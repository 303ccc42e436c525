// Fused cross-entropy: per-row loss m + log(l) - logit[label] over the
// vocabulary, without materialising the softmax.
//
// Replaces the TPU kernel `_ce_kernel` of
// src/repro/kernels/cross_entropy/kernel.py (launcher `cross_entropy_call`).
// Per row it gives m + log(max(l, 1e-30)) - logit[label]: m the row max, l
// the sum of bf16-rounded p = exp(s - m) taken as all-ones products (the
// paper's eq. 9: mma.sync.m16n8k16 bf16, B = ones, f32 accumulation), the
// label's logit SELECTED (one load per row; a label outside [0, vocab)
// picks 0), never multiplied: the reference's one-hot product is exact in
// f32, a TF32 tensor-core product would keep 10 mantissa bits. Columns at
// or past `vocab` are masked. One launch a call.
//
// Bound on this card: bytes. The kernel reads the (rows, width) logits once
// (at the training shape 2048 x 50432 f32, 413 MB: 123 us at 3.35 TB/s);
// its ones-MMAs are 16 flops per logit and its exp one special-function op
// per logit, far below the compute roofline. Design against that:
//
// * The vocabulary is split over CTAs (flash-decoding's split): a work item
//   is one 16-row block (one m16 MMA tile) x one slice of CE_SLICE columns,
//   so 2048 rows of 50432 columns make 128 x 25 CTAs and 256 rows 400, with
//   several CTAs resident on every SM.
// * A step is 4 KB a warp: each thread loads CE_CHUNKS 16-byte chunks (4 f32
//   or 8 bf16 / f16 consecutive columns) of each of its two rows g and g + 8;
//   the quad's four threads take neighbouring chunks, so a warp's load covers
//   64 contiguous bytes of each of its 16 rows, streamed (evict first). The
//   next step is loaded before this one is processed (the loaded words stay
//   in registers until they become values; a 16-bit step's max is taken on
//   the packed pairs), across the whole slice.
// * p = 2^((s - m) log2 e) by ex2.approx on the special-function unit (a few
//   instructions a logit fewer than expf; the plain version's torch.exp
//   differs by an ulp or two, within the check's tolerance).
// * With all-ones B a row's columns may sit in any k-slot, so a chunk's four
//   values of row g (f32; eight: two MMAs at 16-bit input) are the A
//   fragment's row-g halves as loaded.
// * No CTA barrier per step: each warp keeps its own running max m_w and
//   running sum l_w (in its MMA accumulator) over its own steps.
// * Per-element masking only in the one step that crosses `vocab`, and no
//   per-element label compare.
// An odd width or a base not 16-byte aligned takes the element route for the
// whole launch (decided on the host): every step is loaded element by
// element with the column mask, and is not prefetched.
//
// The fold order (ops.cross_entropy_plain walks the same order):
//   slice j covers columns [j S, j S + S), S = CE_SLICE; its steps are
//   [j S + k C, j S + k C + C), C = 4 * CE_CHUNKS * (16 / itemsize) columns,
//   and step k belongs to warp k % CE_WARPS (interleaved). All boundaries
//   sit at column offsets that do not depend on the width.
//   1. Each warp, over its steps in order: m_new = max(m, the step's max,
//      masked columns read as -1e30); l = l * exp(m - m_new) + the ones-MMA
//      sum of bf16(exp(s - m_new)) (masked columns give 0); m = m_new. From
//      m = -1e30, l = 0.
//   2. The CTA merges its warps in warp order: M_j = max_w m_w,
//      L_j = sum over w in order of l_w * exp(m_w - M_j).
//   3. The row block's last CTA (an integer ticket from common.fold_tickets;
//      no float atomics) merges the slices in slice order by the same
//      formula, M = max_j M_j, L = sum over j in order of L_j exp(M_j - M),
//      loads the label logit and writes M + log(max(L, 1e-30)) - pick.
//      A single slice is written by its own CTA (L_0 exp(0) = L_0).
// A warp or slice that holds only pad logits (-1e30) has m = -1e30 and a
// nonzero l; its merge term l exp(-1e30 - M) is exactly 0 when the row has
// a real logit, so padded and cut widths give the same loss bitwise.
//
// The partial variant (`ce_partial`, a template flag of the same kernel):
// the logits are one slice of a vocabulary cut over ranks, starting at
// global column `col0` (the vocab-parallel cross-entropy of the sharded
// step). The split, the steps and the merges are the same; the row block's
// last CTA writes, per row, (M, L, pick) -- the slice's max, its sum of
// exp(s - M), and the label's logit when the label falls in [col0, col0 +
// vocab), else 0 -- instead of the loss. The ranks' triples merge in rank
// order on the host side (models.losses) by the formula of step 3.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int CE_ROWS = 16;        // rows per CTA: one m16 MMA tile (ops.BLOCK_ROWS)
constexpr int CE_WARPS = 4;        // ops.WARPS
constexpr int CE_THREADS = CE_WARPS * 32;
constexpr int CE_CHUNKS = 4;       // 16-byte chunks a thread loads of each row a step
constexpr int CE_SLICE = 2048;     // columns a CTA: ops.SLICE_V
constexpr int CE_DEPTH = 2;        // steps a warp holds: this one and the next
constexpr int CE_MIN_CTAS = 4;     // __launch_bounds__: CTAs resident a SM
constexpr float CE_NEG = -1e30f;

template <typename T>
__host__ __device__ constexpr int chunk_cols() { return 16 / static_cast<int>(sizeof(T)); }
template <typename T>  // ops.step_columns
__host__ __device__ constexpr int step_cols() { return 4 * CE_CHUNKS * chunk_cols<T>(); }

// One step of a thread: its chunks of rows g (a) and g + 8 (b) as loaded.
struct Step {
  uint4 a[CE_CHUNKS], b[CE_CHUNKS];
};

// Element i of a loaded chunk as f32 (exact).
template <typename T>
__device__ __forceinline__ float chunk_val(const uint4& w, int i) {
  const uint32_t* u = reinterpret_cast<const uint32_t*>(&w);
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(u[i]);
  } else {
    const uint32_t word = u[i / 2];
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      return __uint_as_float(i % 2 ? word & 0xffff0000u : word << 16);
    else
      return __half2float(__ushort_as_half(static_cast<unsigned short>(i % 2 ? word >> 16 : word)));
  }
}

// The first column of chunk q of thread t in the step at column c.
template <typename T>
__device__ __forceinline__ int chunk_col(int c, int q, int t) {
  return c + (q * 4 + t) * chunk_cols<T>();
}

// The step's chunks, 16 bytes a load, streamed (evict first: the logits are
// read once).
template <typename T>
__device__ __forceinline__ void load_step(Step& st, const T* pa, const T* pb, int c, int t) {
#pragma unroll
  for (int q = 0; q < CE_CHUNKS; ++q) {
    const int col = chunk_col<T>(c, q, t);
    st.a[q] = __ldcs(reinterpret_cast<const uint4*>(pa + col));
    st.b[q] = __ldcs(reinterpret_cast<const uint4*>(pb + col));
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// 2^x on the special-function unit (ex2.approx: ~2 ulps; x = 0 gives 1).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// p = exp(s - m) as 2^((s - m) log2 e): s - m first, so s == m gives 1 even
// at s = m = -1e30 (a pad logit).
__device__ __forceinline__ float exp_p(float s, float m) {
  return ex2_approx((s - m) * 1.4426950408889634f);
}

// The larger of the two 16-bit values of each half of two words (exact;
// a NaN loses, as in fmaxf).
template <typename T>
__device__ __forceinline__ uint32_t max_halves(uint32_t a, uint32_t b) {
  using T2 = typename std::conditional<std::is_same<T, __nv_bfloat16>::value, __nv_bfloat162,
                                       __half2>::type;
  const T2 m = __hmax2(*reinterpret_cast<const T2*>(&a), *reinterpret_cast<const T2*>(&b));
  return *reinterpret_cast<const uint32_t*>(&m);
}

// The largest value of a row's chunks as loaded, as f32: 16-bit values are
// compared in pairs without unpacking.
template <typename T>
__device__ __forceinline__ float chunks_max(const uint4 (&w)[CE_CHUNKS]) {
  if constexpr (sizeof(T) == 4) {
    float mx = CE_NEG;
#pragma unroll
    for (int q = 0; q < CE_CHUNKS; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx = fmaxf(mx, chunk_val<T>(w[q], i));
    return mx;
  } else {
    uint32_t m2 = w[0].x;
#pragma unroll
    for (int q = 0; q < CE_CHUNKS; ++q) {
      if (q) m2 = max_halves<T>(m2, w[q].x);
      m2 = max_halves<T>(m2, w[q].y);
      m2 = max_halves<T>(m2, w[q].z);
      m2 = max_halves<T>(m2, w[q].w);
    }
    const uint4 pair = make_uint4(m2, 0u, 0u, 0u);
    return fmaxf(CE_NEG, fmaxf(chunk_val<T>(pair, 0), chunk_val<T>(pair, 1)));
  }
}

// A warp's running (m, l) for its rows g and g + 8 over one step: `mx_a`,
// `mx_b` the thread's maxima of the step's unmasked values; the new max, the
// rescale of the MMA accumulator, then the ones-MMAs of bf16(exp(s - m_new)).
// `va`/`vb` give the values, `ok` whether a column counts (p = 0 if not).
template <int CC, typename Va, typename Vb, typename Ok>
__device__ __forceinline__ void online_step(Va va, Vb vb, Ok ok, float mx_a, float mx_b,
                                            float& m_a, float& m_b, float (&acc)[4]) {
  const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
  const float alpha_a = expf(m_a - mn_a), alpha_b = expf(m_b - mn_b);
  acc[0] *= alpha_a;
  acc[1] *= alpha_a;
  acc[2] *= alpha_b;
  acc[3] *= alpha_b;
#pragma unroll
  for (int q = 0; q < CE_CHUNKS; ++q)
#pragma unroll
    for (int h = 0; h < CC / 4; ++h) {
      float pa[4], pb[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * h + e;
        pa[e] = ok(q, i) ? exp_p(va(q, i), mn_a) : 0.f;
        pb[e] = ok(q, i) ? exp_p(vb(q, i), mn_b) : 0.f;
      }
      // A: (g, k 2t..) (g + 8, 2t..) (g, 2t + 8..) (g + 8, 2t + 8..); any k-slot
      const uint32_t A[4] = {pack_bf16(pa[0], pa[1]), pack_bf16(pb[0], pb[1]),
                             pack_bf16(pa[2], pa[3]), pack_bf16(pb[2], pb[3])};
      mma_bf16_16816(acc, A, ONES_BF16X2, ONES_BF16X2);
    }
  m_a = mn_a;
  m_b = mn_b;
}

// A step whose 16-byte chunks all lie before `vocab`, from its loaded words.
template <typename T>
__device__ __forceinline__ void full_step(const Step& st, float& m_a, float& m_b,
                                          float (&acc)[4]) {
  online_step<chunk_cols<T>()>([&](int q, int i) { return chunk_val<T>(st.a[q], i); },
                               [&](int q, int i) { return chunk_val<T>(st.b[q], i); },
                               [](int, int) { return true; }, chunks_max<T>(st.a),
                               chunks_max<T>(st.b), m_a, m_b, acc);
}

// A step loaded element by element, columns at or past `vocab` masked (read
// as -1e30 for the max, p = 0): the step that crosses `vocab`, and every step
// of the element route. Each element is read twice (the max, then p), the
// second time from L1, so no step is held in registers.
template <typename T>
__device__ __forceinline__ void masked_step(const T* pa, const T* pb, int c, int t, int vocab,
                                            float& m_a, float& m_b, float (&acc)[4]) {
  constexpr int CC = chunk_cols<T>();
  auto col = [&](int q, int i) { return chunk_col<T>(c, q, t) + i; };
  auto va = [&](int q, int i) { return col(q, i) < vocab ? to_f32(pa[col(q, i)]) : CE_NEG; };
  auto vb = [&](int q, int i) { return col(q, i) < vocab ? to_f32(pb[col(q, i)]) : CE_NEG; };
  float mx_a = CE_NEG, mx_b = CE_NEG;
#pragma unroll
  for (int q = 0; q < CE_CHUNKS; ++q)
#pragma unroll
    for (int i = 0; i < CC; ++i) {
      mx_a = fmaxf(mx_a, va(q, i));
      mx_b = fmaxf(mx_b, vb(q, i));
    }
  online_step<CC>(va, vb, [&](int q, int i) { return col(q, i) < vocab; }, mx_a, mx_b, m_a, m_b,
                  acc);
}

// l * exp(m - M) as the plain version takes it: one product, rounded.
__device__ __forceinline__ float merge_term(float l, float m, float M) {
  return __fmul_rn(l, expf(m - M));
}

template <typename T>
__device__ __forceinline__ float finish(const T* logits, const int* labels, long long ld,
                                        int vocab, int row, float M, float L) {
  const int lab = labels[row];
  const float pick = lab >= 0 && lab < vocab ? to_f32(logits[row * ld + lab]) : 0.f;
  return M + logf(fmaxf(L, 1e-30f)) - pick;
}

// A finished row: its loss, or with PARTIAL its (M, L, pick) triple, the
// label taken relative to the slice's first global column `col0`.
template <typename T, bool PARTIAL>
__device__ __forceinline__ void write_row(const T* logits, const int* labels, float* out,
                                          long long ld, int vocab, int col0, int row, float M,
                                          float L) {
  if constexpr (PARTIAL) {
    const long long lab = static_cast<long long>(labels[row]) - col0;
    out[3LL * row] = M;
    out[3LL * row + 1] = L;
    out[3LL * row + 2] = lab >= 0 && lab < vocab ? to_f32(logits[row * ld + lab]) : 0.f;
  } else {
    out[row] = finish(logits, labels, ld, vocab, row, M, L);
  }
}

template <typename T, bool VEC, bool PARTIAL>
__global__ void __launch_bounds__(CE_THREADS, CE_MIN_CTAS)
ce_kernel(const T* __restrict__ logits, const int* __restrict__ labels, float* __restrict__ out,
          float2* __restrict__ part, unsigned int* __restrict__ ticket, int rows, long long ld,
          int vocab, int slices, int col0) {
  constexpr int SC = step_cols<T>();
  __shared__ float warp_m[CE_WARPS][CE_ROWS], warp_l[CE_WARPS][CE_ROWS];
  __shared__ bool am_last;

  const int block = blockIdx.x / slices, j = blockIdx.x % slices;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = block * CE_ROWS;
  // rows past `rows` re-read the last row; their sums are never written
  const T* pa = logits + static_cast<long long>(min(row0 + g, rows - 1)) * ld;
  const T* pb = logits + static_cast<long long>(min(row0 + g + 8, rows - 1)) * ld;

  float m_a = CE_NEG, m_b = CE_NEG;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // ones-MMA accumulator: l of rows g, g + 8
  const int stride = CE_WARPS * SC;
  const int c0 = j * CE_SLICE + warp * SC;
  const int c_end = min(j * CE_SLICE + CE_SLICE, vocab);
  int c = c0;
  if constexpr (VEC) {
    // full steps c0, c0 + stride, ... while c + SC <= c_end; the next in flight
    const int nfull = c0 + SC <= c_end ? (c_end - SC - c0) / stride + 1 : 0;
    Step buf[CE_DEPTH];
#pragma unroll
    for (int d = 0; d + 1 < CE_DEPTH; ++d)
      if (d < nfull) load_step(buf[d], pa, pb, c0 + d * stride, t);
    for (int s0 = 0; s0 < nfull; s0 += CE_DEPTH) {
#pragma unroll
      for (int d = 0; d < CE_DEPTH; ++d) {
        const int s = s0 + d;  // the same for the whole warp: mma.sync stays converged
        if (s < nfull) {
          if (s + CE_DEPTH - 1 < nfull)
            load_step(buf[(d + CE_DEPTH - 1) % CE_DEPTH], pa, pb, c0 + (s + CE_DEPTH - 1) * stride,
                      t);
          full_step<T>(buf[d], m_a, m_b, acc);
        }
      }
    }
    c = c0 + nfull * stride;
    if (c < c_end) masked_step(pa, pb, c, t, vocab, m_a, m_b, acc);  // crosses `vocab`
  } else {
    for (; c < c_end; c += stride) masked_step(pa, pb, c, t, vocab, m_a, m_b, acc);
  }

  // every column of D holds the row sum, in each thread of the quad
  if (t == 0) {
    warp_m[warp][g] = m_a;
    warp_m[warp][g + 8] = m_b;
    warp_l[warp][g] = acc[0];
    warp_l[warp][g + 8] = acc[2];
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r < CE_ROWS) {  // 2. the warps in warp order
    float M = CE_NEG, L = 0.f;
#pragma unroll
    for (int w = 0; w < CE_WARPS; ++w) M = fmaxf(M, warp_m[w][r]);
#pragma unroll
    for (int w = 0; w < CE_WARPS; ++w) L = __fadd_rn(L, merge_term(warp_l[w][r], warp_m[w][r], M));
    if (slices == 1) {
      if (row0 + r < rows)
        write_row<T, PARTIAL>(logits, labels, out, ld, vocab, col0, row0 + r, M, L);
    } else {
      part[static_cast<long long>(blockIdx.x) * CE_ROWS + r] = make_float2(M, L);
      __threadfence();  // publish the pair before the ticket
    }
  }
  if (slices == 1) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    am_last = atomicAdd(ticket + block, 1u) == static_cast<unsigned int>(slices - 1);
    if (am_last) ticket[block] = 0u;  // every other CTA of the row block has its ticket
  }
  __syncthreads();
  if (!am_last) return;
  __threadfence();
  if (r < CE_ROWS && row0 + r < rows) {  // 3. the slices in slice order
    const float2* pr = part + static_cast<long long>(block) * slices * CE_ROWS + r;
    float M = CE_NEG, L = 0.f;
    for (int k = 0; k < slices; ++k) M = fmaxf(M, __ldcg(pr + k * CE_ROWS).x);
    for (int k = 0; k < slices; ++k) {
      const float2 v = __ldcg(pr + k * CE_ROWS);
      L = __fadd_rn(L, merge_term(v.y, v.x, M));
    }
    write_row<T, PARTIAL>(logits, labels, out, ld, vocab, col0, row0 + r, M, L);
  }
}

template <typename T, bool PARTIAL = false>
int launch(const void* logits, const int* labels, float* out, int rows, long long ld, int vocab,
           int vec, void* part, unsigned int* ticket, cudaStream_t stream, int col0 = 0) {
  const int slices = (vocab + CE_SLICE - 1) / CE_SLICE;
  const long long ctas = static_cast<long long>((rows + CE_ROWS - 1) / CE_ROWS) * slices;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(ctas));
  const T* x = static_cast<const T*>(logits);
  float2* p = static_cast<float2*>(part);
  if (vec)
    ce_kernel<T, true, PARTIAL><<<grid, CE_THREADS, 0, stream>>>(x, labels, out, p, ticket, rows,
                                                                 ld, vocab, slices, col0);
  else
    ce_kernel<T, false, PARTIAL><<<grid, CE_THREADS, 0, stream>>>(x, labels, out, p, ticket,
                                                                  rows, ld, vocab, slices, col0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// logits: (rows, vocab) with row stride `width` (>= vocab) in `dtype`;
// labels: (rows,) int32; out: (rows,) f32. `vec`: the base and the row
// stride are 16-byte aligned (16-byte loads), else the element route.
// `part`: (ceil(rows / 16) * slices * 16) float2 scratch, slices =
// ceil(vocab / 2048) (unread with one slice, and may then be null);
// `ticket`: ceil(rows / 16) unsigned ints, 0 on entry and 0 again when the
// kernel ends.
extern "C" int ce_forward(const void* logits, const int* labels, float* out, int rows,
                          long long width, int vocab, int vec, int dtype, void* part,
                          unsigned int* ticket, void* stream) {
  if (rows < 0 || vocab < 1 || vocab > width) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return launch<float>(logits, labels, out, rows, width, vocab, vec, part, ticket, s);
    case DT_BF16:
      return launch<__nv_bfloat16>(logits, labels, out, rows, width, vocab, vec, part, ticket, s);
    case DT_F16:
      return launch<__half>(logits, labels, out, rows, width, vocab, vec, part, ticket, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The partial variant: logits (rows, vocab) with row stride `width`, one
// slice of a vocabulary starting at global column `col0`; labels global
// ids; out: (rows, 3) f32, (M, L, pick) a row. `part` and `ticket` as for
// ce_forward.
extern "C" int ce_partial(const void* logits, const int* labels, float* out, int rows,
                          long long width, int vocab, int col0, int vec, int dtype, void* part,
                          unsigned int* ticket, void* stream) {
  if (rows < 0 || vocab < 1 || vocab > width || col0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return launch<float, true>(logits, labels, out, rows, width, vocab, vec, part, ticket, s,
                                 col0);
    case DT_BF16:
      return launch<__nv_bfloat16, true>(logits, labels, out, rows, width, vocab, vec, part,
                                         ticket, s, col0);
    case DT_F16:
      return launch<__half, true>(logits, labels, out, rows, width, vocab, vec, part, ticket, s,
                                  col0);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
