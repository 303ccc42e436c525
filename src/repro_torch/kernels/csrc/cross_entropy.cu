// Fused cross-entropy: per-row loss m + log(l) - logit[label] over the
// vocabulary, without materialising the softmax.
//
// Replaces the TPU kernel `_ce_kernel` of
// src/repro/kernels/cross_entropy/kernel.py (launcher `cross_entropy_call`).
// Per row it keeps the running max m (CUDA cores), the denominator
// l = l * exp(m_old - m_new) + rowsum(bf16(exp(s - m_new))) whose row sum is
// the paper's all-ones product (eq. 9: mma.sync.m16n8k16 bf16, B = ones,
// f32 accumulation), and the label's logit. Columns v >= vocab are masked.
//
// The label logit is SELECTED on the CUDA cores, not multiplied: the
// reference gathers it with an f32 one-hot product, which is exact on its
// host, and a TF32 tensor-core product would keep only 10 mantissa bits.
//
// Bound on this card: bytes. The kernel reads the (rows, width) logits once
// (at the training shape 2048 x 50432 f32, 413 MB: 123 us at 3.35 TB/s);
// its ones-MMAs are 16 flops per logit and its exp one special-function op
// per logit, far below the compute roofline. Design against that: one CTA of
// 8 warps per 16-row MMA tile (2048 rows -> 128 CTAs on 132 SMs). The CTA
// walks the vocabulary in tiles of 512 columns, each warp owning 64 of them
// (four 16-column MMA k-steps); the next tile's logits are loaded into
// registers while the current one is processed, so two tiles' loads are in
// flight. The tile max is exchanged through double-buffered shared memory
// (one barrier per tile); every warp then scales its own running row sums,
// which live in its MMA accumulator, by exp(m_old - m_new) and adds the
// ones-MMA of its p tile. The warps' sums are folded in warp order at the
// end: deterministic, no atomics. Not yet TMA or cp.async: right and simple
// first.
#include "common.cuh"

namespace {

constexpr int CE_ROWS = 16;                   // rows per CTA: one m16 MMA tile
constexpr int CE_WARPS = 8;
constexpr int CE_THREADS = CE_WARPS * 32;
constexpr int CE_WCOLS = 64;                  // columns per warp per tile
constexpr int CE_KSTEPS = CE_WCOLS / 16;      // MMA k-steps per warp per tile
constexpr int CE_BV = CE_WARPS * CE_WCOLS;    // ops.BLOCK_V
constexpr float CE_NEG = -1e30f;

// Two neighbouring columns (c, c + 1) of one row; columns past `vocab` read
// as CE_NEG and are never loaded.
template <typename T>
__device__ __forceinline__ float2 load_cols(const T* row, int c, int vocab, bool even) {
  if (even && c + 1 < vocab) return load_pair(row + c);
  float2 v = make_float2(CE_NEG, CE_NEG);
  if (c < vocab) v.x = to_f32(row[c]);
  if (c + 1 < vocab) v.y = to_f32(row[c + 1]);
  return v;
}

// One warp's share of one vocab tile: for each k-step, the A-fragment
// layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   [0..1] row g, cols 2t..2t+1   [2..3] row g+8, cols 2t..
//   [4..5] row g, cols 2t+8..     [6..7] row g+8, cols 2t+8..
template <typename T>
__device__ __forceinline__ void load_tile(float (&s)[CE_KSTEPS][8], const T* ra, const T* rb,
                                          bool va, bool vb, int col0, int vocab, bool even) {
  const float2 neg = make_float2(CE_NEG, CE_NEG);
#pragma unroll
  for (int kk = 0; kk < CE_KSTEPS; ++kk) {
    const int c0 = col0 + kk * 16, c1 = c0 + 8;
    const float2 a0 = va ? load_cols(ra, c0, vocab, even) : neg;
    const float2 a1 = vb ? load_cols(rb, c0, vocab, even) : neg;
    const float2 a2 = va ? load_cols(ra, c1, vocab, even) : neg;
    const float2 a3 = vb ? load_cols(rb, c1, vocab, even) : neg;
    s[kk][0] = a0.x; s[kk][1] = a0.y; s[kk][2] = a1.x; s[kk][3] = a1.y;
    s[kk][4] = a2.x; s[kk][5] = a2.y; s[kk][6] = a3.x; s[kk][7] = a3.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(CE_THREADS)
ce_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
          float* __restrict__ out, int rows, long long ld, int vocab, int even) {
  __shared__ float tile_max[2][CE_WARPS][CE_ROWS];
  __shared__ float warp_l[CE_WARPS][CE_ROWS];
  __shared__ float pick_s[CE_ROWS];
  __shared__ float m_s[CE_ROWS];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * CE_ROWS;
  const int ra = row0 + g, rb = ra + 8;
  const bool va = ra < rows, vb = rb < rows;
  const T* pa = logits + static_cast<long long>(va ? ra : 0) * ld;
  const T* pb = logits + static_cast<long long>(vb ? rb : 0) * ld;
  const int la = va ? labels[ra] : -1, lb = vb ? labels[rb] : -1;
  if (threadIdx.x < CE_ROWS) pick_s[threadIdx.x] = 0.f;
  __syncthreads();  // pick_s is cleared before any thread may write a label

  float m_a = CE_NEG, m_b = CE_NEG;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // ones-MMA accumulator: l of rows g, g+8
  const int wcol = warp * CE_WCOLS + 2 * t;
  float cur[CE_KSTEPS][8];
  load_tile(cur, pa, pb, va, vb, wcol, vocab, even != 0);
  int buf = 0;
  for (int v0 = 0; v0 < vocab; v0 += CE_BV, buf ^= 1) {
    float nxt[CE_KSTEPS][8];
    if (v0 + CE_BV < vocab) load_tile(nxt, pa, pb, va, vb, v0 + CE_BV + wcol, vocab, even != 0);

    // mask, label pick, this warp's tile max of rows g and g+8
    float mx_a = CE_NEG, mx_b = CE_NEG;
    uint32_t valid = 0;
#pragma unroll
    for (int kk = 0; kk < CE_KSTEPS; ++kk) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = v0 + wcol + kk * 16 + (e & 1) + ((e & 4) ? 8 : 0);
        const bool row_b = (e & 2) != 0;
        const bool ok = col < vocab && (row_b ? vb : va);
        const float sv = ok ? cur[kk][e] : CE_NEG;
        cur[kk][e] = sv;
        if (ok) valid |= 1u << (kk * 8 + e);
        if (ok && col == (row_b ? lb : la)) pick_s[row_b ? g + 8 : g] = sv;  // one writer
        if (row_b) mx_b = fmaxf(mx_b, sv); else mx_a = fmaxf(mx_a, sv);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    if (t == 0) {
      tile_max[buf][warp][g] = mx_a;
      tile_max[buf][warp][g + 8] = mx_b;
    }
    __syncthreads();
    float tm_a = CE_NEG, tm_b = CE_NEG;
#pragma unroll
    for (int w = 0; w < CE_WARPS; ++w) {
      tm_a = fmaxf(tm_a, tile_max[buf][w][g]);
      tm_b = fmaxf(tm_b, tile_max[buf][w][g + 8]);
    }
    const float mn_a = fmaxf(m_a, tm_a), mn_b = fmaxf(m_b, tm_b);
    const float alpha_a = expf(m_a - mn_a), alpha_b = expf(m_b - mn_b);
    acc[0] *= alpha_a;
    acc[1] *= alpha_a;
    acc[2] *= alpha_b;
    acc[3] *= alpha_b;
    // l += rowsum(bf16 p) as ones-MMAs, one per 16-column k-step
#pragma unroll
    for (int kk = 0; kk < CE_KSTEPS; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        p[e] = (valid >> (kk * 8 + e) & 1u) ? expf(cur[kk][e] - ((e & 2) ? mn_b : mn_a)) : 0.f;
      const uint32_t A[4] = {pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]),
                             pack_bf16(p[4], p[5]), pack_bf16(p[6], p[7])};
      mma_bf16_16816(acc, A, ONES_BF16X2, ONES_BF16X2);
    }
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int kk = 0; kk < CE_KSTEPS; ++kk)
#pragma unroll
      for (int e = 0; e < 8; ++e) cur[kk][e] = nxt[kk][e];
  }

  // every column of D holds the row sum; lane t == 0 owns column 0
  if (t == 0) {
    warp_l[warp][g] = acc[0];
    warp_l[warp][g + 8] = acc[2];
    if (warp == 0) {
      m_s[g] = m_a;
      m_s[g + 8] = m_b;
    }
  }
  __syncthreads();
  if (threadIdx.x < CE_ROWS && row0 + static_cast<int>(threadIdx.x) < rows) {
    const int r = threadIdx.x;
    float l = 0.f;
    for (int w = 0; w < CE_WARPS; ++w) l += warp_l[w][r];  // fixed order
    out[row0 + r] = m_s[r] + logf(fmaxf(l, 1e-30f)) - pick_s[r];
  }
}

template <typename T>
int launch(const void* logits, const int* labels, float* out, int rows, long long ld,
           int vocab, int even, cudaStream_t stream) {
  const dim3 grid((rows + CE_ROWS - 1) / CE_ROWS);
  ce_kernel<T><<<grid, CE_THREADS, 0, stream>>>(static_cast<const T*>(logits), labels, out,
                                                 rows, ld, vocab, even);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// logits: (rows, vocab) with row stride `width` (>= vocab) in `dtype`;
// labels: (rows,) int32; out: (rows,) f32. `even`: width is even and logits
// is aligned for two-element loads.
extern "C" int ce_forward(const void* logits, const int* labels, float* out, int rows,
                          long long width, int vocab, int even, int dtype, void* stream) {
  if (rows < 0 || vocab < 1 || vocab > width) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return launch<float>(logits, labels, out, rows, width, vocab, even, s);
    case DT_BF16:
      return launch<__nv_bfloat16>(logits, labels, out, rows, width, vocab, even, s);
    case DT_F16:
      return launch<__half>(logits, labels, out, rows, width, vocab, even, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
