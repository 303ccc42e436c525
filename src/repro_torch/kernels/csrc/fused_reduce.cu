// Striped single-launch full reduction: sum of all (prologue-mapped)
// elements of one flat array, with an optional NaN/Inf census and an
// in-kernel epilogue chain.
//
// Replaces the TPU kernel `fused_accumulate_kernel` of
// src/repro/kernels/mma_reduce/kernel.py (launcher `reduce_fused`). The
// reference's geometry is kept at m = 128: a block is 8 m^2 tiles (its
// default `tiles_per_block`), 131072 elements; lane c streams blocks c,
// c + C, c + 2C, ... as `reduce_fused`'s index map does. Lanes are CTAs.
// Each element is cast to the compute dtype, the tail past n is masked to
// zero, the census counts the non-finite compute-cast values BEFORE the
// prologue, and the prologue (identity / square / abs) maps the value at
// the compute dtype.
//
// bf16 / f16 compute is the paper's all-ones product (eq. 9): every warp
// feeds 256 elements per mma.sync.m16n8k16 (B = ones, f32 accumulation)
// and keeps the row sums in its MMA accumulator across the whole lane.
// f32 compute has no exact tensor-core product (TF32 keeps 10 mantissa
// bits), so it sums on the CUDA cores in f32, in a fixed order, as the parts
// kernel does.
//
// A lane partial is one f32 sum and one count (the (m, m) column-replicated
// TPU accumulator is not needed). The lanes are folded without float
// atomics: the last CTA to finish, found by an integer ticket, folds them
// in the fixed shape of `ops.combine_lane_partials` (thread i sums lanes i,
// i + 256, ... in order; a fixed shuffle tree per warp; the warps in order),
// applies the epilogue chain to the total and writes [total, count]. The
// ticket is a buffer the caller zeroes once; the last CTA sets it back to 0.
// A stripe of ONE lane (n <= one block, as the loss's token sum) has
// nothing to fold across CTAs: its CTA writes [epilogue(0 + total), count]
// itself -- `combine_lane_partials` of one partial is 0 + it (a -0 total
// comes out +0) -- with no lane partial, fence or ticket, the in-kernel
// finish of a single-lane launch that the reference's cost model counts
// (`fused_hbm_bytes(epilogue=True)`). One launch per call; two launches on
// the same input agree bitwise.
//
// The moments pair (`fr_moments`, replacing `fused_moments_kernel` of the
// same file, the reference's prologue "moments") is the same kernel with a
// second accumulator: every loaded word feeds X @ 1 at the compute dtype
// and its square, taken at the compute dtype (`prologue_word<CD,
// PRO_SQUARE>` of the same word: one rounding of the f32 product), feeds
// X^2 @ 1 (f32 compute: the element into one running sum, and v * v into
// the other by one fma, as nvcc contracted the element route's square and
// add); the two halves fold by the same fixed tree and the launch writes
// [sum, sumsq]. It has no census and no epilogue, as in the reference. Its
// A operands sit in the k-slots the element route it replaced gave them,
// so the pair is bitwise that route's.
//
// Bound on this card: bytes (n * itemsize read once; the ones-MMA is 16
// flops per element, far below the bf16 roofline); at the loss's 2048
// elements the launch is latency. Loads are 16 bytes per thread, four
// groups per step, and the next step's groups are loaded as soon as this
// step's words are read (before its MMAs), across the block loop, so a
// warp always has a step in flight. The words stay as loaded until they
// are the MMA's A operand (reduce_common.cuh's
// word route: a bf16 / f16 input at its own compute dtype is not converted
// at all, f32 is rounded once per pair), with prologue and census as
// template parameters.
#include "reduce_common.cuh"

namespace {

constexpr int FR_THREADS = 256;
constexpr int FR_WARPS = FR_THREADS / 32;
constexpr int FR_GROUP = RC_GROUP;  // elements per thread per group: 16 bytes of bf16
constexpr int FR_UNROLL = 4;  // groups a thread loads per step
constexpr int FR_MAX_STEPS = RC_MAX_STEPS;

// PRO: identity, square or abs (census as CENSUS), or moments (the pair:
// a second accumulator for the squares, and `lane_cnt` then holds the
// lanes' sums of squares as floats).
template <typename T, int CD, int PRO, bool CENSUS>
__global__ void __launch_bounds__(FR_THREADS)
fused_sum_kernel(const T* __restrict__ x, long long n, long long block_elems, long long blocks,
                 int aligned, const Chain chain, float* __restrict__ lane_sum,
                 int* __restrict__ lane_cnt, unsigned int* __restrict__ ticket,
                 float* __restrict__ out) {
  constexpr bool DUAL = PRO == PRO_MOMENTS;
  constexpr bool WORDS = CD != DT_F32;  // the word route into the ones-MMA
  __shared__ float warp_sum[FR_WARPS];
  __shared__ float warp_sum2[FR_WARPS];
  __shared__ long long warp_cnt[FR_WARPS];
  __shared__ bool am_last;

  const int lane_id = blockIdx.x, lanes = gridDim.x;
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const long long stride = static_cast<long long>(FR_THREADS) * FR_GROUP;
  const long long warp_off = static_cast<long long>(warp) * 32 * FR_GROUP;
  const bool vec = aligned != 0;
  float* lane_sq = reinterpret_cast<float*>(lane_cnt);

  float acc[4] = {0.f, 0.f, 0.f, 0.f};   // ones-MMA accumulator (bf16/f16 compute)
  float acc2[4] = {0.f, 0.f, 0.f, 0.f};  // DUAL: the squares' accumulator
  float fsum = 0.f, fsum2 = 0.f;         // f32 compute
  int cnt = 0;
  // The warp's steps: lane c's blocks c, c + C, ..., in each the groups from
  // the WARP's first element (so every thread of a warp runs the same steps:
  // mma.sync must be issued by the whole warp) on, FR_UNROLL groups a step.
  // Groups past `end` load as zeros. Only the last block can be short, so a
  // warp with no step left in a block has no block after it.
  long long b = lane_id;
  long long w0 = b * block_elems + warp_off;
  long long end = w0 - warp_off + block_elems < n ? w0 - warp_off + block_elems : n;
  bool have = b < blocks && w0 < end;
  Raw<T> raw[FR_UNROLL];
  auto load_step = [&]() {
    const long long e0 = w0 + lid * FR_GROUP;
#pragma unroll
    for (int u = 0; u < FR_UNROLL; ++u) load_raw(x, e0 + u * stride, end, vec, raw[u]);
  };
  if (have) load_step();
  while (have) {
    uint32_t w[FR_UNROLL][4];  // WORDS: this step's A operands
#pragma unroll
    for (int u = 0; u < FR_UNROLL; ++u) {
      if constexpr (WORDS) {
        raw_words<T, CD>(raw[u], w[u]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (CENSUS) cnt += nonfinite_halves<CD>(w[u][k]);  // census before the prologue
          w[u][k] = prologue_word<CD, PRO>(w[u][k]);  // moments: the words as they are
        }
      } else {  // f32 compute
#pragma unroll
        for (int i = 0; i < FR_GROUP; ++i) {
          const float v = raw_elem(raw[u], i);
          if (CENSUS) cnt += isfinite(v) ? 0 : 1;
          if constexpr (DUAL) {  // the element route's v * v + fsum2 compiled to one fma
            fsum += v;
            fsum2 = fmaf(v, v, fsum2);
          } else {
            fsum += PRO == PRO_SQUARE ? __fmul_rn(v, v) : PRO == PRO_ABS ? fabsf(v) : v;
          }
        }
      }
    }
    // the next step's loads go out before this step's MMAs
    w0 += FR_UNROLL * stride;
    if (w0 >= end) {
      b += lanes;
      w0 = b * block_elems + warp_off;
      end = w0 - warp_off + block_elems < n ? w0 - warp_off + block_elems : n;
    }
    have = b < blocks && w0 < end;
    if (have) load_step();
    if constexpr (WORDS) {
#pragma unroll
      for (int u = 0; u < FR_UNROLL; ++u) {
        ones_mma<CD>(acc, w[u]);
        if constexpr (DUAL) {  // the squares of the same words, at the compute dtype
          uint32_t sq[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) sq[k] = prologue_word<CD, PRO_SQUARE>(w[u][k]);
          ones_mma<CD>(acc2, sq);
        }
      }
    }
  }
  // every column of D holds its row's sum: lane t == 0 owns rows g, g + 8
  float s = CD == DT_F32 ? fsum : ((lid & 3) == 0 ? acc[0] + acc[2] : 0.f);
  float s2 = CD == DT_F32 ? fsum2 : ((lid & 3) == 0 ? acc2[0] + acc2[2] : 0.f);
  long long c = cnt;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {  // fixed-shape tree
    s += __shfl_down_sync(0xffffffffu, s, off);
    if (DUAL) s2 += __shfl_down_sync(0xffffffffu, s2, off);
    else c += __shfl_down_sync(0xffffffffu, c, off);
  }
  if (lid == 0) {
    warp_sum[warp] = s;
    warp_sum2[warp] = s2;
    warp_cnt[warp] = c;
  }
  __syncthreads();
  if (lanes == 1) {  // the one-lane route: this CTA's total is the launch's
    if (threadIdx.x == 0) {
      float ls = 0.f, ls2 = 0.f;
      long long lc = 0;
      for (int k = 0; k < FR_WARPS; ++k) {
        ls += warp_sum[k];
        ls2 += warp_sum2[k];
        lc += warp_cnt[k];
      }
      if constexpr (DUAL) {
        out[0] = __fadd_rn(0.f, ls);
        out[1] = __fadd_rn(0.f, ls2);
      } else {
        out[0] = apply_chain(__fadd_rn(0.f, ls), chain);
        if (CENSUS) out[1] = static_cast<float>(lc);
      }
    }
    return;
  }
  if (threadIdx.x == 0) {
    float ls = 0.f, ls2 = 0.f;
    long long lc = 0;
    for (int k = 0; k < FR_WARPS; ++k) {
      ls += warp_sum[k];
      ls2 += warp_sum2[k];
      lc += warp_cnt[k];
    }
    lane_sum[lane_id] = ls;
    if (DUAL) lane_sq[lane_id] = ls2;
    else lane_cnt[lane_id] = static_cast<int>(lc);
    __threadfence();  // publish the partial before taking a ticket
    am_last = atomicAdd(ticket, 1u) == static_cast<unsigned int>(lanes - 1);
    if (am_last) *ticket = 0u;  // every other CTA has taken its ticket
  }
  __syncthreads();
  if (!am_last) return;

  // The last CTA folds the lanes (ops.combine_lane_partials).
  __threadfence();
  s = 0.f;
  s2 = 0.f;
  c = 0;
  for (int i = threadIdx.x; i < lanes; i += FR_THREADS) {
    s += __ldcg(lane_sum + i);
    if (DUAL) s2 += __ldcg(lane_sq + i);
    else c += __ldcg(lane_cnt + i);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    if (DUAL) s2 += __shfl_down_sync(0xffffffffu, s2, off);
    else c += __shfl_down_sync(0xffffffffu, c, off);
  }
  if (lid == 0) {
    warp_sum[warp] = s;
    warp_sum2[warp] = s2;
    warp_cnt[warp] = c;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float total = 0.f, total2 = 0.f;
  long long total_cnt = 0;
  for (int k = 0; k < FR_WARPS; ++k) {
    total += warp_sum[k];
    total2 += warp_sum2[k];
    total_cnt += warp_cnt[k];
  }
  if constexpr (DUAL) {
    out[0] = total;
    out[1] = total2;
  } else {
    out[0] = apply_chain(total, chain);
    if (CENSUS) out[1] = static_cast<float>(total_cnt);
  }
}

struct Launch {
  const void* x;
  long long n, block_elems, blocks;
  int lanes, aligned;
  Chain chain;
  float* lane_sum;
  int* lane_cnt;
  unsigned int* ticket;
  float* out;
  cudaStream_t stream;
};

template <typename T, int CD, int PRO, bool CENSUS>
int launch(const Launch& a) {
  fused_sum_kernel<T, CD, PRO, CENSUS><<<a.lanes, FR_THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.x), a.n, a.block_elems, a.blocks, a.aligned, a.chain, a.lane_sum,
      a.lane_cnt, a.ticket, a.out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CD>
int by_prologue(int prologue, int census, const Launch& a) {
  switch (prologue) {
    case PRO_IDENTITY:
      return census ? launch<T, CD, PRO_IDENTITY, true>(a) : launch<T, CD, PRO_IDENTITY, false>(a);
    case PRO_SQUARE:
      return census ? launch<T, CD, PRO_SQUARE, true>(a) : launch<T, CD, PRO_SQUARE, false>(a);
    case PRO_ABS:
      return census ? launch<T, CD, PRO_ABS, true>(a) : launch<T, CD, PRO_ABS, false>(a);
    case PRO_MOMENTS:
      return launch<T, CD, PRO_MOMENTS, false>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int by_compute(int compute, int prologue, int census, const Launch& a) {
  switch (compute) {
    case DT_F32: return by_prologue<T, DT_F32>(prologue, census, a);
    case DT_BF16: return by_prologue<T, DT_BF16>(prologue, census, a);
    case DT_F16: return by_prologue<T, DT_F16>(prologue, census, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(const void* x, long long n, int dtype, int compute, int prologue, int census,
             long long block_elems, long long blocks, int lanes, int aligned, const Chain& chain,
             float* out, void* scratch, unsigned int* ticket, void* stream) {
  float* lane_sum = static_cast<float*>(scratch);
  Launch a{x, n, block_elems, blocks, lanes, aligned, chain, lane_sum,
           reinterpret_cast<int*>(lane_sum + lanes), ticket, out,
           static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case DT_F32: return by_compute<float>(compute, prologue, census, a);
    case DT_BF16: return by_compute<__nv_bfloat16>(compute, prologue, census, a);
    case DT_F16: return by_compute<__half>(compute, prologue, census, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: n elements of `dtype`, read flat; `block_elems`, `blocks` and `lanes`
// are the stripe geometry of ops.lane_geometry (lanes <= blocks). `scratch`
// holds `lanes` floats then `lanes` ints (uninitialised; not read with one
// lane, and may then be null); `ticket` is one unsigned int that is 0 on
// entry and 0 again when the kernel ends. `out` receives
// [epilogue(total)] or, with census, [epilogue(total), count].
extern "C" int fr_sum(const void* x, long long n, int dtype, int compute, int prologue,
                      int census, long long block_elems, long long blocks, int lanes,
                      int aligned, int chain_len, const int* chain_ops, const float* chain_p0,
                      const float* chain_p1, float* out, void* scratch, unsigned int* ticket,
                      void* stream) {
  Chain chain;
  if (n < 1 || lanes < 1 || lanes > blocks || block_elems < 1 || prologue < PRO_IDENTITY ||
      prologue > PRO_ABS || !make_chain(chain_len, chain_ops, chain_p0, chain_p1, &chain))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(x, n, dtype, compute, prologue, census, block_elems, blocks, lanes, aligned,
                  chain, out, scratch, ticket, stream);
}

// The moments pair: the same geometry and scratch; `out` receives [sum,
// sumsq] of the compute-cast elements and their compute-dtype squares.
extern "C" int fr_moments(const void* x, long long n, int dtype, int compute,
                          long long block_elems, long long blocks, int lanes, int aligned,
                          float* out, void* scratch, unsigned int* ticket, void* stream) {
  Chain chain;
  make_chain(0, nullptr, nullptr, nullptr, &chain);
  if (n < 1 || lanes < 1 || lanes > blocks || block_elems < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(x, n, dtype, compute, PRO_MOMENTS, 0, block_elems, blocks, lanes, aligned,
                  chain, out, scratch, ticket, stream);
}
