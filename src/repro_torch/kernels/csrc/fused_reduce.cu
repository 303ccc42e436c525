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
// One launch per call; two launches on the same input agree bitwise.
//
// Bound on this card: bytes (n * itemsize read once; the ones-MMA is 16
// flops per element, far below the bf16 roofline). Loads are 16 bytes per
// thread, four groups in flight per thread; at the loss's 2048 elements
// the launch is latency.
#include "common.cuh"

namespace {

constexpr int FR_THREADS = 256;
constexpr int FR_WARPS = FR_THREADS / 32;
constexpr int FR_GROUP = 8;      // elements per thread per group: 16 bytes of bf16
constexpr int FR_UNROLL = 4;     // groups in flight per thread
constexpr int FR_MAX_STEPS = 8;  // ops.FUSED_MAX_CHAIN_STEPS

enum Prologue : int { PRO_IDENTITY = 0, PRO_SQUARE = 1, PRO_ABS = 2 };

struct Chain {
  int len;
  int op[FR_MAX_STEPS];
  float p0[FR_MAX_STEPS];
  float p1[FR_MAX_STEPS];
};

template <int CD>
__device__ __forceinline__ float to_compute(float v) {
  if (CD == DT_BF16) return __bfloat162float(__float2bfloat16_rn(v));
  if (CD == DT_F16) return __half2float(__float2half_rn(v));
  return v;
}

// Eight elements [e, e + 8) as f32; elements at or past `end` read as 0.
__device__ __forceinline__ void load_group(const float* x, long long e, long long end,
                                           bool aligned, float (&v)[FR_GROUP]) {
  if (aligned && e + FR_GROUP <= end) {
    const float4 a = *reinterpret_cast<const float4*>(x + e);
    const float4 b = *reinterpret_cast<const float4*>(x + e + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < FR_GROUP; ++i) v[i] = e + i < end ? x[e + i] : 0.f;
}

template <typename T>
__device__ __forceinline__ void load_group(const T* x, long long e, long long end,
                                           bool aligned, float (&v)[FR_GROUP]) {
  if (aligned && e + FR_GROUP <= end) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + e);
    const T* h = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < FR_GROUP; ++i) v[i] = to_f32(h[i]);
    return;
  }
#pragma unroll
  for (int i = 0; i < FR_GROUP; ++i) v[i] = e + i < end ? to_f32(x[e + i]) : 0.f;
}

template <typename T, int CD>
__global__ void __launch_bounds__(FR_THREADS)
fused_sum_kernel(const T* __restrict__ x, long long n, long long block_elems, long long blocks,
                 int prologue, int census, int aligned, const Chain chain,
                 float* __restrict__ lane_sum, int* __restrict__ lane_cnt,
                 unsigned int* __restrict__ ticket, float* __restrict__ out) {
  __shared__ float warp_sum[FR_WARPS];
  __shared__ long long warp_cnt[FR_WARPS];
  __shared__ bool am_last;

  const int lane_id = blockIdx.x, lanes = gridDim.x;
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const long long stride = static_cast<long long>(FR_THREADS) * FR_GROUP;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // ones-MMA accumulator (bf16/f16 compute)
  float fsum = 0.f;                     // f32 compute
  int cnt = 0;
  for (long long b = lane_id; b < blocks; b += lanes) {
    const long long base = b * block_elems;
    const long long end = base + block_elems < n ? base + block_elems : n;
    // The loop bound is the WARP's first element, so every thread of a warp
    // runs the same iterations: mma.sync must be issued by the whole warp.
    // Groups past `end` load as zeros.
    const long long first = base + static_cast<long long>(warp) * 32 * FR_GROUP;
    for (long long w0 = first; w0 < end; w0 += FR_UNROLL * stride) {
      const long long e0 = w0 + lid * FR_GROUP;
      float v[FR_UNROLL][FR_GROUP];
#pragma unroll
      for (int u = 0; u < FR_UNROLL; ++u) load_group(x, e0 + u * stride, end, aligned != 0, v[u]);
#pragma unroll
      for (int u = 0; u < FR_UNROLL; ++u) {
#pragma unroll
        for (int i = 0; i < FR_GROUP; ++i) {
          float cv = to_compute<CD>(v[u][i]);
          cnt += isfinite(cv) ? 0 : 1;  // census before the prologue
          if (prologue == PRO_SQUARE) cv = to_compute<CD>(cv * cv);
          else if (prologue == PRO_ABS) cv = fabsf(cv);
          v[u][i] = cv;
        }
        if (CD == DT_F32) {
#pragma unroll
          for (int i = 0; i < FR_GROUP; ++i) fsum += v[u][i];
        } else if (CD == DT_BF16) {
          const uint32_t A[4] = {pack_bf16(v[u][0], v[u][1]), pack_bf16(v[u][2], v[u][3]),
                                 pack_bf16(v[u][4], v[u][5]), pack_bf16(v[u][6], v[u][7])};
          mma_bf16_16816(acc, A, ONES_BF16X2, ONES_BF16X2);
        } else {
          const uint32_t A[4] = {pack_f16(v[u][0], v[u][1]), pack_f16(v[u][2], v[u][3]),
                                 pack_f16(v[u][4], v[u][5]), pack_f16(v[u][6], v[u][7])};
          mma_f16_16816(acc, A, ONES_F16X2, ONES_F16X2);
        }
      }
    }
  }
  // every column of D holds its row's sum: lane t == 0 owns rows g, g + 8
  float s = CD == DT_F32 ? fsum : ((lid & 3) == 0 ? acc[0] + acc[2] : 0.f);
  long long c = cnt;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {  // fixed-shape tree
    s += __shfl_down_sync(0xffffffffu, s, off);
    c += __shfl_down_sync(0xffffffffu, c, off);
  }
  if (lid == 0) {
    warp_sum[warp] = s;
    warp_cnt[warp] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ls = 0.f;
    long long lc = 0;
    for (int w = 0; w < FR_WARPS; ++w) {
      ls += warp_sum[w];
      lc += warp_cnt[w];
    }
    lane_sum[lane_id] = ls;
    lane_cnt[lane_id] = static_cast<int>(lc);
    __threadfence();  // publish the partial before taking a ticket
    am_last = atomicAdd(ticket, 1u) == static_cast<unsigned int>(lanes - 1);
    if (am_last) *ticket = 0u;  // every other CTA has taken its ticket
  }
  __syncthreads();
  if (!am_last) return;

  // The last CTA folds the lanes (ops.combine_lane_partials).
  __threadfence();
  s = 0.f;
  c = 0;
  for (int i = threadIdx.x; i < lanes; i += FR_THREADS) {
    s += __ldcg(lane_sum + i);
    c += __ldcg(lane_cnt + i);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    c += __shfl_down_sync(0xffffffffu, c, off);
  }
  if (lid == 0) {
    warp_sum[warp] = s;
    warp_cnt[warp] = c;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float total = 0.f;
  long long total_cnt = 0;
  for (int w = 0; w < FR_WARPS; ++w) {
    total += warp_sum[w];
    total_cnt += warp_cnt[w];
  }
  for (int k = 0; k < chain.len; ++k) total = epilogue_step(total, chain.op[k], chain.p0[k], chain.p1[k]);
  out[0] = total;
  if (census) out[1] = static_cast<float>(total_cnt);
}

template <typename T, int CD>
void launch_one(const void* x, long long n, long long block_elems, long long blocks, int lanes,
                int prologue, int census, int aligned, const Chain& chain, float* lane_sum,
                int* lane_cnt, unsigned int* ticket, float* out, cudaStream_t stream) {
  fused_sum_kernel<T, CD><<<lanes, FR_THREADS, 0, stream>>>(
      static_cast<const T*>(x), n, block_elems, blocks, prologue, census, aligned, chain,
      lane_sum, lane_cnt, ticket, out);
}

template <typename T>
int launch(const void* x, long long n, long long block_elems, long long blocks, int lanes,
           int compute, int prologue, int census, int aligned, const Chain& chain,
           float* lane_sum, int* lane_cnt, unsigned int* ticket, float* out,
           cudaStream_t stream) {
  switch (compute) {
    case DT_F32:
      launch_one<T, DT_F32>(x, n, block_elems, blocks, lanes, prologue, census, aligned, chain,
                            lane_sum, lane_cnt, ticket, out, stream);
      break;
    case DT_BF16:
      launch_one<T, DT_BF16>(x, n, block_elems, blocks, lanes, prologue, census, aligned, chain,
                             lane_sum, lane_cnt, ticket, out, stream);
      break;
    case DT_F16:
      launch_one<T, DT_F16>(x, n, block_elems, blocks, lanes, prologue, census, aligned, chain,
                            lane_sum, lane_cnt, ticket, out, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: n elements of `dtype`, read flat; `block_elems`, `blocks` and `lanes`
// are the stripe geometry of ops.lane_geometry (lanes <= blocks). `scratch`
// holds `lanes` floats then `lanes` ints (uninitialised); `ticket` is one
// unsigned int that is 0 on entry and 0 again when the kernel ends. `out`
// receives [epilogue(total)] or, with census, [epilogue(total), count].
extern "C" int fr_sum(const void* x, long long n, int dtype, int compute, int prologue,
                      int census, long long block_elems, long long blocks, int lanes,
                      int aligned, int chain_len, const int* chain_ops, const float* chain_p0,
                      const float* chain_p1, float* out, void* scratch, unsigned int* ticket,
                      void* stream) {
  if (n < 1 || lanes < 1 || lanes > blocks || block_elems < 1 || chain_len < 0 ||
      chain_len > FR_MAX_STEPS || prologue < PRO_IDENTITY || prologue > PRO_ABS)
    return static_cast<int>(cudaErrorInvalidValue);
  Chain chain;
  chain.len = chain_len;
  for (int k = 0; k < FR_MAX_STEPS; ++k) {
    chain.op[k] = k < chain_len ? chain_ops[k] : -1;
    chain.p0[k] = k < chain_len ? chain_p0[k] : 0.f;
    chain.p1[k] = k < chain_len ? chain_p1[k] : 0.f;
  }
  float* lane_sum = static_cast<float*>(scratch);
  int* lane_cnt = reinterpret_cast<int*>(lane_sum + lanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return launch<float>(x, n, block_elems, blocks, lanes, compute, prologue, census, aligned,
                           chain, lane_sum, lane_cnt, ticket, out, s);
    case DT_BF16:
      return launch<__nv_bfloat16>(x, n, block_elems, blocks, lanes, compute, prologue, census,
                                   aligned, chain, lane_sum, lane_cnt, ticket, out, s);
    case DT_F16:
      return launch<__half>(x, n, block_elems, blocks, lanes, compute, prologue, census, aligned,
                            chain, lane_sum, lane_cnt, ticket, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
