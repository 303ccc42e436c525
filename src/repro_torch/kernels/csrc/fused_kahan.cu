// Striped single-launch full reduction with a per-lane Kahan carry.
//
// Replaces the TPU kernel `fused_kahan_kernel` of
// src/repro/kernels/mma_reduce/kernel.py (launcher `reduce_fused`,
// `kahan=True`). The geometry is the fused kernel's (fused_reduce.cu): a
// block is `r` m^2 tiles, lane c (a CTA) streams blocks c, c + C, ...,
// every lane runs `blocks_per_lane` blocks, and blocks past the real ones
// are zero tiles, as the reference's padded grid gives them.
//
// The carry cannot live in an MMA accumulator across tiles, as K1 keeps its
// sums: every tile's D = X @ 1 starts from zero, and each of its 128 row
// sums is then two-summed into that row's (acc, comp) pair, in tile order
// (kernel.py:309-316): y = d - comp; s = acc + y; comp = (s - acc) - y;
// acc = s. Warp w owns rows 16w .. 16w + 15 of every tile; each thread keeps
// the pairs of its two rows in registers over the whole lane. bf16 / f16
// row sums are eight m16n8k16 ones-MMAs per row strip; f32 sums on the
// CUDA cores (TF32 would round). The adds are __fadd_rn / __fsub_rn, which
// the compiler neither contracts nor reassociates, and the file is built
// without --use_fast_math: `(s - acc) - y` stays as written.
//
// Each lane writes its (acc[128], comp[128]). The last CTA to finish (an
// integer ticket, as in K1) folds them as `ops.combine_lane_partials_kahan`
// does: one serial Kahan pass over lane 0's acc rows, then its -comp rows,
// then lane 1's, ... (thread 0, from shared memory the CTA fills chunk by
// chunk), applies the epilogue chain and writes the total. One launch per
// call; repeat launches agree bitwise.
//
// Bound on this card: bytes (n * itemsize read once), as K1. The serial
// fold is a chain of 4 dependent f32 adds per value over 256 values per
// lane; at 528 lanes it is ~135 000 steps after the stream ends, which
// dominates the call: a later change would fold per lane in parallel
// before a short serial pass (not bitwise the reference's order).
#include "reduce_common.cuh"

namespace {

constexpr int KH_THREADS = 256;
constexpr int KH_WARPS = KH_THREADS / 32;
constexpr int KH_CHUNK = 2048;  // lane values staged per fold step (8 lanes)

__device__ __forceinline__ void kahan_add(float v, float& acc, float& comp) {
  const float y = __fsub_rn(v, comp);
  const float s = __fadd_rn(acc, y);
  comp = __fsub_rn(__fsub_rn(s, acc), y);
  acc = s;
}

template <typename T, int CD>
__global__ void __launch_bounds__(KH_THREADS)
fused_kahan_kernel(const T* __restrict__ x, long long n, int r, long long blocks,
                   long long blocks_per_lane, int prologue, int aligned, const Chain chain,
                   float* __restrict__ lane_part, unsigned int* __restrict__ ticket,
                   float* __restrict__ out) {
  __shared__ float stage[KH_CHUNK];
  __shared__ bool am_last;

  const int lane_id = blockIdx.x, lanes = gridDim.x;
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const int g = lid / 4, t = lid % 4;
  const int row0 = 16 * warp + g, row1 = row0 + 8;

  float acc0 = 0.f, comp0 = 0.f, acc1 = 0.f, comp1 = 0.f;
  for (long long j = 0; j < blocks_per_lane; ++j) {
    const long long b = j * lanes + lane_id;
    for (int tt = 0; tt < r; ++tt) {
      float2 d = make_float2(0.f, 0.f);
      if (b < blocks) {  // a whole zero tile past the real blocks adds D = 0
        const long long tile = (b * r + tt) * static_cast<long long>(RC_TILE);
        float v0[4][RC_GROUP], v1[4][RC_GROUP];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const long long off = 8 * t + 32 * u;
          load_group(x, tile + row0 * RC_ROW + off, n, aligned != 0, v0[u]);
          load_group(x, tile + row1 * RC_ROW + off, n, aligned != 0, v1[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int i = 0; i < RC_GROUP; ++i) {
            v0[u][i] = prologue_map<CD>(to_compute<CD>(v0[u][i]), prologue);
            v1[u][i] = prologue_map<CD>(to_compute<CD>(v1[u][i]), prologue);
          }
        }
        d = tile_row_sums<CD>(v0, v1);
      }
      kahan_add(d.x, acc0, comp0);
      kahan_add(d.y, acc1, comp1);
    }
  }
  // lane partial: [acc rows 0..127][comp rows 0..127]
  float* mine = lane_part + static_cast<long long>(lane_id) * 2 * RC_ROW;
  if (t == 0) {
    mine[row0] = acc0;
    mine[row1] = acc1;
    mine[RC_ROW + row0] = comp0;
    mine[RC_ROW + row1] = comp1;
  }
  __threadfence();  // publish the partial before taking a ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    am_last = atomicAdd(ticket, 1u) == static_cast<unsigned int>(lanes - 1);
    if (am_last) *ticket = 0u;  // every other CTA has taken its ticket
  }
  __syncthreads();
  if (!am_last) return;

  // The last CTA: one serial Kahan pass, lane by lane, acc rows then -comp.
  __threadfence();
  const long long total_vals = static_cast<long long>(lanes) * 2 * RC_ROW;
  float s = 0.f, c = 0.f;
  for (long long base = 0; base < total_vals; base += KH_CHUNK) {
    const int len = total_vals - base < KH_CHUNK ? static_cast<int>(total_vals - base) : KH_CHUNK;
    for (int i = threadIdx.x; i < len; i += KH_THREADS) {
      const long long k = base + i;
      const float v = __ldcg(lane_part + k);
      stage[i] = (k % (2 * RC_ROW)) < RC_ROW ? v : -v;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < len; ++i) kahan_add(stage[i], s, c);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = apply_chain(s, chain);
}

template <typename T, int CD>
int launch(const void* x, long long n, int r, long long blocks, long long bpl, int lanes,
           int prologue, int aligned, const Chain& chain, float* lane_part, unsigned int* ticket,
           float* out, cudaStream_t stream) {
  fused_kahan_kernel<T, CD><<<lanes, KH_THREADS, 0, stream>>>(
      static_cast<const T*>(x), n, r, blocks, bpl, prologue, aligned, chain, lane_part, ticket,
      out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_compute(const void* x, long long n, int compute, int r, long long blocks, long long bpl,
               int lanes, int prologue, int aligned, const Chain& chain, float* lane_part,
               unsigned int* ticket, float* out, cudaStream_t stream) {
  switch (compute) {
    case DT_F32:
      return launch<T, DT_F32>(x, n, r, blocks, bpl, lanes, prologue, aligned, chain, lane_part,
                               ticket, out, stream);
    case DT_BF16:
      return launch<T, DT_BF16>(x, n, r, blocks, bpl, lanes, prologue, aligned, chain,
                                lane_part, ticket, out, stream);
    case DT_F16:
      return launch<T, DT_F16>(x, n, r, blocks, bpl, lanes, prologue, aligned, chain, lane_part,
                               ticket, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: n elements of `dtype`, read flat. `r` (tiles per block), `blocks`,
// `blocks_per_lane` and `lanes` are the stripe geometry of
// ops.lane_geometry. `lane_part` holds lanes x 2 x 128 floats
// (uninitialised); `ticket` is one unsigned int, 0 on entry and on exit.
// `out` receives [epilogue(total)].
extern "C" int fk_sum(const void* x, long long n, int dtype, int compute, int prologue, int r,
                      long long blocks, long long blocks_per_lane, int lanes, int aligned,
                      int chain_len, const int* chain_ops, const float* chain_p0,
                      const float* chain_p1, float* out, float* lane_part, unsigned int* ticket,
                      void* stream) {
  Chain chain;
  if (n < 1 || r < 1 || lanes < 1 || lanes > blocks || blocks_per_lane * lanes < blocks ||
      prologue < PRO_IDENTITY || prologue > PRO_ABS ||
      !make_chain(chain_len, chain_ops, chain_p0, chain_p1, &chain))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return by_compute<float>(x, n, compute, r, blocks, blocks_per_lane, lanes, prologue,
                               aligned, chain, lane_part, ticket, out, s);
    case DT_BF16:
      return by_compute<__nv_bfloat16>(x, n, compute, r, blocks, blocks_per_lane, lanes,
                                       prologue, aligned, chain, lane_part, ticket, out, s);
    case DT_F16:
      return by_compute<__half>(x, n, compute, r, blocks, blocks_per_lane, lanes, prologue,
                                aligned, chain, lane_part, ticket, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
