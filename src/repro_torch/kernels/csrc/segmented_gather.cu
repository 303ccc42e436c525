// Segmented multi-reduce: S segments of one flat buffer -> S per-segment
// sums (or the moments pair, or sums and non-finite counts), in one launch.
//
// Replaces the TPU kernel `segmented_gather_kernel` of
// src/repro/kernels/mma_reduce/kernel.py (launcher `reduce_segments`). The
// buffer is read in place through the reference's aligned-block cover
// (ops.segment_cover_layout): cover tile t reads the whole m^2-aligned block
// `src[t]` of the caller's buffer (clipped to n) and keeps the elements of
// its window [lo[t], hi[t]) -- a non-aligned segment boundary reads its
// block once for each neighbour, as cost_model.segmented_hbm_bytes counts.
// The five int32 maps (src, seg, flush, lo, hi) sit in one (5, tpad) device
// array; pad tiles (fully masked, never flushed) carry segment S, so the
// segment row is sorted.
//
// Lanes are CTAs and stripe the cover one tile at a time, as the
// reference's grid does: lane c takes tiles c, c + C, ... Each value is
// cast to the compute dtype, masked to its window (before anything else),
// counted if non-finite (census), and mapped by the prologue there (square
// at the compute dtype; moments keeps the value and its square). Warp w
// owns tile rows 16w .. 16w + 15 (reduce_common.cuh `tile_row_sums`:
// m16n8k16 ones-MMAs with f32 accumulation at bf16 / f16 compute, CUDA-core
// f32 sums in a fixed order at f32 compute, where TF32 would round), and
// each thread adds its two rows' sums of every tile into f32 registers.
// At the tile the lane-aware flush map marks (the last tile of a segment in
// this lane's stripe) the CTA folds its 128 row accumulators in a fixed
// order (`block_fold`, ops.fold_rows_plain), writes the lane's sub-partial
// of that segment and starts again from 0. The flush flag, like every map,
// is the same for the whole CTA, so the branch around the fold is uniform
// and every warp issues the same MMAs.
//
// Each CTA first zeroes its row of the (C, out_slots) sub-partials (a lane
// visits only some segments). No float atomics: the last CTA to finish,
// found by an integer ticket, folds each segment's sub-partials over the
// lanes that streamed a tile of it, in lane order
// (ops.combine_segment_partials; a segment's cover tiles are a run of the
// sorted segment map, so the fold reads one value per cover tile at most,
// not all C x S), and maps every sum slot by the
// epilogue chain -- an empty segment's slot is the chain of 0 at any lane
// count. The ticket is a buffer the caller zeroes once; the last CTA sets it
// back to 0.
//
// Bound on this card: bytes (the cover's blocks read once each; 16 flops an
// element for the ones-MMA is far below the tensor-core rate).
#include "reduce_common.cuh"

namespace {

constexpr int SG_THREADS = 256;
constexpr int SG_WARPS = SG_THREADS / 32;

// The fixed fold of the CTA's 128 row values (ops.fold_rows_plain): the
// leader of quad g in warp w holds rows 16w + g (`a`) and 16w + g + 8 (`b`).
// Returns the total in thread 0; uses `warp_buf` and two barriers.
__device__ __forceinline__ float block_fold(float a, float b, float* warp_buf) {
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  float v = (lid & 3) == 0 ? a + b : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lid == 0) warp_buf[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < SG_WARPS; ++w) total += warp_buf[w];
  __syncthreads();
  return total;
}

// The CTA's total of one integer count per thread (exact in any order).
__device__ __forceinline__ float block_count(int c, float* warp_buf) {
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
  if (lid == 0) warp_buf[warp] = static_cast<float>(c);
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < SG_WARPS; ++w) total += warp_buf[w];
  __syncthreads();
  return total;
}

// DUAL: the moments pair (no census, no chain); the second accumulator
// holds the squares. With census each thread counts its non-finite values.
// Two CTAs per SM (at most 128 registers a thread) where that spills
// nothing: 25-35% faster at 2^28 than one; the moments variant needs more.
template <typename T, int CD, bool DUAL>
__global__ void __launch_bounds__(SG_THREADS, DUAL ? 1 : 2)
segments_kernel(const T* __restrict__ x, long long n, int prologue, int census,
                const int* __restrict__ maps, int tpad, int nseg, int aligned, const Chain chain,
                float* __restrict__ sub, float* __restrict__ out,
                unsigned int* __restrict__ ticket) {
  __shared__ float warp_buf[SG_WARPS];
  __shared__ bool am_last;

  const int lane_id = blockIdx.x, lanes = gridDim.x;
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const int g = lid / 4, t4 = lid % 4;
  const int row0 = 16 * warp + g, row1 = row0 + 8;
  const int out_slots = DUAL || census ? 2 * nseg : nseg;
  const int* src_of = maps;
  const int* seg_of = maps + tpad;
  const int* flush_of = maps + 2 * tpad;
  const int* lo_of = maps + 3 * tpad;
  const int* hi_of = maps + 4 * tpad;

  float* my_sub = sub + static_cast<long long>(lane_id) * out_slots;
  for (int s = threadIdx.x; s < out_slots; s += SG_THREADS) my_sub[s] = 0.f;
  __syncthreads();

  float acc0 = 0.f, acc1 = 0.f;  // this thread's two rows, summed over the lane's tiles
  float sec0 = 0.f, sec1 = 0.f;  // DUAL: their squares
  int cnt = 0;                   // census: this thread's non-finite values
  for (int t = lane_id; t < tpad; t += lanes) {
    const int lo = __ldg(lo_of + t), hi = __ldg(hi_of + t);
    if (hi > lo) {  // a cover tile (pad tiles are fully masked and never flush)
      const long long base = static_cast<long long>(__ldg(src_of + t)) * RC_TILE;
      const long long end = base + RC_TILE < n ? base + RC_TILE : n;
      float r0[4][RC_GROUP], r1[4][RC_GROUP];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int off = 8 * t4 + 32 * u;
        load_group(x, base + row0 * RC_ROW + off, end, aligned != 0, r0[u]);
        load_group(x, base + row1 * RC_ROW + off, end, aligned != 0, r1[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int i = 0; i < RC_GROUP; ++i) {
          const int lin0 = row0 * RC_ROW + 8 * t4 + 32 * u + i, lin1 = lin0 + 8 * RC_ROW;
          // mask to the window first, then cast, count and map
          const float v0 = lin0 >= lo && lin0 < hi ? to_compute<CD>(r0[u][i]) : 0.f;
          const float v1 = lin1 >= lo && lin1 < hi ? to_compute<CD>(r1[u][i]) : 0.f;
          cnt += (isfinite(v0) ? 0 : 1) + (isfinite(v1) ? 0 : 1);
          r0[u][i] = DUAL ? v0 : prologue_map<CD>(v0, prologue);
          r1[u][i] = DUAL ? v1 : prologue_map<CD>(v1, prologue);
        }
      }
      const float2 d = tile_row_sums<CD>(r0, r1);
      acc0 = acc0 + d.x;
      acc1 = acc1 + d.y;
      if (DUAL) {
        const float2 d2 = tile_row_sums<CD, true>(r0, r1);
        sec0 = sec0 + d2.x;
        sec1 = sec1 + d2.y;
      }
    }
    if (__ldg(flush_of + t)) {  // CTA-uniform: the fold's barriers are safe
      const int seg = __ldg(seg_of + t);
      const float total = block_fold(acc0, acc1, warp_buf);
      if (threadIdx.x == 0) my_sub[seg] = total;
      acc0 = acc1 = 0.f;
      if (DUAL || census) {
        const float total2 = DUAL ? block_fold(sec0, sec1, warp_buf) : block_count(cnt, warp_buf);
        if (threadIdx.x == 0) my_sub[nseg + seg] = total2;
        sec0 = sec1 = 0.f;
        cnt = 0;
      }
    }
  }

  __threadfence();  // every thread publishes its sub-partial writes
  __syncthreads();
  if (threadIdx.x == 0) {
    am_last = atomicAdd(ticket, 1u) == static_cast<unsigned int>(lanes - 1);
    if (am_last) *ticket = 0u;  // every other CTA has taken its ticket
  }
  __syncthreads();
  if (!am_last) return;

  // The last CTA folds, for each segment, the lanes that streamed a tile of
  // it -- those of its cover tiles [a, b), tile t being lane t mod C's -- in
  // lane order (ops.combine_segment_partials), and maps the sum slots. An
  // empty segment keeps the chain of 0; a segment's first cover tile (the
  // sorted segment map changes there) is found by a coalesced pass over the
  // tiles, and the run after it is read up to C tiles.
  __threadfence();
  const bool two = DUAL || census;
  for (int s = threadIdx.x; s < nseg; s += SG_THREADS) {
    out[s] = apply_chain(0.f, chain);
    if (two) out[nseg + s] = 0.f;
  }
  __syncthreads();
  for (int a = threadIdx.x; a < tpad; a += SG_THREADS) {
    const int s = __ldg(seg_of + a);
    if (s >= nseg || (a > 0 && __ldg(seg_of + a - 1) == s)) continue;
    int b = a + 1;
    while (b < tpad && b - a < lanes && __ldg(seg_of + b) == s) ++b;
    // the touched lanes in increasing order: one or two runs
    int r0 = 0, r1 = lanes, q0 = 0, q1 = 0;
    if (b - a < lanes) {
      const int c0 = a % lanes, c1 = (b - 1) % lanes;
      if (c0 <= c1) {
        r0 = c0;
        r1 = c1 + 1;
      } else {  // wrapped: lanes 0 .. c1, then c0 .. C - 1
        r1 = c1 + 1;
        q0 = c0;
        q1 = lanes;
      }
    }
    float v = 0.f, v2 = 0.f;
    bool started = false;
    for (int run = 0; run < 2; ++run) {
      const int lo = run == 0 ? r0 : q0, hi = run == 0 ? r1 : q1;
      for (int c = lo; c < hi; ++c) {
        const float* row = sub + static_cast<long long>(c) * out_slots;
        const float x0 = __ldcg(row + s);
        v = started ? v + x0 : x0;
        if (two) {
          const float x1 = __ldcg(row + nseg + s);
          v2 = started ? v2 + x1 : x1;
        }
        started = true;
      }
    }
    out[s] = apply_chain(v, chain);
    if (two) out[nseg + s] = v2;
  }
}

template <typename T, bool DUAL>
int launch(const void* x, long long n, int compute, int prologue, int census, const int* maps,
           int tpad, int lanes, int nseg, int aligned, const Chain& chain, float* sub, float* out,
           unsigned int* ticket, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  switch (compute) {
    case DT_F32:
      segments_kernel<T, DT_F32, DUAL><<<lanes, SG_THREADS, 0, stream>>>(
          xt, n, prologue, census, maps, tpad, nseg, aligned, chain, sub, out, ticket);
      break;
    case DT_BF16:
      segments_kernel<T, DT_BF16, DUAL><<<lanes, SG_THREADS, 0, stream>>>(
          xt, n, prologue, census, maps, tpad, nseg, aligned, chain, sub, out, ticket);
      break;
    case DT_F16:
      segments_kernel<T, DT_F16, DUAL><<<lanes, SG_THREADS, 0, stream>>>(
          xt, n, prologue, census, maps, tpad, nseg, aligned, chain, sub, out, ticket);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool DUAL>
int by_dtype(const void* x, long long n, int dtype, int compute, int prologue, int census,
             const int* maps, int tpad, int lanes, int nseg, int aligned, const Chain& chain,
             float* sub, float* out, unsigned int* ticket, cudaStream_t stream) {
  switch (dtype) {
    case DT_F32:
      return launch<float, DUAL>(x, n, compute, prologue, census, maps, tpad, lanes, nseg,
                                 aligned, chain, sub, out, ticket, stream);
    case DT_BF16:
      return launch<__nv_bfloat16, DUAL>(x, n, compute, prologue, census, maps, tpad, lanes,
                                         nseg, aligned, chain, sub, out, ticket, stream);
    case DT_F16:
      return launch<__half, DUAL>(x, n, compute, prologue, census, maps, tpad, lanes, nseg,
                                  aligned, chain, sub, out, ticket, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: n elements of `dtype`, read flat. `maps`: the device (5, tpad) int32
// cover maps (src block, segment, lane-aware flush flag, lo, hi) of a
// `lanes`-lane stripe (tpad = lanes * tiles per lane). `prologue`: 0
// identity, 1 square, 2 abs, 3 moments (no census, no chain). `sub` holds
// lanes x out_slots floats (uninitialised; out_slots = 2 nseg for moments or
// census, else nseg); `out` receives the out_slots folded values; `ticket`
// is one unsigned int that is 0 on entry and 0 again when the kernel ends.
extern "C" int sg_segments(const void* x, long long n, int dtype, int compute, int prologue,
                           int census, const int* maps, int tpad, int lanes, int nseg,
                           int aligned, int chain_len, const int* chain_ops,
                           const float* chain_p0, const float* chain_p1, float* sub, float* out,
                           unsigned int* ticket, void* stream) {
  Chain chain;
  const bool dual = prologue == PRO_MOMENTS;
  if (n < 1 || lanes < 1 || tpad < lanes || tpad % lanes != 0 || nseg < 1 ||
      prologue < PRO_IDENTITY || prologue > PRO_MOMENTS || (dual && (census || chain_len)) ||
      !make_chain(chain_len, chain_ops, chain_p0, chain_p1, &chain))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dual)
    return by_dtype<true>(x, n, dtype, compute, prologue, 0, maps, tpad, lanes, nseg, aligned,
                          chain, sub, out, ticket, s);
  return by_dtype<false>(x, n, dtype, compute, prologue, census, maps, tpad, lanes, nseg,
                         aligned, chain, sub, out, ticket, s);
}
