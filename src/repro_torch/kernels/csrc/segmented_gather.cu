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
// owns tile rows 16w .. 16w + 15: thread (g, t) of the warp holds, for
// rows 16w + g and 16w + g + 8, the 32 elements 8t + 32u + i (u < 4,
// i < 8) of each; at bf16 / f16 compute they feed eight m16n8k16
// ones-MMAs with f32 accumulation, at f32 compute CUDA-core sums in a
// fixed order (each thread's 32 in (u, i) order, then the row's quad by a
// shuffle tree), where TF32 would round. Each thread adds its two rows'
// sums of every tile into f32 registers. At the tile the lane-aware flush
// map marks (the last tile of a segment in this lane's stripe) the CTA
// folds its 128 row accumulators in a fixed order (ops.fold_rows_plain),
// writes the lane's sub-partial of that segment and starts again from 0.
// The flush flag, like every map, is the same for the whole CTA, so the
// branches around the MMAs and the fold are uniform and every warp issues
// the same MMAs.
//
// What bounds it on this card is bytes (the cover's blocks read once each;
// 16 flops an element for the ones-MMA is far below the tensor-core rate),
// and the design keeps the per-tile work off that stream:
// - a ring of SG_STAGES blocks in shared memory, each filled whole by one
//   bulk copy (1-D TMA, issued by thread 0, completing on the stage's
//   mbarrier), so two tiles are in flight while one is summed; a block
//   clipped at n, or any block of a buffer that is not 16-byte aligned,
//   is loaded by each thread's own element loads into the stage instead.
//   The maps are read SG_STAGES + 1 tiles ahead, so no copy waits on a map;
// - the words stay as loaded until they are the MMA's A operand (the word
//   route of reduce_common.cuh): a bf16 / f16 input at its own compute
//   dtype is not converted at all, an f32 input is rounded once per pair;
//   prologue and census are template parameters, and the window mask runs
//   only on tiles that a segment boundary cuts (lo > 0 or hi < m^2; the
//   branch is uniform, the MMAs sit after it);
// - one barrier a tile: it frees the stage and publishes a fold's warp
//   totals (which alternate between two shared buffers); the census or
//   moments second statistic shares it;
// - the last CTA's fold over the lanes reads each segment's lane values at
//   once, whole segments to a thread from a list of the segments' first
//   tiles built in the ring (below), and the blocks are loaded with an
//   evict-first L2 policy, so the maps and sub-partials it reads stay in
//   L2.
// Each ones-MMA gets the A operands it got before this design, so the
// output is bitwise the earlier kernel's at every compute dtype, and
// bitwise `mma_sum_segments_plain` at f32 compute.
//
// Each CTA first zeroes its row of the (C, out_slots) sub-partials (a lane
// visits only some segments). No float atomics: the last CTA to finish,
// found by an integer ticket, folds each segment's sub-partials over the
// lanes that streamed a tile of it, in lane order
// (ops.combine_segment_partials; a segment's cover tiles are a run of the
// sorted segment map, so the fold reads one value per cover tile at most,
// not all C x S), and maps every sum slot by the epilogue chain -- an
// empty segment's slot is the chain of 0 at any lane count. The ticket is
// a buffer the caller zeroes once; the last CTA sets it back to 0.
#include <type_traits>

#include "hopper.cuh"
#include "reduce_common.cuh"

namespace {

constexpr int SG_THREADS = 256;
constexpr int SG_WARPS = SG_THREADS / 32;
constexpr int SG_STAGES = 3;  // cover tiles a CTA holds in shared memory: two in flight
constexpr int SG_BATCH = 16;  // a segment's lane values a thread reads at once in the last CTA

// One cover tile's five map words (CTA-uniform); past the maps, a pad.
struct TileMap {
  int src, seg, flush, lo, hi;
};

__device__ __forceinline__ TileMap tile_map(const int* maps, int tpad, int t) {
  TileMap m{0, 0, 0, 0, 0};
  if (t < tpad) {
    m.src = __ldg(maps + t);
    m.seg = __ldg(maps + tpad + t);
    m.flush = __ldg(maps + 2 * tpad + t);
    m.lo = __ldg(maps + 3 * tpad + t);
    m.hi = __ldg(maps + 4 * tpad + t);
  }
  return m;
}

// The warp's share of the fixed fold of the CTA's 128 row values
// (ops.fold_rows_plain): the leader of quad g holds rows 16w + g (`a`) and
// 16w + g + 8 (`b`); a shuffle-down tree; the total in lane 0.
__device__ __forceinline__ float warp_rows(float a, float b) {
  float v = (threadIdx.x & 3) == 0 ? a + b : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The warp's total of one integer count per thread (exact in any order).
__device__ __forceinline__ float warp_count(int c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
  return static_cast<float>(c);
}

// One cover tile's block, whole, from global into shared memory by the
// bulk copy engine (1-D TMA); its bytes complete on the mbarrier. The block
// is read once (twice at a cut boundary, at once), so L2 evicts it first:
// the maps and the sub-partials the last CTA reads stay there.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 policy;\n"
      "createpolicy.fractional.L2::evict_first.b64 policy, 1.0;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], policy;\n}\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// PRO: identity, square, abs, or moments (the value and its square, no
// census, no chain). CENSUS: each thread counts its non-finite values. Two
// CTAs per SM at 16-bit input (at most 128 registers a thread, a 96 KB
// ring each); one at f32 input (a 192 KB ring) and for moments.
template <typename T, int CD, int PRO, bool CENSUS>
__global__ void __launch_bounds__(SG_THREADS, PRO == PRO_MOMENTS ? 1 : 2)
segments_kernel(const T* __restrict__ x, long long n, const int* __restrict__ maps, int tpad,
                int nseg, int aligned, const Chain chain, float* __restrict__ sub,
                float* __restrict__ out, unsigned int* __restrict__ ticket) {
  constexpr bool DUAL = PRO == PRO_MOMENTS;
  constexpr bool TWO = DUAL || CENSUS;
  constexpr bool WORDS = CD != DT_F32;  // the ones-MMA on compute-dtype words
  constexpr uint32_t TILE_BYTES = RC_TILE * sizeof(T);
  extern __shared__ __align__(128) unsigned char ring[];  // SG_STAGES blocks of T
  __shared__ __align__(8) uint64_t full[SG_STAGES];
  __shared__ float fold_buf[2][2][SG_WARPS];  // [fold parity][statistic][warp]
  __shared__ bool am_last;

  const int lane_id = blockIdx.x, lanes = gridDim.x;
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const int lin0 = (16 * warp + lid / 4) * RC_ROW + 8 * (lid % 4);  // row g, u = 0, i = 0
  const int out_slots = TWO ? 2 * nseg : nseg;
  const int* seg_of = maps + tpad;
  const bool vec = aligned != 0;

  // A cover tile's block comes by the bulk copy when the buffer is 16-byte
  // aligned and the block is whole; else (the block clipped at n, or an
  // unaligned buffer) every thread loads its groups itself.
  auto bulk = [&](const TileMap& m) {
    return m.hi > m.lo && vec && static_cast<long long>(m.src) * RC_TILE + RC_TILE <= n;
  };
  auto issue = [&](const TileMap& m, int s) {  // thread 0
    fence_proxy_async();  // the stage's earlier reads come before the copy's writes
    mbar_expect_tx(smem_u32(&full[s]), TILE_BYTES);
    bulk_load(smem_u32(ring + s * TILE_BYTES), x + static_cast<long long>(m.src) * RC_TILE,
              TILE_BYTES, smem_u32(&full[s]));
  };

  // q[j]: the map of the lane's tile k + j at its k-th tile
  TileMap q[SG_STAGES + 1];
#pragma unroll
  for (int j = 0; j <= SG_STAGES; ++j) q[j] = tile_map(maps, tpad, lane_id + j * lanes);
  if (threadIdx.x == 0) {
    for (int s = 0; s < SG_STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    mbar_init_fence();
  }
  float* my_sub = sub + static_cast<long long>(lane_id) * out_slots;
  for (int s = threadIdx.x; s < out_slots; s += SG_THREADS) my_sub[s] = 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < SG_STAGES; ++s)
      if (bulk(q[s])) issue(q[s], s);
  }

  float acc0 = 0.f, acc1 = 0.f;  // this thread's two rows, summed over the lane's tiles
  float sec0 = 0.f, sec1 = 0.f;  // DUAL: their squares
  int cnt = 0;                   // census: this thread's non-finite values
  int parity = 0;                // of the fold buffer
  uint32_t phases = 0;           // bit s: the parity stage s completes next
  for (int t = lane_id, k = 0; t < tpad; t += lanes, ++k) {
    const int s = k % SG_STAGES;
    const TileMap m = q[0];
    const TileMap later = tile_map(maps, tpad, t + (SG_STAGES + 1) * lanes);
    if (m.hi > m.lo) {  // a cover tile (pad tiles are fully masked and never flush)
      T* tile = reinterpret_cast<T*>(ring + s * TILE_BYTES);
      if (bulk(m)) {
        mbar_wait(smem_u32(&full[s]), (phases >> s) & 1u);
        phases ^= 1u << s;
      } else {  // this thread's groups, loaded by elements into the stage
        const long long base = static_cast<long long>(m.src) * RC_TILE;
        const long long end = base + RC_TILE < n ? base + RC_TILE : n;
#pragma unroll 1  // a row of groups at a time: 32 element loads in flight, not 64
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int lin = lin0 + r * 8 * RC_ROW + 32 * u;
            Raw<T> g;
            load_raw(x, base + lin, end, vec, g);
            *reinterpret_cast<Raw<T>*>(tile + lin) = g;
          }
        // read back through shared memory, as a bulk tile; a later bulk copy
        // into this stage comes after these writes
        fence_proxy_async();
      }
      // raw[r][u]: row g + 8r, elements 8t + 32u .. + 8 of the tile
      Raw<T> raw[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          raw[r][u] = *reinterpret_cast<const Raw<T>*>(tile + lin0 + r * 8 * RC_ROW + 32 * u);
      uint32_t w[2][4][4], w2[2][4][4];  // WORDS: A operands (w2: DUAL's squares)
      float rs[2] = {0.f, 0.f}, qs[2] = {0.f, 0.f};  // f32 compute: row sums (qs: squares)
      auto take = [&](auto masked) {
        constexpr bool MASK = decltype(masked)::value;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int lin = lin0 + r * 8 * RC_ROW + 32 * u;
            if constexpr (WORDS) {
              uint32_t v[4];
              raw_words<T, CD>(raw[r][u], v);
              if (MASK) mask_words(v, lin, m.lo, m.hi);  // before anything else
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (CENSUS) cnt += nonfinite_halves<CD>(v[j]);
                if (DUAL) w2[r][u][j] = prologue_word<CD, PRO_SQUARE>(v[j]);
                w[r][u][j] = DUAL ? v[j] : prologue_word<CD, PRO>(v[j]);
              }
            } else {
#pragma unroll
              for (int i = 0; i < RC_GROUP; ++i) {
                float v = raw_elem(raw[r][u], i);
                if (MASK) v = lin + i >= m.lo && lin + i < m.hi ? v : 0.f;
                if (CENSUS) cnt += isfinite(v) ? 0 : 1;
                const float sq = __fmul_rn(v, v);
                rs[r] = __fadd_rn(rs[r], PRO == PRO_SQUARE ? sq : PRO == PRO_ABS ? fabsf(v) : v);
                if (DUAL) qs[r] = __fadd_rn(qs[r], sq);
              }
            }
          }
        }
      };
      if (m.lo == 0 && m.hi == RC_TILE) take(std::false_type{});  // interior: no mask
      else take(std::true_type{});
      if constexpr (WORDS) {
        float d[4] = {0.f, 0.f, 0.f, 0.f}, d2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t a[4] = {w[0][u][2 * h], w[1][u][2 * h], w[0][u][2 * h + 1],
                                   w[1][u][2 * h + 1]};
            ones_mma<CD>(d, a);
            if (DUAL) {
              const uint32_t b[4] = {w2[0][u][2 * h], w2[1][u][2 * h], w2[0][u][2 * h + 1],
                                     w2[1][u][2 * h + 1]};
              ones_mma<CD>(d2, b);
            }
          }
        }
        acc0 = acc0 + d[0];
        acc1 = acc1 + d[2];
        if (DUAL) {
          sec0 = sec0 + d2[0];
          sec1 = sec1 + d2[2];
        }
      } else {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rs[r] = __fadd_rn(rs[r], __shfl_xor_sync(0xffffffffu, rs[r], 1));
          rs[r] = __fadd_rn(rs[r], __shfl_xor_sync(0xffffffffu, rs[r], 2));
          if (DUAL) {
            qs[r] = __fadd_rn(qs[r], __shfl_xor_sync(0xffffffffu, qs[r], 1));
            qs[r] = __fadd_rn(qs[r], __shfl_xor_sync(0xffffffffu, qs[r], 2));
          }
        }
        acc0 = acc0 + rs[0];
        acc1 = acc1 + rs[1];
        if (DUAL) {
          sec0 = sec0 + qs[0];
          sec1 = sec1 + qs[1];
        }
      }
    }
    if (m.flush) {  // CTA-uniform, as every map
      const float v = warp_rows(acc0, acc1);
      const float v2 = DUAL ? warp_rows(sec0, sec1) : CENSUS ? warp_count(cnt) : 0.f;
      if (lid == 0) {
        fold_buf[parity][0][warp] = v;
        if (TWO) fold_buf[parity][1][warp] = v2;
      }
      acc0 = acc1 = sec0 = sec1 = 0.f;
      cnt = 0;
    }
    // One barrier a tile: stage s is read by every thread, and a fold's
    // warp totals are in. The next fold writes the other buffer; the one
    // after it comes after a later barrier, which thread 0 reaches only
    // once it has read this one.
    __syncthreads();
    if (threadIdx.x == 0) {
      if (m.flush) {
        float total = 0.f, total2 = 0.f;
        for (int w = 0; w < SG_WARPS; ++w) {
          total += fold_buf[parity][0][w];
          if (TWO) total2 += fold_buf[parity][1][w];
        }
        my_sub[m.seg] = total;
        if (TWO) my_sub[nseg + m.seg] = total2;
      }
      if (bulk(q[SG_STAGES])) issue(q[SG_STAGES], s);  // tile k + SG_STAGES into stage s
    }
    if (m.flush) parity ^= 1;
#pragma unroll
    for (int j = 0; j < SG_STAGES; ++j) q[j] = q[j + 1];
    q[SG_STAGES] = later;
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
  // empty segment keeps the chain of 0. A segment's first cover tile is
  // where the sorted segment map changes; the ring, free now, holds a chunk
  // of the map and the list of the chunk's segment starts in tile order
  // (a block-wide scan places them), so every thread then folds whole
  // segments -- one after another, each with its lanes' values read at once
  // -- and no thread idles while another of its warp folds. (The tail runs
  // on one SM after the stream, where the map and the sub-partials have
  // left L2: a thread that waited for a read per tile and per lane, as the
  // first version did, kept the card ~0.3 ms.)
  __threadfence();
  for (int s = threadIdx.x; s < nseg; s += SG_THREADS) {
    out[s] = apply_chain(0.f, chain);
    if (TWO) out[nseg + s] = 0.f;
  }
  __shared__ int warp_starts[SG_WARPS];
  constexpr int CAP = SG_STAGES * TILE_BYTES / sizeof(int);
  constexpr int CH = ((CAP - 3) / 3) / SG_THREADS * SG_THREADS;  // tiles a chunk
  int* segs = reinterpret_cast<int*>(ring);        // [i]: the segment of tile c0 + i - 1
  int2* starts = reinterpret_cast<int2*>(segs + CH + 2);  // (tile, segment), in tile order
  int2 carry = make_int2(-1, -1);  // the last start of the chunk before: its run goes on
  for (int c0 = 0; c0 < tpad; c0 += CH) {
    const int len = tpad - c0 < CH ? tpad - c0 : CH;
#pragma unroll 16
    for (int i = threadIdx.x; i <= len; i += SG_THREADS)
      segs[i] = c0 + i > 0 ? __ldg(seg_of + c0 + i - 1) : -1;
    __syncthreads();
    // this thread's tiles [lo, hi) of the chunk: count, place, write its starts
    const int per = (len + SG_THREADS - 1) / SG_THREADS;
    const int lo = static_cast<int>(threadIdx.x) * per < len ? threadIdx.x * per : len;
    const int hi = lo + per < len ? lo + per : len;
    int mine = 0;
    for (int i = lo; i < hi; ++i) mine += segs[i + 1] != segs[i];
    int incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lid >= off) incl += v;
    }
    if (lid == 31) warp_starts[warp] = incl;
    __syncthreads();
    int pos = carry.x >= 0 ? 1 : 0, total = pos;
    for (int w = 0; w < SG_WARPS; ++w) {
      pos += w < warp ? warp_starts[w] : 0;
      total += warp_starts[w];
    }
    pos += incl - mine;
    for (int i = lo; i < hi; ++i)
      if (segs[i + 1] != segs[i]) starts[pos++] = make_int2(c0 + i, segs[i + 1]);
    if (threadIdx.x == 0 && carry.x >= 0) starts[0] = carry;
    __syncthreads();
    const bool last = c0 + len >= tpad;
    for (int k = threadIdx.x; k < (last ? total : total - 1); k += SG_THREADS) {
      const int a = starts[k].x, s = starts[k].y;
      const int b = k + 1 < total ? starts[k + 1].x : tpad;
      if (s >= nseg) continue;  // the pad tiles after the last segment
      // the touched lanes in increasing order: one or two runs
      int r0 = 0, r1 = lanes, q0 = 0, q1 = 0;
      if (b - a < lanes) {
        const int l0 = a % lanes, l1 = (b - 1) % lanes;
        if (l0 <= l1) {
          r0 = l0;
          r1 = l1 + 1;
        } else {  // wrapped: lanes 0 .. l1, then l0 .. C - 1
          r1 = l1 + 1;
          q0 = l0;
          q1 = lanes;
        }
      }
      float v = 0.f, v2 = 0.f;
      bool started = false;
      for (int run = 0; run < 2; ++run) {
        const int from = run == 0 ? r0 : q0, to = run == 0 ? r1 : q1;
        for (int c = from; c < to; c += SG_BATCH) {
          float x0[SG_BATCH], x1[SG_BATCH];
#pragma unroll
          for (int i = 0; i < SG_BATCH; ++i) {
            const float* row = sub + static_cast<long long>(c + i) * out_slots;
            x0[i] = c + i < to ? __ldcg(row + s) : 0.f;
            if (TWO) x1[i] = c + i < to ? __ldcg(row + nseg + s) : 0.f;
          }
#pragma unroll
          for (int i = 0; i < SG_BATCH; ++i) {
            if (c + i >= to) break;
            v = started ? v + x0[i] : x0[i];
            if (TWO) v2 = started ? v2 + x1[i] : x1[i];
            started = true;
          }
        }
      }
      out[s] = apply_chain(v, chain);
      if (TWO) out[nseg + s] = v2;
    }
    carry = starts[total - 1];
    __syncthreads();  // the next chunk overwrites the map and the list
  }
}

struct Launch {
  const void* x;
  long long n;
  const int* maps;
  int tpad, lanes, nseg, aligned;
  Chain chain;
  float* sub;
  float* out;
  unsigned int* ticket;
  cudaStream_t stream;
};

template <typename T, int CD, int PRO, bool CENSUS>
int launch(const Launch& a) {
  constexpr int smem = SG_STAGES * RC_TILE * static_cast<int>(sizeof(T));
  const cudaError_t attr = cudaFuncSetAttribute(
      segments_kernel<T, CD, PRO, CENSUS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  segments_kernel<T, CD, PRO, CENSUS><<<a.lanes, SG_THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.x), a.n, a.maps, a.tpad, a.nseg, a.aligned, a.chain, a.sub,
      a.out, a.ticket);
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
  Launch a{x, n, maps, tpad, lanes, nseg, aligned, {}, sub, out, ticket,
           static_cast<cudaStream_t>(stream)};
  const bool dual = prologue == PRO_MOMENTS;
  if (n < 1 || lanes < 1 || tpad < lanes || tpad % lanes != 0 || nseg < 1 ||
      prologue < PRO_IDENTITY || prologue > PRO_MOMENTS || (dual && (census || chain_len)) ||
      !make_chain(chain_len, chain_ops, chain_p0, chain_p1, &a.chain))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case DT_F32: return by_compute<float>(compute, prologue, census, a);
    case DT_BF16: return by_compute<__nv_bfloat16>(compute, prologue, census, a);
    case DT_F16: return by_compute<__half>(compute, prologue, census, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
