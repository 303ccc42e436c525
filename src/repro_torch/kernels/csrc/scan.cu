// Prefix sum of a flat buffer by triangular MMAs, in one launch.
//
// Replaces the TPU kernel `scan_kernel` of src/repro/kernels/scan.py
// (launcher `mma_scan_pallas`). Per m x m tile X (m = 128, row-major: flat
// index p = 128 i + j), as the reference:
//
//   T1 = X @ J                 row totals
//   D[i] = T1[0] + ... + T1[i-1]   (the reference's Ls @ T1)
//   R = X @ U                  each row's running prefix (U strictly upper
//                              for the exclusive scan)
//   out = (R + D) + carry      written in the storage dtype
//
// and the tile's total, read off the corner D[127] + T1[127] (never off R),
// feeds the f32 carry, folded strictly left to right. Lanes (CTAs) own
// contiguous ranges of blocks of `r` tiles and rebuild their carry by
// re-reading every tile before their range (T1 and D only; nothing
// written), so the carry of a tile is the same chain of f32 adds at every
// lane count and the output is bitwise the same. That re-read is the
// `refetch_read` of cost_model.scan_hbm_bytes: extra lanes add bytes and
// shorten no chain, so the wrapper defaults to one lane.
//
// Each warp of a CTA takes one tile of a group of eight consecutive tiles:
// it computes its tile's T1 and D and total, one thread folds the eight
// totals into the carry in tile order, and each warp then writes its tile,
// re-reading it (from L2). f32 compute has no exact tensor-core product
// (TF32 keeps 10 mantissa bits): lane l adds rows l, l + 32, l + 64, l + 96
// left to right in f32, so R[i, 127] is T1[i] and the exclusive prefix is
// the inclusive one shifted, bit for bit. bf16 / f16 compute runs the
// products on the tensor cores: each row strip of 16 as the A operand
// (reduce_common.cuh's element order), T1 eight m16n8k16 ones-MMAs per
// strip, R 16 column chunks of eight MMAs each, B the 0/1 triangular
// operand built in registers (exact at bf16 and f16). Every column of R
// chains the same eight products in the same order as T1, so R[:, 127] is
// T1 and strict-U column j is inclusive column j - 1, bit for bit. D is one
// lane's left-to-right fold of the tile's 128 row totals.
//
// Bound on this card: bytes (n read once, the block-padded prefix written
// once; the MMAs are far below the tensor-core rate). One lane streams the
// whole buffer through one SM, which leaves the card far from that bound: a
// chained handoff of each group's carry between CTAs keeps the same fold
// and is the next step.
#include "reduce_common.cuh"

namespace {

constexpr int SC_THREADS = 256;
constexpr int SC_WARPS = SC_THREADS / 32;  // tiles in flight per CTA, one per warp

// bf16 / f16 bit patterns of 1.0 in the low half
template <int CD>
__device__ __forceinline__ uint32_t one_bits() {
  return CD == DT_BF16 ? 0x3F80u : 0x3C00u;
}

template <int CD>
__device__ __forceinline__ uint32_t pack_c(float a, float b) {
  return CD == DT_BF16 ? pack_bf16(a, b) : pack_f16(a, b);
}

template <int CD>
__device__ __forceinline__ void mma_c(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  if (CD == DT_BF16) mma_bf16_16816(d, a, b0, b1);
  else mma_f16_16816(d, a, b0, b1);
}

template <typename T>
__device__ __forceinline__ void store_group(T* out, long long e, const float (&v)[RC_GROUP]) {
#pragma unroll
  for (int i = 0; i < RC_GROUP; i += 2) store_pair(out + e + i, v[i], v[i + 1]);
}

// f32 compute: lane l of the warp owns rows l, l + 32, l + 64, l + 96 of its
// tile and adds each left to right in f32. EMIT writes the prefix:
// (R + D) + carry, R the running sum (inclusive) or the one before it.
template <typename T, bool EMIT>
__device__ __forceinline__ void rows_f32(const T* __restrict__ x, long long base, long long n,
                                         bool aligned, int lid, float (&acc)[4],
                                         const float* dn, float carry, int inclusive,
                                         T* __restrict__ out) {
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] = 0.f;
#pragma unroll 2
  for (int gi = 0; gi < RC_ROW / RC_GROUP; ++gi) {
    float v[4][RC_GROUP];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      load_group(x, base + (lid + 32 * r) * RC_ROW + RC_GROUP * gi, n, aligned, v[r]);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float o[RC_GROUP];
#pragma unroll
      for (int i = 0; i < RC_GROUP; ++i) {
        const float prev = acc[r];
        acc[r] = __fadd_rn(acc[r], v[r][i]);
        if (EMIT) o[i] = __fadd_rn(__fadd_rn(inclusive ? acc[r] : prev, dn[r]), carry);
      }
      if (EMIT) store_group(out, base + (lid + 32 * r) * RC_ROW + RC_GROUP * gi, o);
    }
  }
}

// bf16 / f16 compute: row strip s (rows 16 s + g and 16 s + g + 8) of the
// warp's tile as the A operand of the eight k-chunks (reduce_common.cuh's
// element order: k slots 2 t4, 2 t4 + 1 hold columns c0, c0 + 1 and slots
// 2 t4 + 8, 2 t4 + 9 hold c0 + 2, c0 + 3, c0 = 8 t4 + 32 u + 4 h).
template <typename T, int CD>
__device__ __forceinline__ void strip_a(const T* __restrict__ x, long long base, long long n,
                                        bool aligned, int s, int g, int t4,
                                        uint32_t (&A)[8][4]) {
  const int row0 = 16 * s + g, row1 = row0 + 8;
  float r0[4][RC_GROUP], r1[4][RC_GROUP];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    load_group(x, base + row0 * RC_ROW + 8 * t4 + 32 * u, n, aligned, r0[u]);
    load_group(x, base + row1 * RC_ROW + 8 * t4 + 32 * u, n, aligned, r1[u]);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * h;
      A[2 * u + h][0] = pack_c<CD>(r0[u][i], r0[u][i + 1]);
      A[2 * u + h][1] = pack_c<CD>(r1[u][i], r1[u][i + 1]);
      A[2 * u + h][2] = pack_c<CD>(r0[u][i + 2], r0[u][i + 3]);
      A[2 * u + h][3] = pack_c<CD>(r1[u][i + 2], r1[u][i + 3]);
    }
  }
}

// Phase A of one warp's tile: its 128 row totals T1 into `t1`, then lane 0
// folds them left to right into D (`dn`) and returns the tile total
// D[127] + T1[127] (the corner of D + T1) in lane 0.
template <typename T, int CD>
__device__ __forceinline__ float tile_totals(const T* __restrict__ x, long long base, long long n,
                                             bool aligned, float* t1, float* dn) {
  const int lid = threadIdx.x % 32;
  if constexpr (CD == DT_F32) {
    float acc[4];
    rows_f32<T, false>(x, base, n, aligned, lid, acc, nullptr, 0.f, 1,
                       static_cast<T*>(nullptr));
#pragma unroll
    for (int r = 0; r < 4; ++r) t1[lid + 32 * r] = acc[r];
  } else {
    const int g = lid / 4, t4 = lid % 4;
    const uint32_t ones = one_bits<CD>() | (one_bits<CD>() << 16);
    for (int s = 0; s < RC_ROW / 16; ++s) {
      uint32_t A[8][4];
      strip_a<T, CD>(x, base, n, aligned, s, g, t4, A);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 8; ++k) mma_c<CD>(d, A[k], ones, ones);  // T1 = X @ J
      if (t4 == 0) {
        t1[16 * s + g] = d[0];
        t1[16 * s + g + 8] = d[2];
      }
    }
  }
  __syncwarp();
  float total = 0.f;
  if (lid == 0) {
#pragma unroll 8
    for (int i = 0; i < RC_ROW; ++i) {
      dn[i] = total;
      total = __fadd_rn(total, t1[i]);
    }
  }
  __syncwarp();
  return total;
}

// Phase B of one warp's tile: the prefix (R + D) + carry, written.
template <typename T, int CD>
__device__ __forceinline__ void tile_emit(const T* __restrict__ x, long long base, long long n,
                                          bool aligned, const float* dn, float carry,
                                          int inclusive, T* __restrict__ out) {
  const int lid = threadIdx.x % 32;
  if constexpr (CD == DT_F32) {
    float acc[4];
    const float d4[4] = {dn[lid], dn[lid + 32], dn[lid + 64], dn[lid + 96]};
    rows_f32<T, true>(x, base, n, aligned, lid, acc, d4, carry, inclusive, out);
  } else {
    const int g = lid / 4, t4 = lid % 4;
    for (int s = 0; s < RC_ROW / 16; ++s) {
      const int row0 = 16 * s + g, row1 = row0 + 8;
      uint32_t A[8][4];
      strip_a<T, CD>(x, base, n, aligned, s, g, t4, A);
      const float dn0 = dn[row0], dn1 = dn[row1];
      for (int nc = 0; nc < RC_ROW / 8; ++nc) {
        const int j = 8 * nc + g;  // this thread's B column
        float r[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c0 = 8 * t4 + 32 * u + 4 * h;
            uint32_t e[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              e[q] = (inclusive ? c0 + q <= j : c0 + q < j) ? one_bits<CD>() : 0u;
            mma_c<CD>(r, A[2 * u + h], e[0] | (e[1] << 16), e[2] | (e[3] << 16));
          }
        }
        const int col = 8 * nc + 2 * t4;
        store_pair(out + base + row0 * RC_ROW + col, __fadd_rn(__fadd_rn(r[0], dn0), carry),
                   __fadd_rn(__fadd_rn(r[1], dn0), carry));
        store_pair(out + base + row1 * RC_ROW + col, __fadd_rn(__fadd_rn(r[2], dn1), carry),
                   __fadd_rn(__fadd_rn(r[3], dn1), carry));
      }
    }
  }
}

// Warp w takes tile g + w of each group of eight consecutive tiles: phase A
// (T1, D, the total) for the eight tiles at once, then thread 0 folds the
// eight totals into the carry in tile order (each tile's carry is the fold
// of every total before it), then phase B writes the owned tiles. The
// carry rebuild runs phase A over the tiles before the lane's range (up to
// the data's end).
template <typename T, int CD>
__global__ void __launch_bounds__(SC_THREADS)
scan_kernel(const T* __restrict__ x, long long n, T* __restrict__ out, long long tiles_per_lane,
            int inclusive, int aligned) {
  __shared__ float t1s[SC_WARPS][RC_ROW];    // each warp's tile's row totals
  __shared__ float downs[SC_WARPS][RC_ROW];  // D of each warp's tile
  __shared__ float totals[SC_WARPS];
  __shared__ float carries[SC_WARPS];

  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const long long first_owned = blockIdx.x * tiles_per_lane;
  const long long end_owned = first_owned + tiles_per_lane;
  const long long data_tiles = (n + RC_TILE - 1) / RC_TILE;
  const long long rebuild_end = first_owned < data_tiles ? first_owned : data_tiles;
  float carry = 0.f;  // thread 0's running carry

  for (int phase = 0; phase < 2; ++phase) {
    const bool emit = phase == 1;
    const long long begin = emit ? first_owned : 0, end = emit ? end_owned : rebuild_end;
    for (long long g0 = begin; g0 < end; g0 += SC_WARPS) {
      const long long t = g0 + warp;
      const bool live = t < end;  // warp-uniform
      if (live) {
        const float total = tile_totals<T, CD>(x, t * RC_TILE, n, aligned != 0, t1s[warp],
                                               downs[warp]);
        if (lid == 0) totals[warp] = total;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int w = 0; w < SC_WARPS && g0 + w < end; ++w) {
          carries[w] = carry;
          carry = __fadd_rn(carry, totals[w]);
        }
      }
      __syncthreads();
      if (emit && live)
        tile_emit<T, CD>(x, t * RC_TILE, n, aligned != 0, downs[warp], carries[warp],
                         inclusive, out);
    }
  }
}

template <typename T>
int by_compute(const void* x, long long n, int compute, long long tiles_per_lane, int lanes,
               int inclusive, int aligned, void* out, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  switch (compute) {
    case DT_F32:
      scan_kernel<T, DT_F32><<<lanes, SC_THREADS, 0, stream>>>(xt, n, ot, tiles_per_lane,
                                                               inclusive, aligned);
      break;
    case DT_BF16:
      scan_kernel<T, DT_BF16><<<lanes, SC_THREADS, 0, stream>>>(xt, n, ot, tiles_per_lane,
                                                                inclusive, aligned);
      break;
    case DT_F16:
      scan_kernel<T, DT_F16><<<lanes, SC_THREADS, 0, stream>>>(xt, n, ot, tiles_per_lane,
                                                               inclusive, aligned);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: n elements of `dtype`, read flat; `out`: lanes x tiles_per_lane x m^2
// elements of the same dtype (the block-padded prefix; tiles_per_lane = r x
// blocks per lane of kernels/scan's scan_geometry). Lane c writes tiles
// [c tiles_per_lane, (c + 1) tiles_per_lane).
extern "C" int sc_scan(const void* x, long long n, int dtype, int compute,
                       long long tiles_per_lane, int lanes, int inclusive, int aligned,
                       void* out, void* stream) {
  if (n < 1 || lanes < 1 || tiles_per_lane < 1 ||
      tiles_per_lane * lanes * RC_TILE < n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return by_compute<float>(x, n, compute, tiles_per_lane, lanes, inclusive, aligned, out, s);
    case DT_BF16:
      return by_compute<__nv_bfloat16>(x, n, compute, tiles_per_lane, lanes, inclusive, aligned,
                                       out, s);
    case DT_F16:
      return by_compute<__half>(x, n, compute, tiles_per_lane, lanes, inclusive, aligned, out,
                                s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
