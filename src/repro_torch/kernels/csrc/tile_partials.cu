// One level of the paper's hierarchy (eqs. 9-13): every m x m tile of a
// flat stream reduced by two all-ones MMAs to one partial.
//
// Replaces the TPU kernel `tile_partials_kernel` of
// src/repro/kernels/mma_reduce/kernel.py (launcher `reduce_tiles`). The
// hierarchy relaunches it on its own partials (ops.mma_sum_hier), as the
// paper relaunches its kernel: cost_model.levels(n, 128) launches, two at
// n = 2^28.
//
// Grid: one CTA per block of `r` tiles (`tiles_per_block`, the reference's
// block); no state is carried between CTAs. Level 0 reads the caller's
// buffer in its own dtype and masks the tail past n; upper levels read the
// previous launch's f32 partials, `stride` floats apart (2 for one column
// of the moments pair), and round them to the compute dtype before the MMA,
// as the reference's `_load_tiles` does (its lossy semantics, kept). The
// prologue (identity, square, abs) maps each value after the compute cast;
// the moments prologue emits a (tile, 2) pair: X and X * X at the compute
// dtype.
//
// The two MMAs of `_two_mma` (kernel.py:91-107): D = X @ 1 gives the 128
// row sums (f32 accumulation; warp w owns rows 16w .. 16w + 15, eight
// m16n8k16 ones-MMAs per strip), D is rounded to the compute dtype, and
// 1 @ D sums the 128 rounded values (eight more ones-MMAs, by one warp per
// tile, with B = D from shared memory). f32 compute sums on the CUDA cores
// (TF32 would round), in a fixed order. Tiles are taken eight at a time:
// one barrier hands each batch's row sums from the row warps to the column
// warps. The epilogue chain runs on the final level only (one tile, t ==
// 1). The launch writes a partial for every tile of its padded grid (zero
// tiles give 0), as the reference's output block does.
//
// Bound on this card: bytes (level 0 reads n * itemsize once; the upper
// levels read 4 bytes per tile of the level below). Sixteen MMA flops per
// element for the first product is far below the tensor-core rate.
#include "reduce_common.cuh"

namespace {

constexpr int TP_THREADS = 256;
constexpr int TP_WARPS = TP_THREADS / 32;  // also the tiles per batch

template <typename T>
__device__ __forceinline__ void load_tile_group(const T* x, long long e, long long n,
                                                long long stride, bool aligned,
                                                float (&v)[RC_GROUP]) {
  if (stride == 1) {
    load_group(x, e, n, aligned, v);
    return;
  }
#pragma unroll
  for (int i = 0; i < RC_GROUP; ++i) v[i] = e + i < n ? to_f32(x[(e + i) * stride]) : 0.f;
}

// Column sum of one tile's 128 rounded row sums: 1 @ D.
template <int CD>
__device__ __forceinline__ float column_sum(const float* rs, int lid) {
  if (CD == DT_F32) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) s = __fadd_rn(s, rs[4 * lid + i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
    return s;
  }
  const int g = lid / 4, t = lid % 4;
  (void)g;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  const uint32_t ones = CD == DT_BF16 ? ONES_BF16X2 : ONES_F16X2;
  const uint32_t A[4] = {ones, ones, ones, ones};
#pragma unroll
  for (int c = 0; c < RC_ROW / 16; ++c) {
    // B (k = 16c + 2t.., n = g) and (k = 16c + 2t + 8.., n = g): every
    // column of B holds the same 16 rounded row sums
    const float* k0 = rs + 16 * c + 2 * t;
    if (CD == DT_BF16) {
      mma_bf16_16816(d, A, pack_bf16(k0[0], k0[1]), pack_bf16(k0[8], k0[9]));
    } else {
      mma_f16_16816(d, A, pack_f16(k0[0], k0[1]), pack_f16(k0[8], k0[9]));
    }
  }
  return d[0];
}

// MOM: the moments prologue (two statistics); else `prologue` is
// elementwise. Two CTAs per SM: at most 128 registers a thread.
template <typename T, int CD, bool MOM>
__global__ void __launch_bounds__(TP_THREADS, 2)
tile_partials_kernel(const T* __restrict__ x, long long n, long long stride, int r,
                     int prologue, int aligned, const Chain chain, float* __restrict__ out) {
  __shared__ float rows[MOM ? 2 : 1][TP_WARPS][RC_ROW];  // [statistic][tile of batch][row]

  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const int g = lid / 4, t = lid % 4;
  const int row0 = 16 * warp + g, row1 = row0 + 8;
  const long long first_tile = static_cast<long long>(blockIdx.x) * r;

  for (int b0 = 0; b0 < r; b0 += TP_WARPS) {
    const int batch = r - b0 < TP_WARPS ? r - b0 : TP_WARPS;
    // D = X @ 1 for every tile of the batch: this warp's 16 rows of each
    for (int j = 0; j < batch; ++j) {
      const long long tile = (first_tile + b0 + j) * RC_TILE;
      float v0[4][RC_GROUP], v1[4][RC_GROUP];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long off = 8 * t + 32 * u;
        load_tile_group(x, tile + row0 * RC_ROW + off, n, stride, aligned != 0, v0[u]);
        load_tile_group(x, tile + row1 * RC_ROW + off, n, stride, aligned != 0, v1[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int i = 0; i < RC_GROUP; ++i) {
          const float c0 = to_compute<CD>(v0[u][i]), c1 = to_compute<CD>(v1[u][i]);
          v0[u][i] = MOM ? c0 : prologue_map<CD>(c0, prologue);
          v1[u][i] = MOM ? c1 : prologue_map<CD>(c1, prologue);
        }
      }
      const float2 d = tile_row_sums<CD>(v0, v1);
      // D re-enters the second MMA at the compute dtype
      if (t == 0) {
        rows[0][j][row0] = to_compute<CD>(d.x);
        rows[0][j][row1] = to_compute<CD>(d.y);
      }
      if constexpr (MOM) {  // X * X at the compute dtype, from the same registers
        const float2 d2 = tile_row_sums<CD, true>(v0, v1);
        if (t == 0) {
          rows[1][j][row0] = to_compute<CD>(d2.x);
          rows[1][j][row1] = to_compute<CD>(d2.y);
        }
      }
    }
    __syncthreads();
    // 1 @ D: warp j sums tile j's rounded row sums
    if (warp < batch) {
      const long long tile = first_tile + b0 + warp;
      const float s = column_sum<CD>(rows[0][warp], lid);
      if constexpr (MOM) {
        const float s2 = column_sum<CD>(rows[1][warp], lid);
        if (lid == 0) {
          out[2 * tile] = s;
          out[2 * tile + 1] = s2;
        }
      } else if (lid == 0) {
        out[tile] = apply_chain(s, chain);
      }
    }
    __syncthreads();
  }
}

template <typename T, int CD>
int launch(const void* x, long long n, long long stride, int r, long long blocks, int prologue,
           int aligned, const Chain& chain, float* out, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(blocks));
  if (prologue == PRO_MOMENTS)
    tile_partials_kernel<T, CD, true><<<grid, TP_THREADS, 0, stream>>>(
        static_cast<const T*>(x), n, stride, r, prologue, aligned, chain, out);
  else
    tile_partials_kernel<T, CD, false><<<grid, TP_THREADS, 0, stream>>>(
        static_cast<const T*>(x), n, stride, r, prologue, aligned, chain, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_compute(const void* x, long long n, long long stride, int compute, int r,
               long long blocks, int prologue, int aligned, const Chain& chain, float* out,
               cudaStream_t stream) {
  switch (compute) {
    case DT_F32:
      return launch<T, DT_F32>(x, n, stride, r, blocks, prologue, aligned, chain, out, stream);
    case DT_BF16:
      return launch<T, DT_BF16>(x, n, stride, r, blocks, prologue, aligned, chain, out, stream);
    case DT_F16:
      return launch<T, DT_F16>(x, n, stride, r, blocks, prologue, aligned, chain, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: n values of `dtype`, value i at x[i * stride] (stride > 1 only for f32
// partials). `r` tiles per CTA, `blocks` CTAs (r * blocks * m^2 >= n).
// `prologue`: 0 identity, 1 square, 2 abs, 3 moments. `out` receives
// r * blocks partials ((r * blocks, 2) for moments); the chain (final level
// only) maps each partial.
extern "C" int tp_level(const void* x, long long n, long long stride, int dtype, int compute,
                        int prologue, int r, long long blocks, int aligned, int chain_len,
                        const int* chain_ops, const float* chain_p0, const float* chain_p1,
                        float* out, void* stream) {
  Chain chain;
  if (n < 1 || stride < 1 || (stride > 1 && dtype != DT_F32) || r < 1 || blocks < 1 ||
      blocks > 0x7fffffffLL || static_cast<long long>(r) * blocks * RC_TILE < n ||
      prologue < PRO_IDENTITY || prologue > PRO_MOMENTS ||
      (prologue == PRO_MOMENTS && chain_len != 0) ||
      !make_chain(chain_len, chain_ops, chain_p0, chain_p1, &chain))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return by_compute<float>(x, n, stride, compute, r, blocks, prologue, aligned, chain, out, s);
    case DT_BF16:
      return by_compute<__nv_bfloat16>(x, n, stride, compute, r, blocks, prologue, aligned,
                                       chain, out, s);
    case DT_F16:
      return by_compute<__half>(x, n, stride, compute, r, blocks, prologue, aligned, chain, out,
                                s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
