// One level of the paper's hierarchy (eqs. 9-13): every m x m tile of a
// flat stream reduced by two all-ones MMAs to one partial.
//
// Replaces the TPU kernel `tile_partials_kernel` of
// src/repro/kernels/mma_reduce/kernel.py (launcher `reduce_tiles`). The
// hierarchy relaunches it on its own partials (ops.mma_sum_hier), as the
// paper relaunches its kernel: cost_model.levels(n, 128) launches, two at
// n = 2^28.
//
// Grid: blocks of `r` tiles (`tiles_per_block`, the reference's block),
// CTA c taking blocks c, c + G, ... (G CTAs: as many as fit on the card at
// once, at most one per block); no state is carried between blocks. Level 0
// reads the caller's buffer in its own dtype and masks the tail past n;
// upper levels read the previous launch's f32 partials, `stride` floats
// apart (2 for one column of the moments pair), and round them to the
// compute dtype before the MMA, as the reference's `_load_tiles` does (its
// lossy semantics, kept). The prologue (identity, square, abs) maps each
// value after the compute cast; the moments prologue emits a (tile, 2)
// pair: X and X * X at the compute dtype.
//
// The two MMAs of `_two_mma` (kernel.py:91-107): D = X @ 1 gives the 128
// row sums (f32 accumulation; warp w owns rows 16w .. 16w + 15, eight
// m16n8k16 ones-MMAs per strip), D is rounded to the compute dtype, and
// 1 @ D sums the 128 rounded values (eight more ones-MMAs, by one warp per
// tile, with B = D from shared memory). f32 compute sums on the CUDA cores
// (TF32 would round), in a fixed order. Tiles are taken eight at a time:
// one barrier hands each batch's row sums from the row warps to the column
// warps, through one of two buffers (the next batch fills the other, so no
// second barrier). The epilogue chain runs on the final level only (one
// tile, t == 1). The launch writes a partial for every tile of its padded
// grid (zero tiles give 0), as the reference's output block does.
//
// Bound on this card: bytes (level 0 reads n * itemsize once; the upper
// levels read 4 bytes per tile of the level below). Sixteen MMA flops per
// element for the first product is far below the tensor-core rate. The
// stream is the word route (reduce_common.cuh's tile strips): a warp reads
// its strip of a tile in steps of 4 KB and loads the next step -- of this
// tile, the next, or the CTA's next block -- before this step's MMAs, so
// loads stay in flight across tiles and across the batch's barrier and
// column sums (measured faster than one CTA per block, or 2 KB steps:
// PERF.md). The loaded words are the MMA's A operands (a bf16 / f16 input
// at its own compute dtype unconverted, f32 rounded once a pair); they are
// tile_row_sums' operands, so every partial is bitwise the element route's.
#include "reduce_common.cuh"

namespace {

constexpr int TP_THREADS = 256;
constexpr int TP_WARPS = TP_THREADS / 32;  // also the tiles per batch

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
  const int t = lid % 4;
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

// PRO: identity, square, abs, or moments (the pair X, X * X). Two CTAs per
// SM: at most 128 registers a thread.
template <typename T, int CD, int PRO>
__global__ void __launch_bounds__(TP_THREADS, 2)
tile_partials_kernel(const T* __restrict__ x, long long n, long long stride, int r,
                     long long blocks, int aligned, const Chain chain, float* __restrict__ out) {
  constexpr bool MOM = PRO == PRO_MOMENTS;
  constexpr int WPRO = MOM ? PRO_IDENTITY : PRO;  // the prologue of the MMA's words
  constexpr int SU = STRIP_U<T>, STEPS = 4 / SU;  // values of u a step, steps a strip
  // [buffer][statistic][tile of batch][row]
  __shared__ float rows[2][MOM ? 2 : 1][TP_WARPS][RC_ROW];

  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const int g = lid / 4, t = lid % 4;
  const int row0 = 16 * warp + g, row1 = row0 + 8;
  const long long first = static_cast<long long>(row0) * RC_ROW + 8 * t;  // in its tile
  const bool vec = aligned != 0;

  // The CTA's steps: block b (blockIdx.x, + gridDim.x, ...), tile tt of it,
  // step s of the strip. Every thread of the CTA runs the same steps.
  long long b = blockIdx.x;
  int tt = 0, s = 0, buf = 0;
  Strip<T, SU> st;
  load_strip(x, b * r * RC_TILE + first, 0, n, stride, vec, st);
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  float q[4] = {0.f, 0.f, 0.f, 0.f};  // MOM: the squares' D
  for (bool have = b < blocks; have;) {
    uint32_t w0[SU][4], w1[SU][4];
    if constexpr (CD == DT_F32) {
      strip_f32<T, WPRO>(st, d);
      if constexpr (MOM) strip_f32<T, PRO_SQUARE>(st, q);
    } else {
      strip_words<T, CD, WPRO>(st, w0, w1);
    }
    // the next step's loads go out before this step's MMAs, and across the
    // batch's barrier and column sums
    const long long tile = b * r + tt;
    const int j = tt % TP_WARPS;  // the tile's place in its batch
    const bool tile_end = s == STEPS - 1;
    const bool batch_end = tile_end && (j == TP_WARPS - 1 || tt == r - 1);
    if (++s == STEPS) {
      s = 0;
      if (++tt == r) {
        tt = 0;
        b += gridDim.x;
      }
    }
    have = b < blocks;
    if (have) load_strip(x, (b * r + tt) * RC_TILE + first, s, n, stride, vec, st);
    if constexpr (CD != DT_F32) {
      strip_mma<CD, SU>(d, w0, w1);
      if constexpr (MOM) strip_mma<CD, SU, true>(q, w0, w1);
    }
    if (!tile_end) continue;
    // D re-enters the second MMA at the compute dtype
    const float2 rs = strip_row_sums<CD>(d);
    if (t == 0) {
      rows[buf][0][j][row0] = to_compute<CD>(rs.x);
      rows[buf][0][j][row1] = to_compute<CD>(rs.y);
    }
    if constexpr (MOM) {
      const float2 rq = strip_row_sums<CD>(q);
      if (t == 0) {
        rows[buf][1][j][row0] = to_compute<CD>(rq.x);
        rows[buf][1][j][row1] = to_compute<CD>(rq.y);
      }
    }
    d[0] = d[1] = d[2] = d[3] = 0.f;
    q[0] = q[1] = q[2] = q[3] = 0.f;
    if (!batch_end) continue;
    __syncthreads();
    // 1 @ D: warp i sums the batch's tile i
    if (warp <= j) {
      const long long mine = tile - j + warp;
      const float cs = column_sum<CD>(rows[buf][0][warp], lid);
      if constexpr (MOM) {
        const float cq = column_sum<CD>(rows[buf][1][warp], lid);
        if (lid == 0) {
          out[2 * mine] = cs;
          out[2 * mine + 1] = cq;
        }
      } else if (lid == 0) {
        out[mine] = apply_chain(cs, chain);
      }
    }
    buf ^= 1;
  }
}

struct Level {
  const void* x;
  long long n, stride, blocks;
  int r, aligned;
  Chain chain;
  float* out;
  cudaStream_t stream;
};

template <typename T, int CD, int PRO>
int launch(const Level& a) {
  // as many CTAs as the card holds at once, at most one per block
  const auto kernel = tile_partials_kernel<T, CD, PRO>;
  static int per_sm = 0;  // CTAs a SM holds: the kernel's own, found once
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TP_THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const dim3 grid(static_cast<unsigned int>(a.blocks < resident ? a.blocks : resident));
  kernel<<<grid, TP_THREADS, 0, a.stream>>>(static_cast<const T*>(a.x), a.n, a.stride, a.r,
                                            a.blocks, a.aligned, a.chain, a.out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CD>
int by_prologue(int prologue, const Level& a) {
  switch (prologue) {
    case PRO_IDENTITY: return launch<T, CD, PRO_IDENTITY>(a);
    case PRO_SQUARE: return launch<T, CD, PRO_SQUARE>(a);
    case PRO_ABS: return launch<T, CD, PRO_ABS>(a);
    case PRO_MOMENTS: return launch<T, CD, PRO_MOMENTS>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int by_compute(int compute, int prologue, const Level& a) {
  switch (compute) {
    case DT_F32: return by_prologue<T, DT_F32>(prologue, a);
    case DT_BF16: return by_prologue<T, DT_BF16>(prologue, a);
    case DT_F16: return by_prologue<T, DT_F16>(prologue, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: n values of `dtype`, value i at x[i * stride] (stride > 1 only for f32
// partials). `r` tiles per block, `blocks` blocks (r * blocks * m^2 >= n).
// `prologue`: 0 identity, 1 square, 2 abs, 3 moments. `out` receives
// r * blocks partials ((r * blocks, 2) for moments); the chain (final level
// only) maps each partial.
extern "C" int tp_level(const void* x, long long n, long long stride, int dtype, int compute,
                        int prologue, int r, long long blocks, int aligned, int chain_len,
                        const int* chain_ops, const float* chain_p0, const float* chain_p1,
                        float* out, void* stream) {
  Level a{x, n, stride, blocks, r, aligned, {}, out, static_cast<cudaStream_t>(stream)};
  if (n < 1 || stride < 1 || (stride > 1 && dtype != DT_F32) || r < 1 || blocks < 1 ||
      blocks > 0x7fffffffLL || static_cast<long long>(r) * blocks * RC_TILE < n ||
      (prologue == PRO_MOMENTS && chain_len != 0) ||
      !make_chain(chain_len, chain_ops, chain_p0, chain_p1, &a.chain))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case DT_F32: return by_compute<float>(compute, prologue, a);
    case DT_BF16: return by_compute<__nv_bfloat16>(compute, prologue, a);
    case DT_F16: return by_compute<__half>(compute, prologue, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
