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
// The fold, in two levels (`ops.combine_lane_pairs_kahan`):
//   1. each lane's CTA, after its stream, runs one serial Kahan pass over
//      its own 256 values -- acc rows 0..127, then the negated comp rows
//      0..127 (Kahan's corrected sum is s - c) -- and writes that pass's
//      (s_c, c_c);
//   2. the last CTA to finish (an integer ticket, as in K1; no float
//      atomics) runs one serial Kahan pass over s_0, -c_0, s_1, -c_1, ...
//      in lane order, applies the epilogue chain and writes the total.
// Step 1 is 256 dependent steps in every CTA at once, step 2 is 2C steps
// in one: at C = 528 lanes ~1 300 steps after the stream ends, where one
// serial pass over all C x 256 values (the reference's order,
// `combine_lane_partials_kahan`) is 135 168 (~1.3 ms on this card). One
// launch per call; repeat launches agree bitwise.
//
// Bound on this card: bytes (n * itemsize read once), as K1. The stream is
// the word route (reduce_common.cuh's tile strips): a warp reads its strip
// of a tile in steps of 4 KB and loads the next step before this step's
// MMAs and Kahan adds; the loaded words are the MMA's A operands (a bf16 /
// f16 input at its own compute dtype unconverted, f32 rounded once a pair),
// tile_row_sums' operands, so every D, and every lane's (acc, comp), is
// bitwise the element route's. Two CTAs a SM (at most 128 registers): the
// default 528 lanes run in two waves, each warp with 4 KB in flight, which
// measured faster than four CTAs a SM with 2 KB steps (64 registers), above
// all for a few lanes (PERF.md).
#include "reduce_common.cuh"

namespace {

constexpr int KH_THREADS = 256;
constexpr int KH_CHUNK = 2048;  // lane pairs' values the last CTA stages at a time

__device__ __forceinline__ void kahan_add(float v, float& acc, float& comp) {
  const float y = __fsub_rn(v, comp);
  const float s = __fadd_rn(acc, y);
  comp = __fsub_rn(__fsub_rn(s, acc), y);
  acc = s;
}

template <typename T, int CD, int PRO>
__global__ void __launch_bounds__(KH_THREADS, 2)
fused_kahan_kernel(const T* __restrict__ x, long long n, int r, long long blocks,
                   long long blocks_per_lane, int aligned, const Chain chain,
                   float* __restrict__ lane_part, unsigned int* __restrict__ ticket,
                   float* __restrict__ out) {
  constexpr int SU = STRIP_U<T>, STEPS = 4 / SU;  // values of u a step, steps a strip
  __shared__ float stage[KH_CHUNK];
  __shared__ bool am_last;

  const int lane_id = blockIdx.x, lanes = gridDim.x;
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const int g = lid / 4, t = lid % 4;
  const int row0 = 16 * warp + g, row1 = row0 + 8;
  const long long first = static_cast<long long>(row0) * RC_ROW + 8 * t;  // in its tile
  const bool vec = aligned != 0;

  // The lane's steps: tile tt of block b (b = lane_id, + C, ...; zero tiles
  // from b = blocks on), step s of the strip. Every thread of the CTA runs
  // the same steps, so the MMAs see the whole warp.
  long long b = lane_id, k = 0;
  const long long tiles = blocks_per_lane * r;
  int tt = 0, s = 0;
  bool live = b < blocks;
  Strip<T, SU> st;
  if (live) load_strip(x, b * r * RC_TILE + first, 0, n, 1, vec, st);
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  float acc0 = 0.f, comp0 = 0.f, acc1 = 0.f, comp1 = 0.f;
  while (k < tiles) {
    uint32_t w0[SU][4], w1[SU][4];
    if (live) {
      if constexpr (CD == DT_F32) strip_f32<T, PRO>(st, d);
      else strip_words<T, CD, PRO>(st, w0, w1);
    }
    // the next step's loads go out before this step's MMAs and Kahan adds
    const bool tile_end = s == STEPS - 1;
    if (++s == STEPS) {
      s = 0;
      ++k;
      if (++tt == r) {
        tt = 0;
        b += lanes;
      }
    }
    const bool live_next = k < tiles && b < blocks;
    if (live_next) load_strip(x, (b * r + tt) * RC_TILE + first, s, n, 1, vec, st);
    if constexpr (CD != DT_F32) {
      if (live) strip_mma<CD, SU>(d, w0, w1);
    }
    if (tile_end) {  // a zero tile past the real blocks adds D = 0
      const float2 rs = strip_row_sums<CD>(d);
      kahan_add(rs.x, acc0, comp0);
      kahan_add(rs.y, acc1, comp1);
      d[0] = d[1] = d[2] = d[3] = 0.f;
    }
    live = live_next;
  }

  // 1. the lane's own pass: acc rows 0..127, then -comp rows 0..127
  if (t == 0) {
    stage[row0] = acc0;
    stage[row1] = acc1;
    stage[RC_ROW + row0] = -comp0;
    stage[RC_ROW + row1] = -comp1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ls = 0.f, lc = 0.f;
    for (int i = 0; i < 2 * RC_ROW; ++i) kahan_add(stage[i], ls, lc);
    lane_part[2 * lane_id] = ls;
    lane_part[2 * lane_id + 1] = lc;
    __threadfence();  // publish the pair before taking a ticket
    am_last = atomicAdd(ticket, 1u) == static_cast<unsigned int>(lanes - 1);
    if (am_last) *ticket = 0u;  // every other CTA has taken its ticket
  }
  __syncthreads();
  if (!am_last) return;

  // 2. the last CTA: one serial pass over s_0, -c_0, s_1, -c_1, ...
  __threadfence();
  const long long total_vals = 2LL * lanes;
  float ts = 0.f, tc = 0.f;
  for (long long base = 0; base < total_vals; base += KH_CHUNK) {
    const int len = total_vals - base < KH_CHUNK ? static_cast<int>(total_vals - base) : KH_CHUNK;
    __syncthreads();  // the previous chunk is folded
    for (int i = threadIdx.x; i < len; i += KH_THREADS) {
      const float v = __ldcg(lane_part + base + i);
      stage[i] = (base + i) % 2 == 0 ? v : -v;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < len; ++i) kahan_add(stage[i], ts, tc);
    }
  }
  if (threadIdx.x == 0) out[0] = apply_chain(ts, chain);
}

struct Launch {
  const void* x;
  long long n, blocks, bpl;
  int r, lanes, aligned;
  Chain chain;
  float* lane_part;
  unsigned int* ticket;
  float* out;
  cudaStream_t stream;
};

template <typename T, int CD, int PRO>
int launch(const Launch& a) {
  fused_kahan_kernel<T, CD, PRO><<<a.lanes, KH_THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.x), a.n, a.r, a.blocks, a.bpl, a.aligned, a.chain, a.lane_part,
      a.ticket, a.out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CD>
int by_prologue(int prologue, const Launch& a) {
  switch (prologue) {
    case PRO_IDENTITY: return launch<T, CD, PRO_IDENTITY>(a);
    case PRO_SQUARE: return launch<T, CD, PRO_SQUARE>(a);
    case PRO_ABS: return launch<T, CD, PRO_ABS>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int by_compute(int compute, int prologue, const Launch& a) {
  switch (compute) {
    case DT_F32: return by_prologue<T, DT_F32>(prologue, a);
    case DT_BF16: return by_prologue<T, DT_BF16>(prologue, a);
    case DT_F16: return by_prologue<T, DT_F16>(prologue, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: n elements of `dtype`, read flat. `r` (tiles per block), `blocks`,
// `blocks_per_lane` and `lanes` are the stripe geometry of
// ops.lane_geometry. `lane_part` holds at least lanes x 2 floats
// (uninitialised): lane c's pass writes (s_c, c_c) at 2c; `ticket` is one
// unsigned int, 0 on entry and on exit. `out` receives [epilogue(total)].
extern "C" int fk_sum(const void* x, long long n, int dtype, int compute, int prologue, int r,
                      long long blocks, long long blocks_per_lane, int lanes, int aligned,
                      int chain_len, const int* chain_ops, const float* chain_p0,
                      const float* chain_p1, float* out, float* lane_part, unsigned int* ticket,
                      void* stream) {
  Launch a{x, n, blocks, blocks_per_lane, r, lanes, aligned, {}, lane_part, ticket, out,
           static_cast<cudaStream_t>(stream)};
  if (n < 1 || r < 1 || lanes < 1 || lanes > blocks || blocks_per_lane * lanes < blocks ||
      !make_chain(chain_len, chain_ops, chain_p0, chain_p1, &a.chain))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case DT_F32: return by_compute<float>(compute, prologue, a);
    case DT_BF16: return by_compute<__nv_bfloat16>(compute, prologue, a);
    case DT_F16: return by_compute<__half>(compute, prologue, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
