// Matmul with its row moments fused into the epilogue: Y = X @ W, plus the
// per-row sum and sum of squares of the f32 accumulator, in one launch.
//
// Replaces the TPU kernel `_kernel` of
// src/repro/kernels/matmul_stats/kernel.py (launcher `matmul_stats_call`):
// X and W are rounded to bf16 as they are read (f16 input too: the
// reference rounds to bf16), the product is accumulated in f32, Y is stored
// in x's dtype, and the moments are taken from the f32 accumulator, not
// from the stored Y, each as an all-ones MMA (the paper's eq. 9) on the
// resident tile.
//
// Bound on the H100: operations. At olmo-1b's MLP down projection,
// (2048 x 8192) @ (8192 x 2048) bf16, the 68.7 GFLOP take 69.5 us at 989
// TFLOP/s, the 75.5 MB of operands and output 22.5 us at 3.35 TB/s.
//
// Design (Hopper's own instructions). One CTA per 128 x 128 tile of Y, one
// CTA on an SM at a time (197 KB of shared memory; a persistent grid that
// walks the tiles measured no faster, and two CTAs per SM fit in neither
// registers nor shared memory). A CTA is two consumer warpgroups and one
// producer warpgroup (`setmaxnreg` moves registers from the producer to
// the consumers). K runs in steps of 64
// through a ring of stages in shared memory, each the X tile (128 rows x
// 64 of K) and the W tile (64 of K x 128 columns) in bf16 in the 128-byte
// swizzle, with a full and an empty mbarrier per stage. Consumer warpgroup
// g owns rows 64 g .. 64 g + 63 of the tile and runs wgmma m64n128k16: X
// K-major, W (stored (K, N), N contiguous) through the transposed (MN-major)
// descriptor, whose leading offset steps between its two 64-column atoms.
// A stage is released to the producer once the next stage's MMAs are
// queued behind its own (wait_group 1), and the descriptors are built once
// and advanced by adds. 128 x 256 tiles do not fit: the accumulators `acc`
// and `tot` would take 256 f32 registers a thread. At the shapes measured
// the kernel is held by the rate at which stages arrive from L2, not by the
// MMAs (PERF.md).
//
// The tensor cores' f32 accumulation does not round to nearest: over a
// long K its error is one-sided, and no sum over a row cancels it in
// sum(y * y). So each 512 of K (the reference's K block, `bk`) starts with
// the scale-d = 0 form of wgmma (no zeroing pass) and ends with the chunk
// added into `tot` by round-to-nearest f32 adds. Every wgmma, wait and fold
// is on a path without branches: the chunk start is a runtime predicate
// operand of the wgmma, and the fold follows the chunk's loop (a wgmma, or
// a read of its accumulator, under a runtime condition makes ptxas
// serialize every wgmma).
//
// How the producer fills a stage depends on the operand (`ms_forward`'s
// routes, decided on the host by matmul_stats/ops.py `load_route`):
//   TMA   bf16, 16-byte aligned base and rows: one thread issues
//         cp.async.bulk.tensor straight into the swizzled tile;
//   CAST  f32 or f16, aligned the same way: TMA brings the raw tile into a
//         second ring of two stages, and the producer warpgroup rounds it to
//         bf16 into the swizzled tile;
//   ELEM  anything else (an unaligned base, K or N times the itemsize not
//         a multiple of 16 bytes): the producer warpgroup loads element by
//         element, rounds and writes the same swizzled tile.
// TMA zero-fills rows and columns past M, N and K, and ELEM writes zeros
// there, so padded K adds nothing and padded columns add 0 to the moments.
// The CAST route reads through TMA rather than through the producer's
// registers: 40 registers a thread cannot keep enough 16-byte loads in
// flight to feed the tensor cores.
//
// The moments: each warp of a consumer warpgroup holds 16 rows of the
// accumulator in the m16n8 C-fragment layout, so two adjacent 8-column
// chunks are the A fragment of one m16n8k16 MMA, and the accumulator feeds a
// ones-MMA without leaving registers. A bf16 operand keeps 8 significant
// bits, so each f32 value v (y, and y * y rounded in f32) is split into
// three bf16 pieces, hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi -
// mid), whose sum is v exactly (each difference is exact in f32 and the last
// holds at most 8 significant bits); the three pieces go through ones-MMAs
// with f32 accumulation over the tile's 128 columns. The only error left is
// the f32 accumulation of the sums, as in the plain version.
//
// Across tiles, without float atomics: each tile writes its rows' (128, 2)
// partial into a (M, column blocks, 2) workspace, and the last tile of each
// row block, found by an integer ticket per row block, folds the partials
// in column-block order and writes s and ss. One launch per call; two launches on the same input
// give the same bits.
#include <cstring>

#include "hopper.cuh"

namespace {

constexpr int MS_BM = 128;              // rows of Y per tile
constexpr int MS_BN = 128;              // columns of Y per tile
constexpr int MS_BK = 64;               // K per stage: one 128-byte swizzle row of bf16
constexpr int MS_FOLD_STEPS = 8;        // stages per f32 fold: 512 of K, the reference's bk
constexpr int MS_CONSUMERS = 256;       // two consumer warpgroups
constexpr int MS_THREADS = MS_CONSUMERS + 128;  // + the producer warpgroup
constexpr uint32_t MS_XTILE = MS_BM * MS_BK * 2;     // 16 KB: 128 rows x 128 bytes
constexpr uint32_t MS_WHALF = MS_BK * 64 * 2;        // 8 KB: 64 rows of K x 64 columns
constexpr uint32_t MS_STAGE = MS_XTILE + 2 * MS_WHALF;  // 32 KB
constexpr int MS_MAX_STAGES = 6;
constexpr int MS_RAW_STAGES = 2;        // the CAST route's ring of raw tiles
constexpr int MS_SMEM_LIMIT = 232448 - 256;  // per block, minus the static shared bytes

enum Route : int { ROUTE_TMA = 0, ROUTE_CAST = 1, ROUTE_ELEM = 2 };  // ops.py ROUTE_*

// Eight f32 values rounded to bf16 as four bf16x2 words (element 2i low).
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                    pack_bf16(v[6], v[7]));
}

// Eight consecutive elements of a raw tile in shared memory (16-byte aligned).
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* h = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = to_f32(h[i]);
}

// Elements src[0 .. valid) of a row in device memory, one at a time; zeros
// past them.
template <typename T>
__device__ __forceinline__ void load8_elem(const T* src, int valid, float (&v)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = e < valid ? to_f32(src[e]) : 0.f;
}

// Byte offset of the 16-byte chunk c of row r in a 128-byte-swizzled tile
// (as TMA's 128-byte swizzle places it; the tile starts 1024-byte aligned).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// The producer warpgroup's share of one stage's X tile (rows m0 .., K
// k0 ..): chunk q = (row q / 8, 16-byte chunk q % 8), eight per thread.
template <typename T>
__device__ __forceinline__ void stage_x(unsigned char* tile, int route, const T* raw,
                                        const T* x, int m0, int k0, int m, int k, int ptid) {
#pragma unroll 2
  for (int i = 0; i < 8; ++i) {
    const int q = ptid + 128 * i, r = q >> 3, c = q & 7;
    float v[8];
    if (route == ROUTE_CAST) {
      load8(raw + r * MS_BK + 8 * c, v);
    } else {
      const int row = m0 + r, col = k0 + 8 * c;
      const int valid = row < m ? min(8, max(0, k - col)) : 0;
      load8_elem(x + (valid > 0 ? static_cast<size_t>(row) * k + col : 0), valid, v);
    }
    *reinterpret_cast<uint4*>(tile + swz(r, c)) = pack8(v);
  }
}

// The same for the W tile (K k0 .., columns n0 ..): chunk q = (row of K
// q / 16, 16-byte chunk q % 16), the chunks of columns 64 .. 127 in the
// second 8 KB half.
template <typename T>
__device__ __forceinline__ void stage_w(unsigned char* tile, int route, const T* raw,
                                        const T* w, int k0, int n0, int k, int n, int ptid) {
#pragma unroll 2
  for (int i = 0; i < 8; ++i) {
    const int q = ptid + 128 * i, r = q >> 4, cc = q & 15;
    float v[8];
    if (route == ROUTE_CAST) {
      load8(raw + r * MS_BN + 8 * cc, v);
    } else {
      const int row = k0 + r, col = n0 + 8 * cc;
      const int valid = row < k ? min(8, max(0, n - col)) : 0;
      load8_elem(w + (valid > 0 ? static_cast<size_t>(row) * n + col : 0), valid, v);
    }
    *reinterpret_cast<uint4*>(tile + (cc >> 3) * MS_WHALF + swz(r, cc & 7)) = pack8(v);
  }
}

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_one(__half* p, float v) { *p = __float2half_rn(v); }

// One ones-MMA per bf16 piece of the four values of each of two adjacent
// C fragments (c0: columns 0..7, c1: columns 8..15 of a 16-column slab):
// acc[0] (row g) and acc[2] (row g + 8) gain the slab's row sums of v.
__device__ __forceinline__ void ones_mma_exact(float (&acc)[4], const float (&c0)[4],
                                               const float (&c1)[4]) {
  float r0[4], r1[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    r0[e] = c0[e];
    r1[e] = c1[e];
  }
#pragma unroll
  for (int piece = 0; piece < 3; ++piece) {
    float p0[4], p1[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p0[e] = __bfloat162float(__float2bfloat16_rn(r0[e]));
      p1[e] = __bfloat162float(__float2bfloat16_rn(r1[e]));
      r0[e] = __fsub_rn(r0[e], p0[e]);  // exact: the bits below the piece
      r1[e] = __fsub_rn(r1[e], p1[e]);
    }
    const uint32_t a[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                           pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
    mma_bf16_16816(acc, a, ONES_BF16X2, ONES_BF16X2);
  }
}

// Kernel parameters that are not pointers or tensor maps.
struct MsShape {
  int m, n, k, col_blocks, tiles;
  int route_x, route_w, w_dtype;
  int stages;                 // bf16 ring depth
  uint32_t raw_x, raw_w;      // raw bytes of X and W per raw stage (0 unless CAST)
};

template <typename TX>
__global__ void __launch_bounds__(MS_THREADS, 1)
matmul_stats_kernel(const __grid_constant__ CUtensorMap tmx,
                    const __grid_constant__ CUtensorMap tmw, const TX* __restrict__ x,
                    const void* __restrict__ w, TX* __restrict__ y, float* __restrict__ s_out,
                    float* __restrict__ ss_out, const MsShape sh, float* __restrict__ ws,
                    unsigned int* __restrict__ tickets) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ bool am_last;
  // 1024-byte aligned: the swizzle atoms are 8 rows x 128 bytes
  const uint32_t raw_addr = smem_u32(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw_addr);
  const int S = sh.stages;
  const uint32_t raw_stage = sh.raw_x + sh.raw_w;
  const uint32_t raw0 = base + S * MS_STAGE;  // the raw ring, then the barriers
  const uint32_t bars = raw0 + MS_RAW_STAGES * raw_stage;
  auto ring = [&](int s) { return base + s * MS_STAGE; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };
  auto raw_full = [&](int r) { return bars + 8 * (2 * S + r); };
  const int ksteps = (sh.k + MS_BK - 1) / MS_BK;  // the same for every thread
  const int bm = blockIdx.x / sh.col_blocks, bn = blockIdx.x % sh.col_blocks;
  const int m0 = bm * MS_BM, n0 = bn * MS_BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 2);  // the TMA's expect_tx arrival, then the staged tile's
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    for (int r = 0; r < MS_RAW_STAGES; ++r) mbar_init(raw_full(r), 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= MS_CONSUMERS) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int ptid = threadIdx.x - MS_CONSUMERS;
    const bool cast = raw_stage > 0;
    const bool staged = sh.route_x != ROUTE_TMA || sh.route_w != ROUTE_TMA;  // CTA-uniform
    if (!staged && ptid != 0) return;  // TMA alone: one thread issues every load
    const uint32_t tma_bytes = (sh.route_x == ROUTE_TMA ? MS_XTILE : 0u) +
                               (sh.route_w == ROUTE_TMA ? 2 * MS_WHALF : 0u);
    int s = 0;  // the ring position, and its phase
    uint32_t phase = 0;
    // the raw tiles of step j go to raw stage j % 2
    auto issue_raw = [&](int j) {
      const uint32_t dst = raw0 + (j % MS_RAW_STAGES) * raw_stage;
      mbar_expect_tx(raw_full(j % MS_RAW_STAGES), raw_stage);
      if (sh.raw_x) tma_load_2d(dst, &tmx, j * MS_BK, m0, raw_full(j % MS_RAW_STAGES));
      if (sh.raw_w) tma_load_2d(dst + sh.raw_x, &tmw, n0, j * MS_BK, raw_full(j % MS_RAW_STAGES));
    };
    if (cast && ptid == 0)
      for (int j = 0; j < MS_RAW_STAGES && j < ksteps; ++j) issue_raw(j);
    for (int kt = 0; kt < ksteps; ++kt) {
      mbar_wait(empty(s), phase ^ 1);  // a fresh barrier passes parity 1
      const int k0 = kt * MS_BK;
      if (ptid == 0) {
        mbar_expect_tx(full(s), tma_bytes);
        if (sh.route_x == ROUTE_TMA) tma_load_2d(ring(s), &tmx, k0, m0, full(s));
        if (sh.route_w == ROUTE_TMA) {
          tma_load_2d(ring(s) + MS_XTILE, &tmw, n0, k0, full(s));
          tma_load_2d(ring(s) + MS_XTILE + MS_WHALF, &tmw, n0 + 64, k0, full(s));
        }
      }
      if (staged) {
        if (cast) mbar_wait(raw_full(kt % MS_RAW_STAGES), (kt / MS_RAW_STAGES) & 1);
        unsigned char* dst = smem + (ring(s) - base);
        const unsigned char* rawp = smem + (raw0 + (kt % MS_RAW_STAGES) * raw_stage - base);
        if (sh.route_x != ROUTE_TMA)
          stage_x(dst, sh.route_x, reinterpret_cast<const TX*>(rawp), x, m0, k0, sh.m, sh.k,
                  ptid);
        if (sh.route_w != ROUTE_TMA) {
          unsigned char* wt = dst + MS_XTILE;
          const unsigned char* rw = rawp + sh.raw_x;
          switch (sh.w_dtype) {
            case DT_BF16:
              stage_w(wt, sh.route_w, reinterpret_cast<const __nv_bfloat16*>(rw),
                      static_cast<const __nv_bfloat16*>(w), k0, n0, sh.k, sh.n, ptid);
              break;
            case DT_F16:
              stage_w(wt, sh.route_w, reinterpret_cast<const __half*>(rw),
                      static_cast<const __half*>(w), k0, n0, sh.k, sh.n, ptid);
              break;
            default:
              stage_w(wt, sh.route_w, reinterpret_cast<const float*>(rw),
                      static_cast<const float*>(w), k0, n0, sh.k, sh.n, ptid);
          }
        }
        // the consumers read the tile through the async proxy (wgmma), and
        // the raw stage is refilled through it (TMA)
        fence_proxy_async();
        named_bar_sync(1, 128);
      }
      if (ptid == 0) {
        mbar_arrive(full(s));
        if (cast && kt + MS_RAW_STAGES < ksteps) issue_raw(kt + MS_RAW_STAGES);
      }
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ctid = threadIdx.x, warp = ctid / 32, lane = ctid % 32;
  const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
  const int rloc = 64 * wg + 16 * (warp % 4) + g;  // this thread's rows rloc and rloc + 8
  const bool pairs = (sh.n % 2) == 0;  // then (row * n + even column) is pair-aligned
  float acc[64], tot[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;
  fence_regs(acc);
  // Descriptors of stage 0 (this warpgroup's 64 rows of X; the W tile), and
  // the ring position advanced step by step: the loop issues its MMAs with
  // an add, not a rebuild of both descriptors.
  const uint64_t a_desc = sw128_desc(base + wg * 64 * 128);
  const uint64_t b_desc = sw128_desc(base + MS_XTILE, MS_WHALF, 1024);
  int s = 0;  // the next stage of the ring, and its phase
  uint32_t phase = 0;
  auto release = [&](int stage) {  // this warp is done with the stage
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(stage));
  };
  // One chunk of up to 512 of K per pass: its first MMA overwrites `acc`,
  // each stage is released once the next stage's MMAs are queued behind
  // it, and the chunk is folded after the pass (no wait or fold under a
  // branch: that would make ptxas serialize the MMAs).
  for (int c0 = 0; c0 < ksteps; c0 += MS_FOLD_STEPS) {
    const int c1 = min(c0 + MS_FOLD_STEPS, ksteps);
    int held = s;
    for (int kt = c0; kt < c1; ++kt) {
      mbar_wait(full(s), phase);
      const uint64_t at = static_cast<uint64_t>(s) * (MS_STAGE >> 4);  // descriptor units
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < MS_BK / 16; ++kk)
        wgmma_m64n128_ss<1>(acc, a_desc + at + 2 * kk, b_desc + at + 128 * kk,
                            kt > c0 || kk > 0);
      wg_commit();
      wg_wait1();  // the previous stage's MMAs are done; this one's run on
      if (kt > c0) release(held);
      held = s;
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
    }
    wg_wait0();
    fence_regs(acc);
    release(held);
#pragma unroll
    for (int i = 0; i < 64; ++i) tot[i] = __fadd_rn(tot[i], acc[i]);
  }

  // Y in x's dtype, masked at the ragged edges. Accumulator element 4 j + e:
  // row rloc + 8 (e / 2), column 8 j + 2 t4 + e % 2.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + rloc + 8 * half;
    if (row >= sh.m) continue;
    TX* yrow = y + static_cast<size_t>(row) * sh.n;
#pragma unroll
    for (int j = 0; j < MS_BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t4;
      const float v0 = tot[4 * j + 2 * half], v1 = tot[4 * j + 2 * half + 1];
      if (pairs) {
        if (col < sh.n) store_pair(yrow + col, v0, v1);
      } else {
        if (col < sh.n) store_one(yrow + col, v0);
        if (col + 1 < sh.n) store_one(yrow + col + 1, v1);
      }
    }
  }

  // Row moments of the f32 accumulator on the tensor cores, over the
  // tile's 128 columns (padded columns hold 0).
  float ms[4] = {0.f, 0.f, 0.f, 0.f}, mq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int jp = 0; jp < MS_BN / 16; ++jp) {
    float c0[4], c1[4], q0[4], q1[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      c0[e] = tot[8 * jp + e];
      c1[e] = tot[8 * jp + 4 + e];
      q0[e] = __fmul_rn(c0[e], c0[e]);
      q1[e] = __fmul_rn(c1[e], c1[e]);
    }
    ones_mma_exact(ms, c0, c1);
    ones_mma_exact(mq, q0, q1);
  }
  if (t4 == 0) {  // every column of D holds its row's sum
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + rloc + 8 * half;
      if (row < sh.m) {
        float* p = ws + (static_cast<size_t>(row) * sh.col_blocks + bn) * 2;
        p[0] = ms[2 * half];
        p[1] = mq[2 * half];
      }
    }
  }
  __threadfence();  // publish the partials before the ticket is taken
  named_bar_sync(2, MS_CONSUMERS);
  if (ctid == 0) {
    am_last =
        atomicAdd(tickets + bm, 1u) == static_cast<unsigned int>(sh.col_blocks - 1);
    if (am_last) tickets[bm] = 0u;  // every other tile of the row block has taken its ticket
  }
  named_bar_sync(2, MS_CONSUMERS);
  if (am_last) {  // CTA-uniform: the row block's last tile folds it in column-block order
    __threadfence();
    const int r = ctid % MS_BM, q = ctid / MS_BM;  // row r, moment q (0: sum, 1: squares)
    const int row = m0 + r;
    if (row < sh.m) {
      const float* p = ws + static_cast<size_t>(row) * sh.col_blocks * 2 + q;
      float total = 0.f;
      for (int j = 0; j < sh.col_blocks; ++j) total += __ldcg(p + 2 * j);
      (q == 0 ? s_out : ss_out)[row] = total;
    }
  }
}

size_t itemsize(int dtype) { return dtype == DT_F32 ? 4 : 2; }

CUtensorMapDataType tma_type(int dtype) {
  return dtype == DT_F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : dtype == DT_F16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// The (rows, cols) row-major matrix at `base` as boxes of box_cols x
// box_rows: the 128-byte swizzle for the TMA route, raw rows for CAST.
int encode(CUtensorMap* map, const void* base, int dtype, int rows, int cols, int box_cols,
           int box_rows, int route) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * itemsize(dtype)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  return encode_tiled(map, tma_type(dtype), 2, base, dims, strides, box,
                      route == ROUTE_TMA ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <typename TX>
int launch(const void* x, const void* w, void* y, float* s, float* ss, MsShape sh, float* ws,
           unsigned int* tickets, int x_dtype, cudaStream_t stream) {
  CUtensorMap tmx, tmw;
  memset(&tmx, 0, sizeof(tmx));
  memset(&tmw, 0, sizeof(tmw));
  int err = 0;
  if (sh.route_x != ROUTE_ELEM)
    err = encode(&tmx, x, x_dtype, sh.m, sh.k, MS_BK, MS_BM, sh.route_x);
  if (!err && sh.route_w != ROUTE_ELEM)
    err = encode(&tmw, w, sh.w_dtype, sh.k, sh.n, sh.route_w == ROUTE_TMA ? 64 : MS_BN, MS_BK,
                 sh.route_w);
  if (err) return err;
  const size_t raw = 2 * (static_cast<size_t>(sh.raw_x) + sh.raw_w);
  const size_t fixed = 1024 + raw + 8 * (2 * MS_MAX_STAGES + MS_RAW_STAGES);
  sh.stages = static_cast<int>((MS_SMEM_LIMIT - fixed) / MS_STAGE);
  if (sh.stages > MS_MAX_STAGES) sh.stages = MS_MAX_STAGES;
  const size_t smem = fixed + static_cast<size_t>(sh.stages) * MS_STAGE;
  const cudaError_t attr = cudaFuncSetAttribute(
      matmul_stats_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  matmul_stats_kernel<TX><<<sh.tiles, MS_THREADS, smem, stream>>>(
      tmx, tmw, static_cast<const TX*>(x), w, static_cast<TX*>(y), s, ss, sh, ws, tickets);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (m, k) row-major of x_dtype; w: (k, n) row-major of w_dtype; y: (m, n)
// of x_dtype; s, ss: m floats. route_x / route_w: how each operand is
// loaded (ROUTE_TMA only for bf16, TMA and CAST only for a 16-byte aligned
// base with rows a multiple of 16 bytes). ws: m * ceil(n / 128) * 2 floats
// (uninitialised); tickets: ceil(m / 128) unsigned ints, 0 on entry and 0
// again when the kernel ends. m, n >= 1, k >= 0.
extern "C" int ms_forward(const void* x, const void* w, void* y, float* s, float* ss, int m,
                          int n, int k, int x_dtype, int w_dtype, int route_x, int route_w,
                          float* ws, unsigned int* tickets, void* stream) {
  if (m < 1 || n < 1 || k < 0 || x_dtype < DT_F32 || x_dtype > DT_F16 || w_dtype < DT_F32 ||
      w_dtype > DT_F16 || route_x < ROUTE_TMA || route_x > ROUTE_ELEM ||
      route_w < ROUTE_TMA || route_w > ROUTE_ELEM)
    return static_cast<int>(cudaErrorInvalidValue);
  auto tma_ok = [](const void* p, int dtype, int cols, int route) {
    if (route == ROUTE_ELEM) return true;
    if (route == ROUTE_TMA && dtype != DT_BF16) return false;
    if (route == ROUTE_CAST && dtype == DT_BF16) return false;
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (cols * itemsize(dtype)) % 16 == 0;
  };
  if (!tma_ok(x, x_dtype, k, route_x) || !tma_ok(w, w_dtype, n, route_w))
    return static_cast<int>(cudaErrorInvalidValue);
  MsShape sh;
  sh.m = m;
  sh.n = n;
  sh.k = k;
  sh.col_blocks = (n + MS_BN - 1) / MS_BN;
  const long long tiles = static_cast<long long>((m + MS_BM - 1) / MS_BM) * sh.col_blocks;
  if (tiles > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  sh.tiles = static_cast<int>(tiles);
  // K = 0: no stage is loaded (and no tensor map can describe the operands)
  sh.route_x = k == 0 ? ROUTE_ELEM : route_x;
  sh.route_w = k == 0 ? ROUTE_ELEM : route_w;
  sh.w_dtype = w_dtype;
  sh.stages = 0;
  sh.raw_x = sh.route_x == ROUTE_CAST ? MS_BM * MS_BK * static_cast<uint32_t>(itemsize(x_dtype))
                                      : 0;
  sh.raw_w = sh.route_w == ROUTE_CAST ? MS_BK * MS_BN * static_cast<uint32_t>(itemsize(w_dtype))
                                      : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case DT_F32:
      return launch<float>(x, w, y, s, ss, sh, ws, tickets, x_dtype, st);
    case DT_BF16:
      return launch<__nv_bfloat16>(x, w, y, s, ss, sh, ws, tickets, x_dtype, st);
    default:
      return launch<__half>(x, w, y, s, ss, sh, ws, tickets, x_dtype, st);
  }
}
