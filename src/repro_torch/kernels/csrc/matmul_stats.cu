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
// Design: one CTA of eight warps per 128 x 128 tile of Y; warp (wm, wn)
// owns rows 64 wm .. 64 wm + 63 and columns 32 wn .. 32 wn + 31, as 4 x 4
// mma.sync.m16n8k16 bf16 tiles with f32 accumulators in registers. The
// tensor cores' f32 accumulation does not round to nearest: over a long K
// its error is one-sided, and no sum over a row cancels it in sum(y * y).
// So the accumulators are added into a second f32 tile by round-to-nearest
// adds after every 512 of K, the reference's K block (`bk`). K runs
// in steps of 32 through a double buffer in shared memory: the next step's
// X and W are loaded into registers in their own dtype while the tensor
// cores work on the current one, then rounded to bf16 and stored into the
// other buffer (the in-kernel cast rules out cp.async). Fragments come from
// ldmatrix (W's with .trans). Loads past M, N or K read zeros, so padded K
// adds nothing and padded columns add 0 to the moments; stores are masked.
// When K or N times the itemsize is not a multiple of 16 bytes, or an
// operand is not 16-byte aligned, the same kernel loads element by element
// (a uniform branch on `aligned`). No wgmma or TMA yet: right and simple
// first.
//
// The moments: the C fragments of two adjacent m16n8 tiles are the A
// fragment of one m16k16 MMA (flash attention's P @ V layout), so the
// accumulator feeds a ones-MMA without leaving registers. A bf16 operand
// keeps 8 significant bits, so each f32 value v (y, and y * y rounded in
// f32) is split into three bf16 pieces, hi = bf16(v), mid = bf16(v - hi),
// lo = bf16(v - hi - mid), whose sum is v exactly (each difference is exact
// in f32 and the last holds at most 8 significant bits); the three pieces
// go through ones-MMAs with f32 accumulation. The only error left is the
// f32 accumulation of the sums, as in the plain version.
//
// Across CTAs, without float atomics: the four column warps' row sums are
// added in warp order, each CTA writes its (128, 2) partial into a (M,
// column blocks, 2) workspace, and the last CTA of each row block, found by
// an integer ticket per row block, folds the partials in column-block order
// and writes s and ss. One launch per call; two launches on the same input
// give the same bits.
#include "common.cuh"

namespace {

constexpr int MS_BM = 128;              // rows of Y per CTA
constexpr int MS_BN = 128;              // columns of Y per CTA
constexpr int MS_BK = 32;               // K per pipeline step
constexpr int MS_FOLD_STEPS = 16;       // steps per f32 fold: 512 of K, the reference's bk
constexpr int MS_THREADS = 256;         // eight warps: 2 (rows) x 4 (columns)
constexpr int MS_LDX = MS_BK + 8;       // smem row strides (bf16), 16-byte multiples
constexpr int MS_LDW = MS_BN + 8;       // that put ldmatrix's eight rows in distinct banks
constexpr int MS_GROUPS = MS_BM * MS_BK / 8 / MS_THREADS;  // 8-element groups per thread
static_assert(MS_BK * MS_BN / 8 / MS_THREADS == MS_GROUPS, "X and W tiles hold as many groups");

// Eight elements of T as raw 32-bit words (f32: 8 words; bf16 / f16: 4).
template <typename T>
struct Raw {
  static constexpr int kWords = 8 * static_cast<int>(sizeof(T)) / 4;
  uint32_t w[kWords];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Eight elements at src[0..8) of a row, zero where `row_ok` is false or the
// column col + e is past `cols`. Aligned: 16-byte loads, each wholly in or
// out of range (cols is a multiple of 16 / sizeof(T) there); otherwise one
// element at a time.
template <typename T>
__device__ __forceinline__ void load_group(Raw<T>& r, const T* src, bool row_ok, int col,
                                           int cols, bool aligned) {
  constexpr int kVec = Raw<T>::kWords / 4;          // 16-byte vectors per group
  constexpr int kPerVec = 16 / static_cast<int>(sizeof(T));
  if (aligned) {
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (row_ok && col + v * kPerVec < cols)
        u = *reinterpret_cast<const uint4*>(src + v * kPerVec);
      r.w[4 * v + 0] = u.x;
      r.w[4 * v + 1] = u.y;
      r.w[4 * v + 2] = u.z;
      r.w[4 * v + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < Raw<T>::kWords; ++i) r.w[i] = 0u;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (row_ok && col + e < cols) {
        if constexpr (sizeof(T) == 4) {
          r.w[e] = __float_as_uint(reinterpret_cast<const float*>(src)[e]);
        } else {
          const uint32_t bits = reinterpret_cast<const unsigned short*>(src)[e];
          r.w[e / 2] |= bits << (16 * (e % 2));
        }
      }
    }
  }
}

// The group rounded to bf16, as four bf16x2 words (element 2i in the low half).
__device__ __forceinline__ void to_bf16(const Raw<float>& r, uint32_t (&o)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = pack_bf16(__uint_as_float(r.w[2 * i]), __uint_as_float(r.w[2 * i + 1]));
}
__device__ __forceinline__ void to_bf16(const Raw<__nv_bfloat16>& r, uint32_t (&o)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = r.w[i];
}
__device__ __forceinline__ void to_bf16(const Raw<__half>& r, uint32_t (&o)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t bits = r.w[i];
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&bits));  // exact
    o[i] = pack_bf16(f.x, f.y);
  }
}

template <typename T>
__device__ __forceinline__ void store_group(__nv_bfloat16* dst, const Raw<T>& r) {
  uint32_t o[4];
  to_bf16(r, o);
  *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
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

template <typename TX, typename TW>
__global__ void __launch_bounds__(MS_THREADS)
matmul_stats_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ y,
                    float* __restrict__ s_out, float* __restrict__ ss_out, int m, int n, int k,
                    int aligned, float* __restrict__ ws, unsigned int* __restrict__ tickets) {
  __shared__ __align__(16) __nv_bfloat16 sX[2][MS_BM * MS_LDX];
  __shared__ __align__(16) __nv_bfloat16 sW[2][MS_BK * MS_LDW];
  __shared__ float sMom[4][MS_BM][2];  // per column warp: (row sum, row sum of squares)
  __shared__ bool am_last;

  const int col_blocks = gridDim.x;
  const int bn_idx = blockIdx.x, bm_idx = blockIdx.y;
  const int m0 = bm_idx * MS_BM, n0 = bn_idx * MS_BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane >> 2, t = lane & 3;
  const bool vec = aligned != 0;

  // The groups this thread stages: X (row q / 4, columns 8 (q % 4) ..) and
  // W (row q / 16, columns 8 (q % 16) ..) of the step's tiles, q = tid + 256 i.
  Raw<TX> rx[MS_GROUPS];
  Raw<TW> rw[MS_GROUPS];
  auto load_step = [&](int k0) {
#pragma unroll
    for (int i = 0; i < MS_GROUPS; ++i) {
      const int q = tid + i * MS_THREADS;
      const int xr = m0 + q / 4, xc = k0 + 8 * (q % 4);
      const bool xok = xr < m;
      load_group(rx[i], x + (xok ? static_cast<size_t>(xr) * k + xc : 0), xok, xc, k, vec);
      const int wr = k0 + q / 16, wc = n0 + 8 * (q % 16);
      const bool wok = wr < k;
      load_group(rw[i], w + (wok ? static_cast<size_t>(wr) * n + wc : 0), wok, wc, n, vec);
    }
  };
  auto store_step = [&](int buf) {
#pragma unroll
    for (int i = 0; i < MS_GROUPS; ++i) {
      const int q = tid + i * MS_THREADS;
      store_group(&sX[buf][(q / 4) * MS_LDX + 8 * (q % 4)], rx[i]);
      store_group(&sW[buf][(q / 16) * MS_LDW + 8 * (q % 16)], rw[i]);
    }
  };

  // acc: the MMAs' accumulators over one chunk of 512 of K; tot: the f32
  // sum of the chunks, added on the CUDA cores (round to nearest)
  float acc[4][4][4], tot[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = tot[i][j][e] = 0.f;

  const int steps = (k + MS_BK - 1) / MS_BK;  // the same for every thread
  if (steps > 0) {
    load_step(0);
    store_step(0);
  }
  __syncthreads();
  for (int kt = 0; kt < steps; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < steps) load_step((kt + 1) * MS_BK);  // in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < MS_BK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], &sX[buf][(wm * 64 + i * 16 + lane % 16) * MS_LDX + kk + (lane / 16) * 8]);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &sW[buf][(kk + lane % 8 + ((lane / 8) & 1) * 8) * MS_LDW + wn * 32 +
                                      jp * 16 + (lane / 16) * 8]);
        b[2 * jp][0] = r[0];
        b[2 * jp][1] = r[1];
        b[2 * jp + 1][0] = r[2];
        b[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    if ((kt + 1) % MS_FOLD_STEPS == 0 || kt + 1 == steps) {  // the same for every thread
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tot[i][j][e] = __fadd_rn(tot[i][j][e], acc[i][j][e]);
            acc[i][j][e] = 0.f;
          }
    }
    if (kt + 1 < steps) store_step(buf ^ 1);
    __syncthreads();
  }

  // Y in x's dtype, masked at the ragged edges.
  const bool pairs = (n % 2) == 0;  // then (row * n + even column) is pair-aligned
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + i * 16 + g + 8 * half;
      if (row >= m) continue;
      TX* yrow = y + static_cast<size_t>(row) * n;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + j * 8 + 2 * t;
        const float v0 = tot[i][j][2 * half], v1 = tot[i][j][2 * half + 1];
        if (pairs) {
          if (col < n) store_pair(yrow + col, v0, v1);
        } else {
          if (col < n) store_one(yrow + col, v0);
          if (col + 1 < n) store_one(yrow + col + 1, v1);
        }
      }
    }
  }

  // Row moments of the f32 accumulator on the tensor cores.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float ms[4] = {0.f, 0.f, 0.f, 0.f}, mq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      float q0[4], q1[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        q0[e] = __fmul_rn(tot[i][2 * jp][e], tot[i][2 * jp][e]);
        q1[e] = __fmul_rn(tot[i][2 * jp + 1][e], tot[i][2 * jp + 1][e]);
      }
      ones_mma_exact(ms, tot[i][2 * jp], tot[i][2 * jp + 1]);
      ones_mma_exact(mq, q0, q1);
    }
    if (t == 0) {  // every column of D holds its row's sum
      const int r = wm * 64 + i * 16 + g;
      sMom[wn][r][0] = ms[0];
      sMom[wn][r][1] = mq[0];
      sMom[wn][r + 8][0] = ms[2];
      sMom[wn][r + 8][1] = mq[2];
    }
  }
  __syncthreads();

  // This CTA's partial: the column warps in order. Thread (r, q) owns row r,
  // moment q (0: sum, 1: sum of squares).
  const int r = tid % MS_BM, q = tid / MS_BM;
  const int row = m0 + r;
  if (row < m) {
    const float part = ((sMom[0][r][q] + sMom[1][r][q]) + sMom[2][r][q]) + sMom[3][r][q];
    ws[(static_cast<size_t>(row) * col_blocks + bn_idx) * 2 + q] = part;
  }
  __threadfence();  // publish the partial before the ticket is taken
  __syncthreads();
  if (tid == 0) {
    am_last = atomicAdd(tickets + bm_idx, 1u) == static_cast<unsigned int>(col_blocks - 1);
    if (am_last) tickets[bm_idx] = 0u;  // every other CTA of the row block has taken its ticket
  }
  __syncthreads();
  if (!am_last) return;

  // The row block's last CTA folds the partials in column-block order.
  __threadfence();
  if (row < m) {
    const float* p = ws + static_cast<size_t>(row) * col_blocks * 2 + q;
    float total = 0.f;
    for (int j = 0; j < col_blocks; ++j) total += __ldcg(p + 2 * j);
    (q == 0 ? s_out : ss_out)[row] = total;
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* y, float* s, float* ss, int m, int n, int k,
           int aligned, float* ws, unsigned int* tickets, cudaStream_t stream) {
  const dim3 grid((n + MS_BN - 1) / MS_BN, (m + MS_BM - 1) / MS_BM);
  matmul_stats_kernel<TX, TW><<<grid, MS_THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(y), s, ss, m, n,
      k, aligned, ws, tickets);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX>
int dispatch_w(const void* x, const void* w, void* y, float* s, float* ss, int m, int n, int k,
               int w_dtype, int aligned, float* ws, unsigned int* tickets, cudaStream_t stream) {
  switch (w_dtype) {
    case DT_F32:
      return launch<TX, float>(x, w, y, s, ss, m, n, k, aligned, ws, tickets, stream);
    case DT_BF16:
      return launch<TX, __nv_bfloat16>(x, w, y, s, ss, m, n, k, aligned, ws, tickets, stream);
    case DT_F16:
      return launch<TX, __half>(x, w, y, s, ss, m, n, k, aligned, ws, tickets, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: (m, k) row-major of x_dtype; w: (k, n) row-major of w_dtype; y: (m, n)
// of x_dtype; s, ss: m floats. `aligned`: x and w 16-byte aligned and k and
// n times their itemsizes multiples of 16 bytes. ws: m * ceil(n / 128) * 2
// floats (uninitialised); tickets: ceil(m / 128) unsigned ints, 0 on entry
// and 0 again when the kernel ends. m, n >= 1, k >= 0.
extern "C" int ms_forward(const void* x, const void* w, void* y, float* s, float* ss, int m,
                          int n, int k, int x_dtype, int w_dtype, int aligned, float* ws,
                          unsigned int* tickets, void* stream) {
  if (m < 1 || n < 1 || k < 0 || (m + MS_BM - 1) / MS_BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case DT_F32:
      return dispatch_w<float>(x, w, y, s, ss, m, n, k, w_dtype, aligned, ws, tickets, st);
    case DT_BF16:
      return dispatch_w<__nv_bfloat16>(x, w, y, s, ss, m, n, k, w_dtype, aligned, ws, tickets,
                                       st);
    case DT_F16:
      return dispatch_w<__half>(x, w, y, s, ss, m, n, k, w_dtype, aligned, ws, tickets, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
