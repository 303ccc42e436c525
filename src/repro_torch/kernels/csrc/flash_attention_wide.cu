// Flash attention forward for head widths 128 < d <= 256 (K6's wide
// variant), with the softmax denominator as an all-ones MMA.
//
// Replaces the same TPU kernel as flash_attention.cu (`_attn_kernel` of
// src/repro/kernels/flash_attention/kernel.py), which takes any head
// width; recurrentgemma-9b's heads are 256 wide. flash_attention.cu's
// `fa_forward` hands every d > 128 to `fa_forward_wide` below.
//
// Why a second kernel: at d = 256 the 128-query CTA of flash_attention.cu
// does not fit. Its Q tile and two stages of K and V take 320 KB of shared
// memory (the card has 227 KB a CTA), and a 64 x 256 f32 output
// accumulator is 128 registers a thread on top of the scores.
//
// Design. One CTA of 8 warps per (batch x head, 128-query block); keys
// stream in blocks of 64 through two shared-memory stages (cp.async for
// bf16; f16 and f32 are loaded, rounded to bf16 and stored by the same
// threads), each stage's next block loading while this one computes. Q
// tiles are 128 rows, K and V tiles 64 rows, all of 256 bf16 columns (512
// bytes a row, 16-byte chunks XOR-swizzled by row, so ldmatrix reads them
// without bank conflicts); columns past d and rows past the sequence are
// zeros. Warp w owns query rows 16 w .. +15 and every output column:
//   S = Q K^T        mma.sync m16n8k16 over the d / 16 k-steps
//   mask, scale, online max, p = 2^(s - m_new) in registers
//   l = l alpha + rowsum(bf16 p)   four m16n8k16 ones-MMAs on P's registers
//   O = O alpha + P V             P from registers (the S accumulator
//                                 re-packed as A fragments), V through
//                                 ldmatrix.trans; O is 16 x 256 f32, 128
//                                 registers a thread
// and writes out = O / max(l, 1e-30). Blocks no query of the CTA can see
// are skipped with the reference's run test; the heaviest causal q-blocks
// run first.
//
// Numerics: those of flash_attention.cu and of the plain version with
// block_q = 128, block_k = 64 (ops.blocks_for): s = (bf16 q . bf16 k) * (scale *
// log2 e), masked to -1e30; m_new = max(m, rowmax s); p = 2^(s - m_new)
// masked to 0; l = l 2^(m - m_new) + rowsum(bf16 p); acc = acc alpha +
// bf16(p) @ bf16(v); out = acc / max(l, 1e-30).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int FW_BQ = 128;                    // query rows per CTA, 16 a warp
constexpr int FW_BK = 64;                     // keys per streamed block
constexpr int FW_DMAX = 256;                  // widest head
constexpr int FW_WARPS = FW_BQ / 16;
constexpr int FW_THREADS = 32 * FW_WARPS;
constexpr int FW_ROW = 2 * FW_DMAX;           // bytes of a tile row (bf16)
constexpr uint32_t FW_QTILE = FW_BQ * FW_ROW;  // 64 KB
constexpr uint32_t FW_KTILE = FW_BK * FW_ROW;  // 32 KB, a K or a V tile
constexpr size_t FW_SMEM = FW_QTILE + 4 * FW_KTILE + 128;  // Q, then K and V for two stages
constexpr float FW_NEG = -1e30f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the byte offset of 16-byte chunk c of row r in a swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * FW_ROW + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
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

// Rows [row0, row0 + ROWS) of a (len, d) matrix into a swizzled tile, by
// all the CTA's threads: bf16 by cp.async (waited for with the stage's
// group), f16 / f32 loaded, rounded to bf16 and stored. Rows past len and
// columns past d are zeros.
template <int ROWS, typename T>
__device__ __forceinline__ void load_tile(unsigned char* tile, const T* src, int row0, int len,
                                          int d) {
#pragma unroll
  for (int j = 0; j < ROWS * 32 / FW_THREADS; ++j) {
    const int i = threadIdx.x + FW_THREADS * j;
    const int r = i / 32, c = i % 32;
    const bool ok = row0 + r < len && 8 * c < d;
    const T* p = src + (ok ? static_cast<size_t>(row0 + r) * d + 8 * c : 0);
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      cp_async16(smem_addr(tile + swz(r, c)), p, ok);
    } else {
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (ok) load8(p, v);
      uint4 packed;
      packed.x = pack_bf16(v[0], v[1]);
      packed.y = pack_bf16(v[2], v[3]);
      packed.z = pack_bf16(v[4], v[5]);
      packed.w = pack_bf16(v[6], v[7]);
      *reinterpret_cast<uint4*>(tile + swz(r, c)) = packed;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(FW_THREADS, 1)
attn_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, int sq, int skv, int d, int n_q_heads, int n_kv_heads,
                     float scale_log2, int causal, int window, int q_offset, int kv_len) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  unsigned char* sQ = smem;
  auto sK = [&](int s) { return smem + FW_QTILE + FW_KTILE * (2 * s); };
  auto sV = [&](int s) { return smem + FW_QTILE + FW_KTILE * (1 + 2 * s); };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FW_BQ;  // the heaviest causal blocks first
  const int b = bh / n_q_heads, h = bh % n_q_heads;
  const int kvh = b * n_kv_heads + h / (n_q_heads / n_kv_heads);
  const int nkb = (skv + FW_BK - 1) / FW_BK;
  const int qpos0 = q_offset + q0;
  const T* kg = k + static_cast<size_t>(kvh) * skv * d;
  const T* vg = v + static_cast<size_t>(kvh) * skv * d;
  // the reference's run test: blocks no query of this CTA can see are skipped
  auto run = [&](int ik) {
    const int k0 = ik * FW_BK;
    bool r = k0 < kv_len;
    if (causal) r = r && (k0 <= qpos0 + FW_BQ - 1);
    if (window > 0) r = r && (qpos0 - (k0 + FW_BK - 1) < window);
    return r;
  };
  auto next_run = [&](int ik) {
    while (ik < nkb && !run(ik)) ++ik;
    return ik;
  };

  int ik = next_run(0);
  load_tile<FW_BQ>(sQ, q + static_cast<size_t>(bh) * sq * d, q0, sq, d);
  if (ik < nkb) {
    load_tile<FW_BK>(sK(0), kg, ik * FW_BK, skv, d);
    load_tile<FW_BK>(sV(0), vg, ik * FW_BK, skv, d);
  }
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = 16 * warp;  // this warp's first query row in the CTA
  const int g = lane / 4, t4 = lane % 4;
  const int qpos_a = qpos0 + rw + g, qpos_b = qpos_a + 8;
  const int ksteps = d / 16;
  const uint32_t q_base = smem_addr(sQ);
  float acc[FW_DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < FW_DMAX / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_a = FW_NEG, m_b = FW_NEG, l_a = 0.f, l_b = 0.f;

  int stage = 0;
  while (ik < nkb) {
    const int nxt = next_run(ik + 1);
    if (nxt < nkb) {  // the next block streams in while this one computes
      load_tile<FW_BK>(sK(stage ^ 1), kg, nxt * FW_BK, skv, d);
      load_tile<FW_BK>(sV(stage ^ 1), vg, nxt * FW_BK, skv, d);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = ik * FW_BK;
    const uint32_t k_base = smem_addr(sK(stage)), v_base = smem_addr(sV(stage));
    // a block that no row of this warp sees is skipped by the warp: for
    // such rows the update is the identity (alpha = 1, p = 0), so skipping
    // it changes no bit
    bool sees = true;
    if (causal) sees = k0 <= qpos0 + rw + 15;
    if (window > 0) sees = sees && (qpos0 + rw - (k0 + FW_BK - 1) < window);
    if (sees) {  // the same for every lane
    // S = Q K^T: 16 rows x 64 keys, f32
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < FW_DMAX / 16; ++kk) {
      if (kk < ksteps) {  // the same for every lane
        uint32_t a[4];
        ldsm_x4(a, q_base + swz(rw + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          uint32_t bk[4];
          ldsm_x4(bk, k_base + swz(8 * j + ((lane >> 4) << 3) + (lane & 7),
                                   2 * kk + ((lane >> 3) & 1)));
          mma_bf16_16816(sc[j], a, bk[0], bk[1]);
          mma_bf16_16816(sc[j + 1], a, bk[2], bk[3]);
        }
      }
    }

    // scale, mask, running max (sc[j][e]: row e < 2 ? a : b, key 8 j + 2 t4 + (e & 1))
    uint32_t valid = 0;
    float mx_a = FW_NEG, mx_b = FW_NEG;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t4 + (e & 1);
        const int qp = e < 2 ? qpos_a : qpos_b;
        bool ok = key < kv_len;
        if (causal) ok = ok && key <= qp;
        if (window > 0) ok = ok && (qp - key) < window;
        const float sv = ok ? sc[j][e] * scale_log2 : FW_NEG;
        sc[j][e] = sv;
        if (ok) valid |= 1u << (4 * j + e);
        if (e < 2) mx_a = fmaxf(mx_a, sv); else mx_b = fmaxf(mx_b, sv);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = ex2(m_a - mn_a), alpha_b = ex2(m_b - mn_b);

    // P = 2^(S - m_new) as bf16 A fragments, one per 16 keys
    uint32_t pf[FW_BK / 16][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = (valid >> (4 * j + e) & 1u) ? ex2(sc[j][e] - (e < 2 ? mn_a : mn_b)) : 0.f;
      pf[j / 2][(j & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }

    // the denominator: rowsum(bf16 p) as a ones-MMA, f32 accumulate
    float ls[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < FW_BK / 16; ++kk) mma_bf16_16816(ls, pf[kk], ONES_BF16X2, ONES_BF16X2);
    l_a = l_a * alpha_a + ls[0];
    l_b = l_b * alpha_b + ls[2];

    // O = O alpha + P V
#pragma unroll
    for (int j = 0; j < FW_DMAX / 8; ++j) {
      acc[j][0] *= alpha_a; acc[j][1] *= alpha_a;
      acc[j][2] *= alpha_b; acc[j][3] *= alpha_b;
    }
#pragma unroll
    for (int kk = 0; kk < FW_BK / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < FW_DMAX / 16; ++np) {
        if (16 * np < d) {  // the same for every lane
          uint32_t bv[4];
          ldsm_x4_t(bv, v_base + swz(16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7),
                                     2 * np + (lane >> 4)));
          mma_bf16_16816(acc[2 * np], pf[kk], bv[0], bv[1]);
          mma_bf16_16816(acc[2 * np + 1], pf[kk], bv[2], bv[3]);
        }
      }
    }
    m_a = mn_a;
    m_b = mn_b;
    }
    __syncthreads();  // this stage is free for the block after next
    stage ^= 1;
    ik = nxt;
  }
  cp_async_wait<0>();

  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  T* oa = o + (static_cast<size_t>(bh) * sq + q0 + rw + g) * d;
  T* ob = oa + 8 * static_cast<size_t>(d);
  const bool live_a = q0 + rw + g < sq, live_b = q0 + rw + g + 8 < sq;
#pragma unroll
  for (int j = 0; j < FW_DMAX / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    if (8 * j < d) {
      if (live_a) store_pair(oa + c, acc[j][0] / den_a, acc[j][1] / den_a);
      if (live_b) store_pair(ob + c, acc[j][2] / den_b, acc[j][3] / den_b);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int sq, int skv, int d,
           int n_q_heads, int n_kv_heads, float scale_log2, int causal, int window,
           int q_offset, int kv_len, cudaStream_t stream) {
  const cudaError_t attr =
      cudaFuncSetAttribute(attn_fwd_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(FW_SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(bh, (sq + FW_BQ - 1) / FW_BQ);
  attn_fwd_wide_kernel<T><<<grid, FW_THREADS, FW_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, skv, d, n_q_heads, n_kv_heads, scale_log2, causal, window,
      q_offset, kv_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// As fa_forward (flash_attention.cu), for 128 < d <= 256, d a multiple of 16.
extern "C" int fa_forward_wide(const void* q, const void* k, const void* v, void* o, int bh,
                               int sq, int skv, int d, int n_q_heads, int n_kv_heads,
                               float scale_log2, int causal, int window, int q_offset,
                               int kv_len, int dtype, void* stream) {
  if (d % 16 != 0 || d <= 128 || d > FW_DMAX) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return launch<float>(q, k, v, o, bh, sq, skv, d, n_q_heads, n_kv_heads, scale_log2,
                           causal, window, q_offset, kv_len, s);
    case DT_BF16:
      return launch<__nv_bfloat16>(q, k, v, o, bh, sq, skv, d, n_q_heads, n_kv_heads,
                                   scale_log2, causal, window, q_offset, kv_len, s);
    case DT_F16:
      return launch<__half>(q, k, v, o, bh, sq, skv, d, n_q_heads, n_kv_heads, scale_log2,
                            causal, window, q_offset, kv_len, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
