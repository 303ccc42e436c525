// Flash attention forward with the softmax denominator as an all-ones MMA.
//
// Replaces the TPU kernel `_attn_kernel` of
// src/repro/kernels/flash_attention/kernel.py: online-softmax attention
// over streamed K/V blocks, GQA head map, causal mask, sliding window,
// q_offset, and the kv_len mask; the denominator update
// l = l * alpha + rowsum(bf16(p)) is a ones-MMA (the paper's eq. 9), as in
// the reference.
//
// Bound on this card: at the serving shapes (Sq = Skv = 256, D = 128) the
// causal FLOPs take about a fifth of the time the q/k/v/o bytes take, so
// the kernel is bound by bytes and, at this size, by launch and latency.
// Design: one CTA of 4 warps per (batch*head, 64-query block); each warp
// owns 16 query rows and keeps its Q fragments, the running max, the
// denominator and the f32 output accumulator in registers. K and V stream
// through shared memory one 64-key block at a time (3 tiles of 64 x 136
// bf16 = 52 KB of dynamic shared memory). QK^T, PV and the denominator are
// mma.sync.m16n8k16 bf16 with f32 accumulation. Blocks that no query of
// the CTA can see (future, past the window, past kv_len) are skipped with
// the reference's run test. No wgmma or TMA yet: right and simple first.
//
// Numerics mirror the reference block update: s = (bf16 q . bf16 k) * scale,
// masked to NEG = -1e30; m_new = max(m, rowmax s); p = exp(s - m_new)
// masked to 0; l = l * exp(m - m_new) + rowsum(bf16 p);
// acc = acc * alpha + bf16(p) @ bf16(v); out = acc / max(l, 1e-30).
#include "common.cuh"

namespace {

constexpr int FA_BQ = 64;            // query rows per CTA
constexpr int FA_BK = 64;            // keys per streamed block
constexpr int FA_WARPS = FA_BQ / 16;
constexpr int FA_THREADS = FA_WARPS * 32;
constexpr int FA_DMAX = 128;         // largest head dim
constexpr int FA_LD = FA_DMAX + 8;   // smem row stride (bf16): skews banks
constexpr float FA_NEG = -1e30f;
constexpr size_t FA_SMEM = 3ull * FA_BQ * FA_LD * sizeof(__nv_bfloat16);

__device__ __forceinline__ uint32_t ld_smem32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [row0, row0 + 64) of a (len, d) matrix -> bf16 smem tile; rows past
// `len` are zero, as the reference's zero padding.
template <typename T>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const T* src, int row0,
                                          int len, int d) {
  const int half_d = d / 2;
  for (int i = threadIdx.x; i < FA_BQ * half_d; i += FA_THREADS) {
    const int r = i / half_d, c = 2 * (i % half_d);
    float2 v = make_float2(0.f, 0.f);
    if (row0 + r < len) v = load_pair(src + static_cast<size_t>(row0 + r) * d + c);
    *reinterpret_cast<__nv_bfloat162*>(dst + r * FA_LD + c) = __floats2bfloat162_rn(v.x, v.y);
  }
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o, int sq, int skv, int d,
                int n_q_heads, int n_kv_heads, float sm_scale, int causal,
                int window, int q_offset, int kv_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + FA_BQ * FA_LD;
  __nv_bfloat16* sV = sK + FA_BK * FA_LD;

  const int bh = blockIdx.y, q0 = blockIdx.x * FA_BQ;
  const int b = bh / n_q_heads, h = bh % n_q_heads;
  const int kvh = b * n_kv_heads + h / (n_q_heads / n_kv_heads);
  const T* qg = q + static_cast<size_t>(bh) * sq * d;
  const T* kg = k + static_cast<size_t>(kvh) * skv * d;
  const T* vg = v + static_cast<size_t>(kvh) * skv * d;
  T* og = o + static_cast<size_t>(bh) * sq * d;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int ra = warp * 16 + g, rb = ra + 8;  // this thread's two rows
  const int nkk = d / 16;                      // k-steps over the head dim

  load_tile(sQ, qg, q0, sq, d);
  __syncthreads();
  uint32_t qf[FA_DMAX / 16][4];
#pragma unroll
  for (int kk = 0; kk < FA_DMAX / 16; ++kk) {
    if (kk < nkk) {
      const int c = kk * 16 + 2 * t;
      qf[kk][0] = ld_smem32(sQ + ra * FA_LD + c);
      qf[kk][1] = ld_smem32(sQ + rb * FA_LD + c);
      qf[kk][2] = ld_smem32(sQ + ra * FA_LD + c + 8);
      qf[kk][3] = ld_smem32(sQ + rb * FA_LD + c + 8);
    }
  }

  float m_a = FA_NEG, m_b = FA_NEG, l_a = 0.f, l_b = 0.f;
  float acc[FA_DMAX / 8][4];
#pragma unroll
  for (int nd = 0; nd < FA_DMAX / 8; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  const int qpos0 = q_offset + q0;
  const int qpos_a = qpos0 + ra, qpos_b = qpos0 + rb;
  const int nkb = (skv + FA_BK - 1) / FA_BK;
  for (int ik = 0; ik < nkb; ++ik) {
    const int k0 = ik * FA_BK;
    // the reference's run test: skip blocks no query of this CTA can see
    bool run = k0 < kv_len;
    if (causal) run = run && (k0 <= qpos0 + FA_BQ - 1);
    if (window > 0) run = run && (qpos0 - (k0 + FA_BK - 1) < window);
    if (!run) continue;  // uniform across the CTA

    __syncthreads();  // every warp is done with the previous K/V tiles
    load_tile(sK, kg, k0, skv, d);
    load_tile(sV, vg, k0, skv, d);
    __syncthreads();

    // S = Q K^T: 8 n-tiles of 8 keys, f32 accumulate
    float s[FA_BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < FA_BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = sK + (nt * 8 + g) * FA_LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < FA_DMAX / 16; ++kk)
        if (kk < nkk)
          mma_bf16_16816(s[nt], qf[kk], ld_smem32(krow + kk * 16),
                         ld_smem32(krow + kk * 16 + 8));
    }

    // scale, mask, running max
    uint32_t valid = 0;
    float mx_a = FA_NEG, mx_b = FA_NEG;
#pragma unroll
    for (int nt = 0; nt < FA_BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const int qp = e < 2 ? qpos_a : qpos_b;
        bool ok = key < kv_len;
        if (causal) ok = ok && key <= qp;
        if (window > 0) ok = ok && (qp - key) < window;
        const float sv = ok ? s[nt][e] * sm_scale : FA_NEG;
        s[nt][e] = sv;
        if (ok) valid |= 1u << (nt * 4 + e);
        if (e < 2) mx_a = fmaxf(mx_a, sv); else mx_b = fmaxf(mx_b, sv);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = expf(m_a - mn_a), alpha_b = expf(m_b - mn_b);

    // P = exp(S - m_new) as bf16 A fragments (4 k-steps of 16 keys)
    uint32_t pf[FA_BK / 16][4];
#pragma unroll
    for (int nt = 0; nt < FA_BK / 8; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = (valid >> (nt * 4 + e) & 1u) ? expf(s[nt][e] - (e < 2 ? mn_a : mn_b)) : 0.f;
      pf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }

    // denominator: rowsum(bf16 p) as a ones-MMA, f32 accumulate
    float ls[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < FA_BK / 16; ++kk)
      mma_bf16_16816(ls, pf[kk], ONES_BF16X2, ONES_BF16X2);
    l_a = l_a * alpha_a + ls[0];
    l_b = l_b * alpha_b + ls[2];

    // acc = acc * alpha + P V, one 8-column slice of the head dim at a time
#pragma unroll
    for (int nd = 0; nd < FA_DMAX / 8; ++nd) {
      if (nd * 8 < d) {
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
        const __nv_bfloat16* vcol = sV + nd * 8 + g;
#pragma unroll
        for (int kk = 0; kk < FA_BK / 16; ++kk) {
          const int key = kk * 16 + 2 * t;
          const uint32_t b0 = pack_raw(vcol[key * FA_LD], vcol[(key + 1) * FA_LD]);
          const uint32_t b1 = pack_raw(vcol[(key + 8) * FA_LD], vcol[(key + 9) * FA_LD]);
          mma_bf16_16816(pv, pf[kk], b0, b1);
        }
        acc[nd][0] = acc[nd][0] * alpha_a + pv[0];
        acc[nd][1] = acc[nd][1] * alpha_a + pv[1];
        acc[nd][2] = acc[nd][2] * alpha_b + pv[2];
        acc[nd][3] = acc[nd][3] * alpha_b + pv[3];
      }
    }
    m_a = mn_a;
    m_b = mn_b;
  }

  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int nd = 0; nd < FA_DMAX / 8; ++nd) {
    if (nd * 8 < d) {
      const int c = nd * 8 + 2 * t;
      if (q0 + ra < sq)
        store_pair(og + static_cast<size_t>(q0 + ra) * d + c, acc[nd][0] / den_a,
                   acc[nd][1] / den_a);
      if (q0 + rb < sq)
        store_pair(og + static_cast<size_t>(q0 + rb) * d + c, acc[nd][2] / den_b,
                   acc[nd][3] / den_b);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int sq,
           int skv, int d, int n_q_heads, int n_kv_heads, float sm_scale, int causal,
           int window, int q_offset, int kv_len, cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      attn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(FA_SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((sq + FA_BQ - 1) / FA_BQ, bh);
  attn_fwd_kernel<T><<<grid, FA_THREADS, FA_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, skv, d, n_q_heads, n_kv_heads, sm_scale, causal, window,
      q_offset, kv_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (bh, sq, d); k, v: (bh / (n_q_heads / n_kv_heads), skv, d); o like q.
// window <= 0 means no window. d must be a multiple of 16, at most 128.
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o, int bh,
                          int sq, int skv, int d, int n_q_heads, int n_kv_heads,
                          float sm_scale, int causal, int window, int q_offset,
                          int kv_len, int dtype, void* stream) {
  if (d % 16 != 0 || d > FA_DMAX || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return launch<float>(q, k, v, o, bh, sq, skv, d, n_q_heads, n_kv_heads, sm_scale,
                           causal, window, q_offset, kv_len, s);
    case DT_BF16:
      return launch<__nv_bfloat16>(q, k, v, o, bh, sq, skv, d, n_q_heads, n_kv_heads,
                                   sm_scale, causal, window, q_offset, kv_len, s);
    case DT_F16:
      return launch<__half>(q, k, v, o, bh, sq, skv, d, n_q_heads, n_kv_heads, sm_scale,
                            causal, window, q_offset, kv_len, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
