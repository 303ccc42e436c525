// Fused row-moment norms: non-parametric LayerNorm (OLMo) and RMSNorm.
//
// Replaces the TPU kernels `layernorm_np_kernel` and `rmsnorm_kernel` of
// src/repro/kernels/row_moments/kernel.py. Each row's sum and sum of
// squares are the paper's all-ones product (eq. 9, D = X @ 1), issued as
// mma.sync.m16n8k16 bf16 with f32 accumulation; the normalisation runs on
// the CUDA cores.
//
// Bound on this card: bytes. The kernel reads the (rows, d) input and
// writes the output once each; its ones-MMAs do 16 flops per input element
// and statistic, far below the 295 flops/byte where bf16 tensor cores
// become the limit. Design against that: one CTA per 16-row MMA tile with 8
// warps splitting d in interleaved 16-column chunks, so a row block reads
// contiguous 256-byte stretches and 1024 prefill rows give 64 CTAs. The
// second pass re-reads the block's rows, which are still in L1/L2, and
// writes the output. Rows past `rows` are masked (loaded as zero, never
// stored), not padded.
//
// Roundings follow the reference: x and the f32 square x*x are each
// rounded to bf16 before the ones-MMA; var = max(ss/d - mu^2, 0).
#include "common.cuh"

namespace {

constexpr int RM_ROWS = 16;   // rows per CTA: one m16 MMA tile
constexpr int RM_WARPS = 8;   // warps splitting d
constexpr int RM_THREADS = RM_WARPS * 32;

template <typename T, bool LAYERNORM>
__global__ void __launch_bounds__(RM_THREADS)
row_norm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                T* __restrict__ out, int rows, int d, float eps) {
  __shared__ float part_s[RM_WARPS][RM_ROWS];
  __shared__ float part_ss[RM_WARPS][RM_ROWS];
  __shared__ float mu_s[RM_ROWS];
  __shared__ float rstd_s[RM_ROWS];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * RM_ROWS;
  const int ra = row0 + g, rb = row0 + g + 8;
  const bool va = ra < rows, vb = rb < rows;
  const T* xa = x + static_cast<size_t>(va ? ra : 0) * d;
  const T* xb = x + static_cast<size_t>(vb ? rb : 0) * d;

  float acc_s[4] = {0.f, 0.f, 0.f, 0.f};
  float acc_ss[4] = {0.f, 0.f, 0.f, 0.f};
  const float2 zero = make_float2(0.f, 0.f);
  for (int k0 = warp * 16; k0 < d; k0 += RM_WARPS * 16) {
    const int c0 = k0 + 2 * t, c1 = c0 + 8;
    const float2 a0 = va ? load_pair(xa + c0) : zero;
    const float2 a1 = vb ? load_pair(xb + c0) : zero;
    const float2 a2 = va ? load_pair(xa + c1) : zero;
    const float2 a3 = vb ? load_pair(xb + c1) : zero;
    if (LAYERNORM) {
      const uint32_t A[4] = {pack_bf16(a0.x, a0.y), pack_bf16(a1.x, a1.y),
                             pack_bf16(a2.x, a2.y), pack_bf16(a3.x, a3.y)};
      mma_bf16_16816(acc_s, A, ONES_BF16X2, ONES_BF16X2);
    }
    const uint32_t Q[4] = {
        pack_bf16(a0.x * a0.x, a0.y * a0.y), pack_bf16(a1.x * a1.x, a1.y * a1.y),
        pack_bf16(a2.x * a2.x, a2.y * a2.y), pack_bf16(a3.x * a3.x, a3.y * a3.y)};
    mma_bf16_16816(acc_ss, Q, ONES_BF16X2, ONES_BF16X2);
  }
  // every column of D holds the row sum; lane t == 0 owns column 0
  if (t == 0) {
    part_s[warp][g] = acc_s[0];
    part_s[warp][g + 8] = acc_s[2];
    part_ss[warp][g] = acc_ss[0];
    part_ss[warp][g + 8] = acc_ss[2];
  }
  __syncthreads();
  if (threadIdx.x < RM_ROWS) {
    const int r = threadIdx.x;
    float s = 0.f, ss = 0.f;
    for (int w = 0; w < RM_WARPS; ++w) {  // fixed order: deterministic
      s += part_s[w][r];
      ss += part_ss[w][r];
    }
    const float fd = static_cast<float>(d);
    if (LAYERNORM) {
      const float mu = s / fd;
      const float var = fmaxf(ss / fd - mu * mu, 0.f);
      mu_s[r] = mu;
      rstd_s[r] = 1.f / sqrtf(var + eps);
    } else {
      mu_s[r] = 0.f;
      rstd_s[r] = 1.f / sqrtf(ss / fd + eps);
    }
  }
  __syncthreads();

  const int half_d = d / 2;
  for (int i = threadIdx.x; i < RM_ROWS * half_d; i += RM_THREADS) {
    const int r = i / half_d, c = 2 * (i % half_d);
    const int row = row0 + r;
    if (row >= rows) break;  // rows are row-major in i: the rest are past too
    const size_t off = static_cast<size_t>(row) * d + c;
    const float2 v = load_pair(x + off);
    const float mu = mu_s[r], rstd = rstd_s[r];
    float y0, y1;
    if (LAYERNORM) {
      y0 = (v.x - mu) * rstd;
      y1 = (v.y - mu) * rstd;
    } else {
      y0 = v.x * rstd * gamma[c];
      y1 = v.y * rstd * gamma[c + 1];
    }
    store_pair(out + off, y0, y1);
  }
}

template <bool LAYERNORM>
int launch(const void* x, const float* gamma, void* out, int rows, int d,
           float eps, int dtype, cudaStream_t stream) {
  const dim3 grid((rows + RM_ROWS - 1) / RM_ROWS);
  switch (dtype) {
    case DT_F32:
      row_norm_kernel<float, LAYERNORM><<<grid, RM_THREADS, 0, stream>>>(
          static_cast<const float*>(x), gamma, static_cast<float*>(out), rows, d, eps);
      break;
    case DT_BF16:
      row_norm_kernel<__nv_bfloat16, LAYERNORM><<<grid, RM_THREADS, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(x), gamma,
          static_cast<__nv_bfloat16*>(out), rows, d, eps);
      break;
    case DT_F16:
      row_norm_kernel<__half, LAYERNORM><<<grid, RM_THREADS, 0, stream>>>(
          static_cast<const __half*>(x), gamma, static_cast<__half*>(out), rows, d, eps);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rm_layernorm_np(const void* x, void* out, int rows, int d,
                               float eps, int dtype, void* stream) {
  return launch<true>(x, nullptr, out, rows, d, eps, dtype,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int rm_rmsnorm(const void* x, const float* gamma, void* out, int rows,
                          int d, float eps, int dtype, void* stream) {
  return launch<false>(x, gamma, out, rows, d, eps, dtype,
                       static_cast<cudaStream_t>(stream));
}
