// Helpers shared by the full-reduction kernels: the striped fused kernels
// (fused_reduce.cu: K1 and the moments pair K2; fused_kahan.cu: K3) and the
// paper's level (tile_partials.cu: K10).
//
// All of them read the caller's flat buffer in its own dtype (f32, bf16 or
// f16), cast each element to the compute dtype, mask the tail past n to
// zero, and map it by the prologue at the compute dtype. A tile is the
// reference's m x m = 128 x 128 block of 16384 consecutive elements; its
// row i is elements [128 i, 128 i + 128).
#pragma once

#include "common.cuh"

constexpr int RC_GROUP = 8;       // elements per load group: 16 bytes of bf16
constexpr int RC_TILE = 128 * 128;
constexpr int RC_ROW = 128;
constexpr int RC_MAX_STEPS = 8;   // ops.FUSED_MAX_CHAIN_STEPS

enum Prologue : int { PRO_IDENTITY = 0, PRO_SQUARE = 1, PRO_ABS = 2, PRO_MOMENTS = 3 };

// An epilogue chain, passed to a kernel by value.
struct Chain {
  int len;
  int op[RC_MAX_STEPS];
  float p0[RC_MAX_STEPS];
  float p1[RC_MAX_STEPS];
};

inline bool make_chain(int len, const int* ops, const float* p0, const float* p1, Chain* c) {
  if (len < 0 || len > RC_MAX_STEPS) return false;
  c->len = len;
  for (int k = 0; k < RC_MAX_STEPS; ++k) {
    c->op[k] = k < len ? ops[k] : -1;
    c->p0[k] = k < len ? p0[k] : 0.f;
    c->p1[k] = k < len ? p1[k] : 0.f;
  }
  return true;
}

__device__ __forceinline__ float apply_chain(float t, const Chain& c) {
  for (int k = 0; k < c.len; ++k) t = epilogue_step(t, c.op[k], c.p0[k], c.p1[k]);
  return t;
}

// An f32 value rounded to the compute dtype (round to nearest even), kept
// in f32.
template <int CD>
__device__ __forceinline__ float to_compute(float v) {
  if (CD == DT_BF16) return __bfloat162float(__float2bfloat16_rn(v));
  if (CD == DT_F16) return __half2float(__float2half_rn(v));
  return v;
}

// Eight elements [e, e + 8) as f32; elements at or past `end` read as 0.
__device__ __forceinline__ void load_group(const float* x, long long e, long long end,
                                           bool aligned, float (&v)[RC_GROUP]) {
  if (aligned && e + RC_GROUP <= end) {
    const float4 a = *reinterpret_cast<const float4*>(x + e);
    const float4 b = *reinterpret_cast<const float4*>(x + e + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < RC_GROUP; ++i) v[i] = e + i < end ? x[e + i] : 0.f;
}

template <typename T>
__device__ __forceinline__ void load_group(const T* x, long long e, long long end,
                                           bool aligned, float (&v)[RC_GROUP]) {
  if (aligned && e + RC_GROUP <= end) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + e);
    const T* h = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < RC_GROUP; ++i) v[i] = to_f32(h[i]);
    return;
  }
#pragma unroll
  for (int i = 0; i < RC_GROUP; ++i) v[i] = e + i < end ? to_f32(x[e + i]) : 0.f;
}

// The elementwise prologue at the compute dtype (identity, square, abs).
template <int CD>
__device__ __forceinline__ float prologue_map(float cv, int prologue) {
  if (prologue == PRO_SQUARE) return to_compute<CD>(cv * cv);
  if (prologue == PRO_ABS) return fabsf(cv);
  return cv;
}

// Row sums of one tile for the two rows a thread's MMA fragments cover.
// Warp w owns tile rows 16w .. 16w + 15; thread (g = lane / 4, t = lane % 4)
// holds, for rows g and g + 8 of that strip, the 32 elements 8t + 32u + i
// (u < 4, i < 8), already cast and mapped (`r0`, `r1`). bf16 / f16: eight
// m16n8k16 ones-MMAs with f32 accumulation, starting from zero (D = X @ 1);
// every column of D holds its row's sum. f32: CUDA-core sums, each thread's
// 32 in order, then the row's four threads by a fixed shuffle tree.
// Returns the two row sums in every thread of the row's quad. SQ sums the
// squares of the values instead, each taken at the compute dtype (the
// moments prologue's second statistic, from the same registers).
template <int CD, bool SQ = false>
__device__ __forceinline__ float sq_at(float v) {
  return SQ ? to_compute<CD>(v * v) : v;
}

template <int CD, bool SQ = false>
__device__ __forceinline__ float2 tile_row_sums(const float (&r0)[4][RC_GROUP],
                                                const float (&r1)[4][RC_GROUP]) {
  if (CD == DT_F32) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int i = 0; i < RC_GROUP; ++i) {
        s0 = __fadd_rn(s0, sq_at<CD, SQ>(r0[u][i]));
        s1 = __fadd_rn(s1, sq_at<CD, SQ>(r1[u][i]));
      }
    }
    s0 = __fadd_rn(s0, __shfl_xor_sync(0xffffffffu, s0, 1));
    s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, 1));
    s0 = __fadd_rn(s0, __shfl_xor_sync(0xffffffffu, s0, 2));
    s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, 2));
    return make_float2(s0, s1);
  }
  float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * h;
      uint32_t A[4];
      const float a0 = sq_at<CD, SQ>(r0[u][i]), a1 = sq_at<CD, SQ>(r0[u][i + 1]);
      const float a2 = sq_at<CD, SQ>(r0[u][i + 2]), a3 = sq_at<CD, SQ>(r0[u][i + 3]);
      const float b0 = sq_at<CD, SQ>(r1[u][i]), b1 = sq_at<CD, SQ>(r1[u][i + 1]);
      const float b2 = sq_at<CD, SQ>(r1[u][i + 2]), b3 = sq_at<CD, SQ>(r1[u][i + 3]);
      if (CD == DT_BF16) {
        A[0] = pack_bf16(a0, a1);
        A[1] = pack_bf16(b0, b1);
        A[2] = pack_bf16(a2, a3);
        A[3] = pack_bf16(b2, b3);
        mma_bf16_16816(d, A, ONES_BF16X2, ONES_BF16X2);
      } else {
        A[0] = pack_f16(a0, a1);
        A[1] = pack_f16(b0, b1);
        A[2] = pack_f16(a2, a3);
        A[3] = pack_f16(b2, b3);
        mma_f16_16816(d, A, ONES_F16X2, ONES_F16X2);
      }
    }
  }
  return make_float2(d[0], d[2]);
}
