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

// ---------------------------------------------------------------------------
// The word route (K1, K2, K3, K8 and K10; the helpers above serve K4).
//
// A load group's eight elements are kept as the words loaded (`Raw`) until
// they become the ones-MMA's A operand: four 32-bit words, each two
// compute-dtype values, `lo` in the low half (pack_bf16's order). When the
// input dtype is the compute dtype the loaded words ARE that operand; f32
// (or the other 16-bit dtype) is rounded once per pair (cvt.rn.bf16x2.f32 /
// cvt.rn.f16x2.f32), which is what to_compute followed by pack_bf16 /
// pack_f16 gives (the second rounding of an exact value changes nothing).
// On the words: the window mask clears halves, the census counts halves
// whose exponent is all ones (non-finite; 0x7f80 in bf16, 0x7c00 in f16),
// abs clears the sign bits, square unpacks (exactly), squares in f32 and
// packs (one rounding: to_compute then pack again gives the same bits).
// tests/test_torch_word_route.py holds these identities over every 16-bit
// pattern.

template <typename T> struct DtypeOf;
template <> struct DtypeOf<float> { static constexpr int value = DT_F32; };
template <> struct DtypeOf<__nv_bfloat16> { static constexpr int value = DT_BF16; };
template <> struct DtypeOf<__half> { static constexpr int value = DT_F16; };

// Eight consecutive elements as loaded: one 16-byte word for 16-bit
// dtypes, two for f32.
template <typename T>
struct Raw {
  uint4 q[sizeof(T) / 2];
};

// Elements [e, e + 8) as loaded; elements at or past `end` read as 0. One
// or two 16-byte loads when `vec` (16-byte aligned base) and the group
// lies before `end`, else element loads.
template <typename T>
__device__ __forceinline__ void load_raw(const T* x, long long e, long long end, bool vec,
                                         Raw<T>& g) {
  constexpr int Q = sizeof(T) / 2;
  if (vec && e + RC_GROUP <= end) {
    const uint4* p = reinterpret_cast<const uint4*>(x + e);
#pragma unroll
    for (int q = 0; q < Q; ++q) g.q[q] = __ldg(p + q);
    return;
  }
  uint32_t w[4 * Q];
  if constexpr (sizeof(T) == 4) {
    const uint32_t* b = reinterpret_cast<const uint32_t*>(x);
#pragma unroll
    for (int i = 0; i < RC_GROUP; ++i) w[i] = e + i < end ? __ldg(b + e + i) : 0u;
  } else {
    const unsigned short* b = reinterpret_cast<const unsigned short*>(x);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t lo = e + 2 * k < end ? __ldg(b + e + 2 * k) : 0u;
      const uint32_t hi = e + 2 * k + 1 < end ? __ldg(b + e + 2 * k + 1) : 0u;
      w[k] = lo | (hi << 16);
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) g.q[q] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
}

// Element i of a loaded group as f32 (exact).
template <typename T>
__device__ __forceinline__ float raw_elem(const Raw<T>& g, int i) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(g.q);
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[i]);
  } else {
    const unsigned short h = static_cast<unsigned short>(w[i / 2] >> (16 * (i % 2)));
    if constexpr (DtypeOf<T>::value == DT_BF16) return __uint_as_float(static_cast<uint32_t>(h) << 16);
    else return __half2float(__ushort_as_half(h));
  }
}

// Two f32 values rounded to the 16-bit compute dtype in one word.
template <int CD>
__device__ __forceinline__ uint32_t pack_cd(float lo, float hi) {
  return CD == DT_BF16 ? pack_bf16(lo, hi) : pack_f16(lo, hi);
}

// The two compute-dtype values of a word, as f32 (exact).
template <int CD>
__device__ __forceinline__ float2 unpack_cd(uint32_t w) {
  if (CD == DT_BF16) return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
  __half2 h = *reinterpret_cast<__half2*>(&w);
  return __half22float2(h);
}

// The group as four compute-dtype words (CD bf16 or f16): the loaded words
// when the input dtype is CD, else one rounding per pair.
template <typename T, int CD>
__device__ __forceinline__ void raw_words(const Raw<T>& g, uint32_t (&w)[4]) {
  if constexpr (DtypeOf<T>::value == CD) {
    w[0] = g.q[0].x; w[1] = g.q[0].y; w[2] = g.q[0].z; w[3] = g.q[0].w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = pack_cd<CD>(raw_elem(g, 2 * k), raw_elem(g, 2 * k + 1));
  }
}

// Keeps the halves of elements [lin, lin + 8) that lie in [lo, hi).
__device__ __forceinline__ void mask_words(uint32_t (&w)[4], int lin, int lo, int hi) {
  if (lin >= lo && lin + RC_GROUP <= hi) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int e = lin + 2 * k;
    const uint32_t keep = (e >= lo && e < hi ? 0x0000ffffu : 0u) |
                          (e + 1 >= lo && e + 1 < hi ? 0xffff0000u : 0u);
    w[k] &= keep;
  }
}

// Non-finite halves of a compute-dtype word: exponent all ones.
template <int CD>
__device__ __forceinline__ int nonfinite_halves(uint32_t w) {
  constexpr uint32_t E = CD == DT_BF16 ? 0x7f807f80u : 0x7c007c00u;
  const uint32_t e = w & E;
  return static_cast<int>((e & 0xffffu) == (E & 0xffffu)) + static_cast<int>((e >> 16) == (E >> 16));
}

// The elementwise prologue (identity, square, abs) on a compute-dtype word.
template <int CD, int PRO>
__device__ __forceinline__ uint32_t prologue_word(uint32_t w) {
  if constexpr (PRO == PRO_ABS) {
    return w & 0x7fff7fffu;
  } else if constexpr (PRO == PRO_SQUARE) {
    const float2 v = unpack_cd<CD>(w);
    return pack_cd<CD>(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
  } else {
    return w;
  }
}

// The ones-MMA at the compute dtype: D += A @ 1.
template <int CD>
__device__ __forceinline__ void ones_mma(float (&d)[4], const uint32_t (&a)[4]) {
  if (CD == DT_BF16) mma_bf16_16816(d, a, ONES_BF16X2, ONES_BF16X2);
  else mma_f16_16816(d, a, ONES_F16X2, ONES_F16X2);
}

// A strided group of f32 partials (an upper level reading one column of a
// moments pair), else load_raw: elements [e, e + 8) at x[(e + i) * stride].
template <typename T>
__device__ __forceinline__ void load_raw_at(const T* x, long long e, long long end,
                                            long long stride, bool vec, Raw<T>& g) {
  if constexpr (sizeof(T) == 4) {
    if (stride != 1) {
      const uint32_t* b = reinterpret_cast<const uint32_t*>(x);
      uint32_t w[RC_GROUP];
#pragma unroll
      for (int i = 0; i < RC_GROUP; ++i) w[i] = e + i < end ? __ldg(b + (e + i) * stride) : 0u;
      g.q[0] = make_uint4(w[0], w[1], w[2], w[3]);
      g.q[1] = make_uint4(w[4], w[5], w[6], w[7]);
      return;
    }
  }
  load_raw(x, e, end, vec, g);
}

// ---------------------------------------------------------------------------
// Tile strips on the word route (K3 and K10).
//
// Warp w of a 256-thread CTA owns rows 16w .. 16w + 15 of a tile, and thread
// (g = lane / 4, t = lane % 4) the groups 8t + 32u (u < 4) of rows g and
// g + 8 of that strip, as tile_row_sums takes them. A kernel reads a strip
// in 4 / SU steps of SU = STRIP_U<T> values of u, 4 KB a warp (the whole
// strip at 16-bit input, half of it at f32: 32 registers of loaded words
// either way), and loads the next step while it sums this one. Word pair
// (2i, 2i + 1) of a group is pack(r[u][2i], r[u][2i + 1]), so every
// ones-MMA gets the A operand tile_row_sums gave it, in the same order,
// and f32 compute adds the same values in the same order: the row sums are
// bitwise the element route's.

template <typename T>
constexpr int STRIP_U = 8 / static_cast<int>(sizeof(T));

template <typename T, int SU>
struct Strip {
  Raw<T> r0[SU], r1[SU];  // rows g and g + 8
};

// Step `s` of the strip whose thread's first element (row g, u = 0) is e.
template <typename T, int SU>
__device__ __forceinline__ void load_strip(const T* x, long long e, int s, long long end,
                                           long long stride, bool vec, Strip<T, SU>& st) {
#pragma unroll
  for (int k = 0; k < SU; ++k) {
    const long long off = e + 32 * (SU * s + k);
    load_raw_at(x, off, end, stride, vec, st.r0[k]);
    load_raw_at(x, off + 8 * RC_ROW, end, stride, vec, st.r1[k]);
  }
}

// The step's A operands at the compute dtype (bf16 / f16), mapped by PRO.
template <typename T, int CD, int PRO, int SU>
__device__ __forceinline__ void strip_words(const Strip<T, SU>& st, uint32_t (&w0)[SU][4],
                                            uint32_t (&w1)[SU][4]) {
#pragma unroll
  for (int k = 0; k < SU; ++k) {
    raw_words<T, CD>(st.r0[k], w0[k]);
    raw_words<T, CD>(st.r1[k], w1[k]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w0[k][i] = prologue_word<CD, PRO>(w0[k][i]);
      w1[k][i] = prologue_word<CD, PRO>(w1[k][i]);
    }
  }
}

// The step's ones-MMAs into D (rows g and g + 8 in d[0] and d[2]); SQ feeds
// the squares of the words, each rounded to the compute dtype.
template <int CD, int SU, bool SQ = false>
__device__ __forceinline__ void strip_mma(float (&d)[4], const uint32_t (&w0)[SU][4],
                                          const uint32_t (&w1)[SU][4]) {
  constexpr int P = SQ ? PRO_SQUARE : PRO_IDENTITY;
#pragma unroll
  for (int k = 0; k < SU; ++k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t a[4] = {prologue_word<CD, P>(w0[k][2 * h]), prologue_word<CD, P>(w1[k][2 * h]),
                             prologue_word<CD, P>(w0[k][2 * h + 1]),
                             prologue_word<CD, P>(w1[k][2 * h + 1])};
      ones_mma<CD>(d, a);
    }
  }
}

// f32 compute: the step's values, mapped by PRO, into the thread's running
// sums of rows g (d[0]) and g + 8 (d[2]), in (u, i) order.
template <typename T, int PRO, int SU>
__device__ __forceinline__ void strip_f32(const Strip<T, SU>& st, float (&d)[4]) {
#pragma unroll
  for (int k = 0; k < SU; ++k) {
#pragma unroll
    for (int i = 0; i < RC_GROUP; ++i) {
      const float a = raw_elem(st.r0[k], i), b = raw_elem(st.r1[k], i);
      d[0] = __fadd_rn(d[0], PRO == PRO_SQUARE ? __fmul_rn(a, a) : PRO == PRO_ABS ? fabsf(a) : a);
      d[2] = __fadd_rn(d[2], PRO == PRO_SQUARE ? __fmul_rn(b, b) : PRO == PRO_ABS ? fabsf(b) : b);
    }
  }
}

// The strip's two row sums once its last step is in, in every thread of the
// row's quad: D's (ones-MMA), or the quad's f32 sums folded by the fixed
// shuffle tree of tile_row_sums.
template <int CD>
__device__ __forceinline__ float2 strip_row_sums(const float (&d)[4]) {
  if (CD != DT_F32) return make_float2(d[0], d[2]);
  float s0 = d[0], s1 = d[2];
  s0 = __fadd_rn(s0, __shfl_xor_sync(0xffffffffu, s0, 1));
  s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, 1));
  s0 = __fadd_rn(s0, __shfl_xor_sync(0xffffffffu, s0, 2));
  s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, 2));
  return make_float2(s0, s1);
}
