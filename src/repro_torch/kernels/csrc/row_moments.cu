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
// become the limit. So the design keeps every row in registers between its
// one read and its one write:
//
//   * A row belongs to a group of `warps_per_row` warps of one CTA
//     (`rows_per_cta` groups a CTA). The row is cut into 16-byte chunks of
//     V = 16 / sizeof(T) elements; lane l of the group (0 <= l < 32 W)
//     holds chunks ((s * C + i) * 32 W + l) for i < C, where C <=
//     RM_MAX_CHUNKS is the host's `chunks` and s the slab (below). All C
//     loads are issued before the first use, so a 1024 x 2048 bf16 input
//     is in flight at once (1024 warps, 8 loads a lane).
//   * The statistics are ones-MMAs on the values the lane already holds:
//     a row sum does not care which A slot an element takes, so each lane
//     packs its own 8 values (one bf16/f16 chunk, two f32 chunks), rounded
//     to bf16, and their f32 squares rounded to bf16, straight into its A
//     registers; no value of x is shuffled. After the lane's MMAs (in
//     chunk order) the 16 rows of D hold 16 partial sums of the row.
//   * Fold order, fixed: each lane takes d0 + d2 (its quad's D rows g and
//     g + 8), then a butterfly over the lane bits 4, 8, 16 (the same bits in
//     every lane); where W > 1, the warp totals are added in warp order
//     0..W-1 through shared memory. Repeated launches are bitwise equal.
//   * The normalisation reads the row from registers and writes 16-byte
//     stores. RMSNorm's gamma is read once a warp, in its own dtype (f32,
//     bf16 or f16), never cast on the host: beside x where it is no wider
//     than x, after the statistics where it is (f32 gamma with bf16/f16 x
//     would hold 64 more registers across the fold).
//
// Routes (the host picks one per call, kernels/row_moments/ops.py
// `launch_plan`):
//   vector   16-byte loads and stores: x (and gamma) at a 16-byte aligned
//            base and rows of a multiple of 16 bytes;
//   element  chunks of V elements 32 columns apart (each element load of
//            a warp reads 32 adjacent columns), loaded and stored element
//            by element, masked at the end of the row: any base, any d;
//   re-read  (with either) a row longer than 16 warps x 32 lanes x 8
//            chunks (32768 bf16/f16 or 16384 f32 elements) is taken in
//            `slabs` slabs: the statistics pass over every slab, then the
//            normalisation re-reads each slab. Only such rows read x twice.
// Rows past `rows` are masked (no load, no store), not padded.
//
// Roundings follow the reference: x and the f32 square x*x are each
// rounded to bf16 before the ones-MMA; var = max(ss/d - mu^2, 0);
// rstd = 1 / sqrt(var + eps); RMSNorm's y = (x * rstd) * gamma in f32.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int RM_MAX_CHUNKS = 8;     // 16-byte chunks a lane holds
constexpr int RM_MAX_THREADS = 512;  // a CTA: 128 registers a thread

enum Route : int { ROUTE_VECTOR = 0, ROUTE_ELEMENT = 1 };  // ops.py ROUTE_*

// The bits of one element of T, and the f32 value of those bits.
template <typename T> struct Bits;
template <> struct Bits<float> {
  static __device__ __forceinline__ uint32_t of(float v) { return __float_as_uint(v); }
  static __device__ __forceinline__ float elem(uint32_t b) { return __uint_as_float(b); }
  static __device__ __forceinline__ float to_f32(uint32_t b) { return __uint_as_float(b); }
  static __device__ __forceinline__ uint32_t round(float v) { return __float_as_uint(v); }
};
template <> struct Bits<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t of(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
  static __device__ __forceinline__ __nv_bfloat16 elem(uint32_t b) {
    return __ushort_as_bfloat16(static_cast<unsigned short>(b));
  }
  static __device__ __forceinline__ float to_f32(uint32_t b) { return __uint_as_float(b << 16); }
  static __device__ __forceinline__ uint32_t round(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
template <> struct Bits<__half> {
  static __device__ __forceinline__ uint32_t of(__half v) { return __half_as_ushort(v); }
  static __device__ __forceinline__ __half elem(uint32_t b) {
    return __ushort_as_half(static_cast<unsigned short>(b));
  }
  static __device__ __forceinline__ float to_f32(uint32_t b) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
  }
  static __device__ __forceinline__ uint32_t round(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
};

// N elements of T in 32-bit words (8, 16 or 32 bytes), element e in word
// e / (4 / sizeof(T)), low half first: the layout of the row in memory.
template <typename T, int N>
struct Chunk {
  static constexpr int PER_WORD = 4 / sizeof(T);
  static constexpr int WORDS = N / PER_WORD;
  uint32_t w[WORDS];

  __device__ __forceinline__ uint32_t bits(int e) const {
    const uint32_t b = w[e / PER_WORD];
    return PER_WORD == 1 ? b : (e & 1) ? b >> 16 : b & 0xffffu;
  }
  __device__ __forceinline__ float get(int e) const { return Bits<T>::to_f32(bits(e)); }
  // elements are set in order 0..N-1
  __device__ __forceinline__ void put(int e, uint32_t b) {
    if (PER_WORD == 1) w[e] = b;
    else if (e & 1) w[e / 2] |= b << 16;
    else w[e / 2] = b;
  }
};

// Chunk c of a row: element e at column col0 + e * stride (stride 1 on the
// vector route, where a chunk lies wholly inside or outside the row).
template <int ROUTE, typename T, int N>
__device__ __forceinline__ void load_chunk(Chunk<T, N>& c, const T* row, int col0, int stride,
                                           int d) {
  constexpr int W = Chunk<T, N>::WORDS;
  if (ROUTE == ROUTE_VECTOR) {
    if (col0 < d) {
      if constexpr (W == 2) {
        const uint2 v = *reinterpret_cast<const uint2*>(row + col0);
        c.w[0] = v.x;
        c.w[1] = v.y;
      } else {
#pragma unroll
        for (int k = 0; k < W / 4; ++k) {
          const uint4 v = reinterpret_cast<const uint4*>(row + col0)[k];
          c.w[4 * k] = v.x;
          c.w[4 * k + 1] = v.y;
          c.w[4 * k + 2] = v.z;
          c.w[4 * k + 3] = v.w;
        }
      }
      return;
    }
#pragma unroll
    for (int k = 0; k < W; ++k) c.w[k] = 0u;
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int col = col0 + e * stride;
      c.put(e, col < d ? Bits<T>::of(row[col]) : 0u);
    }
  }
}

template <int ROUTE, typename T, int N>
__device__ __forceinline__ void store_chunk(T* row, const Chunk<T, N>& c, int col0, int stride,
                                            int d) {
  constexpr int W = Chunk<T, N>::WORDS;
  static_assert(W == 4, "an output chunk is 16 bytes");
  if (ROUTE == ROUTE_VECTOR) {
    if (col0 < d)
      *reinterpret_cast<uint4*>(row + col0) = make_uint4(c.w[0], c.w[1], c.w[2], c.w[3]);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int col = col0 + e * stride;
      if (col < d) row[col] = Bits<T>::elem(c.bits(e));
    }
  }
}

template <typename T, typename TG, bool LAYERNORM, int ROUTE>
__global__ void __launch_bounds__(RM_MAX_THREADS)
row_norm_kernel(const T* __restrict__ x, const TG* __restrict__ gamma, T* __restrict__ out,
                int rows, int d, int warps_per_row, int chunks, int slabs, float eps) {
  constexpr int V = 16 / sizeof(T);  // elements per chunk
  constexpr int PER_MMA = 8 / V;     // chunks per ones-MMA: 1, or 2 at f32
  // gamma no wider than x is loaded beside x; a wider one (f32 gamma with
  // bf16/f16 x: 64 registers) after the statistics
  constexpr bool GAMMA_EARLY = !LAYERNORM && sizeof(TG) <= sizeof(T);
  __shared__ float part[RM_MAX_THREADS / 32][2];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp % warps_per_row;  // the warp's place in its row group
  const int row = blockIdx.x * ((blockDim.x >> 5) / warps_per_row) + warp / warps_per_row;
  const bool valid = row < rows;
  const int group = warps_per_row * 32;  // lanes a row
  const int gl = wr * 32 + lane;
  const size_t base = static_cast<size_t>(valid ? row : 0) * d;
  const T* xr = x + base;
  T* orow = out + base;

  // Chunk c = s * chunks + i: on the vector route V adjacent columns from
  // (c * 32 W + l) * V; on the element route V columns 32 apart from
  // ((c * W + w) * V) * 32 + lane, so that each element load of a warp
  // reads 32 adjacent columns (and its addresses differ by constants).
  // Chunks past `chunks` or the row: none.
  constexpr int stride = ROUTE == ROUTE_VECTOR ? 1 : 32;
  auto first = [&](int s, int i) {
    if (!valid || i >= chunks) return d;
    const int c = s * chunks + i;
    return ROUTE == ROUTE_VECTOR ? (c * group + gl) * V : (c * warps_per_row + wr) * V * 32 + lane;
  };
  Chunk<T, V> xv[RM_MAX_CHUNKS];
  Chunk<TG, V> gv[RM_MAX_CHUNKS];
  auto load_x = [&](int s) {
#pragma unroll
    for (int i = 0; i < RM_MAX_CHUNKS; ++i) load_chunk<ROUTE>(xv[i], xr, first(s, i), stride, d);
  };
  auto load_gamma = [&](int s) {
#pragma unroll
    for (int i = 0; i < RM_MAX_CHUNKS; ++i)
      load_chunk<ROUTE>(gv[i], gamma, first(s, i), stride, d);
  };

  float acc_s[4] = {0.f, 0.f, 0.f, 0.f};
  float acc_ss[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < slabs; ++s) {
    load_x(s);
    if (GAMMA_EARLY && slabs == 1) load_gamma(0);
#pragma unroll
    for (int i = 0; i < RM_MAX_CHUNKS; i += PER_MMA) {
      if (i >= chunks) break;  // the same for the whole warp
      float f[8];
#pragma unroll
      for (int q = 0; q < PER_MMA; ++q)
#pragma unroll
        for (int e = 0; e < V; ++e) f[q * V + e] = xv[i + q].get(e);
      uint32_t Q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        Q[k] = pack_bf16(f[2 * k] * f[2 * k], f[2 * k + 1] * f[2 * k + 1]);
      mma_bf16_16816(acc_ss, Q, ONES_BF16X2, ONES_BF16X2);
      if (LAYERNORM) {
        uint32_t A[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)  // bf16 x is its own A operand
          A[k] = std::is_same<T, __nv_bfloat16>::value ? xv[i].w[k]
                                                       : pack_bf16(f[2 * k], f[2 * k + 1]);
        mma_bf16_16816(acc_s, A, ONES_BF16X2, ONES_BF16X2);
      }
    }
  }
  // The row stays in registers as loaded: no f32 copy of it is kept
  // across the fold (64 more registers at bf16).
#pragma unroll
  for (int i = 0; i < RM_MAX_CHUNKS; ++i)
#pragma unroll
    for (int k = 0; k < Chunk<T, V>::WORDS; ++k) asm volatile("" : "+r"(xv[i].w[k]));

  // every column of D holds its row's sum: d0 is D row g, d2 row g + 8
  float sum = acc_s[0] + acc_s[2], sumsq = acc_ss[0] + acc_ss[2];
#pragma unroll
  for (int m = 4; m < 32; m <<= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, m);
    sumsq += __shfl_xor_sync(0xffffffffu, sumsq, m);
  }
  if (warps_per_row > 1) {  // the same for the whole CTA
    if (lane == 0) {
      part[warp][0] = sum;
      part[warp][1] = sumsq;
    }
    __syncthreads();
    sum = 0.f;
    sumsq = 0.f;
    for (int w = warp - wr; w < warp - wr + warps_per_row; ++w) {  // warp order
      sum += part[w][0];
      sumsq += part[w][1];
    }
  }
  if (!valid) return;

  const float fd = static_cast<float>(d);
  float mu = 0.f, rstd;
  if (LAYERNORM) {
    mu = sum / fd;
    const float var = fmaxf(sumsq / fd - mu * mu, 0.f);
    rstd = 1.f / sqrtf(var + eps);
  } else {
    rstd = 1.f / sqrtf(sumsq / fd + eps);
  }

  for (int s = 0; s < slabs; ++s) {
    if (slabs > 1) load_x(s);
    if (!LAYERNORM && !(GAMMA_EARLY && slabs == 1)) load_gamma(s);
#pragma unroll
    for (int i = 0; i < RM_MAX_CHUNKS; ++i) {
      if (i >= chunks) break;
      Chunk<T, V> y;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float v = xv[i].get(e);
        y.put(e, Bits<T>::round(LAYERNORM ? (v - mu) * rstd : v * rstd * gv[i].get(e)));
      }
      store_chunk<ROUTE>(orow, y, first(s, i), stride, d);
    }
  }
}

struct Geometry {
  int rows, d, warps_per_row, rows_per_cta, chunks, slabs;
  float eps;
};

template <typename T, typename TG, bool LAYERNORM>
int launch_typed(const void* x, const void* gamma, void* out, const Geometry& g, int route,
                 cudaStream_t stream) {
  const int threads = g.rows_per_cta * g.warps_per_row * 32;
  if (g.rows < 1 || g.d < 1 || g.warps_per_row < 1 || g.rows_per_cta < 1 || g.chunks < 1 ||
      g.chunks > RM_MAX_CHUNKS || g.slabs < 1 || threads > RM_MAX_THREADS ||
      static_cast<long long>(g.slabs) * g.chunks * g.warps_per_row * 32 * (16 / sizeof(T)) <
          g.d)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((g.rows + g.rows_per_cta - 1) / g.rows_per_cta);
  const T* xt = static_cast<const T*>(x);
  const TG* gt = static_cast<const TG*>(gamma);
  T* ot = static_cast<T*>(out);
  if (route == ROUTE_VECTOR)
    row_norm_kernel<T, TG, LAYERNORM, ROUTE_VECTOR><<<grid, threads, 0, stream>>>(
        xt, gt, ot, g.rows, g.d, g.warps_per_row, g.chunks, g.slabs, g.eps);
  else if (route == ROUTE_ELEMENT)
    row_norm_kernel<T, TG, LAYERNORM, ROUTE_ELEMENT><<<grid, threads, 0, stream>>>(
        xt, gt, ot, g.rows, g.d, g.warps_per_row, g.chunks, g.slabs, g.eps);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool LAYERNORM>
int launch_gamma(const void* x, const void* gamma, void* out, const Geometry& g, int route,
                 int gamma_dtype, cudaStream_t stream) {
  switch (gamma_dtype) {
    case DT_F32: return launch_typed<T, float, LAYERNORM>(x, gamma, out, g, route, stream);
    case DT_BF16:
      return launch_typed<T, __nv_bfloat16, LAYERNORM>(x, gamma, out, g, route, stream);
    case DT_F16: return launch_typed<T, __half, LAYERNORM>(x, gamma, out, g, route, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool LAYERNORM>
int launch(const void* x, const void* gamma, void* out, const Geometry& g, int dtype,
           int gamma_dtype, int route, cudaStream_t stream) {
  // LayerNorm has no gamma: its kernels are instantiated once, with an
  // unused f32 gamma type
  switch (dtype) {
    case DT_F32:
      return LAYERNORM ? launch_typed<float, float, true>(x, gamma, out, g, route, stream)
                       : launch_gamma<float, false>(x, gamma, out, g, route, gamma_dtype, stream);
    case DT_BF16:
      return LAYERNORM
                 ? launch_typed<__nv_bfloat16, float, true>(x, gamma, out, g, route, stream)
                 : launch_gamma<__nv_bfloat16, false>(x, gamma, out, g, route, gamma_dtype,
                                                      stream);
    case DT_F16:
      return LAYERNORM ? launch_typed<__half, float, true>(x, gamma, out, g, route, stream)
                       : launch_gamma<__half, false>(x, gamma, out, g, route, gamma_dtype, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int rm_layernorm_np(const void* x, void* out, int rows, int d, float eps, int dtype,
                               int route, int warps_per_row, int rows_per_cta, int chunks,
                               int slabs, void* stream) {
  const Geometry g{rows, d, warps_per_row, rows_per_cta, chunks, slabs, eps};
  return launch<true>(x, nullptr, out, g, dtype, DT_F32, route,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int rm_rmsnorm(const void* x, const void* gamma, void* out, int rows, int d,
                          float eps, int dtype, int gamma_dtype, int route, int warps_per_row,
                          int rows_per_cta, int chunks, int slabs, void* stream) {
  const Geometry g{rows, d, warps_per_row, rows_per_cta, chunks, slabs, eps};
  return launch<false>(x, gamma, out, g, dtype, gamma_dtype, route,
                       static_cast<cudaStream_t>(stream));
}
