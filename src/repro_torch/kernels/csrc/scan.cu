// Prefix sum of a flat buffer by triangular MMAs: one launch, one tile per
// CTA over every SM, each tile's carry by a bit-exact look-back.
//
// Replaces the TPU kernel `scan_kernel` of src/repro/kernels/scan.py
// (launcher `mma_scan_pallas`). Per m x m tile X (m = 128, row-major: flat
// index p = 128 i + j), as the reference:
//
//   T1 = X @ J                 row totals
//   D[i] = T1[0] + ... + T1[i-1]   (the reference's Ls @ T1)
//   R = X @ U                  each row's running prefix (U strictly upper
//                              for the exclusive scan)
//   out = (R + D) + carry      written in the storage dtype
//
// and the tile's total, read off the corner D[127] + T1[127] (never off R),
// feeds the f32 carry c[t + 1] = c[t] + total[t], c[0] = 0: the same chain
// of f32 adds, strictly left to right, as the reference and the plain
// version.
//
// Arithmetic per tile (unchanged from the one-SM kernel it replaces, so
// the output is bitwise the same). f32 compute has no exact tensor-core
// product (TF32 keeps 10 mantissa bits): thread r adds row r left to right
// in f32, so R[i, 127] is T1[i] and the exclusive prefix is the inclusive
// one shifted, bit for bit. bf16 / f16 compute runs the products on the
// tensor cores: warp w takes row strip w of 16 rows as the A operand
// (reduce_common.cuh's element order), T1 eight m16n8k16 ones-MMAs, R 16
// column chunks of eight MMAs each, B the 0/1 triangular operand built in
// registers (exact at bf16 and f16). Every column of R chains the same
// eight products in the same order as T1, so R[:, 127] is T1 and strict-U
// column j is inclusive column j - 1, bit for bit. D is one thread's
// left-to-right fold of the 128 row totals.
//
// Schedule. A CTA draws its tile index from an atomic ticket (not from
// blockIdx), so every tile it waits on belongs to a CTA that started before
// it and never waits on it: no deadlock, whatever order the card schedules
// CTAs in. It stages its tile into shared memory once by cp.async (rows
// padded so that row-wise and fragment reads miss bank conflicts), computes
// T1, D and the total there, publishes the total, learns its carry by the
// look-back, writes the prefix over the staged tile in place and stores it
// with coalesced 16-byte writes (an f32 tile writes R + D while the
// look-back runs and adds the carry as it is stored: the same last add).
// HBM traffic: n read once, the tile-padded prefix written once, plus one
// 8-byte word per tile; no tile is re-read.
//
// The look-back keeps the bits. Tile t publishes, in one 64-bit word,
// first its total and then, once it knows c[t], its inclusive carry
// c[t + 1], each tagged by a status (total / inclusive) and the launch's
// epoch in the word's high half: one release store, read by acquire loads
// with __nanosleep backoff. Tile t reads the words of t - 1, t - 2, ... 32
// at a time (one per lane) down to the nearest inclusive carry c[k + 1],
// waiting until every word between is published, then folds the totals of
// tiles k + 1 .. t - 1 onto c[k + 1] left to right in f32. By induction on
// t every published inclusive carry is the value of the chain above,
// whichever CTA computed it: tile 0 publishes 0 + total[0] = c[1], and if
// c[k + 1] is the chain's, so is c[k + 1] + total[k + 1] + ... + total[t - 1]
// added in that order. (CUB's decoupled look-back adds aggregates of
// aggregates instead, which changes the order of the adds, and so the
// bits, from run to run.) The output is therefore bitwise the one-SM
// kernel's and the plain version's, on any run. The ticket counter is set
// back to 0 by the CTA that draws the last ticket, and the epoch, raised by
// the wrapper at every launch, retires the words of earlier launches: no
// memset launch.
//
// Bound on this card: bytes (n read once, the prefix written once; the
// MMAs and adds are far below the tensor-core and CUDA-core rates).
#include <type_traits>

#include "reduce_common.cuh"

namespace {

constexpr int SC_THREADS = 256;
constexpr int SC_WARPS = SC_THREADS / 32;  // bf16 / f16: one 16-row strip each
static_assert(SC_WARPS * 16 == RC_ROW, "one warp per 16-row strip of the tile");
constexpr int SC_LB_WINDOWS = 32;          // look-back words held: 32 x 32
constexpr unsigned SC_TOTAL = 0u, SC_INCLUSIVE = 1u;
constexpr unsigned SC_MAX_POLLS = 1u << 26;  // ~17 s of 256 ns naps

// bf16 / f16 bit patterns of 1.0 in the low half
template <int CD>
__device__ __forceinline__ uint32_t one_bits() {
  return CD == DT_BF16 ? 0x3F80u : 0x3C00u;
}

template <int CD>
__device__ __forceinline__ uint32_t pack_c(float a, float b) {
  return CD == DT_BF16 ? pack_bf16(a, b) : pack_f16(a, b);
}

template <int CD>
__device__ __forceinline__ void mma_c(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  if (CD == DT_BF16) mma_bf16_16816(d, a, b0, b1);
  else mma_f16_16816(d, a, b0, b1);
}

__device__ __forceinline__ float from_f32_as(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_f32_as(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ __half from_f32_as(float v, __half*) { return __float2half_rn(v); }

// The staged tile's row stride, in elements: a row plus 16 bytes (64 for a
// 16-bit tile read as MMA fragments), so that the eight threads of a
// 16-byte shared-memory access phase hit distinct banks.
template <typename T, int CD>
struct Layout {
  static constexpr int PAD = (sizeof(T) == 2 && CD != DT_F32) ? 64 : 16;
  static constexpr int LD = RC_ROW + PAD / static_cast<int>(sizeof(T));
  static constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // elements per 16 bytes
  static constexpr int CPR = RC_ROW / EPC;                        // 16-byte chunks per row
  static constexpr size_t TILE_BYTES = sizeof(T) * RC_ROW * LD;
  static constexpr size_t SMEM =
      TILE_BYTES + sizeof(float) * (2 * RC_ROW + SC_LB_WINDOWS * 32);
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

// A tile's word carries all that a reader takes from it (status, epoch and
// value in one 64-bit access), so relaxed device-scope accesses suffice:
// no other data is published through it.
__device__ __forceinline__ void publish(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long peek(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long word(unsigned epoch, unsigned status, float v) {
  return (static_cast<unsigned long long>(2u * epoch + status) << 32) | __float_as_uint(v);
}

// Elements [base, base + m^2) of x (zeros past n) into the padded tile.
template <typename T, int CD>
__device__ __forceinline__ void stage_in(T* tile, const T* __restrict__ x, long long base,
                                         long long n, bool aligned) {
  using L = Layout<T, CD>;
  for (int c = threadIdx.x; c < RC_ROW * L::CPR; c += SC_THREADS) {
    const int row = c / L::CPR, col = (c % L::CPR) * L::EPC;
    T* dst = tile + row * L::LD + col;
    const long long e = base + row * RC_ROW + col;
    if (aligned) {
      const long long left = n - e;
      const int valid = left >= L::EPC ? L::EPC : (left > 0 ? static_cast<int>(left) : 0);
      cp_async16(dst, valid ? x + e : x, valid * static_cast<int>(sizeof(T)));
    } else {
#pragma unroll
      for (int i = 0; i < L::EPC; ++i) dst[i] = e + i < n ? x[e + i] : from_f32_as(0.f, dst);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// The written tile to out[base, base + m^2), 16 bytes a thread, streaming
// (it is not read again here). ADD: an f32 tile of (R + D) gets the carry
// added on the way, the last add of (R + D) + carry.
template <typename T, int CD, bool ADD>
__device__ __forceinline__ void stage_out(const T* tile, T* __restrict__ out, long long base,
                                          float carry) {
  using L = Layout<T, CD>;
  for (int c = threadIdx.x; c < RC_ROW * L::CPR; c += SC_THREADS) {
    const int row = c / L::CPR, col = (c % L::CPR) * L::EPC;
    uint4 raw = *reinterpret_cast<const uint4*>(tile + row * L::LD + col);
    if constexpr (ADD) {
      float* f = reinterpret_cast<float*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) f[i] = __fadd_rn(f[i], carry);
    }
    __stcs(reinterpret_cast<uint4*>(out + base + row * RC_ROW + col), raw);
  }
}

// f32 compute, thread r < 128: row r summed left to right (EMIT: the prefix
// (R + D) + carry written over the row in place; without CARRY, R + D).
template <typename T, int CD, bool EMIT, bool CARRY = true>
__device__ __forceinline__ float row_f32(T* row, float dn, float carry, int inclusive) {
  using L = Layout<T, CD>;
  float acc = 0.f;
#pragma unroll 4
  for (int c = 0; c < L::CPR; ++c) {
    uint4 raw = *reinterpret_cast<const uint4*>(row + c * L::EPC);
    T* h = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < L::EPC; ++i) {
      const float prev = acc;
      acc = __fadd_rn(acc, to_f32(h[i]));
      if (EMIT) {
        const float rd = __fadd_rn(inclusive ? acc : prev, dn);
        h[i] = from_f32_as(CARRY ? __fadd_rn(rd, carry) : rd, h);
      }
    }
    if (EMIT) *reinterpret_cast<uint4*>(row + c * L::EPC) = raw;
  }
  return acc;
}

// Eight staged elements (16-byte aligned) as f32, by 16-byte shared loads.
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&v)[RC_GROUP]) {
#pragma unroll
  for (int c = 0; c < static_cast<int>(sizeof(T)) * RC_GROUP / 16; ++c) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
    const T* h = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i)
      v[c * (16 / static_cast<int>(sizeof(T))) + i] = to_f32(h[i]);
  }
}

// bf16 / f16 compute: row strip s (rows 16 s + g and 16 s + g + 8) of the
// staged tile as the A operand of the eight k-chunks (reduce_common.cuh's
// element order: k slots 2 t4, 2 t4 + 1 hold columns c0, c0 + 1 and slots
// 2 t4 + 8, 2 t4 + 9 hold c0 + 2, c0 + 3, c0 = 8 t4 + 32 u + 4 h).
template <typename T, int CD>
__device__ __forceinline__ void strip_a(const T* tile, int s, int g, int t4,
                                        uint32_t (&A)[8][4]) {
  using L = Layout<T, CD>;
  const T* r0 = tile + (16 * s + g) * L::LD + 8 * t4;
  const T* r1 = r0 + 8 * L::LD;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float a[RC_GROUP], b[RC_GROUP];
    load8(r0 + 32 * u, a);
    load8(r1 + 32 * u, b);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * h;
      A[2 * u + h][0] = pack_c<CD>(a[i], a[i + 1]);
      A[2 * u + h][1] = pack_c<CD>(b[i], b[i + 1]);
      A[2 * u + h][2] = pack_c<CD>(a[i + 2], a[i + 3]);
      A[2 * u + h][3] = pack_c<CD>(b[i + 2], b[i + 3]);
    }
  }
}

// bf16 / f16 compute, warp s: the strip's prefix (R + D) + carry written over
// it in place (its A fragments are already in registers; without CARRY,
// R + D). A k-chunk whose X columns all lie past the output chunk's last
// column meets only zeros of U: its MMA would add exact zeros and is
// skipped; one whose X columns all lie at or before its first column
// (before it, for the strict U) takes the all-ones B.
template <typename T, int CD, bool CARRY = true>
__device__ __forceinline__ void strip_emit(T* tile, int s, int g, int t4,
                                           const uint32_t (&A)[8][4], const float* dn,
                                           float carry, int inclusive) {
  using L = Layout<T, CD>;
  const int row0 = 16 * s + g, row1 = row0 + 8;
  const float dn0 = dn[row0], dn1 = dn[row1];
  const uint32_t ones = one_bits<CD>() | (one_bits<CD>() << 16);
  for (int nc = 0; nc < RC_ROW / 8; ++nc) {
    const int j = 8 * nc + g;  // this thread's B column
    float r[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // the k-chunk's X columns are 32 u + 4 h .. 32 u + 4 h + 27, the
        // output chunk's 8 nc .. 8 nc + 7; the branches are warp-uniform
        if (32 * u + 4 * h > 8 * nc + 7) continue;  // B all zeros
        if (inclusive ? 32 * u + 4 * h + 27 <= 8 * nc : 32 * u + 4 * h + 27 < 8 * nc) {
          mma_c<CD>(r, A[2 * u + h], ones, ones);  // B all ones
          continue;
        }
        const int c0 = 8 * t4 + 32 * u + 4 * h;
        uint32_t e[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          e[q] = (inclusive ? c0 + q <= j : c0 + q < j) ? one_bits<CD>() : 0u;
        mma_c<CD>(r, A[2 * u + h], e[0] | (e[1] << 16), e[2] | (e[3] << 16));
      }
    }
    const int col = 8 * nc + 2 * t4;
    float v[4] = {__fadd_rn(r[0], dn0), __fadd_rn(r[1], dn0), __fadd_rn(r[2], dn1),
                  __fadd_rn(r[3], dn1)};
    if (CARRY) {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = __fadd_rn(v[i], carry);
    }
    store_pair(tile + row0 * L::LD + col, v[0], v[1]);
    store_pair(tile + row1 * L::LD + col, v[2], v[3]);
  }
}

// One warp of tile t >= 1: c[t] from the nearest published inclusive carry
// and the totals after it, folded left to right (see the note at the top).
// Lane l reads the word of tile t - 1 - 32 w - l, window w = 0, 1, ... in
// turn; `held` keeps the totals taken so far, held[q] the word of tile
// t - 1 - q. Returns c[t] in lane 0.
__device__ float look_back(const unsigned long long* words, long long t, unsigned epoch,
                           float* held) {
  const int lane = threadIdx.x % 32;
  const unsigned tag_total = 2u * epoch + SC_TOTAL, tag_incl = 2u * epoch + SC_INCLUSIVE;
  unsigned polls = 0, sleep = 32;
  for (int w = 0;;) {
    const long long j = t - 1 - 32LL * w - lane;
    unsigned tag = tag_incl;  // before tile 0: the chain's start, c[0] = 0
    float v = 0.f;
    if (j >= 0) {
      const unsigned long long got = peek(words + j);
      tag = static_cast<unsigned>(got >> 32);
      v = __uint_as_float(static_cast<unsigned>(got));
    }
    const unsigned incl = __ballot_sync(0xffffffffu, tag == tag_incl);
    const unsigned ready = __ballot_sync(0xffffffffu, tag == tag_total || tag == tag_incl);
    const unsigned need = incl ? (incl & -incl) - 1u : 0xffffffffu;  // lanes before it
    if ((ready & need) != need) {
      // a word that stays unpublished for seconds means a broken protocol:
      // stop the launch with an error rather than hang the card
      if (++polls > SC_MAX_POLLS) __trap();
      __nanosleep(sleep);
      sleep = sleep < 256 ? 2 * sleep : sleep;
      continue;  // read this window again
    }
    held[32 * w + lane] = v;
    __syncwarp();
    if (incl) {
      float c = 0.f;
      if (lane == 0) {
        const int k = 32 * w + __ffs(incl) - 1;  // the inclusive carry's slot
        c = held[k];
        for (int q = k - 1; q >= 0; --q) c = __fadd_rn(c, held[q]);
      }
      return c;
    }
    // 32 totals: read the next window; when the room held runs out, the
    // carries below are still being folded: start again from t - 1
    if (++w == SC_LB_WINDOWS) w = 0;
  }
}

template <typename T, int CD>
__global__ void __launch_bounds__(SC_THREADS, 3)
scan_kernel(const T* __restrict__ x, long long n, T* __restrict__ out,
            unsigned long long* __restrict__ state, unsigned epoch, long long tiles,
            int inclusive, int aligned) {
  using L = Layout<T, CD>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  float* t1 = reinterpret_cast<float*>(smem + L::TILE_BYTES);
  float* dn = t1 + RC_ROW;
  float* held = dn + RC_ROW;
  __shared__ long long s_tile;
  __shared__ float s_total, s_carry;

  // state[0] is the ticket counter, state[1 + t] tile t's word
  unsigned long long* words = state + 1;
  if (threadIdx.x == 0) {
    const long long tk = static_cast<long long>(atomicAdd(state, 1ull));
    if (tk == tiles - 1) state[0] = 0ull;  // the last ticket: ready for the next launch
    s_tile = tk;
  }
  __syncthreads();
  const long long t = s_tile;
  const long long base = t * RC_TILE;
  stage_in<T, CD>(tile, x, base, n, aligned != 0);

  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const int g = lid / 4, t4 = lid % 4;
  uint32_t A[8][4];  // bf16 / f16: this warp's strip, kept for the emit
  if constexpr (CD == DT_F32) {
    if (threadIdx.x < RC_ROW)
      t1[threadIdx.x] = row_f32<T, CD, false>(tile + threadIdx.x * L::LD, 0.f, 0.f, 1);
  } else {
    strip_a<T, CD>(tile, warp, g, t4, A);
    const uint32_t ones = one_bits<CD>() | (one_bits<CD>() << 16);
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 8; ++k) mma_c<CD>(d, A[k], ones, ones);  // T1 = X @ J
    if (t4 == 0) {
      t1[16 * warp + g] = d[0];
      t1[16 * warp + g + 8] = d[2];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll 8
    for (int i = 0; i < RC_ROW; ++i) {
      dn[i] = total;
      total = __fadd_rn(total, t1[i]);
    }
    s_total = total;
    // tile 0 knows its carry: publish c[1] = 0 + total[0] at once
    publish(words + t, t == 0 ? word(epoch, SC_INCLUSIVE, __fadd_rn(0.f, total))
                              : word(epoch, SC_TOTAL, total));
  }
  // An f32 tile holds R + D exactly as the last add of (R + D) + carry
  // reads it, so the prefix is written before the carry is known and the
  // carry added as the tile is stored: the look-back then runs beside the
  // emit (on a warp that owns no rows at f32 compute, else before warp 0's
  // strip). A 16-bit tile rounds R + D, so it waits for the carry first.
  constexpr bool kDefer = std::is_same<T, float>::value;
  constexpr int kLookBackWarp = kDefer && CD == DT_F32 ? SC_WARPS - 1 : 0;
  if (kDefer) __syncthreads();  // D, for every emitting warp
  if (warp == kLookBackWarp) {
    __syncwarp();
    float carry = 0.f;
    if (t > 0) carry = look_back(words, t, epoch, held);
    if (lid == 0) {
      if (t > 0) publish(words + t, word(epoch, SC_INCLUSIVE, __fadd_rn(carry, s_total)));
      s_carry = carry;
    }
  }
  if (!kDefer) __syncthreads();
  if constexpr (CD == DT_F32) {
    if (threadIdx.x < RC_ROW)
      row_f32<T, CD, true, !kDefer>(tile + threadIdx.x * L::LD, dn[threadIdx.x],
                                    kDefer ? 0.f : s_carry, inclusive);
  } else {
    strip_emit<T, CD, !kDefer>(tile, warp, g, t4, A, dn, kDefer ? 0.f : s_carry, inclusive);
  }
  __syncthreads();
  stage_out<T, CD, kDefer>(tile, out, base, s_carry);
}

template <typename T, int CD>
int launch(const void* x, long long n, long long tiles, int inclusive, int aligned, void* out,
           void* state, unsigned epoch, cudaStream_t stream) {
  const size_t smem = Layout<T, CD>::SMEM;
  const cudaError_t attr = cudaFuncSetAttribute(
      scan_kernel<T, CD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  scan_kernel<T, CD><<<static_cast<unsigned>(tiles), SC_THREADS, smem, stream>>>(
      static_cast<const T*>(x), n, static_cast<T*>(out),
      static_cast<unsigned long long*>(state), epoch, tiles, inclusive, aligned);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_compute(const void* x, long long n, int compute, long long tiles, int inclusive,
               int aligned, void* out, void* state, unsigned epoch, cudaStream_t stream) {
  switch (compute) {
    case DT_F32:
      return launch<T, DT_F32>(x, n, tiles, inclusive, aligned, out, state, epoch, stream);
    case DT_BF16:
      return launch<T, DT_BF16>(x, n, tiles, inclusive, aligned, out, state, epoch, stream);
    case DT_F16:
      return launch<T, DT_F16>(x, n, tiles, inclusive, aligned, out, state, epoch, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: n elements of `dtype`, read flat; `out`: ceil(n / m^2) x m^2 elements
// of the same dtype (the tile-padded prefix); `state`: 1 + ceil(n / m^2)
// 64-bit words (the ticket counter, 0 at entry and again at exit, then one
// word per tile), kept by the caller per stream; `epoch`: 1 .. 2^31 - 1, a
// value no earlier launch on this state used since it was zeroed.
extern "C" int sc_scan(const void* x, long long n, int dtype, int compute, int inclusive,
                       int aligned, void* out, void* state, int epoch, void* stream) {
  if (n < 1 || epoch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + RC_TILE - 1) / RC_TILE;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned ep = static_cast<unsigned>(epoch);
  switch (dtype) {
    case DT_F32:
      return by_compute<float>(x, n, compute, tiles, inclusive, aligned, out, state, ep, s);
    case DT_BF16:
      return by_compute<__nv_bfloat16>(x, n, compute, tiles, inclusive, aligned, out, state,
                                       ep, s);
    case DT_F16:
      return by_compute<__half>(x, n, compute, tiles, inclusive, aligned, out, state, ep, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
