// Flash attention forward with the softmax denominator as an all-ones MMA,
// on Hopper's asynchronous tensor cores (wgmma) fed by TMA.
//
// Replaces the TPU kernel `_attn_kernel` of
// src/repro/kernels/flash_attention/kernel.py: online-softmax attention
// over streamed K/V blocks, GQA head map, causal mask, sliding window,
// q_offset, and the kv_len mask; the denominator update
// l = l * alpha + rowsum(bf16(p)) is a ones-MMA (the paper's eq. 9), as in
// the reference.
//
// Bound on this card: bytes. At the training and serving shapes (S = 512
// and 256, D = 128, causal) the q/k/v/o bytes take about twice as long as
// the causal bf16 tensor-core FLOPs; at these sizes the kernel is held by
// its latency: it has to keep the tensor cores fed while K/V stream in.
//
// Design. One CTA per (batch x head, 128-query block), the reference's
// block geometry: 128 queries, keys streamed in blocks of 128 (its block_k,
// and the paper's m). Two consumer warpgroups own 64 query rows each; one
// producer warp keeps the next K/V block loading into a ring of two
// shared-memory stages while the consumers compute (full / empty
// mbarriers per stage). bf16 inputs come by TMA (cp.async.bulk.tensor,
// 3-D tensor maps over (D, S, batch x heads) encoded on the host through
// the driver entry point, 64 x 128 boxes with the 128-byte swizzle, rows
// past S zero-filled); f16 and f32 inputs are loaded by the producer warp,
// rounded to bf16 as they are staged, into the same swizzled layout. Per
// key block a consumer warpgroup runs
//   S = Q K^T        wgmma m64n128k16, Q and K K-major in shared memory
//   mask, scale, online max, p = 2^(s - m_new) in registers
//   l = l alpha + rowsum(bf16 p)   eight m16n8k16 ones-MMAs on P's registers
//   O = O alpha + P V             wgmma m64n64k16 x 2, P from registers (the
//                                 accumulator of S re-packed as the A
//                                 fragment), V in its natural key-major
//                                 layout through the transposed descriptor
// and writes out = O / max(l, 1e-30) from registers. Blocks that no query
// of the CTA can see (future, past the window, past kv_len) are skipped
// with the reference's run test. The grid runs the heaviest causal
// q-blocks first.
//
// Numerics mirror the reference block update in base 2, as the plain
// version does: s = (bf16 q . bf16 k) * (scale * log2 e), masked to
// NEG = -1e30; m_new = max(m, rowmax s); p = 2^(s - m_new) masked to 0
// (ex2.approx, one instruction; p = e^(scale q.k - scale m_new) as in the
// reference); l = l * 2^(m - m_new) + rowsum(bf16 p);
// acc = acc * alpha + bf16(p) @ bf16(v); out = acc / max(l, 1e-30).
#include <cstring>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int FA_BQ = 128;                   // query rows per CTA
constexpr int FA_BK = 128;                   // keys per streamed block
constexpr int FA_DMAX = 128;                 // largest head dim (wider: flash_attention_wide.cu)
constexpr int FA_CWARPS = 8;                 // two consumer warpgroups
constexpr int FA_THREADS = 32 * FA_CWARPS + 32;  // + the producer warp
constexpr int FA_STAGES = 2;
constexpr float FA_NEG = -1e30f;
// A tile is 128 rows x 128 dims of bf16 as two column halves of 64 dims,
// each 128 rows x 128 bytes in the 128-byte swizzle (the TMA box).
constexpr uint32_t FA_HALF = 128 * 128;
constexpr uint32_t FA_TILE = 2 * FA_HALF;
constexpr uint32_t FA_BARS = FA_TILE * (1 + 2 * FA_STAGES);  // Q, then K and V per stage
constexpr size_t FA_SMEM = 1024 + FA_BARS + 8 * (1 + 2 * FA_STAGES);

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D += A B, A (64 x 16) from registers (the m16n8k16 A fragment of each
// warp's 16 rows), B (16 x 64) MN-major in shared memory (transposed
// descriptor), f32 accumulate.
__device__ __forceinline__ void wgmma_m64n64_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ---- staging of f16 / f32 inputs (rounded to bf16) ----
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

// Rows [row0, row0 + 128) of a (len, d) matrix into a swizzled tile by one
// warp: the 16-byte chunk c of row r of a column half lands at chunk
// c ^ (r % 8), as TMA's 128-byte swizzle puts it. Rows past len and
// columns past d are zeros.
template <typename T>
__device__ __forceinline__ void stage_tile(unsigned char* tile, const T* src, int row0, int len,
                                           int d, int lane) {
  for (int i = lane; i < 2 * 128 * 8; i += 32) {
    const int half = i / 1024, r = (i / 8) % 128, c = i % 8;
    const int col = 64 * half + 8 * c;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (row0 + r < len && col < d) load8(src + static_cast<size_t>(row0 + r) * d + col, v);
    uint4 packed;
    packed.x = pack_bf16(v[0], v[1]);
    packed.y = pack_bf16(v[2], v[3]);
    packed.z = pack_bf16(v[4], v[5]);
    packed.w = pack_bf16(v[6], v[7]);
    *reinterpret_cast<uint4*>(tile + half * FA_HALF + r * 128 + ((c ^ (r & 7)) * 16)) = packed;
  }
  // the consumers read the tile through the async proxy (wgmma)
  fence_proxy_async();
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS, 1)
attn_fwd_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
                const __grid_constant__ CUtensorMap tmv, const T* __restrict__ q,
                const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o, int sq,
                int skv, int d, int n_q_heads, int n_kv_heads, float scale_log2, int causal,
                int window, int q_offset, int kv_len) {
  constexpr bool kTma = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 1024-byte aligned: the swizzle atoms are 8 rows x 128 bytes
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t bars = base + FA_BARS;  // q_full, full[stages], empty[stages]
  const uint32_t q_full = bars;
  auto sK = [&](int s) { return base + FA_TILE * (1 + 2 * s); };
  auto sV = [&](int s) { return base + FA_TILE * (2 + 2 * s); };
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + FA_STAGES + s); };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FA_BQ;  // the heaviest causal blocks first
  const int b = bh / n_q_heads, h = bh % n_q_heads;
  const int kvh = b * n_kv_heads + h / (n_q_heads / n_kv_heads);
  const int halves = (d + 63) / 64;
  const int nkb = (skv + FA_BK - 1) / FA_BK;
  const int qpos0 = q_offset + q0;
  // the reference's run test: blocks no query of this CTA can see are skipped
  auto run = [&](int ik) {
    const int k0 = ik * FA_BK;
    bool r = k0 < kv_len;
    if (causal) r = r && (k0 <= qpos0 + FA_BQ - 1);
    if (window > 0) r = r && (qpos0 - (k0 + FA_BK - 1) < window);
    return r;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < FA_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), FA_CWARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == FA_CWARPS) {
    // ---------------- producer warp ----------------
    if constexpr (kTma) {
      if (halves == 1) {
        // d <= 64: the second column half of every tile is never loaded; the
        // consumers' MMAs run over both (a uniform instruction stream), so
        // it holds zeros
        for (int t = 0; t < 1 + 2 * FA_STAGES; ++t)
          for (int c = lane; c < static_cast<int>(FA_HALF / 16); c += 32)
            reinterpret_cast<uint4*>(smem + t * FA_TILE + FA_HALF)[c] = make_uint4(0, 0, 0, 0);
        fence_proxy_async();
        __syncwarp();
      }
      if (lane == 0) {
        mbar_expect_tx(q_full, halves * FA_BQ * 128);
        for (int hf = 0; hf < halves; ++hf)
          tma_load(sQ + hf * FA_HALF, &tmq, 64 * hf, q0, bh, q_full);
      }
    } else {
      stage_tile(smem, q + static_cast<size_t>(bh) * sq * d, q0, sq, d, lane);
      if (lane == 0) mbar_arrive(q_full);
    }
    const T* kg = k + static_cast<size_t>(kvh) * skv * d;
    const T* vg = v + static_cast<size_t>(kvh) * skv * d;
    int i = 0;
    for (int ik = 0; ik < nkb; ++ik) {
      if (!run(ik)) continue;
      const int s = i % FA_STAGES;
      mbar_wait(empty(s), ((i / FA_STAGES) & 1) ^ 1);  // a fresh barrier passes parity 1
      const int k0 = ik * FA_BK;
      if constexpr (kTma) {
        if (lane == 0) {
          mbar_expect_tx(full(s), 2 * halves * FA_HALF);
          for (int hf = 0; hf < halves; ++hf) {
            tma_load(sK(s) + hf * FA_HALF, &tmk, 64 * hf, k0, kvh, full(s));
            tma_load(sV(s) + hf * FA_HALF, &tmv, 64 * hf, k0, kvh, full(s));
          }
        }
      } else {
        stage_tile(smem + (sK(s) - base), kg, k0, skv, d, lane);
        stage_tile(smem + (sV(s) - base), vg, k0, skv, d, lane);
        if (lane == 0) mbar_arrive(full(s));
      }
      ++i;
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
  const int ra = 64 * wg + 16 * (warp % 4) + g, rb = ra + 8;  // this thread's two rows
  const int qpos_a = qpos0 + ra, qpos_b = qpos0 + rb;
  const int wq0 = qpos0 + 64 * wg;  // this warpgroup's first query position
  float acc0[32], acc1[32];  // O, head dims 0..63 and 64..127
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
  float m_a = FA_NEG, m_b = FA_NEG, l_a = 0.f, l_b = 0.f;
  const uint32_t q_rows = sQ + 64 * wg * 128;  // this warpgroup's 64 rows
  float sc[64];                                 // S of the current block
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;

  mbar_wait(q_full, 0);
  int i = 0;
  for (int ik = 0; ik < nkb; ++ik) {
    if (!run(ik)) continue;  // uniform across the CTA
    const int s = i % FA_STAGES;
    mbar_wait(full(s), (i / FA_STAGES) & 1);
    const int k0 = ik * FA_BK;

    // S = Q K^T: 64 x 128 per warpgroup, f32 (all eight k-steps: dims past
    // d are zeros in both operands)
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < FA_DMAX / 16; ++kk) {
      const uint32_t off = (kk / 4) * FA_HALF + (kk % 4) * 32;
      wgmma_m64n128_ss<0>(sc, sw128_desc(q_rows + off), sw128_desc(sK(s) + off), kk > 0);
    }
    wg_commit();
    wg_wait0();
    fence_regs(sc);

    // scale, mask, running max (accumulator element 4 j + e: row e < 2 ? a : b,
    // key 8 j + 2 t4 + (e & 1)); a block that every row of the warpgroup
    // sees whole skips the masks (the same values: nothing is masked)
    bool whole = k0 + FA_BK <= kv_len;
    if (causal) whole = whole && k0 + FA_BK - 1 <= wq0;
    if (window > 0) whole = whole && wq0 + 63 - k0 < window;
    uint64_t valid = ~0ull;
    float mx_a = FA_NEG, mx_b = FA_NEG;
    if (whole) {
#pragma unroll
      for (int j = 0; j < FA_BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sv = sc[4 * j + e] * scale_log2;
          sc[4 * j + e] = sv;
          if (e < 2) mx_a = fmaxf(mx_a, sv); else mx_b = fmaxf(mx_b, sv);
        }
      }
    } else {
      valid = 0;
#pragma unroll
      for (int j = 0; j < FA_BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t4 + (e & 1);
          const int qp = e < 2 ? qpos_a : qpos_b;
          bool ok = key < kv_len;
          if (causal) ok = ok && key <= qp;
          if (window > 0) ok = ok && (qp - key) < window;
          const float sv = ok ? sc[4 * j + e] * scale_log2 : FA_NEG;
          sc[4 * j + e] = sv;
          if (ok) valid |= 1ull << (4 * j + e);
          if (e < 2) mx_a = fmaxf(mx_a, sv); else mx_b = fmaxf(mx_b, sv);
        }
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
    uint32_t pf[FA_BK / 16][4];
#pragma unroll
    for (int j = 0; j < FA_BK / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = (valid >> (4 * j + e) & 1ull) ? ex2(sc[4 * j + e] - (e < 2 ? mn_a : mn_b)) : 0.f;
      pf[j / 2][(j & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }

    // the denominator: rowsum(bf16 p) as a ones-MMA, f32 accumulate
    float ls[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < FA_BK / 16; ++kk) mma_bf16_16816(ls, pf[kk], ONES_BF16X2, ONES_BF16X2);
    l_a = l_a * alpha_a + ls[0];
    l_b = l_b * alpha_b + ls[2];

    // O = O alpha + P V
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc0[4 * j] *= alpha_a; acc0[4 * j + 1] *= alpha_a;
      acc0[4 * j + 2] *= alpha_b; acc0[4 * j + 3] *= alpha_b;
      acc1[4 * j] *= alpha_a; acc1[4 * j + 1] *= alpha_a;
      acc1[4 * j + 2] *= alpha_b; acc1[4 * j + 3] *= alpha_b;
    }
    fence_regs(acc0);
    fence_regs(acc1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < FA_BK / 16; ++kk) {
      const uint32_t vrow = sV(s) + kk * 16 * 128;  // keys 16 kk .. 16 kk + 15
      wgmma_m64n64_rs_tb(acc0, pf[kk], sw128_desc(vrow));
      wgmma_m64n64_rs_tb(acc1, pf[kk], sw128_desc(vrow + FA_HALF));
    }
    wg_commit();
    wg_wait0();
    fence_regs(acc0);
    fence_regs(acc1);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));  // this warp is done with the stage
    m_a = mn_a;
    m_b = mn_b;
    ++i;
  }

  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  T* oa = o + (static_cast<size_t>(bh) * sq + q0 + ra) * d;
  T* ob = oa + 8 * d;
  const bool live_a = q0 + ra < sq, live_b = q0 + rb < sq;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t4;
    if (8 * j < d) {
      if (live_a) store_pair(oa + c, acc0[4 * j] / den_a, acc0[4 * j + 1] / den_a);
      if (live_b) store_pair(ob + c, acc0[4 * j + 2] / den_b, acc0[4 * j + 3] / den_b);
    }
    if (64 + 8 * j < d) {
      if (live_a) store_pair(oa + 64 + c, acc1[4 * j] / den_a, acc1[4 * j + 1] / den_a);
      if (live_b) store_pair(ob + 64 + c, acc1[4 * j + 2] / den_b, acc1[4 * j + 3] / den_b);
    }
  }
}

// The (d, rows, mats) bf16 tensor at `base` as boxes of 64 columns x
// `box_rows` rows, 128-byte swizzle, rows past `rows` zero-filled.
int encode(CUtensorMap* map, const void* base, int d, int rows, int mats, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(mats)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int sq, int skv, int d,
           int n_q_heads, int n_kv_heads, float scale_log2, int causal, int window,
           int q_offset, int kv_len, cudaStream_t stream) {
  CUtensorMap tmq, tmk, tmv;
  memset(&tmq, 0, sizeof(tmq));
  memset(&tmk, 0, sizeof(tmk));
  memset(&tmv, 0, sizeof(tmv));
  if (std::is_same<T, __nv_bfloat16>::value) {
    const int bhkv = bh / (n_q_heads / n_kv_heads);
    int err = encode(&tmq, q, d, sq, bh, FA_BQ);
    if (!err) err = encode(&tmk, k, d, skv, bhkv, FA_BK);
    if (!err) err = encode(&tmv, v, d, skv, bhkv, FA_BK);
    if (err) return err;
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      attn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(FA_SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(bh, (sq + FA_BQ - 1) / FA_BQ);
  attn_fwd_kernel<T><<<grid, FA_THREADS, FA_SMEM, stream>>>(
      tmq, tmk, tmv, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, d, n_q_heads, n_kv_heads,
      scale_log2, causal, window, q_offset, kv_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fa_forward_wide(const void* q, const void* k, const void* v, void* o, int bh,
                               int sq, int skv, int d, int n_q_heads, int n_kv_heads,
                               float scale_log2, int causal, int window, int q_offset,
                               int kv_len, int dtype, void* stream);

// q: (bh, sq, d); k, v: (bh / (n_q_heads / n_kv_heads), skv, d); o like q;
// every pointer 16-byte aligned. scale_log2 is the softmax scale times
// log2(e). window <= 0 means no window. d must be a multiple of 16, at most
// 256: past 128 the wide variant (flash_attention_wide.cu) runs.
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o, int bh,
                          int sq, int skv, int d, int n_q_heads, int n_kv_heads,
                          float scale_log2, int causal, int window, int q_offset,
                          int kv_len, int dtype, void* stream) {
  if (d > FA_DMAX)
    return fa_forward_wide(q, k, v, o, bh, sq, skv, d, n_q_heads, n_kv_heads, scale_log2,
                           causal, window, q_offset, kv_len, dtype, stream);
  if (d % 16 != 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
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
