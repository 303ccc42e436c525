// Flash attention forward for head widths 128 < d <= 256 (K6's wide
// variant), with the softmax denominator as an all-ones MMA, on Hopper's
// asynchronous tensor cores (wgmma) fed by TMA.
//
// Replaces the same TPU kernel as flash_attention.cu: `_attn_kernel` of
// src/repro/kernels/flash_attention/kernel.py (launched at its line 165),
// which takes any head width; recurrentgemma-9b's heads are 256 wide.
// flash_attention.cu's `fa_forward` hands every d > 128 to
// `fa_forward_wide` below.
//
// Why a second kernel: at d = 256 the 128 x 128 blocks of
// flash_attention.cu do not fit. Its Q tile and two stages of K and V take
// 320 KB of shared memory (the card has 227 KB a CTA), and a 64 x 128 S
// accumulator beside the 64 x 256 f32 output accumulator is 192 registers
// a thread before P.
//
// Bound on this card, at recurrentgemma-9b's 16 query heads on one kv head
// of 256, bf16, causal (PERF.md): operations at the ring case's prefill (4
// x 2304 tokens, window 2048: 168 M visible pairs, 176 us of tensor-core
// work against 38 us of bytes); bytes at the training shape (4 x 512:
// 10.6 us) and at the serving prefill (4 x 256: 5.3 us), where the grid
// is one or two waves of CTAs and each CTA's latency holds the kernel.
//
// Design. One CTA of three warpgroups per (batch x head, 128-query block):
// two consumer warpgroups own 64 query rows each, and a producer
// warpgroup keeps K and V loading (`setmaxnreg` moves registers from the
// producer, 40 a thread, to the consumers, 232: the 64 x 256 f32 output
// accumulator alone is 128 a thread). Keys stream in blocks of 64 (the
// plain version's block_k, ops.blocks_for) through two stages; K and V of
// a stage have their own full and empty mbarriers, so a stage's K is
// refilled as soon as both warpgroups have taken S from it, while P V still
// reads its V. Tiles are bf16 in the 128-byte swizzle, as column slabs of
// 64 (128 bytes a row): Q is 128 x 256 (64 KB), a K or V stage 64 x 256
// (32 KB each); with two stages, 192 KB of the 227 KB. bf16 inputs come
// by TMA (cp.async.bulk.tensor, 3-D tensor maps over (d, S, batch x heads)
// encoded on the host, 64-column boxes, rows past S zero-filled by TMA);
// f16 and f32 inputs are loaded by the producer warpgroup, rounded to bf16
// as they are staged, into the same layout. Slabs wholly past d are zeroed
// once and never loaded; TMA zero-fills the columns past d of the slab
// that d ends in. Every MMA runs over all 256 columns: no wgmma sits under
// a runtime condition (that makes ptxas serialize them all). Per key block
// a consumer warpgroup runs
//   S = Q K^T        wgmma m64n64k16 x 16, Q and K K-major in shared memory
//   mask, scale, online max, p = 2^(s - m_new) in registers
//   l = l alpha + rowsum(bf16 p)   four m16n8k16 ones-MMAs on P's registers
//   O = O alpha + P V             wgmma m64n256k16 x 4, P from registers (the
//                                 accumulator of S re-packed as the A
//                                 fragment), V in its natural key-major
//                                 layout through the transposed descriptor,
//                                 whose leading offset steps between the
//                                 four 64-column slabs
// and writes out = O / max(l, 1e-30) from registers, the first d columns.
// Blocks that no query of the CTA can see (future, past the window, past
// kv_len) are skipped with the reference's run test, and the grid runs the
// heaviest causal q-blocks first.
//
// Registers and spills (ptxas -v, sm_90a, CUDA 12.9; tools/attn_probe.py
// prints them): 168 registers a thread at launch, 232 in the consumers and
// 40 in the producer by setmaxnreg, 0 bytes of spills in each of the f32,
// bf16 and f16 instantiations, no C75xx note. The waits give up after
// seconds rather than trap (`wait_or_give_up`): with a trap ptxas gave
// every region 168 registers, spilled ~800 bytes and serialized the
// wgmmas.
//
// Numerics: those of flash_attention.cu and of the plain version with
// block_q = 128, block_k = 64 (ops.blocks_for), in the same order: s =
// (bf16 q . bf16 k) * (scale * log2 e), masked to -1e30; m_new = max(m,
// rowmax s); p = 2^(s - m_new) masked to 0; l = l 2^(m - m_new) +
// rowsum(bf16 p); acc = acc alpha + bf16(p) @ bf16(v); out = acc /
// max(l, 1e-30).
#include <cstring>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int FW_BQ = 128;                      // query rows per CTA, 64 a consumer warpgroup
constexpr int FW_BK = 64;                       // keys per streamed block
constexpr int FW_DMAX = 256;                    // widest head: every MMA runs over it
constexpr int FW_SLABS = FW_DMAX / 64;          // 64-column slabs of a tile
constexpr int FW_CONSUMERS = 256;               // two consumer warpgroups
constexpr int FW_THREADS = FW_CONSUMERS + 128;  // + the producer warpgroup
constexpr int FW_STAGES = 2;
constexpr float FW_NEG = -1e30f;
constexpr uint32_t FW_QSLAB = FW_BQ * 128;         // 16 KB: 128 rows x 64 columns of bf16
constexpr uint32_t FW_KSLAB = FW_BK * 128;         // 8 KB
constexpr uint32_t FW_QTILE = FW_SLABS * FW_QSLAB;  // 64 KB
constexpr uint32_t FW_KTILE = FW_SLABS * FW_KSLAB;  // 32 KB, a K or a V tile
constexpr uint32_t FW_BARS = FW_QTILE + 2 * FW_STAGES * FW_KTILE;  // Q, then K and V a stage
constexpr int FW_NBARS = 1 + 4 * FW_STAGES;  // q_full; k_full, v_full, k_empty, v_empty a stage
constexpr size_t FW_SMEM = 1024 + FW_BARS + 8 * FW_NBARS;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D (+)= A B, A (64 x 16) and B (16 x 64) both K-major in shared memory
// (descriptors), f32 accumulate; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D += A B, A (64 x 16) from registers (the m16n8k16 A fragment of each
// warp's 16 rows), B (16 x 256) MN-major in shared memory (transposed
// descriptor: four 64-column atoms, the leading offset their step), f32
// accumulate.
__device__ __forceinline__ void wgmma_m64n256_rs_tb(float (&d)[128], const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}
// hopper.cuh's mbar_wait traps after seconds of waiting. Here a trap's
// exit path makes ptxas drop the setmaxnreg budgets (every region then
// gets the launch's 168 registers: the consumers spilled ~800 bytes and ran
// 2.2x slower). So a wait of seconds gives up for good instead: every
// later wait of the thread returns at once and the kernel ends, with
// wrong output that the checks against the plain version catch, rather
// than hang the card.
__device__ __forceinline__ void wait_or_give_up(uint32_t bar, uint32_t parity, bool& gave_up) {
  if (gave_up || mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > 4000000000ull) {
      gave_up = true;
      return;
    }
  }
}

// ---- staging of f16 / f32 inputs (rounded to bf16) ----
// One 16-byte load rounded to bf16: 8 f16 values into 16 bytes, 4 f32
// values into 8 (the producer's 40 registers hold no more).
__device__ __forceinline__ uint2 load_bf16(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  return make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
}
__device__ __forceinline__ uint4 load_bf16(const __half* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __half* h = reinterpret_cast<const __half*>(&raw);
  return make_uint4(pack_bf16(to_f32(h[0]), to_f32(h[1])), pack_bf16(to_f32(h[2]), to_f32(h[3])),
                    pack_bf16(to_f32(h[4]), to_f32(h[5])), pack_bf16(to_f32(h[6]), to_f32(h[7])));
}

// Rows [row0, row0 + ROWS) of a (len, d) matrix into a tile of four
// swizzled slabs by the producer warpgroup: the 16-byte chunk c of row r
// of a slab lands at chunk c ^ (r % 8), as TMA's 128-byte swizzle puts it.
// Rows past len and columns past d are zeros.
template <int ROWS, typename T>
__device__ __forceinline__ void stage_tile(unsigned char* tile, const T* src, int row0, int len,
                                           int d, int ptid) {
  constexpr int kPer = 16 / sizeof(T);  // values a load: 4 (f32) or 8 (f16)
  constexpr int kLoads = 64 / kPer;     // loads a row of a slab
  for (int i = ptid; i < FW_SLABS * ROWS * kLoads; i += 128) {
    const int slab = i / (ROWS * kLoads), r = (i / kLoads) % ROWS, col = kPer * (i % kLoads);
    unsigned char* dst =
        tile + slab * ROWS * 128 + r * 128 + (((col / 8) ^ (r & 7)) * 16) + (col % 8) * 2;
    const bool ok = row0 + r < len && 64 * slab + col < d;
    const T* at = src + static_cast<size_t>(row0 + r) * d + 64 * slab + col;
    decltype(load_bf16(src)) packed = {};
    if (ok) packed = load_bf16(at);
    *reinterpret_cast<decltype(packed)*>(dst) = packed;
  }
  // the consumers read the tile through the async proxy (wgmma)
  fence_proxy_async();
  named_bar_sync(1, 128);
}

template <typename T>
__global__ void __launch_bounds__(FW_THREADS, 1)
attn_fwd_wide_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
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
  auto sK = [&](int s) { return base + FW_QTILE + FW_KTILE * (2 * s); };
  auto sV = [&](int s) { return base + FW_QTILE + FW_KTILE * (2 * s + 1); };
  const uint32_t bars = base + FW_BARS;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + FW_STAGES + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + 2 * FW_STAGES + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * FW_STAGES + s); };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FW_BQ;  // the heaviest causal blocks first
  const int b = bh / n_q_heads, h = bh % n_q_heads;
  const int kvh = b * n_kv_heads + h / (n_q_heads / n_kv_heads);
  const int slabs = (d + 63) / 64;  // slabs that hold columns below d
  const int nkb = (skv + FW_BK - 1) / FW_BK;
  const int qpos0 = q_offset + q0;
  // the reference's run test: blocks no query of this CTA can see are skipped
  auto run = [&](int ik) {
    const int k0 = ik * FW_BK;
    bool r = k0 < kv_len;
    if (causal) r = r && (k0 <= qpos0 + FW_BQ - 1);
    if (window > 0) r = r && (qpos0 - (k0 + FW_BK - 1) < window);
    return r;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), FW_CONSUMERS / 32);  // one arrival per consumer warp
      mbar_init(v_empty(s), FW_CONSUMERS / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= FW_CONSUMERS) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int ptid = threadIdx.x - FW_CONSUMERS;
    bool gave_up = false;
    if constexpr (kTma) {
      if (slabs < FW_SLABS) {
        // slabs wholly past d are never loaded: zeros, written once (the
        // consumers' MMAs run over all four)
        for (int t = 0; t < 1 + 2 * FW_STAGES; ++t) {
          const uint32_t tile = t == 0 ? 0u : FW_QTILE + (t - 1) * FW_KTILE;
          const uint32_t slab = t == 0 ? FW_QSLAB : FW_KSLAB;
          uint4* z = reinterpret_cast<uint4*>(smem + tile + slabs * slab);
          for (int c = ptid; c < static_cast<int>((FW_SLABS - slabs) * slab / 16); c += 128)
            z[c] = make_uint4(0, 0, 0, 0);
        }
        fence_proxy_async();
        named_bar_sync(1, 128);
      }
      if (ptid != 0) return;  // one thread issues every load
      mbar_expect_tx(q_full, slabs * FW_QSLAB);
      for (int sl = 0; sl < slabs; ++sl) tma_load(sQ + sl * FW_QSLAB, &tmq, 64 * sl, q0, bh, q_full);
    } else {
      stage_tile<FW_BQ>(smem, q + static_cast<size_t>(bh) * sq * d, q0, sq, d, ptid);
      if (ptid == 0) mbar_arrive(q_full);
    }
    const T* kg = k + static_cast<size_t>(kvh) * skv * d;
    const T* vg = v + static_cast<size_t>(kvh) * skv * d;
    int i = 0;
    for (int ik = 0; ik < nkb; ++ik) {
      if (!run(ik)) continue;
      const int s = i % FW_STAGES;
      const uint32_t ph = ((i / FW_STAGES) & 1) ^ 1;  // a fresh barrier passes parity 1
      const int k0 = ik * FW_BK;
      if constexpr (kTma) {
        wait_or_give_up(k_empty(s), ph, gave_up);
        mbar_expect_tx(k_full(s), slabs * FW_KSLAB);
        for (int sl = 0; sl < slabs; ++sl)
          tma_load(sK(s) + sl * FW_KSLAB, &tmk, 64 * sl, k0, kvh, k_full(s));
        wait_or_give_up(v_empty(s), ph, gave_up);
        mbar_expect_tx(v_full(s), slabs * FW_KSLAB);
        for (int sl = 0; sl < slabs; ++sl)
          tma_load(sV(s) + sl * FW_KSLAB, &tmv, 64 * sl, k0, kvh, v_full(s));
      } else {
        wait_or_give_up(k_empty(s), ph, gave_up);
        stage_tile<FW_BK>(smem + (sK(s) - base), kg, k0, skv, d, ptid);
        if (ptid == 0) mbar_arrive(k_full(s));
        wait_or_give_up(v_empty(s), ph, gave_up);
        stage_tile<FW_BK>(smem + (sV(s) - base), vg, k0, skv, d, ptid);
        if (ptid == 0) mbar_arrive(v_full(s));
      }
      ++i;
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
  const int ra = 64 * wg + 16 * (warp % 4) + g, rb = ra + 8;  // this thread's two rows
  const int qpos_a = qpos0 + ra, qpos_b = qpos0 + rb;
  const int wq0 = qpos0 + 64 * wg;  // this warpgroup's first query position
  float acc[128];                   // O, 64 rows x 256 columns a warpgroup
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float sc[32];  // S of the current block, 64 rows x 64 keys a warpgroup
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  float m_a = FW_NEG, m_b = FW_NEG, l_a = 0.f, l_b = 0.f;
  // descriptors built once and advanced by adds (16-byte units): this
  // warpgroup's 64 rows of Q, and stage 0's K and V
  const uint64_t q_desc = sw128_desc(sQ + 64 * wg * 128);
  const uint64_t k_desc = sw128_desc(sK(0));
  const uint64_t v_desc = sw128_desc(sV(0), FW_KSLAB, 1024);
  constexpr uint64_t kStage = 2 * FW_KTILE / 16;
  auto release = [&](uint32_t bar) {  // this warp is done with the tile
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  bool gave_up = false;
  wait_or_give_up(q_full, 0, gave_up);
  int i = 0;
  for (int ik = 0; ik < nkb; ++ik) {
    if (!run(ik)) continue;  // uniform across the CTA
    const int s = i % FW_STAGES;
    const uint32_t ph = (i / FW_STAGES) & 1;
    const int k0 = ik * FW_BK;
    const uint64_t st = static_cast<uint64_t>(s) * kStage;

    // S = Q K^T: 64 x 64 per warpgroup, f32, over all 16 k-steps (columns
    // past d are zeros in both operands)
    wait_or_give_up(k_full(s), ph, gave_up);
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < FW_DMAX / 16; ++kk)
      wgmma_m64n64_ss(sc, q_desc + ((kk / 4) * FW_QSLAB + (kk % 4) * 32) / 16,
                      k_desc + st + ((kk / 4) * FW_KSLAB + (kk % 4) * 32) / 16, kk > 0);
    wg_commit();
    wg_wait0();
    fence_regs(sc);
    release(k_empty(s));

    // scale, mask, running max (accumulator element 4 j + e: row e < 2 ? a : b,
    // key 8 j + 2 t4 + (e & 1)); a block that every row of the warpgroup
    // sees whole skips the masks (the same values: nothing is masked)
    bool whole = k0 + FW_BK <= kv_len;
    if (causal) whole = whole && k0 + FW_BK - 1 <= wq0;
    if (window > 0) whole = whole && wq0 + 63 - k0 < window;
    uint32_t valid = ~0u;
    float mx_a = FW_NEG, mx_b = FW_NEG;
    if (whole) {
#pragma unroll
      for (int j = 0; j < FW_BK / 8; ++j) {
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
      for (int j = 0; j < FW_BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t4 + (e & 1);
          const int qp = e < 2 ? qpos_a : qpos_b;
          bool ok = key < kv_len;
          if (causal) ok = ok && key <= qp;
          if (window > 0) ok = ok && (qp - key) < window;
          const float sv = ok ? sc[4 * j + e] * scale_log2 : FW_NEG;
          sc[4 * j + e] = sv;
          if (ok) valid |= 1u << (4 * j + e);
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
    uint32_t pf[FW_BK / 16][4];
#pragma unroll
    for (int j = 0; j < FW_BK / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = (valid >> (4 * j + e) & 1u) ? ex2(sc[4 * j + e] - (e < 2 ? mn_a : mn_b)) : 0.f;
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
      acc[4 * j] *= alpha_a; acc[4 * j + 1] *= alpha_a;
      acc[4 * j + 2] *= alpha_b; acc[4 * j + 3] *= alpha_b;
    }
    wait_or_give_up(v_full(s), ph, gave_up);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < FW_BK / 16; ++kk)  // keys 16 kk .. 16 kk + 15
      wgmma_m64n256_rs_tb(acc, pf[kk], v_desc + st + kk * 16 * 128 / 16);
    wg_commit();
    wg_wait0();
    fence_regs(acc);
    release(v_empty(s));
    m_a = mn_a;
    m_b = mn_b;
    ++i;
  }

  // out = O / max(l, 1e-30) as O times the reciprocal (rcp.approx: no
  // call to the division's slow path in this region of 232 registers)
  const float inv_a = rcp(fmaxf(l_a, 1e-30f)), inv_b = rcp(fmaxf(l_b, 1e-30f));
  T* oa = o + (static_cast<size_t>(bh) * sq + q0 + ra) * d;
  T* ob = oa + 8 * static_cast<size_t>(d);
  const bool live_a = q0 + ra < sq, live_b = q0 + rb < sq;
#pragma unroll
  for (int j = 0; j < FW_DMAX / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    if (8 * j < d) {
      if (live_a) store_pair(oa + c, acc[4 * j] * inv_a, acc[4 * j + 1] * inv_a);
      if (live_b) store_pair(ob + c, acc[4 * j + 2] * inv_b, acc[4 * j + 3] * inv_b);
    }
  }
}

// The (d, rows, mats) bf16 tensor at `base` as boxes of 64 columns x
// `box_rows` rows, 128-byte swizzle; rows past `rows` and columns past d
// read as zeros.
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
    int err = encode(&tmq, q, d, sq, bh, FW_BQ);
    if (!err) err = encode(&tmk, k, d, skv, bhkv, FW_BK);
    if (!err) err = encode(&tmv, v, d, skv, bhkv, FW_BK);
    if (err) return err;
  }
  const cudaError_t attr =
      cudaFuncSetAttribute(attn_fwd_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(FW_SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(bh, (sq + FW_BQ - 1) / FW_BQ);
  attn_fwd_wide_kernel<T><<<grid, FW_THREADS, FW_SMEM, stream>>>(
      tmq, tmk, tmv, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, d, n_q_heads, n_kv_heads,
      scale_log2, causal, window, q_offset, kv_len);
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
