// Multi-part reduction: S separate arrays -> per-part totals, K epilogue
// chains of the cross-part total, and a NaN/Inf census, in one launch.
//
// Replaces the TPU kernel `parts_accumulate_kernel` of
// src/repro/kernels/mma_reduce/kernel.py (launcher `reduce_parts`). The
// output row is the reference's: [S part totals][K chains][S counts][1
// total count], or [S sums][S sums of squares] when a part carries the
// moments prologue (its square slot; other parts leave theirs 0). Empty
// parts keep 0 in their slots.
//
// Bound on this card: bytes, and at the serving size (4 parts of 50304
// f32 logits, 0.8 MB) launch latency.
//
// Design: a by-value table of (pointer, size, dtype, prologue, output slot,
// tile run) for up to 128 live parts, so no part is copied or packed. One
// CTA per (part, 16384-element tile) -- the reference's m^2 tile -- writes a
// partial sum (and, for a moments part, a partial sum of squares) and a
// partial non-finite count. The CTA switches once on its part's dtype and
// reads the tile in 16-byte groups (`load_group`): warp w owns tile rows
// 16w .. 16w + 15, thread (g, t) the elements 8t + 32u + i of rows g and
// g + 8. Each value is cast to the compute dtype, counted if non-finite
// (before the prologue, as the reference does) and mapped by the prologue
// there. f32 compute has no exact tensor-core product (TF32 keeps 10
// mantissa bits), so it sums on the CUDA cores (reduce_common.cuh
// `tile_row_sums`: each thread's 32 in order, then the row's quad); bf16 /
// f16 compute is the ones-MMA of eq. 9 (m16n8k16 MMAs with f32
// accumulation). The 128 row sums fold in the fixed order of `block_fold`
// (ops.fold_rows_plain).
//
// The fold is deterministic and uses no float atomics. Each CTA publishes
// its partials and takes its part's integer ticket; the part's last CTA
// folds the part: its 256 threads stage the part's tile partials into
// shared memory with coalesced loads, 1024 tiles at a time, and one thread
// adds them in tile order (sums, squares and counts as three independent
// chains). So a part's fold overlaps the streaming of the parts after it,
// and the tickets spread over up to 128 counters. The part's folding CTA
// then publishes the raw part total and takes the grid ticket; the last of
// those maps each part total by the slot chain, folds the raw part totals
// in part order, and writes the row with the total chains applied -- the
// order of ops.mma_sum_parts_plain, so at bf16 / f16 compute the row is
// bitwise that version's fold of the same tile partials. The tickets live
// in a buffer the caller zeroes once and keeps; each last CTA sets its
// counter back to 0, so the next launch on the stream finds them zeroed
// and the partials need no clearing. One kernel launch per call.
#include "reduce_common.cuh"

namespace {

constexpr int PR_MAX_PARTS = 128;   // ops.PARTS_KERNEL_MAX
constexpr int PR_TILE = 128 * 128;  // the reference's m^2 tile
constexpr int PR_THREADS = 256;
constexpr int PR_WARPS = PR_THREADS / 32;
constexpr int PR_MAX_CHAINS = 4;
constexpr int PR_MAX_STEPS = 4;
constexpr int PR_FOLD_CHUNK = 1024;  // tile partials staged per pass of a part's fold

struct PartsTable {
  const void* ptr[PR_MAX_PARTS];
  long long size[PR_MAX_PARTS];
  int start[PR_MAX_PARTS + 1];  // live part i owns tiles [start[i], start[i+1])
  int seg[PR_MAX_PARTS];        // output slot of live part i
  unsigned char dtype[PR_MAX_PARTS];
  unsigned char prologue[PR_MAX_PARTS];
  int n_live, n_seg, n_chains, census, dual;
  int chain_len[PR_MAX_CHAINS + 1];  // the K total chains, then the slot chain
  int op[PR_MAX_CHAINS + 1][PR_MAX_STEPS];
  float p0[PR_MAX_CHAINS + 1][PR_MAX_STEPS];
  float p1[PR_MAX_CHAINS + 1][PR_MAX_STEPS];
};

constexpr int SLOT_CHAIN = PR_MAX_CHAINS;

__device__ float apply_chain(float t, const PartsTable& tab, int k) {
  for (int s = 0; s < tab.chain_len[k]; ++s)
    t = epilogue_step(t, tab.op[k][s], tab.p0[k][s], tab.p1[k][s]);
  return t;
}

// The fixed fold of one tile's 128 row values (ops.fold_rows_plain): the
// leader of quad g in warp w holds rows 16w + g (`a`) and 16w + g + 8 (`b`).
// Returns the total in thread 0; uses `warp_buf` and two barriers.
__device__ __forceinline__ float block_fold(float a, float b, float* warp_buf) {
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  float v = (lid & 3) == 0 ? a + b : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lid == 0) warp_buf[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < PR_WARPS; ++w) total += warp_buf[w];
  __syncthreads();
  return total;
}

// One tile of a part of dtype T: its (sum, sum of squares, non-finite
// count) in thread 0. A moments part also sums its squares; other parts
// leave `sq` 0.
template <int CD, typename T>
__device__ __forceinline__ void tile_pass(const T* __restrict__ src, long long base, int n,
                                          int pro, float& sum, float& sq, int& cnt,
                                          float* warp_sum, float* warp_sq, int* warp_cnt) {
  const bool moments = pro == PRO_MOMENTS;
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const int g = lid / 4, t4 = lid % 4;
  const long long row0 = base + static_cast<long long>(16 * warp + g) * RC_ROW;
  const long long row1 = row0 + 8 * RC_ROW;
  const long long end = base + n;
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  float r0[4][RC_GROUP], r1[4][RC_GROUP];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    load_group(src, row0 + 8 * t4 + 32 * u, end, aligned, r0[u]);
    load_group(src, row1 + 8 * t4 + 32 * u, end, aligned, r1[u]);
  }
  cnt = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int i = 0; i < RC_GROUP; ++i) {
      const float c0 = to_compute<CD>(r0[u][i]), c1 = to_compute<CD>(r1[u][i]);
      cnt += (isfinite(c0) ? 0 : 1) + (isfinite(c1) ? 0 : 1);
      r0[u][i] = moments ? c0 : prologue_map<CD>(c0, pro);
      r1[u][i] = moments ? c1 : prologue_map<CD>(c1, pro);
    }
  }
  const float2 d = tile_row_sums<CD>(r0, r1);
  sum = block_fold(d.x, d.y, warp_sum);
  sq = 0.f;
  if (moments) {  // one part per CTA: the branch, its MMAs and barriers are CTA-uniform
    const float2 d2 = tile_row_sums<CD, true>(r0, r1);
    sq = block_fold(d2.x, d2.y, warp_sq);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  if (lid == 0) warp_cnt[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    cnt = 0;
    for (int w = 0; w < PR_WARPS; ++w) cnt += warp_cnt[w];
  }
}

// scratch: n_tiles tile sums, tile squares and tile counts (int), then,
// from an even word, PR_MAX_PARTS part sums and part squares (float) and
// part counts (long long). tickets: PR_MAX_PARTS part counters, then the
// grid's.
template <int CD>
__global__ void __launch_bounds__(PR_THREADS)
parts_kernel(const PartsTable tab, float* __restrict__ out, float* __restrict__ tile_sum,
             float* __restrict__ tile_sq, int* __restrict__ tile_cnt,
             float* __restrict__ part_sum, float* __restrict__ part_sq,
             long long* __restrict__ part_cnt, unsigned int* __restrict__ tickets) {
  __shared__ float warp_sum[PR_WARPS];
  __shared__ float warp_sq[PR_WARPS];
  __shared__ int warp_cnt[PR_WARPS];
  __shared__ float st_sum[PR_FOLD_CHUNK];
  __shared__ float st_sq[PR_FOLD_CHUNK];
  __shared__ int st_cnt[PR_FOLD_CHUNK];
  __shared__ bool am_last;

  const int tile = blockIdx.x;
  int lo = 0, hi = tab.n_live - 1;  // the live part owning this tile
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tab.start[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  const int part = lo;
  const long long base = static_cast<long long>(tile - tab.start[part]) * PR_TILE;
  const long long left = tab.size[part] - base;  // ragged tail of THIS part
  const int n = left < PR_TILE ? static_cast<int>(left) : PR_TILE;
  const int pro = tab.prologue[part];

  float sum, sq;
  int cnt;
  switch (tab.dtype[part]) {  // CTA-uniform
    case DT_BF16:
      tile_pass<CD>(static_cast<const __nv_bfloat16*>(tab.ptr[part]), base, n, pro, sum, sq, cnt,
                    warp_sum, warp_sq, warp_cnt);
      break;
    case DT_F16:
      tile_pass<CD>(static_cast<const __half*>(tab.ptr[part]), base, n, pro, sum, sq, cnt,
                    warp_sum, warp_sq, warp_cnt);
      break;
    default:
      tile_pass<CD>(static_cast<const float*>(tab.ptr[part]), base, n, pro, sum, sq, cnt,
                    warp_sum, warp_sq, warp_cnt);
  }
  const int t0 = tab.start[part], t1 = tab.start[part + 1];
  if (threadIdx.x == 0) {
    tile_sum[tile] = sum;
    tile_sq[tile] = sq;
    tile_cnt[tile] = cnt;
    __threadfence();  // publish the partials before taking the part's ticket
    am_last = atomicAdd(tickets + part, 1u) == static_cast<unsigned int>(t1 - t0 - 1);
    // every other CTA of the part has taken its ticket: reset it for the next launch
    if (am_last) tickets[part] = 0u;
  }
  __syncthreads();
  if (!am_last) return;

  // The part's last CTA folds the part's tiles in tile order.
  __threadfence();
  float ps = 0.f, ps2 = 0.f;
  long long pc = 0;
  for (int c0 = t0; c0 < t1; c0 += PR_FOLD_CHUNK) {  // CTA-uniform trip count
    const int len = min(PR_FOLD_CHUNK, t1 - c0);
    for (int i = threadIdx.x; i < len; i += PR_THREADS) {
      st_sum[i] = __ldcg(tile_sum + c0 + i);
      st_sq[i] = __ldcg(tile_sq + c0 + i);
      st_cnt[i] = __ldcg(tile_cnt + c0 + i);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll 8
      for (int i = 0; i < len; ++i) {
        ps += st_sum[i];
        ps2 += st_sq[i];
        pc += st_cnt[i];
      }
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  part_sum[part] = ps;
  part_sq[part] = ps2;
  part_cnt[part] = pc;
  __threadfence();  // publish the part total before taking the grid ticket
  const unsigned int grid_ticket = atomicAdd(tickets + PR_MAX_PARTS, 1u);
  if (grid_ticket != static_cast<unsigned int>(tab.n_live - 1)) return;
  tickets[PR_MAX_PARTS] = 0u;  // every part's folder has taken its ticket

  // The last part folder writes the row: part totals in part order.
  __threadfence();
  const int out_slots = tab.dual ? 2 * tab.n_seg : tab.n_seg;
  const int n_out = out_slots + tab.n_chains + (tab.census ? tab.n_seg + 1 : 0);
  for (int s = 0; s < n_out; ++s) out[s] = 0.f;
  const int cbase = out_slots + tab.n_chains;
  float total = 0.f;
  long long total_cnt = 0;
  for (int p = 0; p < tab.n_live; ++p) {
    const float pt = __ldcg(part_sum + p);
    out[tab.seg[p]] = apply_chain(pt, tab, SLOT_CHAIN);
    if (tab.prologue[p] == PRO_MOMENTS) out[tab.n_seg + tab.seg[p]] = __ldcg(part_sq + p);
    total += pt;
    if (tab.census) {
      const long long pcnt = __ldcg(part_cnt + p);
      out[cbase + tab.seg[p]] = static_cast<float>(pcnt);
      total_cnt += pcnt;
    }
  }
  for (int k = 0; k < tab.n_chains; ++k) out[out_slots + k] = apply_chain(total, tab, k);
  if (tab.census) out[n_out - 1] = static_cast<float>(total_cnt);
}

}  // namespace

// Host arrays describe the live parts (in layout order); prologue codes 0
// identity, 1 square, 2 abs, 3 moments (then `dual` is 1 and there are no
// chains and no census). `slot_*` is the chain of every part total;
// `chain_ops` and `chain_p0/p1` are [n_chains][PR_MAX_STEPS] row-major.
// `scratch` holds parts_scratch_words(n_tiles) 4-byte words
// (uninitialised, 8-byte aligned); `tickets` is PR_MAX_PARTS + 1 unsigned
// ints that are 0 on entry and 0 again when the kernel ends. Returns a
// cudaError_t value, or cudaErrorInvalidValue on a bad table.
extern "C" int pr_parts(const void* const* ptrs, const long long* sizes, const int* starts,
                        const int* segs, const int* dtypes, const int* prologues,
                        int n_live, int n_seg, int compute, int dual, int slot_len,
                        const int* slot_ops, const float* slot_p0, const float* slot_p1,
                        const int* chain_lens, const int* chain_ops, const float* chain_p0,
                        const float* chain_p1, int n_chains, int census, float* out,
                        void* scratch, unsigned int* tickets, void* stream) {
  if (n_live < 1 || n_live > PR_MAX_PARTS || n_chains < 0 || n_chains > PR_MAX_CHAINS ||
      slot_len < 0 || slot_len > PR_MAX_STEPS || (dual && (n_chains || census || slot_len)))
    return static_cast<int>(cudaErrorInvalidValue);
  PartsTable tab;
  for (int i = 0; i < n_live; ++i) {
    if (prologues[i] < PRO_IDENTITY || prologues[i] > PRO_MOMENTS ||
        (prologues[i] == PRO_MOMENTS && !dual))
      return static_cast<int>(cudaErrorInvalidValue);
    tab.ptr[i] = ptrs[i];
    tab.size[i] = sizes[i];
    tab.seg[i] = segs[i];
    tab.dtype[i] = static_cast<unsigned char>(dtypes[i]);
    tab.prologue[i] = static_cast<unsigned char>(prologues[i]);
  }
  for (int i = 0; i <= n_live; ++i) tab.start[i] = starts[i];
  tab.n_live = n_live;
  tab.n_seg = n_seg;
  tab.n_chains = n_chains;
  tab.census = census;
  tab.dual = dual;
  for (int k = 0; k <= PR_MAX_CHAINS; ++k) {
    const bool slot = k == SLOT_CHAIN;
    const int len = slot ? slot_len : (k < n_chains ? chain_lens[k] : 0);
    if (len < 0 || len > PR_MAX_STEPS) return static_cast<int>(cudaErrorInvalidValue);
    tab.chain_len[k] = len;
    for (int s = 0; s < PR_MAX_STEPS; ++s) {
      const bool used = slot || k < n_chains;
      tab.op[k][s] = used ? (slot ? slot_ops[s] : chain_ops[k * PR_MAX_STEPS + s]) : -1;
      tab.p0[k][s] = used ? (slot ? slot_p0[s] : chain_p0[k * PR_MAX_STEPS + s]) : 0.f;
      tab.p1[k][s] = used ? (slot ? slot_p1[s] : chain_p1[k * PR_MAX_STEPS + s]) : 0.f;
    }
  }
  const int n_tiles = starts[n_live];
  float* tile_sum = static_cast<float*>(scratch);
  float* tile_sq = tile_sum + n_tiles;
  int* tile_cnt = reinterpret_cast<int*>(tile_sq + n_tiles);
  float* part_sum = tile_sum + (3 * static_cast<size_t>(n_tiles) + 1) / 2 * 2;
  float* part_sq = part_sum + PR_MAX_PARTS;
  long long* part_cnt = reinterpret_cast<long long*>(part_sq + PR_MAX_PARTS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PR_LAUNCH(CD)                                                                          \
  parts_kernel<CD><<<n_tiles, PR_THREADS, 0, s>>>(tab, out, tile_sum, tile_sq, tile_cnt,      \
                                                  part_sum, part_sq, part_cnt, tickets)
  switch (compute) {
    case DT_F32: PR_LAUNCH(DT_F32); break;
    case DT_BF16: PR_LAUNCH(DT_BF16); break;
    case DT_F16: PR_LAUNCH(DT_F16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PR_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
