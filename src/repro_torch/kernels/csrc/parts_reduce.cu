// Multi-part reduction: S separate arrays -> per-part totals, K epilogue
// chains of the cross-part total, and a NaN/Inf census, in one launch.
//
// Replaces the TPU kernel `parts_accumulate_kernel` of
// src/repro/kernels/mma_reduce/kernel.py (launcher `reduce_parts`). The
// output row is the reference's: [S part totals][K chains][S counts][1
// total count]. Empty parts keep 0 in their total and count slots.
//
// Bound on this card: bytes, and at the serving size (4 parts of 50304
// f32 logits, 0.8 MB) launch latency. The compute dtype of this path is
// f32, and tensor cores have no exact f32 product (TF32 keeps 10 mantissa
// bits), so each element is prologue-mapped and accumulated in f32 on the
// CUDA cores; the ones-MMA form belongs to bf16/f16 compute, which this
// kernel does not take (the wrapper raises NotImplementedError).
//
// Design: a by-value table of (pointer, size, dtype, prologue, output slot,
// tile run) for up to 128 live parts, so no part is copied or packed. One
// CTA per (part, 16384-element tile) -- the reference's m^2 tile -- writes a
// partial sum and a partial non-finite count. The census counts the raw
// (masked) value before the prologue, as the reference does. The fold is
// deterministic and uses no float atomics: the last CTA to finish, found by
// an integer ticket, folds the partials of each part in tile order, then the
// part totals in part order, and writes the row with the epilogue chains
// applied. The ticket lives in a buffer the caller zeroes once and keeps;
// the last CTA sets it back to 0, so the next launch on the stream finds it
// zeroed and the partials need no clearing. One kernel launch per call.
#include "common.cuh"

namespace {

constexpr int PR_MAX_PARTS = 128;   // ops.PARTS_KERNEL_MAX
constexpr int PR_TILE = 128 * 128;  // the reference's m^2 tile
constexpr int PR_THREADS = 256;
constexpr int PR_MAX_CHAINS = 4;
constexpr int PR_MAX_STEPS = 4;

enum Prologue : unsigned char { PRO_IDENTITY = 0, PRO_SQUARE = 1, PRO_ABS = 2 };

struct PartsTable {
  const void* ptr[PR_MAX_PARTS];
  long long size[PR_MAX_PARTS];
  int start[PR_MAX_PARTS + 1];  // live part i owns tiles [start[i], start[i+1])
  int seg[PR_MAX_PARTS];        // output slot of live part i
  unsigned char dtype[PR_MAX_PARTS];
  unsigned char prologue[PR_MAX_PARTS];
  int n_live, n_seg, n_chains, census;
  int chain_len[PR_MAX_CHAINS];
  int op[PR_MAX_CHAINS][PR_MAX_STEPS];
  float p0[PR_MAX_CHAINS][PR_MAX_STEPS];
  float p1[PR_MAX_CHAINS][PR_MAX_STEPS];
};

__device__ __forceinline__ float load_elem(const void* p, int dtype, long long i) {
  if (dtype == DT_BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dtype == DT_F16) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ float apply_chain(float t, const PartsTable& tab, int k) {
  for (int s = 0; s < tab.chain_len[k]; ++s)
    t = epilogue_step(t, tab.op[k][s], tab.p0[k][s], tab.p1[k][s]);
  return t;
}

__global__ void __launch_bounds__(PR_THREADS)
parts_kernel(const PartsTable tab, float* __restrict__ out, float* __restrict__ tile_sum,
             int* __restrict__ tile_cnt, unsigned int* __restrict__ ticket) {
  __shared__ float warp_sum[PR_THREADS / 32];
  __shared__ int warp_cnt[PR_THREADS / 32];
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
  const void* src = tab.ptr[part];
  const int dtype = tab.dtype[part], pro = tab.prologue[part];

  float sum = 0.f;
  int cnt = 0;
  for (int i = threadIdx.x; i < n; i += PR_THREADS) {
    float v = load_elem(src, dtype, base + i);
    cnt += isfinite(v) ? 0 : 1;  // census on the raw value
    if (pro == PRO_SQUARE) v = v * v;
    else if (pro == PRO_ABS) v = fabsf(v);
    sum += v;
  }
  // fixed-shape tree: the same order on every run
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, off);
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    warp_sum[warp] = sum;
    warp_cnt[warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    int c = 0;
    for (int w = 0; w < PR_THREADS / 32; ++w) {
      s += warp_sum[w];
      c += warp_cnt[w];
    }
    tile_sum[tile] = s;
    tile_cnt[tile] = c;
    __threadfence();  // publish the partials before taking a ticket
    am_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    // every other CTA has taken its ticket: reset it for the next launch
    if (am_last) *ticket = 0u;
  }
  __syncthreads();
  if (!am_last || threadIdx.x != 0) return;

  // The last CTA folds: parts in order, each part's tiles in order.
  __threadfence();
  const int n_out = tab.n_seg + tab.n_chains + (tab.census ? tab.n_seg + 1 : 0);
  for (int s = 0; s < n_out; ++s) out[s] = 0.f;
  const int cbase = tab.n_seg + tab.n_chains;
  float total = 0.f;
  long long total_cnt = 0;
  for (int p = 0; p < tab.n_live; ++p) {
    float ps = 0.f;
    long long pc = 0;
    for (int t = tab.start[p]; t < tab.start[p + 1]; ++t) {
      ps += __ldcg(tile_sum + t);
      pc += __ldcg(tile_cnt + t);
    }
    out[tab.seg[p]] = ps;
    total += ps;
    if (tab.census) {
      out[cbase + tab.seg[p]] = static_cast<float>(pc);
      total_cnt += pc;
    }
  }
  for (int k = 0; k < tab.n_chains; ++k) out[tab.n_seg + k] = apply_chain(total, tab, k);
  if (tab.census) out[n_out - 1] = static_cast<float>(total_cnt);
}

}  // namespace

// Host arrays describe the live parts (in layout order); `chain_ops` and
// `chain_p0/p1` are [n_chains][PR_MAX_STEPS] row-major. `scratch` holds
// n_tiles floats, then n_tiles ints (uninitialised); `ticket` is one
// unsigned int that is 0 on entry and 0 again when the kernel ends.
// Returns a cudaError_t value, or cudaErrorInvalidValue on a bad table.
extern "C" int pr_parts(const void* const* ptrs, const long long* sizes, const int* starts,
                        const int* segs, const int* dtypes, const int* prologues,
                        int n_live, int n_seg, const int* chain_lens, const int* chain_ops,
                        const float* chain_p0, const float* chain_p1, int n_chains,
                        int census, float* out, void* scratch, unsigned int* ticket,
                        void* stream) {
  if (n_live < 1 || n_live > PR_MAX_PARTS || n_chains < 0 || n_chains > PR_MAX_CHAINS)
    return static_cast<int>(cudaErrorInvalidValue);
  PartsTable tab;
  for (int i = 0; i < n_live; ++i) {
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
  for (int k = 0; k < n_chains; ++k) {
    if (chain_lens[k] < 0 || chain_lens[k] > PR_MAX_STEPS)
      return static_cast<int>(cudaErrorInvalidValue);
    tab.chain_len[k] = chain_lens[k];
    for (int s = 0; s < PR_MAX_STEPS; ++s) {
      tab.op[k][s] = chain_ops[k * PR_MAX_STEPS + s];
      tab.p0[k][s] = chain_p0[k * PR_MAX_STEPS + s];
      tab.p1[k][s] = chain_p1[k * PR_MAX_STEPS + s];
    }
  }
  const int n_tiles = starts[n_live];
  float* tile_sum = static_cast<float*>(scratch);
  int* tile_cnt = reinterpret_cast<int*>(tile_sum + n_tiles);
  parts_kernel<<<n_tiles, PR_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      tab, out, tile_sum, tile_cnt, ticket);
  return static_cast<int>(cudaGetLastError());
}
