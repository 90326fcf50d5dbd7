// Fragmentation-scoring kernels of the batched Monte-Carlo engine and of the
// single-decision scheduler API (mfi_delta), written by hand for Hopper
// (sm_90a), behind a plain C interface loaded with ctypes
// (repro_torch/kernels/build.py builds this file with nvcc at first use).
//
// Every launcher runs its kernel on the stream it is given, never
// synchronises, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
//
// Every score is an integer held in float32 (window sizes <= 32 slices,
// sums <= 32 windows), so each kernel reproduces its plain torch version
// (repro_torch/kernels/fragscore/ref.py) bit for bit in any summation order.
//
// Shapes on the engine's main path (M = 100 A100-80GB GPUs, R = 500
// replicas): N = 18 windows, A = 7 anchors, S = 8 slices.  fragscore,
// delta_from_base and select_from_base move a few megabytes a call at most
// and do a few million float operations, so on an H100 a chain of dependent
// loads and instructions inside one block, not bytes or operations, sets
// their time (a few microseconds); the designs keep one launch per engine
// stage and read every table once per block.  migrate_refine reads ~48 MB a
// call, so bytes bound it (see its note).  mfi_delta serves one scheduling
// decision over up to 10^6 GPUs, where its bytes bound it (see its note).

#include <cuda_runtime.h>

#include "../../csrc/device_scope.h"
#include <math_constants.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kMaxSlices = 16;  // S <= 12 (the H200-141GB geometry)
constexpr int kMaxKeys = 8;     // effective scoring keys of a fused spec
constexpr int kFragThreads = 32;
constexpr int kMfiThreads = 256;    // an mfi_delta block: a thread per GPU row
constexpr int kDeltaThreads = 128;  // a delta_from_base block: a thread per GPU row of a replica
constexpr int kSelectThreads = 128;  // a select block per replica, a thread per GPU row
constexpr int kMigrateThreads = 256;
constexpr float kBig = 1e9f;  // the masked-key sentinel (ref.BIG)
constexpr float kMfiBig = 1e30f;  // mfi_delta's infeasibility sentinel (ref.MFI_BIG)

// ---------------------------------------------------------------------------
// Windows as bit sets.  Where N <= 32 and every window size is a whole
// number of slices in [0, 32], a set of windows is one 32-bit word and the
// sizes are kSizeBits bit planes (plane q: the windows whose size has bit q
// set).  A sum of sizes is then a sum of popcounts, and the windows of size
// <= t a bit-sliced comparison of the planes with t.
// ---------------------------------------------------------------------------

// Σ v[i] over the set bits i of `bits`, from the bit planes of the window
// sizes (plane q holds the windows whose size has bit q set): exact, as the
// sizes are whole slices.
constexpr int kMaxWindows = 32;  // a set of windows is one 32-bit word
constexpr int kSizeBits = 6;     // window sizes below 64 slices
struct Planes {
  uint32_t q[kSizeBits];
};

__device__ __forceinline__ float window_sum(uint32_t bits, const Planes& planes) {
  int sum = 0;
#pragma unroll
  for (int q = 0; q < kSizeBits; ++q) sum += __popc(bits & planes.q[q]) << q;
  return static_cast<float>(sum);
}

// The windows whose size is <= free (sizes are whole, so <= floor(free)):
// the planes compared with t = floor(free), most significant bit first.
// Bits past the last window are set too; every caller masks them off.
__device__ __forceinline__ uint32_t windows_le(const Planes& planes, float free_slices) {
  const int t = static_cast<int>(fminf(fmaxf(floorf(free_slices), -1.f), 63.f));
  uint32_t lt = 0, eq = ~0u;  // windows already below t; equal to t so far
#pragma unroll
  for (int q = kSizeBits - 1; q >= 0; --q) {
    const uint32_t pq = planes.q[q];
    if ((t >> q) & 1) {
      lt |= eq & ~pq;
      eq &= pq;
    } else {
      eq &= ~pq;
    }
  }
  return t < 0 ? 0u : lt | eq;
}

// The float count arithmetic of F over one occupancy row x (its slices past
// s are 0; used = the row's sum), for any values and any window table.
__device__ __forceinline__ float score_row(const float (&x)[kMaxSlices], float used,
                                           const float* sw, const float* sv, int n,
                                           int s, int partial) {
  const float free_slices = static_cast<float>(s) - used;
  float acc = 0.f;
  for (int i = 0; i < n; ++i) {
    float inwin = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSlices; ++j) {
      if (j < s) inwin += x[j] * sw[i * s + j];
    }
    const float vi = sv[i];
    const bool counted = partial ? (inwin > 0.f && inwin < vi) : (inwin > 0.f);
    if (counted && vi <= free_slices) acc += vi;
  }
  return acc;
}

// Row `row` of an (rows, s) int32 matrix into x (x is 0 past s): 16-byte
// loads where the matrix allows them.
__device__ __forceinline__ void load_row(const int32_t* __restrict__ occ, int64_t row, int s,
                                         int (&x)[kMaxSlices]) {
  const int32_t* o = occ + row * s;
  if ((s & 3) == 0 && (reinterpret_cast<uintptr_t>(occ) & 15) == 0) {
#pragma unroll
    for (int c = 0; c < kMaxSlices / 4; ++c) {
      if (4 * c < s) {
        const int4 u = __ldg(reinterpret_cast<const int4*>(o) + c);
        x[4 * c] = u.x;
        x[4 * c + 1] = u.y;
        x[4 * c + 2] = u.z;
        x[4 * c + 3] = u.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kMaxSlices; ++j)
      if (j < s) x[j] = o[j];
  }
}

// A placement table w (N, S), v (N,) as bit sets in registers, read by
// every warp, lane i window i.  Where `store`, the lane also puts the
// table into shared memory (sw, sv) for the count path.
struct TableBits {
  bool ok;                    // 0/1 windows of whole sizes in [0, 32], N <= 32
  uint32_t swin[kMaxSlices];  // the windows holding slice j
  Planes planes;              // the bit planes of the window sizes
  uint32_t wb;                // the lane's window, as slice bits
  float vl;                   // the lane's window size
};

__device__ __forceinline__ TableBits warp_table_bits(const float* __restrict__ w,
                                                     const float* __restrict__ v, int n, int s,
                                                     float* sw, float* sv, bool store) {
  const int lane = threadIdx.x % 32;
  TableBits t;
  t.ok = n <= kMaxWindows;
  t.wb = 0;
  t.vl = 0.f;
  for (int i = lane; i < n; i += 32) {
    float wi[kMaxSlices];
#pragma unroll
    for (int j = 0; j < kMaxSlices; ++j) wi[j] = j < s ? w[i * s + j] : 0.f;
    const float vi = v[i];
    uint32_t bits = 0;
#pragma unroll
    for (int j = 0; j < kMaxSlices; ++j) {
      if (j < s) {
        if (store) sw[i * s + j] = wi[j];
        t.ok &= wi[j] == 0.f || wi[j] == 1.f;
        bits |= (wi[j] != 0.f ? 1u : 0u) << j;
      }
    }
    t.ok &= vi == floorf(vi) && vi >= 0.f && vi <= 32.f;
    if (store) sv[i] = vi;
    if (i == lane) {
      t.vl = vi;
      t.wb = bits;
    }
  }
  t.ok = __all_sync(0xffffffffu, t.ok);
  const bool mine = lane < n;
#pragma unroll
  for (int j = 0; j < kMaxSlices; ++j)
    t.swin[j] = j < s ? __ballot_sync(0xffffffffu, mine && ((t.wb >> j) & 1)) : 0u;
  const int vi = t.ok && mine ? static_cast<int>(t.vl) : 0;
#pragma unroll
  for (int q = 0; q < kSizeBits; ++q) t.planes.q[q] = __ballot_sync(0xffffffffu, (vi >> q) & 1);
  return t;
}

// A block's output tile: the block's outputs, contiguous in device memory
// from dst, sit in shared memory at tile[tile_lead(dst) + e], so that the
// tile (16-byte aligned) and dst agree modulo 16 bytes, and leave in
// 16-byte stores (store_tile; the block's threads all call it).
__host__ __device__ inline size_t tile_words(size_t count) { return (count + 3 + 3) & ~static_cast<size_t>(3); }

__device__ __forceinline__ int tile_lead(const float* dst) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
}

__device__ __forceinline__ void store_tile(float* __restrict__ dst, const float* tile, int count) {
  const int lead = tile_lead(dst);
  const int head = min((4 - lead) & 3, count);  // up to dst's first 16-byte boundary
  const int body = (count - head) & ~3;
  for (int e = threadIdx.x; e < head; e += blockDim.x) dst[e] = tile[lead + e];
  const float4* src4 = reinterpret_cast<const float4*>(tile + lead + head);
  float4* dst4 = reinterpret_cast<float4*>(dst + head);
  for (int c = threadIdx.x; c < body / 4; c += blockDim.x) dst4[c] = src4[c];
  for (int e = head + body + threadIdx.x; e < count; e += blockDim.x) dst[e] = tile[lead + e];
}

// ---------------------------------------------------------------------------
// fragscore — replaces kernels/fragscore/fragscore.py::fragscore (Pallas,
// _fragscore_kernel/_score_block; src/repro/kernels/fragscore/fragscore.py:76,
// call :100) of the JAX package.
//
// F(m) of each occupancy row: window counts occ · Wᵀ, the blocked/partial
// predicate, the eligibility of each window against the row's free slices,
// and the eligible sum.  Bound: bytes, well under 0.1 µs (the main path
// scores the R·E = 6,000 expire rows, 192 KB in and 24 KB out, or the R
// commit rows), so the launch and one chain of dependent steps set the
// time.  The design shortens that chain:
//  * a block is one warp, so 6,000 rows spread over all SMs (188 blocks);
//  * a thread's row comes in 16-byte loads issued before the table is
//    read, so that the two latencies overlap (load_row);
//  * every warp reads the window table, lane i window i, and keeps its bit
//    sets in registers by ballot (warp_table_bits): the windows holding
//    each slice and the bit planes of the sizes (only the count path below
//    reads the table from shared memory);
//  * a row of 0/1 entries (every row the engine makes) is a slice mask: its
//    occupied windows are the OR of its slices' windows, the eligible ones
//    a bit-sliced comparison of the planes with S − used, and F under
//    "blocked" a popcount sum; "partial" also counts each window's slices;
//  * any other row, or a table that is not 0/1 windows of whole sizes in
//    [0, 32] with N <= 32, takes the float count arithmetic (score_row) on
//    the table in shared memory, so the kernel equals its plain version on
//    any row whose sums are exact in float32, not only on the engine's.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kFragThreads) fragscore_kernel(
    const int32_t* __restrict__ occ, const float* __restrict__ w,
    const float* __restrict__ v, float* __restrict__ out, int q, int n, int s,
    int partial) {
  extern __shared__ float sh[];
  float* sw = sh;         // (N, S) window slices, for the count path
  float* sv = sw + n * s;  // (N,) window sizes
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  int x[kMaxSlices];
#pragma unroll
  for (int j = 0; j < kMaxSlices; ++j) x[j] = 0;
  if (row < q) load_row(occ, row, s, x);  // the row first: its loads fly while the table is read
  const TableBits tb = warp_table_bits(w, v, n, s, sw, sv, threadIdx.x < 32);
  uint32_t mask = 0;
  bool binary = true;
#pragma unroll
  for (int j = 0; j < kMaxSlices; ++j) {
    binary &= (x[j] & ~1) == 0;
    mask |= static_cast<uint32_t>(x[j] & 1) << j;
  }
  const int used = __popc(mask);
  uint32_t full = 0;  // "partial": the windows whose count reaches their size
  if (partial && tb.ok) {
    for (int i = 0; i < n; ++i) {
      const uint32_t wbi = __shfl_sync(0xffffffffu, tb.wb, i);
      const float vw = __shfl_sync(0xffffffffu, tb.vl, i);
      full |= (static_cast<float>(__popc(mask & wbi)) >= vw ? 1u : 0u) << i;
    }
  }
  __syncthreads();  // the count path's table in place
  if (row >= q) return;
  float score;
  if (tb.ok && binary) {
    uint32_t occupied = 0;  // the windows holding a used slice
#pragma unroll
    for (int j = 0; j < kMaxSlices; ++j) occupied |= ((mask >> j) & 1) ? tb.swin[j] : 0u;
    const uint32_t elig = windows_le(tb.planes, static_cast<float>(s - used));
    score = window_sum((partial ? occupied & ~full : occupied) & elig, tb.planes);
  } else {
    float xf[kMaxSlices];
    float usedf = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSlices; ++j) {
      xf[j] = static_cast<float>(x[j]);
      usedf += xf[j];
    }
    score = score_row(xf, usedf, sw, sv, n, s, partial);
  }
  out[row] = score;
}

// ---------------------------------------------------------------------------
// mfi_delta — replaces kernels/fragscore/fragscore.py::mfi_delta (Pallas,
// _mfi_delta_kernel/_score_block; src/repro/kernels/fragscore/fragscore.py:133,
// call :160) of the JAX package: the ΔF table of one scheduling decision.
//
// For every GPU row of raw occupancy occ (M, S) and every anchor k of the
// requested class: F(min(occ + mask_k, 1)) − F(occ) where the anchor is
// valid (pv[k] > 0) and its window holds no occupied slice, exactly 1e30
// otherwise.
//
// Bound: bytes.  Per row it reads S int32 and writes A floats: at M = 10^6
// A100-80GB rows and 1g.10gb (A = 7), 32 MB + 28 MB, 17.9 µs at 3.35 TB/s.
// The float work the function needs (each row's window counts and F, and F
// after each feasible dry run, ~0.73 GFLOP at 45 % fill) takes 11 µs at
// 67 TFLOP/s.  At M <= 10^4 the launch and one block's chain set the time.
// Design:
//  * a thread per row, 256 rows a tile, as many blocks as the card holds at
//    once, each walking tiles with the next tile's row in flight (16-byte
//    loads, load_row) while it scores the current one;
//  * every warp keeps the window table's bit sets in registers by ballot
//    (warp_table_bits, as fragscore), and lane k derives anchor k's slice
//    mask, which the block reads from shared memory;
//  * a 0/1 row (every row the scheduler makes) is a slice mask, and a
//    feasible dry run is the mask | the anchor's slices, so F of either is
//    one entry of a table of F over every 0/1 row of S <= 12 slices, which
//    each block builds once in shared memory (16 KB at S = 12): F of a mask
//    is a popcount sum over its occupied windows (the OR of its slices'
//    windows) of size <= S − used (a bit-sliced comparison of the size
//    planes); "partial" also drops the full windows: where every window's
//    size is its slice count (every device model's table) a window is full
//    iff none of its slices is free, else each window's slices are counted;
//    per anchor, feasibility is one AND and ΔF one table read less F(occ);
//  * any other row, or a table that is not 0/1 windows and anchors with
//    window sizes whole in [0, 32], N <= 32 and S <= 12, takes the float
//    count arithmetic of the reference (score_row) on the tables in shared
//    memory, so that the kernel equals its plain version on any occupancy
//    whose sums are exact in float32;
//  * each tile's (rows × A) outputs leave through shared memory in 16-byte
//    stores (store_tile).
// Replaced (measured in PERF.md): PR 14's design, every feasible dry run
// rescored from its slices in float, N·(2·S + 3) dependent operations each
// (15.1 µs at M = 100, 391.6 µs at 10^6, bound by instruction issue); and a
// first version of this one with a block per 256-row tile and F of every
// dry run as its own popcount sum (4.4 µs at M = 100, 71.9 µs at 10^6:
// ten waves of 80-register blocks, each paying the table derivation).
// Also measured slower at 10^6 (PERF.md): the row tiles staged by a
// cp.async ring of 2–6 tiles a block, one block per SM, three or four per
// SM by launch bounds (two is what the registers allow).
// ---------------------------------------------------------------------------

constexpr int kMfiTableSlices = 12;  // the F table holds every 0/1 row of S <= 12 slices

// "partial": the windows none of whose slices is outside `bits`, from the
// windows of each slice where every window's size is its slice count
// (`whole`), else by counting each window's slices in `bits`.
__device__ __forceinline__ uint32_t full_windows(uint32_t bits, const TableBits& tb, bool whole,
                                                 const uint32_t* swb, const float* sv, int n,
                                                 int s) {
  if (whole) {
    uint32_t open = 0;  // the windows holding a slice outside `bits`
#pragma unroll
    for (int j = 0; j < kMaxSlices; ++j) open |= (j < s && !((bits >> j) & 1)) ? tb.swin[j] : 0u;
    return ~open;
  }
  uint32_t full = 0;
  for (int i = 0; i < n; ++i)
    full |= (static_cast<float>(__popc(bits & swb[i])) >= sv[i] ? 1u : 0u) << i;
  return full;
}

// words of mfi_delta's shared memory before its tables: the output tile,
// then the F table
__host__ __device__ inline size_t mfi_table_offset(int a) {
  return tile_words(static_cast<size_t>(kMfiThreads) * a);
}

inline size_t mfi_smem_bytes(int n, int s, int a) {
  const size_t table = s <= kMfiTableSlices ? size_t{1} << s : 0;
  return 4 * (mfi_table_offset(a) + table + static_cast<size_t>(n) * s + n +
              static_cast<size_t>(a) * s + 2 * a + n);
}

template <bool kPartialMetric>
__global__ void __launch_bounds__(kMfiThreads) mfi_delta_kernel(
    const int32_t* __restrict__ occ, const float* __restrict__ w,
    const float* __restrict__ v, const float* __restrict__ pm,
    const float* __restrict__ pv, float* __restrict__ out, int m, int n, int s, int a,
    int64_t tiles) {
  extern __shared__ __align__(16) float mdsh[];
  const int table_size = s <= kMfiTableSlices ? 1 << s : 0;
  float* tile = mdsh;                                // a tile's (rows, A) outputs
  float* ftab = tile + mfi_table_offset(a);          // F of every 0/1 row
  float* sw = ftab + table_size;                     // (N, S) window slices
  float* sv = sw + n * s;                            // (N,) window sizes
  float* spm = sv + n;                               // (A, S) anchor slices
  float* spv = spm + a * s;                          // (A,) anchor validity
  uint32_t* sanc = reinterpret_cast<uint32_t*>(spv + a);  // (A,) slice mask | valid << 31
  uint32_t* swb = sanc + a;                          // (N,) each window's slices
  const int lane = threadIdx.x % 32;
  const bool lead_warp = threadIdx.x < 32;
  int x[kMaxSlices];
#pragma unroll
  for (int j = 0; j < kMaxSlices; ++j) x[j] = 0;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kMfiThreads + threadIdx.x;
  if (first < m) load_row(occ, first, s, x);  // in flight while the tables are read
  const TableBits tb = warp_table_bits(w, v, n, s, sw, sv, lead_warp);
  bool ok = tb.ok && table_size > 0;  // and every anchor is 0/1 slices
  for (int k = lane; k < a; k += 32) {
    uint32_t am = 0;
#pragma unroll
    for (int j = 0; j < kMaxSlices; ++j) {
      if (j < s) {
        const float mj = pm[k * s + j];
        ok &= mj == 0.f || mj == 1.f;
        am |= (mj != 0.f ? 1u : 0u) << j;
        if (lead_warp) spm[k * s + j] = mj;
      }
    }
    const float vk = pv[k];
    if (lead_warp) {
      spv[k] = vk;
      sanc[k] = am | (vk > 0.f ? 1u << 31 : 0u);
    }
  }
  ok = __all_sync(0xffffffffu, ok);
  const bool whole = __all_sync(0xffffffffu, lane >= n || __popc(tb.wb) == static_cast<int>(tb.vl));
  if (lead_warp && lane < n) swb[lane] = tb.wb;
  __syncthreads();  // the anchors and the count path's tables in place
  if (ok) {  // F of every 0/1 row
    for (int bits = threadIdx.x; bits < table_size; bits += blockDim.x) {
      uint32_t occupied = 0;  // the windows holding a used slice
#pragma unroll
      for (int j = 0; j < kMaxSlices; ++j) occupied |= ((bits >> j) & 1) ? tb.swin[j] : 0u;
      const uint32_t keep = kPartialMetric ? ~full_windows(bits, tb, whole, swb, sv, n, s) : ~0u;
      ftab[bits] = window_sum(occupied & keep & windows_le(tb.planes, static_cast<float>(s - __popc(bits))),
                              tb.planes);
    }
    __syncthreads();
  }
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t row0 = t * kMfiThreads, row = row0 + threadIdx.x;
    uint32_t mask = 0;
    bool binary = true;
#pragma unroll
    for (int j = 0; j < kMaxSlices; ++j) {
      binary &= (x[j] & ~1) == 0;
      mask |= static_cast<uint32_t>(x[j] & 1) << j;
    }
    // the next tile's row flies while this one is scored
    const int64_t next = row + static_cast<int64_t>(gridDim.x) * kMfiThreads;
#pragma unroll
    for (int j = 0; j < kMaxSlices; ++j) x[j] = 0;
    if (next < m) load_row(occ, next, s, x);
    float* dst = out + row0 * a;
    float* o = tile + tile_lead(dst) + threadIdx.x * a;
    if (row < m && ok && binary) {
      const float fb = ftab[mask];
      for (int k = 0; k < a; ++k) {
        const uint32_t an = sanc[k], am = an & 0xffffu;
        o[k] = (an >> 31) && !(mask & am) ? ftab[mask | am] - fb : kMfiBig;
      }
    } else if (row < m) {  // the reference's float arithmetic
      int xr[kMaxSlices];
#pragma unroll
      for (int j = 0; j < kMaxSlices; ++j) xr[j] = 0;
      load_row(occ, row, s, xr);
      float xf[kMaxSlices];
      float usedf = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxSlices; ++j) {
        xf[j] = static_cast<float>(xr[j]);
        usedf += xf[j];
      }
      const float fb = score_row(xf, usedf, sw, sv, n, s, kPartialMetric);
      for (int k = 0; k < a; ++k) {
        const float* mk = spm + k * s;
        float overlap = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxSlices; ++j) {
          if (j < s) overlap += xf[j] * mk[j];
        }
        float d = kMfiBig;
        if (overlap == 0.f && spv[k] > 0.f) {
          float h[kMaxSlices];
          float hused = 0.f;
#pragma unroll
          for (int j = 0; j < kMaxSlices; ++j) {
            h[j] = j < s ? fminf(xf[j] + mk[j], 1.f) : 0.f;
            hused += h[j];
          }
          d = score_row(h, hused, sw, sv, n, s, kPartialMetric) - fb;
        }
        o[k] = d;
      }
    }
    __syncthreads();
    store_tile(dst, tile, static_cast<int>(min(static_cast<int64_t>(kMfiThreads), m - row0)) * a);
    __syncthreads();  // the tile is free again
  }
}

// ---------------------------------------------------------------------------
// Tables and sort forms shared by delta_from_base, select_from_base and
// migrate_refine.
// ---------------------------------------------------------------------------

// Copy `words` 4-byte words to shared memory with cp.async (16 bytes a copy
// where both sides are 16-byte aligned), so that every load of a run is in
// flight at once; the caller commits and waits.
__device__ __forceinline__ void stage_async(void* dst, const void* src, int words) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const char* s = static_cast<const char*>(src);
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | d) & 15) == 0) {
    done = words & ~3;
    for (int c = threadIdx.x; c < done / 4; c += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + 16 * c),
                   "l"(s + 16 * c));
  }
  for (int i = done + threadIdx.x; i < words; i += blockDim.x)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d + 4 * i), "l"(s + 4 * i));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Every (model, class) table in shared memory, with the bit sets
// derived from them (stage_window_tables, derive_window_bits,
// stage_spec_tables).
struct SpecTables {
  const float* v;     // (K, N) window sizes
  const float* mw;    // (K, P, A, N) window counts each anchor adds
  const float* mem;   // (K, P) slice demand
  uint32_t* mwb;      // (K, P, A) bits of the windows each anchor touches
  uint32_t* planes;   // (K, kSizeBits) bit planes of the window sizes
  const int* meta;    // (K, P, A) anchor: valid + 2·window row + 64·anchor value
};

__device__ __forceinline__ Planes planes_of(const SpecTables& t, int k) {
  Planes p;
#pragma unroll
  for (int q = 0; q < kSizeBits; ++q) p.q[q] = t.planes[k * kSizeBits + q];
  return p;
}

// words of V, maskwin, profile_mem and the bit sets derived from them
__host__ __device__ inline size_t window_tables_raw(int k_count, int p_count, int a, int n) {
  const size_t kpa = static_cast<size_t>(k_count) * p_count * a;
  return static_cast<size_t>(k_count) * n + kpa * n + static_cast<size_t>(k_count) * p_count +
         kpa + static_cast<size_t>(k_count) * kSizeBits;
}

// an area that follows the tables starts 16-byte aligned
__host__ __device__ inline size_t round_words(size_t words) { return (words + 3) & ~static_cast<size_t>(3); }

__host__ __device__ inline size_t window_tables_words(int k_count, int p_count, int a, int n) {
  return round_words(window_tables_raw(k_count, p_count, a, n));
}

// the window tables and the anchor words of every (model, class)
__host__ __device__ inline size_t spec_tables_words(int k_count, int p_count, int a, int n) {
  return round_words(window_tables_raw(k_count, p_count, a, n) +
                     3 * static_cast<size_t>(k_count) * p_count * a);
}

// The i-th anchor (k, p, j) a block derives: of every class, or of class
// p_only >= 0 only.
__device__ __forceinline__ int picked_anchor(int i, int p_only, int p_count, int a) {
  return p_only >= 0 ? ((i / a) * p_count + p_only) * a + i % a : i;
}

// Issue the cp.async copies of V, maskwin and profile_mem into sh; the
// caller commits, waits and syncs before derive_window_bits.
__device__ __forceinline__ SpecTables stage_window_tables(uint32_t* sh, const float* __restrict__ V,
                                                          const float* __restrict__ maskwin,
                                                          const float* __restrict__ profile_mem,
                                                          int k_count, int p_count, int a, int n) {
  const int kpa = k_count * p_count * a;
  float* sv = reinterpret_cast<float*>(sh);
  float* smw = sv + k_count * n;
  float* smem = smw + kpa * n;
  uint32_t* smwb = reinterpret_cast<uint32_t*>(smem + k_count * p_count);
  uint32_t* splanes = smwb + kpa;
  stage_async(sv, V, k_count * n);
  stage_async(smw, maskwin, kpa * n);
  stage_async(smem, profile_mem, k_count * p_count);
  return SpecTables{sv, smw, smem, smwb, splanes, nullptr};
}

// The bit sets of the staged tables, a ballot each (lane w holds window w):
// the windows each anchor of every class, or of class p_only >= 0, touches,
// then the size planes of every model.  blockDim is a multiple of 32; the
// caller syncs the block before reading them.
__device__ __forceinline__ void derive_window_bits(const SpecTables& t, int k_count, int p_count,
                                                   int a, int n, int p_only) {
  const int pick_count = p_only >= 0 ? k_count * a : k_count * p_count * a;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
#pragma unroll 4
  for (int i = warp; i < pick_count; i += warps) {
    const int x = picked_anchor(i, p_only, p_count, a);
    const uint32_t bits = __ballot_sync(0xffffffffu, lane < n && t.mw[x * n + lane] > 0.f);
    if (lane == 0) t.mwb[x] = bits;
  }
#pragma unroll 2
  for (int i = warp; i < k_count * kSizeBits; i += warps) {
    const int k = i / kSizeBits, q = i % kSizeBits;
    const int vw = lane < n ? static_cast<int>(t.v[k * n + lane]) : 0;
    const uint32_t bits = __ballot_sync(0xffffffffu, (vw >> q) & 1);
    if (lane == 0) t.planes[i] = bits;
  }
}

// Stage the tables into sh with cp.async (it waits for every copy in flight,
// the caller's too) and derive the bit sets: the anchor words and the
// windows each anchor touches, of every class or only of class p_only >= 0,
// and the size planes of every model.  blockDim is a multiple of 32; the
// caller syncs the block before reading the derived sets.
__device__ __forceinline__ SpecTables stage_spec_tables(
    uint32_t* sh, const float* __restrict__ V, const float* __restrict__ maskwin,
    const int32_t* __restrict__ profile_rows, const uint8_t* __restrict__ profile_valid,
    const int32_t* __restrict__ profile_anchors, const float* __restrict__ profile_mem,
    int k_count, int p_count, int a, int n, int p_only) {
  const int kpa = k_count * p_count * a;
  SpecTables t = stage_window_tables(sh, V, maskwin, profile_mem, k_count, p_count, a, n);
  // (an offset in int arithmetic: a size_t one here cost select_from_base 0.4 µs, PERF.md)
  int* srow = reinterpret_cast<int*>(t.planes + k_count * kSizeBits);
  int* sanc = srow + kpa;
  int* sval = sanc + kpa;
  stage_async(srow, profile_rows, kpa);
  stage_async(sanc, profile_anchors, kpa);
  cp_async_commit();
  const int pick_count = p_only >= 0 ? k_count * a : kpa;
  for (int i = threadIdx.x; i < pick_count; i += blockDim.x) {
    const int x = picked_anchor(i, p_only, p_count, a);
    sval[x] = profile_valid[x];
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = threadIdx.x; i < pick_count; i += blockDim.x) {  // one word per anchor
    const int x = picked_anchor(i, p_only, p_count, a);
    srow[x] = (sval[x] ? 1 : 0) + (srow[x] & 31) * 2 + sanc[x] * 64;
  }
  derive_window_bits(t, k_count, p_count, a, n, p_only);
  t.meta = srow;
  return t;
}

// One candidate placement of a refinement: its key bases and its place.
struct Cand {
  float delta, fa, anc;  // ΔF, free slices after, anchor value
  int gpu, col;
  bool ok;
};

// Key i of a candidate under the packed key code (3 bits per key, as
// decode_keys reads it), decoded arithmetically so that nothing is indexed
// at run time (an indexed array would live in local memory).
__device__ __forceinline__ float key_of(int keycode, int i, const Cand& c) {
  const int code = (keycode >> (3 * i)) & 7;
  const int base = code & 3;
  const float v = base == 0 ? c.delta : base == 1 ? c.fa : base == 2 ? static_cast<float>(c.gpu) : c.anc;
  return (code & 4) ? -v : v;
}

// c ? a : b, field by field (a struct-valued branch would go to local memory)
__device__ __forceinline__ Cand pick(bool c, const Cand& a, const Cand& b) {
  return {c ? a.delta : b.delta, c ? a.fa : b.fa, c ? a.anc : b.anc,
          c ? a.gpu : b.gpu,     c ? a.col : b.col, c ? a.ok : b.ok};
}

// Two columns of one row differ only in ΔF and the anchor value (free
// slices and gpu are the row's), so the refinement along a row compares the
// distinct ones among those keys, in key order, each as d·ΔF + a·anchor
// (d, a in {0, ±1}: exact).
struct ColOrder {
  float d0, a0, d1, a1;
  int n;
};

__host__ __device__ inline ColOrder col_order(int keycode, int nkeys) {
  ColOrder o = {0.f, 0.f, 0.f, 0.f, 0};
  int seen = 0;
  for (int i = 0; i < nkeys; ++i) {
    const int code = (keycode >> (3 * i)) & 7, base = code & 3;
    if ((base != 0 && base != 3) || ((seen >> base) & 1)) continue;
    seen |= 1 << base;
    const float sgn = (code & 4) ? -1.f : 1.f;
    const float d = base == 0 ? sgn : 0.f, a = base == 3 ? sgn : 0.f;
    if (o.n == 0) {
      o.d0 = d;
      o.a0 = a;
    } else {
      o.d1 = d;
      o.a1 = a;
    }
    ++o.n;
  }
  return o;
}

// column x before column y of the same row (ties keep the earlier column)
__device__ __forceinline__ bool col_less(const ColOrder& o, const Cand& x, const Cand& y) {
  const float x0 = o.d0 * x.delta + o.a0 * x.anc, y0 = o.d0 * y.delta + o.a0 * y.anc;
  if (o.n > 0 && x0 != y0) return x0 < y0;
  const float x1 = o.d1 * x.delta + o.a1 * x.anc, y1 = o.d1 * y.delta + o.a1 * y.anc;
  return o.n > 1 && x1 < y1;
}

// Pass 0 orders rows by (keys..., gpu).  A row in sort form holds the
// values of the distinct key bases in key order (a repeated base decides
// nothing), so that a comparison is a few float compares.
struct RowOrder {
  int code;  // key code of the distinct bases, in order
  int n;     // their number (at most 4)
  int map;   // per key of the tuple: its slot (2 bits) and a sign flip (1 bit)
  int cut;   // the leading bases that decide between rows of distinct GPUs (below)
};

struct RowCand {
  float kv[4];
  int gpu, col;
  bool ok;
};

__host__ __device__ inline RowOrder row_order(int keycode, int nkeys) {
  RowOrder o = {0, 0, 0, -1};
  int seen = 0, slot_of = 0;  // the bases taken, and the slot of each (2 bits)
  for (int i = 0; i < nkeys; ++i) {
    const int code = (keycode >> (3 * i)) & 7, base = code & 3;
    if (!((seen >> base) & 1)) {
      seen |= 1 << base;
      slot_of |= o.n << (2 * base);
      o.code |= code << (3 * o.n++);
    }
    const int j = (slot_of >> (2 * base)) & 3;
    const int flip = ((code ^ (o.code >> (3 * j))) >> 2) & 1;
    o.map |= (j | flip << 2) << (3 * i);
  }
  // Rows of distinct GPUs are decided at the gpu base at the latest: "gpu"
  // orders them as the flat index gpu·A + col does, "-gpu" decides alone.
  for (int j = 0; j < o.n && o.cut < 0; ++j) {
    const int code = (o.code >> (3 * j)) & 7;
    if ((code & 3) == 2) o.cut = (code & 4) ? j + 1 : j;
  }
  if (o.cut < 0) o.cut = o.n;
  return o;
}

__device__ __forceinline__ RowCand row_cand(const RowOrder& o, const Cand& c) {
  RowCand r;
#pragma unroll
  for (int j = 0; j < 4; ++j) r.kv[j] = j < o.n ? key_of(o.code, j, c) : 0.f;
  r.gpu = c.gpu;
  r.col = c.col;
  r.ok = c.ok;
  return r;
}

// key i of the tuple
__device__ __forceinline__ float row_key(const RowOrder& o, const RowCand& r, int i) {
  const int m = (o.map >> (3 * i)) & 7, j = m & 3;
  const float v = j == 0 ? r.kv[0] : j == 1 ? r.kv[1] : j == 2 ? r.kv[2] : r.kv[3];
  return (m & 4) ? -v : v;
}

// feasible first, then (keys..., gpu)
__device__ __forceinline__ bool row_less(const RowOrder& o, const RowCand& a, const RowCand& b) {
  if (a.ok != b.ok) return a.ok;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < o.n && a.kv[j] != b.kv[j]) return a.kv[j] < b.kv[j];
  return a.gpu < b.gpu;
}

__device__ __forceinline__ RowCand pick(bool c, const RowCand& a, const RowCand& b) {
  RowCand r;
#pragma unroll
  for (int j = 0; j < 4; ++j) r.kv[j] = c ? a.kv[j] : b.kv[j];
  r.gpu = c ? a.gpu : b.gpu;
  r.col = c ? a.col : b.col;
  r.ok = c ? a.ok : b.ok;
  return r;
}

__device__ __forceinline__ RowCand shfl_down(const RowCand& c, int off) {
  RowCand o;
#pragma unroll
  for (int j = 0; j < 4; ++j) o.kv[j] = __shfl_down_sync(0xffffffffu, c.kv[j], off);
  o.gpu = __shfl_down_sync(0xffffffffu, c.gpu, off);
  o.col = __shfl_down_sync(0xffffffffu, c.col, off);
  o.ok = __shfl_down_sync(0xffffffffu, static_cast<int>(c.ok), off) != 0;
  return o;
}

// (c1, c2) becomes the top-2 of the union of two sorted top-2 lists of
// distinct rows, (c1, c2) and (o1, o2): two comparisons
__device__ __forceinline__ void top2_merge(const RowOrder& o, const RowCand& o1,
                                           const RowCand& o2, RowCand& c1, RowCand& c2) {
  const bool o_first = row_less(o, o1, c1);
  const RowCand a = pick(o_first, c1, c2), b = pick(o_first, o2, o1);  // the runner-up is one
  c2 = pick(row_less(o, b, a), b, a);
  c1 = pick(o_first, o1, c1);
}

// ΔF of an anchor from a row's window counts b and the anchor's mw, in the
// plain version's dense arithmetic, for any values: F after sums the sizes
// of the windows that hold a slice after the placement (b + mw > 0; under
// "partial" also b + mw < v) and fit the free slices fa.
template <bool kPartialMetric>
__device__ __forceinline__ float count_delta(const float* b, const float* v, const float* mw,
                                             int n, float fa, float fb) {
  float f_after = 0.f;
  for (int i = 0; i < n; ++i) {
    const float ba = b[i] + mw[i];
    if (ba > 0.f && (!kPartialMetric || ba < v[i]) && v[i] <= fa) f_after += v[i];
  }
  return f_after - fb;
}

// ΔF of an anchor under "blocked" from bit sets: Σ v over (the row's
// windows holding a slice, pos | the windows the anchor touches, mwb) & the
// windows of size <= the free slices after it, elig.  It equals
// count_delta<false> wherever the row's counts and the anchor's are >= 0.
__device__ __forceinline__ float blocked_delta(uint32_t pos, uint32_t mwb, uint32_t elig,
                                               const Planes& planes, float fb) {
  return window_sum((pos | mwb) & elig, planes) - fb;
}

// What a refinement computes, fixed per launch: no ΔF key, or ΔF under the
// "blocked" or the "partial" metric.
constexpr int kNoDelta = 0, kBlocked = 1, kPartial = 2;

__host__ __device__ inline int refine_mode(int keycode, int nkeys, int partial) {
  bool delta = false;  // a key is ΔF
  for (int i = 0; i < nkeys; ++i) delta |= ((keycode >> (3 * i)) & 3) == 0;
  return !delta ? kNoDelta : partial ? kPartial : kBlocked;
}

// Refine column j of one GPU row of model k for class p into `best` (ties
// keep the earlier column).  `b` holds the row's window counts, `pos` and
// `nz` its bits of b > 0 and b != 0, `elig` its windows of size <= fa, fa
// and fb its free slices after the placement and its F; `live` is false for
// a padding row.  Under "blocked", F after a placement = Σ v over
// (occupied | the anchor's windows) & eligible.
template <int kMode>
__device__ __forceinline__ void refine_col(const SpecTables& t, const float* b, uint32_t pos,
                                           uint32_t nz, uint32_t elig, const Planes& planes,
                                           int k, int p, int j, float fa, float fb, int gpu,
                                           bool live, int n, int a, int p_count,
                                           const ColOrder& cols, Cand& best) {
  const int kpj = (k * p_count + p) * a + j;
  const int mt = t.meta[kpj];
  const bool feasible = live && (mt & 1) && !((nz >> ((mt >> 1) & 31)) & 1u);
  float delta = 0.f;
  if (kMode == kBlocked) delta = blocked_delta(pos, t.mwb[kpj], elig, planes, fb);
  if (kMode == kPartial && feasible)
    delta = count_delta<true>(b, t.v + k * n, t.mw + kpj * n, n, fa, fb);
  const Cand c = {delta, fa, static_cast<float>(mt >> 6), gpu, j, true};
  best = pick(feasible && (!best.ok || col_less(cols, c, best)), c, best);
}

// The best feasible column of one GPU row (ok = false where no anchor is
// feasible), its arguments as refine_col's.
template <int kMode>
__device__ __forceinline__ Cand refine_row(const SpecTables& t, const float* b, uint32_t pos,
                                           uint32_t nz, int k, int p, float fa, float fb,
                                           int gpu, int n, int a, int p_count,
                                           const ColOrder& cols) {
  const Planes planes = planes_of(t, k);
  const uint32_t elig = windows_le(planes, fa);
  Cand best = {0.f, fa, 0.f, gpu, -1, false};
  for (int j = 0; j < a; ++j)
    refine_col<kMode>(t, b, pos, nz, elig, planes, k, p, j, fa, fb, gpu, true, n, a, p_count,
                      cols, best);
  return best;
}

// the bits of b > 0 and of b != 0 over a row's n window counts
__device__ __forceinline__ void row_bits(const float* b, int n, uint32_t& pos, uint32_t& nz) {
  pos = nz = 0;
  for (int w = 0; w < n; ++w) {
    pos |= (b[w] > 0.f ? 1u : 0u) << w;
    nz |= (b[w] != 0.f ? 1u : 0u) << w;
  }
}

// An order-preserving unsigned image of a float that is not NaN: x < y iff
// ordered(x) < ordered(y), and -0 and +0 map alike.
__device__ __forceinline__ uint32_t ordered(float x) {
  const uint32_t u = __float_as_uint(x + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The flat index gpu·A + col of the lexicographic minimum of (keys..., gpu,
// col) over the warp's candidates with ok, which lie on distinct GPUs, or -1
// where none has: one min-reduction per deciding key (RowOrder::cut), then
// one over the flat index.
__device__ __forceinline__ int warp_argmin(const RowOrder& o, const RowCand& c, int a) {
  bool live = c.ok;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < o.cut) {
      const uint32_t key = live ? ordered(c.kv[j]) : 0xffffffffu;
      const uint32_t least = __reduce_min_sync(0xffffffffu, key);  // every lane takes part
      live = live && key == least;
    }
  }
  const uint32_t flat = live ? static_cast<uint32_t>(c.gpu * a + c.col) : 0xffffffffu;
  return static_cast<int>(__reduce_min_sync(0xffffffffu, flat));
}

// ---------------------------------------------------------------------------
// select_from_base — replaces kernels/fragscore/fragscore.py::select_from_base
// (Pallas, _select_from_base_kernel/_key_tile; src/repro/kernels/fragscore/
// fragscore.py:473, call :527) and its host-side tile merge
// sim/batched.py::_lex_pick_rows of the JAX package.
//
// One replica's whole decision: feasibility (the anchor's window holds no
// occupied slice), ΔF, and the lexicographic minimum over (keys..., gpu,
// col) of the feasible candidates — the total order of the reference's
// masked refinement, whose remaining ties go to the lowest flat index
// gpu·A + col; an all-infeasible replica resolves to (0, 0, false).
//
// Bound: bytes.  At R = 500, M = 100 it reads base (3.6 MB) and the replica
// state, about 1.2 µs at 3.35 TB/s; its float work is a few MFLOP.  Its
// time is one block's chain of dependent instructions (thousands of cycles
// on an H100, with little to overlap them), so the design cuts that chain:
//  * a block per replica, a thread per GPU row (runs of kSelectRun rows);
//  * the replica's rows, free slices, F and the GPUs' models come by
//    16-byte cp.async, in flight with the tables, which every block stages
//    once (stage_spec_tables, shared with migrate_refine) with the bit sets
//    of its replica's class only: an anchor's windows by one ballot, the
//    size planes by six a model;
//  * a thread refines its row along the anchors in bit arithmetic
//    (refine_row): feasibility is one bit of the row's nonzero windows, the
//    eligible windows a bit-sliced comparison of the size planes with the
//    free slices, and ΔF under "blocked" a popcount sum;
//  * the metric and whether a key is ΔF are template arguments, and the
//    key order (row_order, col_order) is decoded on the host;
//  * the argmin is a min-reduction per deciding key over order-preserving
//    unsigned images of the keys (__reduce_min_sync), then one over the
//    flat index: in each warp, then across the block's four warps.
// Measured and dropped (PERF.md): a warp per replica (four rows a lane,
// four replicas a block, a shuffle tree, no block barrier; its lanes' rows
// one after another made the chain about four times as long), the same
// with the four rows interleaved, and two threads a row (half the anchors
// each).
// Preconditions (the launcher refuses N > 32; spec_tables builds no other
// sizes): N <= 32 windows of whole sizes in [0, 32].
// ---------------------------------------------------------------------------

constexpr int kSelectRun = kSelectThreads;  // GPU rows of a run, a thread each

// words of a select run area: the rows, their free slices, F and models
__host__ __device__ inline size_t select_run_words(int run, int n) {
  return static_cast<size_t>(run) * (n + 3);
}

// Stage rows [g0, g0 + cnt) of replica r; one cp.async group.
__device__ __forceinline__ void stage_select_run(uint32_t* area, int run, int r, int g0, int cnt,
                                                 const float* base, const int32_t* free,
                                                 const float* f, const int32_t* midx, int m,
                                                 int n) {
  const int64_t row0 = static_cast<int64_t>(r) * m + g0;
  stage_async(area, base + row0 * n, cnt * n);
  stage_async(area + run * n, free + row0, cnt);
  stage_async(area + run * n + run, f + row0, cnt);
  stage_async(area + run * n + 2 * run, midx + g0, cnt);
  cp_async_commit();
}

template <int kMode>
__global__ void __launch_bounds__(kSelectThreads) select_from_base_kernel(
    const float* __restrict__ base, const int32_t* __restrict__ free,
    const float* __restrict__ f, const int32_t* __restrict__ pid,
    const int32_t* __restrict__ midx, const float* __restrict__ V,
    const float* __restrict__ maskwin, const int32_t* __restrict__ profile_rows,
    const uint8_t* __restrict__ profile_valid,
    const int32_t* __restrict__ profile_anchors,
    const float* __restrict__ profile_mem, int32_t* __restrict__ out_gpu,
    int32_t* __restrict__ out_col, uint8_t* __restrict__ out_ok, int m, int n, int a,
    int p_count, int k_count, int run, RowOrder order, ColOrder cols) {
  extern __shared__ uint32_t ssh[];
  __shared__ RowCand warp_best[kSelectThreads / 32];
  const int r = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint32_t* area = ssh + spec_tables_words(k_count, p_count, a, n);
  stage_select_run(area, run, r, 0, min(run, m), base, free, f, midx, m, n);
  const int p = pid[r];
  // waits for every copy in flight, the first run's too
  const SpecTables t = stage_spec_tables(ssh, V, maskwin, profile_rows, profile_valid,
                                         profile_anchors, profile_mem, k_count, p_count, a, n, p);
  const float* rows = reinterpret_cast<const float*>(area);  // [run][N]
  const int* rfree = reinterpret_cast<const int*>(rows + run * n);
  const float* rf = reinterpret_cast<const float*>(rfree + run);
  const int* rmodel = reinterpret_cast<const int*>(rf + run);
  const RowCand none = {{0.f, 0.f, 0.f, 0.f}, 0, 0, false};
  RowCand best = none;  // this thread's best row
  for (int g0 = 0; g0 < m; g0 += run) {
    const int cnt = min(run, m - g0);
    if (g0 > 0) {
      __syncthreads();  // the previous run is used up
      stage_select_run(area, run, r, g0, cnt, base, free, f, midx, m, n);
      cp_async_wait<0>();
    }
    __syncthreads();  // the run (and, the first time, the derived tables) in place
    const int i = threadIdx.x;
    if (i < cnt) {
      uint32_t pos, nz;
      row_bits(rows + i * n, n, pos, nz);
      const int k = rmodel[i];
      const float fa = static_cast<float>(rfree[i]) - t.mem[k * p_count + p];
      const Cand c = refine_row<kMode>(t, rows + i * n, pos, nz, k, p, fa, rf[i], g0 + i, n, a,
                                       p_count, cols);
      const RowCand rc = row_cand(order, c);
      best = pick(c.ok && (!best.ok || row_less(order, rc, best)), rc, best);
    }
  }
  // each warp's minimum, then the warps' minimum in warp 0
  const int flat = warp_argmin(order, best, a);
  if (flat < 0 ? lane == 0 : best.ok && best.gpu * a + best.col == flat) {
    warp_best[warp] = flat < 0 ? none : best;
  }
  __syncthreads();
  if (warp > 0) return;
  const int win = warp_argmin(order, lane < kSelectThreads / 32 ? warp_best[lane] : none, a);
  if (lane == 0) {
    out_gpu[r] = win >= 0 ? win / a : 0;
    out_col[r] = win >= 0 ? win % a : 0;
    out_ok[r] = win >= 0 ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// delta_from_base — replaces kernels/fragscore/fragscore.py::delta_from_base
// (Pallas, _delta_from_base_kernel/_delta_block; src/repro/kernels/
// fragscore/fragscore.py:248, call :291) and its per-model-group dispatch
// sim/batched.py::make_delta_fn of the JAX package.
//
// The raw (R, M, A) ΔF table of each replica's request from the window
// counts, with no feasibility mask.  Bound: bytes.  At R = 500, M = 100
// (N = 18, A = 7) it reads base (3.6 MB) and the replica state and writes
// 1.4 MB, 1.61 µs at 3.35 TB/s; its float work is a few MFLOP.  Like
// select_from_base, whose staging and bit sets it shares, it is bound in
// practice by one block's chain of dependent steps.  Design:
//  * a block per run of 128 GPU rows of one replica, a thread per row:
//    R·⌈M/128⌉ blocks, so a call with R = 1 and a large M still spreads
//    over the card;
//  * the run's rows, free slices, F and models come by 16-byte cp.async
//    (stage_select_run), in flight with V, maskwin and profile_mem
//    (stage_window_tables); the block derives by ballot the windows each
//    anchor of its replica's class touches and the size planes of every
//    model (derive_window_bits);
//  * under "blocked", ΔF of a column is a popcount sum (blocked_delta,
//    shared with select_from_base and migrate_refine), exact where the
//    row's window counts and the anchor's are >= 0;
//  * "partial", a row with a negative (or NaN) count, and tables outside
//    the bit form (N > 32, a window size that is not a whole number in
//    [0, 32], a negative anchor count) take the dense count arithmetic
//    (count_delta) on the staged row, so that the kernel equals its plain
//    version on any input whose sums are exact in float32;
//  * the block's (rows × A) outputs, contiguous in (R, M, A), leave
//    through shared memory in 16-byte stores (store_tile).
// Replaced (PR 11's design): a thread per (replica, GPU) row in a flat grid,
// reading its counts at a 72-byte stride and again, with the model's V and
// maskwin rows, for every anchor, and writing 7 floats at a 28-byte stride:
// 20.7 µs at R = 500, M = 100 (PERF.md).  Measured slower (PERF.md): runs
// of 64 rows; maskwin staged in 16-byte copies (through L2 alone, and
// through L1, where select_from_base, which shares the staging, lost more
// than this kernel gained).  With no ΔF work at all a block takes most of
// the time still: the staging, the barriers and the launch dominate.
// ---------------------------------------------------------------------------

constexpr int kDeltaRun = kDeltaThreads;  // GPU rows of a block, a thread each

// the window tables, the run area (rows, free slices, F, models) and the
// output tile
inline size_t delta_smem_bytes(int run, int k_count, int p_count, int a, int n) {
  return 4 * (window_tables_words(k_count, p_count, a, n) + select_run_words(run, n) +
              tile_words(static_cast<size_t>(run) * a));
}

template <int kMode>  // kBlocked or kPartial
__global__ void __launch_bounds__(kDeltaThreads) delta_from_base_kernel(
    const float* __restrict__ base, const int32_t* __restrict__ free,
    const float* __restrict__ f, const int32_t* __restrict__ pid,
    const int32_t* __restrict__ midx, const float* __restrict__ V,
    const float* __restrict__ maskwin, const float* __restrict__ profile_mem,
    float* __restrict__ out, int m, int n, int a, int p_count, int k_count, int run, int runs) {
  extern __shared__ __align__(16) uint32_t dsh[];
  const int r = blockIdx.x / runs, g0 = (blockIdx.x % runs) * run;
  const int cnt = min(run, m - g0);
  uint32_t* area = dsh + static_cast<int>(window_tables_words(k_count, p_count, a, n));
  stage_select_run(area, run, r, g0, cnt, base, free, f, midx, m, n);
  const int p = pid[r];
  const SpecTables t = stage_window_tables(dsh, V, maskwin, profile_mem, k_count, p_count, a, n);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  derive_window_bits(t, k_count, p_count, a, n, p);
  // the bit form: N <= 32 windows of whole sizes in [0, 32], and no
  // negative count among class p's anchors
  bool form = n <= kMaxWindows;
  for (int i = threadIdx.x; i < k_count * n; i += blockDim.x) {
    const float vi = t.v[i];
    form &= vi == floorf(vi) && vi >= 0.f && vi <= 32.f;
  }
  for (int k = 0; k < k_count; ++k) {
    const float* mw = t.mw + (k * p_count + p) * a * n;
    for (int i = threadIdx.x; i < a * n; i += blockDim.x) form &= mw[i] >= 0.f;
  }
  form = __syncthreads_and(form);  // and the derived bit sets in place
  const float* rows = reinterpret_cast<const float*>(area);  // [run][N]
  const int* rfree = reinterpret_cast<const int*>(rows + run * n);
  const float* rf = reinterpret_cast<const float*>(rfree + run);
  const int* rmodel = reinterpret_cast<const int*>(rf + run);
  float* tile = reinterpret_cast<float*>(area + static_cast<int>(select_run_words(run, n)));
  float* dst = out + (static_cast<int64_t>(r) * m + g0) * a;
  const int i = threadIdx.x;
  if (i < cnt) {
    const float* b = rows + i * n;
    const int k = rmodel[i], kp = k * p_count + p;
    const float fa = static_cast<float>(rfree[i]) - t.mem[kp];
    const float fb = rf[i];
    float* o = tile + tile_lead(dst) + i * a;
    uint32_t pos = 0;  // the windows holding a slice
    bool bits = kMode == kBlocked && form;
    if (bits) {
#pragma unroll 6
      for (int w = 0; w < n; ++w) {
        pos |= (b[w] > 0.f ? 1u : 0u) << w;
        bits &= b[w] >= 0.f;
      }
    }
    if (bits) {
      const Planes planes = planes_of(t, k);
      const uint32_t elig = windows_le(planes, fa);
#pragma unroll 7
      for (int j = 0; j < a; ++j) o[j] = blocked_delta(pos, t.mwb[kp * a + j], elig, planes, fb);
    } else {
      for (int j = 0; j < a; ++j)
        o[j] = count_delta<kMode == kPartial>(b, t.v + k * n, t.mw + (kp * a + j) * n, n, fa, fb);
    }
  }
  __syncthreads();
  store_tile(dst, tile, cnt * a);
}

// ---------------------------------------------------------------------------
// migrate_refine — replaces kernels/fragscore/fragscore.py::migrate_refine
// (Pallas, _migrate_refine_kernel: _class_pass_impl and _victim_pass_impl
// with _refine_cols, _tile_top2 and _delta_rows; src/repro/kernels/
// fragscore/fragscore.py:670, calls :755 and :819) and its host-side merge
// sim/batched.py::_merge_top2 of the JAX package.
//
// Both refinements of the factored defrag search in ONE launch with two
// block ranges; the wrapper's `launches` counts that one launch.  Every
// block first stages the tables of every (model, class) in shared memory
// once (stage_spec_tables), with cp.async: window sizes, the anchors' window
// counts, slice demand, and one word per anchor (validity, window row,
// anchor value); from them it derives bit sets over the N <= 32 windows:
// the windows each anchor touches, the windows of size <= t for t = -1..32,
// and the bit planes of the window sizes.
//  * Blocks [0, R), pass 0: one block per replica for all P <= 8 classes.
//    The replica's (M, N) rows are staged in runs of 256 with cp.async, and
//    each row's occupied-window bits are taken once.  Every thread refines
//    (class, row) pairs along the anchors (feasibility, ΔF, keys; ties to
//    the first column); then warp p folds class p's rows into per-lane
//    top-2 lists by (keys..., gpu) and merges them in a shuffle tree, two
//    comparisons a merge on the rows' sort keys.
//  * Blocks [R, R + B1), pass 1: B1 blocks (as many as the card holds at
//    once) walk the R·C victims in runs of 256, the next run's patched rows
//    and per-victim scalars in flight (cp.async, two buffers) while a
//    thread per victim refines its row along the anchors from the tables in
//    shared memory (nothing is gathered per victim from device memory),
//    keeping the first column on ties.  (A group of lanes per victim, one
//    per anchor, was built first and measured slower: PERF.md.)
// ΔF under the "blocked" metric is a sum of window sizes over bit sets:
// F after = Σ v over (occupied | the anchor's windows) & eligible, eligible
// meaning v <= free slices after the placement.  Window sizes are whole
// slices, at most 32, so eligibility is one of 34 bit sets of the model
// and a sum is Σ_q 2^q·popcount(bits & plane q).  Every key is an integer
// held in float32, so each sum is exact in any order and the kernel equals
// its plain version bit for bit.  The "partial" metric scores each window
// from the counts (N steps per anchor).
// Masked outputs: pass 0 writes gpu = col = 0 and keys = 1e9 where no row
// is feasible (ok = 0); pass 1 writes column 0 and the UNMASKED keys of
// column 0 where no anchor is feasible — the plain version's conventions.
//
// Bound: bytes.  At R = 500, M = 100, C_live = 800, N = 18, L = 3 a call
// reads base2 (28.8 MB), five per-victim scalars (8 MB) and the replica
// state (4 MB), and writes 6.8 MB: about 48 MB, 14 µs at 3.35 TB/s, while
// its float work (a few hundred MFLOP) takes a few µs at 67 TFLOP/s.  The
// tables are read from L2 once per block; base2 is read once, in order.
// ---------------------------------------------------------------------------

constexpr int kMigrateRun = 256;  // rows of a pass-0 run, victims of a pass-1 run
constexpr int kMigrateClasses = 8;  // demand classes pass 0 takes (a warp each)

// the tables, then the run area: pass 0's rows, five words per row and its
// refined columns (three words per class and row), or pass 1's two run
// buffers of rows and five words per victim
inline size_t migrate_smem_bytes(int k_count, int p_count, int a, int n) {
  const size_t pass0 = n + 5 + 3 * kMigrateClasses, pass1 = 2 * (n + 5);
  return 4 * (spec_tables_words(k_count, p_count, a, n) +
              static_cast<size_t>(kMigrateRun) * (pass0 > pass1 ? pass0 : pass1));
}

// Pass 0: block r refines every GPU row of replica r for every class.
template <int kMode>
__device__ __forceinline__ void migrate_class_pass(
    const SpecTables& t, uint32_t* run, int r, const float* __restrict__ base,
    const int32_t* __restrict__ free, const float* __restrict__ f,
    const int32_t* __restrict__ midx, int32_t* __restrict__ out_g1,
    uint8_t* __restrict__ out_ok1, int32_t* __restrict__ out_a1, float* __restrict__ out_k1,
    int32_t* __restrict__ out_g2, uint8_t* __restrict__ out_ok2, int32_t* __restrict__ out_a2,
    float* __restrict__ out_k2, int m, int n, int a, int p_count, int nkeys, int keycode,
    const ColOrder& cols) {
  float* rows = reinterpret_cast<float*>(run);  // [run][N]
  int* rfree = reinterpret_cast<int*>(rows + kMigrateRun * n);
  float* rf = reinterpret_cast<float*>(rfree + kMigrateRun);
  int* rmodel = reinterpret_cast<int*>(rf + kMigrateRun);
  uint32_t* rpos = reinterpret_cast<uint32_t*>(rmodel + kMigrateRun);  // bits of b > 0
  uint32_t* rnz = rpos + kMigrateRun;                                   // bits of b != 0
  // each (class, row)'s refined column: ΔF, anchor value, column (-1: none)
  float* bdelta = reinterpret_cast<float*>(rnz + kMigrateRun);          // [P][run]
  float* banc = bdelta + kMigrateClasses * kMigrateRun;
  int* bcol = reinterpret_cast<int*>(banc + kMigrateClasses * kMigrateRun);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const RowOrder order = row_order(keycode, nkeys);
  const RowCand none = {{0.f, 0.f, 0.f, 0.f}, 0, 0, false};
  RowCand c1 = none, c2 = none;  // this lane's top-2 of class p (warp p)
  for (int g0 = 0; g0 < m; g0 += kMigrateRun) {
    const int cnt = min(kMigrateRun, m - g0);
    __syncthreads();  // the previous run is used up
    const int64_t row0 = static_cast<int64_t>(r) * m + g0;
    stage_async(rows, base + row0 * n, cnt * n);
    stage_async(rfree, free + row0, cnt);
    stage_async(rf, f + row0, cnt);
    stage_async(rmodel, midx + g0, cnt);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) row_bits(rows + i * n, n, rpos[i], rnz[i]);
    __syncthreads();
    // refine every (class, row) pair along its anchors; ties to the first column
    for (int q = threadIdx.x; q < p_count * cnt; q += blockDim.x) {
      const int p = q / cnt, i = q % cnt;
      const int k = rmodel[i];
      const float fa = static_cast<float>(rfree[i]) - t.mem[k * p_count + p];
      const Cand best = refine_row<kMode>(t, rows + i * n, rpos[i], rnz[i], k, p, fa, rf[i],
                                          g0 + i, n, a, p_count, cols);
      bdelta[p * kMigrateRun + i] = best.delta;
      banc[p * kMigrateRun + i] = best.anc;
      bcol[p * kMigrateRun + i] = best.ok ? best.col : -1;
    }
    __syncthreads();
    if (warp < p_count) {  // warp p folds class p's rows into its lanes' top-2
      const int p = warp;
      for (int i = lane; i < cnt; i += 32) {
        const int col = bcol[p * kMigrateRun + i];
        const int k = rmodel[i];
        const Cand c = {bdelta[p * kMigrateRun + i],
                        static_cast<float>(rfree[i]) - t.mem[k * p_count + p],
                        banc[p * kMigrateRun + i], g0 + i, col, col >= 0};
        top2_merge(order, row_cand(order, c), none, c1, c2);
      }
    }
  }
  if (warp >= p_count) return;
  // the warp's lists, merged in a shuffle tree
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const RowCand o1 = shfl_down(c1, off);
    const RowCand o2 = shfl_down(c2, off);
    if (lane + off < 32) top2_merge(order, o1, o2, c1, c2);
  }
  if (lane == 0) {  // lane 0 holds the class's top-2
    const int64_t o = static_cast<int64_t>(r) * p_count + warp;
    out_g1[o] = c1.ok ? c1.gpu : 0;
    out_ok1[o] = c1.ok ? 1 : 0;
    out_a1[o] = c1.ok ? c1.col : 0;
    out_g2[o] = c2.ok ? c2.gpu : 0;
    out_ok2[o] = c2.ok ? 1 : 0;
    out_a2[o] = c2.ok ? c2.col : 0;
    for (int i = 0; i < nkeys; ++i) {
      out_k1[o * nkeys + i] = c1.ok ? row_key(order, c1, i) : kBig;
      out_k2[o * nkeys + i] = c2.ok ? row_key(order, c2, i) : kBig;
    }
  }
}

// Refine one victim's patched row `b` along its anchors: the best feasible
// column, or column 0 and its unmasked keys where none is.
template <int kMode>
__device__ __forceinline__ void score_victim(
    const SpecTables& t, const float* b, int k, int p, int free_slices, float fb, int gpu,
    int64_t gi, int32_t* __restrict__ out_ap, uint8_t* __restrict__ out_okp,
    float* __restrict__ out_kp, int n, int a, int p_count, int nkeys, int keycode,
    const ColOrder& cols) {
  const float fa = static_cast<float>(free_slices) - t.mem[k * p_count + p];
  uint32_t pos, nz;
  row_bits(b, n, pos, nz);
  const Planes planes = planes_of(t, k);
  const uint32_t elig = windows_le(planes, fa);
  Cand best = {0.f, fa, 0.f, gpu, 0, false}, col0 = best;
  for (int j = 0; j < a; ++j) {
    const int kpj = (k * p_count + p) * a + j;
    const int mt = t.meta[kpj];
    const bool feasible = (mt & 1) && !((nz >> ((mt >> 1) & 31)) & 1u);
    if (!feasible && j != 0) continue;  // column 0 is the all-infeasible fallback
    float delta = 0.f;
    if (kMode == kPartial) delta = count_delta<true>(b, t.v + k * n, t.mw + kpj * n, n, fa, fb);
    if (kMode == kBlocked) delta = blocked_delta(pos, t.mwb[kpj], elig, planes, fb);
    const Cand c = {delta, fa, static_cast<float>(mt >> 6), gpu, j, feasible};
    col0 = pick(j == 0, c, col0);
    best = pick(feasible && (!best.ok || col_less(cols, c, best)), c, best);
  }
  out_ap[gi] = best.ok ? best.col : 0;
  out_okp[gi] = best.ok ? 1 : 0;
  const Cand out = pick(best.ok, best, col0);
  for (int q = 0; q < nkeys; ++q) out_kp[gi * nkeys + q] = key_of(keycode, q, out);
}

// Stage run `run_i` of the victims into `area`: rows, then model, class,
// free slices, F and GPU of each victim; one cp.async group either way.
__device__ __forceinline__ void stage_victims(uint32_t* area, int64_t run_i, int64_t runs,
                                              int64_t total, const float* base2,
                                              const int32_t* free2, const float* f2,
                                              const int32_t* rg, const int32_t* rp,
                                              const int32_t* kc, int n) {
  if (run_i < runs) {
    const int64_t first = run_i * kMigrateRun;
    const int cnt = static_cast<int>(min(static_cast<int64_t>(kMigrateRun), total - first));
    uint32_t* scal = area + kMigrateRun * n;
    stage_async(area, base2 + first * n, cnt * n);
    stage_async(scal, kc + first, cnt);
    stage_async(scal + kMigrateRun, rp + first, cnt);
    stage_async(scal + 2 * kMigrateRun, free2 + first, cnt);
    stage_async(scal + 3 * kMigrateRun, f2 + first, cnt);
    stage_async(scal + 4 * kMigrateRun, rg + first, cnt);
  }
  cp_async_commit();
}

// Pass 1: this block's runs of the R·C victims, a thread per victim.
template <int kMode>
__device__ __forceinline__ void migrate_victim_pass(
    const SpecTables& t, uint32_t* run, int64_t block, int64_t blocks, int64_t total,
    const float* __restrict__ base2, const int32_t* __restrict__ free2,
    const float* __restrict__ f2, const int32_t* __restrict__ rg,
    const int32_t* __restrict__ rp, const int32_t* __restrict__ kc,
    int32_t* __restrict__ out_ap, uint8_t* __restrict__ out_okp, float* __restrict__ out_kp,
    int n, int a, int p_count, int nkeys, int keycode, const ColOrder& cols) {
  const int64_t runs = (total + kMigrateRun - 1) / kMigrateRun;
  const int buf_words = kMigrateRun * (n + 5);
  stage_victims(run, block, runs, total, base2, free2, f2, rg, rp, kc, n);
  int buf = 0;
  for (int64_t run_i = block; run_i < runs; run_i += blocks, buf ^= 1) {
    // the next run flies while this one is scored
    stage_victims(run + (buf ^ 1) * buf_words, run_i + blocks, runs, total, base2, free2, f2,
                  rg, rp, kc, n);
    cp_async_wait<1>();
    __syncthreads();
    const int64_t first = run_i * kMigrateRun;
    const int cnt = static_cast<int>(min(static_cast<int64_t>(kMigrateRun), total - first));
    const float* rows = reinterpret_cast<const float*>(run + buf * buf_words);  // [run][N]
    const int* vmodel = reinterpret_cast<const int*>(rows + kMigrateRun * n);
    const int* vclass = vmodel + kMigrateRun;
    const int* vfree = vclass + kMigrateRun;
    const float* vf = reinterpret_cast<const float*>(vfree + kMigrateRun);
    const int* vgpu = reinterpret_cast<const int*>(vf + kMigrateRun);
    const int i = threadIdx.x;
    if (i < cnt) score_victim<kMode>(t, rows + i * n, vmodel[i], vclass[i], vfree[i], vf[i], vgpu[i],
                              first + i, out_ap, out_okp, out_kp, n, a, p_count, nkeys, keycode,
                              cols);
    __syncthreads();  // the next iteration prefetches into this buffer
  }
}

template <int kMode>
__global__ void __launch_bounds__(kMigrateThreads, 4) migrate_refine_kernel(
    const float* __restrict__ base, const int32_t* __restrict__ free,
    const float* __restrict__ f, const float* __restrict__ base2,
    const int32_t* __restrict__ free2, const float* __restrict__ f2,
    const int32_t* __restrict__ rg, const int32_t* __restrict__ rp,
    const int32_t* __restrict__ kc, const int32_t* __restrict__ midx,
    const float* __restrict__ V, const float* __restrict__ maskwin,
    const int32_t* __restrict__ profile_rows,
    const uint8_t* __restrict__ profile_valid,
    const int32_t* __restrict__ profile_anchors,
    const float* __restrict__ profile_mem, int32_t* __restrict__ out_g1,
    uint8_t* __restrict__ out_ok1, int32_t* __restrict__ out_a1,
    float* __restrict__ out_k1, int32_t* __restrict__ out_g2,
    uint8_t* __restrict__ out_ok2, int32_t* __restrict__ out_a2,
    float* __restrict__ out_k2, int32_t* __restrict__ out_ap,
    uint8_t* __restrict__ out_okp, float* __restrict__ out_kp, int r_count, int m,
    int c_count, int n, int a, int p_count, int k_count, int nkeys, int keycode) {
  extern __shared__ uint32_t msh[];
  const ColOrder cols = col_order(keycode, nkeys);
  const SpecTables t = stage_spec_tables(msh, V, maskwin, profile_rows, profile_valid,
                                         profile_anchors, profile_mem, k_count, p_count, a, n, -1);
  uint32_t* run = msh + spec_tables_words(k_count, p_count, a, n);
  if (static_cast<int>(blockIdx.x) < r_count) {
    migrate_class_pass<kMode>(t, run, blockIdx.x, base, free, f, midx, out_g1, out_ok1, out_a1,
                       out_k1, out_g2, out_ok2, out_a2, out_k2, m, n, a, p_count, nkeys,
                       keycode, cols);
  } else {
    migrate_victim_pass<kMode>(t, run, blockIdx.x - r_count, gridDim.x - r_count,
                        static_cast<int64_t>(r_count) * c_count, base2, free2, f2, rg, rp, kc,
                        out_ap, out_okp, out_kp, n, a, p_count, nkeys, keycode, cols);
  }
}

}  // namespace

extern "C" {

int fragscore_launch(const void* occ, const void* w, const void* v, void* out,
                     int q, int n, int s, int partial, int device,
                     void* stream) {
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  if (q <= 0 || s > kMaxSlices) return cudaErrorInvalidValue;
  const int blocks = (q + kFragThreads - 1) / kFragThreads;
  const size_t smem = 4 * (static_cast<size_t>(n) * s + n);
  fragscore_kernel<<<blocks, kFragThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(occ), static_cast<const float*>(w),
      static_cast<const float*>(v), static_cast<float*>(out), q, n, s, partial);
  return cudaGetLastError();
}

int mfi_delta_launch(const void* occ, const void* w, const void* v,
                     const void* profile_masks, const void* profile_valid,
                     void* out, int m, int n, int s, int a, int partial,
                     int device, void* stream) {
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  cudaError_t err = cudaSuccess;
  if (m <= 0 || a <= 0 || n < 0 || s < 0 || s > kMaxSlices) return cudaErrorInvalidValue;
  const auto kernel = partial ? mfi_delta_kernel<true> : mfi_delta_kernel<false>;
  const size_t smem = mfi_smem_bytes(n, s, a);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMfiThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // as many blocks as the card holds at once, each walking tiles of rows
  const int64_t tiles = (static_cast<int64_t>(m) + kMfiThreads - 1) / kMfiThreads;
  const int64_t resident = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  kernel<<<static_cast<int>(tiles < resident ? tiles : resident), kMfiThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(occ), static_cast<const float*>(w),
      static_cast<const float*>(v), static_cast<const float*>(profile_masks),
      static_cast<const float*>(profile_valid), static_cast<float*>(out), m, n, s, a, tiles);
  return cudaGetLastError();
}

int delta_from_base_launch(const void* base, const void* free, const void* f,
                           const void* pid, const void* midx, const void* V,
                           const void* maskwin, const void* profile_mem,
                           void* out, int r_count, int m, int n, int a,
                           int p_count, int k_count, int partial, int device, void* stream) {
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  cudaError_t err = cudaSuccess;
  if (r_count <= 0 || m <= 0 || n < 0 || a < 0 || p_count <= 0 || k_count <= 0)
    return cudaErrorInvalidValue;
  const int run = m < kDeltaRun ? (m + 3) & ~3 : kDeltaRun;  // 16-byte aligned areas
  const int runs = (m + run - 1) / run;
  if (static_cast<int64_t>(r_count) * runs > INT_MAX) return cudaErrorInvalidValue;
  const auto kernel = partial ? delta_from_base_kernel<kPartial> : delta_from_base_kernel<kBlocked>;
  const size_t smem = delta_smem_bytes(run, k_count, p_count, a, n);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<r_count * runs, kDeltaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(base), static_cast<const int32_t*>(free),
      static_cast<const float*>(f), static_cast<const int32_t*>(pid),
      static_cast<const int32_t*>(midx), static_cast<const float*>(V),
      static_cast<const float*>(maskwin), static_cast<const float*>(profile_mem),
      static_cast<float*>(out), m, n, a, p_count, k_count, run, runs);
  return cudaGetLastError();
}

int select_from_base_launch(const void* base, const void* free, const void* f,
                            const void* pid, const void* midx, const void* V,
                            const void* maskwin, const void* profile_rows,
                            const void* profile_valid,
                            const void* profile_anchors,
                            const void* profile_mem, void* out_gpu,
                            void* out_col, void* out_ok, int r_count, int m,
                            int n, int a, int p_count, int k_count, int nkeys,
                            int keycode, int partial, int device,
                            void* stream) {
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  cudaError_t err = cudaSuccess;
  // window bits fit one 32-bit word
  if (r_count <= 0 || m < 0 || nkeys < 0 || nkeys > kMaxKeys || n <= 0 || n > kMaxWindows ||
      a <= 0 || p_count <= 0 || k_count <= 0) {
    return cudaErrorInvalidValue;
  }
  const int mode = refine_mode(keycode, nkeys, partial);
  const auto kernel = mode == kNoDelta   ? select_from_base_kernel<kNoDelta>
                      : mode == kBlocked ? select_from_base_kernel<kBlocked>
                                         : select_from_base_kernel<kPartial>;
  const int run = m < kSelectRun ? (m + 3) & ~3 : kSelectRun;  // 16-byte aligned areas
  const size_t smem = 4 * (spec_tables_words(k_count, p_count, a, n) + select_run_words(run, n));
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<r_count, kSelectThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(base), static_cast<const int32_t*>(free),
      static_cast<const float*>(f), static_cast<const int32_t*>(pid),
      static_cast<const int32_t*>(midx), static_cast<const float*>(V),
      static_cast<const float*>(maskwin),
      static_cast<const int32_t*>(profile_rows),
      static_cast<const uint8_t*>(profile_valid),
      static_cast<const int32_t*>(profile_anchors),
      static_cast<const float*>(profile_mem), static_cast<int32_t*>(out_gpu),
      static_cast<int32_t*>(out_col), static_cast<uint8_t*>(out_ok), m, n, a, p_count, k_count,
      run, row_order(keycode, nkeys), col_order(keycode, nkeys));
  return cudaGetLastError();
}

int migrate_refine_launch(
    const void* base, const void* free, const void* f, const void* base2,
    const void* free2, const void* f2, const void* rg, const void* rp,
    const void* kc, const void* midx, const void* V, const void* maskwin,
    const void* profile_rows, const void* profile_valid,
    const void* profile_anchors, const void* profile_mem, void* out_g1,
    void* out_ok1, void* out_a1, void* out_k1, void* out_g2, void* out_ok2,
    void* out_a2, void* out_k2, void* out_ap, void* out_okp, void* out_kp,
    int r_count, int m, int c_count, int n, int a, int p_count, int k_count,
    int nkeys, int keycode, int partial, int device, void* stream) {
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  cudaError_t err = cudaSuccess;
  // window bits fit one 32-bit word; a class takes one warp of pass 0
  if (r_count <= 0 || m <= 0 || c_count < 0 || nkeys < 0 || nkeys > kMaxKeys || n <= 0 ||
      n > kMaxWindows || a <= 0 || p_count <= 0 || p_count > kMigrateClasses) {
    return cudaErrorInvalidValue;
  }
  const int mode = refine_mode(keycode, nkeys, partial);
  const auto kernel = mode == kNoDelta   ? migrate_refine_kernel<kNoDelta>
                      : mode == kBlocked ? migrate_refine_kernel<kBlocked>
                                         : migrate_refine_kernel<kPartial>;
  const size_t smem = migrate_smem_bytes(k_count, p_count, a, n);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMigrateThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // pass 1: as many blocks as the card holds at once, each walking runs
  const int64_t runs = (static_cast<int64_t>(r_count) * c_count + kMigrateRun - 1) / kMigrateRun;
  const int64_t pass1 = runs < static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms
                            ? runs
                            : static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  if (r_count + pass1 > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<static_cast<int>(r_count + pass1), kMigrateThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(base), static_cast<const int32_t*>(free),
      static_cast<const float*>(f), static_cast<const float*>(base2),
      static_cast<const int32_t*>(free2), static_cast<const float*>(f2),
      static_cast<const int32_t*>(rg), static_cast<const int32_t*>(rp),
      static_cast<const int32_t*>(kc), static_cast<const int32_t*>(midx),
      static_cast<const float*>(V), static_cast<const float*>(maskwin),
      static_cast<const int32_t*>(profile_rows),
      static_cast<const uint8_t*>(profile_valid),
      static_cast<const int32_t*>(profile_anchors),
      static_cast<const float*>(profile_mem), static_cast<int32_t*>(out_g1),
      static_cast<uint8_t*>(out_ok1), static_cast<int32_t*>(out_a1),
      static_cast<float*>(out_k1), static_cast<int32_t*>(out_g2),
      static_cast<uint8_t*>(out_ok2), static_cast<int32_t*>(out_a2),
      static_cast<float*>(out_k2), static_cast<int32_t*>(out_ap),
      static_cast<uint8_t*>(out_okp), static_cast<float*>(out_kp), r_count, m,
      c_count, n, a, p_count, k_count, nkeys, keycode);
  return cudaGetLastError();
}

}  // extern "C"
