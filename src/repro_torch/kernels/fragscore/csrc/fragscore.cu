// Fragmentation-scoring kernels of the batched Monte-Carlo engine and of the
// single-decision scheduler API (mfi_delta), written by hand for Hopper
// (sm_90a), behind a plain C interface loaded with ctypes
// (repro_torch/kernels/build.py builds this file with nvcc at first use).
//
// Every launcher runs its kernel on the stream it is given, never
// synchronises, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
//
// Every score is an integer held in float32 (window sizes <= 12 slices,
// sums <= 31 windows), so each kernel reproduces its plain torch version
// (repro_torch/kernels/fragscore/ref.py) bit for bit in any summation order.
//
// Shapes on the engine's main path (M = 100 A100-80GB GPUs, R = 500
// replicas): N = 18 windows, A = 7 anchors, S = 8 slices.  The first three
// kernels move a few megabytes a call at most and do a few hundred
// thousand float operations, so on an H100 each is bound by its launch
// (a few microseconds), not by bytes or operations; the designs keep one
// launch per engine stage and read every table once per block.
// migrate_refine reads ~40 MB a call, so bytes bound it (see its note).
// mfi_delta serves one scheduling decision over up to 10^6 GPUs, where its
// bytes bound it (see its note).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kMaxSlices = 16;  // S <= 12 (the H200-141GB geometry)
constexpr int kMaxKeys = 8;     // effective scoring keys of a fused spec
constexpr int kFragThreads = 256;
constexpr int kDeltaThreads = 256;
constexpr int kSelectThreads = 128;
constexpr int kMigrateThreads = 128;
constexpr float kBig = 1e9f;  // the masked-key sentinel (ref.BIG)
constexpr float kMfiBig = 1e30f;  // mfi_delta's infeasibility sentinel (ref.MFI_BIG)

// ---------------------------------------------------------------------------
// fragscore — replaces kernels/fragscore/fragscore.py::fragscore (Pallas,
// _fragscore_kernel/_score_block) of the JAX package.
//
// F(m) of each occupancy row: window counts occ · Wᵀ, the blocked/partial
// predicate, the eligibility of each window against the row's free slices,
// and the eligible sum.  Bound: launch.  On the main path a call scores the
// R·E expire rows (500·12·8 int32 = 192 KB in, 24 KB out) or the R commit
// rows, i.e. well under 0.1 µs of HBM time at 3.35 TB/s.  Design: one
// thread per row (no cross-thread reduction at all), the (N, S) window
// table staged once per block in shared memory, the row held in registers.
// ---------------------------------------------------------------------------

// F of one occupancy row x (its slices past s are 0), used = the row's sum.
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

__global__ void __launch_bounds__(kFragThreads) fragscore_kernel(
    const int32_t* __restrict__ occ, const float* __restrict__ w,
    const float* __restrict__ v, float* __restrict__ out, int q, int n, int s,
    int partial) {
  extern __shared__ float sh[];
  float* sw = sh;
  float* sv = sh + n * s;
  for (int i = threadIdx.x; i < n * s; i += blockDim.x) sw[i] = w[i];
  for (int i = threadIdx.x; i < n; i += blockDim.x) sv[i] = v[i];
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= q) return;
  const int32_t* o = occ + static_cast<int64_t>(row) * s;
  float x[kMaxSlices];
  float used = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxSlices; ++j) {
    x[j] = j < s ? static_cast<float>(o[j]) : 0.f;
    used += x[j];
  }
  out[row] = score_row(x, used, sw, sv, n, s, partial);
}

// ---------------------------------------------------------------------------
// mfi_delta — replaces kernels/fragscore/fragscore.py::mfi_delta (Pallas,
// _mfi_delta_kernel/_score_block; src/repro/kernels/fragscore/fragscore.py:133)
// of the JAX package: the ΔF table of one scheduling decision.
//
// For every GPU row of raw occupancy occ (M, S) and every anchor k of the
// requested class: F(min(occ + mask_k, 1)) - F(occ) where the anchor is real
// and its window holds no occupied slice, exactly 1e30 otherwise.  The
// reference's float arithmetic is kept (window counts as float dot products,
// every slice clipped to 1 in the dry run), so the kernel gives its plain
// version's answer for any occupancy whose sums are exact in float32.
//
// Bound: bytes.  Per row it reads S int32 and writes A floats (M = 10^6
// A100-80GB rows, 1g.10gb: 32 MB + 28 MB, 18 µs at 3.35 TB/s).  On 0/1
// occupancy the function needs fewer operations than this kernel does: the
// row's window counts once (2·N·S), F(occ) from them (4·N) and, per
// feasible anchor, the counts plus the anchor's fixed mask·W row (N) and F
// after (4·N): ~0.73 GFLOP at 45 % fill, 11 µs at 67 TFLOP/s.  This kernel instead rescores
// every feasible dry run from its slices, N·(2·S + 3) per anchor.  At
// M <= 10^4 the launch (a few µs) bounds it.  Design: one thread per row,
// the row in registers (no cross-thread reduction), the model's window
// table and the class's anchor masks staged once per block in shared memory
// (at most N = 31, S = 12, A = 12: 2.2 KB), F of a dry run computed only
// for a feasible anchor.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kFragThreads) mfi_delta_kernel(
    const int32_t* __restrict__ occ, const float* __restrict__ w,
    const float* __restrict__ v, const float* __restrict__ pm,
    const float* __restrict__ pv, float* __restrict__ out, int m, int n, int s,
    int a, int partial) {
  extern __shared__ float sh[];
  float* sw = sh;
  float* sv = sw + n * s;
  float* spm = sv + n;
  float* spv = spm + a * s;
  for (int i = threadIdx.x; i < n * s; i += blockDim.x) sw[i] = w[i];
  for (int i = threadIdx.x; i < n; i += blockDim.x) sv[i] = v[i];
  for (int i = threadIdx.x; i < a * s; i += blockDim.x) spm[i] = pm[i];
  for (int i = threadIdx.x; i < a; i += blockDim.x) spv[i] = pv[i];
  __syncthreads();
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= m) return;
  const int32_t* o = occ + row * s;
  float x[kMaxSlices];
  float used = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxSlices; ++j) {
    x[j] = j < s ? static_cast<float>(o[j]) : 0.f;
    used += x[j];
  }
  const float fb = score_row(x, used, sw, sv, n, s, partial);
  float* dst = out + row * a;
  for (int k = 0; k < a; ++k) {
    const float* mk = spm + k * s;
    float overlap = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSlices; ++j) {
      if (j < s) overlap += x[j] * mk[j];
    }
    float delta = kMfiBig;
    if (overlap == 0.f && spv[k] > 0.f) {
      float h[kMaxSlices];
      float hused = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxSlices; ++j) {
        h[j] = j < s ? fminf(x[j] + mk[j], 1.f) : 0.f;
        hused += h[j];
      }
      delta = score_row(h, hused, sw, sv, n, s, partial) - fb;
    }
    dst[k] = delta;
  }
}

// The ΔF arithmetic shared by delta_from_base and select_from_base.  Window
// counts after a feasible placement are base + mw (the anchor's window is
// disjoint from the current occupancy).  "blocked" splits F_after into the
// windows that are already occupied (occupied_sum, once per row) and the
// ones only the anchor makes occupied (the "cross" term, a plain fp32 loop
// over N); "partial" is the dense per-window predicate.

__device__ __forceinline__ float occupied_sum(const float* b, const float* v,
                                              int n, float free_after) {
  float s = 0.f;
  for (int i = 0; i < n; ++i) {
    if (b[i] > 0.f && v[i] <= free_after) s += v[i];
  }
  return s;
}

__device__ __forceinline__ float anchor_delta(const float* b, const float* v,
                                              const float* mw, int n,
                                              float free_after, float s_occ,
                                              float fb, int partial) {
  if (partial) {
    float fa = 0.f;
    for (int i = 0; i < n; ++i) {
      const float ba = b[i] + mw[i];
      if (ba > 0.f && ba < v[i] && v[i] <= free_after) fa += v[i];
    }
    return fa - fb;
  }
  float cross = 0.f;
  for (int i = 0; i < n; ++i) {
    if (!(b[i] > 0.f) && v[i] <= free_after && mw[i] > 0.f) cross += v[i];
  }
  return (s_occ + cross) - fb;
}

// ---------------------------------------------------------------------------
// delta_from_base — replaces kernels/fragscore/fragscore.py::delta_from_base
// (Pallas, _delta_from_base_kernel/_delta_block) of the JAX package.
//
// The raw (R, M, A) ΔF table of each replica's request from the window
// counts.  Bound: launch.  At R = 500, M = 100 it reads base (3.6 MB) and
// writes 1.4 MB, about 1.5 µs of HBM time.  Design: one thread per
// (replica, GPU) row writes that row's A outputs; the replica's demand
// class and the row's model are gathered in-kernel, which replaces the
// per-replica operand gathers and the per-model-group launches of the
// TPU version with a single launch for any fleet.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kDeltaThreads) delta_from_base_kernel(
    const float* __restrict__ base, const int32_t* __restrict__ free,
    const float* __restrict__ f, const int32_t* __restrict__ pid,
    const int32_t* __restrict__ midx, const float* __restrict__ V,
    const float* __restrict__ maskwin, const float* __restrict__ profile_mem,
    float* __restrict__ out, int r_count, int m, int n, int a, int p_count,
    int partial) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(r_count) * m) return;
  const int r = static_cast<int>(t / m);
  const int g = static_cast<int>(t % m);
  const int k = midx[g];
  const int p = pid[r];
  const float* b = base + t * n;
  const float* v = V + static_cast<int64_t>(k) * n;
  const float* mw = maskwin + (static_cast<int64_t>(k) * p_count + p) * a * n;
  const float free_after = static_cast<float>(free[t]) - profile_mem[k * p_count + p];
  const float fb = f[t];
  const float s_occ = partial ? 0.f : occupied_sum(b, v, n, free_after);
  float* o = out + t * a;
  for (int j = 0; j < a; ++j) {
    o[j] = anchor_delta(b, v, mw + static_cast<int64_t>(j) * n, n, free_after,
                        s_occ, fb, partial);
  }
}

// ---------------------------------------------------------------------------
// select_from_base — replaces kernels/fragscore/fragscore.py::select_from_base
// (Pallas, _select_from_base_kernel/_key_tile) and its host-side tile merge
// sim/batched.py::_lex_pick_rows of the JAX package.
//
// One replica's whole decision: feasibility (the anchor's window holds no
// occupied slice), ΔF, and the lexicographic minimum over
// (keys..., gpu, col) of the feasible candidates — the total order of the
// reference's masked refinement, whose remaining ties go to the lowest flat
// index gpu·A + col.  Bound: launch.  At R = 500, M = 100 it reads base
// (3.6 MB, about 1.1 µs at 3.35 TB/s) and writes 9 bytes per replica.
// Design: one block per replica (grid R), threads striding over the GPU
// rows, the replica's demand-class tables of every model staged in shared
// memory, each thread's best candidate kept in registers, then a
// warp-shuffle and a shared-memory reduction.  No host merge and one launch
// for a mixed fleet; an all-infeasible replica resolves to (0, 0, false).
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool lex_less(const float (&ka)[kMaxKeys], int fa,
                                         const float (&kb)[kMaxKeys], int fb,
                                         int nkeys) {
#pragma unroll
  for (int i = 0; i < kMaxKeys; ++i) {
    if (i < nkeys) {
      if (ka[i] < kb[i]) return true;
      if (ka[i] > kb[i]) return false;
    }
  }
  return fa < fb;
}

// One demand class's tables of every model, staged in shared memory.
struct ClassTables {
  const float* v;    // (K, N) window sizes
  const float* mw;   // (K, A, N) slices each anchor adds per window
  const float* mem;  // (K,) slice demand
  const int* row;    // (K, A) window row of each anchor
  const int* anc;    // (K, A) anchor value
  const int* val;    // (K, A) anchor validity
};

inline size_t class_tables_floats(int k_count, int n, int a) {
  return static_cast<size_t>(k_count) * n + static_cast<size_t>(k_count) * a * n +
         k_count + 3 * static_cast<size_t>(k_count) * a;
}

// Stage class p's tables into sh; ends with a block barrier.
__device__ ClassTables stage_class_tables(
    float* sh, const float* __restrict__ V, const float* __restrict__ maskwin,
    const int32_t* __restrict__ profile_rows,
    const uint8_t* __restrict__ profile_valid,
    const int32_t* __restrict__ profile_anchors,
    const float* __restrict__ profile_mem, int p, int k_count, int p_count, int n,
    int a) {
  float* sv = sh;
  float* smw = sv + k_count * n;
  float* smem = smw + k_count * a * n;
  int* srow = reinterpret_cast<int*>(smem + k_count);
  int* sanc = srow + k_count * a;
  int* sval = sanc + k_count * a;
  for (int i = threadIdx.x; i < k_count * n; i += blockDim.x) sv[i] = V[i];
  for (int i = threadIdx.x; i < k_count * a * n; i += blockDim.x) {
    const int k = i / (a * n);
    smw[i] = maskwin[(static_cast<int64_t>(k) * p_count + p) * a * n + i % (a * n)];
  }
  for (int i = threadIdx.x; i < k_count; i += blockDim.x) {
    smem[i] = profile_mem[i * p_count + p];
  }
  for (int i = threadIdx.x; i < k_count * a; i += blockDim.x) {
    const int64_t src = (static_cast<int64_t>(i / a) * p_count + p) * a + i % a;
    srow[i] = profile_rows[src];
    sanc[i] = profile_anchors[src];
    sval[i] = profile_valid[src];
  }
  __syncthreads();
  return ClassTables{sv, smw, smem, srow, sanc, sval};
}

// keycode packs 3 bits per key: bits 0-1 the base (0 frag-delta,
// 1 free-slices, 2 gpu, 3 anchor), bit 2 the "-" direction
struct KeyCode {
  int base[kMaxKeys];
  bool neg[kMaxKeys];
  bool need_delta;
};

__device__ __forceinline__ KeyCode decode_keys(int keycode, int nkeys) {
  KeyCode kc;
  kc.need_delta = false;
#pragma unroll
  for (int i = 0; i < kMaxKeys; ++i) {
    const int c = (keycode >> (3 * i)) & 7;
    kc.base[i] = c & 3;
    kc.neg[i] = (c & 4) != 0;
    if (i < nkeys && kc.base[i] == 0) kc.need_delta = true;
  }
  return kc;
}

// The signed key vector of one candidate.
__device__ __forceinline__ void key_vector(const KeyCode& kc, float delta,
                                           float free_after, float gpu,
                                           float anchor, float (&out)[kMaxKeys]) {
#pragma unroll
  for (int i = 0; i < kMaxKeys; ++i) {
    float val;
    switch (kc.base[i]) {
      case 0: val = delta; break;
      case 1: val = free_after; break;
      case 2: val = gpu; break;
      default: val = anchor; break;
    }
    out[i] = kc.neg[i] ? -val : val;
  }
}

__device__ __forceinline__ void copy_keys(float (&dst)[kMaxKeys],
                                          const float (&src)[kMaxKeys]) {
#pragma unroll
  for (int i = 0; i < kMaxKeys; ++i) dst[i] = src[i];
}

__global__ void __launch_bounds__(kSelectThreads) select_from_base_kernel(
    const float* __restrict__ base, const int32_t* __restrict__ free,
    const float* __restrict__ f, const int32_t* __restrict__ pid,
    const int32_t* __restrict__ midx, const float* __restrict__ V,
    const float* __restrict__ maskwin, const int32_t* __restrict__ profile_rows,
    const uint8_t* __restrict__ profile_valid,
    const int32_t* __restrict__ profile_anchors,
    const float* __restrict__ profile_mem, int32_t* __restrict__ out_gpu,
    int32_t* __restrict__ out_col, uint8_t* __restrict__ out_ok, int m, int n,
    int a, int p_count, int k_count, int nkeys, int keycode, int partial) {
  extern __shared__ float sh[];
  const int r = blockIdx.x;
  const ClassTables t = stage_class_tables(sh, V, maskwin, profile_rows, profile_valid,
                                           profile_anchors, profile_mem, pid[r],
                                           k_count, p_count, n, a);
  const KeyCode kc = decode_keys(keycode, nkeys);

  float best[kMaxKeys];
#pragma unroll
  for (int i = 0; i < kMaxKeys; ++i) best[i] = CUDART_INF_F;
  int best_flat = INT_MAX;

  const float* base_r = base + static_cast<int64_t>(r) * m * n;
  for (int g = threadIdx.x; g < m; g += blockDim.x) {
    const int k = midx[g];
    const float* b = base_r + static_cast<int64_t>(g) * n;
    const float* v = t.v + k * n;
    const int64_t rg = static_cast<int64_t>(r) * m + g;
    const float free_after = static_cast<float>(free[rg]) - t.mem[k];
    const float fb = f[rg];
    const float s_occ =
        (kc.need_delta && !partial) ? occupied_sum(b, v, n, free_after) : 0.f;
    for (int j = 0; j < a; ++j) {
      const int kj = k * a + j;
      if (!t.val[kj] || b[t.row[kj]] != 0.f) continue;  // infeasible anchor
      const float delta =
          kc.need_delta
              ? anchor_delta(b, v, t.mw + kj * n, n, free_after, s_occ, fb, partial)
              : 0.f;
      float cand[kMaxKeys];
      key_vector(kc, delta, free_after, static_cast<float>(g),
                 static_cast<float>(t.anc[kj]), cand);
      const int flat = g * a + j;
      if (lex_less(cand, flat, best, best_flat, nkeys)) {
        copy_keys(best, cand);
        best_flat = flat;
      }
    }
  }

  // warp-shuffle reduction of the per-thread winners
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float other[kMaxKeys];
#pragma unroll
    for (int i = 0; i < kMaxKeys; ++i) {
      other[i] = __shfl_down_sync(0xffffffffu, best[i], off);
    }
    const int other_flat = __shfl_down_sync(0xffffffffu, best_flat, off);
    if (lex_less(other, other_flat, best, best_flat, nkeys)) {
#pragma unroll
      for (int i = 0; i < kMaxKeys; ++i) best[i] = other[i];
      best_flat = other_flat;
    }
  }

  // then across the block's warps in shared memory
  __shared__ float wkeys[kSelectThreads / 32][kMaxKeys];
  __shared__ int wflat[kSelectThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kMaxKeys; ++i) wkeys[warp][i] = best[i];
    wflat[warp] = best_flat;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kSelectThreads / 32; ++w) {
      if (lex_less(wkeys[w], wflat[w], best, best_flat, nkeys)) {
#pragma unroll
        for (int i = 0; i < kMaxKeys; ++i) best[i] = wkeys[w][i];
        best_flat = wflat[w];
      }
    }
    const bool ok = best_flat != INT_MAX;
    out_gpu[r] = ok ? best_flat / a : 0;
    out_col[r] = ok ? best_flat % a : 0;
    out_ok[r] = ok ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// migrate_refine — replaces kernels/fragscore/fragscore.py::migrate_refine
// (Pallas, _migrate_refine_kernel: _class_pass_impl and _victim_pass_impl
// with _refine_cols, _tile_top2 and _delta_rows) and its host-side merge
// sim/batched.py::_merge_top2 of the JAX package.
//
// Both refinements of the factored defrag search in ONE launch with two
// block ranges; the wrapper's `launches` counts that one launch.
//  * Blocks [0, R·P), pass 0: one block per (replica, demand class), one
//    thread per GPU row of the untouched cluster.  A thread refines its row
//    along the anchors (feasibility, ΔF and keys as in select_from_base;
//    ties to the first column), then a per-thread, warp-shuffle and
//    shared-memory top-2 by (keys..., gpu) yields the class's best and
//    runner-up rows: the reference's in-tile _tile_top2 and host
//    _merge_top2 in one reduction.  The class's tables of every model are
//    staged in shared memory, so a mixed fleet is the same single launch.
//  * Blocks [R·P, R·P + ceil(R·C / 128)), pass 1: one thread per (replica,
//    victim) refines the victim's patched row, gathering its own model's
//    and class's tables through kc/rp (the reference's wrapper built
//    per-victim (C, A, N) tables for this; nothing of the kind is built).
// Masked outputs: pass 0 writes gpu = col = 0 and keys = 1e9 where no row
// is feasible (ok = 0); pass 1 writes column 0 and the UNMASKED keys of
// column 0 where no anchor is feasible — the plain version's conventions.
//
// Bound: bytes.  At R = 500, M = 100, C_live = 800, N = 18, L = 3 a call
// reads base2 (28.8 MB), five per-victim scalars (8 MB) and the replica
// state (4 MB), and writes 6.8 MB: about 48 MB, 14 µs at 3.35 TB/s, while
// its float work (a few hundred MFLOP) takes a few µs at 67 TFLOP/s.  The
// dominant stream, base2, is read once and in order: each pass-1 block
// stages its 128 rows through shared memory with coalesced loads.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void top2_insert(const float (&key)[kMaxKeys], int g, int col,
                                            float (&k1)[kMaxKeys], int& g1, int& c1,
                                            float (&k2)[kMaxKeys], int& g2, int& c2,
                                            int nkeys) {
  if (lex_less(key, g, k1, g1, nkeys)) {
    copy_keys(k2, k1);
    g2 = g1;
    c2 = c1;
    copy_keys(k1, key);
    g1 = g;
    c1 = col;
  } else if (lex_less(key, g, k2, g2, nkeys)) {
    copy_keys(k2, key);
    g2 = g;
    c2 = col;
  }
}

__device__ __forceinline__ void migrate_class_pass(
    float* sh, int r, int p, const float* __restrict__ base,
    const int32_t* __restrict__ free, const float* __restrict__ f,
    const int32_t* __restrict__ midx, const float* __restrict__ V,
    const float* __restrict__ maskwin, const int32_t* __restrict__ profile_rows,
    const uint8_t* __restrict__ profile_valid,
    const int32_t* __restrict__ profile_anchors,
    const float* __restrict__ profile_mem, int32_t* __restrict__ out_g1,
    uint8_t* __restrict__ out_ok1, int32_t* __restrict__ out_a1,
    float* __restrict__ out_k1, int32_t* __restrict__ out_g2,
    uint8_t* __restrict__ out_ok2, int32_t* __restrict__ out_a2,
    float* __restrict__ out_k2, int m, int n, int a, int p_count, int k_count,
    int nkeys, const KeyCode& keys, int partial) {
  const ClassTables t = stage_class_tables(sh, V, maskwin, profile_rows, profile_valid,
                                           profile_anchors, profile_mem, p, k_count,
                                           p_count, n, a);
  float k1[kMaxKeys], k2[kMaxKeys];
#pragma unroll
  for (int i = 0; i < kMaxKeys; ++i) k1[i] = k2[i] = CUDART_INF_F;
  int g1 = INT_MAX, c1 = 0, g2 = INT_MAX, c2 = 0;

  const float* base_r = base + static_cast<int64_t>(r) * m * n;
  for (int g = threadIdx.x; g < m; g += blockDim.x) {
    const int k = midx[g];
    const float* b = base_r + static_cast<int64_t>(g) * n;
    const float* v = t.v + k * n;
    const int64_t rg = static_cast<int64_t>(r) * m + g;
    const float free_after = static_cast<float>(free[rg]) - t.mem[k];
    const float fb = f[rg];
    const float s_occ =
        (keys.need_delta && !partial) ? occupied_sum(b, v, n, free_after) : 0.f;
    float best[kMaxKeys];
#pragma unroll
    for (int i = 0; i < kMaxKeys; ++i) best[i] = CUDART_INF_F;
    int best_col = INT_MAX;
    for (int j = 0; j < a; ++j) {
      const int kj = k * a + j;
      if (!t.val[kj] || b[t.row[kj]] != 0.f) continue;  // infeasible anchor
      const float delta =
          keys.need_delta
              ? anchor_delta(b, v, t.mw + kj * n, n, free_after, s_occ, fb, partial)
              : 0.f;
      float cand[kMaxKeys];
      key_vector(keys, delta, free_after, static_cast<float>(g),
                 static_cast<float>(t.anc[kj]), cand);
      if (lex_less(cand, j, best, best_col, nkeys)) {
        copy_keys(best, cand);
        best_col = j;
      }
    }
    if (best_col != INT_MAX) top2_insert(best, g, best_col, k1, g1, c1, k2, g2, c2, nkeys);
  }

  // warp-shuffle merge of the per-thread top-2 lists
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float o1[kMaxKeys], o2[kMaxKeys];
#pragma unroll
    for (int i = 0; i < kMaxKeys; ++i) {
      o1[i] = __shfl_down_sync(0xffffffffu, k1[i], off);
      o2[i] = __shfl_down_sync(0xffffffffu, k2[i], off);
    }
    const int og1 = __shfl_down_sync(0xffffffffu, g1, off);
    const int oc1 = __shfl_down_sync(0xffffffffu, c1, off);
    const int og2 = __shfl_down_sync(0xffffffffu, g2, off);
    const int oc2 = __shfl_down_sync(0xffffffffu, c2, off);
    top2_insert(o1, og1, oc1, k1, g1, c1, k2, g2, c2, nkeys);
    top2_insert(o2, og2, oc2, k1, g1, c1, k2, g2, c2, nkeys);
  }

  // then across the block's warps in shared memory
  constexpr int kWarps = kMigrateThreads / 32;
  __shared__ float wkeys[kWarps][2][kMaxKeys];
  __shared__ int wrow[kWarps][4];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    copy_keys(wkeys[warp][0], k1);
    copy_keys(wkeys[warp][1], k2);
    wrow[warp][0] = g1;
    wrow[warp][1] = c1;
    wrow[warp][2] = g2;
    wrow[warp][3] = c2;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kWarps; ++w) {
    top2_insert(wkeys[w][0], wrow[w][0], wrow[w][1], k1, g1, c1, k2, g2, c2, nkeys);
    top2_insert(wkeys[w][1], wrow[w][2], wrow[w][3], k1, g1, c1, k2, g2, c2, nkeys);
  }
  const int64_t o = static_cast<int64_t>(r) * p_count + p;
  const bool ok1 = g1 != INT_MAX;
  const bool ok2 = g2 != INT_MAX;
  out_g1[o] = ok1 ? g1 : 0;
  out_ok1[o] = ok1 ? 1 : 0;
  out_a1[o] = ok1 ? c1 : 0;
  out_g2[o] = ok2 ? g2 : 0;
  out_ok2[o] = ok2 ? 1 : 0;
  out_a2[o] = ok2 ? c2 : 0;
  for (int i = 0; i < nkeys; ++i) {
    out_k1[o * nkeys + i] = ok1 ? k1[i] : kBig;
    out_k2[o * nkeys + i] = ok2 ? k2[i] : kBig;
  }
}

__device__ __forceinline__ void migrate_victim_pass(
    float* sh, int64_t first, int64_t total, const float* __restrict__ base2,
    const int32_t* __restrict__ free2, const float* __restrict__ f2,
    const int32_t* __restrict__ rg, const int32_t* __restrict__ rp,
    const int32_t* __restrict__ kc, const float* __restrict__ V,
    const float* __restrict__ maskwin, const int32_t* __restrict__ profile_rows,
    const uint8_t* __restrict__ profile_valid,
    const int32_t* __restrict__ profile_anchors,
    const float* __restrict__ profile_mem, int32_t* __restrict__ out_ap,
    uint8_t* __restrict__ out_okp, float* __restrict__ out_kp, int n, int a,
    int p_count, int nkeys, const KeyCode& keys, int partial) {
  // coalesced staging of this block's consecutive base2 rows
  const int rows_here = static_cast<int>(
      total - first < static_cast<int64_t>(blockDim.x) ? total - first : blockDim.x);
  const float* src = base2 + first * n;
  for (int i = threadIdx.x; i < rows_here * n; i += blockDim.x) sh[i] = src[i];
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= rows_here) return;

  const int64_t vi = first + threadIdx.x;
  const float* b = sh + threadIdx.x * n;
  const int k = kc[vi];
  const int64_t cls = static_cast<int64_t>(k) * p_count + rp[vi];
  const float* v = V + static_cast<int64_t>(k) * n;
  const float* mw = maskwin + cls * a * n;
  const float free_after = static_cast<float>(free2[vi]) - profile_mem[cls];
  const float fb = f2[vi];
  const float gpu = static_cast<float>(rg[vi]);
  const float s_occ =
      (keys.need_delta && !partial) ? occupied_sum(b, v, n, free_after) : 0.f;
  float best[kMaxKeys], col0[kMaxKeys];
#pragma unroll
  for (int i = 0; i < kMaxKeys; ++i) best[i] = col0[i] = CUDART_INF_F;
  int best_col = INT_MAX;
  for (int j = 0; j < a; ++j) {
    const int64_t cj = cls * a + j;
    const bool feasible = profile_valid[cj] && b[profile_rows[cj]] == 0.f;
    if (!feasible && j != 0) continue;  // column 0 is the all-infeasible fallback
    const float delta =
        keys.need_delta
            ? anchor_delta(b, v, mw + static_cast<int64_t>(j) * n, n, free_after, s_occ,
                           fb, partial)
            : 0.f;
    float cand[kMaxKeys];
    key_vector(keys, delta, free_after, gpu, static_cast<float>(profile_anchors[cj]), cand);
    if (j == 0) copy_keys(col0, cand);
    if (feasible && lex_less(cand, j, best, best_col, nkeys)) {
      copy_keys(best, cand);
      best_col = j;
    }
  }
  const bool ok = best_col != INT_MAX;
  out_ap[vi] = ok ? best_col : 0;
  out_okp[vi] = ok ? 1 : 0;
  for (int i = 0; i < nkeys; ++i) out_kp[vi * nkeys + i] = ok ? best[i] : col0[i];
}

__global__ void __launch_bounds__(kMigrateThreads) migrate_refine_kernel(
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
    int c_count, int n, int a, int p_count, int k_count, int nkeys, int keycode,
    int partial) {
  extern __shared__ float sh[];
  const KeyCode keys = decode_keys(keycode, nkeys);
  const int pass0_blocks = r_count * p_count;
  if (static_cast<int>(blockIdx.x) < pass0_blocks) {
    migrate_class_pass(sh, blockIdx.x / p_count, blockIdx.x % p_count, base, free, f,
                       midx, V, maskwin, profile_rows, profile_valid, profile_anchors,
                       profile_mem, out_g1, out_ok1, out_a1, out_k1, out_g2, out_ok2,
                       out_a2, out_k2, m, n, a, p_count, k_count, nkeys, keys, partial);
  } else {
    const int64_t first =
        static_cast<int64_t>(blockIdx.x - pass0_blocks) * kMigrateThreads;
    migrate_victim_pass(sh, first, static_cast<int64_t>(r_count) * c_count, base2,
                        free2, f2, rg, rp, kc, V, maskwin, profile_rows, profile_valid,
                        profile_anchors, profile_mem, out_ap, out_okp, out_kp, n, a,
                        p_count, nkeys, keys, partial);
  }
}

}  // namespace

extern "C" {

int fragscore_launch(const void* occ, const void* w, const void* v, void* out,
                     int q, int n, int s, int partial, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (q <= 0 || s > kMaxSlices) return cudaErrorInvalidValue;
  const int blocks = (q + kFragThreads - 1) / kFragThreads;
  const size_t smem = sizeof(float) * static_cast<size_t>(n * s + n);
  fragscore_kernel<<<blocks, kFragThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(occ), static_cast<const float*>(w),
      static_cast<const float*>(v), static_cast<float*>(out), q, n, s, partial);
  return cudaGetLastError();
}

int mfi_delta_launch(const void* occ, const void* w, const void* v,
                     const void* profile_masks, const void* profile_valid,
                     void* out, int m, int n, int s, int a, int partial,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (m <= 0 || a <= 0 || s > kMaxSlices) return cudaErrorInvalidValue;
  const int blocks = (m + kFragThreads - 1) / kFragThreads;
  const size_t smem = sizeof(float) * static_cast<size_t>(n * s + n + a * s + a);
  mfi_delta_kernel<<<blocks, kFragThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(occ), static_cast<const float*>(w),
      static_cast<const float*>(v), static_cast<const float*>(profile_masks),
      static_cast<const float*>(profile_valid), static_cast<float*>(out), m, n,
      s, a, partial);
  return cudaGetLastError();
}

int delta_from_base_launch(const void* base, const void* free, const void* f,
                           const void* pid, const void* midx, const void* V,
                           const void* maskwin, const void* profile_mem,
                           void* out, int r_count, int m, int n, int a,
                           int p_count, int partial, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t rows = static_cast<int64_t>(r_count) * m;
  if (rows <= 0) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>((rows + kDeltaThreads - 1) / kDeltaThreads);
  delta_from_base_kernel<<<blocks, kDeltaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(base), static_cast<const int32_t*>(free),
      static_cast<const float*>(f), static_cast<const int32_t*>(pid),
      static_cast<const int32_t*>(midx), static_cast<const float*>(V),
      static_cast<const float*>(maskwin), static_cast<const float*>(profile_mem),
      static_cast<float*>(out), r_count, m, n, a, p_count, partial);
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (r_count <= 0 || nkeys < 0 || nkeys > kMaxKeys) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * class_tables_floats(k_count, n, a);
  select_from_base_kernel<<<r_count, kSelectThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(base), static_cast<const int32_t*>(free),
      static_cast<const float*>(f), static_cast<const int32_t*>(pid),
      static_cast<const int32_t*>(midx), static_cast<const float*>(V),
      static_cast<const float*>(maskwin),
      static_cast<const int32_t*>(profile_rows),
      static_cast<const uint8_t*>(profile_valid),
      static_cast<const int32_t*>(profile_anchors),
      static_cast<const float*>(profile_mem), static_cast<int32_t*>(out_gpu),
      static_cast<int32_t*>(out_col), static_cast<uint8_t*>(out_ok), m, n, a,
      p_count, k_count, nkeys, keycode, partial);
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (r_count <= 0 || c_count < 0 || nkeys < 0 || nkeys > kMaxKeys) {
    return cudaErrorInvalidValue;
  }
  const int64_t pass0 = static_cast<int64_t>(r_count) * p_count;
  const int64_t pass1 =
      (static_cast<int64_t>(r_count) * c_count + kMigrateThreads - 1) / kMigrateThreads;
  if (pass0 + pass1 > INT_MAX) return cudaErrorInvalidValue;
  const size_t floats = class_tables_floats(k_count, n, a);
  const size_t smem = sizeof(float) * (floats > static_cast<size_t>(kMigrateThreads) * n
                                           ? floats
                                           : static_cast<size_t>(kMigrateThreads) * n);
  migrate_refine_kernel<<<static_cast<int>(pass0 + pass1), kMigrateThreads, smem,
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
      c_count, n, a, p_count, k_count, nkeys, keycode, partial);
  return cudaGetLastError();
}

}  // extern "C"
