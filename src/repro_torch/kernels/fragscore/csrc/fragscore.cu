// Fragmentation-scoring kernels of the batched Monte-Carlo engine, written
// by hand for Hopper (sm_90a), behind a plain C interface loaded with ctypes
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
// replicas): N = 18 windows, A = 7 anchors, S = 8 slices.  All three
// kernels move well under a megabyte a call and do a few hundred
// thousand float operations, so on an H100 each is bound by its launch
// (a few microseconds), not by bytes or operations; the designs keep one
// launch per engine stage and read every table once per block.

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
  out[row] = acc;
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
  const int p = pid[r];
  float* sv = sh;                        // (K, N) window sizes
  float* smw = sv + k_count * n;         // (K, A, N) this class's maskwin
  float* smem = smw + k_count * a * n;   // (K,) this class's slice demand
  int* srow = reinterpret_cast<int*>(smem + k_count);  // (K, A) window row
  int* sanc = srow + k_count * a;        // (K, A) anchor value
  int* sval = sanc + k_count * a;        // (K, A) anchor validity
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

  // keycode packs 3 bits per key: bits 0-1 the base (0 frag-delta,
  // 1 free-slices, 2 gpu, 3 anchor), bit 2 the "-" direction
  int code[kMaxKeys];
  float sgn[kMaxKeys];
  bool need_delta = false;
#pragma unroll
  for (int i = 0; i < kMaxKeys; ++i) {
    const int c = (keycode >> (3 * i)) & 7;
    code[i] = c & 3;
    sgn[i] = (c & 4) ? -1.f : 1.f;
    if (i < nkeys && code[i] == 0) need_delta = true;
  }

  float best[kMaxKeys];
#pragma unroll
  for (int i = 0; i < kMaxKeys; ++i) best[i] = CUDART_INF_F;
  int best_flat = INT_MAX;

  const float* base_r = base + static_cast<int64_t>(r) * m * n;
  for (int g = threadIdx.x; g < m; g += blockDim.x) {
    const int k = midx[g];
    const float* b = base_r + static_cast<int64_t>(g) * n;
    const float* v = sv + k * n;
    const int64_t rg = static_cast<int64_t>(r) * m + g;
    const float free_after = static_cast<float>(free[rg]) - smem[k];
    const float fb = f[rg];
    const float s_occ =
        (need_delta && !partial) ? occupied_sum(b, v, n, free_after) : 0.f;
    for (int j = 0; j < a; ++j) {
      const int kj = k * a + j;
      if (!sval[kj] || b[srow[kj]] != 0.f) continue;  // infeasible anchor
      const float delta =
          need_delta ? anchor_delta(b, v, smw + kj * n, n, free_after, s_occ, fb, partial)
                     : 0.f;
      float cand[kMaxKeys];
#pragma unroll
      for (int i = 0; i < kMaxKeys; ++i) {
        float val;
        switch (code[i]) {
          case 0: val = delta; break;
          case 1: val = free_after; break;
          case 2: val = static_cast<float>(g); break;
          default: val = static_cast<float>(sanc[kj]); break;
        }
        cand[i] = sgn[i] < 0.f ? -val : val;
      }
      const int flat = g * a + j;
      if (lex_less(cand, flat, best, best_flat, nkeys)) {
#pragma unroll
        for (int i = 0; i < kMaxKeys; ++i) best[i] = cand[i];
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
  const size_t smem = sizeof(float) * static_cast<size_t>(
      k_count * n + k_count * a * n + k_count + 3 * k_count * a);
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

}  // extern "C"
