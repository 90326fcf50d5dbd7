// GQA flash-decode attention with the KV cache split across blocks, written
// by hand for Hopper (sm_90a), behind a plain C interface loaded with ctypes
// (repro_torch/kernels/build.py builds this file with nvcc at first use).
//
// Replaces kernels/decode_attention/decode_attention.py::decode_attention
// (Pallas, _decode_kernel; src/repro/kernels/decode_attention/
// decode_attention.py:73) of the JAX package: one new query token per batch
// row attends to a (B, S, K, D) KV cache, query head h reading KV head
// h / G (H = G·K), keys start[b] <= t < length[b] valid (start = 0 when
// the caller passes none; a sliding-window layer's ring cache sets it), f32
// online softmax, the result cast to q's dtype.  A row with no valid key
// gives 0 (normaliser 0 -> 1, as in the TPU kernel).  The plain torch version is
// repro_torch/kernels/decode_attention/ref.py::decode_attention_ref.
//
// Bound on an H100: bytes.  A call reads each valid key and value row once
// (2 · Σ_b (length[b] - start[b]) · K · D elements) plus q, and writes out;
// it does 4 · Σ_b (length[b] - start[b]) · H · D operations, about one per
// byte read in bf16, far below the ~295 bf16 tensor-core operations per byte
// at which the arithmetic would bound it.  At the serving path's shape (B = 4 slots,
// K = 8, D = 64, lengths ~160, bf16) that is ~1.3 MB, 0.4 µs of HBM time,
// so a call is bound by its launch; at B = 8, S = 8192 with ragged lengths
// it is 64 MB, 19 µs.
//
// Design (split-KV):
//  * Grid (B·K·ceil(G / rows per block), n_splits).  The host planner
//    (split.py::plan_splits) picks the split length from S, B·K and the
//    card's SM count so that the card holds about two blocks per SM; it
//    never reads `length` or `start`, which stay on the device.  A block
//    whose split ends at or before start[b], or starts at or past
//    length[b], exits at once (split 0 of an empty row writes its zeros),
//    so short rows cost nothing and the longest row is spread over many
//    SMs.  The split holding start[b] begins its walk there.
//  * Staging.  A block walks its split in tiles of keys.  The K and V rows
//    of a tile go to shared memory by 16-byte cp.async into a ring of
//    stages, so the next tile is in flight while one is consumed.  Rows are
//    padded by 16 bytes, which keeps the row reads free of bank conflicts.
//    (A row whose bytes are not a multiple of 16, or a K/V pointer that is
//    not 16-byte aligned, is copied with plain loads.)
//  * bf16, D <= 128: tensor cores.  8 warps, tiles of 128 keys, 2 stages;
//    each warp owns 16 keys of every tile and runs mma.sync m16n8k16 (bf16
//    in, f32 accumulate) twice: S = Q·Kᵀ with the block's (up to 16) query
//    rows as the M = 16 rows, then O += P·V with P taken straight from S's
//    accumulator registers.  Each warp keeps its own f32 online softmax
//    (row max and sum over the 4 lanes of a row by shuffles), so a tile
//    costs one barrier; the warps' states are merged in warp order at the
//    end of the split.  P enters the second product as two bf16 parts,
//    hi = bf16(p) and lo = bf16(p - hi), in two MMAs: hi + lo holds p to
//    ~2^-17, so P·V keeps the f32 P of the TPU kernel and the plain
//    version (a single bf16 P, as flash-attention kernels use, is off by
//    up to 2^-9 per probability).
//  * f32 (any D) and bf16 with D > 128: CUDA cores, 4 warps, 3 stages.
//    Each thread owns one key of the tile and a subset of the (up to 8)
//    query rows for the scores; one warp per query row takes the tile's max
//    and sum; for P·V each thread owns a pair of columns and a contiguous
//    share of the tile's keys, summed in order at the end of the split.
//  * Merge.  With one split the block normalises and writes the output.
//    Otherwise each split writes its partial (m, l, acc) in f32 to scratch
//    that the wrapper allocates, and counts itself done on an int32 counter
//    of its (b, kh, row chunk); the last block to finish merges the valid
//    splits, floor(start / split_len) to ceil(length / split_len) - 1, in
//    split order (a split with m = -inf weighs 0) and resets the counter
//    to 0 for the next call.
//    Every sum runs in a fixed order, so two calls on the same inputs give
//    the same bits, whichever block merges.
// The launcher never synchronises, allocates nothing and returns
// cudaGetLastError(); the wrapper counts one launch per call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxHeadDim = 256;
// the tensor-core path: warps per block (16 keys of a tile each), ring stages
constexpr int kMmaWarps = 8;
constexpr int kMmaStages = 2;
// the CUDA-core path
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// two consecutive elements as floats
__device__ __forceinline__ float2 pair_f32(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 pair_f32(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// the 16 bytes of a chunk as floats (8 bf16 or 4 f32)
__device__ __forceinline__ void chunk_f32(const uint4& c, float (&x)[4]) {
  x[0] = __uint_as_float(c.x);
  x[1] = __uint_as_float(c.y);
  x[2] = __uint_as_float(c.z);
  x[3] = __uint_as_float(c.w);
}
__device__ __forceinline__ void chunk_f32(const uint4& c, float (&x)[8]) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// 16-byte async copy; src_bytes = 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes = 16) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// d += a · b, m16n8k16, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// a pair of floats (x, y) as bf16 pairs hi = bf16(x, y), lo = bf16((x, y) - hi)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// What every split block shares: where its rows and keys are.
struct Split {
  int b, kh, g0, gc, len, lo, t_begin, t_end, split;
  size_t row0;  // first output row (b·H + kh·G + g0)
};

__device__ __forceinline__ Split locate(const int32_t* length, const int32_t* start, int s,
                                        int kheads, int group, int rows_per_block,
                                        int split_len) {
  Split sp;
  const int chunks = (group + rows_per_block - 1) / rows_per_block;
  const int bk = blockIdx.x / chunks;
  sp.g0 = (blockIdx.x % chunks) * rows_per_block;
  sp.gc = min(rows_per_block, group - sp.g0);
  sp.b = bk / kheads;
  sp.kh = bk % kheads;
  sp.len = max(0, min(length[sp.b], s));
  sp.lo = start ? max(0, min(start[sp.b], sp.len)) : 0;
  sp.split = blockIdx.y;
  sp.t_begin = max(sp.split * split_len, sp.lo);
  sp.t_end = min(sp.len, (sp.split + 1) * split_len);
  sp.row0 = static_cast<size_t>(sp.b) * kheads * group + static_cast<size_t>(sp.kh) * group + sp.g0;
  return sp;
}

// Copy tile `tile` (TK keys from t_begin + tile·TK) of K and V into ring
// stage tile % STAGES (rows of ROW bytes: K rows, then V rows) with the
// block's THREADS threads, then commit one cp.async group (empty past the
// last tile).  Rows past the split's end are zero-filled when `zfill`,
// skipped otherwise.
template <typename T, int DMAX, int TK, int ROW, int THREADS, int STAGES>
__device__ __forceinline__ void fetch_tile(unsigned char* stages, const T* k, const T* v,
                                           size_t base, size_t key_stride, const Split& sp,
                                           int tile, int n_tiles, int d, bool vec16,
                                           bool zfill) {
  constexpr int kStageBytes = 2 * TK * ROW;
  if (tile < n_tiles) {
    unsigned char* st = stages + (tile % STAGES) * kStageBytes;
    const int t0 = sp.t_begin + tile * TK;
    const int rows = min(TK, sp.t_end - t0);
    if (vec16) {
      constexpr int CH = DMAX * static_cast<int>(sizeof(T)) / 16;  // chunks of a padded row
      constexpr int EPC = 16 / static_cast<int>(sizeof(T));
      const int row_chunks = d / EPC;
      for (int i = threadIdx.x; i < 2 * TK * CH; i += THREADS) {
        const int c = i % CH, rr = i / CH;
        const int kv = rr / TK, r = rr % TK;
        if (c >= row_chunks || (r >= rows && !zfill)) continue;
        const int t = t0 + min(r, rows - 1);  // a valid address even when zero-filling
        const T* src = (kv ? v : k) + base + static_cast<size_t>(t) * key_stride + c * EPC;
        cp_async16(st + rr * ROW + c * 16, src, r < rows ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < 2 * TK * d; i += THREADS) {
        const int rr = i / d, e = i % d;
        const int kv = rr / TK, r = rr % TK;
        T val = T(0.f);
        if (r < rows) val = ((kv ? v : k) + base + static_cast<size_t>(t0 + r) * key_stride)[e];
        else if (!zfill) continue;
        reinterpret_cast<T*>(st + rr * ROW)[e] = val;
      }
    }
  }
  cp_async_commit();
}

// Zero the row tails [d, DMAX) of every stage row: rows are read whole, and
// the copies never write there.
template <typename T, int DMAX, int TK, int ROW, int THREADS, int STAGES>
__device__ __forceinline__ void zero_tails(unsigned char* stages, int d) {
  if (d < DMAX) {
    const int tail = (DMAX - d) * static_cast<int>(sizeof(T));
    for (int i = threadIdx.x; i < STAGES * 2 * TK * tail; i += THREADS)
      stages[(i / tail) * ROW + d * static_cast<int>(sizeof(T)) + i % tail] = 0;
  }
}

// After every thread of a block wrote its share of the split's partial
// (m, l, acc), the block that finishes last among the splits of its (b, kh,
// row chunk) merges the partials of the row's valid splits (those that hold
// a key of [lo, len)) in split order and writes the output.  Which block
// that is does not change the sums.  Its counter is reset for the next call
// on the stream.
template <int THREADS, typename T>
__device__ void merge_if_last(const Split& sp, int* counters, const float* part_ml,
                              const float* part_acc, T* out, int d, int split_len,
                              int n_splits) {
  __shared__ int last;
  __threadfence();  // this block's partial is visible before it is counted
  __syncthreads();
  const int j0 = sp.lo / split_len;                   // the first valid split
  const int nv = (sp.len + split_len - 1) / split_len;  // one past the last
  if (threadIdx.x == 0) {
    last = atomicAdd(counters + blockIdx.x, 1) == nv - j0 - 1;
    if (last) counters[blockIdx.x] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < sp.gc * d; i += THREADS) {
    const int g = i / d, e = i % d;
    const size_t slot0 = (sp.row0 + g) * n_splits;
    float mx = -CUDART_INF_F;
    for (int j = j0; j < nv; ++j) mx = fmaxf(mx, __ldcg(part_ml + (slot0 + j) * 2));
    float a = 0.f, l = 0.f;
#pragma unroll 4
    for (int j = j0; j < nv; ++j) {
      const float m = __ldcg(part_ml + (slot0 + j) * 2);
      const float wt = m == -CUDART_INF_F ? 0.f : expf(m - mx);
      l += __ldcg(part_ml + (slot0 + j) * 2 + 1) * wt;
      a += __ldcg(part_acc + (slot0 + j) * d + e) * wt;
    }
    store(out + (sp.row0 + g) * d + e, a / (l == 0.f ? 1.f : l));
  }
}

// ---------------------------------------------------------------------------
// bf16, D <= 128: tensor cores
// ---------------------------------------------------------------------------

template <int DMAX>
struct MmaGeometry {
  static constexpr int kWarps = kMmaWarps;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kStages = kMmaStages;
  static constexpr int kRows = 16;                // query rows per block (mma M)
  static constexpr int kTile = 16 * kWarps;       // keys per tile, 16 per warp
  static constexpr int kRowBytes = DMAX * 2 + 16; // padded K/V row
  static constexpr int kQRowBytes = DMAX * 2 + 16;
  static constexpr int kStageBytes = 2 * kTile * kRowBytes;
  static constexpr int kSmem = kRows * kQRowBytes + kStages * kStageBytes;
  // the end-of-split merge of the warps: (m, l) and O per warp, in the ring
  static_assert(kWarps * kRows * (DMAX + 2) * 4 <= kStages * kStageBytes, "merge buffer");
};

template <int DMAX>
__global__ void __launch_bounds__(MmaGeometry<DMAX>::kThreads) decode_split_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ length,
    const int32_t* __restrict__ start, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc,
    int* __restrict__ counters, int s, int kheads, int group, int d, float scale, int split_len,
    int n_splits, int vec16) {
  using G = MmaGeometry<DMAX>;
  constexpr int TK = G::kTile;
  constexpr int KS = DMAX / 16;  // k-steps of Q·Kᵀ
  constexpr int NT = DMAX / 8;   // n-tiles of P·V
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qs = smem;                               // [16][DMAX] bf16, padded
  unsigned char* stages = smem + G::kRows * G::kQRowBytes;  // ring

  const Split sp = locate(length, start, s, kheads, group, G::kRows, split_len);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (sp.t_begin >= sp.t_end) {         // no valid key in this split
    if (sp.split == 0 && sp.lo >= sp.len)  // nor in the row: it gives 0
      for (int i = tid; i < sp.gc * d; i += G::kThreads) store(out + sp.row0 * d + i, 0.f);
    return;
  }

  // start the first tiles' copies, then stage q (zero past d and past gc)
  // while they fly
  const size_t key_stride = static_cast<size_t>(kheads) * d;
  const size_t base = static_cast<size_t>(sp.b) * s * key_stride + static_cast<size_t>(sp.kh) * d;
  const int n_tiles = (sp.t_end - sp.t_begin + TK - 1) / TK;
#pragma unroll
  for (int i = 0; i < G::kStages - 1; ++i)
    fetch_tile<__nv_bfloat16, DMAX, TK, G::kRowBytes, G::kThreads, G::kStages>(
        stages, k, v, base, key_stride, sp, i, n_tiles, d, vec16, true);
  zero_tails<__nv_bfloat16, DMAX, TK, G::kRowBytes, G::kThreads, G::kStages>(stages, d);
  for (int i = tid; i < G::kRows * DMAX; i += G::kThreads) {
    const int g = i / DMAX, e = i % DMAX;
    reinterpret_cast<__nv_bfloat16*>(qs + g * G::kQRowBytes)[e] =
        (g < sp.gc && e < d) ? q[(sp.row0 + g) * d + e] : __float2bfloat16_rn(0.f);
  }
  __syncthreads();  // q staged

  // Q fragments (A operand, rows = query rows), held for the whole split
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldmatrix_x4(qf[ks], qs + (lane % 16) * G::kQRowBytes + (ks * 16 + (lane / 16) * 8) * 2);

  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};  // rows lane/4 and lane/4 + 8
  float l_run[2] = {0.f, 0.f};                      // this thread's share of the sums
  const int k0 = warp * 16;                         // this warp's keys in a tile

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<G::kStages - 2>();
    __syncthreads();  // the tile has landed; the stage of tile - 1 is free
    fetch_tile<__nv_bfloat16, DMAX, TK, G::kRowBytes, G::kThreads, G::kStages>(
        stages, k, v, base, key_stride, sp, tile + G::kStages - 1, n_tiles, d, vec16, true);
    const int valid = min(TK, sp.t_end - (sp.t_begin + tile * TK));
    if (k0 >= valid) continue;  // warp-uniform: none of this warp's keys
    const unsigned char* ks_tile = stages + (tile % G::kStages) * G::kStageBytes;
    const unsigned char* vs_tile = ks_tile + TK * G::kRowBytes;

    // S = Q·Kᵀ over this warp's 16 keys: two n-tiles of 8 keys
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int q2 = 0; q2 < KS / 2; ++q2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ks_tile + (k0 + nt * 8 + lane % 8) * G::kRowBytes +
                            (q2 * 32 + (lane / 8) * 8) * 2);
        mma_bf16(sc[nt], qf[2 * q2], kb[0], kb[1]);
        mma_bf16(sc[nt], qf[2 * q2 + 1], kb[2], kb[3]);
      }
    }
    // scale and mask: element (row lane/4 (+8), key k0 + 8·nt + 2·(lane%4) + e)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * (lane % 4) + (e & 1);
        sc[nt][e] = key < valid ? sc[nt][e] * scale : -CUDART_INF_F;
      }
    // online softmax of rows lane/4 (h = 0) and lane/4 + 8 (h = 1)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(fmaxf(sc[0][2 * h], sc[0][2 * h + 1]), fmaxf(sc[1][2 * h], sc[1][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m_run[h], mx);
      const float alpha = m_run[h] == -CUDART_INF_F ? 0.f : expf(m_run[h] - mn);
      float ls = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const float p = sc[nt][e] == -CUDART_INF_F ? 0.f : expf(sc[nt][e] - mn);
          sc[nt][e] = p;
          ls += p;
        }
      l_run[h] = l_run[h] * alpha + ls;
      m_run[h] = mn;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        o[nt][2 * h] *= alpha;
        o[nt][2 * h + 1] *= alpha;
      }
    }
    // O += P·V: P from the accumulators (A operand, k = this warp's 16 keys)
    // as bf16 hi and lo parts
    uint32_t ph[4], pl[4];
    split_bf16(sc[0][0], sc[0][1], ph[0], pl[0]);
    split_bf16(sc[0][2], sc[0][3], ph[1], pl[1]);
    split_bf16(sc[1][0], sc[1][1], ph[2], pl[2]);
    split_bf16(sc[1][2], sc[1][3], ph[3], pl[3]);
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vs_tile + (k0 + ((lane / 8) % 2) * 8 + lane % 8) * G::kRowBytes +
                                (n2 * 16 + (lane / 16) * 8) * 2);
      mma_bf16(o[2 * n2], ph, vb[0], vb[1]);
      mma_bf16(o[2 * n2], pl, vb[0], vb[1]);
      mma_bf16(o[2 * n2 + 1], ph, vb[2], vb[3]);
      mma_bf16(o[2 * n2 + 1], pl, vb[2], vb[3]);
    }
  }

  // merge the warps' states in warp order
  cp_async_wait<0>();
  __syncthreads();
  float* wo = reinterpret_cast<float*>(stages);     // [warp][16][DMAX]
  float* wml = wo + G::kWarps * G::kRows * DMAX;       // [warp][16][2]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = lane / 4 + 8 * h;
    if (lane % 4 == 0) {
      wml[(warp * G::kRows + row) * 2] = m_run[h];
      wml[(warp * G::kRows + row) * 2 + 1] = l;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* dst = wo + (warp * G::kRows + row) * DMAX + nt * 8 + 2 * (lane % 4);
      dst[0] = o[nt][2 * h];
      dst[1] = o[nt][2 * h + 1];
    }
  }
  __syncthreads();
  for (int i = tid; i < sp.gc * d; i += G::kThreads) {
    const int g = i / d, e = i % d;
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < G::kWarps; ++w) mx = fmaxf(mx, wml[(w * G::kRows + g) * 2]);
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < G::kWarps; ++w) {
      const float m = wml[(w * G::kRows + g) * 2];
      const float wt = m == -CUDART_INF_F ? 0.f : expf(m - mx);
      l += wml[(w * G::kRows + g) * 2 + 1] * wt;
      a += wo[(w * G::kRows + g) * DMAX + e] * wt;
    }
    if (n_splits == 1) {
      store(out + (sp.row0 + g) * d + e, a / (l == 0.f ? 1.f : l));
    } else {
      const size_t slot = (sp.row0 + g) * n_splits + sp.split;
      part_acc[slot * d + e] = a;
      if (e == 0) {
        part_ml[slot * 2] = mx;
        part_ml[slot * 2 + 1] = l;
      }
    }
  }
  if (n_splits > 1)
    merge_if_last<G::kThreads>(sp, counters, part_ml, part_acc, out, d, split_len, n_splits);
}

// ---------------------------------------------------------------------------
// f32 (and bf16 with D > 128): CUDA cores
// ---------------------------------------------------------------------------

template <typename T, int DMAX>
struct SimtGeometry {
  static constexpr int kRows = 8;  // query rows per block
  static constexpr int kTile = 8192 / (DMAX * static_cast<int>(sizeof(T)));  // 8 KB of K per tile
  static constexpr int kRowBytes = DMAX * static_cast<int>(sizeof(T)) + 16;
  static constexpr int kEpc = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte chunk
  static constexpr int kChunks = DMAX / kEpc;
  static constexpr int kGroupSubsets = kThreads / kTile;  // score step: query-row subsets
  static constexpr int kRowsPerThread = kGroupSubsets >= kRows ? 1 : kRows / kGroupSubsets;
  static constexpr int kPairs = DMAX / 2;                 // P·V step: column pairs
  static constexpr int kKeySubsets = kThreads / kPairs;   // ... and key shares
  static constexpr int kStageBytes = 2 * kTile * kRowBytes;
  static constexpr int kSmem = kRows * DMAX * 4 + kStages * kStageBytes + kRows * kTile * 4;
  static_assert(kTile >= 8 && kTile <= kThreads, "tile");
  static_assert(kKeySubsets >= 1 && kTile % kKeySubsets == 0, "key shares");
  static_assert(kKeySubsets * kRows * DMAX * 4 <= kStages * kStageBytes, "merge buffer");
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) decode_split_simt_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int32_t* __restrict__ length, const int32_t* __restrict__ start, T* __restrict__ out,
    float* __restrict__ part_ml,
    float* __restrict__ part_acc, int* __restrict__ counters, int s, int kheads, int group,
    int d, float scale, int split_len, int n_splits, int vec16) {
  using G = SimtGeometry<T, DMAX>;
  constexpr int TK = G::kTile;
  constexpr int R = G::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);                              // [8][DMAX]
  unsigned char* stages = smem + R * DMAX * 4;                              // ring
  float* sc = reinterpret_cast<float*>(stages + kStages * G::kStageBytes);  // [8][TK]
  __shared__ float alpha_s[R], m_s[R], l_s[R];

  const Split sp = locate(length, start, s, kheads, group, R, split_len);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (sp.t_begin >= sp.t_end) {
    if (sp.split == 0 && sp.lo >= sp.len)
      for (int i = tid; i < sp.gc * d; i += kThreads) store(out + sp.row0 * d + i, 0.f);
    return;
  }
  for (int i = tid; i < R * DMAX; i += kThreads) {
    const int g = i / DMAX, e = i % DMAX;
    qs[i] = (g < sp.gc && e < d) ? to_f32(q[(sp.row0 + g) * d + e]) : 0.f;
  }
  zero_tails<T, DMAX, TK, G::kRowBytes, kThreads, kStages>(stages, d);

  const size_t key_stride = static_cast<size_t>(kheads) * d;
  const size_t base = static_cast<size_t>(sp.b) * s * key_stride + static_cast<size_t>(sp.kh) * d;
  const int n_tiles = (sp.t_end - sp.t_begin + TK - 1) / TK;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i)
    fetch_tile<T, DMAX, TK, G::kRowBytes, kThreads, kStages>(stages, k, v, base, key_stride, sp, i,
                                                             n_tiles, d, vec16, false);

  const int kk = tid % TK, gs = tid / TK;                   // score step
  const int dp = tid % G::kPairs, ks = tid / G::kPairs;     // P·V step
  constexpr int kKeysPerShare = TK / G::kKeySubsets;
  float acc[R][2];
#pragma unroll
  for (int g = 0; g < R; ++g) acc[g][0] = acc[g][1] = 0.f;
  float m_run[R / kWarps], l_run[R / kWarps];  // rows warp, warp + kWarps
#pragma unroll
  for (int j = 0; j < R / kWarps; ++j) {
    m_run[j] = -CUDART_INF_F;
    l_run[j] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    fetch_tile<T, DMAX, TK, G::kRowBytes, kThreads, kStages>(
        stages, k, v, base, key_stride, sp, tile + kStages - 1, n_tiles, d, vec16, false);
    const unsigned char* st = stages + (tile % kStages) * G::kStageBytes;
    const int valid = min(TK, sp.t_end - (sp.t_begin + tile * TK));

    if (gs < R) {
      float dot[G::kRowsPerThread];
#pragma unroll
      for (int j = 0; j < G::kRowsPerThread; ++j) dot[j] = 0.f;
      if (kk < valid) {
        const uint4* krow = reinterpret_cast<const uint4*>(st + kk * G::kRowBytes);
#pragma unroll 4
        for (int c = 0; c < G::kChunks; ++c) {
          float x[G::kEpc];
          chunk_f32(krow[c], x);
#pragma unroll
          for (int j = 0; j < G::kRowsPerThread; ++j) {
            const float4* qr = reinterpret_cast<const float4*>(
                qs + (gs + j * G::kGroupSubsets) * DMAX + c * G::kEpc);
#pragma unroll
            for (int e = 0; e < G::kEpc / 4; ++e) {
              const float4 qq = qr[e];
              dot[j] = fmaf(qq.x, x[4 * e], dot[j]);
              dot[j] = fmaf(qq.y, x[4 * e + 1], dot[j]);
              dot[j] = fmaf(qq.z, x[4 * e + 2], dot[j]);
              dot[j] = fmaf(qq.w, x[4 * e + 3], dot[j]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < G::kRowsPerThread; ++j) {
        const int g = gs + j * G::kGroupSubsets;
        if (g < R) sc[g * TK + kk] = kk < valid ? dot[j] * scale : -CUDART_INF_F;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < R / kWarps; ++j) {
      const int g = warp + j * kWarps;
      if (g < sp.gc) {
        float mt = -CUDART_INF_F;
        for (int t = lane; t < valid; t += 32) mt = fmaxf(mt, sc[g * TK + t]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
        const float mn = fmaxf(m_run[j], mt);
        float ls = 0.f;
        for (int t = lane; t < valid; t += 32) {
          const float x = sc[g * TK + t];
          const float p = x == -CUDART_INF_F ? 0.f : expf(x - mn);
          sc[g * TK + t] = p;
          ls += p;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, off);
        const float alpha = m_run[j] == -CUDART_INF_F ? 0.f : expf(m_run[j] - mn);
        l_run[j] = l_run[j] * alpha + ls;
        m_run[j] = mn;
        if (lane == 0) alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    if (ks < G::kKeySubsets) {
      const unsigned char* vst = st + TK * G::kRowBytes;
#pragma unroll
      for (int g = 0; g < R; ++g) {
        if (g < sp.gc) {
          acc[g][0] *= alpha_s[g];
          acc[g][1] *= alpha_s[g];
        }
      }
      const int t_lo = ks * kKeysPerShare;
      const int t_hi = min(valid, t_lo + kKeysPerShare);
      for (int t = t_lo; t < t_hi; ++t) {
        const float2 vv = pair_f32(reinterpret_cast<const T*>(vst + t * G::kRowBytes) + 2 * dp);
#pragma unroll
        for (int g = 0; g < R; ++g) {
          if (g < sp.gc) {
            const float p = sc[g * TK + t];
            acc[g][0] = fmaf(p, vv.x, acc[g][0]);
            acc[g][1] = fmaf(p, vv.y, acc[g][1]);
          }
        }
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(stages);  // [kKeySubsets][8][DMAX]
  if (ks < G::kKeySubsets) {
#pragma unroll
    for (int g = 0; g < R; ++g) {
      red[(ks * R + g) * DMAX + 2 * dp] = acc[g][0];
      red[(ks * R + g) * DMAX + 2 * dp + 1] = acc[g][1];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < R / kWarps; ++j) {
      m_s[warp + j * kWarps] = m_run[j];
      l_s[warp + j * kWarps] = l_run[j];
    }
  }
  __syncthreads();
  for (int i = tid; i < sp.gc * d; i += kThreads) {
    const int g = i / d, e = i % d;
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < G::kKeySubsets; ++j) a += red[(j * R + g) * DMAX + e];
    if (n_splits == 1) {
      const float l = l_s[g];
      store(out + (sp.row0 + g) * d + e, a / (l == 0.f ? 1.f : l));
    } else {
      const size_t slot = (sp.row0 + g) * n_splits + sp.split;
      part_acc[slot * d + e] = a;
      if (e == 0) {
        part_ml[slot * 2] = m_s[g];
        part_ml[slot * 2 + 1] = l_s[g];
      }
    }
  }
  if (n_splits > 1)
    merge_if_last<kThreads>(sp, counters, part_ml, part_acc, out, d, split_len, n_splits);
}

// Launch a split kernel of `threads` threads, `rows_per_block` query rows
// per block and `smem` bytes of dynamic shared memory.
template <typename T, typename Kernel>
cudaError_t launch_split(Kernel kernel, int threads, int rows_per_block, int smem,
                         const void* q, const void* k, const void* v, const void* length,
                         const void* start, void* out, void* scratch, void* counters, int b,
                         int h, int kheads, int s, int d, float scale, int split_len,
                         int n_splits, int vec16,
                         cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int group = h / kheads;
  const int64_t rows =
      static_cast<int64_t>(b) * kheads * ((group + rows_per_block - 1) / rows_per_block);
  if (rows > INT32_MAX || n_splits > 65535) return cudaErrorInvalidValue;
  float* ml = static_cast<float*>(scratch);
  float* acc = ml + static_cast<size_t>(b) * h * n_splits * 2;
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(n_splits));
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(length), static_cast<const int32_t*>(start),
      static_cast<T*>(out), ml, acc, static_cast<int*>(counters), s, kheads, group, d, scale,
      split_len, n_splits, vec16);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, H, D), k and v (B, S, K, D), out (B, H, D), all contiguous and of one
// type (bf16 != 0: bfloat16, else float32); length (B,) int32; start (B,)
// int32, or null for a start of 0 in every row.  With n_splits > 1: scratch
// f32 of B·H·n_splits·(D + 2) elements, and counters int32 of
// B·K·ceil(G / 8) elements that are 0 (the kernel leaves them 0).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* length, const void* start, void* out, void* scratch,
                            void* counters, int b, int h, int kheads, int s, int d, int bf16,
                            float scale, int split_len, int n_splits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b <= 0 || kheads <= 0 || h % kheads != 0 || s < 0 || d <= 0 ||
      d > kMaxHeadDim || split_len <= 0 || n_splits <= 0 ||
      static_cast<int64_t>(split_len) * n_splits < s)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte copies need rows of a multiple of 16 bytes and 16-byte aligned K and V
  const int elem = bf16 ? 2 : 4;
  const int vec16 = (d * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(v) % 16 == 0;
#define DECODE_ARGS q, k, v, length, start, out, scratch, counters, b, h, kheads, s, d, scale, \
                    split_len, n_splits, vec16, st
  if (bf16 && d <= 64)
    return launch_split<__nv_bfloat16>(decode_split_mma_kernel<64>, MmaGeometry<64>::kThreads,
                                       MmaGeometry<64>::kRows, MmaGeometry<64>::kSmem,
                                       DECODE_ARGS);
  if (bf16 && d <= 128)
    return launch_split<__nv_bfloat16>(decode_split_mma_kernel<128>, MmaGeometry<128>::kThreads,
                                       MmaGeometry<128>::kRows, MmaGeometry<128>::kSmem,
                                       DECODE_ARGS);
  if (bf16)
    return launch_split<__nv_bfloat16>(decode_split_simt_kernel<__nv_bfloat16, 256>, kThreads,
                                       SimtGeometry<__nv_bfloat16, 256>::kRows,
                                       SimtGeometry<__nv_bfloat16, 256>::kSmem, DECODE_ARGS);
  if (d <= 64)
    return launch_split<float>(decode_split_simt_kernel<float, 64>, kThreads,
                               SimtGeometry<float, 64>::kRows, SimtGeometry<float, 64>::kSmem,
                               DECODE_ARGS);
  if (d <= 128)
    return launch_split<float>(decode_split_simt_kernel<float, 128>, kThreads,
                               SimtGeometry<float, 128>::kRows, SimtGeometry<float, 128>::kSmem,
                               DECODE_ARGS);
  return launch_split<float>(decode_split_simt_kernel<float, 256>, kThreads,
                             SimtGeometry<float, 256>::kRows, SimtGeometry<float, 256>::kSmem,
                             DECODE_ARGS);
#undef DECODE_ARGS
}

}  // extern "C"
