// GQA flash-decode attention, written by hand for Hopper (sm_90a), behind a
// plain C interface loaded with ctypes (repro_torch/kernels/build.py builds
// this file with nvcc at first use).
//
// Replaces kernels/decode_attention/decode_attention.py::decode_attention
// (Pallas, _decode_kernel) of the JAX package: one new query token per batch
// row attends to a (B, S, K, D) KV cache, query head h reading KV head
// h / G (H = G·K), keys t < length[b] valid, f32 online softmax, the result
// cast to q's dtype.  A row with no valid key gives 0 (normaliser 0 -> 1, as
// in the TPU kernel).  The plain torch version is
// repro_torch/kernels/decode_attention/ref.py::decode_attention_ref.
//
// Bound on an H100: bytes.  A call reads each valid key and value row once
// (2 · Σ_b length[b] · K · D elements) plus q, and writes out; it does
// 4 · Σ_b length[b] · H · D float operations, about one per byte read in
// bf16, far below the ~20 f32 ops per byte the card needs before the
// arithmetic units bound it.  At the serving path's shape (B = 4 slots,
// K = 8, D = 64, lengths ~130-160, bf16) that is ~1.3 MB, 0.4 µs of HBM
// time, so a call is bound by its launch; at B = 8, S = 8192 it is 134 MB,
// 40 µs.
//
// Design (simple, correct first; split-KV across blocks, TMA and wgmma are
// later work): one block of 8 warps per (batch row, KV head, group of up to
// 8 query rows).  Each lane owns EPL = ceil(D / 32) consecutive elements of
// the head dimension, so a warp reads one key row (D contiguous elements)
// per load, coalesced.  The block's G query rows stay in registers.  Warp w
// streams keys w·U, w·U + 8U, … in steps of U keys whose K and V rows it
// loads together (U loads in flight per lane), reduces the U·G dot products
// with warp shuffles and keeps its own running max, normaliser and
// accumulator in registers.  Each K/V element is read by exactly one warp,
// so staging the rows in shared memory would buy no reuse; shared memory
// holds only the final merge of the 8 warps' partial softmax states, done in
// warp order so the result does not depend on scheduling.  Keys past a row's
// length are never read.  The launcher never synchronises, allocates
// nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroup = 8;      // query rows per block; longer groups run in chunks
constexpr int kMaxHeadDim = 256;  // EPL <= 8

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T, int EPL>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int32_t* __restrict__ length, T* __restrict__ out, int s, int kheads,
    int group, int d, float scale) {
  constexpr int U = EPL <= 2 ? 4 : (EPL <= 4 ? 2 : 1);  // keys per warp step
  const int chunks = (group + kMaxGroup - 1) / kMaxGroup;
  const int bk = blockIdx.x / chunks;
  const int g0 = (blockIdx.x % chunks) * kMaxGroup;
  const int gc = min(kMaxGroup, group - g0);
  const int b = bk / kheads, kh = bk % kheads;
  const int h = kheads * group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = max(0, min(length[b], s));

  // q rows of this block, this lane's slice of the head dimension
  const T* qb = q + (static_cast<size_t>(b) * h + static_cast<size_t>(kh) * group + g0) * d;
  float qr[kMaxGroup][EPL];
  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][EPL];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int dd = lane * EPL + e;
      qr[g][e] = (g < gc && dd < d) ? to_f32(qb[static_cast<size_t>(g) * d + dd]) : 0.f;
      acc[g][e] = 0.f;
    }
  }

  const size_t key_stride = static_cast<size_t>(kheads) * d;
  const size_t base = static_cast<size_t>(b) * s * key_stride + static_cast<size_t>(kh) * d;
  const T* kb = k + base;
  const T* vb = v + base;
  for (int t0 = warp * U; t0 < len; t0 += kWarps * U) {
    float kr[U][EPL], vr[U][EPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int dd = lane * EPL + e;
        const bool ok = t < len && dd < d;
        const size_t off = static_cast<size_t>(t) * key_stride + dd;
        kr[u][e] = ok ? to_f32(kb[off]) : 0.f;
        vr[u][e] = ok ? to_f32(vb[off]) : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < gc) {  // uniform across the block
        float sc[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) part = fmaf(qr[g][e], kr[u][e], part);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
          sc[u] = (t0 + u < len) ? part * scale : -CUDART_INF_F;
        }
        float mt = sc[0];  // key t0 is valid, so mt is finite
#pragma unroll
        for (int u = 1; u < U; ++u) mt = fmaxf(mt, sc[u]);
        const float mn = fmaxf(m[g], mt);
        const float alpha = expf(m[g] - mn);  // 0 while m[g] is -inf
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float p = expf(sc[u] - mn);  // 0 on a masked key
          l[g] += p;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vr[u][e], acc[g][e]);
        }
        m[g] = mn;
      }
    }
  }

  // merge the warps' partial softmax states, in warp order
  __shared__ float sm[kWarps][kMaxGroup], sl[kWarps][kMaxGroup];
  __shared__ float sacc[kMaxGroup][kMaxHeadDim];
  __shared__ float stot[kMaxGroup];
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      sm[warp][g] = m[g];
      sl[warp][g] = l[g];
    }
  }
  for (int i = threadIdx.x; i < kMaxGroup * kMaxHeadDim; i += kThreads)
    sacc[i / kMaxHeadDim][i % kMaxHeadDim] = 0.f;
  __syncthreads();
  float wscale[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    float mx = -CUDART_INF_F;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm[w][g]);
    wscale[g] = m[g] == -CUDART_INF_F ? 0.f : expf(m[g] - mx);
    if (threadIdx.x == g && g < gc) {
      float tot = 0.f;
      for (int w = 0; w < kWarps; ++w)
        tot += sm[w][g] == -CUDART_INF_F ? 0.f : sl[w][g] * expf(sm[w][g] - mx);
      stot[g] = tot;
    }
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const int dd = lane * EPL + e;
          if (g < gc && dd < d) sacc[g][dd] += acc[g][e] * wscale[g];
        }
      }
    }
    __syncthreads();
  }
  T* ob = out + (static_cast<size_t>(b) * h + static_cast<size_t>(kh) * group + g0) * d;
  for (int i = threadIdx.x; i < gc * d; i += kThreads) {
    const int g = i / d, dd = i % d;
    const float tot = stot[g];
    store(ob + static_cast<size_t>(g) * d + dd, sacc[g][dd] / (tot == 0.f ? 1.f : tot));
  }
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* length, void* out, int blocks, int s,
                         int kheads, int group, int d, float scale,
                         cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const int32_t* lp = static_cast<const int32_t*>(length);
  T* op = static_cast<T*>(out);
  if (d <= 64) {
    decode_attention_kernel<T, 2><<<blocks, kThreads, 0, stream>>>(
        qp, kp, vp, lp, op, s, kheads, group, d, scale);
  } else if (d <= 128) {
    decode_attention_kernel<T, 4><<<blocks, kThreads, 0, stream>>>(
        qp, kp, vp, lp, op, s, kheads, group, d, scale);
  } else {
    decode_attention_kernel<T, 8><<<blocks, kThreads, 0, stream>>>(
        qp, kp, vp, lp, op, s, kheads, group, d, scale);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, H, D), k and v (B, S, K, D), out (B, H, D), all contiguous and of one
// type (bf16 != 0: bfloat16, else float32); length (B,) int32.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* length, void* out, int b, int h,
                            int kheads, int s, int d, int bf16, float scale,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b <= 0 || kheads <= 0 || h % kheads != 0 || s < 0 || d <= 0 ||
      d > kMaxHeadDim)
    return cudaErrorInvalidValue;
  const int group = h / kheads;
  const int64_t blocks = static_cast<int64_t>(b) * kheads *
                         ((group + kMaxGroup - 1) / kMaxGroup);
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_typed<__nv_bfloat16>(q, k, v, length, out, static_cast<int>(blocks),
                                       s, kheads, group, d, scale, st);
  return launch_typed<float>(q, k, v, length, out, static_cast<int>(blocks), s,
                             kheads, group, d, scale, st);
}

}  // extern "C"
