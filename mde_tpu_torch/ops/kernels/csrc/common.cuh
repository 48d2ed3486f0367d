// Shared helpers for the port's hand-written kernels: element conversion,
// 16-byte vectors, warp reductions, dtype codes and the window-attention
// body that K1 (window_attention.cu) and K2 (ordered_attention.cu) share.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed from Python (mde_tpu_torch/ops/kernels/__init__.py)
#define MDE_F32 0
#define MDE_BF16 1

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round a float to T's precision and back (mirrors a cast to the input dtype).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

template <typename T, int VEC> struct alignas(sizeof(T) * VEC) Vec { T v[VEC]; };

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Floats of shared memory that window_head_attention needs for n tokens at
// head dim hd: q (n*hd), k (n*(hd+1), padded so that threads reading
// different keys hit different banks), v (n*hd) and the scores (n*n).
__host__ __device__ inline size_t window_head_smem_floats(int n, int hd) {
  return (size_t)n * hd * 3 + n + (size_t)n * n;
}

// softmax(q.k^T * scale + bias(row, col)) . v for one (window, head).
// q, k, v point at the head's first element of the window, rows `ld`
// elements apart; out is contiguous (rows `ldo` apart). Products and sums
// are f32; the probabilities are rounded to T before P.v, as the plain
// version rounds them to the input dtype.
// PRESCALE: scale q in T before q.k^T (the JAX window-attention kernel);
// otherwise scale the f32 logits (the JAX ordered-attention plain path).
template <typename T, bool PRESCALE, typename BiasFn>
__device__ void window_head_attention(const T* __restrict__ q, const T* __restrict__ k,
                                      const T* __restrict__ v, T* __restrict__ out, int n,
                                      int hd, int ld, int ldo, float scale, float* smem,
                                      BiasFn bias) {
  const int ldk = hd + 1;
  float* sq = smem;
  float* sk = sq + n * hd;
  float* sv = sk + n * ldk;
  float* sp = sv + n * hd;
  const float scale_t = to_float(from_float<T>(scale));
  for (int i = threadIdx.x; i < n * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    const size_t off = (size_t)r * ld + d;
    const float qv = to_float(q[off]);
    sq[i] = PRESCALE ? round_to<T>(qv * scale_t) : qv;
    sk[r * ldk + d] = to_float(k[off]);
    sv[i] = to_float(v[off]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    const int r = i / n, c = i - r * n;
    const float* qr = sq + r * hd;
    const float* kc = sk + c * ldk;
    float s = 0.f;
    for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kc[d], s);
    sp[i] = (PRESCALE ? s : s * scale) + bias(r, c);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int r = warp; r < n; r += nwarps) {
    float* row = sp + r * n;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);
    for (int j = lane; j < n; j += 32) row[j] = round_to<T>(row[j] * inv);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    const float* pr = sp + r * n;
    float o = 0.f;
    for (int j = 0; j < n; ++j) o = fmaf(pr[j], sv[j * hd + d], o);
    out[(size_t)r * ldo + d] = from_float<T>(o);
  }
}

// Allow a kernel more than 48 KB of dynamic shared memory when it needs it.
template <typename K> inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
