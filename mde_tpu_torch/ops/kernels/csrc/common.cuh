// Shared helpers for the port's hand-written kernels: element conversion,
// 16-byte vectors, warp reductions, dtype codes, the window-attention body
// that K1 (window_attention.cu) and K2 (ordered_attention.cu) share, and the
// shared-memory sizes of K5 (channel_attention*.cu).
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

// Floats of shared memory that window_head_attention_bwd needs for n tokens
// at head dim hd: q*scale and dO (n*hd each), k and v (n*(hd+1) each,
// padded like k above), P and dS (n*n each).
__host__ __device__ inline size_t window_head_bwd_smem_floats(int n, int hd) {
  return (size_t)n * hd * 2 + (size_t)n * (hd + 1) * 2 + (size_t)n * n * 2;
}

// Gradients of softmax(qs . k^T + bias(row, col)) . v for one (window,
// head), qs = q*scale rounded to T (the JAX backward kernels scale q in the
// input dtype for both attentions). Recomputes S and P in f32, then
//   dP = dO . v^T, dS = P * (dP - rowsum(dP * P)),
//   dq = dS . k * scale, dk = dS^T . qs, dv = P^T . dO,
// with P and dS rounded to T before those three products, as the JAX kernel
// casts them. q, k, v point at the head's first element of the window, rows
// `ld` apart; dout rows `ldo` apart; dq, dk, dv rows `ldg` apart.
// sink(row, col, ds) receives every f32 dS once; the thread that calls it
// for a given (row, col) depends only on (row, col) and blockDim, so a sink
// may accumulate into a per-entry slot without atomics. The caller
// synchronises before it reuses smem.
template <typename T, typename BiasFn, typename SinkFn>
__device__ void window_head_attention_bwd(const T* __restrict__ q, const T* __restrict__ k,
                                          const T* __restrict__ v, const T* __restrict__ dout,
                                          T* __restrict__ dq, T* __restrict__ dk,
                                          T* __restrict__ dv, int n, int hd, int ld, int ldo,
                                          int ldg, float scale, float* smem, BiasFn bias,
                                          SinkFn sink) {
  const int ldk = hd + 1;
  float* sq = smem;           // q * scale, rounded to T
  float* sdo = sq + n * hd;   // dO
  float* sk = sdo + n * hd;   // k, rows ldk apart
  float* sv = sk + n * ldk;   // v, rows ldk apart
  float* sp = sv + n * ldk;   // S, then P, then P rounded to T
  float* sd = sp + n * n;     // dP, then dS rounded to T
  const float scale_t = to_float(from_float<T>(scale));
  for (int i = threadIdx.x; i < n * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    const size_t off = (size_t)r * ld + d;
    sq[i] = round_to<T>(to_float(q[off]) * scale_t);
    sk[r * ldk + d] = to_float(k[off]);
    sv[r * ldk + d] = to_float(v[off]);
    sdo[i] = to_float(dout[(size_t)r * ldo + d]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    const int r = i / n, c = i - r * n;
    const float* qr = sq + r * hd;
    const float* dor = sdo + r * hd;
    const float* kc = sk + c * ldk;
    const float* vc = sv + c * ldk;
    float s = 0.f, dp = 0.f;
    for (int d = 0; d < hd; ++d) {
      s = fmaf(qr[d], kc[d], s);
      dp = fmaf(dor[d], vc[d], dp);
    }
    sp[i] = s + bias(r, c);
    sd[i] = dp;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int r = warp; r < n; r += nwarps) {
    float* prow = sp + r * n;
    float* drow = sd + r * n;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, prow[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(prow[j] - m);
      prow[j] = e;
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);
    float dot = 0.f;
    for (int j = lane; j < n; j += 32) {
      prow[j] *= inv;
      dot = fmaf(drow[j], prow[j], dot);
    }
    dot = warp_sum(dot);
    for (int j = lane; j < n; j += 32) {
      const float p = prow[j];
      const float ds = p * (drow[j] - dot);
      sink(r, j, ds);
      prow[j] = round_to<T>(p);
      drow[j] = round_to<T>(ds);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    float gq = 0.f, gk = 0.f, gv = 0.f;
    for (int j = 0; j < n; ++j) {
      gq = fmaf(sd[r * n + j], sk[j * ldk + d], gq);  // dS[r, j] k[j, d]
      gk = fmaf(sd[j * n + r], sq[j * hd + d], gk);   // dS[j, r] qs[j, d]
      gv = fmaf(sp[j * n + r], sdo[j * hd + d], gv);  // P[j, r] dO[j, d]
    }
    const size_t off = (size_t)r * ldg + d;
    dq[off] = from_float<T>(gq * scale);
    dk[off] = from_float<T>(gk);
    dv[off] = from_float<T>(gv);
  }
}

// Floats of shared memory one (window, head) pair of the channel attention
// (K5) takes at n tokens, decoder head dim hd and encoder head dim ehd:
// q (n*hd), k and v (n*ehd each) and P (hd rows padded to ehd+1).
__host__ __device__ inline size_t channel_pair_smem_floats(int n, int hd, int ehd) {
  return (size_t)n * hd + 2 * (size_t)n * ehd + (size_t)hd * (ehd + 1);
}

// The same for K5's backward: q and dO (n*hd each), k and v (n*ehd each),
// P and dS (hd rows padded to ehd+1 each).
__host__ __device__ inline size_t channel_pair_bwd_smem_floats(int n, int hd, int ehd) {
  return 2 * (size_t)n * hd + 2 * (size_t)n * ehd + 2 * (size_t)hd * (ehd + 1);
}

// Windows per block for the backward kernels: enough blocks to fill the
// card several times over (132 SMs, ~8 blocks each), each walking a run of
// windows so that its sum across windows meets device memory once.
inline int windows_per_block(int bw, int heads) {
  const int target = 132 * 8;
  const long long work = (long long)bw * heads;
  return (int)((work + target - 1) / target);
}

// Allow a kernel more than 48 KB of dynamic shared memory when it needs it.
template <typename K> inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
