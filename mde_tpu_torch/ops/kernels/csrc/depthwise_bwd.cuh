// The backward body that K3's dxdw (depthwise_dxdw.cu) and dw
// (depthwise_dw.cu) kernels share.
//
// Forward (depthwise.cu), with replicate padding as clamped coordinates:
//   out[b, h, w, c] = sum_{i, j} wt[i, j, c] * x[b, cl(h + i - P), cl(w + j - P), c]
// so, with g the gradient of out,
//   dw[i, j, c] = sum_{b, h, w} x[b, cl(h + i - P), cl(w + j - P), c] * g[b, h, w, c]
//   dx[b, y, z, c] = sum over (h, w, i, j) with cl(h + i - P) = y and
//                    cl(w + j - P) = z of wt[i, j, c] * g[b, h, w, c].
// For each tap the rows h with cl(h + i - P) = y form one run: the single
// row y + P - i inside the image, widened at y = 0 and y = H - 1 to every
// row whose tap the clamp maps onto the border (the replicate pad's edge
// rows folded back, as the TPU kernel's fold at depthwise.py:380-384 does
// on a padded copy). dx is therefore a gather over clamped runs: no padded
// copy of x or g (the TPU's gp4 and xps, :335-342) is ever written.
//
// Layout: threads run along C, VEC channels each (VEC * 32 threads of a
// warp read 128 contiguous bytes in bf16 pairs). A block is 32 x 8 threads:
// x along channel vectors, y along columns. It covers one image and a band
// of BAND rows; a thread walks its columns (z = threadIdx.y, +8, ...) and,
// inside each, the band's rows, so that the block works on a few columns at
// a time and the taps' reloads hit L1. Every thread keeps its own K x K x VEC
// f32 sums for dw; the block reduces them over threadIdx.y in shared memory
// and writes one partial per (image, band) to `part`. A second kernel sums
// the partials into dw in a fixed order: no atomics, the same bits every run.

#pragma once

#include "common.cuh"

constexpr int DW_BAND = 8;
constexpr int DW_TX = 32;
constexpr int DW_TY = 8;

// rows (or columns) of g whose clamped tap t lands on y: [lo, hi], empty if lo > hi
__device__ __forceinline__ void tap_run(int y, int t, int pad, int size, int& lo, int& hi) {
  const int at = y + pad - t;
  lo = y == 0 ? 0 : at;
  hi = y == size - 1 ? size - 1 : at;
  lo = max(lo, 0);
  hi = min(hi, size - 1);
}

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  const Vec<T, VEC> v = *reinterpret_cast<const Vec<T, VEC>*>(p);
#pragma unroll
  for (int e = 0; e < VEC; ++e) out[e] = to_float(v.v[e]);
}

template <typename T, int VEC, int K, bool DX>
__global__ void __launch_bounds__(DW_TX * DW_TY)
    depthwise_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const T* __restrict__ wt, T* __restrict__ dx,
                         float* __restrict__ part, int H, int W, int C, int bands) {
  constexpr int P = K / 2;
  __shared__ float red[DW_TY][DW_TX * VEC];
  const int cv = blockIdx.x * DW_TX + threadIdx.x;
  const bool active = cv * VEC < C;
  const int band = blockIdx.y, b = blockIdx.z;
  const int y0 = band * DW_BAND, y1 = min(H, y0 + DW_BAND);
  const size_t img = (size_t)b * H * W * C + (size_t)cv * VEC;
  float dw[K][K][VEC];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) dw[i][j][e] = 0.f;

  if (active) {
    for (int z = threadIdx.y; z < W; z += DW_TY) {
      for (int y = y0; y < y1; ++y) {
        float gv[VEC];
        load_vec<T, VEC>(g + img + ((size_t)y * W + z) * C, gv);
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const int hx = min(max(y + i - P, 0), H - 1);
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const int wx = min(max(z + j - P, 0), W - 1);
            float xv[VEC];
            load_vec<T, VEC>(x + img + ((size_t)hx * W + wx) * C, xv);
#pragma unroll
            for (int e = 0; e < VEC; ++e) dw[i][j][e] = fmaf(xv[e], gv[e], dw[i][j][e]);
          }
        }
        if (DX) {
          float acc[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
          for (int i = 0; i < K; ++i) {
            int hlo, hhi;
            tap_run(y, i, P, H, hlo, hhi);
#pragma unroll
            for (int j = 0; j < K; ++j) {
              int wlo, whi;
              tap_run(z, j, P, W, wlo, whi);
              float wv[VEC];
              load_vec<T, VEC>(wt + (size_t)(i * K + j) * C + (size_t)cv * VEC, wv);
              for (int hh = hlo; hh <= hhi; ++hh)
                for (int ww = wlo; ww <= whi; ++ww) {
                  float gs[VEC];
                  load_vec<T, VEC>(g + img + ((size_t)hh * W + ww) * C, gs);
#pragma unroll
                  for (int e = 0; e < VEC; ++e) acc[e] = fmaf(wv[e], gs[e], acc[e]);
                }
            }
          }
          Vec<T, VEC> out;
#pragma unroll
          for (int e = 0; e < VEC; ++e) out.v[e] = from_float<T>(acc[e]);
          *reinterpret_cast<Vec<T, VEC>*>(dx + img + ((size_t)y * W + z) * C) = out;
        }
      }
    }
  }

  // sum the block's dw over threadIdx.y, one tap at a time
  const size_t part_base = (((size_t)b * bands + band) * K * K) * C + (size_t)cv * VEC;
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) red[threadIdx.y][threadIdx.x * VEC + e] = dw[i][j][e];
      __syncthreads();
      if (threadIdx.y == 0 && active) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float s = 0.f;
          for (int t = 0; t < DW_TY; ++t) s += red[t][threadIdx.x * VEC + e];
          part[part_base + (size_t)(i * K + j) * C + e] = s;
        }
      }
      __syncthreads();
    }
}

// dw[t] = sum over p of part[p][t], t over the K*K*C taps, in order of p.
// static: each source that includes this header has its own copy.
static __global__ void depthwise_sum_partials(const float* __restrict__ part, float* __restrict__ dw,
                                       int parts, int taps) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= taps) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += part[(size_t)p * taps + t];
  dw[t] = s;
}

// Partials the wrapper must allocate for `part`: (B * bands, K, K, C) f32.
inline int depthwise_bwd_bands(int H) { return (H + DW_BAND - 1) / DW_BAND; }

template <typename T, int VEC, int K, bool DX>
static int depthwise_bwd_launch(const void* x, const void* g, const void* wt, void* dx,
                                float* part, float* dw, int B, int H, int W, int C,
                                cudaStream_t stream) {
  const int bands = depthwise_bwd_bands(H);
  const int vecs = C / VEC;
  dim3 grid((vecs + DW_TX - 1) / DW_TX, bands, B);
  depthwise_bwd_kernel<T, VEC, K, DX><<<grid, dim3(DW_TX, DW_TY), 0, stream>>>(
      (const T*)x, (const T*)g, (const T*)wt, (T*)dx, part, H, W, C, bands);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int taps = K * K * C;
  depthwise_sum_partials<<<(taps + 255) / 256, 256, 0, stream>>>(part, dw, B * bands, taps);
  return (int)cudaGetLastError();
}

// Dispatch on dtype, vector width (vec2: C even and the tensors aligned to
// two elements) and kernel size (3, 5 or 7).
template <bool DX>
static int depthwise_bwd_dispatch(const void* x, const void* g, const void* wt, void* dx,
                                  float* part, float* dw, int B, int H, int W, int C, int k,
                                  int vec2, int dtype, cudaStream_t s) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || (vec2 && C % 2) || B > 65535 ||
      depthwise_bwd_bands(H) > 65535)
    return (int)cudaErrorInvalidValue;
#define MDE_DW_CASE(T, V, KK) \
  return depthwise_bwd_launch<T, V, KK, DX>(x, g, wt, dx, part, dw, B, H, W, C, s)
#define MDE_DW_K(T, V)             \
  switch (k) {                     \
    case 3: MDE_DW_CASE(T, V, 3);  \
    case 5: MDE_DW_CASE(T, V, 5);  \
    case 7: MDE_DW_CASE(T, V, 7);  \
    default: return (int)cudaErrorInvalidValue; \
  }
  if (dtype == MDE_F32) {
    if (vec2) { MDE_DW_K(float, 2) } else { MDE_DW_K(float, 1) }
  }
  if (dtype == MDE_BF16) {
    if (vec2) { MDE_DW_K(__nv_bfloat16, 2) } else { MDE_DW_K(__nv_bfloat16, 1) }
  }
#undef MDE_DW_K
#undef MDE_DW_CASE
  return (int)cudaErrorInvalidValue;
}
