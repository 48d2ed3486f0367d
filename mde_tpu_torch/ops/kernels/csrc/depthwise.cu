// K3: depthwise 'same' 2-D convolution with replicate padding, NHWC, forward.
//
// Replaces the TPU kernel _pallas_depthwise
// (mde_tpu/ops/pallas/depthwise.py:405, bodies _kernel :79 and
// _roll_kernel :103), reached through fused_depthwise_conv2d (:521):
//   out[b, h, w, c] = sum_{i, j} wt[i, j, c] * x[b, clamp(h+i-kh/2), clamp(w+j-kw/2), c]
//
// What bounds it on an H100: at the main-path shape (8, 112, 224, 2048) bf16
// with a 5x5 kernel it reads x and writes out once, 822 MB, 245 us at
// 3.35 TB/s, against 20.6 GFLOP (21 us at the 989 TFLOP/s bf16 peak): it is
// bound by bytes. This kernel does those operations as f32 multiply-adds on
// the CUDA cores, 0.31 ms at their 67 TFLOP/s, so its own arithmetic is the
// nearer ceiling.
//
// Design: threads run along C, each owning VEC channels (16 bytes: 8 bf16 or
// 4 f32) so that a warp reads 512 contiguous bytes per tap. A thread walks a
// strip of ROWS output rows of one column: every input row it loads (5 taps
// across W) feeds all the output rows it touches, so it loads
// (ROWS+kh-1)*kw vectors for ROWS*kh*kw taps. The replicate pad is clamped
// coordinates: no padded copy is ever written. Sums are f32 in the order of
// the plain version (i outer, j inner). The TPU kernel's halo blocks and
// sublane relayouts have no counterpart here.

#include "common.cuh"

constexpr int ROWS = 8;

template <typename T, int VEC>
__global__ void depthwise_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                                 T* __restrict__ out, int H, int W, int C, int kh, int kw,
                                 int strips) {
  const int cv = blockIdx.x * blockDim.x + threadIdx.x;
  if (cv * VEC >= C) return;
  const int wo = blockIdx.y;
  const int b = blockIdx.z / strips;
  const int h0 = (blockIdx.z - b * strips) * ROWS;
  const int ph = kh / 2, pw = kw / 2;
  float acc[ROWS][VEC];
#pragma unroll
  for (int o = 0; o < ROWS; ++o)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[o][e] = 0.f;

  const T* xb = x + (size_t)b * H * W * C + (size_t)cv * VEC;
  const T* wc = wt + (size_t)cv * VEC;
  for (int r = h0 - ph; r < h0 + ROWS + ph; ++r) {
    const int hr = min(max(r, 0), H - 1);
    for (int j = 0; j < kw; ++j) {
      const int wr = min(max(wo + j - pw, 0), W - 1);
      const Vec<T, VEC> xv = *reinterpret_cast<const Vec<T, VEC>*>(xb + ((size_t)hr * W + wr) * C);
#pragma unroll
      for (int o = 0; o < ROWS; ++o) {
        const int i = r - h0 - o + ph;  // tap row of input row r for output row h0+o
        if (i < 0 || i >= kh) continue;
        const Vec<T, VEC> wv = *reinterpret_cast<const Vec<T, VEC>*>(wc + (size_t)(i * kw + j) * C);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[o][e] = fmaf(to_float(xv.v[e]), to_float(wv.v[e]), acc[o][e]);
      }
    }
  }
#pragma unroll
  for (int o = 0; o < ROWS; ++o) {
    const int ho = h0 + o;
    if (ho >= H) break;
    Vec<T, VEC> ov;
#pragma unroll
    for (int e = 0; e < VEC; ++e) ov.v[e] = from_float<T>(acc[o][e]);
    *reinterpret_cast<Vec<T, VEC>*>(out + (((size_t)b * H + ho) * W + wo) * C + (size_t)cv * VEC) = ov;
  }
}

template <typename T, int VEC>
static int launch(const void* x, const void* wt, void* out, int B, int H, int W, int C, int kh,
                  int kw, cudaStream_t stream) {
  const int threads = 128;
  const int vecs = C / VEC;
  const int strips = (H + ROWS - 1) / ROWS;
  dim3 grid((vecs + threads - 1) / threads, W, B * strips);
  depthwise_kernel<T, VEC><<<grid, threads, 0, stream>>>((const T*)x, (const T*)wt, (T*)out, H,
                                                         W, C, kh, kw, strips);
  return (int)cudaGetLastError();
}

// x, out: contiguous (B, H, W, C); wt: contiguous (kh, kw, C), same dtype as x.
// vec16 != 0 selects 16-byte channel vectors: C must be a multiple of
// 16 / itemsize and x, wt, out 16-byte aligned (the wrapper checks both).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int mde_depthwise_conv2d(const void* x, const void* wt, void* out, int B, int H,
                                    int W, int C, int kh, int kw, int vec16, int dtype,
                                    void* stream) {
  if (kh % 2 == 0 || kw % 2 == 0 || kh <= 0 || kw <= 0 || W > 65535 || B <= 0 || H <= 0 ||
      C <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MDE_F32)
    return vec16 ? launch<float, 4>(x, wt, out, B, H, W, C, kh, kw, s)
                 : launch<float, 1>(x, wt, out, B, H, W, C, kh, kw, s);
  if (dtype == MDE_BF16)
    return vec16 ? launch<__nv_bfloat16, 8>(x, wt, out, B, H, W, C, kh, kw, s)
                 : launch<__nv_bfloat16, 1>(x, wt, out, B, H, W, C, kh, kw, s);
  return (int)cudaErrorInvalidValue;
}
