// K4: the fused eval feed-forward middle, GLU gate + depthwise conv with
// replicate padding + folded BatchNorm + exact-erf GELU, NHWC, forward.
//
// Replaces the TPU kernel _pallas_glu_ff (mde_tpu/ops/pallas/glu_ff.py:150,
// bodies _kernel :81 and _kernel_roll :118, the default), reached through
// fused_glu_dwconv_bn_gelu (:245):
//   g[b, h, w, c]   = a * sigmoid(b)          (ab = a | b along channels,
//                                               in the input dtype)
//   y[b, h, w, c]   = sum_{i, j} wt[i, j, c] * g[b, clamp(h+i-kh/2), clamp(w+j-kw/2), c]
//   out[b, h, w, c] = gelu_erf(y * s[c] + t[c])
// with the taps summed in f32 (as _kernel_roll does), the affine and GELU
// in f32, and one cast to the output dtype.
//
// What bounds it on an H100: at the flagship's serving shape (8, 112, 224,
// 2 x 2048) bf16 with a 5x5 kernel it reads ab once and writes out once,
// 2.47 GB, 0.74 ms at 3.35 TB/s, against 21 GFLOP of taps (21 us at the
// 989 TFLOP/s bf16 peak): it is bound by bytes. The unfused chain writes and
// reads the gate, the conv output and the BatchNorm output besides.
//
// Design: K3's forward (depthwise.cu) with the gate folded into its loads.
// Threads run along C, each owning VEC channels (16 bytes) of both halves,
// and walk a strip of ROWS output rows of one column; every input pixel a
// thread loads (a and b, two 16-byte vectors) is gated once in registers
// and feeds every output row it touches. The replicate pad is clamped
// coordinates, since the gate commutes with it. The epilogue (affine, erff
// GELU) runs in registers before the single store.

#include "common.cuh"

constexpr int ROWS = 8;

// a * sigmoid(b), each step rounded to T as the plain version's ops in T are.
template <typename T>
__device__ __forceinline__ float gate(T a, T b) {
  const float sg = round_to<T>(1.f / (1.f + expf(-to_float(b))));
  return round_to<T>(to_float(a) * sg);
}

template <typename T, int VEC>
__global__ void glu_ff_kernel(const T* __restrict__ ab, const T* __restrict__ wt,
                              const float* __restrict__ sc, const float* __restrict__ sh,
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

  const T* ab_b = ab + (size_t)b * H * W * 2 * C + (size_t)cv * VEC;
  const T* wc = wt + (size_t)cv * VEC;
  for (int r = h0 - ph; r < h0 + ROWS + ph; ++r) {
    const int hr = min(max(r, 0), H - 1);
    for (int j = 0; j < kw; ++j) {
      const int wr = min(max(wo + j - pw, 0), W - 1);
      const T* px = ab_b + ((size_t)hr * W + wr) * 2 * C;
      const Vec<T, VEC> av = *reinterpret_cast<const Vec<T, VEC>*>(px);
      const Vec<T, VEC> bv = *reinterpret_cast<const Vec<T, VEC>*>(px + C);
      float g[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) g[e] = gate(av.v[e], bv.v[e]);
#pragma unroll
      for (int o = 0; o < ROWS; ++o) {
        const int i = r - h0 - o + ph;  // tap row of input row r for output row h0+o
        if (i < 0 || i >= kh) continue;
        const Vec<T, VEC> wv = *reinterpret_cast<const Vec<T, VEC>*>(wc + (size_t)(i * kw + j) * C);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[o][e] = fmaf(g[e], to_float(wv.v[e]), acc[o][e]);
      }
    }
  }
  float s[VEC], t[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    s[e] = sc[cv * VEC + e];
    t[e] = sh[cv * VEC + e];
  }
#pragma unroll
  for (int o = 0; o < ROWS; ++o) {
    const int ho = h0 + o;
    if (ho >= H) break;
    Vec<T, VEC> ov;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float y = acc[o][e] * s[e] + t[e];
      ov.v[e] = from_float<T>(0.5f * y * (1.f + erff(y * 0.70710678118654752f)));
    }
    *reinterpret_cast<Vec<T, VEC>*>(out + (((size_t)b * H + ho) * W + wo) * C + (size_t)cv * VEC) = ov;
  }
}

template <typename T, int VEC>
static int launch(const void* ab, const void* wt, const float* sc, const float* sh, void* out,
                  int B, int H, int W, int C, int kh, int kw, cudaStream_t stream) {
  const int threads = 128;
  const int vecs = C / VEC;
  const int strips = (H + ROWS - 1) / ROWS;
  dim3 grid((vecs + threads - 1) / threads, W, B * strips);
  glu_ff_kernel<T, VEC><<<grid, threads, 0, stream>>>((const T*)ab, (const T*)wt, sc, sh,
                                                      (T*)out, H, W, C, kh, kw, strips);
  return (int)cudaGetLastError();
}

// ab: contiguous (B, H, W, 2C), a | b along the last dim; wt: contiguous
// (kh, kw, C) in ab's dtype; sc, sh: (C,) f32; out: contiguous (B, H, W, C).
// vec16 != 0 selects 16-byte channel vectors: C must be a multiple of
// 16 / itemsize and ab, wt, out 16-byte aligned (the wrapper checks both).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int mde_glu_ff(const void* ab, const void* wt, const float* sc, const float* sh,
                          void* out, int B, int H, int W, int C, int kh, int kw, int vec16,
                          int dtype, void* stream) {
  if (kh % 2 == 0 || kw % 2 == 0 || kh <= 0 || kw <= 0 || W > 65535 || B <= 0 || H <= 0 ||
      C <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MDE_F32)
    return vec16 ? launch<float, 4>(ab, wt, sc, sh, out, B, H, W, C, kh, kw, s)
                 : launch<float, 1>(ab, wt, sc, sh, out, B, H, W, C, kh, kw, s);
  if (dtype == MDE_BF16)
    return vec16 ? launch<__nv_bfloat16, 8>(ab, wt, sc, sh, out, B, H, W, C, kh, kw, s)
                 : launch<__nv_bfloat16, 1>(ab, wt, sc, sh, out, B, H, W, C, kh, kw, s);
  return (int)cudaErrorInvalidValue;
}
