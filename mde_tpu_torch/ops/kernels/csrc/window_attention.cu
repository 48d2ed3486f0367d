// K1: window multi-head attention (Swin W-MSA / SW-MSA), forward.
//
// Replaces the TPU kernel _pallas_window_attention
// (mde_tpu/ops/pallas/window_attention.py:139, body _kernel :101), reached
// through fused_window_attention (:352). Per window and head it computes
//   softmax(q*scale . k^T + bias[h] + mask[w mod nW]) . v
// with q scaled in the input dtype, as the TPU kernel does (:122).
//
// What bounds it on an H100: at the main-path shapes (stage 1: 4096 windows
// of 49 tokens, 128 channels, 4 heads, head dim 32, batch 8, bf16) it reads
// q, k, v and writes out once, 205 MB, 61 us at 3.35 TB/s, against 5 GFLOP
// (5 us on the bf16 tensor cores): it is bound by bytes.
//
// Design: one block per (window, head). The head's q, k and v (49 x 32) are
// staged in shared memory as f32, the 49 x 49 scores stay in shared memory
// through bias, mask and a warp-per-row softmax, and P.v is written straight
// to the output. Nothing of size (windows, heads, N, N) touches device
// memory. q, k and v may be strided views of one fused qkv projection (row
// stride ld), so the caller needs no copies. Products run on the CUDA cores
// in f32; tensor cores (wgmma) are later work. The TPU-only tricks (window
// pairs packed to 128 lanes, the VMEM block picker) have no counterpart.

#include "common.cuh"

template <typename T>
__global__ void window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                        const T* __restrict__ v,
                                        const float* __restrict__ bias,
                                        const float* __restrict__ mask, T* __restrict__ out,
                                        int n, int c, int hd, int ld, int nw, float scale) {
  extern __shared__ float smem[];
  const int w = blockIdx.x, h = blockIdx.y;
  const size_t in_off = (size_t)w * n * ld + (size_t)h * hd;
  const size_t out_off = (size_t)w * n * c + (size_t)h * hd;
  const float* bh = bias ? bias + (size_t)h * n * n : nullptr;
  const float* mw = mask ? mask + (size_t)(w % nw) * n * n : nullptr;
  auto add = [=](int r, int col) {
    float b = 0.f;
    if (bh) b += bh[r * n + col];
    if (mw) b += mw[r * n + col];
    return b;
  };
  window_head_attention<T, true>(q + in_off, k + in_off, v + in_off, out + out_off, n, hd, ld,
                                 c, scale, smem, add);
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, const float* bias,
                  const float* mask, void* out, int bw, int n, int c, int heads, int ld,
                  int nw, float scale, cudaStream_t stream) {
  const int hd = c / heads;
  const size_t smem = window_head_smem_floats(n, hd) * sizeof(float);
  cudaError_t err = allow_smem(window_attention_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bw, heads);
  window_attention_kernel<T><<<grid, 128, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, mask, (T*)out, n, c, hd, ld, nw, scale);
  return (int)cudaGetLastError();
}

// q, k, v: (bw, n, c) with rows ld elements apart; bias: (heads, n, n) f32
// or null; mask: (nw, n, n) f32 or null; out: contiguous (bw, n, c).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int mde_window_attention(const void* q, const void* k, const void* v,
                                    const float* bias, const float* mask, void* out, int bw,
                                    int n, int c, int heads, int ld, int nw, float scale,
                                    int dtype, void* stream) {
  if (heads <= 0 || c % heads != 0 || n <= 0 || (mask && nw <= 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MDE_F32)
    return launch<float>(q, k, v, bias, mask, out, bw, n, c, heads, ld, nw, scale, s);
  if (dtype == MDE_BF16)
    return launch<__nv_bfloat16>(q, k, v, bias, mask, out, bw, n, c, heads, ld, nw, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mde_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
