// K1 backward: gradients of window multi-head attention (W-MSA / SW-MSA).
//
// Replaces the TPU kernel _pallas_window_attention_bwd
// (mde_tpu/ops/pallas/window_attention.py:235, body _bwd_kernel :180).
// Per window and head it recomputes P = softmax(qs . k^T + bias[h] +
// mask[w mod nW]) from the saved q, k, v (qs = q*scale in the input dtype,
// :203), forms dS = P * (dP - rowsum(dP * P)) with dP = dO . v^T, and writes
//   dq = dS . k * scale, dk = dS^T . qs, dv = P^T . dO
// into one fused (B*nW, N, 3C) gradient laid out like the qkv projection,
// plus dbias[h] = sum over windows of dS (f32).
//
// What bounds it on an H100: at the train path's stage-1 shape (2048
// windows of 49 tokens, 128 channels, 4 heads, head dim 32, batch 4, bf16)
// it reads q, k, v, dO and writes dq, dk, dv once, 7 * 2048*49*128 * 2 B =
// 180 MB, 54 us at 3.35 TB/s, against 10 * 2048*49^2*128 = 6.3 GFLOP (6 us on
// the bf16 tensor cores): it is bound by bytes.
//
// Design: one block per (run of windows, head). For each window the block
// stages q, k, v and dO in shared memory as f32, keeps S, P, dP and dS
// (49 x 49) there, and writes the three gradients straight out; nothing of
// size (windows, heads, N, N) touches device memory. The TPU summed dbias
// over its sequential grid; Hopper's blocks run in no order, so each block
// sums dS over the windows it walks in shared memory (each entry owned by
// one thread, no atomics) and then adds its 49 x 49 partial to a zeroed f32
// buffer with one atomicAdd per entry. The order of those adds, and so the
// last bits of dbias, changes from run to run. Products run on the CUDA
// cores in f32, as in the forward; window-pair packing and _pick_tb are TPU
// tricks with no counterpart.

#include "common.cuh"

template <typename T>
__global__ void window_attention_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                                            const float* __restrict__ bias,
                                            const float* __restrict__ mask,
                                            T* __restrict__ dqkv, float* __restrict__ dbias,
                                            int bw, int n, int c, int hd, int nw, int wpb,
                                            float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.y;
  float* acc = smem + window_head_bwd_smem_floats(n, hd);  // (n, n) dbias partial
  if (dbias)
    for (int i = threadIdx.x; i < n * n; i += blockDim.x) acc[i] = 0.f;
  const float* bh = bias ? bias + (size_t)h * n * n : nullptr;
  const int w0 = (int)blockIdx.x * wpb;
  const int w_end = min(bw, w0 + wpb);
  for (int w = w0; w < w_end; ++w) {
    const float* mw = mask ? mask + (size_t)(w % nw) * n * n : nullptr;
    auto add = [=](int r, int col) {
      float b = 0.f;
      if (bh) b += bh[r * n + col];
      if (mw) b += mw[r * n + col];
      return b;
    };
    auto sink = [=](int r, int col, float ds) {
      if (dbias) acc[r * n + col] += ds;
    };
    const size_t in_off = (size_t)w * n * 3 * c + (size_t)h * hd;
    const size_t out_off = (size_t)w * n * c + (size_t)h * hd;
    // the body's first __syncthreads also orders the zeroing of acc above
    window_head_attention_bwd<T>(qkv + in_off, qkv + in_off + c, qkv + in_off + 2 * c,
                                 dout + out_off, dqkv + in_off, dqkv + in_off + c,
                                 dqkv + in_off + 2 * c, n, hd, 3 * c, c, 3 * c, scale, smem,
                                 add, sink);
    __syncthreads();
  }
  if (dbias)
    for (int i = threadIdx.x; i < n * n; i += blockDim.x)
      atomicAdd(dbias + (size_t)h * n * n + i, acc[i]);
}

template <typename T>
static int launch(const void* qkv, const void* dout, const float* bias, const float* mask,
                  void* dqkv, float* dbias, int bw, int n, int c, int heads, int nw, float scale,
                  cudaStream_t stream) {
  const int hd = c / heads;
  const size_t smem =
      (window_head_bwd_smem_floats(n, hd) + (dbias ? (size_t)n * n : 0)) * sizeof(float);
  cudaError_t err = allow_smem(window_attention_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int wpb = windows_per_block(bw, heads);
  dim3 grid((bw + wpb - 1) / wpb, heads);
  window_attention_bwd_kernel<T><<<grid, 256, smem, stream>>>(
      (const T*)qkv, (const T*)dout, bias, mask, (T*)dqkv, dbias, bw, n, c, hd, nw, wpb, scale);
  return (int)cudaGetLastError();
}

// qkv, dqkv: contiguous (bw, n, 3c), q | k | v along the last dim; dout:
// contiguous (bw, n, c); bias: (heads, n, n) f32 or null; mask: (nw, n, n)
// f32 or null; dbias: (heads, n, n) f32, zeroed by the caller, or null
// (only with bias). Returns the CUDA error code of the launch (0 on success).
extern "C" int mde_window_attention_bwd(const void* qkv, const void* dout, const float* bias,
                                        const float* mask, void* dqkv, float* dbias, int bw,
                                        int n, int c, int heads, int nw, float scale, int dtype,
                                        void* stream) {
  if (heads <= 0 || c % heads != 0 || n <= 0 || bw <= 0 || (mask && nw <= 0) ||
      (dbias && !bias))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MDE_F32)
    return launch<float>(qkv, dout, bias, mask, dqkv, dbias, bw, n, c, heads, nw, scale, s);
  if (dtype == MDE_BF16)
    return launch<__nv_bfloat16>(qkv, dout, bias, mask, dqkv, dbias, bw, n, c, heads, nw, scale,
                                 s);
  return (int)cudaErrorInvalidValue;
}
