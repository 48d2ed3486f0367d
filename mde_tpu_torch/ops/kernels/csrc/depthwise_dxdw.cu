// K3 dxdw: both gradients of the 5x5 replicate-pad depthwise conv in one pass.
//
// Replaces the TPU kernel _dxdw_pallas (mde_tpu/ops/pallas/depthwise.py:322,
// body _dxdw_kernel :238): dx, the correlation of g with the flipped taps
// with the replicate pad's edge rows and columns folded back (:380-384),
// accumulated in f32 and written in the input dtype (:266, :278), and
// dw[i, j, c] = sum_{b, p, q} xp[b, p+i, q+j, c] * g[b, p, q, c] in f32.
// The arithmetic and the layout are in depthwise_bwd.cuh.
//
// What bounds it on an H100: at the train path's shape (4, 112, 224, 2048)
// bf16 with a 5x5 kernel it reads x and g and writes dx once, 3 * 411 MB =
// 1.23 GB, 0.37 ms at 3.35 TB/s, against 4 * 25 operations per element
// (dx and dw multiply-adds), 20.6 GFLOP, 21 us at 989 TFLOP/s: it is bound by
// bytes. Its products run as f32 multiply-adds on the CUDA cores (0.31 ms at
// their 67 TFLOP/s), and every thread reloads the 25 taps of x and of g from
// L1, so the rate of load instructions is the nearer ceiling.
//
// Design: a gather over output positions, as the forward's clamped
// coordinates: each thread owns a (pixel, channel pair) of dx and sums the
// g values whose clamped tap reads it, so no padded copy is written and no
// two threads write one element. dw is reduced in registers, then over the
// block in shared memory, then over (image, band) by a second small kernel,
// where the TPU carried it across its sequential grid.

#include "depthwise_bwd.cuh"

// x, g, dx: contiguous (B, H, W, C); wt: contiguous (k, k, C), x's dtype;
// part: (B * ceil(H / 8), k, k, C) f32 scratch; dw: (k, k, C) f32. k is 3, 5
// or 7. Returns the CUDA error code of the launches (0 on success).
extern "C" int mde_depthwise_conv2d_dxdw(const void* x, const void* g, const void* wt,
                                         void* dx, float* part, float* dw, int B, int H, int W,
                                         int C, int k, int vec2, int dtype, void* stream) {
  return depthwise_bwd_dispatch<true>(x, g, wt, dx, part, dw, B, H, W, C, k, vec2, dtype,
                                      (cudaStream_t)stream);
}
