// K3 dw: the weight gradient of the 5x5 replicate-pad depthwise conv alone.
//
// Replaces the TPU kernel _dw_pallas (mde_tpu/ops/pallas/depthwise.py:189,
// bodies _dw_kernel :125 and _dw_slice_kernel :160):
//   dw[i, j, c] = sum_{b, p, q} xp[b, p+i, q+j, c] * g[b, p, q, c]
// in f32, xp the replicate-padded x. It runs when x needs no gradient; the
// train step takes dxdw instead. The arithmetic and the layout are those of
// the dxdw kernel without dx (depthwise_bwd.cuh).
//
// What bounds it on an H100: at (4, 112, 224, 2048) bf16, 5x5, it reads x
// and g once, 822 MB (dw itself is 0.2 MB), 0.25 ms at 3.35 TB/s, against
// 2 * 25 operations per element, 10.3 GFLOP (10 us at 989 TFLOP/s): it is
// bound by bytes. The 25 reloads of x per output from L1 are the nearer
// ceiling, as in dxdw.
//
// Design: the TPU kernel walked halo blocks of a padded copy and carried a
// (kh, kw, 128) accumulator over its sequential grid; here clamped
// coordinates replace the pad, each thread keeps 25 x 2 f32 sums in
// registers, and the block and then a second kernel reduce them in a fixed
// order, with no atomics.

#include "depthwise_bwd.cuh"

// x, g: contiguous (B, H, W, C); part: (B * ceil(H / 8), k, k, C) f32
// scratch; dw: (k, k, C) f32. k is 3, 5 or 7. Returns the CUDA error code of
// the launches (0 on success).
extern "C" int mde_depthwise_conv2d_dw(const void* x, const void* g, float* part, float* dw,
                                       int B, int H, int W, int C, int k, int vec2, int dtype,
                                       void* stream) {
  return depthwise_bwd_dispatch<false>(x, g, nullptr, nullptr, part, dw, B, H, W, C, k, vec2,
                                       dtype, (cudaStream_t)stream);
}
