// K3 dw: the weight gradient of the 5x5 replicate-pad depthwise conv alone.
//
// Replaces the TPU kernel _dw_pallas (mde_tpu/ops/pallas/depthwise.py:189,
// bodies _dw_kernel :125 and _dw_slice_kernel :160):
//   dw[i, j, c] = sum_{b, p, q} xp[b, p+i, q+j, c] * g[b, p, q, c]
// in f32, xp the replicate-padded x. It runs when x needs no gradient; the
// train step takes dxdw instead.
//
// What bounds it on an H100: at (4, 112, 224, 2048) bf16, 5x5, it reads x
// and g once, 822 MB (dw itself is 0.2 MB), 0.25 ms at 3.35 TB/s, against
// 2 * 25 operations per element, 10.3 GFLOP (10 us at 989 TFLOP/s; 0.15 ms
// as f32 multiply-adds on the CUDA cores at 67 TFLOP/s): it is bound by
// bytes.
//
// Tiled body (k 3, 5, 7; C in whole 16-byte vectors and x, g 16-byte
// aligned): dxdw's dw role alone (depthwise_bwd_tile.cuh). A block of 8 dw
// warps (4 at 7x7) owns one image, a strip of 32 columns (8 at 7x7) and 64
// channels and sweeps its rows once, staging g's row s and x's row
// clamp(s - P) into the cp.async ring; each thread keeps its K x K x 2 f32
// sums and K rolling rows of g in registers; the block sums its warps in
// shared memory in a fixed order into one partial per (image, strip), and
// a second kernel sums the partials in order, with no atomics. The block
// is half of dxdw's, over the same ring (92,160 B at 5x5 bf16), so that
// two blocks fit an SM: dxdw's dw warps alone left half of their block,
// and of the SM, idle. The strip and each thread's order are dxdw's, so dw
// alone gives the bits that dxdw's dw gives.
//
// Other shapes (C off the 16-byte vector, misaligned views) take the gather
// body of depthwise_bwd.cuh: clamped coordinates in place of the pad, each
// thread 25 x 2 f32 sums, the block and then the second kernel reducing
// them in a fixed order.

#include "depthwise_bwd_tile.cuh"

template <typename T, int K> using DwTile = BwdTile<T, K, false>;

// two blocks an SM: 256 threads (128 at 7x7) take half the register file
// at 128 registers a thread, and two rings fit in shared memory
template <typename T, int K>
__global__ void __launch_bounds__((DwTile<T, K>::THREADS), 2)
    depthwise_dw_tiled_kernel(const T* __restrict__ x, const T* __restrict__ g,
                              float* __restrict__ part, int H, int W, int C) {
  using D = DwTile<T, K>;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  T* ring = reinterpret_cast<T*>(tile_smem);  // [RING][g, x][NPX][TILE_CH]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * TILE_CH, z0 = blockIdx.y * D::S::TW, b = blockIdx.z;
  const size_t img = (size_t)b * H * W * C;
  const int steps = H + K - 1;
  constexpr int RING = D::S::RING, SYNC = D::S::SYNC;
#pragma unroll
  for (int s = 0; s < RING - SYNC; s += SYNC) {
#pragma unroll
    for (int r = 0; r < SYNC; ++r)
      bwd_stage<T, K, false>(ring, g + img, x + img, s + r, steps, H, W, C, z0, c0);
    cp_async_commit();
  }
  float2 dw[K][K];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) dw[i][j] = make_float2(0.f, 0.f);
  dw_sweep<T, K, false>(ring, g + img, x + img, dw, H, W, C, z0, c0, warp, lane);
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
  float* red = reinterpret_cast<float*>(tile_smem);  // [warp][tap][channel]
  dw_to_red<K>(red, dw, warp, lane);
  __syncthreads();
  dw_block_partial<T, K, false>(red, part, b, C, c0);
}

template <typename T>
static int launch_dw_tiled(const void* x, const void* g, float* part, float* dw, int B, int H,
                           int W, int C, int k, cudaStream_t s) {
#define MDE_DW_TILED(KK)                                                                     \
  return launch_bwd_tiled<DwTile<T, KK>>(depthwise_dw_tiled_kernel<T, KK>, s, part, dw, B, W, \
                                         C, (const T*)x, (const T*)g, part, H, W, C)
  switch (k) {
    case 3: MDE_DW_TILED(3);
    case 5: MDE_DW_TILED(5);
    case 7: MDE_DW_TILED(7);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MDE_DW_TILED
}

// x, g: contiguous (B, H, W, C); part: (mde_depthwise_bwd_parts(B, H, W,
// k), k, k, C) f32 scratch; dw: (k, k, C) f32. k is 3, 5 or 7. vec2: C even
// and x, g aligned to two elements (for the gather body). Returns the CUDA
// error code of the launches (0 on success).
extern "C" int mde_depthwise_conv2d_dw(const void* x, const void* g, float* part, float* dw,
                                       int B, int H, int W, int C, int k, int vec2, int dtype,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!bwd_tiled(C, k, dtype, {x, g}))
    return depthwise_bwd_dispatch<false>(x, g, nullptr, nullptr, part, dw, B, H, W, C, k, vec2,
                                         dtype, s);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == MDE_F32) return launch_dw_tiled<float>(x, g, part, dw, B, H, W, C, k, s);
  return launch_dw_tiled<__nv_bfloat16>(x, g, part, dw, B, H, W, C, k, s);
}

// Shared memory a block of the tiled body takes for a k x k kernel in dtype.
extern "C" int mde_depthwise_conv2d_dw_smem(int k, int dtype) {
  const bool bf = dtype == MDE_BF16;
  switch (k) {
    case 3: return (int)(bf ? DwTile<__nv_bfloat16, 3>::smem() : DwTile<float, 3>::smem());
    case 5: return (int)(bf ? DwTile<__nv_bfloat16, 5>::smem() : DwTile<float, 5>::smem());
    case 7: return (int)(bf ? DwTile<__nv_bfloat16, 7>::smem() : DwTile<float, 7>::smem());
    default: return 0;
  }
}

// 1 where mde_depthwise_conv2d_dw takes its tiled body for these arguments,
// 0 where it takes the gather body.
extern "C" int mde_depthwise_conv2d_dw_tiled(const void* x, const void* g, int C, int k,
                                             int dtype) {
  return bwd_tiled(C, k, dtype, {x, g}) ? 1 : 0;
}
