// K3 dxdw: both gradients of the 5x5 replicate-pad depthwise conv in one pass.
//
// Replaces the TPU kernel _dxdw_pallas (mde_tpu/ops/pallas/depthwise.py:322,
// body _dxdw_kernel :238): dx, the correlation of g with the flipped taps
// with the replicate pad's edge rows and columns folded back (:380-384),
// accumulated in f32 and written in the input dtype (:266, :278), and
// dw[i, j, c] = sum_{b, p, q} xp[b, p+i, q+j, c] * g[b, p, q, c] in f32.
//
// What bounds it on an H100: at the train path's shape (4, 112, 224, 2048)
// bf16 with a 5x5 kernel it reads x and g and writes dx once, 3 * 411 MB =
// 1.23 GB, 0.37 ms at 3.35 TB/s, against 4 * 25 operations per element
// (dx and dw multiply-adds), 20.6 GFLOP, 21 us at 989 TFLOP/s: it is bound by
// bytes. Its products stay f32 multiply-adds on the CUDA cores, 0.31 ms at
// their 67 TFLOP/s, so the instructions executed around them are the nearer
// ceiling.
//
// Tiled body (k 3, 5, 7; C in whole 16-byte vectors and x, g, wt, dx 16-byte
// aligned): the tile of depthwise_tile.cuh, swept as depthwise_bwd_tile.cuh
// sets out, which also holds the dw role. A block owns one image, a strip
// of WARPS x COLS columns (32 at 3x3 and 5x5) and 64 channels, and sweeps
// its rows once: step s stages g's row s (zero outside the image) and x's
// row clamp(s - P) (clamped), s = 0 .. H + K - 2, K steps a barrier. WARPS
// warps compute dx and WARPS dw, each warp COLS columns, a thread one
// channel pair, all in f32 registers:
// - dx warps keep the K x K taps and K rolling rows of dx sums. g's row s
//   with tap (i, j) adds to row s + i - P and column q - P + j: the
//   unclamped rows -P .. H - 1 + P of the transposed conv, complete in
//   order. A complete row above row 0, or from H - 1 to H - 2 + P, is added
//   onto the row below it (the replicate pad's fold, as _dxdw_kernel folds
//   dxp), the others are written. The column fold is a few more products,
//   after the taps' loop, in the warps whose columns hold column 0 or
//   W - 1; the others run the plain correlation without a branch.
// - dw warps keep the K x K x 2 sums and K rolling rows of g at their
//   columns: x's padded row s pairs with g's row s - i for tap row i.
//   After the sweep the block sums its dw warps in shared memory in a fixed
//   order and writes one partial per (image, strip); a second kernel sums
//   the partials in order. No atomics: dx and dw are the same bits every
//   run, and dw the bits of the dw kernel's tiled body (depthwise_dw.cu).
// Per element a thread executes K * K multiply-adds for dx and K * K for dw
// against (COLS + K - 1) / COLS shared loads for each, and one more for dw's
// g, where the gather body executed some 75 global loads of 4 bytes. The two roles meet at a named
// barrier from their own loops, so that neither holds the other's
// registers (tools/k3_variants.py times dx alone and dw alone).

// Other shapes (C off the 16-byte vector, misaligned views) take the
// gather body of depthwise_bwd.cuh: a gather over clamped runs, 2 or 1
// elements a thread. The rule is dxdw_tiled below.

#include "depthwise_bwd_tile.cuh"

template <typename T, int K> using DxdwTile = BwdTile<T, K, true>;

template <typename T, int K>
__device__ __forceinline__ void dx_sweep(T* ring, const T* gb, const T* xb,
                                         const T* __restrict__ wt, T* __restrict__ dx, int H,
                                         int W, int C, int z0, int c0, int cw, int lane) {
  using D = DxdwTile<T, K>;
  constexpr int P = K / 2, COLS = D::S::COLS;
  const int cc = c0 + 2 * lane, zc = z0 + cw * COLS, steps = H + K - 1;
  const bool active = cc < C;
  // warps whose columns hold column 0 or W - 1 add the replicate pad's fold
  const bool left = zc == 0;
  const int ce = W - 1 - zc;
  const bool right = ce >= 0 && ce < COLS;
  float2 w[K][K];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j)
      w[i][j] = active ? load_pair(wt + (size_t)(i * K + j) * C + cc) : make_float2(0.f, 0.f);
  // acc[(r + P) % K]: the sums of unclamped dx row r, K rows in flight
  float2 acc[K][COLS];
#pragma unroll
  for (int r = 0; r < K; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = make_float2(0.f, 0.f);

  for (int s0 = 0; s0 < steps; s0 += K) {
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int s = s0 + u;
      if (s >= steps) break;
      bwd_step<T, K, true>(ring, gb, xb, s, u, steps, H, W, C, z0, c0);
      // g's row s (zero past H), columns zc - P .. zc + COLS - 1 + P
      const T* row = ring + (s % D::S::RING) * 2 * D::ROW + cw * COLS * TILE_CH + 2 * lane;
      float2 gv[COLS + K - 1];
#pragma unroll
      for (int t = 0; t < COLS + K - 1; ++t) gv[t] = load_pair(row + t * TILE_CH);
      // tap row i takes g's row s to unclamped row s + i - P
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int c = 0; c < COLS; ++c)
#pragma unroll
          for (int j = 0; j < K; ++j) fma_pair(acc[(u + i) % K][c], gv[c + K - 1 - j], w[i][j]);
      if (left) {  // columns -P .. -1 onto column 0
#pragma unroll
        for (int i = 0; i < K; ++i)
#pragma unroll
          for (int c = -P; c < 0; ++c)
#pragma unroll
            for (int j = 0; j <= c + P; ++j)
              fma_pair(acc[(u + i) % K][0], gv[c + K - 1 - j], w[i][j]);
      }
      if (right) {  // columns W .. W - 1 + P onto column W - 1
#pragma unroll
        for (int e = 0; e < COLS; ++e)
          if (e == ce) {
#pragma unroll
            for (int i = 0; i < K; ++i)
#pragma unroll
              for (int d = 1; d <= P; ++d)
#pragma unroll
                for (int j = d + P; j < K; ++j)
                  fma_pair(acc[(u + i) % K][e], gv[e + d + K - 1 - j], w[i][j]);
          }
      }
      // unclamped row r = s - P is complete
      const int r = s - P;
      float2(&o)[COLS] = acc[u % K];
      if (r < 0 || (r >= H - 1 && r < H - 1 + P)) {  // fold onto row r + 1
        float2(&n)[COLS] = acc[(u + 1) % K];
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          n[c].x += o[c].x;
          n[c].y += o[c].y;
        }
      } else if (active) {
        const int y = r < H ? r : H - 1;
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          if (zc + c < W) store_pair(dx + ((size_t)y * W + zc + c) * C + cc, o[c]);
      }
#pragma unroll
      for (int c = 0; c < COLS; ++c) o[c] = make_float2(0.f, 0.f);
    }
  }
}

template <typename T, int K>
__global__ void __launch_bounds__((DxdwTile<T, K>::THREADS), 1)
    depthwise_dxdw_tiled_kernel(const T* __restrict__ x, const T* __restrict__ g,
                                const T* __restrict__ wt, T* __restrict__ dx,
                                float* __restrict__ part, int H, int W, int C) {
  using D = DxdwTile<T, K>;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  T* ring = reinterpret_cast<T*>(tile_smem);  // [RING][g, x][NPX][TILE_CH]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cw = warp % D::WARPS;
  const int c0 = blockIdx.x * TILE_CH, z0 = blockIdx.y * D::S::TW, b = blockIdx.z;
  const size_t img = (size_t)b * H * W * C;
  const int steps = H + K - 1;
  constexpr int RING = D::S::RING, SYNC = D::S::SYNC;
#pragma unroll
  for (int s = 0; s < RING - SYNC; s += SYNC) {
#pragma unroll
    for (int r = 0; r < SYNC; ++r)
      bwd_stage<T, K, true>(ring, g + img, x + img, s + r, steps, H, W, C, z0, c0);
    cp_async_commit();
  }
  float* red = reinterpret_cast<float*>(tile_smem);  // [warp][tap][channel], after the sweep
  if (warp < D::WARPS) {
    dx_sweep<T, K>(ring, g + img, x + img, wt, dx + img, H, W, C, z0, c0, cw, lane);
    cp_async_wait<0>();
    role_sync<D::THREADS>();  // the ring is free
  } else {
    float2 dw[K][K];
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = 0; j < K; ++j) dw[i][j] = make_float2(0.f, 0.f);
    dw_sweep<T, K, true>(ring, g + img, x + img, dw, H, W, C, z0, c0, cw, lane);
    cp_async_wait<0>();
    role_sync<D::THREADS>();  // the ring is free
    dw_to_red<K>(red, dw, cw, lane);
  }
  __syncthreads();
  dw_block_partial<T, K, true>(red, part, b, C, c0);
}

template <typename T, int K>
static int launch_dxdw_tiled(const void* x, const void* g, const void* wt, void* dx,
                             float* part, float* dw, int B, int H, int W, int C,
                             cudaStream_t stream) {
  return launch_bwd_tiled<DxdwTile<T, K>>(depthwise_dxdw_tiled_kernel<T, K>, stream, part, dw,
                                          B, W, C, (const T*)x, (const T*)g, (const T*)wt,
                                          (T*)dx, part, H, W, C);
}

// The shape rule: the tiled body for k 3, 5 and 7 on 16-byte vectors, the
// gather body for the rest.
static bool dxdw_tiled(int C, int k, int dtype, const void* x, const void* g, const void* wt,
                       const void* dx) {
  return bwd_tiled(C, k, dtype, {x, g, wt, dx});
}

template <typename T>
static int launch_dxdw_tiled_k(const void* x, const void* g, const void* wt, void* dx,
                               float* part, float* dw, int B, int H, int W, int C, int k,
                               cudaStream_t s) {
  switch (k) {
    case 3: return launch_dxdw_tiled<T, 3>(x, g, wt, dx, part, dw, B, H, W, C, s);
    case 5: return launch_dxdw_tiled<T, 5>(x, g, wt, dx, part, dw, B, H, W, C, s);
    case 7: return launch_dxdw_tiled<T, 7>(x, g, wt, dx, part, dw, B, H, W, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x, g, dx: contiguous (B, H, W, C); wt: contiguous (k, k, C), x's dtype;
// part: (mde_depthwise_bwd_parts(B, H, W, k), k, k, C) f32 scratch; dw:
// (k, k, C) f32. k is 3, 5 or 7. vec2: C even and x, g, wt aligned to two
// elements (for the gather body). Returns the CUDA error code of the launches
// (0 on success).
extern "C" int mde_depthwise_conv2d_dxdw(const void* x, const void* g, const void* wt,
                                         void* dx, float* part, float* dw, int B, int H, int W,
                                         int C, int k, int vec2, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!dxdw_tiled(C, k, dtype, x, g, wt, dx))
    return depthwise_bwd_dispatch<true>(x, g, wt, dx, part, dw, B, H, W, C, k, vec2, dtype, s);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == MDE_F32)
    return launch_dxdw_tiled_k<float>(x, g, wt, dx, part, dw, B, H, W, C, k, s);
  return launch_dxdw_tiled_k<__nv_bfloat16>(x, g, wt, dx, part, dw, B, H, W, C, k, s);
}

// Partials the wrapper allocates for the dxdw and dw kernels, enough for
// either body: B x (bands of the gather body, or strips of the tiled one).
extern "C" int mde_depthwise_bwd_parts(int B, int H, int W, int k) {
  const int strips = k == 3 ? bwd_strips<3>(W) : k == 5 ? bwd_strips<5>(W) : bwd_strips<7>(W);
  const int bands = depthwise_bwd_bands(H);
  return B * (bands > strips ? bands : strips);
}

// Shared memory a block of the tiled body takes for a k x k kernel in dtype.
extern "C" int mde_depthwise_conv2d_dxdw_smem(int k, int dtype) {
  const bool bf = dtype == MDE_BF16;
  switch (k) {
    case 3: return (int)(bf ? DxdwTile<__nv_bfloat16, 3>::smem() : DxdwTile<float, 3>::smem());
    case 5: return (int)(bf ? DxdwTile<__nv_bfloat16, 5>::smem() : DxdwTile<float, 5>::smem());
    case 7: return (int)(bf ? DxdwTile<__nv_bfloat16, 7>::smem() : DxdwTile<float, 7>::smem());
    default: return 0;
  }
}
