// The tiled backward of K3 that dxdw (depthwise_dxdw.cu) and dw alone
// (depthwise_dw.cu) share: the tile of depthwise_tile.cuh swept over g and
// x, and the dw role: its sweep and its fixed-order block reduction.
//
// A block owns one image, a strip of WARPS x COLS columns (32 at 3x3 and
// 5x5, 8 at 7x7) and 64 channels, and sweeps its rows once: step s stages
// g's row s (zero outside the image) and x's row clamp(s - P) (clamped),
// s = 0 .. H + K - 2, K steps a barrier. dw warps, one per COLS columns,
// a thread one channel pair, keep the K x K x 2 f32 sums and K rolling
// rows of g at their columns in registers: x's padded row s pairs with g's
// row s - i for tap row i. After the sweep the block sums its dw warps in
// shared memory in a fixed order and writes one partial per (image,
// strip); depthwise_sum_partials (depthwise_bwd.cuh) sums the partials in
// order. No atomics: dw is the same bits every run, and the same bits in
// dxdw and dw alone, whose dw warps run the same code on the same strips.
//
// In dxdw (DX) a block holds WARPS dx warps beside its WARPS dw warps, the
// two roles meeting at barrier 1 from their own loops; dw alone holds the
// dw warps only, half the threads over the same ring, so that two blocks
// fit an SM where dxdw's one does.
#pragma once

#include "depthwise_bwd.cuh"
#include "depthwise_tile.cuh"

template <typename T, int K, bool DX>
struct BwdTile {
  static constexpr int KSIZE = K;
  // warps of each role, each owning COLS columns of the strip: 8 (strips of
  // 32 columns), 4 at 7x7, whose 98 taps need the registers of a 256-thread
  // dxdw block
  static constexpr int WARPS = K == 7 ? 4 : 8;
  static constexpr int THREADS = (DX ? 2 : 1) * WARPS * 32;
  using S = TileShape<K, WARPS>;
  static constexpr int ROW = S::NPX * TILE_CH;  // elements of a staged row
  // a slot of the ring: g's row, then x's row
  static constexpr size_t ring_bytes() { return (size_t)S::RING * 2 * ROW * sizeof(T); }
  // the dw warps' sums, for the block's reduction (after the sweep)
  static constexpr size_t red_bytes() { return (size_t)WARPS * K * K * TILE_CH * 4; }
  static constexpr size_t smem() {
    return ring_bytes() > red_bytes() ? ring_bytes() : red_bytes();
  }
};

// Strips of the tiled bodies (partials per image) at width W.
template <int K> inline int bwd_strips(int W) {
  constexpr int TW = BwdTile<float, K, true>::S::TW;
  return (W + TW - 1) / TW;
}

template <int THREADS> __device__ __forceinline__ void role_sync() {
  // all the block's roles meet at barrier 1 from their own loops
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

// Stage the rows of step s, if the sweep has one, into their slot of the
// ring: g's row s (zero past H) and x's row clamp(s - P).
template <typename T, int K, bool DX>
__device__ __forceinline__ void bwd_stage(T* ring, const T* gb, const T* xb, int s, int steps,
                                          int H, int W, int C, int z0, int c0) {
  using D = BwdTile<T, K, DX>;
  constexpr int P = K / 2, NPX = D::S::NPX;
  if (s >= steps) return;
  T* slot = ring + (s % D::S::RING) * 2 * D::ROW;
  stage_row<T, NPX, false, D::THREADS>(slot, gb, s < H ? s : -1, z0 - P, W, C, c0);
  stage_row<T, NPX, true, D::THREADS>(slot + D::ROW, xb, min(max(s - P, 0), H - 1), z0 - P,
                                        W, C, c0);
}

// Step s of the sweep, at offset u of its unrolled group: every SYNC steps,
// wait for the rows of steps s .. s + SYNC - 1, free the slots of the last
// SYNC steps and stage the rows RING - SYNC steps ahead.
template <typename T, int K, bool DX>
__device__ __forceinline__ void bwd_step(T* ring, const T* gb, const T* xb, int s, int u,
                                         int steps, int H, int W, int C, int z0, int c0) {
  using D = BwdTile<T, K, DX>;
  using S = typename D::S;
  if (u % S::SYNC != 0) return;
  cp_async_wait<S::PENDING>();
  role_sync<D::THREADS>();
#pragma unroll
  for (int r = 0; r < S::SYNC; ++r)
    bwd_stage<T, K, DX>(ring, gb, xb, s + S::RING - S::SYNC + r, steps, H, W, C, z0, c0);
  cp_async_commit();
}

// The dw role of dw warp cw: its K x K sums over the strip's sweep, added
// to dw, which the caller zeroes. Each kernel zeroes dw and stages the
// sweep's first rows in its own body: as functions of this header, the
// two made ptxas schedule dxdw's kernel otherwise, 13% slower on an H100
// (tools/k3_variants.py dxdw).
template <typename T, int K, bool DX>
__device__ __forceinline__ void dw_sweep(T* ring, const T* gb, const T* xb, float2 (&dw)[K][K],
                                         int H, int W, int C, int z0, int c0, int cw,
                                         int lane) {
  using D = BwdTile<T, K, DX>;
  constexpr int P = K / 2, COLS = D::S::COLS;
  const int steps = H + K - 1;
  // gr[h % K]: g's row h at this thread's columns, K rows (zero before row 0)
  float2 gr[K][COLS];
#pragma unroll
  for (int r = 0; r < K; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) gr[r][c] = make_float2(0.f, 0.f);

  for (int s0 = 0; s0 < steps; s0 += K) {
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int s = s0 + u;
      if (s >= steps) break;
      bwd_step<T, K, DX>(ring, gb, xb, s, u, steps, H, W, C, z0, c0);
      const T* row = ring + (s % D::S::RING) * 2 * D::ROW + cw * COLS * TILE_CH + 2 * lane;
#pragma unroll
      for (int c = 0; c < COLS; ++c) gr[u][c] = load_pair(row + (c + P) * TILE_CH);
      // x's padded row s, columns zc - P .. zc + COLS - 1 + P (clamped)
      float2 xv[COLS + K - 1];
#pragma unroll
      for (int t = 0; t < COLS + K - 1; ++t) xv[t] = load_pair(row + D::ROW + t * TILE_CH);
      // padded row s is tap row i of g's row s - i
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = 0; j < K; ++j)
#pragma unroll
          for (int c = 0; c < COLS; ++c) fma_pair(dw[i][j], xv[c + j], gr[(u - i + K) % K][c]);
    }
  }
}

// dw warp cw's sums into the block's reduction buffer red (the ring's
// memory, once every role has passed the sweep's last barrier).
template <int K>
__device__ __forceinline__ void dw_to_red(float* red, const float2 (&dw)[K][K], int cw,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j)
      *reinterpret_cast<float2*>(red + ((cw * K + i) * K + j) * TILE_CH + 2 * lane) = dw[i][j];
}

// After a barrier, every thread of the block: the sum of the dw warps'
// sums, warp 0 first, as the block's partial of (image b, strip
// blockIdx.y).
template <typename T, int K, bool DX>
__device__ __forceinline__ void dw_block_partial(const float* red, float* __restrict__ part,
                                                 int b, int C, int c0) {
  using D = BwdTile<T, K, DX>;
  float* out = part + ((size_t)b * gridDim.y + blockIdx.y) * K * K * C + c0;
  for (int e = threadIdx.x; e < K * K * TILE_CH; e += D::THREADS) {
    const int tap = e / TILE_CH, ch = e % TILE_CH;
    if (c0 + ch >= C) continue;
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < D::WARPS; ++q) sum += red[(q * K * K + tap) * TILE_CH + ch];
    out[(size_t)tap * C + ch] = sum;
  }
}

// Launch a tiled body (kernel, with args) at D's threads and shared memory
// on a grid of (channel slices, strips, images), then the partials' sum.
template <typename D, typename... Params, typename... Args>
static int launch_bwd_tiled(void (*kernel)(Params...), cudaStream_t stream, float* part,
                            float* dw, int B, int W, int C, Args... args) {
  constexpr size_t smem = D::smem();
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int strips = (W + D::S::TW - 1) / D::S::TW;
  kernel<<<dim3((C + TILE_CH - 1) / TILE_CH, strips, B), D::THREADS, smem, stream>>>(args...);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int taps = D::KSIZE * D::KSIZE * C;
  depthwise_sum_partials<<<(taps + 255) / 256, 256, 0, stream>>>(part, dw, B * strips, taps);
  return (int)cudaGetLastError();
}

// The shape rule of the tiled bodies: k 3, 5 and 7 on 16-byte vectors of
// C, every tensor of `ptrs` 16-byte aligned; the gather body takes the rest.
inline bool bwd_tiled(int C, int k, int dtype, std::initializer_list<const void*> ptrs) {
  return tile_k(k) && (dtype == MDE_F32 || dtype == MDE_BF16) &&
         tile_aligned(C, dtype == MDE_F32 ? 4 : 2, ptrs);
}
