// The tile that K3's tiled forward (depthwise.cu) and tiled dxdw
// (depthwise_dxdw.cu) share: a block's staging ring in shared memory and
// the channel pairs its threads read from it.
//
// A block owns one image, a strip of TW output columns and a slice of
// TILE_CH channels, and sweeps down the strip one input row a step. Rows
// of the strip with their halo (TW + K - 1 pixels of TILE_CH channels) are
// staged by 16-byte cp.async copies into a ring in shared memory, SYNC rows
// at a time (one barrier for SYNC steps) and RING - SYNC rows ahead of the
// row being computed, so that the copies of the next rows overlap the
// arithmetic on these. Columns off the image are clamped (the replicate pad
// of the forward and of dw's x) or zero (g outside the image, for dx);
// channels past C are zero.
//
// Each thread owns a channel pair (lane) and COLS neighbouring columns
// (warp): it reads its COLS + K - 1 staged pixels of a row as one 4-byte
// (bf16) or 8-byte (f32) word each, a warp reading 128 or 256 contiguous
// bytes, and keeps its taps and sums in registers. A depthwise conv shares
// nothing across channels, so shared memory serves the copies alone: each
// input vector crosses L2 once, plus the halo columns.
#pragma once

#include <initializer_list>

#include "common.cuh"

// channels of a block: 32 lanes x 2
constexpr int TILE_CH = 64;

// The kernel sizes the tiled bodies are compiled for.
inline bool tile_k(int k) { return k == 3 || k == 5 || k == 7; }

// Tile of a body whose WARPS warps each own COLS columns, for a K x K kernel.
template <int K, int WARPS> struct TileShape {
  static constexpr int P = K / 2;
  // columns a thread owns: fewer at 7x7, where the taps alone take 98 registers
  static constexpr int COLS = K == 7 ? 2 : 4;
  static constexpr int TW = WARPS * COLS;  // output columns of a strip
  static constexpr int NPX = TW + K - 1;   // staged pixels of a row
  // rows staged and computed between two barriers: 1, or the K steps a
  // sweep unrolls (so that their registers are indexed at compile time)
  static constexpr int SYNC = K;
  // rows of the ring: the SYNC rows being computed and those staged ahead
  static constexpr int RING = 2 * SYNC;
  // cp.async groups (of SYNC rows) that may stay in flight when the oldest
  // staged rows are needed
  static constexpr int PENDING = RING / SYNC - 2;
  static_assert(K % SYNC == 0 && RING % SYNC == 0 && PENDING >= 0, "ring of whole groups");
};

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// a bf16 pair as one 4-byte word: each bf16 is the high half of its f32
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ void store_pair(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

__device__ __forceinline__ void fma_pair(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.y = fmaf(a.y, b.y, acc.y);
}

// Start the copies of row `row` (or zeros, if row < 0) of image `img`
// (H x W x C), columns col0 .. col0 + NPX - 1 (clamped into the image if
// CLAMP, else zero outside it) and channels c0 .. c0 + TILE_CH - 1 (zero
// past C), into dst[NPX][TILE_CH]. C is a multiple of 16 bytes and img
// 16-byte aligned. Each of the block's THREADS threads takes a share.
template <typename T, int NPX, bool CLAMP, int THREADS>
__device__ __forceinline__ void stage_row(T* dst, const T* __restrict__ img, int row, int col0,
                                          int W, int C, int c0) {
  constexpr int PER = 16 / sizeof(T);      // elements of a copy
  constexpr int CHUNKS = TILE_CH / PER;    // copies of a pixel
  constexpr int N = NPX * CHUNKS;
#pragma unroll
  for (int k = 0; k < (N + THREADS - 1) / THREADS; ++k) {
    const int t = threadIdx.x + k * THREADS;
    if (N % THREADS != 0 && t >= N) break;
    const int px = t / CHUNKS, ch = t % CHUNKS;
    const int c = c0 + ch * PER;
    int col = col0 + px;
    bool valid = row >= 0 && c < C;
    if (CLAMP)
      col = min(max(col, 0), W - 1);
    else
      valid = valid && col >= 0 && col < W;
    cp_async16(dst + px * TILE_CH + ch * PER,
               valid ? img + ((size_t)row * W + col) * C + c : img, valid);
  }
}

// The tiled bodies take C in whole 16-byte vectors and 16-byte aligned
// tensors: the copies are 16 bytes.
inline bool tile_aligned(int C, int itemsize, std::initializer_list<const void*> ptrs) {
  if (C % (16 / itemsize) != 0) return false;
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16 != 0) return false;
  return true;
}
