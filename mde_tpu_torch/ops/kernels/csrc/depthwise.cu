// K3: depthwise 'same' 2-D convolution with replicate padding, NHWC, forward.
//
// Replaces the TPU kernel _pallas_depthwise
// (mde_tpu/ops/pallas/depthwise.py:405, bodies _kernel :79 and
// _roll_kernel :103), reached through fused_depthwise_conv2d (:521):
//   out[b, h, w, c] = sum_{i, j} wt[i, j, c] * x[b, clamp(h+i-kh/2), clamp(w+j-kw/2), c]
// with the taps summed in f32 and one cast to x's dtype.
//
// What bounds it on an H100: at the main-path shape (8, 112, 224, 2048) bf16
// with a 5x5 kernel it reads x and writes out once, 1.64 GB, 0.49 ms at
// 3.35 TB/s, against 20.6 GFLOP (21 us at the 989 TFLOP/s bf16 peak): it is
// bound by bytes. Its products and sums stay f32 multiply-adds on the CUDA
// cores, 0.31 ms at their 67 TFLOP/s, so the instructions executed around
// them are the nearer ceiling.
//
// Tiled body (square 3x3, 5x5 and 7x7; C in whole 16-byte vectors and
// 16-byte aligned tensors): the tile of depthwise_tile.cuh. A block of 8
// warps owns a strip of 8 x COLS output columns (32; 16 at 7x7), 64 channels
// and one image, and sweeps its padded rows top to bottom, each staged once
// (clamped rows and columns give the replicate pad), K rows a barrier. A
// thread keeps its channel pair's K x K taps and K rolling rows of COLS
// output sums in registers: each staged row it reads (COLS + K - 1 words)
// feeds the K output rows it touches, and the output row that is complete
// is written and its sums reused for the row K below. Per output a thread
// executes (COLS + K - 1) / COLS shared loads and K * K multiply-adds a
// channel, against the column body's K guarded 16-byte weight loads per tap
// from L1 and an input vector fetched ~7.5 times through L1/L2. The sums of
// an output run over i, then j, as the plain version's and the column body's
// do: the two bodies give the same bits. At the main-path shape the copies
// alone take 0.61 ms and the arithmetic alone 0.64 (tools/k3_variants.py):
// the two overlap in part.

// Other shapes (odd non-square kernels, other sizes, C off the 16-byte
// vector, misaligned views) take the column body below: threads along C, VEC
// channels each (16 bytes, or 1 element where the wrapper finds C or a
// pointer off the 16-byte grid), each walking ROWS output rows of one
// column with runtime kernel sizes. The rule is depthwise_tiled below, on
// the kernel's sides and the wrapper's vec16 alone.

#include "depthwise_tile.cuh"

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

// The tiled body: 8 warps, each owning COLS columns of the strip; two
// blocks an SM, one at 7x7, where the taps alone take 98 registers.
constexpr int FWD_WARPS = 8;
constexpr int FWD_THREADS = FWD_WARPS * 32;
constexpr int fwd_min_blocks(int k) { return k == 7 ? 1 : 2; }

template <typename T, int K>
__global__ void __launch_bounds__(FWD_THREADS, fwd_min_blocks(K))
    depthwise_tiled_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                           T* __restrict__ out, int H, int W, int C) {
  using S = TileShape<K, FWD_WARPS>;
  constexpr int P = S::P, COLS = S::COLS, NPX = S::NPX;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  T* ring = reinterpret_cast<T*>(tile_smem);  // [RING][NPX][TILE_CH]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * TILE_CH, z0 = blockIdx.y * S::TW, b = blockIdx.z;
  const int cc = c0 + 2 * lane, zc = z0 + warp * COLS;
  const bool active = cc < C;
  const T* xb = x + (size_t)b * H * W * C;
  // padded row p of the sweep is x's row clamp(p - P); output row h takes
  // padded rows h .. h + K - 1
  const int steps = H + K - 1;

  float2 w[K][K];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j)
      w[i][j] = active ? load_pair(wt + (size_t)(i * K + j) * C + cc) : make_float2(0.f, 0.f);
  // acc[h % K]: the sums of output row h, for K rows in flight
  float2 acc[K][COLS];
#pragma unroll
  for (int r = 0; r < K; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = make_float2(0.f, 0.f);

  // stage padded row p into its slot of the ring
  constexpr int RING = S::RING, SYNC = S::SYNC;
  auto stage = [&](int p) {
    if (p < steps)
      stage_row<T, NPX, true, FWD_THREADS>(ring + (p % RING) * NPX * TILE_CH, xb,
                                           min(max(p - P, 0), H - 1), z0 - P, W, C, c0);
  };
#pragma unroll
  for (int p = 0; p < RING - SYNC; p += SYNC) {
#pragma unroll
    for (int r = 0; r < SYNC; ++r) stage(p + r);
    cp_async_commit();
  }
  for (int p0 = 0; p0 < steps; p0 += K) {
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int p = p0 + u;
      if (p >= steps) break;
      if (u % SYNC == 0) {
        cp_async_wait<S::PENDING>();
        __syncthreads();  // rows p .. p + SYNC - 1 have landed; the last group's slots are free
#pragma unroll
        for (int r = 0; r < SYNC; ++r) stage(p + RING - SYNC + r);
        cp_async_commit();
      }

      const T* row = ring + (p % RING) * NPX * TILE_CH + warp * COLS * TILE_CH + 2 * lane;
      float2 xv[COLS + K - 1];
#pragma unroll
      for (int t = 0; t < COLS + K - 1; ++t) xv[t] = load_pair(row + t * TILE_CH);
      // padded row p is tap row i of output row p - i
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int c = 0; c < COLS; ++c)
#pragma unroll
          for (int j = 0; j < K; ++j) fma_pair(acc[(u - i + K) % K][c], xv[c + j], w[i][j]);
      // output row p - K + 1 is complete: write it, and reuse its sums for row p + 1
      const int h = p - K + 1;
      float2(&o)[COLS] = acc[(u + 1) % K];
      if (h >= 0 && active) {
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          if (zc + c < W) store_pair(out + (((size_t)b * H + h) * W + zc + c) * C + cc, o[c]);
      }
#pragma unroll
      for (int c = 0; c < COLS; ++c) o[c] = make_float2(0.f, 0.f);
    }
  }
}

template <typename T, int K> constexpr size_t tiled_smem() {
  using S = TileShape<K, FWD_WARPS>;
  return (size_t)S::RING * S::NPX * TILE_CH * sizeof(T);
}

template <typename T, int K>
static int launch_tiled(const void* x, const void* wt, void* out, int B, int H, int W, int C,
                        cudaStream_t stream) {
  auto kernel = depthwise_tiled_kernel<T, K>;
  constexpr size_t smem = tiled_smem<T, K>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  constexpr int TW = TileShape<K, FWD_WARPS>::TW;
  dim3 grid((C + TILE_CH - 1) / TILE_CH, (W + TW - 1) / TW, B);
  kernel<<<grid, FWD_THREADS, smem, stream>>>((const T*)x, (const T*)wt, (T*)out, H, W, C);
  return (int)cudaGetLastError();
}

// The shape rule: the tiled body for square 3x3, 5x5 and 7x7 kernels on
// 16-byte vectors (vec16), the column body for the rest.
inline bool depthwise_tiled(int kh, int kw, int vec16) {
  return vec16 && kh == kw && tile_k(kh);
}

template <typename T>
static int launch_tiled_k(const void* x, const void* wt, void* out, int B, int H, int W, int C,
                          int k, cudaStream_t s) {
  switch (k) {
    case 3: return launch_tiled<T, 3>(x, wt, out, B, H, W, C, s);
    case 5: return launch_tiled<T, 5>(x, wt, out, B, H, W, C, s);
    case 7: return launch_tiled<T, 7>(x, wt, out, B, H, W, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x, out: contiguous (B, H, W, C); wt: contiguous (kh, kw, C), same dtype as x.
// vec16 != 0 selects 16-byte channel vectors: C must be a multiple of
// 16 / itemsize and x, wt, out 16-byte aligned (the wrapper checks both).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int mde_depthwise_conv2d(const void* x, const void* wt, void* out, int B, int H,
                                    int W, int C, int kh, int kw, int vec16, int dtype,
                                    void* stream) {
  if (kh % 2 == 0 || kw % 2 == 0 || kh <= 0 || kw <= 0 || W > 65535 || B <= 0 || B > 65535 ||
      H <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (depthwise_tiled(kh, kw, vec16)) {
    if (dtype == MDE_F32) return launch_tiled_k<float>(x, wt, out, B, H, W, C, kh, s);
    if (dtype == MDE_BF16) return launch_tiled_k<__nv_bfloat16>(x, wt, out, B, H, W, C, kh, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == MDE_F32)
    return vec16 ? launch<float, 4>(x, wt, out, B, H, W, C, kh, kw, s)
                 : launch<float, 1>(x, wt, out, B, H, W, C, kh, kw, s);
  if (dtype == MDE_BF16)
    return vec16 ? launch<__nv_bfloat16, 8>(x, wt, out, B, H, W, C, kh, kw, s)
                 : launch<__nv_bfloat16, 1>(x, wt, out, B, H, W, C, kh, kw, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory a block of the tiled body takes for a k x k kernel in dtype
// (0 where the shape takes the column body, which uses none).
extern "C" int mde_depthwise_conv2d_smem(int k, int dtype) {
  const bool bf = dtype == MDE_BF16;
  switch (k) {
    case 3: return (int)(bf ? tiled_smem<__nv_bfloat16, 3>() : tiled_smem<float, 3>());
    case 5: return (int)(bf ? tiled_smem<__nv_bfloat16, 5>() : tiled_smem<float, 5>());
    case 7: return (int)(bf ? tiled_smem<__nv_bfloat16, 7>() : tiled_smem<float, 7>());
    default: return 0;
  }
}
