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
// 989 TFLOP/s bf16 peak): it is bound by bytes. Beside the copies the CUDA
// cores run, per output, 25 f32 multiply-adds, the affine and the erf GELU
// (~30 instructions), and per staged element the gate: the instructions,
// not the copies, set its rate (tools/k4_k5_variants.py: the copies alone
// take 0.87 ms).
//
// Tiled body (square 3x3, 5x5 and 7x7; C in whole 16-byte vectors and
// 16-byte aligned tensors): K3's tiled forward (depthwise.cu, tile in
// depthwise_tile.cuh) with the gate staged once. A block of 8 warps owns
// one image, a strip of 8 x COLS output columns (32; 16 at 7x7) and 64
// channels, and sweeps the strip's padded rows top to bottom in groups of
// K rows, one barrier a group. A thread keeps its channel pair's K x K taps
// and K rolling rows of COLS output sums in registers, as K3 does; the
// output row that is complete gets the affine (the thread's two scales and
// shifts loaded once) and the erf GELU in registers, then one 4-byte
// (bf16) store a pixel.
//   Staging: while a group is computed, the next group's rows are copied
// by 16-byte cp.async, a and b of a pixel's chunk by the same thread (b's
// chunks C channels further along the row; clamped rows and columns give
// the replicate pad, which the gate commutes with). After the group, each
// thread waits for its own copies and gates exactly the chunks it copied,
// writing the gate over a in the input dtype (it is already rounded to
// it); the group's barrier then publishes the gated rows. So the gate
// needs no barrier of its own and runs once per staged element (about 0.46
// G gates a call at the serving shape, against 3.1 G in the column body).
// b is read by its copier alone, before it copies into the same slot again,
// so b takes one group of rows and a two. The threads start one warp
// further along each row, so that no warp copies and gates more than the
// others over a group.
//   The bf16 sigmoid: it is rounded to bf16, so it is read from a table of
// bf16(ff_sigmoid(b)) for every bf16 b with 2^-16 <= |b| < 2^8 (6,144
// entries, 12 KB of shared memory, built by each block with ff_sigmoid
// itself), b's magnitude clamped into that range (outside it the sigmoid
// rounds to 0.5, 1 or 0, as at the table's ends): the same bits as
// computing it. The lookup has no branch; a chunk of 8 that holds a NaN
// computes its sigmoids. Computing the sigmoid (an expf and an IEEE
// division) or branching per element for the table's range cost 0.25-0.3
// ms a call (tools/k4_k5_variants.py); in the SASS, the division's
// slow-path check and the branch each put a convergence barrier (BSSY,
// BSYNC) around every element.
//
// Other shapes (odd non-square kernels, other sizes, C off the 16-byte
// vector, misaligned views) take the column body below: threads along C,
// VEC channels each (16 bytes, or 1 element), each walking ROWS output
// rows of one column, gating every input vector it loads. The rule is
// glu_ff_tiled below, on the kernel's sides and the wrapper's vec16 alone.
// Both bodies compute the same gate (ff_gate; the tiled body's bf16
// sigmoid table holds ff_sigmoid's own values), sum the taps of an output
// in the same order (rows i outer, columns j inner) and run the same
// epilogue (ff_out): they give the same bits.

#include <type_traits>

#include "depthwise_tile.cuh"

constexpr int ROWS = 8;

// sigmoid(b) in f32
__device__ __forceinline__ float ff_sigmoid(float b) { return 1.f / (1.f + expf(-b)); }

// The gate a * sigmoid(b) in place of a, for N elements of T, each step
// rounded to T as the plain version's ops in T are. In bf16 the sigmoid is
// rounded to bf16 and the product taken by the bf16 multiply (mul.bf16,
// two lanes at a time where N is even): the product of two bf16 values is
// exact in f32, so its one rounding gives what rounding the f32 product
// gives, in fewer instructions. Both bodies gate through this function.
template <int N>
__device__ __forceinline__ void ff_gate(float (&a)[N], const float (&b)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) a[e] *= ff_sigmoid(b[e]);
}
template <int N>
__device__ __forceinline__ void ff_gate(__nv_bfloat16 (&a)[N], const __nv_bfloat16 (&b)[N]) {
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int e = 0; e < N; e += 2) {
      const float2 f = __bfloat1622float2(__halves2bfloat162(b[e], b[e + 1]));
      const __nv_bfloat162 g = __hmul2(__halves2bfloat162(a[e], a[e + 1]),
                                       __floats2bfloat162_rn(ff_sigmoid(f.x), ff_sigmoid(f.y)));
      a[e] = __low2bfloat16(g);
      a[e + 1] = __high2bfloat16(g);
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e)
      a[e] = __hmul(a[e], __float2bfloat16(ff_sigmoid(__bfloat162float(b[e]))));
  }
}

// The tiled body's table of bf16(ff_sigmoid(b)) (as bits) for the bf16 b
// with exponent field in [SG_E0, SG_E0 + SG_NE), positive b first: entry
// (b's bits & 0x7fff) - (SG_E0 << 7), plus SG_HALF for negative b.
constexpr int SG_E0 = 127 - 16, SG_NE = 24, SG_HALF = SG_NE * 128, SG_ENTRIES = 2 * SG_HALF;

__device__ __forceinline__ unsigned short sg_entry(int i) {
  const unsigned bits = (i >= SG_HALF ? 0x8000u : 0u) | ((i % SG_HALF) + (SG_E0 << 7));
  return __bfloat16_as_ushort(__float2bfloat16(ff_sigmoid(__uint_as_float(bits << 16))));
}

// bf16(ff_sigmoid(b)) of a b that is not a NaN (bits: b's 16 bits), from
// the table with b's magnitude clamped into its range, without a branch:
// below it (|b| < 2^-16) the sigmoid rounds to 0.5, as it does at its
// first entry, and above it (|b| > 255, infinities included) to 1 or 0,
// as at its last (+-255).
__device__ __forceinline__ unsigned sg_bits(const unsigned short* tab, unsigned bits) {
  const int rel = (int)(bits & 0x7fffu) - (SG_E0 << 7);
  return tab[min(max(rel, 0), SG_HALF - 1) + (bits >> 15) * SG_HALF];
}

// The bf16 gate from the table; a chunk that holds a NaN b (never, from a
// finite projection) takes the computed sigmoid, so that the bits are
// those of the computed gate whatever b holds.
template <int N>
__device__ __forceinline__ void ff_gate(__nv_bfloat16 (&a)[N], const __nv_bfloat16 (&b)[N],
                                        const unsigned short* tab) {
  static_assert(N % 2 == 0, "pairs");
  uint32_t nan = 0;  // 1.0 in the lanes that hold a NaN
#pragma unroll
  for (int e = 0; e < N; e += 2) {
    const __nv_bfloat162 isnan = __hisnan2(__halves2bfloat162(b[e], b[e + 1]));
    nan |= *reinterpret_cast<const uint32_t*>(&isnan);
  }
  if (nan) {
    ff_gate(a, b);
    return;
  }
#pragma unroll
  for (int e = 0; e < N; e += 2) {
    const unsigned sg = sg_bits(tab, __bfloat16_as_ushort(b[e])) |
                        sg_bits(tab, __bfloat16_as_ushort(b[e + 1])) << 16;
    const __nv_bfloat162 g = __hmul2(__halves2bfloat162(a[e], a[e + 1]),
                                     *reinterpret_cast<const __nv_bfloat162*>(&sg));
    a[e] = __low2bfloat16(g);
    a[e + 1] = __high2bfloat16(g);
  }
}

// gelu_erf(y * s + t) in f32, the affine as one multiply-add.
__device__ __forceinline__ float ff_out(float y, float s, float t) {
  const float z = fmaf(y, s, t);
  return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
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
      Vec<T, VEC> av = *reinterpret_cast<const Vec<T, VEC>*>(px);
      const Vec<T, VEC> bv = *reinterpret_cast<const Vec<T, VEC>*>(px + C);
      ff_gate(av.v, bv.v);
      float g[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) g[e] = to_float(av.v[e]);
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
    for (int e = 0; e < VEC; ++e) ov.v[e] = from_float<T>(ff_out(acc[o][e], s[e], t[e]));
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

// The tiled body: 8 warps, each owning COLS columns of the strip; two
// blocks an SM, one at 7x7, where the taps alone take 98 registers.
constexpr int FF_WARPS = 8;
constexpr int FF_THREADS = FF_WARPS * 32;
constexpr int ff_min_blocks(int k) { return k == 7 ? 1 : 2; }

// The tiled body's staging: a's ring of two groups of K rows and b's one
// group, each row NPX pixels of TILE_CH channels, and in bf16 the sigmoid's
// table.
template <typename T, int K> struct FFTile {
  using S = TileShape<K, FF_WARPS>;
  static constexpr int PER = 16 / sizeof(T);       // elements of a copy
  static constexpr int CHUNKS = TILE_CH / PER;     // copies of a pixel and operand
  static constexpr int ROW = S::NPX * CHUNKS;      // copies of a row and operand
  static constexpr size_t A_ELEMS = (size_t)2 * K * S::NPX * TILE_CH;
  static constexpr size_t B_ELEMS = (size_t)K * S::NPX * TILE_CH;
  static constexpr bool TABLE = std::is_same<T, __nv_bfloat16>::value;
  static constexpr size_t SMEM =
      (A_ELEMS + B_ELEMS) * sizeof(T) + (TABLE ? SG_ENTRIES * sizeof(unsigned short) : 0);
};

// f(chunk) for each of this thread's copies of a padded row p (the copies
// of one operand of a row, ROW of them, are numbered along the row: pixel
// chunk / CHUNKS, channel chunk chunk % CHUNKS). The threads start one warp
// further along each row, so that the chunks past the first FF_THREADS
// fall to a different warp each row.
template <typename T, int K, typename F>
__device__ __forceinline__ void for_row(int p, F f) {
  constexpr int ROW = FFTile<T, K>::ROW;
  const int t = (threadIdx.x + 32 * p) % FF_THREADS;
#pragma unroll 1
  for (int i = t; i < ROW; i += FF_THREADS) f(i);
}

template <typename T, int K>
__global__ void __launch_bounds__(FF_THREADS, ff_min_blocks(K))
    glu_ff_tiled_kernel(const T* __restrict__ ab, const T* __restrict__ wt,
                        const float* __restrict__ sc, const float* __restrict__ sh,
                        T* __restrict__ out, int H, int W, int C) {
  using G = FFTile<T, K>;
  using S = typename G::S;
  constexpr int P = S::P, COLS = S::COLS, NPX = S::NPX, PER = G::PER;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  T* ring = reinterpret_cast<T*>(tile_smem);  // a, then the gate: [2K][NPX][TILE_CH]
  T* bring = ring + G::A_ELEMS;               // b: [K][NPX][TILE_CH]
  unsigned short* sg_tab = reinterpret_cast<unsigned short*>(bring + G::B_ELEMS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * TILE_CH, z0 = blockIdx.y * S::TW, b = blockIdx.z;
  const int cc = c0 + 2 * lane, zc = z0 + warp * COLS;
  const bool active = cc < C;
  const T* abb = ab + (size_t)b * H * W * 2 * C;
  // padded row p of the sweep is ab's row clamp(p - P); output row h takes
  // padded rows h .. h + K - 1
  const int steps = H + K - 1;

  float2 w[K][K];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j)
      w[i][j] = active ? load_pair(wt + (size_t)(i * K + j) * C + cc) : make_float2(0.f, 0.f);
  const float2 s = active ? make_float2(sc[cc], sc[cc + 1]) : make_float2(0.f, 0.f);
  const float2 t = active ? make_float2(sh[cc], sh[cc + 1]) : make_float2(0.f, 0.f);
  // acc[h % K]: the sums of output row h, for K rows in flight
  float2 acc[K][COLS];
#pragma unroll
  for (int r = 0; r < K; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = make_float2(0.f, 0.f);

  // start the copies of a and b of padded row p (none past the sweep)
  auto stage = [&](int p) {
    if (p >= steps) return;
    T* da = ring + (p % (2 * K)) * NPX * TILE_CH;
    T* db = bring + (p % K) * NPX * TILE_CH;
    const int row = min(max(p - P, 0), H - 1);
    for_row<T, K>(p, [&](int i) {
      const int col = min(max(z0 - P + i / G::CHUNKS, 0), W - 1);
      const int c = c0 + (i % G::CHUNKS) * PER;
      const bool valid = c < C;
      const T* src = valid ? abb + ((size_t)row * W + col) * 2 * C + c : abb;
      cp_async16(da + i * PER, src, valid);
      cp_async16(db + i * PER, valid ? src + C : abb, valid);
    });
  };
  // gate this thread's own copies of padded row p, in place of a
  auto gate = [&](int p) {
    if (p >= steps) return;
    T* da = ring + (p % (2 * K)) * NPX * TILE_CH;
    const T* db = bring + (p % K) * NPX * TILE_CH;
    for_row<T, K>(p, [&](int i) {
      Vec<T, PER>* pa = reinterpret_cast<Vec<T, PER>*>(da + i * PER);
      const Vec<T, PER> bv = *reinterpret_cast<const Vec<T, PER>*>(db + i * PER);
      Vec<T, PER> av = *pa;
      if constexpr (G::TABLE)
        ff_gate(av.v, bv.v, sg_tab);
      else
        ff_gate(av.v, bv.v);
      *pa = av;
    });
  };

  if constexpr (G::TABLE) {
    for (int i = threadIdx.x; i < SG_ENTRIES; i += FF_THREADS) sg_tab[i] = sg_entry(i);
    __syncthreads();
  }
  // the first group: staged, landed and gated before the sweep
#pragma unroll 1
  for (int r = 0; r < K; ++r) stage(r);
  cp_async_commit();
  cp_async_wait<0>();
#pragma unroll 1
  for (int r = 0; r < K; ++r) gate(r);

  for (int p0 = 0; p0 < steps; p0 += K) {
    __syncthreads();  // rows p0 .. p0 + K - 1 are gated; the last group's slots are free
#pragma unroll 1
    for (int r = 0; r < K; ++r) stage(p0 + K + r);
    cp_async_commit();
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int p = p0 + u;
      if (p >= steps) break;
      const T* row = ring + (p % (2 * K)) * NPX * TILE_CH + warp * COLS * TILE_CH + 2 * lane;
      float2 xv[COLS + K - 1];
#pragma unroll
      for (int c = 0; c < COLS + K - 1; ++c) xv[c] = load_pair(row + c * TILE_CH);
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
          if (zc + c < W)
            store_pair(out + (((size_t)b * H + h) * W + zc + c) * C + cc,
                       make_float2(ff_out(o[c].x, s.x, t.x), ff_out(o[c].y, s.y, t.y)));
      }
#pragma unroll
      for (int c = 0; c < COLS; ++c) o[c] = make_float2(0.f, 0.f);
    }
    // the next group has landed: gate this thread's own copies of it
    cp_async_wait<0>();
#pragma unroll 1
    for (int r = 0; r < K; ++r) gate(p0 + K + r);
  }
}

template <typename T, int K>
static int launch_tiled(const void* ab, const void* wt, const float* sc, const float* sh,
                        void* out, int B, int H, int W, int C, cudaStream_t stream) {
  auto kernel = glu_ff_tiled_kernel<T, K>;
  constexpr size_t smem = FFTile<T, K>::SMEM;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  constexpr int TW = TileShape<K, FF_WARPS>::TW;
  dim3 grid((C + TILE_CH - 1) / TILE_CH, (W + TW - 1) / TW, B);
  kernel<<<grid, FF_THREADS, smem, stream>>>((const T*)ab, (const T*)wt, sc, sh, (T*)out, H, W,
                                             C);
  return (int)cudaGetLastError();
}

// The shape rule: the tiled body for square 3x3, 5x5 and 7x7 kernels on
// 16-byte vectors (vec16), the column body for the rest.
inline bool glu_ff_tiled(int kh, int kw, int vec16) { return vec16 && kh == kw && tile_k(kh); }

template <typename T>
static int launch_tiled_k(const void* ab, const void* wt, const float* sc, const float* sh,
                          void* out, int B, int H, int W, int C, int k, cudaStream_t s) {
  switch (k) {
    case 3: return launch_tiled<T, 3>(ab, wt, sc, sh, out, B, H, W, C, s);
    case 5: return launch_tiled<T, 5>(ab, wt, sc, sh, out, B, H, W, C, s);
    case 7: return launch_tiled<T, 7>(ab, wt, sc, sh, out, B, H, W, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ab: contiguous (B, H, W, 2C), a | b along the last dim; wt: contiguous
// (kh, kw, C) in ab's dtype; sc, sh: (C,) f32; out: contiguous (B, H, W, C).
// vec16 != 0 selects 16-byte channel vectors: C must be a multiple of
// 16 / itemsize and ab, wt, out 16-byte aligned (the wrapper checks both).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int mde_glu_ff(const void* ab, const void* wt, const float* sc, const float* sh,
                          void* out, int B, int H, int W, int C, int kh, int kw, int vec16,
                          int dtype, void* stream) {
  if (kh % 2 == 0 || kw % 2 == 0 || kh <= 0 || kw <= 0 || W > 65535 || B <= 0 || B > 65535 ||
      H <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (glu_ff_tiled(kh, kw, vec16)) {
    if (dtype == MDE_F32) return launch_tiled_k<float>(ab, wt, sc, sh, out, B, H, W, C, kh, s);
    if (dtype == MDE_BF16)
      return launch_tiled_k<__nv_bfloat16>(ab, wt, sc, sh, out, B, H, W, C, kh, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == MDE_F32)
    return vec16 ? launch<float, 4>(ab, wt, sc, sh, out, B, H, W, C, kh, kw, s)
                 : launch<float, 1>(ab, wt, sc, sh, out, B, H, W, C, kh, kw, s);
  if (dtype == MDE_BF16)
    return vec16 ? launch<__nv_bfloat16, 8>(ab, wt, sc, sh, out, B, H, W, C, kh, kw, s)
                 : launch<__nv_bfloat16, 1>(ab, wt, sc, sh, out, B, H, W, C, kh, kw, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory a block of the tiled body takes for a k x k kernel in dtype
// (0 where the shape takes the column body, which uses none).
extern "C" int mde_glu_ff_smem(int k, int dtype) {
  const bool bf = dtype == MDE_BF16;
  switch (k) {
    case 3: return (int)(bf ? FFTile<__nv_bfloat16, 3>::SMEM : FFTile<float, 3>::SMEM);
    case 5: return (int)(bf ? FFTile<__nv_bfloat16, 5>::SMEM : FFTile<float, 5>::SMEM);
    case 7: return (int)(bf ? FFTile<__nv_bfloat16, 7>::SMEM : FFTile<float, 7>::SMEM);
    default: return 0;
  }
}
