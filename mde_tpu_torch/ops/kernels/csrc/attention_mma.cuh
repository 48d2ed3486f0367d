// Window attention in bf16 on the tensor cores: the per-(window, head)
// bodies of K1's and K2's forwards and backwards (window_attention*.cu,
// ordered_attention*.cu).
//
// One block of 4 warps holds one (window, head). Its operands (rows of the
// head's q, k, v and dO) are staged in shared memory as bf16 by 16-byte
// cp.async copies, rows padded to a multiple of 16 with zeros and the head
// dim padded with zeros to a multiple of 16, then 8 elements more, so that
// the 8 rows one ldmatrix reads start in 8 different 16-byte bank groups
// (a row is 2 * pad16(hd) + 16 bytes, an odd number of 16-byte groups).
// Each warp owns 16 query rows: mma.sync.m16n8k16 (bf16 operands, f32
// sums) computes its 16 x n block of S with A and B fed by ldmatrix, S
// stays in registers, the bias is added per accumulator element (from its
// (row, col), or from a tile of the bias kept in fragment order, FragBias),
// the softmax reduces within the quad of lanes that share a row, and the
// f32 accumulators of P become the bf16 A fragments of P.v in registers.
//
// Fragment layouts (PTX ISA, mma.m16n8k16, g = lane / 4, t = lane % 4):
//   A (16 x 16): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B (16 x 8):  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C (16 x 8):  c0 c1 (g, 2t..2t+1), c2 c3 (g+8, 2t..2t+1)
// So the C fragments of two neighbouring 8-column tiles of S are the A
// fragment of the 16 keys they cover.
#pragma once

#include "common.cuh"

typedef __nv_bfloat16 bf16;

// Largest window (tokens) and head dim the bodies take.
#define MMA_MAX_N 128
#define MMA_MAX_HD 128
#define MMA_THREADS 128

__host__ __device__ inline int mma_pad16(int x) { return (x + 15) & ~15; }

// The shapes the bodies take: windows of up to MMA_MAX_N tokens, head dims
// that are multiples of 8 (16-byte rows) up to MMA_MAX_HD.
inline bool mma_shape(int n, int hd) {
  return n > 0 && n <= MMA_MAX_N && hd > 0 && hd % 8 == 0 && hd <= MMA_MAX_HD;
}

// Row stride, in elements, of a staged (rows, hd) operand.
__host__ __device__ inline int mma_ld(int hd) { return mma_pad16(hd) + 8; }

// Four 8 x 8 bf16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8. Register j holds row lane / 4, elements 2 (lane % 4) and the next,
// of matrix j; with TRANS, column lane / 4, rows 2 (lane % 4) and the next.
template <bool TRANS> __device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p))
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p))
                 : "memory");
}

// c += a . b on the tensor cores: 16 x 16 bf16 by 16 x 8 bf16, f32 sums.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16, the first in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Addresses of the ldmatrix x4 operands of one 16 x 16 tile at (r0, c0) of
// a row-major matrix with rows `ld` apart, for each use of the tile:
// A of a row-major product (rows r0.., k c0..), no transpose
__device__ __forceinline__ const bf16* tile_a(const bf16* m, int ld, int r0, int c0,
                                              int lane) {
  return m + (r0 + (lane & 15)) * ld + c0 + ((lane >> 4) << 3);
}
// B of a . m^T (n = rows r0.., k = cols c0..), no transpose: registers
// (0, 1) are b0, b1 of n r0..r0+7 and (2, 3) those of n r0+8..r0+15
__device__ __forceinline__ const bf16* tile_bt(const bf16* m, int ld, int r0, int c0,
                                               int lane) {
  return m + (r0 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 + (((lane >> 3) & 1) << 3);
}
// B of a . m (k = rows r0.., n = cols c0..), transposed: registers (0, 1)
// are b0, b1 of n c0..c0+7 and (2, 3) those of n c0+8..c0+15
__device__ __forceinline__ const bf16* tile_b(const bf16* m, int ld, int r0, int c0, int lane) {
  return m + (r0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + c0 + ((lane >> 4) << 3);
}

// Offset of element (row, col) of a (rows, cols) bf16 matrix kept without
// row padding: the 16-byte chunks of each row are permuted by XOR with the
// row's low bits (up to 3, as many as the chunk count allows), so that the
// 8 rows one ldmatrix reads, or one fragment store writes, meet in different
// bank groups. cols is a multiple of 16.
__device__ __forceinline__ int swz(int row, int col, int cols) {
  const int chunks = cols >> 3;
  const int mask = min(chunks & -chunks, 8) - 1;
  return row * cols + ((((col >> 3) ^ (row & mask)) << 3) | (col & 7));
}

// A of m^T . b (m = cols c0.., k = rows r0..), transposed, for a matrix
// laid out by swz
__device__ __forceinline__ const bf16* tile_at(const bf16* m, int cols, int r0, int c0,
                                               int lane) {
  return m + swz(r0 + (lane & 7) + ((lane >> 4) << 3), c0 + (((lane >> 3) & 1) << 3), cols);
}

// f(r, ch) for every (row, 16-byte chunk) of a (rows, chunks) operand, the
// one at flat index r * chunks + ch taken by thread idx mod count of
// `count` threads. Where count is a multiple of chunks (the head dims
// that are powers of two) a thread keeps one chunk column and steps over
// rows, with no division in the loop.
template <typename F>
__device__ __forceinline__ void for_chunks(int idx, int count, int rows, int chunks, F f) {
  if (count % chunks == 0) {
    const int ch = idx % chunks, step = count / chunks;
    for (int r = idx / chunks; r < rows; r += step) f(r, ch);
  } else {
    for (int i = idx; i < rows * chunks; i += count) f(i / chunks, i % chunks);
  }
}

// Stage rows [0, n) and columns [0, hd) of a bf16 matrix with rows `ldg`
// apart into `rows` rows of `ld` elements, zero-filling rows [n, rows) and
// columns [hd, pad16(hd)). hd is a multiple of 8 and src 16-byte aligned.
// The caller commits and waits; mma_scale_staged touches exactly the
// chunks that this thread copied.
__device__ __forceinline__ void mma_stage(bf16* dst, const bf16* src, int n, int rows, int hd,
                                          int ldg, int ld) {
  for_chunks(threadIdx.x, blockDim.x, rows, mma_pad16(hd) >> 3, [&](int r, int ch) {
    const bool valid = r < n && (ch << 3) < hd;
    cp_async16(dst + r * ld + (ch << 3), valid ? src + (size_t)r * ldg + (ch << 3) : src,
               valid);
  });
}

// Stage rows [0, n) and columns [0, hd) of a bf16 matrix with rows `ldg`
// apart into `rows` rows of `ld` elements, zero-filling rows [n, rows) and
// columns [hd, pad16(hd)), by the 32 lanes of one warp (mma_stage's copies,
// with the warp's lanes in place of the block's threads).
__device__ __forceinline__ void warp_stage(bf16* dst, const bf16* src, int n, int rows, int hd,
                                           int ldg, int ld, int lane) {
  for_chunks(lane, 32, rows, mma_pad16(hd) >> 3, [&](int r, int ch) {
    const bool valid = r < n && (ch << 3) < hd;
    cp_async16(dst + r * ld + (ch << 3), valid ? src + (size_t)r * ldg + (ch << 3) : src,
               valid);
  });
}

// K5's shape rule (channel_attention*.cu): bf16 on the tensor cores where
// both head dims and the window fit mma_shape; f32 and the rest on the
// CUDA cores.
inline bool channel_mma(int n, int hd, int ehd, int dtype) {
  return dtype == MDE_BF16 && mma_shape(n, hd) && mma_shape(n, ehd);
}

// Multiply what mma_stage copied by `scale`, rounding each product to bf16,
// after this thread's copies completed (no barrier needed: each thread
// scales its own chunks).
__device__ __forceinline__ void mma_scale_staged(bf16* dst, int rows, int hd, int ld,
                                                 float scale) {
  for_chunks(threadIdx.x, blockDim.x, rows, mma_pad16(hd) >> 3, [&](int r, int ch) {
    uint4* p = reinterpret_cast<uint4*>(dst + r * ld + (ch << 3));
    uint4 x = *p;
    uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[j]));
      w[j] = pack_bf16(f.x * scale, f.y * scale);
    }
    *p = x;
  });
}

// Logits of one warp's 16 rows: s[j] is the C fragment of columns 8j..8j+7
// of this.b^T (a: rows r0.. of `a`, b: the first np rows of `b`, both
// rows `ld` apart), summed over the pad16(hd) / 16 column steps. NT and DT
// bound np / 16 and pad16(hd) / 16; nk and nd are their values.
template <int NT, int DT>
__device__ __forceinline__ void mma_rows_abt(float (&s)[2 * NT][4], const bf16* a,
                                             const bf16* b, int ld, int r0, int nk, int nd,
                                             int lane) {
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kd = 0; kd < DT; ++kd) {
    if (kd >= nd) break;
    uint32_t fa[4];
    ldsm_x4<false>(fa, tile_a(a, ld, r0, kd * 16, lane));
#pragma unroll
    for (int kt = 0; kt < NT; ++kt) {
      if (kt >= nk) break;
      uint32_t fb[4];
      ldsm_x4<false>(fb, tile_bt(b, ld, kt * 16, kd * 16, lane));
      mma16816(s[2 * kt], fa, fb[0], fb[1]);
      mma16816(s[2 * kt + 1], fa, fb[2], fb[3]);
    }
  }
}

// o[dn] (C fragments of columns 8dn..8dn+7) = p . m over keys 0..16nk,
// p given as f32 C fragments times the per-half factors f0 (row g), f1
// (row g+8), rounded to bf16; m rows `ld` apart.
template <int NT, int DT>
__device__ __forceinline__ void mma_rows_pm(float (&o)[2 * DT][4], const float (&p)[2 * NT][4],
                                            float f0, float f1, const bf16* m, int ld, int nk,
                                            int nd, int lane) {
#pragma unroll
  for (int j = 0; j < 2 * DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
    if (kt >= nk) break;
    const uint32_t fa[4] = {pack_bf16(p[2 * kt][0] * f0, p[2 * kt][1] * f0),
                            pack_bf16(p[2 * kt][2] * f1, p[2 * kt][3] * f1),
                            pack_bf16(p[2 * kt + 1][0] * f0, p[2 * kt + 1][1] * f0),
                            pack_bf16(p[2 * kt + 1][2] * f1, p[2 * kt + 1][3] * f1)};
#pragma unroll
    for (int dp = 0; dp < DT; ++dp) {
      if (dp >= nd) break;
      uint32_t fb[4];
      ldsm_x4<true>(fb, tile_b(m, ld, kt * 16, dp * 16, lane));
      mma16816(o[2 * dp], fa, fb[0], fb[1]);
      mma16816(o[2 * dp + 1], fa, fb[2], fb[3]);
    }
  }
}

// Row max and sum within the quad of lanes that hold one row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// exp(x) for the softmax: expf, or with FAST_EXP the multiply and ex2.approx
// of __expf (2 instructions instead of ~10; its error, at most 2 + 1.16|x|
// ulp, is far below the bf16 rounding of P that follows).
template <bool FAST_EXP> __device__ __forceinline__ float softmax_exp(float x) {
  return FAST_EXP ? __expf(x) : expf(x);
}

// softmax over the columns of s (in place, unnormalised: exp(s - max)),
// returning 1 / rowsum for row halves g and g+8; columns >= n are -inf.
template <int NT, bool FAST_EXP = false>
__device__ __forceinline__ void mma_softmax(float (&s)[2 * NT][4], int nk, float& inv0,
                                            float& inv1) {
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
    if (j >= 2 * nk) break;
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
    if (j >= 2 * nk) break;
    s[j][0] = softmax_exp<FAST_EXP>(s[j][0] - m0);
    s[j][1] = softmax_exp<FAST_EXP>(s[j][1] - m0);
    s[j][2] = softmax_exp<FAST_EXP>(s[j][2] - m1);
    s[j][3] = softmax_exp<FAST_EXP>(s[j][3] - m1);
    l0 += s[j][0] + s[j][1];
    l1 += s[j][2] + s[j][3];
  }
  inv0 = 1.f / quad_sum(l0);
  inv1 = 1.f / quad_sum(l1);
}

// The logits of one warp's 16 rows (C fragments s, rows r0..), scaled in
// f32 after the product and then biased: s * scale + bias(row, col) where
// col < n, -inf at the padded keys. bias(row, col) is called for
// row < pad16(n), col < n.
template <int NT, typename BiasFn>
__device__ __forceinline__ void add_bias(float (&s)[2 * NT][4], int r0, int nk, int n,
                                         float scale, BiasFn bias) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
    if (j >= 2 * nk) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + ((e >> 1) << 3), col = 8 * j + 2 * t + (e & 1);
      s[j][e] = col < n ? __fmul_rn(s[j][e], scale) + bias(row, col) : -INFINITY;
    }
  }
}

// A (pad16(n), pad16(n)) f32 bias kept in shared memory in the order of the
// C fragments: the float4 of lane L for 8-column tile j of 16-row tile rt
// sits at (rt * pad16(n) / 8 + j) * 32 + L and holds that lane's c0..c3.
// -inf at the padded keys, 0 at the padded rows (mma_bias_tile). Each lane
// reads its 2 pad16(n) / 8 values of a row tile as float4s, in 4 wavefronts
// a warp-wide load, whatever its (row, col).
struct FragBias {
  const float4* tile;
};

// Offset, in floats, of element (row, col) of such a tile of `tiles`
// 8-column tiles a row tile (pad16(n) / 8).
__device__ __forceinline__ int frag_offset(int row, int col, int tiles) {
  const int r = row & 15, cc = col & 7;
  return ((((row >> 4) * tiles + (col >> 3)) * 32 + ((r & 7) << 2) + (cc >> 1)) << 2) +
         ((r >> 3) << 1) + (cc & 1);
}

// Fill a FragBias tile with bias + mask ((n, n) f32 each, either may be
// null); all threads of the block call it and the caller synchronises
// before the tile is read. The two are summed first, then added to the
// logit: (s + bias) + mask in the JAX kernels, s + (bias + mask) here, at
// most one f32 rounding apart, and equal wherever the mask is 0.
__device__ __forceinline__ void mma_bias_tile(float* tile, const float* __restrict__ bias,
                                              const float* __restrict__ mask, int n) {
  const int np = mma_pad16(n), tiles = np >> 3;
  // a float4 of the tile at a time, in its order, two of them in flight
#pragma unroll 2
  for (int f = threadIdx.x; f < np * np / 4; f += blockDim.x) {
    const int lane = f & 31, rt = (f >> 5) / tiles, j = (f >> 5) - rt * tiles;
    const int row = rt * 16 + (lane >> 2), col = 8 * j + 2 * (lane & 3);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + ((e >> 1) << 3), cc = col + (e & 1);
      const bool in = r < n && cc < n;
      const float b = in && bias ? bias[r * n + cc] : 0.f;
      const float m = in && mask ? mask[r * n + cc] : 0.f;
      v[e] = cc < n ? b + m : -INFINITY;
    }
    reinterpret_cast<float4*>(tile)[f] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// add_bias from a FragBias tile: the padded keys' -inf comes from the tile.
template <int NT>
__device__ __forceinline__ void add_bias(float (&s)[2 * NT][4], int r0, int nk, int n,
                                         float scale, FragBias bias) {
  const float4* p = bias.tile + (r0 >> 4) * 2 * nk * 32 + (threadIdx.x & 31);
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
    if (j >= 2 * nk) break;
    const float4 b = p[j * 32];
    s[j][0] = __fmul_rn(s[j][0], scale) + b.x;
    s[j][1] = __fmul_rn(s[j][1], scale) + b.y;
    s[j][2] = __fmul_rn(s[j][2], scale) + b.z;
    s[j][3] = __fmul_rn(s[j][3], scale) + b.w;
  }
}

// softmax(q . k^T * scale + bias(row, col)) . v for one (window, head), in
// bf16 with f32 logits, softmax and sums; P is rounded to bf16 before P.v.
// sq, sk, sv: staged by mma_stage, pad16(n) rows `ld` apart; each warp
// reuses its own rows of sq to stage its output, which it writes to `out`
// (rows `ldo` apart) in 16-byte stores. bias: a FragBias, or a callable
// bias(row, col) (add_bias). All threads of the block call it.
template <int NT, int DT, bool FAST_EXP = false, typename BiasFn>
__device__ void mma_head_attention(bf16* sq, const bf16* sk, const bf16* sv, int ld,
                                   bf16* __restrict__ out, int ldo, int n, int hd, float scale,
                                   BiasFn bias) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nk = mma_pad16(n) >> 4, nd = mma_pad16(hd) >> 4;
  for (int rt = warp; rt < nk; rt += blockDim.x >> 5) {
    const int r0 = rt * 16;
    float s[2 * NT][4];
    mma_rows_abt<NT, DT>(s, sq, sk, ld, r0, nk, nd, lane);
    add_bias<NT>(s, r0, nk, n, scale, bias);
    float inv0, inv1;
    mma_softmax<NT, FAST_EXP>(s, nk, inv0, inv1);
    float o[2 * DT][4];
    mma_rows_pm<NT, DT>(o, s, inv0, inv1, sv, ld, nk, nd, lane);
    bf16* stage = sq + r0 * ld;
#pragma unroll
    for (int dn = 0; dn < 2 * DT; ++dn) {
      if (dn >= 2 * nd) break;
      *reinterpret_cast<uint32_t*>(stage + g * ld + 8 * dn + 2 * t) =
          pack_bf16(o[dn][0], o[dn][1]);
      *reinterpret_cast<uint32_t*>(stage + (g + 8) * ld + 8 * dn + 2 * t) =
          pack_bf16(o[dn][2], o[dn][3]);
    }
    __syncwarp();
    for_chunks(lane, 32, 16, hd >> 3, [&](int r, int ch) {
      if (r0 + r < n)
        *reinterpret_cast<uint4*>(out + (size_t)(r0 + r) * ldo + (ch << 3)) =
            *reinterpret_cast<const uint4*>(stage + r * ld + (ch << 3));
    });
  }
}

// Gradient of one (window, head), first half: per warp and 16 query rows,
// recompute S = qs . k^T + bias (add_bias) and P in f32, dP = dO . v^T, and
//   dS = P * (dP - rowsum(dP * P)),
// hand the f32 dS to sink.tile(r0, ds) (all lanes of the warp together; ds
// holds C fragments as S, and is 0 at padded rows and keys), write
//   dq = bf16(dS) . k * scale
// to `dq` (rows `ldg` apart), and store bf16(P) and bf16(dS) in sp and sds
// ((pad16(n), pad16(n)) laid out by swz; zero at padded rows and keys) for
// mma_bwd_keys. sq holds qs = q * scale rounded to bf16 (mma_scale_staged).
template <int NT, int DT, bool FAST_EXP = false, typename BiasFn, typename Sink>
__device__ void mma_bwd_rows(const bf16* sq, const bf16* sk, const bf16* sv, const bf16* sdo,
                             int ld, bf16* sp, bf16* sds, bf16* __restrict__ dq,
                             int ldg, int n, int hd, float scale, BiasFn bias, Sink& sink) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int np = mma_pad16(n), nk = np >> 4, nd = mma_pad16(hd) >> 4;
  for (int rt = warp; rt < nk; rt += blockDim.x >> 5) {
    const int r0 = rt * 16;
    float s[2 * NT][4], dp[2 * NT][4];
    mma_rows_abt<NT, DT>(s, sq, sk, ld, r0, nk, nd, lane);
    mma_rows_abt<NT, DT>(dp, sdo, sv, ld, r0, nk, nd, lane);
    add_bias<NT>(s, r0, nk, n, 1.f, bias);  // q came scaled: s * 1 is exact
    float inv0, inv1;
    mma_softmax<NT, FAST_EXP>(s, nk, inv0, inv1);
    // padded rows get P = 0, so that they add nothing to dk, dv or dT
    if (r0 + g >= n) inv0 = 0.f;
    if (r0 + g + 8 >= n) inv1 = 0.f;
    float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      if (j >= 2 * nk) break;
      s[j][0] *= inv0;
      s[j][1] *= inv0;
      s[j][2] *= inv1;
      s[j][3] *= inv1;
      dot0 = fmaf(dp[j][0], s[j][0], fmaf(dp[j][1], s[j][1], dot0));
      dot1 = fmaf(dp[j][2], s[j][2], fmaf(dp[j][3], s[j][3], dot1));
    }
    dot0 = quad_sum(dot0);
    dot1 = quad_sum(dot1);
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      if (j >= 2 * nk) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - ((e >> 1) ? dot1 : dot0));
    }
    sink.template tile<NT>(r0, dp);
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      if (j >= 2 * nk) break;
      const int c = 8 * j + 2 * t;
      const int o0 = swz(r0 + g, c, np), o1 = swz(r0 + g + 8, c, np);
      *reinterpret_cast<uint32_t*>(sp + o0) = pack_bf16(s[j][0], s[j][1]);
      *reinterpret_cast<uint32_t*>(sp + o1) = pack_bf16(s[j][2], s[j][3]);
      *reinterpret_cast<uint32_t*>(sds + o0) = pack_bf16(dp[j][0], dp[j][1]);
      *reinterpret_cast<uint32_t*>(sds + o1) = pack_bf16(dp[j][2], dp[j][3]);
    }
    float o[2 * DT][4];
    mma_rows_pm<NT, DT>(o, dp, 1.f, 1.f, sk, ld, nk, nd, lane);
#pragma unroll
    for (int dn = 0; dn < 2 * DT; ++dn) {
      if (8 * dn >= hd) break;
      const int c = 8 * dn + 2 * t;
      if (r0 + g < n)
        *reinterpret_cast<uint32_t*>(dq + (size_t)(r0 + g) * ldg + c) =
            pack_bf16(o[dn][0] * scale, o[dn][1] * scale);
      if (r0 + g + 8 < n)
        *reinterpret_cast<uint32_t*>(dq + (size_t)(r0 + g + 8) * ldg + c) =
            pack_bf16(o[dn][2] * scale, o[dn][3] * scale);
    }
  }
}

// Second half, after a barrier: per warp and 16 keys,
//   dk = bf16(dS)^T . qs, dv = bf16(P)^T . dO
// over all pad16(n) rows, written to dk and dv (rows `ldg` apart). Reads
// sq, sdo, sp and sds only, so the caller may refill sk and sv meanwhile.
template <int NT, int DT>
__device__ void mma_bwd_keys(const bf16* sq, const bf16* sdo, int ld, const bf16* sp,
                             const bf16* sds, bf16* __restrict__ dk,
                             bf16* __restrict__ dv, int ldg, int n, int hd) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int np = mma_pad16(n), nk = np >> 4, nd = mma_pad16(hd) >> 4;
  for (int kt = warp; kt < nk; kt += blockDim.x >> 5) {
    const int k0 = kt * 16;
    float gk[2 * DT][4], gv[2 * DT][4];
#pragma unroll
    for (int j = 0; j < 2 * DT; ++j)
      gk[j][0] = gk[j][1] = gk[j][2] = gk[j][3] = gv[j][0] = gv[j][1] = gv[j][2] = gv[j][3] =
          0.f;
#pragma unroll
    for (int rs = 0; rs < NT; ++rs) {
      if (rs >= nk) break;
      uint32_t fds[4], fp[4];
      ldsm_x4<true>(fds, tile_at(sds, np, rs * 16, k0, lane));
      ldsm_x4<true>(fp, tile_at(sp, np, rs * 16, k0, lane));
#pragma unroll
      for (int dp = 0; dp < DT; ++dp) {
        if (dp >= nd) break;
        uint32_t fb[4];
        ldsm_x4<true>(fb, tile_b(sq, ld, rs * 16, dp * 16, lane));
        mma16816(gk[2 * dp], fds, fb[0], fb[1]);
        mma16816(gk[2 * dp + 1], fds, fb[2], fb[3]);
        ldsm_x4<true>(fb, tile_b(sdo, ld, rs * 16, dp * 16, lane));
        mma16816(gv[2 * dp], fp, fb[0], fb[1]);
        mma16816(gv[2 * dp + 1], fp, fb[2], fb[3]);
      }
    }
#pragma unroll
    for (int dn = 0; dn < 2 * DT; ++dn) {
      if (8 * dn >= hd) break;
      const int c = 8 * dn + 2 * t;
      if (k0 + g < n) {
        const size_t off = (size_t)(k0 + g) * ldg + c;
        *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16(gk[dn][0], gk[dn][1]);
        *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(gv[dn][0], gv[dn][1]);
      }
      if (k0 + g + 8 < n) {
        const size_t off = (size_t)(k0 + g + 8) * ldg + c;
        *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16(gk[dn][2], gk[dn][3]);
        *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(gv[dn][2], gv[dn][3]);
      }
    }
  }
}

// Windows a block walks, for a grid of (bw / wpb) x heads blocks of
// `kernel` at `smem` bytes: runs of about `target` windows, sized so that
// the grid fills whole waves of the blocks the card holds at once (a
// block's windows run one after another, so a last wave part full leaves
// SMs idle for a whole run). 0 on an error.
template <typename K>
static int balanced_windows_per_block(K kernel, size_t smem, int bw, int heads, int target) {
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, MMA_THREADS, smem) !=
          cudaSuccess)
    return 0;
  const long long work = (long long)bw * heads, slots = (long long)sms * max(per_sm, 1);
  const long long waves = max(1LL, (work + slots * target / 2) / (slots * target));
  const long long per_block = (work + slots * waves - 1) / (slots * waves);
  return (int)min((long long)bw, max(1LL, per_block));
}
