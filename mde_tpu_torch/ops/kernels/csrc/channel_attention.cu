// K5: kernel-window (channel) cross attention of the KSA decoder, forward.
//
// Replaces the TPU kernel _pallas_channel_attention
// (mde_tpu/ops/pallas/channel_attention.py:70, body _kernel :45), reached
// through fused_channel_attention (:183). Per window and head the "sequence"
// axes are channels: the scores contract the tokens,
//   S[d, e] = sum_n q[n, d] k[n, e] * scale,  P = softmax_e(S) (f32),
//   out[n, d] = sum_e P[d, e] v[n, e],
// with P rounded to the input dtype before P.v, as the TPU kernel casts it.
// The head dims hd = C/heads (decoder side) and ehd = EC/heads (encoder
// side) may differ. k and v are strided views of the fused kv projection
// (row stride 2 EC), so the caller makes no copies.
//
// What bounds it on an H100: at the KSA decoder's serving shapes (batch 8:
// 4096 windows of 49 tokens at C = EC = 64 and 4 heads, 1024 at 128 and 8,
// 256 at 256 and 16; hd = ehd = 16 at all three, bf16) it reads q, k, v and
// writes out once, 4 * 4096*49*64 * 2 B = 103 MB, 31 us at 3.35 TB/s,
// against 4 * 4096*49*16*16*4 = 0.8 GFLOP (under 1 us on the tensor
// cores): it is bound by bytes.
//
// Tensor-core body (bf16, n <= 128 tokens, hd and ehd multiples of 8 up
// to 128; the rule mma_shape of attention_mma.cuh, on both head dims): a
// block of one warp owns one (window, head), the heads of a window in
// neighbouring blocks (blocks of 2 or 4 heads, a warp each, ran alike:
// tools/k4_k5_variants.py). The warp stages its head's q, k and v rows by
// 16-byte cp.async straight from the strided views (rows padded to a
// multiple of 16 with zeros, the head dims to a multiple of 16, rows
// mma_ld apart so that ldmatrix meets no bank conflict). Per 16 rows d of the head, mma.sync.m16n8k16 computes S = q^T k
// over the tokens (A = q^T by ldmatrix.trans, B = k by ldmatrix.trans: 8
// products at n = 49, hd = ehd = 16), S is scaled in f32 and its padded
// columns set to -inf, the softmax reduces within the quad of lanes that
// share a row (expf, as the CUDA-core body), and the C fragments of S's
// 8-column tiles, times 1/rowsum and rounded to bf16, are the A fragments
// of out^T = P . v^T (B = v by ldmatrix, 16 columns of out^T a product).
// out^T goes back to (token, d) through the warp's own q rows, which the
// scores no longer need, and leaves in 16-byte stores.
//
// f32 inputs (the card's f32 checks, held at 1e-5), and bf16 outside the
// tensor-core shapes, take the CUDA-core body below: a block takes several
// (window, head) pairs, PAIRS_SMEM_FLOATS of shared memory's worth, and
// stages their q, k and v as f32; the scores, the row softmax (one thread
// per row) and P.v stay in shared memory. P's rows are padded to ehd + 1
// floats so that threads reading one column of P for consecutive d hit
// different banks.

#include "attention_mma.cuh"

// Shared memory a forward block aims to fill with pairs (floats, 48 KB).
constexpr int PAIRS_SMEM_FLOATS = 12288;

template <typename T>
__global__ void channel_attention_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                                         T* __restrict__ out, int pairs, int heads, int n,
                                         int hd, int ehd, int ldq, int ldkv, float scale,
                                         int ppb) {
  extern __shared__ float smem[];
  const int per = (int)channel_pair_smem_floats(n, hd, ehd);
  const int p0 = blockIdx.x * ppb;
  const int np = min(ppb, pairs - p0);
  const int ec = heads * ehd, ldp = ehd + 1;
  const int nq = n * hd, nk = n * ehd;
  // per pair: q (n x hd), k (n x ehd), v (n x ehd), P (hd x ldp)
  for (int i = threadIdx.x; i < np * nq; i += blockDim.x) {
    const int p = i / nq, rem = i - p * nq, r = rem / hd, d = rem - r * hd;
    const int pair = p0 + p, w = pair / heads, h = pair - w * heads;
    smem[p * per + rem] = to_float(q[((size_t)w * n + r) * ldq + (size_t)h * hd + d]);
  }
  for (int i = threadIdx.x; i < np * nk; i += blockDim.x) {
    const int p = i / nk, rem = i - p * nk, r = rem / ehd, e = rem - r * ehd;
    const int pair = p0 + p, w = pair / heads, h = pair - w * heads;
    const size_t off = ((size_t)w * n + r) * ldkv + (size_t)h * ehd + e;
    float* sk = smem + p * per + nq;
    sk[rem] = to_float(kv[off]);
    sk[nk + rem] = to_float(kv[off + ec]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < np * hd * ehd; i += blockDim.x) {
    const int p = i / (hd * ehd), rem = i - p * hd * ehd, d = rem / ehd, e = rem - d * ehd;
    float* sq = smem + p * per;
    const float* sk = sq + nq;
    float s = 0.f;
    for (int r = 0; r < n; ++r) s = fmaf(sq[r * hd + d], sk[r * ehd + e], s);
    (sq + nq + 2 * nk)[d * ldp + e] = s * scale;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < np * hd; i += blockDim.x) {
    const int p = i / hd, d = i - p * hd;
    float* row = smem + p * per + nq + 2 * nk + d * ldp;
    float m = -INFINITY;
    for (int e = 0; e < ehd; ++e) m = fmaxf(m, row[e]);
    float sum = 0.f;
    for (int e = 0; e < ehd; ++e) {
      const float x = expf(row[e] - m);
      row[e] = x;
      sum += x;
    }
    const float inv = 1.f / sum;
    for (int e = 0; e < ehd; ++e) row[e] = round_to<T>(row[e] * inv);
  }
  __syncthreads();
  const int c = heads * hd;
  for (int i = threadIdx.x; i < np * nq; i += blockDim.x) {
    const int p = i / nq, rem = i - p * nq, r = rem / hd, d = rem - r * hd;
    const int pair = p0 + p, w = pair / heads, h = pair - w * heads;
    const float* sv = smem + p * per + nq + nk;
    const float* pr = sv + nk + d * ldp;
    float o = 0.f;
    for (int e = 0; e < ehd; ++e) o = fmaf(pr[e], sv[r * ehd + e], o);
    out[((size_t)w * n + r) * c + (size_t)h * hd + d] = from_float<T>(o);
  }
}

// Pairs a block of the CUDA-core body takes, and its shared memory.
static int cuda_core_pairs(int n, int hd, int ehd) {
  return (int)max((size_t)1, PAIRS_SMEM_FLOATS / channel_pair_smem_floats(n, hd, ehd));
}
static size_t cuda_core_smem(int n, int hd, int ehd) {
  return channel_pair_smem_floats(n, hd, ehd) * cuda_core_pairs(n, hd, ehd) * sizeof(float);
}

template <typename T>
static int launch_cuda_cores(const void* q, const void* kv, void* out, int bw, int n, int c,
                             int ec, int heads, float scale, cudaStream_t stream) {
  const int hd = c / heads, ehd = ec / heads;
  const int ppb = cuda_core_pairs(n, hd, ehd);
  const size_t smem = cuda_core_smem(n, hd, ehd);
  cudaError_t err = allow_smem(channel_attention_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int pairs = bw * heads;
  channel_attention_kernel<T><<<(pairs + ppb - 1) / ppb, 128, smem, stream>>>(
      (const T*)q, (const T*)kv, (T*)out, pairs, heads, n, hd, ehd, c, 2 * ec, scale, ppb);
  return (int)cudaGetLastError();
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

// Shared memory of the tensor-core body: q, k and v in pad16(n) rows of
// mma_ld(head dim) elements.
static size_t mma_smem(int n, int hd, int ehd) {
  return (size_t)mma_pad16(n) * (mma_ld(hd) + 2 * mma_ld(ehd)) * sizeof(bf16);
}

// The tensor-core body: block b (one warp) takes window b / heads and head
// b mod heads; NT and ET bound pad16(n) / 16 and pad16(ehd) / 16.
template <int NT, int ET, bool FAST_EXP = false>
__global__ void __launch_bounds__(32)
    channel_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                                 bf16* __restrict__ out, int n, int c, int ec, int heads,
                                 float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int w = blockIdx.x / heads, h = blockIdx.x - w * heads;
  const int hd = c / heads, ehd = ec / heads, np = mma_pad16(n);
  const int ldq = mma_ld(hd), ldk = mma_ld(ehd);
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = sq + np * ldq;
  bf16* sv = sk + np * ldk;
  const bf16* kw = kv + (size_t)w * n * 2 * ec + (size_t)h * ehd;
  warp_stage(sq, q + (size_t)w * n * c + (size_t)h * hd, n, np, hd, c, ldq, lane);
  warp_stage(sk, kw, n, np, ehd, 2 * ec, ldk, lane);
  warp_stage(sv, kw + ec, n, np, ehd, 2 * ec, ldk, lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();

  const int nk = np >> 4, ne = mma_pad16(ehd) >> 4;
  for (int d0 = 0; d0 < hd; d0 += 16) {
    // S rows d0 .. d0 + 15: A = q^T (rows d, k = tokens), transposed
    // (tile_bt's addresses are those of A of m^T . b), B = k (k = tokens,
    // n = e), transposed
    float s[2 * ET][4];
#pragma unroll
    for (int j = 0; j < 2 * ET; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < NT; ++kt) {
      if (kt >= nk) break;
      uint32_t fa[4];
      ldsm_x4<true>(fa, tile_bt(sq, ldq, kt * 16, d0, lane));
#pragma unroll
      for (int et = 0; et < ET; ++et) {
        if (et >= ne) break;
        uint32_t fb[4];
        ldsm_x4<true>(fb, tile_b(sk, ldk, kt * 16, et * 16, lane));
        mma16816(s[2 * et], fa, fb[0], fb[1]);
        mma16816(s[2 * et + 1], fa, fb[2], fb[3]);
      }
    }
    // the logits in f32, -inf at the padded columns e >= ehd
#pragma unroll
    for (int j = 0; j < 2 * ET; ++j) {
      if (j >= 2 * ne) break;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = 8 * j + 2 * t + (e & 1) < ehd ? __fmul_rn(s[j][e], scale) : -INFINITY;
    }
    float inv0, inv1;
    mma_softmax<ET, FAST_EXP>(s, ne, inv0, inv1);
    // out^T rows d0 .. d0 + 15 = bf16(P) . v^T: B = v (n = tokens, k = e)
    float o[2 * NT][4];
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
    for (int et = 0; et < ET; ++et) {
      if (et >= ne) break;
      const uint32_t fa[4] = {pack_bf16(s[2 * et][0] * inv0, s[2 * et][1] * inv0),
                              pack_bf16(s[2 * et][2] * inv1, s[2 * et][3] * inv1),
                              pack_bf16(s[2 * et + 1][0] * inv0, s[2 * et + 1][1] * inv0),
                              pack_bf16(s[2 * et + 1][2] * inv1, s[2 * et + 1][3] * inv1)};
#pragma unroll
      for (int kt = 0; kt < NT; ++kt) {
        if (kt >= nk) break;
        uint32_t fb[4];
        ldsm_x4<false>(fb, tile_bt(sv, ldk, kt * 16, et * 16, lane));
        mma16816(o[2 * kt], fa, fb[0], fb[1]);
        mma16816(o[2 * kt + 1], fa, fb[2], fb[3]);
      }
    }
    // out[token, d] over q's columns d0 .. d0 + 15, which every lane has read
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      if (j >= 2 * nk) break;
      bf16* o0 = sq + (8 * j + 2 * t) * ldq + d0 + g;
      o0[0] = __float2bfloat16(o[j][0]);
      o0[ldq] = __float2bfloat16(o[j][1]);
      o0[8] = __float2bfloat16(o[j][2]);
      o0[ldq + 8] = __float2bfloat16(o[j][3]);
    }
  }
  __syncwarp();
  bf16* ow = out + (size_t)w * n * c + (size_t)h * hd;
  for_chunks(lane, 32, n, hd >> 3, [&](int r, int ch) {
    *reinterpret_cast<uint4*>(ow + (size_t)r * c + (ch << 3)) =
        *reinterpret_cast<const uint4*>(sq + r * ldq + (ch << 3));
  });
}

template <int NT, int ET>
static int launch_mma(const void* q, const void* kv, void* out, int bw, int n, int c, int ec,
                      int heads, float scale, cudaStream_t stream) {
  auto kernel = channel_attention_mma_kernel<NT, ET>;
  const size_t smem = mma_smem(n, c / heads, ec / heads);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)bw * heads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 32, smem, stream>>>((const bf16*)q, (const bf16*)kv, (bf16*)out,
                                                 n, c, ec, heads, scale);
  return (int)cudaGetLastError();
}

// The shape rule: bf16 on the tensor cores where both head dims and the
// window fit mma_shape; f32 and the rest on the CUDA cores.
inline bool channel_mma(int n, int hd, int ehd, int dtype) {
  return dtype == MDE_BF16 && mma_shape(n, hd) && mma_shape(n, ehd);
}

// q: contiguous (bw, n, c); kv: contiguous (bw, n, 2 ec), k | v along the
// last dim; out: contiguous (bw, n, c). The tensor-core body takes q, kv
// and out 16-byte aligned. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int mde_channel_attention(const void* q, const void* kv, void* out, int bw, int n,
                                     int c, int ec, int heads, float scale, int dtype,
                                     void* stream) {
  if (heads <= 0 || c % heads != 0 || ec % heads != 0 || n <= 0 || bw <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int hd = c / heads, ehd = ec / heads;
  if (dtype == MDE_F32)
    return launch_cuda_cores<float>(q, kv, out, bw, n, c, ec, heads, scale, s);
  if (dtype != MDE_BF16) return (int)cudaErrorInvalidValue;
  if (!channel_mma(n, hd, ehd, dtype))
    return launch_cuda_cores<bf16>(q, kv, out, bw, n, c, ec, heads, scale, s);
  if (((uintptr_t)q | (uintptr_t)kv | (uintptr_t)out) & 15) return (int)cudaErrorMisalignedAddress;
  if (n <= 64 && ehd <= 16)
    return launch_mma<4, 1>(q, kv, out, bw, n, c, ec, heads, scale, s);
  return launch_mma<8, 8>(q, kv, out, bw, n, c, ec, heads, scale, s);
}

// Bytes of shared memory one block of mde_channel_attention takes for this
// shape and dtype (MDE_F32 or MDE_BF16).
extern "C" int mde_channel_attention_smem(int n, int c, int ec, int heads, int dtype) {
  if (heads <= 0 || n <= 0) return 0;
  const int hd = c / heads, ehd = ec / heads;
  if (channel_mma(n, hd, ehd, dtype)) return (int)mma_smem(n, hd, ehd);
  return (int)cuda_core_smem(n, hd, ehd);
}
