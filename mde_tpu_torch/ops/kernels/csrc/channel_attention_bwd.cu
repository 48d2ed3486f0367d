// K5 backward: gradients of the KSA decoder's kernel-window (channel) cross
// attention.
//
// Replaces the TPU kernel _pallas_channel_attention_bwd
// (mde_tpu/ops/pallas/channel_attention.py:137, body _bwd_kernel :94). Per
// window and head it recomputes S[d, e] = sum_n q[n, d] k[n, e] * scale and
// P = softmax_e(S) in f32 from the saved q, k, v, then
//   dP[d, e] = sum_n dO[n, d] v[n, e],
//   dS = P * (dP - rowsum(dP * P)) * scale,
//   dq[n, d] = sum_e dS[d, e] k[n, e],  dk[n, e] = sum_d dS[d, e] q[n, d],
//   dv[n, e] = sum_d P[d, e] dO[n, d],
// with P and dS rounded to the input dtype before the three products, as
// the TPU kernel casts them (:121-131). dk and dv are written into one
// fused (bw, n, 2 EC) gradient laid out like the kv projection.
//
// What bounds it on an H100: at the KSA stage-0 train shape (2048 windows
// of 49 tokens, C = EC = 64, 4 heads, hd = ehd = 16, bf16) it reads q, k,
// v, dO and writes dq, dk, dv once, 7 * 2048*49*64 * 2 B = 90 MB, 27 us at
// 3.35 TB/s, against 2048*4 * 5 * 49*16*16*2 = 1.0 GFLOP (1 us on the
// tensor cores): it is bound by bytes.
//
// Tensor-core body (bf16 where the forward's rule channel_mma holds: n <=
// 128 tokens, head dims multiples of 8 up to 128; q, kv, dO, dq and dkv
// 16-byte aligned): as the forward, a block of one warp owns one (window,
// head). The warp stages q and k, then dO and v, by 16-byte cp.async
// straight from the strided views (two groups, so that S is computed while
// dO and v arrive; rows padded to a multiple of 16 with zeros, the head
// dims to a multiple of 16, rows mma_ld apart so that ldmatrix meets no
// bank conflict). Per 16 rows d, S = q^T k and dP = dO^T v are each one
// mma.sync.m16n8k16 chain over the tokens (A by ldmatrix.trans, as the
// forward takes q^T); the softmax and dS are computed on the C fragments,
// reducing within the quad of lanes that share a row (padded columns e are
// -inf in S, so 0 in P and dS; padded rows d get P = 0). P and dS, rounded
// to bf16 (16 x 16 per head at the KSA shapes, 512 B each), go to shared
// memory, from which the three products over tokens x head dim read them as
// B operands: dq = k . dS^T (ldmatrix), dk = q . dS and dv = dO . P
// (ldmatrix.trans), 16 tokens at a time, each accumulated in f32 registers
// and written back through a 16-row stage in shared memory in 16-byte
// stores.
//
// f32 inputs (the card's f32 checks, held at 1e-5) and bf16 outside the
// tensor-core shapes take the CUDA-core body: a block takes several
// (window, head) pairs with q, dO, k and v staged in shared memory as f32
// and P, dS kept there (rows padded to ehd + 1). Neither body falls back to
// the other. No gradient is summed across windows, so there are no atomics
// and every bit is the same from run to run.

#include "attention_mma.cuh"

// Shared memory a backward block aims to fill with pairs (floats, 48 KB).
constexpr int PAIRS_SMEM_FLOATS = 12288;

template <typename T>
__global__ void channel_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                                             const T* __restrict__ dout, T* __restrict__ dq,
                                             T* __restrict__ dkv, int pairs, int heads, int n,
                                             int hd, int ehd, float scale, int ppb) {
  extern __shared__ float smem[];
  const int per = (int)channel_pair_bwd_smem_floats(n, hd, ehd);
  const int p0 = blockIdx.x * ppb;
  const int np = min(ppb, pairs - p0);
  const int c = heads * hd, ec = heads * ehd, ldp = ehd + 1;
  const int nq = n * hd, nk = n * ehd;
  // per pair: q, dO (n x hd each), k, v (n x ehd each), P, dS (hd x ldp each)
  for (int i = threadIdx.x; i < np * nq; i += blockDim.x) {
    const int p = i / nq, rem = i - p * nq, r = rem / hd, d = rem - r * hd;
    const int pair = p0 + p, w = pair / heads, h = pair - w * heads;
    const size_t off = ((size_t)w * n + r) * c + (size_t)h * hd + d;
    float* sq = smem + p * per;
    sq[rem] = to_float(q[off]);
    sq[nq + rem] = to_float(dout[off]);
  }
  for (int i = threadIdx.x; i < np * nk; i += blockDim.x) {
    const int p = i / nk, rem = i - p * nk, r = rem / ehd, e = rem - r * ehd;
    const int pair = p0 + p, w = pair / heads, h = pair - w * heads;
    const size_t off = ((size_t)w * n + r) * 2 * ec + (size_t)h * ehd + e;
    float* sk = smem + p * per + 2 * nq;
    sk[rem] = to_float(kv[off]);
    sk[nk + rem] = to_float(kv[off + ec]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < np * hd * ehd; i += blockDim.x) {
    const int p = i / (hd * ehd), rem = i - p * hd * ehd, d = rem / ehd, e = rem - d * ehd;
    float* sq = smem + p * per;
    float* sdo = sq + nq;
    float* sk = sdo + nq;
    float* sv = sk + nk;
    float s = 0.f, dp = 0.f;
    for (int r = 0; r < n; ++r) {
      s = fmaf(sq[r * hd + d], sk[r * ehd + e], s);
      dp = fmaf(sdo[r * hd + d], sv[r * ehd + e], dp);
    }
    float* sp = sv + nk;
    sp[d * ldp + e] = s * scale;
    sp[hd * ldp + d * ldp + e] = dp;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < np * hd; i += blockDim.x) {
    const int p = i / hd, d = i - p * hd;
    float* prow = smem + p * per + 2 * nq + 2 * nk + d * ldp;
    float* drow = prow + hd * ldp;
    float m = -INFINITY;
    for (int e = 0; e < ehd; ++e) m = fmaxf(m, prow[e]);
    float sum = 0.f;
    for (int e = 0; e < ehd; ++e) {
      const float x = expf(prow[e] - m);
      prow[e] = x;
      sum += x;
    }
    const float inv = 1.f / sum;
    float dot = 0.f;
    for (int e = 0; e < ehd; ++e) {
      prow[e] *= inv;
      dot = fmaf(drow[e], prow[e], dot);
    }
    for (int e = 0; e < ehd; ++e) {
      const float pv = prow[e];
      drow[e] = round_to<T>(pv * (drow[e] - dot) * scale);
      prow[e] = round_to<T>(pv);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < np * nq; i += blockDim.x) {
    const int p = i / nq, rem = i - p * nq, r = rem / hd, d = rem - r * hd;
    const int pair = p0 + p, w = pair / heads, h = pair - w * heads;
    const float* sk = smem + p * per + 2 * nq;
    const float* ds = sk + 2 * nk + hd * ldp + d * ldp;
    float g = 0.f;
    for (int e = 0; e < ehd; ++e) g = fmaf(ds[e], sk[r * ehd + e], g);
    dq[((size_t)w * n + r) * c + (size_t)h * hd + d] = from_float<T>(g);
  }
  for (int i = threadIdx.x; i < np * nk; i += blockDim.x) {
    const int p = i / nk, rem = i - p * nk, r = rem / ehd, e = rem - r * ehd;
    const int pair = p0 + p, w = pair / heads, h = pair - w * heads;
    const float* sq = smem + p * per;
    const float* sdo = sq + nq;
    const float* sp = sq + 2 * nq + 2 * nk;
    const float* ds = sp + hd * ldp;
    float gk = 0.f, gv = 0.f;
    for (int d = 0; d < hd; ++d) {
      gk = fmaf(ds[d * ldp + e], sq[r * hd + d], gk);
      gv = fmaf(sp[d * ldp + e], sdo[r * hd + d], gv);
    }
    const size_t off = ((size_t)w * n + r) * 2 * ec + (size_t)h * ehd + e;
    dkv[off] = from_float<T>(gk);
    dkv[off + ec] = from_float<T>(gv);
  }
}

// Pairs a block of the CUDA-core body takes, and its shared memory.
static int cuda_core_pairs(int n, int hd, int ehd) {
  return (int)max((size_t)1, PAIRS_SMEM_FLOATS / channel_pair_bwd_smem_floats(n, hd, ehd));
}
static size_t cuda_core_smem(int n, int hd, int ehd) {
  return channel_pair_bwd_smem_floats(n, hd, ehd) * cuda_core_pairs(n, hd, ehd) * sizeof(float);
}

template <typename T>
static int launch_cuda_cores(const void* q, const void* kv, const void* dout, void* dq,
                             void* dkv, int bw, int n, int c, int ec, int heads, float scale,
                             cudaStream_t stream) {
  const int hd = c / heads, ehd = ec / heads;
  const int ppb = cuda_core_pairs(n, hd, ehd);
  const size_t smem = cuda_core_smem(n, hd, ehd);
  cudaError_t err = allow_smem(channel_attention_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int pairs = bw * heads;
  channel_attention_bwd_kernel<T><<<(pairs + ppb - 1) / ppb, 128, smem, stream>>>(
      (const T*)q, (const T*)kv, (const T*)dout, (T*)dq, (T*)dkv, pairs, heads, n, hd, ehd,
      scale, ppb);
  return (int)cudaGetLastError();
}

// Shared memory of the tensor-core body: q and dO in pad16(n) rows of
// mma_ld(hd) elements, k and v in pad16(n) rows of mma_ld(ehd), P and dS in
// pad16(hd) rows of mma_ld(ehd), and a stage of 16 output rows.
static size_t mma_smem(int n, int hd, int ehd) {
  const int np = mma_pad16(n), ldq = mma_ld(hd), ldk = mma_ld(ehd);
  return ((size_t)2 * np * (ldq + ldk) + (size_t)2 * mma_pad16(hd) * ldk +
          (size_t)16 * max(ldq, ldk)) *
         sizeof(bf16);
}

// The C fragments o[j] (columns 8j..8j+7) of 16 output rows m0.., columns
// [0, cols), written to `out` (rows `ldg` apart, rows m0 .. n - 1) through
// `stage` (16 rows of `ld`) in 16-byte stores, by the warp's 32 lanes.
template <int J>
__device__ __forceinline__ void store_rows(const float (&o)[J][4], bf16* stage, int ld,
                                           bf16* __restrict__ out, int ldg, int m0, int n,
                                           int cols, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (8 * j >= cols) break;
    *reinterpret_cast<uint32_t*>(stage + g * ld + 8 * j + 2 * t) = pack_bf16(o[j][0], o[j][1]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * ld + 8 * j + 2 * t) =
        pack_bf16(o[j][2], o[j][3]);
  }
  __syncwarp();
  for_chunks(lane, 32, min(16, n - m0), cols >> 3, [&](int r, int ch) {
    *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * ldg + (ch << 3)) =
        *reinterpret_cast<const uint4*>(stage + r * ld + (ch << 3));
  });
  __syncwarp();
}

// The tensor-core body: block b (one warp) takes window b / heads and head
// b mod heads; NT, DT and ET bound pad16(n) / 16, pad16(hd) / 16 and
// pad16(ehd) / 16.
template <int NT, int DT, int ET>
__global__ void __launch_bounds__(32)
    channel_attention_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                                     const bf16* __restrict__ dout, bf16* __restrict__ dq,
                                     bf16* __restrict__ dkv, int n, int c, int ec, int heads,
                                     float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int w = blockIdx.x / heads, h = blockIdx.x - w * heads;
  const int hd = c / heads, ehd = ec / heads, np = mma_pad16(n);
  const int ldq = mma_ld(hd), ldk = mma_ld(ehd), lds = max(ldq, ldk);
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + np * ldq;
  bf16* sk = sdo + np * ldq;
  bf16* sv = sk + np * ldk;
  bf16* sp = sv + np * ldk;                 // bf16(P), pad16(hd) rows d of ldk
  bf16* sds = sp + mma_pad16(hd) * ldk;     // bf16(dS), the same
  bf16* stage = sds + mma_pad16(hd) * ldk;  // 16 output rows of lds
  const size_t qo = (size_t)w * n * c + (size_t)h * hd;
  const bf16* kw = kv + (size_t)w * n * 2 * ec + (size_t)h * ehd;
  warp_stage(sq, q + qo, n, np, hd, c, ldq, lane);
  warp_stage(sk, kw, n, np, ehd, 2 * ec, ldk, lane);
  cp_async_commit();
  warp_stage(sdo, dout + qo, n, np, hd, c, ldq, lane);
  warp_stage(sv, kw + ec, n, np, ehd, 2 * ec, ldk, lane);
  cp_async_commit();

  const int nk = np >> 4, nd = mma_pad16(hd) >> 4, ne = mma_pad16(ehd) >> 4;
  for (int d0 = 0; d0 < hd; d0 += 16) {
    // S and dP rows d0 .. d0 + 15: A = q^T or dO^T (rows d, k = tokens),
    // transposed (tile_bt's addresses are those of A of m^T . b); B = k or
    // v (k = tokens, n = e), transposed
    float s[2 * ET][4], dp[2 * ET][4];
#pragma unroll
    for (int j = 0; j < 2 * ET; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    if (d0 == 0) {
      cp_async_wait<1>();
      __syncwarp();
    }
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
    if (d0 == 0) {
      cp_async_wait<0>();
      __syncwarp();
    }
#pragma unroll
    for (int kt = 0; kt < NT; ++kt) {
      if (kt >= nk) break;
      uint32_t fa[4];
      ldsm_x4<true>(fa, tile_bt(sdo, ldq, kt * 16, d0, lane));
#pragma unroll
      for (int et = 0; et < ET; ++et) {
        if (et >= ne) break;
        uint32_t fb[4];
        ldsm_x4<true>(fb, tile_b(sv, ldk, kt * 16, et * 16, lane));
        mma16816(dp[2 * et], fa, fb[0], fb[1]);
        mma16816(dp[2 * et + 1], fa, fb[2], fb[3]);
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
    mma_softmax<ET>(s, ne, inv0, inv1);
    // padded rows d >= hd get P = 0, so that they add nothing to dk or dv
    if (d0 + g >= hd) inv0 = 0.f;
    if (d0 + g + 8 >= hd) inv1 = 0.f;
    float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * ET; ++j) {
      if (j >= 2 * ne) break;
      s[j][0] *= inv0;
      s[j][1] *= inv0;
      s[j][2] *= inv1;
      s[j][3] *= inv1;
      dot0 = fmaf(dp[j][0], s[j][0], fmaf(dp[j][1], s[j][1], dot0));
      dot1 = fmaf(dp[j][2], s[j][2], fmaf(dp[j][3], s[j][3], dot1));
    }
    dot0 = quad_sum(dot0);
    dot1 = quad_sum(dot1);
    // bf16(P) and bf16(dS = P (dP - rowsum(dP P)) scale) at rows d0 + g, + 8
#pragma unroll
    for (int j = 0; j < 2 * ET; ++j) {
      if (j >= 2 * ne) break;
      const int o0 = (d0 + g) * ldk + 8 * j + 2 * t, o1 = o0 + 8 * ldk;
      *reinterpret_cast<uint32_t*>(sp + o0) = pack_bf16(s[j][0], s[j][1]);
      *reinterpret_cast<uint32_t*>(sp + o1) = pack_bf16(s[j][2], s[j][3]);
      *reinterpret_cast<uint32_t*>(sds + o0) =
          pack_bf16(s[j][0] * (dp[j][0] - dot0) * scale, s[j][1] * (dp[j][1] - dot0) * scale);
      *reinterpret_cast<uint32_t*>(sds + o1) =
          pack_bf16(s[j][2] * (dp[j][2] - dot1) * scale, s[j][3] * (dp[j][3] - dot1) * scale);
    }
  }
  __syncwarp();

  bf16* gq = dq + qo;
  bf16* gk = dkv + (size_t)w * n * 2 * ec + (size_t)h * ehd;
  for (int m0 = 0; m0 < n; m0 += 16) {
    {  // dq rows m0.. = k . dS^T: A = k (tokens, e), B = dS (n = d, k = e)
      float o[2 * DT][4];
#pragma unroll
      for (int j = 0; j < 2 * DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
      for (int kt = 0; kt < ET; ++kt) {
        if (kt >= ne) break;
        uint32_t fa[4];
        ldsm_x4<false>(fa, tile_a(sk, ldk, m0, kt * 16, lane));
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          if (dt >= nd) break;
          uint32_t fb[4];
          ldsm_x4<false>(fb, tile_bt(sds, ldk, dt * 16, kt * 16, lane));
          mma16816(o[2 * dt], fa, fb[0], fb[1]);
          mma16816(o[2 * dt + 1], fa, fb[2], fb[3]);
        }
      }
      store_rows(o, stage, lds, gq, c, m0, n, hd, lane);
    }
    // dk rows m0.. = q . dS and dv rows m0.. = dO . P: A = q or dO (tokens,
    // d), B = dS or P (k = d, n = e), transposed
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const bf16* sa = part ? sdo : sq;
      const bf16* sb = part ? sp : sds;
      float o[2 * ET][4];
#pragma unroll
      for (int j = 0; j < 2 * ET; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
      for (int kt = 0; kt < DT; ++kt) {
        if (kt >= nd) break;
        uint32_t fa[4];
        ldsm_x4<false>(fa, tile_a(sa, ldq, m0, kt * 16, lane));
#pragma unroll
        for (int et = 0; et < ET; ++et) {
          if (et >= ne) break;
          uint32_t fb[4];
          ldsm_x4<true>(fb, tile_b(sb, ldk, kt * 16, et * 16, lane));
          mma16816(o[2 * et], fa, fb[0], fb[1]);
          mma16816(o[2 * et + 1], fa, fb[2], fb[3]);
        }
      }
      store_rows(o, stage, lds, gk + part * ec, 2 * ec, m0, n, ehd, lane);
    }
  }
}

template <int NT, int DT, int ET>
static int launch_mma(const void* q, const void* kv, const void* dout, void* dq, void* dkv,
                      int bw, int n, int c, int ec, int heads, float scale,
                      cudaStream_t stream) {
  auto kernel = channel_attention_bwd_mma_kernel<NT, DT, ET>;
  const size_t smem = mma_smem(n, c / heads, ec / heads);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)bw * heads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 32, smem, stream>>>((const bf16*)q, (const bf16*)kv,
                                                 (const bf16*)dout, (bf16*)dq, (bf16*)dkv, n, c,
                                                 ec, heads, scale);
  return (int)cudaGetLastError();
}

// q, dout, dq: contiguous (bw, n, c); kv, dkv: contiguous (bw, n, 2 ec),
// k | v along the last dim. The tensor-core body takes q, kv, dout, dq and
// dkv 16-byte aligned. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int mde_channel_attention_bwd(const void* q, const void* kv, const void* dout,
                                         void* dq, void* dkv, int bw, int n, int c, int ec,
                                         int heads, float scale, int dtype, void* stream) {
  if (heads <= 0 || c % heads != 0 || ec % heads != 0 || n <= 0 || bw <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int hd = c / heads, ehd = ec / heads;
  if (dtype == MDE_F32)
    return launch_cuda_cores<float>(q, kv, dout, dq, dkv, bw, n, c, ec, heads, scale, s);
  if (dtype != MDE_BF16) return (int)cudaErrorInvalidValue;
  if (!channel_mma(n, hd, ehd, dtype))
    return launch_cuda_cores<bf16>(q, kv, dout, dq, dkv, bw, n, c, ec, heads, scale, s);
  if (((uintptr_t)q | (uintptr_t)kv | (uintptr_t)dout | (uintptr_t)dq | (uintptr_t)dkv) & 15)
    return (int)cudaErrorMisalignedAddress;
  if (n <= 64 && hd <= 16 && ehd <= 16)
    return launch_mma<4, 1, 1>(q, kv, dout, dq, dkv, bw, n, c, ec, heads, scale, s);
  return launch_mma<8, 8, 8>(q, kv, dout, dq, dkv, bw, n, c, ec, heads, scale, s);
}

// Bytes of shared memory one block of mde_channel_attention_bwd takes for
// this shape and dtype (MDE_F32 or MDE_BF16).
extern "C" int mde_channel_attention_bwd_smem(int n, int c, int ec, int heads, int dtype) {
  if (heads <= 0 || n <= 0) return 0;
  const int hd = c / heads, ehd = ec / heads;
  if (channel_mma(n, hd, ehd, dtype)) return (int)mma_smem(n, hd, ehd);
  return (int)cuda_core_smem(n, hd, ehd);
}
