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
// Design: as the forward, a block takes several (window, head) pairs with
// q, dO, k and v staged in shared memory as f32 and P, dS kept there (rows
// padded to ehd + 1). No gradient is summed across windows, so there are no
// atomics and every bit is the same from run to run.

#include "common.cuh"

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

template <typename T>
static int launch(const void* q, const void* kv, const void* dout, void* dq, void* dkv, int bw,
                  int n, int c, int ec, int heads, float scale, cudaStream_t stream) {
  const int hd = c / heads, ehd = ec / heads;
  const size_t per = channel_pair_bwd_smem_floats(n, hd, ehd);
  const int ppb = (int)max((size_t)1, PAIRS_SMEM_FLOATS / per);
  const size_t smem = per * ppb * sizeof(float);
  cudaError_t err = allow_smem(channel_attention_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int pairs = bw * heads;
  channel_attention_bwd_kernel<T><<<(pairs + ppb - 1) / ppb, 128, smem, stream>>>(
      (const T*)q, (const T*)kv, (const T*)dout, (T*)dq, (T*)dkv, pairs, heads, n, hd, ehd,
      scale, ppb);
  return (int)cudaGetLastError();
}

// q, dout, dq: contiguous (bw, n, c); kv, dkv: contiguous (bw, n, 2 ec),
// k | v along the last dim. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int mde_channel_attention_bwd(const void* q, const void* kv, const void* dout,
                                         void* dq, void* dkv, int bw, int n, int c, int ec,
                                         int heads, float scale, int dtype, void* stream) {
  if (heads <= 0 || c % heads != 0 || ec % heads != 0 || n <= 0 || bw <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MDE_F32)
    return launch<float>(q, kv, dout, dq, dkv, bw, n, c, ec, heads, scale, s);
  if (dtype == MDE_BF16)
    return launch<__nv_bfloat16>(q, kv, dout, dq, dkv, bw, n, c, ec, heads, scale, s);
  return (int)cudaErrorInvalidValue;
}
