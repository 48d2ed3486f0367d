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
// side) may differ.
//
// What bounds it on an H100: at the KSA stage-0 serving shape (4096 windows
// of 49 tokens, C = EC = 64, 4 heads, hd = ehd = 16, bf16) it reads q, k, v
// and writes out once, 4 * 4096*49*64 * 2 B = 103 MB, 31 us at 3.35 TB/s,
// against 4 * 4096*49*16*16*4 = 0.8 GFLOP (under 1 us on the tensor cores):
// it is bound by bytes.
//
// Design: the work of one (window, head) pair is tiny (a 16 x 16 score tile
// contracted over 49 tokens, ~50 KFLOP), so a block takes several pairs,
// PAIRS_SMEM_FLOATS of shared memory's worth, and stages their q, k and v
// as f32; the scores, the row softmax (one thread per row) and P.v stay in
// shared memory. P's rows are padded to ehd + 1 floats so that threads
// reading one column of P for consecutive d hit different banks. k and v
// are strided views of the fused kv projection (row stride ldkv), so the
// caller makes no copies. Products run on the CUDA cores in f32.

#include "common.cuh"

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

template <typename T>
static int launch(const void* q, const void* kv, void* out, int bw, int n, int c, int ec,
                  int heads, float scale, cudaStream_t stream) {
  const int hd = c / heads, ehd = ec / heads;
  const size_t per = channel_pair_smem_floats(n, hd, ehd);
  const int ppb = (int)max((size_t)1, PAIRS_SMEM_FLOATS / per);
  const size_t smem = per * ppb * sizeof(float);
  cudaError_t err = allow_smem(channel_attention_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int pairs = bw * heads;
  channel_attention_kernel<T><<<(pairs + ppb - 1) / ppb, 128, smem, stream>>>(
      (const T*)q, (const T*)kv, (T*)out, pairs, heads, n, hd, ehd, c, 2 * ec, scale, ppb);
  return (int)cudaGetLastError();
}

// q: contiguous (bw, n, c); kv: contiguous (bw, n, 2 ec), k | v along the
// last dim; out: contiguous (bw, n, c). Returns the CUDA error code of the
// launch (0 on success).
extern "C" int mde_channel_attention(const void* q, const void* kv, void* out, int bw, int n,
                                     int c, int ec, int heads, float scale, int dtype,
                                     void* stream) {
  if (heads <= 0 || c % heads != 0 || ec % heads != 0 || n <= 0 || bw <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MDE_F32) return launch<float>(q, kv, out, bw, n, c, ec, heads, scale, s);
  if (dtype == MDE_BF16) return launch<__nv_bfloat16>(q, kv, out, bw, n, c, ec, heads, scale, s);
  return (int)cudaErrorInvalidValue;
}
