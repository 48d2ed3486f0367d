// The optimizer's step as one multi-tensor pass pair: optax's
// clip_by_global_norm + adamw over every parameter of a model, with the
// gradient norm the clip needs and the logged gradient and parameter norms
// taken in the same passes.
//
// Replaces no Pallas kernel: the JAX package's optimizer is optax's
// clip_by_global_norm + adamw (mde_tpu/train/optim.py), elementwise code that
// XLA fuses. The port's plain version (AdamW._plain_update in
// mde_tpu_torch/train/optim.py) runs it as ~17 foreach passes, a norm
// launch per tensor three times over and a read-back of the norm to decide
// the clip, which made the card wait on the host for the whole phase.
//
// What bounds it on an H100: the arithmetic is a few dozen operations an
// element, far below the ridge, so bytes set the time. The least a step can
// move in f32 is 32 bytes a parameter: g read once for the norm, then g, p,
// mu, nu read and p, mu, nu written (28 with bf16 moments); the plain
// version moves ~144. At 3.35 TB/s that is 1.30 ms for the flagship's
// 135.65 M parameters and 2.20 ms for oda_conv's 230.47 M.
//
// What the design does about it:
//  - Launch 1 (norm): one pass over the gradients of every tensor, the
//    BatchNorm ones under zero_grad_bn included, writing per-block partial
//    sums of squares in f64: the updated tensors' (the clip's norm), the
//    others' (the logged norm adds them), and the others' parameters (they
//    do not change, so the parameter norm takes them here).
//  - Launch 2 (update): every block first sums the updated tensors'
//    partials in a fixed order (so all blocks decide the clip alike, and
//    two runs give the same bits: no float atomics anywhere), then streams
//    its range of g, p, mu, nu once, in 16-byte vectors where the four
//    pointers allow, and writes p, mu, nu, adding the new p's squares to
//    its partial of the parameter norm while p is in registers.
//  - Launch 3 (finish): one block sums the partials into the two logged
//    norms. Nothing is read back: the clip is decided on the card.
//  - The tensors are one concatenation, each padded to 4 elements, cut into
//    one contiguous range a block (4 blocks an SM, all resident at once):
//    every block moves the same bytes, and a block's first tensor is found
//    by a binary search of the offsets.
//  - The table (the pointers of g, p, mu, nu, the offsets, the sizes, the
//    encoder's flags) travels by value in the kernel's parameters, ~30 KB
//    for MAX_TENSORS tensors (__grid_constant__: read in place, never
//    copied to a thread's stack), so nothing is copied from the host and
//    the card holds nothing between steps. The host packs the parameters' part
//    once and writes the gradients' pointers, new tensors every step, into
//    it before the launches; past MAX_TENSORS the tensors go in windows,
//    two launches a window.
//
// The element step is the plain version's, in its order and in f32: the
// clip g = (g / n) * max_norm where !(n < max_norm) (a NaN norm clips), mu =
// b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2, u = (mu / (1 - b1^t)) /
// (sqrt(nu / (1 - b2^t)) + eps) by true divisions, u += weight_decay p,
// u *= -lr, u *= encoder_scale for the encoder's tensors, p += u; mu is
// rounded to its dtype after u is formed from the f32 value. The host's
// scalars come as f32 arguments, as PyTorch's foreach ops take them.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// tensors a launch carries in its parameters (at most 32,764 bytes on sm_70
// and later with CUDA 12.1 or later)
constexpr int MAX_TENSORS = 640;

// One window's tensors; those from n_update on get no update (mu and nu
// null). The host's copy is int64 throughout (mde_tpu_torch/ops/kernels/
// adamw.py packs it): the five pointer and size arrays, then the offsets
// (n + 1: each tensor's start in the padded concatenation, a multiple of 4,
// and the end), then a flag a tensor (1: the encoder's).
struct Table {
  const float* g[MAX_TENSORS];
  float* p[MAX_TENSORS];
  void* mu[MAX_TENSORS];
  float* nu[MAX_TENSORS];
  long long numel[MAX_TENSORS];
  long long offset[MAX_TENSORS + 1];
  unsigned encoder[MAX_TENSORS / 32];
};

struct Hyper {
  float b1, omb1, b2, omb2, bc1, bc2, eps, wd, neg_lr, enc_scale, max_norm;
};

// The partials: four rows of `stride` doubles (a window's blocks at
// window * blocks + block).
enum Row { G_UPD = 0, G_REST = 1, P_REST = 2, P_UPD = 3 };

// The sum of each of N values over the block, in a fixed order, returned
// to every thread.
template <int N>
__device__ __forceinline__ void block_sum(double (&v)[N]) {
  __shared__ double red[WARPS][N];
  __syncthreads();  // a previous call's readers are done
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    double x = v[k];
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) red[warp][k] = x;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    double s = 0.0;
    for (int w = 0; w < WARPS; ++w) s += red[w][k];
    v[k] = s;
  }
}

// The block's share [*lo, *hi) of the flat range [lo, hi): equal lengths, a
// multiple of 4 elements each.
__device__ __forceinline__ void block_range(long long lo, long long hi, long long* blo,
                                            long long* bhi) {
  const long long per = ((hi - lo + gridDim.x - 1) / gridDim.x + 3) & ~3LL;
  *blo = min(hi, lo + per * blockIdx.x);
  *bhi = min(hi, *blo + per);
}

// The last tensor of [0, n) whose offset is at most x.
__device__ __forceinline__ int first_tensor(const Table& tab, int n, long long x) {
  int a = 0, b = n - 1;
  while (a < b) {
    const int m = (a + b + 1) >> 1;
    if (tab.offset[m] <= x) a = m; else b = m - 1;
  }
  return a;
}

__device__ __forceinline__ void load4(const float* a, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(a);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* a, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(a);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  x[0] = __low2float(lo); x[1] = __high2float(lo); x[2] = __low2float(hi); x[3] = __high2float(hi);
}

__device__ __forceinline__ void store4(float* a, const float (&x)[4]) {
  *reinterpret_cast<float4*>(a) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* a, const float (&x)[4]) {
  __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16(x[0]), __float2bfloat16(x[1]));
  __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16(x[2]), __float2bfloat16(x[3]));
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(a) = v;
}

__device__ __forceinline__ bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Launch 1: sums of squares over the window's tensors; those from n_update
// on get no update.
__global__ void __launch_bounds__(THREADS, 4)
adamw_norm_kernel(const __grid_constant__ Table tab, int n, int n_update,
                  double* __restrict__ partials, int slot, int stride) {
  long long blo, bhi;
  block_range(tab.offset[0], tab.offset[n], &blo, &bhi);
  double acc[3] = {0.0, 0.0, 0.0};  // g of updated tensors, g of the rest, p of the rest
  if (blo < bhi) {
    for (int t = first_tensor(tab, n, blo); t < n && tab.offset[t] < bhi; ++t) {
      const long long off = tab.offset[t];
      const long long i0 = max(blo, off) - off;
      const long long i1 = min(bhi, off + tab.numel[t]) - off;
      if (i0 >= i1) continue;
      const float* g = tab.g[t];
      const float* p = tab.p[t];
      const bool rest = t >= n_update;
      double sg = 0.0, sp = 0.0;
      long long tail = i0;
      if (aligned(g, 16) && (!rest || aligned(p, 16))) {
        const long long q1 = i1 >> 2;
        long long q = (i0 >> 2) + threadIdx.x;
        // four 16-byte loads in flight a thread
        for (; q + 3 * THREADS < q1; q += 4 * THREADS) {
          float x[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u) load4(g + 4 * (q + u * THREADS), x[u]);
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int k = 0; k < 4; ++k) sg += (double)x[u][k] * x[u][k];
        }
        for (; q < q1; q += THREADS) {
          float x[4];
          load4(g + 4 * q, x);
#pragma unroll
          for (int k = 0; k < 4; ++k) sg += (double)x[k] * x[k];
        }
        if (rest) {
          for (q = (i0 >> 2) + threadIdx.x; q < q1; q += THREADS) {
            float x[4];
            load4(p + 4 * q, x);
#pragma unroll
            for (int k = 0; k < 4; ++k) sp += (double)x[k] * x[k];
          }
        }
        tail = q1 << 2;
      }
      for (long long i = tail + threadIdx.x; i < i1; i += THREADS) {
        const double x = g[i];
        sg += x * x;
        if (rest) {
          const double y = p[i];
          sp += y * y;
        }
      }
      if (rest) {
        acc[1] += sg;
        acc[2] += sp;
      } else {
        acc[0] += sg;
      }
    }
  }
  block_sum(acc);
  if (threadIdx.x == 0) {
    const int at = slot + blockIdx.x;
    partials[G_UPD * stride + at] = acc[0];
    partials[G_REST * stride + at] = acc[1];
    partials[P_REST * stride + at] = acc[2];
  }
}

// One element's step; returns p's new value.
struct Step {
  Hyper h;
  float norm;
  bool clip, encoder;

  __device__ __forceinline__ float operator()(float g, float p, float& m, float& v) const {
    if (clip) g = (g / norm) * h.max_norm;
    m = m * h.b1 + h.omb1 * g;
    v = v * h.b2 + h.omb2 * g * g;
    float u = (m / h.bc1) / (sqrtf(v / h.bc2) + h.eps);
    if (h.wd != 0.f) u = u + h.wd * p;
    u = u * h.neg_lr;
    if (encoder) u = u * h.enc_scale;
    return p + u;
  }
};

// Launch 2: the update of the window's first n_update tensors, after the
// clip's norm from every window's partials.
template <typename MuT>
__global__ void __launch_bounds__(THREADS, 4)
adamw_update_kernel(const __grid_constant__ Table tab, int n_update,
                    double* __restrict__ partials, int slot, int stride, const Hyper h) {
  double total[1] = {0.0};
  for (int i = threadIdx.x; i < stride; i += THREADS) total[0] += partials[G_UPD * stride + i];
  block_sum(total);
  Step step;
  step.h = h;
  step.norm = (float)sqrt(total[0]);
  step.clip = h.max_norm > 0.f && !(step.norm < h.max_norm);

  long long blo, bhi;
  block_range(tab.offset[0], tab.offset[n_update], &blo, &bhi);
  double acc[1] = {0.0};
  if (blo < bhi) {
    for (int t = first_tensor(tab, n_update, blo); t < n_update && tab.offset[t] < bhi; ++t) {
      const long long off = tab.offset[t];
      const long long i0 = max(blo, off) - off;
      const long long i1 = min(bhi, off + tab.numel[t]) - off;
      if (i0 >= i1) continue;
      const float* g = tab.g[t];
      float* p = tab.p[t];
      MuT* mu = static_cast<MuT*>(tab.mu[t]);
      float* nu = tab.nu[t];
      step.encoder = (tab.encoder[t >> 5] >> (t & 31)) & 1u;
      double sp = 0.0;
      long long tail = i0;
      if (aligned(g, 16) && aligned(p, 16) && aligned(nu, 16) && aligned(mu, 4 * sizeof(MuT))) {
        const long long q1 = i1 >> 2;
        for (long long q = (i0 >> 2) + threadIdx.x; q < q1; q += THREADS) {
          float xg[4], xp[4], xm[4], xv[4];
          load4(g + 4 * q, xg);
          load4(p + 4 * q, xp);
          load4(mu + 4 * q, xm);
          load4(nu + 4 * q, xv);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            xp[k] = step(xg[k], xp[k], xm[k], xv[k]);
            sp += (double)xp[k] * xp[k];
          }
          store4(p + 4 * q, xp);
          store4(mu + 4 * q, xm);
          store4(nu + 4 * q, xv);
        }
        tail = q1 << 2;
      }
      for (long long i = tail + threadIdx.x; i < i1; i += THREADS) {
        float m = to_float(mu[i]), v = nu[i];
        const float np = step(g[i], p[i], m, v);
        p[i] = np;
        mu[i] = from_float<MuT>(m);
        nu[i] = v;
        sp += (double)np * np;
      }
      acc[0] += sp;
    }
  }
  block_sum(acc);
  if (threadIdx.x == 0) partials[P_UPD * stride + slot + blockIdx.x] = acc[0];
}

// Launch 3: out[0] the gradient norm (every tensor), out[1] the parameter
// norm (after the update), each summed in a fixed order.
__global__ void __launch_bounds__(THREADS)
adamw_finish_kernel(const double* __restrict__ partials, int stride, float* __restrict__ out) {
  double s[2] = {0.0, 0.0};
  for (int i = threadIdx.x; i < stride; i += THREADS) {
    s[0] += partials[G_UPD * stride + i] + partials[G_REST * stride + i];
    s[1] += partials[P_UPD * stride + i] + partials[P_REST * stride + i];
  }
  block_sum(s);
  if (threadIdx.x == 0) {
    out[0] = (float)sqrt(s[0]);
    out[1] = (float)sqrt(s[1]);
  }
}

// The host's int64 table of n tensors (g, p, mu, nu, numel: n each; offset:
// n + 1; encoder flags: n) as the launch's Table; false where it does not
// fit or its offsets are not whole vectors in order.
bool unpack(const long long* host, int n, Table* tab) {
  if (n <= 0 || n > MAX_TENSORS) return false;
  const long long* off = host + 5 * n;
  for (int t = 0; t < n; ++t) {
    tab->g[t] = reinterpret_cast<const float*>(host[t]);
    tab->p[t] = reinterpret_cast<float*>(host[n + t]);
    tab->mu[t] = reinterpret_cast<void*>(host[2 * n + t]);
    tab->nu[t] = reinterpret_cast<float*>(host[3 * n + t]);
    tab->numel[t] = host[4 * n + t];
    if (tab->numel[t] < 0 || off[t] % 4 || off[t + 1] < off[t] + tab->numel[t]) return false;
  }
  for (int t = 0; t <= n; ++t) tab->offset[t] = off[t];
  for (int w = 0; w < MAX_TENSORS / 32; ++w) tab->encoder[w] = 0u;
  for (int t = 0; t < n; ++t)
    if (host[6 * n + 1 + t]) tab->encoder[t >> 5] |= 1u << (t & 31);
  return true;
}

bool partial_slots(int blocks, int slot, int stride) {
  return blocks > 0 && slot >= 0 && slot + blocks <= stride;
}

}  // namespace

// Launch 1 over a window of n tensors (table: the host's int64 table, its
// first n_update tensors updated), `blocks` blocks writing the partials'
// columns from `slot` on.
extern "C" int mde_adamw_norm(const long long* table, int n, int n_update, void* partials,
                              int blocks, int slot, int stride, void* stream) {
  Table tab;
  if (!unpack(table, n, &tab) || n_update < 0 || n_update > n ||
      !partial_slots(blocks, slot, stride))
    return (int)cudaErrorInvalidValue;
  adamw_norm_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      tab, n, n_update, static_cast<double*>(partials), slot, stride);
  return (int)cudaGetLastError();
}

// Launch 2 over the same window: its first n_update tensors' update;
// mu_dtype MDE_F32 or MDE_BF16.
extern "C" int mde_adamw_update(const long long* table, int n, int n_update, void* partials,
                                int blocks, int slot, int stride, float b1, float omb1, float b2,
                                float omb2, float bc1, float bc2, float eps, float wd,
                                float neg_lr, float enc_scale, float max_norm, int mu_dtype,
                                void* stream) {
  Table tab;
  if (!unpack(table, n, &tab) || n_update < 0 || n_update > n ||
      !partial_slots(blocks, slot, stride))
    return (int)cudaErrorInvalidValue;
  const Hyper h = {b1, omb1, b2, omb2, bc1, bc2, eps, wd, neg_lr, enc_scale, max_norm};
  double* part = static_cast<double*>(partials);
  cudaStream_t s = (cudaStream_t)stream;
  if (mu_dtype == MDE_F32)
    adamw_update_kernel<float><<<blocks, THREADS, 0, s>>>(tab, n_update, part, slot, stride, h);
  else if (mu_dtype == MDE_BF16)
    adamw_update_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(tab, n_update, part, slot,
                                                                  stride, h);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Launch 3: the two norms into out (2 floats).
extern "C" int mde_adamw_finish(const void* partials, int stride, void* out, void* stream) {
  if (stride <= 0) return (int)cudaErrorInvalidValue;
  adamw_finish_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const double*>(partials), stride, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
