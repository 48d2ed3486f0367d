// K1 backward: gradients of window multi-head attention (W-MSA / SW-MSA).
//
// Replaces the TPU kernel _pallas_window_attention_bwd
// (mde_tpu/ops/pallas/window_attention.py:235, body _bwd_kernel :180).
// Per window and head it recomputes P = softmax(qs . k^T + bias[h] +
// mask[w mod nW]) from the saved q, k, v (qs = q*scale in the input dtype,
// :203), forms dS = P * (dP - rowsum(dP * P)) with dP = dO . v^T, and writes
//   dq = dS . k * scale, dk = dS^T . qs, dv = P^T . dO
// (P and dS rounded to the input dtype first, dq scaled in f32) into one
// fused (B*nW, N, 3C) gradient laid out like the qkv projection, plus
// dbias[h] = sum over windows of the unrounded f32 dS.
//
// What bounds it on an H100: at the train path's stage-1 shape (2048
// windows of 49 tokens, 128 channels, 4 heads, head dim 32, batch 4, bf16)
// it reads q, k, v, dO and writes dq, dk, dv once, 7 * 2048*49*128 * 2 B =
// 180 MB, 54 us at 3.35 TB/s, against 10 * 2048*49^2*128 = 6.3 GFLOP (6 us on
// the bf16 tensor cores): it is bound by bytes.
//
// Why the first design ran at 21x that bound: it staged everything as f32
// in shared memory and took its five products as f32 FMAs on the CUDA
// cores, with f32 P and dS of (n, n) in shared memory (54 KB a block), and
// read the bias and mask element by element from global memory.
//
// Design (bf16): K2's backward bodies (attention_mma.cuh): per window, each
// warp recomputes S and P for its 16 query rows and dP = dO . v^T in
// registers on mma.sync.m16n8k16, forms dS there, hands the f32 dS to the
// dbias sink and writes dq from bf16 dS fragments; bf16 P and dS go to
// shared memory once (unpadded rows, swizzled), and after a barrier each
// warp takes 16 keys for dk = dS^T . qs and dv = P^T . dO while the next
// window's k and v are copied in; the softmax's exp is __expf's
// ex2.approx, as in the forward. One block of 4 warps walks a run of
// windows of one head, a mask slot's windows across the images in turn (as
// the forward), so bias + mask is summed into a FragBias tile once a slot.
//
// The dbias sink: every warp owns the same 16-row tiles in every window,
// and each lane the same (row, col) set of their C fragments, so a lane
// adds its f32 dS to a (pad16(n), pad16(n)) f32 partial in shared memory
// kept in fragment order (DBiasSink), as float4s that no other thread
// touches: no shared atomics (which are compare-and-swap loops on this
// card) and no barrier. After its last window the block adds its n x n
// partial to the f32 gradient with one global atomicAdd per entry: at
// stage 1, batch 4, the grid's (2048 / wpb) x 4 blocks make 2401 each,
// 0.94 M in all at 3 blocks an SM (392 blocks of up to 21 windows); their
// order, and so the last bits of dbias, changes from run to run. On a
// grid that made 2.8 M of them, skipping them saved under 2% of the
// kernel's time (PERF.md).
//
// Shapes: as the forward (mma_shape): bf16 at n <= 128 and head dims that
// are multiples of 8 up to 128 on the tensor cores; f32, and bf16 beyond
// those shapes, on the CUDA-core body window_head_attention_bwd
// (common.cuh). Window-pair packing and _pick_tb are TPU tricks with no
// counterpart.

#include "attention_mma.cuh"

// f32, and bf16 outside mma_shape: one block of 256 threads per (run of
// windows, head), everything staged as f32, dbias summed per block in
// shared memory (each entry owned by one thread).
template <typename T>
__global__ void window_attention_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                                            const float* __restrict__ bias,
                                            const float* __restrict__ mask,
                                            T* __restrict__ dqkv, float* __restrict__ dbias,
                                            int bw, int n, int c, int hd, int nw, int wpb,
                                            float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.y;
  float* acc = smem + window_head_bwd_smem_floats(n, hd);  // (n, n) dbias partial
  if (dbias)
    for (int i = threadIdx.x; i < n * n; i += blockDim.x) acc[i] = 0.f;
  const float* bh = bias ? bias + (size_t)h * n * n : nullptr;
  const int w0 = (int)blockIdx.x * wpb;
  const int w_end = min(bw, w0 + wpb);
  for (int w = w0; w < w_end; ++w) {
    const float* mw = mask ? mask + (size_t)(w % nw) * n * n : nullptr;
    auto add = [=](int r, int col) {
      float b = 0.f;
      if (bh) b += bh[r * n + col];
      if (mw) b += mw[r * n + col];
      return b;
    };
    auto sink = [=](int r, int col, float ds) {
      if (dbias) acc[r * n + col] += ds;
    };
    const size_t in_off = (size_t)w * n * 3 * c + (size_t)h * hd;
    const size_t out_off = (size_t)w * n * c + (size_t)h * hd;
    // the body's first __syncthreads also orders the zeroing of acc above
    window_head_attention_bwd<T>(qkv + in_off, qkv + in_off + c, qkv + in_off + 2 * c,
                                 dout + out_off, dqkv + in_off, dqkv + in_off + c,
                                 dqkv + in_off + 2 * c, n, hd, 3 * c, c, 3 * c, scale, smem,
                                 add, sink);
    __syncthreads();
  }
  if (dbias)
    for (int i = threadIdx.x; i < n * n; i += blockDim.x)
      atomicAdd(dbias + (size_t)h * n * n + i, acc[i]);
}

// Adds one warp's f32 dS of a 16-row tile to the block's dbias partial, a
// (pad16(n), pad16(n)) f32 tile in FragBias order: each lane adds its C
// fragments to the float4s that only it reads and writes, in every window.
struct DBiasSink {
  float4* acc;  // null without a bias
  int tiles;    // pad16(n) / 8

  template <int NT> __device__ __forceinline__ void tile(int r0, const float (&ds)[2 * NT][4]) {
    if (!acc) return;
    float4* p = acc + (r0 >> 4) * tiles * 32 + (threadIdx.x & 31);
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      if (j >= tiles) break;
      float4 a = p[j * 32];
      a.x += ds[j][0];
      a.y += ds[j][1];
      a.z += ds[j][2];
      a.w += ds[j][3];
      p[j * 32] = a;
    }
  }
};

// Resident blocks an SM the bf16 kernel is compiled for: 3 at the main
// path's n <= 64, hd <= 32 (68 KB of shared memory with the bias).
constexpr int bwd_min_blocks(int nt, int dt) { return nt <= 4 && dt <= 2 ? 3 : 1; }

// bf16 on the tensor cores: one block of MMA_THREADS per (run of wpb
// windows, head), head-fastest, windows in the forward's order (slots = nW
// with a mask, 1 without). NT and DT bound pad16(n) / 16 and pad16(hd) / 16.
template <int NT, int DT>
__global__ void __launch_bounds__(MMA_THREADS, bwd_min_blocks(NT, DT))
    window_attention_bwd_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                                    const float* __restrict__ bias,
                                    const float* __restrict__ mask, bf16* __restrict__ dqkv,
                                    float* __restrict__ dbias, int bw, int n, int c, int heads,
                                    int slots, int wpb, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x % heads;
  const int u0 = (blockIdx.x / heads) * wpb, u1 = min(bw, u0 + wpb);
  const int hd = c / heads, np = mma_pad16(n), ld = mma_ld(hd), ldg = 3 * c;
  const int images = bw / slots;
  float* sb = reinterpret_cast<float*>(smem_raw);  // bias + mask, FragBias order
  float* sdb = sb + np * np;                         // dbias partial, the same order
  bf16* sq = reinterpret_cast<bf16*>(sdb + (dbias ? np * np : 0));  // qs, rounded to bf16
  bf16* sk = sq + np * ld;
  bf16* sv = sk + np * ld;
  bf16* sdo = sv + np * ld;
  bf16* sp = sdo + np * ld;  // bf16(P), (np, np) laid out by swz
  bf16* sds = sp + np * np;   // bf16(dS)
  if (dbias)  // ordered before the sink's first use by the first window's barrier
    for (int i = threadIdx.x; i < np * np; i += blockDim.x) sdb[i] = 0.f;
  const float* bh = bias ? bias + (size_t)h * n * n : nullptr;
  const float scale_t = __bfloat162float(__float2bfloat16(scale));
  DBiasSink sink{dbias ? reinterpret_cast<float4*>(sdb) : nullptr, np >> 3};
  int slot = -1;
  for (int u = u0; u < u1; ++u) {
    const int s = u / images, w = s + (u - s * images) * slots;
    const size_t base = (size_t)w * n * ldg + (size_t)h * hd;
    const size_t obase = (size_t)w * n * c + (size_t)h * hd;
    if (u == u0) {  // later windows' k and v were copied during the last one
      mma_stage(sk, qkv + base + c, n, np, hd, ldg, ld);
      mma_stage(sv, qkv + base + 2 * c, n, np, hd, ldg, ld);
    }
    mma_stage(sq, qkv + base, n, np, hd, ldg, ld);
    mma_stage(sdo, dout + obase, n, np, hd, c, ld);
    cp_async_commit();
    if (s != slot) {  // the last window's readers of sb passed its middle barrier
      slot = s;
      mma_bias_tile(sb, bh, mask ? mask + (size_t)s * n * n : nullptr, n);
    }
    cp_async_wait<0>();
    mma_scale_staged(sq, np, hd, ld, scale_t);
    __syncthreads();
    mma_bwd_rows<NT, DT, true>(sq, sk, sv, sdo, ld, sp, sds, dqkv + base, ldg, n, hd, scale,
                               FragBias{reinterpret_cast<const float4*>(sb)}, sink);
    __syncthreads();
    if (u + 1 < u1) {
      const int s1 = (u + 1) / images, w1 = s1 + (u + 1 - s1 * images) * slots;
      const size_t next = (size_t)w1 * n * ldg + (size_t)h * hd;
      mma_stage(sk, qkv + next + c, n, np, hd, ldg, ld);
      mma_stage(sv, qkv + next + 2 * c, n, np, hd, ldg, ld);
      cp_async_commit();
    }
    mma_bwd_keys<NT, DT>(sq, sdo, ld, sp, sds, dqkv + base + c, dqkv + base + 2 * c, ldg, n,
                         hd);
    __syncthreads();
  }
  if (dbias)
    for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
      const int row = i / n, col = i - row * n;
      atomicAdd(dbias + (size_t)h * n * n + i, sdb[frag_offset(row, col, np >> 3)]);
    }
}

// Shared memory of the bf16 tensor-core kernel: the FragBias tile, with a
// bias the dbias partial, qs, k, v and dO in pad16(n) rows of mma_ld(hd)
// elements, and bf16 P and dS as (pad16(n), pad16(n)).
static size_t mma_bwd_smem(int n, int hd, bool with_dbias) {
  const size_t np = mma_pad16(n);
  return (with_dbias ? 2 : 1) * np * np * sizeof(float) +
         (4 * np * mma_ld(hd) + 2 * np * np) * sizeof(bf16);
}

// Shared memory of the CUDA-core kernel: window_head_attention_bwd's, and
// with a bias the (n, n) dbias partial.
static size_t cuda_cores_bwd_smem(int n, int hd, bool with_dbias) {
  return (window_head_bwd_smem_floats(n, hd) + (with_dbias ? (size_t)n * n : 0)) *
         sizeof(float);
}

template <int NT, int DT>
static int launch_mma(const void* qkv, const void* dout, const float* bias, const float* mask,
                      void* dqkv, float* dbias, int bw, int n, int c, int heads, int nw,
                      float scale, cudaStream_t stream) {
  auto kernel = window_attention_bwd_mma_kernel<NT, DT>;
  const size_t smem = mma_bwd_smem(n, c / heads, dbias != nullptr);
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess)  // room for bwd_min_blocks blocks an SM
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  // runs of about 16 windows, so that dbias meets device memory once a run
  const int wpb = balanced_windows_per_block(kernel, smem, bw, heads, 16);
  if (wpb <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((bw + wpb - 1) / wpb) * heads;
  kernel<<<blocks, MMA_THREADS, smem, stream>>>((const bf16*)qkv, (const bf16*)dout, bias,
                                                mask, (bf16*)dqkv, dbias, bw, n, c, heads,
                                                mask ? nw : 1, wpb, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_cuda_cores(const void* qkv, const void* dout, const float* bias,
                             const float* mask, void* dqkv, float* dbias, int bw, int n, int c,
                             int heads, int nw, float scale, cudaStream_t stream) {
  const int hd = c / heads;
  const size_t smem = cuda_cores_bwd_smem(n, hd, dbias != nullptr);
  cudaError_t err = allow_smem(window_attention_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int wpb = windows_per_block(bw, heads);
  dim3 grid((bw + wpb - 1) / wpb, heads);
  window_attention_bwd_kernel<T><<<grid, 256, smem, stream>>>(
      (const T*)qkv, (const T*)dout, bias, mask, (T*)dqkv, dbias, bw, n, c, hd, nw, wpb, scale);
  return (int)cudaGetLastError();
}

// qkv, dqkv: contiguous (bw, n, 3c), q | k | v along the last dim; dout:
// contiguous (bw, n, c); bias: (heads, n, n) f32 or null; mask: (nw, n, n)
// f32 or null, nw dividing bw; dbias: (heads, n, n) f32, zeroed by the
// caller, or null (only with bias). bf16 at mma_shape: 16-byte aligned.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int mde_window_attention_bwd(const void* qkv, const void* dout, const float* bias,
                                        const float* mask, void* dqkv, float* dbias, int bw,
                                        int n, int c, int heads, int nw, float scale, int dtype,
                                        void* stream) {
  if (heads <= 0 || c % heads != 0 || n <= 0 || bw <= 0 || (mask && (nw <= 0 || bw % nw)) ||
      (dbias && !bias))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int hd = c / heads;
  if (dtype == MDE_F32)
    return launch_cuda_cores<float>(qkv, dout, bias, mask, dqkv, dbias, bw, n, c, heads, nw,
                                    scale, s);
  if (dtype != MDE_BF16) return (int)cudaErrorInvalidValue;
  if (!mma_shape(n, hd))
    return launch_cuda_cores<bf16>(qkv, dout, bias, mask, dqkv, dbias, bw, n, c, heads, nw,
                                   scale, s);
  // the tensor-core bodies copy 16-byte pieces
  if (((uintptr_t)qkv | (uintptr_t)dout | (uintptr_t)dqkv) & 15)
    return (int)cudaErrorMisalignedAddress;
  if (n <= 64 && hd <= 32)
    return launch_mma<4, 2>(qkv, dout, bias, mask, dqkv, dbias, bw, n, c, heads, nw, scale, s);
  return launch_mma<8, 8>(qkv, dout, bias, mask, dqkv, dbias, bw, n, c, heads, nw, scale, s);
}

// Bytes of shared memory one block of mde_window_attention_bwd takes for
// this shape and dtype (MDE_F32 or MDE_BF16), with or without a bias.
extern "C" int mde_window_attention_bwd_smem(int n, int c, int heads, int has_bias,
                                             int dtype) {
  if (heads <= 0) return 0;
  const int hd = c / heads;
  if (dtype == MDE_BF16 && mma_shape(n, hd)) return (int)mma_bwd_smem(n, hd, has_bias);
  return (int)cuda_cores_bwd_smem(n, hd, has_bias);
}
