// K1: window multi-head attention (Swin W-MSA / SW-MSA), forward.
//
// Replaces the TPU kernel _pallas_window_attention
// (mde_tpu/ops/pallas/window_attention.py:139, body _kernel :101), reached
// through fused_window_attention (:352). Per window and head it computes
//   softmax(q*scale . k^T + bias[h] + mask[w mod nW]) . v
// with q scaled in the input dtype by the scale rounded to it, as the TPU
// kernel does (:122), f32 logits, bias, mask and softmax, and P rounded to
// the input dtype before P.v.
//
// What bounds it on an H100: at the main-path shapes (stage 1: 4096 windows
// of 49 tokens, 128 channels, 4 heads, head dim 32, batch 8, bf16) it reads
// q, k, v and writes out once, 205 MB, 61 us at 3.35 TB/s, against 5 GFLOP
// (5 us on the bf16 tensor cores): it is bound by bytes.
//
// Why the first design ran at 16x that bound: one block per (window, head)
// staged q, k, v as f32 in shared memory, kept the 49 x 49 scores there and
// took every product as f32 FMAs on the CUDA cores, two shared-memory
// operands each; and every block read the head's (49, 49) bias and its
// window's (49, 49) mask element by element from global memory, 19.2 KB a
// block against its 9.4 KB of q, k and v.
//
// Design (bf16): the products go to the tensor cores (attention_mma.cuh:
// mma.sync.m16n8k16 with ldmatrix operands, S and P in registers, never in
// shared memory). One block of 4 warps walks a run of windows of one head;
// window w takes mask slot w mod nW, and the run visits the windows of one
// slot across the images (w, w + nW, ...) before the next slot, so bias +
// mask is the same for most of its windows. The block sums the two once
// per slot into a FragBias tile in shared memory (f32 in the order of the C
// fragments, 16 KB at n = 49), from which each lane reads its logits' bias
// as float4s. Per window, q, k and v come by 16-byte cp.async straight from
// the strided views of the fused (B*nW, N, 3C) projection (row stride 3C),
// q is scaled in bf16 in shared memory (mma_scale_staged) and the logits get
// scale 1; each warp takes 16 query rows, and the softmax's exp is
// __expf's ex2.approx (FAST_EXP). The runs are sized so that the grid fills
// whole waves of resident blocks (balanced_windows_per_block), which
// matters at stage 3 (256 windows x 16 heads at batch 8), where 18 of the
// flagship's 24 launches run. Loads are not double-buffered: 7 resident
// blocks an SM (31 KB and at most 72 registers each at n = 49, hd = 32)
// hide one another's copies; a double-buffered variant holds 4 and was
// slower at stage 1, faster at stage 3 (PERF.md).
//
// Shapes: bf16 at n <= 128 and head dims that are multiples of 8 up to 128
// take the tensor cores (hd 16, the KSA decoder, and hd 32, every Swin
// stage); f32 inputs (the card's f32 checks against the CPU, held at 1e-5,
// which TF32 would break) and bf16 beyond those shapes (the window-12
// NewCRFs, n = 144) take the CUDA-core body window_head_attention
// (common.cuh). The rule is mma_shape below, on (dtype, n, hd) alone. The
// TPU-only tricks (window pairs packed to 128 lanes, the VMEM block picker)
// have no counterpart.

#include "attention_mma.cuh"

// f32, and bf16 outside mma_shape: one block of 128 threads per (window,
// head), q, k, v and the scores staged as f32, products on the CUDA cores.
template <typename T>
__global__ void window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                        const T* __restrict__ v,
                                        const float* __restrict__ bias,
                                        const float* __restrict__ mask, T* __restrict__ out,
                                        int n, int c, int hd, int ld, int nw, float scale) {
  extern __shared__ float smem[];
  const int w = blockIdx.x, h = blockIdx.y;
  const size_t in_off = (size_t)w * n * ld + (size_t)h * hd;
  const size_t out_off = (size_t)w * n * c + (size_t)h * hd;
  const float* bh = bias ? bias + (size_t)h * n * n : nullptr;
  const float* mw = mask ? mask + (size_t)(w % nw) * n * n : nullptr;
  auto add = [=](int r, int col) {
    float b = 0.f;
    if (bh) b += bh[r * n + col];
    if (mw) b += mw[r * n + col];
    return b;
  };
  window_head_attention<T, true>(q + in_off, k + in_off, v + in_off, out + out_off, n, hd, ld,
                                 c, scale, smem, add);
}

// bf16 on the tensor cores: one block of MMA_THREADS per (run of wpb
// windows, head), blocks ordered head-fastest so that neighbouring blocks
// read neighbouring pieces of the same rows. Window u of a head's sequence
// is w = s + i * slots with s = u / (bw / slots), i = u mod (bw / slots):
// slots = nW with a mask (s is the mask slot), 1 without. NT and DT bound
// pad16(n) / 16 and pad16(hd) / 16.
// Resident blocks an SM the bf16 kernel is compiled for: 7 at the main
// path's n <= 64, hd <= 32 (at most 72 registers a thread, 31 KB of shared
// memory at hd 32).
constexpr int fwd_min_blocks(int nt, int dt) { return nt <= 4 && dt <= 2 ? 7 : 1; }

template <int NT, int DT>
__global__ void __launch_bounds__(MMA_THREADS, fwd_min_blocks(NT, DT))
    window_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const float* __restrict__ bias,
                                const float* __restrict__ mask, bf16* __restrict__ out, int bw,
                                int n, int c, int heads, int ldg, int slots, int wpb,
                                float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x % heads;
  const int u0 = (blockIdx.x / heads) * wpb, u1 = min(bw, u0 + wpb);
  const int hd = c / heads, np = mma_pad16(n), ld = mma_ld(hd);
  const int images = bw / slots;
  float* sb = reinterpret_cast<float*>(smem_raw);  // bias + mask, FragBias order
  bf16* sq = reinterpret_cast<bf16*>(sb + np * np);
  bf16* sk = sq + np * ld;
  bf16* sv = sk + np * ld;
  const float* bh = bias ? bias + (size_t)h * n * n : nullptr;
  const float scale_t = __bfloat162float(__float2bfloat16(scale));
  int slot = -1;
  for (int u = u0; u < u1; ++u) {
    const int s = u / images, w = s + (u - s * images) * slots;
    const size_t base = (size_t)w * n * ldg + (size_t)h * hd;
    mma_stage(sq, q + base, n, np, hd, ldg, ld);
    mma_stage(sk, k + base, n, np, hd, ldg, ld);
    mma_stage(sv, v + base, n, np, hd, ldg, ld);
    cp_async_commit();
    if (s != slot) {  // the last window's readers of sb passed the barrier below
      slot = s;
      mma_bias_tile(sb, bh, mask ? mask + (size_t)s * n * n : nullptr, n);
    }
    cp_async_wait<0>();
    mma_scale_staged(sq, np, hd, ld, scale_t);
    __syncthreads();
    mma_head_attention<NT, DT, true>(sq, sk, sv, ld, out + (size_t)w * n * c + (size_t)h * hd,
                                     c, n, hd, 1.f,
                                     FragBias{reinterpret_cast<const float4*>(sb)});
    __syncthreads();  // before the next window's copies overwrite sq, sk, sv
  }
}

// Shared memory of the bf16 tensor-core kernel: the FragBias tile and q, k,
// v in pad16(n) rows of mma_ld(hd) elements.
static size_t mma_smem(int n, int hd) {
  const size_t np = mma_pad16(n);
  return np * np * sizeof(float) + 3 * np * mma_ld(hd) * sizeof(bf16);
}

template <int NT, int DT>
static int launch_mma(const void* q, const void* k, const void* v, const float* bias,
                      const float* mask, void* out, int bw, int n, int c, int heads, int ld,
                      int nw, float scale, cudaStream_t stream) {
  auto kernel = window_attention_mma_kernel<NT, DT>;
  const size_t smem = mma_smem(n, c / heads);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  // runs of about 8 windows: the tile is summed about once a run
  const int wpb = balanced_windows_per_block(kernel, smem, bw, heads, 8);
  if (wpb <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((bw + wpb - 1) / wpb) * heads;
  kernel<<<blocks, MMA_THREADS, smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                                bias, mask, (bf16*)out, bw, n, c, heads, ld,
                                                mask ? nw : 1, wpb, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_cuda_cores(const void* q, const void* k, const void* v, const float* bias,
                             const float* mask, void* out, int bw, int n, int c, int heads,
                             int ld, int nw, float scale, cudaStream_t stream) {
  const int hd = c / heads;
  const size_t smem = window_head_smem_floats(n, hd) * sizeof(float);
  cudaError_t err = allow_smem(window_attention_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bw, heads);
  window_attention_kernel<T><<<grid, 128, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, mask, (T*)out, n, c, hd, ld, nw, scale);
  return (int)cudaGetLastError();
}

// q, k, v: (bw, n, c) with rows ld elements apart (3c for the views of one
// fused projection); bias: (heads, n, n) f32 or null; mask: (nw, n, n) f32
// or null, nw dividing bw; out: contiguous (bw, n, c). bf16 at mma_shape:
// 16-byte aligned, ld a multiple of 8. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int mde_window_attention(const void* q, const void* k, const void* v,
                                    const float* bias, const float* mask, void* out, int bw,
                                    int n, int c, int heads, int ld, int nw, float scale,
                                    int dtype, void* stream) {
  if (heads <= 0 || c % heads != 0 || n <= 0 || bw <= 0 || (mask && (nw <= 0 || bw % nw)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int hd = c / heads;
  if (dtype == MDE_F32)
    return launch_cuda_cores<float>(q, k, v, bias, mask, out, bw, n, c, heads, ld, nw, scale,
                                    s);
  if (dtype != MDE_BF16) return (int)cudaErrorInvalidValue;
  if (!mma_shape(n, hd))
    return launch_cuda_cores<bf16>(q, k, v, bias, mask, out, bw, n, c, heads, ld, nw, scale,
                                   s);
  // the tensor-core body copies and stores 16-byte pieces
  if ((((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) & 15) || ld % 8)
    return (int)cudaErrorMisalignedAddress;
  if (n <= 64 && hd <= 32)
    return launch_mma<4, 2>(q, k, v, bias, mask, out, bw, n, c, heads, ld, nw, scale, s);
  return launch_mma<8, 8>(q, k, v, bias, mask, out, bw, n, c, heads, ld, nw, scale, s);
}

// Bytes of shared memory one block of mde_window_attention takes for this
// shape and dtype (MDE_F32 or MDE_BF16).
extern "C" int mde_window_attention_smem(int n, int c, int heads, int dtype) {
  if (heads <= 0) return 0;
  const int hd = c / heads;
  if (dtype == MDE_BF16 && mma_shape(n, hd)) return (int)mma_smem(n, hd);
  return (int)(window_head_smem_floats(n, hd) * sizeof(float));
}

extern "C" const char* mde_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
