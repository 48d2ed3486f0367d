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
// strided views: q and k at one row stride, v at its own (3C for all three
// in the Swin blocks' fused (B*nW, N, 3C) qkv projection; 2C for q and k
// of the NewCRFs blocks' fused qk and C for their separate v),
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
// Wide windows (the ODA encoder's window 12: n = 144 at hd 32, nine 16-row
// tiles). What bounds them: at stage 1, batch 8 ((1024, 144, 192), 6 heads)
// the kernel reads q, k, v and writes out once, 226 MB, 68 us at 3.35 TB/s,
// against 16 GFLOP (16 us on the tensor cores) and 127 M exps (34 us at the
// 16 a clock an SM of the special-function units): bytes bind, the exps
// close behind.
// Why the first wide body ran at 9.4x that bound (7.2x unmasked; H100 80GB
// HBM3, 700 W): a FragBias tile is 83 KB there, so its blocks (nine warps
// and 35 KB, two an SM at 96 registers with 68 bytes spilled) read bias and
// mask through L2 for every logit, 166 KB a (window, head) against 28 KB of
// q, k and v (~1 GB a launch), inside the logits' dependent chain; and each
// window's copies were waited for before its compute began.
// Design (window_attention_wide_kernel): one block an SM (221 KB of shared
// memory) of nine consumer warps, warp rt owning query rows 16 rt.. of
// every window, and one producer warp, walking a run of windows of one head
// in the order above, mask slot by mask slot. Each consumer fills its own
// 16 rows of the f32 FragBias tile when the slot changes (warp_bias_rows:
// 8 windows reuse them at batch 8, a whole run without a mask) and reads
// nothing else from L2. The producer copies q, k and v into a ring of
// WIDE_FWD_STAGES stages (cp.async, each lane's copies arriving on the
// stage's mbarrier as they land); a consumer waits on that mbarrier, scales
// its own q rows in place, computes, stages its output in them and
// releases the stage on a second mbarrier: there is no block-wide
// barrier. Runs are sized so that the grid is whole waves of one block an
// SM (wide_windows_per_block). ptxas: 168 registers (the most that nine or
// ten warps allow, three to one of the four schedulers), no spills.
// What bounds it now (tools/k1_variants.py, stage 1): the loads are hidden
// (the variant without them is within 2%), the tile fills cost ~10% masked,
// and the rest is the warps' own compute, whose dependent chains (mma,
// shuffles, exps) three warps a scheduler do not hide. Not taken: wgmma
// (the tensor cores are not the limit, and 144 rows are 2.25 of its 64-row
// tiles); TMA tiles (a tensor map needs libcuda's cuTensorMapEncodeTiled, and head
// dims off a multiple of 16 need zero columns a box does not give); one
// cp.async.bulk a 64-byte row, which the variants time at 2.5-2.9x slower.
//
// Shapes: bf16 at n <= 128 and head dims that are multiples of 8 up to 128,
// and at 128 < n <= 144 with head dims that are multiples of 8 up to 32,
// take the tensor cores (hd 16, the KSA decoder, and hd 32, every Swin
// stage, the ODA and NewCRFs window 12 included); f32 inputs (the card's
// f32 checks against the CPU, held at 1e-5, which TF32 would break) and
// bf16 beyond those shapes take the CUDA-core body window_head_attention
// (common.cuh). The rule is window_mma_shape, on (dtype, n, hd) alone. The
// TPU kernel takes q, k and v as separate arrays (fused_window_attention,
// :352), as the NewCRFs blocks hand them over; the Swin blocks' fused qkv
// is the case q = qkv, k = qkv + C, v = qkv + 2C, all at row stride 3C,
// through the same body. The TPU-only tricks (window pairs packed to 128
// lanes, the VMEM block picker) have no counterpart.

#include "attention_mma.cuh"

// f32, and bf16 outside window_mma_shape: one block of 128 threads per (window,
// head), q, k, v and the scores staged as f32, products on the CUDA cores.
template <typename T>
__global__ void window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                        const T* __restrict__ v,
                                        const float* __restrict__ bias,
                                        const float* __restrict__ mask, T* __restrict__ out,
                                        int n, int c, int hd, int ld, int ldv, int nw,
                                        float scale) {
  extern __shared__ float smem[];
  const int w = blockIdx.x, h = blockIdx.y;
  const size_t in_off = (size_t)w * n * ld + (size_t)h * hd;
  const size_t v_off = (size_t)w * n * ldv + (size_t)h * hd;
  const size_t out_off = (size_t)w * n * c + (size_t)h * hd;
  const float* bh = bias ? bias + (size_t)h * n * n : nullptr;
  const float* mw = mask ? mask + (size_t)(w % nw) * n * n : nullptr;
  auto add = [=](int r, int col) {
    float b = 0.f;
    if (bh) b += bh[r * n + col];
    if (mw) b += mw[r * n + col];
    return b;
  };
  window_head_attention<T, true>(q + in_off, k + in_off, v + v_off, out + out_off, n, hd, ld,
                                 ldv, c, scale, smem, add);
}

// bf16 on the tensor cores: one block of MMA_THREADS per (run of wpb
// windows, head), blocks ordered head-fastest so that neighbouring blocks
// read neighbouring pieces of the same rows. Window u of a head's sequence
// is w = s + i * slots with s = u / (bw / slots), i = u mod (bw / slots):
// slots = nW with a mask (s is the mask slot), 1 without. NT and DT bound
// pad16(n) / 16 and pad16(hd) / 16.
// Resident blocks an SM the kernel is compiled for: 7 at the main path's
// n <= 64, hd <= 32 (at most 72 registers a thread, 31 KB of shared memory
// at hd 32).
constexpr int fwd_min_blocks(int nt, int dt) { return nt <= 4 && dt <= 2 ? 7 : 1; }

template <int NT, int DT>
__global__ void __launch_bounds__(MMA_THREADS, fwd_min_blocks(NT, DT))
    window_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const float* __restrict__ bias,
                                const float* __restrict__ mask, bf16* __restrict__ out, int bw,
                                int n, int c, int heads, int ldg, int ldv, int slots, int wpb,
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
    const size_t vbase = (size_t)w * n * ldv + (size_t)h * hd;
    mma_stage(sq, q + base, n, np, hd, ldg, ld);
    mma_stage(sk, k + base, n, np, hd, ldg, ld);
    mma_stage(sv, v + vbase, n, np, hd, ldv, ld);
    cp_async_commit();
    if (s != slot) {  // the last window's readers of sb passed the barrier below
      slot = s;
      mma_bias_tile(sb, bh, mask ? mask + (size_t)s * n * n : nullptr, n);
    }
    cp_async_wait<0>();
    mma_scale_staged(sq, np, hd, ld, scale_t);
    __syncthreads();
    bf16* o = out + (size_t)w * n * c + (size_t)h * hd;
    mma_head_attention<NT, DT, true>(sq, sk, sv, ld, o, c, n, hd, 1.f,
                                     FragBias{reinterpret_cast<const float4*>(sb)});
    __syncthreads();  // before the next window's copies overwrite sq, sk, sv
  }
}

// Stages of the wide body's copy ring.
#define WIDE_FWD_STAGES 4

// Wide windows (window_mma_wide), bf16: one block an SM of MMA_WIDE_WARPS
// consumer warps, warp rt owning query rows 16 rt .. 16 rt + 15 of every
// window, and one producer warp, per (run of wpb windows, head), in the
// order of the kernel above. The producer copies q, k and v of each window
// into the next free stage of a ring of R (cp.async, 16 bytes a lane, rows
// and columns past n and hd zero-filled), each lane's copies arriving on
// the stage's `full` mbarrier as they land; a consumer warp waits on it,
// computes its rows and arrives on the stage's `empty` mbarrier, on which
// the producer waits before it refills the stage. There is no block-wide
// barrier: each warp fills the rows of the FragBias tile that it alone
// reads (warp_bias_rows) when its window's mask slot changes, and stages
// its output in its own rows of the stage's q.
template <int R>
__global__ void __launch_bounds__(32 * (MMA_WIDE_WARPS + 1), 1)
    window_attention_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const float* __restrict__ bias,
                                 const float* __restrict__ mask, bf16* __restrict__ out, int bw,
                                 int n, int c, int heads, int ldg, int ldv, int slots, int wpb,
                                 float scale) {
  constexpr int NT = MMA_WIDE_N / 16, DT = MMA_WIDE_HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x % heads;
  const int u0 = (blockIdx.x / heads) * wpb, u1 = min(bw, u0 + wpb);
  const int hd = c / heads, np = mma_pad16(n), ld = mma_ld(hd), stage = 3 * np * ld;
  const int nk = np >> 4, nd = mma_pad16(hd) >> 4;
  const int images = bw / slots;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sb = reinterpret_cast<float*>(smem_raw);  // bias + mask, FragBias order
  bf16* ring = reinterpret_cast<bf16*>(sb + np * np);  // R stages of q, k, v
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R * stage);
  uint64_t* empty = full + R;
  if (threadIdx.x == 0) {
    for (int i = 0; i < R; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], MMA_WIDE_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (warp == MMA_WIDE_WARPS) {  // the producer
    for (int u = u0, i = 0; u < u1; ++u, ++i) {
      const int st = i % R, s = u / images, w = s + (u - s * images) * slots;
      if (i >= R) mbar_wait(&empty[st], (i / R - 1) & 1);
      bf16* dst = ring + st * stage;
      const size_t base = (size_t)w * n * ldg + (size_t)h * hd;
      warp_stage(dst, q + base, n, np, hd, ldg, ld, lane);
      warp_stage(dst + np * ld, k + base, n, np, hd, ldg, ld, lane);
      warp_stage(dst + 2 * np * ld, v + (size_t)w * n * ldv + (size_t)h * hd, n, np, hd, ldv,
                 ld, lane);
      cp_async_arrive(&full[st]);
    }
    return;
  }
  const int r0 = warp * 16, g = lane >> 2, t = lane & 3;
  const float* bh = bias ? bias + (size_t)h * n * n : nullptr;
  const float scale_t = __bfloat162float(__float2bfloat16(scale));
  const FragBias tile{reinterpret_cast<const float4*>(sb)};
  int slot = -1;
  for (int u = u0, i = 0; u < u1; ++u, ++i) {
    const int st = i % R, s = u / images, w = s + (u - s * images) * slots;
    if (s != slot) {
      slot = s;
      warp_bias_rows(sb, bh, mask ? mask + (size_t)s * n * n : nullptr, n, warp, lane);
    }
    mbar_wait(&full[st], (i / R) & 1);
    bf16* sq = ring + st * stage;
    const bf16* sk = sq + np * ld;
    const bf16* sv = sk + np * ld;
    scale_rows(sq, ld, r0, nd, lane, scale_t);  // this warp's rows, read only by it
    __syncwarp();
    uint32_t fa[DT][4];
    load_rows<DT>(fa, sq, ld, r0, nd, lane);
    float sc[2 * NT][4];
#pragma unroll
    for (int kt = 0; kt < NT; ++kt) {
      if (kt >= nk) break;
      uint32_t fb[DT][4];
      load_bt<DT>(fb, sk, ld, kt * 16, nd, lane);
      float blk[2][4];
      mma_block<DT>(blk, fa, fb, nd);
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[2 * kt][e] = blk[0][e], sc[2 * kt + 1][e] = blk[1][e];
    }
    add_tile<NT>(sc, r0, nk, tile);  // q came scaled
    float inv0, inv1;
    mma_softmax<NT, true>(sc, nk, inv0, inv1);
    float o[2 * DT][4];
    mma_rows_pm<NT, DT>(o, sc, inv0, inv1, sv, ld, nk, nd, lane);
    bf16* rows = sq + r0 * ld;  // this warp's q rows, read only by it, stage its output
#pragma unroll
    for (int dn = 0; dn < 2 * DT; ++dn) {
      if (dn >= 2 * nd) break;
      *reinterpret_cast<uint32_t*>(rows + g * ld + 8 * dn + 2 * t) =
          pack_bf16(o[dn][0], o[dn][1]);
      *reinterpret_cast<uint32_t*>(rows + (g + 8) * ld + 8 * dn + 2 * t) =
          pack_bf16(o[dn][2], o[dn][3]);
    }
    __syncwarp();
    bf16* dst = out + (size_t)w * n * c + (size_t)h * hd;
    for_chunks(lane, 32, 16, hd >> 3, [&](int r, int ch) {
      if (r0 + r < n)
        *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * c + (ch << 3)) =
            *reinterpret_cast<const uint4*>(rows + r * ld + (ch << 3));
    });
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
}

// Shared memory of the bf16 tensor-core kernels: the FragBias tile and q, k,
// v in pad16(n) rows of mma_ld(hd) elements, for wide windows
// WIDE_FWD_STAGES of them and a full and an empty mbarrier each.
static size_t mma_smem(int n, int hd) {
  const size_t np = mma_pad16(n), qkv = 3 * np * mma_ld(hd) * sizeof(bf16);
  if (window_mma_wide(n, hd))
    return np * np * sizeof(float) + WIDE_FWD_STAGES * (qkv + 2 * sizeof(uint64_t));
  return np * np * sizeof(float) + qkv;
}

template <int NT, int DT>
static int launch_mma(const void* q, const void* k, const void* v, const float* bias,
                      const float* mask, void* out, int bw, int n, int c, int heads, int ld,
                      int ldv, int nw, float scale, cudaStream_t stream) {
  auto kernel = window_attention_mma_kernel<NT, DT>;
  const size_t smem = mma_smem(n, c / heads);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  // runs of about 8 windows: the tile is summed about once a run
  const int wpb = balanced_windows_per_block(kernel, smem, bw, heads, 8);
  if (wpb <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((bw + wpb - 1) / wpb) * heads;
  kernel<<<blocks, MMA_THREADS, smem, stream>>>((const bf16*)q, (const bf16*)k,
                                                (const bf16*)v, bias, mask, (bf16*)out, bw, n,
                                                c, heads, ld, ldv, mask ? nw : 1, wpb, scale);
  return (int)cudaGetLastError();
}

static int launch_wide(const void* q, const void* k, const void* v, const float* bias,
                       const float* mask, void* out, int bw, int n, int c, int heads, int ld,
                       int ldv, int nw, float scale, cudaStream_t stream) {
  auto kernel = window_attention_wide_kernel<WIDE_FWD_STAGES>;
  const size_t smem = mma_smem(n, c / heads);
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  // a block's start (the first window's copies, its rows of the tile) is
  // about two windows' time
  const int wpb = wide_windows_per_block(bw, heads, 2);
  if (wpb <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((bw + wpb - 1) / wpb) * heads;
  kernel<<<blocks, 32 * (MMA_WIDE_WARPS + 1), smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, bias, mask, (bf16*)out, bw, n, c, heads,
      ld, ldv, mask ? nw : 1, wpb, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_cuda_cores(const void* q, const void* k, const void* v, const float* bias,
                             const float* mask, void* out, int bw, int n, int c, int heads,
                             int ld, int ldv, int nw, float scale, cudaStream_t stream) {
  const int hd = c / heads;
  const size_t smem = window_head_smem_floats(n, hd) * sizeof(float);
  cudaError_t err = allow_smem(window_attention_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bw, heads);
  window_attention_kernel<T><<<grid, 128, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, mask, (T*)out, n, c, hd, ld, ldv, nw,
      scale);
  return (int)cudaGetLastError();
}

// q, k, v: (bw, n, c), q's and k's rows ld elements apart, v's ldv (3c
// and 3c for the views of one fused qkv projection; 2c and c for a fused
// qk and a separate v); bias: (heads, n, n) f32 or null; mask: (nw, n, n)
// f32 or null, nw dividing bw; out: contiguous (bw, n, c). bf16 at
// window_mma_shape: 16-byte aligned, ld and ldv multiples of 8. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int mde_window_attention(const void* q, const void* k, const void* v,
                                    const float* bias, const float* mask, void* out, int bw,
                                    int n, int c, int heads, int ld, int ldv, int nw,
                                    float scale, int dtype, void* stream) {
  if (heads <= 0 || c % heads != 0 || n <= 0 || bw <= 0 || ld < c || ldv < c ||
      (mask && (nw <= 0 || bw % nw)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int hd = c / heads;
  if (dtype == MDE_F32)
    return launch_cuda_cores<float>(q, k, v, bias, mask, out, bw, n, c, heads, ld, ldv, nw,
                                    scale, s);
  if (dtype != MDE_BF16) return (int)cudaErrorInvalidValue;
  if (!window_mma_shape(n, hd))
    return launch_cuda_cores<bf16>(q, k, v, bias, mask, out, bw, n, c, heads, ld, ldv, nw,
                                   scale, s);
  // the tensor-core body copies and stores 16-byte pieces
  if ((((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) & 15) || ld % 8 ||
      ldv % 8)
    return (int)cudaErrorMisalignedAddress;
  if (n <= 64 && hd <= 32)
    return launch_mma<4, 2>(q, k, v, bias, mask, out, bw, n, c, heads, ld, ldv, nw, scale, s);
  if (n <= MMA_MAX_N)
    return launch_mma<8, 8>(q, k, v, bias, mask, out, bw, n, c, heads, ld, ldv, nw, scale, s);
  return launch_wide(q, k, v, bias, mask, out, bw, n, c, heads, ld, ldv, nw, scale, s);
}

// Bytes of shared memory one block of mde_window_attention takes for this
// shape and dtype (MDE_F32 or MDE_BF16).
extern "C" int mde_window_attention_smem(int n, int c, int heads, int dtype) {
  if (heads <= 0) return 0;
  const int hd = c / heads;
  if (dtype == MDE_BF16 && window_mma_shape(n, hd)) return (int)mma_smem(n, hd);
  return (int)(window_head_smem_floats(n, hd) * sizeof(float));
}

extern "C" const char* mde_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
