// K1 backward: gradients of window multi-head attention (W-MSA / SW-MSA).
//
// Replaces the TPU kernel _pallas_window_attention_bwd
// (mde_tpu/ops/pallas/window_attention.py:235, body _bwd_kernel :180).
// Per window and head it recomputes P = softmax(qs . k^T + bias[h] +
// mask[w mod nW]) from the saved q, k, v (qs = q*scale in the input dtype,
// :203), forms dS = P * (dP - rowsum(dP * P)) with dP = dO . v^T, and writes
//   dq = dS . k * scale, dk = dS^T . qs, dv = P^T . dO
// (P and dS rounded to the input dtype first, dq scaled in f32), each laid
// out like its input, plus dbias[h] = sum over windows of the unrounded f32
// dS. The inputs are strided views as in the forward: q and k at one row
// stride, v at its own; dq and dk go out at q's stride and dv at v's. The
// Swin blocks' fused qkv (all at 3C) thus gets one fused (B*nW, N, 3C)
// dqkv, and the NewCRFs blocks' fused qk (2C) and separate v (C) a fused
// dqk and a dv, with no slice or concatenation copies either way.
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
// Wide windows (the ODA encoder's window 12: n = 144 at hd 32). What bounds
// them: at stage 1, batch 4 ((512, 144, 192), 6 heads) the kernel reads q,
// k, v, dO and writes dq, dk, dv once, 199 MB, 59 us at 3.35 TB/s, against
// 20 GFLOP (21 us on the tensor cores) and two exps a logit: bytes bind.
// Why the first wide body ran at 16.3x that bound (H100 80GB HBM3, 700 W):
// staged as above a block would need 295 KB (FragBias tile and dbias
// partial 83 KB each, bf16 P and dS 83 KB, qs, k, v and dO 46 KB), so it
// read bias and mask through L2 for every logit it recomputed and kept the
// dbias partial, P, dS and the operands (207 KB, one block an SM of nine
// warps at 168 registers with 28 bytes spilled), in two phases between
// barriers with only k and v of the next window copied during the second.
// Design: window_attention_bwd_wide_kernel below: the FragBias tile filled
// once a mask slot, a ring of copy stages, no P or dS in shared memory
// (recomputed a 16 x 16 block at a time for the per-key products) and the
// dbias sums in registers.
//
// The CUDA-core body at that shape, with a bias, would need 324 KB (q, k,
// v, dO, P and dP as f32, and the dbias partial). There it keeps one f32
// (n, n) matrix (window_head_attention_bwd_lean: P, then dS in its place,
// dP recomputed a row at a time, 158 KB at n = 144, hd 32) and adds dS to
// dbias in device memory with one atomicAdd an entry a window.
//
// Shapes: as the forward (window_mma_shape): bf16 at n <= 128 and head dims
// that are multiples of 8 up to 128, and at 128 < n <= 144 with head dims
// that are multiples of 8 up to 32, on the tensor cores; f32, and bf16
// beyond those shapes, on the CUDA-core body window_head_attention_bwd
// (common.cuh), or its lean form where that does not fit a block.
// Window-pair packing and _pick_tb are TPU tricks with no counterpart.

#include "attention_mma.cuh"

// f32, and bf16 outside window_mma_shape: one block of 256 threads per (run of
// windows, head), everything staged as f32, dbias summed per block in
// shared memory (each entry owned by one thread).
template <typename T>
__global__ void window_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                            const T* __restrict__ v,
                                            const T* __restrict__ dout,
                                            const float* __restrict__ bias,
                                            const float* __restrict__ mask, T* __restrict__ dq,
                                            T* __restrict__ dk, T* __restrict__ dv,
                                            float* __restrict__ dbias, int bw, int n, int c,
                                            int hd, int ld, int ldv, int nw, int wpb,
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
    const size_t in_off = (size_t)w * n * ld + (size_t)h * hd;
    const size_t v_off = (size_t)w * n * ldv + (size_t)h * hd;
    const size_t out_off = (size_t)w * n * c + (size_t)h * hd;
    // the body's first __syncthreads also orders the zeroing of acc above
    window_head_attention_bwd<T>(q + in_off, k + in_off, v + v_off, dout + out_off,
                                 dq + in_off, dk + in_off, dv + v_off, n, hd, ld, ldv, c,
                                 scale, smem, add, sink);
    __syncthreads();
  }
  if (dbias)
    for (int i = threadIdx.x; i < n * n; i += blockDim.x)
      atomicAdd(dbias + (size_t)h * n * n + i, acc[i]);
}

// Shared memory a block may have on the H100 (bytes).
#define BWD_SMEM_LIMIT 232448

// Floats of shared memory that window_head_attention_bwd_lean needs for n
// tokens at head dim hd: qs and dO (n*hd each), k and v (n*(hd+1) each),
// one (n, n) matrix and n row sums.
__host__ __device__ inline size_t lean_bwd_smem_floats(int n, int hd) {
  return (size_t)n * hd * 2 + (size_t)n * (hd + 1) * 2 + (size_t)n * n + n;
}

// window_head_attention_bwd with one (n, n) f32 matrix in shared memory: P,
// then, after dv = bf16(P)^T . dO, dS in its place, with dP = dO . v^T
// recomputed a row at a time (the same f32 sums in the same order, so the
// same results); dS goes to dbias_h (the head's (n, n) f32 gradient in
// device memory, or null) by atomicAdd. The caller synchronises before it
// reuses smem.
template <typename T, typename BiasFn>
__device__ void window_head_attention_bwd_lean(const T* __restrict__ q,
                                               const T* __restrict__ k,
                                               const T* __restrict__ v,
                                               const T* __restrict__ dout, T* __restrict__ dq,
                                               T* __restrict__ dk, T* __restrict__ dv, int n,
                                               int hd, int ld, int ldv, int ldo, float scale,
                                               float* smem, BiasFn bias,
                                               float* __restrict__ dbias_h) {
  const int ldk = hd + 1;
  float* sq = smem;          // q * scale, rounded to T
  float* sdo = sq + n * hd;  // dO
  float* sk = sdo + n * hd;  // k, rows ldk apart
  float* sv = sk + n * ldk;  // v, rows ldk apart
  float* sp = sv + n * ldk;  // S, then P, then dS rounded to T
  float* sdot = sp + n * n;  // rowsum(dP * P)
  const float scale_t = to_float(from_float<T>(scale));
  for (int i = threadIdx.x; i < n * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    const size_t off = (size_t)r * ld + d;
    sq[i] = round_to<T>(to_float(q[off]) * scale_t);
    sk[r * ldk + d] = to_float(k[off]);
    sv[r * ldk + d] = to_float(v[(size_t)r * ldv + d]);
    sdo[i] = to_float(dout[(size_t)r * ldo + d]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    const int r = i / n, c = i - r * n;
    const float* qr = sq + r * hd;
    const float* kc = sk + c * ldk;
    float s = 0.f;
    for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kc[d], s);
    sp[i] = s + bias(r, c);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  // dP[r, j] = dO[r] . v[j], summed as window_head_attention_bwd sums it
  auto dp_at = [&](int r, int j) {
    const float* dor = sdo + r * hd;
    const float* vc = sv + j * ldk;
    float dp = 0.f;
    for (int d = 0; d < hd; ++d) dp = fmaf(dor[d], vc[d], dp);
    return dp;
  };
  for (int r = warp; r < n; r += nwarps) {
    float* prow = sp + r * n;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, prow[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(prow[j] - m);
      prow[j] = e;
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);
    float dot = 0.f;
    for (int j = lane; j < n; j += 32) {
      prow[j] *= inv;
      dot = fmaf(dp_at(r, j), prow[j], dot);
    }
    dot = warp_sum(dot);
    if (lane == 0) sdot[r] = dot;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    float gv = 0.f;
    for (int j = 0; j < n; ++j) gv = fmaf(round_to<T>(sp[j * n + r]), sdo[j * hd + d], gv);
    dv[(size_t)r * ldv + d] = from_float<T>(gv);
  }
  __syncthreads();
  for (int r = warp; r < n; r += nwarps) {
    float* prow = sp + r * n;
    const float dot = sdot[r];
    for (int j = lane; j < n; j += 32) {
      const float ds = prow[j] * (dp_at(r, j) - dot);
      if (dbias_h) atomicAdd(dbias_h + r * n + j, ds);
      prow[j] = round_to<T>(ds);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    float gq = 0.f, gk = 0.f;
    for (int j = 0; j < n; ++j) {
      gq = fmaf(sp[r * n + j], sk[j * ldk + d], gq);  // dS[r, j] k[j, d]
      gk = fmaf(sp[j * n + r], sq[j * hd + d], gk);   // dS[j, r] qs[j, d]
    }
    const size_t off = (size_t)r * ld + d;
    dq[off] = from_float<T>(gq * scale);
    dk[off] = from_float<T>(gk);
  }
}

// The lean body's kernel: one block of 256 threads per (window, head).
template <typename T>
__global__ void window_attention_bwd_lean_kernel(const T* __restrict__ q,
                                                 const T* __restrict__ k,
                                                 const T* __restrict__ v,
                                                 const T* __restrict__ dout,
                                                 const float* __restrict__ bias,
                                                 const float* __restrict__ mask,
                                                 T* __restrict__ dq, T* __restrict__ dk,
                                                 T* __restrict__ dv, float* __restrict__ dbias,
                                                 int n, int c, int hd, int ld, int ldv, int nw,
                                                 float scale) {
  extern __shared__ float smem[];
  const int w = blockIdx.x, h = blockIdx.y;
  const float* bh = bias ? bias + (size_t)h * n * n : nullptr;
  const float* mw = mask ? mask + (size_t)(w % nw) * n * n : nullptr;
  auto add = [=](int r, int col) {
    float b = 0.f;
    if (bh) b += bh[r * n + col];
    if (mw) b += mw[r * n + col];
    return b;
  };
  const size_t in_off = (size_t)w * n * ld + (size_t)h * hd;
  const size_t v_off = (size_t)w * n * ldv + (size_t)h * hd;
  const size_t out_off = (size_t)w * n * c + (size_t)h * hd;
  window_head_attention_bwd_lean<T>(q + in_off, k + in_off, v + v_off, dout + out_off,
                                    dq + in_off, dk + in_off, dv + v_off, n, hd, ld, ldv, c,
                                    scale, smem, add,
                                    dbias ? dbias + (size_t)h * n * n : nullptr);
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
// q, k, dq and dk rows are ldg apart, v and dv rows ldv.
template <int NT, int DT>
__global__ void __launch_bounds__(MMA_THREADS, bwd_min_blocks(NT, DT))
    window_attention_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                    const float* __restrict__ bias,
                                    const float* __restrict__ mask, bf16* __restrict__ dq,
                                    bf16* __restrict__ dk, bf16* __restrict__ dv,
                                    float* __restrict__ dbias, int bw, int n, int c, int heads,
                                    int ldg, int ldv, int slots, int wpb, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x % heads;
  const int u0 = (blockIdx.x / heads) * wpb, u1 = min(bw, u0 + wpb);
  const int hd = c / heads, np = mma_pad16(n), ld = mma_ld(hd);
  const int images = bw / slots;
  float* sb = reinterpret_cast<float*>(smem_raw);  // bias + mask, FragBias order
  float* sdb = sb + np * np;                        // dbias partial, the same order
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
    const size_t vbase = (size_t)w * n * ldv + (size_t)h * hd;
    const size_t obase = (size_t)w * n * c + (size_t)h * hd;
    if (u == u0) {  // later windows' k and v were copied during the last one
      mma_stage(sk, k + base, n, np, hd, ldg, ld);
      mma_stage(sv, v + vbase, n, np, hd, ldv, ld);
    }
    mma_stage(sq, q + base, n, np, hd, ldg, ld);
    mma_stage(sdo, dout + obase, n, np, hd, c, ld);
    cp_async_commit();
    if (s != slot) {  // the last window's readers of sb passed its middle barrier
      slot = s;
      mma_bias_tile(sb, bh, mask ? mask + (size_t)s * n * n : nullptr, n);
    }
    cp_async_wait<0>();
    mma_scale_staged(sq, np, hd, ld, scale_t);
    __syncthreads();
    mma_bwd_rows<NT, DT, true>(sq, sk, sv, sdo, ld, sp, sds, dq + base, ldg, n, hd, scale,
                               FragBias{reinterpret_cast<const float4*>(sb)}, sink);
    __syncthreads();
    if (u + 1 < u1) {
      const int s1 = (u + 1) / images, w1 = s1 + (u + 1 - s1 * images) * slots;
      mma_stage(sk, k + (size_t)w1 * n * ldg + (size_t)h * hd, n, np, hd, ldg, ld);
      mma_stage(sv, v + (size_t)w1 * n * ldv + (size_t)h * hd, n, np, hd, ldv, ld);
      cp_async_commit();
    }
    mma_bwd_keys<NT, DT>(sq, sdo, ld, sp, sds, dk + base, ldg, dv + vbase, ldv, n, hd);
    __syncthreads();
  }
  if (dbias)
    for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
      const int row = i / n, col = i - row * n;
      atomicAdd(dbias + (size_t)h * n * n + i, sdb[frag_offset(row, col, np >> 3)]);
    }
}

// Stages of the wide body's copy ring.
#define WIDE_BWD_STAGES 2
// Row tiles whose dbias sums a lane keeps in registers; those of the others
// are in shared memory, a float4 for each (row tile, 8-key tile, thread).
#define WIDE_DB_REG_TILES 4

// Wide windows (window_mma_wide), bf16: one block an SM of MMA_WIDE_WARPS
// warps per (run of wpb windows, head), in the order of the kernel above.
// q, k, v and dO of each window arrive in a ring of R stages (cp.async, 16
// bytes a thread, padding zero-filled), each thread's copies arriving on
// the stage's mbarrier as they land; the copies of window i + R - 1 are
// issued at window i's middle barrier, once every warp is done with the
// stage they refill. A block keeps no P or dS: per window,
//  - rows pass: warp rt scales its query rows 16 rt.. of q in place (qs,
//    rounded to bf16) and takes them a 16-key block at a time (bias + mask
//    from the FragBias tile), twice: once for the row maxima and the sums
//    of exp(s - max) and of exp(s - max) * dP (rescaled as the maxima
//    grow), which give 1 / rowsum and D = rowsum(P * dP); then for P, dP
//    and dS = P * (dP - D) and dq = bf16(dS) . k * scale. It keeps the
//    maxima, 1 / rowsum and D of its rows in shared memory;
//  - keys pass, after the middle barrier: warp kt takes keys 16 kt.. and
//    each row tile in turn, recomputes the 16 x 16 blocks of S, P (from the
//    kept maxima and sums: the rows pass's f32 values), dP and dS, adds dS
//    to its dbias registers (the same keys in every window) and takes
//    dv += bf16(P)^T . dO and dk += bf16(dS)^T . qs, the transposes' A
//    fragments from movmatrix.
// Nine warps share an SM's four schedulers three to one, which leaves a
// thread 168 registers, so neither pass keeps a row of S, and a lane keeps
// the dbias sums of WIDE_DB_REG_TILES row tiles (32 of its 72) in registers
// and the rest in its own float4s of shared memory: all 72 in registers
// spilled 200 bytes and ran 1.1x as long (tools/k1_variants.py). When the mask slot changes, each warp fills its own
// rows of the FragBias tile after a barrier (its rows pass reads only
// those, and the middle barrier orders them before the keys pass); after
// its last window each lane adds its 72 dbias sums to the head's gradient
// by atomicAdd.
template <int R>
__global__ void __launch_bounds__(32 * MMA_WIDE_WARPS, 1)
    window_attention_bwd_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                     const float* __restrict__ bias,
                                     const float* __restrict__ mask, bf16* __restrict__ dq,
                                     bf16* __restrict__ dk, bf16* __restrict__ dv,
                                     float* __restrict__ dbias, int bw, int n, int c, int heads,
                                     int ldg, int ldv, int slots, int wpb, float scale) {
  constexpr int NT = MMA_WIDE_N / 16, DT = MMA_WIDE_HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x % heads;
  const int u0 = (blockIdx.x / heads) * wpb, u1 = min(bw, u0 + wpb);
  const int hd = c / heads, np = mma_pad16(n), ld = mma_ld(hd), stage = 4 * np * ld;
  const int nk = np >> 4, nd = mma_pad16(hd) >> 4, tiles = np >> 3;
  const int images = bw / slots;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* sb = reinterpret_cast<float*>(smem_raw);  // bias + mask, FragBias order
  bf16* ring = reinterpret_cast<bf16*>(sb + np * np);  // R stages of q, k, v, dO
  float* stats = reinterpret_cast<float*>(ring + R * stage);  // 2 x (max, 1/sum, D) a row
  // dbias sums of row tiles WIDE_DB_REG_TILES.., each thread's own float4s
  float4* dbs = reinterpret_cast<float4*>(stats + 6 * np) + threadIdx.x;
  constexpr int DBS = 2 * (NT - WIDE_DB_REG_TILES);
  uint64_t* full = reinterpret_cast<uint64_t*>(dbs - threadIdx.x + DBS * blockDim.x);
  // the copies of the window at index j of the run into stage j % R
  auto issue = [&](int j) {
    const int u = u0 + j, s = u / images, w = s + (u - s * images) * slots;
    const size_t base = (size_t)w * n * ldg + (size_t)h * hd;
    bf16* dst = ring + (j % R) * stage;
    mma_stage(dst, q + base, n, np, hd, ldg, ld);
    mma_stage(dst + np * ld, k + base, n, np, hd, ldg, ld);
    mma_stage(dst + 2 * np * ld, v + (size_t)w * n * ldv + (size_t)h * hd, n, np, hd, ldv, ld);
    mma_stage(dst + 3 * np * ld, dout + (size_t)w * n * c + (size_t)h * hd, n, np, hd, c, ld);
    cp_async_arrive(&full[j % R]);
  };
  const int count = u1 - u0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < R; ++i) mbar_init(&full[i], 32 * MMA_WIDE_WARPS);
    mbar_init_fence();
  }
  __syncthreads();
  for (int j = 0; j < min(R - 1, count); ++j) issue(j);
  const float* bh = bias ? bias + (size_t)h * n * n : nullptr;
  const float scale_t = __bfloat162float(__float2bfloat16(scale));
  const float4* tile4 = reinterpret_cast<const float4*>(sb);
  // dbias of keys 16 warp.. and every row, summed over windows: row tiles
  // below WIDE_DB_REG_TILES here, the others in dbs
  float db[WIDE_DB_REG_TILES][2][4];
#pragma unroll
  for (int rt = 0; rt < WIDE_DB_REG_TILES; ++rt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) db[rt][0][e] = db[rt][1][e] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < DBS; ++i) dbs[i * blockDim.x] = make_float4(0.f, 0.f, 0.f, 0.f);
  int slot = -1;
  for (int i = 0; i < count; ++i) {
    const int u = u0 + i, st = i % R, s = u / images, w = s + (u - s * images) * slots;
    if (s != slot) {
      // every warp is done with the last slot's tile; each fills its own rows,
      // which only it reads before the middle barrier
      if (slot >= 0) __syncthreads();
      slot = s;
      warp_bias_rows(sb, bh, mask ? mask + (size_t)s * n * n : nullptr, n, warp, lane);
    }
    mbar_wait(&full[st], (i / R) & 1);
    bf16* sq = ring + st * stage;
    const bf16* sk = sq + np * ld;
    const bf16* sv = sk + np * ld;
    const bf16* sdo = sv + np * ld;
    float* smax = stats + (i & 1) * 3 * np;
    float* sinv = smax + np;
    float* sdot = sinv + np;
    const size_t base = (size_t)w * n * ldg + (size_t)h * hd;
    {  // rows pass: warp rt = warp
      const int r0 = warp * 16;
      // qs = q * scale, rounded to bf16, in place: this warp's rows, which
      // only it reads before the middle barrier
      scale_rows(sq, ld, r0, nd, lane, scale_t);
      __syncwarp();
      const float4* brow = tile4 + warp * tiles * 32 + lane;
      uint32_t fa[DT][4], fo[DT][4];
      load_rows<DT>(fa, sq, ld, r0, nd, lane);
      load_rows<DT>(fo, sdo, ld, r0, nd, lane);
      // the logits of key block kt, biased (q came scaled)
      auto logits = [&](int kt, float (&blk)[2][4]) {
        uint32_t fb[DT][4];
        load_bt<DT>(fb, sk, ld, kt * 16, nd, lane);
        mma_block<DT>(blk, fa, fb, nd);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float4 b = brow[(2 * kt + jj) * 32];
          blk[jj][0] += b.x;
          blk[jj][1] += b.y;
          blk[jj][2] += b.z;
          blk[jj][3] += b.w;
        }
      };
      auto dp_block = [&](int kt, float (&dp)[2][4]) {
        uint32_t fb[DT][4];
        load_bt<DT>(fb, sv, ld, kt * 16, nd, lane);
        mma_block<DT>(dp, fo, fb, nd);
      };
      // one sweep for the row maxima and the sums of exp(s - max) and of
      // exp(s - max) * dP, rescaled as the maxima grow
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, e0 = 0.f, e1 = 0.f;
#pragma unroll 3
      for (int kt = 0; kt < nk; ++kt) {
        float blk[2][4], dp[2][4];
        logits(kt, blk);
        dp_block(kt, dp);
        const float n0 = fmaxf(m0, quad_max(fmaxf(fmaxf(blk[0][0], blk[0][1]),
                                                  fmaxf(blk[1][0], blk[1][1]))));
        const float n1 = fmaxf(m1, quad_max(fmaxf(fmaxf(blk[0][2], blk[0][3]),
                                                  fmaxf(blk[1][2], blk[1][3]))));
        // exp(-inf) = 0 for the first block (m = -inf); n is finite
        const float c0 = softmax_exp<true>(m0 - n0), c1 = softmax_exp<true>(m1 - n1);
        l0 *= c0, e0 *= c0, l1 *= c1, e1 *= c1;
        m0 = n0, m1 = n1;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float x0 = softmax_exp<true>(blk[jj][0] - m0);
          const float x1 = softmax_exp<true>(blk[jj][1] - m0);
          const float x2 = softmax_exp<true>(blk[jj][2] - m1);
          const float x3 = softmax_exp<true>(blk[jj][3] - m1);
          l0 += x0 + x1;
          l1 += x2 + x3;
          e0 = fmaf(dp[jj][0], x0, fmaf(dp[jj][1], x1, e0));
          e1 = fmaf(dp[jj][2], x2, fmaf(dp[jj][3], x3, e1));
        }
      }
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      e0 = quad_sum(e0);
      e1 = quad_sum(e1);
      // padded rows get P = 0, so that they add nothing to dk, dv or dbias
      const float inv0 = r0 + g < n ? 1.f / l0 : 0.f;
      const float inv1 = r0 + g + 8 < n ? 1.f / l1 : 0.f;
      const float dot0 = e0 * inv0, dot1 = e1 * inv1;
      if (t == 0) {
        smax[r0 + g] = m0, smax[r0 + g + 8] = m1;
        sinv[r0 + g] = inv0, sinv[r0 + g + 8] = inv1;
        sdot[r0 + g] = dot0, sdot[r0 + g + 8] = dot1;
      }
      float o[2 * DT][4];
#pragma unroll
      for (int j = 0; j < 2 * DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll 3
      for (int kt = 0; kt < nk; ++kt) {
        float blk[2][4], dp[2][4];
        logits(kt, blk);
        dp_block(kt, dp);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pe = softmax_exp<true>(blk[jj][e] - ((e >> 1) ? m1 : m0)) *
                             ((e >> 1) ? inv1 : inv0);
            dp[jj][e] = pe * (dp[jj][e] - ((e >> 1) ? dot1 : dot0));
          }
        }
        const uint32_t fds[4] = {pack_bf16(dp[0][0], dp[0][1]), pack_bf16(dp[0][2], dp[0][3]),
                                 pack_bf16(dp[1][0], dp[1][1]), pack_bf16(dp[1][2], dp[1][3])};
#pragma unroll
        for (int dn = 0; dn < DT; ++dn) {
          if (dn >= nd) break;
          uint32_t fk[4];
          ldsm_x4<true>(fk, tile_b(sk, ld, kt * 16, dn * 16, lane));
          mma16816(o[2 * dn], fds, fk[0], fk[1]);
          mma16816(o[2 * dn + 1], fds, fk[2], fk[3]);
        }
      }
#pragma unroll
      for (int dn = 0; dn < 2 * DT; ++dn) {
        if (8 * dn >= hd) break;
        const int col = 8 * dn + 2 * t;
        if (r0 + g < n)
          *reinterpret_cast<uint32_t*>(dq + base + (size_t)(r0 + g) * ldg + col) =
              pack_bf16(o[dn][0] * scale, o[dn][1] * scale);
        if (r0 + g + 8 < n)
          *reinterpret_cast<uint32_t*>(dq + base + (size_t)(r0 + g + 8) * ldg + col) =
              pack_bf16(o[dn][2] * scale, o[dn][3] * scale);
      }
    }
    __syncthreads();  // every warp is done with the stage of window i - 1
    if (i + R - 1 < count) issue(i + R - 1);
    {  // keys pass: warp kt = warp
      const int k0 = warp * 16;
      float gk[2 * DT][4], gv[2 * DT][4];
#pragma unroll
      for (int j = 0; j < 2 * DT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) gk[j][e] = gv[j][e] = 0.f;
      }
#pragma unroll
      for (int rt = 0; rt < NT; ++rt) {
        if (rt >= nk) break;
        const int r0 = rt * 16;
        float pb[2][4], dp[2][4];
        {  // this warp's keys' fragments, loaded again for each row tile (16 fewer
           // registers held across the loop)
          uint32_t fa[DT][4], fb[DT][4];
          load_rows<DT>(fa, sq, ld, r0, nd, lane);
          load_bt<DT>(fb, sk, ld, k0, nd, lane);
          mma_block<DT>(pb, fa, fb, nd);
          load_rows<DT>(fa, sdo, ld, r0, nd, lane);
          load_bt<DT>(fb, sv, ld, k0, nd, lane);
          mma_block<DT>(dp, fa, fb, nd);
        }
        const float mx[2] = {smax[r0 + g], smax[r0 + g + 8]};
        const float iv[2] = {sinv[r0 + g], sinv[r0 + g + 8]};
        const float dt[2] = {sdot[r0 + g], sdot[r0 + g + 8]};
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float4 b = tile4[(rt * tiles + 2 * warp + jj) * 32 + lane];
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hh = e >> 1;
            // the rows pass's logit and P, bit for bit
            pb[jj][e] = softmax_exp<true>(pb[jj][e] + bv[e] - mx[hh]) * iv[hh];
            dp[jj][e] = pb[jj][e] * (dp[jj][e] - dt[hh]);
          }
          if (rt < WIDE_DB_REG_TILES) {
#pragma unroll
            for (int e = 0; e < 4; ++e) db[rt < WIDE_DB_REG_TILES ? rt : 0][jj][e] += dp[jj][e];
          } else {
            float4& a = dbs[((rt - WIDE_DB_REG_TILES) * 2 + jj) * blockDim.x];
            a = make_float4(a.x + dp[jj][0], a.y + dp[jj][1], a.z + dp[jj][2], a.w + dp[jj][3]);
          }
        }
        uint32_t ap[4], ads[4];
        a_of_transpose(ap, pb);
        a_of_transpose(ads, dp);
#pragma unroll
        for (int dn = 0; dn < DT; ++dn) {
          if (dn >= nd) break;
          uint32_t fb[4];
          ldsm_x4<true>(fb, tile_b(sdo, ld, r0, dn * 16, lane));
          mma16816(gv[2 * dn], ap, fb[0], fb[1]);
          mma16816(gv[2 * dn + 1], ap, fb[2], fb[3]);
          ldsm_x4<true>(fb, tile_b(sq, ld, r0, dn * 16, lane));
          mma16816(gk[2 * dn], ads, fb[0], fb[1]);
          mma16816(gk[2 * dn + 1], ads, fb[2], fb[3]);
        }
      }
      const size_t vbase = (size_t)w * n * ldv + (size_t)h * hd;
#pragma unroll
      for (int dn = 0; dn < 2 * DT; ++dn) {
        if (8 * dn >= hd) break;
        const int col = 8 * dn + 2 * t;
        if (k0 + g < n) {
          const size_t r = k0 + g;
          *reinterpret_cast<uint32_t*>(dk + base + r * ldg + col) =
              pack_bf16(gk[dn][0], gk[dn][1]);
          *reinterpret_cast<uint32_t*>(dv + vbase + r * ldv + col) =
              pack_bf16(gv[dn][0], gv[dn][1]);
        }
        if (k0 + g + 8 < n) {
          const size_t r = k0 + g + 8;
          *reinterpret_cast<uint32_t*>(dk + base + r * ldg + col) =
              pack_bf16(gk[dn][2], gk[dn][3]);
          *reinterpret_cast<uint32_t*>(dv + vbase + r * ldv + col) =
              pack_bf16(gv[dn][2], gv[dn][3]);
        }
      }
    }
  }
  if (dbias) {
    float* dh = dbias + (size_t)h * n * n;
#pragma unroll
    for (int rt = 0; rt < NT; ++rt) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        float sum[4];
        if (rt < WIDE_DB_REG_TILES) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[e] = db[rt < WIDE_DB_REG_TILES ? rt : 0][jj][e];
        } else {
          const float4 a = dbs[((rt - WIDE_DB_REG_TILES) * 2 + jj) * blockDim.x];
          sum[0] = a.x, sum[1] = a.y, sum[2] = a.z, sum[3] = a.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = rt * 16 + g + ((e >> 1) << 3);
          const int col = warp * 16 + 8 * jj + 2 * t + (e & 1);
          if (row < n && col < n) atomicAdd(dh + row * n + col, sum[e]);
        }
      }
    }
  }
}

// Shared memory of the bf16 tensor-core kernels. n <= MMA_MAX_N: the
// FragBias tile, with a bias the dbias partial, qs, k, v and dO in
// pad16(n) rows of mma_ld(hd) elements, and bf16 P and dS as (pad16(n),
// pad16(n)). Wide windows: the FragBias tile, WIDE_BWD_STAGES stages of q,
// k, v and dO, two sets of row maxima, sums and D, the dbias sums kept in
// shared memory, and an mbarrier a stage.
static size_t mma_bwd_smem(int n, int hd, bool with_dbias) {
  const size_t np = mma_pad16(n), ops = 4 * np * mma_ld(hd) * sizeof(bf16);
  if (window_mma_wide(n, hd))
    return np * np * sizeof(float) + WIDE_BWD_STAGES * (ops + sizeof(uint64_t)) +
           6 * np * sizeof(float) +
           2 * (MMA_WIDE_WARPS - WIDE_DB_REG_TILES) * 32 * MMA_WIDE_WARPS * sizeof(float4);
  return (1 + (with_dbias ? 1 : 0)) * np * np * sizeof(float) + ops +
         2 * np * np * sizeof(bf16);
}

// Shared memory of the CUDA-core kernel: window_head_attention_bwd's, and
// with a bias the (n, n) dbias partial.
static size_t cuda_cores_bwd_smem(int n, int hd, bool with_dbias) {
  return (window_head_bwd_smem_floats(n, hd) + (with_dbias ? (size_t)n * n : 0)) *
         sizeof(float);
}

// Whether the CUDA-core shapes take the lean body: where the full one does
// not fit a block.
static bool lean_bwd(int n, int hd, bool with_dbias) {
  return cuda_cores_bwd_smem(n, hd, with_dbias) > BWD_SMEM_LIMIT;
}

// The launches take the pointers of mde_window_attention_bwd, packed.
struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *bias, *mask;
  void *dq, *dk, *dv;
  float* dbias;
  int bw, n, c, heads, ld, ldv, nw;
  float scale;
};

template <int NT, int DT>
static int launch_mma(const BwdArgs& a, cudaStream_t stream) {
  const int bw = a.bw, n = a.n, c = a.c, heads = a.heads;
  float* dbias = a.dbias;
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
  kernel<<<blocks, MMA_THREADS, smem, stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (const bf16*)a.dout, a.bias, a.mask,
      (bf16*)a.dq, (bf16*)a.dk, (bf16*)a.dv, dbias, bw, n, c, heads, a.ld, a.ldv,
      a.mask ? a.nw : 1, wpb, a.scale);
  return (int)cudaGetLastError();
}

static int launch_wide(const BwdArgs& a, cudaStream_t stream) {
  auto kernel = window_attention_bwd_wide_kernel<WIDE_BWD_STAGES>;
  const size_t smem = mma_bwd_smem(a.n, a.c / a.heads, a.dbias != nullptr);
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  // a block's start (the first window's copies, the tile) is about two
  // windows' time
  const int wpb = wide_windows_per_block(a.bw, a.heads, 2);
  if (wpb <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((a.bw + wpb - 1) / wpb) * a.heads;
  kernel<<<blocks, 32 * MMA_WIDE_WARPS, smem, stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (const bf16*)a.dout, a.bias, a.mask,
      (bf16*)a.dq, (bf16*)a.dk, (bf16*)a.dv, a.dbias, a.bw, a.n, a.c, a.heads, a.ld, a.ldv,
      a.mask ? a.nw : 1, wpb, a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_lean(const BwdArgs& a, cudaStream_t stream) {
  const int hd = a.c / a.heads;
  const size_t smem = lean_bwd_smem_floats(a.n, hd) * sizeof(float);
  cudaError_t err = allow_smem(window_attention_bwd_lean_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.bw, a.heads);
  window_attention_bwd_lean_kernel<T><<<grid, 256, smem, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.bias, a.mask, (T*)a.dq,
      (T*)a.dk, (T*)a.dv, a.dbias, a.n, a.c, hd, a.ld, a.ldv, a.nw, a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_cuda_cores(const BwdArgs& a, cudaStream_t stream) {
  const int hd = a.c / a.heads;
  if (lean_bwd(a.n, hd, a.dbias != nullptr)) return launch_lean<T>(a, stream);
  const size_t smem = cuda_cores_bwd_smem(a.n, hd, a.dbias != nullptr);
  cudaError_t err = allow_smem(window_attention_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int wpb = windows_per_block(a.bw, a.heads);
  dim3 grid((a.bw + wpb - 1) / wpb, a.heads);
  window_attention_bwd_kernel<T><<<grid, 256, smem, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.bias, a.mask, (T*)a.dq,
      (T*)a.dk, (T*)a.dv, a.dbias, a.bw, a.n, a.c, hd, a.ld, a.ldv, a.nw, wpb, a.scale);
  return (int)cudaGetLastError();
}

// q, k, v: (bw, n, c), q's and k's rows ld elements apart, v's ldv (3c and
// 3c for the views of one fused qkv projection; 2c and c for a fused qk
// and a separate v); dq, dk, dv: laid out like q, k, v (rows ld, ld and
// ldv apart); dout: contiguous (bw, n, c); bias: (heads, n, n) f32 or null;
// mask: (nw, n, n) f32 or null, nw dividing bw; dbias: (heads, n, n) f32,
// zeroed by the caller, or null (only with bias). bf16 at window_mma_shape:
// 16-byte aligned, ld and ldv multiples of 8. Returns the CUDA error code
// of the launch (0 on success).
extern "C" int mde_window_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* dout, const float* bias, const float* mask,
                                        void* dq, void* dk, void* dv, float* dbias, int bw,
                                        int n, int c, int heads, int ld, int ldv, int nw,
                                        float scale, int dtype, void* stream) {
  if (heads <= 0 || c % heads != 0 || n <= 0 || bw <= 0 || ld < c || ldv < c ||
      (mask && (nw <= 0 || bw % nw)) || (dbias && !bias))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const BwdArgs a{q, k, v, dout, bias, mask, dq, dk, dv, dbias, bw, n, c, heads, ld, ldv, nw,
                  scale};
  const int hd = c / heads;
  if (dtype == MDE_F32) return launch_cuda_cores<float>(a, s);
  if (dtype != MDE_BF16) return (int)cudaErrorInvalidValue;
  if (!window_mma_shape(n, hd)) return launch_cuda_cores<bf16>(a, s);
  // the tensor-core bodies copy 16-byte pieces
  if ((((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout | (uintptr_t)dq |
        (uintptr_t)dk | (uintptr_t)dv) & 15) || ld % 8 || ldv % 8)
    return (int)cudaErrorMisalignedAddress;
  if (n <= 64 && hd <= 32) return launch_mma<4, 2>(a, s);
  if (n <= MMA_MAX_N) return launch_mma<8, 8>(a, s);
  return launch_wide(a, s);
}

// Bytes of shared memory one block of mde_window_attention_bwd takes for
// this shape and dtype (MDE_F32 or MDE_BF16), with or without a bias.
extern "C" int mde_window_attention_bwd_smem(int n, int c, int heads, int has_bias,
                                             int dtype) {
  if (heads <= 0) return 0;
  const int hd = c / heads;
  if (dtype == MDE_BF16 && window_mma_shape(n, hd)) return (int)mma_bwd_smem(n, hd, has_bias);
  if (lean_bwd(n, hd, has_bias)) return (int)(lean_bwd_smem_floats(n, hd) * sizeof(float));
  return (int)cuda_cores_bwd_smem(n, hd, has_bias);
}
