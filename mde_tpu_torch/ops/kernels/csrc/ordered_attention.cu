// K2: ordered depth-bias window attention, forward.
//
// Replaces the TPU kernel _pallas_ordered_attention
// (mde_tpu/ops/pallas/ordered_attention.py:254, body _kernel :157), reached
// through fused_ordered_window_attention (:513). Per window and head it
// computes
//   softmax(q . k^T * scale + T[idx[i] - idx[j] + E - 1, h]) . v
// and plain window attention when the table is absent. The logits are
// scaled in f32 after the product, as the plain path does (:94-95).
//
// What bounds it on an H100: at the main-path shapes (3136 windows of 64
// tokens, 512 channels, 8 heads, head dim 64, batch 8, bf16) it reads q, k,
// v and writes out once, 822 MB (plus 0.8 MB of indices), 245 us at
// 3.35 TB/s, against 26 GFLOP (27 us on the bf16 tensor cores): it is bound
// by bytes.
//
// Why the first design ran at 16x that bound: it staged q, k, v and the
// scores as f32 in shared memory and took every logit and every output
// element as a 64-term loop of f32 FMAs on the CUDA cores, each FMA reading
// two operands from shared memory. 25,088 (window, head) pairs x 2 x 64^3
// FMAs are 411 M warp instructions of 2 shared-memory wavefronts each:
// ~3.5 ms at one wavefront per clock on 132 SMs, against 3.9 ms measured.
// Shared-memory bandwidth, not device memory, set its time.
//
// Design (bf16): the products go to the tensor cores, and S and P never
// touch shared memory (attention_mma.cuh). One block of 4 warps per
// (window, head), blocks ordered head-fastest so that neighbouring blocks
// read neighbouring 128-byte pieces of the same rows. q, k and v arrive by
// 16-byte cp.async into padded bf16 rows (27 KB at n = hd = 64), beside the
// head's column of the bias table (2E-1 floats) and the window's indices;
// each warp takes 16 query rows through mma.sync.m16n8k16 with ldmatrix
// operands, gathers each logit's bias from shared memory by its (row, col),
// takes the softmax within quads of lanes, turns P into bf16 A fragments in
// registers for P.v, and stores its output rows in 16-byte pieces. At about
// 30 KB and 128 threads a block, several blocks share an SM, so one block's
// copies overlap another's products.
//
// Why mma.sync and not wgmma with TMA: the per-head tile is 64 x 64 x 64
// and the kernel is bound by bytes, so the aim is to leave the shared-memory
// loop, not to reach the tensor cores' peak; mma.sync on the 16-row tiles
// of one (window, head) does that with four warps and no warpgroup
// choreography. A TMA/wgmma design is for a later change, if a profile asks.
//
// f32 inputs (the card's f32 checks against the CPU) keep the CUDA-core
// body window_head_attention (common.cuh), a second instantiation chosen by
// dtype in the entry point: TF32 tensor cores would round the operands to
// 10 bits of mantissa, far outside the f32 checks' 1e-5.
//
// The TPU kernel needed Toeplitz one-hot matmuls or lane gathers for the
// bias only because Mosaic has no dynamic VMEM gather (:9-12); window-pair
// packing is a 128-lane MXU trick and is not carried over.

#include "attention_mma.cuh"

// f32: one block of 256 threads per (window, head), q, k, v and the scores
// staged as f32, products on the CUDA cores.
__global__ void ordered_attention_f32_kernel(const float* __restrict__ q,
                                             const float* __restrict__ k,
                                             const float* __restrict__ v,
                                             const int* __restrict__ idx,
                                             const float* __restrict__ table,
                                             float* __restrict__ out, int n, int c, int hd,
                                             int heads, int num_emb, float scale) {
  extern __shared__ float smem[];
  const int w = blockIdx.x, h = blockIdx.y;
  float* st = smem + window_head_smem_floats(n, hd);  // (2E-1,) column of T for head h
  int* si = (int*)(st + 2 * num_emb - 1);             // (n,) indices of the window
  if (table) {
    for (int r = threadIdx.x; r < 2 * num_emb - 1; r += blockDim.x)
      st[r] = table[(size_t)r * heads + h];
    // clamped so that no index can read outside the table
    for (int r = threadIdx.x; r < n; r += blockDim.x)
      si[r] = min(max(idx[(size_t)w * n + r], 0), num_emb - 1);
  }
  // window_head_attention synchronises before it reads any logit
  const int off = num_emb - 1;
  auto gather = [=](int r, int col) { return table ? st[si[r] - si[col] + off] : 0.f; };
  const size_t base = (size_t)w * n * c + (size_t)h * hd;
  window_head_attention<float, false>(q + base, k + base, v + base, out + base, n, hd, c, c,
                                      scale, smem, gather);
}

// bf16: one block of MMA_THREADS per (window, head) on the tensor cores.
// NT and DT bound pad16(n) / 16 and pad16(hd) / 16.
template <int NT, int DT>
__global__ void __launch_bounds__(MMA_THREADS)
    ordered_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const int* __restrict__ idx,
                                 const float* __restrict__ table, bf16* __restrict__ out, int n,
                                 int c, int hd, int heads, int num_emb, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = blockIdx.x / heads, h = blockIdx.x - w * heads;
  const int np = mma_pad16(n), ld = mma_ld(hd);
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = sq + np * ld;
  bf16* sv = sk + np * ld;
  float* st = reinterpret_cast<float*>(sv + np * ld);  // (2E-1,) column of T for head h
  int* si = reinterpret_cast<int*>(st + 2 * num_emb - 1);  // (np,) indices, 0 past n
  const size_t base = (size_t)w * n * c + (size_t)h * hd;
  mma_stage(sq, q + base, n, np, hd, c, ld);
  mma_stage(sk, k + base, n, np, hd, c, ld);
  mma_stage(sv, v + base, n, np, hd, c, ld);
  cp_async_commit();
  if (table) {
    for (int r = threadIdx.x; r < 2 * num_emb - 1; r += blockDim.x)
      st[r] = table[(size_t)r * heads + h];
    // clamped so that no index can read outside the table
    for (int r = threadIdx.x; r < np; r += blockDim.x)
      si[r] = r < n ? min(max(idx[(size_t)w * n + r], 0), num_emb - 1) : 0;
  }
  cp_async_wait<0>();
  __syncthreads();
  const int off = num_emb - 1;
  auto gather = [=](int r, int col) { return table ? st[si[r] - si[col] + off] : 0.f; };
  mma_head_attention<NT, DT>(sq, sk, sv, ld, out + base, c, n, hd, scale, gather);
}

// Shared memory of the bf16 kernel: q, k, v in pad16(n) rows of mma_ld(hd)
// elements, the table's column and the indices.
static size_t mma_smem(int n, int hd, int num_emb, bool table) {
  const size_t np = mma_pad16(n);
  return 3 * np * mma_ld(hd) * sizeof(bf16) +
         (table ? (2 * num_emb - 1) * sizeof(float) + np * sizeof(int) : 0);
}

// Shared memory of the f32 kernel: window_head_attention's, and with a
// table its column and the indices.
static size_t f32_smem(int n, int hd, int num_emb, bool table) {
  return (window_head_smem_floats(n, hd) + (table ? 2 * num_emb - 1 + n : 0)) * sizeof(float);
}

template <int NT, int DT>
static int launch_mma(const void* q, const void* k, const void* v, const int* idx,
                      const float* table, void* out, int bw, int n, int c, int heads,
                      int num_emb, float scale, cudaStream_t stream) {
  const int hd = c / heads;
  const size_t smem = mma_smem(n, hd, num_emb, table != nullptr);
  cudaError_t err = allow_smem(ordered_attention_mma_kernel<NT, DT>, smem);
  if (err != cudaSuccess) return (int)err;
  ordered_attention_mma_kernel<NT, DT><<<(unsigned)bw * heads, MMA_THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, idx, table, (bf16*)out, n, c, hd, heads,
      num_emb, scale);
  return (int)cudaGetLastError();
}

static int launch_f32(const void* q, const void* k, const void* v, const int* idx,
                      const float* table, void* out, int bw, int n, int c, int heads,
                      int num_emb, float scale, cudaStream_t stream) {
  const int hd = c / heads;
  const size_t smem = f32_smem(n, hd, num_emb, table != nullptr);
  cudaError_t err = allow_smem(ordered_attention_f32_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bw, heads);
  ordered_attention_f32_kernel<<<grid, 256, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, idx, table, (float*)out, n, c, hd,
      heads, num_emb, scale);
  return (int)cudaGetLastError();
}

// q, k, v, out: contiguous (bw, n, c), 16-byte aligned in bf16; idx:
// (bw, n) int32 in [0, num_emb); table: (2*num_emb-1, heads) f32, or null
// for plain window attention. n <= 128 and the head dim c / heads a
// multiple of 8 up to 128. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int mde_ordered_attention(const void* q, const void* k, const void* v,
                                     const int* idx, const float* table, void* out, int bw,
                                     int n, int c, int heads, int num_emb, float scale,
                                     int dtype, void* stream) {
  if (heads <= 0 || c % heads != 0 || !mma_shape(n, c / heads) ||
      (table && (num_emb <= 0 || !idx)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MDE_F32)
    return launch_f32(q, k, v, idx, table, out, bw, n, c, heads, num_emb, scale, s);
  if (dtype != MDE_BF16) return (int)cudaErrorInvalidValue;
  // the bf16 body copies and stores 16-byte pieces
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) & 15)
    return (int)cudaErrorMisalignedAddress;
  if (n <= 64 && c / heads <= 64)
    return launch_mma<4, 4>(q, k, v, idx, table, out, bw, n, c, heads, num_emb, scale, s);
  return launch_mma<8, 8>(q, k, v, idx, table, out, bw, n, c, heads, num_emb, scale, s);
}

// Bytes of shared memory one block of mde_ordered_attention takes for this
// shape and dtype (MDE_F32 or MDE_BF16), with or without a table.
extern "C" int mde_ordered_attention_smem(int n, int c, int heads, int num_emb, int has_table,
                                          int dtype) {
  const int hd = c / heads;
  return (int)(dtype == MDE_BF16 ? mma_smem(n, hd, num_emb, has_table)
                                 : f32_smem(n, hd, num_emb, has_table));
}
