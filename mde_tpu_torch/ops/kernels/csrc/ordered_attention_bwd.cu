// K2 backward: gradients of ordered depth-bias window attention.
//
// Replaces the TPU kernel _pallas_ordered_attention_bwd
// (mde_tpu/ops/pallas/ordered_attention.py:403, body _bwd_kernel :299, and
// the dT fold :461-466). Per window and head it recomputes
//   P = softmax(qs . k^T + T[idx[i] - idx[j] + E - 1, h])
// with qs = q*scale in the input dtype (:335), forms dS = P * (dP -
// rowsum(dP * P)), and writes dq = dS . k * scale, dk = dS^T . qs,
// dv = P^T . dO, and
//   dT[a - b + E - 1, h] = sum of dS over the pairs with (idx_q, idx_k) = (a, b).
// Without a table it is the gradient of plain window attention.
//
// What bounds it on an H100: at the train path's shape (1568 windows of 64
// tokens, 512 channels, 8 heads, head dim 64, batch 4, bf16) it reads q, k,
// v, dO and writes dq, dk, dv once, 7 * 1568*64*512 * 2 B = 720 MB, 0.21 ms
// at 3.35 TB/s, against 10 * 1568*64^2*512 = 33 GFLOP (33 us on the bf16
// tensor cores): it is bound by bytes.
//
// Why the first design ran at 22x that bound: it staged everything as f32
// in shared memory and took each of its five 64 x 64 x 64 products per
// (window, head) as loops of f32 FMAs on the CUDA cores, two shared-memory
// operands each: 12,544 pairs x 5 x 64^3 FMAs, ~4.4 ms of shared-memory
// wavefronts on 132 SMs, against 4.8 ms measured.
//
// Design (bf16): the five products go to the tensor cores
// (attention_mma.cuh, mma.sync.m16n8k16 with ldmatrix operands). One block
// of 4 warps per (run of windows, head), as before, so that the dT buckets
// meet device memory once per block; the runs are sized so that the grid
// fills whole waves of resident blocks. Per window the block stages qs
// (rounded on load), k, v and dO as bf16 (36 KB at n = hd = 64); each warp
// recomputes S and P for its 16 query rows and dP = dO . v^T in registers,
// forms dS there, feeds the f32 dS to the dT buckets, and writes dq from
// bf16 dS fragments in registers. P and dS go to shared memory as bf16 once
// (8 KB each, rows unpadded and swizzled); after a barrier each warp takes
// 16 keys for dk = dS^T . qs and dv = P^T . dO through transposing
// ldmatrix. k and v are no longer read then, so the next window's k and v
// are copied in meanwhile. At 54 KB and at most 128 registers a thread
// (launch bounds), 4 blocks share an SM: loads are not double-buffered,
// since resident blocks hide them better than a deeper pipeline in fewer
// blocks (a double-buffered variant, 2 blocks an SM, was slower).
//
// The dT buckets: shared-memory float atomics are compare-and-swap loops
// on this card (ATOMS.CAST.SPIN), and lanes that meet on one address retry
// in turn. So each thread sums the runs of its dS that share a bucket in
// registers and adds each run once (DTableSink): the fewer distinct
// indices a window holds, the longer the runs and the fewer the atomics.
// After its last window the block adds its 2E-1 sums to the f32 table
// gradient with global atomicAdds. The sum is JAX's, taken directly; its
// order (and so the last bits of dT) changes from run to run.
//
// Why mma.sync and not wgmma with TMA: the tiles are 64 x 64 x 64 and the
// kernel is bound by bytes; mma.sync leaves the shared-memory loop without
// warpgroup choreography. A TMA/wgmma design is for a later change.
//
// f32 inputs keep the CUDA-core body window_head_attention_bwd
// (common.cuh), chosen by dtype in the entry point: TF32 would break the
// f32 checks' 1e-5.

#include "attention_mma.cuh"

// f32: one block of 256 threads per (run of windows, head), everything
// staged as f32, every dS added to its bucket with a shared atomicAdd.
__global__ void ordered_attention_bwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const int* __restrict__ idx,
    const float* __restrict__ table, float* __restrict__ dq, float* __restrict__ dk,
    float* __restrict__ dv, float* __restrict__ dtable, int bw, int n, int c, int hd, int heads,
    int num_emb, int wpb, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.y;
  const int rows = 2 * num_emb - 1;
  float* st = smem + window_head_bwd_smem_floats(n, hd);  // (2E-1,) column of T
  float* sdt = st + rows;                                  // (2E-1,) dT partial
  int* si = (int*)(sdt + rows);                            // (n,) indices of a window
  if (table)
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      st[r] = table[(size_t)r * heads + h];
      sdt[r] = 0.f;
    }
  const int off = num_emb - 1;
  const int w0 = (int)blockIdx.x * wpb;
  const int w_end = min(bw, w0 + wpb);
  for (int w = w0; w < w_end; ++w) {
    if (table)
      // clamped as in the forward, so that no index reads outside the table
      for (int r = threadIdx.x; r < n; r += blockDim.x)
        si[r] = min(max(idx[(size_t)w * n + r], 0), num_emb - 1);
    // the body synchronises before it reads any logit or calls the sink
    auto gather = [=](int r, int col) { return table ? st[si[r] - si[col] + off] : 0.f; };
    auto sink = [=](int r, int col, float ds) {
      if (table) atomicAdd(sdt + (si[r] - si[col] + off), ds);
    };
    const size_t base = (size_t)w * n * c + (size_t)h * hd;
    window_head_attention_bwd<float>(q + base, k + base, v + base, dout + base, dq + base,
                                     dk + base, dv + base, n, hd, c, c, c, scale, smem, gather,
                                     sink);
    __syncthreads();
  }
  if (table)
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
      atomicAdd(dtable + (size_t)r * heads + h, sdt[r]);
}

// Adds one warp's f32 dS to the block's partial dT (2E-1 floats in shared
// memory), a tile of 16 query rows at a time: each thread sums the runs of
// its dS that share a bucket in registers and adds each run with one
// atomic. Shared-memory float atomics are compare-and-swap loops on this
// card, and lanes that meet on one address retry in turn, so where a
// window's indices are few (smooth depth) the runs are long and the adds
// few: with one index a window, one add a thread and tile.
struct DTableSink {
  float* sdt;     // the block's (2E-1,) partial dT, null without a table
  const int* si;  // the window's clamped indices, 0 past n
  int off, n;     // E - 1 and the window's tokens

  template <int NT> __device__ __forceinline__ void tile(int r0, const float (&ds)[2 * NT][4]) {
    if (!sdt) return;
    const int t = threadIdx.x & 3, g = (threadIdx.x & 31) >> 2;
    const int nk = mma_pad16(n) >> 4;
    int cur = -1;
    float acc = 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + g + 8 * hf;
      if (row >= n) break;
      const int vr = si[row] + off;
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j) {
        if (j >= 2 * nk) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t + e;
          if (col >= n) continue;
          const int b = vr - si[col];
          const float x = ds[j][2 * hf + e];
          if (b != cur) {
            if (cur >= 0) atomicAdd(sdt + cur, acc);
            cur = b;
            acc = x;
          } else {
            acc += x;
          }
        }
      }
    }
    if (cur >= 0) atomicAdd(sdt + cur, acc);
  }
};

// Resident blocks an SM the bf16 kernel is compiled for: 4 at the flagship's
// n = hd = 64 (at most 128 registers a thread, 54 KB of shared memory).
constexpr int bwd_min_blocks(int nt, int dt) { return nt <= 4 && dt <= 4 ? 4 : 1; }

// bf16: one block of MMA_THREADS per (run of wpb windows, head) on the
// tensor cores. NT and DT bound pad16(n) / 16 and pad16(hd) / 16.
template <int NT, int DT>
__global__ void __launch_bounds__(MMA_THREADS, bwd_min_blocks(NT, DT))
    ordered_attention_bwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const int* __restrict__ idx, const float* __restrict__ table,
    bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ dtable, int bw, int n, int c, int hd, int heads, int num_emb, int wpb,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.y;
  const int rows = 2 * num_emb - 1;
  const int np = mma_pad16(n), ld = mma_ld(hd);
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // qs = q * scale, rounded to bf16
  bf16* sk = sq + np * ld;
  bf16* sv = sk + np * ld;
  bf16* sdo = sv + np * ld;
  bf16* sp = sdo + np * ld;  // bf16(P), (np, np) laid out by swz
  bf16* sds = sp + np * np;   // bf16(dS)
  float* st = reinterpret_cast<float*>(sds + np * np);  // (2E-1,) column of T
  float* sdt = st + rows;                                // (2E-1,) dT partial
  int* si = reinterpret_cast<int*>(sdt + rows);          // (np,) indices, 0 past n
  if (table)
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      st[r] = table[(size_t)r * heads + h];
      sdt[r] = 0.f;
    }
  const int off = num_emb - 1;
  const float scale_t = __bfloat162float(__float2bfloat16(scale));
  const int w0 = (int)blockIdx.x * wpb;
  const int w_end = min(bw, w0 + wpb);
  auto gather = [=](int r, int col) { return table ? st[si[r] - si[col] + off] : 0.f; };
  for (int w = w0; w < w_end; ++w) {
    const size_t base = (size_t)w * n * c + (size_t)h * hd;
    if (w == w0) {  // later windows' k and v were copied during the last one
      mma_stage(sk, k + base, n, np, hd, c, ld);
      mma_stage(sv, v + base, n, np, hd, c, ld);
    }
    mma_stage(sq, q + base, n, np, hd, c, ld);
    mma_stage(sdo, dout + base, n, np, hd, c, ld);
    cp_async_commit();
    if (table)
      // clamped as in the forward, so that no index reads outside the table
      for (int r = threadIdx.x; r < np; r += blockDim.x)
        si[r] = r < n ? min(max(idx[(size_t)w * n + r], 0), num_emb - 1) : 0;
    cp_async_wait<0>();
    mma_scale_staged(sq, np, hd, ld, scale_t);
    __syncthreads();
    DTableSink sink{table ? sdt : nullptr, si, off, n};
    mma_bwd_rows<NT, DT>(sq, sk, sv, sdo, ld, sp, sds, dq + base, c, n, hd, scale, gather,
                         sink);
    __syncthreads();
    if (w + 1 < w_end) {
      mma_stage(sk, k + base + (size_t)n * c, n, np, hd, c, ld);
      mma_stage(sv, v + base + (size_t)n * c, n, np, hd, c, ld);
      cp_async_commit();
    }
    mma_bwd_keys<NT, DT>(sq, sdo, ld, sp, sds, dk + base, c, dv + base, c, n, hd);
    __syncthreads();
  }
  if (table)
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
      atomicAdd(dtable + (size_t)r * heads + h, sdt[r]);
}

// Shared memory of the bf16 kernel: qs, k, v, dO in pad16(n) rows of
// mma_ld(hd) elements, bf16 P and dS as (pad16(n), pad16(n)), and with a
// table its column, the dT partial and the indices.
static size_t mma_bwd_smem(int n, int hd, int num_emb, bool table) {
  const size_t np = mma_pad16(n);
  return (4 * np * mma_ld(hd) + 2 * np * np) * sizeof(bf16) +
         (table ? 2 * (2 * num_emb - 1) * sizeof(float) + np * sizeof(int) : 0);
}

// Shared memory of the f32 kernel: window_head_attention_bwd's, and with a
// table its column, the dT partial and the indices.
static size_t f32_bwd_smem(int n, int hd, int num_emb, bool table) {
  return (window_head_bwd_smem_floats(n, hd) + (table ? 2 * (2 * num_emb - 1) + n : 0)) *
         sizeof(float);
}

template <int NT, int DT>
static int launch_mma(const void* q, const void* k, const void* v, const void* dout,
                      const int* idx, const float* table, void* dq, void* dk, void* dv,
                      float* dtable, int bw, int n, int c, int heads, int num_emb, float scale,
                      cudaStream_t stream) {
  const int hd = c / heads;
  const size_t smem = mma_bwd_smem(n, hd, num_emb, table != nullptr);
  cudaError_t err = allow_smem(ordered_attention_bwd_mma_kernel<NT, DT>, smem);
  if (err == cudaSuccess)  // room for bwd_min_blocks blocks an SM
    err = cudaFuncSetAttribute(ordered_attention_bwd_mma_kernel<NT, DT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  // runs of about 8 windows, in whole waves of 4 blocks an SM at n = hd = 64
  const int wpb = balanced_windows_per_block(ordered_attention_bwd_mma_kernel<NT, DT>, smem,
                                             bw, heads, 8);
  if (wpb <= 0) return (int)cudaGetLastError();
  dim3 grid((bw + wpb - 1) / wpb, heads);
  ordered_attention_bwd_mma_kernel<NT, DT><<<grid, MMA_THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, idx, table, (bf16*)dq,
      (bf16*)dk, (bf16*)dv, dtable, bw, n, c, hd, heads, num_emb, wpb, scale);
  return (int)cudaGetLastError();
}

static int launch_f32(const void* q, const void* k, const void* v, const void* dout,
                      const int* idx, const float* table, void* dq, void* dk, void* dv,
                      float* dtable, int bw, int n, int c, int heads, int num_emb, float scale,
                      cudaStream_t stream) {
  const int hd = c / heads;
  const size_t smem = f32_bwd_smem(n, hd, num_emb, table != nullptr);
  cudaError_t err = allow_smem(ordered_attention_bwd_f32_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int wpb = windows_per_block(bw, heads);
  dim3 grid((bw + wpb - 1) / wpb, heads);
  ordered_attention_bwd_f32_kernel<<<grid, 256, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, idx, table,
      (float*)dq, (float*)dk, (float*)dv, dtable, bw, n, c, hd, heads, num_emb, wpb, scale);
  return (int)cudaGetLastError();
}

// q, k, v, dout, dq, dk, dv: contiguous (bw, n, c), 16-byte aligned in
// bf16; idx: (bw, n) int32; table: (2*num_emb-1, heads) f32, or null for
// plain window attention; dtable: like table, zeroed by the caller (null
// exactly when table is). n <= 128 and the head dim c / heads a multiple
// of 8 up to 128. Returns the CUDA error code of the launch (0 on success).
extern "C" int mde_ordered_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* dout, const int* idx, const float* table,
                                         void* dq, void* dk, void* dv, float* dtable, int bw,
                                         int n, int c, int heads, int num_emb, float scale,
                                         int dtype, void* stream) {
  if (heads <= 0 || c % heads != 0 || !mma_shape(n, c / heads) || bw <= 0 ||
      (!table != !dtable) || (table && (num_emb <= 0 || !idx)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MDE_F32)
    return launch_f32(q, k, v, dout, idx, table, dq, dk, dv, dtable, bw, n, c, heads, num_emb,
                      scale, s);
  if (dtype != MDE_BF16) return (int)cudaErrorInvalidValue;
  // the bf16 bodies copy and store 16-byte pieces
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout | (uintptr_t)dq |
       (uintptr_t)dk | (uintptr_t)dv) & 15)
    return (int)cudaErrorMisalignedAddress;
  if (n <= 64 && c / heads <= 64)
    return launch_mma<4, 4>(q, k, v, dout, idx, table, dq, dk, dv, dtable, bw, n, c, heads,
                            num_emb, scale, s);
  return launch_mma<8, 8>(q, k, v, dout, idx, table, dq, dk, dv, dtable, bw, n, c, heads,
                          num_emb, scale, s);
}

// Bytes of shared memory one block of mde_ordered_attention_bwd takes for
// this shape and dtype (MDE_F32 or MDE_BF16), with or without a table.
extern "C" int mde_ordered_attention_bwd_smem(int n, int c, int heads, int num_emb,
                                              int has_table, int dtype) {
  const int hd = c / heads;
  return (int)(dtype == MDE_BF16 ? mma_bwd_smem(n, hd, num_emb, has_table)
                                 : f32_bwd_smem(n, hd, num_emb, has_table));
}
