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
// Design: one block per (run of windows, head), as K1's backward. The TPU
// built dT through one-hot matmuls into an (E, heads*E) accumulator carried
// over its sequential grid, then segment-summed it (:461-466). Here the
// block keeps its head's column of T (2E-1 floats), the window's indices
// and a (2E-1)-float dT accumulator in shared memory; every dS is added
// straight to its bucket with a shared-memory atomicAdd, and after its last
// window the block adds its 255 sums to the f32 table gradient with global
// atomicAdds. The same sum as JAX's, taken directly; its order (and so the
// last bits of dT) changes from run to run. q, k, v, dO (64 x 64 each) and
// the 64 x 64 P and dS sit in shared memory as f32, about 101 KB a block.

#include "common.cuh"

template <typename T>
__global__ void ordered_attention_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const int* __restrict__ idx, const float* __restrict__ table,
    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dtable,
    int bw, int n, int c, int hd, int heads, int num_emb, int wpb, float scale) {
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
    window_head_attention_bwd<T>(q + base, k + base, v + base, dout + base, dq + base,
                                 dk + base, dv + base, n, hd, c, c, c, scale, smem, gather,
                                 sink);
    __syncthreads();
  }
  if (table)
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
      atomicAdd(dtable + (size_t)r * heads + h, sdt[r]);
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, const void* dout,
                  const int* idx, const float* table, void* dq, void* dk, void* dv,
                  float* dtable, int bw, int n, int c, int heads, int num_emb, float scale,
                  cudaStream_t stream) {
  const int hd = c / heads;
  const size_t smem =
      (window_head_bwd_smem_floats(n, hd) + (table ? 2 * (2 * num_emb - 1) + n : 0)) *
      sizeof(float);
  cudaError_t err = allow_smem(ordered_attention_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int wpb = windows_per_block(bw, heads);
  dim3 grid((bw + wpb - 1) / wpb, heads);
  ordered_attention_bwd_kernel<T><<<grid, 256, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, idx, table, (T*)dq, (T*)dk,
      (T*)dv, dtable, bw, n, c, hd, heads, num_emb, wpb, scale);
  return (int)cudaGetLastError();
}

// q, k, v, dout, dq, dk, dv: contiguous (bw, n, c); idx: (bw, n) int32;
// table: (2*num_emb-1, heads) f32, or null for plain window attention;
// dtable: like table, zeroed by the caller (null exactly when table is).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int mde_ordered_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* dout, const int* idx, const float* table,
                                         void* dq, void* dk, void* dv, float* dtable, int bw,
                                         int n, int c, int heads, int num_emb, float scale,
                                         int dtype, void* stream) {
  if (heads <= 0 || c % heads != 0 || n <= 0 || bw <= 0 || (!table != !dtable) ||
      (table && (num_emb <= 0 || !idx)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MDE_F32)
    return launch<float>(q, k, v, dout, idx, table, dq, dk, dv, dtable, bw, n, c, heads,
                         num_emb, scale, s);
  if (dtype == MDE_BF16)
    return launch<__nv_bfloat16>(q, k, v, dout, idx, table, dq, dk, dv, dtable, bw, n, c,
                                 heads, num_emb, scale, s);
  return (int)cudaErrorInvalidValue;
}
