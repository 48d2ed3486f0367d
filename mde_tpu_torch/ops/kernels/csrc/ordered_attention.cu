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
// Design: one block per (window, head). The head's column of the bias table
// (2E-1 = 255 floats) and the window's 64 indices sit in shared memory, and
// each logit gathers its bias directly from there. The TPU kernel needed
// Toeplitz one-hot matmuls or lane gathers for this only because Mosaic has
// no dynamic VMEM gather (:9-12); window-pair packing is a 128-lane MXU
// trick and is not carried over. q, k, v (64 x 64 each) and the 64 x 64
// scores are staged in shared memory as f32 (66 KB), products run on the
// CUDA cores in f32.

#include "common.cuh"

template <typename T>
__global__ void ordered_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                         const T* __restrict__ v, const int* __restrict__ idx,
                                         const float* __restrict__ table, T* __restrict__ out,
                                         int n, int c, int hd, int heads, int num_emb,
                                         float scale) {
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
  window_head_attention<T, false>(q + base, k + base, v + base, out + base, n, hd, c, c, scale,
                                  smem, gather);
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, const int* idx,
                  const float* table, void* out, int bw, int n, int c, int heads, int num_emb,
                  float scale, cudaStream_t stream) {
  const int hd = c / heads;
  const size_t smem =
      (window_head_smem_floats(n, hd) + (table ? 2 * num_emb - 1 + n : 0)) * sizeof(float);
  cudaError_t err = allow_smem(ordered_attention_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bw, heads);
  ordered_attention_kernel<T><<<grid, 256, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, idx, table, (T*)out, n, c, hd, heads, num_emb,
      scale);
  return (int)cudaGetLastError();
}

// q, k, v, out: contiguous (bw, n, c); idx: (bw, n) int32 in [0, num_emb);
// table: (2*num_emb-1, heads) f32, or null for plain window attention.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int mde_ordered_attention(const void* q, const void* k, const void* v,
                                     const int* idx, const float* table, void* out, int bw,
                                     int n, int c, int heads, int num_emb, float scale,
                                     int dtype, void* stream) {
  if (heads <= 0 || c % heads != 0 || n <= 0 || (table && (num_emb <= 0 || !idx)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == MDE_F32)
    return launch<float>(q, k, v, idx, table, out, bw, n, c, heads, num_emb, scale, s);
  if (dtype == MDE_BF16)
    return launch<__nv_bfloat16>(q, k, v, idx, table, out, bw, n, c, heads, num_emb, scale, s);
  return (int)cudaErrorInvalidValue;
}
