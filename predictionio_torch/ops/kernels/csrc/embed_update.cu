// embed_update: the row-sparse table update of rowwise Adagrad,
//
//   table[idx[b], :] += -scale[b] * grad[b, :]     for b in [0, B)
//
// in place and safe under duplicate indices, for Hopper (sm_90a).
//
// Replaces predictionio_tpu/ops/pallas/embed_update.py: _scatter_apply's
// pallas_call (body _apply_kernel), called by pallas_rowwise_adagrad.
// The TPU kernel tiles the batch 8 rows at a time, reads each touched
// row into VMEM with its own DMA, routes in-tile duplicates through an
// adjacency product and orders tiles with semaphores. None of that is
// needed here: one warp per batch row adds its scaled gradient into the
// table row with float atomics, which the L2 resolves, so duplicates
// sum correctly in some order (the order, and so the last bits of a
// row that several batch rows touch, may change from run to run; the
// JAX package's contract allows that: "modulo summation order").
//
// What bounds it on the card: bytes. Each batch row reads its gradient
// (E floats) and each touched table row is read and written once, so a
// B = 8192, E = 128 update moves about 12.6 MB: some 3.8 us at
// 3.35 TB/s. The scattered 512-byte rows keep it below that rate.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 8 warps: 8 batch rows per block

__global__ void __launch_bounds__(kThreads)
    embed_update_kernel(float* __restrict__ table,
                        const long long* __restrict__ idx,
                        const float* __restrict__ grad,
                        const float* __restrict__ scale, int B, int E,
                        long long N) {
  const int b = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= B) return;
  const long long row = idx[b];
  if (row < 0 || row >= N) return;   // ids outside the table: no row
  const float s = -scale[b];
  const float* g = grad + (size_t)b * E;
  float* t = table + (size_t)row * E;
  for (int e = lane; e < E; e += 32) atomicAdd(t + e, s * g[e]);
}

}  // namespace

extern "C" int embed_update_launch(float* table, const long long* idx,
                                   const float* grad, const float* scale,
                                   int B, int E, long long N, void* stream) {
  if (B < 1 || E < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const int per_block = kThreads / 32;
  embed_update_kernel<<<(B + per_block - 1) / per_block, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      table, idx, grad, scale, B, E, N);
  return (int)cudaGetLastError();
}

extern "C" const char* embed_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
