// K3: fused gather -> decompress -> exact MaxSim (stage 3-5 tail, fused).
//
// Replaces: src/repro/kernels/fused_score.py:79
// gather_decompress_maxsim_pallas (kernel body :41, pallas_call :142).
//
// Computes K2's score for each finalist pid = final_pids[b, n], reading
// its doc_lens[pid] codes and packed residual rows straight from the CSR
// token arrays at doc_offsets[pid]; nothing gathered is written to memory.
// A pid == -1 lane has no rows and writes sum_i NEG * q_mask[b, i], which
// is what the plain version gives.
//
// Bound on the H100: operations, as K2 (2*nq*d f32 operations per token of
// the finalist passages against ~d*nbits/8 + 4 payload bytes).  IEEE f32
// on the CUDA cores, bit-identical to the plain version.
//
// Design: the TPU kernel reads a fixed doc_maxlen window clamped inside the
// token array, a static-shape workaround of Mosaic; here the block reads
// exactly rows [start, start + len) of the passage, in tiles of 32, through
// the score_doc body it shares with K2.  Grid (finalists, B), one block per
// finalist, the lane's query tile in shared memory.
#include "plaid_kernels.cuh"

namespace {

__global__ void __launch_bounds__(plaid::kThreads)
gather_decompress_maxsim_kernel(const float* __restrict__ qs,
                                const float* __restrict__ q_masks,
                                const int* __restrict__ final_pids,
                                const int* __restrict__ codes_tok,
                                const uint8_t* __restrict__ residuals_tok,
                                const int* __restrict__ doc_offsets,
                                const int* __restrict__ doc_lens,
                                const float* __restrict__ centroids,
                                const float* __restrict__ weights,
                                float* __restrict__ out, int nq, int d, int pd,
                                int nbits, int n3) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* e_s = q_s + nq * (d + 1);
  float* mx_s = e_s + plaid::kTile * (d + 1);
  const int b = blockIdx.y, n = blockIdx.x;
  const int64_t slot = (int64_t)b * n3 + n;
  const int pid = final_pids[slot];
  const int len = pid >= 0 ? doc_lens[pid] : 0;
  const int64_t start = pid >= 0 ? doc_offsets[pid] : 0;
  plaid::load_query_tile(qs + (int64_t)b * nq * d, nq, d, q_s);
  __syncthreads();
  const float total = plaid::score_doc(
      q_s, q_masks + (int64_t)b * nq, codes_tok + start,
      residuals_tok + start * pd, nullptr, len, centroids, weights, nq, d, pd,
      nbits, e_s, mx_s);
  if (threadIdx.x == 0) out[slot] = total;
}

}  // namespace

extern "C" int plaid_gather_decompress_maxsim(
    const float* qs, const float* q_masks, const int* final_pids,
    const int* codes_tok, const uint8_t* residuals_tok, const int* doc_offsets,
    const int* doc_lens, const float* centroids, const float* weights,
    float* out, int B, int nq, int d, int nbits, int n3, void* stream) {
  if (B == 0 || n3 == 0) return 0;
  const int pd = d * nbits / 8;
  const size_t smem = plaid::score_doc_smem_bytes(nq, d);
  cudaError_t err = plaid::allow_smem(gather_decompress_maxsim_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  gather_decompress_maxsim_kernel<<<dim3(n3, B), plaid::kThreads, smem,
                                    (cudaStream_t)stream>>>(
      qs, q_masks, final_pids, codes_tok, residuals_tok, doc_offsets, doc_lens,
      centroids, weights, out, nq, d, pd, nbits, n3);
  return (int)cudaGetLastError();
}
