// K2: batched residual decompression + exact MaxSim (stage 4, unfused).
//
// Replaces: src/repro/kernels/decompress.py:205
// decompress_and_score_batched_pallas (kernel body :172, pallas_call :232).
//
// Computes, for each lane b and finalist n,
//   out[b, n] = sum_i q_mask[b, i] * max_{t: tok_valid} emb_t . q[b, i]
//   emb_t     = centroids[code_t] + weights[unpack(packed_t)]
// with NEG where a passage has no valid token and no 0-clamp.
//
// Bound on the H100: operations.  Per valid token it reads 4 + d*nbits/8 + 1
// bytes plus a centroid row (the distinct rows touched are at most the
// table), and does 2*nq*d float32 operations; at nq = 32, d = 128 that is
// ~8K flops per ~40 payload bytes, above the f32 ridge of 67 TFLOP/s over
// 3.35 TB/s.  This version uses IEEE f32 on the CUDA cores (no TF32, no
// tensor cores) so it agrees bit for bit with its plain version.
//
// Design: one block per (b, finalist), grid (finalists, B) with the
// finalist axis innermost.  The lane's query tile goes to shared memory
// once per block; tiles of 32 tokens are reconstructed into shared memory
// (one thread per packed byte, MSB-first fields) and scored one
// (token, query) dot product per thread, with a running max per query in
// registers.  Tiles with no valid token are skipped, so the padding past
// a passage's length costs one flag read.
#include "plaid_kernels.cuh"

namespace {

__global__ void __launch_bounds__(plaid::kThreads)
decompress_score_kernel(const float* __restrict__ q,
                        const float* __restrict__ q_mask,
                        const int* __restrict__ codes,
                        const uint8_t* __restrict__ packed,
                        const bool* __restrict__ tok_valid,
                        const float* __restrict__ centroids,
                        const float* __restrict__ weights,
                        float* __restrict__ out, int nq, int d, int pd,
                        int nbits, int nd, int L) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* e_s = q_s + nq * (d + 1);
  float* mx_s = e_s + plaid::kTile * (d + 1);
  const int b = blockIdx.y, n = blockIdx.x;
  plaid::load_query_tile(q + (int64_t)b * nq * d, nq, d, q_s);
  __syncthreads();
  const int64_t row = (int64_t)b * nd + n;
  const float total = plaid::score_doc(
      q_s, q_mask + (int64_t)b * nq, codes + row * L, packed + row * L * pd,
      tok_valid + row * L, L, centroids, weights, nq, d, pd, nbits, e_s, mx_s);
  if (threadIdx.x == 0) out[row] = total;
}

}  // namespace

extern "C" int plaid_decompress_and_score_batched(
    const float* q, const float* q_mask, const int* codes, const uint8_t* packed,
    const bool* tok_valid, const float* centroids, const float* weights,
    float* out, int B, int nq, int d, int nbits, int nd, int L, void* stream) {
  if (B == 0 || nd == 0) return 0;
  const int pd = d * nbits / 8;
  const size_t smem = plaid::score_doc_smem_bytes(nq, d);
  cudaError_t err = plaid::allow_smem(decompress_score_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  decompress_score_kernel<<<dim3(nd, B), plaid::kThreads, smem,
                            (cudaStream_t)stream>>>(
      q, q_mask, codes, packed, tok_valid, centroids, weights, out, nq, d, pd,
      nbits, nd, L);
  return (int)cudaGetLastError();
}
