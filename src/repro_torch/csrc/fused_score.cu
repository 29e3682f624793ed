// K3: fused gather -> decompress -> exact MaxSim (stage 3-5 tail, fused).
//
// Replaces: src/repro/kernels/fused_score.py:79
// gather_decompress_maxsim_pallas (kernel body :41, pallas_call :142).
//
// Computes K2's score for each finalist pid = final_pids[b, n], reading
// its doc_lens[pid] codes and packed residual rows straight from the CSR
// token arrays at doc_offsets[pid]; nothing gathered is written to memory.
// A pid == -1 slot has no rows and writes sum_i NEG * q_mask[b, i], which
// is what the plain version gives.
//
// Bound, contract and design: plaid_kernels.cuh, maxsim::score_kernel
// (the body K2 shares).  The TPU kernel reads a fixed doc_maxlen window
// clamped inside the token array, a static-shape workaround of Mosaic;
// here a block takes the prefix sum of its G finalists' lengths and walks
// exactly rows [start, start + len) of each, as one stream of tokens.  A
// passage's byte rows start at start * pd, 16-byte aligned only when pd
// is, so the copy narrows to 8 or 4 bytes (or to single bytes) otherwise.
#include "plaid_kernels.cuh"

extern "C" int plaid_gather_decompress_maxsim(
    const float* qs, const float* q_masks, const int* final_pids,
    const int* codes_tok, const uint8_t* residuals_tok, const int* doc_offsets,
    const int* doc_lens, const float* centroids, const float* weights,
    float* out, int B, int nq, int d, int nbits, int n3, int G, void* stream) {
  plaid::maxsim::Args a{};
  a.q = qs;
  a.q_mask = q_masks;
  a.final_pids = final_pids;
  a.codes = codes_tok;
  a.packed = residuals_tok;
  a.doc_offsets = doc_offsets;
  a.doc_lens = doc_lens;
  a.centroids = centroids;
  a.weights = weights;
  a.out = out;
  a.nq = nq;
  a.d = d;
  a.nd = n3;
  a.G = G;
  return plaid::maxsim::launch<true>(a, B, nbits, stream);
}

// Blocks an SM holds at nbits 2 (-1 if the query failed).
extern "C" int plaid_gather_maxsim_blocks_per_sm(int nq, int d, int G, int L) {
  return plaid::maxsim::blocks_per_sm<true>(nq, d, G, L);
}
