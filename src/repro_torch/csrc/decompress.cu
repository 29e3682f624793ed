// K2 (and K6): batched residual decompression + exact MaxSim (stage 4,
// unfused); K4: standalone residual decompression.  Both decompress with
// plaid_kernels.cuh's unpack_field, as the reference's two kernels share
// `_unpack`.
//
// ---- K2 -------------------------------------------------------------------
//
// Replaces: src/repro/kernels/decompress.py:205
// decompress_and_score_batched_pallas (kernel body :172, pallas_call :232).
//
// K6 (src/repro/kernels/decompress.py:119 decompress_and_score_pallas,
// pallas_call :142) is this kernel launched with B = 1: the reference's
// single-query kernel is the B = 1 case of the batched one.
//
// Computes, for each lane b and finalist n,
//   out[b, n] = sum_i q_mask[b, i] * max_{t: tok_valid} emb_t . q[b, i]
//   emb_t     = centroids[code_t] + weights[unpack(packed_t)]
// with NEG where a passage has no valid token and no 0-clamp.
//
// Bound, contract and design: plaid_kernels.cuh, maxsim::score_kernel
// (the body K3 shares).  Here its rows are the gathered (B, nd, L) blocks:
// a block scans the tok_valid flags of its G passages once and walks only
// the valid rows, so the padding past a passage's length costs one flag.
//
// ---- K4 -------------------------------------------------------------------
// Replaces: src/repro/kernels/decompress.py:54 decompress_residuals_pallas
// (kernel body :43, pallas_call :69).
//
// Computes out[r, j * vpb + v] = weights[field v of packed[r, j]], fields
// MSB-first, vpb = 8 / nbits.  A table lookup with no arithmetic, so it
// equals its plain version bit for bit.
//
// Bound on the H100: bytes.  n*pd bytes in, n*pd*vpb*4 bytes out (16x the
// input at nbits = 2); vanilla's stage-3 block (4096 passages x 180 rows x
// 32 B) is 23.6 MB in and 377 MB out, 0.12 ms at 3.35 TB/s.
//
// Design: one thread per packed byte, so a warp reads 32 neighbouring
// bytes and writes 32 neighbouring groups of vpb floats as 8- or 16-byte
// stores.  The 2^nbits weights are held in registers (nbits is a template
// argument) and chosen by a select chain, as the reference selects them,
// so the lookup itself touches no memory.
#include "plaid_kernels.cuh"

namespace {

template <int NBITS>
__device__ __forceinline__ float select_weight(const float (&w)[1 << NBITS],
                                               unsigned idx) {
  float v = w[0];
#pragma unroll
  for (int b = 1; b < (1 << NBITS); ++b) v = idx == (unsigned)b ? w[b] : v;
  return v;
}

template <int NBITS>
__global__ void __launch_bounds__(256)
decompress_residuals_kernel(const uint8_t* __restrict__ packed,
                            const float* __restrict__ weights,
                            float* __restrict__ out, int64_t nbytes) {
  constexpr int kVpb = 8 / NBITS;
  float w[1 << NBITS];
#pragma unroll
  for (int b = 0; b < (1 << NBITS); ++b) w[b] = __ldg(weights + b);
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nbytes) return;
  const unsigned byte = __ldg(packed + i);
  float f[kVpb];
#pragma unroll
  for (int v = 0; v < kVpb; ++v)
    f[v] = select_weight<NBITS>(w, plaid::unpack_field(byte, NBITS, v));
  float* dst = out + i * kVpb;  // 4*kVpb-byte aligned: out is 16-byte aligned
  if constexpr (kVpb == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(f[0], f[1]);
  } else {
#pragma unroll
    for (int q = 0; q < kVpb / 4; ++q)
      reinterpret_cast<float4*>(dst)[q] =
          make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
  }
}

}  // namespace

extern "C" int plaid_decompress_and_score_batched(
    const float* q, const float* q_mask, const int* codes, const uint8_t* packed,
    const bool* tok_valid, const float* centroids, const float* weights,
    float* out, int B, int nq, int d, int nbits, int nd, int L, int G, void* stream) {
  plaid::maxsim::Args a{};
  a.q = q;
  a.q_mask = q_mask;
  a.codes = codes;
  a.packed = packed;
  a.tok_valid = tok_valid;
  a.centroids = centroids;
  a.weights = weights;
  a.out = out;
  a.nq = nq;
  a.d = d;
  a.nd = nd;
  a.L = L;
  a.G = G;
  return plaid::maxsim::launch<false>(a, B, nbits, stream);
}

// Blocks an SM holds at nbits 2 (-1 if the query failed).
extern "C" int plaid_decompress_score_blocks_per_sm(int nq, int d, int G, int L) {
  return plaid::maxsim::blocks_per_sm<false>(nq, d, G, L);
}

extern "C" int plaid_decompress_residuals(const uint8_t* packed,
                                          const float* weights, float* out,
                                          int n, int pd, int nbits,
                                          void* stream) {
  const int64_t nbytes = (int64_t)n * pd;
  if (nbytes == 0) return 0;
  constexpr int kThreads = 256;
  const unsigned blocks = (unsigned)((nbytes + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (nbits) {
    case 1:
      decompress_residuals_kernel<1><<<blocks, kThreads, 0, s>>>(packed, weights, out, nbytes);
      break;
    case 2:
      decompress_residuals_kernel<2><<<blocks, kThreads, 0, s>>>(packed, weights, out, nbytes);
      break;
    case 4:
      decompress_residuals_kernel<4><<<blocks, kThreads, 0, s>>>(packed, weights, out, nbytes);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
