// K1: batched centroid interaction, stages 2 and 3 of the PLAID funnel.
//
// Replaces: src/repro/kernels/maxsim.py:110 centroid_interaction_batched_pallas
// (kernel body :88, pallas_call :131).  K5 (maxsim.py:48
// centroid_interaction_pallas, pallas_call :64) is this kernel launched with
// B = 1: the reference's single-query kernel is the B = 1 case of this one.
//
// Computes, for each lane b and candidate n,
//   out[b, n] = sum_i q_mask[b, i] * max(0, max_t S_cq[b, code_t, i])
// over the passage's tokens t with code_t >= 0 and keep[b, code_t]
// (padded and pruned tokens count as NEG before the max).  The -1 pads may
// sit anywhere in a row.
//
// Bound on the H100: bytes.  Each valid, kept token reads one 4*nq-byte
// score row at a data-dependent address, plus its 4-byte code and 1-byte
// keep flag; the arithmetic is one max per (token, query).  At K = 2^18,
// nq = 32 one lane's S_cq is 32 MB, so the rows are gathered from L2 and
// device memory, never staged in shared memory.
//
// Design: one warp per (b, candidate), 8 candidates per block.  Lane i
// holds query token i's running max (groups of 32 for nq > 32).  The warp
// loads 32 codes at a time coalesced, ballots the valid and kept ones, and
// walks only those: each is one coalesced 4*nq-byte row read.  The grid is
// (candidate blocks, B) with the candidate axis innermost, so the blocks
// in flight share one lane's S_cq and its rows stay hot in the 50 MB L2.
// The query sum is the 32-lane butterfly that the plain version mirrors.
#include "plaid_kernels.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
centroid_interaction_kernel(const float* __restrict__ s_cq,
                            const int* __restrict__ codes,
                            const unsigned char* __restrict__ keep,
                            const float* __restrict__ q_mask,
                            float* __restrict__ out, int K, int nq, int nd,
                            int L) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (n >= nd) return;  // whole warp leaves; no block-level barrier below
  const int64_t row = (int64_t)b * nd + n;
  const int* crow = codes + row * L;
  const float* S = s_cq + (int64_t)b * K * nq;
  const unsigned char* kp = keep + (int64_t)b * K;
  const float* qm = q_mask + (int64_t)b * nq;

  float total = 0.f;
  for (int g = 0; g < nq; g += 32) {
    const int qi = g + lane;
    float m = plaid::kNeg;
    for (int t0 = 0; t0 < L; t0 += 32) {
      const int t = t0 + lane;
      int c = t < L ? crow[t] : -1;
      if (c >= 0 && !kp[c]) c = -1;
      unsigned live = __ballot_sync(plaid::kFull, c >= 0);
      while (live) {
        const int j = __ffs(live) - 1;
        live &= live - 1;
        const int cj = __shfl_sync(plaid::kFull, c, j);
        if (qi < nq) m = fmaxf(m, __ldg(S + (int64_t)cj * nq + qi));
      }
    }
    float v = qi < nq ? __fmul_rn(fmaxf(m, 0.f), qm[qi]) : 0.f;
    v = plaid::warp_tree_sum(v);
    total = g == 0 ? v : __fadd_rn(total, v);
  }
  if (lane == 0) out[row] = total;
}

}  // namespace

extern "C" int plaid_centroid_interaction_batched(
    const float* s_cq, const int* codes, const unsigned char* keep,
    const float* q_mask, float* out, int B, int K, int nq, int nd, int L,
    void* stream) {
  if (B == 0 || nd == 0) return 0;
  const dim3 grid((nd + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  centroid_interaction_kernel<<<grid, kWarpsPerBlock * 32, 0,
                                (cudaStream_t)stream>>>(s_cq, codes, keep,
                                                        q_mask, out, K, nq, nd, L);
  return (int)cudaGetLastError();
}
