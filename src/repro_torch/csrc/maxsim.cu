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
// sit anywhere in a row.  A null keep keeps every centroid (stage 3), a
// null q_mask weighs every query 1 (no multiply).  The max is exact in any
// order; the query sum is plaid::warp_tree_sum's butterfly, which the plain
// version (kernels/ref.py, scoring.lane_tree_sum) mirrors, so the two agree
// bit for bit.
//
// Bound on the H100: bytes.  The codes are read once (4 bytes a slot, pads
// included: 189 MB at the stage-2 shape B=32, nd=8192, L=180), each
// distinct kept score row (4*nq bytes) and keep flag once; one max per
// (token, query).  At K = 2^18, nq = 32 one lane's S_cq is 32 MB, so rows
// are gathered from L2 and device memory, never staged in shared memory.
// A row is gathered for every kept token, so the SMs also take in 4*nq
// bytes a kept token from L1/L2 (1.4 GB at the stage-3 shape, no keep).
//
// Design.  The grid is (candidate blocks, B) with the candidate axis
// innermost, so the blocks in flight share one lane's S_cq rows and keep
// flags in the 50 MB L2.  A warp scores `per_warp` consecutive candidates,
// one at a time.  What the first version (one row load in flight a warp)
// waited on, and what each step does about it:
// * Codes, keep flags and rows formed one dependent chain per 32-token
//   chunk.  Now a lane holds four consecutive codes of each 128-token
//   piece of a window of kWindow tokens (a ColBERTv2 passage), loaded 16
//   bytes at a time when rows allow, and the next candidate's codes load
//   while the warp scores this one; every keep lookup of the window goes
//   out before the first is used.
// * Pads and pruned tokens took turns of the row walk.  The warp compacts
//   the window's live codes (a warp prefix sum of the lanes' counts) into
//   a list in shared memory, so every row load is a live row.  A window
//   without a live code costs one vote.
// * One 128-byte row load in flight a warp.  For nq = 4R with R | 32 (R
//   = 8 at ColBERTv2's nq = 32) a row is R float4s, so one load gathers
//   32/R rows, and kRowLoads loads go out before the first max.  Each lane
//   keeps the running max of its 4 queries for its row group; the groups
//   merge by __shfl_xor_sync max and the values move back to one query a
//   lane for the unchanged tree sum.  Other nq keep one query a lane
//   (groups of 32 queries) and load kRowLoads rows before the first max.
// * Most stage-2 candidates keep no token at all (t_cs 0.4 keeps ~28 of
//   2^18 centroids a lane on the synthetic index).  Such a candidate's
//   score is the lane's score of an empty passage, the tree sum of
//   0 * q_mask, which each warp computes once.
// Probed on the H100 and left out, none faster (PERF.md): keep
// packed to bits and staged in shared memory; codes streamed into shared
// memory by cp.async rings or by the TMA engine, or prefetched to L2; a
// second candidate's codes prefetched into registers.  At the stage-2
// shape the codes stream alone (no keep lookup) takes ~0.08 ms and the
// 1-byte keep lookups ~0.04 more (launch/interaction_probe.py).
#include <type_traits>

#include "plaid_kernels.cuh"

namespace {

constexpr int kWarps = 8;      // warps a block
constexpr int kWindow = 256;   // tokens compacted at a time (a passage's L <= 256)
constexpr int kPieces = kWindow / 128;  // 4-token pieces a lane holds of a window
constexpr int kCodes = 4 * kPieces;
constexpr int kRowLoads = 4;   // row loads a lane issues before the first max
constexpr int kMaxPerWarp = 32;

struct Args {
  const float* s_cq;          // (B, K, nq)
  const int* codes;           // (B, nd, L), -1 pad
  const unsigned char* keep;  // (B, K) or null
  const float* q_mask;        // (B, nq) or null
  float* out;                 // (B, nd)
  int K, nq, nd, L, per_warp;
  bool vec;  // L % 4 == 0 and codes 16-byte aligned: a piece is one 16-byte load
};

// Which centroids a warp keeps: every one (null keep) or those whose
// 1-byte flag is set.
struct KeepAll {
  __device__ bool operator()(int) const { return true; }
};
struct KeepBytes {
  const unsigned char* kp;
  __device__ bool operator()(int c) const { return __ldg(kp + c) != 0; }
};

// The codes of tokens [w0, w0 + kWindow): lane l holds tokens
// w0 + 128h + 4l + e in c[4h + e] (-1 past L).
__device__ __forceinline__ void load_codes(const int* crow, int w0, int L, bool vec,
                                           int (&c)[kCodes], int lane) {
#pragma unroll
  for (int h = 0; h < kPieces; ++h) {
    const int t = w0 + 128 * h + 4 * lane;
    if (vec) {
      int4 v = make_int4(-1, -1, -1, -1);
      if (t < L) v = __ldg(reinterpret_cast<const int4*>(crow + t));
      c[4 * h] = v.x;
      c[4 * h + 1] = v.y;
      c[4 * h + 2] = v.z;
      c[4 * h + 3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) c[4 * h + e] = t + e < L ? __ldg(crow + t + e) : -1;
    }
  }
}

// Drops the pads and pruned centroids of one window's codes `c` and writes
// the live ones to `list`; returns their count (the same in every lane).
// Every keep lookup goes out before the first is used; a window with no
// live code costs one vote.
template <class Keep>
__device__ __forceinline__ int compact(const int (&c)[kCodes], const Keep& keep, int* list,
                                       int lane) {
  bool live[kCodes];
#pragma unroll
  for (int i = 0; i < kCodes; ++i) live[i] = c[i] >= 0 && keep(c[i]);
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < kCodes; ++i) cnt += live[i];
  if (!__any_sync(plaid::kFull, cnt)) return 0;
  int incl = cnt;  // inclusive prefix sum of the lanes' counts
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(plaid::kFull, incl, d);
    if (lane >= d) incl += y;
  }
  int at = incl - cnt;
#pragma unroll
  for (int i = 0; i < kCodes; ++i)
    if (live[i]) list[at++] = c[i];
  __syncwarp();
  return __shfl_sync(plaid::kFull, incl, 31);
}

// A candidate without a live token: sum_i q_mask[i] * max(0, NEG), summed
// as every other candidate is (the same value in every lane).
__device__ __forceinline__ float empty_score(const float* qm, int nq, int lane) {
  float total = 0.f;
  for (int g = 0; g < nq; g += 32) {
    const int qi = g + lane;
    float v = 0.f;
    if (qi < nq) {
      v = fmaxf(plaid::kNeg, 0.f);
      if (qm) v = __fmul_rn(v, __ldg(qm + qi));
    }
    v = plaid::warp_tree_sum(v);
    total = g == 0 ? v : __fadd_rn(total, v);
  }
  return total;
}

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z), fmaxf(a.w, b.w));
}

__device__ __forceinline__ float4 shfl_xor4(float4 v, int m) {
  return make_float4(__shfl_xor_sync(plaid::kFull, v.x, m), __shfl_xor_sync(plaid::kFull, v.y, m),
                     __shfl_xor_sync(plaid::kFull, v.z, m), __shfl_xor_sync(plaid::kFull, v.w, m));
}

// One candidate of lane b whose first window's codes are in `c`; returns
// its score (in every lane), `empty` when no token is live.  R > 0: nq =
// 4R, lane = R*grp + j holds queries 4j..4j+3 of row group grp.  R = 0:
// lane i holds query g + i of each group of 32.
template <int R, class Keep>
__device__ __forceinline__ float candidate(const Args& a, int b, const int* crow,
                                           int (&c)[kCodes], const Keep& keep, int* list, int lane,
                                           float empty) {
  const float* qm = a.q_mask ? a.q_mask + (int64_t)b * a.nq : nullptr;
  if constexpr (R > 0) {
    constexpr int G = 32 / R;
    const float4* S = reinterpret_cast<const float4*>(a.s_cq) + (int64_t)b * a.K * R;
    const int grp = lane / R, j = lane % R;
    float4 m = make_float4(plaid::kNeg, plaid::kNeg, plaid::kNeg, plaid::kNeg);
    bool any = false;
    for (int w0 = 0;;) {
      const int n = compact(c, keep, list, lane);
      any |= n > 0;
      for (int r0 = 0; r0 < n; r0 += G * kRowLoads) {
        float4 v[kRowLoads];
#pragma unroll
        for (int u = 0; u < kRowLoads; ++u) {
          const int r = r0 + G * u + grp;
          v[u] = r < n ? __ldg(S + (int64_t)list[r] * R + j) : m;
        }
#pragma unroll
        for (int u = 0; u < kRowLoads; ++u) m = max4(m, v[u]);
      }
      __syncwarp();  // the list is rewritten next
      if ((w0 += kWindow) >= a.L) break;
      load_codes(crow, w0, a.L, a.vec, c, lane);
    }
    if (!any) return empty;
#pragma unroll
    for (int w = R; w < 32; w <<= 1) m = max4(m, shfl_xor4(m, w));
    // query i = lane: component i % 4 of the lanes with j = i / 4
    const int src = (lane >> 2) % R;
    const float x0 = __shfl_sync(plaid::kFull, m.x, src);
    const float x1 = __shfl_sync(plaid::kFull, m.y, src);
    const float x2 = __shfl_sync(plaid::kFull, m.z, src);
    const float x3 = __shfl_sync(plaid::kFull, m.w, src);
    const int q = lane & 3;
    const float x = q == 0 ? x0 : q == 1 ? x1 : q == 2 ? x2 : x3;
    float v = 0.f;
    if (lane < 4 * R) {
      v = fmaxf(x, 0.f);
      if (qm) v = __fmul_rn(v, __ldg(qm + lane));
    }
    return plaid::warp_tree_sum(v);
  } else {
    const float* S = a.s_cq + (int64_t)b * a.K * a.nq;
    const bool whole = a.L <= kWindow;  // one window: compacted once for all groups
    int n = compact(c, keep, list, lane);
    if (whole && n == 0) {
      __syncwarp();
      return empty;
    }
    float total = 0.f;
    for (int g = 0; g < a.nq; g += 32) {
      const int qi = g + lane;
      float m = plaid::kNeg;
      for (int w0 = 0; w0 < a.L; w0 += kWindow) {
        if (w0 > 0 || (g > 0 && !whole)) {
          __syncwarp();
          load_codes(crow, w0, a.L, a.vec, c, lane);
          n = compact(c, keep, list, lane);
        }
        if (qi < a.nq) {
          for (int r0 = 0; r0 < n; r0 += kRowLoads) {
            float v[kRowLoads];
#pragma unroll
            for (int u = 0; u < kRowLoads; ++u)
              v[u] = r0 + u < n ? __ldg(S + (int64_t)list[r0 + u] * a.nq + qi) : m;
#pragma unroll
            for (int u = 0; u < kRowLoads; ++u) m = fmaxf(m, v[u]);
          }
        }
      }
      float v = 0.f;
      if (qi < a.nq) {
        v = fmaxf(m, 0.f);
        if (qm) v = __fmul_rn(v, __ldg(qm + qi));
      }
      v = plaid::warp_tree_sum(v);
      total = g == 0 ? v : __fadd_rn(total, v);
    }
    __syncwarp();
    return total;
  }
}

// Warp w of block x scores candidates [first, first + per_warp) of lane
// blockIdx.y, loading each next candidate's first window while it scores
// the current one.
template <int R, class Keep>
__device__ __forceinline__ void score_candidates(const Args& a, const Keep& keep, int* list) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int first = (blockIdx.x * kWarps + warp) * a.per_warp;
  const int last = min(first + a.per_warp, a.nd);
  if (first >= last) return;
  const int* cb = a.codes + (int64_t)b * a.nd * a.L;
  const float empty = empty_score(a.q_mask ? a.q_mask + (int64_t)b * a.nq : nullptr, a.nq, lane);
  int next[kCodes];
  load_codes(cb + (int64_t)first * a.L, 0, a.L, a.vec, next, lane);
  for (int n = first; n < last; ++n) {
    int c[kCodes];
#pragma unroll
    for (int i = 0; i < kCodes; ++i) c[i] = next[i];
    if (n + 1 < last) load_codes(cb + (int64_t)(n + 1) * a.L, 0, a.L, a.vec, next, lane);
    const float v = candidate<R>(a, b, cb + (int64_t)n * a.L, c, keep, list, lane, empty);
    if (lane == 0) a.out[(int64_t)b * a.nd + n] = v;
  }
}

template <int R>
__global__ void __launch_bounds__(kWarps * 32) interaction_kernel(Args a) {
  __shared__ int lists[kWarps][kWindow];
  int* list = lists[threadIdx.x >> 5];
  if (a.keep == nullptr) {
    score_candidates<R>(a, KeepAll{}, list);
  } else {
    score_candidates<R>(a, KeepBytes{a.keep + (int64_t)blockIdx.y * a.K}, list);
  }
}

template <class F>
cudaError_t launch_all(F&& launch, int nq, const float* s_cq) {
  const bool rows = reinterpret_cast<uintptr_t>(s_cq) % 16 == 0;  // float4 loads
  if (rows && nq == 32) return launch(std::integral_constant<int, 8>{});
  if (rows && nq == 16) return launch(std::integral_constant<int, 4>{});
  if (rows && nq == 8) return launch(std::integral_constant<int, 2>{});
  if (rows && nq == 4) return launch(std::integral_constant<int, 1>{});
  return launch(std::integral_constant<int, 0>{});
}

}  // namespace

// Each warp scores per_warp consecutive candidates (1..kMaxPerWarp).
extern "C" int plaid_centroid_interaction_batched(
    const float* s_cq, const int* codes, const unsigned char* keep, const float* q_mask,
    float* out, int B, int K, int nq, int nd, int L, int per_warp, void* stream) {
  if (B == 0 || nd == 0) return 0;
  if (per_warp < 1 || per_warp > kMaxPerWarp) return (int)cudaErrorInvalidValue;
  const bool vec = L % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const Args a{s_cq, codes, keep, q_mask, out, K, nq, nd, L, per_warp, vec};
  const dim3 grid((nd + kWarps * per_warp - 1) / (kWarps * per_warp), B), block(kWarps * 32);
  cudaStream_t st = (cudaStream_t)stream;
  return (int)launch_all(
      [&](auto r) {
        interaction_kernel<decltype(r)::value><<<grid, block, 0, st>>>(a);
        return cudaGetLastError();
      },
      nq, s_cq);
}
