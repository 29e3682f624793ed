// Device code shared by the PLAID search kernels (sm_90a).
//
// * warp_tree_sum / warp_max: the 32-lane butterfly reductions.  The plain
//   PyTorch versions reproduce warp_tree_sum's order exactly
//   (repro_torch.core.scoring.lane_tree_sum), so kernel and plain version
//   agree bit for bit.
// * unpack_field: the counterpart of repro/kernels/decompress.py:25-37
//   `_unpack` -- field v of a packed byte, 8/nbits bucket indices per byte,
//   most-significant bits first.  K2, K3 (through reconstruct_byte) and K4
//   (decompress.cu) all unpack with it.
// * reconstruct_byte: unpack_field plus the `centroids[code] + weights[idx]`
//   reconstruction.
// * score_doc: the exact-MaxSim body of K2 (decompress.cu) and K3
//   (fused_score.cu), which differ only in where a passage's rows come from.
//
// All float32 arithmetic uses __fmul_rn / __fadd_rn so that nvcc cannot
// contract a multiply and an add into one FMA: the plain versions round
// after every operation, and so must the kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace plaid {

constexpr float kNeg = -1e4f;  // repro_torch.constants.NEG
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_tree_sum(float v) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, w));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, w));
  return v;
}

// Bucket index v (0 = most significant) of one packed residual byte.
__device__ __forceinline__ unsigned unpack_field(unsigned byte, int nbits, int v) {
  const int vpb = 8 / nbits;
  return (byte >> ((vpb - 1 - v) * nbits)) & ((1u << nbits) - 1u);
}

// One packed residual byte -> 8/nbits reconstructed dims:
// dst[v] = cent[v] + weights[field v], fields taken MSB-first.
__device__ __forceinline__ void reconstruct_byte(const float* __restrict__ cent,
                                                 const float* __restrict__ weights,
                                                 unsigned byte, int nbits,
                                                 float* __restrict__ dst) {
  const int vpb = 8 / nbits;
  for (int v = 0; v < vpb; ++v) {
    const unsigned idx = unpack_field(byte, nbits, v);
    dst[v] = __fadd_rn(__ldg(cent + v), __ldg(weights + idx));
  }
}

// Tokens reconstructed per shared-memory tile, and the block shape the
// score_doc kernels are launched with.
constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQPerThread = 8;  // nq <= kWarps * kMaxQPerThread = 64

// Shared memory score_doc needs: q tile + token tile (rows padded to d+1
// floats so a warp reading 32 tokens' dim j hits 32 banks) + per-query max.
inline size_t score_doc_smem_bytes(int nq, int d) {
  return sizeof(float) * ((size_t)(nq + kTile) * (d + 1) + nq);
}

// Copy lane b's (nq, d) query tile into shared memory (row stride d+1).
__device__ __forceinline__ void load_query_tile(const float* __restrict__ q, int nq,
                                                int d, float* __restrict__ q_s) {
  for (int i = threadIdx.x; i < nq * d; i += blockDim.x)
    q_s[(i / d) * (d + 1) + i % d] = q[i];
}

// Exact MaxSim of one passage against the block's query tile:
//   sum_i q_mask[i] * max_{t valid} (centroids[code_t] + weights[idx_t]) . q_i
// (NEG where no token is valid).  Rows 0..len-1 are scanned; `valid` may be
// null (every scanned row is valid).  Returns the score in thread 0.
// Thread layout: lane = token within a tile, warp w owns queries w, w+8, ...
__device__ float score_doc(const float* __restrict__ q_s,
                           const float* __restrict__ q_mask,
                           const int* __restrict__ codes,
                           const uint8_t* __restrict__ packed,
                           const bool* __restrict__ valid, int len,
                           const float* __restrict__ centroids,
                           const float* __restrict__ weights, int nq, int d,
                           int pd, int nbits, float* __restrict__ e_s,
                           float* __restrict__ mx_s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int stride = d + 1, vpb = 8 / nbits;
  float m[kMaxQPerThread];
#pragma unroll
  for (int k = 0; k < kMaxQPerThread; ++k) m[k] = kNeg;

  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int tn = min(kTile, len - t0);
    int any = 0;
    if (tid < tn) any = valid ? (int)valid[t0 + tid] : 1;
    if (!__syncthreads_or(any)) continue;  // block-uniform skip of empty tiles
    for (int s = tid; s < tn * pd; s += blockDim.x) {
      const int t = s / pd, j = s - t * pd;
      int code = codes[t0 + t];
      code = code < 0 ? 0 : code;
      const unsigned byte = packed[(int64_t)(t0 + t) * pd + j];
      reconstruct_byte(centroids + (int64_t)code * d + j * vpb, weights, byte,
                       nbits, e_s + t * stride + j * vpb);
    }
    __syncthreads();
    if (lane < tn && (valid == nullptr || valid[t0 + lane])) {
      const float* e = e_s + lane * stride;
#pragma unroll
      for (int k = 0; k < kMaxQPerThread; ++k) {
        const int qi = warp + k * kWarps;
        if (qi < nq) {
          const float* qv = q_s + qi * stride;
          float s = 0.f;
          for (int j = 0; j < d; ++j) s = __fadd_rn(s, __fmul_rn(e[j], qv[j]));
          m[k] = fmaxf(m[k], s);
        }
      }
    }
    __syncthreads();  // the next tile overwrites e_s
  }

#pragma unroll
  for (int k = 0; k < kMaxQPerThread; ++k) {
    const int qi = warp + k * kWarps;
    const float v = warp_max(m[k]);
    if (lane == 0 && qi < nq) mx_s[qi] = v;
  }
  __syncthreads();
  float total = 0.f;
  if (warp == 0) {
    for (int g = 0; g < nq; g += 32) {
      const int qi = g + lane;
      float v = qi < nq ? __fmul_rn(mx_s[qi], q_mask[qi]) : 0.f;
      v = warp_tree_sum(v);
      total = g == 0 ? v : __fadd_rn(total, v);
    }
  }
  return total;
}

// Raise the dynamic shared-memory cap of `kernel` when `bytes` needs it.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace plaid
