// K7: attention with an online softmax (flash attention), causal or not,
// MHA / GQA / MQA, on CUDA cores in float32.
//
// Replaces: src/repro/kernels/flash_attention.py:86 flash_attention
// (kernel body _flash_kernel :30, pallas_call :107).
//
// Computes, for batch b, query head h (KV head h / (H / Hkv)) and row i,
//   out[b, i, h] = sum_j softmax_j(q_i . k_j * dh^-0.5) v_j
// over the keys j < S (j <= i when causal), with the reference's online
// softmax state (m, l, acc) in float32 and out = acc / max(l, 1e-20) cast to
// the input type.  q (B, S, H, dh), k and v (B, S, Hkv, dh), all of one type
// (bf16 or f32), contiguous; any S; dh a multiple of 8 up to 128.
//
// Bound on the H100: for the encoder's bf16 shapes, bytes (q + k + v + o
// once at 3.35 TB/s) against 4 B H S^2 dh operations at the 989 TFLOP/s
// bf16 tensor-core peak.  This first kernel computes in float32 on CUDA
// cores (67 TFLOP/s), so its real limit is those operations; wgmma is a
// later change.
//
// Design: one block of 256 threads per (64 query rows, h, b).  The block
// stages its q tile once, then walks 64-key K/V tiles of the mapped KV head
// through shared memory (converted to f32, head dims zero-padded to 64 or
// 128, ragged keys and rows masked here, not by the caller).  Threads form a
// 16 x 16 grid: thread (ty, tx) holds the scores of rows ty + 16a and keys
// tx + 16c (a, c < 4) and the accumulator of rows ty + 16a and dims
// 4 (16 c4 + tx) + {0..3}.  Each tile is: a 4x4 register-blocked q.k^T from
// float4 shared-memory reads; the row max and sum across tx by shuffles
// (the 16 threads of a row sit in one half-warp); p written to shared
// memory; a register-blocked p.v with p in f32.  When causal, a block stops
// at its last row's key, and only tiles that reach past a row mask it.
#include "plaid_kernels.cuh"

#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per shared-memory tile
constexpr float kNegInit = -1e30f;  // the reference's NEG: initial row max

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int DHP>
constexpr size_t smem_bytes() {
  // q, k, v tiles (row stride DHP + 4 keeps float4 alignment and spreads
  // rows over banks) + the p tile (row stride kBK + 4)
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (DHP + 4) + (size_t)kBQ * (kBK + 4));
}

// Copy rows [r0, r0 + rows) of one head of x (B, S, nh, dh) into a tile of
// DHP f32 columns; rows >= S and columns >= dh become 0.
template <typename T, int DHP>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, int64_t head_base,
                                          int64_t row_stride, int r0, int rows, int S,
                                          int dh, float* __restrict__ dst) {
  for (int e = threadIdx.x; e < rows * DHP; e += kThreads) {
    const int r = e / DHP, d = e - r * DHP;
    float val = 0.f;
    if (r0 + r < S && d < dh) val = to_f32(x[head_base + (int64_t)(r0 + r) * row_stride + d]);
    dst[r * (DHP + 4) + d] = val;
  }
}

template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S, int H,
                       int Hkv, int dh, int causal, float scale) {
  constexpr int kStride = DHP + 4, kPStride = kBK + 4, kC4 = DHP / 64;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kBQ * kStride;
  float* v_s = k_s + kBK * kStride;
  float* p_s = v_s + kBK * kStride;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int64_t q_row = (int64_t)H * dh, kv_row = (int64_t)Hkv * dh;
  const int64_t q_base = (int64_t)b * S * q_row + (int64_t)h * dh;
  const int64_t kv_base = (int64_t)b * S * kv_row + (int64_t)kvh * dh;

  load_tile<T, DHP>(q, q_base, q_row, row0, kBQ, S, dh, q_s);

  float m[4], l[4], acc[4][4 * kC4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInit;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * kC4; ++e) acc[a][e] = 0.f;
  }

  const int hi = causal ? min(S, row0 + kBQ) : S;
  for (int k0 = 0; k0 < hi; k0 += kBK) {
    __syncthreads();  // the previous tile's k_s, v_s, p_s are consumed
    load_tile<T, DHP>(k, kv_base, kv_row, k0, kBK, S, dh, k_s);
    load_tile<T, DHP>(v, kv_base, kv_row, k0, kBK, S, dh, v_s);
    __syncthreads();

    // s = q . k^T over the padded head dims (padding is 0 on both sides)
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DHP; d += 4) {
      float4 qa[4], kc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qa[a] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * a) * kStride + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kc[c] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * c) * kStride + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[a][c] = fmaf(qa[a].x, kc[c].x, s[a][c]);
          s[a][c] = fmaf(qa[a].y, kc[c].y, s[a][c]);
          s[a][c] = fmaf(qa[a].z, kc[c].z, s[a][c]);
          s[a][c] = fmaf(qa[a].w, kc[c].w, s[a][c]);
        }
    }

    // online softmax over this tile, rows ty + 16a; the 16 threads of a
    // row are the 16 lanes of one half-warp (xor offsets < 16)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = row0 + ty + 16 * a;
      bool ok[4];
      float tmax = kNegInit;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + tx + 16 * c;
        ok[c] = key < S && (!causal || key <= row);
        s[a][c] *= scale;
        if (ok[c]) tmax = fmaxf(tmax, s[a][c]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(plaid::kFull, tmax, w));
      const float m_new = fmaxf(m[a], tmax);
      const float corr = expf(m[a] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[a][c] - m_new) : 0.f;
        psum += p;
        p_s[(ty + 16 * a) * kPStride + tx + 16 * c] = p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) psum += __shfl_xor_sync(plaid::kFull, psum, w);
      l[a] = l[a] * corr + psum;
      m[a] = m_new;
#pragma unroll
      for (int e = 0; e < 4 * kC4; ++e) acc[a][e] *= corr;
    }
    __syncthreads();  // p_s complete

    // acc += p . v, p in f32
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pa[a] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * a) * kPStride + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c4 = 0; c4 < kC4; ++c4) {
          const float4 vv = *reinterpret_cast<const float4*>(
              v_s + (j + jj) * kStride + 4 * (16 * c4 + tx));
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float p = jj == 0 ? pa[a].x : jj == 1 ? pa[a].y : jj == 2 ? pa[a].z : pa[a].w;
            acc[a][4 * c4 + 0] = fmaf(p, vv.x, acc[a][4 * c4 + 0]);
            acc[a][4 * c4 + 1] = fmaf(p, vv.y, acc[a][4 * c4 + 1]);
            acc[a][4 * c4 + 2] = fmaf(p, vv.z, acc[a][4 * c4 + 2]);
            acc[a][4 * c4 + 3] = fmaf(p, vv.w, acc[a][4 * c4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = row0 + ty + 16 * a;
    if (row >= S) continue;
    const float inv_l = 1.f / fmaxf(l[a], 1e-20f);
    T* orow = o + q_base + (int64_t)row * q_row;
#pragma unroll
    for (int c4 = 0; c4 < kC4; ++c4)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (16 * c4 + tx) + e;
        if (d < dh) store(orow + d, acc[a][4 * c4 + e] * inv_l);
      }
  }
}

template <typename T, int DHP>
int launch(const T* q, const T* k, const T* v, T* o, int B, int S, int H, int Hkv,
           int dh, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DHP>();
  cudaError_t err = plaid::allow_smem(flash_attention_kernel<T, DHP>, smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)dh));
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, DHP><<<grid, kThreads, smem, stream>>>(q, k, v, o, S, H, Hkv, dh,
                                                                   causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* o, int B, int S, int H, int Hkv,
             int dh, int causal, void* stream) {
  if (dh <= 0 || dh % 8 || dh > 128 || Hkv <= 0 || H % Hkv) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return dh <= 64 ? launch<T, 64>(q, k, v, o, B, S, H, Hkv, dh, causal, s)
                  : launch<T, 128>(q, k, v, o, B, S, H, Hkv, dh, causal, s);
}

}  // namespace

extern "C" int plaid_flash_attention_f32(const float* q, const float* k, const float* v,
                                         float* o, int B, int S, int H, int Hkv, int dh,
                                         int causal, void* stream) {
  return dispatch<float>(q, k, v, o, B, S, H, Hkv, dh, causal, stream);
}

extern "C" int plaid_flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                          const __nv_bfloat16* v, __nv_bfloat16* o, int B,
                                          int S, int H, int Hkv, int dh, int causal,
                                          void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, Hkv, dh, causal, stream);
}
