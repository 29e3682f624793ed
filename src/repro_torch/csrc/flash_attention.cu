// K7: attention with an online softmax (flash attention), causal or not,
// MHA / GQA / MQA: a bf16 body on the tensor cores (wgmma, TMA) and an f32
// body on CUDA cores.
//
// Replaces: src/repro/kernels/flash_attention.py:86 flash_attention
// (kernel body _flash_kernel :30, pallas_call :107).
//
// Computes, for batch b, query head h (KV head h / (H / Hkv)) and row i,
//   out[b, i, h] = sum_j softmax_j(q_i . k_j * dh^-0.5) v_j
// over the keys j < S (j <= i when causal), with the reference's online
// softmax state (m, l, acc) in float32, initial row max -1e30, and
// out = acc / max(l, 1e-20) cast to the input type.  q (B, S, H, dh), k and
// v (B, S, Hkv, dh), all of one type (bf16 or f32), contiguous; any S; dh a
// multiple of 8 up to 128, zero-padded to 64 or 128 inside the kernel;
// ragged rows and keys are masked here, not by the caller.
//
// Bound on the H100: for the encoder's bf16 shapes, bytes: q + k + v + o
// once at 3.35 TB/s (177 MB, 0.053 ms at B=64, S=180, 48 heads over 12 KV
// heads, dh 64) against 4 B H S^2 dh operations at the 989 TFLOP/s bf16
// tensor-core peak (25.5 GFLOP, 0.026 ms; 51 GFLOP with the three-term
// p.v below, 0.052 ms, still just under the byte bound).
//
// bf16 body (plaid_flash_attention_bf16), one warpgroup per block:
//
// * Rows.  A block owns 64 rows of one KV group: hb query heads of the
//   group (hb the largest power of two dividing H / Hkv, at most 64) times
//   64 / hb positions, row r = (position p0 + r / hb, head h0 + r % hb).
//   Stacking the group's heads along M fills the 64 rows of wgmma at the
//   query shape (S=32, 4 heads a group: 2 full tiles a group, not 4 half
//   empty ones) and wastes at most 64 / hb - 1 rows at a ragged S; K and V
//   are read once per 64 rows.  Grid ((H / Hkv / hb) * ceil(S / (64 / hb)),
//   Hkv, B): 9,216 blocks at the passage shape, 768 at the query shape.
// * Copies.  Q (once) and 64-key K and V tiles arrive by TMA through 4-D
//   tensor maps over (dh, heads, S, B) with 128-byte swizzle, boxes of
//   (64 dims, hb or 1 heads, 64 / hb or 64 positions, 1): rows past S and
//   dims past dh come back as zeros and a box never crosses into the next
//   sequence.  K and V have two stages, each with its own mbarrier, so tile
//   j + 1 is in flight while tile j is multiplied; dh 128 is two 64-dim
//   slabs (a 128-byte swizzle row holds 64 bf16).  The maps are encoded on
//   the host for each call (cuTensorMapEncodeTiled, reached through the
//   runtime's driver entry point, so the library links nothing new) and
//   passed as __grid_constant__ parameters.  TMA needs 16-byte aligned
//   global addresses, so q, k and v must be 16-byte aligned.
// * S = Q K^T: wgmma m64n64k16, A (Q) and B (K) from shared memory, both
//   K-major; bf16 x bf16 products are exact in the f32 accumulators, so
//   only the order of the sum differs from the reference.
// * Online softmax in registers: each thread holds 2 rows x 16 keys of S;
//   masks (-inf) only in a tile that reaches past S or past a causal row;
//   row max and row sum over the 4 lanes of a quad by shuffles; in log2
//   units, p = 2^(s dh^-0.5 log2 e - m) as one fma and one ex2.approx
//   (relative error ~2^-22, far inside the tolerance), l rescaled by
//   corr = 2^(m_old - m_new).
// * O = O corr + P V: the S accumulators are converted in place into
//   register A-operands (the accumulator and A fragments share a layout),
//   p split into three bf16 terms, p_hi = bf16(p), p_mid = bf16(p - p_hi),
//   p_lo = bf16(p - p_hi - p_mid) (each difference exact in f32), and
//   three wgmmas a 16-key step (register A, V as an MN-major B with the
//   transpose bit) sum the tile's P V into fresh f32 accumulators, which
//   are then added to O in IEEE f32 (one fma an element).  The reference
//   keeps p in f32.  One bf16 p puts ~11% of the outputs outside one bf16
//   ulp of it; hi + lo (~2^-18 of p) still puts near-zero outputs of
//   short causal rows outside (about one in a million: atol is 1e-6);
//   three terms (~2^-27 of p, f32's own precision) put none outside
//   (tests/test_torch_flash.py, the emulation tests).  The tensor cores'
//   sums round toward zero, so a chain of wgmmas into O across every tile
//   of an LM row drifts: at S 32,768 (yi-34b's prefill, on an H100)
//   outputs near zero left atol 1e-6 by ~1e-6 (2,774 of 268M, all at
//   positions past 10,000); a tile's chain of 12 wgmmas, summed across
//   tiles in IEEE f32, leaves none.
// * Output: acc * (1 / max(l, 1e-20)) rounded to bf16 and stored from
//   registers, rows past S and dims past dh skipped.
//
// Occupancy.  `nvcc -Xptxas -v` (kernels/_build.py keeps its output;
// chip_smoke.py prints it, PERF.md records it) gave 126 registers at
// dh <= 64 and 142 at dh 128, no spills, before the tile accumulators
// (32 more a thread; the build phase prints today's).  Shared memory is
// 40 KB a block at dh <= 64 (Q, 2 x K, 2 x V tiles of 8 KB) and 80 KB at
// dh 128, each plus 1 KB to align to 1024 bytes.  Registers bound the
// blocks an SM holds at dh <= 64 (4 at 128 a thread, 3 up to 168; shared
// memory would allow 5); at dh 128 shared memory allows 2.  At 4 blocks
// the 132 SMs hold 528 blocks of the encoder's dh 64 at a time: the
// passage shape's 9,216 blocks run in 17.5 waves, and the query shape's
// 768 in 1.45 (its second wave less than half full; there are no more
// rows to spread).
//
// f32 body (plaid_flash_attention_f32): off the main path (the encoder runs
// in bf16), used at the reference's f32 test shapes.  It computes on CUDA
// cores (67 TFLOP/s): one block of 256 threads per (64 query rows, h, b)
// stages its q tile once, then walks 64-key K/V tiles of the mapped KV head
// through shared memory (head dims zero-padded to 64 or 128, ragged keys
// and rows masked).  Threads form a 16 x 16 grid: thread (ty, tx) holds the
// scores of rows ty + 16a and keys tx + 16c (a, c < 4) and the accumulator
// of rows ty + 16a and dims 4 (16 c4 + tx) + {0..3}.  Each tile is: a 4x4
// register-blocked q.k^T from float4 shared-memory reads; the row max and
// sum across tx by shuffles (the 16 threads of a row sit in one half-warp);
// p written to shared memory; a register-blocked p.v with p in f32.  When
// causal, a block stops at its last row's key, and only tiles that reach
// past a row mask it.
#include "plaid_kernels.cuh"

#include <cuda.h>  // CUtensorMap and libcuda's enums; nothing is linked
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per shared-memory tile
constexpr float kNegInit = -1e30f;  // the reference's NEG: initial row max

template <int DHP>
constexpr size_t smem_bytes() {
  // q, k, v tiles (row stride DHP + 4 keeps float4 alignment and spreads
  // rows over banks) + the p tile (row stride kBK + 4)
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (DHP + 4) + (size_t)kBQ * (kBK + 4));
}

// Copy rows [r0, r0 + rows) of one head of x (B, S, nh, dh) into a tile of
// DHP columns; rows >= S and columns >= dh become 0.
template <int DHP>
__device__ __forceinline__ void load_tile(const float* __restrict__ x, int64_t head_base,
                                          int64_t row_stride, int r0, int rows, int S,
                                          int dh, float* __restrict__ dst) {
  for (int e = threadIdx.x; e < rows * DHP; e += kThreads) {
    const int r = e / DHP, d = e - r * DHP;
    float val = 0.f;
    if (r0 + r < S && d < dh) val = x[head_base + (int64_t)(r0 + r) * row_stride + d];
    dst[r * (DHP + 4) + d] = val;
  }
}

template <int DHP>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int S, int H,
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

  load_tile<DHP>(q, q_base, q_row, row0, kBQ, S, dh, q_s);

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
    load_tile<DHP>(k, kv_base, kv_row, k0, kBK, S, dh, k_s);
    load_tile<DHP>(v, kv_base, kv_row, k0, kBK, S, dh, v_s);
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
    float* orow = o + q_base + (int64_t)row * q_row;
#pragma unroll
    for (int c4 = 0; c4 < kC4; ++c4)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (16 * c4 + tx) + e;
        if (d < dh) orow[d] = acc[a][4 * c4 + e] * inv_l;
      }
  }
}

template <int DHP>
int launch(const float* q, const float* k, const float* v, float* o, int B, int S, int H,
           int Hkv, int dh, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DHP>();
  cudaError_t err = plaid::allow_smem(flash_attention_kernel<DHP>, smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)dh));
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<DHP><<<grid, kThreads, smem, stream>>>(q, k, v, o, S, H, Hkv, dh,
                                                                causal, scale);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------------------
// bf16 body: wgmma + TMA
// --------------------------------------------------------------------------
namespace wg {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kRows = 64;      // query rows per block (the M of wgmma)
constexpr int kKeys = 64;      // keys per K/V tile
constexpr int kStages = 2;     // K/V ring depth
constexpr uint32_t kBoxBytes = 64 * 64 * 2;  // one (64 rows, 64 dims) bf16 box

// Every tile is one 8 KB box: 64 rows of 128 bytes, swizzled in 1024-byte
// atoms of 8 rows.  The struct sits on a 1024-byte boundary.
template <int DHP>
struct Smem {
  __nv_bfloat16 q[DHP / 64][64 * 64];
  __nv_bfloat16 k[kStages][DHP / 64][64 * 64];
  __nv_bfloat16 v[kStages][DHP / 64][64 * 64];
  uint64_t bar_q, bar_k[kStages], bar_v[kStages];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory; completion is counted
// on `bar` in bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address >> 4, 8-row groups 1024 bytes apart, layout SWIZZLE_128B.  The
// same 1024 bytes sit in the leading-offset field: K-major swizzled
// operands ignore it, and the MN-major V tile is one 64-wide atom, whose
// k groups are 1024 bytes apart whichever field names that stride.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// 2^x (ex2.approx: relative error ~2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulators across an
// asynchronous wgmma.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define PLAID_ACC32(d)                                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),         \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),      \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define PLAID_D32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64, f32) = [d +] A B, A and B bf16 K-major in shared memory;
// scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PLAID_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : PLAID_ACC32(d)
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

// d (64 x 64, f32) = [d +] A B, A bf16 in registers (the fragment of a
// 64 x 16 tile), B bf16 MN-major in shared memory (transpose bit set);
// scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PLAID_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : PLAID_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}

// A pair of neighbouring keys' p as three bf16 terms, t[0] + t[1] + t[2],
// each packed as one A-fragment register (the lower key in the low half).
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t (&t)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
    t[i] = *reinterpret_cast<const uint32_t*>(&h);
    p0 -= __low2float(h);  // exact: h holds p0's leading bits
    p1 -= __high2float(h);
  }
}

template <int DHP>
__device__ __forceinline__ void load_kv(Smem<DHP>& sm, const CUtensorMap* tk,
                                        const CUtensorMap* tv, int tile, int stage, int kvh,
                                        int b) {
  constexpr int kSlabs = DHP / 64;
  mbar_expect_tx(&sm.bar_k[stage], kSlabs * kBoxBytes);
#pragma unroll
  for (int s = 0; s < kSlabs; ++s)
    tma_load(sm.k[stage][s], tk, &sm.bar_k[stage], 64 * s, kvh, tile * kKeys, b);
  mbar_expect_tx(&sm.bar_v[stage], kSlabs * kBoxBytes);
#pragma unroll
  for (int s = 0; s < kSlabs; ++s)
    tma_load(sm.v[stage][s], tv, &sm.bar_v[stage], 64 * s, kvh, tile * kKeys, b);
}

template <int DHP>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ o, int S, int H, int Hkv, int dh,
                             int causal, int hb, float scale_log2) {
  constexpr int kSlabs = DHP / 64;
  extern __shared__ uint8_t smem_raw[];
  Smem<DHP>& sm = *reinterpret_cast<Smem<DHP>*>(smem_raw +
                                                ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, quad = lane & 3;
  const int pb = kRows / hb;  // positions per block
  const int npc = (S + pb - 1) / pb;
  const int hc = blockIdx.x / npc;
  const int p0 = (blockIdx.x - hc * npc) * pb;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int h0 = kvh * (H / Hkv) + hc * hb;
  const int n_tiles = ((causal ? min(S, p0 + pb) : S) + kKeys - 1) / kKeys;

  if (tid == 0) {
    mbar_init(&sm.bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.bar_k[s], 1);
      mbar_init(&sm.bar_v[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&sm.bar_q, kSlabs * kBoxBytes);
#pragma unroll
    for (int s = 0; s < kSlabs; ++s) tma_load(sm.q[s], &tq, &sm.bar_q, 64 * s, h0, p0, b);
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_kv(sm, &tk, &tv, j, j, kvh, b);
  }

  // this thread's rows: r0 = 16 warp + lane / 4 and r0 + 8, each spread
  // over the 4 lanes of its quad; accumulator element 4 n8 + 2 rr + e is
  // row r0 + 8 rr, column 8 n8 + 2 quad + e
  const int r0 = 16 * warp + (lane >> 2);
  const int pos[2] = {p0 + r0 / hb, p0 + (r0 + 8) / hb};
  float m[2] = {kNegInit, kNegInit}, l[2] = {0.f, 0.f}, corr[2];
  float acc[kSlabs][32], s[32], tile[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) tile[i] = 0.f;
#pragma unroll
  for (int c = 0; c < kSlabs; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

  mbar_wait(&sm.bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const int k0 = j * kKeys;

    // s = q . k^T
    mbar_wait(&sm.bar_k[st], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk)  // 16 dims a step: +32 bytes in a swizzle row
      wgmma_ss(s, sw128_desc(sm.q[kk / 4]) + 2 * (kk % 4),
               sw128_desc(sm.k[st][kk / 4]) + 2 * (kk % 4), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // masks only where the tile reaches past S or, causal, past a row
    if (k0 + kKeys > S || (causal && k0 + kKeys - 1 > p0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i / 4) + 2 * quad + (i & 1);
        if (key >= S || (causal && key > pos[(i >> 1) & 1])) s[i] = -INFINITY;
      }
    }

    // online softmax in log2 units (m = max of s * scale * log2 e), one
    // row half (rr) at a time
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float tmax = kNegInit;
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
        tmax = fmaxf(tmax, fmaxf(s[4 * n8 + 2 * rr], s[4 * n8 + 2 * rr + 1]));
      tmax = fmaxf(tmax, __shfl_xor_sync(plaid::kFull, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(plaid::kFull, tmax, 2));
      const float m_new = fmaxf(m[rr], tmax * scale_log2);
      corr[rr] = ex2(m[rr] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * n8 + 2 * rr + e;
          s[i] = ex2(fmaf(s[i], scale_log2, -m_new));  // masked: 2^-inf = 0
          psum += s[i];
        }
      psum += __shfl_xor_sync(plaid::kFull, psum, 1);
      psum += __shfl_xor_sync(plaid::kFull, psum, 2);
      l[rr] = l[rr] * corr[rr] + psum;
      m[rr] = m_new;
    }

    // p as A fragments, 16 keys a step: register r of step kk holds row
    // half r & 1 and keys 16 kk + 8 (r >> 1) + 2 quad + {0, 1}
    uint32_t pa[3][4][4];  // [term][step][register]
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
        uint32_t t[3];
        split_pair(s[i], s[i + 1], t);
#pragma unroll
        for (int u = 0; u < 3; ++u) pa[u][kk][r] = t[u];
      }

    // tile = p_hi . v + p_mid . v + p_lo . v over this tile's 64 keys, 16
    // (2048 bytes of v) a step, in fresh accumulators; then acc = acc * corr
    // + tile in IEEE f32, one slab at a time.  The tensor cores round their
    // sums toward zero: a chain of wgmmas into acc across all of a long
    // row's tiles (S 32,768: 512 tiles, 6,144 products) drifted ~1e-6 from
    // the exact sum of outputs ~0.05; a chain of 12 within a tile does not.
    mbar_wait(&sm.bar_v[st], parity);
#pragma unroll
    for (int c = 0; c < kSlabs; ++c) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = sw128_desc(sm.v[st][c]) + (uint64_t)(kk * 2048 >> 4);
#pragma unroll
        for (int u = 0; u < 3; ++u) wgmma_rs(tile, pa[u][kk], dv, kk | u);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(tile);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = fmaf(acc[c][i], corr[(i >> 1) & 1], tile[i]);
    }

    __syncthreads();  // every warp is done with stage st
    if (tid == 0 && j + kStages < n_tiles) load_kv(sm, &tk, &tv, j + kStages, st, kvh, b);
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + 8 * rr;
    if (pos[rr] >= S) continue;
    const float inv = 1.f / fmaxf(l[rr], 1e-20f);
    __nv_bfloat16* orow = o + (((int64_t)b * S + pos[rr]) * H + h0 + r % hb) * dh;
#pragma unroll
    for (int c = 0; c < kSlabs; ++c)
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const int d = 64 * c + 8 * n8 + 2 * quad;
        if (d < dh)
          *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
              acc[c][4 * n8 + 2 * rr] * inv, acc[c][4 * n8 + 2 * rr + 1] * inv);
      }
  }
}

#undef PLAID_ACC32
#undef PLAID_D32

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the driver the runtime has loaded (its ABI as
// of CUDA 12.0, where it appeared).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of x (B, S, nh, dh) bf16 as (dh, nh, S, B), boxes of (64 dims,
// heads, 64 / heads positions, 1), 128-byte swizzle, zeros out of range.
// Returns 0, or 1000 + the CUresult.
int make_map(CUtensorMap* map, const void* x, int B, int S, int nh, int dh, int heads) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return 1000 + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)nh, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2, (cuuint64_t)nh * dh * 2,
                                 (cuuint64_t)S * nh * dh * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)heads, (cuuint32_t)(kRows / heads), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

template <int DHP>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           __nv_bfloat16* o, int B, int S, int H, int Hkv, int dh, int causal,
           cudaStream_t stream) {
  const int g = H / Hkv;
  int hb = 1;  // query heads stacked along M
  while (hb < kRows && g % (2 * hb) == 0) hb *= 2;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, B, S, H, dh, hb);
  if (!err) err = make_map(&tk, k, B, S, Hkv, dh, 1);
  if (!err) err = make_map(&tv, v, B, S, Hkv, dh, 1);
  if (err) return err;
  const size_t smem = sizeof(Smem<DHP>) + 1024;  // + room to align to 1024
  err = (int)plaid::allow_smem(flash_attention_kernel_wgmma<DHP>, smem);
  if (err) return err;
  const int npc = (S + kRows / hb - 1) / (kRows / hb);
  const dim3 grid((g / hb) * npc, Hkv, B);
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)dh));  // dh^-0.5 log2 e
  flash_attention_kernel_wgmma<DHP><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, o, S, H, Hkv, dh, causal, hb, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace wg

bool bad_args(int dh, int H, int Hkv) {
  return dh <= 0 || dh % 8 || dh > 128 || Hkv <= 0 || H % Hkv;
}

}  // namespace

extern "C" int plaid_flash_attention_f32(const float* q, const float* k, const float* v,
                                         float* o, int B, int S, int H, int Hkv, int dh,
                                         int causal, void* stream) {
  if (bad_args(dh, H, Hkv)) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return dh <= 64 ? launch<64>(q, k, v, o, B, S, H, Hkv, dh, causal, s)
                  : launch<128>(q, k, v, o, B, S, H, Hkv, dh, causal, s);
}

// Returns a cudaError_t, or 1000 + a CUresult when a tensor map could not
// be encoded (the TMA needs 16-byte aligned q, k, v).
extern "C" int plaid_flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                          const __nv_bfloat16* v, __nv_bfloat16* o, int B,
                                          int S, int H, int Hkv, int dh, int causal,
                                          void* stream) {
  if (bad_args(dh, H, Hkv)) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0) return 0;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dh <= 64 ? wg::launch<64>(q, k, v, o, B, S, H, Hkv, dh, causal, s)
                  : wg::launch<128>(q, k, v, o, B, S, H, Hkv, dh, causal, s);
}
