// Device code shared by the PLAID search kernels (sm_90a).
//
// * warp_tree_sum: the 32-lane butterfly sum.  The plain PyTorch versions
//   reproduce its order exactly (repro_torch.core.scoring.lane_tree_sum),
//   so kernel and plain version agree bit for bit.
// * unpack_field: the counterpart of repro/kernels/decompress.py:25-37
//   `_unpack` -- field v of a packed byte, 8/nbits bucket indices per byte,
//   most-significant bits first.  K2, K3 and K4 (decompress.cu) all unpack
//   with it.
// * maxsim::score_kernel: the exact-MaxSim body of K2 (decompress.cu, and
//   K6, K2 at B = 1) and K3 (fused_score.cu), which differ only in where a
//   passage's rows come from.  Its note follows below.
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

// Bucket index v (0 = most significant) of one packed residual byte.
__device__ __forceinline__ unsigned unpack_field(unsigned byte, int nbits, int v) {
  const int vpb = 8 / nbits;
  return (byte >> ((vpb - 1 - v) * nbits)) & ((1u << nbits) - 1u);
}

// Raise the dynamic shared-memory cap of `kernel` when `bytes` needs it.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ---------------------------------------------------------------------------
// The exact-MaxSim body of K2 / K3 / K6
// ---------------------------------------------------------------------------
//
// Computes, for lane b and finalist slot n,
//   out[b, n] = sum_i q_mask[b, i] * max_{t valid} emb_t . q[b, i]
//   emb_t[j]  = centroids[code_t][j] + weights[field j of packed_t]
// with NEG where the passage has no valid token.
//
// The contract it keeps with the plain versions (kernels/ref.py) and with
// scoring.dot_in_order, on which pid identity between `plaid` and
// `plaid-cuda` rests: emb_t[j] is one __fadd_rn, fields MSB-first; every
// dot product is accumulated for j = 0, 1, ..., d-1 as
// s = __fadd_rn(s, __fmul_rn(e[j], q[j])) from 0.f; the max is exact (taken
// on the order-preserving int image of the float, so its order is free);
// the query sum is __fmul_rn by q_mask and warp_tree_sum over groups of 32
// queries, added in group order.  So the output equals the plain version's
// bit for bit.
//
// Bound on the H100: operations.  2*nq*d f32 operations per valid token
// against ~4 + d*nbits/8 payload bytes.  The card's table counts an FMA as
// two operations at 67 TFLOP/s; the contract forbids FMA, so each term is
// two instructions on the FP32 pipes and the reachable bound is twice the
// table's: ~0.75 ms against 0.376510 at the k=1000 shape (3.07M tokens x
// 32 queries x 128 dims).  No tensor cores: wgmma, mma.sync and TF32 round
// their inputs and sum in an order the hardware sets.
//
// Design.
// * Block = 4 warps, one lane b and G finalist slots (G chosen on the host
//   so that the grid keeps >= 2 waves: kernels/decompress.py
//   passages_per_block; 16 at the k=1000 shape).  The lane's queries are
//   loaded once per block into shared memory, rows padded to nqp = 32 or
//   64 (zeros), row stride S floats with S/4 odd.
// * The block walks the VALID tokens of its G passages as one stream in
//   tiles of kTile = 64, each token tagged with its slot; invalid rows are
//   compacted away (K2: a block scan of tok_valid into a list of rows; K3:
//   the prefix sum of doc_lens).  Only the last tile of a block is ragged.
// * Warp w stages, reconstructs and scores only tokens [16w, 16w+16) of
//   each tile, so each warp runs its own two-buffer pipeline on its own
//   mbarriers and the block meets at a barrier only before the query sum.
//   While tile t is scored, owner lane i bulk-copies token i of tile t+1
//   (its centroid row, gathered by code, and its packed row) with the TMA
//   engine (cp.async.bulk, one 1-D copy a row: Hopper's TMA has no row
//   gather), and the codes of tile t+2 load into registers.  Then lane c
//   adds the weights to float4 column c of the landed rows in place (one
//   __fadd_rn a dim).  Rows that are not 16-byte multiples, or d > 128,
//   take a generic path: plain loads, reconstructed at once.
// * Scoring, register-tiled on the CUDA cores: lane = qg + 8*tg owns
//   tokens 16w + tg + 4k (k < 4) and queries qg + 8l (l < QPT = nqp/8),
//   4 x QPT independent accumulators.  Per 4 dims it loads 4 + QPT float4
//   from shared memory (row-major [token][dim] and [query][dim]; with S/4
//   odd a warp's loads hit distinct banks) and issues 16*QPT __fmul_rn and
//   as many __fadd_rn: 16 FP32 instructions a shared load, where the
//   one-dot-a-thread body had one (SASS: 256 of the unrolled loop's 294
//   instructions are FMUL/FADD, no FFMA).
// * Each thread folds its 4 tokens' scores per slot and atomicMax-es the
//   order-preserving int image into a (slot, query) table in shared memory;
//   one warp per slot finishes the q_mask sum.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; nvcc 12.9, ptxas -v): 90-94
// registers at nq <= 32 and 108-117 at nq <= 64, 0 spills; shared memory
// 100.5 KB (K2) / 91.4 KB (K3) a block at nq 32, d 128, nbits 2, G 16, so
// 2 blocks (8 warps) an SM by the occupancy API.  At the k=1000 shape the
// loop alone (launch/maxsim_loop.py) holds 76-77% of 132 x 128 lanes x
// 1.98 GHz from 8 to 16 warps an SM: a floor near 1.0 ms for the ~25G lane
// operations.  PERF.md has the kernels' times and where the rest goes.
namespace maxsim {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                     // tokens per stage
constexpr int kTokPerWarp = kTile / kWarps;   // 16: staged, reconstructed, scored by one warp
constexpr int kQGroups = 8;                   // lanes along the query axis
constexpr int kMaxSlots = 32;                 // G <= 32 (one warp scans K3's lens)

struct Args {
  const float* q;            // (B, nq, d)
  const float* q_mask;       // (B, nq)
  const int* codes;          // K2: (B, nd, L); K3: (Nt,)
  const uint8_t* packed;     // K2: (B, nd, L, pd); K3: (Nt, pd)
  const bool* tok_valid;     // K2: (B, nd, L); K3: unused
  const int* final_pids;     // K3: (B, nd), -1 pad; K2: unused
  const int* doc_offsets;    // K3: (Nd + 1,)
  const int* doc_lens;       // K3: (Nd,)
  const float* centroids;    // (K, d)
  const float* weights;      // (2^nbits,)
  float* out;                // (B, nd)
  int nq, d, pd, nd, L, G;   // L: K2's rows a block (0 for K3)
  int tma;                   // rows go by bulk copy (16-byte multiples, aligned)
};

__host__ __device__ inline int row_stride(int d) {
  const int a = (d + 3) / 4;  // float4 columns
  return 4 * (a % 2 == 0 ? a + 1 : a + 2);
}

// Byte offsets of the dynamic shared memory (q, e and bytes 16-byte
// aligned, the (buffer, warp) mbarriers 8-byte aligned).
struct Layout {
  size_t q, e, bytes, bar, w, mx, slot, list, pre, start, scan, size;
  __host__ __device__ Layout(int nqp, int S, int pdp, int G, int list_len) {
    size_t o = 0;
    q = o;     o += (size_t)nqp * S * 4;
    e = o;     o += (size_t)2 * kTile * S * 4;
    bytes = o; o += (size_t)2 * kTile * pdp;  // pdp: 0, or pd (a multiple of 16)
    bar = o;   o += 2 * kWarps * 8;
    w = o;     o += 16 * 4;
    mx = o;    o += (size_t)G * nqp * 4;
    slot = o;  o += 2 * kTile * 4;
    list = o;  o += (size_t)list_len * 4;
    pre = o;   o += (size_t)(G + 1) * 4;
    start = o; o += (size_t)G * 4;
    scan = o;  o += kWarps * 4;
    size = o;
  }
};

// float -> int with the same order (-0 below +0), and back.
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
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

// A one-dimensional bulk copy by the TMA engine: `bytes` (a multiple of
// 16) from global `src` to shared `dst`, both 16-byte aligned, counted on
// `bar` as they land.  It bypasses the load/store pipes the scoring loop's
// shared loads use.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The packed bits of float4 column c (dims 4c .. 4c+3) of a residual row
// at p: nbits 1, the byte of dims 8(c/2) ..; nbits 2, byte c; nbits 4,
// bytes 2c and 2c+1 as lo | hi << 8.
template <int NBITS>
__device__ __forceinline__ unsigned column_bits(const uint8_t* p, int c) {
  if constexpr (NBITS == 1) return p[c / 2];
  else if constexpr (NBITS == 2) return p[c];
  else return p[2 * c] | (unsigned)p[2 * c + 1] << 8;
}

// Bucket index of dim 4c + v from column c's bits (MSB-first fields).
template <int NBITS>
__device__ __forceinline__ unsigned column_field(unsigned bits, int c, int v) {
  if constexpr (NBITS == 1) return unpack_field(bits, 1, (c & 1) * 4 + v);
  else if constexpr (NBITS == 2) return unpack_field(bits, 2, v);
  else return unpack_field(v < 2 ? bits & 0xffu : bits >> 8, 4, v & 1);
}

__device__ __forceinline__ float component(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

template <int QPT>
__device__ __forceinline__ void mul_add(float (&acc)[4][QPT], const float (&e)[4],
                                        const float (&q)[QPT]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int l = 0; l < QPT; ++l) acc[k][l] = __fadd_rn(acc[k][l], __fmul_rn(e[k], q[l]));
}

// CSR = false: K2 (rows of the gathered (B, nd, L) blocks, valid where
// tok_valid); CSR = true: K3 (rows [doc_offsets[pid], +doc_lens[pid]) of
// the token arrays, pid = final_pids[b, n]).  Grid (ceil(nd / G), B).
template <int NBITS, int QPT, bool CSR>
__global__ void __launch_bounds__(kThreads, 2) score_kernel(const Args a) {
  constexpr int kNqp = kQGroups * QPT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * a.G;
  const int G = min(a.G, a.nd - n0);  // this block's slots
  const int S = row_stride(a.d), pdp = a.tma ? a.pd : 0;
  const Layout lay(kNqp, S, pdp, a.G, CSR ? 0 : a.G * a.L);
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  float* e_s = reinterpret_cast<float*>(smem + lay.e);
  uint8_t* by_s = smem + lay.bytes;
  uint64_t* bar_s = reinterpret_cast<uint64_t*>(smem + lay.bar);
  float* w_s = reinterpret_cast<float*>(smem + lay.w);
  int* mx_s = reinterpret_cast<int*>(smem + lay.mx);
  int* slot_s = reinterpret_cast<int*>(smem + lay.slot);
  int* list_s = reinterpret_cast<int*>(smem + lay.list);
  int* pre_s = reinterpret_cast<int*>(smem + lay.pre);
  int* start_s = reinterpret_cast<int*>(smem + lay.start);
  int* scan_s = reinterpret_cast<int*>(smem + lay.scan);
  const int64_t slot0 = (int64_t)blockIdx.y * a.nd + n0;  // (b, n0) flattened

  // ---- set-up: queries, weights, the (slot, query) maxima, the stream ----
  const float* qb = a.q + (int64_t)blockIdx.y * a.nq * a.d;
  if (a.tma) {  // d % 4 == 0 and q 16-byte aligned: float4 columns
    const int c4 = S / 4;
    for (int i = tid; i < kNqp * c4; i += kThreads) {
      const int r = i / c4, c = i - r * c4;
      reinterpret_cast<float4*>(q_s)[i] =
          r < a.nq && 4 * c < a.d ? __ldg(reinterpret_cast<const float4*>(qb + r * a.d) + c)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int r = warp; r < kNqp; r += kWarps)
      for (int j = lane; j < S; j += 32)
        q_s[r * S + j] = (r < a.nq && j < a.d) ? __ldg(qb + (int64_t)r * a.d + j) : 0.f;
  }
  if (tid < (1 << NBITS)) w_s[tid] = __ldg(a.weights + tid);
  if (tid < 2 * kWarps) mbar_init(bar_s + tid, 1);  // (buffer, warp): lane 0's arrival
  if (tid == 0) asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  for (int i = tid; i < G * kNqp; i += kThreads) mx_s[i] = ordered(kNeg);

  int total;  // valid tokens of the block's G passages
  if constexpr (CSR) {
    if (warp == 0) {
      int len = 0, start = 0;
      if (lane < G) {
        const int pid = a.final_pids[slot0 + lane];
        if (pid >= 0) {
          len = a.doc_lens[pid];
          start = a.doc_offsets[pid];
        }
      }
      int incl = len;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      if (lane < G) {
        pre_s[lane + 1] = incl;
        start_s[lane] = start;
      }
      if (lane == 0) pre_s[0] = 0;
    }
    __syncthreads();
    total = pre_s[G];
  } else {
    // compact the valid rows of the G passages' L-row windows into list_s
    const int nflags = G * a.L;
    const bool* vb = a.tok_valid + slot0 * a.L;
    const int per = (nflags + kThreads - 1) / kThreads;
    const int beg = min(tid * per, nflags), end = min(beg + per, nflags);
    int cnt = 0;
    for (int x = beg; x < end; ++x) cnt += vb[x] ? 1 : 0;
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) scan_s[warp] = incl;
    __syncthreads();
    int pos = incl - cnt;
    total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      pos += w < warp ? scan_s[w] : 0;
      total += scan_s[w];
    }
    for (int x = beg; x < end; ++x)
      if (vb[x]) list_s[pos++] = x;
    __syncthreads();
  }

  // ---- per-tile steps ----------------------------------------------------
  // Owner lanes (lane < 16) of warp w resolve token 16w + lane of a tile:
  // its row in the token arrays, its slot (-1 past the stream's end) and
  // its centroid code (a load left in flight until the tile is staged).
  auto fetch = [&](int tile, int& code, int64_t& row, int& slot) {
    const int p = tile * kTile + warp * kTokPerWarp + lane;
    code = 0;
    row = 0;
    slot = -1;
    if (lane < kTokPerWarp && p < total) {
      if constexpr (CSR) {
        int s = 0;
        while (pre_s[s + 1] <= p) ++s;
        slot = s;
        row = (int64_t)start_s[s] + (p - pre_s[s]);
      } else {
        const int local = list_s[p];
        slot = local / a.L;
        row = slot0 * a.L + local;
      }
      code = __ldg(a.codes + row);
    }
  };
  // Warp w stages tokens [16w, 16w+16) of a tile into buffer `buf`: owner
  // lane i bulk-copies token i's centroid row and packed row (the TMA
  // path), tags it with its slot, and lane 0 arms the buffer's mbarrier
  // with the warp's bytes.  Other widths are reconstructed at once with
  // plain loads (the generic path).
  constexpr int kVpb = 8 / NBITS;
  auto issue = [&](int buf, int code, int64_t row, int slot) {
    const int t0 = buf * kTile + warp * kTokPerWarp;
    const int n = __popc(__ballot_sync(kFull, lane < kTokPerWarp && slot >= 0));
    if (lane < kTokPerWarp) slot_s[t0 + lane] = slot;
    const float* cent = a.centroids + (int64_t)max(code, 0) * a.d;
    const uint8_t* pk = a.packed + row * a.pd;
    if (a.tma) {
      // this warp's generic accesses to its rows precede the copies
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      uint64_t* bar = bar_s + buf * kWarps + warp;
      if (lane == 0) mbar_expect_tx(bar, (unsigned)n * (a.d * 4 + a.pd));
      __syncwarp();
      if (lane < n) {
        bulk_copy(e_s + (size_t)(t0 + lane) * S, cent, a.d * 4, bar);
        bulk_copy(by_s + (size_t)(t0 + lane) * a.pd, pk, a.pd, bar);
      }
      return;
    }
    for (int i = 0; i < n; ++i) {
      const float* c = a.centroids + (int64_t)max(__shfl_sync(kFull, code, i), 0) * a.d;
      const uint8_t* p = a.packed + __shfl_sync(kFull, row, i) * a.pd;
      float* e = e_s + (size_t)(t0 + i) * S;
      for (int j = lane; j < a.d; j += 32)
        e[j] = __fadd_rn(__ldg(c + j), w_s[unpack_field(__ldg(p + j / kVpb), NBITS, j % kVpb)]);
    }
  };
  // TMA path: wait for the buffer, then emb = centroid + weight in place
  // (one __fadd_rn a dim); lane c owns float4 column c of the warp's rows.
  auto reconstruct = [&](int buf, unsigned parity) {
    if (!a.tma) return;
    mbar_wait(bar_s + buf * kWarps + warp, parity);
    const int t0 = buf * kTile + warp * kTokPerWarp;
    const int n = __popc(__ballot_sync(kFull, lane < kTokPerWarp && slot_s[t0 + lane] >= 0));
    if (lane >= a.d / 4) return;
#pragma unroll
    for (int i = 0; i < kTokPerWarp; ++i) {
      if (i >= n) break;
      float4* e = reinterpret_cast<float4*>(e_s + (size_t)(t0 + i) * S) + lane;
      const unsigned bits = column_bits<NBITS>(by_s + (size_t)(t0 + i) * a.pd, lane);
      float4 v = *e;
      v.x = __fadd_rn(v.x, w_s[column_field<NBITS>(bits, lane, 0)]);
      v.y = __fadd_rn(v.y, w_s[column_field<NBITS>(bits, lane, 1)]);
      v.z = __fadd_rn(v.z, w_s[column_field<NBITS>(bits, lane, 2)]);
      v.w = __fadd_rn(v.w, w_s[column_field<NBITS>(bits, lane, 3)]);
      *e = v;
    }
  };
  const int qg = lane % kQGroups, tg = lane / kQGroups;
  const int tok = warp * kTokPerWarp + tg;  // this thread's tokens: tok + 4k
  auto flush = [&](int slot, const int (&m)[QPT]) {
    if (slot < 0) return;
#pragma unroll
    for (int l = 0; l < QPT; ++l)
      if (qg + kQGroups * l < a.nq) atomicMax(mx_s + slot * kNqp + qg + kQGroups * l, m[l]);
  };
  auto score = [&](int buf) {
    const int* sl = slot_s + buf * kTile;
    if (sl[warp * kTokPerWarp] < 0) return;  // the warp's tokens are past the end
    const float* ep = e_s + (size_t)buf * kTile * S + tok * S;
    const float* qp = q_s + qg * S;
    float acc[4][QPT];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int l = 0; l < QPT; ++l) acc[k][l] = 0.f;
    const int d4 = a.d / 4;
#pragma unroll 4
    for (int jc = 0; jc < d4; ++jc) {
      float4 ev[4], qv[QPT];
#pragma unroll
      for (int k = 0; k < 4; ++k) ev[k] = *reinterpret_cast<const float4*>(ep + 4 * k * S + 4 * jc);
#pragma unroll
      for (int l = 0; l < QPT; ++l)
        qv[l] = *reinterpret_cast<const float4*>(qp + kQGroups * l * S + 4 * jc);
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // dims 4jc .. 4jc+3, in order
        float e[4], q[QPT];
#pragma unroll
        for (int k = 0; k < 4; ++k) e[k] = component(ev[k], c);
#pragma unroll
        for (int l = 0; l < QPT; ++l) q[l] = component(qv[l], c);
        mul_add<QPT>(acc, e, q);
      }
    }
    for (int j = 4 * d4; j < a.d; ++j) {  // d % 4 tail, in order
      float e[4], q[QPT];
#pragma unroll
      for (int k = 0; k < 4; ++k) e[k] = ep[4 * k * S + j];
#pragma unroll
      for (int l = 0; l < QPT; ++l) q[l] = qp[kQGroups * l * S + j];
      mul_add<QPT>(acc, e, q);
    }
    // fold the 4 tokens (stream order, so a slot's tokens are adjacent)
    int cur = sl[tok], m[QPT];
#pragma unroll
    for (int l = 0; l < QPT; ++l) m[l] = ordered(acc[0][l]);
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      const int s = sl[tok + 4 * k];
      if (s != cur) {
        flush(cur, m);
        cur = s;
#pragma unroll
        for (int l = 0; l < QPT; ++l) m[l] = ordered(acc[k][l]);
      } else {
#pragma unroll
        for (int l = 0; l < QPT; ++l) m[l] = max(m[l], ordered(acc[k][l]));
      }
    }
    flush(cur, m);
  };

  // ---- the stream: each warp its own pipeline --------------------------
  // Warp w stages, reconstructs and scores only tokens [16w, 16w+16) of
  // each tile, so no block barrier is needed until the query sum.  Tile t
  // sits in buffer t % 2; the warp's mbarrier of that buffer completes
  // phase t / 2 % 2 when the tile's rows have landed.
  const int ntiles = (total + kTile - 1) / kTile;
  int code = 0, slot = -1;
  int64_t row = 0;
  __syncthreads();  // mbarriers initialised
  if (ntiles > 0) {
    fetch(0, code, row, slot);
    issue(0, code, row, slot);
    fetch(1, code, row, slot);
  }
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    reconstruct(buf, (t >> 1) & 1);
    __syncwarp();  // tile t's rows complete; the warp is done with tile t-1's
    if (t + 1 < ntiles) {
      issue(buf ^ 1, code, row, slot);
      fetch(t + 2, code, row, slot);
    }
    score(buf);
  }
  __syncthreads();

  // ---- sum_i q_mask[i] * max_i, one warp a slot --------------------------
  const float* qm = a.q_mask + (int64_t)blockIdx.y * a.nq;
  for (int s = warp; s < G; s += kWarps) {
    float total_s = 0.f;
    for (int g = 0; g < a.nq; g += 32) {
      const int qi = g + lane;
      float v = qi < a.nq ? __fmul_rn(unordered(mx_s[s * kNqp + qi]), __ldg(qm + qi)) : 0.f;
      v = warp_tree_sum(v);
      total_s = g == 0 ? v : __fadd_rn(total_s, v);
    }
    if (lane == 0) a.out[slot0 + s] = total_s;
  }
}

// The largest shared-memory carveout, so that two blocks fit an SM, and
// the dynamic shared memory the instance needs.
template <typename K>
inline cudaError_t prepare(K kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  return err != cudaSuccess ? err : allow_smem(kernel, smem);
}

template <int NBITS, int QPT, bool CSR>
inline int launch_instance(const Args& a, int B, size_t smem, cudaStream_t stream) {
  auto kernel = score_kernel<NBITS, QPT, CSR>;
  const cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.nd + a.G - 1) / a.G, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Blocks of the nbits = 2 instance an SM can hold (the occupancy API).
template <bool CSR>
inline int blocks_per_sm(int nq, int d, int G, int L) {
  const int qpt = nq <= 4 * kQGroups ? 4 : 8;
  const Layout lay(kQGroups * qpt, row_stride(d), d / 4, G, CSR ? 0 : G * L);
  auto kernel = qpt == 4 ? score_kernel<2, 4, CSR> : score_kernel<2, 8, CSR>;
  int n = 0;
  if (prepare(kernel, lay.size) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, lay.size) !=
          cudaSuccess)
    return -1;
  return n;
}

// Checks the shapes the body takes, picks the instance and launches it.
template <bool CSR>
inline int launch(Args a, int B, int nbits, void* stream) {
  if (B == 0 || a.nd == 0) return 0;
  if (a.nq < 1 || a.nq > 8 * kQGroups || a.G < 1 || a.G > kMaxSlots || a.d < 1 ||
      a.L < 0 || a.d * nbits % 8 || (nbits != 1 && nbits != 2 && nbits != 4))
    return (int)cudaErrorInvalidValue;
  a.pd = a.d * nbits / 8;
  a.tma = a.d % 4 == 0 && a.d <= 4 * 32 && a.pd % 16 == 0 && (uintptr_t)a.q % 16 == 0 &&
          (uintptr_t)a.centroids % 16 == 0 && (uintptr_t)a.packed % 16 == 0;
  const int qpt = a.nq <= 4 * kQGroups ? 4 : 8;
  const Layout lay(kQGroups * qpt, row_stride(a.d), a.tma ? a.pd : 0, a.G,
                   CSR ? 0 : a.G * a.L);
  if (lay.size > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nbits * 10 + qpt) {
    case 14: return launch_instance<1, 4, CSR>(a, B, lay.size, s);
    case 18: return launch_instance<1, 8, CSR>(a, B, lay.size, s);
    case 24: return launch_instance<2, 4, CSR>(a, B, lay.size, s);
    case 28: return launch_instance<2, 8, CSR>(a, B, lay.size, s);
    case 44: return launch_instance<4, 4, CSR>(a, B, lay.size, s);
    default: return launch_instance<4, 8, CSR>(a, B, lay.size, s);
  }
}

}  // namespace maxsim
}  // namespace plaid
