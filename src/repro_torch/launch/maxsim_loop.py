"""The exact-MaxSim scoring loop of K2/K3 alone, at several occupancies.

    PYTHONPATH=src python -m repro_torch.launch.maxsim_loop [--iters 100000]

Builds (``nvcc``, into the git-ignored ``build/repro_torch/maxsim_loop``)
and runs a kernel that is ``csrc/plaid_kernels.cuh``'s scoring loop and
nothing else: the same 128-thread blocks, the same lane layout (4 tokens x
4 queries a thread), the same float4 shared-memory loads, ``__fmul_rn`` /
``__fadd_rn`` in dimension order, d = 128, nq = 32, unrolled by 4.  Its
dynamic shared memory is sized to hold 2, 3 or 4 blocks an SM.  For each
it prints the time and the lane operations a second (a multiply and an add
a term), as a share of 132 SMs x 128 lanes x 1.98 GHz, and the SM clock
``nvidia-smi`` reads while the loop runs.  So it says what rate the loop can
reach on this card, which no tile staging, tail or set-up slows.  Needs one
card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import threading
import time

from repro_torch.kernels import _build

SOURCE = r"""
#include <cstdio>
#include <cstdlib>
#include <cuda_runtime.h>
__device__ __forceinline__ float component(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}
__global__ void __launch_bounds__(128) loop_kernel(float* out, int iters, int S) {
  extern __shared__ __align__(16) float sm[];
  float* q_s = sm;
  float* e_s = sm + 32 * S;
  for (int i = threadIdx.x; i < (32 + 64) * S; i += blockDim.x) sm[i] = 1.0f + i * 1e-7f;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* ep = e_s + (warp * 16 + lane / 8) * S;
  const float* qp = q_s + (lane % 8) * S;
  float acc[4][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll 4
    for (int jc = 0; jc < 32; ++jc) {
      float4 ev[4], qv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) ev[k] = *reinterpret_cast<const float4*>(ep + 4 * k * S + 4 * jc);
#pragma unroll
      for (int l = 0; l < 4; ++l) qv[l] = *reinterpret_cast<const float4*>(qp + 8 * l * S + 4 * jc);
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int l = 0; l < 4; ++l)
            acc[k][l] = __fadd_rn(acc[k][l], __fmul_rn(component(ev[k], c), component(qv[l], c)));
    }
  }
  float s = 0.f;
  for (int k = 0; k < 4; ++k)
    for (int l = 0; l < 4; ++l) s += acc[k][l];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main(int argc, char** argv) {
  const int S = 132, iters = atoi(argv[1]);
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  float* out;
  cudaMalloc(&out, (size_t)prop.multiProcessorCount * 8 * 128 * 4);
  cudaFuncSetAttribute(loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
  cudaFuncSetAttribute(loop_kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  for (int kb : {100, 72, 54}) {
    const size_t smem = (size_t)kb * 1024;
    int nb = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, loop_kernel, 128, smem);
    const int grid = prop.multiProcessorCount * nb;
    cudaEvent_t a, b;
    cudaEventCreate(&a);
    cudaEventCreate(&b);
    loop_kernel<<<grid, 128, smem>>>(out, 2, S);
    cudaEventRecord(a);
    loop_kernel<<<grid, 128, smem>>>(out, iters, S);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, a, b);
    const double ops = 2.0 * grid * 128.0 * iters * 32 * 4 * 16;
    printf("{\"smem_kb\": %d, \"blocks_per_sm\": %d, \"ms\": %.6f, \"lane_ops_per_s\": %.6e}\n",
           kb, nb, ms, ops / (ms * 1e-3));
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) { fprintf(stderr, "%s\n", cudaGetErrorString(err)); return 1; }
  return 0;
}
"""

PEAK_LANE_OPS = 132 * 128 * 1.98e9  # H100 SXM: SMs x FP32 lanes x boost clock


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=100_000)  # ~0.5 s a case
    args = ap.parse_args(argv)
    out = _build.BUILD_ROOT / "maxsim_loop"
    out.mkdir(parents=True, exist_ok=True)
    src, exe = out / "maxsim_loop.cu", out / "maxsim_loop"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-std=c++17", "-o", str(exe), str(src)], check=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    clocks, done = [], threading.Event()

    def sample():  # the SM clock while the loop runs
        while not done.is_set():
            r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                               capture_output=True, text=True)
            if r.returncode == 0 and r.stdout.strip().isdigit():
                clocks.append(int(r.stdout.strip()))
            time.sleep(0.05)

    sampler = threading.Thread(target=sample)
    sampler.start()
    run = subprocess.run([str(exe), str(args.iters)], capture_output=True, text=True)
    done.set()
    sampler.join()
    if run.returncode:
        raise SystemExit(f"maxsim_loop: {run.stderr}")
    rows = [json.loads(ln) for ln in run.stdout.splitlines()]
    for r in rows:
        r["share_of_peak"] = r["lane_ops_per_s"] / PEAK_LANE_OPS
    print(json.dumps({"maxsim_loop": rows, "sm_clock_mhz_samples": clocks, "smi": smi}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
