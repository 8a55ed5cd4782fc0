"""Issue rates of the instructions the tensor-core conv kernels are built
from, on the card alone (no conv, no memory traffic):

    python -m stroke_prediction_tpu_torch.bench.mma_rate

* ``mma.sync.m16n8k8`` tf32 (the float32 kernels' 3xTF32 products) and
  ``mma.sync.m16n8k16`` bf16 (the bfloat16 kernels'): each warp issues 8
  independent accumulator chains in a loop;
* ``ld.shared.b32``, conflict-free (the float32 dW fragments' reads).

Each at one block per SM of 4, 8, 9 (the dW kernels' block) and 16 warps,
and two blocks of 8.  Prints the card's name and power limit, then per
case the instructions per second per SM and the rate they make (TFLOP/s,
or bytes per second per SM).  The source is compiled by ``nvcc`` for
``sm_90a`` into ``build/mma_rate/`` beside the package.  Exits non-zero
without a CUDA card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

SOURCE = r"""
#include <cuda_runtime.h>

#define MMA_LOOP(INSTR)                                                      \
  unsigned a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2,            \
                   threadIdx.x + 3};                                         \
  unsigned b[2] = {threadIdx.x * 3u, threadIdx.x * 5u};                      \
  float d[8][4] = {};                                                        \
  for (int i = 0; i < iters; ++i) {                                          \
    _Pragma("unroll") for (int j = 0; j < 8; ++j) asm volatile(              \
        INSTR " {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"     \
        : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])         \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1])); \
  }                                                                          \
  float s = 0.f;                                                             \
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];    \
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;

__global__ void tf32_kernel(float* out, int iters) {
  MMA_LOOP("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32")
}

__global__ void bf16_kernel(float* out, int iters) {
  MMA_LOOP("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32")
}

// 16 conflict-free ld.shared.b32 a loop step (the lanes read 32
// consecutive words), volatile so that none is merged with another
__global__ void lds_kernel(float* out, int iters) {
  __shared__ float buf[4096];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) buf[i] = i;
  __syncthreads();
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(buf));
  const int at = threadIdx.x % 32;
  float s = 0.f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float v;
      asm volatile("ld.shared.b32 %0, [%1];\n"
                   : "=f"(v)
                   : "r"(base + 4u * ((at + 32 * j + i) & 4095)));
      s += v;
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int run(int which, float* out, int blocks, int threads,
                   int iters) {
  if (which == 0) {
    tf32_kernel<<<blocks, threads>>>(out, iters);
  } else if (which == 1) {
    bf16_kernel<<<blocks, threads>>>(out, iters);
  } else {
    lds_kernel<<<blocks, threads>>>(out, iters);
  }
  return cudaGetLastError();
}
"""

# (name, kernel, FLOPs an instruction, instructions a loop step a warp)
CASES = (("mma.sync.m16n8k8 tf32", 0, 2 * 16 * 8 * 8, 8),
         ("mma.sync.m16n8k16 bf16", 1, 2 * 16 * 8 * 16, 8),
         ("ld.shared.b32", 2, 0, 16))
SHAPES = ((4, 1), (8, 1), (9, 1), (16, 1), (8, 2))   # warps, blocks per SM
ITERS = 2000


def build():
    from stroke_prediction_tpu_torch.ops import _build

    out = _build.BUILD_DIR.parent / "mma_rate"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "mma_rate.cu", out / "libmma_rate.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
                   check=True)
    fn = ctypes.CDLL(str(lib)).run
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_rate: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    run = build()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(n_sm * 2 * 16 * 32, device="cuda")
    for name, which, flop, per_step in CASES:
        for warps, per_sm in SHAPES:
            args = (which, out.data_ptr(), n_sm * per_sm, 32 * warps)
            if run(*args, 10):
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = run(*args, ITERS)
            end.record()
            end.synchronize()
            if err:
                raise RuntimeError(f"{name}: launch failed")
            ms = start.elapsed_time(end)
            n = n_sm * per_sm * warps * ITERS * per_step
            rate = (f"{n * flop / ms / 1e9:.1f} TFLOP/s" if flop else
                    f"{n * 128 / ms / 1e6 / n_sm:.1f} GB/s per SM")
            print(f"{name}: {warps} warps x {per_sm} block(s) per SM: "
                  f"{ms:.4f} ms, {n / ms / 1e6 / n_sm:.4f} G instructions/s "
                  f"per SM, {rate}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
