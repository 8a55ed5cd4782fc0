// One separable squared-EDT pass: out[l, i] = min_j f[l, j] + (i - j)^2.
//
// Replaces the TPU kernel stroke_prediction_tpu/ops/edt.py _parabola_kernel
// (launched by _parabola_pass_pallas).  The min runs over the n real columns
// of each line only, in float32; the caller clamps squared distances of
// site-less lines at _BIG = 1e12 before the first pass, exactly as the JAX
// code does.  (i - j)^2 is an exact float32 integer for n <= 4096, so the
// result equals the plain PyTorch version bit for bit.
//
//   f, out  (n_lines, n) contiguous float32
//
// Design: one block takes kLines consecutive lines and stages them in shared
// memory; each thread computes one output element at a time by scanning the
// line, so the threads of a warp (consecutive i of one line) read f[j] as a
// broadcast.  O(n^2) per line, branch-free.
//
// Bound on the H100: the n^2 add + min per line at the float32 CUDA-core rate
// (67 TFLOP/s, counting add and min as one operation each); the bytes (one
// read and one write of each line) come second at the tester's n = 128.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLines = 8;  // lines per block

__global__ void __launch_bounds__(kThreads)
edt_parabola_kernel(const float* __restrict__ f, float* __restrict__ out,
                    long long n_lines, int n) {
  extern __shared__ float f_s[];  // [kLines][n]
  const long long line0 = (long long)blockIdx.x * kLines;
  const long long left = n_lines - line0;
  const int lines = left < kLines ? (int)left : kLines;
  const int count = lines * n;
  const float* src = f + line0 * n;
  for (int k = threadIdx.x; k < count; k += kThreads) f_s[k] = src[k];
  __syncthreads();

  float* dst = out + line0 * n;
  for (int k = threadIdx.x; k < count; k += kThreads) {
    const int l = k / n;
    const int i = k - l * n;
    const float* fl = f_s + l * n;
    const float fi = (float)i;
    float best = fl[0] + fi * fi;
    for (int j = 1; j < n; ++j) {
      const float d = (float)(i - j);
      best = fminf(best, fl[j] + d * d);
    }
    dst[k] = best;
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  The caller has checked
// shapes, dtypes, devices and contiguity, and allocated out.
extern "C" int edt_parabola_f32(const float* f, float* out, long long n_lines,
                                int n, void* stream) {
  const unsigned blocks = (unsigned)((n_lines + kLines - 1) / kLines);
  const size_t smem = sizeof(float) * kLines * (size_t)n;
  edt_parabola_kernel<<<blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(f, out, n_lines,
                                                             n);
  return cudaGetLastError();
}
