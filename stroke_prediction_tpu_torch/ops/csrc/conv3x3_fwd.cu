// Fused 3x3x3 stride-1 convolution forward: y = act(conv3d(x, k) + b).
//
// Replaces the TPU kernel stroke_prediction_tpu/ops/pallas/s2d.py
// _conv_kernel (launched by _s2d_conv_p, API s2d_conv).  What it computes is
// carried over, not the TPU layout: the s2d 2x2x2 cell packing only existed to
// fill the MXU's 128 lanes, so this kernel runs a direct convolution over
// channels-last NDHWC float32.
//
//   x      (B, D_in, H, W, C_in)    contiguous float32
//   kernel (3, 3, 3, C_in, C_out)   contiguous float32 (BN already folded in)
//   bias   (C_out,) or a per-output-plane (D_out, C_out) table (z-SAME fold)
//   y      (B, D_out, H-2, W-2, C_out)
//   H/W are valid; D is valid (z_pad 0, D_out = D_in - 2) or zero-padded by
//   one plane on each side (z_pad 1, D_out = D_in).  act: 0 none,
//   1 LeakyReLU(alpha), 2 ELU(alpha) with the exp of the clamped value.
//
// Design: each thread owns one output voxel and a tile of kCoTile output
// channels held in registers; it walks the 27 taps x C_in and accumulates in
// float32.  The block stages one kz plane of its C_out tile's weights
// (9 x C_in x kCoTile floats) in shared memory, where every warp reads it as
// a broadcast.  Inputs are read through the read-only cache, four channels
// per load when C_in % 4 == 0.
//
// Bound on the H100: the multiply-adds at the float32 CUDA-core rate
// (67 TFLOP/s), since this version does not use the tensor cores; the bytes
// (each input and output once) are far below that.  A tensor-core implicit
// GEMM (TF32 or bf16) is the later, faster design.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // output voxels per block, one per thread
constexpr int kCoTile = 16;    // output channels per block (registers)

__device__ __forceinline__ float activate(float y, int act, float alpha) {
  if (act == 1) return y > 0.f ? y : alpha * y;
  if (act == 2) return y > 0.f ? y : alpha * (expf(fminf(y, 0.f)) - 1.f);
  return y;
}

// acc[c] += xv * w[c] for the kCoTile channels of one weight row.
__device__ __forceinline__ void fma_row(float (&acc)[kCoTile], float xv,
                                        const float* w) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int q = 0; q < kCoTile / 4; ++q) {
    const float4 wv = w4[q];
    acc[4 * q + 0] = fmaf(xv, wv.x, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(xv, wv.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(xv, wv.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(xv, wv.w, acc[4 * q + 3]);
  }
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
conv3x3_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int batch, int d_in, int h, int w_in, int c_in, int c_out,
                   int d_out, int z_pad, int bias_table, int act,
                   float alpha) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [9][c_in][kCoTile]

  const int h_out = h - 2, w_out = w_in - 2;
  const long long n_vox = (long long)batch * d_out * h_out * w_out;
  const long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int co0 = blockIdx.y * kCoTile;
  const bool active = v < n_vox;
  int ox = 0, oy = 0, oz = 0, ob = 0;
  if (active) {
    long long r = v;
    ox = (int)(r % w_out);
    r /= w_out;
    oy = (int)(r % h_out);
    r /= h_out;
    oz = (int)(r % d_out);
    ob = (int)(r / d_out);
  }

  float acc[kCoTile];
#pragma unroll
  for (int c = 0; c < kCoTile; ++c) acc[c] = 0.f;

  const int slab = 9 * c_in * kCoTile;
  for (int kz = 0; kz < 3; ++kz) {
    __syncthreads();  // every thread is done with the previous plane
    for (int i = threadIdx.x; i < slab; i += kThreads) {
      const int c = i % kCoTile;
      const int row = i / kCoTile;  // (ky * 3 + kx) * c_in + ci
      const int co = co0 + c;
      w_s[i] = co < c_out
                   ? w[((long long)kz * 9 * c_in + row) * c_out + co]
                   : 0.f;
    }
    __syncthreads();
    const int iz = oz + kz - z_pad;
    if (!active || iz < 0 || iz >= d_in) continue;  // padded plane: zeros
    for (int ky = 0; ky < 3; ++ky) {
      for (int kx = 0; kx < 3; ++kx) {
        const float* xp =
            x + ((((long long)ob * d_in + iz) * h + oy + ky) * w_in + ox + kx) *
                    c_in;
        const float* wp = w_s + (ky * 3 + kx) * c_in * kCoTile;
        if (kVec4) {
          for (int ci = 0; ci < c_in; ci += 4) {
            const float4 xv = __ldg(reinterpret_cast<const float4*>(xp + ci));
            fma_row(acc, xv.x, wp + (ci + 0) * kCoTile);
            fma_row(acc, xv.y, wp + (ci + 1) * kCoTile);
            fma_row(acc, xv.z, wp + (ci + 2) * kCoTile);
            fma_row(acc, xv.w, wp + (ci + 3) * kCoTile);
          }
        } else {
          for (int ci = 0; ci < c_in; ++ci) {
            fma_row(acc, __ldg(xp + ci), wp + ci * kCoTile);
          }
        }
      }
    }
  }
  if (!active) return;

  float* yp = y + v * c_out;
  const float* bp = bias + (bias_table ? (long long)oz * c_out : 0);
#pragma unroll
  for (int c = 0; c < kCoTile; ++c) {
    const int co = co0 + c;
    if (co < c_out) yp[co] = activate(acc[c] + bp[co], act, alpha);
  }
}

template <bool kVec4>
cudaError_t launch(const float* x, const float* w, const float* bias, float* y,
                   int batch, int d_in, int h, int w_in, int c_in, int c_out,
                   int d_out, int z_pad, int bias_table, int act, float alpha,
                   cudaStream_t stream) {
  const long long n_vox = (long long)batch * d_out * (h - 2) * (w_in - 2);
  const dim3 grid((unsigned)((n_vox + kThreads - 1) / kThreads),
                  (unsigned)((c_out + kCoTile - 1) / kCoTile));
  const size_t smem = sizeof(float) * 9 * (size_t)c_in * kCoTile;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_fwd_kernel<kVec4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  conv3x3_fwd_kernel<kVec4><<<grid, kThreads, smem, stream>>>(
      x, w, bias, y, batch, d_in, h, w_in, c_in, c_out, d_out, z_pad,
      bias_table, act, alpha);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  The caller has checked
// shapes, dtypes, devices and contiguity, and allocated y.
extern "C" int conv3x3_fwd_f32(const float* x, const float* w,
                               const float* bias, float* y, int batch,
                               int d_in, int h, int w_in, int c_in, int c_out,
                               int z_pad, int bias_table, int act, float alpha,
                               void* stream) {
  const int d_out = d_in - 2 + 2 * z_pad;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = c_in % 4 == 0 &&
                    reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  if (vec4) {
    return launch<true>(x, w, bias, y, batch, d_in, h, w_in, c_in, c_out,
                        d_out, z_pad, bias_table, act, alpha, s);
  }
  return launch<false>(x, w, bias, y, batch, d_in, h, w_in, c_in, c_out,
                       d_out, z_pad, bias_table, act, alpha, s);
}
