// float32 weight and bias gradients of the 3x3x3 stride-1 convolution
// y = act(conv3d(x, k) + b) on the CUDA cores (kernel K4 of the port,
// float32 storage), and the plan of every fused or dW-only pass.
//
// Replaces the TPU kernel of stroke_prediction_tpu/ops/pallas/s2d.py
//   K4  conv3x3_bwd_dw_f32 <- _dw_kernel + _dw_taps (dW alone: the weight
//                             half of the split backward, and the entry
//                             conv, whose input is data: no dx; the
//                             bfloat16 K4 is conv3x3_bwd_dw_tc.cu, on the
//                             tensor cores)
// and the db reduction that _s2d_conv_bwd did in XLA.  (The fused K2 is
// conv3x3_bwd_f32_tc.cu for float32, in 3xTF32, and conv3x3_bwd_tc.cu for
// bfloat16; K3, dx alone, is conv3x3_bwd_dx_f32_tc.cu and
// conv3x3_bwd_dx_tc.cu; all on the tensor cores.)  The math is carried
// over, not the s2d cell layout, superpatch weights or tap-table
// fold-back:
//
//   g'           = g * act'(y)   (from the saved OUTPUT: LeakyReLU 1 / alpha,
//                                 ELU 1 / y + alpha, none 1)
//   dk[t, i, o]  = sum_{b,z,h,w} x[z + tz - p, h + ty, w + tx, i] * g'[.., o]
//   db[o]        = sum g'[.., o]   (or db[z, o] per output plane for the
//                                   z-SAME plane table)
// over NDHWC float32 tensors, p = z_pad (0 'v', 1 's'), out-of-range terms
// zero; g' and every sum are float32; dk and db are float32
// (s2d.py:943-944).
//
// Design:
//   * A block of 128 threads owns a tile of 4 rows x 32 columns of one
//     output depth plane of one sample.  Per channel tile of 16 it stages
//     in shared memory, as float32 with a padded channel stride of 20
//     (conflict-free float4 reads):
//       - the tile's own g' plane, 1 plane x 6 x 34 voxels, formed here
//         from g and y: no separate pass writes it;
//       - the x region, 3 planes x 6 x 34 voxels (every input voxel that
//         the tile's outputs read).
//   * dW: the 27 x C_in x C_out block is cut into micro-tiles of one tap x
//     4 input x 4 output channels; each thread owns micro-tiles, sums one
//     over the tile's 128 voxels in registers and adds it to the block's
//     private float32 partial in device memory.  Blocks are persistent (as
//     many as fit on the card) and walk the tiles in a fixed order; a second
//     launch sums the per-block partials in block order.  No float atomics:
//     dW is bit-identical from run to run on the same card.
//   * db: each tile writes its per-channel sums of g'; a last launch sums
//     them in tile order (per output plane for the table).
//
// Bound on the H100: 2 * 27 * C_in * C_out FLOPs per output voxel at the
// float32 CUDA-core rate (67 TFLOP/s), since this version does not use the
// tensor cores; the bytes (x, y, g read once) are far below that at the
// U-Net's widths.

#include <cuda_runtime.h>

#include "common.cuh"
#include "conv3x3_bwd.cuh"

namespace {

using stroke::cotangent;
using stroke::Geo;

constexpr int kTH = 4;                 // tile rows
constexpr int kTW = 32;                // tile columns
constexpr int kThreads = kTH * kTW;    // one thread per tile voxel
constexpr int kRH = kTH + 2;           // halo region rows
constexpr int kRW = kTW + 2;           // halo region columns
constexpr int kPlane = kRH * kRW;      // voxels of one region plane
constexpr int kCT = 16;                // channel tile
constexpr int kCS = 20;                // staged channel stride (floats)

Geo make_geo(int batch, int d_in, int h, int w, int c_in, int c_out,
             int z_pad) {
  return stroke::make_geo(batch, d_in, h, w, c_in, c_out, z_pad, false, kTH,
                          kTW);
}

constexpr size_t kSmemBytes =
    sizeof(float) * ((size_t)kPlane * kCS          // the own g' plane
                     + (size_t)3 * kPlane * kCS);  // x region

// dW and the db partials of an output-space tile.
__global__ void __launch_bounds__(kThreads)
conv3x3_bwd_dw_f32_kernel(const float* __restrict__ x,
                          const float* __restrict__ y,
                          const float* __restrict__ g,
                          float* __restrict__ part, float* __restrict__ dbp,
                          Geo geo, int act, float alpha) {
  extern __shared__ float4 smem4[];
  float* gc = reinterpret_cast<float*>(smem4);          // the own g' plane
  float* xs = gc + kPlane * kCS;                        // x region

  const int tid = threadIdx.x;
  const int c_in = geo.c_in, c_out = geo.c_out, p = geo.z_pad;
  const int n_cit = (c_in + kCT - 1) / kCT, n_cot = (c_out + kCT - 1) / kCT;
  const long long dw_size = 27LL * c_in * c_out;
  float* my_part = part + blockIdx.x * dw_size;
  for (long long i = tid; i < dw_size; i += kThreads) my_part[i] = 0.f;
  __syncthreads();  // zeros visible before the owners add to them

  for (long long tile = blockIdx.x; tile < geo.n_tiles; tile += gridDim.x) {
    long long r = tile;
    const int tw = (int)(r % geo.n_tw);
    r /= geo.n_tw;
    const int th = (int)(r % geo.n_th);
    r /= geo.n_th;
    const int z = (int)(r % geo.tile_d);
    const int b = (int)(r / geo.tile_d);
    const int h0 = th * kTH, w0 = tw * kTW;

    for (int cit = 0; cit < n_cit; ++cit) {
      const int ci0 = cit * kCT, ci_n = min(kCT, c_in - ci0);

      for (int cot = 0; cot < n_cot; ++cot) {
        const int co0 = cot * kCT, co_n = min(kCT, c_out - co0);
        __syncthreads();  // every thread is done with the previous staging

        // the own g' plane oz = z, rows oh = h0 - 2 + rh, columns
        // ow = w0 - 2 + rw (the tile's voxels at rh, rw >= 2)
        for (int e = tid; e < kPlane * kCT; e += kThreads) {
          const int c = e % kCT, vox = e / kCT;
          const int rw = vox % kRW, rh = vox / kRW;
          const int oh = h0 - 2 + rh, ow = w0 - 2 + rw;
          float v = 0.f;
          if (c < co_n && oh >= 0 && oh < geo.h_out && ow >= 0 &&
              ow < geo.w_out) {
            const long long idx =
                ((((long long)b * geo.d_out + z) * geo.h_out + oh) *
                     geo.w_out + ow) * c_out + co0 + c;
            v = cotangent<float>(__ldg(g + idx), __ldg(y + idx), act,
                                 alpha);
          }
          gc[vox * kCS + c] = v;
        }
        // x region: planes iz = z - p + rz, rows ih = h0 + rh, columns
        // iw = w0 + rw (once per input-channel tile)
        if (cot == 0) {
          for (int e = tid; e < 3 * kPlane * kCT; e += kThreads) {
            const int c = e % kCT, vox = e / kCT;
            const int rw = vox % kRW, rh = (vox / kRW) % kRH;
            const int rz = vox / kPlane;
            const int iz = z - p + rz, ih = h0 + rh, iw = w0 + rw;
            float v = 0.f;
            if (c < ci_n && iz >= 0 && iz < geo.d_in && ih < geo.h &&
                iw < geo.w) {
              v = __ldg(x + ((((long long)b * geo.d_in + iz) * geo.h + ih) *
                                 geo.w + iw) * c_in + ci0 + c);
            }
            xs[vox * kCS + c] = v;
          }
        }
        __syncthreads();

        // db: this tile's per-channel sums of g' (once per tile)
        if (cit == 0 && tid < co_n) {
          float s = 0.f;
          for (int v = 0; v < kThreads; ++v) {
            s += gc[((v / kTW + 2) * kRW + v % kTW + 2) * kCS + tid];
          }
          dbp[tile * c_out + co0 + tid] = s;
        }
        // dW micro-tiles: one tap x 4 input x 4 output channels
        const int niq = (ci_n + 3) / 4, noq = (co_n + 3) / 4;
        const int n_mt = 27 * niq * noq;
        for (int mt = tid; mt < n_mt; mt += kThreads) {
          const int oq = mt % noq, iq = (mt / noq) % niq;
          const int t = mt / (noq * niq);
          const int tz = t / 9, ty = (t / 3) % 3, tx = t % 3;
          float a[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int o = 0; o < 4; ++o) a[i][o] = 0.f;
          const float* xb = xs + (tz * kRH + ty) * kRW * kCS + tx * kCS +
                            4 * iq;
          const float* gb = gc + (2 * kRW + 2) * kCS + 4 * oq;
          for (int vy = 0; vy < kTH; ++vy) {
            for (int vx = 0; vx < kTW; ++vx) {
              const float4 xv = *reinterpret_cast<const float4*>(
                  xb + (vy * kRW + vx) * kCS);
              const float4 gv = *reinterpret_cast<const float4*>(
                  gb + (vy * kRW + vx) * kCS);
              const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
              const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int o = 0; o < 4; ++o)
                  a[i][o] = fmaf(xa[i], ga[o], a[i][o]);
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int ci = ci0 + 4 * iq + i;
#pragma unroll
            for (int o = 0; o < 4; ++o) {
              const int co = co0 + 4 * oq + o;
              if (ci < c_in && co < c_out) {
                my_part[((long long)t * c_in + ci) * c_out + co] += a[i][o];
              }
            }
          }
        }
      }
    }
  }
}

}  // namespace

// Sizes of the scratch buffers for a fused (with_dx 1) or dW-only (0) pass:
// the number of tiles (db partials: n_tiles x C_out floats) and of dW
// partials (n_blocks x 27 x C_in x C_out floats: one per persistent block,
// or one per chunk of tiles in the bfloat16 dW-only pass).  The fused
// passes are conv3x3_bwd_f32_tc.cu's (float32) and conv3x3_bwd_tc.cu's
// (bfloat16) kernels, the bfloat16 dW-only pass conv3x3_bwd_dw_tc.cu's.
extern "C" int conv3x3_bwd_plan(int with_dx, int bf16, int batch, int d_in,
                                int h, int w, int c_in, int c_out, int z_pad,
                                long long* n_tiles, int* n_blocks) {
  if (with_dx) {
    return bf16 ? stroke::conv3x3_bwd_tc_plan(batch, d_in, h, w, c_in, c_out,
                                              z_pad, n_tiles, n_blocks)
                : stroke::conv3x3_bwd_f32_tc_plan(batch, d_in, h, w, c_in,
                                                  c_out, z_pad, n_tiles,
                                                  n_blocks);
  }
  if (bf16) {
    return stroke::conv3x3_bwd_dw_tc_plan(batch, d_in, h, w, c_in, c_out,
                                          z_pad, n_tiles, n_blocks);
  }
  const Geo geo = make_geo(batch, d_in, h, w, c_in, c_out, z_pad);
  *n_tiles = geo.n_tiles;
  return stroke::persistent_blocks(conv3x3_bwd_dw_f32_kernel, kThreads,
                                   kSmemBytes, geo.n_tiles, n_blocks);
}

// Returns the first failing launch's cudaError_t (0 on success).  The
// caller has checked shapes, dtypes, devices and contiguity, and allocated
// every output and scratch buffer with the plan's sizes.
extern "C" int conv3x3_bwd_dw_f32(const float* x, const float* y,
                                  const float* g, float* dk, float* db,
                                  float* part, float* dbp, int batch,
                                  int d_in, int h, int w, int c_in, int c_out,
                                  int z_pad, int bias_table, int act,
                                  float alpha, int n_blocks, void* stream) {
  const Geo geo = make_geo(batch, d_in, h, w, c_in, c_out, z_pad);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_bwd_dw_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  conv3x3_bwd_dw_f32_kernel<<<n_blocks, kThreads, kSmemBytes, s>>>(
      x, y, g, part, dbp, geo, act, alpha);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return stroke::launch_finalize(part, dbp, dk, db, geo, bias_table, n_blocks,
                                 s);
}
