// float32 backward of the fused 3x3x3 stride-1 convolution
// y = act(conv3d(x, k) + b) on the CUDA cores (kernels K2 and K4 of the
// port, float32 storage).
//
// Replaces the TPU kernels of stroke_prediction_tpu/ops/pallas/s2d.py:
//   K2  conv3x3_bwd_fused_f32 <- _bwd_kernel  (fused dx + dW in one pass;
//                               the bfloat16 K2 is conv3x3_bwd_tc.cu, on
//                               the tensor cores)
//   K4  conv3x3_bwd_dw_f32   <- _dw_kernel + _dw_taps (dW alone; also the
//                               entry conv, whose input is data: no dx;
//                               the bfloat16 K4 is conv3x3_bwd_dw_tc.cu,
//                               on the tensor cores)
// and the db reduction that _s2d_conv_bwd did in XLA.  (K3, dx alone, is
// conv3x3_bwd_dx_f32_tc.cu for float32 and conv3x3_bwd_dx_tc.cu for
// bfloat16, both on the tensor cores.)  The math is carried over, not the
// s2d cell layout, superpatch weights or tap-table fold-back:
//
//   g'           = g * act'(y)   (from the saved OUTPUT: LeakyReLU 1 / alpha,
//                                 ELU 1 / y + alpha, none 1)
//   dx[z,h,w,i]  = sum_{t,o} g'[z - tz + p, h - ty, w - tx, o] * k[t, i, o]
//   dk[t, i, o]  = sum_{b,z,h,w} x[z + tz - p, h + ty, w + tx, i] * g'[.., o]
//   db[o]        = sum g'[.., o]   (or db[z, o] per output plane for the
//                                   z-SAME plane table)
// over NDHWC float32 tensors, p = z_pad (0 'v', 1 's'), out-of-range terms
// zero; g' and every sum are float32; dk and db are float32
// (s2d.py:943-944).
//
// Design (one tile kernel, two instantiations: K2 with dx, K4 without):
//   * A block of 128 threads owns a tile of 4 rows x 32 columns of one depth
//     plane of one sample, in INPUT coordinates for K2 and OUTPUT
//     coordinates for K4 (the two tilings coincide).  Per channel tile of
//     16 it stages in shared memory, as float32 with a padded channel
//     stride of 20 (conflict-free float4 reads):
//       - the g' halo region, 3 planes x 6 x 34 voxels (dx needs every
//         output voxel that reads the tile's inputs; dW needs the tile's own
//         output plane, which is part of that region; K4 stages that plane
//         alone).  g' is formed here from g and y: no separate pass writes
//         it;
//       - the x region, 3 planes x 6 x 34 voxels (every input voxel that
//         the tile's outputs read);
//       - for dx, one kz plane of the weights (9 x 16 x 16).
//     K2 stages g' once per channel-tile pair and uses it for both halves,
//     the counterpart of _bwd_kernel sharing the cotangent DMA.
//   * dx: one thread per input voxel with 16 input channels in registers,
//     looping over the 27 taps and the output channels.
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
// Which of K2 or K3 + K4 a layer takes is the caller's rule
// (ops/conv3x3.py bwd_route); both instantiations take every shape.
//
// Bound on the H100: dx and dW are each 2 * 27 * C_in * C_out FLOPs per
// output voxel at the float32 CUDA-core rate (67 TFLOP/s), since this
// version does not use the tensor cores; the bytes (x, y, g read once, dx
// written once) are far below that at the U-Net's widths.

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
             int z_pad, bool input_space) {
  return stroke::make_geo(batch, d_in, h, w, c_in, c_out, z_pad, input_space,
                          kTH, kTW);
}

template <bool kDx>
constexpr size_t smem_floats() {
  return (size_t)(kDx ? 3 : 1) * kPlane * kCS      // g' region
         + (size_t)3 * kPlane * kCS                // x region
         + (kDx ? (size_t)9 * kCT * kCT : 0);      // one kz weight plane
}

// acc[c] += gv * w[c] for the kCT input channels of one weight row.
__device__ __forceinline__ void fma_row(float (&acc)[kCT], float gv,
                                        const float* w) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int q = 0; q < kCT / 4; ++q) {
    const float4 wv = w4[q];
    acc[4 * q + 0] = fmaf(gv, wv.x, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(gv, wv.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(gv, wv.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(gv, wv.w, acc[4 * q + 3]);
  }
}

// kDx: K2 (dx and dW of an input-space tile) or K4 (dW of an output-space
// tile).
template <bool kDx>
__global__ void __launch_bounds__(kThreads)
conv3x3_bwd_tile_kernel(const float* __restrict__ x,
                        const float* __restrict__ k,
                        const float* __restrict__ y,
                        const float* __restrict__ g, float* __restrict__ dx,
                        float* __restrict__ part, float* __restrict__ dbp,
                        Geo geo, int act, float alpha) {
  extern __shared__ float4 smem4[];
  float* gs = reinterpret_cast<float*>(smem4);          // g' region
  float* xs = gs + (kDx ? 3 : 1) * kPlane * kCS;        // x region
  float* ws = xs + 3 * kPlane * kCS;                    // weight plane
  // the tile's own output plane inside the g' region
  float* gc = gs + (kDx ? 2 - geo.z_pad : 0) * kPlane * kCS;

  const int tid = threadIdx.x;
  const int ly = tid / kTW, lx = tid % kTW;
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
      float acc[kCT];
#pragma unroll
      for (int c = 0; c < kCT; ++c) acc[c] = 0.f;

      for (int cot = 0; cot < n_cot; ++cot) {
        const int co0 = cot * kCT, co_n = min(kCT, c_out - co0);
        __syncthreads();  // every thread is done with the previous staging

        // g' region: planes oz = z - 2 + p + rz (dx) or oz = z (dW alone),
        // rows oh = h0 - 2 + rh, columns ow = w0 - 2 + rw
        const int n_gplanes = kDx ? 3 : 1;
        const int oz_base = kDx ? z - 2 + p : z;
        for (int e = tid; e < n_gplanes * kPlane * kCT; e += kThreads) {
          const int c = e % kCT, vox = e / kCT;
          const int rw = vox % kRW, rh = (vox / kRW) % kRH;
          const int rz = vox / kPlane;
          const int oz = oz_base + rz, oh = h0 - 2 + rh, ow = w0 - 2 + rw;
          float v = 0.f;
          if (c < co_n && oz >= 0 && oz < geo.d_out && oh >= 0 &&
              oh < geo.h_out && ow >= 0 && ow < geo.w_out) {
            const long long idx =
                ((((long long)b * geo.d_out + oz) * geo.h_out + oh) *
                     geo.w_out + ow) * c_out + co0 + c;
            v = cotangent<float>(__ldg(g + idx), __ldg(y + idx), act,
                                 alpha);
          }
          gs[vox * kCS + c] = v;
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

        if (kDx) {
          for (int tz = 0; tz < 3; ++tz) {
            __syncthreads();  // every thread is done with the previous plane
            // ws[(ty * 3 + tx)][o][c] = k[tz, ty, tx, ci0 + c, co0 + o]
            for (int e = tid; e < 9 * kCT * kCT; e += kThreads) {
              const int c = e % kCT, o = (e / kCT) % kCT, t9 = e / (kCT * kCT);
              ws[e] = (c < ci_n && o < co_n)
                          ? __ldg(k + ((long long)(tz * 9 + t9) * c_in + ci0 +
                                       c) * c_out + co0 + o)
                          : 0.f;
            }
            __syncthreads();
            const int rz = 2 - tz;  // g' plane z - tz + p
            for (int ty = 0; ty < 3; ++ty) {
              for (int tx = 0; tx < 3; ++tx) {
                const float* gp =
                    gs + ((rz * kRH + ly + 2 - ty) * kRW + lx + 2 - tx) * kCS;
                const float* wp = ws + (ty * 3 + tx) * kCT * kCT;
#pragma unroll
                for (int o = 0; o < kCT; o += 4) {
                  const float4 gv = *reinterpret_cast<const float4*>(gp + o);
                  fma_row(acc, gv.x, wp + (o + 0) * kCT);
                  fma_row(acc, gv.y, wp + (o + 1) * kCT);
                  fma_row(acc, gv.z, wp + (o + 2) * kCT);
                  fma_row(acc, gv.w, wp + (o + 3) * kCT);
                }
              }
            }
          }
        }
      }

      if (kDx) {
        const int ih = h0 + ly, iw = w0 + lx;
        if (ih < geo.h && iw < geo.w) {
          float* dp = dx + ((((long long)b * geo.d_in + z) * geo.h + ih) *
                                geo.w + iw) * c_in + ci0;
#pragma unroll
          for (int c = 0; c < kCT; ++c) {
            if (c < ci_n) dp[c] = acc[c];
          }
        }
      }
    }
  }
}

// Launches the tile kernel (K2 with kDx, K4 without) and the two
// reductions that sum its dW and db partials.
template <bool kDx>
cudaError_t launch_pass(const float* x, const float* k, const float* y,
                        const float* g, float* dx, float* dk, float* db,
                        float* part, float* dbp, const Geo& geo,
                        int bias_table, int act, float alpha, int n_blocks,
                        void* stream) {
  constexpr size_t smem = sizeof(float) * smem_floats<kDx>();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_bwd_tile_kernel<kDx>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  conv3x3_bwd_tile_kernel<kDx><<<n_blocks, kThreads, smem, s>>>(
      x, k, y, g, dx, part, dbp, geo, act, alpha);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return stroke::launch_finalize(part, dbp, dk, db, geo, bias_table, n_blocks,
                                 s);
}

}  // namespace

// Sizes of the scratch buffers for a fused (with_dx 1) or dW-only (0) pass:
// the number of tiles (db partials: n_tiles x C_out floats) and of dW
// partials (n_blocks x 27 x C_in x C_out floats: one per persistent block
// here, one per chunk of tiles in the bfloat16 passes).  The bfloat16
// fused pass is conv3x3_bwd_tc.cu's kernel, the bfloat16 dW-only pass
// conv3x3_bwd_dw_tc.cu's.
extern "C" int conv3x3_bwd_plan(int with_dx, int bf16, int batch, int d_in,
                                int h, int w, int c_in, int c_out, int z_pad,
                                long long* n_tiles, int* n_blocks) {
  if (bf16) {
    return with_dx ? stroke::conv3x3_bwd_tc_plan(batch, d_in, h, w, c_in,
                                                 c_out, z_pad, n_tiles,
                                                 n_blocks)
                   : stroke::conv3x3_bwd_dw_tc_plan(batch, d_in, h, w, c_in,
                                                    c_out, z_pad, n_tiles,
                                                    n_blocks);
  }
  const Geo geo = make_geo(batch, d_in, h, w, c_in, c_out, z_pad,
                           with_dx != 0);
  *n_tiles = geo.n_tiles;
  return with_dx ? stroke::persistent_blocks(
                       conv3x3_bwd_tile_kernel<true>, kThreads,
                       sizeof(float) * smem_floats<true>(), geo.n_tiles,
                       n_blocks)
                 : stroke::persistent_blocks(
                       conv3x3_bwd_tile_kernel<false>, kThreads,
                       sizeof(float) * smem_floats<false>(), geo.n_tiles,
                       n_blocks);
}

// Each entry point returns the first failing launch's cudaError_t (0 on
// success).  The caller has checked shapes, dtypes, devices and contiguity,
// and allocated every output and scratch buffer with the plan's sizes.
extern "C" int conv3x3_bwd_fused_f32(
    const float* x, const float* k, const float* y, const float* g, float* dx,
    float* dk, float* db, float* part, float* dbp, int batch, int d_in, int h,
    int w, int c_in, int c_out, int z_pad, int bias_table, int act,
    float alpha, int n_blocks, void* stream) {
  const Geo geo = make_geo(batch, d_in, h, w, c_in, c_out, z_pad, true);
  return launch_pass<true>(x, k, y, g, dx, dk, db, part, dbp, geo,
                           bias_table, act, alpha, n_blocks, stream);
}

extern "C" int conv3x3_bwd_dw_f32(const float* x, const float* y,
                                  const float* g, float* dk, float* db,
                                  float* part, float* dbp, int batch,
                                  int d_in, int h, int w, int c_in, int c_out,
                                  int z_pad, int bias_table, int act,
                                  float alpha, int n_blocks, void* stream) {
  const Geo geo = make_geo(batch, d_in, h, w, c_in, c_out, z_pad, false);
  return launch_pass<false>(x, nullptr, y, g, nullptr, dk, db, part, dbp,
                            geo, bias_table, act, alpha, n_blocks, stream);
}
