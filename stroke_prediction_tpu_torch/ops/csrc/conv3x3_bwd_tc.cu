// bfloat16 fused backward of the 3x3x3 stride-1 convolution
// y = act(conv3d(x, k) + b) on Hopper's tensor cores (kernel K2 of the port,
// bfloat16 storage; the float32 K2 is conv3x3_bwd_f32_tc.cu's, in 3xTF32).
//
// Replaces stroke_prediction_tpu/ops/pallas/s2d.py _bwd_kernel (dx + dW in
// one pass over the cotangent) and the db reduction of _s2d_conv_bwd:
//
//   g'           = bf16(g * act'(y))   as s2d.py:879-889 forms it (alpha and
//                                      ELU's y + alpha rounded to bf16 too)
//   dx[z,h,w,i]  = sum_{t,o} g'[z - tz + p, h - ty, w - tx, o] * k[t, i, o]
//   dk[t, i, o]  = sum_{b,z,h,w} x[z + tz - p, h + ty, w + tx, i] * g'[.., o]
//   db[o]        = sum g'[.., o]   (or db[z, o] per output plane)
//
// over NDHWC tensors, p = z_pad (0 'v', 1 's'), out-of-range terms zero;
// bfloat16 operands, float32 sums; dx rounded once to bfloat16, dk and db
// float32.
//
// Design:
//   * A persistent block of 9 warps walks tiles of 9 rows x 16 columns of
//     one depth plane of one sample (input coordinates for dx, output
//     coordinates for dW; the two tilings coincide).  Per tile it stages in
//     shared memory, as bfloat16 with channels zero-padded to CIP / COP
//     (16 or 32) and a voxel stride of C + 8 elements (an odd multiple of
//     16 bytes, so the 8 rows of every ldmatrix hit distinct banks):
//       - the g' halo region, 3 planes x 11 x 18 voxels, formed from g and
//         y while staging (no pass writes g' to device memory);
//       - the x region, 3 planes x 11 x 18 voxels (cp.async when the
//         channels allow 16-byte copies);
//     and once per block the weights k[t][i][o] (o contiguous: the B
//     operand of dx, K-contiguous).
//   * dx: an implicit GEMM on mma.sync.m16n8k16 (bf16 in, f32 sums):
//     M = the tile's 144 input voxels (warp w owns row w: 16 voxels),
//     N = C_in, K = 27 taps x C_out.  The A fragment of a tap is 16
//     voxels' g' rows at that tap's shift, fetched by ldmatrix.x4 from
//     per-lane row addresses; B comes from the weight stage.  (The PTX
//     helpers are mma_bf16.cuh's, shared with the bfloat16 K3.)
//   * dW: a second GEMM on the same staged g': M = (tap, C_in), N = C_out,
//     K = the tile's output voxels.  Warp w owns the taps (tz, ty) =
//     (w / 3, w % 3), tx = 0..2.  A (x at +t) and B (g') are fetched with
//     ldmatrix.trans.  The dW accumulators stay in registers for the
//     block's whole walk and are written once, to the block's row of the
//     partials; dw_finalize_kernel sums the rows in block order, so dW is
//     bit-identical from run to run with no float atomics.
//   * db: per tile, each warp sums its row of g' per channel, one thread per
//     channel sums the 9 rows, and db_finalize_kernel sums the tiles in a
//     fixed order.
//
// Bound: ops/conv3x3.py bwd_route sends here only layers whose padded dW
// block 27 x CIP x COP floats is at most 64 KB, i.e. (CIP, COP) in
// {(16, 16), (16, 32), (32, 16)}; the wrapper raises for any other bfloat16
// shape.  On the H100 the work is 4 * 27 * C_in * C_out FLOPs per voxel
// for 2 x 2 bytes of x, y, g read and dx written, far above the 295
// FLOP/byte ridge at these widths, so the tensor-core rate bounds it; the
// staging of g' and the mma.sync instruction rate are what this version
// spends.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "conv3x3_bwd.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using stroke::cotangent;
using stroke::cotangent2;
using stroke::cp_async16;
using stroke::cp_async_wait_all;
using stroke::Geo;
using stroke::ldsm_x4;
using stroke::ldsm_x4_trans;
using stroke::mma_bf16;

constexpr int kWarps = 9;
constexpr int kThreads = 32 * kWarps;
constexpr int kTH = kWarps;            // tile rows: one per warp
constexpr int kTW = 16;                // tile columns: one mma M fragment
constexpr int kRH = kTH + 2;           // halo region rows
constexpr int kRW = kTW + 2;           // halo region columns
constexpr int kPlane = kRH * kRW;
constexpr int kRegion = 3 * kPlane;    // voxels of a 3-plane halo region

// flags: which operands allow vector accesses
constexpr int kVecX = 1;    // 16-byte copies of x (C_in % 8 == 0, aligned)
constexpr int kVecG = 2;    // 16-byte loads of g and y (C_out % 8 == 0)
constexpr int kVecDx = 4;   // 4-byte stores of dx pairs (C_in even)

template <int CIP, int COP>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * ((size_t)27 * CIP * (COP + 8)   // weights
                         + (size_t)kRegion * (COP + 8)  // g' region
                         + (size_t)kRegion * (CIP + 8)) // x region
         + sizeof(float) * kWarps * 32;                 // db row sums
}

template <int CIP, int COP>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_bwd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ k,
                      const bf16* __restrict__ y, const bf16* __restrict__ g,
                      bf16* __restrict__ dx, float* __restrict__ part,
                      float* __restrict__ dbp, Geo geo, int act, float alpha,
                      int flags) {
  constexpr int GS = COP + 8;   // staged voxel strides (elements)
  constexpr int XS = CIP + 8;
  constexpr int WS = COP + 8;   // weight row (one input channel) stride
  constexpr int NI = CIP / 16;  // 16-channel slices of C_in / C_out
  constexpr int NO = COP / 16;

  extern __shared__ uint4 smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* gs = ws + 27 * CIP * WS;
  bf16* xs = gs + kRegion * GS;
  float* dbs = reinterpret_cast<float*>(xs + kRegion * XS);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c_in = geo.c_in, c_out = geo.c_out, p = geo.z_pad;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // weights, once per block: ws[t][i][o] = k[t, i, o], zero-padded
  for (int e = tid; e < 27 * CIP * COP; e += kThreads) {
    const int o = e % COP, i = (e / COP) % CIP, t = e / (COP * CIP);
    ws[(t * CIP + i) * WS + o] =
        (i < c_in && o < c_out) ? k[(t * c_in + i) * c_out + o] : zero;
  }

  // per-lane ldmatrix rows (see the fragment layouts of m16n8k16):
  // non-transposed A: row lane % 16, k half lane / 16;
  // non-transposed B: n row (lane / 16) * 8 + lane % 8, k half (lane / 8) % 2;
  // transposed A (rows are k): k row (lane / 16) * 8 + lane % 8,
  //   m half (lane / 8) % 2;
  // transposed B (rows are k): k row ((lane / 8) % 2) * 8 + lane % 8,
  //   n half lane / 16.
  const int a_row = lane % 16, a_k = (lane / 16) * 8;
  const int b_n = (lane / 16) * 8 + lane % 8, b_k = ((lane / 8) % 2) * 8;
  const int at_k = (lane / 16) * 8 + lane % 8, at_m = ((lane / 8) % 2) * 8;
  const int bt_k = ((lane / 8) % 2) * 8 + lane % 8, bt_n = (lane / 16) * 8;

  const int tz = warp / 3, ty = warp % 3;  // this warp's dW taps
  float accw[3][NI][2 * NO][4];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int m = 0; m < NI; ++m)
#pragma unroll
      for (int n = 0; n < 2 * NO; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) accw[a][m][n][q] = 0.f;

  for (long long tile = blockIdx.x; tile < geo.n_tiles; tile += gridDim.x) {
    long long r = tile;
    const int tw = (int)(r % geo.n_tw);
    r /= geo.n_tw;
    const int th = (int)(r % geo.n_th);
    r /= geo.n_th;
    const int z = (int)(r % geo.tile_d);
    const int b = (int)(r / geo.tile_d);
    const int h0 = th * kTH, w0 = tw * kTW;

    __syncthreads();  // every warp is done with the previous tile's stage

    // x region: planes iz = z - p + rz, rows h0 + rh, columns w0 + rw
    if (flags & kVecX) {
      constexpr int C8 = CIP / 8, N = kRegion * C8;
#pragma unroll
      for (int it = 0; it < (N + kThreads - 1) / kThreads; ++it) {
        const int e = tid + it * kThreads;
        if (e < N) {
          const int vox = e / C8, c = (e % C8) * 8;
          const int rw = vox % kRW, rh = (vox / kRW) % kRH, rz = vox / kPlane;
          const int iz = z - p + rz, ih = h0 + rh, iw = w0 + rw;
          const bool ok = c < c_in && iz >= 0 && iz < geo.d_in &&
                          ih < geo.h && iw < geo.w;
          const bf16* src =
              ok ? x + ((((long long)b * geo.d_in + iz) * geo.h + ih) *
                            geo.w + iw) * c_in + c
                 : x;
          cp_async16(xs + vox * XS + c, src, ok);
        }
      }
    } else {
      for (int e = tid; e < kRegion * CIP; e += kThreads) {
        const int vox = e / CIP, c = e % CIP;
        const int rw = vox % kRW, rh = (vox / kRW) % kRH, rz = vox / kPlane;
        const int iz = z - p + rz, ih = h0 + rh, iw = w0 + rw;
        xs[vox * XS + c] =
            (c < c_in && iz >= 0 && iz < geo.d_in && ih < geo.h && iw < geo.w)
                ? x[((((long long)b * geo.d_in + iz) * geo.h + ih) * geo.w +
                     iw) * c_in + c]
                : zero;
      }
    }

    // g' region: planes oz = z - 2 + p + rz, rows h0 - 2 + rh, columns
    // w0 - 2 + rw; zero outside the output
    if (flags & kVecG) {
      constexpr int C8 = COP / 8, N = kRegion * C8;
      // three chunks' loads in flight: a full unroll would hold them all in
      // registers beside the dW accumulators and spill
#pragma unroll 3
      for (int it = 0; it < (N + kThreads - 1) / kThreads; ++it) {
        const int e = tid + it * kThreads;
        if (e < N) {
          const int vox = e / C8, c = (e % C8) * 8;
          const int rw = vox % kRW, rh = (vox / kRW) % kRH, rz = vox / kPlane;
          const int oz = z - 2 + p + rz, oh = h0 - 2 + rh, ow = w0 - 2 + rw;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (c < c_out && oz >= 0 && oz < geo.d_out && oh >= 0 &&
              oh < geo.h_out && ow >= 0 && ow < geo.w_out) {
            const long long idx =
                ((((long long)b * geo.d_out + oz) * geo.h_out + oh) *
                     geo.w_out + ow) * c_out + c;
            const uint4 gv = __ldg(reinterpret_cast<const uint4*>(g + idx));
            const uint4 yv = __ldg(reinterpret_cast<const uint4*>(y + idx));
            v.x = cotangent2(gv.x, yv.x, act, alpha);
            v.y = cotangent2(gv.y, yv.y, act, alpha);
            v.z = cotangent2(gv.z, yv.z, act, alpha);
            v.w = cotangent2(gv.w, yv.w, act, alpha);
          }
          *reinterpret_cast<uint4*>(gs + vox * GS + c) = v;
        }
      }
    } else {
      for (int e = tid; e < kRegion * COP; e += kThreads) {
        const int vox = e / COP, c = e % COP;
        const int rw = vox % kRW, rh = (vox / kRW) % kRH, rz = vox / kPlane;
        const int oz = z - 2 + p + rz, oh = h0 - 2 + rh, ow = w0 - 2 + rw;
        float v = 0.f;
        if (c < c_out && oz >= 0 && oz < geo.d_out && oh >= 0 &&
            oh < geo.h_out && ow >= 0 && ow < geo.w_out) {
          const long long idx =
              ((((long long)b * geo.d_out + oz) * geo.h_out + oh) *
                   geo.w_out + ow) * c_out + c;
          v = cotangent<bf16>(__bfloat162float(g[idx]),
                              __bfloat162float(y[idx]), act, alpha);
        }
        gs[vox * GS + c] = __float2bfloat16_rn(v);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // the tile's own output plane (oz = z) inside the g' region
    const bf16* gc = gs + (2 - p) * kPlane * GS;

    // db: warp w sums output row w of the tile, one lane per channel
    if (lane < COP) {
      const bf16* gr = gc + ((warp + 2) * kRW + 2) * GS + lane;
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < kTW; ++v) s += __bfloat162float(gr[v * GS]);
      dbs[warp * 32 + lane] = s;
    }

    // dx of input row h0 + warp, columns w0 .. w0 + 15
    {
      float acc[2 * NI][4];
#pragma unroll
      for (int n = 0; n < 2 * NI; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[n][q] = 0.f;
#pragma unroll 1
      for (int t = 0; t < 27; ++t) {
        const int sz = t / 9, sy = (t / 3) % 3, sx = t % 3;
        // g'[z - sz + p, h - sy, w - sx]: region plane 2 - sz
        const bf16* ap = gs + (((2 - sz) * kRH + warp + 2 - sy) * kRW +
                               a_row + 2 - sx) * GS + a_k;
        const bf16* bp = ws + (t * CIP + b_n) * WS + b_k;
#pragma unroll
        for (int ks = 0; ks < NO; ++ks) {
          unsigned a[4];
          ldsm_x4(a, ap + ks * 16);
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            unsigned bq[4];
            ldsm_x4(bq, bp + ni * 16 * WS + ks * 16);
            mma_bf16(acc[2 * ni], a, bq[0], bq[1]);
            mma_bf16(acc[2 * ni + 1], a, bq[2], bq[3]);
          }
        }
      }
      const int ih = h0 + warp;
      if (ih < geo.h) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int iw = w0 + lane / 4 + 8 * half;
          if (iw >= geo.w) continue;
          bf16* dp = dx + ((((long long)b * geo.d_in + z) * geo.h + ih) *
                               geo.w + iw) * c_in;
#pragma unroll
          for (int n = 0; n < 2 * NI; ++n) {
            const int ci = n * 8 + (lane % 4) * 2;
            const float v0 = acc[n][2 * half], v1 = acc[n][2 * half + 1];
            if (flags & kVecDx) {
              if (ci < c_in) {
                *reinterpret_cast<__nv_bfloat162*>(dp + ci) =
                    __floats2bfloat162_rn(v0, v1);
              }
            } else {
              if (ci < c_in) dp[ci] = __float2bfloat16_rn(v0);
              if (ci + 1 < c_in) dp[ci + 1] = __float2bfloat16_rn(v1);
            }
          }
        }
      }
    }

    // dW of taps (tz, ty, 0..2) over the tile's output voxels, one row of
    // 16 voxels per k step
#pragma unroll 1
    for (int ly = 0; ly < kTH; ++ly) {
      unsigned bq[NO][4];
#pragma unroll
      for (int no = 0; no < NO; ++no) {
        ldsm_x4_trans(bq[no],
                      gc + ((ly + 2) * kRW + bt_k + 2) * GS + no * 16 + bt_n);
      }
#pragma unroll
      for (int sx = 0; sx < 3; ++sx) {
#pragma unroll
        for (int mi = 0; mi < NI; ++mi) {
          unsigned a[4];
          ldsm_x4_trans(a, xs + ((tz * kRH + ly + ty) * kRW + at_k + sx) * XS +
                               mi * 16 + at_m);
#pragma unroll
          for (int no = 0; no < NO; ++no) {
            mma_bf16(accw[sx][mi][2 * no], a, bq[no][0], bq[no][1]);
            mma_bf16(accw[sx][mi][2 * no + 1], a, bq[no][2], bq[no][3]);
          }
        }
      }
    }

    __syncthreads();  // every warp's db row sums are in
    if (tid < c_out) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += dbs[w * 32 + tid];
      dbp[tile * c_out + tid] = s;
    }
  }

  // the block's dW partial, written once: part[block][t][ci][co]
  float* my_part = part + (long long)blockIdx.x * 27 * c_in * c_out;
#pragma unroll
  for (int sx = 0; sx < 3; ++sx) {
    const int t = tz * 9 + ty * 3 + sx;
#pragma unroll
    for (int mi = 0; mi < NI; ++mi) {
#pragma unroll
      for (int n = 0; n < 2 * NO; ++n) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ci = mi * 16 + lane / 4 + 8 * (q / 2);
          const int co = n * 8 + (lane % 4) * 2 + q % 2;
          if (ci < c_in && co < c_out) {
            my_part[((long long)t * c_in + ci) * c_out + co] =
                accw[sx][mi][n][q];
          }
        }
      }
    }
  }
}

template <int CIP, int COP>
struct Config {
  static cudaError_t blocks(long long n_tiles, int* out) {
    return stroke::persistent_blocks(conv3x3_bwd_tc_kernel<CIP, COP>,
                                     kThreads, smem_bytes<CIP, COP>(),
                                     n_tiles, out);
  }
  static cudaError_t launch(const bf16* x, const bf16* k, const bf16* y,
                            const bf16* g, bf16* dx, float* part, float* dbp,
                            const Geo& geo, int act, float alpha, int flags,
                            int n_blocks, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_bwd_tc_kernel<CIP, COP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<CIP, COP>());
    if (err != cudaSuccess) return err;
    conv3x3_bwd_tc_kernel<CIP, COP>
        <<<n_blocks, kThreads, smem_bytes<CIP, COP>(), stream>>>(
            x, k, y, g, dx, part, dbp, geo, act, alpha, flags);
    return cudaGetLastError();
  }
};

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

}  // namespace

namespace stroke {

int conv3x3_bwd_tc_plan(int batch, int d_in, int h, int w, int c_in,
                        int c_out, int z_pad, long long* n_tiles,
                        int* n_blocks) {
  const Geo geo =
      make_geo(batch, d_in, h, w, c_in, c_out, z_pad, true, kTH, kTW);
  *n_tiles = geo.n_tiles;
  switch (fused_config(c_in, c_out)) {
    case 0: return Config<16, 16>::blocks(geo.n_tiles, n_blocks);
    case 1: return Config<16, 32>::blocks(geo.n_tiles, n_blocks);
    case 2: return Config<32, 16>::blocks(geo.n_tiles, n_blocks);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace stroke

// Returns the first failing launch's cudaError_t (0 on success).  The
// caller has checked shapes, dtypes, devices, contiguity and the channel
// bound, and allocated every output and scratch buffer with the plan's
// sizes.
extern "C" int conv3x3_bwd_fused_bf16(
    const bf16* x, const bf16* k, const bf16* y, const bf16* g, bf16* dx,
    float* dk, float* db, float* part, float* dbp, int batch, int d_in, int h,
    int w, int c_in, int c_out, int z_pad, int bias_table, int act,
    float alpha, int n_blocks, void* stream) {
  const Geo geo = stroke::make_geo(batch, d_in, h, w, c_in, c_out, z_pad,
                                   true, kTH, kTW);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int flags = (c_in % 8 == 0 && aligned(x, 16) ? kVecX : 0) |
                    (c_out % 8 == 0 && aligned(g, 16) && aligned(y, 16)
                         ? kVecG : 0) |
                    (c_in % 2 == 0 && aligned(dx, 4) ? kVecDx : 0);
  cudaError_t err;
  switch (stroke::fused_config(c_in, c_out)) {
    case 0:
      err = Config<16, 16>::launch(x, k, y, g, dx, part, dbp, geo, act,
                                   alpha, flags, n_blocks, s);
      break;
    case 1:
      err = Config<16, 32>::launch(x, k, y, g, dx, part, dbp, geo, act,
                                   alpha, flags, n_blocks, s);
      break;
    case 2:
      err = Config<32, 16>::launch(x, k, y, g, dx, part, dbp, geo, act,
                                   alpha, flags, n_blocks, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return stroke::launch_finalize(part, dbp, dk, db, geo, bias_table, n_blocks,
                                 s);
}
