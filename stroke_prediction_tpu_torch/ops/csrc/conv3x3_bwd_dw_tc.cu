// bfloat16 weight and bias gradients of the 3x3x3 stride-1 convolution
// y = act(conv3d(x, k) + b) on Hopper's tensor cores (kernel K4 of the port,
// bfloat16 storage; the float32 K4 is conv3x3_bwd_dw_f32_tc.cu's, in
// 3xTF32).
//
// Replaces stroke_prediction_tpu/ops/pallas/s2d.py _dw_kernel + _dw_taps
// (dW alone: the weight half of the split backward, and the entry conv,
// whose input is data and takes no dx) and the db reduction of
// _s2d_conv_bwd:
//
//   g'           = bf16(g * act'(y))   as s2d.py:879-889 forms it (alpha and
//                                      ELU's y + alpha rounded to bf16 too)
//   dk[t, i, o]  = sum_{b,z,h,w} x[z + tz - p, h + ty, w + tx, i] * g'[.., o]
//   db[o]        = sum g'[.., o]   (or db[z, o] per output plane)
//
// over NDHWC tensors, p = z_pad (0 'v', 1 's'), out-of-range x zero;
// bfloat16 operands, float32 sums; dk and db float32.
//
// Design: the dW GEMM of the bfloat16 K2 (conv3x3_bwd_tc.cu), M = (tap,
// C_in), N = C_out, K = output voxels, cut into channel slices and split
// over the voxels:
//   * A work item is (C_in slice of 16 channels, C_out slice of 16,
//     chunk of tiles), channels zero-padded to the slice.  A tile is 9
//     rows x 16 columns of one output plane of one sample.  The grid
//     is (slice pairs) x S chunks, one item a block; chunk s walks the
//     tiles s, s + S, s + 2S, ...  S is the card's resident block count
//     divided among the slice pairs (at least 1, at most the tiles): it
//     depends on the shape and the card, never on timing.
//   * Per tile a block of 9 warps stages in shared memory, as bfloat16
//     with a voxel stride of C + 8 elements (an odd multiple of 16 bytes,
//     so the 8 rows of every ldmatrix hit distinct banks):
//       - the x region of its C_in slice, 3 planes x 11 x 18 voxels
//         (cp.async where C_in % 8 == 0; else scalar loads of the real
//         channels, the padded ones zeroed once);
//       - the g' tile of its C_out slice: the tile's own output plane
//         only (dW needs no halo of g'), formed from g and y while staging;
//         out-of-range voxels are zero, so ragged tiles add nothing.
//   * Warp w owns the taps (tz, ty) = (w / 3, w % 3), tx = 0..2, and keeps
//     their 3 x 2 accumulator fragments (24 floats a thread) in registers
//     for one tile.  Per row of the tile (one k step of 16 voxels) it
//     fetches g' (B) and x at each tx shift (A) with ldmatrix.trans and
//     issues mma.sync.m16n8k16 (the PTX helpers of mma_bf16.cuh).  After
//     the tile each thread adds its fragments, in IEEE float32, to its own
//     running sums in shared memory (24 floats, as 6 float4 columns of the
//     block, conflict-free) and starts the next tile from zero.  mma.sync's
//     float32 accumulation truncates: over a whole item's chain (~850 mma
//     at a 4 x 28 x 128^2 entry conv) dk of phase-2 training's entry conv
//     on U-Net probabilities came out 1.4e-4 of max|dk| off cuDNN's
//     float32 wgrad, and on random inputs such chains sit 0.8e-5 to 2e-5
//     of max|dk| off float64, 9-mma chains 3e-7 to 8e-7
//     (bench/conv_bwd_dw.py).  A tile's chain is 9 mma.
//   * Each block writes its sums once, to part[chunk][t][ci][co] for its
//     slice; dw_finalize_kernel sums the S chunks in chunk order.  db: the
//     blocks of C_in slice 0 write each tile's g' sums to dbp[tile][co],
//     and db_finalize_kernel sums them in a fixed order.  dW and db are
//     bit-identical from run to run, with no float atomics.  The partials
//     (S x 27 x C_in x C_out floats) are at most one dW per resident block.
//   * Slices of 16 x 16 channels keep the kernel within the 96 registers
//     a thread of __launch_bounds__(288, 2) gets, with no spill.  (A 16 x 32
//     slice, 48 accumulator floats, restages the x region half as often
//     but spills 116 bytes there.)
//
// Bound on the H100: 2 * 27 * C_in * C_out FLOPs per output voxel for
// 2 bytes each of x, y and g read: at the U-Net's widths above the 295
// FLOP/byte ridge (L1, 2 -> 16, near it), so the tensor-core rate bounds
// it.  This version spends its time in mma.sync's instruction rate, the
// ldmatrix traffic, the block-wide waits at each tile's staging, the
// ragged tiles (9 x 16 over 19-21-wide planes at L5 / L6) and, at L1, the
// 8x padding of C_in = 2 to one 16-channel slice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
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
using stroke::ldsm_x4_trans;
using stroke::mma_bf16;

constexpr int kWarps = 9;
constexpr int kThreads = 32 * kWarps;
constexpr int kTH = kWarps;            // tile rows: one per warp's db sum
constexpr int kTW = 16;                // tile columns: one mma k step
constexpr int kTile = kTH * kTW;       // output voxels of a tile
constexpr int kRH = kTH + 2;           // x region rows
constexpr int kRW = kTW + 2;           // x region columns
constexpr int kPlane = kRH * kRW;
constexpr int kRegion = 3 * kPlane;    // voxels of the 3-plane x region

// flags: which operands allow vector accesses
constexpr int kVecX = 1;    // 16-byte copies of x (C_in % 8 == 0, aligned)
constexpr int kVecG = 2;    // 16-byte loads of g and y (C_out % 8 == 0)

constexpr int kC = 16;       // channels of a slice (C_in and C_out)
constexpr int kCS = kC + 8;  // staged voxel stride (elements)

constexpr int kAcc = 3 * 2 * 4;        // a thread's dW fragment floats
constexpr size_t kSmemBytes =
    sizeof(bf16) * ((size_t)kRegion + kTile) * kCS  // x region, g' tile
    + sizeof(float) * kWarps * 32                   // db row sums
    + sizeof(float) * kAcc * kThreads;              // running dW sums

__global__ void __launch_bounds__(kThreads, 2)
conv3x3_bwd_dw_tc_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ y,
                         const bf16* __restrict__ g, float* __restrict__ part,
                         float* __restrict__ dbp, Geo geo, int n_co,
                         int n_chunks, int act, float alpha, int flags) {
  extern __shared__ uint4 smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* gs = xs + kRegion * kCS;
  float* dbs = reinterpret_cast<float*>(gs + kTile * kCS);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c_in = geo.c_in, c_out = geo.c_out, p = geo.z_pad;
  const int pair = blockIdx.x % (gridDim.x / n_chunks);
  const int chunk = blockIdx.x / (gridDim.x / n_chunks);
  const int ci_slice = pair / n_co;
  const int ci0 = ci_slice * kC, co0 = (pair % n_co) * kC;
  const int ci_n = min(kC, c_in - ci0);   // real channels of the slice
  const bf16 zero = __float2bfloat16_rn(0.f);

  // the scalar path writes only the real channels: zero the rest once
  if (!(flags & kVecX)) {
    for (int e = tid; e < kRegion * kCS; e += kThreads) xs[e] = zero;
  }

  // per-lane ldmatrix rows (see the fragment layouts of m16n8k16):
  // transposed A (rows are k): k row (lane / 16) * 8 + lane % 8,
  //   m half (lane / 8) % 2;
  // transposed B (rows are k): k row ((lane / 8) % 2) * 8 + lane % 8,
  //   n half lane / 16.
  const int at_k = (lane / 16) * 8 + lane % 8, at_m = ((lane / 8) % 2) * 8;
  const int bt_k = ((lane / 8) % 2) * 8 + lane % 8, bt_n = (lane / 16) * 8;

  const int tz = warp / 3, ty = warp % 3;  // this warp's taps
  // this thread's running dW sums: column j of the 6 float4 columns holds
  // accw[j / 2][j % 2][0..3]; each thread reads and writes only its own
  float4* tot = reinterpret_cast<float4*>(dbs + kWarps * 32);
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j) {
    tot[j * kThreads + tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float accw[3][2][4];

  for (long long tile = chunk; tile < geo.n_tiles; tile += n_chunks) {
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
      constexpr int C8 = kC / 8, N = kRegion * C8;
#pragma unroll
      for (int it = 0; it < (N + kThreads - 1) / kThreads; ++it) {
        const int e = tid + it * kThreads;
        if (e < N) {
          const int vox = e / C8, c = (e % C8) * 8;
          const int rw = vox % kRW, rh = (vox / kRW) % kRH, rz = vox / kPlane;
          const int iz = z - p + rz, ih = h0 + rh, iw = w0 + rw;
          const bool ok = ci0 + c < c_in && iz >= 0 && iz < geo.d_in &&
                          ih < geo.h && iw < geo.w;
          const bf16* src =
              ok ? x + ((((long long)b * geo.d_in + iz) * geo.h + ih) *
                            geo.w + iw) * c_in + ci0 + c
                 : x;
          cp_async16(xs + vox * kCS + c, src, ok);
        }
      }
    } else {
      for (int e = tid; e < kRegion * ci_n; e += kThreads) {
        const int vox = e / ci_n, c = e % ci_n;
        const int rw = vox % kRW, rh = (vox / kRW) % kRH, rz = vox / kPlane;
        const int iz = z - p + rz, ih = h0 + rh, iw = w0 + rw;
        xs[vox * kCS + c] =
            (iz >= 0 && iz < geo.d_in && ih < geo.h && iw < geo.w)
                ? x[((((long long)b * geo.d_in + iz) * geo.h + ih) * geo.w +
                     iw) * c_in + ci0 + c]
                : zero;
      }
    }

    // g' tile: output plane z, rows h0 + ly, columns w0 + lx; zero outside
    // the output
    if (flags & kVecG) {
      constexpr int C8 = kC / 8, N = kTile * C8;
#pragma unroll
      for (int it = 0; it < (N + kThreads - 1) / kThreads; ++it) {
        const int e = tid + it * kThreads;
        if (e < N) {
          const int vox = e / C8, c = (e % C8) * 8;
          const int oh = h0 + vox / kTW, ow = w0 + vox % kTW;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (co0 + c < c_out && oh < geo.h_out && ow < geo.w_out) {
            const long long idx =
                ((((long long)b * geo.d_out + z) * geo.h_out + oh) *
                     geo.w_out + ow) * c_out + co0 + c;
            const uint4 gv = __ldg(reinterpret_cast<const uint4*>(g + idx));
            const uint4 yv = __ldg(reinterpret_cast<const uint4*>(y + idx));
            v.x = cotangent2(gv.x, yv.x, act, alpha);
            v.y = cotangent2(gv.y, yv.y, act, alpha);
            v.z = cotangent2(gv.z, yv.z, act, alpha);
            v.w = cotangent2(gv.w, yv.w, act, alpha);
          }
          *reinterpret_cast<uint4*>(gs + vox * kCS + c) = v;
        }
      }
    } else {
      for (int e = tid; e < kTile * kC; e += kThreads) {
        const int vox = e / kC, c = e % kC;
        const int oh = h0 + vox / kTW, ow = w0 + vox % kTW;
        float v = 0.f;
        if (co0 + c < c_out && oh < geo.h_out && ow < geo.w_out) {
          const long long idx =
              ((((long long)b * geo.d_out + z) * geo.h_out + oh) *
                   geo.w_out + ow) * c_out + co0 + c;
          v = cotangent<bf16>(__bfloat162float(g[idx]),
                              __bfloat162float(y[idx]), act, alpha);
        }
        gs[vox * kCS + c] = __float2bfloat16_rn(v);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // db (C_in slice 0 only): warp w sums row w of the tile, one lane per
    // channel
    if (ci_slice == 0 && lane < kC) {
      const bf16* gr = gs + warp * kTW * kCS + lane;
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < kTW; ++v) s += __bfloat162float(gr[v * kCS]);
      dbs[warp * 32 + lane] = s;
    }

    // dW of taps (tz, ty, 0..2) over the tile's voxels, one row of 16
    // voxels per k step, from zero
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) accw[a][n][q] = 0.f;
#pragma unroll 1
    for (int ly = 0; ly < kTH; ++ly) {
      unsigned bq[4];
      ldsm_x4_trans(bq, gs + (ly * kTW + bt_k) * kCS + bt_n);
#pragma unroll
      for (int sx = 0; sx < 3; ++sx) {
        unsigned a[4];
        ldsm_x4_trans(
            a, xs + ((tz * kRH + ly + ty) * kRW + at_k + sx) * kCS + at_m);
        mma_bf16(accw[sx][0], a, bq[0], bq[1]);
        mma_bf16(accw[sx][1], a, bq[2], bq[3]);
      }
    }
    // the tile's sums join the running sums in IEEE float32
#pragma unroll
    for (int sx = 0; sx < 3; ++sx) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float4 t = tot[(sx * 2 + n) * kThreads + tid];
        t.x += accw[sx][n][0];
        t.y += accw[sx][n][1];
        t.z += accw[sx][n][2];
        t.w += accw[sx][n][3];
        tot[(sx * 2 + n) * kThreads + tid] = t;
      }
    }

    if (ci_slice == 0) {
      __syncthreads();  // every warp's db row sums are in
      if (tid < kC && co0 + tid < c_out) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += dbs[w * 32 + tid];
        dbp[tile * c_out + co0 + tid] = s;
      }
    }
  }

  // the item's dW, written once: part[chunk][t][ci][co] for its slices
  float* my_part = part + (long long)chunk * 27 * c_in * c_out;
#pragma unroll
  for (int sx = 0; sx < 3; ++sx) {
    const int t = tz * 9 + ty * 3 + sx;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float4 v = tot[(sx * 2 + n) * kThreads + tid];
      const float sum[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ci = ci0 + lane / 4 + 8 * (q / 2);
        const int co = co0 + n * 8 + (lane % 4) * 2 + q % 2;
        if (ci < c_in && co < c_out) {
          my_part[((long long)t * c_in + ci) * c_out + co] = sum[q];
        }
      }
    }
  }
}

int n_slices(int c) { return (c + kC - 1) / kC; }

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

}  // namespace

namespace stroke {

int conv3x3_bwd_dw_tc_plan(int batch, int d_in, int h, int w, int c_in,
                           int c_out, int z_pad, long long* n_tiles,
                           int* n_chunks) {
  if (c_in < 1 || c_out < 1) return cudaErrorInvalidValue;
  const Geo geo =
      make_geo(batch, d_in, h, w, c_in, c_out, z_pad, false, kTH, kTW);
  *n_tiles = geo.n_tiles;
  // resident blocks on the card, divided among the slice pairs
  int resident = 0;
  const cudaError_t err = persistent_blocks(conv3x3_bwd_dw_tc_kernel,
                                            kThreads, kSmemBytes, LLONG_MAX,
                                            &resident);
  if (err != cudaSuccess) return err;
  long long s = resident / (n_slices(c_in) * n_slices(c_out));
  if (s > geo.n_tiles) s = geo.n_tiles;
  *n_chunks = (int)(s < 1 ? 1 : s);
  return cudaSuccess;
}

}  // namespace stroke

// Returns the first failing launch's cudaError_t (0 on success).  The
// caller has checked shapes, dtypes, devices and contiguity, and allocated
// dk, db and the partials with the plan's sizes: n_chunks x 27 x C_in x
// C_out floats of dW partials, n_tiles x C_out of db partials.
extern "C" int conv3x3_bwd_dw_bf16(const bf16* x, const bf16* y,
                                   const bf16* g, float* dk, float* db,
                                   float* part, float* dbp, int batch,
                                   int d_in, int h, int w, int c_in,
                                   int c_out, int z_pad, int bias_table,
                                   int act, float alpha, int n_chunks,
                                   void* stream) {
  if (c_in < 1 || c_out < 1 || n_chunks < 1) return cudaErrorInvalidValue;
  const Geo geo = stroke::make_geo(batch, d_in, h, w, c_in, c_out, z_pad,
                                   false, kTH, kTW);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int flags = (c_in % 8 == 0 && aligned(x, 16) ? kVecX : 0) |
                    (c_out % 8 == 0 && aligned(g, 16) && aligned(y, 16)
                         ? kVecG : 0);
  const int n_co = n_slices(c_out), n_pairs = n_slices(c_in) * n_co;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_bwd_dw_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  conv3x3_bwd_dw_tc_kernel<<<n_pairs * n_chunks, kThreads, kSmemBytes, s>>>(
      x, y, g, part, dbp, geo, n_co, n_chunks, act, alpha, flags);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return stroke::launch_finalize(part, dbp, dk, db, geo, bias_table,
                                 n_chunks, s);
}
