// float32 fused backward of the 3x3x3 stride-1 convolution
// y = act(conv3d(x, k) + b) on Hopper's tensor cores in 3xTF32 (kernel K2
// of the port, float32 storage; the bfloat16 K2 is conv3x3_bwd_tc.cu's).
//
// Replaces stroke_prediction_tpu/ops/pallas/s2d.py _bwd_kernel (dx + dW in
// one pass over the cotangent) and the db reduction of _s2d_conv_bwd:
//
//   g'           = g * act'(y)   (from the saved OUTPUT, in float32:
//                                 LeakyReLU 1 / alpha, ELU 1 / y + alpha,
//                                 none 1)
//   dx[z,h,w,i]  = sum_{t,o} g'[z - tz + p, h - ty, w - tx, o] * k[t, i, o]
//   dk[t, i, o]  = sum_{b,z,h,w} x[z + tz - p, h + ty, w + tx, i] * g'[.., o]
//   db[o]        = sum g'[.., o]   (or db[z, o] per output plane for the
//                                   z-SAME plane table)
//
// over NDHWC float32 tensors, p = z_pad (0 'v', 1 's'), out-of-range terms
// zero; float32 sums; dx, dk and db float32.
//
// Arithmetic (3xTF32, as the float32 K1 and K3): every operand v is split
// into big = tf32(v) and small = tf32(v - big) (cvt.rna.tf32.f32), and
// a * b is taken as small_a * big_b + big_a * small_b + big_a * big_b, in
// that order, on mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32.  The tensor
// cores' float32 sums truncate toward zero, a bias that grows with the
// chain of mma into one accumulator, so in both GEMMs each k8 step's three
// products go into fresh registers and are added to the sum in IEEE
// float32.  That matters most for dW, whose K is the block's whole walk of
// voxels.  db is summed on the CUDA cores from big + small.
//
// Domain: ops/conv3x3.py bwd_route sends here only layers whose channels,
// padded to 16, are (C_in, C_out) in {(16, 16), (16, 32), (32, 16)}, the
// bfloat16 K2's bound; the entry point returns cudaErrorInvalidValue for
// any other shape.
//
// Design.  The bfloat16 K2 stages a whole 3-plane halo region of x and g'
// and all 27 weight taps once per tile; in float32 with big and small
// halves that is 245-377 KB, past a block's 227 KB.  So this kernel
// streams one kz plane per step, as the float32 K3 does, and reindexes dW
// by the INPUT plane so that one x plane serves the three steps:
//   * A persistent block of 9 warps (one block per SM) walks tiles of 9
//     rows x 16 columns of one input plane z of one sample.  dx of the
//     tile's voxels needs the g' planes z - kz + p (kz = 0, 1, 2) over the
//     halo region (rows h0 - 2 .. h0 + 8, columns w0 - 2 .. w0 + 15) with
//     weight plane kz.  dW is partitioned by (input plane, output tile):
//     tap tz pairs x plane z with output plane z - tz + p, the same g'
//     plane that dx reads at step kz = tz, over the output voxels of the
//     tile (the interior of the halo plane) against x plane z at rows
//     h0 .. h0 + 10, columns w0 .. w0 + 17.  Each (output voxel, tap) pair
//     with a stored input plane is counted by exactly one tile.  db: the
//     tile's own output plane z is the g' plane of step kz = p.
//   * Step kz of a tile: g and y of plane z - kz + p over the halo region
//     (11 x 18 voxels x COP channels, zero outside the output and past
//     C_out), weight plane kz (9 taps x CIP rows k[t, i, .] of COP floats)
//     and, at kz = 0, x plane z (11 x 18 voxels x CIP channels) land by
//     cp.async in one of two ring slots; the next step's copies (the next
//     tile's first step across tiles) are in flight while the current
//     step is formed, split and multiplied.  Only first steps write a
//     slot's x part, and they alternate slots, so the tile's x plane stays
//     put for its three steps.
//   * When a step's slot has landed, one pass of 16-byte accesses forms
//     g' = g * act'(y) and writes its big halves over g and its small
//     halves over y, splits the weights (big in place, small beside) and,
//     at kz = 0, x (likewise).  Each element is split once.
//   * dx: M = the tile's input voxels (warp w owns row w, one m16
//     fragment), N = C_in, K = 9 taps x C_out per step; A (g' rows at the
//     tap's shift) and B (weight rows, K-contiguous) by ldmatrix.x4 of
//     16-byte rows of 4 floats, as in the float32 K3.
//   * dW: M = C_in, N = C_out, K = the tile's 144 output voxels per step;
//     warp w owns the spatial tap (ty, tx) = (w / 3, w % 3) at tz = kz,
//     and keeps the 3 x NI x 2NO accumulator fragments of its three taps
//     in registers for the block's whole walk.  Both operands have K
//     (voxels) strided, and ldmatrix.trans moves 16-bit elements only, so
//     each lane reads its fragment elements by ld.shared.b32.  A k8 step
//     is 8 columns of one row, K index kk mapped to column 2kk (kk < 4) or
//     2(kk - 4) + 1: the four k of one read are then 2 voxels apart, and
//     with the voxel strides of C + 4 floats (4 mod 8 words) they fall in
//     the bank groups 0, 8, 16, 24, so every read is conflict-free, and
//     the same strides keep the dx ldmatrix rows conflict-free.
//   * The block writes its dW partial once, to its row of part;
//     dw_finalize_kernel sums the rows in block order.  db: warp w sums
//     row w of the own plane per channel, and one thread per channel sums
//     the 9 rows into the tile's db partial; db_finalize_kernel sums the
//     tiles in a fixed order.  No float atomics: dW and db are
//     bit-identical from run to run.
//   * Shared memory: two slots, the small halves of the weights and of x,
//     and the db row sums: 146,592 / 224,928 / 219,168 bytes a block at
//     (16, 16) / (16, 32) / (32, 16), so one block of 288 threads per SM,
//     which leaves a thread up to 224 registers for the dW accumulators
//     (24 or 48 floats) beside the dx ones and the fragments.
//
// Bound on the H100: 4 * 27 * C_in * C_out FLOPs per output voxel (dx and
// dW) against 4 * (2 * C_in + 2 * C_out) bytes of x, y, g read and dx
// written.  3xTF32 runs three TF32 products per product, so the operations
// bound is the FLOPs at a third of the 495 TFLOP/s TF32 rate (165), which
// bounds it at these widths.  Per step the warps also run the forming /
// split pass and wait at two block-wide barriers, with no second block on
// the SM to fill them.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "conv3x3_bwd.cuh"
#include "mma_bf16.cuh"

namespace {

using stroke::cotangent;
using stroke::cp_async16;
using stroke::cp_async4;
using stroke::cp_async_commit;
using stroke::cp_async_wait_all;
using stroke::Geo;
using stroke::ldsm_x4;
using stroke::mma_tf32;
using stroke::split4;

constexpr int kWarps = 9;
constexpr int kThreads = 32 * kWarps;
constexpr int kTH = kWarps;            // tile rows: one per warp
constexpr int kTW = 16;                // tile columns: one mma M fragment
constexpr int kRH = kTH + 2;           // halo / x region rows
constexpr int kRW = kTW + 2;           // halo / x region columns
constexpr int kPlane = kRH * kRW;      // voxels of one region plane

// flags: which operands allow vector accesses
constexpr int kVecK = 1;    // 16-byte copies of k (C_out % 4 == 0, aligned)
constexpr int kVecG = 2;    // 16-byte copies of g and y (C_out % 4 == 0)
constexpr int kVecX = 4;    // 16-byte copies of x (C_in % 4 == 0, aligned)
constexpr int kVecDx = 8;   // 8-byte stores of dx pairs (C_in even)

// The floats of one ring slot: g (big halves of g' after the split), y
// (small halves of g'), the weights of one kz plane (9 taps x CIP rows) at
// a voxel / row stride of COP + 4, and x plane z at a stride of CIP + 4
// (written by first steps only).
template <int CIP, int COP>
struct Slot {
  static constexpr int kG = kPlane * (COP + 4);
  static constexpr int kW = 9 * CIP * (COP + 4);
  static constexpr int kX = kPlane * (CIP + 4);
  static constexpr int kFloats = 2 * kG + kW + kX;
};

// two ring slots, the small halves of the weights and of x, the db row
// sums
template <int CIP, int COP>
constexpr size_t smem_bytes() {
  using S = Slot<CIP, COP>;
  return sizeof(float) *
         (2 * (size_t)S::kFloats + S::kW + S::kX + kWarps * 32);
}

template <int CIP, int COP>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_bwd_f32_tc_kernel(const float* __restrict__ x,
                          const float* __restrict__ k,
                          const float* __restrict__ y,
                          const float* __restrict__ g,
                          float* __restrict__ dx, float* __restrict__ part,
                          float* __restrict__ dbp, Geo geo, int act,
                          float alpha, int flags) {
  using S = Slot<CIP, COP>;
  constexpr int NI = CIP / 16, NO = COP / 16;
  constexpr int GS = COP + 4;          // g' voxel / weight row stride
  constexpr int XS = CIP + 4;          // x voxel stride
  constexpr int G4 = COP / 4, X4 = CIP / 4;

  // slot s at ring + s * S::kFloats: [g | y | weights | x]
  extern __shared__ uint4 smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* w_small = ring + 2 * S::kFloats;
  float* x_small = w_small + S::kW;
  float* dbs = x_small + S::kX;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c_in = geo.c_in, c_out = geo.c_out, p = geo.z_pad;
  const long long n_tiles = geo.n_tiles;

  // A tile: sample b, input plane z, origin h0, w0.
  struct Item {
    int b, z, h0, w0;
  };
  auto item = [&](long long tile) {
    Item it;
    long long r = tile;
    it.w0 = (int)(r % geo.n_tw) * kTW;
    r /= geo.n_tw;
    it.h0 = (int)(r % geo.n_th) * kTH;
    r /= geo.n_th;
    it.z = (int)(r % geo.tile_d);
    it.b = (int)(r / geo.tile_d);
    return it;
  };

  // Starts the copies of step kz of a tile into a slot.
  auto load_step = [&](long long tile, int kz, int slot) {
    const Item it = item(tile);
    float* gd = ring + slot * S::kFloats;
    float* yd = gd + S::kG;
    float* wd = yd + S::kG;
    float* xd = wd + S::kW;
    // wd[t9][i][o] = k[kz, t9, i, o], zero-padded
    if (flags & kVecK) {
      for (int e = tid; e < 9 * CIP * G4; e += kThreads) {
        const int c = (e % G4) * 4, i = (e / G4) % CIP, t9 = e / (G4 * CIP);
        const bool ok = i < c_in && c < c_out;
        const float* src =
            ok ? k + ((long long)(kz * 9 + t9) * c_in + i) * c_out + c : k;
        cp_async16(wd + (t9 * CIP + i) * GS + c, src, ok);
      }
    } else {
      for (int e = tid; e < 9 * CIP * COP; e += kThreads) {
        const int c = e % COP, i = (e / COP) % CIP, t9 = e / (COP * CIP);
        const bool ok = i < c_in && c < c_out;
        const float* src =
            ok ? k + ((long long)(kz * 9 + t9) * c_in + i) * c_out + c : k;
        cp_async4(wd + (t9 * CIP + i) * GS + c, src, ok);
      }
    }
    // g and y of plane oz = z - kz + p, rows h0 - 2 + rh, columns
    // w0 - 2 + rw; zero outside the output and past C_out
    const int oz = it.z - kz + p;
    {
      const bool vec = flags & kVecG;
      const int per = vec ? G4 : COP;    // copies per voxel
      for (int e = tid; e < kPlane * per; e += kThreads) {
        const int vox = e / per, c = (e % per) * (vec ? 4 : 1);
        const int oh = it.h0 - 2 + vox / kRW, ow = it.w0 - 2 + vox % kRW;
        const bool ok = c < c_out && oz >= 0 && oz < geo.d_out && oh >= 0 &&
                        oh < geo.h_out && ow >= 0 && ow < geo.w_out;
        const long long at =
            ok ? ((((long long)it.b * geo.d_out + oz) * geo.h_out + oh) *
                      geo.w_out + ow) * c_out + c
               : 0;
        if (vec) {
          cp_async16(gd + vox * GS + c, g + at, ok);
          cp_async16(yd + vox * GS + c, y + at, ok);
        } else {
          cp_async4(gd + vox * GS + c, g + at, ok);
          cp_async4(yd + vox * GS + c, y + at, ok);
        }
      }
    }
    // first step: x plane z, rows h0 + rh, columns w0 + rw; zero outside
    // the input and past C_in
    if (kz == 0) {
      const bool vec = flags & kVecX;
      const int per = vec ? X4 : CIP;
      for (int e = tid; e < kPlane * per; e += kThreads) {
        const int vox = e / per, c = (e % per) * (vec ? 4 : 1);
        const int ih = it.h0 + vox / kRW, iw = it.w0 + vox % kRW;
        const bool ok = c < c_in && ih < geo.h && iw < geo.w;
        const float* src =
            ok ? x + ((((long long)it.b * geo.d_in + it.z) * geo.h + ih) *
                          geo.w + iw) * c_in + c
               : x;
        if (vec) {
          cp_async16(xd + vox * XS + c, src, ok);
        } else {
          cp_async4(xd + vox * XS + c, src, ok);
        }
      }
    }
  };

  // per-lane fragment rows (see the fragment layouts of m16n8k8.tf32):
  // dx by ldmatrix.x4 on 16-byte rows of 4 floats, A: row lane % 16, k half
  // lane / 16; B: n row (lane / 16) * 8 + lane % 8, k half (lane / 8) % 2.
  // dW by ld.shared.b32: k (a voxel column pair 2 * (lane % 4), + 1) and
  // m / n lane / 4.
  const int a_row = lane % 16, a_k = (lane / 16) * 4;
  const int b_n = (lane / 16) * 8 + lane % 8, b_k = ((lane / 8) % 2) * 4;
  const int q4 = lane % 4, q8 = lane / 4;
  const int ty = warp / 3, tx = warp % 3;   // this warp's dW spatial tap
  // the lane's dW elements at row 0, columns 0 .. 7 of the tile: x at
  // (ty, tx + 2 q4) of the x plane, g' at (2, 2 + 2 q4) of the halo plane
  const int xw0 = (ty * kRW + tx + 2 * q4) * XS + q8;
  const int gw0 = (2 * kRW + 2 + 2 * q4) * GS + q8;

  float accw[3][NI][2 * NO][4];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int m = 0; m < NI; ++m)
#pragma unroll
      for (int n = 0; n < 2 * NO; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) accw[a][m][n][q] = 0.f;

  long long tile = blockIdx.x;
  if (tile < n_tiles) load_step(tile, 0, 0);
  cp_async_commit();
  int slot = 0;

  for (; tile < n_tiles; tile += gridDim.x) {
    const Item it = item(tile);
    // x plane z of this tile: in the slot of its first step
    float* x_big = ring + slot * S::kFloats + 2 * S::kG + S::kW;

    float acc[2 * NI][4];
#pragma unroll
    for (int n = 0; n < 2 * NI; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[n][q] = 0.f;

#pragma unroll
    for (int kz = 0; kz < 3; ++kz) {
      // this step's copies have landed, and every warp is done with the
      // other slot (the previous step) and with the small halves
      cp_async_wait_all();
      __syncthreads();

      if (kz < 2) {
        load_step(tile, kz + 1, slot ^ 1);
      } else if (tile + gridDim.x < n_tiles) {
        load_step(tile + gridDim.x, 0, slot ^ 1);
      }
      cp_async_commit();

      // the tile's db partial from the previous step's row sums
      if (kz == p + 1 && tid < c_out) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += dbs[w * 32 + tid];
        dbp[tile * c_out + tid] = s;
      }

      // form g' and split it (big halves in place of g, small in place of
      // y); split the weights (big in place, small beside) and, at the
      // first step, x (likewise)
      float* g_big = ring + slot * S::kFloats;
      float* g_small = g_big + S::kG;
      float* w_big = g_small + S::kG;
      for (int e = tid; e < kPlane * G4; e += kThreads) {
        const int at = (e / G4) * GS + (e % G4) * 4;
        float4 v = *reinterpret_cast<const float4*>(g_big + at), s;
        const float4 yv = *reinterpret_cast<const float4*>(g_small + at);
        v.x = cotangent<float>(v.x, yv.x, act, alpha);
        v.y = cotangent<float>(v.y, yv.y, act, alpha);
        v.z = cotangent<float>(v.z, yv.z, act, alpha);
        v.w = cotangent<float>(v.w, yv.w, act, alpha);
        split4(v, s);
        *reinterpret_cast<float4*>(g_big + at) = v;
        *reinterpret_cast<float4*>(g_small + at) = s;
      }
      for (int e = tid; e < 9 * CIP * G4; e += kThreads) {
        const int at = (e / G4) * GS + (e % G4) * 4;
        float4 v = *reinterpret_cast<const float4*>(w_big + at), s;
        split4(v, s);
        *reinterpret_cast<float4*>(w_big + at) = v;
        *reinterpret_cast<float4*>(w_small + at) = s;
      }
      if (kz == 0) {
        for (int e = tid; e < kPlane * X4; e += kThreads) {
          const int at = (e / X4) * XS + (e % X4) * 4;
          float4 v = *reinterpret_cast<const float4*>(x_big + at), s;
          split4(v, s);
          *reinterpret_cast<float4*>(x_big + at) = v;
          *reinterpret_cast<float4*>(x_small + at) = s;
        }
      }
      __syncthreads();

      // db row sums of the tile's own output plane (step kz = p): warp w
      // sums row w per channel from big + small
      if (kz == p && lane < COP) {
        const int at = ((warp + 2) * kRW + 2) * GS + lane;
        float s = 0.f;
#pragma unroll
        for (int v = 0; v < kTW; ++v) {
          s += g_big[at + v * GS] + g_small[at + v * GS];
        }
        dbs[warp * 32 + lane] = s;
      }

      // dx: the 9 taps (kz, sy, sx) of this step's plane, g'[z - kz + p,
      // h - sy, w - sx].  Each k8 step's three products go into fresh
      // registers (a 3-mma chain), added to the tile's sum in IEEE float32.
#pragma unroll
      for (int t9 = 0; t9 < 9; ++t9) {
        const int sy = t9 / 3, sx = t9 % 3;
        const int a_at =
            ((warp + 2 - sy) * kRW + a_row + 2 - sx) * GS + a_k;
        const int b_at = (t9 * CIP + b_n) * GS + b_k;
#pragma unroll
        for (int ks = 0; ks < COP / 8; ++ks) {
          unsigned a_big[4], a_small[4];
          ldsm_x4(a_big, g_big + a_at + ks * 8);
          ldsm_x4(a_small, g_small + a_at + ks * 8);
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            unsigned bb[4], bs[4];
            ldsm_x4(bb, w_big + b_at + ni * 16 * GS + ks * 8);
            ldsm_x4(bs, w_small + b_at + ni * 16 * GS + ks * 8);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const unsigned b_big[2] = {bb[2 * half], bb[2 * half + 1]};
              const unsigned b_small[2] = {bs[2 * half], bs[2 * half + 1]};
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              mma_tf32(d, a_small, b_big);
              mma_tf32(d, a_big, b_small);
              mma_tf32(d, a_big, b_big);
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[2 * ni + half][q] += d[q];
            }
          }
        }
      }

      // dW of tap (kz, ty, tx) over the tile's output voxels: per k8 step
      // the columns 8 ch .. 8 ch + 7 of row r, x at (r + ty, . + tx),
      // g' at (r + 2, . + 2); fresh 3-mma chains added in IEEE float32
#pragma unroll 1
      for (int r = 0; r < kTH; ++r) {
#pragma unroll
        for (int ch = 0; ch < 2; ++ch) {
          const int xo = xw0 + (r * kRW + 8 * ch) * XS;
          const int go = gw0 + (r * kRW + 8 * ch) * GS;
          unsigned gb[2 * NO][2], gs[2 * NO][2];
#pragma unroll
          for (int n = 0; n < 2 * NO; ++n) {
            gb[n][0] = __float_as_uint(g_big[go + n * 8]);
            gb[n][1] = __float_as_uint(g_big[go + GS + n * 8]);
            gs[n][0] = __float_as_uint(g_small[go + n * 8]);
            gs[n][1] = __float_as_uint(g_small[go + GS + n * 8]);
          }
#pragma unroll
          for (int mi = 0; mi < NI; ++mi) {
            const int at = xo + mi * 16;
            const unsigned xb4[4] = {
                __float_as_uint(x_big[at]), __float_as_uint(x_big[at + 8]),
                __float_as_uint(x_big[at + XS]),
                __float_as_uint(x_big[at + XS + 8])};
            const unsigned xs4[4] = {
                __float_as_uint(x_small[at]),
                __float_as_uint(x_small[at + 8]),
                __float_as_uint(x_small[at + XS]),
                __float_as_uint(x_small[at + XS + 8])};
#pragma unroll
            for (int n = 0; n < 2 * NO; ++n) {
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              mma_tf32(d, xs4, gb[n]);
              mma_tf32(d, xb4, gs[n]);
              mma_tf32(d, xb4, gb[n]);
#pragma unroll
              for (int q = 0; q < 4; ++q) accw[kz][mi][n][q] += d[q];
            }
          }
        }
      }
      slot ^= 1;
    }

    // dx of input row h0 + warp, columns w0 .. w0 + 15, all C_in
    const int ih = it.h0 + warp;
    if (ih < geo.h) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int iw = it.w0 + lane / 4 + 8 * half;
        if (iw >= geo.w) continue;
        float* dp = dx + ((((long long)it.b * geo.d_in + it.z) * geo.h + ih) *
                              geo.w + iw) * c_in;
#pragma unroll
        for (int n = 0; n < 2 * NI; ++n) {
          const int ci = n * 8 + (lane % 4) * 2;
          if (ci >= c_in) continue;
          const float v0 = acc[n][2 * half], v1 = acc[n][2 * half + 1];
          if (flags & kVecDx) {
            *reinterpret_cast<float2*>(dp + ci) = make_float2(v0, v1);
          } else {
            dp[ci] = v0;
            if (ci + 1 < c_in) dp[ci + 1] = v1;
          }
        }
      }
    }
  }

  // the block's dW partial, written once: part[block][t][ci][co]
  float* my_part = part + (long long)blockIdx.x * 27 * c_in * c_out;
#pragma unroll
  for (int tz = 0; tz < 3; ++tz) {
    const int t = tz * 9 + ty * 3 + tx;
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
                accw[tz][mi][n][q];
          }
        }
      }
    }
  }
}

template <int CIP, int COP>
struct Config {
  static cudaError_t blocks(long long n_tiles, int* out) {
    return stroke::persistent_blocks(conv3x3_bwd_f32_tc_kernel<CIP, COP>,
                                     kThreads, smem_bytes<CIP, COP>(),
                                     n_tiles, out);
  }
  static cudaError_t launch(const float* x, const float* k, const float* y,
                            const float* g, float* dx, float* part,
                            float* dbp, const Geo& geo, int act, float alpha,
                            int flags, int n_blocks, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_bwd_f32_tc_kernel<CIP, COP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<CIP, COP>());
    if (err != cudaSuccess) return err;
    conv3x3_bwd_f32_tc_kernel<CIP, COP>
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

int conv3x3_bwd_f32_tc_plan(int batch, int d_in, int h, int w, int c_in,
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
extern "C" int conv3x3_bwd_fused_f32(
    const float* x, const float* k, const float* y, const float* g, float* dx,
    float* dk, float* db, float* part, float* dbp, int batch, int d_in, int h,
    int w, int c_in, int c_out, int z_pad, int bias_table, int act,
    float alpha, int n_blocks, void* stream) {
  const Geo geo = stroke::make_geo(batch, d_in, h, w, c_in, c_out, z_pad,
                                   true, kTH, kTW);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int flags = (c_out % 4 == 0 && aligned(k, 16) ? kVecK : 0) |
                    (c_out % 4 == 0 && aligned(g, 16) && aligned(y, 16)
                         ? kVecG : 0) |
                    (c_in % 4 == 0 && aligned(x, 16) ? kVecX : 0) |
                    (c_in % 2 == 0 && aligned(dx, 8) ? kVecDx : 0);
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
