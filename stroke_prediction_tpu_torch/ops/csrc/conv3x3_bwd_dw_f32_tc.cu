// float32 weight and bias gradients of the 3x3x3 stride-1 convolution
// y = act(conv3d(x, k) + b) on Hopper's tensor cores in 3xTF32 (kernel K4
// of the port, float32 storage; the bfloat16 K4 is conv3x3_bwd_dw_tc.cu's).
//
// Replaces stroke_prediction_tpu/ops/pallas/s2d.py _dw_kernel + _dw_taps
// (dW alone: the weight half of the split backward, and the entry conv,
// whose input is data and takes no dx) and the db reduction of
// _s2d_conv_bwd (s2d.py:943-944):
//
//   g'           = g * act'(y)   (from the saved OUTPUT, in float32:
//                                 LeakyReLU 1 / alpha, ELU 1 / y + alpha,
//                                 none 1)
//   dk[t, i, o]  = sum_{b,z,h,w} x[z + tz - p, h + ty, w + tx, i] * g'[.., o]
//   db[o]        = sum g'[.., o]   (or db[z, o] per output plane for the
//                                   z-SAME plane table)
//
// over NDHWC float32 tensors, p = z_pad (0 'v', 1 's'), out-of-range terms
// zero; float32 sums; dk and db float32.
//
// Arithmetic (3xTF32, as the float32 K1, K2 and K3): x and g' are split
// once, in shared memory, into big = tf32(v) and small = tf32(v - big)
// (cvt.rna.tf32.f32), and x * g' is taken as small_x * big_g + big_x *
// small_g + big_x * big_g, in that order, on
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32.  The tensor cores' float32
// sums truncate toward zero, a bias that grows with the chain of mma into
// one accumulator; dW's K is a whole chunk of voxels, so each k8 step's
// three products go into fresh registers and are added to the sum in IEEE
// float32.  db is summed on the CUDA cores from big + small.
//
// Design: the bfloat16 K4's GEMM (M = (tap, C_in), N = C_out, K = output
// voxels), cut into channel slices and split over the voxels:
//   * A work item is (C_in slice of 16 channels, C_out slice of 16 NO,
//     chunk of tiles), channels zero-padded to the slice: NO = 2 (32
//     channels) past 16 output channels, so that each staged and split x
//     region feeds twice the mma, else 1.  A tile is 9 rows x 16 columns of
//     one output plane of one sample.  The grid is (slice
//     pairs) x S chunks, one item a block; chunk s walks the tiles s,
//     s + S, ...  S is the card's resident block count divided among the
//     slice pairs (at least 1, at most the tiles): it depends on the shape
//     and the card, never on timing.
//   * Per tile a block of 9 warps copies by cp.async, into one raw slot:
//     the x region of its C_in slice (3 planes x 11 x 18 voxels, zero
//     outside the input and past C_in) and g and y of the tile's own output
//     plane (9 x 16 voxels, zero outside the output and past C_out: dW
//     needs no halo of g').  One pass then forms g' = g * act'(y) and
//     splits g' and x into big and small halves, at a voxel stride of
//     C + 4 floats (20, or 36 for a 32-channel g' slice); the next tile's
//     copies go into the raw slot while the warps multiply the current one.
//   * Fragments: both operands have K (voxels) strided, and ldmatrix.trans
//     moves 16-bit elements only, so each lane reads its tf32 fragment
//     elements by ld.shared.b32, as the float32 K2's dW does.  A k8 step is
//     8 columns of one tile row, K index kk mapped to column 2kk (kk < 4)
//     or 2(kk - 4) + 1: the four k of a read are 2 voxels apart, and at
//     strides of 20 or 36 floats (4 mod 8 words) they fall in the bank
//     groups 0, 8, 16, 24, so every read is conflict-free.
//   * Warp w owns the taps (tz, ty) = (w / 3, w % 3), tx = 0..2, and keeps
//     their 3 x 2 NO accumulator fragments (24 or 48 floats) in registers
//     for the whole item.  A k8 step reads B (g', 2 NO n8 groups) and the x
//     columns c .. c + 3 of its row shift; the three tx fragments share
//     them (tap tx reads columns c + tx and c + tx + 1): 24 ld.shared.b32
//     for 18 mma, or 32 for 36.
//   * Narrow input (C_in <= 5; the entry conv has 2 channels): padding C_in
//     to 16 rows would leave 7/8 of every mma empty at C_in = 2, so the
//     three tx taps are packed with C_in into M: row m is (tx = m / C_in,
//     i = m % C_in), valid for m < 3 C_in.  The x region is staged and split
//     at a voxel stride of C_in, so row m at voxel v is the float
//     v * C_in + m: the rows of a tx shift are the next floats of the
//     region row.  Warp w keeps one M fragment (8 floats); the packed
//     form's shared memory lets two blocks share an SM.
//   * Each block writes its sums once, to part[chunk][t][ci][co] for its
//     slices; dw_finalize_kernel sums the S chunks in chunk order.  db: the
//     blocks of C_in slice 0 sum each tile's g' (warp w row w, then one
//     thread per channel the 9 rows) into dbp[tile][co], and
//     db_finalize_kernel sums the tiles in a fixed order.  No float
//     atomics: dW and db are bit-identical from run to run.
//   * Shared memory: the raw slot (g, y, the x region), the split halves of
//     g' and x, and the db row sums: 175,680 bytes a block (NO = 1) or
//     212,544 (NO = 2), one block of 288 threads per SM; 78,264 for the
//     packed form, two per SM.  The whole x region is resident (not
//     streamed by tz plane), so each warp owns all three tx of its (tz, ty)
//     and shares its B and x reads among them; with one block per SM the
//     raw slot overlaps the next tile's copies with the current tile's mma.
//     (Splitting x at fragment load instead, with g' split in place and two
//     blocks per SM, was no faster on the card and slower at the entry
//     conv.)
//
// Bound on the H100: 2 * 27 * C_in * C_out FLOPs per output voxel against
// 4 * (C_in + 2 C_out) bytes of x, y and g read (and dk, db written).
// 3xTF32 runs three TF32 products per product, so the operations bound is
// the FLOPs at a third of the 495 TFLOP/s TF32 rate (165); the entry conv
// (2 -> 16) is bound by its bytes.  mma.sync.m16n8k8.tf32 issues at most
// about 1.1 G a second per SM (about 300 TFLOP/s of TF32, 100 of 3xTF32)
// and about 0.84 G with 9 warps, which share the SM's four schedulers
// 3 / 2 / 2 / 2 (stroke_prediction_tpu_torch/bench/mma_rate.py on an
// NVIDIA H100 80GB HBM3 at 700 W).
// Per k8 step a warp also issues 24 (NO = 1) shared loads beside its 18
// mma, near the shared-load rate, and every tile waits at two block-wide
// barriers and for the split pass.

#include <cuda_runtime.h>

#include <climits>
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
using stroke::mma_tf32;
using stroke::split4;
using stroke::split_tf32;

constexpr int kWarps = 9;
constexpr int kThreads = 32 * kWarps;
constexpr int kTH = kWarps;            // tile rows: one per warp's db sum
constexpr int kTW = 16;                // tile columns: two k8 steps
constexpr int kTile = kTH * kTW;       // output voxels of a tile
constexpr int kRH = kTH + 2;           // x region rows
constexpr int kRW = kTW + 2;           // x region columns
constexpr int kPlane = kRH * kRW;
constexpr int kRegion = 3 * kPlane;    // voxels of the 3-plane x region

constexpr int kC = 16;       // channels of a C_in slice
constexpr int kCS = kC + 4;  // split x voxel stride (floats)
constexpr int kMaxPack = 5;  // widest C_in of the packed form (3 C_in <= 16)

// flags: which operands allow vector accesses
constexpr int kVecX = 1;    // 16-byte copies of x (C_in % 4 == 0, aligned)
constexpr int kVecG = 2;    // 16-byte copies of g and y (C_out % 4 == 0)

// The floats of a block's shared memory: [g raw | y raw | g' big | g'
// small | x raw | x big | x small | db row sums].  g and y hold a C_out
// slice of 16 NO channels (raw at a voxel stride of 16 NO, split at
// 16 NO + 4); x a 16-channel C_in slice (raw at a stride of 16, split at
// kCS), or in the packed form all C_in channels at a stride of C_in.
template <bool kPack, int NO>
struct Smem {
  static constexpr int kCO = 16 * NO;
  static constexpr int kGS = kCO + 4;
  static constexpr int kGRaw = kTile * kCO;
  static constexpr int kGSplit = kTile * kGS;
  static constexpr int kXRaw = kRegion * (kPack ? kMaxPack : kC);
  static constexpr int kXSplit = kRegion * (kPack ? kMaxPack : kCS);
  static constexpr int kFloats =
      2 * kGRaw + 2 * kGSplit + kXRaw + 2 * kXSplit + kWarps * 32;
  static constexpr size_t kBytes = sizeof(float) * (size_t)kFloats;
};

// NO: n16 groups of a C_out slice (1, or 2 for a 32-channel slice).
template <bool kPack, int NO>
__global__ void __launch_bounds__(kThreads, (kPack ? 2 : 1))
conv3x3_bwd_dw_f32_tc_kernel(const float* __restrict__ x,
                             const float* __restrict__ y,
                             const float* __restrict__ g,
                             float* __restrict__ part,
                             float* __restrict__ dbp, Geo geo, int n_co,
                             int n_chunks, int act, float alpha, int flags) {
  using S = Smem<kPack, NO>;
  constexpr int CO = S::kCO, GS = S::kGS;
  extern __shared__ uint4 smem[];
  float* g_raw = reinterpret_cast<float*>(smem);
  float* y_raw = g_raw + S::kGRaw;
  float* g_big = y_raw + S::kGRaw;
  float* g_small = g_big + S::kGSplit;
  float* x_raw = g_small + S::kGSplit;
  float* x_big = x_raw + S::kXRaw;
  float* x_small = x_big + S::kXSplit;
  float* dbs = x_small + S::kXSplit;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c_in = geo.c_in, c_out = geo.c_out, p = geo.z_pad;
  const int n_pairs = gridDim.x / n_chunks;
  const int pair = blockIdx.x % n_pairs, chunk = blockIdx.x / n_pairs;
  const int ci_slice = pair / n_co;
  const int ci0 = ci_slice * kC, co0 = (pair % n_co) * CO;
  const int ci_n = kPack ? c_in : min(kC, c_in - ci0);  // real channels
  const int xr = kPack ? c_in : kC;   // raw x voxel stride
  const bool db_block = ci_slice == 0;

  // Starts the copies of a tile into the raw slot.
  auto load = [&](long long tile) {
    long long r = tile;
    const int w0 = (int)(r % geo.n_tw) * kTW;
    r /= geo.n_tw;
    const int h0 = (int)(r % geo.n_th) * kTH;
    r /= geo.n_th;
    const int z = (int)(r % geo.tile_d);
    const int b = (int)(r / geo.tile_d);
    // x region: planes iz = z - p + rz, rows h0 + rh, columns w0 + rw
    {
      const bool vec = flags & kVecX;
      const int per = vec ? kC / 4 : xr;   // copies per voxel
      for (int e = tid; e < kRegion * per; e += kThreads) {
        const int vox = e / per, c = (e % per) * (vec ? 4 : 1);
        const int rw = vox % kRW, rh = (vox / kRW) % kRH, rz = vox / kPlane;
        const int iz = z - p + rz, ih = h0 + rh, iw = w0 + rw;
        const bool ok = c < ci_n && iz >= 0 && iz < geo.d_in && ih < geo.h &&
                        iw < geo.w;
        const float* src =
            ok ? x + ((((long long)b * geo.d_in + iz) * geo.h + ih) * geo.w +
                      iw) * c_in + ci0 + c
               : x;
        if (vec) {
          cp_async16(x_raw + vox * kC + c, src, ok);
        } else {
          cp_async4(x_raw + vox * xr + c, src, ok);
        }
      }
    }
    // g and y: output plane z, rows h0 + ly, columns w0 + lx
    {
      const bool vec = flags & kVecG;
      const int per = vec ? CO / 4 : CO;
      for (int e = tid; e < kTile * per; e += kThreads) {
        const int vox = e / per, c = (e % per) * (vec ? 4 : 1);
        const int oh = h0 + vox / kTW, ow = w0 + vox % kTW;
        const bool ok = co0 + c < c_out && oh < geo.h_out && ow < geo.w_out;
        const long long at =
            ok ? ((((long long)b * geo.d_out + z) * geo.h_out + oh) *
                      geo.w_out + ow) * c_out + co0 + c
               : 0;
        if (vec) {
          cp_async16(g_raw + vox * CO + c, g + at, ok);
          cp_async16(y_raw + vox * CO + c, y + at, ok);
        } else {
          cp_async4(g_raw + vox * CO + c, g + at, ok);
          cp_async4(y_raw + vox * CO + c, y + at, ok);
        }
      }
    }
  };

  // Forms g' from the raw slot and splits g' and x into their halves.
  auto split = [&]() {
    for (int e = tid; e < kTile * CO / 4; e += kThreads) {
      const int raw = e * 4, at = (e / (CO / 4)) * GS + (e % (CO / 4)) * 4;
      float4 v = *reinterpret_cast<const float4*>(g_raw + raw), s;
      const float4 yv = *reinterpret_cast<const float4*>(y_raw + raw);
      v.x = cotangent<float>(v.x, yv.x, act, alpha);
      v.y = cotangent<float>(v.y, yv.y, act, alpha);
      v.z = cotangent<float>(v.z, yv.z, act, alpha);
      v.w = cotangent<float>(v.w, yv.w, act, alpha);
      split4(v, s);
      *reinterpret_cast<float4*>(g_big + at) = v;
      *reinterpret_cast<float4*>(g_small + at) = s;
    }
    if constexpr (kPack) {
      for (int e = tid; e < kRegion * c_in; e += kThreads) {
        unsigned hi, lo;
        split_tf32(x_raw[e], hi, lo);
        x_big[e] = __uint_as_float(hi);
        x_small[e] = __uint_as_float(lo);
      }
    } else {
      for (int e = tid; e < kRegion * kC / 4; e += kThreads) {
        const int raw = e * 4, at = (e / 4) * kCS + (e % 4) * 4;
        float4 v = *reinterpret_cast<const float4*>(x_raw + raw), s;
        split4(v, s);
        *reinterpret_cast<float4*>(x_big + at) = v;
        *reinterpret_cast<float4*>(x_small + at) = s;
      }
    }
  };

  // A tile's db partial from its 9 row sums, one thread per channel.
  auto write_db = [&](long long tile) {
    if (tid < CO && co0 + tid < c_out) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += dbs[w * 32 + tid];
      dbp[tile * c_out + co0 + tid] = s;
    }
  };

  // per-lane fragment elements (see the fragment layouts of m16n8k8.tf32):
  // k (voxel column 2 q4, and 2 q4 + 1 for k + 4), m / n row q8 (and
  // q8 + 8 for A's second pair)
  const int q4 = lane % 4, q8 = lane / 4;
  const int tz = warp / 3, ty = warp % 3;  // this warp's taps
  const int g_at = 2 * q4 * GS + q8;       // g' at tile row 0, column 2 q4
  // x at region plane tz, row ty, column 2 q4: channel q8 of the slice, or
  // in the packed form float q8 (row m = q8) of that voxel
  const int x_at = (tz * kRH + ty) * kRW + 2 * q4;
  const bool lo_ok = !kPack || q8 < 3 * c_in;      // packed rows q8
  const bool hi_ok = !kPack || q8 + 8 < 3 * c_in;  // and q8 + 8

  constexpr int kTaps = kPack ? 1 : 3;   // M fragments: tx, or packed
  float acc[kTaps][2 * NO][4];
#pragma unroll
  for (int a = 0; a < kTaps; ++a)
#pragma unroll
    for (int n = 0; n < 2 * NO; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][n][q] = 0.f;

  long long tile = chunk, prev = -1;
  if (tile < geo.n_tiles) load(tile);
  cp_async_commit();

  for (; tile < geo.n_tiles; tile += n_chunks) {
    // the tile's copies have landed, and every warp is done with the
    // previous tile's halves and row sums
    cp_async_wait_all();
    __syncthreads();
    if (db_block && prev >= 0) write_db(prev);
    split();
    __syncthreads();   // the halves are in; the raw slot is free
    if (tile + n_chunks < geo.n_tiles) load(tile + n_chunks);
    cp_async_commit();

    // db row sums (C_in slice 0): warp w sums row w of the tile per
    // channel from big + small
    if (db_block && lane < CO) {
      const int at = warp * kTW * GS + lane;
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < kTW; ++v) {
        s += g_big[at + v * GS] + g_small[at + v * GS];
      }
      dbs[warp * 32 + lane] = s;
    }

    // dW over the tile's voxels: per k8 step the columns 8 ch .. 8 ch + 7
    // of row ly; fresh 3-mma chains added in IEEE float32
#pragma unroll 1
    for (int ly = 0; ly < kTH; ++ly) {
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        const int go = (ly * kTW + 8 * ch) * GS + g_at;
        unsigned gb[2 * NO][2], gs[2 * NO][2];
#pragma unroll
        for (int n = 0; n < 2 * NO; ++n) {
          gb[n][0] = __float_as_uint(g_big[go + n * 8]);
          gb[n][1] = __float_as_uint(g_big[go + GS + n * 8]);
          gs[n][0] = __float_as_uint(g_small[go + n * 8]);
          gs[n][1] = __float_as_uint(g_small[go + GS + n * 8]);
        }
        const int xv = x_at + ly * kRW + 8 * ch;   // the lane's column 2 q4
        if constexpr (kPack) {
          // rows q8 and q8 + 8 at columns 2 q4 and 2 q4 + 1
          const int at = xv * c_in + q8;
          const unsigned xb4[4] = {
              lo_ok ? __float_as_uint(x_big[at]) : 0u,
              hi_ok ? __float_as_uint(x_big[at + 8]) : 0u,
              lo_ok ? __float_as_uint(x_big[at + c_in]) : 0u,
              hi_ok ? __float_as_uint(x_big[at + c_in + 8]) : 0u};
          const unsigned xs4[4] = {
              lo_ok ? __float_as_uint(x_small[at]) : 0u,
              hi_ok ? __float_as_uint(x_small[at + 8]) : 0u,
              lo_ok ? __float_as_uint(x_small[at + c_in]) : 0u,
              hi_ok ? __float_as_uint(x_small[at + c_in + 8]) : 0u};
          float d[2 * NO][4] = {};
#pragma unroll
          for (int n = 0; n < 2 * NO; ++n) mma_tf32(d[n], xs4, gb[n]);
#pragma unroll
          for (int n = 0; n < 2 * NO; ++n) mma_tf32(d[n], xb4, gs[n]);
#pragma unroll
          for (int n = 0; n < 2 * NO; ++n) mma_tf32(d[n], xb4, gb[n]);
#pragma unroll
          for (int n = 0; n < 2 * NO; ++n)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[0][n][q] += d[n][q];
        } else {
          // channels q8 and q8 + 8 at columns 2 q4 .. 2 q4 + 3: tap tx
          // takes columns tx and tx + 1 of them
          unsigned xb[4][2], xs[4][2];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int at = (xv + c) * kCS + q8;
            xb[c][0] = __float_as_uint(x_big[at]);
            xb[c][1] = __float_as_uint(x_big[at + 8]);
            xs[c][0] = __float_as_uint(x_small[at]);
            xs[c][1] = __float_as_uint(x_small[at + 8]);
          }
#pragma unroll
          for (int sx = 0; sx < 3; ++sx) {
            const unsigned xb4[4] = {xb[sx][0], xb[sx][1], xb[sx + 1][0],
                                     xb[sx + 1][1]};
            const unsigned xs4[4] = {xs[sx][0], xs[sx][1], xs[sx + 1][0],
                                     xs[sx + 1][1]};
            float d[2 * NO][4] = {};
#pragma unroll
            for (int n = 0; n < 2 * NO; ++n) mma_tf32(d[n], xs4, gb[n]);
#pragma unroll
            for (int n = 0; n < 2 * NO; ++n) mma_tf32(d[n], xb4, gs[n]);
#pragma unroll
            for (int n = 0; n < 2 * NO; ++n) mma_tf32(d[n], xb4, gb[n]);
#pragma unroll
            for (int n = 0; n < 2 * NO; ++n)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[sx][n][q] += d[n][q];
          }
        }
      }
    }
    prev = tile;
  }
  if (db_block && prev >= 0) {
    __syncthreads();   // every warp's row sums of the last tile are in
    write_db(prev);
  }

  // the item's dW, written once: part[chunk][t][ci][co] for its slices
  float* my_part = part + (long long)chunk * 27 * c_in * c_out;
#pragma unroll
  for (int a = 0; a < kTaps; ++a) {
#pragma unroll
    for (int n = 0; n < 2 * NO; ++n) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = q8 + 8 * (q / 2);   // the fragment row
        const int co = co0 + n * 8 + 2 * q4 + q % 2;
        int t, ci;
        if constexpr (kPack) {
          if (m >= 3 * c_in) continue;
          t = tz * 9 + ty * 3 + m / c_in;
          ci = m % c_in;
        } else {
          t = tz * 9 + ty * 3 + a;
          ci = ci0 + m;
        }
        if (ci < c_in && co < c_out) {
          my_part[((long long)t * c_in + ci) * c_out + co] = acc[a][n][q];
        }
      }
    }
  }
}

bool packed(int c_in) { return c_in <= kMaxPack; }

// n16 groups of a C_out slice: 32-channel slices past 16 channels (the x
// region is staged and split once for twice the mma), except in the packed
// form
int n_groups(int c_in, int c_out) {
  return !packed(c_in) && c_out > 16 ? 2 : 1;
}

int n_slices(int c, int width) { return (c + width - 1) / width; }

// slice pairs of an item's grid: C_in slices (one in the packed form) x
// C_out slices
int n_pairs(int c_in, int c_out) {
  return (packed(c_in) ? 1 : n_slices(c_in, kC)) *
         n_slices(c_out, 16 * n_groups(c_in, c_out));
}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

template <bool kPack, int NO>
struct Form {
  static cudaError_t resident(int* out) {
    return stroke::persistent_blocks(conv3x3_bwd_dw_f32_tc_kernel<kPack, NO>,
                                     kThreads, Smem<kPack, NO>::kBytes,
                                     LLONG_MAX, out);
  }
  static cudaError_t launch(const float* x, const float* y, const float* g,
                            float* part, float* dbp, const Geo& geo,
                            int n_chunks, int act, float alpha, int flags,
                            cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_bwd_dw_f32_tc_kernel<kPack, NO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Smem<kPack, NO>::kBytes);
    if (err != cudaSuccess) return err;
    conv3x3_bwd_dw_f32_tc_kernel<kPack, NO>
        <<<n_pairs(geo.c_in, geo.c_out) * n_chunks, kThreads,
           Smem<kPack, NO>::kBytes, stream>>>(
            x, y, g, part, dbp, geo, n_slices(geo.c_out, 16 * NO), n_chunks,
            act, alpha, flags);
    return cudaGetLastError();
  }
};

}  // namespace

namespace stroke {

int conv3x3_bwd_dw_f32_tc_plan(int batch, int d_in, int h, int w, int c_in,
                               int c_out, int z_pad, long long* n_tiles,
                               int* n_chunks) {
  if (c_in < 1 || c_out < 1) return cudaErrorInvalidValue;
  const Geo geo =
      make_geo(batch, d_in, h, w, c_in, c_out, z_pad, false, kTH, kTW);
  *n_tiles = geo.n_tiles;
  // resident blocks on the card, divided among the slice pairs
  int resident = 0;
  const cudaError_t err =
      packed(c_in) ? Form<true, 1>::resident(&resident)
      : n_groups(c_in, c_out) == 2 ? Form<false, 2>::resident(&resident)
                                   : Form<false, 1>::resident(&resident);
  if (err != cudaSuccess) return err;
  long long s = resident / n_pairs(c_in, c_out);
  if (s > geo.n_tiles) s = geo.n_tiles;
  *n_chunks = (int)(s < 1 ? 1 : s);
  return cudaSuccess;
}

}  // namespace stroke

// Returns the first failing launch's cudaError_t (0 on success).  The
// caller has checked shapes, dtypes, devices and contiguity, and allocated
// dk, db and the partials with the plan's sizes: n_chunks x 27 x C_in x
// C_out floats of dW partials, n_tiles x C_out of db partials.
extern "C" int conv3x3_bwd_dw_f32(const float* x, const float* y,
                                  const float* g, float* dk, float* db,
                                  float* part, float* dbp, int batch,
                                  int d_in, int h, int w, int c_in, int c_out,
                                  int z_pad, int bias_table, int act,
                                  float alpha, int n_chunks, void* stream) {
  if (c_in < 1 || c_out < 1 || n_chunks < 1) return cudaErrorInvalidValue;
  const Geo geo = stroke::make_geo(batch, d_in, h, w, c_in, c_out, z_pad,
                                   false, kTH, kTW);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pack = packed(c_in);
  const int flags = (!pack && c_in % 4 == 0 && aligned(x, 16) ? kVecX : 0) |
                    (c_out % 4 == 0 && aligned(g, 16) && aligned(y, 16)
                         ? kVecG : 0);
  const cudaError_t err =
      pack ? Form<true, 1>::launch(x, y, g, part, dbp, geo, n_chunks, act,
                                   alpha, flags, s)
      : n_groups(c_in, c_out) == 2
          ? Form<false, 2>::launch(x, y, g, part, dbp, geo, n_chunks, act,
                                   alpha, flags, s)
          : Form<false, 1>::launch(x, y, g, part, dbp, geo, n_chunks, act,
                                   alpha, flags, s);
  if (err != cudaSuccess) return err;
  return stroke::launch_finalize(part, dbp, dk, db, geo, bias_table,
                                 n_chunks, s);
}
