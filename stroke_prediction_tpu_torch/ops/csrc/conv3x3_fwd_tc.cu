// bfloat16 fused 3x3x3 stride-1 convolution forward
// y = bf16(act(conv3d(x, k) + b)) on Hopper's tensor cores (kernel K1 of the
// port, bfloat16 storage; the float32 K1 is conv3x3_fwd_f32_tc.cu's, in
// 3xTF32 on the same structure).
//
// Replaces stroke_prediction_tpu/ops/pallas/s2d.py _conv_kernel (launched by
// _s2d_conv_p, API s2d_conv):
//
//   y[z,h,w,o] = act(sum_{t,i} x[z + tz - p, h + ty, w + tx, i] * k[t, i, o]
//                    + b[o])
//
// over NDHWC tensors, p = z_pad (0 'v', 1 's'), x zero outside [0, D_in) in
// z; b a float32 vector (C_out,) or a per-output-plane (D_out, C_out) table
// (fold_bn_zsame); bfloat16 x and k (the kernel cast after the BN fold, as
// s2d.py _prep casts it), float32 sums, bias and activation in float32, y
// rounded once to bfloat16 (s2d.py: f32 accumulation, out_dtype =
// cells.dtype).  act: 0 none, 1 LeakyReLU(alpha), 2 ELU(alpha) with the exp
// of the clamped value.
//
// Design: an implicit GEMM on mma.sync.m16n8k16 (bf16 in, f32 sums) with
// M = output voxels, N = C_out, K = 27 taps x C_in; the structure of the
// bfloat16 K3 (conv3x3_bwd_dx_tc.cu), whose transposed conv is this GEMM
// with the taps flipped and the channel roles swapped.
//   * A persistent block of 8 warps walks work items: a tile of 8 rows x 16
//     columns of one output plane of one sample, times one N slice of at
//     most 96 output channels (wider C_out is cut into equal slices padded
//     to 16; each slice is a whole y for its channels, so every y element
//     has exactly one writer: no split-K, no atomics).  Warp w owns output
//     row w of the tile: 16 voxels, one M fragment, N / 8 accumulator
//     fragments in registers for the whole item.
//   * K is walked in C_in chunks of KC (16 or 32) channels, and each chunk
//     in its three kz planes.  Per chunk the block stages the x halo region
//     (3 planes x 10 x 18 voxels x KC channels; planes z - p .. z + 2 - p,
//     zero outside the input, past C_in and in the padded channels) by
//     cp.async where C_in % 8 == 0, else by scalar loads.  The weights of
//     one kz plane of the chunk (9 taps x KC x N) are streamed through a
//     ring of two shared-memory slots by cp.async, the next plane's copy in
//     flight while the current one multiplies, also across chunk and
//     work-item boundaries.  Shared voxel and weight-row strides are
//     KC + 8 and N + 8 elements (odd multiples of 16 bytes), so the 8 rows
//     of every ldmatrix hit distinct banks.
//   * A fragment of tap (kz, ky, kx): the region voxels (kz, w + ky,
//     column + kx) by ldmatrix.x4, taps not flipped.  B: the weight slot
//     holds rows k[t, i, .] with C_out (= N) contiguous, i.e. K-major, so
//     mma's .col fragment comes from ldmatrix.x4.trans.
//   * Narrow input (C_in <= 5; the entry conv has 2 channels): padding
//     C_in to 16 would leave 7/8 of every mma empty, so the three kx taps
//     are packed into one 16-wide K step.  A staged voxel holds x[w],
//     x[w + 1], x[w + 2] side by side (channel kx * C_in + i; 4-byte
//     cp.async copies where C_in is even), K is the 9 (kz, ky) taps x 16,
//     and one weight slot holds them all: a third of the mma and ldmatrix
//     work and one staging wait per work item.
//   * Epilogue: bias (vector, or the table row of the output plane) added
//     and the activation applied in float32, then one rounding to bfloat16;
//     stored NDHWC as bf16 pairs where C_out is even, masked at the ragged
//     H / W edges and the padded channels.
//   * Shared memory at most 107,712 bytes a block (two blocks per SM), and
//     __launch_bounds__(256, 2) caps the registers at 128 a thread (three
//     blocks and 85 registers for the packed form at N <= 16).
//
// Bound on the H100: 2 * 27 * C_in * C_out FLOPs per output voxel against
// about 2 * (C_in + C_out) bytes of x read and y written: below the 295
// FLOP/byte ridge at 16 channels (the bytes bound it), above it at 32 and
// more (the tensor-core rate).  This version spends its time in the
// block-wide waits at each staging (the x region's copies are waited for
// at once), mma.sync's instruction rate and the ldmatrix traffic, and the
// ragged last column tile (16 columns per M fragment).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "conv3x3_bwd.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using stroke::activate;
using stroke::cp_async16;
using stroke::cp_async4;
using stroke::cp_async_commit;
using stroke::cp_async_wait_all;
using stroke::cp_async_wait_group;
using stroke::Geo;
using stroke::ldsm_x4;
using stroke::ldsm_x4_trans;
using stroke::mma_bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTH = kWarps;            // tile rows: one per warp
constexpr int kTW = 16;                // tile columns: one mma M fragment
constexpr int kRH = kTH + 2;           // halo region rows
constexpr int kRW = kTW + 2;           // halo region columns
constexpr int kPlane = kRH * kRW;
constexpr int kRegion = 3 * kPlane;    // voxels of a 3-plane halo region
constexpr int kMaxSlice = 96;          // widest N slice (output channels)

// flags: which operands allow vector accesses
constexpr int kVecK = 1;    // 16-byte copies of k (C_out % 8 == 0, aligned)
constexpr int kVecX = 2;    // 16-byte copies of x (C_in % 8 == 0, aligned)
constexpr int kVecY = 4;    // 4-byte stores of y pairs (C_out even)
constexpr int kPairX = 8;   // 4-byte copies of x pairs (C_in even, aligned)

// NI: 16-channel slices of N (C_out) per work item; NO: of a C_in chunk.
template <int NI, int NO>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * ((size_t)2 * 9 * 16 * NO * (16 * NI + 8)  // weights
                         + (size_t)kRegion * (16 * NO + 8));       // x
}

// kPack: the narrow-input form (3 * C_in <= 16, one 16-wide chunk): a
// staged voxel holds x[w], x[w + 1], x[w + 2] side by side (channel
// kx * C_in + i), so K is the 9 (kz, ky) taps x 16 and one weight slot holds
// all of them.  Blocks per SM: two (at most 128 registers a thread), or
// three (85) for the packed form with one 16-channel slice, which fits them
// without spilling (the unpacked one spills 72 B at 85): the third block
// hides more of its staging waits.
template <bool kPack, int NI>
constexpr int min_blocks() {
  return kPack && NI == 1 ? 3 : 2;
}

template <int NI, int NO, bool kPack>
__global__ void __launch_bounds__(kThreads, (min_blocks<kPack, NI>()))
conv3x3_fwd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ k,
                      const float* __restrict__ bias, bf16* __restrict__ y,
                      Geo geo, int n_slices, int bias_table, int act,
                      float alpha, int flags) {
  static_assert(!kPack || NO == 1, "the packed form takes one 16-wide chunk");
  constexpr int NS = 16 * NI;          // output channels of a slice
  constexpr int KC = 16 * NO;          // input channels of a chunk
  constexpr int XS = KC + 8;           // staged x voxel stride (elements)
  constexpr int WS = NS + 8;           // weight row (one input channel)
  constexpr int kSlot = 9 * KC * WS;   // one kz plane of a chunk's weights
  constexpr int kPlanes = kPack ? 1 : 3;  // weight slots per chunk

  extern __shared__ uint4 smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* xs = ws + 2 * kSlot;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c_in = geo.c_in, c_out = geo.c_out, p = geo.z_pad;
  const int n_chunks = (c_in + KC - 1) / KC;
  const long long n_work = geo.n_tiles * n_slices;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // ws[slot][t9][i][o] = k[kz, t9, ci0 + i, co0 + o], zero-padded; packed:
  // k[t9 / 3, t9 % 3, i / C_in, i % C_in, co0 + o] for i < 3 * C_in.
  // Sets the tap and input channel of weight row (t9, i); false past C_in.
  auto k_row = [&](int ci0, int kz, int t9, int i, int& tap, int& ci) {
    if constexpr (kPack) {
      tap = t9 * 3 + i / c_in;
      ci = i % c_in;
      return i < 3 * c_in;
    } else {
      tap = kz * 9 + t9;
      ci = ci0 + i;
      return ci < c_in;
    }
  };
  auto load_plane = [&](long long work, int chunk, int kz, int slot) {
    const int co0 = (int)(work % n_slices) * NS, ci0 = chunk * KC;
    bf16* dst = ws + slot * kSlot;
    if (flags & kVecK) {
      constexpr int C8 = NS / 8, N = 9 * KC * C8;
      for (int e = tid; e < N; e += kThreads) {
        const int c = (e % C8) * 8, i = (e / C8) % KC, t9 = e / (C8 * KC);
        int tap, ci;
        const int co = co0 + c;
        const bool ok = k_row(ci0, kz, t9, i, tap, ci) && co < c_out;
        const bf16* src =
            ok ? k + ((long long)tap * c_in + ci) * c_out + co : k;
        cp_async16(dst + (t9 * KC + i) * WS + c, src, ok);
      }
    } else {
      for (int e = tid; e < 9 * KC * NS; e += kThreads) {
        const int c = e % NS, i = (e / NS) % KC, t9 = e / (NS * KC);
        int tap, ci;
        const int co = co0 + c;
        dst[(t9 * KC + i) * WS + c] =
            (k_row(ci0, kz, t9, i, tap, ci) && co < c_out)
                ? k[((long long)tap * c_in + ci) * c_out + co]
                : zero;
      }
    }
  };

  // Scalar or packed staging of a single chunk writes only its real
  // channels; the padded ones are zeroed here once and never written again.
  const int staged_width =
      kPack ? 3 * c_in : (n_chunks == 1 && c_in < KC ? c_in : KC);
  if ((kPack || !(flags & kVecX)) && staged_width < KC) {
    for (int e = tid; e < kRegion * XS; e += kThreads) xs[e] = zero;
  }

  // per-lane ldmatrix rows (see the fragment layouts of m16n8k16):
  // A: row lane % 16, k half lane / 16;
  // B (.trans of K-major rows): k row ((lane / 8) % 2) * 8 + lane % 8,
  // n half lane / 16.
  const int a_row = lane % 16, a_k = (lane / 16) * 8;
  const int b_k = ((lane / 8) % 2) * 8 + lane % 8, b_n = (lane / 16) * 8;

  long long work = blockIdx.x;
  if (work >= n_work) return;
  load_plane(work, 0, 0, 0);
  cp_async_commit();
  int slot = 0;

  for (; work < n_work; work += gridDim.x) {
    const int co0 = (int)(work % n_slices) * NS;
    long long r = work / n_slices;
    const int tw = (int)(r % geo.n_tw);
    r /= geo.n_tw;
    const int th = (int)(r % geo.n_th);
    r /= geo.n_th;
    const int z = (int)(r % geo.tile_d);
    const int b = (int)(r / geo.tile_d);
    const int h0 = th * kTH, w0 = tw * kTW;

    float acc[2 * NI][4];
#pragma unroll
    for (int n = 0; n < 2 * NI; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[n][q] = 0.f;

#pragma unroll 1
    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      const int ci0 = chunk * KC;
#pragma unroll 1
      for (int kz = 0; kz < kPlanes; ++kz) {
        // this plane's weights have landed, and every warp is done with
        // the other slot (the previous plane) and, at kz 0, with the x
        // region of the previous chunk
        cp_async_wait_all();
        __syncthreads();

        if (kz == 0) {
          // x region of this chunk: planes iz = z - p + rz, rows h0 + rh,
          // columns w0 + rw; zero outside the input and past C_in
          if constexpr (kPack) {
            // columns rw < 16, channel kx * C_in + i = x[.., w0 + rw + kx, i]
            const bool pairs = flags & kPairX;
            const int per = pairs ? c_in / 2 : c_in;  // copies per kx
            for (int e = tid; e < 3 * kRH * kTW * 3 * per; e += kThreads) {
              const int v = e / (3 * per), kx = (e / per) % 3, j = e % per;
              const int rw = v % kTW, rh = (v / kTW) % kRH;
              const int rz = v / (kTW * kRH);
              const int iz = z - p + rz, ih = h0 + rh, iw = w0 + rw + kx;
              const int i = pairs ? 2 * j : j;
              const bool ok =
                  iz >= 0 && iz < geo.d_in && ih < geo.h && iw < geo.w;
              const long long at =
                  ((((long long)b * geo.d_in + iz) * geo.h + ih) * geo.w +
                   iw) * c_in + i;
              bf16* dst =
                  xs + ((rz * kRH + rh) * kRW + rw) * XS + kx * c_in + i;
              if (pairs) {
                cp_async4(dst, ok ? x + at : x, ok);
              } else {
                *dst = ok ? x[at] : zero;
              }
            }
          } else if (flags & kVecX) {
            constexpr int C8 = KC / 8, N = kRegion * C8;
            for (int e = tid; e < N; e += kThreads) {
              const int vox = e / C8, c = (e % C8) * 8;
              const int rw = vox % kRW, rh = (vox / kRW) % kRH;
              const int iz = z - p + vox / kPlane, ih = h0 + rh;
              const int iw = w0 + rw;
              const bool ok = ci0 + c < c_in && iz >= 0 && iz < geo.d_in &&
                              ih < geo.h && iw < geo.w;
              const bf16* src =
                  ok ? x + ((((long long)b * geo.d_in + iz) * geo.h + ih) *
                                geo.w + iw) * c_in + ci0 + c
                     : x;
              cp_async16(xs + vox * XS + c, src, ok);
            }
          } else {
            const int cw = staged_width;
            for (int e = tid; e < kRegion * cw; e += kThreads) {
              const int vox = e / cw, c = e % cw;
              const int rw = vox % kRW, rh = (vox / kRW) % kRH;
              const int iz = z - p + vox / kPlane, ih = h0 + rh;
              const int iw = w0 + rw;
              xs[vox * XS + c] =
                  (ci0 + c < c_in && iz >= 0 && iz < geo.d_in && ih < geo.h &&
                   iw < geo.w)
                      ? x[((((long long)b * geo.d_in + iz) * geo.h + ih) *
                               geo.w + iw) * c_in + ci0 + c]
                      : zero;
            }
          }
          cp_async_commit();
        }

        if (kz + 1 < kPlanes) {
          load_plane(work, chunk, kz + 1, slot ^ 1);
        } else if (chunk + 1 < n_chunks) {
          load_plane(work, chunk + 1, 0, slot ^ 1);
        } else if (work + gridDim.x < n_work) {
          load_plane(work + gridDim.x, 0, 0, slot ^ 1);
        }
        cp_async_commit();

        if (kz == 0) {
          // the region's copies have landed (the next plane's may not)
          cp_async_wait_group<1>();
          __syncthreads();
        }

        // the 9 taps (kz, ky, kx) of this plane: x[z + kz - p, h + ky,
        // w + kx] is region plane kz; packed, the 9 taps (kz, ky) with kx
        // in the channels
        const bf16* wsl = ws + slot * kSlot;
#pragma unroll
        for (int t9 = 0; t9 < 9; ++t9) {
          const int rz = kPack ? t9 / 3 : kz;
          const int ky = kPack ? t9 % 3 : t9 / 3, kx = kPack ? 0 : t9 % 3;
          const bf16* ap =
              xs + ((rz * kRH + warp + ky) * kRW + a_row + kx) * XS + a_k;
          const bf16* bp = wsl + (t9 * KC + b_k) * WS + b_n;
#pragma unroll
          for (int ks = 0; ks < NO; ++ks) {
            unsigned a[4];
            ldsm_x4(a, ap + ks * 16);
#pragma unroll
            for (int ni = 0; ni < NI; ++ni) {
              unsigned bq[4];
              ldsm_x4_trans(bq, bp + ks * 16 * WS + ni * 16);
              mma_bf16(acc[2 * ni], a, bq[0], bq[1]);
              mma_bf16(acc[2 * ni + 1], a, bq[2], bq[3]);
            }
          }
        }
        slot ^= 1;
      }
    }

    // y of output row h0 + warp, columns w0 .. w0 + 15, channels of the
    // slice: bias and activation in float32, one rounding
    const int oh = h0 + warp;
    if (oh < geo.h_out) {
      const float* bp = bias + (bias_table ? (long long)z * c_out : 0);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ow = w0 + lane / 4 + 8 * half;
        if (ow >= geo.w_out) continue;
        bf16* yp = y + ((((long long)b * geo.d_out + z) * geo.h_out + oh) *
                            geo.w_out + ow) * c_out;
#pragma unroll
        for (int n = 0; n < 2 * NI; ++n) {
          const int co = co0 + n * 8 + (lane % 4) * 2;
          if (co >= c_out) continue;
          const float v0 = activate(acc[n][2 * half] + __ldg(bp + co), act,
                                    alpha);
          if (flags & kVecY) {
            const float v1 = activate(
                acc[n][2 * half + 1] + __ldg(bp + co + 1), act, alpha);
            *reinterpret_cast<__nv_bfloat162*>(yp + co) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            yp[co] = __float2bfloat16_rn(v0);
            if (co + 1 < c_out) {
              yp[co + 1] = __float2bfloat16_rn(activate(
                  acc[n][2 * half + 1] + __ldg(bp + co + 1), act, alpha));
            }
          }
        }
      }
    }
  }
}

// Launches one instantiation over n_work items with as many persistent
// blocks as the card holds at once (found once per process).
template <int NI, int NO, bool kPack>
cudaError_t launch(const bf16* x, const bf16* k, const float* bias, bf16* y,
                   const Geo& geo, int n_slices, int bias_table, int act,
                   float alpha, int flags, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NI, NO>();
  static int resident = 0;
  if (!resident) {
    // also sets the kernel's dynamic shared-memory limit, which persists
    const cudaError_t err = stroke::persistent_blocks(
        conv3x3_fwd_tc_kernel<NI, NO, kPack>, kThreads, smem, 1LL << 62,
        &resident);
    if (err != cudaSuccess) return err;
    if (resident < 1) return cudaErrorInvalidConfiguration;
  }
  const long long n_work = geo.n_tiles * n_slices;
  const int n_blocks = (int)(n_work < resident ? n_work : resident);
  if (n_blocks < 1) return cudaSuccess;
  conv3x3_fwd_tc_kernel<NI, NO, kPack><<<n_blocks, kThreads, smem, stream>>>(
      x, k, bias, y, geo, n_slices, bias_table, act, alpha, flags);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  The caller has checked
// shapes, dtypes, devices and contiguity and allocated y.  Every
// C_in, C_out >= 1 is taken: C_out is cut into n_slices equal N slices of
// at most 96 channels padded to 16 (NI 16-channel groups); C_in of at most
// 5 takes the packed form (the three kx taps in one 16-wide K step), wider
// C_in is walked in chunks of 32 where C_in' is a multiple of 32 and a
// slice at most 48 channels wide (the x region and two weight planes then
// still fit two blocks per SM), else of 16.
extern "C" int conv3x3_fwd_bf16(const bf16* x, const bf16* k,
                                const float* bias, bf16* y, int batch,
                                int d_in, int h, int w, int c_in, int c_out,
                                int z_pad, int bias_table, int act,
                                float alpha, void* stream) {
  if (c_in < 1 || c_out < 1) return cudaErrorInvalidValue;
  const Geo geo = stroke::make_geo(batch, d_in, h, w, c_in, c_out, z_pad,
                                   false, kTH, kTW);
  const int cip = (c_in + 15) / 16 * 16, cop = (c_out + 15) / 16 * 16;
  const int n_slices = (cop + kMaxSlice - 1) / kMaxSlice;
  const int ni = ((c_out + n_slices - 1) / n_slices + 15) / 16;
  const bool wide_k = cip % 32 == 0 && ni <= 3;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int flags = (c_out % 8 == 0 && aligned(k, 16) ? kVecK : 0) |
                    (c_in % 8 == 0 && aligned(x, 16) ? kVecX : 0) |
                    (c_out % 2 == 0 && aligned(y, 4) ? kVecY : 0) |
                    (c_in % 2 == 0 && aligned(x, 4) ? kPairX : 0);
#define STROKE_FWD_LAUNCH(NI_, NO_, PACK_)                                \
  launch<NI_, NO_, PACK_>(x, k, bias, y, geo, n_slices, bias_table, act, \
                          alpha, flags, s)
  if (3 * c_in <= 16) {
    switch (ni) {
      case 1: return STROKE_FWD_LAUNCH(1, 1, true);
      case 2: return STROKE_FWD_LAUNCH(2, 1, true);
      case 3: return STROKE_FWD_LAUNCH(3, 1, true);
      case 4: return STROKE_FWD_LAUNCH(4, 1, true);
      case 5: return STROKE_FWD_LAUNCH(5, 1, true);
      case 6: return STROKE_FWD_LAUNCH(6, 1, true);
    }
  }
  if (wide_k) {
    switch (ni) {
      case 1: return STROKE_FWD_LAUNCH(1, 2, false);
      case 2: return STROKE_FWD_LAUNCH(2, 2, false);
      case 3: return STROKE_FWD_LAUNCH(3, 2, false);
    }
  }
  switch (ni) {
    case 1: return STROKE_FWD_LAUNCH(1, 1, false);
    case 2: return STROKE_FWD_LAUNCH(2, 1, false);
    case 3: return STROKE_FWD_LAUNCH(3, 1, false);
    case 4: return STROKE_FWD_LAUNCH(4, 1, false);
    case 5: return STROKE_FWD_LAUNCH(5, 1, false);
    case 6: return STROKE_FWD_LAUNCH(6, 1, false);
  }
#undef STROKE_FWD_LAUNCH
  return cudaErrorInvalidValue;
}
