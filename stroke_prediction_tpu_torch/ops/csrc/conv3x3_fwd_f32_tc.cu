// float32 fused 3x3x3 stride-1 convolution forward
// y = act(conv3d(x, k) + b) on Hopper's tensor cores in 3xTF32 (kernel K1 of
// the port, float32 storage; the bfloat16 K1 is conv3x3_fwd_tc.cu's).
//
// Replaces stroke_prediction_tpu/ops/pallas/s2d.py _conv_kernel (launched by
// _s2d_conv_p, API s2d_conv; float32 sums at s2d.py:419-420):
//
//   y[z,h,w,o] = act(sum_{t,i} x[z + tz - p, h + ty, w + tx, i] * k[t, i, o]
//                    + b[o])
//
// over NDHWC float32 tensors, p = z_pad (0 'v', 1 's'), x zero outside
// [0, D_in) in z; b a float32 vector (C_out,) or a per-output-plane
// (D_out, C_out) table (fold_bn_zsame); bias and activation in float32.
// act: 0 none, 1 LeakyReLU(alpha), 2 ELU(alpha) with the exp of the clamped
// value.
//
// Arithmetic (3xTF32): every operand v is split into big = tf32(v) and
// small = tf32(v - big) (cvt.rna.tf32.f32: round to nearest, ties away from
// zero, to a 10-bit mantissa), and a * b is taken as small_a * big_b +
// big_a * small_b + big_a * big_b, in that order, on
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 into the same float32
// accumulators.  That keeps about 21 of float32's 24 mantissa bits per
// product (one TF32 product keeps 11, and fails the port's float32 limit of
// 1e-4).  The tensor cores' float32 sums truncate toward zero, a bias that
// grows with the chain of mma into one accumulator, so the three products
// of each k8 step go into fresh registers (a 3-mma chain, truncated at the
// scale of its 8 products) and are added to the work item's sum in IEEE
// float32 (round to nearest).  Chains over whole kz planes (54 mma) kept y
// within 1.3e-6 of max|y| of a float64 conv, but their bias moved one
// float32 training step's gradients 2e-3 of max|grad| off the CPU's (the
// limit is 1e-3); per k8 step the card's step is closer to float64 than the
// CPU's own.
//
// Design: the bfloat16 K1's (conv3x3_fwd_tc.cu) implicit GEMM with
// M = output voxels, N = C_out, K = 27 taps x C_in.
//   * A persistent block of 8 warps walks work items: a tile of 8 rows x 16
//     columns of one output plane of one sample, times one N slice of at
//     most 32 output channels (wider C_out is cut into equal slices padded
//     to 16; each y element has exactly one writer: no split-K, no atomics,
//     the same bits on every run).  Warp w owns output row w of the tile:
//     16 voxels, one M fragment, N / 8 accumulator fragments.
//   * K is walked in steps: each C_in chunk of 16 channels in its three kz
//     planes.  A step's operands (the x plane z + kz - p of the halo region,
//     10 x 18 voxels x 16 channels, zero outside the input and past C_in;
//     the weights of the plane, 9 taps x 16 x N) land by cp.async in one of
//     two ring slots, the next step's copies in flight while the current
//     step is split and multiplied, also across chunk and work-item
//     boundaries: no wait for x is left exposed.
//   * The split is made once per element, in shared memory: when a step's
//     slot has landed, the block rewrites it in place as its big halves and
//     writes the small halves to one more buffer of the same layout (one
//     pass of 16-byte accesses).  The fragments are then plain loads: every
//     x element feeds 9 taps of its 8 warps, and every weight all 8 warps,
//     so a split at fragment load, in registers, repeats each split up to
//     72 times and costs more instruction slots than the three mma (it was
//     slower on the card, split for both operands or for x alone).
//   * A fragment of tap (ky, kx): the plane's voxels (w + ky, column + kx)
//     by ldmatrix.x4 (b16 pairs: a 16-byte row of 4 floats gives
//     m16n8k8's tf32 A fragment), once from the big and once from the small
//     halves.  The voxel stride is 20 floats (80 bytes, an odd multiple of
//     16), so the 8 rows of every ldmatrix hit distinct banks.
//   * B: ldmatrix.trans moves 16-bit elements only, so it cannot give the
//     tf32 .col fragment from the weight rows k[t, i, .] (C_out
//     contiguous, K-major).  They are not transposed: each lane reads its
//     two elements (k row tig and tig + 4, column group) by ld.shared.b32.
//     The weight row stride is N + 8 floats, 8 or 24 words mod 32, so the
//     four k rows x eight columns of a warp's read fall in 32 distinct
//     banks, and the weights keep their 16-byte cp.async copies.
//   * Narrow input (C_in <= 2; the entry conv has 2 channels): padding
//     C_in to 16 would leave most of every mma empty, so the three kx taps
//     are packed into one 8-wide K step.  A staged voxel holds x[w],
//     x[w + 1], x[w + 2] side by side (channel kx * C_in + i; 8-byte
//     cp.async copies where C_in is 2), the step is the whole item (the
//     three x planes, K the 9 (kz, ky) taps x 8, a 27-mma chain), and the
//     ring prefetches the next item's region.  Each x element feeds only 3
//     taps here, so x is split at fragment load (in registers) and only
//     the weights in shared memory, which leaves room for three blocks per
//     SM (faster on the card than splitting the region in shared memory).
//   * Epilogue: bias (vector, or the table row of the output plane) added
//     and the activation applied in float32; stored NDHWC as float pairs
//     where C_out is even, masked at the ragged H / W edges and the padded
//     channels.
//   * Shared memory: two slots and the small halves, at most 112,320 bytes
//     a block (two blocks per SM; three of 72,576 for the packed form with
//     one 16-channel slice); __launch_bounds__ caps the registers at 128 a
//     thread (85).
//
// Bound on the H100: 2 * 27 * C_in * C_out FLOPs per output voxel against
// 4 * (C_in + C_out) bytes of x read and y written.  3xTF32 runs three
// TF32 products per product, so the operations bound is the FLOPs at a
// third of the 495 TFLOP/s TF32 rate (165); the entry conv (2 -> 16) is
// bound by its bytes.  Per mma the warps also run about one fragment load
// and an IEEE add, per step the split pass and the copies, and every step
// waits at two block-wide barriers.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "conv3x3_bwd.cuh"
#include "mma_bf16.cuh"

namespace {

using stroke::activate;
using stroke::cp_async16;
using stroke::cp_async4;
using stroke::cp_async8;
using stroke::cp_async_commit;
using stroke::cp_async_wait_all;
using stroke::Geo;
using stroke::ldsm_x4;
using stroke::mma_tf32;
using stroke::split_tf32;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTH = kWarps;            // tile rows: one per warp
constexpr int kTW = 16;                // tile columns: one mma M fragment
constexpr int kRH = kTH + 2;           // halo region rows
constexpr int kRW = kTW + 2;           // halo region columns
constexpr int kPlane = kRH * kRW;      // voxels of one halo plane
constexpr int kMaxSlice = 32;          // widest N slice (output channels)

// flags: which operands allow vector accesses
constexpr int kVecK = 1;    // 16-byte copies of k (C_out % 4 == 0, aligned)
constexpr int kVecX = 2;    // 16-byte copies of x (C_in % 4 == 0, aligned)
constexpr int kVecY = 4;    // 8-byte stores of y pairs (C_out even, aligned)
constexpr int kPairX = 8;   // 8-byte copies of x pairs (C_in == 2, aligned)

// The floats of one ring slot: the x part (one halo plane, or the three of
// the packed form, at a voxel stride of KC + 4) and the weight part (9 taps
// x KC rows of 16 * NI + 8).
template <int NI, int KC, bool kPack>
struct Slot {
  static constexpr int kX = (kPack ? 3 : 1) * kPlane * (KC + 4);
  static constexpr int kW = 9 * KC * (16 * NI + 8);
  static constexpr int kFloats = kX + kW;
};

// two ring slots and the small halves of one (of its weight part alone in
// the packed form)
template <int NI, int KC, bool kPack>
constexpr size_t smem_bytes() {
  using S = Slot<NI, KC, kPack>;
  return sizeof(float) *
         (2 * (size_t)S::kFloats + (kPack ? S::kW : S::kFloats));
}

// Blocks per SM: two (at most 128 registers a thread), or three for the
// packed form with one 16-channel slice, whose shared memory fits three.
template <bool kPack, int NI>
constexpr int min_blocks() {
  return kPack && NI == 1 ? 3 : 2;
}

// NI: 16-channel slices of N (C_out) per work item; KC: channels of a C_in
// chunk (16, or 8 for the packed form).  kPack: the narrow-input form
// (3 * C_in <= 8): a staged voxel holds x[w], x[w + 1], x[w + 2] side by
// side (channel kx * C_in + i), so K is the 9 (kz, ky) taps x 8.
template <int NI, int KC, bool kPack>
__global__ void __launch_bounds__(kThreads, (min_blocks<kPack, NI>()))
conv3x3_fwd_f32_tc_kernel(const float* __restrict__ x,
                          const float* __restrict__ k,
                          const float* __restrict__ bias,
                          float* __restrict__ y, Geo geo, int n_slices,
                          int bias_table, int act, float alpha, int flags) {
  static_assert(!kPack || KC == 8, "the packed form takes one 8-wide chunk");
  static_assert(KC % 8 == 0, "a chunk is whole k8 steps");
  using S = Slot<NI, KC, kPack>;
  constexpr int NS = 16 * NI;          // output channels of a slice
  constexpr int XS = KC + 4;           // staged x voxel stride (floats)
  constexpr int WS = NS + 8;           // weight row (one input channel)
  constexpr int kSteps = kPack ? 1 : 3;  // steps (kz planes) per chunk

  // slot s at ring + s * S::kFloats: [x part | weight part]; small_half:
  // the small halves of the slot being multiplied, in the same layout (the
  // packed form splits its x fragments in registers, and keeps the small
  // halves of the weight part alone: small_half + S::kX is its first)
  extern __shared__ uint4 smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* small_half = ring + 2 * S::kFloats - (kPack ? S::kX : 0);
  constexpr int kSplit0 = kPack ? S::kX : 0;   // first float split in smem

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c_in = geo.c_in, c_out = geo.c_out, p = geo.z_pad;
  const int n_chunks = (c_in + KC - 1) / KC;
  const long long n_work = geo.n_tiles * n_slices;

  // A work item: N slice co0, sample b, output plane z, tile origin h0, w0.
  struct Item {
    int co0, b, z, h0, w0;
  };
  auto item = [&](long long work) {
    Item it;
    it.co0 = (int)(work % n_slices) * NS;
    long long r = work / n_slices;
    it.w0 = (int)(r % geo.n_tw) * kTW;
    r /= geo.n_tw;
    it.h0 = (int)(r % geo.n_th) * kTH;
    r /= geo.n_th;
    it.z = (int)(r % geo.tile_d);
    it.b = (int)(r / geo.tile_d);
    return it;
  };

  // Weight row (t9, i) of a step: k[kz, t9, ci0 + i, .], zero-padded;
  // packed: k[t9 / 3, t9 % 3, i / C_in, i % C_in, .] for i < 3 * C_in.
  // Sets its tap and input channel; false past C_in.
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
  // Starts the copies of step (chunk, kz) of a work item into a slot.
  auto load_step = [&](long long work, int chunk, int kz, int slot) {
    const Item it = item(work);
    const int ci0 = chunk * KC;
    float* xd = ring + slot * S::kFloats;
    float* wd = xd + S::kX;
    if (flags & kVecK) {
      constexpr int C4 = NS / 4, N = 9 * KC * C4;
      for (int e = tid; e < N; e += kThreads) {
        const int c = (e % C4) * 4, i = (e / C4) % KC, t9 = e / (C4 * KC);
        int tap, ci;
        const int co = it.co0 + c;
        const bool ok = k_row(ci0, kz, t9, i, tap, ci) && co < c_out;
        const float* src =
            ok ? k + ((long long)tap * c_in + ci) * c_out + co : k;
        cp_async16(wd + (t9 * KC + i) * WS + c, src, ok);
      }
    } else {
      for (int e = tid; e < 9 * KC * NS; e += kThreads) {
        const int c = e % NS, i = (e / NS) % KC, t9 = e / (NS * KC);
        int tap, ci;
        const int co = it.co0 + c;
        const bool ok = k_row(ci0, kz, t9, i, tap, ci) && co < c_out;
        const float* src =
            ok ? k + ((long long)tap * c_in + ci) * c_out + co : k;
        cp_async4(wd + (t9 * KC + i) * WS + c, src, ok);
      }
    }
    if constexpr (kPack) {
      // the three planes iz = z - p + rz, rows h0 + rh, columns w0 + rw
      // (rw < 16); channel kx * C_in + i = x[.., w0 + rw + kx, i]
      const bool pairs = flags & kPairX;
      const int per = pairs ? 1 : c_in;  // copies per kx
      for (int e = tid; e < 3 * kRH * kTW * 3 * per; e += kThreads) {
        const int v = e / (3 * per), kx = (e / per) % 3, j = e % per;
        const int rw = v % kTW, rh = (v / kTW) % kRH, rz = v / (kTW * kRH);
        const int iz = it.z - p + rz, ih = it.h0 + rh, iw = it.w0 + rw + kx;
        const bool ok = iz >= 0 && iz < geo.d_in && ih < geo.h && iw < geo.w;
        const long long at =
            ((((long long)it.b * geo.d_in + iz) * geo.h + ih) * geo.w + iw) *
                c_in + j;
        float* dst = xd + ((rz * kRH + rh) * kRW + rw) * XS + kx * c_in + j;
        if (pairs) {
          cp_async8(dst, ok ? x + at : x, ok);
        } else {
          cp_async4(dst, ok ? x + at : x, ok);
        }
      }
    } else {
      // plane iz = z + kz - p, rows h0 + rh, columns w0 + rw, channels
      // ci0 .. ci0 + KC - 1; zero outside the input and past C_in
      const int iz = it.z + kz - p;
      const bool vec = flags & kVecX;
      const int per = vec ? KC / 4 : KC;    // copies per voxel
      for (int e = tid; e < kPlane * per; e += kThreads) {
        const int vox = e / per, c = (e % per) * (vec ? 4 : 1);
        const int ih = it.h0 + vox / kRW, iw = it.w0 + vox % kRW;
        const bool ok = ci0 + c < c_in && iz >= 0 && iz < geo.d_in &&
                        ih < geo.h && iw < geo.w;
        const float* src =
            ok ? x + ((((long long)it.b * geo.d_in + iz) * geo.h + ih) *
                          geo.w + iw) * c_in + ci0 + c
               : x;
        if (vec) {
          cp_async16(xd + vox * XS + c, src, ok);
        } else {
          cp_async4(xd + vox * XS + c, src, ok);
        }
      }
    }
  };

  // The packed staging writes only the real channels (kx * C_in + i <
  // 3 * C_in) of the x parts; the padded ones are zeroed here once, split
  // to zeros, and never written again.
  if constexpr (kPack) {
    for (int e = tid; e < S::kX; e += kThreads) {
      ring[e] = 0.f;
      ring[S::kFloats + e] = 0.f;
    }
    __syncthreads();
  }

  // per-lane fragment rows (see the fragment layouts of m16n8k8.tf32):
  // A by ldmatrix.x4: row lane % 16, k half lane / 16 (4 floats);
  // B by ld.shared.b32: k row lane % 4 (and + 4), n column lane / 4.
  const int a_row = lane % 16, a_k = (lane / 16) * 4;
  const int b_k = lane % 4, b_n = lane / 4;

  long long work = blockIdx.x;
  if (work >= n_work) return;
  load_step(work, 0, 0, 0);
  cp_async_commit();
  int slot = 0;

  for (; work < n_work; work += gridDim.x) {
    const Item it = item(work);

    float acc[2 * NI][4];
#pragma unroll
    for (int n = 0; n < 2 * NI; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[n][q] = 0.f;

#pragma unroll 1
    for (int chunk = 0; chunk < n_chunks; ++chunk) {
#pragma unroll 1
      for (int kz = 0; kz < kSteps; ++kz) {
        // this step's copies have landed, and every warp is done with the
        // other slot (the previous step) and with the small halves
        cp_async_wait_all();
        __syncthreads();

        if (kz + 1 < kSteps) {
          load_step(work, chunk, kz + 1, slot ^ 1);
        } else if (chunk + 1 < n_chunks) {
          load_step(work, chunk + 1, 0, slot ^ 1);
        } else if (work + gridDim.x < n_work) {
          load_step(work + gridDim.x, 0, 0, slot ^ 1);
        }
        cp_async_commit();

        // split the slot: big halves in place, small halves beside
        float* big = ring + slot * S::kFloats;
        for (int e = tid + kSplit0 / 4; e < S::kFloats / 4; e += kThreads) {
          float4 v = reinterpret_cast<float4*>(big)[e], s;
          unsigned hi, lo;
          split_tf32(v.x, hi, lo);
          v.x = __uint_as_float(hi);
          s.x = __uint_as_float(lo);
          split_tf32(v.y, hi, lo);
          v.y = __uint_as_float(hi);
          s.y = __uint_as_float(lo);
          split_tf32(v.z, hi, lo);
          v.z = __uint_as_float(hi);
          s.z = __uint_as_float(lo);
          split_tf32(v.w, hi, lo);
          v.w = __uint_as_float(hi);
          s.w = __uint_as_float(lo);
          reinterpret_cast<float4*>(big)[e] = v;
          reinterpret_cast<float4*>(small_half)[e] = s;
        }
        __syncthreads();

        // the 9 taps (ky, kx) of this step's plane (packed: the 9 taps
        // (kz, ky) with kx in the channels).  Each k8 step's three products
        // go into fresh registers (a 3-mma chain, whose truncations are at
        // the scale of its 8 products), added to the item's sum in IEEE
        // float32.
#pragma unroll
        for (int t9 = 0; t9 < 9; ++t9) {
          const int rz = kPack ? t9 / 3 : 0;
          const int ky = kPack ? t9 % 3 : t9 / 3, kx = kPack ? 0 : t9 % 3;
          const int a_at =
              ((rz * kRH + warp + ky) * kRW + a_row + kx) * XS + a_k;
          const int b_at = S::kX + (t9 * KC + b_k) * WS + b_n;
#pragma unroll
          for (int ks = 0; ks < KC / 8; ++ks) {
            unsigned a_big[4], a_small[4];
            if constexpr (kPack) {
              unsigned a[4];
              ldsm_x4(a, big + a_at + ks * 8);
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                split_tf32(__uint_as_float(a[q]), a_big[q], a_small[q]);
              }
            } else {
              ldsm_x4(a_big, big + a_at + ks * 8);
              ldsm_x4(a_small, small_half + a_at + ks * 8);
            }
#pragma unroll
            for (int n = 0; n < 2 * NI; ++n) {
              const int at = b_at + ks * 8 * WS + n * 8;
              const unsigned b_big[2] = {__float_as_uint(big[at]),
                                         __float_as_uint(big[at + 4 * WS])};
              const unsigned b_small[2] = {
                  __float_as_uint(small_half[at]),
                  __float_as_uint(small_half[at + 4 * WS])};
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              mma_tf32(d, a_small, b_big);
              mma_tf32(d, a_big, b_small);
              mma_tf32(d, a_big, b_big);
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[n][q] += d[q];
            }
          }
        }
        slot ^= 1;
      }
    }

    // y of output row h0 + warp, columns w0 .. w0 + 15, channels of the
    // slice: bias and activation in float32
    const int oh = it.h0 + warp;
    if (oh < geo.h_out) {
      const float* bp = bias + (bias_table ? (long long)it.z * c_out : 0);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ow = it.w0 + lane / 4 + 8 * half;
        if (ow >= geo.w_out) continue;
        float* yp =
            y + ((((long long)it.b * geo.d_out + it.z) * geo.h_out + oh) *
                     geo.w_out + ow) * c_out;
#pragma unroll
        for (int n = 0; n < 2 * NI; ++n) {
          const int co = it.co0 + n * 8 + (lane % 4) * 2;
          if (co >= c_out) continue;
          const float v0 = activate(acc[n][2 * half] + __ldg(bp + co), act,
                                    alpha);
          if (flags & kVecY) {
            const float v1 = activate(
                acc[n][2 * half + 1] + __ldg(bp + co + 1), act, alpha);
            *reinterpret_cast<float2*>(yp + co) = make_float2(v0, v1);
          } else {
            yp[co] = v0;
            if (co + 1 < c_out) {
              yp[co + 1] = activate(acc[n][2 * half + 1] + __ldg(bp + co + 1),
                                    act, alpha);
            }
          }
        }
      }
    }
  }
}

// Launches one instantiation over n_work items with as many persistent
// blocks as the card holds at once (found once per process).
template <int NI, int KC, bool kPack>
cudaError_t launch(const float* x, const float* k, const float* bias,
                   float* y, const Geo& geo, int n_slices, int bias_table,
                   int act, float alpha, int flags, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NI, KC, kPack>();
  static int resident = 0;
  if (!resident) {
    // also sets the kernel's dynamic shared-memory limit, which persists
    const cudaError_t err = stroke::persistent_blocks(
        conv3x3_fwd_f32_tc_kernel<NI, KC, kPack>, kThreads, smem,
        1LL << 62, &resident);
    if (err != cudaSuccess) return err;
    if (resident < 1) return cudaErrorInvalidConfiguration;
  }
  const long long n_work = geo.n_tiles * n_slices;
  const int n_blocks = (int)(n_work < resident ? n_work : resident);
  if (n_blocks < 1) return cudaSuccess;
  conv3x3_fwd_f32_tc_kernel<NI, KC, kPack>
      <<<n_blocks, kThreads, smem, stream>>>(x, k, bias, y, geo, n_slices,
                                              bias_table, act, alpha, flags);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  The caller has checked
// shapes, dtypes, devices and contiguity and allocated y.  Every
// C_in, C_out >= 1 is taken: C_out is cut into n_slices equal N slices of
// at most 32 channels padded to 16 (NI 16-channel groups); C_in of at most
// 2 takes the packed form (the three kx taps in one 8-wide K step), wider
// C_in is walked in chunks of 16.
extern "C" int conv3x3_fwd_f32(const float* x, const float* k,
                               const float* bias, float* y, int batch,
                               int d_in, int h, int w, int c_in, int c_out,
                               int z_pad, int bias_table, int act,
                               float alpha, void* stream) {
  if (c_in < 1 || c_out < 1) return cudaErrorInvalidValue;
  const Geo geo = stroke::make_geo(batch, d_in, h, w, c_in, c_out, z_pad,
                                   false, kTH, kTW);
  const int cop = (c_out + 15) / 16 * 16;
  const int n_slices = (cop + kMaxSlice - 1) / kMaxSlice;
  const int ni = ((c_out + n_slices - 1) / n_slices + 15) / 16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int flags = (c_out % 4 == 0 && aligned(k, 16) ? kVecK : 0) |
                    (c_in % 4 == 0 && aligned(x, 16) ? kVecX : 0) |
                    (c_out % 2 == 0 && aligned(y, 8) ? kVecY : 0) |
                    (c_in == 2 && aligned(x, 8) ? kPairX : 0);
  const bool pack = 3 * c_in <= 8;
  if (ni == 1) {
    return pack ? launch<1, 8, true>(x, k, bias, y, geo, n_slices,
                                     bias_table, act, alpha, flags, s)
                : launch<1, 16, false>(x, k, bias, y, geo, n_slices,
                                       bias_table, act, alpha, flags, s);
  }
  if (ni == 2) {
    return pack ? launch<2, 8, true>(x, k, bias, y, geo, n_slices,
                                     bias_table, act, alpha, flags, s)
                : launch<2, 16, false>(x, k, bias, y, geo, n_slices,
                                       bias_table, act, alpha, flags, s);
  }
  return cudaErrorInvalidValue;
}
