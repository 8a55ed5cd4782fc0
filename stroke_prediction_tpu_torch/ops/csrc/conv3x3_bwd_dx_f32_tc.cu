// float32 input gradient of the 3x3x3 stride-1 convolution
// y = act(conv3d(x, k) + b) on Hopper's tensor cores in 3xTF32 (kernel K3
// of the port, float32 storage; the bfloat16 K3 is conv3x3_bwd_dx_tc.cu's).
//
// Replaces stroke_prediction_tpu/ops/pallas/s2d.py _dx_kernel (dx alone, the
// split form of the backward that layers too wide for the fused K2 take):
//
//   g'           = g * act'(y)   (from the saved OUTPUT, in float32:
//                                 LeakyReLU 1 / alpha, ELU 1 / y + alpha,
//                                 none 1)
//   dx[z,h,w,i]  = sum_{t,o} g'[z - tz + p, h - ty, w - tx, o] * k[t, i, o]
//
// over NDHWC float32 tensors, p = z_pad (0 'v', 1 's'), out-of-range g'
// zero; float32 sums, dx float32.
//
// Arithmetic (3xTF32, as the float32 K1, conv3x3_fwd_f32_tc.cu): every
// operand v is split into big = tf32(v) and small = tf32(v - big)
// (cvt.rna.tf32.f32), and a * b is taken as small_a * big_b + big_a *
// small_b + big_a * big_b, in that order, on
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32.  The tensor cores' float32
// sums truncate toward zero, a bias that grows with the chain of mma into
// one accumulator (long chains moved the float32 K1's training-step
// gradients past the port's limit), so each k8 step's three products go
// into fresh registers and are added to the work item's sum in IEEE
// float32.
//
// Design: the bfloat16 K3's (conv3x3_bwd_dx_tc.cu) transposed implicit GEMM
// with M = input voxels, N = C_in, K = 27 taps x C_out, staged as the
// float32 K1 stages its operands.
//   * A persistent block of 8 warps walks work items: a tile of 8 rows x 16
//     columns of one input plane of one sample ('s' included: every input
//     plane is stored), times one N slice of at most 48 input channels
//     (wider C_in is cut into equal slices padded to 16; each slice is a
//     whole dx for its channels, so every dx element has exactly one
//     writer: no split-K, no atomics, bit-identical on repeat).  Warp w
//     owns input row w of the tile: 16 voxels, one M fragment, N / 8
//     accumulator fragments.  Slices of at most 32 channels, which restage
//     and re-split the g' region once more per slice at C_in = 96 and cut
//     C_in = 48 into two padded slices, were slower on the card.
//   * K is walked in steps: each C_out chunk of 8 channels in its three kz
//     planes.  Step kz reads the g' plane z - kz + p (the taps stay
//     flipped).  A step's operands land by cp.async in one of two ring
//     slots: g and y of that plane over the halo region (10 x 18 voxels x
//     8 channels, zero outside the output and past C_out) and the weights
//     of the plane (9 taps x N rows k[t, i, .] of 8 output channels).  The
//     next step's copies are in flight while the current step is formed,
//     split and multiplied, also across chunk and work-item boundaries.
//   * g' is formed and split once per element, in shared memory: when a
//     step's slot has landed, one pass of 16-byte accesses writes
//     g' = g * act'(y) split into its big halves in place of g and its
//     small halves in place of y, splits the weights in place and writes
//     their small halves to one more buffer.  The fragments are then plain
//     loads: every g' element feeds 9 taps of its 8 warps and every weight
//     all 8 warps, so a split at fragment load would repeat each split up
//     to 72 times (it was slower for the float32 K1).
//   * A fragment of tap (sy, sx): 16 voxels' g' rows at that shift, by
//     ldmatrix.x4 (b16 pairs: a 16-byte row of 4 floats gives m16n8k8's
//     tf32 A fragment), once from the big and once from the small halves.
//     B: the weight rows k[t, i, .] have C_out, which is K, contiguous, so
//     a plain ldmatrix.x4 of 8 rows x 4 floats gives the tf32 .col
//     fragments of two n8 groups (lane l: row l / 4, k l % 4).  The voxel
//     and weight-row strides are 12 floats (48 bytes, an odd multiple of
//     16), so the 8 rows of every ldmatrix hit distinct banks.
//   * Epilogue: stored NDHWC as float pairs where C_in is even, masked at
//     the ragged H / W edges and the padded channels.
//   * Shared memory: two slots and the weights' small halves, 55,296 /
//     76,032 / 96,768 bytes a block for slices of 16 / 32 / 48 channels;
//     two blocks per SM, and __launch_bounds__ caps the registers at 128 a
//     thread (three blocks at 80 registers spilled more and were slower on
//     the card).
//
// Bound on the H100: 2 * 27 * C_in * C_out FLOPs per output voxel against
// 4 * (2 * C_out + C_in) bytes of g, y read and dx written.  3xTF32 runs
// three TF32 products per product, so the operations bound is the FLOPs at
// a third of the 495 TFLOP/s TF32 rate (165); at the U-Net's widths that
// bounds it.  Per mma the warps also run about one fragment load and an
// IEEE add, per step the forming / split pass and the copies, and every
// step waits at two block-wide barriers.

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

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTH = kWarps;            // tile rows: one per warp
constexpr int kTW = 16;                // tile columns: one mma M fragment
constexpr int kRH = kTH + 2;           // halo region rows
constexpr int kRW = kTW + 2;           // halo region columns
constexpr int kPlane = kRH * kRW;      // voxels of one halo plane
constexpr int kMaxSlice = 48;          // widest N slice (input channels)
constexpr int kKC = 8;                 // output channels of a K chunk
constexpr int kStride = kKC + 4;       // staged voxel / weight-row stride
constexpr int kPlaneF = kPlane * kStride;  // floats of one staged g plane

// flags: which operands allow vector accesses
constexpr int kVecK = 1;    // 16-byte copies of k (C_out % 4 == 0, aligned)
constexpr int kVecG = 2;    // 16-byte copies of g and y (C_out % 4 == 0)
constexpr int kVecDx = 4;   // 8-byte stores of dx pairs (C_in even)

// The floats of one ring slot: g (big halves of g' after the split), y
// (small halves of g' after the split), and the weights of one kz plane
// (9 taps x 16 * NI rows).
template <int NI>
struct Slot {
  static constexpr int kW = 9 * 16 * NI * kStride;
  static constexpr int kFloats = 2 * kPlaneF + kW;
};

// two ring slots and the small halves of one slot's weights
template <int NI>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * (size_t)Slot<NI>::kFloats + Slot<NI>::kW);
}

// NI: 16-channel groups of the N slice (C_in) per work item.
template <int NI>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_bwd_dx_f32_tc_kernel(const float* __restrict__ k,
                             const float* __restrict__ y,
                             const float* __restrict__ g,
                             float* __restrict__ dx, Geo geo, int n_slices,
                             int act, float alpha, int flags) {
  using S = Slot<NI>;
  constexpr int NS = 16 * NI;          // input channels of a slice
  constexpr int C4 = kKC / 4;          // 16-byte groups of a chunk

  // slot s at ring + s * S::kFloats: [g | y | weights]; w_small: the small
  // halves of the weights of the slot being multiplied
  extern __shared__ uint4 smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* w_small = ring + 2 * S::kFloats;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c_in = geo.c_in, c_out = geo.c_out, p = geo.z_pad;
  const int n_chunks = (c_out + kKC - 1) / kKC;
  const long long n_work = geo.n_tiles * n_slices;

  // A work item: N slice ci0, sample b, input plane z, tile origin h0, w0.
  struct Item {
    int ci0, b, z, h0, w0;
  };
  auto item = [&](long long work) {
    Item it;
    it.ci0 = (int)(work % n_slices) * NS;
    long long r = work / n_slices;
    it.w0 = (int)(r % geo.n_tw) * kTW;
    r /= geo.n_tw;
    it.h0 = (int)(r % geo.n_th) * kTH;
    r /= geo.n_th;
    it.z = (int)(r % geo.tile_d);
    it.b = (int)(r / geo.tile_d);
    return it;
  };

  // Starts the copies of step (chunk, kz) of a work item into a slot.
  auto load_step = [&](long long work, int chunk, int kz, int slot) {
    const Item it = item(work);
    const int co0 = chunk * kKC;
    float* gd = ring + slot * S::kFloats;
    float* yd = gd + kPlaneF;
    float* wd = yd + kPlaneF;
    // wd[t9][i][o] = k[kz, t9, ci0 + i, co0 + o], zero-padded
    if (flags & kVecK) {
      for (int e = tid; e < 9 * NS * C4; e += kThreads) {
        const int c = (e % C4) * 4, i = (e / C4) % NS, t9 = e / (C4 * NS);
        const int ci = it.ci0 + i, co = co0 + c;
        const bool ok = ci < c_in && co < c_out;
        const float* src =
            ok ? k + ((long long)(kz * 9 + t9) * c_in + ci) * c_out + co : k;
        cp_async16(wd + (t9 * NS + i) * kStride + c, src, ok);
      }
    } else {
      for (int e = tid; e < 9 * NS * kKC; e += kThreads) {
        const int c = e % kKC, i = (e / kKC) % NS, t9 = e / (kKC * NS);
        const int ci = it.ci0 + i, co = co0 + c;
        const bool ok = ci < c_in && co < c_out;
        const float* src =
            ok ? k + ((long long)(kz * 9 + t9) * c_in + ci) * c_out + co : k;
        cp_async4(wd + (t9 * NS + i) * kStride + c, src, ok);
      }
    }
    // g and y of plane oz = z - kz + p, rows h0 - 2 + rh, columns
    // w0 - 2 + rw, channels co0 .. co0 + 7; zero outside the output and
    // past C_out
    const int oz = it.z - kz + p;
    const bool vec = flags & kVecG;
    const int per = vec ? C4 : kKC;    // copies per voxel
    for (int e = tid; e < kPlane * per; e += kThreads) {
      const int vox = e / per, c = (e % per) * (vec ? 4 : 1);
      const int oh = it.h0 - 2 + vox / kRW, ow = it.w0 - 2 + vox % kRW;
      const bool ok = co0 + c < c_out && oz >= 0 && oz < geo.d_out &&
                      oh >= 0 && oh < geo.h_out && ow >= 0 && ow < geo.w_out;
      const long long at =
          ok ? ((((long long)it.b * geo.d_out + oz) * geo.h_out + oh) *
                    geo.w_out + ow) * c_out + co0 + c
             : 0;
      if (vec) {
        cp_async16(gd + vox * kStride + c, g + at, ok);
        cp_async16(yd + vox * kStride + c, y + at, ok);
      } else {
        cp_async4(gd + vox * kStride + c, g + at, ok);
        cp_async4(yd + vox * kStride + c, y + at, ok);
      }
    }
  };

  // per-lane fragment rows (see the fragment layouts of m16n8k8.tf32), all
  // by ldmatrix.x4 on 16-byte rows of 4 floats:
  // A: row lane % 16, k half lane / 16;
  // B: n row (lane / 16) * 8 + lane % 8, k half (lane / 8) % 2.
  const int a_row = lane % 16, a_k = (lane / 16) * 4;
  const int b_n = (lane / 16) * 8 + lane % 8, b_k = ((lane / 8) % 2) * 4;

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
      for (int kz = 0; kz < 3; ++kz) {
        // this step's copies have landed, and every warp is done with the
        // other slot (the previous step) and with the weights' small halves
        cp_async_wait_all();
        __syncthreads();

        if (kz < 2) {
          load_step(work, chunk, kz + 1, slot ^ 1);
        } else if (chunk + 1 < n_chunks) {
          load_step(work, chunk + 1, 0, slot ^ 1);
        } else if (work + gridDim.x < n_work) {
          load_step(work + gridDim.x, 0, 0, slot ^ 1);
        }
        cp_async_commit();

        // form g' and split it (big halves in place of g, small in place
        // of y); split the weights (big in place, small beside)
        float* g_big = ring + slot * S::kFloats;
        float* g_small = g_big + kPlaneF;
        float* w_big = g_small + kPlaneF;
        for (int e = tid; e < kPlane * C4; e += kThreads) {
          const int at = (e / C4) * kStride + (e % C4) * 4;
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
        for (int e = tid; e < 9 * NS * C4; e += kThreads) {
          const int at = (e / C4) * kStride + (e % C4) * 4;
          float4 v = *reinterpret_cast<const float4*>(w_big + at), s;
          split4(v, s);
          *reinterpret_cast<float4*>(w_big + at) = v;
          *reinterpret_cast<float4*>(w_small + at) = s;
        }
        __syncthreads();

        // the 9 taps (kz, sy, sx) of this step's plane: g'[z - kz + p,
        // h - sy, w - sx].  Each k8 step's three products go into fresh
        // registers (a 3-mma chain), added to the item's sum in IEEE
        // float32.
#pragma unroll
        for (int t9 = 0; t9 < 9; ++t9) {
          const int sy = t9 / 3, sx = t9 % 3;
          const int a_at =
              ((warp + 2 - sy) * kRW + a_row + 2 - sx) * kStride + a_k;
          const int b_at = (t9 * NS + b_n) * kStride + b_k;
          unsigned a_big[4], a_small[4];
          ldsm_x4(a_big, g_big + a_at);
          ldsm_x4(a_small, g_small + a_at);
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            unsigned bb[4], bs[4];
            ldsm_x4(bb, w_big + b_at + ni * 16 * kStride);
            ldsm_x4(bs, w_small + b_at + ni * 16 * kStride);
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
        slot ^= 1;
      }
    }

    // dx of input row h0 + warp, columns w0 .. w0 + 15, channels of the
    // slice
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
          const int ci = it.ci0 + n * 8 + (lane % 4) * 2;
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
}

// Launches one instantiation over n_work items with as many persistent
// blocks as the card holds at once (found once per process).
template <int NI>
cudaError_t launch(const float* k, const float* y, const float* g, float* dx,
                   const Geo& geo, int n_slices, int act, float alpha,
                   int flags, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NI>();
  static int resident = 0;
  if (!resident) {
    // also sets the kernel's dynamic shared-memory limit, which persists
    const cudaError_t err = stroke::persistent_blocks(
        conv3x3_bwd_dx_f32_tc_kernel<NI>, kThreads, smem, 1LL << 62,
        &resident);
    if (err != cudaSuccess) return err;
    if (resident < 1) return cudaErrorInvalidConfiguration;
  }
  const long long n_work = geo.n_tiles * n_slices;
  const int n_blocks = (int)(n_work < resident ? n_work : resident);
  if (n_blocks < 1) return cudaSuccess;
  conv3x3_bwd_dx_f32_tc_kernel<NI><<<n_blocks, kThreads, smem, stream>>>(
      k, y, g, dx, geo, n_slices, act, alpha, flags);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  The caller has checked
// shapes, dtypes, devices and contiguity and allocated dx.  Every
// C_in, C_out >= 1 is taken: C_in is cut into n_slices equal N slices of at
// most 48 channels padded to 16 (NI 16-channel groups), and C_out walked in
// chunks of 8.
extern "C" int conv3x3_bwd_dx_f32(const float* k, const float* y,
                                  const float* g, float* dx, int batch,
                                  int d_in, int h, int w, int c_in, int c_out,
                                  int z_pad, int act, float alpha,
                                  void* stream) {
  if (c_in < 1 || c_out < 1) return cudaErrorInvalidValue;
  const Geo geo = stroke::make_geo(batch, d_in, h, w, c_in, c_out, z_pad,
                                   true, kTH, kTW);
  const int cip = (c_in + 15) / 16 * 16;
  const int n_slices = (cip + kMaxSlice - 1) / kMaxSlice;
  const int ni = ((c_in + n_slices - 1) / n_slices + 15) / 16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int flags = (c_out % 4 == 0 && aligned(k, 16) ? kVecK : 0) |
                    (c_out % 4 == 0 && aligned(g, 16) && aligned(y, 16)
                         ? kVecG : 0) |
                    (c_in % 2 == 0 && aligned(dx, 8) ? kVecDx : 0);
  switch (ni) {
    case 1:
      return launch<1>(k, y, g, dx, geo, n_slices, act, alpha, flags, s);
    case 2:
      return launch<2>(k, y, g, dx, geo, n_slices, act, alpha, flags, s);
    case 3:
      return launch<3>(k, y, g, dx, geo, n_slices, act, alpha, flags, s);
  }
  return cudaErrorInvalidValue;
}
