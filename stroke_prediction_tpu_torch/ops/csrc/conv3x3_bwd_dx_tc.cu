// bfloat16 input gradient of the 3x3x3 stride-1 convolution
// y = act(conv3d(x, k) + b) on Hopper's tensor cores (kernel K3 of the port,
// bfloat16 storage; the float32 K3 is conv3x3_bwd_dx_f32_tc.cu's, in
// 3xTF32).
//
// Replaces stroke_prediction_tpu/ops/pallas/s2d.py _dx_kernel (dx alone, the
// split form of the backward that layers too wide for the fused K2 take):
//
//   g'           = bf16(g * act'(y))   as s2d.py:879-889 forms it (alpha and
//                                      ELU's y + alpha rounded to bf16 too)
//   dx[z,h,w,i]  = sum_{t,o} g'[z - tz + p, h - ty, w - tx, o] * k[t, i, o]
//
// over NDHWC tensors, p = z_pad (0 'v', 1 's'), out-of-range g' zero;
// bfloat16 operands, float32 sums, dx rounded once to bfloat16.
//
// Design: an implicit GEMM on mma.sync.m16n8k16 (bf16 in, f32 sums) with
// M = input voxels, N = C_in, K = 27 taps x C_out.
//   * A persistent block of 8 warps walks work items: a tile of 8 rows x 16
//     columns of one input plane of one sample, times one N slice of at most
//     96 input channels (wider C_in is cut into equal slices padded to 16;
//     each slice is a whole dx for its channels, so every dx element has
//     exactly one writer: no split-K, no atomics, bit-identical on repeat).
//     Warp w owns row w of the tile: 16 voxels, one M fragment, N / 8
//     accumulator fragments in registers for the whole item.
//   * K is walked in C_out chunks of KC (16 or 32) channels, and each chunk
//     in its three kz planes.  Per chunk the block stages the g' halo
//     region (3 planes x 10 x 18 voxels x KC channels) as bfloat16, formed
//     from g and y on the way in (no pass writes g' to device memory).  The
//     weights of one kz plane of the chunk (9 taps x N x KC) are streamed
//     through a ring of two shared-memory slots by cp.async, the next
//     plane's copy in flight while the current one multiplies, also across
//     chunk and work-item boundaries; all 27 taps at the widths of L6 / L7
//     would not fit beside the g' region.  Shared voxel and weight-row
//     strides are KC + 8 elements (an odd multiple of 16 bytes), so the 8
//     rows of every ldmatrix hit distinct banks.
//   * A fragment of tap t: 16 voxels' g' rows at that tap's shift, by
//     ldmatrix.x4 from per-lane row addresses; B: the weight slot, rows
//     k[t, i, .] with C_out contiguous (K-contiguous, as mma's .col wants).
//   * Epilogue: each accumulator rounded once to bfloat16, stored NDHWC as
//     bf16 pairs where C_in is even, masked at the ragged H / W edges and
//     the padded channels; every input plane is stored ('s' included).
//   * Shared memory at most 112,320 bytes a block (two blocks per SM), and
//     __launch_bounds__(256, 2) caps the registers at 128 a thread.
//
// Bound on the H100: 2 * 27 * C_in * C_out FLOPs per output voxel for
// 2 bytes each of g, y read and dx written: at the U-Net's widths far above
// the 295 FLOP/byte ridge, so the tensor-core rate bounds it.  This version
// spends its time in mma.sync's instruction rate, the ldmatrix traffic, the
// block-wide waits at each staging, and the ragged last column tile (16
// columns per M fragment).

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
using stroke::mma_bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTH = kWarps;            // tile rows: one per warp
constexpr int kTW = 16;                // tile columns: one mma M fragment
constexpr int kRH = kTH + 2;           // halo region rows
constexpr int kRW = kTW + 2;           // halo region columns
constexpr int kPlane = kRH * kRW;
constexpr int kRegion = 3 * kPlane;    // voxels of a 3-plane halo region
constexpr int kMaxSlice = 96;          // widest N slice (input channels)

// flags: which operands allow vector accesses
constexpr int kVecK = 1;    // 16-byte copies of k (C_out % 8 == 0, aligned)
constexpr int kVecG = 2;    // 16-byte loads of g and y (C_out % 8 == 0)
constexpr int kVecDx = 4;   // 4-byte stores of dx pairs (C_in even)

// NI: 16-channel slices of N (C_in) per work item; NO: of a C_out chunk.
template <int NI, int NO>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * ((size_t)2 * 9 * 16 * NI * (16 * NO + 8)  // weights
                         + (size_t)kRegion * (16 * NO + 8));       // g'
}

template <int NI, int NO>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_bwd_dx_tc_kernel(const bf16* __restrict__ k,
                         const bf16* __restrict__ y,
                         const bf16* __restrict__ g, bf16* __restrict__ dx,
                         Geo geo, int n_slices, int act, float alpha,
                         int flags) {
  constexpr int NS = 16 * NI;          // input channels of a slice
  constexpr int KC = 16 * NO;          // output channels of a chunk
  constexpr int GS = KC + 8;           // staged g' voxel stride (elements)
  constexpr int WS = KC + 8;           // weight row (one input channel)
  constexpr int kSlot = 9 * NS * WS;   // one kz plane of a chunk's weights

  extern __shared__ uint4 smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* gs = ws + 2 * kSlot;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c_in = geo.c_in, c_out = geo.c_out, p = geo.z_pad;
  const int n_chunks = (c_out + KC - 1) / KC;
  const long long n_work = geo.n_tiles * n_slices;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // ws[slot][t9][i][o] = k[kz, t9, ci0 + i, co0 + o], zero-padded
  auto load_plane = [&](long long work, int chunk, int kz, int slot) {
    const int ci0 = (int)(work % n_slices) * NS, co0 = chunk * KC;
    bf16* dst = ws + slot * kSlot;
    if (flags & kVecK) {
      constexpr int C8 = KC / 8, N = 9 * NS * C8;
      for (int e = tid; e < N; e += kThreads) {
        const int c = (e % C8) * 8, i = (e / C8) % NS, t9 = e / (C8 * NS);
        const int ci = ci0 + i, co = co0 + c;
        const bool ok = ci < c_in && co < c_out;
        const bf16* src =
            ok ? k + ((long long)(kz * 9 + t9) * c_in + ci) * c_out + co : k;
        cp_async16(dst + (t9 * NS + i) * WS + c, src, ok);
      }
    } else {
      for (int e = tid; e < 9 * NS * KC; e += kThreads) {
        const int c = e % KC, i = (e / KC) % NS, t9 = e / (KC * NS);
        const int ci = ci0 + i, co = co0 + c;
        dst[(t9 * NS + i) * WS + c] =
            (ci < c_in && co < c_out)
                ? k[((long long)(kz * 9 + t9) * c_in + ci) * c_out + co]
                : zero;
      }
    }
  };

  // per-lane ldmatrix rows (see the fragment layouts of m16n8k16):
  // A: row lane % 16, k half lane / 16;
  // B: n row (lane / 16) * 8 + lane % 8, k half (lane / 8) % 2.
  const int a_row = lane % 16, a_k = (lane / 16) * 8;
  const int b_n = (lane / 16) * 8 + lane % 8, b_k = ((lane / 8) % 2) * 8;

  long long work = blockIdx.x;
  if (work >= n_work) return;
  load_plane(work, 0, 0, 0);
  int slot = 0;

  for (; work < n_work; work += gridDim.x) {
    const int ci0 = (int)(work % n_slices) * NS;
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
      const int co0 = chunk * KC;
#pragma unroll 1
      for (int kz = 0; kz < 3; ++kz) {
        // this plane's weights have landed, and every warp is done with
        // the other slot (the previous plane) and, at kz 0, with the g'
        // region of the previous chunk
        cp_async_wait_all();
        __syncthreads();
        if (kz < 2) {
          load_plane(work, chunk, kz + 1, slot ^ 1);
        } else if (chunk + 1 < n_chunks) {
          load_plane(work, chunk + 1, 0, slot ^ 1);
        } else if (work + gridDim.x < n_work) {
          load_plane(work + gridDim.x, 0, 0, slot ^ 1);
        }

        if (kz == 0) {
          // g' region of this chunk: planes oz = z - 2 + p + rz, rows
          // h0 - 2 + rh, columns w0 - 2 + rw; zero outside the output
          if (flags & kVecG) {
            constexpr int C8 = KC / 8, N = kRegion * C8;
#pragma unroll 3
            for (int it = 0; it < (N + kThreads - 1) / kThreads; ++it) {
              const int e = tid + it * kThreads;
              if (e < N) {
                const int vox = e / C8, c = (e % C8) * 8;
                const int rw = vox % kRW, rh = (vox / kRW) % kRH;
                const int rz = vox / kPlane;
                const int oz = z - 2 + p + rz, oh = h0 - 2 + rh;
                const int ow = w0 - 2 + rw;
                uint4 v = make_uint4(0u, 0u, 0u, 0u);
                if (co0 + c < c_out && oz >= 0 && oz < geo.d_out &&
                    oh >= 0 && oh < geo.h_out && ow >= 0 && ow < geo.w_out) {
                  const long long idx =
                      ((((long long)b * geo.d_out + oz) * geo.h_out + oh) *
                           geo.w_out + ow) * c_out + co0 + c;
                  const uint4 gv =
                      __ldg(reinterpret_cast<const uint4*>(g + idx));
                  const uint4 yv =
                      __ldg(reinterpret_cast<const uint4*>(y + idx));
                  v.x = cotangent2(gv.x, yv.x, act, alpha);
                  v.y = cotangent2(gv.y, yv.y, act, alpha);
                  v.z = cotangent2(gv.z, yv.z, act, alpha);
                  v.w = cotangent2(gv.w, yv.w, act, alpha);
                }
                *reinterpret_cast<uint4*>(gs + vox * GS + c) = v;
              }
            }
          } else {
            for (int e = tid; e < kRegion * KC; e += kThreads) {
              const int vox = e / KC, c = e % KC;
              const int rw = vox % kRW, rh = (vox / kRW) % kRH;
              const int rz = vox / kPlane;
              const int oz = z - 2 + p + rz, oh = h0 - 2 + rh;
              const int ow = w0 - 2 + rw;
              float v = 0.f;
              if (co0 + c < c_out && oz >= 0 && oz < geo.d_out && oh >= 0 &&
                  oh < geo.h_out && ow >= 0 && ow < geo.w_out) {
                const long long idx =
                    ((((long long)b * geo.d_out + oz) * geo.h_out + oh) *
                         geo.w_out + ow) * c_out + co0 + c;
                v = cotangent<bf16>(__bfloat162float(g[idx]),
                                    __bfloat162float(y[idx]), act, alpha);
              }
              gs[vox * GS + c] = __float2bfloat16_rn(v);
            }
          }
          __syncthreads();
        }

        // the 9 taps (kz, sy, sx) of this plane: g'[z - kz + p, h - sy,
        // w - sx] is region plane 2 - kz
        const bf16* wsl = ws + slot * kSlot;
#pragma unroll
        for (int t9 = 0; t9 < 9; ++t9) {
          const int sy = t9 / 3, sx = t9 % 3;
          const bf16* ap = gs + (((2 - kz) * kRH + warp + 2 - sy) * kRW +
                                 a_row + 2 - sx) * GS + a_k;
          const bf16* bp = wsl + (t9 * NS + b_n) * WS + b_k;
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
        slot ^= 1;
      }
    }

    // dx of input row h0 + warp, columns w0 .. w0 + 15, channels of the
    // slice
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
          const int ci = ci0 + n * 8 + (lane % 4) * 2;
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
}

// Launches one instantiation over n_work items with as many persistent
// blocks as the card holds at once (found once per process).
template <int NI, int NO>
cudaError_t launch(const bf16* k, const bf16* y, const bf16* g, bf16* dx,
                   const Geo& geo, int n_slices, int act, float alpha,
                   int flags, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NI, NO>();
  static int resident = 0;
  if (!resident) {
    // also sets the kernel's dynamic shared-memory limit, which persists
    const cudaError_t err = stroke::persistent_blocks(
        conv3x3_bwd_dx_tc_kernel<NI, NO>, kThreads, smem, 1LL << 62,
        &resident);
    if (err != cudaSuccess) return err;
    if (resident < 1) return cudaErrorInvalidConfiguration;
  }
  const long long n_work = geo.n_tiles * n_slices;
  const int n_blocks = (int)(n_work < resident ? n_work : resident);
  if (n_blocks < 1) return cudaSuccess;
  conv3x3_bwd_dx_tc_kernel<NI, NO><<<n_blocks, kThreads, smem, stream>>>(
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
// most 96 channels padded to 16 (NI 16-channel groups), and C_out walked in
// chunks of 32 where C_out' is a multiple of 32 and a slice at most 48
// channels wide (the g' region and two weight planes then still fit two
// blocks per SM), else of 16.
extern "C" int conv3x3_bwd_dx_bf16(const bf16* k, const bf16* y,
                                   const bf16* g, bf16* dx, int batch,
                                   int d_in, int h, int w, int c_in,
                                   int c_out, int z_pad, int act,
                                   float alpha, void* stream) {
  if (c_in < 1 || c_out < 1) return cudaErrorInvalidValue;
  const Geo geo = stroke::make_geo(batch, d_in, h, w, c_in, c_out, z_pad,
                                   true, kTH, kTW);
  const int cip = (c_in + 15) / 16 * 16, cop = (c_out + 15) / 16 * 16;
  const int n_slices = (cip + kMaxSlice - 1) / kMaxSlice;
  const int ni = ((c_in + n_slices - 1) / n_slices + 15) / 16;
  const bool wide_k = cop % 32 == 0 && ni <= 3;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int flags = (c_out % 8 == 0 && aligned(k, 16) ? kVecK : 0) |
                    (c_out % 8 == 0 && aligned(g, 16) && aligned(y, 16)
                         ? kVecG : 0) |
                    (c_in % 2 == 0 && aligned(dx, 4) ? kVecDx : 0);
#define STROKE_DX_LAUNCH(NI_, NO_) \
  launch<NI_, NO_>(k, y, g, dx, geo, n_slices, act, alpha, flags, s)
  if (wide_k) {
    switch (ni) {
      case 1: return STROKE_DX_LAUNCH(1, 2);
      case 2: return STROKE_DX_LAUNCH(2, 2);
      case 3: return STROKE_DX_LAUNCH(3, 2);
    }
  }
  switch (ni) {
    case 1: return STROKE_DX_LAUNCH(1, 1);
    case 2: return STROKE_DX_LAUNCH(2, 1);
    case 3: return STROKE_DX_LAUNCH(3, 1);
    case 4: return STROKE_DX_LAUNCH(4, 1);
    case 5: return STROKE_DX_LAUNCH(5, 1);
    case 6: return STROKE_DX_LAUNCH(6, 1);
  }
#undef STROKE_DX_LAUNCH
  return cudaErrorInvalidValue;
}
