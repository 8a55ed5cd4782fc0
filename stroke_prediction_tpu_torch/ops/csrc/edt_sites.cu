// The exact separable Euclidean distance transform of a site mask over its
// last three axes (D, H, W), in two kernels:
//
//   A  edt_scan_d_pass_h_kernel: f2 = squared distance along D to the
//      nearest site of the voxel's (n, ., h, w) column (_BIG = 1e12 for a
//      column without one), then the parabola pass along H,
//      g(h) = min_j f2(j) + (h - j)^2, kept in shared memory in between;
//   B  edt_pass_w_kernel: the parabola pass along W,
//      e(w) = min_j g(j) + (w - j)^2, then sqrt.
//
// Replaces the TPU kernel stroke_prediction_tpu/ops/edt.py _parabola_kernel
// (launched by _parabola_pass_pallas) and the XLA scan and sqrt around it
// (_edt_from_sites).  Kernel B without the sqrt is the single pass along a
// contiguous last axis (edt_parabola_f32).
//
//   sites  (N, D, H, W) bool (one byte a voxel), contiguous
//   tmp    (N, D, H, W) float32, contiguous: g
//   out    (N, D, H, W) float32, contiguous: the distances
//
// Exactness: f2 is k^2 for the integer distance k to the nearest site, or
// 1e12f, which is what the plain clamp(d^2, _BIG) of the two-sided cummax
// scan gives bit for bit.  Each candidate is one float32 add of an exact
// integer (i - j)^2 (an FMA gives the same rounding, since d * d is exact),
// the min over j is exact in any order, and sqrtf is correctly rounded
// (nvcc's default -prec-sqrt=true), so the result equals the plain version
// bit for bit.  The min-plus is the brute-force O(n^2) one: Felzenszwalb's
// O(n) envelope divides to intersect parabolas, and near _BIG the float32
// rounding of that division can pick the wrong parabola.
//
// Bound on the H100: the function needs its bytes, 5 a voxel (the mask in,
// the distance out) at 3.35 TB/s.  Its operations are fewer than that: an
// exact O(n) lower envelope (every f is an integer square or 1e12, so
// intersections compare exactly by integer cross-multiplication) takes
// about 41 a voxel over the scan, both passes and the sqrt.  The (H + W)
// candidates a voxel of the brute-force min-plus are this kernel's choice,
// not the function's need.  Launches and copies were the parent's cost:
// the design removes them (the mask read in place, no cummax, no movedim,
// no .contiguous(); g through device memory once; the sqrt fused into the
// last store; two launches a call).  What remains: the passes issue three
// instructions a candidate (the offset, an FMA, a min), and kernel A's scan
// along D, which every block of a strip repeats for its own d, reads D
// times the mask from L2 (8 bytes a lane where W allows).  The scan reads
// every z: an outward scan could stop a block early only where every
// column of its strip holds a site, and a block that owned several d would
// leave SMs idle at these grids (112 blocks at both shapes below).
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, device time), per
// call of the validation step's (2, 28, 64, 64) and the tester's (1, 28,
// 128, 128): kernel A 6.5 / 14.6 us (its scan 2.5 / 5.2), kernel B 4.1 /
// 10.3 us, against 53.0 / 72.8 us for the parent's composition.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kBig = 1e12f;          // _BIG of ops/edt.py, as float32
constexpr int kUnrollJ = 4;            // j a step of the min-plus loops

// kernel A: a block owns one (n, d) and a strip of 32 consecutive w
constexpr int kStrip = 32;             // w columns a block: one warp's lanes
constexpr int kThreadsA = 512;
constexpr int kWarpsA = kThreadsA / 32;
constexpr int kScanA = 16;             // mask loads in flight a lane
constexpr int kRowsA = 4;              // h outputs a lane

// kernel B: a block takes kWarpsB rows, one row a warp
constexpr int kThreadsB = 256;
constexpr int kWarpsB = kThreadsB / 32;
constexpr int kOutB = 2;               // outputs a lane, 32 apart

__device__ __forceinline__ float inf_f32() {
  return __int_as_float(0x7f800000);
}

// n rounded up to whole j steps; the padding holds +inf, which never wins
// a min (every line has finite values), so the loops need no remainder
__host__ __device__ __forceinline__ int padded(int n) {
  return (n + kUnrollJ - 1) / kUnrollJ * kUnrollJ;
}

// The mask bytes a lane loads at once: kVec consecutive w of one (z, h)
template <int kVec> struct MaskWord;
template <> struct MaskWord<1> { typedef unsigned char T; };
template <> struct MaskWord<8> { typedef unsigned long long T; };

// kVec = 8 needs W a multiple of 8 and an 8-byte aligned mask
template <int kVec>
__global__ void __launch_bounds__(kThreadsA)
edt_scan_d_pass_h_kernel(const unsigned char* __restrict__ sites,
                         float* __restrict__ g, int D, int H, int W) {
  typedef typename MaskWord<kVec>::T Word;
  constexpr int kPerRow = kStrip / kVec;   // lanes a strip row
  extern __shared__ float f2_s[];      // [padded(H)][kStrip]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int d = blockIdx.y;
  const long long n = blockIdx.z;
  const long long plane = (long long)H * W;
  const int hp = padded(H);

  // f2 along D: lane (r, q) scans the columns w0 .. w0 + kVec - 1 of row
  // h0 + r over all z, kScanA predicated loads at a time; a warp's load
  // covers kVec rows of the strip (32 bytes each).  The columns are read
  // again by the blocks of the other d, from L2.
  const int q = lane % kPerRow;
  const int r = lane / kPerRow;
  const int w0 = blockIdx.x * kStrip + q * kVec;
  const unsigned char* col = sites + n * D * plane + (w0 < W ? w0 : 0);
  for (int h = warp * kVec + r; h < hp; h += kWarpsA * kVec) {
    int best[kVec];                    // above any |z - d|: no site yet
#pragma unroll
    for (int b = 0; b < kVec; ++b) best[b] = D;
    if (w0 < W && h < H) {
      const unsigned char* c = col + (long long)h * W;
      for (int z0 = 0; z0 < D; z0 += kScanA) {
        Word v[kScanA];
#pragma unroll
        for (int k = 0; k < kScanA; ++k) {
          v[k] = z0 + k < D
                     ? *reinterpret_cast<const Word*>(c + (z0 + k) * plane)
                     : Word(0);
        }
#pragma unroll
        for (int k = 0; k < kScanA; ++k) {
          if (v[k]) {
            const int dz = abs(z0 + k - d);
#pragma unroll
            for (int b = 0; b < kVec; ++b) {
              if ((v[k] >> (8 * b)) & 0xff) best[b] = min(best[b], dz);
            }
          }
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kVec; ++b) {
      const float k = (float)best[b];
      f2_s[h * kStrip + q * kVec + b] =
          h >= H ? inf_f32() : (best[b] < D ? k * k : kBig);
    }
  }
  __syncthreads();

  // the H pass: a warp's lanes read f2[j][w] of one row (conflict-free),
  // each read feeding kRowsA outputs.  h - j is an exact float offset from
  // a running h0 - j0 (no int-to-float conversion per candidate)
  const int w = blockIdx.x * kStrip + lane;
  if (w >= W) return;
  float* gp = g + (n * D + d) * plane + w;
  const int groups = (H + kRowsA - 1) / kRowsA;
  for (int grp = warp; grp < groups; grp += kWarpsA) {
    const int h0 = grp * kRowsA;
    float best[kRowsA];
#pragma unroll
    for (int r = 0; r < kRowsA; ++r) best[r] = inf_f32();
    float dj = (float)h0;              // h0 - j0
    for (int j0 = 0; j0 < hp; j0 += kUnrollJ, dj -= (float)kUnrollJ) {
#pragma unroll
      for (int jj = 0; jj < kUnrollJ; ++jj) {
        const float f = f2_s[(j0 + jj) * kStrip + lane];
#pragma unroll
        for (int r = 0; r < kRowsA; ++r) {
          const float dd = dj + (float)(r - jj);
          best[r] = fminf(best[r], f + dd * dd);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsA; ++r) {
      if (h0 + r < H) gp[(long long)(h0 + r) * W] = best[r];
    }
  }
}

// rows (n_rows, n) contiguous; a warp stages and owns one row, lane i makes
// outputs i, i + 32, ... (reads of f[j] are broadcasts)
template <bool kSqrt>
__global__ void __launch_bounds__(kThreadsB)
edt_pass_w_kernel(const float* __restrict__ f, float* __restrict__ out,
                  long long n_rows, int n) {
  extern __shared__ float f_s[];       // [kWarpsB][padded(n)]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kWarpsB + warp;
  if (row >= n_rows) return;
  const int np = padded(n);
  float* fl = f_s + warp * np;
  const float* src = f + row * n;
  for (int i = lane; i < np; i += 32) fl[i] = i < n ? src[i] : inf_f32();
  __syncwarp();

  float* dst = out + row * n;
  for (int i0 = lane; i0 < n; i0 += 32 * kOutB) {
    float best[kOutB];
#pragma unroll
    for (int t = 0; t < kOutB; ++t) best[t] = inf_f32();
    float dj = (float)i0;              // i0 - j0
    for (int j0 = 0; j0 < np; j0 += kUnrollJ, dj -= (float)kUnrollJ) {
      const float4 f4 = *reinterpret_cast<const float4*>(fl + j0);
      const float fj[kUnrollJ] = {f4.x, f4.y, f4.z, f4.w};
#pragma unroll
      for (int jj = 0; jj < kUnrollJ; ++jj) {
#pragma unroll
        for (int t = 0; t < kOutB; ++t) {
          const float dd = dj + (float)(32 * t - jj);
          best[t] = fminf(best[t], fj[jj] + dd * dd);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kOutB; ++t) {
      const int i = i0 + 32 * t;
      if (i < n) dst[i] = kSqrt ? sqrtf(best[t]) : best[t];
    }
  }
}

template <int kVec>
cudaError_t launch_scan_d_pass_h(const unsigned char* sites, float* g,
                                 int N, int D, int H, int W,
                                 cudaStream_t stream) {
  const size_t smem = sizeof(float) * kStrip * (size_t)padded(H);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        edt_scan_d_pass_h_kernel<kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((W + kStrip - 1) / kStrip), (unsigned)D,
                  (unsigned)N);
  edt_scan_d_pass_h_kernel<kVec><<<grid, kThreadsA, smem, stream>>>(
      sites, g, D, H, W);
  return cudaGetLastError();
}

template <bool kSqrt>
cudaError_t launch_pass_w(const float* f, float* out, long long n_rows,
                          int n, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n_rows + kWarpsB - 1) / kWarpsB);
  const size_t smem = sizeof(float) * kWarpsB * (size_t)padded(n);
  edt_pass_w_kernel<kSqrt><<<blocks, kThreadsB, smem, stream>>>(f, out,
                                                                n_rows, n);
  return cudaGetLastError();
}

}  // namespace

// Both entries return the first cudaError_t of their launches (0 on
// success).  The caller has checked shapes (1 <= D, H, W, n <= 1024,
// 1 <= N <= 65535), dtypes, devices and contiguity, and allocated out and
// tmp.

// The whole EDT of sites (N, D, H, W): two launches on ``stream``.
extern "C" int edt_sites_f32(const void* sites, float* out, float* tmp,
                             int N, int D, int H, int W, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* m = static_cast<const unsigned char*>(sites);
  const bool wide = W % 8 == 0 && reinterpret_cast<uintptr_t>(m) % 8 == 0;
  const cudaError_t err =
      wide ? launch_scan_d_pass_h<8>(m, tmp, N, D, H, W, s)
           : launch_scan_d_pass_h<1>(m, tmp, N, D, H, W, s);
  if (err != cudaSuccess) return err;
  return launch_pass_w<true>(tmp, out, (long long)N * D * H, W, s);
}

// One parabola pass along the contiguous last axis of f (n_rows, n):
// kernel B without the sqrt.
extern "C" int edt_parabola_f32(const float* f, float* out, long long n_rows,
                                int n, void* stream) {
  return launch_pass_w<false>(f, out, n_rows, n,
                              static_cast<cudaStream_t>(stream));
}
