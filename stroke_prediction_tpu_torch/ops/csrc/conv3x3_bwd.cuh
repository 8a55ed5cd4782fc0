// What the conv sources share (conv3x3_fwd_f32_tc.cu,
// conv3x3_bwd_f32_tc.cu, conv3x3_bwd_dx_f32_tc.cu and
// conv3x3_bwd_dw_f32_tc.cu: float32 K1, K2, K3 and K4 on the tensor cores
// in 3xTF32; conv3x3_fwd_tc.cu, conv3x3_bwd_tc.cu, conv3x3_bwd_dx_tc.cu and
// conv3x3_bwd_dw_tc.cu: bfloat16 K1, K2, K3 and K4 on the tensor cores;
// conv3x3_bwd.cu: the plan of every fused or dW-only pass): the tile space
// over a volume, the persistent grid size, the channel domain of the fused
// K2, and the two reductions that sum the blocks' (or chunks') dW partials
// and the tiles' db partials in a fixed order (so dW and db are
// bit-identical from run to run, with no float atomics).

#pragma once

#include <cuda_runtime.h>

namespace stroke {

constexpr int kFinThreads = 256;

// A tile is th rows x tw columns of one depth plane of one sample, walked
// with the column tile fastest, then the row tile, the plane, the sample.
struct Geo {
  int batch, d_in, h, w, c_in, c_out, d_out, h_out, w_out, z_pad;
  int tile_d, n_th, n_tw;  // tile space: depth planes, row / column tiles
  long long n_tiles;
};

// input_space: tile the input (dx, or fused dx + dW) or the smaller output
// (the forward, or dW alone).
inline Geo make_geo(int batch, int d_in, int h, int w, int c_in, int c_out,
                    int z_pad, bool input_space, int th, int tw) {
  Geo g;
  g.batch = batch;
  g.d_in = d_in;
  g.h = h;
  g.w = w;
  g.c_in = c_in;
  g.c_out = c_out;
  g.z_pad = z_pad;
  g.d_out = d_in - 2 + 2 * z_pad;
  g.h_out = h - 2;
  g.w_out = w - 2;
  g.tile_d = input_space ? d_in : g.d_out;
  g.n_th = ((input_space ? h : g.h_out) + th - 1) / th;
  g.n_tw = ((input_space ? w : g.w_out) + tw - 1) / tw;
  g.n_tiles = (long long)batch * g.tile_d * g.n_th * g.n_tw;
  return g;
}

namespace {

// dk[i] = sum over the blocks' partials, in block order.
__global__ void dw_finalize_kernel(const float* __restrict__ part,
                                   float* __restrict__ dk, int n_part,
                                   long long n) {
  const long long i = (long long)blockIdx.x * kFinThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int q = 0; q < n_part; ++q) s += part[q * n + i];
  dk[i] = s;
}

// db[o] (or db[z, o] for the plane table) = sum of the tiles' g' sums, one
// block per entry, in a fixed order.
__global__ void __launch_bounds__(kFinThreads)
db_finalize_kernel(const float* __restrict__ dbp, float* __restrict__ db,
                   Geo geo, int bias_table) {
  __shared__ float red[kFinThreads];
  const int entry = blockIdx.x;
  const int o = entry % geo.c_out, zo = entry / geo.c_out;
  const long long per_plane = (long long)geo.n_th * geo.n_tw;
  const long long n = bias_table ? geo.batch * per_plane : geo.n_tiles;
  float s = 0.f;
  for (long long j = threadIdx.x; j < n; j += kFinThreads) {
    const long long tile =
        bias_table
            ? ((j / per_plane) * geo.tile_d + zo) * per_plane + j % per_plane
            : j;
    s += dbp[tile * geo.c_out + o];
  }
  red[threadIdx.x] = s;
  __syncthreads();
  for (int half = kFinThreads / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) db[entry] = red[0];
}

cudaError_t launch_finalize(const float* part, const float* dbp, float* dk,
                            float* db, const Geo& geo, int bias_table,
                            int n_part, cudaStream_t stream) {
  const long long n = 27LL * geo.c_in * geo.c_out;
  dw_finalize_kernel<<<(unsigned)((n + kFinThreads - 1) / kFinThreads),
                       kFinThreads, 0, stream>>>(part, dk, n_part, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_db = bias_table ? geo.d_out * geo.c_out : geo.c_out;
  db_finalize_kernel<<<n_db, kFinThreads, 0, stream>>>(dbp, db, geo,
                                                       bias_table);
  return cudaGetLastError();
}

// Persistent grid size: min(blocks resident on the card at once, tiles).
template <typename Kernel>
cudaError_t persistent_blocks(Kernel kernel, int threads, size_t smem,
                              long long n_tiles, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  const long long nb = (long long)per_sm * n_sm;
  *out = (int)(nb < n_tiles ? nb : (n_tiles > 0 ? n_tiles : 1));
  return cudaSuccess;
}

}  // namespace

// The fused K2's domain (ops/conv3x3.py bwd_route): 0 for (16, 16), 1 for
// (16, 32), 2 for (32, 16) channels after padding to 16; -1 outside it.
inline int fused_config(int c_in, int c_out) {
  const int ci = (c_in + 15) / 16 * 16, co = (c_out + 15) / 16 * 16;
  if (c_in < 1 || c_out < 1) return -1;
  if (ci == 16 && co == 16) return 0;
  if (ci == 16 && co == 32) return 1;
  if (ci == 32 && co == 16) return 2;
  return -1;
}

// The fused passes of conv3x3_bwd_tc.cu (bfloat16) and
// conv3x3_bwd_f32_tc.cu (float32): the tile count and grid for channel
// counts in the domain above (cudaErrorInvalidValue for others).
int conv3x3_bwd_tc_plan(int batch, int d_in, int h, int w, int c_in,
                        int c_out, int z_pad, long long* n_tiles,
                        int* n_blocks);
int conv3x3_bwd_f32_tc_plan(int batch, int d_in, int h, int w, int c_in,
                            int c_out, int z_pad, long long* n_tiles,
                            int* n_blocks);

// The dW-only passes of conv3x3_bwd_dw_tc.cu (bfloat16) and
// conv3x3_bwd_dw_f32_tc.cu (float32): the tile count and the number of
// tile chunks (rows of dW partials), for any C_in, C_out >= 1.
int conv3x3_bwd_dw_tc_plan(int batch, int d_in, int h, int w, int c_in,
                           int c_out, int z_pad, long long* n_tiles,
                           int* n_chunks);
int conv3x3_bwd_dw_f32_tc_plan(int batch, int d_in, int h, int w, int c_in,
                               int c_out, int z_pad, long long* n_tiles,
                               int* n_chunks);

}  // namespace stroke
