// The plan of every fused (K2) or dW-only (K4) pass of the conv backward:
// one C entry that the wrapper (ops/conv3x3.py _plan) calls for the sizes
// of a pass's scratch buffers before it launches the pass.  The passes
// themselves are conv3x3_bwd_tc.cu (bfloat16 K2), conv3x3_bwd_f32_tc.cu
// (float32 K2), conv3x3_bwd_dw_tc.cu (bfloat16 K4) and
// conv3x3_bwd_dw_f32_tc.cu (float32 K4), all on the tensor cores.

#include <cuda_runtime.h>

#include "conv3x3_bwd.cuh"

// Sizes of the scratch buffers for a fused (with_dx 1) or dW-only (0) pass:
// the number of tiles (db partials: n_tiles x C_out floats) and of dW
// partials (n_blocks x 27 x C_in x C_out floats: one per persistent block
// of a fused pass, or one per chunk of tiles of a dW-only pass).
extern "C" int conv3x3_bwd_plan(int with_dx, int bf16, int batch, int d_in,
                                int h, int w, int c_in, int c_out, int z_pad,
                                long long* n_tiles, int* n_blocks) {
  if (with_dx) {
    return bf16 ? stroke::conv3x3_bwd_tc_plan(batch, d_in, h, w, c_in, c_out,
                                              z_pad, n_tiles, n_blocks)
                : stroke::conv3x3_bwd_f32_tc_plan(batch, d_in, h, w, c_in,
                                                  c_out, z_pad, n_tiles,
                                                  n_blocks);
  }
  return bf16 ? stroke::conv3x3_bwd_dw_tc_plan(batch, d_in, h, w, c_in,
                                               c_out, z_pad, n_tiles,
                                               n_blocks)
              : stroke::conv3x3_bwd_dw_f32_tc_plan(batch, d_in, h, w, c_in,
                                                   c_out, z_pad, n_tiles,
                                                   n_blocks);
}
