// Device helpers shared by the conv kernels: loads and stores of float32
// storage for the CUDA-core kernels (conv3x3_bwd.cu), the activations and
// their gradients, and g' formed in the storage type.  A bfloat16 value is
// rounded to nearest even (__float2bfloat16_rn), as PyTorch's
// .to(torch.bfloat16) does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace stroke {

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

// act: 0 none, 1 LeakyReLU(alpha), 2 ELU(alpha) with the exp of the clamped
// value (s2d.py _act).
__device__ __forceinline__ float activate(float y, int act, float alpha) {
  if (act == 1) return y > 0.f ? y : alpha * y;
  if (act == 2) return y > 0.f ? y : alpha * (expf(fminf(y, 0.f)) - 1.f);
  return y;
}

// d act / d pre-activation, from the saved OUTPUT y (s2d.py _s2d_conv_bwd):
// LeakyReLU 1 or alpha (alpha at y == 0), ELU 1 or y + alpha, none 1.
__device__ __forceinline__ float act_grad(float y, int act, float alpha) {
  if (act == 1) return y > 0.f ? 1.f : alpha;
  if (act == 2) return y > 0.f ? 1.f : y + alpha;
  return 1.f;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// g' = g * act'(y) as s2d.py:879-889 forms it in the storage type T: for
// bfloat16, alpha, ELU's y + alpha and the product are each rounded to
// bfloat16 (as ops/conv3x3.py _masked_cotangent does); for float32 all in
// float32.
template <typename T>
__device__ __forceinline__ float cotangent(float g, float y, int act,
                                           float alpha) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const float a = round_bf16(alpha);
    const float d =
        (act == 2 && !(y > 0.f)) ? round_bf16(y + a) : act_grad(y, act, a);
    return round_bf16(g * d);
  } else {
    return g * act_grad(y, act, alpha);
  }
}

}  // namespace stroke
