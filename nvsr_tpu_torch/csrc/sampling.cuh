// Device helpers shared by the plane samplers of triplane_render.cu and
// plane_sample.cu. Every f32 step uses _rn intrinsics, so no FMA
// contraction changes it and the kernels equal their plain PyTorch
// versions (one rounded operation per step) bit for bit.

#pragma once

#include <cuda_bf16.h>

__device__ inline float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// normalized grid coordinate -> source coordinate (torch grid_sample)
__device__ inline float unnormalize(float g, int size, bool align_corners) {
  if (align_corners)
    return __fmul_rn(__fmul_rn(__fadd_rn(g, 1.0f), 0.5f), (float)(size - 1));
  return __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), (float)size), 1.0f),
                   0.5f);
}

// Torch's cubic convolution kernel (A = -0.75) at signed tap distance d,
// in the Horner form of nvsr_tpu/ops/pallas/tile_sampler.py:290
// (_cubic_weight): ((A+2)|d| - (A+3))|d||d| + 1 for |d| <= 1,
// ((A|d| - 5A)|d| + 8A)|d| - 4A for |d| < 2, else 0.
__device__ inline float cubic_weight(float d) {
  const float ad = fabsf(d);
  if (ad <= 1.0f)
    return __fadd_rn(
        __fmul_rn(__fmul_rn(__fsub_rn(__fmul_rn(1.25f, ad), 2.25f), ad), ad),
        1.0f);
  if (ad < 2.0f)
    return __fadd_rn(
        __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(-0.75f, ad), 3.75f),
                                      ad),
                            -6.0f),
                  ad),
        3.0f);
  return 0.0f;
}

// Bicubic geometry of one source coordinate (already unnormalized):
// clipped to [-1, size] (exact: beyond it every tap clamps to the edge and
// the weights sum to 1 in real arithmetic, but the folded bf16 weights do
// not, so the clip is kept), then its floor and fraction.
__device__ inline void cubic_coord(float s, int size, int* i0, float* t) {
  const float c = fminf(fmaxf(s, -1.0f), (float)size);
  const float f = floorf(c);
  *i0 = (int)f;
  *t = __fsub_rn(c, f);
}
