// The falloff of one splat at one pixel, shared by kernels B
// (composite_fwd.cu) and C (composite_bwd.cu):
//   sigma = 0.5 (a dx^2 + c dy^2) + b dx dy
//   raw alpha = opacity * exp(-min(sigma, 30))
// rounded operation by operation in the order of their plain PyTorch
// versions (ops/gaussian/compositor.py), with no fused multiply-add. Left to
// itself nvcc contracts these products into FMAs, so the kernel and the
// plain version round sigma differently in the last bit, and a pair whose
// alpha lies at the 1/255 cutoff (or sigma at 0) is kept by one and dropped
// by the other: on opaque scenes that moves a gradient of kernel C by ~1e-4
// of its row's largest value. Rounded alike, both keep the same pairs.
//
// sigma splits into terms of one offset each, (a dx) dx and b dx of a pixel
// column, (c dy) dy of a pixel row, and a last step per pixel; a kernel that
// computes each term once for its column or row gets the same bits.
#pragma once

#include <math.h>

__device__ __forceinline__ float splat_xx(float a, float dx) {
  return __fmul_rn(__fmul_rn(a, dx), dx);
}

__device__ __forceinline__ float splat_bx(float b, float dx) { return __fmul_rn(b, dx); }

__device__ __forceinline__ float splat_yy(float c, float dy) {
  return __fmul_rn(__fmul_rn(c, dy), dy);
}

// sigma from the column terms xx = (a dx) dx, bx = b dx and the row term
// yy = (c dy) dy
__device__ __forceinline__ float splat_sigma_terms(float xx, float bx, float yy,
                                                   float dy) {
  return __fadd_rn(__fmul_rn(0.5f, __fadd_rn(xx, yy)), __fmul_rn(bx, dy));
}

__device__ __forceinline__ float splat_sigma(float a, float b, float c,
                                             float dx, float dy) {
  return splat_sigma_terms(splat_xx(a, dx), splat_bx(b, dx), splat_yy(c, dy), dy);
}

__device__ __forceinline__ float splat_alpha_raw(float opacity, float sigma) {
  return __fmul_rn(opacity, expf(-fminf(sigma, 30.f)));
}
