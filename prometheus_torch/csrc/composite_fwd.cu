// Front-to-back alpha compositing of 16x16 tiles for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel prometheus_tpu/ops/gaussian/pallas_kernel.py
// ::_kernel (launched by run_compositor_kernel). Each tile owns a
// depth-sorted worklist packed channel-major as data[t] = (16, K) f32:
// rows mean_x, mean_y, conic a, b, c, r, g, b, opacity, depth (rows 10-15
// unused). For every pixel of the tile and every instance in order:
//   sigma = 0.5 (a dx^2 + c dy^2) + b dx dy
//   alpha = min(0.999, opacity * exp(-min(sigma, 30))), zeroed if alpha < 1/255
//           or sigma < 0
//   w = alpha * T;  rgb += w * color;  depth += w * z;  acc_alpha += w;
//   T *= 1 - alpha
// The tile stops after a 128-instance chunk once every pixel's T is <= 1e-4,
// the same rule as the TPU kernel (a per-pixel stop would change results by
// up to 1e-4 per channel). out[t] = (8, 256): rgb, acc_depth, acc_alpha, 0s.
//
// Design: one block per (view, tile), one thread per pixel, all views in one
// launch. A block stages each 128-instance chunk (10 rows x 128 floats) in
// shared memory with coalesced loads; every thread then reads the same
// instance at the same time (a broadcast, no bank conflicts). The TPU
// kernel's MXU prefix-sum of log(1 - alpha) is not carried over: the
// sequential T *= (1 - alpha) per pixel computes the same quantity.
//
// What bounds it on an H100: the fp32 arithmetic of the alpha evaluation
// (15 operations with one exp for every pixel-instance pair walked, 256 per
// instance staged, and 12 more for each pair the cutoff keeps) against 40
// bytes read per instance, so the SMs' fp32/SFU throughput, not device
// memory, is the floor at production density.
#include <cuda_runtime.h>
#include <math.h>

#include "splat_alpha.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kChunk = 128;
constexpr int kChannels = 16;
constexpr int kUsed = 10;
constexpr float kMaxAlpha = 0.999f;
constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;

__global__ void __launch_bounds__(kPixels)
composite_fwd_kernel(const float* __restrict__ data, const int* __restrict__ counts,
                     float* __restrict__ out, int K, int grid_w, int tiles_per_view) {
  __shared__ float s[kUsed][kChunk];
  const int t = blockIdx.x;
  const int local = t % tiles_per_view;
  const int p = threadIdx.x;
  const float px = float((local % grid_w) * kTile + p % kTile) + 0.5f;
  const float py = float((local / grid_w) * kTile + p / kTile) + 0.5f;
  const float* d = data + size_t(t) * kChannels * K;
  const int count = min(counts[t], K);

  float r = 0.f, g = 0.f, b = 0.f, dep = 0.f, acc = 0.f, T = 1.f;
  for (int base = 0; base < count; base += kChunk) {
    const int n = min(kChunk, count - base);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = p; i < kUsed * kChunk; i += kPixels) {
      const int c = i / kChunk, j = i % kChunk;
      s[c][j] = j < n ? d[size_t(c) * K + base + j] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float dx = px - s[0][j];
      const float dy = py - s[1][j];
      const float sigma = splat_sigma(s[2][j], s[3][j], s[4][j], dx, dy);
      const float alpha = fminf(kMaxAlpha, splat_alpha_raw(s[8][j], sigma));
      if (!(alpha >= kAlphaCutoff && sigma >= 0.f)) continue;
      const float w = alpha * T;
      r += w * s[5][j];
      g += w * s[6][j];
      b += w * s[7][j];
      dep += w * s[9][j];
      acc += w;
      T *= 1.f - alpha;
    }
    if (!__syncthreads_or(T > kTEps)) break;
  }
  float* o = out + size_t(t) * 8 * kPixels + p;
  o[0 * kPixels] = r;
  o[1 * kPixels] = g;
  o[2 * kPixels] = b;
  o[3 * kPixels] = dep;
  o[4 * kPixels] = acc;
  o[5 * kPixels] = 0.f;
  o[6 * kPixels] = 0.f;
  o[7 * kPixels] = 0.f;
}

}  // namespace

// data: (n_tiles, 16, K) f32, counts: (n_tiles,) i32, out: (n_tiles, 8, 256)
// f32, all contiguous on the device. Tile t is tile t % tiles_per_view of its
// view, row-major over a grid grid_w tiles wide. Returns cudaGetLastError().
extern "C" int composite_fwd(const void* data, const void* counts, void* out,
                             int n_tiles, int K, int grid_w, int tiles_per_view,
                             void* stream) {
  if (n_tiles <= 0 || K <= 0 || grid_w <= 0 || tiles_per_view <= 0)
    return int(cudaErrorInvalidValue);
  composite_fwd_kernel<<<n_tiles, kPixels, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int*>(counts),
      static_cast<float*>(out), K, grid_w, tiles_per_view);
  return int(cudaGetLastError());
}
