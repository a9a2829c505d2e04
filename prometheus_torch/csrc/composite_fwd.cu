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
// The TPU kernel's MXU prefix-sum of log(1 - alpha) is not carried over: the
// sequential T *= (1 - alpha) per pixel computes the same quantity.
//
// What bounds it on an H100: instruction issue. The falloff is rounded op by
// op (splat_alpha.cuh) and exp is the accurate expf, so every walked pair
// costs its sigma (as compiled, 25 instructions an instance for a thread's
// two pixels), and every instance a warp does not skip an exp, the cutoff
// tests and an update per pixel (44 more), against 40 bytes read per walked
// instance. The first design (one thread per pixel, ten scalar
// shared-memory loads a pair, synchronous staging) was bound by those loads
// on the memory-instruction pipe instead.
//
// Design: one block per (view, tile), all views in one launch.
// - A thread owns two vertically adjacent pixels of one column (128 threads
//   a tile) and a warp an 8 x 8 quarter of the tile. A thread reads each
//   instance once for both pixels and takes dx, (a dx) dx and b dx once for
//   the column, dy and (c dy) dy once per row: the same rounded operations
//   on the same operands as the first design, so sigma, alpha and every
//   pixel's sequential T are bit-identical to it.
// - Staging (splat_stage.cuh): each 128-instance chunk is copied by cp.async
//   into shared memory instance-major, double-buffered (chunk c + 1 lands
//   while chunk c is walked), and read back as vector broadcast loads. Slot
//   10 of each staged instance gets its reach, ln(255 opacity) + 0.01: a pair
//   whose sigma exceeds it is below the 1/255 cutoff.
// - A warp skips the exp and the update of an instance when the sigma of
//   every one of its 64 pixels exceeds the reach (one vote), which changes
//   no result.
// Chosen by timing against the first design (bit-equal outputs): two pixels
// a thread beat 1, 2 x 1, 2 x 2 and 1 x 4 (more registers, and 128-pixel
// warps skip less); 8 x 8 warps beat 16 x 4; skipping the update of a cut
// pair beat a branchless update; the per-instance reach beat a fixed one
// (5.6, for opacity <= 1) and no skip; testing sigma > reach alone beat
// also testing its sign; unrolling 4 times beat 1, 2 and 8; no register cap
// beat a cap for more resident warps; one instance a vote beat two; loading
// the colours with the geometry beat loading them after the vote. Walking
// tiles longest-first was faster, but sorting the counts cost more than it
// saved.
#include <cuda_runtime.h>
#include <math.h>

#include "splat_alpha.cuh"
#include "splat_stage.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kThreads = kPixels / 2;  // pixels (col, row0) and (col, row0 + 1)
constexpr float kMaxAlpha = 0.999f;
constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr int kReachSlot = 10;  // of a staged instance (kStride floats)
static_assert(kReachSlot >= kUsed && kReachSlot < kStride, "the reach needs a free slot");
constexpr unsigned kFull = 0xffffffffu;

// The sigma beyond which a pair of opacity op is certainly below the cutoff:
// op exp(-sigma) < 1/255 for sigma > ln(255 op), and 0.01 of margin covers
// the rounding of logf, expf and the product. Infinite where the clamp of
// sigma at 30 could keep a pair; NaN (never exceeded) for op < 0 or NaN;
// -inf (always exceeded) for op = 0.
__device__ __forceinline__ float splat_reach(float op) {
  const float r = logf(op * 255.f) + 0.01f;
  return r >= 30.f ? INFINITY : r;
}

__global__ void __launch_bounds__(kThreads)
composite_fwd_kernel(const float* __restrict__ data, const int* __restrict__ counts,
                     float* __restrict__ out, int K, int grid_w, int tiles_per_view) {
  __shared__ __align__(16) float stage[2][kChunk * kStride];
  const int t = blockIdx.x;
  const int local = t % tiles_per_view;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // warp w covers the 8 x 8 quarter (w % 2, w / 2) of the tile
  const int col = 8 * (warp % 2) + lane % 8;
  const int row0 = 8 * (warp / 2) + 2 * (lane / 8);
  const float px = float((local % grid_w) * kTile + col) + 0.5f;
  const float py[2] = {float((local / grid_w) * kTile + row0) + 0.5f,
                       float((local / grid_w) * kTile + row0 + 1) + 0.5f};
  const float* d = data + size_t(t) * kChannels * K;
  const int count = min(counts[t], K);
  const int n_chunks = (count + kChunk - 1) / kChunk;

  float r[2] = {0.f, 0.f}, g[2] = {0.f, 0.f}, b[2] = {0.f, 0.f};
  float dep[2] = {0.f, 0.f}, acc[2] = {0.f, 0.f}, T[2] = {1.f, 1.f};
  if (n_chunks > 0) {
    stage_async<kThreads>(stage[0], d, K, 0, min(count, kChunk));
    cp_async_wait_all();
    __syncthreads();
  }
  for (int c = 0; c < n_chunks; ++c) {
    // chunk c + 1 lands while chunk c is walked; its buffer held chunk c - 1,
    // which every thread finished before the last barrier
    if (c + 1 < n_chunks)
      stage_async<kThreads>(stage[(c + 1) & 1], d, K, c + 1,
                            min(count - (c + 1) * kChunk, kChunk));
    float* s = stage[c & 1];
    const int n = min(count - c * kChunk, kChunk);
    for (int j = threadIdx.x; j < n; j += kThreads)
      s[j * kStride + kReachSlot] = splat_reach(s[j * kStride + 8]);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const Splat sp = load_splat(s + j * kStride);
      const float reach = s[j * kStride + kReachSlot];
      const float dx = px - sp.mx;
      const float xx = splat_xx(sp.a, dx), bx = splat_bx(sp.b, dx);
      float sig[2];
      bool near = false;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float dy = py[q] - sp.my;
        sig[q] = splat_sigma_terms(xx, bx, splat_yy(sp.c, dy), dy);
        near |= !(sig[q] > reach);
      }
      if (!__any_sync(kFull, near)) continue;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float alpha = fminf(kMaxAlpha, splat_alpha_raw(sp.op, sig[q]));
        if (!(alpha >= kAlphaCutoff && sig[q] >= 0.f)) continue;
        const float w = alpha * T[q];
        r[q] += w * sp.r;
        g[q] += w * sp.g;
        b[q] += w * sp.bl;
        dep[q] += w * sp.z;
        acc[q] += w;
        T[q] *= 1.f - alpha;
      }
    }
    if (c + 1 < n_chunks) {
      cp_async_wait_all();  // this thread's part of chunk c + 1 is in
      // also: all of chunk c + 1 is in, and chunk c's buffer is free
      if (!__syncthreads_or(T[0] > kTEps || T[1] > kTEps)) break;
    }
  }

  float* o = out + size_t(t) * 8 * kPixels;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int p = (row0 + q) * kTile + col;
    o[0 * kPixels + p] = r[q];
    o[1 * kPixels + p] = g[q];
    o[2 * kPixels + p] = b[q];
    o[3 * kPixels + p] = dep[q];
    o[4 * kPixels + p] = acc[q];
    o[5 * kPixels + p] = 0.f;
    o[6 * kPixels + p] = 0.f;
    o[7 * kPixels + p] = 0.f;
  }
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
  composite_fwd_kernel<<<n_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int*>(counts),
      static_cast<float*>(out), K, grid_w, tiles_per_view);
  return int(cudaGetLastError());
}
