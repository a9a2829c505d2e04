// Gradient of the 16x16 tile compositor for Hopper (sm_90a): per-instance
// gradients of the packed worklists from the upstream pixel gradients.
//
// Replaces the Pallas TPU kernel prometheus_tpu/ops/gaussian/
// pallas_backward.py::_bwd_kernel (launched by _pallas_backward under the
// custom VJP composite_pallas_diff). data[t] = (16, K) f32 holds rows mean_x,
// mean_y, conic a, b, c, r, g, b, opacity, depth (composite_fwd.cu's layout);
// gout[t] = (8, 256) holds dL/d(rgb, accumulated depth, accumulated alpha)
// per pixel. For pixel p and instances i in order, with w_i = alpha_i T_i:
//   u_i       = c_i . gC + z_i gZ + gA
//   S_i       = sum_{j > i} u_j w_j            (over the whole worklist)
//   dL/dalpha = u_i T_i - S_i / max(1 - alpha_i, 1e-3)   on live pairs only
//               (alpha_raw in [1/255, 0.999), sigma >= 0)
//   dsigma    = -alpha dalpha;  d opacity = dalpha alpha / opacity
//   d mean, d conic through sigma = 0.5 (a dx^2 + c dy^2) + b dx dy
//   d color   = gC w_i;  d depth = gZ w_i
// summed over the tile's 256 pixels into gdata[t] (16, K): rows 0-9 as data,
// rows 10-15 zero, slots past the last walked 128-instance chunk zero. As
// the Pallas kernel, the walk has no early stop: it covers every chunk the
// tile's count reaches, all 128 slots of each (dead slots carry opacity 0).
//
// Design: one block per (view, tile), one thread per pixel, all views in one
// launch. Pass 1 walks the worklist front to back and keeps the
// transmittance at every 32-instance boundary in shared memory (K / 32 x
// 256 floats, 32 KB at K = 1024), in place of the TPU kernel's log-space
// reconstruction. Pass 2 walks the chunks back to front; for each
// 32-instance sub-chunk a thread recomputes alpha and T forward into
// registers, then walks it in reverse with its running suffix sum S. The 10
// gradients of each instance are summed over a warp with shuffles (skipped
// when no pixel of the warp sees the instance), then over the 8 warps
// through shared memory, and written once.
//
// What bounds it on an H100: the fp32 arithmetic of evaluating alpha for
// every (pixel, instance) pair walked and of the gradient for every pair the
// cutoff keeps, against 40 bytes read per walked instance and the 16 x K x 4
// bytes of gdata written per tile.
#include <cuda_runtime.h>
#include <math.h>

#include "splat_alpha.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kWarps = kPixels / 32;
constexpr int kChunk = 128;
constexpr int kSub = 32;
constexpr int kSubs = kChunk / kSub;
constexpr int kChannels = 16;
constexpr int kUsed = 10;
constexpr float kMaxAlpha = 0.999f;
constexpr float kAlphaCutoff = 1.0f / 255.0f;

__device__ __forceinline__ float alpha_at(float (*s)[kChunk], int j,
                                          float px, float py) {
  const float dx = px - s[0][j];
  const float dy = py - s[1][j];
  const float sigma = splat_sigma(s[2][j], s[3][j], s[4][j], dx, dy);
  const float raw = splat_alpha_raw(s[8][j], sigma);
  return (raw >= kAlphaCutoff && sigma >= 0.f) ? fminf(raw, kMaxAlpha) : 0.f;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage rows 0-9 of the 128 slots of chunk c in shared memory.
__device__ __forceinline__ void stage(float (*s)[kChunk], const float* d, int K,
                                      int c) {
  for (int i = threadIdx.x; i < kUsed * kChunk; i += kPixels) {
    const int row = i / kChunk, j = i % kChunk;
    s[row][j] = d[size_t(row) * K + c * kChunk + j];
  }
}

__global__ void __launch_bounds__(kPixels)
composite_bwd_kernel(const float* __restrict__ data, const float* __restrict__ gout,
                     const int* __restrict__ counts, float* __restrict__ gdata,
                     int K, int grid_w, int tiles_per_view) {
  extern __shared__ float smem[];
  float(*s)[kChunk] = reinterpret_cast<float(*)[kChunk]>(smem);  // [kUsed][kChunk]
  float* red = smem + kUsed * kChunk;                 // [kWarps][kSub][kUsed]
  float* t_sub = red + kWarps * kSub * kUsed;         // [K / kSub][kPixels]

  const int t = blockIdx.x;
  const int local = t % tiles_per_view;
  const int p = threadIdx.x, warp = p / 32, lane = p % 32;
  const float px = float((local % grid_w) * kTile + p % kTile) + 0.5f;
  const float py = float((local / grid_w) * kTile + p / kTile) + 0.5f;
  const float* d = data + size_t(t) * kChannels * K;
  float* g = gdata + size_t(t) * kChannels * K;
  const int count = min(counts[t], K);
  const int n_chunks = (count + kChunk - 1) / kChunk;
  const int walked = n_chunks * kChunk;

  // what the walk does not write: rows 10-15, and slots past the walk
  for (int i = p; i < (kChannels - kUsed) * K; i += kPixels) g[size_t(kUsed) * K + i] = 0.f;
  for (int i = p; i < kUsed * (K - walked); i += kPixels)
    g[size_t(i / (K - walked)) * K + walked + i % (K - walked)] = 0.f;

  const float* go = gout + size_t(t) * 8 * kPixels + p;
  const float gR = go[0], gG = go[kPixels], gB = go[2 * kPixels];
  const float gZ = go[3 * kPixels], gA = go[4 * kPixels];

  // pass 1: transmittance at every sub-chunk boundary
  float T = 1.f;
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // the previous chunk's readers are done
    stage(s, d, K, c);
    __syncthreads();
    for (int sb = 0; sb < kSubs; ++sb) {
      t_sub[(c * kSubs + sb) * kPixels + p] = T;
      for (int jj = 0; jj < kSub; ++jj) T *= 1.f - alpha_at(s, sb * kSub + jj, px, py);
    }
  }

  // pass 2: back to front with the running suffix sum S of u w
  float S = 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    __syncthreads();
    stage(s, d, K, c);
    __syncthreads();
    for (int sb = kSubs - 1; sb >= 0; --sb) {
      float al[kSub], tin[kSub];
      float Tc = t_sub[(c * kSubs + sb) * kPixels + p];
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        al[jj] = alpha_at(s, sb * kSub + jj, px, py);
        tin[jj] = Tc;
        Tc *= 1.f - al[jj];
      }
#pragma unroll
      for (int jj = kSub - 1; jj >= 0; --jj) {
        const int j = sb * kSub + jj;
        const float a = al[jj];
        float v[kUsed];
#pragma unroll
        for (int r = 0; r < kUsed; ++r) v[r] = 0.f;
        if (__any_sync(0xffffffffu, a > 0.f)) {
          if (a > 0.f) {
            const float ti = tin[jj], w = a * ti;
            const float u = s[5][j] * gR + s[6][j] * gG + s[7][j] * gB + s[9][j] * gZ + gA;
            if (a < kMaxAlpha) {  // live: the 0.999 clamp passes no gradient
              const float da = u * ti - S / fmaxf(1.f - a, 1e-3f);
              const float dsig = -a * da;
              const float dx = px - s[0][j], dy = py - s[1][j];
              const float ca = s[2][j], cb = s[3][j], cc = s[4][j];
              v[0] = -dsig * (ca * dx + cb * dy);
              v[1] = -dsig * (cc * dy + cb * dx);
              v[2] = dsig * 0.5f * dx * dx;
              v[3] = dsig * dx * dy;
              v[4] = dsig * 0.5f * dy * dy;
              const float op = s[8][j];
              v[8] = op > 0.f ? da * (a / fmaxf(op, 1e-8f)) : 0.f;
            }
            v[5] = gR * w;
            v[6] = gG * w;
            v[7] = gB * w;
            v[9] = gZ * w;
            S += u * w;
          }
#pragma unroll
          for (int r = 0; r < kUsed; ++r) v[r] = warp_sum(v[r]);
        }
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < kUsed; ++r) red[(warp * kSub + jj) * kUsed + r] = v[r];
        }
      }
      __syncthreads();
      for (int i = p; i < kUsed * kSub; i += kPixels) {
        const int r = i / kSub, jj = i % kSub;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += red[(w * kSub + jj) * kUsed + r];
        g[size_t(r) * K + c * kChunk + sb * kSub + jj] = sum;
      }
      __syncthreads();  // red is rewritten by the next sub-chunk
    }
  }
}

}  // namespace

// data: (n_tiles, 16, K) f32, gout: (n_tiles, 8, 256) f32, counts: (n_tiles,)
// i32, gdata: (n_tiles, 16, K) f32, all contiguous on the device; K % 128 ==
// 0. Tile t is tile t % tiles_per_view of its view, row-major over a grid
// grid_w tiles wide. Returns cudaGetLastError() after the launch.
extern "C" int composite_bwd(const void* data, const void* gout, const void* counts,
                             void* gdata, int n_tiles, int K, int grid_w,
                             int tiles_per_view, void* stream) {
  if (n_tiles <= 0 || K <= 0 || K % kChunk || grid_w <= 0 || tiles_per_view <= 0)
    return int(cudaErrorInvalidValue);
  const size_t bytes =
      sizeof(float) * (kUsed * kChunk + kWarps * kSub * kUsed + size_t(K / kSub) * kPixels);
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  composite_bwd_kernel<<<n_tiles, kPixels, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const float*>(gout),
      static_cast<const int*>(counts), static_cast<float*>(gdata), K, grid_w,
      tiles_per_view);
  return int(cudaGetLastError());
}
