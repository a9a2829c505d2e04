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
// What bounds it on an H100: the fp32 arithmetic of evaluating alpha for
// every (pixel, instance) pair walked and of the gradient for every pair the
// cutoff keeps, against 40 bytes read per walked instance and the 16 x K x 4
// bytes of gdata written per tile; device memory is far from the limit. In
// practice the instructions issued per pair bound it: alpha is evaluated
// twice for every walked pair (once to find the transmittance, once to walk
// back), ~25 instructions each with the falloff rounded op by op
// (splat_alpha.cuh), and summing ten gradients per instance over a tile's
// pixels costs 50 shuffles a warp with plain warp sums.
//
// Design: one block per (view, tile), all views in one launch; a thread owns
// kPix = 2 vertically adjacent pixels of one column (128 threads a tile),
// shares each instance's loads between them and adds their gradients in
// registers before any reduction across lanes.
// - Staging (splat_stage.cuh): the 10 used rows of a 128-instance chunk are
//   copied by cp.async into shared memory instance-major (12 floats an
//   instance, read back as two float4 and a float2 broadcast loads),
//   double-buffered: the next chunk (pass 1) or the previous one (pass 2)
//   is in flight while the current one is walked.
// - Pass 1 walks the chunks front to back and keeps each pixel's
//   transmittance at every 16-instance boundary in shared memory (K / 16 x
//   256 floats, 64 KB at K = 1024), in place of the TPU kernel's log-space
//   reconstruction (T is never rebuilt by dividing by 1 - alpha).
// - Pass 2 walks the chunks back to front; for each 16-instance sub-chunk a
//   thread recomputes alpha and T forward into registers for its pixels,
//   then walks the sub-chunk in reverse with each pixel's running suffix sum
//   S. The ten gradients of three consecutive instances (30 of 32 values a
//   lane) are summed over the warp by one reduce-scatter butterfly: each of
//   its 5 steps hands half of the values a lane holds to its partner, 16 +
//   8 + 4 + 2 + 1 = 31 shuffles for 3 instances where warp sums take 150,
//   after which lane L holds value L; a group no pixel of the warp sees is
//   skipped. The lanes store their sums as per-warp partials of the chunk,
//   and the block adds the 4 warps' partials in a fixed order once per
//   128-instance chunk (two block barriers a chunk), so the result does not
//   depend on the order warps run in. Shared memory 96 KB at K = 1024.
// Chosen by measurement among 1 or 2 pixels a thread, 16- or 32-instance
// sub-chunks, exact or fast division, and a warp-level skip of instances
// whose footprint misses the warp's rows (slower in every pairing).
#include <cuda_runtime.h>
#include <math.h>

#include "splat_alpha.cuh"
#include "splat_stage.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kPix = 2;  // pixels a thread: (col, 2 r) and (col, 2 r + 1)
constexpr int kThreads = kPixels / kPix;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 16;  // instances between transmittance checkpoints
constexpr int kSubs = kChunk / kSub;
constexpr int kGroup = 3;    // instances a butterfly sums
constexpr int kGroups = (kSub + kGroup - 1) / kGroup;
constexpr float kMaxAlpha = 0.999f;
constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float alpha_at(const Splat& s, float px, float py) {
  const float dx = px - s.mx;
  const float dy = py - s.my;
  const float sigma = splat_sigma(s.a, s.b, s.c, dx, dy);
  const float raw = splat_alpha_raw(s.op, sigma);
  return (raw >= kAlphaCutoff && sigma >= 0.f) ? fminf(raw, kMaxAlpha) : 0.f;
}

// One step of a reduce-scatter over the warp: a lane holds 2 H values and
// keeps H of them, the upper half where lane bit H is set (the lower half
// goes to its partner, which keeps the lower half), adding the partner's.
template <int H>
__device__ __forceinline__ void reduce_step(float (&x)[32], int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? x[i] : x[i + H];
    const float keep = up ? x[i + H] : x[i];
    x[i] = keep + __shfl_xor_sync(kFull, send, H);
  }
}

// Sum value L of x over the warp into lane L: 16 + 8 + 4 + 2 + 1 shuffles.
__device__ __forceinline__ float reduce_scatter(float (&x)[32], int lane) {
  reduce_step<16>(x, lane);
  reduce_step<8>(x, lane);
  reduce_step<4>(x, lane);
  reduce_step<2>(x, lane);
  reduce_step<1>(x, lane);
  return x[0];
}

__global__ void __launch_bounds__(kThreads)
composite_bwd_kernel(const float* __restrict__ data, const float* __restrict__ gout,
                     const int* __restrict__ counts, float* __restrict__ gdata,
                     int K, int grid_w, int tiles_per_view) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                             // [2][kChunk][kStride]
  float* part = stage + 2 * kChunk * kStride;      // [kWarps][kUsed][kChunk]
  float* t_sub = part + kWarps * kUsed * kChunk;   // [K / kSub][kPixels]

  const int t = blockIdx.x;
  const int local = t % tiles_per_view;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // pixels (col, row0 + q), q < kPix, of the tile
  const int col = tid % kTile, row0 = kPix * (tid / kTile);
  const float px = float((local % grid_w) * kTile + col) + 0.5f;
  float py[kPix];
  int pix[kPix];
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    py[q] = float((local / grid_w) * kTile + row0 + q) + 0.5f;
    pix[q] = (row0 + q) * kTile + col;
  }
  const float* d = data + size_t(t) * kChannels * K;
  float* g = gdata + size_t(t) * kChannels * K;
  const int count = min(counts[t], K);
  const int n_chunks = (count + kChunk - 1) / kChunk;
  const int walked = n_chunks * kChunk;

  // what the walk does not write: rows 10-15, and slots past the walk
  for (int i = tid; i < (kChannels - kUsed) * K; i += kThreads) g[size_t(kUsed) * K + i] = 0.f;
  for (int i = tid; i < kUsed * (K - walked); i += kThreads)
    g[size_t(i / (K - walked)) * K + walked + i % (K - walked)] = 0.f;
  if (n_chunks == 0) return;

  float gR[kPix], gG[kPix], gB[kPix], gZ[kPix], gA[kPix];
  const float* go = gout + size_t(t) * 8 * kPixels;
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    gR[q] = go[pix[q]];
    gG[q] = go[kPixels + pix[q]];
    gB[q] = go[2 * kPixels + pix[q]];
    gZ[q] = go[3 * kPixels + pix[q]];
    gA[q] = go[4 * kPixels + pix[q]];
  }

  // pass 1: transmittance at every sub-chunk boundary
  float T[kPix];
#pragma unroll
  for (int q = 0; q < kPix; ++q) T[q] = 1.f;
  stage_async<kThreads>(stage, d, K, 0);
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c is in; every thread is done with chunk c - 1
    if (c + 1 < n_chunks) stage_async<kThreads>(stage + ((c + 1) & 1) * kChunk * kStride, d, K, c + 1);
    const float* s = stage + (c & 1) * kChunk * kStride;
    for (int sb = 0; sb < kSubs; ++sb) {
#pragma unroll
      for (int q = 0; q < kPix; ++q) t_sub[(c * kSubs + sb) * kPixels + pix[q]] = T[q];
#pragma unroll 8
      for (int jj = 0; jj < kSub; ++jj) {
        const Splat sp = load_splat(s + (sb * kSub + jj) * kStride);
#pragma unroll
        for (int q = 0; q < kPix; ++q) T[q] *= 1.f - alpha_at(sp, px, py[q]);
      }
    }
  }

  // pass 2: back to front with each pixel's running suffix sum S of u w.
  // Chunk n_chunks - 1 is still staged from pass 1.
  float S[kPix];
#pragma unroll
  for (int q = 0; q < kPix; ++q) S[q] = 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c is in; the last chunk's partials are summed
    if (c > 0) stage_async<kThreads>(stage + ((c - 1) & 1) * kChunk * kStride, d, K, c - 1);
    const float* s = stage + (c & 1) * kChunk * kStride;
    for (int sb = kSubs - 1; sb >= 0; --sb) {
      float al[kSub][kPix], tin[kSub][kPix];
      float Tc[kPix];
#pragma unroll
      for (int q = 0; q < kPix; ++q) Tc[q] = t_sub[(c * kSubs + sb) * kPixels + pix[q]];
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const Splat sp = load_splat(s + (sb * kSub + jj) * kStride);
#pragma unroll
        for (int q = 0; q < kPix; ++q) {
          al[jj][q] = alpha_at(sp, px, py[q]);
          tin[jj][q] = Tc[q];
          Tc[q] *= 1.f - al[jj][q];
        }
      }
      // groups of kGroup instances from the top of the sub-chunk down
#pragma unroll
      for (int grp = 0; grp < kGroups; ++grp) {
        constexpr int kLast = kSub - kGroup * (kGroups - 1);  // instances of the last group
        const int n_in = grp < kGroups - 1 ? kGroup : kLast;
        float v[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) v[i] = 0.f;
        bool seen = false;
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          if (k >= n_in) continue;
          const int jj = kSub - 1 - kGroup * grp - k;
          const Splat sp = load_splat(s + (sb * kSub + jj) * kStride);
#pragma unroll
          for (int q = 0; q < kPix; ++q) {
            const float a = al[jj][q];
            if (a > 0.f) {
              seen = true;
              const float ti = tin[jj][q], w = a * ti;
              const float u = sp.r * gR[q] + sp.g * gG[q] + sp.bl * gB[q] + sp.z * gZ[q] + gA[q];
              if (a < kMaxAlpha) {  // live: the 0.999 clamp passes no gradient
                const float da = u * ti - __fdividef(S[q], fmaxf(1.f - a, 1e-3f));
                const float dsig = -a * da;
                const float dx = px - sp.mx, dy = py[q] - sp.my;
                v[kUsed * k + 0] += -dsig * (sp.a * dx + sp.b * dy);
                v[kUsed * k + 1] += -dsig * (sp.c * dy + sp.b * dx);
                v[kUsed * k + 2] += dsig * 0.5f * dx * dx;
                v[kUsed * k + 3] += dsig * dx * dy;
                v[kUsed * k + 4] += dsig * 0.5f * dy * dy;
                v[kUsed * k + 8] += sp.op > 0.f ? da * __fdividef(a, fmaxf(sp.op, 1e-8f)) : 0.f;
              }
              v[kUsed * k + 5] += gR[q] * w;
              v[kUsed * k + 6] += gG[q] * w;
              v[kUsed * k + 7] += gB[q] * w;
              v[kUsed * k + 9] += gZ[q] * w;
              S[q] += u * w;
            }
          }
        }
        const float sum = __any_sync(kFull, seen) ? reduce_scatter(v, lane) : 0.f;
        if (lane < kUsed * n_in) {
          const int jj = kSub - 1 - kGroup * grp - lane / kUsed;
          part[(warp * kUsed + lane % kUsed) * kChunk + sb * kSub + jj] = sum;
        }
      }
    }
    __syncthreads();  // every warp's partials of chunk c are in
    for (int i = tid; i < kUsed * kChunk; i += kThreads) {
      const int r = i / kChunk, j = i % kChunk;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += part[(w * kUsed + r) * kChunk + j];
      g[size_t(r) * K + c * kChunk + j] = sum;
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
      sizeof(float) * (2 * kChunk * kStride + kWarps * kUsed * kChunk + size_t(K / kSub) * kPixels);
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  composite_bwd_kernel<<<n_tiles, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const float*>(gout),
      static_cast<const int*>(counts), static_cast<float*>(gdata), K, grid_w,
      tiles_per_view);
  return int(cudaGetLastError());
}
