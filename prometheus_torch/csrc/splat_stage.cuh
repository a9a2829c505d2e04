// Instance-major staging of packed worklists in shared memory, shared by
// kernels B (composite_fwd.cu) and C (composite_bwd.cu).
//
// A worklist data[t] = (kChannels, K) f32 is channel-major: rows mean_x,
// mean_y, conic a, b, c, r, g, b, opacity, depth (rows 10-15 unused). The
// kUsed rows of a kChunk-slot chunk are copied by cp.async into shared memory
// instance-major, kStride floats an instance, so that every thread reads one
// instance back as two float4 and one float2 broadcast loads instead of ten
// scalar ones, and the copy of the next chunk overlaps the walk of this one.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kChunk = 128;    // slots of one staged chunk
constexpr int kChannels = 16;  // rows of a packed worklist
constexpr int kUsed = 10;      // rows the kernels read
constexpr int kStride = 12;    // floats of one staged instance (16-byte rows)

// one staged instance: the data rows 0-9
struct Splat {
  float mx, my, a, b, c, r, g, bl, op, z;
};

__device__ __forceinline__ Splat load_splat(const float* s) {
  const float4 x = *reinterpret_cast<const float4*>(s);
  const float4 y = *reinterpret_cast<const float4*>(s + 4);
  const float2 z = *reinterpret_cast<const float2*>(s + 8);
  return {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w, z.x, z.y};
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Start copying rows 0-9 of the first n slots of chunk c of the worklist d
// (row stride K) into s (kChunk x kStride floats), instance-major, as one
// cp.async group that the kThreads threads of the block share. Slots n and
// up of s keep what they held.
template <int kThreads>
__device__ __forceinline__ void stage_async(float* s, const float* d, int K, int c,
                                            int n = kChunk) {
  for (int i = threadIdx.x; i < kUsed * kChunk; i += kThreads) {
    const int row = i / kChunk, j = i % kChunk;
    if (j < n) cp_async4(s + j * kStride + row, d + size_t(row) * K + c * kChunk + j);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}
