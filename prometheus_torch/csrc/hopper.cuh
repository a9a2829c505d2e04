// Hopper (sm_90a) building blocks shared by the attention kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu): mbarriers, TMA tensor and bulk
// copies, the bulk reduce-add, wgmma shared-memory descriptors and issue
// helpers (bf16 in, fp32 accumulators in registers), named barriers and
// setmaxnreg, all in inline PTX so that a source including it builds in
// seconds; and, on the host, the 4-D tensor map over a BTNH bf16 tensor.
//
// wgmma accumulator layout (m64nN, fp32), which the kernels' softmax and
// epilogues index: thread t of the warpgroup holds rows r0 = 16 (t / 32) +
// (t % 32) / 4 and r1 = r0 + 8; register i sits at row (i % 4 < 2 ? r0 : r1)
// and column 8 (i / 4) + 2 (t % 4) + (i % 2). The register A operand of one
// k16 step is the same layout over 16 columns, so an accumulator becomes an
// A operand by packing pairs (acc_to_a).
//
// Shared-memory operands are the layouts TMA writes: a box 64 bf16 wide
// (128-byte rows, 128-byte swizzle, 1024-byte atoms of 8 rows) or 16 wide
// (32-byte rows, 32-byte swizzle, 256-byte atoms). Every tile starts on a
// 1024-byte boundary, so the descriptors' base offset is 0.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------- basics

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bar.sync on a named barrier (0 is __syncthreads) for `threads` threads
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// arrive at a named barrier without waiting for it
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

// generic-proxy writes to shared memory, made visible to TMA and wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that never
// ends (a pipeline fault) traps after about 2^26 tries, each of which may
// sleep up to the hardware's time limit, so the launch fails instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// ---------------------------------------------------------------- TMA

// a 4-D box of `map` at coordinates (c0, c1, c2, c3), innermost first
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// dst[i] += src[i] in device memory for `bytes` of fp32, as one bulk
// operation; its order against other blocks' additions is not fixed
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst,
                                                    const float* src,
                                                    uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], "
      "%2;" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the committed bulk operations have read their shared-memory source
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// the committed bulk operations are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ---------------------------------------------------------------- wgmma

enum Swizzle : uint32_t { kSw128 = 1, kSw32 = 3 };

// Shared-memory matrix descriptor (`lbo`, `sbo` in bytes). K-major
// operands with a swizzle ignore `lbo` (the kernels pass 16) and take in
// `sbo` the step between groups of 8 rows along M or N. For MN-major ones
// `lbo` is the step between 64- (or 16-) element atoms along M or N, unused
// where the operand is one atom wide as in every product here, and `sbo`
// the step between groups of 8 rows along K.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo, Swizzle sw) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(sw) << 62);
}

// a descriptor moved by `bytes` (a multiple of 16) along its tile
__device__ __forceinline__ uint64_t advance(uint64_t d, uint32_t bytes) {
  return d + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// at most N committed groups still run (groups finish in order)
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator, or of
// a register A operand, across the asynchronous wgmma that uses it
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

#define HOPPER_F8(d, i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_W8(d, i)                                                     \
  "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]), "=f"(d[i + 4]), \
      "=f"(d[i + 5]), "=f"(d[i + 6]), "=f"(d[i + 7])

#define HOPPER_N128                                                           \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}"
#define HOPPER_N64                                                            \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}, %32, %33, p, 1, 1, %35, %36;\n}"
#define HOPPER_N16                                                            \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"                                \
  "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}"

// d (64 x N) = A (64 x 16) B (16 x N) (+ d with ACC), A and B from shared
// memory. TA / TB: 0 for a K-major operand, 1 for an MN-major one. Without
// ACC the old d is neither read nor kept alive, so its registers are free
// between one product and the next.
template <int TA, int TB, bool ACC>
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db) {
  if constexpr (ACC)
    asm volatile(HOPPER_N128
                 : HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16),
                   HOPPER_F8(d, 24), HOPPER_F8(d, 32), HOPPER_F8(d, 40),
                   HOPPER_F8(d, 48), HOPPER_F8(d, 56)
                 : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  else
    asm volatile(HOPPER_N128
                 : HOPPER_W8(d, 0), HOPPER_W8(d, 8), HOPPER_W8(d, 16),
                   HOPPER_W8(d, 24), HOPPER_W8(d, 32), HOPPER_W8(d, 40),
                   HOPPER_W8(d, 48), HOPPER_W8(d, 56)
                 : "l"(da), "l"(db), "r"(0), "n"(TA), "n"(TB));
}

template <int TA, int TB, bool ACC>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  if constexpr (ACC)
    asm volatile(HOPPER_N64
                 : HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16),
                   HOPPER_F8(d, 24)
                 : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  else
    asm volatile(HOPPER_N64
                 : HOPPER_W8(d, 0), HOPPER_W8(d, 8), HOPPER_W8(d, 16),
                   HOPPER_W8(d, 24)
                 : "l"(da), "l"(db), "r"(0), "n"(TA), "n"(TB));
}

template <int TA, int TB, bool ACC>
__device__ __forceinline__ void mma_ss_n16(float (&d)[8], uint64_t da,
                                           uint64_t db) {
  if constexpr (ACC)
    asm volatile(HOPPER_N16
                 : HOPPER_F8(d, 0)
                 : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  else
    asm volatile(HOPPER_N16
                 : HOPPER_W8(d, 0)
                 : "l"(da), "l"(db), "r"(0), "n"(TA), "n"(TB));
}

#undef HOPPER_N128
#undef HOPPER_N64
#undef HOPPER_N16
#undef HOPPER_W8

// d (64 x N) += A (64 x 16, registers, from acc_to_a) B (16 x N, shared)
template <int TB>
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}"
      : HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16), HOPPER_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void mma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "%14;\n}"
      : HOPPER_F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

#undef HOPPER_F8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x by the special-function unit (2 ulp; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// columns 16 k .. 16 k + 15 of a fp32 accumulator as the bf16 register A
// operand of one k16 step
template <int R>
__device__ __forceinline__ void acc_to_a(const float (&d)[R], int k,
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[8 * k + 0], d[8 * k + 1]);
  a[1] = pack_bf16(d[8 * k + 2], d[8 * k + 3]);
  a[2] = pack_bf16(d[8 * k + 4], d[8 * k + 5]);
  a[3] = pack_bf16(d[8 * k + 6], d[8 * k + 7]);
}

// ---------------------------------------------------------------- tiles

// A tile of `rows` rows of the padded head dim DP as TMA lays it down: the
// 64-column boxes one after the other, then the 16-column box if any.
template <int DP>
struct Tile {
  static constexpr int kBoxes = DP / 64;
  static constexpr int kRem = DP % 64;
  static_assert(kRem == 0 || kRem == 16, "head dim padded to 64 k (+ 16)");
  __host__ __device__ static constexpr uint32_t bytes(int rows) {
    return uint32_t(rows) * (kBoxes * 128 + kRem * 2);
  }
};

// every TMA box of one tile of a BTNH tensor (rows t0 .. t0 + rows - 1 of
// head h, batch b), all on one barrier
template <int DP>
__device__ __forceinline__ void load_btnh_tile(unsigned char* dst,
                                          const CUtensorMap* m,
                                          const CUtensorMap* m16,
                                          uint64_t* bar, int rows, int h,
                                          int t0, int b) {
#pragma unroll
  for (int i = 0; i < Tile<DP>::kBoxes; ++i)
    tma_load_4d(dst + i * rows * 128, m, bar, 64 * i, h, t0, b);
  if constexpr (Tile<DP>::kRem != 0)
    tma_load_4d(dst + Tile<DP>::kBoxes * rows * 128, m16, bar,
                64 * Tile<DP>::kBoxes, h, t0, b);
}

// ---------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda)
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D map over a contiguous (B, T, H, D) bf16 tensor, dimensions (D, H,
// T, B) innermost first, whose box is `cols` columns of one head at `rows`
// consecutive positions of one batch. Columns past D read as zero. Every
// global stride (2 D, 2 H D, 2 T H D bytes) must be a multiple of 16.
// Returns 0, or a cudaError_t value.
inline int btnh_map(CUtensorMap* map, const void* ptr, int B, int T, int H,
                    int D, int cols, int rows, CUtensorMapSwizzle sw) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return int(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(T),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * 2, cuuint64_t(H) * D * 2,
                                 cuuint64_t(T) * H * D * 2};
  const cuuint32_t box[4] = {cuuint32_t(cols), 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : int(cudaErrorInvalidValue);
}

}  // namespace hopper
