// Flash attention backward for Hopper (sm_90a): dQ, dK, dV of non-causal
// O = softmax(Q K^T * scale) V, given Q, K, V, O, dO and the forward's
// per-row log-sum-exp (flash_attn_fwd.cu writes it when training).
//
// Replaces the two Pallas TPU kernels that jax.grad runs through the library
// flash attention's custom VJP (jax/experimental/pallas/ops/tpu/
// flash_attention.py: _flash_attention_bwd_dkv and _flash_attention_bwd_dq),
// reached from prometheus_tpu/ops/attention.py::scaled_dot_product_attention
// in its flash branch. Layout is BTNH at the API: element (b, t, h, d) sits at
// ((b * T + t) * H + h) * D + d. Q, K, V, O, dO and the gradients are bf16;
// the log-sum-exp and the row sums D_i are fp32 (B, H, T); scores,
// probabilities and the accumulators are fp32. P and dS are rounded to bf16
// for the tensor-core products, as the forward rounds P.
//
// What bounds it on an H100: 10 B H T^2 D operations (recompute S, then dV,
// dP, dQ and dK) on 7 B T H D bf16 values read and written, e.g.
// (4, 1024, 16, 72) is 48 GFLOP against 66 MB: the tensor cores (989 TFLOP/s
// bf16), not device memory, set the floor.
//
// D <= 80 (72 on the path: the DiT), FlashAttention-2/3's backward in three
// launches on the caller's stream:
//   1. delta:  D_i = sum_d dO_id O_id, one warp per row;
//   2. main:   one block per (batch*head, 128-key tile), three warpgroups as
//              in the forward: a producer warpgroup (setmaxnreg 40) whose one
//              thread loads the block's K and V once and streams Q, dO, lse
//              and D_i for 64 query rows at a time by TMA into a 2-stage
//              ring; two consumer warpgroups (232 registers) own 64 keys
//              each. Per query tile, by wgmma into fp32 registers:
//              S^T = K Q^T, dP^T = V dO^T; P^T = exp2(S^T scale log2 e -
//              lse log2 e), dS^T = P^T (dP^T - D_i); dV += P^T dO and
//              dK += dS^T Q with P^T and dS^T as bf16 register A operands and
//              dO, Q read through the transpose bit (the accumulators stay in
//              registers, 2 x 40 a thread); dS^T goes to shared memory as
//              bf16 and each warpgroup's dQ partial, dS K over its 64 keys,
//              is added into an fp32 (B, H, T, D) scratch by one TMA bulk
//              reduce-add of its 64 x D tile;
//   3. convert: dQ = scratch * scale, cast to bf16 in BTNH.
// That spends 10 B H T^2 D operations, where the earlier design (a dK/dV
// kernel and a dQ kernel that recomputed S and dP) spent 14. Its price:
// dQ is a sum of fp32 partials whose order follows the order blocks run in,
// so dQ's last bits may differ from run to run (dK and dV do not).
// The head dim is cut as in the forward: a 64-column box (128-byte
// swizzle) and, at D = 72, a 16-column box (32-byte swizzle) whose columns
// 72..79 TMA fills with zeros. Shared memory: K, V 2 x 20 KB, Q and dO
// 2 stages x 2 x 10 KB, lse and D_i 1 KB, dS^T 2 x 8 KB, dQ staging
// 2 x 20 KB: 138 KB. Registers a consumer thread: S^T, dP^T 32 each, dV, dK
// 40 each, dQ 40, P and dS as bf16 16 each.
//
// D = 512 (the VAE decoder's mid block) cannot keep a key tile's dK and dV
// in registers: a 64-key tile's two 64 x 512 fp32 accumulators are 256 KB,
// the SM's whole register file. So it works in two phases with P and dS in
// device memory, each a wgmma kernel with the D <= 80 kernels' three
// warpgroups (a TMA producer, two consumers) and an mbarrier ring:
//   1. delta, as above;
//   2. scores: one block per (128 query rows, 128 keys, batch*head): S =
//      Q K^T and dP = dO V^T over the 512-column depth in 8 TMA steps of 64
//      columns (3-stage ring, 64 KB a stage), each consumer 64 query rows
//      x 128 keys of both (128 accumulator registers); the epilogue writes
//      P = exp2(S scale log2 e - lse log2 e) and dS = P (dP - D_i) as bf16
//      into (G, T, T) scratch;
//   3. grads: one batched GEMM kernel for dV = P^T dO, dK = scale dS^T Q
//      and dQ = scale dS K, one block per (128 output rows, product and 256
//      output columns, batch*head), each consumer 64 x 256 in registers
//      (four m64n64 accumulators), the T-deep reduction in 64-row TMA steps
//      (4-stage ring, 48 KB a stage); P^T and dS^T are the scratch tiles
//      read through wgmma's transpose bit, dO, Q and K MN-major as in the
//      D <= 80 kernel.
// 10 B H T^2 D operations, no atomics (so no gradient depends on the order
// blocks run in), and 2 x G x T^2 bf16 of scratch: 64 MB at the train step's
// (16, 1024, 1, 512), whose round trip (~128 MB) costs ~0.04 ms at 3.35
// TB/s against a 0.087 ms compute floor. The caller sizes G (batch*head
// pairs a group); larger calls run phases 2 and 3 group by group.
//
// D = 128 and 256 (the VAE mid blocks of width-scaled models) run the same
// two phases: phase 2 takes D / 64 TMA steps, and phase 3 writes 256 output
// columns a block at D = 256 and 128 (two m64n64 accumulators a consumer)
// at D = 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

// ------------------------------------------------------ the D_i pre-pass

constexpr int kWarps = 8;  // a delta block: one warp per row
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                       float* __restrict__ delta, int rows, int T, int H, int D) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;  // (b, t, h) order
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* po = o + size_t(row) * D;
  const bf16* pd = dout + size_t(row) * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32)
    s += __bfloat162float(po[c]) * __bfloat162float(pd[c]);
  s = warp_sum(s);
  if (lane == 0) {
    const int b = row / (T * H), t = (row / H) % T, h = row % H;
    delta[(size_t(b) * H + h) * T + t] = s;
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

// ---------------------------------------------------------------- D <= 80

constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kMainThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kBK = 128;                    // keys a block
constexpr int kBQ = 64;                     // query rows a step
constexpr int kStages = 2;

template <int DP>
struct MainLayout {
  using Tl = Tile<DP>;
  static constexpr uint32_t k = 0;
  static constexpr uint32_t v = k + Tl::bytes(kBK);
  static constexpr uint32_t q = v + Tl::bytes(kBK);
  static constexpr uint32_t dout = q + kStages * Tl::bytes(kBQ);
  static constexpr uint32_t ds = dout + kStages * Tl::bytes(kBQ);  // 2 x 64 x 64 bf16
  static constexpr uint32_t dq = ds + 2 * 64 * 64 * 2;               // 2 x 64 x DP fp32
  static constexpr uint32_t rows = dq + 2 * 64 * DP * 4;  // lse, D_i: stages x 2 x 64
  static constexpr uint32_t bar = rows + kStages * 2 * kBQ * 4;
  // kv_full, then q_full and q_empty per stage; + 1 KB to round the base
  // up to the 1024-byte swizzle atom
  static constexpr uint32_t bytes = bar + 8 * (1 + 2 * kStages) + 1024;
};

template <int DP>
__global__ void __launch_bounds__(kMainThreads, 1)
flash_bwd_main_kernel(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      const __grid_constant__ CUtensorMap mdo,
                      const __grid_constant__ CUtensorMap mq16,
                      const __grid_constant__ CUtensorMap mk16,
                      const __grid_constant__ CUtensorMap mv16,
                      const __grid_constant__ CUtensorMap mdo16,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dq_acc, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int T, int H, int D, float scale) {
  using L = MainLayout<DP>;
  using Tl = Tile<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* q_full = kv_full + 1;
  uint64_t* q_empty = q_full + kStages;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kBK;
  const int nq = T / kBQ;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(q_full + s, 1);
      mbar_init(q_empty + s, kConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: one thread issues every load
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(kv_full, 2 * Tl::bytes(kBK));
      load_btnh_tile<DP>(smem + L::k, &mk, &mk16, kv_full, kBK, h, k0, b);
      load_btnh_tile<DP>(smem + L::v, &mv, &mv16, kv_full, kBK, h, k0, b);
      for (int i = 0; i < nq; ++i) {
        const int s = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        const int q0 = i * kBQ;
        float* rows = reinterpret_cast<float*>(smem + L::rows) + s * 2 * kBQ;
        mbar_wait(q_empty + s, ph ^ 1);
        mbar_expect_tx(q_full + s, 2 * Tl::bytes(kBQ) + 2 * kBQ * 4);
        load_btnh_tile<DP>(smem + L::q + s * Tl::bytes(kBQ), &mq, &mq16,
                           q_full + s, kBQ, h, q0, b);
        load_btnh_tile<DP>(smem + L::dout + s * Tl::bytes(kBQ), &mdo, &mdo16,
                           q_full + s, kBQ, h, q0, b);
        bulk_load(rows, lse + size_t(bh) * T + q0, kBQ * 4, q_full + s);
        bulk_load(rows + kBQ, delta + size_t(bh) * T + q0, kBQ * 4, q_full + s);
      }
    }
  } else {
    // ---- consumer warpgroups: keys k0 + 64 w .. k0 + 64 w + 63
    reg_alloc<232>();
    const int w = threadIdx.x / 128, t = threadIdx.x % 128;
    const int r0 = 16 * (t / 32) + (t % 32) / 4, cq = 2 * (t % 4);
    constexpr bool kRem = Tl::kRem != 0;
    const float scale_log2 = scale * kLog2e;
    float dv1[32], dv2[8], dk1[32], dk2[8], st[32], dpt[32], dq1[32], dq2[8];
#pragma unroll
    for (int i = 0; i < 32; ++i) dv1[i] = dk1[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) dv2[i] = dk2[i] = 0.f;
    // this warpgroup's 64 keys: the A operand (K-major) of S^T and dP^T,
    // and the B operand (MN-major) of dQ, from the same tiles
    const uint64_t kd = desc(smem + L::k + w * 64 * 128, 16, 1024, kSw128);
    const uint64_t kd16 =
        desc(smem + L::k + Tl::kBoxes * kBK * 128 + w * 64 * 32, 16, 256, kSw32);
    const uint64_t vd = desc(smem + L::v + w * 64 * 128, 16, 1024, kSw128);
    const uint64_t vd16 =
        desc(smem + L::v + Tl::kBoxes * kBK * 128 + w * 64 * 32, 16, 256, kSw32);
    unsigned char* dss = smem + L::ds + w * 64 * 128;  // dS^T, 64 keys x 64 queries
    const uint64_t dsd = desc(dss, 16, 1024, kSw128);
    float* dqs = reinterpret_cast<float*>(smem + L::dq) + w * 64 * DP;
    mbar_wait(kv_full, 0);

    for (int i = 0; i < nq; ++i) {
      const int s = i % kStages;
      const uint32_t ph = (i / kStages) & 1;
      const int q0 = i * kBQ;
      unsigned char* qs = smem + L::q + s * Tl::bytes(kBQ);
      unsigned char* dos = smem + L::dout + s * Tl::bytes(kBQ);
      const float* lrow = reinterpret_cast<const float*>(smem + L::rows) + s * 2 * kBQ;
      const float* drow = lrow + kBQ;
      const uint64_t qd = desc(qs, 16, 1024, kSw128);
      const uint64_t qd16 = desc(qs + Tl::kBoxes * kBQ * 128, 16, 256, kSw32);
      const uint64_t dod = desc(dos, 16, 1024, kSw128);
      const uint64_t dod16 = desc(dos + Tl::kBoxes * kBQ * 128, 16, 256, kSw32);

      // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries)
      mbar_wait(q_full + s, ph);
      wgmma_fence();
      mma_ss_n64<0, 0, false>(st, kd, qd);
#pragma unroll
      for (int kk = 1; kk < 4; ++kk)
        mma_ss_n64<0, 0, true>(st, advance(kd, 32 * kk), advance(qd, 32 * kk));
      if constexpr (kRem) mma_ss_n64<0, 0, true>(st, kd16, qd16);
      mma_ss_n64<0, 0, false>(dpt, vd, dod);
#pragma unroll
      for (int kk = 1; kk < 4; ++kk)
        mma_ss_n64<0, 0, true>(dpt, advance(vd, 32 * kk), advance(dod, 32 * kk));
      if constexpr (kRem) mma_ss_n64<0, 0, true>(dpt, vd16, dod16);
      wgmma_commit();
      wgmma_wait();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T in place; column c of the tile is query q0 + c
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = 8 * (j / 4) + cq + (j % 2);
        const float p = fast_exp2(fmaf(st[j], scale_log2, -lrow[c] * kLog2e));
        st[j] = p;
        dpt[j] = p * (dpt[j] - drow[c]);
      }
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc_to_a(st, kk, pa[kk]);
        acc_to_a(dpt, kk, da[kk]);
      }

      // dV += P^T dO, dK += dS^T Q (dO and Q MN-major: 16 query rows a step)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma_rs_n64<1>(dv1, pa[kk], advance(dod, 2048 * kk));
        mma_rs_n64<1>(dk1, da[kk], advance(qd, 2048 * kk));
        if constexpr (kRem) {
          mma_rs_n16<1>(dv2, pa[kk], advance(dod16, 512 * kk));
          mma_rs_n16<1>(dk2, da[kk], advance(qd16, 512 * kk));
        }
      }
      wgmma_commit();

      // dS^T to shared memory in the 128-byte swizzle: key row r holds the
      // 64 queries, 16-byte chunk c at c ^ (r % 8). The values come from the
      // packed A operand, so the fp32 dS^T is dead by now.
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int r = r0 + 8 * ((j >> 1) & 1), c = 8 * (j / 4) + cq;
        *reinterpret_cast<uint32_t*>(dss + r * 128 + (((c / 8) ^ (r % 8)) * 16) +
                                     (c % 8) * 2) = da[j / 8][(j % 8) / 2];
      }
      fence_proxy_async();
      named_sync(1 + w, 128);

      // dQ partial (64 queries x DP) = dS K over this warpgroup's keys:
      // dS^T read MN-major is dS, K read MN-major
      wgmma_fence();
      mma_ss_n64<1, 1, false>(dq1, dsd, kd);
      if constexpr (kRem) mma_ss_n16<1, 1, false>(dq2, dsd, kd16);
#pragma unroll
      for (int kk = 1; kk < 4; ++kk) {
        mma_ss_n64<1, 1, true>(dq1, advance(dsd, 2048 * kk), advance(kd, 2048 * kk));
        if constexpr (kRem)
          mma_ss_n16<1, 1, true>(dq2, advance(dsd, 2048 * kk),
                                 advance(kd16, 512 * kk));
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(pa);
      fence_regs(da);
      fence_regs(dv1);
      fence_regs(dk1);
      fence_regs(dq1);
      fence_regs(dv2);
      fence_regs(dk2);
      fence_regs(dq2);
      mbar_arrive(q_empty + s);

      // stage the partial as 64 x D fp32 rows and add it into the scratch
      if (t == 0) bulk_wait_read();  // the last step's addition has read it
      named_sync(1 + w, 128);
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int r = r0 + 8 * ((j >> 1) & 1), c = 8 * (j / 4) + cq;
        if (c < D)
          *reinterpret_cast<float2*>(dqs + r * D + c) = make_float2(dq1[j], dq1[j + 1]);
      }
      if constexpr (kRem) {
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          const int r = r0 + 8 * ((j >> 1) & 1), c = 64 + 8 * (j / 4) + cq;
          if (c < D)
            *reinterpret_cast<float2*>(dqs + r * D + c) = make_float2(dq2[j], dq2[j + 1]);
        }
      }
      fence_proxy_async();
      named_sync(1 + w, 128);
      if (t == 0) {
        bulk_reduce_add_f32(dq_acc + (size_t(bh) * T + q0) * D, dqs, kBQ * D * 4);
        bulk_commit();
      }
    }
    if (t == 0) bulk_wait();

    // dK (times the scale) and dV rows of this warpgroup's keys
    const size_t row_stride = size_t(H) * D;
    const size_t base = (size_t(b) * T * H + h) * D;  // element (b, 0, h, 0)
    const int ka = k0 + 64 * w + r0;
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int r = (j >> 1) & 1, c = 8 * (j / 4) + cq;
      const size_t at = base + size_t(ka + 8 * r) * row_stride + c;
      if (c < D) {
        *reinterpret_cast<uint32_t*>(dk + at) = pack_bf16(dk1[j] * scale, dk1[j + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(dv1[j], dv1[j + 1]);
      }
    }
    if constexpr (kRem) {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const int r = (j >> 1) & 1, c = 64 + 8 * (j / 4) + cq;
        const size_t at = base + size_t(ka + 8 * r) * row_stride + c;
        if (c < D) {
          *reinterpret_cast<uint32_t*>(dk + at) = pack_bf16(dk2[j] * scale, dk2[j + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(dv2[j], dv2[j + 1]);
        }
      }
    }
  }
}

// dq (B, T, H, D) bf16 = scale * the (B, H, T, D) fp32 scratch, two values
// a thread
__global__ void flash_bwd_dq_convert_kernel(const float* __restrict__ acc,
                                            bf16* __restrict__ dq, size_t pairs,
                                            int T, int H, int D, float scale) {
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const size_t e = 2 * i, row = e / D;  // row in (b, t, h) order
  const int d = int(e % D);
  const size_t b = row / (size_t(T) * H);
  const int t = int((row / H) % T), h = int(row % H);
  const float2 x = *reinterpret_cast<const float2*>(
      acc + ((b * H + h) * T + t) * D + d);
  *reinterpret_cast<uint32_t*>(dq + e) = pack_bf16(x.x * scale, x.y * scale);
}

cudaError_t launch_delta(const bf16* o, const bf16* dout, float* delta, int B,
                         int T, int H, int D, cudaStream_t s) {
  const int rows = B * T * H;
  flash_bwd_delta_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      o, dout, delta, rows, T, H, D);
  return cudaGetLastError();
}

template <int DP>
int launch_main(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                const float* lse, const bf16* dout, float* delta, float* dq_acc,
                bf16* dq, bf16* dk, bf16* dv, int B, int T, int H, int D,
                float scale, cudaStream_t s) {
  using L = MainLayout<DP>;
  if (T % kBK != 0 || dq_acc == nullptr) return int(cudaErrorInvalidValue);
  cudaError_t err = launch_delta(o, dout, delta, B, T, H, D, s);
  if (err != cudaSuccess) return int(err);
  // maps of q, k, v, dO over 64-column boxes, then over the 16-column box
  // (copies of the first four where the head dim has none)
  CUtensorMap maps[8];
  const bf16* src[4] = {q, k, v, dout};
  const int rows[4] = {kBQ, kBK, kBK, kBQ};
  for (int i = 0; i < 4; ++i) {
    int e = btnh_map(&maps[i], src[i], B, T, H, D, 64, rows[i],
                     CU_TENSOR_MAP_SWIZZLE_128B);
    if (e == 0 && Tile<DP>::kRem != 0)
      e = btnh_map(&maps[4 + i], src[i], B, T, H, D, 16, rows[i],
                   CU_TENSOR_MAP_SWIZZLE_32B);
    else
      maps[4 + i] = maps[i];
    if (e != 0) return e;
  }
  auto kern = flash_bwd_main_kernel<DP>;
  if ((err = prepare(kern, L::bytes)) != cudaSuccess) return int(err);
  kern<<<dim3(T / kBK, B * H), kMainThreads, L::bytes, s>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7],
      lse, delta, dq_acc, dk, dv, T, H, D, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const size_t pairs = size_t(B) * T * H * D / 2;
  flash_bwd_dq_convert_kernel<<<unsigned((pairs + 255) / 256), 256, 0, s>>>(
      dq_acc, dq, pairs, T, H, D, scale);
  return int(cudaGetLastError());
}

// ------------------------------------------------------ D = 128, 256, 512

constexpr int kT = 128;             // query rows and keys of a score tile
constexpr uint32_t kBox = 64 * 128;  // bytes of a 64-row, 64-column box

// Phase 1 stage: 64 columns of the depth of Q and dO (the tile's 128 query
// rows) and of K and V (its 128 keys), 16 KB each
struct ScoreLayout {
  static constexpr int kStages = 3;
  static constexpr uint32_t q = 0, k = 2 * kBox, dout = 4 * kBox, v = 6 * kBox;
  static constexpr uint32_t stage = 8 * kBox;
  static constexpr uint32_t bar = kStages * stage;                 // 192 KB
  static constexpr uint32_t bytes = bar + 8 * 2 * kStages + 1024;  // + swizzle round-up
};

// Phase 2 stage: 64 rows of the reduction of the A operand (two 64 x 64
// boxes of the P or dS scratch) and of the B operand (NB 64-column boxes of
// dO, Q or K: 64 NB output columns)
template <int NB>
struct GradLayout {
  static constexpr int kStages = 4;
  static constexpr uint32_t a = 0, b = 2 * kBox;
  static constexpr uint32_t stage = (2 + NB) * kBox;
  static constexpr uint32_t bar = kStages * stage;                 // 192 KB at NB = 4
  static constexpr uint32_t bytes = bar + 8 * 2 * kStages + 1024;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

// S += Q K^T and dP += dO V^T over the 64 columns of one stage, for this
// warpgroup's 64 query rows and the tile's 128 keys
template <bool ACC>
__device__ __forceinline__ void score_step(float (&sc)[64], float (&dp)[64],
                                           const unsigned char* st, int w) {
  using L = ScoreLayout;
  const uint64_t qd = desc(st + L::q + w * kBox, 16, 1024, kSw128);
  const uint64_t kd = desc(st + L::k, 16, 1024, kSw128);
  const uint64_t dod = desc(st + L::dout + w * kBox, 16, 1024, kSw128);
  const uint64_t vd = desc(st + L::v, 16, 1024, kSw128);
  mma_ss_n128<0, 0, ACC>(sc, qd, kd);
  mma_ss_n128<0, 0, ACC>(dp, dod, vd);
#pragma unroll
  for (int kk = 1; kk < 4; ++kk) {
    mma_ss_n128<0, 0, true>(sc, advance(qd, 32 * kk), advance(kd, 32 * kk));
    mma_ss_n128<0, 0, true>(dp, advance(dod, 32 * kk), advance(vd, 32 * kk));
  }
}

// Phase 1: one block per (128 keys, 128 query rows, batch*head of the
// group). S = Q K^T and dP = dO V^T by wgmma over the D-column depth in
// D / 64 TMA steps of 64 columns; the epilogue writes P = exp2(S scale log2
// e - lse log2 e) and dS = P (dP - D_i) as bf16 rows (query, key) of the
// group's (G, T, T) scratch.
template <int D>
__global__ void __launch_bounds__(kMainThreads, 1)
flash_bwd512_scores_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           const __grid_constant__ CUtensorMap mdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta, bf16* __restrict__ p_out,
                           bf16* __restrict__ ds_out, int T, int H, int bh0,
                           float scale_log2) {
  using L = ScoreLayout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* empty = full + L::kStages;
  const int k0 = blockIdx.x * kT, q0 = blockIdx.y * kT, g = blockIdx.z;
  const int bh = bh0 + g, b = bh / H, h = bh % H;
  constexpr int kSteps = D / 64;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: one thread issues every load
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      for (int i = 0; i < kSteps; ++i) {
        const int s = i % L::kStages;
        unsigned char* st = smem + s * L::stage;
        mbar_wait(empty + s, ((i / L::kStages) & 1) ^ 1);
        mbar_expect_tx(full + s, L::stage);
        tma_load_4d(st + L::q, &mq, full + s, 64 * i, h, q0, b);
        tma_load_4d(st + L::k, &mk, full + s, 64 * i, h, k0, b);
        tma_load_4d(st + L::dout, &mdo, full + s, 64 * i, h, q0, b);
        tma_load_4d(st + L::v, &mv, full + s, 64 * i, h, k0, b);
      }
    }
  } else {
    // ---- consumer warpgroups: query rows q0 + 64 w .. q0 + 64 w + 63
    reg_alloc<232>();
    const int w = threadIdx.x / 128, t = threadIdx.x % 128;
    const int r0 = 16 * (t / 32) + (t % 32) / 4, cq = 2 * (t % 4);
    float sc[64], dp[64];
    mbar_wait(full, 0);
    wgmma_fence();
    score_step<false>(sc, dp, smem, w);
    wgmma_commit();
    for (int i = 1; i < kSteps; ++i) {
      const int s = i % L::kStages;
      mbar_wait(full + s, (i / L::kStages) & 1);
      wgmma_fence();
      score_step<true>(sc, dp, smem + s * L::stage, w);
      wgmma_commit();
      wgmma_wait<1>();  // the step before is done: its stage is free
      mbar_arrive(empty + (i - 1) % L::kStages);
    }
    wgmma_wait();
    fence_regs(sc);
    fence_regs(dp);

    const int qa = q0 + 64 * w + r0;  // rows qa and qa + 8
    float l2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l2[r] = lse[size_t(bh) * T + qa + 8 * r] * kLog2e;
      dl[r] = delta[size_t(bh) * T + qa + 8 * r];
    }
    const size_t row = (size_t(g) * T + qa) * T + k0;
#pragma unroll
    for (int j = 0; j < 64; j += 2) {
      const int r = (j >> 1) & 1, c = 8 * (j / 4) + cq;
      const float p0 = fast_exp2(fmaf(sc[j], scale_log2, -l2[r]));
      const float p1 = fast_exp2(fmaf(sc[j + 1], scale_log2, -l2[r]));
      const size_t at = row + size_t(8 * r) * T + c;
      *reinterpret_cast<uint32_t*>(p_out + at) = pack_bf16(p0, p1);
      *reinterpret_cast<uint32_t*>(ds_out + at) =
          pack_bf16(p0 * (dp[j] - dl[r]), p1 * (dp[j + 1] - dl[r]));
    }
  }
}

// acc (64 x 64 NB) += A (64 x 64) B (64 x 64 NB) over one stage: A is this
// warpgroup's box of the stage, K-major (TA = 0: dS rows, for dQ) or
// MN-major (TA = 1: P or dS read as P^T or dS^T, for dV and dK); B is NB
// MN-major 64-column boxes
template <int NB, int TA, bool ACC>
__device__ __forceinline__ void grad_step(float (&acc)[NB][32], const unsigned char* st,
                                          int w) {
  using L = GradLayout<NB>;
  const uint64_t ad = desc(st + L::a + w * kBox, 16, 1024, kSw128);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t a = advance(ad, TA ? 2048 * kk : 32 * kk);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const uint64_t bd = advance(desc(st + L::b + n * kBox, 16, 1024, kSw128), 2048 * kk);
      if (ACC || kk > 0)
        mma_ss_n64<TA, 1, true>(acc[n], a, bd);
      else
        mma_ss_n64<TA, 1, false>(acc[n], a, bd);
    }
  }
}

template <int NB, int TA>
__device__ __forceinline__ void grad_mainloop(float (&acc)[NB][32], unsigned char* smem,
                                              uint64_t* full, uint64_t* empty, int steps,
                                              int w) {
  using L = GradLayout<NB>;
  mbar_wait(full, 0);
  wgmma_fence();
  grad_step<NB, TA, false>(acc, smem, w);
  wgmma_commit();
  for (int i = 1; i < steps; ++i) {
    const int s = i % L::kStages;
    mbar_wait(full + s, (i / L::kStages) & 1);
    wgmma_fence();
    grad_step<NB, TA, true>(acc, smem + s * L::stage, w);
    wgmma_commit();
    wgmma_wait<1>();  // the step before is done: its stage is free
    mbar_arrive(empty + (i - 1) % L::kStages);
  }
  wgmma_wait();
#pragma unroll
  for (int n = 0; n < NB; ++n) fence_regs(acc[n]);
}

// Phase 2: one block per (128 output rows, product and 64 NB output
// columns, batch*head of the group), one batched GEMM for three products:
//   dV = P^T dO, dK = scale dS^T Q (rows: keys), dQ = scale dS K (rows:
//   queries),
// each 128 x 64 NB of (T x D) with a T-deep reduction in 64-row TMA steps;
// the transposed scratch operands are read through wgmma's transpose bit.
// Writes bf16 in BTNH.
template <int D, int NB>
__global__ void __launch_bounds__(kMainThreads, 1)
flash_bwd512_grads_kernel(const __grid_constant__ CUtensorMap mp,
                          const __grid_constant__ CUtensorMap mds,
                          const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mdo,
                          bf16* __restrict__ dq, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int T, int H, int bh0, float scale) {
  using L = GradLayout<NB>;
  constexpr int kParts = D / (64 * NB);  // blocks of output columns a product
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* empty = full + L::kStages;
  const int m0 = blockIdx.x * kT, which = blockIdx.y / kParts;
  const int n0 = (blockIdx.y % kParts) * 64 * NB;
  const int g = blockIdx.z, bh = bh0 + g, b = bh / H, h = bh % H;
  const int steps = T / 64;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      const CUtensorMap* ma = which == 0 ? &mp : &mds;
      const CUtensorMap* mb = which == 0 ? &mdo : which == 1 ? &mq : &mk;
      for (int i = 0; i < steps; ++i) {
        const int s = i % L::kStages, r0 = 64 * i;
        unsigned char* st = smem + s * L::stage;
        mbar_wait(empty + s, ((i / L::kStages) & 1) ^ 1);
        mbar_expect_tx(full + s, L::stage);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // dV, dK: scratch rows (queries) r0.., columns (keys) m0 + 64 j..;
          // dQ: scratch rows (queries) m0 + 64 j.., columns (keys) r0..
          if (which < 2)
            tma_load_4d(st + L::a + j * kBox, ma, full + s, m0 + 64 * j, 0, r0, g);
          else
            tma_load_4d(st + L::a + j * kBox, ma, full + s, r0, 0, m0 + 64 * j, g);
        }
#pragma unroll
        for (int n = 0; n < NB; ++n)
          tma_load_4d(st + L::b + n * kBox, mb, full + s, n0 + 64 * n, h, r0, b);
      }
    }
  } else {
    reg_alloc<232>();
    const int w = threadIdx.x / 128, t = threadIdx.x % 128;
    const int r0 = 16 * (t / 32) + (t % 32) / 4, cq = 2 * (t % 4);
    float acc[NB][32];
    if (which < 2)
      grad_mainloop<NB, 1>(acc, smem, full, empty, steps, w);
    else
      grad_mainloop<NB, 0>(acc, smem, full, empty, steps, w);
    bf16* out = which == 0 ? dv : which == 1 ? dk : dq;
    const float f = which == 0 ? 1.f : scale;
    const size_t row_stride = size_t(H) * D;
    bf16* row = out + (size_t(b) * T * H + h) * D + size_t(m0 + 64 * w + r0) * row_stride + n0;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int r = (j >> 1) & 1, c = 64 * n + 8 * (j / 4) + cq;
        *reinterpret_cast<uint32_t*>(row + 8 * r * row_stride + c) =
            pack_bf16(acc[n][j] * f, acc[n][j + 1] * f);
      }
  }
}

// D = 128, 256 or 512 in groups of `group` batch*head pairs: the D_i
// pre-pass, then per group phase 1 into the bf16 scratch (P, then dS: 2 x
// group x T x T) and phase 2 out of it.
template <int D>
int launch_512(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
               const float* lse, const bf16* dout, float* delta, bf16* scratch,
               bf16* dq, bf16* dk, bf16* dv, int B, int T, int H, int group,
               float scale, cudaStream_t s) {
  constexpr int NB = D < 256 ? D / 64 : 4;  // 64-column boxes a phase-2 block
  auto scores = flash_bwd512_scores_kernel<D>;
  auto grads = flash_bwd512_grads_kernel<D, NB>;
  if (T % kT != 0 || scratch == nullptr || group <= 0) return int(cudaErrorInvalidValue);
  cudaError_t err = launch_delta(o, dout, delta, B, T, H, D, s);
  if (err != cudaSuccess) return int(err);
  // phase 1 reads 128-row boxes of q, k, v, dO; phase 2 64-row boxes of q,
  // k, dO and 64 x 64 boxes of the scratch, mapped as (group, T, 1, T)
  CUtensorMap m1[4], m2[3], ms[2];
  const bf16* src1[4] = {q, k, v, dout};
  const bf16* src2[3] = {q, k, dout};
  for (int i = 0; i < 4; ++i) {
    const int e = btnh_map(&m1[i], src1[i], B, T, H, D, 64, kT, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != 0) return e;
  }
  for (int i = 0; i < 3; ++i) {
    const int e = btnh_map(&m2[i], src2[i], B, T, H, D, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != 0) return e;
  }
  bf16* p_scr = scratch;
  bf16* ds_scr = scratch + size_t(group) * T * T;
  for (int i = 0; i < 2; ++i) {
    const int e = btnh_map(&ms[i], i ? ds_scr : p_scr, group, T, 1, T, 64, 64,
                           CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != 0) return e;
  }
  if ((err = prepare(scores, ScoreLayout::bytes)) != cudaSuccess ||
      (err = prepare(grads, GradLayout<NB>::bytes)) != cudaSuccess)
    return int(err);
  const float scale_log2 = scale * kLog2e;
  for (int bh0 = 0; bh0 < B * H; bh0 += group) {
    const int n = B * H - bh0 < group ? B * H - bh0 : group;
    scores<<<dim3(T / kT, T / kT, n), kMainThreads, ScoreLayout::bytes, s>>>(
        m1[0], m1[1], m1[2], m1[3], lse, delta, p_scr, ds_scr, T, H, bh0, scale_log2);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
    grads<<<dim3(T / kT, 3 * (D / (64 * NB)), n), kMainThreads, GradLayout<NB>::bytes, s>>>(
        ms[0], ms[1], m2[0], m2[1], m2[2], dq, dk, dv, T, H, bh0, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  return 0;
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: contiguous (B, T, H, D) bf16 on the device,
// 16-byte aligned; lse: (B, H, T) fp32 from flash_attn_fwd; delta: (B, H, T)
// fp32 scratch. D % 8 == 0 and D <= 80: scratch is a (B, H, T, D) fp32 dQ
// sum filled with zeros and group is unused; D is 128, 256 or 512: scratch holds 2 x
// group x T x T bf16 (P and dS of `group` batch*head pairs at a time, 1 <=
// group). T % 128 == 0. Returns cudaGetLastError() after the last launch (0
// on success).
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* lse, const void* dout,
                              void* delta, void* scratch, void* dq, void* dk,
                              void* dv, int B, int T, int H, int D, int group,
                              float scale, void* stream) {
  if (D <= 0 || D % 8 != 0 || (D > 80 && D != 128 && D != 256 && D != 512))
    return int(cudaErrorInvalidValue);
  auto c = [](const void* p) { return static_cast<const bf16*>(p); };
  auto m = [](void* p) { return static_cast<bf16*>(p); };
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* acc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_main<64>(c(q), c(k), c(v), c(o), l, c(dout), dl, acc, m(dq),
                           m(dk), m(dv), B, T, H, D, scale, s);
  if (D <= 80)
    return launch_main<80>(c(q), c(k), c(v), c(o), l, c(dout), dl, acc, m(dq),
                           m(dk), m(dv), B, T, H, D, scale, s);
  if (D == 128)
    return launch_512<128>(c(q), c(k), c(v), c(o), l, c(dout), dl, m(scratch), m(dq),
                           m(dk), m(dv), B, T, H, group, scale, s);
  if (D == 256)
    return launch_512<256>(c(q), c(k), c(v), c(o), l, c(dout), dl, m(scratch), m(dq),
                           m(dk), m(dv), B, T, H, group, scale, s);
  return launch_512<512>(c(q), c(k), c(v), c(o), l, c(dout), dl, m(scratch), m(dq),
                         m(dk), m(dv), B, T, H, group, scale, s);
}
