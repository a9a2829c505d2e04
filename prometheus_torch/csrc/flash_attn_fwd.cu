// Flash attention forward for Hopper (sm_90a): non-causal softmax(Q K^T / sqrt(D)) V.
//
// Replaces the Pallas TPU flash attention that
// prometheus_tpu/ops/attention.py::scaled_dot_product_attention reaches in its
// flash branch (jax.experimental.pallas.ops.tpu.flash_attention, block sizes
// from _block_sizes). Layout is BTNH at the API: element (b, t, h, d) sits at
// ((b * T + t) * H + h) * D + d. Inputs and output are bf16; scores, the
// running max / sum and the output accumulator are fp32.
//
// What bounds it on an H100: at the path's shapes the work is 4*B*H*T^2*D
// operations on 4*B*T*H*D*2 bytes, e.g. (B=2, T=2048, H=10, D=64) is 21.5
// GFLOP against 21 MB, so the tensor cores (989 TFLOP/s bf16) and not the
// 3.35 TB/s of device memory set the floor (22 us vs 6 us). Reaching the
// tensor cores' rate needs wgmma with its accumulators in registers, operands
// that arrive by TMA while the previous tile is multiplied, and no trip of a
// score or the output through shared memory. That is this design
// (FlashAttention-3's shape):
//
// - One block per (batch*head, query tile), three warpgroups. The producer
//   warpgroup gives its registers up (setmaxnreg 40) and one of its threads
//   issues every TMA load: the query tile once, then K and V tiles into a
//   ring of STAGES slots with full / empty mbarriers, K and V on barriers of
//   their own so that the next K arrives while this tile's P V runs. The two
//   consumer warpgroups take 232 registers each.
// - S = Q K^T by wgmma from swizzled shared memory into fp32 registers; the
//   online softmax runs in base 2 on the accumulator layout (row max and
//   sum over the 4 threads of a row by shuffles, the row sum kept per thread
//   and summed once at the end); P goes to bf16 in registers and is the
//   register A operand of O += P V, with V read through wgmma's transpose
//   bit. O stays in registers for the whole K/V walk. At D <= 80 the
//   softmax of tile j runs while the tensor cores multiply P V of tile
//   j - 1 (S of tile j is issued first, then that product), and the two
//   consumer warpgroups take turns to issue their products (named
//   barriers), so that one's softmax meets the other's products.
// - D <= 80 (64 on the U-Net, 72 on the DiT): 128 query rows, 64 per
//   consumer warpgroup, 128-row K/V tiles in 2 stages. A 72-wide row (144
//   bytes) is wider than the 128-byte swizzle span, so the head dim is cut
//   into a 64-column box (128-byte swizzle) and a 16-column box (32-byte
//   swizzle) whose columns 72..79 TMA fills with zeros: one extra k16 step
//   of Q K^T and an N = 16 product for P V, against 44% wasted depth if the
//   head dim were padded to 128. Shared memory: Q 20 KB, K and V 2 x 20 KB
//   each, 100 KB; registers: O 40, S 64, P 32 a thread.
// - D = 512 (VAE mid blocks): a 64 x 512 fp32 accumulator would take 256
//   registers a thread, so the two consumer warpgroups split the output
//   columns (256 each, 128 registers a thread) and the head dim of S: each
//   computes S over its 256 columns, the two partial 64 x 64 score tiles
//   meet in shared memory (32 KB, two named-barrier syncs a tile) and each
//   warpgroup runs the same softmax on their sum. 64 query rows, 64-row K/V
//   tiles in one stage each: Q 64 KB + K 64 KB + V 64 KB + 32 KB = 224 KB
//   of the 227 KB a block may use.
// - D = 128 and 256 (the VAE mid blocks of width-scaled models) take the
//   D = 512 design with D / 2 output columns a warpgroup: the column split
//   keeps the accumulator and the softmax as they are at every one of the
//   three widths. Shared memory: Q, K, V 3 x 16 KB a 64-column box, + 32
//   KB: 128 KB at 256, 80 KB at 128.
//
// For training the kernel also writes each query row's log-sum-exp of the
// scaled scores, fp32 (B, H, T) in natural-log units, which the backward
// (flash_attn_bwd.cu) uses to recompute the probabilities; inference passes
// a null pointer and writes nothing more.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One online-softmax step on a 64 x N score accumulator: rows r0 (m[0],
// l[0]) and r1 (m[1], l[1]) of this thread. The scores become unnormalised
// probabilities in place; corr[] is what the output must be scaled by.
template <int R>
__device__ __forceinline__ void softmax_step(float (&sc)[R], float (&m)[2],
                                             float (&l)[2], float scale_log2,
                                             float (&corr)[2]) {
  float x[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < R; ++i) x[(i >> 1) & 1] = fmaxf(x[(i >> 1) & 1], sc[i]);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(x[r]) * scale_log2);
    corr[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -m[r]));
    sum[r] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
}

template <int R>
__device__ __forceinline__ void rescale(float (&o)[R], const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < R; ++i) o[i] *= corr[(i >> 1) & 1];
}

// rows r0, r1 of a 64 x N accumulator, divided by the row sums, into
// columns col0.. of the bf16 output rows (columns at or past D dropped)
template <int R>
__device__ __forceinline__ void store_rows(const float (&acc)[R], bf16* row0,
                                           bf16* row1, int col0, int D,
                                           const float (&inv)[2]) {
  const int cq = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int i = 0; i < R; i += 2) {
    const int col = col0 + 8 * (i / 4) + cq;
    const int r = (i >> 1) & 1;
    if (col < D)
      *reinterpret_cast<uint32_t*>((r ? row1 : row0) + col) =
          pack_bf16(acc[i] * inv[r], acc[i + 1] * inv[r]);
  }
}

template <int DP, int BQ, int BK, int STAGES, bool COLS>
struct FwdLayout {
  static constexpr uint32_t q = 0;
  static constexpr uint32_t k = q + Tile<DP>::bytes(BQ);
  static constexpr uint32_t v = k + STAGES * Tile<DP>::bytes(BK);
  static constexpr uint32_t x = v + STAGES * Tile<DP>::bytes(BK);
  static constexpr uint32_t bar = x + (COLS ? 2 * 64 * BK * 4 : 0);
  // q_full, then k_full, k_empty, v_full, v_empty per stage; + 1 KB so the
  // base can be rounded up to the 1024-byte swizzle atom
  static constexpr uint32_t bytes = bar + 8 * (1 + 4 * STAGES) + 1024;
};

template <int DP, int BQ, int BK, int STAGES, bool COLS>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv,
                 const __grid_constant__ CUtensorMap mq16,
                 const __grid_constant__ CUtensorMap mk16,
                 const __grid_constant__ CUtensorMap mv16,
                 bf16* __restrict__ o, float* __restrict__ lse, int T, int H,
                 int D, float scale_log2) {
  using L = FwdLayout<DP, BQ, BK, STAGES, COLS>;
  using Tl = Tile<DP>;
  static_assert(!COLS || ((DP == 128 || DP == 256 || DP == 512) && BQ == 64),
                "column split is for D = 128, 256 and 512");
  static_assert(COLS || BQ == 128, "row split: 64 query rows per warpgroup");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + STAGES;
  uint64_t* v_full = k_empty + STAGES;
  uint64_t* v_empty = v_full + STAGES;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int nk = T / BK;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(k_empty + s, kConsumers);
      mbar_init(v_full + s, 1);
      mbar_init(v_empty + s, kConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: one thread issues every load
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, Tl::bytes(BQ));
      load_btnh_tile<DP>(smem + L::q, &mq, &mq16, q_full, BQ, h, q0, b);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        const uint32_t ph = (kt / STAGES) & 1;
        mbar_wait(k_empty + s, ph ^ 1);
        mbar_expect_tx(k_full + s, Tl::bytes(BK));
        load_btnh_tile<DP>(smem + L::k + s * Tl::bytes(BK), &mk, &mk16, k_full + s,
                      BK, h, kt * BK, b);
        mbar_wait(v_empty + s, ph ^ 1);
        mbar_expect_tx(v_full + s, Tl::bytes(BK));
        load_btnh_tile<DP>(smem + L::v + s * Tl::bytes(BK), &mv, &mv16, v_full + s,
                      BK, h, kt * BK, b);
      }
    }
  } else {
    // ---- consumer warpgroups
    reg_alloc<232>();
    const int w = threadIdx.x / 128, t = threadIdx.x % 128;
    const int r0 = 16 * (t / 32) + (t % 32) / 4;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
    const size_t row_stride = size_t(H) * D;
    bf16* ob = o + (size_t(b) * T * H + h) * D;  // element (b, 0, h, 0)
    unsigned char* qs = smem + L::q;
    mbar_wait(q_full, 0);

    if constexpr (!COLS) {
      // rows 64 w .. 64 w + 63 of the query tile, all DP columns
      constexpr int NS = BK / 16;  // k16 steps of P V
      float o1[32], o2[8], sc[BK / 2];
#pragma unroll
      for (int i = 0; i < 32; ++i) o1[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) o2[i] = 0.f;
      const uint64_t qd = desc(qs + w * 64 * 128, 16, 1024, kSw128);
      const uint64_t qd16 =
          desc(qs + Tl::kBoxes * BQ * 128 + w * 64 * 32, 16, 256, kSw32);
      uint32_t pa[NS][4];
      // S = Q K^T of tile kt into sc, one commit group
      auto issue_s = [&](int kt) {
        const int s = kt % STAGES;
        unsigned char* ks = smem + L::k + s * Tl::bytes(BK);
        mbar_wait(k_full + s, (kt / STAGES) & 1);
        wgmma_fence();
        const uint64_t kd = desc(ks, 16, 1024, kSw128);
        mma_ss_n128<0, 0, false>(sc, qd, kd);
#pragma unroll
        for (int kk = 1; kk < 4; ++kk)
          mma_ss_n128<0, 0, true>(sc, advance(qd, 32 * kk), advance(kd, 32 * kk));
        if constexpr (Tl::kRem != 0)
          mma_ss_n128<0, 0, true>(
              sc, qd16, desc(ks + Tl::kBoxes * BK * 128, 16, 256, kSw32));
        wgmma_commit();
      };
      // O += P V of tile kt, P from pa, one commit group
      auto issue_pv = [&](int kt) {
        const int s = kt % STAGES;
        unsigned char* vs = smem + L::v + s * Tl::bytes(BK);
        mbar_wait(v_full + s, (kt / STAGES) & 1);
        wgmma_fence();
        const uint64_t vd = desc(vs, 16, 1024, kSw128);
        const uint64_t vd16 = desc(vs + Tl::kBoxes * BK * 128, 16, 256, kSw32);
#pragma unroll
        for (int kk = 0; kk < NS; ++kk) {
          mma_rs_n64<1>(o1, pa[kk], advance(vd, 2048 * kk));
          if constexpr (Tl::kRem != 0)
            mma_rs_n16<1>(o2, pa[kk], advance(vd16, 512 * kk));
        }
        wgmma_commit();
      };

      // The two warpgroups take turns to issue their products (named
      // barriers 2 + w, FlashAttention-3's ping-pong), so that one's
      // softmax runs while the other's products hold the tensor cores; the
      // first turn is warpgroup 0's. Every issue below is one turn.
      const int turns = nk + 1;
      int turn = 0;
      auto take_turn = [&]() { named_sync(2 + w, kConsumers); };
      auto pass_turn = [&]() {
        // the last turn of warpgroup 1 has no one to pass to
        if (w == 0 || ++turn < turns) named_arrive(2 + (1 - w), kConsumers);
      };
      if (w == 1) named_arrive(2, kConsumers);

      // FlashAttention-3's overlap inside the warpgroup: while the tensor
      // cores run P V of tile kt - 1, the softmax of tile kt runs; O is
      // rescaled once that product is in
      take_turn();
      issue_s(0);
      pass_turn();
      wgmma_wait();
      fence_regs(sc);
      mbar_arrive(k_empty);
      softmax_step(sc, m, l, scale_log2, corr);
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) acc_to_a(sc, kk, pa[kk]);
      for (int kt = 1; kt < nk; ++kt) {
        take_turn();
        issue_s(kt);
        issue_pv(kt - 1);
        pass_turn();
        wgmma_wait<1>();  // S of tile kt is in
        fence_regs(sc);
        mbar_arrive(k_empty + kt % STAGES);
        softmax_step(sc, m, l, scale_log2, corr);
        wgmma_wait();  // P V of tile kt - 1 is in
        fence_regs(o1);
        fence_regs(o2);
        fence_regs(pa);
        mbar_arrive(v_empty + (kt - 1) % STAGES);
        rescale(o1, corr);
        if constexpr (Tl::kRem != 0) rescale(o2, corr);
#pragma unroll
        for (int kk = 0; kk < NS; ++kk) acc_to_a(sc, kk, pa[kk]);
      }
      take_turn();
      issue_pv(nk - 1);
      pass_turn();
      wgmma_wait();
      fence_regs(o1);
      fence_regs(o2);
      mbar_arrive(v_empty + (nk - 1) % STAGES);
      const int qa = q0 + 64 * w + r0;
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = quad_sum(l[r]);
        inv[r] = 1.f / l[r];
      }
      bf16* row0 = ob + size_t(qa) * row_stride;
      bf16* row1 = ob + size_t(qa + 8) * row_stride;
      store_rows(o1, row0, row1, 0, D, inv);
      if constexpr (Tl::kRem != 0) store_rows(o2, row0, row1, 64, D, inv);
      if (lse != nullptr && t % 4 == 0) {
        // softmax = exp2(s * scale_log2 - (m + log2 l)); natural log for the API
        lse[size_t(bh) * T + qa] = (m[0] + log2f(l[0])) * 0.6931471805599453f;
        lse[size_t(bh) * T + qa + 8] = (m[1] + log2f(l[1])) * 0.6931471805599453f;
      }
    } else {
      // all 64 query rows, output columns DP / 2 w .. DP / 2 (w + 1) - 1
      // (boxes NB w .. NB w + NB - 1); S over the same columns, summed with
      // the other half's
      constexpr uint32_t kBox = 64 * 128;  // one 64-row, 64-column box
      constexpr int NB = DP / 128;         // boxes a warpgroup
      float acc[NB][32], sc[32];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;
      float* xs = reinterpret_cast<float*>(smem + L::x);
      const uint64_t qd = desc(qs + NB * w * kBox, 16, 1024, kSw128);
      for (int kt = 0; kt < nk; ++kt) {
        unsigned char* ks = smem + L::k;
        unsigned char* vs = smem + L::v;
        const uint32_t ph = kt & 1;

        mbar_wait(k_full, ph);
        wgmma_fence();
        const uint64_t kd = desc(ks + NB * w * kBox, 16, 1024, kSw128);
        mma_ss_n64<0, 0, false>(sc, qd, kd);
#pragma unroll
        for (int kk = 1; kk < 4 * NB; ++kk) {
          const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
          mma_ss_n64<0, 0, true>(sc, advance(qd, off), advance(kd, off));
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(sc);
        mbar_arrive(k_empty);

        // the other half's partial scores; both halves add in the same
        // order of the two terms, so their softmax agrees bit for bit
        if (kt > 0) named_sync(1, kConsumers);  // last tile's reads are done
#pragma unroll
        for (int i = 0; i < 32; ++i) xs[(w * 32 + i) * 128 + t] = sc[i];
        named_sync(1, kConsumers);
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] += xs[((1 - w) * 32 + i) * 128 + t];

        softmax_step(sc, m, l, scale_log2, corr);
#pragma unroll
        for (int n = 0; n < NB; ++n) rescale(acc[n], corr);
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc_to_a(sc, kk, pa[kk]);

        mbar_wait(v_full, ph);
        wgmma_fence();
        const uint64_t vd = desc(vs + NB * w * kBox, 16, 1024, kSw128);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int n = 0; n < NB; ++n)
            mma_rs_n64<1>(acc[n], pa[kk], advance(vd, n * kBox + 2048 * kk));
        wgmma_commit();
        wgmma_wait();
#pragma unroll
        for (int n = 0; n < NB; ++n) fence_regs(acc[n]);
        mbar_arrive(v_empty);
      }
      const int qa = q0 + r0;
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = quad_sum(l[r]);
        inv[r] = 1.f / l[r];
      }
      bf16* row0 = ob + size_t(qa) * row_stride;
      bf16* row1 = ob + size_t(qa + 8) * row_stride;
#pragma unroll
      for (int n = 0; n < NB; ++n)
        store_rows(acc[n], row0, row1, DP / 2 * w + 64 * n, D, inv);
      if (lse != nullptr && w == 0 && t % 4 == 0) {
        lse[size_t(bh) * T + qa] = (m[0] + log2f(l[0])) * 0.6931471805599453f;
        lse[size_t(bh) * T + qa + 8] = (m[1] + log2f(l[1])) * 0.6931471805599453f;
      }
    }
  }
}

template <int DP, int BQ, int BK, int STAGES, bool COLS>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int T, int H, int D, float scale_log2, cudaStream_t stream) {
  using L = FwdLayout<DP, BQ, BK, STAGES, COLS>;
  if (T % BQ != 0 || T % BK != 0) return int(cudaErrorInvalidValue);
  // maps of q, k, v over 64-column boxes, then over the 16-column box
  // (copies of the first three where the head dim has none)
  CUtensorMap maps[6];
  const void* src[3] = {q, k, v};
  const int rows[3] = {BQ, BK, BK};
  for (int i = 0; i < 3; ++i) {
    int err = btnh_map(&maps[i], src[i], B, T, H, D, 64, rows[i],
                       CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == 0 && Tile<DP>::kRem != 0)
      err = btnh_map(&maps[3 + i], src[i], B, T, H, D, 16, rows[i],
                     CU_TENSOR_MAP_SWIZZLE_32B);
    else
      maps[3 + i] = maps[i];
    if (err != 0) return err;
  }
  auto kern = flash_fwd_kernel<DP, BQ, BK, STAGES, COLS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::bytes));
  if (err != cudaSuccess) return int(err);
  dim3 grid(T / BQ, B * H);
  kern<<<grid, kThreads, L::bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
      static_cast<bf16*>(o), lse, T, H, D, scale_log2);
  return int(cudaGetLastError());
}

}  // namespace

// q, k, v, o: contiguous (B, T, H, D) bf16 on the device, 16-byte aligned;
// D % 8 == 0 and D <= 80, or D is 128, 256 or 512; T % 128 == 0. lse: contiguous
// (B, H, T) fp32, or null when the caller needs no log-sum-exp.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int T, int H, int D,
                              float scale, void* stream) {
  // head dims of the paths: 16 to 72 (padded to 64 or 80), 128, 256 and 512
  if (D <= 0 || D % 8 != 0 || (D > 80 && D != 128 && D != 256 && D != 512))
    return int(cudaErrorInvalidValue);
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (D <= 64)
    return launch<64, 128, 128, 2, false>(q, k, v, o, l, B, T, H, D, scale_log2, s);
  if (D <= 80)
    return launch<80, 128, 128, 2, false>(q, k, v, o, l, B, T, H, D, scale_log2, s);
  if (D == 128)
    return launch<128, 64, 64, 1, true>(q, k, v, o, l, B, T, H, D, scale_log2, s);
  if (D == 256)
    return launch<256, 64, 64, 1, true>(q, k, v, o, l, B, T, H, D, scale_log2, s);
  return launch<512, 64, 64, 1, true>(q, k, v, o, l, B, T, H, D, scale_log2, s);
}
