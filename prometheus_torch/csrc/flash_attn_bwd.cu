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
// D = 512 (the VAE mid block) keeps the first design, WMMA 16x16x16 with the
// score tiles and accumulators in shared memory: the delta pass, a dK/dV
// kernel per 16-key tile (two fp32 accumulators of 16 x 516 floats so a
// block fits in 227 KB) and a dQ kernel per 32-query tile that recomputes S
// and dP; its dQ does not depend on block order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;
using namespace hopper;

// ------------------------------- D = 512 (WMMA), and the D_i pre-pass of both

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Shared memory of both kernels. RES rows of two resident tiles (the
// block's own K, V for dkv; Q, dO for dq), STR rows of two streamed tiles,
// the BQ x BK score and dP tiles, the bf16 P and dS tiles, NACC fp32
// accumulators of RES x DP, and the lse / D values of the BQ query rows.
template <int DP, int BQ, int BK, int RES, int STR, int NACC>
struct Layout {
  static constexpr int LDB = DP + 8;  // bf16 row stride of Q, K, V, dO tiles
  static constexpr int LDS = BK + 4;  // f32 row stride of S and dP
  static constexpr int LDP = BK + 8;  // bf16 row stride of P and dS
  static constexpr int LDA = DP + 4;  // f32 row stride of the accumulators
  static constexpr size_t res_off = 0;
  static constexpr size_t str_off = align128(res_off + size_t(2) * RES * LDB * 2);
  static constexpr size_t s_off = align128(str_off + size_t(2) * STR * LDB * 2);
  static constexpr size_t dp_off = align128(s_off + size_t(BQ) * LDS * 4);
  static constexpr size_t p_off = align128(dp_off + size_t(BQ) * LDS * 4);
  static constexpr size_t ds_off = align128(p_off + size_t(BQ) * LDP * 2);
  static constexpr size_t acc_off = align128(ds_off + size_t(BQ) * LDP * 2);
  static constexpr size_t lse_off = align128(acc_off + size_t(NACC) * RES * LDA * 4);
  static constexpr size_t dl_off = lse_off + size_t(BQ) * 4;
  static constexpr size_t bytes = align128(dl_off + size_t(BQ) * 4);
};

// Copy ROWS rows of D bf16 (16-byte vectors) into a shared tile of width DP,
// zero-filling columns D..DP-1.
template <int DP, int ROWS, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row_stride, int D) {
  const int vecs = D / 8;
  const int per_row = DP / 8;
  for (int i = threadIdx.x; i < ROWS * per_row; i += kThreads) {
    const int r = i / per_row, c = i % per_row;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (c < vecs)
      val = *reinterpret_cast<const uint4*>(src + size_t(r) * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// OUT (BQ x BK, f32) = A (BQ x DP) B^T for the two products S = Q K^T and
// dP = dO V^T, one 16x16 output tile per warp at a time.
template <int DP, int BQ, int BK, int LDB, int LDS>
__device__ __forceinline__ void scores(const bf16* Qs, const bf16* Ks,
                                       const bf16* dOs, const bf16* Vs,
                                       float* Ss, float* dPs) {
  constexpr int cols = BK / 16;
  constexpr int per = (BQ / 16) * cols;
  const int warp = threadIdx.x / 32;
  for (int tile = warp; tile < 2 * per; tile += kWarps) {
    const int which = tile / per, tm = (tile % per) / cols, tn = tile % cols;
    const bf16* A = which ? dOs : Qs;
    const bf16* B = which ? Vs : Ks;
    float* out = which ? dPs : Ss;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < DP; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, A + tm * 16 * LDB + kk, LDB);
      wmma::load_matrix_sync(fb, B + tn * 16 * LDB + kk, LDB);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + tm * 16 * LDS + tn * 16, acc, LDS,
                            wmma::mem_row_major);
  }
}

// One row per thread slot: lse in log2 units and D_i for the BQ query rows
// starting at q0 of head bh.
template <int BQ>
__device__ __forceinline__ void load_rows(float* lse2, float* dl,
                                          const float* lse, const float* delta,
                                          int bh, int T, int q0) {
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    lse2[r] = lse[size_t(bh) * T + q0 + r] * kLog2e;
    dl[r] = delta[size_t(bh) * T + q0 + r];
  }
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

template <int DP, int BQ, int BK>
using DkvLayout = Layout<DP, BQ, BK, BK, BQ, 2>;

template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int H,
                     int D, float scale) {
  using L = DkvLayout<DP, BQ, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::res_off);
  bf16* Vs = Ks + BK * L::LDB;
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::str_off);
  bf16* dOs = Qs + BQ * L::LDB;
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* dPs = reinterpret_cast<float*>(smem + L::dp_off);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p_off);
  bf16* dSs = reinterpret_cast<bf16*>(smem + L::ds_off);
  float* dKa = reinterpret_cast<float*>(smem + L::acc_off);
  float* dVa = dKa + BK * L::LDA;
  float* lse2 = reinterpret_cast<float*>(smem + L::lse_off);
  float* dl = reinterpret_cast<float*>(smem + L::dl_off);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int row_stride = H * D;
  const size_t base = (size_t(b) * T * H + h) * D;  // element (b, 0, h, 0)
  const int warp = threadIdx.x / 32;
  const float scale_log2 = scale * kLog2e;

  load_tile<DP, BK, L::LDB>(Ks, k + base + size_t(k0) * row_stride, row_stride, D);
  load_tile<DP, BK, L::LDB>(Vs, v + base + size_t(k0) * row_stride, row_stride, D);
  for (int i = threadIdx.x; i < 2 * BK * L::LDA; i += kThreads) dKa[i] = 0.f;

  for (int q0 = 0; q0 < T; q0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<DP, BQ, L::LDB>(Qs, q + base + size_t(q0) * row_stride, row_stride, D);
    load_tile<DP, BQ, L::LDB>(dOs, dout + base + size_t(q0) * row_stride, row_stride, D);
    load_rows<BQ>(lse2, dl, lse, delta, bh, T, q0);
    __syncthreads();
    scores<DP, BQ, BK, L::LDB, L::LDS>(Qs, Ks, dOs, Vs, Ss, dPs);
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      const float p = exp2f(Ss[r * L::LDS + c] * scale_log2 - lse2[r]);
      Ps[r * L::LDP + c] = __float2bfloat16(p);
      dSs[r * L::LDP + c] = __float2bfloat16(p * (dPs[r * L::LDS + c] - dl[r]));
    }
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q: P and dS read column-major are P^T, dS^T
    constexpr int cols = DP / 16;
    constexpr int per = (BK / 16) * cols;
    for (int tile = warp; tile < 2 * per; tile += kWarps) {
      const int which = tile / per, tm = (tile % per) / cols, tn = tile % cols;
      const bf16* A = which ? dSs : Ps;
      const bf16* B = which ? Qs : dOs;
      float* acc_tile = (which ? dKa : dVa) + tm * 16 * L::LDA + tn * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, acc_tile, L::LDA, wmma::mem_row_major);
      for (int kk = 0; kk < BQ; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, A + kk * L::LDP + tm * 16, L::LDP);
        wmma::load_matrix_sync(fb, B + kk * L::LDB + tn * 16, L::LDB);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(acc_tile, acc, L::LDA, wmma::mem_row_major);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BK * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const size_t at = base + size_t(k0 + r) * row_stride + c;
    dk[at] = __float2bfloat16(dKa[r * L::LDA + c] * scale);
    dv[at] = __float2bfloat16(dVa[r * L::LDA + c]);
  }
}

template <int DP, int BQ, int BK>
using DqLayout = Layout<DP, BQ, BK, BQ, BK, 1>;

template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int T, int H, int D, float scale) {
  using L = DqLayout<DP, BQ, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::res_off);
  bf16* dOs = Qs + BQ * L::LDB;
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::str_off);
  bf16* Vs = Ks + BK * L::LDB;
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* dPs = reinterpret_cast<float*>(smem + L::dp_off);
  bf16* dSs = reinterpret_cast<bf16*>(smem + L::ds_off);
  float* dQa = reinterpret_cast<float*>(smem + L::acc_off);
  float* lse2 = reinterpret_cast<float*>(smem + L::lse_off);
  float* dl = reinterpret_cast<float*>(smem + L::dl_off);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int row_stride = H * D;
  const size_t base = (size_t(b) * T * H + h) * D;
  const int warp = threadIdx.x / 32;
  const float scale_log2 = scale * kLog2e;

  load_tile<DP, BQ, L::LDB>(Qs, q + base + size_t(q0) * row_stride, row_stride, D);
  load_tile<DP, BQ, L::LDB>(dOs, dout + base + size_t(q0) * row_stride, row_stride, D);
  load_rows<BQ>(lse2, dl, lse, delta, bh, T, q0);
  for (int i = threadIdx.x; i < BQ * L::LDA; i += kThreads) dQa[i] = 0.f;

  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();
    load_tile<DP, BK, L::LDB>(Ks, k + base + size_t(k0) * row_stride, row_stride, D);
    load_tile<DP, BK, L::LDB>(Vs, v + base + size_t(k0) * row_stride, row_stride, D);
    __syncthreads();
    scores<DP, BQ, BK, L::LDB, L::LDS>(Qs, Ks, dOs, Vs, Ss, dPs);
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      const float p = exp2f(Ss[r * L::LDS + c] * scale_log2 - lse2[r]);
      dSs[r * L::LDP + c] = __float2bfloat16(p * (dPs[r * L::LDS + c] - dl[r]));
    }
    __syncthreads();
    // dQ += dS K
    constexpr int cols = DP / 16;
    for (int tile = warp; tile < (BQ / 16) * cols; tile += kWarps) {
      const int tm = tile / cols, tn = tile % cols;
      float* acc_tile = dQa + tm * 16 * L::LDA + tn * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, acc_tile, L::LDA, wmma::mem_row_major);
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, dSs + tm * 16 * L::LDP + kk, L::LDP);
        wmma::load_matrix_sync(fb, Ks + kk * L::LDB + tn * 16, L::LDB);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(acc_tile, acc, L::LDA, wmma::mem_row_major);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dq[base + size_t(q0 + r) * row_stride + c] =
        __float2bfloat16(dQa[r * L::LDA + c] * scale);
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

// D = 512, the WMMA design. DP: padded head dim; (QD, KD): query and key
// tile rows of the dkv kernel; (QQ, KQ): those of the dq kernel.
template <int DP, int QD, int KD, int QQ, int KQ>
int launch_wmma(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const float* lse, const bf16* dout, float* delta, bf16* dq, bf16* dk,
           bf16* dv, int B, int T, int H, int D, float scale, cudaStream_t s) {
  if (T % QD || T % KD || T % QQ || T % KQ) return int(cudaErrorInvalidValue);
  cudaError_t err = launch_delta(o, dout, delta, B, T, H, D, s);
  if (err != cudaSuccess) return int(err);

  using LK = DkvLayout<DP, QD, KD>;
  auto dkv = flash_bwd_dkv_kernel<DP, QD, KD>;
  if ((err = prepare(dkv, LK::bytes)) != cudaSuccess) return int(err);
  dkv<<<dim3(T / KD, B * H), kThreads, LK::bytes, s>>>(q, k, v, dout, lse, delta,
                                                       dk, dv, T, H, D, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);

  using LQ = DqLayout<DP, QQ, KQ>;
  auto dqk = flash_bwd_dq_kernel<DP, QQ, KQ>;
  if ((err = prepare(dqk, LQ::bytes)) != cudaSuccess) return int(err);
  dqk<<<dim3(T / QQ, B * H), kThreads, LQ::bytes, s>>>(q, k, v, dout, lse, delta,
                                                       dq, T, H, D, scale);
  return int(cudaGetLastError());
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: contiguous (B, T, H, D) bf16 on the device,
// 16-byte aligned; lse: (B, H, T) fp32 from flash_attn_fwd; delta: (B, H, T)
// fp32 scratch; dq_acc: (B, H, T, D) fp32 scratch filled with zeros (D <= 80;
// unused, and may be null, at D = 512). D % 8 == 0 and D <= 80, or
// D == 512; T % 128 == 0. Returns cudaGetLastError() after the last launch
// (0 on success).
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* lse, const void* dout,
                              void* delta, void* dq_acc, void* dq, void* dk,
                              void* dv, int B, int T, int H, int D, float scale,
                              void* stream) {
  if (D <= 0 || D % 8 != 0 || (D > 80 && D != 512)) return int(cudaErrorInvalidValue);
  auto c = [](const void* p) { return static_cast<const bf16*>(p); };
  auto m = [](void* p) { return static_cast<bf16*>(p); };
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* acc = static_cast<float*>(dq_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_main<64>(c(q), c(k), c(v), c(o), l, c(dout), dl, acc, m(dq),
                           m(dk), m(dv), B, T, H, D, scale, s);
  if (D <= 80)
    return launch_main<80>(c(q), c(k), c(v), c(o), l, c(dout), dl, acc, m(dq),
                           m(dk), m(dv), B, T, H, D, scale, s);
  return launch_wmma<512, 32, 16, 32, 16>(c(q), c(k), c(v), c(o), l, c(dout), dl,
                                          m(dq), m(dk), m(dv), B, T, H, D, scale, s);
}
