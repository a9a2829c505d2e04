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
// probabilities and the accumulators are fp32.
//
// FlashAttention-2's backward, in three launches on the caller's stream:
//   1. delta:  D_i = sum_d dO_id O_id, one warp per row;
//   2. dkv:    one block per (batch*head, key tile) walks every query tile:
//              S = Q K^T, P = exp(S * scale - lse), dP = dO V^T,
//              dS = P (dP - D); dV += P^T dO, dK += dS^T Q (times scale);
//   3. dq:     one block per (batch*head, query tile) walks every key tile,
//              recomputes S, P, dP and dS, and accumulates dQ += dS K.
// Two kernels instead of fp32 atomics into dQ: no scratch, and the result
// does not depend on the order blocks run in (as the library's two
// pallas_calls). P and dS are rounded to bf16 for the tensor-core products,
// as the forward rounds P.
//
// What bounds it on an H100: 10 B H T^2 D operations (recompute S, then dV,
// dP, dQ and dK; this version spends 14, recomputing S and dP in the dq
// kernel) on 7 B T H D bf16 values read and written, e.g. (4, 1024, 16, 72)
// is 48 GFLOP against 66 MB: the tensor cores (989 TFLOP/s bf16), not
// device memory, set the floor. Every T x T intermediate stays in shared
// memory. This first version issues mma.sync through the WMMA API
// (16x16x16 bf16 fragments) with the score tiles and the accumulators in
// shared memory; wgmma and TMA are later work.
//
// Head dims: D is padded in shared memory to DP (a multiple of 16, zero
// filled): D <= 80 runs as DP = 80 (72 on the path), D = 512 as DP = 512.
// At D = 512 the fp32 dK and dV accumulators take 16-row key tiles
// (2 x 16 x 516 floats) so that one block fits in 227 KB of shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

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

// DP: padded head dim; (QD, KD): query and key tile rows of the dkv kernel;
// (QQ, KQ): those of the dq kernel.
template <int DP, int QD, int KD, int QQ, int KQ>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const float* lse, const bf16* dout, float* delta, bf16* dq, bf16* dk,
           bf16* dv, int B, int T, int H, int D, float scale, cudaStream_t s) {
  if (T % QD || T % KD || T % QQ || T % KQ) return int(cudaErrorInvalidValue);
  const int rows = B * T * H;
  flash_bwd_delta_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      o, dout, delta, rows, T, H, D);
  cudaError_t err = cudaGetLastError();
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
// fp32 scratch. D % 8 == 0 and D <= 80, or D == 512; T % 64 == 0.
// Returns cudaGetLastError() after the last launch (0 on success).
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* lse, const void* dout,
                              void* delta, void* dq, void* dk, void* dv, int B,
                              int T, int H, int D, float scale, void* stream) {
  if (D <= 0 || D % 8 != 0 || (D > 80 && D != 512)) return int(cudaErrorInvalidValue);
  auto c = [](const void* p) { return static_cast<const bf16*>(p); };
  auto m = [](void* p) { return static_cast<bf16*>(p); };
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 80)
    return launch<80, 64, 64, 64, 64>(c(q), c(k), c(v), c(o), l, c(dout), dl,
                                      m(dq), m(dk), m(dv), B, T, H, D, scale, s);
  return launch<512, 32, 16, 32, 16>(c(q), c(k), c(v), c(o), l, c(dout), dl,
                                     m(dq), m(dk), m(dv), B, T, H, D, scale, s);
}
