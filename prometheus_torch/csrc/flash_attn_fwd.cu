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
// 3.35 TB/s of device memory set the floor (22 us vs 6 us). The design keeps
// every T x T intermediate on chip: one block per (batch*head, query tile)
// walks the K/V tiles once with an online softmax, so device memory sees each
// input once and the output once. This first version issues mma.sync through
// the WMMA API (16x16x16 bf16 fragments) and stages the score tile and the
// output accumulator in shared memory; wgmma and TMA are later work.
//
// Head dims: D is padded in shared memory to DP (a multiple of 16, zero
// filled), so D = 64, 72 and 512 all run. D = 512 uses 32-row tiles so the
// fp32 accumulator fits in shared memory (dynamic shared memory above 48 KB
// is enabled with cudaFuncSetAttribute).
//
// For training the kernel also writes each query row's log-sum-exp of the
// scaled scores, fp32 (B, H, T) in natural-log units, which the backward
// (flash_attn_bwd.cu) uses to recompute the probabilities; inference passes
// a null pointer and writes nothing more.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

template <int DP, int BQ, int BK>
struct Layout {
  static constexpr int LDB = DP + 8;  // bf16 row stride of the Q, K, V tiles
  static constexpr int LDS = BK + 4;  // f32 row stride of the score tile
  static constexpr int LDP = BK + 8;  // bf16 row stride of the probabilities
  static constexpr int LDO = DP + 4;  // f32 row stride of the accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = align128(q_off + size_t(BQ) * LDB * 2);
  static constexpr size_t v_off = align128(k_off + size_t(BK) * LDB * 2);
  static constexpr size_t s_off = align128(v_off + size_t(BK) * LDB * 2);
  static constexpr size_t p_off = align128(s_off + size_t(BQ) * LDS * 4);
  static constexpr size_t o_off = align128(p_off + size_t(BQ) * LDP * 2);
  static constexpr size_t m_off = align128(o_off + size_t(BQ) * LDO * 4);
  static constexpr size_t l_off = m_off + size_t(BQ) * 4;
  static constexpr size_t c_off = l_off + size_t(BQ) * 4;
  static constexpr size_t bytes = align128(c_off + size_t(BQ) * 4);
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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int T, int H, int D, float scale_log2) {
  using L = Layout<DP, BQ, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);
  float* row_m = reinterpret_cast<float*>(smem + L::m_off);
  float* row_l = reinterpret_cast<float*>(smem + L::l_off);
  float* row_c = reinterpret_cast<float*>(smem + L::c_off);

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int row_stride = H * D;
  const size_t base = (size_t(b) * T * H + h) * D;  // element (b, 0, h, 0)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile<DP, BQ, L::LDB>(Qs, q + base + size_t(q0) * row_stride, row_stride, D);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += kThreads) Os[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    row_m[i] = -INFINITY;
    row_l[i] = 0.f;
  }

  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<DP, BK, L::LDB>(Ks, k + base + size_t(k0) * row_stride, row_stride, D);
    load_tile<DP, BK, L::LDB>(Vs, v + base + size_t(k0) * row_stride, row_stride, D);
    __syncthreads();

    // S = Q K^T (K tile read column-major is K^T)
    constexpr int s_cols = BK / 16;
    for (int tile = warp; tile < (BQ / 16) * s_cols; tile += kWarps) {
      const int tm = tile / s_cols, tn = tile % s_cols;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + tm * 16 * L::LDB + kk, L::LDB);
        wmma::load_matrix_sync(fb, Ks + tn * 16 * L::LDB + kk, L::LDB);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ss + tm * 16 * L::LDS + tn * 16, acc, L::LDS,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax in base 2, one warp per row
    for (int r = warp; r < BQ; r += kWarps) {
      float mx = -INFINITY;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, Ss[r * L::LDS + c]);
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(mx) * scale_log2);
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float p = exp2f(Ss[r * L::LDS + c] * scale_log2 - m_new);
        Ps[r * L::LDP + c] = __float2bfloat16(p);
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = exp2f(m_old - m_new);
        row_c[r] = corr;
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      Os[r * L::LDO + c] *= row_c[r];
    }
    __syncthreads();

    // O += P V
    constexpr int o_cols = DP / 16;
    for (int tile = warp; tile < (BQ / 16) * o_cols; tile += kWarps) {
      const int tm = tile / o_cols, tn = tile % o_cols;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* o_tile = Os + tm * 16 * L::LDO + tn * 16;
      wmma::load_matrix_sync(acc, o_tile, L::LDO, wmma::mem_row_major);
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Ps + tm * 16 * L::LDP + kk, L::LDP);
        wmma::load_matrix_sync(fb, Vs + kk * L::LDB + tn * 16, L::LDB);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(o_tile, acc, L::LDO, wmma::mem_row_major);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    o[base + size_t(q0 + r) * row_stride + c] =
        __float2bfloat16(Os[r * L::LDO + c] / row_l[r]);
  }
  if (lse != nullptr) {
    // softmax = exp2(s * scale_log2 - (m + log2 l)); natural log for the API
    for (int r = threadIdx.x; r < BQ; r += kThreads)
      lse[size_t(blockIdx.y) * T + q0 + r] =
          (row_m[r] + log2f(row_l[r])) * 0.6931471805599453f;
  }
}

template <int DP, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int T, int H, int D, float scale_log2, cudaStream_t stream) {
  using L = Layout<DP, BQ, BK>;
  if (T % BQ != 0 || T % BK != 0) return int(cudaErrorInvalidValue);
  auto kern = flash_fwd_kernel<DP, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::bytes));
  if (err != cudaSuccess) return int(err);
  dim3 grid(T / BQ, B * H);
  kern<<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, T, H, D,
      scale_log2);
  return int(cudaGetLastError());
}

}  // namespace

// q, k, v, o: contiguous (B, T, H, D) bf16 on the device, 16-byte aligned;
// D % 8 == 0 and D <= 80, or D == 512. lse: contiguous (B, H, T) fp32, or
// null when the caller needs no log-sum-exp.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int T, int H, int D,
                              float scale, void* stream) {
  // head dims of the path: 64 and 72 (padded to 80), and 512
  if (D <= 0 || D % 8 != 0 || (D > 80 && D != 512)) return int(cudaErrorInvalidValue);
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (D <= 64) return launch<64, 64, 64>(q, k, v, o, l, B, T, H, D, scale_log2, s);
  if (D <= 80) return launch<80, 64, 64>(q, k, v, o, l, B, T, H, D, scale_log2, s);
  return launch<512, 32, 32>(q, k, v, o, l, B, T, H, D, scale_log2, s);
}
