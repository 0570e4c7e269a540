// Device helpers shared by the port's kernels: type conversion at the
// compute dtype's rounding points, warp reductions, the f32 LayerNorm of one
// token, tanh-GELU, a register-tiled f32 "NT" matrix product on the CUDA
// cores, and bf16 matrix products on the tensor cores (WMMA 16x16x16, f32
// accumulation).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace fbanet {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;  // threads per block for every kernel here
constexpr float kLnEps = 1e-5f;  // torch nn.LayerNorm default, as in JAX

// Stages K11 removes from K3 (bits of the kSkip / SKIP template parameter of
// both of K3's forms, attention_bwd.cuh and attention_bwd_wgmma.cuh).
enum : int { kNoRecompute = 1, kNoDsoftmax = 2, kNoWgrads = 4, kNoDx = 8, kNoCore = 16 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The value `v` takes once stored in T: the compute dtype's rounding point,
// kept in an f32 register or shared-memory slot.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// jax.nn.gelu's default (tanh approximation), same association order.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return x * (0.5f * (1.0f + tanhf(k * (x + 0.044715f * (x * x * x)))));
}

// One warp normalises one token of C channels: f32 statistics with the fast
// variance E[x^2] - E[x]^2 clamped at 0, then y rounded to the compute type
// T (flax LayerNorm followed by .astype(T)) and stored as TY.
template <typename T, typename TY>
__device__ __forceinline__ void layernorm_row(const T* __restrict__ x, int C,
                                              const float* __restrict__ scale,
                                              const float* __restrict__ shift,
                                              TY* __restrict__ y, int lane) {
  float sum = 0.f, sq = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = to_f(x[c]);
    sum += v;
    sq += v * v;
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mu = sum / C;
  const float var = fmaxf(0.f, sq / C - mu * mu);
  const float inv = rsqrtf(var + kLnEps);
  for (int c = lane; c < C; c += 32)
    y[c] = from_f<TY>(round_to<T>((to_f(x[c]) - mu) * (inv * scale[c]) + shift[c]));
}

// epi(m, n, sum_k A[m * lda + k] * B[n * bsn + k * bsk]) for m < M, n < N,
// accumulated in f32 in order of k. A is f32 in shared memory; B is f32 in
// shared memory or a weight matrix of type TB in global memory ([N, K] rows
// for a torch Linear weight: bsn = K, bsk = 1).
//
// Each thread owns a 4 x 4 tile: rows m0..m0+3 (the same for neighbouring
// lanes, so A reads broadcast) and columns nl + j * ncol (consecutive across
// lanes, so B reads from shared memory with an odd row stride hit distinct
// banks). Out-of-range rows and columns read a clamped row and are dropped
// in the epilogue, which keeps the k loop free of branches.
template <typename TB, typename Epi>
__device__ __forceinline__ void gemm_nt(int M, int N, int K,
                                        const float* __restrict__ A, int lda,
                                        const TB* __restrict__ B, int bsn, int bsk,
                                        Epi epi) {
  const int ncol = (N + 3) >> 2;
  const int ntile = ncol * ((M + 3) >> 2);
  for (int tile = threadIdx.x; tile < ntile; tile += blockDim.x) {
    const int nl = tile % ncol;
    const int m0 = (tile / ncol) * 4;
    const float* a[4];
    const TB* bp[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A + min(m0 + i, M - 1) * lda;
#pragma unroll
    for (int j = 0; j < 4; ++j) bp[j] = B + (size_t)min(nl + j * ncol, N - 1) * bsn;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < K; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a[i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = to_f(bp[j][(size_t)k * bsk]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + i, n = nl + j * ncol;
        if (m < M && n < N) epi(m, n, acc[i][j]);
      }
  }
}

// Where the window-attention kernels (K1, K3 and their windowed entries)
// find their tokens. Block g handles window g of the post-roll map
// [B, H, W, C] (window-partition order: image, window row, window column),
// or, with `windowed`, rows g * n .. g * n + n - 1 of pre-partitioned windows
// [G, n, C]. Its mask window is g % nw (in map mode nw is the number of
// windows per image, so that is the window's place in its image).
struct WinGeom {
  int H, W, C, ws, n, nw, windowed;
};

struct WinBlock {
  int win;              // mask window
  size_t base;          // pixel index of token 0
  int rowlen, rowstride;  // token t sits t / rowlen rows of rowstride on
  __device__ explicit WinBlock(const WinGeom& g) : WinBlock(g, blockIdx.x) {}
  // window `w` (K3's wgmma form walks several windows per block)
  __device__ WinBlock(const WinGeom& g, int w) {
    win = w % g.nw;
    if (g.windowed) {
      base = (size_t)w * g.n;
      rowlen = g.n;
      rowstride = 0;
    } else {
      const int nww = g.W / g.ws;
      base = ((size_t)(w / g.nw) * g.H + (win / nww) * g.ws) * g.W +
             (win % nww) * g.ws;
      rowlen = g.ws;
      rowstride = g.W;
    }
  }
  // pixel (token row) index of the block's token t
  __device__ __forceinline__ size_t pix(int t) const {
    return base + (size_t)(t / rowlen) * rowstride + t % rowlen;
  }
};

// Columns one head takes in the first kernels' bf16 q, k, v (and K3's do)
// tiles: its size rounded up to the 16 of a WMMA tile. A head of 8 is
// zero-padded to 16, so q k^T adds 8 exact zero products and p v computes 8
// columns more, which are dropped (those kernels take head sizes in
// multiples of 8, as the TPU kernel does: attention_pallas.py::_supported).
__host__ __device__ inline int head_pitch(int dh) { return (dh + 15) & ~15; }

// Shared-memory carving: each array starts on a 128-byte boundary (WMMA
// loads and stores need 32-byte aligned tiles).
__host__ __device__ inline size_t align128(size_t bytes) {
  return (bytes + 127) & ~size_t(127);
}

// Tensor-core product over bf16 operands. For each 16 x 16 tile of the
// [Mp, N] output (Mp, N, K multiples of 16) one warp accumulates
// sum_k A(m, k) * B(k, n) in f32, parks the tile in its 16 x 16 f32 slot of
// `scratch` and calls epi(m, n, value) for the rows m < M. A(m, k) lives at
// A[m * lda + k] for wmma::row_major (the default) and at A[k * lda + m] for
// wmma::col_major (a transposed operand); B(k, n) lives at B[n * ldb + k]
// for wmma::col_major (a torch Linear weight [N, K], or K^T) and at
// B[k * ldb + n] for wmma::row_major. Strides are multiples of 8 elements,
// tile starts 32-byte aligned.
template <typename BLayout, typename ALayout = wmma::row_major, typename Epi>
__device__ __forceinline__ void gemm_tc(int M, int Mp, int N, int K,
                                        const bf16* A, int lda, const bf16* B,
                                        int ldb, float* scratch, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tn = N / 16, ntile = (Mp / 16) * tn;
  float* slot = scratch + warp * 256;
  for (int tile = warp; tile < ntile; tile += blockDim.x >> 5) {
    const int m0 = (tile / tn) * 16, n0 = (tile % tn) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b;
      if constexpr (std::is_same_v<ALayout, wmma::row_major>)
        wmma::load_matrix_sync(a, A + (size_t)m0 * lda + k0, lda);
      else
        wmma::load_matrix_sync(a, A + (size_t)k0 * lda + m0, lda);
      if constexpr (std::is_same_v<BLayout, wmma::col_major>)
        wmma::load_matrix_sync(b, B + (size_t)n0 * ldb + k0, ldb);
      else
        wmma::load_matrix_sync(b, B + (size_t)k0 * ldb + n0, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(slot, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) {
      const int m = m0 + i / 16;
      if (m < M) epi(m, n0 + i % 16, slot[i]);
    }
    __syncwarp();
  }
}

// Cm[M][N] (f32, row stride ldc, a multiple of 4) += A[M][K] . B where B(k, n)
// = B[n * ldb + k] for wmma::col_major (the default: a torch Linear weight
// slice) or B[k * ldb + n] for wmma::row_major. M, N, K multiples of 16; each
// warp owns whole output tiles, so no two warps touch the same element.
template <typename BLayout = wmma::col_major>
__device__ __forceinline__ void gemm_tc_acc(int M, int N, int K, const bf16* A,
                                            int lda, const bf16* B, int ldb,
                                            float* Cm, int ldc) {
  const int warp = threadIdx.x >> 5;
  const int tn = N / 16, ntile = (M / 16) * tn;
  for (int tile = warp; tile < ntile; tile += blockDim.x >> 5) {
    const int m0 = (tile / tn) * 16, n0 = (tile % tn) * 16;
    float* c = Cm + (size_t)m0 * ldc + n0;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, c, ldc, wmma::mem_row_major);
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b;
      wmma::load_matrix_sync(a, A + (size_t)m0 * lda + k0, lda);
      if constexpr (std::is_same_v<BLayout, wmma::col_major>)
        wmma::load_matrix_sync(b, B + (size_t)n0 * ldb + k0, ldb);
      else
        wmma::load_matrix_sync(b, B + (size_t)k0 * ldb + n0, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(c, acc, ldc, wmma::mem_row_major);
  }
}

// epi(m, n, sum_k A(m, k) * B(k, n)) on the CUDA cores, f32 accumulation in
// order of k: the f32 counterpart of gemm_tc for the backward kernels. Row m
// of A starts at arow(m) (a pointer into shared or global memory, so rows
// need not be evenly spaced), with element k at arow(m)[k * ask]; B(k, n) =
// B[n * bsn + k * bsk]. Same 4 x 4 register tiling as gemm_nt.
template <typename ARow, typename TB, typename Epi>
__device__ __forceinline__ void gemm_f32(int M, int N, int K, ARow arow, int ask,
                                         const TB* __restrict__ B, int bsn, int bsk,
                                         Epi epi) {
  const int ncol = (N + 3) >> 2;
  const int ntile = ncol * ((M + 3) >> 2);
  for (int tile = threadIdx.x; tile < ntile; tile += blockDim.x) {
    const int nl = tile % ncol;
    const int m0 = (tile / ncol) * 4;
    const float* a[4];
    const TB* bp[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = arow(min(m0 + i, M - 1));
#pragma unroll
    for (int j = 0; j < 4; ++j) bp[j] = B + (size_t)min(nl + j * ncol, N - 1) * bsn;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < K; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a[i][(size_t)k * ask];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = to_f(bp[j][(size_t)k * bsk]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + i, n = nl + j * ncol;
        if (m < M && n < N) epi(m, n, acc[i][j]);
      }
  }
}

// epi(m, n, sum_k A(m, k) B(k, n)) for operands of the compute type T in
// shared memory (B may be a weight in global memory), with A row- or
// column-major (AL) and B row- or column-major (BL) as in gemm_tc: the
// tensor cores for bf16 (M, N, K multiples of 16), the CUDA cores for f32.
template <typename T, typename AL, typename BL, typename Epi>
__device__ __forceinline__ void mm(int M, int N, int K, const T* A, int lda, const T* B,
                                   int ldb, float* scratch, Epi epi) {
  if constexpr (std::is_same_v<T, bf16>) {
    gemm_tc<BL, AL>(M, M, N, K, A, lda, B, ldb, scratch, epi);
  } else {
    constexpr bool arow = std::is_same_v<AL, wmma::row_major>;
    constexpr bool brow = std::is_same_v<BL, wmma::row_major>;
    gemm_f32(M, N, K, [&](int m) { return A + (size_t)m * (arow ? lda : 1); },
             arow ? 1 : lda, B, brow ? 1 : ldb, brow ? ldb : 1, epi);
  }
}

// The derivative of gelu_tanh, as autodiff of jax.nn.gelu gives it:
// gelu(x) = x * cdf, cdf = 0.5 (1 + tanh(u)), u = k (x + 0.044715 x^3).
__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float k = 0.7978845608028654f;
  const float t = tanhf(k * (x + 0.044715f * (x * x * x)));
  const float cdf = 0.5f * (1.0f + t);
  return cdf + x * (0.5f * (1.0f - t * t)) * (k * (1.0f + 3.0f * 0.044715f * (x * x)));
}

}  // namespace fbanet
