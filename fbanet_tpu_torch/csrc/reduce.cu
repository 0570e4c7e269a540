// The cross-block sums of the backward kernels K3 (attention_bwd.cu) and K4
// (leff_bwd.cu), in a fixed order and without atomics, so the gradients are
// bitwise repeatable.
//
// Replaces the accumulation into constant-index output blocks of the TPU
// kernels fbanet_tpu/ops/attention_pallas.py::_attention_bwd_kernel
// (:456-473) and fbanet_tpu/ops/leff_pallas.py::_leff_bwd_kernel (:379-401),
// which relies on the TPU grid running in order on one core.
//
// fbanet_token_matmul: part[s][m][n] = sum over the tokens t of slice s of
// A[t][m] * B[t][n] (A [T, M], B [T, N], row-major, the compute dtype; f32
// accumulation in token order). One block owns one 64 x 64 tile of one
// slice; the wrapper sums the slices with fbanet_column_sum. What bounds it:
// the bytes of A and B, read once per tile row/column of the output
// (M/64 + N/64 passes over the tokens), against 2 T M N flops; at the
// main-path widths (M, N <= 1024) it is bound by the tensor cores' rate only
// when M and N are both large. In bf16 the products run on the tensor cores
// (WMMA 16x16x16, Aᵀ loaded column-major from a shared-memory tile of 32
// tokens); in f32 on the CUDA cores, 4 x 4 outputs per thread.
//
// fbanet_column_sum: out[j] = sum over r of P[r][j] in row order, one thread
// per column (coalesced across a warp). Bound by the bytes of P.
#include "common.cuh"

namespace fbanet {
namespace {

constexpr int kTile = 64, kTok = 32;

struct GemmArgs {
  const void *a, *b;
  float* part;
  int T, M, N, chunk;
};

__global__ void __launch_bounds__(kThreads) token_matmul_f32_kernel(GemmArgs g) {
  __shared__ float sA[kTok][kTile], sB[kTok][kTile];
  const float* A = (const float*)g.a;
  const float* B = (const float*)g.b;
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile, s = blockIdx.z;
  const int t_begin = s * g.chunk, t_end = min(g.T, t_begin + g.chunk);
  const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
  float acc[4][4] = {};
  for (int t0 = t_begin; t0 < t_end; t0 += kTok) {
    for (int i = threadIdx.x; i < kTok * kTile; i += kThreads) {
      const int tt = i / kTile, c = i % kTile, t = t0 + tt;
      sA[tt][c] = t < t_end ? A[(size_t)t * g.M + m0 + c] : 0.f;
      sB[tt][c] = t < t_end ? B[(size_t)t * g.N + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int tt = 0; tt < kTok; ++tt) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sA[tt][tm * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[tt][tn + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = g.part + (size_t)s * g.M * g.N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[(size_t)(m0 + tm * 4 + i) * g.N + n0 + tn + 16 * j] = acc[i][j];
}

__global__ void __launch_bounds__(kThreads) token_matmul_bf16_kernel(GemmArgs g) {
  constexpr int ld = kTile + 8;
  __shared__ __align__(128) bf16 sA[kTok][ld];
  __shared__ __align__(128) bf16 sB[kTok][ld];
  const bf16* A = (const bf16*)g.a;
  const bf16* B = (const bf16*)g.b;
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile, s = blockIdx.z;
  const int t_begin = s * g.chunk, t_end = min(g.T, t_begin + g.chunk);
  const int warp = threadIdx.x >> 5;
  // 16 output tiles of 16 x 16, two per warp
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  const bf16 zero = __float2bfloat16(0.f);
  for (int t0 = t_begin; t0 < t_end; t0 += kTok) {
    for (int i = threadIdx.x; i < kTok * kTile; i += kThreads) {
      const int tt = i / kTile, c = i % kTile, t = t0 + tt;
      sA[tt][c] = t < t_end ? A[(size_t)t * g.M + m0 + c] : zero;
      sB[tt][c] = t < t_end ? B[(size_t)t * g.N + n0 + c] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < kTok; k0 += 16)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int tile = warp * 2 + i, tr = tile / 4, tc = tile % 4;
        // A^T (m, t) = sA[t][m]: column-major with leading dimension ld
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, &sA[k0][tr * 16], ld);
        wmma::load_matrix_sync(fb, &sB[k0][tc * 16], ld);
        wmma::mma_sync(acc[i], fa, fb, acc[i]);
      }
    __syncthreads();
  }
  float* out = g.part + (size_t)s * g.M * g.N;
  for (int i = 0; i < 2; ++i) {
    const int tile = warp * 2 + i, tr = tile / 4, tc = tile % 4;
    wmma::store_matrix_sync(out + (size_t)(m0 + tr * 16) * g.N + n0 + tc * 16, acc[i],
                            g.N, wmma::mem_row_major);
  }
}

__global__ void __launch_bounds__(kThreads) column_sum_kernel(const float* __restrict__ p,
                                                              float* __restrict__ out,
                                                              int R, int M) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= M) return;
  float acc = 0.f;
  for (int r = 0; r < R; ++r) acc += p[(size_t)r * M + j];
  out[j] = acc;
}

}  // namespace
}  // namespace fbanet

extern "C" {

int fbanet_token_matmul(const void* a, const void* b, void* part, int T, int M, int N,
                        int chunk, int bf16, void* stream) {
  using namespace fbanet;
  if (M % kTile || N % kTile || chunk <= 0 || chunk % kTok)
    return (int)cudaErrorInvalidValue;
  GemmArgs g{a, b, (float*)part, T, M, N, chunk};
  const dim3 grid(N / kTile, M / kTile, (T + chunk - 1) / chunk);
  if (bf16)
    token_matmul_bf16_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(g);
  else
    token_matmul_f32_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

int fbanet_column_sum(const void* p, void* out, int R, int M, void* stream) {
  using namespace fbanet;
  column_sum_kernel<<<(M + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)p, (float*)out, R, M);
  return (int)cudaGetLastError();
}

}  // extern "C"
