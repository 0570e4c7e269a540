// K2's first kernel's block body (and K8's, K10's), shared by leff.cu (K2),
// leff_ablation.cu (K10) and leff_variants.cu (K8): the tile, the layout, the
// stages and the bf16 kernel with its compile-time flags. What K2 computes
// and why it is built so is at the top of leff.cu, with K2's wgmma form.
#pragma once

#include "common.cuh"

namespace fbanet {
namespace {

constexpr int kTileH = 8, kTileW = 8;
constexpr int kInH = kTileH + 2, kInW = kTileW + 2;
constexpr int kIn = kInH * kInW, kOut = kTileH * kTileW;
constexpr int kInPad = 112;  // kIn rounded up to the 16-row WMMA tile
constexpr int kChunkF32 = 32, kChunkBf16 = 64;  // hidden channels per pass

// bf16 kernel: byte offsets of y [112][C+8] bf16, the f32 accumulator
// [64][C+4], h1 [112][chunk+8] bf16, h2 [64][chunk+8] bf16 and one 16 x 16
// f32 WMMA epilogue slot per warp.
struct Bf16Layout {
  size_t y, acc, h1, h2, scratch, total;
  __host__ __device__ explicit Bf16Layout(int C) {
    y = 0;
    acc = y + align128(sizeof(bf16) * kInPad * (C + 8));
    h1 = acc + align128(sizeof(float) * kOut * (C + 4));
    h2 = h1 + align128(sizeof(bf16) * kInPad * (kChunkBf16 + 8));
    scratch = h2 + align128(sizeof(bf16) * kOut * (kChunkBf16 + 8));
    total = scratch + sizeof(float) * 256 * (kThreads / 32);
  }
};

struct Args {
  const void* x;
  void* out;
  const float *ln_s, *ln_b;
  const void *w1, *w2;  // compute-dtype weights, torch Linear layout
  const float *b1, *wdw, *bdw, *b2;
  int H, W, C, Ch, residual;
};

// The block's tile: image b, output rows/cols from (r0 + 1, c0 + 1); halo
// token t sits at (r0 + t / kInW, c0 + t % kInW).
struct Tile {
  int b, r0, c0;
  __device__ explicit Tile(const Args& a) {
    const int tiles_w = (a.W + kTileW - 1) / kTileW;
    const int tiles_h = (a.H + kTileH - 1) / kTileH;
    int blk = blockIdx.x;
    const int tx = blk % tiles_w;
    blk /= tiles_w;
    const int ty = blk % tiles_h;
    b = blk / tiles_h;
    r0 = ty * kTileH - 1;
    c0 = tx * kTileW - 1;
  }
  __device__ bool inside(const Args& a, int t) const {
    const int r = r0 + t / kInW, c = c0 + t % kInW;
    return r >= 0 && r < a.H && c >= 0 && c < a.W;
  }
  __device__ size_t pix(const Args& a, int r, int c) const {
    return (((size_t)b * a.H + r) * a.W + c) * a.C;
  }
};

// The hidden activation: tanh-GELU, or K10's nogelu stand-in x * 0.7.
template <bool kGelu>
__device__ __forceinline__ float act(float v) {
  if constexpr (kGelu) return gelu_tanh(v);
  return v * 0.7f;
}

// h2[t][j] = round(act(bdw + sum_taps h1 * w)) for the 64 interior tokens
// of hidden channels k0 .. k0 + kc (f32 taps, accumulated in this order).
template <typename T, bool kGelu, typename TH>
__device__ __forceinline__ void depthwise_gelu(const Args& a, int k0, int kc,
                                               const TH* sH1, TH* sH2, int ldk) {
  for (int i = threadIdx.x; i < kOut * kc; i += blockDim.x) {
    const int t = i / kc, j = i % kc;
    const int r = t / kTileW, c = t % kTileW;
    const float* wk = a.wdw + (size_t)(k0 + j) * 9;
    float acc = a.bdw[k0 + j];
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
        acc += to_f(sH1[((r + ky) * kInW + c + kx) * ldk + j]) * wk[ky * 3 + kx];
    sH2[t * ldk + j] = from_f<TH>(round_to<T>(act<kGelu>(acc)));
  }
}

// K10 nodw: h2 = round(act(h1)) on the 64 interior tokens.
template <bool kGelu>
__device__ __forceinline__ void pointwise_act(int kc, const bf16* sH1, bf16* sH2, int ldk) {
  for (int i = threadIdx.x; i < kOut * kc; i += blockDim.x) {
    const int t = i / kc, j = i % kc;
    const int r = t / kTileW, c = t % kTileW;
    const float h1 = __bfloat162float(sH1[((r + 1) * kInW + c + 1) * ldk + j]);
    sH2[t * ldk + j] = __float2bfloat16(act<kGelu>(h1));
  }
}

// out = acc + b2 (+ x) for the tile's in-image output tokens.
template <typename T>
__device__ __forceinline__ void write_out(const Args& a, const Tile& tile,
                                          const float* sAcc, int ldacc) {
  const T* x = (const T*)a.x;
  T* out = (T*)a.out;
  for (int i = threadIdx.x; i < kOut * a.C; i += blockDim.x) {
    const int t = i / a.C, o = i % a.C;
    const int r = tile.r0 + 1 + t / kTileW, c = tile.c0 + 1 + t % kTileW;
    if (r < a.H && c < a.W) {
      const size_t p = tile.pix(a, r, c) + o;
      float v = sAcc[t * ldacc + o] + a.b2[o];
      if (a.residual) v += to_f(x[p]);
      out[p] = from_f<T>(v);
    }
  }
}

// K8's packed bf16 arithmetic: two hidden channels per instruction, each
// product and each sum rounded to bf16 once (round to nearest even), as
// arithmetic on bf16 arrays rounds. The explicit .rn keeps ptxas from fusing
// a multiply and an add into one rounding (the script rounds both).
__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 from_bits(unsigned u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}
__device__ __forceinline__ __nv_bfloat162 mul2(__nv_bfloat162 a, __nv_bfloat162 b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(bits(a)), "r"(bits(b)));
  return from_bits(d);
}
__device__ __forceinline__ __nv_bfloat162 add2(__nv_bfloat162 a, __nv_bfloat162 b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(bits(a)), "r"(bits(b)));
  return from_bits(d);
}

// jax.nn.gelu's tanh form evaluated in bf16 (the script's gelu of a bf16
// array): x * (0.5 * (1 + tanh(k * (x + 0.044715 * (x * x) * x)))), every
// constant and every step in bf16. The tanh is the card's packed
// tanh.approx.bf16x2, chosen over an f32 tanhf rounded to bf16: the f32
// route unpacks both lanes, costs ~20 instructions a value and would time
// the f32 path this variant exists to compare against; the approximation's
// error is about one bf16 ulp of the result, inside the bf16 limit the
// kernel is held to against its plain version (which takes torch.tanh).
__device__ __forceinline__ __nv_bfloat162 gelu_bf16x2(__nv_bfloat162 x) {
  const __nv_bfloat162 k = __float2bfloat162_rn(0.7978845608028654f);
  const __nv_bfloat162 c = __float2bfloat162_rn(0.044715f);
  const __nv_bfloat162 one = __float2bfloat162_rn(1.f), half = __float2bfloat162_rn(0.5f);
  const __nv_bfloat162 x3 = mul2(mul2(x, x), x);
  unsigned t;
  asm("tanh.approx.bf16x2 %0, %1;" : "=r"(t) : "r"(bits(mul2(k, add2(x, mul2(c, x3))))));
  return mul2(x, mul2(half, add2(one, from_bits(t))));
}

// gemm_tc with its epilogue on column pairs: epi2(m, n, value(m, n),
// value(m, n + 1)) for even n (the packed GELU of K8's dense1).
template <typename BLayout, typename Epi2>
__device__ __forceinline__ void gemm_tc_pairs(int M, int Mp, int N, int K, const bf16* A,
                                              int lda, const bf16* B, int ldb,
                                              float* scratch, Epi2 epi2) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tn = N / 16, ntile = (Mp / 16) * tn;
  float* slot = scratch + warp * 256;
  for (int tile = warp; tile < ntile; tile += blockDim.x >> 5) {
    const int m0 = (tile / tn) * 16, n0 = (tile % tn) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b;
      wmma::load_matrix_sync(a, A + (size_t)m0 * lda + k0, lda);
      wmma::load_matrix_sync(b, B + (size_t)n0 * ldb + k0, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(slot, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int i = 2 * lane; i < 256; i += 64) {
      const int m = m0 + i / 16;
      if (m < M) epi2(m, n0 + i % 16, slot[i], slot[i + 1]);
    }
    __syncwarp();
  }
}

// K8's depthwise 3x3 + second GELU on channel pairs (j, j + 1) of the 64
// interior tokens. kDwBf16: taps, bias and accumulator in bf16 (taps and
// bias staged in sTap as [10][kc], the bias last), each product and add
// rounded; else K2's f32 taps for both channels, rounded to bf16 before a
// bf16 GELU. kGeluBf16: the GELU in bf16, else in f32 on the bf16 sum.
template <bool kDwBf16, bool kGeluBf16>
__device__ __forceinline__ void depthwise_pairs(const Args& a, int k0, int kc, const bf16* sH1,
                                                bf16* sH2, int ldk, const bf16* sTap) {
  const int kp = kc / 2;
  for (int i = threadIdx.x; i < kOut * kp; i += blockDim.x) {
    const int t = i / kp, j = 2 * (i % kp);
    const int r = t / kTileW, c = t % kTileW;
    __nv_bfloat162 z;
    if constexpr (kDwBf16) {
      const __nv_bfloat162* tap = (const __nv_bfloat162*)sTap + j / 2;
      z = tap[9 * kp];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
          z = add2(z, mul2(*(const __nv_bfloat162*)(sH1 + ((r + ky) * kInW + c + kx) * ldk + j),
                           tap[(ky * 3 + kx) * kp]));
    } else {
      const float* w0 = a.wdw + (size_t)(k0 + j) * 9;
      const float* w1 = w0 + 9;
      float acc0 = a.bdw[k0 + j], acc1 = a.bdw[k0 + j + 1];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const bf16* h = sH1 + ((r + ky) * kInW + c + kx) * ldk + j;
          acc0 += to_f(h[0]) * w0[ky * 3 + kx];
          acc1 += to_f(h[1]) * w1[ky * 3 + kx];
        }
      z = __floats2bfloat162_rn(acc0, acc1);
    }
    if constexpr (kGeluBf16)
      z = gelu_bf16x2(z);
    else
      z = __floats2bfloat162_rn(gelu_tanh(__low2float(z)), gelu_tanh(__high2float(z)));
    *(__nv_bfloat162*)(sH2 + t * ldk + j) = z;
  }
}

// kGelu / kDw false: K10's nogelu / nodw (K2 itself is <true, true>);
// kDwBf16 / kGeluBf16 true: K8's variants (with kGelu and kDw true). Their
// taps occupy bf16 [10][kChunkBf16] after Bf16Layout's `total`.
template <bool kGelu, bool kDw, bool kDwBf16 = false, bool kGeluBf16 = false>
__global__ void __launch_bounds__(kThreads) leff_bf16_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int C = a.C, ldc = C + 8, ldacc = C + 4, ldk = kChunkBf16 + 8;
  const Bf16Layout L(C);
  bf16* sY = (bf16*)(smem_raw + L.y);
  float* sAcc = (float*)(smem_raw + L.acc);
  bf16* sH1 = (bf16*)(smem_raw + L.h1);
  bf16* sH2 = (bf16*)(smem_raw + L.h2);
  float* scratch = (float*)(smem_raw + L.scratch);
  bf16* sTap = (bf16*)(smem_raw + L.total);
  const Tile tile(a);
  const bf16* x = (const bf16*)a.x;
  const bf16* w1 = (const bf16*)a.w1;
  const bf16* w2 = (const bf16*)a.w2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int t = warp; t < kInPad; t += kThreads / 32) {
    if (t < kIn && tile.inside(a, t))
      layernorm_row<bf16>(x + tile.pix(a, tile.r0 + t / kInW, tile.c0 + t % kInW), C,
                          a.ln_s, a.ln_b, sY + t * ldc, lane);
    else  // outside the image, and the padding rows of the last WMMA tile
      for (int c = lane; c < C; c += 32) sY[t * ldc + c] = __float2bfloat16(0.f);
  }
  for (int i = threadIdx.x; i < kOut * ldacc; i += blockDim.x) sAcc[i] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < a.Ch; k0 += kChunkBf16) {
    const int kc = min(kChunkBf16, a.Ch - k0);
    if constexpr (kDwBf16)
      for (int i = threadIdx.x; i < 10 * kc; i += blockDim.x) {
        const int tap = i / kc, j = i % kc;
        sTap[i] = __float2bfloat16(tap < 9 ? a.wdw[(size_t)(k0 + j) * 9 + tap] : a.bdw[k0 + j]);
      }
    if constexpr (kGeluBf16)
      gemm_tc_pairs<wmma::col_major>(
          kIn, kInPad, kc, C, sY, ldc, w1 + (size_t)k0 * C, C, scratch,
          [&](int t, int j, float v0, float v1) {
            *(__nv_bfloat162*)(sH1 + t * ldk + j) =
                tile.inside(a, t)
                    ? gelu_bf16x2(__floats2bfloat162_rn(v0 + a.b1[k0 + j], v1 + a.b1[k0 + j + 1]))
                    : __float2bfloat162_rn(0.f);
          });
    else
      gemm_tc<wmma::col_major>(kIn, kInPad, kc, C, sY, ldc, w1 + (size_t)k0 * C, C, scratch,
                               [&](int t, int j, float v) {
                                 sH1[t * ldk + j] = tile.inside(a, t)
                                     ? __float2bfloat16(act<kGelu>(v + a.b1[k0 + j]))
                                     : __float2bfloat16(0.f);
                               });
    __syncthreads();
    if constexpr (kDwBf16 || kGeluBf16)
      depthwise_pairs<kDwBf16, kGeluBf16>(a, k0, kc, sH1, sH2, ldk, sTap);
    else if constexpr (kDw)
      depthwise_gelu<bf16, kGelu>(a, k0, kc, sH1, sH2, ldk);
    else
      pointwise_act<kGelu>(kc, sH1, sH2, ldk);
    __syncthreads();
    gemm_tc_acc(kOut, C, kc, sH2, ldk, w2 + k0, a.Ch, sAcc, ldacc);
    __syncthreads();
  }
  write_out<bf16>(a, tile, sAcc, ldacc);
}

}  // namespace
}  // namespace fbanet
