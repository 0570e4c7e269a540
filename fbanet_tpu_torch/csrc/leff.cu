// K2: fused LeFF (norm2 -> dense C->Ch -> tanh-GELU -> depthwise 3x3, zero
// padding -> tanh-GELU -> dense Ch->C [+ residual]) on [B, H, W, C].
//
// Replaces the TPU kernel fbanet_tpu/ops/leff_pallas.py::_leff_kernel
// (launched by _pallas_forward). Rounding points follow it: LN in f32
// rounded to the compute type; h1 = gelu(f32 product + f32 bias) rounded;
// the depthwise taps and bias in f32 with an f32 accumulator; h2 = gelu(acc)
// rounded; f32-accumulated dense2 + f32 bias, residual in f32.
//
// What bounds it on the H100: arithmetic (16 C^2 flops per token against
// 4 C bytes of bf16 in and out, ~1000-4000 flops per byte). What the design
// does: the 4C hidden tensor never reaches device memory, the whole point
// of the TPU kernel. One block owns an 8 x 8 output tile of one image; it
// normalises the 10 x 10 tile with its +-1 halo once, then walks the hidden
// channels in chunks: dense1 of the chunk on all 100 halo tokens, GELU, the
// 3x3 depthwise conv of the chunk (exact per chunk, since it is per
// channel) on the 64 interior tokens, GELU, and dense2's partial product
// accumulated into an f32 [64, C] tile in shared memory. Halo tokens
// outside the image hold h1 = 0, the conv's zero padding. In bf16 both
// dense products run on the tensor cores (WMMA 16x16x16, f32 accumulation;
// the 100 halo rows pad to 112); in f32 they are register-tiled FMAs on the
// CUDA cores. The halo recompute costs 100/64 of dense1; larger tiles and a
// wgmma pipeline are later work.
//
// K10 (fbanet_leff_ablation) is the bf16 kernel with one stage changed at
// compile time, the counterpart of the ablation copy
// scripts/measure_swin_rates.py::_leff_abl_kernel (no residual): nogelu
// (both GELUs become x 0.7) and nodw (no depthwise 3x3: h2 = act(h1) on the
// tile's own tokens; dense1 still runs on the halo, as the script's does).
// Its `full` variant is K2's own instantiation. The changed math is
// deliberate: the variants exist to split K2's time by stage.
#include "common.cuh"

namespace fbanet {
namespace {

constexpr int kTileH = 8, kTileW = 8;
constexpr int kInH = kTileH + 2, kInW = kTileW + 2;
constexpr int kIn = kInH * kInW, kOut = kTileH * kTileW;
constexpr int kInPad = 112;  // kIn rounded up to the 16-row WMMA tile
constexpr int kChunkF32 = 32, kChunkBf16 = 64;  // hidden channels per pass

inline size_t leff_f32_smem(int C) {
  return sizeof(float) * ((size_t)(kIn + kOut) * (C + 1) +
                          (size_t)(kIn + kOut) * (kChunkF32 + 1));
}

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

__global__ void __launch_bounds__(kThreads) leff_f32_kernel(Args a) {
  extern __shared__ float smem[];
  const int C = a.C, ldc = C + 1, ldk = kChunkF32 + 1;
  float* sY = smem;                // [kIn][ldc] LN output of the halo tile
  float* sAcc = sY + kIn * ldc;    // [kOut][ldc] dense2 accumulator
  float* sH1 = sAcc + kOut * ldc;  // [kIn][ldk] h1 chunk
  float* sH2 = sH1 + kIn * ldk;    // [kOut][ldk] h2 chunk
  const Tile tile(a);
  const float* x = (const float*)a.x;
  const float* w1 = (const float*)a.w1;
  const float* w2 = (const float*)a.w2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int t = warp; t < kIn; t += kThreads / 32) {
    if (tile.inside(a, t))
      layernorm_row<float>(x + tile.pix(a, tile.r0 + t / kInW, tile.c0 + t % kInW), C,
                           a.ln_s, a.ln_b, sY + t * ldc, lane);
    else
      for (int c = lane; c < C; c += 32) sY[t * ldc + c] = 0.f;
  }
  for (int i = threadIdx.x; i < kOut * ldc; i += blockDim.x) sAcc[i] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < a.Ch; k0 += kChunkF32) {
    const int kc = min(kChunkF32, a.Ch - k0);
    gemm_nt(kIn, kc, C, sY, ldc, w1 + (size_t)k0 * C, C, 1, [&](int t, int j, float v) {
      sH1[t * ldk + j] = tile.inside(a, t) ? gelu_tanh(v + a.b1[k0 + j]) : 0.f;
    });
    __syncthreads();
    depthwise_gelu<float, true>(a, k0, kc, sH1, sH2, ldk);
    __syncthreads();
    // dense2 partial: B[o][j] = w2[o * Ch + k0 + j]
    gemm_nt(kOut, C, kc, sH2, ldk, w2 + k0, a.Ch, 1, [&](int t, int o, float v) {
      sAcc[t * ldc + o] += v;
    });
    __syncthreads();
  }
  write_out<float>(a, tile, sAcc, ldc);
}

// kGelu / kDw false: K10's nogelu / nodw (K2 itself is <true, true>).
template <bool kGelu, bool kDw>
__global__ void __launch_bounds__(kThreads) leff_bf16_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int C = a.C, ldc = C + 8, ldacc = C + 4, ldk = kChunkBf16 + 8;
  const Bf16Layout L(C);
  bf16* sY = (bf16*)(smem_raw + L.y);
  float* sAcc = (float*)(smem_raw + L.acc);
  bf16* sH1 = (bf16*)(smem_raw + L.h1);
  bf16* sH2 = (bf16*)(smem_raw + L.h2);
  float* scratch = (float*)(smem_raw + L.scratch);
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
    gemm_tc<wmma::col_major>(kIn, kInPad, kc, C, sY, ldc, w1 + (size_t)k0 * C, C, scratch,
                             [&](int t, int j, float v) {
                               sH1[t * ldk + j] = tile.inside(a, t)
                                   ? __float2bfloat16(act<kGelu>(v + a.b1[k0 + j]))
                                   : __float2bfloat16(0.f);
                             });
    __syncthreads();
    if constexpr (kDw)
      depthwise_gelu<bf16, kGelu>(a, k0, kc, sH1, sH2, ldk);
    else
      pointwise_act<kGelu>(kc, sH1, sH2, ldk);
    __syncthreads();
    gemm_tc_acc(kOut, C, kc, sH2, ldk, w2 + k0, a.Ch, sAcc, ldacc);
    __syncthreads();
  }
  write_out<bf16>(a, tile, sAcc, ldacc);
}

using Kernel = void (*)(Args);

int launch(Kernel kern, const Args& a, int B, int smem, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)B * ((a.H + kTileH - 1) / kTileH) *
                        ((a.W + kTileW - 1) / kTileW);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

Kernel production_kernel(int use_bf16) {
  if (use_bf16) return leff_bf16_kernel<true, true>;
  return leff_f32_kernel;
}

Kernel ablation_kernel(int variant) {
  switch (variant) {
    case 1: return leff_bf16_kernel<false, true>;
    case 2: return leff_bf16_kernel<true, false>;
    default: return leff_bf16_kernel<true, true>;
  }
}

}  // namespace
}  // namespace fbanet

extern "C" {

// Dynamic shared memory of one block, or 0 for a shape the kernel does not
// take (the bf16 kernel tiles C and the hidden width by 16).
int fbanet_leff_smem(int C, int Ch, int bf16) {
  if (bf16 && (C % 16 || Ch % 16)) return 0;
  return (int)(bf16 ? fbanet::Bf16Layout(C).total : fbanet::leff_f32_smem(C));
}

int fbanet_leff(const void* x, void* out, const void* ln_s, const void* ln_b,
                const void* w1, const void* b1, const void* wdw, const void* bdw,
                const void* w2, const void* b2, int B, int H, int W, int C, int Ch,
                int residual, int bf16, void* stream) {
  const int smem = fbanet_leff_smem(C, Ch, bf16);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const fbanet::Args a{x, out, (const float*)ln_s, (const float*)ln_b, w1, w2,
                       (const float*)b1, (const float*)wdw, (const float*)bdw,
                       (const float*)b2, H, W, C, Ch, residual};
  return fbanet::launch(fbanet::production_kernel(bf16), a, B, smem, stream);
}

// K10 on a bf16 map, no residual. variant: 0 full (K2's instantiation),
// 1 nogelu, 2 nodw.
int fbanet_leff_ablation(const void* x, void* out, const void* ln_s, const void* ln_b,
                         const void* w1, const void* b1, const void* wdw, const void* bdw,
                         const void* w2, const void* b2, int B, int H, int W, int C,
                         int Ch, int variant, void* stream) {
  const int smem = fbanet_leff_smem(C, Ch, 1);
  if (smem == 0 || variant < 0 || variant > 2) return (int)cudaErrorInvalidValue;
  const fbanet::Args a{x, out, (const float*)ln_s, (const float*)ln_b, w1, w2,
                       (const float*)b1, (const float*)wdw, (const float*)bdw,
                       (const float*)b2, H, W, C, Ch, 0};
  return fbanet::launch(fbanet::ablation_kernel(variant), a, B, smem, stream);
}

}  // extern "C"
