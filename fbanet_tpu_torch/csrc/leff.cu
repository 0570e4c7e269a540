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
// The bf16 kernel and its stages live in leff.cuh, and the wgmma form
// (bf16; ops/leff.py::_leff_plan picks the form and tile per shape; the
// kernel above stays for f32 and for bf16 shapes the plan does not send
// there) in leff_wgmma.cuh, so that K8 (leff_variants.cu, packed-bf16
// flags of both forms) and K10 (leff_ablation.cu, stage ablations of both
// forms) build in files of their own. The wgmma form's entries are below.
#include "leff.cuh"
#include "leff_wgmma.cuh"

#include <cstdint>

namespace fbanet {
namespace {

inline size_t leff_f32_smem(int C) {
  return sizeof(float) * ((size_t)(kIn + kOut) * (C + 1) +
                          (size_t)(kIn + kOut) * (kChunkF32 + 1));
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

// Dynamic shared memory of the wgmma form for tile th x tw and hidden chunk
// kc, or 0 for one it does not take (leff_wgmma_smem: C 64, 128 or 256 with
// the forms (th, tw, kc) = (16, 8, 64), (16, 8, 32), (8, 8, 64), (8, 8, 32)
// and at most four 64 x 64 pieces of out per tile; C = 32 with (16, 16,
// 64), (16, 16, 32), (16, 8, 64), (16, 8, 32)).
int fbanet_leff_wgmma_smem(int C, int th, int tw, int kc) {
  return fbanet::leff_wgmma_smem(C, th, tw, kc);
}

// K2's wgmma form on a bf16 map: w2t = W2^T [Ch, C]; th x tw tiles dividing
// H x W, hidden chunk kc dividing Ch.
int fbanet_leff_wgmma(const void* x, void* out, const void* ln_s, const void* ln_b,
                      const void* w1, const void* b1, const void* wdw, const void* bdw,
                      const void* w2t, const void* b2, int B, int H, int W, int C, int Ch,
                      int residual, int th, int tw, int kc, void* stream) {
  using namespace fbanet;
  if (th < 1 || tw < 1 || kc < 1 || H % th || W % tw || Ch % kc)
    return (int)cudaErrorInvalidValue;
  const FwArgs a{(const bf16*)x, (bf16*)out, (const float*)ln_s, (const float*)ln_b,
                 (const float*)b1, (const float*)wdw, (const float*)bdw, (const float*)b2,
                 H, W, C, Ch, residual};
  return launch_leff_form<false, false, false, false, true>(w1, w2t, a, B, th, tw, kc, stream);
}

}  // extern "C"
