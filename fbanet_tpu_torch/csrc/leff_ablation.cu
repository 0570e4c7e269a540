// K10: K2's function (fused norm2 -> dense C->4C -> tanh-GELU -> depthwise
// 3x3 -> tanh-GELU -> dense 4C->C) on a bf16 [B, H, W, C] map, no residual,
// with one stage changed at compile time. The counterpart of the TPU kernel
// scripts/measure_swin_rates.py::_leff_abl_kernel (launched by abl_leff),
// which splits K2's time by stage: nogelu (both GELUs become x * 0.7) and
// nodw (no depthwise 3x3: h2 = act(h1) on the tile's own tokens; dense1
// still runs on the halo, as the script's does). The changed math is
// deliberate.
//
// The variants are compile-time flags of K2's two forms: on the wgmma form
// (leff_wgmma.cuh, NOGELU / NODW) at the plans ops/leff.py::_leff_plan
// gives it; on the first kernel (leff.cuh, kGelu / kDw) at the shapes that
// plan keeps there. `full` launches K2's own instantiation of the form, so
// it is bitwise K2 (no residual). What bounds it on the H100: arithmetic,
// as K2.
#include "leff.cuh"
#include "leff_wgmma.cuh"

namespace fbanet {
namespace {

using Kernel = void (*)(Args);

Kernel ablation_kernel(int variant) {
  switch (variant) {
    case 0: return leff_bf16_kernel<true, true>;
    case 1: return leff_bf16_kernel<false, true>;
    case 2: return leff_bf16_kernel<true, false>;
    default: return nullptr;
  }
}

// K10 on the first kernel (w2 in torch Linear layout [C, Ch]).
int launch_first(const Args& a, int B, int variant, void* stream) {
  const Kernel kern = ablation_kernel(variant);
  if (kern == nullptr || a.C % 16 || a.Ch % 16) return (int)cudaErrorInvalidValue;
  const int smem = (int)Bf16Layout(a.C).total;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid =
      (unsigned)B * ((a.H + kTileH - 1) / kTileH) * ((a.W + kTileW - 1) / kTileW);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fbanet

extern "C" {

// K10 on a bf16 map, no residual. variant: 0 full (K2's instantiation of
// the form), 1 nogelu, 2 nodw. th, tw, kc: the plan of K2's wgmma form (w2
// then W2^T [Ch, C]; th x tw dividing H x W, kc dividing Ch), or th = 0 for
// the first kernel (w2 in torch Linear layout; C and the hidden width
// multiples of 16).
int fbanet_leff_ablation(const void* x, void* out, const void* ln_s, const void* ln_b,
                         const void* w1, const void* b1, const void* wdw, const void* bdw,
                         const void* w2, const void* b2, int B, int H, int W, int C,
                         int Ch, int variant, int th, int tw, int kc, void* stream) {
  using namespace fbanet;
  if (th == 0) {
    const Args a{x, out, (const float*)ln_s, (const float*)ln_b, w1, w2,
                 (const float*)b1, (const float*)wdw, (const float*)bdw,
                 (const float*)b2, H, W, C, Ch, 0};
    return launch_first(a, B, variant, stream);
  }
  if (th < 0 || tw < 1 || kc < 1 || H % th || W % tw || Ch % kc)
    return (int)cudaErrorInvalidValue;
  const FwArgs a{(const bf16*)x, (bf16*)out, (const float*)ln_s, (const float*)ln_b,
                 (const float*)b1, (const float*)wdw, (const float*)bdw, (const float*)b2,
                 H, W, C, Ch, 0};
  switch (variant) {
    case 0: return launch_leff_form<false, false>(w1, w2, a, B, th, tw, kc, stream);
    case 1: return launch_leff_form<false, false, true, false>(w1, w2, a, B, th, tw, kc, stream);
    case 2: return launch_leff_form<false, false, false, true>(w1, w2, a, B, th, tw, kc, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
