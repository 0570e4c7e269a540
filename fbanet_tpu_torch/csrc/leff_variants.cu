// K8: K2's function (fused norm2 -> dense C->4C -> tanh-GELU -> depthwise
// 3x3 -> tanh-GELU -> dense 4C->C) on a bf16 [B, H, W, C] map, no residual,
// with the depthwise stage and/or both GELUs in packed bf16 arithmetic. The
// counterpart of the TPU kernel scripts/measure_swin_variants.py::
// _leff_var_kernel (launched by variant_leff), which asks whether the TPU's
// vector unit gains from packing bf16 two to a lane. On the H100 the same
// question is whether __nv_bfloat162 arithmetic (two hidden channels per
// instruction) speeds up K2's GELUs and depthwise conv.
//
// The variants are compile-time flags of K2's two forms: dwbf16 (depthwise
// taps, bias and accumulator in bf16, each product and add rounded, the
// script's :382-387), gelubf16 (both GELUs evaluated in bf16, :375-378 and
// :388-389), bothbf16. On the wgmma form (leff_wgmma.cuh, DWBF16 /
// GELUBF16) at the plans ops/leff.py::_leff_plan gives it; on the first
// kernel (leff.cuh, kDwBf16 / kGeluBf16) at the shapes that plan keeps
// there. With both flags off the entry launches K2's own instantiation of
// the form, so it is bitwise K2 (no residual). What bounds it on the H100:
// arithmetic, as K2.
#include "leff.cuh"
#include "leff_wgmma.cuh"

namespace fbanet {
namespace {

using Kernel = void (*)(Args);

Kernel variant_kernel(int variant) {
  switch (variant) {
    case 0: return leff_bf16_kernel<true, true>;
    case 1: return leff_bf16_kernel<true, true, true, false>;
    case 2: return leff_bf16_kernel<true, true, false, true>;
    case 3: return leff_bf16_kernel<true, true, true, true>;
    default: return nullptr;
  }
}

// K8 on the first kernel (w2 in torch Linear layout [C, Ch]).
int launch_first(const Args& a, int B, int variant, void* stream) {
  const Kernel kern = variant_kernel(variant);
  if (kern == nullptr || a.C % 16 || a.Ch % 16) return (int)cudaErrorInvalidValue;
  const int smem = (int)(Bf16Layout(a.C).total +
                         (variant & 1 ? sizeof(bf16) * 10 * kChunkBf16 : 0));
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

// K8 on a bf16 map, no residual. variant: 0 no flag (K2's instantiation),
// 1 dwbf16, 2 gelubf16, 3 bothbf16. th, tw, kc: the plan of K2's wgmma form
// (w2 then W2^T [Ch, C]; th x tw dividing H x W, kc dividing Ch), or th = 0
// for the first kernel (w2 in torch Linear layout; C and the hidden width
// multiples of 16).
int fbanet_leff_variant(const void* x, void* out, const void* ln_s, const void* ln_b,
                        const void* w1, const void* b1, const void* wdw, const void* bdw,
                        const void* w2, const void* b2, int B, int H, int W, int C, int Ch,
                        int variant, int th, int tw, int kc, void* stream) {
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
    case 1: return launch_leff_form<true, false>(w1, w2, a, B, th, tw, kc, stream);
    case 2: return launch_leff_form<false, true>(w1, w2, a, B, th, tw, kc, stream);
    case 3: return launch_leff_form<true, true>(w1, w2, a, B, th, tw, kc, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
