// K9 on K1's wgmma form: K1's function (fused norm1 -> q | k | v -> per-head
// softmax(q k^T dh^-1/2 + bias) v -> output projection) on a bf16
// [B, H, W, C] map, mask-free, no residual, with one stage taken out at
// compile time. The counterpart of the TPU kernel
// scripts/measure_swin_rates.py::_abl_kernel (launched by abl_attention),
// whose variants split K1's time by stage; here they split the time of the
// form K1's plan (ops/attention.py::_attention_plan) picks. The first
// kernel's variants, for the shapes that plan keeps there, are
// fbanet_window_attention_ablation in attention.cu.
//
// The variants (the changed math is deliberate):
//  - full: K1 itself, through K1's entry (mask-free, no residual);
//  - nosoftmax: the CORE kWgNoSoftmax of attention_wgmma.cuh, p = round(l /
//    64) in place of the softmax, o = p v not scaled;
//  - nocore: the CORE kWgNoCore, o = round(round(q + k) + v), no logits and
//    no p v;
//  - notrans: K1 over the map's memory read as consecutive 64-token windows
//    (window g = tokens 64 g .. 64 g + 63 of the row-major map, the script's
//    `x4.reshape(gb, n, c)`): K1b's entry, which is that addressing.
// Only the (head size, warpgroups, staged) triples the plan picks at the
// five groups are built, as for K7: (64, 2, 1), (64, 4, 1) here and
// (16, 4, 0), (16, 4, 1) in attention_ablation_wgmma16.cu, a file of its
// own so that nvcc builds the two halves in parallel. What bounds it on the
// H100: arithmetic, as K1.
#include "attention_wgmma.cuh"

extern "C" {
int fbanet_attention_ablation_wgmma16(int core, const void* w3, const void* wproj,
                                      const void* args, int staged, void* stream);
int fbanet_window_attention_wgmma_smem(int n, int C, int heads, int nwg, int staged);
int fbanet_window_attention_wgmma(const void* x, void* out, const void* ln_s, const void* ln_b,
                                  const void* w3, const void* bq, const void* bkv,
                                  const void* wproj, const void* bproj, const void* bias,
                                  const void* mask, int B, int H, int W, int C, int heads,
                                  int ws, int residual, int nwg, int wpb, int staged,
                                  void* stream);
int fbanet_window_attention_wgmma_windows(const void* x, void* out, const void* ln_s,
                                          const void* ln_b, const void* w3, const void* bq,
                                          const void* bkv, const void* wproj,
                                          const void* bproj, const void* bias, const void* mask,
                                          int G, int n, int C, int heads, int nw, int nwg,
                                          int wpb, int staged, void* stream);
}

namespace fbanet {
namespace {

int ablation_smem(int n, int C, int heads, int variant, int nwg, int staged) {
  if (variant < 0 || variant > 3 || heads < 1 || C % heads) return 0;
  const int dh = C / heads;
  if (!((dh == 64 && staged == 1 && (nwg == 2 || nwg == 4)) ||
        (dh == 16 && nwg == 4 && (staged == 0 || staged == 1))))
    return 0;
  return fbanet_window_attention_wgmma_smem(n, C, heads, nwg, staged);  // K1's layout
}

template <int NWG>
int launch64(int core, const void* w3, const void* wproj, const AfArgs& a, void* stream) {
  return core == kWgNoSoftmax ? launch_one<64, NWG, true, kWgNoSoftmax>(w3, wproj, a, stream)
                              : launch_one<64, NWG, true, kWgNoCore>(w3, wproj, a, stream);
}

}  // namespace
}  // namespace fbanet

extern "C" {

// Dynamic shared memory of K9's `variant` (0 full, 1 nosoftmax, 2 nocore,
// 3 notrans) on K1's wgmma form with `nwg` warpgroups and the weights
// staged or streamed (K1's own), or 0 for a shape it does not take
// (64-token windows, an instantiated triple, at most 232,448 bytes).
int fbanet_attention_ablation_wgmma_smem(int n, int C, int heads, int variant, int nwg,
                                         int staged) {
  return fbanet::ablation_smem(n, C, heads, variant, nwg, staged);
}

// K9 on K1's wgmma form on a bf16 map [B, H, W, C], mask-free, no
// residual: w3 = [Wq; Wkv] [3C, C], bias [heads, n, n] f32, `variant` as
// above, K1's plan (nwg, wpb windows per block, staged).
int fbanet_attention_ablation_wgmma(const void* x, void* out, const void* ln_s,
                                    const void* ln_b, const void* w3, const void* bq,
                                    const void* bkv, const void* wproj, const void* bproj,
                                    const void* bias, int B, int H, int W, int C, int heads,
                                    int ws, int variant, int nwg, int wpb, int staged,
                                    void* stream) {
  using namespace fbanet;
  const int n = ws * ws;
  if (ablation_smem(n, C, heads, variant, nwg, staged) == 0 || wpb < 1 || H % ws || W % ws)
    return (int)cudaErrorInvalidValue;
  if (variant == 0)
    return fbanet_window_attention_wgmma(x, out, ln_s, ln_b, w3, bq, bkv, wproj, bproj, bias,
                                         nullptr, B, H, W, C, heads, ws, 0, nwg, wpb, staged,
                                         stream);
  if (variant == 3)
    return fbanet_window_attention_wgmma_windows(x, out, ln_s, ln_b, w3, bq, bkv, wproj, bproj,
                                                 bias, nullptr, B * H * W / n, n, C, heads, 1,
                                                 nwg, wpb, staged, stream);
  const int nw = (H / ws) * (W / ws);
  const AfArgs a{(const bf16*)x, (bf16*)out, (const float*)ln_s, (const float*)ln_b,
                 (const float*)bq, (const float*)bkv, (const float*)bproj, (const float*)bias,
                 nullptr, WinGeom{H, W, C, ws, n, nw, 0}, heads, 0, B * nw, wpb};
  const int core = variant == 1 ? kWgNoSoftmax : kWgNoCore;
  if (C / heads == 16) return fbanet_attention_ablation_wgmma16(core, w3, wproj, &a, staged, stream);
  return nwg == 4 ? launch64<4>(core, w3, wproj, a, stream) : launch64<2>(core, w3, wproj, a, stream);
}

}  // extern "C"
