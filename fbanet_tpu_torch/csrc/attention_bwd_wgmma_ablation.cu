// K11 on K3's wgmma form: the attention backward on bf16 windows
// [G, 64, C], mask-free, no residual, with one stage removed at compile
// time (the SKIP bits of attention_bwd_wgmma.cuh, where the kernel and what
// each bit removes are described). Its `full` variant is K3's windowed
// entry itself (fbanet_window_attention_bwd_wgmma_windows). The five bits
// are instantiated at both head sizes here for two warpgroups and in
// attention_bwd_wgmma_ablation4.cu for four (every pair
// ops/attention.py::_attention_bwd_plan can pick), files of their own so
// that nvcc builds them in parallel with K3's and with each other. The
// first kernel's bits, for the shapes that plan keeps on it, are in
// attention_bwd_ablation.cu.
#include "attention_bwd_wgmma.cuh"

extern "C" {

// K11 with four warpgroups (attention_bwd_wgmma_ablation4.cu).
int fbanet_window_attention_bwd_wgmma_ablation4(
    const void* x, const void* g, void* dx, void* ys, void* os, void* dqs, void* dkvs,
    void* part, const void* ln_s, const void* ln_b, const void* w3, const void* bq,
    const void* bkv, const void* wproj, const void* bias, int G, int n, int C, int heads,
    int wpb, int skip, void* stream);

// K11 on the wgmma form with `nwg` warpgroups and `wpb` windows per block:
// the pointers of fbanet_window_attention_bwd_wgmma_windows (`mask` is
// ignored; with kNoWgrads ys, os, dqs, dkvs and part are not touched),
// `skip` one kNo* bit.
int fbanet_window_attention_bwd_wgmma_ablation(
    const void* x, const void* g, void* dx, void* ys, void* os, void* dqs, void* dkvs,
    void* part, const void* ln_s, const void* ln_b, const void* w3, const void* bq,
    const void* bkv, const void* wproj, const void* bias, const void* mask, int G, int n, int C,
    int heads, int nwg, int wpb, int skip, void* stream) {
  (void)mask;
  if (nwg == 4)
    return fbanet_window_attention_bwd_wgmma_ablation4(x, g, dx, ys, os, dqs, dkvs, part, ln_s,
                                                       ln_b, w3, bq, bkv, wproj, bias, G, n, C,
                                                       heads, wpb, skip, stream);
  if (nwg != 2) return (int)cudaErrorInvalidValue;
  return fbanet::launch_ablation<2>(x, g, dx, ys, os, dqs, dkvs, part, ln_s, ln_b, w3, bq, bkv,
                                    wproj, bias, G, n, C, heads, wpb, skip, stream);
}

}  // extern "C"
