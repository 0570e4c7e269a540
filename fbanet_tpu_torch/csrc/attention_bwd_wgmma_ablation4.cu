// K11 on K3's wgmma form with four warpgroups: the other half of
// attention_bwd_wgmma_ablation.cu's instantiations, in a file of its own so
// that nvcc builds the two halves in parallel. Reached through
// fbanet_window_attention_bwd_wgmma_ablation.
#include "attention_bwd_wgmma.cuh"

extern "C" {

int fbanet_window_attention_bwd_wgmma_ablation4(
    const void* x, const void* g, void* dx, void* ys, void* os, void* dqs, void* dkvs,
    void* part, const void* ln_s, const void* ln_b, const void* w3, const void* bq,
    const void* bkv, const void* wproj, const void* bias, int G, int n, int C, int heads,
    int wpb, int skip, void* stream) {
  return fbanet::launch_ablation<4>(x, g, dx, ys, os, dqs, dkvs, part, ln_s, ln_b, w3, bq, bkv,
                                    wproj, bias, G, n, C, heads, wpb, skip, stream);
}

}  // extern "C"
