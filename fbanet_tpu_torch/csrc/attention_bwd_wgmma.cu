// K3's wgmma form: its entries on the post-roll map and on pre-partitioned
// windows (K1b's backward), SKIP = 0 of the kernel in
// attention_bwd_wgmma.cuh, where the kernel and its design are described.
#include "attention_bwd_wgmma.cuh"

namespace fbanet {
namespace {

int launch_k3(const void* w3, const void* wproj, const AbArgs& a, int nwg, void* stream) {
  return nwg == 4   ? launch_nwg<4, 0>(w3, wproj, a, stream)
         : nwg == 2 ? launch_nwg<2, 0>(w3, wproj, a, stream)
                    : launch_nwg<1, 0>(w3, wproj, a, stream);
}

}  // namespace
}  // namespace fbanet

extern "C" {

// Dynamic shared memory of K3's wgmma form with `nwg` warpgroups, or 0 for
// a shape it does not take: 64-token windows, C 64, 128 or 256, head size
// 8, 16, 32 or 64, nwg 4 (or 2 at C <= 128: each warpgroup holds at most one
// 64-column piece of dy), or C = 32 with one head and nwg 1, within
// 232,448 bytes.
int fbanet_window_attention_bwd_wgmma_smem(int n, int C, int heads, int nwg) {
  return fbanet::bwd_wgmma_smem(n, C, heads, nwg);
}

// K3's wgmma form on the post-roll map [B, H, W, C]: w3 = [Wq; Wkv] [3C, C],
// `wpb` windows per block in window order; part holds one row of
// 6C + heads 64 64 floats per block.
int fbanet_window_attention_bwd_wgmma(const void* x, const void* g, void* dx, void* ys,
                                      void* os, void* dqs, void* dkvs, void* part,
                                      const void* ln_s, const void* ln_b, const void* w3,
                                      const void* bq, const void* bkv, const void* wproj,
                                      const void* bias, const void* mask, int B, int H, int W,
                                      int C, int heads, int ws, int residual, int nwg, int wpb,
                                      void* stream) {
  const int n = ws * ws;
  const int smem = fbanet_window_attention_bwd_wgmma_smem(n, C, heads, nwg);
  if (smem == 0 || smem > 232448 || wpb < 1 || H % ws || W % ws)
    return (int)cudaErrorInvalidValue;
  const int nw = (H / ws) * (W / ws);
  const fbanet::AbArgs a{(const fbanet::bf16*)x, (const fbanet::bf16*)g, (fbanet::bf16*)dx,
                         (fbanet::bf16*)ys, (fbanet::bf16*)os, (fbanet::bf16*)dqs,
                         (fbanet::bf16*)dkvs, (float*)part, (const float*)ln_s,
                         (const float*)ln_b, (const float*)bq, (const float*)bkv,
                         (const float*)bias, (const float*)mask,
                         fbanet::WinGeom{H, W, C, ws, n, nw, 0}, heads, residual, B * nw, wpb};
  return fbanet::launch_k3(w3, wproj, a, nwg, stream);
}

// The same on pre-partitioned windows [G, n, C] (K1b's backward): mask
// [nw, n, n] or null, window g masked by mask[g % nw]; no residual.
int fbanet_window_attention_bwd_wgmma_windows(
    const void* x, const void* g, void* dx, void* ys, void* os, void* dqs, void* dkvs,
    void* part, const void* ln_s, const void* ln_b, const void* w3, const void* bq,
    const void* bkv, const void* wproj, const void* bias, const void* mask, int G, int n, int C,
    int heads, int nw, int nwg, int wpb, void* stream) {
  const int smem = fbanet_window_attention_bwd_wgmma_smem(n, C, heads, nwg);
  if (smem == 0 || smem > 232448 || wpb < 1 || nw < 1) return (int)cudaErrorInvalidValue;
  const fbanet::AbArgs a{(const fbanet::bf16*)x, (const fbanet::bf16*)g, (fbanet::bf16*)dx,
                         (fbanet::bf16*)ys, (fbanet::bf16*)os, (fbanet::bf16*)dqs,
                         (fbanet::bf16*)dkvs, (float*)part, (const float*)ln_s,
                         (const float*)ln_b, (const float*)bq, (const float*)bkv,
                         (const float*)bias, (const float*)mask,
                         fbanet::WinGeom{0, 0, C, 0, n, nw, 1}, heads, 0, G, wpb};
  return fbanet::launch_k3(w3, wproj, a, nwg, stream);
}

}  // extern "C"
