// K3's entries: the backward of K1 on the post-roll map and of K1b on
// pre-partitioned windows, in f32 and bf16. The kernel and its notes are in
// attention_bwd.cuh; K11's instantiations of it are in
// attention_bwd_ablation.cu, a file of their own so that nvcc builds them in
// parallel with these.
#include "attention_bwd.cuh"

namespace fbanet {
namespace {

// K3's instantiation for the compute type and head size dh.
BwdKernel kernel_for(int use_bf16, int dh) {
  if (use_bf16)
    return head_pitch(dh) == dh ? window_attention_bwd_kernel<bf16, 0>
                                : window_attention_bwd_kernel<bf16, 0, true>;
  return window_attention_bwd_kernel<float, 0>;
}

}  // namespace
}  // namespace fbanet

extern "C" {

// Head-group width the kernel uses, or 0 for a shape it does not take (the
// bf16 kernel tiles by 16: tokens, C and a head group; head sizes in
// multiples of 8, padded to 16; no group may fit). `skip`: the stages a K11
// variant removes (0 for K3).
int fbanet_window_attention_bwd_group(int n, int C, int heads, int bf16, int skip) {
  if (C % heads) return 0;
  if (bf16 && (n % 16 || C % 16 || (C / heads) % 8)) return 0;
  return fbanet::pick_group(n, C, heads, bf16 != 0, skip);
}

// K3 on the post-roll map [B, H, W, C].
int fbanet_window_attention_bwd(const void* x, const void* g, void* dx, void* ys, void* os,
                                void* dqs, void* dkvs, void* part, const void* ln_s,
                                const void* ln_b, const void* wq, const void* bq,
                                const void* wkv, const void* bkv, const void* wproj,
                                const void* bias, const void* mask, int B, int H, int W,
                                int C, int heads, int ws, int residual, int bf16,
                                void* stream) {
  const int n = ws * ws, nw = (H / ws) * (W / ws);
  const int gw = fbanet_window_attention_bwd_group(n, C, heads, bf16, 0);
  if (gw == 0) return (int)cudaErrorInvalidValue;
  const fbanet::BwdArgs a{x, g, dx, ys, os, dqs, dkvs, (float*)part,
                          (const float*)ln_s, (const float*)ln_b, wq, wkv, wproj,
                          (const float*)bq, (const float*)bkv, (const float*)bias,
                          (const float*)mask, fbanet::WinGeom{H, W, C, ws, n, nw, 0},
                          heads, residual, gw};
  return fbanet::launch_bwd(fbanet::kernel_for(bf16, C / heads), a, (unsigned)B * nw,
                            bf16 != 0, false, stream);
}

// K3 on pre-partitioned windows [G, n, C] (K1b's backward): mask [nw, n, n]
// or null, window g masked by mask[g % nw]; no residual.
int fbanet_window_attention_bwd_windows(const void* x, const void* g, void* dx, void* ys,
                                        void* os, void* dqs, void* dkvs, void* part,
                                        const void* ln_s, const void* ln_b, const void* wq,
                                        const void* bq, const void* wkv, const void* bkv,
                                        const void* wproj, const void* bias, const void* mask,
                                        int G, int n, int C, int heads, int nw, int bf16,
                                        void* stream) {
  const int gw = fbanet_window_attention_bwd_group(n, C, heads, bf16, 0);
  if (gw == 0 || nw < 1) return (int)cudaErrorInvalidValue;
  const fbanet::BwdArgs a{x, g, dx, ys, os, dqs, dkvs, (float*)part,
                          (const float*)ln_s, (const float*)ln_b, wq, wkv, wproj,
                          (const float*)bq, (const float*)bkv, (const float*)bias,
                          (const float*)mask, fbanet::WinGeom{0, 0, C, 0, n, nw, 1},
                          heads, 0, gw};
  return fbanet::launch_bwd(fbanet::kernel_for(bf16, C / heads), a, (unsigned)G,
                            bf16 != 0, false, stream);
}

}  // extern "C"
