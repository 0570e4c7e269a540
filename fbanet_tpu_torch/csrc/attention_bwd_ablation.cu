// K11 on K3's first kernel: K3 on bf16 windows [G, n, C], mask-free, with
// one stage removed at compile time (the kNo* bits of attention_bwd.cuh,
// where the kernel and what each bit removes are described), at the shapes
// ops/attention.py::_attention_bwd_plan keeps on that kernel (and under an
// explicit first-kernel plan); the wgmma form's bits are in
// attention_bwd_wgmma_ablation.cu. Its `full` variant is K3's windowed
// entry itself (fbanet_window_attention_bwd_windows). These instantiations
// live in a file of their own so that nvcc builds them in parallel with
// K3's.
#include "attention_bwd.cuh"

namespace fbanet {
namespace {

BwdKernel ablation_kernel(int skip) {
  switch (skip) {
    case kNoRecompute: return window_attention_bwd_kernel<bf16, kNoRecompute>;
    case kNoDsoftmax: return window_attention_bwd_kernel<bf16, kNoDsoftmax>;
    case kNoWgrads: return window_attention_bwd_kernel<bf16, kNoWgrads>;
    case kNoDx: return window_attention_bwd_kernel<bf16, kNoDx>;
    case kNoCore: return window_attention_bwd_kernel<bf16, kNoCore>;
    default: return nullptr;
  }
}

}  // namespace
}  // namespace fbanet

extern "C" {

// K11 with the stages in `skip` removed (one kNo* bit). `mask` is ignored;
// with kNoWgrads, ys, os and part are not touched.
int fbanet_window_attention_bwd_ablation(const void* x, const void* g, void* dx, void* ys,
                                         void* os, void* dqs, void* dkvs, void* part,
                                         const void* ln_s, const void* ln_b, const void* wq,
                                         const void* bq, const void* wkv, const void* bkv,
                                         const void* wproj, const void* bias,
                                         const void* mask, int G, int n, int C, int heads,
                                         int skip, void* stream) {
  using namespace fbanet;
  (void)mask;
  const BwdKernel kern = ablation_kernel(skip);
  if (kern == nullptr || C % heads || n % 16 || C % 16 || (C / heads) % 16)
    return (int)cudaErrorInvalidValue;
  const int gw = pick_group(n, C, heads, true, skip);
  if (gw == 0) return (int)cudaErrorInvalidValue;
  const BwdArgs a{x, g, dx, ys, os, dqs, dkvs, (float*)part,
                  (const float*)ln_s, (const float*)ln_b, wq, wkv, wproj,
                  (const float*)bq, (const float*)bkv, (const float*)bias,
                  nullptr, WinGeom{0, 0, C, 0, n, 1, 1}, heads, 0, gw};
  return launch_bwd(kern, a, (unsigned)G, true, (skip & kNoCore) != 0, stream);
}

}  // extern "C"
