// K9 on K1's wgmma form at head size 16 with four warpgroups, weights
// streamed or staged: the other half of attention_ablation_wgmma.cu's
// instantiations (where the variants are described), in a file of its own
// so that nvcc builds the two halves in parallel. Reached through
// fbanet_attention_ablation_wgmma.
#include "attention_wgmma.cuh"

namespace fbanet {
namespace {

template <bool STAGED>
int launch16(int core, const void* w3, const void* wproj, const AfArgs& a, void* stream) {
  return core == kWgNoSoftmax ? launch_one<16, 4, STAGED, kWgNoSoftmax>(w3, wproj, a, stream)
                              : launch_one<16, 4, STAGED, kWgNoCore>(w3, wproj, a, stream);
}

}  // namespace
}  // namespace fbanet

extern "C" {

// `core` kWgNoSoftmax or kWgNoCore, `args` the caller's AfArgs (the same
// header's layout), four warpgroups.
int fbanet_attention_ablation_wgmma16(int core, const void* w3, const void* wproj,
                                      const void* args, int staged, void* stream) {
  const fbanet::AfArgs& a = *static_cast<const fbanet::AfArgs*>(args);
  return staged ? fbanet::launch16<true>(core, w3, wproj, a, stream)
                : fbanet::launch16<false>(core, w3, wproj, a, stream);
}

}  // extern "C"
