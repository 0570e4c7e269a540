// K7 on K1's wgmma form at head size 16 with four warpgroups, weights
// streamed or staged: the other half of attention_variants_wgmma.cu's
// instantiations (where the cores and their mapping are described), in a
// file of its own so that nvcc builds the two halves in parallel. Reached
// through fbanet_attention_variant_wgmma.
#include "attention_wgmma.cuh"

namespace fbanet {
namespace {

template <bool STAGED>
int launch16(int core, const void* w3, const void* wproj, const AfArgs& a, void* stream) {
  switch (core) {
    case kWgLoop: return launch_one<16, 4, STAGED, kWgLoop>(w3, wproj, a, stream);
    case kWgLoopLn: return launch_one<16, 4, STAGED, kWgLoopLn>(w3, wproj, a, stream);
    case kWgStack: return launch_one<16, 4, STAGED, kWgStack>(w3, wproj, a, stream);
    case kWgStackLn: return launch_one<16, 4, STAGED, kWgStackLn>(w3, wproj, a, stream);
    case kWgLanepack: return launch_one<16, 4, STAGED, kWgLanepack>(w3, wproj, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace fbanet

extern "C" {

// `core` the instantiation's (already mapped), `args` the caller's AfArgs
// (the same header's layout), four warpgroups.
int fbanet_attention_variant_wgmma16(int core, const void* w3, const void* wproj,
                                     const void* args, int staged, void* stream) {
  const fbanet::AfArgs& a = *static_cast<const fbanet::AfArgs*>(args);
  return staged ? fbanet::launch16<true>(core, w3, wproj, a, stream)
                : fbanet::launch16<false>(core, w3, wproj, a, stream);
}

}  // extern "C"
