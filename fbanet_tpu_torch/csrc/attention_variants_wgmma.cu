// K7 on K1's wgmma form: K1's function (fused norm1 -> q | k | v -> per-head
// softmax(q k^T dh^-1/2 + bias) v -> output projection) on a bf16
// [B, H, W, C] map, mask-free, no residual, with the per-head core chosen at
// compile time (CORE of attention_wgmma.cuh, where each core is described).
// The counterpart of the TPU kernel scripts/measure_swin_variants.py::
// _var_kernel (launched by variant_attention), which times rewrites of K1's
// head stage; here they are rewrites of the head stage of the form K1's plan
// (ops/attention.py::_attention_plan) picks. The first kernel's cores, for
// the shapes that plan keeps there, are in attention_variants.cu.
//
// Which instantiation a core runs: loop_ln is K1's own (kWgLoopLn); stack3d
// and stack3d_ln are loop and loop_ln wherever a warpgroup holds one head
// (head size 64 at the instantiated shapes, or heads <= warpgroups), since
// stacking two heads per stage then changes nothing; ln+qkv1 is stack3d_ln
// (this form already forms q | k | v in one product over [Wq; Wkv]); ln+nr2
// is the plan with 2 windows per block. Only the (head size, warpgroups,
// staged) triples the plan picks at the five groups are built: (64, 2, 1),
// (64, 4, 1) here and (16, 4, 0), (16, 4, 1) in
// attention_variants_wgmma16.cu, a file of its own so that nvcc builds the
// two halves in parallel. What bounds it on the H100: arithmetic, as K1.
#include "attention_wgmma.cuh"

extern "C" int fbanet_attention_variant_wgmma16(int core, const void* w3, const void* wproj,
                                                const void* args, int staged, void* stream);

namespace fbanet {
namespace {

constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

bool variant_triple(int dh, int nwg, int staged) {
  return (dh == 64 && staged == 1 && (nwg == 2 || nwg == 4)) ||
         (dh == 16 && nwg == 4 && (staged == 0 || staged == 1));
}

// The core whose instantiation runs `core` (see the top of this file).
int variant_core(int core, int dh, int heads, int nwg) {
  if ((core == kWgStack || core == kWgStackLn) && (dh != 16 || (heads + nwg - 1) / nwg < 2))
    return core == kWgStack ? kWgLoop : kWgLoopLn;
  return core;
}

int variant_smem(int n, int C, int heads, int core, int nwg, int staged) {
  if (n != kWinTok || C % 64 || C > 256 || heads < 1 || C % heads || core < kWgLoop ||
      core > kWgLanepack)
    return 0;
  if (!variant_triple(C / heads, nwg, staged) || (core == kWgLanepack && heads % 2)) return 0;
  const size_t total = AfLayout(C, heads, nwg, staged, core == kWgLanepack).total;
  return total > (size_t)kSmemLimit ? 0 : (int)total;
}

template <int NWG>
int launch64(int core, const void* w3, const void* wproj, const AfArgs& a, void* stream) {
  switch (core) {
    case kWgLoop: return launch_one<64, NWG, true, kWgLoop>(w3, wproj, a, stream);
    case kWgLoopLn: return launch_one<64, NWG, true, kWgLoopLn>(w3, wproj, a, stream);
    case kWgLanepack: return launch_one<64, NWG, true, kWgLanepack>(w3, wproj, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace fbanet

extern "C" {

// Dynamic shared memory of K7's `core` (0 loop, 1 loop_ln, 2 stack3d,
// 3 stack3d_ln, 4 lanepack) on K1's wgmma form with `nwg` warpgroups and
// the weights staged or streamed, or 0 for a shape it does not take
// (64-token windows, an instantiated triple, lanepack with even heads,
// at most 232,448 bytes).
int fbanet_attention_variant_wgmma_smem(int n, int C, int heads, int core, int nwg,
                                        int staged) {
  return fbanet::variant_smem(n, C, heads, core, nwg, staged);
}

// Heads a warpgroup takes through each stage of `core` on that form (1 for
// the loops and where stacking changes nothing, 2 for lanepack and for
// stack3d(_ln) where a warpgroup holds two heads or more), 0 if not taken.
int fbanet_attention_variant_wgmma_stage(int n, int C, int heads, int core, int nwg,
                                         int staged) {
  using namespace fbanet;
  if (variant_smem(n, C, heads, core, nwg, staged) == 0) return 0;
  const int c = variant_core(core, C / heads, heads, nwg);
  return c == kWgLoop || c == kWgLoopLn ? 1 : 2;
}

// K7 on K1's wgmma form on a bf16 map [B, H, W, C], mask-free, no residual:
// w3 = [Wq; Wkv] [3C, C], bias [heads, n, n] f32 (lanepack too), `core` as
// above, K1's plan (nwg, wpb windows per block, staged).
int fbanet_attention_variant_wgmma(const void* x, void* out, const void* ln_s, const void* ln_b,
                                   const void* w3, const void* bq, const void* bkv,
                                   const void* wproj, const void* bproj, const void* bias, int B,
                                   int H, int W, int C, int heads, int ws, int core, int nwg,
                                   int wpb, int staged, void* stream) {
  using namespace fbanet;
  const int n = ws * ws;
  if (variant_smem(n, C, heads, core, nwg, staged) == 0 || wpb < 1 || H % ws || W % ws)
    return (int)cudaErrorInvalidValue;
  const int nw = (H / ws) * (W / ws);
  const AfArgs a{(const bf16*)x, (bf16*)out, (const float*)ln_s, (const float*)ln_b,
                 (const float*)bq, (const float*)bkv, (const float*)bproj, (const float*)bias,
                 nullptr, WinGeom{H, W, C, ws, n, nw, 0}, heads, 0, B * nw, wpb};
  const int c = variant_core(core, C / heads, heads, nwg);
  if (C / heads == 16) return fbanet_attention_variant_wgmma16(c, w3, wproj, &a, staged, stream);
  return nwg == 4 ? launch64<4>(c, w3, wproj, a, stream) : launch64<2>(c, w3, wproj, a, stream);
}

}  // extern "C"
