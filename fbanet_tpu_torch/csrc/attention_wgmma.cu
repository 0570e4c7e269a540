// K1's wgmma form: fused norm1 + window attention (the forward of K3) in
// bf16, for 8 x 8 windows (64 tokens), C = 64, 128 or 256 and head size 8,
// 16, 32 or 64, on the post-roll map [B, H, W, C] (K1) or on pre-partitioned
// windows [G, 64, C] (K1b). It replaces the TPU kernels
// fbanet_tpu/ops/attention_pallas.py::_attention2d_kernel and
// _attention_kernel; the function, its outputs and its rounding points are
// those of the first kernel (attention.cu, kept for f32, for the shapes
// ops/attention.py::_attention_plan does not send here): LN in f32
// rounded to bf16; q = (y Wq^T + bq) dh^-1/2 in f32, then rounded, k and
// v likewise without the scale; f32 logits + bias + mask; p = exp(l - max)
// rounded to bf16 for the AV product; o = (p v) (1 / sum) in f32, then
// rounded; proj + bproj + residual in f32, rounded once.
//
// What bounds it on the H100: arithmetic (8 T C^2 + 4 T 64 C flops against
// 4 T C bytes of activations). The first kernel runs every product as WMMA
// 16 x 16 x 16 with the weight fragment read from device memory per tile
// and k-step, makes an f32 round trip through shared memory per 16 x 16
// result, walks the heads one after another with three block barriers each
// and gives each window one block. This form:
//  - walks a fixed, contiguous list of windows per block (`wpb` of them,
//    ops/attention.py::_window_blocks), one or two resident blocks per SM;
//  - runs q | k | v = y [Wq; Wkv]^T and the output projection as wgmma in
//    pieces of 32 output columns with f32 accumulators in registers, the
//    pieces dealt to the warpgroups in turn; A (y, then o) is K-major in
//    128-byte-swizzled 64-channel atoms, the weights are 64-column x 32-row
//    TMA boxes, either staged once per block (`STAGED`: all 4 C^2 bf16,
//    where they fit: C <= 128) or streamed per window through a four-slot
//    TMA ring per warpgroup with mbarriers, a box's products in flight
//    while the slot of the box before refills;
//  - adds the biases and the scale on the accumulator fragments and rounds
//    q, k, v into per-head tiles of pitch 2 dh (hopper.cuh's 32/64/128-byte
//    swizzles), so each head is a whole wgmma operand in either major;
//  - runs head h on warpgroup h mod NWG without block barriers: logits
//    q k^T as m64n64 (k = dh) accumulated onto the head's f32 bias (loaded
//    into the accumulator while the head before runs its p v product), the
//    window's mask added on the fragments from shared memory (staged once
//    per window), max and sum by shuffles, p rounded to bf16 as a register
//    A operand of o = p v (m64n{dh}k64), 1 / sum applied on the
//    accumulator, o rounded into y's space (y is dead once q | k | v are
//    formed);
//  - adds bproj and the residual to the projection's fragments in f32 and
//    stores bf16 straight to the map through the window addressing.
// Four block barriers per window (after LN, q | k | v, the heads, proj).
// Head sizes 32 and 8 (embed 32, the configuration's default): a head of 32
// is a tile of 64-byte rows (64-byte swizzle), q k^T two k16 steps and p v
// m64n32; a head of 8 (16-byte rows have no swizzle mode) is held
// zero-padded to 16 columns (common.cuh's head_pitch), the pad's zeros
// written with q, k and v, so q k^T is one k16 step with a zero half and
// p v an n16 product whose pad columns are dropped. o lies in y's atoms at
// every head size, so the projection does not see the padding.
//
// The form's layout, kernel and launch are in attention_wgmma.cuh, shared
// with K7's cores and K9's stages on this form (attention_variants_wgmma*.cu,
// attention_ablation_wgmma*.cu).
#include "attention_wgmma.cuh"

namespace fbanet {
namespace {

template <int DH>
cudaError_t launch_dh(const CUtensorMap& m3, const CUtensorMap& mp, const AfArgs& a, int nwg,
                      int staged, unsigned grid, int smem, cudaStream_t s) {
  if (nwg == 4)
    return staged ? launch_k<DH, 4, true>(m3, mp, a, grid, smem, s)
                  : launch_k<DH, 4, false>(m3, mp, a, grid, smem, s);
  return staged ? launch_k<DH, 2, true>(m3, mp, a, grid, smem, s)
                : launch_k<DH, 2, false>(m3, mp, a, grid, smem, s);
}

int launch_form(const void* w3, const void* wproj, AfArgs a, int nwg, int staged, void* stream) {
  const int C = a.geom.C, dh = C / a.heads;
  CUtensorMap m3, mp;
  cudaError_t e = make_tma_map_bf16(&m3, w3, 3 * C, C, kBoxRows);
  if (e == cudaSuccess) e = make_tma_map_bf16(&mp, wproj, C, C, kBoxRows);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((a.windows + a.wpb - 1) / a.wpb);
  const int smem = (int)AfLayout(C, a.heads, nwg, staged).total;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dh) {
    case 8: return (int)launch_dh<8>(m3, mp, a, nwg, staged, grid, smem, s);
    case 16: return (int)launch_dh<16>(m3, mp, a, nwg, staged, grid, smem, s);
    case 32: return (int)launch_dh<32>(m3, mp, a, nwg, staged, grid, smem, s);
    default: return (int)launch_dh<64>(m3, mp, a, nwg, staged, grid, smem, s);
  }
}

}  // namespace
}  // namespace fbanet

extern "C" {

// Dynamic shared memory of K1's wgmma form with `nwg` warpgroups and the
// weights staged (1) or streamed (0), or 0 for a shape it does not take:
// 64-token windows, C 64, 128 or 256, head size 8, 16, 32 or 64, nwg 2 or
// 4, at most 232,448 bytes (staged weights fit up to C = 128; at head size 8
// the padded head tiles leave them room only at C = 64).
int fbanet_window_attention_wgmma_smem(int n, int C, int heads, int nwg, int staged) {
  using namespace fbanet;
  if (n != kWinTok || C % 64 || C > 256 || heads < 1 || C % heads) return 0;
  const int dh = C / heads;
  if ((dh != 8 && dh != 16 && dh != 32 && dh != 64) || (nwg != 4 && nwg != 2) ||
      (staged != 0 && staged != 1))
    return 0;
  const size_t total = AfLayout(C, heads, nwg, staged).total;
  return total > 232448 ? 0 : (int)total;
}

// K1's wgmma form on the post-roll map [B, H, W, C]: w3 = [Wq; Wkv] [3C, C],
// `wpb` windows per block in window order.
int fbanet_window_attention_wgmma(const void* x, void* out, const void* ln_s, const void* ln_b,
                                  const void* w3, const void* bq, const void* bkv,
                                  const void* wproj, const void* bproj, const void* bias,
                                  const void* mask, int B, int H, int W, int C, int heads,
                                  int ws, int residual, int nwg, int wpb, int staged,
                                  void* stream) {
  const int n = ws * ws;
  if (fbanet_window_attention_wgmma_smem(n, C, heads, nwg, staged) == 0 || wpb < 1 || H % ws ||
      W % ws)
    return (int)cudaErrorInvalidValue;
  const int nw = (H / ws) * (W / ws);
  const fbanet::AfArgs a{(const fbanet::bf16*)x, (fbanet::bf16*)out, (const float*)ln_s,
                         (const float*)ln_b, (const float*)bq, (const float*)bkv,
                         (const float*)bproj, (const float*)bias, (const float*)mask,
                         fbanet::WinGeom{H, W, C, ws, n, nw, 0}, heads, residual, B * nw, wpb};
  return fbanet::launch_form(w3, wproj, a, nwg, staged, stream);
}

// K1b: the same on pre-partitioned windows [G, n, C]: mask [nw, n, n] or
// null, window g masked by mask[g % nw]; no residual.
int fbanet_window_attention_wgmma_windows(const void* x, void* out, const void* ln_s,
                                          const void* ln_b, const void* w3, const void* bq,
                                          const void* bkv, const void* wproj,
                                          const void* bproj, const void* bias, const void* mask,
                                          int G, int n, int C, int heads, int nw, int nwg,
                                          int wpb, int staged, void* stream) {
  if (fbanet_window_attention_wgmma_smem(n, C, heads, nwg, staged) == 0 || wpb < 1 || nw < 1)
    return (int)cudaErrorInvalidValue;
  const fbanet::AfArgs a{(const fbanet::bf16*)x, (fbanet::bf16*)out, (const float*)ln_s,
                         (const float*)ln_b, (const float*)bq, (const float*)bkv,
                         (const float*)bproj, (const float*)bias, (const float*)mask,
                         fbanet::WinGeom{0, 0, C, 0, n, nw, 1}, heads, 0, G, wpb};
  return fbanet::launch_form(w3, wproj, a, nwg, staged, stream);
}

}  // extern "C"
