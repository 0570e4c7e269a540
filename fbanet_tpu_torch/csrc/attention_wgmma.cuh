// K1's wgmma form, shared by attention_wgmma.cu (K1's and K1b's entries),
// attention_variants_wgmma*.cu (K7's cores on this form) and
// attention_ablation_wgmma*.cu (K9's stages on it): the layout, the kernel
// and its launch. What K1 computes, its rounding points and what
// bounds it are at the top of attention_wgmma.cu.
//
// K7 is this kernel with the per-head core chosen at compile time (CORE),
// the counterpart of the variant copy scripts/measure_swin_variants.py::
// _var_kernel (mask-free, no residual). kWgLoopLn is K1's own core, kept
// verbatim: its instantiations are K1's. The others, in variant_heads:
//  - kWgLoop: K1's order with the softmax normalised before AV: p =
//    round(e (1 / sum)) is the A operand of p v, and o is not scaled after;
//  - kWgStack / kWgStackLn: a warpgroup takes its heads two at a time
//    through each stage: both heads' logits groups issued before one wait,
//    the pair's softmax, both p v groups before one wait, the next pair's
//    biases loading while this pair's p v runs; per-head arithmetic as
//    kWgLoop / K1's (bitwise). Built at head size 16, where a warpgroup
//    holds several heads (4 at C = 256, 2 at C = 128 at the five groups);
//  - kWgLanepack: heads in pairs (a, b) with block-diagonal operands: the
//    logits [64, 128] = [q_a | q_b] [[k_a, 0], [0, k_b]]^T as m64n128 with
//    K = 2 dh, onto the pair's two biases, max and sum over each 64-wide
//    half, e rounded as the A operand of p v = m64n{2 dh}k128 against
//    [[v_a, 0], [0, v_b]], each half times 1 / its sum. k and v lie as
//    [k_a, Z, k_b] per pair (Z a zero head tile), so [k_a; Z] and [Z; k_b]
//    are each one 128-row operand at the tile stride; the window's mask
//    space is not kept (K7 is mask-free), so the layout is 5 tensors of
//    64 x C plus the weights. The next pair's biases load after p v (a
//    64-float logits accumulator, 2 dh more for o).
// K9 (attention_ablation_wgmma*.cu) takes one stage out of K1 in the same
// slot, the counterpart of scripts/measure_swin_rates.py::_abl_kernel:
//  - kWgNoSoftmax: K1's loop with p = round(l (1 / 64)) in place of the
//    softmax, l the logits accumulated onto the bias; o = p v, not scaled;
//  - kWgNoCore: no logits and no p v: o = round(round(q + k) + v) element by
//    element from the head tiles (q keeps its dh^-1/2), by the whole block.
// The variants take no mask and no residual.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

#include <cstdint>
#include <type_traits>

namespace fbanet {
namespace {

constexpr int kWinTok = 64;   // tokens of an 8 x 8 window
constexpr int kBoxRows = 32;  // weight rows (output columns) of one TMA box, 64 columns wide
constexpr int kBoxBytes = 64 * kBoxRows * 2;  // a ring slot (a box of 32 columns fills half)
constexpr int kSlots = 4;     // TMA ring slots per warpgroup when streaming

// The per-head core (K7's `core`, the ids of ops' _CORE_IDS; then K9's
// stages); kWgLoopLn is K1's own.
enum WgCore {
  kWgLoop = 0,
  kWgLoopLn = 1,
  kWgStack = 2,
  kWgStackLn = 3,
  kWgLanepack = 4,
  kWgNoSoftmax = 5,
  kWgNoCore = 6
};

struct AfArgs {
  const bf16* x;
  bf16* out;
  const float *ln_s, *ln_b, *bq, *bkv, *bproj, *bias, *mask;
  WinGeom geom;
  int heads, residual, windows, wpb;
};

// Shared-memory layout (byte offsets from a 1024-byte aligned base) for C
// channels, `heads` heads and NWG warpgroups: y, then o [64 rows] K-major
// in 64-channel atoms (at C = 32 one tile of 64-byte rows); q, k, v, each
// 64 x C bf16 as per-head tiles (64 x 2 C at head size 8, each head
// zero-padded to 16 columns); the window's f32 mask [64][64] (8-float
// groups of row r XOR-ed with r % 8); the weights (staged: [Wq; Wkv] then
// Wproj as 32-row boxes of 64 columns, or 32 at C = 32, piece p's boxes
// together; streamed: each warpgroup's ring of kSlots boxes); the barriers
// (staged: one; streamed: one per ring slot). The sizes are the same
// expressions at C = 32. K7's lanepack: k and v each 1.5 tensors ([k_a, Z,
// k_b] per pair of heads) and no mask.
struct AfLayout {
  size_t y, q, k, v, mk, w, bars, total;
  __host__ __device__ AfLayout(int C, int heads, int nwg, int staged, bool lanepack = false) {
    const size_t t = (size_t)128 * C;  // one 64 x C bf16 tensor
    const size_t ht = (size_t)128 * heads * head_pitch(C / heads);  // one as head tiles
    y = 0;
    q = t;
    k = t + ht;
    v = lanepack ? 2 * t + 3 * t / 2 : t + 2 * ht;
    mk = lanepack ? 5 * t : t + 3 * ht;
    w = mk + (lanepack ? 0 : sizeof(float) * kWinTok * kWinTok);
    bars = w + (staged ? (size_t)8 * C * C : (size_t)nwg * kSlots * kBoxBytes);
    total = bars + (size_t)(staged ? 1 : nwg * kSlots) * sizeof(uint64_t) +
            1024;  // + slack to align the base
  }
};

// K7: the softmax of one head's logits s (its accumulator fragments, bias
// included) into p as A fragments, in K1's order: the row max, e = exp(l -
// max), its f32 row sum, rinv = 1 / sum. LATE (K1's): p = round(e), the
// caller scales o by rinv; else p = round(e rinv).
template <bool LATE>
__device__ __forceinline__ void head_softmax(float* s, uint32_t* pf, float* rinv) {
  float mx[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
      mx[h2] = fmaxf(mx[h2], fmaxf(s[4 * j + 2 * h2], s[4 * j + 2 * h2 + 1]));
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
    mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float e0 = expf(s[2 * i] - mx[i % 2]), e1 = expf(s[2 * i + 1] - mx[i % 2]);
    sum[i % 2] += e0 + e1;
    if constexpr (LATE) {
      pf[i] = pack_bf2(e0, e1);
    } else {
      s[2 * i] = e0;
      s[2 * i + 1] = e1;
    }
  }
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    sum[h2] += __shfl_xor_sync(0xffffffffu, sum[h2], 1);
    sum[h2] += __shfl_xor_sync(0xffffffffu, sum[h2], 2);
    rinv[h2] = 1.0f / sum[h2];
  }
  if constexpr (!LATE)
#pragma unroll
    for (int i = 0; i < 16; ++i)
      pf[i] = pack_bf2(s[2 * i] * rinv[i % 2], s[2 * i + 1] * rinv[i % 2]);
}

// K7's per-head cores other than K1's and K9's nosoftmax (see the top of
// this file) for one window: q, k, v in their head tiles (lanepack: k and v as [k_a, Z, k_b]
// per pair), o rounded into y's atoms (`atom_at`), the bias [heads][64][64]
// f32. Warpgroup wg takes heads (pairs, for lanepack) wg, wg + NWG, ...
template <int DH, int NWG, int CORE, typename AtomAt>
__device__ __forceinline__ void variant_heads(const uint8_t* sQ, const uint8_t* sK,
                                              const uint8_t* sV, const float* bias, int heads,
                                              int wg, int arow, int acol, AtomAt atom_at) {
  constexpr int PITCH = 2 * DH;
  constexpr uint32_t HT = 64 * PITCH;
  auto desc_k = [](const uint8_t* p) {
    return smem_desc(smem_addr(p), 16, 16 * DH, sw_layout(2 * DH));
  };
  auto desc_mn = [](const uint8_t* p) {
    return smem_desc(smem_addr(p), 128 * DH, 16 * DH, sw_layout(2 * DH));
  };
  // the bias of head h onto a 64-column accumulator (column offset 64 * part
  // of a wider one)
  auto load_bias = [&](float* s, int h) {
    const float* bh = bias + (size_t)h * kWinTok * kWinTok;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const float2 bv = __ldg(
            reinterpret_cast<const float2*>(bh + (arow + 8 * h2) * kWinTok + 8 * j + acol));
        s[4 * j + 2 * h2] = bv.x;
        s[4 * j + 2 * h2 + 1] = bv.y;
      }
  };
  if constexpr (CORE == kWgLanepack) {
    const int pairs = heads / 2;
    float s[64];
    for (int pr = wg; pr < pairs; pr += NWG) {
      const uint8_t* qa = sQ + 2 * pr * HT;
      const uint8_t* ka = sK + 3 * pr * HT;  // then Z, then k_b
      const uint8_t* va = sV + 3 * pr * HT;
      load_bias(s, 2 * pr);
      load_bias(s + 32, 2 * pr + 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)  // [q_a | 0] [k_a; Z]^T
        wgmma_ss<128, 0, 0>(s, desc_k(qa + kk * 32), desc_k(ka + kk * 32));
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)  // [0 | q_b] [Z; k_b]^T
        wgmma_ss<128, 0, 0>(s, desc_k(qa + HT + kk * 32), desc_k(ka + HT + kk * 32));
      wgmma_commit();
      wgmma_wait_all();
      // accumulator column group j < 8 is head a's, j >= 8 head b's
      float mx[2][2], sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, rinv[2][2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          float m = __int_as_float(0xff800000);
#pragma unroll
          for (int j = 8 * hf; j < 8 * hf + 8; ++j)
            m = fmaxf(m, fmaxf(s[4 * j + 2 * h2], s[4 * j + 2 * h2 + 1]));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          mx[hf][h2] = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        }
      uint32_t pf[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hf = i / 16, h2 = i % 2;
        const float e0 = expf(s[2 * i] - mx[hf][h2]), e1 = expf(s[2 * i + 1] - mx[hf][h2]);
        sum[hf][h2] += e0 + e1;
        pf[i] = pack_bf2(e0, e1);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          float t = sum[hf][h2];
          t += __shfl_xor_sync(0xffffffffu, t, 1);
          t += __shfl_xor_sync(0xffffffffu, t, 2);
          rinv[hf][h2] = 1.0f / t;
        }
      // o [64, 2 dh] = p [[v_a, 0], [0, v_b]]: keys of a against [v_a | Z],
      // keys of b against [Z | v_b] (MN atoms HT apart)
      float o[DH];
#pragma unroll
      for (int i = 0; i < DH; ++i) o[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<2 * DH, 1>(o, pf + 4 * kk, desc_mn(va + kk * 16 * PITCH));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<2 * DH, 1>(o, pf + 16 + 4 * kk, desc_mn(va + HT + kk * 16 * PITCH));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < DH / 4; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const float r = rinv[j / (DH / 8)][h2];
          *reinterpret_cast<uint32_t*>(atom_at(arow + 8 * h2, 2 * pr * DH + 8 * j + acol)) =
              pack_bf2(o[4 * j + 2 * h2] * r, o[4 * j + 2 * h2 + 1] * r);
        }
    }
  } else {
    // kWgLoop and kWgNoSoftmax one head per stage; kWgStack(Ln) two where
    // the warpgroup holds two more (head size 16). A stage of CNT heads runs
    // whole, with no per-head branch between its wgmma fence and wait (one
    // would make ptxas serialize the wgmmas, C7520)
    constexpr bool LATE = CORE == kWgStackLn;
    constexpr int S = (CORE == kWgLoop || CORE == kWgNoSoftmax || DH != 16) ? 1 : 2;
    const int per = heads > wg ? (heads - wg + NWG - 1) / NWG : 0;  // this warpgroup's heads
    float s[S][32];
#pragma unroll
    for (int u = 0; u < S; ++u)
      if (u < per) load_bias(s[u], wg + u * NWG);
    // heads i .. i + CNT - 1 of this warpgroup's, then the next stage's
    // biases into s while their p v products run
    auto stage = [&](int i, auto cnt_c) {
      constexpr int CNT = decltype(cnt_c)::value;
      const int h0 = wg + i * NWG;
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < CNT; ++u)
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          wgmma_ss<64, 0, 0>(s[u], desc_k(sQ + (h0 + u * NWG) * HT + kk * 32),
                             desc_k(sK + (h0 + u * NWG) * HT + kk * 32));
      wgmma_commit();
      wgmma_wait_all();
      uint32_t pf[CNT][16];
      float rinv[CNT][2];
#pragma unroll
      for (int u = 0; u < CNT; ++u) {
        if constexpr (CORE == kWgNoSoftmax) {  // p = round(l / 64); 1/64 is exact
#pragma unroll
          for (int i = 0; i < 16; ++i)
            pf[u][i] = pack_bf2(s[u][2 * i] * (1.f / kWinTok), s[u][2 * i + 1] * (1.f / kWinTok));
        } else {
          head_softmax<LATE>(s[u], pf[u], rinv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < S; ++u)  // s is free
        if (i + CNT + u < per) load_bias(s[u], h0 + (CNT + u) * NWG);
      float o[CNT][DH / 2];
#pragma unroll
      for (int u = 0; u < CNT; ++u)
#pragma unroll
        for (int e = 0; e < DH / 2; ++e) o[u][e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < CNT; ++u)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<DH, 1>(o[u], pf[u] + 4 * kk,
                          desc_mn(sV + (h0 + u * NWG) * HT + kk * 16 * PITCH));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int u = 0; u < CNT; ++u)
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            *reinterpret_cast<uint32_t*>(
                atom_at(arow + 8 * h2, (h0 + u * NWG) * DH + 8 * j + acol)) =
                LATE ? pack_bf2(o[u][4 * j + 2 * h2] * rinv[u][h2],
                                o[u][4 * j + 2 * h2 + 1] * rinv[u][h2])
                     : pack_bf2(o[u][4 * j + 2 * h2], o[u][4 * j + 2 * h2 + 1]);
    };
    int i = 0;
    for (; i + S <= per; i += S) stage(i, std::integral_constant<int, S>{});
    if constexpr (S == 2)
      if (i < per) stage(i, std::integral_constant<int, 1>{});  // an odd head left
  }
}

template <int DH, int NWG, bool STAGED, int CORE = kWgLoopLn, int YP = 128>
__global__ void __launch_bounds__(NWG * 128, 4 / NWG)
    attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_w3,
                           const __grid_constant__ CUtensorMap map_wproj, AfArgs a) {
  constexpr int NT = NWG * 128, NW = NT / 32;
  constexpr int HP = head_pitch(DH);   // columns of a head tile (DH, or 16 at DH 8)
  constexpr int PITCH = 2 * HP;        // bytes per row of a head tile
  constexpr uint32_t HT = 64 * PITCH;  // bytes of a head tile
  static_assert(DH == 8 || DH == 16 || DH == 32 || DH == 64, "the head sizes instantiated here");
  static_assert(CORE == kWgLoopLn || DH == 16 || DH == 64,
                "K7's and K9's cores are built at head sizes 16 and 64");
  // YP: bytes of a row of the y / o tile and of a weight box, 128 (C >= 64:
  // atoms of 64 channels, boxes of 64 columns) or 64 (C = 32: one tile of
  // 64-byte rows, boxes of 32 columns, 64-byte swizzle); BW: a box's columns
  static_assert(YP == 128 || (YP == 64 && DH == 32 && NWG == 1 && STAGED && CORE == kWgLoopLn),
                "C = 32 is built for K1 alone: one head of 32 on one warpgroup, weights staged");
  static_assert(NWG > 1 || YP == 64, "one warpgroup a block is the C = 32 form");
  constexpr int BW = YP / 2;
  constexpr uint32_t kBoxBytesC = kBoxRows * YP;  // bytes of one box
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int C = a.geom.C, heads = a.heads;
  const AfLayout L(C, heads, NWG, STAGED, CORE == kWgLanepack);
  uint8_t* sY = sm + L.y;  // y, then o
  uint8_t* sQ = sm + L.q;
  uint8_t* sK = sm + L.k;
  uint8_t* sV = sm + L.v;
  float* sMk = reinterpret_cast<float*>(sm + L.mk);
  uint8_t* sW = sm + L.w;
  uint64_t* bars0 = reinterpret_cast<uint64_t*>(sm + L.bars);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4, wl = warp % 4;
  const int arow = 16 * wl + lane / 4, acol = 2 * (lane % 4);  // accumulator rows / columns
  const bool producer = threadIdx.x % 128 == 0;
  const int wbar = 1 + wg;  // this warpgroup's named barrier
  const int kQ = C / BW;    // weight boxes along K per piece
  const int pq = 3 * C / kBoxRows, pp = C / kBoxRows;  // pieces of q | k | v and of proj
  const int w0 = blockIdx.x * a.wpb, nwin = min(a.wpb, a.windows - w0);

  auto desc_k = [](const uint8_t* p) {  // a head tile, K-major
    return smem_desc(smem_addr(p), 16, 16 * HP, sw_layout(PITCH));
  };
  auto desc_mn = [](const uint8_t* p) {  // a head tile, MN-major
    return smem_desc(smem_addr(p), HT, 16 * HP, sw_layout(PITCH));
  };
  // (row, column c) of the tensor held as per-head tiles from `base`; at
  // head size 8 column c of head c / 8 has its pad column c + 8 in the tile
  auto tile_at = [&](uint8_t* base, int row, int c) {
    return base + (c / DH) * HT + swz_at(row, (c % DH) * 2, PITCH);
  };
  auto pad_at = [&](uint8_t* base, int row, int c) {
    return base + (c / DH) * HT + swz_at(row, (c % DH + DH) * 2, PITCH);
  };
  // the same for k and v under lanepack: head h's tile is 3 (h / 2) + 2 (h % 2)
  auto pair_tile_at = [&](uint8_t* base, int row, int c) {
    const int h = c / DH;
    return base + (3 * (h / 2) + 2 * (h % 2)) * HT + swz_at(row, (c % DH) * 2, PITCH);
  };
  // (row, column c) of y / o in its 64-channel atoms, or at C = 32 in its
  // one tile of 64-byte rows. YP = 128 keeps the C >= 64 instantiations'
  // own expressions, here and for y's stores below: the same offsets
  // computed through 16-byte chunks raised their spills at head size 64
  // (48 / 56 -> 68 / 76 bytes at two warpgroups, staged) and their device
  // time ~5 % (H100).
  auto atom_at = [&](int row, int c) {
    if constexpr (YP == 128)
      return sY + (size_t)(c / 64) * 8192 + swz(row, (c % 64) / 8) + (c % 8) * 2;
    else
      return sY + swz_at(row, 2 * c, 64);
  };
  // float index of mask element (row, column c) in sMk: the accumulator
  // fragments' float2 reads then meet each bank at most twice
  auto mask_at = [](int row, int c) { return row * kWinTok + (((c / 8) ^ (row % 8)) * 8) + c % 8; };

  // --- streamed weights: the warpgroup's boxes in the order it consumes
  // them, per window its q | k | v pieces, then its proj pieces ---
  uint8_t* ring = sW + (size_t)wg * kSlots * kBoxBytes;
  uint64_t* bars = bars0 + (STAGED ? 0 : kSlots * wg);
  auto owned = [&](int pieces) { return pieces > wg ? (pieces - wg + NWG - 1) / NWG : 0; };
  const int nQ = owned(pq) * kQ, per_win = nQ + owned(pp) * kQ;
  const int total_boxes = STAGED ? 0 : nwin * per_win;
  auto issue = [&](int it) {  // TMA of box `it` into slot it % kSlots
    int idx = it % per_win;
    const CUtensorMap* map = &map_w3;
    if (idx >= nQ) {
      idx -= nQ;
      map = &map_wproj;
    }
    uint64_t* bar = &bars[it % kSlots];
    mbar_expect_tx(bar, kBoxBytesC);
    tma_load_2d(ring + (it % kSlots) * kBoxBytes, map, BW * (idx % kQ),
                kBoxRows * (wg + (idx / kQ) * NWG), bar);
  };
  int it = 0;  // boxes consumed by this warpgroup

  if (threadIdx.x == 0) {
    for (int i = 0; i < (STAGED ? 1 : NWG * kSlots); ++i) mbar_init(bars0 + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if constexpr (STAGED) {
    if (threadIdx.x == 0) {  // every weight box once, onto one barrier
      mbar_expect_tx(bars0, (uint32_t)(8 * C * C));
      for (int r = 0; r < pq; ++r)
        for (int cb = 0; cb < kQ; ++cb)
          tma_load_2d(sW + (size_t)(r * kQ + cb) * kBoxBytesC, &map_w3, BW * cb, kBoxRows * r,
                      bars0);
      for (int r = 0; r < pp; ++r)
        for (int cb = 0; cb < kQ; ++cb)
          tma_load_2d(sW + (size_t)((pq + r) * kQ + cb) * kBoxBytesC, &map_wproj, BW * cb,
                      kBoxRows * r, bars0);
    }
  } else if (producer) {
    tma_prefetch_map(&map_w3);
    tma_prefetch_map(&map_wproj);
    for (int i = 0; i < kSlots && i < total_boxes; ++i) issue(i);
  }

  // acc[16] = A [64 x C] (y or o, in sY) times the 32 weight rows of piece
  // p ([Wq; Wkv] or, with `proj`, Wproj), K over the C columns in order.
  // The K loop is unrolled (kQ = 1, 2 or 4 boxes): a loop around
  // accumulators in flight would make ptxas serialize the wgmmas.
  auto piece = [&](float* acc, bool proj, int p) {
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    if constexpr (STAGED) mbar_wait(bars0, 0);  // the staged weights have landed
    const uint8_t* wp = sW + (size_t)((proj ? pq : 0) + p) * kQ * kBoxBytesC;
    auto run = [&](auto kq) {
#pragma unroll
      for (int kb = 0; kb < decltype(kq)::value; ++kb) {
        const uint8_t* box = wp + kb * kBoxBytesC;
        if constexpr (!STAGED) {
          mbar_wait(&bars[it % kSlots], (it / kSlots) & 1);
          box = ring + (it % kSlots) * kBoxBytes;
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < YP / 32; ++kk)
          wgmma_ss<32, 0, 0>(acc, k_desc_at(smem_addr(sY + kb * 64 * YP + kk * 32), YP),
                             k_desc_at(smem_addr(box + kk * 32), YP));
        wgmma_commit();
        if constexpr (!STAGED) {
          // box it - 1's products are done in every warp of the group:
          // its slot takes box it - 1 + kSlots while box it's run
          wgmma_wait<1>();
          named_bar_sync(wbar, 128);
          if (producer && it > 0 && it - 1 + kSlots < total_boxes) issue(it - 1 + kSlots);
          ++it;
        }
      }
      wgmma_wait_all();
    };
    if (kQ == 1)
      run(std::integral_constant<int, 1>{});
    else if (kQ == 2)
      run(std::integral_constant<int, 2>{});
    else
      run(std::integral_constant<int, 4>{});
  };

  if constexpr (CORE == kWgLanepack) {  // the pairs' zero tiles of k and v, once
    for (int e = threadIdx.x; e < (heads / 2) * (int)(HT / 16); e += NT) {
      const size_t off = (size_t)(3 * (e / (HT / 16)) + 1) * HT + (e % (HT / 16)) * 16;
      *reinterpret_cast<uint4*>(sK + off) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(sV + off) = make_uint4(0, 0, 0, 0);
    }
    fence_proxy_async();  // read by wgmma after the first window's barriers
  }

  const float scale = 1.0f / sqrtf((float)DH);
  const int seg = C / 8, sl = lane % seg, sub = lane / seg, tpw = 32 / seg;

  for (int wi = 0; wi < nwin; ++wi) {
    const WinBlock wb(a.geom, w0 + wi);
    auto tok = [&](int t) -> size_t { return wb.pix(t); };

    // --- the window's mask into shared memory (read by every head); the
    // next window's tokens and mask on their way into L2 ---
    if (a.mask) {
      const float4* src = reinterpret_cast<const float4*>(a.mask + (size_t)wb.win * 4096);
#pragma unroll
      for (int i = 0; i < 1024 / NT; ++i) {
        const int e = threadIdx.x + i * NT, r = e / 16;
        *reinterpret_cast<float4*>(sMk + mask_at(r, 4 * (e % 16))) = __ldg(src + e);
      }
    }
    if (wi + 1 < nwin) {
      const WinBlock nb(a.geom, w0 + wi + 1);
      const int lpr = YP == 128 ? C / 64 : 1;  // 128-byte lines per token
      for (int e = threadIdx.x; e < kWinTok * lpr; e += NT)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(a.x + nb.pix(e / lpr) * C + (e % lpr) * 64));
      if (a.mask && threadIdx.x < 128)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(a.mask + (size_t)nb.win * 4096 +
                                                          threadIdx.x * 32));
    }

    // --- LN: y = round((x - mu) (inv s) + b) into the atoms ---
    for (int t0 = warp * tpw; t0 < kWinTok; t0 += NW * tpw) {  // warp-uniform
      const int t = t0 + sub;
      float v[8];
      unpack_bf8(__ldg(reinterpret_cast<const uint4*>(a.x + tok(t) * C + 8 * sl)), v);
      float mu, inv;
      ln_stats8(v, seg, C, &mu, &inv);
      float yv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        yv[i] = (v[i] - mu) * (inv * __ldg(a.ln_s + 8 * sl + i)) + __ldg(a.ln_b + 8 * sl + i);
      uint8_t* dst;
      if constexpr (YP == 128)
        dst = sY + (size_t)(sl / 8) * 8192 + swz(t, sl % 8);
      else
        dst = sY + swz_at(t, 16 * sl, 64);
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(pack_bf2(yv[0], yv[1]), pack_bf2(yv[2], yv[3]), pack_bf2(yv[4], yv[5]),
                     pack_bf2(yv[6], yv[7]));
    }
    fence_proxy_async();
    __syncthreads();

    // --- q | k | v = y [Wq; Wkv]^T + b, rounded into the head tiles (q
    // scaled after its bias) ---
    for (int p = wg; p < pq; p += NWG) {
      const int which = kBoxRows * p / C;  // 0 q, 1 k, 2 v
      uint8_t* dst = which == 0 ? sQ : which == 1 ? sK : sV;
      float2 b2[4];  // this thread's biases, loaded while the products run
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kBoxRows * p + 8 * j + acol;
        b2[j] = __ldg(reinterpret_cast<const float2*>(which == 0 ? a.bq + col : a.bkv + col - C));
      }
      float acc[16];
      piece(acc, false, p);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = (kBoxRows * p + 8 * j + acol) % C;
          float v0 = acc[4 * j + 2 * h] + b2[j].x, v1 = acc[4 * j + 2 * h + 1] + b2[j].y;
          if (which == 0) {
            v0 *= scale;
            v1 *= scale;
          }
          if constexpr (CORE == kWgLanepack)
            *reinterpret_cast<uint32_t*>(which == 0 ? tile_at(dst, arow + 8 * h, c)
                                                    : pair_tile_at(dst, arow + 8 * h, c)) =
                pack_bf2(v0, v1);
          else
            *reinterpret_cast<uint32_t*>(tile_at(dst, arow + 8 * h, c)) = pack_bf2(v0, v1);
          if constexpr (HP > DH)  // the pad's zeros, which q k^T reads
            *reinterpret_cast<uint32_t*>(pad_at(dst, arow + 8 * h, c)) = 0u;
        }
    }
    fence_proxy_async();
    __syncthreads();  // y is dead: o takes its space

    if constexpr (CORE == kWgLoopLn) {
      // --- the per-head core, head h on warpgroup h mod NWG. The logits
      // accumulate onto the head's bias, which `s` receives while the head
      // before runs its p v product (device-memory latency off the path) ---
      float s[32];
      auto load_bias = [&](int h) {
        const float* bh = a.bias + (size_t)h * kWinTok * kWinTok;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const float2 bv = __ldg(
                reinterpret_cast<const float2*>(bh + (arow + 8 * h2) * kWinTok + 8 * j + acol));
            s[4 * j + 2 * h2] = bv.x;
            s[4 * j + 2 * h2 + 1] = bv.y;
          }
      };
      if (wg < heads) load_bias(wg);
      for (int h = wg; h < heads; h += NWG) {
        const uint8_t* qh = sQ + h * HT;
        const uint8_t* kh = sK + h * HT;
        const uint8_t* vh = sV + h * HT;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HP / 16; ++kk)
          wgmma_ss<64, 0, 0>(s, desc_k(qh + kk * 32), desc_k(kh + kk * 32));
        wgmma_commit();
        wgmma_wait_all();
        // logits (+ bias) + mask; e = exp(l - max), its f32 row sum
        float mx[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            float* sv = s + 4 * j + 2 * h2;
            if (a.mask) {
              const float2 mv =
                  *reinterpret_cast<const float2*>(sMk + mask_at(arow + 8 * h2, 8 * j + acol));
              sv[0] += mv.x;
              sv[1] += mv.y;
            }
            mx[h2] = fmaxf(mx[h2], fmaxf(sv[0], sv[1]));
          }
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
          mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
        }
        float sum[2] = {0.f, 0.f};
        uint32_t pf[16];  // e rounded, as A fragments
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float e0 = expf(s[2 * i] - mx[i % 2]), e1 = expf(s[2 * i + 1] - mx[i % 2]);
          sum[i % 2] += e0 + e1;
          pf[i] = pack_bf2(e0, e1);
        }
        float rinv[2];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          sum[h2] += __shfl_xor_sync(0xffffffffu, sum[h2], 1);
          sum[h2] += __shfl_xor_sync(0xffffffffu, sum[h2], 2);
          rinv[h2] = 1.0f / sum[h2];
        }
        if (h + NWG < heads) load_bias(h + NWG);  // s is free
        // o = (p v) (1 / sum), rounded into o's atoms (at head size 8 an
        // n16 product whose pad columns are dropped)
        float o[HP / 2];
#pragma unroll
        for (int i = 0; i < HP / 2; ++i) o[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<HP, 1>(o, pf + 4 * kk, desc_mn(vh + kk * 16 * PITCH));
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            *reinterpret_cast<uint32_t*>(atom_at(arow + 8 * h2, h * DH + 8 * j + acol)) =
                pack_bf2(o[4 * j + 2 * h2] * rinv[h2], o[4 * j + 2 * h2 + 1] * rinv[h2]);
      }
    } else if constexpr (CORE == kWgNoCore) {
      // --- K9's nocore: o = round(round(q + k) + v), 8 channels a thread
      // at a time, rounded into o's atoms ---
      for (int e = threadIdx.x; e < kWinTok * C / 8; e += NT) {
        const int row = e / (C / 8), c = 8 * (e % (C / 8));
        float q8[8], k8[8], v8[8];
        unpack_bf8(*reinterpret_cast<const uint4*>(tile_at(sQ, row, c)), q8);
        unpack_bf8(*reinterpret_cast<const uint4*>(tile_at(sK, row, c)), k8);
        unpack_bf8(*reinterpret_cast<const uint4*>(tile_at(sV, row, c)), v8);
        uint32_t o4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 qk = unpack_bf2(pack_bf2(q8[2 * i] + k8[2 * i], q8[2 * i + 1] + k8[2 * i + 1]));
          o4[i] = pack_bf2(qk.x + v8[2 * i], qk.y + v8[2 * i + 1]);
        }
        *reinterpret_cast<uint4*>(atom_at(row, c)) = make_uint4(o4[0], o4[1], o4[2], o4[3]);
      }
    } else {  // K7's other cores, K9's nosoftmax
      variant_heads<DH, NWG, CORE>(sQ, sK, sV, a.bias, heads, wg, arow, acol, atom_at);
    }
    fence_proxy_async();
    __syncthreads();

    // --- out = o Wproj^T + bproj (+ x), f32, rounded once into the map ---
    for (int p = wg; p < pp; p += NWG) {
      // this thread's biases and residual pairs, loaded while the products run
      float2 b2[4];
      uint32_t res[4][2] = {};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kBoxRows * p + 8 * j + acol;
        b2[j] = __ldg(reinterpret_cast<const float2*>(a.bproj + col));
        if (a.residual)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            res[j][h] = __ldg(reinterpret_cast<const unsigned int*>(a.x + tok(arow + 8 * h) * C + col));
      }
      float acc[16];
      piece(acc, true, p);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const size_t off = tok(arow + 8 * h) * C + kBoxRows * p + 8 * j + acol;
          float v0 = acc[4 * j + 2 * h] + b2[j].x;
          float v1 = acc[4 * j + 2 * h + 1] + b2[j].y;
          if (a.residual) {
            const float2 r = unpack_bf2(res[j][h]);
            v0 += r.x;
            v1 += r.y;
          }
          *reinterpret_cast<uint32_t*>(a.out + off) = pack_bf2(v0, v1);
        }
    }
    __syncthreads();  // o is no longer read: the next window's y may take its space
  }
}

template <int DH, int NWG, bool STAGED, int CORE = kWgLoopLn, int YP = 128>
cudaError_t launch_k(const CUtensorMap& m3, const CUtensorMap& mp, const AfArgs& a,
                     unsigned grid, int smem, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(attention_wgmma_kernel<DH, NWG, STAGED, CORE, YP>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  attention_wgmma_kernel<DH, NWG, STAGED, CORE, YP><<<grid, NWG * 128, smem, s>>>(m3, mp, a);
  return cudaGetLastError();
}

// Launch the instantiation <DH, NWG, STAGED, CORE> (K7's and K9's entries,
// at C >= 64 only): the weight maps, grid and shared memory as K1's
// launch_form makes them.
template <int DH, int NWG, bool STAGED, int CORE>
int launch_one(const void* w3, const void* wproj, const AfArgs& a, void* stream) {
  static_assert(NWG > 1, "K7 and K9 are not built for C = 32");
  const int C = a.geom.C;
  if (C % 64) return (int)cudaErrorInvalidValue;
  CUtensorMap m3, mp;
  cudaError_t e = make_tma_map_bf16(&m3, w3, 3 * C, C, kBoxRows);
  if (e == cudaSuccess) e = make_tma_map_bf16(&mp, wproj, C, C, kBoxRows);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((a.windows + a.wpb - 1) / a.wpb);
  const int smem = (int)AfLayout(C, a.heads, NWG, STAGED, CORE == kWgLanepack).total;
  return (int)launch_k<DH, NWG, STAGED, CORE>(m3, mp, a, grid, smem, (cudaStream_t)stream);
}

}  // namespace
}  // namespace fbanet
