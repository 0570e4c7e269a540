// K2's wgmma form (the bf16 fused LeFF: norm2 -> dense C->Ch -> tanh-GELU
// -> depthwise 3x3 -> tanh-GELU -> dense Ch->C [+ residual]), shared by
// leff.cu (K2's entries) and leff_variants.cu (K8's). What K2 computes, its
// rounding points and what bounds it are at the top of leff.cu.
//
// The form (ops/leff.py::_leff_plan picks the form and tile per shape; the
// first kernel, leff.cuh, stays for f32 and for bf16 shapes the plan does
// not send here) is K4's design run forwards:
//  - the W1 and W2^T slices of a hidden chunk arrive by TMA in 128-byte
//    swizzled atoms, one chunk ahead in a ring of two mbarrier slots;
//  - z1 = y W1^T runs on K-major wgmma over the tile's halo rows (a TH x TW
//    tile's (TH + 2)(TW + 2) halo tokens padded to whole 64-row blocks:
//    192 for 16 x 8, 128 for 8 x 8); bias and GELU in the epilogue, h1
//    rounded to bf16 in shared memory, 0 outside the image (the conv's
//    zero padding);
//  - the depthwise 3 x 3 takes every thread as (token, channel pair) work
//    items over 16 warps, taps and bias of the chunk in registers, f32 taps
//    and accumulator in K2's order, then GELU and the bf16 round, written as
//    h2^T (MN-major);
//  - out^T += W2^T_chunk^T h2^T runs on MN-major wgmma with the f32
//    accumulators in registers across all chunks (64 x 64 pieces, one per
//    warpgroup): no f32 accumulator tile in shared memory;
//  - 16 x 8 tiles where the pieces fit four warpgroups (C <= 128), 8 x 8
//    at C = 256.
//
// C = 32 (YP = 64, FBANet-32's enc0): y and the W1 / W2^T chunks are tiles
// of 64-byte rows (64-byte swizzle; TMA boxes 32 columns wide), so dense1
// is the same product with K = 32 (two k16 steps). dense2's out^T would put
// C = 32 in wgmma's M, below its 64 rows, so it runs token-major: out +=
// h2 W2^T_chunk, the tile's tokens as M in 64-row pieces (one a
// warpgroup), N = C = 32, K = the chunk; the depthwise stage writes h2
// token-major (K-major, rows of 2 kc bytes: the same bytes as h2^T) and the
// W2^T chunk is read MN-major, as K4's dy = dz1 W1 at C = 32. The halved y
// and weight tiles leave room for 16 x 16 tiles (a halo of 1.27x the tile's
// tokens, not 1.41x; each weight chunk loaded once for twice the tokens;
// four 64 x 32 pieces of out, one a warpgroup), so the forms at C = 32 are
// (16 x 16 | 16 x 8) x (64 | 32); K8's and K10's flags are not built there.
//
// K8 is this kernel with its two flags, the counterpart of the variant copy
// scripts/measure_swin_variants.py::_leff_var_kernel (no residual):
// GELUBF16 rounds z1 + b1 and the depthwise sum to bf16 and takes both
// GELUs in bf16 (gelu_bf16x2, leff.cuh); DWBF16 runs the depthwise stage's
// channel pairs in __nv_bfloat162 (leff.cuh's mul2 / add2: taps and bias
// rounded to bf16 once per chunk in registers, each product and add
// rounded, in depthwise_pairs' order). Both false is K2's instantiation,
// the flags' branches folded away at compile time.
//
// K10 is this kernel with two more flags, the counterpart of the ablation
// copy scripts/measure_swin_rates.py::_leff_abl_kernel (no residual):
// NOGELU makes both activations x * 0.7 (the z1 epilogue and the one after
// the depthwise sum; the rounding points stay K2's), NODW drops the
// depthwise stage: h2 = round(act(h1)) on the tile's interior tokens, read
// from h1 at their halo positions, with the taps and bdw never loaded; z1
// still runs over the whole halo, as the script's dense1 does. K10 sets one
// of them and neither of K8's.
#pragma once

#include "hopper.cuh"
#include "leff.cuh"

#include <cstdint>

namespace fbanet {
namespace {

constexpr int kFwThreads = 512;  // four warpgroups

struct FwArgs {
  const bf16* x;
  bf16* out;
  const float *ln_s, *ln_b, *b1, *wdw, *bdw, *b2;
  int H, W, C, Ch, residual;
};

// a th x tw tile: halo (+-1) YW wide, NY tokens padded to NYp (whole 64-row
// wgmma blocks); NI interior tokens
struct FwGeom {
  int th, tw, YW, NY, NYp, NI;
  __host__ __device__ constexpr FwGeom(int th_, int tw_)
      : th(th_), tw(tw_), YW(tw_ + 2), NY((th_ + 2) * (tw_ + 2)),
        NYp(((th_ + 2) * (tw_ + 2) + 63) & ~63), NI(th_ * tw_) {}
};

// Shared-memory layout (byte offsets from a 1024-byte aligned base): y
// [NYp rows] K-major in 64-channel atoms (at C = 32 one tile of 64-byte
// rows: 2 C bytes a row either way); the W1 and W2^T chunks, two ring
// slots each, as TMA lands them ([kc rows] of C); h2^T [kc rows] of NI
// tokens, MN-major (at C = 32 h2 [NI rows] of kc, K-major: the same
// bytes); h1 bf16 [NY][kc + 8]; the chunk's taps, b1 and bdw in f32; two
// mbarriers. After the chunk loop out [NI][C + 4] f32 reuses the space
// from 0 (the host checks it ends before the barriers).
struct FwLayout {
  int hp;
  size_t wslot, y, w1, w2t, h2t, h1, taps, b1, bdw, bars, total;
  __host__ __device__ FwLayout(int C, int kc, const FwGeom& q) {
    const size_t row = 2 * (size_t)C;  // bytes of a row of C bf16 channels
    wslot = kc * row;
    hp = kc + 8;
    y = 0;
    w1 = y + q.NYp * row;
    w2t = w1 + 2 * wslot;
    h2t = w2t + 2 * wslot;
    h1 = h2t + (q.NI / 64) * kc * 128;
    taps = h1 + align128(sizeof(bf16) * q.NY * hp);
    b1 = taps + align128(sizeof(float) * 9 * kc);
    bdw = b1 + align128(sizeof(float) * kc);
    bars = bdw + align128(sizeof(float) * kc);
    total = bars + 2 * sizeof(uint64_t) + 1024;  // + slack to align the base
  }
};

// K8's depthwise 3 x 3 + second GELU of the form, on the interior's NI
// tokens of a TW-wide tile, as h2^T (rows j, j + 1, column t): each thread
// keeps one channel pair j, j + 1 of the chunk. DWBF16: the taps and bias
// rounded to bf16 pairs once, each product and add rounded
// (depthwise_pairs' order), the GELU in f32 on the bf16 sum or, with
// GELUBF16, in bf16; else K2's f32 taps and sum, rounded for the bf16 GELU.
template <int KC, int TW, int NT, int NI, bool DWBF16, bool GELUBF16>
__device__ __forceinline__ void depthwise_pairs_wgmma(const bf16* sH1, int hp, int YW,
                                                      const float* sTaps, const float* sBdw,
                                                      uint8_t* sH2t) {
  constexpr int P = KC / 2;
  const int j = 2 * (threadIdx.x % P);
  float2 wt[9];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
    wt[tap] = *reinterpret_cast<const float2*>(sTaps + tap * KC + j);
  const float2 bdw = *reinterpret_cast<const float2*>(sBdw + j);
  __nv_bfloat162 wt2[9];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) wt2[tap] = __floats2bfloat162_rn(wt[tap].x, wt[tap].y);
  const __nv_bfloat162 bdw2 = __floats2bfloat162_rn(bdw.x, bdw.y);
  for (int t = threadIdx.x / P; t < NI; t += NT / P) {
    const int ti = t / TW, tj = t % TW;
    __nv_bfloat162 z;
    if constexpr (DWBF16) {
      z = bdw2;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
          z = add2(z, mul2(from_bits(*reinterpret_cast<const uint32_t*>(
                               sH1 + ((ti + ky) * YW + tj + kx) * hp + j)),
                           wt2[ky * 3 + kx]));
    } else {
      float2 acc = bdw;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float2 hv = unpack_bf2(*reinterpret_cast<const uint32_t*>(
              sH1 + ((ti + ky) * YW + tj + kx) * hp + j));
          acc.x += hv.x * wt[ky * 3 + kx].x;
          acc.y += hv.y * wt[ky * 3 + kx].y;
        }
      z = __floats2bfloat162_rn(acc.x, acc.y);
    }
    const uint32_t w = GELUBF16 ? bits(gelu_bf16x2(z))
                                : pack_bf2(gelu_tanh(__low2float(z)), gelu_tanh(__high2float(z)));
    uint8_t* col = sH2t + (size_t)(t / 64) * KC * 128 + (t % 8) * 2;
    *reinterpret_cast<uint16_t*>(col + swz(j, (t % 64) / 8)) = (uint16_t)(w & 0xffffu);
    *reinterpret_cast<uint16_t*>(col + swz(j + 1, (t % 64) / 8)) = (uint16_t)(w >> 16);
  }
}

// K10's stage in place of the depthwise 3 x 3 + GELU, on the interior's NI
// tokens as h2^T: NODW h2 = round(act(h1)) (h1 at the token's halo
// position), else K2's f32 taps and sum in K2's order; act is x * 0.7 with
// NOGELU, else the tanh GELU, on the f32 value, rounded once.
template <int KC, int TW, int NT, int NI, bool NOGELU, bool NODW>
__device__ __forceinline__ void depthwise_ablation_wgmma(const bf16* sH1, int hp, int YW,
                                                         const float* sTaps, const float* sBdw,
                                                         uint8_t* sH2t) {
  constexpr int P = KC / 2;
  auto act = [](float v) { return NOGELU ? v * 0.7f : gelu_tanh(v); };
  const int j = 2 * (threadIdx.x % P);
  float2 wt[9], bdw = make_float2(0.f, 0.f);
  if constexpr (!NODW) {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      wt[tap] = *reinterpret_cast<const float2*>(sTaps + tap * KC + j);
    bdw = *reinterpret_cast<const float2*>(sBdw + j);
  }
  for (int t = threadIdx.x / P; t < NI; t += NT / P) {
    const int ti = t / TW, tj = t % TW;
    float2 z;
    if constexpr (NODW) {
      z = unpack_bf2(*reinterpret_cast<const uint32_t*>(sH1 + ((ti + 1) * YW + tj + 1) * hp + j));
    } else {
      z = bdw;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float2 hv = unpack_bf2(*reinterpret_cast<const uint32_t*>(
              sH1 + ((ti + ky) * YW + tj + kx) * hp + j));
          z.x += hv.x * wt[ky * 3 + kx].x;
          z.y += hv.y * wt[ky * 3 + kx].y;
        }
    }
    const uint32_t w = pack_bf2(act(z.x), act(z.y));
    uint8_t* col = sH2t + (size_t)(t / 64) * KC * 128 + (t % 8) * 2;
    *reinterpret_cast<uint16_t*>(col + swz(j, (t % 64) / 8)) = (uint16_t)(w & 0xffffu);
    *reinterpret_cast<uint16_t*>(col + swz(j + 1, (t % 64) / 8)) = (uint16_t)(w >> 16);
  }
}

template <int KC, int TH, int TW, bool DWBF16 = false, bool GELUBF16 = false,
          bool NOGELU = false, bool NODW = false, int YP = 128>
__global__ void __launch_bounds__(kFwThreads, 1)
    leff_wgmma_kernel(const __grid_constant__ CUtensorMap map_w1,
                      const __grid_constant__ CUtensorMap map_w2t, FwArgs a) {
  constexpr int NT = kFwThreads, NW = NT / 32, NWG = NT / 128;
  constexpr int P = KC / 2;  // channel pairs of a chunk
  static_assert(KC == 32 || KC == 64, "the chunk widths instantiated here");
  static_assert(NT % P == 0, "the depthwise stage keeps one channel pair per thread");
  static_assert(!((NOGELU || NODW) && (DWBF16 || GELUBF16)), "K10's flags go without K8's");
  // YP: bytes of a row of the y and weight tiles, 128 (C >= 64: atoms of 64
  // channels) or 64 (C = 32: one tile of 64-byte rows, token-major dense2)
  static_assert(YP == 128 || (YP == 64 && TH == 16 && !(DWBF16 || GELUBF16 || NOGELU || NODW)),
                "C = 32 is built for K2 alone, 16 x 16 and 16 x 8 tiles");
  constexpr int KS = YP / 32;  // k16 steps along a row of the y and weight tiles
  constexpr int ON = YP == 128 ? 64 : 32;  // accumulator columns of a piece of out
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  constexpr FwGeom q(TH, TW);
  const int C = a.C, atomsC = 2 * C / YP;  // tiles of YP-byte rows across C
  const FwLayout L(C, KC, q);
  const int hp = L.hp;
  uint8_t* sY = sm + L.y;
  uint8_t* sH2t = sm + L.h2t;
  bf16* sH1 = reinterpret_cast<bf16*>(sm + L.h1);
  float* sTaps = reinterpret_cast<float*>(sm + L.taps);
  float* sB1 = reinterpret_cast<float*>(sm + L.b1);
  float* sBdw = reinterpret_cast<float*>(sm + L.bdw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bars);  // ring slots 0, 1

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4;
  const int tiles_w = a.W / TW, tiles_h = a.H / TH;
  const int tx = blockIdx.x % tiles_w, ty = (blockIdx.x / tiles_w) % tiles_h;
  const int b = blockIdx.x / (tiles_w * tiles_h);
  const int r0 = ty * TH - 1, c0 = tx * TW - 1;  // image coords of halo (0, 0)
  auto inside = [&](int hr, int hc) {
    const int r = r0 + hr, c = c0 + hc;
    return r >= 0 && r < a.H && c >= 0 && c < a.W;
  };
  auto pix = [&](int hr, int hc) -> size_t {
    return ((size_t)b * a.H + r0 + hr) * a.W + c0 + hc;
  };
  const int nck = a.Ch / KC;
  const uint32_t wbytes = (uint32_t)C * KC * 2;
  auto load = [&](int ck, int slot) {  // W1 and W2^T rows ck KC .. + KC
    uint64_t* bar = &bars[slot];
    mbar_expect_tx(bar, 2 * wbytes);
    for (int at = 0; at < atomsC; ++at) {
      tma_load_2d(sm + L.w1 + slot * L.wslot + at * KC * YP, &map_w1, at * (YP / 2), ck * KC,
                  bar);
      tma_load_2d(sm + L.w2t + slot * L.wslot + at * KC * YP, &map_w2t, at * (YP / 2), ck * KC,
                  bar);
    }
  };
  // K-major descriptor of k16 step k of 64-row block mb of a tile of `rows`
  // rows (y, or a weight chunk with rows = KC)
  auto k_step = [](const uint8_t* base, int rows, int mb, int k) {
    return k_desc_at(smem_addr(base + (size_t)(k / KS) * rows * YP + mb * 64 * YP + (k % KS) * 32),
                     YP);
  };

  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    tma_prefetch_map(&map_w1);
    tma_prefetch_map(&map_w2t);
    load(0, 0);
  }

  // --- LN of the halo into y (0 outside the image and in the padding) ---
  {
    const int seg = C / 8, sl = lane % seg, sub = lane / seg, tpw = 32 / seg;
    float s8[8], b8[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s8[i] = __ldg(a.ln_s + 8 * sl + i);
      b8[i] = __ldg(a.ln_b + 8 * sl + i);
    }
    uint8_t* ydst = sY + (size_t)(sl / (YP / 16)) * q.NYp * YP;
    for (int t0 = warp * tpw; t0 < q.NYp; t0 += NW * tpw) {  // warp-uniform
      const int t = t0 + sub, hr = t / q.YW, hc = t % q.YW;
      const bool ok = t < q.NY && inside(hr, hc);
      float v[8] = {};
      if (ok)
        unpack_bf8(__ldg(reinterpret_cast<const uint4*>(a.x + pix(hr, hc) * C + 8 * sl)), v);
      float mu, inv;
      ln_stats8(v, seg, C, &mu, &inv);
      if (t >= q.NYp) continue;
      uint4 y = make_uint4(0, 0, 0, 0);
      if (ok) {
        float yv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) yv[i] = (v[i] - mu) * inv * s8[i] + b8[i];
        y = make_uint4(pack_bf2(yv[0], yv[1]), pack_bf2(yv[2], yv[3]), pack_bf2(yv[4], yv[5]),
                       pack_bf2(yv[6], yv[7]));
      }
      *reinterpret_cast<uint4*>(ydst + swz_at(t, 16 * (sl % (YP / 16)), YP)) = y;
    }
  }
  fence_proxy_async();  // y is read by wgmma (ordered by the loop's first barrier)

  // out^T in 64 x 64 pieces (C block cb, token block tb), at most 4:
  // warpgroup wg holds piece wg in its registers over the chunks. At
  // YP = 64: out in 64 x C pieces (token block wg)
  const int npieces = YP == 128 ? atomsC * (q.NI / 64) : q.NI / 64;
  const bool has_piece = wg < npieces;
  const int cb = YP == 128 ? wg / (q.NI / 64) : 0, tb = YP == 128 ? wg % (q.NI / 64) : wg;
  float oacc[ON / 2];
#pragma unroll
  for (int i = 0; i < ON / 2; ++i) oacc[i] = 0.f;
  // this thread's rows and columns in a wgmma accumulator
  const int arow = 16 * (warp % 4) + lane / 4, acol = 2 * (lane % 4);

  for (int i = 0; i < nck; ++i) {
    const int k0 = i * KC;
    for (int e = threadIdx.x; e < 11 * KC; e += NT) {
      const int j = e % KC, r = e / KC;
      if constexpr (NODW) {  // K10 nodw: b1 only
        if (r != 9) continue;
      }
      if (r < 9)
        sTaps[r * KC + j] = a.wdw[(size_t)(k0 + j) * 9 + r];
      else
        (r == 9 ? sB1 : sBdw)[j] = (r == 9 ? a.b1 : a.bdw)[k0 + j];
    }
    __syncthreads();  // also: chunk i - 1 is done with ring slot (i + 1) & 1, h1 and h2^T
    if (threadIdx.x == 0 && i + 1 < nck) load(i + 1, (i + 1) & 1);
    mbar_wait(&bars[i & 1], (i >> 1) & 1);
    const uint8_t* w1s = sm + L.w1 + (i & 1) * L.wslot;
    const uint8_t* w2s = sm + L.w2t + (i & 1) * L.wslot;

    // z1 = y W1^T + b1 on the halo: h1 = round(gelu(z1)), 0 outside the image
    for (int mb = wg; mb * 64 < q.NY; mb += NWG) {
      float acc[KC / 2];
#pragma unroll
      for (int j = 0; j < KC / 2; ++j) acc[j] = 0.f;
      wgmma_fence();
      for (int k = 0; k < C / 16; ++k)
        wgmma_ss<KC, 0, 0>(acc, k_step(sY, q.NYp, mb, k), k_step(w1s, KC, 0, k));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int jj = 0; jj < KC / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = mb * 64 + arow + 8 * h, col = 8 * jj + acol;
          if (row >= q.NY) continue;
          uint32_t v = 0u;
          if constexpr (GELUBF16) {  // K8: z1 + b1 rounded, the GELU in bf16
            if (inside(row / q.YW, row % q.YW))
              v = bits(gelu_bf16x2(__floats2bfloat162_rn(acc[4 * jj + 2 * h] + sB1[col],
                                                         acc[4 * jj + 2 * h + 1] + sB1[col + 1])));
          } else if constexpr (NOGELU) {  // K10: act = x * 0.7
            if (inside(row / q.YW, row % q.YW))
              v = pack_bf2((acc[4 * jj + 2 * h] + sB1[col]) * 0.7f,
                           (acc[4 * jj + 2 * h + 1] + sB1[col + 1]) * 0.7f);
          } else {
            if (inside(row / q.YW, row % q.YW))
              v = pack_bf2(gelu_tanh(acc[4 * jj + 2 * h] + sB1[col]),
                           gelu_tanh(acc[4 * jj + 2 * h + 1] + sB1[col + 1]));
          }
          *reinterpret_cast<uint32_t*>(sH1 + row * hp + col) = v;
        }
    }
    __syncthreads();

    // depthwise 3 x 3 on the interior (f32 taps in order), GELU, rounded:
    // h2^T rows j, j + 1, column t (at YP = 64 h2 row t, columns j, j + 1).
    // A thread keeps one channel pair (NT is a multiple of P) and its taps
    // in registers
    if constexpr (DWBF16 || GELUBF16) {
      depthwise_pairs_wgmma<KC, TW, NT, q.NI, DWBF16, GELUBF16>(sH1, hp, q.YW, sTaps, sBdw, sH2t);
    } else if constexpr (NOGELU || NODW) {
      depthwise_ablation_wgmma<KC, TW, NT, q.NI, NOGELU, NODW>(sH1, hp, q.YW, sTaps, sBdw, sH2t);
    } else {
      const int j = 2 * (threadIdx.x % P);
      float2 wt[9];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        wt[tap] = *reinterpret_cast<const float2*>(sTaps + tap * KC + j);
      const float2 bdw = *reinterpret_cast<const float2*>(sBdw + j);
      for (int t = threadIdx.x / P; t < q.NI; t += NT / P) {
        const int ti = t / TW, tj = t % TW;
        float2 z = bdw;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float2 hv = unpack_bf2(*reinterpret_cast<const uint32_t*>(
                sH1 + ((ti + ky) * q.YW + tj + kx) * hp + j));
            z.x += hv.x * wt[ky * 3 + kx].x;
            z.y += hv.y * wt[ky * 3 + kx].y;
          }
        const uint32_t w = pack_bf2(gelu_tanh(z.x), gelu_tanh(z.y));
        if constexpr (YP == 128) {
          uint8_t* col = sH2t + (size_t)(t / 64) * KC * 128 + (t % 8) * 2;
          *reinterpret_cast<uint16_t*>(col + swz(j, (t % 64) / 8)) = (uint16_t)(w & 0xffffu);
          *reinterpret_cast<uint16_t*>(col + swz(j + 1, (t % 64) / 8)) = (uint16_t)(w >> 16);
        } else {
          *reinterpret_cast<uint32_t*>(sH2t + swz_at(t, 2 * j, 2 * KC)) = w;
        }
      }
    }
    fence_proxy_async();  // h2^T is read by wgmma next
    __syncthreads();

    // out^T += (W2^T chunk)^T h2^T on this warpgroup's piece (at YP = 64:
    // out += h2 W2^T chunk, h2 K-major as A, the W2^T chunk MN-major as B)
    if (has_piece) {
      wgmma_fence();
      if constexpr (YP == 128) {
#pragma unroll
        for (int k = 0; k < KC / 16; ++k)
          wgmma_ss<64, 1, 1>(oacc,
                             mn_major_desc(smem_addr(w2s + cb * KC * 128 + k * 2048), KC * 128),
                             mn_major_desc(smem_addr(sH2t + tb * KC * 128 + k * 2048), KC * 128));
      } else {
#pragma unroll
        for (int k = 0; k < KC / 16; ++k)
          wgmma_ss<ON, 0, 1>(oacc, k_desc_at(smem_addr(sH2t + tb * 64 * 2 * KC + k * 32), 2 * KC),
                             mn_desc_at(smem_addr(w2s + k * 16 * YP), KC * YP, YP));
      }
      wgmma_commit();
      wgmma_wait_all();
    }
  }

  // --- out = acc + b2 (+ x), through [NI][C + 4] f32 over the chunk space ---
  __syncthreads();
  const int ldo = C + 4;
  float* sOut = reinterpret_cast<float*>(sm);
  if (has_piece) {
#pragma unroll
    for (int jj = 0; jj < ON / 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = oacc[4 * jj + 2 * h + e];
          if constexpr (YP == 128)  // out^T: row = channel, column = token
            sOut[(tb * 64 + 8 * jj + acol + e) * ldo + cb * 64 + arow + 8 * h] = v;
          else  // out: row = token, column = channel
            sOut[(tb * 64 + arow + 8 * h) * ldo + 8 * jj + acol + e] = v;
        }
  }
  __syncthreads();
  const int c8s = C / 8;
  for (int e = threadIdx.x; e < q.NI * c8s; e += NT) {
    const int t = e / c8s, c8 = e % c8s;
    const size_t p = pix(1 + t / TW, 1 + t % TW) * C + 8 * c8;
    const float4 u0 = *reinterpret_cast<const float4*>(sOut + t * ldo + 8 * c8);
    const float4 u1 = *reinterpret_cast<const float4*>(sOut + t * ldo + 8 * c8 + 4);
    float v[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] += a.b2[8 * c8 + i];
    if (a.residual) {
      float xv[8];
      unpack_bf8(__ldg(reinterpret_cast<const uint4*>(a.x + p)), xv);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] += xv[i];
    }
    *reinterpret_cast<uint4*>(a.out + p) =
        make_uint4(pack_bf2(v[0], v[1]), pack_bf2(v[2], v[3]), pack_bf2(v[4], v[5]),
                   pack_bf2(v[6], v[7]));
  }
}

template <int KC, int TH, int TW, bool DWBF16 = false, bool GELUBF16 = false,
          bool NOGELU = false, bool NODW = false, int YP = 128>
cudaError_t launch_wgmma(const CUtensorMap& m1, const CUtensorMap& m2, const FwArgs& a,
                         unsigned grid, int smem, cudaStream_t s) {
  const cudaError_t e =
      cudaFuncSetAttribute(leff_wgmma_kernel<KC, TH, TW, DWBF16, GELUBF16, NOGELU, NODW, YP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  leff_wgmma_kernel<KC, TH, TW, DWBF16, GELUBF16, NOGELU, NODW, YP>
      <<<grid, kFwThreads, smem, s>>>(m1, m2, a);
  return cudaGetLastError();
}

// Dynamic shared memory of the form for tile th x tw and hidden chunk kc,
// or 0 for one it does not take: at C 64, 128 or 256 the forms (th, tw, kc)
// = (16, 8, 64), (16, 8, 32), (8, 8, 64), (8, 8, 32), at most four 64 x 64
// pieces of out per tile; at C = 32 (16, 16, 64), (16, 16, 32), (16, 8,
// 64), (16, 8, 32), pieces of 64 x 32.
inline int leff_wgmma_smem(int C, int th, int tw, int kc) {
  const bool form = C == 32 ? th == 16 && (tw == 16 || tw == 8) && (kc == 32 || kc == 64)
                            : (th == 16 || th == 8) && tw == 8 && (kc == 32 || kc == 64);
  if ((C % 64 && C != 32) || C > 256 || !form) return 0;
  const FwGeom q(th, tw);
  if ((C >= 64 ? C / 64 : 1) * (q.NI / 64) > 4) return 0;
  const FwLayout L(C, kc, q);
  if ((size_t)q.NI * (C + 4) * sizeof(float) > L.bars) return 0;
  return (int)L.total;
}

// Launch the form <kc, th, tw, DWBF16, GELUBF16, NOGELU, NODW> on a bf16
// map (w2t = W2^T [Ch, C]); the caller has checked th x tw divides H x W
// and kc divides Ch. C32: the C = 32 forms are built too, for K2's own
// entry only (K8's and K10's entries refuse C = 32).
template <bool DWBF16, bool GELUBF16, bool NOGELU = false, bool NODW = false, bool C32 = false>
int launch_leff_form(const void* w1, const void* w2t, const FwArgs& a, int B, int th, int tw,
                     int kc, void* stream) {
  static_assert(!C32 || !(DWBF16 || GELUBF16 || NOGELU || NODW), "C = 32 is K2's own form");
  const int smem = leff_wgmma_smem(a.C, th, tw, kc);
  if (smem == 0 || smem > 232448 || (!C32 && a.C == 32)) return (int)cudaErrorInvalidValue;
  const int box_cols = a.C == 32 ? 32 : 64;
  CUtensorMap map_w1, map_w2t;
  cudaError_t e = make_tma_map_bf16(&map_w1, w1, a.Ch, a.C, kc, box_cols);
  if (e == cudaSuccess) e = make_tma_map_bf16(&map_w2t, w2t, a.Ch, a.C, kc, box_cols);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)B * (a.H / th) * (a.W / tw);
  const cudaStream_t s = (cudaStream_t)stream;
  if constexpr (C32) {
    if (a.C == 32) {
      if (tw == 16)
        e = kc == 64 ? launch_wgmma<64, 16, 16, false, false, false, false, 64>(map_w1, map_w2t,
                                                                                a, grid, smem, s)
                     : launch_wgmma<32, 16, 16, false, false, false, false, 64>(map_w1, map_w2t,
                                                                                a, grid, smem, s);
      else
        e = kc == 64 ? launch_wgmma<64, 16, 8, false, false, false, false, 64>(map_w1, map_w2t,
                                                                               a, grid, smem, s)
                     : launch_wgmma<32, 16, 8, false, false, false, false, 64>(map_w1, map_w2t,
                                                                               a, grid, smem, s);
      return (int)e;
    }
  }
  if (th == 16)
    e = kc == 64 ? launch_wgmma<64, 16, 8, DWBF16, GELUBF16, NOGELU, NODW>(map_w1, map_w2t, a,
                                                                          grid, smem, s)
                 : launch_wgmma<32, 16, 8, DWBF16, GELUBF16, NOGELU, NODW>(map_w1, map_w2t, a,
                                                                          grid, smem, s);
  else
    e = kc == 64 ? launch_wgmma<64, 8, 8, DWBF16, GELUBF16, NOGELU, NODW>(map_w1, map_w2t, a,
                                                                         grid, smem, s)
                 : launch_wgmma<32, 8, 8, DWBF16, GELUBF16, NOGELU, NODW>(map_w1, map_w2t, a,
                                                                         grid, smem, s);
  return (int)e;
}
}  // namespace
}  // namespace fbanet
