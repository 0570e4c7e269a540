// K3's wgmma form: the backward of K1 (fused norm1 + window attention) in
// bf16, for 8 x 8 windows (64 tokens), C = 64, 128 or 256 and head size 8,
// 16, 32 or 64, or C = 32 with one head of 32 (FBANet-32's enc0), on the
// post-roll map [B, H, W, C] or on pre-partitioned windows
// [G, 64, C] (K1b's backward). The function, its outputs and its rounding
// points are those of the first kernel (attention_bwd.cuh, kept for f32
// and for the shapes ops/attention.py::_attention_bwd_plan does not send
// here); what changes is how the card runs it. Entries: K3's in
// attention_bwd_wgmma.cu (SKIP = 0), K11's in
// attention_bwd_wgmma_ablation.cu, a file of its own so that nvcc builds
// its instantiations in parallel with K3's.
//
// The first kernel gives one 256-thread block to each window, runs every
// product as WMMA 16 x 16 x 16 with the weight operand read from device
// memory per tile, walks the heads one after another with five block-wide
// barriers each, makes round trips of the softmax through f32 shared
// memory, reads back the dq / dk / dv it wrote for its dy product, and
// writes one f32 partial row of 6C + heads 64 64 floats per window
// (429 MB at dec1, B = 8). This form:
//  - walks a fixed, contiguous list of windows per block (`wpb` of them,
//    one or two resident blocks per SM), so the parameter-gradient
//    partials are summed over the block's windows in window order before
//    they are written: one row per block (no float atomics; the sums
//    repeat bitwise);
//  - splits every dense product (do = g Wproj, q | k | v = y [Wq; Wkv]^T,
//    dy = [dq dk dv] [Wq; Wkv]) into 64-row pieces that the warpgroups
//    take in turn; each warpgroup streams its weight boxes (64 columns x
//    32 rows, 128-byte swizzled) through its own two-slot TMA ring with
//    mbarriers, and runs the pieces on wgmma with f32 accumulators in
//    registers;
//  - keeps q, k, v and do as one shared-memory tile per head whose rows
//    are the head's 2 dh bytes (swizzled at that pitch, hopper.cuh), so
//    each head is a K-major and an MN-major wgmma operand of its own;
//  - runs the per-head core on the warpgroups concurrently (head h on
//    warpgroup h mod NWG, synchronised by named barriers, not by the
//    block): logits q k^T and dp = do v^T as m64n64 products, softmax and
//    dsoftmax on the accumulator fragments with row sums by shuffles, p and
//    dlogits rounded to bf16 at the first kernel's points and fed to
//    o = p v and dq = dlogits k as register A operands, and to dv = p^T do
//    and dk = dlogits^T q through one bf16 64 x 64 tile per warpgroup;
//  - writes the rounded dq, dk, dv over the head's q, k, v tiles, where
//    dy's product reads them (and once to device memory for R1's weight
//    gradients), so nothing is read back from device memory.
// What bounds it on the H100: arithmetic, as the first kernel; per block
// the window's steps run in order, with eight block barriers per window.
//
// Head sizes 32 and 8 (embed 32, the configuration's default): a head of 32
// is a tile of 64-byte rows (64-byte swizzle), two k16 steps of q k^T and
// do v^T, n32 products for the rest. A head of 8 has no swizzle mode of its
// own (16-byte rows), so each head is held zero-padded to 16 columns
// (common.cuh's head_pitch, as the first kernels hold it): the tiles of do,
// q, k and v take 2 C columns, their epilogues write the pad's zeros with
// the values, q k^T and do v^T are one k16 step with a zero half, and
// o = p v, dv = p^T do, dq = dlogits k and dk = dlogits^T q run as n16
// products whose pad columns (exact zeros) are dropped. dy's product takes
// the padded head tiles as A, one k16 step a head, against [Wq; Wkv] from
// a TMA map that inserts 8 zero rows after each 8 (hopper.cuh's
// make_tma_map_bf16_pad8): twice the boxes of the other head sizes.
//
// C = 32 (YP = 64): the y | g tile has 64-byte rows (64-byte swizzle, the
// head-32 tile), the weight boxes are 32 columns wide (64-byte swizzled
// TMA), do and dy are one 64 x 32 piece each (n32, K 32 and 96), q | k | v
// three pieces of 32 columns with K = 32. With a single head a second
// warpgroup would idle through the core, so the form runs one warpgroup a
// block (NWG = 1), four blocks an SM (~40 KB of shared memory each), each
// walking its consecutive windows as at C >= 64. Measured against two
// warpgroups a block, each walking every other window of the block's list
// with a layout, ring and barrier of its own and the two partials added
// into the block's row: 0.3458 against 0.3813 device ms at FBANet-32's
// enc0, B=8 (H100), and the second design raised the spills of the other
// instantiations.
//
// K11 is this kernel with the stages in SKIP (common.cuh's kNo* bits, one
// at a time) removed at compile time, each bit as the first kernel's and
// ops/attention.py::attention_bwd_math's: norecompute (no LayerNorm and no
// q | k | v product: mu = 0, inv = 1, xhat = y = x, and the q, k and v
// head tiles filled from x), nodsoftmax (dlogits = dp / 64), nowgrads (no
// o = p v, no per-token scratch, no column or bias partials: part is not
// written), nodx (no dy product and no LN backward: dx = x, and dy = x for
// the LN partials), nocore (no per-head stage and no q | k | v product,
// whose values only it reads: o = dq = dk = dv = do, dy's product reads
// the do tiles, the bq / bkv partials are the f32 do's column sums and the
// bias rows 0). The changed math is deliberate: the variants split K3's
// time by stage. SKIP = 0 is K3's instantiation, every branch of the bits
// folded away at compile time.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

#include <cstdint>

namespace fbanet {
namespace {

constexpr int kWinTok = 64;        // tokens of an 8 x 8 window
constexpr int kBoxRows = 32;       // weight rows of one TMA box (64 columns wide)
constexpr int kBoxBytes = 64 * kBoxRows * 2;  // a ring slot (a box of 32 columns fills half)

struct AbArgs {
  const bf16 *x, *g;
  bf16 *dx, *ys, *os, *dqs, *dkvs;  // dx out; per-token scratch for R1
  float* part;                      // [blocks][6C + heads 64 64] partial sums
  const float *ln_s, *ln_b, *bq, *bkv, *bias, *mask;
  WinGeom geom;
  int heads, residual, windows, wpb;
};

// Shared-memory layout (byte offsets from a 1024-byte aligned base) for C
// channels, `heads` heads and NWG warpgroups: y | g [64 rows] K-major in
// 64-channel atoms (g until do is formed, then y); do, q, k, v, each 64 x C
// bf16 as per-head tiles (64 x 2 C at head size 8, each head padded to 16
// columns); each warpgroup's ring of two weight boxes; each
// warpgroup's p / dlogits tile (64 x 64 bf16, MN-major), over y | g where
// that is large enough; the column-sum scratch (NWG x 4 warps x 64
// floats); the block's running column partials (6C floats: LN scale and
// bias, bq, bkv, bproj, summed over its windows and written once);
// LayerNorm statistics; the ring barriers. After the dy product
// dy [64][C + 4] f32 and the column sums' scratch reuse the space from 0
// (the host checks they end before the rings).
struct AbLayout {
  size_t yg, d_o, q, k, v, ring, pt, cs, colp, mu, inv, bars, total, red, red_end;
  __host__ __device__ AbLayout(int C, int heads, int nwg) {
    const size_t t = (size_t)128 * C;  // one 64 x C bf16 tensor
    const size_t ht = (size_t)128 * heads * head_pitch(C / heads);  // one as head tiles
    yg = 0;
    d_o = t;
    q = t + ht;
    k = t + 2 * ht;
    v = t + 3 * ht;
    ring = t + 4 * ht;
    const size_t after = ring + (size_t)nwg * 2 * kBoxBytes;
    pt = t >= (size_t)nwg * 8192 ? 0 : after;
    cs = pt == 0 ? after : after + (size_t)nwg * 8192;
    colp = cs + (size_t)nwg * 4 * 64 * sizeof(float);
    mu = colp + align128(sizeof(float) * 6 * C);
    inv = mu + kWinTok * sizeof(float);
    bars = inv + kWinTok * sizeof(float);
    total = bars + (size_t)nwg * 2 * sizeof(uint64_t) + 1024;  // + slack to align the base
    red = align128(sizeof(float) * kWinTok * (C + 4));
    red_end = red + sizeof(float) * 3 * nwg * 128;
  }
};

// Dynamic shared memory of the form with `nwg` warpgroups, or 0 for a
// shape it does not take: 64-token windows, C 64, 128 or 256, head size 8,
// 16, 32 or 64, nwg 4 (or 2 at C <= 128: each warpgroup holds at most one
// 64-column piece of dy), or C = 32 with one head on one warpgroup, within
// 232,448 bytes (head size 8's padded tiles exceed it at C = 256).
inline int bwd_wgmma_smem(int n, int C, int heads, int nwg) {
  if (n != kWinTok || (C % 64 && C != 32) || C > 256 || heads < 1 || C % heads) return 0;
  const int dh = C / heads;
  if (C == 32 ? heads != 1 || nwg != 1
              : (dh != 8 && dh != 16 && dh != 32 && dh != 64) || (nwg != 4 && nwg != 2) ||
                    C > 64 * nwg)
    return 0;
  const AbLayout L(C, heads, nwg);
  if (L.red_end > L.ring || L.total > 232448) return 0;  // at most the H100's 227 KB a block
  return (int)L.total;
}

template <int DH, int NWG, int SKIP, int YP>
__global__ void __launch_bounds__(NWG * 128, 4 / NWG)
    attention_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_w3,
                               const __grid_constant__ CUtensorMap map_wproj,
                               const __grid_constant__ CUtensorMap map_w3p, AbArgs a) {
  // the stages this instantiation runs (all of them for K3, SKIP = 0)
  constexpr bool RECOMPUTE = !(SKIP & kNoRecompute), DSOFTMAX = !(SKIP & kNoDsoftmax);
  constexpr bool WGRADS = !(SKIP & kNoWgrads), DXCHAIN = !(SKIP & kNoDx);
  constexpr bool CORE = !(SKIP & kNoCore), QKV = RECOMPUTE && CORE;
  constexpr int NT = NWG * 128, NW = NT / 32;
  constexpr int HP = head_pitch(DH);       // columns of a head tile (DH, or 16 at DH 8)
  constexpr int PAD = HP / DH;             // 2 at DH 8: a zero column per head column
  constexpr int PITCH = 2 * HP;            // bytes per row of a head tile
  constexpr uint32_t HT = 64 * PITCH;      // bytes of a head tile
  static_assert(DH == 8 || DH == 16 || DH == 32 || DH == 64, "the head sizes instantiated here");
  static_assert(SKIP == 0 || DH == 16 || DH == 64, "K11 is built at head sizes 16 and 64");
  // YP: bytes of a row of the y | g tile and of a weight box, 128 (C >= 64)
  // or 64 (C = 32); BW: the box's columns, the width of a do or dy piece
  static_assert(YP == 128 || (YP == 64 && DH == 32 && NWG == 1 && SKIP == 0),
                "C = 32 is built for one head of 32 on one warpgroup");
  constexpr int BW = YP / 2;
  constexpr uint32_t kBoxBytesC = kBoxRows * YP;  // bytes of one 2-D box
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int C = a.geom.C, heads = a.heads;
  const AbLayout L(C, heads, NWG);
  uint8_t* sYG = sm + L.yg;
  uint8_t* sDo = sm + L.d_o;
  uint8_t* sQ = sm + L.q;
  uint8_t* sK = sm + L.k;
  uint8_t* sV = sm + L.v;
  float* sMu = reinterpret_cast<float*>(sm + L.mu);
  float* sInv = reinterpret_cast<float*>(sm + L.inv);
  float* sDy = reinterpret_cast<float*>(sm);  // after the dy product
  float* red = reinterpret_cast<float*>(sm + L.red);
  const int ldy = C + 4;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4, wl = warp % 4;
  const int arow = 16 * wl + lane / 4, acol = 2 * (lane % 4);  // accumulator rows / columns
  uint8_t* ring = sm + L.ring + (size_t)wg * 2 * kBoxBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bars) + 2 * wg;
  uint8_t* sP = sm + L.pt + (size_t)wg * 8192;
  float* cs = reinterpret_cast<float*>(sm + L.cs) + wg * 4 * 64;
  float* colp = reinterpret_cast<float*>(sm + L.colp);  // the block's 6C partials
  const bool producer = threadIdx.x % 128 == 0;
  const int wbar = 1 + wg;  // this warpgroup's named barrier

  auto desc_k = [](const uint8_t* p) {  // a head tile, K-major
    return smem_desc(smem_addr(p), 16, 16 * HP, sw_layout(PITCH));
  };
  auto desc_mn = [](const uint8_t* p) {  // a head tile, MN-major
    return smem_desc(smem_addr(p), HT, 16 * HP, sw_layout(PITCH));
  };
  // byte offset of 16-byte chunk c8 (channels 8 c8 .. 8 c8 + 7) of token t
  // in the y | g tile: atoms of 64-channel rows, or at C = 32 one tile of
  // 64-byte rows
  auto yg_off = [](int t, int c8) -> uint32_t {
    return (uint32_t)(c8 / (YP / 16)) * 64 * YP + swz_at(t, 16 * (c8 % (YP / 16)), YP);
  };
  // (row, column c) of the tensor held as per-head tiles from `base`
  auto tile_at = [&](uint8_t* base, int row, int c) {
    return base + (c / DH) * HT + swz_at(row, (c % DH) * 2, PITCH);
  };
  // the pair (row, c), (row, c + 1) rounded into the head tiles; at head
  // size 8 zeros into the same pair of the head's pad columns too
  auto put_pair = [&](uint8_t* base, int row, int c, uint32_t w) {
    *reinterpret_cast<uint32_t*>(tile_at(base, row, c)) = w;
    if constexpr (PAD > 1)
      *reinterpret_cast<uint32_t*>(base + (c / DH) * HT + swz_at(row, (c % DH + DH) * 2, PITCH)) =
          0u;
  };

  // --- the warpgroup's weight boxes, in the order it consumes them: per
  // window its do pieces (K over Wproj rows), its q | k | v pieces (32 rows
  // of [Wq; Wkv], K over columns), its dy pieces (K over [Wq; Wkv] rows) ---
  const int kD = C / kBoxRows, kQ = C / BW, kY = PAD * 3 * C / kBoxRows;  // boxes per piece
  auto owned = [&](int pieces) { return pieces > wg ? (pieces - wg + NWG - 1) / NWG : 0; };
  const int nD = owned(C / BW) * kD, nQ = QKV ? owned(3 * C / kBoxRows) * kQ : 0,
            nY = DXCHAIN ? owned(C / BW) * kY : 0, per_win = nD + nQ + nY;
  const int w0 = blockIdx.x * a.wpb, nwin = min(a.wpb, a.windows - w0);
  const int total_boxes = nwin * per_win;
  auto issue = [&](int it) {  // TMA of box `it` into slot it & 1
    int idx = it % per_win;
    const CUtensorMap* map = &map_w3;
    int col, row;
    if (idx < nD) {
      map = &map_wproj;
      col = BW * (wg + (idx / kD) * NWG);
      row = kBoxRows * (idx % kD);
    } else if ((idx -= nD) < nQ) {
      col = BW * (idx % kQ);
      row = kBoxRows * (wg + (idx / kQ) * NWG);
    } else {
      idx -= nQ;
      col = BW * (wg + (idx / kY) * NWG);
      row = kBoxRows * (idx % kY);
      if constexpr (PAD > 1) {  // [Wq; Wkv] with 8 zero rows after each 8
        mbar_expect_tx(&bars[it & 1], kBoxBytes);
        tma_load_3d(ring + (it & 1) * kBoxBytes, &map_w3p, col, 0, 2 * (idx % kY),
                    &bars[it & 1]);
        return;
      }
    }
    mbar_expect_tx(&bars[it & 1], kBoxBytesC);
    tma_load_2d(ring + (it & 1) * kBoxBytes, map, col, row, &bars[it & 1]);
  };
  int it = 0;  // boxes consumed by this warpgroup
  // wait for box `it`, run body(slot) (its wgmmas complete on return), free
  // the slot for box it + 2, having issued box it + 1
  auto consume = [&](auto&& body) {
    if (producer && it + 1 < total_boxes) issue(it + 1);
    mbar_wait(&bars[it & 1], (it >> 1) & 1);
    body(ring + (it & 1) * kBoxBytes);
    named_bar_sync(wbar, 128);
    ++it;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * NWG; ++i) mbar_init(reinterpret_cast<uint64_t*>(sm + L.bars) + i, 1);
    mbar_fence_init();
  }
  if constexpr (WGRADS)
    for (int i = threadIdx.x; i < 6 * C; i += NT) colp[i] = 0.f;
  __syncthreads();
  if (producer) {
    tma_prefetch_map(&map_w3);
    tma_prefetch_map(&map_wproj);
    if constexpr (PAD > 1) tma_prefetch_map(&map_w3p);
    if (total_boxes > 0) issue(0);
  }

  float* part = a.part + (size_t)blockIdx.x * (6 * C + heads * kWinTok * kWinTok);
  const float scale = 1.0f / sqrtf((float)DH);
  const int seg = C / 8, sl = lane % seg, sub = lane / seg, tpw = 32 / seg;

  for (int wi = 0; wi < nwin; ++wi) {
    const int win = w0 + wi;
    const bool first = wi == 0;
    const WinBlock wb(a.geom, win);
    auto tok = [&](int t) -> size_t { return wb.pix(t); };

    // --- g into y | g, K-major ---
    for (int e = threadIdx.x; e < kWinTok * seg; e += NT) {
      const int t = e / seg, c8 = e % seg;
      *reinterpret_cast<uint4*>(sYG + yg_off(t, c8)) =
          __ldg(reinterpret_cast<const uint4*>(a.g + tok(t) * C + 8 * c8));
    }
    fence_proxy_async();
    __syncthreads();

    // --- do = g Wproj: pieces of BW columns, rounded into the do tiles ---
    for (int p = wg; p < C / BW; p += NWG) {
      float acc[BW / 2];
#pragma unroll
      for (int i = 0; i < BW / 2; ++i) acc[i] = 0.f;
      for (int kb = 0; kb < kD; ++kb)
        consume([&](const uint8_t* slot) {
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const int o = kBoxRows * kb + 16 * kk;
            wgmma_ss<BW, 0, 1>(
                acc, k_desc_at(smem_addr(sYG + (o / BW) * 64 * YP + ((o % BW) / 16) * 32), YP),
                mn_desc_at(smem_addr(slot + kk * 16 * YP), kBoxBytes, YP));
          }
          wgmma_commit();
          wgmma_wait_all();
        });
#pragma unroll
      for (int j = 0; j < BW / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          put_pair(sDo, arow + 8 * h, BW * p + 8 * j + acol,
                   pack_bf2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
      if constexpr (!CORE && WGRADS) {
        // K11 nocore: dq = dk = dv = do in f32 (unscaled) and o = do rounded:
        // the piece's column sums over the 64 tokens (the two rows, the
        // warp's row groups, the four warps in order) into the bq, bk and bv
        // partials, and the rounded piece out as o, dq, dk and dv
        float v[16];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) v[2 * j + e] = acc[4 * j + e] + acc[4 * j + 2 + e];
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
        if (lane < 4) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) cs[wl * 64 + 8 * j + acol + e] = v[2 * j + e];
        }
        named_bar_sync(wbar, 128);
        for (int d = threadIdx.x % 128; d < 64; d += 128) {
          const float sum = ((cs[d] + cs[64 + d]) + cs[128 + d]) + cs[192 + d];
          colp[2 * C + 64 * p + d] += sum;
          colp[3 * C + 64 * p + d] += sum;
          colp[4 * C + 64 * p + d] += sum;
        }
        named_bar_sync(wbar, 128);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const size_t r = tok(arow + 8 * h);
            const int c = 64 * p + 8 * j + acol;
            const uint32_t w = pack_bf2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            *reinterpret_cast<uint32_t*>(a.os + r * C + c) = w;
            *reinterpret_cast<uint32_t*>(a.dqs + r * C + c) = w;
            *reinterpret_cast<uint32_t*>(a.dkvs + r * 2 * C + c) = w;
            *reinterpret_cast<uint32_t*>(a.dkvs + r * 2 * C + C + c) = w;
          }
      }
    }
    fence_proxy_async();
    __syncthreads();  // g is dead

    // --- LN: statistics, y = round(xhat s + b) into y | g and out ---
    for (int t0 = warp * tpw; t0 < kWinTok; t0 += NW * tpw) {  // warp-uniform
      const int t = t0 + sub;
      if constexpr (RECOMPUTE) {
        float v[8];
        unpack_bf8(__ldg(reinterpret_cast<const uint4*>(a.x + tok(t) * C + 8 * sl)), v);
        float mu, inv;
        ln_stats8(v, seg, C, &mu, &inv);
        float yv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          yv[i] = (v[i] - mu) * inv * __ldg(a.ln_s + 8 * sl + i) + __ldg(a.ln_b + 8 * sl + i);
        const uint4 y = make_uint4(pack_bf2(yv[0], yv[1]), pack_bf2(yv[2], yv[3]),
                                   pack_bf2(yv[4], yv[5]), pack_bf2(yv[6], yv[7]));
        if constexpr (QKV) *reinterpret_cast<uint4*>(sYG + yg_off(t, sl)) = y;
        if constexpr (WGRADS) *reinterpret_cast<uint4*>(a.ys + tok(t) * C + 8 * sl) = y;
        if (sl == 0) {
          sMu[t] = mu;
          sInv[t] = inv;
        }
      } else {
        // K11 norecompute: y = q = k = v = x (q unscaled), xhat = x
        const uint4 xv = __ldg(reinterpret_cast<const uint4*>(a.x + tok(t) * C + 8 * sl));
        *reinterpret_cast<uint4*>(tile_at(sQ, t, 8 * sl)) = xv;
        *reinterpret_cast<uint4*>(tile_at(sK, t, 8 * sl)) = xv;
        *reinterpret_cast<uint4*>(tile_at(sV, t, 8 * sl)) = xv;
        if constexpr (WGRADS) *reinterpret_cast<uint4*>(a.ys + tok(t) * C + 8 * sl) = xv;
        if (sl == 0) {
          sMu[t] = 0.f;
          sInv[t] = 1.f;
        }
      }
    }
    fence_proxy_async();
    __syncthreads();

    // --- q | k | v = y [Wq; Wkv]^T + b: pieces of 32 columns, rounded into
    // the head tiles (q scaled after its bias) ---
    if constexpr (QKV) {
      for (int p = wg; p < 3 * C / kBoxRows; p += NWG) {
        float acc[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = 0.f;
        for (int kb = 0; kb < kQ; ++kb)
          consume([&](const uint8_t* slot) {
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < YP / 32; ++kk)
              wgmma_ss<32, 0, 0>(acc, k_desc_at(smem_addr(sYG + kb * 64 * YP + kk * 32), YP),
                                 k_desc_at(smem_addr(slot + kk * 32), YP));
            wgmma_commit();
            wgmma_wait_all();
          });
        const int which = kBoxRows * p / C;  // 0 q, 1 k, 2 v
        uint8_t* dst = which == 0 ? sQ : which == 1 ? sK : sV;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = kBoxRows * p + 8 * j + acol, c = col % C;
            float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
            if (which == 0) {
              v0 = (v0 + a.bq[c]) * scale;
              v1 = (v1 + a.bq[c + 1]) * scale;
            } else {
              v0 += a.bkv[col - C];
              v1 += a.bkv[col - C + 1];
            }
            put_pair(dst, arow + 8 * h, c, pack_bf2(v0, v1));
          }
      }
      fence_proxy_async();
      __syncthreads();
    }

    // --- the per-head core, head h on warpgroup h mod NWG ---
    if constexpr (CORE) {
      // column sums of a DH-wide accumulator (rows arow, arow + 8) over the 64
      // tokens, in a fixed order: the two rows, the warp's row groups by a
      // xor tree, then the four warps in order; added to the block's running
      // partials dst[0 .. DH) in shared memory
      auto colsum = [&](const float* acc, float* dst) {
        float v[DH / 4];
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) v[2 * j + e] = acc[4 * j + e] + acc[4 * j + 2 + e];
#pragma unroll
        for (int i = 0; i < DH / 4; ++i)
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
        if (lane < 4) {
#pragma unroll
          for (int j = 0; j < DH / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) cs[wl * 64 + 8 * j + acol + e] = v[2 * j + e];
        }
        named_bar_sync(wbar, 128);
        for (int d = threadIdx.x % 128; d < DH; d += 128)
          dst[d] += ((cs[d] + cs[64 + d]) + cs[128 + d]) + cs[192 + d];
        named_bar_sync(wbar, 128);
      };
      // an HP-wide accumulator's DH head columns rounded into head tile
      // `tile` and device memory row stride `ld` from `gdst` (at head size 8
      // the pad columns, zeros, are dropped: the tile's stay zero)
      auto store_head = [&](const float* acc, uint8_t* tile, bf16* gdst, int ld) {
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = arow + 8 * h, d = 8 * j + acol;
            const uint32_t w = pack_bf2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            if (tile) *reinterpret_cast<uint32_t*>(tile + swz_at(r, 2 * d, PITCH)) = w;
            if constexpr (WGRADS) *reinterpret_cast<uint32_t*>(gdst + tok(r) * ld + d) = w;
          }
      };
      // the 64 x 64 bf16 tile sP from accumulator pairs
      auto store_p = [&](const uint32_t* f) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = arow + 8 * h, c = 8 * j + acol;
            *reinterpret_cast<uint32_t*>(sP + swz(r, c / 8) + (c % 8) * 2) = f[2 * j + h];
          }
        fence_proxy_async();
        named_bar_sync(wbar, 128);
      };
      for (int h = wg; h < heads; h += NWG) {
        uint8_t* qh = sQ + h * HT;
        uint8_t* kh = sK + h * HT;
        uint8_t* vh = sV + h * HT;
        const uint8_t* doh = sDo + h * HT;
        const float* bh = a.bias + (size_t)h * kWinTok * kWinTok;
        const float* mw = a.mask ? a.mask + (size_t)wb.win * kWinTok * kWinTok : nullptr;
        float* pb = part + 6 * C + (size_t)h * kWinTok * kWinTok;
        if (WGRADS && !first)  // this thread's four 128-byte lines of the running bias partial
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
            for (int half = 0; half < 2; ++half)
              asm volatile("prefetch.global.L1 [%0];\n" ::"l"(
                  pb + (arow + 8 * h2) * kWinTok + 32 * half + acol));
        // logits = q k^T + bias + mask; p = e * (1 / sum e) in f32
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HP / 16; ++kk)
          wgmma_ss<64, 0, 0>(s, desc_k(qh + kk * 32), desc_k(kh + kk * 32));
        wgmma_commit();
        wgmma_wait_all();
        float mx[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int idx = (arow + 8 * h2) * kWinTok + 8 * j + acol;
            const float2 bv = *reinterpret_cast<const float2*>(bh + idx);
            const float2 mv = mw ? *reinterpret_cast<const float2*>(mw + idx) : make_float2(0.f, 0.f);
            float* sv = s + 4 * j + 2 * h2;
            sv[0] = sv[0] + bv.x + mv.x;
            sv[1] = sv[1] + bv.y + mv.y;
            mx[h2] = fmaxf(mx[h2], fmaxf(sv[0], sv[1]));
          }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
          mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          s[i] = expf(s[i] - mx[(i / 2) % 2]);
          sum[(i / 2) % 2] += s[i];
        }
        float rinv[2];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          sum[h2] += __shfl_xor_sync(0xffffffffu, sum[h2], 1);
          sum[h2] += __shfl_xor_sync(0xffffffffu, sum[h2], 2);
          rinv[h2] = 1.0f / sum[h2];
        }
        uint32_t pf[16];  // p rounded, as A fragments
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          s[2 * i] *= rinv[i % 2];
          s[2 * i + 1] *= rinv[i % 2];
          pf[i] = pack_bf2(s[2 * i], s[2 * i + 1]);
        }
        // o = p v, rounded out (only dWproj reads it)
        if constexpr (WGRADS) {
          float o[HP / 2];
#pragma unroll
          for (int i = 0; i < HP / 2; ++i) o[i] = 0.f;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_rs<HP, 1>(o, pf + 4 * kk, desc_mn(vh + kk * 16 * PITCH));
          wgmma_commit();
          wgmma_wait_all();
          store_head(o, nullptr, a.os + h * DH, C);
        }
        named_bar_sync(wbar, 128);  // the previous head's dk product is done with sP
        store_p(pf);
        // dp = do v^T, dv = p^T do
        float dp[32], dv[HP / 2];
#pragma unroll
        for (int i = 0; i < 32; ++i) dp[i] = 0.f;
#pragma unroll
        for (int i = 0; i < HP / 2; ++i) dv[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HP / 16; ++kk)
          wgmma_ss<64, 0, 0>(dp, desc_k(doh + kk * 32), desc_k(vh + kk * 32));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<HP, 1, 1>(dv, mn_major_desc(smem_addr(sP + kk * 2048), 8192),
                             desc_mn(doh + kk * 16 * PITCH));
        wgmma_commit();
        wgmma_wait_all();
        named_bar_sync(wbar, 128);  // v and sP are no longer read
        if constexpr (WGRADS) colsum(dv, colp + 4 * C + h * DH);
        store_head(dv, vh, a.dkvs + C + h * DH, 2 * C);
        // dlogits = p (dp - sum(dp p)) in f32 (in dp); the bias partial
        float rs[2] = {0.f, 0.f};
        if constexpr (DSOFTMAX) {
#pragma unroll
          for (int i = 0; i < 32; ++i) rs[(i / 2) % 2] += dp[i] * s[i];
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            rs[h2] += __shfl_xor_sync(0xffffffffu, rs[h2], 1);
            rs[h2] += __shfl_xor_sync(0xffffffffu, rs[h2], 2);
          }
        }
        uint32_t lf[16];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            float* dv2 = dp + 4 * j + 2 * h2;
            const float* p2 = s + 4 * j + 2 * h2;
            if constexpr (DSOFTMAX) {
              dv2[0] = p2[0] * (dv2[0] - rs[h2]);
              dv2[1] = p2[1] * (dv2[1] - rs[h2]);
            } else {  // K11 nodsoftmax: dlogits = dp / 64
              dv2[0] = dv2[0] * (1.0f / kWinTok);
              dv2[1] = dv2[1] * (1.0f / kWinTok);
            }
            if constexpr (WGRADS) {
              float2* dst =
                reinterpret_cast<float2*>(pb + (arow + 8 * h2) * kWinTok + 8 * j + acol);
              float2 acc2 = make_float2(dv2[0], dv2[1]);
              if (!first) {
                const float2 old = *dst;
                acc2 = make_float2(old.x + acc2.x, old.y + acc2.y);
              }
              *dst = acc2;
            }
            lf[2 * j + h2] = pack_bf2(dv2[0], dv2[1]);
          }
        store_p(lf);
        // dq = dlogits k (scaled), dk = dlogits^T q
        float dq[HP / 2], dk[HP / 2];
#pragma unroll
        for (int i = 0; i < HP / 2; ++i) dq[i] = dk[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t* f = lf + 4 * kk;
          wgmma_rs<HP, 1>(dq, f, desc_mn(kh + kk * 16 * PITCH));
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<HP, 1, 1>(dk, mn_major_desc(smem_addr(sP + kk * 2048), 8192),
                             desc_mn(qh + kk * 16 * PITCH));
        wgmma_commit();
        wgmma_wait_all();
        named_bar_sync(wbar, 128);  // q and k are no longer read
#pragma unroll
        for (int i = 0; i < HP / 2; ++i) dq[i] *= scale;
        if constexpr (WGRADS) {
          colsum(dq, colp + 2 * C + h * DH);
          colsum(dk, colp + 3 * C + h * DH);
        }
        store_head(dq, qh, a.dqs + h * DH, C);
        store_head(dk, kh, a.dkvs + h * DH, 2 * C);
      }
      fence_proxy_async();
      __syncthreads();
    }

    // --- dy = dq Wq + dk Wk + dv Wv: pieces of BW columns, K over the 3C
    // rows of [Wq; Wkv], the A operand from the head tiles (at head size 8
    // K over the 6C rows of the padded [Wq; Wkv], one padded head a k16
    // step) ---
    if constexpr (DXCHAIN) {
      float yacc[BW / 2];
#pragma unroll
      for (int i = 0; i < BW / 2; ++i) yacc[i] = 0.f;
      const int yp = wg;  // this warpgroup's piece (at most one: C <= BW NWG)
      if (yp < C / BW)
        for (int kb = 0; kb < kY; ++kb)
          consume([&](const uint8_t* slot) {
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
              const int j0 = (kBoxRows * kb + 16 * kk) / PAD, c = j0 % C;
              const uint8_t* src = j0 < C ? sQ : j0 < 2 * C ? sK : sV;
              if constexpr (!CORE) src = sDo;  // K11 nocore: dq = dk = dv = do
              wgmma_ss<BW, 0, 1>(yacc, desc_k(src + (c / DH) * HT + (c % DH) * 2),
                                 mn_desc_at(smem_addr(slot + kk * 16 * YP), kBoxBytes, YP));
            }
            wgmma_commit();
            wgmma_wait_all();
          });
      __syncthreads();  // every dy product is done: dy may take the space from 0
      if (yp < C / BW) {
#pragma unroll
        for (int j = 0; j < BW / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              sDy[(arow + 8 * h) * ldy + BW * yp + 8 * j + acol + e] = yacc[4 * j + 2 * h + e];
      }
      __syncthreads();
    }

    // --- LayerNorm backward; ln scale / bias and bproj partials ---
    if constexpr (DXCHAIN) {
      for (int t = warp; t < kWinTok; t += NW) {
        const size_t p = tok(t) * C;
        const float mu = sMu[t], inv = sInv[t];
        float m1 = 0.f, m2 = 0.f;
        for (int c = lane; c < C; c += 32) {
          const float dxh = sDy[t * ldy + c] * a.ln_s[c];
          m1 += dxh;
          m2 += dxh * ((to_f(a.x[p + c]) - mu) * inv);
        }
        m1 = warp_sum(m1) / C;
        m2 = warp_sum(m2) / C;
        for (int c = lane; c < C; c += 32) {
          const float xhat = (to_f(a.x[p + c]) - mu) * inv;
          const float dxh = sDy[t * ldy + c] * a.ln_s[c];
          float v = round_to<bf16>(inv * (dxh - m1 - xhat * m2));
          if (a.residual) v += to_f(a.g[p + c]);
          a.dx[p + c] = from_f<bf16>(v);
        }
      }
    } else {  // K11 nodx: dx = x
      for (int e = threadIdx.x; e < kWinTok * seg; e += NT) {
        const size_t p = tok(e / seg) * C + 8 * (e % seg);
        *reinterpret_cast<uint4*>(a.dx + p) = __ldg(reinterpret_cast<const uint4*>(a.x + p));
      }
    }
    if constexpr (WGRADS)
      tile_column_sums<NT, 3>(
          C, kWinTok, red,
          [&](int t, int c, float* v) {
            const size_t p = tok(t) * C + c;
            float dy;
            if constexpr (DXCHAIN)
              dy = sDy[t * ldy + c];
            else  // K11 nodx: dy = x
              dy = to_f(a.x[p]);
            v[0] = dy * ((to_f(a.x[p]) - sMu[t]) * sInv[t]);
            v[1] = dy;
            v[2] = to_f(a.g[p]);
          },
          [&](int c, const float* s3) {
            colp[c] += s3[0];
            colp[C + c] += s3[1];
            colp[5 * C + c] += s3[2];
          });
  }
  if constexpr (WGRADS) {
    for (int i = threadIdx.x; i < 6 * C; i += NT) part[i] = colp[i];
    if constexpr (!CORE)  // K11 nocore: no bias gradient
      for (int i = threadIdx.x; i < heads * kWinTok * kWinTok; i += NT) part[6 * C + i] = 0.f;
  }
}

template <int DH, int NWG, int SKIP, int YP = 128>
cudaError_t launch_wgmma(const CUtensorMap& m3, const CUtensorMap& mp, const CUtensorMap& m3p,
                         const AbArgs& a, unsigned grid, int smem, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(attention_bwd_wgmma_kernel<DH, NWG, SKIP, YP>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  attention_bwd_wgmma_kernel<DH, NWG, SKIP, YP><<<grid, NWG * 128, smem, s>>>(m3, mp, m3p, a);
  return cudaGetLastError();
}

// Launch the instantiation <head size, NWG, SKIP> on `a` (w3 = [Wq; Wkv]
// [3C, C]); the caller has checked the shape with bwd_wgmma_smem. K3
// (SKIP = 0) is built at head sizes 8, 16, 32 and 64 (NWG 2, 4) and at
// C = 32 with one head (NWG 1), K11 at 16 and 64.
template <int NWG, int SKIP>
int launch_nwg(const void* w3, const void* wproj, const AbArgs& a, void* stream) {
  const int C = a.geom.C, dh = C / a.heads;
  if (SKIP != 0 && dh != 16 && dh != 64) return (int)cudaErrorInvalidValue;
  if ((NWG == 1) != (C == 32)) return (int)cudaErrorInvalidValue;
  const AbLayout L(C, a.heads, NWG);
  const int box_cols = C == 32 ? 32 : 64;
  CUtensorMap m3, mp, m3p;
  cudaError_t e = make_tma_map_bf16(&m3, w3, 3 * C, C, kBoxRows, box_cols);
  if (e == cudaSuccess) e = make_tma_map_bf16(&mp, wproj, C, C, kBoxRows, box_cols);
  if (e == cudaSuccess) {
    if (dh == 8)
      e = make_tma_map_bf16_pad8(&m3p, w3, 3 * C, C);
    else
      m3p = m3;  // unread
  }
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((a.windows + a.wpb - 1) / a.wpb);
  const int smem = (int)L.total;
  const cudaStream_t s = (cudaStream_t)stream;
  if constexpr (NWG == 1) {  // C = 32, one head of 32
    return SKIP == 0 ? (int)launch_wgmma<32, 1, 0, 64>(m3, mp, m3p, a, grid, smem, s)
                     : (int)cudaErrorInvalidValue;
  } else {
    if constexpr (SKIP == 0) {
      if (dh == 8) return (int)launch_wgmma<8, NWG, 0>(m3, mp, m3p, a, grid, smem, s);
      if (dh == 32) return (int)launch_wgmma<32, NWG, 0>(m3, mp, m3p, a, grid, smem, s);
    }
    e = dh == 16 ? launch_wgmma<16, NWG, SKIP>(m3, mp, m3p, a, grid, smem, s)
                 : launch_wgmma<64, NWG, SKIP>(m3, mp, m3p, a, grid, smem, s);
    return (int)e;
  }
}

// K11 on the form with NWG warpgroups: the windowed entry's pointers
// (windows [G, n, C], mask-free, no residual), `skip` one kNo* bit. Each
// NWG is instantiated in a file of its own (attention_bwd_wgmma_ablation.cu
// and attention_bwd_wgmma_ablation4.cu), so that nvcc builds the two halves
// in parallel.
template <int NWG>
int launch_ablation(const void* x, const void* g, void* dx, void* ys, void* os, void* dqs,
                    void* dkvs, void* part, const void* ln_s, const void* ln_b, const void* w3,
                    const void* bq, const void* bkv, const void* wproj, const void* bias, int G,
                    int n, int C, int heads, int wpb, int skip, void* stream) {
  const int smem = bwd_wgmma_smem(n, C, heads, NWG);
  if (smem == 0 || smem > 232448 || wpb < 1) return (int)cudaErrorInvalidValue;
  const AbArgs a{(const bf16*)x, (const bf16*)g, (bf16*)dx, (bf16*)ys, (bf16*)os, (bf16*)dqs,
                 (bf16*)dkvs, (float*)part, (const float*)ln_s, (const float*)ln_b,
                 (const float*)bq, (const float*)bkv, (const float*)bias, nullptr,
                 WinGeom{0, 0, C, 0, n, 1, 1}, heads, 0, G, wpb};
  switch (skip) {
    case kNoRecompute: return launch_nwg<NWG, kNoRecompute>(w3, wproj, a, stream);
    case kNoDsoftmax: return launch_nwg<NWG, kNoDsoftmax>(w3, wproj, a, stream);
    case kNoWgrads: return launch_nwg<NWG, kNoWgrads>(w3, wproj, a, stream);
    case kNoDx: return launch_nwg<NWG, kNoDx>(w3, wproj, a, stream);
    case kNoCore: return launch_nwg<NWG, kNoCore>(w3, wproj, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace fbanet
