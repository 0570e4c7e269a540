// K1's wgmma form: fused norm1 + window attention (the forward of K3) in
// bf16, for 8 x 8 windows (64 tokens), C = 64, 128 or 256 and head size 16
// or 64, on the post-roll map [B, H, W, C] (K1) or on pre-partitioned
// windows [G, 64, C] (K1b). It replaces the TPU kernels
// fbanet_tpu/ops/attention_pallas.py::_attention2d_kernel and
// _attention_kernel; the function, its outputs and its rounding points are
// those of the first kernel (attention.cu, kept for f32, for the shapes
// ops/attention.py::_attention_plan does not send here and as the base of
// K9's and K7's flags): LN in f32 rounded to bf16; q = (y Wq^T + bq) dh^-1/2
// in f32, then rounded, k and v likewise without the scale; f32 logits +
// bias + mask; p = exp(l - max) rounded to bf16 for the AV product;
// o = (p v) (1 / sum) in f32, then rounded; proj + bproj + residual in f32,
// rounded once.
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
#include "common.cuh"
#include "hopper.cuh"

#include <cstdint>
#include <type_traits>

namespace fbanet {
namespace {

constexpr int kWinTok = 64;   // tokens of an 8 x 8 window
constexpr int kBoxRows = 32;  // weight rows (output columns) of one TMA box, 64 columns wide
constexpr int kBoxBytes = 64 * kBoxRows * 2;
constexpr int kSlots = 4;     // TMA ring slots per warpgroup when streaming

struct AfArgs {
  const bf16* x;
  bf16* out;
  const float *ln_s, *ln_b, *bq, *bkv, *bproj, *bias, *mask;
  WinGeom geom;
  int heads, residual, windows, wpb;
};

// Shared-memory layout (byte offsets from a 1024-byte aligned base) for C
// channels and NWG warpgroups: y, then o [64 rows] K-major in 64-channel
// atoms; q, k, v, each 64 x C bf16 as per-head tiles; the window's f32 mask
// [64][64] (8-float groups of row r XOR-ed with r % 8); the weights (staged:
// [Wq; Wkv] then Wproj as 32-row x 64-column boxes, piece p's boxes
// together; streamed: each warpgroup's ring of kSlots boxes); the barriers
// (staged: one; streamed: one per ring slot).
struct AfLayout {
  size_t y, q, k, v, mk, w, bars, total;
  __host__ __device__ AfLayout(int C, int nwg, int staged) {
    const size_t t = (size_t)128 * C;  // one 64 x C bf16 tensor
    y = 0;
    q = t;
    k = 2 * t;
    v = 3 * t;
    mk = 4 * t;
    w = mk + sizeof(float) * kWinTok * kWinTok;
    bars = w + (staged ? (size_t)8 * C * C : (size_t)nwg * kSlots * kBoxBytes);
    total = bars + (size_t)(staged ? 1 : nwg * kSlots) * sizeof(uint64_t) +
            1024;  // + slack to align the base
  }
};

template <int DH, int NWG, bool STAGED>
__global__ void __launch_bounds__(NWG * 128, 4 / NWG)
    attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_w3,
                           const __grid_constant__ CUtensorMap map_wproj, AfArgs a) {
  constexpr int NT = NWG * 128, NW = NT / 32;
  constexpr int PITCH = 2 * DH;        // bytes per row of a head tile
  constexpr uint32_t HT = 64 * PITCH;  // bytes of a head tile
  static_assert(DH == 16 || DH == 64, "the head sizes instantiated here");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int C = a.geom.C, heads = a.heads;
  const AfLayout L(C, NWG, STAGED);
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
  const int kQ = C / 64;    // weight boxes along K per piece
  const int pq = 3 * C / kBoxRows, pp = C / kBoxRows;  // pieces of q | k | v and of proj
  const int w0 = blockIdx.x * a.wpb, nwin = min(a.wpb, a.windows - w0);

  auto desc_k = [](const uint8_t* p) {  // a head tile, K-major
    return smem_desc(smem_addr(p), 16, 16 * DH, sw_layout(2 * DH));
  };
  auto desc_mn = [](const uint8_t* p) {  // a head tile, MN-major
    return smem_desc(smem_addr(p), 128 * DH, 16 * DH, sw_layout(2 * DH));
  };
  // (row, column c) of the tensor held as per-head tiles from `base`
  auto tile_at = [&](uint8_t* base, int row, int c) {
    return base + (c / DH) * HT + swz_at(row, (c % DH) * 2, PITCH);
  };
  // (row, column c) of y / o in its 64-channel atoms
  auto atom_at = [&](int row, int c) {
    return sY + (size_t)(c / 64) * 8192 + swz(row, (c % 64) / 8) + (c % 8) * 2;
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
    mbar_expect_tx(bar, kBoxBytes);
    tma_load_2d(ring + (it % kSlots) * kBoxBytes, map, 64 * (idx % kQ),
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
          tma_load_2d(sW + (size_t)(r * kQ + cb) * kBoxBytes, &map_w3, 64 * cb, kBoxRows * r,
                      bars0);
      for (int r = 0; r < pp; ++r)
        for (int cb = 0; cb < kQ; ++cb)
          tma_load_2d(sW + (size_t)((pq + r) * kQ + cb) * kBoxBytes, &map_wproj, 64 * cb,
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
    const uint8_t* wp = sW + (size_t)((proj ? pq : 0) + p) * kQ * kBoxBytes;
    auto run = [&](auto kq) {
#pragma unroll
      for (int kb = 0; kb < decltype(kq)::value; ++kb) {
        const uint8_t* box = wp + kb * kBoxBytes;
        if constexpr (!STAGED) {
          mbar_wait(&bars[it % kSlots], (it / kSlots) & 1);
          box = ring + (it % kSlots) * kBoxBytes;
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<32, 0, 0>(acc, k_major_desc(smem_addr(sY + kb * 8192 + kk * 32)),
                             k_major_desc(smem_addr(box + kk * 32)));
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
      const int lpr = C / 64;  // 128-byte lines per token
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
      *reinterpret_cast<uint4*>(sY + (size_t)(sl / 8) * 8192 + swz(t, sl % 8)) =
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
          *reinterpret_cast<uint32_t*>(tile_at(dst, arow + 8 * h, c)) = pack_bf2(v0, v1);
        }
    }
    fence_proxy_async();
    __syncthreads();  // y is dead: o takes its space

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
      for (int kk = 0; kk < DH / 16; ++kk)
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
      // o = (p v) (1 / sum), rounded into o's atoms
      float o[DH / 2];
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<DH, 1>(o, pf + 4 * kk, desc_mn(vh + kk * 16 * PITCH));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
          *reinterpret_cast<uint32_t*>(atom_at(arow + 8 * h2, h * DH + 8 * j + acol)) =
              pack_bf2(o[4 * j + 2 * h2] * rinv[h2], o[4 * j + 2 * h2 + 1] * rinv[h2]);
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

template <int DH, int NWG, bool STAGED>
cudaError_t launch_k(const CUtensorMap& m3, const CUtensorMap& mp, const AfArgs& a,
                     unsigned grid, int smem, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(attention_wgmma_kernel<DH, NWG, STAGED>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  attention_wgmma_kernel<DH, NWG, STAGED><<<grid, NWG * 128, smem, s>>>(m3, mp, a);
  return cudaGetLastError();
}

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
  const int smem = (int)AfLayout(C, nwg, staged).total;
  const cudaStream_t s = (cudaStream_t)stream;
  e = dh == 16 ? launch_dh<16>(m3, mp, a, nwg, staged, grid, smem, s)
               : launch_dh<64>(m3, mp, a, nwg, staged, grid, smem, s);
  return (int)e;
}

}  // namespace
}  // namespace fbanet

extern "C" {

// Dynamic shared memory of K1's wgmma form with `nwg` warpgroups and the
// weights staged (1) or streamed (0), or 0 for a shape it does not take:
// 64-token windows, C 64, 128 or 256, head size 16 or 64, nwg 2 or 4, at
// most 232,448 bytes (staged weights fit up to C = 128).
int fbanet_window_attention_wgmma_smem(int n, int C, int heads, int nwg, int staged) {
  using namespace fbanet;
  if (n != kWinTok || C % 64 || C > 256 || heads < 1 || C % heads) return 0;
  const int dh = C / heads;
  if ((dh != 16 && dh != 64) || (nwg != 4 && nwg != 2) || (staged != 0 && staged != 1))
    return 0;
  const size_t total = AfLayout(C, nwg, staged).total;
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
