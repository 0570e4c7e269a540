// K4: the backward of K2 (fused norm2 + LeFF) on [B, H, W, C]: dx, plus what
// the parameter gradients need. One kernel entry stands for both TPU
// backward kernels of the LeFF.
//
// Replaces fbanet_tpu/ops/leff_pallas.py::_leff_bwd_kernel (row strips with
// +-2 / +-1 row halos, launched by _pallas_backward) and its column-blocked
// twin _leff_bwd2d_kernel (+-2 / +-1 halos in both dimensions, launched by
// _pallas_backward_2d): this kernel uses the 2-D form, of which the row
// strips are a special case, at every shape. The JAX package sends its two
// largest decoder shapes to an XLA backward under differentiation only for
// lack of TPU VMEM; the same function runs here at all five shapes.
//
// Rounding points follow the TPU kernels: the forward is recomputed with
// LN in f32, y rounded, z1 = y W1^T + b1 and h1 = gelu(z1) in f32 (zero
// outside the image: the conv's padding), z2 = bdw + taps * h1 and h2 =
// gelu(z2) in f32; g rounded; dh2 = g W2 (f32); dz2 = gelu'(z2) dh2; dh1 =
// the transposed depthwise conv of dz2; dz1 = gelu'(z1) dh1, rounded for
// dy = dz1 W1 (f32); the LayerNorm backward in f32. gelu' is the exact
// derivative of the tanh approximation.
//
// A block owns an output tile and recomputes the forward on it with a +-2
// halo (the conv of the +-1 halo of dz2 needs h1 at +-2), with g on the +-1
// halo, so dx is complete within the tile. The hidden width does not fit
// shared memory, so the hidden channels are walked in chunks: z1 -> h1 ->
// z2 -> dh2 -> dz2 -> dh1 -> dz1 are all per channel. For the parameter
// gradients the block writes the rounded y, h2 and dz1 of its tokens (image
// layout) for the weight gradients (dW1 = dz1^T y, dW2 = g^T h2) and one f32
// row of per-tile partial sums (LN scale/bias, b1, the 9 depthwise taps,
// bdw, b2); csrc/reduce.cu sums them in a fixed order (no atomics, bitwise
// repeatable).
//
// What bounds it on the H100: about 10 T C Ch tensor-core flops plus 54 T Ch
// CUDA-core flops (T tokens) against 6 T C + 2 T Ch bytes of activations
// and scratch: arithmetic, 0.01-0.06 ms per B=2 call. The first form (the
// WMMA form below, kept for f32 and for bf16 shapes the wgmma form does not
// take) ran at 0.8-1.7 % of that: 8 x 8 tiles, every B fragment of W1 / W2
// an unpipelined load from L2, the depthwise stages on one thread per
// hidden channel of a 64-wide chunk (at most 64 of 256 threads, 64 tokens x
// 9 taps in series each), a round trip of dz1 through device memory for
// dy, and 200 one-block-per-SM blocks at 40 px.
//
// The wgmma form (bf16; ops/leff.py::_leff_bwd_plan picks the form and the
// split per shape), 3.3-3.7x faster on the card at the five shapes:
//  - the W1 and W2^T slices of a hidden chunk arrive by TMA in 128-byte
//    swizzled atoms, W1 one chunk ahead in a ring of two mbarrier slots,
//    W2^T one stage ahead; z1 = y W1^T and dh2 = g W2 (K-major operands)
//    and dy^T = W1^T dz1^T (MN-major) run on wgmma with f32 accumulators
//    in registers; dy's stay there across the chunks, so dz1 never leaves
//    the SM except as the dz1s scratch R1 needs;
//  - z2, h2 and the interior stage (dh1, gelu', the tap, bdw and b1
//    partials) take every thread as (token, channel pair) work items with
//    the chunk's taps in shared memory or registers; each partial is
//    summed over fixed token subsets per thread, then a fixed xor tree
//    inside the warp, then the warps in order;
//  - 16 warps (four warpgroups) per block: those stages are bound by
//    latency, and with 8 warps on the SM the same body ran 24 % slower;
//  - 16 x 8 tiles where C <= 128 cut the halo recompute from 2.25x to
//    1.88x (16 x 16 fits only with 16-wide chunks and ran slower);
//  - below half a block per SM (the bottleneck at B=2), `splits` blocks
//    share a tile's hidden chunks; each writes an f32 dy partial and
//    leff_ln_bwd_kernel adds them in split order and runs the LayerNorm
//    backward.
// What still bounds it (stage ablations on the card at B=8): the
// depthwise stages take about two thirds of its time at 5-7 % of the
// arithmetic bound, each limited by latency between block-wide barriers,
// not by tanh or shared-memory bandwidth; the products about a tenth.
#include "common.cuh"
#include "hopper.cuh"

#include <cstdint>

namespace fbanet {
namespace {

// ------------------------------------------------ the WMMA form (f32, bf16) ----
//
// One block owns an 8 x 8 output tile and recomputes the forward on its
// 12 x 12 tile, with g on the 10 x 10; hidden chunks of 64, 32 or 16. The
// rounded dz1 of each chunk goes to scratch; pass 2 reads it back to form
// dy [64, C] in an f32 shared-memory tile. bf16 products run on the tensor
// cores (WMMA 16x16x16, f32 accumulation; the 100 g-halo rows pad to 112),
// f32 ones on the CUDA cores (g read straight from device memory there).


constexpr int kT = 8;             // output tile edge
constexpr int kX = kT + 4;        // x halo tile edge (+-2)
constexpr int kG = kT + 2;        // g halo tile edge (+-1)
constexpr int kNX = kX * kX;      // 144 (a multiple of 16)
constexpr int kNG = kG * kG;      // 100
constexpr int kNGPad = 112;       // kNG rounded up to the 16-row WMMA tile
constexpr int kNI = kT * kT;      // 64 interior tokens

struct Args {
  const void *x, *g;
  void *dx, *ys, *h2s, *dz1s;  // dx out; per-token scratch, compute type
  float* part;                 // [tiles][3C + 11Ch] partial sums
  const float *ln_s, *ln_b;
  const void *w1, *w2;  // compute-type weights, torch Linear layout
  const float *b1, *wdw, *bdw;
  int H, W, C, Ch, residual, kc;
};

// Shared-memory layout (byte offsets). bf16 arrays have strides of C + 8 /
// kc + 8 elements (WMMA), f32 arrays odd strides. Pass 2 reuses pass 1's
// space after the statistics.
struct Layout {
  int ldc, ldk, ldy, kc2;
  size_t mu, inv, y, gt, h1, z1, z2, scratch, zero, dy, a2, total;
  __host__ __device__ Layout(int C, int Ch, int kc, bool bf) {
    const size_t e = bf ? 2 : 4;
    ldc = bf ? C + 8 : C + 1;
    ldk = kc + 1;
    ldy = C + 4;
    kc2 = Ch % 64 == 0 ? 64 : 16;
    mu = 0;
    inv = mu + align128(sizeof(float) * kNX);
    const size_t base = inv + align128(sizeof(float) * kNX);
    y = base;
    gt = y + align128(e * kNX * ldc);
    h1 = gt + (bf ? align128(e * kNGPad * ldc) : 0);
    z1 = h1 + align128(sizeof(float) * kNX * ldk);
    z2 = z1 + align128(sizeof(float) * kNI * ldk);
    scratch = z2 + align128(sizeof(float) * kNGPad * ldk);
    zero = scratch + (bf ? align128(sizeof(float) * 256 * (kThreads / 32)) : 0);
    const size_t end1 = zero + (bf ? 0 : sizeof(float) * C);  // f32: a zero g row
    dy = base;
    a2 = dy + align128(sizeof(float) * kNI * ldy);
    const size_t end2 = a2 + (bf ? sizeof(bf16) * kNI * (kc2 + 8) : 0);
    total = end1 > end2 ? end1 : end2;
  }
};

// Widest hidden chunk (64, 32 or 16 channels, dividing Ch) that fits.
__host__ inline int pick_chunk(int C, int Ch, bool bf) {
  for (int kc = 64; kc >= 16; kc /= 2)
    if (Ch % kc == 0 && Layout(C, Ch, kc, bf).total <= 232448) return kc;
  return 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) leff_bwd_wmma_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr bool bf = std::is_same_v<T, bf16>;
  using row = wmma::row_major;
  using col = wmma::col_major;
  const int C = a.C, Ch = a.Ch, kc = a.kc;
  const Layout L(C, Ch, kc, bf);
  float* sMu = (float*)(smem_raw + L.mu);
  float* sInv = (float*)(smem_raw + L.inv);
  T* sY = (T*)(smem_raw + L.y);
  T* sGt = (T*)(smem_raw + L.gt);
  float* sH1 = (float*)(smem_raw + L.h1);
  float* sZ1 = (float*)(smem_raw + L.z1);
  float* sZ2 = (float*)(smem_raw + L.z2);
  float* scratch = (float*)(smem_raw + L.scratch);
  float* sZero = (float*)(smem_raw + L.zero);
  float* sDy = (float*)(smem_raw + L.dy);
  T* sA2 = (T*)(smem_raw + L.a2);
  const int ldc = L.ldc, ldk = L.ldk, ldy = L.ldy;

  const T* x = (const T*)a.x;
  const T* g = (const T*)a.g;
  T* ys = (T*)a.ys;
  T* h2s = (T*)a.h2s;
  T* dz1s = (T*)a.dz1s;
  const T* w1 = (const T*)a.w1;
  const T* w2 = (const T*)a.w2;
  const int tiles_w = a.W / kT, tiles_h = a.H / kT;
  const int tx = blockIdx.x % tiles_w, ty = (blockIdx.x / tiles_w) % tiles_h;
  const int b = blockIdx.x / (tiles_w * tiles_h);
  const int r0 = ty * kT - 2, c0 = tx * kT - 2;  // image coords of x-halo (0, 0)
  // x-halo token t = hr * 12 + hc sits at (r0 + hr, c0 + hc)
  auto inside = [&](int hr, int hc) {
    const int r = r0 + hr, c = c0 + hc;
    return r >= 0 && r < a.H && c >= 0 && c < a.W;
  };
  auto pix = [&](int hr, int hc) -> size_t {
    return ((size_t)b * a.H + r0 + hr) * a.W + c0 + hc;
  };
  // interior token i (0..63) sits at x-halo (2 + i / 8, 2 + i % 8)
  auto ipix = [&](int i) { return pix(2 + i / kT, 2 + i % kT); };
  float* part = a.part + (size_t)blockIdx.x * (3 * C + 11 * Ch);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // --- LN of the 12 x 12 tile (y = 0 outside the image); g on the 10 x 10 ---
  for (int t = warp; t < kNX; t += kThreads / 32) {
    const int hr = t / kX, hc = t % kX;
    if (!inside(hr, hc)) {
      for (int c = lane; c < C; c += 32) sY[t * ldc + c] = from_f<T>(0.f);
      if (lane == 0) sMu[t] = sInv[t] = 0.f;
      continue;
    }
    const T* xr = x + pix(hr, hc) * C;
    float sum = 0.f, sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = to_f(xr[c]);
      sum += v;
      sq += v * v;
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    const float mu = sum / C;
    const float inv = rsqrtf(fmaxf(0.f, sq / C - mu * mu) + kLnEps);
    if (lane == 0) {
      sMu[t] = mu;
      sInv[t] = inv;
    }
    const bool interior = hr >= 2 && hr < kT + 2 && hc >= 2 && hc < kT + 2;
    for (int c = lane; c < C; c += 32) {
      const T yv = from_f<T>((to_f(xr[c]) - mu) * inv * a.ln_s[c] + a.ln_b[c]);
      sY[t * ldc + c] = yv;
      if (interior) ys[pix(hr, hc) * C + c] = yv;
    }
  }
  if constexpr (bf) {
    for (int i = threadIdx.x; i < kNGPad * C; i += kThreads) {
      const int u = i / C, c = i % C, hr = 1 + u / kG, hc = 1 + u % kG;
      sGt[u * ldc + c] = (u < kNG && inside(hr, hc)) ? g[pix(hr, hc) * C + c] : from_f<T>(0.f);
    }
  } else {
    for (int c = threadIdx.x; c < C; c += kThreads) sZero[c] = 0.f;
  }
  // db2 partial: the column sums of g over the interior
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float acc = 0.f;
    for (int i = 0; i < kNI; ++i) acc += to_f(g[ipix(i) * C + c]);
    part[2 * C + 11 * Ch + c] = acc;
  }
  __syncthreads();

  for (int k0 = 0; k0 < Ch; k0 += kc) {
    // z1 = y W1^T + b1 on the 144 tokens: h1 (0 outside), z1 of the interior
    mm<T, row, col>(kNX, kc, C, sY, ldc, w1 + (size_t)k0 * C, C, scratch,
                    [&](int t, int j, float v) {
                      const int hr = t / kX, hc = t % kX;
                      const float z = v + a.b1[k0 + j];
                      sH1[t * ldk + j] = inside(hr, hc) ? gelu_tanh(z) : 0.f;
                      if (hr >= 2 && hr < kT + 2 && hc >= 2 && hc < kT + 2)
                        sZ1[((hr - 2) * kT + hc - 2) * ldk + j] = z;
                    });
    __syncthreads();
    // z2 on the 10 x 10 tokens (f32 taps in order); h2 of the interior out
    for (int i = threadIdx.x; i < kNG * kc; i += kThreads) {
      const int u = i / kc, j = i % kc, ur = u / kG, uc = u % kG;
      const float* wk = a.wdw + (size_t)(k0 + j) * 9;
      float z = a.bdw[k0 + j];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
          z += sH1[((ur + ky) * kX + uc + kx) * ldk + j] * wk[ky * 3 + kx];
      sZ2[u * ldk + j] = z;
      if (ur >= 1 && ur <= kT && uc >= 1 && uc <= kT)
        h2s[pix(ur + 1, uc + 1) * Ch + k0 + j] = from_f<T>(gelu_tanh(z));
    }
    __syncthreads();
    // dh2 = g W2 on the 10 x 10 tokens -> dz2 = gelu'(z2) dh2, in place.
    // B(k = o, n = j) = w2[o * Ch + k0 + j], row-major
    auto dz2_epi = [&](int u, int j, float v) {
      sZ2[u * ldk + j] = gelu_tanh_grad(sZ2[u * ldk + j]) * v;
    };
    if constexpr (bf) {
      gemm_tc<row>(kNG, kNGPad, kc, C, sGt, ldc, w2 + k0, Ch, scratch, dz2_epi);
    } else {
      gemm_f32(kNG, kc, C,
               [&](int u) -> const float* {
                 const int hr = 1 + u / kG, hc = 1 + u % kG;
                 return inside(hr, hc) ? (const float*)g + pix(hr, hc) * C : sZero;
               },
               1, w2 + k0, 1, Ch, dz2_epi);
    }
    __syncthreads();
    // per channel: bdw and tap partials (interior, token order); dh1 ->
    // dz1 = gelu'(z1) dh1 (in place of z1); b1 partial
    for (int j = threadIdx.x; j < kc; j += kThreads) {
      const float* wk = a.wdw + (size_t)(k0 + j) * 9;
      float sb = 0.f, st[9] = {}, sd = 0.f;
      for (int i = 0; i < kNI; ++i) {
        const int r = i / kT, c = i % kT;  // u coords (r + 1, c + 1)
        const float dz2 = sZ2[((r + 1) * kG + c + 1) * ldk + j];
        sb += dz2;
        float dh1 = 0.f;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            st[ky * 3 + kx] += sH1[((r + 1 + ky) * kX + c + 1 + kx) * ldk + j] * dz2;
            dh1 += sZ2[((r + 2 - ky) * kG + c + 2 - kx) * ldk + j] * wk[ky * 3 + kx];
          }
        const float dz1 = gelu_tanh_grad(sZ1[i * ldk + j]) * dh1;
        sZ1[i * ldk + j] = dz1;
        sd += dz1;
      }
      part[2 * C + k0 + j] = sd;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) part[2 * C + Ch + tap * Ch + k0 + j] = st[tap];
      part[2 * C + 10 * Ch + k0 + j] = sb;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kNI * kc; i += kThreads) {
      const int t = i / kc, j = i % kc;
      dz1s[ipix(t) * Ch + k0 + j] = from_f<T>(sZ1[t * ldk + j]);
    }
    __syncthreads();
  }

  // --- pass 2: dy = dz1 W1 (f32), over pass 1's space ---
  for (int i = threadIdx.x; i < kNI * ldy; i += kThreads) sDy[i] = 0.f;
  __syncthreads();
  if constexpr (bf) {
    const int kc2 = L.kc2, lda2 = kc2 + 8;
    for (int k0 = 0; k0 < Ch; k0 += kc2) {
      for (int i = threadIdx.x; i < kNI * kc2; i += kThreads) {
        const int t = i / kc2, k = i % kc2;
        sA2[t * lda2 + k] = dz1s[ipix(t) * Ch + k0 + k];
      }
      __syncthreads();
      // B(k, i) = w1[k][i], row-major
      gemm_tc_acc<row>(kNI, C, kc2, sA2, lda2, w1 + (size_t)k0 * C, C, sDy, ldy);
      __syncthreads();
    }
  } else {
    gemm_f32(kNI, C, Ch, [&](int t) { return (const float*)dz1s + ipix(t) * Ch; }, 1, w1, 1,
             C, [&](int m, int i, float v) { sDy[m * ldy + i] = v; });
    __syncthreads();
  }

  // --- LayerNorm backward of the interior; ln scale/bias partials ---
  T* dx = (T*)a.dx;
  for (int i = warp; i < kNI; i += kThreads / 32) {
    const int t = (2 + i / kT) * kX + 2 + i % kT;
    const size_t p = ipix(i) * C;
    const float mu = sMu[t], inv = sInv[t];
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dxh = sDy[i * ldy + c] * a.ln_s[c];
      m1 += dxh;
      m2 += dxh * ((to_f(x[p + c]) - mu) * inv);
    }
    m1 = warp_sum(m1) / C;
    m2 = warp_sum(m2) / C;
    for (int c = lane; c < C; c += 32) {
      const float xhat = (to_f(x[p + c]) - mu) * inv;
      const float dxh = sDy[i * ldy + c] * a.ln_s[c];
      float v = round_to<T>(inv * (dxh - m1 - xhat * m2));
      if (a.residual) v += to_f(g[p + c]);
      dx[p + c] = from_f<T>(v);
    }
  }
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s1 = 0.f, s2 = 0.f;
    for (int i = 0; i < kNI; ++i) {
      const int t = (2 + i / kT) * kX + 2 + i % kT;
      const float dy = sDy[i * ldy + c];
      s1 += dy * ((to_f(x[ipix(i) * C + c]) - sMu[t]) * sInv[t]);
      s2 += dy;
    }
    part[c] = s1;
    part[C + c] = s2;
  }
}

// ------------------------------------------------- the wgmma form (bf16) ----
//
// A block owns a TH x TW output tile and a slice of the hidden chunks of
// width KC (`splits` blocks per tile); 16 warps, four warpgroups. The tile
// and chunk are template parameters (the forms ops/leff.py::_K4_FORMS
// lists: 16 x 8 and 8 x 8, each with 32-wide chunks), so the halo
// index arithmetic divides by constants; _leff_bwd_plan fixes the form and
// the split per shape, and the kernel takes them as given.

constexpr int kRed = 22;  // per channel pair: 9 tap, 1 bdw, 1 b1 partials, x 2
// threads of a block: four warpgroups. Measured against two (the same
// body, 190-199 registers a thread) at the five groups at B=8: 24 % less
// device time, at 128 registers (the depthwise stages are bound by latency
// with 8 warps on an SM)
constexpr int kWgThreads = 512;

struct WgArgs {
  const bf16 *x, *g;
  bf16 *dx, *ys, *h2s, *dz1s;
  float *part, *dyp;  // [tiles][3C + 11Ch]; f32 dy partials [splits][B H W][C]
  const float *ln_s, *ln_b, *b1, *wdw, *bdw;
  int H, W, C, Ch, residual, th, tw, splits;
};

// token counts of a th x tw tile: x halo (+-2) NX, g halo (+-1) NG,
// interior NI; NXr, NGr rounded up to whole 8-row swizzle groups
struct WgGeom {
  int th, tw, XW, GW, NX, NG, NI, NXr, NGr;
  __host__ __device__ constexpr WgGeom(int th_, int tw_)
      : th(th_), tw(tw_), XW(tw_ + 4), GW(tw_ + 2), NX((th_ + 4) * (tw_ + 4)),
        NG((th_ + 2) * (tw_ + 2)), NI(th_ * tw_), NXr(((th_ + 4) * (tw_ + 4) + 7) & ~7),
        NGr(((th_ + 2) * (tw_ + 2) + 7) & ~7) {}
};

// Shared-memory layout (byte offsets from a 1024-byte aligned base). bf16
// operands of wgmma in 128-byte swizzle atoms of 64 channels (hopper.cuh):
// y [NX rows] and g [NG rows] K-major; the W1 chunk (two slots, a ring one
// chunk ahead) and the W2^T chunk as TMA lands them, [kc rows] of C; dz1^T
// [kc rows] of NI tokens, MN-major. A 64-row wgmma block of y or g that
// runs past NX or NG reads the next array's bytes into rows it discards.
// f32 arrays of the chunk with a row stride of kc + 4: h1 on the x halo,
// gelu'(z1) on the interior, z2 (then dz2) on the g halo; the chunk's taps,
// b1 and bdw. After the chunk loop dy [NI][C + 4] f32 reuses the space from
// 0 (the host checks it ends before h1). The partial-sum scratch `red`
// (at most 16 warps x 16 pairs x kRed floats) reuses h1, gz1 and z2 once
// the interior stage is done with them (the host checks it fits).
struct WgLayout {
  int kcp;
  size_t y, g, w1, w2, dz1t, h1, gz1, z2, taps, b1, bdw, mu, inv, bars, total;
  __host__ __device__ WgLayout(int C, int kc, const WgGeom& q) {
    const size_t atoms = C / 64;
    kcp = kc + 4;
    y = 0;
    g = y + atoms * q.NXr * 128;
    w1 = (g + atoms * q.NGr * 128 + 1023) & ~size_t(1023);
    w2 = w1 + 2 * atoms * kc * 128;
    dz1t = w2 + atoms * kc * 128;
    h1 = dz1t + (q.NI / 64) * kc * 128;
    gz1 = h1 + align128(sizeof(float) * q.NX * kcp);
    z2 = gz1 + align128(sizeof(float) * q.NI * kcp);
    taps = z2 + align128(sizeof(float) * q.NGr * kcp);
    b1 = taps + align128(sizeof(float) * 9 * kc);
    bdw = b1 + align128(sizeof(float) * kc);
    mu = bdw + align128(sizeof(float) * kc);
    inv = mu + align128(sizeof(float) * q.NI);
    bars = inv + align128(sizeof(float) * q.NI);
    total = bars + 3 * sizeof(uint64_t) + 1024;  // + slack to align the base
  }
};

// The LayerNorm backward of the tile's NI interior tokens (pixel ipix(t)):
// dx from dy (f32 [NI][ldy] in shared memory) and each token's statistics,
// then the tile's LayerNorm scale and bias partials part[c], part[C + c].
// The old kernel's arithmetic, with the partials summed in tile_column_sums.
template <int NT, typename Pix>
__device__ __forceinline__ void ln_backward_tile(const WgArgs& a, int NI, Pix ipix,
                                                 const float* sDy, int ldy, const float* sMu,
                                                 const float* sInv, float* part, float* red) {
  const int C = a.C, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < NI; i += NT / 32) {
    const size_t p = ipix(i) * C;
    const float mu = sMu[i], inv = sInv[i];
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dxh = sDy[i * ldy + c] * a.ln_s[c];
      m1 += dxh;
      m2 += dxh * ((to_f(a.x[p + c]) - mu) * inv);
    }
    m1 = warp_sum(m1) / C;
    m2 = warp_sum(m2) / C;
    for (int c = lane; c < C; c += 32) {
      const float xhat = (to_f(a.x[p + c]) - mu) * inv;
      const float dxh = sDy[i * ldy + c] * a.ln_s[c];
      float v = round_to<bf16>(inv * (dxh - m1 - xhat * m2));
      if (a.residual) v += to_f(a.g[p + c]);
      a.dx[p + c] = from_f<bf16>(v);
    }
  }
  tile_column_sums<NT, 2>(
      C, NI, red,
      [&](int t, int c, float* v) {
        const float dy = sDy[t * ldy + c];
        v[0] = dy * ((to_f(a.x[ipix(t) * C + c]) - sMu[t]) * sInv[t]);
        v[1] = dy;
      },
      [&](int c, const float* s) {
        part[c] = s[0];
        part[C + c] = s[1];
      });
}

template <int KC, int TH, int TW>
__global__ void __launch_bounds__(kWgThreads, 1)
    leff_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_w1,
                          const __grid_constant__ CUtensorMap map_w2t, WgArgs a) {
  constexpr int NT = kWgThreads, NW = NT / 32, NWG = NT / 128;  // threads, warps, groups
  constexpr int P = KC / 2;  // channel pairs of a chunk
  // interior stage: LP lanes take LP neighbouring pairs of one token, GPW
  // token groups per warp, PB warps side by side over the pairs, QH rows of
  // warps; Q token groups in all
  constexpr int LP = P < 16 ? P : 16, GPW = 32 / LP, PB = P / LP, QH = NW / PB;
  constexpr int Q = GPW * QH;
  static_assert(KC == 32, "the chunk width instantiated here");
  static_assert(NT % P == 0, "the z2 stage keeps one channel pair per thread");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  constexpr WgGeom q(TH, TW);
  const int C = a.C, Ch = a.Ch, atomsC = C / 64;
  const WgLayout L(C, KC, q);
  const int kcp = L.kcp;
  uint8_t* sY = sm + L.y;
  uint8_t* sG = sm + L.g;
  uint8_t* sW2 = sm + L.w2;
  uint8_t* sDz1t = sm + L.dz1t;
  float* sH1 = reinterpret_cast<float*>(sm + L.h1);
  float* sGz1 = reinterpret_cast<float*>(sm + L.gz1);
  float* sZ2 = reinterpret_cast<float*>(sm + L.z2);
  float* sTaps = reinterpret_cast<float*>(sm + L.taps);
  float* sB1 = reinterpret_cast<float*>(sm + L.b1);
  float* sBdw = reinterpret_cast<float*>(sm + L.bdw);
  float* sMu = reinterpret_cast<float*>(sm + L.mu);
  float* sInv = reinterpret_cast<float*>(sm + L.inv);
  float* red = sH1;  // partial-sum scratch, when h1, gz1 and z2 are not live
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bars);  // W1 slots 0, 1; W2^T

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4;
  const int tiles_w = a.W / q.tw, tiles_h = a.H / q.th;
  const int tile = blockIdx.x / a.splits, split = blockIdx.x % a.splits;
  const int tx = tile % tiles_w, ty = (tile / tiles_w) % tiles_h;
  const int b = tile / (tiles_w * tiles_h);
  const int r0 = ty * q.th - 2, c0 = tx * q.tw - 2;  // image coords of x-halo (0, 0)
  auto inside = [&](int hr, int hc) {  // x-halo coords
    const int r = r0 + hr, c = c0 + hc;
    return r >= 0 && r < a.H && c >= 0 && c < a.W;
  };
  auto pix = [&](int hr, int hc) -> size_t {
    return ((size_t)b * a.H + r0 + hr) * a.W + c0 + hc;
  };
  // interior token t sits at x-halo (2 + t / tw, 2 + t % tw)
  auto ipix = [&](int t) { return pix(2 + t / q.tw, 2 + t % q.tw); };
  float* part = a.part + (size_t)tile * (3 * C + 11 * Ch);
  const int nck = Ch / KC / a.splits, ck0 = split * nck;
  const uint32_t wbytes = (uint32_t)C * KC * 2;
  auto load_w = [&](const CUtensorMap* map, uint8_t* dst, int ck, uint64_t* bar) {
    mbar_expect_tx(bar, wbytes);
    for (int at = 0; at < atomsC; ++at)
      tma_load_2d(dst + at * KC * 128, map, at * 64, ck * KC, bar);
  };
  auto w1_slot = [&](int i) { return sm + L.w1 + (size_t)(i & 1) * atomsC * KC * 128; };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    tma_prefetch_map(&map_w1);
    tma_prefetch_map(&map_w2t);
    load_w(&map_w1, w1_slot(0), ck0, &bars[0]);
    load_w(&map_w2t, sW2, ck0, &bars[2]);
  }

  // --- LN of the x halo into y (0 outside the image); g on the g halo ---
  {
    const int seg = C / 8, sl = lane % seg, sub = lane / seg, tpw = 32 / seg;
    float s8[8], b8[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s8[i] = __ldg(a.ln_s + 8 * sl + i);
      b8[i] = __ldg(a.ln_b + 8 * sl + i);
    }
    uint8_t* ydst = sY + (size_t)(sl / 8) * q.NXr * 128;
    for (int t0 = warp * tpw; t0 < q.NX; t0 += NW * tpw) {  // warp-uniform
      const int t = t0 + sub, hr = t / q.XW, hc = t % q.XW;
      const bool ok = t < q.NX && inside(hr, hc);
      float v[8] = {};
      if (ok)
        unpack_bf8(__ldg(reinterpret_cast<const uint4*>(a.x + pix(hr, hc) * C + 8 * sl)), v);
      float mu, inv;
      ln_stats8(v, seg, C, &mu, &inv);
      if (t >= q.NX) continue;
      uint4 y = make_uint4(0, 0, 0, 0);
      if (ok) {
        float yv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) yv[i] = (v[i] - mu) * inv * s8[i] + b8[i];
        y = make_uint4(pack_bf2(yv[0], yv[1]), pack_bf2(yv[2], yv[3]), pack_bf2(yv[4], yv[5]),
                       pack_bf2(yv[6], yv[7]));
      }
      *reinterpret_cast<uint4*>(ydst + swz(t, sl % 8)) = y;
      if (hr >= 2 && hr < q.th + 2 && hc >= 2 && hc < q.tw + 2) {
        const int i = (hr - 2) * q.tw + hc - 2;
        *reinterpret_cast<uint4*>(a.ys + pix(hr, hc) * C + 8 * sl) = y;
        if (sl == 0) {
          sMu[i] = mu;
          sInv[i] = inv;
        }
      }
    }
    for (int i = threadIdx.x; i < q.NGr * seg; i += NT) {
      const int u = i / seg, c8 = i % seg, ur = u / q.GW, uc = u % q.GW;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (u < q.NG && inside(ur + 1, uc + 1))
        v = __ldg(reinterpret_cast<const uint4*>(a.g + pix(ur + 1, uc + 1) * C + 8 * c8));
      *reinterpret_cast<uint4*>(sG + (size_t)(c8 / 8) * q.NGr * 128 + swz(u, c8 % 8)) = v;
    }
  }
  fence_proxy_async();
  __syncthreads();
  if (split == 0) {  // db2 partial: the column sums of g over the interior
    tile_column_sums<NT, 1>(
        C, q.NI, red,
        [&](int t, int c, float* v) {
          const int u = (t / q.tw + 1) * q.GW + t % q.tw + 1;
          v[0] = __bfloat162float(*reinterpret_cast<const bf16*>(
              sG + (size_t)(c / 64) * q.NGr * 128 + swz(u, (c % 64) / 8) + (c % 8) * 2));
        },
        [&](int c, const float* s) { part[2 * C + 11 * Ch + c] = s[0]; });
  }

  // dy^T in 64 x 64 pieces (C block, token block), at most 4: warpgroup
  // wg holds piece wg in its registers over the chunks
  const int npieces = atomsC * (q.NI / 64);
  const bool has_piece = wg < npieces;
  const int cb = wg / (q.NI / 64), tb = wg % (q.NI / 64);
  float dyacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dyacc[i] = 0.f;
  // this thread's rows and columns in a wgmma accumulator
  const int arow = 16 * (warp % 4) + lane / 4, acol = 2 * (lane % 4);

  for (int i = 0; i < nck; ++i) {
    const int ck = ck0 + i, k0 = ck * KC;
    for (int e = threadIdx.x; e < 11 * KC; e += NT) {
      const int j = e % KC, r = e / KC;
      if (r < 9)
        sTaps[r * KC + j] = a.wdw[(size_t)(k0 + j) * 9 + r];
      else
        (r == 9 ? sB1 : sBdw)[j] = (r == 9 ? a.b1 : a.bdw)[k0 + j];
    }
    __syncthreads();  // also: every read of W1 slot (i + 1) & 1 (chunk i - 1) is done
    if (threadIdx.x == 0 && i + 1 < nck) load_w(&map_w1, w1_slot(i + 1), ck + 1, &bars[(i + 1) & 1]);
    mbar_wait(&bars[i & 1], (i >> 1) & 1);
    const uint8_t* w1s = w1_slot(i);

    // z1 = y W1^T + b1 on the x halo: h1 (0 outside the image), gelu'(z1)
    // of the interior
    for (int mb = wg; mb * 64 < q.NX; mb += NWG) {
      float acc[KC / 2];
#pragma unroll
      for (int j = 0; j < KC / 2; ++j) acc[j] = 0.f;
      wgmma_fence();
      for (int k = 0; k < C / 16; ++k)
        wgmma_ss<32, 0, 0>(
            acc,
            k_major_desc(smem_addr(sY + (size_t)(k / 4) * q.NXr * 128 + mb * 8192 + (k % 4) * 32)),
            k_major_desc(smem_addr(w1s + (k / 4) * KC * 128 + (k % 4) * 32)));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int jj = 0; jj < KC / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = mb * 64 + arow + 8 * h, col = 8 * jj + acol;
          if (row >= q.NX) continue;
          const int hr = row / q.XW, hc = row % q.XW;
          const float za = acc[4 * jj + 2 * h] + sB1[col];
          const float zb = acc[4 * jj + 2 * h + 1] + sB1[col + 1];
          float2 h1 = make_float2(0.f, 0.f);
          if (hr >= 2 && hr < q.th + 2 && hc >= 2 && hc < q.tw + 2) {
            float2 dg;
            gelu_and_grad(za, &h1.x, &dg.x);
            gelu_and_grad(zb, &h1.y, &dg.y);
            *reinterpret_cast<float2*>(sGz1 + ((hr - 2) * q.tw + hc - 2) * kcp + col) = dg;
          } else if (inside(hr, hc)) {
            h1 = make_float2(gelu_tanh(za), gelu_tanh(zb));
          }
          *reinterpret_cast<float2*>(sH1 + row * kcp + col) = h1;
        }
    }
    __syncthreads();

    // z2 = bdw + taps * h1 on the g halo (f32 taps in order): gelu'(z2)
    // kept for dz2, h2 = gelu(z2) of the interior out. Work items: (token,
    // channel pair); a thread keeps one pair (NT is a multiple of P) and
    // its taps in registers
    {
      const int j = 2 * (threadIdx.x % P);
      float2 wt[9];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        wt[tap] = *reinterpret_cast<const float2*>(sTaps + tap * KC + j);
      const float2 bdw = *reinterpret_cast<const float2*>(sBdw + j);
      for (int u = threadIdx.x / P; u < q.NG; u += NT / P) {
        const int ur = u / q.GW, uc = u % q.GW;
        float2 z = bdw;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float2 hv = *reinterpret_cast<const float2*>(
                sH1 + ((ur + ky) * q.XW + uc + kx) * kcp + j);
            z.x += hv.x * wt[ky * 3 + kx].x;
            z.y += hv.y * wt[ky * 3 + kx].y;
          }
        float2 dg;
        if (ur >= 1 && ur <= q.th && uc >= 1 && uc <= q.tw) {
          float2 h2;
          gelu_and_grad(z.x, &h2.x, &dg.x);
          gelu_and_grad(z.y, &h2.y, &dg.y);
          *reinterpret_cast<uint32_t*>(a.h2s + pix(ur + 1, uc + 1) * Ch + k0 + j) =
              pack_bf2(h2.x, h2.y);
        } else {
          dg = make_float2(gelu_tanh_grad(z.x), gelu_tanh_grad(z.y));
        }
        *reinterpret_cast<float2*>(sZ2 + u * kcp + j) = dg;
      }
    }
    __syncthreads();

    // dh2 = g W2 on the g halo -> dz2 = gelu'(z2) dh2, in place of gelu'(z2)
    mbar_wait(&bars[2], i & 1);
    for (int mb = wg; mb * 64 < q.NG; mb += NWG) {
      float acc[KC / 2];
#pragma unroll
      for (int j = 0; j < KC / 2; ++j) acc[j] = 0.f;
      wgmma_fence();
      for (int k = 0; k < C / 16; ++k)
        wgmma_ss<32, 0, 0>(
            acc,
            k_major_desc(smem_addr(sG + (size_t)(k / 4) * q.NGr * 128 + mb * 8192 + (k % 4) * 32)),
            k_major_desc(smem_addr(sW2 + (k / 4) * KC * 128 + (k % 4) * 32)));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int jj = 0; jj < KC / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = mb * 64 + arow + 8 * h, col = 8 * jj + acol;
          if (row >= q.NG) continue;
          float2* zp = reinterpret_cast<float2*>(sZ2 + row * kcp + col);
          const float2 dg = *zp;
          *zp = make_float2(dg.x * acc[4 * jj + 2 * h], dg.y * acc[4 * jj + 2 * h + 1]);
        }
    }
    __syncthreads();  // every read of the W2^T slot is done
    if (threadIdx.x == 0 && i + 1 < nck) load_w(&map_w2t, sW2, ck + 1, &bars[2]);

    // per interior token and channel pair: the tap and bdw partials, dh1
    // (the transposed conv of dz2), dz1 = gelu'(z1) dh1 and the b1 partial.
    // A 16-lane phase reads 128 contiguous bytes of one token; a thread
    // takes the tokens qq, qq + Q, ... in order
    {
      const int pr = (warp % PB) * LP + lane % LP, j = 2 * pr;
      const int qh = warp / PB, qq = qh * GPW + lane / LP;
      float2 wt[9];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        wt[tap] = *reinterpret_cast<const float2*>(sTaps + tap * KC + j);
      float sum[kRed];
#pragma unroll
      for (int v = 0; v < kRed; ++v) sum[v] = 0.f;
      for (int t = qq; t < q.NI; t += Q) {
        const int ti = t / q.tw, tj = t % q.tw;
        const float2 dz2 =
            *reinterpret_cast<const float2*>(sZ2 + ((ti + 1) * q.GW + tj + 1) * kcp + j);
        sum[18] += dz2.x;
        sum[19] += dz2.y;
        float2 dh1 = make_float2(0.f, 0.f);
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const int tap = ky * 3 + kx;
            const float2 h = *reinterpret_cast<const float2*>(
                sH1 + ((ti + 1 + ky) * q.XW + tj + 1 + kx) * kcp + j);
            sum[2 * tap] += h.x * dz2.x;
            sum[2 * tap + 1] += h.y * dz2.y;
            const float2 d = *reinterpret_cast<const float2*>(
                sZ2 + ((ti + 2 - ky) * q.GW + tj + 2 - kx) * kcp + j);
            dh1.x += d.x * wt[tap].x;
            dh1.y += d.y * wt[tap].y;
          }
        const float2 gz = *reinterpret_cast<const float2*>(sGz1 + t * kcp + j);
        const float dza = gz.x * dh1.x, dzb = gz.y * dh1.y;
        sum[20] += dza;
        sum[21] += dzb;
        // the rounded dz1: dz1^T tile (rows j, j + 1, column t) and dz1s
        const uint32_t w = pack_bf2(dza, dzb);
        uint8_t* col = sDz1t + (size_t)(t / 64) * KC * 128 + (t % 8) * 2;
        *reinterpret_cast<uint16_t*>(col + swz(j, (t % 64) / 8)) = (uint16_t)(w & 0xffffu);
        *reinterpret_cast<uint16_t*>(col + swz(j + 1, (t % 64) / 8)) = (uint16_t)(w >> 16);
        *reinterpret_cast<uint32_t*>(a.dz1s + ipix(t) * Ch + k0 + j) = w;
      }
      // the GPW token groups of a warp in a fixed xor tree, then (below)
      // the QH warp rows in order
#pragma unroll
      for (int v = 0; v < kRed; ++v)
#pragma unroll
        for (int o = LP; o < 32; o <<= 1) sum[v] += __shfl_xor_sync(0xffffffffu, sum[v], o);
      fence_proxy_async();  // dz1^T is read by wgmma next
      __syncthreads();      // h1 is dead: `red` may take its space
      if (lane < LP) {
#pragma unroll
        for (int v = 0; v < kRed; ++v) red[(qh * P + pr) * kRed + v] = sum[v];
      }
      __syncthreads();
    }

    // dy^T += W1_chunk^T dz1^T on this warpgroup's piece
    wgmma_fence();
    if (has_piece) {
#pragma unroll
      for (int k = 0; k < KC / 16; ++k)
        wgmma_ss<64, 1, 1>(dyacc,
                           mn_major_desc(smem_addr(w1s + cb * KC * 128 + k * 2048), KC * 128),
                           mn_major_desc(smem_addr(sDz1t + tb * KC * 128 + k * 2048), KC * 128));
    }
    wgmma_commit();
    // meanwhile: the chunk's partials, summed over the warps in order
    for (int e = threadIdx.x; e < P * kRed; e += NT) {
      const int pr = e / kRed, v = e % kRed;
      float s = red[pr * kRed + v];
      for (int h = 1; h < QH; ++h) s += red[(h * P + pr) * kRed + v];
      const int jj = k0 + 2 * pr + (v & 1), kind = v / 2;  // 0-8 taps, 9 bdw, 10 b1
      part[kind < 9 ? 2 * C + Ch + kind * Ch + jj : kind == 9 ? 2 * C + 10 * Ch + jj
                                                              : 2 * C + jj] = s;
    }
    wgmma_wait_all();
  }

  // --- dy [NI][C + 4] f32 over the chunk space; then the LN backward, or
  // this split's partial out ---
  __syncthreads();
  const int ldy = C + 4;
  float* sDy = reinterpret_cast<float*>(sm);
  if (has_piece) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sDy[(tb * 64 + 8 * jj + acol + e) * ldy + cb * 64 + arow + 8 * h] =
              dyacc[4 * jj + 2 * h + e];
  }
  __syncthreads();
  if (a.splits > 1) {
    const size_t tiles = gridDim.x / a.splits;
    float* dst = a.dyp + (size_t)split * tiles * q.NI * C;
    for (int e = threadIdx.x; e < q.NI * (C / 4); e += NT) {
      const int t = e / (C / 4), c4 = e % (C / 4);
      *reinterpret_cast<float4*>(dst + ipix(t) * C + 4 * c4) =
          *reinterpret_cast<const float4*>(sDy + t * ldy + 4 * c4);
    }
    return;
  }
  ln_backward_tile<NT>(a, q.NI, ipix, sDy, ldy, sMu, sInv, part, red);
}

// With a split: dy = the splits' f32 partials added in split order, the
// token statistics recomputed from x, then the LayerNorm backward and its
// partials of one tile per block. Shared memory: dy [NI][C + 4], mu, inv,
// the sums' scratch.
__global__ void __launch_bounds__(kThreads) leff_ln_bwd_kernel(WgArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const WgGeom q(a.th, a.tw);
  const int C = a.C, ldy = C + 4;
  float* sDy = reinterpret_cast<float*>(smem_raw);
  float* sMu = sDy + q.NI * ldy;
  float* sInv = sMu + q.NI;
  float* red = sInv + q.NI;
  const int tiles_w = a.W / q.tw, tiles_h = a.H / q.th, tile = blockIdx.x;
  const int tx = tile % tiles_w, ty = (tile / tiles_w) % tiles_h;
  const int b = tile / (tiles_w * tiles_h);
  auto ipix = [&](int t) -> size_t {
    return ((size_t)b * a.H + ty * q.th + t / q.tw) * a.W + tx * q.tw + t % q.tw;
  };
  const size_t stride = (size_t)gridDim.x * q.NI * C;  // one split's partial
  for (int e = threadIdx.x; e < q.NI * (C / 4); e += kThreads) {
    const int t = e / (C / 4), c4 = e % (C / 4);
    const float4* src = reinterpret_cast<const float4*>(a.dyp + ipix(t) * C + 4 * c4);
    float4 s = src[0];
    for (int k = 1; k < a.splits; ++k) {
      const float4 v = src[k * stride / 4];
      s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
    }
    *reinterpret_cast<float4*>(sDy + t * ldy + 4 * c4) = s;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int seg = C / 8, sl = lane % seg, sub = lane / seg, tpw = 32 / seg;
  for (int t0 = warp * tpw; t0 < q.NI; t0 += (kThreads / 32) * tpw) {  // warp-uniform
    const int t = t0 + sub;
    float v[8] = {};
    if (t < q.NI) unpack_bf8(__ldg(reinterpret_cast<const uint4*>(a.x + ipix(t) * C + 8 * sl)), v);
    float mu, inv;
    ln_stats8(v, seg, C, &mu, &inv);
    if (t < q.NI && sl == 0) {
      sMu[t] = mu;
      sInv[t] = inv;
    }
  }
  __syncthreads();
  ln_backward_tile<kThreads>(a, q.NI, ipix, sDy, ldy, sMu, sInv,
                             a.part + (size_t)tile * (3 * C + 11 * a.Ch), red);
}

template <int KC, int TH, int TW>
cudaError_t launch_wgmma(const CUtensorMap& map_w1, const CUtensorMap& map_w2t, const WgArgs& a,
                         unsigned grid, int smem, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(leff_bwd_wgmma_kernel<KC, TH, TW>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  leff_bwd_wgmma_kernel<KC, TH, TW><<<grid, kWgThreads, smem, s>>>(map_w1, map_w2t, a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fbanet

extern "C" {

// Hidden chunk the WMMA form uses, or 0 for a shape it does not take (the
// bf16 kernel tiles C and the hidden width by 16).
int fbanet_leff_bwd_chunk(int C, int Ch, int bf16) {
  if (bf16 && (C % 16 || Ch % 16)) return 0;
  return fbanet::pick_chunk(C, Ch, bf16 != 0);
}

// Dynamic shared memory of the wgmma form for tile th x tw and chunk kc, or
// 0 for one it does not take (C 64, 128 or 256; the forms (th, tw, kc) =
// (16, 8, 32), (8, 8, 32); at most four 64 x 64 pieces of dy per tile).
int fbanet_leff_bwd_smem(int C, int th, int tw, int kc) {
  using namespace fbanet;
  const bool form = (th == 16 || th == 8) && tw == 8 && kc == 32;
  if (C % 64 || C > 256 || kThreads % C || !form) return 0;
  const WgGeom q(th, tw);
  if ((C / 64) * (q.NI / 64) > 4) return 0;
  const WgLayout L(C, kc, q);
  if ((size_t)q.NI * (C + 4) * sizeof(float) > L.h1 ||
      sizeof(float) * (kWgThreads / 32) * 16 * kRed > L.taps - L.h1)
    return 0;
  return (int)L.total;
}

// th == 0: the WMMA form (f32 or bf16; w2 [C, Ch]). th > 0: the wgmma form
// (bf16; w2t = W2^T [Ch, C]) with th x tw tiles, hidden chunk kc and
// `splits` blocks per tile; with splits > 1, dyp holds splits x B H W x C
// floats. part holds one row of 3C + 11Ch floats per tile.
int fbanet_leff_bwd(const void* x, const void* g, void* dx, void* ys, void* h2s, void* dz1s,
                    void* part, void* dyp, const void* ln_s, const void* ln_b, const void* w1,
                    const void* b1, const void* wdw, const void* bdw, const void* w2,
                    const void* w2t, int B, int H, int W, int C, int Ch, int residual, int bf16,
                    int th, int tw, int kc, int splits, void* stream) {
  using namespace fbanet;
  const cudaStream_t s = (cudaStream_t)stream;
  if (th == 0) {
    const int kc0 = fbanet_leff_bwd_chunk(C, Ch, bf16);
    if (kc0 == 0 || H % kT || W % kT) return (int)cudaErrorInvalidValue;
    Args a{x, g, dx, ys, h2s, dz1s, (float*)part, (const float*)ln_s, (const float*)ln_b,
           w1, w2, (const float*)b1, (const float*)wdw, (const float*)bdw, H, W, C, Ch,
           residual, kc0};
    const int smem = (int)Layout(C, Ch, kc0, bf16 != 0).total;
    auto kern = bf16 ? leff_bwd_wmma_kernel<fbanet::bf16> : leff_bwd_wmma_kernel<float>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<(unsigned)B * (H / kT) * (W / kT), kThreads, smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  const int smem = fbanet_leff_bwd_smem(C, th, tw, kc);
  if (!bf16 || smem == 0 || smem > 232448 || splits < 1 || H % th || W % tw ||
      Ch % (kc * splits))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_w1, map_w2t;
  cudaError_t e = make_tma_map_bf16(&map_w1, w1, Ch, C, kc);
  if (e == cudaSuccess) e = make_tma_map_bf16(&map_w2t, w2t, Ch, C, kc);
  if (e != cudaSuccess) return (int)e;
  WgArgs a{(const fbanet::bf16*)x, (const fbanet::bf16*)g, (fbanet::bf16*)dx,
           (fbanet::bf16*)ys, (fbanet::bf16*)h2s, (fbanet::bf16*)dz1s, (float*)part,
           (float*)dyp, (const float*)ln_s, (const float*)ln_b, (const float*)b1,
           (const float*)wdw, (const float*)bdw, H, W, C, Ch, residual, th, tw, splits};
  const unsigned tiles = (unsigned)B * (H / th) * (W / tw), grid = tiles * splits;
  e = th == 16 ? launch_wgmma<32, 16, 8>(map_w1, map_w2t, a, grid, smem, s)
               : launch_wgmma<32, 8, 8>(map_w1, map_w2t, a, grid, smem, s);
  if (splits == 1 || e != cudaSuccess) return (int)e;
  const WgGeom q(th, tw);
  const int smem2 = (int)(sizeof(float) * (q.NI * (C + 4) + 2 * q.NI + 2 * kThreads));
  e = cudaFuncSetAttribute(leff_ln_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (e != cudaSuccess) return (int)e;
  leff_ln_bwd_kernel<<<tiles, kThreads, smem2, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
