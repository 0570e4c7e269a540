// K4: the backward of K2 (fused norm2 + LeFF) on [B, H, W, C]: dx, plus what
// the parameter gradients need. One kernel stands for both TPU backward
// kernels of the LeFF.
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
// One block owns an 8 x 8 output tile and recomputes the forward on its
// 12 x 12 tile with a +-2 halo (the conv of the +-1 halo of dz2 needs h1 at
// +-2), with g on the 10 x 10 +-1 halo, so dx is complete within the block.
// The hidden width does not fit shared memory (at C = 256 the f32 hidden of
// one haloed tile alone is 590 KB), so the hidden channels are walked in
// chunks: z1 -> h1 -> z2 -> dh2 -> dz2 -> dh1 -> dz1 are all per channel. The
// rounded dz1 of each chunk goes to scratch; pass 2 reads it back to form dy
// [64, C] in an f32 shared-memory tile. For the parameter gradients the
// block writes the rounded y, h2 and dz1 of its 64 tokens (image layout) for
// the weight gradients (dW1 = dz1^T y, dW2 = g^T h2) and one f32 row of
// per-block partial sums (LN scale/bias, b1, the 9 depthwise taps, bdw, b2);
// csrc/reduce.cu sums them in a fixed order (no atomics, bitwise repeatable).
//
// What bounds it on the H100: arithmetic (about 2.5 times K2's products on
// 144/64 of the tokens for the halo). bf16 products run on the tensor cores
// (WMMA 16x16x16, f32 accumulation; the 100 g-halo rows pad to 112), f32
// ones on the CUDA cores (g read straight from device memory there).
#include "common.cuh"

namespace fbanet {
namespace {

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
__global__ void __launch_bounds__(kThreads) leff_bwd_kernel(Args a) {
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

}  // namespace
}  // namespace fbanet

extern "C" {

// Hidden chunk the kernel uses, or 0 for a shape it does not take (the bf16
// kernel tiles C and the hidden width by 16).
int fbanet_leff_bwd_chunk(int C, int Ch, int bf16) {
  if (bf16 && (C % 16 || Ch % 16)) return 0;
  return fbanet::pick_chunk(C, Ch, bf16 != 0);
}

int fbanet_leff_bwd(const void* x, const void* g, void* dx, void* ys, void* h2s, void* dz1s,
                    void* part, const void* ln_s, const void* ln_b, const void* w1,
                    const void* b1, const void* wdw, const void* bdw, const void* w2, int B,
                    int H, int W, int C, int Ch, int residual, int bf16, void* stream) {
  const int kc = fbanet_leff_bwd_chunk(C, Ch, bf16);
  if (kc == 0 || H % fbanet::kT || W % fbanet::kT) return (int)cudaErrorInvalidValue;
  fbanet::Args a{x, g, dx, ys, h2s, dz1s, (float*)part, (const float*)ln_s,
                 (const float*)ln_b, w1, w2, (const float*)b1, (const float*)wdw,
                 (const float*)bdw, H, W, C, Ch, residual, kc};
  const int smem = (int)fbanet::Layout(C, Ch, kc, bf16 != 0).total;
  auto kern = bf16 ? fbanet::leff_bwd_kernel<fbanet::bf16> : fbanet::leff_bwd_kernel<float>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)B * (H / fbanet::kT) * (W / fbanet::kT);
  kern<<<grid, fbanet::kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
