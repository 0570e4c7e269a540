// ECC: translation ECC of a burst's frames to their templates, every pyramid level, in one
// launch.
//
// Replaces no TPU kernel: fbanet_tpu/ops/registration.py runs translation ECC as XLA ops (its
// warps as one-hot matrix products) in a lax.while_loop under vmap, so each frame stops on its
// own. The port's plain version (ops/registration.py: ecc_align's pyramid,
// _ecc_translation_level and _run_ecc_iters) runs all frames at once with a `where` mask: about
// 115 small launches and one blocking host read per batched iteration, ~31 iterations a served
// batch, so the card idled through most of registration. Here one block registers one frame
// through every level and stops on its own; nothing returns to the host until the end.
//
// Per block (frame n, template n):
//   1. the blur-and-halve pyramid of the image and of the template (5-tap binomial, zero
//      padding, rows then columns, then [::2, ::2]) into the frame's slice of `scratch`;
//   2. coarse to fine, per level: the image staged in shared memory when it fits (160 px is
//      100 KB, two blocks an SM), else read where it lies (L1/L2); the template's mean and norm
//      (two passes); then the iterations of _ecc_translation_level.step in f32: the clamped
//      linear sample along rows, then columns (the floor and fraction of _shift_axis), of the
//      image and of its central differences with replicated edges (_image_gradients: formed
//      from the staged image at the taps, never stored), the zero-mean warped image from a
//      first pass (its mean) and a second (the centred sums), the 2 x 2 solve, the lam branch,
//      the isfinite guard on dp and rho; p doubles between levels (_scale_matrix by 2);
//   3. a frame runs while |rho - rho_prev| > eps and fewer than `iters` iterations have run
//      (every iteration when eps <= 0), from |drho| = inf, as _run_ecc_iters; a stopped frame
//      keeps its p and rho;
//   4. a non-finite result becomes the identity with rho = -1 (ecc_align's fallback).
// Block sums: warp shuffles, then the warps' partials summed in one fixed order by every thread,
// so all threads hold the same sums, take the same branch and need no broadcast.
//
// What bounds it: operations. Per pixel and iteration the algorithm needs ~48 f32 operations
// (the bilinear sample of the image and its two gradients, seven products summed) against
// 8 bytes per pixel and level read once from device memory; the pixels of a level are re-read
// every iteration from shared memory or L1/L2, and the two passes sample each pixel twice. The
// design keeps every iteration on the card: the serving path's cost was the host's launches
// and reads, not the card's arithmetic.
#include "common.cuh"

#include <cmath>

namespace fbanet {
namespace {

constexpr int kEccThreads = 512;
constexpr int kEccWarps = kEccThreads / 32;
constexpr int kEccMaxLevels = 16;

struct EccArgs {
  const float* tmpl;   // [N, H, W]
  const float* image;  // [N, H, W]
  const float* p0;     // [N, 2] at the coarsest level, or null: zero
  float* p_out;        // [N, 2] at the finest level
  float* rho_out;      // [N]
  int* iters_out;      // [levels, N]: iterations run, per level (0 = finest) and frame
  float* scratch;      // [N, 2, S]: the image's levels 1.., then the template's
  int N, H, W, levels, iters;
  float eps;
  int stage_bytes;  // dynamic shared memory: a level whose image fits is staged there
};

// (h, w) of pyramid level `l` and the offset of its image in a frame's scratch slice (levels
// >= 1; level 1 at 0); `total`: S, the floats of levels 1.. of one image
__host__ __device__ inline void level_dims(int H, int W, int l, int levels, int* h, int* w,
                                           long long* off, long long* total) {
  int hh = H, ww = W;
  long long o = 0, s = 0;
  for (int k = 1; k < levels; ++k) {
    hh = (hh + 1) / 2;
    ww = (ww + 1) / 2;
    if (k < l) o += (long long)hh * ww;
    if (k == l) *h = hh, *w = ww;
    s += (long long)hh * ww;
  }
  if (l == 0) *h = H, *w = W;
  *off = o;
  *total = s;
}

// Visit the block's pixels of an h x w map: thread t takes t, t + kEccThreads, ... in row-major
// order, (y, x) carried from one to the next.
template <typename F>
__device__ __forceinline__ void for_pixels(int h, int w, F&& f) {
  int y = (int)threadIdx.x / w, x = (int)threadIdx.x - y * w;
  const int dy = kEccThreads / w, dx = kEccThreads - dy * w;
  while (y < h) {
    f(y, x, y * w + x);
    x += dx;
    y += dy;
    if (x >= w) x -= w, ++y;
  }
}

// v[k] summed over the block, in every thread; `red` holds kEccWarps x K floats. Callers
// alternate two `red` buffers, so a buffer is written again only after a barrier that every
// thread reaches after reading it.
template <int K>
__device__ __forceinline__ void block_sums(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * K + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    for (int i = 0; i < kEccWarps; ++i) s += red[i * K + k];
    v[k] = s;
  }
}

// _blur_and_halve of an h x w map into ho x wo: the 5-tap binomial along rows, then along
// columns, zero outside, sampled at even rows and columns; each sum in the plain version's order
__device__ void blur_halve(const float* src, int h, int w, float* dst, int ho, int wo) {
  const float k[5] = {1.f / 16, 4.f / 16, 6.f / 16, 4.f / 16, 1.f / 16};
  for_pixels(ho, wo, [&](int y, int x, int i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const int c = 2 * x + j - 2;
      if (c < 0 || c >= w) continue;
      float r = 0.f;
#pragma unroll
      for (int t = 0; t < 5; ++t) {
        const int row = 2 * y + t - 2;
        if (row >= 0 && row < h) r += k[t] * src[row * w + c];
      }
      acc += k[j] * r;
    }
    dst[i] = acc;
  });
}

// _shift_axis's source index: clamp(i + floor(t), 0, n - 1), computed in f32 as the plain
// version does (fmaxf also maps a NaN position to 0)
__device__ __forceinline__ int clamp_index(float v, int n) {
  return (int)fminf(fmaxf(v, 0.f), (float)(n - 1));
}

struct Shift {
  float i0x, fx, i0y, fy;  // floor and fraction of (tx, ty)
};

// The warped image, x-gradient and y-gradient at output pixel (y, x): the four taps (rows
// r0, r1 = clamped y + floor(ty) and its successor; columns c0, c1 likewise) blended along rows,
// then columns. A gradient's taps are the tap's clamped neighbours: with c1 == c0 + 1 the right
// neighbour of c0 is c1 and the left one of c1 is c0; with c0 == c1 on the left edge the right
// neighbour is min(c1 + 1, w - 1) and the left one the tap itself, on the right edge the right
// neighbour is the tap itself and the left one max(c0 - 1, 0) (and the same for rows), so
// twelve reads serve all three samples.
__device__ __forceinline__ void sample3(const float* src, int h, int w, int y, int x,
                                        const Shift& s, float* iw, float* ixw, float* iyw) {
  const float yf = (float)y + s.i0y, xf = (float)x + s.i0x;
  const int r0 = clamp_index(yf, h), r1 = clamp_index(yf + 1.f, h);
  const int c0 = clamp_index(xf, w), c1 = clamp_index(xf + 1.f, w);
  const int cl = max(c0 - 1, 0), cr = min(c1 + 1, w - 1);
  const int ru = max(r0 - 1, 0), rd = min(r1 + 1, h - 1);
  const float* R0 = src + r0 * w;
  const float* R1 = src + r1 * w;
  const float* RU = src + ru * w;
  const float* RD = src + rd * w;
  const float a00 = R0[c0], a01 = R0[c1], a10 = R1[c0], a11 = R1[c1];
  const float l0 = R0[cl], l1 = R1[cl], q0 = R0[cr], q1 = R1[cr];
  const float u0 = RU[c0], u1 = RU[c1], d0 = RD[c0], d1 = RD[c1];
  const bool xs = c1 != c0, ys = r1 != r0;
  // right of c0 / left of c1, in rows r0 and r1
  const float right0 = xs ? a01 : (c0 == 0 ? q0 : a00);
  const float right1 = xs ? a11 : (c0 == 0 ? q1 : a10);
  const float left0 = (xs || c0 == 0) ? a00 : l0;
  const float left1 = (xs || c0 == 0) ? a10 : l1;
  // below r0 / above r1, in columns c0 and c1
  const float down0 = ys ? a10 : (r0 == 0 ? d0 : a00);
  const float down1 = ys ? a11 : (r0 == 0 ? d1 : a01);
  const float up0 = (ys || r0 == 0) ? a00 : u0;
  const float up1 = (ys || r0 == 0) ? a01 : u1;
  const float gx00 = (right0 - l0) * 0.5f, gx01 = (q0 - left0) * 0.5f;
  const float gx10 = (right1 - l1) * 0.5f, gx11 = (q1 - left1) * 0.5f;
  const float gy00 = (down0 - u0) * 0.5f, gy10 = (d0 - up0) * 0.5f;
  const float gy01 = (down1 - u1) * 0.5f, gy11 = (d1 - up1) * 0.5f;
  const float wy0 = 1.f - s.fy, wx0 = 1.f - s.fx;
  *iw = wx0 * (wy0 * a00 + s.fy * a10) + s.fx * (wy0 * a01 + s.fy * a11);
  *ixw = wx0 * (wy0 * gx00 + s.fy * gx10) + s.fx * (wy0 * gx01 + s.fy * gx11);
  *iyw = wx0 * (wy0 * gy00 + s.fy * gy10) + s.fx * (wy0 * gy01 + s.fy * gy11);
}

__global__ void __launch_bounds__(kEccThreads, 2) ecc_translation_kernel(EccArgs a) {
  extern __shared__ float staged[];
  __shared__ float red_a[kEccWarps * 6], red_b[kEccWarps * 4];
  const int n = blockIdx.x;
  const long long hw0 = (long long)a.H * a.W;
  int h, w;
  long long off, total;
  level_dims(a.H, a.W, 0, a.levels, &h, &w, &off, &total);
  float* img_levels = a.scratch + (long long)n * 2 * total;
  float* tpl_levels = img_levels + total;
  const float* img0 = a.image + n * hw0;
  const float* tpl0 = a.tmpl + n * hw0;

  // 1. the pyramids
  for (int l = 1; l < a.levels; ++l) {
    int hp, wp, hl, wl;
    long long offp, offl;
    level_dims(a.H, a.W, l - 1, a.levels, &hp, &wp, &offp, &total);
    level_dims(a.H, a.W, l, a.levels, &hl, &wl, &offl, &total);
    blur_halve(l == 1 ? img0 : img_levels + offp, hp, wp, img_levels + offl, hl, wl);
    blur_halve(l == 1 ? tpl0 : tpl_levels + offp, hp, wp, tpl_levels + offl, hl, wl);
    __syncthreads();
  }

  // 2. coarse to fine
  float px = a.p0 ? a.p0[2 * n] : 0.f, py = a.p0 ? a.p0[2 * n + 1] : 0.f;
  float rho = 0.f;
  for (int l = a.levels - 1; l >= 0; --l) {
    level_dims(a.H, a.W, l, a.levels, &h, &w, &off, &total);
    const int npix = h * w;
    const float* img = l == 0 ? img0 : img_levels + off;
    const float* tpl = l == 0 ? tpl0 : tpl_levels + off;
    if ((long long)npix * (long long)sizeof(float) <= a.stage_bytes) {
      for (int i = threadIdx.x; i < npix; i += kEccThreads) staged[i] = img[i];
      img = staged;
      __syncthreads();
    }
    // the template's mean, then its centred norm
    float tm[1] = {0.f};
    for_pixels(h, w, [&](int, int, int i) { tm[0] += tpl[i]; });
    block_sums(tm, red_a);
    const float tmean = tm[0] / (float)npix;
    float tn[1] = {0.f};
    for_pixels(h, w, [&](int, int, int i) {
      const float tb = tpl[i] - tmean;
      tn[0] += tb * tb;
    });
    block_sums(tn, red_b);
    const float t_norm = sqrtf(tn[0]) + 1e-12f;

    rho = 0.f;
    float drho = INFINITY;
    int it = 0;
    for (; it < a.iters; ++it) {
      if (a.eps > 0.f && !(drho > a.eps)) break;
      Shift s;
      s.i0x = floorf(px), s.fx = px - s.i0x;
      s.i0y = floorf(py), s.fy = py - s.i0y;
      // pass 1: the warped image's sum; the sums that need no centring
      float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for_pixels(h, w, [&](int y, int x, int i) {
        float iw, ixw, iyw;
        sample3(img, h, w, y, x, s, &iw, &ixw, &iyw);
        const float tb = tpl[i] - tmean;
        v[0] += iw;
        v[1] += ixw * ixw;
        v[2] += ixw * iyw;
        v[3] += iyw * iyw;
        v[4] += ixw * tb;
        v[5] += iyw * tb;
      });
      block_sums(v, red_a);
      const float mean = v[0] / (float)npix;
      // pass 2: the sums of the centred warped image
      float q[4] = {0.f, 0.f, 0.f, 0.f};
      for_pixels(h, w, [&](int y, int x, int i) {
        float iw, ixw, iyw;
        sample3(img, h, w, y, x, s, &iw, &ixw, &iyw);
        const float ib = iw - mean, tb = tpl[i] - tmean;
        q[0] += ib * ib;
        q[1] += ixw * ib;
        q[2] += iyw * ib;
        q[3] += tb * ib;
      });
      block_sums(q, red_b);
      const float c00 = v[1] + 1e-8f, c01 = v[2], c11 = v[3] + 1e-8f;
      const float gt0 = v[4], gt1 = v[5];
      const float i_norm2 = q[0] + 1e-12f, gi0 = q[1], gi1 = q[2], corr = q[3];
      const float det = c00 * c11 - c01 * c01;
      const float ci0 = (c11 * gi0 - c01 * gi1) / det, ci1 = (c00 * gi1 - c01 * gi0) / det;
      const float lam_num = i_norm2 - (gi0 * ci0 + gi1 * ci1);
      const float lam_den = corr - (gt0 * ci0 + gt1 * ci1);
      const float lam = fabsf(lam_den) < 1e-12f ? 1.f : lam_num / lam_den;
      const float b0 = lam * gt0 - gi0, b1 = lam * gt1 - gi1;
      float dp0 = (c11 * b0 - c01 * b1) / det, dp1 = (c00 * b1 - c01 * b0) / det;
      if (!isfinite(dp0)) dp0 = 0.f;
      if (!isfinite(dp1)) dp1 = 0.f;
      const float rho2 = corr / (t_norm * sqrtf(i_norm2));
      px += dp0;
      py += dp1;
      drho = fabsf(rho2 - rho);
      rho = rho2;
    }
    if (threadIdx.x == 0) a.iters_out[(long long)l * a.N + n] = it;
    if (l > 0) px *= 2.f, py *= 2.f;
  }
  // 4. ecc_align's fallback: a non-finite result becomes the identity with rho = -1
  if (!(isfinite(rho) && isfinite(px) && isfinite(py))) px = py = 0.f, rho = -1.f;
  if (threadIdx.x == 0) {
    a.p_out[2 * n] = px;
    a.p_out[2 * n + 1] = py;
    a.rho_out[n] = rho;
  }
}

// the dynamic shared memory of a launch: the largest level image that fits beside the static
// sums (levels shrink, so the finest one that fits)
int stage_bytes(int H, int W, int levels) {
  static const int optin = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return v;
  }();
  const long long limit = optin - (long long)sizeof(float) * kEccWarps * 10;
  for (int l = 0; l < levels; ++l) {
    int h, w;
    long long off, total;
    level_dims(H, W, l, levels, &h, &w, &off, &total);
    const long long bytes = (long long)h * w * sizeof(float);
    if (bytes <= limit) return (int)bytes;
  }
  return 0;
}

}  // namespace
}  // namespace fbanet

extern "C" {

int fbanet_ecc_translation(const void* tmpl, const void* image, const void* p0, void* p_out,
                           void* rho_out, void* iters_out, void* scratch, int N, int H, int W,
                           int levels, int iters, float eps, void* stream) {
  using namespace fbanet;
  if (N < 1 || H < 1 || W < 1 || levels < 1 || levels > kEccMaxLevels || iters < 0 ||
      (long long)H * W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int smem = stage_bytes(H, W, levels);
  cudaError_t e = cudaFuncSetAttribute(ecc_translation_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  EccArgs a{(const float*)tmpl, (const float*)image, (const float*)p0, (float*)p_out,
            (float*)rho_out, (int*)iters_out, (float*)scratch, N, H, W, levels, iters, eps,
            smem};
  ecc_translation_kernel<<<N, kEccThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
