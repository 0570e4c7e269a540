// K5 and K6: bilinear warps of a burst of channels-last f32 frames.
//
// K5 fbanet_warp_homography replaces fbanet_tpu/ops/warp_pallas.py::
// _homography_kernel: each output pixel (x, y) of frame f samples the frame
// at (xs / den, ys / den), [xs, ys, den] = M_f [x, y, 1], with |den| < 1e-12
// replaced by 1e-12. K6 fbanet_warp_coords replaces _coords_kernel: it
// samples at given (y, x) positions, coords [F, H, W, 2].
//
// The shared sample (the TPU's _warp_rows_kernel_body, warp_pallas.py:57-99)
// clamps the position into the image first and the cell after:
// cyc = clip(cy, 0, h-1), y0 = clip(int(cyc), 0, h-2), fy = cyc - y0, the
// same for x; blends the two rows of each column, then the two columns. In
// constant mode a pixel whose unclamped position lies outside
// [0, h-1] x [0, w-1] becomes cval as a whole (no per-tap blend). The TPU
// kernel's one-hot matrix products, hi/lo bf16 split of the image and
// approximate reciprocal are workarounds for a machine without a vector
// gather; here each thread gathers its four taps from f32 memory and the
// divide is IEEE f32.
//
// What bounds it: bytes. Each output value needs four reads and a handful
// of flops, and neighbouring threads take neighbouring x, so the taps of a
// warp fall on a few rows of the frame and are served mostly from L1/L2.
// The least traffic is each frame read once and each output written once
// (plus the coordinates for K6). One thread per output pixel loops over the
// channels; frames stay channels-last, so a pixel's C values are adjacent.
#include "common.cuh"

namespace fbanet {
namespace {

struct WarpArgs {
  const float* frames;  // [F, H, W, C]
  float* out;           // [F, H, W, C]
  int F, H, W, C, constant;
  float cval;
};

__device__ __forceinline__ void sample_pixel(const WarpArgs& a, int f, int y, int x, float cy,
                                             float cx) {
  const float hm1 = (float)(a.H - 1), wm1 = (float)(a.W - 1);
  float* dst = a.out + (((size_t)f * a.H + y) * a.W + x) * a.C;
  if (a.constant && !(cy >= 0.f && cy <= hm1 && cx >= 0.f && cx <= wm1)) {
    for (int c = 0; c < a.C; ++c) dst[c] = a.cval;
    return;
  }
  // fmaxf maps a NaN position to 0, so no index leaves the frame
  const float cyc = fminf(fmaxf(cy, 0.f), hm1), cxc = fminf(fmaxf(cx, 0.f), wm1);
  const int y0 = min(max((int)cyc, 0), a.H - 2), x0 = min(max((int)cxc, 0), a.W - 2);
  const float fy = cyc - (float)y0, fx = cxc - (float)x0;
  const float* p00 = a.frames + (((size_t)f * a.H + y0) * a.W + x0) * a.C;
  const float* p10 = p00 + (size_t)a.W * a.C;
  for (int c = 0; c < a.C; ++c) {
    const float left = __ldg(p00 + c) * (1.f - fy) + __ldg(p10 + c) * fy;
    const float right = __ldg(p00 + a.C + c) * (1.f - fy) + __ldg(p10 + a.C + c) * fy;
    dst[c] = left * (1.f - fx) + right * fx;
  }
}

// one thread per output pixel, pixels in (f, y, x) order
__device__ __forceinline__ bool pixel_of_thread(const WarpArgs& a, int* f, int* y, int* x) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.F * a.H * a.W) return false;
  *x = i % a.W;
  *y = (i / a.W) % a.H;
  *f = i / (a.W * a.H);
  return true;
}

__global__ void __launch_bounds__(kThreads)
    warp_homography_kernel(WarpArgs a, const float* __restrict__ mats) {
  int f, y, x;
  if (!pixel_of_thread(a, &f, &y, &x)) return;
  const float* m = mats + (size_t)f * 9;
  const float xf = (float)x, yf = (float)y;
  const float xs = m[0] * xf + m[1] * yf + m[2];
  const float ys = m[3] * xf + m[4] * yf + m[5];
  float den = m[6] * xf + m[7] * yf + m[8];
  if (fabsf(den) < 1e-12f) den = 1e-12f;
  sample_pixel(a, f, y, x, __fdiv_rn(ys, den), __fdiv_rn(xs, den));
}

__global__ void __launch_bounds__(kThreads)
    warp_coords_kernel(WarpArgs a, const float* __restrict__ coords) {
  int f, y, x;
  if (!pixel_of_thread(a, &f, &y, &x)) return;
  const float2 yx = __ldg(reinterpret_cast<const float2*>(coords) +
                          ((size_t)f * a.H + y) * a.W + x);
  sample_pixel(a, f, y, x, yx.x, yx.y);
}

cudaError_t launch_grid(const WarpArgs& a, dim3* grid) {
  if (a.F < 1 || a.H < 2 || a.W < 2 || a.C < 1 ||
      (long long)a.F * a.H * a.W > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  *grid = dim3((a.F * a.H * a.W + kThreads - 1) / kThreads);
  return cudaSuccess;
}

}  // namespace
}  // namespace fbanet

extern "C" {

int fbanet_warp_homography(const void* frames, const void* mats, void* out, int F, int H,
                           int W, int C, int constant, float cval, void* stream) {
  using namespace fbanet;
  WarpArgs a{(const float*)frames, (float*)out, F, H, W, C, constant, cval};
  dim3 grid;
  if (cudaError_t e = launch_grid(a, &grid); e != cudaSuccess) return (int)e;
  warp_homography_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a, (const float*)mats);
  return (int)cudaGetLastError();
}

int fbanet_warp_coords(const void* frames, const void* coords, void* out, int F, int H, int W,
                       int C, int constant, float cval, void* stream) {
  using namespace fbanet;
  WarpArgs a{(const float*)frames, (float*)out, F, H, W, C, constant, cval};
  dim3 grid;
  if (cudaError_t e = launch_grid(a, &grid); e != cudaSuccess) return (int)e;
  warp_coords_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a, (const float*)coords);
  return (int)cudaGetLastError();
}

}  // extern "C"
