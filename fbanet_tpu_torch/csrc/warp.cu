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
// What bounds them on the H100: bytes. Each output value needs four reads
// and a handful of flops; the least traffic is each frame read once and
// each output written once (plus the coordinates for K6). Neighbouring
// threads take neighbouring x, so the taps of a warp fall on a few rows of
// the frame and are served mostly from L1/L2. K5 and K6's general path
// (any C) run one thread per output pixel looping over the channels.
//
// At C = 3 both have their own kernel: K6 warps the [image, gx, gy] stack
// of the ECC loop (75 calls per align, at 160, 80 and 40 px), K5 the RGB
// frames at the end of the align (104 x 160^2 x 3 at the published burst).
// The generic one reached about half of its byte bound at 160 px: each
// thread made 12 scalar tap loads and three 4-byte stores at a 12-byte
// stride (a warp's store touched 12 sectors per instruction), and K5's
// read its frame's nine matrix floats per thread. Here C is a template
// parameter; a pixel's two taps of a row are one contiguous run of 6
// floats, read as three 8-byte loads (or 4 + 8 + 8 + 4 bytes where the run
// is not 8-byte aligned); the block's outputs are staged in shared memory
// and written out as float4, so every store instruction of a warp writes
// 512 contiguous bytes; each thread samples 4, 2 or 1 pixels (kPix, the
// most that still fills the card: 4 at 160 px, 2 at 80, 1 at 40 on 104
// frames), with the position loads of its pixels in flight together. The
// one kernel takes its positions from a template source: K6's coordinates,
// or K5's frame matrices, staged once per block in shared memory (a block
// of at most 1,024 pixels touches two 160 px frames) and applied with
// the generic kernel's expressions.
// At 80 and 40 px the card's work is a few microseconds; there the call's
// time is the host's (ops/warp_kernels.py keeps that to one allocation and
// one foreign call).
#include "common.cuh"

#include <cstdint>

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

// v[0..5] = p[0..5]: three 8-byte loads where p is 8-byte aligned, else
// 4 + 8 + 8 + 4 bytes
__device__ __forceinline__ void load_run6(const float* p, float v[6]) {
  if ((reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    const float2 b = __ldg(reinterpret_cast<const float2*>(p + 2));
    const float2 c = __ldg(reinterpret_cast<const float2*>(p + 4));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y, v[4] = c.x, v[5] = c.y;
  } else {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p + 1));
    const float2 b = __ldg(reinterpret_cast<const float2*>(p + 3));
    v[0] = __ldg(p), v[1] = a.x, v[2] = a.y, v[3] = b.x, v[4] = b.y, v[5] = __ldg(p + 5);
  }
}

// K6's positions: (y, x) per pixel from coords [F, H, W, 2].
struct CoordsPos {
  const float2* coords;
  __device__ __forceinline__ void stage(int, int, int, float*) const {}
  __device__ __forceinline__ float2 at(int p, int, int, int, const float*) const {
    return __ldg(coords + p);
  }
};

// K5's positions: (ys / den, xs / den), [xs, ys, den] = M_f [x, y, 1], with
// the matrices of the block's frames f0, f0 + 1, ... staged in `sm`.
struct HomographyPos {
  const float* mats;
  // frames a block of `npix` pixels touches, at most
  __host__ __device__ static int frames(int npix, int hw) { return (npix - 1) / hw + 2; }
  __device__ __forceinline__ void stage(int p0, int npix, int hw, float* sm) const {
    const int f0 = p0 / hw, n = 9 * ((p0 + npix - 1) / hw - f0 + 1);
    for (int i = threadIdx.x; i < n; i += kThreads) sm[i] = __ldg(mats + (size_t)f0 * 9 + i);
    __syncthreads();
  }
  // pixel (x, y) of frame f0 + df
  __device__ __forceinline__ float2 at(int, int df, int y, int x, const float* sm) const {
    const float* m = sm + 9 * df;
    const float xf = (float)x, yf = (float)y;
    const float xs = m[0] * xf + m[1] * yf + m[2];
    const float ys = m[3] * xf + m[4] * yf + m[5];
    float den = m[6] * xf + m[7] * yf + m[8];
    if (fabsf(den) < 1e-12f) den = 1e-12f;
    return make_float2(__fdiv_rn(ys, den), __fdiv_rn(xs, den));
  }
};

// K5's and K6's block for a compile-time channel count C (instantiated for
// C = 3): the block owns kBlockPix = kThreads x kPix consecutive output
// pixels (in (f, y, x) order); thread t samples pixels t, t + kThreads, ...
// of them, at positions from `pos`, into shared memory, which the block
// then writes out as float4. The same arithmetic as sample_pixel.
template <int C, int kPix, typename Pos>
__device__ __forceinline__ void warp_staged(const WarpArgs& a, const Pos& pos) {
  static_assert(C == 3, "the taps are read as runs of 2 C = 6 floats");
  constexpr int kBlockPix = kThreads * kPix;
  __shared__ float4 stage4[kBlockPix * C / 4];
  extern __shared__ float pos_sm[];  // what `pos` stages, if anything
  float* stage = reinterpret_cast<float*>(stage4);
  const int hw = a.H * a.W;
  const int p0 = blockIdx.x * kBlockPix;
  const int npix = min(kBlockPix, a.F * hw - p0);
  const float hm1 = (float)(a.H - 1), wm1 = (float)(a.W - 1);
  pos.stage(p0, npix, hw, pos_sm);
  // (frame, row, column) of the thread's first pixel by division, of each
  // next one (kThreads further on) by carrying
  const int f0 = p0 / hw;
  int f = (p0 + (int)threadIdx.x) / hw, r = p0 + (int)threadIdx.x - f * hw;
  int y = r / a.W, x = r - y * a.W;
  float2 yx[kPix];
  int fk[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (k > 0) {
      for (x += kThreads; x >= a.W; x -= a.W) ++y;
      for (; y >= a.H; y -= a.H) ++f;
    }
    fk[k] = f;
    yx[k] = i < npix ? pos.at(p0 + i, f - f0, y, x, pos_sm) : make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i >= npix) break;
    float* dst = stage + i * C;
    const float cy = yx[k].x, cx = yx[k].y;
    if (a.constant && !(cy >= 0.f && cy <= hm1 && cx >= 0.f && cx <= wm1)) {
#pragma unroll
      for (int c = 0; c < C; ++c) dst[c] = a.cval;
      continue;
    }
    const float cyc = fminf(fmaxf(cy, 0.f), hm1), cxc = fminf(fmaxf(cx, 0.f), wm1);
    const int y0 = min(max((int)cyc, 0), a.H - 2), x0 = min(max((int)cxc, 0), a.W - 2);
    const float fy = cyc - (float)y0, fx = cxc - (float)x0;
    const float* p00 = a.frames + ((size_t)fk[k] * hw + (size_t)y0 * a.W + x0) * C;
    float top[2 * C], bot[2 * C];
    load_run6(p00, top);
    load_run6(p00 + (size_t)a.W * C, bot);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float left = top[c] * (1.f - fy) + bot[c] * fy;
      const float right = top[C + c] * (1.f - fy) + bot[C + c] * fy;
      dst[c] = left * (1.f - fx) + right * fx;
    }
  }
  __syncthreads();
  float* out = a.out + (size_t)p0 * C;
  if (npix == kBlockPix) {  // p0 C floats is a multiple of 4: 16-byte aligned
    float4* out4 = reinterpret_cast<float4*>(out);
    for (int i = threadIdx.x; i < kBlockPix * C / 4; i += kThreads) out4[i] = stage4[i];
  } else {
    for (int i = threadIdx.x; i < npix * C; i += kThreads) out[i] = stage[i];
  }
}

// the kernels of K6 and K5 at C channels, kPix pixels a thread
template <int C, int kPix>
__global__ void __launch_bounds__(kThreads)
    warp_coords_staged_kernel(WarpArgs a, CoordsPos pos) {
  warp_staged<C, kPix>(a, pos);
}

// (eight blocks an SM, as launch_staged counts: 32 registers, where it
// would take 40 and hold six)
template <int C, int kPix>
__global__ void __launch_bounds__(kThreads, 8)
    warp_homography_staged_kernel(WarpArgs a, HomographyPos pos) {
  warp_staged<C, kPix>(a, pos);
}

template <int kPix> auto staged_kernel(CoordsPos) { return warp_coords_staged_kernel<3, kPix>; }
template <int kPix> auto staged_kernel(HomographyPos) {
  return warp_homography_staged_kernel<3, kPix>;
}

// Launch the C = 3 kernel with the most pixels per thread (4, 2, 1) whose
// grid still fills every SM with 2048 threads (8 blocks), as many as it
// can hold; `pos_bytes(block pixels)` is the shared memory `pos` stages.
template <typename Pos, typename PosBytes>
cudaError_t launch_staged(const WarpArgs& a, const Pos& pos, PosBytes pos_bytes,
                          cudaStream_t stream) {
  static const int sms = [] {
    int dev = 0, n = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const int total = a.F * a.H * a.W;
  int ppt = 4;
  while (ppt > 1 && (total + kThreads * ppt - 1) / (kThreads * ppt) < 8 * sms) ppt /= 2;
  const dim3 grid((unsigned)((total + kThreads * ppt - 1) / (kThreads * ppt)));
  const size_t smem = pos_bytes(kThreads * ppt);
  const auto kernel = ppt == 1   ? staged_kernel<1>(pos)
                      : ppt == 2 ? staged_kernel<2>(pos)
                                 : staged_kernel<4>(pos);
  kernel<<<grid, kThreads, smem, stream>>>(a, pos);
  return cudaGetLastError();
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
  if (C == 3 && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    const int hw = H * W;
    return (int)launch_staged(a, HomographyPos{(const float*)mats},
                              [hw](int block_pix) {
                                return sizeof(float) * 9 * HomographyPos::frames(block_pix, hw);
                              },
                              (cudaStream_t)stream);
  }
  warp_homography_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a, (const float*)mats);
  return (int)cudaGetLastError();
}

int fbanet_warp_coords(const void* frames, const void* coords, void* out, int F, int H, int W,
                       int C, int constant, float cval, void* stream) {
  using namespace fbanet;
  WarpArgs a{(const float*)frames, (float*)out, F, H, W, C, constant, cval};
  dim3 grid;
  if (cudaError_t e = launch_grid(a, &grid); e != cudaSuccess) return (int)e;
  if (C == 3 && reinterpret_cast<uintptr_t>(out) % 16 == 0)
    return (int)launch_staged(a, CoordsPos{(const float2*)coords}, [](int) { return size_t(0); },
                              (cudaStream_t)stream);
  warp_coords_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a, (const float*)coords);
  return (int)cudaGetLastError();
}

}  // extern "C"
