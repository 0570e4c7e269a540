// K1: fused window attention (norm1 -> Q/KV projections -> per-head
// softmax(q k^T * dh^-1/2 + relative-position bias [+ shift mask]) V -> output
// projection [+ residual]) on a post-roll [B, H, W, C] feature map.
//
// Replaces the TPU kernel fbanet_tpu/ops/attention_pallas.py::
// _attention2d_kernel (launched by _pallas_forward_2d). Rounding points follow
// its _attn_block_math: LN in f32 rounded to the compute type; q, k, v from
// f32-accumulated products plus f32 bias (q scaled in f32) rounded; f32
// logits + bias + mask; max-subtracted exp with the probabilities rounded
// for the AV product and the division by the f32 row sum applied after it;
// f32-accumulated output projection + f32 bias, residual added in f32.
//
// What bounds it on the H100: arithmetic. A window reads 64 x C activations
// (16-32 KB in bf16) and does ~8 x 64 x C^2 flops of projections, about
// 256-1024 flops per byte of activation traffic, so the kernel is
// compute-bound. What the design does: one block per window reads its 64
// tokens straight from the 4-D map by index arithmetic and writes the result
// back in place, so no partition tensor, no q/k/v and no logits ever reach
// device memory (the point of the TPU kernel). Heads run in groups of at
// most 64 projected columns, which keeps the working set of C = 256 in
// shared memory (dynamic, above the 48 KB default). In bf16 every product
// runs on the tensor cores (WMMA 16x16x16, f32 accumulation, operands in
// shared memory, weights read from L2; a head of 8 channels, as FBANet-32's
// bottleneck, dec0 and dec1 have, sits zero-padded to 16 columns in the q,
// k, v tiles, head_pitch in attention_fwd.cuh); in f32 the products are
// register-tiled FMAs on the CUDA cores (f32 has no tensor-core path of the
// same precision). A wgmma/TMA pipeline with weights staged in shared
// memory is later work.
//
// K1b (fbanet_window_attention_windows) is the same block body on
// pre-partitioned windows [G, N, C]: it replaces the TPU kernel
// attention_pallas.py::_attention_kernel (launched by _pallas_forward, API
// fused_window_attention). Only the addressing changes: window g reads and
// writes rows g * N .. g * N + N - 1, its mask is mask[g % windows per
// image], and there is no residual.
//
// K9's first-kernel form (fbanet_window_attention_ablation, for the shapes
// K1's plan keeps here; on K1's wgmma form it is attention_ablation_wgmma*.cu)
// is K1's bf16 kernel with one stage removed at compile time, the
// counterpart of the ablation copy
// scripts/measure_swin_rates.py::_abl_kernel: mask-free, no residual;
// nosoftmax (p = logits / n, rounded), nocore (o = q + k + v in the compute
// type, no per-head stage), notrans (window g is n consecutive tokens of the
// row-major map: K1b's addressing over the map's memory). Its `full` variant
// is K1's own instantiation. The changed math is deliberate: the variants
// exist to split K1's time by stage.
//
// K7's first-kernel cores (attention_variants.cu, for the shapes K1's plan
// keeps here; on K1's wgmma form they are attention_variants_wgmma*.cu)
// rewrite this body's head stage; the pieces both use (head group,
// shared-memory layout, softmax) are in attention_fwd.cuh.
#include "attention_fwd.cuh"

namespace fbanet {
namespace {

// f32 kernel: every array f32 with odd row strides (no bank conflicts).
inline size_t attention_f32_smem(int n, int C, int heads) {
  const int dh = C / heads;
  const int gw = head_group(heads, dh) * dh;
  return sizeof(float) * ((size_t)2 * n * (C + 1) + (size_t)3 * n * (gw + 1) +
                          (size_t)n * (n + 1) + n);
}

// Six ints only: three more (a 132-byte parameter block instead of 120)
// made K1 ~11 % slower on the H100, with its body unchanged (the A/B runs
// in PERF.md). Map mode: H, W and the window ws of the post-roll map.
// Windowed mode (ws == 0, K1b and K9's notrans): H is the mask's window
// count and W the tokens per window.
struct Args {
  const void* x;
  void* out;
  const float *ln_s, *ln_b;
  const void *wq, *wkv, *wproj;  // compute-dtype weights, torch Linear layout
  const float *bq, *bkv, *bproj, *bias, *mask;
  int H, W, C, heads, ws, residual;
};

// The token lookup of a block (common.cuh's WinBlock) from Args' six ints.
__device__ __forceinline__ WinBlock window_block(int H, int W, int C, int ws) {
  if (ws == 0) return WinBlock(WinGeom{0, 0, C, 0, W, H, 1});
  return WinBlock(WinGeom{H, W, C, ws, ws * ws, (H / ws) * (W / ws), 0});
}

__global__ void __launch_bounds__(kThreads) window_attention_f32_kernel(Args a) {
  extern __shared__ float smem[];
  const float* __restrict__ x = (const float*)a.x;
  float* __restrict__ out = (float*)a.out;
  const float* wq = (const float*)a.wq;
  const float* wkv = (const float*)a.wkv;
  const float* wproj = (const float*)a.wproj;
  const int C = a.C, n = a.ws ? a.ws * a.ws : a.W;
  const int dh = C / a.heads;
  const int gw = group_width(C, a.heads);
  const int ldc = C + 1, ldg = gw + 1, lds = n + 1;
  float* sY = smem;             // [n][ldc] LN output
  float* sO = sY + n * ldc;     // [n][ldc] attention output, all heads
  float* sQ = sO + n * ldc;     // [n][ldg] q of the head group
  float* sK = sQ + n * ldg;     // [n][ldg]
  float* sV = sK + n * ldg;     // [n][ldg]
  float* sS = sV + n * ldg;     // [n][lds] logits, then probabilities
  float* sInv = sS + n * lds;   // [n] 1 / row sum

  const WinBlock wb = window_block(a.H, a.W, C, a.ws);
  auto tok = [&](int t) -> size_t { return wb.pix(t) * C; };  // token t's channel 0
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < n; t += kThreads / 32)
    layernorm_row<float>(x + tok(t), C, a.ln_s, a.ln_b, sY + t * ldc, lane);
  __syncthreads();

  const float scale = 1.0f / sqrtf((float)dh);
  const float* mw = a.mask ? a.mask + (size_t)wb.win * n * n : nullptr;
  for (int g0 = 0; g0 < C; g0 += gw) {
    gemm_nt(n, gw, C, sY, ldc, wq + (size_t)g0 * C, C, 1, [&](int m, int j, float v) {
      sQ[m * ldg + j] = (v + a.bq[g0 + j]) * scale;
    });
    gemm_nt(n, gw, C, sY, ldc, wkv + (size_t)g0 * C, C, 1, [&](int m, int j, float v) {
      sK[m * ldg + j] = v + a.bkv[g0 + j];
    });
    gemm_nt(n, gw, C, sY, ldc, wkv + (size_t)(C + g0) * C, C, 1, [&](int m, int j, float v) {
      sV[m * ldg + j] = v + a.bkv[C + g0 + j];
    });
    __syncthreads();
    for (int hh = 0; hh < gw / dh; ++hh) {
      const int h = g0 / dh + hh;
      const float* bh = a.bias + (size_t)h * n * n;
      gemm_nt(n, n, dh, sQ + hh * dh, ldg, sK + hh * dh, ldg, 1, [&](int m, int s, float v) {
        sS[m * lds + s] = v + bh[m * n + s] + (mw ? mw[m * n + s] : 0.f);
      });
      __syncthreads();
      softmax_rows(n, sS, lds, sS, lds, sInv);  // in place
      __syncthreads();
      // o = P V: B[d][s] = V[s][d] (column access: bsn = 1, bsk = ldg)
      gemm_nt(n, dh, n, sS, lds, sV + hh * dh, 1, ldg, [&](int m, int d, float v) {
        sO[m * ldc + h * dh + d] = v * sInv[m];
      });
      __syncthreads();
    }
  }

  gemm_nt(n, C, C, sO, ldc, wproj, C, 1, [&](int m, int o, float v) {
    const size_t p = tok(m) + o;
    out[p] = v + a.bproj[o] + (a.residual ? x[p] : 0.f);
  });
}

// o = p v divides by the row sum after the product: 1 / (row sum) from
// softmax_rows, or 1 for K9's nosoftmax, whose probabilities are the logits
// times 1 / n, rounded (the script's `(attn * (1.0 / n)).astype(cdtype)`).
__device__ __forceinline__ void uniform_rows(int n, const float* sS, int lds, bf16* sP,
                                             int ldp, float* sInv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int m = warp; m < n; m += kThreads / 32) {
    for (int s = lane; s < n; s += 32) sP[m * ldp + s] = __float2bfloat16(sS[m * lds + s] * (1.0f / n));
    if (lane == 0) sInv[m] = 1.0f;
  }
}

// kSoftmax / kCore false: K9's nosoftmax / nocore (K1 itself is <true, true>).
// kPad: heads whose size is not a multiple of 16, padded (head_pitch); the
// other instantiations keep each head at its own width.
template <bool kSoftmax, bool kCore, bool kPad = false>
__global__ void __launch_bounds__(kThreads) window_attention_bf16_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const bf16* __restrict__ x = (const bf16*)a.x;
  bf16* __restrict__ out = (bf16*)a.out;
  const bf16* wq = (const bf16*)a.wq;
  const bf16* wkv = (const bf16*)a.wkv;
  const bf16* wproj = (const bf16*)a.wproj;
  const int C = a.C, n = a.ws ? a.ws * a.ws : a.W;
  const int dh = C / a.heads, dp = kPad ? head_pitch(dh) : dh;
  const int gw = group_width(C, a.heads);
  const int gp = kPad ? group_pitch(C, a.heads) : gw;
  const int ldc = C + 8, ldg = gp + 8, ldp = n + 8, lds = n + 1;
  const Bf16Layout L(n, C, gp);
  bf16* sY = (bf16*)(smem_raw + L.y);
  bf16* sO = (bf16*)(smem_raw + L.o);
  bf16* sQ = (bf16*)(smem_raw + L.q);
  bf16* sK = (bf16*)(smem_raw + L.k);
  bf16* sV = (bf16*)(smem_raw + L.v);
  bf16* sP = (bf16*)(smem_raw + L.p);
  float* sS = (float*)(smem_raw + L.s);
  float* sInv = (float*)(smem_raw + L.inv);
  float* scratch = (float*)(smem_raw + L.scratch);

  const WinBlock wb = window_block(a.H, a.W, C, a.ws);
  auto tok = [&](int t) -> size_t { return wb.pix(t) * C; };
  // column j of a head group's projection -> its column in the padded tiles
  auto padded = [&](int j) { return kPad ? j + (j / dh) * (dp - dh) : j; };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (kPad)  // the padding columns stay zero: no epilogue writes them
    for (int i = threadIdx.x; i < n * ldg; i += kThreads) {
      const bf16 zero = __float2bfloat16(0.f);
      sQ[i] = zero;
      sK[i] = zero;
      sV[i] = zero;
    }
  for (int t = warp; t < n; t += kThreads / 32)
    layernorm_row<bf16>(x + tok(t), C, a.ln_s, a.ln_b, sY + t * ldc, lane);
  __syncthreads();

  const float scale = 1.0f / sqrtf((float)dh);
  const float* mw = a.mask ? a.mask + (size_t)wb.win * n * n : nullptr;
  using col = wmma::col_major;
  for (int g0 = 0; g0 < C; g0 += gw) {
    gemm_tc<col>(n, n, gw, C, sY, ldc, wq + (size_t)g0 * C, C, scratch,
                 [&](int m, int j, float v) {
                   sQ[m * ldg + padded(j)] = __float2bfloat16((v + a.bq[g0 + j]) * scale);
                 });
    gemm_tc<col>(n, n, gw, C, sY, ldc, wkv + (size_t)g0 * C, C, scratch,
                 [&](int m, int j, float v) {
                   sK[m * ldg + padded(j)] = __float2bfloat16(v + a.bkv[g0 + j]);
                 });
    gemm_tc<col>(n, n, gw, C, sY, ldc, wkv + (size_t)(C + g0) * C, C, scratch,
                 [&](int m, int j, float v) {
                   sV[m * ldg + padded(j)] = __float2bfloat16(v + a.bkv[C + g0 + j]);
                 });
    __syncthreads();
    if constexpr (!kCore) {
      // K9 nocore: o = (q + k) + v, each sum rounded as bf16 arrays add
      for (int i = threadIdx.x; i < n * gw; i += kThreads) {
        const int m = i / gw, j = i % gw, jp = m * ldg + padded(j);
        const float qk = round_to<bf16>(__bfloat162float(sQ[jp]) + __bfloat162float(sK[jp]));
        sO[m * ldc + g0 + j] = __float2bfloat16(qk + __bfloat162float(sV[jp]));
      }
      __syncthreads();
      continue;
    }
    for (int hh = 0; hh < gw / dh; ++hh) {
      const int h = g0 / dh + hh;
      const float* bh = a.bias + (size_t)h * n * n;
      // logits: B(d, s) = K[s][d], a column-major view of the k tile (over
      // the padded head: the padding adds zeros)
      gemm_tc<col>(n, n, n, dp, sQ + hh * dp, ldg, sK + hh * dp, ldg, scratch,
                   [&](int m, int s, float v) {
                     sS[m * lds + s] = v + bh[m * n + s] + (mw ? mw[m * n + s] : 0.f);
                   });
      __syncthreads();
      if constexpr (kSoftmax)
        softmax_rows(n, sS, lds, sP, ldp, sInv);
      else
        uniform_rows(n, sS, lds, sP, ldp, sInv);
      __syncthreads();
      gemm_tc<wmma::row_major>(n, n, dp, n, sP, ldp, sV + hh * dp, ldg, scratch,
                               [&](int m, int d, float v) {
                                 if (!kPad || d < dh)  // not a padding column
                                   sO[m * ldc + h * dh + d] = __float2bfloat16(v * sInv[m]);
                               });
      __syncthreads();
    }
  }

  gemm_tc<col>(n, n, C, C, sO, ldc, wproj, C, scratch, [&](int m, int o, float v) {
    const size_t p = tok(m) + o;
    float r = v + a.bproj[o];
    if (a.residual) r += __bfloat162float(x[p]);
    out[p] = __float2bfloat16(r);
  });
}

size_t smem_bytes(int n, int C, int heads, int bf16) {
  return bf16 ? Bf16Layout(n, C, group_pitch(C, heads)).total
              : attention_f32_smem(n, C, heads);
}

using Kernel = void (*)(Args);

// K1's own instantiation for the compute type and head size (K1b's too).
Kernel production_kernel(int use_bf16, int dh) {
  if (use_bf16)
    return head_pitch(dh) == dh ? window_attention_bf16_kernel<true, true>
                                : window_attention_bf16_kernel<true, true, true>;
  return window_attention_f32_kernel;
}

Kernel ablation_kernel(int variant) {
  switch (variant) {
    case 1: return window_attention_bf16_kernel<false, true>;
    case 2: return window_attention_bf16_kernel<true, false>;
    default: return window_attention_bf16_kernel<true, true>;
  }
}

int launch(Kernel kern, const Args& a, unsigned grid, int smem, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// H, W, ws as Args takes them (ws == 0: H mask windows, W tokens).
Args make_args(const void* x, void* out, const void* ln_s, const void* ln_b, const void* wq,
               const void* bq, const void* wkv, const void* bkv, const void* wproj,
               const void* bproj, const void* bias, const void* mask, int H, int W, int C,
               int heads, int ws, int residual) {
  return Args{x, out, (const float*)ln_s, (const float*)ln_b, wq, wkv, wproj,
              (const float*)bq, (const float*)bkv, (const float*)bproj,
              (const float*)bias, (const float*)mask, H, W, C, heads, ws, residual};
}

}  // namespace
}  // namespace fbanet

extern "C" {

// Dynamic shared memory of one block, or 0 for a shape the kernel does not
// take (the bf16 kernel tiles by 16: tokens, C and a head group's width;
// head sizes in multiples of 8, padded to 16).
int fbanet_window_attention_smem(int n, int C, int heads, int bf16) {
  if (C % heads) return 0;
  if (bf16 && (n % 16 || C % 16 || (C / heads) % 8 ||
               fbanet::group_width(C, heads) % 16))
    return 0;
  return (int)fbanet::smem_bytes(n, C, heads, bf16);
}

// K1 on the post-roll map [B, H, W, C].
int fbanet_window_attention(const void* x, void* out, const void* ln_s,
                            const void* ln_b, const void* wq, const void* bq,
                            const void* wkv, const void* bkv, const void* wproj,
                            const void* bproj, const void* bias, const void* mask,
                            int B, int H, int W, int C, int heads, int ws,
                            int residual, int bf16, void* stream) {
  using namespace fbanet;
  const int n = ws * ws, nw = (H / ws) * (W / ws);
  const int smem = fbanet_window_attention_smem(n, C, heads, bf16);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const Args a = make_args(x, out, ln_s, ln_b, wq, bq, wkv, bkv, wproj, bproj, bias, mask,
                           H, W, C, heads, ws, residual);
  return launch(production_kernel(bf16, C / heads), a, (unsigned)B * nw, smem, stream);
}

// K1b on pre-partitioned windows [G, n, C]: mask [nw, n, n] or null, window
// g masked by mask[g % nw]; no residual.
int fbanet_window_attention_windows(const void* x, void* out, const void* ln_s,
                                    const void* ln_b, const void* wq, const void* bq,
                                    const void* wkv, const void* bkv, const void* wproj,
                                    const void* bproj, const void* bias, const void* mask,
                                    int G, int n, int C, int heads, int nw, int bf16,
                                    void* stream) {
  using namespace fbanet;
  const int smem = fbanet_window_attention_smem(n, C, heads, bf16);
  if (smem == 0 || nw < 1) return (int)cudaErrorInvalidValue;
  const Args a = make_args(x, out, ln_s, ln_b, wq, bq, wkv, bkv, wproj, bproj, bias, mask,
                           nw, n, C, heads, 0, 0);
  return launch(production_kernel(bf16, C / heads), a, (unsigned)G, smem, stream);
}

// K9 on a bf16 map [B, H, W, C], mask-free, no residual. variant: 0 full
// (K1's instantiation), 1 nosoftmax, 2 nocore, 3 notrans (K1b's addressing
// over the map: window g = tokens g * n .. g * n + n - 1). `mask` is ignored.
int fbanet_window_attention_ablation(const void* x, void* out, const void* ln_s,
                                     const void* ln_b, const void* wq, const void* bq,
                                     const void* wkv, const void* bkv, const void* wproj,
                                     const void* bproj, const void* bias, const void* mask,
                                     int B, int H, int W, int C, int heads, int ws,
                                     int variant, void* stream) {
  using namespace fbanet;
  (void)mask;
  const int n = ws * ws, nw = (H / ws) * (W / ws);
  const int smem = fbanet_window_attention_smem(n, C, heads, 1);
  if (smem == 0 || variant < 0 || variant > 3 || head_pitch(C / heads) != C / heads)
    return (int)cudaErrorInvalidValue;  // the variants keep heads unpadded
  const Args a = variant == 3
                     ? make_args(x, out, ln_s, ln_b, wq, bq, wkv, bkv, wproj, bproj, bias,
                                 nullptr, 1, n, C, heads, 0, 0)
                     : make_args(x, out, ln_s, ln_b, wq, bq, wkv, bkv, wproj, bproj, bias,
                                 nullptr, H, W, C, heads, ws, 0);
  return launch(ablation_kernel(variant), a, (unsigned)B * nw, smem, stream);
}

const char* fbanet_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
