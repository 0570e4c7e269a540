// K3: the backward of K1 (fused norm1 + window attention) on a post-roll
// [B, H, W, C] map: dx, plus what the parameter gradients need.
//
// Replaces the TPU kernel fbanet_tpu/ops/attention_pallas.py::
// _attention_bwd_kernel (launched by _pallas_backward, reached from K1's
// custom_vjp through _fused2d_bwd -> _fused_bwd). Rounding points follow it:
// the forward is recomputed (LN in f32, y rounded; q scaled in f32 after its
// bias, then rounded; k, v rounded; f32 logits + bias + mask; p = e * (1 /
// sum) in f32, rounded for the products); the incoming gradient g rounded;
// do = g Wproj^T rounded; dp = do v^T and dv = p^T do in f32; dlogits =
// p (dp - sum(dp p)) in f32, rounded for dq = dlogits k and dk = dlogits^T q;
// dq scaled in f32; dq, dk, dv rounded for dy = dq Wq + dkv Wkv (f32); the
// LayerNorm backward in f32.
//
// One block per window, as K1. Pass 1 recomputes LN and, head group by head
// group, q, k, v; per head it rebuilds the probabilities and produces dq, dk,
// dv. Pass 2 forms dy [64, C] in an f32 shared-memory tile from the rounded
// dq, dk, dv that pass 1 wrote out, and finishes dx. The parameter gradients
// are sums over all windows, which the TPU accumulates across its ordered
// grid. Here each block writes what those sums need to scratch the wrapper
// allocates: the rounded y, o, dq and dk|dv per token (image layout), for
// the weight gradients dW = cotangent^T . input, and one f32 row of per-block
// partial sums (LN scale/bias, bq, bkv, bproj, the [heads, 64, 64] bias).
// csrc/reduce.cu sums them in a fixed order, so the gradients are bitwise
// repeatable.
//
// What bounds it on the H100: arithmetic, as K1 (about twice K1's products
// per window against reading x and g once). The working set of C = 256 / 16
// heads fits shared memory because heads run in groups (the host picks the
// widest group that fits) and pass 2 reuses pass 1's space. bf16 products
// run on the tensor cores (WMMA 16x16x16, f32 accumulation); f32 ones on the
// CUDA cores.
#include "common.cuh"

namespace fbanet {
namespace {

struct BwdArgs {
  const void *x, *g;
  void *dx, *ys, *os, *dqs, *dkvs;  // dx out; per-token scratch, compute type
  float* part;                      // [windows][6C + heads n n] partial sums
  const float *ln_s, *ln_b;
  const void *wq, *wkv, *wproj;  // compute-type weights, torch Linear layout
  const float *bq, *bkv, *bias, *mask;
  int H, W, C, heads, ws, residual, gw;
};

// Shared-memory layout (byte offsets) for n tokens, width C, head size dh,
// head-group width gw. Element strides: bf16 arrays C + 8 / gw + 8 / n + 8
// (WMMA wants multiples of 8), f32 arrays odd (no bank conflicts). Pass 2
// (dy and its operand staging) reuses pass 1's space after the statistics.
struct BwdLayout {
  int ldc, ldg, ldp, lds, ldd, ldy, kc;
  size_t mu, inv, y, d_o, q, k, v, s, p, dp, dq, dk, dv, scratch, gstage, dy, a2, total;
  __host__ __device__ BwdLayout(int n, int C, int dh, int gw, bool bf) {
    const size_t e = bf ? 2 : 4;
    ldc = bf ? C + 8 : C + 1;
    ldg = bf ? gw + 8 : gw + 1;
    ldp = n + 8;
    lds = n + 1;
    ldd = dh + 1;
    ldy = C + 4;
    kc = (C % 64 == 0) ? 64 : 16;
    mu = 0;
    inv = mu + align128(sizeof(float) * n);
    const size_t base = inv + align128(sizeof(float) * n);
    y = base;
    d_o = y + align128(e * n * ldc);
    q = d_o + align128(e * n * ldc);
    k = q + align128(e * n * ldg);
    v = k + align128(e * n * ldg);
    s = v + align128(e * n * ldg);
    p = s + align128(sizeof(float) * n * lds);
    dp = p + (bf ? align128(sizeof(bf16) * n * ldp) : 0);
    dq = dp + align128(sizeof(float) * n * lds);
    dk = dq + align128(sizeof(float) * n * ldd);
    dv = dk + align128(sizeof(float) * n * ldd);
    scratch = dv + align128(sizeof(float) * n * ldd);
    size_t end1 = scratch + (bf ? sizeof(float) * 256 * (kThreads / 32) : 0);
    gstage = q;  // g is staged where the head-group arrays go later
    end1 = end1 > gstage + e * n * ldc ? end1 : gstage + e * n * ldc;
    dy = base;
    a2 = dy + align128(sizeof(float) * n * ldy);
    const size_t end2 = a2 + (bf ? sizeof(bf16) * n * (kc + 8) : 0);
    total = end1 > end2 ? end1 : end2;
  }
};

// Widest head group (a divisor of heads, at most 64 columns) whose layout
// fits the H100's 227 KB of shared memory per block; 0 if none does.
__host__ inline int pick_group(int n, int C, int heads, bool bf) {
  const int dh = C / heads;
  for (int hg = heads; hg >= 1; --hg)
    if (heads % hg == 0 && hg * dh <= 64 && BwdLayout(n, C, dh, hg * dh, bf).total <= 232448)
      return hg * dh;
  return 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) window_attention_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr bool bf = std::is_same_v<T, bf16>;
  using row = wmma::row_major;
  using col = wmma::col_major;
  const int C = a.C, ws = a.ws, n = ws * ws, heads = a.heads;
  const int dh = C / heads, gw = a.gw;
  const BwdLayout L(n, C, dh, gw, bf);
  float* sMu = (float*)(smem_raw + L.mu);
  float* sInv = (float*)(smem_raw + L.inv);
  T* sY = (T*)(smem_raw + L.y);
  T* sDo = (T*)(smem_raw + L.d_o);
  T* sG = (T*)(smem_raw + L.gstage);
  T* sQ = (T*)(smem_raw + L.q);
  T* sK = (T*)(smem_raw + L.k);
  T* sV = (T*)(smem_raw + L.v);
  float* sS = (float*)(smem_raw + L.s);
  float* sDp = (float*)(smem_raw + L.dp);
  // p and dlogits as product operands: rounded bf16 copies, or the f32
  // arrays themselves (rounding to f32 is the identity)
  T* sP = bf ? (T*)(smem_raw + L.p) : (T*)sS;
  T* sDl = bf ? (T*)(smem_raw + L.p) : (T*)sDp;
  const int ldpl = bf ? L.ldp : L.lds;  // leading dimension of sP / sDl
  float* sDq = (float*)(smem_raw + L.dq);
  float* sDk = (float*)(smem_raw + L.dk);
  float* sDv = (float*)(smem_raw + L.dv);
  float* scratch = (float*)(smem_raw + L.scratch);
  float* sDy = (float*)(smem_raw + L.dy);
  T* sA2 = (T*)(smem_raw + L.a2);
  const int ldc = L.ldc, ldg = L.ldg, lds = L.lds, ldd = L.ldd, ldy = L.ldy;

  const T* x = (const T*)a.x;
  const T* g = (const T*)a.g;
  T* ys = (T*)a.ys;
  T* os = (T*)a.os;
  T* dqs = (T*)a.dqs;
  T* dkvs = (T*)a.dkvs;
  const T* wq = (const T*)a.wq;
  const T* wkv = (const T*)a.wkv;
  const T* wproj = (const T*)a.wproj;
  const int nwh = a.H / ws, nww = a.W / ws;
  const int win = blockIdx.x % (nwh * nww);
  const int b = blockIdx.x / (nwh * nww);
  const int wr = win / nww, wc = win % nww;
  auto tok = [&](int t) -> size_t {  // token t's pixel index in the map
    const int r = wr * ws + t / ws, c = wc * ws + t % ws;
    return ((size_t)b * a.H + r) * a.W + c;
  };
  float* part = a.part + (size_t)blockIdx.x * (6 * C + heads * n * n);
  const float* mw = a.mask ? a.mask + (size_t)win * n * n : nullptr;
  const float scale = 1.0f / sqrtf((float)dh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // --- LN statistics and y = round(xhat * s + b); stage g ---
  for (int t = warp; t < n; t += kThreads / 32) {
    const T* xr = x + tok(t) * C;
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
    for (int c = lane; c < C; c += 32) {
      const T yv = from_f<T>((to_f(xr[c]) - mu) * inv * a.ln_s[c] + a.ln_b[c]);
      sY[t * ldc + c] = yv;
      ys[tok(t) * C + c] = yv;
      sG[t * ldc + c] = g[tok(t) * C + c];
    }
  }
  __syncthreads();
  // dbproj partial: the column sums of g
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float acc = 0.f;
    for (int t = 0; t < n; ++t) acc += to_f(sG[t * ldc + c]);
    part[5 * C + c] = acc;
  }
  // do = g Wproj^T: B(k = o, n = i) = wproj[o * C + i], row-major
  mm<T, row, row>(n, C, C, sG, ldc, wproj, C, scratch,
                  [&](int m, int i, float v) { sDo[m * ldc + i] = from_f<T>(v); });
  __syncthreads();

  for (int g0 = 0; g0 < C; g0 += gw) {
    // q, k, v of the head group: B(k = i, n = j) = w[(row0 + j) * C + i]
    mm<T, row, col>(n, gw, C, sY, ldc, wq + (size_t)g0 * C, C, scratch,
                    [&](int m, int j, float v) {
                      sQ[m * ldg + j] = from_f<T>((v + a.bq[g0 + j]) * scale);
                    });
    mm<T, row, col>(n, gw, C, sY, ldc, wkv + (size_t)g0 * C, C, scratch,
                    [&](int m, int j, float v) { sK[m * ldg + j] = from_f<T>(v + a.bkv[g0 + j]); });
    mm<T, row, col>(n, gw, C, sY, ldc, wkv + (size_t)(C + g0) * C, C, scratch,
                    [&](int m, int j, float v) {
                      sV[m * ldg + j] = from_f<T>(v + a.bkv[C + g0 + j]);
                    });
    __syncthreads();
    for (int hh = 0; hh < gw / dh; ++hh) {
      const int h = g0 / dh + hh;
      const float* bh = a.bias + (size_t)h * n * n;
      const T* qh = sQ + hh * dh;
      const T* kh = sK + hh * dh;
      const T* vh = sV + hh * dh;
      const T* doh = sDo + h * dh;
      // logits: B(d, s) = k[s][d], column-major
      mm<T, row, col>(n, n, dh, qh, ldg, kh, ldg, scratch, [&](int m, int s, float v) {
        sS[m * lds + s] = v + bh[m * n + s] + (mw ? mw[m * n + s] : 0.f);
      });
      __syncthreads();
      // p = e * (1 / sum e), f32 in sS; rounded copy in sP
      for (int m = warp; m < n; m += kThreads / 32) {
        float* r = sS + m * lds;
        float mx = __int_as_float(0xff800000);
        for (int s = lane; s < n; s += 32) mx = fmaxf(mx, r[s]);
        mx = warp_max(mx);
        float sum = 0.f;
        for (int s = lane; s < n; s += 32) {
          const float e = expf(r[s] - mx);
          r[s] = e;
          sum += e;
        }
        const float rinv = 1.0f / warp_sum(sum);
        __syncwarp();
        for (int s = lane; s < n; s += 32) {
          const float p = r[s] * rinv;
          r[s] = p;
          if constexpr (bf) sP[m * L.ldp + s] = from_f<T>(p);
        }
      }
      __syncthreads();
      // o = p v (written out rounded), dv = p^T do, dp = do v^T
      mm<T, row, row>(n, dh, n, sP, ldpl, vh, ldg, scratch, [&](int m, int d, float v) {
        os[tok(m) * C + h * dh + d] = from_f<T>(v);
      });
      mm<T, col, row>(n, dh, n, sP, ldpl, doh, ldc, scratch,
                      [&](int s, int d, float v) { sDv[s * ldd + d] = v; });
      mm<T, row, col>(n, n, dh, doh, ldc, vh, ldg, scratch,
                      [&](int m, int s, float v) { sDp[m * lds + s] = v; });
      __syncthreads();
      // dlogits = p (dp - sum(dp p)) in f32; rounded copy; bias partial
      float* pb = part + 6 * C + (size_t)h * n * n;
      for (int m = warp; m < n; m += kThreads / 32) {
        const float* pr = sS + m * lds;
        float* dr = sDp + m * lds;
        float acc = 0.f;
        for (int s = lane; s < n; s += 32) acc += dr[s] * pr[s];
        acc = warp_sum(acc);
        for (int s = lane; s < n; s += 32) {
          const float dl = pr[s] * (dr[s] - acc);
          dr[s] = dl;
          pb[m * n + s] = dl;
          if constexpr (bf) sDl[m * L.ldp + s] = from_f<T>(dl);
        }
      }
      __syncthreads();
      // dq = dlogits k (scaled), dk = dlogits^T q
      mm<T, row, row>(n, dh, n, sDl, ldpl, kh, ldg, scratch,
                      [&](int m, int d, float v) { sDq[m * ldd + d] = v * scale; });
      mm<T, col, row>(n, dh, n, sDl, ldpl, qh, ldg, scratch,
                      [&](int s, int d, float v) { sDk[s * ldd + d] = v; });
      __syncthreads();
      // f32 column sums (bq, bkv partials) and the rounded values out
      for (int j = threadIdx.x; j < 3 * dh; j += kThreads) {
        const float* src = j < dh ? sDq : (j < 2 * dh ? sDk : sDv);
        const int d = j % dh;
        float acc = 0.f;
        for (int t = 0; t < n; ++t) acc += src[t * ldd + d];
        part[(j < dh ? 2 * C : (j < 2 * dh ? 3 * C : 4 * C)) + h * dh + d] = acc;
      }
      for (int i = threadIdx.x; i < n * dh; i += kThreads) {
        const int t = i / dh, d = i % dh;
        const size_t p = tok(t);
        dqs[p * C + h * dh + d] = from_f<T>(sDq[t * ldd + d]);
        dkvs[p * 2 * C + h * dh + d] = from_f<T>(sDk[t * ldd + d]);
        dkvs[p * 2 * C + C + h * dh + d] = from_f<T>(sDv[t * ldd + d]);
      }
      __syncthreads();
    }
  }

  // --- pass 2: dy = dq Wq + dkv Wkv (f32), over pass 1's space ---
  for (int i = threadIdx.x; i < n * ldy; i += kThreads) sDy[i] = 0.f;
  __syncthreads();
  if constexpr (bf) {
    const int kc = L.kc, lda2 = kc + 8;
    for (int k0 = 0; k0 < 3 * C; k0 += kc) {
      for (int i = threadIdx.x; i < n * kc; i += kThreads) {
        const int t = i / kc, k = k0 + i % kc;
        sA2[t * lda2 + i % kc] = k < C ? dqs[tok(t) * C + k] : dkvs[tok(t) * 2 * C + k - C];
      }
      __syncthreads();
      // B(k, i) = W[k][i]: rows of Wq, then of Wkv, row-major
      const T* wrows = k0 < C ? wq + (size_t)k0 * C : wkv + (size_t)(k0 - C) * C;
      gemm_tc_acc<row>(n, C, kc, sA2, lda2, wrows, C, sDy, ldy);
      __syncthreads();
    }
  } else {
    gemm_f32(n, C, C, [&](int m) { return (const float*)dqs + tok(m) * C; }, 1, wq, 1, C,
             [&](int m, int i, float v) { sDy[m * ldy + i] += v; });
    __syncthreads();
    gemm_f32(n, C, 2 * C, [&](int m) { return (const float*)dkvs + tok(m) * 2 * C; }, 1,
             wkv, 1, C, [&](int m, int i, float v) { sDy[m * ldy + i] += v; });
    __syncthreads();
  }

  // --- LayerNorm backward; ln scale/bias partials ---
  T* dx = (T*)a.dx;
  for (int t = warp; t < n; t += kThreads / 32) {
    const size_t p = tok(t) * C;
    const float mu = sMu[t], inv = sInv[t];
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dxh = sDy[t * ldy + c] * a.ln_s[c];
      m1 += dxh;
      m2 += dxh * ((to_f(x[p + c]) - mu) * inv);
    }
    m1 = warp_sum(m1) / C;
    m2 = warp_sum(m2) / C;
    for (int c = lane; c < C; c += 32) {
      const float xhat = (to_f(x[p + c]) - mu) * inv;
      const float dxh = sDy[t * ldy + c] * a.ln_s[c];
      float v = round_to<T>(inv * (dxh - m1 - xhat * m2));
      if (a.residual) v += to_f(g[p + c]);
      dx[p + c] = from_f<T>(v);
    }
  }
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s1 = 0.f, s2 = 0.f;
    for (int t = 0; t < n; ++t) {
      const float dy = sDy[t * ldy + c];
      s1 += dy * ((to_f(x[tok(t) * C + c]) - sMu[t]) * sInv[t]);
      s2 += dy;
    }
    part[c] = s1;
    part[C + c] = s2;
  }
}

}  // namespace
}  // namespace fbanet

extern "C" {

// Head-group width the kernel uses, or 0 for a shape it does not take (the
// bf16 kernel tiles by 16: tokens, C and head size; no group may fit).
int fbanet_window_attention_bwd_group(int n, int C, int heads, int bf16) {
  if (C % heads) return 0;
  if (bf16 && (n % 16 || C % 16 || (C / heads) % 16)) return 0;
  return fbanet::pick_group(n, C, heads, bf16 != 0);
}

int fbanet_window_attention_bwd(const void* x, const void* g, void* dx, void* ys, void* os,
                                void* dqs, void* dkvs, void* part, const void* ln_s,
                                const void* ln_b, const void* wq, const void* bq,
                                const void* wkv, const void* bkv, const void* wproj,
                                const void* bias, const void* mask, int B, int H, int W,
                                int C, int heads, int ws, int residual, int bf16,
                                void* stream) {
  const int n = ws * ws;
  const int gw = fbanet_window_attention_bwd_group(n, C, heads, bf16);
  if (gw == 0) return (int)cudaErrorInvalidValue;
  fbanet::BwdArgs a{x, g, dx, ys, os, dqs, dkvs, (float*)part,
                    (const float*)ln_s, (const float*)ln_b, wq, wkv, wproj,
                    (const float*)bq, (const float*)bkv, (const float*)bias,
                    (const float*)mask, H, W, C, heads, ws, residual, gw};
  const int smem = (int)fbanet::BwdLayout(n, C, C / heads, gw, bf16 != 0).total;
  auto kern = bf16 ? fbanet::window_attention_bwd_kernel<fbanet::bf16>
                   : fbanet::window_attention_bwd_kernel<float>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)B * (H / ws) * (W / ws);
  kern<<<grid, fbanet::kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
