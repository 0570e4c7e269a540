// K3's first kernel (and K11): the backward of K1 (fused norm1 + window
// attention) on a post-roll [B, H, W, C] map: dx, plus what the parameter
// gradients need. Entries: attention_bwd.cu (K3), attention_bwd_ablation.cu
// (K11). K3's bf16 form for Hopper (wgmma, TMA, several windows per block)
// is attention_bwd_wgmma.cuh; ops/attention.py::_attention_bwd_plan keeps
// this kernel for f32 and for the shapes that form does not take, and K11
// runs its flags here at those shapes.
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
// run on the tensor cores (WMMA 16x16x16, f32 accumulation; a head of 8
// channels, as FBANet-32's bottleneck, dec0 and dec1 have, sits zero-padded
// to 16 columns in the q, k, v and do tiles, so dp = do v^T adds zeros and
// dq, dk, dv, o compute 8 columns more that are dropped); f32 ones on the
// CUDA cores.
//
// fbanet_window_attention_bwd_windows is the same kernel on pre-partitioned
// windows [G, N, C] (K1b's backward; the TPU's _attention_bwd_kernel works on
// windows too): window g reads rows g * N .. g * N + N - 1, its mask is
// mask[g % windows per image], and there is no residual. Its per-token
// scratch is in window order.
//
// K11 is this kernel on windows with one stage removed at compile time
// (kSkip), the counterpart of the ablation copy
// scripts/measure_bwd.py::_abl_bwd_kernel (mask-free, bf16): norecompute
// (no LN statistics and no q/k/v products: inv = 1, xhat = x, y = q = k = v
// = x), nodsoftmax (dlogits = dp / n), nocore (no per-head stage: o = dq =
// dk = dv = do, the bias gradient 0), nodx (no dy product and no LN
// backward: dx = x, and dy = x for the LN gradients), nowgrads (no o = p v
// product, which only dWproj reads, no per-token scratch for the weight
// gradients and no partial sums; the wrapper skips the sums and returns
// zeros). Its `full` variant is this kernel's own windowed instantiation.
// The changed math is deliberate: the variants exist to split K3's time by
// stage.
#pragma once

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
  WinGeom geom;
  int heads, residual, gw;
};

// Shared-memory layout (byte offsets) for n tokens, width C, head size dh,
// head-group width gw. In bf16 each head of q, k, v and do takes
// head_pitch(dh) columns (a head of 8 zero-padded to 16, common.cuh); `hp`
// is that pitch (dh in f32). Element strides: bf16 arrays C + 8 / padded
// widths + 8 / n + 8 (WMMA wants multiples of 8), f32 arrays odd (no bank
// conflicts). Pass 2 (dy and its operand staging) reuses pass 1's space
// after the statistics. K11's nocore keeps the f32 do [n][C] after pass 1's
// space (do32).
struct BwdLayout {
  int hp, ldc, ldo, ldg, ldp, lds, ldd, ldy, kc;
  size_t mu, inv, y, d_o, q, k, v, s, p, dp, dq, dk, dv, scratch, gstage, dy, a2, do32, total;
  __host__ __device__ BwdLayout(int n, int C, int dh, int gw, bool bf, bool nocore = false) {
    const size_t e = bf ? 2 : 4;
    hp = bf ? head_pitch(dh) : dh;
    ldc = bf ? C + 8 : C + 1;
    ldo = bf ? C / dh * hp + 8 : C + 1;
    ldg = bf ? gw / dh * hp + 8 : gw + 1;
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
    q = d_o + align128(e * n * ldo);
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
    do32 = align128(end1);
    if (nocore) end1 = do32 + sizeof(float) * n * C;
    total = end1 > end2 ? end1 : end2;
  }
};

// Widest head group (a divisor of heads, at most 64 columns; in bf16
// padded, and whole 16-wide tiles of the projections) whose layout fits the
// H100's 227 KB of shared memory per block; 0 if none does.
__host__ inline int pick_group(int n, int C, int heads, bool bf, int skip) {
  const int dh = C / heads;
  for (int hg = heads; hg >= 1; --hg)
    if (heads % hg == 0 && hg * (bf ? head_pitch(dh) : dh) <= 64 &&
        (!bf || hg * dh % 16 == 0) &&
        BwdLayout(n, C, dh, hg * dh, bf, skip & kNoCore).total <= 232448)
      return hg * dh;
  return 0;
}

// kPad: bf16 heads whose size is not a multiple of 16, padded (head_pitch);
// the other instantiations keep each head at its own width. Two blocks an
// SM (128 registers): with the thread count alone ptxas gave the others
// 128 but the padded one 176, one block an SM, and FBANet-32's dec1 (C =
// 64, little shared memory) ran 55 % slower; with one block an SM asked
// for, it gave every instantiation 154-168 (PERF.md §6).
template <typename T, int kSkip, bool kPad = false>
__global__ void __launch_bounds__(kThreads, 2) window_attention_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr bool bf = std::is_same_v<T, bf16>;
  constexpr bool recompute = !(kSkip & kNoRecompute), dsoftmax = !(kSkip & kNoDsoftmax);
  constexpr bool wgrads = !(kSkip & kNoWgrads), dxchain = !(kSkip & kNoDx);
  constexpr bool core = !(kSkip & kNoCore);
  using row = wmma::row_major;
  using col = wmma::col_major;
  const int C = a.geom.C, n = a.geom.n, heads = a.heads;
  const int dh = C / heads, gw = a.gw;
  const BwdLayout L(n, C, dh, gw, bf, !core);
  const int hp = kPad ? L.hp : dh, ldo = kPad ? L.ldo : L.ldc;
  // channel j of q, k, v, do (of a head group or of all heads) -> its
  // column in the padded tiles
  auto padded = [&](int j) { return kPad ? j + (j / dh) * (hp - dh) : j; };
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
  const WinBlock wb(a.geom);
  auto tok = [&](int t) -> size_t { return wb.pix(t); };  // token t's pixel index
  float* part = a.part + (size_t)blockIdx.x * (6 * C + heads * n * n);
  const float* mw = a.mask ? a.mask + (size_t)wb.win * n * n : nullptr;
  const float scale = 1.0f / sqrtf((float)dh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // --- LN statistics and y = round(xhat * s + b); stage g ---
  for (int t = warp; t < n; t += kThreads / 32) {
    const T* xr = x + tok(t) * C;
    float mu = 0.f, inv = 1.f;  // norecompute: xhat = x
    if constexpr (recompute) {
      float sum = 0.f, sq = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float v = to_f(xr[c]);
        sum += v;
        sq += v * v;
      }
      sum = warp_sum(sum);
      sq = warp_sum(sq);
      mu = sum / C;
      inv = rsqrtf(fmaxf(0.f, sq / C - mu * mu) + kLnEps);
    }
    if (lane == 0) {
      sMu[t] = mu;
      sInv[t] = inv;
    }
    for (int c = lane; c < C; c += 32) {
      const T yv = recompute ? from_f<T>((to_f(xr[c]) - mu) * inv * a.ln_s[c] + a.ln_b[c])
                             : xr[c];
      sY[t * ldc + c] = yv;
      if constexpr (wgrads) ys[tok(t) * C + c] = yv;
      sG[t * ldc + c] = g[tok(t) * C + c];
    }
    if constexpr (kPad)  // do's padding columns stay zero: no epilogue writes them
      for (int c = lane; c < ldo; c += 32) sDo[t * ldo + c] = from_f<T>(0.f);
  }
  __syncthreads();
  // dbproj partial: the column sums of g
  if constexpr (wgrads)
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float acc = 0.f;
      for (int t = 0; t < n; ++t) acc += to_f(sG[t * ldc + c]);
      part[5 * C + c] = acc;
    }
  // do = g Wproj^T: B(k = o, n = i) = wproj[o * C + i], row-major
  float* sDo32 = (float*)(smem_raw + L.do32);
  mm<T, row, row>(n, C, C, sG, ldc, wproj, C, scratch, [&](int m, int i, float v) {
    sDo[m * ldo + padded(i)] = from_f<T>(v);
    if constexpr (!core) sDo32[m * C + i] = v;
  });
  __syncthreads();
  if constexpr (kPad && core) {  // q, k, v's padding columns, where g was staged
    for (int i = threadIdx.x; i < n * ldg; i += kThreads) {
      const T zero = from_f<T>(0.f);
      sQ[i] = zero;
      sK[i] = zero;
      sV[i] = zero;
    }
    __syncthreads();
  }

  if constexpr (!core) {
    // K11 nocore: o = round(do), dq = dk = dv = do (f32; no scale), so the
    // bq / bkv partials are the column sums of the f32 do and the bias
    // gradient is 0
    if constexpr (wgrads) {
      for (int c = threadIdx.x; c < C; c += kThreads) {
        float acc = 0.f;
        for (int t = 0; t < n; ++t) acc += sDo32[t * C + c];
        part[2 * C + c] = acc;
        part[3 * C + c] = acc;
        part[4 * C + c] = acc;
      }
      for (int i = threadIdx.x; i < heads * n * n; i += kThreads) part[6 * C + i] = 0.f;
    }
    for (int i = threadIdx.x; i < n * C; i += kThreads) {
      const int t = i / C, c = i % C;
      const size_t p = tok(t);
      const T v = sDo[t * ldo + padded(c)];
      if constexpr (wgrads) os[p * C + c] = v;
      dqs[p * C + c] = v;
      dkvs[p * 2 * C + c] = v;
      dkvs[p * 2 * C + C + c] = v;
    }
    __syncthreads();
  }

  for (int g0 = 0; g0 < (core ? C : 0); g0 += gw) {
    if constexpr (recompute) {
      // q, k, v of the head group: B(k = i, n = j) = w[(row0 + j) * C + i]
      mm<T, row, col>(n, gw, C, sY, ldc, wq + (size_t)g0 * C, C, scratch,
                      [&](int m, int j, float v) {
                        sQ[m * ldg + padded(j)] = from_f<T>((v + a.bq[g0 + j]) * scale);
                      });
      mm<T, row, col>(n, gw, C, sY, ldc, wkv + (size_t)g0 * C, C, scratch,
                      [&](int m, int j, float v) {
                        sK[m * ldg + padded(j)] = from_f<T>(v + a.bkv[g0 + j]);
                      });
      mm<T, row, col>(n, gw, C, sY, ldc, wkv + (size_t)(C + g0) * C, C, scratch,
                      [&](int m, int j, float v) {
                        sV[m * ldg + padded(j)] = from_f<T>(v + a.bkv[C + g0 + j]);
                      });
    } else {
      // K11 norecompute: q = k = v = x (unscaled)
      for (int i = threadIdx.x; i < n * gw; i += kThreads) {
        const int m = i / gw, j = i % gw, jp = m * ldg + padded(j);
        sQ[jp] = sK[jp] = sV[jp] = sY[m * ldc + g0 + j];
      }
    }
    __syncthreads();
    for (int hh = 0; hh < gw / dh; ++hh) {
      const int h = g0 / dh + hh;
      const float* bh = a.bias + (size_t)h * n * n;
      // the head's tiles, hp columns each (bf16: a head of 8 padded with
      // zero columns, whose products add zeros or are dropped)
      const T* qh = sQ + hh * hp;
      const T* kh = sK + hh * hp;
      const T* vh = sV + hh * hp;
      const T* doh = sDo + h * hp;
      // logits: B(d, s) = k[s][d], column-major
      mm<T, row, col>(n, n, hp, qh, ldg, kh, ldg, scratch, [&](int m, int s, float v) {
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
      // o = p v (written out rounded; only dWproj reads it), dv = p^T do,
      // dp = do v^T
      if constexpr (wgrads)
        mm<T, row, row>(n, hp, n, sP, ldpl, vh, ldg, scratch, [&](int m, int d, float v) {
          if (!kPad || d < dh) os[tok(m) * C + h * dh + d] = from_f<T>(v);
        });
      mm<T, col, row>(n, hp, n, sP, ldpl, doh, ldo, scratch, [&](int s, int d, float v) {
        if (!kPad || d < dh) sDv[s * ldd + d] = v;
      });
      mm<T, row, col>(n, n, hp, doh, ldo, vh, ldg, scratch,
                      [&](int m, int s, float v) { sDp[m * lds + s] = v; });
      __syncthreads();
      // dlogits = p (dp - sum(dp p)) in f32; rounded copy; bias partial
      float* pb = part + 6 * C + (size_t)h * n * n;
      for (int m = warp; m < n; m += kThreads / 32) {
        const float* pr = sS + m * lds;
        float* dr = sDp + m * lds;
        float acc = 0.f;
        if constexpr (dsoftmax) {
          for (int s = lane; s < n; s += 32) acc += dr[s] * pr[s];
          acc = warp_sum(acc);
        }
        for (int s = lane; s < n; s += 32) {
          // K11 nodsoftmax: dlogits = dp / n
          const float dl = dsoftmax ? pr[s] * (dr[s] - acc) : dr[s] * (1.0f / n);
          dr[s] = dl;
          if constexpr (wgrads) pb[m * n + s] = dl;
          if constexpr (bf) sDl[m * L.ldp + s] = from_f<T>(dl);
        }
      }
      __syncthreads();
      // dq = dlogits k (scaled), dk = dlogits^T q
      mm<T, row, row>(n, hp, n, sDl, ldpl, kh, ldg, scratch, [&](int m, int d, float v) {
        if (!kPad || d < dh) sDq[m * ldd + d] = v * scale;
      });
      mm<T, col, row>(n, hp, n, sDl, ldpl, qh, ldg, scratch, [&](int s, int d, float v) {
        if (!kPad || d < dh) sDk[s * ldd + d] = v;
      });
      __syncthreads();
      // f32 column sums (bq, bkv partials) and the rounded values out
      if constexpr (wgrads)
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

  T* dx = (T*)a.dx;
  if constexpr (!dxchain) {
    // K11 nodx: dx = x, and dy = x for the LN gradients
    for (int i = threadIdx.x; i < n * C; i += kThreads) {
      const size_t p = tok(i / C) * C + i % C;
      dx[p] = x[p];
    }
    if constexpr (wgrads)
      for (int c = threadIdx.x; c < C; c += kThreads) {
        float s1 = 0.f, s2 = 0.f;
        for (int t = 0; t < n; ++t) {
          const float dy = to_f(x[tok(t) * C + c]);
          s1 += dy * ((dy - sMu[t]) * sInv[t]);
          s2 += dy;
        }
        part[c] = s1;
        part[C + c] = s2;
      }
    return;
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
  if constexpr (wgrads)
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

using BwdKernel = void (*)(BwdArgs);

// Launch one instantiation (its dynamic shared memory set first); returns
// cudaGetLastError().
inline int launch_bwd(BwdKernel kern, const BwdArgs& a, unsigned grid, bool bf, bool nocore,
                      void* stream) {
  const int smem =
      (int)BwdLayout(a.geom.n, a.geom.C, a.geom.C / a.heads, a.gw, bf, nocore).total;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fbanet
