// K7: K1's function (fused norm1 -> Q/KV projections -> per-head
// softmax(q k^T * dh^-1/2 + relative-position bias) V -> output projection),
// mask-free and with no residual, on a bf16 [B, H, W, C] map, with the
// per-head stage chosen at compile time. The counterpart of the TPU kernel
// scripts/measure_swin_variants.py::_var_kernel (launched by
// variant_attention), which times rewrites of K1's head stage. These are
// the cores on K1's first kernel, for the shapes K1's plan keeps there
// (the tools' `-base` lines); on K1's wgmma form they are
// attention_variants_wgmma.cu's.
//
// Rounding points are K1's (attention.cu:1-11): LN in f32 rounded to bf16;
// q, k, v from f32-accumulated products plus f32 bias (q scaled in f32)
// rounded; f32 logits + bias; the output projection accumulated in f32 plus
// f32 bias. The LN, the q/k/v epilogues, the softmax and the tensor-core
// products are K1's own (attention_fwd.cuh, common.cuh). The cores:
//
// - loop: one head at a time, as K1; the softmax normalised before AV
//   (p = e / sum rounded to bf16, no division after AV): the script's
//   `_core_loop` without late_norm.
// - loop_ln: K1's own order, dividing by the row sum after AV. Bitwise K1
//   (fused_window_attention_2d, no mask, no residual).
// - stack3d / stack3d_ln: the heads of a chunk go through each stage
//   together: the logits of every head of the chunk (the warps split across
//   heads x 16 x 16 tiles), one barrier, one softmax pass over chunk * n
//   rows, one barrier, the AV of every head. The chunk is the largest
//   divisor of K1's head group (<= 64 columns) whose f32 logits
//   [chunk][n][n+1] and bf16 probabilities [chunk][n][n+8] fit in shared
//   memory beside the rest (the script's `_stack_chunk` bounds the TPU's
//   VMEM the same way).
// - lanepack: heads in pairs, late-normalised (`_core_lanepack`). The pair's
//   logits [n, 2n] come from one product with the block-diagonal key stack
//   [[k_a, 0], [0, k_b]]: its off-diagonal 16 x 16 tiles are loaded from a
//   zero tile, so the tensor cores do twice the core's products, as on the
//   TPU. Max and sum over each n-wide half of a 2n-wide row (one warp per
//   row), the division after AV by the block-diagonal [[v_a, 0], [0, v_b]].
//   The bias arrives packed [heads / 2][n][2n] (pack_bias_pairs). Even head
//   counts only; the head group holds at least one pair (2 heads of 64 at
//   C = 128).
// - qkv1 (with stack3d_ln): q, k and v of the head group from one pass over
//   the [3 gw, C] panel of wq and wkv rows, instead of three products.
// - nr (runtime): windows per block, a loop around the block body. K1 runs
//   one. The TPU kernel's nr is rows of windows per grid step, picked by
//   its VMEM budget; a block here has no such budget to fill, so only the
//   script's explicit nr = 2 (ln+nr2) has a counterpart.
//
// What bounds it on the H100: arithmetic, as K1. The variants exist to
// measure which head stage wastes least of it; the stacked cores trade
// K1's per-head barriers (three per head) for three per chunk.
#include "attention_fwd.cuh"

namespace fbanet {
namespace {

enum Core { kLoop = 0, kLoopLn = 1, kStack = 2, kStackLn = 3, kLanepack = 4 };

struct VarArgs {
  const bf16* x;
  bf16* out;
  const float *ln_s, *ln_b;
  const bf16 *wq, *wkv, *wproj;  // torch Linear layout
  const float *bq, *bkv, *bproj;
  const float* bias;  // [heads][n][n]; lanepack: [heads / 2][n][2n]
  int H, W, C, heads, ws;
  int nr;     // windows per block
  int gw;     // columns of a head group
  int chunk;  // heads per stacked stage (1 for loop)
};

// Head group of a core: K1's, or for lanepack the smallest even one when
// K1's holds an odd number of heads.
__host__ __device__ inline int variant_group(int C, int heads, int core) {
  const int dh = C / heads;
  int hg = head_group(heads, dh);
  if (core == kLanepack && hg % 2) hg = 2;
  return hg * dh;
}

// Byte offsets of the shared-memory arrays: K1's Bf16Layout with `mats`
// logits / probability matrices of `cols` columns (n, or 2n for lanepack)
// and a 16 x 16 bf16 zero tile.
struct VarLayout {
  size_t y, o, q, k, v, p, s, inv, zero, scratch, total;
  __host__ __device__ VarLayout(int n, int C, int gw, int mats, int cols) {
    y = 0;
    o = y + align128(sizeof(bf16) * n * (C + 8));
    q = o + align128(sizeof(bf16) * n * (C + 8));
    k = q + align128(sizeof(bf16) * n * (gw + 8));
    v = k + align128(sizeof(bf16) * n * (gw + 8));
    p = v + align128(sizeof(bf16) * n * (gw + 8));
    s = p + align128(sizeof(bf16) * mats * n * (cols + 8));
    inv = s + align128(sizeof(float) * mats * n * (cols + 1));
    zero = inv + align128(sizeof(float) * mats * n * (cols / n));
    scratch = zero + align128(sizeof(bf16) * 256);
    total = scratch + sizeof(float) * 256 * (kThreads / 32);
  }
};

__host__ __device__ inline VarLayout variant_layout(int n, int C, int gw, int chunk,
                                                    int core) {
  return core == kLanepack ? VarLayout(n, C, gw, chunk / 2, 2 * n)
                           : VarLayout(n, C, gw, chunk, n);
}

struct Tile16 {
  const bf16* p;
  int ld;
};

// gemm_tc over `count` products at once: for each 16 x 16 output tile of
// product i < count, one warp accumulates in f32, over k in steps of 16, the
// A tile at(i, m0, k0) times the B tile bt(i, k0, n0) (each a pointer and
// its leading dimension, in the layouts AL and BL), then calls epi(i, m, n,
// value). The same tile order and sums as gemm_tc, so a product computed
// here equals the one gemm_tc gives bit for bit.
template <typename BL, typename AL, typename ATile, typename BTile, typename Epi>
__device__ __forceinline__ void gemm_tc_tiles(int count, int M, int N, int K, ATile at,
                                              BTile bt, float* scratch, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tn = N / 16, per = (M / 16) * tn;
  float* slot = scratch + warp * 256;
  for (int tile = warp; tile < count * per; tile += blockDim.x >> 5) {
    const int i = tile / per, r = tile % per;
    const int m0 = (r / tn) * 16, n0 = (r % tn) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, AL> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BL> b;
      const Tile16 ta = at(i, m0, k0), tb = bt(i, k0, n0);
      wmma::load_matrix_sync(a, ta.p, ta.ld);
      wmma::load_matrix_sync(b, tb.p, tb.ld);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(slot, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int j = lane; j < 256; j += 32) epi(i, m0 + j / 16, n0 + j % 16, slot[j]);
    __syncwarp();
  }
}

// The script's jax.nn.softmax before AV: p = e / sum, rounded to bf16.
__device__ __forceinline__ void softmax_rows_normed(int rows, int n, float* sS, int lds,
                                                    bf16* sP, int ldp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int m = warp; m < rows; m += kThreads / 32) {
    float* row = sS + m * lds;
    float mx = __int_as_float(0xff800000);  // -inf
    for (int s = lane; s < n; s += 32) mx = fmaxf(mx, row[s]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int s = lane; s < n; s += 32) {
      const float e = expf(row[s] - mx);
      sum += e;
      row[s] = e;
    }
    sum = warp_sum(sum);
    for (int s = lane; s < n; s += 32) sP[m * ldp + s] = __float2bfloat16(row[s] / sum);
  }
}

// lanepack's softmax: each row of 2n logits is two heads' rows side by side;
// max and sum per n-wide half. e rounded to bf16 into p, 1 / sum of each
// half into inv[2 m] and inv[2 m + 1].
__device__ __forceinline__ void softmax_pair_rows(int rows, int n, const float* sS, int lds,
                                                  bf16* sP, int ldp, float* sInv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int m = warp; m < rows; m += kThreads / 32) {
    const float* row = sS + m * lds;
    float ma = __int_as_float(0xff800000), mb = ma;
    for (int s = lane; s < n; s += 32) {
      ma = fmaxf(ma, row[s]);
      mb = fmaxf(mb, row[n + s]);
    }
    ma = warp_max(ma);
    mb = warp_max(mb);
    float sa = 0.f, sb = 0.f;
    for (int s = lane; s < n; s += 32) {
      const float ea = expf(row[s] - ma), eb = expf(row[n + s] - mb);
      sa += ea;
      sb += eb;
      sP[m * ldp + s] = __float2bfloat16(ea);
      sP[m * ldp + n + s] = __float2bfloat16(eb);
    }
    sa = warp_sum(sa);
    sb = warp_sum(sb);
    if (lane == 0) {
      sInv[2 * m] = 1.0f / sa;
      sInv[2 * m + 1] = 1.0f / sb;
    }
  }
}

template <int kCore, bool kQkv1>
__global__ void __launch_bounds__(kThreads) attention_variant_kernel(VarArgs a) {
  constexpr bool kLate = kCore != kLoop && kCore != kStack;
  constexpr bool kPerHead = kCore == kLoop || kCore == kLoopLn;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int C = a.C, ws = a.ws, n = ws * ws, gw = a.gw, chunk = a.chunk;
  const int dh = C / a.heads;
  const int ldc = C + 8, ldg = gw + 8;
  const int cols = kCore == kLanepack ? 2 * n : n;
  const int ldp = cols + 8, lds = cols + 1;
  const VarLayout L = variant_layout(n, C, gw, chunk, kCore);
  bf16* sY = (bf16*)(smem_raw + L.y);
  bf16* sO = (bf16*)(smem_raw + L.o);
  bf16* sQ = (bf16*)(smem_raw + L.q);
  bf16* sK = (bf16*)(smem_raw + L.k);
  bf16* sV = (bf16*)(smem_raw + L.v);
  bf16* sP = (bf16*)(smem_raw + L.p);
  float* sS = (float*)(smem_raw + L.s);
  float* sInv = (float*)(smem_raw + L.inv);
  bf16* sZero = (bf16*)(smem_raw + L.zero);
  float* scratch = (float*)(smem_raw + L.scratch);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (kCore == kLanepack)
    for (int i = threadIdx.x; i < 256; i += kThreads) sZero[i] = __float2bfloat16(0.f);

  const int nww = a.W / ws, nw = (a.H / ws) * nww;
  const float scale = 1.0f / sqrtf((float)dh);
  using col = wmma::col_major;
  using row = wmma::row_major;

  for (int r = 0; r < a.nr; ++r) {
    // window g of the map, in window-partition order (common.cuh's WinBlock)
    const int g = blockIdx.x * a.nr + r, win = g % nw;
    const size_t base = ((size_t)(g / nw) * a.H + (win / nww) * ws) * a.W + (win % nww) * ws;
    auto tok = [&](int t) -> size_t { return (base + (size_t)(t / ws) * a.W + t % ws) * C; };
    for (int t = warp; t < n; t += kThreads / 32)
      layernorm_row<bf16>(a.x + tok(t), C, a.ln_s, a.ln_b, sY + t * ldc, lane);
    __syncthreads();

    for (int g0 = 0; g0 < C; g0 += gw) {
      if constexpr (kQkv1) {
        // rows j of the [3 gw, C] panel: wq, then the k and v rows of wkv
        auto panel = [&](int j) -> const bf16* {
          if (j < gw) return a.wq + (size_t)(g0 + j) * C;
          if (j < 2 * gw) return a.wkv + (size_t)(g0 + j - gw) * C;
          return a.wkv + (size_t)(C + g0 + j - 2 * gw) * C;
        };
        gemm_tc_tiles<col, row>(
            1, n, 3 * gw, C,
            [&](int, int m0, int k0) { return Tile16{sY + m0 * ldc + k0, ldc}; },
            [&](int, int k0, int n0) { return Tile16{panel(n0) + k0, C}; }, scratch,
            [&](int, int m, int j, float v) {
              if (j < gw)
                sQ[m * ldg + j] = __float2bfloat16((v + a.bq[g0 + j]) * scale);
              else if (j < 2 * gw)
                sK[m * ldg + j - gw] = __float2bfloat16(v + a.bkv[g0 + j - gw]);
              else
                sV[m * ldg + j - 2 * gw] = __float2bfloat16(v + a.bkv[C + g0 + j - 2 * gw]);
            });
      } else {
        gemm_tc<col>(n, n, gw, C, sY, ldc, a.wq + (size_t)g0 * C, C, scratch,
                     [&](int m, int j, float v) {
                       sQ[m * ldg + j] = __float2bfloat16((v + a.bq[g0 + j]) * scale);
                     });
        gemm_tc<col>(n, n, gw, C, sY, ldc, a.wkv + (size_t)g0 * C, C, scratch,
                     [&](int m, int j, float v) {
                       sK[m * ldg + j] = __float2bfloat16(v + a.bkv[g0 + j]);
                     });
        gemm_tc<col>(n, n, gw, C, sY, ldc, a.wkv + (size_t)(C + g0) * C, C, scratch,
                     [&](int m, int j, float v) {
                       sV[m * ldg + j] = __float2bfloat16(v + a.bkv[C + g0 + j]);
                     });
      }
      __syncthreads();

      if constexpr (kPerHead) {
        // K1's head loop (attention.cu), three barriers per head
        for (int hh = 0; hh < gw / dh; ++hh) {
          const int h = g0 / dh + hh;
          const float* bh = a.bias + (size_t)h * n * n;
          gemm_tc<col>(n, n, n, dh, sQ + hh * dh, ldg, sK + hh * dh, ldg, scratch,
                       [&](int m, int s, float v) { sS[m * lds + s] = v + bh[m * n + s]; });
          __syncthreads();
          if constexpr (kLate)
            softmax_rows(n, sS, lds, sP, ldp, sInv);
          else
            softmax_rows_normed(n, n, sS, lds, sP, ldp);
          __syncthreads();
          gemm_tc<row>(n, n, dh, n, sP, ldp, sV + hh * dh, ldg, scratch,
                       [&](int m, int d, float v) {
                         sO[m * ldc + h * dh + d] = __float2bfloat16(kLate ? v * sInv[m] : v);
                       });
          __syncthreads();
        }
      } else if constexpr (kCore == kLanepack) {
        // pairs (h0 + 2p, h0 + 2p + 1) of the chunk; the pair's q/k/v
        // columns cq .. cq + 2 dh are adjacent in the group's tiles
        for (int c0 = 0; c0 < gw / dh; c0 += chunk) {
          const int h0 = g0 / dh + c0, pairs = chunk / 2;
          auto cq = [&](int p) { return (c0 + 2 * p) * dh; };
          // logits [n, 2n] = [q_a | q_b] . [[k_a, 0], [0, k_b]]^T
          gemm_tc_tiles<col, row>(
              pairs, n, 2 * n, 2 * dh,
              [&](int p, int m0, int k0) { return Tile16{sQ + m0 * ldg + cq(p) + k0, ldg}; },
              [&](int p, int k0, int n0) {
                return (n0 < n) == (k0 < dh) ? Tile16{sK + (n0 % n) * ldg + cq(p) + k0, ldg}
                                             : Tile16{sZero, 16};
              },
              scratch,
              [&](int p, int m, int s, float v) {
                sS[(p * n + m) * lds + s] =
                    v + a.bias[((size_t)(h0 / 2 + p) * n + m) * 2 * n + s];
              });
          __syncthreads();
          softmax_pair_rows(pairs * n, n, sS, lds, sP, ldp, sInv);
          __syncthreads();
          // o [n, 2 dh] = e . [[v_a, 0], [0, v_b]], each half / its sum
          gemm_tc_tiles<row, row>(
              pairs, n, 2 * dh, 2 * n,
              [&](int p, int m0, int k0) { return Tile16{sP + (p * n + m0) * ldp + k0, ldp}; },
              [&](int p, int k0, int n0) {
                return (k0 < n) == (n0 < dh) ? Tile16{sV + (k0 % n) * ldg + cq(p) + n0, ldg}
                                             : Tile16{sZero, 16};
              },
              scratch,
              [&](int p, int m, int d, float v) {
                const int rr = p * n + m;
                sO[m * ldc + (h0 + 2 * p) * dh + d] =
                    __float2bfloat16(v * sInv[2 * rr + (d < dh ? 0 : 1)]);
              });
          __syncthreads();
        }
      } else {
        // stack3d: the chunk's heads through each stage together
        for (int c0 = 0; c0 < gw / dh; c0 += chunk) {
          const int h0 = g0 / dh + c0;
          gemm_tc_tiles<col, row>(
              chunk, n, n, dh,
              [&](int i, int m0, int k0) {
                return Tile16{sQ + m0 * ldg + (c0 + i) * dh + k0, ldg};
              },
              [&](int i, int k0, int n0) {
                return Tile16{sK + n0 * ldg + (c0 + i) * dh + k0, ldg};
              },
              scratch,
              [&](int i, int m, int s, float v) {
                sS[(i * n + m) * lds + s] = v + a.bias[((size_t)(h0 + i) * n + m) * n + s];
              });
          __syncthreads();
          if constexpr (kLate)
            softmax_rows(chunk * n, n, sS, lds, sP, ldp, sInv);
          else
            softmax_rows_normed(chunk * n, n, sS, lds, sP, ldp);
          __syncthreads();
          gemm_tc_tiles<row, row>(
              chunk, n, dh, n,
              [&](int i, int m0, int k0) { return Tile16{sP + (i * n + m0) * ldp + k0, ldp}; },
              [&](int i, int k0, int n0) {
                return Tile16{sV + k0 * ldg + (c0 + i) * dh + n0, ldg};
              },
              scratch,
              [&](int i, int m, int d, float v) {
                sO[m * ldc + (h0 + i) * dh + d] =
                    __float2bfloat16(kLate ? v * sInv[i * n + m] : v);
              });
          __syncthreads();
        }
      }
    }

    gemm_tc<col>(n, n, C, C, sO, ldc, a.wproj, C, scratch, [&](int m, int o, float v) {
      a.out[tok(m) + o] = __float2bfloat16(v + a.bproj[o]);
    });
  }
}

using Kernel = void (*)(VarArgs);

Kernel variant_kernel(int core, int qkv1) {
  if (qkv1) return core == kStackLn ? attention_variant_kernel<kStackLn, true> : nullptr;
  switch (core) {
    case kLoop: return attention_variant_kernel<kLoop, false>;
    case kLoopLn: return attention_variant_kernel<kLoopLn, false>;
    case kStack: return attention_variant_kernel<kStack, false>;
    case kStackLn: return attention_variant_kernel<kStackLn, false>;
    case kLanepack: return attention_variant_kernel<kLanepack, false>;
    default: return nullptr;
  }
}

constexpr size_t kSmemLimit = 232448;  // bytes of shared memory a block may use

// Heads per stacked stage: 1 for the loop cores; for stack3d the largest
// divisor of the head group, for lanepack its largest even divisor, whose
// layout fits shared memory; 0 for a shape the kernel does not take.
int variant_chunk(int n, int C, int heads, int core) {
  if (core < kLoop || core > kLanepack || heads < 1 || C % heads) return 0;
  const int dh = C / heads;
  if (n % 16 || C % 16 || dh % 16) return 0;
  if (core == kLanepack && heads % 2) return 0;
  const int gw = variant_group(C, heads, core);
  if (core == kLoop || core == kLoopLn)
    return variant_layout(n, C, gw, 1, core).total <= kSmemLimit ? 1 : 0;
  const int step = core == kLanepack ? 2 : 1;
  for (int chunk = gw / dh; chunk >= step; --chunk)
    if ((gw / dh) % chunk == 0 && chunk % step == 0 &&
        variant_layout(n, C, gw, chunk, core).total <= kSmemLimit)
      return chunk;
  return 0;
}

}  // namespace
}  // namespace fbanet

extern "C" {

// Heads per stage of a core (see variant_chunk), 0 if not taken.
int fbanet_attention_variant_chunk(int n, int C, int heads, int core) {
  return fbanet::variant_chunk(n, C, heads, core);
}

// Dynamic shared memory of one block, 0 for a shape the kernel does not take.
int fbanet_attention_variant_smem(int n, int C, int heads, int core) {
  using namespace fbanet;
  const int chunk = variant_chunk(n, C, heads, core);
  if (chunk == 0) return 0;
  return (int)variant_layout(n, C, variant_group(C, heads, core), chunk, core).total;
}

// K7 on a bf16 map [B, H, W, C], mask-free, no residual. core: 0 loop,
// 1 loop_ln, 2 stack3d, 3 stack3d_ln, 4 lanepack (bias packed [heads / 2,
// n, 2n]); qkv1 with stack3d_ln only; nr windows per block, dividing the
// map's B * windows.
int fbanet_attention_variant(const void* x, void* out, const void* ln_s, const void* ln_b,
                             const void* wq, const void* bq, const void* wkv,
                             const void* bkv, const void* wproj, const void* bproj,
                             const void* bias, int B, int H, int W, int C, int heads,
                             int ws, int core, int qkv1, int nr, void* stream) {
  using namespace fbanet;
  const int n = ws * ws;
  const int chunk = variant_chunk(n, C, heads, core);
  const Kernel kern = variant_kernel(core, qkv1);
  if (chunk == 0 || kern == nullptr || ws < 1 || H % ws || W % ws || nr < 1)
    return (int)cudaErrorInvalidValue;
  const int windows = B * (H / ws) * (W / ws);
  if (windows % nr) return (int)cudaErrorInvalidValue;
  const int gw = variant_group(C, heads, core);
  const int smem = (int)variant_layout(n, C, gw, chunk, core).total;
  const VarArgs a{(const bf16*)x,    (bf16*)out,         (const float*)ln_s,
                  (const float*)ln_b, (const bf16*)wq,   (const bf16*)wkv,
                  (const bf16*)wproj, (const float*)bq,  (const float*)bkv,
                  (const float*)bproj, (const float*)bias, H, W, C, heads, ws, nr, gw, chunk};
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)(windows / nr), kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
