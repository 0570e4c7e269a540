// Pieces of K1's bf16 block body shared by K1 (attention.cu) and K7
// (attention_variants.cu): the head group, the shared-memory layout, and the
// softmax whose division comes after the AV product.
#pragma once

#include "common.cuh"

namespace fbanet {
namespace {

// Heads per group: the largest divisor of `heads` whose padded columns
// (head_pitch, common.cuh) fit in 64 and whose columns fill whole 16-wide
// tiles of the projections; 1 where none does.
__host__ __device__ inline int head_group(int heads, int dh) {
  int hg = 1;
  for (int g = 1; g <= heads; ++g)
    if (heads % g == 0 && g * head_pitch(dh) <= 64 && g * dh % 16 == 0) hg = g;
  return hg;
}

// bf16 kernel: byte offsets of its shared-memory arrays, in this order:
// LN output y and attention output o [n][C+8] bf16; q, k, v of a head
// group [n][gw+8] bf16 (gw: the group's padded width, group_pitch);
// probabilities p [n][n+8] bf16; f32 logits s [n][n+1]; f32 1 / row sums;
// one 16 x 16 f32 WMMA epilogue slot per warp.
struct Bf16Layout {
  size_t y, o, q, k, v, p, s, inv, scratch, total;
  __host__ __device__ Bf16Layout(int n, int C, int gw) {
    y = 0;
    o = y + align128(sizeof(bf16) * n * (C + 8));
    q = o + align128(sizeof(bf16) * n * (C + 8));
    k = q + align128(sizeof(bf16) * n * (gw + 8));
    v = k + align128(sizeof(bf16) * n * (gw + 8));
    p = v + align128(sizeof(bf16) * n * (gw + 8));
    s = p + align128(sizeof(bf16) * n * (n + 8));
    inv = s + align128(sizeof(float) * n * (n + 1));
    scratch = inv + align128(sizeof(float) * n);
    total = scratch + sizeof(float) * 256 * (kThreads / 32);
  }
};

__host__ __device__ inline int group_width(int C, int heads) {
  return head_group(heads, C / heads) * (C / heads);
}

// The group's width with each head padded to head_pitch.
__host__ __device__ inline int group_pitch(int C, int heads) {
  return head_group(heads, C / heads) * head_pitch(C / heads);
}

// Softmax of one logits row per warp: probabilities (rounded to the compute
// type) into p, 1 / (f32 row sum) into inv; the division happens after AV.
// `rows` rows of n logits (rows > n: the heads of a K7 stack, one after the
// other at the same stride).
template <typename TP>
__device__ __forceinline__ void softmax_rows(int rows, int n, const float* sS, int lds,
                                             TP* sP, int ldp, float* sInv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int m = warp; m < rows; m += kThreads / 32) {
    const float* row = sS + m * lds;
    float mx = __int_as_float(0xff800000);  // -inf
    for (int s = lane; s < n; s += 32) mx = fmaxf(mx, row[s]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int s = lane; s < n; s += 32) {
      const float e = expf(row[s] - mx);
      sum += e;
      sP[m * ldp + s] = from_f<TP>(e);
    }
    sum = warp_sum(sum);
    if (lane == 0) sInv[m] = 1.0f / sum;
  }
}

template <typename TP>
__device__ __forceinline__ void softmax_rows(int n, const float* sS, int lds,
                                             TP* sP, int ldp, float* sInv) {
  softmax_rows(n, n, sS, lds, sP, ldp, sInv);
}

}  // namespace
}  // namespace fbanet
