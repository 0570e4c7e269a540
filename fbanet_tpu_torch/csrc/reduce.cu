// The cross-block sums of the backward kernels K3 (attention_bwd.cu) and K4
// (leff_bwd.cu), in a fixed order and without float atomics, so the
// gradients are bitwise repeatable.
//
// They replace the accumulation into constant-index output blocks of the TPU
// kernels fbanet_tpu/ops/attention_pallas.py::_attention_bwd_kernel
// (:456-473: dWq, dWkv, dWproj, the biases, LayerNorm and relative-position
// bias sums) and fbanet_tpu/ops/leff_pallas.py::_leff_bwd_kernel (:379-401:
// dW1, dW2, the biases, LayerNorm and depthwise tap sums), which rely on the
// TPU grid running in order on one core. Hopper's blocks run in no order, so
// K3/K4 write per-token scratch and per-block partials, and these kernels
// sum them in an order fixed by the shapes alone.
//
// fbanet_token_matmul, bf16 (R1, the main path's weight gradients):
// out[m][n] = sum over t of A[t][m] B[t][n] (A [T, M], B [T, N] row-major),
// f32 accumulation. What bounds it: the bytes of A and B, 2 T (M + N),
// against 2 T M N flops, at most 205 flops per byte at M, N <= 1024 and
// below the H100's ~295: device memory. So the design reads each input
// byte from device memory about once and keeps enough bytes in flight:
//  - a block owns one tile_m x tile_n output tile (64 or 128 each) for one
//    slice of the tokens; blockIdx.x is the tile, so the blocks of a slice
//    are adjacent in launch order and read its tokens from L2 together;
//  - one producer thread streams 64-token stages of A and B with TMA into
//    a ring of 4-8 stages in dynamic shared memory (64-column boxes in the
//    128-byte swizzle, one mbarrier per stage for "full", one for "empty"),
//    so every load is a bulk copy and loads run ahead of the products;
//  - each consumer warpgroup owns 64 rows of the tile and runs 4
//    wgmma.m64n{tile_n}k16 per stage with both operands in shared memory
//    (A^T and B are both MN-major: the descriptors' transpose bits),
//    accumulating each slice's tokens in order in registers;
//  - the plan (ops/reduce.py::_token_matmul_plan) gives as many slices as
//    fill the SMs once with one block each. Every block then writes its
//    partial tile, all blocks meet at a grid barrier (a cooperative launch
//    keeps them resident), and they sum the slices in a fixed order. That
//    keeps one launch and spreads the sum over the card: a second pass
//    through fbanet_column_sum costs a launch and a host round of the
//    wrapper per call, and a semaphore chain in the epilogue (slice s
//    waits for s - 1) would serialise up to 132 read-add-writes of a tile.
//    The partials (about SMs x tile floats) are the kernel's main cost
//    beyond its inputs, which is why the plan takes 128-wide tiles only
//    for large outputs.
//
// fbanet_token_matmul, f32 (only the f32 gradient check runs it): the first
// port's kernel, unchanged: 64 x 64 tiles of 4 x 4 CUDA-core FMAs per
// thread, 32-token stages, slices' partials summed by the caller.
//
// fbanet_column_sum (R2): out[j] = sum over r of P[r][j] for an f32 [R, M]
// matrix, bound by the bytes of P. A block owns a band of 128 columns
// (float4 per lane; 32 columns of scalars where M % 4 != 0) and a slice of
// rows; its 8 warps take interleaved rows, each with 8 independent 16-byte
// loads in flight, and combine in a fixed tree in shared memory. With more
// than one slice, each block writes its partial row and the last block of
// a band to arrive (an integer counter) sums the partials in slice order,
// so the order depends on the plan (ops/reduce.py::_column_sum_plan), not
// on which block finished first.
#include "common.cuh"
#include "hopper.cuh"

namespace fbanet {
namespace {

// ------------------------------------------------------------- f32 R1 ----

constexpr int kTile = 64, kTok = 32;

struct GemmArgs {
  const void *a, *b;
  float* part;
  int T, M, N, chunk;
};

__global__ void __launch_bounds__(kThreads) token_matmul_f32_kernel(GemmArgs g) {
  __shared__ float sA[kTok][kTile], sB[kTok][kTile];
  const float* A = (const float*)g.a;
  const float* B = (const float*)g.b;
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile, s = blockIdx.z;
  const int t_begin = s * g.chunk, t_end = min(g.T, t_begin + g.chunk);
  const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
  float acc[4][4] = {};
  for (int t0 = t_begin; t0 < t_end; t0 += kTok) {
    for (int i = threadIdx.x; i < kTok * kTile; i += kThreads) {
      const int tt = i / kTile, c = i % kTile, t = t0 + tt;
      sA[tt][c] = t < t_end ? A[(size_t)t * g.M + m0 + c] : 0.f;
      sB[tt][c] = t < t_end ? B[(size_t)t * g.N + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int tt = 0; tt < kTok; ++tt) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sA[tt][tm * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[tt][tn + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = g.part + (size_t)s * g.M * g.N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[(size_t)(m0 + tm * 4 + i) * g.N + n0 + tn + 16 * j] = acc[i][j];
}

// ------------------------------------------------------ fixed-order sums --

// V consecutive f32 columns per lane: float4 (16-byte loads) where M % 4
// == 0, else one float
template <int V> struct Cols;
template <> struct Cols<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ T add(T x, T y) {
    return make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
  }
};
template <> struct Cols<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T add(T x, T y) { return x + y; }
};

// One warp's share of a column sum: rows r, r + stride, r + 2 stride, ...
// below r_end of `src` (one row is `step` T's apart), added in row order, 8
// loads in flight. L2 loads (ld.cg): the rows may have been written earlier
// in the same kernel by another SM.
template <int V>
__device__ __forceinline__ typename Cols<V>::T warp_rows(const typename Cols<V>::T* src,
                                                         size_t step, int r, int stride,
                                                         int r_end) {
  using C = Cols<V>;
  typename C::T acc = C::zero();
  for (; r + 7 * stride < r_end; r += 8 * stride) {
    typename C::T v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = __ldcg(src + (size_t)(r + k * stride) * step);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = C::add(acc, v[k]);
  }
  for (; r < r_end; r += stride) acc = C::add(acc, __ldcg(src + (size_t)r * step));
  return acc;
}

// the W warps' sums of one lane's columns, in a fixed pairwise tree
template <int W, typename T> __device__ __forceinline__ T warp_tree(T (*sums)[32], int lane) {
  if constexpr (W == 1)
    return sums[0][lane];
  else
    return Cols<sizeof(T) / 4>::add(warp_tree<W / 2>(sums, lane),
                                    warp_tree<W / 2>(sums + W / 2, lane));
}

// All blocks of the grid meet here (they must be co-resident: a
// cooperative launch). sync[0] counts arrivals, sync[1] is the generation;
// the last block to arrive resets the count and moves the generation on.
__device__ void grid_barrier(unsigned* sync) {
  const unsigned blocks = gridDim.x * gridDim.y;
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = sync + 1;
    const unsigned g0 = *gen;
    __threadfence();
    if (atomicAdd(sync, 1u) == blocks - 1) {
      atomicExch(sync, 0u);
      __threadfence();
      atomicAdd(sync + 1, 1u);
    } else {
      while (*gen == g0) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// ------------------------------------------------------------ bf16 R1 ----

constexpr int kStageTok = 64;                   // tokens per ring stage
constexpr int kAtomBytes = kStageTok * 128;     // one 64-column swizzle atom
constexpr int kRingBudget = 200 * 1024;         // shared memory for the ring

template <int BM, int BN> struct TmShape {
  static constexpr int kGroups = BM / 64;                  // consumer warpgroups
  static constexpr int kThreads = 128 * kGroups + 32;      // + the producer warp
  static constexpr int kABytes = (BM / 64) * kAtomBytes;
  static constexpr int kStageBytes = kABytes + (BN / 64) * kAtomBytes;
  static constexpr int kStages =
      kRingBudget / kStageBytes < 8 ? kRingBudget / kStageBytes : 8;
  // ring + barriers + slack to align the ring to 1024 bytes
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
  static_assert(kStages >= 3, "ring of at least 3 stages");
};

struct TmArgs {
  float *part, *out;  // slice partials [splits][M][N] (splits > 1), out [M][N]
  unsigned* sync;     // two zeroed words for the grid barrier (splits > 1)
  int T, M, N, chunk;
};

// consumers: warpgroup `warp / 4` owns rows [64 (warp / 4), +64) of the
// tile; each waits for a stage, runs 4 wgmma k16 steps on it, hands it
// back, then writes its f32 accumulators to `out` ([.][N] rows).
template <int BM, int BN>
__device__ __forceinline__ void consume(uint8_t* ring, uint64_t* full, uint64_t* empty,
                                        int n_stages, int m0, int n0, int warp, int lane,
                                        float* out, int N) {
  using S = TmShape<BM, BN>;
  const int grp = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < n_stages; ++i) {
    const int s = i % S::kStages;
    mbar_wait(&full[s], (i / S::kStages) & 1);
    const uint32_t a_addr = smem_addr(ring + s * S::kStageBytes + grp * kAtomBytes);
    const uint32_t b_addr = smem_addr(ring + s * S::kStageBytes + S::kABytes);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kStageTok / 16; ++k)  // 16 tokens = 2 groups of 8 rows
      wgmma_bf16<BN>(acc, mn_major_desc(a_addr + k * 2048, kAtomBytes),
                     mn_major_desc(b_addr + k * 2048, kAtomBytes));
    wgmma_commit();
    wgmma_wait_all();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const int row = m0 + 64 * grp + 16 * (warp % 4) + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    *reinterpret_cast<float2*>(out + (size_t)row * N + col) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (size_t)(row + 8) * N + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

template <int BM, int BN>
__global__ void __launch_bounds__(TmShape<BM, BN>::kThreads, 1)
    token_matmul_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                             const __grid_constant__ CUtensorMap map_b, TmArgs g) {
  using S = TmShape<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::kStages * S::kStageBytes);
  uint64_t* empty = full + S::kStages;

  const int tiles_n = g.N / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  const int slice = blockIdx.y, splits = gridDim.y;
  const int t_begin = slice * g.chunk;
  const int n_stages = (min(g.T, t_begin + g.chunk) - t_begin + kStageTok - 1) / kStageTok;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * S::kGroups);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * S::kGroups) {  // producer: one thread issues every TMA load
    if (lane == 0) {
      tma_prefetch_map(&map_a);
      tma_prefetch_map(&map_b);
      for (int i = 0; i < n_stages; ++i) {
        const int s = i % S::kStages;
        if (i >= S::kStages) mbar_wait(&empty[s], ((i / S::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], S::kStageBytes);
        uint8_t* stage = ring + s * S::kStageBytes;
        const int t = t_begin + i * kStageTok;
#pragma unroll
        for (int a = 0; a < BM / 64; ++a)
          tma_load_2d(stage + a * kAtomBytes, &map_a, m0 + 64 * a, t, &full[s]);
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          tma_load_2d(stage + S::kABytes + b * kAtomBytes, &map_b, n0 + 64 * b, t,
                      &full[s]);
      }
    }
  } else {
    consume<BM, BN>(ring, full, empty, n_stages, m0, n0, warp, lane,
                    splits == 1 ? g.out : g.part + (size_t)slice * g.M * g.N, g.N);
  }
  if (splits == 1) return;

  // every slice's partial tile is written: the blocks share the sum of the
  // slices out, in 128-column bands of [splits, M N]. G warps take one band
  // (as many as let every warp of the grid have a band at once, at most W
  // and at least 4 slices each): warp g adds slices g, g + G, ... in order,
  // then the G sums add in warp order.
  __threadfence();
  grid_barrier(g.sync);
  constexpr int W = 4 * S::kGroups;
  auto sums = reinterpret_cast<float4 (*)[32]>(ring);  // the ring is idle now
  const size_t row = (size_t)g.M * g.N / 4;             // one slice, in float4
  const int bands = (int)(row / 32);
  int G = 1;
  while (2 * G <= W && 8 * G <= splits &&
         (size_t)bands * 2 * G <= (size_t)W * gridDim.x * gridDim.y)
    G *= 2;
  const int per = W / G;
  for (int base = (blockIdx.y * gridDim.x + blockIdx.x) * per; base < bands;
       base += gridDim.x * gridDim.y * per) {
    const int band = base + warp / G;
    if (warp < W && band < bands)
      sums[warp][lane] = warp_rows<4>(reinterpret_cast<const float4*>(g.part) + band * 32 + lane,
                                      row, warp % G, G, splits);
    __syncthreads();
    if (warp < W && band < bands && warp % G == 0) {
      float4 v = sums[warp][lane];
      for (int k = 1; k < G; ++k) v = Cols<4>::add(v, sums[warp + k][lane]);
      reinterpret_cast<float4*>(g.out)[band * 32 + lane] = v;
    }
    __syncthreads();
  }
}

template <int BM, int BN>
cudaError_t launch_bf16(const void* a, const void* b, TmArgs g, int splits,
                        cudaStream_t stream) {
  using S = TmShape<BM, BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      token_matmul_bf16_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap map_a, map_b;
  cudaError_t err = make_tma_map_bf16(&map_a, a, g.T, g.M, kStageTok);
  if (err == cudaSuccess) err = make_tma_map_bf16(&map_b, b, g.T, g.N, kStageTok);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.M / BM) * (g.N / BN), splits);
  if (splits == 1) {
    token_matmul_bf16_kernel<BM, BN><<<grid, S::kThreads, S::kSmem, stream>>>(map_a, map_b, g);
    return cudaGetLastError();
  }
  // the slices' sum follows a grid barrier: every block must be resident
  void* args[] = {&map_a, &map_b, &g};
  return cudaLaunchCooperativeKernel((const void*)token_matmul_bf16_kernel<BM, BN>, grid,
                                     dim3(S::kThreads), args, S::kSmem, stream);
}

// ----------------------------------------------------------------- R2 ----

constexpr int kRowWarps = kThreads / 32;

template <int V>
__global__ void __launch_bounds__(kThreads)
    column_sum_kernel(const float* __restrict__ p, float* __restrict__ part,
                      float* __restrict__ out, unsigned* __restrict__ counters, int R,
                      int M, int rows_per_slice) {
  using C = Cols<V>;
  using T = typename C::T;
  __shared__ T sums[kRowWarps][32];
  __shared__ bool last;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int band = blockIdx.x, slice = blockIdx.y, slices = gridDim.y;
  const int col = (band * 32 + lane) * V;
  const int r_end = min(R, (slice + 1) * rows_per_slice);
  if (col < M)
    sums[warp][lane] = warp_rows<V>(reinterpret_cast<const T*>(p + col), (size_t)M / V,
                                    slice * rows_per_slice + warp, kRowWarps, r_end);
  else
    sums[warp][lane] = C::zero();
  __syncthreads();
  if (warp == 0 && col < M)
    *reinterpret_cast<T*>((slices == 1 ? out : part + (size_t)slice * M) + col) =
        warp_tree<kRowWarps>(sums, lane);
  if (slices == 1) return;
  // the last block of this band to arrive sums the slices in slice order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&counters[band], 1u) == (unsigned)slices - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (warp == 0 && col < M) {
    T s = __ldcg(reinterpret_cast<const T*>(part + col));
    for (int k = 1; k < slices; ++k)
      s = C::add(s, __ldcg(reinterpret_cast<const T*>(part + (size_t)k * M + col)));
    *reinterpret_cast<T*>(out + col) = s;
  }
  if (threadIdx.x == 0) counters[band] = 0;  // ready for the next call
}

}  // namespace
}  // namespace fbanet

extern "C" {

// bf16: out [M, N] = A^T B; tile_m and tile_n in {64, 128},
// chunk a multiple of 64 tokens, A and B 16-byte aligned; with more than
// one slice, `part` holds ceil(T / chunk) x M x N floats and `sync` two
// zeroed words (left zeroed), and every block must fit on the card at once.
// f32: the slices' partials in `part` (64 x 64 tiles, chunk a multiple of
// 32), summed by the caller; `out` and `sync` unused.
int fbanet_token_matmul(const void* a, const void* b, void* part, void* out, void* sync,
                        int T, int M, int N, int chunk, int tile_m, int tile_n, int bf16,
                        void* stream) {
  using namespace fbanet;
  if (T <= 0 || chunk <= 0 || tile_m <= 0 || tile_n <= 0 || M % tile_m || N % tile_n)
    return (int)cudaErrorInvalidValue;
  const int splits = (T + chunk - 1) / chunk;
  const cudaStream_t s = (cudaStream_t)stream;
  if (!bf16) {
    if (tile_m != kTile || tile_n != kTile || chunk % kTok) return (int)cudaErrorInvalidValue;
    GemmArgs g{a, b, (float*)part, T, M, N, chunk};
    token_matmul_f32_kernel<<<dim3(N / kTile, M / kTile, splits), kThreads, 0, s>>>(g);
    return (int)cudaGetLastError();
  }
  if (chunk % kStageTok || (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16)
    return (int)cudaErrorInvalidValue;
  const TmArgs g{(float*)part, (float*)out, (unsigned*)sync, T, M, N, chunk};
  switch (tile_m * 1000 + tile_n) {
    case 64064: return (int)launch_bf16<64, 64>(a, b, g, splits, s);
    case 64128: return (int)launch_bf16<64, 128>(a, b, g, splits, s);
    case 128064: return (int)launch_bf16<128, 64>(a, b, g, splits, s);
    case 128128: return (int)launch_bf16<128, 128>(a, b, g, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// p [R, M] f32, 16-byte aligned; bands of 128 columns (float4) where M % 4
// == 0, else of 32. `part` holds slices x M floats and `counters` one
// zeroed unsigned int per band (left zeroed again) when slices > 1.
int fbanet_column_sum(const void* p, void* part, void* out, void* counters, int R, int M,
                      int rows_per_slice, void* stream) {
  using namespace fbanet;
  if (R <= 0 || M <= 0 || rows_per_slice <= 0 ||
      (reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorInvalidValue;
  const int slices = (R + rows_per_slice - 1) / rows_per_slice;
  const cudaStream_t s = (cudaStream_t)stream;
  if (M % 4 == 0)
    column_sum_kernel<4><<<dim3((M + 127) / 128, slices), kThreads, 0, s>>>(
        (const float*)p, (float*)part, (float*)out, (unsigned*)counters, R, M, rows_per_slice);
  else
    column_sum_kernel<1><<<dim3((M + 31) / 32, slices), kThreads, 0, s>>>(
        (const float*)p, (float*)part, (float*)out, (unsigned*)counters, R, M, rows_per_slice);
  return (int)cudaGetLastError();
}

}  // extern "C"
