// Shared device code of the structured self-attention kernels (sm_90a):
// the register-tiled product engine behind K2/K10 (csrc/attn_fwd.cu) and
// K11 (csrc/attn_bwd.cu), and the shared-memory sizes their host plans
// (ops/attn.py:attn_fwd_plan, attn_bwd_plan) must agree with.
//
// The engine computes one [R, CW] tile of a product C = A^T B over a depth
// K, C[r, c] = sum_k A[k, r] B[k, c], for R in {8, 16, 32, 64} token rows
// and CW = 64 columns, on 256 threads. Both operands come through loader
// callbacks (any layout, global or shared memory, zero past the edge) and
// are staged in slabs of SLAB = 64 depth values, double-buffered: the next
// slab is loaded into registers while the current one is used, so one block
// barrier a slab. The slabs are deep because the tiles are small: a slab's
// products take less time than its loads' latency, so the number of slabs
// (4 over D = 256) sets the engine's time. Each thread owns a 4 x 4
// register tile fed by two 16-byte shared loads per 16 FMAs. A small R leaves threads over, so the depth is
// split 64 / R ways and the partial tiles are summed in split order: the
// result is the same bit for bit on every run. The sums reach the caller's
// epilogue one (r, c) per call, consecutive threads on consecutive c, all
// 32 lanes of a warp together on one row (R * CW is a multiple of 256).
// Everything is f32 FMA: no TF32 and no bf16 products, so the kernels keep
// the plain version's f32 bar.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

constexpr int THREADS = 256;
constexpr int CW = 64;     // output columns of one tile
constexpr int SLAB = 64;   // depth of one staged slab
constexpr int SPLIT = 8;   // CTAs of K2/K10's cluster: the time split
constexpr int WSPLIT = 16; // CTAs of K11's weight-gradient cluster: the token split
constexpr int WR = 32;     // rows of dW1 in a weight-gradient tile
constexpr float NEG = -1e30f;
constexpr size_t SMEM_LIMIT = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Floats of the engine for an R-row tile: two slabs of each operand,
// [SLAB, R + 4] and [SLAB, CW + 4], and the split partials [64 / R, R, CW].
__host__ __device__ constexpr int engine_floats(int R) {
  return 2 * SLAB * (R + 4) + 2 * SLAB * (CW + 4) + 64 * CW;
}

// Shared memory in bytes (ops/attn.py: attn_fwd_smem, attn_bwd_smem,
// attn_wgrad_smem). K2/K10: the engine, the tile's half-row score sums
// [R, 2], scores and weights [R], per row of the cluster's G rows the
// running max, normalizer and rescale factor and the weighted sum [G, D],
// and the merge's per-rank factors [SPLIT, G]. At the flagship's M = 200
// plan (R = 64, G = 12) that is 99 856 bytes: two CTAs an SM, so the 17
// clusters run in one wave.
__host__ __device__ constexpr size_t fwd_smem(int R, int G, int D) {
  return 4 * ((size_t)engine_floats(R) + 4 * R + (3 + SPLIT) * G + (size_t)G * D);
}
// K11's token kernel: the engine, tanh(P) (then dproj) of the tile [R, A],
// and a_t, ds_t [R].
__host__ __device__ constexpr size_t bwd_smem(int R, int A) {
  return 4 * ((size_t)engine_floats(R) + (size_t)R * A + 2 * R);
}
// K11's weight-gradient kernel: the engine at R = WR and its partial tile.
__host__ __device__ constexpr size_t wgrad_smem() {
  return 4 * ((size_t)engine_floats(WR) + WR * CW);
}

// Raise a kernel's dynamic shared-memory limit to `bytes` on the current
// device once, not at every launch (the call costs host time on the
// serving path). `done` is the caller's static per-device record.
template <typename K>
inline cudaError_t allow_smem(K* kernel, size_t bytes, int (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev] >= (int)bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = (int)bytes;
  return err;
}

__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4& a, const float4& b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i][0] = fmaf(av[i], b.x, acc[i][0]);
    acc[i][1] = fmaf(av[i], b.y, acc[i][1]);
    acc[i][2] = fmaf(av[i], b.z, acc[i][2]);
    acc[i][3] = fmaf(av[i], b.w, acc[i][3]);
  }
}

// Slab value idx -> (depth kk, row or column x). K_FAST puts consecutive
// threads on consecutive depths (an operand whose rows are contiguous in
// depth: H rows, W1 rows read as W1^T), else on consecutive rows/columns.
template <bool K_FAST, int W>
__device__ __forceinline__ void slab_at(int idx, int& kk, int& x) {
  if (K_FAST) {
    kk = idx % SLAB;
    x = idx / SLAB;
  } else {
    kk = idx / W;
    x = idx % W;
  }
}

// One [R, CW] tile: la(k, r) and lb(k, c) give A[k, r] and B[k, c] for
// k < K (never called past K), epi(r, c, v) takes the sum. `sm` holds
// engine_floats(R) floats, 16-byte aligned. Starts and ends with a block
// barrier, so the caller may write what the loaders read right before the
// call and read what the epilogue wrote right after it.
template <int R, bool A_KFAST, bool B_KFAST, typename LA, typename LB, typename EPI>
__device__ __forceinline__ void tile_product(float* sm, int K, LA&& la, LB&& lb, EPI&& epi) {
  static_assert(R == 8 || R == 16 || R == 32 || R == 64, "tile rows");
  constexpr int S = 64 / R;                 // split of the depth
  constexpr int TS = THREADS / S;           // threads of one split: (R/4) x 16 tiles of 4 x 4
  constexpr int KPS = SLAB / S;             // depth of a slab per split
  constexpr int PA = (SLAB * R + THREADS - 1) / THREADS;
  constexpr int PB = SLAB * CW / THREADS;
  float (*As)[SLAB][R + 4] = reinterpret_cast<float (*)[SLAB][R + 4]>(sm);
  float (*Bs)[SLAB][CW + 4] = reinterpret_cast<float (*)[SLAB][CW + 4]>(sm + 2 * SLAB * (R + 4));
  float* part = sm + 2 * SLAB * (R + 4) + 2 * SLAB * (CW + 4);
  const int tid = threadIdx.x, s = tid / TS, l = tid % TS, tr = l / 16, tc = l % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  float va[PA], vb[PB];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < PA; ++i) {
      const int idx = tid + i * THREADS;
      int kk, r;
      slab_at<A_KFAST, R>(idx, kk, r);
      va[i] = idx < SLAB * R && k0 + kk < K ? la(k0 + kk, r) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < PB; ++i) {
      int kk, c;
      slab_at<B_KFAST, CW>(tid + i * THREADS, kk, c);
      vb[i] = k0 + kk < K ? lb(k0 + kk, c) : 0.0f;
    }
  };
  const int n = (K + SLAB - 1) / SLAB;
  __syncthreads();  // the previous tile's reads of the slabs and partials are done
  if (n > 0) load(0);
  for (int sl = 0; sl < n; ++sl) {
    const int buf = sl & 1;
#pragma unroll
    for (int i = 0; i < PA; ++i) {
      const int idx = tid + i * THREADS;
      int kk, r;
      slab_at<A_KFAST, R>(idx, kk, r);
      if (idx < SLAB * R) As[buf][kk][r] = va[i];
    }
#pragma unroll
    for (int i = 0; i < PB; ++i) {
      int kk, c;
      slab_at<B_KFAST, CW>(tid + i * THREADS, kk, c);
      Bs[buf][kk][c] = vb[i];
    }
    __syncthreads();  // slab sl is in; every read of this buffer's slab sl - 2 is done
    if (sl + 1 < n) load((sl + 1) * SLAB);
#pragma unroll
    for (int j = 0; j < KPS; ++j) {
      const int kk = s * KPS + j;
      outer4(acc, *reinterpret_cast<const float4*>(&As[buf][kk][tr * 4]),
             *reinterpret_cast<const float4*>(&Bs[buf][kk][tc * 4]));
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(&part[(s * R + tr * 4 + i) * CW + tc * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  for (int o = tid; o < R * CW; o += THREADS) {
    float v = 0.0f;
#pragma unroll
    for (int q = 0; q < S; ++q) v += part[q * R * CW + o];
    epi(o / CW, o % CW, v);
  }
  __syncthreads();
}

}  // namespace attn
