// Weight gradients and demb of the LSTM backward for Hopper (sm_90a): the
// off-chain half of K8, K6 and kernel 3.
//
// Replaces: the products that the Pallas backward kernels take inside their
// time loop, in induction_network_on_fewrel_tpu/ops/lstm.py:
// _fused_win_bwd_kernel (:1090-1107) and _fused_bwd_kernel (:792-806):
//   demb_t = da_t W_ih^T;  dW_ih += emb_t^T da_t;  db += sum_rows da_t;
//   dW_hh += h_prev^T da_t
// and _bwd_kernel (:258-262): dW_hh only. The chain kernels
// (lstm_cluster_bwd_kernel) stream da [Gc, L, M, 4u] in f32; this kernel
// takes the products over all L*M rows at once, per group g:
//   demb [Gc, L, M, D] (emb's dtype, per group) = da W_ih^T
//   [dW_hh; dW_ih; db] = A^T da,  A = [h_prev | emb | 1]  [L*M, u + D + 1]
// h_prev is either the chain's hp stream at time t (K8: shift = 0) or the
// saved hs at the kernel-previous time, zero at kernel step 0 (K6, kernel 3:
// shift = 1). Without the projection (D = 0) only dW_hh is computed.
//
// What bounds it on this card: f32 operations (about 2 (u + 2D + 1) 4u L M
// per group, ~4 GFLOP at the flagship training step) at the FP32 rate; the
// bytes (da, 33 MB, read by the demb tiles and by each row of weight
// tiles) come second.
//
// Design: 64 x 64 output tiles on 256 threads, each owning a 4 x 4 register
// tile; 16-row slabs of both operands staged in shared memory (two buffers:
// the next slab is loaded into registers while the current one is used, so
// one block barrier a slab), and a thread feeds 16 FMAs from two 16-byte
// loads. demb tiles take the 4u gate columns as their k dimension. The
// weight tiles split their L*M rows over a cluster of 8 CTAs (split-K);
// each CTA keeps its partial tile in shared memory and, after a cluster
// barrier, CTA r sums rows [8r, 8r + 8) of the tile over the 8 partials
// in rank order through distributed shared memory, so the result repeats
// bit for bit (no atomics) and needs no second launch.

#include "lstm_common.cuh"

namespace {

namespace cg = cooperative_groups;
using lstm::View;
using lstm::to_f32;
using lstm::from_f32;

constexpr int THREADS = 256, TILE = 64, SLAB = 16, SPLIT = 8;
constexpr int PER = SLAB * TILE / THREADS;  // values of each operand a thread stages a slab

template <typename T, typename HT>
struct WgradArgs {
  const float* da;  // [Gc, L, M, 4u]
  const T* x;       // PROJ: emb (view xv)
  const HT* h;      // h_prev source (view hv)
  const T* wih;     // [Gc, D, 4u] (PROJ)
  T* demb;          // [Gc, L, M, D] (PROJ)
  float* dwih;      // [Gc, D, 4u] (PROJ)
  float* db;        // [Gc, 4u] (PROJ)
  float* dwhh;      // [Gc, u, 4u]
  View xv, hv;
  int L, M, D, u, shift, rev_group;
  int demb_blocks;  // blockIdx.x below this computes demb; a multiple of SPLIT
};

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

// Grid (demb_blocks + weight tiles * SPLIT, Gc), clusters of (SPLIT, 1, 1).
// Runs the slabs s = 0, 1, .. < n through two shared buffers: load(s, va,
// vb) fetches a slab's PER + PER operand values into registers (slot i:
// index tid + i * THREADS of the [SLAB, TILE] slab, transposed by `at`),
// then each slab is stored, and accumulated while the next one loads.
template <typename Load, typename At>
__device__ __forceinline__ void slab_loop(int n, float (*As)[SLAB][TILE + 4],
                                          float (*Bs)[SLAB][TILE + 4], float (&acc)[4][4],
                                          Load&& load, At&& at) {
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  float va[PER], vb[PER];
  if (n > 0) load(0, va, vb);
  for (int s = 0; s < n; ++s) {
    const int buf = s & 1;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      int x, y;
      at(tid + i * THREADS, x, y);
      As[buf][x][y] = va[i];
      Bs[buf][x][y] = vb[i];
    }
    __syncthreads();  // slab s is in; every read of this buffer's slab s - 2 is done
    if (s + 1 < n) load(s + 1, va, vb);
#pragma unroll
    for (int k = 0; k < SLAB; ++k)
      outer4(acc, *reinterpret_cast<const float4*>(&As[buf][k][tr * 4]),
             *reinterpret_cast<const float4*>(&Bs[buf][k][tc * 4]));
  }
}

// Grid (demb_blocks + weight tiles * SPLIT, Gc), clusters of (SPLIT, 1, 1).
template <typename T, typename HT, bool PROJ>
__global__ void __launch_bounds__(THREADS) lstm_wgrad_kernel(WgradArgs<T, HT> a) {
  __shared__ __align__(16) float As[2][SLAB][TILE + 4];
  __shared__ __align__(16) float Bs[2][SLAB][TILE + 4];
  __shared__ __align__(16) float part[TILE * TILE];
  const int g = blockIdx.y, tid = threadIdx.x, G = 4 * a.u, M = a.M, LM = a.L * M;
  const int tr = tid / 16, tc = tid % 16;  // rows tr*4.., columns tc*4.. of the tile
  const float* da_g = a.da + (size_t)g * LM * G;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  if (PROJ && (int)blockIdx.x < a.demb_blocks) {
    // demb rows [r0, r0 + 64) x columns [k0, k0 + 64): sum over j < 4u of da[r, j] W_ih[k, j].
    const int D = a.D, DT = (D + TILE - 1) / TILE;
    const int r0 = blockIdx.x / DT * TILE, k0 = blockIdx.x % DT * TILE;
    if (r0 >= LM) return;  // padding to a whole cluster
    const T* wih_g = a.wih + (size_t)g * D * G;
    slab_loop(
        (G + SLAB - 1) / SLAB, As, Bs, acc,
        [&](int s, float (&va)[PER], float (&vb)[PER]) {
#pragma unroll
          for (int i = 0; i < PER; ++i) {
            const int idx = tid + i * THREADS, r = idx / SLAB, j = s * SLAB + idx % SLAB;
            va[i] = r0 + r < LM && j < G ? da_g[(size_t)(r0 + r) * G + j] : 0.0f;
            vb[i] = k0 + r < D && j < G ? to_f32(wih_g[(size_t)(k0 + r) * G + j]) : 0.0f;
          }
        },
        [](int idx, int& x, int& y) {
          x = idx % SLAB;
          y = idx / SLAB;
        });
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + tr * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + tc * 4 + j;
        if (r < LM && k < D) a.demb[((size_t)g * LM + r) * D + k] = from_f32<T>(acc[i][j]);
      }
    }
    return;
  }

  // Weight tile (kt, ct) of A^T da over row chunk `rank` of the cluster.
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = ((int)blockIdx.x - a.demb_blocks) / SPLIT;
  const int K = a.u + (PROJ ? a.D + 1 : 0), CT = (G + TILE - 1) / TILE;
  const int k0 = tile / CT * TILE, c0 = tile % CT * TILE;
  const int chunk = ((LM + SPLIT - 1) / SPLIT + SLAB - 1) / SLAB * SLAB;
  const int rb = rank * chunk, re = min(LM, rb + chunk);
  const bool rev = g == a.rev_group;
  // A[row, k]: h_prev (k < u), emb (k < u + D), 1 (k = u + D), else 0.
  auto a_at = [&](int row, int k) -> float {
    const int t = row / M, m = row - t * M;
    if (k < a.u) {
      const int tp = a.shift ? (rev ? t + 1 : t - 1) : t;
      if (tp < 0 || tp >= a.L) return 0.0f;
      return to_f32(a.h[g * a.hv.group + m * a.hv.row + tp * a.hv.time + k]);
    }
    if (PROJ && k < a.u + a.D)
      return to_f32(a.x[g * a.xv.group + m * a.xv.row + t * a.xv.time + k - a.u]);
    return PROJ && k == a.u + a.D ? 1.0f : 0.0f;
  };
  slab_loop(
      max(0, (re - rb + SLAB - 1) / SLAB), As, Bs, acc,
      [&](int s, float (&va)[PER], float (&vb)[PER]) {
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int idx = tid + i * THREADS, kk = idx % TILE, row = rb + s * SLAB + idx / TILE;
          va[i] = row < re && k0 + kk < K ? a_at(row, k0 + kk) : 0.0f;
          vb[i] = row < re && c0 + kk < G ? da_g[(size_t)row * G + c0 + kk] : 0.0f;
        }
      },
      [](int idx, int& x, int& y) {
        x = idx / TILE;
        y = idx % TILE;
      });
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(&part[(tr * 4 + i) * TILE + tc * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  cluster.sync();  // every partial tile of the cluster is written
  constexpr int ROWS = TILE / SPLIT;
  for (int idx = tid; idx < ROWS * TILE; idx += THREADS) {
    const int kk = rank * ROWS + idx / TILE, cc = idx % TILE;
    float s = 0.0f;
    for (int q = 0; q < SPLIT; ++q) s += cluster.map_shared_rank(part, q)[kk * TILE + cc];
    const int k = k0 + kk, col = c0 + cc;
    if (k < K && col < G) {
      if (k < a.u)
        a.dwhh[((size_t)g * a.u + k) * G + col] = s;
      else if (k < a.u + a.D)
        a.dwih[((size_t)g * a.D + k - a.u) * G + col] = s;
      else
        a.db[(size_t)g * G + col] = s;
    }
  }
  cluster.sync();  // no CTA leaves while a peer may still read its partial
}

template <typename T, typename HT, bool PROJ>
int launch(WgradArgs<T, HT> a, int Gc, cudaStream_t stream) {
  const int LM = a.L * a.M, G = 4 * a.u, K = a.u + (PROJ ? a.D + 1 : 0);
  const int demb = PROJ ? (LM + TILE - 1) / TILE * ((a.D + TILE - 1) / TILE) : 0;
  a.demb_blocks = (demb + SPLIT - 1) / SPLIT * SPLIT;
  const int wblocks = (K + TILE - 1) / TILE * ((G + TILE - 1) / TILE) * SPLIT;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.demb_blocks + wblocks, Gc, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, lstm_wgrad_kernel<T, HT, PROJ>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, typename HT>
int launch_proj(const void* da, const void* x, const void* h, const void* wih, void* demb,
                void* dwih, void* db, void* dwhh, int L, int M, int D, int u, int Gc, View xv,
                View hv, int shift, int rev_group, cudaStream_t s) {
  WgradArgs<T, HT> a{};
  a.da = static_cast<const float*>(da);
  a.x = static_cast<const T*>(x);
  a.h = static_cast<const HT*>(h);
  a.wih = static_cast<const T*>(wih);
  a.demb = static_cast<T*>(demb);
  a.dwih = static_cast<float*>(dwih);
  a.db = static_cast<float*>(db);
  a.dwhh = static_cast<float*>(dwhh);
  a.xv = xv;
  a.hv = hv;
  a.L = L; a.M = M; a.D = D; a.u = u; a.shift = shift; a.rev_group = rev_group;
  return D ? launch<T, HT, true>(a, Gc, s) : launch<T, HT, false>(a, Gc, s);
}

}  // namespace

extern "C" {

// da [Gc, L, M, 4u] f32 contiguous. x (emb, D > 0 only) and wih [Gc, D, 4u]
// in bf16 when bf16 != 0 (else f32); x by its (group, row, time) strides
// x_g, x_m, x_t. h, the h_prev source, by its strides h_g, h_m, h_t: f32
// when h_f32 != 0, else x's dtype; shift != 0 reads it at the kernel-previous
// time (rev_group walks time reversed), zero at kernel step 0. Writes, per
// group, dwhh [Gc, u, 4u] and, with D > 0, demb [Gc, L, M, D] (x's dtype),
// dwih [Gc, D, 4u] and db [Gc, 4u], all contiguous (dwih, db, dwhh f32).
int lstm_wgrad(const void* da, const void* x, const void* h, const void* wih, void* demb,
               void* dwih, void* db, void* dwhh, int L, int M, int D, int u, int Gc,
               long long x_g, long long x_m, long long x_t, long long h_g, long long h_m,
               long long h_t, int shift, int rev_group, int bf16, int h_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const View xv{x_g, x_m, x_t}, hv{h_g, h_m, h_t};
  if (bf16 && h_f32)
    return launch_proj<__nv_bfloat16, float>(da, x, h, wih, demb, dwih, db, dwhh, L, M, D, u,
                                             Gc, xv, hv, shift, rev_group, s);
  if (bf16)
    return launch_proj<__nv_bfloat16, __nv_bfloat16>(da, x, h, wih, demb, dwih, db, dwhh, L, M,
                                                     D, u, Gc, xv, hv, shift, rev_group, s);
  if (!h_f32) return (int)cudaErrorInvalidValue;
  return launch_proj<float, float>(da, x, h, wih, demb, dwih, db, dwhh, L, M, D, u, Gc, xv, hv,
                                   shift, rev_group, s);
}

const char* lstm_wgrad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
