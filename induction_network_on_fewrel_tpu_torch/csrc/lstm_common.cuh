// Shared device code of the LSTM kernels (sm_90a): the forward kernel body
// behind K1, K7, K4 and kernels 1/2, the gradient step behind K8, K6 and
// kernel 3, and the kernel that walks saved full residual streams (K6 and
// kernel 3). Each .cu source includes this header and instantiates only
// the templates its launchers use.
//
// Layout. A tensor of one group g (a BiLSTM direction) is addressed as
//   base + g * View::group + row * View::row + t * View::time + column,
// so one body serves the fused encoder's [L, M, *] streams (both directions
// in one row, natural time), the split recurrence's time-major
// [L, M, Gc*4u] input and its grouped [Gc, M, L, 4u] one, with no copy.
// One group (rev_group) walks natural time backwards: kernel step s reads
// and writes natural time L-1-s.
//
// Block shape (every kernel here): one block per (row tile of TM rows,
// group); 4u threads, thread j owning gate column j. Gate pre-activations
// accumulate in f32 (bf16 products are exact in f32); h, c and their
// gradients are carried in f32. Rows past M read zeros and write nothing,
// so the ragged last tile needs no padded copy.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace lstm {

constexpr int MAX_THREADS = 512;  // 4u <= 512

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Cells (row, unit) per thread in the cell phases: TM * u cells over 4u threads.
__host__ __device__ constexpr int cells_per_thread(int TM) { return TM >= 4 ? TM / 4 : 1; }

struct View {
  long long group, row, time;
};

// Pre-activations of gate column j for the TM rows of a tile:
//   PROJ:  b_j + emb_s[r] . W_ih[:, j] + hp[r] . W_hh[:, j]
//   else:  xg[row, t, j] + hp[r] . W_hh[:, j]     (xt: xg at time t, group g)
// into a_s[r * 4u + j]. Each weight is read once and reused TM times.
template <typename T, int TM, bool PROJ>
__device__ __forceinline__ void gate_column(float* a_s, const float* hp, const float* emb_s,
                                            const T* wih_d, float bj, const T* xt,
                                            long long xrow, int row0, int M,
                                            const float* whh_d, int D, int u, int j) {
  const int G = 4 * u;
  float acc[TM];
  if constexpr (PROJ) {
#pragma unroll
    for (int r = 0; r < TM; ++r) acc[r] = bj;
    for (int k = 0; k < D; ++k) {
      const float w = to_f32(wih_d[(size_t)k * G + j]);
#pragma unroll
      for (int r = 0; r < TM; ++r) acc[r] = fmaf(emb_s[r * D + k], w, acc[r]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < TM; ++r)
      acc[r] = row0 + r < M ? to_f32(xt[(row0 + r) * xrow + j]) : 0.0f;
  }
  for (int k = 0; k < u; ++k) {
    const float w = whh_d[(size_t)k * G + j];
#pragma unroll
    for (int r = 0; r < TM; ++r) acc[r] = fmaf(hp[r * u + k], w, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) a_s[r * G + j] = acc[r];
}

// Stage the embeddings of natural time t for the tile (f32; rows past M read zero).
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, View v, int t, int row0,
                                           int rows, int M, int D, int j, int nthreads) {
  for (int idx = j; idx < rows * D; idx += nthreads) {
    const int r = idx / D, k = idx - r * D;
    const int row = row0 + r;
    dst[idx] = row < M ? to_f32(src[row * v.row + t * v.time + k]) : 0.0f;
  }
}

// --- forward ------------------------------------------------------------------

// What the forward writes besides hs: nothing (K1, kernel 2), one (h, c)
// checkpoint pair per W-step natural block (K7), or c at every step (K4,
// kernel 1).
enum Residuals { kNone = 0, kCkpt = 1, kFull = 2 };

template <typename T, typename R>
struct FwdArgs {
  const T* x;        // PROJ: emb [L, M, D] (shared by the groups); else xg (view xv)
  const T* wih;      // [Gc, D, 4u] (PROJ)
  const float* b;    // [Gc, 1, 4u] (PROJ)
  const float* whh;  // [Gc, u, 4u]
  T* hs;             // view hv
  R* c1;             // kFull: cs (view hv); kCkpt: ch [ceil(L/W), M, *] (view hv by block)
  R* c2;             // kCkpt: cc
  View xv, hv;
  int L, M, D, u, W, rev_group;
};

template <typename T, typename R, bool PROJ, int MODE, int TM>
__global__ void __launch_bounds__(MAX_THREADS) lstm_fwd_kernel(FwdArgs<T, R> a) {
  constexpr int CPT = TM / 4;      // blockDim == 4u, so CPT * 4u == TM * u
  extern __shared__ float smem[];
  const int u = a.u, G = 4 * u, D = PROJ ? a.D : 0, L = a.L, M = a.M;
  float* emb_s = smem;             // [TM, D]  this step's embeddings (PROJ)
  float* h_s = emb_s + TM * D;     // [TM, u]  h carry
  float* a_s = h_s + TM * u;       // [TM, G]  gate pre-activations

  const int j = threadIdx.x;
  const int g = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const bool rev = g == a.rev_group;
  const T* wih_d = PROJ ? a.wih + (size_t)g * D * G : nullptr;
  const float* whh_d = a.whh + (size_t)g * u * G;
  const float bj = PROJ ? a.b[g * G + j] : 0.0f;
  const T* x_g = a.x + g * a.xv.group;

  float c[CPT];
#pragma unroll
  for (int q = 0; q < CPT; ++q) c[q] = 0.0f;
  for (int idx = j; idx < TM * u; idx += G) h_s[idx] = 0.0f;

  for (int s = 0; s < L; ++s) {
    const int t = rev ? L - 1 - s : s;
    // Kernel-last step of t's natural block: this step's state is its slot.
    const bool ckpt_step =
        MODE == kCkpt && (rev ? t % a.W == 0 : (t % a.W == a.W - 1 || t == L - 1));
    if constexpr (PROJ) stage_rows(emb_s, x_g, a.xv, t, row0, TM, M, D, j, G);
    __syncthreads();  // emb_s staged; h_s holds h_{s-1}

    gate_column<T, TM, PROJ>(a_s, h_s, emb_s, wih_d, bj, x_g + t * a.xv.time, a.xv.row, row0,
                             M, whh_d, D, u, j);
    __syncthreads();  // all pre-activations written, all reads of h_s done

#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int idx = j + q * G;
      const int r = idx / u, jj = idx - r * u;
      const float* ar = a_s + r * G;
      const float ig = sigmoidf(ar[jj]);
      const float fg = sigmoidf(ar[u + jj]);
      const float gg = tanhf(ar[2 * u + jj]);
      const float og = sigmoidf(ar[3 * u + jj]);
      c[q] = fg * c[q] + ig * gg;
      const float h = og * tanhf(c[q]);
      h_s[idx] = h;
      const int row = row0 + r;
      if (row < M) {
        const long long o = g * a.hv.group + row * a.hv.row + jj;
        a.hs[o + t * a.hv.time] = from_f32<T>(h);
        if (MODE == kFull) a.c1[o + t * a.hv.time] = from_f32<R>(c[q]);
        if (ckpt_step) {
          a.c1[o + (t / a.W) * a.hv.time] = from_f32<R>(h);
          a.c2[o + (t / a.W) * a.hv.time] = from_f32<R>(c[q]);
        }
      }
    }
    __syncthreads();  // h_s complete before the next step reads it
  }
}

template <typename T, typename R, bool PROJ, int MODE, int TM>
int launch_fwd(const FwdArgs<T, R>& a, int groups, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)TM * ((PROJ ? a.D : 0) + a.u + 4 * a.u);
  cudaError_t err = cudaFuncSetAttribute(lstm_fwd_kernel<T, R, PROJ, MODE, TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.M + TM - 1) / TM, groups);
  lstm_fwd_kernel<T, R, PROJ, MODE, TM><<<grid, 4 * a.u, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// --- backward -----------------------------------------------------------------

template <typename T, typename R>
struct BwdArgs {
  const T* dhs;      // view hv
  const T* x;        // PROJ: emb [L, M, D] (view xv, shared); else xg (view xv)
  const T* hs;       // full residuals: hs (view hv), the source of h_prev
  const R* c1;       // full residuals: cs (view hv); K8: ch
  const R* c2;       // K8: cc
  const T* wih;      // [Gc, D, 4u] (PROJ)
  const float* b;    // [Gc, 1, 4u] (PROJ)
  const float* whh;  // [Gc, u, 4u]
  T* dx;             // PROJ: demb [Gc, L, M, D] (group slab L*M*D, view xv); else dxg (view xv)
  float* dwih_p;     // [Gc, nT, D, 4u] (PROJ)
  float* db_p;       // [Gc, nT, 4u] (PROJ)
  float* dwhh_p;     // [Gc, nT, u, 4u]
  View xv, hv;
  int L, M, D, u, W, rev_group;
};

// Per-block state of a gradient sweep: the block's group and row tile, its
// weights, and the slices of the inputs and outputs it reads and owns.
template <typename T, typename R, bool PROJ>
struct Sweep {
  int row0, j, lane, warp, nwarps, G, D, u, M;
  View xv, hv;
  const T* wih_d;
  const float* whh_d;
  float bj;
  const T* dhs_g;
  const T* x_g;
  T* dx_g;
  float* dwih_t;
  float* dwhh_t;

  __device__ Sweep(const BwdArgs<T, R>& a, int TM) : xv(a.xv), hv(a.hv) {
    const int g = blockIdx.y, tile = blockIdx.x, nT = gridDim.x;
    j = threadIdx.x;
    lane = j & 31;
    warp = j >> 5;
    u = a.u;
    G = 4 * u;
    nwarps = G >> 5;
    D = PROJ ? a.D : 0;
    M = a.M;
    row0 = tile * TM;
    wih_d = PROJ ? a.wih + (size_t)g * D * G : nullptr;
    whh_d = a.whh + (size_t)g * u * G;
    bj = PROJ ? a.b[g * G + j] : 0.0f;
    dhs_g = a.dhs + g * a.hv.group;
    x_g = a.x + g * a.xv.group;
    dx_g = PROJ ? a.dx + (size_t)g * a.L * a.M * D : a.dx + g * a.xv.group;
    dwih_t = PROJ ? a.dwih_p + ((size_t)g * nT + tile) * D * G : nullptr;
    dwhh_t = a.dwhh_p + ((size_t)g * nT + tile) * u * G;
  }

  // Column j of the tile's weight-gradient slabs starts at zero.
  __device__ void zero_slabs() const {
    for (int k = 0; k < D; ++k) dwih_t[(size_t)k * G + j] = 0.0f;
    for (int k = 0; k < u; ++k) dwhh_t[(size_t)k * G + j] = 0.0f;
  }
};

// One gradient step at natural time t (ops/lstm.py:_bwd_kernel and
// _fused_bwd_kernel):
//   a     = [emb_t W_ih + b |  xg_t] + h_prev W_hh   (gates recomputed, f32)
//   dh_t  = dhs_t + dh_carry
//   da_o  = dh_t tanh(c_t) o(1-o)
//   dc_t  = dc_carry + dh_t o (1 - tanh(c_t)^2)
//   da_i  = dc_t g i(1-i);  da_g = dc_t i (1-g^2);  da_f = dc_t c_prev f(1-f)
//   PROJ: demb_t = da W_ih^T;  dW_ih += emb_t^T da;  db += sum_rows da
//   else: dxg_t = da
//   dW_hh += h_prev^T da;  dh_carry = da W_hh^T;  dc_carry = dc_t f
// Entry (after a barrier): emb_s (PROJ), hp, cp, ct [TM, u] f32 hold the
// step's embeddings, h_prev, c_prev and c_t; dh_s and dc the carries.
// Exit (after a barrier): the carries updated, the step's outputs written.
// Thread j owns column j of the tile's weight-gradient slabs (no atomics):
// an f32 dW_hh is 256 KiB at u = 128, more than a block's shared memory, so
// the slabs live in device memory (L2-resident at these sizes).
template <typename T, typename R, bool PROJ, int TM>
__device__ __forceinline__ void grad_step(const Sweep<T, R, PROJ>& w, int t, const float* hp,
                                          const float* cp, const float* ct, const float* emb_s,
                                          float* a_s, float* dh_s,
                                          float (&dc)[cells_per_thread(TM)], float& db_acc) {
  constexpr int CPT = cells_per_thread(TM);
  const int G = w.G, u = w.u, D = w.D, j = w.j, M = w.M, TU = TM * u;
  const View& xv = w.xv;
  const View& hv = w.hv;
  gate_column<T, TM, PROJ>(a_s, hp, emb_s, w.wih_d, w.bj, w.x_g + t * xv.time, xv.row, w.row0,
                           M, w.whh_d, D, u, j);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    const int idx = j + q * G;
    if (idx < TU) {
      const int r = idx / u, jj = idx - r * u;
      const int row = w.row0 + r;
      float* ar = a_s + r * G;
      const float ig = sigmoidf(ar[jj]);
      const float fg = sigmoidf(ar[u + jj]);
      const float gg = tanhf(ar[2 * u + jj]);
      const float og = sigmoidf(ar[3 * u + jj]);
      const float tc = tanhf(ct[idx]);
      const float dht =
          (row < M ? to_f32(w.dhs_g[row * hv.row + t * hv.time + jj]) : 0.0f) + dh_s[idx];
      const float dct = dc[q] + dht * og * (1.0f - tc * tc);
      ar[jj] = dct * gg * ig * (1.0f - ig);
      ar[u + jj] = dct * cp[idx] * fg * (1.0f - fg);
      ar[2 * u + jj] = dct * ig * (1.0f - gg * gg);
      ar[3 * u + jj] = dht * tc * og * (1.0f - og);
      dc[q] = dct * fg;
    }
  }
  __syncthreads();  // a_s holds da; every read of dh_s is done

  // PROJ: demb_t = da W_ih^T (columns k < D); dh_carry = da W_hh^T
  // (columns D..D+u): one warp per column, shuffle reductions.
  for (int k = w.warp; k < D + u; k += w.nwarps) {
    float acc[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) acc[r] = 0.0f;
    if (PROJ && k < D) {
      for (int jj = w.lane; jj < G; jj += 32) {
        const float wt = to_f32(w.wih_d[(size_t)k * G + jj]);
#pragma unroll
        for (int r = 0; r < TM; ++r) acc[r] = fmaf(a_s[r * G + jj], wt, acc[r]);
      }
    } else {
      for (int jj = w.lane; jj < G; jj += 32) {
        const float wt = w.whh_d[(size_t)(k - D) * G + jj];
#pragma unroll
        for (int r = 0; r < TM; ++r) acc[r] = fmaf(a_s[r * G + jj], wt, acc[r]);
      }
    }
    float mine = 0.0f;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const float v = warp_sum(acc[r]);
      if (w.lane == r) mine = v;
    }
    if (w.lane < TM) {
      const int row = w.row0 + w.lane;
      if (k < D) {
        if (row < M) w.dx_g[row * xv.row + t * xv.time + k] = from_f32<T>(mine);
      } else {
        dh_s[w.lane * u + (k - D)] = mine;
      }
    }
  }

  if constexpr (PROJ) {
    float dsum = 0.0f;
#pragma unroll
    for (int r = 0; r < TM; ++r) dsum += a_s[r * G + j];
    db_acc += dsum;
    for (int k = 0; k < D; ++k) {
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < TM; ++r) s = fmaf(emb_s[r * D + k], a_s[r * G + j], s);
      w.dwih_t[(size_t)k * G + j] += s;
    }
  } else {
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int row = w.row0 + r;
      if (row < M) w.dx_g[row * xv.row + t * xv.time + j] = from_f32<T>(a_s[r * G + j]);
    }
  }
  for (int k = 0; k < u; ++k) {
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < TM; ++r) s = fmaf(hp[r * u + k], a_s[r * G + j], s);
    w.dwhh_t[(size_t)k * G + j] += s;
  }
  __syncthreads();  // a_s, emb_s, dh_s and the states are reused next step
}

// --- backward over saved full residual streams (K6, kernel 3) ---------------

// Shared memory of lstm_resid_bwd_kernel: h_prev, c_prev, c_t and the dh
// carry [TM, u] each, the step's embeddings [TM, D] (PROJ), the gates [TM, 4u].
inline size_t resid_bwd_smem(int TM, int D, int u) {
  return sizeof(float) * ((size_t)4 * TM * u + (size_t)TM * D + (size_t)TM * 4 * u);
}

// Kernel-reverse walk of one group over the forward's saved streams: at
// kernel step s (natural t) c_t comes from cs at t, and h_prev, c_prev from
// hs and cs at the kernel-previous step (natural t-1, or t+1 for the
// reversed group), masked to the zero initial state at s = 0. These are the
// stored, rounded values (hs in its dtype, cs in the residual dtype), not
// f32 carries, as in the Pallas kernels.
template <typename T, typename R, bool PROJ, int TM>
__global__ void __launch_bounds__(MAX_THREADS) lstm_resid_bwd_kernel(BwdArgs<T, R> a) {
  constexpr int CPT = cells_per_thread(TM);
  extern __shared__ float smem[];
  const Sweep<T, R, PROJ> w(a, TM);
  const int u = w.u, G = w.G, j = w.j, L = a.L, M = a.M, TU = TM * u;
  float* hp = smem;               // [TM, u]
  float* cp = hp + TU;            // [TM, u]
  float* ct = cp + TU;            // [TM, u]
  float* dh_s = ct + TU;          // [TM, u]  dh carry
  float* emb_s = dh_s + TU;       // [TM, D]  (PROJ)
  float* a_s = emb_s + TM * w.D;  // [TM, 4u] gates, then da

  const bool rev = (int)blockIdx.y == a.rev_group;
  const T* hs_g = a.hs + blockIdx.y * a.hv.group;
  const R* cs_g = a.c1 + blockIdx.y * a.hv.group;
  w.zero_slabs();
  float db_acc = 0.0f;
  float dc[CPT];
#pragma unroll
  for (int q = 0; q < CPT; ++q) dc[q] = 0.0f;
  for (int idx = j; idx < TU; idx += G) dh_s[idx] = 0.0f;

  for (int s = L - 1; s >= 0; --s) {
    const int t = rev ? L - 1 - s : s;
    const int tp = rev ? t + 1 : t - 1;
    for (int idx = j; idx < TU; idx += G) {
      const int r = idx / u, jj = idx - r * u;
      const int row = w.row0 + r;
      const long long o = row * a.hv.row + jj;
      const bool live = row < M;
      ct[idx] = live ? to_f32(cs_g[o + t * a.hv.time]) : 0.0f;
      hp[idx] = live && s > 0 ? to_f32(hs_g[o + tp * a.hv.time]) : 0.0f;
      cp[idx] = live && s > 0 ? to_f32(cs_g[o + tp * a.hv.time]) : 0.0f;
    }
    if constexpr (PROJ) stage_rows(emb_s, a.x, a.xv, t, w.row0, TM, M, w.D, j, G);
    __syncthreads();  // the step's states and embeddings staged
    grad_step<T, R, PROJ, TM>(w, t, hp, cp, ct, emb_s, a_s, dh_s, dc, db_acc);
  }
  if constexpr (PROJ) a.db_p[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * G + j] = db_acc;
}

template <typename T, typename R, bool PROJ, int TM>
int launch_resid_bwd(const BwdArgs<T, R>& a, int groups, cudaStream_t stream) {
  const size_t smem = resid_bwd_smem(TM, PROJ ? a.D : 0, a.u);
  cudaError_t err = cudaFuncSetAttribute(lstm_resid_bwd_kernel<T, R, PROJ, TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.M + TM - 1) / TM, groups);
  lstm_resid_bwd_kernel<T, R, PROJ, TM><<<grid, 4 * a.u, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace lstm
