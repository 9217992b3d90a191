// Shared device code of the LSTM kernels (sm_90a): the cluster forward body
// behind K1, K7, K4 and kernels 1/2 (lstm_cluster_fwd_kernel), the gradient
// step behind K8, K6 and kernel 3, and the kernel that walks saved full
// residual streams (K6 and kernel 3). Each .cu source includes this header
// and instantiates only the templates its launchers use.
//
// Layout. A tensor of one group g (a BiLSTM direction) is addressed as
//   base + g * View::group + row * View::row + t * View::time + column,
// so one body serves the fused encoder's [L, M, *] streams (both directions
// in one row, natural time), the split recurrence's time-major
// [L, M, Gc*4u] input and its grouped [Gc, M, L, 4u] one, with no copy.
// One group (rev_group) walks natural time backwards: kernel step s reads
// and writes natural time L-1-s.
//
// Block shape: the forward runs one thread-block cluster per (row tile,
// group), described at its kernel below. The backward kernels run one
// block per (row tile of TM rows, group); 4u threads, thread j owning gate
// column j (gate_column). Gate pre-activations
// accumulate in f32 (bf16 products are exact in f32); h, c and their
// gradients are carried in f32. Rows past M read zeros and write nothing,
// so the ragged last tile needs no padded copy.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

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

// --- forward: one thread-block cluster per (row tile, group) ------------------
//
// An f32 W_hh is 256 KiB per direction, more than a CTA's shared memory, so
// the body splits a group's 4u gate columns over a cluster of C CTAs (C = 8
// at u = 128). CTA c owns units [c u/C, (c+1) u/C) and all four gate columns
// of each (i, f, g, o at j, u+j, 2u+j, 3u+j), so the cell update and the c
// carries stay local. Before the time loop it copies its slice of W_hh
// (cp.async; f32, 32 KiB at C = 8), of W_ih (converted to f32) and of b
// into shared memory, where they stay for all L steps. Per step:
//   1. gates: the [TM, u] x [u, NC] product (NC = 4u/C) on 256 threads, each
//      owning a 4-row x 4-column micro-tile over a 1/S slice of k (split-K):
//      two 16-byte shared loads (h of 4 rows, W_hh of 4 columns) feed 16
//      FMAs. The k-slice-0 thread starts from the step's input gates.
//   2. cells: a thread owns one (row, unit) cell per 256 cells; c stays in
//      its registers. It sums the S partials; four lanes gather the new h of
//      4 rows of one unit and one of them stores the float4 into its own h
//      buffer of the next parity and, with st.async, into every other CTA's
//      (distributed shared memory). Each st.async completes its bytes on
//      the receiving CTA's mbarrier of that parity, so no CTA fences or
//      waits on a cluster barrier per step: a CTA waits only until its
//      mbarrier has seen the (C-1) u/C x TM values of its peers.
//   3. hs (and the residuals) to global memory; then the next step's input
//      gates, which do not depend on h (emb_t' W_ih + b from embedding rows
//      loaded into registers at the top of the step, or xg read in place);
//      then the mbarrier wait.
// Reuse of an h buffer is safe without a barrier: a CTA writes parity p^1
// at step s only after it received every peer's h of step s-1, which each
// peer sent after its own gate phase of step s-1 had read p^1.
// The h carry is f32 and never rounded between steps; gate pre-activations
// accumulate in f32; only the summation order of the gate sums differs
// from the plain version.
//
// What bounds it: the L-step chain. No phase is bound by bytes or by the
// FP32 rate; each is a few hundred dependent instructions per thread with 8
// warps per SM to hide them: the gate product, the cells with the exchange,
// and the next step's input gates, which every CTA computes itself (so they
// lengthen the step instead of hiding behind the exchange). FWD_PHASE marks
// the phases for kernels/fwd_phases.py.

// Clock cycles per phase of one thread of the forward, summed over launches:
// compiled in only with -DLSTM_PHASES (kernels/fwd_phases.py builds such a
// copy and reads fwd_phase_cycles); the thread is thread LSTM_PHASES_TID of
// CTA (LSTM_PHASES_CTA, 0). FWD_PHASE(i) adds the cycles since the previous
// mark to slot i.
#ifdef LSTM_PHASES
#ifndef LSTM_PHASES_CTA
#define LSTM_PHASES_CTA 0
#endif
#ifndef LSTM_PHASES_TID
#define LSTM_PHASES_TID 0
#endif
__device__ unsigned long long fwd_phase_cycles[8];
#define FWD_PHASE_START long long phase_t = clock64()
#define FWD_PHASE(i)                                                                  \
  do {                                                                                \
    if (blockIdx.x == LSTM_PHASES_CTA && blockIdx.y == 0 &&                           \
        threadIdx.x == LSTM_PHASES_TID) {                                             \
      const long long now = clock64();                                                \
      fwd_phase_cycles[i] += (unsigned long long)(now - phase_t);                     \
      phase_t = now;                                                                  \
    }                                                                                 \
  } while (0)
#else
#define FWD_PHASE_START
#define FWD_PHASE(i) \
  do {               \
  } while (0)
#endif

// What the forward writes besides hs: nothing (K1, kernel 2), one (h, c)
// checkpoint pair per W-step natural block (K7), or c at every step (K4,
// kernel 1).
enum Residuals { kNone = 0, kCkpt = 1, kFull = 2 };

constexpr int FWD_THREADS = 256;
constexpr int CELLS = 4;  // cells a thread may own: TM * u / C <= 4 * 256
constexpr int PF = 8;     // input values a thread loads ahead a step
constexpr size_t SMEM_LIMIT = 232448;  // a block's dynamic shared memory on an H100

// Split-K factor of the gate product: 256 threads over (TM/4) x (NC/4) tiles.
__host__ __device__ inline int fwd_splits(int TM, int C, int u) {
  return FWD_THREADS / (TM * (4 * u / C) / 16);
}

// Split of the projection over D: 256 threads over (TM/2) x (NC/4) tiles of
// 2 rows x 4 columns, each over a 1/P slice of D (1 without projection).
__host__ __device__ inline int fwd_psplits(int TM, int C, int D, int u) {
  if (D == 0) return 1;
  const int p = FWD_THREADS / (TM / 2 * (u / C));
  return p < 1 ? 1 : (p > D ? D : p);
}

// Shared memory of lstm_cluster_fwd_kernel in bytes (ops/lstm.py:fwd_smem):
// two mbarriers (16 bytes); W_hh slice [u, NC]; W_ih slice [D, NC] and b
// [NC] (D = 0 without the projection); two h buffers [u, TM + 4]; the
// step's input gates [P, TM, NC]; the split-K partials [S, TM, NC + 8]; the
// staged embeddings [D, TM + 2]. The paddings spread the cell phase's loads
// and stores over the banks.
inline size_t fwd_smem(int TM, int C, int D, int u) {
  const size_t NC = 4 * (size_t)u / C;
  return 16 + sizeof(float) * (u * NC + D * NC + (D ? NC : 0) + 2 * (size_t)u * (TM + 4) +
                               fwd_psplits(TM, C, D, u) * TM * NC +
                               fwd_splits(TM, C, u) * TM * (NC + 8) + (size_t)D * (TM + 2));
}

// The plans the body takes (ops/lstm.py:fwd_plan picks one): TM a multiple
// of 4, C in 1..8 dividing u, at most 256 gate tiles and 4 cells a thread.
inline bool fwd_plan_ok(int TM, int C, int D, int u) {
  if (TM < 4 || TM % 4 || C < 1 || C > 8 || u < C || u % C) return false;
  const int tiles = TM * (4 * u / C) / 16, cells = TM * (u / C);
  return tiles <= FWD_THREADS && cells <= CELLS * FWD_THREADS &&
         fwd_smem(TM, C, D, u) <= SMEM_LIMIT;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// The address of the same shared-memory location in CTA `rank` of the cluster.
__device__ __forceinline__ unsigned map_rank(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Wait for the phase of `bar` with the given parity to complete. A peer
// that never delivers traps (the launch then fails) instead of hanging.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  for (unsigned spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 24)) __trap();
  }
}
// 16 bytes into another CTA's shared memory, completing on its mbarrier.
__device__ __forceinline__ void st_async4(unsigned addr, float4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fma4(float (&acc)[4], float x, const float4& w) {
  acc[0] = fmaf(x, w.x, acc[0]);
  acc[1] = fmaf(x, w.y, acc[1]);
  acc[2] = fmaf(x, w.z, acc[2]);
  acc[3] = fmaf(x, w.w, acc[3]);
}

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

// Grid (ceil(M/TM) * C, groups), clusters of (C, 1, 1): blockIdx.x / C is
// the row tile, the cluster rank the CTA's unit slice; 256 threads.
template <typename T, typename R, bool PROJ, int MODE>
__global__ void __launch_bounds__(FWD_THREADS)
    lstm_cluster_fwd_kernel(FwdArgs<T, R> a, int TM, int C) {
  FWD_PHASE_START;
  const int c = (int)cooperative_groups::this_cluster().block_rank();
  const int u = a.u, G = 4 * u, UC = u / C, NC = 4 * UC, NB = NC / 4;
  const int D = PROJ ? a.D : 0, L = a.L, M = a.M;
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = blockIdx.y;
  const int row0 = (blockIdx.x / C) * TM;
  const bool rev = g == a.rev_group;
  const int S = fwd_splits(TM, C, u), P = fwd_psplits(TM, C, D, u);
  const int HS = TM + 4, RS = NC + 8, ES = TM + 2;  // padded row strides

  extern __shared__ __align__(16) float smem[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);  // [2] by parity
  float* whh_s = smem + 4;               // [u, NC]     W_hh slice
  float* wih_s = whh_s + u * NC;         // [D, NC]     W_ih slice (PROJ)
  float* b_s = wih_s + D * NC;           // [NC]        b slice (PROJ)
  float* h_s = b_s + (PROJ ? NC : 0);    // [2][u, HS]  h by step parity, k-major
  float* xp_s = h_s + 2 * u * HS;        // [P, TM, NC] the step's input gates (P partials)
  float* red_s = xp_s + P * TM * NC;     // [S, TM, RS] split-K partials
  float* emb_s = red_s + S * TM * RS;    // [D, ES]     staged embeddings (PROJ)

  // Global gate column of local column q.
  auto gcol = [&](int q) {
    const int gate = q / UC;
    return gate * u + c * UC + (q - gate * UC);
  };

  // Prologue: the CTA's weight slices into shared memory, h_{-1} = 0, the
  // mbarriers, then a cluster barrier (every CTA started and initialised).
  const float* whh_g = a.whh + (size_t)g * u * G;
  for (int idx = tid; idx < u * NC; idx += FWD_THREADS) {
    const int k = idx / NC, q = idx - k * NC;
    __pipeline_memcpy_async(whh_s + idx, whh_g + (size_t)k * G + gcol(q), sizeof(float));
  }
  __pipeline_commit();
  if constexpr (PROJ) {
    const T* wih_g = a.wih + (size_t)g * D * G;
    for (int idx = tid; idx < D * NC; idx += FWD_THREADS) {
      const int k = idx / NC, q = idx - k * NC;
      wih_s[idx] = to_f32(wih_g[(size_t)k * G + gcol(q)]);
    }
    for (int q = tid; q < NC; q += FWD_THREADS) b_s[q] = a.b[g * G + gcol(q)];
  }
  for (int idx = tid; idx < u * HS; idx += FWD_THREADS) h_s[idx] = 0.0f;
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  FWD_PHASE(0);  // prologue

  // The next step's inputs are loaded into registers at the top of a step
  // (PF per thread, raw), so their latency hides behind the gate and cell
  // phases; project() converts and stores them, then computes.
  const T* x_g = a.x + g * a.xv.group;
  const int NIN = PROJ ? TM * D : TM * NC;  // input values a step
  auto in_offset = [&](int idx) -> long long {  // -1: a row past M
    if constexpr (PROJ) {
      const int r = idx / D;
      return row0 + r < M ? (row0 + r) * a.xv.row + (idx - r * D) : -1;
    } else {
      const int r = idx / NC;
      return row0 + r < M ? (row0 + r) * a.xv.row + gcol(idx - r * NC) : -1;
    }
  };
  auto store_in = [&](int idx, float v) {
    if constexpr (PROJ) {
      const int r = idx / D;
      emb_s[(idx - r * D) * ES + r] = v;
    } else {
      xp_s[idx] = v;
    }
  };
  long long pf_off[PF];
#pragma unroll
  for (int i = 0; i < PF; ++i) {
    const int idx = tid + i * FWD_THREADS;
    pf_off[i] = idx < NIN ? in_offset(idx) : -1;
  }
  T pf[PF];
  auto prefetch = [&](int t) {
#pragma unroll
    for (int i = 0; i < PF; ++i)
      pf[i] = pf_off[i] >= 0 ? x_g[pf_off[i] + t * a.xv.time] : from_f32<T>(0.0f);
  };
  // Input gates of natural time t (prefetched) into xp_s.
  auto project = [&](int t) {
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int idx = tid + i * FWD_THREADS;
      if (idx < NIN) store_in(idx, to_f32(pf[i]));
    }
    for (int idx = tid + PF * FWD_THREADS; idx < NIN; idx += FWD_THREADS) {
      const long long o = in_offset(idx);
      store_in(idx, o >= 0 ? to_f32(x_g[o + t * a.xv.time]) : 0.0f);
    }
    if constexpr (PROJ) {
      __syncthreads();
      const int PT = TM / 2 * NB, KD = (D + P - 1) / P;
      for (int qd = tid; qd < PT * P; qd += FWD_THREADS) {
        const int p = qd / PT, rem = qd - p * PT;
        const int r = rem / NB * 2, cq = (rem - rem / NB * NB) * 4;
        float acc0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, acc1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (p == 0) {
          const float4 bv = *reinterpret_cast<const float4*>(b_s + cq);
          acc0[0] = acc1[0] = bv.x; acc0[1] = acc1[1] = bv.y;
          acc0[2] = acc1[2] = bv.z; acc0[3] = acc1[3] = bv.w;
        }
        const int kb = p * KD, ke = min(D, kb + KD);
#pragma unroll 4
        for (int k = kb; k < ke; ++k) {
          const float2 e = *reinterpret_cast<const float2*>(emb_s + k * ES + r);
          const float4 w = *reinterpret_cast<const float4*>(wih_s + k * NC + cq);
          fma4(acc0, e.x, w);
          fma4(acc1, e.y, w);
        }
        float* xo = xp_s + (p * TM + r) * NC + cq;
        *reinterpret_cast<float4*>(xo) = make_float4(acc0[0], acc0[1], acc0[2], acc0[3]);
        *reinterpret_cast<float4*>(xo + NC) = make_float4(acc1[0], acc1[1], acc1[2], acc1[3]);
      }
    }
    __syncthreads();
  };

  // Gate tile of this thread: rows rb*4.., columns cb*4.., k in [k0, k1).
  const int tiles = TM / 4 * NB;
  const int kg = tid / tiles, tile = tid - kg * tiles;
  const int rb = tile / NB, cb = tile - rb * NB;
  const int KS = (u + S - 1) / S;
  const int k0 = kg * KS, k1 = min(u, k0 + KS);
  // Cells of this thread: e = tid + i * 256 < TM * UC is (row r4 * 4 + e % 4,
  // local unit (e / 4) % UC), r4 = e / (4 UC): four consecutive lanes hold
  // 4 rows of one unit. The c carries stay in registers.
  const int NCELL = TM * UC;
  // Bytes a CTA receives from its peers a step, and the exchange addresses.
  const unsigned rx_bytes = (unsigned)((C - 1) * UC * TM * sizeof(float));
  float cst[CELLS], hv[CELLS];
#pragma unroll
  for (int i = 0; i < CELLS; ++i) cst[i] = hv[i] = 0.0f;

  prefetch(rev ? L - 1 : 0);
  project(rev ? L - 1 : 0);
  cluster_arrive();  // every CTA of the cluster has started and set up
  cluster_wait();
  FWD_PHASE(1);  // the first step's input gates and the cluster barrier

  for (int s = 0; s < L; ++s) {
    const int t = rev ? L - 1 - s : s;
    const bool more = s + 1 < L;
    const int pn = (s & 1) ^ 1;  // parity of the buffer this step writes
    const float* hc = h_s + (s & 1) * u * HS;
    float* hn = h_s + pn * u * HS;
    if (more) {
      prefetch(rev ? L - 2 - s : s + 1);
      if (tid == 0) mbar_expect_tx(&bars[pn], rx_bytes);
    }

    if (kg < S) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (kg == 0)
          for (int p = 0; p < P; ++p) {
            const float4 v =
                *reinterpret_cast<const float4*>(xp_s + (p * TM + rb * 4 + i) * NC + cb * 4);
            x.x += v.x; x.y += v.y; x.z += v.z; x.w += v.w;
          }
        acc[i][0] = x.x; acc[i][1] = x.y; acc[i][2] = x.z; acc[i][3] = x.w;
      }
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        const float4 h4 = *reinterpret_cast<const float4*>(hc + k * HS + rb * 4);
        const float4 w4 = *reinterpret_cast<const float4*>(whh_s + k * NC + cb * 4);
        fma4(acc[0], h4.x, w4);
        fma4(acc[1], h4.y, w4);
        fma4(acc[2], h4.z, w4);
        fma4(acc[3], h4.w, w4);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(red_s + (kg * TM + rb * 4 + i) * RS + cb * 4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    FWD_PHASE(2);  // gates
    __syncthreads();  // every partial written
    FWD_PHASE(3);

#pragma unroll
    for (int i = 0; i < CELLS; ++i) {
      const int e = tid + i * FWD_THREADS;
      const int rr = e & 3, jl = (e >> 2) % UC, r4 = (e >> 2) / UC, r = r4 * 4 + rr;
      if (e < NCELL) {
        float ai = 0.0f, af = 0.0f, ag = 0.0f, ao = 0.0f;
        for (int p = 0; p < S; ++p) {
          const float* pr = red_s + (p * TM + r) * RS + jl;
          ai += pr[0];
          af += pr[UC];
          ag += pr[2 * UC];
          ao += pr[3 * UC];
        }
        const float ig = sigmoidf(ai), fg = sigmoidf(af), gg = tanhf(ag), og = sigmoidf(ao);
        cst[i] = fg * cst[i] + ig * gg;
        hv[i] = og * tanhf(cst[i]);
      }
      if (i * FWD_THREADS < NCELL && more) {  // uniform over the block
        const int src = lane & ~3;
        const float4 h4 = make_float4(__shfl_sync(0xffffffffu, hv[i], src),
                                      __shfl_sync(0xffffffffu, hv[i], src + 1),
                                      __shfl_sync(0xffffffffu, hv[i], src + 2),
                                      __shfl_sync(0xffffffffu, hv[i], src + 3));
        if (e < NCELL && rr == 0) {
          float* dst = hn + (c * UC + jl) * HS + r4 * 4;
          *reinterpret_cast<float4*>(dst) = h4;
          const unsigned la = smem_addr(dst), lb = smem_addr(&bars[pn]);
          for (int q = 1; q < C; ++q) {
            const int peer = (c + q) % C;
            st_async4(map_rank(la, peer), h4, map_rank(lb, peer));
          }
        }
      }
    }
    FWD_PHASE(4);  // cells and the h exchange

    const bool ckpt_step =  // kernel-last step of t's natural block: its slot
        MODE == kCkpt && (rev ? t % a.W == 0 : (t % a.W == a.W - 1 || t == L - 1));
#pragma unroll
    for (int i = 0; i < CELLS; ++i) {
      const int e = tid + i * FWD_THREADS;
      const int r = (e >> 2) / UC * 4 + (e & 3), row = row0 + r;
      if (e < NCELL && row < M) {
        const long long o = g * a.hv.group + row * a.hv.row + c * UC + (e >> 2) % UC;
        a.hs[o + t * a.hv.time] = from_f32<T>(hv[i]);
        if (MODE == kFull) a.c1[o + t * a.hv.time] = from_f32<R>(cst[i]);
        if (ckpt_step) {
          a.c1[o + (t / a.W) * a.hv.time] = from_f32<R>(hv[i]);
          a.c2[o + (t / a.W) * a.hv.time] = from_f32<R>(cst[i]);
        }
      }
    }
    FWD_PHASE(5);  // hs and residual stores
    if (more) {
      project(rev ? L - 2 - s : s + 1);  // ends with a block barrier: hn's local part is in
      FWD_PHASE(6);
      mbar_wait(&bars[pn], (unsigned)(s >> 1) & 1u);  // every peer's part is in
      FWD_PHASE(7);
    }
  }
  cluster_arrive();  // no CTA leaves while a peer may still address its memory
  cluster_wait();
}

// Launch the cluster forward with row tile TM and cluster size C (the
// caller's plan, ops/lstm.py:fwd_plan). A plan the body cannot take is
// refused with cudaErrorInvalidValue, a cluster that cannot be resident
// with cudaErrorLaunchOutOfResources, before anything is launched.
template <typename T, typename R, bool PROJ, int MODE>
int launch_fwd(const FwdArgs<T, R>& a, int groups, int TM, int C, cudaStream_t stream) {
  const int D = PROJ ? a.D : 0;
  if (!fwd_plan_ok(TM, C, D, a.u)) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(TM, C, D, a.u);
  void (*kernel)(FwdArgs<T, R>, int, int) = lstm_cluster_fwd_kernel<T, R, PROJ, MODE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((a.M + TM - 1) / TM) * C, groups, 1);
  cfg.blockDim = dim3(FWD_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kernel, a, TM, C);
  if (err != cudaSuccess) return (int)err;
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
