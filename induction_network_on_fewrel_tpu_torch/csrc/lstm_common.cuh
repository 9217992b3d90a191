// Shared device code of the LSTM kernels (sm_90a): the cluster forward body
// behind K1, K7, K4 and kernels 1/2 (lstm_cluster_fwd_kernel) and the
// cluster backward body behind K8, K6 and kernel 3 (lstm_cluster_bwd_kernel,
// the gradient chain; the weight gradients are csrc/lstm_wgrad.cu's). Each
// .cu source includes this header and instantiates only the templates its
// launchers use.
//
// Layout. A tensor of one group g (a BiLSTM direction) is addressed as
//   base + g * View::group + row * View::row + t * View::time + column,
// so one body serves the fused encoder's [L, M, *] streams (both directions
// in one row, natural time), the split recurrence's time-major
// [L, M, Gc*4u] input and its grouped [Gc, M, L, 4u] one, with no copy.
// One group (rev_group) walks natural time backwards: kernel step s reads
// and writes natural time L-1-s.
//
// Both bodies run one thread-block cluster per (row tile, group), described
// at the forward kernel below. Gate pre-activations accumulate in f32
// (bf16 products are exact in f32); h, c and their gradients are carried in
// f32. Rows past M read zeros and write nothing, so the ragged last tile
// needs no padded copy.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <mutex>
#include <vector>

namespace lstm {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

struct View {
  long long group, row, time;
};

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

// Floats of shared memory that one CTA's forward step takes (after the
// mbarriers): W_hh slice [u, NC]; W_ih slice [D, NC] and b [NC] (D = 0
// without the projection); two h buffers [u, HS]; the step's input gates
// [P, TM, NC]; the split-K partials [S, TM, NC + 8]; the staged embeddings
// [D, TM + 2], rounded up to 16 bytes. HS is the row stride of the h
// buffers.
__host__ __device__ inline size_t fwd_core_floats(int TM, int C, int D, int u, int HS) {
  const size_t NC = 4 * (size_t)u / C;
  return u * NC + D * NC + (D ? NC : 0) + 2 * (size_t)u * HS + fwd_psplits(TM, C, D, u) * TM * NC +
         fwd_splits(TM, C, u) * TM * (NC + 8) + ((size_t)D * (TM + 2) + 3) / 4 * 4;
}

// Shared memory of lstm_cluster_fwd_kernel in bytes (ops/lstm.py:fwd_smem):
// two mbarriers (16 bytes) and the forward step's floats with h buffers of
// row stride TM + 4. The paddings spread the cell phase's loads and stores
// over the banks.
inline size_t fwd_smem(int TM, int C, int D, int u) {
  return 16 + sizeof(float) * fwd_core_floats(TM, C, D, u, TM + 4);
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

// One CTA's part of a cluster forward step: its shared-memory carve-up, its
// thread mappings and the step's phases. lstm_cluster_fwd_kernel runs it
// over the sequence; lstm_cluster_bwd_kernel runs it to replay a window.
template <typename T, bool PROJ>
struct FwdCore {
  int c, C, u, UC, NC, NB, D, M, TM, S, P, HS, RS, ES, tid, lane, row0, NIN, NCELL;
  int kg, rb, cb, k0, k1;  // gate tile: rows rb*4.., columns cb*4.., k in [k0, k1)
  unsigned rx_bytes;       // bytes a CTA receives from its peers a step
  float *whh_s, *wih_s, *b_s, *h_s, *xp_s, *red_s, *emb_s;
  const T* x_g;
  View xv;
  long long pf_off[PF];
  T pf[PF];
  float cst[CELLS], hv[CELLS];  // c and h of the thread's cells
  int cr[CELLS], cj[CELLS];     // row and local unit of the thread's cells

  // base: the shared memory after the mbarriers; g: the group.
  __device__ __forceinline__ FwdCore(float* base, const T* x, View xv_, int g, int u_, int D_,
                                     int M_, int TM_, int C_, int HS_)
      : C(C_), u(u_), D(PROJ ? D_ : 0), M(M_), TM(TM_), HS(HS_), xv(xv_) {
    c = (int)cooperative_groups::this_cluster().block_rank();
    UC = u / C;
    NC = 4 * UC;
    NB = NC / 4;
    tid = threadIdx.x;
    lane = tid & 31;
    row0 = (blockIdx.x / C) * TM;
    S = fwd_splits(TM, C, u);
    P = fwd_psplits(TM, C, D, u);
    RS = NC + 8;
    ES = TM + 2;
    whh_s = base;                    // [u, NC]     W_hh slice
    wih_s = whh_s + u * NC;          // [D, NC]     W_ih slice (PROJ)
    b_s = wih_s + D * NC;            // [NC]        b slice (PROJ)
    h_s = b_s + (PROJ ? NC : 0);     // [2][u, HS]  h by step parity, k-major
    xp_s = h_s + 2 * u * HS;         // [P, TM, NC] the step's input gates (P partials)
    red_s = xp_s + P * TM * NC;      // [S, TM, RS] split-K partials
    emb_s = red_s + S * TM * RS;     // [D, ES]     staged embeddings (PROJ)
    x_g = x + g * xv.group;
    NIN = PROJ ? TM * D : TM * NC;
    const int tiles = TM / 4 * NB;
    kg = tid / tiles;
    const int tile = tid - kg * tiles;
    rb = tile / NB;
    cb = tile - rb * NB;
    const int KS = (u + S - 1) / S;
    k0 = kg * KS;
    k1 = min(u, k0 + KS);
    // Cells: e = tid + i * 256 < TM * UC is (row (e / 4 UC) * 4 + e % 4,
    // local unit (e / 4) % UC): four consecutive lanes hold 4 rows of one unit.
    NCELL = TM * UC;
    rx_bytes = (unsigned)((C - 1) * UC * TM * sizeof(float));
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int idx = tid + i * FWD_THREADS;
      pf_off[i] = idx < NIN ? in_offset(idx) : -1;
    }
#pragma unroll
    for (int i = 0; i < CELLS; ++i) {
      const int e = tid + i * FWD_THREADS;
      cst[i] = hv[i] = 0.0f;
      cr[i] = (e >> 2) / UC * 4 + (e & 3);
      cj[i] = (e >> 2) % UC;
    }
  }

  // The first float after the carve-up (16-byte aligned).
  __device__ __forceinline__ float* end() const { return emb_s + (D * ES + 3) / 4 * 4; }

  // Global gate column of local column q.
  __device__ __forceinline__ int gcol(int q) const {
    const int gate = q / UC;
    return gate * u + c * UC + (q - gate * UC);
  }

  // The CTA's weight slices into shared memory (W_hh by cp.async: the
  // caller waits with __pipeline_wait_prior(0)).
  __device__ __forceinline__ void load_weights(const T* wih, const float* b, const float* whh,
                                               int g) {
    const int G = 4 * u;
    const float* whh_g = whh + (size_t)g * u * G;
    for (int idx = tid; idx < u * NC; idx += FWD_THREADS) {
      const int k = idx / NC, q = idx - k * NC;
      __pipeline_memcpy_async(whh_s + idx, whh_g + (size_t)k * G + gcol(q), sizeof(float));
    }
    __pipeline_commit();
    if constexpr (PROJ) {
      const T* wih_g = wih + (size_t)g * D * G;
      for (int idx = tid; idx < D * NC; idx += FWD_THREADS) {
        const int k = idx / NC, q = idx - k * NC;
        wih_s[idx] = to_f32(wih_g[(size_t)k * G + gcol(q)]);
      }
      for (int q = tid; q < NC; q += FWD_THREADS) b_s[q] = b[g * G + gcol(q)];
    }
  }

  // The next step's inputs are loaded into registers at the top of a step
  // (PF per thread, raw), so their latency hides behind the gate and cell
  // phases; project() converts and stores them, then computes.
  __device__ __forceinline__ long long in_offset(int idx) const {  // -1: a row past M
    if constexpr (PROJ) {
      const int r = idx / D;
      return row0 + r < M ? (row0 + r) * xv.row + (idx - r * D) : -1;
    } else {
      const int r = idx / NC;
      return row0 + r < M ? (row0 + r) * xv.row + gcol(idx - r * NC) : -1;
    }
  }
  __device__ __forceinline__ void store_in(int idx, float v) {
    if constexpr (PROJ) {
      const int r = idx / D;
      emb_s[(idx - r * D) * ES + r] = v;
    } else {
      xp_s[idx] = v;
    }
  }
  __device__ __forceinline__ void prefetch(int t) {
#pragma unroll
    for (int i = 0; i < PF; ++i)
      pf[i] = pf_off[i] >= 0 ? x_g[pf_off[i] + t * xv.time] : from_f32<T>(0.0f);
  }
  // Input gates of natural time t (prefetched) into xp_s; ends with a
  // block barrier.
  __device__ __forceinline__ void project(int t) {
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int idx = tid + i * FWD_THREADS;
      if (idx < NIN) store_in(idx, to_f32(pf[i]));
    }
    for (int idx = tid + PF * FWD_THREADS; idx < NIN; idx += FWD_THREADS) {
      const long long o = in_offset(idx);
      store_in(idx, o >= 0 ? to_f32(x_g[o + t * xv.time]) : 0.0f);
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
  }

  // The gate product from h buffer hc: the thread's 4x4 tile over its k
  // slice into red_s (the k-slice-0 thread starts from the input gates).
  __device__ __forceinline__ void gates(const float* hc) {
    if (kg >= S) return;
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

  // The four gate activations of the thread's cell i (after the block
  // barrier that follows gates()): the split-K partials summed in slice order.
  __device__ __forceinline__ void activations(int i, float& ig, float& fg, float& gg,
                                              float& og) const {
    const int r = cr[i], jl = cj[i];
    float ai = 0.0f, af = 0.0f, ag = 0.0f, ao = 0.0f;
    for (int p = 0; p < S; ++p) {
      const float* pr = red_s + (p * TM + r) * RS + jl;
      ai += pr[0];
      af += pr[UC];
      ag += pr[2 * UC];
      ao += pr[3 * UC];
    }
    ig = sigmoidf(ai);
    fg = sigmoidf(af);
    gg = tanhf(ag);
    og = sigmoidf(ao);
  }

  // Cells: c and h of every cell of the thread; at_cell(i, e, ig, fg, gg,
  // og) sees each cell's gates after its update (cst[i], hv[i] new). With
  // `more`, the new h goes into the thread's own buffer hn and, by
  // st.async, into every peer's, completing on that peer's `bar`.
  template <typename F>
  __device__ __forceinline__ void cells(float* hn, unsigned long long* bar, bool more,
                                        F&& at_cell) {
#pragma unroll
    for (int i = 0; i < CELLS; ++i) {
      const int e = tid + i * FWD_THREADS;
      if (e < NCELL) {
        float ig, fg, gg, og;
        activations(i, ig, fg, gg, og);
        cst[i] = fg * cst[i] + ig * gg;
        hv[i] = og * tanhf(cst[i]);
        at_cell(i, e, ig, fg, gg, og);
      }
      if (i * FWD_THREADS < NCELL && more) {  // uniform over the block
        const int src = lane & ~3;
        const float4 h4 = make_float4(__shfl_sync(0xffffffffu, hv[i], src),
                                      __shfl_sync(0xffffffffu, hv[i], src + 1),
                                      __shfl_sync(0xffffffffu, hv[i], src + 2),
                                      __shfl_sync(0xffffffffu, hv[i], src + 3));
        if (e < NCELL && (e & 3) == 0) {
          float* dst = hn + (c * UC + cj[i]) * HS + (cr[i] & ~3);
          *reinterpret_cast<float4*>(dst) = h4;
          const unsigned la = smem_addr(dst), lb = smem_addr(bar);
          for (int q = 1; q < C; ++q) {
            const int peer = (c + q) % C;
            st_async4(map_rank(la, peer), h4, map_rank(lb, peer));
          }
        }
      }
    }
  }
};

// Grid (ceil(M/TM) * C, groups), clusters of (C, 1, 1): blockIdx.x / C is
// the row tile, the cluster rank the CTA's unit slice; 256 threads.
template <typename T, typename R, bool PROJ, int MODE>
__global__ void __launch_bounds__(FWD_THREADS)
    lstm_cluster_fwd_kernel(FwdArgs<T, R> a, int TM, int C) {
  FWD_PHASE_START;
  extern __shared__ __align__(16) float smem[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);  // [2] by parity
  const int g = blockIdx.y;
  FwdCore<T, PROJ> core(smem + 4, a.x, a.xv, g, a.u, a.D, a.M, TM, C, TM + 4);
  const int u = a.u, L = a.L, M = a.M, UC = core.UC, HS = core.HS, tid = core.tid;
  const bool rev = g == a.rev_group;

  // Prologue: the CTA's weight slices into shared memory, h_{-1} = 0, the
  // mbarriers, then a cluster barrier (every CTA started and initialised).
  core.load_weights(a.wih, a.b, a.whh, g);
  for (int idx = tid; idx < u * HS; idx += FWD_THREADS) core.h_s[idx] = 0.0f;
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  FWD_PHASE(0);  // prologue

  long long ho[CELLS];  // the hv-view offset (time 0) of each cell, -1 past M
#pragma unroll
  for (int i = 0; i < CELLS; ++i) {
    const int row = core.row0 + core.cr[i];
    ho[i] = tid + i * FWD_THREADS < core.NCELL && row < M
                ? g * a.hv.group + row * a.hv.row + core.c * UC + core.cj[i]
                : -1;
  }
  core.prefetch(rev ? L - 1 : 0);
  core.project(rev ? L - 1 : 0);
  cluster_arrive();  // every CTA of the cluster has started and set up
  cluster_wait();
  FWD_PHASE(1);  // the first step's input gates and the cluster barrier

  for (int s = 0; s < L; ++s) {
    const int t = rev ? L - 1 - s : s;
    const bool more = s + 1 < L;
    const int pn = (s & 1) ^ 1;  // parity of the buffer this step writes
    if (more) {
      core.prefetch(rev ? L - 2 - s : s + 1);
      if (tid == 0) mbar_expect_tx(&bars[pn], core.rx_bytes);
    }
    core.gates(core.h_s + (s & 1) * u * HS);
    FWD_PHASE(2);  // gates
    __syncthreads();  // every partial written
    FWD_PHASE(3);
    core.cells(core.h_s + pn * u * HS, &bars[pn], more,
               [](int, int, float, float, float, float) {});
    FWD_PHASE(4);  // cells and the h exchange

    const bool ckpt_step =  // kernel-last step of t's natural block: its slot
        MODE == kCkpt && (rev ? t % a.W == 0 : (t % a.W == a.W - 1 || t == L - 1));
#pragma unroll
    for (int i = 0; i < CELLS; ++i) {
      const long long o = ho[i];
      if (o >= 0) {
        a.hs[o + t * a.hv.time] = from_f32<T>(core.hv[i]);
        if (MODE == kFull) a.c1[o + t * a.hv.time] = from_f32<R>(core.cst[i]);
        if (ckpt_step) {
          a.c1[o + (t / a.W) * a.hv.time] = from_f32<R>(core.hv[i]);
          a.c2[o + (t / a.W) * a.hv.time] = from_f32<R>(core.cst[i]);
        }
      }
    }
    FWD_PHASE(5);  // hs and residual stores
    if (more) {
      core.project(rev ? L - 2 - s : s + 1);  // ends with a block barrier: hn's local part is in
      FWD_PHASE(6);
      mbar_wait(&bars[pn], (unsigned)(s >> 1) & 1u);  // every peer's part is in
      FWD_PHASE(7);
    }
  }
  cluster_arrive();  // no CTA leaves while a peer may still address its memory
  cluster_wait();
}

// The (kernel, device, shared-memory bytes, cluster size) launches whose
// runtime checks in launch_cluster passed. A launch found here makes no
// runtime call but the launch itself: the checks cost host time on the
// serving path, and a launch inside a CUDA-graph capture (the training
// step, train/steps.py) then records nothing else.
struct ClusterChecked {
  const void* kernel;
  int dev;
  size_t smem;
  int C;
};
inline std::mutex cluster_checked_mutex;
inline std::vector<ClusterChecked> cluster_checked;

// Launch `kernel` on a grid (gx, gy) of clusters of (C, 1, 1) with `smem`
// bytes of dynamic shared memory. A cluster that cannot be resident is
// refused with cudaErrorLaunchOutOfResources before anything is launched.
// The kernel's shared-memory limit is only ever raised, to the largest
// `smem` it was launched with on the device.
template <typename Args>
int launch_cluster(void (*kernel)(Args, int, int), const Args& a, size_t smem, int gx, int gy,
                   int TM, int C, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, gy, 1);
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
  {
    std::lock_guard<std::mutex> lock(cluster_checked_mutex);
    const void* k = reinterpret_cast<const void*>(kernel);
    bool seen = false;
    size_t raised = 0;
    for (const ClusterChecked& c : cluster_checked) {
      if (c.kernel != k || c.dev != dev) continue;
      raised = c.smem > raised ? c.smem : raised;
      seen = seen || (c.smem == smem && c.C == C);
    }
    if (!seen) {
      if (smem > raised) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
      }
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
      cluster_checked.push_back({k, dev, smem, C});
    }
  }
  err = cudaLaunchKernelEx(&cfg, kernel, a, TM, C);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launch the cluster forward with row tile TM and cluster size C (the
// caller's plan, ops/lstm.py:fwd_plan). A plan the body cannot take is
// refused with cudaErrorInvalidValue before anything is launched.
template <typename T, typename R, bool PROJ, int MODE>
int launch_fwd(const FwdArgs<T, R>& a, int groups, int TM, int C, cudaStream_t stream) {
  const int D = PROJ ? a.D : 0;
  if (!fwd_plan_ok(TM, C, D, a.u)) return (int)cudaErrorInvalidValue;
  return launch_cluster(lstm_cluster_fwd_kernel<T, R, PROJ, MODE>, a, fwd_smem(TM, C, D, a.u),
                        ((a.M + TM - 1) / TM) * C, groups, TM, C, stream);
}

// --- backward: the gradient chain on a cluster -------------------------------
//
// The backward is split in two. lstm_cluster_bwd_kernel (here) walks the
// recurrence in kernel-reverse time and carries only the gradient chain:
// per step it computes da (the four gate gradients) of the CTA's own cells
// and the dh carry, and streams da (f32, [Gc, L, M, 4u]) to device memory;
// the weight gradients and demb are products over all L*M rows that
// csrc/lstm_wgrad.cu computes afterwards, off the chain.
//
// It runs on the cluster layout of the forward: one cluster of C CTAs per
// (row tile, group), CTA c owning u/C units with all four gates of each and
// its f32 W_hh slice [u, 4u/C] resident in shared memory. Per gradient step
// at natural time t (ops/lstm.py:_cell_grad):
//   dh_t = dhs_t + dh_carry;  dc_t = dc_carry + dh_t o (1 - tanh(c_t)^2)
//   da_i = dc_t g i(1-i);  da_f = dc_t c_prev f(1-f);  da_g = dc_t i (1-g^2)
//   da_o = dh_t tanh(c_t) o(1-o);  dc_carry = dc_t f;  dh_carry = da W_hh^T
//   1. da of the own cells (dc_carry and dh_carry in registers) into da_s
//      [NC, TM] and to the da stream (and, without the projection, to dxg);
//   2. the partial dh = da_own [TM, NC] . W_hh_slice^T, [TM, u]: a 4-row x
//      4-unit register tile per thread, two 16-byte loads per 16 FMAs;
//   3. reduce-scatter: the tile of units owned by CTA p goes to p's buffer
//      of this step's parity, slot c (st.async completing on p's mbarrier of
//      that parity; CTA c's own part by a plain store);
//   4. the wait on this parity's mbarrier, a block barrier, and the sum of
//      the C slots in rank order (not arrival order: deterministic) into
//      the dh carry of each own cell.
// Reuse of a reduce-scatter buffer is safe without a barrier: CTA c writes
// parity p into a peer's buffer at step s + 2 only after it received that
// peer's part of step s + 1, which the peer sent after step s + 1's da
// phase, and the peer read its parity-p slots (step s's sum) before that
// phase. The same argument holds for the mbarriers' phases.
//
// Gates and states per step, by mode:
//   kWindow (K8): the window's forward replay from the (h, c) checkpoint
//     seed is the forward's step (FwdCore, with the h all-gather). During
//     it the CTA keeps the gates i, f, g, o and c of its own cells for
//     every window step in shared memory ([W, 5, NCELL]), and writes the
//     h_prev of each step (own units, f32; the seed's rounded value at the
//     window's kernel-first step) to the hp stream [Gc, L, M, u] that
//     dW_hh = sum h_prev^T da needs. The gradient sweep recomputes no gates.
//   kSaved (K6, kernel 3): the gates at t come from the saved hs (h_prev at
//     the kernel-previous time, zero at kernel step 0) and the input, and do
//     not depend on the carries: the next step's gates are computed while
//     this step's dh parts are in flight. c_t and c_prev come from cs.
// What bounds it: the L-step chain (2L with the replay), as the forward.
// BWD_PHASE marks the phases for kernels/fwd_phases.py.

#ifdef LSTM_PHASES
__device__ unsigned long long bwd_phase_cycles[8];
#define BWD_PHASE_START long long bphase_t = clock64()
#define BWD_PHASE(i)                                                                  \
  do {                                                                                \
    if (blockIdx.x == LSTM_PHASES_CTA && blockIdx.y == 0 &&                           \
        threadIdx.x == LSTM_PHASES_TID) {                                             \
      const long long now = clock64();                                                \
      bwd_phase_cycles[i] += (unsigned long long)(now - bphase_t);                    \
      bphase_t = now;                                                                 \
    }                                                                                 \
  } while (0)
#else
#define BWD_PHASE_START
#define BWD_PHASE(i) \
  do {               \
  } while (0)
#endif

enum BwdMode { kWindow = 0, kSaved = 1 };

template <typename T, typename R>
struct BwdArgs {
  const T* dhs;      // view hv
  const T* x;        // PROJ: emb [L, M, D] (view xv, shared); else xg (view xv)
  const T* hs;       // kSaved: hs (view hv), the source of h_prev
  const R* c1;       // kSaved: cs (view hv); kWindow: ch [ceil(L/W), M, *] (view hv by block)
  const R* c2;       // kWindow: cc
  const T* wih;      // [Gc, D, 4u] (PROJ)
  const float* b;    // [Gc, 1, 4u] (PROJ)
  const float* whh;  // [Gc, u, 4u]
  float* da;         // [Gc, L, M, 4u] f32
  float* hp;         // kWindow: [Gc, L, M, u] f32, h_prev of every step
  T* dx;             // !PROJ: dxg (view xv)
  View xv, hv;
  int L, M, D, u, W, rev_group;
};

// Shared memory of lstm_cluster_bwd_kernel in bytes (ops/lstm.py:bwd_smem):
// four mbarriers (32 bytes); the forward step's floats, with unpadded h
// buffers (row stride TM) where a window must fit (W > 0) and TM + 4
// otherwise; the window's gates and c of the own cells [W, 5, TM u/C]
// (W = 0: none); the reduce-scatter buffers [2, C, u/C, TM]. da_s [4u/C, TM]
// shares the split-K partials' space.
inline size_t bwd_smem(int TM, int C, int D, int u, int W) {
  return 32 + sizeof(float) * (fwd_core_floats(TM, C, D, u, W ? TM : TM + 4) +
                               5 * (size_t)W * TM * (u / C) + 2 * (size_t)TM * u);
}

// The plans the body takes (ops/lstm.py:bwd_plan picks one): the forward's,
// with u/C a multiple of 4 (a dh tile's 4 units go to one CTA) and at most
// 256 dh tiles.
inline bool bwd_plan_ok(int TM, int C, int D, int u, int W) {
  if (TM < 4 || TM % 4 || C < 1 || C > 8 || u < C || u % C || (u / C) % 4) return false;
  const int tiles = TM * (4 * u / C) / 16, cells = TM * (u / C);
  return tiles <= FWD_THREADS && cells <= CELLS * FWD_THREADS &&
         TM / 4 * (u / 4) <= FWD_THREADS && bwd_smem(TM, C, D, u, W) <= SMEM_LIMIT;
}

// Grid (ceil(M/TM) * C, groups), clusters of (C, 1, 1), 256 threads, as
// the forward.
template <typename T, typename R, bool PROJ, int MODE>
__global__ void __launch_bounds__(FWD_THREADS)
    lstm_cluster_bwd_kernel(BwdArgs<T, R> a, int TM, int C) {
  BWD_PHASE_START;
  extern __shared__ __align__(16) float smem[];
  // [0, 1]: the replay's h exchange by parity; [2, 3]: the dh reduce-scatter.
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);
  const int g = blockIdx.y;
  FwdCore<T, PROJ> core(smem + 8, a.x, a.xv, g, a.u, a.D, a.M, TM, C,
                        MODE == kWindow ? TM : TM + 4);
  const int u = a.u, G = 4 * u, L = a.L, M = a.M, UC = core.UC, NC = core.NC;
  const int c = core.c, tid = core.tid, row0 = core.row0, NCELL = core.NCELL;
  const bool rev = g == a.rev_group;
  float* win_s = core.end();                                        // [W, 5, NCELL]
  float* rs_s = win_s + (MODE == kWindow ? 5 * a.W * NCELL : 0);    // [2, C, UC, TM]
  float* da_s = core.red_s;                                         // [NC, TM]

  core.load_weights(a.wih, a.b, a.whh, g);
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  cluster_arrive();  // every CTA of the cluster has started and set up
  cluster_wait();
  BWD_PHASE(0);  // prologue

  long long ho[CELLS];  // the hv-view offset (time 0) of each cell, -1 past M
#pragma unroll
  for (int i = 0; i < CELLS; ++i) {
    const int row = row0 + core.cr[i];
    ho[i] = tid + i * FWD_THREADS < NCELL && row < M
                ? g * a.hv.group + row * a.hv.row + c * UC + core.cj[i]
                : -1;
  }
  float dc[CELLS], dh[CELLS], dhs_v[CELLS];
#pragma unroll
  for (int i = 0; i < CELLS; ++i) dc[i] = dh[i] = dhs_v[i] = 0.0f;
  auto load_dhs = [&](int t) {
#pragma unroll
    for (int i = 0; i < CELLS; ++i) {
      const long long o = ho[i];
      dhs_v[i] = o >= 0 ? to_f32(a.dhs[o + t * a.hv.time]) : 0.0f;
    }
  };

  unsigned rs_phase = 0;  // bit p: the phase parity the next wait on bars[2 + p] expects
  int gs = 0;             // gradient steps so far
  const int RB = TM / 4, kb = tid / RB, rb = tid - kb * RB;  // dh tile: rows rb*4.., units kb*4..
  const float* whh_s = core.whh_s;
  // One gradient step at natural time t; cell_in(i, e, ig, fg, gg, og, ct,
  // cp) gives cell e's gates, c_t and c_prev; t_next (-1: none) is the next
  // step's time, whose dhs is loaded once da is out; between() runs while the
  // dh parts are in flight.
  auto grad = [&](int t, int t_next, auto&& cell_in, auto&& between) {
    const int par = gs & 1;
    if (tid == 0) mbar_expect_tx(&bars[2 + par], core.rx_bytes);
#pragma unroll
    for (int i = 0; i < CELLS; ++i) {
      const int e = tid + i * FWD_THREADS;
      if (e < NCELL) {
        float ig, fg, gg, og, ct, cp;
        cell_in(i, e, ig, fg, gg, og, ct, cp);
        const int r = core.cr[i], jl = core.cj[i];
        const float dht = dhs_v[i] + dh[i];
        const float tc = tanhf(ct);
        const float dct = dc[i] + dht * og * (1.0f - tc * tc);
        float d[4];
        d[0] = dct * gg * ig * (1.0f - ig);
        d[1] = dct * cp * fg * (1.0f - fg);
        d[2] = dct * ig * (1.0f - gg * gg);
        d[3] = dht * tc * og * (1.0f - og);
        dc[i] = dct * fg;
        const int row = row0 + r;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          da_s[(q * UC + jl) * TM + r] = d[q];
          if (row < M) {
            const int col = q * u + c * UC + jl;
            a.da[(((size_t)g * L + t) * M + row) * G + col] = d[q];
            if constexpr (!PROJ)
              a.dx[g * a.xv.group + row * a.xv.row + t * a.xv.time + col] = from_f32<T>(d[q]);
          }
        }
      }
    }
    if (t_next >= 0) load_dhs(t_next);
    BWD_PHASE(2);  // da
    __syncthreads();  // da_s complete
    BWD_PHASE(3);

    if (kb < u / 4) {
      float acc[4][4];  // [unit][row]
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[k][r] = 0.0f;
#pragma unroll 2
      for (int q = 0; q < NC; q += 4) {
        float4 dq[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dq[j] = *reinterpret_cast<const float4*>(da_s + (q + j) * TM + rb * 4);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 w = *reinterpret_cast<const float4*>(whh_s + (kb * 4 + k) * NC + q);
          fma4(acc[k], w.x, dq[0]);
          fma4(acc[k], w.y, dq[1]);
          fma4(acc[k], w.z, dq[2]);
          fma4(acc[k], w.w, dq[3]);
        }
      }
      const int p = kb * 4 / UC, kl = kb * 4 - p * UC;
      const unsigned lb = smem_addr(&bars[2 + par]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 v = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
        float* dst = rs_s + ((par * C + c) * UC + kl + k) * TM + rb * 4;
        if (p == c)
          *reinterpret_cast<float4*>(dst) = v;
        else
          st_async4(map_rank(smem_addr(dst), p), v, map_rank(lb, p));
      }
    }
    BWD_PHASE(4);  // the dh product and its reduce-scatter
    between();
    BWD_PHASE(5);  // kSaved: the next step's gates
    mbar_wait(&bars[2 + par], (rs_phase >> par) & 1u);  // every peer's part is in
    rs_phase ^= 1u << par;
    __syncthreads();  // and the own part
    BWD_PHASE(6);  // reduce-scatter wait
#pragma unroll
    for (int i = 0; i < CELLS; ++i) {
      const int e = tid + i * FWD_THREADS;
      if (e < NCELL) {
        const float* src = rs_s + (par * C * UC + core.cj[i]) * TM + core.cr[i];
        float s = 0.0f;
        for (int q = 0; q < C; ++q) s += src[q * UC * TM];
        dh[i] = s;
      }
    }
    BWD_PHASE(7);  // rank-ordered sum
    ++gs;
  };

  if constexpr (MODE == kWindow) {
    const int W = a.W, nB = (L + W - 1) / W;
    unsigned h_phase = 0;  // bit p: the phase parity the next wait on bars[p] expects
    float cseed[CELLS], hprev[CELLS];
    for (int n = 0; n < nB; ++n) {
      const int blk = rev ? n : nB - 1 - n;  // kernel-reverse block order
      const int base = blk * W, Wb = min(W, L - base);
      const bool first = rev ? blk == nB - 1 : blk == 0;
      const long long seed_t = (rev ? blk + 1 : blk - 1) * a.hv.time;
      auto time_of = [&](int js) { return rev ? base + Wb - 1 - js : base + js; };
      // The seed: h of every unit into h buffer 0, the own cells' c and h into registers.
      for (int idx = tid; idx < TM * u; idx += FWD_THREADS) {
        const int r = idx / u, k = idx - r * u, row = row0 + r;
        core.h_s[k * core.HS + r] =
            !first && row < M ? to_f32(a.c1[g * a.hv.group + row * a.hv.row + k + seed_t]) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < CELLS; ++i) {
        const long long o = ho[i];
        const bool live = !first && o >= 0;
        core.cst[i] = cseed[i] = live ? to_f32(a.c2[o + seed_t]) : 0.0f;
        hprev[i] = live ? to_f32(a.c1[o + seed_t]) : 0.0f;
      }
      core.prefetch(time_of(0));
      core.project(time_of(0));  // ends with a block barrier: the seed is in

      // The replay, ascending in kernel time.
      for (int js = 0; js < Wb; ++js) {
        const int t = time_of(js);
        const bool more = js + 1 < Wb;
        const int pn = (js & 1) ^ 1;
        if (more) {
          core.prefetch(time_of(js + 1));
          if (tid == 0) mbar_expect_tx(&bars[pn], core.rx_bytes);
        }
        core.gates(core.h_s + (js & 1) * u * core.HS);
        __syncthreads();
        float* w = win_s + js * 5 * NCELL;
        core.cells(core.h_s + pn * u * core.HS, &bars[pn], more,
                   [&](int i, int e, float ig, float fg, float gg, float og) {
                     w[e] = ig;
                     w[NCELL + e] = fg;
                     w[2 * NCELL + e] = gg;
                     w[3 * NCELL + e] = og;
                     w[4 * NCELL + e] = core.cst[i];
                     const int row = row0 + core.cr[i];
                     if (row < M)
                       a.hp[(((size_t)g * L + t) * M + row) * u + c * UC + core.cj[i]] = hprev[i];
                     hprev[i] = core.hv[i];
                   });
        if (more) {
          core.project(time_of(js + 1));
          mbar_wait(&bars[pn], (h_phase >> pn) & 1u);
          h_phase ^= 1u << pn;
        }
      }
      __syncthreads();  // the last cell phase read the partials that da_s reuses
      BWD_PHASE(1);  // the window's replay

      // The gradient steps, descending in kernel time.
      load_dhs(time_of(Wb - 1));
      for (int js = Wb - 1; js >= 0; --js) {
        const float* w = win_s + js * 5 * NCELL;
        grad(time_of(js), js ? time_of(js - 1) : -1,
             [&](int i, int e, float& ig, float& fg, float& gg, float& og, float& ct, float& cp) {
               ig = w[e];
               fg = w[NCELL + e];
               gg = w[2 * NCELL + e];
               og = w[3 * NCELL + e];
               ct = w[4 * NCELL + e];
               cp = js ? w[4 * NCELL + e - 5 * NCELL] : cseed[i];
             },
             [] {});
      }
    }
  } else {
    // Kernel step s's inputs are loaded into registers a step ahead (at the
    // top of step s + 1, so their latency hides behind its da and dh
    // phases): h_prev from hs at the kernel-previous time (zero at s = 0),
    // the input (core.prefetch), c_t and c_prev of the own cells from cs.
    // step_gates then stages them and computes the gates into registers.
    constexpr int HPF = 16;  // h_prev values a thread stages: TM u <= 16 * 256 (bwd_plan_ok)
    T hpf[HPF];
    R ctf[CELLS], cpf[CELLS];
    float gt[CELLS][4], ct_v[CELLS], cp_v[CELLS];
    auto time_of = [&](int s) { return rev ? L - 1 - s : s; };
    auto load_step = [&](int s) {
      const int t = time_of(s);
      const long long tp = (long long)(rev ? t + 1 : t - 1) * a.hv.time;
#pragma unroll
      for (int i = 0; i < HPF; ++i) {
        const int idx = tid + i * FWD_THREADS, r = idx / u, row = row0 + r;
        hpf[i] = idx < TM * u && s > 0 && row < M
                     ? a.hs[g * a.hv.group + row * a.hv.row + (idx - r * u) + tp]
                     : from_f32<T>(0.0f);
      }
      core.prefetch(t);
#pragma unroll
      for (int i = 0; i < CELLS; ++i) {
        const long long o = ho[i];
        ctf[i] = o >= 0 ? a.c1[o + t * a.hv.time] : from_f32<R>(0.0f);
        cpf[i] = o >= 0 && s > 0 ? a.c1[o + tp] : from_f32<R>(0.0f);
      }
    };
    auto step_gates = [&](int s) {
#pragma unroll
      for (int i = 0; i < HPF; ++i) {
        const int idx = tid + i * FWD_THREADS, r = idx / u;
        if (idx < TM * u) core.h_s[(idx - r * u) * core.HS + r] = to_f32(hpf[i]);
      }
      core.project(time_of(s));  // ends with a block barrier: h_prev is in
      core.gates(core.h_s);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < CELLS; ++i) {
        const int e = tid + i * FWD_THREADS;
        if (e < NCELL) {
          core.activations(i, gt[i][0], gt[i][1], gt[i][2], gt[i][3]);
          ct_v[i] = to_f32(ctf[i]);
          cp_v[i] = to_f32(cpf[i]);
        }
      }
    };
    load_step(L - 1);
    step_gates(L - 1);
    load_dhs(time_of(L - 1));
    __syncthreads();  // the activations read the partials that da_s reuses
    for (int s = L - 1; s >= 0; --s) {
      if (s) load_step(s - 1);
      grad(time_of(s), s ? time_of(s - 1) : -1,
           [&](int i, int, float& ig, float& fg, float& gg, float& og, float& ct, float& cp) {
             ig = gt[i][0];
             fg = gt[i][1];
             gg = gt[i][2];
             og = gt[i][3];
             ct = ct_v[i];
             cp = cp_v[i];
           },
           [&] {
             if (s) step_gates(s - 1);
           });
    }
  }
  cluster_arrive();  // no CTA leaves while a peer may still address its memory
  cluster_wait();
}

// Launch the cluster backward with row tile TM and cluster size C (the
// caller's plan, ops/lstm.py:bwd_plan); refusals as launch_fwd.
template <typename T, typename R, bool PROJ, int MODE>
int launch_bwd(const BwdArgs<T, R>& a, int groups, int TM, int C, cudaStream_t stream) {
  const int D = PROJ ? a.D : 0, W = MODE == kWindow ? a.W : 0;
  if (!bwd_plan_ok(TM, C, D, a.u, W)) return (int)cudaErrorInvalidValue;
  return launch_cluster(lstm_cluster_bwd_kernel<T, R, PROJ, MODE>, a,
                        bwd_smem(TM, C, D, a.u, W), ((a.M + TM - 1) / TM) * C, groups, TM, C,
                        stream);
}

}  // namespace lstm
