// Windowed fused BiLSTM backward for Hopper (sm_90a): K8.
//
// Replaces: induction_network_on_fewrel_tpu/ops/lstm.py:_fused_win_bwd_kernel
// (launched by _fused_win_bwd_call, the backward rule of _bilstm_fused_tm at
// lstm_cs_window = W > 0). The forward (K7) kept one (h, c) checkpoint pair
// per natural-time block [bW, min(bW+W, L)); this kernel walks each
// direction in kernel-reverse time and, on entering a block, replays its
// forward steps in f32 from the seed (the checkpoint of the kernel-previous
// block: b-1 for the forward direction, b+1 for the reverse one; zero for
// the direction's kernel-first block), keeping the block's h and c in
// shared memory. Then, per step (ops/lstm.py:1067-1107):
//
//   a     = emb_t W_ih + b + h_prev W_hh        (gates recomputed, f32)
//   dh_t  = dhs_t + dh_carry
//   da_o  = dh_t tanh(c_t) o(1-o)
//   dc_t  = dc_carry + dh_t o (1 - tanh(c_t)^2)
//   da_i  = dc_t g i(1-i);  da_g = dc_t i (1-g^2);  da_f = dc_t c_prev f(1-f)
//   demb_t   = da W_ih^T        -> demb [2, L, M, D] in the emb dtype
//   dW_ih   += emb_t^T da;  db += sum_rows da;  dW_hh += h_prev^T da
//   dh_carry = da W_hh^T;  dc_carry = dc_t f
//
// The ragged last block (L % W != 0) is replayed for its Wb = L - bW steps
// only, so nothing past L is read (the TPU kernel selects the carried state
// on those lanes instead). Rows past M read zero embeddings, zero seeds and
// zero dhs, so their da is exactly zero and they add nothing to the sums.
//
// Outputs per (row tile, direction) block, each owned by that block alone
// (no atomics): demb for its rows, and f32 partials dW_ih [D, 4u], db [4u],
// dW_hh [u, 4u] of its tile, summed over tiles outside the kernel (as the
// JAX call sums its per-tile partials, lstm.py:1212-1215). An f32 dW_hh is
// 256 KiB at u = 128, more than a block's 227 KiB of shared memory, so the
// partial slabs live in device memory (L2-resident at these sizes) and the
// thread that owns gate column j read-modify-writes column j of both.
//
// What bounds it on this card: like K1, the sequential chain (2L steps per
// direction: replay + gradient), with a grid of (ceil(M/TM), 2) blocks; per
// gradient step each thread also updates its (D + u) partial entries in L2.
// By bytes and operations the work is tiny next to the card's rates.
//
// Design (simple and right first; the gradient step is grad_step in
// lstm_common.cuh, shared with K6 and kernel 3): blockDim = 4u, thread j
// owns gate column j for the gate recompute (weights read once per step from L2 and
// reused from a register for the TM rows) and for the weight-gradient
// columns; the cell update gives each thread fixed (row, unit) cells whose
// dc carries stay in registers; da W_ih^T and da W_hh^T run one warp per
// output column (coalesced weight rows, shuffle reductions). The row tile
// TM is a template parameter in {8, 4, 2, 1} that the caller picks so the
// window fits in shared memory (2 W TM u f32 values).

#include "lstm_common.cuh"

namespace {

using lstm::BwdArgs;
using lstm::View;

size_t smem_bytes(int TM, int W, int D, int u) {
  return sizeof(float) * ((size_t)2 * W * TM * u + 3 * (size_t)TM * u + (size_t)TM * D +
                          (size_t)TM * 4 * u);
}

template <typename T, typename R, int TM>
__global__ void __launch_bounds__(lstm::MAX_THREADS)
bilstm_win_bwd_kernel(BwdArgs<T, R> a) {
  constexpr int CPT = lstm::cells_per_thread(TM);
  extern __shared__ float smem[];
  const lstm::Sweep<T, R, true> w(a, TM);
  const int u = w.u, G = w.G, D = w.D, j = w.j, L = a.L, M = a.M, W = a.W, TU = TM * u;
  const int dir = blockIdx.y;
  float* hwin = smem;               // [W, TM, u]  replayed h of the block
  float* cwin = hwin + W * TU;      // [W, TM, u]  replayed c of the block
  float* seed_h = cwin + W * TU;    // [TM, u]
  float* seed_c = seed_h + TU;      // [TM, u]
  float* dh_s = seed_c + TU;        // [TM, u]     dh carry
  float* emb_s = dh_s + TU;         // [TM, D]     this step's embeddings
  float* a_s = emb_s + TM * D;      // [TM, 4u]    gates, then da

  w.zero_slabs();
  float db_acc = 0.0f;
  float dc[CPT];
#pragma unroll
  for (int q = 0; q < CPT; ++q) dc[q] = 0.0f;
  for (int idx = j; idx < TU; idx += G) dh_s[idx] = 0.0f;

  const int nB = (L + W - 1) / W;
  for (int n = 0; n < nB; ++n) {
    const int blk = dir ? n : nB - 1 - n;   // kernel-reverse block order
    const int base = blk * W;
    const int Wb = min(W, L - base);
    const bool first = dir ? blk == nB - 1 : blk == 0;
    const int sblk = dir ? blk + 1 : blk - 1;
    for (int idx = j; idx < TU; idx += G) {
      const int r = idx / u, jj = idx - r * u;
      const int row = w.row0 + r;
      float hv = 0.0f, cv = 0.0f;
      if (!first && row < M) {
        const size_t o = ((size_t)sblk * M + row) * (2 * u) + dir * u + jj;
        hv = lstm::to_f32(a.c1[o]);
        cv = lstm::to_f32(a.c2[o]);
      }
      seed_h[idx] = hv;
      seed_c[idx] = cv;
    }

    // Replay the block's forward steps, ascending in kernel time.
    for (int js = 0; js < Wb; ++js) {
      const int pos = dir ? Wb - 1 - js : js;
      const int prev = dir ? pos + 1 : pos - 1;
      const float* hp = js == 0 ? seed_h : hwin + prev * TU;
      const float* cp = js == 0 ? seed_c : cwin + prev * TU;
      lstm::stage_rows(emb_s, a.x, a.xv, base + pos, w.row0, TM, M, D, j, G);
      __syncthreads();  // emb_s, seeds and the previous replay step visible
      lstm::gate_column<T, TM, true>(a_s, hp, emb_s, w.wih_d, w.bj, nullptr, 0, w.row0, M,
                                     w.whh_d, D, u, j);
      __syncthreads();
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int idx = j + q * G;
        if (idx < TU) {
          const int r = idx / u, jj = idx - r * u;
          const float* ar = a_s + r * G;
          const float ig = lstm::sigmoidf(ar[jj]);
          const float fg = lstm::sigmoidf(ar[u + jj]);
          const float gg = tanhf(ar[2 * u + jj]);
          const float og = lstm::sigmoidf(ar[3 * u + jj]);
          const float c = fg * cp[idx] + ig * gg;
          cwin[pos * TU + idx] = c;
          hwin[pos * TU + idx] = og * tanhf(c);
        }
      }
      __syncthreads();
    }

    // Gradient steps, descending in kernel time.
    for (int ks = 0; ks < Wb; ++ks) {
      const int o = dir ? ks : Wb - 1 - ks;
      const bool at_seed = dir ? o == Wb - 1 : o == 0;
      const int op = dir ? o + 1 : o - 1;
      const float* hp = at_seed ? seed_h : hwin + op * TU;
      const float* cp = at_seed ? seed_c : cwin + op * TU;
      lstm::stage_rows(emb_s, a.x, a.xv, base + o, w.row0, TM, M, D, j, G);
      __syncthreads();
      lstm::grad_step<T, R, true, TM>(w, base + o, hp, cp, cwin + o * TU, emb_s, a_s, dh_s, dc,
                                      db_acc);
    }
  }
  a.db_p[((size_t)dir * gridDim.x + blockIdx.x) * G + j] = db_acc;
}

template <typename T, typename R, int TM>
int launch(const BwdArgs<T, R>& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(TM, a.W, a.D, a.u);
  cudaError_t err = cudaFuncSetAttribute(bilstm_win_bwd_kernel<T, R, TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.M + TM - 1) / TM, 2);
  bilstm_win_bwd_kernel<T, R, TM><<<grid, 4 * a.u, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename R>
int launch_tm(int tm, const void* dhs, const void* emb, const void* ch, const void* cc,
              const void* wih, const void* b, const void* whh, void* demb, void* dwih_p,
              void* db_p, void* dwhh_p, int L, int M, int D, int u, int W, cudaStream_t s) {
  BwdArgs<T, R> a{};
  a.dhs = static_cast<const T*>(dhs);
  a.x = static_cast<const T*>(emb);
  a.c1 = static_cast<const R*>(ch);
  a.c2 = static_cast<const R*>(cc);
  a.wih = static_cast<const T*>(wih);
  a.b = static_cast<const float*>(b);
  a.whh = static_cast<const float*>(whh);
  a.dx = static_cast<T*>(demb);
  a.dwih_p = static_cast<float*>(dwih_p);
  a.db_p = static_cast<float*>(db_p);
  a.dwhh_p = static_cast<float*>(dwhh_p);
  a.xv = View{0, D, (long long)M * D};
  a.hv = View{u, 2LL * u, 2LL * M * u};
  a.L = L; a.M = M; a.D = D; a.u = u; a.W = W; a.rev_group = 1;
  switch (tm) {
    case 8: return launch<T, R, 8>(a, s);
    case 4: return launch<T, R, 4>(a, s);
    case 2: return launch<T, R, 2>(a, s);
    case 1: return launch<T, R, 1>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dhs, emb [L, M, *] and wih [2, D, 4u] in bf16 when bf16 != 0 (else f32);
// ch, cc [ceil(L/W), M, 2u] in bf16 when res_bf16 != 0 (else f32); b, whh
// f32. Writes demb [2, L, M, D] (emb's dtype) and the f32 per-tile partials
// dwih_p [2, ceil(M/tm), D, 4u], db_p [2, ceil(M/tm), 4u] and
// dwhh_p [2, ceil(M/tm), u, 4u]. The caller guarantees tm in {8, 4, 2, 1},
// 4u <= 512 and a multiple of 32, 1 <= W <= L, that the dynamic shared
// memory 4 (2 W tm u + 3 tm u + tm D + 4 tm u) bytes fits a block, and
// contiguous tensors.
int bilstm_win_bwd(const void* dhs, const void* emb, const void* ch, const void* cc,
                   const void* wih, const void* b, const void* whh, void* demb, void* dwih_p,
                   void* db_p, void* dwhh_p, int L, int M, int D, int u, int W, int tm,
                   int bf16, int res_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && res_bf16)
    return launch_tm<__nv_bfloat16, __nv_bfloat16>(tm, dhs, emb, ch, cc, wih, b, whh, demb,
                                                   dwih_p, db_p, dwhh_p, L, M, D, u, W, s);
  if (bf16)
    return launch_tm<__nv_bfloat16, float>(tm, dhs, emb, ch, cc, wih, b, whh, demb, dwih_p,
                                           db_p, dwhh_p, L, M, D, u, W, s);
  if (res_bf16)
    return launch_tm<float, __nv_bfloat16>(tm, dhs, emb, ch, cc, wih, b, whh, demb, dwih_p,
                                           db_p, dwhh_p, L, M, D, u, W, s);
  return launch_tm<float, float>(tm, dhs, emb, ch, cc, wih, b, whh, demb, dwih_p, db_p,
                                 dwhh_p, L, M, D, u, W, s);
}

const char* bilstm_win_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
