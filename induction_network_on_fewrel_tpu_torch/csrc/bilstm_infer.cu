// Fused BiLSTM forward for Hopper (sm_90a): one kernel body, three launchers.
//
// K1 (bilstm_infer_fwd) replaces
// induction_network_on_fewrel_tpu/ops/lstm.py:_fused_fwd_kernel_infer
// (launched by _fused_fwd_call_infer, the no-grad primal of
// _bilstm_fused_tm): the input projection emb_t @ W_ih + b and the
// bidirectional LSTM recurrence in one kernel, writing only the hidden
// states hs [L, M, 2u] (cols [0:u] forward, [u:2u] reverse, natural time).
//
// K7 (bilstm_win_fwd) replaces ops/lstm.py:_fused_win_fwd_kernel (launched
// by _fused_win_fwd_call, the training forward at lstm_cs_window = W > 0):
// the same body with the compile-time flag kCkpt, which also writes one
// (h, c) checkpoint pair per natural-time block [bW, min(bW+W, L)) into
// ch, cc [ceil(L/W), M, 2u] in the residual dtype. Slot b holds the state
// at the block's kernel-LAST step: natural min(bW+W, L)-1 for the forward
// direction, natural bW for the reverse one (the TPU kernel gets the same
// value from its block flush). h and c are written from the f32 values the
// recurrence carries (c from its register), so with f32 residuals the
// backward's window replay starts from exactly the forward's state.
//
// K4 (bilstm_full_fwd) replaces ops/lstm.py:_fused_fwd_kernel (launched by
// _fused_fwd_call, the training forward at lstm_cs_window = 0, the
// full-residual route): the same body with the flag kFull, which also
// writes c at every step into cs [L, M, 2u] in the residual dtype, from
// the register-resident f32 c. hs stays in the activation dtype, so with a
// bf16 encoder the backward (K6) reads h_prev as bf16, as the TPU kernel
// does.
//
// Numerics follow the TPU kernel: gate pre-activations
// a = emb·W_ih + b + h·W_hh accumulate in f32 (emb and W_ih in the
// activation dtype, b and W_hh in f32), gate order [i, f, g, o], h and c
// carries in f32, hs written in the activation dtype. The reverse direction
// reads and writes natural time L-1-s at its step s.
//
// Design: the cluster body lstm_cluster_fwd_kernel (lstm_common.cuh, shared
// with the split recurrence's kernels 1 and 2; its comment has the step in
// detail). One thread-block cluster of C CTAs per (row tile of TM rows,
// direction); CTA c owns u/C units and all four gate columns of each, keeps
// its slices of W_hh (f32), W_ih and b in shared memory for the whole
// recurrence, computes its [TM, u] x [u, 4u/C] gate product with 4 x 4
// register tiles (two 16-byte shared loads per 16 FMAs), and sends its new
// h slice into every peer's shared memory (st.async, distributed shared
// memory), each CTA waiting on its own mbarrier for its peers' bytes. The
// next step's input projection emb_t W_ih + b does not depend on h and is
// computed while the peers' h is in flight. The caller picks TM and C
// (ops/lstm.py:fwd_plan): C = 8 at u = 128 and TM = 16, so a serving bucket
// of 1-16 rows runs on 16 SMs, and TM = 32 at M = 200, 7 x 2 x 8 = 112 CTAs,
// one wave on 132 SMs. The c carries stay in registers; rows past M read
// zeros and write nothing, so the ragged last tile needs no padded copy.
//
// What bounds it on this card: the 40-step sequential chain. Bytes (emb and
// hs streamed once, the weights read once per CTA) and operations are far
// below the card's rates at these sizes, so the time is the chain's length
// times one step, and a step is three phases of similar length, each a few
// hundred instructions per thread with 8 warps per SM to hide their
// latency: the gate product, the cells with the h exchange, and the next
// step's projection (which every CTA computes itself, so it lengthens the
// step rather than hiding behind it). `python -m
// induction_network_on_fewrel_tpu_torch.kernels.fwd_phases` prints the
// cycles of each phase on the card; PERF.md §5 has them.
//
// Tried and dropped: the recurrent product on the tensor cores in 3xTF32
// (mma.sync m16n8k8, W_hh pre-split into TF32 halves in shared memory) kept
// f32 accuracy but made the step slower on the H100 in a trial build: one
// 8-column tile per warp leaves too few independent mma chains per step,
// and every warp splits the same h fragments. A projection that leaves
// the step needs warps of its own (warp specialization) or a global
// scratch of the gates of all L steps.

#include "lstm_common.cuh"

namespace {

using lstm::FwdArgs;
using lstm::View;

// emb [L, M, D] and hs / residuals [*, M, 2u]: direction d's columns start at d*u.
template <typename T, typename R>
FwdArgs<T, R> fused_args(const void* emb, const void* wih, const void* b, const void* whh,
                         void* hs, void* c1, void* c2, int L, int M, int D, int u, int W) {
  FwdArgs<T, R> a;
  a.x = static_cast<const T*>(emb);
  a.wih = static_cast<const T*>(wih);
  a.b = static_cast<const float*>(b);
  a.whh = static_cast<const float*>(whh);
  a.hs = static_cast<T*>(hs);
  a.c1 = static_cast<R*>(c1);
  a.c2 = static_cast<R*>(c2);
  a.xv = View{0, D, (long long)M * D};
  a.hv = View{u, 2LL * u, 2LL * M * u};
  a.L = L; a.M = M; a.D = D; a.u = u; a.W = W; a.rev_group = 1;
  return a;
}

template <typename T, typename R, int MODE>
int launch(const void* emb, const void* wih, const void* b, const void* whh, void* hs,
           void* c1, void* c2, int L, int M, int D, int u, int W, int tm, int cluster,
           cudaStream_t stream) {
  return lstm::launch_fwd<T, R, true, MODE>(
      fused_args<T, R>(emb, wih, b, whh, hs, c1, c2, L, M, D, u, W), 2, tm, cluster, stream);
}

template <typename T, int MODE>
int launch_res(const void* emb, const void* wih, const void* b, const void* whh, void* hs,
               void* c1, void* c2, int L, int M, int D, int u, int W, int res_bf16, int tm,
               int cluster, cudaStream_t stream) {
  if (res_bf16)
    return launch<T, __nv_bfloat16, MODE>(emb, wih, b, whh, hs, c1, c2, L, M, D, u, W, tm,
                                          cluster, stream);
  return launch<T, float, MODE>(emb, wih, b, whh, hs, c1, c2, L, M, D, u, W, tm, cluster,
                                stream);
}

}  // namespace

extern "C" {

// Every launcher takes the caller's plan last before the stream: the row
// tile tm and the cluster size (ops/lstm.py:fwd_plan). A plan the body
// cannot take returns cudaErrorInvalidValue before anything is launched.

// emb [L, M, D], wih [2, D, 4u] (both bf16 when bf16 != 0, else f32),
// b [2, 1, 4u] f32, whh [2, u, 4u] f32 -> hs [L, M, 2u] in emb's dtype.
// The caller guarantees contiguous tensors.
int bilstm_infer_fwd(const void* emb, const void* wih, const void* b, const void* whh,
                     void* hs, int L, int M, int D, int u, int bf16, int tm, int cluster,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16, __nv_bfloat16, lstm::kNone>(emb, wih, b, whh, hs, nullptr,
                                                             nullptr, L, M, D, u, 1, tm,
                                                             cluster, s);
  return launch<float, float, lstm::kNone>(emb, wih, b, whh, hs, nullptr, nullptr, L, M, D, u,
                                           1, tm, cluster, s);
}

// K7: as bilstm_infer_fwd, plus ch, cc [ceil(L/W), M, 2u] in bf16 when
// res_bf16 != 0, else f32. The caller guarantees 1 <= W <= L.
int bilstm_win_fwd(const void* emb, const void* wih, const void* b, const void* whh,
                   void* hs, void* ch, void* cc, int L, int M, int D, int u, int W,
                   int bf16, int res_bf16, int tm, int cluster, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_res<__nv_bfloat16, lstm::kCkpt>(emb, wih, b, whh, hs, ch, cc, L, M, D, u, W,
                                                  res_bf16, tm, cluster, s);
  return launch_res<float, lstm::kCkpt>(emb, wih, b, whh, hs, ch, cc, L, M, D, u, W, res_bf16,
                                        tm, cluster, s);
}

// K4: as bilstm_infer_fwd, plus cs [L, M, 2u] (c at every step) in bf16
// when res_bf16 != 0, else f32.
int bilstm_full_fwd(const void* emb, const void* wih, const void* b, const void* whh,
                    void* hs, void* cs, int L, int M, int D, int u, int bf16, int res_bf16,
                    int tm, int cluster, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_res<__nv_bfloat16, lstm::kFull>(emb, wih, b, whh, hs, cs, nullptr, L, M, D,
                                                  u, 1, res_bf16, tm, cluster, s);
  return launch_res<float, lstm::kFull>(emb, wih, b, whh, hs, cs, nullptr, L, M, D, u, 1,
                                        res_bf16, tm, cluster, s);
}

const char* bilstm_infer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef LSTM_PHASES
// Copy the forward's 8 per-phase cycle sums into out (host memory), then
// zero them when reset != 0 (kernels/fwd_phases.py).
int bilstm_fwd_phases(void* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, lstm::fwd_phase_cycles, 8 * sizeof(long long));
  if (err != cudaSuccess || !reset) return (int)err;
  const unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(lstm::fwd_phase_cycles, zero, sizeof(zero));
}
#endif

}  // extern "C"
