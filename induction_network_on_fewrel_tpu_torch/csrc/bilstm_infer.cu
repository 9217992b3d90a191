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
// What bounds it on this card: the 40-step sequential chain. Every step
// depends on the previous step's h, so at serving sizes (a bucket of 1-16
// rows is one row tile per direction: 2 blocks on 132 SMs) the kernel is
// latency-bound, far from both the byte and the operation roofline. Per
// step a block reads W_ih and W_hh of its direction (60x512 + 128x512
// values, ~0.4 MB) from L2; both directions' weights (~0.6 MB) stay
// L2-resident across steps and blocks.
//
// Design (simple and right first; the body is lstm_fwd_kernel in
// lstm_common.cuh, shared with the split recurrence's kernels 1 and 2): one
// block per (row tile of TM = 16 rows, direction); the TPU's sequential
// grid axis over L becomes a loop inside the block. One thread per gate
// column j of the 4u columns computes the TM pre-activations of its
// column, reading each weight once per step and
// reusing it from a register TM times; the step's embedding tile and h
// live in shared memory (f32) and are read as broadcasts. The cell update
// then gives each thread TM/4 fixed (row, unit) cells, whose c carries
// stay in registers for all L steps. Rows past M read zeros and write
// nothing: the ragged last tile needs no padded copy of the input.
//
// Later optimization (not here): an f32 W_hh of one direction is 256 KiB,
// more than a block's 227 KiB of shared memory, so it is read from L2 each
// step. Splitting the 4u columns across a 2-CTA cluster (each CTA keeps
// half of W_hh in shared memory or registers and the two exchange h through
// distributed shared memory) would take the weights off L2 and let the
// matrix products run on the tensor cores.

#include "lstm_common.cuh"

namespace {

using lstm::FwdArgs;
using lstm::View;

constexpr int TM = 16;  // rows per block; TM / 4 cells per thread, c in registers

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
           void* c1, void* c2, int L, int M, int D, int u, int W, cudaStream_t stream) {
  return lstm::launch_fwd<T, R, true, MODE, TM>(
      fused_args<T, R>(emb, wih, b, whh, hs, c1, c2, L, M, D, u, W), 2, stream);
}

template <typename T, int MODE>
int launch_res(const void* emb, const void* wih, const void* b, const void* whh, void* hs,
               void* c1, void* c2, int L, int M, int D, int u, int W, int res_bf16,
               cudaStream_t stream) {
  if (res_bf16)
    return launch<T, __nv_bfloat16, MODE>(emb, wih, b, whh, hs, c1, c2, L, M, D, u, W, stream);
  return launch<T, float, MODE>(emb, wih, b, whh, hs, c1, c2, L, M, D, u, W, stream);
}

}  // namespace

extern "C" {

// emb [L, M, D], wih [2, D, 4u] (both bf16 when bf16 != 0, else f32),
// b [2, 1, 4u] f32, whh [2, u, 4u] f32 -> hs [L, M, 2u] in emb's dtype.
// The caller guarantees 4u <= 512 and contiguous tensors.
int bilstm_infer_fwd(const void* emb, const void* wih, const void* b, const void* whh,
                     void* hs, int L, int M, int D, int u, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16, __nv_bfloat16, lstm::kNone>(emb, wih, b, whh, hs, nullptr,
                                                             nullptr, L, M, D, u, 1, s);
  return launch<float, float, lstm::kNone>(emb, wih, b, whh, hs, nullptr, nullptr, L, M, D, u,
                                           1, s);
}

// K7: as bilstm_infer_fwd, plus ch, cc [ceil(L/W), M, 2u] in bf16 when
// res_bf16 != 0, else f32. The caller guarantees 1 <= W <= L.
int bilstm_win_fwd(const void* emb, const void* wih, const void* b, const void* whh,
                   void* hs, void* ch, void* cc, int L, int M, int D, int u, int W,
                   int bf16, int res_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_res<__nv_bfloat16, lstm::kCkpt>(emb, wih, b, whh, hs, ch, cc, L, M, D, u, W,
                                                  res_bf16, s);
  return launch_res<float, lstm::kCkpt>(emb, wih, b, whh, hs, ch, cc, L, M, D, u, W, res_bf16,
                                        s);
}

// K4: as bilstm_infer_fwd, plus cs [L, M, 2u] (c at every step) in bf16
// when res_bf16 != 0, else f32.
int bilstm_full_fwd(const void* emb, const void* wih, const void* b, const void* whh,
                    void* hs, void* cs, int L, int M, int D, int u, int bf16, int res_bf16,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_res<__nv_bfloat16, lstm::kFull>(emb, wih, b, whh, hs, cs, nullptr, L, M, D,
                                                  u, 1, res_bf16, s);
  return launch_res<float, lstm::kFull>(emb, wih, b, whh, hs, cs, nullptr, L, M, D, u, 1,
                                        res_bf16, s);
}

const char* bilstm_infer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
