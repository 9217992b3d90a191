// Full-residual fused BiLSTM backward for Hopper (sm_90a): K6.
//
// Replaces: induction_network_on_fewrel_tpu/ops/lstm.py:_fused_bwd_kernel
// (launched by _fused_bwd_call, the backward rule of _bilstm_fused_tm at
// lstm_cs_window = 0). The forward (K4) saved hs [L, M, 2u] in the
// activation dtype and cs [L, M, 2u] (c at every step) in the residual
// dtype. Per (row tile, direction) block, this kernel walks kernel-reverse
// time; at each step it reads c_t from cs, and h_prev from hs and c_prev
// from cs at the kernel-previous step, masked to zero at the direction's
// kernel-first step (ops/lstm.py:769-773). These are the stored, rounded
// values: with a bf16 encoder h_prev is bf16, the full-residual mode's
// defined behaviour. Then the gradient step of K8 (grad_step in
// lstm_common.cuh): gates recomputed in f32, demb [2, L, M, D] per
// direction in the activation dtype, f32 per-tile partial slabs of dW_ih,
// db and dW_hh (in device memory: an f32 dW_hh is 256 KiB, more than a
// block's shared memory), summed over tiles outside the kernel, as the JAX
// call does (ops/lstm.py:943-947).
//
// What bounds it on this card: the L-step sequential chain per direction
// (no window replay: L steps, where K8 takes 2L), with a grid of
// (ceil(M/TM), 2) blocks; per step each thread also updates its (D + u)
// partial entries in L2. By bytes and operations the work is tiny next to
// the card's rates.
//
// Design: the block body of lstm_resid_bwd_kernel (lstm_common.cuh,
// shared with kernel 3 of the split recurrence). TM = 8 rows per block:
// there is no window to hold, so shared memory (4 (4 TM u + TM D + 4 TM u)
// bytes, 34.7 KB at u = 128, D = 60) does not bind; TM = 8 is the tile at
// which K8's step body was measured to stay within 128 registers a thread
// at 512 threads without spills. The ragged last tile is masked in the
// kernel (rows past M read zeros and write nothing); no padded copy.

#include "lstm_common.cuh"

namespace {

using lstm::BwdArgs;
using lstm::View;

constexpr int TM = 8;

template <typename T, typename R>
int launch(const void* dhs, const void* emb, const void* hs, const void* cs, const void* wih,
           const void* b, const void* whh, void* demb, void* dwih_p, void* db_p, void* dwhh_p,
           int L, int M, int D, int u, cudaStream_t stream) {
  BwdArgs<T, R> a{};
  a.dhs = static_cast<const T*>(dhs);
  a.x = static_cast<const T*>(emb);
  a.hs = static_cast<const T*>(hs);
  a.c1 = static_cast<const R*>(cs);
  a.wih = static_cast<const T*>(wih);
  a.b = static_cast<const float*>(b);
  a.whh = static_cast<const float*>(whh);
  a.dx = static_cast<T*>(demb);
  a.dwih_p = static_cast<float*>(dwih_p);
  a.db_p = static_cast<float*>(db_p);
  a.dwhh_p = static_cast<float*>(dwhh_p);
  a.xv = View{0, D, (long long)M * D};
  a.hv = View{u, 2LL * u, 2LL * M * u};
  a.L = L; a.M = M; a.D = D; a.u = u; a.W = 0; a.rev_group = 1;
  return lstm::launch_resid_bwd<T, R, true, TM>(a, 2, stream);
}

}  // namespace

extern "C" {

// dhs, emb, hs [L, M, *] and wih [2, D, 4u] in bf16 when bf16 != 0 (else
// f32); cs [L, M, 2u] in bf16 when res_bf16 != 0 (else f32); b, whh f32.
// Writes demb [2, L, M, D] (emb's dtype) and the f32 per-tile partials
// dwih_p [2, ceil(M/tm), D, 4u], db_p [2, ceil(M/tm), 4u] and
// dwhh_p [2, ceil(M/tm), u, 4u]. tm is the caller's row tile, which sizes
// the partials: any other value than the compiled TM = 8 is refused with
// cudaErrorInvalidValue before anything is launched. The caller guarantees
// 4u <= 512 and a multiple of 32, that 4 (64 u + 8 D) bytes of shared
// memory fit a block, and contiguous tensors.
int bilstm_full_bwd(const void* dhs, const void* emb, const void* hs, const void* cs,
                    const void* wih, const void* b, const void* whh, void* demb, void* dwih_p,
                    void* db_p, void* dwhh_p, int L, int M, int D, int u, int tm, int bf16,
                    int res_bf16, void* stream) {
  if (tm != TM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && res_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(dhs, emb, hs, cs, wih, b, whh, demb, dwih_p,
                                                db_p, dwhh_p, L, M, D, u, s);
  if (bf16)
    return launch<__nv_bfloat16, float>(dhs, emb, hs, cs, wih, b, whh, demb, dwih_p, db_p,
                                        dwhh_p, L, M, D, u, s);
  if (res_bf16)
    return launch<float, __nv_bfloat16>(dhs, emb, hs, cs, wih, b, whh, demb, dwih_p, db_p,
                                        dwhh_p, L, M, D, u, s);
  return launch<float, float>(dhs, emb, hs, cs, wih, b, whh, demb, dwih_p, db_p, dwhh_p, L, M,
                              D, u, s);
}

const char* bilstm_full_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
