// Full-residual fused BiLSTM backward for Hopper (sm_90a): K6, the gradient
// chain.
//
// Replaces: induction_network_on_fewrel_tpu/ops/lstm.py:_fused_bwd_kernel
// (launched by _fused_bwd_call, the backward rule of _bilstm_fused_tm at
// lstm_cs_window = 0), together with csrc/lstm_wgrad.cu. The forward (K4)
// saved hs [L, M, 2u] in the activation dtype and cs [L, M, 2u] (c at every
// step) in the residual dtype. Per (row tile, direction) this kernel walks
// kernel-reverse time; at each step the gates come from emb and h_prev, the
// saved hs at the kernel-previous step (zero at the direction's kernel-first
// step, ops/lstm.py:769-773), and c_t, c_prev from cs. These are the stored,
// rounded values: with a bf16 encoder h_prev is bf16, the full-residual
// mode's defined behaviour. It writes da [2, L, M, 4u] (f32); lstm_wgrad
// then computes demb, dW_ih, db and dW_hh from da, emb and the same shifted
// hs over all rows at once.
//
// What bounds it on this card: the L-step sequential chain per direction
// (no window replay). By bytes and operations the work is tiny next to the
// card's rates.
//
// Design: lstm_cluster_bwd_kernel in kSaved mode (lstm_common.cuh): one
// cluster of C CTAs per (row tile, direction) with resident weight slices;
// the gates do not depend on the carries, so the next step's gates are
// computed while this step's dh parts are in flight; the chain carries only
// da -> dh (a reduce-scatter over the cluster) and dc. Row tile and cluster
// size come from the caller (ops/lstm.py:bwd_plan).

#include "lstm_common.cuh"

namespace {

using lstm::BwdArgs;
using lstm::View;

template <typename T, typename R>
int launch(const void* dhs, const void* emb, const void* hs, const void* cs, const void* wih,
           const void* b, const void* whh, void* da, int L, int M, int D, int u, int tm,
           int cluster, cudaStream_t stream) {
  BwdArgs<T, R> a{};
  a.dhs = static_cast<const T*>(dhs);
  a.x = static_cast<const T*>(emb);
  a.hs = static_cast<const T*>(hs);
  a.c1 = static_cast<const R*>(cs);
  a.wih = static_cast<const T*>(wih);
  a.b = static_cast<const float*>(b);
  a.whh = static_cast<const float*>(whh);
  a.da = static_cast<float*>(da);
  a.xv = View{0, D, (long long)M * D};
  a.hv = View{u, 2LL * u, 2LL * M * u};
  a.L = L; a.M = M; a.D = D; a.u = u; a.W = 0; a.rev_group = 1;
  return lstm::launch_bwd<T, R, true, lstm::kSaved>(a, 2, tm, cluster, stream);
}

}  // namespace

extern "C" {

// dhs, emb, hs [L, M, *] and wih [2, D, 4u] in bf16 when bf16 != 0 (else
// f32); cs [L, M, 2u] in bf16 when res_bf16 != 0 (else f32); b, whh f32.
// Writes da [2, L, M, 4u] (f32). tm and cluster are the caller's plan
// (ops/lstm.py:bwd_plan); a plan the body cannot take returns
// cudaErrorInvalidValue before anything is launched. The caller guarantees
// contiguous tensors.
int bilstm_full_bwd(const void* dhs, const void* emb, const void* hs, const void* cs,
                    const void* wih, const void* b, const void* whh, void* da, int L, int M,
                    int D, int u, int bf16, int res_bf16, int tm, int cluster, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && res_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(dhs, emb, hs, cs, wih, b, whh, da, L, M, D, u,
                                                tm, cluster, s);
  if (bf16)
    return launch<__nv_bfloat16, float>(dhs, emb, hs, cs, wih, b, whh, da, L, M, D, u, tm,
                                        cluster, s);
  if (res_bf16)
    return launch<float, __nv_bfloat16>(dhs, emb, hs, cs, wih, b, whh, da, L, M, D, u, tm,
                                        cluster, s);
  return launch<float, float>(dhs, emb, hs, cs, wih, b, whh, da, L, M, D, u, tm, cluster, s);
}

const char* bilstm_full_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef LSTM_PHASES
// Copy the backward's phase counters (8 x u64) to host memory `out`, and
// zero them when reset != 0 (kernels/fwd_phases.py).
int bilstm_bwd_phases(void* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, lstm::bwd_phase_cycles, 8 * sizeof(long long));
  if (err != cudaSuccess || !reset) return (int)err;
  const unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(lstm::bwd_phase_cycles, zero, sizeof(zero));
}
#endif

}  // extern "C"
