// Windowed fused BiLSTM backward for Hopper (sm_90a): K8, the gradient chain.
//
// Replaces: induction_network_on_fewrel_tpu/ops/lstm.py:_fused_win_bwd_kernel
// (launched by _fused_win_bwd_call, the backward rule of _bilstm_fused_tm at
// lstm_cs_window = W > 0), together with csrc/lstm_wgrad.cu. The forward
// (K7) kept one (h, c) checkpoint pair per natural-time block
// [bW, min(bW+W, L)); this kernel walks each direction in kernel-reverse
// time and, on entering a block, replays its forward steps in f32 from the
// seed (the checkpoint of the kernel-previous block: b-1 for the forward
// direction, b+1 for the reverse one; zero for the direction's kernel-first
// block), then takes the block's gradient steps (ops/lstm.py:1067-1107).
// It writes da [2, L, M, 4u] and the h_prev of every step hp [2, L, M, u]
// (f32): at a block's kernel-first step h_prev is the seed, rounded to the
// residual dtype, not the f32 replayed h of the neighbouring block, so
// dW_hh needs it stored. lstm_wgrad then computes demb, dW_ih, db and dW_hh
// from da, emb and hp over all rows at once.
//
// The ragged last block (L % W != 0) is replayed for its Wb = L - bW steps
// only, so nothing past L is read (the TPU kernel selects the carried state
// on those lanes instead). Rows past M read zero embeddings, seeds and dhs,
// so their da is exactly zero; they are not written.
//
// What bounds it on this card: the sequential chain, 2L steps per
// direction (replay + gradient). By bytes and operations the work is tiny
// next to the card's rates.
//
// Design: lstm_cluster_bwd_kernel in kWindow mode (lstm_common.cuh): one
// cluster of C CTAs per (row tile, direction), each keeping its W_hh, W_ih
// and b slices resident; the replay is the forward's cluster step, keeping
// the own cells' gates and c of every window step in shared memory, so the
// gradient steps recompute no gates and carry only da -> dh (a
// reduce-scatter over the cluster) and dc. Row tile and cluster size come
// from the caller (ops/lstm.py:bwd_plan).

#include "lstm_common.cuh"

namespace {

using lstm::BwdArgs;
using lstm::View;

template <typename T, typename R>
int launch(const void* dhs, const void* emb, const void* ch, const void* cc, const void* wih,
           const void* b, const void* whh, void* da, void* hp, int L, int M, int D, int u, int W,
           int tm, int cluster, cudaStream_t s) {
  BwdArgs<T, R> a{};
  a.dhs = static_cast<const T*>(dhs);
  a.x = static_cast<const T*>(emb);
  a.c1 = static_cast<const R*>(ch);
  a.c2 = static_cast<const R*>(cc);
  a.wih = static_cast<const T*>(wih);
  a.b = static_cast<const float*>(b);
  a.whh = static_cast<const float*>(whh);
  a.da = static_cast<float*>(da);
  a.hp = static_cast<float*>(hp);
  a.xv = View{0, D, (long long)M * D};
  a.hv = View{u, 2LL * u, 2LL * M * u};
  a.L = L; a.M = M; a.D = D; a.u = u; a.W = W; a.rev_group = 1;
  return lstm::launch_bwd<T, R, true, lstm::kWindow>(a, 2, tm, cluster, s);
}

}  // namespace

extern "C" {

// dhs, emb [L, M, *] and wih [2, D, 4u] in bf16 when bf16 != 0 (else f32);
// ch, cc [ceil(L/W), M, 2u] in bf16 when res_bf16 != 0 (else f32); b, whh
// f32. Writes da [2, L, M, 4u] and hp [2, L, M, u] (f32). tm and cluster
// are the caller's plan (ops/lstm.py:bwd_plan); a plan the body cannot take
// returns cudaErrorInvalidValue before anything is launched. The caller
// guarantees 1 <= W <= L and contiguous tensors.
int bilstm_win_bwd(const void* dhs, const void* emb, const void* ch, const void* cc,
                   const void* wih, const void* b, const void* whh, void* da, void* hp, int L,
                   int M, int D, int u, int W, int bf16, int res_bf16, int tm, int cluster,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && res_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(dhs, emb, ch, cc, wih, b, whh, da, hp, L, M, D,
                                                u, W, tm, cluster, s);
  if (bf16)
    return launch<__nv_bfloat16, float>(dhs, emb, ch, cc, wih, b, whh, da, hp, L, M, D, u, W, tm,
                                        cluster, s);
  if (res_bf16)
    return launch<float, __nv_bfloat16>(dhs, emb, ch, cc, wih, b, whh, da, hp, L, M, D, u, W, tm,
                                        cluster, s);
  return launch<float, float>(dhs, emb, ch, cc, wih, b, whh, da, hp, L, M, D, u, W, tm, cluster,
                              s);
}

const char* bilstm_win_bwd_error_string(int code) {
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
