// LSTM recurrence over pre-projected gates for Hopper (sm_90a): kernels 1,
// 2 and 3 of the split recurrence (ops API lstm_recurrence,
// lstm_recurrence_grouped, bilstm_recurrence_tm).
//
// Replaces, in induction_network_on_fewrel_tpu/ops/lstm.py:
//   kernel 2 (lstm_split_fwd_infer): _fwd_kernel_infer (launched by
//     _fwd_call_infer and _fwd_call_tm_infer, the no-grad primal): hs only;
//   kernel 1 (lstm_split_fwd): _fwd_kernel (_fwd_call, _fwd_call_tm, the
//     training forward): hs and cs at every step, both in xg's dtype;
//   kernel 3 (lstm_split_bwd): _bwd_kernel (_bwd_call, _bwd_call_tm),
//     together with csrc/lstm_wgrad.cu: kernel-reverse walk over the saved
//     hs/cs, gates recomputed from xg + h_prev W_hh, dxg = da written every
//     step in xg's dtype and da in f32; lstm_wgrad sums dW_hh = h_prev^T da
//     over all rows at once.
// Per group g (a direction): a_t = xg_t + h_{t-1} W_hh[g], gate order
// [i, f, g, o], h and c carried in f32; W_hh is f32.
//
// Layouts run in place: every tensor is passed as a (group, row, time)
// view with unit column stride, so the grouped [Gc, M, L, 4u] input and the
// time-major [L, M, Gc*4u] one (whose group 1 walks time reversed, as the
// JAX index maps do) need no transpose, flip or pad copy (the JAX call
// pads and transposes, ops/lstm.py:266-287).
//
// What bounds them on this card: as K1 and K6, the L-step sequential chain;
// bytes (xg streamed once, 4u values per row and step) and operations are
// far below the card's rates at these sizes.
//
// Design: kernels 1 and 2 are the cluster forward body
// lstm_cluster_fwd_kernel (lstm_common.cuh, K1's) without the projection:
// one cluster of C CTAs per (row tile, group), each CTA keeping its W_hh
// slice in shared memory and exchanging h through distributed shared
// memory; the next step's input gates are xg read in place (coalesced
// within each gate's unit slice) while the peers' h is in flight. Kernel 3
// is lstm_cluster_bwd_kernel (K6's body) without the projection: it writes
// dxg = da (and the f32 da stream) where K6 writes only da. TM and C come
// from the caller (ops/lstm.py:fwd_plan, bwd_plan).

#include "lstm_common.cuh"

namespace {

using lstm::BwdArgs;
using lstm::FwdArgs;
using lstm::View;

template <typename T, int MODE>
int launch_fwd(const void* xg, const void* whh, void* hs, void* cs, int L, int M, int u, int Gc,
               View xv, View hv, int rev_group, int tm, int cluster, cudaStream_t stream) {
  FwdArgs<T, T> a{};
  a.x = static_cast<const T*>(xg);
  a.whh = static_cast<const float*>(whh);
  a.hs = static_cast<T*>(hs);
  a.c1 = static_cast<T*>(cs);
  a.xv = xv;
  a.hv = hv;
  a.L = L; a.M = M; a.D = 0; a.u = u; a.W = 1; a.rev_group = rev_group;
  return lstm::launch_fwd<T, T, false, MODE>(a, Gc, tm, cluster, stream);
}

template <typename T>
int launch_bwd(const void* dhs, const void* xg, const void* hs, const void* cs, const void* whh,
               void* dxg, void* da, int L, int M, int u, int Gc, View xv, View hv,
               int rev_group, int tm, int cluster, cudaStream_t stream) {
  BwdArgs<T, T> a{};
  a.dhs = static_cast<const T*>(dhs);
  a.x = static_cast<const T*>(xg);
  a.hs = static_cast<const T*>(hs);
  a.c1 = static_cast<const T*>(cs);
  a.whh = static_cast<const float*>(whh);
  a.dx = static_cast<T*>(dxg);
  a.da = static_cast<float*>(da);
  a.xv = xv;
  a.hv = hv;
  a.L = L; a.M = M; a.D = 0; a.u = u; a.W = 0; a.rev_group = rev_group;
  return lstm::launch_bwd<T, T, false, lstm::kSaved>(a, Gc, tm, cluster, stream);
}

}  // namespace

extern "C" {

// Common arguments: xg (group, row, time) element strides x_g, x_m, x_t
// (unit column stride, 4u columns a group) in bf16 when bf16 != 0, else
// f32; hs, cs and dhs share the strides h_g, h_m, h_t (u columns a group)
// and xg's dtype; whh [Gc, u, 4u] f32 contiguous; rev_group is the group
// that walks time reversed (-1: none). Every launcher takes the caller's
// plan before the stream: row tile tm and cluster size (ops/lstm.py:fwd_plan
// for the forwards, bwd_plan for kernel 3); a plan the body cannot take
// returns cudaErrorInvalidValue before anything is launched.

// Kernel 2: hs only.
int lstm_split_fwd_infer(const void* xg, const void* whh, void* hs, int L, int M, int u, int Gc,
                         long long x_g, long long x_m, long long x_t, long long h_g,
                         long long h_m, long long h_t, int rev_group, int bf16, int tm,
                         int cluster, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const View xv{x_g, x_m, x_t}, hv{h_g, h_m, h_t};
  if (bf16)
    return launch_fwd<__nv_bfloat16, lstm::kNone>(xg, whh, hs, nullptr, L, M, u, Gc, xv, hv,
                                                  rev_group, tm, cluster, s);
  return launch_fwd<float, lstm::kNone>(xg, whh, hs, nullptr, L, M, u, Gc, xv, hv, rev_group,
                                        tm, cluster, s);
}

// Kernel 1: hs and cs.
int lstm_split_fwd(const void* xg, const void* whh, void* hs, void* cs, int L, int M, int u,
                   int Gc, long long x_g, long long x_m, long long x_t, long long h_g,
                   long long h_m, long long h_t, int rev_group, int bf16, int tm, int cluster,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const View xv{x_g, x_m, x_t}, hv{h_g, h_m, h_t};
  if (bf16)
    return launch_fwd<__nv_bfloat16, lstm::kFull>(xg, whh, hs, cs, L, M, u, Gc, xv, hv,
                                                  rev_group, tm, cluster, s);
  return launch_fwd<float, lstm::kFull>(xg, whh, hs, cs, L, M, u, Gc, xv, hv, rev_group, tm,
                                        cluster, s);
}

// Kernel 3: dxg (xg's strides and dtype) and da [Gc, L, M, 4u] (f32,
// contiguous). tm and cluster are the caller's plan (ops/lstm.py:bwd_plan).
int lstm_split_bwd(const void* dhs, const void* xg, const void* hs, const void* cs,
                   const void* whh, void* dxg, void* da, int L, int M, int u, int Gc,
                   long long x_g, long long x_m, long long x_t, long long h_g, long long h_m,
                   long long h_t, int rev_group, int bf16, int tm, int cluster, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const View xv{x_g, x_m, x_t}, hv{h_g, h_m, h_t};
  if (bf16)
    return launch_bwd<__nv_bfloat16>(dhs, xg, hs, cs, whh, dxg, da, L, M, u, Gc, xv, hv,
                                     rev_group, tm, cluster, s);
  return launch_bwd<float>(dhs, xg, hs, cs, whh, dxg, da, L, M, u, Gc, xv, hv, rev_group, tm,
                           cluster, s);
}

const char* lstm_split_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
