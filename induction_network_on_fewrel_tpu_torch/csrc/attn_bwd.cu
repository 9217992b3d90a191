// Structured self-attention backward for Hopper (sm_90a): K11.
//
// Replaces: induction_network_on_fewrel_tpu/ops/attn.py:_bwd_kernel
// (launched by _bwd_call, the backward rule _attn_core_bwd of both the
// "pallas" and the "xla_remat" attention). From the forward's saved
// softmax stats mx, dn [M] it rebuilds, per token (t, m),
//
//   T_t    = tanh(W1^T h_t)                         [A]
//   a_t    = exp(s_t - mx) [mask > 0] / (dn + 1e-13),  s_t = w2 . T_t
//   ds_t   = a_t (dout . h_t - dout . out)          (out saved in H's dtype)
//   dproj  = ds_t (1 - T_t^2) * w2                  [A]
//   dH_t   = a_t dout + W1 dproj                    written in H's dtype
//   dW1    = sum_t h_t dproj^T;  dw2 = sum_t ds_t T_t
//
// all in f32 (dout arrives in H's dtype, attn.py:334). A fully masked row
// has a_t = 0 everywhere and writes exact zeros; the mask gets no gradient.
//
// What bounds it on this card: f32 operations (three products of 2 D A a
// token: 12 us at the FP32 peak at M = 200, against 2.5 us for reading H
// and writing dH in bf16).
//
// Design. Nothing in the backward runs along time: mx, dn and dout . out
// are fixed per row, so every token is independent apart from the weight
// gradients' sums. Two launches:
//
// 1. attn_bwd_token_kernel, parallel over the N = L M tokens (H viewed as
//    [N, D]): a CTA owns a tile of R tokens (ops/attn.py:attn_bwd_plan
//    picks R so that the tiles fill the card: 32 at M = 200, 250 CTAs; 8
//    at M = 16, 80 CTAs) and runs P = H W1 and dH - a dout = dproj W1^T as
//    register-tiled products (csrc/attn_common.cuh; any D and A), with the
//    per-token scalars between them. It writes dH and streams dproj and
//    T ds [N, A] in f32.
// 2. attn_wgrad_kernel: [dW1 | dw2] = [H | 1]^T [dproj | T ds] in 32 x 64
//    tiles. Each tile splits the N tokens over a cluster of WSPLIT = 16
//    CTAs (M = 200: 9 tiles, 144 CTAs of 500 tokens); after a cluster
//    barrier CTA q sums rows [2q, 2q + 2) of the tile over the 16 partials
//    in rank order through distributed shared memory (as
//    csrc/lstm_wgrad.cu). No atomics and no partial slabs: the outputs
//    repeat bit for bit, with no reduction launched after the kernel.
//
// Why two launches and not one: the weight gradients sum over all tokens,
// across every CTA of the token launch, and a fixed-order sum across
// clusters needs a grid-wide barrier or a second pass; the second pass
// reads back 2 N A f32 (4 MB at M = 200) from L2.

#include "attn_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace attn;

template <typename T>
struct BwdArgs {
  const T* H;         // [L, M, D] = [N, D]
  const float* mask;  // [M, L]
  const float* w1;    // [D, A]
  const float* w2;    // [A]
  const T* out;       // [M, D]
  const float* mx;    // [M]
  const float* dn;    // [M]
  const T* dout;      // [M, D]
  T* dH;              // [N, D]
  float* dproj;       // [N, A]
  float* tds;         // [N, A]  T ds
  float* dw1;         // [D, A]
  float* dw2;         // [A]
  int L, M, D, A;
};

// Grid ceil(N / R), 256 threads.
template <typename T, int R>
__global__ void __launch_bounds__(THREADS) attn_bwd_token_kernel(BwdArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  const int L = a.L, M = a.M, D = a.D, A = a.A, N = L * M;
  const int n0 = (int)blockIdx.x * R;
  float* eng = smem;
  float* t_s = eng + engine_floats(R);   // [R, A]  T, then dproj
  float* a_s = t_s + R * A;              // [R]     a_t
  float* ds_s = a_s + R;                 // [R]     ds_t
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // T = tanh(H W1) for the tile, 64 columns of A at a time.
  for (int a0 = 0; a0 < A; a0 += CW) {
    tile_product<R, true, false>(
        eng, D,
        [&](int k, int r) { return n0 + r < N ? to_f32(a.H[(size_t)(n0 + r) * D + k]) : 0.0f; },
        [&](int k, int c) { return a0 + c < A ? a.w1[(size_t)k * A + a0 + c] : 0.0f; },
        [&](int r, int c, float v) {
          if (a0 + c < A) t_s[r * A + a0 + c] = tanhf(v);
        });
  }
  // Per token: s, dout . h, dout . out (one warp a token), then a_t, ds_t.
  for (int r = warp; r < R; r += THREADS / 32) {
    const int n = n0 + r;
    if (n >= N) {
      if (lane == 0) a_s[r] = ds_s[r] = 0.0f;
      continue;
    }
    const int m = n % M, t = n / M;
    float sv = 0.0f, dv = 0.0f, cv = 0.0f;
    for (int j = lane; j < A; j += 32) sv = fmaf(t_s[r * A + j], a.w2[j], sv);
    const T* h = a.H + (size_t)n * D;
    const T* dorow = a.dout + (size_t)m * D;
    const T* orow = a.out + (size_t)m * D;
    for (int d = lane; d < D; d += 32) {
      const float g = to_f32(dorow[d]);
      dv = fmaf(g, to_f32(h[d]), dv);
      cv = fmaf(g, to_f32(orow[d]), cv);
    }
    sv = warp_sum(sv);
    dv = warp_sum(dv);
    cv = warp_sum(cv);
    if (lane == 0) {
      const float at = a.mask[(size_t)m * L + t] > 0.0f ? expf(sv - a.mx[m]) / (a.dn[m] + 1e-13f)
                                                        : 0.0f;
      a_s[r] = at;
      ds_s[r] = at * (dv - cv);
    }
  }
  __syncthreads();
  // dproj = ds (1 - T^2) w2 in place of T; stream dproj and T ds.
  for (int i = tid; i < R * A; i += THREADS) {
    const int r = i / A, j = i - r * A, n = n0 + r;
    if (n >= N) {
      t_s[i] = 0.0f;
      continue;
    }
    const float tv = t_s[i], ds = ds_s[r];
    const float dp = ds * (1.0f - tv * tv) * a.w2[j];
    a.tds[(size_t)n * A + j] = tv * ds;
    a.dproj[(size_t)n * A + j] = dp;
    t_s[i] = dp;
  }
  // dH = a dout + dproj W1^T, 64 columns of D at a time.
  for (int d0 = 0; d0 < D; d0 += CW) {
    tile_product<R, true, true>(
        eng, A, [&](int k, int r) { return t_s[r * A + k]; },
        [&](int k, int c) { return d0 + c < D ? a.w1[(size_t)(d0 + c) * A + k] : 0.0f; },
        [&](int r, int c, float v) {
          const int n = n0 + r, d = d0 + c;
          if (n < N && d < D)
            a.dH[(size_t)n * D + d] =
                from_f32<T>(fmaf(a_s[r], to_f32(a.dout[(size_t)(n % M) * D + d]), v));
        });
  }
}

// Grid (weight tiles * WSPLIT), clusters of (WSPLIT, 1, 1), 256 threads.
// Tile i < DT * AT is dW1 rows [WR (i / AT), +WR) x columns [64 (i % AT),
// +64); the AT tiles after them are dw2's columns (row 0 of 1^T T ds).
template <typename T>
__global__ void __launch_bounds__(THREADS) attn_wgrad_kernel(BwdArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int D = a.D, A = a.A, N = a.L * a.M;
  const int AT = (A + CW - 1) / CW, DT = (D + WR - 1) / WR;
  const int tile = (int)blockIdx.x / WSPLIT;
  const bool w1_tile = tile < DT * AT;
  const int k0 = w1_tile ? tile / AT * WR : 0;
  const int c0 = (w1_tile ? tile % AT : tile - DT * AT) * CW;
  const int chunk = (N + WSPLIT - 1) / WSPLIT, nb = rank * chunk;
  const int K = max(0, min(N, nb + chunk) - nb);
  float* eng = smem;
  float* part = eng + engine_floats(WR);   // [WR, CW]
  auto store = [&](int r, int c, float v) { part[r * CW + c] = v; };
  if (w1_tile) {
    tile_product<WR, false, false>(
        eng, K,
        [&](int k, int r) { return k0 + r < D ? to_f32(a.H[(size_t)(nb + k) * D + k0 + r]) : 0.0f; },
        [&](int k, int c) { return c0 + c < A ? a.dproj[(size_t)(nb + k) * A + c0 + c] : 0.0f; },
        store);
  } else {
    tile_product<WR, false, false>(
        eng, K, [](int, int r) { return r == 0 ? 1.0f : 0.0f; },
        [&](int k, int c) { return c0 + c < A ? a.tds[(size_t)(nb + k) * A + c0 + c] : 0.0f; },
        store);
  }
  cluster.sync();  // every partial tile of the cluster is written
  constexpr int ROWS = WR / WSPLIT;
  for (int idx = threadIdx.x; idx < ROWS * CW; idx += THREADS) {
    const int r = rank * ROWS + idx / CW, c = idx % CW;
    float s = 0.0f;
    for (int q = 0; q < WSPLIT; ++q) s += cluster.map_shared_rank(part, q)[r * CW + c];
    if (c0 + c >= A) continue;
    if (w1_tile) {
      if (k0 + r < D) a.dw1[(size_t)(k0 + r) * A + c0 + c] = s;
    } else if (r == 0) {
      a.dw2[c0 + c] = s;
    }
  }
  cluster.sync();  // no CTA leaves while a peer may still read its partial
}

template <typename T, int R>
int launch_tokens(const BwdArgs<T>& a, cudaStream_t stream) {
  static int smem_set[64];
  const size_t smem = bwd_smem(R, a.A);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(attn_bwd_token_kernel<T, R>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int N = a.L * a.M;
  attn_bwd_token_kernel<T, R><<<(N + R - 1) / R, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wgrad(const BwdArgs<T>& a, cudaStream_t stream) {
  static int smem_set[64];
  const size_t smem = wgrad_smem();
  cudaError_t err = allow_smem(attn_wgrad_kernel<T>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  // A cluster of 16 CTAs is past the portable 8 (the attribute is per device).
  err = cudaFuncSetAttribute(attn_wgrad_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  const int AT = (a.A + CW - 1) / CW, DT = (a.D + WR - 1) / WR;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((DT * AT + AT) * WSPLIT), 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = WSPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, attn_wgrad_kernel<T>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* H, const void* mask, const void* w1, const void* w2, const void* out,
           const void* mx, const void* dn, const void* dout, void* dH, void* dproj, void* tds,
           void* dw1, void* dw2, int L, int M, int D, int A, int tile, cudaStream_t stream) {
  BwdArgs<T> a{};
  a.H = static_cast<const T*>(H);
  a.mask = static_cast<const float*>(mask);
  a.w1 = static_cast<const float*>(w1);
  a.w2 = static_cast<const float*>(w2);
  a.out = static_cast<const T*>(out);
  a.mx = static_cast<const float*>(mx);
  a.dn = static_cast<const float*>(dn);
  a.dout = static_cast<const T*>(dout);
  a.dH = static_cast<T*>(dH);
  a.dproj = static_cast<float*>(dproj);
  a.tds = static_cast<float*>(tds);
  a.dw1 = static_cast<float*>(dw1);
  a.dw2 = static_cast<float*>(dw2);
  a.L = L; a.M = M; a.D = D; a.A = A;
  int err;
  switch (tile) {
    case 8: err = launch_tokens<T, 8>(a, stream); break;
    case 16: err = launch_tokens<T, 16>(a, stream); break;
    case 32: err = launch_tokens<T, 32>(a, stream); break;
    case 64: err = launch_tokens<T, 64>(a, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return launch_wgrad<T>(a, stream);
}

}  // namespace

extern "C" {

// H [L, M, D], out and dout [M, D] (bf16 when bf16 != 0, else f32); mask
// [M, L], w1 [D, A], w2 [A, 1], mx and dn [M] f32 -> dH [L, M, D] in H's
// dtype, dw1 [D, A] and dw2 [A, 1] f32, through the f32 scratch streams
// dproj and tds [L M, A]. tile (ops/attn.py:attn_bwd_plan) is the token
// kernel's R in {8, 16, 32, 64}. Two launches on the stream. The caller
// guarantees L, M >= 1 and contiguous tensors.
int attn_bwd(const void* H, const void* mask, const void* w1, const void* w2, const void* out,
             const void* mx, const void* dn, const void* dout, void* dH, void* dproj, void* tds,
             void* dw1, void* dw2, int L, int M, int D, int A, int tile, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(H, mask, w1, w2, out, mx, dn, dout, dH, dproj, tds, dw1, dw2, L,
                                 M, D, A, tile, s);
  return launch<float>(H, mask, w1, w2, out, mx, dn, dout, dH, dproj, tds, dw1, dw2, L, M, D, A,
                       tile, s);
}

const char* attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
