// One-pass online-softmax structured self-attention forward for Hopper (sm_90a).
//
// K2 (attn_fwd) replaces induction_network_on_fewrel_tpu/ops/attn.py:
// _make_fwd_kernel(with_stats=False), i.e. _fwd_kernel_infer, launched by
// _fwd_call. K10 (attn_fwd_stats) replaces _make_fwd_kernel(with_stats=True),
// the training forward of _attn_core: the SAME body with the compile-time
// flag STATS, which also writes the row's final running max mx [M] and
// normalizer dn [M] (f32), the only residuals the backward (K11) needs. As
// on the TPU, one body serves both, so the no-grad and the training forward
// share their numerics by construction:
//
//   s_t   = w2 . tanh(W1^T h_t)                (f32, whatever H's dtype)
//   a     = masked_softmax_t(s)                (mask <= 0 -> excluded)
//   out   = sum_t a_t h_t / (sum_t e_t + 1e-13), written in H's dtype
//
// as a running max m, normalizer d and weighted sum acc[D] over time, so H
// is read from device memory once. e_t is multiplied by the 0/1 mask after
// the shift (attn.py:147), so a fully-masked row keeps d = 0 and acc = 0
// and writes exact zeros.
//
// What bounds it on this card: bytes at large M (H is read once: 40 x 256
// values per row), but at serving sizes (1-16 rows, one block each) it is
// latency-bound by the per-chunk block synchronizations. The work per row
// is ~0.7 MFLOP of f32 projection, small next to the card's rate.
//
// Design (simple and right first): one block per row. W1 [D, A] (64 KiB in
// f32 at D = 256, A = 64) and w2 are staged into shared memory once per
// block; time runs in chunks of TLC steps. Per chunk the block stages the
// TLC hidden vectors of its row (f32), computes the TLC x A projections
// (one output per thread and pass, consecutive threads on consecutive
// columns of W1, so shared-memory reads are conflict-free and h is a
// broadcast), reduces tanh(.) * w2 over A per step with warp shuffles, and
// then each thread advances the online softmax for its own columns d of
// acc over the chunk's steps. There is no padded copy: steps past L are
// skipped and the row's mask is read directly.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int TLC = 8;            // time steps per chunk
constexpr int MAX_DPT = 4;        // columns of acc per thread: D <= 1024
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, bool STATS>
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const T* __restrict__ H,         // [L, M, D]
                const float* __restrict__ mask,  // [M, L]
                const float* __restrict__ w1,    // [D, A]
                const float* __restrict__ w2,    // [A]
                T* __restrict__ out,             // [M, D]
                float* __restrict__ mx,          // [M] (STATS only)
                float* __restrict__ dn,          // [M] (STATS only)
                int L, int M, int D, int A) {
  extern __shared__ float smem[];
  float* w1_s = smem;                 // [D, A]
  float* w2_s = w1_s + D * A;         // [A]
  float* h_s = w2_s + A;              // [TLC, D]
  float* p_s = h_s + TLC * D;         // [TLC, A]  tanh(proj) * w2
  float* s_s = p_s + TLC * A;         // [TLC]     scores

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int m = blockIdx.x;

  for (int i = tid; i < D * A; i += THREADS) w1_s[i] = w1[i];
  for (int i = tid; i < A; i += THREADS) w2_s[i] = w2[i];

  float acc[MAX_DPT];
#pragma unroll
  for (int q = 0; q < MAX_DPT; ++q) acc[q] = 0.0f;
  float run_max = NEG, den = 0.0f;

  for (int t0 = 0; t0 < L; t0 += TLC) {
    const int n = min(TLC, L - t0);
    __syncthreads();  // previous chunk's h_s / s_s reads are done (and w1_s staged)
    for (int i = tid; i < n * D; i += THREADS) {
      const int tl = i / D, d = i - tl * D;
      h_s[i] = to_f32(H[((size_t)(t0 + tl) * M + m) * D + d]);
    }
    __syncthreads();
    for (int o = tid; o < n * A; o += THREADS) {
      const int tl = o / A, a = o - tl * A;
      const float* h = h_s + tl * D;
      float p = 0.0f;
      for (int d = 0; d < D; ++d) p = fmaf(h[d], w1_s[d * A + a], p);
      p_s[o] = tanhf(p) * w2_s[a];
    }
    __syncthreads();
    for (int tl = warp; tl < n; tl += THREADS / 32) {
      float v = 0.0f;
      for (int a = lane; a < A; a += 32) v += p_s[tl * A + a];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) s_s[tl] = v;
    }
    __syncthreads();
    for (int tl = 0; tl < n; ++tl) {
      const bool valid = mask[(size_t)m * L + t0 + tl] > 0.0f;
      const float s = valid ? s_s[tl] : NEG;
      const float m_new = fmaxf(run_max, s);
      const float corr = expf(run_max - m_new);
      const float e = valid ? expf(s - m_new) : 0.0f;
      den = den * corr + e;
#pragma unroll
      for (int q = 0; q < MAX_DPT; ++q) {
        const int d = tid + q * THREADS;
        if (d < D) acc[q] = acc[q] * corr + e * h_s[tl * D + d];
      }
      run_max = m_new;
    }
  }
  const float inv = 1.0f / (den + 1e-13f);
#pragma unroll
  for (int q = 0; q < MAX_DPT; ++q) {
    const int d = tid + q * THREADS;
    if (d < D) out[(size_t)m * D + d] = from_f32<T>(acc[q] * inv);
  }
  if (STATS && tid == 0) {  // every thread carries the same run_max and den
    mx[m] = run_max;
    dn[m] = den;
  }
}

template <typename T, bool STATS>
int launch(const void* H, const void* mask, const void* w1, const void* w2, void* out,
           void* mx, void* dn, int L, int M, int D, int A, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)D * A + A + TLC * D + TLC * A + TLC);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<T, STATS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_fwd_kernel<T, STATS><<<M, THREADS, smem, stream>>>(
      static_cast<const T*>(H), static_cast<const float*>(mask),
      static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<T*>(out), static_cast<float*>(mx), static_cast<float*>(dn), L, M, D, A);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// H [L, M, D] (bf16 when bf16 != 0, else f32), mask [M, L] f32,
// w1 [D, A] f32, w2 [A, 1] f32 -> out [M, D] in H's dtype.
// The caller guarantees D <= 1024, M >= 1 and contiguous tensors.
int attn_fwd(const void* H, const void* mask, const void* w1, const void* w2, void* out,
             int L, int M, int D, int A, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16, false>(H, mask, w1, w2, out, nullptr, nullptr, L, M, D, A, s);
  return launch<float, false>(H, mask, w1, w2, out, nullptr, nullptr, L, M, D, A, s);
}

// K10: as attn_fwd, plus mx, dn [M] f32 (the row's softmax max and normalizer).
int attn_fwd_stats(const void* H, const void* mask, const void* w1, const void* w2, void* out,
                   void* mx, void* dn, int L, int M, int D, int A, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16, true>(H, mask, w1, w2, out, mx, dn, L, M, D, A, s);
  return launch<float, true>(H, mask, w1, w2, out, mx, dn, L, M, D, A, s);
}

const char* attn_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
