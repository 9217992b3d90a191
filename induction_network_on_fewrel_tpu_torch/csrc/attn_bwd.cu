// One-pass structured self-attention backward for Hopper (sm_90a): K11.
//
// Replaces: induction_network_on_fewrel_tpu/ops/attn.py:_bwd_kernel
// (launched by _bwd_call, the backward rule _attn_core_bwd of both the
// "pallas" and the "xla_remat" attention). From the forward's saved
// softmax stats mx, dn [M] it rebuilds, per row m and step t,
//
//   tl_t   = tanh(W1^T h_t)                         [A]
//   a_t    = exp(s_t - mx) [mask > 0] / (dn + 1e-13),  s_t = w2 . tl_t
//   ds_t   = a_t (dout . h_t - dout . out)          (out saved in H's dtype)
//   dproj  = ds_t (1 - tl_t^2) * w2                 [A]
//   dH_t   = a_t dout + W1 dproj                    written in H's dtype
//   dW1   += h_t dproj^T;  dw2 += ds_t tl_t
//
// in one pass over H, all in f32 (dout arrives in H's dtype, attn.py:334).
// A fully masked row has a_t = 0 everywhere and writes exact zeros; the
// mask itself gets no gradient.
//
// What bounds it on this card: bytes at large M (H read once, dH written
// once), but at the flagship's M = 200 it is latency-bound by the per-chunk
// block barriers, like K2. Work per row-step: two [D] x [D, A] products.
//
// Design (simple and right first): one block walks rb rows in turn; W1 is
// staged once per block into shared memory with a padded row stride A + 1,
// so both the projection (threads along A) and W1 dproj (threads along D)
// read it without bank conflicts. dW1 [D, A] (64 KiB f32 at D = 256,
// A = 64) accumulates in shared memory over the block's rows, each thread
// owning fixed entries, and dw2 in a register of thread a; each block
// writes its own f32 partials, summed over blocks outside the kernel (as
// the JAX call sums its per-tile partials, attn.py:309). Time runs in
// chunks of TLC steps; steps past L are skipped, not padded.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int TLC = 8;    // time steps per chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

size_t smem_bytes(int D, int A) {
  return sizeof(float) * ((size_t)D * (A + 1) + (size_t)D * A + A + D + TLC * D +
                          2 * TLC * A + 2 * TLC + THREADS / 32);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_bwd_kernel(const T* __restrict__ H,         // [L, M, D]
                const float* __restrict__ mask,  // [M, L]
                const float* __restrict__ w1,    // [D, A]
                const float* __restrict__ w2,    // [A]
                const T* __restrict__ out,       // [M, D]
                const float* __restrict__ mx,    // [M]
                const float* __restrict__ dn,    // [M]
                const T* __restrict__ dout,      // [M, D]
                T* __restrict__ dH,              // [L, M, D]
                float* __restrict__ dw1_p,       // [nblk, D, A]
                float* __restrict__ dw2_p,       // [nblk, A]
                int L, int M, int D, int A, int rb) {
  extern __shared__ float smem[];
  const int AP = A + 1;
  float* w1_s = smem;               // [D, A+1]  padded rows
  float* dw1_s = w1_s + D * AP;     // [D, A]
  float* w2_s = dw1_s + D * A;      // [A]
  float* do_s = w2_s + A;           // [D]       dout row (f32)
  float* h_s = do_s + D;            // [TLC, D]
  float* t_s = h_s + TLC * D;       // [TLC, A]  tanh(h W1)
  float* p_s = t_s + TLC * A;       // [TLC, A]  dproj
  float* a_s = p_s + TLC * A;       // [TLC]     softmax weight a_t
  float* ds_s = a_s + TLC;          // [TLC]
  float* red_s = ds_s + TLC;        // [THREADS / 32]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int NW = THREADS / 32;

  for (int i = tid; i < D * A; i += THREADS) {
    const int d = i / A, a = i - d * A;
    w1_s[d * AP + a] = w1[i];
    dw1_s[i] = 0.0f;
  }
  for (int i = tid; i < A; i += THREADS) w2_s[i] = w2[i];
  float dw2 = 0.0f;  // entry a = tid (A <= THREADS)

  const int r_end = min((int)(blockIdx.x + 1) * rb, M);
  for (int m = blockIdx.x * rb; m < r_end; ++m) {
    __syncthreads();  // staging done; the previous row's reads of do_s are done
    float cpart = 0.0f;
    for (int d = tid; d < D; d += THREADS) {
      const float dv = to_f32(dout[(size_t)m * D + d]);
      do_s[d] = dv;
      cpart = fmaf(dv, to_f32(out[(size_t)m * D + d]), cpart);
    }
    cpart = warp_sum(cpart);
    if (lane == 0) red_s[warp] = cpart;
    __syncthreads();
    float c = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) c += red_s[w];
    const float mxm = mx[m];
    const float den = dn[m] + 1e-13f;

    for (int t0 = 0; t0 < L; t0 += TLC) {
      const int n = min(TLC, L - t0);
      __syncthreads();  // the previous chunk is done with h_s, t_s, p_s
      for (int i = tid; i < n * D; i += THREADS) {
        const int tl = i / D, d = i - tl * D;
        h_s[i] = to_f32(H[((size_t)(t0 + tl) * M + m) * D + d]);
      }
      __syncthreads();
      for (int o = tid; o < n * A; o += THREADS) {
        const int tl = o / A, a = o - tl * A;
        const float* h = h_s + tl * D;
        float p = 0.0f;
        for (int d = 0; d < D; ++d) p = fmaf(h[d], w1_s[d * AP + a], p);
        t_s[o] = tanhf(p);
      }
      __syncthreads();
      for (int tl = warp; tl < n; tl += NW) {
        float sv = 0.0f, dv = 0.0f;
        for (int a = lane; a < A; a += 32) sv = fmaf(t_s[tl * A + a], w2_s[a], sv);
        for (int d = lane; d < D; d += 32) dv = fmaf(do_s[d], h_s[tl * D + d], dv);
        sv = warp_sum(sv);
        dv = warp_sum(dv);
        if (lane == 0) {
          const bool valid = mask[(size_t)m * L + t0 + tl] > 0.0f;
          const float e = valid ? expf(sv - mxm) : 0.0f;
          const float at = e / den;
          a_s[tl] = at;
          ds_s[tl] = at * (dv - c);
        }
      }
      __syncthreads();
      for (int o = tid; o < n * A; o += THREADS) {
        const int tl = o / A, a = o - tl * A;
        const float tv = t_s[o];
        p_s[o] = ds_s[tl] * (1.0f - tv * tv) * w2_s[a];
      }
      if (tid < A) {
        for (int tl = 0; tl < n; ++tl) dw2 = fmaf(t_s[tl * A + tid], ds_s[tl], dw2);
      }
      __syncthreads();
      for (int o = tid; o < n * D; o += THREADS) {
        const int tl = o / D, d = o - tl * D;
        const float* p = p_s + tl * A;
        const float* w = w1_s + d * AP;
        float v = 0.0f;
        for (int a = 0; a < A; ++a) v = fmaf(p[a], w[a], v);
        dH[((size_t)(t0 + tl) * M + m) * D + d] = from_f32<T>(a_s[tl] * do_s[d] + v);
      }
      for (int e = tid; e < D * A; e += THREADS) {
        const int d = e / A, a = e - d * A;
        float s = 0.0f;
        for (int tl = 0; tl < n; ++tl) s = fmaf(h_s[tl * D + d], p_s[tl * A + a], s);
        dw1_s[e] += s;
      }
    }
  }
  __syncthreads();
  float* dw1_b = dw1_p + (size_t)blockIdx.x * D * A;
  for (int e = tid; e < D * A; e += THREADS) dw1_b[e] = dw1_s[e];
  if (tid < A) dw2_p[(size_t)blockIdx.x * A + tid] = dw2;
}

template <typename T>
int launch(const void* H, const void* mask, const void* w1, const void* w2, const void* out,
           const void* mx, const void* dn, const void* dout, void* dH, void* dw1_p,
           void* dw2_p, int L, int M, int D, int A, int rb, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, A);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_kernel<T><<<(M + rb - 1) / rb, THREADS, smem, stream>>>(
      static_cast<const T*>(H), static_cast<const float*>(mask),
      static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<const T*>(out), static_cast<const float*>(mx),
      static_cast<const float*>(dn), static_cast<const T*>(dout), static_cast<T*>(dH),
      static_cast<float*>(dw1_p), static_cast<float*>(dw2_p), L, M, D, A, rb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// H [L, M, D], out and dout [M, D] (bf16 when bf16 != 0, else f32); mask
// [M, L], w1 [D, A], w2 [A, 1], mx and dn [M] f32 -> dH [L, M, D] in H's
// dtype and the f32 partials dw1_p [ceil(M/rb), D, A], dw2_p [ceil(M/rb), A],
// one slab per block of rb rows. The caller guarantees A <= 256, M >= 1,
// rb >= 1, that the dynamic shared memory
// fits a block (4 (2 D A + D + A + 8 D + 16 A + 24) bytes), and contiguous
// tensors.
int attn_bwd(const void* H, const void* mask, const void* w1, const void* w2, const void* out,
             const void* mx, const void* dn, const void* dout, void* dH, void* dw1_p,
             void* dw2_p, int L, int M, int D, int A, int rb, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(H, mask, w1, w2, out, mx, dn, dout, dH, dw1_p, dw2_p, L, M,
                                 D, A, rb, s);
  return launch<float>(H, mask, w1, w2, out, mx, dn, dout, dH, dw1_p, dw2_p, L, M, D, A, rb,
                       s);
}

const char* attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
