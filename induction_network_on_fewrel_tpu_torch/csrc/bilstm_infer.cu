// Fused BiLSTM forward for Hopper (sm_90a): one kernel body, two launchers.
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
// the same body with the compile-time flag CKPT, which also writes one
// (h, c) checkpoint pair per natural-time block [bW, min(bW+W, L)) into
// ch, cc [ceil(L/W), M, 2u] in the residual dtype. Slot b holds the state
// at the block's kernel-LAST step: natural min(bW+W, L)-1 for the forward
// direction, natural bW for the reverse one (the TPU kernel gets the same
// value from its block flush). h and c are written from the f32 values the
// recurrence carries (c from its register), so with f32 residuals the
// backward's window replay starts from exactly the forward's state.
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
// Design (simple and right first): one block per (row tile of TM rows,
// direction); the TPU's sequential grid axis over L becomes a loop inside
// the block. One thread per gate column j of the 4u columns computes the
// TM pre-activations of its column, reading each weight once per step and
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int TM = 16;           // rows per block
constexpr int CPT = TM / 4;      // cells per thread (blockDim == 4u)
constexpr int MAX_THREADS = 512; // 4u <= 512: u <= 128, 128 registers a thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

template <typename T, typename R, bool CKPT>
__global__ void __launch_bounds__(MAX_THREADS)
bilstm_fwd_kernel(const T* __restrict__ emb,     // [L, M, D]
                  const T* __restrict__ wih,     // [2, D, 4u]
                  const float* __restrict__ b,   // [2, 1, 4u]
                  const float* __restrict__ whh, // [2, u, 4u]
                  T* __restrict__ hs,            // [L, M, 2u]
                  R* __restrict__ ch,            // [nB, M, 2u] (CKPT only)
                  R* __restrict__ cc,            // [nB, M, 2u] (CKPT only)
                  int L, int M, int D, int u, int W) {
  extern __shared__ float smem[];
  const int G = 4 * u;
  float* emb_s = smem;             // [TM, D]  this step's embedding tile
  float* h_s = emb_s + TM * D;     // [TM, u]  h carry
  float* a_s = h_s + TM * u;       // [TM, G]  gate pre-activations

  const int j = threadIdx.x;       // gate column; blockDim.x == G
  const int dir = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const T* wih_d = wih + (size_t)dir * D * G;
  const float* whh_d = whh + (size_t)dir * u * G;
  const float bj = b[dir * G + j];

  float c[CPT];
#pragma unroll
  for (int q = 0; q < CPT; ++q) c[q] = 0.0f;
  for (int idx = j; idx < TM * u; idx += G) h_s[idx] = 0.0f;

  for (int s = 0; s < L; ++s) {
    const int t = dir ? L - 1 - s : s;
    // Kernel-last step of t's natural block: this step's state is its slot.
    const bool ckpt_step = CKPT && (dir ? t % W == 0 : (t % W == W - 1 || t == L - 1));
    for (int idx = j; idx < TM * D; idx += G) {
      const int r = idx / D, k = idx - r * D;
      const int row = row0 + r;
      emb_s[idx] = row < M ? to_f32(emb[((size_t)t * M + row) * D + k]) : 0.0f;
    }
    __syncthreads();  // emb_s staged; h_s holds h_{s-1}

    float acc[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) acc[r] = bj;
    for (int k = 0; k < D; ++k) {
      const float w = to_f32(wih_d[(size_t)k * G + j]);
#pragma unroll
      for (int r = 0; r < TM; ++r) acc[r] = fmaf(emb_s[r * D + k], w, acc[r]);
    }
    for (int k = 0; k < u; ++k) {
      const float w = whh_d[(size_t)k * G + j];
#pragma unroll
      for (int r = 0; r < TM; ++r) acc[r] = fmaf(h_s[r * u + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) a_s[r * G + j] = acc[r];
    __syncthreads();  // all pre-activations written, all reads of h_s done

#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int idx = j + q * G;   // < TM * u because G * CPT == TM * u
      const int r = idx / u, jj = idx - r * u;
      const float* ar = a_s + r * G;
      const float ig = sigmoidf(ar[jj]);
      const float fg = sigmoidf(ar[u + jj]);
      const float gg = tanhf(ar[2 * u + jj]);
      const float og = sigmoidf(ar[3 * u + jj]);
      c[q] = fg * c[q] + ig * gg;
      const float h = og * tanhf(c[q]);
      h_s[idx] = h;
      const int row = row0 + r;
      if (row < M) {
        hs[((size_t)t * M + row) * (2 * u) + dir * u + jj] = from_f32<T>(h);
        if (ckpt_step) {
          const size_t o = ((size_t)(t / W) * M + row) * (2 * u) + dir * u + jj;
          ch[o] = from_f32<R>(h);
          cc[o] = from_f32<R>(c[q]);
        }
      }
    }
    __syncthreads();  // h_s complete before the next step reads it
  }
}

template <typename T, typename R, bool CKPT>
int launch(const void* emb, const void* wih, const void* b, const void* whh, void* hs,
           void* ch, void* cc, int L, int M, int D, int u, int W, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)TM * (D + u + 4 * u);
  cudaError_t err = cudaFuncSetAttribute(bilstm_fwd_kernel<T, R, CKPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + TM - 1) / TM, 2);
  bilstm_fwd_kernel<T, R, CKPT><<<grid, 4 * u, smem, stream>>>(
      static_cast<const T*>(emb), static_cast<const T*>(wih),
      static_cast<const float*>(b), static_cast<const float*>(whh),
      static_cast<T*>(hs), static_cast<R*>(ch), static_cast<R*>(cc), L, M, D, u, W);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_win(const void* emb, const void* wih, const void* b, const void* whh, void* hs,
               void* ch, void* cc, int L, int M, int D, int u, int W, int res_bf16,
               cudaStream_t stream) {
  if (res_bf16)
    return launch<T, __nv_bfloat16, true>(emb, wih, b, whh, hs, ch, cc, L, M, D, u, W, stream);
  return launch<T, float, true>(emb, wih, b, whh, hs, ch, cc, L, M, D, u, W, stream);
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
    return launch<__nv_bfloat16, __nv_bfloat16, false>(emb, wih, b, whh, hs, nullptr, nullptr,
                                                       L, M, D, u, 1, s);
  return launch<float, float, false>(emb, wih, b, whh, hs, nullptr, nullptr, L, M, D, u, 1, s);
}

// K7: as bilstm_infer_fwd, plus ch, cc [ceil(L/W), M, 2u] in bf16 when
// res_bf16 != 0, else f32. The caller guarantees 1 <= W <= L.
int bilstm_win_fwd(const void* emb, const void* wih, const void* b, const void* whh,
                   void* hs, void* ch, void* cc, int L, int M, int D, int u, int W,
                   int bf16, int res_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_win<__nv_bfloat16>(emb, wih, b, whh, hs, ch, cc, L, M, D, u, W, res_bf16, s);
  return launch_win<float>(emb, wih, b, whh, hs, ch, cc, L, M, D, u, W, res_bf16, s);
}

const char* bilstm_infer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
