// Exact lazy Adam on the word table for Hopper (sm_90a): the catch-up of
// skipped rows and the write-back of the compact rows.
//
// Replaces: induction_network_on_fewrel_tpu/train/lazy_embed.py:147
// decay_catchup (with :506 make_materialize, its whole-table form) and the
// scatter of the compact rows at :460 (the epilogue of the hoisted fused
// scan, and the per-step body's scatter at :318). They are not Pallas
// kernels: the JAX package leaves them to XLA (a lax.while_loop whose trip
// count is the largest gap, and .at[uids].set). The port's plain versions
// are ops/lazy_embed.py:lazy_catchup_reference and lazy_scatter_reference.
//
// With weight decay off the table, a row that gets no gradient for k steps
// only decays: m <- b1 m, v <- b2 v, and W moves by the bias-corrected
// momentum tail. lazy_catchup_kernel applies those k steps to each row it
// is given, in the JAX order (lazy_embed.py:167-186): for u = last+1 ..
// last+kc, lr = lr0 gamma^floor((u-1)/step), bc = 1 - b^u in f32,
//   m = b1 m;  v = b2 v;  W = W - (lr (m / bc1)) / (sqrt(v / bc2) + eps)
// with kc = min(k, CATCHUP_CAP) for a row whose m or v holds a nonzero and
// 0 otherwise, then the residual decay m b1^(k-kc), v b2^(k-kc). The trip
// count is read from the device (the update count and the row's last
// update) inside the kernel, so a CUDA graph replays it without a host
// sync: that is what a while_loop on the host could not give.
//
// Out of place (the prologue of a step) it gathers rows ids[R] of (W, m,
// v, last) and writes the caught-up rows to compact [R, D] buffers; an id
// of V or more is a pad lane: it reads the clamped row V-1, is not caught
// up and is never written back. In place (materialize, R = V, no ids) it
// writes back only the rows that change and sets last to t for the rows
// with moments. A row whose m and v are zero never moves, whatever its
// gap, so its last is left as it is (the JAX make_materialize sets every
// last): a delta ring save after a materialize then holds the rows that
// trained, not the whole table.
// lazy_scatter_kernel writes compact rows, moments and last = t back at
// ids[R], dropping pad lanes.
//
// In place, table/m/v alias out_w/out_m/out_v: each row is read whole into
// registers by its warp before it is written, and no other warp touches it.
//
// One warp per row, each lane holding up to kPerLane of the row's D
// values in registers (D <= 128; the word table has D = 50). What bounds
// them on this card: bytes. The catch-up of R rows moves 3 x 4 B x D per
// row in and out; its arithmetic is a few operations per element and
// step, and at steady state kc is 0-2. Materialize reads all of m and v
// for the alive test and only the alive rows' W.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;          // rows per CTA
constexpr int kPerLane = 4;        // D <= 32 * kPerLane
constexpr unsigned kFull = 0xffffffffu;

struct Hyper {
  float lr, gamma, b1, b2, eps;
  int step_size, cap;
};

__global__ void __launch_bounds__(32 * kWarps)
lazy_catchup_kernel(const float* table, const float* m_in, const float* v_in, int* last,
                    const int* __restrict__ ids, float* out_w, float* out_m, float* out_v,
                    const long long* count, int R, int V, int D, const Hyper h, bool in_place) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;
  const int t = (int)*count;
  const int id = ids != nullptr ? ids[row] : (int)row;
  const bool pad = id < 0 || id >= V;
  const long long src = pad ? V - 1 : id;
  const int last_r = last[src];
  const int k = pad ? 0 : max(t - last_r, 0);
  float w[kPerLane], m[kPerLane], v[kPerLane];
  bool nz = false;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int j = lane + 32 * e;
    m[e] = v[e] = 0.f;
    if (j < D) {
      m[e] = m_in[src * D + j];
      v[e] = v_in[src * D + j];
      nz = nz || m[e] != 0.f || v[e] != 0.f;
    }
  }
  const bool alive = __any_sync(kFull, nz);
  const int kc = alive ? min(k, h.cap) : 0;
  if (in_place) {
    if (!alive) return;             // never moves: nothing to write
    if (lane == 0) last[src] = t;
    if (k == 0) return;
  }
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int j = lane + 32 * e;
    w[e] = j < D ? table[src * D + j] : 0.f;
  }
  for (int s = 1; s <= kc; ++s) {
    const int u = last_r + s;          // the 1-based update this trip applies
    const float uf = (float)u;
    const float bc1 = 1.f - powf(h.b1, uf);
    const float bc2 = 1.f - powf(h.b2, uf);
    const float lr = h.lr * powf(h.gamma, (float)((u - 1) / h.step_size));
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      m[e] = h.b1 * m[e];
      v[e] = h.b2 * v[e];
      w[e] = w[e] - (lr * (m[e] / bc1)) / (sqrtf(v[e] / bc2) + h.eps);
    }
  }
  if (k > kc) {
    const float r = (float)(k - kc);
    const float f1 = powf(h.b1, r), f2 = powf(h.b2, r);
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      m[e] = m[e] * f1;
      v[e] = v[e] * f2;
    }
  }
  const long long dst = in_place ? src : row;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int j = lane + 32 * e;
    if (j < D) {
      out_w[dst * D + j] = w[e];
      out_m[dst * D + j] = m[e];
      out_v[dst * D + j] = v[e];
    }
  }
}

__global__ void __launch_bounds__(32 * kWarps)
lazy_scatter_kernel(float* table, float* m, float* v, int* last, const int* __restrict__ ids,
                    const float* __restrict__ rows_w, const float* __restrict__ rows_m,
                    const float* __restrict__ rows_v, const long long* count, int R, int V,
                    int D) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;
  const int id = ids[row];
  if (id < 0 || id >= V) return;       // pad lane: dropped
  const long long dst = id;
  for (int j = lane; j < D; j += 32) {
    table[dst * D + j] = rows_w[row * D + j];
    m[dst * D + j] = rows_m[row * D + j];
    v[dst * D + j] = rows_v[row * D + j];
  }
  if (lane == 0) last[dst] = (int)*count;
}

unsigned blocks_for(int R) { return (unsigned)((R + kWarps - 1) / kWarps); }

}  // namespace

extern "C" {

// table, m, v: f32 [V, D]; last: int32 [V]; count: int64 [1] (the updates
// applied so far, t). Out of place: ids int32 [R] (pad >= V), out_* f32
// [R, D]. In place (in_place != 0): ids null, R == V, out_* == table, m, v,
// and last is set to t where m or v is nonzero. Hyperparameters as
// ops/optim.py:OptimHyper.
int lazy_catchup(const void* table, const void* m, const void* v, void* last, const void* ids,
                 void* out_w, void* out_m, void* out_v, const void* count, int R, int V, int D,
                 float lr, float gamma, int step_size, float b1, float b2, float eps, int cap,
                 int in_place, void* stream) {
  if (R < 1 || V < 1 || D < 1 || D > 32 * kPerLane || step_size < 1 || cap < 0)
    return (int)cudaErrorInvalidValue;
  if (in_place && (ids != nullptr || R != V)) return (int)cudaErrorInvalidValue;
  if (!in_place && ids == nullptr) return (int)cudaErrorInvalidValue;
  const Hyper h{lr, gamma, b1, b2, eps, step_size, cap};
  lazy_catchup_kernel<<<blocks_for(R), 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const float*>(m),
      static_cast<const float*>(v), static_cast<int*>(last), static_cast<const int*>(ids),
      static_cast<float*>(out_w), static_cast<float*>(out_m), static_cast<float*>(out_v),
      static_cast<const long long*>(count), R, V, D, h, in_place != 0);
  return (int)cudaGetLastError();
}

// Writes rows_* [R, D] at ids[R] of table, m, v and last = t (count [1],
// int64); ids of V or more are dropped.
int lazy_scatter(void* table, void* m, void* v, void* last, const void* ids,
                 const void* rows_w, const void* rows_m, const void* rows_v, const void* count,
                 int R, int V, int D, void* stream) {
  if (R < 1 || V < 1 || D < 1) return (int)cudaErrorInvalidValue;
  lazy_scatter_kernel<<<blocks_for(R), 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(table), static_cast<float*>(m), static_cast<float*>(v),
      static_cast<int*>(last), static_cast<const int*>(ids), static_cast<const float*>(rows_w),
      static_cast<const float*>(rows_m), static_cast<const float*>(rows_v),
      static_cast<const long long*>(count), R, V, D);
  return (int)cudaGetLastError();
}

const char* lazy_embed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
