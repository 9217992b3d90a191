// Structured self-attention forward for Hopper (sm_90a): K2 and K10.
//
// K2 (attn_fwd) replaces induction_network_on_fewrel_tpu/ops/attn.py:
// _make_fwd_kernel(with_stats=False), i.e. _fwd_kernel_infer, launched by
// _fwd_call. K10 (attn_fwd_stats) replaces _make_fwd_kernel(with_stats=True),
// the training forward of _attn_core: the SAME body with the compile-time
// flag STATS, which also writes the row's softmax max mx [M] and normalizer
// dn [M] (f32), the only residuals the backward (K11) needs. As on the TPU,
// one body serves both, so the no-grad and the training forward share their
// numerics by construction:
//
//   s_t   = w2 . tanh(W1^T h_t)                (f32, whatever H's dtype)
//   a     = masked_softmax_t(s)                (mask <= 0 -> excluded)
//   out   = sum_t a_t h_t / (sum_t e_t + 1e-13), written in H's dtype
//
// What bounds it on this card: f32 operations (the projection, 2 L D A per
// row: 3.9 us at the FP32 peak at M = 200, against 1.2 us for reading a
// bf16 H once), but in practice latency: at serving sizes (1-16 rows) a
// CTA that walks a whole row leaves most of the 132 SMs idle.
//
// Design: one thread-block cluster of SPLIT = 8 CTAs per group of G rows
// (ops/attn.py:attn_fwd_plan). CTA q of the cluster owns time steps
// [q Lc, q Lc + Lc), Lc = ceil(L / 8), of every row of the group, so a
// single row fills a cluster and 16 rows 128 CTAs. A CTA computes the
// projections of all its G x Lc tokens at once as one register-tiled
// product (csrc/attn_common.cuh, A in chunks of 64 columns, D streamed in
// slabs; any D and A), then per row its partial softmax: the max m_q of
// its scores, d_q = sum e^(s - m_q) and acc_q[D] = sum e^(s - m_q) h. After
// a cluster barrier CTA q merges columns [q D/8, q D/8 + D/8) of every row
// of the group from the 8 partials through distributed shared memory, in
// rank order: M = max m_q, d = sum_q d_q e^(m_q - M), out = sum_q acc_q
// e^(m_q - M) / (d + 1e-13). The merge order is fixed, so runs repeat bit
// for bit. Masked steps get e = 0 after the shift (attn.py:147): a fully
// masked row keeps M = -1e30, d = 0, acc = 0 and writes exact zeros. A row
// longer than a tile (Lc > 64 steps) passes its steps in chunks, carrying
// (m, d, acc) over the chunks as an online softmax. ops/attn.py:
// attn_fwd_split_reference is the plain twin of this split and merge.

#include "attn_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace attn;

template <typename T>
struct FwdArgs {
  const T* H;         // [L, M, D]
  const float* mask;  // [M, L]
  const float* w1;    // [D, A]
  const float* w2;    // [A]
  T* out;             // [M, D]
  float* mx;          // [M] (STATS only)
  float* dn;          // [M] (STATS only)
  int L, M, D, A;
  int G;              // rows of a cluster
  int Lc;             // time steps of a CTA
  int chunk;          // steps of a row per pass: min(Lc, R / G)
};

// Grid (ceil(M / G) * SPLIT), clusters of (SPLIT, 1, 1), 256 threads.
template <typename T, bool STATS, int R>
__global__ void __launch_bounds__(THREADS) attn_fwd_kernel(FwdArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int L = a.L, M = a.M, D = a.D, A = a.A, G = a.G, ch = a.chunk;
  const int m0 = (int)(blockIdx.x / SPLIT) * G;
  const int gn = min(G, M - m0);                      // rows of this group
  const int t0 = rank * a.Lc, tn = max(0, min(a.Lc, L - t0));
  float* eng = smem;
  float* hs_s = eng + engine_floats(R);               // [R, 2]   half-row sums of tanh(p) w2
  float* s_s = hs_s + 2 * R;                          // [R]      scores
  float* e_s = s_s + R;                               // [R]      e^(s - m)
  float* m_s = e_s + R;                               // [G]      running max
  float* d_s = m_s + G;                               // [G]      normalizer
  float* c_s = d_s + G;                               // [G]      this pass's rescale
  float* f_s = c_s + G;                               // [SPLIT, G] merge factors e^(m_q - M)
  float* acc_s = f_s + SPLIT * G;                     // [G, D]   weighted sum
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG;
    d_s[g] = 0.0f;
  }
  for (int i = tid; i < G * D; i += THREADS) acc_s[i] = 0.0f;

  for (int p = 0; p < tn; p += ch) {
    const int pn = min(ch, tn - p);
    // Tile row r = g * ch + j is step t0 + p + j of row m0 + g.
    auto hrow = [&](int r) -> const T* {
      const int g = r / ch, j = r - g * ch;
      return g < gn && j < pn ? a.H + ((size_t)(t0 + p + j) * M + m0 + g) * D : nullptr;
    };
    for (int a0 = 0; a0 < A; a0 += CW) {
      tile_product<R, true, false>(
          eng, D,
          [&](int k, int r) {
            const T* h = hrow(r);
            return h ? to_f32(h[k]) : 0.0f;
          },
          [&](int k, int c) { return a0 + c < A ? a.w1[(size_t)k * A + a0 + c] : 0.0f; },
          [&](int r, int c, float v) {
            // A warp holds 32 consecutive columns of one row: sum them here.
            const float x = warp_sum(a0 + c < A ? tanhf(v) * a.w2[a0 + c] : 0.0f);
            if (lane == 0) hs_s[2 * r + c / 32] = x;
          });
      for (int r = tid; r < R; r += THREADS) {
        const float x = hs_s[2 * r] + hs_s[2 * r + 1];
        s_s[r] = a0 == 0 ? x : s_s[r] + x;
      }
    }
    __syncthreads();  // every score of the pass is in s_s
    for (int g = warp; g < gn; g += THREADS / 32) {
      const float* mrow = a.mask + (size_t)(m0 + g) * L + t0 + p;
      float mloc = NEG;
      for (int j = lane; j < pn; j += 32)
        if (mrow[j] > 0.0f) mloc = fmaxf(mloc, s_s[g * ch + j]);
      mloc = warp_max(mloc);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mloc);
      float esum = 0.0f;
      for (int j = lane; j < pn; j += 32) {
        const float e = mrow[j] > 0.0f ? expf(s_s[g * ch + j] - m_new) : 0.0f;
        e_s[g * ch + j] = e;
        esum += e;
      }
      esum = warp_sum(esum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[g] = corr;
        d_s[g] = d_s[g] * corr + esum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();  // e_s and the rescale factors are in
    for (int i = tid; i < gn * D; i += THREADS) {
      const int g = i / D, d = i - g * D;
      float v = acc_s[i] * c_s[g];
      const T* h = a.H + ((size_t)(t0 + p) * M + m0 + g) * D + d;
      for (int j = 0; j < pn; ++j) v = fmaf(e_s[g * ch + j], to_f32(h[(size_t)j * M * D]), v);
      acc_s[i] = v;
    }
    // The next pass's first tile starts with a block barrier.
  }

  cluster.sync();  // every CTA's partial (m, d, acc) is written
  // Per row: M = max_q m_q and the factors e^(m_q - M), read once from the
  // peers into f_s; the normalizer in rank order (K10's dn).
  for (int g = tid; g < gn; g += THREADS) {
    float mq[SPLIT];
    float mxv = NEG;
#pragma unroll
    for (int q = 0; q < SPLIT; ++q) {
      mq[q] = cluster.map_shared_rank(m_s, q)[g];
      mxv = fmaxf(mxv, mq[q]);
    }
    float den = 0.0f;
#pragma unroll
    for (int q = 0; q < SPLIT; ++q) {
      const float f = expf(mq[q] - mxv);
      f_s[q * G + g] = f;
      den = fmaf(cluster.map_shared_rank(d_s, q)[g], f, den);
    }
    c_s[g] = den;
    if (STATS && rank == 0) {
      a.mx[m0 + g] = mxv;
      a.dn[m0 + g] = den;
    }
  }
  __syncthreads();
  // CTA `rank` merges columns [rank dsz, rank dsz + dsz) of every row, in rank order.
  const int dsz = (D + SPLIT - 1) / SPLIT, d0 = rank * dsz;
  for (int i = tid; i < gn * dsz; i += THREADS) {
    const int g = i / dsz, d = d0 + i - g * dsz;
    if (d >= D) continue;
    float v = 0.0f;
#pragma unroll
    for (int q = 0; q < SPLIT; ++q)
      v = fmaf(cluster.map_shared_rank(acc_s, q)[g * D + d], f_s[q * G + g], v);
    a.out[(size_t)(m0 + g) * D + d] = from_f32<T>(v / (c_s[g] + 1e-13f));
  }
  cluster.sync();  // no CTA leaves while a peer may still read its partial
}

template <typename T, bool STATS, int R>
int launch_tile(const FwdArgs<T>& a, cudaStream_t stream) {
  static int smem_set[64];
  const size_t smem = fwd_smem(R, a.G, a.D);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(attn_fwd_kernel<T, STATS, R>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((a.M + a.G - 1) / a.G * SPLIT), 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, attn_fwd_kernel<T, STATS, R>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, bool STATS>
int launch(const void* H, const void* mask, const void* w1, const void* w2, void* out, void* mx,
           void* dn, int L, int M, int D, int A, int tile, int cluster, int rows, int steps,
           int chunk, cudaStream_t stream) {
  if (cluster != SPLIT || rows < 1 || chunk < 1 || rows * chunk > tile ||
      (long long)steps * SPLIT < L || chunk > steps)
    return (int)cudaErrorInvalidValue;
  FwdArgs<T> a{};
  a.H = static_cast<const T*>(H);
  a.mask = static_cast<const float*>(mask);
  a.w1 = static_cast<const float*>(w1);
  a.w2 = static_cast<const float*>(w2);
  a.out = static_cast<T*>(out);
  a.mx = static_cast<float*>(mx);
  a.dn = static_cast<float*>(dn);
  a.L = L; a.M = M; a.D = D; a.A = A; a.G = rows; a.Lc = steps; a.chunk = chunk;
  switch (tile) {
    case 8: return launch_tile<T, STATS, 8>(a, stream);
    case 16: return launch_tile<T, STATS, 16>(a, stream);
    case 32: return launch_tile<T, STATS, 32>(a, stream);
    case 64: return launch_tile<T, STATS, 64>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// H [L, M, D] (bf16 when bf16 != 0, else f32), mask [M, L] f32,
// w1 [D, A] f32, w2 [A, 1] f32 -> out [M, D] in H's dtype. The plan
// (ops/attn.py:attn_fwd_plan): tile R in {8, 16, 32, 64}, cluster = 8,
// rows G per cluster, steps Lc = ceil(L / 8) per CTA, chunk = min(Lc, R /
// G) steps of a row per pass. The caller guarantees L, M >= 1 and
// contiguous tensors; a plan the body cannot take returns
// cudaErrorInvalidValue without launching.
int attn_fwd(const void* H, const void* mask, const void* w1, const void* w2, void* out,
             int L, int M, int D, int A, int bf16, int tile, int cluster, int rows, int steps,
             int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16, false>(H, mask, w1, w2, out, nullptr, nullptr, L, M, D, A,
                                        tile, cluster, rows, steps, chunk, s);
  return launch<float, false>(H, mask, w1, w2, out, nullptr, nullptr, L, M, D, A, tile,
                              cluster, rows, steps, chunk, s);
}

// K10: as attn_fwd, plus mx, dn [M] f32 (the row's softmax max and normalizer).
int attn_fwd_stats(const void* H, const void* mask, const void* w1, const void* w2, void* out,
                   void* mx, void* dn, int L, int M, int D, int A, int bf16, int tile,
                   int cluster, int rows, int steps, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16, true>(H, mask, w1, w2, out, mx, dn, L, M, D, A, tile, cluster,
                                       rows, steps, chunk, s);
  return launch<float, true>(H, mask, w1, w2, out, mx, dn, L, M, D, A, tile, cluster, rows,
                             steps, chunk, s);
}

const char* attn_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
