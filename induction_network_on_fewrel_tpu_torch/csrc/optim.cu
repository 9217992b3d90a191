// Multi-tensor optimizer update for Hopper (sm_90a): the global-norm clip,
// the weight decay, the moments and the update of every parameter of the
// training step in two launches.
//
// Replaces: the optimizer half of induction_network_on_fewrel_tpu/train/
// steps.py:make_update_body, which XLA fuses into one pass over every
// parameter (make_optimizer, steps.py:48-128: clip_by_global_norm, then
// adam / adamw / sgd with a staircase rate, the word table optionally on
// plain sgd or frozen). It is not a Pallas kernel: the JAX package leaves
// it to XLA. The port's plain version is the per-parameter loop of
// ops/optim.py:optim_update_reference.
//
// Two kernels over one table of tensors:
//   optim_sumsq_kernel   per-chunk sums of squares of every gradient into
//                        partials[chunk]; the last CTA to finish sums the
//                        partials in a fixed order and writes the global
//                        norm. No atomics touch a value, so the norm is
//                        bitwise repeatable.
//   optim_update_kernel  reads the norm, the update count and the
//                        configuration, and applies per element
//                          g <- g if |g| < clip else g / |g| * clip
//                          adam   g += wd p; m, v; p -= lr m^/(sqrt(v^) + eps)
//                          adamw  m, v from g; p -= lr (m^/(sqrt(v^) + eps) + wd p)
//                          sgd    p -= lr (g + wd p)
//                          sgd_plain (the word table's sgd) p -= lr g
//                          adam_nodecay (the lazy word table's compact rows,
//                                 train/lazy_embed.py) adam without the decay
//                        with lr = lr0 gamma^floor(c / step) and the bias
//                        corrections 1 - b^(c+1) in f32 (optax's order). It
//                        reads p, g, m, v once and writes p, m, v once; the
//                        last CTA to finish advances the count.
//
// The table travels by value as the kernel's parameter (constant bank,
// __grid_constant__ so that no thread copies it), so a CUDA graph that
// captures the launch keeps it, and no device copy of it is made. It holds
// 256 entries, 14 KB of parameters (CUDA 12.1's 32 764-byte limit on sm_70
// and later): snail over the BiLSTM has 68 tensors. Chunk k of the
// flattened table is CTA k; each CTA finds its tensor by a scan of the
// table's chunk offsets.
//
// What bounds it on this card: bytes. The update moves 7 x 4 B per Adam
// element (p, g, m, v read, p, m, v written), sumsq 4 B per gradient
// element; the arithmetic is a few dozen operations per element.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTensors = 256;  // ops/optim.py:MAX_TENSORS
constexpr int kThreads = 256;
constexpr int kVec = 4;           // a float4 per load
constexpr int kIters = 16;        // float4 loads per thread per chunk
constexpr int kChunk = kThreads * kVec * kIters;   // ops/optim.py:CHUNK

enum Rule : int { kAdam = 0, kAdamW = 1, kSgd = 2, kSgdPlain = 3, kAdamNoDecay = 4 };

struct Entry {
  float* p;
  const float* g;   // null: a gradient of zeros
  float* m;
  float* v;
  long long n;
  long long chunk0;   // first chunk of this tensor in the flattened table
  int rule;
  int pad;
};

struct Table {
  Entry e[kMaxTensors];
  int count;
  int pad;
  long long chunks;
};

struct Hyper {
  float lr, gamma, b1, b2, omb1, omb2, eps, wd, clip;
  int step_size;
};

__device__ __forceinline__ int find_entry(const Table& t, long long chunk) {
  int i = 0;
  while (i + 1 < t.count && t.e[i + 1].chunk0 <= chunk) ++i;
  return i;
}

// Sum of a value over the CTA in a fixed order (warp shuffles, then warp 0
// over the warp sums); every thread returns the total.
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kThreads / 32 ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) red[0] = x;
  }
  __syncthreads();
  const float total = red[0];
  __syncthreads();
  return total;
}

// True in the CTA that arrives last at `counter`, which it resets to 0.
// Every CTA's global writes before the call are visible to that CTA.
__device__ __forceinline__ bool last_to_arrive(unsigned* counter, unsigned total) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned ticket = atomicAdd(counter, 1u);
    last = ticket == total - 1;
    if (last) *counter = 0u;
  }
  __syncthreads();
  return last;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

// Thread t of a chunk walks elements base + (k * kThreads + t) * kVec + j,
// k < kIters, j < kVec: a float4 a step where the pointers allow it (every
// allocation the step makes does; a tensor's tail and a misaligned view
// take one element at a time).
__global__ void __launch_bounds__(kThreads)
optim_sumsq_kernel(const __grid_constant__ Table t, float* partials, unsigned* counter,
                   float* norm) {
  __shared__ float red[kThreads / 32];
  const long long chunk = blockIdx.x;
  const Entry& e = t.e[find_entry(t, chunk)];
  const long long base = (chunk - e.chunk0) * kChunk;
  float acc = 0.f;
  if (e.g != nullptr) {
    const bool vec = aligned16(e.g);
#pragma unroll 4
    for (int k = 0; k < kIters; ++k) {
      const long long i = base + ((long long)k * kThreads + threadIdx.x) * kVec;
      if (i >= e.n) break;
      if (vec && i + kVec <= e.n) {
        const float4 x = *reinterpret_cast<const float4*>(e.g + i);
        acc = fmaf(x.x, x.x, acc);
        acc = fmaf(x.y, x.y, acc);
        acc = fmaf(x.z, x.z, acc);
        acc = fmaf(x.w, x.w, acc);
      } else {
        for (int j = 0; j < kVec && i + j < e.n; ++j) acc = fmaf(e.g[i + j], e.g[i + j], acc);
      }
    }
  }
  acc = block_sum(acc, red);
  if (threadIdx.x == 0) partials[chunk] = acc;
  if (!last_to_arrive(counter, gridDim.x)) return;
  // Fixed order: thread j sums partials j, j + 256, ... in turn, then the
  // CTA sums the 256 results as block_sum does.
  volatile const float* vp = partials;
  float s = 0.f;
  for (long long j = threadIdx.x; j < t.chunks; j += kThreads) s += vp[j];
  s = block_sum(s, red);
  if (threadIdx.x == 0) *norm = sqrtf(s);
}

struct Step {
  float lr, bc1, bc2, gn;
  bool keep;
};

// One element of one tensor: the clip scale, then the tensor's rule.
__device__ __forceinline__ void update_one(float& p, float g, float& m, float& v, int rule,
                                           const Hyper& h, const Step& s) {
  g = s.keep ? g : g / s.gn * h.clip;
  switch (rule) {
    case kAdam:
    case kAdamW:
    case kAdamNoDecay: {
      if (rule == kAdam) g = g + h.wd * p;
      m = h.b1 * m + h.omb1 * g;
      v = h.b2 * v + h.omb2 * (g * g);
      float u = (m / s.bc1) / (sqrtf(v / s.bc2) + h.eps);
      if (rule == kAdamW) u = u + h.wd * p;
      p = p - s.lr * u;
      break;
    }
    case kSgd:
      p = p - s.lr * (g + h.wd * p);
      break;
    default:   // kSgdPlain
      p = p - s.lr * g;
      break;
  }
}

__global__ void __launch_bounds__(kThreads)
optim_update_kernel(const __grid_constant__ Table t, const float* norm, long long* count,
                    unsigned* counter, const Hyper h) {
  const long long chunk = blockIdx.x;
  const Entry& e = t.e[find_entry(t, chunk)];
  const long long c = *count;
  Step s;
  s.lr = h.lr * powf(h.gamma, (float)(c / h.step_size));
  s.bc1 = 1.f - powf(h.b1, (float)(c + 1));
  s.bc2 = 1.f - powf(h.b2, (float)(c + 1));
  s.gn = *norm;
  s.keep = s.gn < h.clip;
  const bool moments = e.rule == kAdam || e.rule == kAdamW || e.rule == kAdamNoDecay;
  const bool vec = aligned16(e.p) && aligned16(e.g) && aligned16(e.m) && aligned16(e.v);
  const long long base = (chunk - e.chunk0) * kChunk;
#pragma unroll 2
  for (int k = 0; k < kIters; ++k) {
    const long long i = base + ((long long)k * kThreads + threadIdx.x) * kVec;
    if (i >= e.n) break;
    if (vec && i + kVec <= e.n) {
      float4 p = *reinterpret_cast<const float4*>(e.p + i);
      const float4 g = e.g != nullptr ? *reinterpret_cast<const float4*>(e.g + i)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 m = make_float4(0.f, 0.f, 0.f, 0.f), v = m;
      if (moments) {
        m = *reinterpret_cast<const float4*>(e.m + i);
        v = *reinterpret_cast<const float4*>(e.v + i);
      }
      update_one(p.x, g.x, m.x, v.x, e.rule, h, s);
      update_one(p.y, g.y, m.y, v.y, e.rule, h, s);
      update_one(p.z, g.z, m.z, v.z, e.rule, h, s);
      update_one(p.w, g.w, m.w, v.w, e.rule, h, s);
      *reinterpret_cast<float4*>(e.p + i) = p;
      if (moments) {
        *reinterpret_cast<float4*>(e.m + i) = m;
        *reinterpret_cast<float4*>(e.v + i) = v;
      }
    } else {
      for (int j = 0; j < kVec && i + j < e.n; ++j) {
        float p = e.p[i + j], m = moments ? e.m[i + j] : 0.f, v = moments ? e.v[i + j] : 0.f;
        update_one(p, e.g != nullptr ? e.g[i + j] : 0.f, m, v, e.rule, h, s);
        e.p[i + j] = p;
        if (moments) {
          e.m[i + j] = m;
          e.v[i + j] = v;
        }
      }
    }
  }
  if (last_to_arrive(counter, gridDim.x) && threadIdx.x == 0) *count = c + 1;
}

// entries: host array of `count` rows of 7 long longs (p, g, m, v, n, chunk0,
// rule), laid out by ops/optim.py:entry_rows.
int make_table(const long long* entries, int count, Table* t) {
  if (count < 1 || count > kMaxTensors) return (int)cudaErrorInvalidValue;
  *t = Table{};
  t->count = count;
  long long chunks = 0;
  for (int i = 0; i < count; ++i) {
    const long long* r = entries + 7 * i;
    Entry& e = t->e[i];
    e.p = reinterpret_cast<float*>(r[0]);
    e.g = reinterpret_cast<const float*>(r[1]);
    e.m = reinterpret_cast<float*>(r[2]);
    e.v = reinterpret_cast<float*>(r[3]);
    e.n = r[4];
    e.chunk0 = r[5];
    e.rule = (int)r[6];
    if (e.chunk0 != chunks || e.n < 1 || e.rule < kAdam || e.rule > kAdamNoDecay)
      return (int)cudaErrorInvalidValue;
    if ((e.rule == kAdam || e.rule == kAdamW || e.rule == kAdamNoDecay) &&
        (e.m == nullptr || e.v == nullptr))
      return (int)cudaErrorInvalidValue;
    chunks += (e.n + kChunk - 1) / kChunk;
  }
  t->chunks = chunks;
  return chunks > 0x7fffffffLL ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace

extern "C" {

// Writes partials[chunks] and norm[1] (f32); counter is a zeroed unsigned
// that the kernel leaves zeroed. The gradients are f32 and contiguous.
int optim_sumsq(const void* entries, int count, void* partials, void* counter, void* norm,
                void* stream) {
  static_assert(sizeof(Table) <= 32764,
                "the table must fit the 32 764-byte kernel parameter space");
  Table t;
  int err = make_table(static_cast<const long long*>(entries), count, &t);
  if (err != 0) return err;
  optim_sumsq_kernel<<<(unsigned)t.chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<float*>(partials), static_cast<unsigned*>(counter),
      static_cast<float*>(norm));
  return (int)cudaGetLastError();
}

// Updates p, m, v of every entry in place from norm[1] (f32, the output of
// optim_sumsq) and count[1] (int64, the updates applied so far, advanced by
// one). lr, gamma and step_size give the staircase rate; omb1 = 1 - b1 and
// omb2 = 1 - b2 as the host rounds them to f32.
int optim_update(const void* entries, int count, const void* norm, void* count_dev,
                 void* counter, float lr, float gamma, int step_size, float b1, float b2,
                 float omb1, float omb2, float eps, float wd, float clip, void* stream) {
  if (step_size < 1) return (int)cudaErrorInvalidValue;
  Table t;
  int err = make_table(static_cast<const long long*>(entries), count, &t);
  if (err != 0) return err;
  const Hyper h{lr, gamma, b1, b2, omb1, omb2, eps, wd, clip, step_size};
  optim_update_kernel<<<(unsigned)t.chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const float*>(norm), static_cast<long long*>(count_dev),
      static_cast<unsigned*>(counter), h);
  return (int)cudaGetLastError();
}

const char* optim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
