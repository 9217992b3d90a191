// Native episodic N-way K-shot sampler + prefetching pipeline.
//
// TPU-native replacement for the reference's torch DataLoader worker
// processes (SURVEY.md §3.4): the device consumes fixed-shape episode
// batches at tens of thousands of episodes/sec, far beyond what a Python
// loop can produce, so batch assembly runs here — C++ threads filling a
// ring buffer the trainer drains through ctypes (zero-copy into numpy).
//
// Determinism contract (load-bearing for multi-host data parallelism and
// for test reproducibility): batch `i` is generated by an RNG seeded as
// splitmix64(seed, i) — a pure function of (seed, batch index) — so the
// produced sequence is identical whatever the thread count or scheduling.
//
// Episode semantics (mirrors sampling/episodes.py, SURVEY.md §2.1):
//   * N distinct relations per episode;
//   * K support + Q query instances per relation, without replacement;
//   * na_rate*Q extra NOTA queries from relations OUTSIDE the episode,
//     labeled N (FewRel 2.0);
//   * queries shuffled within the episode.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- RNG ----
// splitmix64 (seed expansion) + xoshiro256** (stream) — public-domain
// algorithms by Vigna; tiny, fast, and reproducible everywhere.

static inline uint64_t splitmix64(uint64_t& x) {
  x += 0x9E3779B97F4A7C15ULL;
  uint64_t z = x;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

struct Xoshiro256 {
  uint64_t s[4];

  explicit Xoshiro256(uint64_t seed) {
    for (int i = 0; i < 4; ++i) s[i] = splitmix64(seed);
  }

  static inline uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }

  uint64_t next() {
    const uint64_t result = rotl(s[1] * 5, 7) * 9;
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }

  // Unbiased integer in [0, bound) — Lemire's multiply-shift with rejection.
  uint64_t bounded(uint64_t bound) {
    uint64_t x = next();
    __uint128_t m = (__uint128_t)x * bound;
    uint64_t l = (uint64_t)m;
    if (l < bound) {
      uint64_t t = (0 - bound) % bound;
      while (l < t) {
        x = next();
        m = (__uint128_t)x * bound;
        l = (uint64_t)m;
      }
    }
    return (uint64_t)(m >> 64);
  }
};

// Partial Fisher–Yates: leave a random `take`-subset in idx[0..take).
static void partial_shuffle(std::vector<int64_t>& idx, int64_t take,
                            Xoshiro256& rng) {
  const int64_t n = (int64_t)idx.size();
  for (int64_t i = 0; i < take; ++i) {
    int64_t j = i + (int64_t)rng.bounded((uint64_t)(n - i));
    std::swap(idx[i], idx[j]);
  }
}

// ---------------------------------------------------------- Sampler ------

struct Sampler {
  // Borrowed views of the caller-owned tokenized corpus (kept alive by the
  // Python wrapper for the Sampler's lifetime).
  const int32_t* words;
  const int32_t* pos1;
  const int32_t* pos2;
  const float* mask;
  std::vector<int64_t> rel_offsets;  // [R+1]
  int64_t num_relations;
  int32_t L, n, k, q, na_rate, batch_size;
  uint64_t seed;
  std::atomic<int64_t> next_batch{0};

  int64_t total_q() const { return (int64_t)(n + na_rate) * q; }

  int64_t rel_size(int64_t r) const {
    return rel_offsets[r + 1] - rel_offsets[r];
  }

  void copy_row(int64_t row, int32_t* w, int32_t* p1, int32_t* p2,
                float* m) const {
    const size_t off = (size_t)row * L;
    std::memcpy(w, words + off, sizeof(int32_t) * L);
    std::memcpy(p1, pos1 + off, sizeof(int32_t) * L);
    std::memcpy(p2, pos2 + off, sizeof(int32_t) * L);
    std::memcpy(m, mask + off, sizeof(float) * L);
  }

  // Fill one batch of episode ROW INDICES only (no corpus copies): the
  // device-resident token/feature-cache path (train/token_cache.py) gathers
  // rows on device, so the host needs just [B,N,K]+[B,TQ] int32 ids per
  // step. Identical episode semantics and per-batch-idx RNG stream shape as
  // sample() below; ~100x less host work and bytes.
  void sample_indices(int64_t batch_idx, int32_t* sup_idx, int32_t* qry_idx,
                      int32_t* label) const {
    uint64_t se = seed;
    se ^= splitmix64(se) + (uint64_t)batch_idx * 0x9E3779B97F4A7C15ULL;
    Xoshiro256 rng(se);

    const int64_t TQ = total_q();
    std::vector<int64_t> rels(num_relations);
    std::vector<int64_t> inst;
    std::vector<int64_t> qrows;
    std::vector<int32_t> qlabels;
    std::vector<int64_t> perm;
    std::vector<char> in_episode(num_relations);

    for (int32_t b = 0; b < batch_size; ++b) {
      for (int64_t r = 0; r < num_relations; ++r) rels[r] = r;
      partial_shuffle(rels, n, rng);
      std::fill(in_episode.begin(), in_episode.end(), 0);
      for (int32_t c = 0; c < n; ++c) in_episode[rels[c]] = 1;

      qrows.clear();
      qlabels.clear();
      for (int32_t c = 0; c < n; ++c) {
        const int64_t r = rels[c];
        const int64_t m_r = rel_size(r);
        inst.resize(m_r);
        for (int64_t i = 0; i < m_r; ++i) inst[i] = rel_offsets[r] + i;
        partial_shuffle(inst, k + q, rng);
        for (int32_t j = 0; j < k; ++j)
          sup_idx[((size_t)b * n + c) * k + j] = (int32_t)inst[j];
        for (int32_t j = 0; j < q; ++j) {
          qrows.push_back(inst[k + j]);
          qlabels.push_back(c);
        }
      }
      for (int64_t j = 0; j < (int64_t)na_rate * q; ++j) {
        int64_t r;
        do {
          r = (int64_t)rng.bounded((uint64_t)num_relations);
        } while (in_episode[r]);
        qrows.push_back(rel_offsets[r] +
                        (int64_t)rng.bounded((uint64_t)rel_size(r)));
        qlabels.push_back(n);
      }
      perm.resize(TQ);
      for (int64_t i = 0; i < TQ; ++i) perm[i] = i;
      partial_shuffle(perm, TQ, rng);
      for (int64_t i = 0; i < TQ; ++i) {
        qry_idx[(size_t)b * TQ + i] = (int32_t)qrows[perm[i]];
        label[(size_t)b * TQ + i] = qlabels[perm[i]];
      }
    }
  }

  // Fill one batch (batch index fixes the RNG stream → deterministic).
  void sample(int64_t batch_idx, int32_t* sw, int32_t* sp1, int32_t* sp2,
              float* sm, int32_t* qw, int32_t* qp1, int32_t* qp2, float* qm,
              int32_t* label) const {
    uint64_t se = seed;
    // Mix batch index into the seed stream (two rounds decorrelate).
    se ^= splitmix64(se) + (uint64_t)batch_idx * 0x9E3779B97F4A7C15ULL;
    Xoshiro256 rng(se);

    const int64_t TQ = total_q();
    std::vector<int64_t> rels(num_relations);
    std::vector<int64_t> inst;
    std::vector<int64_t> qrows;   // query source rows, pre-shuffle
    std::vector<int32_t> qlabels;
    std::vector<int64_t> perm;
    std::vector<char> in_episode(num_relations);

    for (int32_t b = 0; b < batch_size; ++b) {
      // --- draw N distinct relations ---
      for (int64_t r = 0; r < num_relations; ++r) rels[r] = r;
      partial_shuffle(rels, n, rng);
      std::fill(in_episode.begin(), in_episode.end(), 0);
      for (int32_t c = 0; c < n; ++c) in_episode[rels[c]] = 1;

      qrows.clear();
      qlabels.clear();

      // --- per class: K support rows + Q query rows, no overlap ---
      for (int32_t c = 0; c < n; ++c) {
        const int64_t r = rels[c];
        const int64_t m_r = rel_size(r);
        inst.resize(m_r);
        for (int64_t i = 0; i < m_r; ++i) inst[i] = rel_offsets[r] + i;
        partial_shuffle(inst, k + q, rng);
        for (int32_t j = 0; j < k; ++j) {
          const size_t o =
              (((size_t)b * n + c) * k + j) * L;  // [B, N, K, L]
          copy_row(inst[j], sw + o, sp1 + o, sp2 + o, sm + o);
        }
        for (int32_t j = 0; j < q; ++j) {
          qrows.push_back(inst[k + j]);
          qlabels.push_back(c);
        }
      }

      // --- NOTA negatives from outside the episode ---
      for (int64_t j = 0; j < (int64_t)na_rate * q; ++j) {
        int64_t r;
        do {
          r = (int64_t)rng.bounded((uint64_t)num_relations);
        } while (in_episode[r]);
        const int64_t row = rel_offsets[r] + (int64_t)rng.bounded((uint64_t)rel_size(r));
        qrows.push_back(row);
        qlabels.push_back(n);
      }

      // --- shuffle queries within the episode ---
      perm.resize(TQ);
      for (int64_t i = 0; i < TQ; ++i) perm[i] = i;
      partial_shuffle(perm, TQ, rng);
      for (int64_t i = 0; i < TQ; ++i) {
        const int64_t src = perm[i];
        const size_t o = ((size_t)b * TQ + i) * L;  // [B, TQ, L]
        copy_row(qrows[src], qw + o, qp1 + o, qp2 + o, qm + o);
        label[(size_t)b * TQ + i] = qlabels[src];
      }
    }
  }
};

// --------------------------------------------------------- Pipeline ------
// Ring buffer of pre-sampled batches filled by worker threads. Slot `i`
// holds batch sequence number i, i+depth, i+2*depth, … — consumers always
// read batches in sequence order, so the output equals the single-threaded
// sampler stream (determinism preserved under any thread count).

struct Slot {
  std::vector<int32_t> sw, sp1, sp2, qw, qp1, qp2;
  std::vector<float> sm, qm;
  std::vector<int32_t> label;
  int64_t batch_idx = -1;  // which sequence number currently occupies it
  bool claimed = false;    // a worker is filling (or has filled) the slot
  bool ready = false;      // fill complete, awaiting the consumer
  std::mutex mu;
  std::condition_variable cv;
};

struct Pipeline {
  Sampler* sampler;  // borrowed
  int depth;
  std::vector<Slot> slots;
  std::vector<std::thread> workers;
  std::atomic<int64_t> next_to_fill{0};
  int64_t next_to_read = 0;
  std::atomic<bool> stop{false};

  Pipeline(Sampler* s, int depth_, int num_threads, int64_t start = 0)
      : sampler(s), depth(depth_), slots(depth_), next_to_fill(start),
        next_to_read(start) {
    const size_t sup = (size_t)s->batch_size * s->n * s->k * s->L;
    const size_t qry = (size_t)s->batch_size * s->total_q() * s->L;
    const size_t lab = (size_t)s->batch_size * s->total_q();
    for (int i = 0; i < depth_; ++i) {
      Slot& slot = slots[i];
      slot.sw.resize(sup); slot.sp1.resize(sup); slot.sp2.resize(sup);
      slot.sm.resize(sup);
      slot.qw.resize(qry); slot.qp1.resize(qry); slot.qp2.resize(qry);
      slot.qm.resize(qry);
      slot.label.resize(lab);
    }
    // "Last consumed" sentinels such that the first admissible fill for
    // slot (idx % depth) is the first sequence number >= start mapping to
    // it (see succession rule in worker_loop). start = 0 reproduces the
    // original sentinels; a cursor resume starts mid-stream.
    for (int64_t i = 0; i < depth_; ++i) {
      const int64_t idx_first = start + i;
      slots[idx_first % depth_].batch_idx = idx_first - depth_;
    }
    for (int t = 0; t < num_threads; ++t)
      workers.emplace_back([this] { worker_loop(); });
  }

  ~Pipeline() {
    // Lock each slot's mutex around the notify: without it, a worker that
    // just evaluated its wait predicate (seeing stop == false) but has not
    // yet re-armed the wait would miss the wakeup and join() would hang.
    stop.store(true);
    for (auto& slot : slots) {
      std::lock_guard<std::mutex> lk(slot.mu);
      slot.cv.notify_all();
    }
    for (auto& w : workers) w.join();
  }

  void worker_loop() {
    while (!stop.load()) {
      const int64_t idx = next_to_fill.fetch_add(1);
      Slot& slot = slots[idx % depth];
      {
        std::unique_lock<std::mutex> lk(slot.mu);
        // Strict succession: the slot only admits batch (last consumed +
        // depth). Without this, a worker holding idx+2*depth could claim
        // the slot ahead of the worker holding idx+depth, whose wait could
        // then never be satisfied → deadlock (caught by the 2000-batch
        // stress in tests/test_native.py).
        slot.cv.wait(lk, [&] {
          return stop.load() ||
                 (!slot.claimed && slot.batch_idx + depth == idx);
        });
        if (stop.load()) return;
        slot.claimed = true;
        slot.batch_idx = idx;
      }
      sampler->sample(idx, slot.sw.data(), slot.sp1.data(), slot.sp2.data(),
                      slot.sm.data(), slot.qw.data(), slot.qp1.data(),
                      slot.qp2.data(), slot.qm.data(), slot.label.data());
      {
        std::lock_guard<std::mutex> lk(slot.mu);
        slot.ready = true;
      }
      slot.cv.notify_all();
    }
  }

  void next(int32_t* sw, int32_t* sp1, int32_t* sp2, float* sm, int32_t* qw,
            int32_t* qp1, int32_t* qp2, float* qm, int32_t* label) {
    const int64_t idx = next_to_read++;
    Slot& slot = slots[idx % depth];
    std::unique_lock<std::mutex> lk(slot.mu);
    slot.cv.wait(lk, [&] { return slot.ready && slot.batch_idx == idx; });
    auto cp = [](auto* dst, const auto& src) {
      std::memcpy(dst, src.data(), src.size() * sizeof(src[0]));
    };
    cp(sw, slot.sw); cp(sp1, slot.sp1); cp(sp2, slot.sp2); cp(sm, slot.sm);
    cp(qw, slot.qw); cp(qp1, slot.qp1); cp(qp2, slot.qp2); cp(qm, slot.qm);
    cp(label, slot.label);
    slot.ready = false;  // free the slot for batch idx + depth
    slot.claimed = false;
    lk.unlock();
    slot.cv.notify_all();
  }
};

}  // namespace

// ------------------------------------------------------------ C ABI ------

extern "C" {

void* inf_sampler_create(const int32_t* words, const int32_t* pos1,
                         const int32_t* pos2, const float* mask,
                         const int64_t* rel_offsets, int64_t num_relations,
                         int32_t L, int32_t n, int32_t k, int32_t q,
                         int32_t na_rate, int32_t batch_size, uint64_t seed) {
  auto* s = new Sampler();
  s->words = words;
  s->pos1 = pos1;
  s->pos2 = pos2;
  s->mask = mask;
  s->rel_offsets.assign(rel_offsets, rel_offsets + num_relations + 1);
  s->num_relations = num_relations;
  s->L = L;
  s->n = n;
  s->k = k;
  s->q = q;
  s->na_rate = na_rate;
  s->batch_size = batch_size;
  s->seed = seed;
  return s;
}

void inf_sampler_destroy(void* h) { delete static_cast<Sampler*>(h); }

// Fill one batch; uses and advances the sampler's internal sequence number.
void inf_sampler_sample(void* h, int32_t* sw, int32_t* sp1, int32_t* sp2,
                        float* sm, int32_t* qw, int32_t* qp1, int32_t* qp2,
                        float* qm, int32_t* label) {
  auto* s = static_cast<Sampler*>(h);
  s->sample(s->next_batch.fetch_add(1), sw, sp1, sp2, sm, qw, qp1, qp2, qm,
            label);
}

// Fill `s_count` consecutive index batches STACKED on a leading S axis
// (sup_idx [S,B,N,K], qry_idx [S,B,TQ], label [S,B,TQ]) — the exact layout
// a steps_per_call-fused dispatch consumes. Advances the sequence by
// s_count; per-batch determinism is unchanged (each batch re-seeds from its
// own sequence number).
void inf_sampler_sample_indices(void* h, int64_t s_count, int32_t* sup_idx,
                                int32_t* qry_idx, int32_t* label) {
  auto* s = static_cast<Sampler*>(h);
  const int64_t base = s->next_batch.fetch_add(s_count);
  const size_t sup_stride = (size_t)s->batch_size * s->n * s->k;
  const size_t qry_stride = (size_t)s->batch_size * s->total_q();
  for (int64_t i = 0; i < s_count; ++i) {
    s->sample_indices(base + i, sup_idx + (size_t)i * sup_stride,
                      qry_idx + (size_t)i * qry_stride,
                      label + (size_t)i * qry_stride);
  }
}

// Stream-position accessors (datapipe cursor support): the sampler is a
// pure function of (seed, batch index), so "where the stream is" IS the
// next sequence number — get it for checkpoints, set it on resume.
int64_t inf_sampler_get_next(void* h) {
  return static_cast<Sampler*>(h)->next_batch.load();
}

void inf_sampler_set_next(void* h, int64_t next) {
  static_cast<Sampler*>(h)->next_batch.store(next);
}

void* inf_pipeline_create(void* sampler, int32_t depth, int32_t num_threads) {
  return new Pipeline(static_cast<Sampler*>(sampler), depth, num_threads);
}

// Pipeline whose first delivered batch is sequence number `start` — the
// resume path: a restored cursor recreates the prefetch pipeline at the
// consumed position instead of replaying from batch 0.
void* inf_pipeline_create_at(void* sampler, int32_t depth,
                             int32_t num_threads, int64_t start) {
  auto* p = new Pipeline(static_cast<Sampler*>(sampler), depth, num_threads,
                         start);
  return p;
}

void inf_pipeline_next(void* h, int32_t* sw, int32_t* sp1, int32_t* sp2,
                       float* sm, int32_t* qw, int32_t* qp1, int32_t* qp2,
                       float* qm, int32_t* label) {
  static_cast<Pipeline*>(h)->next(sw, sp1, sp2, sm, qw, qp1, qp2, qm, label);
}

void inf_pipeline_destroy(void* h) { delete static_cast<Pipeline*>(h); }

}  // extern "C"
