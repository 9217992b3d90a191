"""The query-graph cache's host side (CPU, a fake program factory).

``QueryGraphCache`` makes one program per (n_tier, bucket, dtype) key and
parameter bank; on the card each is a captured CUDA graph, which only
the card can run (``test_graph_replay_equals_eager_on_the_card``, marked
``cuda``). Here a fake factory records what would be captured: the keys
planned per tier, the warmup count against ``program_bound``, no capture
after warmup across registration, thresholds, dtype rolls and publishes,
and the bank flip of a publish with a batch in flight on the old bank.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import threading

import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.data import (
    GloveTokenizer,
    make_synthetic_fewrel,
    make_synthetic_glove,
)
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.serving.buckets import (
    QueryGraphCache,
    QueryRunner,
    resident_dtype_name,
    stack_queries,
)
from induction_network_on_fewrel_tpu_torch.serving.engine import InferenceEngine
from induction_network_on_fewrel_tpu_torch.serving.geometry import program_bound

VOCAB, L, K = 60, 10, 2
SMALL = dict(vocab_size=VOCAB + 2, max_length=L, word_dim=8, pos_dim=2, lstm_hidden=8,
             att_dim=4, induction_dim=6, ntn_slices=3, k=K, compute_dtype="float32")
BUCKETS = (1, 2, 4, 8)
TIERS = (4, 8, 16, 32, 64)


class FakeProgram:
    """Records its key and bank; answers eagerly (so verdicts stay real)."""

    captured = True
    made: list = []

    def __init__(self, model, n, c, bucket, max_length, dtype, bank):
        self.key, self.bank = (n, bucket, dtype), bank
        self.runner = QueryRunner(model)
        self.split = (0.0, 0.0, 0.0)
        self.runs = 0
        self.gate = None
        FakeProgram.made.append(self)

    def run(self, class_mat, query, scale=None):
        self.runs += 1
        if self.gate is not None:
            entered, release = self.gate
            entered.set()
            release.wait(timeout=30.0)
        return self.runner.run(class_mat, query, scale)


@pytest.fixture
def world():
    cfg = ExperimentConfig(**SMALL)
    model = build_model(cfg, device="cpu")
    tok = GloveTokenizer(make_synthetic_glove(vocab_size=VOCAB, word_dim=8), max_length=L)
    ds = make_synthetic_fewrel(num_relations=12, instances_per_relation=6, vocab_size=VOCAB,
                               sentence_len=(4, 12), seed=2)
    FakeProgram.made = []
    return cfg, model, tok, ds


def _engine(world, **kw):
    cfg, model, tok, _ = world
    kw.setdefault("start", False)
    banks = []

    def factory(m, n, c, bucket, max_length, dtype):
        return FakeProgram(m, n, c, bucket, max_length, dtype, bank=banks.index(m))

    eng = InferenceEngine(model, cfg, tok, device="cpu", buckets=BUCKETS,
                          geometry_tiers=",".join(map(str, TIERS)), program_factory=factory,
                          **kw)
    banks.extend(eng.registry.banks)
    return eng


def _drain(eng, futs):
    while not all(f.done() for f in futs):
        eng.batcher.drain_once(block_s=0.01)
    return [f.result() for f in futs]


def _sizes(eng, ds, tenant, sizes):
    """One batch of each size for ``tenant``; returns the verdicts."""
    names = eng.registry.names_for(tenant)
    pool = [i for n in names for i in ds.instances[n][K:]]
    out = []
    for size in sizes:
        out += _drain(eng, [eng.submit(pool[j % len(pool)], deadline_s=30.0, tenant=tenant)
                            for j in range(size)])
    return out


def test_warmup_plans_one_key_per_tier_bucket_dtype(world):
    eng = _engine(world)
    try:
        ds = world[3]
        eng.register_dataset(ds, max_classes=3, tenant="a")       # tier 4
        eng.register_dataset(ds, max_classes=6, tenant="b")       # tier 8
        eng.register_dataset(ds, max_classes=7, tenant="c")       # tier 8, shared keys
        made = eng.warmup()
        keys = {(t, b, "f32") for t in (4, 8) for b in BUCKETS}
        assert set(eng.programs.keys()) == keys and made == len(keys)
        assert made <= program_bound(TIERS, BUCKETS, 1)
        assert eng.programs.captures == 2 * made                  # one graph per bank
        assert sorted((p.key, p.bank) for p in FakeProgram.made) == sorted(
            (k, b) for k in keys for b in (0, 1))
        assert eng.stats.snapshot()["warmup_compiles"] == made
        assert eng.warmup() == 0                                  # idempotent
    finally:
        eng.close()


def test_no_capture_after_warmup_across_the_control_plane(world):
    """Traffic of every batch size, registrations inside a tier, a
    threshold, a publish and a tier-crossing registration: only the
    crossing makes programs, counted as warmup before the swap."""
    eng = _engine(world)
    try:
        ds = world[3]
        eng.register_dataset(ds, max_classes=3, tenant="a")
        eng.register_dataset(ds, max_classes=6, tenant="b")
        eng.warmup()
        made, captures = eng.programs.compiles, eng.programs.captures
        _sizes(eng, ds, "a", (1, 2, 3, 5, 8))
        eng.register_class(ds.rel_names[3], ds.instances[ds.rel_names[3]][:K], tenant="a")
        eng.set_nota_threshold(0.5, tenant="b")
        eng.publish_params({k: v.clone() * 1.01 for k, v in eng.registry.model.state_dict()
                            .items()})
        _sizes(eng, ds, "b", (4, 7))
        assert (eng.programs.compiles, eng.programs.captures) == (made, captures)
        # 4 -> 5 classes crosses tier 4 -> 8: tier 8's keys exist (tenant b).
        eng.register_class(ds.rel_names[4], ds.instances[ds.rel_names[4]][:K], tenant="a")
        assert eng.registry.snapshot("a").n_tier == 8
        assert eng.programs.compiles == made
        # 6 -> 9 classes crosses tier 8 -> 16: made before the swap.
        eng.register_dataset(ds, max_classes=9, tenant="b")
        assert eng.programs.compiles == made + len(BUCKETS)
        _sizes(eng, ds, "b", (1, 8))
        snap = eng.stats.snapshot()
        assert snap["steady_recompiles"] == 0
        assert snap["warmup_compiles"] == made + len(BUCKETS)
    finally:
        eng.close()


def test_dtype_roll_warms_before_the_swap(world):
    eng = _engine(world, quant_probe_every=1)
    try:
        ds = world[3]
        eng.register_dataset(ds, max_classes=3, tenant="a")
        eng.warmup()
        eng.set_resident_dtype("a", "int8")      # int8 keys; f32 shadow keys exist
        assert {k[2] for k in eng.programs.keys()} == {"f32", "int8"}
        eng.set_resident_dtype("a", "bf16")
        assert len(eng.programs.keys()) <= program_bound((4,), BUCKETS, 3)
        verdicts = _sizes(eng, ds, "a", (1, 4))
        assert all(v["label"] in eng.registry.names_for("a") or v["nota"] for v in verdicts)
        assert eng.stats.snapshot()["steady_recompiles"] == 0
        assert eng.stats.snapshot()["quant_probes"] == 2
    finally:
        eng.close()


def test_a_miss_after_warmup_counts_as_a_steady_recompile(world):
    eng = _engine(world)
    try:
        eng.register_dataset(world[3], max_classes=3)
        _sizes(eng, world[3], "default", (2,))          # no warmup: a miss
        assert eng.stats.snapshot()["steady_recompiles"] == 1
    finally:
        eng.close()


def test_publish_flips_banks_and_pins_the_in_flight_batch(world):
    """A batch admitted before the commit scores on the old bank's weights
    even while the commit happens; the next batch scores on the new bank;
    a second publish waits until no batch pins its (the old) bank; no
    publish makes a program."""
    eng = _engine(world, start=True)
    try:
        ds = world[3]
        eng.register_dataset(ds, max_classes=3, tenant="a")
        eng.warmup()
        made = eng.programs.compiles
        q = ds.instances[ds.rel_names[0]][K]
        old_sd = {k: v.clone() for k, v in eng.registry.model.state_dict().items()}
        new_sd = {k: v * 1.5 for k, v in old_sd.items()}
        prog0 = next(p for p in FakeProgram.made if p.key == (4, 1, "f32") and p.bank == 0)
        entered, release = threading.Event(), threading.Event()
        prog0.gate = (entered, release)
        old_snap = eng.registry.snapshot("a")
        held = eng.submit(q, deadline_s=60.0, tenant="a")
        assert entered.wait(timeout=30.0)                 # the batch is on bank 0
        assert eng.publish_params(new_sd) == 1            # commits around it
        new_snap = eng.registry.snapshot("a")
        assert (old_snap.bank, new_snap.bank) == (0, 1)
        second = threading.Thread(target=eng.publish_params, args=(old_sd,))
        second.start()
        second.join(timeout=0.5)
        assert second.is_alive()                          # bank 0 is still pinned
        assert eng.registry.params_version == 1
        prog0.gate = None
        release.set()
        v_old = held.result(timeout=30.0)
        second.join(timeout=30.0)
        assert not second.is_alive() and eng.registry.params_version == 2
        assert eng.registry.snapshot("a").bank == 0
        # The held batch scored with the old weights and the old matrix.
        ref = build_model(world[0], device="cpu")
        t = eng.tokenizer(q)
        query = stack_queries([{k: getattr(t, k) for k in ("word", "pos1", "pos2", "mask")}], 1)
        ref.load_state_dict(old_sd)
        want_old = QueryRunner(ref).run(old_snap.matrix, query)[0][:3]
        ref.load_state_dict(new_sd)
        want_new = QueryRunner(ref).run(new_snap.matrix, query)[0][:3]
        assert not np.allclose(want_old, want_new)
        np.testing.assert_allclose(list(v_old["logits"].values()), want_old, rtol=1e-6, atol=1e-6)
        assert v_old["snapshot_version"] == old_snap.version
        prog1 = next(p for p in FakeProgram.made if p.key == (4, 1, "f32") and p.bank == 1)
        runs1 = prog1.runs
        eng.publish_params(new_sd)                        # back to bank 1, version 3
        v_new = eng.classify(q, deadline_s=60.0, tenant="a")
        assert prog1.runs == runs1 + 1
        np.testing.assert_allclose(list(v_new["logits"].values()), want_new, rtol=1e-5, atol=1e-5)
        assert eng.programs.compiles == made and eng.stats.snapshot()["steady_recompiles"] == 0
    finally:
        eng.close()


def test_resident_dtype_names():
    assert [resident_dtype_name(d) for d in (torch.float32, torch.bfloat16, torch.int8)] == [
        "f32", "bf16", "int8"]
    assert resident_dtype_name(np.float32) == "f32"
    with pytest.raises(ValueError, match="not a resident dtype"):
        resident_dtype_name(torch.float16)


@pytest.mark.cuda
def test_graph_replay_equals_eager_on_the_card():
    """One key's captured graph vs the eager scorer on the same weights,
    matrix and queries (f32, bf16 and int8 residency), within 1e-6 of the
    logits' scale; the graph keeps a re-filled matrix."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the capture runs only there")
    cfg = ExperimentConfig(**SMALL)
    model = build_model(cfg, device="cuda")
    cache = QueryGraphCache([model])
    rng = np.random.default_rng(0)
    query = {"word": rng.integers(0, VOCAB, (4, L)).astype(np.int32),
             "pos1": rng.integers(0, 2 * L, (4, L)).astype(np.int16),
             "pos2": rng.integers(0, 2 * L, (4, L)).astype(np.int16),
             "mask": np.ones((4, L), np.int8)}
    for dtype, scale in (("f32", None), ("bf16", None), ("int8", 0.01)):
        for seed in (1, 2):
            mat = torch.randn((8, cfg.induction_dim), generator=torch.Generator().manual_seed(
                seed))
            mat = (mat * 50).to(torch.int8) if dtype == "int8" else mat.to(
                {"f32": torch.float32, "bf16": torch.bfloat16}[dtype])
            got = cache.run(0, mat.cuda(), query, scale=scale)
            want = QueryRunner(model).run(mat.cuda(), query, scale)
            assert np.abs(got - want).max() <= 1e-6 * max(1.0, np.abs(want).max())
    assert cache.captures == 3


@pytest.mark.cuda
def test_two_engines_capture_at_once_on_the_card():
    """Two caches (two replicas' engines) making programs from two threads at
    the same moment: the captures take turns (they share the serving
    capture stream) and both caches' graphs replay equal to eager."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the capture runs only there")
    cfg = ExperimentConfig(**SMALL)
    models = [build_model(cfg.replace(seed=s), device="cuda") for s in (1, 2)]
    caches = [QueryGraphCache([m]) for m in models]
    errors: list = []
    start = threading.Barrier(2)

    def warm(cache):
        try:
            start.wait()
            cache.warmup(8, cfg.induction_dim, (1, 2, 4), L, dtypes=("f32", "bf16"))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=warm, args=(c,)) for c in caches]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    rng = np.random.default_rng(3)
    query = {"word": rng.integers(0, VOCAB, (4, L)).astype(np.int32),
             "pos1": rng.integers(0, 2 * L, (4, L)).astype(np.int16),
             "pos2": rng.integers(0, 2 * L, (4, L)).astype(np.int16),
             "mask": np.ones((4, L), np.int8)}
    mat = torch.randn((8, cfg.induction_dim), generator=torch.Generator().manual_seed(4)).cuda()
    for cache, model in zip(caches, models):
        assert cache.captures == 6
        want = QueryRunner(model).run(mat, query)
        assert np.abs(cache.run(0, mat, query) - want).max() <= 1e-6 * max(1.0, np.abs(want).max())
