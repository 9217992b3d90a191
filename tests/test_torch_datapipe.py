"""The port's host feed (datapipe/) against the invariants of the JAX package's.

The JAX ``tests/test_datapipe.py`` contracts, held on the port: the feed's
stream is bitwise the synchronous sampler's at depths 0, 1, 2 and 4, for
the numpy and the C++ samplers; fused and single draws interleave on one
stream; a cursor resume is exact at every depth and backend, also inside a
fused unit; a layout or stream-tag mismatch raises; a depth-0 feed leaves
a trainer's metrics bitwise unchanged. The mixture's picks and the fault
grammar equal the JAX functions'; a poisoned unit is refused at depths 0
and 2; a ``slow`` fault accumulates stall time; a ``stall`` fault logs
ticks until ``close()`` ends it. Every feed is closed, and no producer
thread outlives its test.
"""

import json
import threading
import time

import numpy as np
import pytest

from induction_network_on_fewrel_tpu.data import GloveTokenizer as JaxTokenizer
from induction_network_on_fewrel_tpu.data import make_synthetic_fewrel as jax_fewrel
from induction_network_on_fewrel_tpu.data import make_synthetic_glove as jax_glove
from induction_network_on_fewrel_tpu.datapipe import FeedFaults as JaxFaults
from induction_network_on_fewrel_tpu.datapipe import MixtureSchedule as JaxSchedule
from induction_network_on_fewrel_tpu.datapipe.faults import perturb_query_batch as jax_perturb
from induction_network_on_fewrel_tpu.datapipe.faults import poison_tree as jax_poison
from induction_network_on_fewrel_tpu.sampling import EpisodeSampler as JaxEpisodeSampler
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.data import (
    GloveTokenizer,
    make_synthetic_fewrel,
    make_synthetic_glove,
)
from induction_network_on_fewrel_tpu_torch.datapipe import (
    FeedError,
    FeedFaults,
    MixtureSampler,
    MixtureSchedule,
    PipelineCursor,
    PipelineFeed,
)
from induction_network_on_fewrel_tpu_torch.datapipe.faults import (
    PerturbedSampler,
    perturb_query_batch,
    poison_tree,
)
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.sampling.episodes import EpisodeSampler
from induction_network_on_fewrel_tpu_torch.sampling.native import (
    make_index_sampler,
    make_sampler,
)
from induction_network_on_fewrel_tpu_torch.train.framework import FewShotTrainer
from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

SIZES = [12] * 6
DEPTHS = (0, 1, 2, 4)
BACKENDS = ("python", "native")


def _index_sampler(seed=7, backend="python"):
    return make_index_sampler(SIZES, 3, 2, 2, batch_size=2, seed=seed, backend=backend)


def _close(*samplers):
    for s in samplers:
        if hasattr(s, "close"):
            s.close()


def _equal(a, b):
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.fixture(scope="module")
def corpus():
    vocab = make_synthetic_glove(vocab_size=300)
    ds = make_synthetic_fewrel(num_relations=6, instances_per_relation=12, vocab_size=300)
    return vocab, ds, GloveTokenizer(vocab, max_length=12)


@pytest.fixture(autouse=True)
def no_thread_left():
    before = set(threading.enumerate())
    yield
    left = [t for t in threading.enumerate()
            if t not in before and t.name == "datapipe-producer" and t.is_alive()]
    assert not left, left


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("depth", DEPTHS)
def test_index_stream_identical_across_depths(depth, backend):
    ref = _index_sampler(backend=backend)
    feed = PipelineFeed(_index_sampler(backend=backend), prefetch_depth=depth)
    try:
        for _ in range(12):
            _equal(ref.sample_batch(), feed.sample_batch())
    finally:
        feed.close()
        _close(ref)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("depth", DEPTHS)
def test_token_stream_identical_across_depths(corpus, depth, backend):
    _, ds, tok = corpus

    def mk():
        return make_sampler(ds, tok, 3, 2, 2, batch_size=2, seed=4, backend=backend, prefetch=2)

    ref, feed = mk(), PipelineFeed(mk(), prefetch_depth=depth)
    try:
        for _ in range(6):
            _equal(ref.sample_batch(), feed.sample_batch())
    finally:
        feed.close()
        _close(ref)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("depth", (0, 2))
def test_fused_and_single_interleave_preserve_stream(depth, backend):
    ref = _index_sampler(backend=backend)
    flat = [ref.sample_batch() for _ in range(13)]
    feed = PipelineFeed(_index_sampler(backend=backend), prefetch_depth=depth, unit=4)
    try:
        _equal(feed.sample_batch(), flat[0])
        stack = feed.sample_fused(4)                # batches 1..4, across a unit boundary
        _equal(feed.sample_batch(), flat[5])
        feed.sample_fused(2)
        whole = feed.sample_fused(4)                # batches 8..11: one whole unit
        _equal(feed.sample_batch(), flat[12])
        for i in range(4):
            _equal([s[i] for s in stack], flat[1 + i])
            _equal([s[i] for s in whole], flat[8 + i])
        assert feed.stats()["consumed"] == 13
    finally:
        feed.close()


@pytest.mark.parametrize("depth", (0, 2))
def test_fused_token_units_interleave_with_single_draws(corpus, depth):
    """The C++ token sampler's fused units: whole, sliced and restacked,
    one stream."""
    _, ds, tok = corpus

    def mk():
        return make_sampler(ds, tok, 3, 2, 2, batch_size=2, seed=4, backend="native", prefetch=0)

    ref = mk()
    flat = [ref.sample_batch() for _ in range(9)]
    feed = PipelineFeed(mk(), prefetch_depth=depth, unit=3)
    try:
        whole = feed.sample_fused(3)                # batches 0..2
        one = feed.sample_batch()                   # batch 3, sliced from a unit
        across = feed.sample_fused(3)               # batches 4..6, restacked
        assert type(whole) is type(one) is type(across) is type(flat[0])
        for i in range(3):
            _equal([x[i] for x in whole], flat[i])
            _equal([x[i] for x in across], flat[4 + i])
        _equal(one, flat[3])
    finally:
        feed.close()
        ref.close()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("depth", DEPTHS)
def test_cursor_resume_exact(depth, backend):
    feed = PipelineFeed(_index_sampler(backend=backend), prefetch_depth=depth)
    try:
        for _ in range(5):
            feed.sample_batch()
        cur = feed.cursor_state()
        want = [feed.sample_batch() for _ in range(6)]
    finally:
        feed.close()
    assert cur.consumed == 5
    cur = PipelineCursor.from_json(cur.to_json())
    resumed = PipelineFeed(_index_sampler(backend=backend), prefetch_depth=2)
    try:
        resumed.restore_cursor(cur)
        for w in want:
            _equal(w, resumed.sample_batch())
    finally:
        resumed.close()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("depth", (1, 2, 4))
def test_cursor_resume_mid_unit_fused(depth, backend):
    """A cursor taken inside a unit (after an odd single draw) restores the
    exact stream: the replay covers the offset into the unit."""
    feed = PipelineFeed(_index_sampler(backend=backend), prefetch_depth=depth, unit=4)
    try:
        feed.sample_fused(4)
        feed.sample_batch()                         # consumed 5, inside unit [4, 8)
        cur = feed.cursor_state()
        want = feed.sample_fused(4)
    finally:
        feed.close()
    assert (cur.consumed, cur.captured_at) == (5, 4)
    resumed = PipelineFeed(_index_sampler(backend=backend), prefetch_depth=4, unit=4)
    try:
        resumed.restore_cursor(PipelineCursor.from_json(cur.to_json()))
        _equal(want, resumed.sample_fused(4))
    finally:
        resumed.close()


def test_cursor_layout_and_tag_mismatch_raise():
    feed = PipelineFeed(_index_sampler(), prefetch_depth=0, stream_tag="mixture=;seed=0")
    try:
        cur = feed.cursor_state()
        assert cur.layout == {"process_count": 1, "process_index": 0, "global_batch": 2,
                              "local_batch": 2}
        bad = PipelineCursor.from_dict(cur.to_dict())
        bad.layout["global_batch"] = 64
        with pytest.raises(ValueError, match="layout mismatch"):
            feed.restore_cursor(bad)
        tagged = PipelineCursor.from_dict(cur.to_dict())
        tagged.stream_tag = "mixture=other;seed=1"
        with pytest.raises(ValueError, match="stream tag"):
            feed.restore_cursor(tagged)
        with pytest.raises(ValueError, match="version 7 unsupported"):
            PipelineCursor.from_dict({**cur.to_dict(), "version": 7})
    finally:
        feed.close()


def test_depth0_feed_leaves_the_metrics_stream_bitwise(corpus, tmp_path):
    """A trainer on a depth-0 feed logs the same training metrics, bitwise,
    as on the bare sampler; the feed adds one kind="data" record a window."""
    vocab, ds, tok = corpus
    cfg = ExperimentConfig(encoder="cnn", n=2, k=2, q=2, batch_size=2, max_length=12,
                           vocab_size=302, hidden_size=16, compute_dtype="float32",
                           train_iter=4, val_step=0)
    model = build_model(cfg, glove_init=vocab.vectors, device="cpu")
    state = {k: v.clone() for k, v in model.state_dict().items()}

    def run(wrap, out):
        model.load_state_dict(state)
        sampler = EpisodeSampler(ds, tok, cfg.n, cfg.k, cfg.q, cfg.batch_size, seed=5)
        if wrap:
            sampler = PipelineFeed(sampler, prefetch_depth=0)
        trainer = FewShotTrainer(model, cfg, sampler, logger=MetricsLogger(out, quiet=True),
                                 metric_window=2)
        try:
            trainer.train(4)
        finally:
            trainer.close()
        recs = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
        return recs

    bare, fed = run(False, tmp_path / "bare"), run(True, tmp_path / "fed")
    strip = [{k: v for k, v in r.items() if k not in ("wall_s", "episodes_per_s")}
             for r in fed if r["kind"] == "train"]
    assert strip == [{k: v for k, v in r.items() if k not in ("wall_s", "episodes_per_s")}
                     for r in bare] and strip
    data = [r for r in fed if r["kind"] == "data"]
    assert [r["step"] for r in data] == [2, 4] and data[-1]["consumed"] == 4.0
    assert all(0.0 <= r["feed_stall_frac"] <= 1.0 for r in data)


def test_mixture_matches_jax():
    specs = ["train:1.0;other:0.0@0,1.0@100", "a:3.0;b:1.0", "x:1@0,0@10;y:0.2@0,1@20;z:0.5"]
    for spec in specs:
        ours, theirs = MixtureSchedule.parse(spec), JaxSchedule.parse(spec)
        assert ours.sources == theirs.sources and ours.to_spec() == theirs.to_spec()
        for seed in (0, 11):
            assert [ours.pick(seed, i) for i in range(1000)] == \
                [theirs.pick(seed, i) for i in range(1000)]
        assert [ours.weights_at(i) for i in (0, 5, 50, 1000)] == \
            [theirs.weights_at(i) for i in (0, 5, 50, 1000)]
    for bad, match in (("nocolon", "must be"), ("a:1@0,2@0", "repeats"), ("a:1;a:2", "twice"),
                       ("a:-1", ">= 0"), ("", "empty")):
        with pytest.raises(ValueError, match=match):
            MixtureSchedule.parse(bad)
        with pytest.raises(ValueError):
            JaxSchedule.parse(bad)


def test_mixture_sampler_stream_and_cursor():
    def mk():
        return MixtureSampler([("a", _index_sampler(seed=1)), ("b", _index_sampler(seed=2))],
                              MixtureSchedule.parse("a:1.0;b:1.0"), seed=4)

    ref = mk()
    want = [ref.sample_batch() for _ in range(10)]
    assert 0 not in ref.counts.values()
    feed = PipelineFeed(mk(), prefetch_depth=2)
    try:
        for _ in range(4):
            feed.sample_batch()
        cur = feed.cursor_state()
        upcoming = [feed.sample_batch() for _ in range(6)]
    finally:
        feed.close()
    for a, b in zip(want[4:], upcoming):
        _equal(a, b)
    resumed = PipelineFeed(mk(), prefetch_depth=0)
    try:
        resumed.restore_cursor(PipelineCursor.from_json(cur.to_json()))
        for u in upcoming:
            _equal(u, resumed.sample_batch())
    finally:
        resumed.close()
    big = make_index_sampler(SIZES, 3, 2, 3, batch_size=2, seed=2, backend="python")
    with pytest.raises(ValueError, match="identically-shaped"):
        MixtureSampler([("a", _index_sampler()), ("b", big)], MixtureSchedule.parse("a:1;b:1"))


def test_fault_parse_matches_jax():
    for spec in ("", "slow:0.05,poison:30", "stall:7", " slow:0 , stall:2,poison:1 "):
        ours, theirs = FeedFaults.parse(spec), JaxFaults.parse(spec)
        assert (ours.slow_s, ours.stall_at, ours.poison_at, ours.active) == \
            (theirs.slow_s, theirs.stall_at, theirs.poison_at, theirs.active)
    for bad in ("explode:1", "slow:-1"):
        with pytest.raises(ValueError):
            FeedFaults.parse(bad)
        with pytest.raises(ValueError):
            JaxFaults.parse(bad)


def test_poison_and_perturbations_match_jax(corpus):
    _, ds, tok = corpus
    batch = EpisodeSampler(ds, tok, 3, 2, 2, batch_size=2, seed=3).sample_batch()
    jds = jax_fewrel(num_relations=6, instances_per_relation=12, vocab_size=300)
    jbatch = JaxEpisodeSampler(jds, JaxTokenizer(jax_glove(vocab_size=300), max_length=12),
                               3, 2, 2, batch_size=2, seed=3).sample_batch()
    _equal(batch, jbatch)
    for ours, theirs in zip(poison_tree(batch), jax_poison(jbatch)):
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))
    for mode in ("token_noise:0.3", "mask_drop:0.5", "blank:0.5"):
        name, _, rate = mode.partition(":")
        ours = perturb_query_batch(batch, name, float(rate), np.random.default_rng(1))
        theirs = jax_perturb(jbatch, name, float(rate), np.random.default_rng(1))
        _equal(ours, theirs)
    wrapped = PerturbedSampler(EpisodeSampler(ds, tok, 3, 2, 2, batch_size=2, seed=3), "blank:1")
    assert wrapped.sample_batch().query_word.shape == batch.query_word.shape


@pytest.mark.parametrize("depth", [0, 2])
def test_poisoned_unit_refused(depth, tmp_path):
    logger = MetricsLogger(tmp_path, quiet=True)
    feed = PipelineFeed(_index_sampler(), prefetch_depth=depth,
                        faults=FeedFaults.parse("poison:3"), logger=logger)
    try:
        for _ in range(3):
            feed.sample_batch()
        with pytest.raises(FeedError, match="poisoned batch refused at index 3"):
            feed.sample_batch()
    finally:
        feed.close()
        logger.close()
    recs = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [(r["kind"], r["poisoned"], r["producer_alive"]) for r in recs] == [("data", 1.0, 1.0)]


def test_slow_fault_accumulates_stall_time():
    feed = PipelineFeed(_index_sampler(), prefetch_depth=0, faults=FeedFaults.parse("slow:0.02"))
    try:
        for _ in range(3):
            feed.sample_batch()
        stats = feed.drain_stats()
    finally:
        feed.close()
    assert stats["stall_s"] >= 0.05 and stats["consumed"] == 3.0
    assert 0.0 < stats["feed_stall_frac"] <= 1.0


@pytest.mark.parametrize("depth", [0, 2])
def test_stall_fault_ticks_until_closed(depth, tmp_path):
    """A wedged producer: the blocked draw logs stall ticks instead of
    hanging silently, and ``close()`` ends it with a FeedError."""
    logger = MetricsLogger(tmp_path, quiet=True)
    feed = PipelineFeed(_index_sampler(), prefetch_depth=depth,
                        faults=FeedFaults.parse("stall:2"), logger=logger, stall_tick_s=0.05)
    errors = []

    def draw():
        try:
            feed.sample_batch()
        except FeedError as e:
            errors.append(e)

    try:
        feed.sample_batch()
        feed.sample_batch()
        blocked = threading.Thread(target=draw, daemon=True)
        blocked.start()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not (tmp_path / "metrics.jsonl").exists():
            time.sleep(0.02)
        assert blocked.is_alive()
    finally:
        feed.close()
        logger.close()
    blocked.join(timeout=10.0)
    assert not blocked.is_alive() and len(errors) == 1
    ticks = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert ticks and all(r["kind"] == "data" and r["consumed"] == 2.0 and r["stalled_s"] > 0
                         for r in ticks)
