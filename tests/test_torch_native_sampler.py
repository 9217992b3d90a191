"""The port's C++ episode samplers (sampling/native.py) against the JAX package's.

Both packages build their own copy of ``episode_sampler.cpp`` with g++ and
wrap it with ctypes; on the same corpus and seed the port's batches must
equal the JAX ``native/sampler.py`` batches bitwise: token batches (direct,
and through the C++ prefetch ring at 1 and 3 threads), index batches,
``sample_fused(S)`` against S single draws, NOTA labels. Then the cursor
protocol's round trips, the factories' backend policy (``auto`` = native
for a training stream, numpy for an evaluation stream; a library that does
not build under ``auto`` raises naming ``--sampler python``), and a failed
g++ build raising with the compiler's output. Every sampler is closed.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import numpy as np
import pytest

from induction_network_on_fewrel_tpu.data import GloveTokenizer as JaxTokenizer
from induction_network_on_fewrel_tpu.data import make_synthetic_fewrel as jax_fewrel
from induction_network_on_fewrel_tpu.data import make_synthetic_glove as jax_glove
from induction_network_on_fewrel_tpu.native.sampler import NativeEpisodeSampler as JaxNative
from induction_network_on_fewrel_tpu.native.sampler import NativeIndexSampler as JaxNativeIndex
from induction_network_on_fewrel_tpu_torch.data import (
    GloveTokenizer,
    make_synthetic_fewrel,
    make_synthetic_glove,
)
from induction_network_on_fewrel_tpu_torch.kernels import build
from induction_network_on_fewrel_tpu_torch.sampling import native
from induction_network_on_fewrel_tpu_torch.sampling.episodes import EpisodeSampler
from induction_network_on_fewrel_tpu_torch.sampling.index import IndexEpisodeSampler
from induction_network_on_fewrel_tpu_torch.sampling.native import (
    NativeEpisodeSampler,
    NativeIndexSampler,
    make_index_sampler,
    make_sampler,
)

N, K, Q, L, B, R = 5, 2, 3, 16, 2, 10
SIZES = [9, 12, 7, 10, 8, 11]


@pytest.fixture(scope="module")
def corpora():
    """(port dataset, port tokenizer, JAX dataset, JAX tokenizer) of one
    synthetic corpus."""
    ds = make_synthetic_fewrel(num_relations=R, instances_per_relation=20, vocab_size=300)
    jds = jax_fewrel(num_relations=R, instances_per_relation=20, vocab_size=300)
    return (ds, GloveTokenizer(make_synthetic_glove(vocab_size=300), max_length=L),
            jds, JaxTokenizer(jax_glove(vocab_size=300), max_length=L))


def _equal(a, b):
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y)


def _closing(*samplers):
    for s in samplers:
        s.close()


@pytest.mark.parametrize("na_rate", [0, 1])
@pytest.mark.parametrize("prefetch,threads", [(0, 1), (3, 1), (3, 3)],
                         ids=["direct", "ring-1", "ring-3"])
def test_token_batches_equal_jax(corpora, na_rate, prefetch, threads):
    ds, tok, jds, jtok = corpora
    ours = NativeEpisodeSampler(ds, tok, N, K, Q, batch_size=B, na_rate=na_rate, seed=11,
                                prefetch=prefetch, num_threads=threads)
    theirs = JaxNative(jds, jtok, N, K, Q, batch_size=B, na_rate=na_rate, seed=11)
    try:
        for _ in range(8):
            a, b = ours.sample_batch(), theirs.sample_batch()
            _equal(a, b)
        assert a.support_word.shape == (B, N, K, L) and a.label.shape == (B, (N + na_rate) * Q)
        if na_rate:
            assert (a.label == N).sum() == B * na_rate * Q
    finally:
        _closing(ours, theirs)


@pytest.mark.parametrize("na_rate", [0, 1])
def test_index_batches_and_fused_equal_jax(na_rate):
    ours = NativeIndexSampler(SIZES, 3, 2, 2, batch_size=3, na_rate=na_rate, seed=5)
    theirs = JaxNativeIndex(SIZES, 3, 2, 2, batch_size=3, na_rate=na_rate, seed=5)
    single = NativeIndexSampler(SIZES, 3, 2, 2, batch_size=3, na_rate=na_rate, seed=5)
    try:
        for _ in range(3):
            _equal(ours.sample_batch(), theirs.sample_batch())
        fused = ours.sample_fused(4)
        _equal(fused, theirs.sample_fused(4))
        for _ in range(3):
            single.sample_batch()
        for i in range(4):
            _equal([x[i] for x in fused], single.sample_batch())
        sup, qry, lab = fused
        assert sup.shape == (4, 3, 3, 2) and qry.shape == lab.shape == (4, 3, (3 + na_rate) * 2)
        offsets = np.cumsum([0] + SIZES)
        rel_of = np.searchsorted(offsets, qry, side="right") - 1
        if na_rate:
            # NOTA queries come from relations outside the episode's N.
            ep_rels = np.searchsorted(offsets, sup[..., 0], side="right") - 1    # [S, B, N]
            nota = lab == 3
            assert nota.sum() == 4 * 3 * 2
            for s, b in zip(*np.nonzero(nota.any(-1))):
                assert not set(rel_of[s, b][nota[s, b]]) & set(ep_rels[s, b])
        else:
            assert set(np.unique(lab)) == {0, 1, 2}
    finally:
        _closing(ours, theirs, single)


@pytest.mark.parametrize("prefetch", [0, 3], ids=["direct", "ring"])
def test_token_fused_equals_single_draws(corpora, prefetch):
    """``sample_fused(S)`` stacks the next S batches of the same stream."""
    ds, tok, _, _ = corpora
    fused = NativeEpisodeSampler(ds, tok, N, K, Q, batch_size=B, na_rate=1, seed=6,
                                 prefetch=prefetch)
    single = NativeEpisodeSampler(ds, tok, N, K, Q, batch_size=B, na_rate=1, seed=6)
    try:
        fused.sample_batch()
        block = fused.sample_fused(4)
        assert block.query_word.shape == (4, B, (N + 1) * Q, L)
        assert all(a.flags.c_contiguous for a in block)
        single.sample_batch()
        for i in range(4):
            _equal([x[i] for x in block], single.sample_batch())
        assert fused.feed_state() == {"kind": "native", "next": 5}
    finally:
        _closing(fused, single)


@pytest.mark.parametrize("prefetch", [0, 3], ids=["direct", "ring"])
def test_token_feed_state_round_trip(corpora, prefetch):
    ds, tok, _, _ = corpora
    a = NativeEpisodeSampler(ds, tok, N, K, Q, batch_size=B, seed=3, prefetch=prefetch)
    b = NativeEpisodeSampler(ds, tok, N, K, Q, batch_size=B, seed=3, prefetch=prefetch)
    try:
        for _ in range(5):
            a.sample_batch()
        state = a.feed_state()
        assert state == {"kind": "native", "next": 5}
        want = [a.sample_batch() for _ in range(4)]
        b.restore_feed_state(state)
        for w in want:
            _equal(w, b.sample_batch())
    finally:
        _closing(a, b)


def test_index_feed_state_round_trip():
    a = NativeIndexSampler(SIZES, 3, 2, 2, batch_size=2, seed=9)
    b = NativeIndexSampler(SIZES, 3, 2, 2, batch_size=2, seed=9)
    try:
        a.sample_fused(3)
        a.sample_batch()
        state = a.feed_state()
        assert state == {"kind": "native", "next": 4}
        want = a.sample_fused(2)
        b.restore_feed_state(state)
        _equal(want, b.sample_fused(2))
    finally:
        _closing(a, b)


def test_factories_follow_the_backend_policy(corpora):
    ds, tok, _, _ = corpora
    made = [
        (make_sampler(ds, tok, N, K, Q, batch_size=B, prefetch=0), NativeEpisodeSampler),
        (make_sampler(ds, tok, N, K, Q, batch_size=B, eval=True), EpisodeSampler),
        (make_sampler(ds, tok, N, K, Q, backend="python"), EpisodeSampler),
        (make_sampler(ds, tok, N, K, Q, backend="native", eval=True, prefetch=0),
         NativeEpisodeSampler),
        (make_index_sampler(SIZES, 3, 2, 2), NativeIndexSampler),
        (make_index_sampler(SIZES, 3, 2, 2, eval=True), IndexEpisodeSampler),
        (make_index_sampler(SIZES, 3, 2, 2, backend="python"), IndexEpisodeSampler),
        (make_index_sampler(SIZES, 3, 2, 2, backend="native", eval=True), NativeIndexSampler),
    ]
    try:
        for sampler, kind in made:
            assert type(sampler) is kind
    finally:
        _closing(*(s for s, _ in made if hasattr(s, "close")))
    with pytest.raises(ValueError, match="unknown sampler"):
        make_index_sampler(SIZES, 3, 2, 2, backend="cuda")


def test_auto_names_the_python_sampler_when_the_build_fails(corpora, monkeypatch):
    ds, tok, _, _ = corpora

    def broken():
        raise RuntimeError("g++ failed on episode_sampler.cpp")

    monkeypatch.setattr(native, "load_native_lib", broken)
    with pytest.raises(RuntimeError, match="--sampler python"):
        make_index_sampler(SIZES, 3, 2, 2)
    with pytest.raises(RuntimeError, match="--sampler python"):
        make_sampler(ds, tok, N, K, Q)
    assert type(make_index_sampler(SIZES, 3, 2, 2, eval=True)) is IndexEpisodeSampler


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int main( {\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed on broken.cpp.*error"):
        build.HostLibrary("broken").build()
    assert not list((tmp_path / "out").glob("*.so"))


def test_needs_enough_relations(corpora):
    ds, tok, _, _ = corpora
    with pytest.raises(ValueError, match="need >= 11 relations"):
        NativeEpisodeSampler(ds, tok, R + 1, K, Q)
    with pytest.raises(ValueError, match="prefetch=2 needs num_threads >= 1"):
        NativeEpisodeSampler(ds, tok, N, K, Q, prefetch=2, num_threads=0)
