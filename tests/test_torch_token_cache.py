"""The port's device-resident token cache vs the JAX package's (CPU).

* ``tokenize_dataset`` (and its offset compaction) bitwise equal to the
  JAX function, dtypes included; a table whose pos1 is not ``off + l``
  keeps it per token while pos2 compacts, as in JAX.
* Offset-form positions: the model's logits and every gradient are
  bitwise those of the per-token ids, with both leaves, pos1 alone or pos2
  alone in offset form.
* The index sampler draws the same stream as the JAX
  ``FeatureEpisodeSampler`` (index mode) from the same seed, with and
  without NOTA.
* A cached training step (indices in, the gather inside the step) equals
  the live step on the same episodes bitwise; fused cached eval equals
  per-batch cached eval.
* ``register_tokens`` on rows of the token cache's form (offset
  positions) gives the JAX registry's class vectors within 1e-5, and the
  same vectors as ``register`` on the raw sentences, bitwise.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import jax
import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.data import GloveTokenizer as JaxTokenizer
from induction_network_on_fewrel_tpu.data import make_synthetic_fewrel as jax_fewrel
from induction_network_on_fewrel_tpu.data import make_synthetic_glove as jax_glove
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu.serving.registry import TenantRegistry as JaxRegistry
from induction_network_on_fewrel_tpu.train.feature_cache import FeatureEpisodeSampler
from induction_network_on_fewrel_tpu.train.token_cache import _compact_pos_offsets as jax_compact
from induction_network_on_fewrel_tpu.train.token_cache import tokenize_dataset as jax_tokenize
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.data import (
    GloveTokenizer,
    make_synthetic_fewrel,
    make_synthetic_glove,
)
from induction_network_on_fewrel_tpu_torch.interop import params_from_jax
from induction_network_on_fewrel_tpu_torch.models.base import to_device
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.sampling.index import (
    IndexEpisodeSampler,
    check_sampler_backend,
)
from induction_network_on_fewrel_tpu_torch.sampling.native import make_index_sampler
from induction_network_on_fewrel_tpu_torch.serving.buckets import zero_batch
from induction_network_on_fewrel_tpu_torch.serving.registry import TenantRegistry
from induction_network_on_fewrel_tpu_torch.train.framework import stack_batches
from induction_network_on_fewrel_tpu_torch.train.steps import (
    make_eval_step,
    make_multi_eval_step,
    make_optimizer,
    make_train_step,
    train_step,
)
from induction_network_on_fewrel_tpu_torch.train.token_cache import (
    TokenTable,
    _compact_pos_offsets,
    tokenize_dataset,
)

VOCAB, L = 60, 12
SMALL = dict(vocab_size=VOCAB + 2, max_length=L, word_dim=10, pos_dim=2, lstm_hidden=16,
             att_dim=8, induction_dim=12, ntn_slices=6, n=3, train_n=3, k=2, q=2, batch_size=2,
             compute_dtype="float32", lr=3e-3)


@pytest.fixture(scope="module")
def world():
    vocab = make_synthetic_glove(vocab_size=VOCAB, word_dim=10)
    ds = make_synthetic_fewrel(num_relations=6, instances_per_relation=8, vocab_size=VOCAB,
                               sentence_len=(5, 16), seed=4)
    tok = GloveTokenizer(vocab, max_length=L)
    jvocab = jax_glove(vocab_size=VOCAB, word_dim=10)
    jds = jax_fewrel(num_relations=6, instances_per_relation=8, vocab_size=VOCAB,
                     sentence_len=(5, 16), seed=4)
    return {"vocab": vocab, "ds": ds, "tok": tok, "jds": jds,
            "jtok": JaxTokenizer(jvocab, max_length=L)}


def test_tokenize_dataset_matches_jax(world):
    table, sizes = tokenize_dataset(world["ds"], world["tok"])
    jtable, jsizes = jax_tokenize(world["jds"], world["jtok"])
    assert sizes == jsizes and set(table) == set(jtable)
    for k, v in table.items():
        assert v.dtype == jtable[k].dtype and np.array_equal(v, jtable[k]), k
    assert table["pos1"].ndim == table["pos2"].ndim == 1         # offset form
    assert table["word"].dtype == np.int32 and table["mask"].dtype == np.int8


def test_compact_pos_offsets_per_key_matches_jax(world):
    arrays = {k: np.stack([getattr(world["tok"](i), k) for r in world["ds"].rel_names
                           for i in world["ds"].instances[r]]) for k in ("word", "mask")}
    full, _ = tokenize_dataset(world["ds"], world["tok"])
    idx = np.arange(L)
    table = {**arrays, "pos1": (full["pos1"][:, None] + idx).astype(np.int16),
             "pos2": (full["pos2"][:, None] + idx).astype(np.int16)}
    table["pos1"][0, -1] = 0                                     # not off + l any more
    got, want = _compact_pos_offsets(table), jax_compact(table)
    assert got["pos1"].shape == table["pos1"].shape and got["pos2"].ndim == 1
    for k in got:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("offset_keys", [("pos1", "pos2"), ("pos1",), ("pos2",)])
def test_offset_form_equals_per_token_ids(world, offset_keys):
    table, _ = tokenize_dataset(world["ds"], world["tok"])
    cfg = ExperimentConfig(**SMALL)
    model = build_model(cfg, device="cpu")
    rng = np.random.default_rng(0)
    sup_i = rng.choice(table["word"].shape[0], (2, 3, 2), replace=False)
    qry_i = rng.choice(table["word"].shape[0], (2, 6))
    idx = np.arange(L)

    def side(i, offsets):
        out = {k: table[k][i] for k in ("word", "mask")}
        for key in ("pos1", "pos2"):
            off = table[key][i]
            out[key] = off if key in offsets else (off[..., None] + idx).astype(np.int16)
        return to_device(out, "cpu")

    def run(offsets):
        model.zero_grad(set_to_none=True)
        logits = model(side(sup_i, offsets), side(qry_i, offsets))
        logits.square().sum().backward()
        return logits.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}

    (a, ga), (b, gb) = run(()), run(offset_keys)
    assert torch.equal(a, b)
    for n in ga:
        assert torch.equal(ga[n], gb[n]), n


@pytest.mark.parametrize("na_rate", [0, 1])
def test_index_sampler_matches_jax(na_rate):
    sizes = [9, 12, 7, 10, 8]
    ours = IndexEpisodeSampler(sizes, 3, 2, 2, batch_size=3, na_rate=na_rate, seed=11)
    theirs = FeatureEpisodeSampler(sizes, 3, 2, 2, batch_size=3, na_rate=na_rate, seed=11)
    for _ in range(5):
        a, b = ours.sample_batch(), theirs.sample_batch()
        for x, y in zip(a, (b.support_idx, b.query_idx, b.label)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    state = ours.rng.bit_generator.state
    again = IndexEpisodeSampler(sizes, 3, 2, 2, batch_size=3, na_rate=na_rate, seed=0)
    again.rng.bit_generator.state = state
    assert all(np.array_equal(x, y) for x, y in zip(ours.sample_batch(), again.sample_batch()))
    check_sampler_backend("python")
    check_sampler_backend("native")
    native = make_index_sampler(sizes, 3, 2, 2, batch_size=3, na_rate=na_rate, seed=11,
                                backend="native")
    try:
        sup, qry, lab = native.sample_batch()
    finally:
        native.close()
    assert sup.shape == (3, 3, 2) and qry.shape == lab.shape == (3, (3 + na_rate) * 2)
    assert set(np.unique(lab)) <= set(range(3 + (na_rate > 0)))
    with pytest.raises(ValueError, match="unknown sampler"):
        check_sampler_backend("cpp")


def _live_batch(table, sup_i, qry_i, label):
    idx = np.arange(L)

    def side(i):
        out = {k: table[k][i] for k in ("word", "mask")}
        for key in ("pos1", "pos2"):
            out[key] = (table[key][i][..., None] + idx).astype(np.int16)
        return out

    return side(sup_i), side(qry_i), label


def test_cached_step_equals_live_step(world):
    arrays, sizes = tokenize_dataset(world["ds"], world["tok"])
    cfg = ExperimentConfig(**SMALL, token_cache=True)
    sampler = IndexEpisodeSampler(sizes, 3, 2, 2, batch_size=2, seed=2)
    batches = [tuple(sampler.sample_batch()) for _ in range(3)]
    cached, live = build_model(cfg, device="cpu"), build_model(cfg, device="cpu")
    opt_c, opt_l = make_optimizer(cfg, cached), make_optimizer(cfg, live)
    step = make_train_step(cached, opt_c, cfg, source=TokenTable(arrays, sizes, "cpu"))
    for b in batches:
        mc = step(*b)
        ml = train_step(live, opt_l, cfg, *_live_batch(arrays, *b))
        assert all(torch.equal(mc[k], ml[k]) for k in ml)
    for (n, a), b in zip(cached.state_dict().items(), live.state_dict().values()):
        assert torch.equal(a, b), n


def test_fused_cached_eval_equals_per_batch(world):
    arrays, sizes = tokenize_dataset(world["ds"], world["tok"])
    cfg = ExperimentConfig(**{**SMALL, "na_rate": 1}, token_cache=True)
    model = build_model(cfg, device="cpu")
    table = TokenTable(arrays, sizes, "cpu")
    sampler = IndexEpisodeSampler(sizes, 3, 2, 2, batch_size=2, na_rate=1, seed=9)
    batches = [tuple(sampler.sample_batch()) for _ in range(4)]
    single = make_eval_step(model, cfg, source=table)
    fused = make_multi_eval_step(model, cfg, source=table)(*stack_batches(batches))
    for i, b in enumerate(batches):
        one = single(*b)
        for k in one:
            assert torch.equal(fused[k][i], one[k]), k


def test_register_tokens_matches_jax_registry(world):
    """Offset-form rows of the token cache: the port's class vectors vs the
    JAX registry's on the same weights (1e-5), and ``register_tokens`` ==
    ``register`` on the raw sentences (bitwise)."""
    jcfg = JaxConfig(**{k: v for k, v in SMALL.items() if k != "train_n"},
                     lstm_backend="scan", attn_backend="xla")
    jmodel = jax_build_model(jcfg)
    zeros = zero_batch(L, (1, 1, 1))
    params = jax.jit(jmodel.init)(jax.random.key(3), zeros,
                                  {k: v[:, 0] for k, v in zeros.items()})["params"]
    model = build_model(ExperimentConfig(**SMALL), device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    table, sizes = tokenize_dataset(world["ds"], world["tok"])
    jtable, _ = jax_tokenize(world["jds"], world["jtok"])
    starts = np.concatenate([[0], np.cumsum(sizes)])
    reg = TenantRegistry(model, world["tok"], k=2, tiers=None)
    raw = TenantRegistry(model, world["tok"], k=2, tiers=None)
    jreg = JaxRegistry(jmodel, {"params": params}, world["jtok"], k=2, tiers=None)
    for ci, rel in enumerate(world["ds"].rel_names[:3]):
        rows = [{k: v[starts[ci] + r] for k, v in table.items()} for r in range(2)]
        jrows = [{k: v[starts[ci] + r] for k, v in jtable.items()} for r in range(2)]
        got = reg.register_tokens(rel, rows)
        want = jreg.register_tokens(rel, jrows)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert np.array_equal(raw.register(rel, world["ds"].instances[rel][:2]), got)
    assert reg.snapshot().names == jreg.snapshot().names
