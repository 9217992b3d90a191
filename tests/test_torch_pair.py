"""The port's BERT-PAIR (``--model pair``) vs the JAX ``PairModel`` (CPU).

At the tiny BERT width of ``tests/test_torch_bert.py`` (2 layers, hidden
32, 4 heads, FFN 64, 500 ids) and L=12: the port's fresh weights go to the
JAX model through ``interop.params_to_jax`` (the JAX init tree, leaf for
leaf: ``backbone/...``, ``match_head``, ``nota_logit``), the same numpy
token episode through both, and ``Σ logits ⊙ R`` through
``jax.value_and_grad`` and autograd:

* f32 logits within 1e-5 of their scale, with and without the NOTA logit
  (set nonzero, appended last); every gradient within 1e-5 of its leaf's
  scale; frozen: no backbone gradient.
* bf16 logits within the repo's 5e-2 band.
* refusals by name: pair without ``--encoder bert``, pair with
  ``--nota_head stats``, pair with ``--feature_cache`` or ``--token_cache``.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu_torch import cli
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.interop import params_to_jax
from induction_network_on_fewrel_tpu_torch.models.base import to_device
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.models.pair import PairModel

L, B, N, K, Q = 12, 2, 3, 2, 1
TINY = dict(encoder="bert", model="pair", bert_layers=2, bert_hidden=32, bert_heads=4,
            bert_intermediate=64, bert_vocab_size=500, max_length=L, train_n=N, n=N, k=K, q=Q,
            batch_size=B)
F32 = 1e-5
BF16_BAND = 5e-2


def _tokens(rng, lead):
    word = rng.integers(16, 500, lead + (L,)).astype(np.int32)
    word[..., 0] = 3
    word[..., 2], word[..., 4] = 1, 2
    lengths = rng.integers(5, L + 1, lead)
    mask = (np.arange(L) < lengths[..., None]).astype(np.int8)
    word[mask == 0] = 0
    zeros = np.zeros(lead + (L,), np.int16)
    return {"word": word, "pos1": zeros, "pos2": zeros.copy(), "mask": mask}


def _episode(na_rate, seed=0):
    rng = np.random.default_rng(seed)
    return _tokens(rng, (B, N, K)), _tokens(rng, (B, (N + na_rate) * Q))


def _models(na_rate=0, compute="float32", frozen=False):
    """(JAX model, JAX params, port model) on the port's fresh weights; the
    NOTA logit set to 0.3."""
    kw = dict(TINY, na_rate=na_rate, compute_dtype=compute, bert_frozen=frozen)
    tmodel = build_model(ExperimentConfig(**kw, seed=2), device="cpu")
    assert isinstance(tmodel, PairModel)
    if na_rate:
        with torch.no_grad():
            tmodel.nota_logit.fill_(0.3)
    jmodel = jax_build_model(JaxConfig(**kw))
    sup, qry = _episode(na_rate)
    init = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.key(0), sup, qry)["params"])
    tree = params_to_jax(tmodel.state_dict())
    flat = lambda t: {p: (v.shape, v.dtype) for p, v in  # noqa: E731
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    assert flat(tree) == flat(init)
    return jmodel, {"params": tree}, tmodel


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("na_rate", [0, 1], ids=["no_nota", "nota"])
def test_logits_and_gradients_match_jax(na_rate):
    jmodel, params, tmodel = _models(na_rate)
    sup, qry = _episode(na_rate, seed=1)
    R = np.random.default_rng(2).standard_normal((B, (N + na_rate) * Q, N + (na_rate > 0)))
    R = R.astype(np.float32)

    def loss(p):
        logits = jmodel.apply(p, sup, qry)
        return jnp.sum(logits * R), logits

    (_, want), jg = jax.value_and_grad(loss, has_aux=True)(params)
    logits = tmodel(to_device(sup, "cpu"), to_device(qry, "cpu"))
    assert logits.dtype == torch.float32 and logits.shape == want.shape
    assert _rel(logits.detach().numpy(), want) < F32
    if na_rate:
        torch.testing.assert_close(logits[..., -1], torch.full_like(logits[..., -1], 0.3))
    (logits * torch.from_numpy(R)).sum().backward()
    grads = params_to_jax({n: p.grad for n, p in tmodel.named_parameters()})
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jg["params"])[0])
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        w = np.asarray(flat_j[path])
        assert np.abs(g - w).max() <= F32 * max(np.abs(w).max(), 1e-30), path


def test_bf16_logits_within_band():
    jmodel, params, tmodel = _models(1, compute="bfloat16")
    sup, qry = _episode(1, seed=3)
    want = np.asarray(jmodel.apply(params, sup, qry))
    with torch.no_grad():
        got = tmodel(to_device(sup, "cpu"), to_device(qry, "cpu"))
    assert _rel(got.numpy(), want) < BF16_BAND


def test_frozen_pair_has_no_backbone_gradient():
    _, _, tmodel = _models(1, frozen=True)
    sup, qry = _episode(1, seed=4)
    tmodel(to_device(sup, "cpu"), to_device(qry, "cpu")).sum().backward()
    for n, p in tmodel.named_parameters():
        assert (p.grad is None) == n.startswith("backbone."), n


@pytest.mark.parametrize("kw,named", [
    ({"encoder": "cnn"}, "--model pair requires --encoder bert"),
    ({"nota_head": "stats", "na_rate": 1}, "--model pair supports only --nota_head scalar"),
    ({"feature_cache": True, "bert_frozen": True}, "--feature_cache cannot serve --model pair"),
], ids=["not_bert", "stats_head", "feature_cache"])
def test_build_refuses_by_name(kw, named):
    with pytest.raises(ValueError, match=named):
        build_model(ExperimentConfig(**{**TINY, **kw}), device="cpu")


@pytest.mark.parametrize("flag,named", [
    ("--token_cache", "--token_cache does not serve --model pair"),
    ("--feature_cache", "--feature_cache cannot serve --model pair"),
])
def test_cli_refuses_pair_with_a_cache(flag, named):
    argv = ["--synthetic", "--device", "cpu", "--model", "pair", "--encoder", "bert",
            "--bert_frozen", flag]
    with pytest.raises(ValueError, match=named):
        cli.train_main(argv)
