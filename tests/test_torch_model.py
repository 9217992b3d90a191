"""Torch port model vs the JAX model on the same weights (CPU, small widths).

The JAX model's ``init`` params are carried into the port with
``interop.params_from_jax``; the same numpy token batches go through both.
f32 agrees within 1e-5 (encoder, class_vectors, score_queries with and
without an int8 dequant scale, the full episode forward, both NOTA
heads); bf16 agrees within the kernel band against the JAX kernels in
interpret mode. The interop round trip is bitwise in both directions.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.interop import (
    PARAM_MAP,
    params_from_jax,
    params_to_jax,
)
from induction_network_on_fewrel_tpu_torch.models.base import to_device
from induction_network_on_fewrel_tpu_torch.models.build import build_model

SMALL = dict(
    vocab_size=60, max_length=12, word_dim=10, pos_dim=2, lstm_hidden=16,
    att_dim=8, induction_dim=12, ntn_slices=6, routing_iters=3,
)
B, N, K, TQ, L = 2, 3, 2, 4, 12   # 12 support + 8 query = 20 encoder rows
F32 = 1e-5
BF16_BAND = 5e-2                  # the tests/test_attn.py bf16 band


def _tokens(rng, lead):
    word = rng.integers(0, SMALL["vocab_size"], lead + (L,)).astype(np.int32)
    pos1 = rng.integers(0, 2 * L, lead + (L,)).astype(np.int16)
    pos2 = rng.integers(0, 2 * L, lead + (L,)).astype(np.int16)
    lengths = rng.integers(1, L + 1, lead)
    mask = (np.arange(L) < lengths[..., None]).astype(np.int8)
    return {"word": word, "pos1": pos1, "pos2": pos2, "mask": mask}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    return _tokens(rng, (B, N, K)), _tokens(rng, (B, TQ))


_PAIRS: dict = {}


def _pair(nota_head="scalar", na_rate=1, compute="float32", jax_kernels=False):
    """(jax apply fn, jax params, port model on the same weights), cached
    per configuration so each JAX program compiles once per module."""
    key = (nota_head, na_rate, compute, jax_kernels)
    if key not in _PAIRS:
        shared = dict(SMALL, na_rate=na_rate, nota_head=nota_head, compute_dtype=compute)
        jcfg = JaxConfig(**shared, lstm_backend="scan", attn_backend="xla")
        zeros = {k: np.zeros((1, 1, 1, L), np.int32) for k in ("word", "pos1", "pos2", "mask")}
        params = jax.jit(jax_build_model(jcfg).init)(
            jax.random.key(3), zeros, {k: v[:, 0] for k, v in zeros.items()}
        )["params"]
        # Nonzero NOTA params, so the NOTA head's arithmetic is exercised.
        for name, val in (("nota_logit", [0.3]), ("nota_stats_w", [0.5, -0.2, 1.5]),
                          ("nota_stats_b", [0.1])):
            if name in params:
                params[name] = jnp.asarray(val, jnp.float32)
        if jax_kernels:
            jcfg = jcfg.replace(lstm_backend="interpret", attn_backend="interpret")
        jmodel = jax_build_model(jcfg)
        apply = jax.jit(jmodel.apply, static_argnames="method")
        tmodel = build_model(ExperimentConfig(**shared), device="cpu")
        tmodel.load_state_dict(params_from_jax(params))
        _PAIRS[key] = (apply, params, tmodel)
    return _PAIRS[key]


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


@pytest.mark.parametrize("nota_head", ["scalar", "stats"])
def test_forward_class_vectors_score_queries_f32(batch, nota_head):
    sup, qry = batch
    apply, params, tmodel = _pair(nota_head)
    v = {"params": params}
    sup_t, qry_t = to_device(sup, "cpu"), to_device(qry, "cpu")
    with torch.inference_mode():
        _close(tmodel(sup_t, qry_t), apply(v, sup, qry), F32)
        cv = tmodel.class_vectors(sup_t)
        jcv = apply(v, sup, method="class_vectors")
        _close(cv, jcv, F32)
        logits = tmodel.score_queries(cv, qry_t)
        assert logits.shape == (B, TQ, N + 1) and logits.dtype == torch.float32
        _close(logits, apply(v, jcv, qry, method="score_queries"), F32)


def test_score_queries_int8_scale(batch):
    sup, qry = batch
    apply, params, tmodel = _pair("scalar")
    v = {"params": params}
    jcv = np.asarray(apply(v, sup, method="class_vectors"))
    scale = np.float32(np.abs(jcv).max() / 127.0)
    q8 = np.clip(np.rint(jcv / scale), -127, 127).astype(np.int8)
    want = apply(v, jnp.asarray(q8), qry, jnp.float32(scale), method="score_queries")
    with torch.inference_mode():
        got = tmodel.score_queries(torch.from_numpy(q8), to_device(qry, "cpu"),
                                   torch.tensor(scale))
    _close(got, want, F32)


def test_encoder_f32_and_no_nota(batch):
    sup, _ = batch
    apply, params, tmodel = _pair(na_rate=0)
    assert not any(n.startswith("nota") for n in params)
    want = apply({"params": params}, sup["word"], sup["pos1"], sup["pos2"],
                        sup["mask"], method="encode")
    with torch.inference_mode():
        s = to_device(sup, "cpu")
        got = tmodel.encode(s["word"], s["pos1"], s["pos2"], s["mask"])
    assert got.shape == (B, N, K, 2 * SMALL["lstm_hidden"])
    _close(got, want, F32)


def test_bf16_encoder_matches_jax_kernels(batch):
    """bf16 encoder (embedding rounded to bf16, kernel dtype placement) vs
    the JAX model running its Pallas kernels in interpret mode."""
    sup, qry = batch
    apply, params, tmodel = _pair("scalar", compute="bfloat16", jax_kernels=True)
    v = {"params": params}
    jcv = apply(v, sup, method="class_vectors")
    with torch.inference_mode():
        cv = tmodel.class_vectors(to_device(sup, "cpu"))
        _close(cv, jcv, BF16_BAND)
        _close(tmodel.score_queries(cv, to_device(qry, "cpu")),
               apply(v, jcv, qry, method="score_queries"), BF16_BAND)


@pytest.mark.parametrize("nota_head", ["scalar", "stats", "none"])
def test_interop_round_trip_bitwise(nota_head):
    na_rate = 0 if nota_head == "none" else 1
    apply, params, tmodel = _pair("scalar" if na_rate == 0 else nota_head, na_rate=na_rate)
    flat = {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }
    sd = params_from_jax(params)
    # Every JAX leaf maps exactly once, onto every port parameter.
    assert len(sd) == len(flat) == len(set(sd))
    assert set(sd) == set(tmodel.state_dict())
    back = params_to_jax(sd)
    back_flat = {
        "/".join(str(getattr(k, "key", k)) for k in path): leaf
        for path, leaf in jax.tree_util.tree_flatten_with_path(back)[0]
    }
    assert set(back_flat) == set(flat)
    for name, arr in flat.items():
        assert back_flat[name].dtype == arr.dtype
        np.testing.assert_array_equal(back_flat[name], arr, err_msg=name)
    # port -> JAX -> port
    sd0 = {k: v.clone() for k, v in tmodel.state_dict().items()}
    sd1 = params_from_jax(params_to_jax(sd0))
    for name, t in sd0.items():
        assert torch.equal(sd1[name], t), name


def test_interop_refuses_unknown_leaves():
    with pytest.raises(KeyError, match="without a torch counterpart"):
        params_from_jax({"encoder": {"Dense_0": {"kernel": np.zeros((2, 2))}}})
    with pytest.raises(KeyError, match="without a JAX counterpart"):
        params_to_jax({"encoder.att.weight": torch.zeros(2)})
    assert len({name for _, name, _ in PARAM_MAP}) == len(PARAM_MAP)


@pytest.mark.parametrize("kw", [{"model": "pair", "encoder": "bert"}, {"encoder": "bert"}],
                         ids=["pair", "bert"])
def test_build_model_builds_pair_and_bert(kw):
    """BERT-PAIR and the BERT encoder, refused before their slice, build:
    BERT-PAIR owns its backbone, the induction head's BERT sits behind the
    passthrough embedding (parity with JAX: tests/test_torch_bert.py,
    tests/test_torch_pair.py)."""
    model = build_model(ExperimentConfig(vocab_size=12, bert_layers=1, bert_hidden=16,
                                         bert_heads=2, bert_intermediate=32, bert_vocab_size=100,
                                         **kw), device="cpu")
    names = [n for n, _ in model.named_parameters()]
    prefix = "backbone." if kw.get("model") == "pair" else "encoder.backbone."
    assert f"{prefix}tok_emb.embedding" in names and not any("word_embedding" in n for n in names)
    assert model.device == torch.device("cpu")


@pytest.mark.parametrize("kw,named", [
    ({"encoder": "bilstm", "moe_experts": 4}, "--moe_experts requires --encoder transformer"),
    ({"encoder": "cnn", "tfm_stacked": True}, "--tfm_stacked requires --encoder transformer"),
], ids=["moe", "stacked"])
def test_build_model_refuses_other_models_and_encoders(kw, named):
    """The transformer's MoE and stacked layouts, which build since they were
    ported (tests/test_torch_moe.py, tests/test_torch_stacked.py), are
    refused by name over another encoder, which would silently train
    without them (the JAX ``build.py:159-182``), before any parameter is
    made."""
    with pytest.raises(ValueError, match=named):
        build_model(ExperimentConfig(vocab_size=12, **kw), device="cpu")


def test_offset_form_positions_refused(batch):
    """Offset-form positions (the token cache's per-sentence offsets, one
    rank below ``word``) are no longer refused: they encode bitwise like
    the per-token ids ``off + l`` they stand for, pos1 and pos2 each."""
    sup, _ = batch
    _, _, tmodel = _pair()
    s = to_device(sup, "cpu")
    off = torch.randint(1, L + 1, s["word"].shape[:-1], generator=torch.Generator().manual_seed(0))
    full = off[..., None] + torch.arange(L)
    with torch.no_grad():
        want = tmodel.encode(s["word"], full, full, s["mask"])
        for pos1, pos2 in ((off, full), (full, off), (off, off)):
            assert torch.equal(tmodel.encode(s["word"], pos1, pos2, s["mask"]), want)
