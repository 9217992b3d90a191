"""The port's model zoo vs the JAX package's, forward and backward (CPU).

Every few-shot model (proto, proto_hatt, siamese, gnn, snail, metanet)
over every encoder (cnn, bilstm, transformer) at the small config of the
JAX package's ``tests/test_model_zoo.py`` (L=16, CNN hidden 64, N=4, K=2,
Q=3, B=2; narrow BiLSTM and transformer widths). The port's fresh weights
go to the JAX model through ``interop.params_to_jax`` (whose tree must be
the JAX init tree, leaf for leaf), the same numpy token batch goes
through both, and the loss ``Σ logits ⊙ R`` (R a fixed random array)
through ``jax.value_and_grad`` and autograd:

* f32: the logits within 1e-5 of their scale; every parameter's gradient
  elementwise within rtol 1e-5 plus 1e-5 of its own scale. A leaf whose
  JAX gradient lies below 1e-6 of the largest element over all leaves
  (``NOISE_LEAF``) holds rounding noise alone: a head's symmetry makes it
  zero (a softmax's shared shift: gnn's ``adj_*/Dense_2/bias``, snail's
  ``att_*/k/bias``, the transformer's ``ln_final/bias`` under proto,
  siamese and metanet). Such a leaf is held to rounding level on the
  port's side too, within 1e-5 of the largest element. The JAX BiLSTM
  runs its scan and two-pass attention, the port its plain versions.
* bf16: the logits within the 5e-2 band of ``tests/test_torch_model.py``,
  of their scale, against the JAX Pallas kernels in interpret mode.
* the NOTA heads (scalar, stats) with nonzero NOTA parameters, f32.

Interop, fresh weights and the shared ops are in
``tests/test_torch_zoo_parts.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.interop import params_to_jax
from induction_network_on_fewrel_tpu_torch.models.base import to_device
from induction_network_on_fewrel_tpu_torch.models.build import build_model

L, B, N, K, Q = 16, 2, 4, 2, 3
SMALL = dict(
    vocab_size=302, max_length=L, train_n=N, n=N, k=K, q=Q, batch_size=B, hidden_size=64,
    gnn_dim=16, gnn_adj_hidden=16, snail_tc_filters=16, lstm_hidden=16, att_dim=8,
    tfm_layers=2, tfm_model=32, tfm_heads=2, tfm_ff=64,
)
MODELS = ("proto", "proto_hatt", "siamese", "gnn", "snail", "metanet")
ENCODERS = ("cnn", "bilstm", "transformer")
F32 = 1e-5
NOISE_LEAF = 1e-6
BF16_BAND = 5e-2
NOTA_VALUES = {"nota_logit": [0.3], "nota_stats_w": [0.5, -0.2, 1.5], "nota_stats_b": [0.1]}


def _tokens(rng, lead):
    word = rng.integers(0, SMALL["vocab_size"], lead + (L,)).astype(np.int32)
    pos1 = rng.integers(0, 2 * L, lead + (L,)).astype(np.int16)
    pos2 = rng.integers(0, 2 * L, lead + (L,)).astype(np.int16)
    lengths = rng.integers(1, L + 1, lead)
    mask = (np.arange(L) < lengths[..., None]).astype(np.int8)
    return {"word": word, "pos1": pos1, "pos2": pos2, "mask": mask}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    return _tokens(rng, (B, N, K)), _tokens(rng, (B, N * Q))


def _pair(model, encoder, compute="float32", na_rate=0, nota_head="scalar"):
    """(JAX model, JAX params, port model): the port's fresh weights (and
    nonzero NOTA parameters) in both, the JAX tree checked against the
    JAX init tree's paths, shapes and dtypes."""
    kw = dict(SMALL, model=model, encoder=encoder, compute_dtype=compute, na_rate=na_rate,
              nota_head=nota_head)
    backends = ({"lstm_backend": "scan", "attn_backend": "xla"} if compute == "float32"
                else {"lstm_backend": "interpret", "attn_backend": "interpret"})
    tmodel = build_model(ExperimentConfig(**kw, seed=3), device="cpu")
    with torch.no_grad():
        for name, val in NOTA_VALUES.items():
            if hasattr(tmodel, name):
                getattr(tmodel, name).copy_(torch.tensor(val))
    jmodel = jax_build_model(JaxConfig(**kw, **backends))
    params = params_to_jax(tmodel.state_dict())
    zeros = {k: np.zeros((1, N, K, L), np.int32) for k in ("word", "pos1", "pos2", "mask")}
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), zeros,
                            {k: v[:, 0] for k, v in zeros.items()})["params"]
    want = {jax.tree_util.keystr(p): (tuple(x.shape), x.dtype)
            for p, x in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {jax.tree_util.keystr(p): (tuple(x.shape), x.dtype)
           for p, x in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert got == want
    return jmodel, params, tmodel


def _weights(shape):
    return np.random.default_rng(5).normal(size=shape).astype(np.float32)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("encoder", ENCODERS)
@pytest.mark.parametrize("model", MODELS)
def test_f32_logits_and_every_gradient_match_jax(batch, model, encoder):
    sup, qry = batch
    jmodel, params, tmodel = _pair(model, encoder)
    R = _weights((B, N * Q, N))

    def loss(p):
        logits = jmodel.apply({"params": p}, sup, qry)
        return jnp.sum(logits * R), logits

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    logits = tmodel(to_device(sup, "cpu"), to_device(qry, "cpu"))
    assert logits.shape == (B, N * Q, N) and logits.dtype == torch.float32
    (logits * torch.from_numpy(R)).sum().backward()
    _close(logits.detach().numpy(), jlogits, F32)

    tgrads = params_to_jax({n: p.grad for n, p in tmodel.named_parameters()})
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(jgrads))[0]
    gscale = max(float(np.abs(g).max()) for _, g in flat)
    assert gscale > 0
    for path, want in flat:
        got = tgrads
        for k in path:
            got = got[k.key]
        name = jax.tree_util.keystr(path)
        scale = float(np.abs(want).max())
        if scale < NOISE_LEAF * gscale:
            assert float(np.abs(np.asarray(got)).max()) <= F32 * gscale, name
            continue
        np.testing.assert_allclose(got, want, rtol=F32, atol=F32 * scale, err_msg=name)


@pytest.mark.parametrize("encoder", ENCODERS)
@pytest.mark.parametrize("model", MODELS)
def test_bf16_logits_within_the_band(batch, model, encoder):
    sup, qry = batch
    jmodel, params, tmodel = _pair(model, encoder, compute="bfloat16")
    want = jax.jit(jmodel.apply)({"params": params}, sup, qry)
    with torch.inference_mode():
        got = tmodel(to_device(sup, "cpu"), to_device(qry, "cpu"))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    _close(got.numpy(), want, BF16_BAND)


@pytest.mark.parametrize("nota_head", ["scalar", "stats"])
@pytest.mark.parametrize("model", MODELS)
def test_nota_heads_match_jax(batch, model, nota_head):
    sup, qry = batch
    jmodel, params, tmodel = _pair(model, "cnn", na_rate=1, nota_head=nota_head)
    want = jax.jit(jmodel.apply)({"params": params}, sup, qry)
    with torch.inference_mode():
        got = tmodel(to_device(sup, "cpu"), to_device(qry, "cpu"))
    assert got.shape == (B, N * Q, N + 1)
    _close(got.numpy(), want, F32)
