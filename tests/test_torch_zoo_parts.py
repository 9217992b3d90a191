"""The zoo's parts in the port: interop, fresh weights, shared ops (CPU).

* ``interop`` carries every zoo tree (each model over each encoder) both
  ways bitwise: a tree of the JAX init's paths, shapes and dtypes goes to
  a ``state_dict`` that loads strictly into the port's model, and back; an
  unknown leaf raises in either direction.
* Fresh weights follow flax's initializers at the flagship widths: Dense
  and Conv kernels truncated lecun-normal with flax's fan-in (times the
  receptive field for a conv), biases zeros, LayerNorm ones and zeros,
  the transformer's ``pos_embedding`` an untruncated normal(0.02),
  ``metric_w`` and ``meta_a*`` ones, ``metric_v``/``metric_b`` and
  ``meta_b*`` zeros, ``w_slow`` lecun-normal.
* gnn's one-hot and broadcast adjacency forms give the same adjacency
  and gradients, and both equal the JAX module's forms on the same weights.
* ``masked_max``'s gradient splits ties evenly, as ``jax.grad`` of
  ``jnp.max`` does; a fully masked row gives the -1e30 pad; ``masked_mean``
  divides by the count plus 1e-13.
* ``FewShotModel.encode`` takes offset-form positions on the batch-major
  route (CNN, transformer) as on the time-major one.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu.models.gnn import _AdjacencyMLP as JaxAdjacency
from induction_network_on_fewrel_tpu.ops import core as jax_core
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.interop import params_from_jax, params_to_jax
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.models.embedding import TRUNC_STD
from induction_network_on_fewrel_tpu_torch.models.gnn import _AdjacencyMLP
from induction_network_on_fewrel_tpu_torch.models.layers import Conv, Dense, LayerNorm
from induction_network_on_fewrel_tpu_torch.ops.core import masked_max, masked_mean

MODELS = ("proto", "proto_hatt", "siamese", "gnn", "snail", "metanet")
ENCODERS = ("cnn", "bilstm", "transformer")
SMALL = dict(vocab_size=40, max_length=16, train_n=4, n=4, k=2, q=3, batch_size=2,
             hidden_size=24, gnn_dim=8, gnn_adj_hidden=8, snail_tc_filters=8, lstm_hidden=8,
             att_dim=4, tfm_layers=2, tfm_model=16, tfm_heads=2, tfm_ff=24)
BOUND = 2.0 / TRUNC_STD          # max |w| / std of a flax truncated-normal draw


def _init_shapes(cfg: dict):
    jmodel = jax_build_model(JaxConfig(**cfg, lstm_backend="scan", attn_backend="xla"))
    zeros = {k: np.zeros((1, cfg["n"], cfg["k"], cfg["max_length"]), np.int32)
             for k in ("word", "pos1", "pos2", "mask")}
    return jax.eval_shape(jmodel.init, jax.random.key(0), zeros,
                          {k: v[:, 0] for k, v in zeros.items()})["params"]


@pytest.mark.parametrize("encoder", ENCODERS)
@pytest.mark.parametrize("model", MODELS)
def test_interop_round_trip_bitwise_for_every_tree(model, encoder):
    cfg = dict(SMALL, model=model, encoder=encoder, na_rate=1, nota_head="stats")
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(s.dtype), _init_shapes(cfg))
    sd = params_from_jax(tree)
    tmodel = build_model(ExperimentConfig(**cfg), device="cpu")
    tmodel.load_state_dict(sd, strict=True)       # every name and shape of the port's model
    back = params_to_jax(tmodel.state_dict())
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    back_flat = dict((jax.tree_util.keystr(p), x)
                     for p, x in jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(back_flat) == len(flat) == len(sd)
    for path, want in flat:
        got = back_flat[jax.tree_util.keystr(path)]
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=jax.tree_util.keystr(path))
    again = params_from_jax(back)
    for name, t in tmodel.state_dict().items():
        assert torch.equal(again[name], t), name


@pytest.mark.parametrize("tree", [
    {"Conv_3": {"kernel": np.zeros((2, 1, 1, 4))}},
    {"encoder": {"Dense_0": {"kernel": np.zeros((2, 2))}}},
    {"adj_0": {"Dense_3": {"bias": np.zeros(2)}}},
    {"tc_1": {"cc_0": {"filter": {"scale": np.zeros(2)}}}},
])
def test_interop_refuses_unknown_zoo_leaves(tree):
    with pytest.raises(KeyError, match="without a torch counterpart"):
        params_from_jax(tree)
    name = ".".join(jax.tree_util.keystr(p).replace("['", "").replace("']", ".").strip(".")
                    for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0])
    with pytest.raises(KeyError, match="without a JAX counterpart"):
        params_to_jax({name.replace("kernel", "weight"): torch.zeros(2)})


def _expected_init(model: torch.nn.Module):
    """parameter name -> ("truncated", std) | ("normal", std) | ("const", value)."""
    out = {}
    for mname, mod in model.named_modules():
        prefix = mname + "." if mname else ""
        if isinstance(mod, (Dense, Conv)):
            out[prefix + "weight"] = ("truncated", 1.0 / math.sqrt(mod.weight[0].numel()))
            out[prefix + "bias"] = ("const", 0.0)
        elif isinstance(mod, LayerNorm):
            out[prefix + "scale"] = ("const", 1.0)
            out[prefix + "bias"] = ("const", 0.0)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "pos_embedding":
            out[name] = ("normal", 0.02)
        elif leaf in ("metric_w", "meta_a1", "meta_a2"):
            out[name] = ("const", 1.0)
        elif leaf in ("metric_v", "metric_b", "meta_b1", "meta_b2"):
            out[name] = ("const", 0.0)
        elif leaf == "w_slow":
            out[name] = ("truncated", 1.0 / math.sqrt(p.shape[0]))
    return out


@pytest.mark.parametrize("model,encoder", [(m, "cnn") for m in MODELS]
                         + [("proto", "transformer")])
def test_fresh_params_follow_flax_initializers(model, encoder):
    """At the flagship widths (CNN 230 filters, transformer 4 x 256, ff
    1024, 5-way 5-shot): the mean, std and truncation of every draw."""
    tmodel = build_model(ExperimentConfig(vocab_size=40, model=model, encoder=encoder),
                         device="cpu")
    want = _expected_init(tmodel)
    params = dict(tmodel.named_parameters())
    zoo = [n for n in params if not n.startswith(("embedding.", "nota"))]
    assert set(zoo) <= set(want), sorted(set(zoo) - set(want))
    for name in zoo:
        kind, val = want[name]
        w = params[name].detach().double()
        if kind == "const":
            assert torch.equal(w, torch.full_like(w, val)), name
            continue
        if kind == "truncated":
            assert float(w.abs().max()) <= BOUND * val * (1 + 1e-6), name
        if w.numel() >= 10_000:             # enough draws for a 3 % std bar
            assert abs(float(w.std()) / val - 1.0) < 0.03, name
            assert abs(float(w.mean())) < 0.03 * val, name
            if kind == "truncated":         # reaches the cut, as flax does
                assert float(w.abs().max()) > 0.95 * BOUND * val, name
            else:                           # not truncated: draws beyond the cut
                assert float(w.abs().max()) > BOUND * val, name


def test_gnn_adjacency_forms_equal_and_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 7, 10)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    onehot = _AdjacencyMLP(10, 8, torch.float32, device="cpu", generator=gen)
    bcast = _AdjacencyMLP(10, 8, torch.float32, one_hot_max_t=4, device="cpu", generator=gen)
    bcast.load_state_dict(onehot.state_dict())
    outs, grads = [], []
    for mod in (onehot, bcast):
        xt = torch.from_numpy(x).requires_grad_()
        a = mod(xt)
        (a * torch.from_numpy(np.arange(a.numel(), dtype=np.float32).reshape(a.shape))).sum() \
            .backward()
        outs.append(a.detach().numpy())
        grads.append([xt.grad.numpy()] + [p.grad.numpy() for p in mod.parameters()])
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)
    gscale = max(np.abs(g).max() for g in grads[0])     # the last bias's is noise: softmax
    for g1, g2 in zip(*grads):
        np.testing.assert_allclose(g1, g2, rtol=1e-5, atol=1e-5 * gscale)
    for a in outs:
        np.testing.assert_allclose(a.sum(-1), 1.0, rtol=1e-5)
        assert np.abs(a[:, np.arange(7), np.arange(7)]).max() < 1e-6
    params = params_to_jax({"adj_0." + k: v for k, v in onehot.state_dict().items()})["adj_0"]
    for limit in (64, 4):
        want = JaxAdjacency(hidden=8, compute_dtype=jnp.float32, one_hot_max_t=limit).apply(
            {"params": params}, jnp.asarray(x))
        np.testing.assert_allclose(outs[0], np.asarray(want), rtol=1e-5, atol=1e-6)


def test_masked_max_splits_tie_gradients_like_jnp_max():
    x = np.array([[1.0, 3.0, 3.0, 2.0], [5.0, 5.0, 5.0, 9.0], [0.0, 0.0, 4.0, 4.0]], np.float32)
    mask = np.array([[1, 1, 1, 1], [1, 1, 1, 0], [1, 1, 0, 0]], np.int8)
    w = np.array([1.0, 2.0, 3.0], np.float32)
    want = jax.grad(lambda v: jnp.sum(jax_core.masked_max(v, mask, axis=1) * w))(x)
    xt = torch.from_numpy(x).requires_grad_()
    (masked_max(xt, torch.from_numpy(mask), dim=1) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    assert xt.grad[0].tolist() == [0.0, 0.5, 0.5, 0.0]       # the tie, split evenly
    assert xt.grad[1].tolist() == pytest.approx([2 / 3] * 3 + [0.0])


def test_masked_pad_value_and_mean_epsilon():
    x = np.arange(12, dtype=np.float32).reshape(3, 4) - 5.0
    mask = np.array([[0, 0, 0, 0], [1, 1, 0, 0], [1, 1, 1, 1]], np.int8)
    got_max = masked_max(torch.from_numpy(x), torch.from_numpy(mask), dim=1)
    np.testing.assert_array_equal(got_max.numpy(), np.asarray(jax_core.masked_max(x, mask, 1)))
    assert float(got_max[0]) == np.float32(-1e30)             # a fully masked row
    got_mean = masked_mean(torch.from_numpy(x), torch.from_numpy(mask), dim=1)
    np.testing.assert_array_equal(got_mean.numpy(), np.asarray(jax_core.masked_mean(x, mask, 1)))
    assert float(got_mean[0]) == 0.0                          # 0 / (0 + 1e-13)
    assert float(got_mean[1]) == np.float32((x[1, 0] + x[1, 1]) / (2 + 1e-13))


@pytest.mark.parametrize("encoder", ENCODERS)
def test_offset_form_positions_on_both_routes(encoder):
    cfg = ExperimentConfig(**dict(SMALL, model="proto", encoder=encoder))
    tmodel = build_model(cfg, device="cpu")
    assert getattr(tmodel.encoder, "wants_time_major", False) == (encoder == "bilstm")
    g = torch.Generator().manual_seed(0)
    L = cfg.max_length
    word = torch.randint(0, cfg.vocab_size, (2, 3, L), generator=g)
    mask = (torch.arange(L) < torch.randint(1, L + 1, (2, 3, 1), generator=g)).to(torch.int8)
    off = torch.randint(1, L + 1, (2, 3), generator=g)
    full = off[..., None] + torch.arange(L)
    with torch.no_grad():
        want = tmodel.encode(word, full, full, mask)
        assert want.shape == (2, 3, tmodel.encoder.output_dim)
        for pos1, pos2 in ((off, full), (full, off), (off, off)):
            assert torch.equal(tmodel.encode(word, pos1, pos2, mask), want)


def test_snail_refuses_an_episode_of_another_depth():
    """snail's TC blocks hold ceil(log2 T) convolutions for the T = n·k + 1
    it was built for; an episode that needs another count is refused by
    name (the JAX model has no parameters for it either)."""
    cfg = ExperimentConfig(**dict(SMALL, model="snail", encoder="cnn", n=3, train_n=3, k=2))
    tmodel = build_model(cfg, device="cpu")
    assert tmodel.tc_1.depth == 3                               # T = 7
    g = torch.Generator().manual_seed(0)

    def tokens(lead):
        ids = torch.randint(0, cfg.vocab_size, lead + (cfg.max_length,), generator=g)
        return {"word": ids, "pos1": ids % 8, "pos2": ids % 8, "mask": torch.ones_like(ids)}

    with torch.no_grad():
        assert tmodel(tokens((1, 3, 2)), tokens((1, 3))).shape == (1, 3, 3)
        with pytest.raises(ValueError, match=r"snail was built for 3 .* \(T=16\) needs 4"):
            tmodel(tokens((1, 3, 5)), tokens((1, 3)))
