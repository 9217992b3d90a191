"""The layer-stacked transformer on one card (pp=1): the port against the JAX package (CPU).

* ``PipelinedTransformerEncoder`` (2 layers, d 32) against the JAX
  encoder on its flax init (``stack_*`` leaves carried by
  ``interop.params_from_jax``, and back, bitwise): the forward and the
  gradients of ``Σ out ⊙ R`` for the input and every leaf, f32 within
  1e-5 of each one's scale, bf16 within the 5e-2 band of
  ``tests/test_torch_model.py``.
* Fresh stacked kernels are an untruncated normal(1/sqrt(fan_in)).
* A 20-step trajectory of induction over the stacked transformer against
  JAX ``make_train_step``: losses rtol 2e-4, the final parameters atol
  1e-3.
* Refused by name: the stacked layout with MoE (``build_model`` and the
  CLI) and ``--pp 2`` over layers that do not divide into its stages (the
  JAX text; ``--pp`` runs since, ``tests/test_torch_pp.py``).
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.data import GloveTokenizer as JaxTokenizer
from induction_network_on_fewrel_tpu.data import make_synthetic_fewrel as jax_fewrel
from induction_network_on_fewrel_tpu.data import make_synthetic_glove as jax_glove
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu.models.build import batch_to_model_inputs as jax_inputs
from induction_network_on_fewrel_tpu.models.pipeline_transformer import (
    PipelinedTransformerEncoder as JaxStacked,
)
from induction_network_on_fewrel_tpu.sampling.episodes import EpisodeSampler as JaxSampler
from induction_network_on_fewrel_tpu.train.steps import init_state, make_train_step
from induction_network_on_fewrel_tpu_torch import cli
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.interop import params_from_jax, params_to_jax
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.models.pipeline_transformer import (
    PipelinedTransformerEncoder,
)
from induction_network_on_fewrel_tpu_torch.train.steps import make_optimizer, train_step

M, L, DIN = 4, 10, 12
WIDTHS = dict(num_layers=2, d_model=32, num_heads=2, d_ff=64, max_length=L)
BF16_BAND = 5e-2
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_BAND)}


def _pair(dtype):
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(M, L, DIN)).astype(np.float32)
    mask = (np.arange(L) < np.array([10, 7, 3, 1])[:, None]).astype(np.float32)
    jenc = JaxStacked(**WIDTHS, compute_dtype=jdt)
    params = jenc.init(jax.random.key(0), jnp.asarray(emb), jnp.asarray(mask))
    tenc = PipelinedTransformerEncoder(DIN, num_heads=2, num_layers=2, d_model=32, d_ff=64,
                                       max_length=L, compute_dtype=tdt, device="cpu",
                                       generator=torch.Generator().manual_seed(0))
    sd = params_from_jax({"encoder": jax.device_get(params["params"])})
    assert {k.removeprefix("encoder.") for k in sd} == set(tenc.state_dict())
    tenc.load_state_dict({k.removeprefix("encoder."): v for k, v in sd.items()})
    back = params_to_jax({f"encoder.{k}": v for k, v in tenc.state_dict().items()})["encoder"]
    for path, w in jax.tree_util.tree_flatten_with_path(jax.device_get(params["params"]))[0]:
        g = back
        for k in path:
            g = g[k.key]
        np.testing.assert_array_equal(g, w)
    return jenc, params, tenc, emb, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_forward_and_gradients_match_jax(dtype):
    jenc, params, tenc, emb, mask = _pair(dtype)
    jdt, tdt, tol = DTYPES[dtype]
    R = np.random.default_rng(1).normal(size=(M, 32)).astype(np.float32)

    def f(p, x):
        out = jenc.apply(p, x, jnp.asarray(mask))
        return jnp.sum(out.astype(jnp.float32) * R), out

    (_, jout), (jgp, jgx) = jax.device_get(jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(emb).astype(jdt)))
    tx = torch.tensor(emb).to(tdt).requires_grad_()
    tout = tenc(tx, torch.tensor(mask))
    assert tout.dtype == tdt and tout.shape == (M, 32)
    (tout.float() * torch.tensor(R)).sum().backward()
    want_out = np.asarray(jout, np.float32)
    np.testing.assert_allclose(tout.detach().float().numpy(), want_out, rtol=0,
                               atol=tol * float(np.abs(want_out).max()))
    got = {**params_to_jax({f"encoder.{n}": p.grad for n, p in tenc.named_parameters()})
           ["encoder"], "x": tx.grad.float().numpy()}
    want = {**jgp["params"], "x": np.asarray(jgx, np.float32)}
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for k in path:
            g = g[k.key]
        w = np.asarray(w, np.float32)
        scale = float(np.abs(w).max())
        assert scale > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(g, w, rtol=0 if dtype == "bfloat16" else 1e-5,
                                   atol=tol * scale, err_msg=jax.tree_util.keystr(path))


def test_fresh_stacked_kernels_are_untruncated_normals():
    tenc = PipelinedTransformerEncoder(DIN, num_layers=3, d_model=64, d_ff=256, max_length=L,
                                       device="cpu", generator=torch.Generator().manual_seed(0))
    for name, fan_in in (("qkv_w", 64), ("att_out_w", 64), ("mlp_up_w", 64), ("mlp_down_w", 256)):
        w = getattr(tenc, f"stack_{name}").detach()
        assert w.shape[0] == 3
        assert float(w.std()) == pytest.approx(fan_in ** -0.5, rel=0.03)
        # Untruncated: some draws lie past the truncated normal's 2.27 std.
        assert float(w.abs().max()) > 2.3 * fan_in ** -0.5
    assert bool((tenc.stack_ln1_scale == 1).all()) and not tenc.stack_mlp_up_b.any()
    assert bool((tenc.final_ln_scale == 1).all()) and not tenc.final_ln_bias.any()


TL = 12
TRAJ = dict(vocab_size=302, max_length=TL, train_n=3, n=3, k=2, q=2, batch_size=2,
            encoder="transformer", model="induction", tfm_layers=2, tfm_model=16, tfm_heads=2,
            tfm_ff=32, tfm_stacked=True, induction_dim=8, ntn_slices=4,
            compute_dtype="float32", loss="mse", optimizer="adam", lr=2e-3, weight_decay=1e-4,
            grad_clip=1.0, lr_step_size=7)
STEPS = 20


def test_stacked_trajectory_matches_jax_train_step():
    jcfg = JaxConfig(**TRAJ)
    vocab = jax_glove(jcfg.vocab_size - 2, jcfg.word_dim)
    ds = jax_fewrel(num_relations=6, instances_per_relation=8, vocab_size=jcfg.vocab_size - 2)
    s = JaxSampler(ds, JaxTokenizer(vocab, TL), 3, 2, 2, batch_size=2, seed=7)
    batches = [jax_inputs(s.sample_batch()) for _ in range(STEPS)]
    jmodel = jax_build_model(jcfg)
    state = init_state(jmodel, jcfg, batches[0][0], batches[0][1])
    step = make_train_step(jmodel, jcfg)
    cfg = ExperimentConfig(**TRAJ)
    tmodel = build_model(cfg, device="cpu")
    assert type(tmodel.encoder).__name__ == "PipelinedTransformerEncoder"
    tmodel.load_state_dict(params_from_jax(jax.device_get(state.params["params"])))
    opt = make_optimizer(cfg, tmodel)
    for support, query, label in batches:
        state, jm = step(state, support, query, label)
        tm = train_step(tmodel, opt, cfg, support, query, label)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-4)
    got = params_to_jax(tmodel.state_dict())
    for path, w in jax.tree_util.tree_flatten_with_path(jax.device_get(state.params["params"]))[0]:
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, w, atol=1e-3, err_msg=jax.tree_util.keystr(path))


def test_stacked_with_moe_refused_by_name(capsys):
    with pytest.raises(ValueError, match="--tfm_stacked .* does not compose with MoE"):
        build_model(ExperimentConfig(vocab_size=12, encoder="transformer", tfm_stacked=True,
                                     moe_experts=4), device="cpu")
    with pytest.raises(SystemExit) as e:
        cli.main(["train", "--synthetic", "--device", "cpu", "--encoder", "transformer",
                  "--tfm_stacked", "--moe_experts", "4"])
    assert e.value.code == 2
    assert "does not compose with MoE" in capsys.readouterr().err


@pytest.mark.parametrize("mode", ["train", "test"])
def test_pp_above_one_still_refused_by_name(capsys, mode):
    """``--pp`` runs (``tests/test_torch_pp.py``); over layers that do not
    divide into its stages it is refused with the JAX text."""
    with pytest.raises(SystemExit) as e:
        cli.main([mode, "--synthetic", "--device", "cpu", "--encoder", "transformer",
                  "--tfm_stacked", "--tfm_layers", "3", "--pp", "2", "--load_ckpt", "unused"])
    assert e.value.code == 2
    assert "--tfm_layers (3) must be divisible by --pp (2) pipeline stages" in \
        capsys.readouterr().err
