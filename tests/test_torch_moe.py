"""The MoE FFN on one card (ep=1): the port against the JAX package (CPU).

* ``MoeFfn`` against flax's at f32, the flax init carried by
  ``interop.params_from_jax``, within 1e-5 of the output's scale: with
  pad tokens, with capacity drops (capacity 0.5), with a padded last group
  (T not a multiple of the group size), at top-k 1 and 2.
* The load-balance value against the one flax sows, and nothing sown or
  computed outside the train step.
* Gradients of ``Σ out ⊙ R + w·aux`` against ``jax.vjp``: the input and
  every parameter, within 1e-5 of each one's scale.
* Fresh experts drawn as flax draws them: ``lecun_normal`` on ``[E, d,
  f]`` counts E as receptive field, std (E·d)^-1/2.
* A 20-step trajectory of induction over the MoE transformer with the
  load-balance term in the objective against JAX ``make_train_step``:
  losses rtol 2e-4, the final parameters atol 1e-3.
* ``--ep 2`` with MoE is ported: it parses and asks the mesh for two ranks
  (``tests/test_torch_moe_dp.py`` runs it on spawned ranks).
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
from induction_network_on_fewrel_tpu.models.moe import MoeFfn as JaxMoe
from induction_network_on_fewrel_tpu.sampling.episodes import EpisodeSampler as JaxSampler
from induction_network_on_fewrel_tpu.train.steps import init_state, make_train_step
from induction_network_on_fewrel_tpu_torch import cli
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.interop import params_from_jax, params_to_jax
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.models.moe import MoeFfn, collect_aux
from induction_network_on_fewrel_tpu_torch.train.steps import (
    aux_weight,
    make_optimizer,
    train_step,
)

D, E, F_ = 16, 4, 32
M, L = 3, 5
# (top_k, capacity factor, group size): no drops, drops, a padded group.
CASES = [(1, 2.0, 512), (2, 0.5, 512), (2, 2.0, 7), (1, 0.5, 4)]
IDS = ["top1", "top2-drops", "top2-group-pad", "top1-drops-group-pad"]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, L, D)).astype(np.float32)
    mask = (np.arange(L) < np.array([5, 3, 1])[:, None]).astype(np.float32)
    return x, mask


def _pair(top_k, cap, group):
    """(flax module, its params, the port's module on them)."""
    x, mask = _inputs()
    jm = JaxMoe(num_experts=E, d_ff=F_, top_k=top_k, capacity_factor=cap, group_size=group)
    params = jm.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(mask))
    assert "losses" not in params          # never sown at init
    tm = MoeFfn(D, E, F_, top_k, cap, group, device="cpu",
                generator=torch.Generator().manual_seed(0))
    sd = params_from_jax({"encoder": {"moe_0": jax.device_get(params["params"])}})
    tm.load_state_dict({k.removeprefix("encoder.moe_0."): v for k, v in sd.items()})
    return jm, params, tm


@pytest.mark.parametrize("top_k,cap,group", CASES, ids=IDS)
def test_moe_forward_and_aux_match_flax(top_k, cap, group):
    jm, params, tm = _pair(top_k, cap, group)
    x, mask = _inputs()
    want, sown = jm.apply(params, jnp.asarray(x), jnp.asarray(mask), mutable="losses")
    (jaux,) = sown["losses"]["moe_aux"]
    with collect_aux(tm) as sink:
        got = tm(torch.tensor(x), torch.tensor(mask))
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5 * scale)
    assert len(sink) == 1
    np.testing.assert_allclose(float(sink[0].detach()), float(jaux), rtol=1e-6)
    drops = float(tm.drop_share)
    assert (drops > 0) == (cap < 1.0), drops
    # Outside collect_aux (eval) nothing is appended and no sink is left set.
    tm(torch.tensor(x), torch.tensor(mask))
    assert tm.aux_sink is None and len(sink) == 1


@pytest.mark.parametrize("top_k,cap,group", CASES, ids=IDS)
def test_moe_gradients_match_jax_vjp(top_k, cap, group):
    jm, params, tm = _pair(top_k, cap, group)
    x, mask = _inputs()
    R = np.random.default_rng(2).normal(size=(M, L, D)).astype(np.float32)
    w = 0.3

    def f(p, xx):
        out, sown = jm.apply(p, xx, jnp.asarray(mask), mutable="losses")
        return jnp.sum(out * R) + w * sown["losses"]["moe_aux"][0]

    jgp, jgx = jax.device_get(jax.jit(jax.grad(f, argnums=(0, 1)))(params, jnp.asarray(x)))
    tx = torch.tensor(x, requires_grad=True)
    with collect_aux(tm) as sink:
        loss = (tm(tx, torch.tensor(mask)) * torch.tensor(R)).sum() + w * sink[0]
    loss.backward()
    got = {**params_to_jax({f"encoder.moe_0.{n}": p.grad for n, p in tm.named_parameters()})
           ["encoder"]["moe_0"], "x": tx.grad.numpy()}
    want = {**jgp["params"], "x": np.asarray(jgx)}
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for k in path:
            g = g[k.key]
        scale = float(np.abs(leaf).max())
        assert scale > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(g, leaf, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=jax.tree_util.keystr(path))


def test_fresh_experts_follow_flax_lecun_normal():
    x = jnp.zeros((1, 4, 256))
    jp = jax.device_get(JaxMoe(num_experts=8, d_ff=1024).init(jax.random.key(0), x)["params"])
    tm = MoeFfn(256, 8, 1024, device="cpu", generator=torch.Generator().manual_seed(0))
    for name, fan_in in (("experts_up", 8 * 256), ("experts_down", 8 * 1024)):
        ours, theirs = float(getattr(tm, name).detach().std()), float(np.std(jp[name]))
        assert ours == pytest.approx(fan_in ** -0.5, rel=0.01)
        assert theirs == pytest.approx(fan_in ** -0.5, rel=0.01)
        assert float(getattr(tm, name).detach().abs().max()) <= 2 * fan_in ** -0.5 / 0.8796 + 1e-6
    router = float(np.std(jp["router"]["kernel"]))
    assert float(tm.router.weight.detach().std()) == pytest.approx(router, rel=0.05)
    assert not tm.experts_up_bias.any() and not tm.experts_down_bias.any()


# --- the trajectory ----------------------------------------------------------------

TL = 12
TRAJ = dict(vocab_size=302, max_length=TL, train_n=3, n=3, k=2, q=2, batch_size=2,
            encoder="transformer", model="induction", tfm_layers=2, tfm_model=16, tfm_heads=2,
            tfm_ff=32, induction_dim=8, ntn_slices=4, moe_experts=4, moe_every=1,
            moe_group_size=64, moe_aux_weight=0.05, compute_dtype="float32", loss="mse",
            optimizer="adam", lr=2e-3, weight_decay=1e-4, grad_clip=1.0, lr_step_size=7)
STEPS = 20


def test_moe_trajectory_matches_jax_train_step():
    jcfg = JaxConfig(**TRAJ)
    vocab = jax_glove(jcfg.vocab_size - 2, jcfg.word_dim)
    ds = jax_fewrel(num_relations=6, instances_per_relation=8, vocab_size=jcfg.vocab_size - 2)
    s = JaxSampler(ds, JaxTokenizer(vocab, TL), 3, 2, 2, batch_size=2, seed=7)
    batches = [jax_inputs(s.sample_batch()) for _ in range(STEPS)]
    jmodel = jax_build_model(jcfg)
    state = init_state(jmodel, jcfg, batches[0][0], batches[0][1])
    step = make_train_step(jmodel, jcfg)
    cfg = ExperimentConfig(**TRAJ)
    assert aux_weight(cfg) == 0.05 and aux_weight(cfg.replace(moe_experts=0)) == 0.0
    tmodel = build_model(cfg, device="cpu")
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


def test_moe_aux_term_moves_the_objective_not_the_metric():
    """The train objective carries ``moe_aux_weight`` times the sown terms;
    the reported loss is the task loss (the JAX ``loss_and_metrics``)."""
    from induction_network_on_fewrel_tpu_torch.models.base import to_device
    from induction_network_on_fewrel_tpu_torch.train.steps import loss_and_metrics

    cfg = ExperimentConfig(**TRAJ)
    tmodel = build_model(cfg, device="cpu")
    rng = np.random.default_rng(0)

    def tok(lead):
        return {"word": rng.integers(0, 300, lead + (TL,)),
                "pos1": rng.integers(0, 2 * TL, lead + (TL,)),
                "pos2": rng.integers(0, 2 * TL, lead + (TL,)),
                "mask": np.ones(lead + (TL,), np.int8)}

    sup, qry = to_device(tok((2, 3, 2)), "cpu"), to_device(tok((2, 6)), "cpu")
    label = torch.tensor(rng.integers(0, 3, (2, 6)))
    plain, m0 = loss_and_metrics(tmodel, sup, qry, label, "mse")
    with_aux, m1 = loss_and_metrics(tmodel, sup, qry, label, "mse", 0.05)
    assert float(m0["loss"]) == float(m1["loss"]) == float(plain.detach())
    with collect_aux(tmodel) as sink:
        tmodel(sup, qry)
    assert len(sink) == 2
    aux = float(sum(sink).detach())
    np.testing.assert_allclose(float(with_aux.detach()), float(plain.detach()) + 0.05 * aux,
                               rtol=1e-6)


@pytest.mark.parametrize("mode", ["train", "test"])
def test_ep_above_one_still_refused_by_name(tmp_path, mode):
    """``--ep`` left the refusals when the expert-parallel executor came:
    ``--ep 2`` with MoE parses into the config and reaches the mesh, which
    asks for two ranks (without a launcher, the JAX mesh text, as ``--dp 2``
    gets)."""
    argv = ["--synthetic", "--device", "cpu", "--encoder", "transformer", "--moe_experts", "4",
            "--ep", "2"]
    assert cli.config_from_args(cli.parse_args(mode == "train", argv)).ep == 2
    assert "--ep" not in cli.DEFERRED
    with pytest.raises(ValueError, match=r"1 devices not divisible by pp\*ep\*tp\*sp=2"):
        cli.main([mode, *argv, "--load_ckpt", str(tmp_path)])
