"""FewRel 2.0 adversarial domain adaptation: the port against the JAX package (CPU).

* ``gradient_reversal`` against ``jax.vjp`` of the JAX op, f32 and bf16.
* ``DomainDiscriminator``'s forward at f32 within 1e-6, on the JAX init
  carried by ``interop.disc_params_from_jax`` (and back, bitwise).
* ``InstanceSampler`` over 20 batches and ``make_domain_shifted_fewrel``
  at shift 0 / 0.5 / 1 against the JAX package's, bitwise.
* One DANN step's gradients, every model and discriminator leaf, against
  ``jax.grad`` of the JAX step body's loss (``steps.py:474``), within
  1e-5 of each leaf's scale, over the CNN and the BiLSTM (plain versions
  against the JAX scan), f32, under the flagship's MSE loss. A model leaf
  whose JAX gradient lies below 1e-6 of the largest element over all
  leaves would hold rounding noise alone and be held to rounding level,
  as in ``tests/test_torch_zoo_models.py`` (none does here). The
  discriminator's leaves are held to 1e-5 of its largest element: at a
  fresh discriminator its 2-way output bias gradient is [s, -s], s the
  mean of near-cancelling softmax terms (~5e-4 out of terms of ~3e-2), so
  the encoder's f32 rounding, which every other leaf shows at <= 2e-6 of
  its scale, reaches 5e-5 of that leaf's own.
* 20 steps of ``make_adv_train_step`` against JAX ``make_adv_train_step``
  and five S=4 calls of ``make_adv_multi_train_step`` against its JAX
  twin, the weights carried from the JAX init: losses and domain losses
  rtol 2e-4 at every step, the final model and discriminator parameters
  atol 1e-3.
* Through the CLI: a checkpoint has the same leaves with and without
  ``--adv`` (the discriminator is never saved), and ``--adv`` with lazy,
  the feature cache or the token cache is refused by name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.data import GloveTokenizer as JaxTokenizer
from induction_network_on_fewrel_tpu.data import make_synthetic_fewrel as jax_fewrel
from induction_network_on_fewrel_tpu.data import make_synthetic_glove as jax_glove
from induction_network_on_fewrel_tpu.data.synthetic import (
    make_domain_shifted_fewrel as jax_shifted,
)
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu.models.adversarial import (
    DomainDiscriminator as JaxDisc,
)
from induction_network_on_fewrel_tpu.models.base import FewShotModel as JaxFewShot
from induction_network_on_fewrel_tpu.models.build import batch_to_model_inputs as jax_inputs
from induction_network_on_fewrel_tpu.models.build import encoder_output_dim as jax_feat_dim
from induction_network_on_fewrel_tpu.models.losses import cross_entropy_loss as jax_ce
from induction_network_on_fewrel_tpu.ops import gradient_reversal as jax_reversal
from induction_network_on_fewrel_tpu.sampling import EpisodeSampler as JaxSampler
from induction_network_on_fewrel_tpu.sampling import InstanceSampler as JaxInstances
from induction_network_on_fewrel_tpu.train import steps as jsteps
from induction_network_on_fewrel_tpu_torch import cli
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.data import (
    GloveTokenizer,
    make_domain_shifted_fewrel,
    make_synthetic_fewrel,
    make_synthetic_glove,
)
from induction_network_on_fewrel_tpu_torch.interop import (
    disc_params_from_jax,
    disc_params_to_jax,
    params_from_jax,
    params_to_jax,
)
from induction_network_on_fewrel_tpu_torch.models.adversarial import DomainDiscriminator
from induction_network_on_fewrel_tpu_torch.models.base import to_device
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.ops.core import gradient_reversal
from induction_network_on_fewrel_tpu_torch.sampling.episodes import InstanceSampler
from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager
from induction_network_on_fewrel_tpu_torch.train.framework import stack_batches
from induction_network_on_fewrel_tpu_torch.train.steps import (
    adv_loss_and_metrics,
    init_disc_state,
    make_adv_multi_train_step,
    make_adv_train_step,
    make_optimizer,
)

L = 12
ADV = dict(vocab_size=302, max_length=L, train_n=3, n=3, k=2, q=2, batch_size=2,
           hidden_size=32, lstm_hidden=16, att_dim=8, induction_dim=8, ntn_slices=4,
           compute_dtype="float32", loss="mse", lr=3e-3, weight_decay=1e-4, grad_clip=1.0,
           lr_step_size=7, adv=True, adv_lambda=0.5, adv_dis_hidden=32, adv_batch=8)
JAX_BACKENDS = dict(lstm_backend="scan", attn_backend="xla")
STEPS = 20
NOISE_LEAF = 1e-6


@pytest.fixture(scope="module")
def data():
    """The JAX samplers' batches: 20 (support, query, label, src, tgt)."""
    vocab = jax_glove(vocab_size=300)
    src_ds = jax_fewrel(num_relations=6, instances_per_relation=10, vocab_size=300, seed=0)
    tgt_ds = jax_fewrel(num_relations=6, instances_per_relation=10, vocab_size=300, seed=97)
    tok = JaxTokenizer(vocab, max_length=L)
    ep = JaxSampler(src_ds, tok, n=3, k=2, q=2, batch_size=2, seed=0)
    src = JaxInstances(src_ds, tok, batch_size=8, seed=1)
    tgt = JaxInstances(tgt_ds, tok, batch_size=8, seed=2)
    return [jax_inputs(ep.sample_batch()) + (src.sample_batch()._asdict(),
                                             tgt.sample_batch()._asdict())
            for _ in range(STEPS)]


def _jax_pair(encoder, data):
    """(JAX model, disc, cfg, state, disc state) and the port's (model, opt,
    disc state, cfg) on the JAX init."""
    kw = dict(ADV, encoder=encoder, model="induction")
    jcfg = JaxConfig(**kw, **JAX_BACKENDS)
    jmodel = jax_build_model(jcfg)
    state = jsteps.init_state(jmodel, jcfg, data[0][0], data[0][1])
    jdisc = JaxDisc(hidden=jcfg.adv_dis_hidden)
    dstate = jsteps.init_disc_state(jdisc, jcfg, jax_feat_dim(jcfg))
    cfg = ExperimentConfig(**kw, lstm_backend="reference", attn_backend="reference")
    tmodel = build_model(cfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.device_get(state.params["params"])))
    disc = init_disc_state(cfg, dstate.params["params"]["fc1"]["kernel"].shape[0], "cpu")
    disc.module.load_state_dict(disc_params_from_jax(jax.device_get(dstate.params["params"])))
    return (jmodel, jdisc, jcfg, state, dstate), (tmodel, make_optimizer(cfg, tmodel), disc, cfg)


def _close_trees(got: dict, want: dict, **tol) -> None:
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), err_msg=jax.tree_util.keystr(path),
                                   **tol)


# --- ops, module, samplers -----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1.0, 0.25])
def test_gradient_reversal_matches_jax_vjp(dtype, scale):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 7)).astype(np.float32)
    g = rng.normal(size=(5, 7)).astype(np.float32)
    y, vjp = jax.vjp(lambda t: jax_reversal(t, scale), jnp.asarray(x, dtype))
    (jg,) = vjp(jnp.asarray(g, dtype))
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tx = torch.tensor(x).to(tdt).requires_grad_()
    ty = gradient_reversal(tx, scale)
    (tg,) = torch.autograd.grad(ty, tx, torch.tensor(g).to(tdt))
    assert tg.dtype == tdt
    np.testing.assert_array_equal(ty.detach().float().numpy(), np.asarray(y, np.float32))
    np.testing.assert_array_equal(tg.float().numpy(), np.asarray(jg, np.float32))


def test_discriminator_forward_matches_flax():
    jdisc = JaxDisc(hidden=32)
    params = jdisc.init(jax.random.key(3), jnp.zeros((1, 24)))
    disc = DomainDiscriminator(24, 32, device="cpu", generator=torch.Generator().manual_seed(0))
    disc.load_state_dict(disc_params_from_jax(jax.device_get(params["params"])))
    back = disc_params_to_jax(disc.state_dict())
    _close_trees(back, jax.device_get(params["params"]), rtol=0, atol=0)
    x = np.random.default_rng(1).normal(size=(9, 24)).astype(np.float32)
    want = np.asarray(jdisc.apply(params, jnp.asarray(x)))
    assert disc(torch.tensor(x).to(torch.bfloat16)).dtype == torch.float32
    np.testing.assert_allclose(disc(torch.tensor(x)).detach().numpy(), want, rtol=0, atol=1e-6)


def test_instance_sampler_matches_jax_bitwise():
    ds = make_synthetic_fewrel(num_relations=5, instances_per_relation=9, vocab_size=120, seed=4)
    jds = jax_fewrel(num_relations=5, instances_per_relation=9, vocab_size=120, seed=4)
    ours = InstanceSampler(ds, GloveTokenizer(make_synthetic_glove(120), max_length=L), 7, seed=5)
    theirs = JaxInstances(jds, JaxTokenizer(jax_glove(120), max_length=L), 7, seed=5)
    for _ in range(20):
        a, b = ours.sample_batch(), theirs.sample_batch()
        for f in ("word", "pos1", "pos2", "mask"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("shift", [0.0, 0.5, 1.0])
def test_domain_shifted_fewrel_matches_jax_bitwise(shift):
    ours = make_domain_shifted_fewrel(num_relations=4, instances_per_relation=6,
                                      vocab_size=120, shift=shift, seed=3)
    theirs = jax_shifted(num_relations=4, instances_per_relation=6, vocab_size=120,
                         shift=shift, seed=3)
    assert ours.rel_names == theirs.rel_names
    for rel in ours.rel_names:
        assert [tuple(vars(i).values()) for i in ours.instances[rel]] == \
               [tuple(vars(i).values()) for i in theirs.instances[rel]]
    with pytest.raises(ValueError, match="shift must be in"):
        make_domain_shifted_fewrel(shift=1.5)


# --- one step's gradients, trajectories ----------------------------------------------


@pytest.mark.parametrize("encoder", ["cnn", "bilstm"])
def test_adv_step_gradients_match_jax(data, encoder):
    (jmodel, jdisc, jcfg, state, dstate), (tmodel, _, disc, cfg) = _jax_pair(encoder, data)
    sup, qry, label, src, tgt = data[0]

    def loss_fn(params, dparams):      # the JAX step body's loss (steps.py:494-516)
        fs_loss, _ = jsteps.loss_and_metrics(jmodel, params, sup, qry, label, jcfg.loss, 0.0)

        def enc(b):
            return jmodel.apply(params, b["word"], b["pos1"], b["pos2"], b["mask"],
                                method=JaxFewShot.encode)

        feat = jnp.concatenate([enc(src), enc(tgt)], axis=0)
        dom_label = jnp.concatenate([jnp.zeros(src["word"].shape[0], jnp.int32),
                                     jnp.ones(tgt["word"].shape[0], jnp.int32)])
        dom_logits = jdisc.apply(dparams, jax_reversal(feat, jcfg.adv_lambda))
        return fs_loss + jax_ce(dom_logits[None], dom_label[None])

    jg, jdg = jax.device_get(jax.jit(jax.grad(loss_fn, argnums=(0, 1)))(state.params,
                                                                        dstate.params))
    batch = [to_device(x, "cpu") if isinstance(x, dict) else torch.as_tensor(x)
             for x in (sup, qry, label, src, tgt)]
    loss, m = adv_loss_and_metrics(tmodel, disc.module, cfg, *batch)
    np.testing.assert_allclose(float(loss.detach()), float(loss_fn(state.params, dstate.params)),
                               rtol=1e-5)
    assert set(m) == {"loss", "accuracy", "domain_loss", "domain_accuracy"}
    loss.backward()
    for module, to_jax, want in ((tmodel, params_to_jax, jg["params"]),
                                 (disc.module, disc_params_to_jax, jdg["params"])):
        got = to_jax({n: p.grad for n, p in module.named_parameters()})
        flat = jax.tree_util.tree_flatten_with_path(want)[0]
        assert len(flat) == len(list(module.parameters()))
        top = max(float(np.abs(w).max()) for _, w in flat)
        for path, w in flat:
            g = got
            for k in path:
                g = g[k.key]
            scale = float(np.abs(w).max())
            if module is disc.module or scale < NOISE_LEAF * top:
                scale = top
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * scale,
                                       err_msg=jax.tree_util.keystr(path))


def _finals(tmodel, disc, state, dstate):
    _close_trees(params_to_jax(tmodel.state_dict()), jax.device_get(state.params["params"]),
                 rtol=0, atol=1e-3)
    _close_trees(disc_params_to_jax(disc.module.state_dict()),
                 jax.device_get(dstate.params["params"]), rtol=0, atol=1e-3)


def test_adv_trajectory_matches_jax_adv_train_step(data):
    (jmodel, jdisc, jcfg, state, dstate), (tmodel, opt, disc, cfg) = _jax_pair("bilstm", data)
    jstep = jsteps.make_adv_train_step(jmodel, jdisc, jcfg)
    step = make_adv_train_step(tmodel, opt, disc, cfg)
    for batch in data:
        state, dstate, jm = jstep(state, dstate, *batch)
        tm = step(*batch)
        for k in ("loss", "domain_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-4, err_msg=k)
        for k in ("accuracy", "domain_accuracy"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), abs=1e-6)
    assert int(opt.count) == int(disc.opt.count) == STEPS
    _finals(tmodel, disc, state, dstate)


def test_adv_multi_step_matches_jax_adv_multi_train_step(data):
    (jmodel, jdisc, jcfg, state, dstate), (tmodel, opt, disc, cfg) = _jax_pair("cnn", data)
    jmulti = jsteps.make_adv_multi_train_step(jmodel, jdisc, jcfg)
    multi = make_adv_multi_train_step(tmodel, opt, disc, cfg)
    S = 4
    for i in range(0, STEPS, S):
        chunk = data[i:i + S]
        stacked = stack_batches([b[:3] for b in chunk]) + tuple(
            {k: np.stack([b[j][k] for b in chunk]) for k in chunk[0][j]} for j in (3, 4))
        state, dstate, jm = jmulti(state, dstate, *stacked)
        tm = multi(*stacked)
        for k in ("loss", "domain_loss"):
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), rtol=2e-4, err_msg=k)
    _finals(tmodel, disc, state, dstate)


# --- CLI ----------------------------------------------------------------------------

TINY = ["--synthetic", "--device", "cpu", "--N", "3", "--K", "2", "--Q", "2", "--batch_size",
        "2", "--max_length", "12", "--vocab_size", "62", "--lstm_hidden", "8",
        "--induction_dim", "8", "--ntn_slices", "4", "--train_iter", "3", "--val_step", "2",
        "--val_iter", "4"]


def test_adv_checkpoint_holds_the_plain_models_leaves(tmp_path, capsys):
    for name, extra in (("plain", []), ("adv", ["--adv", "--adv_batch", "4",
                                                "--adv_dis_hidden", "8"])):
        assert cli.main(["train", *TINY, *extra, "--save_ckpt", str(tmp_path / name)]) == 0
    capsys.readouterr()
    leaves = {name: {k: tuple(v.shape) for k, v in
                     CheckpointManager(tmp_path / name).params("best").items()}
              for name in ("plain", "adv")}
    assert leaves["adv"] == leaves["plain"]
    assert not any(k.startswith(("fc1", "fc2", "out")) for k in leaves["adv"])
    assert cli.main(["test", "--synthetic", "--device", "cpu", "--load_ckpt",
                     str(tmp_path / "adv"), "--N", "3", "--K", "2", "--Q", "2",
                     "--batch_size", "2", "--test_iter", "4"]) == 0


@pytest.mark.parametrize("extra,named", [
    (["--embed_optimizer", "lazy"], "--embed_optimizer lazy does not combine with --adv"),
    (["--encoder", "bert", "--bert_layers", "1", "--bert_hidden", "16", "--bert_heads", "2",
      "--bert_intermediate", "32", "--bert_vocab_size", "100", "--bert_frozen",
      "--feature_cache"], "--feature_cache excludes --adv"),
    (["--token_cache"], "--token_cache does not serve --adv"),
], ids=["lazy", "feature_cache", "token_cache"])
def test_adv_refusals_by_name(tmp_path, extra, named):
    with pytest.raises(ValueError, match=named):
        cli.main(["train", *TINY, "--adv", *extra, "--save_ckpt", str(tmp_path / "c")])
