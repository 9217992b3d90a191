"""The port's training path vs the JAX package at small widths (CPU).

* The optimizer chain in isolation against the JAX package's optax chain
  (clip_by_global_norm -> add_decayed_weights -> adam, staircase decay):
  the clip below and above its threshold, coupled decay, and a staircase
  crossing two boundaries, on the same parameters and gradients.
* A 20-step trajectory of the port's ``train_step`` against JAX
  ``make_train_step`` on identical batches from one seeded sampler, the
  weights carried by ``interop.params_from_jax``, f32, mse and ce, at the
  tests/test_trajectory_twin.py bars (losses rtol 2e-4, final params atol
  1e-3).
* The numpy ``EpisodeSampler`` copy gives the JAX sampler's batches.
* The CLI's train -> test round trip on the CPU, and its refusal to run
  on a machine without CUDA unless given ``--device cpu``, or on a data
  file that does not exist.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.data import GloveTokenizer as JaxTokenizer
from induction_network_on_fewrel_tpu.data import make_synthetic_fewrel as jax_fewrel
from induction_network_on_fewrel_tpu.data import make_synthetic_glove as jax_glove
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu.models.build import batch_to_model_inputs as jax_inputs
from induction_network_on_fewrel_tpu.sampling.episodes import EpisodeSampler as JaxSampler
from induction_network_on_fewrel_tpu.train.steps import init_state, make_optimizer as jax_opt
from induction_network_on_fewrel_tpu.train.steps import make_train_step
from induction_network_on_fewrel_tpu_torch import cli
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.data import (
    GloveTokenizer,
    make_synthetic_fewrel,
    make_synthetic_glove,
)
from induction_network_on_fewrel_tpu_torch.interop import params_from_jax, params_to_jax
from induction_network_on_fewrel_tpu_torch.models.build import build_model, resolve_runtime_backends
from induction_network_on_fewrel_tpu_torch.models.losses import episode_metrics, mse_onehot_loss
from induction_network_on_fewrel_tpu_torch.sampling.episodes import EpisodeSampler
from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager
from induction_network_on_fewrel_tpu_torch.train.steps import (
    ClipDecayOptimizer,
    make_optimizer,
    train_step,
)

SMALL = dict(
    vocab_size=60, max_length=12, word_dim=10, pos_dim=2, lstm_hidden=16,
    att_dim=8, induction_dim=12, ntn_slices=6, routing_iters=3,
)
TRAJ = dict(SMALL, n=3, k=2, q=2, batch_size=2, compute_dtype="float32", lr=2e-3,
            weight_decay=1e-4, grad_clip=1.0, lr_step_size=3, lr_gamma=0.5)
STEPS = 20


# --- optimizer -------------------------------------------------------------------


def test_optimizer_matches_optax_chain():
    """Per step, gradients scaled so that the clip is inactive (norm below
    the threshold) on some steps and active on others; 7 updates with
    lr_step_size=3 cross the staircase at updates 3 and 6. The bar (1e-5
    relative, 1e-6 absolute) is f32 rounding of the two op orders; a wrong
    clip, decay coupling, epsilon placement or staircase step moves the
    parameters by a fraction of lr = 1e-2."""
    cfg = dict(lr=1e-2, weight_decay=1e-2, lr_step_size=3, lr_gamma=0.5, grad_clip=1.0)
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(4, 5)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    tx = jax_opt(JaxConfig(**cfg))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in params.values()]
    opt = ClipDecayOptimizer(tp, **cfg)
    clipped = []
    for step, scale in enumerate([0.05, 3.0, 0.1, 5.0, 0.02, 2.0, 0.3]):
        grads = {k: (rng.normal(size=v.shape) * scale).astype(np.float32)
                 for k, v in params.items()}
        upd, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, grads.values()):
            p.grad = torch.from_numpy(g)
        assert opt.learning_rate() == cfg["lr"] * 0.5 ** (step // 3)
        norm = float(opt.step())
        clipped.append(norm >= cfg["grad_clip"])
        for p, v in zip(tp, jp.values()):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(v), rtol=1e-5, atol=1e-6)
    assert any(clipped) and not all(clipped)
    assert opt.count == 7


def test_optimizer_clip_has_no_epsilon_and_decay_is_coupled():
    """A gradient of norm exactly 2 with clip 1 is halved (clip_grad_norm_
    would divide by 2 + 1e-6); with lr_step_size huge and one update, the
    update direction includes wd * p before Adam's normalization. The bias
    corrections 1 - b^1 are f32 values, as optax computes them on the
    device (with lr = 1 their rounding shows at 1e-5)."""
    p = torch.nn.Parameter(torch.tensor([3.0, -4.0]))
    opt = ClipDecayOptimizer([p], lr=1.0, weight_decay=0.5, lr_step_size=10**9, lr_gamma=0.5,
                             grad_clip=1.0)
    p.grad = torch.tensor([2.0, 0.0])
    opt.step()
    g = torch.tensor([1.0, 0.0]) + 0.5 * torch.tensor([3.0, -4.0])    # clipped + decay
    m, v = (1 - 0.9) * g, (1 - 0.999) * g * g                         # first moments
    bc1, bc2 = 1 - torch.tensor(0.9), 1 - torch.tensor(0.999)         # f32, as optax
    expect = torch.tensor([3.0, -4.0]) - (m / bc1) / (torch.sqrt(v / bc2) + 1e-8)
    torch.testing.assert_close(p.detach(), expect, rtol=1e-6, atol=1e-6)


def test_optimizer_refuses_unported_choices():
    model = build_model(ExperimentConfig(**SMALL), device="cpu")
    with pytest.raises(ValueError, match="embed_optimizer=lazy .* requires --optimizer adam"):
        make_optimizer(ExperimentConfig(**SMALL, embed_optimizer="lazy", optimizer="sgd"), model)
    with pytest.raises(ValueError, match="unknown optimizer 'rmsprop'"):
        make_optimizer(ExperimentConfig(**SMALL, optimizer="rmsprop"), model)


def test_optimizer_state_round_trip():
    p = torch.nn.Parameter(torch.ones(3))
    opt = ClipDecayOptimizer([p], lr=0.1, weight_decay=0.0, lr_step_size=2, lr_gamma=0.5,
                        grad_clip=10.0)
    p.grad = torch.ones(3)
    opt.step()
    other = ClipDecayOptimizer([torch.nn.Parameter(torch.ones(3))], lr=0.1, weight_decay=0.0,
                          lr_step_size=2, lr_gamma=0.5, grad_clip=10.0)
    other.load_state_dict(opt.state_dict())
    assert other.count == 1 and torch.equal(other.mu[0], opt.mu[0])


# --- sampler ---------------------------------------------------------------------


@pytest.mark.parametrize("na_rate", [0, 1])
def test_sampler_matches_jax_sampler(na_rate):
    kw = dict(num_relations=6, instances_per_relation=9, vocab_size=58, seed=4)
    jt = JaxTokenizer(jax_glove(58, 10), max_length=12)
    tt = GloveTokenizer(make_synthetic_glove(58, 10), max_length=12)
    js = JaxSampler(jax_fewrel(**kw), jt, 3, 2, 2, batch_size=2, na_rate=na_rate, seed=9)
    ts = EpisodeSampler(make_synthetic_fewrel(**kw), tt, 3, 2, 2, batch_size=2,
                        na_rate=na_rate, seed=9)
    assert ts.total_q == js.total_q
    for _ in range(3):
        a, b = js.sample_batch(), ts.sample_batch()
        for name, x, y in zip(a._fields, a, b):
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
    with pytest.raises(ValueError, match="instances < K\\+Q"):
        EpisodeSampler(make_synthetic_fewrel(**kw), tt, 3, 5, 5)


def test_episode_metrics_nota_fractions():
    logits = torch.tensor([[[0.0, 1.0, 2.0], [3.0, 0.0, 0.0], [0.0, 0.0, 5.0]]])
    label = torch.tensor([[2, 0, 0]])
    m = episode_metrics(logits, label, nota=True)
    assert float(m["accuracy"]) == pytest.approx(2 / 3)
    assert float(m["nota_tp"]) == pytest.approx(1 / 3)
    assert float(m["nota_pred"]) == pytest.approx(2 / 3)
    assert float(m["nota_true"]) == pytest.approx(1 / 3)
    assert float(mse_onehot_loss(logits, label)) > 0


# --- trajectory vs JAX -------------------------------------------------------------


def _batches(n):
    jcfg = JaxConfig(**TRAJ)
    vocab = jax_glove(jcfg.vocab_size - 2, jcfg.word_dim)
    ds = jax_fewrel(num_relations=6, instances_per_relation=jcfg.k + jcfg.q + 4,
                    vocab_size=jcfg.vocab_size - 2, sentence_len=(6, jcfg.max_length))
    s = JaxSampler(ds, JaxTokenizer(vocab, jcfg.max_length), jcfg.n, jcfg.k, jcfg.q,
                   batch_size=jcfg.batch_size, seed=123)
    return [jax_inputs(s.sample_batch()) for _ in range(n)]


@pytest.mark.parametrize("loss", ["mse", "ce"])
def test_trajectory_matches_jax_train_step(loss):
    jcfg = JaxConfig(**TRAJ, loss=loss)
    batches = _batches(STEPS)
    jmodel = jax_build_model(jcfg)
    state = init_state(jmodel, jcfg, batches[0][0], batches[0][1])
    step = make_train_step(jmodel, jcfg)
    model = build_model(ExperimentConfig(**TRAJ, loss=loss), device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(state.params["params"])))
    opt = make_optimizer(ExperimentConfig(**TRAJ, loss=loss), model)
    cfg = ExperimentConfig(**TRAJ, loss=loss)
    for support, query, label in batches:
        state, jm = step(state, support, query, label)
        tm = train_step(model, opt, cfg, support, query, label)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-4)
        assert float(tm["accuracy"]) == pytest.approx(float(jm["accuracy"]), abs=1e-6)
    want = params_to_jax({k: torch.from_numpy(np.asarray(v)) for k, v in
                          params_from_jax(jax.device_get(state.params["params"])).items()})
    got = params_to_jax(model.state_dict())
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, w, atol=1e-3, err_msg=jax.tree_util.keystr(path))


def test_bf16_train_step_gives_every_encoder_param_a_gradient():
    """The bf16 training route (plain versions of K7/K8/K10/K11 on the CPU)
    reaches every parameter with a finite, nonzero gradient."""
    cfg = ExperimentConfig(**dict(TRAJ, compute_dtype="bfloat16"))
    model = build_model(cfg, device="cpu")
    support, query, label = _batches(1)[0]
    opt = make_optimizer(cfg, model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    m = train_step(model, opt, cfg, support, query, label)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    for name, v in model.state_dict().items():
        assert not torch.equal(v, before[name]), f"{name} did not move"


def test_runtime_knobs_resolve_and_refuse():
    r = resolve_runtime_backends(ExperimentConfig(), "cpu")
    assert r == {"lstm_backend": "reference", "attn_backend": "reference",
                 "lstm_cs_window": 8, "lstm_residual_dtype": None}
    r = resolve_runtime_backends(ExperimentConfig(lstm_cs_window=3, lstm_residuals="f32"), "cpu")
    assert r["lstm_cs_window"] == 3 and r["lstm_residual_dtype"] == torch.float32
    with pytest.raises(ValueError, match="lstm_cs_window must be >= 0"):
        resolve_runtime_backends(ExperimentConfig(lstm_cs_window=-1), "cpu")
    with pytest.raises(ValueError, match="unknown lstm_residuals"):
        resolve_runtime_backends(ExperimentConfig(lstm_residuals="fp8"), "cpu")


def test_checkpoint_slots_restore_params_and_optimizer(tmp_path):
    cfg = ExperimentConfig(**TRAJ)
    model = build_model(cfg, device="cpu")
    opt = make_optimizer(cfg, model)
    support, query, label = _batches(1)[0]
    train_step(model, opt, cfg, support, query, label)
    mngr = CheckpointManager(tmp_path, cfg)
    with pytest.raises(FileNotFoundError, match="no best checkpoint"):
        mngr.restore_best(model)
    mngr.save(1, model, opt, val_accuracy=0.5)
    mngr.save_latest(1, model, opt)
    fresh = build_model(cfg.replace(seed=1), device="cpu")
    fresh_opt = make_optimizer(cfg, fresh)
    assert mngr.restore_best(fresh, fresh_opt) == 1
    for name, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[name], v), name
    assert fresh_opt.count == 1 and all(torch.equal(a, b) for a, b in zip(fresh_opt.nu, opt.nu))
    assert CheckpointManager.load_config(tmp_path) == cfg


# --- CLI ---------------------------------------------------------------------------


TINY = ["--synthetic", "--N", "3", "--K", "2", "--Q", "2", "--batch_size", "2",
        "--max_length", "12", "--vocab_size", "62", "--lstm_hidden", "8",
        "--induction_dim", "10", "--ntn_slices", "4"]


def test_cli_train_then_test_round_trip(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    rc = cli.main(["train", *TINY, "--device", "cpu", "--train_iter", "6", "--val_step", "3",
                   "--val_iter", "4", "--lr", "5e-3", "--save_ckpt", str(ckpt)])
    assert rc == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(final) == {"final_val_accuracy", "acc_ci95"}
    recs = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
    assert [(r["step"], r["mode"]) for r in recs if r["kind"] == "ckpt"] == [(3, "full"),
                                                                             (6, "full")]
    # The ring saves' records, and the per-window step-byte record.
    recs = [r for r in recs if r["kind"] not in ("ckpt", "roofline")]
    assert [r["kind"] for r in recs].count("val") == 2
    assert recs[-2]["kind"] == "train" and recs[-2]["step"] == 6 and "loss" in recs[-2]
    assert all("acc_ci95" in r for r in recs if r["kind"] == "val")
    assert (ckpt / "best.pt").exists() and (ckpt / "latest.pt").exists()
    # config.json carries the JAX names and loads into the JAX config.
    saved = json.loads((ckpt / "config.json").read_text())
    assert set(saved) <= {f.name for f in dataclasses.fields(JaxConfig)}
    assert JaxConfig.from_json((ckpt / "config.json").read_text()).lstm_hidden == 8

    rc = cli.main(["test", "--synthetic", "--device", "cpu", "--load_ckpt", str(ckpt),
                   "--N", "3", "--K", "2", "--Q", "2", "--batch_size", "2",
                   "--test_iter", "8"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.0 <= out["test_accuracy"] <= 1.0 and out["acc_ci95"] >= 0.0


def test_cli_second_run_into_one_directory_owns_it(tmp_path, capsys):
    """A second run into a used --save_ckpt directory, of another width and
    with no val boundary: its final eval does not restore the first run's
    best checkpoint, config.json is its own, and test loads its latest."""
    ckpt = str(tmp_path / "ckpt")
    assert cli.main(["train", *TINY, "--device", "cpu", "--train_iter", "2", "--val_step", "2",
                     "--val_iter", "2", "--save_ckpt", ckpt]) == 0
    assert (tmp_path / "ckpt" / "best.pt").exists()
    wider = [a if a != "8" else "12" for a in TINY]          # --lstm_hidden 12
    assert cli.main(["train", *wider, "--device", "cpu", "--train_iter", "2", "--val_step", "5",
                     "--val_iter", "2", "--save_ckpt", ckpt]) == 0
    err = capsys.readouterr().err
    assert "final eval from best checkpoint" not in err.split("[train] step=2")[-1]
    assert not (tmp_path / "ckpt" / "best.pt").exists()
    assert CheckpointManager.load_config(ckpt).lstm_hidden == 12
    assert cli.main(["test", "--synthetic", "--device", "cpu", "--load_ckpt", ckpt,
                     "--N", "3", "--K", "2", "--Q", "2", "--batch_size", "2",
                     "--test_iter", "4"]) == 0
    assert "loaded latest checkpoint step=2" in capsys.readouterr().err


def test_cli_refuses_without_cuda_or_synthetic(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal path is not reachable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train", *TINY, "--train_iter", "1", "--save_ckpt", str(tmp_path / "c")])
    with pytest.raises(FileNotFoundError, match="--train_file"):
        cli.main(["train", *TINY[1:], "--device", "cpu", "--train_file",
                  str(tmp_path / "missing.json"), "--save_ckpt", str(tmp_path / "c")])
    assert cli.main([]) == 2
