"""The port's fused dispatch, grad probe, trainer loop and CLI (CPU).

* ``make_multi_train_step`` at S=4 gives bitwise the updates and metrics
  of 4 single ``train_step`` calls. On the CPU the factory is the eager
  step run S times, so this pins only the eager stacking (the batches'
  order, the metrics' layout, the state carried between steps); the
  captured S-step graph runs only on the card, where ``chip_smoke.py``
  holds one S=4 replay against four S=1 replays from the same weights on
  the same batches.
* ``make_multi_train_step`` against the JAX ``make_multi_train_step``
  (its ``lax.scan``) over 20 steps in calls of 4, from the same weights on
  the same batches, f32: losses rtol 2e-4, parameters atol 1e-3 (the
  tests/test_trajectory_twin.py bars), for Adam with a shared table and
  for AdamW with a frozen one.
* Fused eval equals per-batch eval, the trainer's padded tail included.
* ``make_grad_probe`` against the JAX probe on the same weights and batch:
  the cosine within 1e-5, the norms within 1e-4.
* The trainer: ``steps_per_call > val_step`` is refused with the JAX
  message; a fused loop with a one-at-a-time tail equals the plain loop;
  ``grad_probe_every`` logs ``health`` records.
* The CLI: the new flags reach the config; ``--embed_optimizer lazy`` with
  another optimizer than Adam is refused by name; ``--resume`` continues a run to the same checkpoints as
  an uninterrupted run; ``--only_test`` reports the test accuracy.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import json

import jax
import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.data import GloveTokenizer as JaxTokenizer
from induction_network_on_fewrel_tpu.data import make_synthetic_fewrel as jax_fewrel
from induction_network_on_fewrel_tpu.data import make_synthetic_glove as jax_glove
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu.models.build import batch_to_model_inputs as jax_inputs
from induction_network_on_fewrel_tpu.sampling.episodes import EpisodeSampler as JaxSampler
from induction_network_on_fewrel_tpu.train.steps import init_state
from induction_network_on_fewrel_tpu.train.steps import make_grad_probe as jax_grad_probe
from induction_network_on_fewrel_tpu.train.steps import make_multi_train_step as jax_multi_step
from induction_network_on_fewrel_tpu_torch import cli
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.data import (
    GloveTokenizer,
    make_synthetic_fewrel,
    make_synthetic_glove,
)
from induction_network_on_fewrel_tpu_torch.interop import params_from_jax, params_to_jax
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.sampling.episodes import EpisodeSampler
from induction_network_on_fewrel_tpu_torch.train.framework import FewShotTrainer, stack_batches
from induction_network_on_fewrel_tpu_torch.train.steps import (
    eval_step,
    make_grad_probe,
    make_multi_eval_step,
    make_multi_train_step,
    make_optimizer,
    train_step,
)
from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

SMALL = dict(
    vocab_size=60, max_length=12, word_dim=10, pos_dim=2, lstm_hidden=16,
    att_dim=8, induction_dim=12, ntn_slices=6, routing_iters=3,
)
TRAJ = dict(SMALL, n=3, k=2, q=2, batch_size=2, compute_dtype="float32", lr=2e-3,
            weight_decay=1e-4, grad_clip=1.0, lr_step_size=3, lr_gamma=0.5)
S = 4


def _batches(n, seed=123):
    jcfg = JaxConfig(**TRAJ)
    vocab = jax_glove(jcfg.vocab_size - 2, jcfg.word_dim)
    ds = jax_fewrel(num_relations=6, instances_per_relation=jcfg.k + jcfg.q + 4,
                    vocab_size=jcfg.vocab_size - 2, sentence_len=(6, jcfg.max_length))
    s = JaxSampler(ds, JaxTokenizer(vocab, jcfg.max_length), jcfg.n, jcfg.k, jcfg.q,
                   batch_size=jcfg.batch_size, seed=seed)
    return [jax_inputs(s.sample_batch()) for _ in range(n)]


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_fused_steps_equal_single_steps_bitwise():
    """S=4 fused == 4 single steps, bitwise. On the CPU this pins only the
    eager stacking (``make_multi_train_step`` is the eager step run S
    times); the S-step CUDA graph is checked on the card."""
    cfg = ExperimentConfig(**TRAJ, steps_per_call=S)
    batches = _batches(2 * S)
    single, fused = build_model(cfg, device="cpu"), build_model(cfg, device="cpu")
    opt_a, opt_b = make_optimizer(cfg, single), make_optimizer(cfg, fused)
    seq = [train_step(single, opt_a, cfg, *b) for b in batches]
    multi = make_multi_train_step(fused, opt_b, cfg)
    out = [multi(*stack_batches(batches[i:i + S])) for i in range(0, 2 * S, S)]
    for key in ("loss", "accuracy", "grad_norm"):
        got = torch.cat([o[key] for o in out])
        assert torch.equal(got, torch.stack([m[key] for m in seq])), key
    for name, v in _params(single).items():
        assert torch.equal(_params(fused)[name], v), name
    assert int(opt_a.count) == int(opt_b.count) == 2 * S
    for a, b in zip(opt_a.mu + opt_a.nu, opt_b.mu + opt_b.nu):
        assert torch.equal(a, b)


def _tree_get(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.mark.parametrize("optimizer,embed", [("adam", "shared"), ("adamw", "frozen")])
def test_multi_train_step_matches_jax_scan(optimizer, embed):
    kw = dict(TRAJ, optimizer=optimizer, embed_optimizer=embed, steps_per_call=S)
    jcfg = JaxConfig(**kw)
    batches = _batches(20)
    jmodel = jax_build_model(jcfg)
    state = init_state(jmodel, jcfg, batches[0][0], batches[0][1])
    jmulti = jax_multi_step(jmodel, jcfg)
    cfg = ExperimentConfig(**kw)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(state.params["params"])))
    multi = make_multi_train_step(model, make_optimizer(cfg, model), cfg)
    for i in range(0, 20, S):
        stacked = stack_batches(batches[i:i + S])
        state, jm = jmulti(state, *stacked)
        tm = multi(*stacked)
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]), rtol=2e-4)
    want = params_to_jax({k: torch.from_numpy(np.asarray(v)) for k, v in
                          params_from_jax(jax.device_get(state.params["params"])).items()})
    got = params_to_jax(model.state_dict())
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        np.testing.assert_allclose(_tree_get(got, path), w, atol=1e-3,
                                   err_msg=jax.tree_util.keystr(path))


def test_fused_eval_equals_per_batch_eval():
    cfg = ExperimentConfig(**TRAJ)
    model = build_model(cfg, device="cpu")
    batches = _batches(3)
    fused = make_multi_eval_step(model, cfg)(*stack_batches(batches))
    for i, b in enumerate(batches):
        one = eval_step(model, cfg, *b)
        for k, v in one.items():
            assert torch.equal(fused[k][i], v), k


def _tok_and_sampler(cfg, split_seed, seed):
    tok = GloveTokenizer(make_synthetic_glove(cfg.vocab_size - 2, cfg.word_dim), cfg.max_length)
    ds = make_synthetic_fewrel(num_relations=6, instances_per_relation=cfg.k + cfg.q + 4,
                               vocab_size=cfg.vocab_size - 2, sentence_len=(6, cfg.max_length),
                               seed=split_seed)
    return EpisodeSampler(ds, tok, cfg.n, cfg.k, cfg.q, batch_size=cfg.batch_size, seed=seed)


def test_trainer_fused_eval_pads_its_tail():
    """7 batches at a width of 4: one fused call, then 3 real batches padded
    to 4 with the last one repeated and the repeats dropped; the metrics
    equal the per-batch evaluation of the same 7 batches."""
    cfg = ExperimentConfig(**TRAJ)
    model = build_model(cfg, device="cpu")
    per_batch = FewShotTrainer(model, cfg, None, _tok_and_sampler(cfg, 1, 5))
    fused = FewShotTrainer(model, cfg.replace(eval_steps_per_call=4), None,
                           _tok_and_sampler(cfg, 1, 5))
    assert per_batch.multi_eval_step is None and fused.eval_spc == 4
    a = per_batch.evaluate(7 * cfg.batch_size, return_metrics=True)
    b = fused.evaluate(7 * cfg.batch_size, return_metrics=True)
    assert a == b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_probe_matches_jax_probe(dtype):
    jcfg = JaxConfig(**dict(TRAJ, compute_dtype=dtype))
    support, query, label = _batches(1)[0]
    jmodel = jax_build_model(jcfg)
    state = init_state(jmodel, jcfg, support, query)
    want = jax.device_get(jax_grad_probe(jmodel, jcfg)(state.params, support, query, label))
    cfg = ExperimentConfig(**dict(TRAJ, compute_dtype=dtype))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(state.params["params"])))
    got = make_grad_probe(model, cfg)(support, query, label)
    assert set(got) == set(want) == {"grad_norm", "grad_norm_f32", "grad_cosine"}
    np.testing.assert_allclose(float(got["grad_cosine"]), float(want["grad_cosine"]), atol=1e-5)
    for k in ("grad_norm", "grad_norm_f32"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)
    assert model.embedding.word_embedding.grad is None      # no training state touched


def test_trainer_refuses_steps_per_call_over_val_step():
    cfg = ExperimentConfig(**TRAJ, steps_per_call=5, val_step=4)
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match=r"steps_per_call \(5\) must not exceed val_step \(4\)"):
        FewShotTrainer(model, cfg, _tok_and_sampler(cfg, 0, 0), _tok_and_sampler(cfg, 1, 1))
    FewShotTrainer(model, cfg, _tok_and_sampler(cfg, 0, 0))    # no val sampler: no boundary


def test_trainer_fused_loop_equals_plain_loop(tmp_path):
    """10 steps at steps_per_call=4 (two fused calls, then two single
    steps) give the plain loop's parameters and window means; a probe
    every 5 steps logs at the first step past each multiple of 5."""
    runs = {}
    for spc in (1, 4):
        cfg = ExperimentConfig(**TRAJ, steps_per_call=spc, grad_probe_every=5 if spc > 1 else 0)
        model = build_model(cfg, device="cpu")
        logger = MetricsLogger(tmp_path / str(spc), quiet=True)
        trainer = FewShotTrainer(model, cfg, _tok_and_sampler(cfg, 0, 7), logger=logger)
        assert trainer.metric_window == 50
        assert trainer.train(10) == 10
        trainer.close()
        recs = [json.loads(line) for line in (tmp_path / str(spc) / "metrics.jsonl").read_text()
                .splitlines()]
        runs[spc] = (_params(model), recs)
    for name, v in runs[1][0].items():
        assert torch.equal(runs[4][0][name], v), name
    train_1 = [r for r in runs[1][1] if r["kind"] == "train"]
    train_4 = [r for r in runs[4][1] if r["kind"] == "train"]
    assert [r["step"] for r in train_4] == [10]
    for k in ("loss", "accuracy", "grad_norm"):
        assert train_4[0][k] == pytest.approx(train_1[0][k], rel=1e-6)
    health = [r for r in runs[4][1] if r["kind"] == "health"]
    assert [r["step"] for r in health] == [8, 10]
    assert all(r["event"] == "grad_probe" and 0.99 < r["grad_cosine"] <= 1.0 + 1e-6
               for r in health)


TINY = ["--synthetic", "--N", "3", "--K", "2", "--Q", "2", "--batch_size", "2",
        "--max_length", "12", "--vocab_size", "62", "--lstm_hidden", "8",
        "--induction_dim", "10", "--ntn_slices", "4", "--device", "cpu", "--lr", "5e-3"]


def test_cli_new_flags_reach_the_config():
    args = cli.build_arg_parser(train=True).parse_args(
        TINY + ["--optimizer", "adamw", "--embed_optimizer", "frozen", "--weight_decay", "0.01",
                "--lr_step_size", "7", "--grad_clip", "2.5", "--steps_per_call", "4",
                "--eval_steps_per_call", "2", "--metric_window_calls", "3",
                "--grad_probe_every", "9", "--resume", "--only_test"])
    cfg = cli.config_from_args(args)
    assert (cfg.optimizer, cfg.embed_optimizer, cfg.weight_decay, cfg.lr_step_size,
            cfg.grad_clip, cfg.steps_per_call, cfg.eval_steps_per_call,
            cfg.metric_window_calls, cfg.grad_probe_every) == \
        ("adamw", "frozen", 0.01, 7, 2.5, 4, 2, 3, 9)
    assert args.resume and args.only_test
    test_args = cli.build_arg_parser(train=False).parse_args(TINY + ["--steps_per_call", "4"])
    assert cli.config_from_args(test_args).steps_per_call == 4


def test_cli_refuses_lazy_by_name(tmp_path):
    """Lazy Adam replicates Adam's momentum tail: with another optimizer
    ``--embed_optimizer lazy`` is refused by name."""
    with pytest.raises(ValueError, match="embed_optimizer=lazy .* requires --optimizer adam"):
        cli.main(["train", *TINY, "--embed_optimizer", "lazy", "--optimizer", "sgd",
                  "--train_iter", "1", "--save_ckpt", str(tmp_path / "c")])


def _payload(path):
    return torch.load(path, weights_only=True)


def _assert_same_payload(a, b):
    assert a["step"] == b["step"]
    for k, v in a["params"].items():
        assert torch.equal(b["params"][k], v), k
    assert a["opt"]["count"] == b["opt"]["count"] and a["opt"]["rules"] == b["opt"]["rules"]
    for x, y in zip(a["opt"]["mu"] + a["opt"]["nu"], b["opt"]["mu"] + b["opt"]["nu"]):
        assert (x is None and y is None) or torch.equal(x, y)


def test_cli_resume_equals_an_uninterrupted_run(tmp_path, capsys):
    """6 steps in one run vs 3 steps, then ``--resume`` for 3 more (val
    every 3 steps): the same latest and best checkpoints, bitwise; the
    resumed run keeps the directory's best slot and continues both
    samplers' streams."""
    common = [*TINY, "--val_step", "3", "--val_iter", "4", "--embed_optimizer", "sgd"]
    whole, parts = str(tmp_path / "whole"), str(tmp_path / "parts")
    assert cli.main(["train", *common, "--train_iter", "6", "--save_ckpt", whole]) == 0
    assert cli.main(["train", *common, "--train_iter", "3", "--save_ckpt", parts]) == 0
    assert cli.main(["train", *common, "--train_iter", "3", "--save_ckpt", parts,
                     "--resume"]) == 0
    assert "restored latest checkpoint step=3" in capsys.readouterr().err
    for slot in ("latest", "best"):
        _assert_same_payload(_payload(tmp_path / "whole" / f"{slot}.pt"),
                             _payload(tmp_path / "parts" / f"{slot}.pt"))
    vals = [[r for r in map(json.loads, (tmp_path / d / "metrics.jsonl").read_text().splitlines())
             if r["kind"] == "val"] for d in ("whole", "parts")]
    assert [(r["step"], r["accuracy"]) for r in vals[0]] == \
        [(r["step"], r["accuracy"]) for r in vals[1]]

    assert cli.main(["train", *common, "--save_ckpt", parts, "--resume", "--only_test",
                     "--test_iter", "4"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"test_accuracy", "acc_ci95"} and 0.0 <= out["test_accuracy"] <= 1.0
    with pytest.raises(ValueError, match=r"other architecture fields: \['optimizer'\]"):
        cli.main(["train", *common, "--optimizer", "sgd", "--train_iter", "1",
                  "--save_ckpt", parts, "--resume"])
