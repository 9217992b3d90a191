"""The train/test CLI under data parallel.

* ``torchrun --nproc_per_node 2 -m induction_network_on_fewrel_tpu_torch.cli
  train --dp 2 --device cpu`` (two gloo ranks) trains a few steps of the
  token-cache lazy path with ZeRO-1 and bucketed gradients, rank 0 alone
  writing the checkpoint and the result line; ``test`` on that checkpoint
  under two ranks evaluates it. The same launch trains ``--adv``,
  ``--mixture`` and ``--feature_cache`` (a narrow BERT) a few steps each. Each launch is bounded; an overrun kills
  the launcher's process group.
* The refusals under a mesh: the JAX batch-divisibility text (also with
  ``--mixture`` and with ``--feature_cache``, which run under a mesh), an
  ``--adv_batch`` that does not divide, ``--dp`` above the world without a
  launcher (the JAX mesh text), and MoE and the live lazy path by name.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

from induction_network_on_fewrel_tpu_torch import cli
from induction_network_on_fewrel_tpu_torch.parallel import distributed, mesh as mesh_mod

REPO = Path(__file__).resolve().parents[1]
TINY = ["--synthetic", "--N", "3", "--K", "2", "--Q", "2", "--batch_size", "4",
        "--max_length", "12", "--vocab_size", "40", "--lstm_hidden", "8", "--induction_dim", "10",
        "--ntn_slices", "4", "--device", "cpu", "--sampler", "python", "--prefetch_depth", "0"]
BOUND_S = 90


def torchrun(args: list, cwd: Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "induction_network_on_fewrel_tpu_torch.cli", *args],
        cwd=str(cwd), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=BOUND_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"torchrun {args[:3]} overran {BOUND_S} s")
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def test_torchrun_two_ranks_train_then_test(tmp_path):
    ckpt = tmp_path / "ckpt"
    train = torchrun(["train", *TINY, "--dp", "2", "--token_cache", "--embed_optimizer", "lazy",
                      "--zero_opt", "--grad_bucketing", "on", "--steps_per_call", "2",
                      "--train_iter", "4", "--val_step", "2", "--val_iter", "8",
                      "--save_ckpt", str(ckpt)], tmp_path)
    assert train.returncode == 0, train.stderr[-3000:]
    lines = [json.loads(x) for x in train.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 1 and 0.0 <= lines[0]["final_val_accuracy"] <= 1.0   # rank 0 alone
    assert (ckpt / "config.json").exists() and (ckpt / "best.pt").exists()
    saved = json.loads((ckpt / "config.json").read_text())
    assert (saved["dp"], saved["zero_opt"], saved["grad_bucketing"]) == (2, True, "on")
    records = [json.loads(x) for x in (ckpt / "metrics.jsonl").read_text().splitlines()]
    assert sum(r.get("kind") == "train" for r in records) >= 1
    test = torchrun(["test", *TINY, "--dp", "2", "--token_cache", "--load_ckpt", str(ckpt),
                     "--test_iter", "8"], tmp_path)
    assert test.returncode == 0, test.stderr[-3000:]
    lines = [json.loads(x) for x in test.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 1 and 0.0 <= lines[0]["test_accuracy"] <= 1.0


PATHS = {
    "adv": ["--adv", "--adv_batch", "4", "--adv_dis_hidden", "8"],
    "mixture": ["--mixture", "train:1;synthetic:1"],
    "feature_cache": ["--encoder", "bert", "--bert_frozen", "--feature_cache", "--bert_layers",
                      "2", "--bert_hidden", "32", "--bert_heads", "4", "--bert_intermediate",
                      "64", "--bert_vocab_size", "500"],
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_torchrun_two_ranks_train_the_other_paths(path, tmp_path):
    """``--adv``, ``--mixture`` and ``--feature_cache`` under two gloo ranks:
    a few steps and a val pass, rank 0 alone printing the result."""
    run = torchrun(["train", *TINY, "--dp", "2", *PATHS[path], "--train_iter", "4",
                    "--val_step", "2", "--val_iter", "8"], tmp_path)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = [json.loads(x) for x in run.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 1 and 0.0 <= lines[0]["final_val_accuracy"] <= 1.0


def test_dp_above_the_world_without_a_launcher_is_the_jax_error(monkeypatch):
    for v in distributed.LAUNCHER_ENV:
        monkeypatch.delenv(v, raising=False)
    args = cli.parse_args(True, [*TINY, "--dp", "2"])
    with pytest.raises(ValueError, match="dp\\*pp\\*ep\\*tp\\*sp=2 exceeds 1 available devices"):
        cli.dp_mesh(args, cli.config_from_args(args))
    for dp in ("0", "1"):
        args = cli.parse_args(True, [*TINY, "--dp", dp])
        assert cli.dp_mesh(args, cli.config_from_args(args)) is None


REFUSED = {
    "batch": (["--batch_size", "3"], "--batch_size 3 must be divisible by the data-parallel "
                                     "mesh axis dp=2 .* try --batch_size 4 or --dp 3"),
    "adv": (["--adv", "--adv_batch", "5"], "--adv_batch 5 must be divisible by the "
                                           "data-parallel mesh axis dp=2 .* try --adv_batch 6"),
    "mixture": (["--mixture", "train:1;synthetic:1", "--batch_size", "5"],
                "--batch_size 5 must be divisible by the data-parallel mesh axis dp=2"),
    "lazy_live": (["--embed_optimizer", "lazy"], "does not combine with a device mesh on the LIVE "
                                                 "token path"),
    "moe": (["--encoder", "transformer", "--moe_experts", "2"],
            "--moe_experts under data parallel is refused"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_by_name_under_a_mesh(name, monkeypatch):
    flags, msg = REFUSED[name]
    monkeypatch.setattr(distributed, "maybe_initialize_distributed", lambda **kw: True)
    monkeypatch.setattr(mesh_mod, "make_mesh", lambda dp=None, **kw: mesh_mod.Mesh(dp=2))
    args = cli.parse_args(True, [*TINY, "--dp", "2", *flags])
    with pytest.raises(ValueError, match=msg):
        cli.dp_mesh(args, cli.config_from_args(args))


def test_feature_cache_refused_under_a_mesh(monkeypatch):
    """The feature cache runs under a mesh; a batch that does not divide
    over the ranks is still refused with it."""
    monkeypatch.setattr(distributed, "maybe_initialize_distributed", lambda **kw: True)
    monkeypatch.setattr(mesh_mod, "make_mesh", lambda dp=None, **kw: mesh_mod.Mesh(dp=2))
    cache = [*TINY, "--encoder", "bert", "--bert_frozen", "--feature_cache"]
    args = cli.parse_args(True, cache)
    assert cli.dp_mesh(args, cli.config_from_args(args)) == mesh_mod.Mesh(dp=2)
    args = cli.parse_args(True, [*cache, "--batch_size", "3"])
    with pytest.raises(ValueError, match="--batch_size 3 must be divisible by the data-parallel "
                                         "mesh axis dp=2"):
        cli.dp_mesh(args, cli.config_from_args(args))
