"""The port's training CLI on real-format files (CPU, tiny widths).

Tiny FewRel-schema JSON splits and a GloVe word2id JSON + .npy pair are
written to a temporary directory (no corpus is needed):

* ``train`` then ``test`` from the files: the vocabulary ``load_glove``
  reads equals the JAX ``load_glove``'s, the run's config takes its
  vocab_size and word_dim from it, and ``test`` reports NOTA precision and
  recall; a missing file is refused by name;
* ``--trainN/--na_rate/--nota_head`` reach the config and train (5-way
  training episodes, 3-way eval);
* ``--loss mse --na_rate 3`` is refused without ``--force``;
* ``--fault_step`` crashes a fresh run before its val boundary, and
  ``--resume`` then gives the same checkpoints as an uninterrupted run
  (bitwise on the CPU), with the shared table and with the token cache and
  lazy Adam;
* ``--divergence_guard stop`` on a collapsed val accuracy restores the best
  checkpoint, purges the newer ring slots and ends the run.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import json

import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.data.glove import load_glove as jax_load_glove
from induction_network_on_fewrel_tpu_torch import cli
from induction_network_on_fewrel_tpu_torch.data import (
    load_glove,
    make_synthetic_fewrel,
    make_synthetic_glove,
)
from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager
from induction_network_on_fewrel_tpu_torch.train.framework import FewShotTrainer

WORDS = 60
TINY = ["--N", "3", "--K", "2", "--Q", "2", "--batch_size", "2", "--max_length", "12",
        "--lstm_hidden", "8", "--induction_dim", "10", "--ntn_slices", "4", "--device", "cpu",
        "--lr", "5e-3"]


def _record(inst):
    return {"tokens": list(inst.tokens), "h": [inst.head_name, "Q1", [list(inst.head_pos)]],
            "t": [inst.tail_name, "Q2", [list(inst.tail_pos)]]}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("real")
    vocab = make_synthetic_glove(vocab_size=WORDS, word_dim=10)
    (d / "glove_word2id.json").write_text(
        json.dumps({w: i for w, i in vocab.word2id.items() if i < WORDS}))
    np.save(d / "glove_mat.npy", vocab.vectors[:WORDS])
    out = {"dir": d, "glove": ["--glove", str(d / "glove_word2id.json"), "--glove_mat",
                               str(d / "glove_mat.npy")]}
    for split, (n_rel, seed) in {"train": (12, 0), "val": (6, 1), "test": (6, 2)}.items():
        ds = make_synthetic_fewrel(num_relations=n_rel, instances_per_relation=10,
                                   vocab_size=WORDS, sentence_len=(6, 14), seed=seed)
        (d / f"{split}.json").write_text(
            json.dumps({r: [_record(i) for i in ds.instances[r]] for r in ds.rel_names}))
        out[split] = [f"--{split}_file", str(d / f"{split}.json")]
    return out


def _records(ckpt, kind):
    return [r for r in map(json.loads, (ckpt / "metrics.jsonl").read_text().splitlines())
            if r["kind"] == kind]


def test_train_then_test_from_files(files, tmp_path, capsys):
    ours = load_glove(files["glove"][1], files["glove"][3])
    theirs = jax_load_glove(files["glove"][1], files["glove"][3])
    assert ours.word2id == theirs.word2id and np.array_equal(ours.vectors, theirs.vectors)
    ckpt = tmp_path / "ckpt"
    assert cli.main(["train", *TINY, *files["train"], *files["val"], *files["glove"],
                     "--na_rate", "1", "--loss", "ce", "--train_iter", "4", "--val_step", "2",
                     "--val_iter", "4", "--save_ckpt", str(ckpt)]) == 0
    saved = CheckpointManager.load_config(ckpt)
    assert (saved.vocab_size, saved.word_dim) == (WORDS + 2, 10)
    capsys.readouterr()
    assert cli.main(["test", *TINY, *files["test"], *files["glove"], "--na_rate", "1",
                     "--load_ckpt", str(ckpt), "--test_iter", "8"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"test_accuracy", "acc_ci95", "nota_precision", "nota_recall"} <= set(out)


def test_missing_file_is_refused(files, tmp_path):
    with pytest.raises(FileNotFoundError, match="--val_file .*nope.json"):
        cli.main(["train", *TINY, *files["train"], "--val_file", str(tmp_path / "nope.json"),
                  "--train_iter", "1", "--save_ckpt", str(tmp_path / "c")])


def test_trainn_na_rate_nota_head_reach_the_config_and_train(files, tmp_path):
    argv = [*TINY, *files["train"], *files["val"], *files["glove"], "--trainN", "5",
            "--na_rate", "1", "--nota_head", "stats", "--loss", "ce", "--train_iter", "4",
            "--val_step", "2", "--val_iter", "4", "--steps_per_call", "2",
            "--save_ckpt", str(tmp_path / "ckpt")]
    cfg = cli.config_from_args(cli.build_arg_parser(train=True).parse_args(argv))
    assert (cfg.train_n, cfg.n, cfg.na_rate, cfg.nota_head) == (5, 3, 1, "stats")
    assert cli.main(["train", *argv]) == 0
    train = _records(tmp_path / "ckpt", "train")
    assert train[-1]["step"] == 4 and np.isfinite(train[-1]["loss"])
    assert all("nota_recall" in r for r in _records(tmp_path / "ckpt", "val"))
    params = torch.load(tmp_path / "ckpt" / "best.pt", weights_only=True)["params"]
    assert "nota_stats_w" in params


def test_mse_with_high_na_rate_needs_force(files, tmp_path):
    argv = [*TINY, *files["train"], *files["val"], *files["glove"], "--na_rate", "3",
            "--train_iter", "1", "--val_step", "1", "--val_iter", "2",
            "--save_ckpt", str(tmp_path / "c")]
    with pytest.raises(ValueError, match="--loss mse with --na_rate 3 .* --force"):
        cli.main(["train", *argv])
    assert cli.main(["train", *argv, "--force"]) == 0


@pytest.mark.parametrize("mode", [[], ["--token_cache", "--embed_optimizer", "lazy"]],
                         ids=["shared", "cache-lazy"])
def test_fault_then_resume_equals_uninterrupted(files, tmp_path, mode, capsys):
    common = [*TINY, *files["train"], *files["val"], *files["glove"], *mode, "--val_step", "3",
              "--val_iter", "4", "--steps_per_call", "3"]
    whole, parts = tmp_path / "whole", tmp_path / "parts"
    assert cli.main(["train", *common, "--train_iter", "9", "--save_ckpt", str(whole)]) == 0
    with pytest.raises(RuntimeError, match="injected fault at step 6"):
        cli.main(["train", *common, "--train_iter", "9", "--fault_step", "5",
                  "--save_ckpt", str(parts)])
    assert CheckpointManager(parts).ring_step() == 3
    assert cli.main(["train", *common, "--train_iter", "6", "--fault_step", "5", "--resume",
                     "--save_ckpt", str(parts)]) == 0
    assert "restored latest checkpoint step=3" in capsys.readouterr().err
    ring = next(n for n in ("latest.pt", "ring_delta.pt", "ring_base.pt")
                if (whole / n).exists())
    for name in (ring, "best.pt"):
        a = torch.load(whole / name, weights_only=True)
        b = torch.load(parts / name, weights_only=True)
        assert a["step"] == b["step"] == (9 if name == ring else a["step"])
        for key in ("params", "lazy", "rows"):
            for k, v in a.get(key, {}).items():
                assert torch.equal(b[key][k], v), (name, key, k)
        assert a["opt"]["count"] == b["opt"]["count"]
        for x, y in zip(a["opt"]["mu"] + a["opt"]["nu"], b["opt"]["mu"] + b["opt"]["nu"]):
            assert (x is None and y is None) or torch.equal(x, y)


def test_divergence_guard_stop_restores_best_and_purges(files, tmp_path, monkeypatch, capsys):
    """Scripted val accuracies 0.9 then 0.1 (a collapse past the arming
    threshold): the run stops at the second boundary with the best (step 2)
    restored and the ring slot of step 4 purged."""
    accs = iter([0.9, 0.1, 0.1])
    real = FewShotTrainer.evaluate

    def scripted(self, num, sampler=None, return_metrics=False, source=None):
        if sampler is not None:
            return real(self, num, sampler, return_metrics, source)
        acc = next(accs)
        return {"accuracy": acc, "acc_ci95": 0.0} if return_metrics else acc

    monkeypatch.setattr(FewShotTrainer, "evaluate", scripted)
    ckpt = tmp_path / "ckpt"
    assert cli.main(["train", *TINY, *files["train"], *files["val"], *files["glove"],
                     "--train_iter", "8", "--val_step", "2", "--val_iter", "4",
                     "--divergence_guard", "stop", "--save_ckpt", str(ckpt)]) == 0
    assert [r["step"] for r in _records(ckpt, "val")] == [2, 4]
    stop = _records(ckpt, "divergence_stop")
    assert len(stop) == 1 and stop[0]["restored_step"] == 2.0
    assert not (ckpt / "latest.pt").exists()                  # step 4 purged
    assert CheckpointManager(ckpt).restore_latest(
        cli.make_trainer(cli.build_arg_parser(True).parse_args(
            [*TINY, *files["train"], *files["val"], *files["glove"]]),
            CheckpointManager.load_config(ckpt), only_test=True)[0].model)[0] == 2
