"""The port's checkpoint ring: the cases of tests/test_ckpt_delta.py and
tests/test_ckpt_integrity.py on the port's ``.pt`` format (CPU).

Delta saves: a resume from a delta equals the trajectory bitwise and the
post-resume save deltas against the same base; a zero-row delta; a rebase
once a delta passes half the table; full saves for a state without the
lazy leaves and under ``ckpt_delta="off"``; the divergence guard's purge.
Integrity: a clean restore verifies silently; a corrupt delta is
quarantined (renamed, a fault record) and the restore falls back to the
base; a corrupt base orphans its delta and the restore falls back to the
best save; a truncated full ring slot falls back to the best save; slots
written without sidecars keep raising; verified data whose load fails
(another architecture) re-raises the original error. Best-val retention
of 3.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import json

import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.data import (
    GloveTokenizer,
    make_synthetic_fewrel,
    make_synthetic_glove,
)
from induction_network_on_fewrel_tpu_torch.models.build import batch_to_model_inputs, build_model
from induction_network_on_fewrel_tpu_torch.sampling.episodes import EpisodeSampler
from induction_network_on_fewrel_tpu_torch.train.checkpoint import SIDECAR, CheckpointManager
from induction_network_on_fewrel_tpu_torch.train.lazy_embed import LazyTable, live_rows
from induction_network_on_fewrel_tpu_torch.train.steps import make_optimizer, make_train_step
from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

# Vocabulary >> corpus, so the changed rows stay under the half-table rebase
# threshold and ring saves take the delta path (the JAX test's sizes).
VOCAB = 402
CFG = ExperimentConfig(
    vocab_size=VOCAB, max_length=12, word_dim=10, pos_dim=2, lstm_hidden=8, att_dim=4,
    induction_dim=6, ntn_slices=3, train_n=3, n=3, k=2, q=2, batch_size=2,
    compute_dtype="float32", lr=3e-3, lr_step_size=3, weight_decay=0.0,
    embed_optimizer="lazy",
)


@pytest.fixture(scope="module")
def batches():
    vocab = make_synthetic_glove(vocab_size=VOCAB - 2, word_dim=10)
    ds = make_synthetic_fewrel(num_relations=6, instances_per_relation=6, vocab_size=35,
                               sentence_len=(6, 12))
    sampler = EpisodeSampler(ds, GloveTokenizer(vocab, max_length=12), 3, 2, 2, batch_size=2,
                             seed=3)
    return [batch_to_model_inputs(sampler.sample_batch()) for _ in range(12)]


class Run:
    """Model, optimizer, lazy table (if the config has one) and a step."""

    def __init__(self, cfg=CFG, seed=0):
        self.cfg = cfg
        self.model = build_model(cfg.replace(seed=seed), device="cpu")
        self.opt = make_optimizer(cfg, self.model)
        self.lazy = None
        if cfg.embed_optimizer == "lazy":
            self.lazy = LazyTable(self.model, self.opt.hyper, live_rows(cfg))
            self.opt.attach_compact(self.lazy.rows, self.lazy.rows_m, self.lazy.rows_v)
        self._step = make_train_step(self.model, self.opt, cfg, lazy=self.lazy)

    def steps(self, bs):
        """Train on ``bs``; the lazy table is left as the steps leave it (rows
        a step did not touch stay behind, as between val boundaries)."""
        for b in bs:
            self._step(*b)
        return self

    def state(self):
        out = {"params": {k: v.clone() for k, v in self.model.state_dict().items()},
               "opt": self.opt.state_dict()}
        if self.lazy is not None:
            out["lazy"] = self.lazy.state_dict()
        return out

    def save_latest(self, mgr, step):
        info = mgr.save_latest(step, self.model, self.opt, lazy=self.lazy)
        mgr.wait()                      # the slot on disk before the test reads it
        return info

    def save_best(self, mgr, step, acc=0.5):
        mgr.save(step, self.model, self.opt, acc, lazy=self.lazy)
        mgr.wait()

    def restore(self, mgr):
        return mgr.restore_latest(self.model, self.opt, self.lazy)[0]


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def _bitflip(path):
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))


def _faults(ckpt_dir):
    path = ckpt_dir / "log" / "metrics.jsonl"
    if not path.exists():                  # nothing was logged
        return []
    return [r for r in map(json.loads, path.read_text().splitlines()) if r["kind"] == "fault"]


def test_delta_resume_equals_the_trajectory(batches, tmp_path):
    run = Run()
    mgr = CheckpointManager(tmp_path, CFG)
    assert run.steps(batches[:4]).save_latest(mgr, 4)["mode"] == "base"
    info = run.steps(batches[4:6]).save_latest(mgr, 6)
    assert info["mode"] == "delta" and 0 < info["rows"] < VOCAB // 4
    assert (tmp_path / f"ring_base.pt{SIDECAR}").exists()
    want = run.state()
    fresh = Run(seed=1)
    mgr2 = CheckpointManager(tmp_path, CFG)
    assert fresh.restore(mgr2) == 6 and _equal(fresh.state(), want)
    assert _equal(fresh.steps(batches[6:7]).state(), run.steps(batches[6:7]).state())
    assert fresh.save_latest(mgr2, 7)["mode"] == "delta"        # the same base, re-armed
    again = Run(seed=2)
    assert again.restore(CheckpointManager(tmp_path, CFG)) == 7
    assert _equal(again.state(), fresh.state())


def test_zero_row_delta(batches, tmp_path):
    run = Run().steps(batches[:2])
    mgr = CheckpointManager(tmp_path, CFG)
    assert run.save_latest(mgr, 2)["mode"] == "base"
    info = run.save_latest(mgr, 3)
    assert info["mode"] == "delta" and info["rows"] == 0
    assert run.steps(batches[2:3]).save_latest(mgr, 4)["mode"] == "delta"
    other = Run(seed=1)
    assert other.restore(mgr) == 4 and _equal(other.state(), run.state())


def test_rebase_past_half_the_table(tmp_path):
    """A 48-word corpus over a 52-row table: a delta would cover more than
    half of it, so the second save writes a fresh base."""
    cfg = CFG.replace(vocab_size=52)
    vocab = make_synthetic_glove(vocab_size=50, word_dim=10)
    ds = make_synthetic_fewrel(num_relations=6, instances_per_relation=6, vocab_size=48,
                               sentence_len=(8, 12))
    sampler = EpisodeSampler(ds, GloveTokenizer(vocab, max_length=12), 3, 2, 2, batch_size=2,
                             seed=3)
    bs = [batch_to_model_inputs(sampler.sample_batch()) for _ in range(8)]
    run = Run(cfg).steps(bs[:2])
    mgr = CheckpointManager(tmp_path, cfg)
    assert run.save_latest(mgr, 2)["mode"] == "base"
    assert run.steps(bs[2:]).save_latest(mgr, 8)["mode"] == "base"
    other = Run(cfg, seed=1)
    assert other.restore(mgr) == 8 and _equal(other.state(), run.state())


@pytest.mark.parametrize("cfg", [CFG.replace(embed_optimizer="shared"),
                                 CFG.replace(ckpt_delta="off")], ids=["shared", "delta-off"])
def test_full_ring_saves(batches, tmp_path, cfg):
    run = Run(cfg).steps(batches[:2])
    mgr = CheckpointManager(tmp_path, cfg)
    assert run.save_latest(mgr, 2)["mode"] == "full"
    assert run.save_latest(mgr, 2) is None                       # the ring holds step 2
    assert (tmp_path / "latest.pt").exists() and not (tmp_path / "ring_base.pt").exists()
    other = Run(cfg, seed=1)
    assert other.restore(mgr) == 2 and _equal(other.state(), run.state())


def test_purge_ring_newer_than_best(batches, tmp_path):
    run = Run().steps(batches[:2])
    mgr = CheckpointManager(tmp_path, CFG)
    run.save_best(mgr, 2, 0.9)
    assert run.save_latest(mgr, 3)["mode"] == "base"
    assert run.steps(batches[2:4]).save_latest(mgr, 5)["mode"] == "delta"
    mgr.purge_ring_newer_than(2)
    assert not (tmp_path / "ring_base.pt").exists() and not (tmp_path / "ring_delta.pt").exists()
    assert Run(seed=1).restore(mgr) == 2
    assert run.save_latest(mgr, 6)["mode"] == "base"              # the diff base went too


def test_clean_restore_verifies_silently(batches, tmp_path):
    run = Run().steps(batches[:2])
    logger = MetricsLogger(tmp_path / "log", quiet=True)
    mgr = CheckpointManager(tmp_path, CFG, logger=logger)
    run.save_latest(mgr, 2)
    run.steps(batches[2:4]).save_latest(mgr, 4)
    assert Run(seed=1).restore(CheckpointManager(tmp_path, CFG, logger=logger)) == 4
    logger.close()
    assert _faults(tmp_path) == [] and not list(tmp_path.glob("*.quarantined*"))


def test_corrupt_delta_falls_back_to_base(batches, tmp_path):
    run = Run().steps(batches[:2])
    mgr = CheckpointManager(tmp_path, CFG)
    run.save_latest(mgr, 2)
    base_state = run.state()
    run.steps(batches[2:4]).save_latest(mgr, 4)
    _bitflip(tmp_path / "ring_delta.pt")
    logger = MetricsLogger(tmp_path / "log", quiet=True)
    mgr2 = CheckpointManager(tmp_path, CFG, logger=logger)
    other = Run(seed=1)
    assert other.restore(mgr2) == 2 and _equal(other.state(), base_state)
    assert (tmp_path / "ring_delta.pt.quarantined").exists()
    assert (tmp_path / f"ring_delta.pt{SIDECAR}.quarantined").exists()
    assert not (tmp_path / "ring_delta.pt").exists()
    logger.close()
    faults = _faults(tmp_path)
    assert len(faults) == 1 and faults[0]["ckpt_kind"] == "ring_delta"
    assert faults[0]["action"] == "ckpt_quarantine"
    # The directory stays writable: the next ring save deltas against the base.
    assert other.steps(batches[4:5]).save_latest(mgr2, 3)["mode"] == "delta"


def test_dead_base_orphans_its_delta_and_falls_back_to_best(batches, tmp_path):
    run = Run().steps(batches[:1])
    mgr = CheckpointManager(tmp_path, CFG)
    run.save_best(mgr, 1)
    best_state = run.state()
    assert run.steps(batches[1:2]).save_latest(mgr, 2)["mode"] == "base"
    assert run.steps(batches[2:3]).save_latest(mgr, 3)["mode"] == "delta"
    _bitflip(tmp_path / "ring_base.pt")
    logger = MetricsLogger(tmp_path / "log", quiet=True)
    other = Run(seed=1)
    assert other.restore(CheckpointManager(tmp_path, CFG, logger=logger)) == 1
    assert _equal(other.state(), best_state)
    logger.close()
    kinds = {(f["ckpt_kind"], int(f["ckpt_step"])) for f in _faults(tmp_path)}
    assert kinds == {("ring_base", 2), ("ring_delta", 3)}
    assert (tmp_path / "ring_base.pt.quarantined").exists()
    assert (tmp_path / "ring_delta.pt.quarantined").exists()


def test_truncated_ring_falls_back_to_best(batches, tmp_path):
    cfg = CFG.replace(ckpt_delta="off")
    run = Run(cfg).steps(batches[:1])
    mgr = CheckpointManager(tmp_path, cfg)
    run.save_best(mgr, 1)
    best_state = run.state()
    assert run.steps(batches[1:2]).save_latest(mgr, 2)["mode"] == "full"
    path = tmp_path / "latest.pt"
    path.write_bytes(path.read_bytes()[: path.stat().st_size // 2])
    other = Run(cfg, seed=1)
    assert other.restore(CheckpointManager(tmp_path, cfg)) == 1
    assert _equal(other.state(), best_state)
    assert (tmp_path / "latest.pt.quarantined").exists()


def test_no_manifest_keeps_raising(batches, tmp_path):
    """Slots written without sidecars (the earlier format): a truncated one
    raises its own error and is not quarantined; an empty directory has no
    checkpoint."""
    cfg = CFG.replace(ckpt_delta="off")
    run = Run(cfg).steps(batches[:1])
    mgr = CheckpointManager(tmp_path, cfg)
    run.save_best(mgr, 1)
    run.save_latest(mgr, 2)
    for side in tmp_path.glob(f"*{SIDECAR}"):
        side.unlink()
    assert Run(cfg, seed=1).restore(CheckpointManager(tmp_path, cfg)) == 2
    path = tmp_path / "latest.pt"
    path.write_bytes(path.read_bytes()[: path.stat().st_size // 2])
    with pytest.raises(Exception) as err:
        Run(cfg, seed=1).restore(CheckpointManager(tmp_path, cfg))
    assert not isinstance(err.value, FileNotFoundError)
    assert path.exists() and not list(tmp_path.glob("*.quarantined*"))
    with pytest.raises(FileNotFoundError, match="no latest checkpoint"):
        Run(cfg).restore(CheckpointManager(tmp_path / "empty", cfg))


def test_intact_data_with_another_architecture_reraises(batches, tmp_path):
    run = Run().steps(batches[:1])
    run.save_latest(CheckpointManager(tmp_path, CFG), 1)
    wider = CFG.replace(lstm_hidden=12)
    with pytest.raises(RuntimeError, match="size mismatch"):
        Run(wider).restore(CheckpointManager(tmp_path))         # no config: no field check
    assert (tmp_path / "ring_base.pt").exists() and not list(tmp_path.glob("*.quarantined*"))
    with pytest.raises(ValueError, match=r"other architecture fields: \['lstm_hidden'\]"):
        Run(wider).restore(CheckpointManager(tmp_path, wider))


def test_best_retention_of_three(batches, tmp_path):
    run = Run(CFG.replace(embed_optimizer="shared"))
    mgr = CheckpointManager(tmp_path, run.cfg)
    for step, acc in ((1, 0.2), (2, 0.3), (3, 0.4), (4, 0.5)):
        run.steps(batches[step:step + 1]).save_best(mgr, step, acc)
    names = sorted(p.name for p in tmp_path.glob("best*.pt"))
    assert names == ["best.00000002.pt", "best.00000003.pt", "best.pt"]
    _bitflip(tmp_path / "best.pt")
    assert mgr.restore_best(Run(run.cfg, seed=1).model) == 3      # the next best
    assert np.isclose(json.loads((tmp_path / f"best.00000003.pt{SIDECAR}").read_text())
                      ["val_accuracy"], 0.4)
