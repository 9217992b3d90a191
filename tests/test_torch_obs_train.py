"""The port's training telemetry (CPU) vs the JAX package's, and the
checkpoint manager's saver, staging and fault points.

Both packages' ``train`` CLIs run once (a module fixture each) on the same
synthetic data with ``--watchdog --perf --nan_inject_step 3 --run_dir``:
the same record kinds at the same steps (left out: ``kind="compile"``,
since the port's CPU steps capture no CUDA graph while the JAX run logs
its XLA compiles, and ``kind="ckpt"``, since the JAX saver skips a ring
save while another is in flight), the same health events, the
same perf tiles, and ``tools/obs_report.py --check`` (the JAX tool, run as
a program) passes on the port's run directory. The port's run also
carries ``--tensorboard`` (read back equal to its metrics.jsonl) and
``--profile`` (a chrome trace with the ``train/dispatch`` spans).

Then the port alone: a save taken by the saver thread at step s while
the trainer steps on restores bitwise equal to a synchronous save at s,
with and without staging; the staging drain mirrors slot files only;
``ckpt.bitflip``/``ckpt.truncate`` plans quarantine a ring save (one
``kind="fault"`` record) and ``restore_latest`` lands on the previous good
save bitwise; ``ckpt.restore_raise`` is contained as corruption; a save
error re-raises at ``wait()``; ``--debug_nans`` raises
``FloatingPointError`` naming the first poisoned step; the NaN injection
trips the watchdog and the recorder dumps.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.cli import train_main as jax_train_main
from induction_network_on_fewrel_tpu_torch import cli
from induction_network_on_fewrel_tpu_torch.obs.chaos import ChaosRegistry, install
from induction_network_on_fewrel_tpu_torch.obs.perf import TILE_SEGMENTS
from induction_network_on_fewrel_tpu_torch.train import checkpoint
from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager
from induction_network_on_fewrel_tpu_torch.utils.metrics import read_events

REPO = Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--lstm_hidden", "8", "--max_length", "12", "--induction_dim", "10",
        "--ntn_slices", "4", "--N", "3", "--K", "2", "--Q", "2", "--batch_size", "2",
        "--val_step", "4", "--val_iter", "4", "--steps_per_call", "2",
        "--metric_window_calls", "1", "--vocab_size", "62", "--sampler", "python"]
# One metric window [0, 8] before the one val boundary (at 8): the JAX loop
# restarts its window at a val boundary, the port's at a metric record.
OBS = ["--train_iter", "8", "--val_step", "8", "--watchdog", "--perf", "--nan_inject_step", "3"]


def _records(run_dir: Path) -> list[dict]:
    return [json.loads(ln) for ln in (run_dir / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port run dir, JAX run dir) of the same command line."""
    root = tmp_path_factory.mktemp("obs_train")
    port, jax_dir = root / "port", root / "jax"
    argv = [*TINY, *OBS]
    assert cli.main(["train", *argv, "--save_ckpt", str(port / "ckpt"), "--run_dir", str(port),
                     "--tensorboard", str(port / "tb"), "--profile", str(port / "prof"),
                     "--profile_steps", "4"]) == 0
    assert jax_train_main([*argv, "--save_ckpt", str(jax_dir / "ckpt"), "--run_dir",
                           str(jax_dir), "--compile_cache", "off", "--dp", "1"]) == 0
    return port, jax_dir


def _kinds(recs) -> set:
    return {(r["step"], r["kind"]) for r in recs
            if r["kind"] not in ("compile", "profile", "ckpt")}


def test_train_records_health_and_perf_tiles_equal_jax(runs):
    port, jax_dir = runs
    ours, theirs = _records(port), _records(jax_dir)
    assert _kinds(ours) == _kinds(theirs)
    health = [(r["step"], r["event"], r["severity"]) for r in ours if r["kind"] == "health"]
    assert health == [(r["step"], r["event"], r["severity"])
                      for r in theirs if r["kind"] == "health"]
    assert ("non_finite", "critical") in {(e, s) for _, e, s in health}

    def tiles(recs):
        return [sorted(k for k in r if k.endswith("_ms")) for r in recs if r["kind"] == "perf"]

    assert tiles(ours) == tiles(theirs) and tiles(ours)
    for r in (r for r in ours if r["kind"] == "perf"):
        parts = sum(r[f"{seg}_ms"] for seg in TILE_SEGMENTS)
        assert abs(parts - r["segments_sum_ms"]) <= 4e-3          # per-field rounding
        assert abs(r["segments_sum_ms"] - r["window_s"] * 1e3) <= 1e-3
    roof = [r for r in ours if r["kind"] == "roofline"]
    assert roof and roof[0]["step_bytes"] == next(
        r for r in theirs if r["kind"] == "roofline")["step_bytes"]


def test_obs_report_check_passes_on_the_ports_run_dir(runs):
    port, _ = runs
    out = subprocess.run([sys.executable, str(REPO / "tools" / "obs_report.py"), str(port),
                          "--check"], capture_output=True, text=True, cwd=REPO,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("OK:")


def test_nan_injection_trips_the_watchdog_and_dumps_the_recorder(runs):
    port, _ = runs
    dump = json.loads((port / "flight_recorder.json").read_text())
    assert dump["reason"].startswith("watchdog: non_finite")
    assert any(m["kind"] == "train" and m["loss"] == "nan" for m in dump["metrics"])
    assert any(s["name"] == "train/dispatch" for s in dump["spans"])


def test_tensorboard_mirror_reads_back_as_metrics_jsonl(runs):
    port, _ = runs
    (tb,) = (port / "tb").iterdir()
    # A non-finite float is the string "nan" in metrics.jsonl, as a health
    # message field is: the finite scalars are compared, the NaN loss apart.
    want = [(f"{r['kind']}/{k}", r["step"], np.float32(v)) for r in _records(port)
            for k, v in r.items() if k not in ("step", "kind", "wall_s")
            and isinstance(v, (int, float))]
    got = read_events(tb)
    assert [x for x in got if np.isfinite(x[2])] == want
    assert [(t, s) for t, s, v in got if not np.isfinite(v)] == [("train/loss", 8)]


def test_profile_window_traces_the_dispatch_spans(runs):
    port, _ = runs
    events = json.loads((port / "prof" / "trace.json").read_text())["traceEvents"]
    assert sum(e.get("name") == "train/dispatch" for e in events) == 2     # steps 3..6
    assert any(r["kind"] == "profile" for r in _records(port))


# --- the saver, staging and fault points ----------------------------------------


def _trainer(tmp_path, *extra, steps=4):
    args = cli.parse_args(True, [*TINY, "--train_iter", str(steps), "--save_ckpt",
                                 str(tmp_path / "ckpt"), *extra])
    trainer, _ = cli.make_trainer(args, cli.config_from_args(args))
    return trainer


def _payload(path: Path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_bitwise(a, b):
    la, lb = checkpoint._leaves(a), checkpoint._leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), p
        else:
            assert x == y, p


@pytest.mark.parametrize("stage", ["auto", "off"])
def test_async_save_restores_bitwise_equal_to_a_sync_save(tmp_path, stage):
    trainer = _trainer(tmp_path, "--ckpt_stage", stage)
    try:
        trainer.train(2)
        cfg = trainer.cfg
        sync = CheckpointManager(tmp_path / "sync", cfg)
        sync.save_latest(2, trainer.model, trainer.opt, samplers=trainer.sampler_states())
        sync.wait()                             # the synchronous reference
        saver = CheckpointManager(tmp_path / "async", cfg, stage=stage)
        assert (saver.root != saver.dir) == (stage == "auto" and Path("/dev/shm").is_dir())
        saver.save_latest(2, trainer.model, trainer.opt, samplers=trainer.sampler_states())
        saver.save(2, trainer.model, trainer.opt, 0.5)
        trainer.train(4, start_step=2)          # the state moves on under the saver
        saver.wait()
        _assert_bitwise(_payload(tmp_path / "async" / "latest.pt"),
                        _payload(tmp_path / "sync" / "latest.pt"))
        assert (tmp_path / "async" / "best.pt.integrity.json").exists()
        root = saver.root
        saver.close()
        assert not root.exists() or root == saver.dir
    finally:
        trainer.close()


def test_staging_drain_mirrors_slot_files_only(tmp_path):
    src, dst = tmp_path / "stage", tmp_path / "real"
    src.mkdir()
    dst.mkdir()
    for name in ("best.pt", "best.pt.integrity.json", "latest.pt"):
        (src / name).write_text(name)
    for name in ("best.00000002.pt", "metrics.jsonl", "config.json", "latest.pt.quarantined"):
        (dst / name).write_text("keep")
    checkpoint.sync_slots(src, dst)
    assert sorted(p.name for p in dst.iterdir()) == [
        "best.pt", "best.pt.integrity.json", "config.json", "latest.pt",
        "latest.pt.quarantined", "metrics.jsonl"]
    assert checkpoint.stage_root_for(tmp_path, "off") is None
    with pytest.raises(ValueError, match="ckpt_stage"):
        checkpoint.stage_root_for(tmp_path, "on")


@pytest.mark.parametrize("mode", ["bitflip", "truncate"])
def test_a_corrupted_ring_save_is_quarantined_and_the_restore_lands_on_the_best(tmp_path, mode):
    # Ring saves at steps 4, 8 and the end (8 again: deduplicated): the
    # second is the last ring save, so it is the slot left corrupt.
    argv = [*TINY, "--train_iter", "8", "--chaos", f"ckpt.{mode}@1:ring",
            "--save_ckpt", str(tmp_path / "ckpt"), "--watchdog"]
    assert cli.main(["train", *argv]) == 0
    recs = _records(tmp_path / "ckpt")
    assert [(r["point"], r["ckpt_kind"]) for r in recs if r["kind"] == "fault"] == \
        [(f"ckpt.{mode}", "ring")]
    trainer = _trainer(tmp_path / "restore")
    try:
        mngr = CheckpointManager(tmp_path / "ckpt", trainer.cfg, logger=trainer.logger)
        step, _ = mngr.restore_latest(trainer.model, trainer.opt)
        best = _payload(tmp_path / "ckpt" / "best.pt")
        assert step == best["step"]
        _assert_bitwise(trainer.model.state_dict(), best["params"])
        assert (tmp_path / "ckpt" / "latest.pt.quarantined").exists()
        faults = [r for r in _records(tmp_path / "restore" / "ckpt") if r["kind"] == "fault"]
        assert [(f["action"], f["ckpt_kind"]) for f in faults] == [("ckpt_quarantine", "latest")]
    finally:
        trainer.close()


def test_restore_raise_is_contained_as_corruption(tmp_path):
    trainer = _trainer(tmp_path)
    try:
        trainer.train(4)
        install(ChaosRegistry.parse("ckpt.restore_raise@0:ring"))
        mngr = CheckpointManager(tmp_path / "ckpt", trainer.cfg)
        step, _ = mngr.restore_latest(trainer.model, trainer.opt)
        assert step == _payload(tmp_path / "ckpt" / "best.pt")["step"]
        assert (tmp_path / "ckpt" / "latest.pt.quarantined").exists()
    finally:
        install(None)
        trainer.close()


def test_a_failed_async_save_reraises_at_wait(tmp_path):
    trainer = _trainer(tmp_path)
    try:
        saver = CheckpointManager(tmp_path / "async", trainer.cfg, stage="off")
        saver.save_latest(1, trainer.model, trainer.opt)
        saver.wait()
        (tmp_path / "async" / "latest.pt").unlink()
        (tmp_path / "async" / "latest.pt").mkdir()      # the rename onto it fails
        saver.save_latest(2, trainer.model, trainer.opt)
        with pytest.raises(RuntimeError, match="async checkpoint save failed"):
            saver.wait()
        saver.close()
    finally:
        trainer.close()


def test_debug_nans_raises_at_the_call_holding_the_poisoned_step(tmp_path):
    trainer = _trainer(tmp_path, "--debug_nans")
    try:
        assert trainer.train(2) == 2
        with torch.no_grad():
            next(trainer.model.parameters()).fill_(float("nan"))
        with pytest.raises(FloatingPointError, match="at step 3 "):
            trainer.train(2, start_step=2)
    finally:
        trainer.close()
