"""The port's serving drills (``load/chaos.py``, ``load/drift.py``,
``load/burn.py``) on the tool's synthetic checkpoint (the flagship widths,
a 2 002-word table) on the CPU, held to the JAX tool's gates
(``tools/loadgen.py``).

* The chaos drill at the seed of the committed JAX artifact
  (``CHAOS_r01.json``) passes the JAX ``check_chaos_drill``; its ring-slot
  leg quarantines the corrupted delta and restores the base bitwise with
  the cursor following, as the artifact's leg did.
* The drift drill passes the JAX tool's drift acceptance (tripped,
  once-latched, a capture on disk, re-armed by the publish, clean after
  it) with its calibration on the deterministic split.
* The burn drill trips a once-latched fast-burn CRITICAL with its
  diagnostics captured (the JAX tool's acceptance).
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import json
import os
import sys
from types import SimpleNamespace

import pytest
import torch

from induction_network_on_fewrel_tpu_torch.load import burn, chaos, drift, harness
from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOOLS = os.path.join(REPO, "tools")
if _TOOLS not in sys.path:
    sys.path.insert(0, _TOOLS)

import loadgen  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(tmp_path, **kw):
    with open(os.path.join(REPO, "CHAOS_r01.json")) as f:
        cfg = json.load(f)["config"]
    argv = ["--device", "cpu", "--run_dir", str(tmp_path / "run"), "--seed", str(cfg["seed"]),
            "--tenants", str(cfg["tenants"]), "--N", str(cfg["N"]), "--K", str(cfg["K"])]
    for k, v in kw.items():
        argv += [f"--{k}", str(v)]
    return harness.parse_args(argv)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("load_ckpt")
    return harness.make_synthetic_checkpoint(_args(tmp), str(tmp))


def _sinks(run):
    from induction_network_on_fewrel_tpu_torch.obs import DiagnosticsCapture, FlightRecorder

    logger = MetricsLogger(run, quiet=True)
    recorder = FlightRecorder(out_dir=run)
    logger.add_hook(recorder.record_metric)
    return SimpleNamespace(logger=logger, recorder=recorder,
                           capture=DiagnosticsCapture(run, recorder=recorder))


def test_chaos_drill_passes_the_jax_gate(ckpt, tmp_path):
    args = _args(tmp_path)
    s = _sinks(args.run_dir)
    try:
        drill = chaos.run_chaos_drill(args, ckpt, s.logger, s.recorder, s.capture)
    finally:
        s.capture.wait(10.0)
        s.logger.close()
    assert loadgen.check_chaos_drill(drill), json.dumps(drill, default=str)
    assert chaos.check_chaos_drill(drill)
    with open(os.path.join(REPO, "CHAOS_r01.json")) as f:
        art = json.load(f)["chaos_drill"]
    assert set(drill) == set(art)
    for key in ("breaker_open_criticals", "execute_errors", "other_tenant_served",
                "probe_served", "breaker_recovered", "drift_rearmed", "slo_rearmed",
                "rollback_latch_rearmed"):
        assert drill[key] == art[key], key
    assert drill["rollback"] == {**art["rollback"], "params_version_before": 0,
                                 "params_version_after": 0}
    leg = drill["ckpt"]
    assert leg["modes"] == art["ckpt"]["modes"] == ["base", "delta"]
    assert leg["fallback_step"] == art["ckpt"]["fallback_step"] == 2
    assert leg["bitwise_equal"] and leg["cursor_followed"] and not leg["mismatched_leaves"]
    assert leg["quarantined"] == ["ring_delta.pt.integrity.json.quarantined",
                                  "ring_delta.pt.quarantined"]


def test_ckpt_leg_names_a_diverged_leaf(monkeypatch):
    """A restore that lands on other values is reported leaf by leaf."""
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager

    real = CheckpointManager.restore_latest

    def drifting(self, model, opt=None, lazy=None):
        out = real(self, model, opt, lazy)
        with torch.no_grad():
            next(iter(model.parameters())).add_(1.0)
        return out

    monkeypatch.setattr(CheckpointManager, "restore_latest", drifting)
    leg = chaos._chaos_ckpt_leg(None)
    assert not leg["bitwise_equal"] and leg["mismatched_leaves"]


def test_drift_drill_passes_the_jax_acceptance(ckpt, tmp_path):
    args = _args(tmp_path)
    s = _sinks(args.run_dir)
    try:
        drill = drift.run_drift_drill(args, ckpt, s.logger, s.recorder, s.capture)
    finally:
        s.capture.wait(10.0)
        s.logger.close()
    assert drift.drift_ok(drill), json.dumps(drill, default=str)
    cal = drill["calibration"]
    assert {cal["base_rate"], cal["shift_rate"]} == {0.0, 1.0}
    assert drill["rearmed_on_calibration"] and drill["baseline_armed"]
    assert drill["drift_features"] and "nota_rate" in drill["drift_features"]
    assert drill["post_publish_events"] == 0 or drill["clean_after_publish"]
    assert drill["published_version"] == 1


def test_burn_drill_trips_once_latched_with_captures(ckpt, tmp_path):
    import numpy as np

    from induction_network_on_fewrel_tpu_torch.load.harness import (
        _pools,
        build_engine,
        build_slo,
        register_tenants,
        run_open,
    )

    args = _args(tmp_path, rate=40, duration=1, slo_fast_s=1.0)
    args.burn_drill = True
    s = _sinks(args.run_dir)
    engine = build_engine(args, ckpt, "continuous", logger=s.logger,
                          slo=build_slo(args, s.logger, s.recorder, s.capture))
    try:
        pools = _pools(register_tenants(engine, args), args.K)
        engine.warmup()
        rng = np.random.default_rng(args.seed)
        run_open(engine, pools, args.rate, 0.5, rng)          # the healthy baseline p50
        out = burn.run_burn_drill(engine, pools, args, rng)
    finally:
        engine.close()
        s.capture.wait(10.0)
        s.logger.close()
    assert burn.burn_ok(out), json.dumps(out, default=str)
    assert out["tripped_at_rate_multiplier"] in (4, 16, 64)
    assert out["dropped"] == 0
