"""The port's run report (``tools/obs_report.py`` of the port package) vs
the JAX repository's ``tools/obs_report.py`` (CPU).

* ``check_schema`` gives the JAX tool's record count and errors, and
  ``--check`` its exit code, on a clean stream and on each planted fault:
  an unknown kind, a missing ``step``, a non-finite value, a malformed
  line, a nested field.
* On a stream holding every record kind the report reads (train, eval,
  perf, compile, serve, fleet, hop, scale, adapt, fault, trace, health,
  quality, scenario, ckpt, data, comms, roofline) with a ``config.json``
  and a ``flight_recorder.json``, every section of the port's ``--json``
  equals the JAX tool's, but ``mfu`` (the port reads the card from the
  train records' ``device``: MFU against the H100's peak, none on the CPU)
  and ``overhead`` (a timing). The text rendering is the JAX tool's.
* ``assert_reports_equal`` is the same comparison on a run directory;
  ``test_torch_obs_train.py`` and ``test_torch_obs_serving.py`` apply it to
  the port's and the JAX package's training and serving runs.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.tools import obs_report
from induction_network_on_fewrel_tpu_torch.utils.flops import train_step_flops
from induction_network_on_fewrel_tpu_torch.utils.roofline import H100_BF16_FLOPS

REPO = Path(__file__).resolve().parents[1]
_TOOLS = str(REPO / "tools")
if _TOOLS not in sys.path:
    sys.path.insert(0, _TOOLS)

import obs_report as jax_obs_report  # noqa: E402

# Sections whose numbers the port computes differently by design.
DELTAS = ("mfu", "overhead")


def _json_report(mod, run_dir: Path, capsys) -> tuple[int, dict]:
    capsys.readouterr()
    rc = mod.main([str(run_dir), "--json"])
    return rc, json.loads(capsys.readouterr().out)


def assert_reports_equal(run_dir: Path, capsys) -> dict:
    """The port's ``--json`` report of ``run_dir`` equals the JAX tool's
    section by section, but ``DELTAS``; returns the port's."""
    rc, ours = _json_report(obs_report, run_dir, capsys)
    jrc, theirs = _json_report(jax_obs_report, run_dir, capsys)
    assert rc == jrc
    assert set(ours) == set(theirs)
    for section in ours:
        if section not in DELTAS:
            assert ours[section] == theirs[section], section
    return ours


# --- the schema gate --------------------------------------------------------------


GOOD = {"step": 1, "kind": "train", "wall_s": 0.5, "loss": 0.25, "device": "cpu"}
FAULTS = {
    "clean": [json.dumps(GOOD)],
    "unknown_kind": [json.dumps(GOOD), json.dumps({**GOOD, "kind": "bogus"})],
    "missing_step": [json.dumps({k: v for k, v in GOOD.items() if k != "step"})],
    "bool_step": [json.dumps({**GOOD, "step": True})],
    "non_finite": [json.dumps({**GOOD, "loss": math.nan}), json.dumps({**GOOD, "loss": "nan"})],
    "malformed_line": [json.dumps(GOOD), '{"step": 2, "kind": "train"', "[1, 2]"],
    "nested_field": [json.dumps({**GOOD, "extra": {"a": 1}})],
    "wall_s_string": [json.dumps({**GOOD, "wall_s": "0.5"})],
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_check_schema_equals_jax_on_planted_faults(tmp_path, fault, capsys):
    (tmp_path / "metrics.jsonl").write_text("\n".join(FAULTS[fault]) + "\n\n")
    ours = obs_report.check_schema(tmp_path / "metrics.jsonl")
    assert ours == jax_obs_report.check_schema(tmp_path / "metrics.jsonl")
    assert (ours[1] == []) == (fault in ("clean", "non_finite"))
    rc = obs_report.main([str(tmp_path), "--check"])
    out = capsys.readouterr()
    assert rc == jax_obs_report.main([str(tmp_path), "--check"])
    assert rc == (0 if not ours[1] else 1)
    assert out.out.startswith("OK:" if rc == 0 else "FAIL:")
    assert obs_report.load_records(tmp_path / "metrics.jsonl") == \
        jax_obs_report.load_records(tmp_path / "metrics.jsonl")


def test_missing_stream_exits_2(tmp_path):
    assert obs_report.main([str(tmp_path), "--check"]) == 2
    out = subprocess.run([sys.executable, "-m", "induction_network_on_fewrel_tpu_torch.tools."
                          "obs_report", str(tmp_path / "absent")], capture_output=True,
                         text=True, cwd=REPO, timeout=60)
    assert out.returncode == 2 and "no metrics.jsonl" in out.stderr


# --- every section ----------------------------------------------------------------


def _every_kind(device: str) -> list[dict]:
    """One stream with each record shape the report's sections read."""
    recs, t = [], [0.0]

    def rec(step, kind, **kw):
        t[0] += 0.25
        recs.append({"step": step, "kind": kind, "wall_s": round(t[0], 3), **kw})

    for i, (loss, eps) in enumerate([(1.2, 40.0), (0.9, 44.0), (0.7, 46.0), (0.6, 47.5)]):
        rec(4 * (i + 1), "data", window_s=0.25, stall_s=0.01 * i, produce_s=0.2, queue_depth=2.0,
            produced=4.0 * (i + 1), consumed=4.0 * (i + 1), producer_alive=1.0, poisoned=0.0)
        rec(4 * (i + 1), "train", episodes_per_s=eps, loss=loss, accuracy=0.5, device=device)
        rec(4 * (i + 1), "roofline", step_mb=12.5, step_bytes=12.5e6, lstm_residual_bytes=1e5,
            lstm_cs_window=8.0)
        rec(4 * (i + 1), "perf", window_s=0.25, step_ms=62.5, data_wait_ms=10.0,
            host_dispatch_ms=40.0, device_sync_ms=12.5, checkpoint_ms=0.0, eval_ms=0.0,
            probe_ms=0.0, other_ms=0.0, compiles=float(i == 0), compile_ms=3.0 * (i == 0),
            gc_ms=0.5, oob=float(i == 3), cause="data_wait" if i == 3 else "",
            floor_ms=1.5, device_over_floor=2.0 + i)
        rec(4 * (i + 1), "comms", wire_mb_per_step=0.0, dp=1.0)
    rec(1, "compile", fn="train_step", phase="warmup", elapsed_ms=120.5, trigger="first")
    rec(9, "compile", fn="eval_step", phase="recompile", elapsed_ms=30.0, trigger="shape")
    rec(8, "val", accuracy=0.61234, acc_ci95=0.0312, nota_precision=0.5, nota_recall=0.25)
    rec(16, "test", accuracy=0.6, acc_ci95=0.04)
    rec(8, "ckpt", event="ring_save", mode="base", bytes=4.0e6, rows=50.0)
    rec(16, "ckpt", event="ring_save", mode="delta", bytes=2.0e5, rows=12.0)
    rec(17, "data", stalled_s=0.75, producer_alive=1.0)
    for tenant, p50 in (("a", 1.5), ("b", 2.5)):
        rec(20, "serve", tenant=tenant, served=10.0, rejected=0.0, shed=1.0,
            deadline_missed=0.0, p50_ms=p50, p99_ms=4 * p50)
        rec(20, "quality", tenant=tenant, served=10.0, nota_rate=0.1, margin_p50=0.4,
            entropy_p50=0.9)
        rec(20, "quality", tenant=tenant, probe="drift", window=8.0, latched=0.0,
            nota_rate_base=0.1, nota_rate_cur=0.2, nota_rate_band=0.05, margin_base=0.4,
            margin_cur=0.3, margin_band=0.05, entropy_base=0.9, entropy_cur=1.0,
            entropy_band=0.1)
    rec(20, "serve", served=20.0, rejected=0.0, shed=2.0, deadline_missed=1.0, batches=6.0,
        batch_occupancy=0.8, p50_ms=2.0, p99_ms=9.0, queue_depth=0.0, steady_recompiles=0.0,
        swaps=1.0)
    rec(21, "serve", event="snapshot_swap", params_version=1.0)
    for i in range(3):
        rec(22 + i, "trace", trace_id=f"t{i}", tenant="a", scheduler="continuous",
            bucket=4.0, queue_ms=0.5, pack_ms=0.1, execute_ms=1.0 + i, respond_ms=0.05,
            total_ms=1.65 + i + (0.5 if i == 2 else 0.0))
    rec(25, "trace", trace_id="p1", op="publish", publish_ms=12.5, params_version=1.0)
    rec(26, "health", event="slo_fast_burn", severity="critical", tenant="a", burn_fast=14.4,
        burn_slow=2.0, message="burn")
    rec(27, "health", event="prediction_drift", severity="critical", tenant="a",
        feature="nota_rate", current=0.5, baseline=0.1, band=0.05, message="drift")
    rec(28, "health", event="drift_rearm", severity="warning", message="rearm")
    rec(28, "health", event="grad_probe", severity="info", grad_cosine=0.9991)
    rec(29, "health", event="recompile_burst", severity="warning", message="burst")
    for leg, extra in (("in_domain", {}), ("cross_domain", {"shift": 0.5}),
                       ("cross_domain", {"shift": 1.0}), ("nota_calibration", {"na_rate": 1.0})):
        rec(30, "scenario", leg=leg, accuracy=0.8 - extra.get("shift", 0.0) / 4,
            acc_ci95=0.02, best_f1=0.7, best_tau=0.3, **extra)
    for action, kw in (("inject", {"point": "serve.execute_raise"}),
                       ("inject", {"point": "ckpt.bitflip"}),
                       ("ckpt_quarantine", {"ckpt_kind": "latest", "ckpt_step": 8.0,
                                            "reason": "digest"}),
                       ("breaker", {"tenant": "a", "to": "open"}),
                       ("breaker", {"tenant": "a", "to": "closed"}),
                       ("publish_rollback", {"reason": "non-finite"}),
                       ("execute_error", {"requests": 3.0}),
                       ("degraded_verdicts", {"served": 2.0}),
                       ("replica_dead", {"replica": "r1"}),
                       ("recovered", {"tenants": 4.0, "reregistered": 4.0, "unplaceable": 0.0,
                                      "unreachable": 0.0, "caught_up": 1.0,
                                      "params_version": 2.0, "journal_records": 12.0,
                                      "snapshot_seq": 3.0}),
                       ("catchup", {"replica": "r2", "from_version": 1.0, "to_version": 2.0}),
                       ("replica_restarted", {"replica": "r1", "ok": 1.0}),
                       ("replica_restarted", {"replica": "r1", "ok": 0.0}),
                       ("replica_restart_exhausted", {"replica": "r1"}),
                       ("journal_truncated", {"reason": "torn", "bytes_dropped": 17.0,
                                              "records_kept": 11.0}),
                       ("scale_stuck", {"direction": "out", "replica": "r3", "reason": "warm",
                                        "waited_s": 2.0, "budget_s": 1.0})):
        rec(31, "fault", action=action, **kw)
    for action, kw in (("trigger", {}), ("train", {"ok": 1.0, "train_s": 3.5}),
                       ("canary", {"passed": 1.0}),
                       ("publish", {"ok": 1.0, "publish_s": 0.4, "params_version": 2.0}),
                       ("verified", {"recover_s": 9.5}), ("train", {"ok": 0.0}),
                       ("canary", {"passed": 0.0}), ("rollback", {}), ("exhausted", {})):
        rec(32, "adapt", tenant="a" if action not in ("exhausted",) else "b", action=action, **kw)
    rec(33, "fleet", replicas=3.0, live=3.0, dead=0.0, tenants=4.0, submitted=40.0, shed=1.0,
        degraded_served=0.0, replica_deaths=0.0, replaced=2.0, pending_failover=0.0,
        proc_role="router", proc_pid=123.0)
    for rid in ("r0", "r1"):
        rec(33, "fleet", replica=rid, state="up", routed=20.0, qps=5.0, served=20.0,
            p50_ms=1.0, p99_ms=3.0, batch_occupancy=0.5, steady_recompiles=0.0,
            queue_depth=0.0, breaker="closed")
    rec(34, "fleet", event="fanout_publish", publish_s=0.7, replicas=3.0, params_version=2.0)
    rec(35, "fleet", event="replace", moved=2.0)
    rec(36, "fleet", event="journal_compact", snapshot_seq=3.0)
    for i in range(2):
        rec(37, "hop", trace_id=f"h{i}", replica=f"r{i}", route_ms=0.1, queue_ms=0.2,
            wire_ms=0.3, remote_ms=1.0, respond_ms=0.1, router_ms=1.7, hop_ms=0.7,
            offset_ms=0.25 * i)
    for i, (n, p, idle) in enumerate([(2, 1.0, 0.0), (3, 1.0, 0.0), (3, 0.0, 1.0)]):
        rec(38 + i, "scale", replicas=float(n), pressure=p, idle=idle)
    rec(41, "scale", event="scale_out", replica="r2", warm_compiles=3.0, moved=1.0, replicas=3.0)
    rec(42, "scale", event="drain_in", replica="r2", moved=1.0, replicas=2.0)
    rec(43, "scale", event="tail", applied=5.0)
    rec(44, "scale", event="promotion", promote_s=0.3, tenants=4.0, replicas=2.0,
        lease_epoch=2.0, final_tail_ops=1.0)
    return recs


def _write_run(run: Path, device: str, cfg: ExperimentConfig) -> None:
    run.mkdir(parents=True, exist_ok=True)
    (run / "metrics.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in _every_kind(device)))
    (run / "config.json").write_text(cfg.to_json())
    (run / "flight_recorder.json").write_text(json.dumps(
        {"reason": "watchdog", "dump_count": 1, "events": [{}], "metrics": [{}, {}],
         "spans": []}))


@pytest.mark.parametrize("device", ["cpu", "NVIDIA H100 80GB HBM3"])
def test_every_section_equals_jax(tmp_path, device, capsys):
    cfg = ExperimentConfig(compute_dtype="bfloat16")
    _write_run(tmp_path, device, cfg)
    ours = assert_reports_equal(tmp_path, capsys)
    for section in ("train", "eval", "perf", "compile", "serve", "fleet", "hops", "elasticity",
                    "adapt", "faults", "recovery", "traces", "slo", "quality", "scenarios",
                    "ckpt", "input_pipeline", "comms", "roofline", "health",
                    "flight_recorder"):
        assert ours[section], section
    assert "components_mb" in ours["roofline"]
    flops = train_step_flops(cfg)["per_episode"]
    mfu = ours["mfu"]
    assert mfu["flops_per_episode"] == flops
    assert mfu["achieved_flops_per_s"] == round(ours["train"]["eps_mean"] * flops, 3)
    if device == "cpu":
        assert "mfu" not in mfu and "device_kind" not in mfu
    else:
        assert mfu["device_kind"] == device
        assert mfu["mfu"] == round(ours["train"]["eps_mean"] * flops / H100_BF16_FLOPS, 4)
    assert obs_report.render(ours) == jax_obs_report.render(ours)


def test_overhead_and_text_mode_as_a_program(tmp_path):
    _write_run(tmp_path, "cpu", ExperimentConfig())
    out = subprocess.run([sys.executable, "-m",
                          "induction_network_on_fewrel_tpu_torch.tools.obs_report",
                          str(tmp_path), "--overhead"], capture_output=True, text=True,
                         cwd=REPO, timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith(f"== run report: {tmp_path} ==")
    assert "-- overhead --" in out.stdout and "span_cost_us" in out.stdout
