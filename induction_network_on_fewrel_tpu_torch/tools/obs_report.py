"""Render one run report from a run directory's telemetry stream, and
check its schema: the port of the JAX repository's ``tools/obs_report.py``.

Input: a run directory holding ``metrics.jsonl`` (training and serving
write it), and where present ``flight_recorder.json`` (``obs/recorder.py``)
and ``config.json`` (a checkpoint directory: the roofline table and the
analytic MFU).

Modes:

* default        the human-readable report: p50/p99 step time, the
                 episodes/s trend, MFU, eval accuracy with its CI, serving
                 percentiles, request-trace waterfalls (segments checked
                 within 5 % of the measured latency), SLO burns, the
                 prediction-quality and drift tables, scenario legs, the
                 step-time decomposition and capture forensics, the fleet,
                 hop, elasticity, adaptation, fault and recovery ledgers,
                 health events and the flight recorder. The stream is
                 schema-checked first; a malformed stream is a finding.
* ``--check``    schema validation only; exit 1 on any violation.
* ``--json``     the report as one JSON object.
* ``--overhead`` the span enter/exit cost (a ``timed_call`` A/B) as a
                 fraction of the run's own p50 step time.

Every section equals the JAX tool's on the same directory but two: ``mfu``
reads the card a run trained on from its ``kind="train"`` records
(``device``, ``torch.cuda.get_device_name`` at train time) and reports MFU
against that card's dense peak (``utils/flops.peak_flops_per_chip``: the
H100's); a CPU run reports none, as the JAX tool off the TPU. ``overhead``
is a timing. Rendering and the checks are host work: no device is touched.

Run: ``python -m induction_network_on_fewrel_tpu_torch.tools.obs_report
RUN_DIR [--check] [--json] [--overhead]``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

# One home for the tiled-segment list (obs/perf.py): a segment added there
# must be summed here, or tiles_ok_frac reports a false violation.
from induction_network_on_fewrel_tpu_torch.obs.perf import TILE_SEGMENTS as PERF_SEGMENTS
from induction_network_on_fewrel_tpu_torch.utils.metrics import KNOWN_KINDS


# --- schema check ---------------------------------------------------------

def check_schema(path: Path, max_errors: int = 20) -> tuple[int, list[str]]:
    """Validate metrics.jsonl: one JSON object per line with step (int),
    kind (known), wall_s (number), and scalar (number/str) fields.
    Returns (record_count, errors)."""
    errors: list[str] = []
    n = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            if len(errors) >= max_errors:
                errors.append("... (further errors suppressed)")
                break
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"line {lineno}: not JSON ({e.msg})")
                continue
            if not isinstance(rec, dict):
                errors.append(f"line {lineno}: not a JSON object")
                continue
            n += 1
            step = rec.get("step")
            if not isinstance(step, int) or isinstance(step, bool):
                errors.append(f"line {lineno}: step must be an int, got {step!r}")
            kind = rec.get("kind")
            if kind not in KNOWN_KINDS:
                errors.append(
                    f"line {lineno}: unknown kind {kind!r} "
                    f"(known: {sorted(KNOWN_KINDS)})"
                )
            if not isinstance(rec.get("wall_s"), (int, float)):
                errors.append(f"line {lineno}: wall_s must be a number")
            for k, v in rec.items():
                if k in ("step", "kind", "wall_s"):
                    continue
                if not isinstance(v, (int, float, str)):
                    errors.append(
                        f"line {lineno}: field {k!r} must be scalar/str, "
                        f"got {type(v).__name__}"
                    )
    return n, errors


# --- aggregation ----------------------------------------------------------

def _percentile(xs: list[float], q: float) -> float:
    """Nearest-rank percentile (same convention as serving/stats.py)."""
    s = sorted(xs)
    i = min(len(s) - 1, max(0, int(round(q / 100.0 * len(s))) - 1))
    return s[i]


def load_records(path: Path) -> list[dict]:
    recs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    recs.append(json.loads(line))
                except json.JSONDecodeError:
                    pass  # counted by check_schema; aggregation skips
    return recs


def _process_identity(recs: list[dict]) -> str | None:
    """The per-process identity column: multi-process fleet
    streams stamp proc_role/proc_replica/proc_pid on every record
    (utils/metrics.MetricsLogger.set_identity). Folded to one string per
    distinct process; single-process runs (no identity set) carry no
    column."""
    seen: dict[tuple, None] = {}
    for r in recs:
        role = r.get("proc_role")
        if not isinstance(role, str):
            continue
        key = (role, r.get("proc_replica"), r.get("proc_pid"))
        seen.setdefault(key, None)
    if not seen:
        return None
    parts = []
    for role, replica, pid in seen:
        tag = f"{role}/{replica}" if isinstance(replica, str) else role
        parts.append(f"{tag} pid={int(pid)}" if isinstance(
            pid, (int, float)) else tag)
    return ", ".join(parts)


def train_summary(recs: list[dict]) -> dict | None:
    """Per-window step times from consecutive train records: each record
    logs at wall_s having advanced `step`; dt/dstep is the honest
    per-step wall time for that window (includes host feed + dispatch)."""
    train = [r for r in recs if r.get("kind") == "train"]
    if not train:
        return None
    step_times, eps = [], []
    for prev, cur in zip(train, train[1:]):
        dstep = cur.get("step", 0) - prev.get("step", 0)
        dwall = cur.get("wall_s", 0.0) - prev.get("wall_s", 0.0)
        if dstep > 0 and dwall > 0:
            step_times.append(dwall / dstep)
    eps = [
        float(r["episodes_per_s"]) for r in train
        if isinstance(r.get("episodes_per_s"), (int, float))
        and math.isfinite(r["episodes_per_s"])
    ]
    out = {
        "records": len(train),
        "first_step": train[0].get("step"),
        "last_step": train[-1].get("step"),
    }
    if step_times:
        out["step_time_p50_s"] = round(_percentile(step_times, 50), 6)
        out["step_time_p99_s"] = round(_percentile(step_times, 99), 6)
    if eps:
        out["eps_mean"] = round(sum(eps) / len(eps), 2)
        out["eps_min"] = round(min(eps), 2)
        out["eps_max"] = round(max(eps), 2)
        half = len(eps) // 2
        if half:
            first = sum(eps[:half]) / half
            second = sum(eps[half:]) / (len(eps) - half)
            out["eps_trend"] = round(second / first, 4) if first > 0 else None
    losses = [
        r["loss"] for r in train
        if isinstance(r.get("loss"), (int, float)) and math.isfinite(r["loss"])
    ]
    if losses:
        out["loss_first"] = round(losses[0], 6)
        out["loss_last"] = round(losses[-1], 6)
    return out


def eval_summary(recs: list[dict]) -> dict | None:
    evals = [r for r in recs if r.get("kind") in ("val", "eval", "test")]
    if not evals:
        return None
    last = evals[-1]
    out = {"records": len(evals), "last_step": last.get("step")}
    for k in ("accuracy", "acc_ci95", "nota_precision", "nota_recall"):
        if isinstance(last.get(k), (int, float)):
            out[k] = round(last[k], 4)
    return out


def serve_summary(recs: list[dict]) -> dict | None:
    """Serving section: the aggregate stream is
    the records WITHOUT a ``tenant`` field; per-tenant records restate the
    counters tenant-by-tenant (one kind="serve" record per tenant per emit
    — serving/stats.ServingStats.emit), and ``event`` records mark
    control-plane actions (hot-swap publishes). The section renders the
    aggregate headline, a per-tenant p50/p99 table, and shed/swap event
    counts."""
    serves = [r for r in recs if r.get("kind") == "serve"]
    if not serves:
        return None
    events = [r for r in serves if isinstance(r.get("event"), str)]
    tenant_recs = [
        r for r in serves
        if isinstance(r.get("tenant"), str) and not isinstance(
            r.get("event"), str
        )
    ]
    aggregate = [
        r for r in serves
        if not isinstance(r.get("event"), str)
        and not isinstance(r.get("tenant"), str)
    ]
    out: dict = {"records": len(serves)}
    proc = _process_identity(serves)
    if proc:
        out["process"] = proc
    if aggregate:
        last = aggregate[-1]
        out.update({
            k: last[k] for k in (
                "served", "rejected", "shed", "deadline_missed", "batches",
                "batch_occupancy", "p50_ms", "p99_ms", "queue_depth",
                "steady_recompiles", "swaps",
            ) if k in last
        })
    if tenant_recs:
        # Last record per tenant is that tenant's current counters.
        by_tenant: dict[str, dict] = {}
        for r in tenant_recs:
            by_tenant[r["tenant"]] = {
                k: r[k] for k in (
                    "served", "rejected", "shed", "deadline_missed",
                    "p50_ms", "p99_ms",
                ) if k in r
            }
        out["tenants"] = {t: by_tenant[t] for t in sorted(by_tenant)}
    swaps = [r for r in events if r.get("event") == "snapshot_swap"]
    if swaps:
        out["swap_events"] = len(swaps)
        last_swap = swaps[-1]
        if isinstance(last_swap.get("params_version"), (int, float)):
            out["params_version"] = int(last_swap["params_version"])
    return out


def ckpt_summary(recs: list[dict]) -> dict | None:
    """Ring-save telemetry (kind="ckpt"): how many boundary saves
    ran in each mode and what the steady-state payload is — the delta-ring
    byte diet, read straight off the stream."""
    saves = [
        r for r in recs
        if r.get("kind") == "ckpt" and r.get("event") == "ring_save"
    ]
    if not saves:
        return None
    by_mode: dict[str, int] = {}
    for s in saves:
        by_mode[str(s.get("mode"))] = by_mode.get(str(s.get("mode")), 0) + 1
    out = {"records": len(saves), "by_mode": by_mode}
    last = saves[-1]
    if isinstance(last.get("bytes"), (int, float)):
        out["last_bytes"] = int(last["bytes"])
        out["last_mode"] = last.get("mode")
    deltas = [
        s["bytes"] for s in saves
        if s.get("mode") == "delta" and isinstance(s.get("bytes"), (int, float))
    ]
    fulls = [
        s["bytes"] for s in saves
        if s.get("mode") in ("full", "base")
        and isinstance(s.get("bytes"), (int, float))
    ]
    if deltas:
        out["delta_bytes_mean"] = int(sum(deltas) / len(deltas))
    if deltas and fulls:
        # The headline ratio: steady-state delta payload vs a full save.
        out["delta_over_full"] = round(
            (sum(deltas) / len(deltas)) / max(fulls), 4
        )
    rows = [
        s["rows"] for s in saves
        if isinstance(s.get("rows"), (int, float))
    ]
    if rows:
        out["rows_last"] = int(rows[-1])
    return out


def data_summary(recs: list[dict]) -> dict | None:
    """Input-pipeline section (kind="data"): the headline is the
    feed stall fraction — consumer seconds blocked on the queue over the
    windows' wall seconds (acceptance: < 2% of step time with prefetch
    enabled). Window records carry window_s; stall ticks (emitted while
    blocked) carry stalled_s and no window_s — they contribute context
    (producer liveness, poison counts) but not the fraction's denominator."""
    data = [r for r in recs if r.get("kind") == "data"]
    if not data:
        return None
    windows = [
        r for r in data
        if isinstance(r.get("window_s"), (int, float)) and r["window_s"] > 0
    ]
    out = {"records": len(data), "windows": len(windows)}
    if windows:
        stall = sum(float(r.get("stall_s", 0.0)) for r in windows)
        wall = sum(float(r["window_s"]) for r in windows)
        produce = sum(float(r.get("produce_s", 0.0)) for r in windows)
        out["stall_s_total"] = round(stall, 4)
        out["produce_s_total"] = round(produce, 4)
        out["feed_stall_frac"] = round(stall / wall, 6) if wall > 0 else None
        depths = [
            float(r["queue_depth"]) for r in windows
            if isinstance(r.get("queue_depth"), (int, float))
        ]
        if depths:
            out["queue_depth_mean"] = round(sum(depths) / len(depths), 3)
    last = data[-1]
    for k in ("produced", "consumed", "queue_depth", "episodes_buffered",
              "producer_alive", "poisoned"):
        if isinstance(last.get(k), (int, float)):
            out[k] = last[k]
    stalls = [r for r in data if "stalled_s" in r]
    if stalls:
        out["stall_ticks"] = len(stalls)
        out["longest_stall_s"] = round(
            max(float(r.get("stalled_s", 0.0)) for r in stalls), 3
        )
    return out


def comms_summary(recs: list[dict]) -> dict | None:
    """Collective-traffic section (kind="comms"): the headline is
    wire_mb_per_step, the bytes every data-parallel training step puts on
    the interconnect per device (the JAX package's comms ledger; the port
    logs no such record until it runs data parallel).
    The records are per-window restatements of a per-step constant, so
    the LAST record is the truth; a mid-run change (it would take a
    restart with different dp/compact_demb) would show in the count."""
    comms = [r for r in recs if r.get("kind") == "comms"]
    if not comms:
        return None
    last = comms[-1]
    out = {"records": len(comms)}
    for k in ("wire_mb_per_step", "payload_bytes_per_step",
              "wire_bytes_per_step", "dp", "compact_demb", "demb_u_rows"):
        if isinstance(last.get(k), (int, float)):
            out[k] = last[k]
    return out


def roofline_summary(recs: list[dict], run_dir: Path) -> dict | None:
    """HBM-roofline section (kind="roofline"): the headline is step_mb,
    analytic HBM bytes per train step at this config's residual knobs
    (utils/roofline.step_bytes). Per-window restatements of a per-step
    constant, so the LAST record is the truth. When the run dir carries a
    config.json the per-component byte table is rebuilt from the same
    formulas."""
    rl = [r for r in recs if r.get("kind") == "roofline"]
    if not rl:
        return None
    last = rl[-1]
    out = {"records": len(rl)}
    for k in ("step_mb", "step_bytes", "lstm_residual_bytes",
              "lstm_cs_window", "corpus_rows"):
        if isinstance(last.get(k), (int, float)):
            out[k] = last[k]
    cfg_path = run_dir / "config.json"
    if cfg_path.exists():
        try:
            from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
            from induction_network_on_fewrel_tpu_torch.utils.roofline import step_components

            cfg = ExperimentConfig.from_json(cfg_path.read_text())
            # Same corpus bound as the headline (the record carries it on
            # real-corpus lazy runs), else the table's demb/optimizer rows
            # fall back to the synthetic default and stop summing to step_mb.
            u_rows = last.get("corpus_rows")
            out["components_mb"] = {
                name: round(b / 1e6, 1)
                for name, b, _ in step_components(
                    cfg, corpus_rows=int(u_rows) if u_rows else None)
            }
        except Exception as e:  # noqa: BLE001 — the table is best-effort; the headline stands
            out["components_error"] = f"{type(e).__name__}: {e}"
    return out


def perf_summary(recs: list[dict]) -> dict | None:
    """Step-time decomposition section (kind="perf"): per-window
    segments that tile the measured window (obs/perf.py). Headlines: the
    median segment fractions (where the wall time goes), the tile check
    (fraction of windows whose segments sum to window_s within 5% — the
    acceptance bar; by construction it should be 1.0), out-of-band window
    count and the cause table, and the roofline-floor comparison when the
    stream carries it."""
    perf = [
        r for r in recs
        if r.get("kind") == "perf"
        and isinstance(r.get("window_s"), (int, float))
    ]
    if not perf:
        return None
    out: dict = {"windows": len(perf)}

    def med(key: str) -> float | None:
        xs = [
            float(r[key]) for r in perf
            if isinstance(r.get(key), (int, float))
        ]
        return round(_percentile(xs, 50), 4) if xs else None

    out["step_ms_p50"] = med("step_ms")
    total_ms = sum(float(r["window_s"]) for r in perf) * 1e3
    if total_ms > 0:
        for seg in PERF_SEGMENTS:
            seg_ms = sum(float(r.get(f"{seg}_ms", 0.0)) for r in perf)
            out[f"{seg}_frac"] = round(seg_ms / total_ms, 4)
    tiles_ok = sum(
        1 for r in perf
        if abs(
            sum(float(r.get(f"{s}_ms", 0.0)) for s in PERF_SEGMENTS)
            - float(r["window_s"]) * 1e3
        ) <= 0.05 * float(r["window_s"]) * 1e3
    )
    out["tiles_ok_frac"] = round(tiles_ok / len(perf), 4)
    compiles = sum(float(r.get("compiles", 0.0)) for r in perf)
    if compiles:
        out["window_compiles"] = int(compiles)
        out["compile_ms_total"] = round(
            sum(float(r.get("compile_ms", 0.0)) for r in perf), 3
        )
    gc_ms = sum(float(r.get("gc_ms", 0.0)) for r in perf)
    if gc_ms:
        out["gc_ms_total"] = round(gc_ms, 3)
    oob = [r for r in perf if r.get("oob")]
    out["oob_windows"] = len(oob)
    if oob:
        by_cause: dict[str, int] = {}
        for r in oob:
            c = str(r.get("cause"))
            by_cause[c] = by_cause.get(c, 0) + 1
        out["causes"] = by_cause
    floor = med("floor_ms")
    if floor is not None:
        out["floor_ms"] = floor
        out["device_over_floor_p50"] = med("device_over_floor")
    return out


def compile_summary(recs: list[dict]) -> dict | None:
    """Compile-forensics section (kind="compile"): one record
    per observed capture (obs/compile.py: on the card, a CUDA-graph
    capture or a kernel build; a CPU run logs none). Headlines: counts by
    phase (warmup / recompile / dup), total compile seconds, the
    steady-state verdict (any post-arm gated recompile is the invariant
    breach — surfaced via the recompile_burst health event), and the
    slowest compiles with their triggers."""
    comps = [r for r in recs if r.get("kind") == "compile"]
    if not comps:
        return None
    by_phase: dict[str, int] = {}
    for c in comps:
        p = str(c.get("phase"))
        by_phase[p] = by_phase.get(p, 0) + 1
    out: dict = {"records": len(comps), "by_phase": by_phase}
    elapsed = [
        float(c["elapsed_ms"]) for c in comps
        if isinstance(c.get("elapsed_ms"), (int, float))
    ]
    if elapsed:
        out["compile_ms_total"] = round(sum(elapsed), 3)
    bursts = [
        r for r in recs
        if r.get("kind") == "health" and r.get("event") == "recompile_burst"
    ]
    out["recompile_bursts"] = len(bursts)
    slow = sorted(
        (c for c in comps if isinstance(c.get("elapsed_ms"), (int, float))),
        key=lambda c: -float(c["elapsed_ms"]),
    )[:3]
    if slow:
        out["slowest"] = [
            f"{c.get('fn')} {float(c['elapsed_ms']):.1f}ms "
            f"step={c.get('step')} trigger={c.get('trigger')} "
            f"phase={c.get('phase')}"
            for c in slow
        ]
    return out


SEGMENTS = ("queue", "pack", "execute", "respond")


def _waterfall_lines(t: dict, width: int = 32) -> list[str]:
    """One request trace -> ASCII waterfall: each segment drawn at its
    offset within [0, total_ms], so the eye reads WHERE the latency went
    (a long leading gap = queueing; a long tail = device execute)."""
    total = float(t.get("total_ms") or 0.0)
    segs = [(s, float(t.get(f"{s}_ms", 0.0))) for s in SEGMENTS]
    ssum = sum(d for _, d in segs)
    ok = total > 0 and abs(ssum - total) <= 0.05 * total
    head = (
        f"trace {t.get('trace_id')} tenant={t.get('tenant')} "
        f"scheduler={t.get('scheduler')} bucket={int(t.get('bucket', 0))} "
        f"total={total:.3f}ms (segments sum {ssum:.3f}ms, "
        f"{'ok' if ok else 'MISMATCH > 5%'})"
    )
    lines = [head]
    scale = width / total if total > 0 else 0.0
    offset = 0.0
    for name, dur in segs:
        a = int(round(offset * scale))
        b = max(a + 1, int(round((offset + dur) * scale)))
        bar = " " * a + "#" * min(b - a, width - a)
        lines.append(f"  {name:<8}{dur:9.3f}ms |{bar:<{width}}|")
        offset += dur
    return lines


def trace_summary(recs: list[dict]) -> dict | None:
    """Request-scoped tracing section (kind="trace"): sampled
    per-request segment records from the serving data plane. Headlines:
    segment medians (which stage owns the latency), the fraction of
    traces whose segments sum to the measured end-to-end latency within
    5% (the tentpole's consistency bar), and a rendered waterfall of the
    slowest sampled request. Control-plane records (op="publish") are
    counted separately."""
    traces = [
        r for r in recs
        if r.get("kind") == "trace"
        and isinstance(r.get("total_ms"), (int, float))
    ]
    control = [r for r in recs if r.get("kind") == "trace" and r.get("op")]
    if not traces and not control:
        return None
    out: dict = {"records": len(traces) + len(control)}
    proc = _process_identity(traces)
    if proc:
        out["process"] = proc
    if traces:
        out["sampled_requests"] = len(traces)

        def med(key: str) -> float | None:
            xs = [
                float(r[key]) for r in traces
                if isinstance(r.get(key), (int, float))
            ]
            return round(_percentile(xs, 50), 3) if xs else None

        for s in SEGMENTS:
            out[f"{s}_ms_p50"] = med(f"{s}_ms")
        out["total_ms_p50"] = med("total_ms")
        sums_ok = sum(
            1 for r in traces
            if r["total_ms"] > 0 and abs(
                sum(float(r.get(f"{s}_ms", 0.0)) for s in SEGMENTS)
                - float(r["total_ms"])
            ) <= 0.05 * float(r["total_ms"])
        )
        out["segments_sum_ok_frac"] = round(sums_ok / len(traces), 4)
        by_tenant: dict[str, int] = {}
        for r in traces:
            tn = str(r.get("tenant"))
            by_tenant[tn] = by_tenant.get(tn, 0) + 1
        out["by_tenant"] = by_tenant
        slowest = max(traces, key=lambda r: float(r["total_ms"]))
        out["waterfall"] = _waterfall_lines(slowest)
    if control:
        out["control_records"] = len(control)
        last = control[-1]
        if isinstance(last.get("publish_ms"), (int, float)):
            out["last_publish_ms"] = last["publish_ms"]
    return out


def slo_summary(recs: list[dict]) -> dict | None:
    """SLO burn-rate section: kind="health" events named
    slo_fast_burn / slo_slow_burn, grouped per tenant with the latest
    burn rates — the at-a-glance "who is burning budget" table."""
    events = [
        r for r in recs
        if r.get("kind") == "health"
        and str(r.get("event", "")).startswith("slo_")
    ]
    if not events:
        return None
    out: dict = {"records": len(events)}
    by_tenant: dict[str, dict] = {}
    for e in events:
        tn = str(e.get("tenant"))
        row = by_tenant.setdefault(tn, {"events": 0})
        row["events"] += 1
        row["last_event"] = e.get("event")
        row["severity"] = e.get("severity")
        for k in ("burn_fast", "burn_slow"):
            if isinstance(e.get(k), (int, float)):
                row[k] = e[k]
    out["tenants"] = {t: by_tenant[t] for t in sorted(by_tenant)}
    return out


def quality_summary(recs: list[dict]) -> dict | None:
    """Prediction-quality section (kind="quality"): two record
    shapes split on the ``probe`` field — per-tenant TRAFFIC records
    (serving/stats.quality_snapshot: nota_rate / margin_p50 /
    entropy_p50) and DRIFT-STATE records (obs/drift.emit: baseline vs
    current vs band per feature). Headlines: the per-tenant quality
    table, the drift table, and prediction_drift / drift_rearm health
    event counts."""
    quality = [r for r in recs if r.get("kind") == "quality"]
    drift_events = [
        r for r in recs
        if r.get("kind") == "health"
        and r.get("event") in ("prediction_drift", "drift_rearm")
    ]
    if not quality and not drift_events:
        return None
    out: dict = {"records": len(quality)}
    traffic = [r for r in quality if r.get("probe") != "drift"]
    drift = [r for r in quality if r.get("probe") == "drift"]
    if traffic:
        by_tenant: dict[str, dict] = {}
        for r in traffic:
            if isinstance(r.get("tenant"), str):
                by_tenant[r["tenant"]] = {
                    k: r[k] for k in
                    ("served", "nota_rate", "margin_p50", "entropy_p50")
                    if k in r
                }
        if by_tenant:
            out["tenants"] = {t: by_tenant[t] for t in sorted(by_tenant)}
    if drift:
        by_tenant = {}
        for r in drift:
            if isinstance(r.get("tenant"), str):
                by_tenant[r["tenant"]] = {
                    k: r[k] for k in (
                        "window", "latched",
                        "nota_rate_base", "nota_rate_cur", "nota_rate_band",
                        "margin_base", "margin_cur", "margin_band",
                        "entropy_base", "entropy_cur", "entropy_band",
                    ) if k in r
                }
        if by_tenant:
            out["drift"] = {t: by_tenant[t] for t in sorted(by_tenant)}
    drifts = [e for e in drift_events if e.get("event") == "prediction_drift"]
    if drifts:
        out["drift_events"] = len(drifts)
        last = drifts[-1]
        out["last_drift"] = (
            f"{last.get('severity')}: tenant={last.get('tenant')} "
            f"feature={last.get('feature')} "
            f"current={last.get('current')} vs baseline="
            f"{last.get('baseline')} (band {last.get('band')})"
        )
    rearms = [e for e in drift_events if e.get("event") == "drift_rearm"]
    if rearms:
        out["rearms"] = len(rearms)
    return out


def scenario_summary(recs: list[dict]) -> dict | None:
    """Scenario-harness section (kind="scenario"): one row per
    evaluated leg of the scenario harness (load/scenarios.py) — cross-domain accuracy ± CI,
    the DA-mixture recovery, NOTA calibration best-F1, adversarial
    degradation. The LAST record per leg wins (a re-run supersedes)."""
    scen = [r for r in recs if r.get("kind") == "scenario"]
    if not scen:
        return None
    by_leg: dict[str, dict] = {}
    for r in scen:
        # Distinct legs can share a leg NAME (one cross_domain record per
        # shift, one nota_calibration per na_rate): fold the discriminator
        # into the key so a grid run keeps every row instead of the last.
        leg = str(r.get("leg"))
        if isinstance(r.get("shift"), (int, float)):
            leg = f"{leg}[shift={r['shift']:g}]"
        if isinstance(r.get("na_rate"), (int, float)):
            leg = f"{leg}[na={r['na_rate']:g}]"
        by_leg[leg] = {
            k: r[k] for k in (
                "accuracy", "acc_ci95", "shift", "degradation",
                "best_f1", "best_tau", "na_rate",
                "nota_precision", "nota_recall",
            ) if k in r
        }
    out: dict = {"records": len(scen), "legs": by_leg}
    ind = by_leg.get("in_domain", {}).get("accuracy")
    cross = [
        v["accuracy"] for k, v in by_leg.items()
        if k.startswith("cross_domain")
        and isinstance(v.get("accuracy"), (int, float))
    ]
    if isinstance(ind, (int, float)) and cross:
        # Gap at the WORST shift — the headline degradation.
        out["cross_domain_gap"] = round(ind - min(cross), 4)
    return out


def fault_summary(recs: list[dict]) -> dict | None:
    """Fault-domain section (kind="fault"): injections
    (obs/chaos.py, action="inject") next to the containment they
    provoked — checkpoint quarantines, circuit-breaker transitions
    (with each tenant's LAST state), publish rollbacks, degraded-mode
    verdicts. The fault criticals (ckpt_corrupt / breaker_open /
    publish_rollback) appear in the health section; this section is the
    action-level ledger."""
    faults = [r for r in recs if r.get("kind") == "fault"]
    if not faults:
        return None
    by_action: dict[str, int] = {}
    for r in faults:
        a = str(r.get("action"))
        by_action[a] = by_action.get(a, 0) + 1
    out: dict = {"records": len(faults), "by_action": by_action}
    injected = [r for r in faults if r.get("action") == "inject"]
    if injected:
        by_point: dict[str, int] = {}
        for r in injected:
            p = str(r.get("point"))
            by_point[p] = by_point.get(p, 0) + 1
        out["injected_by_point"] = by_point
    quarantines = [r for r in faults if r.get("action") == "ckpt_quarantine"]
    if quarantines:
        out["quarantined_slots"] = [
            f"{q.get('ckpt_kind')}/{int(q.get('ckpt_step', 0))}: "
            f"{q.get('reason')}"
            for q in quarantines[-3:]
        ]
    transitions = [r for r in faults if r.get("action") == "breaker"]
    if transitions:
        last_state: dict[str, str] = {}
        opens = 0
        for r in transitions:
            last_state[str(r.get("tenant"))] = str(r.get("to"))
            opens += r.get("to") == "open"
        out["breaker_opens"] = opens
        out["breaker_last_state"] = dict(sorted(last_state.items()))
    rollbacks = [r for r in faults if r.get("action") == "publish_rollback"]
    if rollbacks:
        out["publish_rollbacks"] = len(rollbacks)
        out["last_rollback"] = str(rollbacks[-1].get("reason"))
    exec_errs = [r for r in faults if r.get("action") == "execute_error"]
    if exec_errs:
        out["execute_error_requests"] = int(sum(
            float(r.get("requests", 0)) for r in exec_errs
        ))
    degraded = [r for r in faults if r.get("action") == "degraded_verdicts"]
    if degraded:
        out["degraded_verdicts"] = int(sum(
            float(r.get("served", 0)) for r in degraded
        ))
    return out


def adapt_summary(recs: list[dict]) -> dict | None:
    """Self-healing adaptation section (kind="adapt"): the
    loop outcome table — per tenant: triggers, fine-tunes (ok/failed),
    canary passes/fails, publishes, rollbacks, verified loops, and
    whether the tenant exhausted its retry budget — with the
    time-to-recover headline (the last verified loop's trigger-to-
    back-in-band wall time) and fine-tune/publish costs."""
    adapt = [r for r in recs if r.get("kind") == "adapt"]
    if not adapt:
        return None
    out: dict = {"records": len(adapt)}
    verified = [r for r in adapt if r.get("action") == "verified"]
    if verified:
        out["time_to_recover_s"] = verified[-1].get("recover_s")
        out["verified_loops"] = len(verified)
    trains_ok = [r for r in adapt
                 if r.get("action") == "train" and r.get("ok") == 1.0]
    if trains_ok:
        out["finetune_s_last"] = trains_ok[-1].get("train_s")
    publishes = [r for r in adapt
                 if r.get("action") == "publish" and r.get("ok") == 1.0]
    if publishes:
        out["publish_s_last"] = publishes[-1].get("publish_s")
        out["last_params_version"] = publishes[-1].get("params_version")
    by_tenant: dict[str, dict] = {}
    for r in adapt:
        t = str(r.get("tenant"))
        row = by_tenant.setdefault(t, {
            "triggers": 0, "train_ok": 0, "train_fail": 0,
            "canary_pass": 0, "canary_fail": 0, "publishes": 0,
            "rollbacks": 0, "verified": 0, "exhausted": 0,
        })
        a = r.get("action")
        if a == "trigger":
            row["triggers"] += 1
        elif a == "train":
            row["train_ok" if r.get("ok") == 1.0 else "train_fail"] += 1
        elif a == "canary":
            row["canary_pass" if r.get("passed") == 1.0
                else "canary_fail"] += 1
        elif a == "publish" and r.get("ok") == 1.0:
            row["publishes"] += 1
        elif a == "rollback":
            row["rollbacks"] += 1
        elif a == "verified":
            row["verified"] += 1
        elif a == "exhausted":
            row["exhausted"] += 1
    out["loops"] = {t: by_tenant[t] for t in sorted(by_tenant)}
    exhausted = [r for r in adapt if r.get("action") == "exhausted"]
    if exhausted:
        out["exhausted_tenants"] = sorted(
            {str(r.get("tenant")) for r in exhausted}
        )
    return out


def fleet_summary(recs: list[dict]) -> dict | None:
    """Fleet-tier section (kind="fleet"): the router's
    aggregate counters, a per-replica table (state + routed + serving
    percentiles + the per-replica zero-recompile counter), placement
    churn (cumulative ``replaced`` + replace events), and the fan-out
    publish row (publish_s / replicas / params_version of the last
    all-or-nothing fleet publish). Splits the three record shapes on
    the ``replica`` and ``event`` fields — the serve-section
    discipline."""
    fleet = [r for r in recs if r.get("kind") == "fleet"]
    if not fleet:
        return None
    events = [r for r in fleet if isinstance(r.get("event"), str)]
    replica_recs = [
        r for r in fleet
        if isinstance(r.get("replica"), str)
        and not isinstance(r.get("event"), str)
    ]
    aggregate = [
        r for r in fleet
        if not isinstance(r.get("replica"), str)
        and not isinstance(r.get("event"), str)
    ]
    out: dict = {"records": len(fleet)}
    proc = _process_identity(fleet)
    if proc:
        out["process"] = proc
    if aggregate:
        last = aggregate[-1]
        out.update({
            k: last[k] for k in (
                "replicas", "live", "dead", "tenants", "submitted",
                "shed", "degraded_served", "replica_deaths", "replaced",
                "pending_failover",
            ) if k in last
        })
    if replica_recs:
        by_replica: dict[str, dict] = {}
        for r in replica_recs:   # last record per replica wins
            by_replica[r["replica"]] = {
                k: r[k] for k in (
                    "state", "routed", "qps", "served", "p50_ms", "p99_ms",
                    "batch_occupancy", "steady_recompiles", "queue_depth",
                    "breaker",
                ) if k in r
            }
        out["replica_table"] = {
            rid: by_replica[rid] for rid in sorted(by_replica)
        }
    publishes = [e for e in events if e.get("event") == "fanout_publish"]
    if publishes:
        last = publishes[-1]
        out["fanout_publishes"] = len(publishes)
        out["last_fanout"] = {
            k: last[k] for k in ("publish_s", "replicas", "params_version")
            if k in last
        }
    replaces = [e for e in events if e.get("event") == "replace"]
    if replaces:
        out["replace_events"] = len(replaces)
        out["last_replace_moved"] = replaces[-1].get("moved")
    deaths = [
        r for r in recs
        if r.get("kind") == "fault" and r.get("action") == "replica_dead"
    ]
    if deaths:
        out["replica_dead_faults"] = len(deaths)
    return out


HOP_SEGMENTS = ("route", "queue", "wire", "remote", "respond")


def hop_summary(recs: list[dict]) -> dict | None:
    """Cross-process hop section (kind="hop"): router-side
    segments per sampled routed request. Headlines: segment medians,
    router_ms / hop_ms percentiles (hop_ms = the fleet tax on top of
    the replica's own total), the tiling check (segments sum to
    router_ms within 5% — same timestamps by construction, so the bar
    should read 1.0), per-replica sample counts, and the last clock-
    offset estimate per replica (the fleet_report skew input)."""
    hops = [
        r for r in recs
        if r.get("kind") == "hop"
        and isinstance(r.get("router_ms"), (int, float))
    ]
    if not hops:
        return None
    out: dict = {"records": len(hops)}
    proc = _process_identity(hops)
    if proc:
        out["process"] = proc

    def pct(key: str, q: float) -> float | None:
        xs = [
            float(r[key]) for r in hops
            if isinstance(r.get(key), (int, float))
        ]
        return round(_percentile(xs, q), 3) if xs else None

    for s in HOP_SEGMENTS:
        out[f"{s}_ms_p50"] = pct(f"{s}_ms", 50)
    out["router_ms_p50"] = pct("router_ms", 50)
    out["router_ms_p99"] = pct("router_ms", 99)
    out["hop_ms_p50"] = pct("hop_ms", 50)
    out["hop_ms_p99"] = pct("hop_ms", 99)
    sums_ok = sum(
        1 for r in hops
        if float(r["router_ms"]) > 0 and abs(
            sum(float(r.get(f"{s}_ms", 0.0)) for s in HOP_SEGMENTS)
            - float(r["router_ms"])
        ) <= 0.05 * float(r["router_ms"])
    )
    out["segments_sum_ok_frac"] = round(sums_ok / len(hops), 4)
    by_replica: dict[str, int] = {}
    offsets: dict[str, float] = {}
    for r in hops:
        rid = str(r.get("replica"))
        by_replica[rid] = by_replica.get(rid, 0) + 1
        if isinstance(r.get("offset_ms"), (int, float)):
            offsets[rid] = float(r["offset_ms"])
    out["by_replica"] = {k: by_replica[k] for k in sorted(by_replica)}
    if any(offsets.values()):
        out["clock_offset_ms"] = {
            k: offsets[k] for k in sorted(offsets)
        }
    return out


def recovery_summary(recs: list[dict]) -> dict | None:
    """Durable-control-plane section: journal health
    (compactions, truncated tails), cold-start recoveries (tenant /
    re-registration / catch-up counts from the last
    ``action="recovered"`` record), per-replica catch-up rows, and
    supervised restart outcomes — the recovery ledger next to the
    faults section's containment ledger."""
    faults = [r for r in recs if r.get("kind") == "fault"]
    compacts = [
        r for r in recs
        if r.get("kind") == "fleet" and r.get("event") == "journal_compact"
    ]
    recovered = [r for r in faults if r.get("action") == "recovered"]
    catchups = [r for r in faults if r.get("action") == "catchup"]
    restarts = [r for r in faults
                if r.get("action") == "replica_restarted"]
    truncated = [r for r in faults
                 if r.get("action") == "journal_truncated"]
    exhausted = [r for r in faults
                 if r.get("action") == "replica_restart_exhausted"]
    if not (recovered or catchups or restarts or truncated or compacts):
        return None
    out: dict = {}
    if recovered:
        last = recovered[-1]
        out["recoveries"] = len(recovered)
        out["last_recovery"] = {
            k: int(last[k]) for k in (
                "tenants", "reregistered", "unplaceable", "unreachable",
                "caught_up", "params_version", "journal_records",
                "snapshot_seq",
            ) if k in last
        }
    if catchups:
        out["catchup_rows"] = [
            f"{c.get('replica')}: v{int(c.get('from_version', 0))} -> "
            f"v{int(c.get('to_version', 0))}"
            for c in catchups[-5:]
        ]
    if restarts:
        ok = sum(1 for r in restarts if r.get("ok") == 1.0)
        out["replica_restarts"] = {
            "ok": ok, "failed": len(restarts) - ok,
        }
    if exhausted:
        out["restart_budget_exhausted"] = sorted(
            {str(r.get("replica")) for r in exhausted}
        )
    if truncated:
        out["journal_truncations"] = len(truncated)
        out["last_truncation"] = (
            f"{truncated[-1].get('reason')} "
            f"(-{int(truncated[-1].get('bytes_dropped', 0))} B, "
            f"{int(truncated[-1].get('records_kept', 0))} records kept)"
        )
    if compacts:
        out["journal_compactions"] = len(compacts)
        out["snapshot_seq"] = compacts[-1].get("snapshot_seq")
    return out


def elasticity_summary(recs: list[dict]) -> dict | None:
    """Elasticity section (kind="scale"): the autoscaler's
    tick timeline (replica count over pressure/idle classifications),
    completed scale decisions with the trigger signals that justified
    them, standby tail progress, and promotions — next to the fleet
    section's router ledger. ``action="scale_stuck"`` faults land in
    the faults/health sections; this is the decision ledger."""
    scale = [r for r in recs if r.get("kind") == "scale"]
    if not scale:
        return None
    ticks = [r for r in scale if "event" not in r]
    outs = [r for r in scale if r.get("event") == "scale_out"]
    drains = [r for r in scale if r.get("event") == "drain_in"]
    tails = [r for r in scale if r.get("event") == "tail"]
    promos = [r for r in scale if r.get("event") == "promotion"]
    stuck = [r for r in recs if r.get("kind") == "fault"
             and r.get("action") == "scale_stuck"]
    out: dict = {"ticks": len(ticks)}
    if ticks:
        counts = [int(r.get("replicas", 0)) for r in ticks]
        out["replicas"] = (
            f"{counts[-1]} now (min {min(counts)}, max {max(counts)} "
            f"over {len(ticks)} ticks)"
        )
        out["pressure_ticks"] = sum(
            1 for r in ticks if r.get("pressure") == 1.0
        )
        out["idle_ticks"] = sum(1 for r in ticks if r.get("idle") == 1.0)
    if outs or drains:
        out["decisions"] = [
            f"{r['event']}: {r.get('replica')} "
            + (f"warm={int(r.get('warm_compiles', 0))} " if
               r.get("event") == "scale_out" else "")
            + f"moved={int(r.get('moved', 0))} "
            f"-> {int(r.get('replicas', 0))} replicas"
            for r in (outs + drains)[-6:]
        ]
    if tails:
        out["standby_tail"] = (
            f"{len(tails)} polls with progress, "
            f"{int(tails[-1].get('applied', 0))} ops applied"
        )
    if promos:
        last = promos[-1]
        out["promotions"] = len(promos)
        out["last_promotion"] = (
            f"{last.get('promote_s')}s, "
            f"{int(last.get('tenants', 0))} tenants over "
            f"{int(last.get('replicas', 0))} replicas, "
            f"lease epoch {int(last.get('lease_epoch', 0))}, "
            f"{int(last.get('final_tail_ops', 0))} final tail ops"
        )
    if stuck:
        out["scale_stuck"] = [
            f"{r.get('direction')} {r.get('replica') or '?'}: "
            f"{r.get('reason')} (waited {r.get('waited_s')}s "
            f"of {r.get('budget_s')}s budget)"
            for r in stuck[-3:]
        ]
    return out


def health_summary(recs: list[dict]) -> dict:
    events = [r for r in recs if r.get("kind") == "health"]
    by_event: dict[str, int] = {}
    for e in events:
        by_event[str(e.get("event"))] = by_event.get(str(e.get("event")), 0) + 1
    out = {"records": len(events), "by_event": by_event}
    probes = [e for e in events if e.get("event") == "grad_probe"]
    if probes:
        cos = [
            p["grad_cosine"] for p in probes
            if isinstance(p.get("grad_cosine"), (int, float))
        ]
        if cos:
            out["grad_cosine_min"] = round(min(cos), 4)
            out["grad_cosine_last"] = round(cos[-1], 4)
    critical = [
        e for e in events
        if e.get("severity") == "critical"
    ]
    if critical:
        out["critical"] = [
            {"step": e.get("step"), "event": e.get("event"),
             "message": e.get("message")}
            for e in critical[-5:]
        ]
    return out


def mfu_summary(run_dir: Path, train: dict | None, recs: list[dict]) -> dict | None:
    """Analytic MFU when the run dir carries a config.json and the card the
    run trained on (the ``device`` of its train records) has a known peak;
    a CPU run reports the FLOP rate without MFU."""
    if not train or not train.get("eps_mean"):
        return None
    cfg_path = run_dir / "config.json"
    if not cfg_path.exists():
        return None
    try:
        from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
        from induction_network_on_fewrel_tpu_torch.utils.flops import (
            peak_flops_per_chip,
            train_step_flops,
        )

        cfg = ExperimentConfig.from_json(cfg_path.read_text())
        flops = train_step_flops(cfg)
        out = {
            "flops_per_episode": flops["per_episode"],
            "achieved_flops_per_s": round(train["eps_mean"] * flops["per_episode"], 3),
        }
        kinds = [r["device"] for r in recs
                 if r.get("kind") == "train" and isinstance(r.get("device"), str)]
        if kinds:
            peak = peak_flops_per_chip(kinds[-1], cfg.compute_dtype)
            if peak:
                out["mfu"] = round(train["eps_mean"] * flops["per_episode"] / peak, 4)
                out["device_kind"] = kinds[-1]
        return out
    except Exception as e:  # noqa: BLE001 — a report section, never a crash
        return {"error": f"mfu unavailable: {type(e).__name__}: {e}"}


def recorder_summary(run_dir: Path) -> dict | None:
    p = run_dir / "flight_recorder.json"
    if not p.exists():
        return None
    try:
        d = json.loads(p.read_text())
    except json.JSONDecodeError as e:
        return {"error": f"flight_recorder.json unreadable: {e.msg}"}
    return {
        "reason": d.get("reason"),
        "dump_count": d.get("dump_count"),
        "events": len(d.get("events", [])),
        "metrics": len(d.get("metrics", [])),
        "spans": len(d.get("spans", [])),
    }


def overhead_summary(train: dict | None, iters: int = 20000) -> dict:
    """timed_call A/B of span enter/exit cost: the identical loop body with
    and without the span context manager; the delta per iteration is the
    span tax (a tracker bound to no device: no NVTX range)."""
    from induction_network_on_fewrel_tpu_torch.obs.spans import SpanTracker
    from induction_network_on_fewrel_tpu_torch.utils.profiling import timed_call

    tracker = SpanTracker(capacity=256)

    def with_spans():
        acc = 0
        for i in range(iters):
            with tracker.span("overhead/probe"):
                acc += i
        return acc

    def without_spans():
        acc = 0
        for i in range(iters):
            acc += i
        return acc

    # Warm both paths once (bytecode/alloc warmup), then measure.
    with_spans(), without_spans()
    _, t_with = timed_call(with_spans)
    _, t_without = timed_call(without_spans)
    per_span_s = max(0.0, (t_with - t_without) / iters)
    out = {"span_cost_us": round(per_span_s * 1e6, 3), "iters": iters}
    if train and train.get("step_time_p50_s"):
        # ~4 spans/step in the training loop (sample, dispatch, fetch
        # amortized, probe): the tax against the measured step.
        frac = 4 * per_span_s / train["step_time_p50_s"]
        out["fraction_of_p50_step"] = round(frac, 6)
        out["under_2pct"] = bool(frac < 0.02)
    return out


# --- rendering ------------------------------------------------------------

def render(report: dict) -> str:
    lines = [f"== run report: {report['run_dir']} =="]
    n, errors = report["schema"]["records"], report["schema"]["errors"]
    lines.append(f"schema: {n} records, {len(errors)} errors")
    for e in errors[:10]:
        lines.append(f"  ! {e}")
    for section in ("train", "mfu", "eval", "perf", "compile", "serve",
                    "fleet", "hops", "elasticity", "adapt", "faults",
                    "recovery",
                    "traces", "slo", "quality", "scenarios", "ckpt",
                    "input_pipeline", "comms", "roofline", "health",
                    "flight_recorder", "overhead"):
        body = report.get(section)
        if body is None:
            continue
        lines.append(f"-- {section} --")
        for k, v in body.items():
            if isinstance(v, dict) and all(
                isinstance(sv, dict) for sv in v.values()
            ) and v:
                # Table-of-dicts (e.g. serve.tenants): one row per key.
                lines.append(f"  {k}:")
                for sk in v:
                    row = " ".join(f"{a}={b}" for a, b in v[sk].items())
                    lines.append(f"    {sk}: {row}")
            elif isinstance(v, list) and v and all(
                isinstance(x, str) for x in v
            ):
                # Preformatted block (the trace waterfall): one line each.
                lines.append(f"  {k}:")
                for x in v:
                    lines.append(f"    {x}")
            else:
                lines.append(f"  {k}: {v}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render/validate the telemetry stream of one run dir"
    )
    ap.add_argument("run_dir", help="dir holding metrics.jsonl")
    ap.add_argument("--check", action="store_true",
                    help="schema validation only; exit 1 on any violation")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the report as one JSON object")
    ap.add_argument("--overhead", action="store_true",
                    help="measure span overhead (timed_call A/B) and state "
                         "it as a fraction of this run's p50 step time")
    args = ap.parse_args(argv)

    run_dir = Path(args.run_dir)
    metrics = run_dir / "metrics.jsonl"
    if not metrics.exists():
        print(f"no metrics.jsonl in {run_dir}", file=sys.stderr)
        return 2

    n, errors = check_schema(metrics)
    if args.check:
        for e in errors:
            print(f"schema error: {e}", file=sys.stderr)
        print(f"{'FAIL' if errors else 'OK'}: {n} records, "
              f"{len(errors)} schema errors")
        return 1 if errors else 0

    recs = load_records(metrics)
    train = train_summary(recs)
    report = {
        "run_dir": str(run_dir),
        "schema": {"records": n, "errors": errors},
        "train": train,
        "mfu": mfu_summary(run_dir, train, recs),
        "eval": eval_summary(recs),
        "perf": perf_summary(recs),
        "compile": compile_summary(recs),
        "serve": serve_summary(recs),
        "fleet": fleet_summary(recs),
        "hops": hop_summary(recs),
        "elasticity": elasticity_summary(recs),
        "adapt": adapt_summary(recs),
        "faults": fault_summary(recs),
        "recovery": recovery_summary(recs),
        "traces": trace_summary(recs),
        "slo": slo_summary(recs),
        "quality": quality_summary(recs),
        "scenarios": scenario_summary(recs),
        "ckpt": ckpt_summary(recs),
        "input_pipeline": data_summary(recs),
        "comms": comms_summary(recs),
        "roofline": roofline_summary(recs, run_dir),
        "health": health_summary(recs),
        "flight_recorder": recorder_summary(run_dir),
    }
    if args.overhead:
        report["overhead"] = overhead_summary(train)
    if args.as_json:
        print(json.dumps(report, indent=1, default=str))
    else:
        print(render(report))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
