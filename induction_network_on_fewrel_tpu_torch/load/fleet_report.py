"""Fleet-wide observability report: cross-process trace stitching and the
journal-correlated incident timeline (the port of the JAX repository's
``tools/fleet_report.py``, over the port's ``fleet/journal.py``).

A fleet run is many telemetry streams: the router process's metrics.jsonl
(hop records, fleet rollups, journal-op events, autoscaler ticks), one
metrics.jsonl per replica (serve counters, sampled kind="trace" request
waterfalls), and the control plane's write-ahead log (timestamp-free, so
replay stays deterministic). This tool folds them into one story:

* **Stitching**: every ``kind="hop"`` record names the trace_id it handed
  across the hop; the owning replica's ``kind="trace"`` record for the
  same id carries the replica-side segments. Hops with no replica-side
  record are unstitched; replica request traces no hop named are orphans;
  both fail ``--check``.
* **Clock discipline**: hop records carry ``offset_ms``, the transport's
  per-replica clock-offset estimate; replica timestamps are moved onto the
  router's clock with it, and ``--check`` fails when an estimate exceeds
  ``--skew_bound_ms``.
* **Journal correlation**: the router's ``event="journal_op"`` records
  (op, seq) are cross-checked against the WAL replayed read-only
  (``JournalTailer``, which never truncates another process's log).
* **Incident timeline**: journal ops, scale decisions, promotions, SLO
  burns, health CRITICALs, adapt transitions, replica deaths and
  recoveries from every stream, merged on offset-corrected ``t_unix``.

Run: ``python -m induction_network_on_fewrel_tpu_torch.load.fleet_report
FLEET_DIR [--check] [--json] [--router DIR] [--replica DIR ...] [--journal
DIR] [--skew_bound_ms MS] [--waterfalls N]``. FLEET_DIR holds ``router/``,
one ``r*/`` per replica and ``journal/`` (what the fleet-obs drill lays
down); the flags override discovery piecewise. The report's dict equals
the JAX tool's on the same directory.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from induction_network_on_fewrel_tpu_torch.fleet.journal import (
    SNAPSHOT_NAME,
    WAL_NAME,
    JournalTailer,
)

ROUTER_SEGMENTS = ("route", "queue", "wire", "remote", "respond")
REPLICA_SEGMENTS = ("queue", "pack", "execute", "respond")


# --- stream loading -------------------------------------------------------

def load_stream(run_dir: Path) -> list[dict]:
    """metrics.jsonl -> records, silently skipping unparseable lines
    (the package's tools/obs_report.py --check owns schema enforcement per
    stream)."""
    path = Path(run_dir) / "metrics.jsonl"
    recs: list[dict] = []
    if not path.exists():
        return recs
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict):
                    recs.append(rec)
    return recs


def discover(fleet_dir: Path, router: str | None,
             replicas: list[str], journal: str | None):
    """Resolve (router_dir, {replica_id: dir}, journal_dir) from the
    FLEET_DIR convention, each overridable by an explicit flag."""
    fleet_dir = Path(fleet_dir)
    router_dir = Path(router) if router else (
        fleet_dir / "router" if (fleet_dir / "router").exists()
        else fleet_dir
    )
    if replicas:
        rep_dirs = [Path(r) for r in replicas]
    else:
        rep_dirs = sorted(
            d for d in fleet_dir.iterdir()
            if d.is_dir() and d != router_dir
            and (d / "metrics.jsonl").exists()
        ) if fleet_dir.is_dir() else []
    by_id: dict[str, Path] = {}
    for d in rep_dirs:
        recs = load_stream(d)
        rid = next(
            (r["proc_replica"] for r in recs
             if isinstance(r.get("proc_replica"), str)), d.name,
        )
        by_id[rid] = d
    jdir = Path(journal) if journal else fleet_dir / "journal"
    if not ((jdir / WAL_NAME).exists() or (jdir / SNAPSHOT_NAME).exists()):
        jdir = None
    return router_dir, by_id, jdir


# --- stitching ------------------------------------------------------------

def stitch(router_recs: list[dict],
           replica_recs: dict[str, list[dict]]) -> dict:
    """Match every hop record to its replica-side trace record by
    trace_id. Returns coverage numbers + the stitched list (hop,
    replica_id, replica trace record)."""
    hops = [
        r for r in router_recs
        if r.get("kind") == "hop"
        and isinstance(r.get("trace_id"), str)
    ]
    # trace_id -> (replica id, record); request traces only (a publish
    # control record carries op=... and no per-request total).
    remote: dict[str, tuple[str, dict]] = {}
    for rid, recs in replica_recs.items():
        for r in recs:
            if (r.get("kind") == "trace"
                    and isinstance(r.get("trace_id"), str)
                    and isinstance(r.get("total_ms"), (int, float))
                    and not r.get("op")):
                remote[r["trace_id"]] = (rid, r)
    stitched, unstitched = [], []
    for h in hops:
        hit = remote.pop(h["trace_id"], None)
        if hit is None:
            unstitched.append(h)
        else:
            stitched.append((h, hit[0], hit[1]))
    # What is left in ``remote`` was served traced on a replica but never
    # announced by a hop record: orphaned request traces. (Replica-local
    # sampling with no router in front produces these legitimately — but
    # then there are no hop records either and this tool has nothing to
    # stitch; in a fleet run orphans mean lost telemetry.)
    orphans = sorted(remote)
    n_hops = len(hops)
    return {
        "hop_records": n_hops,
        "stitched": len(stitched),
        "unstitched": len(unstitched),
        "unstitched_frac": round(len(unstitched) / n_hops, 4)
        if n_hops else 0.0,
        "orphan_spans": len(orphans),
        "orphan_trace_ids": orphans[:10],
        "pairs": stitched,
    }


def _bar(offset: float, dur: float, total: float, width: int = 32) -> str:
    scale = width / total if total > 0 else 0.0
    a = int(round(offset * scale))
    b = max(a + 1, int(round((offset + dur) * scale)))
    return " " * a + "#" * min(b - a, width - a)


def waterfall_lines(hop: dict, rid: str, trace: dict) -> list[str]:
    """One stitched trace -> the fleet waterfall: router segments tile
    [0, router_ms]; the replica's segments tile its own total, drawn
    inside the hop's remote window (offset = where remote_ms starts on
    the router timeline — durations need no clock alignment)."""
    total = float(hop.get("router_ms") or 0.0)
    segs = [(s, float(hop.get(f"{s}_ms", 0.0))) for s in ROUTER_SEGMENTS]
    ssum = sum(d for _, d in segs)
    ok = total > 0 and abs(ssum - total) <= 0.05 * total
    lines = [
        f"trace {hop.get('trace_id')} tenant={hop.get('tenant')} "
        f"router->{rid} fleet={total:.3f}ms hop_tax={hop.get('hop_ms')}ms "
        f"(router segments sum {ssum:.3f}ms, "
        f"{'ok' if ok else 'MISMATCH > 5%'})",
    ]
    offset = 0.0
    remote_at = 0.0
    for name, dur in segs:
        if name == "remote":
            remote_at = offset
        lines.append(
            f"  router {name:<8}{dur:9.3f}ms "
            f"|{_bar(offset, dur, total):<32}|"
        )
        offset += dur
    r_total = float(trace.get("total_ms") or 0.0)
    r_segs = [(s, float(trace.get(f"{s}_ms", 0.0)))
              for s in REPLICA_SEGMENTS]
    # The replica block is drawn to the ROUTER's scale, anchored at the
    # remote window — the eye reads the replica's internal breakdown in
    # fleet-time position. (The replica's measured total can exceed the
    # clamped remote window by scheduling jitter; the bars then saturate
    # at the window edge rather than lie about the timeline.)
    r_off = remote_at
    for name, dur in r_segs:
        lines.append(
            f"  {rid:<6} {name:<8}{dur:9.3f}ms "
            f"|{_bar(r_off, dur, total):<32}|"
        )
        r_off += dur
    r_sum = sum(d for _, d in r_segs)
    r_ok = r_total > 0 and abs(r_sum - r_total) <= 0.05 * r_total
    lines.append(
        f"  {rid} total {r_total:.3f}ms (segments sum {r_sum:.3f}ms, "
        f"{'ok' if r_ok else 'MISMATCH > 5%'})"
    )
    return lines


# --- clock skew -----------------------------------------------------------

def clock_offsets(router_recs: list[dict]) -> dict[str, float]:
    """Last offset_ms estimate per replica, off the hop stream."""
    out: dict[str, float] = {}
    for r in router_recs:
        if (r.get("kind") == "hop"
                and isinstance(r.get("replica"), str)
                and isinstance(r.get("offset_ms"), (int, float))):
            out[r["replica"]] = float(r["offset_ms"])
    return out


# --- journal correlation --------------------------------------------------

def journal_correlation(journal_dir: Path | None,
                        router_recs: list[dict]) -> dict | None:
    """Replay the WAL read-only and cross-check every telemetry
    (op, seq) pair against the replayed record at that seq. Seqs folded
    into a snapshot are unverifiable (the ops are gone by design) and
    count separately, not as mismatches."""
    if journal_dir is None:
        return None
    tailer = JournalTailer(journal_dir)
    wal = {int(r["seq"]): str(r.get("op")) for r in tailer.records()
           if isinstance(r.get("seq"), (int, float))}
    snap_path = Path(journal_dir) / SNAPSHOT_NAME
    snap_base = 0
    if snap_path.exists():
        try:
            snap_base = int(
                json.loads(snap_path.read_text()).get("applied", 0)
            )
        except (json.JSONDecodeError, OSError):
            pass
    events = [
        r for r in router_recs
        if r.get("kind") == "fleet" and r.get("event") == "journal_op"
        and isinstance(r.get("seq"), (int, float))
    ]
    mismatches, compacted = [], 0
    for e in events:
        seq = int(e["seq"])
        op = str(e.get("op"))
        if seq in wal:
            if wal[seq] != op:
                mismatches.append(
                    f"seq {seq}: telemetry says {op!r}, WAL says "
                    f"{wal[seq]!r}"
                )
        elif seq < snap_base:
            compacted += 1
        else:
            mismatches.append(
                f"seq {seq} ({op!r}): no WAL record (torn tail? "
                f"wrong journal dir?)"
            )
    return {
        "wal_records": len(wal),
        "snapshot_base": snap_base,
        "journal_op_events": len(events),
        "compacted_unverifiable": compacted,
        "mismatches": mismatches,
        "state": tailer.state.to_dict() if (len(wal) or snap_base)
        else None,
    }


# --- the incident timeline ------------------------------------------------

def _event_label(r: dict) -> str | None:
    """One timeline-worthy record -> its ledger line, None for records
    that are load, not events (ticks, rollups, request traces)."""
    kind = r.get("kind")
    if kind == "fleet":
        ev = r.get("event")
        if ev == "journal_op":
            return f"journal {r.get('op')} seq={int(r.get('seq', -1))}"
        if ev == "fanout_publish":
            return (f"fanout publish -> v{int(r.get('params_version', 0))}"
                    f" across {int(r.get('replicas', 0))} replicas"
                    f" ({r.get('publish_s')}s)")
        if ev == "replica_add":
            return (f"replica {r.get('replica')} joined "
                    f"({int(r.get('replicas', 0))} replicas)")
        if ev == "replica_retire":
            return (f"replica {r.get('replica')} retired "
                    f"({int(r.get('replicas', 0))} replicas)")
        if ev == "replace":
            return f"failover re-placed {int(r.get('moved', 0))} tenants"
        if ev == "journal_compact":
            return (f"journal compacted at seq "
                    f"{int(r.get('snapshot_seq', 0))}")
        return None
    if kind == "scale":
        ev = r.get("event")
        if ev == "scale_out":
            return (f"autoscaler scale_out {r.get('replica')} "
                    f"(occupancy={r.get('occupancy')} "
                    f"shed_delta={r.get('shed_delta')})")
        if ev == "drain_in":
            return (f"autoscaler drain_in {r.get('replica')} "
                    f"moved={int(r.get('moved', 0))}")
        if ev == "promotion":
            return (f"standby PROMOTED in {r.get('promote_s')}s "
                    f"(lease epoch {int(r.get('lease_epoch', 0))})")
        return None
    if kind == "fault":
        a = r.get("action")
        if a == "replica_dead":
            return (f"replica {r.get('replica')} DEAD "
                    f"({r.get('reason')}; {int(r.get('tenants', 0))} "
                    f"tenants affected)")
        if a == "replica_recover":
            return f"replica {r.get('replica')} recovered ({r.get('reason')})"
        if a == "publish_rollback":
            return f"publish ROLLED BACK: {r.get('reason')}"
        if a == "recovered":
            return (f"cold-start recovery: {int(r.get('tenants', 0))} "
                    f"tenants, {int(r.get('reregistered', 0))} "
                    f"re-registered")
        if a == "breaker":
            return (f"breaker {r.get('tenant')}: {r.get('from')} -> "
                    f"{r.get('to')}")
        if a == "scale_stuck":
            return f"scale {r.get('direction')} STUCK: {r.get('reason')}"
        return None
    if kind == "health":
        ev = str(r.get("event", ""))
        if ev.startswith("slo_"):
            return (f"SLO {ev} tenant={r.get('tenant')} "
                    f"burn_fast={r.get('burn_fast')}")
        if r.get("severity") == "critical":
            return f"CRITICAL {ev}: {r.get('message')}"
        return None
    if kind == "adapt":
        return (f"adapt {r.get('action')} tenant={r.get('tenant')} "
                f"state={r.get('state')}")
    return None


def build_timeline(router_recs: list[dict],
                   replica_recs: dict[str, list[dict]],
                   offsets: dict[str, float]) -> dict:
    """Merge event-worthy records from every stream onto the ROUTER's
    clock: replica t_unix minus that replica's offset estimate (offset =
    replica − router by the ClockSync convention). Records without
    t_unix (identity stamping off) cannot be placed across processes and
    are counted, not guessed at."""
    events: list[tuple[float, str, str]] = []
    unplaced = 0

    def fold(recs: list[dict], src: str, shift_ms: float) -> None:
        nonlocal unplaced
        for r in recs:
            label = _event_label(r)
            if label is None:
                continue
            t = r.get("t_unix")
            if not isinstance(t, (int, float)):
                unplaced += 1
                continue
            events.append((float(t) - shift_ms / 1e3, src, label))

    fold(router_recs, "router", 0.0)
    for rid, recs in replica_recs.items():
        fold(recs, rid, offsets.get(rid, 0.0))
    events.sort(key=lambda e: e[0])
    t0 = events[0][0] if events else 0.0
    return {
        "events": len(events),
        "unplaced_events": unplaced,
        "lines": [
            f"+{t - t0:9.3f}s  {src:<8} {label}"
            for t, src, label in events
        ],
        "raw": [
            {"t": round(t - t0, 6), "src": src, "event": label}
            for t, src, label in events
        ],
    }


# --- report ---------------------------------------------------------------

def build_report(fleet_dir: Path, router_dir: Path,
                 replica_dirs: dict[str, Path],
                 journal_dir: Path | None, skew_bound_ms: float,
                 n_waterfalls: int) -> dict:
    router_recs = load_stream(router_dir)
    replica_recs = {rid: load_stream(d)
                    for rid, d in sorted(replica_dirs.items())}
    st = stitch(router_recs, replica_recs)
    offsets = clock_offsets(router_recs)
    jc = journal_correlation(journal_dir, router_recs)
    tl = build_timeline(router_recs, replica_recs, offsets)

    # The slowest stitched traces get waterfalls (the ones worth reading).
    pairs = sorted(
        st.pop("pairs"),
        key=lambda p: -float(p[0].get("router_ms", 0.0)),
    )[:max(n_waterfalls, 0)]
    waterfalls = [waterfall_lines(h, rid, t) for h, rid, t in pairs]
    tiling_ok = sum(
        1 for h, _, _ in pairs
        if float(h.get("router_ms", 0.0)) > 0 and abs(
            sum(float(h.get(f"{s}_ms", 0.0)) for s in ROUTER_SEGMENTS)
            - float(h["router_ms"])
        ) <= 0.05 * float(h["router_ms"])
    )

    failures: list[str] = []
    if st["hop_records"] == 0:
        failures.append("no hop records — is this a fleet run dir with "
                        "trace sampling on?")
    if st["unstitched"]:
        failures.append(
            f"{st['unstitched']} hop(s) unstitched "
            f"(frac {st['unstitched_frac']}) — replica-side trace "
            f"records missing"
        )
    if st["orphan_spans"]:
        failures.append(
            f"{st['orphan_spans']} orphan replica trace(s) no hop ever "
            f"named: {st['orphan_trace_ids']}"
        )
    worst_skew = max((abs(v) for v in offsets.values()), default=0.0)
    if worst_skew > skew_bound_ms:
        failures.append(
            f"clock skew {worst_skew}ms exceeds bound {skew_bound_ms}ms "
            f"— cross-process ordering untrustworthy"
        )
    if jc is not None and jc["mismatches"]:
        failures.extend(f"journal: {m}" for m in jc["mismatches"])
    if pairs and tiling_ok < len(pairs):
        failures.append(
            f"{len(pairs) - tiling_ok} rendered waterfall(s) with "
            f"router segments summing outside 5% of fleet latency"
        )

    return {
        "fleet_dir": str(fleet_dir),
        "router_dir": str(router_dir),
        "replicas": {rid: str(d) for rid, d in replica_dirs.items()},
        "journal_dir": str(journal_dir) if journal_dir else None,
        "stitching": st,
        "clock_offset_ms": offsets,
        "worst_skew_ms": worst_skew,
        "skew_bound_ms": skew_bound_ms,
        "journal": jc,
        "timeline": tl,
        "waterfalls": waterfalls,
        "failures": failures,
    }


def render(report: dict) -> str:
    lines = [f"== fleet report: {report['fleet_dir']} =="]
    lines.append(
        f"router: {report['router_dir']}  replicas: "
        f"{', '.join(sorted(report['replicas'])) or '(none)'}  journal: "
        f"{report['journal_dir'] or '(none)'}"
    )
    st = report["stitching"]
    lines.append("-- stitching --")
    lines.append(
        f"  hops={st['hop_records']} stitched={st['stitched']} "
        f"unstitched={st['unstitched']} (frac {st['unstitched_frac']}) "
        f"orphans={st['orphan_spans']}"
    )
    if report["clock_offset_ms"]:
        lines.append("-- clock --")
        for rid in sorted(report["clock_offset_ms"]):
            lines.append(
                f"  {rid}: offset {report['clock_offset_ms'][rid]}ms "
                f"(bound {report['skew_bound_ms']}ms)"
            )
    jc = report["journal"]
    if jc:
        lines.append("-- journal --")
        lines.append(
            f"  wal_records={jc['wal_records']} "
            f"snapshot_base={jc['snapshot_base']} "
            f"journal_op_events={jc['journal_op_events']} "
            f"mismatches={len(jc['mismatches'])}"
        )
    for wf in report["waterfalls"]:
        lines.append("-- waterfall --")
        lines.extend(f"  {x}" for x in wf)
    tl = report["timeline"]
    lines.append(
        f"-- timeline ({tl['events']} events, "
        f"{tl['unplaced_events']} unplaced) --"
    )
    lines.extend(f"  {x}" for x in tl["lines"])
    if report["failures"]:
        lines.append("-- FAILURES --")
        lines.extend(f"  ! {f}" for f in report["failures"])
    return "\n".join(lines)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m induction_network_on_fewrel_tpu_torch.load.fleet_report",
        description="stitch a fleet's telemetry streams + WAL into one "
                    "cross-process report"
    )
    ap.add_argument("fleet_dir", help="fleet run dir (router/ r*/ journal/)")
    ap.add_argument("--router", help="router run dir override")
    ap.add_argument("--replica", action="append", default=[],
                    help="replica run dir (repeatable) override")
    ap.add_argument("--journal", help="journal dir override")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on any stitching/skew/journal failure")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--skew_bound_ms", type=float, default=250.0,
                    help="max tolerated |clock offset| estimate")
    ap.add_argument("--waterfalls", type=int, default=3,
                    help="stitched waterfalls to render (slowest first)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    fleet_dir = Path(args.fleet_dir)
    router_dir, replica_dirs, journal_dir = discover(
        fleet_dir, args.router, args.replica, args.journal
    )
    if not (router_dir / "metrics.jsonl").exists():
        print(f"no metrics.jsonl under {router_dir}", file=sys.stderr)
        return 2
    report = build_report(
        fleet_dir, router_dir, replica_dirs, journal_dir,
        args.skew_bound_ms, args.waterfalls,
    )
    if args.as_json:
        print(json.dumps(report, indent=1, default=str))
    else:
        print(render(report))
    if args.check:
        for f in report["failures"]:
            print(f"fleet check: {f}", file=sys.stderr)
        print(f"{'FAIL' if report['failures'] else 'OK'}: "
              f"{report['stitching']['stitched']} stitched, "
              f"{report['timeline']['events']} timeline events, "
              f"{len(report['failures'])} failures")
        return 1 if report["failures"] else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
