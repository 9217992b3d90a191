"""The fleet observability drill (the JAX ``tools/loadgen.py:3209-3446``).

A 3-replica miniature fleet laid out as the multi-stream run-dir
convention ``load/fleet_report.py`` reads (``router/``: the router's
telemetry; one dir per replica with identity-stamped engine streams;
``journal/``: the WAL), driven open loop through one scale-out, one
replica kill and one fan-out publish. The stitched report is the system
under test: every sampled hop stitches to its replica-side trace, no
replica trace goes unclaimed, the journal ops land in the timeline in the
order they were fired, and ``fleet_report --check`` is green.
"""

from __future__ import annotations

import time
from pathlib import Path

from induction_network_on_fewrel_tpu_torch.load import fleet_report
from induction_network_on_fewrel_tpu_torch.load.fleet import tiny_world


def fleet_obs_drill(seed: int = 0, fleet_dir: str | None = None, device=None) -> dict:
    from induction_network_on_fewrel_tpu_torch.fleet import (
        FleetControl,
        FleetRouter,
        InProcessReplica,
    )
    from induction_network_on_fewrel_tpu_torch.fleet.journal import FleetJournal
    from induction_network_on_fewrel_tpu_torch.serving.batcher import Saturated
    from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

    if fleet_dir is None:
        raise ValueError("fleet_obs_drill needs a fleet dir (--run_dir)")
    root = Path(fleet_dir)
    root.mkdir(parents=True, exist_ok=True)
    R, T = 3, 6
    world = tiny_world(seed, device)
    loggers: list = []

    def mk(rid):
        # One stream per process-equivalent, stamped with its identity.
        lg = MetricsLogger(root / rid, quiet=True)
        lg.set_identity("serve", replica=rid)
        loggers.append(lg)
        return InProcessReplica(rid, world.engine(logger=lg))

    replicas = {f"r{i + 1:02d}": mk(f"r{i + 1:02d}") for i in range(R)}
    rlog = MetricsLogger(root / "router", quiet=True)
    rlog.set_identity("router")
    loggers.append(rlog)
    router = FleetRouter(dict(replicas), logger=rlog, trace_sample=0.5,
                         queue_capacity_per_replica=64)
    journal = FleetJournal(root / "journal", logger=rlog)
    control = FleetControl(router, journal=journal)
    out: dict = {"replicas": R, "tenants": T, "seed": seed}
    futs: list = []
    try:
        names = [f"t{i:02d}" for i in range(T)]
        for i, t in enumerate(names):
            control.register_tenant(t, world.datasets[i % 4])
        for h in router.replicas.values():
            h.warmup()
        pools = world.pools(names)

        def open_loop(n, phase):
            # A fixed arrival cadence, completions collected at the end.
            for s in range(n):
                t = names[(s + phase) % T]
                try:
                    futs.append(router.submit(pools[t][s % len(pools[t])], 10.0, tenant=t))
                except Saturated:
                    pass
                time.sleep(0.002)

        open_loop(24, 0)
        # Incident 1: a scale-out (journals replica_add; churn re-placed).
        control.add_replica(mk(f"r{R + 1:02d}"))
        control.replace_tenants()
        router.replicas[f"r{R + 1:02d}"].warmup()
        open_loop(24, 1)
        # Incident 2: a replica kill. The engine keeps draining its queue
        # (sampled requests in flight still land their traces), placement
        # fails over and the timeline gets the fault record.
        victim = router.directory[names[0]].owner
        router.mark_replica_dead(victim, reason="drill")
        control.replace_tenants()
        open_loop(24, 2)
        # Incident 3: a fan-out publish (journals publish_commit).
        control.publish_params(world.params)
        open_loop(24, 3)
        served = degraded = 0
        for f in futs:
            v = f.result(timeout=30.0)
            served += 1
            degraded += bool(v.get("degraded"))
        out["requests"] = {"submitted": len(futs), "served": served, "degraded": degraded}
        out["victim"] = victim
        router.emit_stats()
    finally:
        router.close()
        journal.close()
        for lg in loggers:
            lg.close()

    # The stitched report is the acceptance: the code path ``fleet_report
    # --check`` runs, on the layout just written.
    router_dir, rep_dirs, jdir = fleet_report.discover(root, None, [], None)
    report = fleet_report.build_report(root, router_dir, rep_dirs, jdir, skew_bound_ms=250.0,
                                       n_waterfalls=3)
    st = report["stitching"]
    hops = [r for r in fleet_report.load_stream(router_dir) if r.get("kind") == "hop"]

    def pct(vals, q):
        if not vals:
            return None
        xs = sorted(vals)
        return xs[min(len(xs) - 1, int(q / 100.0 * len(xs)))]

    hop_ms = [float(r["hop_ms"]) for r in hops]
    router_ms = [float(r["router_ms"]) for r in hops]
    out["stitching"] = {
        "hop_records": st["hop_records"],
        "stitched": st["stitched"],
        "stitch_coverage": round(st["stitched"] / st["hop_records"], 4)
        if st["hop_records"] else 0.0,
        "unstitched_frac": st["unstitched_frac"],
        "orphan_spans": st["orphan_spans"],
    }
    out["hop"] = {"hop_ms_p50": pct(hop_ms, 50), "hop_ms_p99": pct(hop_ms, 99),
                  "router_ms_p50": pct(router_ms, 50), "router_ms_p99": pct(router_ms, 99)}
    out["clock"] = {"max_offset_ms": report["worst_skew_ms"],
                    "per_replica": report["clock_offset_ms"]}
    tl = report["timeline"]["raw"]

    def first(pred):
        return next((i for i, e in enumerate(tl) if pred(e)), None)

    i_add = first(lambda e: "journal replica_add" in e["event"])
    i_kill = first(lambda e: "DEAD" in e["event"])
    i_pub = first(lambda e: "journal publish_commit" in e["event"])
    out["timeline"] = {
        "events": report["timeline"]["events"],
        "unplaced": report["timeline"]["unplaced_events"],
        "journal_ops": sum(1 for e in tl if e["event"].startswith("journal ")),
        "incidents_ordered": None not in (i_add, i_kill, i_pub) and i_add < i_kill < i_pub,
    }
    out["zero_bands"] = {"orphan_spans": st["orphan_spans"],
                         "unstitched_frac": st["unstitched_frac"]}
    out["check_failures"] = report["failures"]
    out["waterfalls_rendered"] = len(report["waterfalls"])
    out["passed"] = bool(
        not report["failures"]
        and st["hop_records"] >= 10
        and out["stitching"]["stitch_coverage"] == 1.0
        and st["orphan_spans"] == 0
        and out["timeline"]["incidents_ordered"]
        and out["timeline"]["unplaced"] == 0
        and out["waterfalls_rendered"] >= 1
        and out["requests"]["served"] == out["requests"]["submitted"]
    )
    return out
