"""The elasticity drill (the JAX ``tools/loadgen.py:2809-3208``) on the
port's autoscaler and hot standby: one journaled single-replica miniature
fleet with a hot standby tailing the WAL, then a diurnal cycle.

* **Ramp -> scale-out**: two pressure readings on the autoscaler's
  injected clock (the sensor is scripted, the scale mechanics are real)
  spawn a replica, catch it up to the journaled params_version, pre-warm
  the tenants the rendezvous hands it, and only then join placement:
  nothing dropped, no capture after warmup through the scale event.
* **Trough -> drain-in**: idle readings drain the newest replica with
  requests still queued on it; the policy waits for an empty queue before
  moving the registrations and retiring it, so every in-flight future
  gets a real verdict.
* **Second ramp -> router kill-9 -> standby promotion**: the primary
  router object is dropped mid-ramp; the standby serves known tenants
  degraded NOTA until ``promote()`` (lease first, so the zombie primary's
  next append raises; final catch-up replay; a ``recover()`` rebuilding
  the directory bitwise).
"""

from __future__ import annotations

import os
import tempfile
import time

from induction_network_on_fewrel_tpu_torch.load.fleet import (
    save_fresh_checkpoint,
    serve_all,
    tiny_world,
)


def elastic_tier1_drill(seed: int = 0, logger=None, device=None) -> dict:
    from induction_network_on_fewrel_tpu_torch.fleet import (
        FleetAutoscaler,
        FleetControl,
        FleetJournal,
        FleetRouter,
        HotStandby,
        InProcessReplica,
        JournalError,
    )
    from induction_network_on_fewrel_tpu_torch.serving.breaker import CircuitBreaker
    from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

    T = 12
    world = tiny_world(seed, device)
    own_logger = logger if logger is not None else MetricsLogger(None, quiet=True)
    tmp = tempfile.TemporaryDirectory(prefix="elastic_drill_")
    out: dict = {"replicas_start": 1, "tenants": T, "seed": seed}
    routers: list = []
    journals: list = []
    handles: dict = {}
    standby = None
    try:
        ckpt = save_fresh_checkpoint(world, os.path.join(tmp.name, "ckpt"))
        jdir = os.path.join(tmp.name, "journal")
        journal = FleetJournal(jdir, fsync="always", logger=own_logger)
        journals.append(journal)
        journal.acquire_lease("primary")   # the single-writer latch

        def mk():
            return world.engine(logger=own_logger)

        def spawn(rid):
            handles[rid] = InProcessReplica(rid, mk())
            return handles[rid]

        handles["r00"] = InProcessReplica("r00", mk())
        router = FleetRouter({"r00": handles["r00"]}, logger=own_logger,
                             breaker=CircuitBreaker(failure_threshold=3, open_s=1.0),
                             queue_capacity_per_replica=64)
        routers.append(router)
        control = FleetControl(router, journal=journal)
        names = [f"t{i:02d}" for i in range(T)]
        for i, tenant in enumerate(names):
            control.register_tenant(tenant, world.datasets[i % 4])
            if i % 3 == 0:
                control.set_nota_threshold(tenant, 0.25 + 0.05 * (i % 4))
        handles["r00"].warmup()
        pools = world.pools(names)
        control.publish_checkpoint(ckpt)   # v1: what catch-up re-drives
        control.quarantine_tenant(names[1], reason="drill: operator hold")

        # The hot standby arms before anything interesting happens.
        standby = HotStandby(jdir, owner="standby", logger=own_logger)
        standby.poll()

        clockd = {"t": 0.0}
        scaler = FleetAutoscaler(control, spawn, min_replicas=1, max_replicas=2,
                                 high_occupancy=0.75, low_occupancy=0.20,
                                 high_windows=2, low_windows=2, cooldown_s=5.0,
                                 scale_budget_s=30.0, clock=lambda: clockd["t"],
                                 logger=own_logger)

        # --- PHASE A: ramp -> scale-out ------------------------------
        _, deg_a0, err_a0 = serve_all(router, names, pools)
        hot = {"occupancy": 0.92, "shed_delta": 3}
        actions_a = [scaler.tick(dict(hot))["action"]]
        clockd["t"] = 1.0
        actions_a.append(scaler.tick(dict(hot))["action"])
        ev = dict(scaler.last_event or {})
        _, deg_a1, err_a1 = serve_all(router, names, pools)
        _, _, err_a2 = serve_all(router, names, pools)   # steady: warmed programs
        versions = {rid: h.params_version for rid, h in router.replicas.items()}
        out["scale_out"] = {
            "actions": actions_a,
            "ticks_to_scale": len(actions_a),
            "replica": ev.get("replica"),
            "warm_compiles": ev.get("warm_compiles", 0),
            "moved": ev.get("moved", 0),
            "replicas_after": len(router.replicas),
            "params_version_uniform": len(set(versions.values())) == 1,
            "params_version": max(versions.values()),
            "quarantine_held": deg_a0 == 1 and deg_a1 == 1,
            "errors": err_a0 + err_a1 + err_a2,
        }
        tail_a = standby.poll()

        # --- PHASE B: trough -> drain-in (in-flight pinned) ----------
        victim = sorted(router.replicas)[-1]
        owned = [t for t, e in router.directory.items() if e.owner == victim and t != names[1]]
        inflight = [router.submit(pools[t][1], 10.0, tenant=t) for t in owned[:4]]
        clockd["t"] = 10.0   # past the scale-out cool-down
        actions_b = []
        for _ in range(60):
            actions_b.append(scaler.tick({"occupancy": 0.02})["action"])
            clockd["t"] += 1.0
            if actions_b[-1] == "drain_in":
                break
            if actions_b[-1] == "pending":
                time.sleep(0.05)   # the victim's queue draining for real
        ev2 = dict(scaler.last_event or {})
        inflight_drain_ok = all("label" in f.result(timeout=30.0) for f in inflight)
        _, deg_b, err_b = serve_all(router, names, pools)
        out["drain_in"] = {
            "replica": ev2.get("replica"),
            "victim_matches": ev2.get("replica") == victim,
            "inflight_at_drain": len(inflight),
            "inflight_survived": inflight_drain_ok,
            "moved": ev2.get("moved", 0),
            "replicas_after": len(router.replicas),
            "tenants_intact": len(router.directory) == T,
            "drained": actions_b[-1] == "drain_in",
            "errors": err_b,
        }
        tail_b = standby.poll()

        # --- PHASE C: second ramp -> kill-9 -> promotion -------------
        clockd["t"] += 10.0   # past the drain-in cool-down
        scaler.tick(dict(hot))
        clockd["t"] += 1.0
        actions_c = scaler.tick(dict(hot))["action"]
        ev3 = dict(scaler.last_event or {})
        _, _, err_c = serve_all(router, names, pools)
        dir_before = router.directory_view()
        placement_before = router.placement.owners(names)
        inflight2 = [router.submit(pools[t][1], 10.0, tenant=t)
                     for t in names[2:8] if t != names[1]]
        # Kill-9: the router object is gone; the replica engines keep
        # working the queues they own; the zombie control plane's journal
        # survives to prove the lease fence.
        zombie_journal = journal
        routers.remove(router)
        del router, control

        window_deg = 0
        for t in names[:3]:
            v = standby.classify(pools[t][0], tenant=t)
            window_deg += bool(v.get("degraded") and v.get("failover"))
        try:
            standby.classify(pools[names[0]][0], tenant="t99")
            unknown_refused = False
        except ValueError:
            unknown_refused = True

        # The standby has not polled since before the second scale-out:
        # promote()'s final catch-up replay must fold it.
        live_handles = {rid: h for rid, h in handles.items() if rid != victim}
        promo = standby.promote(live_handles,
                                breaker=CircuitBreaker(failure_threshold=3, open_s=1.0),
                                queue_capacity_per_replica=64)
        routers.append(standby.router)
        journals.append(standby.journal)
        dir_after = standby.router.directory_view()
        inflight_kill_ok = all("label" in f.result(timeout=30.0) for f in inflight2)
        _, deg_p, err_p = serve_all(standby, names, pools)
        try:
            zombie_journal.append("tenant_threshold", tenant=names[3], threshold=0.4)
            split_brain_refused = False
        except JournalError:
            split_brain_refused = True
        control3 = FleetControl(standby.router, journal=standby.journal, logger=own_logger)
        control3.set_nota_threshold(names[2], 0.45)
        promoted_writer_ok = (
            standby.journal.materialize().tenants[names[2]]["nota_threshold"] == 0.45)
        out["promotion"] = {
            "scale_out2_replica": ev3.get("replica"),
            "second_ramp_action": actions_c,
            "replicas_at_kill": len(live_handles),
            "directory_bitwise": dir_after == dir_before,
            "placement_identical": standby.router.placement.owners(names) == placement_before,
            "tenants_lost": T - len(standby.router.directory),
            "degraded_during_promotion": window_deg,
            "unknown_tenant_refused": unknown_refused,
            "inflight_at_kill": len(inflight2),
            "inflight_survived": inflight_kill_ok,
            "promote_s": round(promo["promote_s"], 4),
            "final_tail_ops": promo["final_tail_ops"],
            "applied": promo["applied"],
            "lease_epoch": promo["lease_epoch"],
            "split_brain_refused": split_brain_refused,
            "promoted_writer_ok": promoted_writer_ok,
            "quarantine_held": deg_p == 1,
            "errors": err_p + err_c,
        }
        out["standby"] = {"tail_ops_scale": tail_a, "tail_ops_drain": tail_b,
                          "applied": standby.applied}
        steady = sum(h.stats_snapshot()["steady_recompiles"] for h in handles.values())
        out["zero_bands"] = {
            "dropped_during_scale": out["scale_out"]["errors"] + out["drain_in"]["errors"],
            "dropped_during_promotion": (out["promotion"]["errors"]
                                         + (0 if inflight_kill_ok else len(inflight2))),
            "tenants_lost": out["promotion"]["tenants_lost"],
            "steady_recompiles": steady,
        }
        out["passed"] = check_elastic_drill(out)
        return out
    finally:
        for r in routers:
            r.close()
        for j in journals:
            j.close()
        for h in handles.values():
            try:
                h.close()
            except Exception:  # noqa: BLE001 — an already closed handle is fine
                pass
        if logger is None:
            own_logger.close()
        tmp.cleanup()


def check_elastic_drill(out: dict) -> bool:
    """The drill's acceptance (the JAX gate)."""
    so = out.get("scale_out", {})
    di = out.get("drain_in", {})
    pr = out.get("promotion", {})
    sb = out.get("standby", {})
    zb = out.get("zero_bands", {})
    return bool(
        so.get("actions") == ["none", "scale_out"]
        and so.get("replicas_after") == 2
        and so.get("warm_compiles", 0) >= 1
        and so.get("moved", 0) >= 1
        and so.get("params_version_uniform")
        and so.get("params_version") == 1
        and so.get("quarantine_held")
        and di.get("victim_matches")
        and di.get("drained")
        and di.get("replicas_after") == 1
        and di.get("tenants_intact")
        and di.get("inflight_at_drain", 0) >= 1
        and di.get("inflight_survived")
        and pr.get("second_ramp_action") == "scale_out"
        and pr.get("replicas_at_kill") == 2
        and pr.get("directory_bitwise")
        and pr.get("placement_identical")
        and pr.get("tenants_lost") == 0
        and pr.get("degraded_during_promotion", 0) >= 1
        and pr.get("unknown_tenant_refused")
        and pr.get("inflight_survived")
        and pr.get("final_tail_ops", 0) >= 1
        and pr.get("split_brain_refused")
        and pr.get("promoted_writer_ok")
        and pr.get("quarantine_held")
        and sb.get("tail_ops_scale", 0) >= 1
        and sb.get("tail_ops_drain", 0) >= 1
        and zb.get("dropped_during_scale") == 0
        and zb.get("dropped_during_promotion") == 0
        and zb.get("tenants_lost") == 0
        and zb.get("steady_recompiles") == 0
    )
