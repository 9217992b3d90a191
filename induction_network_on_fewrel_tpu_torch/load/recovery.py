"""The durability drill (the JAX ``tools/loadgen.py:2435-2808``) on the
port's journaled fleet: one journaled 3-replica miniature fleet, then
three recovery arms.

* **Router kill-9**: every control-plane op is write-ahead-logged, then
  the router object is dropped mid-life with one replica's engine
  replaced by a fresh one (the host that died with it). A fresh router's
  ``recover(journal)`` must rebuild the directory bitwise, keep placement
  identical, re-register and catch the fresh replica up to the journaled
  generation, and lose no tenant; the requests in flight at the kill
  resolve (the replicas own their queues).
* **Replica kill -> supervised restart**: the supervisor's first restart
  fails on purpose; the second runs only after the backoff (an injected
  clock) and catches the replica up; traffic to the survivors drops
  nothing, and no replica captures after warmup.
* **Torn journal tail** (``journal.torn_write``): the next append is
  refused; reopening truncates at the tear and recovers every record
  before it; appends land again.

``tear_journal`` is the third arm's mechanics on any control plane.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import Counter

from induction_network_on_fewrel_tpu_torch.load.fleet import save_fresh_checkpoint, tiny_world


def tear_journal(control, journal_dir, tenant: str, other: str, logger=None) -> dict:
    """Tear the WAL under ``control`` mid-record (``journal.torn_write`` on
    a threshold op for ``tenant``), try one more append (for ``other``),
    reopen the journal and append the torn op again through it:
    {append_refused_after_tear, prefix_recovered, appendable_after_heal}.
    The control plane's journal is left as torn; the healed one is closed,
    and the log then holds what the live directory holds."""
    from induction_network_on_fewrel_tpu_torch.fleet import FleetJournal
    from induction_network_on_fewrel_tpu_torch.obs.chaos import ChaosRegistry, install

    state_before = json.dumps(control.journal.materialize().to_dict(), sort_keys=True)
    install(ChaosRegistry.parse("journal.torn_write@0", logger=logger))
    try:
        control.set_nota_threshold(tenant, 0.5)   # the torn append
    finally:
        install(None)
    refused = False
    try:
        # Straight to the journal: the control plane applies an op before
        # journaling it, and a refused op must not leave the live directory
        # ahead of the log.
        control.journal.append("tenant_threshold", tenant=other, threshold=0.5)
    except Exception:  # noqa: BLE001 — the journal must refuse
        refused = True
    healed = FleetJournal(journal_dir, fsync="always", logger=logger)
    try:
        state_after = json.dumps(healed.materialize().to_dict(), sort_keys=True)
        healed.append("tenant_threshold", tenant=tenant, threshold=0.5)
        appendable = healed.materialize().tenants[tenant]["nota_threshold"] == 0.5
    finally:
        healed.close()
    return {"append_refused_after_tear": refused,
            "prefix_recovered": state_after == state_before,
            "appendable_after_heal": appendable}


def recovery_tier1_drill(seed: int = 0, logger=None, device=None) -> dict:
    from induction_network_on_fewrel_tpu_torch.fleet import (
        FleetControl,
        FleetJournal,
        FleetRouter,
        InProcessReplica,
        ReplicaSupervisor,
    )
    from induction_network_on_fewrel_tpu_torch.obs.chaos import install
    from induction_network_on_fewrel_tpu_torch.serving.breaker import CircuitBreaker
    from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

    R, T = 3, 18
    world = tiny_world(seed, device)
    own_logger = logger if logger is not None else MetricsLogger(None, quiet=True)
    tmp = tempfile.TemporaryDirectory(prefix="recovery_drill_")
    out: dict = {"replicas": R, "tenants": T, "seed": seed}
    routers: list = []
    journals: list = []
    try:
        ckpt = save_fresh_checkpoint(world, os.path.join(tmp.name, "ckpt"))
        jdir = os.path.join(tmp.name, "journal")
        journal = FleetJournal(jdir, fsync="always", logger=own_logger)
        journals.append(journal)

        def mk():
            return world.engine(logger=own_logger)

        replicas = {f"r{i:02d}": InProcessReplica(f"r{i:02d}", mk()) for i in range(R)}
        router = FleetRouter(replicas, logger=own_logger,
                             breaker=CircuitBreaker(failure_threshold=3, open_s=1.0),
                             queue_capacity_per_replica=64)
        routers.append(router)
        control = FleetControl(router, journal=journal)
        names = [f"t{i:02d}" for i in range(T)]
        for i, tenant in enumerate(names):
            control.register_tenant(tenant, world.datasets[i % 4])
            if i % 3 == 0:
                control.set_nota_threshold(tenant, 0.25 + 0.05 * (i % 4))
        for h in router.replicas.values():
            h.warmup()
        pools = world.pools(names)
        # The journaled publish every catch-up re-drives (version 1).
        control.publish_checkpoint(ckpt)
        # Quarantine after the publish: recovery must re-assert flags
        # journaled after a committed publish.
        control.quarantine_tenant(names[1], reason="drill: operator hold")
        dir_before = router.directory_view()
        placement_before = router.placement.owners(names)
        out["placement_distribution"] = dict(sorted(Counter(
            e.owner for e in router.directory.values()).items()))
        out["journal_records_at_kill"] = journal.seq

        # --- ARM A: router kill-9 + one replica host lost ---------------
        lost_rid = sorted(replicas)[1]
        survivors_of_lost = [t for t, e in router.directory.items() if e.owner != lost_rid]
        inflight = [router.submit(pools[t][1], 10.0, tenant=t) for t in survivors_of_lost[:6]]
        replicas[lost_rid].close()   # that host died with the router
        replicas2 = dict(replicas)
        replicas2[lost_rid] = InProcessReplica(lost_rid, mk())
        journal2 = FleetJournal(jdir, fsync="always", logger=own_logger)
        journals.append(journal2)
        router2 = FleetRouter(replicas2, logger=own_logger,
                              breaker=CircuitBreaker(failure_threshold=3, open_s=1.0),
                              queue_capacity_per_replica=64)
        routers.append(router2)
        control2 = FleetControl(router2, journal=journal2)
        summary = router2.recover(journal2)
        dir_after = router2.directory_view()
        inflight_survived = all("label" in f.result(timeout=30.0) for f in inflight)
        served = degraded = errors = 0
        for t in names:
            try:
                v = router2.classify(pools[t][0], 10.0, tenant=t)
                served += 1
                degraded += bool(v.get("degraded"))
            except Exception:  # noqa: BLE001 — counted: the zero-band
                errors += 1
        versions = {rid: h.params_version for rid, h in router2.replicas.items()}
        out["router_kill"] = {
            "lost_replica": lost_rid,
            "directory_bitwise": dir_after == dir_before,
            "placement_identical": router2.placement.owners(names) == placement_before,
            "tenants_lost": T - len(router2.directory),
            "reregistered": summary["reregistered"],
            "caught_up": summary["caught_up"],
            "params_version_uniform": len(set(versions.values())) == 1,
            "params_version": max(versions.values()),
            "inflight_at_kill": len(inflight),
            "inflight_survived": inflight_survived,
            "served": served,
            # names[1] is quarantined: its degraded verdict proves the flag
            # survived the crash.
            "quarantine_survived": degraded == 1,
            "errors": errors,
        }

        # --- ARM B: replica kill -> supervised restart ------------------
        clock = {"t": 0.0}
        attempts = {"n": 0}

        def restart_fn(rid):
            attempts["n"] += 1
            if attempts["n"] == 1:
                raise RuntimeError("injected spawn failure (drill)")
            return InProcessReplica(rid, mk())

        sup = ReplicaSupervisor(router2, restart_fn, journal=journal2, backoff_s=0.5,
                                restart_budget=3, clock=lambda: clock["t"], logger=own_logger)
        victim = router2.directory[names[0]].owner
        victim_tenants = [t for t, e in router2.directory.items() if e.owner == victim]
        router2.replicas[victim].close()
        router2.mark_replica_dead(victim, reason="drill kill")
        survivors = [t for t in names if t not in victim_tenants and t != names[1]]
        catchup_errors = 0
        for t in survivors:
            try:
                router2.classify(pools[t][0], 10.0, tenant=t)
            except Exception:  # noqa: BLE001 — counted: the zero-band
                catchup_errors += 1
        p1 = sup.poll()                      # attempt 1: the injected failure
        delay = sup.next_delay(victim, 1)
        clock["t"] = delay * 0.5
        p2 = sup.poll()                      # inside the backoff: must not try
        clock["t"] = delay + 1e-6
        p3 = sup.poll()                      # attempt 2: succeeds
        for t in survivors:
            try:
                router2.classify(pools[t][0], 10.0, tenant=t)
            except Exception:  # noqa: BLE001 — counted: the zero-band
                catchup_errors += 1
        recovered = all(not router2.classify(pools[t][0], 10.0, tenant=t).get("degraded")
                        for t in victim_tenants[:4] if t != names[1])
        versions = {rid: h.params_version for rid, h in router2.replicas.items()}
        steady = sum(h.stats_snapshot()["steady_recompiles"] for h in router2.replicas.values())
        out["replica_kill"] = {
            "victim": victim,
            "affected_tenants": len(victim_tenants),
            "restart_attempts": attempts["n"],
            "backoff_honored": (p1["failed"] == [victim] and p2["restarted"] == []
                                and p2["failed"] == [] and p3["restarted"] == [victim]),
            "caught_up_version": max(versions.values()),
            "params_version_uniform": len(set(versions.values())) == 1,
            "recovered": recovered,
            "dropped_during_catchup": catchup_errors,
            "steady_recompiles": steady,
        }

        # --- ARM C: torn journal tail -----------------------------------
        out["torn_tail"] = tear_journal(control2, jdir, names[2], names[3], logger=own_logger)

        out["zero_bands"] = {
            "tenants_lost": out["router_kill"]["tenants_lost"],
            "steady_recompiles": out["replica_kill"]["steady_recompiles"],
            "dropped_during_catchup": out["replica_kill"]["dropped_during_catchup"],
        }
        out["passed"] = check_recovery_drill(out)
        return out
    finally:
        install(None)
        for r in routers:
            r.close()
        for j in journals:
            j.close()
        if logger is None:
            own_logger.close()
        tmp.cleanup()


def check_recovery_drill(out: dict) -> bool:
    """The drill's acceptance (the JAX gate)."""
    rk = out.get("router_kill", {})
    rep = out.get("replica_kill", {})
    tt = out.get("torn_tail", {})
    zb = out.get("zero_bands", {})
    return bool(
        rk.get("directory_bitwise")
        and rk.get("placement_identical")
        and rk.get("tenants_lost") == 0
        and rk.get("reregistered", 0) >= 1
        and rk.get("caught_up", 0) >= 1
        and rk.get("params_version_uniform")
        and rk.get("quarantine_survived")
        and rk.get("inflight_survived")
        and rk.get("errors") == 0
        and rep.get("backoff_honored")
        and rep.get("params_version_uniform")
        and rep.get("recovered")
        and rep.get("dropped_during_catchup") == 0
        and rep.get("steady_recompiles") == 0
        and tt.get("append_refused_after_tear")
        and tt.get("prefix_recovered")
        and tt.get("appendable_after_heal")
        and zb.get("tenants_lost") == 0
        and zb.get("steady_recompiles") == 0
        and zb.get("dropped_during_catchup") == 0
    )
