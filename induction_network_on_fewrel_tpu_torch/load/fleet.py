"""The fleet soak and its tier-1 miniature (the JAX
``tools/loadgen.py:1850-2434``) over the port's ``fleet/``.

``run_fleet_soak``: R in-process replicas behind the router, T tenants
rendezvous-placed across them, then
1. onboarding through the control plane (owners recorded, placement
   re-resolution consistent);
2. mixed closed-loop traffic with one all-or-nothing fan-out publish
   fired mid-load from a side thread: zero drops, zero captures after
   warmup on every replica, params_version uniform; a per-window,
   per-replica occupancy/shed time series rides along;
3. a replica add: placement churn against the rendezvous bound, the
   displaced tenants re-registered and re-served;
4. the ``fleet.replica_kill`` drill: failover serves degraded NOTA (zero
   drops), the watchdog latches one ``replica_dead`` CRITICAL,
   re-placement recovers the tenants, a revive re-arms the latch.

``fleet_tier1_drill`` is the miniature 3-replica leg (a CNN on a 122-word
vocabulary, 48 tenants) whose placement numbers are pure functions of the
ids, so the JAX artifact's ``tier1`` block pins them exactly.
``tiny_world`` is that miniature, shared with the recovery, elastic and
fleet-obs drills: every replica's engine gets its own copy of the fresh
weights (a replica's registry writes its parameter banks in place).
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from types import SimpleNamespace

import numpy as np

from induction_network_on_fewrel_tpu_torch.load.harness import build_engine, pct_ms

# The drills' miniature world (the JAX drills' config, without its
# ``device="cpu"``: the port's device is the caller's).
TINY = dict(model="induction", encoder="cnn", hidden_size=16, vocab_size=122, word_dim=8,
            pos_dim=2, max_length=16, induction_dim=8, ntn_slices=4, routing_iters=2,
            n=3, train_n=3, k=2, q=2)
TINY_BUCKETS = (1, 2, 4)


def tiny_world(seed: int, device=None, datasets: int = 4) -> SimpleNamespace:
    """cfg, tok, params (the fresh weights' state_dict, on the host),
    ``datasets`` synthetic corpora, and ``engine(logger=None, **kw)``
    building one replica engine on ``device``."""
    from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
    from induction_network_on_fewrel_tpu_torch.data import (
        GloveTokenizer,
        make_synthetic_fewrel,
        make_synthetic_glove,
    )
    from induction_network_on_fewrel_tpu_torch.models.build import build_model
    from induction_network_on_fewrel_tpu_torch.serving.engine import InferenceEngine

    cfg = ExperimentConfig(**TINY, seed=seed)
    vocab = make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim)
    tok = GloveTokenizer(vocab, max_length=cfg.max_length)
    params = build_model(cfg, glove_init=vocab.vectors, device="cpu").state_dict()
    corpora = [make_synthetic_fewrel(num_relations=cfg.n, instances_per_relation=cfg.k + 6,
                                     vocab_size=cfg.vocab_size - 2, seed=seed + 101 * d)
               for d in range(datasets)]

    def engine(logger=None, **kw):
        model = build_model(cfg, device=device)
        model.load_state_dict(params)
        return InferenceEngine(model, cfg, tok, k=cfg.k, buckets=TINY_BUCKETS, device=device,
                               logger=logger, **kw)

    def pools(names):
        """{tenant: held-out queries}, tenant i on corpus i % len(corpora)."""
        return {t: [inst for rel in corpora[i % len(corpora)].rel_names
                    for inst in corpora[i % len(corpora)].instances[rel][cfg.k:]]
                for i, t in enumerate(names)}

    return SimpleNamespace(cfg=cfg, tok=tok, vocab=vocab, params=params, datasets=corpora,
                           engine=engine, pools=pools)


def save_fresh_checkpoint(world, ckpt: str) -> str:
    """The world's fresh weights as a best slot at step 0 (the publishable
    artifact a journaled catch-up re-drives)."""
    from induction_network_on_fewrel_tpu_torch.models.build import build_model
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager
    from induction_network_on_fewrel_tpu_torch.train.steps import make_optimizer

    model = build_model(world.cfg, device="cpu")
    model.load_state_dict(world.params)
    mngr = CheckpointManager(ckpt, world.cfg, stage="off")
    try:
        mngr.save(0, model, make_optimizer(world.cfg, model), val_accuracy=0.0)
        mngr.wait()
    finally:
        mngr.close()
    return ckpt


def serve_all(front, names, pools) -> tuple[int, int, int]:
    """One verdict per tenant through ``front``: (served, degraded,
    errors)."""
    served = degraded = errors = 0
    for t in names:
        try:
            v = front.classify(pools[t][0], 10.0, tenant=t)
            served += 1
            degraded += bool(v.get("degraded"))
        except Exception:  # noqa: BLE001 — counted: the zero-band
            errors += 1
    return served, degraded, errors


def _fleet_datasets(args, count: int) -> list:
    """``count`` distinct synthetic corpora; tenants cycle over them."""
    from induction_network_on_fewrel_tpu_torch.data import make_synthetic_fewrel

    return [make_synthetic_fewrel(num_relations=args.N, instances_per_relation=args.K + 10,
                                  vocab_size=2000, seed=args.seed + 101 * d)
            for d in range(count)]


def _run_fleet_closed(router, pools, tenant_names, concurrency, duration, seed,
                      deadline_s=10.0):
    """Closed-loop workers striding across ``tenant_names`` through the
    router: latency percentiles and the three outcome counters (``shed``:
    backpressure, backed off and retried; ``degraded``: failover NOTA
    verdicts; ``errors``: everything else)."""
    from induction_network_on_fewrel_tpu_torch.serving.batcher import Saturated

    lat: list[float] = []
    counters = {"shed": 0, "degraded": 0, "errors": 0}
    lock = threading.Lock()
    stop = time.monotonic() + duration

    def worker(wi: int):
        r = np.random.default_rng(seed + wi)
        mine, me = [], {"shed": 0, "degraded": 0, "errors": 0}
        i = wi
        while time.monotonic() < stop:
            tenant = tenant_names[i % len(tenant_names)]
            i += concurrency
            pool = pools[tenant]
            inst = pool[int(r.integers(len(pool)))]
            t0 = time.monotonic()
            try:
                v = router.classify(inst, deadline_s, tenant=tenant)
                mine.append(time.monotonic() - t0)
                if v.get("degraded"):
                    me["degraded"] += 1
            except Saturated as e:
                me["shed"] += 1
                delay = e.retry_after_s * (0.75 + 0.5 * float(r.random()))
                time.sleep(max(0.0, min(delay, stop - time.monotonic())))
            except Exception:  # noqa: BLE001 — counted: the zero-band
                me["errors"] += 1
        with lock:
            lat.extend(mine)
            for k in counters:
                counters[k] += me[k]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(concurrency)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    return {"served": len(lat), "qps": round(len(lat) / wall, 1),
            "p50_ms": pct_ms(lat, 50), "p99_ms": pct_ms(lat, 99), "wall": wall, **counters}


def run_fleet_soak(args, ckpt, logger, recorder, capture) -> dict:
    from induction_network_on_fewrel_tpu_torch.fleet import (
        FleetControl,
        FleetPlacement,
        FleetRouter,
        InProcessReplica,
    )
    from induction_network_on_fewrel_tpu_torch.load.harness import engine_params
    from induction_network_on_fewrel_tpu_torch.obs import HealthWatchdog
    from induction_network_on_fewrel_tpu_torch.obs.chaos import ChaosRegistry, install
    from induction_network_on_fewrel_tpu_torch.serving.breaker import CircuitBreaker
    from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

    R, T = args.fleet, max(args.tenants, 1)
    # The kill drill's criticals flow through logger hooks (the watchdog):
    # without a run dir a pathless logger carries the record stream.
    own_logger = logger is None
    if own_logger:
        logger = MetricsLogger(None, quiet=True)
    watchdog = HealthWatchdog(logger=logger, recorder=recorder, capture=capture)
    logger.add_hook(watchdog.observe_record)

    def mk():
        return build_engine(args, ckpt, "continuous", logger=logger)

    replicas = {f"r{i:02d}": InProcessReplica(f"r{i:02d}", mk()) for i in range(R)}
    router = FleetRouter(replicas, logger=logger,
                         breaker=CircuitBreaker(failure_threshold=3, open_s=1.0),
                         queue_capacity_per_replica=args.queue_depth)
    control = FleetControl(router)
    out: dict = {"replicas": R, "tenants": T}
    try:
        # 1. Onboarding.
        datasets = _fleet_datasets(args, min(8, T))
        names = [f"t{i:04d}" for i in range(T)]
        t0 = time.monotonic()
        for i, tenant in enumerate(names):
            control.register_tenant(tenant, datasets[i % len(datasets)])
        out["register_s"] = round(time.monotonic() - t0, 3)
        out["warmup_compiles"] = sum(h.warmup() for h in router.replicas.values())
        dist = Counter(e.owner for e in router.directory.values())
        out["placement_distribution"] = dict(sorted(dist.items()))
        owners = router.placement.owners(names)
        out["placement_consistent"] = all(owners[t] == router.directory[t].owner for t in names)
        pools = {t: [inst for rel in datasets[i % len(datasets)].rel_names
                     for inst in datasets[i % len(datasets)].instances[rel][args.K:]]
                 for i, t in enumerate(names)}

        # 2. Mixed traffic and a mid-load fan-out publish.
        served0 = {rid: h.stats_snapshot()["served"] for rid, h in router.replicas.items()}
        pub: dict = {}

        def _publish():
            p0 = time.monotonic()
            try:
                first = router.replicas[sorted(router.replicas)[0]]
                pub["params_version"] = control.publish_params(engine_params(first.engine))
            except Exception as e:  # noqa: BLE001 — report, never die
                pub["error"] = repr(e)
            pub["publish_s"] = round(time.monotonic() - p0, 4)

        # The per-window, per-replica occupancy/shed time series.
        ts_windows: list = []
        ts_window_s = max(args.duration / 8.0, 0.25)
        ts_stop = threading.Event()

        def _sample_timeseries():
            w = 0
            last_shed = router.snapshot()["shed"]
            while not ts_stop.wait(ts_window_s):
                snap = router.snapshot()
                row = {"window": w, "t_s": round((w + 1) * ts_window_s, 3),
                       "shed_delta": snap["shed"] - last_shed,
                       "inflight": snap["inflight"], "replicas": {}}
                last_shed = snap["shed"]
                for rid in sorted(router.replicas):
                    try:
                        s = router.replicas[rid].stats_snapshot()
                    except Exception:  # noqa: BLE001 — dead mid-drill
                        continue
                    row["replicas"][rid] = {"occupancy": s["batch_occupancy"],
                                            "queue_depth": s["queue_depth"],
                                            "served": s["served"]}
                ts_windows.append(row)
                w += 1

        sampler = threading.Thread(target=_sample_timeseries, daemon=True)
        sampler.start()
        timer = threading.Timer(max(args.duration / 2, 0.5), _publish)
        timer.start()
        traffic = _run_fleet_closed(router, pools, names, args.concurrency, args.duration,
                                    args.seed)
        timer.join(timeout=120.0)
        ts_stop.set()
        sampler.join(timeout=10.0)
        out["timeseries"] = {"window_s": ts_window_s, "windows": ts_windows}
        wall = traffic.pop("wall")
        out["traffic"] = traffic
        per_replica = {}
        for rid, h in sorted(router.replicas.items()):
            s = h.stats_snapshot()
            per_replica[rid] = {"qps": round((s["served"] - served0[rid]) / wall, 1),
                                "served": s["served"], "p50_ms": s["p50_ms"],
                                "p99_ms": s["p99_ms"], "occupancy": s["batch_occupancy"],
                                "steady_recompiles": s["steady_recompiles"]}
        out["per_replica"] = per_replica
        versions = {rid: h.params_version for rid, h in router.replicas.items()}
        out["fanout_publish"] = {
            **pub, "replicas": len(versions), "uniform": len(set(versions.values())) == 1,
            "dropped": traffic["errors"],
            "steady_recompiles": sum(r["steady_recompiles"] for r in per_replica.values()),
        }

        # 3. A replica add: churn against the rendezvous bound.
        before = router.placement.owners(names)
        new_rid = f"r{R:02d}"
        control.add_replica(InProcessReplica(new_rid, mk()))
        after = router.placement.owners(names)
        moved = FleetPlacement.churn(before, after)
        replaced = control.replace_tenants()
        router.replicas[new_rid].warmup()
        moved_tenants = [t for t in names if after[t] != before[t]]
        out["placement"] = {
            "tenants": T,
            "replicas": R,
            "add_churn_frac": round(moved / T, 4),
            "add_churn_bound": round(1.5 / (R + 1), 4),
            # A large-T concentration bound: tiny fleets record it unbanded.
            "churn_ok": T < 100 or moved / T <= 1.5 / (R + 1),
            "moved": moved,
            "replaced": replaced,
            "moved_tenants_served": all(
                not router.classify(pools[t][0], 10.0, tenant=t).get("degraded")
                for t in moved_tenants[:5]),
        }

        # 4. The replica-kill failover drill.
        victim = router.directory[names[0]].owner
        affected = [t for t, e in router.directory.items() if e.owner == victim]
        install(ChaosRegistry.parse(f"fleet.replica_kill@0:{victim}", logger=logger))
        kill_traffic = _run_fleet_closed(router, pools, names[: min(T, 128)], 2,
                                         max(1.5, args.duration / 3), args.seed + 7)
        install(None)
        crits = [e for e in watchdog.events if e.event == "replica_dead"]
        replaced_kill = control.replace_tenants()
        recovered = all(not router.classify(pools[t][0], 10.0, tenant=t).get("degraded")
                        for t in affected[:5])
        router.revive_replica(victim, reason="drill recovery")
        latch_rearmed = f"replica_dead:{victim}" not in watchdog._latched
        moved_back = control.replace_tenants()
        out["replica_kill"] = {
            "victim": victim,
            "affected_tenants": len(affected),
            "degraded_served": kill_traffic["degraded"],
            "dropped_during_failover": kill_traffic["errors"],
            "criticals": len(crits),
            "once_latched": len(crits) == 1,
            "replaced": replaced_kill,
            "recovered": recovered,
            "latch_rearmed_on_revive": latch_rearmed,
            "moved_back_on_revive": moved_back,
        }
        router.emit_stats()
        final_recompiles = sum(h.stats_snapshot()["steady_recompiles"]
                               for h in router.replicas.values())
        out["zero_bands"] = {"dropped_during_failover": kill_traffic["errors"],
                             "steady_recompiles": final_recompiles}
        out["passed"] = check_fleet_soak(out)
        return out
    finally:
        install(None)
        router.close()
        # Unhook the soak's watchdog: a later drill on the same logger must
        # not see every fault critical twice.
        if watchdog.observe_record in logger.hooks:
            logger.hooks.remove(watchdog.observe_record)
        if own_logger:
            logger.close()


def check_fleet_soak(out: dict) -> bool:
    """The soak's acceptance (the JAX gate)."""
    fp = out.get("fanout_publish", {})
    pl = out.get("placement", {})
    rk = out.get("replica_kill", {})
    zb = out.get("zero_bands", {})
    return bool(
        out.get("placement_consistent")
        and fp.get("params_version") is not None
        and fp.get("uniform")
        and fp.get("dropped") == 0
        and fp.get("steady_recompiles") == 0
        and isinstance(pl.get("add_churn_frac"), float)
        and pl.get("churn_ok")
        and pl.get("moved_tenants_served")
        and rk.get("degraded_served", 0) >= 1
        and rk.get("criticals") == 1
        and rk.get("once_latched")
        and rk.get("recovered")
        and rk.get("latch_rearmed_on_revive")
        and rk.get("dropped_during_failover") == 0
        and zb.get("steady_recompiles") == 0
    )


def fleet_tier1_drill(seed: int = 0, logger=None, device=None) -> dict:
    """The miniature 3-replica fleet, every fleet invariant in one pass:
    placement, mixed traffic, a poisoned fan-out (the middle replica's
    prepare) rolled back atomically, a clean fan-out, the add churn, and
    the replica-kill failover. Deterministic in ``seed``."""
    from induction_network_on_fewrel_tpu_torch.fleet import (
        FleetControl,
        FleetPlacement,
        FleetPublishError,
        FleetRouter,
        InProcessReplica,
    )
    from induction_network_on_fewrel_tpu_torch.obs import HealthWatchdog
    from induction_network_on_fewrel_tpu_torch.obs.chaos import ChaosRegistry, install
    from induction_network_on_fewrel_tpu_torch.serving.breaker import CircuitBreaker
    from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

    R, T = 3, 48
    world = tiny_world(seed, device)
    # A hook-bearing logger even with no run dir: the watchdog's latch
    # assertions need the record stream.
    own_logger = logger if logger is not None else MetricsLogger(None, quiet=True)
    watchdog = HealthWatchdog(logger=own_logger)
    own_logger.add_hook(watchdog.observe_record)

    def mk():
        return world.engine(logger=own_logger)

    replicas = {f"r{i:02d}": InProcessReplica(f"r{i:02d}", mk()) for i in range(R)}
    router = FleetRouter(replicas, logger=own_logger,
                         breaker=CircuitBreaker(failure_threshold=3, open_s=1.0),
                         queue_capacity_per_replica=64)
    control = FleetControl(router)
    out: dict = {"replicas": R, "tenants": T, "seed": seed}
    try:
        names = [f"t{i:02d}" for i in range(T)]
        for i, tenant in enumerate(names):
            control.register_tenant(tenant, world.datasets[i % 4])
        for h in router.replicas.values():
            h.warmup()
        dist = Counter(e.owner for e in router.directory.values())
        out["placement_distribution"] = dict(sorted(dist.items()))
        owners = router.placement.owners(names)
        out["placement_consistent"] = all(owners[t] == router.directory[t].owner for t in names)
        pools = world.pools(names)
        verdicts = [router.classify(pools[t][0], 10.0, tenant=t) for t in names]
        out["traffic_ok"] = all(v["tenant"] == t and not v.get("degraded")
                                for v, t in zip(verdicts, names))

        # A poisoned fan-out: the middle replica's prepare is injected; the
        # whole fleet rolls back with the in-flight batches untouched.
        versions0 = {rid: h.params_version for rid, h in router.replicas.items()}
        futs = [router.submit(pools[t][1], 10.0, tenant=t) for t in names[:8]]
        install(ChaosRegistry.parse("publish.nan_params@1", logger=own_logger))
        try:
            control.publish_params(world.params)
            rolled_back = False
        except FleetPublishError:
            rolled_back = True
        install(None)
        inflight_ok = all("label" in f.result(timeout=30.0) for f in futs)
        out["poisoned_fanout"] = {
            "rolled_back": rolled_back,
            "versions_unchanged": versions0 == {rid: h.params_version
                                                for rid, h in router.replicas.items()},
            "inflight_untouched": inflight_ok,
        }
        version = control.publish_params(world.params)
        out["fanout_publish"] = {
            "params_version": version,
            "uniform": len({h.params_version for h in router.replicas.values()}) == 1,
        }

        # A replica add: churn at the rendezvous bound.
        before = router.placement.owners(names)
        control.add_replica(InProcessReplica(f"r{R:02d}", mk()))
        after = router.placement.owners(names)
        moved = FleetPlacement.churn(before, after)
        control.replace_tenants()
        router.replicas[f"r{R:02d}"].warmup()
        out["add_churn_frac"] = round(moved / T, 4)
        out["add_churn_bound"] = round(1.5 / (R + 1), 4)

        # Replica-kill failover: degraded -> re-place -> recover.
        victim = router.directory[names[0]].owner
        install(ChaosRegistry.parse(f"fleet.replica_kill@0:{victim}", logger=own_logger))
        v_deg = router.classify(pools[names[0]][0], 10.0, tenant=names[0])
        install(None)
        crits = [e for e in watchdog.events if e.event == "replica_dead"]
        router.classify(pools[names[0]][0], 10.0, tenant=names[0])
        crits2 = [e for e in watchdog.events if e.event == "replica_dead"]
        control.replace_tenants()
        v_rec = router.classify(pools[names[0]][0], 10.0, tenant=names[0])
        router.revive_replica(victim, reason="drill")
        out["replica_kill"] = {
            "victim": victim,
            "degraded_verdict": bool(v_deg.get("degraded") and v_deg.get("failover")),
            "criticals": len(crits),
            "once_latched": len(crits2) == 1,
            "recovered": not v_rec.get("degraded"),
            "latch_rearmed_on_revive": f"replica_dead:{victim}" not in watchdog._latched,
        }
        out["steady_recompiles"] = sum(h.stats_snapshot()["steady_recompiles"]
                                       for h in router.replicas.values())
        out["passed"] = bool(
            out["placement_consistent"]
            and out["traffic_ok"]
            and all(out["poisoned_fanout"].values())
            and out["fanout_publish"]["uniform"]
            and out["add_churn_frac"] <= out["add_churn_bound"]
            and out["replica_kill"]["degraded_verdict"]
            and out["replica_kill"]["criticals"] == 1
            and out["replica_kill"]["once_latched"]
            and out["replica_kill"]["recovered"]
            and out["replica_kill"]["latch_rearmed_on_revive"]
            and out["steady_recompiles"] == 0
        )
        return out
    finally:
        install(None)
        router.close()
        if watchdog.observe_record in own_logger.hooks:
            own_logger.hooks.remove(watchdog.observe_record)
        if logger is None:
            own_logger.close()
