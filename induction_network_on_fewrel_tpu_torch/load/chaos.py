"""The fault-domain drill (the JAX ``tools/loadgen.py:1026-1326``) on the
port's chaos points (``obs/chaos.py``), on an engine of its own:

1. execute faults: injected launch failures for tenant0 fail only that
   batch's futures (typed ``ExecuteError``) and trip its circuit breaker
   (a once-latched ``breaker_open`` CRITICAL); the other tenant keeps
   serving; after the open window a half-open probe recovers the tenant;
2. poisoned publish: a NaN publish is refused by the validation gate and
   rolls back: params_version and every snapshot unchanged, nothing in
   flight dropped, no capture after warmup, one ``publish_rollback``
   CRITICAL;
3. recovery: a clean publish commits (the rollback latch and the drift
   baseline re-arm) and the SLO fast-burn latch re-arms once clean
   traffic drains the window;
4. a corrupted ring slot: ``_chaos_ckpt_leg``.

``_chaos_ckpt_leg`` is the kill -> corrupt -> resume leg in one process: a
tiny lazy-table run (on the CPU, as the JAX leg) writes a ring base and a
delta with a cursor each, the delta is bit-flipped on disk, and a fresh
``CheckpointManager`` (what ``--resume`` builds) must quarantine it and
restore the base bitwise, the cursor following.
"""

from __future__ import annotations

import tempfile
import time
from pathlib import Path

from induction_network_on_fewrel_tpu_torch.load.harness import (
    _pools,
    build_engine,
    engine_params,
    register_tenants,
)


def _state(model, opt, lazy) -> dict:
    """Every tensor of a training state, by name (copies)."""
    out = {f"params/{k}": v.detach().clone() for k, v in model.state_dict().items()}

    def walk(prefix, obj):
        import torch

        if isinstance(obj, torch.Tensor):
            out[prefix] = obj.detach().clone()
        elif isinstance(obj, dict):
            for k, v in obj.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(f"{prefix}/{i}", v)
        else:
            out[prefix] = obj

    walk("opt", opt.state_dict())
    walk("lazy", lazy.state_dict())
    return out


def _chaos_ckpt_leg(logger) -> dict:
    """kill -> corrupt the newest ring slot -> resume, in one process."""
    import torch

    from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
    from induction_network_on_fewrel_tpu_torch.data import (
        GloveTokenizer,
        make_synthetic_fewrel,
        make_synthetic_glove,
    )
    from induction_network_on_fewrel_tpu_torch.models.build import (
        batch_to_model_inputs,
        build_model,
    )
    from induction_network_on_fewrel_tpu_torch.obs.chaos import corrupt_file
    from induction_network_on_fewrel_tpu_torch.sampling.episodes import EpisodeSampler
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager
    from induction_network_on_fewrel_tpu_torch.train.lazy_embed import LazyTable, live_rows
    from induction_network_on_fewrel_tpu_torch.train.steps import (
        make_optimizer,
        make_train_step,
    )

    cfg = ExperimentConfig(
        encoder="cnn", n=3, k=2, q=2, batch_size=2, max_length=12, vocab_size=202,
        hidden_size=16, embed_optimizer="lazy", compute_dtype="float32", ckpt_stage="off",
    )
    vocab = make_synthetic_glove(vocab_size=cfg.vocab_size - 2)
    ds = make_synthetic_fewrel(num_relations=6, instances_per_relation=6, vocab_size=35)
    sampler = EpisodeSampler(ds, GloveTokenizer(vocab, max_length=cfg.max_length),
                             cfg.n, cfg.k, cfg.q, cfg.batch_size, seed=3)
    batches = [batch_to_model_inputs(sampler.sample_batch()) for _ in range(6)]

    def run():
        model = build_model(cfg, glove_init=vocab.vectors, device="cpu")
        opt = make_optimizer(cfg, model)
        lazy = LazyTable(model, opt.hyper, live_rows(cfg))
        opt.attach_compact(lazy.rows, lazy.rows_m, lazy.rows_v)
        return model, opt, lazy

    model, opt, lazy = run()
    step_fn = make_train_step(model, opt, cfg, lazy=lazy)
    work = tempfile.mkdtemp(prefix="chaos_ckpt_")
    mgr = CheckpointManager(work, cfg, logger=logger)
    for sup, qry, lab in batches[:2]:
        step_fn(sup, qry, lab)
    mode_base = mgr.save_latest(2, model, opt, samplers={"cursor": {"pos": 2}},
                                lazy=lazy)["mode"]
    mgr.wait()
    survivor = _state(model, opt, lazy)
    for sup, qry, lab in batches[2:4]:
        step_fn(sup, qry, lab)
    mode_delta = mgr.save_latest(4, model, opt, samplers={"cursor": {"pos": 4}},
                                 lazy=lazy)["mode"]
    mgr.wait()
    mgr.close()    # the "kill": the process owning the run is gone

    corrupted = corrupt_file(Path(work) / "ring_delta.pt", "bitflip")
    mgr2 = CheckpointManager(work, cfg, logger=logger)   # the "--resume"
    model2, opt2, lazy2 = run()
    step, extra = mgr2.restore_latest(model2, opt2, lazy2)
    restored = _state(model2, opt2, lazy2)
    mismatched = []
    for name, va in survivor.items():
        vb = restored.get(name)
        same = (torch.equal(va, vb) if isinstance(va, torch.Tensor)
                and isinstance(vb, torch.Tensor) else va == vb)
        if not same:
            mismatched.append(name)
    mismatched += sorted(set(restored) - set(survivor))
    cursor = (extra.get("samplers") or {}).get("cursor")
    quarantined = sorted(str(p.relative_to(work)) for p in Path(work).rglob("*.quarantined*"))
    mgr2.close()
    return {
        "modes": [mode_base, mode_delta],
        "corrupted_file": corrupted,
        "fallback_step": step,
        "bitwise_equal": not mismatched,
        "mismatched_leaves": mismatched[:8],
        "cursor_followed": bool(cursor) and cursor.get("pos") == step,
        "quarantined": quarantined,
    }


def run_chaos_drill(args, ckpt, logger, recorder, capture) -> dict:
    from induction_network_on_fewrel_tpu_torch.obs import (
        DriftDetector,
        HealthWatchdog,
        SLOEngine,
        SLOObjective,
    )
    from induction_network_on_fewrel_tpu_torch.obs.chaos import ChaosRegistry, install
    from induction_network_on_fewrel_tpu_torch.serving.batcher import ExecuteError, Saturated
    from induction_network_on_fewrel_tpu_torch.serving.breaker import CircuitBreaker
    from induction_network_on_fewrel_tpu_torch.serving.registry import PublishError

    THRESHOLD, OPEN_S, FAST_S = 3, 0.6, 0.75
    watchdog = HealthWatchdog(logger=logger, recorder=recorder, capture=capture)
    if logger is not None:
        logger.add_hook(watchdog.observe_record)
    chaos = ChaosRegistry.parse(
        f"serve.execute_raise@0*{THRESHOLD}:tenant0,publish.nan_params@0", logger=logger)
    chaos.install()
    breaker = CircuitBreaker(failure_threshold=THRESHOLD, open_s=OPEN_S)
    slo = SLOEngine(SLOObjective(availability=args.slo_availability,
                                 latency_ms=args.slo_latency_ms),
                    fast_window_s=FAST_S, slow_window_s=10 * FAST_S,
                    logger=logger, recorder=recorder, capture=capture)
    drift = DriftDetector(window=16, baseline_n=8, min_count=8, eval_interval_s=0.0,
                          logger=logger, recorder=recorder, capture=capture)
    engine = build_engine(args, ckpt, "continuous", logger=logger, slo=slo, drift=drift,
                          breaker=breaker)
    out: dict = {"threshold": THRESHOLD, "open_s": OPEN_S}
    try:
        tenants = register_tenants(engine, args)
        engine.warmup()
        pools = _pools(tenants, args.K)
        t0 = "tenant0"
        others = [t for t in pools if t != t0]

        # 1. Execute faults -> typed errors -> the breaker opens -> shed.
        exec_errors = shed = 0
        for i in range(12):
            try:
                engine.classify(pools[t0][i % len(pools[t0])], tenant=t0)
            except ExecuteError:
                exec_errors += 1
            except Saturated:
                shed += 1
        out["execute_errors"] = exec_errors
        out["shed_while_open"] = shed
        out["breaker_opened"] = breaker.state(t0) == "open"
        other_served = 0
        for t in others:
            for i in range(4):
                v = engine.classify(pools[t][i % len(pools[t])], tenant=t)
                other_served += "label" in v and not v.get("degraded", False)
        out["other_tenant_served"] = other_served
        out["breaker_open_criticals"] = len([
            e for e in watchdog.events if e.event == "breaker_open" and e.severity == "critical"])

        # Recovery: the half-open probe after the window.
        time.sleep(OPEN_S + 0.1)
        v = engine.classify(pools[t0][0], tenant=t0)
        out["probe_served"] = "label" in v
        out["breaker_recovered"] = breaker.state(t0) == "closed"

        # 2. A poisoned publish under in-flight load.
        pv0 = engine.registry.params_version
        versions0 = {t: engine.registry.snapshot(t).version for t in engine.registry.tenants()}
        futs = []
        for i in range(16):
            t = list(pools)[i % len(pools)]
            futs.append(engine.submit(pools[t][i % len(pools[t])], tenant=t))
        try:
            engine.publish_params(engine_params(engine))
            poisoned_raised = False
        except PublishError as e:
            poisoned_raised = True
            out["rollback_reason"] = str(e)[:160]
        dropped = 0
        for f in futs:
            try:
                f.result(timeout=30.0)
            except Exception:  # noqa: BLE001 — any failure is a drop here
                dropped += 1
        snap = engine.stats.snapshot()
        out["rollback"] = {
            "poisoned_publish_refused": poisoned_raised,
            "params_version_before": pv0,
            "params_version_after": engine.registry.params_version,
            "tenant_snapshots_unchanged": versions0 == {
                t: engine.registry.snapshot(t).version for t in engine.registry.tenants()},
            "dropped_during_rollback": dropped,
            "steady_recompiles": snap["steady_recompiles"],
            "rollback_criticals": sum(1 for e in watchdog.events
                                      if e.event == "publish_rollback"),
        }

        # 3. A clean publish commits; the latches re-arm.
        rearms_before = drift.rearms
        out["clean_publish_version"] = engine.publish_params(engine_params(engine))
        out["drift_rearmed"] = drift.rearms == rearms_before + 1
        out["rollback_latch_rearmed"] = "publish_rollback" not in watchdog._latched
        slo.evaluate()
        out["slo_tripped_during_faults"] = slo.tripped
        time.sleep(FAST_S + 0.2)
        for i in range(15):
            engine.classify(pools[t0][i % len(pools[t0])], tenant=t0)
        slo.evaluate()
        out["slo_rearmed"] = f"slo_burn:{t0}:fast" not in slo._latched
        out["stats"] = engine.stats.snapshot(queue_depth=engine.batcher.queue_depth)
    finally:
        engine.close()
        install(None)

    # 4. kill -> corrupt -> resume (its own tiny training world).
    out["ckpt"] = _chaos_ckpt_leg(logger)
    out["ckpt_corrupt_criticals"] = sum(1 for e in watchdog.events
                                        if e.event == "ckpt_corrupt")
    out["injected"] = len(chaos.fired_log)
    return out


def check_chaos_drill(drill: dict) -> bool:
    """The drill's acceptance: inject -> contain -> recover, all held (the
    JAX gate)."""
    rb = drill.get("rollback", {})
    return bool(
        drill.get("breaker_opened")
        and drill.get("breaker_open_criticals") == 1
        and drill.get("execute_errors", 0) >= 1
        and drill.get("other_tenant_served", 0) >= 1
        and drill.get("probe_served")
        and drill.get("breaker_recovered")
        and rb.get("poisoned_publish_refused")
        and rb.get("params_version_before") == rb.get("params_version_after")
        and rb.get("tenant_snapshots_unchanged")
        and rb.get("dropped_during_rollback") == 0
        and rb.get("steady_recompiles") == 0
        and rb.get("rollback_criticals") == 1
        and drill.get("drift_rearmed")
        and drill.get("rollback_latch_rearmed")
        and drill.get("slo_rearmed")
        and drill.get("ckpt", {}).get("bitwise_equal")
        and drill.get("ckpt", {}).get("cursor_followed")
        and drill.get("ckpt", {}).get("quarantined")
        and drill.get("ckpt_corrupt_criticals", 0) >= 1
    )
