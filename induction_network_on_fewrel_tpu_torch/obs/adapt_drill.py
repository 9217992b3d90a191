"""The self-healing adaptation drill: both arms of the JAX repository's
``tools/loadgen.py`` drill (``_adapt_world``, ``run_adapt_success_arm``,
``run_adapt_failure_arm``, ``check_adapt_drill``), over the port's fleet,
engine, fine-tune and canary.

* ``adapt_world`` trains the source artifact (``make_synthetic_fewrel``)
  and makes its shifted twin (``make_domain_shifted_fewrel``, the wiki ->
  pubmed shift in miniature: the same relations, the trigger words moved
  to a disjoint vocabulary block).
* The success arm: clean traffic arms the drift baseline; target traffic
  collapses to NOTA and trips a drift CRITICAL; the controller fine-tunes
  (``train/finetune.mixture_finetune``), holds the candidate to the canary
  floors (``obs/canary.run_canary``), publishes it through the fleet's
  all-or-nothing fan-out with requests in flight, and verifies once the
  re-armed detector's NOTA rate is back in band.
* The failure arm: ``adapt.canary_fail`` fails every canary: zero
  publishes, the backoff honoured, ``adapt_exhausted`` latched once, the
  tenant quarantined, every candidate removed.

``ADAPT_WORLD`` is the JAX drill's miniature (a CNN on a 300-word
vocabulary), which runs on the CPU in seconds; a caller passes its own
config (the flagship BiLSTM on the card) and knobs. ``check_adapt_drill``
is the JAX gate, copied.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import os
import tempfile
import time

# The JAX drill's miniature world (``tools/loadgen.py:1327``): a
# source-trained model collapses to the all-NOTA basin on the shifted twin
# and a mixture-ramp fine-tune recovers it. CE loss, seed 1.
ADAPT_WORLD = dict(
    num_relations=5, instances_per_relation=20,
    train_iters=140, finetune_steps=100,
    # grid_5w2s: the canary also runs a 5-way grid point, another geometry
    # than the 2-way fine-tune's.
    canary_floors={"in_domain": 0.6, "target": 0.5, "grid_5w2s": 0.3},
    canary_episodes=48,
    drift=dict(window=32, baseline_n=24, min_count=16),
    cfg=dict(
        model="induction", encoder="cnn", hidden_size=64,
        induction_dim=32, ntn_slices=32, routing_iters=2,
        train_n=2, n=2, k=2, q=2, na_rate=1, batch_size=4,
        max_length=16, vocab_size=302, word_dim=50,
        compute_dtype="float32", loss="ce", lr=5e-3,
        weight_decay=0.0, val_step=0, seed=1,
    ),
)

TENANT = "tenant0"


def adapt_world(seed: int, tmpdir: str, cfg=None, plan: dict | None = None, device=None,
                init_params=None):
    """(cfg, tok, vocab, src, tgt, ckpt_dir): the source-trained live
    artifact (``plan["train_iters"]`` steps from ``cfg``'s fresh init, saved
    as a best slot) and the two corpora. ``cfg`` defaults to
    ``ADAPT_WORLD["cfg"]``; the corpora draw from its vocabulary.
    ``init_params`` (a state_dict) replaces the fresh init; the JAX
    trainer draws one batch to initialize its state, so the training
    stream then starts one batch later, as the JAX world's does."""
    from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
    from induction_network_on_fewrel_tpu_torch.data import (
        GloveTokenizer,
        make_domain_shifted_fewrel,
        make_synthetic_fewrel,
        make_synthetic_glove,
    )
    from induction_network_on_fewrel_tpu_torch.models.build import build_model
    from induction_network_on_fewrel_tpu_torch.sampling.episodes import EpisodeSampler
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager
    from induction_network_on_fewrel_tpu_torch.train.framework import FewShotTrainer
    from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

    plan = plan or ADAPT_WORLD
    cfg = cfg or ExperimentConfig(**plan["cfg"])
    vocab = make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim)
    tok = GloveTokenizer(vocab, max_length=cfg.max_length)
    src = make_synthetic_fewrel(num_relations=plan["num_relations"],
                                instances_per_relation=plan["instances_per_relation"],
                                vocab_size=cfg.vocab_size - 2, seed=seed)
    tgt = make_domain_shifted_fewrel(num_relations=plan["num_relations"],
                                     instances_per_relation=plan["instances_per_relation"],
                                     vocab_size=cfg.vocab_size - 2, shift=1.0, seed=seed)
    model = build_model(cfg, glove_init=vocab.vectors, device=device)
    sampler = EpisodeSampler(src, tok, n=cfg.n, k=cfg.k, q=cfg.q, batch_size=cfg.batch_size,
                             na_rate=cfg.na_rate, seed=seed + 1)
    if init_params is not None:
        model.load_state_dict(init_params)
        sampler.sample_batch()
    ckpt = os.path.join(tmpdir, "live_ckpt")
    trainer = FewShotTrainer(model, cfg, sampler, logger=MetricsLogger(quiet=True))
    try:
        step = trainer.train(num_iters=plan["train_iters"])
        mngr = CheckpointManager(ckpt, cfg, stage="off")
        try:
            mngr.save(step, model, trainer.opt, val_accuracy=0.0)
            mngr.wait()
        finally:
            mngr.close()
    finally:
        trainer.close()
    return cfg, tok, vocab, src, tgt, ckpt


def adapt_pools(src, tgt, k: int):
    """Held-out (post-support) query pools per domain."""
    return ([i for r in src.rel_names for i in src.instances[r][k:]],
            [i for r in tgt.rel_names for i in tgt.instances[r][k:]])


def replica_engine(cfg, tok, ckpt: str, *, drift=None, logger=None, buckets=(1, 2, 4),
                   device=None, **kw):
    """An engine on its own copy of the checkpoint's weights (a replica's
    registry writes its parameter banks in place, so replicas share none)."""
    from induction_network_on_fewrel_tpu_torch.models.build import build_model
    from induction_network_on_fewrel_tpu_torch.serving.engine import InferenceEngine
    from induction_network_on_fewrel_tpu_torch.serving.registry import load_params

    model = build_model(cfg, device=device)
    model.load_state_dict(load_params(ckpt))
    return InferenceEngine(model, cfg, tok, k=cfg.k, buckets=buckets, device=device,
                           logger=logger, drift=drift, **kw)


def build_adapt_controller(cfg, tok, src, tgt, ckpt, drift, publish_fn, quarantine_fn,
                           tmpdir, *, steps, plan: dict | None = None, device=None,
                           logger=None, recorder=None, capture=None, **kw):
    """The drill's controller: the real mixture fine-tune, the real canary
    (on a model of its own per candidate), the caller's (fan-out) publish;
    the serving CLI's wiring at drill scale. Returns (controller, work dir)."""
    from induction_network_on_fewrel_tpu_torch.models.build import build_model
    from induction_network_on_fewrel_tpu_torch.obs.adapt import (
        AdaptationController,
        make_checkpoint_loop,
    )
    from induction_network_on_fewrel_tpu_torch.obs.canary import run_canary
    from induction_network_on_fewrel_tpu_torch.serving.registry import load_params
    from induction_network_on_fewrel_tpu_torch.train.finetune import mixture_finetune

    plan = plan or ADAPT_WORLD
    work = tempfile.mkdtemp(dir=tmpdir, prefix="candidates_")

    def finetune(src_ckpt, out, seq, attempt, step_budget, wall_budget_s):
        return mixture_finetune(src_ckpt, out, src, tgt, tok, steps=step_budget,
                                wall_budget_s=wall_budget_s, seed=cfg.seed + 100 + seq,
                                device=device, logger=logger)

    train_fn, publish, cleanup, current_fn = make_checkpoint_loop(
        ckpt, work, finetune, publish_fn, prefix="cand_")

    def canary_fn(candidate):
        floors = dict(plan["canary_floors"])
        legs = {"in_domain": src, "target": tgt}
        for name in floors:
            if name.startswith("grid_"):
                legs[name] = src
        return run_canary(build_model(cfg, device=device), load_params(candidate), cfg, tok,
                          legs=legs, floors=floors, episodes=plan["canary_episodes"],
                          seed=cfg.seed + 7)

    controller = AdaptationController(
        train_fn, canary_fn, publish, drift=drift, current_fn=current_fn,
        cleanup_fn=cleanup, quarantine_fn=quarantine_fn, step_budget=steps,
        logger=logger, recorder=recorder, capture=capture, **kw)
    return controller, work


def settle(cond, timeout_s: float = 10.0) -> bool:
    """Wait until ``cond()`` holds (or ``timeout_s`` passes). A replica's
    worker resolves a request's future before it hands the verdict to the
    drift detector, so a client that has its answer can be ahead of the
    detector by the last batch."""
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    return cond()


def drive(classify, pool, cap: int, stop=None, count_nota: bool = False):
    """Classify pool instances round-robin until ``stop()`` or ``cap``
    calls; returns (calls, nota_count)."""
    nota = 0
    for i in range(cap):
        if stop is not None and stop():
            return i, nota
        v = classify(pool[i % len(pool)])
        nota += bool(v.get("nota")) if count_nota else 0
    return cap, nota


def _watching(tenants):
    """A DriftDetector class that observes only ``tenants``."""
    from induction_network_on_fewrel_tpu_torch.obs.drift import DriftDetector

    class Watching(DriftDetector):
        def observe(self, tenant, *args, **kw):
            if tenant in tenants:
                return super().observe(tenant, *args, **kw)
            return []

    return Watching


def run_adapt_success_arm(cfg, tok, src, tgt, ckpt, tmpdir, *, plan: dict | None = None,
                          replicas: int = 3, device=None, logger=None, recorder=None,
                          capture=None, on_verdict=None, during_attempt=None,
                          after_warmup=None, buckets=(1, 2, 4), watch=None) -> dict:
    """Inject shift -> drift CRITICAL -> mixture fine-tune -> canary pass
    -> all-or-nothing fan-out publish over ``replicas`` in-process replicas
    (0 dropped, 0 steady captures, params_version uniform) -> NOTA rate
    back in band -> detector re-armed -> controller verified.

    ``on_verdict(stage, verdict)`` sees every verdict the arm's traffic
    gets (stages ``baseline``, ``shift``, ``post``); ``after_warmup(router,
    control)`` runs once the fleet is warm, before any traffic;
    ``during_attempt(router, pools)`` is a context manager factory entered
    around the adaptation attempt (traffic kept in flight while the
    fine-tune runs). ``watch``: the tenants the drift detector observes
    (default all), so that a caller's own load on another tenant cannot
    start a loop of its own."""
    from induction_network_on_fewrel_tpu_torch.fleet import (
        FleetControl,
        FleetRouter,
        InProcessReplica,
    )
    from induction_network_on_fewrel_tpu_torch.obs.adapt import COOLDOWN, TRIGGERED, VERIFYING
    from induction_network_on_fewrel_tpu_torch.obs.drift import DriftDetector

    plan = plan or ADAPT_WORLD
    dknobs = plan["drift"]
    # One detector shared by every replica (keyed by tenant): a committed
    # fan-out re-arms it once.
    drift = (DriftDetector if watch is None else _watching(watch))(
        eval_interval_s=0.0, logger=logger, recorder=recorder, capture=capture, **dknobs)
    handles = {f"r{i}": InProcessReplica(f"r{i}", replica_engine(
        cfg, tok, ckpt, drift=drift, logger=logger, buckets=buckets, device=device))
        for i in range(replicas)}
    router = FleetRouter(handles, logger=logger)
    control = FleetControl(router)
    out: dict = {"replicas": replicas}
    src_pool, tgt_pool = adapt_pools(src, tgt, cfg.k)
    # The zero-drop proof rides inside the publish: a burst of clean
    # queries is submitted just before the fan-out, so the hot-swap commits
    # with requests in flight.
    inflight: dict = {"futures": [], "submitted": 0}

    def publish_with_inflight_load(candidate):
        seen0 = drift.observed(TENANT)
        futs = [router.submit(src_pool[i % len(src_pool)], 30.0, tenant=TENANT)
                for i in range(16)]
        inflight["futures"].extend(futs)
        inflight["submitted"] += len(futs)
        t0 = time.monotonic()
        version = control.publish_checkpoint(candidate)
        out["fanout_publish_ms"] = round((time.monotonic() - t0) * 1e3, 3)
        # Burst verdicts served or observed after the last commit's re-arm
        # would enter the post-publish baseline beside the target traffic
        # (all 16 of them: a window of 16 target verdicts is judged against
        # a baseline of mostly clean ones, and can re-trip). Drain the
        # burst, wait until the detector has seen it, then re-arm, so the
        # baseline holds post-publish traffic only. The JAX drill
        # (``tools/loadgen.py``) does not.
        concurrent.futures.wait(futs, timeout=30.0)
        answered = sum(1 for f in futs if f.done() and f.exception() is None)
        settle(lambda: drift.observed(TENANT) >= seen0 + answered)
        drift.rearm(TENANT, reason="in-flight burst drained")
        return version

    controller, work = build_adapt_controller(
        cfg, tok, src, tgt, ckpt, drift, publish_with_inflight_load,
        lambda t, reason="": control.quarantine_tenant(t, reason=reason),
        tmpdir, steps=plan["finetune_steps"], plan=plan, device=device,
        logger=logger, recorder=recorder, capture=capture,
        retry_budget=3, backoff_s=0.5, cooldown_s=5.0,
        verify_window_s=120.0, wall_budget_s=120.0)
    out["work"] = work
    try:
        control.register_tenant(TENANT, src)
        for h in router.replicas.values():
            h.warmup()
        if after_warmup is not None:
            after_warmup(router, control)
        stage = {"name": "baseline"}

        def classify(inst):
            v = router.classify(inst, 30.0, tenant=TENANT)
            if on_verdict is not None:
                on_verdict(stage["name"], v)
            return v

        # 1. The calibration baseline from clean in-domain traffic.
        drive(classify, src_pool, dknobs["baseline_n"] + dknobs["min_count"] + 8)
        out["baseline_armed"] = settle(lambda: drift.armed(TENANT))
        healthy = drift.baseline_for(TENANT)
        out["nota_healthy"] = healthy["nota_rate"][0] if healthy else None
        # 2. The domain shift: a fixed window of target-twin traffic (the
        # recorded NOTA rate measures the collapse, not the trip latency).
        stage["name"] = "shift"
        calls, nota_shift = drive(classify, tgt_pool, 2 * dknobs["window"], count_nota=True)
        out["tripped"] = settle(lambda: controller.state_of(TENANT) == TRIGGERED)
        out["shift_queries"] = calls
        out["nota_shifted"] = round(nota_shift / max(calls, 1), 4)
        trigger = [r for r in controller.records if r["action"] == "trigger"]
        out["trigger_feature"] = trigger[0].get("feature") if trigger else None
        if not out["tripped"]:
            out["verified"] = False
            return out
        t_trigger = time.monotonic()
        # 3. The attempt: fine-tune, canary, fan-out publish with requests
        # in flight.
        versions0 = {rid: h.engine.registry.params_version for rid, h in handles.items()}
        ctx = (during_attempt(router, (src_pool, tgt_pool)) if during_attempt is not None
               else contextlib.nullcontext())
        t0 = time.monotonic()
        with ctx:
            processed = controller.run_once()
        out["adapt_wall_s"] = round(time.monotonic() - t0, 3)
        out["processed"] = processed
        out["state_after_publish"] = controller.state_of(TENANT)
        out["published"] = controller.state_of(TENANT) == VERIFYING
        recs = {r["action"]: r for r in controller.records}
        out["finetune_s"] = recs.get("train", {}).get("train_s")
        out["canary_passed"] = recs.get("canary", {}).get("passed") == 1.0
        out["canary_first_failure"] = recs.get("canary", {}).get("first_failure")
        out["publish_s"] = recs.get("publish", {}).get("publish_s")
        dropped = 0
        for fut in inflight["futures"]:
            try:
                fut.result(timeout=30.0)
            except Exception:  # noqa: BLE001 — any failure is a drop
                dropped += 1
        out["inflight_at_publish"] = inflight["submitted"]
        out["dropped_during_publish"] = dropped
        versions1 = {rid: h.engine.registry.params_version for rid, h in handles.items()}
        out["params_version_before"] = sorted(versions0.values())[0]
        out["params_versions_after"] = sorted(set(versions1.values()))
        out["versions_uniform"] = (len(set(versions1.values())) == 1
                                   and all(versions1[r] == versions0[r] + 1 for r in versions1))
        out["steady_recompiles"] = sum(h.engine.stats.snapshot()["steady_recompiles"]
                                       for h in handles.values())
        # 4. Verification: exactly baseline_n adapted target queries
        # re-baseline the re-armed detector.
        stage["name"] = "post"
        rearms_at_publish = drift.rearms
        drive(classify, tgt_pool, dknobs["baseline_n"])
        settle(lambda: drift.armed(TENANT))
        post = drift.baseline_for(TENANT)
        out["nota_post"] = post["nota_rate"][0] if post else None
        out["rearmed"] = drift.armed(TENANT) and rearms_at_publish >= 1
        controller.tick()
        out["verified"] = controller.state_of(TENANT) == COOLDOWN
        out["trigger_to_verified_s"] = round(time.monotonic() - t_trigger, 3)
        ver = [r for r in controller.records if r["action"] == "verified"]
        if ver:
            out["recover_s"] = ver[-1].get("recover_s")
            out["nota_band"] = ver[-1].get("nota_band")
        out["loops"] = controller.loop_info(TENANT)["loops"]
        out["candidate"] = controller.current_fn()
        out["records"] = list(controller.records)
        return out
    finally:
        controller.close()
        router.close()


def run_adapt_failure_arm(cfg, tok, src, tgt, ckpt, tmpdir, *, plan: dict | None = None,
                          retries: int = 2, backoff_s: float = 30.0, device=None,
                          logger=None, recorder=None, capture=None, journal=None,
                          on_attempt=None, buckets=(1, 2, 4)) -> dict:
    """Forced canary failure (``adapt.canary_fail``): the candidate is
    discarded (zero publishes), the retries honour the exponential backoff
    (on an injected clock), and the retry budget exhausts into one
    permanent ``adapt_exhausted`` CRITICAL and the tenant's quarantine.
    With ``journal`` the latch is written to it. ``on_attempt(index)`` runs
    before each attempt (a caller's memory reading)."""
    from induction_network_on_fewrel_tpu_torch.obs.adapt import EXHAUSTED, TRIGGERED
    from induction_network_on_fewrel_tpu_torch.obs.chaos import ChaosRegistry, install
    from induction_network_on_fewrel_tpu_torch.obs.drift import DriftDetector

    plan = plan or ADAPT_WORLD
    dknobs = plan["drift"]
    drift = DriftDetector(eval_interval_s=0.0, logger=logger, recorder=recorder,
                          capture=capture, **dknobs)
    engine = replica_engine(cfg, tok, ckpt, drift=drift, logger=logger, buckets=buckets,
                            device=device)
    chaos = ChaosRegistry.parse(f"adapt.canary_fail@0*{retries}:{TENANT}", logger=logger)
    chaos.install()
    out: dict = {"retry_budget": retries, "backoff_s": backoff_s}
    # Tiny fine-tunes: the chaos point fails the canary regardless, so the
    # arm drills the retry, backoff and exhaustion machinery.
    controller, work = build_adapt_controller(
        cfg, tok, src, tgt, ckpt, drift, engine.publish_checkpoint,
        lambda t, reason="": engine.quarantine_tenant(t, reason=reason),
        tmpdir, steps=8, plan=plan, device=device, logger=logger, recorder=recorder,
        capture=capture, retry_budget=retries, backoff_s=backoff_s,
        verify_window_s=60.0, wall_budget_s=60.0, journal=journal)
    try:
        engine.register_dataset(src, tenant=TENANT)
        engine.warmup()
        src_pool, tgt_pool = adapt_pools(src, tgt, cfg.k)

        def classify(inst):
            return engine.classify(inst, tenant=TENANT)

        drive(classify, src_pool, dknobs["baseline_n"] + dknobs["min_count"] + 8)
        settle(lambda: drift.armed(TENANT))
        drive(classify, tgt_pool, 2 * dknobs["window"],
              stop=lambda: controller.state_of(TENANT) == TRIGGERED)
        out["tripped"] = settle(lambda: controller.state_of(TENANT) == TRIGGERED)
        if not out["tripped"]:
            return out
        pv0 = engine.registry.params_version
        swaps0 = engine.stats.snapshot()["swaps"]
        # Attempt 1: the fine-tune runs, the canary is failed, the candidate
        # discarded, the backoff scheduled.
        now = 1000.0
        if on_attempt is not None:
            on_attempt(1)
        out["attempt1_ran"] = controller.run_once(now=now) == TENANT
        info = controller.loop_info(TENANT)
        out["attempt1_failed"] = info["state"] == TRIGGERED and info["attempts"] == 1
        # The backoff: a retry before not_before does not run.
        out["backoff_honored"] = controller.run_once(now=now + 0.5 * backoff_s) is None
        # Past the backoff the last attempts burn the budget: EXHAUSTED and
        # quarantined, permanently.
        for a in range(2, retries + 1):
            if on_attempt is not None:
                on_attempt(a)
            ran = controller.run_once(now=now + (2 ** (a - 1) - 1) * backoff_s + a) == TENANT
            out[f"attempt{a}_ran"] = ran
        if on_attempt is not None:
            on_attempt(retries + 1)
        out["exhausted"] = controller.state_of(TENANT) == EXHAUSTED
        out["exhausted_criticals"] = sum(1 for e in controller.events
                                         if e.event == "adapt_exhausted")
        out["quarantined"] = engine.registry.snapshot(TENANT).degraded
        out["retrigger_absorbed"] = not controller.trigger(TENANT, now=now + 500.0)
        out["candidates_cleaned"] = not any(p.startswith("cand_") for p in os.listdir(work))
        snap = engine.stats.snapshot()
        out["unexpected_publishes"] = (engine.registry.params_version - pv0
                                       + snap["swaps"] - swaps0)
        out["canary_fail_records"] = sum(1 for r in controller.records
                                         if r["action"] == "canary" and r.get("passed") == 0.0)
        out["injected"] = len(chaos.fired_log)
        # The quarantined tenant's verdicts: degraded NOTA.
        degraded = [classify(i) for i in tgt_pool[:4]]
        out["degraded_verdicts"] = sum(bool(v.get("degraded")) and bool(v.get("nota"))
                                       for v in degraded)
        out["engine"] = engine
        return out
    finally:
        controller.close()
        install(None)
        if "engine" not in out:
            engine.close()


def adapt_drill(seed: int = 1, device=None, logger=None, init_params=None) -> dict:
    """Both arms in one world at ``ADAPT_WORLD``; ``passed`` is
    ``check_adapt_drill`` of the result."""
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="adapt_drill_") as tmpdir:
        cfg, tok, _, src, tgt, ckpt = adapt_world(seed, tmpdir, device=device,
                                                  init_params=init_params)
        out = {"seed": seed, "config": dict(ADAPT_WORLD["cfg"]),
               "success": run_adapt_success_arm(cfg, tok, src, tgt, ckpt, tmpdir,
                                                device=device, logger=logger),
               "canary_failure": run_adapt_failure_arm(cfg, tok, src, tgt, ckpt, tmpdir,
                                                       device=device, logger=logger)}
        out["canary_failure"].pop("engine").close()
    out["wall_s"] = round(time.monotonic() - t0, 1)
    out["passed"] = check_adapt_drill(out)
    return out


def check_adapt_drill(drill: dict) -> bool:
    """The drill's acceptance (the JAX gate): detect -> adapt -> gate ->
    publish -> verify on the success arm; discard -> backoff -> exhaust ->
    contain on the failure arm."""
    s = drill.get("success", {})
    f = drill.get("canary_failure", {})
    return bool(
        s.get("baseline_armed")
        and s.get("tripped")
        and s.get("canary_passed")
        and s.get("published")
        and s.get("versions_uniform")
        and s.get("dropped_during_publish") == 0
        and s.get("steady_recompiles") == 0
        and s.get("rearmed")
        and s.get("verified")
        and s.get("nota_shifted", 0) >= 0.5
        and abs(s.get("nota_post", 1.0) - s.get("nota_healthy", 0.0))
        <= max(s.get("nota_band") or 0.05, 0.05) + 1e-9
        and f.get("tripped")
        and f.get("attempt1_failed")
        and f.get("backoff_honored")
        and f.get("exhausted")
        and f.get("exhausted_criticals") == 1
        and f.get("quarantined")
        and f.get("retrigger_absorbed")
        and f.get("candidates_cleaned")
        and f.get("unexpected_publishes") == 0
        and f.get("canary_fail_records") == f.get("retry_budget")
    )
