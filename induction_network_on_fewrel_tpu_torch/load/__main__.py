"""``python -m induction_network_on_fewrel_tpu_torch.load``: the load
generator's entry point (the JAX ``tools/loadgen.py:3828`` ``main``).

Standalone modes, each on its own world, run first and return: ``--fleet
R`` (the soak, then the tier-1 miniature), ``--recovery_drill``,
``--elastic_drill``, ``--fleet_obs_drill``, ``--adapt_drill``
(``obs/adapt_drill.py``), ``--quant_ab``, ``--geom_ab``. Otherwise each
scheduler arm (``--scheduler ab``: continuous, then microbatch, the same
seeded arrivals) serves the closed and open phases, the swap drill and
the burn drill, then the drift and chaos drills run on engines of their
own. The report goes to stdout as one JSON line (and to ``--artifact``,
``--*_artifact`` when given: a path the caller names, never a default).
Exit code 1 when any gate fails, 2 on a refused flag.
"""

from __future__ import annotations

import json
import sys
import tempfile

import numpy as np

from induction_network_on_fewrel_tpu_torch.load.harness import (
    build_engine,
    build_slo,
    check_serving_dp,
    drive_one,
    engine_params,
    make_synthetic_checkpoint,
    parse_args,
    require_device,
)

PROG = "python -m induction_network_on_fewrel_tpu_torch.load"


def _write(path, report) -> None:
    if path:
        with open(path, "w") as fh:
            json.dump(report, fh, indent=1)
        print(f"wrote {path}", file=sys.stderr)


def _telemetry_note(args) -> None:
    if args.run_dir:
        print(f"telemetry in {args.run_dir} — render with 'python -m "
              f"induction_network_on_fewrel_tpu_torch.tools.obs_report {args.run_dir}'",
              file=sys.stderr)


def fleet_mode(args, ckpt, logger, recorder, capture) -> int:
    from induction_network_on_fewrel_tpu_torch.load.fleet import fleet_tier1_drill, run_fleet_soak

    rc = 0
    soak = run_fleet_soak(args, ckpt, logger, recorder, capture)
    pl, fp, rk = (soak.get("placement", {}), soak.get("fanout_publish", {}),
                  soak.get("replica_kill", {}))
    print(f"[fleet soak] R={args.fleet} T={soak['tenants']} "
          f"qps={soak.get('traffic', {}).get('qps')} publish_s={fp.get('publish_s')} "
          f"uniform={fp.get('uniform')} dropped={fp.get('dropped')} "
          f"recompiles={soak.get('zero_bands', {}).get('steady_recompiles')}; "
          f"add churn {pl.get('add_churn_frac')} (bound {pl.get('add_churn_bound')}); "
          f"kill: degraded={rk.get('degraded_served')} criticals={rk.get('criticals')} "
          f"recovered={rk.get('recovered')}")
    if not soak.get("passed", False):
        print("FAIL[fleet soak]: invariants did not hold", file=sys.stderr)
        rc = 1
    tier1 = fleet_tier1_drill(seed=args.seed, logger=logger, device=args.device)
    if not tier1.get("passed"):
        print("FAIL[fleet tier1]: miniature drill failed", file=sys.stderr)
        rc = 1
    report = {
        "config": {"fleet": args.fleet, "tenants": args.tenants, "N": args.N, "K": args.K,
                   "buckets": args.buckets, "queue_depth": args.queue_depth,
                   "concurrency": args.concurrency, "duration": args.duration,
                   "device": args.device, "seed": args.seed},
        **soak,
        "tier1": {**tier1, "band": {"churn_frac_abs": 0.0}},
    }
    print(json.dumps({k: report[k] for k in
                      ("config", "traffic", "per_replica", "placement", "fanout_publish",
                       "replica_kill", "zero_bands", "passed") if k in report}))
    _write(args.fleet_artifact, report)
    _telemetry_note(args)
    return rc


def recovery_mode(args, logger) -> int:
    from induction_network_on_fewrel_tpu_torch.load.recovery import recovery_tier1_drill

    drill = recovery_tier1_drill(seed=args.seed, logger=logger, device=args.device)
    rk, rep, tt = drill["router_kill"], drill["replica_kill"], drill["torn_tail"]
    print(f"[recovery drill/router-kill] bitwise={rk['directory_bitwise']} "
          f"placement={rk['placement_identical']} lost={rk['tenants_lost']} "
          f"reregistered={rk['reregistered']} caught_up={rk['caught_up']} "
          f"uniform=v{rk['params_version']} errors={rk['errors']}")
    print(f"[recovery drill/replica-kill] victim={rep['victim']} "
          f"attempts={rep['restart_attempts']} backoff_honored={rep['backoff_honored']} "
          f"uniform={rep['params_version_uniform']} recovered={rep['recovered']} "
          f"dropped={rep['dropped_during_catchup']} recompiles={rep['steady_recompiles']}")
    print(f"[recovery drill/torn-tail] refused={tt['append_refused_after_tear']} "
          f"prefix={tt['prefix_recovered']} healed={tt['appendable_after_heal']}")
    rc = 0
    if not drill["passed"]:
        print("FAIL[recovery drill]: durability invariants did not hold", file=sys.stderr)
        rc = 1
    report = {"round": 1, "generated_by": f"{PROG} --recovery_drill", **drill}
    print(json.dumps({k: report[k] for k in ("replicas", "tenants", "zero_bands", "passed")}))
    _write(args.recovery_artifact, report)
    _telemetry_note(args)
    return rc


def elastic_mode(args, logger) -> int:
    from induction_network_on_fewrel_tpu_torch.load.elastic import elastic_tier1_drill

    drill = elastic_tier1_drill(seed=args.seed, logger=logger, device=args.device)
    so, di, pr = drill["scale_out"], drill["drain_in"], drill["promotion"]
    print(f"[elastic drill/scale-out] replica={so['replica']} ticks={so['ticks_to_scale']} "
          f"warm_compiles={so['warm_compiles']} moved={so['moved']} "
          f"uniform=v{so['params_version']} errors={so['errors']}")
    print(f"[elastic drill/drain-in] replica={di['replica']} "
          f"inflight={di['inflight_at_drain']} survived={di['inflight_survived']} "
          f"moved={di['moved']} tenants_intact={di['tenants_intact']} errors={di['errors']}")
    print(f"[elastic drill/promotion] bitwise={pr['directory_bitwise']} "
          f"placement={pr['placement_identical']} lost={pr['tenants_lost']} "
          f"degraded_window={pr['degraded_during_promotion']} "
          f"tail_ops={pr['final_tail_ops']} split_brain_refused={pr['split_brain_refused']} "
          f"promote_s={pr['promote_s']} errors={pr['errors']}")
    rc = 0
    if not drill["passed"]:
        print("FAIL[elastic drill]: elasticity invariants did not hold", file=sys.stderr)
        rc = 1
    report = {"round": 1, "generated_by": f"{PROG} --elastic_drill", **drill}
    print(json.dumps({k: report[k] for k in
                      ("replicas_start", "tenants", "zero_bands", "passed")}))
    _write(args.elastic_artifact, report)
    _telemetry_note(args)
    return rc


def fleet_obs_mode(args) -> int:
    from induction_network_on_fewrel_tpu_torch.load.fleet_obs import fleet_obs_drill

    drill = fleet_obs_drill(seed=args.seed, fleet_dir=args.run_dir, device=args.device)
    st, hp, tl = drill["stitching"], drill["hop"], drill["timeline"]
    print(f"[fleet obs drill] hops={st['hop_records']} coverage={st['stitch_coverage']} "
          f"unstitched_frac={st['unstitched_frac']} orphans={st['orphan_spans']} "
          f"hop_p50={hp['hop_ms_p50']}ms hop_p99={hp['hop_ms_p99']}ms "
          f"router_p50={hp['router_ms_p50']}ms; timeline events={tl['events']} "
          f"journal_ops={tl['journal_ops']} incidents_ordered={tl['incidents_ordered']} "
          f"check_failures={len(drill['check_failures'])}")
    rc = 0
    if not drill["passed"]:
        print("FAIL[fleet obs drill]: stitching/timeline invariants did not hold",
              file=sys.stderr)
        rc = 1
    report = {"round": 1, "generated_by": f"{PROG} --fleet_obs_drill", **drill}
    print(json.dumps({k: report[k] for k in
                      ("replicas", "tenants", "stitching", "hop", "timeline", "zero_bands",
                       "passed")}))
    _write(args.obsfleet_artifact, report)
    print(f"fleet layout in {args.run_dir} — render with "
          f"'python -m induction_network_on_fewrel_tpu_torch.load.fleet_report {args.run_dir}'",
          file=sys.stderr)
    return rc


def adapt_mode(args, logger) -> int:
    from induction_network_on_fewrel_tpu_torch.obs.adapt_drill import adapt_drill

    drill = adapt_drill(seed=args.seed, device=args.device, logger=logger)
    s, f = drill["success"], drill["canary_failure"]
    print(f"[adapt drill/success] tripped={s.get('tripped')} ({s.get('trigger_feature')}) "
          f"nota {s.get('nota_healthy')} -> {s.get('nota_shifted')} -> {s.get('nota_post')}; "
          f"finetune {s.get('finetune_s')}s canary={s.get('canary_passed')} publish "
          f"{s.get('publish_s')}s uniform={s.get('versions_uniform')} "
          f"dropped={s.get('dropped_during_publish')} "
          f"recompiles={s.get('steady_recompiles')} verified={s.get('verified')} "
          f"recover {s.get('recover_s')}s")
    print(f"[adapt drill/canary-failure] tripped={f.get('tripped')} "
          f"backoff_honored={f.get('backoff_honored')} exhausted={f.get('exhausted')} "
          f"criticals={f.get('exhausted_criticals')} quarantined={f.get('quarantined')} "
          f"publishes={f.get('unexpected_publishes')} cleaned={f.get('candidates_cleaned')}")
    rc = 0
    if not drill["passed"]:
        print("FAIL[adapt drill]: the loop did not detect/adapt/gate/verify (or contain) as "
              "required", file=sys.stderr)
        rc = 1
    report = {
        "round": 1, "generated_by": f"{PROG} --adapt_drill", **drill,
        "zero_bands": {"dropped_during_publish": s.get("dropped_during_publish"),
                       "steady_recompiles": s.get("steady_recompiles"),
                       "unexpected_publishes": f.get("unexpected_publishes")},
    }
    print(json.dumps({k: report[k] for k in ("zero_bands", "passed") if k in report}))
    _write(args.adapt_artifact, report)
    _telemetry_note(args)
    return rc


def quant_mode(args, ckpt, logger) -> int:
    from induction_network_on_fewrel_tpu_torch.load.quant import run_quant_ab

    drill = run_quant_ab(args, ckpt, logger=logger)
    den = drill["density"]
    for dt, a in drill["arms"].items():
        print(f"[quant ab/{dt}] qps={a['qps']} p50={a['p50_ms']}ms p99={a['p99_ms']}ms "
              f"bytes/tenant={a['resident_bytes_per_tenant']} probes={a['quant_probes']} "
              f"agreement={a['quant_agreement']} margin_drift={a['quant_margin_drift']} "
              f"dropped={a['dropped']} recompiles={a['steady_recompiles']}")
    print(f"[quant ab/density] f32/int8 bytes ratio {den['bytes_ratio_f32_over_int8']}x, "
          f"projected tenants/card {den['tenants_per_chip_projected']}")
    rc = 0
    if not drill["passed"]:
        print(f"FAIL[quant ab]: {drill['check_failures']}", file=sys.stderr)
        rc = 1
    report = {
        "round": 1, "generated_by": f"{PROG} --quant_ab",
        "config": {"tenants": args.tenants, "N": args.N, "K": args.K, "buckets": args.buckets,
                   "rate": args.rate, "duration": args.duration, "device": args.device,
                   "seed": args.seed},
        **drill,
    }
    print(json.dumps({k: report[k] for k in ("config", "density", "zero_bands", "passed")}))
    _write(args.quant_artifact, report)
    _telemetry_note(args)
    return rc


def geom_mode(args, ckpt, logger) -> int:
    from induction_network_on_fewrel_tpu_torch.load.geom import (
        GEOM_CROSSER_START,
        GEOM_TENANT_N,
        run_geom_ab,
    )

    drill = run_geom_ab(args, ckpt, logger=logger)
    for label, a in drill["arms"].items():
        print(f"[geom ab/{label}] programs={a['program_cache_keys']} "
              f"(compiled {a['programs_compiled']}) qps={a['qps']} p50={a['p50_ms']}ms "
              f"p99={a['p99_ms']}ms parity={a['parity_max_delta']:.2e} "
              f"dropped={a['dropped']} recompiles={a['steady_recompiles']}")
    print("[geom ab/grid] " + " ".join(f"{k}={v['accuracy']}±{v['acc_ci95']}"
                                       for k, v in drill["grid"].items()))
    rc = 0
    if not drill["passed"]:
        print(f"FAIL[geom ab]: {drill['check_failures']}", file=sys.stderr)
        rc = 1
    report = {
        "round": 1, "generated_by": f"{PROG} --geom_ab",
        "config": {"tenant_classes": list(GEOM_TENANT_N) + [GEOM_CROSSER_START],
                   "K": args.K, "buckets": args.buckets, "rate": args.rate,
                   "duration": args.duration, "device": args.device, "seed": args.seed},
        **drill,
    }
    print(json.dumps({k: report[k] for k in
                      ("config", "program_bound_tiered", "zero_bands",
                       "exact_arm_steady_recompiles", "passed")}))
    _write(args.geom_artifact, report)
    _telemetry_note(args)
    return rc


def arm_verdicts(arm: str, r: dict) -> int:
    """Print one scheduler arm's summary; 1 when a gate failed."""
    from induction_network_on_fewrel_tpu_torch.load.burn import burn_ok

    rc = 0
    if not r.get("parity_ok"):
        print(f"FAIL[{arm}]: registry parity out of tolerance", file=sys.stderr)
        rc = 1
    snap = r.get("stats", {})
    print(f"[{arm}] occupancy {snap.get('batch_occupancy')} served {snap.get('served')} "
          f"recompiles {snap.get('steady_recompiles')}")
    if snap.get("steady_recompiles", 0) > 0:
        print(f"FAIL[{arm}]: query path recompiled after warmup", file=sys.stderr)
        rc = 1
    drill = r.get("swap_drill")
    if drill is not None:
        if drill.get("params_version") is None:
            print(f"FAIL[{arm}]: hot-swap publish did not complete: "
                  f"{drill.get('error', 'publish thread hung')}", file=sys.stderr)
            rc = 1
        else:
            print(f"[{arm}] swap drill: published v{drill['params_version']} in "
                  f"{drill.get('publish_s')}s with {drill['inflight_at_swap']} in flight -> "
                  f"dropped {drill['dropped']}")
        if drill["dropped"] > 0:
            print(f"FAIL[{arm}]: hot-swap dropped queries", file=sys.stderr)
            rc = 1
    burn = r.get("burn_drill")
    if burn is not None:
        print(f"[{arm}] burn drill: tripped={burn['tripped']} "
              f"fast_events={burn['fast_burn_events']} once_latched={burn['once_latched']} "
              f"captures={len(burn['captures'])}")
        if not burn_ok(burn):
            print(f"FAIL[{arm}]: burn drill did not trip/latch/capture as required",
                  file=sys.stderr)
            rc = 1
    return rc


def comparison(results: dict) -> dict:
    """The scheduler A/B's comparison block (both arms present)."""
    c, m = results["continuous"], results["microbatch"]
    out = {}
    if "closed" in c and "closed" in m:
        out["closed_qps_continuous"] = c["closed"]["qps"]
        out["closed_qps_microbatch"] = m["closed"]["qps"]
        out["closed_qps_ratio"] = round(c["closed"]["qps"] / max(m["closed"]["qps"], 1e-9), 3)
    if "open" in c and "open" in m:
        out["open_p99_continuous_ms"] = c["open"]["p99_ms"]
        out["open_p99_microbatch_ms"] = m["open"]["p99_ms"]
        if m["open"]["p99_ms"]:
            out["open_p99_ratio"] = round(c["open"]["p99_ms"] / m["open"]["p99_ms"], 3)
    return out


def generator_mode(args, ckpt, logger, recorder, capture) -> int:
    from induction_network_on_fewrel_tpu_torch.load.chaos import check_chaos_drill, run_chaos_drill
    from induction_network_on_fewrel_tpu_torch.load.drift import drift_ok, run_drift_drill

    rc = 0
    results = {}
    arms = ["continuous", "microbatch"] if args.scheduler == "ab" else [args.scheduler]
    for arm in arms:
        rng = np.random.default_rng(args.seed)  # the same arrivals per arm
        engine = build_engine(args, ckpt, arm, logger=logger,
                              slo=build_slo(args, logger=logger, recorder=recorder,
                                            capture=capture))
        try:
            swap_fn = None
            if args.swap_drill:
                # Re-publish the engine's own weights: the whole swap runs
                # under live load; the drill measures disruption.
                swap_fn = lambda e=engine: e.publish_params(engine_params(e))  # noqa: E731
            results[arm] = drive_one(engine, args, rng, swap_fn=swap_fn)
        finally:
            engine.close()
        rc |= arm_verdicts(arm, results[arm])

    drift_result = None
    if args.drift_drill:
        drift_result = drill = run_drift_drill(args, ckpt, logger, recorder, capture)
        print(f"[drift drill] calibrated floor {drill['calibration']['threshold']} "
              f"(clean_frac {drill['calibration']['clean_frac']}) -> "
              f"tripped={drill.get('tripped')} after={drill.get('tripped_after')} shifted "
              f"queries, features={drill.get('drift_features')}, "
              f"once_latched={drill.get('once_latched')}, "
              f"publish_rearm={drill.get('rearmed_on_publish')}, "
              f"clean_after={drill.get('clean_after_publish')}")
        if not drift_ok(drill):
            print("FAIL[drift drill]: did not trip/latch/capture/re-arm as required",
                  file=sys.stderr)
            rc = 1

    chaos_result = None
    if args.chaos_drill:
        chaos_result = drill = run_chaos_drill(args, ckpt, logger, recorder, capture)
        ok = check_chaos_drill(drill)
        rb = drill.get("rollback", {})
        print(f"[chaos drill] breaker: opened={drill.get('breaker_opened')} "
              f"criticals={drill.get('breaker_open_criticals')} "
              f"recovered={drill.get('breaker_recovered')}; "
              f"rollback: refused={rb.get('poisoned_publish_refused')} "
              f"dropped={rb.get('dropped_during_rollback')} "
              f"recompiles={rb.get('steady_recompiles')}; "
              f"rearm: drift={drill.get('drift_rearmed')} slo={drill.get('slo_rearmed')} "
              f"rollback_latch={drill.get('rollback_latch_rearmed')}; "
              f"ckpt: fallback_step={drill.get('ckpt', {}).get('fallback_step')} "
              f"bitwise={drill.get('ckpt', {}).get('bitwise_equal')}")
        if not ok:
            print("FAIL[chaos drill]: containment did not hold as required", file=sys.stderr)
            rc = 1
        _write(args.chaos_artifact, {
            "config": {"tenants": args.tenants, "N": args.N, "K": args.K,
                       "device": args.device, "seed": args.seed,
                       "threshold": drill.get("threshold"), "open_s": drill.get("open_s")},
            "chaos_drill": drill,
            "passed": ok,
            "zero_bands": {"dropped_during_rollback": rb.get("dropped_during_rollback"),
                           "steady_recompiles": rb.get("steady_recompiles")},
        })

    report = {
        "config": {
            "tenants": args.tenants, "N": args.N, "K": args.K, "buckets": args.buckets,
            "queue_depth": args.queue_depth, "tenant_share": args.tenant_share,
            "rate": args.rate, "concurrency": args.concurrency, "duration": args.duration,
            "device": args.device, "serving_dp": args.serving_dp, "seed": args.seed,
            "swap_drill": bool(args.swap_drill), "trace_sample": args.trace_sample,
            "burn_drill": bool(args.burn_drill), "drift_drill": bool(args.drift_drill),
            "chaos_drill": bool(args.chaos_drill), "slo_latency_ms": args.slo_latency_ms,
            "slo_availability": args.slo_availability,
        },
        "arms": results,
    }
    if drift_result is not None:
        report["drift_drill"] = drift_result
    if chaos_result is not None:
        report["chaos_drill"] = chaos_result
    if "continuous" in results and "microbatch" in results:
        report["comparison"] = comparison(results)
        print("A/B: " + json.dumps(report["comparison"]))
    print(json.dumps(report, default=str))
    _write(args.artifact, report)
    _telemetry_note(args)
    return rc


def main(argv=None) -> int:
    args = parse_args(argv)
    require_device(args.device)
    check_serving_dp(args)
    tmp = None
    ckpt = args.ckpt
    if ckpt is None and not (args.adapt_drill or args.recovery_drill or args.elastic_drill
                             or args.fleet_obs_drill):
        tmp = tempfile.TemporaryDirectory(prefix="loadgen_")
        print("building synthetic-data checkpoint...", file=sys.stderr)
        # The quant A/B measures verdict agreement: it needs real margins.
        ckpt = make_synthetic_checkpoint(args, tmp.name,
                                         train_iters=60 if args.quant_ab else 0)
    logger = recorder = capture = None
    if args.run_dir and not args.fleet_obs_drill:
        # (The fleet-obs drill lays its own multi-stream layout there.)
        from induction_network_on_fewrel_tpu_torch.obs import DiagnosticsCapture, FlightRecorder
        from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

        logger = MetricsLogger(args.run_dir)
        recorder = FlightRecorder(out_dir=args.run_dir)
        logger.add_hook(recorder.record_metric)
        capture = DiagnosticsCapture(args.run_dir, recorder=recorder, profile=args.slo_profile)
    try:
        if args.fleet > 0:
            return fleet_mode(args, ckpt, logger, recorder, capture)
        if args.recovery_drill:
            return recovery_mode(args, logger)
        if args.elastic_drill:
            return elastic_mode(args, logger)
        if args.fleet_obs_drill:
            return fleet_obs_mode(args)
        if args.adapt_drill:
            return adapt_mode(args, logger)
        if args.quant_ab:
            return quant_mode(args, ckpt, logger)
        if args.geom_ab:
            return geom_mode(args, ckpt, logger)
        return generator_mode(args, ckpt, logger, recorder, capture)
    finally:
        if capture is not None:
            capture.wait(10.0)
        if logger is not None:
            logger.close()
        if tmp is not None:
            tmp.cleanup()


if __name__ == "__main__":
    sys.exit(main())
