"""The drift drill (the JAX ``tools/loadgen.py:804-1025``): the model-
quality phase on an engine of its own.

1. probe: in-domain and constant out-of-vocabulary traffic; an open-set
   NOTA floor calibrated from the verdicts' NOTA gaps splits the two
   deterministically (``calibrate_drift_floor``);
2. baseline: the detector re-armed, clean in-domain traffic until the
   baseline captures and the window fills;
3. shift: OOV traffic moves the NOTA rate by exactly 1.0: a once-latched
   CRITICAL with diagnostics on disk;
4. once-latch: more shifted traffic fires nothing new per feature;
5. publish re-arm: a hot-swap of the engine's own weights re-arms the
   detector, and clean traffic re-baselines without a NOTA-rate event.

``drill_engine`` runs steps 1-5 on a caller's engine and tenant (the
card's smoke script drives it on a trained checkpoint); ``run_drift_drill``
is the tool's arm on the synthetic checkpoint.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from induction_network_on_fewrel_tpu_torch.load.harness import (
    _pools,
    build_engine,
    engine_params,
    register_tenants,
)


def _oov_instance(i: int = 0):
    """A constant out-of-vocabulary query: every token misses the word
    table and maps to UNK, so repeated submissions are a point mass in
    logit space (always strictly on one side of a threshold)."""
    from induction_network_on_fewrel_tpu_torch.data.fewrel import Instance

    toks = tuple(f"zqxdrift{i}" for _ in range(8))
    return Instance(tokens=toks, head_pos=(0,), tail_pos=(1,))


def _nota_gap(verdict: dict) -> float:
    """The scalar the engine's NOTA decision thresholds on: the best class
    logit, minus the NOTA logit when a trained head exists. Either way the
    verdict is NOTA iff this gap is below the threshold."""
    from induction_network_on_fewrel_tpu_torch.serving.engine import NO_RELATION

    best = max(v for k, v in verdict["logits"].items() if k != NO_RELATION)
    if NO_RELATION in verdict["logits"]:
        return best - verdict["logits"][NO_RELATION]
    return best


def calibrate_drift_floor(in_gaps, oov_gaps) -> dict:
    """The NOTA threshold and the clean pool that make the drill
    deterministic: the OOV probe is a point mass at ``v`` (the median of
    its gaps), and a threshold strictly between ``v`` and the in-domain
    gaps on the more-populated side of it gives a baseline NOTA rate of
    exactly 0 (or 1) and a shifted rate of exactly 1 (or 0). Returns
    {threshold, clean_idx, clean_frac, base_rate, shift_rate}."""
    in_l = np.asarray(in_gaps, dtype=np.float64)
    v = float(np.median(np.asarray(oov_gaps, dtype=np.float64)))
    eps = max(1e-9, 1e-6 * max(abs(v), 1.0))
    above = np.flatnonzero(in_l > v + eps)
    below = np.flatnonzero(in_l < v - eps)
    if len(above) == 0 and len(below) == 0:
        return {"threshold": None, "clean_idx": [], "clean_frac": 0.0,
                "base_rate": None, "shift_rate": None}
    if len(above) >= len(below):
        thr = (v + float(in_l[above].min())) / 2.0
        clean, base_rate, shift_rate = above, 0.0, 1.0
    else:
        thr = (float(in_l[below].max()) + v) / 2.0
        clean, base_rate, shift_rate = below, 1.0, 0.0
    return {
        "threshold": round(thr, 6),
        "clean_idx": [int(i) for i in clean],
        # The minority side straddling v is left out of drill traffic.
        "clean_frac": round(len(clean) / max(len(in_l), 1), 4),
        "base_rate": base_rate,
        "shift_rate": shift_rate,
    }


def drill_engine(engine, drift, pool: list, tenant: str) -> dict:
    """Steps 1-5 on ``engine`` (warmed, ``tenant`` registered, ``drift``
    its detector) over the held-out ``pool``; returns the JAX drill's
    dict."""
    oov = _oov_instance()

    def classify_many(insts) -> list[dict]:
        return [engine.classify(i, tenant=tenant) for i in insts]

    out: dict = {}
    # 1. Probe and calibrate (everything fed to the detector so far is
    # dropped by the re-arm that setting the threshold makes).
    probe_in = classify_many(pool)
    probe_oov = classify_many([oov] * 3)
    cal = calibrate_drift_floor([_nota_gap(v) for v in probe_in],
                                [_nota_gap(v) for v in probe_oov])
    out["calibration"] = {k: cal[k] for k in
                          ("threshold", "base_rate", "shift_rate", "clean_frac")}
    out["clean_pool"] = len(cal["clean_idx"])
    if cal["threshold"] is None or not cal["clean_idx"]:
        out["tripped"] = False
        return out
    clean = [pool[i] for i in cal["clean_idx"]]
    engine.set_nota_threshold(cal["threshold"], tenant=tenant)
    out["rearmed_on_calibration"] = not drift.armed(tenant)
    # Drill accounting starts here: events latched on probe traffic do not
    # count.
    drill_start = len(drift.events)

    def drill_events():
        return list(drift.events)[drill_start:]

    # 2. A fresh baseline under the floor, from the clean pool.
    n_base = drift.baseline_n + drift.min_count + 8
    classify_many(clean[i % len(clean)] for i in range(n_base))
    out["baseline_armed"] = drift.armed(tenant)
    out["baseline"] = drift.baseline_for(tenant)

    # 3. The injected shift: constant-OOV traffic.
    tripped_after = None
    for i in range(drift.window):
        engine.classify(oov, tenant=tenant)
        if any(e.severity == "critical" for e in drill_events()):
            tripped_after = i + 1
            break
    crits = [e for e in drill_events() if e.severity == "critical"]
    out["tripped"] = bool(crits)
    out["tripped_after"] = tripped_after
    out["critical_events"] = len(crits)
    out["drift_features"] = sorted({e.data.get("feature") for e in crits})
    out["state_at_trip"] = drift.drift_state(tenant)

    # 4. Once-latch: at most one critical per (tenant, feature).
    classify_many([oov] * drift.min_count)
    per_feature = Counter(e.data.get("feature") for e in drill_events()
                          if e.severity == "critical")
    out["once_latched"] = bool(per_feature) and all(v == 1 for v in per_feature.values())
    out["captures"] = {latch: {k: cap.get(k) for k in
                               ("flight_dump", "span_snapshot", "profile_state")}
                       for latch, cap in drift.captured.items()}

    # 5. A publish re-arms; clean traffic re-baselines with no NOTA-rate
    # event and nothing critical.
    rearms_before = drift.rearms
    out["published_version"] = engine.publish_params(engine_params(engine))
    out["rearmed_on_publish"] = drift.rearms == rearms_before + 1 and not drift.armed(tenant)
    events_before = [e for e in drift.events if e.event == "prediction_drift"]
    classify_many(clean[i % len(clean)] for i in range(n_base))
    new_events = [e for e in drift.events if e.event == "prediction_drift"][len(events_before):]
    out["rebaselined"] = drift.armed(tenant)
    out["post_publish_events"] = len(new_events)
    out["clean_after_publish"] = not any(
        e.severity == "critical" or e.data.get("feature") == "nota_rate" for e in new_events)
    return out


def run_drift_drill(args, ckpt, logger, recorder, capture) -> dict:
    """The tool's drift arm: its own engine on ``ckpt``, tenant0."""
    from induction_network_on_fewrel_tpu_torch.obs import DriftDetector

    tenant = "tenant0"
    drift = DriftDetector(window=64, baseline_n=48, min_count=24, eval_interval_s=0.0,
                          logger=logger, recorder=recorder, capture=capture)
    engine = build_engine(args, ckpt, "continuous", logger=logger, drift=drift)
    try:
        tenants = register_tenants(engine, args)
        engine.warmup()
        out = drill_engine(engine, drift, _pools(tenants, args.K)[tenant], tenant)
        engine.emit_stats()
        return out
    finally:
        engine.close()


def drift_ok(drill: dict) -> bool:
    """The tool's acceptance of a drift drill."""
    got_capture = any(c.get("flight_dump") or c.get("span_snapshot")
                      for c in drill.get("captures", {}).values())
    return bool(drill.get("tripped") and drill.get("critical_events", 0) >= 1
                and drill.get("once_latched") and got_capture
                and drill.get("rearmed_on_publish") and drill.get("rebaselined")
                and drill.get("clean_after_publish"))
