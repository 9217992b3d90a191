"""The burn-rate drill (the JAX ``tools/loadgen.py:731`` ``run_burn_drill``).

Escalating open-loop overload (4x, 16x, 64x the configured rate, at least
1.2 s each, stopping at the first trip) drives latency, and at the top
rates queue rejections, through the SLO objective; the fast-window burn
must trip a once-latched CRITICAL whose diagnostics capture is on disk
before the drill returns. The objective is twice the arm's measured p50
(an objective the healthy phases met), and drill submits carry it as
their deadline, so a queue-delayed request burns budget as a miss even
while the card stays fast.
"""

from __future__ import annotations

import sys

from induction_network_on_fewrel_tpu_torch.load.harness import _flat, pct_ms, run_open


def run_burn_drill(engine, pools, args, rng) -> dict:
    from induction_network_on_fewrel_tpu_torch.obs.health import SLOObjective

    slo = engine.slo
    baseline_p50 = engine.stats.percentile_ms(50) or 5.0
    thr = args.slo_latency_ms or round(max(1.0, 2.0 * baseline_p50), 3)
    slo.default_objective = SLOObjective(availability=args.slo_availability, latency_ms=thr)
    phase_s = max(1.2, args.duration / 4)
    totals = {"offered": 0, "served": 0, "rejected": 0, "deadline_miss": 0, "dropped": 0}
    all_lat: dict[str, list] = {t: [] for t in pools}
    tripped_at = None
    for mult in (4, 16, 64):
        rate = max(args.rate * mult, 100.0)
        print(f"burn drill: rate {rate}/s for {phase_s}s against latency SLO {thr} ms "
              f"(fast window {args.slo_fast_s}s)", file=sys.stderr)
        lat, rej, miss, dropped, wall, offered, _ = run_open(
            engine, pools, rate, phase_s, rng, deadline_s=thr / 1e3)
        for t, xs in lat.items():
            all_lat[t].extend(xs)
        totals["offered"] += offered
        totals["served"] += sum(len(x) for x in lat.values())
        totals["rejected"] += rej
        totals["deadline_miss"] += miss
        totals["dropped"] += dropped
        slo.evaluate()
        if any(e.event == "slo_fast_burn" for e in slo.events):
            tripped_at = mult
            break
    fast = [e for e in slo.events if e.event == "slo_fast_burn"]
    # Once-latch: a second sweep while still burning emits nothing new.
    relatch = slo.evaluate()
    return {
        "threshold_ms": thr,
        "tripped_at_rate_multiplier": tripped_at,
        "p99_ms": pct_ms(_flat(all_lat), 99),
        **totals,
        "tripped": slo.tripped,
        "fast_burn_events": len(fast),
        "once_latched": len(relatch) == 0,
        "burn_rates": {t: slo.burn_rates(t) for t in sorted(all_lat)
                       if slo.burn_rates(t) is not None},
        "captures": {latch: {k: cap.get(k) for k in
                             ("flight_dump", "span_snapshot", "profile", "profile_state")}
                     for latch, cap in slo.captured.items()},
    }


def burn_ok(burn: dict) -> bool:
    """The tool's acceptance of a burn drill: tripped, at least one fast
    event, once-latched, a diagnostics capture on disk."""
    got_capture = any(c.get("flight_dump") or c.get("span_snapshot")
                      for c in burn["captures"].values())
    return bool(burn["tripped"] and burn["fast_burn_events"] >= 1 and burn["once_latched"]
                and got_capture)
