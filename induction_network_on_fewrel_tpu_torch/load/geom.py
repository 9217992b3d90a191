"""The mixed-geometry A/B (the JAX ``tools/loadgen.py:3613-3827``).

Two arms against the same checkpoint and the same seeded arrivals:
**tiered** (N-tier bucketed resident stacks, the serving default) and
**exact** (``geometry_tiers="off"``: one program family per distinct
class count). Both serve the same mixed-N tenant set (3..40 classes), then
take a tier-crossing re-registration (a tenant with 7 of its 9 relations
registers the rest, crossing the 8 -> 16 tier) and a resident-dtype flip
mid-drill. The tiered arm must make no program after warmup through both
(warm-before-swap), with its program count bounded by tiers x buckets x
dtypes; the exact arm shows the capture tax the tiers remove. The grid
leg is the scenario harness's miniature (``load/scenarios.run_tier1``).
"""

from __future__ import annotations

import sys

import numpy as np

from induction_network_on_fewrel_tpu_torch.load.harness import (
    _flat,
    _pools,
    build_engine,
    check_registry_parity,
    pct_ms,
    run_open,
)

GEOM_TENANT_N = (3, 5, 14, 24, 40)
GEOM_CROSSER_DS_N = 9     # the crosser's full relation set
GEOM_CROSSER_START = 7    # registered first (tier 8); +2 crosses to 16
GEOM_PARITY_TOL_F32 = 1e-4    # both arms serve f32 residents at parity
GEOM_PARITY_TOL_BF16 = 0.25   # the flipped tenant, after the flip


def register_geom_tenants(engine, args) -> dict:
    """One synthetic corpus per entry of ``GEOM_TENANT_N`` plus the crosser
    at its starting class count; returns {tenant: dataset} (the crosser's
    dataset holds all ``GEOM_CROSSER_DS_N`` relations)."""
    from induction_network_on_fewrel_tpu_torch.data import make_synthetic_fewrel

    tenants = {}
    for t, n in enumerate(GEOM_TENANT_N):
        name = f"geo{t}_n{n}"
        ds = make_synthetic_fewrel(num_relations=n, instances_per_relation=args.K + 10,
                                   vocab_size=2000, seed=args.seed + 101 * t)
        engine.register_dataset(ds, tenant=name)
        tenants[name] = ds
    ds = make_synthetic_fewrel(num_relations=GEOM_CROSSER_DS_N,
                               instances_per_relation=args.K + 10, vocab_size=2000,
                               seed=args.seed + 977)
    engine.register_dataset(ds, tenant="crosser", max_classes=GEOM_CROSSER_START)
    tenants["crosser"] = ds
    return tenants


def run_geom_arm(args, ckpt, tiers_spec: str, label: str, logger=None) -> dict:
    """One arm: the mixed-N tenants, warmup, parity, open-loop phase 1,
    the tier crossing and the dtype flip, open-loop phase 2, the stats."""
    engine = build_engine(args, ckpt, "continuous", logger=logger, geometry_tiers=tiers_spec)
    try:
        tenants = register_geom_tenants(engine, args)
        compiled = engine.warmup()
        parity = max(check_registry_parity(engine, ds, tenant=t) for t, ds in tenants.items())
        tier_by_tenant = {t: engine.registry.snapshot(t).n_tier for t in tenants}
        print(f"[geom ab/{label}] warmup {compiled} programs, tiers "
              f"{sorted(set(tier_by_tenant.values()))}, parity max|delta| = {parity:.2e}",
              file=sys.stderr)
        pools = _pools(tenants, args.K)
        rng = np.random.default_rng(args.seed)  # the same arrivals per arm
        lat1, rej1, miss1, drop1, wall1, off1, _ = run_open(engine, pools, args.rate,
                                                            args.duration, rng)
        # The tier crossing (7 -> 9 classes; the engine warms the new tier
        # before the registry's swap), then the smallest tenant rolls to
        # bf16 (warm-first).
        engine.register_dataset(tenants["crosser"], tenant="crosser")
        cross_tier = engine.registry.snapshot("crosser").n_tier
        flip_tenant = f"geo0_n{GEOM_TENANT_N[0]}"
        engine.set_resident_dtype(flip_tenant, "bf16")
        flip_parity = check_registry_parity(engine, tenants[flip_tenant], tenant=flip_tenant)
        lat2, rej2, miss2, drop2, wall2, off2, _ = run_open(engine, pools, args.rate,
                                                            args.duration, rng)
        flat = _flat(lat1) + _flat(lat2)
        wall = wall1 + wall2
        snap = engine.stats.snapshot(queue_depth=engine.batcher.queue_depth)
        return {
            "arm": label,
            "geometry_tiers": tiers_spec,
            "tenants": len(tenants),
            "tenant_classes": {t: len(engine.registry.snapshot(t).names) for t in tenants},
            "tier_by_tenant": tier_by_tenant,
            "warmup_compiles": compiled,
            "programs_compiled": engine.programs.compiles,
            "program_cache_keys": len(engine.programs.keys()),
            "parity_max_delta": parity,
            "parity_tol": GEOM_PARITY_TOL_F32,
            "tier_crossing": {"tenant": "crosser",
                              "classes": f"{GEOM_CROSSER_START}->{GEOM_CROSSER_DS_N}",
                              "tier_after": cross_tier},
            "dtype_flip": {"tenant": flip_tenant, "dtype": "bf16",
                           "parity_max_delta": flip_parity,
                           "parity_tol": GEOM_PARITY_TOL_BF16},
            "offered_qps": round((off1 + off2) / wall, 1),
            "qps": round(len(flat) / wall, 1),
            "p50_ms": pct_ms(flat, 50),
            "p99_ms": pct_ms(flat, 99),
            "served": snap["served"],
            "rejected": rej1 + rej2,
            "deadline_miss": miss1 + miss2,
            "dropped": drop1 + drop2,
            "steady_recompiles": snap["steady_recompiles"],
            "resident_bytes": snap["resident_bytes"],
        }
    finally:
        engine.close()


def run_geom_ab(args, ckpt, logger=None, grid_res: dict | None = None) -> dict:
    """The tiered and exact arms, the scenario (N, K) grid leg and the
    gates. ``grid_res`` is a finished ``run_tier1`` result (the leg is run
    here, at ``--seed`` + 1, when None)."""
    from induction_network_on_fewrel_tpu_torch.load import scenarios
    from induction_network_on_fewrel_tpu_torch.serving.geometry import (
        DEFAULT_TIERS,
        program_bound,
        tiers_spec,
    )

    arms = {
        "tiered": run_geom_arm(args, ckpt, tiers_spec(DEFAULT_TIERS), "tiered", logger=logger),
        "exact": run_geom_arm(args, ckpt, "off", "exact", logger=logger),
    }
    buckets = tuple(int(b) for b in args.buckets.split(","))
    # The whole drill's bound: f32 everywhere plus the one bf16 flip.
    bound = program_bound(DEFAULT_TIERS, buckets, n_dtypes=2)
    if grid_res is None:
        grid_res = scenarios.run_tier1(seed=args.seed + 1, device=args.device)
    grid = {key: {"n": leg["n"], "k": leg["k"], "accuracy": leg["accuracy"],
                  "acc_ci95": leg["acc_ci95"]}
            for key, leg in grid_res["grid"].items()}
    out = {
        "arms": arms,
        "program_bound_tiered": bound,
        "grid": grid,
        "zero_bands": {
            "tiered_dropped": arms["tiered"]["dropped"],
            "tiered_steady_recompiles": arms["tiered"]["steady_recompiles"],
        },
        # The tax the tiers remove: the exact arm makes a program on the
        # query path when the crosser re-registers; the tiered arm must not.
        "exact_arm_steady_recompiles": arms["exact"]["steady_recompiles"],
    }
    out["check_failures"] = check_geom_ab(out)
    out["passed"] = not out["check_failures"]
    return out


def check_geom_ab(out: dict) -> list:
    """Gate the drill (the JAX gate): every failure is a named string."""
    fails = []
    for name, v in out["zero_bands"].items():
        if v != 0:
            fails.append(f"zero_band:{name}={v}")
    t, e = out["arms"]["tiered"], out["arms"]["exact"]
    if not (t["parity_max_delta"] < t["parity_tol"]):
        fails.append(f"parity:tiered={t['parity_max_delta']:.3g}>={t['parity_tol']}")
    if not (e["parity_max_delta"] < e["parity_tol"]):
        fails.append(f"parity:exact={e['parity_max_delta']:.3g}>={e['parity_tol']}")
    for label, arm in out["arms"].items():
        fp = arm["dtype_flip"]
        if not (fp["parity_max_delta"] < fp["parity_tol"]):
            fails.append(f"flip_parity:{label}={fp['parity_max_delta']:.3g}"
                         f">={fp['parity_tol']}")
    if t["program_cache_keys"] > out["program_bound_tiered"]:
        fails.append(f"program_bound:tiered={t['program_cache_keys']}"
                     f">{out['program_bound_tiered']}")
    if t["program_cache_keys"] >= e["program_cache_keys"]:
        fails.append(f"no_program_win:tiered={t['program_cache_keys']}"
                     f">=exact={e['program_cache_keys']}")
    if e["steady_recompiles"] == 0:
        fails.append("exact_arm_recompile_tax_missing: the exact arm's tier crossing should "
                     "recompile on the query path")
    if not out["grid"]:
        fails.append("grid:empty")
    return fails
