"""The quantized-serving A/B (the JAX ``tools/loadgen.py:3447-3612``).

Three arms, f32 / bf16 / int8 resident class vectors, against the same
checkpoint and the same seeded open-loop arrivals. The quantized arms
re-score every batch against their f32 shadow (``quant_probe_every=1``),
so the verdict agreement and margin drift cover the whole run. The
density section projects tenants per card from the measured resident
bytes per tenant against a nominal 1 GiB budget for resident class
vectors: a projection, labelled as such; its honesty is in the ratio
between arms.
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
    register_tenants,
    run_open,
)

# Nominal per-card budget for resident class vectors (1 GiB).
QUANT_RESIDENT_BUDGET_BYTES = 2**30

# Registry-vs-direct parity tolerance per arm: f32 residents to float
# error; quantized residents carry real quantization error, gated well
# inside the 0.25 margin-drift band (their verdict agreement floor is the
# real quality gate).
QUANT_PARITY_TOL = {"f32": 1e-4, "bf16": 0.25, "int8": 0.25}


def run_quant_arm(args, ckpt, dtype: str, logger=None) -> dict:
    """One resident-dtype arm: a fresh engine, the tenants, the parity
    check, the open-loop phase, the stats."""
    engine = build_engine(args, ckpt, "continuous", logger=logger, resident_dtype=dtype,
                          quant_probe_every=0 if dtype == "f32" else 1)
    try:
        tenants = register_tenants(engine, args)
        compiled = engine.warmup()
        parity = max(check_registry_parity(engine, ds, tenant=t) for t, ds in tenants.items())
        print(f"[quant ab/{dtype}] warmup {compiled} programs, parity max|delta| = "
              f"{parity:.2e} (tol {QUANT_PARITY_TOL[dtype]})", file=sys.stderr)
        pools = _pools(tenants, args.K)
        rng = np.random.default_rng(args.seed)  # the same arrivals per arm
        lat, rej, miss, dropped, wall, offered, _ = run_open(engine, pools, args.rate,
                                                             args.duration, rng)
        flat = _flat(lat)
        snap = engine.stats.snapshot(queue_depth=engine.batcher.queue_depth)
        resident = engine.registry.resident_bytes()
        drifts = [q["quant_margin_drift"] for q in engine.stats.quality_snapshot().values()
                  if "quant_margin_drift" in q]
        return {
            "dtype": dtype,
            "warmup_compiles": compiled,
            "parity_max_delta": parity,
            "parity_tol": QUANT_PARITY_TOL[dtype],
            "offered_qps": round(offered / wall, 1),
            "qps": round(len(flat) / wall, 1),
            "p50_ms": pct_ms(flat, 50),
            "p99_ms": pct_ms(flat, 99),
            "served": snap["served"],
            "rejected": rej,
            "deadline_miss": miss,
            "dropped": dropped,
            "steady_recompiles": snap["steady_recompiles"],
            "resident_bytes": snap["resident_bytes"],
            "resident_bytes_per_tenant": round(sum(resident.values()) / max(len(resident), 1),
                                               1),
            "quant_probes": snap["quant_probes"],
            "quant_agreement": snap["quant_agreement"],
            "quant_margin_drift": round(sum(drifts) / len(drifts), 4) if drifts else 0.0,
        }
    finally:
        engine.close()


def run_quant_ab(args, ckpt, logger=None) -> dict:
    """The three arms, the density projection and the gates."""
    arms = {dt: run_quant_arm(args, ckpt, dt, logger=logger) for dt in ("f32", "bf16", "int8")}
    bpt = {dt: arms[dt]["resident_bytes_per_tenant"] for dt in arms}
    density = {
        "resident_budget_bytes_nominal": QUANT_RESIDENT_BUDGET_BYTES,
        "projection_note": ("tenants_per_chip = budget / measured bytes-per-tenant; a "
                            "projection from the resident bytes this run measured"),
        "bytes_ratio_f32_over_int8": round(bpt["f32"] / max(bpt["int8"], 1e-9), 2),
        "bytes_ratio_f32_over_bf16": round(bpt["f32"] / max(bpt["bf16"], 1e-9), 2),
        "tenants_per_chip_projected": {
            dt: int(QUANT_RESIDENT_BUDGET_BYTES // max(bpt[dt], 1.0)) for dt in arms},
    }
    out = {
        "arms": arms,
        "density": density,
        "parity_floor": 0.99,
        "margin_drift_band": 0.25,
        "zero_bands": {
            "dropped": sum(a["dropped"] for a in arms.values()),
            "steady_recompiles": sum(a["steady_recompiles"] for a in arms.values()),
        },
    }
    out["check_failures"] = check_quant_ab(out)
    out["passed"] = not out["check_failures"]
    return out


def check_quant_ab(out: dict) -> list:
    """Gate the drill (the JAX gate): every failure is a named string."""
    fails = []
    for name, v in out["zero_bands"].items():
        if v != 0:
            fails.append(f"zero_band:{name}={v}")
    for dt, arm in out["arms"].items():
        if not (arm["parity_max_delta"] < arm["parity_tol"]):
            fails.append(f"parity:{dt}={arm['parity_max_delta']:.3g}>={arm['parity_tol']}")
        if dt != "f32":
            if arm["quant_probes"] <= 0:
                fails.append(f"no_probes:{dt}")
            if arm["quant_agreement"] < out["parity_floor"]:
                fails.append(f"agreement:{dt}={arm['quant_agreement']:.4f}"
                             f"<{out['parity_floor']}")
            if arm["quant_margin_drift"] > out["margin_drift_band"]:
                fails.append(f"margin_drift:{dt}={arm['quant_margin_drift']:.4f}"
                             f">{out['margin_drift_band']}")
    if out["density"]["bytes_ratio_f32_over_int8"] < 3.5:
        fails.append(f"density:f32/int8={out['density']['bytes_ratio_f32_over_int8']}<3.5")
    return fails
