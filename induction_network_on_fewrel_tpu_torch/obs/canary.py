"""The adaptation controller's pre-publish canary: quality floors as a
plan-in/verdict-out entry point.

The port's copy of the JAX repository's ``tools/scenarios.py`` canary
(``_sampler``, ``_eval_leg``, ``floors_from_headline``,
``canary_verdict``, ``run_canary``), written against the port's
``FewShotTrainer.evaluate``. The controller (obs/adapt.py) and the
serving CLI share this one home for what "good enough to ship" means: a
candidate that fails any floor is discarded, never published.

Legs: ``{name: FewRel-schema dataset}``. A leg named ``grid_<N>w<K>s`` (or
bare ``<N>w<K>s``) is evaluated at that episode geometry, with plain N-way
accuracy (na_rate 0: an all-relations N-way point has no spare relation
to draw a NOTA distractor from). Floors: ``{name: min accuracy}``; a floor
without an evaluated leg fails.
"""

from __future__ import annotations

import dataclasses

from induction_network_on_fewrel_tpu_torch.serving.geometry import parse_grid_key

# The JAX scenario harness's tier-1 regression band: a headline accuracy
# minus ``accuracy_abs`` is its canary floor.
TIER1_BAND = {
    "accuracy_abs": 0.12,
    "f1_abs": 0.15,
}


def _sampler(ds, tok, cfg, seed, na_rate=None):
    from induction_network_on_fewrel_tpu_torch.sampling.episodes import EpisodeSampler

    return EpisodeSampler(
        ds, tok, n=cfg.n, k=cfg.k, q=cfg.q, batch_size=cfg.batch_size,
        na_rate=cfg.na_rate if na_rate is None else na_rate, seed=seed,
    )


def _eval_leg(trainer, sampler, episodes) -> dict:
    m = trainer.evaluate(episodes, sampler=sampler, return_metrics=True)
    out = {
        "accuracy": round(m["accuracy"], 4),
        "acc_ci95": round(m["acc_ci95"], 4),
    }
    for k in ("nota_precision", "nota_recall"):
        if k in m:
            out[k] = round(m[k], 4)
    return out


def floors_from_headline(headline: dict, band: dict | None = None) -> dict[str, float]:
    """Turn a recorded headline (the JAX scenario harness's ``tier1``
    block: ``in_domain_accuracy``, ``cross_domain_accuracy``,
    ``da_mixture_accuracy``, ``grid``) into canary floors: each accuracy
    minus the tier-1 band. Grid points become ``grid_<N>w<K>s`` floors."""
    tol = (band or TIER1_BAND)["accuracy_abs"]
    floors = {}
    for key in ("in_domain_accuracy", "cross_domain_accuracy", "da_mixture_accuracy"):
        if isinstance(headline.get(key), (int, float)):
            floors[key] = round(max(headline[key] - tol, 0.0), 4)
    for key, acc in (headline.get("grid") or {}).items():
        if isinstance(acc, (int, float)):
            floors[f"grid_{key}"] = round(max(acc - tol, 0.0), 4)
    return floors


def canary_verdict(legs: dict, floors: dict[str, float]) -> dict:
    """Hold evaluated legs to their floors. ``legs``: {name: {"accuracy":
    ...}} (legs without a floor are recorded, not judged; a floor without
    a matching leg fails: a gate that silently skips a bar is worse than
    no gate). Verdict: {"passed", "legs", "failures"}."""
    failures = []
    out_legs = {}
    for name, leg in legs.items():
        acc = leg.get("accuracy")
        floor = floors.get(name)
        row = {"accuracy": acc}
        if floor is not None:
            row["floor"] = floor
            row["ok"] = bool(acc is not None and acc >= floor)
            if not row["ok"]:
                failures.append(f"{name}: accuracy {acc} below floor {floor}")
        out_legs[name] = row
    for name in sorted(set(floors) - set(legs)):
        failures.append(f"{name}: floor {floors[name]} has no evaluated leg")
    return {"passed": not failures, "legs": out_legs, "failures": failures}


def run_canary(model, params, cfg, tok, legs: dict, floors: dict,
               episodes: int = 48, seed: int = 0) -> dict:
    """Evaluate candidate ``params`` (a state_dict, loaded into ``model``
    in place; None = ``model``'s own weights) on each leg's dataset and
    hold it to the floors. ``model`` is the canary's own module, never a
    serving replica's. Returns the ``canary_verdict`` dict with per-leg
    accuracy/acc_ci95."""
    from induction_network_on_fewrel_tpu_torch.train.framework import FewShotTrainer
    from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

    if not legs:
        raise ValueError("canary needs at least one evaluation leg")
    if params is not None:
        model.load_state_dict(params)
    first = next(iter(legs.values()))
    trainer = FewShotTrainer(
        model, cfg, _sampler(first, tok, cfg, seed=seed),
        logger=MetricsLogger(quiet=True),
    )
    try:
        evaluated = {}
        for i, (name, ds) in enumerate(sorted(legs.items())):
            geom = parse_grid_key(name)
            leg_cfg = dataclasses.replace(cfg, n=geom[0], k=geom[1]) if geom else cfg
            evaluated[name] = _eval_leg(
                trainer,
                _sampler(ds, tok, leg_cfg, seed=seed + 17 + i, na_rate=0 if geom else None),
                episodes,
            )
    finally:
        trainer.close()
    return canary_verdict(evaluated, floors)
