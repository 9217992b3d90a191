"""Model-quality scenario harness (the harness half of the JAX
``tools/scenarios.py``): cross-domain accuracy with a mixture-ramp DA arm,
NOTA threshold calibration, adversarial query legs and the (N, K) grid,
trained and evaluated through the port's trainer.

* **Cross-domain**: train on the source domain, evaluate on it and on
  shifted twins (``make_domain_shifted_fewrel`` moves the trigger signal
  to a disjoint vocabulary block); a second arm trains through
  ``datapipe/mixture.MixtureSampler`` with the shifted twin ramping in.
* **NOTA calibration**: the decision threshold swept over a quantile grid
  of the observed gaps (precision/recall/F1 per tau), the best-F1 point,
  and the drift detector's quality baseline at it.
* **Adversarial**: queries through ``datapipe/faults`` perturbations.
* **Grid**: the same trained weights at each (N, K) episode geometry.

``run_tier1`` is the miniature leg the JAX tier-1 test holds to its
committed artifact's band; ``tier1_headline`` flattens it. The canary
(the quality floors) lives in ``obs/canary.py``. ``init_params`` starts
both trainings from given weights; the JAX trainer draws one batch to
initialize its state, so each training stream then starts one batch
later, as the JAX harness's does.

Run: ``python -m induction_network_on_fewrel_tpu_torch.load.scenarios
[--mode tier1|full] [--seed 1] [--artifact PATH] [--run_dir DIR]
[--device cuda|cpu]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

from induction_network_on_fewrel_tpu_torch.obs.canary import (
    TIER1_BAND,
    _eval_leg,
    _sampler,
)
from induction_network_on_fewrel_tpu_torch.serving.geometry import grid_key

# The miniature (tier-1) world: the smallest where the trigger signal
# trains well above chance in ~150 steps; CE loss, seed 1.
TIER1 = dict(
    num_relations=5, instances_per_relation=20, iters=150,
    eval_episodes=48, shifts=(1.0,), na_grid=(1,),
    adversarial=("token_noise:0.4", "blank:1.0"),
    grid=((2, 1), (2, 2), (5, 1), (5, 2)),
    cfg=dict(
        model="induction", encoder="cnn", hidden_size=64,
        induction_dim=32, ntn_slices=32, routing_iters=2,
        train_n=2, n=2, k=2, q=2, na_rate=1, batch_size=4,
        max_length=16, vocab_size=302, word_dim=50,
        compute_dtype="float32", loss="ce", lr=5e-3,
        weight_decay=0.0, val_step=0, seed=1,
    ),
)

# Full mode: the 5-way 5-shot geometry on a larger corpus, a shift grid,
# an na_rate grid and the paper's (N, K) grid.
FULL = dict(
    num_relations=10, instances_per_relation=20, iters=600,
    eval_episodes=160, shifts=(0.5, 1.0), na_grid=(1, 2),
    adversarial=("token_noise:0.3", "token_noise:0.6", "mask_drop:0.5", "blank:1.0"),
    grid=((5, 1), (5, 5), (10, 1), (10, 5)),
    cfg=dict(
        model="induction", encoder="cnn", hidden_size=64,
        induction_dim=32, ntn_slices=32, routing_iters=2,
        train_n=5, n=5, k=5, q=5, na_rate=1, batch_size=4,
        max_length=16, vocab_size=302, word_dim=50,
        compute_dtype="float32", loss="ce", lr=5e-3,
        weight_decay=0.0, val_step=0, seed=1,
    ),
)


def _world(plan: dict, seed: int):
    """(cfg, tokenizer, source ds, {shift: shifted ds}, glove vectors)."""
    from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
    from induction_network_on_fewrel_tpu_torch.data import (
        GloveTokenizer,
        make_domain_shifted_fewrel,
        make_synthetic_fewrel,
        make_synthetic_glove,
    )

    cfg = ExperimentConfig(**plan["cfg"])
    vocab = make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim)
    tok = GloveTokenizer(vocab, max_length=cfg.max_length)
    src = make_synthetic_fewrel(num_relations=plan["num_relations"],
                                instances_per_relation=plan["instances_per_relation"],
                                vocab_size=cfg.vocab_size - 2, seed=seed)
    tgts = {shift: make_domain_shifted_fewrel(
                num_relations=plan["num_relations"],
                instances_per_relation=plan["instances_per_relation"],
                vocab_size=cfg.vocab_size - 2, shift=shift, seed=seed)
            for shift in plan["shifts"]}
    return cfg, tok, src, tgts, vocab


def _train(cfg, vocab, sampler, iters, device=None, init_params=None):
    """(model, trainer) after ``iters`` steps from a fresh init (or from
    ``init_params``, one batch of the stream skipped)."""
    from induction_network_on_fewrel_tpu_torch.models.build import build_model
    from induction_network_on_fewrel_tpu_torch.train.framework import FewShotTrainer
    from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

    model = build_model(cfg, glove_init=vocab.vectors, device=device)
    if init_params is not None:
        model.load_state_dict(init_params)
        sampler.sample_batch()
    trainer = FewShotTrainer(model, cfg, sampler, logger=MetricsLogger(quiet=True))
    trainer.train(num_iters=iters)
    return model, trainer


# --- NOTA threshold calibration -------------------------------------------


def nota_operating_points(gap, is_true_nota, taus) -> list[dict]:
    """Precision/recall/F1 per threshold bias tau. ``gap``: per query,
    best class score minus the NOTA logit; the decision is NOTA iff
    ``tau > gap``, so the predicted set grows with tau. With zero
    predictions precision is 1.0."""
    gap = np.asarray(gap, dtype=np.float64)
    truth = np.asarray(is_true_nota, dtype=bool)
    out = []
    for tau in taus:
        pred = gap < float(tau)
        tp = float(np.sum(pred & truth))
        n_pred = float(np.sum(pred))
        n_true = float(np.sum(truth))
        precision = tp / n_pred if n_pred else 1.0
        recall = tp / n_true if n_true else 0.0
        f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
        out.append({
            "tau": round(float(tau), 4),
            "precision": round(precision, 4),
            "recall": round(recall, 4),
            "f1": round(f1, 4),
            "nota_rate": round(n_pred / max(len(gap), 1), 4),
        })
    return out


def default_tau_grid(gap, points: int = 13):
    """A quantile grid over the observed gaps, bracketed by the all-NOTA
    and no-NOTA ends and always holding 0.0 (the learned head's own
    calibration)."""
    gap = np.asarray(gap, dtype=np.float64)
    qs = np.quantile(gap, np.linspace(0.02, 0.98, points))
    return sorted(set([round(float(t), 4) for t in qs]
                      + [0.0, round(float(gap.min()) - 1.0, 4),
                         round(float(gap.max()) + 1.0, 4)]))


def nota_calibration(model, params, cfg, ds, tok, episodes, na_rate, seed) -> dict:
    """Logits over NOTA-bearing episodes, the threshold sweep, the best-F1
    point and the quality baseline at it. ``params`` (a state_dict, or
    None for ``model``'s own weights) is loaded into ``model``."""
    import torch

    from induction_network_on_fewrel_tpu_torch.models.base import to_device
    from induction_network_on_fewrel_tpu_torch.models.build import batch_to_model_inputs
    from induction_network_on_fewrel_tpu_torch.obs.drift import quality_features

    if params is not None:
        model.load_state_dict(params)
    sampler = _sampler(ds, tok, cfg, seed=seed + 31, na_rate=na_rate)
    rows, labels = [], []
    for _ in range(max(1, episodes // cfg.batch_size)):
        sup, qry, lab = batch_to_model_inputs(sampler.sample_batch())
        with torch.inference_mode():
            logits = model(to_device(sup, model.device), to_device(qry, model.device))
        logits = logits.float().cpu().numpy()            # [B, TQ, n+1]
        rows.append(logits.reshape(-1, logits.shape[-1]))
        labels.append(np.asarray(lab).reshape(-1))
    rows = np.concatenate(rows)
    labels = np.concatenate(labels)
    n = cfg.n
    gap = rows[:, :n].max(axis=-1) - rows[:, n]
    truth = labels == n
    ops = nota_operating_points(gap, truth, default_tau_grid(gap))
    best_op = max(ops, key=lambda o: o["f1"])
    margin, entropy = quality_features(rows[:, :n])
    pred = gap < best_op["tau"]
    baseline = {
        "nota_rate": [round(float(pred.mean()), 4), round(float(pred.std()), 4)],
        "margin": [round(float(margin.mean()), 4), round(float(margin.std()), 4)],
        "entropy": [round(float(entropy.mean()), 4), round(float(entropy.std()), 4)],
    }
    return {"na_rate": na_rate, "queries": int(len(gap)), "operating_points": ops,
            "best": best_op, "baseline": baseline}


# --- the harness ----------------------------------------------------------


def run(plan: dict, seed: int, logger=None, step0: int = 0, tag: str = "", device=None,
        init_params=None) -> dict:
    """Every scenario family under ``plan``; with ``logger`` one
    kind="scenario" record per leg (names prefixed by ``tag``)."""
    from induction_network_on_fewrel_tpu_torch.datapipe.faults import PerturbedSampler
    from induction_network_on_fewrel_tpu_torch.datapipe.mixture import (
        MixtureSampler,
        MixtureSchedule,
    )

    t0 = time.monotonic()
    cfg, tok, src, tgts, vocab = _world(plan, seed)
    step = step0

    def emit(leg: str, fields: dict) -> None:
        nonlocal step
        if logger is not None:
            scalars = {k: v for k, v in fields.items() if isinstance(v, (int, float, str))}
            logger.log(step, kind="scenario", leg=tag + leg, **scalars)
        step += 1

    trainers = []
    try:
        # -- source-domain training + cross-domain evals -------------------
        model, trainer = _train(cfg, vocab, _sampler(src, tok, cfg, seed=seed + 1),
                                plan["iters"], device, init_params)
        trainers.append(trainer)
        in_domain = _eval_leg(trainer, _sampler(src, tok, cfg, seed=seed + 2),
                              plan["eval_episodes"])
        emit("in_domain", in_domain)
        cross = {}
        for shift, tgt in sorted(tgts.items()):
            r = _eval_leg(trainer, _sampler(tgt, tok, cfg, seed=seed + 3), plan["eval_episodes"])
            r["shift"] = shift
            cross[f"{shift:g}"] = r
            emit("cross_domain", r)

        # -- DA arm: train through the mixture machinery -------------------
        hardest = max(tgts)
        ramp_at = max(int(plan["iters"] * 0.6), 1)
        schedule = MixtureSchedule.parse(f"src:1.0;tgt:0.2@0,1.0@{ramp_at}")
        mix = MixtureSampler([("src", _sampler(src, tok, cfg, seed=seed + 5)),
                              ("tgt", _sampler(tgts[hardest], tok, cfg, seed=seed + 6))],
                             schedule, seed=seed)
        _, da_trainer = _train(cfg, vocab, mix, plan["iters"], device, init_params)
        trainers.append(da_trainer)
        da = _eval_leg(da_trainer, _sampler(tgts[hardest], tok, cfg, seed=seed + 3),
                       plan["eval_episodes"])
        da["shift"] = hardest
        da["schedule"] = schedule.to_spec()
        da["mixture_counts"] = dict(mix.counts)
        emit("da_mixture", {k: v for k, v in da.items() if not isinstance(v, dict)})

        # -- NOTA threshold calibration ------------------------------------
        nota = {}
        for na in plan["na_grid"]:
            r = nota_calibration(model, None, cfg, src, tok, plan["eval_episodes"],
                                 na_rate=na, seed=seed)
            nota[str(na)] = r
            emit("nota_calibration", {
                "na_rate": float(na), "queries": float(r["queries"]),
                "best_tau": r["best"]["tau"], "best_f1": r["best"]["f1"],
                "best_precision": r["best"]["precision"],
                "best_recall": r["best"]["recall"],
                "baseline_nota_rate": r["baseline"]["nota_rate"][0],
                "baseline_margin": r["baseline"]["margin"][0],
                "baseline_entropy": r["baseline"]["entropy"][0],
            })

        # -- adversarial / noisy episode legs ------------------------------
        adversarial = {"clean": in_domain}
        for spec in plan["adversarial"]:
            r = _eval_leg(trainer, PerturbedSampler(_sampler(src, tok, cfg, seed=seed + 2), spec,
                                                    seed=seed + 9), plan["eval_episodes"])
            r["degradation"] = round(in_domain["accuracy"] - r["accuracy"], 4)
            adversarial[spec] = r
            emit(spec, r)

        # -- (N, K) eval grid: plain N-way accuracy at each geometry -------
        grid = {}
        for i, (gn, gk) in enumerate(plan.get("grid", ())):
            gcfg = dataclasses.replace(cfg, n=gn, k=gk)
            r = _eval_leg(trainer, _sampler(src, tok, gcfg, seed=seed + 400 + i, na_rate=0),
                          plan["eval_episodes"])
            r["n"], r["k"] = gn, gk
            key = grid_key(gn, gk)
            grid[key] = r
            emit(f"grid_{key}", r)
    finally:
        for t in trainers:
            t.close()

    cross_worst = min(c["accuracy"] for c in cross.values())
    return {
        "config": dict(plan["cfg"]),
        "seed": seed,
        "iters": plan["iters"],
        "eval_episodes": plan["eval_episodes"],
        "wall_s": round(time.monotonic() - t0, 1),
        "cross_domain": {
            "in_domain": in_domain,
            "by_shift": cross,
            "gap_at_worst_shift": round(in_domain["accuracy"] - cross_worst, 4),
            "da_mixture": da,
        },
        "nota": nota,
        "adversarial": adversarial,
        "grid": grid,
    }


def run_tier1(seed: int = 1, logger=None, tag: str = "", device=None,
              init_params=None) -> dict:
    """The miniature leg: deterministic under a fixed seed on a fixed
    stack."""
    return run(TIER1, seed=seed, logger=logger, tag=tag, device=device,
               init_params=init_params)


def tier1_headline(res: dict) -> dict:
    """The gated numbers, flat (the artifact's ``tier1`` block)."""
    hardest = max(res["cross_domain"]["by_shift"], key=float)
    na0 = min(res["nota"], key=float)
    return {
        "seed": res["seed"],
        "in_domain_accuracy": res["cross_domain"]["in_domain"]["accuracy"],
        "cross_domain_accuracy": res["cross_domain"]["by_shift"][hardest]["accuracy"],
        "da_mixture_accuracy": res["cross_domain"]["da_mixture"]["accuracy"],
        "nota_best_f1": res["nota"][na0]["best"]["f1"],
        "adversarial_accuracy": {spec: leg["accuracy"]
                                 for spec, leg in res["adversarial"].items()
                                 if spec != "clean"},
        "grid": {key: leg["accuracy"] for key, leg in res.get("grid", {}).items()},
        "band": dict(TIER1_BAND),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m induction_network_on_fewrel_tpu_torch.load.scenarios",
        description="model-quality scenario harness (DA + NOTA + noise)")
    ap.add_argument("--artifact", default=None, metavar="PATH",
                    help="write the report (full + tier1) here")
    ap.add_argument("--mode", default="full", choices=["full", "tier1"],
                    help="tier1 = the miniature gate leg only")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--run_dir", default=None,
                    help="also emit kind='scenario' records to this dir's metrics.jsonl")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="default: the GPU (refuses to start without CUDA)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from induction_network_on_fewrel_tpu_torch.load.harness import require_device

    args = parse_args(argv)
    require_device(args.device)
    logger = None
    if args.run_dir:
        from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

        logger = MetricsLogger(args.run_dir)
    try:
        if args.mode == "tier1":
            res = run_tier1(seed=args.seed, logger=logger, device=args.device)
            report = {"tier1_run": res, "tier1": tier1_headline(res)}
        else:
            print("scenarios: full mode (DA grid + na grid + mixture arm)", file=sys.stderr)
            full = run(FULL, seed=args.seed, logger=logger, device=args.device)
            print(f"scenarios: full done in {full['wall_s']}s; tier1 leg...", file=sys.stderr)
            t1 = run_tier1(seed=args.seed, logger=logger, tag="tier1:", device=args.device)
            report = {
                "round": 1,
                "generated_by": "python -m induction_network_on_fewrel_tpu_torch.load.scenarios",
                "generated_unix_s": int(time.time()),
                "full": full,
                "tier1_run": t1,
                "tier1": tier1_headline(t1),
            }
        print(json.dumps(report.get("tier1", report), indent=1))
        if args.artifact:
            with open(args.artifact, "w") as f:
                json.dump(report, f, indent=1)
            print(f"wrote {args.artifact}", file=sys.stderr)
        return 0
    finally:
        if logger is not None:
            logger.close()


if __name__ == "__main__":
    sys.exit(main())
