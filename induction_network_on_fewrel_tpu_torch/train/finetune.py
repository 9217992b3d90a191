"""Targeted mixture-ramp fine-tune from a live checkpoint.

The remediation arm of the self-healing loop (obs/adapt.py), the port of
the JAX package's ``train/finetune.py``: when a tenant's traffic drifts
out of the training domain, the cure is a mixture curriculum: keep the
source corpus at full weight while the target domain ramps in (Gao et
al. 2019's FewRel 2.0 wiki+pubmed recipe, Geng et al. 2019's episode
construction). This module packages that as one bounded, killable job:

* restores the full train state (parameters, optimizer moments and
  count, a lazy table's state) from the live checkpoint: a fine-tune,
  not a retrain;
* feeds a ``MixtureSampler`` under ``MixtureSchedule.ramp`` through a
  ``PipelineFeed`` (host sampling overlaps dispatch, the production input
  pipeline) into the stock ``FewShotTrainer``;
* saves through the trainer's ring path (``save_latest``), so the
  candidate directory restores through the same integrity-checked
  machinery every other checkpoint does (the ``publish_checkpoint``
  fan-out, ``InferenceEngine.from_checkpoint``);
* enforces a step budget and a wall-clock budget: training runs in
  chunks, the clock is checked between chunks, and a breach kills the
  job: the partial candidate directory is deleted and
  ``AdaptTrainTimeout`` raised, which the controller counts as a failed
  attempt.

On the GPU one trainer serves every chunk, so its training step is
captured as a CUDA graph once per fine-tune and replayed by every chunk.
Each ``trainer.train`` call still ends with the trainer's forced ring
save, so the default 4 chunks pay 4 boundary saves where only the last
matters; prefer a larger ``chunk`` at flagship checkpoint size.
"""

from __future__ import annotations

import gc
import shutil
import time
from pathlib import Path


class AdaptTrainTimeout(RuntimeError):
    """The fine-tune breached its wall-clock budget and was killed; the
    candidate checkpoint directory has been cleaned up."""


def mixture_finetune(
    ckpt_dir: str,
    out_dir: str,
    src_ds,
    tgt_ds,
    tok,
    *,
    steps: int,
    wall_budget_s: float,
    ramp_frac: float = 0.6,
    start_weight: float = 0.2,
    seed: int = 0,
    prefetch_depth: int = 2,
    chunk: int | None = None,
    lr: float | None = None,
    logger=None,
    device=None,
) -> str:
    """Fine-tune the artifact in ``ckpt_dir`` on a src+tgt mixture ramp;
    returns ``out_dir`` (a publishable checkpoint directory). ``steps``
    is the optimizer-step budget; ``wall_budget_s`` the wall-clock
    budget (checked between chunks of ``chunk`` steps, default
    steps/4); ``ramp_frac`` places the parity point of the target ramp.
    ``src_ds``/``tgt_ds`` are FewRel-schema datasets; episode geometry
    and architecture come from the checkpoint's stored config. The job
    runs on ``device`` (default: the GPU). Every tensor the job made is
    released before it returns or raises."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if wall_budget_s <= 0:
        raise ValueError(f"wall_budget_s must be > 0, got {wall_budget_s}")
    try:
        return _finetune(ckpt_dir, out_dir, src_ds, tgt_ds, tok, steps=steps,
                         wall_budget_s=wall_budget_s, ramp_frac=ramp_frac,
                         start_weight=start_weight, seed=seed,
                         prefetch_depth=prefetch_depth, chunk=chunk, lr=lr,
                         logger=logger, device=device)
    finally:
        gc.collect()        # the trainer's graphs and the model go with it


def _finetune(ckpt_dir, out_dir, src_ds, tgt_ds, tok, *, steps, wall_budget_s,
              ramp_frac, start_weight, seed, prefetch_depth, chunk, lr, logger,
              device) -> str:
    from induction_network_on_fewrel_tpu_torch.datapipe.mixture import (
        MixtureSampler,
        MixtureSchedule,
    )
    from induction_network_on_fewrel_tpu_torch.datapipe.producer import PipelineFeed
    from induction_network_on_fewrel_tpu_torch.models.build import build_model
    from induction_network_on_fewrel_tpu_torch.sampling.episodes import EpisodeSampler
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager
    from induction_network_on_fewrel_tpu_torch.train.framework import FewShotTrainer
    from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

    t0 = time.monotonic()
    cfg = CheckpointManager.load_config(ckpt_dir)
    # Runtime knobs for the fine-tune job: no val loop (the canary is the
    # quality gate), single-dispatch steps (the budget is exact), the
    # caller's input-pipeline depth. Architecture fields untouched: the
    # candidate must restore into the serving engine's model.
    cfg = cfg.replace(
        val_step=0, steps_per_call=1, prefetch_depth=prefetch_depth,
        train_iter=steps, **({"lr": lr} if lr is not None else {}),
    )
    model = build_model(cfg, device=device)
    schedule = MixtureSchedule.ramp(
        start_weight=start_weight,
        parity_at=max(int(steps * ramp_frac), 1),
    )
    mix = MixtureSampler(
        [("src", EpisodeSampler(
            src_ds, tok, n=cfg.n, k=cfg.k, q=cfg.q,
            batch_size=cfg.batch_size, na_rate=cfg.na_rate,
            seed=seed + 1)),
         ("tgt", EpisodeSampler(
             tgt_ds, tok, n=cfg.n, k=cfg.k, q=cfg.q,
             batch_size=cfg.batch_size, na_rate=cfg.na_rate,
             seed=seed + 2))],
        schedule, seed=seed,
    )
    feed = PipelineFeed(mix, prefetch_depth=prefetch_depth)
    trainer = FewShotTrainer(
        model, cfg, feed, ckpt_dir=out_dir,
        logger=logger if logger is not None else MetricsLogger(quiet=True),
    )
    chunk = max(1, steps // 4) if chunk is None else max(1, chunk)
    done = 0
    try:
        src_mngr = CheckpointManager(ckpt_dir, cfg)
        try:
            try:
                start_step = src_mngr.restore_best(model, trainer.opt, trainer.lazy)
            except FileNotFoundError:
                start_step, _ = src_mngr.restore_latest(model, trainer.opt, trainer.lazy)
        finally:
            src_mngr.close()
        while done < steps:
            if time.monotonic() - t0 > wall_budget_s:
                raise AdaptTrainTimeout(
                    f"fine-tune killed at {done}/{steps} steps: wall "
                    f"budget {wall_budget_s}s breached "
                    f"({time.monotonic() - t0:.1f}s elapsed); candidate "
                    f"{out_dir} cleaned up"
                )
            n = min(chunk, steps - done)
            trainer.train(num_iters=n, start_step=start_step + done)
            done += n
    except BaseException:
        # Timeout-kill + checkpoint cleanup: a partial candidate must
        # never be publishable by accident.
        trainer.close()
        shutil.rmtree(out_dir, ignore_errors=True)
        raise
    trainer.close()
    return str(Path(out_dir))
