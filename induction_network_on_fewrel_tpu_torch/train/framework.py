"""FewShotTrainer: the episode-loop training framework.

Counterpart of ``induction_network_on_fewrel_tpu/train/framework.py`` for
the flagship path: sample a host batch -> one train step (forward,
backward, update on the card) -> a ``[train]`` record of the window's mean
metrics every ``metric_window`` steps (default 50; each record syncs the
card) and at the end -> validation every ``val_step`` steps, logged as
``[val]`` with ``acc_ci95`` (its time, and the saves', kept out of
``episodes_per_s``) -> best-checkpoint save on improvement and a latest
save at every val boundary and at the end. ``evaluate`` returns the
mean episode accuracy, or with ``return_metrics`` the full dict: accuracy,
``acc_ci95`` (±1.96·σ/√n over per-batch accuracies) and, with NOTA, its
precision and recall aggregated exactly from the per-batch fractions.

Fused multi-step dispatch, mesh sharding, the input pipeline, the
divergence guard and the perf/watchdog hooks of the JAX trainer belong to
later slices.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.models.build import batch_to_model_inputs
from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager
from induction_network_on_fewrel_tpu_torch.train.steps import eval_step, make_optimizer, train_step
from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger


class FewShotTrainer:
    def __init__(self, model, cfg: ExperimentConfig, train_sampler, val_sampler=None,
                 ckpt_dir: str | None = None, logger: MetricsLogger | None = None,
                 metric_window: int = 50):
        self.model = model
        self.cfg = cfg
        self.train_sampler = train_sampler
        self.val_sampler = val_sampler
        self.logger = logger or MetricsLogger(quiet=True)
        self.opt = make_optimizer(cfg, model)
        self.ckpt = CheckpointManager(ckpt_dir, cfg) if ckpt_dir else None
        self.best_val = -1.0
        self.metric_window = metric_window

    def train(self, num_iters: int | None = None) -> None:
        """Run ``num_iters`` updates (default ``cfg.train_iter``)."""
        cfg = self.cfg
        end_step = num_iters or cfg.train_iter
        it = iter(self.train_sampler)
        step = last_logged = 0
        window: list[dict] = []
        t0 = time.monotonic()
        while step < end_step:
            support, query, label = batch_to_model_inputs(next(it))
            window.append(train_step(self.model, self.opt, cfg, support, query, label))
            prev, step = step, step + 1
            if step - last_logged >= self.metric_window or step >= end_step:
                means = {k: torch.stack([m[k] for m in window]).float().mean().item()
                         for k in window[0]}            # one sync per window
                dt = time.monotonic() - t0
                self.logger.log(step, "train",
                                episodes_per_s=(step - last_logged) * cfg.batch_size / max(dt, 1e-9),
                                **means)
                window, last_logged, t0 = [], step, time.monotonic()
            if self.val_sampler is not None and cfg.val_step \
                    and step // cfg.val_step > prev // cfg.val_step:
                t_val = time.monotonic()
                m = self.evaluate(cfg.val_iter, return_metrics=True)
                self.logger.log(step, "val", **m)
                if m["accuracy"] > self.best_val:
                    self.best_val = m["accuracy"]
                    if self.ckpt is not None:
                        self.ckpt.save(step, self.model, self.opt, m["accuracy"])
                if self.ckpt is not None:
                    self.ckpt.save_latest(step, self.model, self.opt)
                t0 += time.monotonic() - t_val    # eval + saves stay out of episodes_per_s
        if self.ckpt is not None:
            self.ckpt.save_latest(step, self.model, self.opt)

    def evaluate(self, num_episodes: int, sampler=None, return_metrics: bool = False):
        """Mean episode accuracy over ``num_episodes`` episodes (at least one
        batch), or the full metric dict with ``return_metrics``."""
        sampler = sampler or self.val_sampler
        n_batches = max(1, num_episodes // sampler.batch_size)
        it = iter(sampler)
        outs = [eval_step(self.model, self.cfg, *batch_to_model_inputs(next(it)))
                for _ in range(n_batches)]
        arrays = {k: torch.stack([o[k] for o in outs]).float().cpu().numpy() for k in outs[0]}
        means = {k: float(np.mean(v)) for k, v in arrays.items()}
        if not return_metrics:
            return means["accuracy"]
        accs = arrays["accuracy"]
        metrics = {
            "accuracy": means["accuracy"],
            "acc_ci95": float(1.96 * np.std(accs, ddof=1) / np.sqrt(len(accs)))
            if len(accs) > 1 else 0.0,
        }
        if "nota_tp" in means:
            metrics["nota_precision"] = means["nota_tp"] / max(means["nota_pred"], 1e-12)
            metrics["nota_recall"] = means["nota_tp"] / max(means["nota_true"], 1e-12)
        return metrics

    def close(self) -> None:
        self.logger.close()
