"""FewShotTrainer: the episode-loop training framework.

Counterpart of ``induction_network_on_fewrel_tpu/train/framework.py``
(``FewShotTrainer.train``/``evaluate``, framework.py:266-330, 380-470,
725-729) for the single-device path: sample host batches -> one dispatch
of ``steps_per_call`` training steps (on the card one CUDA-graph replay,
``train/steps.py``; when fewer steps are left they run one at a time) -> a
``[train]`` record of the window's mean metrics every ``metric_window``
steps (default max(50, metric_window_calls * steps_per_call); each record
syncs the card) and at the end -> every ``grad_probe_every`` steps a
``health`` record (event "grad_probe": the gradient's norm and its cosine
to an all-f32 plain reference, ``make_grad_probe``) -> validation every
``val_step`` steps, logged as ``[val]`` with ``acc_ci95`` (its time, the
probe's and the saves', kept out of ``episodes_per_s``) -> best-checkpoint
save on improvement and a latest save at every val boundary and at the
end. A fused call may not skip a val boundary: ``steps_per_call >
val_step`` with a val sampler is refused.

Each dispatch's metrics are copies of the graph's static outputs, so the
window keeps one tensor per dispatch, not a reference to a buffer the next
replay overwrites.

``evaluate`` scores ``eval_steps_per_call`` batches per dispatch (0 =
min(steps_per_call, 16)); a short tail repeats its last batch and drops
the repeated results, and fewer than a width/8 batches run one at a time.
It returns the mean episode accuracy, or with ``return_metrics`` the full
dict: accuracy, ``acc_ci95`` (±1.96·σ/√n over per-batch accuracies) and,
with NOTA, its precision and recall aggregated exactly from the per-batch
fractions.

``train(num_iters, start_step)`` numbers steps from ``start_step``;
``sampler_states``/``restore_sampler_states`` carry the samplers' random
streams through the latest checkpoint, so a resumed run continues the
episode stream of the run it resumes.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.models.build import batch_to_model_inputs
from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager
from induction_network_on_fewrel_tpu_torch.train.steps import (
    make_eval_step,
    make_grad_probe,
    make_multi_eval_step,
    make_multi_train_step,
    make_optimizer,
    make_train_step,
)
from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger


def stack_batches(batches):
    """[(support, query, label)] -> stacked (support_s, query_s, label_s)."""
    sup = {k: np.stack([b[0][k] for b in batches]) for k in batches[0][0]}
    qry = {k: np.stack([b[1][k] for b in batches]) for k in batches[0][1]}
    return sup, qry, np.stack([b[2] for b in batches])


class FewShotTrainer:
    def __init__(self, model, cfg: ExperimentConfig, train_sampler, val_sampler=None,
                 ckpt_dir: str | None = None, logger: MetricsLogger | None = None,
                 metric_window: int | None = None):
        spc = cfg.steps_per_call
        if spc < 1:
            raise ValueError(f"steps_per_call must be >= 1, got {spc}")
        if val_sampler is not None and cfg.val_step and spc > cfg.val_step:
            # A fused call may not skip val/checkpoint boundaries: mid-chunk
            # params no longer exist to evaluate.
            raise ValueError(
                f"steps_per_call ({spc}) must not exceed "
                f"val_step ({cfg.val_step}); lower it or raise val_step"
            )
        self.model = model
        self.cfg = cfg
        self.train_sampler = train_sampler
        self.val_sampler = val_sampler
        self.logger = logger or MetricsLogger(quiet=True)
        self.opt = make_optimizer(cfg, model)
        self.ckpt = CheckpointManager(ckpt_dir, cfg) if ckpt_dir else None
        self.best_val = -1.0
        self.metric_window = metric_window or max(50, cfg.metric_window_calls * spc)
        self.train_step = make_train_step(model, self.opt, cfg)
        self.multi_train_step = make_multi_train_step(model, self.opt, cfg) if spc > 1 else None
        self.eval_spc = cfg.eval_steps_per_call or min(spc, 16)
        self.eval_step = make_eval_step(model, cfg)
        self.multi_eval_step = make_multi_eval_step(model, cfg) if self.eval_spc > 1 else None
        self.grad_probe = make_grad_probe(model, cfg) if cfg.grad_probe_every > 0 else None

    def train(self, num_iters: int | None = None, start_step: int = 0) -> int:
        """Run ``num_iters`` updates (default ``cfg.train_iter``) numbered
        from ``start_step``; returns the last step."""
        cfg = self.cfg
        spc = cfg.steps_per_call
        end_step = start_step + (num_iters or cfg.train_iter)
        it = iter(self.train_sampler)
        step = last_logged = start_step
        window: list[dict] = []
        t0 = time.monotonic()
        while step < end_step:
            if self.multi_train_step is not None and end_step - step >= spc:
                batches = [batch_to_model_inputs(next(it)) for _ in range(spc)]
                window.append(self.multi_train_step(*stack_batches(batches)))
                prev, step = step, step + spc
            else:
                batches = [batch_to_model_inputs(next(it))]
                window.append(self.train_step(*batches[0]))
                prev, step = step, step + 1
            if step - last_logged >= self.metric_window or step >= end_step:
                keys = list(window[0])
                means = torch.stack([torch.cat([m[k].reshape(-1) for m in window]).float().mean()
                                     for k in keys]).tolist()      # one sync per window
                dt = max(time.monotonic() - t0, 1e-9)
                self.logger.log(step, "train",
                                episodes_per_s=(step - last_logged) * cfg.batch_size / dt,
                                **dict(zip(keys, means)))
                window, last_logged, t0 = [], step, time.monotonic()
            if self.grad_probe is not None \
                    and step // cfg.grad_probe_every > prev // cfg.grad_probe_every:
                t_probe = time.monotonic()
                out = self.grad_probe(*batches[0])
                self.logger.log(step, "health", event="grad_probe", severity="info",
                                **{k: float(v) for k, v in out.items()})
                t0 += time.monotonic() - t_probe    # the probe stays out of episodes_per_s
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
                    self.save_latest(step)
                t0 += time.monotonic() - t_val    # eval + saves stay out of episodes_per_s
        if self.ckpt is not None:
            self.save_latest(step)
        return step

    def save_latest(self, step: int) -> None:
        self.ckpt.save_latest(step, self.model, self.opt, best_val=self.best_val,
                              samplers=self.sampler_states())

    def sampler_states(self) -> dict:
        """The random-stream state of the train and val samplers."""
        return {name: s.rng.bit_generator.state
                for name, s in (("train", self.train_sampler), ("val", self.val_sampler))
                if s is not None and hasattr(s, "rng")}

    def restore_sampler_states(self, states: dict) -> None:
        for name, s in (("train", self.train_sampler), ("val", self.val_sampler)):
            if s is not None and name in states:
                s.rng.bit_generator.state = states[name]

    def evaluate(self, num_episodes: int, sampler=None, return_metrics: bool = False):
        """Mean episode accuracy over ``num_episodes`` episodes (at least one
        batch), or the full metric dict with ``return_metrics``."""
        sampler = sampler or self.val_sampler
        remaining = max(1, num_episodes // sampler.batch_size)
        it = iter(sampler)
        spc = self.eval_spc
        outs = []
        while remaining > 0:
            if self.multi_eval_step is not None and remaining >= max(1, spc // 8):
                take = min(spc, remaining)
                batches = [batch_to_model_inputs(next(it)) for _ in range(take)]
                out = self.multi_eval_step(*stack_batches(batches + [batches[-1]] * (spc - take)))
                outs.append({k: v[:take] for k, v in out.items()})
                remaining -= take
            else:
                out = self.eval_step(*batch_to_model_inputs(next(it)))
                outs.append({k: v.reshape(1) for k, v in out.items()})
                remaining -= 1
        arrays = {k: torch.cat([o[k] for o in outs]).float().cpu().numpy() for k in outs[0]}
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
