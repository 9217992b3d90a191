"""Train/eval steps and the optimizer chain.

Counterpart of ``induction_network_on_fewrel_tpu/train/steps.py`` for the
flagship path (``embed_optimizer="shared"``, ``optimizer="adam"``). One
training step is forward, loss, backward and update, eager on the card;
the encoder's backward runs the K8/K11 kernels through the autograd
Functions of ``ops/``.

``ClipDecayAdam`` is the optax chain the JAX package builds, written out so
its semantics match exactly rather than approximately:

    clip_by_global_norm(grad_clip)    g <- g if |g| < max else g / |g| * max
                                      (no epsilon, unlike clip_grad_norm_)
    add_decayed_weights(wd)           g <- g + wd * p   (coupled L2, after
                                      the clip)
    adam(schedule)                    m <- b1 m + (1-b1) g;  v <- b2 v + (1-b2) g^2
                                      p <- p - lr(c) * m_hat / (sqrt(v_hat) + eps)
                                      (eps outside the square root)

with the staircase schedule lr(c) = lr * gamma ** floor(c / step_size),
where c counts the updates already applied (optax's ``scale_by_schedule``
reads its count before incrementing it) and the bias corrections use c+1.
The whole update stays on the device: the clip's choice is a
``torch.where`` on the norm, never a host sync.
"""

from __future__ import annotations

import math

import torch

from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.models.base import to_device
from induction_network_on_fewrel_tpu_torch.models.losses import (
    LOSS_FNS,
    accuracy,
    episode_metrics,
)


class ClipDecayAdam:
    """clip_by_global_norm -> add_decayed_weights -> adam with a staircase
    learning rate, over a fixed list of parameters."""

    def __init__(self, params, lr: float, weight_decay: float, lr_step_size: int,
                 lr_gamma: float, grad_clip: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.weight_decay = lr, weight_decay
        self.lr_step_size, self.lr_gamma = lr_step_size, lr_gamma
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def learning_rate(self) -> float:
        """The staircase rate of the next update."""
        return self.lr * self.lr_gamma ** (self.count // self.lr_step_size)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Apply one update from the parameters' ``.grad``; returns the
        global gradient norm (a device scalar, before the clip)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
        )
        keep = norm < self.grad_clip
        lr = self.learning_rate()
        c = self.count + 1
        bc1, bc2 = 1.0 - self.b1 ** c, 1.0 - self.b2 ** c
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            g = torch.where(keep, g, g / norm * self.grad_clip)
            if self.weight_decay:
                g = g + self.weight_decay * p
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            p.add_(upd, alpha=-lr)
        self.count = c
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": [m.detach().clone() for m in self.mu],
                "nu": [v.detach().clone() for v in self.nu]}

    def load_state_dict(self, state: dict) -> None:
        if len(state["mu"]) != len(self.params):
            raise ValueError(
                f"optimizer state has {len(state['mu'])} moments for {len(self.params)} params"
            )
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            if dst.shape != src.shape:
                raise ValueError(f"optimizer moment shape {tuple(src.shape)} != {tuple(dst.shape)}")
            dst.copy_(src)


def make_optimizer(cfg: ExperimentConfig, model: torch.nn.Module) -> ClipDecayAdam:
    """The JAX ``make_optimizer`` chain for ``optimizer="adam"`` and
    ``embed_optimizer="shared"`` (one optimizer for every parameter, the
    word table included, densely); other values raise by name."""
    if cfg.optimizer != "adam":
        raise ValueError(f"optimizer {cfg.optimizer!r} is not ported yet (adam only)")
    if cfg.embed_optimizer != "shared":
        raise ValueError(
            f"embed_optimizer {cfg.embed_optimizer!r} is not ported yet (shared only)"
        )
    if cfg.lr_step_size <= 0 or not math.isfinite(cfg.lr):
        raise ValueError(f"bad schedule: lr={cfg.lr}, lr_step_size={cfg.lr_step_size}")
    return ClipDecayAdam(
        model.parameters(), lr=cfg.lr, weight_decay=cfg.weight_decay,
        lr_step_size=cfg.lr_step_size, lr_gamma=cfg.lr_gamma, grad_clip=cfg.grad_clip,
    )


def loss_and_metrics(model, support, query, label, loss_name: str):
    """(loss, {"loss", "accuracy"}) of one batch; metrics are detached."""
    logits = model(support, query)
    loss = LOSS_FNS[loss_name](logits, label)
    return loss, {"loss": loss.detach(), "accuracy": accuracy(logits.detach(), label)}


def train_step(model, opt: ClipDecayAdam, cfg: ExperimentConfig, support, query, label) -> dict:
    """One update on one batch (numpy or tensor leaves). Returns device
    scalars: loss, accuracy and the pre-clip gradient norm."""
    dev = model.device
    support, query = to_device(support, dev), to_device(query, dev)
    label = torch.as_tensor(label).to(dev)
    opt.zero_grad()
    loss, metrics = loss_and_metrics(model, support, query, label, cfg.loss)
    loss.backward()
    metrics["grad_norm"] = opt.step()
    return metrics


@torch.inference_mode()
def eval_step(model, cfg: ExperimentConfig, support, query, label) -> dict:
    """Loss + episode metrics of one batch, without a graph (the K1/K2 route)."""
    dev = model.device
    support, query = to_device(support, dev), to_device(query, dev)
    label = torch.as_tensor(label).to(dev)
    logits = model(support, query)
    return {"loss": LOSS_FNS[cfg.loss](logits, label),
            **episode_metrics(logits, label, cfg.na_rate > 0)}
