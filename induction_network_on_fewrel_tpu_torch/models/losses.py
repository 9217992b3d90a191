"""Losses and episode metrics.

Counterpart of ``induction_network_on_fewrel_tpu/models/losses.py``: MSE
between sigmoid relation scores and the one-hot episode label (Geng et al.
§3.4), or cross entropy over the logits, flag-selected; accuracy; and the
NOTA confusion fractions when the N+1 "none" class is active. The three
NOTA entries share one denominator (all queries), so aggregated precision
and recall are exact: p = Σtp/Σpred, r = Σtp/Σtrue.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mse_onehot_loss(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """logits [B, TQ, C] pre-sigmoid, label [B, TQ] int -> scalar."""
    scores = torch.sigmoid(logits)
    onehot = F.one_hot(label.long(), logits.shape[-1]).to(scores.dtype)
    return torch.mean(torch.square(scores - onehot))


def cross_entropy_loss(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), label.reshape(-1).long())


LOSS_FNS = {"mse": mse_onehot_loss, "ce": cross_entropy_loss}


def predict(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


def accuracy(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    return torch.mean((predict(logits) == label).float())


def episode_metrics(logits: torch.Tensor, label: torch.Tensor, nota: bool) -> dict:
    """accuracy (+ nota_tp / nota_pred / nota_true fractions when ``nota``)."""
    m = {"accuracy": accuracy(logits, label)}
    if nota:
        n = logits.shape[-1] - 1  # the appended none-of-the-above class
        is_pred = predict(logits) == n
        is_true = label == n
        m["nota_tp"] = torch.mean((is_pred & is_true).float())
        m["nota_pred"] = torch.mean(is_pred.float())
        m["nota_true"] = torch.mean(is_true.float())
    return m
