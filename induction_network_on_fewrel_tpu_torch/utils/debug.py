"""Debug-mode numeric checks.

The counterpart of ``induction_network_on_fewrel_tpu/utils/debug.py``. The
JAX ``checkify_step`` raises from inside a jitted step; nothing can raise
from inside a CUDA-graph replay. So under ``--debug_nans`` the captured
training step computes one more metric on the device, ``finite`` (1.0
when the step's loss and its global gradient norm, the square root of the
sum of squares that ``optim_sumsq`` already produces, are both finite),
and the trainer reads it after each replay and raises
``FloatingPointError`` naming the first step whose flag is 0
(``check_finite_steps``). Without the flag the captured graph is the
same as ever. ``assert_all_finite`` is the host check of a metrics dict.
"""

from __future__ import annotations

import math

import torch


def finite_flag(loss: torch.Tensor, grad_norm: torch.Tensor) -> torch.Tensor:
    """1.0 where both the loss and the gradient norm are finite, else 0.0
    (a device scalar; no host sync)."""
    return (torch.isfinite(loss) & torch.isfinite(grad_norm)).float()


def check_finite_steps(finite: torch.Tensor, first_step: int) -> None:
    """Raise ``FloatingPointError`` naming the first step of a call (steps
    ``first_step + 1 ...``) whose ``finite`` flag is 0. Reads the flags
    (one host sync)."""
    flags = finite.reshape(-1).tolist()
    for i, ok in enumerate(flags):
        if not ok:
            raise FloatingPointError(
                f"non-finite loss or gradient at step {first_step + i + 1} (--debug_nans: "
                f"the call over steps {first_step + 1}..{first_step + len(flags)})")


def assert_all_finite(metrics: dict, step: int | None = None) -> None:
    bad = {k: float(v) for k, v in metrics.items() if not math.isfinite(float(v))}
    if bad:
        raise FloatingPointError(f"non-finite metrics at step {step}: {bad}")
