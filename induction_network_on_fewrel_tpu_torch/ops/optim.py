"""The optimizer update of every parameter: plain versions and the CUDA pair.

Counterpart of the update that the JAX package's ``make_optimizer`` chain
(``induction_network_on_fewrel_tpu/train/steps.py:48-128``) leaves to XLA,
which fuses it into one pass: ``clip_by_global_norm`` over every gradient,
then per tensor one of

    adam       g += wd p (coupled L2, after the clip);
               m <- b1 m + (1-b1) g;  v <- b2 v + (1-b2) g^2
               p <- p - lr m^ / (sqrt(v^) + eps)           (optax.adam)
    adamw      the same moments of the clipped g;
               p <- p - lr (m^ / (sqrt(v^) + eps) + wd p)   (optax.adamw)
    sgd        p <- p - lr (g + wd p)                       (optax.sgd, no momentum)
    sgd_plain  p <- p - lr g   (the word table's ``embed_optimizer="sgd"``)

with the staircase rate lr = lr0 gamma^floor(c / step_size), where c
counts the updates already applied, and the bias corrections
m^ = m / (1 - b1^(c+1)), v^ = v / (1 - b2^(c+1)), all in f32 on the device
from the device count, as optax computes them. The clip keeps g when
|g| < clip, else g / |g| * clip (no epsilon). A frozen table is not in the
update at all: it has no gradient, no moments and adds nothing to |g|.

Two kernels (``csrc/optim.cu``), one launch each per update, over a table
of (parameter, gradient, moments, size, rule) entries that travels as the
kernel's by-value parameter:

* ``optim_sumsq``: per-chunk sums of squares of every gradient, then the
  global norm from the chunk sums in a fixed order (bitwise repeatable).
  Its plain version ``optim_sumsq_reference`` takes the same chunks and
  the same order of the final sum.
* ``optim_update``: reads the norm, the count and the configuration, and
  applies the clip scale and each tensor's rule, reading p, g, m, v once
  and writing p, m, v once; it advances the count. Its plain version
  ``optim_update_reference`` is the per-parameter loop.

The wrappers take the plain version only for tensors on the CPU; on CUDA
tensors they launch the kernel or raise. ``launches`` counts kernel
launches. Parameters and gradients are f32 and contiguous.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from induction_network_on_fewrel_tpu_torch.kernels.build import LIBRARY, check_cuda_tensors

# csrc/optim.cu: elements per chunk (one CTA of 256 threads x 16 float4),
# the table's capacity and the threads of the final sum.
CHUNK = 16384
MAX_TENSORS = 64
_FINAL_THREADS = 256
RULES = ("adam", "adamw", "sgd", "sgd_plain")
MOMENT_RULES = ("adam", "adamw")


class OptimHyper(NamedTuple):
    """The configuration of one update rule family."""

    lr: float
    lr_gamma: float
    lr_step_size: int
    weight_decay: float
    grad_clip: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


class OptimWorkspace(NamedTuple):
    """Device buffers of the pair: the chunk sums and the two arrival
    counters, which the kernels leave at zero."""

    partials: torch.Tensor
    counters: torch.Tensor


def num_chunks(tensors) -> int:
    return sum(-(-t.numel() // CHUNK) for t in tensors)


def make_workspace(params) -> OptimWorkspace:
    """The pair's workspace for ``params`` (one entry per tensor), on their
    device. Made before a graph capture, so its counters hold zeros when
    the first replay reads them."""
    dev = params[0].device
    return OptimWorkspace(
        torch.zeros(max(1, num_chunks(params)), dtype=torch.float32, device=dev),
        torch.zeros(2, dtype=torch.int32, device=dev),
    )


def entry_rows(params, grads, mus, nus, rules) -> np.ndarray:
    """[n, 7] int64 rows (p, g, m, v, numel, first chunk, rule code) of the
    kernels' table; a missing gradient or moment is a null pointer."""
    if not 1 <= len(params) <= MAX_TENSORS:
        raise ValueError(f"optimizer table: {len(params)} tensors, the kernels take "
                         f"1..{MAX_TENSORS}")
    rows, chunk0 = [], 0
    for p, g, m, v, rule in zip(params, grads, mus, nus, rules):
        rows.append((p.data_ptr(), 0 if g is None else g.data_ptr(),
                     0 if m is None else m.data_ptr(), 0 if v is None else v.data_ptr(),
                     p.numel(), chunk0, RULES.index(rule)))
        chunk0 += -(-p.numel() // CHUNK)
    return np.asarray(rows, dtype=np.int64)


def _check(name, params, grads, mus, nus, rules):
    for p, g, m, v, rule in zip(params, grads, mus, nus, rules):
        if rule not in RULES:
            raise ValueError(f"{name}: unknown rule {rule!r} (one of {RULES})")
        if rule in MOMENT_RULES and (m is None or v is None):
            raise ValueError(f"{name}: rule {rule!r} needs both moments")
        for x in (p, g, m, v):
            if x is not None and (x.dtype != torch.float32 or x.shape != p.shape):
                raise ValueError(f"{name}: tensors must be f32 of the parameter's shape, got "
                                 f"{x.dtype} {tuple(x.shape)} for {tuple(p.shape)}")
    live = [x for group in (params, grads, mus, nus) for x in group if x is not None]
    check_cuda_tensors(name, *live)


# --- plain versions ------------------------------------------------------------


def optim_sumsq_reference(params, grads) -> torch.Tensor:
    """The kernel's global norm [1] in its order: the sum of squares of
    each CHUNK-element chunk of each gradient (a missing gradient gives
    zero chunks), then thread j of one 256-thread CTA sums chunks j,
    j + 256, ... in turn and the CTA sums the 256 results; the square root
    of that. f32 throughout."""
    parts = []
    for p, g in zip(params, grads):
        n, k = p.numel(), -(-p.numel() // CHUNK)
        if g is None:
            parts.append(torch.zeros(k, dtype=torch.float32, device=p.device))
            continue
        x = F.pad(g.detach().float().reshape(-1), (0, k * CHUNK - n)).reshape(k, CHUNK)
        parts.append((x * x).sum(dim=1))
    rows = torch.cat(parts)
    rows = F.pad(rows, (0, (-rows.numel()) % _FINAL_THREADS)).reshape(-1, _FINAL_THREADS)
    per_thread = rows[0].clone()
    for row in rows[1:]:
        per_thread += row
    return torch.sqrt(per_thread.sum()).reshape(1)


def _schedule(count: torch.Tensor, hp: OptimHyper):
    """(lr, 1 - b1^(c+1), 1 - b2^(c+1)) as f32 device scalars from the
    update count ``c`` (int64 device scalar)."""
    f32 = dict(dtype=torch.float32, device=count.device)
    k = torch.div(count, hp.lr_step_size, rounding_mode="floor").to(torch.float32)
    c1 = (count + 1).to(torch.float32)
    lr = torch.tensor(hp.lr, **f32) * torch.pow(torch.tensor(hp.lr_gamma, **f32), k)
    bc1 = 1.0 - torch.pow(torch.tensor(hp.b1, **f32), c1)
    bc2 = 1.0 - torch.pow(torch.tensor(hp.b2, **f32), c1)
    return lr, bc1, bc2


@torch.no_grad()
def optim_update_reference(params, grads, mus, nus, rules, norm, count, hp: OptimHyper) -> None:
    """The per-parameter loop: the update ``optim_update`` makes, a dozen
    ops per tensor, in place; advances ``count``."""
    lr, bc1, bc2 = _schedule(count.reshape(()), hp)
    norm = norm.reshape(())
    keep = norm < hp.grad_clip
    wd = hp.weight_decay
    for p, g, m, v, rule in zip(params, grads, mus, nus, rules):
        g = torch.zeros_like(p) if g is None else g
        g = torch.where(keep, g, g / norm * hp.grad_clip)
        if rule == "adam":
            g = g + wd * p
        if rule in MOMENT_RULES:
            m.mul_(hp.b1).add_(g, alpha=1.0 - hp.b1)
            v.mul_(hp.b2).addcmul_(g, g, value=1.0 - hp.b2)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + hp.eps)
            if rule == "adamw":
                upd = upd + wd * p
        elif rule == "sgd":
            upd = g + wd * p
        else:
            upd = g
        p.sub_(lr * upd)
    count.add_(1)


# --- kernels -------------------------------------------------------------------


def optim_sumsq(params, grads, ws: OptimWorkspace | None = None) -> torch.Tensor:
    """Global norm [1] (f32, a new tensor) of the gradients ``grads`` of
    ``params`` (a missing gradient counts as zeros). On CUDA, launches
    ``optim_sumsq`` with the chunk sums in ``ws``; on the CPU,
    ``optim_sumsq_reference``."""
    if params[0].device.type == "cpu":
        return optim_sumsq_reference(params, grads)
    if ws is None:
        raise ValueError("optim_sumsq: CUDA gradients need the pair's workspace")
    n = len(params)
    _check("optim_sumsq", params, grads, [None] * n, [None] * n, ["sgd_plain"] * n)
    check_cuda_tensors("optim_sumsq", params[0], ws.partials, ws.counters)
    if num_chunks(params) > ws.partials.numel():
        raise ValueError("optim_sumsq: the workspace holds fewer chunk sums than the table")
    rows = entry_rows(params, grads, [None] * n, [None] * n, ["sgd_plain"] * n)
    norm = torch.empty(1, dtype=torch.float32, device=params[0].device)
    LIBRARY.launch_on(params[0].device, "optim_sumsq", rows.ctypes.data, n,
                      ws.partials.data_ptr(), ws.counters.data_ptr(), norm.data_ptr())
    optim_sumsq.launches += 1
    return norm


optim_sumsq.launches = 0


def optim_update(params, grads, mus, nus, rules, norm, count, hp: OptimHyper,
                 ws: OptimWorkspace | None = None) -> None:
    """Apply one update of every entry in place from the global ``norm``
    [1] and the update ``count`` (int64, advanced by one). On CUDA,
    launches ``optim_update``; on the CPU, ``optim_update_reference``."""
    if params[0].device.type == "cpu":
        optim_update_reference(params, grads, mus, nus, rules, norm, count, hp)
        return
    if ws is None:
        raise ValueError("optim_update: CUDA tensors need the pair's workspace")
    if hp.lr_step_size < 1:
        raise ValueError(f"optim_update: lr_step_size must be >= 1, got {hp.lr_step_size}")
    _check("optim_update", params, grads, mus, nus, rules)
    if count.dtype != torch.int64 or count.numel() != 1 or norm.numel() != 1:
        raise ValueError("optim_update: count must be one int64 and norm one f32")
    check_cuda_tensors("optim_update", params[0], norm, count, ws.counters)
    rows = entry_rows(params, grads, mus, nus, rules)
    f32 = np.float32
    LIBRARY.launch_on(params[0].device, "optim_update", rows.ctypes.data, len(rows),
                      norm.data_ptr(), count.data_ptr(), ws.counters[1:].data_ptr(),
                      float(f32(hp.lr)), float(f32(hp.lr_gamma)), int(hp.lr_step_size),
                      float(f32(hp.b1)), float(f32(hp.b2)), float(f32(1.0 - hp.b1)),
                      float(f32(1.0 - hp.b2)), float(f32(hp.eps)), float(f32(hp.weight_decay)),
                      float(f32(hp.grad_clip)))
    optim_update.launches += 1


optim_update.launches = 0
