"""Exact lazy Adam on the word table: the catch-up and the write-back.

Counterpart of ``induction_network_on_fewrel_tpu/train/lazy_embed.py:147
decay_catchup`` (and its whole-table form ``:506 make_materialize``) and of
the scatter of the compact rows (``:460``, ``:318``), which the JAX package
leaves to XLA. With weight decay off the table, a row that gets no
gradient for k steps only decays (m <- b1 m, v <- b2 v) while its weight
moves by the bias-corrected momentum tail, so its state can be brought up
to date when it is next read:

* ``lazy_catchup``: gather rows ``ids [R]`` of (table, m, v, last) and
  apply their skipped pure-decay Adam steps up to the update count ``t``
  into compact [R, D] buffers. Per row, alive = any m or v nonzero,
  k = max(t - last, 0), kc = min(k, CATCHUP_CAP) if alive else 0; kc steps
  in the JAX order (lr = schedule(u - 1), bias corrections 1 - b^u in
  f32), then the residual decay m b1^(k-kc), v b2^(k-kc). An id of V or
  more is a pad lane: it reads row V-1 and is not caught up.
* ``lazy_materialize``: the same catch-up of every row, in place, and
  ``last`` set to t for every row with moments (before a val pass or a
  save). A row with zero moments never moves whatever its gap, so its
  ``last`` is left as it is, unlike the JAX ``make_materialize``, which
  sets every ``last``: a delta ring save after a materialize then holds
  the rows that trained, not the whole table.
* ``lazy_scatter``: write compact rows, moments and last = t back at
  ``ids``, dropping pad lanes.

Each is one hand-written kernel on the card (``csrc/lazy_embed.cu``; the
catch-up and materialize share one). The trip count of the catch-up is
read from the device inside the kernel, so a CUDA graph replays it with no
host sync. The plain versions (``*_reference``) repeat the arithmetic in
PyTorch; the wrappers take them only for tensors on the CPU, and on CUDA
tensors launch the kernel or raise. ``launches`` counts kernel launches.
State tensors: table, m, v f32 [V, D]; last int32 [V]; the update count
``count`` int64 [1] on the table's device.
"""

from __future__ import annotations

import numpy as np
import torch

from induction_network_on_fewrel_tpu_torch.kernels.build import LIBRARY, check_cuda_tensors
from induction_network_on_fewrel_tpu_torch.ops.optim import OptimHyper

# Momentum-tail catch-up cap: b1^1024 ~ 1e-47, so the weight drift of the
# steps beyond it is far below f32 resolution (the JAX value).
CATCHUP_CAP = 1024
# csrc/lazy_embed.cu: values of a row one lane holds (D <= 32 * 4).
MAX_D = 128


def _f32(x: float, dev) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=dev)


def lazy_catchup_reference(table, m, v, last, ids, t: int, hp: OptimHyper,
                           cap: int = CATCHUP_CAP):
    """(W, m, v) [R, D] of rows ``ids`` (None: every row) caught up to
    update count ``t``: the plain version of ``lazy_catchup``."""
    dev, V = table.device, table.shape[0]
    if ids is None:
        src = torch.arange(V, device=dev)
        pad = torch.zeros(V, dtype=torch.bool, device=dev)
    else:
        ids = ids.long()
        pad = (ids < 0) | (ids >= V)
        src = ids.clamp(0, V - 1)
    W, mm, vv = table.detach()[src].float(), m[src].float(), v[src].float()
    last_r = last[src].long()
    k = torch.where(pad, torch.zeros_like(last_r), (t - last_r).clamp(min=0))
    alive = (mm != 0).any(-1) | (vv != 0).any(-1)
    kc = torch.where(alive, k.clamp(max=cap), torch.zeros_like(k))
    b1, b2, gamma = _f32(hp.b1, dev), _f32(hp.b2, dev), _f32(hp.lr_gamma, dev)
    lr0, eps = _f32(hp.lr, dev), _f32(hp.eps, dev)
    for s in range(1, int(kc.max()) + 1 if kc.numel() else 1):
        active = (s <= kc)[:, None]
        u = last_r + s
        uf = u.float()
        bc1 = (1.0 - torch.pow(b1, uf))[:, None]
        bc2 = (1.0 - torch.pow(b2, uf))[:, None]
        lr = (lr0 * torch.pow(gamma, torch.div(u - 1, hp.lr_step_size,
                                               rounding_mode="floor").float()))[:, None]
        m2, v2 = b1 * mm, b2 * vv
        upd = (lr * (m2 / bc1)) / (torch.sqrt(v2 / bc2) + eps)
        W = torch.where(active, W - upd, W)
        mm = torch.where(active, m2, mm)
        vv = torch.where(active, v2, vv)
    resid = (k - kc).clamp(min=0).float()[:, None]
    return W, mm * torch.pow(b1, resid), vv * torch.pow(b2, resid)


def lazy_scatter_reference(table, m, v, last, ids, rows_w, rows_m, rows_v, t: int) -> None:
    """The plain version of ``lazy_scatter``: boolean-masked index writes."""
    ids = ids.long()
    keep = (ids >= 0) & (ids < table.shape[0])
    dst = ids[keep]
    table[dst] = rows_w[keep]
    m[dst] = rows_m[keep]
    v[dst] = rows_v[keep]
    last[dst] = t


def _check_state(name, table, m, v, last, count):
    V, D = table.shape
    for x in (table, m, v):
        if x.dtype != torch.float32 or tuple(x.shape) != (V, D):
            raise ValueError(f"{name}: table and moments must be f32 [{V}, {D}], got "
                             f"{x.dtype} {tuple(x.shape)}")
    if last.dtype != torch.int32 or tuple(last.shape) != (V,):
        raise ValueError(f"{name}: last must be int32 [{V}], got {last.dtype} {tuple(last.shape)}")
    if count.dtype != torch.int64 or count.numel() != 1:
        raise ValueError(f"{name}: count must be one int64")
    if not 1 <= D <= MAX_D:
        raise ValueError(f"{name}: the kernel takes 1 <= D <= {MAX_D}, got {D}")


def _check_rows(name, ids, rows, D):
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise ValueError(f"{name}: ids must be int32 [R], got {ids.dtype} {tuple(ids.shape)}")
    for x in rows:
        if x.dtype != torch.float32 or tuple(x.shape) != (ids.shape[0], D):
            raise ValueError(f"{name}: compact rows must be f32 [{ids.shape[0]}, {D}], got "
                             f"{x.dtype} {tuple(x.shape)}")


def _hyper_args(hp: OptimHyper) -> tuple:
    f32 = np.float32
    if hp.lr_step_size < 1:
        raise ValueError(f"lr_step_size must be >= 1, got {hp.lr_step_size}")
    return (float(f32(hp.lr)), float(f32(hp.lr_gamma)), int(hp.lr_step_size),
            float(f32(hp.b1)), float(f32(hp.b2)), float(f32(hp.eps)), CATCHUP_CAP)


def lazy_catchup(table, m, v, last, ids, count, hp: OptimHyper, out: tuple) -> tuple:
    """Gather rows ``ids`` (int32 [R]) of the lazy state caught up to the
    update count into ``out`` = (W_r, m_r, v_r), each f32 [R, D]; returns
    ``out``. On CUDA one launch of ``lazy_catchup``; on the CPU the plain
    version."""
    _check_state("lazy_catchup", table, m, v, last, count)
    _check_rows("lazy_catchup", ids, out, table.shape[1])
    if table.device.type == "cpu":
        with torch.no_grad():
            for dst, src in zip(out, lazy_catchup_reference(table, m, v, last, ids, int(count),
                                                            hp)):
                dst.copy_(src)
        return out
    check_cuda_tensors("lazy_catchup", table, m, v, last, ids, count, *out)
    V, D = table.shape
    LIBRARY.launch_on(table.device, "lazy_catchup", table.data_ptr(), m.data_ptr(),
                      v.data_ptr(), last.data_ptr(), ids.data_ptr(), out[0].data_ptr(),
                      out[1].data_ptr(), out[2].data_ptr(), count.data_ptr(), ids.shape[0], V,
                      D, *_hyper_args(hp), 0)
    lazy_catchup.launches += 1
    return out


lazy_catchup.launches = 0


def lazy_materialize(table, m, v, last, count, hp: OptimHyper) -> None:
    """Catch every row of the table up to the update count, in place, and
    set ``last`` to it for the rows with moments: the exact dense-equivalent
    table. On CUDA one in-place launch of ``lazy_catchup`` (counted there),
    which writes only the rows that change."""
    _check_state("lazy_materialize", table, m, v, last, count)
    if table.device.type == "cpu":
        t = int(count)
        alive = (m != 0).any(-1) | (v != 0).any(-1)
        W, mm, vv = lazy_catchup_reference(table, m, v, last, None, t, hp)
        with torch.no_grad():
            table.copy_(W)
        m.copy_(mm)
        v.copy_(vv)
        last[alive] = t
        return
    check_cuda_tensors("lazy_materialize", table, m, v, last, count)
    V, D = table.shape
    LIBRARY.launch_on(table.device, "lazy_catchup", table.data_ptr(), m.data_ptr(),
                      v.data_ptr(), last.data_ptr(), None, table.data_ptr(), m.data_ptr(),
                      v.data_ptr(), count.data_ptr(), V, V, D, *_hyper_args(hp), 1)
    lazy_catchup.launches += 1


def lazy_scatter(table, m, v, last, ids, rows: tuple, count) -> None:
    """Write ``rows`` = (W_r, m_r, v_r) [R, D] back at ``ids`` (int32 [R];
    ids of V or more are dropped) and set those rows' ``last`` to the
    update count. On CUDA one launch of ``lazy_scatter``; on the CPU the
    plain version."""
    _check_state("lazy_scatter", table, m, v, last, count)
    _check_rows("lazy_scatter", ids, rows, table.shape[1])
    if table.device.type == "cpu":
        with torch.no_grad():
            lazy_scatter_reference(table, m, v, last, ids, *rows, int(count))
        return
    check_cuda_tensors("lazy_scatter", table, m, v, last, ids, count, *rows)
    V, D = table.shape
    LIBRARY.launch_on(table.device, "lazy_scatter", table.data_ptr(), m.data_ptr(),
                      v.data_ptr(), last.data_ptr(), ids.data_ptr(), rows[0].data_ptr(),
                      rows[1].data_ptr(), rows[2].data_ptr(), count.data_ptr(), ids.shape[0], V,
                      D)
    lazy_scatter.launches += 1


lazy_scatter.launches = 0
