"""Embedding lookups whose backward is a segment sum, not a sorting scatter.

Counterpart of ``induction_network_on_fewrel_tpu/ops/segsum.py``. The
gradient of ``table[ids]`` is the segment sum of the per-token cotangent
rows by id. Two routes, chosen by the table's row count as the JAX
``Embedding`` chooses them (``models/embedding.py:100-160``):

* ``lookup_matmul_grad`` (tables of at most ``MATMUL_GRAD_MAX_ROWS`` rows:
  both position tables, and a small word table): forward exactly
  ``table[ids]``; backward ``one_hot(ids, U)^T @ cot`` in f32, chunked so
  the [chunk, U] one-hot stays near ``_ONEHOT_BYTES`` (the JAX budget and
  chunk rule, ``segsum.py:36-93``). The one-hot is a comparison with
  ``arange(U)``, so nothing reads the ids on the host. A matrix product
  on the card, deterministic.
* ``lookup_scatter_grad`` (larger tables: the 400 002-row GloVe table):
  forward ``table[ids]``; backward ``segsum``, a sort-free scatter-add of
  the token rows into a zeroed f32 [V, D] (PyTorch's ``index_add_``; the
  JAX package keeps XLA's scatter-add here, and neither is a Pallas
  kernel). Its plain version ``segsum_reference`` is the ``index_put_``
  with accumulate that autograd of ``table[ids]`` runs, which sorts the
  ids first.

* ``lookup_prefix_grad`` (the compact rows of the lazy word table when
  they outnumber ``MATMUL_GRAD_MAX_ROWS``, train/lazy_embed.py): backward
  ``segsum_prefix``: the ids sorted, the cotangent rows' running sum in
  f64, and each row's sum the difference of the running sum at its
  segment's two ends (``scatter_reduce`` amax/amin of integer positions,
  which no order changes), each output row written once. No atomics add a
  value, so the lazy path's table gradient is the same on every run. (The
  sorting ``index_put_``, repeatable too, took 5.1 ms a step there on the
  H100: one warp sums the thousands of padding tokens' rows in turn.)

Both backwards sum the same terms as the scatter in another order: the
results agree with it to f32 rounding of each row's terms, not bitwise.
On the card ``index_add_`` adds with f32 atomics, in an order that changes
from run to run, so its result is not bitwise repeatable either: two runs
agree to that rounding (the rows the padding id shares collect thousands
of terms). A check that compares two runs of a step through the word table
holds its gradient and everything after it to a tolerance, not to
equality. On the CPU it adds in token order, as ``index_put_`` does.
"""

from __future__ import annotations

import torch

# Above this many rows the one-hot product's O(T U D) work stops paying
# (the JAX crossover, kept as is).
MATMUL_GRAD_MAX_ROWS = 32768
# One-hot intermediate budget and the least chunk (the JAX values).
_ONEHOT_BYTES = 32 * 2**20
_MIN_CHUNK = 1024


def segment_sum_matmul(cot: torch.Tensor, ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """sum_t one_hot(ids[t]) cot[t] -> [num_rows, D] f32, as one-hot
    products over chunks of the flattened tokens (one chunk when the
    one-hot fits the budget); ids of any shape, cot [*ids.shape, D]."""
    D = cot.shape[-1]
    cot2 = cot.reshape(-1, D).float()
    flat = ids.reshape(-1).long()
    T = flat.numel()
    chunk = max(_MIN_CHUNK, _ONEHOT_BYTES // (num_rows * cot.element_size()))
    rows = torch.arange(num_rows, device=flat.device)
    out = None
    for s in range(0, max(T, 1), chunk):
        onehot = (flat[s:s + chunk, None] == rows).to(torch.float32)    # [C, U]
        part = onehot.transpose(0, 1) @ cot2[s:s + chunk]
        out = part if out is None else out + part
    return out


def segsum_reference(cot: torch.Tensor, ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """The plain version of ``segsum``: ``index_put_`` with accumulate
    into a zeroed f32 [num_rows, D] (what autograd of ``table[ids]`` runs;
    it sorts the ids)."""
    D = cot.shape[-1]
    out = torch.zeros((num_rows, D), dtype=torch.float32, device=cot.device)
    return out.index_put_((ids.reshape(-1).long(),), cot.reshape(-1, D).float(), accumulate=True)


def segsum(cot: torch.Tensor, ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """sum_t one_hot(ids[t]) cot[t] -> [num_rows, D] f32: ``index_add_``
    of the token rows into zeros (no sort; on the card, f32 atomics, and a
    device-side assert on an id out of range)."""
    D = cot.shape[-1]
    out = torch.zeros((num_rows, D), dtype=torch.float32, device=cot.device)
    return out.index_add_(0, ids.reshape(-1).long(), cot.reshape(-1, D).float())


class _LookupMatmulGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.num_rows, ctx.dtype = table.shape[0], table.dtype
        return table[ids]

    @staticmethod
    def backward(ctx, cot):
        (ids,) = ctx.saved_tensors
        return segment_sum_matmul(cot, ids, ctx.num_rows).to(ctx.dtype), None


class _LookupScatterGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.num_rows, ctx.dtype = table.shape[0], table.dtype
        return table[ids]

    @staticmethod
    def backward(ctx, cot):
        (ids,) = ctx.saved_tensors
        return segsum(cot, ids, ctx.num_rows).to(ctx.dtype), None


def segsum_prefix(cot: torch.Tensor, ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """sum_t one_hot(ids[t]) cot[t] -> [num_rows, D] f32 without atomics on
    a value: a stable sort of the ids, the sorted rows' running sum in f64,
    and row r's sum = run[end_r] - run[start_r] over its segment of the
    sorted order (0 for a row no id names). Static shapes, no host sync."""
    D = cot.shape[-1]
    flat = ids.reshape(-1).long()
    T = flat.numel()
    sorted_ids, perm = torch.sort(flat, stable=True)
    # The running sums along the innermost axis ([D, T]): a scan along the
    # outer axis of [T, D] runs each column's T terms on one thread.
    run = torch.zeros((D, T + 1), dtype=torch.float64, device=cot.device)
    run[:, 1:] = cot.reshape(-1, D)[perm].t().double().cumsum(1)
    pos = torch.arange(T + 1, device=cot.device)
    zero = torch.zeros(num_rows, dtype=torch.long, device=cot.device)
    end = zero.scatter_reduce(0, sorted_ids, pos[1:], "amax", include_self=False)
    start = zero.scatter_reduce(0, sorted_ids, pos[:-1], "amin", include_self=False)
    return (run[:, end] - run[:, start]).t().float().contiguous()


class _LookupPrefixGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.num_rows, ctx.dtype = table.shape[0], table.dtype
        return table[ids]

    @staticmethod
    def backward(ctx, cot):
        (ids,) = ctx.saved_tensors
        return segsum_prefix(cot, ids, ctx.num_rows).to(ctx.dtype), None


def lookup_matmul_grad(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (ids int64 of any shape) whose table gradient is the
    chunked one-hot product. For tables of at most MATMUL_GRAD_MAX_ROWS."""
    return _LookupMatmulGrad.apply(table, ids)


def lookup_scatter_grad(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (ids int64 of any shape) whose table gradient is the
    sort-free scatter-add ``segsum``."""
    return _LookupScatterGrad.apply(table, ids)


def lookup_prefix_grad(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (ids int64 of any shape) whose table gradient is the
    repeatable, atomic-free ``segsum_prefix``."""
    return _LookupPrefixGrad.apply(table, ids)
