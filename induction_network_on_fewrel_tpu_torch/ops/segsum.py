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


def lookup_matmul_grad(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (ids int64 of any shape) whose table gradient is the
    chunked one-hot product. For tables of at most MATMUL_GRAD_MAX_ROWS."""
    return _LookupMatmulGrad.apply(table, ids)


def lookup_scatter_grad(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (ids int64 of any shape) whose table gradient is the
    sort-free scatter-add ``segsum``."""
    return _LookupScatterGrad.apply(table, ids)
