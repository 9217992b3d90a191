"""Exact lazy Adam for the word table: the state and the step's two ends.

Counterpart of ``induction_network_on_fewrel_tpu/train/lazy_embed.py``.
With weight decay off the table (the documented lazy semantics; the dense
twin is Adam with decay on everything but the table), a row's Adam state
evolves in closed form on the steps that do not touch it, so the table is
brought up to date only where it is read. Per training call:

1. (live path only) the batch's word ids are deduplicated into a static
   ``[U = min(T, V)]`` vector on the device: sort, mark first occurrences,
   cumsum, scatter with pad = V, and the tokens remapped from the same sort
   (``LazyTable.dedup``; ``torch.unique`` would sync the host and cannot be
   captured). The token-cache path precomputes this once per corpus
   (``augment_token_table``: ``uids`` and every token's ``winv``);
2. ``prologue``: the ``lazy_catchup`` kernel gathers rows ``ids`` of (table,
   m, v, last) and catches them up to the update count into the compact
   buffers (``rows``, an autograd leaf, and its moments);
3. the forward reads ``rows`` through the remapped ids
   (``Embedding.compact_rows``), so the backward gives a compact [U, D]
   gradient and the dense [V, D] one is never built; the optimizer applies
   ``adam_nodecay`` to the compact leaf, whose gradient joins the global
   norm in place of the dense table's (``ClipDecayOptimizer.attach_compact``);
4. ``epilogue``: the ``lazy_scatter`` kernel writes the rows, moments and
   ``last = t`` back, dropping pad lanes.

The live path runs 2-4 every step. The token-cache path runs the prologue
once per fused call of S steps and the epilogue once after them: every
corpus row gets the update dense Adam gives it (the zero-gradient step for
rows absent from a batch), so the round trip in between is the identity
(the JAX hoisted scan, ``make_lazy_cached_scan_fns``).

``materialize`` catches every row up in place (before each val pass and
each save), so eval and checkpoints see the dense-equivalent table. The
lazy leaves (``m``, ``v`` f32 [V, D], ``last`` int32 [V]) travel with the
checkpoints. Adam only (JAX ``_require_adam``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from induction_network_on_fewrel_tpu_torch.ops.lazy_embed import (
    lazy_catchup,
    lazy_materialize,
    lazy_scatter,
)

LAZY_LEAVES = ("m", "v", "last")


def require_adam(cfg) -> None:
    if cfg.optimizer != "adam":
        raise ValueError(
            "embed_optimizer=lazy replicates dense Adam's momentum tail; "
            f"it requires --optimizer adam (got {cfg.optimizer!r})"
        )


def augment_token_table(table_np: dict) -> tuple[dict, np.ndarray]:
    """The corpus's sorted distinct word ids ``uids [U]`` and every token's
    position in them ``winv [M, L]`` (added to the table), computed once
    at cache build (the JAX function of the same name)."""
    uids = np.unique(table_np["word"]).astype(np.int32)
    winv = np.searchsorted(uids, table_np["word"]).astype(np.int32)
    return {**table_np, "winv": winv}, uids


def live_rows(cfg) -> int:
    """U of the live path: the word tokens of one training batch, at most
    the table's rows."""
    L, B = cfg.max_length, cfg.batch_size
    tokens = B * (cfg.train_n * cfg.k + cfg.train_n * cfg.q + cfg.na_rate * cfg.q) * L
    return min(tokens, cfg.vocab_size)


class LazyTable:
    """The lazy state of ``model``'s word table and the compact buffers of
    ``U`` rows. ``ids`` holds the rows in the compact buffers: the corpus
    ``uids`` (``cached``) or the batch's deduplicated ids (live)."""

    def __init__(self, model, hyper, U: int, uids: torch.Tensor | None = None):
        self.table = model.embedding.word_embedding
        self.embedding = model.embedding
        self.hyper = hyper
        V, D = self.table.shape
        dev = self.table.device
        self.m = torch.zeros((V, D), dtype=torch.float32, device=dev)
        self.v = torch.zeros((V, D), dtype=torch.float32, device=dev)
        self.last = torch.zeros(V, dtype=torch.int32, device=dev)
        self.cached = uids is not None
        if self.cached:
            U = int(uids.shape[0])
            self.ids = uids
        else:
            self.ids = torch.full((U,), V, dtype=torch.int32, device=dev)
        self.rows = torch.zeros((U, D), dtype=torch.float32, device=dev, requires_grad=True)
        self.rows_m = torch.zeros((U, D), dtype=torch.float32, device=dev)
        self.rows_v = torch.zeros((U, D), dtype=torch.float32, device=dev)

    @property
    def U(self) -> int:
        return int(self.rows.shape[0])

    def dedup(self, support: dict, query: dict) -> tuple[dict, dict]:
        """Live path: the batch's distinct word ids into ``ids`` (sorted, pad
        = V) and the batch with its words remapped into them. Static shapes,
        no host sync."""
        V, U = self.table.shape[0], self.U
        sw, qw = support["word"], query["word"]
        if U < min(sw.numel() + qw.numel(), V):
            raise ValueError(f"the lazy table holds {U} compact rows, a batch of "
                             f"{sw.numel() + qw.numel()} tokens may need more")
        ids = torch.cat([sw.reshape(-1), qw.reshape(-1)]).long()
        sorted_ids, perm = torch.sort(ids, stable=True)
        first = torch.ones_like(sorted_ids, dtype=torch.bool)
        first[1:] = sorted_ids[1:] != sorted_ids[:-1]
        pos = torch.cumsum(first.long(), 0) - 1
        buf = torch.full((U + 1,), V, dtype=torch.long, device=ids.device)
        buf.scatter_(0, torch.where(first, pos, torch.full_like(pos, U)), sorted_ids)
        self.ids.copy_(buf[:U])
        inv = torch.empty_like(pos).scatter_(0, perm, pos)
        n = sw.numel()
        return ({**support, "word": inv[:n].reshape(sw.shape)},
                {**query, "word": inv[n:].reshape(qw.shape)})

    def prologue(self, count: torch.Tensor) -> None:
        lazy_catchup(self.table.detach(), self.m, self.v, self.last, self.ids, count,
                     self.hyper, (self.rows.detach(), self.rows_m, self.rows_v))

    def epilogue(self, count: torch.Tensor) -> None:
        lazy_scatter(self.table.detach(), self.m, self.v, self.last, self.ids,
                     (self.rows.detach(), self.rows_m, self.rows_v), count)

    def materialize(self, count: torch.Tensor) -> None:
        lazy_materialize(self.table.detach(), self.m, self.v, self.last, count, self.hyper)

    @contextlib.contextmanager
    def compact_forward(self):
        """The model's forward reads the compact rows inside this block."""
        self.embedding.compact_rows = self.rows
        try:
            yield
        finally:
            self.embedding.compact_rows = None

    def warm_kernels(self) -> None:
        """Launch the scatter once on scratch tensors so its module is
        loaded before a capture; the lazy state is not touched."""
        dev = self.table.device
        t, mm, vv = (torch.zeros((1, 1), device=dev) for _ in range(3))
        last = torch.zeros(1, dtype=torch.int32, device=dev)
        ids = torch.zeros(1, dtype=torch.int32, device=dev)
        count = torch.zeros(1, dtype=torch.int64, device=dev)
        lazy_scatter(t, mm, vv, last, ids, (t.clone(), mm.clone(), vv.clone()), count)

    def state_dict(self) -> dict:
        return {"m": self.m.detach().clone(), "v": self.v.detach().clone(),
                "last": self.last.detach().clone()}

    def load_state_dict(self, state: dict) -> None:
        """Copy in place (a captured graph holds the addresses)."""
        for name in LAZY_LEAVES:
            dst, src = getattr(self, name), state[name]
            if tuple(dst.shape) != tuple(src.shape) or dst.dtype != src.dtype:
                raise ValueError(f"lazy state {name}: {src.dtype} {tuple(src.shape)} != "
                                 f"{dst.dtype} {tuple(dst.shape)}")
            dst.copy_(src)
