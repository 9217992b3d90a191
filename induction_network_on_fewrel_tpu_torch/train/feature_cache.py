"""Frozen-encoder feature cache: encode each split once, train the head on features.

Counterpart of ``induction_network_on_fewrel_tpu/train/feature_cache.py``.
A frozen BERT backbone gives the same sentence vector for the same
sentence at every step, so the cache runs it once per split and the
training steps run the episode head alone:

1. ``encode_table`` tokenizes every instance of a split once
   (``train/token_cache.tokenize_dataset``), and ``encode_rows`` copies the
   tokens to the card and pushes them through the model's ``encode`` in
   fixed ``[batch_size, L]`` chunks under ``torch.no_grad`` (the last chunk
   padded with its last row, then sliced), giving one f32 ``[M, H]``
   table, rows grouped by relation. ``encode_dataset`` is the JAX function's form: one numpy
   block per relation.
2. ``FeatureTable`` keeps that table on the card and gathers episode rows
   from index batches; it is the ``source`` of ``train/steps.py``'s step
   factories (the token cache's ``TokenTable`` role), so the cached train,
   fused-train and eval steps are those factories' CUDA-graph steps with
   the gather inside the graph, and only the [B, N, K] and [B, TQ] int32
   indices and the labels cross to the card each step. The index samplers
   are ``sampling/index.py``'s and ``sampling/native.py``'s.
3. The model trained on it is ``build_model(cfg)`` with ``feature_cache``
   set: the episode head over ``models/bert.CachedFeatures``, so the
   optimizer and the checkpoints hold the head's parameters alone (the
   JAX head-only state, leaf for leaf). Its backbone is
   ``build_model(cfg.replace(feature_cache=False))`` from the same seed
   (and ``bert_weights``), rebuilt by the run that tests the checkpoint.

``FeatureEpisodeSampler`` is the JAX sampler's feature mode: the index
sampler's episodes gathered from a host table into ``FeatureEpisodeBatch``
arrays. Token-level models (``pair``) cannot train on sentence features.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from induction_network_on_fewrel_tpu_torch.data.fewrel import FewRelDataset
from induction_network_on_fewrel_tpu_torch.models.base import QUERY_KEYS
from induction_network_on_fewrel_tpu_torch.sampling.index import IndexEpisodeSampler
from induction_network_on_fewrel_tpu_torch.train.token_cache import tokenize_dataset


class FeatureEpisodeBatch(NamedTuple):
    """B feature episodes: support [B, N, K, H] f32, query [B, TQ, H], label [B, TQ]."""

    support: np.ndarray
    query: np.ndarray
    label: np.ndarray


def encode_table(model, dataset: FewRelDataset, tokenizer,
                 batch_size: int = 256) -> tuple[torch.Tensor, list[int]]:
    """(f32 [M, H] table on the model's device, rows per relation): every
    instance of ``dataset`` through ``model.encode`` once, relations in
    ``dataset.rel_names`` order, in fixed [batch_size, L] chunks."""
    arrays, sizes = tokenize_dataset(dataset, tokenizer)
    return encode_rows(model, arrays, batch_size), sizes


def encode_rows(model, arrays: dict[str, np.ndarray], batch_size: int = 256) -> torch.Tensor:
    """``tokenize_dataset``'s token table through ``model.encode``: one copy
    to the card, then fixed [batch_size, L] chunks under ``torch.no_grad``
    (the last padded with its last row, then sliced); f32 [M, H]."""
    dev = model.device
    toks = {k: torch.as_tensor(np.ascontiguousarray(arrays[k])).to(dev) for k in QUERY_KEYS}
    total = toks["word"].shape[0]
    out = []
    with torch.no_grad():
        for lo in range(0, total, batch_size):
            hi = min(lo + batch_size, total)
            pad = batch_size - (hi - lo)

            def chunk(t):
                part = t[lo:hi]
                return torch.cat([part, t[hi - 1:hi].expand(pad, *t.shape[1:])]) if pad else part

            enc = model.encode(*(chunk(toks[k]) for k in QUERY_KEYS))
            out.append(enc[:hi - lo].float())
    return torch.cat(out)


def encode_dataset(model, dataset: FewRelDataset, tokenizer,
                   batch_size: int = 256) -> list[np.ndarray]:
    """``encode_table`` as the JAX function returns it: one f32 [M_rel, H]
    numpy block per relation."""
    table, sizes = encode_table(model, dataset, tokenizer, batch_size)
    return np.split(table.cpu().numpy(), np.cumsum(sizes)[:-1])


class FeatureTable:
    """One split's encoded rows on the card ([M, H] f32, ``table``), the
    rows per relation (``sizes``) the index sampler draws from, and the
    seconds its build took on the host: ``tokenize_s``, then ``encode_s``
    (until the card is done)."""

    def __init__(self, table: torch.Tensor, sizes, tokenize_s: float = 0.0,
                 encode_s: float = 0.0):
        self.table = table.float().contiguous()
        self.sizes = list(sizes)
        self.tokenize_s, self.encode_s = tokenize_s, encode_s

    @property
    def rows(self) -> int:
        return int(self.table.shape[0])

    @property
    def nbytes(self) -> int:
        return self.table.numel() * self.table.element_size()

    def gather(self, idx: torch.Tensor, compact: bool = False) -> torch.Tensor:
        """The encoded rows ``idx`` names (any shape): [..., H]."""
        return self.table[idx.long()]


def build_feature_table(model, dataset: FewRelDataset, tokenizer,
                        batch_size: int = 256) -> FeatureTable:
    """``encode_table`` of ``dataset`` through ``model`` (the backbone's
    full model), kept on its device, with the tokenize and encode times."""
    t0 = time.perf_counter()
    arrays, sizes = tokenize_dataset(dataset, tokenizer)
    t1 = time.perf_counter()
    table = encode_rows(model, arrays, batch_size)
    if table.is_cuda:
        torch.cuda.synchronize(table.device)
    return FeatureTable(table, sizes, t1 - t0, time.perf_counter() - t1)


class FeatureEpisodeSampler(IndexEpisodeSampler):
    """The index sampler's episodes over per-relation feature blocks,
    gathered on the host: ``sample_batch`` returns ``FeatureEpisodeBatch``.
    The same draws as the JAX ``FeatureEpisodeSampler`` from the same
    seed."""

    def __init__(self, blocks: list, n: int, k: int, q: int, batch_size: int = 1,
                 na_rate: int = 0, seed: int = 0):
        super().__init__([b.shape[0] for b in blocks], n, k, q, batch_size, na_rate, seed)
        self.table = np.concatenate(blocks).astype(np.float32)

    def sample_batch(self) -> FeatureEpisodeBatch:
        sup, qry, label = super().sample_batch()
        return FeatureEpisodeBatch(self.table[sup], self.table[qry], label)
