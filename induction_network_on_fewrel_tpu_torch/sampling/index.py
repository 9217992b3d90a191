"""Seeded episode sampler over per-relation row counts: index episodes.

A numpy copy of the index mode of ``FeatureEpisodeSampler``
(``induction_network_on_fewrel_tpu/train/feature_cache.py:134-266``, the
``python`` branch of ``native/sampler.py:264 make_index_sampler``): the
same draws from ``np.random.default_rng(seed)`` in the same order, so a
seed gives the same episodes in both packages (pinned in
tests/test_torch_token_cache.py). It has the live sampler's episode
statistics (N distinct relations, disjoint K+Q draws per class, NOTA
queries from outside relations at ``na_rate``, shuffled queries) but
returns GLOBAL row indices into a flat table of the split
(train/token_cache.py), so per step only the indices cross to the card.
The random stream is ``rng``; ``feed_state`` (its ``bit_generator`` state)
travels with the checkpoints. ``sample_fused(S)`` stacks S batches, the
interface of the C++ index sampler (``sampling/native.py``).
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np

from induction_network_on_fewrel_tpu_torch.datapipe.cursor import (
    restore_rng_feed_state,
    rng_feed_state,
)
from induction_network_on_fewrel_tpu_torch.sampling.episodes import check_episode_feasibility

SAMPLER_BACKENDS = ("auto", "native", "python")


class IndexEpisodeBatch(NamedTuple):
    """support_idx [B, N, K], query_idx [B, TQ], label [B, TQ]; int32."""

    support_idx: np.ndarray
    query_idx: np.ndarray
    label: np.ndarray


def check_sampler_backend(backend: str) -> None:
    """``backend`` names a sampler backend (sampling/native.py chooses)."""
    if backend not in SAMPLER_BACKENDS:
        raise ValueError(f"unknown sampler {backend!r} (one of {SAMPLER_BACKENDS})")


class IndexEpisodeSampler:
    def __init__(self, sizes, n: int, k: int, q: int, batch_size: int = 1, na_rate: int = 0,
                 seed: int = 0):
        sizes = [int(s) for s in sizes]
        check_episode_feasibility(sizes, n, k, q, na_rate)
        self.sizes = sizes
        self.n, self.k, self.q = n, k, q
        self.batch_size, self.na_rate = batch_size, na_rate
        self.rng = np.random.default_rng(seed)
        self.offsets = np.cumsum([0] + sizes[:-1])

    def _sample_episode(self):
        """One episode of global row indices: ([N, K], [TQ], [TQ]) int32."""
        n, k, q = self.n, self.k, self.q
        rng = self.rng
        rel_ids = rng.choice(len(self.sizes), n, replace=False)
        sup, qry, labels = [], [], []
        for cls, rid in enumerate(rel_ids):
            idx = rng.choice(self.sizes[rid], k + q, replace=False) + self.offsets[rid]
            sup.append(idx[:k])
            qry.append(idx[k:])
            labels.extend([cls] * q)
        if self.na_rate > 0:
            outside = np.setdiff1d(np.arange(len(self.sizes)), rel_ids)
            for _ in range(self.na_rate * q):
                rid = int(rng.choice(outside))
                row = int(rng.integers(self.sizes[rid]))
                qry.append(np.asarray([row + self.offsets[rid]]))
                labels.append(n)
        support = np.stack(sup).astype(np.int32)
        query = np.concatenate(qry).astype(np.int32)
        label = np.asarray(labels, dtype=np.int32)
        perm = rng.permutation(label.shape[0])
        return support, query[perm], label[perm]

    @property
    def total_q(self) -> int:
        return (self.n + self.na_rate) * self.q

    def sample_batch(self) -> IndexEpisodeBatch:
        eps = [self._sample_episode() for _ in range(self.batch_size)]
        return IndexEpisodeBatch(np.stack([e[0] for e in eps]), np.stack([e[1] for e in eps]),
                                 np.stack([e[2] for e in eps]))

    def sample_fused(self, s: int):
        """S stacked batches: (sup [S,B,N,K], qry [S,B,TQ], label [S,B,TQ])."""
        batches = [self.sample_batch() for _ in range(s)]
        return tuple(np.stack([b[f] for b in batches]) for f in range(3))

    def __iter__(self) -> Iterator[IndexEpisodeBatch]:
        while True:
            yield self.sample_batch()

    def feed_state(self) -> dict:
        """The cursor protocol (datapipe/cursor.py): the generator's state."""
        return rng_feed_state(self.rng)

    def restore_feed_state(self, state: dict) -> None:
        restore_rng_feed_state(self.rng, state)
