"""Seeded episodic N-way K-shot sampler with NA/NOTA mixing.

A numpy copy of ``induction_network_on_fewrel_tpu/sampling/episodes.py``
(``EpisodeSampler``): the same draws from ``np.random.default_rng(seed)``
in the same order, so a seed gives the same batches in both packages
(pinned in tests/test_torch_train.py).

Episode semantics (FewRel): draw N distinct relations; per relation draw
K support + Q query instances without overlap; with ``na_rate > 0`` add
``na_rate * Q`` extra queries from relations outside the episode's N,
labeled N (none-of-the-above); shuffle the queries within the episode.
The dataset is tokenized once up front into per-relation array blocks.
``feed_state``/``restore_feed_state`` carry the random stream through a
checkpoint (datapipe/cursor.py).

``InstanceSampler`` (the JAX ``sampling/episodes.py:189``) draws the
unlabeled source and target instance batches of the adversarial step.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np

from induction_network_on_fewrel_tpu_torch.data.fewrel import FewRelDataset
from induction_network_on_fewrel_tpu_torch.data.tokenizer import GloveTokenizer
from induction_network_on_fewrel_tpu_torch.datapipe.cursor import (
    restore_rng_feed_state,
    rng_feed_state,
)


class EpisodeBatch(NamedTuple):
    """One batch of B episodes, all int32/float32 numpy, fixed shapes.

    support_*: [B, N, K, L]; query_*: [B, TQ, L]; label: [B, TQ]
    with TQ = N*Q + na_rate*Q.
    """

    support_word: np.ndarray
    support_pos1: np.ndarray
    support_pos2: np.ndarray
    support_mask: np.ndarray
    query_word: np.ndarray
    query_pos1: np.ndarray
    query_pos2: np.ndarray
    query_mask: np.ndarray
    label: np.ndarray


class _RelationBlock(NamedTuple):
    word: np.ndarray  # [M, L] int32
    pos1: np.ndarray
    pos2: np.ndarray
    mask: np.ndarray  # [M, L] float32


def check_episode_feasibility(sizes, n, k, q, na_rate, names=None):
    """Validate that a corpus can furnish N-way K-shot (+NOTA) episodes."""
    need = n + (1 if na_rate > 0 else 0)
    if len(sizes) < need:
        raise ValueError(
            f"need >= {need} relations for N={n} with na_rate={na_rate}, got {len(sizes)}"
        )
    for i, m in enumerate(sizes):
        if m < k + q:
            label = names[i] if names is not None else f"#{i}"
            raise ValueError(f"relation {label}: {m} instances < K+Q={k + q}")


class EpisodeSampler:
    def __init__(
        self,
        dataset: FewRelDataset,
        tokenizer: GloveTokenizer,
        n: int,
        k: int,
        q: int,
        batch_size: int = 1,
        na_rate: int = 0,
        seed: int = 0,
    ):
        check_episode_feasibility(
            [len(dataset.instances[r]) for r in dataset.rel_names],
            n, k, q, na_rate, names=dataset.rel_names,
        )
        self.n, self.k, self.q = n, k, q
        self.batch_size, self.na_rate = batch_size, na_rate
        self.rng = np.random.default_rng(seed)
        self.rel_names = dataset.rel_names
        self.blocks: list[_RelationBlock] = []
        for rel in dataset.rel_names:
            toks = [tokenizer(inst) for inst in dataset.instances[rel]]
            self.blocks.append(_RelationBlock(
                np.stack([t.word for t in toks]),
                np.stack([t.pos1 for t in toks]),
                np.stack([t.pos2 for t in toks]),
                np.stack([t.mask for t in toks]),
            ))

    @property
    def total_q(self) -> int:
        return self.n * self.q + self.na_rate * self.q

    def _sample_episode(self):
        n, k, q = self.n, self.k, self.q
        rng = self.rng
        rel_ids = rng.choice(len(self.blocks), n, replace=False)
        sup = [[], [], [], []]
        qry = [[], [], [], []]
        labels = []
        for cls, rid in enumerate(rel_ids):
            blk = self.blocks[rid]
            idx = rng.choice(blk.word.shape[0], k + q, replace=False)
            for a, field in zip(sup, blk):
                a.append(field[idx[:k]])
            for a, field in zip(qry, blk):
                a.append(field[idx[k:]])
            labels.extend([cls] * q)
        if self.na_rate > 0:
            # NOTA negatives: sample from relations outside the episode.
            outside = np.setdiff1d(np.arange(len(self.blocks)), rel_ids)
            for _ in range(self.na_rate * q):
                rid = int(rng.choice(outside))
                blk = self.blocks[rid]
                i = int(rng.integers(blk.word.shape[0]))
                for a, field in zip(qry, blk):
                    a.append(field[i:i + 1])
                labels.append(n)
        support = [np.stack(a).reshape(n, k, -1) for a in sup]
        query = [np.concatenate(a, axis=0) for a in qry]
        label = np.asarray(labels, dtype=np.int32)
        perm = rng.permutation(label.shape[0])
        return support, [a[perm] for a in query], label[perm]

    def sample_batch(self) -> EpisodeBatch:
        eps = [self._sample_episode() for _ in range(self.batch_size)]
        sup = [np.stack([e[0][f] for e in eps]) for f in range(4)]
        qry = [np.stack([e[1][f] for e in eps]) for f in range(4)]
        label = np.stack([e[2] for e in eps])
        return EpisodeBatch(*sup, *qry, label)

    def __iter__(self) -> Iterator[EpisodeBatch]:
        while True:
            yield self.sample_batch()

    def feed_state(self) -> dict:
        """The cursor protocol (datapipe/cursor.py): the generator's state."""
        return rng_feed_state(self.rng)

    def restore_feed_state(self, state: dict) -> None:
        restore_rng_feed_state(self.rng, state)


class InstanceBatch(NamedTuple):
    """A batch of M unlabeled instances (domain-adaptation side channel)."""

    word: np.ndarray  # [M, L] int32
    pos1: np.ndarray
    pos2: np.ndarray
    mask: np.ndarray  # [M, L] float32


class InstanceSampler:
    """Uniform unlabeled instance batches from a FewRel-schema dataset, a
    copy of the JAX ``InstanceSampler`` (the same ``default_rng(seed)``
    draw per batch). Feeds the FewRel 2.0 adversarial step: the dataset is
    flattened across relations, tokenized once, and each batch is
    ``batch_size`` rows drawn uniformly with replacement."""

    def __init__(self, dataset: FewRelDataset, tokenizer: GloveTokenizer, batch_size: int,
                 seed: int = 0):
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        toks = [tokenizer(inst) for rel in dataset.rel_names for inst in dataset.instances[rel]]
        self.word = np.stack([t.word for t in toks])
        self.pos1 = np.stack([t.pos1 for t in toks])
        self.pos2 = np.stack([t.pos2 for t in toks])
        self.mask = np.stack([t.mask for t in toks])

    def sample_batch(self) -> InstanceBatch:
        idx = self.rng.integers(self.word.shape[0], size=self.batch_size)
        return InstanceBatch(self.word[idx], self.pos1[idx], self.pos2[idx], self.mask[idx])

    def __iter__(self) -> Iterator[InstanceBatch]:
        while True:
            yield self.sample_batch()

    def feed_state(self) -> dict:
        return rng_feed_state(self.rng)

    def restore_feed_state(self, state: dict) -> None:
        restore_rng_feed_state(self.rng, state)
