"""GloVe-path tokenizer: tokens -> (word ids, pos1, pos2, mask).

Mirrors the reference's ``CNNSentenceEncoder.tokenize`` contract (SURVEY.md
§2.1 "Tokenizer (GloVe path)"): lowercase lookup with ``[UNK]`` fallback and
``[BLANK]`` padding to ``max_length``; per-token signed offsets to the head
and tail entity starts, clamped to ±max_length and shifted into
``[0, 2*max_length)`` so they index an ``Embedding(2*max_length, pos_dim)``.

A copy of ``induction_network_on_fewrel_tpu/data/tokenizer.py`` (same ids
for the same instance, pinned in tests/test_torch_serving.py). Everything
is numpy on the host; output shapes are fixed by ``max_length``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from induction_network_on_fewrel_tpu_torch.data.fewrel import Instance
from induction_network_on_fewrel_tpu_torch.data.glove import GloveVocab


@dataclasses.dataclass
class TokenizedInstance:
    word: np.ndarray  # [L] int32
    pos1: np.ndarray  # [L] int32, offsets to head start, shifted non-negative
    pos2: np.ndarray  # [L] int32, offsets to tail start
    mask: np.ndarray  # [L] float32, 1 for real tokens


class GloveTokenizer:
    def __init__(self, vocab: GloveVocab, max_length: int = 40):
        self.vocab = vocab
        self.max_length = int(max_length)

    def __call__(self, inst: Instance) -> TokenizedInstance:
        L = self.max_length
        ids = np.full(L, self.vocab.blank_id, dtype=np.int32)
        n = min(len(inst.tokens), L)
        for i in range(n):
            ids[i] = self.vocab.lookup(inst.tokens[i])

        head = min(inst.head_pos[0] if inst.head_pos else 0, L - 1)
        tail = min(inst.tail_pos[0] if inst.tail_pos else 0, L - 1)
        idx = np.arange(L, dtype=np.int32)
        pos1 = np.clip(idx - head, -L, L - 1) + L
        pos2 = np.clip(idx - tail, -L, L - 1) + L

        mask = np.zeros(L, dtype=np.float32)
        mask[:n] = 1.0
        return TokenizedInstance(ids, pos1.astype(np.int32), pos2.astype(np.int32), mask)
