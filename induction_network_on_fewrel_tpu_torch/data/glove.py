"""GloVe vocabulary: word -> row id, plus the [V, word_dim] vectors.

A copy of ``GloveVocab`` from ``induction_network_on_fewrel_tpu/data/glove.py``:
two extra rows are appended for ``[UNK]`` and ``[BLANK]`` (pad), matching
the "+2 rows" convention in SURVEY.md §2.1 "Embedding". Loading the real
GloVe files (``load_glove``) comes with the real-GloVe slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np

UNK = "[UNK]"
BLANK = "[BLANK]"


@dataclasses.dataclass
class GloveVocab:
    word2id: dict[str, int]
    vectors: np.ndarray  # [V, word_dim] float32, rows for UNK/BLANK included

    @property
    def unk_id(self) -> int:
        return self.word2id[UNK]

    @property
    def blank_id(self) -> int:
        return self.word2id[BLANK]

    @property
    def vocab_size(self) -> int:
        return self.vectors.shape[0]

    @property
    def word_dim(self) -> int:
        return self.vectors.shape[1]

    def lookup(self, token: str) -> int:
        w2i = self.word2id
        return w2i.get(token, w2i.get(token.lower(), self.unk_id))

    @classmethod
    def from_words(cls, words: list[str], vectors: np.ndarray) -> "GloveVocab":
        """Build from plain words + their vectors, appending UNK/BLANK rows."""
        dim = vectors.shape[1]
        word2id = {w: i for i, w in enumerate(words)}
        word2id[UNK] = len(words)
        word2id[BLANK] = len(words) + 1
        rng = np.random.default_rng(0)
        extra = np.stack(
            # UNK: small random (never trained to zero); BLANK: exact zeros so
            # padding contributes nothing before masking.
            [rng.normal(0, 0.1, dim).astype(np.float32), np.zeros(dim, np.float32)]
        )
        return cls(word2id, np.concatenate([vectors.astype(np.float32), extra]))

