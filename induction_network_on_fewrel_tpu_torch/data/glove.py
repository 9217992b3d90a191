"""GloVe vocabulary: word -> row id, plus the [V, word_dim] vectors.

A copy of ``GloveVocab`` from ``induction_network_on_fewrel_tpu/data/glove.py``:
two extra rows are appended for ``[UNK]`` and ``[BLANK]`` (pad), matching
the "+2 rows" convention in SURVEY.md §2.1 "Embedding"; ``load_glove``,
a copy of the JAX function, reads the real files (a word2id JSON + .npy
matrix, a combined JSON, or the stock ``glove.6B.50d.txt`` text format).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

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


def load_glove(path: str | Path, mat_path: str | Path | None = None) -> GloveVocab:
    """Load GloVe from a word2id JSON + .npy matrix, a combined JSON, or the
    stock ``glove.6B.50d.txt`` format ("word v1 ... v50" per line)."""
    path = Path(path)
    if path.suffix == ".txt":
        # Tokens may themselves contain spaces (glove.840B.300d has entries
        # like ". . ."), so the vector dim is detected once from the first
        # line's maximal float suffix, then every line is split from the
        # right: word = everything before the last ``dim`` fields.
        words, rows, dim = [], [], None
        with open(path, encoding="utf-8") as f:
            for lineno, line in enumerate(f, 1):
                parts = line.rstrip("\n").split(" ")
                if len(parts) < 2:
                    continue
                if dim is None:
                    dim = 0
                    for p in reversed(parts[1:]):
                        try:
                            float(p)
                        except ValueError:
                            break
                        dim += 1
                    if dim == 0:
                        raise ValueError(
                            f"{path}:{lineno}: no numeric vector fields"
                        )
                try:
                    rows.append(np.asarray(parts[-dim:], dtype=np.float32))
                except ValueError as e:
                    raise ValueError(
                        f"{path}:{lineno}: expected {dim} floats at line "
                        f"end: {e}"
                    ) from e
                words.append(" ".join(parts[:-dim]))
        if not words:
            raise ValueError(f"{path}: no GloVe vectors found")
        return GloveVocab.from_words(words, np.stack(rows))
    with open(path) as f:
        raw = json.load(f)
    if isinstance(raw, dict):  # word2id json + separate matrix
        if mat_path is None:
            if "word2id.json" not in path.name:
                raise ValueError(
                    f"{path.name!r} is a word2id dict but mat_path was not given "
                    "and the filename does not follow the '*word2id.json' -> "
                    "'*mat.npy' convention"
                )
            mat_path = path.with_name(path.name.replace("word2id.json", "mat.npy"))
        mat = np.load(mat_path)
        words = [w for w, _ in sorted(raw.items(), key=lambda kv: kv[1])]
        return GloveVocab.from_words(words, mat)
    # combined [{"word": ..., "vec": [...]}] json
    words = [e["word"] for e in raw]
    mat = np.asarray([e["vec"] for e in raw], dtype=np.float32)
    return GloveVocab.from_words(words, mat)
