"""BERT-path tokenizer: WordPiece + entity markers.

A copy of ``induction_network_on_fewrel_tpu/data/bert_tokenizer.py`` (the
same ids for the same instance, bitwise; pinned in
tests/test_torch_bert.py), with each whole token's ids memoized. It emits the GloVe tokenizer's
``TokenizedInstance`` contract, so the episode samplers (numpy and C++)
take either. Entity positions travel in-band: ``[E1]``/``[E2]`` marker
tokens (ids 1/2, BERT's [unused0]/[unused1]) go before the head/tail
mention, and ``models/bert.BertEncoder`` pools the hidden states at those
markers. pos1/pos2 are zeros (the BERT path has no offset embeddings).

Two modes:
* ``vocab_path`` given -> greedy longest-match-first WordPiece over a
  bert-base-uncased ``vocab.txt`` (``##`` continuations); ``vocab_size``
  becomes the file's line count.
* no vocab -> a deterministic hash fallback: each whole token maps by
  FNV-1a into ids [16, vocab_size), so training and serving run end to end
  with a random-init BERT.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from induction_network_on_fewrel_tpu_torch.data.fewrel import Instance
from induction_network_on_fewrel_tpu_torch.data.tokenizer import TokenizedInstance

PAD_ID = 0
E1_ID = 1   # [unused0]
E2_ID = 2   # [unused1]
_FALLBACK_CLS, _FALLBACK_SEP, _FALLBACK_UNK = 3, 4, 5
_FALLBACK_RESERVED = 16


class BertTokenizer:
    def __init__(
        self,
        max_length: int = 128,
        vocab_path: str | Path | None = None,
        vocab_size: int = 30522,
    ):
        self.max_length = int(max_length)
        self.vocab: dict[str, int] | None = None
        self.vocab_size = vocab_size
        self._memo: dict[str, list[int]] = {}
        if vocab_path is not None:
            words = Path(vocab_path).read_text().splitlines()
            self.vocab = {w: i for i, w in enumerate(words)}
            self.vocab_size = len(words)
            self.cls_id = self.vocab.get("[CLS]", _FALLBACK_CLS)
            self.sep_id = self.vocab.get("[SEP]", _FALLBACK_SEP)
            self.unk_id = self.vocab.get("[UNK]", _FALLBACK_UNK)
        else:
            self.cls_id, self.sep_id, self.unk_id = (
                _FALLBACK_CLS, _FALLBACK_SEP, _FALLBACK_UNK,
            )

    # -- wordpiece ----------------------------------------------------------

    def _wordpiece(self, token: str) -> list[int]:
        """The ids of one whole token, memoized: a corpus repeats its words,
        and the split runs in Python per character."""
        ids = self._memo.get(token)
        if ids is None:
            ids = self._memo[token] = self._split(token)
        return ids

    def _split(self, token: str) -> list[int]:
        if self.vocab is None:
            # stable FNV-1a hash into the non-reserved id range
            h = 2166136261
            for ch in token.lower().encode():
                h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
            span = self.vocab_size - _FALLBACK_RESERVED
            return [h % span + _FALLBACK_RESERVED]
        tok, out, start = token.lower(), [], 0
        while start < len(tok):
            end, cur = len(tok), None
            while start < end:
                piece = tok[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            out.append(cur)
            start = end
        return out

    def __call__(self, inst: Instance) -> TokenizedInstance:
        L = self.max_length
        head = inst.head_pos[0] if inst.head_pos else 0
        tail = inst.tail_pos[0] if inst.tail_pos else 0

        ids = [self.cls_id]
        for i, tok in enumerate(inst.tokens):
            if i == head:
                ids.append(E1_ID)
            if i == tail:
                ids.append(E2_ID)
            ids.extend(self._wordpiece(tok))
        ids.append(self.sep_id)
        ids = ids[:L]

        word = np.full(L, PAD_ID, dtype=np.int32)
        word[: len(ids)] = ids
        mask = np.zeros(L, dtype=np.float32)
        mask[: len(ids)] = 1.0
        zeros = np.zeros(L, dtype=np.int32)
        return TokenizedInstance(word, zeros, zeros.copy(), mask)
