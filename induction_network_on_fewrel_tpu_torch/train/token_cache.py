"""Device-resident token cache: each split tokenized once, only indices per step.

Counterpart of ``induction_network_on_fewrel_tpu/train/token_cache.py``.
The dataset a run draws its episodes from is small and static, so it is
tokenized once into one flat table per split (``tokenize_dataset``: word
int32, pos1/pos2 int16, mask int8, [M, L], rows grouped by relation) and
copied to the card once (``TokenTable``). The index sampler
(``sampling/index.py``) draws episodes of global row indices with the live
sampler's statistics, so per step only [B, N, K] and [B, TQ] int32 indices
and the labels cross to the card, and the row gather runs inside the
captured step (``train/steps.py``: the ``source`` of the step factories).
The model, its parameters and the checkpoints are those of the live path.

``_compact_pos_offsets`` collapses per-token position ids to per-sentence
offsets where that is exact (the GloVe tokenizer's ids are ``off + l``), a
rank-1 leaf the model expands back (``models/embedding.is_offset_form``).
With ``embed_optimizer="lazy"`` the table also carries ``winv``, each
token's row in the corpus's sorted distinct word ids ``uids``
(``train/lazy_embed.augment_token_table``), so the lazy step needs no
per-step dedup.
"""

from __future__ import annotations

import numpy as np
import torch

from induction_network_on_fewrel_tpu_torch.data.fewrel import FewRelDataset
from induction_network_on_fewrel_tpu_torch.models.base import QUERY_KEYS


def tokenize_dataset(dataset: FewRelDataset, tokenizer) -> tuple[dict[str, np.ndarray], list[int]]:
    """Tokenize every instance once -> (flat token table, rows per relation),
    relations in ``dataset.rel_names`` order. Wire dtypes: word int32,
    pos1/pos2 int16 (in [0, 2L)), mask int8."""
    toks, rel_sizes = [], []
    for rel in dataset.rel_names:
        insts = dataset.instances[rel]
        rel_sizes.append(len(insts))
        toks.extend(tokenizer(inst) for inst in insts)
    table = {
        "word": np.stack([t.word for t in toks]).astype(np.int32),
        "pos1": np.stack([t.pos1 for t in toks]).astype(np.int16),
        "pos2": np.stack([t.pos2 for t in toks]).astype(np.int16),
        "mask": np.stack([t.mask for t in toks]).astype(np.int8),
    }
    return _compact_pos_offsets(table), rel_sizes


def _compact_pos_offsets(table: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Per-token position ids -> per-sentence offsets where exact: a key
    becomes its rank-1 first column when ``pos[l] == pos[0] + l`` holds for
    every row (checked, never assumed); pos1 and pos2 independently."""
    L = table["pos1"].shape[-1]
    idx = np.arange(L, dtype=np.int32)
    out = dict(table)
    for key in ("pos1", "pos2"):
        pos = table[key].astype(np.int32)
        if np.array_equal(pos, pos[:, :1] + idx):
            out[key] = pos[:, 0].astype(np.int16)
    return out


class TokenTable:
    """One split's token table on ``device``: the ``QUERY_KEYS`` leaves,
    ``winv`` and the corpus ``uids`` (int32) for a lazy run, and the rows
    per relation (``sizes``) the index sampler draws from."""

    def __init__(self, arrays: dict[str, np.ndarray], sizes, device, uids=None):
        self.arrays = {k: torch.as_tensor(np.ascontiguousarray(v)).to(device)
                       for k, v in arrays.items()}
        self.sizes = list(sizes)
        self.uids = None if uids is None else torch.as_tensor(uids, dtype=torch.int32).to(device)

    @property
    def rows(self) -> int:
        return int(self.arrays["word"].shape[0])

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.arrays.values()) + (
            0 if self.uids is None else self.uids.numel() * 4)

    def gather(self, idx: torch.Tensor, compact: bool = False) -> dict[str, torch.Tensor]:
        """The token leaves of rows ``idx`` (any shape); ``compact`` takes the
        words from ``winv`` (ids into the corpus rows, the lazy step's)."""
        i = idx.long()
        out = {k: self.arrays[k][i] for k in QUERY_KEYS}
        if compact:
            out["word"] = self.arrays["winv"][i]
        return out


def build_token_table(dataset: FewRelDataset, tokenizer, device, lazy: bool = False) -> TokenTable:
    """``tokenize_dataset`` on the host, then one copy to ``device``; with
    ``lazy`` the table carries ``winv`` and ``uids``."""
    arrays, sizes = tokenize_dataset(dataset, tokenizer)
    uids = None
    if lazy:
        from induction_network_on_fewrel_tpu_torch.train.lazy_embed import augment_token_table

        arrays, uids = augment_token_table(arrays)
    return TokenTable(arrays, sizes, device, uids)
