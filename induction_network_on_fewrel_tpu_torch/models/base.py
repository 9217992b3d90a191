"""Shared base for few-shot episode models: encoder plumbing + NOTA head.

Counterpart of ``induction_network_on_fewrel_tpu/models/base.py``
(``FewShotModel``). Inputs are dicts of ``{word, pos1, pos2, mask}``
integer tensors with a trailing [L] axis; a position leaf may instead hold
per-sentence offsets, one rank below ``word`` (the token cache's form,
``models/embedding.is_offset_form``), expanded to per-token ids inside the
forward. ``encode`` flattens the
leading axes to M rows and returns sentence vectors with the leading axes
restored. For an encoder that ``wants_time_major`` (the BiLSTM) it
transposes the int ids to [L, M] before the gathers, so the embedding
lands directly in the layout that encoder reads; the CNN and the
transformer take batch-major [M, L, D] embeddings.

The NOTA head appends a none-of-the-above logit as class N: "scalar" is
one learned threshold, "stats" a learned affine over each query's class
scores (max, mean and the POPULATION std, ``correction=0``, as jnp's std).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from induction_network_on_fewrel_tpu_torch.models.embedding import expand_positions
from induction_network_on_fewrel_tpu_torch.models.moe import moe_layers, token_parts

QUERY_KEYS = ("word", "pos1", "pos2", "mask")


def to_device(batch: dict, device) -> dict[str, torch.Tensor]:
    """numpy (or torch) token leaves -> tensors on ``device``, dtypes kept."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


class FewShotModel(nn.Module):
    """Base: ``embedding`` + ``encoder`` modules and the NOTA parameters.
    Subclasses implement the episode-level math."""

    def __init__(self, embedding: nn.Module, encoder: nn.Module, nota: bool,
                 nota_head: str, head_dtype: torch.dtype, device):
        super().__init__()
        if nota_head not in ("scalar", "stats"):
            raise ValueError(f"unknown nota_head {nota_head!r} (scalar | stats)")
        self.embedding = embedding
        self.encoder = encoder
        self.nota = nota
        self.nota_head = nota_head
        self.head_dtype = head_dtype
        if nota and nota_head == "stats":
            self.nota_stats_w = nn.Parameter(torch.zeros(3, device=device))
            self.nota_stats_b = nn.Parameter(torch.zeros(1, device=device))
        elif nota:
            self.nota_logit = nn.Parameter(torch.zeros(1, device=device))

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def encode(self, word, pos1, pos2, mask) -> torch.Tensor:
        """[..., L] token features -> [..., H] sentence vectors (position
        leaves per token or per-sentence offsets)."""
        pos1, pos2 = expand_positions(pos1, word), expand_positions(pos2, word)
        lead, L = word.shape[:-1], word.shape[-1]
        ids = [x.reshape(-1, L) for x in (word, pos1, pos2)]        # [M, L]
        if getattr(self.encoder, "wants_time_major", False):
            ids = [x.transpose(0, 1) for x in ids]                 # [L, M]
        enc = self.encoder(self.embedding(*ids), mask.reshape(-1, L))
        return enc.reshape(*lead, -1)

    def encode_episode(self, support: dict, query: dict):
        """(support [B, N, K, L] dict, query [B, TQ, L] dict) ->
        ([B, N, K, H], [B, TQ, H]): ONE encoder call over support ⧺ query
        rows (the encoder is row-independent, so concat-encode-split is
        exact; MoE layers, which route groups of tokens, learn the two parts,
        ``models/moe.token_parts``, which under data parallel are two slices
        of the global order). Encoded rows (the feature cache's [B, N, K, H]
        and [B, TQ, H] tensors) pass straight through."""
        if not isinstance(support, dict):
            return support, query
        L = support["word"].shape[-1]
        if query["word"].shape[-1] != L:
            raise ValueError(
                f"support/query sequence lengths differ: {L} vs "
                f"{query['word'].shape[-1]}"
            )
        sup_lead = support["word"].shape[:-1]
        qry_lead = query["word"].shape[:-1]
        cat = {
            k: torch.cat([expand_positions(support[k], support["word"]).reshape(-1, L),
                          expand_positions(query[k], query["word"]).reshape(-1, L)])
            for k in QUERY_KEYS
        }
        ns = int(np.prod(sup_lead))
        layers = moe_layers(self.encoder)
        with token_parts(layers, (ns, int(np.prod(qry_lead)))) if layers else \
                contextlib.nullcontext():
            enc = self.encode(cat["word"], cat["pos1"], cat["pos2"], cat["mask"])
        return enc[:ns].reshape(*sup_lead, -1), enc[ns:].reshape(*qry_lead, -1)

    def append_nota(self, logits: torch.Tensor) -> torch.Tensor:
        """[B, TQ, N] -> [B, TQ, N+1] with the NOTA logit last (if enabled)."""
        if not self.nota:
            return logits
        B, TQ, _ = logits.shape
        if self.nota_head == "stats":
            lf = logits.float()
            feats = torch.stack(
                [lf.amax(-1), lf.mean(-1), lf.std(-1, correction=0)], dim=-1
            )                                                   # [B, TQ, 3]
            na = (feats @ self.nota_stats_w + self.nota_stats_b).to(logits.dtype)
            return torch.cat([logits, na[..., None]], dim=-1)
        na = self.nota_logit.to(logits.dtype).expand(B, TQ, 1)
        return torch.cat([logits, na], dim=-1)
