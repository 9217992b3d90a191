"""BERT-PAIR few-shot model (``--model pair``).

Counterpart of ``induction_network_on_fewrel_tpu/models/pair.py``
(``PairModel``), the FewRel 2.0 NOTA baseline: every (query, support) pair
is joined at the token level and scored by the BERT backbone as one
sequence; a query's logit for class i is the mean of its K match scores
against that class's supports, and the NOTA logit, when ``nota``, is one
learned threshold (zero-initialised) appended as class N.

Layout per pair: ``[CLS] query [SEP] | [CLS] support [SEP]``, two fixed-L
blocks (``data/bert_tokenizer.py``) joined along the token axis with
segment ids 0/1 and the masks as f32; pad positions stay masked. The match
head is ``Dense(1)`` on the first position's hidden state in the compute
dtype; the mean over K is taken in f32.

Cost: B·TQ·N·K sequences of 2L tokens per step, quadratic in the episode,
as the reference's BERT-PAIR.
"""

from __future__ import annotations

import torch
from torch import nn

from induction_network_on_fewrel_tpu_torch.models.bert import BertBackbone
from induction_network_on_fewrel_tpu_torch.models.layers import Dense


class PairModel(nn.Module):
    def __init__(self, vocab: int, layers: int = 12, hidden: int = 768, heads: int = 12,
                 intermediate: int = 3072, frozen: bool = False, remat: bool = False,
                 nota: bool = False, compute_dtype: torch.dtype = torch.float32, *, device,
                 generator: torch.Generator):
        super().__init__()
        self.backbone = BertBackbone(vocab, layers, hidden, heads, intermediate, remat=remat,
                                     dtype=compute_dtype, device=device, generator=generator)
        self.match_head = Dense(hidden, 1, compute_dtype, device=device, generator=generator)
        self.frozen = frozen
        self.nota = nota
        if nota:
            self.nota_logit = nn.Parameter(torch.zeros(1, device=device))

    @property
    def device(self) -> torch.device:
        return self.match_head.weight.device

    def forward(self, support: dict, query: dict) -> torch.Tensor:
        """(support [B, N, K, L] token dict, query [B, TQ, L]) -> f32 logits
        [B, TQ, N(+1)]."""
        B, N, K, L = support["word"].shape
        TQ = query["word"].shape[1]

        def pairs(qx, sx):
            q = qx[:, :, None, None].expand(B, TQ, N, K, L)
            s = sx[:, None].expand(B, TQ, N, K, L)
            return torch.cat([q, s], dim=-1).reshape(-1, 2 * L)

        ids = pairs(query["word"], support["word"])
        mask = pairs(query["mask"].float(), support["mask"].float())
        seg = torch.arange(2 * L, device=ids.device).ge(L).to(torch.int32).expand_as(ids)
        hidden = self.backbone(ids, mask, segment_ids=seg)
        if self.frozen:
            hidden = hidden.detach()
        match = self.match_head(hidden[:, 0])[..., 0]                   # [B*TQ*N*K]
        logits = match.reshape(B, TQ, N, K).float().mean(-1)
        if self.nota:
            logits = torch.cat([logits, self.nota_logit.expand(B, TQ, 1)], dim=-1)
        return logits
