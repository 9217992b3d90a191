"""Siamese network: a learned pairwise metric over query/support pairs.

Counterpart of ``induction_network_on_fewrel_tpu/models/siamese.py``
(``SiameseNetwork``). A query's score against one support instance is
``s(q, e) = -Σ w (q - e)² + Σ v q e + b`` and a class logit is the mean of
its K pair scores, in ``head_dtype``. Both terms are expanded over the
hidden axis (``(2w + v)·q·e - w·q² - w·e²``), so nothing bigger than
[B, TQ, N·K] is built. Parameters: ``metric_w [H]`` (ones), ``metric_v
[H]`` and the scalar ``metric_b`` (zeros).
"""

from __future__ import annotations

import torch
from torch import nn

from induction_network_on_fewrel_tpu_torch.models.base import FewShotModel


class SiameseNetwork(FewShotModel):
    def __init__(self, embedding, encoder, nota: bool = False, nota_head: str = "scalar",
                 head_dtype: torch.dtype = torch.float32, *, device):
        super().__init__(embedding, encoder, nota, nota_head, head_dtype, device)
        H = encoder.output_dim
        self.metric_w = nn.Parameter(torch.ones(H, device=device))
        self.metric_v = nn.Parameter(torch.zeros(H, device=device))
        self.metric_b = nn.Parameter(torch.zeros((), device=device))

    def forward(self, support: dict, query: dict) -> torch.Tensor:
        sup_enc, qry_enc = self.encode_episode(support, query)
        B, N, K, H = sup_enc.shape
        dt = self.head_dtype
        w, v, b = self.metric_w.to(dt), self.metric_v.to(dt), self.metric_b.to(dt)
        q = qry_enc.to(dt)                                        # [B, TQ, H]
        e = sup_enc.to(dt).reshape(B, N * K, H)                   # [B, NK, H]
        cross = torch.einsum("bqh,bsh->bqs", q * (2.0 * w + v), e)
        q2 = torch.einsum("bqh,h->bq", q * q, w)
        e2 = torch.einsum("bsh,h->bs", e * e, w)
        pair = cross - q2[..., None] - e2[:, None, :] + b         # [B, TQ, NK]
        logits = pair.reshape(B, -1, N, K).mean(dim=-1)
        return self.append_nota(logits).float()
