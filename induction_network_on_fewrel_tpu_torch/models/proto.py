"""Prototypical network (Snell et al. 2017), the toolkit's default model.

Counterpart of ``induction_network_on_fewrel_tpu/models/proto.py``
(``PrototypicalNetwork``): the prototype of a class is the mean of its K
support encodings, and a query's logit for the class is ``-‖q - p‖²``
("euclid", expanded as ``2 q·p - ‖q‖² - ‖p‖²``) or ``q·p`` ("dot"),
scored in ``head_dtype``. No parameters beyond the encoder's and NOTA's.
"""

from __future__ import annotations

import torch

from induction_network_on_fewrel_tpu_torch.models.base import FewShotModel

PROTO_METRICS = ("euclid", "dot")


class PrototypicalNetwork(FewShotModel):
    def __init__(self, embedding, encoder, metric: str = "euclid", nota: bool = False,
                 nota_head: str = "scalar", head_dtype: torch.dtype = torch.float32, *,
                 device):
        super().__init__(embedding, encoder, nota, nota_head, head_dtype, device)
        if metric not in PROTO_METRICS:
            raise ValueError(f"unknown proto metric {metric!r} (one of {PROTO_METRICS})")
        self.metric = metric

    def forward(self, support: dict, query: dict) -> torch.Tensor:
        sup_enc, qry_enc = self.encode_episode(support, query)
        qry = qry_enc.to(self.head_dtype)                         # [B, TQ, H]
        proto = sup_enc.to(self.head_dtype).mean(dim=2)           # [B, N, H]
        logits = torch.einsum("bqh,bnh->bqn", qry, proto)
        if self.metric == "euclid":
            q2 = (qry * qry).sum(-1)
            p2 = (proto * proto).sum(-1)
            logits = 2.0 * logits - q2[..., None] - p2[:, None, :]
        return self.append_nota(logits).float()
