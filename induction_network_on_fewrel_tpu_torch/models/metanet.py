"""Meta Networks (Munkhdalai & Yu, ICML 2017).

Counterpart of ``induction_network_on_fewrel_tpu/models/metanet.py``
(``MetaNet``), all in f32:

1. slow path: ``s_q = e_q @ w_slow`` (``w_slow [H, N]``, lecun normal);
2. the closed-form descent direction of CE(e @ w_slow, y) for each support
   instance, ``G_ij = e_ij ⊗ (onehot(y_ij) - softmax(e_ij @ w_slow))``
   [B, N, K, H, N] (no autograd inside the forward);
3. fast weights ``F = a2·tanh(a1·G + b1) + b2`` (``meta_a* = 1``,
   ``meta_b* = 0``, one scalar each);
4. memory read: ``α = softmax cos(e_q, e_ij)`` over the N·K supports,
   ``W_fast(q) = Σ α F``;
5. logits ``s_q + e_q @ W_fast(q)``.

``w_slow`` is N wide, so N rides in a checkpoint's geometry.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from induction_network_on_fewrel_tpu_torch.models.base import FewShotModel
from induction_network_on_fewrel_tpu_torch.models.embedding import truncated_normal_param


class MetaNet(FewShotModel):
    def __init__(self, embedding, encoder, n: int, nota: bool = False,
                 nota_head: str = "scalar", head_dtype: torch.dtype = torch.float32, *,
                 device, generator: torch.Generator):
        super().__init__(embedding, encoder, nota, nota_head, head_dtype, device)
        H = encoder.output_dim
        self.w_slow = truncated_normal_param(generator, (H, n), 1.0 / math.sqrt(H), device)
        self.meta_a1 = nn.Parameter(torch.ones(1, device=device))
        self.meta_b1 = nn.Parameter(torch.zeros(1, device=device))
        self.meta_a2 = nn.Parameter(torch.ones(1, device=device))
        self.meta_b2 = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, support: dict, query: dict) -> torch.Tensor:
        sup_enc, qry_enc = self.encode_episode(support, query)
        B, N, K, H = sup_enc.shape
        sup, qry = sup_enc.float(), qry_enc.float()

        p = torch.softmax(torch.einsum("bnkh,hm->bnkm", sup, self.w_slow), dim=-1)
        y = torch.eye(N, device=sup.device)[None, :, None, :]
        G = torch.einsum("bnkh,bnkm->bnkhm", sup, y - p)          # [B, N, K, H, N]
        F = self.meta_a2 * torch.tanh(self.meta_a1 * G + self.meta_b1) + self.meta_b2

        def unit(x):
            return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)

        keys = sup.reshape(B, N * K, H)
        att = torch.softmax(torch.einsum("bth,bsh->bts", unit(qry), unit(keys)), dim=-1)
        w_fast = torch.einsum("bts,bshm->bthm", att, F.reshape(B, N * K, H, N))
        logits = (torch.einsum("bth,hm->btm", qry, self.w_slow)
                  + torch.einsum("bth,bthm->btm", qry, w_fast))
        return self.append_nota(logits).float()
