"""Induction module (dynamic routing) + neural-tensor relation scorer + the
full InductionNetwork model.

Counterpart of ``induction_network_on_fewrel_tpu/models/induction.py``.
Math (Geng et al. 2019):

* Induction, per class i with K support vectors e_ij:
    ê_ij = squash(W_s e_ij + b_s);  b_ij = 0
    repeat ``routing_iters`` times:
        d_i = softmax(b_i);  c_i = squash(Σ_j d_ij ê_ij);  b_ij += ê_ij · c_i
* Relation (NTN): v_iq = relu(c_iᵀ M^[1:h] e_q), score r_iq = w_vᵀ v_iq + b_v.

The head runs in ``head_dtype`` (f32 on the flagship) with f32 routing and
f32 accumulation of the NTN contractions. ``class_vectors`` /
``score_queries`` split the forward at the class-vector boundary for
serving: supports are distilled once, each query batch is one encoder pass
plus the NTN score. ``score_queries`` dequantizes an int8 resident class
matrix with its f32 ``scale``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from induction_network_on_fewrel_tpu_torch.models.base import FewShotModel
from induction_network_on_fewrel_tpu_torch.models.embedding import truncated_normal_param
from induction_network_on_fewrel_tpu_torch.models.layers import Dense
from induction_network_on_fewrel_tpu_torch.ops.core import squash


class Induction(nn.Module):
    def __init__(self, in_dim: int, induction_dim: int = 100, routing_iters: int = 3,
                 dtype: torch.dtype = torch.float32, *, device, generator):
        super().__init__()
        self.dense = Dense(in_dim, induction_dim, dtype, device=device, generator=generator)
        self.routing_iters = routing_iters
        self.dtype = dtype

    def forward(self, support: torch.Tensor) -> torch.Tensor:
        """[B, N, K, D] support encodings -> [B, N, C] class vectors."""
        B, N, K, _ = support.shape
        e32 = squash(self.dense(support)).float()            # [B, N, K, C]
        b = e32.new_zeros((B, N, K))
        for _ in range(self.routing_iters):
            d = torch.softmax(b, dim=-1)
            c = squash(torch.einsum("bnk,bnkc->bnc", d, e32))
            b = b + torch.einsum("bnkc,bnc->bnk", e32, c)
        d = torch.softmax(b, dim=-1)
        c = squash(torch.einsum("bnk,bnkc->bnc", d, e32))
        return c.to(self.dtype)


class RelationNTN(nn.Module):
    def __init__(self, class_dim: int, slices: int = 100,
                 dtype: torch.dtype = torch.float32, *, device, generator):
        super().__init__()
        # flax's truncated glorot-normal with the slice axis as batch axis:
        # fan_in = fan_out = C, so std = sqrt(2 / (2C)).
        self.tensor_slices = truncated_normal_param(
            generator, (slices, class_dim, class_dim), 1.0 / math.sqrt(class_dim), device
        )
        self.dense = Dense(slices, 1, dtype, device=device, generator=generator)
        self.dtype = dtype

    def forward(self, class_vec: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
        """([B, N, C], [B, TQ, C]) -> pre-sigmoid relation logits [B, TQ, N].
        Slices are rounded to the head dtype; contractions accumulate in f32."""
        M = self.tensor_slices.to(self.dtype).float()
        cM = torch.einsum("bnc,hcd->bnhd", class_vec.float(), M)
        v = torch.relu(torch.einsum("bnhd,bqd->bqnh", cM, query.float()))
        return self.dense(v)[..., 0]


class InductionNetwork(FewShotModel):
    """encoder -> induction -> relation scoring. ``forward(support, query)``
    returns f32 logits [B, TQ, N(+1)]."""

    def __init__(self, embedding, encoder, induction_dim: int = 100,
                 routing_iters: int = 3, ntn_slices: int = 100, nota: bool = False,
                 nota_head: str = "scalar", head_dtype: torch.dtype = torch.float32,
                 *, device, generator: torch.Generator):
        super().__init__(embedding, encoder, nota, nota_head, head_dtype, device)
        H = encoder.output_dim
        self.induction = Induction(H, induction_dim, routing_iters, head_dtype,
                                   device=device, generator=generator)
        self.relation = RelationNTN(induction_dim, ntn_slices, head_dtype,
                                    device=device, generator=generator)
        self.query_proj = Dense(H, induction_dim, head_dtype,
                                device=device, generator=generator)

    def forward(self, support: dict, query: dict) -> torch.Tensor:
        sup_enc, qry_enc = self.encode_episode(support, query)
        class_vec = self.induction(sup_enc)                    # [B, N, C]
        logits = self.relation(class_vec, self.query_proj(qry_enc))
        return self.append_nota(logits).float()

    def class_vectors(self, support: dict) -> torch.Tensor:
        """[B, N, K, L] support token dict -> [B, N, C] class vectors."""
        sup_enc = self.encode(
            support["word"], support["pos1"], support["pos2"], support["mask"]
        )
        return self.induction(sup_enc)

    def score_queries(self, class_vec: torch.Tensor, query: dict,
                      scale: torch.Tensor | float | None = None) -> torch.Tensor:
        """([B, N, C] class vectors, [B, TQ, L] query dict) -> f32 logits
        [B, TQ, N(+1)]. An int8 ``class_vec`` is dequantized with its f32
        per-tenant ``scale``."""
        if scale is not None:
            class_vec = class_vec.float() * scale
        qry_enc = self.encode(
            query["word"], query["pos1"], query["pos2"], query["mask"]
        )
        logits = self.relation(class_vec.to(self.head_dtype), self.query_proj(qry_enc))
        return self.append_nota(logits).float()
