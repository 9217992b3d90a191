"""Hybrid-attention prototypical network (Gao et al., AAAI 2019).

Counterpart of ``induction_network_on_fewrel_tpu/models/proto_hatt.py``
(``ProtoHATT``):

* feature-level attention: three convolutions over the K support
  encodings of a class, ``Conv_0`` (32 filters) and ``Conv_1`` (64), each
  ``(k, 1)`` with flax's asymmetric padding ``((k-1)//2, k//2)`` on the K
  axis and ReLU, then ``Conv_2`` (1 filter, ``(k, 1)``, stride ``(k, 1)``,
  no padding); the per-dimension weights are ``1 + relu(.)``;
* instance-level attention: a shared ``Dense_0`` g, scores
  ``Σ_h tanh(g(e_nk)) g(q)``, a softmax over K in f32, and a
  query-conditioned prototype per class;
* logits ``-Σ_h z_nh (p_nh - q_h)²`` in ``head_dtype``.

flax runs the convolutions NHWC on [B·N, K, H, 1]; here they run NCHW on
[B·N, 1, K, H], with the kernels ``[kh, kw, Cin, Cout]`` as ``[Cout, Cin,
kh, kw]`` (``interop.py``). ``k`` is the configured K-shot: the kernels
are K tall, so it rides in a checkpoint's geometry (``config.py``).
"""

from __future__ import annotations

import torch

from induction_network_on_fewrel_tpu_torch.models.base import FewShotModel
from induction_network_on_fewrel_tpu_torch.models.layers import Conv, Dense


class ProtoHATT(FewShotModel):
    def __init__(self, embedding, encoder, k: int = 5, nota: bool = False,
                 nota_head: str = "scalar", compute_dtype: torch.dtype = torch.float32,
                 head_dtype: torch.dtype = torch.float32, *, device,
                 generator: torch.Generator):
        super().__init__(embedding, encoder, nota, nota_head, head_dtype, device)
        H, cd = encoder.output_dim, compute_dtype
        kw = dict(device=device, generator=generator)
        pad = (((k - 1) // 2, k // 2), (0, 0))
        self.Conv_0 = Conv(1, 32, (k, 1), cd, padding=pad, **kw)
        self.Conv_1 = Conv(32, 64, (k, 1), cd, padding=pad, **kw)
        self.Conv_2 = Conv(64, 1, (k, 1), cd, stride=(k, 1), **kw)
        self.Dense_0 = Dense(H, H, cd, **kw)
        self.compute_dtype = cd

    def forward(self, support: dict, query: dict) -> torch.Tensor:
        sup_enc, qry_enc = self.encode_episode(support, query)
        B, N, K, H = sup_enc.shape
        cd, hd = self.compute_dtype, self.head_dtype
        sup_enc, qry_enc = sup_enc.to(cd), qry_enc.to(cd)

        x = sup_enc.reshape(B * N, 1, K, H)
        x = torch.relu(self.Conv_0(x))
        x = torch.relu(self.Conv_1(x))
        x = self.Conv_2(x)                                        # [B*N, 1, 1, H]
        fea_att = (1.0 + torch.relu(x[:, 0, 0, :])).reshape(B, N, H)

        sup_g = torch.tanh(self.Dense_0(sup_enc))                 # [B, N, K, H]
        qry_g = self.Dense_0(qry_enc)                             # [B, TQ, H]
        score = torch.einsum("bnkh,bth->btnk", sup_g, qry_g)
        alpha = torch.softmax(score.float(), dim=-1).to(cd)
        proto = torch.einsum("btnk,bnkh->btnh", alpha, sup_enc)  # [B, TQ, N, H]

        diff = proto.to(hd) - qry_enc.to(hd)[:, :, None, :]
        logits = -torch.einsum("btnh,bnh->btn", diff * diff, fea_att.to(hd))
        return self.append_nota(logits.float()).float()
