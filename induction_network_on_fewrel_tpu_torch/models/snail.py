"""SNAIL meta-learner (Mishra et al., ICLR 2018).

Counterpart of ``induction_network_on_fewrel_tpu/models/snail.py``
(``SNAIL``, ``_CausalConvBlock``, ``_TCBlock``, ``_AttentionBlock``). Each
query's episode is one sequence of T = N·K + 1 steps: the N·K supports
(encoding ⧺ one-hot label), then the query (encoding ⧺ zeros). Attention
``att_1`` (keys 64, values 32), TC block ``tc_1``, ``att_2`` (256, 128),
``tc_2``, ``att_3`` (512, 256), each concatenating its output onto the
features; ``out`` reads the N logits off the last (query) step. A TC block
is ⌈log₂ T⌉ gated causal convolutions ``cc_<i>`` (``tanh(filter) *
sigmoid(gate)``, window 2, dilation 2^i, the sequence left-padded by the
dilation); an attention block is single-head and causal, its scores in
the compute dtype, masked with -1e9 and softmaxed in f32. All B·TQ
sequences run as one batch in the compute dtype.

The number of convolutions in a TC block follows T, so the model is built
for the configured N and K (T = n·k + 1); another T with another count is
refused by name. The causal mask is made on the device at the first
forward of each T and kept (``_causal``), so a CUDA graph's warm-up makes
it and the capture only reads it.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from induction_network_on_fewrel_tpu_torch.models.base import FewShotModel
from induction_network_on_fewrel_tpu_torch.models.layers import Conv, Dense


def tc_depth(T: int) -> int:
    """Causal convolutions in a TC block over T steps (JAX snail.py:64)."""
    return max(1, math.ceil(math.log2(T)))


class _CausalConvBlock(nn.Module):
    """Channel-first [G, F, T] -> [G, F + filters, T]."""

    def __init__(self, in_ch: int, filters: int, dilation: int, dtype: torch.dtype, **kw):
        super().__init__()
        conv = dict(padding=((dilation, 0),), dilation=(dilation,), **kw)
        self.filter = Conv(in_ch, filters, (2,), dtype, **conv)
        self.gate = Conv(in_ch, filters, (2,), dtype, **conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, torch.tanh(self.filter(x)) * torch.sigmoid(self.gate(x))], dim=1)


class _TCBlock(nn.Module):
    def __init__(self, in_ch: int, seq_len: int, filters: int, dtype: torch.dtype, **kw):
        super().__init__()
        self.depth = tc_depth(seq_len)
        for i in range(self.depth):
            self.add_module(f"cc_{i}", _CausalConvBlock(in_ch + i * filters, filters, 2 ** i,
                                                        dtype, **kw))
        self.out_dim = in_ch + self.depth * filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[G, T, F] -> [G, T, F + depth * filters]."""
        x = x.transpose(1, 2)
        for i in range(self.depth):
            x = self.get_submodule(f"cc_{i}")(x)
        return x.transpose(1, 2)


class _AttentionBlock(nn.Module):
    def __init__(self, in_dim: int, key_dim: int, value_dim: int, dtype: torch.dtype, **kw):
        super().__init__()
        self.q = Dense(in_dim, key_dim, dtype, **kw)
        self.k = Dense(in_dim, key_dim, dtype, **kw)
        self.v = Dense(in_dim, value_dim, dtype, **kw)
        self.key_dim, self.dtype = key_dim, dtype
        self.out_dim = in_dim + value_dim

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        """[G, T, F] -> [G, T, F + value_dim]."""
        scores = torch.matmul(self.q(x), self.k(x).transpose(1, 2)) / math.sqrt(self.key_dim)
        scores = torch.where(causal, scores.float(), -1e9)
        att = torch.softmax(scores, dim=-1).to(self.dtype)
        return torch.cat([x, torch.matmul(att, self.v(x))], dim=-1)


class SNAIL(FewShotModel):
    def __init__(self, embedding, encoder, n: int, k: int, tc_filters: int = 128,
                 nota: bool = False, nota_head: str = "scalar",
                 compute_dtype: torch.dtype = torch.float32,
                 head_dtype: torch.dtype = torch.float32, *, device,
                 generator: torch.Generator):
        super().__init__(embedding, encoder, nota, nota_head, head_dtype, device)
        cd, T = compute_dtype, n * k + 1
        kw = dict(device=device, generator=generator)
        self.att_1 = _AttentionBlock(encoder.output_dim + n, 64, 32, cd, **kw)
        self.tc_1 = _TCBlock(self.att_1.out_dim, T, tc_filters, cd, **kw)
        self.att_2 = _AttentionBlock(self.tc_1.out_dim, 256, 128, cd, **kw)
        self.tc_2 = _TCBlock(self.att_2.out_dim, T, tc_filters, cd, **kw)
        self.att_3 = _AttentionBlock(self.tc_2.out_dim, 512, 256, cd, **kw)
        self.out = Dense(self.att_3.out_dim, n, cd, **kw)
        self.compute_dtype = cd
        self._masks: dict = {}

    def _causal(self, T: int, device) -> torch.Tensor:
        if (T, device) not in self._masks:
            with torch.inference_mode(False):     # a tensor autograd may save
                self._masks[(T, device)] = torch.ones(
                    (T, T), dtype=torch.bool, device=device).tril()
        return self._masks[(T, device)]

    def forward(self, support: dict, query: dict) -> torch.Tensor:
        sup_enc, qry_enc = self.encode_episode(support, query)
        B, N, K, H = sup_enc.shape
        TQ = qry_enc.shape[1]
        cd, T = self.compute_dtype, N * K + 1
        if tc_depth(T) != self.tc_1.depth:
            raise ValueError(f"snail was built for {self.tc_1.depth} causal convolutions a TC "
                             f"block; an episode of N={N}, K={K} (T={T}) needs {tc_depth(T)}")
        eye = torch.eye(N, dtype=cd, device=sup_enc.device)
        sup_seq = torch.cat([sup_enc.to(cd), eye[None, :, None, :].expand(B, N, K, N)], -1)
        sup_seq = sup_seq.reshape(B, 1, N * K, H + N).expand(B, TQ, N * K, H + N)
        qry_tok = torch.cat([qry_enc.to(cd)[:, :, None, :],
                             torch.zeros((B, TQ, 1, N), dtype=cd, device=qry_enc.device)], -1)
        x = torch.cat([sup_seq, qry_tok], dim=2).reshape(B * TQ, T, H + N)

        causal = self._causal(T, x.device)
        x = self.tc_1(self.att_1(x, causal))
        x = self.tc_2(self.att_2(x, causal))
        x = self.att_3(x, causal)
        logits = self.out(x[:, -1, :]).reshape(B, TQ, N)
        return self.append_nota(logits.float()).float()
