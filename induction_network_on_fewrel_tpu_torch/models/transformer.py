"""Transformer sentence encoder, the single-device path.

Counterpart of ``induction_network_on_fewrel_tpu/models/transformer.py``
(``TransformerEncoder`` with ``attn_impl=None``): an input
projection plus a learned position embedding (``normal(0.02)``, not
truncated), pre-LN blocks (LayerNorm, fused qkv projection, dense masked
attention, output projection, residual; LayerNorm, tanh-approximated GELU
MLP, residual), a final LayerNorm and a masked mean over the valid tokens.
Batch-major [M, L, D] in, [M, d_model] out, in the compute dtype with f32
parameters. flax's defaults where torch's differ: LayerNorm epsilon 1e-6
with f32 statistics (``models/layers.LayerNorm``), ``nn.gelu``'s tanh
approximation, and attention masked with -1e30 in the compute dtype with
its softmax in f32 (``dense_attention``).

With ``num_experts > 0`` every ``moe_every``-th block (block i with
(i+1) % moe_every == 0) has the routed expert FFN ``moe_{i}``
(``models/moe.MoeFfn``, fed the sentence mask) in place of its dense MLP,
as the JAX encoder at ep=1. The layer-stacked layout is
``models/pipeline_transformer.py``. On an sp axis (``seq``, a
``parallel/ring.SequenceShard``: the JAX ``attn_impl`` of a ring) the
encoder gets the rank's token columns, takes the position rows of their
offset, attends over the ring and pools over every rank's tokens.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from induction_network_on_fewrel_tpu_torch.models.embedding import normal_param
from induction_network_on_fewrel_tpu_torch.models.layers import Dense, LayerNorm
from induction_network_on_fewrel_tpu_torch.models.moe import MoeFfn
from induction_network_on_fewrel_tpu_torch.ops.core import masked_mean
from induction_network_on_fewrel_tpu_torch.parallel.ring import dense_attention


class TransformerEncoder(nn.Module):
    def __init__(self, input_dim: int, num_layers: int = 4, d_model: int = 256,
                 num_heads: int = 4, d_ff: int = 1024, max_length: int = 40,
                 compute_dtype: torch.dtype = torch.float32, num_experts: int = 0,
                 moe_top_k: int = 2, moe_capacity: float = 2.0, moe_every: int = 2,
                 moe_group_size: int = 512, *, device, generator: torch.Generator):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"tfm_model {d_model} is not a multiple of tfm_heads {num_heads}")
        self.num_layers, self.d_model, self.num_heads = num_layers, d_model, num_heads
        self.compute_dtype = cd = compute_dtype
        kw = dict(device=device, generator=generator)
        self.pos_embedding = normal_param(generator, (max_length, d_model), 0.02, device)
        self.in_proj = Dense(input_dim, d_model, cd, **kw)
        self.moe_blocks = frozenset(i for i in range(num_layers)
                                    if num_experts > 0 and (i + 1) % moe_every == 0)
        for i in range(num_layers):
            self.add_module(f"ln_att_{i}", LayerNorm(d_model, cd, device=device))
            self.add_module(f"qkv_{i}", Dense(d_model, 3 * d_model, cd, **kw))
            self.add_module(f"att_out_{i}", Dense(d_model, d_model, cd, **kw))
            self.add_module(f"ln_mlp_{i}", LayerNorm(d_model, cd, device=device))
            if i in self.moe_blocks:
                self.add_module(f"moe_{i}", MoeFfn(
                    d_model, num_experts, d_ff, moe_top_k, moe_capacity, moe_group_size, cd,
                    **kw))
            else:
                self.add_module(f"intermediate_{i}", Dense(d_model, d_ff, cd, **kw))
                self.add_module(f"mlp_out_{i}", Dense(d_ff, d_model, cd, **kw))
        self.ln_final = LayerNorm(d_model, cd, device=device)
        self.seq = None         # parallel/ring.attach_sequence

    def forward(self, emb: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """emb [M, L, D], mask [M, L] -> [M, d_model] (on an sp axis: this
        rank's L/sp token columns in, the whole sequence's mean out)."""
        M, L, _ = emb.shape
        cd, d, H = self.compute_dtype, self.d_model, self.num_heads
        layer = self.get_submodule
        seq = self.seq
        off = 0 if seq is None else seq.offset
        attn = dense_attention if seq is None else seq.attention
        x = self.in_proj(emb) + self.pos_embedding[None, off:off + L].to(cd)

        def split(t):
            return t.reshape(M, L, H, d // H).transpose(1, 2)

        for i in range(self.num_layers):
            q, k, v = layer(f"qkv_{i}")(layer(f"ln_att_{i}")(x)).split(d, dim=-1)
            out = attn(split(q), split(k), split(v), mask)
            x = x + layer(f"att_out_{i}")(out.transpose(1, 2).reshape(M, L, d))
            h = layer(f"ln_mlp_{i}")(x)
            if i in self.moe_blocks:
                # The mask keeps pads out of the experts' capacity slots.
                x = x + layer(f"moe_{i}")(h, mask)
                continue
            h = layer(f"intermediate_{i}")(h)
            x = x + layer(f"mlp_out_{i}")(F.gelu(h, approximate="tanh"))
        x = self.ln_final(x)
        if seq is not None:
            return seq.pool(x, mask).to(cd)
        return masked_mean(x, mask[..., None], dim=-2).to(cd)

    @property
    def output_dim(self) -> int:
        return self.d_model
