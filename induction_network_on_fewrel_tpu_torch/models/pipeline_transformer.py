"""Layer-stacked transformer encoder, the single-card path (the JAX package's pp=1).

Counterpart of ``induction_network_on_fewrel_tpu/models/pipeline_transformer.py``
(``block_apply``, ``sequential_blocks``, ``PipelinedTransformerEncoder``
with ``pipeline_impl=None``): the math of ``models/transformer.py``
(pre-LN blocks, learned positions, masked-mean pooling) with every
per-layer parameter stacked along a leading layer axis ``[NL, ...]``
(``stack_*`` leaves) instead of living in per-layer modules. That layout
is what lets the JAX package shard the layer axis over a ``pp`` mesh axis;
on one card the executor is a loop over the layer axis, the JAX scan.

JAX's op order where it differs from ``models/transformer.py``: its own
``_layer_norm`` (f32 statistics, the two-pass variance, epsilon 1e-6,
the result in the input's dtype), each projection a product and then a
bias add in the compute dtype, scores divided by sqrt(head dim), masked
keys set to -1e30 in the compute dtype, the softmax in f32, and flax's
tanh-approximated GELU.

Fresh weights: ``in_proj`` a flax Dense (truncated lecun normal),
``pos_embedding`` ``normal(0.02)``, the stacked kernels an UNtruncated
``normal(1/sqrt(fan_in))`` (the JAX ``pipeline_transformer.py:112-117``),
the stacked LayerNorm scales ones and every bias zeros; ``final_ln_scale``
ones, ``final_ln_bias`` zeros. Leaf names are the JAX ones.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from induction_network_on_fewrel_tpu_torch.models.embedding import normal_param
from induction_network_on_fewrel_tpu_torch.models.layers import Dense
from induction_network_on_fewrel_tpu_torch.ops.core import masked_mean

_NEG = -1e30
# (name, shape of one layer as a function of (d, f), fan-in or None for a
# constant, the constant), in the JAX creation order.
STACK = (
    ("ln1_scale", lambda d, f: (d,), None, 1.0),
    ("ln1_bias", lambda d, f: (d,), None, 0.0),
    ("qkv_w", lambda d, f: (d, 3 * d), "d", None),
    ("qkv_b", lambda d, f: (3 * d,), None, 0.0),
    ("att_out_w", lambda d, f: (d, d), "d", None),
    ("att_out_b", lambda d, f: (d,), None, 0.0),
    ("ln2_scale", lambda d, f: (d,), None, 1.0),
    ("ln2_bias", lambda d, f: (d,), None, 0.0),
    ("mlp_up_w", lambda d, f: (d, f), "d", None),
    ("mlp_up_b", lambda d, f: (f,), None, 0.0),
    ("mlp_down_w", lambda d, f: (f, d), "f", None),
    ("mlp_down_b", lambda d, f: (d,), None, 0.0),
)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """The JAX ``_layer_norm``: f32 mean and two-pass variance, the result
    in x's dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def block_apply(layer: dict, x: torch.Tensor, mask: torch.Tensor,
                num_heads: int) -> torch.Tensor:
    """One pre-LN block with one layer's slice of the stack. x: [M, L, d];
    mask: [M, L]."""
    M, L, d = x.shape
    H = num_heads
    hd = d // H
    cd = x.dtype

    h = layer_norm(x, layer["ln1_scale"], layer["ln1_bias"])
    qkv = h @ layer["qkv_w"].to(cd) + layer["qkv_b"].to(cd)
    q, k, v = (t.reshape(M, L, H, hd).transpose(1, 2) for t in qkv.split(d, dim=-1))
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
    s = torch.where(mask[:, None, None, :] > 0, s, torch.full_like(s, _NEG))
    p = torch.softmax(s.float(), dim=-1).to(cd)
    out = torch.matmul(p, v).transpose(1, 2).reshape(M, L, d)
    x = x + out @ layer["att_out_w"].to(cd) + layer["att_out_b"].to(cd)

    h = layer_norm(x, layer["ln2_scale"], layer["ln2_bias"])
    h = F.gelu(h @ layer["mlp_up_w"].to(cd) + layer["mlp_up_b"].to(cd), approximate="tanh")
    return x + h @ layer["mlp_down_w"].to(cd) + layer["mlp_down_b"].to(cd)


class PipelinedTransformerEncoder(nn.Module):
    """[M, L, D] embedded tokens + [M, L] mask -> [M, d_model] sentence vectors."""

    def __init__(self, input_dim: int, num_layers: int = 4, d_model: int = 256,
                 num_heads: int = 4, d_ff: int = 1024, max_length: int = 40,
                 compute_dtype: torch.dtype = torch.float32, *, device,
                 generator: torch.Generator):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"tfm_model {d_model} is not a multiple of tfm_heads {num_heads}")
        self.num_layers, self.d_model, self.num_heads = num_layers, d_model, num_heads
        self.compute_dtype = compute_dtype
        self.in_proj = Dense(input_dim, d_model, compute_dtype, device=device,
                             generator=generator)
        self.pos_embedding = normal_param(generator, (max_length, d_model), 0.02, device)
        fans = {"d": d_model, "f": d_ff}
        for name, shape_of, fan, value in STACK:
            shape = (num_layers,) + shape_of(d_model, d_ff)
            if fan is None:
                leaf = nn.Parameter(torch.full(shape, value, device=device))
            else:
                leaf = normal_param(generator, shape, 1.0 / math.sqrt(fans[fan]), device)
            self.register_parameter(f"stack_{name}", leaf)
        self.final_ln_scale = nn.Parameter(torch.ones(d_model, device=device))
        self.final_ln_bias = nn.Parameter(torch.zeros(d_model, device=device))

    def forward(self, emb: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """emb [M, L, D], mask [M, L] -> [M, d_model]."""
        L = emb.shape[1]
        cd = self.compute_dtype
        x = self.in_proj(emb) + self.pos_embedding[None, :L].to(cd)
        for i in range(self.num_layers):          # the JAX scan over the layer axis
            layer = {name: getattr(self, f"stack_{name}")[i] for name, *_ in STACK}
            x = block_apply(layer, x, mask, self.num_heads)
        x = layer_norm(x, self.final_ln_scale, self.final_ln_bias)
        return masked_mean(x, mask[..., None], dim=-2).to(cd)

    @property
    def output_dim(self) -> int:
        return self.d_model
