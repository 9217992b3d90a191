"""BERT-base sentence encoder.

Counterpart of ``induction_network_on_fewrel_tpu/models/bert.py``, one
module per JAX class, on ``models/layers.py``'s ``Dense`` and
``LayerNorm`` (parameters f32, products in the compute dtype). Its
arithmetic follows the JAX module op for op, so that the two packages
agree on the same weights:

* the fused QKV projection is one [H, 3H] Dense; the scores are the
  einsum in the compute dtype, then divided by sqrt(d) in f32 (the JAX
  divisor is a numpy scalar, which promotes a bf16 product to f32); a
  -1e30 bias where ``mask == 0``; the softmax in f32, cast back to the
  compute dtype for the einsum with v. Not ``scaled_dot_product_attention``:
  it rounds differently.
* LayerNorms use epsilon 1e-12 (``LN_EPS``, HF's ``layer_norm_eps``) with
  f32 statistics and an f32 output, so the residual stream between layers
  is f32, as flax's ``LayerNorm(dtype=float32)`` leaves it.
* GELU is the exact erf form.
* Initializers are flax's: the Dense kernels truncated lecun-normal,
  ``tok_emb`` flax ``Embed``'s default (a plain normal of std
  1/sqrt(H)), ``pos_emb`` and ``seg_emb`` ``normal(0.02)`` (not truncated).

``BertEncoder`` pools the mean of [CLS] and the hidden states at the first
masked-in ``[E1]``/``[E2]`` marker (``data/bert_tokenizer.py``), falling
back to [CLS] for an absent marker, with static shapes (argmax of the hit
mask, then a select), so the forward captures in a CUDA graph.
``frozen=True`` detaches the backbone's output: the backbone gets no loss
gradient (``grad`` stays None; the optimizer reads that as zeros, as the
JAX chain's ``stop_gradient`` gives them). ``remat=True`` runs each layer
under non-reentrant ``torch.utils.checkpoint`` (no RNG state: the model
has no dropout).

``BertEmbeddingPassthrough`` fills the few-shot models' embedding slot:
the BERT path owns its token table, so the ids pass through.
``CachedFeatures`` fills the encoder slot of a feature-cache model
(``train/feature_cache.py``), which takes encoded rows and holds the head
alone. ``load_hf_weights`` maps a flat ``.npz`` of bert-base-uncased
weights onto a backbone in place.

Parameter names are the JAX paths joined with dots (``backbone.
layer_0.attention.qkv.weight`` for ``backbone/layer_0/attention/qkv/
kernel``), which ``interop.py`` carries both ways.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from induction_network_on_fewrel_tpu_torch.models.embedding import normal_param
from induction_network_on_fewrel_tpu_torch.models.layers import Dense, LayerNorm
from induction_network_on_fewrel_tpu_torch.ops.segsum import lookup_matmul_grad

LN_EPS = 1e-12


def attention_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, L] mask -> [B, 1, 1, L] f32 additive bias: 0 where ``mask > 0``,
    -1e30 elsewhere."""
    return torch.where(mask[:, None, None, :] > 0, 0.0, -1e30)


class BertSelfAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, dtype: torch.dtype, *, device, generator):
        super().__init__()
        self.qkv = Dense(hidden, 3 * hidden, dtype, device=device, generator=generator)
        self.out = Dense(hidden, hidden, dtype, device=device, generator=generator)
        self.heads = heads
        self.dtype = dtype

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        B, L, H = x.shape
        d = H // self.heads
        q, k, v = (t.reshape(B, L, self.heads, d) for t in self.qkv(x).split(H, dim=-1))
        scores = torch.einsum("blhd,bmhd->bhlm", q, k).float() / math.sqrt(d)
        att = torch.softmax(scores + bias, dim=-1)
        out = torch.einsum("bhlm,bmhd->blhd", att.to(self.dtype), v)
        return self.out(out.reshape(B, L, H))


class BertLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, intermediate: int, dtype: torch.dtype, *,
                 device, generator):
        super().__init__()
        self.attention = BertSelfAttention(hidden, heads, dtype, device=device,
                                           generator=generator)
        self.ln_att = LayerNorm(hidden, torch.float32, LN_EPS, device=device)
        self.intermediate = Dense(hidden, intermediate, dtype, device=device,
                                  generator=generator)
        self.mlp_out = Dense(intermediate, hidden, dtype, device=device, generator=generator)
        self.ln_mlp = LayerNorm(hidden, torch.float32, LN_EPS, device=device)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = self.ln_att(x + self.attention(x, bias))
        h = self.mlp_out(F.gelu(self.intermediate(x), approximate="none"))
        return self.ln_mlp(x + h)


class Embed(nn.Module):
    """flax ``nn.Embed``: an f32 ``embedding`` table [V, H], gathered in
    f32; flax's default init, a normal of std 1/sqrt(H)."""

    def __init__(self, vocab: int, hidden: int, *, device, generator):
        super().__init__()
        self.embedding = normal_param(generator, (vocab, hidden), 1.0 / math.sqrt(hidden), device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding)


class BertBackbone(nn.Module):
    """(ids [B, L], mask [B, L], segment ids [B, L] or None) -> hidden
    states [B, L, H] (f32 after the first layer's LayerNorms)."""

    def __init__(self, vocab: int, layers: int = 12, hidden: int = 768, heads: int = 12,
                 intermediate: int = 3072, max_position: int = 512, type_vocab: int = 2,
                 remat: bool = False, dtype: torch.dtype = torch.float32, *, device, generator):
        super().__init__()
        self.tok_emb = Embed(vocab, hidden, device=device, generator=generator)
        self.pos_emb = normal_param(generator, (max_position, hidden), 0.02, device)
        self.seg_emb = normal_param(generator, (type_vocab, hidden), 0.02, device)
        self.ln_emb = LayerNorm(hidden, torch.float32, LN_EPS, device=device)
        self.num_layers = layers
        for i in range(layers):
            setattr(self, f"layer_{i}", BertLayer(hidden, heads, intermediate, dtype,
                                                  device=device, generator=generator))
        self.remat = remat
        self.dtype = dtype

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                segment_ids: torch.Tensor | None = None) -> torch.Tensor:
        L = ids.shape[1]
        word = self.tok_emb(ids)
        # Single-sentence callers are all segment 0; BERT-PAIR passes 0/1 ids,
        # whose two rows' gradient is the deterministic one-hot product (an
        # atomic scatter of thousands of terms into two rows changes its
        # rounding from run to run).
        seg = self.seg_emb[0][None, None] if segment_ids is None \
            else lookup_matmul_grad(self.seg_emb, segment_ids.long())
        x = self.ln_emb(word + self.pos_emb[:L][None] + seg).to(self.dtype)
        bias = attention_bias(mask)
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, bias, use_reentrant=False, preserve_rng_state=False)
            else:
                x = layer(x, bias)
        return x


class BertEmbeddingPassthrough(nn.Module):
    """The few-shot models' ``embedding(word, pos1, pos2)`` slot on the BERT
    path: the ids pass through (entity positions enter through the marker
    pooling, not offset embeddings)."""

    def forward(self, word, pos1, pos2):
        return word


class BertEncoder(nn.Module):
    """(ids [M, L], mask [M, L]) -> sentence vectors [M, H] in the compute
    dtype: the mean of [CLS] and the first masked-in ``[E1]`` and ``[E2]``
    hidden states (each [CLS] when its marker is absent)."""

    wants_time_major = False

    def __init__(self, vocab: int, layers: int = 12, hidden: int = 768, heads: int = 12,
                 intermediate: int = 3072, frozen: bool = True, remat: bool = False,
                 head_marker_id: int = 1, tail_marker_id: int = 2,
                 dtype: torch.dtype = torch.float32, *, device, generator):
        super().__init__()
        self.backbone = BertBackbone(vocab, layers, hidden, heads, intermediate, remat=remat,
                                     dtype=dtype, device=device, generator=generator)
        self.frozen = frozen
        self.markers = (head_marker_id, tail_marker_id)
        self.hidden = hidden
        self.dtype = dtype

    @property
    def output_dim(self) -> int:
        return self.hidden

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        hidden = self.backbone(ids, mask)
        if self.frozen:
            hidden = hidden.detach()
        cls_vec = hidden[:, 0]

        def marker_vec(marker_id: int) -> torch.Tensor:
            hit = (ids == marker_id) & (mask > 0)
            idx = hit.to(torch.int32).argmax(dim=1)               # the first hit; 0 if none
            vec = hidden.gather(1, idx[:, None, None].expand(-1, 1, hidden.shape[-1]))[:, 0]
            return torch.where(hit.any(dim=1, keepdim=True), vec, cls_vec)

        head, tail = self.markers
        pooled = (cls_vec + marker_vec(head) + marker_vec(tail)) / 3.0
        return pooled.to(self.dtype)


class CachedFeatures(nn.Module):
    """The encoder slot of a feature-cache model: no parameters; the model
    takes encoded [..., H] rows (``FewShotModel.encode_episode`` passes
    them through), never tokens."""

    wants_time_major = False

    def __init__(self, hidden: int):
        super().__init__()
        self.hidden = hidden

    @property
    def output_dim(self) -> int:
        return self.hidden

    def forward(self, ids, mask):
        raise ValueError("a feature-cache model holds the episode head alone: it takes encoded "
                         "features (train/feature_cache.py), not tokens")


def load_hf_weights(module: nn.Module, npz_path: str) -> None:
    """Copy a flat ``{hf_name: array}`` .npz of bert-base-uncased weights
    into ``module.backbone`` in place (a ``BertEncoder`` or a
    ``PairModel``); raises KeyError on a missing tensor. The mapping is the
    JAX ``load_hf_weights``'s; HF's Linear weights are [out, in] like
    torch's, so only the fused QKV is assembled (rows: query, key, value):

    bert.embeddings.word_embeddings.weight       -> backbone.tok_emb.embedding
    bert.embeddings.position_embeddings.weight   -> backbone.pos_emb
    bert.embeddings.token_type_embeddings.weight -> backbone.seg_emb
    bert.embeddings.LayerNorm.{gamma,beta}       -> backbone.ln_emb.{scale,bias}
    ...encoder.layer.N.attention.self.{q,k,v}    -> backbone.layer_N.attention.qkv (fused)
    ...attention.output.dense                    -> backbone.layer_N.attention.out
    ...attention.output.LayerNorm                -> backbone.layer_N.ln_att
    ...intermediate.dense / output.dense         -> backbone.layer_N.{intermediate,mlp_out}
    ...output.LayerNorm                          -> backbone.layer_N.ln_mlp

    LayerNorms may be named gamma/beta (TF-era exports) or weight/bias."""
    raw = dict(np.load(npz_path))

    def ln(prefix: str, which: str):
        alt = {"gamma": "weight", "beta": "bias"}[which]
        key = f"{prefix}LayerNorm.{which}"
        return raw[key] if key in raw else raw[f"{prefix}LayerNorm.{alt}"]

    pre = "bert.embeddings."
    vals = {
        "tok_emb.embedding": raw[pre + "word_embeddings.weight"],
        "pos_emb": raw[pre + "position_embeddings.weight"],
        "seg_emb": raw[pre + "token_type_embeddings.weight"],
        "ln_emb.scale": ln(pre, "gamma"), "ln_emb.bias": ln(pre, "beta"),
    }
    bb = module.backbone
    for i in range(bb.num_layers):
        lp, to = f"bert.encoder.layer.{i}.", f"layer_{i}."
        qkv = ("query", "key", "value")
        vals.update({
            to + "attention.qkv.weight": np.concatenate(
                [raw[lp + f"attention.self.{n}.weight"] for n in qkv], axis=0),
            to + "attention.qkv.bias": np.concatenate(
                [raw[lp + f"attention.self.{n}.bias"] for n in qkv]),
            to + "attention.out.weight": raw[lp + "attention.output.dense.weight"],
            to + "attention.out.bias": raw[lp + "attention.output.dense.bias"],
            to + "ln_att.scale": ln(lp + "attention.output.", "gamma"),
            to + "ln_att.bias": ln(lp + "attention.output.", "beta"),
            to + "intermediate.weight": raw[lp + "intermediate.dense.weight"],
            to + "intermediate.bias": raw[lp + "intermediate.dense.bias"],
            to + "mlp_out.weight": raw[lp + "output.dense.weight"],
            to + "mlp_out.bias": raw[lp + "output.dense.bias"],
            to + "ln_mlp.scale": ln(lp + "output.", "gamma"),
            to + "ln_mlp.bias": ln(lp + "output.", "beta"),
        })
    params = dict(bb.named_parameters())
    with torch.no_grad():
        for name, arr in vals.items():
            p = params[name]
            src = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
            if src.shape != p.shape:
                raise ValueError(f"{npz_path}: {name} has shape {tuple(src.shape)}, the "
                                 f"backbone's is {tuple(p.shape)}")
            p.copy_(src)
