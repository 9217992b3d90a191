"""Token embedding: GloVe word vectors ⧺ two entity-position embeddings.

Counterpart of ``induction_network_on_fewrel_tpu/models/embedding.py``
(``Embedding``), in its per-token position-id form: three row gathers,
concatenated to (word_dim + 2*pos_dim)-d token vectors and cast to the
compute dtype (embedding.py:159), so with bf16 the word vectors are rounded
here, before the encoder.

The gathers' backward follows the JAX module (embedding.py:100-160): both
position tables, and a word table of at most ``MATMUL_GRAD_MAX_ROWS``
rows, go through ``ops.segsum.lookup_matmul_grad`` (a one-hot product);
a larger word table (the 400 002-row GloVe table) through
``ops.segsum.lookup_scatter_grad`` (the sort-free scatter-add,
``index_add_``). ``freeze_word_table`` (``embed_optimizer="frozen"``)
gathers from a detached table, so the table gets no gradient at all.

``compact_rows`` (set by the lazy word-table step, train/lazy_embed.py,
for the duration of its forward): a [U, word_dim] leaf of caught-up rows
that the word ids have been remapped into. The forward then gathers from
it and never reads the dense table, so the step's table gradient is the
compact [U, word_dim] one (the one-hot product up to
``MATMUL_GRAD_MAX_ROWS`` rows, else ``lookup_prefix_grad``: no atomics;
``demb_impl`` replaces that lookup under data parallel with
``compact_demb off``, parallel/sharding.py).

Positions in OFFSET form (``is_offset_form``: one rank below ``word``,
the token cache's per-sentence start offsets, whose per-token ids are
exactly ``off + l``) are expanded to per-token ids by
``expand_positions``; pos1 and pos2 are tested independently. The
gathered vectors are the per-token form's, bitwise.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from induction_network_on_fewrel_tpu_torch.ops.segsum import (
    MATMUL_GRAD_MAX_ROWS,
    lookup_matmul_grad,
    lookup_prefix_grad,
    lookup_scatter_grad,
)


def is_offset_form(pos: torch.Tensor, word_rank: int) -> bool:
    """True when a position leaf holds per-sentence offsets (one rank below
    ``word``), the JAX ``is_offset_form`` (models/embedding.py:34)."""
    return pos.dim() == word_rank - 1


def expand_positions(pos: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
    """Per-token position ids shaped like ``word`` ([..., L]): offsets
    ``off [...]`` become ``off + arange(L)``; per-token ids pass through."""
    if not is_offset_form(pos, word.dim()):
        return pos
    L = word.shape[-1]
    return pos.long()[..., None] + torch.arange(L, device=pos.device)


def normal_param(gen: torch.Generator, shape, std: float, device) -> nn.Parameter:
    """f32 N(0, std²) parameter drawn on the CPU from ``gen`` (so a seed
    gives the same weights on every device), then moved to ``device``.
    The embeddings' init, flax's ``normal(0.1)``."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32) * std
    return nn.Parameter(w.to(device))


# Std of a standard normal truncated to [-2, 2]: flax's variance-scaling
# initializers divide their target std by it.
TRUNC_STD = 0.87962566103423978


def truncated_normal_param(gen: torch.Generator, shape, std: float, device) -> nn.Parameter:
    """f32 parameter of std ``std`` drawn as flax's ``variance_scaling(...,
    "truncated_normal")`` (``lecun_normal``, ``glorot_normal``) draws it: a
    standard normal truncated to [-2, 2] (inverse CDF of a uniform draw
    from ``gen`` on the CPU, in f64) times ``std / TRUNC_STD``, so
    |w| <= 2 std / TRUNC_STD ~ 2.27 std; then moved to ``device``."""
    lo = torch.special.ndtr(torch.tensor(-2.0, dtype=torch.float64))
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    z = torch.special.ndtri(lo + (1.0 - 2.0 * lo) * u).clamp(-2.0, 2.0)
    return nn.Parameter((z * (std / TRUNC_STD)).to(torch.float32).to(device))


class Embedding(nn.Module):
    def __init__(
        self,
        vocab_size: int,
        word_dim: int = 50,
        pos_dim: int = 5,
        max_length: int = 40,
        glove_init: np.ndarray | None = None,
        compute_dtype: torch.dtype = torch.float32,
        freeze_word_table: bool = False,
        *,
        device,
        generator: torch.Generator,
    ):
        super().__init__()
        self.freeze_word_table = freeze_word_table
        if glove_init is not None:
            if glove_init.shape != (vocab_size, word_dim):
                raise ValueError(
                    f"glove_init {glove_init.shape} != ({vocab_size}, {word_dim})"
                )
            # A copy: the table is updated in place, and on the CPU a view
            # of the caller's array would update it (and every other model
            # built from it) too.
            word = torch.tensor(glove_init, dtype=torch.float32)
            self.word_embedding = nn.Parameter(word.to(device))
        else:
            self.word_embedding = normal_param(
                generator, (vocab_size, word_dim), 0.1, device
            )
        self.pos1_embedding = normal_param(
            generator, (2 * max_length, pos_dim), 0.1, device
        )
        self.pos2_embedding = normal_param(
            generator, (2 * max_length, pos_dim), 0.1, device
        )
        self.compute_dtype = compute_dtype
        self.compact_rows: torch.Tensor | None = None
        # Under data parallel with compact_demb off: the compact rows'
        # lookup whose backward gathers every rank's cotangent
        # (parallel/sharding.make_compact_demb_lookup).
        self.demb_impl = None

    def forward(self, word, pos1, pos2) -> torch.Tensor:
        """int ids of one shape S -> [*S, word_dim + 2*pos_dim] vectors
        (callers pass time-major [L, M] ids to get [L, M, D]). With
        ``compact_rows`` set, ``word`` indexes those rows."""
        word = word.long()
        if self.compact_rows is not None:
            rows = self.compact_rows
            lookup = (self.demb_impl if self.demb_impl is not None else
                      lookup_matmul_grad if rows.shape[0] <= MATMUL_GRAD_MAX_ROWS
                      else lookup_prefix_grad)
            word_vecs = lookup(rows, word)
        elif self.freeze_word_table:
            word_vecs = self.word_embedding.detach()[word]
        elif self.word_embedding.shape[0] <= MATMUL_GRAD_MAX_ROWS:
            word_vecs = lookup_matmul_grad(self.word_embedding, word)
        else:
            word_vecs = lookup_scatter_grad(self.word_embedding, word)
        out = torch.cat(
            [
                word_vecs,
                lookup_matmul_grad(self.pos1_embedding, pos1.long()),
                lookup_matmul_grad(self.pos2_embedding, pos2.long()),
            ],
            dim=-1,
        )
        return out.to(self.compute_dtype)

    @property
    def output_dim(self) -> int:
        return self.word_embedding.shape[1] + 2 * self.pos1_embedding.shape[1]
