"""Frozen experiment configuration of the serving path.

The port's own copy of the ``ExperimentConfig`` fields that the serving
path reads (``induction_network_on_fewrel_tpu/config.py``): episode
geometry, tokenization/embedding, the BiLSTM + self-attention encoder, the
induction/NTN head, the NOTA head, the dtypes, the kernel backends and the
seed. Names and defaults are the JAX package's, so a config built with the
same keywords describes the same model in both packages. The training,
parallel, fleet and observability knobs come with their slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    # --- episode geometry ---
    n: int = 5                # N-way at eval
    k: int = 5                # K-shot
    q: int = 5                # queries per class per episode
    na_rate: int = 0          # NOTA: na_rate*Q extra none-of-the-above queries
    # NOTA head (models/base.append_nota): "scalar" = one global learned
    # threshold logit; "stats" = per-query learned affine over the class-
    # score distribution (max/mean/std).
    nota_head: str = "scalar"
    batch_size: int = 4       # episodes per forward

    # --- tokenization / embedding ---
    max_length: int = 40      # tokens per sentence (fixed shapes)
    word_dim: int = 50        # GloVe 6B.50d
    pos_dim: int = 5          # each of the two position embeddings
    vocab_size: int = 400002  # GloVe 400k + [UNK] + [BLANK]

    # --- few-shot model: this slice serves induction + bilstm only ---
    model: str = "induction"
    encoder: str = "bilstm"
    lstm_hidden: int = 128    # per direction
    att_dim: int = 64         # structured self-attention projection dim
    # Kernel backends (models/build.resolve_runtime_backends is the one
    # home of their resolution): "auto" = the hand-written CUDA kernel for
    # CUDA tensors, the plain PyTorch version for CPU tensors; "reference"
    # forces the plain version, "cuda" forces the kernel (CUDA tensors only).
    lstm_backend: str = "auto"
    attn_backend: str = "auto"

    # --- induction + relation modules ---
    induction_dim: int = 100  # class-vector dim C after the squash transform
    routing_iters: int = 3    # dynamic-routing iterations
    ntn_slices: int = 100     # tensor slices in the NTN scorer

    # --- numerics ---
    compute_dtype: str = "bfloat16"  # embedding + encoder dtype
    head_dtype: str = "float32"      # induction / NTN / logits dtype
    seed: int = 0

    def replace(self, **kw: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)
