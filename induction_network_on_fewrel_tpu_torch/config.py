"""Frozen experiment configuration of the serving and training paths.

The port's own copy of the ``ExperimentConfig`` fields that the serving
and training paths read (``induction_network_on_fewrel_tpu/config.py``):
episode geometry, tokenization/embedding, the BiLSTM + self-attention
encoder and its training-route knobs, the induction/NTN head, the NOTA
head, the dtypes, the kernel backends, the optimizer family, the loop
lengths, the fused-dispatch and grad-probe knobs, and the seed. Names and
defaults are the JAX package's, so a config built with the same keywords
describes the same model in both packages, and the ``config.json`` a
checkpoint writes loads into the JAX config too. The parallel, fleet and
observability knobs come with their slices.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    # --- episode geometry ---
    n: int = 5                # N-way (training and eval)
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
    # Training route of the BiLSTM (ops/lstm.py): one (h, c) checkpoint pair
    # per W natural-time steps, each window replayed in the backward; 0 =
    # the full-residual twin (hs and c saved at every step, kernels 4/6).
    # "auto" residuals follow compute_dtype; "f32"/"bf16" force the storage
    # dtype of the checkpoints or of the cs stream.
    lstm_cs_window: int = 8
    lstm_residuals: str = "auto"

    # --- induction + relation modules ---
    induction_dim: int = 100  # class-vector dim C after the squash transform
    routing_iters: int = 3    # dynamic-routing iterations
    ntn_slices: int = 100     # tensor slices in the NTN scorer

    # --- optimization (train/steps.make_optimizer) ---
    loss: str = "mse"         # mse (paper §3.4) | ce
    # adam (coupled L2 after the clip) | adamw (decoupled decay) | sgd
    # (coupled L2, no momentum): train/steps.make_optimizer.
    optimizer: str = "adam"
    # Word-table optimizer: "shared" = the main optimizer updates the table
    # densely (reference parity); "sgd" = plain -lr*g on the table (no
    # decay, no moments); "frozen" = the table gets no gradient, no update
    # and no moments; "lazy" is refused by name (ROADMAP queue A item 4).
    embed_optimizer: str = "shared"
    lr: float = 1e-3
    weight_decay: float = 1e-5
    lr_step_size: int = 2000  # staircase decay interval, in updates
    lr_gamma: float = 0.5
    grad_clip: float = 10.0
    train_iter: int = 10000
    val_iter: int = 1000
    val_step: int = 1000
    test_iter: int = 3000
    # Optimizer steps per dispatch (train/steps.make_multi_train_step: one
    # CUDA-graph replay of S captured steps on the card); 1 = one step per
    # dispatch. The updates are the same as S single steps.
    steps_per_call: int = 1
    # Eval batches per dispatch at val/test boundaries; 0 = auto:
    # min(steps_per_call, 16).
    eval_steps_per_call: int = 0
    # Train dispatches between metric records: the window in steps is
    # max(50, metric_window_calls * steps_per_call).
    metric_window_calls: int = 4
    # Every K steps, log the gradient's global norm and its cosine to an
    # all-f32 plain-backend reference gradient on the same batch
    # (train/steps.make_grad_probe); 0 = off.
    grad_probe_every: int = 0

    # --- numerics ---
    compute_dtype: str = "bfloat16"  # embedding + encoder dtype
    head_dtype: str = "float32"      # induction / NTN / logits dtype
    seed: int = 0

    # Fields whose value shapes the parameters or the optimizer state: a
    # checkpoint restores only into a config that agrees on them.
    ARCHITECTURE_FIELDS = (
        "model", "encoder", "lstm_hidden", "att_dim", "word_dim", "pos_dim",
        "vocab_size", "max_length", "induction_dim", "routing_iters",
        "ntn_slices", "loss", "optimizer", "embed_optimizer", "nota_head",
    )

    def replace(self, **kw: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)

    def merge_architecture_from(self, other: "ExperimentConfig") -> "ExperimentConfig":
        """This config with ``other``'s architecture fields."""
        return self.replace(**{f: getattr(other, f) for f in self.ARCHITECTURE_FIELDS})

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        """Keys this config does not have (a JAX config.json carries many
        more) are ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in json.loads(s).items() if k in names})
