"""Model factory: ExperimentConfig -> InductionNetwork on a device.

Counterpart of ``induction_network_on_fewrel_tpu/models/build.py`` for
``--model induction --encoder bilstm``; other models and encoders come with
later slices and are refused by name.

Device rule: ``device=None`` means "cuda". Without CUDA that raises, unless
the caller asked for ``device="cpu"`` explicitly: there is no silent CPU
fall back on the entry points.

``batch_to_model_inputs`` is the counterpart of the JAX function of the
same name for an ``EpisodeBatch``: numpy (support, query, label) with the
same wire dtypes (int16 positions, int8 mask).
"""

from __future__ import annotations

import numpy as np
import torch

from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.models.embedding import Embedding
from induction_network_on_fewrel_tpu_torch.models.encoders import BiLSTMSelfAttnEncoder
from induction_network_on_fewrel_tpu_torch.models.induction import InductionNetwork
from induction_network_on_fewrel_tpu_torch.ops.core import resolve_backend
from induction_network_on_fewrel_tpu_torch.ops.lstm import kernel_width_refusal

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
RESIDUAL_DTYPES = {"auto": None, "f32": torch.float32, "bf16": torch.bfloat16}


def resolve_device(device=None) -> torch.device:
    """None -> cuda. A CUDA device without CUDA raises RuntimeError."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: this entry point runs on the GPU by "
            "default; pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev


def resolve_runtime_backends(cfg: ExperimentConfig, device) -> dict:
    """ONE home for the encoder's kernel backend knobs (counterpart of the
    JAX ``resolve_runtime_backends``). Each of ``lstm_backend`` and
    ``attn_backend`` is ``auto | reference | cuda``:

    =========  ==============================================================
    auto       the hand-written CUDA kernel on a CUDA device (K1 for the
               BiLSTM, K2 for the attention), the plain PyTorch version on
               the CPU
    reference  the plain PyTorch version on any device
    cuda       the kernel; raises on a non-CUDA device
    =========  ==============================================================

    On the TPU the JAX package resolved ``attn_backend auto`` to its
    two-pass XLA form from a TPU measurement; that says nothing about this
    card, so here the attention kernel is on the path by default and
    ``chip_smoke.py`` times it against the plain two-pass version.

    ``lstm_cs_window`` (default 8) is the checkpoint window of the training
    route (K7/K8 or their plain versions); 0 is the JAX package's
    full-residual twin (K4/K6: hs and c saved at every step); negative
    values are refused. ``lstm_residuals`` ``auto | f32 | bf16`` is the
    storage dtype of the checkpoints or of the cs stream; "auto" (None)
    follows the compute dtype. Unlike the JAX resolution, the window also
    engages on the plain path: the plain versions follow the kernels'
    algorithm. None of these knobs change parameters or outputs beyond
    rounding."""
    window = int(cfg.lstm_cs_window)
    if window < 0:
        raise ValueError(
            f"lstm_cs_window must be >= 0, got {window} "
            "(0 = full residual streams, W > 0 = windowed-cs remat)"
        )
    if cfg.lstm_residuals not in RESIDUAL_DTYPES:
        raise ValueError(
            f"unknown lstm_residuals {cfg.lstm_residuals!r} (auto | f32 | bf16)"
        )
    return {
        "lstm_backend": resolve_backend(cfg.lstm_backend, device),
        "attn_backend": resolve_backend(cfg.attn_backend, device),
        "lstm_cs_window": window,
        "lstm_residual_dtype": RESIDUAL_DTYPES[cfg.lstm_residuals],
    }


def check_kernel_widths(cfg: ExperimentConfig, device) -> None:
    """Refuse by name a width that the BiLSTM kernels cannot take, when
    ``lstm_backend`` resolves to "cuda" on ``device``: the cluster bodies
    hold 4u <= 512 gate columns and their weight slices in one CTA's
    shared memory (``ops/lstm.kernel_width_refusal``). ``build_model``
    calls this before it makes any parameter, so such a model fails here
    and not at its first forward. ``--lstm_backend reference`` runs the
    plain version at any width; nothing switches to it by itself. The
    attention kernels take any D and A."""
    if resolve_backend(cfg.lstm_backend, device) != "cuda":
        return
    D = cfg.word_dim + 2 * cfg.pos_dim
    why = kernel_width_refusal(D, cfg.lstm_hidden, int(cfg.lstm_cs_window))
    if why:
        raise ValueError(
            f"lstm_hidden={cfg.lstm_hidden} (input width {D}, lstm_cs_window="
            f"{cfg.lstm_cs_window}) is wider than the BiLSTM CUDA kernels take: {why}; "
            "pass --lstm_backend reference (lstm_backend=\"reference\") to run the "
            "plain PyTorch version on the card"
        )


def build_model(
    cfg: ExperimentConfig,
    glove_init: np.ndarray | None = None,
    device=None,
) -> InductionNetwork:
    """Fresh InductionNetwork with f32 parameters drawn from a
    ``torch.Generator`` seeded with ``cfg.seed``; ``glove_init`` [vocab,
    word_dim] replaces the word table's random init."""
    if cfg.model != "induction":
        raise ValueError(
            f"model {cfg.model!r} is not ported yet: the torch package serves "
            f"--model induction only"
        )
    if cfg.encoder != "bilstm":
        raise ValueError(
            f"encoder {cfg.encoder!r} is not ported yet: the torch package "
            f"runs --encoder bilstm only"
        )
    dev = resolve_device(device)
    check_kernel_widths(cfg, dev)
    backends = resolve_runtime_backends(cfg, dev)
    gen = torch.Generator().manual_seed(cfg.seed)
    compute = DTYPES[cfg.compute_dtype]
    embedding = Embedding(
        cfg.vocab_size, cfg.word_dim, cfg.pos_dim, cfg.max_length,
        glove_init=glove_init, compute_dtype=compute, device=dev, generator=gen,
    )
    encoder = BiLSTMSelfAttnEncoder(
        embedding.output_dim, cfg.lstm_hidden, cfg.att_dim,
        lstm_backend=backends["lstm_backend"],
        attn_backend=backends["attn_backend"],
        compute_dtype=compute,
        lstm_cs_window=backends["lstm_cs_window"],
        lstm_residual_dtype=backends["lstm_residual_dtype"],
        device=dev, generator=gen,
    )
    model = InductionNetwork(
        embedding, encoder,
        induction_dim=cfg.induction_dim, routing_iters=cfg.routing_iters,
        ntn_slices=cfg.ntn_slices, nota=cfg.na_rate > 0, nota_head=cfg.nota_head,
        head_dtype=DTYPES[cfg.head_dtype], device=dev, generator=gen,
    )
    return model


def batch_to_model_inputs(batch) -> tuple[dict, dict, np.ndarray]:
    """EpisodeBatch (numpy) -> (support dict, query dict, label). Positions
    cross to the device as int16 and the mask as int8, as in the JAX
    package; the model's gathers and ``> 0`` tests take any int dtype."""
    support = {
        "word": batch.support_word,
        "pos1": batch.support_pos1.astype(np.int16),
        "pos2": batch.support_pos2.astype(np.int16),
        "mask": batch.support_mask.astype(np.int8),
    }
    query = {
        "word": batch.query_word,
        "pos1": batch.query_pos1.astype(np.int16),
        "pos2": batch.query_pos2.astype(np.int16),
        "mask": batch.query_mask.astype(np.int8),
    }
    return support, query, batch.label
