"""Model factory: ExperimentConfig -> a few-shot model on a device.

Counterpart of ``induction_network_on_fewrel_tpu/models/build.py``: the
models induction, proto, proto_hatt, siamese, gnn, snail and metanet over
the cnn, bilstm, transformer and bert encoders, and BERT-PAIR (``--model
pair``, its own backbone). With ``feature_cache`` the model is the head
alone over encoded rows (``models/bert.CachedFeatures``); its backbone is
``build_model(cfg.replace(feature_cache=False))``. The transformer takes
the MoE FFN (``moe_experts > 0``, ``models/moe.py``; its experts shard
over ``--ep`` ranks, ``parallel/expert.py``) or the layer-stacked layout
(``tfm_stacked``, ``models/pipeline_transformer.py``) on one card; its
pipeline executor (``--pp`` > 1) and ring attention (``--sp``) come with
ROADMAP item 6d (``LATER_SLICE``).

Device rule: ``device=None`` means "cuda". Without CUDA that raises, unless
the caller asked for ``device="cpu"`` explicitly: there is no silent CPU
fall back on the entry points.

``batch_to_model_inputs`` is the counterpart of the JAX function of the
same name for an ``EpisodeBatch``: numpy (support, query, label) with the
same wire dtypes (int16 positions, int8 mask); ``instance_inputs`` the same
for the adversarial step's ``InstanceBatch``.
"""

from __future__ import annotations

import numpy as np
import torch

from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.models.base import FewShotModel
from induction_network_on_fewrel_tpu_torch.models.bert import (
    BertEmbeddingPassthrough,
    BertEncoder,
    CachedFeatures,
)
from induction_network_on_fewrel_tpu_torch.models.embedding import Embedding
from induction_network_on_fewrel_tpu_torch.models.encoders import (
    BiLSTMSelfAttnEncoder,
    CNNEncoder,
)
from induction_network_on_fewrel_tpu_torch.models.gnn import GNN
from induction_network_on_fewrel_tpu_torch.models.induction import InductionNetwork
from induction_network_on_fewrel_tpu_torch.models.metanet import MetaNet
from induction_network_on_fewrel_tpu_torch.models.pair import PairModel
from induction_network_on_fewrel_tpu_torch.models.pipeline_transformer import (
    PipelinedTransformerEncoder,
)
from induction_network_on_fewrel_tpu_torch.models.proto import PROTO_METRICS, PrototypicalNetwork
from induction_network_on_fewrel_tpu_torch.models.proto_hatt import ProtoHATT
from induction_network_on_fewrel_tpu_torch.models.siamese import SiameseNetwork
from induction_network_on_fewrel_tpu_torch.models.snail import SNAIL
from induction_network_on_fewrel_tpu_torch.models.transformer import TransformerEncoder
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


# The JAX package's sharded executors still to port: the ROADMAP queue A
# item that brings them (the CLI refuses --tp, --pp and --sp above 1 by name
# with these).
SHARDED = "ROADMAP queue A item 6d (the sharded executors: tp, sp ring attention, pp)"
LATER_SLICE = {
    "pp": SHARDED + "; --pp 1 with --tfm_stacked runs the layer-stacked transformer on one card",
    "sp": SHARDED,
}
MODELS = ("induction", "proto", "proto_hatt", "siamese", "gnn", "snail", "metanet", "pair")
ENCODERS = ("cnn", "bilstm", "transformer", "bert")
# Models whose parameter shapes hold the N-way width.
N_TIED = tuple(m for m, f in ExperimentConfig.MODEL_GEOMETRY_FIELDS.items() if "n" in f)


def refuse_later_slices(cfg: ExperimentConfig) -> None:
    """Raise ValueError for an unknown model or encoder."""
    if cfg.model not in MODELS:
        raise ValueError(f"unknown model {cfg.model!r} (one of {MODELS})")
    if cfg.encoder not in ENCODERS:
        raise ValueError(f"unknown encoder {cfg.encoder!r} (one of {ENCODERS})")


def check_transformer_options(cfg: ExperimentConfig) -> None:
    """Refuse by name an MoE or stacked configuration the model would
    silently not honor (the JAX ``build.py:159-182``): experts or the
    stacked layout off the transformer, MoE without an expert layer (or
    with no expert chosen per token), the stacked layout with MoE, and
    ``--ep`` above 1 without MoE on the transformer or with experts that do
    not divide over it (the JAX ``cli.py:862-871``)."""
    if cfg.ep > 1:
        if cfg.moe_experts <= 0 or cfg.encoder != "transformer":
            raise ValueError("--ep (expert parallelism) requires --encoder transformer with "
                             "--moe_experts > 0")
        if cfg.moe_experts % cfg.ep != 0:
            raise ValueError(f"--moe_experts ({cfg.moe_experts}) must be divisible by --ep "
                             f"({cfg.ep})")
    if cfg.moe_experts > 0:
        if cfg.encoder != "transformer":
            raise ValueError("--moe_experts requires --encoder transformer (the MoE FFN lives in "
                             "the transformer blocks; other encoders have no MoE path and would "
                             "silently train dense)")
        if cfg.tfm_layers < cfg.moe_every:
            raise ValueError(
                f"--moe_experts with --moe_every {cfg.moe_every} > --tfm_layers "
                f"{cfg.tfm_layers} would create zero expert layers (block i is MoE when "
                "(i+1) % moe_every == 0): the model would silently train dense")
        if cfg.moe_top_k < 1:
            raise ValueError(f"--moe_top_k must be >= 1, got {cfg.moe_top_k}")
    if cfg.tfm_stacked:
        if cfg.encoder != "transformer":
            raise ValueError("--tfm_stacked requires --encoder transformer (the stacked layers "
                             "are transformer layers)")
        if cfg.moe_experts > 0:
            raise ValueError("--tfm_stacked (the layer-stacked transformer) does not compose "
                             "with MoE; drop --moe_experts or --tfm_stacked")


def encoder_output_dim(cfg: ExperimentConfig) -> int:
    """Sentence-vector width of ``cfg``'s encoder."""
    if cfg.encoder == "bilstm":
        return 2 * cfg.lstm_hidden
    if cfg.encoder == "transformer":
        return cfg.tfm_model
    if cfg.encoder == "bert":
        return cfg.bert_hidden
    return cfg.hidden_size  # cnn


def check_feature_cache(cfg: ExperimentConfig) -> None:
    """Refuse by name a feature cache the model cannot train on: the cache
    holds frozen-BERT sentence vectors (the JAX refusals, cli.py:994-1001)."""
    if not cfg.feature_cache:
        return
    if cfg.encoder != "bert" or not cfg.bert_frozen:
        raise ValueError("--feature_cache requires --encoder bert with the frozen backbone "
                         "(a trainable encoder would be silently frozen)")
    if cfg.model == "pair":
        raise ValueError("--feature_cache cannot serve --model pair: it scores token-level "
                         "sentence pairs through the backbone")


def build_pair(cfg: ExperimentConfig, device, gen: torch.Generator) -> PairModel:
    """BERT-PAIR (JAX build.py:184-212): it owns its backbone, so it needs
    ``--encoder bert``, and it has the scalar NOTA logit alone."""
    if cfg.encoder != "bert":
        raise ValueError("--model pair requires --encoder bert (token-level sequence-pair input)")
    if cfg.nota_head != "scalar":
        raise ValueError("--model pair supports only --nota_head scalar")
    return PairModel(cfg.bert_vocab_size, cfg.bert_layers, cfg.bert_hidden, cfg.bert_heads,
                     cfg.bert_intermediate, frozen=cfg.bert_frozen, remat=cfg.bert_remat,
                     nota=cfg.na_rate > 0, compute_dtype=DTYPES[cfg.compute_dtype],
                     device=device, generator=gen)


def build_encoder(cfg: ExperimentConfig, input_dim: int, device, gen: torch.Generator):
    compute = DTYPES[cfg.compute_dtype]
    if cfg.encoder == "bert":
        if cfg.feature_cache:
            return CachedFeatures(cfg.bert_hidden)
        return BertEncoder(cfg.bert_vocab_size, cfg.bert_layers, cfg.bert_hidden, cfg.bert_heads,
                           cfg.bert_intermediate, frozen=cfg.bert_frozen, remat=cfg.bert_remat,
                           dtype=compute, device=device, generator=gen)
    if cfg.encoder == "cnn":
        return CNNEncoder(input_dim, cfg.hidden_size, compute_dtype=compute, device=device,
                          generator=gen)
    if cfg.encoder == "transformer" and cfg.tfm_stacked:
        return PipelinedTransformerEncoder(input_dim, cfg.tfm_layers, cfg.tfm_model,
                                           cfg.tfm_heads, cfg.tfm_ff, cfg.max_length,
                                           compute_dtype=compute, device=device, generator=gen)
    if cfg.encoder == "transformer":
        return TransformerEncoder(input_dim, cfg.tfm_layers, cfg.tfm_model, cfg.tfm_heads,
                                  cfg.tfm_ff, cfg.max_length, compute_dtype=compute,
                                  num_experts=cfg.moe_experts, moe_top_k=cfg.moe_top_k,
                                  moe_capacity=cfg.moe_capacity, moe_every=cfg.moe_every,
                                  moe_group_size=cfg.moe_group_size, device=device,
                                  generator=gen)
    backends = resolve_runtime_backends(cfg, device)
    return BiLSTMSelfAttnEncoder(
        input_dim, cfg.lstm_hidden, cfg.att_dim,
        lstm_backend=backends["lstm_backend"],
        attn_backend=backends["attn_backend"],
        compute_dtype=compute,
        lstm_cs_window=backends["lstm_cs_window"],
        lstm_residual_dtype=backends["lstm_residual_dtype"],
        device=device, generator=gen,
    )


def build_model(
    cfg: ExperimentConfig,
    glove_init: np.ndarray | None = None,
    device=None,
) -> FewShotModel:
    """Fresh ``cfg.model`` over ``cfg.encoder`` with f32 parameters drawn
    from a ``torch.Generator`` seeded with ``cfg.seed``; ``glove_init``
    [vocab, word_dim] replaces the word table's random init. Unknown
    models and encoders, MoE or stacked options the model would not honor
    (``check_transformer_options``), N-tied models trained at another N than they are
    evaluated at, a BiLSTM too wide for its kernels and a feature cache
    off frozen BERT are refused by name before any parameter is made.
    The BERT encoder sits behind ``BertEmbeddingPassthrough`` (it owns its
    token table; ``glove_init`` does not apply)."""
    refuse_later_slices(cfg)
    check_transformer_options(cfg)
    check_feature_cache(cfg)
    if cfg.model in N_TIED and cfg.train_n != cfg.n:
        raise ValueError(
            f"model {cfg.model!r} ties parameter shapes to N; --trainN ({cfg.train_n}) "
            f"must equal --N ({cfg.n})"
        )
    if cfg.model == "proto" and cfg.proto_metric not in PROTO_METRICS:
        raise ValueError(f"unknown proto metric {cfg.proto_metric!r} (one of {PROTO_METRICS})")
    dev = resolve_device(device)
    if cfg.encoder == "bilstm":
        check_kernel_widths(cfg, dev)
    gen = torch.Generator().manual_seed(cfg.seed)
    if cfg.model == "pair":
        return build_pair(cfg, dev, gen)
    compute, head = DTYPES[cfg.compute_dtype], DTYPES[cfg.head_dtype]
    if cfg.encoder == "bert":
        embedding = BertEmbeddingPassthrough()
        encoder = build_encoder(cfg, cfg.bert_hidden, dev, gen)
    else:
        embedding = Embedding(
            cfg.vocab_size, cfg.word_dim, cfg.pos_dim, cfg.max_length,
            glove_init=glove_init, compute_dtype=compute,
            freeze_word_table=cfg.embed_optimizer == "frozen", device=dev, generator=gen,
        )
        encoder = build_encoder(cfg, embedding.output_dim, dev, gen)
    common = dict(nota=cfg.na_rate > 0, nota_head=cfg.nota_head, head_dtype=head, device=dev)
    if cfg.model == "induction":
        return InductionNetwork(
            embedding, encoder, induction_dim=cfg.induction_dim,
            routing_iters=cfg.routing_iters, ntn_slices=cfg.ntn_slices, generator=gen,
            **common,
        )
    if cfg.model == "proto":
        return PrototypicalNetwork(embedding, encoder, cfg.proto_metric, **common)
    if cfg.model == "siamese":
        return SiameseNetwork(embedding, encoder, **common)
    if cfg.model == "metanet":
        return MetaNet(embedding, encoder, cfg.n, generator=gen, **common)
    common.update(compute_dtype=compute, generator=gen)
    if cfg.model == "proto_hatt":
        return ProtoHATT(embedding, encoder, cfg.k, **common)
    if cfg.model == "gnn":
        return GNN(embedding, encoder, cfg.n, cfg.gnn_dim, cfg.gnn_blocks, cfg.gnn_adj_hidden,
                   **common)
    return SNAIL(embedding, encoder, cfg.n, cfg.k, cfg.snail_tc_filters, **common)


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


def instance_inputs(batch) -> dict:
    """InstanceBatch (numpy) -> the token dict of its rows, with the wire
    dtypes of ``batch_to_model_inputs``."""
    return {"word": batch.word, "pos1": batch.pos1.astype(np.int16),
            "pos2": batch.pos2.astype(np.int16), "mask": batch.mask.astype(np.int8)}
