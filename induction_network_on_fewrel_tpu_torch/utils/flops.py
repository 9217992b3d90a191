"""Analytic FLOPs per step for MFU reporting.

A copy of ``induction_network_on_fewrel_tpu/utils/flops.py``: the same
counting convention (matmul terms only; the training step costs 3x the
forward matmuls: 1x forward + 2x backward) and the same formulas, term by
term, for every (encoder, model) of the zoo. Only the peak table differs:
``peak_flops_per_chip`` knows the NVIDIA H100's dense rates
(``utils/roofline.py``), by ``torch.cuda.get_device_name`` fragment.
"""

from __future__ import annotations

from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig

def peak_flops_per_chip(device_kind: str, compute_dtype: str) -> float | None:
    """The dense peak of a known card for the compute dtype: bf16 on the
    tensor cores, f32 outside them; None for an unknown device (the CPU)."""
    from induction_network_on_fewrel_tpu_torch.utils.roofline import (
        H100_BF16_FLOPS,
        H100_F32_FLOPS,
    )

    if "h100" not in device_kind.lower():
        return None
    return H100_BF16_FLOPS if "bfloat16" in compute_dtype else H100_F32_FLOPS


def _geometry(cfg: ExperimentConfig):
    B = cfg.batch_size
    N, K = cfg.train_n, cfg.k
    TQ = cfg.train_n * cfg.q + cfg.na_rate * cfg.q
    Ms = B * N * K
    Mq = B * TQ
    return B, N, K, TQ, Ms, Mq


def encoder_forward_flops(cfg: ExperimentConfig, M: float, L: int | None = None) -> float:
    """Forward matmul FLOPs of ``cfg.encoder`` over ``M`` rows of length
    ``L`` (default cfg.max_length). Shapes mirror models/encoders.py,
    models/transformer.py, and models/bert.py."""
    L = L if L is not None else cfg.max_length
    D = cfg.word_dim + 2 * cfg.pos_dim
    if cfg.encoder == "cnn":
        # encoders.py CNNEncoder: Conv1d window 3, D -> hidden_size.
        return 2.0 * M * L * 3 * D * cfg.hidden_size
    if cfg.encoder == "bilstm":
        u, A, H = cfg.lstm_hidden, cfg.att_dim, 2 * cfg.lstm_hidden
        f = 2.0 * M * L * D * (8 * u)            # input projection
        f += 2.0 * M * L * u * (4 * u) * 2       # recurrence, both dirs
        f += 2.0 * M * L * H * A + 2.0 * M * L * A + 2.0 * M * L * H  # attn
        return f
    if cfg.encoder == "transformer":
        dm, ff, nl = cfg.tfm_model, cfg.tfm_ff, cfg.tfm_layers
        f = 2.0 * M * L * D * dm                 # input projection
        per = 4 * 2.0 * M * L * dm * dm          # qkv + out proj
        per += 2 * 2.0 * M * L * L * dm          # scores + att·v
        per += 2 * 2.0 * M * L * dm * ff         # MLP (MoE top-k ~ same
        return f + nl * per                      # per-token ff work)
    if cfg.encoder == "bert":
        dm, ff, nl = cfg.bert_hidden, cfg.bert_intermediate, cfg.bert_layers
        per = 4 * 2.0 * M * L * dm * dm
        per += 2 * 2.0 * M * L * L * dm
        per += 2 * 2.0 * M * L * dm * ff
        return nl * per + 2.0 * M * dm * dm      # + pooler
    raise ValueError(f"no FLOPs model for encoder {cfg.encoder!r}")


def head_forward_flops(cfg: ExperimentConfig, H: float) -> float:
    """Forward matmul FLOPs of the episode head ``cfg.model`` given encoder
    output dim ``H``. Shapes mirror the models/*.py einsums; tiny readouts
    kept, elementwise excluded (MFU convention)."""
    B, N, K, TQ, Ms, Mq = _geometry(cfg)
    m = cfg.model
    if m == "induction":
        C, S = cfg.induction_dim, cfg.ntn_slices
        f = 2.0 * Ms * H * C + 2.0 * Mq * H * C
        f += cfg.routing_iters * 2 * (2.0 * B * N * K * C)
        f += 2.0 * B * N * S * C * C + 2.0 * B * N * S * C * TQ
        f += 2.0 * B * TQ * N * S
        return f
    if m == "proto":
        return 2.0 * B * TQ * N * H
    if m == "siamese":
        return 2.0 * B * TQ * N * K * H
    if m == "proto_hatt":
        k = K
        f = 2.0 * B * N * K * H * k * 32          # conv 1 -> 32
        f += 2.0 * B * N * K * H * k * 32 * 64    # conv 32 -> 64
        f += 2.0 * B * N * H * k * 64             # strided conv 64 -> 1
        f += 2.0 * (Ms + Mq) * H * H              # shared g() projection
        f += 2 * 2.0 * B * TQ * N * K * H         # scores + weighted proto
        f += 2.0 * B * TQ * N * H                 # weighted distance
        return f
    if m == "metanet":
        f = 2.0 * Ms * H * N                      # slow logits on supports
        f += 2.0 * Ms * H * N                     # meta-gradient outer prod
        f += 2.0 * B * TQ * N * K * H             # cosine memory read
        f += 2.0 * B * TQ * N * K * H * N         # fast-weight mix
        f += 2 * 2.0 * Mq * H * N                 # slow + fast logits
        return f
    if m == "gnn":
        G, T = B * TQ, N * K + 1
        P = _gnn_mlp_pairs(T)                     # pairs the edge MLP runs:
        # T(T-1)/2 unordered (the one-hot upper-triangle form) at zoo
        # shapes, T² ordered above the module's one_hot_max_t broadcast
        # fallback (models/gnn.py). ALGORITHMIC terms only here — the
        # one-hot pair-selection/reconstruction matmuls are data movement
        # expressed as matmul and live in head_overhead_flops:
        # counting them as model FLOPs would inflate gnn MFU against the
        # convention every other model uses).
        adj_hidden, F = 64, H + N                 # models/gnn.py defaults
        f = 0.0
        for _ in range(cfg.gnn_blocks + 1):       # blocks + readout layer
            f += 2.0 * G * P * F * adj_hidden               # adjacency MLP
            f += 2.0 * G * P * adj_hidden * adj_hidden
            f += 2.0 * G * P * adj_hidden
            f += 2.0 * G * T * T * F                        # A @ x
            f += 2.0 * G * T * (2 * F) * cfg.gnn_dim        # gc dense
            F += cfg.gnn_dim
        return f
    if m == "snail":
        import math

        G, T = B * TQ, N * K + 1
        F = H + N
        f = 0.0
        levels = max(1, math.ceil(math.log2(T)))
        for kd, vd in ((64, 32), (256, 128), (512, 256)):  # att blocks
            f += 2.0 * G * T * F * (2 * kd + vd)
            f += 2 * 2.0 * G * T * T * (kd + vd)
            F += vd
            if (kd, vd) == (512, 256):
                break
            for _ in range(levels):               # TC block after att 1/2
                f += 2 * 2.0 * G * T * 2 * F * cfg.snail_tc_filters
                F += cfg.snail_tc_filters
        f += 2.0 * G * F * N                      # readout (query position)
        return f
    if m == "pair":
        return 2.0 * B * TQ * N * K * cfg.bert_hidden  # match head, [CLS]
    raise ValueError(f"no FLOPs model for model {cfg.model!r}")


def _gnn_one_hot_form(T: int) -> bool:
    """Whether models/gnn._AdjacencyMLP runs its one-hot form at ``T``
    nodes (above ONE_HOT_MAX_T it falls back to the broadcast pair form).
    Lazy import: flops accounting must not drag flax in for non-gnn use."""
    from induction_network_on_fewrel_tpu_torch.models.gnn import ONE_HOT_MAX_T

    return T <= ONE_HOT_MAX_T


def _gnn_mlp_pairs(T: int) -> int:
    """Rows the adjacency edge MLP processes per graph: the unordered
    upper triangle in the one-hot form, all T² ordered pairs in the
    broadcast fallback."""
    return T * (T - 1) // 2 if _gnn_one_hot_form(T) else T * T


def head_overhead_flops(cfg: ExperimentConfig, H: float) -> float:
    """Forward matmul FLOPs that are IMPLEMENTATION overhead, not model
    math — currently only the gnn's one-hot pair-selection and [T, T]
    reconstruction matmuls (models/gnn.py `_AdjacencyMLP`: gathers
    re-expressed as matmuls, the reference's form).
    Zero above the module's one_hot_max_t bound, where the broadcast
    fallback runs and no one-hot matmuls exist. Tracked separately so MFU
    keeps the algorithmic-FLOPs convention shared by every other model
    (achieved-matmul throughput = algorithmic + overhead)."""
    if cfg.model != "gnn":
        return 0.0
    B, N, K, TQ, _, _ = _geometry(cfg)
    G, T = B * TQ, N * K + 1
    if not _gnn_one_hot_form(T):
        return 0.0
    P = T * (T - 1) // 2
    F = H + N
    f = 0.0
    for _ in range(cfg.gnn_blocks + 1):
        f += 2 * 2.0 * G * P * T * F              # pair-select one-hots
        f += 2.0 * G * T * T * (P + 1)            # [T, T] reconstruction
        F += cfg.gnn_dim
    return f


def train_step_flops(cfg: ExperimentConfig) -> dict:
    """Analytic matmul FLOPs per optimizer step for ANY (encoder, model)
    config in the zoo. Returns {"forward", "train", "per_episode",
    "overhead_flops"}.

    "forward"/"train"/"per_episode" are ALGORITHMIC (MFU convention,
    comparable across models); "overhead_flops" is the
    train-time cost of matmuls that only exist as implementation artifacts
    (head_overhead_flops — the gnn one-hot select/reconstruct forms).
    Achieved-matmul throughput on such models is (train + overhead_flops)
    per step; MFU consumers must keep using the algorithmic fields.

    Train multipliers: 3x forward for everything trainable; a FROZEN BERT
    backbone on the token path costs 1x (forward only, no backward); with
    the feature cache the backbone is excluded entirely (encoded once at
    cache build, amortized to ~0 per step).
    """
    B, N, K, TQ, Ms, Mq = _geometry(cfg)
    if cfg.model == "pair":
        # B·TQ·N·K token-level pairs of length 2L through the backbone.
        M_pairs = B * TQ * N * K
        enc = encoder_forward_flops(cfg, M_pairs, L=2 * cfg.max_length)
        head = head_forward_flops(cfg, cfg.bert_hidden)
        enc_mult = 1.0 if cfg.bert_frozen else 3.0
        f_train = enc_mult * enc + 3.0 * head
        return {"forward": enc + head, "train": f_train,
                "per_episode": f_train / B, "overhead_flops": 0.0}
    M = Ms + Mq
    enc = encoder_forward_flops(cfg, M)
    H = (2 * cfg.lstm_hidden if cfg.encoder == "bilstm"
         else cfg.tfm_model if cfg.encoder == "transformer"
         else cfg.bert_hidden if cfg.encoder == "bert"
         else cfg.hidden_size)
    head = head_forward_flops(cfg, H)
    if cfg.encoder == "bert" and cfg.bert_frozen:
        enc_mult = 0.0 if cfg.feature_cache else 1.0
    else:
        enc_mult = 3.0
    f_train = enc_mult * enc + 3.0 * head
    # 3x like the head: a one-hot matmul's backward is another matmul.
    overhead = 3.0 * head_overhead_flops(cfg, H)
    return {"forward": enc + head, "train": f_train,
            "per_episode": f_train / B, "overhead_flops": overhead}


def bilstm_induction_train_flops(cfg: ExperimentConfig) -> dict:
    """Flagship wrapper (bench.py's headline contract): the general
    train_step_flops restricted to the bilstm induction config."""
    if cfg.encoder != "bilstm" or cfg.model != "induction":
        raise ValueError(
            "analytic FLOPs are derived for the bilstm induction flagship; "
            f"got encoder={cfg.encoder!r} model={cfg.model!r}"
        )
    return train_step_flops(cfg)
