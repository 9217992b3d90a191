"""Analytic per-component HBM bytes + FLOPs of one flagship train step.

A copy of ``induction_network_on_fewrel_tpu/utils/roofline.py``
(``step_components``, ``step_bytes``, ``lstm_residual_bytes``,
``main_param_count``, ``touched_rows``, ``projected_floor_ms``), formula
for formula: the arithmetic models the fused-kernel flagship step at a
config's residual knobs, whichever backend a process runs. The comms
terms of data parallel come with the comms ledger (ROADMAP queue A item
2).

Shapes: rows M = B*(N*K + N*Q); L tokens; D = word+2*pos; u LSTM
hidden/direction; A att_dim; C induction_dim; H ntn_slices; bf16
activations (2 B), f32 head and optimizer (4 B). ``remat_attn`` defaults
to True here: the port's attention backward always rebuilds the
projection from the forward's softmax statistics (K10 -> K11).

``projected_floor_ms`` divides each component by the card's rates: the
NVIDIA H100's data-sheet figures below (SXM part, dense), the figures
PERF.md's bounds use. The card may run under a lower power limit; the
floor is the data sheet's.
"""

from __future__ import annotations

from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig


def _residual_itemsize(cfg: ExperimentConfig, lstm_residuals: str | None) -> int:
    """Storage width (bytes) of the BiLSTM residual streams/checkpoints:
    "auto" follows the compute dtype, matching models/build's resolver."""
    if lstm_residuals is None:
        lstm_residuals = getattr(cfg, "lstm_residuals", "auto")
    if lstm_residuals == "auto":
        return 2 if cfg.compute_dtype == "bfloat16" else 4
    return {"f32": 4, "bf16": 2}[lstm_residuals]


def step_components(
    cfg: ExperimentConfig,
    remat_attn: bool | None = None,
    corpus_rows: int | None = None,
    lstm_cs_window: int | None = None,
    lstm_residuals: str | None = None,
) -> list[tuple[str, float, float]]:
    """[(component, bytes/step, flops/step)] for the flagship train step.

    ``corpus_rows``: the real distinct-row count when the caller has it
    (bounds the lazy-embed touched-row term; default = the synthetic
    fixture bound, which understates real 40-60k-row corpora).
    ``remat_attn`` None follows ``cfg.remat_attn``. The non-remat rows are
    the two-pass ledger (two-pass attention saving the [L, M, A]
    tanh projection); the remat rows model the recompute-in-backward path
    (ops/attn.py "xla_remat").
    ``lstm_cs_window`` / ``lstm_residuals``: None follows the
    config; window 0 is the full-residual kernel, W > 0 the
    windowed-cs remat (module doc). Both model the fused KERNEL design —
    the arithmetic describes the flagship step regardless of which
    backend the local process resolved to (same convention as the rest
    of this ledger).
    """
    if remat_attn is None:
        remat_attn = True
    if lstm_cs_window is None:
        lstm_cs_window = getattr(cfg, "lstm_cs_window", 0)
    B, N, K, Q, L = cfg.batch_size, cfg.n, cfg.k, cfg.q, cfg.max_length
    TQ = N * Q
    M = B * (N * K + TQ)
    D = cfg.word_dim + 2 * cfg.pos_dim
    u = cfg.lstm_hidden
    A = cfg.att_dim
    C = cfg.induction_dim
    H = cfg.ntn_slices
    bf, f32 = 2, 4

    emb_b = L * M * D * bf          # [L, M, D] bf16, the gathered embedding
    hs_b = L * M * 2 * u * bf       # [L, M, 2u] hidden states
    out_b = M * 2 * u * bf          # [M, 2u] sentence vectors
    rows: list[tuple[str, float, float]] = []

    # L3 embedding: id gathers read the table rows and write emb_t; the
    # windowed pos-offset matmul touches [L+1, L*P] windows (negligible).
    rows.append(("embed gather fwd (write emb + read table)", 2 * emb_b, 0))

    # BiLSTM residual streams: W = 0 saves the full [L, M, 2u]
    # cs stream (and the backward re-reads hs as a residual too); W > 0
    # saves one (h, c) checkpoint pair per W-step window — ceil(L/W)
    # blocks of [M, 2u] each, stored at the residual dtype. ONE home for
    # the formula: lstm_residual_bytes (the bench diet headline) — the
    # rows below must stay in sync with it by construction.
    W = min(int(lstm_cs_window), L) if lstm_cs_window else 0
    res_b = lstm_residual_bytes(cfg, lstm_cs_window, lstm_residuals)

    # Fused BiLSTM kernel FWD: reads emb_t once (gates computed in-kernel
    # from the 60-wide embedding), writes hs plus the residuals the
    # backward needs — the full cs stream (W=0; the hs-only variant was
    # evaluated and rejected, ops/lstm.py: the atanh reconstruction of c
    # from h is ill-conditioned at saturation) or the windowed (h, c)
    # checkpoint pairs (W>0, 1/W the write traffic).
    proj_f = 2 * L * M * D * (8 * u)          # input projection, both dirs
    rec_f = 2 * L * M * u * (4 * u) * 2       # recurrence h@whh, both dirs
    if W:
        rows.append((
            "bilstm kernel fwd (windowed-cs ckpts)",
            emb_b + hs_b + res_b, proj_f + rec_f,
        ))
    else:
        rows.append(("bilstm kernel fwd", emb_b + hs_b + res_b, proj_f + rec_f))

    att_f = 2 * L * M * 2 * u * A + 2 * L * M * 2 * u
    if remat_attn:
        # FWD: the two flat-matmul passes read hs twice and write the
        # sentence vectors + [M] softmax stats; the [L, M, A] projection
        # and [L, M] attention weights are NOT saved.
        rows.append((
            "self-attn fwd (remat: stats-only residual)",
            2 * hs_b + out_b + 2 * M * f32, att_f,
        ))
        # BWD: one-pass kernel — hs read once, dH written once, dout/out
        # read for the softmax-backward dot; projection + attention
        # weights rebuilt in on-chip memory (recompute adds ~1x the forward
        # projection FLOPs on top of the usual 2x-forward backward).
        rows.append((
            "self-attn bwd (kernel recompute)",
            2 * hs_b + 2 * out_b + 2 * M * f32, 3 * att_f,
        ))
    else:
        # Two-pass XLA attention saving the tanh projection: proj pass
        # reads hs, writes [L, M, A]; weighted-sum pass reads hs again.
        rows.append((
            "self-attn fwd", 2 * hs_b + L * M * A * bf + out_b, att_f
        ))
        # BWD re-reads hs three ways (softmax-backward dot, dW1, dH write)
        # plus the saved projection.
        rows.append(("self-attn bwd", 3 * hs_b + L * M * A * bf, 2 * att_f))

    # Episode head FWD (f32): induction transform + routing + NTN.
    ind_f = 2 * B * N * K * 2 * u * C + 3 * (2 * B * N * K * C * 2)
    qp_f = 2 * B * TQ * 2 * u * C
    ntn_f = 2 * B * N * C * C * H + 2 * B * TQ * N * C * H
    head_b = (B * (N * K + TQ) * 2 * u * f32      # enc rows f32
              + B * N * H * C * f32               # cM
              + B * TQ * N * H * f32)             # v
    rows.append(("episode head fwd (f32)", head_b, ind_f + qp_f + ntn_f))
    rows.append(("episode head bwd", 2 * head_b, 2 * (ind_f + qp_f + ntn_f)))

    # Kernel bwd. Full-cs (W=0): reads d(hs), hs, cs, emb; writes demb;
    # gates recomputed per step; dW/db accumulate in on-chip memory -> no HBM term.
    # Windowed (W>0): reads d(hs), the checkpoint pairs, and the emb
    # stream (the [W, tm, D] window block each recompute AND gradient
    # sweep share from on-chip memory); writes demb. The in-window state replay
    # costs one extra forward recurrence of FLOPs — cheap, the kernel is
    # bytes-bound (ops/lstm.py module doc).
    if W:
        rows.append((
            "bilstm kernel bwd (in-window recompute)",
            hs_b + res_b + 2 * emb_b,
            2 * (proj_f + rec_f) + proj_f + (proj_f + rec_f),
        ))
    else:
        rows.append((
            "bilstm kernel bwd (recompute gates)",
            2 * hs_b + res_b + 2 * emb_b, 2 * (proj_f + rec_f) + proj_f,
        ))
    rows.append(("embed scatter bwd (demb -> rows)", 2 * emb_b, 0))

    # Optimizer (f32): non-embedding params p, m, v read + write, grads
    # read. Lazy embed: only the batch's unique rows (<= M*L token ids,
    # bounded by the corpus) touch their table/moment rows.
    n_main = main_param_count(cfg)
    rows.append(("optimizer main (Adam, f32)", 7 * n_main * f32, 0))
    u_rows = touched_rows(cfg, corpus_rows)
    rows.append((
        "lazy embed rows (gather+Adam+scatter)",
        u_rows * cfg.word_dim * f32 * 8, 0,
    ))
    return rows


def main_param_count(cfg: ExperimentConfig) -> int:
    """Non-embedding (word-table-excluded) param count of the flagship
    BiLSTM induction model — the payload of the dp gradient all-reduce."""
    D = cfg.word_dim + 2 * cfg.pos_dim
    u, A, C, H, L = (
        cfg.lstm_hidden, cfg.att_dim, cfg.induction_dim, cfg.ntn_slices,
        cfg.max_length,
    )
    return (
        2 * D * 4 * u + 2 * u * 4 * u + 2 * 4 * u      # lstm
        + 2 * u * A + A                                 # attention
        + 2 * u * C + C + 2 * u * C + C                 # induction + qproj
        + H * C * C + H + 1                             # ntn
        + 2 * (2 * L) * cfg.pos_dim                     # pos tables
    )


# Distinct-row bound of the SYNTHETIC corpus fixtures (the shapes the
# ledger legs and bench CPU-fallback compile) — callers that know the real
# corpus (the token-cache lazy path has uids in hand) must pass it.
SYNTHETIC_CORPUS_ROWS = 2002


def touched_rows(cfg: ExperimentConfig, corpus_rows: int | None = None) -> int:
    """Unique word-table rows a step can touch: bounded by tokens per
    batch and by the corpus vocabulary. ``corpus_rows`` is the actual
    distinct-row count (len(uids)) when the caller knows it; the default
    is the synthetic-fixture bound — real FewRel corpora run ~40-60k rows,
    so leaving the default in place on real data understates the demb
    term several-fold."""
    bound = corpus_rows if corpus_rows else SYNTHETIC_CORPUS_ROWS
    return min(episode_rows(cfg) * cfg.max_length, bound)


def step_bytes(
    cfg: ExperimentConfig,
    remat_attn: bool | None = None,
    corpus_rows: int | None = None,
    lstm_cs_window: int | None = None,
    lstm_residuals: str | None = None,
) -> int:
    """Total analytic HBM bytes for one flagship train step."""
    return int(sum(
        b for _, b, _ in step_components(
            cfg, remat_attn, corpus_rows, lstm_cs_window, lstm_residuals
        )
    ))


# NVIDIA H100 SXM, data sheet: HBM bytes/s, dense bf16 tensor-core FLOP/s,
# f32 FLOP/s outside the tensor cores.
H100_HBM_BW = 3.35e12
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12


def projected_floor_ms(cfg: ExperimentConfig, bw: float = H100_HBM_BW,
                       flops: float | None = None, corpus_rows: int | None = None) -> float:
    """Analytic per-step time floor (ms): each component pays
    max(bytes/bw, flops/peak). ``flops`` defaults to the H100's peak for
    the config's compute dtype (bf16 on the tensor cores, else f32)."""
    if flops is None:
        flops = H100_BF16_FLOPS if cfg.compute_dtype == "bfloat16" else H100_F32_FLOPS
    return sum(max(b / bw, f / flops) * 1e3
               for _, b, f in step_components(cfg, corpus_rows=corpus_rows))


def lstm_residual_bytes(
    cfg: ExperimentConfig,
    lstm_cs_window: int | None = None,
    lstm_residuals: str | None = None,
) -> int:
    """Bytes/step the BiLSTM forward writes SOLELY for the backward (the
    diet headline bench.py stamps): the full [L, M, 2u] cs stream at
    W = 0, or the windowed (h, c) checkpoint pairs — 2 * ceil(L/W)
    blocks of [M, 2u] — at W > 0, in the resolved residual dtype. The
    user-facing hs stream is excluded (the forward writes it
    regardless)."""
    if lstm_cs_window is None:
        lstm_cs_window = getattr(cfg, "lstm_cs_window", 0)
    L, M = cfg.max_length, episode_rows(cfg)
    u = cfg.lstm_hidden
    res = _residual_itemsize(cfg, lstm_residuals)
    W = min(int(lstm_cs_window), L) if lstm_cs_window else 0
    if W:
        return 2 * (-(-L // W)) * M * 2 * u * res
    return L * M * 2 * u * res


def episode_rows(cfg: ExperimentConfig) -> int:
    """M: support + query sentence rows per batch."""
    return cfg.batch_size * (cfg.n * cfg.k + cfg.n * cfg.q)
