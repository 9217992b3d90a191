#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port's serving and training paths, at full width.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases (each prints its lines; any failed check raises and the process
exits non-zero; no phase catches a failure of its own):

1. Environment: torch / CUDA versions and the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``).
2. Build: compile every CUDA source in ``csrc/`` with nvcc (sm_90a), one
   process per source, all started together.
3. Kernel vs plain PyTorch version on the card at the flagship widths
   (L=40, D=60, u=128, 2u=256, A=64) for M in {1, 4, 16, 25, 200} (serving
   buckets, a 5x5 registration, a val/test batch), f32 and bf16, ragged
   row tiles, partial and fully masked rows; kernel, plain and library
   times (CUDA events) and the byte/operation bound. K1's library
   yardstick is cuDNN's f32 ``nn.LSTM`` run as K1 runs, ``.eval()`` under
   ``torch.no_grad()``; its train-mode forward is printed beside it. Each
   forward row prints its cluster launch plan (TM, C, CTAs), each K2 row
   its plan (ops/attn.py:attn_fwd_plan).
4. Main path: the flagship model (400 002 x 50 synthetic GloVe table, bf16
   encoder, f32 head, seeded fresh init) behind ``InferenceEngine``: one
   tenant of 5 relations registered at K=5, 64 requests answered through
   ``classify_batch`` in buckets 1, 4 and 16. The kernels' launch counts
   are zeroed just before and read just after; both must have launched.
   Logits are held against an engine on the same weights with the plain
   ("reference") backends on the same card.
5. Episode forward: B=4 episodes of 5-way 5-shot with 5 queries per class
   (200 encoder rows) through the kernels vs the plain backends.
6. Training kernels vs their plain versions: K7 (windowed BiLSTM forward),
   K8 (its backward: the cluster chain kernel, then the weight-gradient
   kernel ``lstm_wgrad``), K10 (attention forward with stats), K11
   (attention backward) at L=40, D=60, u=128, A=64, M in {16, 200} and a
   ragged M=100, f32 and bf16, W=8, a ragged window (W=6), both residual
   dtypes, a fully masked attention row; kernel, plain and library times
   and the bound. K8 and its cuDNN yardstick (f32 ``nn.LSTM`` forward +
   backward) are timed as the median of 5 repeats of 20 launches, with the
   spread printed. ``lstm_wgrad`` alone vs its plain version on the same
   da / h_prev streams (K8's hp and K6's shifted hs), timed.
6b. Attention kernels K2, K10, K11 vs their plain versions at M in {1, 4,
   16, 25, 200} at the flagship widths and at M in {16, 200} at D = 1280,
   A = 300 (past the old D <= 1024, A <= 256 limits), f32 and bf16, with a
   fully masked row (exact zeros, mx = -1e30, dn = 0) and K11 bitwise equal
   over two runs; times by CUDA events (``ms``) and the kernels' device
   time under torch.profiler (``device_ms``), the bound, the plain time and
   each launch's plan. K11 is two launches (token kernel, weight-gradient
   kernel) behind one wrapper call.
6c. The optimizer pair (``csrc/optim.cu``: ``optim_sumsq``, the global
   norm, and ``optim_update``, the clip, decay, moments and update of every
   tensor) vs the plain twin and the per-parameter loop on the flagship
   parameter list for every rule (adam, adamw, sgd) and word-table mode
   (shared, sgd, frozen): the update within 1e-6 of each tensor's scale,
   the norm bitwise equal over two runs; times for Adam with a shared table
   beside the bound (bytes), the plain versions and the library yardsticks
   (``get_total_norm``, ``Adam(fused=True)``, and ``clip_grad_norm_`` +
   ``Adam(fused=True)`` against the pair).
6d. The segment sum (``ops/segsum.py:segsum``: the word table's gradient,
   ``index_add_`` into zeros, f32 atomics; a library call, not a hand
   kernel) vs its plain version ``index_put_`` with accumulate (it sorts
   the ids) on the flagship batch's word ids; both device times beside
   the bound.
7. Full-residual kernels vs their plain versions: K4 (BiLSTM forward
   writing c every step) and K6 (its backward over the saved hs/cs: chain
   kernel, then ``lstm_wgrad``) at L=40, D=60, u=128, M in {16, 200} plus
   a ragged M=100, f32 and bf16, both residual dtypes; f32 K6 gradients vs
   f32 K8 (W=8) on the same inputs; kernel, plain and library times (K6
   as K8) and the bound. Every backward row prints its chain plan (TM, C,
   CTAs).
8. Split recurrence (kernels 2, 1, 3): the public ops API
   ``lstm_recurrence_grouped`` (Gc=2) and ``bilstm_recurrence_tm`` at
   L=40, u=128, M in {16, 200}, f32 and bf16, without grad (kernel 2) and
   forward + backward under autograd (kernels 1 and 3, and lstm_wgrad
   after kernel 3), launch counts
   zeroed just before and read just after; then each output vs the plain
   versions, kernel 3 vs its plain version on the same residuals, the
   time-major layout vs the grouped one fed the flipped input; times and
   bounds; the library yardstick, an f32 cuDNN ``nn.LSTM`` whose identity
   input weights make it compute ``bilstm_recurrence_tm``, held against
   kernel 2 and timed.
9. Training main path: ``FewShotTrainer`` built by the CLI's wiring at the
   flagship config (bf16 encoder, 400 002-row table, mse, W=8, bf16
   checkpoints, Adam, shared table, B=4 episodes = 200 encoder rows per
   step): step-0 gradients of every parameter vs the plain backends (every
   encoder and embedding gradient finite and nonzero); one CUDA-graph step
   vs one eager step from the same weights on the same batch, and one
   replay of the S=4 graph vs four replays of the S=1 graph on the same 4
   batches (parameters, moments and count within 1e-6 of their scale; in
   the word table only the elements whose gradient is within the atomics'
   rounding of zero are left out, and the table must have moved far above
   that bar); the grad probe's cosine to the all-f32 plain reference above
   0.99; 20 steps as graph replays at steps_per_call 1 with a val pass
   (the eval graph: K1, K2) and a best-checkpoint save, and 20 at
   steps_per_call 4, each run under torch.profiler with the wrappers'
   counts zeroed just before and read just after: the wrappers count the
   warm-up's and the capture's calls, the profiler's kernel records count
   the launches (K7, K8, K10, K11, lstm_wgrad and the optimizer pair once
   per step plus once per graph's warm-up, K1/K2 once per val batch plus
   the eval graph's warm-up, K4/K6 never; no index_put_ sort); the same
   20 steps with the plain backends from the same weights (per-step
   losses, and the means of each fused call's 4, within a band); ms/step
   and episodes/s; then ``cli.test_main`` reloads the best checkpoint and
   evaluates. Then the profiles: 5 eager steps (the earlier path) and the
   graph at steps_per_call 1 and 4: unprofiled ms/step, the host split
   (sample, copy, replay), the graph's memory pool, and under
   torch.profiler the device busy time and launches per step and each
   hand kernel's launches per replay (one per step each).
10. Training at ``lstm_cs_window=0`` (the full-residual route; bf16
   encoder, bf16 residuals, otherwise the flagship): step-0 gradients vs
   the plain backends and their cosine to the W=8 kernel route from the
   same weights on the same batch, one graph step vs one eager step and
   one S=4 replay vs four S=1 replays, 10 steps as graph replays at
   steps_per_call 1 and 4 (two replays of 4, then a one-step tail graph
   twice) counted as in phase 9 (K4, K6, K10, K11, lstm_wgrad and the
   optimizer pair, K7/K8 never), the same steps with the plain backends
   (losses within a band), ms/step and episodes/s beside the W=8 figure,
   and the same profiles.
11. A ``{"kernels": [...]}`` line for the fourteen hand kernels (one per
   Pallas body, the weight-gradient kernel of the backwards and the
   optimizer pair), a ``{"training_step": ...}`` line of the step's
   figures and the segment sum's, then the last line ``{"ok": true,
   "device": {...}}``.

Imports nothing of JAX. Exits non-zero without CUDA (rc 2), and when the
port's package is not beside it (rc 1, with a message naming the package).
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

try:
    from induction_network_on_fewrel_tpu_torch import cli
except ModuleNotFoundError as e:    # run from a directory without the port beside it
    if e.name != "induction_network_on_fewrel_tpu_torch":
        raise
    sys.exit("chip_smoke: the port's package induction_network_on_fewrel_tpu_torch is not "
             "beside this script; run it from the root of a checkout")
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.data import (
    GloveTokenizer,
    make_synthetic_fewrel,
    make_synthetic_glove,
)
from induction_network_on_fewrel_tpu_torch.kernels.build import LIBRARY, SOURCES
from induction_network_on_fewrel_tpu_torch.models.base import to_device
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.ops.attn import (
    attn_bwd,
    attn_bwd_plan,
    attn_bwd_reference,
    attn_fwd_cuda,
    attn_fwd_plan,
    attn_fwd_stats,
    attn_fwd_stats_reference,
    attn_reference,
)
from induction_network_on_fewrel_tpu_torch.ops.lstm import (
    bilstm_bwd_chain_reference,
    bilstm_full_bwd,
    bilstm_full_bwd_reference,
    bilstm_full_fwd,
    bilstm_full_fwd_reference,
    bilstm_infer_cuda,
    bilstm_recurrence_tm,
    bilstm_reference,
    bilstm_win_bwd,
    bilstm_win_bwd_reference,
    bilstm_win_fwd,
    bilstm_win_fwd_reference,
    bwd_plan,
    fwd_plan,
    lstm_recurrence_grouped,
    lstm_split_bwd,
    lstm_split_bwd_reference,
    lstm_split_fwd,
    lstm_split_fwd_reference,
    lstm_split_infer_cuda,
    lstm_split_infer_reference,
    lstm_wgrad,
    lstm_wgrad_reference,
)
from induction_network_on_fewrel_tpu_torch.models.build import batch_to_model_inputs
from induction_network_on_fewrel_tpu_torch.sampling.episodes import EpisodeSampler
from induction_network_on_fewrel_tpu_torch.serving.buckets import QUERY_DTYPES
from induction_network_on_fewrel_tpu_torch.serving.engine import InferenceEngine
from induction_network_on_fewrel_tpu_torch.ops.optim import (
    MOMENT_RULES,
    OptimHyper,
    make_workspace,
    optim_sumsq,
    optim_sumsq_reference,
    optim_update,
    optim_update_reference,
)
from induction_network_on_fewrel_tpu_torch.ops.segsum import segsum, segsum_reference
from induction_network_on_fewrel_tpu_torch.train.framework import FewShotTrainer, stack_batches
from induction_network_on_fewrel_tpu_torch.train.steps import (
    WORD_TABLE,
    batch_leaves,
    loss_and_metrics,
    make_grad_probe,
    make_multi_train_step,
    make_optimizer,
    make_train_step,
    train_step,
)
from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

L, D, U, A = 40, 60, 128, 64
H_DIM = 2 * U
# Phase 3's row counts: serving buckets 1, 4, 16, a 5x5 registration (25)
# and the val/test batch (200).
SERVE_ROWS = (1, 4, 16, 25, 200)
# Published H100 SXM peaks: HBM bytes/s, and
# FLOP/s by operand type (bf16 on the tensor cores, f32 on the CUDA cores).
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# Tolerances (max abs error, kernel vs plain version on the same inputs):
#   K1 f32  5e-5: the 188-term gate sums run in another order, and the
#           difference is carried through 40 recurrent steps; h is bounded
#           by 1, so this is ~100 f32 ulps of the output.
#   K2 f32  2e-5: 256-term projections and a 40-step online softmax vs the
#           two-pass form; outputs are averages of |H| <= 1.
#   bf16    8e-3 (both): each output is rounded to bf16 once from f32
#           values that differ by f32 rounding, so it may land one bf16
#           ulp apart (2^-8 for values in [0.5, 1)); 8e-3 is two ulps.
TOL = {
    ("K1", torch.float32): 5e-5, ("K1", torch.bfloat16): 8e-3,
    ("K2", torch.float32): 2e-5, ("K2", torch.bfloat16): 8e-3,
}
# Logits of the main path, kernel engine vs plain-backend engine: the bf16
# encoder outputs may differ by a bf16 ulp in a few elements, which the f32
# head carries into the logits; the bar is relative to the logits' scale.
LOGIT_REL_TOL = 2e-2


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` launches (CUDA
    events around the whole run, after 3 warm-up calls; L2 stays warm)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def median_ms(fn, repeats: int = 5, iters: int = 20) -> tuple[float, float, float]:
    """(median, min, max) over ``repeats`` runs of ``cuda_ms(fn, iters)``."""
    runs = sorted(cuda_ms(fn, iters) for _ in range(repeats))
    return runs[len(runs) // 2], runs[0], runs[-1]


def spread_text(t: tuple[float, float, float]) -> str:
    return f"{t[0]:.4f} (min {t[1]:.4f} max {t[2]:.4f} over 5 x 20)"


def bound(bytes_moved: float, op_times: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BPS
    return (max(t_bytes, op_times) * 1e3, "bytes" if t_bytes >= op_times else "operations")


def cudnn_infer_ms(M: int) -> float:
    """K1's yardstick: an f32 torch.nn.LSTM(bidirectional) run the way K1
    runs, ``.eval()`` under ``torch.no_grad()`` (cuDNN's inference
    forward; in bf16 it compacts its weights on every call); timed here,
    used nowhere in the port."""
    dev = torch.device("cuda")
    lstm = torch.nn.LSTM(D, U, bidirectional=True).to(dev).eval()
    lstm.flatten_parameters()
    x = torch.randn((L, M, D), device=dev)
    with torch.no_grad():
        return cuda_ms(lambda: lstm(x), 20)


def plan_text(M: int, D_in: int = D, W: int | None = None) -> str:
    """The cluster forward's launch plan at M rows (ops/lstm.py:fwd_plan),
    or, with a window W (0: saved streams), the backward chain's
    (ops/lstm.py:bwd_plan)."""
    p = fwd_plan(M, D_in, U) if W is None else bwd_plan(M, D_in, U, W)
    why = f" ({p.why})" if getattr(p, "why", "") else ""
    return f"plan TM={p.tm} C={p.cluster} CTAs={p.ctas} smem={p.smem}{why}"


def lstm_bound_parts(M: int, dt: torch.dtype) -> tuple[float, float]:
    """K1's (bytes, operation seconds)."""
    es = torch.finfo(dt).bits // 8
    G = 4 * U
    moved = L * M * D * es + 2 * D * G * es + 2 * G * 4 + 2 * U * G * 4 + L * M * H_DIM * es
    ops_in = 2 * 2 * L * M * D * G          # emb x W_ih, both directions (operand dtype)
    ops_rec = 2 * 2 * L * M * U * G         # h x W_hh, both directions (f32)
    return moved, ops_in / PEAK_FLOPS[dt] + ops_rec / PEAK_FLOPS[torch.float32]


def lstm_bound(M: int, dt: torch.dtype):
    return bound(*lstm_bound_parts(M, dt))


def attn_bound_parts(M: int, dt: torch.dtype, d: int = H_DIM, a: int = A) -> tuple[float, float]:
    """K2's (bytes, operation seconds) at width d, attention dim a."""
    es = torch.finfo(dt).bits // 8
    moved = L * M * d * es + M * L * 4 + d * a * 4 + a * 4 + M * d * es
    ops = 2 * L * M * d * a + 2 * L * M * a + 2 * L * M * d   # f32 math
    return moved, ops / PEAK_FLOPS[torch.float32]


def attn_bound(M: int, dt: torch.dtype, d: int = H_DIM, a: int = A):
    return bound(*attn_bound_parts(M, dt, d, a))


def attn_plan_text(M: int, d: int = H_DIM, a: int = A, which: str = "fwd") -> str:
    """The attention kernels' launch plan (ops/attn.py:attn_fwd_plan for
    K2/K10, attn_bwd_plan for K11)."""
    if which == "fwd":
        p = attn_fwd_plan(M, L, d, a)
        return (f"plan tile={p.tile} C={p.cluster} rows={p.rows} steps={p.steps} "
                f"chunk={p.chunk} CTAs={p.ctas} smem={p.smem}")
    p = attn_bwd_plan(M, L, d, a)
    return (f"plan tile={p.tile} CTAs={p.ctas} smem={p.smem} + wgrad CTAs={p.wgrad_ctas} "
            f"smem={p.wgrad_smem}")


def device_ms(fn, iters: int = 20) -> float:
    """Device time of ``fn`` per call in ms: its kernels' self device time
    under torch.profiler over ``iters`` calls, after 3 warm-up calls. Unlike
    ``cuda_ms`` it leaves out the host's time between launches, which a
    kernel of tens of microseconds does not hide."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages() if e.self_device_time_total > 0)
    return us / iters / 1e3


def kernel_checks(gen: torch.Generator) -> dict:
    """Phase 3: both kernels vs their plain versions at every shape/dtype:
    serving buckets M in {1, 4, 16}, a 5x5 registration (M=25) and the
    val/test batch (M=200)."""
    dev = torch.device("cuda")
    rows = {}
    infer_lib = {M: cudnn_infer_ms(M) for M in SERVE_ROWS}
    train_lib = {M: cudnn_lstm_ms(M, False)[0] for M in SERVE_ROWS}
    for M in SERVE_ROWS:
        print(f"[check] cuDNN f32 LSTM M={M}: no-grad eval forward (K1's yardstick) "
              f"{infer_lib[M]:.4f} ms; train-mode forward {train_lib[M]:.4f} ms", flush=True)
    for dt in (torch.float32, torch.bfloat16):
        for M in SERVE_ROWS:
            emb = (torch.randn((L, M, D), generator=gen) * 0.5).to(dev, dt)
            wih = (torch.randn((2, D, 4 * U), generator=gen) / D ** 0.5).to(dev, dt)
            b = (torch.randn((2, 1, 4 * U), generator=gen) * 0.1).to(dev)
            whh = (torch.randn((2, U, 4 * U), generator=gen) / U ** 0.5).to(dev)
            hs = bilstm_infer_cuda(emb, wih, b, whh)
            torch.cuda.synchronize()
            ref = bilstm_reference(emb, wih, b, whh)
            err1 = (hs.float() - ref.float()).abs().max().item()
            tol1 = TOL[("K1", dt)]
            if not (torch.isfinite(hs).all() and err1 <= tol1):
                raise AssertionError(f"K1 {dt} M={M}: max abs err {err1} > {tol1}")
            ms1 = cuda_ms(lambda: bilstm_infer_cuda(emb, wih, b, whh), 20)
            plain1 = cuda_ms(lambda: bilstm_reference(emb, wih, b, whh), 3)
            bd1, by1 = lstm_bound(M, dt)

            H = (torch.rand((L, M, H_DIM), generator=gen) * 2 - 1).to(dev, dt)
            lengths = torch.randint(1, L + 1, (M,), generator=gen)
            mask = (torch.arange(L)[None, :] < lengths[:, None]).float()
            if M > 1:
                mask[1] = 0.0                       # a fully masked row
            mask = mask.to(dev)
            w1 = (torch.randn((H_DIM, A), generator=gen) / H_DIM ** 0.5).to(dev)
            w2 = (torch.randn((A, 1), generator=gen) / A ** 0.5).to(dev)
            out = attn_fwd_cuda(H, mask, w1, w2)
            torch.cuda.synchronize()
            ref2 = attn_reference(H, mask, w1, w2)
            err2 = (out.float() - ref2.float()).abs().max().item()
            tol2 = TOL[("K2", dt)]
            if not (torch.isfinite(out).all() and err2 <= tol2):
                raise AssertionError(f"K2 {dt} M={M}: max abs err {err2} > {tol2}")
            if M > 1 and out[1].abs().max().item() != 0.0:
                raise AssertionError("K2: a fully masked row must give exact zeros")
            ms2 = cuda_ms(lambda: attn_fwd_cuda(H, mask, w1, w2), 20)
            plain2 = cuda_ms(lambda: attn_reference(H, mask, w1, w2), 20)
            bd2, by2 = attn_bound(M, dt)
            name = "bf16" if dt == torch.bfloat16 else "f32"
            rows[("K1", name, M)] = dict(err=err1, tol=tol1, ms=ms1, plain_ms=plain1,
                                         library_ms=infer_lib[M], bound_ms=bd1, bound_by=by1,
                                         train_library_ms=train_lib[M], plan=plan_text(M))
            rows[("K2", name, M)] = dict(err=err2, tol=tol2, ms=ms2, plain_ms=plain2,
                                         library_ms=None, bound_ms=bd2, bound_by=by2,
                                         plan=attn_plan_text(M))
            for k in ("K1", "K2"):
                r = rows[(k, name, M)]
                print(f"[check] {k} {name} M={M}: max_abs_err={r['err']:.3g} "
                      f"(tol {r['tol']:g}) ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                      f"library_ms={r['library_ms']} bound_ms={r['bound_ms']:.5f} "
                      f"({r['bound_by']}){' ' + r['plan'] if 'plan' in r else ''}", flush=True)
    return rows


# Training kernels, kernel vs plain version on the same inputs. Errors are
# relative to the largest magnitude of the plain output they compare:
#   f32   1e-4: sums of up to L*M = 8000 products (dW) taken in another
#         order, through 40 recurrent steps (K7, K8) or a 40-step softmax
#         (K10, K11); ~1000 f32 ulps of the largest value.
#   bf16  1e-2: outputs written in bf16 (hs, checkpoints, demb, dH, out)
#         may land one bf16 ulp (2^-8 = 3.9e-3 relative) apart; the f32
#         outputs (dW, stats) are held to the same bar, as their inputs
#         (hs, out) are bf16 values that may differ by that ulp.
TRAIN_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# f32 K6 vs f32 K8 gradients on the same inputs, relative to each output's
# max: the same arithmetic on the same f32 states, summed in other orders
# (the JAX package holds the two at 1e-6 in interpret mode).
K6_K8_TOL = 1e-5


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|), after a finite check."""
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite kernel output")
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def check_outputs(name: str, pairs: dict, tol: float) -> float:
    """Hold every (kernel, plain) output pair to ``tol``; return the
    largest abs error."""
    worst = 0.0
    for key, (got, want) in pairs.items():
        err, rel = rel_err(got, want)
        if rel > tol:
            raise AssertionError(f"{name} {key}: relative error {rel:.3g} > {tol}")
        worst = max(worst, err)
    return worst


def cudnn_lstm_ms(M: int, backward: bool) -> tuple[float, float, float]:
    """K7/K8's yardstick: an f32 torch.nn.LSTM(bidirectional) in train mode
    (cuDNN; in bf16 it compacts its weights on every call), forward, or
    forward + backward; timed here, used nowhere in the port. (median, min,
    max) of ``median_ms``."""
    dev = torch.device("cuda")
    lstm = torch.nn.LSTM(D, U, bidirectional=True).to(dev).train()
    lstm.flatten_parameters()
    x = torch.randn((L, M, D), device=dev, requires_grad=True)
    g = torch.randn((L, M, H_DIM), device=dev)

    def run():
        out, _ = lstm(x)
        if backward:
            torch.autograd.backward(out, g)
    return median_ms(run)


def win_fwd_bound(M: int, dt: torch.dtype, W: int, rdt: torch.dtype):
    nB = -(-L // W)
    ckpt = 2 * nB * M * H_DIM * (torch.finfo(rdt).bits // 8)
    t_bytes, t_ops = lstm_bound_parts(M, dt)
    return bound(t_bytes + ckpt, t_ops)


def win_bwd_bound(M: int, dt: torch.dtype, W: int, rdt: torch.dtype):
    es, rs, G = torch.finfo(dt).bits // 8, torch.finfo(rdt).bits // 8, 4 * U
    nB = -(-L // W)
    moved = (L * M * H_DIM * es + L * M * D * es + 2 * nB * M * H_DIM * rs      # dhs, emb, ckpts
             + 2 * D * G * es + 2 * G * 4 + 2 * U * G * 4                      # weights
             + 2 * L * M * D * es + (2 * D * G + 2 * G + 2 * U * G) * 4)        # demb, dW
    # Per step and direction: the gates once from the checkpoints (2MG(D+u)),
    # then da W_ih^T, da W_hh^T, emb^T da, h^T da (2MG(D+u) twice). The
    # emb x W_ih product runs in the operand dtype. The da and hp streams
    # that K8 hands to lstm_wgrad are its design's cost, not the function's
    # work, and are not counted here.
    ops_in = 2 * L * 2 * M * D * G
    ops_f32 = 2 * L * (2 * M * U * G + 4 * M * G * (D + U))
    return bound(moved, ops_in / PEAK_FLOPS[dt] + ops_f32 / PEAK_FLOPS[torch.float32])


def attn_stats_bound(M: int, dt: torch.dtype, d: int = H_DIM, a: int = A):
    t_bytes, t_ops = attn_bound_parts(M, dt, d, a)
    return bound(t_bytes + 2 * M * 4, t_ops)


def attn_bwd_bound(M: int, dt: torch.dtype, d: int = H_DIM, a: int = A):
    es = torch.finfo(dt).bits // 8
    moved = (2 * L * M * d * es + M * L * 4 + d * a * 4 + a * 4          # H, dH, mask, w
             + 2 * M * d * es + 2 * M * 4 + d * a * 4 + a * 4)         # out, dout, stats, dW
    ops = 3 * 2 * L * M * d * a + 6 * L * M * a + 6 * L * M * d          # f32 math
    return bound(moved, ops / PEAK_FLOPS[torch.float32])


# Phase 6b's shapes: the flagship widths at every serving and training row
# count, and one width past the kernels' old limits (D <= 1024, A <= 256):
# u = 640 (D = 1280) with A = 300.
ATTN_CASES = [(M, H_DIM, A) for M in SERVE_ROWS] + [(16, 1280, 300), (200, 1280, 300)]


def attn_checks(gen: torch.Generator) -> dict:
    """Phase 6b: K2, K10 and K11 vs their plain versions at ATTN_CASES, f32
    and bf16, each with a partly masked row and a fully masked one (M > 1):
    K2 at phase 3's tolerances, K10/K11 at TRAIN_TOL; the fully masked row
    gives out = 0, mx = -1e30, dn = 0 and dH = 0 exactly; K11 run twice must
    repeat bit for bit. Times: CUDA events around 20 calls as the other
    phases (``ms``, host time between launches included) and the kernels'
    device time under the profiler (``device_ms``), with the plan of each
    launch."""
    dev = torch.device("cuda")
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = "bf16" if dt == torch.bfloat16 else "f32"
        for M, d, a in ATTN_CASES:
            name = f"{dname} M={M} D={d} A={a}"
            tol = TRAIN_TOL[dt]
            H = (torch.rand((L, M, d), generator=gen) * 2 - 1).to(dev, dt)
            lengths = torch.randint(1, L + 1, (M,), generator=gen)
            mask = (torch.arange(L)[None, :] < lengths[:, None]).float()
            if M > 1:
                mask[1] = 0.0                       # a fully masked row
            mask = mask.to(dev)
            w1 = (torch.randn((d, a), generator=gen) / d ** 0.5).to(dev)
            w2 = (torch.randn((a, 1), generator=gen) / a ** 0.5).to(dev)
            dout = (torch.randn((M, d), generator=gen) * 0.1).to(dev, dt)
            out2 = attn_fwd_cuda(H, mask, w1, w2)
            out, mx, dn = attn_fwd_stats(H, mask, w1, w2)
            got11 = attn_bwd(H, mask, w1, w2, out, mx, dn, dout)
            again = attn_bwd(H, mask, w1, w2, out, mx, dn, dout)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got11, again)):
                raise AssertionError(f"K11 {name}: two runs differ")
            ref10 = attn_fwd_stats_reference(H, mask, w1, w2)
            err2 = (out2.float() - ref10[0].float()).abs().max().item()
            tol2 = TOL[("K2", dt)]
            if not (torch.isfinite(out2).all() and err2 <= tol2):
                raise AssertionError(f"K2 {name}: max abs err {err2} > {tol2}")
            live = mask.sum(1) > 0
            err10 = check_outputs(f"K10 {name}", {"out": (out, ref10[0]),
                                                  "mx": (mx[live], ref10[1][live]),
                                                  "dn": (dn, ref10[2])}, tol)
            ref11 = attn_bwd_reference(H, mask, w1, w2, out, mx, dn, dout)
            err11 = check_outputs(f"K11 {name}", dict(zip(("dH", "dw1", "dw2"),
                                                          zip(got11, ref11))), tol)
            if M > 1 and (out2[1].abs().max().item() != 0.0 or out[1].abs().max().item() != 0.0
                          or mx[1].item() != np.float32(-1e30) or dn[1].item() != 0.0
                          or got11[0][:, 1].abs().max().item() != 0.0):
                raise AssertionError(f"{name}: a fully masked row must give out=0, mx=-1e30, "
                                     "dn=0 and dH=0 exactly")
            calls = {
                "K2": (lambda: attn_fwd_cuda(H, mask, w1, w2),
                       lambda: attn_reference(H, mask, w1, w2), err2, tol2,
                       attn_bound(M, dt, d, a), attn_plan_text(M, d, a)),
                "K10": (lambda: attn_fwd_stats(H, mask, w1, w2),
                        lambda: attn_fwd_stats_reference(H, mask, w1, w2), err10, tol,
                        attn_stats_bound(M, dt, d, a), attn_plan_text(M, d, a)),
                "K11": (lambda: attn_bwd(H, mask, w1, w2, out, mx, dn, dout),
                        lambda: attn_bwd_reference(H, mask, w1, w2, out, mx, dn, dout), err11,
                        tol, attn_bwd_bound(M, dt, d, a), attn_plan_text(M, d, a, "bwd")),
            }
            for k, (fn, plain, err, tl, (bd, by), plan) in calls.items():
                r = dict(err=err, tol=tl, ms=cuda_ms(fn, 20), device_ms=device_ms(fn),
                         plain_ms=cuda_ms(plain, 20), library_ms=None, bound_ms=bd,
                         bound_by=by, plan=plan)
                rows[(k, name)] = r
                print(f"[attn] {k} {name}: max_abs_err={err:.3g} (tol {tl:g}"
                      f"{'' if k == 'K2' else ' rel'}) ms={r['ms']:.4f} "
                      f"device_ms={r['device_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                      f"library_ms=None bound_ms={bd:.5f} ({by}) {plan}"
                      f"{'; bitwise equal over two runs' if k == 'K11' else ''}", flush=True)
    return rows


def train_kernel_checks(gen: torch.Generator, library: dict) -> dict:
    """K7, K8, K10 and K11 vs their plain versions at the flagship widths,
    M in {16, 200}, f32 and bf16; W = 8 with residuals in the activation
    dtype, plus a ragged window (W = 6: 40 = 6*6 + 4), the other residual
    dtype, ragged row tiles (M = 100), and a fully masked attention row."""
    dev = torch.device("cuda")
    rows = {}
    cases = [(dt, M, 8, dt) for dt in (torch.float32, torch.bfloat16) for M in (16, 200)]
    cases += [(torch.bfloat16, 200, 6, torch.bfloat16), (torch.bfloat16, 16, 8, torch.float32),
              (torch.float32, 16, 8, torch.bfloat16), (torch.float32, 100, 8, torch.float32),
              (torch.bfloat16, 100, 8, torch.bfloat16)]
    for dt, M, W, rdt in cases:
        name = f"{'bf16' if dt == torch.bfloat16 else 'f32'} M={M} W={W} " \
               f"res={'bf16' if rdt == torch.bfloat16 else 'f32'}"
        tol = TRAIN_TOL[dt if rdt == dt else torch.bfloat16]
        emb = (torch.randn((L, M, D), generator=gen) * 0.5).to(dev, dt)
        wih = (torch.randn((2, D, 4 * U), generator=gen) / D ** 0.5).to(dev, dt)
        b = (torch.randn((2, 1, 4 * U), generator=gen) * 0.1).to(dev)
        whh = (torch.randn((2, U, 4 * U), generator=gen) / U ** 0.5).to(dev)
        dhs = (torch.randn((L, M, H_DIM), generator=gen) * 0.1).to(dev, dt)
        hs, ch, cc = bilstm_win_fwd(emb, wih, b, whh, W, rdt)
        torch.cuda.synchronize()
        ref = bilstm_win_fwd_reference(emb, wih, b, whh, W, rdt)
        err7 = check_outputs(f"K7 {name}", {"hs": (hs, ref[0]), "ch": (ch, ref[1]),
                                            "cc": (cc, ref[2])}, tol)
        # K8 and its plain version on the same checkpoints (the kernel's).
        got8 = bilstm_win_bwd(dhs, emb, ch, cc, wih, b, whh, W)
        torch.cuda.synchronize()
        ref8 = bilstm_win_bwd_reference(dhs, emb, ch, cc, wih, b, whh, W)
        err8 = check_outputs(f"K8 {name}", dict(zip(("demb", "dwih", "db", "dwhh"),
                                                    zip(got8, ref8))), tol)

        H = (torch.rand((L, M, H_DIM), generator=gen) * 2 - 1).to(dev, dt)
        lengths = torch.randint(1, L + 1, (M,), generator=gen)
        mask = (torch.arange(L)[None, :] < lengths[:, None]).float()
        mask[1] = 0.0                                   # a fully masked row
        mask = mask.to(dev)
        w1 = (torch.randn((H_DIM, A), generator=gen) / H_DIM ** 0.5).to(dev)
        w2 = (torch.randn((A, 1), generator=gen) / A ** 0.5).to(dev)
        dout = (torch.randn((M, H_DIM), generator=gen) * 0.1).to(dev, dt)
        out, mx, dn = attn_fwd_stats(H, mask, w1, w2)
        torch.cuda.synchronize()
        ref10 = attn_fwd_stats_reference(H, mask, w1, w2)
        live = mask.sum(1) > 0
        err10 = check_outputs(f"K10 {name}", {"out": (out, ref10[0]),
                                              "mx": (mx[live], ref10[1][live]),
                                              "dn": (dn, ref10[2])}, tol)
        if mx[1].item() != np.float32(-1e30) or dn[1].item() != 0.0 \
                or out[1].abs().max().item() != 0.0:
            raise AssertionError("K10: a fully masked row must give mx=-1e30, dn=0, out=0")
        got11 = attn_bwd(H, mask, w1, w2, out, mx, dn, dout)
        torch.cuda.synchronize()
        ref11 = attn_bwd_reference(H, mask, w1, w2, out, mx, dn, dout)
        err11 = check_outputs(f"K11 {name}", dict(zip(("dH", "dw1", "dw2"), zip(got11, ref11))),
                              tol)
        if got11[0][:, 1].abs().max().item() != 0.0:
            raise AssertionError("K11: a fully masked row must get exact-zero dH")

        r = {}
        r["K7"] = dict(err=err7, tol=tol, ms=cuda_ms(lambda: bilstm_win_fwd(emb, wih, b, whh, W, rdt), 10),
                       plain_ms=cuda_ms(lambda: bilstm_win_fwd_reference(emb, wih, b, whh, W, rdt), 2))
        k8 = median_ms(lambda: bilstm_win_bwd(dhs, emb, ch, cc, wih, b, whh, W))
        r["K8"] = dict(err=err8, tol=tol, ms=k8[0], spread=k8,
                       plain_ms=cuda_ms(lambda: bilstm_win_bwd_reference(dhs, emb, ch, cc, wih, b,
                                                                         whh, W), 1))
        r["K10"] = dict(err=err10, tol=tol, ms=cuda_ms(lambda: attn_fwd_stats(H, mask, w1, w2), 20),
                        plain_ms=cuda_ms(lambda: attn_fwd_stats_reference(H, mask, w1, w2), 20),
                        library_ms=None)
        r["K11"] = dict(err=err11, tol=tol,
                        ms=cuda_ms(lambda: attn_bwd(H, mask, w1, w2, out, mx, dn, dout), 20),
                        plain_ms=cuda_ms(lambda: attn_bwd_reference(H, mask, w1, w2, out, mx, dn,
                                                                    dout), 20),
                        library_ms=None)
        if M not in library:
            library[M] = (cudnn_lstm_ms(M, False), cudnn_lstm_ms(M, True))
            print(f"[check] cuDNN f32 LSTM train mode M={M}: forward {spread_text(library[M][0])}"
                  f" ms; forward + backward {spread_text(library[M][1])} ms", flush=True)
        r["K7"]["library_ms"], r["K8"]["library_ms"] = library[M][0][0], library[M][1][0]
        r["K7"]["plan"] = plan_text(M)
        r["K8"]["plan"] = plan_text(M, W=W)
        r["K10"]["plan"] = attn_plan_text(M)
        r["K11"]["plan"] = attn_plan_text(M, which="bwd")
        for k, (bd, by) in (("K7", win_fwd_bound(M, dt, W, rdt)), ("K8", win_bwd_bound(M, dt, W, rdt)),
                            ("K10", attn_stats_bound(M, dt)), ("K11", attn_bwd_bound(M, dt))):
            r[k].update(bound_ms=bd, bound_by=by)
            rows[(k, name)] = r[k]
            print(f"[check] {k} {name}: max_abs_err={r[k]['err']:.3g} (rel tol {tol:g}) "
                  f"ms={r[k]['ms']:.4f} plain_ms={r[k]['plain_ms']:.4f} "
                  f"library_ms={r[k]['library_ms']} bound_ms={bd:.5f} ({by})"
                  f"{' ' + r[k]['plan'] if 'plan' in r[k] else ''}"
                  f"{' ms ' + spread_text(r[k]['spread']) if 'spread' in r[k] else ''}", flush=True)
    return rows


def wgrad_bound(M: int, dt: torch.dtype, h_f32: bool):
    """lstm_wgrad: reads da (f32), emb, the h_prev source (hp in f32, or hs
    in the activation dtype) and W_ih once, writes demb and the weight
    gradients; f32 operations: demb = da W_ih^T, emb^T da, h^T da, sum da."""
    es, G, rows = torch.finfo(dt).bits // 8, 4 * U, L * M
    moved = (2 * rows * G * 4 + rows * D * es + 2 * rows * U * (4 if h_f32 else es)
             + 2 * D * G * es + 2 * rows * D * es + (2 * D * G + 2 * G + 2 * U * G) * 4)
    ops = 2 * (2 * rows * G * (2 * D + U) + rows * G)
    return bound(moved, ops / PEAK_FLOPS[torch.float32])


def hp_from_hs(hs: torch.Tensor) -> torch.Tensor:
    """The h_prev stream [2, L, M, u] (f32) that K6 reads from its saved hs:
    each direction's hs at the kernel-previous step, zero at the first."""
    hp = hs.new_zeros((2,) + hs.shape[:2] + (U,), dtype=torch.float32)
    hp[0, 1:] = hs[:-1, :, :U].float()
    hp[1, :-1] = hs[1:, :, U:].float()
    return hp


def wgrad_checks(gen: torch.Generator) -> dict:
    """The weight-gradient kernel alone vs its plain version on the same
    streams: da and K8's hp (f32), and da with K6's saved hs (read at the
    kernel-previous step), at M in {16, 200}, f32 and bf16; run twice, the
    outputs must repeat bit for bit (no atomics)."""
    dev = torch.device("cuda")
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        for M in (16, 200):
            emb = (torch.randn((L, M, D), generator=gen) * 0.5).to(dev, dt)
            wih = (torch.randn((2, D, 4 * U), generator=gen) / D ** 0.5).to(dev, dt)
            da = (torch.randn((2, L, M, 4 * U), generator=gen) * 0.1).to(dev)
            hp = (torch.rand((2, L, M, U), generator=gen) * 2 - 1).to(dev)
            hs = (torch.rand((L, M, H_DIM), generator=gen) * 2 - 1).to(dev, dt)
            tol = TRAIN_TOL[dt]
            for src, h, want_h in (("hp", hp, hp), ("hs", hs, hp_from_hs(hs))):
                name = f"{'bf16' if dt == torch.bfloat16 else 'f32'} M={M} {src}"
                got = lstm_wgrad(da, emb, h, wih)
                again = lstm_wgrad(da, emb, h, wih)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(got, again)):
                    raise AssertionError(f"lstm_wgrad {name}: two runs differ")
                ref = lstm_wgrad_reference(da, emb, want_h, wih)
                err = check_outputs(f"lstm_wgrad {name}", dict(zip(
                    ("demb", "dwih", "db", "dwhh"), zip(got, ref))), tol)
                bd, by = wgrad_bound(M, dt, src == "hp")
                r = dict(err=err, tol=tol, ms=cuda_ms(lambda: lstm_wgrad(da, emb, h, wih), 20),
                         plain_ms=cuda_ms(lambda: lstm_wgrad_reference(da, emb, want_h, wih), 20),
                         library_ms=None, bound_ms=bd, bound_by=by)
                rows[("wgrad", name)] = r
                print(f"[check] lstm_wgrad {name}: max_abs_err={err:.3g} (rel tol {tol:g}) "
                      f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms=None "
                      f"bound_ms={bd:.5f} ({by}); bitwise equal over two runs", flush=True)
    return rows


def full_fwd_bound(M: int, dt: torch.dtype, rdt: torch.dtype):
    """K4: K1's work plus c written at every step in the residual dtype."""
    t_bytes, t_ops = lstm_bound_parts(M, dt)
    return bound(t_bytes + L * M * H_DIM * (torch.finfo(rdt).bits // 8), t_ops)


def full_bwd_bound(M: int, dt: torch.dtype, rdt: torch.dtype):
    """K6: reads dhs, emb, hs, cs and the weights once, writes demb and the
    weight gradients; the operations are K8's (gates once, four products)."""
    es, rs, G = torch.finfo(dt).bits // 8, torch.finfo(rdt).bits // 8, 4 * U
    moved = (2 * L * M * H_DIM * es + L * M * D * es + L * M * H_DIM * rs     # dhs, hs, emb, cs
             + 2 * D * G * es + 2 * G * 4 + 2 * U * G * 4                     # weights
             + 2 * L * M * D * es + (2 * D * G + 2 * G + 2 * U * G) * 4)       # demb, dW
    ops_in = 2 * L * 2 * M * D * G
    ops_f32 = 2 * L * (2 * M * U * G + 4 * M * G * (D + U))
    return bound(moved, ops_in / PEAK_FLOPS[dt] + ops_f32 / PEAK_FLOPS[torch.float32])


def full_kernel_checks(gen: torch.Generator, library: dict) -> dict:
    """Phase 7: K4 and K6 vs their plain versions (K6's plain version on
    the kernel's own hs/cs) at the flagship widths, M in {16, 200} and a
    ragged M=100 (not a multiple of K4's 16-row or K6's 8-row tile), f32
    and bf16 with both residual dtypes; f32 K6 vs f32 K8 (W=8) gradients."""
    dev = torch.device("cuda")
    rows = {}
    err68 = 0.0
    cases = [(dt, M, dt) for dt in (torch.float32, torch.bfloat16) for M in (16, 200)]
    cases += [(torch.bfloat16, 100, torch.float32), (torch.float32, 100, torch.bfloat16)]
    for dt, M, rdt in cases:
        name = f"{'bf16' if dt == torch.bfloat16 else 'f32'} M={M} " \
               f"res={'bf16' if rdt == torch.bfloat16 else 'f32'}"
        tol = TRAIN_TOL[dt if rdt == dt else torch.bfloat16]
        emb = (torch.randn((L, M, D), generator=gen) * 0.5).to(dev, dt)
        wih = (torch.randn((2, D, 4 * U), generator=gen) / D ** 0.5).to(dev, dt)
        b = (torch.randn((2, 1, 4 * U), generator=gen) * 0.1).to(dev)
        whh = (torch.randn((2, U, 4 * U), generator=gen) / U ** 0.5).to(dev)
        dhs = (torch.randn((L, M, H_DIM), generator=gen) * 0.1).to(dev, dt)
        hs, cs = bilstm_full_fwd(emb, wih, b, whh, rdt)
        torch.cuda.synchronize()
        ref4 = bilstm_full_fwd_reference(emb, wih, b, whh, rdt)
        err4 = check_outputs(f"K4 {name}", {"hs": (hs, ref4[0]), "cs": (cs, ref4[1])}, tol)
        got6 = bilstm_full_bwd(dhs, emb, hs, cs, wih, b, whh)
        torch.cuda.synchronize()
        ref6 = bilstm_full_bwd_reference(dhs, emb, hs, cs, wih, b, whh)
        err6 = check_outputs(f"K6 {name}", dict(zip(("demb", "dwih", "db", "dwhh"),
                                                    zip(got6, ref6))), tol)
        if dt == rdt == torch.float32:
            # f32 residuals: K8's window replay is the forward's own f32
            # arithmetic, so both backwards see the same states; they sum in
            # other orders (per-step slabs vs replayed windows).
            _, ch, cc = bilstm_win_fwd(emb, wih, b, whh, 8, rdt)
            got8 = bilstm_win_bwd(dhs, emb, ch, cc, wih, b, whh, 8)
            torch.cuda.synchronize()
            err68 = max(err68, check_outputs(f"K6 vs K8 {name}", dict(zip(
                ("demb", "dwih", "db", "dwhh"), zip(got6, got8))), K6_K8_TOL))
        r = {}
        r["K4"] = dict(err=err4, tol=tol, ms=cuda_ms(lambda: bilstm_full_fwd(emb, wih, b, whh, rdt), 10),
                       plain_ms=cuda_ms(lambda: bilstm_full_fwd_reference(emb, wih, b, whh, rdt), 2))
        k6 = median_ms(lambda: bilstm_full_bwd(dhs, emb, hs, cs, wih, b, whh))
        r["K6"] = dict(err=err6, tol=tol, ms=k6[0], spread=k6,
                       plain_ms=cuda_ms(lambda: bilstm_full_bwd_reference(dhs, emb, hs, cs, wih,
                                                                          b, whh), 1))
        if M not in library:
            library[M] = (cudnn_lstm_ms(M, False), cudnn_lstm_ms(M, True))
        r["K4"]["library_ms"], r["K6"]["library_ms"] = library[M][0][0], library[M][1][0]
        r["K4"]["plan"] = plan_text(M)
        r["K6"]["plan"] = plan_text(M, W=0)
        for k, (bd, by) in (("K4", full_fwd_bound(M, dt, rdt)), ("K6", full_bwd_bound(M, dt, rdt))):
            r[k].update(bound_ms=bd, bound_by=by)
            rows[(k, name)] = r[k]
            print(f"[check] {k} {name}: max_abs_err={r[k]['err']:.3g} (rel tol {tol:g}) "
                  f"ms={r[k]['ms']:.4f} plain_ms={r[k]['plain_ms']:.4f} "
                  f"library_ms={r[k]['library_ms']} bound_ms={bd:.5f} ({by})"
                  f"{' ' + r[k]['plan'] if 'plan' in r[k] else ''}"
                  f"{' ms ' + spread_text(r[k]['spread']) if 'spread' in r[k] else ''}", flush=True)
    print(f"[check] K6 vs K8 (W=8) f32 gradients: max abs err {err68:.3g} (rel tol "
          f"{K6_K8_TOL:g})", flush=True)
    return rows


def split_bound(key: str, M: int, dt: torch.dtype):
    """Kernels 2, 1, 3 over 2 groups: xg (4u a row and group) streamed once,
    hs (u) written (kernel 2), plus cs (kernel 1); kernel 3 reads dhs, xg,
    hs, cs and writes dxg and dW_hh. f32 operations: the recurrent product
    per step and group (kernel 3: the gates once, da W_hh^T and h^T da)."""
    es, G = torch.finfo(dt).bits // 8, 4 * U
    rows, w = L * M * 2, 2 * U * G * 4
    if key == "split2":
        moved, prods = rows * (G + U) * es + w, 1
    elif key == "split1":
        moved, prods = rows * (G + 2 * U) * es + w, 1
    else:
        moved, prods = rows * (2 * G + 3 * U) * es + 2 * w, 3
    return bound(moved, prods * 2 * rows * U * G / PEAK_FLOPS[torch.float32])


def split_library(M: int, gen: torch.Generator) -> dict:
    """Kernels 2, 1 and 3's yardstick, timed here and used nowhere in the
    port: one f32 torch.nn.LSTM(8u, u, bidirectional=True) call (cuDNN)
    computes ``bilstm_recurrence_tm`` on [L, M, 8u] when its input weights
    are the identity blocks [I_4u | 0] (forward) and [0 | I_4u] (reverse),
    its biases zero and its recurrent weights W_hh[d]^T: the gate order is
    [i, f, g, o] in both, and the reverse direction walks time reversed with
    its output in natural time. The identity input product is exact in f32,
    and is work the kernels do not do (printed as its time at the f32 peak).
    Held against kernel 2 on the same input, then timed without grad
    (kernel 2), as a train-mode forward (kernel 1), and forward + backward
    (kernel 3)."""
    dev = torch.device("cuda")
    G = 4 * U
    lstm = torch.nn.LSTM(2 * G, U, bidirectional=True).to(dev).train()
    whh = (torch.randn((2, U, G), generator=gen) / U ** 0.5).to(dev)
    eye, zero = torch.eye(G, device=dev), torch.zeros((G, G), device=dev)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.cat([eye, zero], 1))
        lstm.weight_ih_l0_reverse.copy_(torch.cat([zero, eye], 1))
        lstm.weight_hh_l0.copy_(whh[0].T)
        lstm.weight_hh_l0_reverse.copy_(whh[1].T)
        for bias in (lstm.bias_ih_l0, lstm.bias_hh_l0, lstm.bias_ih_l0_reverse,
                     lstm.bias_hh_l0_reverse):
            bias.zero_()
    lstm.flatten_parameters()
    xg = (torch.randn((L, M, 2 * G), generator=gen) * 0.5).to(dev)
    g = (torch.randn((L, M, H_DIM), generator=gen) * 0.1).to(dev)
    with torch.no_grad():
        want = lstm_split_infer_cuda(xg, whh, True)
        got = lstm(xg)[0]
        torch.cuda.synchronize()
        err = check_outputs(f"cuDNN identity-input LSTM vs kernel 2 f32 M={M}",
                            {"hs": (got, want)}, TRAIN_TOL[torch.float32])
        infer = cuda_ms(lambda: lstm(xg), 10)
    x = xg.clone().requires_grad_()

    def fwd_bwd():
        torch.autograd.backward(lstm(x)[0], g)
    out = {"split2": infer, "split1": cuda_ms(lambda: lstm(x), 10), "split3": cuda_ms(fwd_bwd, 10)}
    eye_ms = 2 * 2 * L * M * 2 * G * G / PEAK_FLOPS[torch.float32] * 1e3
    print(f"[split] library yardstick M={M}: cuDNN f32 LSTM(8u, u) with identity input weights "
          f"equals kernel 2 (max abs err {err:.3g}); ms no-grad {out['split2']:.4f} forward "
          f"{out['split1']:.4f} forward+backward {out['split3']:.4f}; its identity input "
          f"product takes {eye_ms:.4f} ms of the forward at the f32 peak", flush=True)
    return out


def split_recurrence(gen: torch.Generator) -> dict:
    """Phase 8: the split-recurrence ops API on the card. The path (public
    calls, kernel backend, counts zeroed just before and read just after),
    then its outputs vs the plain backend, kernel 3 vs its plain version on
    the same residuals, and the time-major layout vs the grouped one fed
    the flipped input."""
    dev = torch.device("cuda")
    G = 4 * U
    cases = [(dt, M, tm) for dt in (torch.float32, torch.bfloat16) for M in (16, 200)
             for tm in (False, True)]
    inputs = {}
    for dt, M, tm in cases:
        shape = (L, M, 2 * G) if tm else (2, M, L, G)
        xg = (torch.randn(shape, generator=gen) * 0.5).to(dev, dt)
        whh = (torch.randn((2, U, G), generator=gen) / U ** 0.5).to(dev)
        ct = (torch.randn((L, M, H_DIM) if tm else (2, M, L, U), generator=gen) * 0.1).to(dev, dt)
        inputs[(dt, M, tm)] = (xg, whh, ct)

    def api(tm):
        return bilstm_recurrence_tm if tm else lstm_recurrence_grouped

    def run(xg, whh, ct, tm, backend):
        with torch.no_grad():
            h_nog = api(tm)(xg, whh, backend=backend)
        x, w = xg.clone().requires_grad_(), whh.clone().requires_grad_()
        h = api(tm)(x, w, backend=backend)
        torch.autograd.backward(h, ct)
        return h_nog, h.detach(), x.grad, w.grad

    torch.cuda.synchronize()
    for fn in SPLIT_KERNELS.values():
        fn.launches = 0
    outs = {case: run(*inp, case[2], "cuda") for case, inp in inputs.items()}
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in SPLIT_KERNELS.items()}
    print(f"[split] {len(cases)} calls without grad and {len(cases)} with forward + backward "
          f"through lstm_recurrence_grouped / bilstm_recurrence_tm: launches {launches}",
          flush=True)
    if any(n != len(cases) for n in launches.values()):
        raise AssertionError(f"split kernels launched {launches}, expected {len(cases)} each")

    rows, library = {}, {}
    for (dt, M, tm), (xg, whh, ct) in inputs.items():
        name = f"{'bf16' if dt == torch.bfloat16 else 'f32'} M={M} {'tm' if tm else 'grouped'}"
        tol = TRAIN_TOL[dt]
        h_nog, h, dx, dw = outs[(dt, M, tm)]
        ref = run(xg, whh, ct, tm, "reference")
        err2 = check_outputs(f"kernel 2 {name}", {"hs": (h_nog, ref[0])}, tol)
        # The autograd path: hs of kernel 1; the gradients went through
        # kernel 3 on kernel 1's residuals, the plain ones on the plain
        # forward's, which may differ by one bf16 ulp (the training band).
        err1 = check_outputs(f"kernel 1 {name}", {"hs": (h, ref[1])}, tol)
        check_outputs(f"split grads {name}", {"dxg": (dx, ref[2]), "dwhh": (dw, ref[3])},
                      tol if dt == torch.float32 else GRAD_REL_TOL)
        hs, cs = lstm_split_fwd(xg, whh, tm)
        got3 = lstm_split_bwd(ct, xg, hs, cs, whh, tm)
        torch.cuda.synchronize()
        ref1 = lstm_split_fwd_reference(xg, whh, tm)
        err1 = max(err1, check_outputs(f"kernel 1 {name}", {"hs": (hs, ref1[0]),
                                                             "cs": (cs, ref1[1])}, tol))
        err3 = check_outputs(f"kernel 3 {name}", dict(zip(("dxg", "dwhh"), zip(
            got3, lstm_split_bwd_reference(ct, xg, hs, cs, whh, tm)))), tol)
        if tm:
            flipped = torch.stack([xg[..., :G].transpose(0, 1),
                                   xg[..., G:].flip(0).transpose(0, 1)]).contiguous()
            with torch.no_grad():
                hg = lstm_recurrence_grouped(flipped, whh, backend="cuda")
            want = torch.cat([hg[0], hg[1].flip(1)], -1).transpose(0, 1)
            check_outputs(f"tm vs grouped layout {name}", {"hs": (h_nog, want)}, tol)
        r = {}
        r["split2"] = dict(err=err2, ms=cuda_ms(lambda: lstm_split_infer_cuda(xg, whh, tm), 10),
                           plain_ms=cuda_ms(lambda: lstm_split_infer_reference(xg, whh, tm), 2))
        r["split1"] = dict(err=err1, ms=cuda_ms(lambda: lstm_split_fwd(xg, whh, tm), 10),
                           plain_ms=cuda_ms(lambda: lstm_split_fwd_reference(xg, whh, tm), 2))
        r["split3"] = dict(err=err3, ms=cuda_ms(lambda: lstm_split_bwd(ct, xg, hs, cs, whh, tm), 10),
                           plain_ms=cuda_ms(lambda: lstm_split_bwd_reference(ct, xg, hs, cs, whh,
                                                                             tm), 1))
        if M not in library:
            library[M] = split_library(M, gen)
        for k in r:
            bd, by = split_bound(k, M, dt)
            r[k].update(tol=tol, library_ms=library[M][k], bound_ms=bd, bound_by=by)
            rows[(k, name)] = r[k]
            plan = f" {plan_text(M, 0, W=0 if k == 'split3' else None)}"
            print(f"[check] {k} {name}: max_abs_err={r[k]['err']:.3g} (rel tol {tol:g}) "
                  f"ms={r[k]['ms']:.4f} plain_ms={r[k]['plain_ms']:.4f} "
                  f"library_ms={r[k]['library_ms']:.4f} bound_ms={bd:.5f} ({by}){plan}",
                  flush=True)
    print("[split] time-major layout equals the grouped one fed the flipped input", flush=True)
    return {"rows": rows, "launches": launches}


# The optimizer pair vs its plain versions on the flagship parameter list
# (every rule x word-table mode): p, m and v within OPTIM_TOL of each
# tensor's scale (the same f32 formulas; nvcc contracts them into fused
# multiply-adds and the card's powf may round the bias corrections one ulp
# apart), the norm within OPTIM_TOL of the plain twin's (the same chunks, a
# different order inside each) and bitwise equal over two runs.
OPTIM_TOL = 1e-6
OPTIM_MODES = [(o, e) for o in ("adam", "adamw", "sgd") for e in ("shared", "sgd", "frozen")]
# The segment sum vs index_put_ with accumulate on the flagship batch's word
# ids: the same f32 terms per row in another order (atomics); the padding
# id's row sums thousands of terms, so the bar is relative to the output's
# largest magnitude.
SEGSUM_TOL = 1e-5


def optim_bytes(numels: list, rules: list) -> float:
    """Bytes the update must move: p, g, m, v read and p, m, v written for
    a tensor with moments, p and g read and p written otherwise."""
    return sum(n * 4 * (7 if r in MOMENT_RULES else 3) for n, r in zip(numels, rules))


def optim_checks(model, gen: torch.Generator) -> dict:
    """Phase 6c: the optimizer pair (``optim_sumsq``, ``optim_update``) vs
    the plain twin and the per-parameter loop on the flagship parameter
    list, for every rule and word-table mode, from random parameters,
    gradients and moments at update count 2000 (past the first staircase
    step); the clip engaged on every other mode. Times for Adam with a
    shared table, beside the bound, the plain versions and the library
    yardsticks (``get_total_norm``; ``Adam(fused=True)``; and the pair
    against ``clip_grad_norm_`` + ``Adam(fused=True)``)."""
    dev = torch.device("cuda")
    cfg = ExperimentConfig()
    hp = OptimHyper(cfg.lr, cfg.lr_gamma, cfg.lr_step_size, cfg.weight_decay, cfg.grad_clip)
    names = [n for n, _ in model.named_parameters()]
    shapes = [p.shape for p in model.parameters()]

    def rand(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    rows, timed = {}, None
    for idx, (o, e) in enumerate(OPTIM_MODES):
        table_rule = {"shared": o, "sgd": "sgd_plain", "frozen": "frozen"}[e]
        rules = [table_rule if n == WORD_TABLE else o for n in names]
        live = [i for i, r in enumerate(rules) if r != "frozen"]
        rl = [rules[i] for i in live]
        params = [rand(shapes[i], 0.1) for i in live]
        grads = [rand(shapes[i], 1e-3 if idx % 2 else 1e-2) for i in live]
        mus = [rand(shapes[i], 1e-3) if rules[i] in MOMENT_RULES else None for i in live]
        nus = [rand(shapes[i], 1e-3).square() if rules[i] in MOMENT_RULES else None
               for i in live]
        ws = make_workspace(params)
        norm = optim_sumsq(params, grads, ws)
        again = optim_sumsq(params, grads, ws)
        want = optim_sumsq_reference(params, grads)
        if not torch.equal(norm, again):
            raise AssertionError(f"optim_sumsq {o}/{e}: two runs differ ({norm} vs {again})")
        n_err, n_rel = rel_err(norm, want)
        if n_rel > OPTIM_TOL:
            raise AssertionError(f"optim_sumsq {o}/{e}: relative error {n_rel:.3g} > {OPTIM_TOL}")

        def clone(xs):
            return [None if x is None else x.clone() for x in xs]

        kp, km, kv, pp, pm, pv = (clone(x) for x in (params, mus, nus, params, mus, nus))
        k_count = torch.full((), 2000, dtype=torch.int64, device=dev)
        p_count = k_count.clone()
        optim_update(kp, grads, km, kv, rl, norm, k_count, hp, ws)
        optim_update_reference(pp, grads, pm, pv, rl, norm, p_count, hp)
        if int(k_count) != 2001 or int(p_count) != 2001:
            raise AssertionError(f"optim_update {o}/{e}: count {int(k_count)}, "
                                 f"plain {int(p_count)}")
        pairs = {f"{names[i]}.{w}": (a, b) for i, *trip in zip(live, kp, km, kv, pp, pm, pv)
                 for w, a, b in (("p", trip[0], trip[3]), ("m", trip[1], trip[4]),
                                 ("v", trip[2], trip[5])) if a is not None}
        err = check_outputs(f"optim_update {o}/{e}", pairs, OPTIM_TOL)
        clipped = float(norm) >= hp.grad_clip
        rows[(o, e)] = {"err": max(err, n_err), "norm": float(norm), "clipped": clipped}
        print(f"[optim] {o:5s} table {e:6s}: {len(live)} tensors, "
              f"{sum(p.numel() for p in params)} elements, norm {float(norm):.6g} "
              f"({'clip engaged' if clipped else 'no clip'}), norm vs twin rel {n_rel:.3g}, "
              f"update vs loop max abs err {err:.3g} (tol {OPTIM_TOL} of scale); sumsq bitwise "
              f"over two runs", flush=True)
        if (o, e) == ("adam", "shared"):
            timed = (params, grads, kp, km, kv, pp, pm, pv, rl, norm, k_count, p_count, ws)

    params, grads, kp, km, kv, pp, pm, pv, rl, norm, k_count, p_count, ws = timed
    numels = [p.numel() for p in params]
    n_all = sum(numels)
    sumsq_bound = bound(4 * n_all + 4, 3 * n_all / PEAK_FLOPS[torch.float32])
    update_bound = bound(optim_bytes(numels, rl), 20 * n_all / PEAK_FLOPS[torch.float32])
    # Device time under the profiler (``device_ms``) for the kernels, the
    # plain versions and the library calls alike: inside the step's graph
    # no host time separates the launches, and an eager call of a wrapper
    # (its host table, checks and ctypes call) takes longer on the host
    # than its kernel on the card. ``ms_events`` keeps the CUDA-event time
    # of the eager calls.
    ev_sumsq = cuda_ms(lambda: optim_sumsq(params, grads, ws), 20)
    ev_update = cuda_ms(lambda: optim_update(kp, grads, km, kv, rl, norm, k_count, hp, ws), 20)
    ms_sumsq = device_ms(lambda: optim_sumsq(params, grads, ws))
    ms_update = device_ms(lambda: optim_update(kp, grads, km, kv, rl, norm, k_count, hp, ws))
    plain_sumsq = device_ms(lambda: optim_sumsq_reference(params, grads), 5)
    plain_update = device_ms(
        lambda: optim_update_reference(pp, grads, pm, pv, rl, norm, p_count, hp), 5)
    lib_sumsq = (device_ms(lambda: torch.nn.utils.get_total_norm(grads))
                 if hasattr(torch.nn.utils, "get_total_norm") else None)
    lib_params = [torch.nn.Parameter(p.clone()) for p in params]
    for p, g in zip(lib_params, grads):
        p.grad = g.clone()
    adam = torch.optim.Adam(lib_params, lr=hp.lr, weight_decay=hp.weight_decay, fused=True)
    lib_update = device_ms(adam.step)

    def clip_and_adam():
        torch.nn.utils.clip_grad_norm_(lib_params, hp.grad_clip)
        adam.step()

    lib_pair = device_ms(clip_and_adam)
    print(f"[optim] adam/shared, {len(params)} tensors, {n_all} elements, device ms: sumsq "
          f"{ms_sumsq:.4f} (bound {sumsq_bound[0]:.4f}, plain twin {plain_sumsq:.4f}, "
          f"get_total_norm {'n/a' if lib_sumsq is None else f'{lib_sumsq:.4f}'}); update "
          f"{ms_update:.4f} (bound {update_bound[0]:.4f} by {update_bound[1]}, per-parameter loop "
          f"{plain_update:.4f}, Adam(fused=True) {lib_update:.4f}); pair "
          f"{ms_sumsq + ms_update:.4f} vs clip_grad_norm_ + Adam(fused=True) {lib_pair:.4f}; "
          f"eager calls by CUDA events: sumsq {ev_sumsq:.4f}, update {ev_update:.4f}", flush=True)
    err = max(r["err"] for r in rows.values())
    return {
        "optim_sumsq": {"err": err, "ms": ms_sumsq, "plain_ms": plain_sumsq,
                        "bound_ms": sumsq_bound[0], "bound_by": sumsq_bound[1],
                        "library_ms": lib_sumsq, "ms_events": ev_sumsq},
        "optim_update": {"err": err, "ms": ms_update, "plain_ms": plain_update,
                         "bound_ms": update_bound[0], "bound_by": update_bound[1],
                         "library_ms": lib_update, "ms_events": ev_update,
                         "pair_ms": ms_sumsq + ms_update, "clip_grad_norm_adam_fused_ms": lib_pair},
    }


def segsum_checks(model, support: dict, query: dict, gen: torch.Generator) -> dict:
    """Phase 6d: the segment sum (``segsum``: ``index_add_`` of the token
    rows into a zeroed f32 [V, D], a library call, not a hand kernel) vs
    its plain version (``index_put_`` with accumulate, what autograd of
    ``table[ids]`` ran before; it sorts the ids) on the flagship batch's
    word ids, time-major [L, M] as the embedding gathers them, with the
    cotangent a [..., :50] slice of a [L, M, 60] gradient as in the step's
    backward; both device times beside the bound."""
    dev = torch.device("cuda")
    V, Dw = model.embedding.word_embedding.shape
    words = np.concatenate([support["word"].reshape(-1, L), query["word"].reshape(-1, L)])
    ids = torch.from_numpy(words.T.copy()).long().to(dev)                 # [L, M]
    wide = (torch.randn(tuple(ids.shape) + (Dw + 10,), generator=gen) * 0.1).to(dev)
    cot = wide[..., :Dw]
    got, again = segsum(cot, ids, V), segsum(cot, ids, V)
    want = segsum_reference(cot, ids, V)
    err, rel = rel_err(got, want)
    run_diff = (got - again).abs().max().item()
    T = ids.numel()
    uniq, counts = torch.unique(ids, return_counts=True)
    print(f"[segsum] {T} tokens, {uniq.numel()} distinct rows of {V}, the most shared row "
          f"{int(counts.max())} tokens: index_add_ vs index_put_ max abs err {err:.3g} (rel "
          f"{rel:.3g}, tol {SEGSUM_TOL}); two runs differ by {run_diff:.3g} (f32 atomics)",
          flush=True)
    if rel > SEGSUM_TOL:
        raise AssertionError(f"segsum: relative error {rel:.3g} > {SEGSUM_TOL}")
    ms = device_ms(lambda: segsum(cot, ids, V))
    plain = device_ms(lambda: segsum_reference(cot, ids, V))
    b = bound(V * Dw * 4 + T * Dw * 4 + T * 8, T * Dw / PEAK_FLOPS[torch.float32])
    print(f"[segsum] device ms: index_add_ {ms:.4f} (zero fill included), bound {b[0]:.4f} "
          f"({b[1]}), index_put_ (plain) {plain:.4f}", flush=True)
    return {"err": err, "ms": ms, "plain_ms": plain, "bound_ms": b[0], "bound_by": b[1]}


# Training main path, kernel route vs the plain ("reference") backends from
# the same weights on the same batches. Both run the same bf16 encoder
# arithmetic, except that a bf16 value written by a kernel (hs, demb, dH,
# out) may land one bf16 ulp away from the plain version's, and the f32
# head and the optimizer carry that on:
#   step-0 gradients: max |g - g_ref| / max |g_ref| per parameter <= 5e-2,
#     the repo's bf16 band (tests/test_attn.py);
#   per-step losses: |loss - loss_ref| / loss_ref <= 2e-2 over 20 steps.
GRAD_REL_TOL = 5e-2
LOSS_REL_TOL = 2e-2
TRAIN_STEPS = 20
WORK_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"
TRAIN_KERNELS = {"K7": bilstm_win_fwd, "K8": bilstm_win_bwd, "K10": attn_fwd_stats, "K11": attn_bwd,
                 "K4": bilstm_full_fwd, "K6": bilstm_full_bwd, "wgrad": lstm_wgrad,
                 "optim_sumsq": optim_sumsq, "optim_update": optim_update,
                 "K1": bilstm_infer_cuda, "K2": attn_fwd_cuda}
STEP_KERNELS = ("K10", "K11", "wgrad", "optim_sumsq", "optim_update")
SPLIT_KERNELS = {"split2": lstm_split_infer_cuda, "split1": lstm_split_fwd, "split3": lstm_split_bwd,
                 "wgrad": lstm_wgrad}
# The training path's kernels by the name the profiler gives them: the
# BiLSTM bodies by their template's mode (forward Residuals 0/1/2: K1, K7,
# K4; backward BwdMode 0/1: K8, K6; PROJ true, which the split recurrence's
# kernels 1-3 do not take), the attention forward by its STATS flag (K2,
# K10), K11 by its token kernel and its weight-gradient kernel (one each
# per call). Under a CUDA graph the wrappers count only the warm-up's and
# the capture's calls, so the launches of a graph run are counted here.
PROFILED = {
    "K1": r"lstm_cluster_fwd_kernel<[^<>]*, true, 0>",
    "K7": r"lstm_cluster_fwd_kernel<[^<>]*, true, 1>",
    "K4": r"lstm_cluster_fwd_kernel<[^<>]*, true, 2>",
    "K8": r"lstm_cluster_bwd_kernel<[^<>]*, true, 0>",
    "K6": r"lstm_cluster_bwd_kernel<[^<>]*, true, 1>",
    "K2": r"attn_fwd_kernel<[^<>]*, false, \d+>",
    "K10": r"attn_fwd_kernel<[^<>]*, true, \d+>",
    "K11": r"attn_bwd_token_kernel<",
    "K11 wgrad": r"attn_wgrad_kernel<",
    "wgrad": r"lstm_wgrad_kernel<",
    "optim_sumsq": r"optim_sumsq_kernel\(",
    "optim_update": r"optim_update_kernel\(",
}
# The sorting scatter behind autograd of table[ids] (index_put_ with
# accumulate): no longer on the training path.
SORT_SCATTER = "indexing_backward_kernel"
# Two runs of the training state from the same weights on the same batches
# (the graph step vs the eager step; one S=4 replay vs four S=1 replays):
# every parameter and moment within 1e-6 of its scale, the count equal. The
# word table's gradient is index_add_'s sum in f32 atomics order, which
# changes from run to run: an element whose gradient is within that
# rounding of zero may take Adam's step (lr * m / (sqrt(v) + eps), ~ +-lr at
# the first step) either way. Those elements alone are left out of the
# table's bar: a nonzero second moment whose root is below TABLE_LOOSE of
# the table's largest (at the first step, |g| < 1e-6 max |g|). The table's
# moments are linear and quadratic in that gradient, so they are held to the
# segment sum's own bar (SEGSUM_TOL): the padding id's row sums ~1800 terms,
# and two atomics orders put the moments 1.4e-6 to 3.2e-6 of their scale
# apart on the card (the H100). The table's change must be far above the parameters' bar, so a
# step that never applied the table's update would fail it.
GRAPH_PARAM_TOL = 1e-6
TABLE_LOOSE = 1e-6
# Training at lstm_cs_window=0 vs the W=8 kernel route from the same
# weights on the same batch: bf16 residuals at every step against bf16
# checkpoint seeds; the JAX band for bf16 residuals (tests/test_lstm.py:517).
W0_COSINE_MIN = 0.999
W0_STEPS = 10
# The grad probe's cosine, the bf16 kernel route's gradient against the
# all-f32 plain reference on the same batch: the bf16 rounding of the
# encoder's activations and residuals (the JAX probe's health signal; a
# sanity floor, not a kernel tolerance).
PROBE_COSINE_MIN = 0.99
GRAD_PARAMS = ("embedding.word_embedding", "embedding.pos1_embedding", "embedding.pos2_embedding",
               "encoder.w_ih", "encoder.w_hh", "encoder.bias", "encoder.att_w1", "encoder.att_w2")


def batch_grads(model, cfg, batch) -> dict[str, torch.Tensor]:
    """Gradients of the training loss on one batch (no update)."""
    support, query, label = batch_to_model_inputs(batch)
    model.zero_grad(set_to_none=True)
    loss, _ = loss_and_metrics(model, to_device(support, "cuda"), to_device(query, "cuda"),
                               torch.as_tensor(label).cuda(), cfg.loss)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return grads


def train_records(path: Path) -> list[dict]:
    return [r for r in map(json.loads, path.read_text().splitlines()) if r["kind"] == "train"]


def profile_rows(prof) -> list:
    from torch.autograd import DeviceType

    return sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  key=lambda r: -r[1])


def profile_eager_steps(trainer, steps: int = 5, tag: str = "profile eager") -> dict:
    """torch.profiler over ``steps`` eager training steps (``train_step``,
    the parent's path) of the trainer's model: device time by kernel, and
    the device's busy share of the wall time (the sum of kernel times over
    the synchronized wall; one stream, so kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    batches = [batch_to_model_inputs(trainer.train_sampler.sample_batch()) for _ in range(steps)]
    train_step(trainer.model, trainer.opt, trainer.cfg, *batches[0])     # warm
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for b in batches:
            train_step(trainer.model, trainer.opt, trainer.cfg, *b)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    rows = profile_rows(prof)
    busy = sum(r[1] for r in rows)
    print(f"[{tag}] {steps} steps under the profiler: wall {wall_us / steps / 1e3:.2f} ms/step, "
          f"{sum(r[2] for r in rows) // steps} kernel launches/step, device busy "
          f"{busy / steps / 1e3:.2f} ms/step ({busy / wall_us:.1%} of wall)", flush=True)
    for key, us, n in rows[:15]:
        print(f"[{tag}]   {us / steps / 1e3:8.3f} ms/step {n // steps:4d}x  {key[:90]}", flush=True)
    return {"busy_ms": busy / steps / 1e3, "launches": sum(r[2] for r in rows) / steps}


def profiled_counts(rows: list) -> dict:
    """Launches of each PROFILED kernel among the profiler's rows."""
    return {k: sum(n for key, _, n in rows if re.search(pat, key)) for k, pat in PROFILED.items()}


def no_sort_scatter(rows: list, tag: str) -> None:
    if any(SORT_SCATTER in key for key, _, _ in rows):
        raise AssertionError(f"{tag}: {SORT_SCATTER} ran: the table gradient took index_put_'s "
                             f"sort")


def profile_graph_steps(trainer, on: tuple, calls: int = 8, tag: str = "profile graph") -> dict:
    """The trainer's CUDA-graph step (``steps_per_call`` steps a replay):
    unprofiled ms/step over ``calls`` replays with the host split (sample:
    the episode batches drawn and stacked on the host; copy: into the pinned
    buffers and the device copies enqueued, including the wait for the
    previous call's copies; replay: ``graph.replay()`` returning), then
    ``calls`` more under torch.profiler: device busy and launches per step,
    and each kernel of ``on`` launched once per step (K11's two kernels
    each once), every other PROFILED kernel never."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    spc = trainer.cfg.steps_per_call
    graphs = trainer.multi_train_step if spc > 1 else trainer.train_step.graphs
    sampler = trainer.train_sampler

    def sample():
        return batch_leaves(*stack_batches([batch_to_model_inputs(sampler.sample_batch())
                                            for _ in range(spc)]))

    captured = graphs.captured(sample())
    split = {"sample": 0.0, "copy": 0.0, "replay": 0.0}
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    for _ in range(calls):
        t0 = time.perf_counter()
        leaves = sample()
        t1 = time.perf_counter()
        captured.fill(leaves)
        t2 = time.perf_counter()
        captured.graph.replay()
        t3 = time.perf_counter()
        split["sample"] += t1 - t0
        split["copy"] += t2 - t1
        split["replay"] += t3 - t2
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t_start) / (calls * spc) * 1e3
    split = {k: v / (calls * spc) * 1e3 for k, v in split.items()}
    stacked = [sample() for _ in range(calls)]
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for leaves in stacked:
            captured.fill(leaves)
            captured.graph.replay()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    rows = profile_rows(prof)
    steps = calls * spc
    busy = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows) / steps
    print(f"[{tag}] steps_per_call={spc}: unprofiled {step_ms:.3f} ms/step -> "
          f"{trainer.cfg.batch_size * 1e3 / step_ms:.1f} episodes/s; host split per step: sample "
          f"{split['sample']:.3f} ms, copy {split['copy']:.3f} ms, replay {split['replay']:.3f} "
          f"ms; graph pool {graphs.pool_bytes / 2**20:.1f} MiB", flush=True)
    print(f"[{tag}] {steps} steps under the profiler: wall {wall_us / steps / 1e3:.3f} ms/step, "
          f"{launches:.1f} launches/step, device busy {busy / steps / 1e3:.3f} ms/step "
          f"({busy / wall_us:.1%} of wall)", flush=True)
    for key, us, n in rows[:15]:
        print(f"[{tag}]   {us / steps / 1e3:8.4f} ms/step {n / steps:6.2f}x  {key[:90]}",
              flush=True)
    if not rows:
        raise AssertionError("the profiler saw no kernel in the graph replays")
    per_replay = {k: n / calls for k, n in profiled_counts(rows).items()}
    print(f"[{tag}] hand kernels per replay of {spc} steps: {per_replay}", flush=True)
    want = {k: float(spc if k.split()[0] in on else 0) for k in PROFILED}
    if per_replay != want:
        raise AssertionError(f"kernels per replay {per_replay}, expected {want}")
    no_sort_scatter(rows, tag)
    return {"step_ms": step_ms, "episodes_per_s": trainer.cfg.batch_size * 1e3 / step_ms,
            "split": split, "busy_ms": busy / steps / 1e3, "launches": launches,
            "busy_share": busy / wall_us, "pool_bytes": graphs.pool_bytes}


def graphs_of(single, multi) -> int:
    """CUDA graphs captured by a trainer's single-step callable (its
    ``GraphSteps`` in ``.graphs``) and its multi-step ``GraphSteps``."""
    return len(single.graphs.graphs) + (len(multi.graphs) if multi is not None else 0)


def grad_cosine(ga: dict, gb: dict) -> float:
    """Global cosine of two gradient sets (the JAX grad-probe reduction)."""
    num = sum(float((ga[k].double() * gb[k].double()).sum()) for k in ga)
    na = sum(float(ga[k].double().square().sum()) for k in ga) ** 0.5
    nb = sum(float(gb[k].double().square().sum()) for k in gb) ** 0.5
    return num / (na * nb + 1e-30)


def table_held(opt, i: int) -> torch.Tensor:
    """The word-table elements held to GRAPH_PARAM_TOL (TABLE_LOOSE),
    from the reference run's second moment of parameter ``i``."""
    nu = opt.nu[i]
    if nu is None:
        return torch.ones_like(opt.params[i], dtype=torch.bool)
    r = nu.sqrt()
    return ~((r > 0) & (r < TABLE_LOOSE * r.max()))


def hold_state(tag: str, got: tuple, want: tuple, table0: torch.Tensor) -> dict:
    """Hold the training state of run ``got`` (model, optimizer) to run
    ``want`` from the same weights (``table0``: the word table before):
    the count equal; every parameter and moment within GRAPH_PARAM_TOL of
    its scale, the word table's and its moments' on the ``table_held``
    elements (its moments within SEGSUM_TOL); the table's change far above
    that bar in both runs."""
    (model, opt), (_, ref) = got, want
    if int(opt.count) != int(ref.count):
        raise AssertionError(f"{tag}: count {int(opt.count)} != {int(ref.count)}")
    names = [n for n, _ in model.named_parameters()]
    it = names.index(WORD_TABLE)
    held = table_held(ref, it)
    worst, worst_table = 0.0, 0.0
    for i, name in enumerate(names):
        for what, a, b in (("", opt.params[i], ref.params[i]), (" m", opt.mu[i], ref.mu[i]),
                           (" v", opt.nu[i], ref.nu[i])):
            if b is None:
                continue
            a, b = a.detach(), b.detach()
            tol = GRAPH_PARAM_TOL
            if i == it:
                a, b = a[held], b[held]
                tol = SEGSUM_TOL if what else GRAPH_PARAM_TOL
            _, rel = rel_err(a, b)
            if rel > tol:
                raise AssertionError(f"{tag}: {name}{what} relative error {rel:.3g} > {tol}")
            if i == it and what:
                worst_table = max(worst_table, rel)
            else:
                worst = max(worst, rel)
    scale = ref.params[it].detach()[held].abs().max().item()
    moved = [(p.params[it].detach() - table0)[held].abs().max().item() for p in (opt, ref)]
    if min(moved) <= 100 * GRAPH_PARAM_TOL * scale:
        raise AssertionError(f"{tag}: the word table moved by {moved} (got, want), not far above "
                             f"the bar {GRAPH_PARAM_TOL * scale:.3g}: was its update applied?")
    left_out = int((~held).sum())
    print(f"[{tag}] count {int(opt.count)}; parameters and moments worst rel {worst:.3g} (tol "
          f"{GRAPH_PARAM_TOL} of scale), the word table's on all but {left_out} of "
          f"{held.numel()} elements (gradient within the atomics' rounding of zero), its "
          f"moments {worst_table:.3g} (tol {SEGSUM_TOL}); the table moved by {moved[0]:.3g} / "
          f"{moved[1]:.3g}", flush=True)
    return {"state_rel": worst, "table_moments_rel": worst_table, "table_left_out": left_out,
            "table_moved": moved[1]}


def graph_vs_eager(cfg, vocab, batch) -> dict:
    """One update of the graph step (``make_train_step``) against one eager
    ``train_step`` from the same fresh weights on the same batch."""
    eager, graph = (build_model(cfg, glove_init=vocab.vectors) for _ in range(2))
    opt_e, opt_g = make_optimizer(cfg, eager), make_optimizer(cfg, graph)
    table0 = eager.embedding.word_embedding.detach().clone()
    me = train_step(eager, opt_e, cfg, *batch)
    mg = make_train_step(graph, opt_g, cfg)(*batch)
    loss_rel = abs(float(mg["loss"]) - float(me["loss"])) / abs(float(me["loss"]))
    norm_rel = abs(float(mg["grad_norm"]) - float(me["grad_norm"])) / float(me["grad_norm"])
    print(f"[graph] W={cfg.lstm_cs_window}: one graph step vs one eager step from the same "
          f"weights: loss rel diff {loss_rel:.3g}, grad norm rel diff {norm_rel:.3g}", flush=True)
    if loss_rel > GRAPH_PARAM_TOL or norm_rel > GRAPH_PARAM_TOL:
        raise AssertionError(f"graph step: loss {loss_rel:.3g} or norm {norm_rel:.3g} differs")
    held = hold_state(f"graph W={cfg.lstm_cs_window}", (graph, opt_g), (eager, opt_e), table0)
    return {**held, "loss_rel": loss_rel, "norm_rel": norm_rel}


def fused_vs_single(cfg, vocab, batches: list) -> dict:
    """One replay of the S=4 graph (``make_multi_train_step``) against four
    replays of the S=1 graph (``make_train_step``) from the same fresh
    weights on the same 4 batches: the 4 losses and norms, then the state
    (``hold_state``)."""
    single, fused = (build_model(cfg, glove_init=vocab.vectors) for _ in range(2))
    opt_s, opt_f = make_optimizer(cfg, single), make_optimizer(cfg, fused)
    table0 = single.embedding.word_embedding.detach().clone()
    step = make_train_step(single, opt_s, cfg)
    ms = [step(*b) for b in batches]
    mf = make_multi_train_step(fused, opt_f, cfg)(*stack_batches(batches))
    worst = 0.0
    for key in ("loss", "grad_norm"):
        want = torch.stack([m[key] for m in ms]).float()
        _, rel = rel_err(mf[key].float(), want)
        worst = max(worst, rel)
        if rel > GRAPH_PARAM_TOL:
            raise AssertionError(f"S=4 replay vs 4 S=1 replays: {key} relative error {rel:.3g}")
    print(f"[fused] W={cfg.lstm_cs_window}: one S={len(batches)} replay vs {len(batches)} S=1 "
          f"replays from the same weights on the same batches: losses and norms rel "
          f"{worst:.3g} (tol {GRAPH_PARAM_TOL})", flush=True)
    held = hold_state(f"fused W={cfg.lstm_cs_window}", (fused, opt_f), (single, opt_s), table0)
    return {**held, "metrics_rel": worst}


def run_trainer(trainer, steps: int, on: tuple, evals: int = 0) -> tuple[dict, dict, list]:
    """``trainer.train(steps)``, the main path, under torch.profiler, with the wrappers' counts zeroed just before and read
    just after. A wrapper counts the calls that launch its kernel: under a
    graph, the warm-up's and the capture's, not the replays. So every
    wrapper of ``on`` must have counted and every other none, and the
    launches are counted from the profiler's records of this run: each
    kernel of ``on`` once per step plus once per captured graph's warm-up
    (an eager forward and backward and one optimizer pair), the eval
    kernels (K1, K2) once per evaluated batch (``evals``) plus once per
    eval graph's warm-up. Returns (profiled launches, wrapper counts, the
    [train] records)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    for fn in TRAIN_KERNELS.values():
        fn.launches = 0
    with contextlib.redirect_stderr(io.StringIO()), \
            torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train(steps)                # the [train]/[val] lines; read back below
        torch.cuda.synchronize()
    wrapped = {k: fn.launches for k, fn in TRAIN_KERNELS.items()}
    if sorted(k for k, n in wrapped.items() if n) != sorted(on):
        raise AssertionError(f"kernel wrappers launched {wrapped}, expected exactly {on}")
    rows = profile_rows(prof)
    launches = profiled_counts(rows)
    n_train = graphs_of(trainer.train_step, trainer.multi_train_step)
    n_eval = graphs_of(trainer.eval_step, trainer.multi_eval_step)
    want = {k: (0 if k.split()[0] not in on else
                evals + n_eval if k in ("K1", "K2") else steps + n_train) for k in PROFILED}
    if launches != want:
        raise AssertionError(f"training kernels launched {launches} (profiler), expected {want} "
                             f"({steps} steps, {n_train} train graphs, {evals} eval batches, "
                             f"{n_eval} eval graphs)")
    no_sort_scatter(rows, "main path")
    trainer.close()
    return launches, wrapped, train_records(trainer.logger.path)


def losses_vs(recs: list, ref_recs: list, tag: str) -> tuple[np.ndarray, float]:
    """Per-step losses (one [train] record per dispatch: a fused record is
    the mean of its steps) against the plain-backend run's at the same
    steps."""
    ref = {r["step"]: r["loss"] for r in ref_recs}
    losses = np.array([r["loss"] for r in recs])
    if not np.isfinite(losses).all():
        raise AssertionError(f"{tag}: non-finite training loss")
    steps = [r["step"] for r in recs]
    spans = np.diff([0] + steps)
    ref_means = np.array([np.mean([ref[t] for t in range(s - n + 1, s + 1)])
                          for s, n in zip(steps, spans)])
    rel = float(np.max(np.abs(losses - ref_means) / ref_means))
    if rel > LOSS_REL_TOL:
        raise AssertionError(f"{tag}: training losses disagree: {rel} > {LOSS_REL_TOL}")
    return losses, rel


def step_ms_of(recs: list, batch_size: int, skip: int) -> float:
    """Median ms/step over the [train] records after the first ``skip``."""
    spans = np.diff([0] + [r["step"] for r in recs])
    ms = [n * batch_size / r["episodes_per_s"] * 1e3 / n for r, n in zip(recs, spans)]
    return float(np.median(ms[skip:]))


def train_main_path() -> dict:
    """Phase 9: FewShotTrainer at full width on the card (the flagship
    config, bf16 encoder, 400 002-row table, mse, lstm_cs_window=8, bf16
    checkpoints): step-0 gradients vs the plain backends, one graph step vs
    one eager step, TRAIN_STEPS steps as CUDA-graph replays at
    steps_per_call 1 (with a val pass and a best-checkpoint save) and 4, the
    same steps with the plain backends, ``cli.test_main`` reloads the
    checkpoint, then the profiles: eager (the parent's step) and the graph
    at steps_per_call 1 and 4."""
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    ckpt, ref_dir = WORK_DIR / "ckpt", WORK_DIR / "reference"
    argv = ["--synthetic", "--bf16", "--train_iter", str(TRAIN_STEPS), "--val_step",
            str(TRAIN_STEPS), "--val_iter", "40", "--save_ckpt", str(ckpt)]
    args = cli.build_arg_parser(train=True).parse_args(argv)
    cfg = cli.config_from_args(args)
    trainer, _ = cli.make_trainer(args, cfg)        # the model is built on the card
    trainer.metric_window = 1                       # one [train] record per dispatch
    model = trainer.model
    ref_cfg = cfg.replace(lstm_backend="reference", attn_backend="reference")
    vocab = make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim)
    tok = GloveTokenizer(vocab, max_length=cfg.max_length)
    ref_model = build_model(ref_cfg, glove_init=vocab.vectors)
    ref_model.load_state_dict(model.state_dict())
    print(f"[train] flagship: B={cfg.batch_size} N={cfg.n} K={cfg.k} Q={cfg.q} "
          f"({cfg.batch_size * cfg.n * (cfg.k + cfg.q)} encoder rows) L={cfg.max_length} "
          f"u={cfg.lstm_hidden} table {tuple(model.embedding.word_embedding.shape)} "
          f"compute {cfg.compute_dtype} W={cfg.lstm_cs_window} residuals {cfg.lstm_residuals} "
          f"loss {cfg.loss} optimizer {cfg.optimizer}/{cfg.embed_optimizer}", flush=True)

    def sampler():
        return EpisodeSampler(cli.load_data(cfg, "train"), tok, cfg.n, cfg.k, cfg.q,
                              batch_size=cfg.batch_size, seed=cfg.seed)

    # Step-0 gradients on the trainer's first batch (a sampler of the same seed).
    first = sampler().sample_batch()
    g = batch_grads(model, cfg, first)
    g_ref = batch_grads(ref_model, ref_cfg, first)
    worst = 0.0
    for name in GRAD_PARAMS:
        if not torch.isfinite(g[name]).all() or g[name].abs().max().item() == 0.0:
            raise AssertionError(f"step-0 gradient of {name} is not finite and nonzero")
    for name, gr in g_ref.items():
        err, rel = rel_err(g[name], gr)
        worst = max(worst, rel)
        if rel > GRAD_REL_TOL:
            raise AssertionError(f"step-0 gradient {name}: relative error {rel:.3g} > {GRAD_REL_TOL}")
    print(f"[train] step-0 gradients of {len(g)} parameters vs plain backends: worst relative "
          f"error {worst:.3g} (tol {GRAD_REL_TOL}); all {len(GRAD_PARAMS)} encoder/embedding "
          f"gradients finite and nonzero", flush=True)
    graph_check = graph_vs_eager(cfg, vocab, batch_to_model_inputs(first))
    four = sampler()
    fused_check = fused_vs_single(cfg, vocab, [batch_to_model_inputs(four.sample_batch())
                                               for _ in range(4)])
    probe = make_grad_probe(model, cfg)(*batch_to_model_inputs(first))
    probe = {k: float(v) for k, v in probe.items()}
    print(f"[train] grad probe (bf16 kernel route vs all-f32 plain W=0 reference, same batch): "
          f"{probe}", flush=True)
    if not (np.isfinite(list(probe.values())).all() and probe["grad_cosine"] > PROBE_COSINE_MIN):
        raise AssertionError(f"grad probe: {probe}")

    t0 = time.monotonic()
    evals = 40 // cfg.batch_size                    # --val_iter 40, one val pass
    launches, wrapped, recs = run_trainer(trainer, TRAIN_STEPS,
                                          ("K7", "K8", "K1", "K2") + STEP_KERNELS, evals)
    wall = time.monotonic() - t0
    vals = [r for r in map(json.loads, (ckpt / "metrics.jsonl").read_text().splitlines())
            if r["kind"] == "val"]
    if len(recs) != TRAIN_STEPS or len(vals) != 1 or not (ckpt / "best.pt").exists():
        raise AssertionError(f"{len(recs)} train records, {len(vals)} val, best.pt missing?")
    steady = step_ms_of(recs, cfg.batch_size, 2)
    print(f"[train] {TRAIN_STEPS} steps (graph replays, steps_per_call 1) in {wall:.2f} s "
          f"(capture, val and saves included; under the profiler's kernel tracing); launches "
          f"(profiler) {launches}, wrapper counts (warm-up and capture) {wrapped}; ms/step "
          f"median of steps "
          f"3-{TRAIN_STEPS} {steady:.2f} -> {cfg.batch_size * 1e3 / steady:.1f} episodes/s; val "
          f"accuracy {vals[0]['accuracy']:.4f} ± {vals[0]['acc_ci95']:.4f}; train graph pool "
          f"{trainer.train_step.graphs.pool_bytes / 2**20:.1f} MiB", flush=True)

    ref_trainer = FewShotTrainer(ref_model, ref_cfg, sampler(),
                                 logger=MetricsLogger(ref_dir, quiet=True), metric_window=1)
    ref_trainer.train(TRAIN_STEPS)
    ref_trainer.close()
    ref_recs = train_records(ref_dir / "metrics.jsonl")
    losses, loss_rel = losses_vs(recs, ref_recs, "W=8")
    print(f"[train] losses {np.round(losses, 5).tolist()}", flush=True)
    print(f"[train] vs plain backends: max per-step relative loss difference {loss_rel:.3g} "
          f"(tol {LOSS_REL_TOL})", flush=True)

    cfg4 = cfg.replace(steps_per_call=4)
    trainer4 = FewShotTrainer(build_model(cfg4, glove_init=vocab.vectors), cfg4, sampler(),
                              logger=MetricsLogger(WORK_DIR / "spc4", quiet=True), metric_window=1)
    launches4, _, recs4 = run_trainer(trainer4, TRAIN_STEPS, ("K7", "K8") + STEP_KERNELS)
    losses4, loss_rel4 = losses_vs(recs4, ref_recs, "W=8 steps_per_call 4")
    steady4 = step_ms_of(recs4, cfg.batch_size, 1)
    print(f"[train] steps_per_call 4: {TRAIN_STEPS} steps in {len(recs4)} replays, launches "
          f"{launches4}; losses (means of 4) {np.round(losses4, 5).tolist()}; vs plain backends "
          f"{loss_rel4:.3g} (tol {LOSS_REL_TOL}); ms/step median of replays 2-{len(recs4)} "
          f"{steady4:.2f} -> {cfg.batch_size * 1e3 / steady4:.1f} episodes/s", flush=True)

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.test_main(["--synthetic", "--bf16", "--load_ckpt", str(ckpt),
                            "--test_iter", "40"])
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    if rc != 0 or not 0.0 <= result["test_accuracy"] <= 1.0 \
            or "loaded best checkpoint" not in err.getvalue():
        raise AssertionError(f"test_main: rc {rc}, {result}, {err.getvalue()!r}")
    print(f"[test] test_main reloaded the best checkpoint: {result}", flush=True)
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    eager = profile_eager_steps(trainer)
    on = ("K7", "K8") + STEP_KERNELS
    prof1 = profile_graph_steps(trainer, on, tag="profile graph")
    prof4 = profile_graph_steps(trainer4, on, tag="profile graph spc4")
    return {"launches": launches, "step_ms": steady, "episodes_per_s": cfg.batch_size * 1e3 / steady,
            "step_ms_spc4": steady4, "grad_rel": worst, "loss_rel": max(loss_rel, loss_rel4),
            "graph": graph_check, "fused": fused_check, "eager": eager, "prof1": prof1,
            "prof4": prof4}


def train_full_residual(w8: dict) -> dict:
    """Phase 10: the training route at ``lstm_cs_window=0`` (K4/K6) at the
    flagship config (bf16 encoder, residuals "auto" = bf16): step-0
    gradients vs the plain backends at W=0 and their cosine to the W=8
    kernel route from the same weights on the same batch, one graph step
    vs one eager step, W0_STEPS steps of ``FewShotTrainer`` as graph
    replays at steps_per_call 1 and 4 (two replays and a one-step tail) with
    the counts zeroed just before and read just after, the same steps with
    the plain backends, ms/step beside W=8's, and the graph's profile."""
    argv = ["--synthetic", "--bf16", "--lstm_cs_window", "0"]
    cfg = cli.config_from_args(cli.build_arg_parser(train=True).parse_args(argv))
    ref_cfg = cfg.replace(lstm_backend="reference", attn_backend="reference")
    w8_cfg = cfg.replace(lstm_cs_window=8)
    vocab = make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim)
    tok = GloveTokenizer(vocab, max_length=cfg.max_length)
    model = build_model(cfg, glove_init=vocab.vectors)
    ref_model = build_model(ref_cfg, glove_init=vocab.vectors)
    w8_model = build_model(w8_cfg, glove_init=vocab.vectors)
    for m in (ref_model, w8_model):
        m.load_state_dict(model.state_dict())

    def sampler():
        return EpisodeSampler(cli.load_data(cfg, "train"), tok, cfg.n, cfg.k, cfg.q,
                              batch_size=cfg.batch_size, seed=cfg.seed)

    first = sampler().sample_batch()
    g = batch_grads(model, cfg, first)
    g_ref = batch_grads(ref_model, ref_cfg, first)
    g8 = batch_grads(w8_model, w8_cfg, first)
    worst = 0.0
    for name, gr in g_ref.items():
        _, rel = rel_err(g[name], gr)
        worst = max(worst, rel)
        if rel > GRAD_REL_TOL:
            raise AssertionError(f"W=0 step-0 gradient {name}: relative error {rel:.3g} > "
                                 f"{GRAD_REL_TOL}")
    cos = grad_cosine(g, g8)
    print(f"[train W=0] step-0 gradients of {len(g)} parameters vs plain backends (W=0): worst "
          f"relative error {worst:.3g} (tol {GRAD_REL_TOL}); cosine to the W=8 kernel route "
          f"{cos:.9f} (min {W0_COSINE_MIN})", flush=True)
    if not cos > W0_COSINE_MIN:
        raise AssertionError(f"W=0 vs W=8 gradient cosine {cos} <= {W0_COSINE_MIN}")
    del w8_model
    graph_check = graph_vs_eager(cfg, vocab, batch_to_model_inputs(first))
    four = sampler()
    fused_check = fused_vs_single(cfg, vocab, [batch_to_model_inputs(four.sample_batch())
                                               for _ in range(4)])

    def trainer_of(m, c, sub):
        return FewShotTrainer(m, c, sampler(), logger=MetricsLogger(WORK_DIR / sub, quiet=True),
                              metric_window=1)

    shutil.rmtree(WORK_DIR, ignore_errors=True)
    on = ("K4", "K6") + STEP_KERNELS
    trainer = trainer_of(model, cfg, "w0")
    launches, wrapped, recs = run_trainer(trainer, W0_STEPS, on)
    cfg4 = cfg.replace(steps_per_call=4)
    trainer4 = trainer_of(build_model(cfg4, glove_init=vocab.vectors), cfg4, "w0_spc4")
    launches4, _, recs4 = run_trainer(trainer4, W0_STEPS, on)
    ref_trainer = trainer_of(ref_model, ref_cfg, "w0_reference")
    ref_trainer.train(W0_STEPS)
    ref_trainer.close()
    ref_recs = train_records(WORK_DIR / "w0_reference" / "metrics.jsonl")
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    losses, loss_rel = losses_vs(recs, ref_recs, "W=0")
    losses4, loss_rel4 = losses_vs(recs4, ref_recs, "W=0 steps_per_call 4")
    if len(losses) != W0_STEPS or [r["step"] for r in recs4] != [4, 8, 9, 10]:
        raise AssertionError(f"W=0 records: {len(losses)}, {[r['step'] for r in recs4]}")
    steady = step_ms_of(recs, cfg.batch_size, 2)
    print(f"[train W=0] {W0_STEPS} steps: launches (profiler) {launches}, wrapper counts (warm-up and "
          f"capture) {wrapped} (steps_per_call 4, profiler: {launches4}); "
          f"losses {np.round(losses, 5).tolist()}; vs plain backends max per-step relative loss "
          f"difference {loss_rel:.3g}, steps_per_call 4 {loss_rel4:.3g} (tol {LOSS_REL_TOL})",
          flush=True)
    print(f"[train W=0] ms/step median of steps 3-{W0_STEPS} {steady:.2f} -> "
          f"{cfg.batch_size * 1e3 / steady:.1f} episodes/s (W=8 in this run: "
          f"{w8['step_ms']:.2f} ms/step, {w8['episodes_per_s']:.1f} episodes/s)", flush=True)
    eager = profile_eager_steps(trainer, tag="profile eager W=0")
    prof1 = profile_graph_steps(trainer, on, tag="profile graph W=0")
    prof4 = profile_graph_steps(trainer4, on, tag="profile graph spc4 W=0")
    return {"launches": launches, "step_ms": steady, "episodes_per_s": cfg.batch_size * 1e3 / steady,
            "grad_rel": worst, "cosine_w8": cos, "loss_rel": max(loss_rel, loss_rel4),
            "graph": graph_check, "fused": fused_check, "eager": eager, "prof1": prof1,
            "prof4": prof4}


def tokenize_rows(tok, instances) -> dict[str, np.ndarray]:
    ts = [tok(i) for i in instances]
    return {k: np.stack([getattr(t, k) for t in ts]).astype(dt)
            for k, dt in QUERY_DTYPES.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()

    # 1. Environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    print(smi, flush=True)

    # 2. Build
    LIBRARY.build()
    print(f"[build] nvcc sm_90a, all kernels ({len(SOURCES)} sources in parallel): "
          f"{LIBRARY.build_seconds:.1f} s", flush=True)

    # 3. Kernel vs plain
    gen = torch.Generator().manual_seed(0)
    rows = kernel_checks(gen)

    # 4. Main path
    cfg = ExperimentConfig()                            # flagship defaults
    vocab = make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim)
    tok = GloveTokenizer(vocab, max_length=cfg.max_length)
    ds = make_synthetic_fewrel(
        num_relations=5, instances_per_relation=60, vocab_size=cfg.vocab_size - 2,
        sentence_len=(10, 60), seed=0,
    )
    n_long = sum(len(i.tokens) > cfg.max_length for v in ds.instances.values() for i in v)
    if n_long == 0:
        raise AssertionError("no support/query sentence exceeds max_length")
    queries = [i for rel in ds.rel_names for i in ds.instances[rel][cfg.k:cfg.k + 13]]
    plan = [1] * 16 + [4] * 4 + [16] * 2                 # 64 requests
    batches, pos = [], 0
    for size in plan:
        batches.append(queries[pos:pos + size])
        pos += size

    model = build_model(cfg, glove_init=vocab.vectors)  # device None -> cuda
    torch.cuda.synchronize()
    bilstm_infer_cuda.launches = 0
    attn_fwd_cuda.launches = 0
    engine = InferenceEngine(model, cfg, tok, k=cfg.k)
    engine.register_dataset(ds)
    verdicts = [engine.classify_batch(b) for b in batches]
    torch.cuda.synchronize()
    launches = {"K1": bilstm_infer_cuda.launches, "K2": attn_fwd_cuda.launches}
    print(f"[main] served {engine.served} requests in {engine.batches} batches; "
          f"launches {launches}; "
          f"{n_long} sentences truncated at L={cfg.max_length}", flush=True)
    if engine.served < 32 or min(launches.values()) == 0:
        raise AssertionError(f"main path did not go through both kernels: {launches}")

    ref_cfg = cfg.replace(lstm_backend="reference", attn_backend="reference")
    ref_model = build_model(ref_cfg, glove_init=vocab.vectors)
    ref_model.load_state_dict(model.state_dict())
    ref_engine = InferenceEngine(ref_model, ref_cfg, tok, k=cfg.k)
    ref_engine.register_dataset(ds)
    ref_verdicts = [ref_engine.classify_batch(b) for b in batches]
    names = engine.class_names

    def logit_matrix(vs):
        return np.array([[v["logits"][n] for n in names] for batch in vs for v in batch])

    got, want = logit_matrix(verdicts), logit_matrix(ref_verdicts)
    if not np.isfinite(got).all():
        raise AssertionError("non-finite logits on the main path")
    scale = float(np.abs(want).max())
    logit_err = float(np.abs(got - want).max())
    mat_err = (engine.registry.snapshot().matrix - ref_engine.registry.snapshot().matrix)
    mat_err = mat_err.abs().max().item()
    print(f"[main] logits vs plain backends: max abs err {logit_err:.3g} at logit "
          f"scale {scale:.3g} (rel tol {LOGIT_REL_TOL}); class matrix max abs err "
          f"{mat_err:.3g}", flush=True)
    if logit_err > LOGIT_REL_TOL * scale:
        raise AssertionError(f"main-path logits disagree: {logit_err} > {LOGIT_REL_TOL}*{scale}")
    by_bucket: dict[int, list[float]] = {}
    for batch in verdicts:
        for v in batch:
            by_bucket.setdefault(v["bucket"], []).append(v["latency_ms"])
    for bkt in sorted(by_bucket):
        lat = np.array(by_bucket[bkt])
        print(f"[main] bucket {bkt}: {len(lat)} requests, request latency ms "
              f"p50 {np.percentile(lat, 50):.3f} max {lat.max():.3f}", flush=True)

    # 5. Episode forward (B=4, N=5, K=5, Q=5 -> 200 encoder rows)
    B, N, K, Q = cfg.batch_size, cfg.n, cfg.k, cfg.q
    sup_inst = [ds.instances[rel][b * K + k] for b in range(B) for rel in ds.rel_names
                for k in range(K)]
    qry_inst = [ds.instances[rel][30 + b * Q + q] for b in range(B) for rel in ds.rel_names
                for q in range(Q)]
    support = {k: v.reshape(B, N, K, -1) for k, v in tokenize_rows(tok, sup_inst).items()}
    query = {k: v.reshape(B, N * Q, -1) for k, v in tokenize_rows(tok, qry_inst).items()}
    with torch.inference_mode():
        ep = model(to_device(support, "cuda"), to_device(query, "cuda"))
        ep_ref = ref_model(to_device(support, "cuda"), to_device(query, "cuda"))
    if tuple(ep.shape) != (B, N * Q, N) or not torch.isfinite(ep).all():
        raise AssertionError(f"episode logits: shape {tuple(ep.shape)}, finite check failed")
    ep_err = (ep - ep_ref).abs().max().item()
    ep_scale = ep_ref.abs().max().item()
    print(f"[episode] logits {tuple(ep.shape)} vs plain backends: max abs err "
          f"{ep_err:.3g} at scale {ep_scale:.3g} (rel tol {LOGIT_REL_TOL})", flush=True)
    if ep_err > LOGIT_REL_TOL * ep_scale:
        raise AssertionError(f"episode logits disagree: {ep_err} > {LOGIT_REL_TOL}*{ep_scale}")

    # 6. Training kernels vs plain (cuDNN yardsticks by M, shared with phase 7)
    library: dict = {}
    train_rows = train_kernel_checks(gen, library)
    wgrad_rows = wgrad_checks(gen)

    # 6b. Attention kernels at every row count and a wide width
    attn_rows = attn_checks(gen)

    # 6c. The optimizer pair, 6d. the segment sum, on the flagship shapes
    optim_rows = optim_checks(model, gen)
    segsum_row = segsum_checks(model, support, query, gen)

    # 7. Full-residual kernels vs plain
    full_rows = full_kernel_checks(gen, library)

    # 8. Split recurrence: the ops API path, then the checks
    split = split_recurrence(gen)

    # 9. Training main path (W=8)
    tr = train_main_path()

    # 10. Training at lstm_cs_window=0
    tr0 = train_full_residual(tr)

    # 11. Summary lines
    def attn_extra(key: str, M: int) -> dict:
        """Phase 6b's figures of an attention kernel: device time and plan
        at the row's M, its worst error there, and the wide case."""
        r = attn_rows[(key, f"bf16 M={M} D={H_DIM} A={A}")]
        wide = attn_rows[(key, f"bf16 M={M} D=1280 A=300")]
        return {"device_ms": r["device_ms"], "plan": r["plan"],
                "max_abs_err_6b": max(v["err"] for (k, _), v in attn_rows.items() if k == key),
                "ms_wide_d1280_a300": wide["ms"], "device_ms_wide_d1280_a300": wide["device_ms"],
                "device_ms_m16" if M == 200 else "device_ms_m200": attn_rows[
                    (key, f"bf16 M={16 if M == 200 else 200} D={H_DIM} A={A}")]["device_ms"]}

    kernels = []
    for key, name, src, replaces in (
        ("K1", "bilstm_infer_fwd", "induction_network_on_fewrel_tpu_torch/csrc/bilstm_infer.cu",
         "induction_network_on_fewrel_tpu/ops/lstm.py:729"),
        ("K2", "attn_fwd", "induction_network_on_fewrel_tpu_torch/csrc/attn_fwd.cu",
         "induction_network_on_fewrel_tpu/ops/attn.py:122"),
    ):
        r = rows[(key, "bf16", 16)]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[key],
            "max_abs_err": max(v["err"] for (k, _, _), v in rows.items() if k == key),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "at": "L=40 M=16 bf16 (serving bucket 16)", "launches_val": tr["launches"][key],
            **{f"ms_m{M}": rows[(key, "bf16", M)]["ms"] for M in SERVE_ROWS if M != 16},
            "bound_ms_m200": rows[(key, "bf16", 200)]["bound_ms"],
            **({"train_library_ms": r["train_library_ms"], "plan": r["plan"]}
               if key == "K1" else attn_extra(key, 16)),
        })
    main_case = "bf16 M=200 W=8 res=bf16"
    for key, name, src, replaces in (
        ("K7", "bilstm_win_fwd", "induction_network_on_fewrel_tpu_torch/csrc/bilstm_infer.cu",
         "induction_network_on_fewrel_tpu/ops/lstm.py:969"),
        ("K8", "bilstm_win_bwd", "induction_network_on_fewrel_tpu_torch/csrc/bilstm_win_bwd.cu",
         "induction_network_on_fewrel_tpu/ops/lstm.py:1000"),
        ("K10", "attn_fwd_stats", "induction_network_on_fewrel_tpu_torch/csrc/attn_fwd.cu",
         "induction_network_on_fewrel_tpu/ops/attn.py:122"),
        ("K11", "attn_bwd", "induction_network_on_fewrel_tpu_torch/csrc/attn_bwd.cu",
         "induction_network_on_fewrel_tpu/ops/attn.py:168"),
    ):
        r = train_rows[(key, main_case)]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": tr["launches"][key],
            "max_abs_err": max(v["err"] for (k, _), v in train_rows.items() if k == key),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "at": "L=40 M=200 bf16 W=8 (training step, B=4 episodes)"
                  + ("; chain kernel + lstm_wgrad" if key == "K8" else ""),
            "ms_m16": train_rows[(key, "bf16 M=16 W=8 res=bf16")]["ms"],
            **({"plan": r["plan"]} if "plan" in r else {}),
            **({"ms_min": r["spread"][1], "ms_max": r["spread"][2]} if "spread" in r else {}),
            **(attn_extra(key, 200) if key in ("K10", "K11") else {}),
        })
    for key, name, src, replaces in (
        ("K4", "bilstm_full_fwd", "induction_network_on_fewrel_tpu_torch/csrc/bilstm_infer.cu",
         "induction_network_on_fewrel_tpu/ops/lstm.py:706"),
        ("K6", "bilstm_full_bwd", "induction_network_on_fewrel_tpu_torch/csrc/bilstm_full_bwd.cu",
         "induction_network_on_fewrel_tpu/ops/lstm.py:751"),
    ):
        r = full_rows[(key, "bf16 M=200 res=bf16")]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": tr0["launches"][key],
            "max_abs_err": max(v["err"] for (k, _), v in full_rows.items() if k == key),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "at": "L=40 M=200 bf16 res=bf16 (training step at lstm_cs_window=0)"
                  + ("; chain kernel + lstm_wgrad" if key == "K6" else ""),
            "ms_m16": full_rows[(key, "bf16 M=16 res=bf16")]["ms"],
            **({"plan": r["plan"]} if "plan" in r else {}),
            **({"ms_min": r["spread"][1], "ms_max": r["spread"][2]} if "spread" in r else {}),
        })
    r = wgrad_rows[("wgrad", "bf16 M=200 hp")]
    kernels.append({
        "name": "lstm_wgrad", "route": "cuda",
        "source": "induction_network_on_fewrel_tpu_torch/csrc/lstm_wgrad.cu",
        "replaces": "induction_network_on_fewrel_tpu/ops/lstm.py:1090",
        "launches": tr["launches"]["wgrad"],
        "max_abs_err": max(v["err"] for v in wgrad_rows.values()),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        "at": "L=40 M=200 bf16, K8's da and hp streams (training step)",
        "ms_hs": wgrad_rows[("wgrad", "bf16 M=200 hs")]["ms"],
        "ms_m16": wgrad_rows[("wgrad", "bf16 M=16 hp")]["ms"],
    })
    for key, name, replaces in (
        ("split2", "lstm_split_fwd_infer", "induction_network_on_fewrel_tpu/ops/lstm.py:189"),
        ("split1", "lstm_split_fwd", "induction_network_on_fewrel_tpu/ops/lstm.py:157"),
        ("split3", "lstm_split_bwd", "induction_network_on_fewrel_tpu/ops/lstm.py:215"),
    ):
        r = split["rows"][(key, "bf16 M=200 tm")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "induction_network_on_fewrel_tpu_torch/csrc/lstm_split.cu",
            "replaces": replaces, "launches": split["launches"][key],
            "max_abs_err": max(v["err"] for (k, _), v in split["rows"].items() if k == key),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "at": "L=40 M=200 u=128 bf16, bilstm_recurrence_tm (2 groups)",
            "ms_m16": split["rows"][(key, "bf16 M=16 tm")]["ms"],
        })
    step_at = "the flagship parameter list (training step, Adam, shared table)"
    for key in ("optim_sumsq", "optim_update"):
        r = optim_rows[key]
        kernels.append({
            "name": key, "route": "cuda",
            "source": "induction_network_on_fewrel_tpu_torch/csrc/optim.cu",
            "replaces": "induction_network_on_fewrel_tpu/train/steps.py:48",
            "launches": tr["launches"][key], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "at": step_at + "; ms, plain_ms and library_ms are device times under the profiler",
            "ms_events": r["ms_events"],
            "launches_w0": tr0["launches"][key],
            **({k: r[k] for k in ("pair_ms", "clip_grad_norm_adam_fused_ms")}
               if key == "optim_update" else {}),
        })
    steps_summary = {
        tag: {"graph_ms_per_step": r["prof1"]["step_ms"],
              "graph_spc4_ms_per_step": r["prof4"]["step_ms"],
              "busy_ms_eager": r["eager"]["busy_ms"], "busy_ms_graph": r["prof1"]["busy_ms"],
              "launches_eager": r["eager"]["launches"], "launches_graph": r["prof1"]["launches"],
              "host_split_ms": r["prof1"]["split"], "host_split_ms_spc4": r["prof4"]["split"],
              "pool_bytes": r["prof1"]["pool_bytes"], "pool_bytes_spc4": r["prof4"]["pool_bytes"],
              "graph_vs_eager": r["graph"], "fused_vs_single": r["fused"]}
        for tag, r in (("W=8", tr), ("W=0", tr0))
    }
    steps_summary["segsum_index_add"] = segsum_row
    print(json.dumps({"training_step": steps_summary}), flush=True)
    print(f"[done] {time.monotonic() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
