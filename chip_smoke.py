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
   checkpoints, B=4 episodes = 200 encoder rows per step): step-0
   gradients of every parameter vs the plain backends (every encoder and
   embedding gradient finite and nonzero), 20 steps with a val pass and a
   best-checkpoint save with the training kernels' launch counts zeroed
   just before and read just after (each of K7/K8/K10/K11 and lstm_wgrad
   must equal the step count, K4/K6 zero), the same 20 steps with the plain backends
   from the same weights (per-step losses within a band), ms/step and
   episodes/s, then ``cli.test_main`` reloads the best checkpoint and
   evaluates. Then five more steps run under torch.profiler: device time
   by kernel and the device's busy share.
10. Training at ``lstm_cs_window=0`` (the full-residual route; bf16
   encoder, bf16 residuals, otherwise the flagship): step-0 gradients vs
   the plain backends and their cosine to the W=8 kernel route from the
   same weights on the same batch, 10 steps with the counts zeroed just
   before and read just after (K4, K6, K10, K11, lstm_wgrad once per
   step, K7/K8 never), the same steps with the plain backends (per-step losses within
   a band), ms/step and episodes/s beside the W=8 figure, and five more
   steps under torch.profiler.
11. A ``{"kernels": [...]}`` line for the twelve kernels (one per Pallas
   body, and the weight-gradient kernel of the backwards), then the last line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX. Exits non-zero without CUDA (rc 2), and when the
port's package is not beside it (rc 1, with a message naming the package).
"""

from __future__ import annotations

import contextlib
import io
import json
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
from induction_network_on_fewrel_tpu_torch.train.framework import FewShotTrainer
from induction_network_on_fewrel_tpu_torch.train.steps import loss_and_metrics, train_step
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
                 "K4": bilstm_full_fwd, "K6": bilstm_full_bwd, "wgrad": lstm_wgrad}
SPLIT_KERNELS = {"split2": lstm_split_infer_cuda, "split1": lstm_split_fwd, "split3": lstm_split_bwd,
                 "wgrad": lstm_wgrad}
# Training at lstm_cs_window=0 vs the W=8 kernel route from the same
# weights on the same batch: bf16 residuals at every step against bf16
# checkpoint seeds; the JAX band for bf16 residuals (tests/test_lstm.py:517).
W0_COSINE_MIN = 0.999
W0_STEPS = 10
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


def profile_train_steps(trainer, steps: int = 5, tag: str = "profile") -> None:
    """torch.profiler over ``steps`` more training steps of
    the main path's trainer (after its checks): device time by kernel, and
    the device's busy share of the wall time (the sum of kernel times over
    the synchronized wall; one stream, so kernels do not overlap)."""
    from torch.autograd import DeviceType
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
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"[{tag}] {steps} steps under the profiler: wall {wall_us / steps / 1e3:.2f} ms/step, "
          f"{sum(r[2] for r in rows) // steps} kernel launches/step, device busy "
          f"{busy / steps / 1e3:.2f} ms/step ({busy / wall_us:.1%} of wall)", flush=True)
    for key, us, n in rows[:15]:
        print(f"[{tag}]   {us / steps / 1e3:8.3f} ms/step {n // steps:4d}x  {key[:90]}", flush=True)


def expect_launches(launches: dict, on: tuple, steps: int) -> None:
    """Each kernel in ``on`` launched once per step, every other never."""
    want = {k: steps if k in on else 0 for k in launches}
    if launches != want:
        raise AssertionError(f"training kernels launched {launches}, expected {want}")


def grad_cosine(ga: dict, gb: dict) -> float:
    """Global cosine of two gradient sets (the JAX grad-probe reduction)."""
    num = sum(float((ga[k].double() * gb[k].double()).sum()) for k in ga)
    na = sum(float(ga[k].double().square().sum()) for k in ga) ** 0.5
    nb = sum(float(gb[k].double().square().sum()) for k in gb) ** 0.5
    return num / (na * nb + 1e-30)


def train_main_path() -> dict:
    """Phase 6: FewShotTrainer at full width on the card (the flagship
    config, bf16 encoder, 400 002-row table, mse, lstm_cs_window=8, bf16
    checkpoints): step-0 gradients vs the plain backends, TRAIN_STEPS
    steps with a val pass and a best-checkpoint save, the same steps with
    the plain backends, then ``cli.test_main`` reloads the checkpoint."""
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    ckpt, ref_dir = WORK_DIR / "ckpt", WORK_DIR / "reference"
    argv = ["--synthetic", "--bf16", "--train_iter", str(TRAIN_STEPS), "--val_step",
            str(TRAIN_STEPS), "--val_iter", "40", "--save_ckpt", str(ckpt)]
    args = cli.build_arg_parser(train=True).parse_args(argv)
    cfg = cli.config_from_args(args)
    trainer, _ = cli.make_trainer(args, cfg)        # the model is built on the card
    trainer.metric_window = 1                       # one [train] record per step
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
          f"loss {cfg.loss}", flush=True)

    # Step-0 gradients on the trainer's first batch (a sampler of the same seed).
    first = EpisodeSampler(cli.load_data(cfg, "train"), tok, cfg.n, cfg.k, cfg.q,
                           batch_size=cfg.batch_size, seed=cfg.seed).sample_batch()
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

    torch.cuda.synchronize()
    for fn in TRAIN_KERNELS.values():
        fn.launches = 0
    t0 = time.monotonic()
    with contextlib.redirect_stderr(io.StringIO()):     # the [train]/[val] lines; read back below
        trainer.train(TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: fn.launches for k, fn in TRAIN_KERNELS.items()}
    expect_launches(launches, ("K7", "K8", "K10", "K11", "wgrad"), TRAIN_STEPS)
    trainer.close()
    recs = train_records(ckpt / "metrics.jsonl")
    vals = [r for r in map(json.loads, (ckpt / "metrics.jsonl").read_text().splitlines())
            if r["kind"] == "val"]
    if len(recs) != TRAIN_STEPS or len(vals) != 1 or not (ckpt / "best.pt").exists():
        raise AssertionError(f"{len(recs)} train records, {len(vals)} val, best.pt missing?")
    step_ms = [cfg.batch_size / r["episodes_per_s"] * 1e3 for r in recs]
    steady = float(np.median(step_ms[2:]))
    print(f"[train] {TRAIN_STEPS} steps in {wall:.2f} s (val and saves included); launches "
          f"{launches}; ms/step first {step_ms[0]:.1f}, median of steps 3-{TRAIN_STEPS} "
          f"{steady:.2f} -> {cfg.batch_size * 1e3 / steady:.1f} episodes/s; val accuracy "
          f"{vals[0]['accuracy']:.4f} ± {vals[0]['acc_ci95']:.4f}", flush=True)

    ref_trainer = FewShotTrainer(
        ref_model, ref_cfg,
        EpisodeSampler(cli.load_data(cfg, "train"), tok, cfg.n, cfg.k, cfg.q,
                       batch_size=cfg.batch_size, seed=cfg.seed),
        logger=MetricsLogger(ref_dir, quiet=True), metric_window=1,
    )
    ref_trainer.train(TRAIN_STEPS)
    ref_trainer.close()
    losses = np.array([r["loss"] for r in recs])
    ref_losses = np.array([r["loss"] for r in train_records(ref_dir / "metrics.jsonl")])
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite training loss")
    loss_rel = float(np.max(np.abs(losses - ref_losses) / ref_losses))
    print(f"[train] losses {np.round(losses, 5).tolist()}", flush=True)
    print(f"[train] vs plain backends: max per-step relative loss difference {loss_rel:.3g} "
          f"(tol {LOSS_REL_TOL})", flush=True)
    if loss_rel > LOSS_REL_TOL:
        raise AssertionError(f"training losses disagree: {loss_rel} > {LOSS_REL_TOL}")

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
    profile_train_steps(trainer)
    return {"launches": launches, "step_ms": steady, "episodes_per_s": cfg.batch_size * 1e3 / steady,
            "grad_rel": worst, "loss_rel": loss_rel}


def train_full_residual(w8: dict) -> dict:
    """Phase 10: the training route at ``lstm_cs_window=0`` (K4/K6) at the
    flagship config (bf16 encoder, residuals "auto" = bf16): step-0
    gradients vs the plain backends at W=0 and their cosine to the W=8
    kernel route from the same weights on the same batch, W0_STEPS steps of
    ``FewShotTrainer`` with the counts zeroed just before and read just
    after, the same steps with the plain backends, ms/step beside W=8's."""
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

    def run(m, c, sub):
        trainer = FewShotTrainer(m, c, sampler(), logger=MetricsLogger(WORK_DIR / sub, quiet=True),
                                 metric_window=1)
        trainer.train(W0_STEPS)
        trainer.close()
        return trainer, train_records(WORK_DIR / sub / "metrics.jsonl")

    shutil.rmtree(WORK_DIR, ignore_errors=True)
    torch.cuda.synchronize()
    for fn in TRAIN_KERNELS.values():
        fn.launches = 0
    trainer, recs = run(model, cfg, "w0")
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in TRAIN_KERNELS.items()}
    expect_launches(launches, ("K4", "K6", "K10", "K11", "wgrad"), W0_STEPS)
    _, ref_recs = run(ref_model, ref_cfg, "w0_reference")
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    losses = np.array([r["loss"] for r in recs])
    ref_losses = np.array([r["loss"] for r in ref_recs])
    if len(losses) != W0_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"W=0 losses: {losses}")
    loss_rel = float(np.max(np.abs(losses - ref_losses) / ref_losses))
    step_ms = [cfg.batch_size / r["episodes_per_s"] * 1e3 for r in recs]
    steady = float(np.median(step_ms[2:]))
    print(f"[train W=0] {W0_STEPS} steps: launches {launches}; losses "
          f"{np.round(losses, 5).tolist()}; vs plain backends max per-step relative loss "
          f"difference {loss_rel:.3g} (tol {LOSS_REL_TOL})", flush=True)
    print(f"[train W=0] ms/step median of steps 3-{W0_STEPS} {steady:.2f} -> "
          f"{cfg.batch_size * 1e3 / steady:.1f} episodes/s (W=8 in this run: "
          f"{w8['step_ms']:.2f} ms/step, {w8['episodes_per_s']:.1f} episodes/s)", flush=True)
    if loss_rel > LOSS_REL_TOL:
        raise AssertionError(f"W=0 training losses disagree: {loss_rel} > {LOSS_REL_TOL}")
    profile_train_steps(trainer, tag="profile W=0")
    return {"launches": launches, "step_ms": steady, "episodes_per_s": cfg.batch_size * 1e3 / steady,
            "grad_rel": worst, "cosine_w8": cos, "loss_rel": loss_rel}


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
            "at": "L=40 M=16 bf16 (serving bucket 16)",
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
    print(f"[done] {time.monotonic() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
