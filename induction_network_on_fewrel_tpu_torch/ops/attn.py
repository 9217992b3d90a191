"""Structured self-attention: plain versions and the CUDA kernels K2, K10, K11.

``masked_selfattn_tm`` is the counterpart of
``induction_network_on_fewrel_tpu/ops/attn.py:masked_selfattn_tm`` on its
kernel path (``_attn_core``):

    s_t = w2 . tanh(W1^T h_t),  a = masked_softmax over t,  out = sum_t a_t h_t

    H_t [L, M, D], mask [M, L] (> 0 = valid token), w1 [D, A], w2 [A, 1]
      -> out [M, D] in H's dtype

Two routes, as in the JAX custom VJP:

* no gradient needed: the forward alone, K2 (``csrc/attn_fwd.cu``,
  replaces ``_make_fwd_kernel(with_stats=False)``) or ``attn_reference``;
* otherwise ``_AttnCore``, a ``torch.autograd.Function`` whose forward is
  K10 (``attn_fwd_stats``: the same kernel body with the softmax stats mx,
  dn [M] written too, replaces ``_make_fwd_kernel(with_stats=True)``) and
  whose backward is K11 (``attn_bwd``, replaces ``_bwd_kernel``): one pass
  over H that rebuilds tanh(H W1) and a_t from the saved stats. The JAX
  package's default on the TPU was "xla_remat", the two-pass forward with
  the same stats and the same backward kernel; on this card the one-pass
  forward is faster than the two-pass plain version, so K10 is the
  training forward. Both produce the same stats, so the backward is the
  same.

Everything computes in f32 whatever H's dtype; outputs and dH are cast to
H's dtype, and the incoming cotangent is cast to H's dtype before the
backward (attn.py:334). The normalizer adds 1e-13; a fully masked row
gives exact zeros forward and backward. The mask gets no gradient.

Backends (``ops.core.resolve_backend``): "reference" is the plain version,
"cuda" the kernels (CUDA tensors only), "auto" picks by the device.

The kernels take any D and A. Their launch plans are made here, on the
host, and tested on the CPU: ``attn_fwd_plan`` splits each row's L steps
over a cluster of 8 CTAs and groups rows so that serving sizes and the
training batch both fill the card; ``attn_bwd_plan`` picks K11's token
tile. ``attn_fwd_split_reference`` is the plain twin of the forward's
split and rank-ordered merge, so that arithmetic is held against the JAX
kernel on the CPU.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from induction_network_on_fewrel_tpu_torch.kernels.build import LIBRARY, check_cuda_tensors
from induction_network_on_fewrel_tpu_torch.ops.core import (
    ACTIVATION_DTYPES,
    needs_grad,
    resolve_backend,
)

_NEG = -1e30
# A block's dynamic shared memory and the SMs of an H100 SXM.
SMEM_LIMIT = 232448
NUM_SMS = 132
# The product engine of csrc/attn_common.cuh: output columns of a tile,
# depth of a staged slab, the token tiles it is compiled for; the CTAs of
# K2/K10's cluster (the time split), and of K11's weight-gradient cluster
# (the token split) with the dW1 rows of its tiles.
CW, SLAB, SPLIT = 64, 64, 8
WSPLIT, WR = 16, 32
TILES = (64, 32, 16, 8)


def masked_selfattn_tm(
    H_t: torch.Tensor,
    mask: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    backend: str = "auto",
) -> torch.Tensor:
    kernel = resolve_backend(backend, H_t.device) == "cuda"
    mask = mask.float()
    w1, w2 = w1.float(), w2.float()
    if not needs_grad(H_t, w1, w2):
        if kernel:
            return attn_fwd_cuda(H_t.contiguous(), mask.contiguous(), w1.contiguous(),
                                 w2.contiguous())
        return attn_reference(H_t, mask, w1, w2)
    return _AttnCore.apply(H_t, mask, w1, w2, kernel)


class _AttnCore(torch.autograd.Function):
    """The custom VJP of ``_attn_core``: K10 forward, K11 backward (or
    their plain versions, for ``kernel=False``)."""

    @staticmethod
    def forward(ctx, H_t, mask, w1, w2, kernel: bool):
        args = (H_t.contiguous(), mask.contiguous(), w1.contiguous(), w2.contiguous())
        fwd = attn_fwd_stats if kernel else attn_fwd_stats_reference
        out, mx, dn = fwd(*args)
        ctx.save_for_backward(*args, out, mx, dn)
        ctx.kernel = kernel
        return out

    @staticmethod
    def backward(ctx, dout):
        H_t, mask, w1, w2, out, mx, dn = ctx.saved_tensors
        bwd = attn_bwd if ctx.kernel else attn_bwd_reference
        dH, dw1, dw2 = bwd(H_t, mask, w1, w2, out, mx, dn, dout.to(H_t.dtype).contiguous())
        return dH, None, dw1, dw2, None


# --- plain versions -----------------------------------------------------------


def _scores(H32, mask, w1, w2):
    """tanh(H W1) [L, M, A], masked scores [L, M] and the 0/1 mask [L, M]."""
    t = torch.tanh(H32 @ w1.float())
    s = (t @ w2.float())[..., 0]
    mk = mask.transpose(0, 1) > 0
    return t, torch.where(mk, s, torch.full_like(s, _NEG)), mk


def attn_fwd_stats_reference(H_t, mask, w1, w2):
    """Two-pass plain version of K10 (``_attn_remat_fwd``'s pass
    structure): (out [M, D] in H's dtype, mx [M], dn [M])."""
    H32 = H_t.float()
    _, s, mk = _scores(H32, mask, w1, w2)
    mx = s.amax(dim=0)
    e = torch.exp(s - mx) * mk
    dn = e.sum(dim=0)
    a = e / (dn + 1e-13)
    return torch.einsum("lm,lmd->md", a, H32).to(H_t.dtype), mx, dn


def attn_reference(H_t, mask, w1, w2) -> torch.Tensor:
    """Two-pass plain version of K2 (``_attn_reference``, attn.py:91)."""
    return attn_fwd_stats_reference(H_t, mask, w1, w2)[0]


def attn_bwd_reference(H_t, mask, w1, w2, out, mx, dn, dout):
    """The plain version of K11 (``_bwd_kernel``'s math over all of H at
    once): (dH [L, M, D] in H's dtype, dw1 [D, A], dw2 [A, 1])."""
    H32 = H_t.float()
    do = dout.float()                                         # [M, D]
    t, s, mk = _scores(H32, mask, w1, w2)
    a = torch.exp(s - mx) * mk / (dn + 1e-13)                 # [L, M]
    c = (do * out.float()).sum(-1)                            # [M]
    ds = a * ((do[None] * H32).sum(-1) - c[None])             # [L, M]
    dproj = ds[..., None] * (1.0 - t * t) * w2.float()[:, 0]  # [L, M, A]
    dh = a[..., None] * do[None] + dproj @ w1.float().T       # [L, M, D]
    D, A = w1.shape
    dw1 = H32.reshape(-1, D).T @ dproj.reshape(-1, A)
    dw2 = (t * ds[..., None]).sum(dim=(0, 1)).reshape(A, 1)
    return dh.to(H_t.dtype), dw1, dw2


def attn_fwd_split_reference(H_t, mask, w1, w2, plan=None):
    """The plain twin of K2/K10's split and merge: (out in H's dtype, mx,
    dn), as ``attn_fwd_stats_reference`` up to f32 rounding. Rank q of the
    plan's cluster owns steps [q Lc, q Lc + Lc) and passes them in chunks
    of ``plan.chunk``, carrying its partial (m, d, acc) as an online
    softmax; the partials are then merged in rank order: M = max m_q,
    d = sum_q d_q e^(m_q - M), out = sum_q acc_q e^(m_q - M) / (d + 1e-13).
    ``plan`` defaults to ``attn_fwd_plan`` of the inputs' widths."""
    L, M, D = H_t.shape
    plan = plan or attn_fwd_plan(M, L, D, w1.shape[1])
    H32 = H_t.float()
    _, s, mk = _scores(H32, mask, w1, w2)                      # s: NEG where masked
    parts = []
    for q in range(plan.cluster):
        m = torch.full((M,), _NEG)
        d = torch.zeros(M)
        acc = torch.zeros((M, D))
        t0, tn = q * plan.steps, max(0, min(plan.steps, L - q * plan.steps))
        for p in range(0, tn, plan.chunk):
            sl = slice(t0 + p, t0 + min(p + plan.chunk, tn))
            m_new = torch.maximum(m, s[sl].amax(dim=0))
            corr = torch.exp(m - m_new)
            e = torch.exp(s[sl] - m_new) * mk[sl]
            d = d * corr + e.sum(dim=0)
            acc = acc * corr[:, None] + torch.einsum("lm,lmd->md", e, H32[sl])
            m = m_new
        parts.append((m, d, acc))
    mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    dn, out = torch.zeros(M), torch.zeros((M, D))
    for m, d, acc in parts:
        f = torch.exp(m - mx)
        dn = dn + d * f
        out = out + acc * f[:, None]
    return (out / (dn + 1e-13)[:, None]).to(H_t.dtype), mx, dn


# --- launch plans ---------------------------------------------------------------


def engine_floats(R: int) -> int:
    """Shared floats of the product engine for an R-row tile
    (``attn::engine_floats``): two slabs of each operand [SLAB, R + 4] and
    [SLAB, CW + 4], and the split partials [64 / R, R, CW]."""
    return 2 * SLAB * (R + 4) + 2 * SLAB * (CW + 4) + 64 * CW


def attn_fwd_smem(R: int, G: int, D: int) -> int:
    """K2/K10's shared bytes (``attn::fwd_smem``): the engine, half-row
    score sums [R, 2], scores and weights [R], per row the max, normalizer
    and rescale [3G] and the weighted sum [G, D], and the merge's per-rank
    factors [SPLIT, G]."""
    return 4 * (engine_floats(R) + 4 * R + (3 + SPLIT) * G + G * D)


def attn_bwd_smem(R: int, A: int) -> int:
    """K11's token kernel's shared bytes (``attn::bwd_smem``): the engine,
    tanh(P) then dproj of the tile [R, A], and a_t, ds_t [R]."""
    return 4 * (engine_floats(R) + R * A + 2 * R)


def attn_wgrad_smem() -> int:
    """K11's weight-gradient kernel's shared bytes (``attn::wgrad_smem``):
    the engine at WR rows and its partial tile [WR, CW]."""
    return 4 * (engine_floats(WR) + WR * CW)


class AttnFwdPlan(NamedTuple):
    """Launch plan of K2/K10: a cluster of ``cluster`` CTAs per group of
    ``rows`` rows; CTA q owns steps [q steps, q steps + steps) of each."""

    tile: int      # R: token rows of the CTA's product tile
    cluster: int   # CTAs splitting a row's steps
    rows: int      # G: rows of a cluster
    steps: int     # Lc = ceil(L / cluster): steps of a CTA
    chunk: int     # steps of a row per pass: min(Lc, R / G)
    ctas: int      # ceil(M / G) * cluster
    smem: int      # dynamic shared memory of a CTA, bytes


def _tile_for(tokens: int) -> int:
    return next(R for R in reversed(TILES) if R >= tokens)


@functools.lru_cache(maxsize=None)
def attn_fwd_plan(M: int, L: int, D: int, A: int) -> AttnFwdPlan:
    """K2/K10's plan. Each row's L steps are split over a cluster of 8
    CTAs (Lc = ceil(L / 8) steps each), so one row fills a cluster. Rows
    are grouped G to a cluster, as many as one 64-token tile holds while
    the CTAs still number 3/2 of the card's SMs (M = 16: G = 1, 128 CTAs;
    M = 200, L = 40: G = 8, 200 CTAs, one wave at two CTAs an SM). A
    longer row (Lc > 64) takes a cluster alone and passes its steps in
    chunks of 64. Each CTA forms the weighted sums [G, D] of its steps
    after the projection, a pass that grows with G D, so G D is kept to
    4096 (D = 1280: G = 3); the sums live in shared memory, which may
    lower G further. A does not
    enter the forward's shared memory (64 of its columns a pass). Raises
    ValueError when not even one row fits."""
    Lc = max(1, -(-L // SPLIT))
    if Lc > TILES[0]:
        G = 1
    else:
        G = max(1, min(TILES[0] // Lc, 2 * M * SPLIT // (3 * NUM_SMS), M, 4096 // D))
    while True:
        chunk = min(Lc, TILES[0] // G)
        R = _tile_for(G * chunk)
        smem = attn_fwd_smem(R, G, D)
        if smem <= SMEM_LIMIT:
            return AttnFwdPlan(R, SPLIT, G, Lc, chunk, -(-M // G) * SPLIT, smem)
        if G == 1:
            raise ValueError(f"the attention forward cannot take D={D}: a CTA would need "
                             f"{smem} bytes of shared memory")
        G -= 1


class AttnBwdPlan(NamedTuple):
    """Launch plan of K11: the token kernel's tile and CTAs, then the
    weight-gradient kernel's clusters."""

    tile: int         # R: tokens of a CTA
    ctas: int         # ceil(L M / R)
    smem: int         # the token kernel's shared bytes
    wgrad_ctas: int   # (dW1 tiles + dw2 tiles) * WSPLIT
    wgrad_smem: int


@functools.lru_cache(maxsize=None)
def attn_bwd_plan(M: int, L: int, D: int, A: int) -> AttnBwdPlan:
    """K11's plan: the largest token tile that still gives two CTAs per
    SM (M = 200, L = 40: R = 16, 500 CTAs; M = 16: R = 8, 80 CTAs), else
    the smallest; a tile whose tanh(P) [R, A] does not fit shared memory
    steps down. The weight-gradient kernel has one cluster of WSPLIT CTAs
    per WR x 64 tile of dW1 and per 64 columns of dw2. Raises ValueError
    when not even an 8-token tile fits."""
    N = L * M
    fits = [R for R in TILES if attn_bwd_smem(R, A) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"the attention backward cannot take A={A}: an 8-token tile would "
                         f"need {attn_bwd_smem(TILES[-1], A)} bytes of shared memory")
    R = next((R for R in fits if -(-N // R) >= 2 * NUM_SMS), fits[-1])
    at = -(-A // CW)
    return AttnBwdPlan(R, -(-N // R), attn_bwd_smem(R, A),
                       (-(-D // WR) * at + at) * WSPLIT, attn_wgrad_smem())


def _plan_for(name, plan, *args):
    try:
        return plan(*args)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None


# --- kernel wrappers ------------------------------------------------------------


def _check_attn_args(name, H_t, mask, w1, w2, plan, *more):
    """Dtype, shape and device checks; returns (L, M, D, A, ``plan(M, L,
    D, A)``). The plan is made before the device check, so a width the
    kernels cannot take is refused on any device; ``more`` are further
    tensors that must share the device."""
    L, M, D = H_t.shape
    if H_t.dtype not in ACTIVATION_DTYPES:
        raise TypeError(f"{name}: H must be one of {ACTIVATION_DTYPES}, got {H_t.dtype}")
    f32 = torch.float32
    if mask.dtype != f32 or w1.dtype != f32 or w2.dtype != f32:
        raise TypeError(f"{name}: mask, w1 and w2 must be float32")
    A = w1.shape[-1]
    if mask.shape != (M, L) or w1.shape != (D, A) or w2.shape != (A, 1):
        raise ValueError(
            f"{name}: mask {tuple(mask.shape)}, w1 {tuple(w1.shape)}, "
            f"w2 {tuple(w2.shape)} do not match H {tuple(H_t.shape)}"
        )
    plan = _plan_for(name, plan, M, L, D, A)
    check_cuda_tensors(name, H_t, mask, w1, w2, *more)
    return L, M, D, A, plan


def _launch(name, device, *args):
    """Launch ``name`` on the current stream of ``device`` (the stream is
    the launcher's last argument)."""
    LIBRARY.launch_on(device, name, *args)


def _fwd_plan_args(plan: AttnFwdPlan) -> tuple:
    return plan.tile, plan.cluster, plan.rows, plan.steps, plan.chunk


def attn_fwd_cuda(H_t, mask, w1, w2) -> torch.Tensor:
    """Launch K2 on the current stream (no synchronize). Raises for CPU
    tensors, unsupported dtypes, shapes or layouts, launch failures, and
    for an input that requires grad while grad mode is on: K2 keeps no
    stats, so its output could carry no gradient."""
    if needs_grad(H_t, w1, w2):
        raise RuntimeError(
            "attn_fwd_cuda: an input requires grad; the training route is "
            "masked_selfattn_tm (K10/K11), K2 would return a detached output"
        )
    L, M, D, A, plan = _check_attn_args("attn_fwd_cuda", H_t, mask, w1, w2, attn_fwd_plan)
    if M == 0 or L == 0:
        return torch.zeros((M, D), dtype=H_t.dtype, device=H_t.device)
    out = torch.empty((M, D), dtype=H_t.dtype, device=H_t.device)
    _launch("attn_fwd", H_t.device,
            H_t.data_ptr(), mask.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            out.data_ptr(), L, M, D, A, int(H_t.dtype == torch.bfloat16),
            *_fwd_plan_args(plan))
    attn_fwd_cuda.launches += 1
    return out


attn_fwd_cuda.launches = 0


def attn_fwd_stats(H_t, mask, w1, w2):
    """Launch K10: (out, mx, dn) as ``attn_fwd_stats_reference``."""
    L, M, D, A, plan = _check_attn_args("attn_fwd_stats", H_t, mask, w1, w2, attn_fwd_plan)
    dev = H_t.device
    if M == 0 or L == 0:     # no step: the fully masked row's stats
        return (torch.zeros((M, D), dtype=H_t.dtype, device=dev),
                torch.full((M,), _NEG, device=dev), torch.zeros((M,), device=dev))
    out = torch.empty((M, D), dtype=H_t.dtype, device=dev)
    mx = torch.empty((M,), dtype=torch.float32, device=dev)
    dn = torch.empty((M,), dtype=torch.float32, device=dev)
    _launch("attn_fwd_stats", dev,
            H_t.data_ptr(), mask.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            out.data_ptr(), mx.data_ptr(), dn.data_ptr(), L, M, D, A,
            int(H_t.dtype == torch.bfloat16), *_fwd_plan_args(plan))
    attn_fwd_stats.launches += 1
    return out, mx, dn


attn_fwd_stats.launches = 0


def attn_bwd(H_t, mask, w1, w2, out, mx, dn, dout):
    """Launch K11 (its token kernel, then its weight-gradient kernel; one
    call, counted once): the same outputs as ``attn_bwd_reference``. dW1
    and dw2 come out of the kernel whole, with no reduction after it."""
    L, M, D, A = H_t.shape + w1.shape[-1:]
    if out.dtype != H_t.dtype or dout.dtype != H_t.dtype or \
            tuple(out.shape) != (M, D) or tuple(dout.shape) != (M, D):
        raise ValueError("attn_bwd: out and dout must be [M, D] in H's dtype")
    if mx.dtype != torch.float32 or dn.dtype != torch.float32 or \
            tuple(mx.shape) != (M,) or tuple(dn.shape) != (M,):
        raise ValueError("attn_bwd: mx and dn must be [M] float32")
    *_, plan = _check_attn_args("attn_bwd", H_t, mask, w1, w2, attn_bwd_plan,
                                out, mx, dn, dout)
    dev = H_t.device
    if M == 0 or L == 0:
        return (torch.zeros((L, M, D), dtype=H_t.dtype, device=dev),
                torch.zeros((D, A), device=dev), torch.zeros((A, 1), device=dev))
    dH = torch.empty((L, M, D), dtype=H_t.dtype, device=dev)
    dproj = torch.empty((L * M, A), dtype=torch.float32, device=dev)
    tds = torch.empty((L * M, A), dtype=torch.float32, device=dev)
    dw1 = torch.empty((D, A), dtype=torch.float32, device=dev)
    dw2 = torch.empty((A, 1), dtype=torch.float32, device=dev)
    _launch("attn_bwd", dev,
            H_t.data_ptr(), mask.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            out.data_ptr(), mx.data_ptr(), dn.data_ptr(), dout.data_ptr(),
            dH.data_ptr(), dproj.data_ptr(), tds.data_ptr(), dw1.data_ptr(), dw2.data_ptr(),
            L, M, D, A, plan.tile, int(H_t.dtype == torch.bfloat16))
    attn_bwd.launches += 1
    return dH, dw1, dw2


attn_bwd.launches = 0
