"""LSTM recurrences: plain PyTorch versions and the CUDA kernels.

Two public families, with the JAX package's signatures and layouts
(``induction_network_on_fewrel_tpu/ops/lstm.py``):

**The fused encoder op** ``bilstm_encoder_tm`` (the kernel path,
``_bilstm_fused_tm``): the input projection and the bidirectional
recurrence in one pass, with the projected gates never stored.

    emb_t [L, M, D], wih [2, D, 4u], b [2, 1, 4u], whh [2, u, 4u]
      -> hs [L, M, 2u]   (cols [0:u] forward, [u:2u] reverse, natural time)

Two routes, as in the JAX custom VJP:

* no gradient needed (grad mode off, or no input requires grad): the
  residual-free forward, K1 (``csrc/bilstm_infer.cu``, replaces
  ``_fused_fwd_kernel_infer``) or its plain version ``bilstm_reference``,
  whatever the window;
* otherwise ``_BiLSTMFused``, a ``torch.autograd.Function``. At
  ``cs_window`` W > 0 its forward is K7 (``bilstm_win_fwd``, replaces
  ``_fused_win_fwd_kernel``): hs plus one (h, c) checkpoint pair per W-step
  natural-time block, in the residual dtype; its backward is K8
  (``bilstm_win_bwd``, replaces ``_fused_win_bwd_kernel``): each window
  replayed in f32 from its seed, then the gradient sweep; W = min(W, L) as
  in the JAX call. At W = 0 (the full-residual twin) its forward is K4
  (``bilstm_full_fwd``, replaces ``_fused_fwd_kernel``): hs plus c at every
  step in the residual dtype; its backward is K6 (``bilstm_full_bwd``,
  ``csrc/bilstm_full_bwd.cu``, replaces ``_fused_bwd_kernel``), which reads
  h_prev from the saved hs (in emb's dtype) and c from the saved cs.
  Each backward is two launches: the chain kernel, which carries only the
  gradient chain and streams the gate gradients da (and, for K8, the h_prev
  of every step), then ``lstm_wgrad`` (``csrc/lstm_wgrad.cu``), which takes
  demb, dW_ih, db and dW_hh as products over all L*M rows. Their plain
  two-stage version is ``bilstm_bwd_chain_reference`` then
  ``lstm_wgrad_reference``.

Dtype placement follows the kernel path exactly (lstm.py:1303-1307): wih
is cast to the embedding dtype, b and whh to f32; gate pre-activations
accumulate in f32; the h and c carries and the window replay are f32; hs
and demb are written in the embedding dtype; the residuals in the residual
dtype (None = the embedding dtype); demb's two direction slabs are summed
in the embedding dtype and dW_ih is rounded to wih's dtype (lstm.py:943,
947, 1212, 1216), so in bf16 the Function returns a bf16 dW_ih that
autograd's cast carries back to the f32 parameter. In bf16 this differs
from the JAX ``scan`` backend, so the plain versions here are held against
JAX ``backend="interpret"`` (tests/test_torch_*.py). Gate order is
[i, f, g, o].

**The split recurrence over pre-projected gates** (``lstm_recurrence``,
``lstm_recurrence_grouped``, ``bilstm_recurrence_tm``):

    grouped:     xg [Gc, M, L, 4u], whh [Gc, u, 4u] -> hs [Gc, M, L, u]
    time-major:  xg [L, M, 2*4u],   whh [2, u, 4u]  -> hs [L, M, 2u]
                 (group 1 walks time reversed; natural-time output)

hs in xg's dtype; whh is cast to f32 (lstm.py:443, 688). No gradient
needed: kernel 2 (``lstm_split_infer_cuda``, replaces
``_fwd_kernel_infer``); otherwise ``_SplitRecurrence``: kernel 1
(``lstm_split_fwd``, replaces ``_fwd_kernel``: hs and cs every step, both
in xg's dtype) and kernel 3 (``lstm_split_bwd``, replaces ``_bwd_kernel``:
dxg in xg's dtype, then f32 dW_hh from ``lstm_wgrad``), all in
``csrc/lstm_split.cu``. The kernels take each layout in place through its
(group, row, time) strides; no transpose, flip or pad copy is made.
``lstm_scan`` is the plain f32 counterpart of the JAX ``lstm_scan``
(autograd-differentiable, no kernel).

Each plain version follows its kernel's algorithm step by step (the
window replay, the seeds, the kernel-reverse walk, the residuals read
back in their stored dtype, the rounding points), so the CPU tests check
the port's own backward, not torch autograd.

Backends (``ops.core.resolve_backend``): "reference" is the plain version,
"cuda" the kernels (CUDA tensors only), "auto" picks by the tensor's
device. A kernel wrapper launches on CUDA tensors or raises; it never
falls back. The kernels mask their ragged last row tile themselves, so no
padded copy is made (the JAX calls pad rows to their tile).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from induction_network_on_fewrel_tpu_torch.kernels.build import LIBRARY, check_cuda_tensors
from induction_network_on_fewrel_tpu_torch.ops.core import (
    ACTIVATION_DTYPES,
    needs_grad,
    resolve_backend,
)

# A block's dynamic shared memory on an H100 (232,448 bytes).
SMEM_LIMIT = 232448
# SMs of an H100 SXM, and the threads of a CTA of the cluster bodies
# (``FWD_THREADS`` in ``csrc/lstm_common.cuh``).
NUM_SMS = 132
FWD_THREADS = 256
# The widest gate row (4u) the LSTM kernels' launchers take.
MAX_GATES = 512


def bilstm_encoder_tm(
    emb_t: torch.Tensor,
    wih: torch.Tensor,
    b: torch.Tensor,
    whh: torch.Tensor,
    backend: str = "auto",
    cs_window: int = 8,
    residual_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Projection + bidirectional recurrence over natural-time embeddings.

    ``cs_window`` W > 0: the training route saves one (h, c) pair per W
    natural-time steps (W is clamped to L) and the backward replays each
    window (K7/K8). W = 0: the full-residual twin saves hs and c at every
    step and the backward reads them back (K4/K6).
    ``residual_dtype``: storage dtype of the checkpoints or of the cs
    stream (None = emb's)."""
    if cs_window < 0:
        raise ValueError(f"cs_window must be >= 0, got {cs_window}")
    wih = wih.to(emb_t.dtype)
    b = b.float()
    whh = whh.float()
    kernel = resolve_backend(backend, emb_t.device) == "cuda"
    if not needs_grad(emb_t, wih, b, whh):
        if kernel:
            return bilstm_infer_cuda(emb_t.contiguous(), wih.contiguous(), b.contiguous(),
                                     whh.contiguous())
        return bilstm_reference(emb_t, wih, b, whh)
    W = min(int(cs_window), emb_t.shape[0])
    res_dt = emb_t.dtype if residual_dtype is None else residual_dtype
    return _BiLSTMFused.apply(emb_t, wih, b, whh, kernel, W, res_dt)


class _BiLSTMFused(torch.autograd.Function):
    """The custom VJP of ``_bilstm_fused_tm``: K7 forward and K8 backward
    at W > 0, K4 forward and K6 backward at W = 0 (or their plain
    versions, for ``kernel=False``)."""

    @staticmethod
    def forward(ctx, emb_t, wih, b, whh, kernel: bool, W: int, res_dt):
        args = (emb_t.contiguous(), wih.contiguous(), b.contiguous(), whh.contiguous())
        if W:
            fwd = bilstm_win_fwd if kernel else bilstm_win_fwd_reference
            hs, r1, r2 = fwd(*args, W, res_dt)          # (h, c) checkpoints
        else:
            fwd = bilstm_full_fwd if kernel else bilstm_full_fwd_reference
            hs, r2 = fwd(*args, res_dt)
            r1 = hs                                      # h_prev is read from hs
        ctx.save_for_backward(args[0], r1, r2, *args[1:])
        ctx.kernel, ctx.W = kernel, W
        return hs

    @staticmethod
    def backward(ctx, dhs):
        emb_t, r1, r2, wih, b, whh = ctx.saved_tensors
        dhs = dhs.to(emb_t.dtype).contiguous()
        if ctx.W:
            bwd = bilstm_win_bwd if ctx.kernel else bilstm_win_bwd_reference
            demb, dwih, db, dwhh = bwd(dhs, emb_t, r1, r2, wih, b, whh, ctx.W)
        else:
            bwd = bilstm_full_bwd if ctx.kernel else bilstm_full_bwd_reference
            demb, dwih, db, dwhh = bwd(dhs, emb_t, r1, r2, wih, b, whh)
        # Per-direction demb summed in the emb dtype, dW_ih rounded to
        # wih's dtype, as the JAX rule does (lstm.py:943, 947).
        return (demb[0] + demb[1], dwih.to(wih.dtype), db.reshape(b.shape), dwhh,
                None, None, None)


def lstm_scan(xg: torch.Tensor, whh: torch.Tensor) -> torch.Tensor:
    """([M, L, 4u] pre-projected inputs, [u, 4u]) -> hidden states [M, L, u]
    in f32: the plain counterpart of the JAX ``lstm_scan`` (zero initial
    state, f32 recurrence), differentiable by autograd."""
    M, L, G = xg.shape
    x = xg.float()
    hs = [h for _, h, _ in _steps(lambda t: x[:, t], whh.float(), range(L), M, G // 4)]
    return torch.stack(hs, dim=1)


def lstm_recurrence(xg: torch.Tensor, whh: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Single-group recurrence: xg [M, L, 4u], whh [u, 4u] -> [M, L, u] in
    xg's dtype (f32 recurrence inside)."""
    return lstm_recurrence_grouped(xg[None], whh[None], backend)[0]


def lstm_recurrence_grouped(xg: torch.Tensor, whh: torch.Tensor,
                            backend: str = "auto") -> torch.Tensor:
    """Gc independent recurrences with per-group weights in one launch:
    xg [Gc, M, L, 4u], whh [Gc, u, 4u] -> hs [Gc, M, L, u] in xg's dtype."""
    return _split_recurrence(xg, whh, backend, tm=False)


def bilstm_recurrence_tm(xg_t: torch.Tensor, whh: torch.Tensor,
                         backend: str = "auto") -> torch.Tensor:
    """Bidirectional recurrence over natural-time gate inputs: xg_t
    [L, M, 8u] (cols [0:4u] forward gates, [4u:8u] reverse gates, the
    reverse NOT pre-flipped), whh [2, u, 4u] -> [L, M, 2u] in natural time
    (cols [0:u] forward, [u:2u] reverse), in xg's dtype."""
    if whh.dim() != 3 or whh.shape[0] != 2:
        raise ValueError(
            f"bilstm_recurrence_tm takes exactly 2 groups (forward, reverse), "
            f"got whh {tuple(whh.shape)}"
        )
    return _split_recurrence(xg_t, whh, backend, tm=True)


def _split_recurrence(xg, whh, backend: str, tm: bool) -> torch.Tensor:
    whh = whh.float()
    xg = xg.contiguous()
    _split_dims(xg, whh, tm)
    kernel = resolve_backend(backend, xg.device) == "cuda"
    if not needs_grad(xg, whh):
        fwd = lstm_split_infer_cuda if kernel else lstm_split_infer_reference
        return fwd(xg, whh.contiguous(), tm)
    return _SplitRecurrence.apply(xg, whh, kernel, tm)


class _SplitRecurrence(torch.autograd.Function):
    """The custom VJP of ``_lstm_pallas`` / ``_bilstm_pallas_tm``: kernel 1
    forward saving hs and cs, kernel 3 backward (or their plain versions,
    for ``kernel=False``)."""

    @staticmethod
    def forward(ctx, xg, whh, kernel: bool, tm: bool):
        whh = whh.contiguous()
        hs, cs = (lstm_split_fwd if kernel else lstm_split_fwd_reference)(xg, whh, tm)
        ctx.save_for_backward(xg, hs, cs, whh)
        ctx.kernel, ctx.tm = kernel, tm
        return hs

    @staticmethod
    def backward(ctx, dhs):
        xg, hs, cs, whh = ctx.saved_tensors
        bwd = lstm_split_bwd if ctx.kernel else lstm_split_bwd_reference
        dxg, dwhh = bwd(dhs.to(xg.dtype).contiguous(), xg, hs, cs, whh, ctx.tm)
        return dxg, dwhh, None, None


# --- plain versions -----------------------------------------------------------


def _cell(a: torch.Tensor, c_prev: torch.Tensor, u: int):
    i = torch.sigmoid(a[:, :u])
    f = torch.sigmoid(a[:, u:2 * u])
    g = torch.tanh(a[:, 2 * u:3 * u])
    o = torch.sigmoid(a[:, 3 * u:])
    c = f * c_prev + i * g
    return i, f, g, o, c


def _cell_grad(a, c_prev, c_t, dh_t, dc, u: int):
    """One step's gate-gradient da [M, 4u] (from the recomputed gates a)
    and the dc carry of the kernel-previous step (lstm.py:245-258)."""
    ig, fg, gg, og, _ = _cell(a, c_prev, u)
    tc = torch.tanh(c_t)
    dct = dc + dh_t * og * (1.0 - tc * tc)
    da = torch.cat([
        dct * gg * ig * (1.0 - ig),
        dct * c_prev * fg * (1.0 - fg),
        dct * ig * (1.0 - gg * gg),
        dh_t * tc * og * (1.0 - og),
    ], dim=-1)
    return da, dct * fg


def _times(L: int, rev: bool):
    """Natural times in kernel order."""
    return range(L - 1, -1, -1) if rev else range(L)


def _steps(xg_at, whh32, times, M: int, u: int, h=None, c=None):
    """The forward recurrence in kernel order from (h, c) (zero by
    default): yields (t, h, c) in f32; ``xg_at(t)`` gives the f32 gate
    inputs of natural time t."""
    h = whh32.new_zeros((M, u)) if h is None else h
    c = whh32.new_zeros((M, u)) if c is None else c
    for t in times:
        _, _, _, o, c = _cell(xg_at(t) + h @ whh32, c, u)
        h = o * torch.tanh(c)
        yield t, h, c


def _fused_forward(emb_t, wih, b, whh, W: int | None, res_dt):
    """The fused kernels' forward: bf16 products are exact in f32, so
    upcasting the operands and multiplying in f32 is the f32 accumulation
    the kernel does. W = None: hs only (K1); W > 0: also the checkpoint
    pair of each natural block (K7); W = 0: also c at every step (K4)."""
    L, M, _ = emb_t.shape
    u = whh.shape[1]
    x = emb_t.float()
    wih32, b32, whh32 = wih.to(emb_t.dtype).float(), b.float(), whh.float()
    hs = torch.empty((L, M, 2 * u), dtype=emb_t.dtype, device=emb_t.device)
    nB = -(-L // W) if W else L
    r1 = torch.empty((nB, M, 2 * u), dtype=res_dt, device=emb_t.device) if W else None
    r2 = torch.empty((nB, M, 2 * u), dtype=res_dt, device=emb_t.device) if W is not None else None
    for d in range(2):
        cols = slice(d * u, (d + 1) * u)
        xg = torch.matmul(x, wih32[d]) + b32[d]            # [L, M, 4u] f32
        for t, h, c in _steps(lambda t: xg[t], whh32[d], _times(L, d == 1), M, u):
            hs[t, :, cols] = h.to(emb_t.dtype)
            if W == 0:
                r2[t, :, cols] = c.to(res_dt)
            # The block's kernel-last step: this state is its checkpoint.
            elif W and (t % W == 0 if d else (t % W == W - 1 or t == L - 1)):
                r1[t // W, :, cols] = h.to(res_dt)
                r2[t // W, :, cols] = c.to(res_dt)
    return hs, r1, r2


def bilstm_reference(emb_t, wih, b, whh) -> torch.Tensor:
    """The plain PyTorch version of K1 (no residuals)."""
    return _fused_forward(emb_t, wih, b, whh, None, None)[0]


def bilstm_win_fwd_reference(emb_t, wih, b, whh, W: int, res_dt):
    """The plain version of K7: (hs, ch, cc) with ch, cc [ceil(L/W), M, 2u]
    holding each natural block's kernel-last (h, c) in ``res_dt``."""
    return _fused_forward(emb_t, wih, b, whh, W, res_dt)


def bilstm_full_fwd_reference(emb_t, wih, b, whh, res_dt):
    """The plain version of K4: (hs, cs), cs [L, M, 2u] holding c at every
    step in ``res_dt``."""
    hs, _, cs = _fused_forward(emb_t, wih, b, whh, 0, res_dt)
    return hs, cs


def _fused_backward(dhs, emb_t, wih, b, whh, states):
    """The gradient sweep of K8 and K6. ``states(d)`` yields, in
    kernel-reverse order, (t, h_prev, c_prev, c_t) in f32 for direction d.
    Returns demb [2, L, M, D] in emb's dtype and f32 dW_ih [2, D, 4u],
    db [2, 4u], dW_hh [2, u, 4u] (the kernels' per-tile partials, summed)."""
    L, M, D = emb_t.shape
    u = whh.shape[1]
    x = emb_t.float()
    wih32, b32, whh32 = wih.float(), b.float(), whh.float()
    dhs32 = dhs.float()
    demb = torch.empty((2, L, M, D), dtype=emb_t.dtype, device=emb_t.device)
    dwih = x.new_zeros((2, D, 4 * u))
    db = x.new_zeros((2, 4 * u))
    dwhh = x.new_zeros((2, u, 4 * u))
    for d in range(2):
        cols = slice(d * u, (d + 1) * u)
        dh = x.new_zeros((M, u))
        dc = x.new_zeros((M, u))
        for t, h_prev, c_prev, c_t in states(d):
            a = x[t] @ wih32[d] + b32[d] + h_prev @ whh32[d]
            da, dc = _cell_grad(a, c_prev, c_t, dhs32[t, :, cols] + dh, dc, u)
            demb[d, t] = (da @ wih32[d].T).to(emb_t.dtype)
            dwih[d] += x[t].T @ da
            db[d] += da.sum(0)
            dwhh[d] += h_prev.T @ da
            dh = da @ whh32[d].T
    return demb, dwih, db, dwhh


def bilstm_win_bwd_reference(dhs, emb_t, ch, cc, wih, b, whh, W: int):
    """The plain version of K8, step for step: per direction, blocks in
    kernel-reverse order; at each block's entry its forward steps replayed
    in f32 from the seed (the kernel-previous block's checkpoint, zero for
    the direction's kernel-first block); then the gradient steps."""
    L, M, _ = emb_t.shape
    u = whh.shape[1]
    nB = ch.shape[0]
    x = emb_t.float()
    wih32, b32, whh32 = wih.float(), b.float(), whh.float()

    def states(d):
        cols = slice(d * u, (d + 1) * u)
        for blk in (range(nB - 1, -1, -1) if d == 0 else range(nB)):
            base = blk * W
            Wb = min(W, L - base)
            if blk == (0 if d == 0 else nB - 1):
                seed_h, seed_c = x.new_zeros((M, u)), x.new_zeros((M, u))
            else:
                s = blk - 1 if d == 0 else blk + 1
                seed_h, seed_c = ch[s, :, cols].float(), cc[s, :, cols].float()
            win = {o: (h, c) for o, h, c in _steps(        # keyed by block offset
                lambda o: x[base + o] @ wih32[d] + b32[d], whh32[d],
                _times(Wb, d == 1), M, u, seed_h, seed_c)}
            for o in _times(Wb, d == 0):
                at_seed = o == (0 if d == 0 else Wb - 1)
                h_prev, c_prev = (seed_h, seed_c) if at_seed else win[o - 1 if d == 0 else o + 1]
                yield base + o, h_prev, c_prev, win[o][1]

    return _fused_backward(dhs, emb_t, wih, b, whh, states)


def bilstm_full_bwd_reference(dhs, emb_t, hs, cs, wih, b, whh):
    """The plain version of K6: per direction, kernel-reverse walk over the
    saved streams; c_t from cs, h_prev from hs and c_prev from cs at the
    kernel-previous step (their stored dtypes, upcast), zero at the
    direction's kernel-first step. Returns what K8's plain version does."""
    L, M, _ = emb_t.shape
    u = whh.shape[1]

    def states(d):
        cols = slice(d * u, (d + 1) * u)
        times = list(_times(L, d == 1))
        zero = hs.new_zeros((M, u), dtype=torch.float32)
        for s in range(L - 1, -1, -1):
            t = times[s]
            if s:
                tp = times[s - 1]
                h_prev, c_prev = hs[tp, :, cols].float(), cs[tp, :, cols].float()
            else:
                h_prev, c_prev = zero, zero
            yield t, h_prev, c_prev, cs[t, :, cols].float()

    return _fused_backward(dhs, emb_t, wih, b, whh, states)


def bilstm_bwd_chain_reference(dhs, emb_t, r1, r2, wih, b, whh, W: int):
    """The plain version of the chain kernels' stage: K8's at W > 0 (r1, r2
    = the checkpoints ch, cc), K6's at W = 0 (r1, r2 = the saved hs, cs).
    Per direction in kernel-reverse order, the gate gradient of every step
    and the h_prev it used: da [2, L, M, 4u] and hp [2, L, M, u], f32. At
    W > 0 each window's gates are kept from its replay, as K8 keeps them,
    and h_prev at a window's kernel-first step is the (rounded) seed; at
    W = 0 the gates come from the saved hs at the kernel-previous step."""
    L, M, _ = emb_t.shape
    u = whh.shape[1]
    x = emb_t.float()
    wih32, b32, whh32 = wih.float(), b.float(), whh.float()
    da = x.new_zeros((2, L, M, 4 * u))
    hp = x.new_zeros((2, L, M, u))

    def window_steps(d):
        """(t, pre-activations, h_prev, c_prev, c_t) in kernel-reverse order."""
        cols = slice(d * u, (d + 1) * u)
        nB = r1.shape[0]
        for blk in (range(nB - 1, -1, -1) if d == 0 else range(nB)):
            base = blk * W
            Wb = min(W, L - base)
            if blk == (0 if d == 0 else nB - 1):
                h, c = x.new_zeros((M, u)), x.new_zeros((M, u))
            else:
                sb = blk - 1 if d == 0 else blk + 1
                h, c = r1[sb, :, cols].float(), r2[sb, :, cols].float()
            kept = []                                   # the replay, kernel order
            for t in (range(base, base + Wb) if d == 0 else range(base + Wb - 1, base - 1, -1)):
                a = x[t] @ wih32[d] + b32[d] + h @ whh32[d]
                _, _, _, o, c_t = _cell(a, c, u)
                kept.append((t, a, h, c, c_t))
                h, c = o * torch.tanh(c_t), c_t
            yield from reversed(kept)

    def saved_steps(d):
        cols = slice(d * u, (d + 1) * u)
        times = list(_times(L, d == 1))
        zero = x.new_zeros((M, u))
        for s in range(L - 1, -1, -1):
            t = times[s]
            h, c = ((r1[times[s - 1], :, cols].float(), r2[times[s - 1], :, cols].float())
                    if s else (zero, zero))
            yield t, x[t] @ wih32[d] + b32[d] + h @ whh32[d], h, c, r2[t, :, cols].float()

    for d in range(2):
        cols = slice(d * u, (d + 1) * u)
        dh = x.new_zeros((M, u))
        dc = x.new_zeros((M, u))
        for t, a, h_prev, c_prev, c_t in (window_steps(d) if W else saved_steps(d)):
            da[d, t], dc = _cell_grad(a, c_prev, c_t, dhs[t, :, cols].float() + dh, dc, u)
            hp[d, t] = h_prev
            dh = da[d, t] @ whh32[d].T
    return da, hp


def lstm_wgrad_reference(da, emb_t, hp, wih):
    """The plain version of ``lstm_wgrad``: from the chain's da and hp (f32,
    [2, L, M, 4u] and [2, L, M, u]), per direction over all L*M rows:
    demb = da W_ih^T in emb's dtype [2, L, M, D], and the f32 sums
    dW_ih = emb^T da [2, D, 4u], db = sum da [2, 4u], dW_hh = hp^T da
    [2, u, 4u]."""
    x = emb_t.float().flatten(0, 1)                    # [L*M, D]
    da2, hp2 = da.flatten(1, 2), hp.flatten(1, 2)      # [2, L*M, *]
    demb = torch.matmul(da2, wih.float().transpose(1, 2)).to(emb_t.dtype)
    dwih = torch.matmul(x.T, da2)
    dwhh = torch.matmul(hp2.transpose(1, 2), da2)
    return demb.view(da.shape[:3] + (-1,)), dwih, da2.sum(1), dwhh


def _split_dims(xg, whh, tm: bool) -> tuple[int, int, int, int]:
    """(Gc, M, L, u) of a split-recurrence input, or ValueError."""
    if whh.dim() != 3 or whh.shape[2] != 4 * whh.shape[1]:
        raise ValueError(f"whh must be [Gc, u, 4u], got {tuple(whh.shape)}")
    Gc, u, G = whh.shape
    if tm:
        if xg.dim() != 3 or xg.shape[2] != Gc * G:
            raise ValueError(f"xg_t must be [L, M, {Gc}*{G}], got {tuple(xg.shape)}")
        L, M = xg.shape[:2]
    else:
        if xg.dim() != 4 or xg.shape[0] != Gc or xg.shape[3] != G:
            raise ValueError(f"xg must be [{Gc}, M, L, {G}], got {tuple(xg.shape)}")
        M, L = xg.shape[1:3]
    return Gc, M, L, u


def _gmt(x: torch.Tensor, groups: int, tm: bool) -> torch.Tensor:
    """The (group, row, time, column) view of a split-recurrence tensor:
    the grouped layout [Gc, M, L, w] as it is, the time-major [L, M, Gc*w]
    one regrouped without a copy."""
    if not tm:
        return x
    L, M, width = x.shape
    return x.view(L, M, groups, width // groups).permute(2, 1, 0, 3)


def _split_hs_like(xg, Gc: int, L: int, M: int, u: int, tm: bool):
    shape = (L, M, Gc * u) if tm else (Gc, M, L, u)
    return torch.empty(shape, dtype=xg.dtype, device=xg.device)


def _split_forward(xg, whh, tm: bool, with_cs: bool):
    Gc, M, L, u = _split_dims(xg, whh, tm)
    hs = _split_hs_like(xg, Gc, L, M, u, tm)
    cs = _split_hs_like(xg, Gc, L, M, u, tm) if with_cs else None
    xv, hv = _gmt(xg, Gc, tm), _gmt(hs, Gc, tm)
    cv = _gmt(cs, Gc, tm) if with_cs else None
    for g in range(Gc):
        for t, h, c in _steps(lambda t: xv[g, :, t].float(), whh[g].float(),
                              _times(L, tm and g == 1), M, u):
            hv[g, :, t] = h.to(xg.dtype)
            if with_cs:
                cv[g, :, t] = c.to(xg.dtype)
    return hs, cs


def lstm_split_infer_reference(xg, whh, tm: bool) -> torch.Tensor:
    """The plain version of kernel 2: hs in xg's dtype."""
    return _split_forward(xg, whh, tm, with_cs=False)[0]


def lstm_split_fwd_reference(xg, whh, tm: bool):
    """The plain version of kernel 1: (hs, cs), both in xg's dtype."""
    return _split_forward(xg, whh, tm, with_cs=True)


def lstm_split_bwd_reference(dhs, xg, hs, cs, whh, tm: bool):
    """The plain version of kernel 3: per group, kernel-reverse walk over
    the saved hs and cs (xg's dtype, upcast; zero state at the kernel-first
    step), gates recomputed from xg + h_prev W_hh. Returns dxg in xg's
    dtype and f32 dW_hh [Gc, u, 4u] (the per-tile partials, summed)."""
    Gc, M, L, u = _split_dims(xg, whh, tm)
    whh32 = whh.float()
    dxg = torch.empty_like(xg)
    dwhh = whh32.new_zeros(whh.shape)
    xv, dxv = _gmt(xg, Gc, tm), _gmt(dxg, Gc, tm)
    hv, cv, dhv = _gmt(hs, Gc, tm), _gmt(cs, Gc, tm), _gmt(dhs, Gc, tm)
    for g in range(Gc):
        times = list(_times(L, tm and g == 1))
        dh = whh32.new_zeros((M, u))
        dc = whh32.new_zeros((M, u))
        for s in range(L - 1, -1, -1):
            t = times[s]
            if s:
                h_prev, c_prev = hv[g, :, times[s - 1]].float(), cv[g, :, times[s - 1]].float()
            else:
                h_prev = c_prev = whh32.new_zeros((M, u))
            a = xv[g, :, t].float() + h_prev @ whh32[g]
            da, dc = _cell_grad(a, c_prev, cv[g, :, t].float(), dhv[g, :, t].float() + dh, dc, u)
            dxv[g, :, t] = da.to(xg.dtype)
            dwhh[g] += h_prev.T @ da
            dh = da @ whh32[g].T
    return dxg, dwhh


# --- kernel wrappers ------------------------------------------------------------


class FwdPlan(NamedTuple):
    """Launch plan of the cluster forward (K1, K7, K4, kernels 1/2)."""

    tm: int        # rows per tile
    cluster: int   # CTAs per cluster; each owns u / cluster units
    ctas: int      # ceil(M / tm) * groups * cluster
    smem: int      # dynamic shared memory of a CTA, bytes
    threads: int = FWD_THREADS


def fwd_psplits(tm: int, cluster: int, D: int, u: int) -> int:
    """Split of the cluster forward's projection over D: 256 threads over
    (tm/2) x (u/cluster) tiles of 2 rows x 4 columns (1 without a
    projection; ``lstm::fwd_psplits``)."""
    if not D:
        return 1
    return max(1, min(D, FWD_THREADS // (tm // 2 * (u // cluster))))


def _core_floats(tm: int, cluster: int, D: int, u: int, hs: int) -> int:
    """Floats of a cluster CTA's forward step (``lstm::fwd_core_floats``):
    the W_hh slice [u, NC], the W_ih slice [D, NC] and b [NC], two h
    buffers [u, hs], the input gates [P, tm, NC], the split-K partials
    [S, tm, NC + 8] and the staged embeddings [D, tm + 2] rounded up to 4
    floats, NC = 4u / cluster."""
    nc = 4 * u // cluster
    splits = FWD_THREADS // (tm * nc // 16)
    return (u * nc + D * nc + (nc if D else 0) + 2 * u * hs
            + fwd_psplits(tm, cluster, D, u) * tm * nc + splits * tm * (nc + 8)
            + -(-D * (tm + 2) // 4) * 4)


def fwd_smem(tm: int, cluster: int, D: int, u: int) -> int:
    """Shared memory of a cluster-forward CTA in bytes (D = 0: no
    projection, the split kernels): two mbarriers (16 bytes) and the
    forward step with h buffers of row stride tm + 4 (``lstm::fwd_smem`` in
    ``csrc/lstm_common.cuh``)."""
    return 16 + 4 * _core_floats(tm, cluster, D, u, tm + 4)


def fwd_plan(M: int, D: int, u: int, groups: int = 2) -> FwdPlan:
    """The cluster forward's plan for M rows (D = 0 for the split kernels).

    The cluster is the largest of 8, 4, 2, 1 that divides u, so every CTA
    owns whole units. The tile is 16 rows unless that gives more CTAs than
    the card has SMs, then 32 (M = 200, u = 128: 7 x 2 x 8 = 112 CTAs, one
    wave). Neither the dtype nor the residual mode changes the plan: W_ih is
    staged in f32 and the residuals go from registers to global memory.
    Raises ValueError for widths the body cannot take."""
    cluster = next(c for c in (8, 4, 2, 1) if u % c == 0)
    units = u // cluster
    big = -(-M // 16) * groups * cluster > NUM_SMS
    why = ""
    for tm in ((32, 16) if big else (16,)):
        if tm * 4 * units // 16 > FWD_THREADS or tm * units > 4 * FWD_THREADS:
            why = (f"{units} units per CTA at cluster size {cluster} need more than "
                   f"{FWD_THREADS} threads")
            continue
        smem = fwd_smem(tm, cluster, D, u)
        if smem > SMEM_LIMIT:
            why = f"a CTA would need {smem} bytes of shared memory"
            continue
        return FwdPlan(tm, cluster, -(-M // tm) * groups * cluster, smem)
    raise ValueError(f"the cluster LSTM forward cannot take D={D}, u={u}: {why}")


class BwdPlan(NamedTuple):
    """Launch plan of the cluster backward chain (K8, K6, kernel 3)."""

    tm: int        # rows per tile
    cluster: int   # CTAs per cluster; each owns u / cluster units
    ctas: int      # ceil(M / tm) * groups * cluster
    smem: int      # dynamic shared memory of a CTA, bytes
    why: str = ""  # why the CTAs take more than one wave, when they do
    threads: int = FWD_THREADS


def bwd_smem(tm: int, cluster: int, D: int, u: int, W: int) -> int:
    """Shared memory of a cluster-backward CTA in bytes (``lstm::bwd_smem``
    in ``csrc/lstm_common.cuh``): four mbarriers (32 bytes), the forward
    step (h buffers of row stride tm where a window must fit, W > 0, else
    tm + 4), the window's gates and c of the own cells [W, 5, tm u/cluster]
    (W = 0: none) and the dh reduce-scatter buffers [2, cluster, u/cluster,
    tm]."""
    return 32 + 4 * (_core_floats(tm, cluster, D, u, tm if W else tm + 4)
                     + 5 * W * tm * (u // cluster) + 2 * tm * u)


def bwd_plan(M: int, D: int, u: int, W: int, groups: int = 2) -> BwdPlan:
    """The cluster backward's plan for M rows, window W (0: the saved
    streams of K6 and kernel 3) and D (0: kernel 3).

    The cluster is the largest of 8, 4, 2, 1 that leaves each CTA a
    multiple of 4 units (a dh tile's 4 units go to one CTA). The tile is 16
    rows, or 32 when 16 would give more CTAs than the card has SMs (M = 200,
    u = 128, W = 8: 7 x 2 x 8 = 112 CTAs, one wave); a tile whose window
    does not fit shared memory steps down to 8 and 4 rows, and ``why`` then
    says why the plan takes more than one wave. Raises ValueError for
    widths the body cannot take."""
    cluster = next((c for c in (8, 4, 2, 1) if u % c == 0 and (u // c) % 4 == 0), None)
    if cluster is None:
        raise ValueError(f"the cluster LSTM backward cannot take u={u}: no cluster size "
                         "leaves each CTA a multiple of 4 units")
    units = u // cluster
    big = -(-M // 16) * groups * cluster > NUM_SMS
    why = ""
    for tm in ((32, 16, 8, 4) if big else (16, 8, 4)):
        if (tm * 4 * units // 16 > FWD_THREADS or tm * units > 4 * FWD_THREADS
                or tm // 4 * (u // 4) > FWD_THREADS):
            why = f"a {tm}-row tile of u={u} needs more than {FWD_THREADS} threads"
            continue
        smem = bwd_smem(tm, cluster, D, u, W)
        if smem > SMEM_LIMIT:
            why = f"a {tm}-row tile at W={W} would need {smem} bytes of shared memory"
            continue
        ctas = -(-M // tm) * groups * cluster
        return BwdPlan(tm, cluster, ctas, smem, why if ctas > NUM_SMS else "")
    raise ValueError(f"the cluster LSTM backward cannot take D={D}, u={u}, W={W}: {why}")


def kernel_width_refusal(D: int, u: int, W: int) -> str:
    """Why the BiLSTM kernels cannot take input width D, hidden width u and
    window W (0: the full-residual route), or "" when they can: the
    launchers' gate-row limit, then the forward and backward plans at the
    smallest row tile (a width no tile takes fails at every M)."""
    if 4 * u > MAX_GATES:
        return f"4u = {4 * u} exceeds the kernels' {MAX_GATES} gate columns"
    try:
        fwd_plan(1, D, u)
        bwd_plan(1, D, u, W)
    except ValueError as e:
        return str(e)
    return ""


def _plan_for(name, plan, *args):
    try:
        return plan(*args)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None


def _check_lstm_args(name, emb_t, wih, b, whh, plan=None):
    """Dtype, shape and device checks of the fused kernels; returns (u,
    ``plan(M, D, u)`` or None). The plan is made before the device check,
    so a width the body cannot take is refused on any device."""
    if emb_t.dtype not in ACTIVATION_DTYPES or wih.dtype != emb_t.dtype:
        raise TypeError(
            f"{name}: emb/wih must share a dtype in {ACTIVATION_DTYPES}, "
            f"got {emb_t.dtype}/{wih.dtype}"
        )
    if b.dtype != torch.float32 or whh.dtype != torch.float32:
        raise TypeError(f"{name}: b and whh must be float32")
    if whh.dim() != 3 or whh.shape[0] != 2 or whh.shape[2] != 4 * whh.shape[1]:
        raise ValueError(f"{name}: whh must be [2, u, 4u], got {tuple(whh.shape)}")
    D, u = emb_t.shape[2], whh.shape[1]
    G = 4 * u
    if tuple(wih.shape) != (2, D, G) or tuple(b.shape) != (2, 1, G):
        raise ValueError(
            f"{name}: wih {tuple(wih.shape)} / b {tuple(b.shape)} do not match D={D}, u={u}"
        )
    if G > MAX_GATES:
        raise ValueError(f"{name}: 4u = {G} exceeds the kernel's {MAX_GATES} threads")
    plan = _plan_for(name, plan, emb_t.shape[1], D, u) if plan else None
    check_cuda_tensors(name, emb_t, wih, b, whh)
    return u, plan


def _check_residuals(name, res_dt):
    if res_dt not in ACTIVATION_DTYPES:
        raise TypeError(f"{name}: residual dtype must be one of {ACTIVATION_DTYPES}, got {res_dt}")


def _refuse_grad(name, *tensors):
    """A forward-only kernel keeps no residuals, so its output could carry
    no gradient: refuse an input that requires grad while grad mode is on."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: an input requires grad; the forward-only kernel would "
            "return a detached output (the training route is the op's autograd Function)"
        )


def _launch(name, device, *args):
    """Launch ``name`` on the current stream of ``device`` (the stream is
    the launcher's last argument)."""
    LIBRARY.launch_on(device, name, *args)


def bilstm_infer_cuda(emb_t, wih, b, whh) -> torch.Tensor:
    """Launch K1 on the current stream (no synchronize). Raises for CPU
    tensors, unsupported dtypes, shapes or layouts, launch failures, and
    for an input that requires grad while grad mode is on."""
    _refuse_grad("bilstm_infer_cuda", emb_t, wih, b, whh)
    u, plan = _check_lstm_args("bilstm_infer_cuda", emb_t, wih, b, whh, fwd_plan)
    L, M, D = emb_t.shape
    hs = torch.empty((L, M, 2 * u), dtype=emb_t.dtype, device=emb_t.device)
    if L == 0 or M == 0:
        return hs
    _launch("bilstm_infer_fwd", emb_t.device,
            emb_t.data_ptr(), wih.data_ptr(), b.data_ptr(), whh.data_ptr(),
            hs.data_ptr(), L, M, D, u, int(emb_t.dtype == torch.bfloat16), plan.tm,
            plan.cluster)
    bilstm_infer_cuda.launches += 1
    return hs


bilstm_infer_cuda.launches = 0


def bilstm_win_fwd(emb_t, wih, b, whh, W: int, res_dt):
    """Launch K7: (hs, ch, cc) as ``bilstm_win_fwd_reference``."""
    u, plan = _check_lstm_args("bilstm_win_fwd", emb_t, wih, b, whh, fwd_plan)
    _check_residuals("bilstm_win_fwd", res_dt)
    L, M, D = emb_t.shape
    if not 1 <= W <= L:
        raise ValueError(f"bilstm_win_fwd: window {W} outside [1, L={L}]")
    nB = -(-L // W)
    hs = torch.empty((L, M, 2 * u), dtype=emb_t.dtype, device=emb_t.device)
    ch = torch.empty((nB, M, 2 * u), dtype=res_dt, device=emb_t.device)
    cc = torch.empty_like(ch)
    if M == 0:
        return hs, ch, cc
    _launch("bilstm_win_fwd", emb_t.device,
            emb_t.data_ptr(), wih.data_ptr(), b.data_ptr(), whh.data_ptr(),
            hs.data_ptr(), ch.data_ptr(), cc.data_ptr(), L, M, D, u, W,
            int(emb_t.dtype == torch.bfloat16), int(res_dt == torch.bfloat16), plan.tm,
            plan.cluster)
    bilstm_win_fwd.launches += 1
    return hs, ch, cc


bilstm_win_fwd.launches = 0


def bilstm_full_fwd(emb_t, wih, b, whh, res_dt):
    """Launch K4: (hs, cs) as ``bilstm_full_fwd_reference``."""
    u, plan = _check_lstm_args("bilstm_full_fwd", emb_t, wih, b, whh, fwd_plan)
    _check_residuals("bilstm_full_fwd", res_dt)
    L, M, D = emb_t.shape
    hs = torch.empty((L, M, 2 * u), dtype=emb_t.dtype, device=emb_t.device)
    cs = torch.empty((L, M, 2 * u), dtype=res_dt, device=emb_t.device)
    if L == 0 or M == 0:
        return hs, cs
    _launch("bilstm_full_fwd", emb_t.device,
            emb_t.data_ptr(), wih.data_ptr(), b.data_ptr(), whh.data_ptr(),
            hs.data_ptr(), cs.data_ptr(), L, M, D, u,
            int(emb_t.dtype == torch.bfloat16), int(res_dt == torch.bfloat16), plan.tm,
            plan.cluster)
    bilstm_full_fwd.launches += 1
    return hs, cs


bilstm_full_fwd.launches = 0


def lstm_wgrad(da, emb_t, h, wih):
    """Launch the weight-gradient kernel of the fused backward (K8, K6):
    from da [2, L, M, 4u] (f32) and the h_prev source ``h`` (K8's hp
    stream [2, L, M, u] in f32, or K6's saved hs [L, M, 2u] in emb's dtype,
    read at the kernel-previous step) the four outputs of
    ``lstm_wgrad_reference``."""
    L, M, D = emb_t.shape
    u = wih.shape[2] // 4
    shift = tuple(h.shape) == (L, M, 2 * u)
    if da.dtype != torch.float32 or tuple(da.shape) != (2, L, M, 4 * u):
        raise ValueError(f"lstm_wgrad: da {da.dtype} {tuple(da.shape)} != f32 [2, L, M, 4u]")
    if not (shift and h.dtype == emb_t.dtype
            or h.dtype == torch.float32 and tuple(h.shape) == (2, L, M, u)):
        raise ValueError(f"lstm_wgrad: h {h.dtype} {tuple(h.shape)} is neither hp nor hs")
    check_cuda_tensors("lstm_wgrad", da, emb_t, h, wih)
    dev = emb_t.device
    demb = torch.empty((2, L, M, D), dtype=emb_t.dtype, device=dev)
    dwih = torch.empty((2, D, 4 * u), dtype=torch.float32, device=dev)
    db = torch.empty((2, 4 * u), dtype=torch.float32, device=dev)
    dwhh = torch.empty((2, u, 4 * u), dtype=torch.float32, device=dev)
    if not L * M:
        return demb, dwih.zero_(), db.zero_(), dwhh.zero_()
    hv = (u, 2 * u, 2 * M * u) if shift else (L * M * u, u, M * u)
    _launch("lstm_wgrad", dev, da.data_ptr(), emb_t.data_ptr(), h.data_ptr(), wih.data_ptr(),
            demb.data_ptr(), dwih.data_ptr(), db.data_ptr(), dwhh.data_ptr(), L, M, D, u, 2,
            0, D, M * D, *hv, int(shift), 1, int(emb_t.dtype == torch.bfloat16),
            int(h.dtype == torch.float32))
    lstm_wgrad.launches += 1
    return demb, dwih, db, dwhh


lstm_wgrad.launches = 0


def bilstm_win_bwd(dhs, emb_t, ch, cc, wih, b, whh, W: int):
    """Launch K8's chain kernel, then ``lstm_wgrad``: the same four outputs
    as ``bilstm_win_bwd_reference``."""
    L, M, D = emb_t.shape
    if not 1 <= W <= L:
        raise ValueError(f"bilstm_win_bwd: window {W} outside [1, L={L}]")
    u, plan = _check_lstm_args("bilstm_win_bwd", emb_t, wih, b, whh,
                               lambda M_, D_, u_: bwd_plan(M_, D_, u_, W))
    check_cuda_tensors("bilstm_win_bwd", emb_t, dhs, ch, cc)
    _check_residuals("bilstm_win_bwd", ch.dtype)
    if dhs.dtype != emb_t.dtype or tuple(dhs.shape) != (L, M, 2 * u):
        raise ValueError(f"bilstm_win_bwd: dhs {dhs.dtype} {tuple(dhs.shape)} != hs")
    if tuple(ch.shape) != (-(-L // W), M, 2 * u) or cc.shape != ch.shape or cc.dtype != ch.dtype:
        raise ValueError(f"bilstm_win_bwd: checkpoints {tuple(ch.shape)} do not match W={W}")
    da = torch.empty((2, L, M, 4 * u), dtype=torch.float32, device=emb_t.device)
    hp = torch.empty((2, L, M, u), dtype=torch.float32, device=emb_t.device)
    if M:
        _launch("bilstm_win_bwd", emb_t.device,
                dhs.data_ptr(), emb_t.data_ptr(), ch.data_ptr(), cc.data_ptr(), wih.data_ptr(),
                b.data_ptr(), whh.data_ptr(), da.data_ptr(), hp.data_ptr(), L, M, D, u, W,
                int(emb_t.dtype == torch.bfloat16), int(ch.dtype == torch.bfloat16), plan.tm,
                plan.cluster)
        bilstm_win_bwd.launches += 1
    return lstm_wgrad(da, emb_t, hp, wih)


bilstm_win_bwd.launches = 0


def bilstm_full_bwd(dhs, emb_t, hs, cs, wih, b, whh):
    """Launch K6's chain kernel, then ``lstm_wgrad`` on the saved hs: the
    same four outputs as ``bilstm_full_bwd_reference``."""
    u, plan = _check_lstm_args("bilstm_full_bwd", emb_t, wih, b, whh,
                               lambda M_, D_, u_: bwd_plan(M_, D_, u_, 0))
    check_cuda_tensors("bilstm_full_bwd", emb_t, dhs, hs, cs)
    _check_residuals("bilstm_full_bwd", cs.dtype)
    L, M, D = emb_t.shape
    for nm, x in (("dhs", dhs), ("hs", hs)):
        if x.dtype != emb_t.dtype or tuple(x.shape) != (L, M, 2 * u):
            raise ValueError(f"bilstm_full_bwd: {nm} {x.dtype} {tuple(x.shape)} != [L, M, 2u]")
    if tuple(cs.shape) != (L, M, 2 * u):
        raise ValueError(f"bilstm_full_bwd: cs {tuple(cs.shape)} != [L, M, 2u]")
    da = torch.empty((2, L, M, 4 * u), dtype=torch.float32, device=emb_t.device)
    if L and M:
        _launch("bilstm_full_bwd", emb_t.device,
                dhs.data_ptr(), emb_t.data_ptr(), hs.data_ptr(), cs.data_ptr(), wih.data_ptr(),
                b.data_ptr(), whh.data_ptr(), da.data_ptr(), L, M, D, u,
                int(emb_t.dtype == torch.bfloat16), int(cs.dtype == torch.bfloat16), plan.tm,
                plan.cluster)
        bilstm_full_bwd.launches += 1
    return lstm_wgrad(da, emb_t, hs, wih)


bilstm_full_bwd.launches = 0


def _check_split_args(name, xg, whh, tm: bool, *streams, plan=None):
    """Dtype, shape and device checks of the split kernels; returns
    (Gc, M, L, u, ``plan(M, 0, u, Gc)`` or None). ``streams`` are u-wide
    tensors laid out like hs. As in ``_check_lstm_args``, the plan is made
    before the device check."""
    if xg.dtype not in ACTIVATION_DTYPES or whh.dtype != torch.float32:
        raise TypeError(f"{name}: xg must be one of {ACTIVATION_DTYPES} and whh float32, "
                        f"got {xg.dtype}/{whh.dtype}")
    Gc, M, L, u = _split_dims(xg, whh, tm)
    if 4 * u > MAX_GATES:
        raise ValueError(f"{name}: 4u = {4 * u} exceeds the kernel's {MAX_GATES} threads")
    want = (L, M, Gc * u) if tm else (Gc, M, L, u)
    for x in streams:
        if x.dtype != xg.dtype or tuple(x.shape) != want:
            raise ValueError(f"{name}: {x.dtype} {tuple(x.shape)} != hs {xg.dtype} {want}")
    plan = _plan_for(name, plan, M, 0, u, Gc) if plan else None
    check_cuda_tensors(name, xg, whh, *streams)
    return Gc, M, L, u, plan


def _split_launch(name, xg, whh, tm: bool, ptrs, hs, extra=()):
    """Launch ``name`` with the (group, row, time) strides of xg and hs;
    ``extra`` goes before the stream."""
    Gc, M, L, u = _split_dims(xg, whh, tm)
    strides = _gmt(xg, Gc, tm).stride()[:3] + _gmt(hs, Gc, tm).stride()[:3]
    _launch(name, xg.device, *ptrs, L, M, u, Gc, *strides, 1 if tm else -1,
            int(xg.dtype == torch.bfloat16), *extra)


def lstm_split_infer_cuda(xg, whh, tm: bool) -> torch.Tensor:
    """Launch kernel 2: hs as ``lstm_split_infer_reference``. Raises, like
    K1, for an input that requires grad while grad mode is on."""
    _refuse_grad("lstm_split_infer_cuda", xg, whh)
    Gc, M, L, u, plan = _check_split_args("lstm_split_infer_cuda", xg, whh, tm, plan=fwd_plan)
    hs = _split_hs_like(xg, Gc, L, M, u, tm)
    if M and L:
        _split_launch("lstm_split_fwd_infer", xg, whh, tm,
                      (xg.data_ptr(), whh.data_ptr(), hs.data_ptr()), hs,
                      (plan.tm, plan.cluster))
        lstm_split_infer_cuda.launches += 1
    return hs


lstm_split_infer_cuda.launches = 0


def lstm_split_fwd(xg, whh, tm: bool):
    """Launch kernel 1: (hs, cs) as ``lstm_split_fwd_reference``."""
    Gc, M, L, u, plan = _check_split_args("lstm_split_fwd", xg, whh, tm, plan=fwd_plan)
    hs = _split_hs_like(xg, Gc, L, M, u, tm)
    cs = torch.empty_like(hs)
    if M and L:
        _split_launch("lstm_split_fwd", xg, whh, tm,
                      (xg.data_ptr(), whh.data_ptr(), hs.data_ptr(), cs.data_ptr()), hs,
                      (plan.tm, plan.cluster))
        lstm_split_fwd.launches += 1
    return hs, cs


lstm_split_fwd.launches = 0


def lstm_split_bwd(dhs, xg, hs, cs, whh, tm: bool):
    """Launch kernel 3's chain kernel (dxg and the f32 da stream), then
    ``lstm_wgrad`` for dW_hh from the saved hs: (dxg, dwhh) as
    ``lstm_split_bwd_reference``."""
    Gc, M, L, u, plan = _check_split_args("lstm_split_bwd", xg, whh, tm, dhs, hs, cs,
                                          plan=lambda M_, D_, u_, g_: bwd_plan(M_, D_, u_, 0, g_))
    dxg = torch.empty_like(xg)
    da = torch.empty((Gc, L, M, 4 * u), dtype=torch.float32, device=xg.device)
    dwhh = torch.empty((Gc, u, 4 * u), dtype=torch.float32, device=xg.device)
    if not (M and L):
        return dxg, dwhh.zero_()
    _split_launch("lstm_split_bwd", xg, whh, tm,
                  (dhs.data_ptr(), xg.data_ptr(), hs.data_ptr(), cs.data_ptr(), whh.data_ptr(),
                   dxg.data_ptr(), da.data_ptr()), hs, (plan.tm, plan.cluster))
    lstm_split_bwd.launches += 1
    _launch("lstm_wgrad", xg.device, da.data_ptr(), None, hs.data_ptr(), None, None, None, None,
            dwhh.data_ptr(), L, M, 0, u, Gc, 0, 0, 0, *_gmt(hs, Gc, tm).stride()[:3], 1,
            1 if tm else -1, int(xg.dtype == torch.bfloat16), int(hs.dtype == torch.float32))
    lstm_wgrad.launches += 1
    return dxg, dwhh


lstm_split_bwd.launches = 0
