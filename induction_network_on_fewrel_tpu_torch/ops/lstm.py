"""Fused BiLSTM: plain PyTorch versions and the CUDA kernels K1, K7 and K8.

``bilstm_encoder_tm`` is the counterpart of
``induction_network_on_fewrel_tpu/ops/lstm.py:bilstm_encoder_tm`` on its
kernel path (``_bilstm_fused_tm``): the input projection and the
bidirectional recurrence in one pass, with the projected gates never
stored. The public signature and layout are the JAX package's:

    emb_t [L, M, D], wih [2, D, 4u], b [2, 1, 4u], whh [2, u, 4u]
      -> hs [L, M, 2u]   (cols [0:u] forward, [u:2u] reverse, natural time)

Two routes, as in the JAX custom VJP:

* no gradient needed (grad mode off, or no input requires grad): the
  residual-free forward, K1 (``csrc/bilstm_infer.cu``, replaces
  ``_fused_fwd_kernel_infer``) or its plain version ``bilstm_reference``;
* otherwise ``_BiLSTMFused``, a ``torch.autograd.Function`` whose forward
  is K7 (``bilstm_win_fwd``, replaces ``_fused_win_fwd_kernel``): hs plus
  one (h, c) checkpoint pair per W-step natural-time block, in the
  residual dtype; and whose backward is K8 (``bilstm_win_bwd``, replaces
  ``_fused_win_bwd_kernel``): each window replayed in f32 from its seed,
  then the gradient sweep. W = min(cs_window, L) as in the JAX call.

Dtype placement follows the kernel path exactly (lstm.py:1303-1307): wih
is cast to the embedding dtype, b and whh to f32; gate pre-activations
accumulate in f32; the h and c carries and the window replay are f32; hs
and demb are written in the embedding dtype; the checkpoints in the
residual dtype (None = the embedding dtype); dW_ih is rounded to wih's
dtype (lstm.py:1216), so in bf16 the Function returns a bf16 dW_ih that
autograd's cast carries back to the f32 parameter. In bf16 this differs
from the JAX ``scan`` backend, so the plain versions here are held against
JAX ``backend="interpret"`` (tests/test_torch_ops.py,
tests/test_torch_train_ops.py). Gate order is [i, f, g, o].

Each plain version follows its kernel's algorithm step by step (the
window replay, the seeds, the kernel-reverse walk, the rounding points),
so the CPU tests check the port's own backward, not torch autograd.

Backends (``ops.core.resolve_backend``): "reference" is the plain version,
"cuda" the kernels (CUDA tensors only), "auto" picks by the tensor's
device. A kernel wrapper launches on CUDA tensors or raises; it never
falls back. The kernels mask their ragged last row tile themselves, so no
padded copy is made (the JAX call pads rows to its tile, lstm.py:1297-1302).
"""

from __future__ import annotations

import torch

from induction_network_on_fewrel_tpu_torch.kernels.build import LIBRARY, check_cuda_tensors
from induction_network_on_fewrel_tpu_torch.ops.core import (
    ACTIVATION_DTYPES,
    needs_grad,
    resolve_backend,
)

# A block's dynamic shared memory on an H100 (232,448 bytes).
SMEM_LIMIT = 232448


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
    window. W = 0 is the JAX package's full-residual twin (kernels 4 and 6),
    which is not ported: with a gradient needed it raises.
    ``residual_dtype``: storage dtype of the checkpoints (None = emb's)."""
    wih = wih.to(emb_t.dtype)
    b = b.float()
    whh = whh.float()
    kernel = resolve_backend(backend, emb_t.device) == "cuda"
    if not needs_grad(emb_t, wih, b, whh):
        if kernel:
            return bilstm_infer_cuda(emb_t.contiguous(), wih.contiguous(), b.contiguous(),
                                     whh.contiguous())
        return bilstm_reference(emb_t, wih, b, whh)
    if cs_window <= 0:
        raise NotImplementedError(
            f"lstm_cs_window={cs_window}: the full-residual BiLSTM backward "
            "(kernels 4 and 6) is not ported; use a window W > 0"
        )
    W = min(int(cs_window), emb_t.shape[0])
    res_dt = emb_t.dtype if residual_dtype is None else residual_dtype
    return _BiLSTMFused.apply(emb_t, wih, b, whh, kernel, W, res_dt)


class _BiLSTMFused(torch.autograd.Function):
    """The windowed custom VJP of ``_bilstm_fused_tm``: K7 forward, K8
    backward (or their plain versions, for ``kernel=False``)."""

    @staticmethod
    def forward(ctx, emb_t, wih, b, whh, kernel: bool, W: int, res_dt):
        args = (emb_t.contiguous(), wih.contiguous(), b.contiguous(), whh.contiguous())
        fwd = bilstm_win_fwd if kernel else bilstm_win_fwd_reference
        hs, ch, cc = fwd(*args, W, res_dt)
        ctx.save_for_backward(args[0], ch, cc, *args[1:])
        ctx.kernel, ctx.W = kernel, W
        return hs

    @staticmethod
    def backward(ctx, dhs):
        emb_t, ch, cc, wih, b, whh = ctx.saved_tensors
        bwd = bilstm_win_bwd if ctx.kernel else bilstm_win_bwd_reference
        demb, dwih, db, dwhh = bwd(dhs.to(emb_t.dtype).contiguous(), emb_t, ch, cc,
                                   wih, b, whh, ctx.W)
        # Per-direction demb summed in the emb dtype, dW_ih rounded to
        # wih's dtype, as the JAX rule does (lstm.py:1212, 1216).
        return (demb[0] + demb[1], dwih.to(wih.dtype), db.reshape(b.shape), dwhh,
                None, None, None)


# --- plain versions -----------------------------------------------------------


def _cell(a: torch.Tensor, c_prev: torch.Tensor, u: int):
    i = torch.sigmoid(a[:, :u])
    f = torch.sigmoid(a[:, u:2 * u])
    g = torch.tanh(a[:, 2 * u:3 * u])
    o = torch.sigmoid(a[:, 3 * u:])
    c = f * c_prev + i * g
    return i, f, g, o, c


def _fused_forward(emb_t, wih, b, whh, W: int | None, res_dt):
    """The kernels' forward: bf16 products are exact in f32, so upcasting
    the operands and multiplying in f32 is the f32 accumulation the kernel
    does. With ``W``, also the checkpoint pair of each natural block."""
    L, M, _ = emb_t.shape
    u = whh.shape[1]
    x = emb_t.float()
    wih32, b32, whh32 = wih.to(emb_t.dtype).float(), b.float(), whh.float()
    hs = torch.empty((L, M, 2 * u), dtype=emb_t.dtype, device=emb_t.device)
    nB = -(-L // W) if W else 0
    ch = torch.empty((nB, M, 2 * u), dtype=res_dt, device=emb_t.device) if W else None
    cc = torch.empty_like(ch) if W else None
    for d in range(2):
        cols = slice(d * u, (d + 1) * u)
        xg = torch.matmul(x, wih32[d]) + b32[d]            # [L, M, 4u] f32
        h = x.new_zeros((M, u))
        c = x.new_zeros((M, u))
        for t in (range(L) if d == 0 else range(L - 1, -1, -1)):
            _, _, _, o, c = _cell(xg[t] + h @ whh32[d], c, u)
            h = o * torch.tanh(c)
            hs[t, :, cols] = h.to(emb_t.dtype)
            # The block's kernel-last step: this state is its checkpoint.
            if W and (t % W == 0 if d else (t % W == W - 1 or t == L - 1)):
                ch[t // W, :, cols] = h.to(res_dt)
                cc[t // W, :, cols] = c.to(res_dt)
    return hs, ch, cc


def bilstm_reference(emb_t, wih, b, whh) -> torch.Tensor:
    """The plain PyTorch version of K1 (no residuals)."""
    return _fused_forward(emb_t, wih, b, whh, None, None)[0]


def bilstm_win_fwd_reference(emb_t, wih, b, whh, W: int, res_dt):
    """The plain version of K7: (hs, ch, cc) with ch, cc [ceil(L/W), M, 2u]
    holding each natural block's kernel-last (h, c) in ``res_dt``."""
    return _fused_forward(emb_t, wih, b, whh, W, res_dt)


def bilstm_win_bwd_reference(dhs, emb_t, ch, cc, wih, b, whh, W: int):
    """The plain version of K8, step for step: per direction, blocks in
    kernel-reverse order; at each block's entry its forward steps replayed
    in f32 from the seed (the kernel-previous block's checkpoint, zero for
    the direction's kernel-first block); then the gradient steps. Returns
    demb [2, L, M, D] in emb's dtype and f32 dW_ih [2, D, 4u], db [2, 4u],
    dW_hh [2, u, 4u] (the kernel's per-tile partials, summed)."""
    L, M, D = emb_t.shape
    u = whh.shape[1]
    nB = ch.shape[0]
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
        for blk in (range(nB - 1, -1, -1) if d == 0 else range(nB)):
            base = blk * W
            Wb = min(W, L - base)
            if blk == (0 if d == 0 else nB - 1):
                seed_h, seed_c = x.new_zeros((M, u)), x.new_zeros((M, u))
            else:
                s = blk - 1 if d == 0 else blk + 1
                seed_h, seed_c = ch[s, :, cols].float(), cc[s, :, cols].float()
            h_win, c_win = [None] * Wb, [None] * Wb
            h, c = seed_h, seed_c
            for j in range(Wb):
                pos = j if d == 0 else Wb - 1 - j
                _, _, _, o, c = _cell(x[base + pos] @ wih32[d] + b32[d] + h @ whh32[d], c, u)
                h = o * torch.tanh(c)
                h_win[pos], c_win[pos] = h, c
            for o in (range(Wb - 1, -1, -1) if d == 0 else range(Wb)):
                t = base + o
                if o == (0 if d == 0 else Wb - 1):
                    h_prev, c_prev = seed_h, seed_c
                else:
                    op = o - 1 if d == 0 else o + 1
                    h_prev, c_prev = h_win[op], c_win[op]
                tc = torch.tanh(c_win[o])
                ig, fg, gg, og, _ = _cell(x[t] @ wih32[d] + b32[d] + h_prev @ whh32[d],
                                          c_prev, u)
                dh_t = dhs32[t, :, cols] + dh
                dct = dc + dh_t * og * (1.0 - tc * tc)
                da = torch.cat([
                    dct * gg * ig * (1.0 - ig),
                    dct * c_prev * fg * (1.0 - fg),
                    dct * ig * (1.0 - gg * gg),
                    dh_t * tc * og * (1.0 - og),
                ], dim=-1)                                   # [M, 4u]
                demb[d, t] = (da @ wih32[d].T).to(emb_t.dtype)
                dwih[d] += x[t].T @ da
                db[d] += da.sum(0)
                dwhh[d] += h_prev.T @ da
                dh = da @ whh32[d].T
                dc = dct * fg
    return demb, dwih, db, dwhh


# --- kernel wrappers ------------------------------------------------------------


def _check_lstm_args(name, emb_t, wih, b, whh):
    check_cuda_tensors(name, emb_t, wih, b, whh)
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
    if G > 512:
        raise ValueError(f"{name}: 4u = {G} exceeds the kernel's 512 threads")
    return u


def _check_residuals(name, res_dt):
    if res_dt not in ACTIVATION_DTYPES:
        raise TypeError(f"{name}: residual dtype must be one of {ACTIVATION_DTYPES}, got {res_dt}")


def bilstm_infer_cuda(emb_t, wih, b, whh) -> torch.Tensor:
    """Launch K1 on the current stream (no synchronize). Raises for CPU
    tensors, unsupported dtypes, shapes or layouts, launch failures, and
    for an input that requires grad while grad mode is on: K1 keeps no
    residuals, so its output could carry no gradient."""
    if needs_grad(emb_t, wih, b, whh):
        raise RuntimeError(
            "bilstm_infer_cuda: an input requires grad; the training route is "
            "bilstm_encoder_tm (K7/K8), K1 would return a detached output"
        )
    u = _check_lstm_args("bilstm_infer_cuda", emb_t, wih, b, whh)
    L, M, D = emb_t.shape
    hs = torch.empty((L, M, 2 * u), dtype=emb_t.dtype, device=emb_t.device)
    if L == 0 or M == 0:
        return hs
    with torch.cuda.device(emb_t.device):
        LIBRARY.launch(
            "bilstm_infer_fwd",
            emb_t.data_ptr(), wih.data_ptr(), b.data_ptr(), whh.data_ptr(),
            hs.data_ptr(), L, M, D, u, int(emb_t.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    bilstm_infer_cuda.launches += 1
    return hs


bilstm_infer_cuda.launches = 0


def bilstm_win_fwd(emb_t, wih, b, whh, W: int, res_dt):
    """Launch K7: (hs, ch, cc) as ``bilstm_win_fwd_reference``."""
    u = _check_lstm_args("bilstm_win_fwd", emb_t, wih, b, whh)
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
    with torch.cuda.device(emb_t.device):
        LIBRARY.launch(
            "bilstm_win_fwd",
            emb_t.data_ptr(), wih.data_ptr(), b.data_ptr(), whh.data_ptr(),
            hs.data_ptr(), ch.data_ptr(), cc.data_ptr(), L, M, D, u, W,
            int(emb_t.dtype == torch.bfloat16), int(res_dt == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    bilstm_win_fwd.launches += 1
    return hs, ch, cc


bilstm_win_fwd.launches = 0


def win_bwd_tile(W: int, D: int, u: int) -> tuple[int, int]:
    """K8's row tile: the largest TM in {8, 4, 2, 1} whose window
    (2 W TM u f32) and step buffers fit a block's shared memory, and the
    bytes it takes (the formula of ``csrc/bilstm_win_bwd.cu``)."""
    for tm in (8, 4, 2, 1):
        smem = 4 * (2 * W * tm * u + 3 * tm * u + tm * D + tm * 4 * u)
        if smem <= SMEM_LIMIT:
            return tm, smem
    raise ValueError(f"bilstm_win_bwd: a window of W={W} at u={u} does not fit shared memory")


def bilstm_win_bwd(dhs, emb_t, ch, cc, wih, b, whh, W: int):
    """Launch K8, then sum its per-tile partials (outside the kernel, as
    the JAX call does): the same four outputs as ``bilstm_win_bwd_reference``."""
    u = _check_lstm_args("bilstm_win_bwd", emb_t, wih, b, whh)
    check_cuda_tensors("bilstm_win_bwd", emb_t, dhs, ch, cc)
    _check_residuals("bilstm_win_bwd", ch.dtype)
    L, M, D = emb_t.shape
    G = 4 * u
    if dhs.dtype != emb_t.dtype or tuple(dhs.shape) != (L, M, 2 * u):
        raise ValueError(f"bilstm_win_bwd: dhs {dhs.dtype} {tuple(dhs.shape)} != hs")
    if not 1 <= W <= L:
        raise ValueError(f"bilstm_win_bwd: window {W} outside [1, L={L}]")
    if tuple(ch.shape) != (-(-L // W), M, 2 * u) or cc.shape != ch.shape or cc.dtype != ch.dtype:
        raise ValueError(f"bilstm_win_bwd: checkpoints {tuple(ch.shape)} do not match W={W}")
    if G % 32:
        raise ValueError(f"bilstm_win_bwd: 4u = {G} must be a multiple of 32")
    tm, _ = win_bwd_tile(W, D, u)
    nT = -(-M // tm)
    dev = emb_t.device
    demb = torch.empty((2, L, M, D), dtype=emb_t.dtype, device=dev)
    dwih_p = torch.empty((2, nT, D, G), dtype=torch.float32, device=dev)
    db_p = torch.empty((2, nT, G), dtype=torch.float32, device=dev)
    dwhh_p = torch.empty((2, nT, u, G), dtype=torch.float32, device=dev)
    if M == 0:
        return demb, dwih_p.sum(1), db_p.sum(1), dwhh_p.sum(1)
    with torch.cuda.device(dev):
        LIBRARY.launch(
            "bilstm_win_bwd",
            dhs.data_ptr(), emb_t.data_ptr(), ch.data_ptr(), cc.data_ptr(),
            wih.data_ptr(), b.data_ptr(), whh.data_ptr(), demb.data_ptr(),
            dwih_p.data_ptr(), db_p.data_ptr(), dwhh_p.data_ptr(),
            L, M, D, u, W, tm, int(emb_t.dtype == torch.bfloat16),
            int(ch.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
        )
    bilstm_win_bwd.launches += 1
    return demb, dwih_p.sum(1), db_p.sum(1), dwhh_p.sum(1)


bilstm_win_bwd.launches = 0
