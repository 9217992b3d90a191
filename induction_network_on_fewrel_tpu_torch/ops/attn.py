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
"""

from __future__ import annotations

import torch

from induction_network_on_fewrel_tpu_torch.kernels.build import LIBRARY, check_cuda_tensors
from induction_network_on_fewrel_tpu_torch.ops.core import (
    ACTIVATION_DTYPES,
    needs_grad,
    resolve_backend,
)

_NEG = -1e30
# K11's rows per block: its dW1/dw2 partials have ceil(M / 4) slabs.
BWD_ROWS_PER_BLOCK = 4


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


# --- kernel wrappers ------------------------------------------------------------


def _check_attn_args(name, H_t, mask, w1, w2):
    L, M, D = H_t.shape
    check_cuda_tensors(name, H_t, mask, w1, w2)
    if H_t.dtype not in ACTIVATION_DTYPES:
        raise TypeError(f"{name}: H must be one of {ACTIVATION_DTYPES}, got {H_t.dtype}")
    if any(x.dtype != torch.float32 for x in (mask, w1, w2)):
        raise TypeError(f"{name}: mask, w1 and w2 must be float32")
    A = w1.shape[-1]
    if tuple(mask.shape) != (M, L) or tuple(w1.shape) != (D, A) or tuple(w2.shape) != (A, 1):
        raise ValueError(
            f"{name}: mask {tuple(mask.shape)}, w1 {tuple(w1.shape)}, "
            f"w2 {tuple(w2.shape)} do not match H {tuple(H_t.shape)}"
        )
    if D > 1024:
        raise ValueError(f"{name}: D = {D} exceeds the kernel's 1024 columns")
    return L, M, D, A


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
    L, M, D, A = _check_attn_args("attn_fwd_cuda", H_t, mask, w1, w2)
    out = torch.empty((M, D), dtype=H_t.dtype, device=H_t.device)
    if M == 0:
        return out
    with torch.cuda.device(H_t.device):
        LIBRARY.launch(
            "attn_fwd",
            H_t.data_ptr(), mask.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            out.data_ptr(), L, M, D, A, int(H_t.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    attn_fwd_cuda.launches += 1
    return out


attn_fwd_cuda.launches = 0


def attn_fwd_stats(H_t, mask, w1, w2):
    """Launch K10: (out, mx, dn) as ``attn_fwd_stats_reference``."""
    L, M, D, A = _check_attn_args("attn_fwd_stats", H_t, mask, w1, w2)
    dev = H_t.device
    out = torch.empty((M, D), dtype=H_t.dtype, device=dev)
    mx = torch.empty((M,), dtype=torch.float32, device=dev)
    dn = torch.empty((M,), dtype=torch.float32, device=dev)
    if M == 0:
        return out, mx, dn
    with torch.cuda.device(dev):
        LIBRARY.launch(
            "attn_fwd_stats",
            H_t.data_ptr(), mask.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            out.data_ptr(), mx.data_ptr(), dn.data_ptr(), L, M, D, A,
            int(H_t.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
        )
    attn_fwd_stats.launches += 1
    return out, mx, dn


attn_fwd_stats.launches = 0


def attn_bwd(H_t, mask, w1, w2, out, mx, dn, dout):
    """Launch K11, then sum its per-block partials (outside the kernel, as
    the JAX call does): the same outputs as ``attn_bwd_reference``."""
    L, M, D, A = _check_attn_args("attn_bwd", H_t, mask, w1, w2)
    check_cuda_tensors("attn_bwd", H_t, out, mx, dn, dout)
    if out.dtype != H_t.dtype or dout.dtype != H_t.dtype or \
            tuple(out.shape) != (M, D) or tuple(dout.shape) != (M, D):
        raise ValueError("attn_bwd: out and dout must be [M, D] in H's dtype")
    if mx.dtype != torch.float32 or dn.dtype != torch.float32 or \
            tuple(mx.shape) != (M,) or tuple(dn.shape) != (M,):
        raise ValueError("attn_bwd: mx and dn must be [M] float32")
    if A > 256:
        raise ValueError(f"attn_bwd: A = {A} exceeds the kernel's 256 threads")
    rb = BWD_ROWS_PER_BLOCK
    nblk = -(-M // rb)
    dev = H_t.device
    dH = torch.empty((L, M, D), dtype=H_t.dtype, device=dev)
    dw1_p = torch.empty((nblk, D, A), dtype=torch.float32, device=dev)
    dw2_p = torch.empty((nblk, A), dtype=torch.float32, device=dev)
    if M > 0:
        with torch.cuda.device(dev):
            LIBRARY.launch(
                "attn_bwd",
                H_t.data_ptr(), mask.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                out.data_ptr(), mx.data_ptr(), dn.data_ptr(), dout.data_ptr(),
                dH.data_ptr(), dw1_p.data_ptr(), dw2_p.data_ptr(), L, M, D, A, rb,
                int(H_t.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
            )
        attn_bwd.launches += 1
    return dH, dw1_p.sum(0), dw2_p.sum(0).reshape(A, 1)


attn_bwd.launches = 0
