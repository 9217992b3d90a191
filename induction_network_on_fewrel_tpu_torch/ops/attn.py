"""Structured self-attention forward: the plain version and the CUDA kernel K2.

``masked_selfattn_tm`` is the counterpart of
``induction_network_on_fewrel_tpu/ops/attn.py:masked_selfattn_tm`` on its
forward path:

    s_t = w2 . tanh(W1^T h_t),  a = masked_softmax over t,  out = sum_t a_t h_t

    H_t [L, M, D], mask [M, L] (> 0 = valid token), w1 [D, A], w2 [A, 1]
      -> out [M, D] in H's dtype

Both versions compute in f32 whatever H's dtype and cast the output back
to H's dtype (the JAX kernel and its ``_attn_reference`` twin do the same;
the JAX "xla" encoder branch instead computes in the compute dtype, so in
bf16 this module is held against JAX ``attn_backend="interpret"``). The
normalizer adds 1e-13 and a fully-masked row gives exact zeros.

Backends (``ops.core.resolve_backend``): "reference" is the plain
two-pass version, "cuda" the one-pass online-softmax kernel in
``csrc/attn_fwd.cu`` (CUDA tensors only), "auto" picks by the device.
"""

from __future__ import annotations

import torch

from induction_network_on_fewrel_tpu_torch.kernels.build import LIBRARY, check_cuda_tensors
from induction_network_on_fewrel_tpu_torch.ops.core import resolve_backend
from induction_network_on_fewrel_tpu_torch.ops.lstm import ACTIVATION_DTYPES

_NEG = -1e30


def masked_selfattn_tm(
    H_t: torch.Tensor,
    mask: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    backend: str = "auto",
) -> torch.Tensor:
    if resolve_backend(backend, H_t.device) == "cuda":
        return attn_fwd_cuda(
            H_t.contiguous(), mask.float().contiguous(),
            w1.float().contiguous(), w2.float().contiguous(),
        )
    return attn_reference(H_t, mask, w1, w2)


def attn_reference(H_t, mask, w1, w2) -> torch.Tensor:
    """Two-pass plain version (``_attn_reference``, attn.py:91)."""
    H32 = H_t.float()
    s = (torch.tanh(H32 @ w1.float()) @ w2.float())[..., 0]    # [L, M]
    mk = mask.transpose(0, 1) > 0                              # [L, M]
    s = torch.where(mk, s, torch.full_like(s, _NEG))
    e = torch.exp(s - s.amax(dim=0, keepdim=True)) * mk
    a = e / (e.sum(dim=0, keepdim=True) + 1e-13)
    return torch.einsum("lm,lmd->md", a, H32).to(H_t.dtype)


def attn_fwd_cuda(H_t, mask, w1, w2) -> torch.Tensor:
    """Launch K2 on the current stream (no synchronize). Raises for CPU
    tensors, unsupported dtypes, shapes or layouts, and launch failures."""
    L, M, D = H_t.shape
    check_cuda_tensors("attn_fwd_cuda", H_t, mask, w1, w2)
    if H_t.dtype not in ACTIVATION_DTYPES:
        raise TypeError(f"attn_fwd_cuda: H must be one of {ACTIVATION_DTYPES}, got {H_t.dtype}")
    if any(x.dtype != torch.float32 for x in (mask, w1, w2)):
        raise TypeError("attn_fwd_cuda: mask, w1 and w2 must be float32")
    A = w1.shape[-1]
    if tuple(mask.shape) != (M, L) or tuple(w1.shape) != (D, A) or tuple(w2.shape) != (A, 1):
        raise ValueError(
            f"attn_fwd_cuda: mask {tuple(mask.shape)}, w1 {tuple(w1.shape)}, "
            f"w2 {tuple(w2.shape)} do not match H {tuple(H_t.shape)}"
        )
    if D > 1024:
        raise ValueError(f"attn_fwd_cuda: D = {D} exceeds the kernel's 1024 columns")
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
