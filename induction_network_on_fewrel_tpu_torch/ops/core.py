"""Small numerical ops shared across modules, and the backend rule.

``squash`` is the capsule-network nonlinearity of the induction module's
dynamic routing (``squash(x) = ||x||^2/(1+||x||^2) * x/||x||``). The masked
reductions keep padded token positions out of pooling/attention while
keeping fixed shapes. Copies of ``induction_network_on_fewrel_tpu/ops/core.py``
with the same constants: eps 1e-12 inside the sqrt, -1e30 for masked
scores, +1e-13 in the softmax normalizer. squash promotes its norm to f32
because ``||x||^2`` underflows fast in bf16.

``gradient_reversal`` is the DANN op of the adversarial step: identity
forward, ``-scale * g`` backward in the cotangent's own dtype.

``resolve_backend`` is the one rule every kernel entry and
``models/build.resolve_runtime_backends`` share: "auto" is the CUDA kernel
for CUDA tensors and the plain PyTorch version for CPU tensors.
``needs_grad`` is the other half of an encoder op's route: with a gradient
needed it goes through its autograd Function, otherwise through the
residual-free forward.
"""

from __future__ import annotations

import functools

import torch

_NEG_INF = -1e30
BACKENDS = ("auto", "reference", "cuda")
# The dtypes the encoder kernels take for activations and residuals.
ACTIVATION_DTYPES = (torch.float32, torch.bfloat16)


def needs_grad(*tensors) -> bool:
    """Whether autograd would record an op on ``tensors`` right now."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def resolve_backend(backend: str, device: torch.device | str) -> str:
    """``auto | reference | cuda`` -> ``reference | cuda`` for ``device``.
    "cuda" on a non-CUDA device raises: no kernel exists there, and a
    silent fall back to the plain version would hide that."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r} (one of {BACKENDS})")
    dev = torch.device(device)
    if backend == "auto":
        return "cuda" if dev.type == "cuda" else "reference"
    if backend == "cuda" and dev.type != "cuda":
        raise RuntimeError(
            f"backend 'cuda' needs CUDA tensors, got tensors on {dev}"
        )
    return backend


def squash(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Capsule squash along ``dim``: scales norm into [0, 1), keeps direction."""
    x32 = x.float()
    sq = torch.sum(x32 * x32, dim=dim, keepdim=True)
    scale = sq / (1.0 + sq) / torch.sqrt(sq + eps)
    return (x32 * scale).to(x.dtype)


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax over ``dim`` treating mask==0 positions as -inf."""
    valid = mask > 0
    scores = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    scores = scores - scores.amax(dim=dim, keepdim=True)
    e = torch.exp(scores) * valid
    return e / (e.sum(dim=dim, keepdim=True) + 1e-13)


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Max over ``dim`` ignoring mask==0 positions (mask broadcasts to x)."""
    return torch.where(mask > 0, x, torch.full_like(x, _NEG_INF)).amax(dim=dim)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    valid = mask > 0
    return (x * valid).sum(dim=dim) / (valid.sum(dim=dim) + 1e-13)


@functools.lru_cache(maxsize=None)
def _rounded(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as a Python float (computed once per pair
    on the host, so a captured step reads it from the cache)."""
    return torch.tensor(x, dtype=dtype).item()


class _GradientReversal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        # JAX's ``-scale * g`` multiplies in g's dtype (x's): the scale is
        # rounded to that dtype first.
        ctx.neg = _rounded(-scale, x.dtype)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.neg, None


def gradient_reversal(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Identity forward; the gradient times ``-scale`` on the way back
    (the JAX ``ops/core.py:46``, Ganin & Lempitsky 2015). A domain
    discriminator upstream of this op minimizes its loss, while the
    encoder below receives the negated gradient and so maximizes domain
    confusion: one backward trains both."""
    return _GradientReversal.apply(x, float(scale))
