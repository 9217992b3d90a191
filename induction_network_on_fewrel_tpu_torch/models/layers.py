"""flax.linen's Dense, Conv and LayerNorm as the JAX models use them.

Each computes in its ``dtype`` with f32 parameters (flax's ``dtype=...,
param_dtype=float32``): inputs and parameters are cast to ``dtype`` before
the product. Fresh parameters follow flax's defaults, drawn from the
model's ``torch.Generator``: kernels truncated lecun-normal with flax's
fan-in (in-features, times the receptive field for a conv), biases zeros,
LayerNorm scale ones.

Layouts are torch's: a Dense ``weight`` is [out, in] (flax's kernel
transposed), a Conv ``weight`` [out, in, *window] (flax's [*window, in,
out] moved channel-first); ``interop.py`` maps one onto the other. A
LayerNorm keeps flax's leaf names, ``scale`` and ``bias``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from induction_network_on_fewrel_tpu_torch.models.embedding import truncated_normal_param


class Dense(nn.Module):
    """``x @ weight.T + bias`` in ``dtype``."""

    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype, *,
                 device, generator: torch.Generator):
        super().__init__()
        self.weight = truncated_normal_param(
            generator, (out_dim, in_dim), 1.0 / math.sqrt(in_dim), device
        )
        self.bias = nn.Parameter(torch.zeros(out_dim, device=device))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv(nn.Module):
    """A 1-D or 2-D convolution on channel-first input ([M, C, *S]) with
    flax's explicit padding: ``padding`` holds one (before, after) pair per
    spatial axis, applied as zeros before an unpadded convolution (torch's
    own padding is symmetric). Like flax, and torch, it does not flip the
    kernel."""

    def __init__(self, in_ch: int, out_ch: int, window: tuple[int, ...], dtype: torch.dtype,
                 padding: tuple[tuple[int, int], ...] | None = None,
                 stride: tuple[int, ...] | None = None, dilation: tuple[int, ...] | None = None,
                 *, device, generator: torch.Generator):
        super().__init__()
        fan_in = in_ch * math.prod(window)
        self.weight = truncated_normal_param(
            generator, (out_ch, in_ch, *window), 1.0 / math.sqrt(fan_in), device
        )
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))
        self.dtype = dtype
        self.conv = {1: F.conv1d, 2: F.conv2d}[len(window)]
        self.pad = [p for pair in reversed(padding or ((0, 0),) * len(window)) for p in pair]
        self.stride = stride or (1,) * len(window)
        self.dilation = dilation or (1,) * len(window)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = F.pad(x.to(dt), self.pad) if any(self.pad) else x.to(dt)
        return self.conv(x, self.weight.to(dt), self.bias.to(dt), stride=self.stride,
                         dilation=self.dilation)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: epsilon 1e-6, statistics in
    f32 whatever the input dtype, the variance as E[x²] - E[x]² clipped at
    0 (flax's fast variance), the result in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype, eps: float = 1e-6, *, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mu * mu, min=0.0)
        y = (x32 - mu) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias
        return y.to(self.dtype)
