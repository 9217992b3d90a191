"""Sentence encoders: CNN, and BiLSTM + structured self-attention.

Counterparts of ``induction_network_on_fewrel_tpu/models/encoders.py``.

``CNNEncoder`` (the thunlp default): a convolution of ``hidden_size``
filters over a window of 3 tokens with flax's SAME padding (one zero row
each side), ReLU, and a max over the valid tokens (``ops.core.masked_max``,
whose gradient splits ties evenly, as ``jnp.max``'s does). It takes
batch-major embeddings [M, L, D] and computes in the compute dtype with f32
parameters; the flax kernel ``Conv_0/kernel [3, D, H]`` is the torch
weight ``Conv_0.weight [H, D, 3]``.

``BiLSTMSelfAttnEncoder`` has the JAX encoder's parameters and layouts:
``w_ih [2, D, 4u]``, ``w_hh [2, u, 4u]``, ``bias [2, 4u]`` (leading axis =
direction, 0 forward / 1 reverse, independent weights), ``att_w1 [2u, A]``
and ``att_w2 [A, 1]``. The body runs time-major: embeddings [L, M, D] go
through the fused BiLSTM (``ops.lstm.bilstm_encoder_tm``) to hidden states
[L, M, 2u], then the structured self-attention
(``ops.attn.masked_selfattn_tm``) gives the sentence vectors [M, 2u] in
the compute dtype. Both ops take ``auto | reference | cuda`` backends,
resolved by ``models/build.resolve_runtime_backends``, which also resolves
the training route's ``lstm_cs_window`` and residual dtype. With a
gradient needed the ops go through their autograd Functions (K7/K8, or
K4/K6 at ``lstm_cs_window=0``, and K10/K11 on the card); without, through
the forward-only kernels K1/K2.

The attention always follows the kernel math (f32 inside, output in H's
dtype); the JAX package's "xla" attention branch instead computes in the
compute dtype, so the bf16 comparison runs against its kernel backends.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from induction_network_on_fewrel_tpu_torch.models.embedding import truncated_normal_param
from induction_network_on_fewrel_tpu_torch.models.layers import Conv
from induction_network_on_fewrel_tpu_torch.ops.attn import masked_selfattn_tm
from induction_network_on_fewrel_tpu_torch.ops.core import masked_max
from induction_network_on_fewrel_tpu_torch.ops.lstm import bilstm_encoder_tm


def _orthogonal_rows(gen: torch.Generator, rows: int, cols: int) -> torch.Tensor:
    """[rows, cols] with orthonormal rows (rows <= cols), sign-fixed QR."""
    q, r = torch.linalg.qr(torch.randn((cols, rows), generator=gen))
    return (q * torch.sign(torch.diagonal(r))).T.contiguous()


class CNNEncoder(nn.Module):
    def __init__(self, input_dim: int, hidden_size: int = 230, window: int = 3,
                 compute_dtype: torch.dtype = torch.float32, *, device,
                 generator: torch.Generator):
        super().__init__()
        self.hidden_size = hidden_size
        self.compute_dtype = compute_dtype
        same = ((window - 1) // 2, window // 2)
        self.Conv_0 = Conv(input_dim, hidden_size, (window,), compute_dtype, padding=(same,),
                           device=device, generator=generator)

    def forward(self, emb: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """emb [M, L, D], mask [M, L] -> [M, hidden_size]."""
        x = torch.relu(self.Conv_0(emb.transpose(1, 2)))         # [M, H, L]
        return masked_max(x, mask[:, None, :], dim=-1).to(self.compute_dtype)

    @property
    def output_dim(self) -> int:
        return self.hidden_size


class BiLSTMSelfAttnEncoder(nn.Module):
    # FewShotModel.encode gathers the embeddings straight into [L, M, D].
    wants_time_major = True

    def __init__(
        self,
        input_dim: int,
        lstm_hidden: int = 128,
        att_dim: int = 64,
        lstm_backend: str = "auto",
        attn_backend: str = "auto",
        compute_dtype: torch.dtype = torch.float32,
        lstm_cs_window: int = 8,
        lstm_residual_dtype: torch.dtype | None = None,
        *,
        device,
        generator: torch.Generator,
    ):
        super().__init__()
        D, u = input_dim, lstm_hidden
        self.lstm_hidden = u
        self.lstm_backend = lstm_backend
        self.attn_backend = attn_backend
        self.compute_dtype = compute_dtype
        self.lstm_cs_window = lstm_cs_window
        self.lstm_residual_dtype = lstm_residual_dtype
        # The JAX encoder's initializers: flax's truncated lecun-normal for
        # the input and attention projections (fan-in D per direction, 2u
        # and A), orthogonal recurrent weights per direction, forget-gate
        # bias 1.
        self.w_ih = truncated_normal_param(generator, (2, D, 4 * u), 1.0 / math.sqrt(D), device)
        self.w_hh = nn.Parameter(torch.stack(
            [_orthogonal_rows(generator, u, 4 * u) for _ in range(2)]
        ).to(device))
        bias = torch.zeros((2, 4 * u))
        bias[:, u:2 * u] = 1.0
        self.bias = nn.Parameter(bias.to(device))
        self.att_w1 = truncated_normal_param(
            generator, (2 * u, att_dim), 1.0 / math.sqrt(2 * u), device
        )
        self.att_w2 = truncated_normal_param(
            generator, (att_dim, 1), 1.0 / math.sqrt(att_dim), device
        )

    def forward(self, emb_t: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """emb_t [L, M, D] time-major embeddings, mask [M, L] -> [M, 2u]."""
        emb_t = emb_t.to(self.compute_dtype)
        H = bilstm_encoder_tm(
            emb_t, self.w_ih, self.bias[:, None, :], self.w_hh,
            backend=self.lstm_backend, cs_window=self.lstm_cs_window,
            residual_dtype=self.lstm_residual_dtype,
        )                                                     # [L, M, 2u]
        H = H.to(self.compute_dtype)
        return masked_selfattn_tm(
            H, mask, self.att_w1, self.att_w2, backend=self.attn_backend
        )

    @property
    def output_dim(self) -> int:
        return 2 * self.lstm_hidden
