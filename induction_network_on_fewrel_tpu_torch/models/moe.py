"""Mixture-of-Experts FFN, the single-card path (the JAX package's ep=1).

Counterpart of ``induction_network_on_fewrel_tpu/models/moe.py``
(``MoeFfn``) in the same einsum form, step for step:

* tokens are routed in fixed groups of ``S = min(group_size, T)`` (the
  last group padded with masked slots), so the dispatch and combine
  one-hots are ``[G, S, E, C]`` with ``C = min(max(1, ceil(k·S/E ·
  capacity_factor)), S)``;
* the router is an f32 Dense over the f32 tokens; its softmax is zeroed on
  pads, so a pad takes no expert slot and counts in no statistic;
* top-k is iterative: each round takes the first maximum (``argmax``) of
  the experts not yet chosen, places the token at the running count of
  its expert within the group (a cumsum over the group's tokens plus the
  slots of earlier rounds) and drops it when that reaches C;
* the gate is folded into combine per round, and combine is renormalized
  by each token's summed surviving gates (+1e-9);
* the experts are batched products over ``[G, E, C, d]`` blocks in the
  compute dtype with a tanh-approximated GELU;
* the load-balance loss ``E · Σ_e f_e·p_e`` (f_e: the share of real tokens
  whose first choice is e, before capacity; p_e: their mean router
  probability of e) is appended to ``aux_sink`` when one is set
  (``collect_aux``), which the train step does and eval never does; the
  share of assignments dropped at capacity is kept beside it
  (``drop_share``, detached).

Fresh weights follow flax: the router a truncated lecun-normal Dense; the
experts' ``[E, d, f]`` and ``[E, f, d]`` kernels flax's ``lecun_normal``,
whose fan-in counts the expert axis as receptive field (E·d and E·f), with
zero biases. Leaf names are the JAX ones (``router``, ``experts_up``,
``experts_up_bias``, ``experts_down``, ``experts_down_bias``), the expert
kernels in the JAX layout. The products stay ``torch.einsum``: XLA
computes them outside any Pallas body.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from induction_network_on_fewrel_tpu_torch.models.embedding import truncated_normal_param
from induction_network_on_fewrel_tpu_torch.models.layers import Dense


def moe_geometry(T: int, num_experts: int, top_k: int, capacity_factor: float,
                 group_size: int) -> tuple[int, int, int, int]:
    """(k, S, G, C) for T tokens: the rounds, the group size, the groups
    and the per-group expert capacity."""
    k = min(top_k, num_experts)
    S = min(group_size, T)
    G = math.ceil(T / S)
    C = min(max(1, math.ceil(k * S / num_experts * capacity_factor)), S)
    return k, S, G, C


class MoeFfn(nn.Module):
    """Top-k routed expert FFN: [M, L, d] (+ [M, L] mask) -> [M, L, d]."""

    def __init__(self, d_model: int, num_experts: int, d_ff: int, top_k: int = 2,
                 capacity_factor: float = 2.0, group_size: int = 512,
                 compute_dtype: torch.dtype = torch.float32, *, device,
                 generator: torch.Generator):
        super().__init__()
        E, d, f = num_experts, d_model, d_ff
        self.num_experts, self.top_k = E, top_k
        self.capacity_factor, self.group_size = capacity_factor, group_size
        self.compute_dtype = compute_dtype
        self.router = Dense(d, E, torch.float32, device=device, generator=generator)
        self.experts_up = truncated_normal_param(generator, (E, d, f), 1.0 / math.sqrt(E * d),
                                                 device)
        self.experts_up_bias = nn.Parameter(torch.zeros(E, f, device=device))
        self.experts_down = truncated_normal_param(generator, (E, f, d), 1.0 / math.sqrt(E * f),
                                                   device)
        self.experts_down_bias = nn.Parameter(torch.zeros(E, d, device=device))
        self.aux_sink: list | None = None
        self.drop_share: torch.Tensor | None = None

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        M, L, d = x.shape
        E, cd = self.num_experts, self.compute_dtype
        T = M * L
        k, S, G, C = moe_geometry(T, E, self.top_k, self.capacity_factor, self.group_size)
        pad = G * S - T

        xt = x.reshape(T, d)
        mk = (torch.ones(T, dtype=torch.float32, device=x.device) if mask is None
              else (mask.reshape(T) > 0).float())
        if pad:
            xt = F.pad(xt, (0, 0, 0, pad))
            mk = F.pad(mk, (0, pad))             # pad slots are masked out
        xt = xt.reshape(G, S, d)
        mk = mk.reshape(G, S)

        logits = self.router(xt.float())                             # [G, S, E] f32
        probs = torch.softmax(logits, dim=-1) * mk[..., None]

        experts = torch.arange(E, device=x.device)
        slots = torch.arange(C, device=x.device, dtype=torch.float32)
        remaining = probs
        slot_count = torch.zeros(G, E, device=x.device)
        dispatch = torch.zeros(G, S, E, C, device=x.device)
        combine = torch.zeros(G, S, E, C, device=x.device)
        gate_sum = torch.zeros(G, S, device=x.device)
        first_oh = None
        for _ in range(k):
            choice = torch.argmax(remaining, dim=-1)                 # first maximum
            oh = (choice[..., None] == experts).float() * mk[..., None]
            first_oh = oh if first_oh is None else first_oh
            # Slot of each token in its expert's buffer: the running count
            # over the group's tokens plus the slots of earlier rounds.
            pos = torch.cumsum(oh, dim=1) - oh + slot_count[:, None, :]
            pos_tok = torch.sum(pos * oh, dim=-1)                    # [G, S]
            ohf = oh * (pos_tok < C).float()[..., None]
            # One-hot of the slot; a slot at or past C (a dropped token) is
            # all zeros, as jax.nn.one_hot makes it.
            slot = (pos_tok.to(torch.int32).float()[..., None] == slots).float()   # [G, S, C]
            piece = ohf[..., None] * slot[:, :, None, :]             # [G, S, E, C]
            dispatch = dispatch + piece
            gp = torch.sum(probs * ohf, dim=-1)                      # [G, S]
            combine = combine + gp[..., None, None] * piece
            gate_sum = gate_sum + gp
            slot_count = slot_count + torch.sum(ohf, dim=1)
            remaining = remaining * (1.0 - oh)

        if self.aux_sink is not None:
            nreal = torch.sum(mk) + 1e-9
            f_e = torch.sum(first_oh, dim=(0, 1)) / nreal
            p_e = torch.sum(probs, dim=(0, 1)) / nreal
            self.aux_sink.append(E * torch.sum(f_e * p_e))
            # The share of real (token, choice) assignments past capacity.
            self.drop_share = (1.0 - torch.sum(slot_count) / (k * nreal)).detach()

        combine = combine / (gate_sum[..., None, None] + 1e-9)

        expert_in = torch.einsum("gsec,gsd->gecd", dispatch.to(cd), xt.to(cd))
        h = F.gelu(torch.einsum("gecd,edf->gecf", expert_in, self.experts_up.to(cd))
                   + self.experts_up_bias[None, :, None, :].to(cd), approximate="tanh")
        out_e = (torch.einsum("gecf,efd->gecd", h, self.experts_down.to(cd))
                 + self.experts_down_bias[None, :, None, :].to(cd))
        out = torch.einsum("gsec,gecd->gsd", combine.to(cd), out_e).reshape(G * S, d)
        if pad:
            out = out[:T]
        return out.reshape(M, L, d)


@contextlib.contextmanager
def collect_aux(model: nn.Module):
    """Within the block, every ``MoeFfn`` of ``model`` appends its
    load-balance loss to the yielded list (the JAX "losses" collection,
    mutable only in the train step)."""
    layers = [m for m in model.modules() if isinstance(m, MoeFfn)]
    sink: list = []
    for m in layers:
        m.aux_sink = sink
    try:
        yield sink
    finally:
        for m in layers:
            m.aux_sink = None
