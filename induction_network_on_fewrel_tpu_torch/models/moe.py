"""Mixture-of-Experts FFN: one card, and the rank's share of a (dp, ep) mesh.

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
* combine is dispatch weighted by each surviving choice's gate over the
  token's summed surviving gates (+1e-9), the JAX per-round fold to the
  bit;
* the experts are batched products over ``[G, E, C, d]`` blocks in the
  compute dtype with a tanh-approximated GELU;
* the load-balance loss ``E · Σ_e f_e·p_e`` (f_e: the share of real tokens
  whose first choice is e, before capacity; p_e: their mean router
  probability of e) is appended to ``aux_sink`` when one is set
  (``collect_aux``), which the train step does and eval never does; the
  share of assignments dropped at capacity is kept beside it
  (``drop_share``, detached).

On a mesh (``dist``, a ``parallel/expert.ExpertMesh`` that
``parallel/expert.attach_experts`` sets) a rank computes its share of the
JAX layer over the GLOBAL batch, as GSPMD partitions it:

* the global tokens are the dp ranks' tokens in the JAX order. The model
  encodes support ⧺ query in one call, so a rank's tokens are ``parts``
  (``token_parts``: its support rows, then its query rows), each one slice
  of the global order: part j of rank r starts at ``dp·Σ_{i<j} c_i +
  r·c_j``. The geometry (S, G, C, pad) comes from the global count;
* a rank lays its tokens out in the global groups they fall in
  (``Layout``: each part padded to whole groups, zeros elsewhere), so the
  products above run over those groups only;
* routing is forward only: one all-gather over the dp group of every
  token's masked router probabilities and mask (E + 1 floats a token)
  gives each rank the global routing, which it computes whole (every rank
  alike) and slices to its tokens. A token's slot depends on every earlier
  token of its global group, across ranks and rounds;
* the load-balance term is global: f_e and the real-token count from the
  gathered routing, p_e the gathered probabilities' sum with the gradient
  of this rank's own share taken ``dp`` times, so the dp average of the
  ranks' gradients is the global term's gradient;
* at ep > 1 each rank holds ``E/ep`` experts (its slice of the JAX ``[E,
  ...]`` leaves), dispatches and combines over them only, sums the
  combine over the ep group (forward all-reduce) and all-reduces the
  gradients of the expert path's inputs (the tokens and the gates) over
  it in backward: the Megatron f/g pair. The router and every other leaf
  then get the same gradient on every ep rank.

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

EXPERT_LEAVES = ("experts_up", "experts_up_bias", "experts_down", "experts_down_bias")


def moe_geometry(T: int, num_experts: int, top_k: int, capacity_factor: float,
                 group_size: int) -> tuple[int, int, int, int]:
    """(k, S, G, C) for T tokens: the rounds, the group size, the groups
    and the per-group expert capacity."""
    k = min(top_k, num_experts)
    S = min(group_size, T)
    G = math.ceil(T / S)
    C = min(max(1, math.ceil(k * S / num_experts * capacity_factor)), S)
    return k, S, G, C


def _pad0(t: torch.Tensor, front: int, back: int) -> torch.Tensor:
    """``t`` with ``front`` and ``back`` zero rows on its first axis."""
    return F.pad(t, (0, 0) * (t.dim() - 1) + (front, back)) if front or back else t


class Layout:
    """Where a rank's T local tokens sit among the G·S slots of the global
    routing groups. ``parts``: the local token count of each part (summing
    to T), each part one slice of the global order; part j of rank
    ``rank`` of ``world`` starts at ``world·Σ_{i<j} c_i + rank·c_j``. One
    rank (or no mesh) is one part at 0: the global layout itself.

    ``spans``: per part (first local token, count, first global group,
    groups, leading pad); the local layout is the parts' groups in turn."""

    def __init__(self, parts: tuple, world: int, rank: int, S: int, G: int):
        if world == 1:
            parts, rank = (sum(parts),), 0
        self.S, self.G, self.world = S, G, world
        self.spans = []
        a = 0
        for c in parts:
            if c:
                off = world * a + rank * c
                g0, g1 = off // S, (off + c - 1) // S
                self.spans.append((a, c, g0, g1 - g0 + 1, off - g0 * S))
            a += c

    def spread(self, t: torch.Tensor) -> torch.Tensor:
        """Local tokens [T, ...] -> the local layout [groups·S, ...] (zeros
        where no local token sits)."""
        S = self.S
        return torch.cat([_pad0(t[a:a + c], front, n * S - front - c)
                          for a, c, _, n, front in self.spans])

    def collect(self, t: torch.Tensor) -> torch.Tensor:
        """The local layout [groups·S, ...] -> local tokens [T, ...]."""
        out, base = [], 0
        for _, c, _, n, front in self.spans:
            out.append(t[base + front:base + front + c])
            base += n * self.S
        return out[0] if len(out) == 1 else torch.cat(out)

    def globalize(self, gathered: torch.Tensor) -> torch.Tensor:
        """Every rank's local tokens [world, T, ...] (rank order) -> the
        global order [G·S, ...], padded."""
        W = self.world
        rows = [gathered[:, a:a + c].reshape(W * c, *gathered.shape[2:])
                for a, c, *_ in self.spans]
        flat = rows[0] if len(rows) == 1 else torch.cat(rows)
        return _pad0(flat, 0, self.G * self.S - flat.shape[0])

    def pick(self, t: torch.Tensor) -> torch.Tensor:
        """A global tensor [G·S, ...] -> the local layout's groups of it."""
        S = self.S
        if len(self.spans) == 1 and self.spans[0][2] == 0 and self.spans[0][3] == self.G:
            return t
        return torch.cat([t[g0 * S:(g0 + n) * S] for _, _, g0, n, _ in self.spans])


@torch.no_grad()
def route(probs: torch.Tensor, mk: torch.Tensor, k: int, C: int):
    """The capacity routing of masked probabilities [G, S, E] (mask [G,
    S]): per round the surviving one-hot [G, S, E] and each token's slot
    [G, S]; the first round's one-hot before capacity; the slots used per
    (group, expert)."""
    G, _, E = probs.shape
    experts = torch.arange(E, device=probs.device)
    remaining = probs
    slot_count = torch.zeros(G, E, device=probs.device)
    rounds, first_oh = [], None
    for _ in range(k):
        choice = torch.argmax(remaining, dim=-1)                     # first maximum
        oh = (choice[..., None] == experts).float() * mk[..., None]
        first_oh = oh if first_oh is None else first_oh
        # Slot of each token in its expert's buffer: the running count
        # over the group's tokens plus the slots of earlier rounds.
        pos = torch.cumsum(oh, dim=1) - oh + slot_count[:, None, :]
        pos_tok = torch.sum(pos * oh, dim=-1)                        # [G, S]
        ohf = oh * (pos_tok < C).float()[..., None]
        rounds.append((ohf, pos_tok))
        slot_count = slot_count + torch.sum(ohf, dim=1)
        remaining = remaining * (1.0 - oh)
    return rounds, first_oh, slot_count


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
        # The mesh (parallel/expert.attach_experts) and this call's parts.
        self.dist = None
        self.parts: tuple | None = None

    @property
    def expert_range(self) -> tuple[int, int]:
        """[lo, hi): the experts this module holds (all of them off a mesh)."""
        if self.dist is None or self.dist.ep == 1:
            return 0, self.num_experts
        n = self.num_experts // self.dist.ep
        return self.dist.ep_rank * n, (self.dist.ep_rank + 1) * n

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # A checkpoint holds every expert (the JAX layout): keep this rank's.
        lo, hi = self.expert_range
        if hi - lo < self.num_experts:
            for name in EXPERT_LEAVES:
                t = state_dict.get(prefix + name)
                if t is not None and t.shape[0] == self.num_experts:
                    state_dict[prefix + name] = t[lo:hi]
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        M, L, d = x.shape
        E, cd, dist = self.num_experts, self.compute_dtype, self.dist
        T = M * L
        world = dist.dp if dist is not None else 1
        k, S, G, C = moe_geometry(world * T, E, self.top_k, self.capacity_factor,
                                  self.group_size)
        parts = tuple(r * L for r in self.parts) if self.parts and sum(self.parts) == M else (T,)
        lay = Layout(parts, world, dist.rank if dist is not None else 0, S, G)

        mk = (torch.ones(T, dtype=torch.float32, device=x.device) if mask is None
              else (mask.reshape(T) > 0).float())
        xt = lay.spread(x.reshape(T, d)).reshape(-1, S, d)       # pad slots are masked out
        mk = lay.spread(mk).reshape(-1, S)

        logits = self.router(xt.float())                             # [Gl, S, E] f32
        probs = torch.softmax(logits, dim=-1) * mk[..., None]

        # The global routing, forward only: every rank's probabilities and
        # mask in the global order.
        local = torch.cat([lay.collect(probs.detach().reshape(-1, E)),
                           lay.collect(mk.reshape(-1, 1))], dim=-1)  # [T, E + 1]
        gathered = dist.route_gather(local) if dist is not None else local[None]
        glob = lay.globalize(gathered).reshape(G, S, E + 1)
        g_probs, g_mk = glob[..., :E], glob[..., E]
        rounds, first_oh, slot_count = route(g_probs, g_mk, k, C)

        lo, hi = self.expert_range
        slots = torch.arange(C, device=x.device, dtype=torch.float32)
        dispatch = torch.zeros(xt.shape[0], S, hi - lo, C, device=x.device)
        gate_sum = torch.zeros(xt.shape[0], S, device=x.device)
        chosen = torch.zeros_like(probs)
        for ohf, pos_tok in rounds:
            ohf = lay.pick(ohf.reshape(G * S, E)).reshape(-1, S, E) * mk[..., None]
            pos_tok = lay.pick(pos_tok.reshape(G * S)).reshape(-1, S)
            # One-hot of the slot; a slot at or past C (a dropped token) is
            # all zeros, as jax.nn.one_hot makes it.
            slot = (pos_tok.to(torch.int32).float()[..., None] == slots).float()   # [Gl, S, C]
            dispatch = dispatch + ohf[..., lo:hi, None] * slot[:, :, None, :]
            gate_sum = gate_sum + torch.sum(probs * ohf, dim=-1)
            chosen = chosen + ohf

        if self.aux_sink is not None:
            nreal = torch.sum(g_mk) + 1e-9
            f_e = torch.sum(first_oh, dim=(0, 1)) / nreal
            # The global probability mass; this rank's share carries the
            # gradient, ``world`` times (the ranks' gradients are averaged).
            mine = torch.sum(probs, dim=(0, 1))
            p_e = (torch.sum(g_probs, dim=(0, 1)) + world * (mine - mine.detach())) / nreal
            self.aux_sink.append(E * torch.sum(f_e * p_e))
            # The share of real (token, choice) assignments past capacity.
            self.drop_share = (1.0 - torch.sum(slot_count) / (k * nreal)).detach()

        # Each token's surviving gates over their sum: combine = dispatch x this.
        gates = probs * chosen / (gate_sum[..., None] + 1e-9)       # [Gl, S, E]
        x_in = xt
        if dist is not None and dist.ep > 1:
            x_in, gates = dist.copy_in(xt, "ep/input_grad_allreduce"), \
                dist.copy_in(gates, "ep/gate_grad_allreduce")
        combine = dispatch * gates[..., lo:hi, None]

        expert_in = torch.einsum("gsec,gsd->gecd", dispatch.to(cd), x_in.to(cd))
        h = F.gelu(torch.einsum("gecd,edf->gecf", expert_in, self.experts_up.to(cd))
                   + self.experts_up_bias[None, :, None, :].to(cd), approximate="tanh")
        out_e = (torch.einsum("gecf,efd->gecd", h, self.experts_down.to(cd))
                 + self.experts_down_bias[None, :, None, :].to(cd))
        out = torch.einsum("gsec,gecd->gsd", combine.to(cd), out_e)
        if dist is not None and dist.ep > 1:
            out = dist.sum_out(out)
        return lay.collect(out.reshape(-1, d)).reshape(M, L, d)


def moe_layers(model: nn.Module) -> list:
    return [m for m in model.modules() if isinstance(m, MoeFfn)]


@contextlib.contextmanager
def collect_aux(model: nn.Module):
    """Within the block, every ``MoeFfn`` of ``model`` appends its
    load-balance loss to the yielded list (the JAX "losses" collection,
    mutable only in the train step)."""
    layers = moe_layers(model)
    sink: list = []
    for m in layers:
        m.aux_sink = sink
    try:
        yield sink
    finally:
        for m in layers:
            m.aux_sink = None


@contextlib.contextmanager
def token_parts(layers: list, rows: tuple):
    """Within the block, the MoE ``layers`` read their input as the
    concatenation of ``rows`` sentence rows per part (support, then query),
    each part one slice of the global order under data parallel."""
    for m in layers:
        m.parts = rows
    try:
        yield
    finally:
        for m in layers:
            m.parts = None
