"""The MoE layers on a (dp, ep) mesh: global routing and the expert-parallel executor.

Counterpart of the ep rules of
``induction_network_on_fewrel_tpu/parallel/sharding.py:50-61`` and of
what GSPMD makes of ``models/moe.py`` on a (dp, ep) mesh. There the
expert leaves ``experts_up``, ``experts_down`` and their biases shard
``P("ep", ...)``, episodes shard over dp only (``episode_batch_shardings``)
and the partitioner computes each rank's share of the global layer. Here
``attach_experts`` gives every ``MoeFfn`` of a model an ``ExpertMesh``:

* routing over the dp group: ``route_gather`` all-gathers every rank's
  tokens' masked router probabilities and mask (forward only; one
  collective a layer a forward), from which each rank computes the global
  routing (``models/moe.py``);
* at ep > 1, the layer keeps its ``E/ep`` experts (this rank's slice of
  each ``[E, ...]`` leaf; a full leaf loading into it is sliced), the
  combine's sum over experts is an all-reduce over the ep group
  (``sum_out``), and the gradients of the expert path's inputs are
  all-reduced over it in backward (``copy_in``). The spelling follows the
  JAX layout: within a dp slice the ep ranks hold the same tokens, so
  every ep rank routes alike; JAX's comment names an all-to-all (GSPMD's
  choice for the dispatch einsum), which the layout does not need: each
  rank already holds every token of its slice.
* gradients: the router and every non-expert leaf come out the same on
  every ep rank and are averaged over dp; an expert leaf is averaged over
  dp within its ep shard (``Mesh.group`` is exactly that group). The
  clip's global norm adds the expert leaves' squares over the ep group
  (``train/steps.ClipDecayOptimizer``); ZeRO-1 leaves those leaves whole
  (the JAX ``state_shardings``: a leaf that is really sharded is not also
  dp-sharded).
* checkpoints hold the JAX layout: ``full_state_dict`` all-gathers the
  expert leaves over the ep group (every rank calls it), the optimizer's
  ``state_dict`` their moments; a restore slices. So a checkpoint restores
  at any ep.

Each collective is counted in ``parallel/grad_buckets.COLLECTIVES`` where
it is issued: "moe/route_allgather", "ep/combine_allreduce",
"ep/input_grad_allreduce", "ep/gate_grad_allreduce", "ep/norm_allreduce",
"ep/experts_allgather" and "ep/moments_allgather".
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from induction_network_on_fewrel_tpu_torch.models.moe import EXPERT_LEAVES, moe_layers
from induction_network_on_fewrel_tpu_torch.parallel.grad_buckets import (
    COLLECTIVES,
    CopyIn,
    SumOut,
)


def is_expert_leaf(name: str) -> bool:
    """True for a parameter name of an MoE layer's expert leaves."""
    return name.rsplit(".", 1)[-1] in EXPERT_LEAVES


class ExpertMesh:
    """A live mesh as the MoE layers read it: ``dp`` ranks (this one
    ``rank``) over ``group``, ``ep`` ranks (this one ``ep_rank``) over
    ``ep_group``."""

    def __init__(self, mesh):
        self.dp, self.rank, self.group = mesh.dp, mesh.rank, mesh.group
        self.ep, self.ep_rank, self.ep_group = mesh.ep, mesh.ep_rank, mesh.ep_group

    def route_gather(self, local: torch.Tensor) -> torch.Tensor:
        """[T, c] on each dp rank -> [dp, T, c], in rank order."""
        local = local.contiguous()
        out = torch.empty((self.dp * local.shape[0],) + tuple(local.shape[1:]),
                          dtype=local.dtype, device=local.device)
        dist.all_gather_into_tensor(out, local, group=self.group)
        COLLECTIVES["moe/route_allgather"] += 1
        return out.view(self.dp, *local.shape)

    def copy_in(self, t: torch.Tensor, label: str) -> torch.Tensor:
        return CopyIn.apply(t, self.ep_group, label)

    def sum_out(self, t: torch.Tensor) -> torch.Tensor:
        return SumOut.apply(t, self.ep_group, "ep/combine_allreduce")

    def gather_experts(self, t: torch.Tensor, label: str) -> torch.Tensor:
        """This rank's slice [E/ep, ...] -> every rank's, [E, ...]."""
        t = t.detach().contiguous()
        out = torch.empty((self.ep * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t, group=self.ep_group)
        COLLECTIVES[label] += 1
        return out


def attach_experts(model, mesh) -> int:
    """Give every MoE layer of ``model`` the live ``mesh`` (routing over its
    dp ranks) and, at ep > 1, keep only this rank's slice of its expert
    leaves (new parameters: call before the optimizer is made). Returns
    the number of MoE layers; a pure layout mesh attaches nothing."""
    layers = moe_layers(model)
    if not layers or not mesh.live:
        return len(layers)
    em = ExpertMesh(mesh)
    for m in layers:
        if m.dist is not None:
            continue
        if m.num_experts % em.ep:
            raise ValueError(f"--moe_experts ({m.num_experts}) must be divisible by --ep "
                             f"({em.ep})")
        m.dist = em
        lo, hi = m.expert_range
        if hi - lo < m.num_experts:
            for name in EXPERT_LEAVES:
                full = getattr(m, name)
                setattr(m, name, torch.nn.Parameter(full.detach()[lo:hi].clone(),
                                                    requires_grad=full.requires_grad))
    return len(layers)


def expert_mesh(model):
    """The ``ExpertMesh`` the model's MoE layers run on, or None."""
    for m in moe_layers(model):
        return m.dist
    return None


def full_state_dict(model) -> dict:
    """``model.state_dict()`` in the JAX layout: every expert leaf whole,
    gathered over the ep group, every tp-sharded leaf whole, gathered over
    the tp group (``parallel/tensor.py``), and every stack leaf whole,
    gathered over the pp group (``parallel/pipeline.py``): collectives at
    ep, tp or pp > 1 (every rank calls it)."""
    from induction_network_on_fewrel_tpu_torch.parallel.pipeline import pp_leaves
    from induction_network_on_fewrel_tpu_torch.parallel.tensor import tp_leaves

    state = model.state_dict()
    em = expert_mesh(model)
    if em is not None and em.ep > 1:
        state = {k: em.gather_experts(v, "ep/experts_allgather") if is_expert_leaf(k) else v
                 for k, v in state.items()}
    for name, axis, tpm in tp_leaves(model):
        state[name] = tpm.gather(state[name], axis, "tp/params_allgather")
    for name, axis, stage in pp_leaves(model):
        state[name] = stage.gather(state[name], axis, "pp/params_allgather")
    return state


class FullModel:
    """A model standing in for itself in a checkpoint save, its state the
    gathered ``full_state_dict`` (taken when made: every rank makes it)."""

    def __init__(self, model):
        self.model = model
        self.state = full_state_dict(model)

    def state_dict(self) -> dict:
        return self.state

    def __getattr__(self, name):
        return getattr(self.model, name)
