"""Tensor parallel over the tp axis: the JAX rule table, Megatron-style.

Counterpart of the tp rules of
``induction_network_on_fewrel_tpu/parallel/sharding.py:50-80``
(``_TP_RULES``, ``_spec_for_path``) and of what GSPMD makes of the
models on a mesh with a tp axis. ``TP_RULES`` is that table in the port's
layouts (a Dense ``weight`` is the JAX kernel transposed), first match by
fragment and leaf rank; a rank-1 leaf (every bias) matches no rank-2 or
rank-3 rule and stays replicated:

* ``tensor_slices`` [h, C, C] -> axis 0: the NTN (``TpRelationNTN``). Each
  tp rank holds ``h/tp`` slices and computes its share of ``v = relu(cM·q)``;
  ``v`` is all-gathered over tp ("tp/ntn_allgather") and the replicated
  ``dense`` [h -> 1] runs whole on every rank. The all-gather, not a
  partial sum of ``dense`` over each rank's rows: the dense leaf then gets
  its whole gradient on every tp rank from the same sum one process makes,
  with no collective for it, and the gather's backward is the rank's slice
  of a cotangent every rank holds whole;
* ``intermediate`` (JAX kernel [d, f], ``P(None, "tp")``) -> the weight's
  rows [f/tp, d]: the column half of an MLP block (``TpColumnDense``); its
  replicated bias is sliced per rank in the forward and its gradient
  assembled over tp ("tp/bias_grad_allreduce", ``DataParallel.finish``);
* ``mlp_out`` (JAX kernel [f, d], ``P("tp", None)``) -> the weight's columns
  [d, f/tp]: the row half (``TpRowDense``); its partial output is summed
  over tp ("tp/mlp_out_allreduce") and its replicated bias added after the
  sum, once;
* the ep rules (``experts_*``; ``parallel/expert.py``) and the pp rules
  (``stack_``: the layer-stacked transformer's leaves, matched before the
  MLP rules and so replicated under tp at pp=1) shard nothing over tp.

The replicated input of each split part (the NTN's class vectors and
queries, an MLP block's input) is the identity forward and all-reduces
its gradient's partials over tp in backward ("tp/input_grad_allreduce"),
so everything below it gets the same gradient on every tp rank, and every
replicated leaf is averaged over dp alone. A tp-sharded leaf is averaged
over dp within its tp shard (``Mesh.group`` is that group). The clip's
global norm adds the tp-sharded leaves' squares over tp
(``train/steps.ClipDecayOptimizer``, "tp/norm_allreduce"); ZeRO-1 leaves
them whole (the JAX ``state_shardings``: a leaf sharded over tp is not also
dp-sharded). Checkpoints hold the JAX layout: ``full_state_dict``
all-gathers the sharded leaves over tp ("tp/params_allgather"), the
optimizer their moments ("tp/moments_allgather"); a full leaf loading into
a sharded module is sliced, so a checkpoint restores at any tp.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from induction_network_on_fewrel_tpu_torch.parallel.grad_buckets import (
    COLLECTIVES,
    CopyIn,
    SumOut,
)

# (fragment, leaf rank, the axis of the port's leaf that shards over tp;
# None: another axis's rule, replicated under tp). First match wins.
TP_RULES: tuple[tuple[str, int, int | None], ...] = (
    ("tensor_slices", 3, 0),
    ("experts_up_bias", 2, None),
    ("experts_down_bias", 2, None),
    ("experts_up", 3, None),
    ("experts_down", 3, None),
    ("stack_", 3, None),
    ("stack_", 2, None),
    ("intermediate", 2, 0),
    ("mlp_out", 2, 1),
)


def tp_axis(name: str, ndim: int) -> int | None:
    """The axis of leaf ``name`` (rank ``ndim``) that shards over tp, or None
    (replicated): the first rule of ``TP_RULES`` whose fragment is in the
    name and whose rank is the leaf's."""
    for frag, rank, axis in TP_RULES:
        if frag in name and rank == ndim:
            return axis
    return None


def check_tp_sizes(cfg, tp: int) -> None:
    """Raise where JAX raises at ``--tp`` (``device_put`` of a leaf whose
    sharded axis does not divide over tp): the NTN's slices, the
    transformer's and BERT's MLP width, by the flag that sets each."""
    if tp <= 1:
        return
    checks = []
    if cfg.model == "induction":
        checks.append(("--ntn_slices", cfg.ntn_slices))
    dense_mlp = cfg.moe_experts == 0 or cfg.moe_every > 1
    if cfg.encoder == "transformer" and not cfg.tfm_stacked and dense_mlp:
        checks.append(("--tfm_ff", cfg.tfm_ff))
    if cfg.encoder == "bert" and not cfg.feature_cache:
        checks.append(("--bert_intermediate", cfg.bert_intermediate))
    for flag, n in checks:
        if n % tp:
            raise ValueError(f"{flag} ({n}) must be divisible by --tp ({tp}): that axis shards "
                             "over tp")


class _GatherLast(torch.autograd.Function):
    """Every tp rank's [..., n] along the last axis, in rank order; backward:
    this rank's slice of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, t, tpm):
        ctx.tpm, ctx.n = tpm, t.shape[-1]
        out = torch.empty((tpm.tp * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t.contiguous(), group=tpm.group)
        COLLECTIVES["tp/ntn_allgather"] += 1
        out = out.view(tpm.tp, *t.shape)
        return torch.movedim(out, 0, -2).reshape(*t.shape[:-1], tpm.tp * t.shape[-1])

    @staticmethod
    def backward(ctx, g):
        lo = ctx.tpm.rank * ctx.n
        return g[..., lo:lo + ctx.n].contiguous(), None


class TensorMesh:
    """A live mesh as the tp modules read it: ``tp`` ranks (this one
    ``rank``) over ``group``."""

    def __init__(self, mesh):
        self.tp, self.rank, self.group = mesh.tp, mesh.tp_rank, mesh.tp_group

    def span(self, n: int) -> tuple[int, int]:
        """[lo, hi) of this rank's share of an axis of ``n``."""
        k = n // self.tp
        return self.rank * k, (self.rank + 1) * k

    def cut(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        lo, hi = self.span(t.shape[axis])
        return t.narrow(axis, lo, hi - lo)

    def copy_in(self, t: torch.Tensor) -> torch.Tensor:
        return CopyIn.apply(t, self.group, "tp/input_grad_allreduce")

    def gather(self, t: torch.Tensor, axis: int, label: str) -> torch.Tensor:
        """Every rank's slice of a sharded leaf (or moment) -> the whole,
        along ``axis`` (a collective: every rank calls it)."""
        t = torch.movedim(t.detach(), axis, 0).contiguous()
        out = torch.empty((self.tp * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t, group=self.group)
        COLLECTIVES[label] += 1
        return torch.movedim(out, 0, axis).contiguous()


class TpModule(nn.Module):
    """A module holding tp-sharded leaves: ``tp_leaves`` {leaf name: axis}.
    A whole leaf (the JAX layout) loading into it is sliced to this rank's
    share."""

    tp_leaves: dict = {}

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for leaf, axis in self.tp_leaves.items():
            key = prefix + leaf
            mine = getattr(self, leaf)
            if key in state_dict and state_dict[key].shape[axis] == mine.shape[axis] * self.tpm.tp:
                state_dict[key] = self.tpm.cut(state_dict[key], axis)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def _slice_param(p: nn.Parameter, tpm: TensorMesh, axis: int) -> nn.Parameter:
    return nn.Parameter(tpm.cut(p.detach(), axis).clone(), requires_grad=p.requires_grad)


class TpColumnDense(TpModule):
    """An MLP block's ``intermediate`` Dense: this rank's rows of the weight
    (its output columns), the bias whole and sliced in the forward."""

    tp_leaves = {"weight": 0}

    def __init__(self, dense, tpm: TensorMesh):
        super().__init__()
        self.tpm, self.dtype = tpm, dense.dtype
        self.weight = _slice_param(dense.weight, tpm, 0)
        self.bias = dense.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        lo, hi = self.tpm.span(self.bias.shape[0])
        return F.linear(self.tpm.copy_in(x).to(dt), self.weight.to(dt), self.bias[lo:hi].to(dt))


class TpRowDense(TpModule):
    """An MLP block's ``mlp_out`` Dense: this rank's columns of the weight
    (its input rows); the partial products summed over tp in f32, then the
    bias, once."""

    tp_leaves = {"weight": 1}

    def __init__(self, dense, tpm: TensorMesh):
        super().__init__()
        self.tpm, self.dtype = tpm, dense.dtype
        self.weight = _slice_param(dense.weight, tpm, 1)
        self.bias = dense.bias

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        part = F.linear(h.to(dt), self.weight.to(dt)).float()
        total = SumOut.apply(part, self.tpm.group, "tp/mlp_out_allreduce")
        return (total + self.bias.float()).to(dt)


class TpRelationNTN(TpModule):
    """The NTN scorer with this rank's ``h/tp`` slices; ``v`` gathered over
    tp, the replicated ``dense`` whole on every rank."""

    tp_leaves = {"tensor_slices": 0}

    def __init__(self, ntn, tpm: TensorMesh):
        super().__init__()
        self.tpm, self.dtype = tpm, ntn.dtype
        self.tensor_slices = _slice_param(ntn.tensor_slices, tpm, 0)
        self.dense = ntn.dense

    def forward(self, class_vec: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
        M = self.tensor_slices.to(self.dtype).float()
        cM = torch.einsum("bnc,hcd->bnhd", self.tpm.copy_in(class_vec).float(), M)
        v = torch.relu(torch.einsum("bnhd,bqd->bqnh", cM, self.tpm.copy_in(query).float()))
        return self.dense(_GatherLast.apply(v, self.tpm))[..., 0]


def attach_tensor(model, mesh) -> int:
    """Put ``model``'s tp-sharded parts on ``mesh``'s tp axis, by
    ``TP_RULES``: the NTN, and each MLP block's ``intermediate``/``mlp_out``
    pair (new parameters: call before the optimizer is made). Returns the
    number of modules replaced; nothing at tp=1 or on a pure layout."""
    if not mesh.live or mesh.tp == 1:
        return 0
    return shard_modules(model, TensorMesh(mesh))


def shard_modules(model, tpm: TensorMesh) -> int:
    """Replace ``model``'s tp-sharded modules by their ``tpm`` shards (the
    body of ``attach_tensor``; a layout ``tpm`` without a group serves the
    tests of the slicing)."""
    from induction_network_on_fewrel_tpu_torch.models.induction import RelationNTN
    from induction_network_on_fewrel_tpu_torch.models.layers import Dense

    swaps = []
    for name, m in model.named_modules():
        if isinstance(m, RelationNTN) and tp_axis(f"{name}.tensor_slices", 3) == 0:
            swaps.append((name, TpRelationNTN(m, tpm)))
        elif isinstance(m, Dense):
            axis = tp_axis(f"{name}.weight", 2)
            if axis is not None:
                swaps.append((name, (TpColumnDense, TpRowDense)[axis](m, tpm)))
    for name, new in swaps:
        parent, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(parent) if parent else model, leaf, new)
    return len(swaps)


def tp_leaves(model) -> list[tuple[str, int, TensorMesh]]:
    """(parameter name, axis, mesh) of every tp-sharded leaf of ``model``."""
    return [(f"{name}.{leaf}", axis, m.tpm) for name, m in model.named_modules()
            if isinstance(m, TpModule) for leaf, axis in m.tp_leaves.items()]


def tp_assembled(model) -> list[nn.Parameter]:
    """The replicated biases that column-split blocks slice in the forward:
    their gradients are assembled over tp after the backward."""
    return [m.bias for _, m in model.named_modules() if isinstance(m, TpColumnDense)]


def tensor_mesh(model):
    """The ``TensorMesh`` of the model's tp modules, or None."""
    for _, m in model.named_modules():
        if isinstance(m, TpModule):
            return m.tpm
    return None
