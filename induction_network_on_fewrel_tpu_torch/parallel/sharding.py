"""The dp parts of sharding: ZeRO-1, the compact table gradient, the dp step.

Counterpart of ``induction_network_on_fewrel_tpu/parallel/sharding.py``
for ``dp`` and ``ep`` (tp/sp/pp come with ROADMAP queue A item 6d; the
ep rules and the MoE layers on a mesh are ``parallel/expert.py``). There
GSPMD partitions one program over the mesh; here each rank runs the step
on its own ``B/dp`` episodes and these pieces make the ranks one
optimizer:

* ``DataParallel``: the dp state of one trainer. Its ``GradReducer``
  (``parallel/grad_buckets.py``) averages the gradients over the ranks
  between the backward and the update; ``mean_`` averages the step's loss
  and accuracy (GSPMD's global mean) and the eval metrics. Under NCCL the
  collectives run inside the captured step; under gloo (CPU ranks, or two
  ranks on one card) the steps stay eager (``eager``). The adversarial
  step (``disc``, the JAX ``make_sharded_adv_train_step``, ``:514``)
  adds a second reducer for the discriminator's gradients ("disc/"
  labels; bucketed and started from the backward as the model's are),
  and its metric mean covers ``domain_loss`` and ``domain_accuracy``
  too; ZeRO-1 shards the model's moments only (the JAX
  ``state_shardings(..., zero_opt)`` of ``state``, not ``disc_state``).
* ``Zero1`` (``state_shardings(zero_opt)`` and the zero1 update, JAX
  ``sharding.py:89``, ``:343``, ``train/steps.py:226-260``): each rank
  holds a contiguous 1/dp chunk of every Adam moment whose size divides
  dp (Adam is elementwise, so a chunk of each flattened leaf is the JAX
  math; the JAX per-axis search is a layout choice only), applies
  ``optim_update`` to its chunk of the parameters, and all-gathers the
  parameters bucket by bucket. The clip's global norm is taken from the
  fully reduced gradient, the same on every rank. A checkpoint holds the
  gathered full moments, so it restores at any world size; a restore
  re-shards (``load_state_dict``).
* the compact table gradient (``make_compact_demb_lookup``,
  ``demb_impl_for``): on the lazy path each rank's segment sum of its own
  tokens lands in the compact [U, D] rows leaf, and ONE all-reduce of those
  rows follows (``demb/compact_allreduce``), never of the dense [V, D]
  table. ``compact_demb off`` is the dense spelling for A/Bs: every rank
  all-gathers the [*, D] embedding cotangent and the ids and sums the
  whole batch itself (``GatheredCotangentLookup``), no rows all-reduce.
  A shared (dense) table's gradient is reduced with the other parameters,
  as the JAX large-table path keeps its native lookup.
* MoE (``cfg.moe_experts``): the model's MoE layers run on the mesh
  (``parallel/expert.attach_experts``: global routing and load-balance
  term, the experts sharded over ep), their collectives in the plan; the
  gradients stay monolithic (the JAX bucket rule under MoE).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from induction_network_on_fewrel_tpu_torch.models.moe import moe_layers
from induction_network_on_fewrel_tpu_torch.ops.segsum import (
    MATMUL_GRAD_MAX_ROWS,
    segment_sum_matmul,
    segsum_prefix,
)
from induction_network_on_fewrel_tpu_torch.parallel.grad_buckets import (
    COLLECTIVES,
    ROWS_PATH,
    GradReducer,
    bucket_index,
    grad_buckets_for,
    overlap_for,
)


def all_gather(out: torch.Tensor, inp: torch.Tensor, group, label: str) -> None:
    """``out`` [W*n] <- every rank's ``inp`` [n], in rank order."""
    dist.all_gather_into_tensor(out, inp, group=group)
    COLLECTIVES[label] += 1


# --- the compact table gradient -------------------------------------------


class GatheredCotangentLookup(torch.autograd.Function):
    """``rows[ids]`` whose backward all-gathers every rank's cotangent and
    ids and returns the whole global batch's segment sum over the ranks'
    count (the mean's gradient): the dense-cotangent spelling."""

    @staticmethod
    def forward(ctx, rows, ids, group, world):
        ctx.save_for_backward(ids)
        ctx.group, ctx.world, ctx.num_rows, ctx.dtype = group, world, rows.shape[0], rows.dtype
        return rows[ids]

    @staticmethod
    def backward(ctx, cot):
        (ids,) = ctx.saved_tensors
        D = cot.shape[-1]
        cot = cot.reshape(-1, D).float().contiguous()
        ids = ids.reshape(-1).contiguous()
        all_cot = torch.empty((ctx.world * cot.shape[0], D), dtype=cot.dtype, device=cot.device)
        all_ids = torch.empty(ctx.world * ids.numel(), dtype=ids.dtype, device=ids.device)
        all_gather(all_cot, cot, ctx.group, "demb/cotangent_allgather")
        all_gather(all_ids, ids, ctx.group, "demb/ids_allgather")
        fn = segment_sum_matmul if ctx.num_rows <= MATMUL_GRAD_MAX_ROWS else segsum_prefix
        grad = fn(all_cot, all_ids, ctx.num_rows) / ctx.world
        return grad.to(ctx.dtype), None, None, None


def make_compact_demb_lookup(mesh):
    """The dense-spelling lookup of ``mesh`` (``GatheredCotangentLookup``),
    as ``Embedding.demb_impl``; None without a live group."""
    if not mesh.live:
        return None

    def lookup(rows, ids):
        return GatheredCotangentLookup.apply(rows, ids, mesh.group, mesh.dp)

    return lookup


def demb_impl_for(cfg, mesh, device=None) -> str | None:
    """Resolve ``cfg.compact_demb`` (the JAX rule): "compact" when the
    mesh has dp ranks (a live group counts at dp=1) and the knob is not
    "off", else None. Bucketed runs resolve None: the rows leaf is then
    reduced in the last bucket."""
    if mesh is None or getattr(cfg, "compact_demb", "auto") == "off":
        return None
    if mesh.dp <= 1 and not mesh.live:
        return None
    if grad_buckets_for(cfg, mesh, device) > 0:
        return None
    return "compact"


# --- ZeRO-1 -------------------------------------------------------------------


class Zero1:
    """The ZeRO-1 layout of an optimizer's moments over ``mesh``: leaf
    ``i`` (in ``shards``) keeps moments for flat elements [lo, lo + n) of
    this rank; the parameters are all-gathered per bucket after each
    update."""

    def __init__(self, names: list, params: list, moment_leaves: list, mesh, n_buckets: int):
        self.group, self.world, self.rank = mesh.group, mesh.dp, mesh.rank
        self.shards: dict = {}
        for i in moment_leaves:
            numel = params[i].numel()
            if numel >= self.world and numel % self.world == 0:
                n = numel // self.world
                self.shards[i] = (self.rank * n, n)
        nb = max(1, n_buckets)
        plan: dict = {}
        for i in self.shards:
            plan.setdefault(bucket_index(names[i], nb), []).append(i)
        self.buckets = []
        for b in sorted(plan):
            idx = plan[b]
            S = sum(self.shards[i][1] for i in idx)
            dev = params[idx[0]].device
            self.buckets.append((b, idx, torch.empty(S, device=dev),
                                 torch.empty(self.world * S, device=dev)))

    def view(self, i: int, t: torch.Tensor | None) -> torch.Tensor | None:
        """This rank's chunk of leaf ``i``'s tensor ``t`` (a view)."""
        if t is None:
            return None
        lo, n = self.shards[i]
        return t.reshape(-1)[lo:lo + n]

    @torch.no_grad()
    def gather_params(self, params: list) -> None:
        """Every rank's updated chunks into every rank's parameters."""
        for b, idx, send, recv in self.buckets:
            off = 0
            for i in idx:
                n = self.shards[i][1]
                send[off:off + n].copy_(self.view(i, params[i]))
                off += n
            all_gather(recv, send, self.group, f"zero1/params_bucket_{b}")
            grid = recv.view(self.world, -1)
            off = 0
            for i in idx:
                n = self.shards[i][1]
                params[i].view(-1).copy_(grid[:, off:off + n].reshape(-1))
                off += n

    @torch.no_grad()
    def gather_moment(self, i: int, shard: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """The full moment of leaf ``i`` (shaped ``like``) from the ranks'
        chunks: a checkpoint's copy."""
        out = torch.empty(like.numel(), dtype=shard.dtype, device=shard.device)
        all_gather(out, shard.contiguous(), self.group, "zero1/moments")
        return out.view_as(like)


# --- the dp state of a trainer ---------------------------------------------------


class DataParallel:
    """One trainer's data parallelism over ``mesh``: the gradient reducer
    (buckets per ``grad_buckets_for``, overlap per ``async_collectives``,
    the lazy rows leaf per ``demb_impl_for``), ZeRO-1 on ``opt`` under
    ``cfg.zero_opt``, and the metric mean. ``disc``: the adversarial
    step's discriminator optimizer, whose gradients get a reducer of their
    own (``disc_reducer``); its moments stay whole. An MoE model's layers
    run on the mesh (``attach_experts``, called before ``opt`` was made:
    at ep > 1 it keeps a slice of each expert leaf), and ``opt`` adds its
    expert leaves' norm over the ep group
    (``ClipDecayOptimizer.shard_experts``)."""

    def __init__(self, model, opt, cfg, mesh, lazy=None, disc=None):
        from induction_network_on_fewrel_tpu_torch.parallel.expert import expert_mesh

        self.mesh, self.cfg = mesh, cfg
        self.moe_layers = len(moe_layers(model))
        if self.moe_layers and mesh.live:
            em = expert_mesh(model)
            if em is None:
                raise ValueError("the model's MoE layers are put on the mesh "
                                 "(parallel/expert.attach_experts) before its optimizer is made")
            if em.ep > 1:
                opt.shard_experts(em)
        self.ep = mesh.ep
        self.encoder_calls = 3 if disc is not None else 1
        self.group, self.world, self.rank = mesh.group, mesh.dp, mesh.rank
        device = model.device
        self.n_buckets = grad_buckets_for(cfg, mesh, device)
        self.compact = demb_impl_for(cfg, mesh, device) is not None
        self.gathered_cotangent = False
        rows = None
        if lazy is not None:
            if self.n_buckets or self.compact:
                rows = (ROWS_PATH, lazy.rows)
            else:
                self.gathered_cotangent = True
                model.embedding.demb_impl = make_compact_demb_lookup(mesh)
        self.reducer = GradReducer(opt.live_named(), mesh, self.n_buckets, overlap_for(cfg), rows)
        self.disc_reducer = (GradReducer(disc.live_named(), mesh, self.n_buckets,
                                         overlap_for(cfg), prefix="disc/")
                             if disc is not None else None)
        self.reducers = [r for r in (self.reducer, self.disc_reducer) if r is not None]
        if cfg.zero_opt:
            opt.shard(mesh, self.n_buckets)
        self.zero = opt.zero
        # gloo's collectives run on the host: its steps stay eager.
        self.eager = device.type != "cuda" or mesh.backend != "nccl"

    def plan(self, steps: int = 1) -> dict:
        """The collectives one call of ``steps`` training steps should
        issue, by kind (``COLLECTIVES``' labels): each step's reductions and
        gathers (an MoE layer's per encoder call: one routing all-gather,
        and at ep > 1 the combine's all-reduce and the two backward
        all-reduces; the expert norm's once a step), and the loss and
        accuracy mean once a call."""
        out = {label: steps for r in self.reducers for label in r.labels}
        if self.moe_layers and self.mesh.live:
            calls = steps * self.moe_layers * self.encoder_calls
            out["moe/route_allgather"] = calls
            if self.ep > 1:
                out.update({"ep/combine_allreduce": calls, "ep/input_grad_allreduce": calls,
                            "ep/gate_grad_allreduce": calls, "ep/norm_allreduce": steps})
        if self.gathered_cotangent:
            out.update({"demb/cotangent_allgather": steps, "demb/ids_allgather": steps})
        if self.zero is not None:
            out.update({f"zero1/params_bucket_{b}": steps for b, *_ in self.zero.buckets})
        out["metrics/mean"] = 1
        return out

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (contiguous) <- its mean over the ranks, in place."""
        dist.all_reduce(t, group=self.group)
        COLLECTIVES["metrics/mean"] += 1
        return t.div_(self.world)

    def arm(self) -> None:
        """Before a backward: every reducer's buckets start as they fill."""
        for r in self.reducers:
            r.arm()

    def finish(self) -> None:
        """After a backward: every gradient holds its mean over the ranks."""
        for r in self.reducers:
            r.finish()

    def mean_columns(self, rows: torch.Tensor, cols: tuple) -> torch.Tensor:
        """[S, c] metric rows with the columns ``cols`` averaged over the
        ranks in one all-reduce (loss, accuracy and the domain game's; the
        gradient norm is already global)."""
        # Column slices only: an index tensor would copy from the host
        # inside a capture.
        idx = list(cols)
        mean = self.mean_(torch.cat([rows[:, j:j + 1] for j in idx], dim=1).contiguous())
        return torch.cat([mean[:, idx.index(j):idx.index(j) + 1] if j in idx else
                          rows[:, j:j + 1] for j in range(rows.shape[1])], dim=1)

    def gather_objects(self, obj) -> list:
        """Every rank's ``obj`` (picklable), in rank order."""
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def barrier(self) -> None:
        """Every rank of the world (the writer, rank 0, is in one dp group
        only at ep > 1)."""
        dist.barrier()
