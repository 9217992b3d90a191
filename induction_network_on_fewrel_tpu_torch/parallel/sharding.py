"""The dp parts of sharding: ZeRO-1, the compact table gradient, the dp step.

Counterpart of ``induction_network_on_fewrel_tpu/parallel/sharding.py``
for ``dp`` (the ep rules and the MoE layers on a mesh are
``parallel/expert.py``, the tp rules ``parallel/tensor.py``, the sp
executor ``parallel/ring.py``, the pp rules and executor
``parallel/pipeline.py``). There
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
* tp and sp (``parallel/tensor.py``, ``parallel/ring.py``, attached
  before the optimizer by ``attach_parallel``): after the dp reduction the
  column-split blocks' biases are assembled over tp and the token-partial
  leaves summed over sp (``finish``); the gradients stay monolithic (the
  JAX bucket rule on a mesh with another axis above 1).
* pp (``parallel/pipeline.py``, attached by ``attach_parallel``): each
  stage's optimizer holds its own stack slices and their moments
  (``ClipDecayOptimizer.shard_pipeline``); the replicated leaves come out
  of the backward equal on every stage, so every gradient is averaged over
  the stage's dp group alone; ZeRO-1 chunks the stage's replicated leaves
  over that group and leaves the stack slices whole (the JAX
  ``state_shardings``); the gradients stay monolithic.
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
    reduced in the last bucket. So do meshes with an sp axis above 1 (the
    token axis is sharded: the JAX generic path)."""
    if mesh is None or getattr(cfg, "compact_demb", "auto") == "off":
        return None
    if getattr(mesh, "sp", 1) > 1:
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


def attach_parallel(model, mesh) -> None:
    """Put ``model``'s sharded parts on the live ``mesh``, before its
    optimizer is made (each makes new parameters or hooks): the MoE layers
    (``parallel/expert.attach_experts``), the tp-sharded modules
    (``parallel/tensor.attach_tensor``), the sp encoder
    (``parallel/ring.attach_sequence``) and the pipeline stage
    (``parallel/pipeline.attach_pipeline``)."""
    from induction_network_on_fewrel_tpu_torch.parallel.expert import attach_experts
    from induction_network_on_fewrel_tpu_torch.parallel.pipeline import attach_pipeline
    from induction_network_on_fewrel_tpu_torch.parallel.ring import attach_sequence
    from induction_network_on_fewrel_tpu_torch.parallel.tensor import attach_tensor

    attach_experts(model, mesh)
    attach_tensor(model, mesh)
    attach_sequence(model, mesh)
    attach_pipeline(model, mesh)


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
        self._tensor_and_sequence(model, opt, mesh, lazy)
        self._pipeline(model, opt, mesh)
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

    def _tensor_and_sequence(self, model, opt, mesh, lazy) -> None:
        """The tp and sp parts of the step: the tp-sharded leaves on the
        optimizer, the biases to assemble over tp, the token-partial leaves
        to sum over sp, and the counts the plan reads."""
        from induction_network_on_fewrel_tpu_torch.parallel.ring import (
            is_token_partial,
            sequence_shard,
        )
        from induction_network_on_fewrel_tpu_torch.parallel.tensor import (
            TpColumnDense,
            TpRelationNTN,
            tensor_mesh,
            tp_assembled,
        )

        self.tp, self.sp = mesh.tp, mesh.sp
        self.tpm = tensor_mesh(model)
        self.assembled = []
        self.ntn = self.mlp_blocks = self.mlp_backward = self.attn_layers = 0
        if mesh.live and mesh.tp > 1:
            if self.tpm is None:
                raise ValueError("the model's tp-sharded parts are put on the mesh "
                                 "(parallel/tensor.attach_tensor) before its optimizer is made")
            opt.shard_tensor(model)
            self.assembled = tp_assembled(model)
            mods = [m for _, m in model.named_modules()]
            self.ntn = sum(isinstance(m, TpRelationNTN) for m in mods)
            self.mlp_blocks = sum(isinstance(m, TpColumnDense) for m in mods)
            # A frozen BERT backbone's output is detached: no backward
            # through its blocks.
            frozen = getattr(getattr(model, "encoder", None), "frozen", False)
            self.mlp_backward = 0 if frozen else self.mlp_blocks
        self.seq = sequence_shard(model)
        self.partial = []
        if mesh.live and mesh.sp > 1:
            if self.seq is None:
                raise ValueError("the model's encoder is put on the mesh "
                                 "(parallel/ring.attach_sequence) before its optimizer is made")
            self.partial = [p for n, p in opt.live_named() if is_token_partial(n)]
            if lazy is not None:
                self.partial.append(lazy.rows)
            self.attn_layers = model.encoder.num_layers

    def _pipeline(self, model, opt, mesh) -> None:
        """The pp part: this stage's stack slices on the optimizer."""
        from induction_network_on_fewrel_tpu_torch.parallel.pipeline import pipe_stage

        self.pp, self.stage = mesh.pp, pipe_stage(model)
        if mesh.live and mesh.pp > 1:
            if self.stage is None:
                raise ValueError("the model's pipeline stage is put on the mesh "
                                 "(parallel/pipeline.attach_pipeline) before its optimizer is made")
            opt.shard_pipeline(model)

    def _sum_over(self, leaves: list, group, label: str) -> None:
        """Every leaf's gradient <- its sum over ``group``, in one flat
        all-reduce."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        dist.all_reduce(flat, group=group)
        COLLECTIVES[label] += 1
        off = 0
        for p, g in zip(leaves, grads):
            n = g.numel()
            total = flat[off:off + n].view_as(p).to(p.dtype)
            if p.grad is None:
                p.grad = total
            else:
                p.grad.copy_(total)
            off += n

    def plan(self, steps: int = 1) -> dict:
        """The collectives one call of ``steps`` training steps should
        issue, by kind (``COLLECTIVES``' labels): each step's reductions and
        gathers (an MoE layer's per encoder call: one routing all-gather,
        and at ep > 1 the combine's all-reduce and the two backward
        all-reduces; the expert norm's once a step; at pp > 1 an encoder
        call's m + S - 2 hops each way and its two sums over pp, the stack
        norm's once a step), and the loss and accuracy mean once a call."""
        out = {label: steps for r in self.reducers for label in r.labels}
        if self.moe_layers and self.mesh.live:
            calls = steps * self.moe_layers * self.encoder_calls
            out["moe/route_allgather"] = calls
            if self.ep > 1:
                out.update({"ep/combine_allreduce": calls, "ep/input_grad_allreduce": calls,
                            "ep/gate_grad_allreduce": calls, "ep/norm_allreduce": steps})
        calls = steps * self.encoder_calls
        if self.tp > 1:
            out.update({"tp/norm_allreduce": steps,
                        "tp/input_grad_allreduce": steps * 2 * self.ntn
                        + calls * self.mlp_backward})
            if self.ntn:
                out["tp/ntn_allgather"] = steps * self.ntn
            if self.mlp_blocks:
                out.update({"tp/mlp_out_allreduce": calls * self.mlp_blocks,
                            "tp/bias_grad_allreduce": steps})
        if self.sp > 1:
            out.update({"sp/ring_hop": calls * self.attn_layers * (2 * self.sp - 1),
                        "sp/pool_allreduce": calls, "sp/grad_allreduce": steps})
        if self.pp > 1:
            out.update({"pp/hop": calls * 2 * self.stage.hops_per_call(),
                        "pp/out_allreduce": calls, "pp/input_grad_allreduce": calls,
                        "pp/norm_allreduce": steps})
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
        """After a backward: every gradient holds its mean over the ranks
        (the dp reducers'; then, at tp > 1, the column-split biases
        assembled over tp, and at sp > 1 the token-partial leaves summed
        over sp: sums and means commute)."""
        for r in self.reducers:
            r.finish()
        if self.assembled:
            self._sum_over(self.assembled, self.tpm.group, "tp/bias_grad_allreduce")
        if self.partial:
            self._sum_over(self.partial, self.seq.group, "sp/grad_allreduce")

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
