"""Pipeline parallel: the GPipe microbatch schedule over the pp axis.

Counterpart of ``induction_network_on_fewrel_tpu/parallel/pipeline.py``
(``gpipe_local``, ``make_gpipe``) and of the pp rules of its
``parallel/sharding.py:59-65``. The layer-stacked transformer's depth
shards over the pp ranks: stage s holds layers [s·NL/S, (s+1)·NL/S) of
every ``stack_*`` leaf (``attach_pipeline``; the Adam moments follow, as
the JAX state's paths do), and an encoder call's rows flow through as
``m`` microbatches (``--pp_microbatches``):

* tick t: stage s runs its layers on microbatch t - s, with that
  microbatch's mask; the activation and its mask hop to stage s+1 together
  (the JAX ``:81-91``) through ``grad_buckets.neighbour_hop``, the
  neighbour ``all_to_all_single`` the sp ring uses ("pp/hop"). The hop is
  cyclic, as the ring's: stage S-1's block reaches stage 0, which drops it
  (JAX's shift has no wrap and hands stage 0 zeros; stage 0 reads neither).
  A bubble tick (no microbatch on the stage) skips the compute and still
  hops, so every rank issues the same collectives. The last tick's hop
  would carry only the last stage's output, which goes nowhere: it is not
  issued, so a forward makes m + S - 2 hops.
* after the m + S - 1 ticks the last stage's outputs are summed over the
  pp group with every other stage's zeros ("pp/out_allreduce", the JAX
  ``psum(done * last)``), so every stage holds them and runs the final
  LayerNorm, the pooling and the head replicated, as JAX does;
* the backward is the mirrored schedule, written by hand as ONE autograd
  Function (``GPipe``), as the ring's backward is: autograd would order
  the per-hop backward functions of independent branches as it likes, and
  two ranks issuing their hops in different orders deadlock. Stage s runs
  microbatch j's backward at tick j + S - 1 - s; the cotangent hops s ->
  s-1. The last stage takes the head's cotangent of its outputs from its
  own head, ONCE: every stage computes the same head, so a sum over pp
  would scale the gradient by S. Each stage's forward keeps the autograd
  graph of each microbatch (the JAX scan's saved residuals; no remat);
* where the replicated leaves' gradients meet: the cotangent of the
  pipeline's input lands on stage 0 only and is summed over the pp group
  with the other stages' zeros ("pp/input_grad_allreduce"), so every stage
  back-propagates the same cotangent into ``in_proj``, ``pos_embedding``
  and the word table (the lazy table's compact rows included), and gets the
  same gradients there with no collective over those leaves (a dense
  400 002-row table's all-reduce would be the cost). ``final_ln_*`` and the
  head are computed alike on every stage and get the same gradients. Every
  replicated leaf is then averaged over its dp group alone; a ``stack_*``
  leaf over the dp group of its stage (``Mesh.group`` is that group). The
  clip's global norm adds the stack leaves' squares over pp
  ("pp/norm_allreduce", ``train/steps.ClipDecayOptimizer``); ZeRO-1 leaves
  them whole (the JAX ``state_shardings``: a pp-sharded leaf is not also
  dp-sharded).

Without a gradient (eval, serving a pp run's model) the same forward runs
with nothing saved. Checkpoints hold the one JAX-named tree:
``parallel/expert.full_state_dict`` all-gathers the stack leaves over pp
("pp/params_allgather"), the optimizer their moments
("pp/moments_allgather"); a whole leaf loading into a stage is sliced, so
a checkpoint restores at any pp.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from induction_network_on_fewrel_tpu_torch.models.pipeline_transformer import sequential_blocks
from induction_network_on_fewrel_tpu_torch.parallel.grad_buckets import (
    COLLECTIVES,
    neighbour_hop,
)


def microbatch_refusal(rows: int, m: int) -> str | None:
    """The JAX ``gpipe_local`` text when ``rows`` do not split into ``m``
    microbatches, else None."""
    if rows % m == 0:
        return None
    return (f"pipeline batch rows per dp shard ({rows}) must divide evenly into "
            f"pp_microbatches ({m}); adjust --batch_size/--pp_microbatches")


class PipeStage:
    """This rank's place on the pp axis: ``pp`` stages over ``group``, this
    one ``stage``, ``microbatches`` per encoder call; called as the
    encoder's ``pipeline_impl``."""

    def __init__(self, mesh, microbatches: int):
        self.pp, self.stage, self.group = mesh.pp, mesh.pp_rank, mesh.pp_group
        self.microbatches = int(microbatches)
        self.next_index = (self.stage + 1) % self.pp
        self.prev_index = (self.stage - 1) % self.pp

    @property
    def last(self) -> bool:
        return self.stage == self.pp - 1

    def span(self, n: int) -> tuple[int, int]:
        """[lo, hi) of this stage's layers of ``n``."""
        k = n // self.pp
        return self.stage * k, (self.stage + 1) * k

    def cut(self, t: torch.Tensor, axis: int = 0) -> torch.Tensor:
        lo, hi = self.span(t.shape[axis])
        return t.narrow(axis, lo, hi - lo)

    def gather(self, t: torch.Tensor, axis: int, label: str) -> torch.Tensor:
        """Every stage's slice of a stack leaf (or moment) -> the whole,
        along ``axis`` (a collective: every stage calls it)."""
        t = torch.movedim(t.detach(), axis, 0).contiguous()
        out = torch.empty((self.pp * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t, group=self.group)
        COLLECTIVES[label] += 1
        return torch.movedim(out, 0, axis).contiguous()

    def hop(self, buf: torch.Tensor, forward: bool) -> torch.Tensor:
        """``buf`` one stage on (forward: s -> s+1; backward: s -> s-1)."""
        to, frm = ((self.next_index, self.prev_index) if forward else
                   (self.prev_index, self.next_index))
        return neighbour_hop(buf, self.group, self.pp, to, frm, "pp/hop")

    def total(self, t: torch.Tensor, label: str) -> torch.Tensor:
        """``t`` summed over the stages (one stage holds it, the rest zeros)."""
        t = t.contiguous()
        dist.all_reduce(t, group=self.group)
        COLLECTIVES[label] += 1
        return t

    def hops_per_call(self) -> int:
        """The hops of one forward (and of one backward)."""
        return self.microbatches + self.pp - 2

    def __call__(self, block_fn, stacked: dict, x: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
        names = tuple(stacked)
        leaves = tuple(stacked[n] for n in names)
        if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in leaves)):
            return GPipe.apply(x, mask, self, block_fn, names, *leaves)
        with torch.no_grad():
            return forward_schedule(self, x, mask, lambda j, cur, m: sequential_blocks(
                block_fn, dict(zip(names, leaves)), cur, m))


def _split(stage: PipeStage, x: torch.Tensor, mask: torch.Tensor):
    """x [M, L, d] -> [m, M/m, L, d]; mask [M, L] -> [m, M/m, L] in x's dtype."""
    m = stage.microbatches
    why = microbatch_refusal(x.shape[0], m)
    if why:
        raise ValueError(why)
    return (x.reshape(m, x.shape[0] // m, *x.shape[1:]),
            mask.to(x.dtype).reshape(m, x.shape[0] // m, mask.shape[-1]))


def forward_schedule(stage: PipeStage, x: torch.Tensor, mask: torch.Tensor, run) -> torch.Tensor:
    """The forward ticks of ``stage``; ``run(j, act, act_mask)`` is this
    stage's layers on microbatch ``j``. Returns [M, L, d]: the last stage's
    outputs on every stage."""
    S, s, m = stage.pp, stage.stage, stage.microbatches
    xs, ms = _split(stage, x, mask)
    act, act_mask = torch.zeros_like(xs[0]), torch.zeros_like(ms[0])
    done = torch.zeros_like(xs)
    n = act.numel()
    for t in range(m + S - 1):
        j = t - s
        cur, cur_m = (xs[j], ms[j]) if s == 0 and j < m else (act, act_mask)
        if 0 <= j < m:
            out = run(j, cur, cur_m)
            if stage.last:
                done[j] = out
        else:                   # a bubble: no microbatch here, the hop still runs
            out = torch.zeros_like(cur)
        if t + 1 < m + S - 1:
            buf = stage.hop(torch.cat([out.reshape(-1), cur_m.reshape(-1)]), forward=True)
            act, act_mask = buf[:n].view_as(act), buf[n:].view_as(act_mask)
    return stage.total(done, "pp/out_allreduce").reshape(x.shape)


class GPipe(torch.autograd.Function):
    """x [M, L, d], mask [M, L] -> [M, L, d]: this stage's layers (the
    stacked leaves ``*leaves`` named ``names``) in the GPipe schedule of
    ``stage``, forward and the mirrored backward."""

    @staticmethod
    def forward(ctx, x, mask, stage, block_fn, names, *leaves):
        live = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        stacked = dict(zip(names, live))
        graphs = {}

        def run(j, cur, cur_m):
            inp = cur.detach().requires_grad_(x.requires_grad)
            with torch.enable_grad():
                out = sequential_blocks(block_fn, stacked, inp, cur_m)
            graphs[j] = (inp, out)
            return out.detach()

        y = forward_schedule(stage, x, mask, run)
        ctx.stage, ctx.graphs, ctx.live = stage, graphs, live
        ctx.x_requires_grad = x.requires_grad
        return y

    @staticmethod
    def backward(ctx, gy):
        stage, live = ctx.stage, ctx.live
        S, s, m = stage.pp, stage.stage, stage.microbatches
        gys = gy.reshape(m, gy.shape[0] // m, *gy.shape[1:])
        wants = [i for i, p in enumerate(live) if p.requires_grad]
        grads = [None] * len(live)
        dxs = torch.zeros_like(gys)
        recv = torch.zeros_like(gys[0])
        for t in range(m + S - 1):
            j = t - (S - 1 - s)
            if 0 <= j < m:
                inp, out = ctx.graphs.pop(j)
                cot = gys[j] if stage.last else recv
                inputs = ([inp] if inp.requires_grad else []) + [live[i] for i in wants]
                got = torch.autograd.grad(out, inputs, cot, allow_unused=True)
                dinp = got[0] if inp.requires_grad else None
                for i, g in zip(wants, got[len(got) - len(wants):]):
                    if g is not None:
                        grads[i] = g if grads[i] is None else grads[i] + g
                if dinp is None:
                    dinp = torch.zeros_like(recv)
                if s == 0:
                    dxs[j] = dinp
            else:
                dinp = torch.zeros_like(recv)
            if t + 1 < m + S - 1:
                recv = stage.hop(dinp.contiguous().reshape(-1), forward=False).view_as(recv)
        grads = [g if g is not None or not p.requires_grad else torch.zeros_like(p)
                 for g, p in zip(grads, live)]
        dx = None
        if ctx.x_requires_grad:
            dx = stage.total(dxs, "pp/input_grad_allreduce").reshape(gy.shape)
        return (dx, None, None, None, None, *grads)


def attach_pipeline(model, mesh) -> bool:
    """Put ``model``'s layer-stacked transformer on ``mesh``'s pp axis: a
    ``PipeStage`` as its executor, and this stage's slice of every
    ``stack_*`` leaf (new parameters: call before the optimizer is made).
    True when attached (pp > 1 on a live mesh)."""
    from induction_network_on_fewrel_tpu_torch.models.pipeline_transformer import (
        STACK,
        PipelinedTransformerEncoder,
    )

    if not mesh.live or mesh.pp == 1:
        return False
    enc = getattr(model, "encoder", None)
    if not isinstance(enc, PipelinedTransformerEncoder):
        raise ValueError("--pp (pipeline parallelism) requires --encoder transformer (stages are "
                         "transformer layers)")
    if enc.pipeline_impl is not None:
        return True
    if enc.num_layers % mesh.pp:
        raise ValueError(f"--tfm_layers ({enc.num_layers}) must be divisible by --pp "
                         f"({mesh.pp}) pipeline stages")
    stage = PipeStage(mesh, enc.microbatches)
    for name, *_ in STACK:
        full = getattr(enc, f"stack_{name}")
        setattr(enc, f"stack_{name}", torch.nn.Parameter(stage.cut(full.detach()).clone(),
                                                         requires_grad=full.requires_grad))
    enc.pipeline_impl = stage
    return True


def pipe_stage(model):
    """The model's ``PipeStage``, or None."""
    return getattr(getattr(model, "encoder", None), "pipeline_impl", None)


def pp_leaves(model) -> list:
    """(parameter name, axis, stage) of every pp-sharded leaf of ``model``:
    the stack leaves (the JAX ``stack_`` rule) of a transformer on a pp
    axis."""
    stage = pipe_stage(model)
    if stage is None:
        return []
    return [(n, 0, stage) for n, _ in model.named_parameters()
            if n.rsplit(".", 1)[-1].startswith("stack_")]
