"""Bucketed gradient all-reduce over the dp ranks.

Counterpart of ``induction_network_on_fewrel_tpu/parallel/grad_buckets.py``.
There the fwd+bwd runs per shard inside ``shard_map`` and the cross-shard
means are free-floating ops outside it, one named psum per
reverse-topological bucket, so that XLA can fly bucket 0's all-reduce
while later buckets' backward still computes. Here every rank runs its own
fwd+bwd on its own episodes, and ``GradReducer`` averages the gradients
over the ranks:

* the gradients are grouped into ``grad_bucket_count`` buckets by
  ``bucket_index`` (output to input: the relation head first, the word
  table last; the lazy table's compact rows leaf ``lazy_embed`` is in the
  last bucket, as the JAX ``train/lazy_embed.py:370`` puts it);
* each bucket is copied into one flat f32 buffer, all-reduced (sum) and
  divided by the world size: the mean over ranks of per-rank means, the
  global-batch mean up to float reassociation;
* ``overlap`` (``--async_collectives on|auto``): a post-accumulate-grad
  hook on each member starts its bucket's all-reduce as soon as the
  bucket's last gradient is ready in the backward; ``off``: every bucket
  after the backward. ``finish`` waits for them all and copies the means
  back into ``.grad``.

Resolved off (``grad_buckets_for`` = 0: "monolithic"), every gradient is
one flat all-reduce after the backward, and the compact rows leaf gets its
own (``demb/compact_allreduce``; parallel/sharding.py). Under NCCL the
all-reduces run inside the captured step (one replay issues them all);
gloo's run on the host, so its steps stay eager (train/steps.py).

``COLLECTIVES`` counts the collectives the port issues, by kind, where
they are issued (the MoE layers' too, ``parallel/expert.py``, and the tp
and sp executors', ``parallel/tensor.py``, ``parallel/ring.py``; under a
CUDA graph: the warm-up's and the capture's, not the replays', as the
kernel wrappers count launches).
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

# Leaf-path fragment -> backward stage, output-to-input (the JAX table).
# The port's parameter names ("encoder.att_w1") hold the same fragments as
# the JAX paths ("encoder/att_w1"); "lazy_embed" names the compact rows.
_STAGES: tuple[tuple[str, int], ...] = (
    ("relation", 0),
    ("induction", 1),
    ("query_proj", 1),
    ("att_", 2),
    ("encoder", 3),
    ("embedding", 4),
    ("lazy_embed", 4),
)
_N_STAGES = 5
_DEFAULT_STAGE = 2
ROWS_PATH = "lazy_embed"

COLLECTIVES: collections.Counter = collections.Counter()


class CopyIn(torch.autograd.Function):
    """Identity forward; the gradient summed over ``group`` in backward
    (the input of a part split over ``group``, whose ranks each hold a
    partial of its gradient)."""

    @staticmethod
    def forward(ctx, t, group, label):
        ctx.group, ctx.label = group, label
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        COLLECTIVES[ctx.label] += 1
        return g, None, None


class SumOut(torch.autograd.Function):
    """The sum over ``group`` forward; identity backward (every rank of the
    group consumes the sum alike)."""

    @staticmethod
    def forward(ctx, t, group, label):
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        COLLECTIVES[label] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def neighbour_hop(buf: torch.Tensor, group, size: int, to: int, frm: int,
                  label: str) -> torch.Tensor:
    """``buf`` (1-D) to index ``to`` of ``group`` (``size`` ranks); the
    block from index ``frm``, back: the JAX ``ppermute`` of one hop, as ONE
    ``all_to_all_single`` whose only non-empty splits are those two (a
    neighbour exchange, never an all-gather). gloo refuses ``send``/``recv``
    on CUDA tensors ("writev ... Bad address") and takes this one; NCCL
    runs it as grouped send/recv. The sp ring (``parallel/ring.py``) and the
    GPipe schedule (``parallel/pipeline.py``) hop through it."""
    out = torch.empty_like(buf)
    n = buf.numel()
    send = [n if j == to else 0 for j in range(size)]
    recv = [n if j == frm else 0 for j in range(size)]
    dist.all_to_all_single(out, buf, output_split_sizes=recv, input_split_sizes=send,
                           group=group)
    COLLECTIVES[label] += 1
    return out


def bucket_index(path: str, n_buckets: int) -> int:
    """Bucket for a param-leaf path: stage scaled into [0, n_buckets)."""
    stage = _DEFAULT_STAGE
    for frag, s in _STAGES:
        if frag in path:
            stage = s
            break
    return min(stage * n_buckets // _N_STAGES, n_buckets - 1)


def grad_buckets_for(cfg, mesh, device=None) -> int:
    """Resolve ``cfg.grad_bucketing`` against the mesh: the bucket count,
    or 0 (monolithic). The JAX rule: off without a dp axis above 1, on
    meshes with another axis above 1 (ep, tp, sp; ``make_mesh`` refuses
    pp) and under MoE; "auto" resolves on only on the accelerator
    (here the card: ``device``, default whether CUDA is present) and only
    for the lazy word table; "on" forces it. One difference: a mesh with
    a live process group resolves at dp=1 too, so world size 1 issues the
    collectives world size N does."""
    knob = getattr(cfg, "grad_bucketing", "off")
    if knob == "off" or mesh is None:
        return 0
    if mesh.dp <= 1 and not mesh.live:
        return 0
    if any(getattr(mesh, ax, 1) > 1 for ax in ("tp", "sp", "pp", "ep")) or \
            getattr(cfg, "moe_experts", 0) > 0:
        return 0
    on_card = (torch.device(device).type == "cuda" if device is not None
               else torch.cuda.is_available())
    if knob == "auto" and (not on_card or getattr(cfg, "embed_optimizer", "shared") != "lazy"):
        return 0
    return max(1, int(getattr(cfg, "grad_bucket_count", 4)))


def overlap_for(cfg) -> bool:
    """``--async_collectives``: "on"/"auto" start each bucket from the
    backward, "off" after it."""
    return getattr(cfg, "async_collectives", "auto") != "off"


class GradReducer:
    """The mean over ``mesh``'s ranks of the gradients of ``named`` ((name,
    leaf) pairs), in buckets. ``rows``: the compact rows leaf (name, leaf)
    or None; it joins the last bucket when bucketed, else is reduced on
    its own. ``prefix`` heads every label (the discriminator's reducer:
    "disc/"). ``arm()`` before the backward, ``finish()`` after it."""

    def __init__(self, named: list, mesh, n_buckets: int, overlap: bool, rows=None,
                 prefix: str = ""):
        self.group, self.world = mesh.group, mesh.dp
        self.overlap = bool(overlap and n_buckets > 0)
        plan: dict = {}
        n = max(1, n_buckets)
        for name, p in named:
            b = bucket_index(name, n) if n_buckets else 0
            plan.setdefault(b, []).append(p)
        if rows is not None:
            b = bucket_index(ROWS_PATH, n) if n_buckets else n      # its own, after all
            plan.setdefault(b, []).append(rows[1])
        self.labels = [prefix + (f"grad/bucket_{b}" if n_buckets else
                                 "demb/compact_allreduce" if b == n else "grad/all")
                       for b in sorted(plan)]
        self.members = [plan[b] for b in sorted(plan)]
        self.bufs = []
        self.slots: dict = {}
        for i, ms in enumerate(self.members):
            off = 0
            for p in ms:
                self.slots[id(p)] = (i, off)
                off += p.numel()
            self.bufs.append(torch.zeros(off, dtype=torch.float32, device=ms[0].device))
        self.armed = False
        self.pending: list = []
        self.works: list = []
        if self.overlap:
            for ms in self.members:
                for p in ms:
                    p.register_post_accumulate_grad_hook(self._ready)

    def arm(self) -> None:
        self.pending = [len(ms) for ms in self.members]
        self.works = [None] * len(self.members)
        self.armed = True

    def _ready(self, p) -> None:
        if not self.armed:
            return
        i, _ = self.slots[id(p)]
        self.pending[i] -= 1
        if self.pending[i] == 0:
            self._launch(i)

    def _launch(self, i: int) -> None:
        buf, off = self.bufs[i], 0
        for p in self.members[i]:
            n = p.numel()
            if p.grad is None:
                buf[off:off + n].zero_()
            else:
                buf[off:off + n].copy_(p.grad.reshape(-1))
            off += n
        self.works[i] = dist.all_reduce(buf, group=self.group, async_op=True)
        COLLECTIVES[self.labels[i]] += 1

    def finish(self) -> None:
        """Start what the backward did not, wait for every bucket, and write
        the means back into ``.grad``."""
        for i, w in enumerate(self.works):
            if w is None:
                self._launch(i)
        for i, w in enumerate(self.works):
            w.wait()
            buf = self.bufs[i].div_(self.world)
            off = 0
            for p in self.members[i]:
                n = p.numel()
                view = buf[off:off + n].view_as(p)
                if p.grad is None:
                    p.grad = view.clone()
                else:
                    p.grad.copy_(view)
                off += n
        self.armed = False
        self.works = []
