"""The (dp, pp, ep, tp, sp) layout of the ranks.

Counterpart of ``induction_network_on_fewrel_tpu/parallel/mesh.py``
(``make_mesh``). There a ``jax.sharding.Mesh`` names the axes (dp, pp, ep,
tp, sp) over the devices. Here one rank is one process on one device,
numbered in the JAX axis order: rank ``(((d·pp + p)·ep + e)·tp + t)·sp + s``
is index ``d`` on the dp axis, ``p`` on pp, ``e`` on ep, ``t`` on tp and
``s`` on sp.

* ``dp``: episodes shard over the dp axis; gradients are averaged over it.
  ``Mesh.group`` is this rank's dp group, the ranks that share its pp, ep,
  tp and sp indices (the whole world when every other axis is 1): every
  gradient, ZeRO-1 chunk, metric mean and MoE routing exchange runs over it.
* ``pp``: the layer-stacked transformer's layers shard over the pp axis and
  run as the GPipe schedule (``parallel/pipeline.py``); ``Mesh.pp_group``.
* ``ep``: the experts of each MoE layer shard over the ep axis
  (``parallel/expert.py``); ``Mesh.ep_group`` (None at ep=1).
* ``tp``: the NTN's slices and the transformer's and BERT's MLP blocks
  shard over the tp axis (``parallel/tensor.py``); ``Mesh.tp_group``.
* ``sp``: the token axis shards over the sp axis and attention runs as a
  ring (``parallel/ring.py``); ``Mesh.sp_group``.

The ranks of one dp index hold the same episodes (``Mesh.rank`` is the dp
index; ``parallel/hostfeed.py`` keys the feed by it).

``Mesh.group`` is the live process group, or None for a pure layout (the
partition arithmetic of ``parallel/hostfeed.py``, tested without ranks).
A mesh with a group runs its collectives even at dp=1: world size 1 over
NCCL issues the same collectives as world size N, each a copy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``dp`` x ``pp`` x ``ep`` x ``tp`` x ``sp`` ranks; this process is
    index ``rank`` on the dp axis, ``pp_rank`` on pp, ``ep_rank`` on ep,
    ``tp_rank`` on tp and ``sp_rank`` on sp (each axis's group None at size
    1)."""

    dp: int
    rank: int = 0
    group: object = None
    ep: int = 1
    ep_rank: int = 0
    ep_group: object = None
    tp: int = 1
    tp_rank: int = 0
    tp_group: object = None
    sp: int = 1
    sp_rank: int = 0
    sp_group: object = None
    pp: int = 1
    pp_rank: int = 0
    pp_group: object = None

    @property
    def live(self) -> bool:
        """True when collectives run over a process group."""
        return self.group is not None

    @property
    def main(self) -> bool:
        """True on the one rank that writes (rank 0 of the world)."""
        return (self.rank == 0 and self.pp_rank == 0 and self.ep_rank == 0 and self.tp_rank == 0
                and self.sp_rank == 0)

    @property
    def backend(self) -> str | None:
        return dist.get_backend(self.group) if self.group is not None else None


def axis_groups(dp: int, ep: int, tp: int = 1, sp: int = 1, pp: int = 1) -> dict:
    """{axis: [(ranks, group), ...]} over ``dp·pp·ep·tp·sp`` ranks in the
    JAX axis order: the groups of an axis hold the ranks that differ in
    that index alone, one group per setting of the other indices, in rank
    order. Only dp and the axes above 1 get groups. Every rank makes every
    group, in this order (``new_group`` is collective): dp, pp, ep, tp, sp."""
    sizes = {"dp": dp, "pp": pp, "ep": ep, "tp": tp, "sp": sp}
    grid = np.arange(dp * pp * ep * tp * sp).reshape(dp, pp, ep, tp, sp)
    out = {}
    for i, (ax, n) in enumerate(sizes.items()):
        if ax == "dp" or n > 1:
            rows = np.moveaxis(grid, i, -1).reshape(-1, n).tolist()
            out[ax] = [(row, dist.new_group(row)) for row in rows]
    return out


def mesh_index(rank: int, ep: int, tp: int, sp: int, pp: int = 1) -> tuple:
    """(d, p, e, t, s) of world ``rank``: rank = (((d·pp + p)·ep + e)·tp + t)·sp + s."""
    rest, s = divmod(rank, sp)
    rest, t = divmod(rest, tp)
    rest, e = divmod(rest, ep)
    d, p = divmod(rest, pp)
    return d, p, e, t, s


def make_mesh(dp: int | None = None, tp: int = 1, sp: int = 1, pp: int = 1, ep: int = 1,
              world_size: int | None = None) -> Mesh:
    """The (dp, pp, ep, tp, sp) mesh over this process's group (``dp=None``
    -> the rest of the world). ``world_size`` makes a pure layout of that
    many ranks (no group, rank 0). The JAX validation: more ranks asked for
    than there are raises."""
    group = None
    rank = 0
    if world_size is None:
        if dist.is_initialized():
            group, rank, n = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
        else:
            n = 1
    else:
        n = int(world_size)
    other = tp * sp * pp * ep
    if dp is None:
        if n % other != 0:
            raise ValueError(f"{n} devices not divisible by pp*ep*tp*sp={other}")
        dp = n // other
    if dp * other > n:
        raise ValueError(f"dp*pp*ep*tp*sp={dp * other} exceeds {n} available devices")
    if group is not None and dp * other < n:
        raise ValueError(
            f"dp*pp*ep*tp*sp={dp * other} leaves {n - dp * other} of the {n} ranks without "
            f"a shard: launch {dp * other} ranks (torchrun --nproc_per_node {dp * other}) or "
            "pass --dp 0 (the whole world)")
    dp, pp, ep, tp, sp = int(dp), int(pp), int(ep), int(tp), int(sp)
    if group is None or pp == ep == tp == sp == 1:
        return Mesh(dp=dp, rank=rank, group=group, ep=ep, tp=tp, sp=sp, pp=pp)
    of = {ax: next(g for ranks, g in groups if rank in ranks)
          for ax, groups in axis_groups(dp, ep, tp, sp, pp).items()}
    d, p, e, t, s = mesh_index(rank, ep, tp, sp, pp)
    return Mesh(dp=dp, rank=d, group=of["dp"], ep=ep, ep_rank=e, ep_group=of.get("ep"),
                tp=tp, tp_rank=t, tp_group=of.get("tp"), sp=sp, sp_rank=s,
                sp_group=of.get("sp"), pp=pp, pp_rank=p, pp_group=of.get("pp"))
