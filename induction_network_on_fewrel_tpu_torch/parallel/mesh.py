"""The data-parallel layout of the ranks.

Counterpart of ``induction_network_on_fewrel_tpu/parallel/mesh.py``
(``make_mesh``), dp only. There a ``jax.sharding.Mesh`` names the axes
(dp, pp, ep, tp, sp) over the devices. Here one rank is one process on
one device, and the mesh is the ``dp`` ranks of a ``torch.distributed``
group: episodes shard over them and gradients are averaged over them.
The other axes (``--tp``, ``--sp``, ``--pp``, ``--ep`` above 1) are
refused by name; they come with ROADMAP queue A item 6d.

``Mesh.group`` is the live process group, or None for a pure layout (the
partition arithmetic of ``parallel/hostfeed.py``, tested without ranks).
A mesh with a group runs its collectives even at dp=1: world size 1 over
NCCL issues the same collectives as world size N, each a copy.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

from induction_network_on_fewrel_tpu_torch.models.build import LATER_SLICE, SHARDED


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``dp`` ranks; this process is ``rank`` of them."""

    dp: int
    rank: int = 0
    group: object = None

    @property
    def live(self) -> bool:
        """True when collectives run over a process group."""
        return self.group is not None

    @property
    def backend(self) -> str | None:
        return dist.get_backend(self.group) if self.group is not None else None


def make_mesh(dp: int | None = None, tp: int = 1, sp: int = 1, pp: int = 1, ep: int = 1,
              world_size: int | None = None) -> Mesh:
    """The dp mesh over this process's group (``dp=None`` -> the whole
    world). ``world_size`` makes a pure layout of that many ranks (no
    group, rank 0). The JAX validation: more ranks asked for than there
    are raises; so do axes other than dp above 1, by name."""
    for flag, n in (("--tp", tp), ("--sp", sp), ("--pp", pp), ("--ep", ep)):
        if n > 1:
            raise ValueError(f"{flag} {n} is not ported yet: it comes with "
                             f"{LATER_SLICE.get(flag[2:], SHARDED)}")
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
    return Mesh(dp=int(dp), rank=rank, group=group)
