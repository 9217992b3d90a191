"""The (dp, ep) layout of the ranks.

Counterpart of ``induction_network_on_fewrel_tpu/parallel/mesh.py``
(``make_mesh``) for the dp and ep axes. There a ``jax.sharding.Mesh``
names the axes (dp, pp, ep, tp, sp) over the devices. Here one rank is
one process on one device, numbered in the JAX axis order: rank ``d·ep +
e`` is index ``d`` on the dp axis and ``e`` on the ep axis.

* ``dp``: episodes shard over the dp axis; gradients are averaged over it.
  ``Mesh.group`` is this rank's dp group, the ranks that share its ep index
  (the whole world at ep=1): every gradient, ZeRO-1 chunk, metric mean and
  MoE routing exchange runs over it.
* ``ep``: the experts of each MoE layer shard over the ep axis
  (``parallel/expert.py``); the ranks of one ep group hold the same
  episodes. ``Mesh.ep_group`` is this rank's ep group (None at ep=1).

The other axes (``--tp``, ``--sp``, ``--pp`` above 1) are refused by name;
they come with ROADMAP queue A item 6d.

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
    """``dp`` x ``ep`` ranks; this process is index ``rank`` on the dp axis
    and ``ep_rank`` on the ep axis."""

    dp: int
    rank: int = 0
    group: object = None
    ep: int = 1
    ep_rank: int = 0
    ep_group: object = None

    @property
    def live(self) -> bool:
        """True when collectives run over a process group."""
        return self.group is not None

    @property
    def main(self) -> bool:
        """True on the one rank that writes (rank 0 of the world)."""
        return self.rank == 0 and self.ep_rank == 0

    @property
    def backend(self) -> str | None:
        return dist.get_backend(self.group) if self.group is not None else None


def axis_groups(dp: int, ep: int) -> tuple[list, list]:
    """(dp groups, ep groups) over ``dp * ep`` ranks in the JAX axis order:
    dp group ``e`` holds ranks ``d·ep + e`` for every d, ep group ``d`` the
    ranks ``d·ep + e`` for every e. Every rank makes every group, in this
    order (``new_group`` is collective)."""
    dp_groups = [dist.new_group([d * ep + e for d in range(dp)]) for e in range(ep)]
    ep_groups = [dist.new_group([d * ep + e for e in range(ep)]) for d in range(dp)]
    return dp_groups, ep_groups


def make_mesh(dp: int | None = None, tp: int = 1, sp: int = 1, pp: int = 1, ep: int = 1,
              world_size: int | None = None) -> Mesh:
    """The (dp, ep) mesh over this process's group (``dp=None`` -> the rest
    of the world). ``world_size`` makes a pure layout of that many ranks (no
    group, rank 0). The JAX validation: more ranks asked for than there are
    raises; so do tp, sp and pp above 1, by name."""
    for flag, n in (("--tp", tp), ("--sp", sp), ("--pp", pp)):
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
    if group is None or ep == 1:
        return Mesh(dp=int(dp), rank=rank, group=group, ep=int(ep))
    dp_groups, ep_groups = axis_groups(int(dp), int(ep))
    d, e = divmod(rank, ep)
    return Mesh(dp=int(dp), rank=d, group=dp_groups[e], ep=int(ep), ep_rank=e,
                ep_group=ep_groups[d])
