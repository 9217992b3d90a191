"""Data and expert parallel over ``torch.distributed``.

Counterpart of ``induction_network_on_fewrel_tpu/parallel/`` for dp and
ep: ``distributed`` (the process group from the launcher's environment),
``mesh`` (the (dp, ep) ranks), ``hostfeed`` (each rank's own episodes),
``grad_buckets`` (the bucketed gradient all-reduce), ``sharding`` (ZeRO-1,
the compact table gradient, the trainer's ``DataParallel``), ``expert``
(the MoE layers on a mesh: global routing, the experts sharded over ep)
and ``rig`` (ranks as spawned processes with a bounded wall time, for
tests and the smoke run). The other sharded executors (tp, sp, pp) come
with item 6d.
"""

from induction_network_on_fewrel_tpu_torch.parallel.distributed import (
    maybe_initialize_distributed,
)
from induction_network_on_fewrel_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh", "maybe_initialize_distributed"]
