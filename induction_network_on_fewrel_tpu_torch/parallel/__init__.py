"""Data, pipeline, expert, tensor and sequence parallel over ``torch.distributed``.

Counterpart of ``induction_network_on_fewrel_tpu/parallel/`` for dp, pp,
ep, tp and sp: ``distributed`` (the process group from the launcher's
environment), ``mesh`` (the (dp, pp, ep, tp, sp) ranks), ``hostfeed``
(each rank's own episodes, the pipeline's row check), ``grad_buckets``
(the bucketed gradient all-reduce, the neighbour hop), ``sharding``
(ZeRO-1, the compact table gradient, the trainer's ``DataParallel``),
``pipeline`` (the pp executor: the GPipe schedule over the layer-stacked
transformer), ``expert`` (the MoE layers on a mesh: global routing, the
experts sharded over ep), ``tensor`` (the tp executor: the NTN slices and
the MLP blocks, Megatron-style), ``ring`` (the sp executor: ring
attention) and ``rig`` (ranks as spawned processes with a bounded wall
time, for tests and the smoke run).
"""

from induction_network_on_fewrel_tpu_torch.parallel.distributed import (
    maybe_initialize_distributed,
)
from induction_network_on_fewrel_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh", "maybe_initialize_distributed"]
