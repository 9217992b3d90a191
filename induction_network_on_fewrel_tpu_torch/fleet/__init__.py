"""Fleet tier: multi-replica serving router + control plane.

The port of the JAX package's ``fleet/``: host code only, copied with the
same names, wire format and journal format, so a JAX client talks to a
port ``ReplicaServer`` and each package replays the other's WAL. Every
replica is an ``InferenceEngine`` of the port (CUDA-graph query path on
the GPU); N in-process replicas share one card.

* ``placement``  — deterministic rendezvous tenant->replica placement
  with replica health states (bounded remap on membership changes).
* ``router``     — the submit front door: placement resolution, fleet-
  level shed fairness, TraceContext propagation across the hop,
  failover to degraded NOTA verdicts, per-replica circuit breaker as
  the health feed. ``InProcessReplica`` is the in-process transport.
* ``control``    — tenant lifecycle routed to owners + the
  all-or-nothing fan-out publish over the registry's two-phase
  prepare/commit (any replica's refusal rolls the whole fleet back).
* ``transport``  — the same ``ReplicaHandle`` interface over JSON-lines
  sockets for real multi-process replicas (per-call deadlines, bounded
  idempotent retry, net.* chaos points).
* ``journal``    — the write-ahead log of every control-plane op:
  CRC-framed records, torn-tail truncation, snapshot
  compaction, deterministic replay; ``FleetRouter.recover(journal)``
  rebuilds the directory bitwise after a crash.
* ``supervisor`` — replica supervision: health probes, restart with
  exponential backoff + deterministic jitter, bounded budget degrading
  to permanent-dead, re-registration + params catch-up on restart.
* ``autoscaler`` — the elasticity policy loop: target-band
  occupancy/shed/burn signals with hysteresis + cool-down driving
  journaled scale-out (spawn -> catch-up -> pre-warm -> join) and
  drain-in (drain -> wait-for-inflight -> replace -> retire).
* ``standby``    — the WAL-tailing hot standby: read-only
  incremental replay of the primary's journal, single-writer lease
  fencing zombie primaries, seconds-scale promotion with tenants
  served degraded-NOTA (never dropped) during the window.
"""

from induction_network_on_fewrel_tpu_torch.fleet.autoscaler import (
    FleetAutoscaler,
)
from induction_network_on_fewrel_tpu_torch.fleet.control import (
    FleetControl,
    FleetPublishError,
)
from induction_network_on_fewrel_tpu_torch.fleet.journal import (
    FleetJournal,
    JournalError,
    JournalLease,
    JournalState,
    JournalTailer,
)
from induction_network_on_fewrel_tpu_torch.fleet.standby import (
    HotStandby,
)
from induction_network_on_fewrel_tpu_torch.fleet.placement import (
    DEAD,
    DRAINING,
    UP,
    FleetPlacement,
    placement_score,
)
from induction_network_on_fewrel_tpu_torch.fleet.router import (
    FleetRouter,
    InProcessReplica,
    ReplicaHandle,
)
from induction_network_on_fewrel_tpu_torch.fleet.supervisor import (
    ReplicaSupervisor,
)

__all__ = [
    "DEAD",
    "DRAINING",
    "UP",
    "FleetAutoscaler",
    "FleetControl",
    "FleetJournal",
    "FleetPlacement",
    "FleetPublishError",
    "FleetRouter",
    "HotStandby",
    "InProcessReplica",
    "JournalError",
    "JournalLease",
    "JournalState",
    "JournalTailer",
    "ReplicaHandle",
    "ReplicaSupervisor",
    "placement_score",
]
