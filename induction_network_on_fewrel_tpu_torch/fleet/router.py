"""Fleet router: one submit front door over N engine replicas.

The router is the data plane of the fleet tier. Per submit it:

1. resolves the tenant's owning replica through the deterministic
   rendezvous placement (fleet/placement.py) — no placement table, no
   coordination; every router instance computes the same owner;
2. enforces **fleet-level shed-load fairness** on top of per-replica
   backpressure: a tenant over its fleet-wide in-flight share sheds at
   the router door (``Saturated(tenant=...)``) before touching any
   replica queue — one hot tenant cannot monopolize the fleet's combined
   admission capacity even when its owner replica still has room;
3. propagates a ``TraceContext`` across the hop: the router's head
   sampler mints the context, opens the ``fleet/route`` span, and hands
   the SAME context to the replica's submit path — the replica-side
   queue/pack/execute/respond segments join the router's trace id, so a
   fleet waterfall reads end to end;
4. **fails over**: a replica marked dead (its per-replica circuit
   breaker — the existing serving/breaker.CircuitBreaker keyed by
   replica id — opening on consecutive launch failures, or the
   ``fleet.replica_kill`` chaos point) drops out of placement; its
   tenants' traffic gets immediate degraded-mode NOTA verdicts (the
   honest "I cannot place this" answer, zero device time) until the
   control plane re-places them onto their new rendezvous owners
   (fleet/control.FleetControl.replace_tenants).

Replica transports: ``InProcessReplica`` wraps an ``InferenceEngine`` in
this process (one card, or CPU tests); ``fleet/transport.py`` puts the SAME
``ReplicaHandle`` interface over a JSON-lines socket for real
multi-process runs. The router is transport-agnostic by construction.

Telemetry: ``kind="fleet"`` records (utils/metrics.KNOWN_KINDS schema
doc) — one aggregate record per emit, one per-replica record (``replica``
str field) restating that replica's serving counters, and event records
(``event="fanout_publish"`` / ``"replica_dead"`` / ``"replace"`` ...)
for control-plane actions. Replica-death containment also emits
``kind="fault"`` ``action="replica_dead"`` records, which the health
watchdog latches as once-per-replica CRITICALs (re-armed by recovery).
``kind="hop"`` records — one per SAMPLED routed request
with router-side segments (route/queue/wire/remote/respond) tiling the
fleet-level latency exactly (see ``_emit_hop``) — and the labeled-gauge
fleet rollup (``bind_registry``): per-replica qps/occupancy/percentile/
breaker gauges in one metrics.prom scrape.
"""

from __future__ import annotations

import json
import threading
import time
from concurrent.futures import Future

from induction_network_on_fewrel_tpu_torch.obs.chaos import (
    chaos_active,
    chaos_fire,
)
from induction_network_on_fewrel_tpu_torch.obs.spans import TraceSampler, get_tracker
from induction_network_on_fewrel_tpu_torch.fleet.placement import (
    DEAD,
    DRAINING,
    UP,
    FleetPlacement,
)
from induction_network_on_fewrel_tpu_torch.serving.batcher import Saturated
from induction_network_on_fewrel_tpu_torch.serving.geometry import (
    DEFAULT_TIERS,
    tier_for,
)


class ReplicaHandle:
    """The transport-agnostic replica interface the router and control
    plane speak. ``InProcessReplica`` (below) backs it with an engine in
    this process; ``fleet/transport.SocketReplica`` backs it with a
    JSON-lines socket to another process. Every method is synchronous
    except ``submit``, which returns a Future."""

    replica_id: str

    # data plane
    def submit(self, instance, deadline_s=None, tenant="default",
               trace=None) -> Future:
        raise NotImplementedError

    # control plane
    def register_dataset(self, dataset, tenant, max_classes=None):
        raise NotImplementedError

    def has_tenant(self, tenant) -> bool:
        raise NotImplementedError

    def set_nota_threshold(self, threshold, tenant):
        raise NotImplementedError

    def quarantine_tenant(self, tenant, reason=""):
        raise NotImplementedError

    def unquarantine_tenant(self, tenant, reason=""):
        raise NotImplementedError

    def drop_tenant(self, tenant):
        raise NotImplementedError

    # two-phase publish (fleet fan-out; target_version = the recovery
    # catch-up spelling, pinning the generation the commit lands at)
    def prepare_publish(self, params=None, ckpt_dir=None,
                        target_version=None):
        raise NotImplementedError

    def commit_publish(self, txn) -> int:
        raise NotImplementedError

    def abort_publish(self, txn) -> None:
        raise NotImplementedError

    # observability / lifecycle
    def ping(self) -> bool:
        """Cheap liveness probe (the supervisor's health loop). The
        transport raises (ConnectionError/TransportTimeout) when the
        peer is gone or wedged; an in-process replica is alive by
        construction."""
        return True

    @property
    def clock_offset_s(self) -> float:
        """Estimated (replica clock − router clock) in seconds — 0.0
        for an in-process replica (one clock, by construction). The
        socket transport estimates it per connection via the NTP-style
        handshake (fleet/transport.ClockSync); the router
        stamps it on ``kind="hop"`` records as ``offset_ms``."""
        return 0.0

    @property
    def params_version(self) -> int:
        raise NotImplementedError

    def stats_snapshot(self) -> dict:
        raise NotImplementedError

    def warmup(self) -> int:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class InProcessReplica(ReplicaHandle):
    """One engine replica in this process — the in-process transport.
    The engine keeps its own batcher worker, breaker, stats, and
    registry; the handle only adapts the interface."""

    def __init__(self, replica_id: str, engine):
        self.replica_id = str(replica_id)
        self.engine = engine

    def submit(self, instance, deadline_s=None, tenant="default",
               trace=None) -> Future:
        return self.engine.submit(
            instance, deadline_s, tenant=tenant, trace=trace
        )

    def register_dataset(self, dataset, tenant, max_classes=None):
        return self.engine.register_dataset(
            dataset, max_classes=max_classes, tenant=tenant
        )

    def has_tenant(self, tenant) -> bool:
        return self.engine.registry.has_tenant(tenant)

    def set_nota_threshold(self, threshold, tenant):
        self.engine.set_nota_threshold(threshold, tenant=tenant)

    def quarantine_tenant(self, tenant, reason=""):
        self.engine.quarantine_tenant(tenant, reason=reason)

    def unquarantine_tenant(self, tenant, reason=""):
        self.engine.unquarantine_tenant(tenant, reason=reason)

    def drop_tenant(self, tenant):
        self.engine.registry.drop_tenant(tenant)

    def prepare_publish(self, params=None, ckpt_dir=None,
                        target_version=None):
        if params is None:
            if ckpt_dir is None:
                raise ValueError("prepare_publish needs params or ckpt_dir")
            from induction_network_on_fewrel_tpu_torch.serving.registry import (
                load_params,
            )

            params = load_params(ckpt_dir)
        return self.engine.prepare_publish(
            params, target_version=target_version
        )

    def commit_publish(self, txn) -> int:
        return self.engine.commit_publish(txn)

    def abort_publish(self, txn) -> None:
        txn.abort()

    @property
    def params_version(self) -> int:
        return self.engine.registry.params_version

    def stats_snapshot(self) -> dict:
        return self.engine.stats.snapshot(
            queue_depth=self.engine.batcher.queue_depth
        )

    def warmup(self) -> int:
        return self.engine.warmup()

    def close(self) -> None:
        self.engine.close()


def drive_tenant_state(handle, tenant: str, entry: "_TenantEntry",
                       reason: str) -> None:
    """ONE home for making a replica serve-ready for one directory
    tenant: register the support source, then carry the NOTA threshold
    and quarantine flag. Shared by failover re-placement
    (control.replace_tenants), cold-start recovery (router.recover),
    and supervised restart (supervisor._adopt) — three hand-mirrored
    copies of this block had already started to drift."""
    handle.register_dataset(
        entry.source, tenant, max_classes=entry.max_classes
    )
    if entry.nota_threshold is not None:
        handle.set_nota_threshold(entry.nota_threshold, tenant)
    if entry.quarantined:
        handle.quarantine_tenant(tenant, reason=reason)


class _TenantEntry:
    """The router's per-tenant directory row: where the tenant is
    REGISTERED (vs where placement currently points — a mismatch is a
    pending re-placement served degraded), plus everything needed to
    re-register it on a new owner after failover: the support source,
    the NOTA threshold, the quarantine flag."""

    __slots__ = ("owner", "source", "max_classes", "nota_threshold",
                 "quarantined")

    def __init__(self, owner, source, max_classes=None):
        self.owner = owner
        self.source = source
        self.max_classes = max_classes
        self.nota_threshold = None
        self.quarantined = False


class FleetRouter:
    """Submit front door + replica health + the fleet tenant directory.

    ``fleet_share`` bounds one tenant's fleet-wide IN-FLIGHT requests to
    that fraction of the fleet's combined queue capacity (sum of replica
    ``max_queue_depth``). Like the per-replica tenant share it binds
    only once a second tenant has submitted — a single-tenant fleet
    keeps full capacity.

    ``resident_budget_bytes``: per-replica budget for
    resident class-vector bytes. Placement capacity is derived from
    BYTES, not tenant count — an int8 tenant is ~4x cheaper than its
    f32 twin, so the same replica holds ~4x the tenants. ``None``
    (default) keeps the pre-quantization behavior: unbounded residency,
    queue depth is the only capacity signal.

    ``tier_spread``: N-tier-weighted rendezvous placement.
    When > 0, each tier's tenants concentrate onto that many "home"
    replicas (placement module doc) so no replica warms every tier's
    program family; ``tiers`` is the ladder tenant class counts map
    through (must match the replicas' engine ladder — serve.py wires
    both from the same resolved policy). 0 (default) = tier-blind.
    """

    def __init__(
        self,
        replicas: dict[str, ReplicaHandle],
        logger=None,
        breaker=None,
        fleet_share: float = 0.5,
        trace_sample: float = 0.0,
        queue_capacity_per_replica: int = 64,
        resident_budget_bytes: float | None = None,
        tier_spread: int = 0,
        tiers: tuple[int, ...] | None = DEFAULT_TIERS,
    ):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        if resident_budget_bytes is not None and resident_budget_bytes <= 0:
            raise ValueError(
                f"resident_budget_bytes must be positive, got "
                f"{resident_budget_bytes}"
            )
        self.replicas: dict[str, ReplicaHandle] = dict(replicas)
        self.placement = FleetPlacement(self.replicas)
        self._logger = logger
        self._tracer = TraceSampler(trace_sample)
        self.fleet_share = fleet_share
        self._capacity_per_replica = queue_capacity_per_replica
        self.resident_budget_bytes = resident_budget_bytes
        if tier_spread < 0:
            raise ValueError(
                f"tier_spread must be >= 0, got {tier_spread}"
            )
        self.tier_spread = tier_spread
        self.tiers = tuple(tiers) if tiers else None
        # Per-replica circuit breaker: serving/breaker.CircuitBreaker
        # keyed by REPLICA id — consecutive forwarded-launch failures
        # open it, the open transition marks the replica dead in
        # placement, a later closed
        # transition marks it back up.
        self.breaker = breaker
        if breaker is not None:
            breaker.on_transition = self._on_breaker_transition
        self._lock = threading.Lock()
        self.directory: dict[str, _TenantEntry] = {}
        self._inflight: dict[str, int] = {}
        self._seen: set[str] = set()
        # Counters (all under _lock).
        self.submitted = 0
        self.routed: dict[str, int] = {r: 0 for r in self.replicas}
        self.degraded_served = 0      # failover NOTA verdicts from HERE
        self.shed = 0                 # fleet-share sheds at the door
        self.replica_deaths = 0
        self.replaced = 0             # tenants re-registered after a
        #                               membership/health change (churn)
        self._emit_step = 0
        # Fleet rollup state: per-replica (time, served) at
        # the last emit, for the qps column; registry families when
        # bind_registry() was called (default unbound — no new work on
        # the emit path).
        self._t0 = time.monotonic()
        self._prev_emit: dict[str, tuple[float, float]] = {}
        self._families: dict[str, object] = {}
        self._bound_registry = None
        self._bound_fns: list[tuple[str, object]] = []

    # --- capacity / fairness ----------------------------------------------

    def _fleet_capacity(self) -> int:
        n_live = max(1, len(self.placement.live()))
        return n_live * self._capacity_per_replica

    def _tenant_cap(self) -> int:
        return max(1, int(self._fleet_capacity() * self.fleet_share))

    def replica_resident_bytes(self, rid: str) -> float:
        """Bytes of resident class vectors on one replica (0.0 when the
        replica is dead or predates the resident_bytes gauge)."""
        try:
            snap = self.replicas[rid].stats_snapshot()
        except Exception:  # noqa: BLE001 — dead replica: no residency
            return 0.0
        return float(snap.get("resident_bytes", 0.0))

    # --- N-tier-weighted placement ------------------------------

    def tier_of_source(self, source, max_classes=None) -> int | None:
        """The N-tier a tenant's support source lands on, or None when
        tier-weighted placement is off / the source is unknown (a
        params-only recovery entry places tier-blind — correct, just
        unweighted for that tenant)."""
        if self.tier_spread <= 0 or source is None:
            return None
        n = len(source.rel_names)
        if max_classes is not None:
            n = min(n, int(max_classes))
        return tier_for(n, self.tiers)

    def place_tenant(self, tenant: str, entry=None) -> str | None:
        """ONE placement spelling for every router/control call site:
        rendezvous with the tenant's N-tier weight when the directory
        (or the caller-supplied ``entry``) knows its source. Register,
        submit, failover, and recovery MUST all resolve through the
        same function — two sites disagreeing on the tier weight would
        read as a permanent pending re-placement."""
        if entry is None:
            entry = self.directory.get(tenant)
        tier = (
            self.tier_of_source(entry.source, entry.max_classes)
            if entry is not None else None
        )
        return self.placement.place(
            tenant, tier=tier, tier_spread=self.tier_spread
        )

    # --- data plane -------------------------------------------------------

    def submit(self, instance, deadline_s=None, tenant="default") -> Future:
        """Route one query to its owning replica. Raises ``ValueError``
        for unregistered tenants, ``Saturated`` at the fleet-share bound
        or with no live replica; returns the replica's Future (or an
        immediately-resolved degraded verdict during failover)."""
        entry = self.directory.get(tenant)
        if entry is None:
            raise ValueError(
                f"unknown tenant {tenant!r} — register it through the "
                f"fleet control plane first"
            )
        if chaos_active():
            owner_now = entry.owner
            if owner_now is not None and chaos_fire(
                "fleet.replica_kill", replica=owner_now,
                step=self.submitted,
            ) is not None:
                self.mark_replica_dead(owner_now, reason="chaos")
        target = self.place_tenant(tenant, entry)
        if target is None:
            raise Saturated(1.0)   # no live replica: back off, retry
        with self._lock:
            self.submitted += 1
            self._seen.add(tenant)
            if (len(self._seen) > 1
                    and self._inflight.get(tenant, 0) >= self._tenant_cap()):
                self.shed += 1
                raise Saturated(0.05, tenant=tenant)
            # RESERVE the in-flight slot under the SAME lock as the cap
            # check — check-then-act across two lock sections would let
            # N concurrent submitters all pass the check at cap-1 and
            # overshoot the share by the caller concurrency. Every exit
            # below that does not hand back a replica future releases
            # the reservation.
            self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
        reserved = True
        probe = False
        try:
            if entry.owner != target:
                if self._admit_recovery_probe(entry.owner):
                    probe = True
                    # The owner's breaker OPEN window elapsed: route THIS
                    # request to it as the half-open recovery probe instead
                    # of a degraded verdict. Success closes the breaker,
                    # whose closed transition revives the replica in
                    # placement — a transient-failure replica heals itself
                    # without operator re-placement; failure re-opens the
                    # window and the next requests go back to degraded.
                    target = entry.owner
                elif (entry.owner in self.replicas
                      and self.placement.state(entry.owner)
                      not in (None, DEAD)):
                    # A MEMBERSHIP change (replica add / drain) moved
                    # the tenant's rendezvous placement while its
                    # registered owner is still alive and holds the
                    # support set: keep serving CORRECT verdicts from
                    # the registration until control.replace_tenants()
                    # moves it. Degraded NOTA is reserved for a dead
                    # owner — the case with nothing left to ask.
                    target = entry.owner
                else:
                    # Pending re-placement with the owner DEAD (or
                    # removed): honest degraded NOTA, zero device time,
                    # until control.replace_tenants() re-registers.
                    return self._degraded_future(tenant)
            trace = self._tracer.maybe_trace()
            handle = self.replicas[target]
            hop = None
            try:
                if trace is not None:
                    # Hop tiling stamps: t0 at mint, t1 once
                    # the fleet/route span is open (route_ms = span +
                    # placement bookkeeping), t2 once handle.submit
                    # returned (queue_ms = local enqueue: the socket
                    # transport's pool hand-off or the engine's
                    # admission). The done callback adds t3/t4 and
                    # splits t3−t2 into wire_ms + remote_ms using the
                    # replica-reported total (_emit_hop). Stamps exist
                    # ONLY on the sampled path — rate 0 stays
                    # allocation-free.
                    t0 = time.monotonic()
                    tracker = get_tracker()
                    with tracker.trace(trace):
                        with tracker.span("fleet/route", xplane=False,
                                          tenant=tenant, replica=target):
                            t1 = time.monotonic()
                            fut = handle.submit(
                                instance, deadline_s, tenant=tenant,
                                trace=trace,
                            )
                    hop = (trace, t0, t1, time.monotonic())
                else:
                    fut = handle.submit(instance, deadline_s, tenant=tenant)
            except Saturated:
                # Per-replica backpressure re-raises as-is — EXCEPT on
                # an admitted recovery probe, whose slot MUST record an
                # outcome or the breaker wedges half-open with no path
                # back. A saturated replica answered, but "queue full"
                # is not probe success: record failure (re-opens the
                # window; the next window probes again).
                if probe and self.breaker is not None:
                    self.breaker.record_failure(target)
                raise
            except BaseException:
                # A transport/submit failure (socket down, closed batcher)
                # counts against the replica's breaker — enough of them
                # opens it and placement routes around. Same owner guard
                # as _on_done: a straggler that read the OLD owner just
                # before replace_tenants() flipped it (the replica then
                # refuses the dropped tenant synchronously) must not
                # count against the healthy replica — except a probe,
                # whose consumed slot must always record.
                if self.breaker is not None and (
                        probe or entry.owner == target):
                    self.breaker.record_failure(target)
                raise
            with self._lock:
                self.routed[target] = self.routed.get(target, 0) + 1
            # Hand the reservation to the done callback BEFORE attaching
            # it — an already-resolved future fires the callback
            # synchronously, and the finally below must not release a
            # second time.
            reserved = False
            fut.add_done_callback(
                lambda f, t=tenant, r=target, p=probe, h=hop:
                    self._on_done(f, t, r, probe=p, hop=h)
            )
            return fut
        finally:
            if reserved:
                self._release_inflight(tenant)

    def classify(self, instance, deadline_s=None, tenant="default") -> dict:
        fut = self.submit(instance, deadline_s, tenant=tenant)
        return fut.result(timeout=(deadline_s or 30.0) + 30.0)

    def _release_inflight(self, tenant: str) -> None:
        with self._lock:
            n = self._inflight.get(tenant, 1) - 1
            if n <= 0:
                self._inflight.pop(tenant, None)
            else:
                self._inflight[tenant] = n

    def _on_done(self, fut: Future, tenant: str, replica: str,
                 probe: bool = False, hop=None) -> None:
        self._release_inflight(tenant)
        if hop is not None:
            self._emit_hop(fut, tenant, replica, hop)
        if self.breaker is None:
            return
        exc = fut.exception()
        if exc is None:
            self.breaker.record_success(replica)
            return
        if probe:
            # An admitted half-open probe consumed the breaker's single
            # probe slot — EVERY failed outcome (deadline miss included)
            # must be recorded, else the breaker wedges half-open
            # forever and the replica can never be probed again.
            self.breaker.record_failure(replica)
            return
        from induction_network_on_fewrel_tpu_torch.serving.batcher import (
            DeadlineExceeded,
            ExecuteError,
            TransportTimeout,
        )

        # ExecuteError = the replica's launch failed; OSError (incl.
        # ConnectionError from a dead SocketReplica process — raised
        # in the transport's pool thread, so it surfaces HERE via
        # the future, never via submit's synchronous except) = the
        # replica itself is unreachable. Both count. Deadline
        # misses and Saturated do not — they are load, not health.
        # DeadlineExceeded needs saying EXPLICITLY: TimeoutError IS an
        # OSError subclass, so without the carve-out a loaded replica
        # expiring requests would read as replica death and cascade a
        # false failover. TransportTimeout is the one
        # deadline that DOES count — a wedged peer answering nothing
        # within the per-call deadline is health, not load.
        if isinstance(exc, DeadlineExceeded) \
                and not isinstance(exc, TransportTimeout):
            return
        if isinstance(exc, (ExecuteError, OSError)):
            # Attribute the failure only while ``replica`` is still
            # the tenant's REGISTERED owner: after replace_tenants()
            # flips the registration, requests still queued on the
            # old (healthy) replica fail typed-retryable when its
            # tenant state is dropped — those stragglers must not
            # open the old replica's breaker and cascade a false
            # replica death.
            entry = self.directory.get(tenant)
            if entry is not None and entry.owner == replica:
                self.breaker.record_failure(replica)

    def _emit_hop(self, fut: Future, tenant: str, replica: str,
                  hop: tuple) -> None:
        """One ``kind="hop"`` record per SAMPLED routed request: router-side segments that tile the measured
        fleet-level latency EXACTLY — every ``*_ms`` comes off the same
        monotonic stamps — with
        ``hop_ms = router_ms − remote_ms``: what the fleet hop added on
        top of the replica's own measured total. ``remote_ms`` is the
        replica's verdict ``latency_ms`` (two DURATIONS subtract with
        no clock alignment needed), clamped into [0, t3−t2] so a
        replica whose reported total exceeds the observed round-trip
        (clock step mid-request) cannot drive ``wire_ms`` negative.
        ``offset_ms`` is the transport's clock-offset estimate, for
        aligning replica-side ABSOLUTE timestamps in
        tools/fleet_report.py. Failed futures emit nothing — their
        story is the fault/breaker records."""
        if self._logger is None or fut.cancelled() \
                or fut.exception() is not None:
            return
        trace, t0, t1, t2 = hop
        verdict = fut.result()
        if not isinstance(verdict, dict):
            return
        t3 = time.monotonic()
        lat = verdict.get("latency_ms")
        remote_s = (
            min(max(float(lat) / 1e3, 0.0), max(t3 - t2, 0.0))
            if isinstance(lat, (int, float)) else 0.0
        )
        offset_s = float(
            getattr(self.replicas.get(replica), "clock_offset_s", 0.0)
            or 0.0
        )
        t4 = time.monotonic()
        self._logger.log(
            self.submitted, kind="hop",
            trace_id=trace.trace_id, tenant=tenant, replica=replica,
            route_ms=round((t1 - t0) * 1e3, 3),
            queue_ms=round((t2 - t1) * 1e3, 3),
            wire_ms=round((t3 - t2 - remote_s) * 1e3, 3),
            remote_ms=round(remote_s * 1e3, 3),
            respond_ms=round((t4 - t3) * 1e3, 3),
            router_ms=round((t4 - t0) * 1e3, 3),
            hop_ms=round((t4 - t0 - remote_s) * 1e3, 3),
            offset_ms=round(offset_s * 1e3, 3),
        )

    def _degraded_future(self, tenant: str) -> Future:
        """An immediately-resolved degraded NOTA verdict — the fleet's
        failover answer while the tenant awaits re-placement. The shape
        is serving/engine.degraded_verdict (ONE home with the engine's
        quarantine path); ``failover=True`` lets clients (and the
        quality stream, which excludes degraded verdicts) tell
        router-side failover from a replica-side quarantine."""
        from induction_network_on_fewrel_tpu_torch.serving.engine import (
            degraded_verdict,
        )

        fut: Future = Future()
        fut.set_result(degraded_verdict(tenant, failover=True))
        with self._lock:
            self.degraded_served += 1
        return fut

    # --- replica health ---------------------------------------------------

    def _admit_recovery_probe(self, replica: str | None) -> bool:
        """True when ``replica`` is a breaker-opened DEAD replica whose
        open window has elapsed and the breaker admits a half-open
        probe. Chaos/operator-killed replicas (breaker still closed)
        never probe — their recovery path is revive + re-placement, and
        auto-routing traffic back would defeat the kill drill's
        semantics."""
        if (self.breaker is None or replica is None
                or replica not in self.replicas
                or self.placement.state(replica) != DEAD):
            return False
        from induction_network_on_fewrel_tpu_torch.serving.breaker import (
            CLOSED as BRK_CLOSED,
        )

        if self.breaker.state(replica) == BRK_CLOSED:
            return False
        return self.breaker.admit(replica) is None

    def _on_breaker_transition(self, replica, frm, to, failures, now):
        """The per-replica breaker IS the health feed: open -> dead
        (placement routes around, tenants fail over), closed -> up.
        Also mirrored as kind='fault' action='breaker' records so the
        existing watchdog latch (breaker_open, keyed by the 'tenant'
        field = replica id here) applies unchanged."""
        if self._logger is not None:
            self._logger.log(
                self.submitted, kind="fault", action="breaker",
                tenant=f"replica:{replica}", **{"from": frm, "to": to},
                failures=float(failures),
            )
        if to == "open":
            self.mark_replica_dead(
                replica, reason=f"breaker open after {failures} failures"
            )
        elif to == "closed" and self.placement.state(replica) == DEAD:
            self.revive_replica(replica, reason="breaker closed")

    def mark_replica_dead(self, replica: str, reason: str = "") -> None:
        if self.placement.state(replica) == DEAD:
            return
        self.placement.set_state(replica, DEAD)
        with self._lock:
            self.replica_deaths += 1
            affected = sum(
                1 for e in self.directory.values() if e.owner == replica
            )
        if self._logger is not None:
            self._logger.log(
                self.submitted, kind="fault", action="replica_dead",
                replica=replica, reason=reason or "operator",
                tenants=float(affected),
            )

    def revive_replica(self, replica: str, reason: str = "") -> None:
        if self.placement.state(replica) == UP:
            return
        self.placement.set_state(replica, UP)
        # Stale-params check: a replica that missed a fan-out publish
        # while dead (control._publish_targets excludes DEAD replicas)
        # re-enters placement at an OLD generation — surfaced LOUDLY
        # here at revive time, not silently discovered at the next
        # fan-out's version-skew record. The control plane holds no
        # params to auto-re-publish with (RUNBOOK §18: revive →
        # re-publish is the operator recipe); this record is the
        # enforcement hook.
        if self._logger is not None:
            try:
                mine = self.replicas[replica].params_version
                peers = [
                    h.params_version
                    for rid, h in self.replicas.items()
                    if rid != replica and self.placement.state(rid) == UP
                ]
            except Exception:  # noqa: BLE001 — an unreachable peer
                mine, peers = None, []
            if mine is not None and peers and mine < max(peers):
                self._logger.log(
                    self.submitted, kind="fault",
                    action="replica_stale_params", replica=replica,
                    params_version=float(mine),
                    fleet_version=float(max(peers)),
                )
            self._logger.log(
                self.submitted, kind="fault", action="replica_recover",
                replica=replica, reason=reason or "operator",
            )

    def drain_replica(self, replica: str) -> None:
        self.placement.set_state(replica, DRAINING)

    def remove_replica(self, replica: str) -> None:
        """Retire a replica out of the fleet for good (the autoscaler's
        drain-in endpoint): drop it from placement and the handle map.
        The caller owns the safety argument — drained first, tenants
        moved off (``replace_tenants``), in-flight work waited out."""
        if replica not in self.replicas:
            raise KeyError(f"unknown replica {replica!r}")
        self.placement.remove_replica(replica)
        with self._lock:
            self.replicas.pop(replica, None)
            self.routed.pop(replica, None)
        if self._logger is not None:
            self._logger.log(
                self.submitted, kind="fleet", event="replica_retire",
                replica=replica, replicas=float(len(self.replicas)),
            )

    def pending_failover(self) -> tuple[str, ...]:
        """Tenants whose registered owner differs from their current
        placement — the set ``control.replace_tenants()`` will move."""
        # Snapshot under _lock: the control plane inserts directory
        # entries (register_tenant) from other threads, and a CPython
        # dict raises mid-iteration when it grows underneath us.
        with self._lock:
            entries = list(self.directory.items())
        by_tenant = dict(entries)
        owners = self.placement.owners(
            [t for t, _ in entries],
            tier_of=lambda t: self.tier_of_source(
                by_tenant[t].source, by_tenant[t].max_classes
            ),
            tier_spread=self.tier_spread,
        )
        return tuple(sorted(
            t for t, e in entries
            if owners.get(t) is not None and owners[t] != e.owner
        ))

    # --- cold-start recovery -----------------------------------

    def recover(self, journal, catch_up: bool = True,
                state=None) -> dict:
        """Rebuild the fleet's control-plane state from a
        ``fleet/journal.FleetJournal`` after a router crash/restart.

        Deterministic by construction: the journal's materialized state
        is a pure fold of the op sequence and placement is a pure
        rendezvous function, so the rebuilt directory is BITWISE the
        pre-crash directory (owner, support source, NOTA threshold,
        quarantine flag per tenant — ``directory_view()`` is the
        canonical comparison form). Three repairs happen along the way:

        * journaled replica DRAIN states re-apply to placement;
        * a tenant whose owning replica lost its registry (a restarted
          replica process answering ``has_tenant`` False) is
          RE-REGISTERED there — source, threshold, and quarantine flag
          re-driven from the journal;
        * with ``catch_up``, every live replica answering at a stale
          params_version is caught up by re-driving the journaled
          publish at the committed generation
          (``catch_up_replica``) — ``replica_stale_params`` turned
          from a warning into a repair.

        Emits one ``kind="fault"`` ``action="recovered"`` summary
        record; returns the summary dict (tenants / reregistered /
        caught_up / journal_records / snapshot_seq)."""
        from induction_network_on_fewrel_tpu_torch.fleet.transport import (
            _dataset_from_wire,
        )

        # ``state`` lets a caller that already materialized the journal
        # (serve.py startup reads the adapt latches from the same
        # state) avoid a second full WAL parse.
        if state is None:
            state = journal.materialize()
        for rid in sorted(state.replicas):
            if rid in self.replicas and state.replicas[rid] == "draining":
                self.placement.set_state(rid, DRAINING)
        reregistered = 0
        rewarmed: set[str] = set()
        lost: list[str] = []
        unreachable: set[str] = set()
        for tenant in sorted(state.tenants):
            meta = state.tenants[tenant]
            source = (
                _dataset_from_wire(meta["source"])
                if meta.get("source") else None
            )
            # Source BEFORE placement: the rebuilt owner must resolve
            # with the same N-tier weight register_tenant used, or a
            # clean recovery would read as a pending re-placement.
            probe_entry = _TenantEntry(
                None, source, max_classes=meta.get("max_classes")
            )
            owner = self.place_tenant(tenant, probe_entry)
            entry = _TenantEntry(
                owner, source, max_classes=meta.get("max_classes")
            )
            entry.nota_threshold = meta.get("nota_threshold")
            entry.quarantined = bool(meta.get("quarantined"))
            if owner is None or source is None:
                # No live replica to place on (traffic sheds typed until
                # one revives) or a params-only source with nothing to
                # re-register from — the DIRECTORY entry still recovers
                # either way: zero tenant loss.
                lost.append(tenant)
            elif owner in unreachable:
                # Already probed and failed: do not burn another
                # transport deadline per tenant on a peer we know is
                # down — its rows recover, the supervisor owns the rest.
                pass
            else:
                # Per-tenant containment: ONE unreachable replica (a
                # socket peer still down at cold start) must not abort
                # the whole recovery — its directory rows recover, its
                # registration waits for the supervisor's restart path,
                # and every other tenant recovers fully.
                try:
                    if not self.replicas[owner].has_tenant(tenant):
                        drive_tenant_state(
                            self.replicas[owner], tenant, entry,
                            reason="journal replay",
                        )
                        reregistered += 1
                        rewarmed.add(owner)
                except Exception:  # noqa: BLE001 — supervisor's job now
                    unreachable.add(owner)
            with self._lock:
                self.directory[tenant] = entry
        for rid in sorted(unreachable):
            self.mark_replica_dead(
                rid, reason="unreachable during recovery"
            )
        # A replica that lost its registry also lost its AOT-compiled
        # query programs: warm it BEFORE it takes traffic, so the first
        # post-recovery query is not a steady-state recompile (the
        # zero-recompile invariant survives the crash).
        for rid in sorted(rewarmed):
            try:
                self.replicas[rid].warmup()
            except Exception:  # noqa: BLE001 — warmup is an optimization
                pass
        caught_up = (
            self.catch_up_replicas(state.committed) if catch_up else []
        )
        summary = {
            "tenants": len(state.tenants),
            "reregistered": reregistered,
            "unplaceable": len(lost),
            "unreachable": len(unreachable),
            "caught_up": len(caught_up),
            "params_version": int(state.committed.get(
                "params_version", 0
            )),
            "journal_records": int(state.applied),
            "snapshot_seq": int(journal.snapshot_seq),
        }
        if self._logger is not None:
            self._logger.log(
                self.submitted, kind="fault", action="recovered",
                **{k: float(v) for k, v in summary.items()},
            )
        return summary

    def catch_up_replicas(self, committed: dict) -> list[dict]:
        """Reconcile every UP replica to the journaled committed
        params_version; returns one row per replica actually caught up
        (also emitted as ``kind="fault"`` ``action="catchup"``)."""
        rows = []
        for rid in sorted(self.replicas):
            if self.placement.state(rid) != UP:
                continue
            try:
                row = self.catch_up_replica(rid, committed)
            except Exception as e:  # noqa: BLE001 — one replica's
                # failed catch-up (unreachable peer, refused restore)
                # must not abort the others': it stays stale, loudly.
                if self._logger is not None:
                    self._logger.log(
                        self.submitted, kind="fault",
                        action="replica_stale_params", replica=rid,
                        reason=f"catch-up failed: "
                               f"{type(e).__name__}: {e}",
                    )
                continue
            if row is not None:
                rows.append(row)
        return rows

    def catch_up_replica(self, rid: str, committed: dict) -> dict | None:
        """Re-drive the journaled publish on ONE stale replica: prepare
        at the committed ckpt path pinned to the committed
        params_version, then commit — the registry's zero-recompile
        hot-swap, so steady-state traffic on every other tenant is
        untouched. Returns the catch-up row, or None when the replica
        is already current (or unreachable — the supervisor's problem,
        not this path's)."""
        target = int(committed.get("params_version", 0) or 0)
        ckpt_dir = committed.get("ckpt_dir")
        handle = self.replicas[rid]
        try:
            mine = int(handle.params_version)
        except Exception:  # noqa: BLE001 — unreachable = supervisor's job
            return None
        if target <= 0 or mine >= target:
            return None
        if not ckpt_dir:
            # A params-only publish left no re-drivable artifact: the
            # skew is surfaced LOUDLY (the older warning), the
            # repair needs an operator re-publish.
            if self._logger is not None:
                self._logger.log(
                    self.submitted, kind="fault",
                    action="replica_stale_params", replica=rid,
                    params_version=float(mine),
                    fleet_version=float(target),
                )
            return None
        txn = handle.prepare_publish(
            ckpt_dir=ckpt_dir, target_version=target
        )
        version = handle.commit_publish(txn)
        # A committed publish CLEARS engine-level quarantine by design
        # (fresh verified weights replace the suspect vectors). The catch-up re-drives an OLD publish, and the journal's
        # quarantine ops came AFTER it: re-assert the directory's
        # quarantine flags so replay order wins, not re-application
        # order.
        with self._lock:
            held = [t for t, e in self.directory.items()
                    if e.owner == rid and e.quarantined]
        for tenant in held:
            try:
                handle.quarantine_tenant(
                    tenant, reason="journal replay (post catch-up)"
                )
            except Exception:  # noqa: BLE001 — a tenant the replica
                pass           # does not hold yet has nothing to clear
        row = {"replica": rid, "from_version": mine,
               "to_version": int(version)}
        if self._logger is not None:
            self._logger.log(
                self.submitted, kind="fault", action="catchup",
                replica=rid, from_version=float(mine),
                to_version=float(version),
            )
        return row

    def directory_view(self) -> dict:
        """The tenant directory in canonical, JSON-ready form — the
        bitwise-comparison artifact the recovery drill equates across a
        kill/restart (support sources compare by their wire-form
        digest, not object identity)."""
        import hashlib

        from induction_network_on_fewrel_tpu_torch.fleet.transport import (
            _dataset_to_wire,
        )

        with self._lock:
            entries = sorted(self.directory.items())
        view = {}
        for tenant, e in entries:
            digest = None
            if e.source is not None and hasattr(e.source, "rel_names"):
                wire = json.dumps(
                    _dataset_to_wire(e.source), sort_keys=True
                ).encode()
                digest = hashlib.sha256(wire).hexdigest()[:16]
            view[tenant] = {
                "owner": e.owner,
                "max_classes": e.max_classes,
                "nota_threshold": e.nota_threshold,
                "quarantined": bool(e.quarantined),
                "source_digest": digest,
            }
        return view

    # --- observability ----------------------------------------------------

    def snapshot(self) -> dict:
        states = self.placement.states()
        pending = len(self.pending_failover())
        with self._lock:
            return {
                "replicas": len(self.replicas),
                "live": sum(1 for s in states.values() if s == UP),
                "dead": sum(1 for s in states.values() if s == DEAD),
                "tenants": len(self.directory),
                "submitted": self.submitted,
                "shed": self.shed,
                "degraded_served": self.degraded_served,
                "replica_deaths": self.replica_deaths,
                "replaced": self.replaced,
                "pending_failover": pending,
                "inflight": sum(self._inflight.values()),
            }

    def bind_registry(self, registry=None, prefix: str = "fleet") -> None:
        """Expose the fleet rollup through the shared obs/
        CounterRegistry: aggregate counters as pull-style
        gauges over ``snapshot()`` (ONE home for the formulas), and the
        per-replica columns as LABELED gauge families
        (``fleet_replica_*{replica="r01"}``) updated by ``emit_stats``
        — one scrape of metrics.prom shows the whole fleet."""
        from induction_network_on_fewrel_tpu_torch.obs.export import get_registry

        reg = registry or get_registry()
        self._bound_registry = reg
        self._bound_prefix = prefix
        self._bound_fns = []

        def agg(name: str, help: str = "") -> None:
            f = lambda k=name: float(self.snapshot()[k])  # noqa: E731
            self._bound_fns.append((f"{prefix}_{name}", f))
            reg.gauge_fn(f"{prefix}_{name}", f, help)

        agg("live", "replicas UP in placement")
        agg("dead", "replicas marked dead")
        agg("tenants", "registered fleet tenants")
        agg("submitted", "requests through the fleet front door")
        agg("shed", "fleet-share door sheds")
        agg("degraded_served", "failover NOTA verdicts from the router")
        agg("pending_failover", "tenants awaiting re-placement")
        agg("inflight", "fleet-wide in-flight requests")
        for col, help in (
            ("qps", "served/s over the last emit interval"),
            ("p50_ms", "median replica latency"),
            ("p99_ms", "tail replica latency"),
            ("batch_occupancy", "real rows / bucket slots"),
            ("queue_depth", "replica admission queue depth"),
            ("shed", "replica-level shed-load rejections"),
            ("steady_recompiles", "programs compiled after warmup"),
            ("routed", "requests routed to the replica"),
            ("up", "1 = UP in placement"),
            ("breaker_open", "1 = breaker open, 0.5 = half-open"),
            ("resident_bytes", "bytes of resident class vectors"),
            ("quant_agreement", "sampled quantized-vs-f32 verdict agreement"),
        ):
            self._families[col] = reg.labeled_gauge(
                f"{prefix}_replica_{col}", help=help
            )

    def unbind_registry(self) -> None:
        """Release the gauge_fn closures (identity-checked) and the
        labeled families — the ServingStats.unbind_registry discipline,
        so a closed router stops rendering stale fleet values."""
        reg = self._bound_registry
        if reg is None:
            return
        for name, f in self._bound_fns:
            reg.unregister(name, fn=f)
        prefix = getattr(self, "_bound_prefix", "fleet")
        for col, fam in self._families.items():
            reg.unregister(f"{prefix}_replica_{col}", inst=fam)
        self._bound_registry = None
        self._bound_fns = []
        self._families = {}

    def emit_stats(self, step: int | None = None) -> None:
        """One aggregate ``kind="fleet"`` record + one per-replica record
        (``replica`` field) restating that replica's serving counters —
        the fleet section of the package's tools/obs_report.py splits on
        the field.
        The per-replica shape grows into the fleet ROLLUP: qps
        (served delta over the emit interval), shed, deadline_missed,
        and the router's breaker state string; when ``bind_registry``
        was called the same columns update the labeled gauge families,
        so metrics.prom restates this record per replica."""
        if self._logger is None:
            return
        step = self.submitted if step is None else step
        self._logger.log(step, kind="fleet", **self.snapshot())
        states = self.placement.states()
        now = time.monotonic()
        for rid in sorted(self.replicas):
            try:
                snap = self.replicas[rid].stats_snapshot()
            except Exception:  # noqa: BLE001 — a dead replica has no stats
                snap = {}
            served = float(snap.get("served", 0.0))
            prev_t, prev_served = self._prev_emit.get(
                rid, (self._t0, 0.0)
            )
            dt = max(now - prev_t, 1e-9)
            qps = max(served - prev_served, 0.0) / dt
            self._prev_emit[rid] = (now, served)
            row: dict = {
                "state": states.get(rid, "removed"),
                "routed": float(self.routed.get(rid, 0)),
                "qps": round(qps, 3),
            }
            row.update({
                k: snap[k] for k in (
                    "served", "p50_ms", "p99_ms", "batch_occupancy",
                    "steady_recompiles", "queue_depth", "degraded",
                    "shed", "deadline_missed", "resident_bytes",
                    "quant_probes", "quant_agreement",
                ) if k in snap
            })
            if self.breaker is not None:
                row["breaker"] = str(self.breaker.state(rid))
            self._logger.log(step, kind="fleet", replica=rid, **row)
            if self._families:
                self._update_families(rid, row)

    def _update_families(self, rid: str, row: dict) -> None:
        brk = row.get("breaker")
        values = {
            "qps": row.get("qps", 0.0),
            "p50_ms": row.get("p50_ms", 0.0),
            "p99_ms": row.get("p99_ms", 0.0),
            "batch_occupancy": row.get("batch_occupancy", 0.0),
            "queue_depth": row.get("queue_depth", 0.0),
            "shed": row.get("shed", 0.0),
            "steady_recompiles": row.get("steady_recompiles", 0.0),
            "routed": row.get("routed", 0.0),
            "up": 1.0 if row.get("state") == UP else 0.0,
            "breaker_open": {"open": 1.0, "half_open": 0.5}.get(brk, 0.0),
            "resident_bytes": row.get("resident_bytes", 0.0),
            "quant_agreement": row.get("quant_agreement", 1.0),
        }
        for col, v in values.items():
            fam = self._families.get(col)
            if fam is not None:
                fam.set(float(v), replica=rid)

    def close(self) -> None:
        self.unbind_registry()
        for handle in self.replicas.values():
            try:
                handle.close()
            except Exception:  # noqa: BLE001 — close every replica anyway
                pass
