"""Fleet control plane: tenant lifecycle routed to owners + the
all-or-nothing fan-out publish.

**Tenant ops route to the owner.** ``register_tenant`` resolves the
rendezvous owner, registers the support set THERE, and records the
source in the router's tenant directory — which is what makes failover
real: after a replica death, ``replace_tenants`` re-registers every
displaced tenant (same source, same NOTA threshold, same quarantine
flag) on its new rendezvous owner, and per-tenant state — exactly the
FewRel 2.0 knobs (NOTA thresholds, drift baselines re-armed by the
registration) — survives re-placement. Quarantine/threshold ops route
the same way.

**Fan-out publish is one fleet transaction.** ``publish_params`` /
``publish_checkpoint`` run the registry's two-phase publish
(serving/registry.prepare_publish -> PublishTransaction) across every
non-dead replica: phase 1 prepares ALL replicas (validation gate + full
re-distill, nothing visible to any data plane); only when every prepare
succeeded does phase 2 commit them one by one (plain-assignment swaps —
zero recompiles, in-flight batches pinned to their old snapshots). ANY
prepare failure — a validation veto, a raising distill, an injected
``publish.nan_params`` on any ONE replica — aborts every prepared
transaction before any replica moved: params_version stays uniform at
the OLD generation fleet-wide, and one ``kind="fault"``
``action="publish_rollback"`` record (``scope="fleet"``) names the
refusing replica. After a committed fan-out every replica is at the
SAME new params_version (asserted), each engine's drift detector
re-armed through its own commit hook.
"""

from __future__ import annotations

import time

from induction_network_on_fewrel_tpu_torch.fleet.placement import DEAD
from induction_network_on_fewrel_tpu_torch.fleet.router import (
    FleetRouter,
    InProcessReplica,
    ReplicaHandle,
    _TenantEntry,
    drive_tenant_state,
)


class FleetPublishError(RuntimeError):
    """The fan-out publish failed. With ``committed`` empty (the normal
    case — phase 1 refused) the WHOLE fleet rolled back: every replica
    still serves its pre-publish generation at the old params_version.
    A non-empty ``committed`` means a COMMIT-phase failure (rare: a
    late-registered straggler whose re-distill fails validation) left
    the fleet version-skewed — the named replicas are live on the new
    generation, the failing one rolled back; re-running the fan-out
    once the cause is fixed restores uniformity. ``replica`` names the
    refusing replica either way."""

    def __init__(self, replica: str, cause: BaseException,
                 committed: tuple[str, ...] = ()):
        if committed:
            msg = (
                f"fleet publish PARTIALLY committed: replica {replica!r} "
                f"failed its commit ({type(cause).__name__}: {cause}) "
                f"after {list(committed)} committed — the fleet is "
                f"version-skewed; re-run the fan-out once the failure "
                f"is fixed"
            )
        else:
            msg = (
                f"fleet publish rolled back: replica {replica!r} refused "
                f"({type(cause).__name__}: {cause}); every replica stays "
                f"on its old params_version"
            )
        super().__init__(msg)
        self.replica = replica
        self.cause = cause
        self.committed = tuple(committed)


class FleetControl:
    """Control-plane operations over a ``FleetRouter``'s replicas.

    With a ``journal`` (fleet/journal.FleetJournal) every
    control-plane op is write-ahead-logged AFTER it succeeds on the
    replicas: tenant register/threshold/quarantine, replica
    add/drain/revive, and committed publishes (params_version + the
    checkpoint path a catch-up can re-drive). A crashed router then
    rebuilds everything through ``FleetRouter.recover(journal)``.
    Placement is never journaled — it stays a pure rendezvous function
    of (tenant id, live replica set)."""

    def __init__(self, router: FleetRouter, logger=None, journal=None):
        self.router = router
        self._logger = logger if logger is not None else router._logger
        self.journal = journal

    def _journal(self, op: str, **fields) -> None:
        if self.journal is not None:
            self.journal.append(op, **fields)

    @staticmethod
    def _source_wire(dataset):
        """The journal-ready form of a support source (None for
        non-dataset sources — e.g. routing-only stubs; such tenants
        recover their directory row but cannot be re-registered)."""
        if dataset is None or not hasattr(dataset, "rel_names"):
            return None
        from induction_network_on_fewrel_tpu_torch.fleet.transport import (
            _dataset_to_wire,
        )

        return _dataset_to_wire(dataset)

    # --- tenant lifecycle -------------------------------------------------

    def register_tenant(
        self, tenant: str, dataset, max_classes=None,
        nota_threshold=None,
    ) -> str:
        """Register ``tenant``'s support corpus on its rendezvous owner;
        returns the owning replica id. The source is recorded in the
        router directory so failover can re-register it elsewhere.

        When the router carries a ``resident_budget_bytes``, placement
        capacity is derived from RESIDENT BYTES, not tenant
        count: a registration that would land on a replica already at
        its byte budget is refused up front — quantized (bf16/int8)
        tenants pack ~2-4x denser than f32 under the same budget."""
        # Place through the router's one tier-aware spelling so register,
        # submit, failover, and recovery all agree on the owner.
        owner = self.router.place_tenant(
            tenant, _TenantEntry(None, dataset, max_classes=max_classes)
        )
        if owner is None:
            raise RuntimeError("no live replica to place the tenant on")
        budget = self.router.resident_budget_bytes
        if budget is not None:
            used = self.router.replica_resident_bytes(owner)
            if used >= budget:
                raise RuntimeError(
                    f"replica {owner!r} is at its resident-byte budget "
                    f"({used:.0f}/{budget:.0f} bytes) — cannot place "
                    f"tenant {tenant!r}; lower the tenant's resident "
                    f"dtype or add replicas"
                )
        handle = self.router.replicas[owner]
        handle.register_dataset(dataset, tenant, max_classes=max_classes)
        entry = _TenantEntry(owner, dataset, max_classes=max_classes)
        if nota_threshold is not None:
            handle.set_nota_threshold(nota_threshold, tenant)
            entry.nota_threshold = nota_threshold
        # Under the router lock: directory iterations (pending_failover,
        # mark_replica_dead's affected-tenant count) snapshot under the
        # same lock, so a concurrent registration can't blow up a
        # mid-failover iteration.
        with self.router._lock:
            self.router.directory[tenant] = entry
        self._journal(
            "tenant_register", tenant=tenant,
            source=self._source_wire(dataset), max_classes=max_classes,
            nota_threshold=nota_threshold,
        )
        return owner

    def set_nota_threshold(self, tenant: str, threshold) -> None:
        entry = self._entry(tenant)
        self.router.replicas[entry.owner].set_nota_threshold(
            threshold, tenant
        )
        entry.nota_threshold = threshold
        self._journal("tenant_threshold", tenant=tenant,
                      threshold=threshold)

    def quarantine_tenant(self, tenant: str, reason: str = "") -> None:
        entry = self._entry(tenant)
        self.router.replicas[entry.owner].quarantine_tenant(tenant, reason)
        entry.quarantined = True
        self._journal("tenant_quarantine", tenant=tenant, reason=reason)

    def unquarantine_tenant(self, tenant: str, reason: str = "") -> None:
        entry = self._entry(tenant)
        self.router.replicas[entry.owner].unquarantine_tenant(
            tenant, reason
        )
        entry.quarantined = False
        self._journal("tenant_unquarantine", tenant=tenant, reason=reason)

    def _entry(self, tenant: str) -> _TenantEntry:
        entry = self.router.directory.get(tenant)
        if entry is None:
            raise ValueError(f"unknown tenant {tenant!r}")
        return entry

    # --- membership / re-placement ----------------------------------------

    def add_replica(self, handle: ReplicaHandle) -> None:
        """Join a replica: membership + placement. Tenants whose
        rendezvous now prefers the newcomer (the ~1/R bound) show up in
        ``pending_failover`` and move on the next ``replace_tenants``."""
        rid = handle.replica_id
        self.router.replicas[rid] = handle
        self.router.routed.setdefault(rid, 0)
        self.router.placement.add_replica(rid)
        self._journal("replica_add", replica=rid)
        if self._logger is not None:
            self._logger.log(
                self.router.submitted, kind="fleet", event="replica_add",
                replica=rid, replicas=float(len(self.router.replicas)),
            )

    def drain_replica(self, replica: str) -> None:
        """Operator drain, journaled: the replica leaves placement (its
        tenants remap at the rendezvous bound) but keeps serving what is
        in flight — and a recovered router replays the drain instead of
        routing fresh traffic back."""
        self.router.drain_replica(replica)
        self._journal("replica_drain", replica=replica)

    def revive_replica(self, replica: str, reason: str = "") -> None:
        self.router.revive_replica(replica, reason=reason)
        self._journal("replica_revive", replica=replica)

    def retire_replica(self, replica: str) -> None:
        """Remove a replica from the fleet FOR GOOD (the autoscaler's
        drain-in endpoint, also an operator op). Refuses while the
        directory still names it as an owner — drain + ``replace_tenants``
        first; retiring is the last step, after in-flight work is out."""
        owners = {e.owner for e in self.router.directory.values()}
        if replica in owners:
            raise ValueError(
                f"replica {replica!r} still owns tenants — drain it and "
                "run replace_tenants() before retiring"
            )
        handle = self.router.replicas.get(replica)
        self.router.remove_replica(replica)
        self._journal("replica_retire", replica=replica)
        if handle is not None:
            try:
                handle.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass

    def forgive_replica(self, replica: str, supervisor=None) -> None:
        """Operator escape hatch: re-arm a replica's supervisor restart
        budget (``ReplicaSupervisor.forgive``), journaled so the audit
        trail shows WHO un-latched a restart-exhausted replica (the
        replay itself is neutral — budgets are process-local)."""
        if supervisor is not None:
            supervisor.forgive(replica)
        self._journal("replica_forgive", replica=replica)
        if self._logger is not None:
            self._logger.log(
                self.router.submitted, kind="fleet",
                event="replica_forgive", replica=replica,
            )

    def replace_tenants(self) -> int:
        """Re-register every displaced tenant (registered owner !=
        current placement) on its new owner, carrying its NOTA threshold
        and quarantine flag; the OLD registration is dropped when its
        replica is still reachable (a dead one simply keeps stale state
        it will never be asked about — and a revive re-fans a publish
        before it re-enters placement anyway). A request already QUEUED
        on the old owner when its tenant state drops fails with a typed
        retryable ``ExecuteError`` (clients retry onto the new owner;
        the router's breaker ignores failures from a replica that is no
        longer the tenant's registered owner, so stragglers cannot
        open a healthy replica's breaker). Returns tenants moved —
        the placement-churn number the FLEET artifact records."""
        moved = 0
        for tenant in self.router.pending_failover():
            entry = self.router.directory[tenant]
            target = self.router.place_tenant(tenant, entry)
            if target is None:
                continue
            drive_tenant_state(
                self.router.replicas[target], tenant, entry,
                reason="carried over",
            )
            old = entry.owner
            entry.owner = target
            moved += 1
            if (old in self.router.replicas
                    and self.router.placement.state(old) not in (None, DEAD)):
                try:
                    self.router.replicas[old].drop_tenant(tenant)
                except Exception:  # noqa: BLE001 — best-effort cleanup
                    pass
        if moved:
            with self.router._lock:
                self.router.replaced += moved
            if self._logger is not None:
                self._logger.log(
                    self.router.submitted, kind="fleet", event="replace",
                    moved=float(moved),
                    tenants=float(len(self.router.directory)),
                )
        return moved

    # --- fan-out publish --------------------------------------------------

    def _publish_targets(self) -> list[str]:
        """Every non-dead replica, deterministic order. Dead replicas
        miss the fan-out by design — they re-enter service only through
        revive + replace/re-publish (RUNBOOK §18)."""
        states = self.router.placement.states()
        return [
            rid for rid in sorted(self.router.replicas)
            if states.get(rid) != DEAD
        ]

    def publish_params(self, new_params) -> int:
        return self._fanout_publish(params=new_params)

    def publish_checkpoint(self, ckpt_dir: str) -> int:
        return self._fanout_publish(ckpt_dir=ckpt_dir)

    def _fanout_publish(self, params=None, ckpt_dir=None) -> int:
        t0 = time.monotonic()
        targets = self._publish_targets()
        if not targets:
            raise RuntimeError("no live replica to publish to")
        prepared: list[tuple[str, object]] = []
        try:
            # Prepares run SEQUENTIALLY, deterministic replica order, by
            # design: the chaos grammar targets fault points by 0-based
            # GLOBAL arrival index (publish.nan_params@1 = the middle
            # replica of three — test-pinned), and parallel prepares
            # would make that order a race. Fan-out publish wall time
            # therefore scales with R; parallel prepare needs a
            # per-replica chaos ARG filter first (future work).
            shared_params = params
            for rid in targets:
                handle = self.router.replicas[rid]
                if isinstance(handle, InProcessReplica):
                    # In-process replicas share this process's memory:
                    # restore the checkpoint ONCE and fan the tree out,
                    # instead of R identical disk restores (the cost
                    # lands straight in the recorded publish_s). Socket
                    # replicas keep ckpt_dir — a params tree does not
                    # cross the wire; each process restores locally.
                    if shared_params is None and ckpt_dir is not None:
                        from induction_network_on_fewrel_tpu_torch.serving \
                            .registry import load_params

                        shared_params = load_params(ckpt_dir)
                    txn = handle.prepare_publish(params=shared_params)
                else:
                    txn = handle.prepare_publish(params=params,
                                                 ckpt_dir=ckpt_dir)
                prepared.append((rid, txn))
        except BaseException as e:
            failing = targets[len(prepared)]
            for rid, txn in prepared:
                try:
                    self.router.replicas[rid].abort_publish(txn)
                except Exception:  # noqa: BLE001 — abort the rest anyway
                    pass
            if self._logger is not None:
                self._logger.log(
                    self.router.submitted, kind="fault",
                    action="publish_rollback", scope="fleet",
                    replica=failing,
                    reason=f"{type(e).__name__}: {e}",
                    prepared=float(len(prepared)),
                )
            raise FleetPublishError(failing, e) from e
        # Phase 2: commit every prepared transaction. A commit CAN still
        # refuse (a late-registered straggler whose re-distill fails
        # validation — that replica rolls back and releases its serial
        # lock in its own finally). Keep committing the rest either way:
        # once any replica is live on the new generation, aborting the
        # others would only WIDEN the skew — and every transaction must
        # be finished (commit or its own rollback) so no publish-serial
        # lock is ever left held.
        versions: dict[str, int] = {}
        failed: list[tuple[str, BaseException]] = []
        telemetry_errors: list[tuple[str, BaseException]] = []
        for rid, txn in prepared:
            try:
                versions[rid] = self.router.replicas[rid].commit_publish(
                    txn
                )
            except BaseException as e:  # noqa: BLE001 — finish the fan-out
                if getattr(txn, "committed", False):
                    # The swap IS live on this replica — the exception
                    # came from POST-commit bookkeeping (a raising
                    # logger hook, disk-full jsonl write; the exact
                    # case PublishTransaction.committed exists for).
                    # Count it committed at its staged version and
                    # surface the real error below — never report a
                    # rollback that did not happen. (A socket txn is a
                    # token, committed unreadable: the wire path stays
                    # conservative and lands in ``failed``.)
                    versions[rid] = txn.new_version
                    telemetry_errors.append((rid, e))
                else:
                    failed.append((rid, e))
        if failed:
            rid, cause = failed[0]
            committed = tuple(sorted(versions))
            if self._logger is not None:
                self._logger.log(
                    self.router.submitted, kind="fault",
                    action="publish_rollback", scope="fleet",
                    replica=rid,
                    reason=f"commit: {type(cause).__name__}: {cause}",
                    prepared=float(len(prepared)),
                    committed=float(len(committed)),
                )
            raise FleetPublishError(rid, cause, committed=committed) \
                from cause
        version = max(versions.values())
        # Write-ahead the COMMITTED generation (the publish is live on
        # every replica at this point): the params_version plus the
        # checkpoint path recovery re-drives a stale replica's catch-up
        # from. Journaled before the telemetry/skew records so a raising
        # logger hook can never lose a live commit. fsync="commit"
        # syncs exactly this append.
        self._journal("publish_commit", params_version=int(version),
                      ckpt_dir=str(ckpt_dir) if ckpt_dir else None)
        if len(set(versions.values())) != 1 and self._logger is not None:
            # The fleet is LIVE on the new weights everywhere (commits
            # landed) but the version COUNTERS disagree — a replica with
            # a different publish history (e.g. direct per-replica
            # publishes before it joined). Surfaced, never hidden: the
            # uniformity invariant the drills assert is on fleets whose
            # replicas share one history.
            self._logger.log(
                self.router.submitted, kind="fault",
                action="publish_version_skew",
                reason=" ".join(
                    f"{r}:{v}" for r, v in sorted(versions.items())
                ),
            )
        if self._logger is not None:
            self._logger.log(
                self.router.submitted, kind="fleet",
                event="fanout_publish",
                publish_s=round(time.monotonic() - t0, 4),
                replicas=float(len(versions)),
                params_version=float(version),
            )
        if telemetry_errors:
            # Every commit is live (the publish SUCCEEDED fleet-wide),
            # but a replica's post-commit bookkeeping raised — re-raise
            # the real error like single-replica publish_params does,
            # after the fanout record above told the truth.
            raise telemetry_errors[0][1]
        return version
