"""Elasticity tier, piece 2: the WAL-tailing hot standby.

The durable control plane made the router rebuildable from
its journal — but a COLD rebuild pays the full replay + re-register +
warm at the worst possible moment. The hot standby closes the last
single point of failure by paying almost all of that cost BEFORE the
primary dies:

* **Tail the same WAL.** ``journal.JournalTailer`` incrementally folds
  committed ops into an in-memory ``JournalState`` — READ-ONLY (a torn
  tail here is usually an append in progress on the live primary, so
  the tailer stops at the last clean frame; it never truncates another
  process's log). Each ``poll()`` keeps the standby's directory view
  seconds-fresh at the cost of parsing only the new bytes.
* **Leadership latch.** Promotion FIRST takes the journal's
  single-writer lease (``journal.JournalLease`` — atomic tmp+rename,
  epoch bumped on every acquisition). From that instant the old
  primary is fenced: its next ``append`` re-reads a lease it no longer
  holds and raises ``JournalError`` instead of split-braining the log.
* **Promotion = final catch-up + recover + take the front door.** One
  last ``poll()`` folds whatever committed between the death and the
  takeover, then a fresh ``FleetRouter`` over the surviving replica
  handles runs ``recover()`` on the TAILED state — the same
  deterministic rebuild the cold path uses (directory bitwise-equal to
  the dead primary's, drains re-applied, stale replicas caught up,
  lost registries re-registered and re-warmed).
* **Degraded-NOTA window, never dropped.** Until ``promote()``
  returns, ``submit()`` answers every known tenant with the shared
  degraded NOTA verdict (``serving.engine.degraded_verdict``,
  ``failover=True``) — the FewRel 2.0 none-of-the-above contract:
  during the takeover a tenant gets "no relation, degraded" in
  milliseconds, not a dropped request. After promotion ``submit``
  delegates to the promoted router.
"""

from __future__ import annotations

import time
from concurrent.futures import Future
from pathlib import Path

from induction_network_on_fewrel_tpu_torch.fleet.journal import (
    FleetJournal,
    JournalLease,
    JournalTailer,
)
from induction_network_on_fewrel_tpu_torch.fleet.router import FleetRouter
from induction_network_on_fewrel_tpu_torch.serving.engine import degraded_verdict


class HotStandby:
    """A warm shadow of the fleet control plane. Construct it next to
    (or on a host away from) the primary, ``poll()`` it on a timer, and
    call ``promote(handles)`` when the primary is declared dead."""

    def __init__(self, journal_dir, *, owner: str = "standby",
                 logger=None, clock=time.monotonic):
        self.dir = Path(journal_dir)
        self.owner = owner
        self.tailer = JournalTailer(self.dir)
        self._logger = logger
        self._clock = clock
        self.router: FleetRouter | None = None
        self.journal: FleetJournal | None = None
        self.promoted = False
        self.lease_epoch: int | None = None
        self.degraded_served = 0
        self._polls = 0

    # --- the warm side ----------------------------------------------------

    @property
    def state(self):
        """The tailed ``JournalState`` (live view — advances on poll)."""
        return self.tailer.state

    @property
    def applied(self) -> int:
        return self.tailer.applied

    def poll(self) -> int:
        """Fold newly committed primary ops into the standby's state;
        returns ops applied. Emits a ``kind="scale"`` ``event="tail"``
        record when the state advanced."""
        n = self.tailer.poll()
        self._polls += 1
        if n and self._logger is not None:
            self._logger.log(
                self._polls, kind="scale", event="tail",
                applied=float(self.tailer.applied), ops=float(n),
            )
        return n

    def tenants(self) -> tuple[str, ...]:
        return tuple(sorted(self.tailer.state.tenants))

    # --- the front door ---------------------------------------------------

    def submit(self, instance, deadline_s=None,
               tenant: str = "default") -> Future:
        """Before promotion: a degraded-NOTA future for any tailed
        tenant (the promotion-window contract — served, never dropped).
        After promotion: the promoted router's real submit."""
        if self.router is not None:
            return self.router.submit(
                instance, deadline_s=deadline_s, tenant=tenant
            )
        if tenant not in self.tailer.state.tenants:
            raise ValueError(
                f"unknown tenant {tenant!r} (standby has tailed "
                f"{len(self.tailer.state.tenants)} tenants)"
            )
        self.degraded_served += 1
        fut: Future = Future()
        fut.set_result(degraded_verdict(tenant, failover=True))
        return fut

    def classify(self, instance, deadline_s=None,
                 tenant: str = "default") -> dict:
        return self.submit(
            instance, deadline_s=deadline_s, tenant=tenant
        ).result()

    # --- promotion --------------------------------------------------------

    def promote(self, handles, *, breaker=None, catch_up: bool = True,
                fsync: str = "commit", **router_kw) -> dict:
        """Take over as primary. Order matters:

        1. ACQUIRE THE LEASE — the zombie primary is fenced before we
           touch anything (its appends now raise, so nothing can land
           behind our final catch-up read).
        2. Final catch-up ``poll()`` — fold every op that committed up
           to the death.
        3. Open the journal as the new single writer (this repairs any
           torn tail — safe now, we hold the lease) and bind it to our
           lease epoch.
        4. Build a ``FleetRouter`` over the surviving replica handles
           and ``recover()`` it FROM THE TAILED STATE — re-register /
           warm / catch-up, bitwise the dead primary's directory.

        Returns the recovery summary + promotion timings; afterwards
        ``submit`` routes for real and ``self.journal`` accepts
        journaled control ops (build a ``FleetControl`` on top)."""
        if self.promoted:
            raise RuntimeError("standby already promoted")
        t0 = self._clock()
        self.lease_epoch = JournalLease(self.dir).acquire(self.owner)
        tail_ops = self.tailer.poll()
        journal = FleetJournal(self.dir, fsync=fsync, logger=self._logger)
        journal.adopt_lease(self.owner, self.lease_epoch)
        router = FleetRouter(
            dict(handles), logger=self._logger, breaker=breaker,
            **router_kw,
        )
        summary = router.recover(
            journal, catch_up=catch_up, state=self.tailer.state
        )
        self.journal = journal
        self.router = router
        self.promoted = True
        # Identity hand-off: from this instant this process IS
        # the fleet front door — records it emits (hop, fleet rollups)
        # must say "router", not "standby", or fleet_report's timeline
        # attributes post-promotion routing to a process that no longer
        # exists in that role. The pre-promotion records keep "standby",
        # so the transition itself is visible in the timeline.
        set_ident = getattr(self._logger, "set_identity", None)
        if callable(set_ident):
            set_ident("router")
        promote_s = self._clock() - t0
        if self._logger is not None:
            self._logger.log(
                self._polls, kind="scale", event="promotion",
                promote_s=float(round(promote_s, 4)),
                tenants=float(len(self.tailer.state.tenants)),
                replicas=float(len(router.replicas)),
                applied=float(self.tailer.applied),
                lease_epoch=float(self.lease_epoch),
                final_tail_ops=float(tail_ops),
            )
        return {
            "promote_s": promote_s,
            "lease_epoch": self.lease_epoch,
            "applied": self.tailer.applied,
            "final_tail_ops": tail_ops,
            **summary,
        }
