"""Replica supervision: probe, restart, re-register, catch up.

The fleet router already CONTAINS a dead replica (breaker-fed failover,
degraded NOTA, re-placement) — but nothing brought one back except an
operator following RUNBOOK §18 by hand. The supervisor closes that loop
for process-per-replica (socket-mode) fleets, and for any fleet whose
replicas can be rebuilt by a ``restart_fn``:

* **Health probe** — every ``poll()`` pings each UP replica
  (``ReplicaHandle.ping``; the socket transport raises
  ``ConnectionError``/``TransportTimeout`` when the peer is gone or
  wedged — the per-call deadline means a wedged peer cannot hang the
  probe loop). A failed probe feeds ``router.mark_replica_dead`` — the
  existing failover path takes over immediately.
* **Restart with exponential backoff + deterministic jitter** — a DEAD
  replica is restarted through ``restart_fn(replica_id) -> handle``
  after ``backoff_s * 2^(attempt-1)`` (capped), plus a jitter that is a
  pure hash of (replica id, attempt) — reproducible in tests and
  drills, no thundering herd across supervisors, no RNG. The clock is
  injectable (the obs/ detector discipline), so tests compress hours
  into arithmetic.
* **Bounded restart budget** — ``restart_budget`` consecutive failed
  restarts degrade the replica to PERMANENT-dead: the supervisor stops
  trying (one ``action="replica_restart_exhausted"`` record), and the
  router's existing failover keeps answering for its tenants.
  ``forgive()`` is the operator escape hatch.
* **Re-registration + catch-up on every restart** — the fresh process
  has an empty registry at params_version 0. The supervisor re-drives
  every directory tenant owned by the replica (support source, NOTA
  threshold, quarantine flag), catches the replica up to the journaled
  committed generation (``router.catch_up_replica`` re-driving the
  journaled publish — zero recompiles on the rest of the fleet), warms
  the new process, resets its breaker history, and revives it in
  placement. ``kind="fault"`` ``action="replica_restarted"`` /
  ``action="catchup"`` tell the stream.

``poll()`` is the unit of work (drills and tests call it directly);
``start()`` runs it on a daemon thread every ``probe_interval_s``.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Callable

from induction_network_on_fewrel_tpu_torch.fleet.placement import DEAD, UP


def deterministic_jitter(replica: str, attempt: int) -> float:
    """A [0, 1) fraction that is a pure function of (replica, attempt) —
    the jitter source: reproducible, process-independent, RNG-free."""
    h = hashlib.blake2b(
        f"{replica}|{attempt}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64


class _Watch:
    __slots__ = ("attempts", "next_attempt_at", "exhausted")

    def __init__(self):
        self.attempts = 0          # consecutive FAILED restart attempts
        self.next_attempt_at = 0.0
        self.exhausted = False     # permanent-dead: budget burned


class ReplicaSupervisor:
    """Supervise one router's replicas. ``restart_fn(replica_id)``
    returns a fresh ``ReplicaHandle`` (spawning a process + dialing a
    ``SocketReplica`` in a real fleet; building a fresh engine in
    drills) or raises — a raise counts as a failed attempt against the
    budget."""

    def __init__(
        self,
        router,
        restart_fn: Callable[[str], object],
        journal=None,
        probe_interval_s: float = 1.0,
        backoff_s: float = 0.5,
        backoff_cap_s: float = 30.0,
        restart_budget: int = 3,
        jitter_frac: float = 0.25,
        clock: Callable[[], float] = time.monotonic,
        logger=None,
    ):
        if restart_budget < 1:
            raise ValueError(
                f"restart_budget must be >= 1, got {restart_budget}"
            )
        if backoff_s <= 0 or probe_interval_s <= 0:
            raise ValueError("backoff_s/probe_interval_s must be > 0")
        self.router = router
        self.restart_fn = restart_fn
        self.journal = journal
        self.probe_interval_s = probe_interval_s
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        self.restart_budget = restart_budget
        self.jitter_frac = jitter_frac
        self._clock = clock
        self._logger = logger if logger is not None else router._logger
        self._watch: dict[str, _Watch] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.restarts = 0          # successful restarts (lifetime)

    # --- policy -----------------------------------------------------------

    def next_delay(self, replica: str, attempts: int) -> float:
        """The wait before attempt ``attempts + 1``: exponential in the
        FAILED attempt count, capped, plus deterministic jitter."""
        base = min(
            self.backoff_s * (2.0 ** max(attempts - 1, 0)),
            self.backoff_cap_s,
        )
        return base * (
            1.0 + self.jitter_frac * deterministic_jitter(replica, attempts)
        )

    def exhausted(self, replica: str) -> bool:
        with self._lock:
            w = self._watch.get(replica)
            return bool(w is not None and w.exhausted)

    def forgive(self, replica: str) -> None:
        """Operator escape hatch: clear the budget so the next poll may
        try again (the adapt controller's ``unquarantine`` discipline)."""
        with self._lock:
            self._watch.pop(replica, None)

    # --- the work unit ----------------------------------------------------

    def poll(self) -> dict:
        """One supervision pass: probe UP replicas, restart due DEAD
        ones. Returns {"probed": n, "marked_dead": [...],
        "restarted": [...], "failed": [...], "exhausted": [...]}."""
        out = {"probed": 0, "marked_dead": [], "restarted": [],
               "failed": [], "exhausted": []}
        now = self._clock()
        states = self.router.placement.states()
        for rid in sorted(self.router.replicas):
            state = states.get(rid)
            if state == UP:
                out["probed"] += 1
                try:
                    alive = self.router.replicas[rid].ping()
                except Exception:  # noqa: BLE001 — any transport error
                    alive = False  # is the answer "not alive"
                if alive:
                    with self._lock:
                        self._watch.pop(rid, None)   # healthy: clean slate
                else:
                    self.router.mark_replica_dead(
                        rid, reason="supervisor probe failed"
                    )
                    out["marked_dead"].append(rid)
                continue
            if state != DEAD:
                continue            # draining: operator's business
            with self._lock:
                w = self._watch.setdefault(rid, _Watch())
                if w.exhausted or now < w.next_attempt_at:
                    continue
            self._attempt_restart(rid, w, now, out)
        return out

    def _attempt_restart(self, rid: str, w: _Watch, now: float,
                         out: dict) -> None:
        attempt = w.attempts + 1
        try:
            handle = self.restart_fn(rid)
            self._adopt(rid, handle)
        except Exception as e:  # noqa: BLE001 — a failed restart is data
            with self._lock:
                w.attempts = attempt
                if attempt >= self.restart_budget:
                    w.exhausted = True
                else:
                    w.next_attempt_at = now + self.next_delay(rid, attempt)
            if self._logger is not None:
                self._logger.log(
                    self.router.submitted, kind="fault",
                    action="replica_restarted", replica=rid, ok=0.0,
                    attempt=float(attempt),
                    reason=f"{type(e).__name__}: {e}",
                )
            if w.exhausted:
                out["exhausted"].append(rid)
                if self._logger is not None:
                    self._logger.log(
                        self.router.submitted, kind="fault",
                        action="replica_restart_exhausted", replica=rid,
                        attempts=float(attempt),
                    )
            else:
                out["failed"].append(rid)
            return
        with self._lock:
            self._watch.pop(rid, None)
            self.restarts += 1
        out["restarted"].append(rid)
        if self._logger is not None:
            self._logger.log(
                self.router.submitted, kind="fault",
                action="replica_restarted", replica=rid, ok=1.0,
                attempt=float(attempt),
            )

    def _adopt(self, rid: str, handle) -> None:
        """Swap the fresh handle in and make it SERVE-READY before it
        re-enters placement: re-register the replica's directory
        tenants, catch up to the journaled committed params_version,
        warm the query programs, reset the breaker, revive. Order
        matters — reviving first would route live traffic at an empty
        registry."""
        from induction_network_on_fewrel_tpu_torch.fleet.router import (
            drive_tenant_state,
        )

        router = self.router
        old = router.replicas.get(rid)
        router.replicas[rid] = handle
        if old is not None and old is not handle:
            try:
                old.close()
            except Exception:  # noqa: BLE001 — the old process is dead
                pass
        # Snapshot under the ROUTER lock: the control plane inserts
        # directory entries from client threads, and a CPython dict
        # raises mid-iteration when it grows underneath us — which the
        # blanket restart-failure handler would miscount as a burned
        # budget attempt.
        with router._lock:
            mine = sorted(
                (t, e) for t, e in router.directory.items()
                if e.owner == rid
            )
        for tenant, entry in mine:
            if entry.source is None:       # nothing to re-register from
                continue
            if handle.has_tenant(tenant):  # survived (in-place restart)
                continue
            drive_tenant_state(handle, tenant, entry,
                               reason="carried over restart")
        if self.journal is not None:
            router.catch_up_replica(
                rid, self.journal.materialize().committed
            )
        try:
            handle.warmup()
        except Exception:  # noqa: BLE001 — warmup is an optimization;
            pass           # steady-state gates catch a broken replica
        if router.breaker is not None:
            router.breaker.reset(rid)
        router.revive_replica(rid, reason="supervised restart")

    # --- loop -------------------------------------------------------------

    def start(self) -> "ReplicaSupervisor":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="replica-supervisor"
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            try:
                self.poll()
            except Exception as e:  # noqa: BLE001 — the supervisor must
                # outlive any single poll's surprise — but SILENTLY
                # no-oping forever would be indistinguishable from
                # healthy supervision: say so in the fault stream.
                if self._logger is not None:
                    try:
                        self._logger.log(
                            self.router.submitted, kind="fault",
                            action="supervisor_poll_error",
                            reason=f"{type(e).__name__}: {e}",
                        )
                    except Exception:  # noqa: BLE001 — last resort
                        pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
