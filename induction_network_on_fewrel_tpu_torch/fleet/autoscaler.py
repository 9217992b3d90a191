"""Elasticity tier, piece 1: the SLO-driven autoscaler.

A policy loop on an INJECTABLE clock that consumes the fleet signals the
stack already emits — per-replica batch occupancy + queue depth
(``serving/stats.ServingStats.snapshot``), the router's shed-load
counter (fleet-share door sheds), and the SLOEngine's fast-window burn
rates — and drives scale-out / drain-in through the journaled
``FleetControl`` ops, so the serving capacity behind Geng 2019's
induction verdicts follows load instead of being fixed at boot.

Policy shape (the classic target-band controller, deliberately boring):

* **Target band + hysteresis**: a tick classifies as PRESSURE
  (occupancy >= high band, or door sheds since the last tick, or any
  tenant's fast burn >= the SLO engine's page threshold) or IDLE
  (occupancy <= low band AND no sheds AND queues empty AND no burn).
  A decision needs ``high_windows`` / ``low_windows`` CONSECUTIVE
  classifications — one hot tick never scales, one cool tick never
  drains.
* **Cool-down**: every completed decision opens a ``cooldown_s`` window
  in which no NEW decision starts (an in-progress one continues), so a
  load step cannot flap the fleet through add/retire cycles faster than
  the signals can settle.
* **Scale-out = spawn -> catch-up -> pre-warm -> join -> replace.** The
  newcomer is caught up to the journaled committed params_version,
  pre-registered with exactly the tenants the rendezvous will hand it
  (``placement_score`` is pure, so "who moves" is computable BEFORE the
  replica joins placement), and AOT-warmed — all before ``replica_add``
  makes it routable. The zero-recompile invariant holds THROUGH the
  scale event: the first query the newcomer serves hits a compiled
  program.
* **Drain-in = drain -> wait-for-inflight -> replace -> retire.** The
  victim leaves placement (journaled ``replica_drain``) but KEEPS its
  tenant registrations — the router serves a draining owner's tenants
  from the owner until ``replace_tenants`` moves them, so nothing
  queued there can be dropped by an early re-registration. Only when
  its queue is EMPTY do the tenants move (rendezvous churn bound) and
  ``replica_retire`` removes it for good — in-flight work is pinned
  through the whole sequence, never dropped.
* **Bounds + stuck latch**: ``min_replicas``/``max_replicas`` clamp the
  policy; a decision that cannot complete within ``scale_budget_s``
  (spawn_fn failing, a drain that never empties) emits ONE
  ``kind="fault"`` ``action="scale_stuck"`` — the watchdog latches it
  CRITICAL until a later completed scale event re-arms it — and the
  loop keeps retrying rather than abandoning the fleet mid-decision.

Every tick emits one ``kind="scale"`` record (the replica-count
timeline); decisions emit ``event="scale_out"`` / ``event="drain_in"``
with the trigger signals that justified them. Deterministic testing is
the same trick the supervisor uses: inject ``clock=`` and (for drills)
pass explicit ``signals=`` into ``tick`` — the policy arithmetic is
pure; only ``observe()`` touches live counters.
"""

from __future__ import annotations

import time

from induction_network_on_fewrel_tpu_torch.fleet.placement import (
    UP,
    placement_score,
)
from induction_network_on_fewrel_tpu_torch.fleet.router import drive_tenant_state


class FleetAutoscaler:
    """The policy loop. ``control`` is the journaled ``FleetControl``;
    ``spawn_fn(replica_id) -> ReplicaHandle`` builds a fresh replica
    (the supervisor's ``restart_fn`` discipline — process/engine
    creation stays the deployment's business)."""

    def __init__(
        self,
        control,
        spawn_fn,
        *,
        slo=None,
        min_replicas: int = 1,
        max_replicas: int = 4,
        high_occupancy: float = 0.75,
        low_occupancy: float = 0.20,
        high_windows: int = 2,
        low_windows: int = 3,
        cooldown_s: float = 30.0,
        scale_budget_s: float = 60.0,
        clock=time.monotonic,
        logger=None,
    ):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if not (0.0 <= low_occupancy < high_occupancy <= 1.0):
            raise ValueError(
                "need 0 <= low_occupancy < high_occupancy <= 1"
            )
        if high_windows < 1 or low_windows < 1:
            raise ValueError("hysteresis windows must be >= 1")
        self.control = control
        self.spawn_fn = spawn_fn
        self.slo = slo
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.high_occupancy = high_occupancy
        self.low_occupancy = low_occupancy
        self.high_windows = high_windows
        self.low_windows = low_windows
        self.cooldown_s = cooldown_s
        self.scale_budget_s = scale_budget_s
        self.clock = clock
        self._logger = logger
        self._last_shed = int(control.router.snapshot()["shed"])
        self._cooldown_until = float("-inf")
        self._high_streak = 0
        self._low_streak = 0
        self._pending: dict | None = None
        self._retired: set[str] = set()
        self._ticks = 0
        self.scale_outs = 0
        self.drain_ins = 0
        self.last_event: dict | None = None   # latest completed decision

    # --- signals ----------------------------------------------------------

    def observe(self) -> dict:
        """One reading of the live fleet signals. Occupancy/queue depth
        average over UP replicas; ``shed_delta`` is door sheds since the
        last reading; ``burn_fast`` is the max fast-window burn across
        SLO tenants (0 without an SLO engine)."""
        router = self.control.router
        snap = router.snapshot()
        occs: list[float] = []
        qds: list[float] = []
        for rid in sorted(router.replicas):
            if router.placement.state(rid) != UP:
                continue
            try:
                s = router.replicas[rid].stats_snapshot()
            except Exception:  # noqa: BLE001 — supervisor's problem
                continue
            occs.append(float(s.get("batch_occupancy") or 0.0))
            qds.append(float(s.get("queue_depth") or 0))
        shed = int(snap["shed"])
        shed_delta = shed - self._last_shed
        self._last_shed = shed
        burn = 0.0
        if self.slo is not None:
            for tenant in self.slo.tenants():
                rates = self.slo.burn_rates(tenant)
                if rates:
                    burn = max(burn, float(rates["burn_fast"]))
        return {
            "replicas": int(snap["replicas"]),
            "live": int(snap["live"]),
            "occupancy": sum(occs) / len(occs) if occs else 0.0,
            "queue_depth": sum(qds) / len(qds) if qds else 0.0,
            "shed_delta": shed_delta,
            "burn_fast": burn,
        }

    def _burn_hot(self, sig: dict) -> bool:
        if self.slo is None:
            return False
        return float(sig.get("burn_fast", 0.0)) >= self.slo.fast_burn

    # --- the policy tick --------------------------------------------------

    def tick(self, signals: dict | None = None) -> dict:
        """One policy evaluation on the injected clock; returns the
        decision summary (``action`` + the signals it was based on).
        ``signals`` overrides ``observe()`` — the drill/test seam: the
        policy arithmetic is pure given the reading."""
        now = self.clock()
        self._ticks += 1
        sig = self.observe() if signals is None else {
            "replicas": len(self.control.router.replicas),
            "live": len(self.control.router.placement.live()),
            "occupancy": 0.0,
            "queue_depth": 0.0,
            "shed_delta": 0,
            "burn_fast": 0.0,
            **signals,
        }
        pressure = (
            sig["occupancy"] >= self.high_occupancy
            or sig["shed_delta"] > 0
            or self._burn_hot(sig)
        )
        idle = (
            sig["occupancy"] <= self.low_occupancy
            and sig["shed_delta"] <= 0
            and sig["queue_depth"] == 0
            and not self._burn_hot(sig)
        )
        if pressure:
            self._high_streak += 1
            self._low_streak = 0
        elif idle:
            self._low_streak += 1
            self._high_streak = 0
        else:
            self._high_streak = 0
            self._low_streak = 0
        if self._pending is not None:
            action = self._continue_pending(sig, now)
        elif now < self._cooldown_until:
            action = "cooldown"
        elif pressure and self._high_streak >= self.high_windows:
            if sig["live"] >= self.max_replicas:
                action = "at_max"
            else:
                action = self._start_scale_out(sig, now)
        elif idle and self._low_streak >= self.low_windows:
            if sig["live"] <= self.min_replicas:
                action = "at_min"
            else:
                action = self._start_drain_in(sig, now)
        else:
            action = "none"
        if self._logger is not None:
            self._logger.log(
                self._ticks, kind="scale",
                replicas=float(len(self.control.router.replicas)),
                live=float(len(self.control.router.placement.live())),
                occupancy=float(sig["occupancy"]),
                queue_depth=float(sig["queue_depth"]),
                shed_delta=float(sig["shed_delta"]),
                burn_fast=float(sig["burn_fast"]),
                pressure=float(pressure),
                idle=float(idle),
                high_streak=float(self._high_streak),
                low_streak=float(self._low_streak),
                action=action,
            )
        return {"action": action, **sig}

    def _continue_pending(self, sig: dict, now: float) -> str:
        if self._pending["direction"] == "scale_out":
            return self._continue_scale_out(sig, now)
        return self._continue_drain_in(sig, now)

    def _complete(self, now: float) -> None:
        self._pending = None
        self._cooldown_until = now + self.cooldown_s
        self._high_streak = 0
        self._low_streak = 0

    def _maybe_stuck(self, now: float, reason: str) -> None:
        p = self._pending
        waited = now - p["started"]
        if waited < self.scale_budget_s or p["stuck"]:
            return
        p["stuck"] = True
        if self._logger is not None:
            self._logger.log(
                self._ticks, kind="fault", action="scale_stuck",
                direction=p["direction"],
                replica=p.get("replica") or "",
                reason=reason,
                waited_s=float(round(waited, 3)),
                budget_s=float(self.scale_budget_s),
            )

    # --- scale-out --------------------------------------------------------

    def _next_replica_id(self) -> str:
        taken = set(self.control.router.replicas) | self._retired
        n = 0
        while f"r{n:02d}" in taken:
            n += 1
        return f"r{n:02d}"

    def _start_scale_out(self, sig: dict, now: float) -> str:
        self._pending = {
            "direction": "scale_out", "started": now, "replica": None,
            "stuck": False,
            "trigger": {
                k: sig[k] for k in ("occupancy", "shed_delta", "burn_fast")
            },
        }
        return self._continue_scale_out(sig, now)

    def _continue_scale_out(self, sig: dict, now: float) -> str:
        p = self._pending
        try:
            rid = p["replica"] or self._next_replica_id()
            p["replica"] = rid
            handle = self.spawn_fn(rid)
            warm = self._join(rid, handle)
        except Exception as e:  # noqa: BLE001 — retried next tick
            self._maybe_stuck(now, f"spawn failed: {type(e).__name__}: {e}")
            return "pending"
        moved = self.control.replace_tenants()
        self.scale_outs += 1
        self.last_event = {
            "event": "scale_out", "replica": p["replica"],
            "scale_s": round(now - p["started"], 3),
            "warm_compiles": int(warm), "moved": int(moved),
            "trigger": dict(p["trigger"]),
        }
        if self._logger is not None:
            self._logger.log(
                self._ticks, kind="scale", event="scale_out",
                replica=p["replica"],
                scale_s=float(round(now - p["started"], 3)),
                warm_compiles=float(warm),
                moved=float(moved),
                replicas=float(len(self.control.router.replicas)),
                **{k: float(v) for k, v in p["trigger"].items()},
            )
        self._complete(now)
        return "scale_out"

    def _join(self, rid: str, handle) -> int:
        """Everything that must happen BEFORE the newcomer is routable:
        catch up to the committed generation, pre-register the tenants
        the rendezvous will hand it, AOT-warm their programs — then
        join placement (``replica_add``). Returns warmup compiles."""
        router = self.control.router
        if self.control.journal is not None:
            self._catch_up_handle(
                handle, self.control.journal.materialize().committed
            )
        live = router.placement.live()
        with router._lock:
            entries = list(router.directory.items())
        for tenant, entry in entries:
            best = max(
                (placement_score(tenant, r) for r in live), default=None
            )
            if best is None or placement_score(tenant, rid) > best:
                if entry.source is None:
                    continue   # routing-only stub: nothing to pre-warm
                drive_tenant_state(handle, tenant, entry,
                                   reason="pre-warm")
        warm = int(handle.warmup())
        self.control.add_replica(handle)
        return warm

    @staticmethod
    def _catch_up_handle(handle, committed: dict) -> None:
        """``FleetRouter.catch_up_replica`` for a handle that has not
        joined yet (same pinned-version re-drive, no router entry)."""
        target = int(committed.get("params_version", 0) or 0)
        ckpt_dir = committed.get("ckpt_dir")
        if target <= 0 or not ckpt_dir:
            return
        if int(handle.params_version) >= target:
            return
        txn = handle.prepare_publish(
            ckpt_dir=ckpt_dir, target_version=target
        )
        handle.commit_publish(txn)

    # --- drain-in ---------------------------------------------------------

    def _start_drain_in(self, sig: dict, now: float) -> str:
        router = self.control.router
        up = [r for r in sorted(router.replicas)
              if router.placement.state(r) == UP]
        victim = up[-1]   # LIFO: drain-in reverses scale-out
        self.control.drain_replica(victim)
        self._pending = {
            "direction": "drain_in", "started": now, "replica": victim,
            "moved": 0, "stuck": False,
        }
        return self._continue_drain_in(sig, now)

    def _continue_drain_in(self, sig: dict, now: float) -> str:
        # Order is drain -> WAIT -> replace -> retire: while DRAINING
        # the victim still owns (and correctly serves) its tenants, so
        # waiting for an empty queue BEFORE replace_tenants() means no
        # queued request can be dropped by its registration moving.
        p = self._pending
        victim = p["replica"]
        handle = self.control.router.replicas.get(victim)
        if handle is not None:
            try:
                depth = int(
                    handle.stats_snapshot().get("queue_depth") or 0
                )
            except Exception as e:  # noqa: BLE001 — retried next tick
                self._maybe_stuck(
                    now, f"stats unreachable: {type(e).__name__}: {e}"
                )
                return "pending"
            if depth > 0:
                self._maybe_stuck(now, f"{depth} request(s) in flight")
                return "pending"
            p["moved"] += self.control.replace_tenants()
            self.control.retire_replica(victim)
            self._retired.add(victim)
        self.drain_ins += 1
        self.last_event = {
            "event": "drain_in", "replica": victim,
            "drain_s": round(now - p["started"], 3),
            "moved": int(p["moved"]),
        }
        if self._logger is not None:
            self._logger.log(
                self._ticks, kind="scale", event="drain_in",
                replica=victim,
                drain_s=float(round(now - p["started"], 3)),
                moved=float(p["moved"]),
                replicas=float(len(self.control.router.replicas)),
            )
        self._complete(now)
        return "drain_in"
