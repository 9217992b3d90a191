"""Drift-triggered adaptation controller.

The pieces of the quality loop all exist — ``obs/drift.py`` detects
per-tenant prediction drift, ``datapipe/mixture.py`` ramps the
mixture curricula that recover domain-adaptation parity
(Gao et al. 2019's wiki -> pubmed shift in miniature), and
``publish_checkpoint`` hot-swaps a training artifact into the live fleet
with zero recompiles. What latched-and-waited-for-a-human
until now closes here: ``AdaptationController`` subscribes to
DriftDetector CRITICALs and drives remediation as a SUPERVISED,
BOUNDED, GATED background job that can never make the fleet worse than
doing nothing:

* **armed -> triggered** — a CRITICAL ``prediction_drift`` event for a
  tenant arms one adaptation loop (re-triggers while a loop is already
  running, cooling down, or exhausted are absorbed — no retrain storms).
  The trigger snapshots the tenant's HEALTHY calibration baseline (the
  pre-drift normal the verification phase must return to).
* **training** — ``train_fn`` runs the targeted mixture-ramp fine-tune
  from the live checkpoint (``train/finetune.mixture_finetune``:
  PipelineFeed + MixtureSchedule + the delta-ring saver) under a STEP
  budget and a WALL-CLOCK budget; a budget breach kills the fine-tune
  and cleans its checkpoints (the helper's contract), and counts as a
  failed attempt.
* **canary** — the candidate is held to the scenario-harness quality
  floors (``obs/canary.run_canary``, plan-in/verdict-out) as a
  hard pre-publish go/no-go gate: a candidate that fails ANY floor is
  discarded (``cleanup_fn``) and NEVER published.
* **publishing** — survivors publish through the existing all-or-nothing
  fan-out (``FleetControl.publish_checkpoint`` — any replica's refusal
  rolls the whole fleet back) or a single engine's
  ``publish_checkpoint``; both re-arm every drift baseline through the
  engines' own commit hooks.
* **verifying** — success is DECLARED, not assumed: inside
  ``verify_window_s`` the drift detector must re-arm (re-baseline from
  post-publish traffic) with the tenant's NOTA rate back inside the
  band of the healthy trigger-time baseline. A drift CRITICAL
  re-tripping inside the window — or the window expiring un-verified —
  ROLLS BACK to the prior artifact (republished through the same
  fan-out) and counts the attempt failed.
* **cooldown / failed / exhausted** — a verified loop resets the
  attempt counter and suppresses triggers for ``cooldown_s``; a failed
  attempt retries after exponential backoff
  (``backoff_s * 2**(attempt-1)``); ``retry_budget`` failed attempts is
  the flap damper: the tenant latches a PERMANENT ``adapt_exhausted``
  CRITICAL (with auto-captured diagnostics), is quarantined
  (``quarantine_fn`` -> degraded NOTA verdicts, zero device time), and
  never retrains again without operator intervention.

Every transition emits one ``kind="adapt"`` record (schema documented in
utils/metrics.KNOWN_KINDS; the package's tools/obs_report.py renders the loop outcome
table with a time-to-recover headline). Every failure arm is drillable
through the chaos registry: ``adapt.train_raise`` / ``adapt.canary_fail``
/ ``adapt.publish_raise`` (obs/chaos.py, RUNBOOK §19), proven end to end
by ``tools/loadgen.py --adapt_drill`` stamping ADAPT_r*.json.

The clock is injectable (``now=`` on every entry point) like every
detector in obs/: drills compress backoff/cooldown/verify windows to the
wall time they actually have. ``run_once``/``tick`` are the synchronous
spine (what tests and drills call); ``start()`` runs them on a
background thread for the serving CLIs.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from collections import deque
from typing import Callable

from induction_network_on_fewrel_tpu_torch.obs.chaos import (
    ChaosError,
    chaos_fire,
)
from induction_network_on_fewrel_tpu_torch.obs.health import (
    CRITICAL,
    HealthEvent,
)

# Controller states (per tenant). One adaptation loop runs at a time
# fleet-wide (the job is a supervised background fine-tune — two
# concurrent fine-tunes would contend for the same device).
ARMED = "armed"
TRIGGERED = "triggered"
TRAINING = "training"
CANARY = "canary"
PUBLISHING = "publishing"
VERIFYING = "verifying"
COOLDOWN = "cooldown"
EXHAUSTED = "exhausted"

STATES = (ARMED, TRIGGERED, TRAINING, CANARY, PUBLISHING, VERIFYING,
          COOLDOWN, EXHAUSTED)


class _Loop:
    """Per-tenant adaptation-loop state (guarded by the controller lock)."""

    __slots__ = (
        "state", "attempts", "not_before", "triggered_at", "feature",
        "healthy", "verify_deadline", "retripped", "prior", "candidate",
        "published_version", "cooldown_until", "loops",
    )

    def __init__(self):
        self.state = ARMED
        self.attempts = 0          # consecutive failed attempts (damper)
        self.not_before = 0.0      # earliest next attempt (backoff)
        self.triggered_at = None   # trigger wall time (recover_s anchor)
        self.feature = ""          # drift feature that tripped
        self.healthy = None        # trigger-time baseline {f: (mean, std)}
        self.verify_deadline = 0.0
        self.retripped = False     # drift CRITICAL during verification
        self.prior = None          # pre-publish artifact (rollback target)
        self.candidate = None      # published candidate (cleanup on
                                   # rollback)
        self.published_version = None
        self.cooldown_until = 0.0
        self.loops = 0             # verified (successful) loops


def make_checkpoint_loop(base_ckpt: str, work_dir: str,
                         finetune_fn: Callable, publish_fn: Callable,
                         prefix: str = "candidate_"):
    """ONE home for the closure wiring both controller builders
    (serve.py's ``_build_adapt`` and the drill's
    ``_build_adapt_controller``) hang the controller on — hand-mirrored
    copies drifted once already (the fine-tune-from-live fix had to
    land twice). Returns ``(train_fn, publish, cleanup, current_fn)``:

    * a live-artifact holder — repeat loops fine-tune from the last
      PUBLISHED artifact, not the stale startup base, and rollback
      republishes whatever is live;
    * ``train_fn`` minting sequential candidate dirs under ``work_dir``
      and delegating to ``finetune_fn(src_ckpt, out_dir, seq, attempt,
      step_budget, wall_budget_s)``;
    * a ``publish`` wrapper advancing the holder on commit;
    * a ``cleanup`` that only ever deletes candidate dirs THIS loop
      minted (never the base checkpoint or an operator-provided dir).
    """
    live = {"artifact": base_ckpt}
    seq = {"n": 0}

    def train_fn(tenant, attempt, step_budget, wall_budget_s):
        seq["n"] += 1
        out = os.path.join(work_dir, f"{prefix}{seq['n']:03d}")
        return finetune_fn(live["artifact"], out, seq["n"], attempt,
                           step_budget, wall_budget_s)

    def publish(candidate):
        version = publish_fn(candidate)
        live["artifact"] = candidate
        return version

    def cleanup(candidate):
        if isinstance(candidate, str) and candidate.startswith(
                os.path.join(work_dir, prefix)):
            shutil.rmtree(candidate, ignore_errors=True)

    return train_fn, publish, cleanup, (lambda: live["artifact"])


class AdaptationController:
    """Supervised drift -> fine-tune -> canary -> publish -> verify loop.

    ``train_fn(tenant, attempt, step_budget, wall_budget_s)`` returns an
    opaque CANDIDATE (whatever ``publish_fn`` accepts — the stack's
    spelling is a checkpoint directory); it must enforce the budgets
    itself and clean up on failure (``train/finetune.mixture_finetune``'s
    contract). ``canary_fn(candidate)`` returns a verdict dict with
    ``passed`` (obs/canary.run_canary). ``publish_fn(candidate)``
    returns the committed params_version (a single engine's
    ``publish_checkpoint`` or the fleet fan-out — both raise on refusal,
    which counts the attempt failed with the fleet untouched).
    ``current_fn()`` returns the currently-live artifact, captured
    immediately before each publish as the rollback target.
    ``cleanup_fn(candidate)`` discards a candidate that failed the
    canary (or was rolled back). ``quarantine_fn(tenant, reason)`` runs
    at exhaustion. ``drift`` is the detector to subscribe to (``bind``)
    and to verify re-arm/in-band against; without one, verification
    degrades to publish-implies-success (unit-test harnesses)."""

    def __init__(
        self,
        train_fn: Callable,
        canary_fn: Callable | None,
        publish_fn: Callable,
        *,
        drift=None,
        current_fn: Callable | None = None,
        cleanup_fn: Callable | None = None,
        quarantine_fn: Callable | None = None,
        retry_budget: int = 3,
        backoff_s: float = 2.0,
        cooldown_s: float = 60.0,
        verify_window_s: float = 30.0,
        step_budget: int = 200,
        wall_budget_s: float = 300.0,
        logger=None,
        recorder=None,
        capture=None,
        on_event: Callable[[HealthEvent], None] | None = None,
        journal=None,
    ):
        if retry_budget < 1:
            raise ValueError(f"retry_budget must be >= 1, got {retry_budget}")
        if backoff_s <= 0 or verify_window_s <= 0 or wall_budget_s <= 0:
            raise ValueError(
                "backoff_s/verify_window_s/wall_budget_s must be > 0"
            )
        self.train_fn = train_fn
        self.canary_fn = canary_fn
        self.publish_fn = publish_fn
        self.drift = drift
        self.current_fn = current_fn
        self.cleanup_fn = cleanup_fn
        self.quarantine_fn = quarantine_fn
        self.retry_budget = retry_budget
        self.backoff_s = backoff_s
        self.cooldown_s = cooldown_s
        self.verify_window_s = verify_window_s
        self.step_budget = step_budget
        self.wall_budget_s = wall_budget_s
        self.logger = logger
        self.recorder = recorder
        self.capture = capture
        self.on_event = on_event
        # Optional fleet journal: the EXHAUSTED latch is
        # control-plane state that must survive a router restart — a
        # recovered fleet must not un-quarantine a flapping tenant and
        # re-enter the retrain storm the damper stopped.
        self.journal = journal
        self._lock = threading.RLock()
        self._loops: dict[str, _Loop] = {}
        self._busy = False           # one fine-tune at a time, fleet-wide
        self._seq = 0                # kind="adapt" record step counter
        self._prev_on_event = None   # chained drift subscriber (bind)
        self._bound_fanout = None    # the installed fanout (bind guard)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.events: deque[HealthEvent] = deque(maxlen=256)
        self.records: deque[dict] = deque(maxlen=512)   # drills/tests
        if drift is not None:
            self.bind(drift)

    # --- subscription -----------------------------------------------------

    def bind(self, drift) -> None:
        """Subscribe to the detector's event stream, CHAINING any
        existing subscriber (the detector has one ``on_event`` slot).
        Idempotent: re-binding the same detector is a no-op — the guard
        compares against the INSTALLED fanout closure, not the inner
        handler, so a second bind can never chain the fanout to itself
        (which would recurse on the first event)."""
        self.drift = drift
        prev = drift.on_event
        if prev is not None and prev is self._bound_fanout:
            return
        self._prev_on_event = prev

        def fanout(ev):
            if self._prev_on_event is not None:
                self._prev_on_event(ev)
            self._on_drift_event(ev)

        self._bound_fanout = fanout
        drift.on_event = fanout

    def _on_drift_event(self, ev: HealthEvent) -> None:
        if ev.event != "prediction_drift" or ev.severity != CRITICAL:
            return
        tenant = ev.data.get("tenant")
        if not isinstance(tenant, str):
            return
        self.trigger(tenant, feature=str(ev.data.get("feature", "")))

    def restore_exhausted(self, exhausted) -> None:
        """Re-prime the PERMANENT exhaustion latches from a recovered
        journal (fleet/journal.JournalState.adapt_exhausted: tenant ->
        attempts). The latch is journaled at exhaustion time so a
        router restart cannot forget it — without this read-back, a
        recovered fleet would absorb nothing and the next drift
        CRITICAL on a quarantined flapper would re-enter exactly the
        retrain storm the damper stopped. Accepts a mapping or an
        iterable of tenant names."""
        items = (exhausted.items() if hasattr(exhausted, "items")
                 else ((t, 0.0) for t in exhausted))
        with self._lock:
            for tenant, attempts in items:
                loop = self._loops.setdefault(str(tenant), _Loop())
                loop.state = EXHAUSTED
                loop.attempts = max(loop.attempts,
                                    int(float(attempts or 0.0)))

    # --- trigger ----------------------------------------------------------

    def trigger(self, tenant: str, feature: str = "",
                now: float | None = None) -> bool:
        """One drift CRITICAL arrived for ``tenant``. Returns whether a
        NEW adaptation loop armed (re-triggers during a running loop,
        cooldown, or after exhaustion are absorbed — except during
        VERIFYING, where a re-trip marks the published candidate failed
        so the next ``tick`` rolls it back)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            loop = self._loops.setdefault(tenant, _Loop())
            if loop.state == VERIFYING:
                # Post-publish drift re-trip inside the verification
                # window: the adaptation made nothing better. The tick
                # path performs the rollback (it owns the publish
                # plumbing); here we only flip the verdict bit.
                loop.retripped = True
                return False
            if loop.state == COOLDOWN and now >= loop.cooldown_until:
                loop.state = ARMED
            if loop.state != ARMED:
                return False     # running / backing off / cooling /
                                 # exhausted: absorbed, no retrain storm
            loop.state = TRIGGERED
            loop.triggered_at = now
            loop.feature = feature
            loop.retripped = False
            # The HEALTHY normal the verification phase must return to:
            # the tenant's calibration baseline as of the trigger (the
            # detector replaces it only on re-arm, so at trigger time it
            # is still the pre-drift baseline).
            loop.healthy = (
                self.drift.baseline_for(tenant)
                if self.drift is not None else None
            )
        self._record(tenant, "trigger", state=TRIGGERED,
                     attempt=float(loop.attempts + 1), feature=feature)
        return True

    # --- the adaptation job ----------------------------------------------

    def run_once(self, now: float | None = None) -> str | None:
        """Run ONE due adaptation attempt to its publish (or failure),
        synchronously on the calling thread. Returns the tenant
        processed, or None when nothing is due. The background thread
        (``start``) calls this in its loop; drills and tests call it
        directly with an injected clock."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._busy:
                return None
            tenant = next(
                (t for t, lp in sorted(self._loops.items())
                 if lp.state == TRIGGERED and now >= lp.not_before),
                None,
            )
            if tenant is None:
                return None
            loop = self._loops[tenant]
            loop.state = TRAINING
            self._busy = True
        try:
            self._attempt(tenant, loop, now)
        except Exception:
            # An unexpected failure in the attempt MACHINERY itself —
            # e.g. a raising telemetry write between the guarded stages
            # — must not strand the tenant in TRAINING/CANARY/PUBLISHING
            # (states neither run_once nor tick can ever schedule
            # again). The state repair in _attempt_failed happens under
            # the lock BEFORE any telemetry, so even a re-raising
            # record leaves the loop schedulable; the error then
            # surfaces to the caller (the background worker logs on).
            with self._lock:
                wedged = loop.state in (TRAINING, CANARY, PUBLISHING)
            if wedged:
                self._attempt_failed(tenant, loop, "internal", now)
            raise
        finally:
            with self._lock:
                self._busy = False
        return tenant

    def _attempt(self, tenant: str, loop: _Loop, now: float) -> None:
        attempt = loop.attempts + 1
        # Wall clock at attempt entry: the verification deadline must be
        # anchored at PUBLISH time, not at run_once() entry — a 200-step
        # fine-tune plus the canary can take minutes, and charging that
        # against a 30 s verify window would roll back every good
        # candidate as "expired" before post-publish traffic could
        # possibly re-baseline the detector. ``now`` may be an injected
        # test clock, so the attempt's real elapsed wall is ADDED to it
        # rather than re-read from time.monotonic() (zero under injected
        # clocks, exact in production where now IS monotonic).
        entry_wall = time.monotonic()
        # -- training -----------------------------------------------------
        t0 = time.monotonic()
        try:
            if chaos_fire("adapt.train_raise", tenant=tenant,
                          step=self._seq) is not None:
                raise ChaosError(
                    f"injected fine-tune failure for {tenant!r} (chaos)"
                )
            candidate = self.train_fn(
                tenant, attempt, self.step_budget, self.wall_budget_s
            )
        except BaseException as e:  # noqa: BLE001 — budget kills included
            self._record(
                tenant, "train", state=TRAINING, attempt=float(attempt),
                ok=0.0, train_s=round(time.monotonic() - t0, 3),
                error=f"{type(e).__name__}: {e}",
            )
            self._attempt_failed(tenant, loop, "train", now)
            return
        self._record(tenant, "train", state=CANARY, attempt=float(attempt),
                     ok=1.0, train_s=round(time.monotonic() - t0, 3),
                     steps=float(self.step_budget))
        # -- canary gate --------------------------------------------------
        with self._lock:
            loop.state = CANARY
        if chaos_fire("adapt.canary_fail", tenant=tenant,
                      step=self._seq) is not None:
            verdict = {"passed": False, "injected": True,
                       "failures": ["chaos: adapt.canary_fail"]}
        elif self.canary_fn is not None:
            try:
                verdict = self.canary_fn(candidate)
            except BaseException as e:  # noqa: BLE001 — a raising canary
                # is a failed gate, never a publish
                verdict = {"passed": False,
                           "failures": [f"{type(e).__name__}: {e}"]}
        else:
            verdict = {"passed": True, "failures": []}
        failures = verdict.get("failures") or []
        self._record(
            tenant, "canary", state=CANARY, attempt=float(attempt),
            passed=1.0 if verdict.get("passed") else 0.0,
            failures=float(len(failures)),
            **({"first_failure": str(failures[0])[:160]}
               if failures else {}),
        )
        if not verdict.get("passed"):
            # Discarded, never published — the canary is a hard bar.
            self._cleanup(candidate)
            self._attempt_failed(tenant, loop, "canary", now)
            return
        # -- publish ------------------------------------------------------
        with self._lock:
            loop.state = PUBLISHING
            loop.prior = (
                self.current_fn() if self.current_fn is not None else None
            )
            loop.candidate = candidate
        t1 = time.monotonic()
        try:
            if chaos_fire("adapt.publish_raise", tenant=tenant,
                          step=self._seq) is not None:
                raise ChaosError(
                    f"injected publish failure for {tenant!r} (chaos)"
                )
            version = self.publish_fn(candidate)
        except BaseException as e:  # noqa: BLE001 — fan-out refusals
            # (FleetPublishError et al.) rolled the fleet back already;
            # the candidate is discarded and the attempt counts failed.
            self._record(
                tenant, "publish", state=PUBLISHING,
                attempt=float(attempt), ok=0.0,
                error=f"{type(e).__name__}: {e}",
            )
            self._cleanup(candidate)
            with self._lock:
                loop.candidate = None
            self._attempt_failed(tenant, loop, "publish", now)
            return
        with self._lock:
            loop.published_version = version
            loop.state = VERIFYING
            loop.verify_deadline = (
                now + (time.monotonic() - entry_wall)
                + self.verify_window_s
            )
        self._record(
            tenant, "publish", state=VERIFYING, attempt=float(attempt),
            ok=1.0, params_version=float(version),
            publish_s=round(time.monotonic() - t1, 3),
        )

    # --- verification ----------------------------------------------------

    def _verify_ok(self, tenant: str, loop: _Loop) -> dict | None:
        """The success bar: the drift detector re-armed (re-baselined
        from post-publish traffic) AND the tenant's NOTA rate is back
        inside the band of the healthy trigger-time baseline. Returns
        the check's numbers, or None when not (yet) satisfied."""
        if self.drift is None:
            return {"nota_base": -1.0, "nota_healthy": -1.0,
                    "nota_band": -1.0}   # no detector: publish = success
        if not self.drift.armed(tenant):
            return None
        base = self.drift.baseline_for(tenant)
        if base is None or loop.healthy is None:
            return {"nota_base": -1.0, "nota_healthy": -1.0,
                    "nota_band": -1.0}
        import math

        h_mean, h_std = loop.healthy["nota_rate"]
        cur = base["nota_rate"][0]
        band = max(
            self.drift.band_sigma * h_std
            / math.sqrt(max(self.drift.baseline_n, 1)),
            self.drift.nota_rate_floor,
        )
        if abs(cur - h_mean) > band:
            return None
        return {"nota_base": round(cur, 6),
                "nota_healthy": round(h_mean, 6),
                "nota_band": round(band, 6)}

    def tick(self, now: float | None = None) -> None:
        """Advance time-driven states: verification success/rollback and
        cooldown expiry. Called by the background loop and by drills
        after driving post-publish traffic."""
        now = time.monotonic() if now is None else now
        with self._lock:
            items = list(self._loops.items())
        for tenant, loop in items:
            if loop.state == VERIFYING:
                if loop.retripped:
                    self._rollback(tenant, loop,
                                   "post-publish drift re-trip", now)
                    continue
                ok = self._verify_ok(tenant, loop)
                if ok is not None:
                    self._verified(tenant, loop, now, ok)
                elif now >= loop.verify_deadline:
                    self._rollback(
                        tenant, loop,
                        "verification window expired without re-arm/"
                        "in-band NOTA rate", now,
                    )
            elif loop.state == COOLDOWN and now >= loop.cooldown_until:
                with self._lock:
                    if loop.state == COOLDOWN:
                        loop.state = ARMED

    def _verified(self, tenant: str, loop: _Loop, now: float,
                  check: dict) -> None:
        with self._lock:
            recover_s = (
                now - loop.triggered_at
                if loop.triggered_at is not None else -1.0
            )
            loop.state = COOLDOWN
            loop.cooldown_until = now + self.cooldown_s
            loop.attempts = 0          # damper resets on success
            loop.loops += 1
            loop.prior = None
            loop.candidate = None
        self._record(
            tenant, "verified", state=COOLDOWN, attempt=0.0,
            recover_s=round(recover_s, 3),
            params_version=float(loop.published_version
                                 if loop.published_version is not None
                                 else -1),
            **check,
        )

    def _rollback(self, tenant: str, loop: _Loop, reason: str,
                  now: float) -> None:
        with self._lock:
            prior, candidate = loop.prior, loop.candidate
            loop.prior = None
            loop.candidate = None
        rolled_version = None
        if prior is not None:
            try:
                rolled_version = self.publish_fn(prior)
            except BaseException as e:  # noqa: BLE001 — a failing
                # rollback publish must not wedge the controller; the
                # fleet stays on the (bad) candidate and the record +
                # exhaustion path tell the operator.
                reason = f"{reason}; rollback publish FAILED: {e}"
        self._record(
            tenant, "rollback", state=TRIGGERED,
            attempt=float(loop.attempts + 1), reason=reason[:200],
            params_version=float(rolled_version
                                 if rolled_version is not None else -1),
        )
        # The candidate directory is deletable ONLY once the prior
        # artifact actually recommitted: with no rollback target, or a
        # rollback publish that failed, the fleet is still SERVING the
        # candidate — deleting it would orphan the live params_version
        # (and fail every later fine-tune reading the live artifact).
        if rolled_version is not None:
            self._cleanup(candidate)
        self._attempt_failed(tenant, loop, "verify", now)

    # --- failure / exhaustion --------------------------------------------

    def _attempt_failed(self, tenant: str, loop: _Loop, stage: str,
                        now: float) -> None:
        with self._lock:
            loop.attempts += 1
            attempts = loop.attempts
            if attempts >= self.retry_budget:
                loop.state = EXHAUSTED
            else:
                loop.state = TRIGGERED
                loop.not_before = (
                    now + self.backoff_s * (2.0 ** (attempts - 1))
                )
        if attempts >= self.retry_budget:
            self._record(tenant, "exhausted", state=EXHAUSTED,
                         attempt=float(attempts), stage=stage)
            self._send(HealthEvent(
                event="adapt_exhausted", severity=CRITICAL, step=self._seq,
                message=(
                    f"tenant {tenant!r} burned its adaptation retry "
                    f"budget ({attempts} failed attempts, last stage "
                    f"{stage!r}): quarantined, no further retrains "
                    f"without operator intervention"
                ),
                data={"tenant": tenant, "attempts": float(attempts),
                      "stage": stage},
            ))
            if self.journal is not None:
                try:
                    self.journal.append(
                        "adapt_exhausted", tenant=tenant,
                        attempts=float(attempts),
                    )
                except Exception:  # noqa: BLE001 — the CRITICAL above
                    pass           # is the hard signal either way
            if self.quarantine_fn is not None:
                try:
                    self.quarantine_fn(
                        tenant, reason="adapt retry budget exhausted"
                    )
                except Exception:  # noqa: BLE001 — best-effort: the
                    pass           # CRITICAL above is the hard signal

    def _cleanup(self, candidate) -> None:
        if candidate is None or self.cleanup_fn is None:
            return
        try:
            self.cleanup_fn(candidate)
        except Exception:  # noqa: BLE001 — cleanup is best-effort
            pass

    # --- emission ---------------------------------------------------------

    def _record(self, tenant: str, action: str, **fields) -> None:
        self._seq += 1
        rec = {"action": action, "tenant": tenant, **fields}
        self.records.append(rec)
        if self.logger is not None:
            self.logger.log(self._seq, kind="adapt", **rec)

    def _send(self, ev: HealthEvent) -> None:
        """adapt_exhausted is PERMANENT by construction (the state
        machine never leaves EXHAUSTED), so emission is once per tenant
        without a separate latch set."""
        self.events.append(ev)
        if self.recorder is not None:
            self.recorder.record_event(ev.to_dict())
        if self.logger is not None:
            self.logger.log(
                ev.step, kind="health", event=ev.event,
                severity=ev.severity, message=ev.message, **ev.data,
            )
        if self.capture is not None:
            self.capture.capture(reason=f"adapt: {ev.message}")
        elif self.recorder is not None:
            self.recorder.dump(reason=f"adapt: {ev.message}")
        if self.on_event is not None:
            self.on_event(ev)

    # --- introspection / lifecycle ---------------------------------------

    def state_of(self, tenant: str) -> str:
        with self._lock:
            loop = self._loops.get(tenant)
            return loop.state if loop is not None else ARMED

    def loop_info(self, tenant: str) -> dict:
        with self._lock:
            loop = self._loops.get(tenant)
            if loop is None:
                return {"state": ARMED, "attempts": 0, "loops": 0}
            return {
                "state": loop.state, "attempts": loop.attempts,
                "loops": loop.loops, "not_before": loop.not_before,
                "published_version": loop.published_version,
            }

    def unquarantine(self, tenant: str) -> None:
        """Operator escape hatch: reset an EXHAUSTED tenant to ARMED
        (the quarantine itself is lifted at the registry/control plane
        by the operator — RUNBOOK §19)."""
        with self._lock:
            loop = self._loops.get(tenant)
            if loop is not None and loop.state == EXHAUSTED:
                loop.state = ARMED
                loop.attempts = 0
                loop.not_before = 0.0

    def start(self, poll_s: float = 0.5) -> None:
        """Run the loop on a background daemon thread (the serving CLI
        spelling); drills/tests stay on the synchronous entry points."""
        if self._thread is not None:
            return
        self._stop.clear()

        def worker():
            while not self._stop.is_set():
                try:
                    self.run_once()
                    self.tick()
                except Exception:  # noqa: BLE001 — the supervisor
                    pass           # thread must survive any one loop
                self._stop.wait(poll_s)

        self._thread = threading.Thread(
            target=worker, name="adapt-controller", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
