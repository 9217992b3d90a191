"""Run-health watchdog: turns the metrics stream into structured events.

The counterpart of ``induction_network_on_fewrel_tpu/obs/health.py``
(``HealthWatchdog``, ``SLOObjective``, ``DiagnosticsCapture``,
``SLOEngine``), with the same events, latches and thresholds; the
diagnostics capture's profile is a ``torch.profiler`` trace where the JAX
one is a ``jax.profiler`` trace.

The failure modes this catches are the ones VERDICT.md flags as silent
today:

* **Non-finite loss/grads** — NaN/Inf in any numeric scalar of a train
  record (the bf16-backward risk, the MSE-sigmoid dead zone).
* **Throughput regression** — episodes/sec falling below a fraction of the
  rolling-median baseline (feed stall, thermal/preemption slowdowns).
* **Routing-entropy collapse** — the induction routing (or any model that
  logs a ``routing_entropy`` / ``*_entropy`` scalar) pinning near zero:
  every query routed identically, i.e. the class vectors collapsed.
* **Serving queue stall** — queue depth > 0 while the served counter stops
  advancing for longer than ``queue_stall_s`` (a wedged batcher worker).
* **Serving shed-load** — the per-tenant shed counter advancing between
  serve windows: some tenant is over its admission share and actively
  shedding traffic. Critical + once-latched, so a
  sustained overload is one incident; re-arms after a shed-free window.
  Hot-swap publishes (``event="snapshot_swap"`` serve records) surface as
  WARNING events — an operator reading the health stream sees every
  weight swap next to whatever it perturbed.
* **Feed stall / poison** — the training input pipeline (datapipe/) starving
  its consumer: stall ticks (``kind="data"``) whose produced counter stops
  advancing for longer than ``queue_stall_s`` while the trainer waits, a
  dead producer thread, or a poisoned batch — the feed-side generalization
  of the serving queue-stall detector.

This module also hosts the per-tenant **SLO burn-rate engine**:
``SLOEngine`` turns per-request serving outcomes into multi-window
error-budget burn rates (fast 5m-equivalent / slow 1h-equivalent,
injectable clock like the watchdog above) and — on a fast-window CRITICAL
— auto-captures diagnostics through ``DiagnosticsCapture`` (flight-
recorder dump + a ``torch.profiler`` trace when asked for,
host-span snapshot as the CPU-honest guaranteed artifact), so the
evidence for a tail regression is on disk before anyone asks.

Wiring: the watchdog is installed as a ``MetricsLogger`` hook, so every
record every execution path emits (train/val/serve) flows through
``observe_record`` with no extra calls at the emit sites. Events are
appended to the flight recorder, logged as ``kind="health"`` records in
metrics.jsonl, and — for critical events — trip the watchdog, which dumps
the flight recorder (obs/recorder.py) so the last-N window of context
survives the incident.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Any, Callable


CRITICAL = "critical"
WARNING = "warning"


@dataclasses.dataclass
class HealthEvent:
    event: str                 # "non_finite" | "throughput_regression" | ...
    severity: str              # "critical" | "warning"
    step: int
    message: str
    data: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "event": self.event,
            "severity": self.severity,
            "step": self.step,
            "message": self.message,
            **{k: v for k, v in self.data.items()},
        }


class HealthWatchdog:
    def __init__(
        self,
        logger=None,
        recorder=None,
        throughput_drop: float = 0.5,
        throughput_window: int = 8,
        throughput_warmup: int = 3,
        entropy_floor: float = 0.05,
        queue_stall_s: float = 5.0,
        on_event: Callable[[HealthEvent], None] | None = None,
        capture: "DiagnosticsCapture | None" = None,
    ):
        """``throughput_drop``: trip when eps/s < drop * rolling median.
        ``throughput_warmup``: train records to observe before the baseline
        arms (the first windows include compile time and are not a
        baseline). ``logger``/``recorder`` are attached lazily so the
        watchdog can be constructed before either exists. ``capture``: a
        DiagnosticsCapture; when set, criticals capture through it (which
        includes the flight dump) instead of a bare recorder dump — the
        fault criticals (ckpt_corrupt / breaker_open /
        publish_rollback) get the same evidence discipline as SLO burns
        and drift."""
        self.logger = logger
        self.recorder = recorder
        self.capture = capture
        self.throughput_drop = throughput_drop
        self.throughput_warmup = throughput_warmup
        self.entropy_floor = entropy_floor
        self.queue_stall_s = queue_stall_s
        self.on_event = on_event
        # Bounded (the module contract says everything here is): a
        # condition that persists for a whole soak must not grow host
        # memory one event per window.
        self.events: deque[HealthEvent] = deque(maxlen=512)
        self.tripped = False
        self._lock = threading.RLock()
        self._eps = deque(maxlen=throughput_window)
        self._in_emit = False
        # Once-semantics latches: a PERSISTENT condition (loss stuck at
        # NaN, entropy pinned at zero) emits one event when it begins and
        # re-arms only after a clean observation — not one critical event
        # (and one flight-recorder dump) per record for the rest of the
        # run. Keys: "non_finite:<kind>", "routing_collapse:<metric>",
        # "throughput".
        self._latched: set[str] = set()
        # Serving-stall state: (served counter, first time it was seen
        # unchanged with a non-empty queue).
        self._last_served: int | None = None
        self._stall_since: float | None = None
        self._stall_reported = False
        # Shed-load state: last aggregate shed counter seen.
        self._last_shed: int | None = None
        # Feed-stall state (training input pipeline): produced counter and
        # first time it was seen unchanged while the consumer waited.
        self._last_fed: int | None = None
        self._feed_stall_since: float | None = None
        self._feed_stall_reported = False
        self._poisoned_seen = 0

    # --- event plumbing --------------------------------------------------

    def _emit(self, ev: HealthEvent) -> None:
        self.events.append(ev)
        if ev.severity == CRITICAL:
            self.tripped = True
        if self.recorder is not None:
            self.recorder.record_event(ev.to_dict())
        if self.logger is not None:
            # Guard against self-observation: this log() call re-enters
            # observe_record through the logger hook.
            self._in_emit = True
            try:
                self.logger.log(
                    ev.step, kind="health", event=ev.event,
                    severity=ev.severity, message=ev.message, **ev.data,
                )
            finally:
                self._in_emit = False
        if ev.severity == CRITICAL:
            # DiagnosticsCapture (when wired) already dumps the recorder
            # as its first artifact — capturing AND dumping would write
            # the flight window twice per incident.
            if self.capture is not None:
                self.capture.capture(
                    reason=f"watchdog: {ev.event} ({ev.message})"
                )
            elif self.recorder is not None:
                self.recorder.dump(
                    reason=f"watchdog: {ev.event} ({ev.message})"
                )
        if self.on_event is not None:
            self.on_event(ev)

    # --- observations ----------------------------------------------------

    def observe_record(self, rec: dict) -> None:
        """MetricsLogger hook: one call per emitted record, any kind."""
        with self._lock:
            if self._in_emit:
                return
            kind = rec.get("kind")
            if kind == "health":
                # Grad-probe records are measurements, not watchdog output:
                # a NaN grad norm must still trip the non-finite check.
                if rec.get("event") == "grad_probe":
                    self._check_finite(int(rec.get("step", 0)), rec)
                return
            step = int(rec.get("step", 0))
            if kind == "fault":
                # Fault-domain stream: containment actions
                # become once-latched criticals; injections are context.
                self._check_fault(step, rec)
                return
            if kind in ("train", "val", "eval", "test", "serve",
                        "quality", "scenario", "perf", "compile",
                        "adapt"):
                # quality/scenario carry model-score statistics — a NaN
                # margin/entropy/accuracy means NaN logits upstream, the
                # exact silent failure the non-finite check exists for.
                # perf/compile carry timing decompositions — a
                # non-finite segment or elapsed means broken clocks or a
                # division by a zero window, equally silent upstream.
                # adapt carries the loop's recover/publish timings and
                # the verification band numbers — same class.
                self._check_finite(step, rec)
            if kind in ("train", "val", "eval"):
                self._check_entropy(step, rec)
            if kind == "train" and "episodes_per_s" in rec:
                self._check_throughput(step, float(rec["episodes_per_s"]))
            if kind == "serve":
                if rec.get("event") == "snapshot_swap":
                    # A publish that COMMITTED re-arms the rollback
                    # latch: the next failed publish is a new incident,
                    # not a suppressed repeat of the last one.
                    self._latched.discard("publish_rollback")
                    # Visibility, not a failure: every hot-swap publish
                    # lands in the health stream next to whatever it
                    # perturbed.
                    # The logger normalizes scalars to float before hooks
                    # see them; these two are counts.
                    as_count = lambda v: (  # noqa: E731
                        int(v) if isinstance(v, (int, float)) else v
                    )
                    self._emit(HealthEvent(
                        event="snapshot_swap", severity=WARNING, step=step,
                        message=(
                            f"hot-swap published params_version "
                            f"{as_count(rec.get('params_version'))} to "
                            f"{as_count(rec.get('tenants'))} tenant(s)"
                        ),
                        data={
                            k: rec[k] for k in
                            ("params_version", "tenants", "slots")
                            if k in rec
                        },
                    ))
                elif "tenant" not in rec:
                    # Aggregate serve windows only: per-tenant records
                    # restate the same counters tenant-by-tenant.
                    self.observe_queue(
                        int(rec.get("queue_depth", 0)),
                        int(rec.get("served", 0)),
                    )
                    self._check_shed(step, rec)
            if kind == "scale":
                # A completed scale decision re-arms the stuck latch:
                # the next stall is a new incident.
                if rec.get("event") in ("scale_out", "drain_in"):
                    self._latched.discard("scale_stuck")
                self._check_finite(step, rec)
            if kind == "data":
                self.observe_feed(
                    produced=int(rec.get("produced", 0)),
                    consumed=int(rec.get("consumed", 0)),
                    producer_alive=bool(rec.get("producer_alive", 1.0)),
                    poisoned=int(rec.get("poisoned", 0)),
                    step=step,
                    waiting="stalled_s" in rec,
                )

    def _check_finite(self, step: int, rec: dict) -> None:
        latch = f"non_finite:{rec.get('kind')}"
        bad = {
            k: str(v) for k, v in rec.items()
            if isinstance(v, float) and not math.isfinite(v)
        }
        if not bad:
            self._latched.discard(latch)  # clean record re-arms
            return
        if latch in self._latched:
            return
        self._latched.add(latch)
        self._emit(HealthEvent(
            event="non_finite", severity=CRITICAL, step=step,
            message=f"non-finite scalars: {sorted(bad)}",
            data={f"bad_{k}": v for k, v in bad.items()},
        ))

    def _check_entropy(self, step: int, rec: dict) -> None:
        for k, v in rec.items():
            if not k.endswith("entropy") or not isinstance(v, (int, float)):
                continue
            latch = f"routing_collapse:{k}"
            if math.isfinite(v) and v < self.entropy_floor:
                if latch in self._latched:
                    continue
                self._latched.add(latch)
                self._emit(HealthEvent(
                    event="routing_collapse", severity=CRITICAL, step=step,
                    message=f"{k}={v:.4g} below floor {self.entropy_floor}",
                    data={k: float(v)},
                ))
            else:
                self._latched.discard(latch)

    def _check_throughput(self, step: int, eps: float) -> None:
        if not math.isfinite(eps):
            return
        if len(self._eps) >= self.throughput_warmup:
            baseline = sorted(self._eps)[len(self._eps) // 2]  # rolling median
            if baseline > 0 and eps < self.throughput_drop * baseline:
                if "throughput" not in self._latched:
                    self._latched.add("throughput")
                    self._emit(HealthEvent(
                        event="throughput_regression", severity=WARNING,
                        step=step,
                        message=(
                            f"episodes_per_s {eps:.1f} < "
                            f"{self.throughput_drop:.0%} of baseline "
                            f"{baseline:.1f}"
                        ),
                        data={"episodes_per_s": eps, "baseline": baseline},
                    ))
                # A regressed window must not drag the baseline down with
                # it (a real slowdown stays an incident, not the new
                # normal) — and it must not re-arm the latch either.
                return
        self._latched.discard("throughput")  # healthy window re-arms
        self._eps.append(eps)

    def _check_shed(self, step: int, rec: dict) -> None:
        """Shed-load detection over aggregate serve windows: the shed
        counter advancing means some tenant is over its admission share
        and actively shedding. Once-latched (a sustained overload is one
        incident); a shed-free window re-arms."""
        shed = rec.get("shed")
        if not isinstance(shed, (int, float)):
            return
        shed = int(shed)
        prev, self._last_shed = self._last_shed, shed
        if prev is None:
            # First window: a nonzero total is still news.
            prev = 0
        if shed > prev:
            if "shed_load" in self._latched:
                return
            self._latched.add("shed_load")
            self._emit(HealthEvent(
                event="shed_load", severity=CRITICAL, step=step,
                message=(
                    f"shed-load active: {shed - prev} per-tenant share "
                    f"rejections since the last serve window "
                    f"(total {shed})"
                ),
                data={
                    "shed": shed,
                    "rejected": int(rec.get("rejected", 0)),
                    "queue_depth": int(rec.get("queue_depth", 0)),
                },
            ))
        else:
            self._latched.discard("shed_load")

    def _check_fault(self, step: int, rec: dict) -> None:
        """Fault-domain criticals, each once-latched with an
        explicit re-arm:

        * ``ckpt_corrupt``     — a checkpoint slot quarantined. Latched
          per SLOT (kind+step): one incident per corrupt slot, however
          many roots/retries report it; a different slot is a new
          incident by key.
        * ``breaker_open``     — a tenant's circuit breaker opened.
          Latched per tenant; the breaker's own ``to="closed"``
          transition re-arms.
        * ``publish_rollback`` — a publish transaction rolled back.
          Single latch; a later COMMITTED publish (snapshot_swap serve
          event) re-arms.
        * ``replica_dead``     — a fleet replica marked dead.
          Latched per replica; ``action="replica_recover"`` re-arms.

        Injected faults (action="inject") are context, not failures —
        the containment they provoke is what must (and does) trip.
        """
        action = rec.get("action")
        if action == "ckpt_quarantine":
            latch = (
                f"ckpt_corrupt:{rec.get('ckpt_kind')}:{rec.get('ckpt_step')}"
            )
            if latch in self._latched:
                return
            self._latched.add(latch)
            self._emit(HealthEvent(
                event="ckpt_corrupt", severity=CRITICAL, step=step,
                message=(
                    f"checkpoint slot {rec.get('ckpt_kind')}/"
                    f"{int(rec.get('ckpt_step', 0))} failed integrity "
                    f"verification and was quarantined "
                    f"({rec.get('reason')})"
                ),
                data={
                    k: rec[k] for k in ("ckpt_kind", "ckpt_step", "reason")
                    if k in rec
                },
            ))
        elif action == "breaker":
            tenant = rec.get("tenant")
            latch = f"breaker_open:{tenant}"
            if rec.get("to") == "open":
                if latch in self._latched:
                    return
                self._latched.add(latch)
                self._emit(HealthEvent(
                    event="breaker_open", severity=CRITICAL, step=step,
                    message=(
                        f"circuit breaker OPEN for tenant {tenant!r} "
                        f"after {int(rec.get('failures', 0))} consecutive "
                        f"execute failures — shedding before it burns "
                        f"device time"
                    ),
                    data={
                        k: rec[k] for k in ("tenant", "from", "failures")
                        if k in rec
                    },
                ))
            elif rec.get("to") == "closed":
                self._latched.discard(latch)
        elif action == "replica_dead":
            # Fleet tier: a replica marked dead (breaker open
            # on forwarded failures, or the fleet.replica_kill chaos
            # point). Latched per replica; action="replica_recover"
            # re-arms — a flapping replica is one incident per down
            # transition, not one per routed-around request.
            replica = rec.get("replica")
            latch = f"replica_dead:{replica}"
            if latch in self._latched:
                return
            self._latched.add(latch)
            self._emit(HealthEvent(
                event="replica_dead", severity=CRITICAL, step=step,
                message=(
                    f"fleet replica {replica!r} marked DEAD "
                    f"({rec.get('reason')}) — "
                    f"{int(rec.get('tenants', 0))} tenant(s) failing "
                    f"over to degraded NOTA until re-placement"
                ),
                data={
                    k: rec[k] for k in ("replica", "reason", "tenants")
                    if k in rec
                },
            ))
        elif action == "replica_recover":
            self._latched.discard(f"replica_dead:{rec.get('replica')}")
        elif action == "scale_stuck":
            # Elasticity tier: a scale decision (spawn/warm
            # on scale-out, wait-for-inflight on drain-in) could not
            # complete within the autoscaler's budget. Once-latched; a
            # later COMPLETED scale event (kind="scale",
            # event="scale_out"/"drain_in") re-arms it.
            if "scale_stuck" in self._latched:
                return
            self._latched.add("scale_stuck")
            self._emit(HealthEvent(
                event="scale_stuck", severity=CRITICAL, step=step,
                message=(
                    f"autoscaler {rec.get('direction')} decision stuck "
                    f"after {rec.get('waited_s')}s "
                    f"(budget {rec.get('budget_s')}s): "
                    f"{rec.get('reason')}"
                ),
                data={
                    k: rec[k] for k in
                    ("direction", "replica", "reason", "waited_s",
                     "budget_s")
                    if k in rec
                },
            ))
        elif action == "publish_rollback":
            if "publish_rollback" in self._latched:
                return
            self._latched.add("publish_rollback")
            self._emit(HealthEvent(
                event="publish_rollback", severity=CRITICAL, step=step,
                message=(
                    f"publish transaction rolled back — every tenant "
                    f"stays on its pre-publish snapshot "
                    f"({rec.get('reason')})"
                ),
                data={
                    k: rec[k] for k in ("reason", "params_version")
                    if k in rec
                },
            ))

    def observe_feed(
        self,
        produced: int,
        consumed: int,
        producer_alive: bool = True,
        poisoned: int = 0,
        step: int = 0,
        waiting: bool = False,
        now: float | None = None,
    ) -> None:
        """Training-feed stall detection — the datapipe generalization of
        observe_queue: same ``queue_stall_s`` budget, but the watched
        counter is the PRODUCER's (a starving consumer with a stuck
        producer is the wedge; an idle feed with a full queue is healthy).
        Fed from ``kind="data"`` records; callable directly with an
        injectable clock for tests."""
        with self._lock:
            now = time.monotonic() if now is None else now
            if poisoned > self._poisoned_seen:
                self._poisoned_seen = poisoned
                self._emit(HealthEvent(
                    event="feed_poisoned", severity=CRITICAL, step=step,
                    message=(
                        f"input pipeline refused a poisoned batch "
                        f"(total {poisoned})"
                    ),
                    data={"poisoned": poisoned, "consumed": consumed},
                ))
            if not producer_alive:
                if "feed_dead" not in self._latched:
                    self._latched.add("feed_dead")
                    self._emit(HealthEvent(
                        event="feed_dead", severity=CRITICAL, step=step,
                        message=(
                            f"input-pipeline producer thread is dead at "
                            f"consumed={consumed}"
                        ),
                        data={"produced": produced, "consumed": consumed},
                    ))
                return
            self._latched.discard("feed_dead")
            advancing = self._last_fed is None or produced > self._last_fed
            if advancing or not waiting:
                self._feed_stall_since = None
                self._feed_stall_reported = False
            elif self._feed_stall_since is None:
                self._feed_stall_since = now
            elif (
                not self._feed_stall_reported
                and now - self._feed_stall_since >= self.queue_stall_s
            ):
                self._feed_stall_reported = True
                self._emit(HealthEvent(
                    event="feed_stall", severity=CRITICAL, step=step,
                    message=(
                        f"input pipeline stalled: produced counter stuck "
                        f"at {produced} for "
                        f"{now - self._feed_stall_since:.1f}s with the "
                        f"trainer waiting"
                    ),
                    data={"produced": produced, "consumed": consumed},
                ))
            self._last_fed = produced

    def observe_queue(
        self, queue_depth: int, served: int, now: float | None = None
    ) -> None:
        """Serving stall detection. Callable directly (the engine's emit
        path does) with an injectable clock for tests."""
        with self._lock:
            now = time.monotonic() if now is None else now
            if queue_depth <= 0 or (
                self._last_served is not None and served > self._last_served
            ):
                self._stall_since = None
                self._stall_reported = False
            elif self._stall_since is None:
                self._stall_since = now
            elif (
                not self._stall_reported
                and now - self._stall_since >= self.queue_stall_s
            ):
                self._stall_reported = True
                self._emit(HealthEvent(
                    event="queue_stall", severity=CRITICAL, step=served,
                    message=(
                        f"queue depth {queue_depth} with served counter "
                        f"stuck at {served} for "
                        f"{now - self._stall_since:.1f}s"
                    ),
                    data={"queue_depth": queue_depth, "served": served},
                ))
            self._last_served = served


# --- per-tenant SLOs: multi-window burn rates -------------------


@dataclasses.dataclass(frozen=True)
class SLOObjective:
    """One tenant's service-level objective.

    ``availability`` is the target GOOD fraction (error budget =
    1 - availability). A request is BAD when it errors (shed, rejected,
    deadline-missed, execution failure) or — with ``latency_ms`` set —
    when it completes slower than the threshold. Folding latency into
    the same budget is the standard "latency SLI as availability"
    spelling: one burn rate, one alert policy, for both failure modes.
    """

    availability: float = 0.99
    latency_ms: float | None = None

    def __post_init__(self):
        if not 0.0 < self.availability < 1.0:
            raise ValueError(
                f"availability must be in (0, 1), got {self.availability}"
            )

    @property
    def budget(self) -> float:
        return 1.0 - self.availability


class DiagnosticsCapture:
    """Auto-capture on an SLO CRITICAL: put the evidence on disk.

    Three artifacts, in decreasing order of certainty:

    * ``flight_recorder.json`` — the recorder's last-N window (metrics,
      health events, spans), when a recorder is attached.
    * ``slo_spans_<n>.json`` — a host-span snapshot from the tracker:
      the GUARANTEED artifact, written synchronously on every capture
      (CPU-honest — no profiler runtime required).
    * ``slo_profile_<n>/trace.json`` — a ``torch.profiler`` chrome trace
      (CPU and, on a CUDA build, CUDA activity) bracketing ``profile_s``
      seconds of whatever executes next, captured from a background
      thread so the caller (a serving worker or submit path) never
      blocks on it. Only one profiler can record in a process:
      a capture that finds one open (the trainer's ``--profile``
      window) keeps its span snapshot and appends the error to
      ``profile_errors``. ``profile=False``
      (the CLIs' default; ``--slo_profile`` asks for it) makes no
      attempt.
    """

    def __init__(
        self,
        out_dir,
        recorder=None,
        tracker=None,
        profile_s: float = 0.5,
        profile: bool = True,
    ):
        from pathlib import Path

        self.out_dir = Path(out_dir)
        self.recorder = recorder
        self._tracker = tracker
        self.profile_s = profile_s
        self.profile = profile
        self.captures = 0
        self.profile_errors: list[str] = []
        self._lock = threading.Lock()
        self._profiling = False

    def _get_tracker(self):
        if self._tracker is not None:
            return self._tracker
        from induction_network_on_fewrel_tpu_torch.obs.spans import get_tracker

        return get_tracker()

    def capture(self, reason: str) -> dict:
        """Run one capture; returns {flight_dump, span_snapshot, profile,
        profile_state} with paths (str) or None per artifact."""
        import json

        with self._lock:
            self.captures += 1
            n = self.captures
        self.out_dir.mkdir(parents=True, exist_ok=True)
        out: dict = {"reason": reason}
        if self.recorder is not None:
            out["flight_dump"] = str(self.recorder.dump(reason=reason))
        else:
            out["flight_dump"] = None
        snap_path = self.out_dir / f"slo_spans_{n}.json"
        snap_path.write_text(json.dumps({
            "reason": reason,
            "captured_unix_s": time.time(),
            "spans": self._get_tracker().snapshot(),
        }, default=str, indent=1))
        out["span_snapshot"] = str(snap_path)
        out["profile"], out["profile_state"] = self._start_profile(n)
        return out

    def _start_profile(self, n: int) -> tuple[str | None, str]:
        if not self.profile:
            return None, "disabled"
        with self._lock:
            if self._profiling:
                # One profile at a time: a second critical during the
                # capture window keeps its span snapshot + dump.
                return None, "already_capturing"
            self._profiling = True
        prof_dir = self.out_dir / f"slo_profile_{n}"

        def _run():
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            try:
                prof = torch.profiler.profile(activities=activities)
                prof.__enter__()
            except RuntimeError as e:       # another profiler is recording
                self.profile_errors.append(f"{type(e).__name__}: {e}")
                with self._lock:
                    self._profiling = False
                return
            try:
                time.sleep(self.profile_s)
            finally:
                prof.__exit__(None, None, None)
                prof_dir.mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(str(prof_dir / "trace.json"))
                with self._lock:
                    self._profiling = False

        # Non-daemon: the profiler must stop before the
        # interpreter tears down; the thread is bounded at ~profile_s.
        t = threading.Thread(target=_run, name=f"slo-profile-{n}")
        t.start()
        self._profile_thread = t
        return str(prof_dir), "started"

    def wait(self, timeout: float | None = None) -> None:
        """Join an in-flight profiler capture (tests / orderly shutdown)."""
        t = getattr(self, "_profile_thread", None)
        if t is not None and t.is_alive():
            t.join(timeout)


class _BurnWindow:
    """Running-sum time window: a deque of ``[bucket, good, bad]`` cells
    (touched buckets only) with maintained totals. ``add`` and ``counts``
    expire cells older than ``span`` buckets from the left, so reads are
    O(1) amortized and storage never scales with the window's cell
    capacity."""

    __slots__ = ("span", "cells", "good", "bad")

    def __init__(self, span: int):
        self.span = max(int(span), 1)
        self.cells: deque[list[float]] = deque()
        self.good = 0.0
        self.bad = 0.0

    def add(self, bucket: int, bad: bool) -> None:
        if self.cells and bucket < self.cells[-1][0]:
            # Clock went backwards across threads: fold into the newest
            # cell rather than corrupting the ascending-order invariant.
            bucket = int(self.cells[-1][0])
        if not self.cells or self.cells[-1][0] != bucket:
            self.cells.append([bucket, 0.0, 0.0])
        self.cells[-1][2 if bad else 1] += 1.0
        if bad:
            self.bad += 1.0
        else:
            self.good += 1.0
        self._expire(bucket)

    def _expire(self, bucket: int) -> None:
        while self.cells and self.cells[0][0] <= bucket - self.span:
            _, g, b = self.cells.popleft()
            self.good -= g
            self.bad -= b

    def counts(self, bucket: int) -> tuple[float, float]:
        """READ-ONLY window counts at ``bucket``: expired cells are
        subtracted without mutating state. Destructive expiry happens
        only in ``add`` (whose bucket comes from the engine's own
        monotonic clock) — a read with a wrong caller-supplied ``now``
        (e.g. wall clock against a monotonic t0) must not permanently
        delete still-valid SLO data, matching the old ring design's
        read-only reads. The window is ``(bucket - span, bucket]`` on
        BOTH sides — cells newer than the queried bucket are excluded
        too (the ring skipped ``b > at`` the same way), so a read with a
        stale ``now`` sees that moment's window, not all later traffic.
        Cost: O(out-of-range cells), usually zero (record-time expiry
        keeps the deque tight), bounded by span."""
        good, bad = self.good, self.bad
        for cell in self.cells:
            if cell[0] <= bucket - self.span:
                good -= cell[1]
                bad -= cell[2]
            else:
                break
        for cell in reversed(self.cells):
            if cell[0] > bucket:
                good -= cell[1]
                bad -= cell[2]
            else:
                break
        return good, bad


class SLOEngine:
    """Per-tenant SLO evaluation as multi-window burn rates.

    The SRE-standard alert shape: burn rate = (bad fraction over a
    window) / error budget. A burn of 1.0 spends the budget exactly over
    the SLO period; the FAST window (5m-equivalent) at a high threshold
    catches "the budget is vaporizing right now" (CRITICAL), the SLOW
    window (1h-equivalent) at a lower threshold catches sustained
    erosion (WARNING). Defaults are the classic 14.4x/6x pair.

    Mechanics:

    * ``record(tenant, latency_ms=..., error=...)`` per request outcome —
      ``ServingStats`` calls this from its existing recording points, so
      the engine's hot path gains no new locks beyond this object's own.
    * Outcomes land in fixed-width time buckets per tenant (ring of
      ``slow_window_s / bucket_s`` [good, bad] pairs — bounded memory per
      tenant, thousand-tenant soaks stay flat).
    * ``evaluate()`` sweeps tenants and emits once-latched events: a
      burning tenant is ONE incident until its fast window drops back
      under threshold (re-arm), not one critical per evaluation.
    * A fast-window CRITICAL triggers ``DiagnosticsCapture`` (flight
      dump + profiler-or-span-snapshot) exactly once per latch. The
      dump + span snapshot are SYNCHRONOUS on the evaluating thread by
      design: the evidence must be durable before the process can die
      of whatever is burning the budget, and the cost (tens of ms,
      once per incident) lands on one request of an already-burning
      tenant. Only the profiler leg backgrounds (it brackets future
      work by nature).
    * The clock is injectable everywhere (``now=``), like the watchdog's
      stall detectors, so tests and drills compress the "5m" windows to
      whatever wall-time they actually have.

    Scale: outcomes land in per-tenant
    **running-sum windows** (``_BurnWindow`` — a deque of touched bucket
    cells plus maintained good/bad totals, expired from the left as the
    bucket index advances), so one evaluate() sweep is O(tenants) and
    memory per tenant is O(touched buckets), never O(window cells). The
    old ring design allocated ``ceil(slow_window/bucket)`` cells per
    tenant up front and summed ``O(window cells)`` per sweep — a
    month-long slow window at 1 s buckets would have been 2.6M cells
    per tenant. Pinned cell-count-independent in
    tests/test_tracing.py::test_slo_evaluate_cell_count_independent.
    """

    MIN_COUNT = 10   # don't alert a window on fewer requests than this

    def __init__(
        self,
        objective: SLOObjective | None = None,
        fast_window_s: float = 300.0,
        slow_window_s: float = 3600.0,
        fast_burn: float = 14.4,
        slow_burn: float = 6.0,
        bucket_s: float | None = None,
        logger=None,
        recorder=None,
        capture: DiagnosticsCapture | None = None,
        on_event: Callable[[HealthEvent], None] | None = None,
    ):
        if slow_window_s < fast_window_s:
            raise ValueError(
                f"slow window ({slow_window_s}s) must be >= fast window "
                f"({fast_window_s}s)"
            )
        self.default_objective = objective or SLOObjective()
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        self.fast_burn = fast_burn
        self.slow_burn = slow_burn
        self.bucket_s = bucket_s or max(fast_window_s / 12.0, 1e-3)
        self._span_fast = int(math.ceil(fast_window_s / self.bucket_s))
        self._span_slow = int(math.ceil(slow_window_s / self.bucket_s))
        self.logger = logger
        self.recorder = recorder
        self.capture = capture
        self.on_event = on_event
        self._lock = threading.RLock()
        self._objectives: dict[str, SLOObjective] = {}
        # tenant -> {"fast"/"slow": _BurnWindow} running sums.
        self._windows: dict[str, dict[str, _BurnWindow]] = {}
        self.events: deque[HealthEvent] = deque(maxlen=512)
        self.tripped = False
        self._latched: set[str] = set()
        self.captured: dict[str, dict] = {}   # latch key -> capture result
        self._t0: float | None = None
        self._last_eval_bucket = -1

    # --- objectives -------------------------------------------------------

    def set_objective(self, tenant: str, objective: SLOObjective) -> None:
        with self._lock:
            self._objectives[tenant] = objective

    def objective_for(self, tenant: str) -> SLOObjective:
        return self._objectives.get(tenant, self.default_objective)

    # --- recording --------------------------------------------------------

    def _bucket_index(self, now: float) -> int:
        if self._t0 is None:
            self._t0 = now
        return int((now - self._t0) / self.bucket_s)

    def _tenant_windows(self, tenant: str) -> dict[str, _BurnWindow]:
        wins = self._windows.get(tenant)
        if wins is None:
            wins = self._windows[tenant] = {
                "fast": _BurnWindow(self._span_fast),
                "slow": _BurnWindow(self._span_slow),
            }
        return wins

    def record(
        self,
        tenant: str,
        latency_ms: float | None = None,
        error: bool = False,
        now: float | None = None,
    ) -> None:
        """One request outcome. ``error=True`` is always bad; otherwise
        the tenant's latency threshold (when set) decides."""
        now = time.monotonic() if now is None else now
        with self._lock:
            obj = self.objective_for(tenant)
            bad = error or (
                obj.latency_ms is not None
                and latency_ms is not None
                and latency_ms > obj.latency_ms
            )
            bucket = self._bucket_index(now)
            for win in self._tenant_windows(tenant).values():
                win.add(bucket, bad)

    # --- evaluation -------------------------------------------------------

    def _rates_locked(self, tenant: str, bucket: int) -> dict | None:
        """burn_rates' body, caller holds the lock — ONE source for the
        public per-tenant read and evaluate()'s all-tenant sweep, so the
        sweep acquires the lock once instead of re-entering the RLock per
        tenant (the last O(tenants) lock cost in the sweep after the
        running-sum windows; re-entrant acquires are cheap but
        not free, and a thousand-tenant sweep paid two per tenant)."""
        wins = self._windows.get(tenant)
        if wins is None:
            return None
        obj = self.objective_for(tenant)
        out = {"budget": obj.budget}
        for label in ("fast", "slow"):
            good, bad = wins[label].counts(bucket)
            total = good + bad
            frac = bad / total if total else 0.0
            out[f"total_{label}"] = int(total)
            out[f"bad_{label}"] = int(bad)
            out[f"burn_{label}"] = (
                round(frac / obj.budget, 3) if obj.budget > 0 else 0.0
            )
        return out

    def burn_rates(
        self, tenant: str, now: float | None = None
    ) -> dict | None:
        """{burn_fast, burn_slow, bad_fast, total_fast, ...} for a tenant
        with recorded traffic; None otherwise. O(1) amortized per window
        — the running sums are maintained at record time."""
        now = time.monotonic() if now is None else now
        with self._lock:
            return self._rates_locked(tenant, self._bucket_index(now))

    def tenants(self) -> tuple[str, ...]:
        """Tenants with recorded traffic, sorted — the autoscaler sweeps
        these for its max-burn pressure signal."""
        with self._lock:
            return tuple(sorted(self._windows))

    def evaluate(self, now: float | None = None) -> list[HealthEvent]:
        """Sweep every tenant's windows; emit (and return) new events.
        Cheap enough to call per stats emit; the serving engine also
        throttles it to once per bucket on the submit path.

        Lock discipline: judgments (window sums + latch transitions)
        happen under the lock; the EMISSION side effects — logger line,
        recorder event, diagnostics capture's file writes — run after
        releasing it. A capture at trip time writing the flight dump
        under this lock would stall every ``record()`` on the serving
        data plane for the duration, injecting the observer into the
        very incident it is documenting. The latch set (mutated under
        the lock) guarantees each event is claimed by exactly one
        evaluating thread."""
        now = time.monotonic() if now is None else now
        pending: list[tuple[HealthEvent, str]] = []
        with self._lock:
            # One lock acquisition and one bucket-index computation for
            # the WHOLE sweep (_rates_locked) — not two re-entrant
            # acquires and a clock quantization per tenant.
            bucket = self._bucket_index(now)
            for tenant in list(self._windows):
                rates = self._rates_locked(tenant, bucket)
                if rates is None:
                    continue
                pending.extend(self._judge(tenant, "fast", rates, CRITICAL,
                                           self.fast_burn))
                pending.extend(self._judge(tenant, "slow", rates, WARNING,
                                           self.slow_burn))
        for ev, latch in pending:
            self._emit(ev, latch)
        return [ev for ev, _ in pending]

    def maybe_evaluate(self, now: float | None = None) -> None:
        """evaluate() at most once per bucket width — the submit-path
        spelling (cheap steady-state: one int compare)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            bucket = self._bucket_index(now)
            if bucket == self._last_eval_bucket:
                return
            self._last_eval_bucket = bucket
        self.evaluate(now=now)

    def _judge(
        self, tenant: str, label: str, rates: dict, severity: str,
        threshold: float,
    ) -> list[tuple[HealthEvent, str]]:
        """Latch transition + event construction ONLY (call with the lock
        held); the caller emits after releasing the lock."""
        latch = f"slo_burn:{tenant}:{label}"
        burn = rates[f"burn_{label}"]
        total = rates[f"total_{label}"]
        if burn >= threshold and total >= self.MIN_COUNT:
            if latch in self._latched:
                return []
            self._latched.add(latch)
            ev = HealthEvent(
                event=f"slo_{label}_burn", severity=severity, step=total,
                message=(
                    f"tenant {tenant!r} burning its error budget "
                    f"{burn:.1f}x over the {label} window "
                    f"({rates[f'bad_{label}']}/{total} bad, "
                    f"budget {rates['budget']:.4g})"
                ),
                data={
                    "tenant": tenant,
                    f"burn_{label}": burn,
                    "burn_fast": rates["burn_fast"],
                    "burn_slow": rates["burn_slow"],
                    "bad": rates[f"bad_{label}"],
                    "total": total,
                },
            )
            return [(ev, latch)]
        if burn < threshold:
            self._latched.discard(latch)   # healthy window re-arms
        return []

    def _emit(self, ev: HealthEvent, latch: str) -> None:
        self.events.append(ev)
        if ev.severity == CRITICAL:
            self.tripped = True
        if self.recorder is not None:
            self.recorder.record_event(ev.to_dict())
        if self.logger is not None:
            self.logger.log(
                ev.step, kind="health", event=ev.event,
                severity=ev.severity, message=ev.message, **ev.data,
            )
        if ev.severity == CRITICAL:
            # Auto-capture: the whole point — the flight dump + profiler
            # (or host-span) evidence is on disk at trip time, once per
            # latch. Falls back to a bare recorder dump with no capture
            # configured.
            if self.capture is not None:
                self.captured[latch] = self.capture.capture(
                    reason=f"slo: {ev.message}"
                )
            elif self.recorder is not None:
                self.recorder.dump(reason=f"slo: {ev.message}")
        if self.on_event is not None:
            self.on_event(ev)
