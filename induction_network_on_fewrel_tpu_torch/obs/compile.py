"""Capture forensics: every CUDA-graph capture and kernel build observed,
stamped and attributed.

The counterpart of ``induction_network_on_fewrel_tpu/obs/compile.py``
(``CompileWatcher``). The port runs no XLA; what costs it seconds at a
shape it has not seen, and what must not happen in steady state, is a
graph capture or a kernel build. So the events a watcher counts are:

* each ``CapturedSteps`` capture (``train/steps.py``): the train graphs
  (``fn="train_step"``) and the eval graphs (``fn="eval_step"``), with the
  input signature as ``shapes``;
* each ``QueryGraphCache`` capture (``serving/buckets.py``,
  ``fn="serve_query"``, shapes "n_tier,bucket,dtype");
* each kernel build in ``kernels/build.py`` (``fn="build:<name>"``, the
  sources' hash as ``shapes``).

The sites call ``notify_capture(fn, shapes, elapsed_s)``; it fans out to
every installed watcher, which stamps one ``CompileRecord`` and one
``kind="compile"`` record with the JAX fields (fn, shapes, elapsed_ms,
trigger, phase, trace_id). The rules are the JAX watcher's
``_observe_compile``:

* ``phase`` is a novelty rule: the first event of a function name is
  ``warmup``; a seen name at a new signature is a ``recompile``; a seen
  (name, signature) pair again is a ``dup``.
* The gate (``steady_recompiles`` and the once-latched CRITICAL
  ``recompile_burst``, ``bind_health``) counts only recompiles observed
  after ``arm_steady()`` (the trainer arms at its first metric window)
  that cost at least ``gate_min_s``.
* ``trigger`` is the innermost open span on the observing thread
  (``obs/spans.py``) and ``trace_id`` its trace: a capture inside
  ``train/dispatch`` names the step that paid for it.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Callable


@dataclasses.dataclass
class CompileRecord:
    fn: str                  # the captured function or built kernel
    shapes: str              # input signature (sources' hash for a build)
    elapsed_s: float         # capture or build seconds
    trigger: str             # innermost open span, or "untraced"
    thread: str
    step: int                # last step stamped via observe_step()
    phase: str               # "warmup" | "recompile" | "dup"
    trace_id: str | None = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_active: set["CompileWatcher"] = set()
_dispatch_lock = threading.Lock()


def notify_capture(fn: str, shapes: str, elapsed_s: float) -> None:
    """One capture or build observed, on the thread that paid for it:
    fanned out to every installed watcher. With none installed, one set
    read."""
    if not _active:
        return
    with _dispatch_lock:
        watchers = list(_active)
    for w in watchers:
        w._observe_compile((fn, shapes), elapsed_s)


def signature(leaves) -> str:
    """A capture's input signature, as the JAX watcher's shapes string
    reads: ``name:dtype[shape]`` per (name, numpy array) leaf."""
    return ", ".join(f"{n}:{a.dtype}{list(a.shape)}" for n, a in leaves)


class CompileWatcher:
    """Bounded ring of CompileRecords + the steady-recompile gate.

    ``logger`` (a MetricsLogger) gets one ``kind="compile"`` record per
    event; ``on_recompile`` fires once-latched on the first gated
    steady-state recompile (``bind_health``)."""

    GATE_MIN_S = 0.05   # a gated recompile must cost at least this

    def __init__(self, logger=None, capacity: int = 256,
                 on_recompile: Callable[[CompileRecord], None] | None = None,
                 gate_min_s: float | None = None, tracker=None):
        self.logger = logger
        self.on_recompile = on_recompile
        self.gate_min_s = self.GATE_MIN_S if gate_min_s is None else gate_min_s
        self.records: deque[CompileRecord] = deque(maxlen=capacity)
        self.compiles = 0
        self.warmup_compiles = 0
        self.shape_variant_compiles = 0
        self.steady_recompiles = 0
        self.dup_compiles = 0
        self.compile_s_total = 0.0
        self.armed = False
        self._sigs: dict[str, set[str]] = {}   # fn -> seen signatures
        self._step = 0
        self._lock = threading.Lock()
        self._latched = False
        self._tracker = tracker

    # --- lifecycle --------------------------------------------------------

    def install(self) -> "CompileWatcher":
        """Start observing this process's captures and builds. Idempotent."""
        with _dispatch_lock:
            _active.add(self)
        return self

    def uninstall(self) -> None:
        with _dispatch_lock:
            _active.discard(self)

    def __enter__(self) -> "CompileWatcher":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # --- feeding ----------------------------------------------------------

    def observe_step(self, step: int) -> None:
        """Stamp the current training step onto subsequent records."""
        self._step = int(step)

    def _observe_compile(self, pending: tuple[str, str] | None, duration: float) -> None:
        fn, shapes = pending if pending else ("?", "")
        trigger, trace_id = self._attribution()
        with self._lock:
            self.compiles += 1
            self.compile_s_total += duration
            seen = self._sigs.get(fn)
            gated = False
            if seen is None:
                phase = "warmup"
                self.warmup_compiles += 1
                self._sigs[fn] = {shapes}
            elif shapes not in seen:
                phase = "recompile"
                self.shape_variant_compiles += 1
                seen.add(shapes)
                gated = self.armed and duration >= self.gate_min_s
                if gated:
                    self.steady_recompiles += 1
            else:
                phase = "dup"
                self.dup_compiles += 1
            rec = CompileRecord(fn=fn, shapes=shapes, elapsed_s=round(duration, 6),
                                trigger=trigger, thread=threading.current_thread().name,
                                step=self._step, phase=phase, trace_id=trace_id)
            self.records.append(rec)
            fire = gated and not self._latched
            if fire:
                self._latched = True
        if self.logger is not None:
            extra = {"trace_id": trace_id} if trace_id else {}
            self.logger.log(rec.step, kind="compile", fn=fn, shapes=shapes,
                            elapsed_ms=round(duration * 1e3, 3), trigger=trigger, phase=phase,
                            **extra)
        if fire and self.on_recompile is not None:
            self.on_recompile(rec)

    def arm_steady(self) -> None:
        """Begin steady state: from here a seen function at a new signature
        costing at least ``gate_min_s`` is a gated recompile."""
        self.armed = True

    def rearm(self) -> None:
        """Re-arm the once-latched recompile alert."""
        with self._lock:
            self._latched = False

    # --- reading ----------------------------------------------------------

    def _attribution(self) -> tuple[str, str | None]:
        tracker = self._tracker
        if tracker is None:
            from induction_network_on_fewrel_tpu_torch.obs.spans import get_tracker

            tracker = get_tracker()
        return tracker.open_span()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "compiles": self.compiles,
                "warmup_compiles": self.warmup_compiles,
                "shape_variant_compiles": self.shape_variant_compiles,
                "steady_recompiles": self.steady_recompiles,
                "dup_compiles": self.dup_compiles,
                "compile_s_total": round(self.compile_s_total, 4),
                "armed": self.armed,
                "records": [r.to_dict() for r in self.records],
            }


def bind_health(watcher: CompileWatcher, health_emit) -> None:
    """Wire the once-latched recompile burst into a HealthWatchdog-style
    emitter (``health_emit(HealthEvent)``)."""
    from induction_network_on_fewrel_tpu_torch.obs.health import CRITICAL, HealthEvent

    def _on(rec: CompileRecord) -> None:
        health_emit(HealthEvent(
            event="recompile_burst", severity=CRITICAL, step=rec.step,
            message=(f"steady-state recompile: {rec.fn} captured a NEW input signature "
                     f"mid-run ({rec.elapsed_s * 1e3:.1f} ms, trigger {rec.trigger})"),
            data={"fn": rec.fn, "trigger": rec.trigger,
                  "elapsed_ms": round(rec.elapsed_s * 1e3, 3),
                  "steady_recompiles": watcher.steady_recompiles},
        ))

    watcher.on_recompile = _on
