"""Online step-time decomposition: where every wall second of a training
window went, with named causes when a window goes out of band.

The counterpart of ``induction_network_on_fewrel_tpu/obs/perf.py``
(``PerfObserver``), with the same tiles, baseline, classifier and record.
Per metric window, wall-clock time decomposes into host-observed segments
that tile the window by construction:

* ``data_wait``      — ``train/sample`` spans (the loop waiting on input)
* ``host_dispatch``  — ``train/dispatch`` spans
* ``device_sync``    — ``train/metrics_fetch`` spans
* ``checkpoint`` / ``eval`` / ``probe`` — their spans at val boundaries
* ``other``          — window − sum(tracked), so the tiles sum to the
                       measured window exactly, every window.

On the card the tiles map onto the work so: a training call is one
CUDA-graph replay (``train/steps.py``), and ``train/dispatch`` is only
the host time to fill the pinned inputs, copy them in and enqueue the
replay; the kernels run after the call returns. The device time of the
window surfaces where the host first waits for it: the window's one
metric fetch (``train/metrics_fetch``, a sync per window), or an earlier
host wait (the pinned buffers' copy event, the val boundary). So
``device_sync`` is the card's compute not overlapped with the host, and
``host_dispatch`` the host's enqueue cost; no sync is added or moved to
make the tiles read otherwise. On the CPU the step runs inside the
dispatch span.

Overlapping context (recorded, never tiled): ``compile_ms``/``compiles``
from the capture watcher (``obs/compile.py``: graph captures and kernel
builds) and ``gc_ms`` from a ``gc.callbacks`` pause meter.

Out-of-band classification: a rolling-median baseline of per-window step
time; a window slower than ``oob_factor`` x baseline is classified into
one cause, in priority order: ``recompile_burst`` (captures or builds in
the window explain a material share of the excess), ``feed_stall``,
``checkpoint_spike``, ``gc_pause``, ``neighbor_contention`` (the
residual). Each is a once-latched CRITICAL ``perf_regression`` health
event with auto-captured diagnostics; a window back in band re-arms.

The observer adds no per-step work: one ``observe_window`` per metric
window reads the window's spans off the ring (newest first).
"""

from __future__ import annotations

import gc
import math
import threading
import time
from collections import deque
from typing import Callable

# Span name -> tiled segment. Unmapped top-level spans (rare) fall into
# ``other`` implicitly — the residual definition keeps the tiling exact no
# matter what runs on the loop thread.
SEGMENT_OF = {
    "train/sample": "data_wait",
    "train/dispatch": "host_dispatch",
    "train/metrics_fetch": "device_sync",
    "train/checkpoint": "checkpoint",
    "train/eval": "eval",
    "train/grad_probe": "probe",
}
TILE_SEGMENTS = (
    "data_wait", "host_dispatch", "device_sync", "checkpoint", "eval",
    "probe", "other",
)
CAUSES = (
    "recompile_burst", "feed_stall", "checkpoint_spike", "gc_pause",
    "neighbor_contention",
)


class GcPauseMeter:
    """Accumulated collector pause seconds via ``gc.callbacks`` — the only
    honest way to see GC stalls from inside the process. Global (the
    collector is); ``total_s`` is read-diffed per window."""

    def __init__(self):
        self.total_s = 0.0
        self.collections = 0
        self._t0: float | None = None
        self._installed = False

    def _cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.monotonic()
        elif phase == "stop" and self._t0 is not None:
            self.total_s += time.monotonic() - self._t0
            self.collections += 1
            self._t0 = None

    def install(self) -> "GcPauseMeter":
        if not self._installed:
            gc.callbacks.append(self._cb)
            self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            try:
                gc.callbacks.remove(self._cb)
            except ValueError:
                pass
            self._installed = False


class PerfObserver:
    """Per-window step-time decomposition over the host span ring.

    ``tracker`` defaults to the process-global SpanTracker; ``logger``
    receives one ``kind="perf"`` record per window; ``compile_watcher``
    (obs/compile.CompileWatcher) supplies the in-window compile context;
    ``capture`` (obs/health.DiagnosticsCapture) auto-captures on the
    first window of each out-of-band episode; ``on_event`` additionally
    receives the HealthEvent (the cli wires the watchdog's emitter so
    perf events ride the same health stream + flight recorder).
    ``floor_ms`` is the shared roofline projection for one step
    (utils/roofline.projected_floor_ms at the deployment's calibration)
    — recorded next to the measured decomposition so "how far off the
    analytic floor is this config running" is a stream field.
    """

    def __init__(
        self,
        logger=None,
        tracker=None,
        compile_watcher=None,
        capture=None,
        on_event: Callable | None = None,
        oob_factor: float = 1.5,
        baseline_window: int = 8,
        baseline_warmup: int = 2,
        floor_ms: float | None = None,
        feed_stall_frac: float = 0.25,
        checkpoint_frac: float = 0.25,
        gc_frac: float = 0.25,
    ):
        if tracker is None:
            from induction_network_on_fewrel_tpu_torch.obs.spans import get_tracker

            tracker = get_tracker()
        self._tracker = tracker
        self.logger = logger
        self._compile = compile_watcher
        self.capture = capture
        self.on_event = on_event
        self.oob_factor = oob_factor
        self.baseline_warmup = baseline_warmup
        self.floor_ms = floor_ms
        self._feed_stall_frac = feed_stall_frac
        self._checkpoint_frac = checkpoint_frac
        self._gc_frac = gc_frac
        self.gc_meter = GcPauseMeter().install()
        self._step_ms = deque(maxlen=baseline_window)
        # The FIRST window contains the step compile (seconds of one-time
        # cost) and must not seed the baseline — an inflated baseline
        # blinds the out-of-band detector for the rest of the run (the
        # watchdog's throughput_warmup rationale, applied here).
        self._skip_baseline = 1
        self._mark: float | None = None      # tracker-timeline window start
        self._last_step: int | None = None
        self._last_compiles = 0
        self._last_compile_s = 0.0
        self._last_gc_s = 0.0
        self._last_gc_n = 0
        self._last_evicted = 0
        self._thread: str | None = None
        self._latched: str | None = None     # active out-of-band cause
        self.windows = 0
        self.last_tiles: tuple[float, dict] | None = None
        self.events: list = []
        self.captured: dict[str, dict] = {}

    # --- lifecycle --------------------------------------------------------

    def begin(self, step: int) -> None:
        """Open the first window at loop entry (the trainer calls this
        once; ``observe_window`` then closes/reopens per metric window).
        Binds the observer to the CALLING thread — only that thread's
        spans tile its windows (the producer/serving threads have their
        own timelines)."""
        self._mark = time.monotonic() - self._tracker._t0
        self._last_step = int(step)
        self._thread = threading.current_thread().name
        if self._compile is not None:
            self._last_compiles = self._compile.compiles
            self._last_compile_s = self._compile.compile_s_total
        self._last_gc_s = self.gc_meter.total_s
        self._last_gc_n = self.gc_meter.collections
        self._last_evicted = self._tracker.evicted

    def close(self) -> None:
        self.gc_meter.uninstall()

    # --- the per-window observation --------------------------------------

    def _segment_sums(self, w0: float, w1: float) -> dict[str, float]:
        """Clipped per-segment span seconds inside [w0, w1] on the bound
        thread, top-level spans only (depth 0 — children re-state their
        parent's time). The ring is walked from its newest span back to
        the bound thread's first span that ended by ``w0``: one thread's
        spans enter the ring in the order they end, so nothing older can
        reach into the window, and a window costs its own spans rather
        than the ring's capacity (the JAX observer copies and scans the
        whole ring)."""
        sums = {s: 0.0 for s in TILE_SEGMENTS}
        tracker = self._tracker
        with tracker._lock:
            ring, newest = tracker._ring, tracker._next_slot - 1
            n = len(ring)
            for i in range(n):
                s = ring[(newest - i) % n]
                if s.thread != self._thread:
                    continue
                end = s.start_s + s.dur_s
                if end <= w0:
                    break
                seg = SEGMENT_OF.get(s.name) if s.depth == 0 else None
                if seg is None:
                    continue
                lo = max(s.start_s, w0)
                hi = min(end, w1)
                if hi > lo:
                    sums[seg] += hi - lo
        return sums

    def observe_window(self, step: int) -> dict | None:
        """Close the current window at ``step``; emit the kind="perf"
        record; classify if out of band. Returns the record dict (None
        before ``begin``)."""
        if self._mark is None or self._last_step is None:
            return None
        now = time.monotonic() - self._tracker._t0
        w0, w1 = self._mark, now
        steps = int(step) - self._last_step
        self._mark, self._last_step = now, int(step)
        window_s = w1 - w0
        if steps <= 0 or window_s <= 0:
            return None
        sums = self._segment_sums(w0, w1)
        tracked = sum(sums.values())
        # The tiling invariant: other := window − tracked. Tracked spans
        # are disjoint (same thread, depth 0, clipped), so tracked <=
        # window up to clock granularity; clamp shields the subtraction
        # from sub-microsecond rounding.
        sums["other"] = max(0.0, window_s - tracked)
        self.last_tiles = (window_s, dict(sums))      # unrounded, for exact checks
        step_ms = window_s * 1e3 / steps
        # Overlapping context: compiles + GC pauses inside the window.
        win_compiles, compile_ms = 0, 0.0
        if self._compile is not None:
            win_compiles = self._compile.compiles - self._last_compiles
            compile_ms = (
                self._compile.compile_s_total - self._last_compile_s
            ) * 1e3
            self._last_compiles = self._compile.compiles
            self._last_compile_s = self._compile.compile_s_total
        gc_ms = (self.gc_meter.total_s - self._last_gc_s) * 1e3
        gc_n = self.gc_meter.collections - self._last_gc_n
        self._last_gc_s = self.gc_meter.total_s
        self._last_gc_n = self.gc_meter.collections
        evicted = self._tracker.evicted - self._last_evicted
        self._last_evicted = self._tracker.evicted

        baseline = None
        if len(self._step_ms) >= self.baseline_warmup:
            ordered = sorted(self._step_ms)
            baseline = ordered[len(ordered) // 2]
        rec = {
            "window_s": round(window_s, 6),
            "steps": float(steps),
            "step_ms": round(step_ms, 4),
            **{
                f"{seg}_ms": round(sums[seg] * 1e3, 3)
                for seg in TILE_SEGMENTS
            },
            "segments_sum_ms": round(
                sum(sums.values()) * 1e3, 3
            ),
            "compiles": float(win_compiles),
            "compile_ms": round(compile_ms, 3),
            "gc_ms": round(gc_ms, 3),
            "gc_collections": float(gc_n),
        }
        if evicted:
            # Ring overflow DURING THIS WINDOW may undercount its tracked
            # spans (the loss lands in ``other``); flagged per window as
            # a delta — the cumulative counter would permanently flag
            # every window after the ring's first wrap.
            rec["ring_evicted"] = float(evicted)
        if baseline is not None:
            rec["baseline_step_ms"] = round(baseline, 4)
        if self.floor_ms is not None:
            rec["floor_ms"] = round(self.floor_ms, 4)
            # Compute-facing time per step vs the analytic floor: how far
            # off the roofline this window ran (large on the CPU).
            dev_ms = (
                (sums["host_dispatch"] + sums["device_sync"]) * 1e3 / steps
            )
            if self.floor_ms > 0:
                rec["device_over_floor"] = round(dev_ms / self.floor_ms, 3)
        oob = (
            baseline is not None
            and math.isfinite(step_ms)
            and step_ms > self.oob_factor * baseline
        )
        rec["oob"] = float(oob)
        cause = None
        if oob:
            excess_ms = (step_ms - baseline) * steps
            cause = self._classify(
                sums, window_s, win_compiles, gc_ms, compile_ms, excess_ms
            )
            rec["cause"] = cause
        else:
            # In-band (or warmup) window: re-arm (the episode ended) and
            # feed the baseline — an out-of-band window must not drag the
            # baseline up with it (the watchdog's discipline). The
            # compile-bearing first window is skipped entirely.
            self._latched = None
            if self._skip_baseline > 0:
                self._skip_baseline -= 1
            else:
                self._step_ms.append(step_ms)
        self.windows += 1
        # Record BEFORE classifying/capturing: a critical's flight dump
        # must contain the perf window that tripped it (the recorder-
        # before-watchdog ordering discipline, obs/recorder.py).
        if self.logger is not None:
            self.logger.log(int(step), kind="perf", **rec)
        if cause is not None:
            self._maybe_event(int(step), cause, rec, baseline)
        return rec

    def _classify(
        self, sums: dict, window_s: float, win_compiles: int,
        gc_ms: float, compile_ms: float, excess_ms: float,
    ) -> str:
        # Compiles take the blame only when they EXPLAIN a material share
        # of the window's excess over baseline — the obs/compile.py
        # gate_min_s discipline, restated for classification: a ~10 ms
        # utility-pjit shape variant at an eval boundary must not mask a
        # feed stall that actually cost the window (a real step-function
        # recompile is seconds and passes trivially).
        if win_compiles > 0 and compile_ms >= 0.25 * excess_ms:
            return "recompile_burst"
        if sums["data_wait"] / window_s > self._feed_stall_frac:
            return "feed_stall"
        if sums["checkpoint"] / window_s > self._checkpoint_frac:
            return "checkpoint_spike"
        if gc_ms / 1e3 / window_s > self._gc_frac:
            return "gc_pause"
        return "neighbor_contention"

    def _maybe_event(
        self, step: int, cause: str, rec: dict, baseline: float
    ) -> None:
        """Once-latched CRITICAL per out-of-band EPISODE: consecutive
        out-of-band windows are one incident (even if the classifier
        refines the cause mid-episode); an in-band window re-arms."""
        if self._latched is not None:
            return
        self._latched = cause
        from induction_network_on_fewrel_tpu_torch.obs.health import (
            CRITICAL,
            HealthEvent,
        )

        ev = HealthEvent(
            event="perf_regression", severity=CRITICAL, step=step,
            message=(
                f"step time {rec['step_ms']:.2f} ms out of band "
                f"(baseline {baseline:.2f} ms, factor "
                f"{rec['step_ms'] / baseline:.2f}x) — cause: {cause}"
            ),
            data={
                "cause": cause,
                "step_ms": rec["step_ms"],
                "baseline_step_ms": round(baseline, 4),
                "data_wait_ms": rec["data_wait_ms"],
                "compile_ms": rec["compile_ms"],
                "checkpoint_ms": rec["checkpoint_ms"],
                "gc_ms": rec["gc_ms"],
            },
        )
        self.events.append(ev)
        if self.on_event is not None:
            self.on_event(ev)
        if self.capture is not None:
            self.captured[f"perf:{cause}:{step}"] = self.capture.capture(
                reason=f"perf: {ev.message}"
            )
