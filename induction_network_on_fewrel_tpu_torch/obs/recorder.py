"""Flight recorder: the last N telemetry records kept in memory, dumped on
an incident.

The counterpart of ``induction_network_on_fewrel_tpu/obs/recorder.py``.
The recorder holds bounded rings of recent metric records and health
events, plus the span window of the tracker, and writes one
``flight_recorder.json`` when something goes wrong: a crash (``armed()``),
SIGTERM, or a watchdog trip (``obs/health.py`` dumps on critical events).
Everything is bounded: a week-long soak costs the memory of a smoke test.
"""

from __future__ import annotations

import contextlib
import json
import signal
import threading
import time
from collections import deque
from pathlib import Path

from induction_network_on_fewrel_tpu_torch.utils.metrics import json_sanitize


class FlightRecorder:
    def __init__(self, out_dir: str | Path | None = None, tracker=None,
                 max_metrics: int = 512, max_events: int = 256):
        """``out_dir``: where ``flight_recorder.json`` lands (the cwd at
        dump time when None). ``tracker``: the SpanTracker whose window the
        dumps include (default: the process-global one)."""
        self.out_dir = Path(out_dir) if out_dir is not None else None
        self._tracker = tracker
        self._metrics: deque = deque(maxlen=max_metrics)
        self._events: deque = deque(maxlen=max_events)
        # RLock: the SIGTERM handler runs dump() on the main thread between
        # bytecodes, possibly inside record_metric on the same thread.
        self._lock = threading.RLock()
        self._t0 = time.monotonic()
        self.dump_count = 0
        self.last_dump_path: Path | None = None
        self._prev_sigterm = None

    def record_metric(self, rec: dict) -> None:
        """MetricsLogger hook: retain the most recent metric records."""
        with self._lock:
            self._metrics.append(rec)

    def record_event(self, event: dict) -> None:
        with self._lock:
            self._events.append(event)

    def _tracker_snapshot(self) -> list[dict]:
        tracker = self._tracker
        if tracker is None:
            from induction_network_on_fewrel_tpu_torch.obs.spans import get_tracker

            tracker = get_tracker()
        return tracker.snapshot()

    def dump(self, reason: str, path: str | Path | None = None) -> Path:
        """Write flight_recorder.json (tmp + rename) and return its path; a
        later dump overwrites it, ``dump_count`` counts them."""
        with self._lock:
            payload = {
                "reason": reason,
                "uptime_s": round(time.monotonic() - self._t0, 3),
                "dumped_unix_s": time.time(),
                "dump_count": self.dump_count + 1,
                "events": list(self._events),
                # Records carry raw floats (the watchdog needs them); the dump
                # stays strict JSON.
                "metrics": [{k: json_sanitize(v) for k, v in m.items()} for m in self._metrics],
                "spans": self._tracker_snapshot(),
            }
            self.dump_count += 1
        out = Path(path) if path is not None else (
            (self.out_dir or Path(".")) / "flight_recorder.json")
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(payload, default=str, indent=1))
        tmp.replace(out)
        self.last_dump_path = out
        return out

    @contextlib.contextmanager
    def armed(self, reason_prefix: str = "crash"):
        """Dump on any exception escaping the block, then re-raise
        (KeyboardInterrupt too: an interrupted soak is when the window
        matters)."""
        try:
            yield self
        except BaseException as e:
            self.dump(reason=f"{reason_prefix}: {type(e).__name__}: {e}")
            raise

    def install_sigterm_handler(self) -> bool:
        """Dump on SIGTERM, then chain to the previous handler (or the
        default exit). Main thread only; returns False elsewhere."""
        if threading.current_thread() is not threading.main_thread():
            return False

        def _handler(signum, frame):
            self.dump(reason="SIGTERM")
            prev = self._prev_sigterm
            if callable(prev):
                prev(signum, frame)
            else:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                signal.raise_signal(signal.SIGTERM)

        self._prev_sigterm = signal.signal(signal.SIGTERM, _handler)
        return True

    def uninstall_sigterm_handler(self) -> None:
        """Put back the handler ``install_sigterm_handler`` replaced (a
        process that runs several CLI calls, as the tests do)."""
        if self._prev_sigterm is not None \
                and threading.current_thread() is threading.main_thread():
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None
