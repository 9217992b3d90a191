"""Shared counter/gauge registry + Prometheus text exposition.

A copy of ``induction_network_on_fewrel_tpu/obs/export.py``: the same
instruments and the same exposition text, byte for byte.

Before this layer, every execution path kept its own counters
(``serving/stats.py`` fields, trainer locals); the registry gives them one
namespace so a scrape — or the run report — sees train and serving through
the same model:

* ``counter(name)`` — monotonically increasing totals.
* ``gauge(name)`` — last-written values.
* ``gauge_fn(name, fn)`` — computed at render time (e.g. queue depth read
  from the live batcher instead of mirrored on every mutation).
* ``labeled_gauge(name)`` — a gauge FAMILY keyed by label set
  (``fleet_replica_qps{replica="r01"}``), the fleet rollup's per-replica
  exposition shape: one scrape shows every replica without
  minting one metric name per replica id.
* ``histogram(name)`` — bucketed distributions (serving latency), rendered
  as the standard ``_bucket``/``_sum``/``_count`` family. Each bucket
  remembers the most recent **exemplar trace_id** observed into it,
  emitted in OpenMetrics exemplar syntax — a scrape of the
  p99 bucket hands the operator a concrete traced request to pull the
  waterfall for, closing the metric -> trace loop.

``to_prometheus()`` renders the standard text exposition format
(``# TYPE``/``# HELP`` + one sample per line) so the output can be served
from any HTTP handler or dropped into a textfile collector; nothing here
imports an HTTP server or a client library. Exemplars use the
OpenMetrics spelling (`` # {trace_id="..."} value`` after a bucket
sample) — scrapers speaking only the legacy format should be pointed at
an OpenMetrics-capable endpoint when histograms are bound, or the
exemplars stripped (they appear ONLY on histogram ``_bucket`` lines).
"""

from __future__ import annotations

import re
import threading
from typing import Callable

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


class Counter:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with per-bucket exemplars.

    ``observe(v, exemplar=trace_id)`` increments the first bucket whose
    upper bound holds ``v`` (cumulative rendering happens at exposition
    time) and stamps that bucket's exemplar. Buckets are upper bounds in
    the metric's own unit; +Inf is implicit.
    """

    DEFAULT_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                  1000.0, 2500.0)

    __slots__ = ("bounds", "_counts", "_sum", "_total", "_exemplars", "_lock")

    def __init__(self, bounds: tuple[float, ...] = DEFAULT_MS):
        self.bounds = tuple(sorted(bounds))
        self._counts = [0] * (len(self.bounds) + 1)   # last = +Inf
        self._exemplars: list[tuple[str, float] | None] = (
            [None] * (len(self.bounds) + 1)
        )
        self._sum = 0.0
        self._total = 0
        self._lock = threading.Lock()

    def observe(self, v: float, exemplar: str | None = None) -> None:
        i = 0
        for i, b in enumerate(self.bounds):  # noqa: B007 — i used after
            if v <= b:
                break
        else:
            i = len(self.bounds)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._total += 1
            if exemplar is not None:
                self._exemplars[i] = (exemplar, float(v))

    @property
    def value(self) -> float:
        """Registry-snapshot scalar: the observation count (histograms
        render fully only in the Prometheus exposition)."""
        with self._lock:
            return float(self._total)

    def state(self) -> tuple[list[int], float, int, list]:
        with self._lock:
            return (
                list(self._counts), self._sum, self._total,
                list(self._exemplars),
            )


def _escape_label(v: str) -> str:
    """Label-value escaping per the exposition format: backslash,
    double-quote, and newline are the three characters with meaning
    inside a quoted label value."""
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


class GaugeFamily:
    """Labeled gauge family: one child value per unique
    label set, rendered as ``name{k="v",...} value`` — the shape the
    fleet rollup needs (``fleet_replica_qps{replica="r01"}``), where a
    plain Gauge would force one metric NAME per replica and break every
    dashboard aggregation. ``set`` is last-write-wins per label set
    (gauge semantics); ``remove`` retires a series (a drained replica
    must stop being scraped, not freeze at its last value)."""

    __slots__ = ("_children", "_lock")

    def __init__(self):
        self._children: dict[tuple[tuple[str, str], ...], float] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(labels: dict) -> tuple[tuple[str, str], ...]:
        if not labels:
            raise ValueError("a labeled gauge needs at least one label")
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        for k, _ in key:
            _check_name(k)
        return key

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._children[key] = float(value)

    def remove(self, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._children.pop(key, None)

    def state(self) -> dict[tuple[tuple[str, str], ...], float]:
        with self._lock:
            return dict(self._children)

    @property
    def value(self) -> float:
        """Registry-snapshot scalar: the live series count (the full
        family renders only in the Prometheus exposition)."""
        with self._lock:
            return float(len(self._children))


class CounterRegistry:
    """Named counters/gauges with idempotent registration: asking for the
    same name twice returns the same instrument, so independent modules
    (stats emitters, the trainer, tools) can share one registry without
    coordinating construction order."""

    def __init__(self, prefix: str = "induction"):
        self.prefix = _check_name(prefix)
        self._lock = threading.Lock()
        self._instruments: dict[str, Counter | Gauge] = {}
        self._fns: dict[str, Callable[[], float]] = {}
        self._help: dict[str, str] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, help, Counter)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, help, Gauge)

    def _get(self, name: str, help: str, cls):
        _check_name(name)
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                if name in self._fns:
                    raise ValueError(f"{name!r} already registered as gauge_fn")
                inst = self._instruments[name] = cls()
                self._help[name] = help
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"{name!r} already registered as {type(inst).__name__}"
                )
            return inst

    def histogram(
        self, name: str, bounds: tuple[float, ...] = Histogram.DEFAULT_MS,
        help: str = "",
    ) -> Histogram:
        """Bucketed distribution; idempotent like counter/gauge (the
        FIRST registration's bounds win — re-asking returns the existing
        instrument unchanged)."""
        _check_name(name)
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                if name in self._fns:
                    raise ValueError(f"{name!r} already registered as gauge_fn")
                inst = self._instruments[name] = Histogram(bounds)
                self._help[name] = help
            elif not isinstance(inst, Histogram):
                raise ValueError(
                    f"{name!r} already registered as {type(inst).__name__}"
                )
            return inst

    def labeled_gauge(self, name: str, help: str = "") -> GaugeFamily:
        """Labeled gauge family; idempotent like counter/gauge —
        re-asking returns the existing family, so the router's
        re-binds across restarts share one series table."""
        return self._get(name, help, GaugeFamily)

    def gauge_fn(self, name: str, fn: Callable[[], float], help: str = "") -> None:
        """Register a pull-style gauge evaluated at render time.
        Re-registration replaces the callback (latest wins) — a fresh
        ServingStats binding over a closed one must not raise."""
        _check_name(name)
        with self._lock:
            if name in self._instruments:
                raise ValueError(f"{name!r} already registered as instrument")
            self._fns[name] = fn
            self._help[name] = help

    def unregister(
        self, name: str, fn: Callable[[], float] | None = None,
        inst=None,
    ) -> None:
        """Drop an instrument or gauge_fn. Idempotent. Lets a closing
        component (e.g. ServingStats.unbind_registry) release the
        callbacks that would otherwise pin it in the global registry and
        keep rendering stale values after its engine is gone. With ``fn``
        (or ``inst`` for push instruments like histograms), removal is
        identity-checked: a closing engine must not delete the live
        instrument a successor engine re-registered under the same name."""
        with self._lock:
            if fn is not None:
                if self._fns.get(name) is fn:
                    self._fns.pop(name)
                    self._help.pop(name, None)
                return
            if inst is not None:
                if self._instruments.get(name) is inst:
                    self._instruments.pop(name)
                    self._help.pop(name, None)
                return
            self._instruments.pop(name, None)
            self._fns.pop(name, None)
            self._help.pop(name, None)

    # --- reading ---------------------------------------------------------

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            insts = dict(self._instruments)
            fns = dict(self._fns)
        out = {name: inst.value for name, inst in insts.items()}
        for name, fn in fns.items():
            try:
                out[name] = float(fn())
            except Exception:
                out[name] = float("nan")  # a dead callback must not kill a scrape
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (one metric family per instrument)."""
        with self._lock:
            insts = dict(self._instruments)
            fns = dict(self._fns)
            helps = dict(self._help)
        lines = []
        values = self.snapshot()
        for name in sorted(values):
            full = f"{self.prefix}_{name}"
            inst = insts.get(name)
            if isinstance(inst, Histogram):
                if helps.get(name):
                    lines.append(f"# HELP {full} {helps[name]}")
                lines.append(f"# TYPE {full} histogram")
                counts, total_sum, total, exemplars = inst.state()
                cum = 0
                for i, bound in enumerate((*inst.bounds, float("inf"))):
                    cum += counts[i]
                    le = "+Inf" if bound == float("inf") else f"{bound:g}"
                    line = f'{full}_bucket{{le="{le}"}} {cum}'
                    ex = exemplars[i]
                    if ex is not None:
                        # OpenMetrics exemplar: the last traced request
                        # that landed in this bucket — scrape-to-waterfall.
                        line += f' # {{trace_id="{ex[0]}"}} {ex[1]:g}'
                    lines.append(line)
                lines.append(f"{full}_sum {total_sum:g}")
                lines.append(f"{full}_count {total}")
                continue
            if isinstance(inst, GaugeFamily):
                if helps.get(name):
                    lines.append(f"# HELP {full} {helps[name]}")
                lines.append(f"# TYPE {full} gauge")
                for key, v in sorted(inst.state().items()):
                    lbl = ",".join(
                        f'{k}="{_escape_label(val)}"' for k, val in key
                    )
                    lines.append(f"{full}{{{lbl}}} {v:g}")
                continue
            mtype = "counter" if isinstance(inst, Counter) else "gauge"
            if name in fns:
                mtype = "gauge"
            if helps.get(name):
                lines.append(f"# HELP {full} {helps[name]}")
            lines.append(f"# TYPE {full} {mtype}")
            lines.append(f"{full} {values[name]:g}")
        return "\n".join(lines) + "\n"


# Process-global registry: integration points (ServingStats, the trainer)
# default to it, mirroring the global span tracker in obs/spans.py.
_GLOBAL = CounterRegistry()


def get_registry() -> CounterRegistry:
    return _GLOBAL


def set_registry(reg: CounterRegistry) -> CounterRegistry:
    global _GLOBAL
    prev, _GLOBAL = _GLOBAL, reg
    return prev
