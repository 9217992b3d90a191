"""Host-side spans: the timing half of the telemetry spine.

The counterpart of ``induction_network_on_fewrel_tpu/obs/spans.py``. A
span is one timed region of host code (sampling, dispatch, eval, a
serving batch). Spans nest per thread, carry attributes, and land in a
fixed-capacity ring: a long soak never grows host memory, and the flight
recorder (``obs/recorder.py``) can always dump the most recent window.

The bridge to the device side is NVTX, where the JAX package's is
``jax.named_scope``: a tracker bound to a CUDA device (``bind_device``)
opens ``torch.cuda.nvtx.range_push(name)`` with each span and pops it at
exit, so the kernels a span launches sit under the same name in a
``torch.profiler`` (or Nsight) timeline: "train/dispatch",
"serve/execute". The binding is explicit and follows the device: a
tracker bound to the CPU (or never bound) makes no NVTX call, because a
CPU build of torch has no NVTX library. While a ``torch.profiler`` profile
records (the trainer's ``--profile`` window, ``utils/profiling.trace``),
the same span also opens a ``record_function`` of its name, so the
profiler's chrome trace carries the span as an annotation row above the
kernels it launched (Kineto records no NVTX ranges). ``nvtx=False`` on
one span skips both for pure host code (serving's tokenization).

Request-scoped tracing rides on the same ring:

* Every span carries a ``span_id`` (allocated at entry, so children can
  name their parent) and, under an active trace context, a ``trace_id``
  that ties spans together across threads (a serving request is admitted
  on a client thread and executed on the batcher's worker).
* ``TraceContext`` is the handle that crosses threads: stash it on the
  unit of work, then ``tracker.trace(ctx)`` in the worker.
* ``links`` records fan-in: one batch-execute span names every request
  trace id it served.
* ``TraceSampler`` is the deterministic 1-in-N head sampler; rate 0
  returns None after one attribute test and allocates nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import os
import threading
import time
from typing import Any, Callable, Iterator

import torch


class TraceContext:
    """The cross-thread trace handle: the trace id plus the span id of the
    originating span (0 = none yet; the first span opened under a fresh
    context fills it in)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: int = 0):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_id!r}, span_id={self.span_id})"


_TRACE_IDS = itertools.count(1)
_TRACE_PREFIX = f"{os.getpid() & 0xFFFF:04x}"


def new_trace_id() -> str:
    """Process-unique trace id: pid prefix + a counter."""
    return f"{_TRACE_PREFIX}-{next(_TRACE_IDS):08x}"


class TraceSampler:
    """Deterministic head sampler: trace every ``round(1/rate)``-th call.
    ``rate <= 0`` pins ``stride = 0`` and ``maybe_trace`` returns None with
    no counter advance and no allocation; ``rate >= 1`` traces every call."""

    __slots__ = ("rate", "stride", "_count")

    def __init__(self, rate: float):
        self.rate = max(0.0, float(rate))
        self.stride = 0 if self.rate <= 0 else max(1, round(1.0 / self.rate))
        # itertools.count.__next__ is atomic under the GIL: submitters on
        # many threads share the sampler without a lock.
        self._count = itertools.count() if self.stride else None

    def maybe_trace(self) -> TraceContext | None:
        if not self.stride:
            return None
        if next(self._count) % self.stride:
            return None
        return TraceContext(new_trace_id())


@dataclasses.dataclass
class Span:
    """One completed span; ``start_s`` is on the tracker's monotonic
    timeline."""

    name: str
    start_s: float
    dur_s: float
    depth: int                 # 0 = top-level in its thread
    parent: str | None         # enclosing span's name, if any
    thread: str
    span_id: int
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)
    trace_id: str | None = None
    parent_id: int | None = None  # enclosing span's id, or the originating
    #                               span across threads
    links: tuple[str, ...] = ()   # fan-in: trace ids merged into this span

    def to_dict(self) -> dict:
        d = {"name": self.name, "start_s": round(self.start_s, 6),
             "dur_s": round(self.dur_s, 6), "depth": self.depth, "parent": self.parent,
             "thread": self.thread, "span_id": self.span_id}
        if self.trace_id is not None:
            d["trace_id"] = self.trace_id
        if self.parent_id is not None:
            d["parent_id"] = self.parent_id
        if self.links:
            d["links"] = list(self.links)
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class SpanTracker:
    """Thread-safe ring of completed spans + per-thread nesting. The ring
    holds the newest ``capacity`` spans; ``evicted`` counts the rest."""

    def __init__(self, capacity: int = 4096, device=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.identity: dict[str, object] = {}
        # RLock: the flight recorder's SIGTERM dump snapshots this tracker
        # from a signal handler that may interrupt _append on this thread.
        self._lock = threading.RLock()
        self._ring: list[Span] = []
        self._next_slot = 0
        self.evicted = 0
        self._ids = itertools.count(1)      # 0 means "no originating span"
        self._tls = threading.local()
        self._t0 = time.monotonic()
        self.nvtx = False
        self.bind_device(device)

    def bind_device(self, device) -> None:
        """Open an NVTX range with every span when ``device`` is a CUDA
        device; none for the CPU or None."""
        self.nvtx = device is not None and torch.device(device).type == "cuda"

    def set_identity(self, role: str, replica: str | None = None) -> None:
        """Stamp proc_role/proc_pid (and proc_replica) on snapshot() output,
        the fields ``MetricsLogger.set_identity`` stamps on records."""
        ident: dict[str, object] = {"proc_role": str(role), "proc_pid": os.getpid()}
        if replica is not None:
            ident["proc_replica"] = str(replica)
        self.identity = ident

    # --- recording -------------------------------------------------------

    def _stack(self) -> list[tuple[str, int]]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _append(self, span: Span) -> None:
        with self._lock:
            if len(self._ring) < self.capacity:
                self._ring.append(span)
            else:
                self._ring[self._next_slot] = span
                self._next_slot = (self._next_slot + 1) % self.capacity
                self.evicted += 1

    # --- trace context ---------------------------------------------------

    def current_trace(self) -> TraceContext | None:
        return getattr(self._tls, "ctx", None)

    def set_trace(self, ctx: TraceContext | None) -> TraceContext | None:
        """Replace the thread's trace context; returns the previous one."""
        prev = getattr(self._tls, "ctx", None)
        self._tls.ctx = ctx
        return prev

    def new_context(self) -> TraceContext:
        return TraceContext(new_trace_id())

    @contextlib.contextmanager
    def trace(self, ctx: TraceContext | None = None) -> Iterator[TraceContext]:
        """Spans opened inside the block (on this thread) carry ``ctx``'s
        trace id; a fresh trace when ``ctx`` is None."""
        ctx = ctx if ctx is not None else self.new_context()
        prev = self.set_trace(ctx)
        try:
            yield ctx
        finally:
            self.set_trace(prev)

    @contextlib.contextmanager
    def span(self, name: str, links: tuple[str, ...] = (), nvtx: bool = True,
             **attrs: Any) -> Iterator[dict]:
        """Time a region; yields the attrs dict so the body can attach
        results. ``links``: trace ids merged into this span. ``nvtx=False``
        skips the NVTX range (pure host code)."""
        stack = self._stack()
        span_id = next(self._ids)
        ctx = getattr(self._tls, "ctx", None)
        if stack:
            parent, parent_id = stack[-1]
        else:
            parent = None
            parent_id = ctx.span_id if ctx is not None and ctx.span_id else None
        if ctx is not None and not ctx.span_id:
            ctx.span_id = span_id
        stack.append((name, span_id))
        ranged = self.nvtx and nvtx
        if ranged:
            torch.cuda.nvtx.range_push(name)
        annotation = None
        if nvtx and torch.autograd._profiler_enabled():
            annotation = torch.profiler.record_function(name)
            annotation.__enter__()
        t0 = time.monotonic()
        try:
            yield attrs
        finally:
            dur = time.monotonic() - t0
            if annotation is not None:
                annotation.__exit__(None, None, None)
            if ranged:
                torch.cuda.nvtx.range_pop()
            stack.pop()
            self._append(Span(
                name=name, start_s=t0 - self._t0, dur_s=dur, depth=len(stack), parent=parent,
                thread=threading.current_thread().name, span_id=span_id, attrs=attrs,
                trace_id=ctx.trace_id if ctx is not None else None, parent_id=parent_id,
                links=tuple(links),
            ))

    def wrap(self, name: str | None = None) -> Callable:
        """Decorator form: ``@tracker.wrap("train/probe")``."""
        def deco(fn):
            span_name = name or fn.__qualname__

            @functools.wraps(fn)
            def inner(*args, **kw):
                with self.span(span_name):
                    return fn(*args, **kw)

            return inner

        return deco

    def open_span(self) -> tuple[str, str | None]:
        """(innermost open span on this thread or "untraced", trace id):
        what a capture or a build observed now is attributed to."""
        stack = getattr(self._tls, "stack", None)
        ctx = self.current_trace()
        return (stack[-1][0] if stack else "untraced",
                ctx.trace_id if ctx is not None else None)

    # --- reading ---------------------------------------------------------

    def _ordered(self) -> list[Span]:
        with self._lock:
            return self._ring[self._next_slot:] + self._ring[:self._next_slot]

    def snapshot(self) -> list[dict]:
        """Completed spans, oldest first, as plain dicts."""
        out = [s.to_dict() for s in self._ordered()]
        if self.identity:
            for d in out:
                d.update(self.identity)
        return out

    def durations(self, name: str) -> list[float]:
        return [s.dur_s for s in self._ordered() if s.name == name]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._next_slot = 0
            self.evicted = 0


# --- process-global tracker ---------------------------------------------
# One default tracker, so the trainer, the feed and serving share a
# timeline without threading a handle through every constructor. Tests
# install their own via set_tracker().

_GLOBAL = SpanTracker()


def get_tracker() -> SpanTracker:
    return _GLOBAL


def set_tracker(tracker: SpanTracker) -> SpanTracker:
    global _GLOBAL
    prev, _GLOBAL = _GLOBAL, tracker
    return prev


def span(name: str, **attrs: Any):
    """A span on the current global tracker."""
    return _GLOBAL.span(name, **attrs)
