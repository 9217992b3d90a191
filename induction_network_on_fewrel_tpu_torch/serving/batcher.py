"""Serving schedulers: a copy of ``ContinuousBatcher`` and
``DynamicBatcher`` from ``induction_network_on_fewrel_tpu/serving/batcher.py``,
with the same error types and the same packing rule.

**ContinuousBatcher** (the default): one admission structure feeds every
bucket: per-tenant deadline heaps behind one condition variable, and the
worker launches the next batch the moment it is free, so a light load
launches at once and a heavy load fills the buckets. Each launch serves
the tenant holding the globally most urgent request when that request is
urgent (deadline slack under two executions, or a quarter of its budget
spent waiting), else the deepest tenant. Backpressure is a global queue
bound plus a per-tenant share that binds once a second tenant has
submitted: an overloaded tenant sheds (``Saturated(tenant=...)``) while
the others keep admitting.

**DynamicBatcher**: the single-queue micro-batcher (the A/B arm):
coalesce up to ``max(buckets)`` requests within ``batch_window_s``,
flushing early when the oldest request's deadline slack runs out.

Both fail expired requests with ``DeadlineExceeded`` before execution,
reject at their bound with ``Saturated`` (a retry-after hint), and fail
a batch whose execution raises without losing the worker.
``start=False`` skips the worker thread: tests drive ``drain_once``.
"""

from __future__ import annotations

import dataclasses
import heapq
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable

from induction_network_on_fewrel_tpu_torch.serving.buckets import DEFAULT_BUCKETS


class Saturated(RuntimeError):
    """Queue at capacity — retry after ``retry_after_s``. ``tenant`` names
    the shed scope: a per-tenant share breach sheds THAT tenant while the
    queue still admits others; ``None`` means the global bound."""

    def __init__(self, retry_after_s: float, tenant: str | None = None):
        scope = f"tenant {tenant!r}" if tenant else "serving queue"
        super().__init__(
            f"{scope} saturated; retry after {retry_after_s:.3f}s"
        )
        self.retry_after_s = retry_after_s
        self.tenant = tenant


class DeadlineExceeded(TimeoutError):
    """The request's deadline expired before it reached the device."""


class ExecuteError(RuntimeError):
    """A launch failed on the device/host side: the batch's futures fail
    with THIS (typed, retry-after-bearing) error and nothing else — the
    worker survives, other tenants' batches are untouched. ``retry_after_s`` tells an adaptive client when
    resubmitting is worth trying (the breaker's open window when one is
    armed, else the drain estimate — same convention as ``Saturated``);
    ``cause`` carries the original exception."""

    def __init__(self, tenant: str, retry_after_s: float,
                 cause: BaseException | None = None):
        super().__init__(
            f"execution failed for tenant {tenant!r} "
            f"({type(cause).__name__ if cause is not None else 'unknown'}: "
            f"{cause}); retry after {retry_after_s:.3f}s"
        )
        self.tenant = tenant
        self.retry_after_s = retry_after_s
        self.cause = cause


@dataclasses.dataclass
class Request:
    query: dict                 # [L]-leaf tokenized query dict
    deadline: float             # absolute time.monotonic() deadline
    future: Future
    enqueued_at: float
    tenant: str = "default"     # verdict/registry scope
    trace: object = None        # obs/spans.TraceContext of a sampled request


class DynamicBatcher:
    def __init__(
        self,
        execute: Callable[[list[Request]], None],
        buckets: tuple[int, ...] = DEFAULT_BUCKETS,
        max_queue_depth: int = 64,
        batch_window_s: float = 0.002,
        stats=None,
        start: bool = True,
    ):
        """``execute(batch)`` fulfills (or fails) every future in ``batch``.
        ``start=False`` skips the worker thread — unit tests then drive
        ``drain_once()`` directly for deterministic scheduling."""
        self._execute = execute
        self.buckets = tuple(sorted(buckets))
        self.batch_window_s = batch_window_s
        self._stats = stats
        self._q: queue.Queue = queue.Queue(maxsize=max_queue_depth)
        self._closed = False
        self._worker = None
        if start:
            self._worker = threading.Thread(target=self._run, daemon=True)
            self._worker.start()

    # --- client side -----------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return self._q.qsize()

    def _retry_after_s(self) -> float:
        """How long a rejected client should back off: the time to drain the
        queue at the observed per-batch execution rate."""
        est = self._stats.exec_estimate_s() if self._stats else 0.005
        batches_ahead = self._q.maxsize / max(self.buckets) + 1
        return batches_ahead * max(est, 1e-4)

    def submit(
        self, query: dict, deadline_s: float, tenant: str = "default", trace=None,
    ) -> Future:
        """Enqueue one tokenized query; returns its Future. Raises
        ``Saturated`` (with a retry-after hint) when the queue is full."""
        if self._closed:
            raise RuntimeError("batcher is closed")
        now = time.monotonic()
        req = Request(
            query=query, deadline=now + deadline_s, future=Future(),
            enqueued_at=now, tenant=tenant, trace=trace,
        )
        try:
            self._q.put_nowait(req)
        except queue.Full:
            if self._stats:
                self._stats.record_rejected(tenant)
            raise Saturated(self._retry_after_s()) from None
        return req.future

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            # Sentinel unblocks an idle worker. put_nowait, not put: a FULL
            # queue (closing under saturation) must not block close —
            # the worker re-checks _closed within its 0.1 s poll anyway.
            self._q.put_nowait(None)
        except queue.Full:
            pass
        if self._worker is not None:
            self._worker.join(timeout=10.0)

    # --- worker side -----------------------------------------------------

    def _repost_sentinel(self) -> None:
        # NEVER a blocking put: a racing submitter can refill the slot the
        # sentinel just freed, and this thread is the queue's only consumer
        # — a blocking re-post would deadlock it. _closed is already set,
        # so a dropped sentinel only costs one 0.1 s poll.
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass

    def _collect(self, first: Request) -> list[Request]:
        """Coalesce up to ``max(buckets)`` requests starting from ``first``.

        Waits at most ``batch_window_s`` for stragglers, and LESS when the
        oldest collected request's deadline slack is smaller — that early
        return is the partial-bucket flush under deadline pressure.
        """
        batch = [first]
        cap = self.buckets[-1]
        window_end = time.monotonic() + self.batch_window_s
        exec_est = self._stats.exec_estimate_s() if self._stats else 0.005
        while len(batch) < cap:
            now = time.monotonic()
            slack = min(r.deadline for r in batch) - now - exec_est
            wait = min(window_end - now, slack)
            if wait <= 0:
                break
            try:
                nxt = self._q.get(timeout=wait)
            except queue.Empty:
                break
            if nxt is None:          # close() sentinel mid-collection:
                self._repost_sentinel()  # for the outer loop; flush now
                break
            batch.append(nxt)
        return batch

    def split_expired(
        self, batch: list[Request], now: float | None = None
    ) -> tuple[list[Request], list[Request]]:
        """(live, expired) partition; expired futures fail immediately."""
        return _split_expired(batch, self._stats, now)

    def drain_once(self, block_s: float = 0.1) -> int:
        """One worker iteration: collect, expire, execute. Returns the number
        of requests executed (0 when idle). Public so tests and synchronous
        callers can drive the batcher without the thread."""
        try:
            first = self._q.get(timeout=block_s)
        except queue.Empty:
            return 0
        if first is None:
            self._repost_sentinel()
            return 0
        batch = self._collect(first)
        live, _ = self.split_expired(batch)
        if not live:
            return 0
        try:
            self._execute(live)
        except BaseException as e:  # noqa: BLE001 — fail the batch, not the worker
            for r in live:
                if not r.future.done():
                    r.future.set_exception(e)
        return len(live)

    def _run(self) -> None:
        while not self._closed:
            self.drain_once()
        # Closed: fail anything still queued so no client blocks forever.
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                return
            if req is not None and not req.future.done():
                req.future.set_exception(RuntimeError("batcher closed"))


def _split_expired(
    batch: list[Request], stats, now: float | None = None
) -> tuple[list[Request], list[Request]]:
    """(live, expired) partition shared by both schedulers; expired
    futures fail immediately with ``DeadlineExceeded``."""
    now = time.monotonic() if now is None else now
    live = [r for r in batch if r.deadline > now]
    dead = [r for r in batch if r.deadline <= now]
    for r in dead:
        if stats:
            stats.record_deadline_miss(r.tenant)
        r.future.set_exception(
            DeadlineExceeded(
                f"deadline exceeded after {now - r.enqueued_at:.3f}s in queue"
            )
        )
    return live, dead


class ContinuousBatcher:
    """Continuous cross-bucket scheduler: one admission structure, per-group
    deadline heaps, launch-on-free.

    ``execute(group, batch)`` fulfills (or fails) every future in ``batch``
    — all requests of one call belong to one ``group`` (the engine keys
    groups by tenant: one tenant = one class matrix = one program call).

    Scheduling invariants:

    * **Launch the moment capacity frees** — no coalescing window, no
      per-bucket flush barrier: the worker pops the most urgent group and
      executes immediately; batch size is whatever accumulated while the
      device was busy (capped at ``max(buckets)``).
    * **Deadline-aware cross-group ordering** — each launch serves the
      group whose head request has the globally earliest deadline, so a
      deep backlog in one tenant never head-of-line-blocks another
      tenant's urgent query.
    * **Two-level backpressure** — a global ``max_queue_depth`` bound plus
      a per-tenant share (``tenant_share`` of the global bound): an
      overloaded tenant gets ``Saturated(tenant=...)`` (shed-load) while
      other tenants keep admitting. The share binds only once a SECOND
      tenant has ever submitted — a single-tenant deployment keeps the
      full queue instead of silently halving its capacity and reporting
      plain saturation as shed-load.
    * **Zero steady-state recompiles** — padding to the fixed bucket set
      is unchanged; this class only reorders WHICH requests share a
      program launch, never the program shapes.
    """

    # A waiting head becomes urgent once it has burned this fraction of
    # its deadline budget — the anti-starvation bound (_pop_group_locked).
    STALE_BUDGET_FRAC = 0.25

    def __init__(
        self,
        execute: Callable[[str, list[Request]], None],
        buckets: tuple[int, ...] = DEFAULT_BUCKETS,
        max_queue_depth: int = 256,
        tenant_share: float = 0.5,
        stats=None,
        start: bool = True,
        batch_window_s: float = 0.0,
    ):
        """``batch_window_s`` is accepted for interface parity with the
        micro-batcher but intentionally unused: continuous batching's whole
        point is that the execute path itself is the coalescing window."""
        self._execute = execute
        self.buckets = tuple(sorted(buckets))
        self._stats = stats
        self.max_queue_depth = max_queue_depth
        self.tenant_cap = max(1, int(max_queue_depth * tenant_share))
        self._cv = threading.Condition()
        # Every tenant that has EVER submitted: the per-tenant share only
        # binds in actual multi-tenant use (see class doc).
        self._seen: set[str] = set()
        # group -> deadline-ordered heap of (deadline, seq, Request); seq
        # breaks deadline ties FIFO (Requests don't order).
        self._pending: dict[str, list] = {}
        # Indexed selection: the per-launch pop used to scan EVERY active group
        # under the admission lock — O(active groups), the known ceiling
        # of a 10k-tenant soak. Two lazy heaps replace the scan:
        #
        # * ``_urgent``  — global [deadline, seq, Request] min-heap, one
        #   entry per ADMISSION, the SAME mutable list object the group
        #   heap holds (deadline+seq order; seq is unique, so comparison
        #   never reaches the Request slot). The globally-earliest
        #   still-pending entry is necessarily the head of its group's
        #   own deadline-ordered heap, so peeking it IS the urgent-group
        #   lookup. Popping a batch NULLS each entry's Request slot in
        #   place — the stale marker AND the memory release (a retained
        #   tuple would pin the executed request's query payload +
        #   result future until the entry drifted to the heap top, ~the
        #   deadline horizon at high qps); stale entries are discarded
        #   lazily, each pushed once and discarded at most once, so the
        #   amortized pop cost is O(log pending).
        # * ``_depth``   — lazy (-depth, seq, group) max-heap; a group is
        #   (re)pushed when its depth GROWS. A popped entry whose stored
        #   depth disagrees with the group's live depth is stale: it is
        #   discarded and, when the group still has pending work, one
        #   accurate entry is re-pushed before continuing — every stale
        #   entry is consumed exactly once, so this also amortizes to
        #   O(log) per selection instead of O(groups).
        self._urgent: list = []
        self._depth: list = []
        self._count = 0
        self._seq = 0
        self._closed = False
        self._worker = None
        if start:
            self._worker = threading.Thread(target=self._run, daemon=True)
            self._worker.start()

    # --- client side -----------------------------------------------------

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return self._count

    def group_depth(self, group: str) -> int:
        with self._cv:
            return len(self._pending.get(group, ()))

    def _retry_after_s(self, pending: int) -> float:
        """Backoff hint: time to drain ``pending`` requests at the observed
        per-batch execution rate and full-bucket packing."""
        est = self._stats.exec_estimate_s() if self._stats else 0.005
        batches_ahead = pending / self.buckets[-1] + 1
        return batches_ahead * max(est, 1e-4)

    def submit(
        self, query: dict, deadline_s: float, tenant: str = "default", trace=None,
    ) -> Future:
        """Admit one tokenized query for ``tenant``; returns its Future.
        Raises ``Saturated`` when the global queue is at bound, or
        ``Saturated(tenant=...)`` when this tenant exceeds its share while
        others still have room (per-tenant shed-load; binds only once a
        second tenant has ever submitted)."""
        now = time.monotonic()
        req = Request(
            query=query, deadline=now + deadline_s, future=Future(),
            enqueued_at=now, tenant=tenant, trace=trace,
        )
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            mine = self._pending.get(tenant)
            depth_mine = len(mine) if mine else 0
            if len(self._seen) > 1 and depth_mine >= self.tenant_cap:
                if self._stats:
                    self._stats.record_shed(tenant)
                raise Saturated(
                    self._retry_after_s(depth_mine), tenant=tenant
                )
            if self._count >= self.max_queue_depth:
                if self._stats:
                    self._stats.record_rejected(tenant)
                raise Saturated(self._retry_after_s(self._count))
            # Seen = ADMITTED at least once: a rejected stray submit must
            # not permanently activate the share for the resident tenant.
            self._seen.add(tenant)
            if mine is None:
                mine = self._pending[tenant] = []
            self._seq += 1
            entry = [req.deadline, self._seq, req]
            heapq.heappush(mine, entry)
            heapq.heappush(self._urgent, entry)
            heapq.heappush(self._depth, (-len(mine), self._seq, tenant))
            self._count += 1
            self._cv.notify()
        return req.future

    def close(self) -> None:
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=10.0)
        # Fail anything still admitted so no client blocks forever.
        with self._cv:
            for heap in self._pending.values():
                for entry in heap:
                    req, entry[2] = entry[2], None
                    if req is not None and not req.future.done():
                        req.future.set_exception(
                            RuntimeError("batcher closed")
                        )
            self._pending.clear()
            self._urgent.clear()
            self._depth.clear()
            self._count = 0

    # --- worker side -----------------------------------------------------

    def _urgent_head_locked(self) -> Request | None:
        """The globally most-urgent pending request, via the lazy global
        deadline heap: discard stale (nulled-at-pop) entries from the
        top, then peek. The surviving minimum is necessarily the head of
        its own group's deadline-ordered heap — group heaps hold only
        pending entries, ordered by the same (deadline, seq) key."""
        heap = self._urgent
        while heap and heap[0][2] is None:
            heapq.heappop(heap)
        return heap[0][2] if heap else None

    def _deepest_group_locked(self) -> str | None:
        """The group with the most pending requests, via the lazy depth
        max-heap: a top entry whose stored depth disagrees with the live
        depth is stale — consume it and, while the group still has work,
        re-push ONE accurate entry before re-examining. Every admission
        pushes one entry and every stale entry is consumed exactly once,
        so the amortized cost is O(log pending) per selection — never a
        scan over active groups."""
        heap = self._depth
        while heap:
            d, _, group = heap[0]
            live_heap = self._pending.get(group)
            live = len(live_heap) if live_heap else 0
            if live and -d == live:
                return group
            heapq.heappop(heap)
            if live:
                self._seq += 1
                heapq.heappush(heap, (-live, self._seq, group))
        return None

    def _pop_group_locked(self) -> tuple[str, list[Request]] | None:
        """Pop up to ``max(buckets)`` requests of the scheduled group (call
        with the cv lock held).

        Slot-level packing policy: serve the group with the globally
        earliest head deadline when that request is URGENT — its deadline
        at risk (slack under ~two executions: it must go now or it
        expires) OR it has burned more than ``STALE_BUDGET_FRAC`` of its
        deadline budget waiting (a sparse tenant's lone query must not
        idle behind a busy tenant's standing backlog until its deadline
        nearly expires); otherwise serve the DEEPEST group, maximizing
        slots filled per launch. Deadline-awareness is what prevents
        head-of-line blocking across tenants; largest-group packing is
        what keeps occupancy high when nothing is urgent — without it,
        launch-on-free degenerates into single-row launches at
        sub-saturation arrival rates and the per-launch fixed cost caps
        throughput (measured in the JAX package's load tests). The staleness
        trigger is deliberately BUDGET-relative, not exec-relative: an
        exec-estimate multiple looks natural but self-tightens as urgent
        launches shrink batches (smaller batches -> smaller estimate ->
        more urgency), collapsing the scheduler into oldest-first
        single-row launches under open-loop load (measured: open p99
        3.5x WORSE). Budget fraction is load-independent: healthy
        steady-state waits never approach it, and a starved request is
        still served within ~STALE_BUDGET_FRAC of its deadline instead
        of at its deadline.

        Selection is INDEXED: the urgent head comes off the lazy global deadline
        heap and the deepest group off the lazy depth heap — both
        amortized O(log pending) — so the per-launch cost under the
        admission lock does not scale with active groups."""
        head = self._urgent_head_locked()
        if head is None:
            return None
        exec_est = self._stats.exec_estimate_s() if self._stats else 0.005
        now = time.monotonic()
        slack = head.deadline - now - exec_est
        budget = head.deadline - head.enqueued_at
        stale = (now - head.enqueued_at) > self.STALE_BUDGET_FRAC * budget
        if slack < 2 * exec_est or stale:
            group = head.tenant
        else:
            group = self._deepest_group_locked()
            if group is None:       # urgent head exists => impossible,
                group = head.tenant  # but never crash the worker on it
        heap = self._pending[group]
        cap = self.buckets[-1]
        batch = []
        while heap and len(batch) < cap:
            entry = heapq.heappop(heap)
            batch.append(entry[2])
            # Null the shared slot: marks the _urgent twin stale AND
            # releases the executed request the moment it leaves the
            # queue (see the index comment in __init__).
            entry[2] = None
        if not heap:
            del self._pending[group]
        self._count -= len(batch)
        return group, batch

    def drain_once(self, block_s: float = 0.1) -> int:
        """One scheduler iteration: wait for admissions (at most
        ``block_s``), pop the most urgent group, expire, execute. Returns
        requests executed (0 when idle). Public so tests and synchronous
        callers drive the scheduler without the thread."""
        with self._cv:
            if self._count == 0 and not self._closed:
                self._cv.wait(timeout=block_s)
            popped = self._pop_group_locked()
        if popped is None:
            return 0
        group, batch = popped
        live, _ = _split_expired(batch, self._stats)
        if not live:
            return 0
        try:
            self._execute(group, live)
        except BaseException as e:  # noqa: BLE001 — fail the batch, not the worker
            for r in live:
                if not r.future.done():
                    r.future.set_exception(e)
        return len(live)

    def _run(self) -> None:
        while True:
            with self._cv:
                if self._closed:
                    # Prompt-fail close (the DynamicBatcher contract): the
                    # backlog is NOT drained — close() fails every still-
                    # admitted future after the join. Only a batch already
                    # mid-execute finishes.
                    return
            self.drain_once()
