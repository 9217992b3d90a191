"""PipelineFeed: a background-produced, bounded, checkpointable episode feed.

The port's counterpart of ``induction_network_on_fewrel_tpu/datapipe/
producer.py``. Sampling on the trainer's thread runs in series with the
step's copy and launch; the feed moves it onto one producer thread that
drives the base sampler into a bounded queue, so batch t+1 is drawn while
the card runs batch t. The consumer's wait on the queue is the feed stall,
measured and logged (``drain_stats``: one ``kind="data"`` record per
metric window).

The stream contract every part keeps: the sequence of batches handed to
the trainer is identical to the synchronous path's, at every prefetch
depth. Production is strictly sequential from one base sampler; the depth
only changes how far ahead that sequence is drawn. ``prefetch_depth=0``
delegates synchronously, bitwise the path without a feed.

Units: the feed produces blocks of ``unit`` batches (``steps_per_call``
for samplers whose ``sample_fused`` fills a stacked [S, B, ...] block in
one call, the layout the captured S-step graph takes: the index samplers'
(sup, qry, label) arrays, the C++ token sampler's ``EpisodeBatch`` of
stacked fields; 1 otherwise).
Consumption may interleave single draws and fused draws; the feed slices
and stacks across unit boundaries, and the cursor counts batches.

The producer hands over the numpy arrays it drew (each unit its own
contiguous arrays) and nothing else: the consumer's ``CapturedSteps.fill``
stays the only writer of a graph's pinned static inputs, which the
previous call's asynchronous copy may still be reading. Each unit is
validated on the producer thread (shape and dtype against the first
unit's, float leaves finite, int leaves non-negative).

Checkpointing: the producer captures the base sampler's stream state just
before drawing each unit; ``cursor_state`` pairs the captured state of the
unit holding the consumed position with the consumed batch count, so
prefetched batches are produced again on resume and never skipped.

Faults (``datapipe/faults.py``): ``slow`` delays production, ``stall``
wedges it (the consumer logs stall ticks), ``poison`` corrupts a unit
after the state capture; the validator refuses it (``FeedError``).

The producer thread is a daemon, ``close()`` joins it, and no wait on the
queue is without a timeout.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Iterator

import numpy as np

from induction_network_on_fewrel_tpu_torch.datapipe.cursor import (
    PipelineCursor,
    capture_sampler_state,
    current_layout,
    restore_sampler_state,
)
from induction_network_on_fewrel_tpu_torch.datapipe.faults import (
    FeedFaults,
    poison_tree,
    tree_leaves,
)
from induction_network_on_fewrel_tpu_torch.obs.spans import span

_POLL_S = 0.2       # the longest a queue wait blocks before it looks around


def _batch_type(batch):
    """The batch type of a unit's fields: its own named tuple (an
    ``EpisodeBatch``), or ``IndexEpisodeBatch`` for a plain (sup, qry,
    label) tuple."""
    if hasattr(batch, "_fields"):
        return type(batch)
    from induction_network_on_fewrel_tpu_torch.sampling.index import IndexEpisodeBatch

    return IndexEpisodeBatch


class FeedError(RuntimeError):
    """The feed cannot serve batches (its producer died, a batch was
    poisoned, or it was closed)."""


class _Item:
    __slots__ = ("start", "payload", "poisoned")

    def __init__(self, start: int, payload: Any, poisoned: str | None):
        self.start = start          # batch index of payload[0]
        self.payload = payload      # a fused (sup, qry, lab) or one batch
        self.poisoned = poisoned    # the validator's verdict (None = clean)


def check_payload(payload, template: list | None) -> tuple[list, str | None]:
    """(the payload's signature, a verdict or None when clean): shapes and
    dtypes against ``template`` (the first unit's), float leaves finite,
    int leaves non-negative (episode indices, labels and token ids are)."""
    leaves = [np.asarray(x) for x in tree_leaves(payload)]
    sig = [(a.shape, a.dtype) for a in leaves]
    if template is not None and sig != template:
        return template, f"batch signature changed: {sig} != {template}"
    for a in leaves:
        if np.issubdtype(a.dtype, np.floating):
            if not np.all(np.isfinite(a)):
                return sig, "non-finite values in a float leaf"
        elif np.issubdtype(a.dtype, np.integer):
            if a.size and int(a.min()) < 0:
                return sig, "negative values in an integer leaf"
    return sig, None


class PipelineFeed:
    """Any sampler (``sample_batch``, and ``sample_fused`` when ``unit`` >
    1) behind a producer thread, a bounded queue and a serializable cursor.
    The trainer-facing surface is the base sampler's: ``sample_batch``,
    ``sample_fused`` (in fused mode), ``batch_size``, ``total_q``,
    iteration and ``close``. ``process`` (the stream's index and count:
    under a mesh the dp index and size) goes into the cursor's layout
    fingerprint (``cursor.current_layout``)."""

    def __init__(self, base, prefetch_depth: int = 2, unit: int = 1,
                 faults: FeedFaults | None = None, logger=None, stream_tag: str = "",
                 stall_tick_s: float = 2.0, process: tuple[int, int] | None = None):
        if prefetch_depth < 0:
            raise ValueError(f"prefetch_depth must be >= 0, got {prefetch_depth}")
        if unit < 1:
            raise ValueError(f"unit must be >= 1, got {unit}")
        if unit > 1 and not hasattr(base, "sample_fused"):
            raise ValueError(f"unit={unit} needs a sampler with sample_fused; "
                             f"{type(base).__name__} has none")
        self.base = base
        self.depth = prefetch_depth
        self.unit = unit
        self.batch_size = base.batch_size
        self.faults = faults or FeedFaults()
        self.logger = logger            # the trainer attaches its logger
        self.stream_tag = stream_tag
        self._stall_tick_s = stall_tick_s
        self._layout = current_layout(base.batch_size, process)

        # Stream position, guarded by _lock.
        self._lock = threading.Lock()
        self._consumed = 0              # batches handed to the trainer
        self._produced = 0              # batches drawn from the base sampler
        self._next_produce = 0          # the producer's next unit start
        # {unit start: the base state captured before drawing that unit},
        # seeded with position 0 so cursor_state never reads the base
        # sampler while the producer draws from it.
        self._states: dict[int, dict] = {0: capture_sampler_state(base)}
        self._template = None           # the first unit's signature

        self._stall_s = 0.0             # consumer time blocked on the feed
        self._produce_s = 0.0           # time spent drawing units
        self._poisoned = 0
        self._win_t0 = time.monotonic()
        self._win = self._new_window()

        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch_depth, 1))
        self._cur: _Item | None = None  # a partly consumed unit
        self._cur_off = 0
        self._stop = threading.Event()
        self._closed = False
        self._gen = 0                   # bumped by restore_cursor and close
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        if unit > 1:
            # An instance attribute, so that hasattr sees it in fused mode only.
            self.sample_fused = self._sample_fused

    @staticmethod
    def _new_window() -> dict:
        return {"stall_s": 0.0, "produce_s": 0.0, "consumed": 0, "produced": 0}

    @property
    def total_q(self):
        return self.base.total_q

    @property
    def layout(self) -> dict:
        """This feed's layout fingerprint (``current_layout``)."""
        return dict(self._layout)

    # --- producer side --------------------------------------------------

    def _ensure_producer(self) -> None:
        if self._closed:
            raise FeedError("the feed is closed")
        if self.depth == 0 or (self._thread is not None and self._thread.is_alive()):
            return
        if self._error is not None:
            raise FeedError("feed producer died") from self._error
        self._stop.clear()
        self._thread = threading.Thread(target=self._produce_loop, args=(self._gen,),
                                        name="datapipe-producer", daemon=True)
        self._thread.start()

    def _should_validate(self) -> bool:
        """Whenever a fault is armed or a logger carries the verdicts (read
        per unit: the trainer attaches its logger after construction)."""
        return self.faults.active or self.logger is not None

    def _draw_unit(self):
        if self.unit > 1:
            return self.base.sample_fused(self.unit)
        return self.base.sample_batch()

    def _validate(self, payload) -> str | None:
        sig, verdict = check_payload(payload, self._template)
        if self._template is None:
            self._template = sig
        return verdict

    def _produce_loop(self, gen: int) -> None:
        try:
            while not self._stop.is_set() and gen == self._gen:
                start = self._next_produce
                if self.faults.stalls_unit(start):
                    self._stop.wait(0.05)       # wedged: produce nothing, stay alive
                    continue
                if self.faults.slow_s > 0:
                    self._stop.wait(self.faults.slow_s)
                    if self._stop.is_set() or gen != self._gen:
                        return
                state = capture_sampler_state(self.base)
                t0 = time.monotonic()
                with span("datapipe/produce", unit=self.unit):
                    payload = self._draw_unit()
                dt = time.monotonic() - t0
                if self.faults.poisons_unit(start, self.unit):
                    payload = poison_tree(payload)
                poisoned = self._validate(payload) if self._should_validate() else None
                item = _Item(start, payload, poisoned)
                with self._lock:
                    self._states[start] = state
                    self._produce_s += dt
                    self._win["produce_s"] += dt
                while not self._stop.is_set() and gen == self._gen:
                    try:
                        self._q.put(item, timeout=_POLL_S)
                        break
                    except queue.Full:
                        continue
                else:
                    return
                with self._lock:
                    self._next_produce = start + self.unit
                    self._produced = self._next_produce
                    self._win["produced"] += self.unit
        except BaseException as e:  # noqa: BLE001 - surfaced on the next pop
            self._error = e

    # --- consumer side --------------------------------------------------

    def _producer_alive(self) -> bool:
        """Depth 0 has no producer thread by design: it reads as alive."""
        thread = self._thread
        return self.depth == 0 or (thread is not None and thread.is_alive())

    def _account_inline(self, dt: float, n: int) -> None:
        """Depth 0: the consumer's wait is the inline production, so it
        counts as both stall and produce time (``feed_stall_frac`` is then
        the share of the wall the trainer waited on the feed at any depth)."""
        with self._lock:
            self._consumed += n
            self._produced = self._consumed
            self._win["consumed"] += n
            self._win["produced"] += n
            self._stall_s += dt
            self._produce_s += dt
            self._win["stall_s"] += dt
            self._win["produce_s"] += dt

    def _tick(self, stalled_s: float) -> None:
        """A ``kind="data"`` record while blocked (or on a refused batch),
        at the consumed batch count."""
        if self.logger is None:
            return
        with self._lock:
            self.logger.log(self._consumed, "data", produced=float(self._produced),
                            consumed=float(self._consumed), queue_depth=float(self._q.qsize()),
                            stalled_s=round(stalled_s, 3),
                            producer_alive=float(self._producer_alive()),
                            poisoned=float(self._poisoned))

    def _refuse(self, index: int, verdict: str):
        with self._lock:
            self._poisoned += 1
        self._tick(0.0)
        raise FeedError(f"poisoned batch refused at index {index}: {verdict}")

    def _pop_item(self) -> _Item:
        self._ensure_producer()
        t0 = time.monotonic()
        next_tick = t0 + self._stall_tick_s
        while True:
            if self._error is not None:
                raise FeedError("feed producer died") from self._error
            try:
                item = self._q.get(timeout=_POLL_S)
                break
            except queue.Empty:
                thread = self._thread           # close() may clear it meanwhile
                if thread is None or not thread.is_alive():
                    if self._error is not None:
                        raise FeedError("feed producer died") from self._error
                    raise FeedError("feed producer exited (the feed was closed or restored)")
                now = time.monotonic()
                if now >= next_tick:
                    self._tick(now - t0)
                    next_tick = now + self._stall_tick_s
        waited = time.monotonic() - t0
        with self._lock:
            self._stall_s += waited
            self._win["stall_s"] += waited
            # The position never rewinds past the unit being consumed.
            for s in [s for s in self._states if s < item.start]:
                del self._states[s]
        if item.poisoned is not None:
            self._refuse(item.start, item.poisoned)
        return item

    def _inline_stall(self) -> None:
        """A ``stall`` fault at depth 0: block like a hung sampler, logging
        stall ticks, until the feed is closed."""
        t0 = time.monotonic()
        while not self._stop.wait(self._stall_tick_s):
            self._tick(time.monotonic() - t0)
        raise FeedError("the feed was closed while stalled")

    def _next_single(self):
        if self.depth == 0:
            if self._closed:
                raise FeedError("the feed is closed")
            start = self._consumed
            if self.faults.stalls_unit(start):
                self._inline_stall()
            t0 = time.monotonic()
            if self.faults.slow_s > 0:
                time.sleep(self.faults.slow_s)
            batch = self.base.sample_batch()
            dt = time.monotonic() - t0
            if self.faults.poisons_unit(start, 1):
                batch = poison_tree(batch)
            if self._should_validate():
                verdict = self._validate(batch)
                if verdict is not None:
                    self._refuse(start, verdict)
            self._account_inline(dt, 1)
            return batch
        if self._cur is None:
            self._cur, self._cur_off = self._pop_item(), 0
        item, off = self._cur, self._cur_off
        out = item.payload
        if self.unit > 1:
            out = _batch_type(out)(*(x[off] for x in out))
        self._cur_off += 1
        if self._cur_off >= self.unit:
            self._cur = None
        with self._lock:
            self._consumed += 1
            self._win["consumed"] += 1
        return out

    def sample_batch(self):
        return self._next_single()

    def _sample_fused(self, s: int):
        """The fused draw (fused mode only): a whole produced unit on the
        fast path, else single batches stacked into [S, B, ...]."""
        if self.depth == 0:
            if self.faults.active:      # faults count per batch: the generic path
                return self._stack([self._next_single() for _ in range(s)])
            if self._closed:
                raise FeedError("the feed is closed")
            t0 = time.monotonic()
            out = self.base.sample_fused(s)
            self._account_inline(time.monotonic() - t0, s)
            return out
        if s == self.unit and self._cur is None:
            item = self._pop_item()
            with self._lock:
                self._consumed += s
                self._win["consumed"] += s
            return item.payload
        return self._stack([self._next_single() for _ in range(s)])

    @staticmethod
    def _stack(batches):
        """Single batches as one fused unit: each field stacked."""
        return _batch_type(batches[0])(*(np.stack(f) for f in zip(*batches)))

    def __iter__(self) -> Iterator:
        while True:
            yield self.sample_batch()

    # --- cursor ---------------------------------------------------------

    def cursor_state(self) -> PipelineCursor:
        """The restorable position at the consumed boundary; batches waiting
        in the queue are produced again on resume."""
        with self._lock:
            c = self._consumed
            if self.depth == 0:
                state, captured_at = capture_sampler_state(self.base), c
            else:
                eligible = [s for s in self._states if s <= c]
                if not eligible:
                    raise RuntimeError(f"no captured sampler state at or before batch {c}")
                captured_at = max(eligible)
                state = self._states[captured_at]
            if state.get("kind") == "replay":
                captured_at = 0         # a fresh sampler and a replay from the origin
            return PipelineCursor(consumed=c, captured_at=captured_at, sampler_state=state,
                                  layout=self.layout, stream_tag=self.stream_tag)

    def restore_cursor(self, cursor: PipelineCursor) -> None:
        """Reposition the stream at ``cursor``: the batches that follow are
        those the uninterrupted run would have consumed next. The layout and
        the stream tag are checked first."""
        cursor.check_layout(self._layout)
        if cursor.stream_tag != self.stream_tag:
            raise ValueError(
                f"pipeline cursor stream tag {cursor.stream_tag!r} does not match this feed's "
                f"{self.stream_tag!r} (another --mixture or seed); resume with the original "
                "configuration"
            )
        self._halt_producer()
        restore_sampler_state(self.base, cursor.sampler_state,
                              skip=cursor.consumed - cursor.captured_at)
        with self._lock:
            self._consumed = self._produced = self._next_produce = cursor.consumed
            self._states = {cursor.consumed: capture_sampler_state(self.base)}
            self._cur, self._cur_off = None, 0
        self._stop.clear()              # the producer restarts at the next draw

    def _drain(self) -> None:
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return

    def _halt_producer(self) -> None:
        self._gen += 1
        self._stop.set()
        self._drain()                   # unblocks a producer waiting on a full queue
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            if self._thread.is_alive():
                raise RuntimeError("the feed's producer thread did not stop within 30 s")
            self._thread = None
        self._drain()
        # Cleared after the join: a halt starts a fresh producer generation.
        self._error = None

    # --- telemetry ------------------------------------------------------

    def stats(self) -> dict:
        """Cumulative counters."""
        with self._lock:
            return {"produced": self._produced, "consumed": self._consumed,
                    "queue_depth": self._q.qsize(), "stall_s": round(self._stall_s, 6),
                    "produce_s": round(self._produce_s, 6), "poisoned": self._poisoned}

    def drain_stats(self) -> dict:
        """The window's feed telemetry for one ``kind="data"`` record:
        counters since the last drain, the queue's state, and
        ``feed_stall_frac``, the share of the window the consumer waited."""
        now = time.monotonic()
        with self._lock:
            win, self._win = self._win, self._new_window()
            window_s = now - self._win_t0
            self._win_t0 = now
            qd = self._q.qsize()
            return {
                "produced": float(self._produced), "consumed": float(self._consumed),
                "queue_depth": float(qd),
                "episodes_buffered": float(qd * self.unit * self.batch_size),
                "stall_s": round(win["stall_s"], 6), "produce_s": round(win["produce_s"], 6),
                "window_s": round(window_s, 6),
                "feed_stall_frac": round(win["stall_s"] / window_s, 6) if window_s > 0 else 0.0,
                "window_consumed": float(win["consumed"]),
                "producer_alive": float(self._producer_alive()),
                "poisoned": float(self._poisoned),
            }

    def close(self) -> None:
        """Stop and join the producer, then close the base sampler."""
        if self._closed:
            return
        self._closed = True
        self._halt_producer()
        self._stop.set()                # a depth-0 stall drill ends too
        if hasattr(self.base, "close"):
            self.base.close()
