"""Per-tenant circuit breaker: a copy of ``CircuitBreaker`` from
``induction_network_on_fewrel_tpu/serving/breaker.py``.

Three states per tenant: **closed** (traffic flows; consecutive launch
failures count, and at ``failure_threshold`` the breaker opens), **open**
(submits shed at once with ``Saturated(tenant=...)`` carrying the rest of
the open window as retry-after; after ``open_s`` it half-opens) and
**half-open** (exactly ``half_open_probes`` submits admit, the first ones
after the transition; a probe success closes the breaker, a failure
re-opens it with a fresh window). The clock is injectable (``clock=``).
Every transition calls ``on_transition(tenant, frm, to, failures, now)``
after the lock is released.

``admit`` runs on client threads and ``record_*`` on the batcher's worker,
under one lock with no I/O inside it.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class _TenantBreaker:
    __slots__ = ("state", "failures", "opened_at", "probes_admitted")

    def __init__(self):
        self.state = CLOSED
        self.failures = 0          # consecutive launch failures (closed)
        self.opened_at = 0.0
        self.probes_admitted = 0   # since the half-open transition


class CircuitBreaker:
    def __init__(
        self,
        failure_threshold: int = 5,
        open_s: float = 5.0,
        half_open_probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
        on_transition=None,
    ):
        if failure_threshold < 1 or half_open_probes < 1 or open_s <= 0:
            raise ValueError(
                "failure_threshold/half_open_probes must be >= 1 and "
                "open_s > 0"
            )
        self.failure_threshold = failure_threshold
        self.open_s = open_s
        self.half_open_probes = half_open_probes
        self._clock = clock
        self.on_transition = on_transition
        self._lock = threading.Lock()
        self._tenants: dict[str, _TenantBreaker] = {}

    # --- client side (submit path) ----------------------------------------

    def admit(self, tenant: str, now: float | None = None) -> float | None:
        """None = admitted; a float = shed, retry after that many
        seconds. Open -> half-open happens lazily here (no timer
        thread): the first arrival past the window becomes the probe."""
        now = self._clock() if now is None else now
        pending = None
        with self._lock:
            tb = self._tenants.get(tenant)
            if tb is None or tb.state == CLOSED:
                return None
            if tb.state == OPEN:
                remaining = tb.opened_at + self.open_s - now
                if remaining > 0:
                    return max(remaining, 1e-3)
                pending = (tenant, OPEN, HALF_OPEN, tb.failures, now)
                tb.state = HALF_OPEN
                tb.probes_admitted = 0
            # HALF_OPEN (possibly just transitioned): deterministic probe
            # admission — the first half_open_probes submits go through.
            if tb.probes_admitted < self.half_open_probes:
                tb.probes_admitted += 1
                out = None
            else:
                out = self.open_s
        if pending is not None:
            self._fire(*pending)
        return out

    def state(self, tenant: str) -> str:
        with self._lock:
            tb = self._tenants.get(tenant)
            return tb.state if tb is not None else CLOSED

    def reset(self, tenant: str) -> None:
        """Forget this key's breaker history (state back to CLOSED, no
        transition callback), for a supervised restart: the replacement
        process shares nothing with the one whose failures opened the
        breaker, so carrying the open window over would shed a healthy
        replica."""
        with self._lock:
            self._tenants.pop(tenant, None)

    # --- worker side (launch outcomes) ------------------------------------

    def record_success(self, tenant: str, now: float | None = None) -> None:
        pending = None
        with self._lock:
            tb = self._tenants.get(tenant)
            if tb is None:
                return
            if tb.state == HALF_OPEN:
                pending = (tenant, HALF_OPEN, CLOSED, tb.failures,
                           self._clock() if now is None else now)
                tb.state = CLOSED
            tb.failures = 0
        if pending is not None:
            self._fire(*pending)

    def record_failure(self, tenant: str, now: float | None = None) -> None:
        now = self._clock() if now is None else now
        pending = None
        with self._lock:
            tb = self._tenants.setdefault(tenant, _TenantBreaker())
            if tb.state == HALF_OPEN:
                # The probe failed: re-open with a fresh window.
                pending = (tenant, HALF_OPEN, OPEN, tb.failures, now)
                tb.state = OPEN
                tb.opened_at = now
            elif tb.state == CLOSED:
                tb.failures += 1
                if tb.failures >= self.failure_threshold:
                    pending = (tenant, CLOSED, OPEN, tb.failures, now)
                    tb.state = OPEN
                    tb.opened_at = now
            # OPEN: a straggler failure from a launch admitted before the
            # open is context, not a new transition.
        if pending is not None:
            self._fire(*pending)

    def _fire(self, tenant, frm, to, failures, now) -> None:
        if self.on_transition is not None:
            self.on_transition(tenant, frm, to, failures, now)
