"""Tenant -> replica placement: deterministic rendezvous hashing with
replica health states.

**Rendezvous (highest-random-weight) hashing** — every (tenant, replica)
pair hashes to a 64-bit score (blake2b of ``"tenant|replica"``; no RNG,
no process state) and the tenant is owned by the LIVE replica with the
highest score. Two properties make it the right placement primitive for
a 10k-tenant fleet:

* **Determinism** — placement is a pure function of (tenant id, live
  replica set). Every router process, every restart, every test replays
  the same map; there is no placement table to replicate or lose.
* **Bounded remap** — adding a replica moves exactly the tenants whose
  new scores win (expectation T/(R+1), the minimum any balanced scheme
  can move); removing one moves exactly ITS tenants and nobody else's
  (every surviving pair's score is unchanged, so every surviving argmax
  is unchanged). Both bounds are test-pinned in tests/test_fleet.py.

**Health states** — ``up`` (eligible), ``draining`` (operator-initiated:
excluded from placement so its tenants remap away at the rendezvous
bound, while the process keeps serving whatever is still in flight) and
``dead`` (excluded; fed by the router's per-replica circuit breaker —
the existing serving/breaker.CircuitBreaker keyed by replica id — or by
the ``fleet.replica_kill`` chaos point). Dead/draining replicas stay in
the table so a revive is one state flip with the same bounded remap.

**N-tier-weighted placement** — with tier-blind
rendezvous a fleet of mixed-geometry tenants sprays every N-tier onto
every replica, so each replica warms the full tiers x buckets x dtypes
program family. ``place(tenant, tier=..., tier_spread=s)`` first picks
the tier's ``s`` "home" replicas by rendezvous ON THE TIER KEY, then
rendezvous-places the tenant within that home set: each tier lands on
at most ``s`` replicas (a replica serves ~``s·T/R`` of ``T`` tiers),
while both levels keep rendezvous determinism and the bounded-remap
property (replica death remaps only the dead replica's tenants/home
slots). ``tier=None`` or ``tier_spread=0`` is exactly the tier-blind
map.
"""

from __future__ import annotations

import hashlib
import threading

UP = "up"
DRAINING = "draining"
DEAD = "dead"

_STATES = (UP, DRAINING, DEAD)


def placement_score(tenant: str, replica: str) -> int:
    """The rendezvous weight of one (tenant, replica) pair: a 64-bit
    digest of the joined ids. Pure and process-independent — every
    router, restart, and test computes the same score."""
    h = hashlib.blake2b(
        f"{tenant}|{replica}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(h, "big")


class FleetPlacement:
    """The fleet's replica table + the rendezvous placement function.

    Thread-safety: the router resolves placement on client threads while
    breaker transitions / control-plane ops mutate states — one lock,
    no I/O under it. ``place`` is two dict reads plus R hash calls (R =
    replicas, single digits to low tens); at fleet scale the per-submit
    cost is placement-table-free by design.
    """

    def __init__(self, replicas=()):
        self._lock = threading.Lock()
        self._states: dict[str, str] = {}
        # Monotonic generation: bumped on every membership/state change,
        # so callers (router owner cache, reports) can cheaply detect
        # that placements may have moved.
        self.generation = 0
        for rid in replicas:
            self._states[str(rid)] = UP

    # --- membership / health ---------------------------------------------

    def add_replica(self, replica: str, state: str = UP) -> None:
        self._set(replica, state, must_exist=False)

    def set_state(self, replica: str, state: str) -> None:
        self._set(replica, state, must_exist=True)

    def _set(self, replica: str, state: str, must_exist: bool) -> None:
        if state not in _STATES:
            raise ValueError(
                f"unknown replica state {state!r} (one of {_STATES})"
            )
        with self._lock:
            if must_exist and replica not in self._states:
                raise ValueError(f"unknown replica {replica!r}")
            if self._states.get(replica) == state:
                return
            self._states[replica] = state
            self.generation += 1

    def remove_replica(self, replica: str) -> None:
        with self._lock:
            if replica not in self._states:
                raise ValueError(f"unknown replica {replica!r}")
            del self._states[replica]
            self.generation += 1

    def state(self, replica: str) -> str | None:
        with self._lock:
            return self._states.get(replica)

    def replicas(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._states))

    def live(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(
                sorted(r for r, s in self._states.items() if s == UP)
            )

    def states(self) -> dict[str, str]:
        with self._lock:
            return dict(self._states)

    # --- placement --------------------------------------------------------

    @staticmethod
    def _pool(live, tier, tier_spread):
        """The candidate replicas a tenant rendezvous-places within:
        all live replicas when tier-blind, else the tier's top-
        ``tier_spread`` home replicas by rendezvous on the tier key."""
        if tier is None or tier_spread <= 0 or tier_spread >= len(live):
            return live
        return sorted(
            live,
            key=lambda r: placement_score(f"tier:{tier}", r),
            reverse=True,
        )[:tier_spread]

    def place(self, tenant: str, tier: int | None = None,
              tier_spread: int = 0) -> str | None:
        """The live replica owning ``tenant`` (highest rendezvous score),
        or None when no replica is up. Ties (astronomically unlikely at
        64 bits) break toward the lexically-smallest id so the map stays
        a pure function of the inputs. ``tier``/``tier_spread`` opt into
        N-tier-weighted placement (module doc): the tenant places within
        its tier's home set instead of the whole fleet."""
        with self._lock:
            live = [r for r, s in self._states.items() if s == UP]
        if not live:
            return None
        pool = self._pool(sorted(live), tier, tier_spread)
        return max(
            pool, key=lambda r: placement_score(tenant, r)
        )

    def owners(self, tenants, tier_of=None,
               tier_spread: int = 0) -> dict[str, str | None]:
        """Batch placement (one lock acquisition, one live-set).
        ``tier_of`` maps tenant -> N-tier (or None) for tier-weighted
        placement; None keeps the tier-blind map."""
        with self._lock:
            live = sorted(
                r for r, s in self._states.items() if s == UP
            )
        if not live:
            return {t: None for t in tenants}
        return {
            t: max(
                self._pool(
                    live,
                    tier_of(t) if tier_of is not None else None,
                    tier_spread,
                ),
                key=lambda r: placement_score(t, r),
            )
            for t in tenants
        }

    @staticmethod
    def churn(before: dict[str, str | None],
              after: dict[str, str | None]) -> int:
        """Tenants whose owner changed between two placement maps — the
        remap cost of a membership change (FLEET artifacts record it as
        a fraction of tenants; the rendezvous bound is what the tests
        pin)."""
        return sum(
            1 for t, r in before.items() if after.get(t) != r
        )
