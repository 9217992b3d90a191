"""Unified chaos-injection registry: named fault points across layers.

The counterpart of ``induction_network_on_fewrel_tpu/obs/chaos.py``, with
its ``KNOWN_POINTS`` catalog copied whole, so that one ``--chaos`` plan
parses the same in both packages. A single spec drives checkpoint
corruption, publish poisoning and serving execute failures, and the
containment machinery (quarantine, circuit breakers, transactional
rollback) is drilled against the injector the tests pin.

Grammar (``ChaosRegistry.parse``): comma-separated directives

    POINT@AT[*COUNT][:ARG]

* ``POINT`` — one of ``KNOWN_POINTS`` (a typo raises: a drill that
  silently injects nothing is worse than no drill).
* ``AT``    — 0-based arrival index at that point: the directive fires
  when the point's (ARG-filtered) hit counter reaches AT.
* ``COUNT`` — consecutive fires from AT (default 1).
* ``ARG``   — point-specific filter/payload: the tenant name on serving
  points, the ring kind (``ring``/``ring_base``/``ring_delta``) on
  checkpoint points.

Examples::

    serve.execute_raise@0*3:tenant0   # fail tenant0's first 3 launches
    ckpt.bitflip@1:ring_delta         # corrupt the 2nd delta ring save
    publish.nan_params@0              # NaN-poison the next publish

The port fires every point: ``ckpt.bitflip``, ``ckpt.truncate``,
``ckpt.restore_raise`` (``train/checkpoint.py``), ``publish.nan_params``,
``publish.distill_raise`` (``serving/registry.py``),
``serve.execute_raise`` (``serving/engine.py``), ``fleet.replica_kill``
(``fleet/router.py``), ``adapt.train_raise``, ``adapt.canary_fail``,
``adapt.publish_raise`` (``obs/adapt.py``), ``net.partition``,
``net.drop``, ``net.slow`` (``fleet/transport.py``) and
``journal.torn_write`` (``fleet/journal.py``).

Determinism: firing is a pure function of the arrival sequence;
corruption offsets derive from a hash of the corrupted file's name. Off
is zero-cost: with nothing installed ``chaos_fire`` is one global load
and an ``is None`` test. Every fired directive emits one
``kind="fault"`` record (``action="inject"``) through the registry's
logger; the containment sites emit their own ``kind="fault"`` records.
"""

from __future__ import annotations

import dataclasses
import threading
from pathlib import Path


class ChaosError(RuntimeError):
    """An injected fault (never raised by real failures — drills and
    tests assert on the type to separate injection from regression)."""


# Fault-point catalog: name -> where it fires / what it models. A point
# not listed here is a parse error.
KNOWN_POINTS: dict[str, str] = {
    "ckpt.bitflip": (
        "after a ring-family checkpoint save completes: flip one byte in "
        "the slot's largest data file (silent media corruption). ARG "
        "filters the ring kind (ring/ring_base/ring_delta)."
    ),
    "ckpt.truncate": (
        "after a ring-family checkpoint save completes: truncate the "
        "slot's largest data file to half (torn write / full disk). ARG "
        "filters the ring kind."
    ),
    "ckpt.restore_raise": (
        "at a slot restore attempt: raise ChaosError (a flaky read — "
        "contained exactly like corruption: quarantine + ring-walk "
        "fallback). ARG filters the ring kind."
    ),
    "publish.nan_params": (
        "at publish entry: NaN-poison the params handed to "
        "publish_params — the pre-swap validation gate must refuse and "
        "roll back."
    ),
    "publish.distill_raise": (
        "inside the publish re-distill pass: raise ChaosError mid-"
        "transaction — the rollback must leave every tenant on its old "
        "snapshot."
    ),
    "serve.execute_raise": (
        "in the serving worker before the device program runs: raise "
        "ChaosError — must fail ONLY that batch's futures (typed "
        "ExecuteError) and feed the tenant's circuit breaker. ARG "
        "filters the tenant."
    ),
    "fleet.replica_kill": (
        "at a fleet-router submit arrival: mark the request's owning "
        "replica DEAD (simulated process death) — the router "
        "must fail over: degraded NOTA verdicts for the replica's "
        "tenants until re-placement, then normal service from the new "
        "owners. ARG filters the replica id."
    ),
    "adapt.train_raise": (
        "at an adaptation fine-tune launch (obs/adapt.py): "
        "raise ChaosError instead of training — the controller must "
        "count the attempt failed, honor its backoff, and exhaust after "
        "the retry budget. ARG filters the tenant."
    ),
    "adapt.canary_fail": (
        "at the adaptation canary gate: force a failed verdict — the "
        "candidate must be DISCARDED (checkpoint cleanup, zero "
        "publishes), never reach the fleet. ARG filters the tenant."
    ),
    "adapt.publish_raise": (
        "at the adaptation publish step, after the canary passed: raise "
        "ChaosError before the fan-out — the controller must count the "
        "attempt failed with the fleet untouched. ARG filters the "
        "tenant."
    ),
    "net.partition": (
        "at a SocketReplica call: raise ConnectionError before any bytes "
        "move (the network between router and replica is gone) "
        "— idempotent calls must retry within their bounded budget, the "
        "breaker must count the failures. ARG filters the replica id."
    ),
    "net.drop": (
        "at a SocketReplica call: the request is sent but the response "
        "is 'lost' — the connection is invalidated and ConnectionError "
        "raised (a dropped packet / dying peer mid-response). ARG "
        "filters the replica id."
    ),
    "net.slow": (
        "at a SocketReplica call: sleep before the call proceeds — "
        "injected network latency for latency/SLO drills. ARG is the "
        "PAYLOAD here — the delay in seconds (default 0.05), not a "
        "filter (every arrival counts)."
    ),
    "journal.torn_write": (
        "at a fleet-journal append (fleet/journal.py): write "
        "a torn record — the header claims the full payload but only "
        "half reaches disk (a crash mid-write) — and refuse further "
        "appends from this journal object; reopening the directory must "
        "truncate the tear and recover every record before it. ARG "
        "filters the journal op name."
    ),
}


# Points whose ARG is a PAYLOAD the fired site reads (directive.arg),
# not an arrival filter — every arrival at the point counts.
PAYLOAD_ARG_POINTS = frozenset({"net.slow"})


@dataclasses.dataclass
class FaultDirective:
    point: str
    at: int
    count: int = 1
    arg: str = ""
    hits: int = 0       # matching arrivals observed so far
    fired: int = 0      # times this directive actually fired

    def matches(self, ctx_arg: str | None) -> bool:
        return not self.arg or (ctx_arg is not None and self.arg == ctx_arg)


class ChaosRegistry:
    """Parsed fault plan + per-directive arrival counters (thread-safe:
    fault points fire from the saver thread, the serving worker, and the
    main thread)."""

    def __init__(self, directives: list[FaultDirective], logger=None):
        self.directives = directives
        self.logger = logger
        self._lock = threading.Lock()
        self.fired_log: list[dict] = []   # every fired directive (drills)

    @classmethod
    def parse(cls, spec: str | None, logger=None) -> "ChaosRegistry | None":
        """``"serve.execute_raise@0*3:t0,publish.nan_params@0"`` -> a
        registry; empty/None -> None (off). Unknown points and malformed
        directives raise ValueError."""
        if not spec:
            return None
        directives = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            head, _, arg = part.partition(":")
            point, at_sep, at_part = head.partition("@")
            if point not in KNOWN_POINTS:
                raise ValueError(
                    f"unknown chaos point {point!r} "
                    f"(known: {', '.join(sorted(KNOWN_POINTS))})"
                )
            if not at_sep:
                raise ValueError(
                    f"chaos directive {part!r} lacks '@AT' (grammar: "
                    f"POINT@AT[*COUNT][:ARG])"
                )
            at_s, star, count_s = at_part.partition("*")
            at = int(at_s)
            count = int(count_s) if star else 1
            if at < 0 or count < 1:
                raise ValueError(
                    f"chaos directive {part!r}: AT must be >= 0 and "
                    f"COUNT >= 1"
                )
            directives.append(
                FaultDirective(point=point, at=at, count=count, arg=arg)
            )
        if not directives:
            return None
        return cls(directives, logger=logger)

    def fire(self, point: str, **ctx) -> FaultDirective | None:
        """One arrival at ``point``; returns the directive when it fires
        (the site then applies the fault), else None. ``ctx`` carries the
        ARG-filter key (``tenant`` on serving points, ``kind`` on
        checkpoint points) plus telemetry fields."""
        # ARG-filter key by point family: tenant on serving points, ring
        # kind on checkpoint points, replica id on fleet/net points, op
        # name on journal points. On PAYLOAD-ARG points the ARG is data
        # the fired site reads (net.slow's delay), never a filter.
        ctx_arg = (ctx.get("tenant") or ctx.get("kind")
                   or ctx.get("replica") or ctx.get("op"))
        payload_arg = point in PAYLOAD_ARG_POINTS
        fired = None
        with self._lock:
            for d in self.directives:
                if d.point != point or not (
                    payload_arg or d.matches(ctx_arg)
                ):
                    continue
                # EVERY matching directive counts this arrival — AT is
                # "0-based arrival index at the point", and an earlier
                # directive firing must not make later ones miscount.
                hit = d.hits
                d.hits += 1
                if fired is None and d.at <= hit < d.at + d.count:
                    d.fired += 1
                    fired = d   # one fault per arrival (first match wins)
        if fired is not None:
            rec = {
                "action": "inject", "point": point,
                "seq": fired.fired,
                # "step" is the record's positional field below and
                # "kind" is the record's KIND field — the ckpt points'
                # ring-kind context re-keys as ckpt_kind (the quarantine
                # records' spelling).
                **{("ckpt_kind" if k == "kind" else k): v
                   for k, v in ctx.items()
                   if k != "step" and isinstance(v, (int, float, str))},
            }
            self.fired_log.append(rec)
            if self.logger is not None:
                self.logger.log(
                    int(ctx.get("step", 0)), kind="fault", **rec
                )
        return fired

    def install(self) -> "ChaosRegistry":
        install(self)
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None


# Module-global active registry. The OFF path is the whole point of this
# spelling: one global load + `is None`, no call into the registry.
_ACTIVE: ChaosRegistry | None = None


def install(registry: ChaosRegistry | None) -> None:
    global _ACTIVE
    _ACTIVE = registry


def get_chaos() -> ChaosRegistry | None:
    return _ACTIVE


def chaos_fire(point: str, **ctx) -> FaultDirective | None:
    """The fault-point call sites' single entry: returns the fired
    directive or None. With no registry installed this is allocation-free
    (ctx is built lazily by callers passing literals; the kwargs dict is
    the only cost, and hot paths guard with ``chaos_active()``)."""
    reg = _ACTIVE
    if reg is None:
        return None
    return reg.fire(point, **ctx)


def chaos_active() -> bool:
    """Hot-path guard: lets per-request sites skip even the kwargs-dict
    construction when chaos is off."""
    return _ACTIVE is not None


# --- checkpoint corruption helpers -----------------------------------------
#
# Shared by the ckpt.* fault points (train/checkpoint.py fires them on the
# saver thread) and by drills corrupting slots on disk directly (the
# kill -> corrupt -> resume recipe). Deterministic: the byte offset
# derives from the file name, never from an RNG.


def _largest_file(step_dir: Path) -> Path | None:
    files = [p for p in step_dir.rglob("*") if p.is_file()]
    if not files:
        return None
    return max(files, key=lambda p: p.stat().st_size)


def corrupt_file(target: str | Path, mode: str = "bitflip") -> str | None:
    """Corrupt one file in place: ``bitflip`` flips one byte in each of 8
    stripes (size unchanged, only the integrity chain catches it),
    ``truncate`` cuts it to half (a torn write). Returns its path (str),
    None for an empty file. Deterministic per file name."""
    target = Path(target)
    size = target.stat().st_size
    if size == 0:
        return None
    if mode == "bitflip":
        jitter = sum(target.name.encode()) * 2654435761
        stripes = min(8, size)
        with open(target, "r+b") as f:
            for i in range(stripes):
                off = ((i * size) // stripes + jitter % max(size // stripes, 1)) % size
                f.seek(off)
                b = f.read(1)
                f.seek(off)
                f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
    elif mode == "truncate":
        with open(target, "r+b") as f:
            f.truncate(max(size // 2, 1))
    else:
        raise ValueError(f"unknown corruption mode {mode!r} (bitflip|truncate)")
    return str(target)


def corrupt_step_dir(step_dir: str | Path, mode: str = "bitflip") -> str | None:
    """Corrupt one checkpoint step directory in place: ``bitflip`` flips
    one byte mid-file (silent corruption — the file still parses as far
    as sizes go, only the integrity chain catches it), ``truncate`` cuts
    the largest file to half (torn write — the restore itself fails).
    Returns the corrupted file path (str) or None when the dir holds no
    files. Deterministic per file name."""
    target = _largest_file(Path(step_dir))
    return None if target is None else corrupt_file(target, mode)
