"""Durable control plane, layer 1: a write-ahead log of every
fleet control-plane op, so a router crash loses NOTHING.

Every piece of fleet state the router holds in memory — the tenant
directory (support sources, NOTA thresholds, quarantine flags), replica
membership/drain states, the committed params_version + checkpoint path,
adaptation exhaustion latches — is exactly the state Geng 2019's
per-relation class vectors and Gao 2019's per-tenant NOTA/DA knobs hang
off, and before this module it lived only in process memory. The journal
makes it an append-only on-disk log with:

* **Per-record framing**: ``[u32 length][u32 crc32][payload]`` per
  record, payload = canonical JSON (sorted keys, no timestamps). A torn
  tail — a crash mid-write, a truncated disk flush, the injected
  ``journal.torn_write`` chaos point — fails the length or CRC check at
  exactly one record, and replay TRUNCATES there: everything before the
  tear is recovered, nothing after it can poison the directory
  (``kind="fault"`` ``action="journal_truncated"`` tells the operator).
* **An fsync policy knob** (``fsync=``): ``"always"`` fsyncs every
  append (maximum durability, one disk sync per control-plane op),
  ``"commit"`` (default) fsyncs only generation-changing ops
  (``publish_commit``) and compactions — tenant churn rides the OS page
  cache, the committed generation never does — and ``"off"`` leaves
  syncing to the OS (drills/tests). The tradeoff is RUNBOOK §20's.
* **Snapshot compaction**: ``compact()`` folds the materialized state
  into ``snapshot.json`` (atomic tmp+rename) and truncates the WAL;
  replay = snapshot + remaining WAL ops, proven equivalent to the full
  log (test-pinned). ``compact_every=N`` auto-compacts when the WAL
  exceeds N records, bounding replay time and disk growth.
* **Deterministic replay**: ``materialize()`` is a pure function of the
  recorded op sequence — no clocks, no RNG, no process state — so every
  router restart, every test, and every compacted/uncompacted pair
  rebuilds the SAME state, and placement stays the pure rendezvous
  function it already was (placements are never journaled; they are
  recomputed from tenant ids + the replayed replica states).

The journal never imports the router/transport layers: callers hand it
JSON-ready payloads (``fleet/control.py`` converts datasets to their
wire form before journaling) so this module has no import cycle and no
serialization opinions of its own.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from pathlib import Path

from induction_network_on_fewrel_tpu_torch.obs.chaos import chaos_fire

WAL_NAME = "wal.log"
SNAPSHOT_NAME = "snapshot.json"
LEASE_NAME = "lease.json"

_HEADER = struct.Struct("<II")   # (payload length, crc32(payload))

FSYNC_POLICIES = ("always", "commit", "off")

# Ops whose loss a crash must never cause — under fsync="commit" these
# (and compactions) are the only syncs: the committed generation, and
# the PERMANENT adaptation-exhaustion latch (rare by construction — one
# append per burned retry budget — and the whole point of journaling it
# is surviving exactly the crash class an unsynced page cache loses).
_COMMIT_OPS = frozenset({"publish_commit", "adapt_exhausted"})

# The full control-plane op vocabulary. An op outside this set is a
# programming error at append time (the FeedFaults rule: refusing loudly
# beats replaying garbage later).
KNOWN_OPS = frozenset({
    "tenant_register",      # tenant, source (wire dict), max_classes,
    #                         nota_threshold (optional)
    "tenant_threshold",     # tenant, threshold
    "tenant_quarantine",    # tenant, reason
    "tenant_unquarantine",  # tenant, reason
    "tenant_drop",          # tenant
    "replica_add",          # replica, meta (optional address dict)
    "replica_drain",        # replica
    "replica_revive",       # replica
    "replica_retire",       # replica (drained out of membership for good)
    "replica_forgive",      # replica (supervisor restart-budget re-arm;
    #                         an audit record — replay-neutral, because
    #                         supervisor budgets are process-local)
    "publish_commit",       # params_version, ckpt_dir (nullable)
    "adapt_exhausted",      # tenant, attempts (the permanent latch)
})


class JournalError(RuntimeError):
    """A journal-layer refusal: unknown op, bad knob, replaying an
    inconsistent prefix (which a CRC-clean journal cannot produce), or
    appending to a journal whose tail was torn by the injected
    ``journal.torn_write`` fault (the simulated crash ends this
    process's writes; recovery reopens the directory)."""


class JournalState:
    """The materialized control-plane state: a pure fold of the op
    sequence. Canonical (``to_dict`` sorts everything), so two replays
    of the same ops compare byte-identical through ``json.dumps``."""

    def __init__(self):
        # tenant -> {source, max_classes, nota_threshold, quarantined}
        self.tenants: dict[str, dict] = {}
        self.replicas: dict[str, str] = {}   # replica -> up|draining
        # The last committed publish: params_version + the checkpoint
        # path a catch-up can re-drive it from (None for params-only
        # publishes — version reconciliation still works, re-driving
        # does not; recovery surfaces that as replica_stale_params).
        self.committed: dict = {"params_version": 0, "ckpt_dir": None}
        self.adapt_exhausted: dict[str, float] = {}   # tenant -> attempts
        self.applied = 0    # ops folded in (snapshot base + WAL)

    def apply(self, rec: dict) -> None:
        op = rec.get("op")
        t = rec.get("tenant")
        if op == "tenant_register":
            self.tenants[t] = {
                "source": rec.get("source"),
                "max_classes": rec.get("max_classes"),
                "nota_threshold": rec.get("nota_threshold"),
                "quarantined": False,
            }
        elif op == "tenant_threshold":
            self._tenant(rec)["nota_threshold"] = rec.get("threshold")
        elif op == "tenant_quarantine":
            self._tenant(rec)["quarantined"] = True
        elif op == "tenant_unquarantine":
            self._tenant(rec)["quarantined"] = False
        elif op == "tenant_drop":
            self.tenants.pop(t, None)
        elif op == "replica_add":
            self.replicas[str(rec.get("replica"))] = "up"
        elif op == "replica_drain":
            self.replicas[str(rec.get("replica"))] = "draining"
        elif op == "replica_revive":
            self.replicas[str(rec.get("replica"))] = "up"
        elif op == "replica_retire":
            self.replicas.pop(str(rec.get("replica")), None)
        elif op == "replica_forgive":
            pass   # audit-only: restart budgets are process-local state
        elif op == "publish_commit":
            self.committed = {
                "params_version": int(rec["params_version"]),
                "ckpt_dir": rec.get("ckpt_dir"),
            }
        elif op == "adapt_exhausted":
            self.adapt_exhausted[t] = float(rec.get("attempts", 0))
        else:
            raise JournalError(f"unknown journal op {op!r} in replay")
        self.applied += 1

    def _tenant(self, rec: dict) -> dict:
        entry = self.tenants.get(rec.get("tenant"))
        if entry is None:
            # Unreachable through the framing: truncation only removes a
            # TAIL, so every CRC-clean prefix is self-consistent.
            raise JournalError(
                f"journal op {rec.get('op')!r} for unregistered tenant "
                f"{rec.get('tenant')!r}"
            )
        return entry

    def to_dict(self) -> dict:
        return {
            "tenants": {t: dict(self.tenants[t])
                        for t in sorted(self.tenants)},
            "replicas": {r: self.replicas[r]
                         for r in sorted(self.replicas)},
            "committed": dict(self.committed),
            "adapt_exhausted": {t: self.adapt_exhausted[t]
                                for t in sorted(self.adapt_exhausted)},
            "applied": self.applied,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "JournalState":
        st = cls()
        st.tenants = {t: dict(v) for t, v in d.get("tenants", {}).items()}
        st.replicas = dict(d.get("replicas", {}))
        st.committed = dict(
            d.get("committed", {"params_version": 0, "ckpt_dir": None})
        )
        st.adapt_exhausted = dict(d.get("adapt_exhausted", {}))
        st.applied = int(d.get("applied", 0))
        return st


class FleetJournal:
    """One journal directory: ``wal.log`` (framed records) +
    ``snapshot.json`` (the compaction base). Thread-safe — control-plane
    ops journal from client threads, the supervisor from its loop."""

    def __init__(self, out_dir: str | Path, fsync: str = "commit",
                 compact_every: int = 0, logger=None):
        if fsync not in FSYNC_POLICIES:
            raise JournalError(
                f"unknown fsync policy {fsync!r} (one of {FSYNC_POLICIES})"
            )
        if compact_every < 0:
            raise JournalError("compact_every must be >= 0 (0 = manual)")
        self.dir = Path(out_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.fsync = fsync
        self.compact_every = compact_every
        self._logger = logger
        self._lock = threading.RLock()
        self._fh = None
        self._torn = False   # set by the injected torn write: the
        #                      "process" died mid-append; reopen to heal
        self.snapshot_seq = 0     # ops folded into snapshot.json
        self._wal_records = 0
        self._lease_owner = None   # set by acquire_lease/adopt_lease
        self._lease_epoch = None
        snap = self.dir / SNAPSHOT_NAME
        if snap.exists():
            self.snapshot_seq = int(
                json.loads(snap.read_text()).get("applied", 0)
            )
        # Opening IS recovery: a torn tail from a previous crash is
        # truncated now, so appends land on a clean frame boundary.
        self._recover_tail()

    # --- write side -------------------------------------------------------

    @property
    def records(self) -> int:
        """WAL records on disk (excludes ops folded into the snapshot)."""
        return self._wal_records

    @property
    def seq(self) -> int:
        """Total ops this journal holds (snapshot base + WAL)."""
        return self.snapshot_seq + self._wal_records

    def append(self, op: str, **fields) -> int:
        """Append one op; returns its 0-based sequence number. Fields
        must be JSON-ready (callers serialize datasets to wire form
        first) and must not carry timestamps — replay is deterministic
        by contract."""
        if op not in KNOWN_OPS:
            raise JournalError(
                f"unknown journal op {op!r} (known: "
                f"{', '.join(sorted(KNOWN_OPS))})"
            )
        with self._lock:
            if self._torn:
                raise JournalError(
                    "journal tail is torn (injected journal.torn_write): "
                    "the writing process is 'dead' — reopen the journal "
                    "directory to truncate and recover"
                )
            self._check_lease()
            seq = self.seq
            payload = json.dumps(
                {"op": op, "seq": seq, **fields}, sort_keys=True
            ).encode()
            header = _HEADER.pack(len(payload), zlib.crc32(payload))
            fired = chaos_fire("journal.torn_write", op=op, step=seq)
            fh = self._open()
            if fired is not None:
                # The simulated crash: the header claims the full record
                # but only half the payload reaches disk. This journal
                # object refuses further writes (the process died);
                # recovery = reopen, which truncates the tear.
                fh.write(header + payload[: max(len(payload) // 2, 1)])
                fh.flush()
                self._torn = True
                return seq
            fh.write(header + payload)
            fh.flush()
            if self.fsync == "always" or (
                self.fsync == "commit" and op in _COMMIT_OPS
            ):
                os.fsync(fh.fileno())
            self._wal_records += 1
            if self.compact_every and self._wal_records >= self.compact_every:
                self._compact_locked()
        # One kind="fleet" event="journal_op" record per append: the WAL payload itself carries NO timestamp (replay is
        # deterministic by contract, above), so THIS record is where a
        # control-plane decision acquires its wall-clock position on
        # the fleet timeline — tools/fleet_report.py orders journal ops
        # by these records and cross-checks op/seq against the replayed
        # WAL. Emitted outside the journal lock: the logger has its own
        # lock, and a slow metrics disk must not serialize appends.
        if self._logger is not None:
            self._logger.log(
                seq, kind="fleet", event="journal_op", op=op,
                seq=float(seq),
            )
        return seq

    def sync(self) -> None:
        """Force an fsync regardless of policy (operator barrier)."""
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                os.fsync(self._fh.fileno())

    # --- single-writer lease ----------------------------------------------

    def acquire_lease(self, owner: str) -> int:
        """Take (or take over) the journal's single-writer lease. Every
        acquisition bumps the epoch; from then on every ``append`` checks
        the lease file and REFUSES when another writer holds a newer
        epoch — a fenced-off zombie primary cannot split-brain the log."""
        with self._lock:
            epoch = JournalLease(self.dir).acquire(owner)
            self._lease_owner = owner
            self._lease_epoch = epoch
            return epoch

    def adopt_lease(self, owner: str, epoch: int) -> None:
        """Bind to a lease already acquired out-of-band (the standby
        acquires BEFORE opening its own ``FleetJournal``, so the fence is
        up during the catch-up replay, not after)."""
        with self._lock:
            self._lease_owner = owner
            self._lease_epoch = int(epoch)

    def _check_lease(self) -> None:
        if self._lease_epoch is None:
            return   # unleased journal: single-process mode, no fence
        held = JournalLease(self.dir).read()
        if (held.get("epoch") != self._lease_epoch
                or held.get("owner") != self._lease_owner):
            raise JournalError(
                f"journal lease lost: held by "
                f"{held.get('owner')!r} epoch {held.get('epoch')} "
                f"(we are {self._lease_owner!r} epoch {self._lease_epoch}) "
                "— split-brain append refused"
            )

    def _open(self):
        if self._fh is None or self._fh.closed:
            self._fh = open(self.dir / WAL_NAME, "ab")
        return self._fh

    def close(self) -> None:
        with self._lock:
            if self._fh is not None and not self._fh.closed:
                self._fh.close()

    # --- read side --------------------------------------------------------

    def _scan(self, repair: bool) -> tuple[list[dict], int]:
        """Parse the WAL: (records, bytes of clean prefix). A short or
        CRC-failing record is a TEAR: everything from its frame start is
        dropped; with ``repair`` the file is truncated there (and the
        truncation is told as a kind='fault' record)."""
        path = self.dir / WAL_NAME
        if not path.exists():
            return [], 0
        blob = path.read_bytes()
        records: list[dict] = []
        off = 0
        clean = 0
        reason = None
        while off + _HEADER.size <= len(blob):
            length, crc = _HEADER.unpack_from(blob, off)
            start, end = off + _HEADER.size, off + _HEADER.size + length
            if end > len(blob):
                reason = "short payload (torn write)"
                break
            payload = blob[start:end]
            if zlib.crc32(payload) != crc:
                reason = "crc mismatch (corrupt record)"
                break
            try:
                rec = json.loads(payload)
            except json.JSONDecodeError:
                reason = "unparseable payload"
                break
            records.append(rec)
            off = end
            clean = off
        else:
            if off < len(blob):
                reason = "trailing partial header"
        if clean < len(blob) and repair:
            dropped = len(blob) - clean
            with open(path, "r+b") as f:
                f.truncate(clean)
            if self._logger is not None:
                self._logger.log(
                    len(records), kind="fault", action="journal_truncated",
                    reason=reason or "torn tail",
                    bytes_dropped=float(dropped),
                    records_kept=float(len(records)),
                )
        return records, clean

    def _recover_tail(self) -> None:
        records, _ = self._scan(repair=True)
        self._wal_records = len(records)
        self._torn = False

    def replay(self) -> list[dict]:
        """The WAL records (clean prefix only; repairs a torn tail in
        place, exactly like construction does)."""
        with self._lock:
            if self._fh is not None and not self._fh.closed:
                self._fh.flush()
            records, _ = self._scan(repair=True)
            self._wal_records = len(records)
            return records

    def materialize(self) -> JournalState:
        """Snapshot base + WAL ops folded into one ``JournalState`` —
        the pure, deterministic replay every recovery path runs."""
        with self._lock:
            snap_path = self.dir / SNAPSHOT_NAME
            if snap_path.exists():
                state = JournalState.from_dict(
                    json.loads(snap_path.read_text())
                )
            else:
                state = JournalState()
            for rec in self.replay():
                state.apply(rec)
            return state

    # --- compaction -------------------------------------------------------

    def compact(self) -> JournalState:
        """Fold the full log into ``snapshot.json`` and truncate the
        WAL. Crash-safe: the snapshot lands by atomic rename BEFORE the
        WAL truncates, so a crash between the two replays snapshot + the
        (re-applied, idempotent-by-construction) WAL ops — every op
        apply is a plain overwrite, so double-application of a suffix
        cannot diverge the state."""
        with self._lock:
            return self._compact_locked()

    def _compact_locked(self) -> JournalState:
        state = self.materialize()
        tmp = self.dir / (SNAPSHOT_NAME + ".tmp")
        snap = json.dumps(state.to_dict(), sort_keys=True, indent=1)
        with open(tmp, "w") as f:
            f.write(snap + "\n")
            f.flush()
            if self.fsync != "off":
                os.fsync(f.fileno())
        os.replace(tmp, self.dir / SNAPSHOT_NAME)
        if self._fh is not None and not self._fh.closed:
            self._fh.close()
            self._fh = None
        with open(self.dir / WAL_NAME, "wb") as f:
            if self.fsync != "off":
                f.flush()
                os.fsync(f.fileno())
        self.snapshot_seq = state.applied
        self._wal_records = 0
        if self._logger is not None:
            self._logger.log(
                state.applied, kind="fleet", event="journal_compact",
                snapshot_seq=float(state.applied),
                tenants=float(len(state.tenants)),
            )
        return state


class JournalLease:
    """The journal directory's single-writer latch: ``lease.json`` holds
    ``{"owner", "epoch"}``, written by atomic tmp+rename. ``acquire``
    bumps the epoch, so a standby taking over FENCES the old primary —
    the zombie's next ``append`` reads a lease it no longer holds and
    raises instead of split-braining the log. This is a cooperative
    lease (every writer goes through ``FleetJournal.append``'s check),
    which is exactly the guarantee a single-host drill can prove."""

    def __init__(self, journal_dir: str | Path):
        self.path = Path(journal_dir) / LEASE_NAME

    def read(self) -> dict:
        """The current lease ({"owner": None, "epoch": 0} when unheld)."""
        if not self.path.exists():
            return {"owner": None, "epoch": 0}
        try:
            d = json.loads(self.path.read_text())
        except (json.JSONDecodeError, OSError):
            return {"owner": None, "epoch": 0}
        return {"owner": d.get("owner"), "epoch": int(d.get("epoch", 0))}

    def acquire(self, owner: str) -> int:
        """Take the lease as ``owner``; returns the new (bumped) epoch."""
        epoch = self.read()["epoch"] + 1
        tmp = self.path.with_suffix(".tmp")
        with open(tmp, "w") as f:
            json.dump({"owner": owner, "epoch": epoch}, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        return epoch


class JournalTailer:
    """A READ-ONLY incremental reader of a journal another process owns —
    the hot standby's view of the primary's WAL. Unlike ``FleetJournal``,
    the tailer NEVER truncates: a short or CRC-failing tail here is most
    likely an append in progress by the live primary, so the tailer stops
    at the last clean frame and retries from there next ``poll``.

    Compaction-aware: when the primary folds the WAL into
    ``snapshot.json`` (the WAL shrinks under our offset, or the snapshot
    base advances past ours), the tailer rebases — reload the snapshot,
    re-read the fresh WAL from byte 0. A compaction racing a single poll
    can transiently rebase on the pre-compact snapshot; the next poll
    reads the settled pair and self-heals (``JournalState.apply`` is a
    pure overwrite-fold, so re-application cannot diverge the state)."""

    def __init__(self, journal_dir: str | Path):
        self.dir = Path(journal_dir)
        self.state = JournalState()
        self._offset = 0         # clean WAL bytes folded into state
        self._snap_applied = 0   # snapshot base folded into state

    @property
    def applied(self) -> int:
        """Total ops folded into the tailed state (mirrors journal.seq)."""
        return self.state.applied

    def poll(self) -> int:
        """Fold newly committed ops into the tailed state; returns how
        many ops the state advanced by this call."""
        before = self.state.applied
        snap = None
        snap_path = self.dir / SNAPSHOT_NAME
        if snap_path.exists():
            try:
                snap = json.loads(snap_path.read_text())
            except (json.JSONDecodeError, OSError):
                snap = None   # racing the atomic rename; next poll wins
        snap_applied = int(snap.get("applied", 0)) if snap else 0
        wal = self.dir / WAL_NAME
        wal_size = wal.stat().st_size if wal.exists() else 0
        if snap_applied > self._snap_applied or wal_size < self._offset:
            # The primary compacted: rebase on the snapshot, restart the
            # WAL read from byte 0.
            self.state = (JournalState.from_dict(snap) if snap
                          else JournalState())
            self._snap_applied = snap_applied
            self._offset = 0
        records, clean = self._read_from(self._offset)
        for rec in records:
            self.state.apply(rec)
        self._offset = clean
        return self.state.applied - before

    def records(self) -> list[dict]:
        """The WAL's clean-frame records from byte 0, read-only — no
        state fold, no truncation. tools/fleet_report.py's replay
        source: each record carries ``op`` and ``seq``, cross-checked
        against the router's ``kind="fleet"`` ``event="journal_op"``
        telemetry. Ops folded into a snapshot are NOT here;
        the snapshot's ``applied`` count says how many seqs precede the
        WAL."""
        return self._read_from(0)[0]

    def _read_from(self, offset: int) -> tuple[list[dict], int]:
        """Parse complete frames from ``offset``; returns (records, new
        clean offset). Read-only — a torn/in-progress tail is left for
        the next poll, never truncated."""
        path = self.dir / WAL_NAME
        if not path.exists():
            return [], offset
        with open(path, "rb") as f:
            f.seek(offset)
            blob = f.read()
        records: list[dict] = []
        off = 0
        clean = 0
        while off + _HEADER.size <= len(blob):
            length, crc = _HEADER.unpack_from(blob, off)
            start, end = off + _HEADER.size, off + _HEADER.size + length
            if end > len(blob):
                break
            payload = blob[start:end]
            if zlib.crc32(payload) != crc:
                break
            try:
                rec = json.loads(payload)
            except json.JSONDecodeError:
                break
            records.append(rec)
            off = end
            clean = off
        return records, offset + clean
