"""Socket transport: the ``ReplicaHandle`` interface over JSON-lines TCP.

The wire format is the JAX package's, byte for byte, so a JAX
``SocketReplica`` talks to a port ``ReplicaServer`` and the reverse. A
port replica in a child process shares the parent's card; like every
entry point of the port it refuses to start without CUDA unless told to
run on the CPU.

The router is transport-agnostic: in-process fleets run
``InProcessReplica`` handles, and THIS module puts the exact same
interface over a localhost socket so a real deployment can run one
engine replica per process (or per host) behind the same router code.
One JSON object per line each way:

    request:  {"op": <name>, ...operands}
    response: {"ok": true, ...result} | {"ok": false, "error": <type>,
               "message": str, ...typed-error fields}

Typed serving errors cross the wire by name: ``Saturated`` (with
``retry_after_s``/``tenant``) and ``ExecuteError`` (with ``tenant``/
``retry_after_s``) are re-raised as the SAME types client-side, so the
router's breaker/backpressure logic cannot tell the transports apart —
which is the point.

Publish fan-out over the wire ships the CHECKPOINT DIRECTORY, not a
params tree: replicas of a real multi-process fleet share the training
run's artifact store, and ``publish_prepare`` restores + prepares
locally (phase 1), holding the transaction server-side under a token
until ``publish_commit``/``publish_abort`` (phase 2) — the same
two-phase contract the in-process handle provides, so the fleet control
plane's all-or-nothing fan-out works unchanged across processes.

Scope: the wire format favors clarity over throughput (tokens travel as
JSON); it is the correctness-faithful IPC arm the slow-lane tests
exercise, not a tuned RPC stack.

Trace stitching: the FULL ``TraceContext`` crosses the wire —
``trace_id`` AND ``span_id`` (the originating span, normally the
router's ``fleet/route`` span). The id string alone is NOT enough: a
replica that rebuilds the context with ``span_id=0`` treats its first
span as the trace's origin, and the router→replica parent link is lost
— the stitched waterfall degenerates into two sibling trees that merely
share an id. With the span id carried, the replica's top-level
``serve/*`` spans parent to the router's span exactly as a cross-THREAD
adoption does in-process (obs/spans.SpanTracker.span). Alongside it,
each new connection runs an NTP-style clock handshake: ``op="clock"``
probes collect (t0 send, t1 server recv, t2 server send, t3 recv)
quadruples and ``ClockSync`` keeps a rolling-median offset estimate —
how tools/fleet_report.py aligns replica-side wall clocks onto the
router's timeline.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

from induction_network_on_fewrel_tpu_torch.fleet.router import ReplicaHandle
from induction_network_on_fewrel_tpu_torch.obs.chaos import (
    chaos_active,
    chaos_fire,
)
from induction_network_on_fewrel_tpu_torch.serving.batcher import (
    ExecuteError,
    Saturated,
    TransportTimeout,
)


class ClockSync:
    """NTP-style clock-offset estimator for one router→replica link
   . Each probe contributes four timestamps — t0 client
    send, t1 server receive, t2 server send, t3 client receive — and
    one offset sample ``((t1 - t0) + (t2 - t3)) / 2``: the
    symmetric-path estimate of (server clock − client clock). The
    estimate is the rolling MEDIAN of the last ``window`` samples,
    robust to the occasional probe that straddles a GC pause or a
    loaded accept queue (an asymmetric leg skews the mean, not the
    median). A sample's RTT, ``(t3 - t0) - (t2 - t1)``, bounds its
    error at half-RTT; the median across probes keeps the estimate
    near the fastest probe's bound. Thread-safe: every dialing thread
    of a ``SocketReplica`` feeds the same estimator."""

    __slots__ = ("window", "_samples", "_rtts", "_lock")

    def __init__(self, window: int = 15):
        self.window = max(1, int(window))
        self._samples: list[float] = []
        self._rtts: list[float] = []
        self._lock = threading.Lock()

    def observe(self, t0: float, t1: float, t2: float, t3: float) -> float:
        """Fold one probe quadruple in; returns this probe's offset
        sample (server − client, seconds)."""
        sample = ((t1 - t0) + (t2 - t3)) / 2.0
        rtt = max(0.0, (t3 - t0) - (t2 - t1))
        with self._lock:
            self._samples.append(sample)
            self._rtts.append(rtt)
            if len(self._samples) > self.window:
                del self._samples[0]
                del self._rtts[0]
        return sample

    @property
    def samples(self) -> int:
        with self._lock:
            return len(self._samples)

    def offset_s(self) -> float:
        """Current estimate of (server clock − client clock) in
        seconds; 0.0 before any probe has landed."""
        with self._lock:
            xs = sorted(self._samples)
        if not xs:
            return 0.0
        mid = len(xs) // 2
        if len(xs) % 2:
            return xs[mid]
        return (xs[mid - 1] + xs[mid]) / 2.0

    def rtt_s(self) -> float:
        """Median probe round-trip (the error bound's scale); 0.0
        before any probe."""
        with self._lock:
            xs = sorted(self._rtts)
        if not xs:
            return 0.0
        mid = len(xs) // 2
        if len(xs) % 2:
            return xs[mid]
        return (xs[mid - 1] + xs[mid]) / 2.0


def _inst_to_wire(inst) -> dict:
    return {
        "tokens": list(inst.tokens),
        "head_pos": list(inst.head_pos),
        "tail_pos": list(inst.tail_pos),
    }


def _inst_from_wire(d: dict):
    from induction_network_on_fewrel_tpu_torch.data.fewrel import Instance

    return Instance(
        tokens=tuple(d["tokens"]),
        head_pos=tuple(int(p) for p in d["head_pos"]),
        tail_pos=tuple(int(p) for p in d["tail_pos"]),
    )


def _dataset_to_wire(dataset) -> dict:
    return {
        rel: [_inst_to_wire(i) for i in dataset.instances[rel]]
        for rel in dataset.rel_names
    }


def _dataset_from_wire(d: dict):
    from induction_network_on_fewrel_tpu_torch.data.fewrel import FewRelDataset

    return FewRelDataset({
        rel: [_inst_from_wire(i) for i in insts]
        for rel, insts in d.items()
    })


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        server: ReplicaServer = self.server.replica_server  # type: ignore
        server.track(self.connection)
        try:
            for line in self.rfile:
                line = line.strip()
                if not line:
                    continue
                req = None
                try:
                    req = json.loads(line)
                    resp = server.dispatch(req)
                except Exception as e:  # noqa: BLE001 — typed -> wire
                    resp = _error_response(e)
                self.wfile.write(
                    (json.dumps(resp) + "\n").encode()
                )
                self.wfile.flush()
                if isinstance(req, dict) and req.get("op") == "bye":
                    return
        finally:
            server.untrack(self.connection)


def _error_response(e: BaseException) -> dict:
    resp = {
        "ok": False, "error": type(e).__name__, "message": str(e),
    }
    for field in ("retry_after_s", "tenant"):
        v = getattr(e, field, None)
        if isinstance(v, (int, float, str)):
            resp[field] = v
    return resp


class ReplicaServer:
    """One engine replica served over a JSON-lines socket. Construct
    with a live ``InferenceEngine``; ``start()`` binds (port 0 = pick a
    free one) and serves on daemon threads; ``address`` is what a
    ``SocketReplica`` connects to."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0):
        self.engine = engine
        self._txns: dict[int, object] = {}
        self._txn_seq = 0
        self._txn_lock = threading.Lock()
        self._active: set = set()      # live handler connections
        self._active_lock = threading.Lock()
        srv = socketserver.ThreadingTCPServer(
            (host, port), _Handler, bind_and_activate=True
        )
        srv.daemon_threads = True
        srv.replica_server = self  # type: ignore[attr-defined]
        self._srv = srv
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> tuple[str, int]:
        return self._srv.server_address[:2]

    def start(self) -> "ReplicaServer":
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True,
            name="replica-server",
        )
        self._thread.start()
        return self

    def track(self, conn) -> None:
        with self._active_lock:
            self._active.add(conn)

    def untrack(self, conn) -> None:
        with self._active_lock:
            self._active.discard(conn)

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        # Sever live handler connections too: a stopped server must look
        # like a DEAD PROCESS to its clients (connection reset on the
        # next call), not like a process that stopped listening while
        # old handler threads keep answering — the supervisor's probe
        # depends on the distinction.
        with self._active_lock:
            active, self._active = set(self._active), set()
        for conn in active:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        with self._txn_lock:
            txns, self._txns = dict(self._txns), {}
        for txn in txns.values():
            try:
                txn.abort()
            except Exception:  # noqa: BLE001 — release every serial lock
                pass

    # --- op dispatch ------------------------------------------------------

    def dispatch(self, req: dict) -> dict:
        op = req.get("op")
        eng = self.engine
        if op in ("ping", "bye"):
            return {"ok": True}
        if op == "clock":
            # NTP-style probe: stamp receive and send on the
            # SERVER's wall clock; the client supplies t0/t3 and feeds
            # the quadruple to its ClockSync. Two separate stamps on
            # purpose — the processing gap between them is subtracted
            # out of the client's RTT bound.
            t_recv = time.time()
            return {"ok": True, "t_recv": t_recv, "t_send": time.time()}
        if op == "classify":
            from induction_network_on_fewrel_tpu_torch.obs.spans import (
                TraceContext,
            )

            # Rebuild the FULL context: span_id is the router-side
            # originating span, so this replica's top-level serve/*
            # spans parent to it (the cross-process stitch — the module
            # docstring says why id-only is not enough).
            trace = (
                TraceContext(
                    str(req["trace_id"]),
                    span_id=int(req.get("span_id") or 0),
                )
                if req.get("trace_id") else None
            )
            inst = req["instance"]
            if (isinstance(inst, dict)
                    and {"tokens", "head_pos", "tail_pos"} <= set(inst)):
                inst = _inst_from_wire(inst)
            # Any other dict shape (raw FewRel records, token dicts with
            # defaulted positions) passes through VERBATIM to
            # engine._as_instance — transport parity: every instance
            # shape the in-process handle accepts works over the wire.
            fut = eng.submit(
                inst,
                req.get("deadline_s"), tenant=req.get("tenant", "default"),
                trace=trace,
            )
            timeout = (req.get("deadline_s") or eng.default_deadline_s) + 30.0
            return {"ok": True, "verdict": fut.result(timeout=timeout)}
        if op == "register":
            names = eng.register_dataset(
                _dataset_from_wire(req["dataset"]),
                max_classes=req.get("max_classes"),
                tenant=req.get("tenant", "default"),
            )
            return {"ok": True, "classes": list(names)}
        if op == "set_nota_threshold":
            eng.set_nota_threshold(
                req.get("threshold"), tenant=req.get("tenant", "default")
            )
            return {"ok": True}
        if op == "quarantine":
            eng.quarantine_tenant(req["tenant"], reason=req.get("reason", ""))
            return {"ok": True}
        if op == "unquarantine":
            eng.unquarantine_tenant(
                req["tenant"], reason=req.get("reason", "")
            )
            return {"ok": True}
        if op == "drop_tenant":
            eng.registry.drop_tenant(req["tenant"])
            return {"ok": True}
        if op == "has_tenant":
            return {"ok": True,
                    "has": bool(eng.registry.has_tenant(req["tenant"]))}
        if op == "publish_prepare":
            from induction_network_on_fewrel_tpu_torch.serving.registry import (
                load_params,
            )

            tv = req.get("target_version")
            txn = eng.prepare_publish(
                load_params(req["ckpt_dir"]),
                target_version=int(tv) if tv is not None else None,
            )
            with self._txn_lock:
                self._txn_seq += 1
                token = self._txn_seq
                self._txns[token] = txn
            return {"ok": True, "txn": token}
        if op == "publish_commit":
            txn = self._take_txn(req["txn"])
            return {"ok": True, "version": eng.commit_publish(txn)}
        if op == "publish_abort":
            self._take_txn(req["txn"]).abort()
            return {"ok": True}
        if op == "stats":
            return {"ok": True, "stats": eng.stats.snapshot(
                queue_depth=eng.batcher.queue_depth
            )}
        if op == "params_version":
            return {"ok": True, "version": eng.registry.params_version}
        if op == "warmup":
            return {"ok": True, "compiled": eng.warmup()}
        raise ValueError(f"unknown op {op!r}")

    def _take_txn(self, token):
        with self._txn_lock:
            txn = self._txns.pop(int(token), None)
        if txn is None:
            raise ValueError(f"unknown publish transaction {token!r}")
        return txn


class SocketReplica(ReplicaHandle):
    """Client half: the ``ReplicaHandle`` interface over per-thread
    connections. Each calling thread lazily dials its OWN connection
    (the server is a ThreadingTCPServer — one handler per connection),
    so the ``pool_size`` submit workers drive up to that many classifies
    concurrently and the replica's batcher can actually batch across
    them; ``submit`` runs the blocking classify on the pool so the
    router still gets a Future. Requests on one connection are strictly
    request/response, so no per-connection lock is needed — a
    connection is only ever used by the thread that dialed it.

    Transport hardening: every call carries a PER-CALL
    deadline (``call_deadline_s`` default; classifies get the request
    deadline plus the server's resolve slack) — a wedged peer raises
    the typed ``TransportTimeout`` (a ``DeadlineExceeded``) instead of
    blocking the calling thread forever, and the connection is dropped
    so the next call re-dials. IDEMPOTENT control-plane calls (ping,
    stats, register, thresholds, quarantine flips — never classify,
    never the token-bearing two-phase publish ops) retry up to
    ``retries`` times on connection errors with deterministic
    exponential backoff. The ``net.partition`` / ``net.drop`` /
    ``net.slow`` chaos points fire here, so every failure arm is
    drillable from one ``--chaos`` spec."""

    # Safe to resend: either read-only or last-write-wins on the server.
    # classify is excluded (a retried request could be answered twice
    # under load); the two-phase publish ops are excluded (the txn
    # token is single-shot server-side — a blind resend can double-
    # commit or hit an already-consumed token).
    _IDEMPOTENT_OPS = frozenset({
        "ping", "stats", "params_version", "warmup", "has_tenant",
        "register", "set_nota_threshold", "quarantine", "unquarantine",
        "drop_tenant", "clock",
    })

    # Probes per NEW connection feeding the link's ClockSync: enough
    # for the median to shrug off one slow probe, cheap enough that a
    # re-dial after a transport error stays sub-millisecond on
    # localhost.
    _CLOCK_PROBES = 3

    def __init__(self, replica_id: str, address: tuple[str, int],
                 pool_size: int = 8, timeout_s: float = 120.0,
                 call_deadline_s: float = 30.0, retries: int = 2,
                 retry_backoff_s: float = 0.05):
        self.replica_id = str(replica_id)
        self._address = address
        self._timeout_s = timeout_s          # connect timeout
        self._call_deadline_s = call_deadline_s
        self._retries = max(int(retries), 0)
        self._retry_backoff_s = retry_backoff_s
        self._tls = threading.local()
        self._conns: list[tuple[socket.socket, object]] = []
        self._conns_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=pool_size,
            thread_name_prefix=f"replica-{replica_id}",
        )
        self._closed = False
        self._clock = ClockSync()   # shared across all dialed threads
        self._connect()   # dial eagerly: fail fast on a bad address

    def _connect(self) -> tuple[socket.socket, object]:
        conn = self._dial()
        if not self._clock_handshake(conn):
            # A probe went UNANSWERED (wedged peer, garbled frame):
            # its late reply would be read as the next RPC's response,
            # and a timed-out buffered reader is poisoned for good
            # (CPython latches _timeout_occurred) — so the stream is
            # unusable either way. Replace it with a fresh one, no
            # probes; the offset estimate keeps whatever samples
            # earlier connections contributed.
            self._drop_conn(conn)
            conn = self._dial()
        return conn

    def _dial(self) -> tuple[socket.socket, object]:
        sock = socket.create_connection(
            self._address, timeout=self._timeout_s
        )
        conn = (sock, sock.makefile("rb"))
        self._tls.conn = conn
        with self._conns_lock:
            self._conns.append(conn)
        return conn

    def _clock_handshake(self, conn) -> bool:
        """Per-connection NTP-style offset probes. Writes
        directly on the fresh socket (NOT through ``_call`` — we are
        inside ``_connect`` and must not recurse). Best-effort for the
        ESTIMATE (a refused probe leaves the rolling median as it was)
        but strict about FRAMING: returns False iff a probe went
        unanswered or unparseable, i.e. the request/response stream
        can no longer be trusted and the caller must replace it."""
        sock, rfile = conn
        try:
            sock.settimeout(min(self._call_deadline_s, 5.0))
            for _ in range(self._CLOCK_PROBES):
                t0 = time.time()
                sock.sendall(b'{"op": "clock"}\n')
                line = rfile.readline()
                t3 = time.time()
                if not line:
                    return False      # peer closed mid-handshake
                try:
                    resp = json.loads(line)
                except ValueError:
                    return False      # garbled frame: desynced
                if not resp.get("ok"):
                    # An answered refusal (older server): the
                    # framing is intact, there is just no clock op.
                    return True
                try:
                    self._clock.observe(
                        t0, float(resp["t_recv"]), float(resp["t_send"]),
                        t3,
                    )
                except (KeyError, TypeError, ValueError):
                    return True       # answered but malformed fields
            return True
        except OSError:
            return False              # timeout/transport fault mid-probe

    @property
    def clock_offset_s(self) -> float:
        """Estimated (replica clock − router clock), seconds — the
        rolling median over this handle's connection handshakes. The
        router stamps it on ``kind="hop"`` records as ``offset_ms``."""
        return self._clock.offset_s()

    def _drop_conn(self, conn) -> None:
        """Invalidate this thread's cached connection: after any
        transport error (broken pipe, timeout mid-response) the socket
        is dead or DESYNCED (a late response line would be read as the
        next request's reply) — the next call from this thread must
        re-dial, which is also what lets a half-open recovery probe
        succeed once a restarted replica process is back."""
        if getattr(self._tls, "conn", None) is conn:
            self._tls.conn = None
        with self._conns_lock:
            if conn in self._conns:
                self._conns.remove(conn)
        sock, rfile = conn
        for closer in (rfile.close, sock.close):
            try:
                closer()
            except OSError:
                pass

    def _call(self, _deadline: float | None = None, **req) -> dict:
        """One request/response with bounded retry: idempotent ops
        resend on CONNECTION errors (never on ``TransportTimeout`` —
        a wedged peer costs a full deadline per attempt, and the
        supervisor/breaker own that diagnosis); everything else
        surfaces the first failure."""
        if self._closed:
            # Local refusal, not a transport fault: retrying a closed
            # handle can never succeed — fail immediately, before the
            # retry loop burns its backoff budget on it.
            raise ConnectionError(f"replica {self.replica_id}: closed")
        op = req.get("op")
        budget = self._retries if op in self._IDEMPOTENT_OPS else 0
        attempt = 0
        while True:
            try:
                return self._call_once(_deadline, req)
            except TransportTimeout:
                raise
            except OSError:
                if attempt >= budget:
                    raise
                attempt += 1
                # Deterministic exponential backoff — no RNG (the
                # chaos/drill replay discipline); per-thread, so no
                # herd to de-synchronize.
                time.sleep(self._retry_backoff_s * (2.0 ** (attempt - 1)))

    def _call_once(self, deadline_s: float | None, req: dict) -> dict:
        if self._closed:
            raise ConnectionError(f"replica {self.replica_id}: closed")
        if chaos_active():
            if chaos_fire("net.partition",
                          replica=self.replica_id) is not None:
                raise ConnectionError(
                    f"replica {self.replica_id}: injected partition"
                )
            slow = chaos_fire("net.slow", replica=self.replica_id)
            if slow is not None:
                time.sleep(float(slow.arg or 0.05))
        conn = getattr(self._tls, "conn", None)
        if conn is None:
            conn = self._connect()
        sock, rfile = conn
        deadline = (self._call_deadline_s if deadline_s is None
                    else deadline_s)
        try:
            sock.settimeout(deadline)
            sock.sendall((json.dumps(req) + "\n").encode())
            if chaos_active() and chaos_fire(
                    "net.drop", replica=self.replica_id) is not None:
                # The response is "lost": the peer may well have acted —
                # exactly why only idempotent ops retry.
                self._drop_conn(conn)
                raise ConnectionError(
                    f"replica {self.replica_id}: injected response drop"
                )
            line = rfile.readline()
        except socket.timeout:
            # The per-call deadline: a wedged peer must not
            # block this thread forever. The connection is DESYNCED by
            # construction (a late response line would answer the next
            # request) — drop it; typed so callers and the router's
            # breaker can tell transport wedge (health) from a server-
            # side deadline miss (load).
            self._drop_conn(conn)
            raise TransportTimeout(
                f"replica {self.replica_id}: no response within "
                f"{deadline:.1f}s (per-call deadline)"
            )
        except OSError:
            self._drop_conn(conn)
            raise
        if not line:
            self._drop_conn(conn)
            raise ConnectionError(
                f"replica {self.replica_id}: connection closed"
            )
        resp = json.loads(line)
        if resp.get("ok"):
            return resp
        err, msg = resp.get("error"), resp.get("message", "")
        if err == "Saturated":
            raise Saturated(
                float(resp.get("retry_after_s", 0.05)),
                tenant=resp.get("tenant"),
            )
        if err == "ExecuteError":
            raise ExecuteError(
                str(resp.get("tenant", "?")),
                retry_after_s=float(resp.get("retry_after_s", 0.05)),
                cause=RuntimeError(msg),
            )
        if err == "DeadlineExceeded":
            from induction_network_on_fewrel_tpu_torch.serving.batcher import (
                DeadlineExceeded,
            )

            raise DeadlineExceeded(msg)
        raise RuntimeError(f"replica {self.replica_id}: {err}: {msg}")

    # --- ReplicaHandle ----------------------------------------------------

    def submit(self, instance, deadline_s=None, tenant="default",
               trace=None) -> Future:
        wire = _inst_to_wire(instance) if hasattr(instance, "tokens") \
            else instance
        # The transport read deadline must sit ABOVE the server's
        # resolve window (request deadline + its 30 s result slack) so
        # a server-side deadline miss comes back as the typed wire
        # error, and TransportTimeout fires only when the peer answers
        # NOTHING — a wedged process, the case that is health.
        wire_deadline = (
            deadline_s if deadline_s is not None else self._call_deadline_s
        ) + 35.0
        return self._pool.submit(
            lambda: self._call(
                _deadline=wire_deadline,
                op="classify", instance=wire, deadline_s=deadline_s,
                tenant=tenant,
                trace_id=trace.trace_id if trace is not None else None,
                # The parent link: without span_id the
                # replica re-roots the trace and the stitched chain
                # breaks — see the module docstring.
                span_id=trace.span_id if trace is not None else None,
            )["verdict"]
        )

    def ping(self) -> bool:
        return bool(self._call(op="ping").get("ok"))

    def has_tenant(self, tenant) -> bool:
        return bool(self._call(op="has_tenant", tenant=tenant)["has"])

    def register_dataset(self, dataset, tenant, max_classes=None):
        # Registration distills server-side (and may compile on the
        # first shape): same headroom as the publish ops.
        return self._call(
            _deadline=max(self._call_deadline_s, 120.0),
            op="register", dataset=_dataset_to_wire(dataset),
            tenant=tenant, max_classes=max_classes,
        )["classes"]

    def set_nota_threshold(self, threshold, tenant):
        self._call(op="set_nota_threshold", threshold=threshold,
                   tenant=tenant)

    def quarantine_tenant(self, tenant, reason=""):
        self._call(op="quarantine", tenant=tenant, reason=reason)

    def unquarantine_tenant(self, tenant, reason=""):
        self._call(op="unquarantine", tenant=tenant, reason=reason)

    def drop_tenant(self, tenant):
        self._call(op="drop_tenant", tenant=tenant)

    def prepare_publish(self, params=None, ckpt_dir=None,
                        target_version=None):
        if ckpt_dir is None:
            raise ValueError(
                "socket replicas publish from a shared checkpoint "
                "directory (pass ckpt_dir; a raw params tree does not "
                "cross the wire)"
            )
        # Prepare restores + re-distills server-side: give it headroom
        # beyond the default control-plane deadline.
        return self._call(
            _deadline=max(self._call_deadline_s, 120.0),
            op="publish_prepare", ckpt_dir=str(ckpt_dir),
            target_version=target_version,
        )["txn"]

    def commit_publish(self, txn) -> int:
        return int(self._call(
            _deadline=max(self._call_deadline_s, 120.0),
            op="publish_commit", txn=txn,
        )["version"])

    def abort_publish(self, txn) -> None:
        self._call(op="publish_abort", txn=txn)

    @property
    def params_version(self) -> int:
        return int(self._call(op="params_version")["version"])

    def stats_snapshot(self) -> dict:
        return self._call(op="stats")["stats"]

    def warmup(self) -> int:
        # Warmup AOT-compiles every bucket program — the slowest
        # control-plane op by far on a cold process.
        return int(self._call(
            _deadline=max(self._call_deadline_s, 300.0), op="warmup",
        )["compiled"])

    def close(self) -> None:
        if self._closed:
            return
        try:
            self._call(op="bye")   # best-effort, this thread's conn
        except Exception:  # noqa: BLE001 — closing a dead socket is fine
            pass
        self._closed = True
        self._pool.shutdown(wait=False)
        with self._conns_lock:
            conns, self._conns = list(self._conns), []
        for sock, rfile in conns:
            for closer in (rfile.close, sock.close):
                try:
                    closer()
                except OSError:
                    pass


def serve_replica_main(argv=None) -> int:
    """One replica process: an engine on a port checkpoint behind a
    ``ReplicaServer``. Prints ``{"address": [host, port]}`` on one line of
    stdout once it listens, then serves until stdin closes (the parent's
    handle on its lifetime) or SIGTERM. On the GPU by default: without
    CUDA it refuses to start unless ``--device cpu`` is given.

        python -m induction_network_on_fewrel_tpu_torch.fleet.transport \\
            --load_ckpt DIR [--buckets 1,2,4,8,16] [--port 0] [--device cpu]
    """
    import argparse
    import signal
    import sys

    from induction_network_on_fewrel_tpu_torch.serving.engine import InferenceEngine

    p = argparse.ArgumentParser(prog="python -m induction_network_on_fewrel_tpu_torch."
                                     "fleet.transport",
                                description="one fleet replica over the socket transport")
    p.add_argument("--load_ckpt", required=True, help="port checkpoint directory to serve")
    p.add_argument("--glove", default=None, help="the vocabulary the model was trained with")
    p.add_argument("--glove_mat", default=None)
    p.add_argument("--buckets", default="1,2,4,8,16")
    p.add_argument("--K", type=int, default=None, help="shots per class (default: the config's)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0, help="0 = a free port")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the GPU (refuses to start without CUDA)")
    args = p.parse_args(argv)
    engine = InferenceEngine.from_checkpoint(
        args.load_ckpt, device=args.device, glove=args.glove, glove_mat=args.glove_mat,
        k=args.K, buckets=tuple(int(b) for b in args.buckets.split(",")))
    server = ReplicaServer(engine, host=args.host, port=args.port).start()
    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    threading.Thread(target=lambda: (sys.stdin.read(), done.set()), daemon=True).start()
    print(json.dumps({"address": list(server.address)}), flush=True)
    try:
        done.wait()
    finally:
        server.stop()
        engine.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(serve_replica_main())
