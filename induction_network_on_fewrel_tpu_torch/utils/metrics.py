"""Structured metrics: stderr lines + metrics.jsonl, the telemetry spine's
single emission point, with an optional TensorBoard mirror.

The counterpart of ``induction_network_on_fewrel_tpu/utils/metrics.py``
(``MetricsLogger``, ``KNOWN_KINDS``) with the same record schema: one JSON
object per line with ``step`` (int), ``kind`` (one of ``KNOWN_KINDS``),
``wall_s`` (float) and scalar or string fields; non-finite floats are
written as the strings "nan"/"inf"/"-inf" so every line is strict JSON.
Unless ``quiet``, each record is also printed to stderr as ``[kind]
step=... key=value``. Every record then goes to the registered hooks
(``add_hook``: the flight recorder, then the watchdog) with its raw
floats, so a NaN reaches the watchdog. ``set_identity`` stamps the
process identity and ``t_unix`` on every later record.

``tensorboard_dir``: every numeric field of every record is also written
as a TensorBoard scalar ``<kind>/<field>`` at the record's step, into an
``events.out.tfevents.*`` file that this module writes itself (TFRecord
framing with masked CRC-32C, and hand-encoded ``Event`` protobufs), so
no TensorFlow or TensorBoard package is needed. ``read_events`` reads
such a file back. A directory that cannot be written raises at
construction or at the write; the mirror never turns itself off.
"""

from __future__ import annotations

import json
import math
import os
import socket
import struct
import sys
import threading
import time
from pathlib import Path
from typing import Callable

# The kinds the telemetry stream may carry: the contract
# ``tools/obs_report.py --check`` enforces, the JAX package's list.
KNOWN_KINDS = frozenset({
    "train", "val", "eval", "test", "profile", "serve", "health",
    "divergence", "divergence_stop", "ckpt", "data", "comms", "trace",
    "quality", "scenario", "roofline", "perf", "fault", "fleet", "hop",
    "scale", "adapt", "compile",
})

_IDENTITY_KEYS = ("proc_role", "proc_replica", "proc_pid", "t_unix")


def json_sanitize(v):
    """Strict-JSON-safe scalar: non-finite floats become 'nan'/'inf'/'-inf'."""
    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)
    return v


# --- the TensorBoard event file -------------------------------------------


def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum of the TFRecord framing."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1          # int64 two's complement, as protobuf encodes it
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint(num << 3 | wire)


def _length_delimited(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def encode_event(wall_time: float, step: int, *, file_version: str | None = None,
                 scalars: dict[str, float] | None = None) -> bytes:
    """An ``Event`` protobuf: wall_time (1, double), step (2, int64),
    file_version (3) or summary (5) of ``Summary.Value{tag (1),
    simple_value (2, float)}`` entries."""
    out = _field(1, 1) + struct.pack("<d", wall_time) + _field(2, 0) + _varint(step)
    if file_version is not None:
        out += _length_delimited(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _length_delimited(1, _length_delimited(1, tag.encode())
                              + _field(2, 5) + struct.pack("<f", value))
            for tag, value in scalars.items())
        out += _length_delimited(5, summary)
    return out


def tfrecord(data: bytes) -> bytes:
    """One TFRecord: length, masked CRC of the length, data, masked CRC of
    the data."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", _masked_crc(length)) + data
            + struct.pack("<I", _masked_crc(data)))


class EventFileWriter:
    """Appends scalar summaries to one ``events.out.tfevents.*`` file."""

    def __init__(self, logdir: str | Path):
        logdir = Path(logdir)
        logdir.mkdir(parents=True, exist_ok=True)
        self.path = logdir / (f"events.out.tfevents.{int(time.time())}."
                              f"{socket.gethostname()}.{os.getpid()}")
        self._fh = open(self.path, "ab")
        self._fh.write(tfrecord(encode_event(time.time(), 0, file_version="brain.Event:2")))
        self._fh.flush()

    def add_scalars(self, step: int, scalars: dict[str, float]) -> None:
        self._fh.write(tfrecord(encode_event(time.time(), step, scalars=scalars)))
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, i


def _fields(buf: bytes):
    """(field number, wire type, value) of one protobuf message."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(buf, i)
            v, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield num, wire, v


def read_events(path: str | Path) -> list[tuple[str, int, float]]:
    """(tag, step, simple_value) of every scalar in an event file written
    by ``EventFileWriter``; each record's CRCs are checked."""
    data = Path(path).read_bytes()
    out, i = [], 0
    while i < len(data):
        head = data[i:i + 8]
        (n,) = struct.unpack("<Q", head)
        (crc,) = struct.unpack("<I", data[i + 8:i + 12])
        body = data[i + 12:i + 12 + n]
        (body_crc,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        if crc != _masked_crc(head) or body_crc != _masked_crc(body):
            raise ValueError(f"{path}: corrupt record at byte {i}")
        i += 16 + n
        step = 0
        for num, _, v in _fields(body):
            if num == 2:
                step = v - (1 << 64) if v >= 1 << 63 else v
            elif num == 5:
                for _, _, value in _fields(v):
                    tag, simple = "", 0.0
                    for fnum, _, fv in _fields(value):
                        if fnum == 1:
                            tag = fv.decode()
                        elif fnum == 2:
                            (simple,) = struct.unpack("<f", fv)
                    out.append((tag, step, simple))
    return out


# --- the logger ------------------------------------------------------------


class MetricsLogger:
    def __init__(self, out_dir: str | Path | None = None, quiet: bool = False,
                 tensorboard_dir: str | Path | None = None):
        self.quiet = quiet
        self.path: Path | None = None
        # The persistent append handle is shared by the serving worker and
        # the main thread: writes hold the lock.
        self._fh = None
        self._io_lock = threading.Lock()
        if out_dir is not None:
            out = Path(out_dir)
            out.mkdir(parents=True, exist_ok=True)
            self.path = out / "metrics.jsonl"
        self.hooks: list[Callable[[dict], None]] = []
        self._identity: dict[str, object] = {}
        self._tb = EventFileWriter(tensorboard_dir) if tensorboard_dir is not None else None
        self._t0 = time.monotonic()

    def add_hook(self, hook: Callable[[dict], None]) -> None:
        """Register a per-record observer (watchdog, flight recorder)."""
        if hook not in self.hooks:
            self.hooks.append(hook)

    def set_identity(self, role: str, replica: str | None = None) -> None:
        """Stamp proc_role (and proc_replica), proc_pid and a per-record
        t_unix on every later record."""
        ident: dict[str, object] = {"proc_role": str(role), "proc_pid": os.getpid()}
        if replica is not None:
            ident["proc_replica"] = str(replica)
        self._identity = ident

    def log(self, step: int, kind: str = "train", **scalars) -> None:
        rec = {"step": int(step), "kind": kind,
               "wall_s": round(time.monotonic() - self._t0, 3)}
        if self._identity:
            rec.update(self._identity)
            rec["t_unix"] = round(time.time(), 6)
        rec.update({k: v if isinstance(v, str) else float(v) for k, v in scalars.items()})
        if self.path is not None:
            line = json.dumps({k: json_sanitize(v) for k, v in rec.items()}) + "\n"
            with self._io_lock:
                if self._fh is None or self._fh.closed:
                    self._fh = open(self.path, "a")
                self._fh.write(line)
                self._fh.flush()
        if self._tb is not None:
            numeric = {f"{kind}/{k}": float(v) for k, v in scalars.items()
                       if not isinstance(v, str)}
            if numeric:
                with self._io_lock:
                    self._tb.add_scalars(int(step), numeric)
        if not self.quiet:
            fields = " ".join(
                f"{k}={v}" if isinstance(v, str) else f"{k}={v:.4g}"
                for k, v in rec.items() if k not in ("step", "kind", "wall_s", *_IDENTITY_KEYS)
            )
            print(f"[{kind}] step={step} {fields}", file=sys.stderr, flush=True)
        for hook in self.hooks:
            hook(rec)       # raw floats on purpose: NaN must reach the watchdog

    @property
    def tensorboard_path(self) -> Path | None:
        return None if self._tb is None else self._tb.path

    def close(self) -> None:
        """Release the file handles; a later log() reopens metrics.jsonl in
        append mode (the TensorBoard mirror stays closed)."""
        with self._io_lock:
            if self._fh is not None and not self._fh.closed:
                self._fh.close()
            if self._tb is not None:
                self._tb.close()
                self._tb = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
