"""Structured metrics: stderr lines + metrics.jsonl.

The subset of ``induction_network_on_fewrel_tpu/utils/metrics.py``
(``MetricsLogger``) that the trainer needs, with the same record schema:
one JSON object per line with ``step`` (int), ``kind`` (train/val/test),
``wall_s`` (float) and scalar fields; non-finite floats are written as the
strings "nan"/"inf"/"-inf" so every line is strict JSON. Unless ``quiet``,
each record is also printed to stderr as ``[kind] step=... key=value``.
"""

from __future__ import annotations

import json
import math
import sys
import threading
import time
from pathlib import Path


def json_sanitize(v):
    """Strict-JSON-safe scalar: non-finite floats become 'nan'/'inf'/'-inf'."""
    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)
    return v


class MetricsLogger:
    def __init__(self, out_dir: str | Path | None = None, quiet: bool = False):
        self.quiet = quiet
        self.path: Path | None = None
        self._fh = None
        self._io_lock = threading.Lock()
        if out_dir is not None:
            out = Path(out_dir)
            out.mkdir(parents=True, exist_ok=True)
            self.path = out / "metrics.jsonl"
        self._t0 = time.monotonic()

    def log(self, step: int, kind: str = "train", **scalars) -> None:
        rec = {"step": int(step), "kind": kind,
               "wall_s": round(time.monotonic() - self._t0, 3)}
        rec.update({k: v if isinstance(v, str) else float(v) for k, v in scalars.items()})
        if self.path is not None:
            line = json.dumps({k: json_sanitize(v) for k, v in rec.items()}) + "\n"
            with self._io_lock:
                if self._fh is None or self._fh.closed:
                    self._fh = open(self.path, "a")
                self._fh.write(line)
                self._fh.flush()
        if not self.quiet:
            fields = " ".join(
                f"{k}={v}" if isinstance(v, str) else f"{k}={v:.4g}"
                for k, v in rec.items() if k not in ("step", "kind", "wall_s")
            )
            print(f"[{kind}] step={step} {fields}", file=sys.stderr, flush=True)

    def close(self) -> None:
        """Release the file handle; a later log() reopens it in append mode."""
        with self._io_lock:
            if self._fh is not None and not self._fh.closed:
                self._fh.close()
