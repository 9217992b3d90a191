"""Tracing / profiling utilities.

The counterpart of ``induction_network_on_fewrel_tpu/utils/profiling.py``:

* ``trace(logdir)`` — a context manager around ``torch.profiler`` (CPU and,
  on a CUDA build, CUDA activity) that writes ``logdir/trace.json``, a
  chrome trace (``export_chrome_trace``; no TensorBoard package needed).
* ``timed_call`` — the clock stops after ``torch.cuda.synchronize``, so the
  time is the work's, not its enqueue's.
* ``annotate(name)`` — an NVTX range on a CUDA build (the JAX package's
  ``jax.named_scope``); on a CPU build, where torch has no NVTX, nothing.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator

import torch


def activities() -> list:
    """The profiler's activities: the CPU, and CUDA when the build has it."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir: str | Path) -> Iterator[torch.profiler.profile]:
    """Profile the block; write ``logdir/trace.json`` at exit."""
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities()) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """An NVTX range named ``name`` around the block on a CUDA build."""
    if not torch.cuda.is_available():
        yield
        return
    torch.cuda.nvtx.range_push(name)
    try:
        yield
    finally:
        torch.cuda.nvtx.range_pop()


def timed_call(fn, *args, **kw):
    """``(out, seconds)`` of ``fn(*args, **kw)``, the clock stopped after
    ``torch.cuda.synchronize()`` when CUDA is available."""
    t0 = time.monotonic()
    out = fn(*args, **kw)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.monotonic() - t0
