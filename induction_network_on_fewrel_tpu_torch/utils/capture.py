"""CUDA-graph captures beside other threads' work on the card.

Every capture of the port (the training and eval steps,
``train/steps.py``; the serving query graphs, ``serving/buckets.py``)
runs through ``capturing``: in ``thread_local`` mode (other threads keep
replaying, copying and distilling meanwhile), on a stream of its own
(``graph_stream``), with Python's garbage collector paused. A capture
fails the graph ("operation failed due to a previous error during
capture") when other work lands on its stream or its own thread makes a
call that a capture forbids:

* ``torch.cuda.Stream()`` hands out the streams of a fixed per-device pool
  in turn, and the engines, registries and checkpoint savers each take
  one, so a capture stream from that pool is, sooner or later, someone
  else's stream too. The capture and warm-up streams here are
  high-priority streams, a pool that nothing else in the port takes from,
  one per device and role, made once.
* a collection during the capture runs finalizers on the capturing thread
  (a dropped graph's or a pinned buffer's release); the collector is
  paused for the capture's length (``torch.cuda.graph`` collects just
  before it begins).
"""

from __future__ import annotations

import contextlib
import gc
import threading

import torch

_STREAMS: dict = {}
_GC_LOCK = threading.Lock()
_GC_PAUSES = [0, False]         # captures in flight, whether gc was enabled before them


def graph_stream(device, role: str) -> torch.cuda.Stream:
    """The one stream of ``role`` on ``device`` ("warmup" and "capture" for
    the training and eval graphs, "serve_warmup" and "serve_capture" for the
    serving ones): a high-priority stream, the same one every time, so that
    repeated captures do not each leave a new stream's cuBLAS workspace
    behind."""
    key = (torch.device(device).index or 0, role)
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(device, priority=-1)
    return _STREAMS[key]


@contextlib.contextmanager
def gc_paused():
    """Python's garbage collector off until the last of the overlapping
    ``gc_paused`` blocks (captures on several threads) ends."""
    with _GC_LOCK:
        if _GC_PAUSES[0] == 0:
            _GC_PAUSES[1] = gc.isenabled()
            gc.disable()
        _GC_PAUSES[0] += 1
    try:
        yield
    finally:
        with _GC_LOCK:
            _GC_PAUSES[0] -= 1
            if _GC_PAUSES[0] == 0 and _GC_PAUSES[1]:
                gc.enable()


@contextlib.contextmanager
def capturing(graph: torch.cuda.CUDAGraph, device, role: str = "capture"):
    """``torch.cuda.graph(graph)`` on ``graph_stream(device, role)`` in
    ``thread_local`` mode, the collector paused."""
    with gc_paused(), torch.cuda.graph(graph, stream=graph_stream(device, role),
                                       capture_error_mode="thread_local"):
        yield
