"""The capture helpers of ``utils/capture.py``.

* ``gc_paused``: the collector stays off while any of several overlapping
  pauses (captures on several threads) is open, comes back after the last,
  and stays off after it if it was off before.
* on the card: each role's capture stream is one stream, made once, and
  none of the pool's streams (``torch.cuda.Stream()``, which the engines,
  registries and savers take) is it.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import gc
import threading

import pytest
import torch

from induction_network_on_fewrel_tpu_torch.utils.capture import capturing, gc_paused, graph_stream


def test_gc_paused_holds_across_overlapping_pauses():
    assert gc.isenabled()
    first_in, second_in, first_out = threading.Event(), threading.Event(), threading.Event()
    seen: dict = {}

    def second():
        first_in.wait(10)
        with gc_paused():
            second_in.set()
            first_out.wait(10)
            seen["inside_after_first_left"] = gc.isenabled()
        seen["after_both"] = gc.isenabled()

    t = threading.Thread(target=second)
    t.start()
    with gc_paused():
        seen["inside"] = gc.isenabled()
        first_in.set()
        second_in.wait(10)
    first_out.set()
    t.join(10)
    assert seen == {"inside": False, "inside_after_first_left": False, "after_both": True}
    gc.disable()
    try:
        with gc_paused():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()


@pytest.mark.cuda
def test_capture_streams_are_their_own_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the streams and captures exist only there")
    roles = ("capture", "warmup", "serve_capture", "serve_warmup")
    streams = {r: graph_stream("cuda", r) for r in roles}
    assert all(graph_stream("cuda", r) is s for r, s in streams.items())
    handles = {s.cuda_stream for s in streams.values()}
    assert len(handles) == len(roles)
    pool = {torch.cuda.Stream("cuda").cuda_stream for _ in range(64)}
    assert not handles & pool
    x = torch.ones(8, device="cuda")
    g = torch.cuda.CUDAGraph()
    with capturing(g, "cuda"):
        y = x * 2
    assert gc.isenabled()
    x.fill_(3.0)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, torch.full((8,), 6.0, device="cuda"))
