"""Serializable pipeline cursor: where the episode stream is, exactly.

The port's copy of ``induction_network_on_fewrel_tpu/datapipe/cursor.py``.
A checkpoint without the input pipeline's position would resume the model
at step S on another episode stream. The cursor captures, per checkpoint:

* the sampler's stream state at a captured batch index: the numpy
  samplers' ``bit_generator`` state (``rng_feed_state``), the native
  samplers' next sequence number (batch i is a pure function of (seed,
  i)), recursively for mixtures;
* the consumed batch index: how many batches the trainer took (the
  producer may be ahead; prefetched batches are produced again on resume,
  never skipped);
* a layout fingerprint: process count and index (``torch.distributed``'s
  world size and rank when it is initialized, else 1 and 0) and the
  global and local batch size, so a cursor restored under another layout
  raises instead of splicing two streams.

Restoring is ``restore_sampler_state`` (the exact state) plus a replay of
``consumed - captured_at`` discarded batches (a resume inside a fused
unit; at most ``steps_per_call`` batches). A sampler without the
``feed_state``/``restore_feed_state`` protocol is captured as
``{"kind": "replay"}``: restoring it means a fresh sampler and ``consumed``
discarded batches.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

CURSOR_VERSION = 1


def capture_sampler_state(sampler) -> dict:
    """The sampler's stream state, restorable by ``restore_sampler_state``;
    ``{"kind": "replay"}`` when the sampler has no ``feed_state``."""
    fn = getattr(sampler, "feed_state", None)
    if fn is None:
        return {"kind": "replay"}
    return fn()


def restore_sampler_state(sampler, state: dict, skip: int = 0) -> None:
    """Set ``sampler`` to ``state``'s position, then discard ``skip``
    batches. For ``kind="replay"`` the sampler must be fresh (built with
    the original seed) and ``skip`` counts from batch 0."""
    if state.get("kind") != "replay":
        fn = getattr(sampler, "restore_feed_state", None)
        if fn is None:
            raise ValueError(
                f"cursor carries state kind {state.get('kind')!r} but "
                f"{type(sampler).__name__} has no restore_feed_state"
            )
        fn(state)
    for _ in range(skip):
        sampler.sample_batch()


def current_layout(batch: int) -> dict:
    """The layout fingerprint of this process (one process holds the whole
    batch until the multi-card modes, ROADMAP queue A item 5)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        pc, pi = dist.get_world_size(), dist.get_rank()
    else:
        pc, pi = 1, 0
    return {
        "process_count": int(pc),
        "process_index": int(pi),
        "global_batch": int(batch),
        "local_batch": int(batch),
    }


@dataclasses.dataclass
class PipelineCursor:
    """One restorable input-pipeline position (every field JSON-able)."""

    consumed: int               # batches the trainer consumed so far
    captured_at: int            # batch index ``sampler_state`` belongs to
    sampler_state: dict         # from capture_sampler_state
    layout: dict                # from current_layout
    stream_tag: str = ""        # mixture spec and seed, checked on restore
    version: int = CURSOR_VERSION

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineCursor":
        v = int(d.get("version", 0))
        if v != CURSOR_VERSION:
            raise ValueError(f"pipeline cursor version {v} unsupported (this build reads "
                             f"v{CURSOR_VERSION})")
        return cls(consumed=int(d["consumed"]), captured_at=int(d["captured_at"]),
                   sampler_state=dict(d["sampler_state"]), layout=dict(d["layout"]),
                   stream_tag=str(d.get("stream_tag", "")), version=v)

    @classmethod
    def from_json(cls, s: str) -> "PipelineCursor":
        return cls.from_dict(json.loads(s))

    def check_layout(self, layout: dict) -> None:
        """Raise when this cursor was written under another process layout:
        resuming would splice two different global streams."""
        mismatched = {k: (self.layout.get(k), layout.get(k))
                      for k in ("process_count", "process_index", "global_batch", "local_batch")
                      if self.layout.get(k) != layout.get(k)}
        if mismatched:
            raise ValueError(
                f"pipeline cursor layout mismatch {mismatched}: the episode stream is seeded "
                "per process layout, so resuming under a different one would not reproduce "
                "the uninterrupted stream. Resume with the original layout, or start a fresh "
                "run directory."
            )


def _json_scalarize(obj: Any) -> Any:
    """numpy scalars and arrays inside an RNG state -> plain Python."""
    import numpy as np

    if isinstance(obj, dict):
        return {k: _json_scalarize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_scalarize(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def rng_feed_state(rng) -> dict:
    """``feed_state`` of a ``numpy.random.Generator``-backed sampler: the
    bit generator's full state (an exact O(1) resume)."""
    return {"kind": "rng", "bit_generator": type(rng.bit_generator).__name__,
            "state": _json_scalarize(rng.bit_generator.state)}


def restore_rng_feed_state(rng, state: dict) -> None:
    got, want = state.get("bit_generator"), type(rng.bit_generator).__name__
    if got != want:
        raise ValueError(f"cursor RNG state is for bit generator {got!r}, the sampler uses "
                         f"{want!r}: numpy version or sampler construction mismatch")
    rng.bit_generator.state = state["state"]
