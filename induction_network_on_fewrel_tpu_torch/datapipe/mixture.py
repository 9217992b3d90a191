"""Declarative episode-mixture schedules, resolved from the batch index.

The port's copy of ``induction_network_on_fewrel_tpu/datapipe/mixture.py``.
FewRel 2.0 training mixes corpora (wiki episodes interleaved with pubmed
for domain adaptation). ``MixtureSampler`` interleaves same-shape child
samplers: which source serves batch ``i`` is a pure function of (seed,
i), a splitmix64 uniform against the schedule's weights at ``i``, so a
mixture resumes exactly from a ``PipelineCursor``. Every source yields
batches of one shape (the captured step's shapes are static), so a
curriculum moves source weights, never episode geometry.

Spec grammar (``--mixture``, ``MixtureSchedule.parse``)::

    SPEC   := entry (';' entry)*
    entry  := source ':' point (',' point)*
    point  := WEIGHT ('@' BATCH_INDEX)?

``"train:1.0;pubmed.json:0.0@0,1.0@4000"`` starts all-train and ramps the
pubmed file linearly to parity by batch 4000 (weights renormalized per
index, linear between breakpoints, flat outside). A source is ``train``
(the run's train split), ``synthetic[:SEED]`` (a synthetic split) or a
FewRel-schema JSON path (``cli.py`` resolves them).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

from induction_network_on_fewrel_tpu_torch.datapipe.cursor import (
    capture_sampler_state,
    restore_sampler_state,
)

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """One splitmix64 output: the mixer the C++ sampler uses for its own
    (seed, batch) expansion (``csrc/episode_sampler.cpp``)."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


@dataclasses.dataclass(frozen=True)
class MixtureSchedule:
    """Per-source piecewise-linear weight curves over the batch index."""

    # ((source_name, ((index, weight), ...)), ...)
    sources: tuple[tuple[str, tuple[tuple[int, float], ...]], ...]

    @classmethod
    def parse(cls, spec: str) -> "MixtureSchedule":
        sources = []
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            name, sep, points_s = entry.rpartition(":")
            if not sep or not name:
                raise ValueError(f"mixture entry {entry!r} must be "
                                 "'source:weight[@index][,weight@index...]'")
            points = []
            for p in points_s.split(","):
                w_s, at, idx_s = p.strip().partition("@")
                w = float(w_s)
                if w < 0:
                    raise ValueError(f"mixture weight must be >= 0, got {w}")
                points.append((int(idx_s) if at else 0, w))
            points.sort()
            if len({i for i, _ in points}) != len(points):
                raise ValueError(f"mixture source {name!r} repeats a breakpoint index")
            sources.append((name.strip(), tuple(points)))
        if not sources:
            raise ValueError(f"empty mixture spec {spec!r}")
        seen = [n for n, _ in sources]
        if len(set(seen)) != len(seen):
            raise ValueError(f"mixture spec names a source twice: {seen}")
        return cls(sources=tuple(sources))

    @classmethod
    def ramp(cls, src: str = "src", tgt: str = "tgt", start_weight: float = 0.2,
             parity_at: int = 1) -> "MixtureSchedule":
        """The domain-adaptation ramp (the adaptation fine-tune's
        curriculum): the source corpus at weight 1.0 while the target ramps
        linearly from ``start_weight`` to parity by batch ``parity_at``."""
        if parity_at < 1:
            raise ValueError(f"parity_at must be >= 1, got {parity_at}")
        return cls.parse(f"{src}:1.0;{tgt}:{start_weight:g}@0,1.0@{parity_at}")

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(n for n, _ in self.sources)

    def weights_at(self, index: int) -> list[float]:
        """Unnormalized per-source weights at batch ``index``."""
        out = []
        for _, points in self.sources:
            if index <= points[0][0]:
                out.append(points[0][1])
                continue
            if index >= points[-1][0]:
                out.append(points[-1][1])
                continue
            for (i0, w0), (i1, w1) in zip(points, points[1:]):
                if i0 <= index <= i1:
                    t = (index - i0) / max(i1 - i0, 1)
                    out.append(w0 + t * (w1 - w0))
                    break
        return out

    def pick(self, seed: int, index: int) -> int:
        """Source index for batch ``index``: pure in (seed, index)."""
        weights = self.weights_at(index)
        total = sum(weights)
        if total <= 0:
            raise ValueError(f"mixture weights all zero at batch {index}: "
                             f"{dict(zip(self.names, weights))}")
        u = _splitmix64(_splitmix64(seed) ^ index) / float(1 << 64)
        acc = 0.0
        for j, w in enumerate(weights):
            acc += w / total
            if u < acc:
                return j
        return len(weights) - 1

    def to_spec(self) -> str:
        """The canonical spec string (round-trips through ``parse``)."""
        return ";".join(name + ":" + ",".join(f"{w:g}@{i}" for i, w in points)
                        for name, points in self.sources)


class MixtureSampler:
    """Interleave same-shape child samplers under a ``MixtureSchedule``.

    The sampler surface (``sample_batch``, ``batch_size``, ``total_q``,
    ``close``, iteration), so it drops into the trainer or a
    ``PipelineFeed``. No ``sample_fused``: a fused unit would interleave
    sources inside one call; the feed stacks single batches instead, which
    keeps the per-index source choice."""

    def __init__(self, children: Sequence[tuple[str, object]], schedule: MixtureSchedule,
                 seed: int = 0):
        names = [n for n, _ in children]
        if list(schedule.names) != names:
            raise ValueError(f"mixture children {names} do not match schedule sources "
                             f"{list(schedule.names)} (order matters: the pick is by position)")
        self._children = list(children)
        self.schedule = schedule
        self.seed = int(seed)
        self._next = 0
        self.counts = {n: 0 for n in names}         # batches served per source
        first = self._children[0][1]
        self.batch_size, self.total_q = first.batch_size, first.total_q
        for name, ch in self._children[1:]:
            if (ch.batch_size, ch.total_q) != (self.batch_size, self.total_q):
                raise ValueError(
                    f"mixture source {name!r} shape (batch_size={ch.batch_size}, "
                    f"total_q={ch.total_q}) differs from {self._children[0][0]!r} "
                    f"({self.batch_size}, {self.total_q}); all sources must produce "
                    "identically-shaped batches (static step shapes)"
                )

    def sample_batch(self):
        j = self.schedule.pick(self.seed, self._next)
        name, child = self._children[j]
        self._next += 1
        self.counts[name] += 1
        return child.sample_batch()

    def __iter__(self) -> Iterator:
        while True:
            yield self.sample_batch()

    def feed_state(self) -> dict:
        return {"kind": "mixture", "next": self._next, "counts": dict(self.counts),
                "children": {name: capture_sampler_state(ch) for name, ch in self._children}}

    def restore_feed_state(self, state: dict) -> None:
        children = state.get("children", {})
        missing = [n for n, _ in self._children if n not in children]
        if missing:
            raise ValueError(f"cursor mixture state lacks sources {missing}; the resumed run "
                             "must use the same --mixture spec")
        for name, ch in self._children:
            st = children[name]
            # A protocol-less child replays its own served count.
            skip = int(state.get("counts", {}).get(name, 0)) if st.get("kind") == "replay" else 0
            restore_sampler_state(ch, st, skip=skip)
        self._next = int(state["next"])
        self.counts = {n: int(state.get("counts", {}).get(n, 0)) for n, _ in self._children}

    def close(self) -> None:
        for _, ch in self._children:
            if hasattr(ch, "close"):
                ch.close()
