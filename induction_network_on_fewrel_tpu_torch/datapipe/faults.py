"""Feed-path fault injection, and query-side episode perturbations.

The port's copy of ``induction_network_on_fewrel_tpu/datapipe/faults.py``.
A fault spec (``--feed_fault``, ``FeedFaults.parse``) is a comma-separated
list of directives applied where the feed draws its units:

* ``slow:SECONDS``: sleep SECONDS before each unit (a slow host sampler);
  the stall telemetry shows how much of it the prefetch hides;
* ``stall:INDEX``: produce nothing once the next batch index reaches
  INDEX (a wedged worker); the consumer keeps logging stall ticks
  (``kind="data"`` records) instead of hanging silently;
* ``poison:INDEX``: corrupt the unit holding batch INDEX after its cursor
  state was captured (float leaves NaN, int leaves negated); the feed's
  validator refuses to hand it to the train step (``FeedError``).

``parse_perturbation``, ``perturb_query_batch`` and ``PerturbedSampler``
corrupt the queries inside a well-formed episode instead (token noise,
truncation, blanked rows), for robustness evaluations.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FeedFaults:
    """An immutable fault plan; ``FeedFaults()`` (all off) is the default."""

    slow_s: float = 0.0             # delay before each unit
    stall_at: int | None = None     # stop producing at this batch index
    poison_at: int | None = None    # corrupt the unit holding this index

    @classmethod
    def parse(cls, spec: str | None) -> "FeedFaults":
        """``"slow:0.05,poison:30"`` -> FeedFaults(slow_s=0.05, poison_at=30);
        empty or None -> all off; an unknown directive raises."""
        if not spec:
            return cls()
        slow_s, stall_at, poison_at = 0.0, None, None
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, arg = part.partition(":")
            if name == "slow":
                slow_s = float(arg)
                if slow_s < 0:
                    raise ValueError(f"slow delay must be >= 0, got {slow_s}")
            elif name == "stall":
                stall_at = int(arg)
            elif name == "poison":
                poison_at = int(arg)
            else:
                raise ValueError(f"unknown feed fault {name!r} (known: slow:SECONDS, "
                                 "stall:INDEX, poison:INDEX)")
        return cls(slow_s=slow_s, stall_at=stall_at, poison_at=poison_at)

    @property
    def active(self) -> bool:
        return self.slow_s > 0 or self.stall_at is not None or self.poison_at is not None

    def stalls_unit(self, unit_start: int) -> bool:
        return self.stall_at is not None and unit_start >= self.stall_at

    def poisons_unit(self, unit_start: int, unit: int) -> bool:
        return self.poison_at is not None and unit_start <= self.poison_at < unit_start + unit


def tree_leaves(tree) -> list:
    """The array leaves of a batch: dicts in sorted key order, tuples
    (named or not) and lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` over every leaf, keeping dicts, named tuples, tuples and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def poison_tree(tree):
    """NaN-poison float leaves, negate int leaves (minus one, so zeros
    corrupt too); shapes and dtypes stay, so the corruption is in the
    values, not in a signature the shape check would catch."""
    def bad(x):
        a = np.array(x)             # a writable copy
        if np.issubdtype(a.dtype, np.floating):
            a.fill(np.nan)
        elif np.issubdtype(a.dtype, np.integer):
            np.negative(a, out=a)
            a -= 1
        return a

    return tree_map(bad, tree)


QUERY_PERTURBATIONS = ("token_noise", "mask_drop", "blank")


def parse_perturbation(spec: str) -> tuple[str, float]:
    """``"token_noise:0.3"`` -> ("token_noise", 0.3); an unknown mode or a
    rate outside [0, 1] raises."""
    name, _, arg = spec.strip().partition(":")
    if name not in QUERY_PERTURBATIONS:
        raise ValueError(f"unknown query perturbation {name!r} "
                         f"(known: {', '.join(QUERY_PERTURBATIONS)})")
    rate = float(arg) if arg else 1.0
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"perturbation rate must be in [0, 1], got {rate}")
    return name, rate


def perturb_query_batch(batch, mode: str, rate: float, rng):
    """Perturb the query side of one EpisodeBatch (numpy; shapes and dtypes
    kept, supports and labels untouched).

    * ``token_noise``: each unmasked query token is replaced, with
      probability ``rate``, by a token drawn from the batch's unmasked
      tokens;
    * ``mask_drop``: the trailing ``rate`` share of each query's mask is
      zeroed (at least one token is kept);
    * ``blank``: a ``rate`` share of the query rows have every unmasked
      token replaced by the batch's most frequent token.
    """
    word = np.array(batch.query_word)
    mask = np.array(batch.query_mask)
    on = mask > 0
    if mode == "token_noise":
        pool = word[on]
        flip = on & (rng.random(word.shape) < rate)
        word[flip] = rng.choice(pool, size=int(flip.sum()))
    elif mode == "mask_drop":
        lengths = on.sum(axis=-1, keepdims=True)
        keep = np.maximum(np.ceil(lengths * (1.0 - rate)), 1.0)
        pos = np.cumsum(on, axis=-1)
        mask = np.where(on & (pos > keep), 0.0, mask).astype(batch.query_mask.dtype)
    elif mode == "blank":
        vals, counts = np.unique(word[on], return_counts=True)
        fill = vals[np.argmax(counts)]
        rows = rng.random(word.shape[:-1]) < rate
        word = np.where(rows[..., None] & on, fill, word)
    else:
        raise ValueError(f"unknown query perturbation {mode!r}")
    return batch._replace(query_word=word.astype(batch.query_word.dtype), query_mask=mask)


class PerturbedSampler:
    """Any episode sampler whose every batch's queries pass through one
    perturbation; deterministic given the sampler's seed and ``seed``."""

    def __init__(self, sampler, spec: str, seed: int = 0):
        self.mode, self.rate = parse_perturbation(spec)
        self.spec = spec
        self._sampler = sampler
        self._rng = np.random.default_rng(seed)
        self.batch_size = sampler.batch_size
        self.total_q = sampler.total_q

    def sample_batch(self):
        return perturb_query_batch(self._sampler.sample_batch(), self.mode, self.rate, self._rng)

    def __iter__(self):
        while True:
            yield self.sample_batch()

    def close(self) -> None:
        if hasattr(self._sampler, "close"):
            self._sampler.close()
