"""N-tier geometry of the resident class matrices: a copy of
``induction_network_on_fewrel_tpu/serving/geometry.py`` (the serving half
and ``grid_key``).

The query-graph cache (``serving/buckets.py``) keys on the resident class
matrix's row count, so a fleet whose tenants range over many relation
counts would capture one graph family per distinct N. Resident [N, C]
stacks therefore pad UP to a small fixed tier ladder (default
4/8/16/32/64) with all-zero rows, and the key becomes (n_tier, bucket,
resident dtype), bounded by tiers x buckets x dtypes
(``program_bound``).

Zero pad rows are safe: the NTN scorer treats the class axis as a batch
axis (pad rows cannot perturb real-row logits); verdicts read only
``row[:n_classes]`` and the NOTA logit sits at ``row[-1]`` for every
tier; zero rows leave the int8 tenant scale unchanged and pass both
degenerate-artifact gates. The one model family tiering must refuse is
``nota_head="stats"``, whose NOTA logit reads max/mean/std over the whole
class axis (``supports_tiering``): such models serve exact-N.
"""

from __future__ import annotations

import numpy as np

# The default tier ladder: powers of two from the smallest useful
# episode (FewRel's 3-relation toy tenants pad to 4) up past the
# paper's 10-way grid with headroom for production relation inventories
# (a 40-relation tenant lands on 64). Five tiers x five buckets x
# three resident dtypes bounds the whole fleet at 75 query graphs, vs
# one family per distinct N unbounded.
DEFAULT_TIERS: tuple[int, ...] = (4, 8, 16, 32, 64)

def parse_tiers(spec) -> tuple[int, ...] | None:
    """Parse a tier-set spec ("4,8,16,32,64") into a validated ascending
    tuple. "off" / "" / None disable tiering (exact-N residency — the
    untiered behavior, kept as an A/B arm). An already-
    parsed tuple/list passes through validation unchanged."""
    if spec is None:
        return None
    if isinstance(spec, (tuple, list)):
        tiers = tuple(int(t) for t in spec)
    else:
        s = str(spec).strip().lower()
        if s in ("", "off", "none"):
            return None
        try:
            tiers = tuple(int(t) for t in s.split(","))
        except ValueError:
            raise ValueError(
                f"geometry_tiers must be comma-separated ints or 'off', "
                f"got {spec!r}"
            ) from None
    if not tiers:
        return None
    if any(t < 1 for t in tiers):
        raise ValueError(f"geometry tiers must be >= 1, got {tiers}")
    if list(tiers) != sorted(set(tiers)):
        raise ValueError(
            f"geometry tiers must be strictly increasing, got {tiers}"
        )
    return tiers


def tiers_spec(tiers: tuple[int, ...] | None) -> str:
    """Inverse of ``parse_tiers`` — the loggable knob spelling."""
    return "off" if not tiers else ",".join(str(t) for t in tiers)


def select_tier(n: int, tiers: tuple[int, ...] = DEFAULT_TIERS) -> int:
    """Smallest tier >= n — the class-axis twin of ``select_bucket``.
    Monotone in n by construction (pinned in tests); raises on n <= 0
    and on overflow past the largest tier (serving callers that want
    the exact-N fallback use ``tier_for``)."""
    if n <= 0:
        raise ValueError(f"class count must be >= 1, got {n}")
    for t in tiers:
        if n <= t:
            return t
    raise ValueError(
        f"{n} classes exceed the largest geometry tier {max(tiers)} — "
        f"extend the tier set or serve this tenant exact-N"
    )


def tier_for(n: int, tiers: tuple[int, ...] | None) -> int:
    """The serving spelling: the tier ``n`` classes pad to, or ``n``
    itself when tiering is off or the tenant overflows the ladder (an
    oversize tenant serves exact-N — correct, just unbounded for that
    one N; callers log it)."""
    if not tiers or n > tiers[-1]:
        return n
    return select_tier(n, tiers)


def pad_class_stack(stack: np.ndarray, tier: int) -> np.ndarray:
    """[N, C] f32 host stack -> [tier, C] with all-zero pad rows
    appended. Zero rows (not repeats, unlike ``pad_rows`` for query
    batches) on purpose: they are invisible to the per-class NTN score,
    leave the int8 tenant scale unchanged, and pass the degenerate-
    artifact gates — see the module doc."""
    n = stack.shape[0]
    if n == tier:
        return stack
    if n > tier:
        raise ValueError(f"cannot pad {n} class rows down to tier {tier}")
    pad = np.zeros((tier - n,) + stack.shape[1:], dtype=stack.dtype)
    return np.concatenate([stack, pad], axis=0)


def program_bound(
    tiers: tuple[int, ...], buckets: tuple[int, ...], n_dtypes: int = 1
) -> int:
    """The query-graph ceiling a tiered fleet can reach:
    tiers x buckets x resident dtypes — the invariant the tier-1 gate
    asserts in-process (a cache exceeding it means some matrix reached
    the data plane un-tiered)."""
    return len(tiers) * len(buckets) * n_dtypes


def supports_tiering(model) -> bool:
    """False for models whose NOTA head reads statistics across the
    class axis inside the query graph (``nota_head="stats"`` —
    max/mean/std over ALL rows, pads included): padding would shift
    the NOTA logit, so such checkpoints serve exact-N."""
    return getattr(model, "nota_head", "scalar") != "stats"


def grid_key(n: int, k: int) -> str:
    """(5, 1) -> "5w1s" — the paper's C-way K-shot spelling, used for
    scenario leg names, canary floors ("grid_5w1s"), and artifact keys."""
    return f"{n}w{k}s"
