"""Online prediction-drift detection over serving verdicts.

A copy of ``induction_network_on_fewrel_tpu/obs/drift.py``
(``quality_features``, ``DriftDetector``). The serving engine computes the
features from the logits rows it already brings to the host for the
verdicts, so drift adds no device work and no sync.

The serving stack already tells an operator when it is slow (SLO burn
rates) or wedged (queue-stall watchdog); this module tells them when it
is *wrong* — or about to be. FewRel 2.0 (Gao et al. 2019, PAPERS.md)
shows exactly where the Geng et al. 2019 induction model degrades
silently: traffic drifting out of the training domain (wiki -> pubmed)
and open-world none-of-the-above queries. Neither failure mode raises an
exception or moves a latency percentile; both move the *prediction
distribution* first. So that is what this detector watches, per tenant:

* **NOTA rate** — fraction of verdicts resolved ``no_relation``. The
  single most sensitive out-of-domain signal: queries that match none of
  the tenant's resident class vectors land here (or stop landing here,
  when a miscalibrated threshold starts swallowing everything).
* **Top-1 margin** — best class score minus runner-up. Shrinking margins
  mean the class vectors no longer separate the traffic.
* **Score entropy** — softmax entropy of the class scores. Rising
  entropy is the same collapse seen from the other side (and catches a
  *uniformly confident-wrong* model that keeps its margins).

Mechanics (deliberately parallel to ``obs/health.SLOEngine``):

* ``observe(tenant, nota=..., margin=..., entropy=...)`` per verdict —
  the engine calls it on the emit path, one deque append steady-state.
* A **calibration baseline** per tenant: mean/std of each feature over
  the first ``baseline_n`` verdicts after (re-)arming, or injected
  explicitly via ``set_baseline`` from a publish-time calibration
  artifact (the ``tools/scenarios.py`` NOTA sweep records exactly these
  stats at the chosen operating point).
* A rolling **detection window** (count-based, bounded deque) compared
  against the baseline: per feature, the band is
  ``max(band_sigma * base_std / sqrt(window), floor)`` — the standard
  error of the window mean under the baseline distribution, floored so
  a zero-variance baseline (NOTA rate 0.0 is common) still gets a
  meaningful band. Window mean outside the band -> WARNING; outside
  ``crit_factor`` bands -> CRITICAL.
* **Once-latched** per (tenant, feature, severity): a sustained shift is
  one incident, not one event per evaluation; returning inside the band
  re-arms the latch. A CRITICAL auto-captures diagnostics through the
  shared ``DiagnosticsCapture`` (flight dump + host-span snapshot),
  exactly once per latch — the evidence for "the model went wrong at
  14:03" is on disk before anyone asks.
* **Baseline re-arm on publish**: a hot-swap (``snapshot_swap``)
  legitimately moves the prediction distribution — new weights, new
  class vectors. The serving engine calls ``rearm()`` after every
  publish, which drops baselines + windows + latches and re-captures
  from the first post-publish traffic, so a publish never reads as
  drift and drift is never masked by a stale pre-publish baseline.
* The clock is injectable (``now=``) like every detector in obs/: the
  evaluation throttle (``eval_interval_s``) compresses in tests and
  drills to whatever wall-time they actually have.

Drill: ``tools/loadgen.py --drift_drill`` calibrates an
open-set NOTA floor from live verdicts, baselines in-domain traffic,
then injects an out-of-vocabulary traffic shift that must trip a
once-latched CRITICAL with captures on disk — and proves a publish
re-arms cleanly.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable

from induction_network_on_fewrel_tpu_torch.obs.health import (
    CRITICAL,
    WARNING,
    HealthEvent,
)

FEATURES = ("nota_rate", "margin", "entropy")


def quality_features(scores):
    """(top-1 margin, softmax entropy) of class-score rows — THE quality
    formulas of the stack, shared by the serving verdict path
    (engine._verdict, per row) and the scenarios harness
    (tools/scenarios.py, vectorized), so the offline calibration baseline
    and the online drift features can never disagree.

    ``scores``: numpy [..., n] class scores (the NOTA logit excluded —
    it is a learned threshold, not a class; folding it in would alias
    threshold recalibration with distribution shift). Returns
    (margin[...], entropy[...]) float64 arrays; margin is 0 for n < 2.
    """
    import numpy as np

    s = np.asarray(scores, dtype=np.float64)
    n = s.shape[-1]
    if n >= 2:
        top2 = np.partition(s, -2, axis=-1)[..., -2:]
        margin = top2[..., 1] - top2[..., 0]
    else:
        margin = np.zeros(s.shape[:-1])
    z = s - s.max(axis=-1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=-1, keepdims=True)
    entropy = -(p * np.log(np.maximum(p, 1e-12))).sum(axis=-1)
    return margin, entropy


def _mean_std(xs) -> tuple[float, float]:
    n = len(xs)
    if n == 0:
        return 0.0, 0.0
    m = sum(xs) / n
    var = sum((x - m) ** 2 for x in xs) / max(n - 1, 1)
    return m, math.sqrt(max(var, 0.0))


class DriftDetector:
    """Per-tenant prediction-drift detector over serving verdicts."""

    def __init__(
        self,
        window: int = 128,
        baseline_n: int = 64,
        min_count: int | None = None,
        band_sigma: float = 4.0,
        crit_factor: float = 2.0,
        eval_interval_s: float = 1.0,
        nota_rate_floor: float = 0.05,
        rel_floor: float = 0.1,
        parity_floor: float = 0.99,
        parity_margin_band: float = 0.25,
        parity_window: int = 8,
        logger=None,
        recorder=None,
        capture=None,
        on_event: Callable[[HealthEvent], None] | None = None,
    ):
        """``window``: detection-window verdict count (bounded memory per
        tenant). ``baseline_n``: verdicts that form the calibration
        baseline after (re-)arming. ``min_count``: don't judge a window
        thinner than this — None (default) resolves to ``min(32,
        window)`` so a small window is judged when full; an explicit
        value larger than the window is refused (the deque is capped at
        ``window``, so such a detector could NEVER judge — a silent
        no-op an operator would mistake for armed coverage).
        ``band_sigma``: band width in standard errors of the window
        mean; ``crit_factor``: CRITICAL at this many bands.
        ``nota_rate_floor``: absolute band floor for the NOTA rate (a
        clean baseline has rate 0.0 with std 0.0); margin/entropy floor
        at ``rel_floor`` of their baseline scale instead (score units are
        model-dependent).

        Quantization parity bands: ``parity_floor`` is the
        absolute verdict-agreement floor the parity police holds
        quantized tenants to (WARNING below it, CRITICAL past
        ``crit_factor`` of the shortfall band ``1 - parity_floor``);
        ``parity_margin_band`` bounds the mean |margin drift| vs f32 the
        same way; ``parity_window`` is how many probes the rolling
        parity means average over. Unlike the drift features these need
        NO calibration baseline — f32 agreement is an absolute bar, not
        a distribution."""
        if not 0.0 < parity_floor <= 1.0:
            raise ValueError(
                f"parity_floor must be in (0, 1], got {parity_floor}"
            )
        if parity_window < 1:
            raise ValueError(
                f"parity_window must be >= 1, got {parity_window}"
            )
        if min_count is None:
            min_count = min(32, window)
        if baseline_n < 2 or window < 2 or min_count < 2:
            raise ValueError("window/baseline_n/min_count must be >= 2")
        if min_count > window:
            raise ValueError(
                f"min_count ({min_count}) exceeds window ({window}): the "
                f"detection window is capped at `window` entries, so this "
                f"detector would never judge anything"
            )
        self.window = window
        self.baseline_n = baseline_n
        self.min_count = min_count
        self.band_sigma = band_sigma
        self.crit_factor = crit_factor
        self.eval_interval_s = eval_interval_s
        self.nota_rate_floor = nota_rate_floor
        self.rel_floor = rel_floor
        self.parity_floor = parity_floor
        self.parity_margin_band = parity_margin_band
        self.parity_window = parity_window
        self.logger = logger
        self.recorder = recorder
        self.capture = capture
        self.on_event = on_event
        self._lock = threading.RLock()
        # tenant -> {feature: (mean, std)} once calibrated.
        self._baseline: dict[str, dict[str, tuple[float, float]]] = {}
        # tenant -> accumulating calibration buffer (pre-baseline).
        self._base_buf: dict[str, list[tuple[float, float, float]]] = {}
        # tenant -> rolling detection window of (nota, margin, entropy).
        self._win: dict[str, deque] = {}
        self._seen: dict[str, int] = {}       # verdicts observed per tenant
        self._last_eval: dict[str, float] = {}
        # tenant -> rolling window of parity-probe outcomes
        # (agreement, margin_drift, rows), the parity probe's.
        self._parity_win: dict[str, deque] = {}
        self.rearms = 0
        self.events: deque[HealthEvent] = deque(maxlen=512)
        self.tripped = False
        self._latched: set[str] = set()
        self.captured: dict[str, dict] = {}   # latch key -> capture result

    # --- calibration ------------------------------------------------------

    def armed(self, tenant: str) -> bool:
        """True once the tenant has a calibration baseline."""
        with self._lock:
            return tenant in self._baseline

    def set_baseline(
        self, tenant: str, baseline: dict[str, tuple[float, float]]
    ) -> None:
        """Inject an explicit calibration baseline — ``{feature: (mean,
        std)}`` for the features in ``FEATURES`` — e.g. the operating-
        point stats a ``tools/scenarios.py`` NOTA calibration recorded at
        publish time. Replaces any traffic-derived baseline and clears
        the tenant's window/latches (the comparison basis changed)."""
        missing = [f for f in FEATURES if f not in baseline]
        if missing:
            raise ValueError(f"baseline lacks features {missing}")
        with self._lock:
            self._baseline[tenant] = {
                f: (float(baseline[f][0]), float(baseline[f][1]))
                for f in FEATURES
            }
            self._base_buf.pop(tenant, None)
            self._win[tenant] = deque(maxlen=self.window)
            self._unlatch(tenant)

    def observed(self, tenant: str) -> int:
        """Verdicts of ``tenant`` observed so far (across re-arms)."""
        with self._lock:
            return self._seen.get(tenant, 0)

    def baseline_for(self, tenant: str) -> dict | None:
        with self._lock:
            base = self._baseline.get(tenant)
            return {f: tuple(v) for f, v in base.items()} if base else None

    def rearm(self, tenant: str | None = None, reason: str = "") -> None:
        """Drop baseline + window + latches (one tenant, or all) and
        re-capture from subsequent traffic. The serving engine calls this
        after every hot-swap publish: a publish legitimately moves the
        prediction distribution, so the old baseline is void — and the
        re-capture means post-publish drift is judged against the NEW
        normal, not masked by it."""
        with self._lock:
            tenants = [tenant] if tenant is not None else list(
                set(self._baseline) | set(self._base_buf) | set(self._win)
                | set(self._parity_win)
            )
            # Quiet no-op when the target never accumulated state: the
            # engine re-arms on every control-plane change (register /
            # threshold / publish), and setup-time registrations before
            # any traffic must not spam drift_rearm events.
            had_any = any(
                t in self._baseline or t in self._base_buf or t in self._win
                or t in self._parity_win
                for t in tenants
            )
            for t in tenants:
                self._baseline.pop(t, None)
                self._base_buf.pop(t, None)
                self._win.pop(t, None)
                self._last_eval.pop(t, None)
                # Parity windows drop with the rest: a publish or a
                # residency roll changes the quantization error, so old
                # probe outcomes no longer describe the live matrix
                # (and _unlatch clears the quant_* latches by prefix).
                self._parity_win.pop(t, None)
                self._unlatch(t)
            if had_any:
                self.rearms += 1
        if had_any:
            self._send(HealthEvent(
                event="drift_rearm", severity=WARNING, step=self.rearms,
                message=(
                    f"drift baseline re-armed for "
                    f"{tenant if tenant is not None else 'all tenants'}"
                    + (f": {reason}" if reason else "")
                ),
                data={"tenants": float(len(tenants))},
            ), latch=None)

    def _unlatch(self, tenant: str) -> None:
        for key in [k for k in self._latched
                    if k.startswith(f"drift:{tenant}:")]:
            self._latched.discard(key)

    # --- observation ------------------------------------------------------

    def observe(
        self,
        tenant: str,
        nota: bool,
        margin: float,
        entropy: float,
        now: float | None = None,
    ) -> list[HealthEvent]:
        """One verdict's quality features. Steady-state cost: a deque
        append + (at most once per ``eval_interval_s``) a window-mean
        judgment. Returns newly emitted events (tests/drills)."""
        now = time.monotonic() if now is None else now
        sample = (1.0 if nota else 0.0, float(margin), float(entropy))
        pending: list[tuple[HealthEvent, str]] = []
        with self._lock:
            self._seen[tenant] = self._seen.get(tenant, 0) + 1
            if tenant not in self._baseline:
                buf = self._base_buf.setdefault(tenant, [])
                buf.append(sample)
                if len(buf) >= self.baseline_n:
                    self._baseline[tenant] = {
                        f: _mean_std([s[i] for s in buf])
                        for i, f in enumerate(FEATURES)
                    }
                    del self._base_buf[tenant]
                    self._win[tenant] = deque(maxlen=self.window)
                return []
            win = self._win[tenant]
            win.append(sample)
            if len(win) < self.min_count:
                return []
            if now - self._last_eval.get(tenant, -math.inf) \
                    < self.eval_interval_s:
                return []
            self._last_eval[tenant] = now
            pending = self._judge_locked(tenant)
        for ev, latch in pending:
            self._send(ev, latch)
        return [ev for ev, _ in pending]

    def observe_parity(
        self,
        tenant: str,
        agreement: float,
        margin_drift: float,
        rows: int = 1,
        now: float | None = None,
    ) -> list[HealthEvent]:
        """One quantization parity-probe outcome: the engine's
        sampled f32 shadow-score hands over the probe's verdict-agreement
        fraction and mean |margin drift|. Judged against the ABSOLUTE
        parity bands (no calibration baseline — f32 IS the reference) on
        every probe, and routed through the exact same latch/auto-
        capture/on_event path as feature drift, so a quantization
        regression trips the same alarms the adaptation loop
        listens to. Returns newly emitted events (tests/drills)."""
        pending: list[tuple[HealthEvent, str]] = []
        with self._lock:
            win = self._parity_win.setdefault(
                tenant, deque(maxlen=self.parity_window)
            )
            win.append((float(agreement), float(margin_drift), int(rows)))
            total = sum(r for _, _, r in win)
            agree = sum(a * r for a, _, r in win) / max(total, 1)
            drift = sum(d * r for _, d, r in win) / max(total, 1)
            checks = (
                # (feature, shift, band): agreement judged as shortfall
                # below 1.0 against the floor's allowance; margin drift
                # as an absolute excursion from 0.
                ("quant_agreement", 1.0 - agree, 1.0 - self.parity_floor),
                ("quant_margin_drift", drift, self.parity_margin_band),
            )
            for f, shift, band in checks:
                warn_latch = f"drift:{tenant}:{f}:warning"
                crit_latch = f"drift:{tenant}:{f}:critical"
                if shift <= band:
                    self._latched.discard(warn_latch)
                    self._latched.discard(crit_latch)
                    continue
                severity = (
                    CRITICAL if shift > self.crit_factor * band else WARNING
                )
                latch = crit_latch if severity == CRITICAL else warn_latch
                if latch in self._latched:
                    continue
                self._latched.add(latch)
                if severity == CRITICAL:
                    self._latched.add(warn_latch)
                cur = agree if f == "quant_agreement" else drift
                pending.append((HealthEvent(
                    event="prediction_drift", severity=severity,
                    step=self._seen.get(tenant, 0),
                    message=(
                        f"tenant {tenant!r} {f} {cur:.4g} breached the "
                        f"quantization parity band {band:.4g} "
                        f"({total} probed rows)"
                    ),
                    data={
                        "tenant": tenant, "feature": f,
                        "baseline": 1.0 if f == "quant_agreement" else 0.0,
                        "current": round(cur, 6),
                        "band": round(band, 6), "window": total,
                    },
                ), latch))
        for ev, latch in pending:
            self._send(ev, latch)
        return [ev for ev, _ in pending]

    def parity_state(self, tenant: str) -> dict | None:
        """{agreement, margin_drift, probes, rows} rolling parity view for
        a tenant with probe history; None otherwise."""
        with self._lock:
            win = self._parity_win.get(tenant)
            if not win:
                return None
            total = sum(r for _, _, r in win)
            return {
                "agreement": round(
                    sum(a * r for a, _, r in win) / max(total, 1), 6
                ),
                "margin_drift": round(
                    sum(d * r for _, d, r in win) / max(total, 1), 6
                ),
                "probes": len(win),
                "rows": total,
            }

    # --- judgment ---------------------------------------------------------

    def _band(self, feature: str, base_std: float, base_mean: float,
              n: int) -> float:
        se = base_std / math.sqrt(max(n, 1))
        if feature == "nota_rate":
            floor = self.nota_rate_floor
        else:
            floor = self.rel_floor * max(abs(base_mean), base_std, 1e-6)
        return max(self.band_sigma * se, floor)

    def drift_state(self, tenant: str) -> dict | None:
        """{feature: {base, cur, band, shift}} + window/latch info for a
        calibrated tenant; None otherwise. The ``kind="quality"`` drift
        record and the quality section of the package's tools/obs_report.py
        read this."""
        with self._lock:
            base = self._baseline.get(tenant)
            if base is None:
                return None
            win = self._win.get(tenant) or ()
            n = len(win)
            out: dict = {"window": n, "latched": sum(
                1 for k in self._latched if k.startswith(f"drift:{tenant}:")
            )}
            for i, f in enumerate(FEATURES):
                bm, bs = base[f]
                cur = (sum(s[i] for s in win) / n) if n else bm
                # Same band the judgment uses (the actual window size) —
                # the emitted record must never show a narrower band
                # than the one that decides alerts.
                band = self._band(f, bs, bm, max(n, 1))
                out[f] = {
                    "base": round(bm, 6), "cur": round(cur, 6),
                    "band": round(band, 6),
                    "shift": round(abs(cur - bm), 6),
                }
            return out

    def _judge_locked(self, tenant: str) -> list[tuple[HealthEvent, str]]:
        """Latch transitions + event construction ONLY (lock held); the
        caller emits after release — same discipline as SLOEngine: the
        capture's file writes must not stall the verdict path."""
        base = self._baseline[tenant]
        win = self._win[tenant]
        n = len(win)
        pending: list[tuple[HealthEvent, str]] = []
        for i, f in enumerate(FEATURES):
            bm, bs = base[f]
            cur = sum(s[i] for s in win) / n
            band = self._band(f, bs, bm, n)
            shift = abs(cur - bm)
            warn_latch = f"drift:{tenant}:{f}:warning"
            crit_latch = f"drift:{tenant}:{f}:critical"
            if shift <= band:
                self._latched.discard(warn_latch)   # back in band re-arms
                self._latched.discard(crit_latch)
                continue
            severity = (
                CRITICAL if shift > self.crit_factor * band else WARNING
            )
            latch = crit_latch if severity == CRITICAL else warn_latch
            # Latches re-arm ONLY fully inside the band (the branch
            # above) — a dip from critical to merely-warning territory
            # keeps the critical latch held, or shift noise around the
            # critical boundary would fire one capture per crossing
            # (same discipline as SLOEngine._judge).
            if latch in self._latched:
                continue
            self._latched.add(latch)
            if severity == CRITICAL:
                self._latched.add(warn_latch)  # critical covers warning
            pending.append((HealthEvent(
                event="prediction_drift", severity=severity,
                step=self._seen.get(tenant, 0),
                message=(
                    f"tenant {tenant!r} {f} drifted {shift:.4g} from "
                    f"baseline {bm:.4g} (band {band:.4g}, window {n})"
                ),
                data={
                    "tenant": tenant, "feature": f,
                    "baseline": round(bm, 6), "current": round(cur, 6),
                    "band": round(band, 6), "window": n,
                },
            ), latch))
        return pending

    # --- emission ---------------------------------------------------------

    def _send(self, ev: HealthEvent, latch: str | None) -> None:
        self.events.append(ev)
        if ev.severity == CRITICAL:
            self.tripped = True
        if self.recorder is not None:
            self.recorder.record_event(ev.to_dict())
        if self.logger is not None:
            self.logger.log(
                ev.step, kind="health", event=ev.event,
                severity=ev.severity, message=ev.message, **ev.data,
            )
        if ev.severity == CRITICAL and latch is not None:
            # Auto-capture once per latch: flight dump + host-span
            # snapshot (+ profiler where the image allows) on disk at
            # trip time — the same evidence discipline as SLO burns.
            if self.capture is not None:
                self.captured[latch] = self.capture.capture(
                    reason=f"drift: {ev.message}"
                )
            elif self.recorder is not None:
                self.recorder.dump(reason=f"drift: {ev.message}")
        if self.on_event is not None:
            self.on_event(ev)

    def emit(self, logger, step: int) -> None:
        """One ``kind="quality"`` drift-state record per calibrated
        tenant: baseline vs current vs band per feature, flattened to
        scalars (schema contract). The serving engine calls this with
        its periodic stats emit."""
        with self._lock:
            tenants = sorted(self._baseline)
            parity_tenants = sorted(self._parity_win)
        for tenant in tenants:
            st = self.drift_state(tenant)
            if st is None:
                continue
            fields: dict = {
                "tenant": tenant, "probe": "drift",
                "window": float(st["window"]),
                "latched": float(st["latched"]),
            }
            for f in FEATURES:
                fields[f"{f}_base"] = st[f]["base"]
                fields[f"{f}_cur"] = st[f]["cur"]
                fields[f"{f}_band"] = st[f]["band"]
            logger.log(step, kind="quality", **fields)
        for tenant in parity_tenants:
            st = self.parity_state(tenant)
            if st is None:
                continue
            logger.log(
                step, kind="quality", tenant=tenant, probe="quant_parity",
                agreement=st["agreement"], margin_drift=st["margin_drift"],
                probes=float(st["probes"]), rows=float(st["rows"]),
                agreement_floor=self.parity_floor,
                margin_band=self.parity_margin_band,
            )
