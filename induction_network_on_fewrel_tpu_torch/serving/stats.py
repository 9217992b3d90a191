"""Serving counters: latency percentiles (aggregate and per tenant), queue
depth, batch occupancy, shed, swap, capture and parity-probe counters.

A copy of ``ServingStats`` from
``induction_network_on_fewrel_tpu/serving/stats.py``. Counters are updated
from the submitting threads and the batcher's worker, so every mutation
holds one lock; ``snapshot()`` is a consistent dict and the record
``emit`` writes (kind="serve", plus one per tenant and one kind="quality"
per tenant with quality-bearing verdicts). Latency samples are bounded
reservoirs (Algorithm R with a deterministic xorshift), read with the
nearest-rank percentile. ``record_compile`` counts query-graph captures:
during warmup, or after it (``steady_recompiles``, the zero-capture
acceptance counter).

``slo`` (an ``obs/health.SLOEngine``) is fed every request outcome
(latency, or an error: rejected, shed, breaker-shed, execute error,
deadline miss); ``record_trace`` keeps a bounded window of sampled
per-request trace records, ``trace_summary`` their segment medians; and
``bind_registry`` exposes the counters in the shared counter registry
(``obs/export.py``) as pull gauges, with a ``serve_latency_ms``
histogram whose buckets carry exemplar trace ids (the JAX
``stats.py:430``); ``unbind_registry`` releases them.
"""

from __future__ import annotations

import threading
from collections import deque


def nearest_rank(xs: list[float], q: float) -> float | None:
    """Nearest-rank percentile over unsorted samples; None when empty.
    The percentile convention of the serving stack (the JAX package's)."""
    s = sorted(xs)
    if not s:
        return None
    i = min(len(s) - 1, max(0, int(round(q / 100.0 * len(s))) - 1))
    return s[i]


class _Reservoir:
    """Fixed-size uniform reservoir (Algorithm R) of latency samples.

    Below the cap it is exact; past the cap each new sample replaces a
    random slot with probability cap/n, so the retained set stays a
    uniform sample of EVERYTHING observed — bounded memory with honest
    long-run percentiles (a round-robin window would instead forget every
    sample older than the cap). The RNG is a tiny xorshift (no numpy on
    the hot path) seeded per reservoir, so runs are deterministic."""

    __slots__ = ("cap", "ms", "n", "_rng")

    def __init__(self, cap: int, seed: int = 0x9E3779B9):
        self.cap = cap
        self.ms: list[float] = []
        self.n = 0
        self._rng = (seed or 1) & 0xFFFFFFFF

    def _next_rand(self) -> int:
        # xorshift32: cheap, stateful, plenty for replacement sampling.
        x = self._rng
        x ^= (x << 13) & 0xFFFFFFFF
        x ^= x >> 17
        x ^= (x << 5) & 0xFFFFFFFF
        self._rng = x
        return x

    def add(self, ms: float) -> None:
        self.n += 1
        if len(self.ms) < self.cap:
            self.ms.append(ms)
            return
        j = self._next_rand() % self.n
        if j < self.cap:
            self.ms[j] = ms

    def percentile(self, q: float) -> float | None:
        return nearest_rank(self.ms, q)


class _TenantStats:
    """Per-tenant slice of the counters (guarded by the owner's lock).

    The quality slice: ``nota`` counts ``no_relation``
    verdicts, ``margin``/``entropy`` are reservoirs of the per-verdict
    top-1 margin and score entropy — the same three features the online
    drift detector watches, kept here so the periodic
    ``kind="quality"`` record states what the tenant's traffic looks
    like even when no detector is armed."""

    __slots__ = ("served", "rejected", "shed", "deadline_missed", "lat",
                 "nota", "quality_n", "margin", "entropy",
                 "execute_errors", "breaker_shed", "degraded",
                 "quant_probes", "quant_rows", "quant_agree_rows",
                 "quant_margin_sum")

    def __init__(self, reservoir_cap: int):
        # Quantization parity police: sampled shadow-score
        # outcomes — probe launches, rows compared, rows whose VERDICT
        # (label + NOTA flag) agreed with f32, and the summed per-row
        # |margin drift| (means come out at read time).
        self.quant_probes = 0
        self.quant_rows = 0
        self.quant_agree_rows = 0
        self.quant_margin_sum = 0.0
        self.served = 0
        self.rejected = 0
        self.shed = 0
        self.deadline_missed = 0
        self.execute_errors = 0   # requests failed by a launch failure
        self.breaker_shed = 0     # submits shed by an open circuit breaker
        self.degraded = 0         # open-set-floor NOTA verdicts served
        #                           while the tenant was quarantined
        self.lat = _Reservoir(reservoir_cap)
        self.nota = 0
        self.quality_n = 0   # verdicts that CARRIED quality features —
        #                      the honest nota_rate denominator when
        #                      quality-less legacy completions mix in
        self.margin = _Reservoir(reservoir_cap, seed=0x51F15EED)
        self.entropy = _Reservoir(reservoir_cap, seed=0x5EED5EED)


class ServingStats:
    """Thread-safe serving counters + bounded latency reservoirs."""

    # Long soaks must not grow host memory without limit. Per-tenant
    # reservoirs are deliberately narrow: at 1024 floats each, a
    # thousand-tenant fleet holds ~8 MB of latency state total (and the
    # Algorithm-R reservoir keeps the percentile honest over the full
    # history at that size — nearest-rank p99 needs ~100+ samples, which
    # 1024 clears with margin).
    MAX_SAMPLES = 65536
    TENANT_SAMPLES = 1024
    MAX_TRACES = 512        # retained sampled per-request trace records

    def __init__(self, slo=None) -> None:
        self._lock = threading.Lock()
        self._slo = slo
        self._traces: deque[dict] = deque(maxlen=self.MAX_TRACES)
        self._hist = None       # the bound latency histogram (bind_registry)
        self._lat = _Reservoir(self.MAX_SAMPLES)
        self._tenants: dict[str, _TenantStats] = {}
        self.served = 0             # futures resolved with a verdict
        self.rejected = 0           # backpressure rejections at submit
        self.shed = 0               # per-tenant share breaches (shed-load)
        self.deadline_missed = 0    # expired before execution
        self.execute_errors = 0     # requests failed by launch failures
        #                             (typed ExecuteError)
        self.breaker_shed = 0       # submits shed by open circuit breakers
        self.degraded = 0           # degraded-mode NOTA verdicts served
        self.batches = 0            # bucket executions
        self.batch_rows = 0         # real (unpadded) rows executed
        self.batch_slots = 0        # bucket slots executed (incl. padding)
        self.exec_s_total = 0.0     # device time across batches
        self._exec_ewma_s: float | None = None
        self.warmup_compiles = 0    # programs compiled by warmup()
        self.steady_compiles = 0    # programs compiled AFTER warmup — the
        #                             zero-recompile acceptance counter
        self.swaps = 0              # atomic hot-swap publishes applied
        self.quant_probes = 0       # parity-police shadow-score launches
        # Resident-bytes provider: the
        # engine binds registry.resident_bytes here; snapshots then carry
        # chip-resident bytes per tenant through the same spine as every
        # other counter. Called OUTSIDE this object's lock (the registry
        # has its own).
        self._resident = None

    # --- recording -------------------------------------------------------

    def _tenant(self, tenant: str | None) -> _TenantStats | None:
        if tenant is None:
            return None
        ts = self._tenants.get(tenant)
        if ts is None:
            ts = self._tenants[tenant] = _TenantStats(self.TENANT_SAMPLES)
        return ts

    def record_done(
        self, latency_s: float, tenant: str | None = None,
        trace_id: str | None = None,
        nota: bool | None = None,
        margin: float | None = None,
        entropy: float | None = None,
    ) -> None:
        """``nota``/``margin``/``entropy`` are the verdict's quality
        features (engine._verdict computes them from the logits row);
        None = caller has no quality signal (legacy paths)."""
        with self._lock:
            self.served += 1
            ms = latency_s * 1e3
            self._lat.add(ms)
            ts = self._tenant(tenant)
            if ts is not None:
                ts.served += 1
                ts.lat.add(ms)
                if nota is not None:
                    ts.quality_n += 1
                    if nota:
                        ts.nota += 1
                if margin is not None:
                    ts.margin.add(float(margin))
                if entropy is not None:
                    ts.entropy.add(float(entropy))
            hist = self._hist
        # Outside the counter lock: the histogram and the SLO engine have
        # their own locks and never call back into this object.
        if hist is not None:
            hist.observe(ms, exemplar=trace_id)
        if self._slo is not None and tenant is not None:
            self._slo.record(tenant, latency_ms=ms)

    def record_rejected(self, tenant: str | None = None) -> None:
        with self._lock:
            self.rejected += 1
            ts = self._tenant(tenant)
            if ts is not None:
                ts.rejected += 1
        if self._slo is not None and tenant is not None:
            self._slo.record(tenant, error=True)

    def record_shed(self, tenant: str) -> None:
        """A per-tenant share breach: THIS tenant sheds while the queue
        still admits others (counted in rejected too — a shed is a
        rejection, with attribution)."""
        with self._lock:
            self.rejected += 1
            self.shed += 1
            ts = self._tenant(tenant)
            ts.rejected += 1
            ts.shed += 1
        if self._slo is not None:
            self._slo.record(tenant, error=True)

    def record_swap(self) -> None:
        with self._lock:
            self.swaps += 1

    def record_execute_error(self, tenant: str | None, requests: int) -> None:
        """A failed launch: ``requests`` futures of ONE tenant's batch
        failed with a typed ExecuteError (the containment contract —
        nothing else fails). Each counts as a bad outcome for the
        tenant's SLO."""
        with self._lock:
            self.execute_errors += requests
            ts = self._tenant(tenant)
            if ts is not None:
                ts.execute_errors += requests
        if self._slo is not None and tenant is not None:
            for _ in range(requests):
                self._slo.record(tenant, error=True)

    def record_breaker_shed(self, tenant: str) -> None:
        """A submit shed by this tenant's OPEN circuit breaker: counted
        apart from share-based shed-load so the watchdog's shed_load
        signal keeps meaning 'over admission share' and breaker activity
        reads from its own counter (and its own breaker_open critical)."""
        with self._lock:
            self.rejected += 1
            self.breaker_shed += 1
            ts = self._tenant(tenant)
            ts.rejected += 1
            ts.breaker_shed += 1
        if self._slo is not None:
            self._slo.record(tenant, error=True)

    def record_degraded(self, tenant: str | None, requests: int) -> None:
        """Degraded-mode NOTA verdicts served for a quarantined tenant.
        Counted as SERVED for throughput/latency (record_done is called
        per request as usual); this counter is the degraded-traffic
        attribution on top."""
        with self._lock:
            self.degraded += requests
            ts = self._tenant(tenant)
            if ts is not None:
                ts.degraded += requests

    def record_deadline_miss(self, tenant: str | None = None) -> None:
        with self._lock:
            self.deadline_missed += 1
            ts = self._tenant(tenant)
            if ts is not None:
                ts.deadline_missed += 1
        if self._slo is not None and tenant is not None:
            self._slo.record(tenant, error=True)

    def record_trace(self, rec: dict) -> None:
        """Retain one sampled per-request trace record (locked: readers
        iterate the window from other threads)."""
        with self._lock:
            self._traces.append(rec)

    def record_batch(self, rows: int, bucket: int, exec_s: float) -> None:
        with self._lock:
            self.batches += 1
            self.batch_rows += rows
            self.batch_slots += bucket
            self.exec_s_total += exec_s
            # EWMA of batch execution time: the batcher's deadline-pressure
            # slack estimate (how long collecting more rows can wait before
            # the oldest request would miss its deadline).
            a = 0.2
            self._exec_ewma_s = (
                exec_s if self._exec_ewma_s is None
                else a * exec_s + (1 - a) * self._exec_ewma_s
            )

    def bind_resident(self, provider) -> None:
        """Attach the resident-bytes provider: a callable returning
        {tenant: chip-resident bytes} (registry.resident_bytes)."""
        self._resident = provider

    def resident_bytes_snapshot(self) -> dict[str, float]:
        """Per-tenant chip-resident bytes from the bound provider ({} when
        none is bound). Never raises — capacity gauges must not take the
        serving path down with them."""
        prov = self._resident
        if prov is None:
            return {}
        try:
            return {t: float(b) for t, b in prov().items()}
        except Exception:  # noqa: BLE001 — gauge-only path
            return {}

    def record_quant_probe(
        self, tenant: str | None, agreement: float, margin_drift: float,
        rows: int,
    ) -> None:
        """One parity-police probe outcome: ``agreement`` is the fraction
        of ``rows`` whose quantized verdict matched the f32 shadow,
        ``margin_drift`` the mean per-row |margin delta|."""
        with self._lock:
            self.quant_probes += 1
            ts = self._tenant(tenant)
            if ts is not None:
                ts.quant_probes += 1
                ts.quant_rows += rows
                ts.quant_agree_rows += int(round(agreement * rows))
                ts.quant_margin_sum += float(margin_drift) * rows

    def record_compile(self, during_warmup: bool) -> None:
        with self._lock:
            if during_warmup:
                self.warmup_compiles += 1
            else:
                self.steady_compiles += 1

    # --- reading ---------------------------------------------------------

    def exec_estimate_s(self, default: float = 0.005) -> float:
        with self._lock:
            return self._exec_ewma_s if self._exec_ewma_s is not None else default

    def percentile_ms(self, q: float) -> float | None:
        """Nearest-rank percentile over the latency reservoir (no numpy
        import on the submit path; the reservoir is small)."""
        with self._lock:
            return self._lat.percentile(q)

    @property
    def slo(self):
        return self._slo

    def trace_summary(self) -> dict | None:
        """Segment medians (nearest rank) and the newest exemplar trace ids
        over the retained sampled traces; None with none recorded."""
        with self._lock:
            traces = [t for t in self._traces if "total_ms" in t]
        if not traces:
            return None

        def med(key: str) -> float | None:
            p = nearest_rank([float(t[key]) for t in traces
                              if isinstance(t.get(key), (int, float))], 50)
            return round(p, 3) if p is not None else None

        return {
            "sampled": len(traces),
            "queue_ms_p50": med("queue_ms"),
            "pack_ms_p50": med("pack_ms"),
            "execute_ms_p50": med("execute_ms"),
            "respond_ms_p50": med("respond_ms"),
            "total_ms_p50": med("total_ms"),
            "exemplar_trace_ids": [t["trace_id"] for t in traces[-5:] if "trace_id" in t],
        }

    def bind_registry(self, registry=None, prefix: str = "serve") -> None:
        """Expose these counters through the shared counter registry
        (default: the process-global one) as pull gauges, read at render
        time, and bind the ``{prefix}_latency_ms`` histogram the record
        path observes into (its buckets carry exemplar trace ids). A fresh
        histogram per bind: the latest binding wins."""
        from induction_network_on_fewrel_tpu_torch.obs.export import get_registry

        reg = registry or get_registry()
        self._bound_registry = reg
        self._bound_fns: list[tuple[str, object]] = []
        reg.unregister(f"{prefix}_latency_ms")
        self._hist = reg.histogram(f"{prefix}_latency_ms",
                                   help="request latency with exemplar trace_ids")
        self._hist_name = f"{prefix}_latency_ms"

        def _register(full: str, f, help: str) -> None:
            self._bound_fns.append((full, f))
            reg.gauge_fn(full, f, help)

        def attr(name: str, help: str = "") -> None:
            _register(f"{prefix}_{name}", lambda n=name: getattr(self, n), help)

        attr("served", "futures resolved with a verdict")
        attr("rejected", "backpressure rejections at submit")
        attr("shed", "per-tenant share breaches (shed-load)")
        attr("swaps", "atomic hot-swap publishes applied")
        attr("deadline_missed", "requests expired before execution")
        attr("batches", "bucket executions")
        attr("warmup_compiles", "programs compiled by warmup()")
        attr("steady_compiles", "programs compiled after warmup")

        def derived(name: str, help: str = "") -> None:
            _register(f"{prefix}_{name}", lambda k=name: self.snapshot()[k], help)

        derived("batch_occupancy", "real rows / bucket slots executed")
        derived("p50_ms", "median request latency")
        derived("p99_ms", "tail request latency")
        derived("resident_bytes", "chip-resident class-matrix bytes")
        derived("quant_agreement", "parity-police verdict agreement vs f32")

    def unbind_registry(self) -> None:
        """Release this object's callbacks and histogram from the registry
        (engine close), identity-checked so a successor's survive."""
        reg = getattr(self, "_bound_registry", None)
        if reg is None:
            return
        for name, f in self._bound_fns:
            reg.unregister(name, fn=f)
        if self._hist is not None:
            reg.unregister(self._hist_name, inst=self._hist)
            self._hist = None
        self._bound_registry = None
        self._bound_fns = []

    def snapshot(self, queue_depth: int | None = None) -> dict:
        # Provider call BEFORE taking our lock (it holds the registry's).
        resident = self.resident_bytes_snapshot()
        with self._lock:
            p50 = self._lat.percentile(50)
            p99 = self._lat.percentile(99)
            occ = (
                self.batch_rows / self.batch_slots if self.batch_slots else 0.0
            )
            agree_rows = sum(
                ts.quant_agree_rows for ts in self._tenants.values()
            )
            quant_rows = sum(ts.quant_rows for ts in self._tenants.values())
            snap = {
                "served": self.served,
                "rejected": self.rejected,
                "shed": self.shed,
                "deadline_missed": self.deadline_missed,
                "execute_errors": self.execute_errors,
                "breaker_shed": self.breaker_shed,
                "degraded": self.degraded,
                "batches": self.batches,
                "batch_occupancy": round(occ, 4),
                "p50_ms": round(p50, 3) if p50 is not None else 0.0,
                "p99_ms": round(p99, 3) if p99 is not None else 0.0,
                "warmup_compiles": self.warmup_compiles,
                "steady_recompiles": self.steady_compiles,
                "swaps": self.swaps,
                # Capacity accounting: total chip-resident
                # class-matrix bytes — the fleet rollup's density
                # numerator-per-replica. 0.0 with no provider bound.
                "resident_bytes": round(sum(resident.values()), 1),
                "quant_probes": self.quant_probes,
                # Rows-weighted verdict agreement across tenants; 1.0
                # with no probes (vacuous truth keeps floor checks
                # green for unquantized arms).
                "quant_agreement": round(
                    agree_rows / quant_rows, 4
                ) if quant_rows else 1.0,
            }
        if queue_depth is not None:
            snap["queue_depth"] = queue_depth
        return snap

    def tenant_snapshot(self) -> dict[str, dict]:
        """Consistent per-tenant view: {tenant: {served, rejected, shed,
        deadline_missed, p50_ms, p99_ms, resident_bytes}}."""
        resident = self.resident_bytes_snapshot()
        with self._lock:
            out = {}
            for name, ts in self._tenants.items():
                p50, p99 = ts.lat.percentile(50), ts.lat.percentile(99)
                out[name] = {
                    "served": ts.served,
                    "rejected": ts.rejected,
                    "shed": ts.shed,
                    "deadline_missed": ts.deadline_missed,
                    "execute_errors": ts.execute_errors,
                    "breaker_shed": ts.breaker_shed,
                    "degraded": ts.degraded,
                    "p50_ms": round(p50, 3) if p50 is not None else 0.0,
                    "p99_ms": round(p99, 3) if p99 is not None else 0.0,
                    "resident_bytes": resident.get(name, 0.0),
                }
            return out

    def quality_snapshot(self) -> dict[str, dict]:
        """Per-tenant prediction-quality view: {tenant:
        {served, nota_rate, margin_p50, entropy_p50}} for tenants whose
        verdicts carried quality features. The traffic-side half of the
        quality record."""
        with self._lock:
            out = {}
            for name, ts in self._tenants.items():
                if ts.quality_n == 0:
                    continue
                m50 = ts.margin.percentile(50)
                e50 = ts.entropy.percentile(50)
                out[name] = {
                    "served": ts.served,
                    # Rate over quality-BEARING verdicts only: mixing in
                    # legacy nota=None completions would dilute it.
                    "nota_rate": round(ts.nota / ts.quality_n, 4),
                    "margin_p50": round(m50, 4) if m50 is not None else 0.0,
                    "entropy_p50": round(e50, 4) if e50 is not None else 0.0,
                }
                if ts.quant_rows:
                    # Parity-police slice: verdict agreement
                    # vs the f32 shadow + mean |margin drift| over every
                    # probed row of this tenant.
                    out[name]["quant_agreement"] = round(
                        ts.quant_agree_rows / ts.quant_rows, 4
                    )
                    out[name]["quant_margin_drift"] = round(
                        ts.quant_margin_sum / ts.quant_rows, 4
                    )
            return out

    def emit(self, logger, step: int, queue_depth: int | None = None) -> None:
        """The aggregate kind="serve" record plus ONE kind="serve" record
        per tenant (distinguished by the ``tenant`` string field — every
        field stays a scalar), plus ONE ``kind="quality"``
        record per tenant with quality-bearing verdicts (nota_rate /
        margin_p50 / entropy_p50 — the model-quality stream next to the
        latency stream)."""
        logger.log(step, kind="serve", **self.snapshot(queue_depth))
        for tenant, snap in sorted(self.tenant_snapshot().items()):
            logger.log(step, kind="serve", tenant=tenant, **snap)
        for tenant, snap in sorted(self.quality_snapshot().items()):
            logger.log(step, kind="quality", tenant=tenant, **snap)
