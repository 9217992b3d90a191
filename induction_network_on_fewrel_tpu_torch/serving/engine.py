"""InferenceEngine: checkpoint -> multi-tenant few-shot serving on the card.

The counterpart of ``induction_network_on_fewrel_tpu/serving/engine.py``
(``InferenceEngine``) for one replica. It wires a ``TenantRegistry``
(supports distilled once into copy-on-write snapshots on two parameter
banks), a ``QueryGraphCache`` (one CUDA graph per (n_tier, bucket, dtype)
and bank, made at ``warmup``), a scheduler (the continuous cross-bucket
batcher by default, the per-bucket micro-batcher as the A/B arm), a
``ServingStats`` and an optional per-tenant ``CircuitBreaker``. Steady
state per query: host tokenization at ``submit``, then one graph replay
per batch (K1, K2 and the head against the tenant's resident class
matrix) and the verdicts.

* **Tenancy**: ``submit(..., tenant=...)`` scopes a query to one tenant's
  snapshot; batches never mix tenants.
* **Hot-swap**: ``publish_params``/``publish_checkpoint`` load new
  weights into the idle bank, re-distil and flip every snapshot; a batch
  in flight finishes on its pinned bank, and nothing is captured.
* **Warm-before-swap**: a registration that moves a live tenant across an
  N tier, and a ``set_resident_dtype`` roll, capture the new key's graphs
  first (counted as warmup), so steady-state traffic never captures.
* **Failure containment**: a batch whose execution raises fails its own
  futures with a typed ``ExecuteError`` (never another tenant's), feeds
  the breaker, and the worker survives; a quarantined tenant gets
  degraded NOTA verdicts with no device time.
* **Parity probe**: every ``quant_probe_every``-th batch of a quantized
  tenant is re-scored against its f32 shadow, and the verdict agreement
  and margin drift are counted (``stats.record_quant_probe``).
* **NOTA per tenant** (FewRel 2.0): a NOTA head's logit is appended as the
  last column and biased by the tenant's threshold; without a head a
  threshold is an open-set floor on the best class logit.

Threads and streams: the batcher's worker runs every batch with the
engine's device current and on a stream of its own, and replays graphs
that the control thread captured (``serving/buckets.py`` states the
capture rule). ``classify_batch``, the synchronous helper, runs its
batches on the caller's thread under the same lock as the worker's, on
the worker's stream. Each batch also records its host split (pack, copy
in, replay call, wait, verdicts; tokenization at submit): ``host_split``.

Telemetry (the JAX ``engine.py``): the request path runs under spans
(``serve/submit`` around tokenization, without an NVTX range;
``serve/stack`` and ``serve/execute`` per batch, linking the trace ids of
the sampled requests they served; ``serve/publish`` per publish, under a
trace of its own; the registry's ``serve/distill``). ``trace_sample=r``
head-samples 1 in round(1/r) admissions (0: nothing allocated): a
sampled request's verdict carries its ``trace_id`` and it gets one
``kind="trace"`` record whose ``queue_ms + pack_ms + execute_ms +
respond_ms`` equal its ``total_ms`` (the same timestamps the latency is
taken from), buffered and flushed with the periodic stats emit.
``slo`` (an SLOEngine) is fed every outcome by the stats and evaluated
from the submit path (a fully shed tenant too) and the emit path;
``drift`` (a DriftDetector) observes each verdict's quality features,
computed from the logits the verdicts are built from (no extra device
work), after the batch's futures resolve, and is re-armed by every
publish, registration, threshold or dtype change; ``watchdog`` (a
HealthWatchdog) hooks the logger and watches the queue from the submit
and emit paths. ``serve.execute_raise`` (``obs/chaos.py``) raises inside
a tenant's batch before the replay: contained like any launch failure.
The counters are bound into the shared counter registry
(``stats.bind_registry``) until ``close``.

Device rule: ``device=None`` means "cuda" and raises without CUDA; the
model must already live on that device. Refused as in the JAX package: a
model other than induction, and feature-cache checkpoints.

dp-sharded scoring (the JAX ``dp``, ``engine.py:284``): ``dp`` above 1
makes a serving mesh of the first ``dp`` visible CUDA devices
(``serving/buckets.make_serving_mesh``; ``devices`` replaces them, a test
seam), gives each parameter bank a replica on every shard device
(``TenantRegistry(shard_devices=...)``) and scores every bucket divisible
by dp across them (``QueryGraphCache(shards=...)``); ``dp`` None or 1 is
the single-device engine. An MoE model is refused at ``dp`` above 1
(``MOE_DP_REFUSAL``): its capacity routing couples the rows of a routing
group, so a bucket scored in row chunks could drop other tokens than the
whole bucket, which the JAX engine routes as one program.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from induction_network_on_fewrel_tpu_torch.data.fewrel import Instance
from induction_network_on_fewrel_tpu_torch.models.build import resolve_device
from induction_network_on_fewrel_tpu_torch.obs.chaos import ChaosError, chaos_active, chaos_fire
from induction_network_on_fewrel_tpu_torch.obs.drift import quality_features
from induction_network_on_fewrel_tpu_torch.obs.spans import TraceSampler, get_tracker, span
from induction_network_on_fewrel_tpu_torch.serving.batcher import (
    ContinuousBatcher,
    DynamicBatcher,
    ExecuteError,
    Request,
    Saturated,
)
from induction_network_on_fewrel_tpu_torch.serving.buckets import (
    DEFAULT_BUCKETS,
    QueryGraphCache,
    make_program,
    make_serving_mesh,
    select_bucket,
    stack_queries,
)
from induction_network_on_fewrel_tpu_torch.serving.registry import (
    DEFAULT_TENANT,
    TenantRegistry,
)
from induction_network_on_fewrel_tpu_torch.serving.stats import ServingStats

NO_RELATION = "no_relation"
# Host segments of a batch, in order (``host_split``).
SPLIT_KEYS = ("tokenize", "pack", "copy", "replay", "wait", "verdict")
MOE_DP_REFUSAL = (
    "serving dp above 1 is refused for an MoE checkpoint (--moe_experts): capacity routing "
    "couples the rows of a routing group, so scoring a bucket in dp row chunks could drop "
    "other tokens than the JAX engine's one program over the whole bucket; serve it at --dp 1")


def degraded_verdict(tenant: str, *, snapshot_version: int = -1,
                     latency_ms: float = 0.0, failover: bool = False) -> dict:
    """The degraded-mode NOTA verdict of a quarantined tenant, shared with
    the fleet router's failover path; ``failover=True`` marks the
    router-side variant."""
    verdict = {
        "label": NO_RELATION,
        "class_index": -1,
        "nota": True,
        "degraded": True,
        "margin": 0.0,
        "entropy": 0.0,
        "tenant": tenant,
        "snapshot_version": snapshot_version,
        "logits": {},
        "latency_ms": latency_ms,
    }
    if failover:
        verdict["failover"] = True
    return verdict


class _Knobs:
    """The engine's serving kwargs as the one-home resolvers read them
    (None = inherit the served config's value)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class HostSplit:
    """Host seconds per segment, summed over batches (tokenization over
    requests); ``ms()`` is the mean per batch (per request for tokenize)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._sum = dict.fromkeys(SPLIT_KEYS, 0.0)
            self.batches = 0
            self.requests = 0

    def add_tokenize(self, s: float) -> None:
        with self._lock:
            self._sum["tokenize"] += s
            self.requests += 1

    def add_batch(self, **segments: float) -> None:
        with self._lock:
            for k, v in segments.items():
                self._sum[k] += v
            self.batches += 1

    def ms(self) -> dict:
        with self._lock:
            out = {k: round(1e3 * v / max(1, self.batches), 4) for k, v in self._sum.items()}
            out["tokenize"] = round(1e3 * self._sum["tokenize"] / max(1, self.requests), 4)
            return out


class InferenceEngine:
    def __init__(self, model, cfg, tokenizer, k: int | None = None,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS, device=None,
                 max_queue_depth: int = 64, batch_window_s: float = 0.002,
                 default_deadline_s: float = 1.0, scheduler: str = "continuous",
                 tenant_share: float = 0.5, logger=None, breaker=None,
                 watchdog=None, slo=None, drift=None, trace_sample: float = 0.0,
                 start: bool = True, resident_dtype: str | None = None,
                 quant_probe_every: int | None = None,
                 geometry_tiers: str | None = None, program_factory=make_program,
                 dp: int | None = None, devices=None):
        from induction_network_on_fewrel_tpu_torch.config import (
            resolve_geometry_policy,
            resolve_quant_policy,
        )

        if cfg.model != "induction":
            raise ValueError(
                f"class-vector serving requires --model induction (supports distill to "
                f"per-class vectors); got {cfg.model!r}. Other episode heads re-read the "
                f"support set per query"
            )
        if cfg.feature_cache:
            raise ValueError(
                "feature-cache checkpoints hold head-only params (no encoder): the "
                "serving engine cannot encode queries through them; serve a full checkpoint"
            )
        if scheduler not in ("continuous", "microbatch"):
            raise ValueError(f"scheduler must be 'continuous' or 'microbatch', got {scheduler!r}")
        dev = resolve_device(device)
        if model.device.type != dev.type or dev.index not in (None, model.device.index):
            raise ValueError(f"model lives on {model.device}, engine asked for {dev}")
        self.cfg = cfg
        self.model = model
        self.device = model.device
        self.tokenizer = tokenizer
        self.nota = cfg.na_rate > 0
        self.max_length = cfg.max_length
        self.default_deadline_s = default_deadline_s
        self.scheduler = scheduler
        self._logger = logger
        self._emit_step = 0
        get_tracker().bind_device(self.device)
        self.watchdog = watchdog
        if watchdog is not None and logger is not None:
            logger.add_hook(watchdog.observe_record)
        self._tracer = TraceSampler(trace_sample)
        self.slo = slo
        if slo is not None and slo.logger is None:
            slo.logger = logger
        self.drift = drift
        if drift is not None and drift.logger is None:
            drift.logger = logger
        self._pending_traces: list[dict] = []
        self.breaker = breaker
        if breaker is not None and breaker.on_transition is None:
            breaker.on_transition = self._on_breaker_transition
        quant = resolve_quant_policy(
            _Knobs(resident_dtype=resident_dtype, quant_probe_every=quant_probe_every), base=cfg)
        geom = resolve_geometry_policy(_Knobs(geometry_tiers=geometry_tiers), base=cfg)
        self.quant_probe_every = quant["probe_every"]
        self._quant_batches = 0
        if dp and dp > 1 and getattr(cfg, "moe_experts", 0) > 0:
            raise ValueError(MOE_DP_REFUSAL)
        self.mesh = make_serving_mesh(dp, devices) if dp and dp > 1 else None
        self.stats = ServingStats(slo=slo)
        self.stats.bind_registry()
        self.registry = TenantRegistry(
            model, tokenizer, k=k if k is not None else cfg.k, logger=logger,
            resident_dtype=quant["resident_dtype"], tiers=geom["tiers"],
            shard_devices=self.mesh,
        )
        self.tiers = self.registry.tiers
        self.stats.bind_resident(self.registry.resident_bytes)
        self.programs = QueryGraphCache(self.registry.banks, stats=self.stats,
                                        factory=program_factory, shards=self.registry.shards)
        self.host_split = HostSplit()
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._exec_lock = threading.Lock()
        if scheduler == "continuous":
            self.batcher = ContinuousBatcher(
                self._execute_group, buckets=buckets, max_queue_depth=max_queue_depth,
                tenant_share=tenant_share, stats=self.stats, start=start,
            )
        else:
            self.batcher = DynamicBatcher(
                self._execute_batch, buckets=buckets, max_queue_depth=max_queue_depth,
                batch_window_s=batch_window_s, stats=self.stats, start=start,
            )

    # --- construction from a trained artifact ----------------------------

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, device=None, glove: str | None = None,
                        glove_mat: str | None = None, lstm_backend: str | None = None,
                        attn_backend: str | None = None, dp: int | None = None,
                        **kw) -> "InferenceEngine":
        """An engine on a port checkpoint directory: its ``config.json``
        decides the architecture, its best slot (else its latest) the
        weights. ``lstm_backend``/``attn_backend`` override the stored
        kernel backends; ``glove`` (+ ``glove_mat``) is the vocabulary the
        model was trained with (the synthetic one of its size otherwise). A
        BERT checkpoint owns its embedding: it is served with the
        ``BertTokenizer`` of its config (``bert_vocab_path``, else the hash
        fallback) and loads no GloVe. ``dp`` shards query scoring over that
        many devices (see the module doc)."""
        from induction_network_on_fewrel_tpu_torch.data import (
            BertTokenizer,
            GloveTokenizer,
            load_glove,
            make_synthetic_glove,
        )
        from induction_network_on_fewrel_tpu_torch.models.build import build_model
        from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager

        cfg = CheckpointManager.load_config(ckpt_dir)
        cfg = cfg.replace(**{k: v for k, v in (("lstm_backend", lstm_backend),
                                               ("attn_backend", attn_backend)) if v is not None})
        if cfg.encoder == "bert":
            tok = BertTokenizer(cfg.max_length, vocab_path=cfg.bert_vocab_path,
                                vocab_size=cfg.bert_vocab_size)
            model = build_model(cfg, device=device)
        else:
            vocab = (load_glove(glove, glove_mat) if glove else
                     make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim))
            if (cfg.vocab_size, cfg.word_dim) != (vocab.vocab_size, vocab.word_dim):
                raise ValueError(
                    f"vocab {vocab.vocab_size}x{vocab.word_dim} does not match the checkpoint's "
                    f"embedding table {cfg.vocab_size}x{cfg.word_dim}: pass the GloVe file the "
                    "model was trained with"
                )
            tok = GloveTokenizer(vocab, max_length=cfg.max_length)
            model = build_model(cfg, glove_init=vocab.vectors, device=device)
        mngr = CheckpointManager(ckpt_dir)
        try:
            step, which = mngr.restore_best(model), "best"
        except FileNotFoundError:
            (step, _), which = mngr.restore_latest(model), "latest"
        print(f"serving {which} checkpoint step={step} from {ckpt_dir} on {model.device}",
              file=sys.stderr)
        return cls(model, cfg, tok, device=device, dp=dp, **kw)

    # --- registration / tenant lifecycle ----------------------------------

    def register_class(self, name: str, instances, tenant: str = DEFAULT_TENANT):
        self._warm_tier_crossing(tenant, (name,))
        vec = self.registry.register(name, instances, tenant=tenant)
        self._drift_rearm(tenant, f"register_class {name!r}")
        return vec

    def register_tokens(self, name: str, rows, tenant: str = DEFAULT_TENANT):
        """``register_class`` from already-tokenized rows (the token cache's
        form, ``TenantRegistry.register_tokens``)."""
        self._warm_tier_crossing(tenant, (name,))
        vec = self.registry.register_tokens(name, rows, tenant=tenant)
        self._drift_rearm(tenant, f"register_tokens {name!r}")
        return vec

    def register_dataset(self, dataset, max_classes: int | None = None,
                         tenant: str = DEFAULT_TENANT) -> list[str]:
        adding = list(dataset.rel_names)
        if max_classes is not None:
            adding = adding[:max_classes]
        self._warm_tier_crossing(tenant, adding)
        names = self.registry.register_dataset(dataset, max_classes=max_classes, tenant=tenant)
        self._drift_rearm(tenant, f"register_dataset ({len(names)} classes)")
        return names

    def _dtypes_for(self, dtype: str) -> tuple[str, ...]:
        """The program dtypes a tenant at ``dtype`` needs: its own, and f32
        for the parity probe's shadow when the probe is on."""
        if self.quant_probe_every > 0 and dtype != "f32":
            return (dtype, "f32")
        return (dtype,)

    def _warm_tier_crossing(self, tenant: str, adding) -> int:
        """When a registration will move a live tenant across an N tier,
        make the new tier's programs first (counted as warmup), so its
        next batch finds them ready. Returns the programs made."""
        if self.tiers is None or not self.registry.has_tenant(tenant):
            return 0
        snap = self.registry.snapshot(tenant)
        cur_tier, c = snap.matrix.shape
        new_tier = self.registry.tier_of(len(set(snap.names) | set(adding)))
        if new_tier <= cur_tier:
            return 0
        return self.programs.warmup(new_tier, c, self.batcher.buckets, self.max_length,
                                    dtypes=self._dtypes_for(snap.resident_dtype))

    def set_nota_threshold(self, threshold: float | None, tenant: str = DEFAULT_TENANT):
        snap = self.registry.set_nota_threshold(threshold, tenant=tenant)
        self._drift_rearm(tenant, "nota_threshold change")
        return snap

    def _drift_rearm(self, tenant: str, reason: str) -> None:
        """A control-plane change moves the tenant's verdict distribution:
        re-calibrate its drift baseline (quiet for a tenant with none)."""
        if self.drift is not None:
            self.drift.rearm(tenant, reason=reason)

    @property
    def class_names(self) -> tuple[str, ...]:
        return self.registry.names

    def warmup(self) -> int:
        """Make every bucket's program for every registered tenant's
        (n_tier, resident dtype), and the f32 shadow's when the parity
        probe is on; returns the programs this call made. After warmup,
        steady-state traffic captures nothing (``steady_recompiles``)."""
        compiled = 0
        for tenant in self.registry.tenants():
            snap = self.registry.snapshot(tenant)
            n, c = snap.matrix.shape
            compiled += self.programs.warmup(n, c, self.batcher.buckets, self.max_length,
                                             dtypes=self._dtypes_for(snap.resident_dtype))
        return compiled

    def set_resident_dtype(self, tenant: str, dtype: str):
        """Re-quantize one live tenant: the new dtype's programs first
        (counted as warmup), then the registry's republish."""
        snap = self.registry.snapshot(tenant)
        n, c = snap.matrix.shape
        self.programs.warmup(n, c, self.batcher.buckets, self.max_length,
                             dtypes=self._dtypes_for(dtype))
        out = self.registry.set_resident_dtype(tenant, dtype)
        self._drift_rearm(tenant, f"resident_dtype {dtype}")
        return out

    # --- hot-swap publish -------------------------------------------------

    def _traced_publish(self, publish_fn, **span_attrs) -> int:
        """A publish under a trace of its own and a ``serve/publish`` span
        (the registry's distils join the trace), then the swap counter, the
        drift re-arm and a ``kind="trace"`` control record (op="publish")."""
        tracker = get_tracker()
        t0 = time.monotonic()
        with tracker.trace() as ctx, tracker.span("serve/publish", **span_attrs):
            version = publish_fn()
        self.stats.record_swap()
        if self.drift is not None:
            self.drift.rearm(reason=f"snapshot_swap v{version}")
        self._emit_trace({"trace_id": ctx.trace_id, "op": "publish",
                          "publish_ms": round((time.monotonic() - t0) * 1e3, 3),
                          "params_version": float(version),
                          "tenants": float(len(self.registry.tenants()))})
        return version

    def publish_params(self, new_params) -> int:
        """Atomic hot-swap to a model state_dict: every tenant re-distils
        on the idle bank and flips to it; batches in flight finish on
        their pinned bank; nothing is captured. Returns params_version."""
        return self._traced_publish(lambda: self.registry.publish_params(new_params))

    def publish_checkpoint(self, ckpt_dir: str) -> int:
        return self._traced_publish(lambda: self.registry.publish_checkpoint(ckpt_dir),
                                    source=ckpt_dir)

    def prepare_publish(self, new_params, target_version=None):
        """Phase 1 of a two-phase publish (the registry's transaction)."""
        return self.registry.prepare_publish(new_params, target_version=target_version)

    def commit_publish(self, txn) -> int:
        return self._traced_publish(txn.commit)

    # --- query path ------------------------------------------------------

    def _tokenize(self, instance) -> dict[str, np.ndarray]:
        t0 = time.perf_counter()
        t = self.tokenizer(self._as_instance(instance))
        self.host_split.add_tokenize(time.perf_counter() - t0)
        return {"word": t.word, "pos1": t.pos1, "pos2": t.pos2, "mask": t.mask}

    def submit(self, instance, deadline_s: float | None = None,
               tenant: str = DEFAULT_TENANT, trace=None):
        """Tokenize one query and enqueue it for ``tenant``; returns a
        Future of its verdict. Raises ``Saturated`` under backpressure or
        while the tenant's breaker is open. ``trace`` adopts a
        TraceContext the caller already minted (the fleet router's front
        door), so the request's segments join the router's trace id;
        otherwise the request is head-sampled here at ``trace_sample``."""
        self.registry.snapshot(tenant)   # raises for unknown tenants
        if self.breaker is not None:
            retry = self.breaker.admit(tenant)
            if retry is not None:
                self.stats.record_breaker_shed(tenant)
                if self.slo is not None:
                    self.slo.maybe_evaluate()
                raise Saturated(retry, tenant=tenant)
        if trace is None:
            trace = self._tracer.maybe_trace()   # None when unsampled
        if trace is None:
            query = self._tokenize(instance)
        else:
            tracker = get_tracker()
            with tracker.trace(trace), tracker.span("serve/submit", nvtx=False, tenant=tenant):
                query = self._tokenize(instance)
        try:
            fut = self.batcher.submit(
                query, deadline_s if deadline_s is not None else self.default_deadline_s,
                tenant=tenant, trace=trace)
        finally:
            # A shed or rejected submit raises after the batcher recorded
            # the bad outcome; a fully shed tenant runs no batch, so its SLO
            # windows are evaluated here.
            if self.slo is not None:
                self.slo.maybe_evaluate()
        if self.watchdog is not None:
            self.watchdog.observe_queue(self.batcher.queue_depth, self.stats.served)
        return fut

    def classify(self, instance, deadline_s: float | None = None,
                 tenant: str = DEFAULT_TENANT) -> dict:
        """Synchronous submit + wait."""
        fut = self.submit(instance, deadline_s, tenant=tenant)
        return fut.result(timeout=(deadline_s or self.default_deadline_s) + 5.0)

    def classify_batch(self, instances, tenant: str = DEFAULT_TENANT) -> list[dict]:
        """Verdicts for ``instances`` in batches of at most ``max(buckets)``
        rows, each padded to its bucket and run on the caller's thread
        (under the worker's lock, on its stream): a thin synchronous
        helper whose batch composition is fixed by the call. A failed
        batch raises its ``ExecuteError``."""
        cap = self.batcher.buckets[-1]
        instances = list(instances)
        verdicts: list[dict] = []
        for start in range(0, len(instances), cap):
            now = time.monotonic()
            batch = [Request(query=self._tokenize(inst), deadline=now + self.default_deadline_s,
                             future=Future(), enqueued_at=now, tenant=tenant)
                     for inst in instances[start:start + cap]]
            self._execute_group(tenant, batch)
            verdicts.extend(r.future.result() for r in batch)
        return verdicts

    @contextlib.contextmanager
    def _device_scope(self):
        """One batch's scope: the worker's lock, the engine's device and
        the worker's stream current, inference mode."""
        with self._exec_lock, torch.inference_mode():
            if self._stream is None:
                yield
            else:
                with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
                    yield

    def _execute_group(self, tenant: str, batch: list[Request]) -> None:
        """Continuous-scheduler callback: one tenant's batch."""
        with self._device_scope():
            try:
                self._run_group(tenant, batch)
            except BaseException as e:  # noqa: BLE001 — contain, never wedge
                self._contain_execute_failure(tenant, batch, e)
        self._maybe_emit()

    def _execute_batch(self, batch: list[Request]) -> None:
        """Micro-batcher callback: the collected batch may mix tenants;
        one program call per tenant sub-batch."""
        by_tenant: dict[str, list[Request]] = {}
        for r in batch:
            by_tenant.setdefault(r.tenant, []).append(r)
        with self._device_scope():
            for tenant, group in by_tenant.items():
                try:
                    self._run_group(tenant, group)
                except BaseException as e:  # noqa: BLE001 — isolate per tenant
                    self._contain_execute_failure(tenant, group, e)
        self._maybe_emit()

    def _contain_execute_failure(self, tenant: str, batch: list[Request],
                                 exc: BaseException) -> None:
        """One failed launch: the batch's futures fail with a typed
        ``ExecuteError`` carrying a retry-after hint, the failure feeds the
        tenant's breaker, and one kind="fault" record names it."""
        retry = (self.breaker.open_s if self.breaker is not None
                 else 2.0 * self.stats.exec_estimate_s())
        err = ExecuteError(tenant, retry_after_s=retry, cause=exc)
        for r in batch:
            if not r.future.done():
                r.future.set_exception(err)
        self.stats.record_execute_error(tenant, len(batch))
        if self.breaker is not None:
            self.breaker.record_failure(tenant)
        if self._logger is not None:
            self._logger.log(self.stats.served, kind="fault", action="execute_error",
                             tenant=tenant, requests=float(len(batch)),
                             cause=f"{type(exc).__name__}: {exc}")

    def _run_group(self, tenant: str, batch: list[Request]) -> None:
        # The pinned snapshot fixes (bank, matrix, names, threshold) for the
        # whole batch, and keeps a publish from overwriting its bank.
        snap = self.registry.pin(tenant)
        try:
            if snap.degraded:
                self._serve_degraded(tenant, batch, snap)
                if self.breaker is not None:
                    self.breaker.record_success(tenant)
                return
            if chaos_active() and chaos_fire("serve.execute_raise", tenant=tenant,
                                             step=self.stats.served) is not None:
                raise ChaosError(f"injected execute failure for tenant {tenant!r} (chaos)")
            bucket = select_bucket(len(batch), self.batcher.buckets)
            traced = [r for r in batch if r.trace is not None]
            links = tuple(r.trace.trace_id for r in traced)
            t_stack = time.monotonic()
            with span("serve/stack", links=links, rows=len(batch), bucket=bucket):
                query = stack_queries([r.query for r in batch], bucket)
            t0 = time.monotonic()
            with span("serve/execute", links=links, rows=len(batch), bucket=bucket):
                logits = self.programs.run(snap.bank, snap.matrix, query, scale=snap.scale)
            t_exec_end = time.monotonic()
            copy_s, replay_s, wait_s = self.programs.split
            self.stats.record_batch(len(batch), bucket, t_exec_end - t0)
            if self.breaker is not None:
                self.breaker.record_success(tenant)
            resolved = [(req, self._verdict(row, snap))
                        for row, req in zip(logits, batch)]   # zip drops the pad rows
            now = time.monotonic()
            for req, verdict in resolved:
                verdict["latency_ms"] = round((now - req.enqueued_at) * 1e3, 3)
                verdict["bucket"] = bucket
                if req.trace is not None:
                    verdict["trace_id"] = req.trace.trace_id
                self.stats.record_done(
                    now - req.enqueued_at, tenant=tenant,
                    trace_id=req.trace.trace_id if req.trace is not None else None,
                    nota=verdict["nota"], margin=verdict["margin"], entropy=verdict["entropy"])
                req.future.set_result(verdict)
            self.host_split.add_batch(pack=t0 - t_stack, copy=copy_s, replay=replay_s,
                                      wait=wait_s, verdict=now - t_exec_end)
            if self.drift is not None:
                # After the futures resolve: a drift CRITICAL writes its
                # capture on this thread, and clients must not wait on it.
                for _, verdict in resolved:
                    self.drift.observe(tenant, nota=verdict["nota"], margin=verdict["margin"],
                                       entropy=verdict["entropy"])
            if self.quant_probe_every > 0 and snap.shadow is not None:
                self._quant_batches += 1
                if self._quant_batches % self.quant_probe_every == 0:
                    self._parity_probe(tenant, snap, query, logits, len(batch))
            for req in traced:
                # The four segments tile [enqueued_at, now] with the
                # timestamps the latency is taken from.
                self._emit_trace({
                    "trace_id": req.trace.trace_id, "tenant": tenant,
                    "scheduler": self.scheduler, "bucket": float(bucket),
                    "rows": float(len(batch)),
                    "queue_ms": round((t_stack - req.enqueued_at) * 1e3, 3),
                    "pack_ms": round((t0 - t_stack) * 1e3, 3),
                    "execute_ms": round((t_exec_end - t0) * 1e3, 3),
                    "respond_ms": round((now - t_exec_end) * 1e3, 3),
                    "total_ms": round((now - req.enqueued_at) * 1e3, 3),
                })
        finally:
            self.registry.unpin(snap)

    def _serve_degraded(self, tenant: str, batch: list[Request], snap) -> None:
        """Quarantined tenant: every request resolves ``no_relation`` with
        ``degraded=True``, with no device time and no quality observation."""
        now = time.monotonic()
        for req in batch:
            verdict = degraded_verdict(
                tenant, snapshot_version=snap.version,
                latency_ms=round((now - req.enqueued_at) * 1e3, 3),
            )
            if req.trace is not None:
                verdict["trace_id"] = req.trace.trace_id
            self.stats.record_done(
                now - req.enqueued_at, tenant=tenant,
                trace_id=req.trace.trace_id if req.trace is not None else None)
            req.future.set_result(verdict)
        self.stats.record_degraded(tenant, len(batch))
        if self._logger is not None:
            self._logger.log(self.stats.served, kind="fault", action="degraded_verdicts",
                             tenant=tenant, served=float(len(batch)))

    def _parity_probe(self, tenant: str, snap, query, logits, rows) -> None:
        """Re-score the padded batch against the tenant's f32 shadow and
        count per-row verdict agreement (label and NOTA flag) and margin
        drift. A failing probe is contained here: the batch has answered."""
        try:
            ref = self.programs.run(snap.bank, snap.shadow, query)
            agree, drift_sum = 0, 0.0
            for i in range(rows):
                vq = self._verdict(logits[i], snap)
                vf = self._verdict(ref[i], snap)
                if vq["label"] == vf["label"] and vq["nota"] == vf["nota"]:
                    agree += 1
                drift_sum += abs(vq["margin"] - vf["margin"])
            self.stats.record_quant_probe(tenant, agree / rows, drift_sum / rows, rows)
            if self.drift is not None:
                self.drift.observe_parity(tenant, agreement=agree / rows,
                                          margin_drift=drift_sum / rows, rows=rows)
        except Exception as e:  # noqa: BLE001 — the probe must not hurt serving
            if self._logger is not None:
                self._logger.log(self.stats.served, kind="fault", action="quant_probe_error",
                                 tenant=tenant, cause=f"{type(e).__name__}: {e}")

    def _on_breaker_transition(self, tenant, frm, to, failures, now) -> None:
        if self._logger is not None:
            self._logger.log(self.stats.served, kind="fault", action="breaker",
                             tenant=tenant, **{"from": frm, "to": to},
                             failures=float(failures))

    def quarantine_tenant(self, tenant: str, reason: str = "") -> None:
        self.registry.quarantine_tenant(tenant, reason=reason)

    def unquarantine_tenant(self, tenant: str, reason: str = "") -> None:
        self.registry.unquarantine_tenant(tenant, reason=reason)
        self._drift_rearm(tenant, f"unquarantine {reason}".strip())

    def _emit_trace(self, rec: dict) -> None:
        """Keep one trace record in the stats at once; its ``kind="trace"``
        line is buffered and written with the periodic stats emit (the
        logger's per-record write and flush is the costliest part)."""
        self.stats.record_trace(rec)
        if self._logger is not None:
            self._pending_traces.append(rec)

    def _flush_traces(self) -> None:
        if self._logger is None or not self._pending_traces:
            return
        pending, self._pending_traces = self._pending_traces, []
        for rec in pending:
            self._logger.log(self.stats.served, kind="trace", **rec)

    def _verdict(self, row: np.ndarray, snap) -> dict:
        """One logits row -> verdict under the tenant's NOTA policy. Only
        the first ``n_classes`` columns are read (pad rows of the tier
        never win); the NOTA logit is ``row[-1]`` for every tier. With a
        NOTA head the threshold biases its logit; without one a threshold
        is an open-set floor on the best class logit. Ties resolve toward
        the class."""
        names = snap.names
        n = len(names)
        best = int(np.argmax(row[:n]))
        thr = snap.nota_threshold
        if self.nota:
            is_nota = float(row[-1]) + (thr or 0.0) > float(row[best])
        else:
            is_nota = thr is not None and float(row[best]) < thr
        m_arr, e_arr = quality_features(row[:n])
        verdict = {
            "label": NO_RELATION if is_nota else names[best],
            "class_index": -1 if is_nota else best,
            "nota": is_nota,
            "margin": round(float(m_arr), 6),
            "entropy": round(float(e_arr), 6),
            "tenant": snap.tenant,
            "snapshot_version": snap.version,
            "logits": {nm: float(row[i]) for i, nm in enumerate(names)},
        }
        if self.nota:
            verdict["logits"][NO_RELATION] = float(row[-1])
        return verdict

    # --- observability / lifecycle ---------------------------------------

    def _maybe_emit(self, every: int = 50) -> None:
        if self.watchdog is not None:
            self.watchdog.observe_queue(self.batcher.queue_depth, self.stats.served)
        if self.slo is not None:
            self.slo.maybe_evaluate()
        if self._logger is None:
            return
        if self.stats.batches - self._emit_step >= every:
            self._emit_step = self.stats.batches
            self._flush_traces()
            self.stats.emit(self._logger, self._emit_step, queue_depth=self.batcher.queue_depth)
            if self.drift is not None:
                self.drift.emit(self._logger, self._emit_step)

    def emit_stats(self) -> None:
        if self.watchdog is not None:
            self.watchdog.observe_queue(self.batcher.queue_depth, self.stats.served)
        if self.slo is not None:
            self.slo.evaluate()
        self._flush_traces()
        if self._logger is not None:
            self.stats.emit(self._logger, self.stats.batches,
                            queue_depth=self.batcher.queue_depth)
            if self.drift is not None:
                self.drift.emit(self._logger, self.stats.batches)

    def close(self) -> None:
        """Close the batcher, emit the final stats and release the counter
        registry's callbacks (write ``metrics.prom`` before this)."""
        self.batcher.close()
        self.emit_stats()
        self.stats.unbind_registry()

    @staticmethod
    def _as_instance(x):
        if isinstance(x, Instance):
            return x
        if isinstance(x, dict):
            if "h" in x:                       # raw FewRel JSON schema
                return Instance.from_raw(x)
            return Instance(
                tokens=tuple(x["tokens"]),
                head_pos=tuple(x.get("head_pos", (0,))),
                tail_pos=tuple(x.get("tail_pos", (0,))),
            )
        raise TypeError(f"cannot interpret query of type {type(x).__name__}")
