"""Serving entry point of the port: ``serve_main``, the counterpart of the
JAX package's ``serve.py`` (``serving/cli.py`` ``serve_main``) for one
replica, and the fresh-weight demo ``main``.

    python -m induction_network_on_fewrel_tpu_torch.serving.cli \\
        --load_ckpt ./ckpt_torch --support_file supports.json \\
        --input queries.jsonl [--device cpu]

Flow: restore a port checkpoint (``--load_ckpt``; fresh-init synthetic
weights without it, demo only), register the support sets (a
FewRel-schema JSON via ``--support_file``, else the synthetic fixtures),
make every (n_tier, bucket, dtype) query graph (``warmup``), then answer
queries: JSON lines from ``--input`` (``-`` = stdin), or a demo batch of
held-out instances of the registered corpus. One verdict JSON per line
on stdout; the serving counters go to stderr, and kind="serve" records
to ``--run_dir/metrics.jsonl``. The flags are the JAX ones under the same
names, plus ``--lstm_backend``/``--attn_backend`` (the kernel backends,
default the checkpoint's). Runs on the GPU by default and refuses to
start without CUDA unless ``--device cpu`` is given.

Telemetry (the JAX ``serving/cli.py:591-670``): ``--watchdog`` (the
health watchdog over the serve stream), ``--trace_sample R`` (per-request
``kind="trace"`` waterfalls; verdicts carry ``trace_id``),
``--slo_latency_ms`` with ``--slo_availability``, ``--slo_fast_s``,
``--slo_slow_s`` (the per-tenant burn-rate engine; ``--slo_profile`` lets
its captures take a torch.profiler trace), ``--drift`` with
``--drift_window``, ``--drift_baseline``, ``--drift_band`` (the
prediction-drift detector) and ``--chaos PLAN`` (``serve.*`` and
``publish.*`` fault points). Any of the watchdog, SLO or drift arms the
flight recorder (``flight_recorder.json`` in ``--run_dir``); SLO and drift
criticals capture diagnostics there. With ``--run_dir`` the shared
counter registry is written as ``metrics.prom`` at exit.

Fleet mode (the JAX ``serving/cli.py:946 _serve_fleet``): ``--replicas N``
(or ``--router`` with one) runs N in-process engine replicas on one card
behind the fleet router (rendezvous placement, ``--tier_spread`` tier
homes, fleet-share shedding, breaker-fed failover, the all-or-nothing
fan-out publish); ``--journal DIR`` write-ahead-logs every control-plane
op (``--journal_fsync``, ``--journal_compact_every``) and recovers the
directory from it at start; ``--autoscale`` (``--autoscale_min``,
``--autoscale_max``, ``--autoscale_interval_s``) arms the SLO-driven
autoscaler; ``--control_socket PATH`` serves operator commands (drain,
forgive, revive, retire, stats; status and promote on a standby), and
``--send JSON`` is its client; ``--standby`` tails ``--journal`` read-only
and promotes (``--standby_poll_s``). ``--adapt`` (needs ``--drift``) arms
the drift-triggered adaptation controller: a drift CRITICAL starts a
mixture-ramp fine-tune (``train/finetune.py``) from the served checkpoint
toward ``--adapt_mixture`` (the synthetic shifted twin on the demo path),
holds the candidate to the ``--adapt_canary`` floors (``obs/canary.py``),
publishes it (through the fan-out in fleet mode) and verifies; the
``--adapt_*`` budgets default to the checkpoint's stamped policy.

``--dp N`` shards query scoring over the first N visible cards (the
engine's ``dp``, one engine and each in-process fleet replica); more than
there are exits 2 with the JAX "exceeds the visible devices" text.
``--compile_cache`` has no counterpart here (``NO_COUNTERPART``): it is
parsed and refused by name unless at its JAX default.

``main`` is the fresh-weight demo: a synthetic vocabulary, fresh-init
weights from ``--seed``, the first N synthetic relations registered at K
shots and held-out instances classified in bucketed batches:

    python -m induction_network_on_fewrel_tpu_torch.serving.cli demo \\
        --N 5 --K 5 --num_queries 16 --seed 0 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

# JAX serving flags of later slices: flag -> the ROADMAP queue A item that
# brings it. A flag given with anything but its JAX default is refused.
DEFERRED: dict = {}
# JAX serving flags the port has no counterpart for: flag -> why.
NO_COUNTERPART = {
    "--compile_cache": "the port keeps no XLA compile cache (its kernels build once into "
                       "build/torch_kernels)",
}
# The JAX defaults of the refused flags (and values that mean the same).
_NEUTRAL = {"--compile_cache": ("auto", "off")}
_FLAGS: set = set()
_TYPES: dict = {}


def build_serve_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m induction_network_on_fewrel_tpu_torch.serving.cli",
        description="few-shot inference engine (induction network) on the GPU",
    )
    p.add_argument("--load_ckpt", default=None,
                   help="port checkpoint directory to serve; omitted = fresh-init synthetic "
                        "weights (demo only: verdicts are untrained)")
    p.add_argument("--support_file", default=None,
                   help="FewRel-schema JSON of support sets; each relation registers with "
                        "its first K instances (synthetic fixtures when omitted)")
    p.add_argument("--K", type=int, default=5, help="shots per registered class")
    p.add_argument("--max_classes", type=int, default=None,
                   help="register at most this many relations")
    p.add_argument("--input", default=None, metavar="FILE|-",
                   help="JSON-lines queries (FewRel instance schema or {'tokens': [...]}); "
                        "'-' = stdin; omitted = demo queries from the support corpus")
    p.add_argument("--glove", default=None, help="GloVe json (word2id or combined) or .txt")
    p.add_argument("--glove_mat", default=None, help=".npy matrix for a word2id json")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the GPU (refuses to start without CUDA)")
    p.add_argument("--lstm_backend", default=None, choices=["auto", "reference", "cuda"],
                   help="BiLSTM impl (default: the checkpoint's): auto = the CUDA kernel on "
                        "the GPU, reference = the plain PyTorch version")
    p.add_argument("--attn_backend", default=None, choices=["auto", "reference", "cuda"],
                   help="self-attention impl (default: the checkpoint's)")
    p.add_argument("--buckets", default="1,2,4,8,16",
                   help="comma-separated batch shape buckets (each one query graph per "
                        "tier and dtype)")
    p.add_argument("--scheduler", default="continuous", choices=["continuous", "microbatch"],
                   help="continuous = cross-bucket launch-on-free scheduler; microbatch = "
                        "the per-bucket coalescing batcher (A/B baseline)")
    p.add_argument("--dp", type=int, default=None,
                   help="shard query scoring over this many local cards (buckets divisible "
                        "by dp score dp-sharded)")
    p.add_argument("--tenant_share", type=float, default=0.5,
                   help="per-tenant fraction of --queue_depth before that tenant sheds")
    p.add_argument("--nota_threshold", type=float, default=None,
                   help="NOTA threshold for the default tenant: biases the learned "
                        "no-relation logit (na_rate>0 checkpoints) or sets an open-set "
                        "floor on the best class logit")
    p.add_argument("--queue_depth", type=int, default=64,
                   help="bounded request-queue depth (backpressure bound)")
    p.add_argument("--batch_window_ms", type=float, default=2.0,
                   help="max time to wait coalescing a bucket (microbatch scheduler only)")
    p.add_argument("--deadline_ms", type=float, default=1000.0,
                   help="default per-request deadline")
    p.add_argument("--demo_queries", type=int, default=32,
                   help="queries for the built-in demo (no --input)")
    p.add_argument("--run_dir", default=None,
                   help="metrics.jsonl dir for kind='serve' records")
    p.add_argument("--breaker_threshold", type=int, default=0,
                   help="per-tenant circuit breaker: open after this many consecutive "
                        "launch failures and shed that tenant until a half-open probe "
                        "succeeds; 0 = off")
    p.add_argument("--breaker_open_s", type=float, default=5.0,
                   help="seconds an open breaker sheds before admitting its probe")
    p.add_argument("--resident_dtype", default=None, choices=["f32", "bf16", "int8"],
                   help="dtype of the resident class matrices (default f32 or the "
                        "checkpoint config)")
    p.add_argument("--quant_probe_every", type=int, default=None,
                   help="re-score every Nth quantized batch against f32 (0 = off)")
    p.add_argument("--geometry_tiers", default=None,
                   help="N-tier ladder the class matrices pad up to ('4,8,16,32,64'), or "
                        "'off' for exact-N (default: the checkpoint config)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--watchdog", action="store_true",
                   help="run-health watchdog: queue-stall detection + NaN checks over the "
                        "serve stream; critical events dump flight_recorder.json to --run_dir")
    p.add_argument("--trace_sample", type=float, default=0.0,
                   help="request-trace head-sampling rate (0 = off; 0.1 traces every 10th "
                        "request): kind='trace' segment records to --run_dir")
    p.add_argument("--slo_latency_ms", type=float, default=None,
                   help="per-request latency objective; turns on the per-tenant SLO "
                        "burn-rate engine (a fast-window CRITICAL captures diagnostics)")
    p.add_argument("--slo_availability", type=float, default=0.99,
                   help="SLO good-fraction target (error budget = 1 - this)")
    p.add_argument("--slo_fast_s", type=float, default=300.0, help="fast burn window seconds")
    p.add_argument("--slo_slow_s", type=float, default=3600.0, help="slow burn window seconds")
    p.add_argument("--slo_profile", action="store_true",
                   help="let SLO/drift captures take a torch.profiler trace")
    p.add_argument("--drift", action="store_true",
                   help="online prediction-drift detector: per-tenant NOTA rate / top-1 "
                        "margin / score entropy vs a baseline from the first traffic; every "
                        "publish re-arms it")
    p.add_argument("--drift_window", type=int, default=128,
                   help="drift detection window (verdicts per tenant)")
    p.add_argument("--drift_baseline", type=int, default=64,
                   help="verdicts that form the calibration baseline after (re-)arming")
    p.add_argument("--drift_band", type=float, default=4.0,
                   help="alert band width in standard errors of the window mean "
                        "(CRITICAL at 2x)")
    p.add_argument("--chaos", default="",
                   help="chaos plan: POINT@AT[*COUNT][:ARG] directives, e.g. "
                        "'serve.execute_raise@0*3:default' (obs/chaos.py); '' = off")
    fleet = p.add_argument_group("fleet mode (fleet/)")
    fleet.add_argument("--replicas", type=int, default=1,
                       help="run this many in-process engine replicas behind the fleet "
                            "router (rendezvous placement, fleet-level shed fairness, "
                            "replica breaker/failover, fan-out publish); 1 = one engine")
    fleet.add_argument("--router", action="store_true",
                       help="route through the fleet router even with --replicas 1")
    fleet.add_argument("--tier_spread", type=int, default=None, dest="geometry_tier_spread",
                       help="concentrate each N-tier's tenants onto this many rendezvous "
                            "home replicas (0 = tier-blind; default: the checkpoint config)")
    fleet.add_argument("--journal", default=None, metavar="DIR",
                       help="write-ahead-log every control-plane op to DIR and, when it "
                            "already holds records, recover the tenant directory and the "
                            "committed params_version from it at start")
    fleet.add_argument("--journal_fsync", default="commit", choices=["always", "commit", "off"],
                       help="journal fsync policy: every append / committed publishes and "
                            "compactions only / left to the OS")
    fleet.add_argument("--journal_compact_every", type=int, default=512,
                       help="fold the WAL into snapshot.json past this many records "
                            "(0 = manual compaction only)")
    fleet.add_argument("--autoscale", action="store_true",
                       help="arm the SLO-driven autoscaler (occupancy/shed/burn band with "
                            "hysteresis and cool-down; journaled scale-out and drain-in)")
    fleet.add_argument("--autoscale_min", type=int, default=1,
                       help="autoscaler floor (replicas)")
    fleet.add_argument("--autoscale_max", type=int, default=4,
                       help="autoscaler ceiling (replicas)")
    fleet.add_argument("--autoscale_interval_s", type=float, default=5.0,
                       help="seconds between autoscaler ticks")
    fleet.add_argument("--standby", action="store_true",
                       help="hot standby: tail the --journal WAL read-only, then promote "
                            "(lease takeover fencing the old primary, final replay, fleet "
                            "rebuild) and serve; with --control_socket promotion waits for "
                            "{\"op\": \"promote\"}")
    fleet.add_argument("--standby_poll_s", type=float, default=0.5,
                       help="seconds between standby WAL tail polls")
    fleet.add_argument("--control_socket", default=None, metavar="PATH",
                       help="serve operator commands on this unix socket (JSON lines): "
                            "drain / forgive / revive / retire / stats (fleet), status / "
                            "promote (standby)")
    fleet.add_argument("--send", default=None, metavar="JSON",
                       help="client mode: send one JSON command (e.g. '{\"op\": \"drain\", "
                            "\"replica\": \"r01\"}') to --control_socket, print the reply, "
                            "exit")
    adapt = p.add_argument_group("self-healing adaptation (obs/adapt.py)")
    adapt.add_argument("--adapt", action="store_true",
                       help="arm the drift-triggered adaptation controller: a drift CRITICAL "
                            "starts a bounded mixture-ramp fine-tune from the served "
                            "checkpoint, canary-gated, published through the (fan-out) "
                            "hot-swap with automatic rollback; needs --drift")
    adapt.add_argument("--adapt_mixture", default=None, metavar="FILE",
                       help="FewRel-schema JSON of the target-domain corpus the fine-tune "
                            "ramps in; required with --adapt and --support_file (the demo "
                            "path uses a synthetic shifted twin)")
    adapt.add_argument("--adapt_retries", type=int, default=None,
                       help="failed adaptation loops before the permanent adapt_exhausted "
                            "CRITICAL + quarantine")
    adapt.add_argument("--adapt_backoff_s", type=float, default=None,
                       help="base retry backoff seconds (doubles per failure)")
    adapt.add_argument("--adapt_cooldown_s", type=float, default=None,
                       help="post-success trigger suppression seconds")
    adapt.add_argument("--adapt_step_budget", type=int, default=None,
                       help="fine-tune optimizer-step budget")
    adapt.add_argument("--adapt_wall_s", type=float, default=None,
                       help="fine-tune wall-clock budget (a breach kills it and removes the "
                            "candidate)")
    adapt.add_argument("--adapt_verify_s", type=float, default=None,
                       help="post-publish verification window (a drift re-trip inside it "
                            "rolls back to the prior artifact)")
    adapt.add_argument("--adapt_canary", default=None,
                       help="pre-publish canary plan 'leg:floor[,...]' over legs "
                            "in_domain/target/grid_<N>w<K>s (obs/canary.py), or 'off'")
    later = p.add_argument_group("JAX flags refused by name unless at their JAX default")
    for flag, why in {**DEFERRED, **NO_COUNTERPART}.items():
        why = f"not ported yet: {why}" if flag in DEFERRED else f"no counterpart: {why}"
        if flag in _FLAGS:
            later.add_argument(flag, action="store_true", help=why)
        else:
            later.add_argument(flag, type=_TYPES.get(flag, str),
                               default=_NEUTRAL.get(flag, (None,))[0], help=why)
    return p


def refuse_deferred(parser: argparse.ArgumentParser, args) -> None:
    """Exit (rc 2) naming the first refused JAX flag that was given with
    anything but its default."""
    for flag, why in {**DEFERRED, **NO_COUNTERPART}.items():
        value = getattr(args, flag[2:])
        neutral = (False,) if flag in _FLAGS else _NEUTRAL.get(flag, (None,))
        if value in neutral:
            continue
        if flag in DEFERRED:
            parser.error(f"{flag} is not ported yet: it comes with {why}")
        parser.error(f"{flag} {value} has no counterpart here: {why}")


def _build_breaker(args):
    if args.breaker_threshold <= 0:
        return None
    from induction_network_on_fewrel_tpu_torch.serving.breaker import CircuitBreaker

    return CircuitBreaker(failure_threshold=args.breaker_threshold,
                          open_s=args.breaker_open_s)


def _engine_kwargs(args, buckets, logger, breaker, obs=None, trace_sample=None) -> dict:
    """The engine's keyword arguments from the flags; a fleet replica
    passes ``trace_sample=0.0`` (the router head-samples and hands the
    context across the hop)."""
    if trace_sample is None:
        trace_sample = getattr(args, "trace_sample", 0.0)
    return dict(
        k=args.K, buckets=buckets, max_queue_depth=args.queue_depth,
        batch_window_s=args.batch_window_ms / 1e3, default_deadline_s=args.deadline_ms / 1e3,
        scheduler=args.scheduler, tenant_share=args.tenant_share, logger=logger,
        breaker=breaker, resident_dtype=args.resident_dtype,
        quant_probe_every=args.quant_probe_every, geometry_tiers=args.geometry_tiers,
        trace_sample=trace_sample, dp=getattr(args, "dp", None), **(obs or {}),
    )


def serve_telemetry(args, logger) -> tuple[dict, object, object]:
    """({watchdog, slo, drift} for the engine, the flight recorder or None,
    the diagnostics capture or None) from the telemetry flags (the JAX
    ``serving/cli.py:591-660``); installs a ``--chaos`` plan."""
    from induction_network_on_fewrel_tpu_torch import obs

    recorder = capture = watchdog = slo = drift = None
    if args.watchdog or args.slo_latency_ms is not None or args.drift:
        recorder = obs.FlightRecorder(out_dir=args.run_dir)
        recorder.install_sigterm_handler()
        if logger is not None:
            logger.add_hook(recorder.record_metric)
    if args.watchdog:
        watchdog = obs.HealthWatchdog(logger=logger, recorder=recorder)
    if args.slo_latency_ms is not None or args.drift:
        capture = obs.DiagnosticsCapture(args.run_dir or ".", recorder=recorder,
                                         profile=args.slo_profile)
    if args.slo_latency_ms is not None:
        slo = obs.SLOEngine(obs.SLOObjective(availability=args.slo_availability,
                                             latency_ms=args.slo_latency_ms),
                            fast_window_s=args.slo_fast_s, slow_window_s=args.slo_slow_s,
                            logger=logger, recorder=recorder, capture=capture)
    if args.drift:
        drift = obs.DriftDetector(window=args.drift_window, baseline_n=args.drift_baseline,
                                  band_sigma=args.drift_band, logger=logger, recorder=recorder,
                                  capture=capture)
    if watchdog is not None and capture is not None:
        watchdog.capture = capture
    if args.chaos:
        reg = obs.ChaosRegistry.parse(args.chaos, logger=logger)
        if reg is not None:
            reg.install()
            print(f"chaos plan armed: {args.chaos}", file=sys.stderr)
    return {"watchdog": watchdog, "slo": slo, "drift": drift}, recorder, capture


def write_prometheus(run_dir) -> None:
    """The shared counter registry's Prometheus text as ``metrics.prom``
    (before the engine's close unbinds its gauges)."""
    from induction_network_on_fewrel_tpu_torch.obs import get_registry

    Path(run_dir, "metrics.prom").write_text(get_registry().to_prometheus())


def _build_engine(args, buckets, logger=None, breaker=None, obs=None, trace_sample=None):
    """The one home of the CLI's engine construction, for one engine and
    for each fleet replica: a checkpoint, or fresh-init synthetic
    weights."""
    from induction_network_on_fewrel_tpu_torch.config import resolve_geometry_policy
    from induction_network_on_fewrel_tpu_torch.serving.engine import InferenceEngine

    resolve_geometry_policy(args)       # validates --geometry_tiers
    if args.load_ckpt:
        return InferenceEngine.from_checkpoint(
            args.load_ckpt, device=args.device, glove=args.glove, glove_mat=args.glove_mat,
            lstm_backend=args.lstm_backend, attn_backend=args.attn_backend,
            **_engine_kwargs(args, buckets, logger, breaker, obs, trace_sample),
        )
    from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig

    cfg = ExperimentConfig(k=args.K, vocab_size=FRESH_VOCAB, seed=args.seed)
    cfg = cfg.replace(**{k: v for k, v in (("lstm_backend", args.lstm_backend),
                                           ("attn_backend", args.attn_backend)) if v is not None})
    print("no --load_ckpt: serving FRESH-INIT synthetic weights (demo only)", file=sys.stderr)
    return _fresh_engine(cfg, args.device,
                         **_engine_kwargs(args, buckets, logger, breaker, obs, trace_sample))


# The fresh-weight demos' vocabulary: 2000 synthetic words + UNK/BLANK.
FRESH_VOCAB = 2002


def _fresh_engine(cfg, device=None, **engine_kwargs):
    """An engine on fresh-init weights of ``cfg`` over the synthetic
    vocabulary (no checkpoint): both demos' model."""
    from induction_network_on_fewrel_tpu_torch.data import GloveTokenizer, make_synthetic_glove
    from induction_network_on_fewrel_tpu_torch.models.build import build_model
    from induction_network_on_fewrel_tpu_torch.serving.engine import InferenceEngine

    vocab = make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim)
    tok = GloveTokenizer(vocab, max_length=cfg.max_length)
    model = build_model(cfg, glove_init=vocab.vectors, device=device)
    return InferenceEngine(model, cfg, tok, device=device, **engine_kwargs)


def _support_dataset(args, cfg_k: int, seed: int = 0):
    from induction_network_on_fewrel_tpu_torch.data import load_fewrel_json, make_synthetic_fewrel

    if args.support_file:
        return load_fewrel_json(args.support_file)
    return make_synthetic_fewrel(num_relations=10, instances_per_relation=max(cfg_k + 10, 20),
                                 vocab_size=FRESH_VOCAB - 2, seed=seed)


def _demo(submit, ds, names, k: int, num_queries: int, seed: int = 0) -> None:
    """Classify held-out instances of the registered corpus (those after
    the K supports) through ``submit`` and print one verdict line each."""
    from induction_network_on_fewrel_tpu_torch.serving.batcher import Saturated

    rng = np.random.default_rng(seed)
    registered = set(names)
    pool = [(rel, inst) for rel in ds.rel_names if rel in registered
            for inst in ds.instances[rel][k:]]
    if not pool:
        pool = [(rel, ds.instances[rel][0]) for rel in registered]
    futures = []
    shed = 0
    for i in rng.choice(len(pool), size=min(num_queries, len(pool)), replace=False):
        rel, inst = pool[int(i)]
        try:
            futures.append((rel, submit(inst)))
        except Saturated as e:
            shed += 1
            print(json.dumps({"true": rel, "shed": True, "retry_after_s": e.retry_after_s}),
                  flush=True)
    hits = errors = 0
    for true_rel, fut in futures:
        try:
            verdict = fut.result(timeout=30.0)
        except Exception as e:  # noqa: BLE001 — typed ExecuteError et al.
            errors += 1
            print(json.dumps({"true": true_rel, "error": f"{type(e).__name__}: {e}"}),
                  flush=True)
            continue
        hits += verdict["label"] == true_rel
        print(json.dumps({"true": true_rel, **verdict}), flush=True)
    tail = "".join([f", {shed} shed" if shed else "", f", {errors} errors" if errors else ""])
    print(f"demo accuracy: {hits}/{len(futures)}{tail}", file=sys.stderr)


def _adapt_target_dataset(args, k: int):
    """The target-domain corpus the adaptation fine-tune ramps in:
    ``--adapt_mixture`` when given; the demo path (synthetic supports)
    falls back to the synthetic shifted twin (the same relations with the
    trigger signal moved to a disjoint vocabulary block). A real
    ``--support_file`` without ``--adapt_mixture`` is refused: the CLI
    does not invent a target corpus."""
    from induction_network_on_fewrel_tpu_torch.data import (
        load_fewrel_json,
        make_domain_shifted_fewrel,
    )

    if args.adapt_mixture:
        return load_fewrel_json(args.adapt_mixture)
    if args.support_file:
        raise SystemExit(
            "--adapt with --support_file needs --adapt_mixture (the target-domain corpus "
            "the mixture-ramp fine-tune adapts toward); only the synthetic demo path can "
            "derive one"
        )
    return make_domain_shifted_fewrel(
        num_relations=10, instances_per_relation=max(k + 10, 20),
        vocab_size=FRESH_VOCAB - 2, shift=1.0, seed=args.seed,
    )


def _save_base_checkpoint(engine, out_dir: str) -> str:
    """Demo path: the served fresh-init weights (and fresh optimizer
    moments) saved through the real ``CheckpointManager``, so the
    adaptation loop has a live artifact to fine-tune from and roll back
    to (a ``--load_ckpt`` deployment uses the served directory itself).
    The directory is derived state: a restart rebuilds it."""
    import shutil

    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager
    from induction_network_on_fewrel_tpu_torch.train.steps import make_optimizer

    model = engine.registry.model
    shutil.rmtree(out_dir, ignore_errors=True)
    mngr = CheckpointManager(out_dir, engine.cfg, stage="off")
    try:
        mngr.save(0, model, make_optimizer(engine.cfg, model), val_accuracy=0.0)
        mngr.wait()
    finally:
        mngr.close()
    return out_dir


def _build_adapt(args, policy, *, drift, engine, src_ds, tgt_ds, base_ckpt, publish_fn,
                 quarantine_fn, logger=None, recorder=None, capture=None, journal=None):
    """The ``AdaptationController`` over the serving context: the
    fine-tune reads the live artifact and the two corpora on the serving
    card, the canary is ``obs/canary.run_canary`` over the legs the plan
    floors (on a model of its own, built per candidate), publish goes
    through the caller's (fan-out) publish, and rollback republishes what
    was live before."""
    import tempfile

    from induction_network_on_fewrel_tpu_torch.obs.adapt import (
        AdaptationController,
        make_checkpoint_loop,
    )

    cfg, tok, device = engine.cfg, engine.tokenizer, engine.model.device
    work = tempfile.mkdtemp(prefix="adapt_candidates_")

    def finetune(src_ckpt, out, seq, attempt, step_budget, wall_budget_s):
        from induction_network_on_fewrel_tpu_torch.train.finetune import mixture_finetune

        return mixture_finetune(
            src_ckpt, out, src_ds, tgt_ds, tok,
            steps=step_budget, wall_budget_s=wall_budget_s,
            seed=args.seed + seq, logger=logger, device=device,
        )

    train_fn, publish, cleanup, current_fn = make_checkpoint_loop(
        base_ckpt, work, finetune, publish_fn,
    )
    canary_fn = None
    floors = policy["canary_floors"]
    if floors:
        # Fail fast at start on a plan naming a leg this deployment does not
        # wire: it would fail every candidate at the first drift CRITICAL.
        from induction_network_on_fewrel_tpu_torch.serving.geometry import parse_grid_key

        legs = {"in_domain": src_ds, "target": tgt_ds}
        for name in floors:
            g = parse_grid_key(name) if name.startswith("grid_") else None
            if g is None:
                continue
            if g[0] > len(src_ds.rel_names):
                raise SystemExit(
                    f"--adapt_canary leg {name!r} needs {g[0]} relations but the in-domain "
                    f"corpus has {len(src_ds.rel_names)}"
                )
            legs[name] = src_ds
        unknown = sorted(set(floors) - set(legs))
        if unknown:
            raise SystemExit(
                f"--adapt_canary names unknown leg(s) {unknown}: this deployment wires legs "
                f"{sorted(legs)} plus grid_<N>w<K>s geometry legs"
            )
        # Only the floored legs: a floorless leg is recorded, not judged.
        legs = {k: v for k, v in legs.items() if k in floors}

        def canary_fn(candidate):
            import gc

            from induction_network_on_fewrel_tpu_torch.models.build import build_model
            from induction_network_on_fewrel_tpu_torch.obs.canary import run_canary
            from induction_network_on_fewrel_tpu_torch.serving.registry import load_params

            try:
                return run_canary(build_model(cfg, device=device), load_params(candidate), cfg,
                                  tok, legs=legs, floors=floors, seed=args.seed)
            finally:
                gc.collect()

    return AdaptationController(
        train_fn, canary_fn, publish,
        drift=drift, current_fn=current_fn,
        cleanup_fn=cleanup, quarantine_fn=quarantine_fn,
        retry_budget=policy["retry_budget"],
        backoff_s=policy["backoff_s"],
        cooldown_s=policy["cooldown_s"],
        verify_window_s=policy["verify_window_s"],
        step_budget=policy["step_budget"],
        wall_budget_s=policy["wall_budget_s"],
        logger=logger, recorder=recorder, capture=capture,
        journal=journal,
    )


def _arm_adapt(args, engine, ds, obs, recorder, capture, logger, publish_fn, quarantine_fn,
               journal=None):
    """The adaptation controller over ``engine``'s context (the first
    replica's in fleet mode) and its policy: the flags, then the served
    checkpoint's stamped policy, then the defaults."""
    import os

    from induction_network_on_fewrel_tpu_torch.config import resolve_adapt_policy
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager

    base = CheckpointManager.load_config(args.load_ckpt) if args.load_ckpt else engine.cfg
    policy = resolve_adapt_policy(args, base=base)
    tgt_ds = _adapt_target_dataset(args, engine.registry.k)
    base_ckpt = args.load_ckpt or _save_base_checkpoint(
        engine, os.path.join(args.run_dir or ".", "adapt_base_ckpt"))
    adapt = _build_adapt(
        args, policy, drift=obs["drift"], engine=engine, src_ds=ds, tgt_ds=tgt_ds,
        base_ckpt=base_ckpt, publish_fn=publish_fn, quarantine_fn=quarantine_fn,
        logger=logger, recorder=recorder, capture=capture, journal=journal,
    )
    return adapt, policy


def _answer_input(args, answer) -> None:
    """One verdict line per JSON-lines query of ``--input``."""
    stream = sys.stdin if args.input == "-" else open(args.input)
    try:
        for line in stream:
            line = line.strip()
            if line:
                print(json.dumps(answer(json.loads(line))), flush=True)
    finally:
        if stream is not sys.stdin:
            stream.close()


def serve_main(argv=None) -> int:
    from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

    parser = build_serve_arg_parser()
    args = parser.parse_args(argv)
    refuse_deferred(parser, args)
    if args.dp is not None and args.dp > 1:
        from induction_network_on_fewrel_tpu_torch.serving.buckets import make_serving_mesh

        try:
            make_serving_mesh(args.dp)
        except ValueError as e:
            parser.error(f"--dp {args.dp}: {e}")
    if args.adapt and not args.drift:
        parser.error("--adapt needs --drift (the controller subscribes to the drift "
                     "detector's CRITICALs)")
    if args.send is not None:
        if not args.control_socket:
            parser.error("--send needs --control_socket (the server address to talk to)")
        return _control_send(args.control_socket, args.send)
    if args.standby and not args.journal:
        parser.error("--standby needs --journal (the WAL directory to tail)")
    fleet = args.replicas > 1 or args.router
    if args.autoscale and not fleet:
        parser.error("--autoscale needs fleet mode (--router or --replicas > 1)")
    buckets = tuple(int(b) for b in args.buckets.split(","))
    logger = MetricsLogger(args.run_dir, quiet=True) if args.run_dir else None
    if logger is not None:
        logger.set_identity("standby" if args.standby else "router" if fleet else "serve")
    obs, recorder, capture = serve_telemetry(args, logger)
    if args.standby or fleet:
        try:
            run = _serve_standby if args.standby else _serve_fleet
            return run(args, buckets, logger=logger, obs=obs, recorder=recorder,
                       capture=capture)
        finally:
            _close_telemetry(recorder)
    try:
        engine = _build_engine(args, buckets, logger=logger, breaker=_build_breaker(args),
                               obs=obs)
    except BaseException:
        _close_telemetry(recorder)
        raise
    adapt = None
    try:
        ds = _support_dataset(args, engine.registry.k, seed=args.seed)
        names = engine.register_dataset(ds, max_classes=args.max_classes)
        if args.nota_threshold is not None:
            engine.set_nota_threshold(args.nota_threshold)
        print(f"registered {len(names)} classes x {engine.registry.k} shots "
              f"(scheduler={args.scheduler})", file=sys.stderr)
        compiled = engine.warmup()
        print(f"warmup: {compiled} query programs ({engine.programs.captures} CUDA graphs) "
              f"(buckets={list(engine.batcher.buckets)})", file=sys.stderr)
        if args.adapt:
            adapt, policy = _arm_adapt(
                args, engine, ds, obs, recorder, capture, logger,
                publish_fn=engine.publish_checkpoint,
                quarantine_fn=lambda t, reason="": engine.quarantine_tenant(t, reason=reason))
            adapt.start()
            print(f"adaptation controller armed (retries={policy['retry_budget']}, "
                  f"step_budget={policy['step_budget']})", file=sys.stderr)
        if args.input:
            _answer_input(args, engine.classify)
        else:
            _demo(engine.submit, ds, list(engine.class_names), engine.registry.k,
                  args.demo_queries, seed=args.seed)
        snap = engine.stats.snapshot(queue_depth=engine.batcher.queue_depth)
        print("serve stats: " + json.dumps(snap), file=sys.stderr)
        return 0
    finally:
        try:
            if args.run_dir:
                write_prometheus(args.run_dir)
            if adapt is not None:
                adapt.close()
            engine.close()
            if logger is not None:
                logger.close()
        finally:
            _close_telemetry(recorder)


def _start_control_server(path: str, handlers: dict, stop_evt):
    """The operator's command channel: a unix-socket JSON-lines server.
    One request line in, one ``{"ok": bool, ...}`` line out; every
    mutating handler goes through the journaled ``FleetControl`` ops, so
    ``drain r01`` from the CLI leaves the same audit trail as the
    in-process call. The thread ends when ``stop_evt`` is set."""
    import os
    import socket
    import threading

    if os.path.exists(path):
        os.unlink(path)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(4)
    srv.settimeout(0.25)

    def run():
        try:
            while not stop_evt.is_set():
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                with conn:
                    f = conn.makefile("rwb")
                    line = f.readline()
                    if not line:
                        continue
                    try:
                        req = json.loads(line)
                        fn = handlers.get(req.get("op"))
                        if fn is None:
                            resp = {"ok": False, "error": (f"unknown op {req.get('op')!r} "
                                                           f"(known: {sorted(handlers)})")}
                        else:
                            resp = {"ok": True, "result": fn(req)}
                    except Exception as e:  # noqa: BLE001 — reported to the client
                        resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                    f.write((json.dumps(resp) + "\n").encode())
                    f.flush()
        finally:
            srv.close()
            try:
                os.unlink(path)
            except OSError:
                pass

    t = threading.Thread(target=run, name="fleet-control-socket", daemon=True)
    t.start()
    return t


def _control_send(path: str, payload: str) -> int:
    """``--send`` client: one command to a ``--control_socket`` server."""
    import socket

    req = json.loads(payload)
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(path)
        s.sendall((json.dumps(req) + "\n").encode())
        line = s.makefile("rb").readline()
    print(line.decode().strip())
    return 0 if json.loads(line).get("ok") else 1


def _fleet_breaker(args):
    from induction_network_on_fewrel_tpu_torch.serving.breaker import CircuitBreaker

    return CircuitBreaker(failure_threshold=3, open_s=args.breaker_open_s)


def _serve_demo(args, router, ds, names, k: int) -> None:
    _demo(lambda inst: router.submit(inst, args.deadline_ms / 1e3, tenant="default"),
          ds, names, k, args.demo_queries, seed=args.seed)


def _serve_standby(args, buckets, logger=None, obs=None, recorder=None, capture=None) -> int:
    """Hot-standby mode: tail the primary's WAL read-only, then promote
    (lease takeover fencing the old primary's appends, final catch-up
    replay, fleet rebuild and warm-up from the tailed state) and serve.
    With ``--control_socket`` the tail loop runs until a ``{"op":
    "promote"}`` command arrives; without one, promotion follows the
    initial catch-up. Replica handles are rebuilt in-process from the
    journaled membership."""
    import threading

    from induction_network_on_fewrel_tpu_torch.fleet import HotStandby, InProcessReplica

    standby = HotStandby(args.journal, logger=logger)
    standby.poll()
    print(f"standby: tailing {args.journal} — {standby.applied} op(s) applied, "
          f"{len(standby.tenants())} tenant(s)", file=sys.stderr)
    promote_evt = threading.Event()
    stop_evt = threading.Event()
    router = None
    try:
        if args.control_socket:
            _start_control_server(args.control_socket, {
                "status": lambda req: {"applied": standby.applied,
                                       "tenants": len(standby.tenants()),
                                       "promoted": standby.promoted},
                "promote": lambda req: (promote_evt.set(), {"promoting": True})[1],
            }, stop_evt)
            while not promote_evt.wait(args.standby_poll_s):
                standby.poll()

        def mk_engine():
            return _build_engine(args, buckets, logger=logger, breaker=_build_breaker(args),
                                 obs=obs, trace_sample=0.0)

        handles = {rid: InProcessReplica(rid, mk_engine())
                   for rid in sorted(standby.state.replicas)}
        if not handles:
            print("standby: the journal names no replicas — nothing to promote",
                  file=sys.stderr)
            return 1
        summary = standby.promote(handles, breaker=_fleet_breaker(args),
                                  queue_capacity_per_replica=args.queue_depth,
                                  trace_sample=args.trace_sample)
        router = standby.router
        router.bind_registry()
        print(f"standby: PROMOTED in {summary['promote_s']:.3f}s — {summary['tenants']} "
              f"tenant(s), reregistered {summary['reregistered']}, caught up "
              f"{summary['caught_up']} replica(s) to v{summary['params_version']} (lease "
              f"epoch {summary['lease_epoch']})", file=sys.stderr)
        if args.input:
            _answer_input(args, lambda q: router.classify(q, args.deadline_ms / 1e3,
                                                          tenant="default"))
        else:
            entry = router.directory.get("default")
            if entry is not None and entry.source is not None:
                names = list(entry.source.rel_names)
                if entry.max_classes is not None:
                    names = names[: entry.max_classes]
                k = handles[sorted(handles)[0]].engine.registry.k
                _serve_demo(args, router, entry.source, names, k)
        router.emit_stats()
        print("standby stats: " + json.dumps(router.snapshot()), file=sys.stderr)
        return 0
    finally:
        stop_evt.set()
        if args.run_dir:
            write_prometheus(args.run_dir)
        if router is not None:
            router.close()
        standby.journal.close()
        if logger is not None:
            logger.close()


def _serve_fleet(args, buckets, logger=None, obs=None, recorder=None, capture=None) -> int:
    """Fleet mode: ``--replicas`` in-process engine replicas on one card
    behind the fleet router. The support corpus registers as the
    ``default`` tenant on its rendezvous owner through the control plane;
    queries (``--input`` or the demo batch) route through the router's
    front door, the path a multi-process deployment takes
    (``fleet/transport.py`` swaps the replica handles, nothing else). The
    shared telemetry objects (SLO, drift, watchdog) are keyed by tenant,
    so every replica feeds them."""
    import os
    import threading

    from induction_network_on_fewrel_tpu_torch.config import resolve_geometry_policy
    from induction_network_on_fewrel_tpu_torch.fleet import (
        FleetControl,
        FleetRouter,
        InProcessReplica,
    )

    def mk_engine():
        return _build_engine(args, buckets, logger=logger, breaker=_build_breaker(args),
                             obs=obs, trace_sample=0.0)

    n = max(args.replicas, 1)
    replicas: dict = {}
    try:
        for i in range(n):
            replicas[f"r{i:02d}"] = InProcessReplica(f"r{i:02d}", mk_engine())
    except BaseException:
        for h in replicas.values():
            h.close()
        raise
    first = replicas["r00"].engine
    geometry = resolve_geometry_policy(args, base=first.cfg)
    router = FleetRouter(replicas, logger=logger, breaker=_fleet_breaker(args),
                         queue_capacity_per_replica=args.queue_depth,
                         trace_sample=args.trace_sample,
                         tier_spread=geometry["tier_spread"], tiers=geometry["tiers"])
    router.bind_registry()
    journal = None
    adapt = None
    stop_evt = threading.Event()
    try:
        if args.journal:
            from induction_network_on_fewrel_tpu_torch.fleet import FleetJournal

            journal = FleetJournal(args.journal, fsync=args.journal_fsync,
                                   compact_every=args.journal_compact_every, logger=logger)
            # The single-writer lease: a standby's promotion fences this
            # process (a zombie primary's next append raises).
            epoch = journal.acquire_lease("primary")
            print(f"fleet: journal lease acquired (epoch {epoch})", file=sys.stderr)
        control = FleetControl(router, journal=journal)
        recovered = None
        if journal is not None and journal.seq > 0:
            # Cold-start recovery: the journal is the directory.
            recovered = journal.materialize()
            summary = router.recover(journal, state=recovered)
            print(f"fleet: recovered {summary['tenants']} tenant(s) from {args.journal} "
                  f"(reregistered {summary['reregistered']}, caught up {summary['caught_up']} "
                  f"replica(s) to v{summary['params_version']})", file=sys.stderr)
        entry = router.directory.get("default")
        if entry is None:
            ds = _support_dataset(args, first.registry.k, seed=args.seed)
            owner = control.register_tenant("default", ds, max_classes=args.max_classes,
                                            nota_threshold=args.nota_threshold)
        else:
            # A recovered fleet serves the journaled corpus.
            owner = entry.owner
            ds = (entry.source if entry.source is not None
                  else _support_dataset(args, first.registry.k, seed=args.seed))
        compiled = sum(h.warmup() for h in router.replicas.values())
        print(f"fleet: {n} replica(s), default tenant placed on {owner}, {compiled} query "
              "programs", file=sys.stderr)
        if args.autoscale:
            from induction_network_on_fewrel_tpu_torch.fleet import FleetAutoscaler

            scaler = FleetAutoscaler(control, lambda rid: InProcessReplica(rid, mk_engine()),
                                     slo=obs["slo"], min_replicas=args.autoscale_min,
                                     max_replicas=args.autoscale_max, logger=logger)

            def tick_loop():
                while not stop_evt.wait(args.autoscale_interval_s):
                    try:
                        scaler.tick()
                    except Exception as e:  # noqa: BLE001 — the loop outlives one tick
                        print(f"autoscaler tick failed: {type(e).__name__}: {e}",
                              file=sys.stderr)

            threading.Thread(target=tick_loop, name="fleet-autoscaler", daemon=True).start()
            print(f"autoscaler armed: {args.autoscale_min}..{args.autoscale_max} replicas, "
                  f"tick every {args.autoscale_interval_s}s", file=sys.stderr)
        if args.control_socket:
            def drain(req):
                control.drain_replica(req["replica"])
                return {"replica": req["replica"], "moved": control.replace_tenants()}

            def forgive(req):
                control.forgive_replica(req["replica"])
                return {"replica": req["replica"]}

            def revive(req):
                control.revive_replica(req["replica"], reason="operator")
                return {"replica": req["replica"], "moved": control.replace_tenants()}

            def retire(req):
                control.retire_replica(req["replica"])
                return {"replica": req["replica"], "replicas": len(router.replicas)}

            _start_control_server(args.control_socket, {
                "drain": drain, "forgive": forgive, "revive": revive, "retire": retire,
                "stats": lambda req: router.snapshot(),
            }, stop_evt)
            print(f"control socket listening on {args.control_socket} "
                  "(drain/forgive/revive/retire/stats)", file=sys.stderr)
        if args.adapt:
            # Survivors publish into the live fleet through the
            # all-or-nothing fan-out.
            adapt, policy = _arm_adapt(
                args, first, ds, obs, recorder, capture, logger,
                publish_fn=control.publish_checkpoint,
                quarantine_fn=lambda t, reason="": control.quarantine_tenant(t, reason=reason),
                journal=journal)
            if recovered is not None and recovered.adapt_exhausted:
                # The journaled permanent exhaustion latches survive a restart.
                adapt.restore_exhausted(recovered.adapt_exhausted)
            adapt.start()
            print("adaptation controller armed over the fleet fan-out "
                  f"(retries={policy['retry_budget']})", file=sys.stderr)
        if args.input:
            _answer_input(args, lambda q: router.classify(q, args.deadline_ms / 1e3,
                                                          tenant="default"))
        else:
            names = list(ds.rel_names)
            if args.max_classes is not None:
                names = names[: args.max_classes]
            _serve_demo(args, router, ds, names, first.registry.k)
        router.emit_stats()
        print("fleet stats: " + json.dumps(router.snapshot()), file=sys.stderr)
        return 0
    finally:
        stop_evt.set()
        if args.run_dir:
            write_prometheus(args.run_dir)
        if adapt is not None:
            adapt.close()
        router.close()
        if journal is not None:
            journal.close()
        if logger is not None:
            logger.close()


def _close_telemetry(recorder) -> None:
    """Remove what ``serve_telemetry`` installed process-wide: the chaos
    plan and the recorder's SIGTERM handler."""
    from induction_network_on_fewrel_tpu_torch.obs.chaos import install

    install(None)
    if recorder is not None:
        recorder.uninstall_sigterm_handler()


# --- the fresh-weight demo ---------------------------------------------------


def fresh_engine(N: int, K: int, seed: int, device=None):
    """(engine, support dataset): synthetic vocab + fresh-init weights,
    the first N relations registered at K shots."""
    from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
    from induction_network_on_fewrel_tpu_torch.data import make_synthetic_fewrel

    cfg = ExperimentConfig(n=N, k=K, vocab_size=FRESH_VOCAB, seed=seed)
    engine = _fresh_engine(cfg, device, k=K)
    ds = make_synthetic_fewrel(
        num_relations=max(10, N), instances_per_relation=max(K + 10, 20),
        vocab_size=cfg.vocab_size - 2, seed=seed,
    )
    engine.register_dataset(ds, max_classes=N)
    return engine, ds


def demo(engine, ds, num_queries: int, seed: int = 0) -> list[dict]:
    """Classify held-out instances (after the K supports) of the registered
    relations; print one JSON verdict per line and the accuracy to stderr."""
    rng = np.random.default_rng(seed)
    k = engine.registry.k
    pool = [
        (rel, inst)
        for rel in engine.class_names
        for inst in ds.instances[rel][k:]
    ]
    picks = rng.choice(len(pool), size=min(num_queries, len(pool)), replace=False)
    chosen = [pool[int(i)] for i in picks]
    verdicts = engine.classify_batch([inst for _, inst in chosen])
    hits = 0
    for (rel, _), v in zip(chosen, verdicts):
        hits += v["label"] == rel
        print(json.dumps({"true": rel, **v}), flush=True)
    print(f"demo accuracy: {hits}/{len(chosen)}", file=sys.stderr)
    return verdicts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="fresh-weight serving demo")
    p.add_argument("--N", type=int, default=5, help="relations registered")
    p.add_argument("--K", type=int, default=5, help="support shots per relation")
    p.add_argument("--num_queries", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)
    engine, ds = fresh_engine(args.N, args.K, args.seed, device=args.device)
    try:
        print("serving FRESH-INIT synthetic weights (demo only) on "
              f"{engine.model.device}", file=sys.stderr)
        demo(engine, ds, args.num_queries, seed=args.seed)
    finally:
        engine.close()
    return 0


if __name__ == "__main__":
    argv = sys.argv[1:]
    if argv[:1] == ["demo"]:
        sys.exit(main(argv[1:]))
    sys.exit(serve_main(argv))
