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

The JAX flags of later slices (the fleet, ``--dp``, ``--adapt*``) are
parsed and refused by name, with the ROADMAP queue A item that brings
them (``models/build.LATER_ITEMS``, shared with the train CLI), so a JAX
command line is never half-obeyed (``DEFERRED``); so is
``--compile_cache``, which has no counterpart here (``NO_COUNTERPART``).
Each is accepted at its JAX default.

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

from induction_network_on_fewrel_tpu_torch.models.build import LATER_ITEMS

# JAX serving flags of later slices: flag -> the ROADMAP queue A item that
# brings it. A flag given with anything but its JAX default is refused.
FLEET, ADAPT = LATER_ITEMS["fleet"], LATER_ITEMS["adapt"]
DEFERRED = {
    "--dp": LATER_ITEMS["dp"],
    "--tier_spread": FLEET, "--replicas": FLEET, "--router": FLEET, "--journal": FLEET,
    "--journal_fsync": FLEET,
    "--journal_compact_every": FLEET, "--autoscale": FLEET, "--autoscale_min": FLEET,
    "--autoscale_max": FLEET, "--autoscale_interval_s": FLEET, "--standby": FLEET,
    "--standby_poll_s": FLEET, "--control_socket": FLEET, "--send": FLEET,
    "--adapt": ADAPT, "--adapt_mixture": ADAPT, "--adapt_retries": ADAPT,
    "--adapt_backoff_s": ADAPT, "--adapt_cooldown_s": ADAPT, "--adapt_step_budget": ADAPT,
    "--adapt_wall_s": ADAPT, "--adapt_verify_s": ADAPT, "--adapt_canary": ADAPT,
}
# JAX serving flags the port has no counterpart for: flag -> why.
NO_COUNTERPART = {
    "--compile_cache": "the port keeps no XLA compile cache (its kernels build once into "
                       "build/torch_kernels)",
}
# The JAX defaults of the refused flags (and values that mean the same).
_NEUTRAL = {
    "--compile_cache": ("auto", "off"), "--tier_spread": (None, 0),
    "--dp": (None, 1), "--replicas": (1,), "--journal": (None,), "--journal_fsync": ("commit",),
    "--journal_compact_every": (512,), "--autoscale_min": (1,), "--autoscale_max": (4,),
    "--autoscale_interval_s": (5.0,), "--standby_poll_s": (0.5,), "--control_socket": (None,),
    "--send": (None,), "--adapt_mixture": (None,),
}
_FLAGS = {"--router", "--autoscale", "--standby", "--adapt"}
_TYPES = {"--dp": int, "--tier_spread": int, "--replicas": int, "--journal_compact_every": int, "--autoscale_min": int,
          "--autoscale_max": int, "--autoscale_interval_s": float, "--standby_poll_s": float,
          "--adapt_retries": int, "--adapt_backoff_s": float, "--adapt_cooldown_s": float,
          "--adapt_step_budget": int, "--adapt_wall_s": float, "--adapt_verify_s": float}


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


def _engine_kwargs(args, buckets, logger, breaker, obs=None) -> dict:
    return dict(
        k=args.K, buckets=buckets, max_queue_depth=args.queue_depth,
        batch_window_s=args.batch_window_ms / 1e3, default_deadline_s=args.deadline_ms / 1e3,
        scheduler=args.scheduler, tenant_share=args.tenant_share, logger=logger,
        breaker=breaker, resident_dtype=args.resident_dtype,
        quant_probe_every=args.quant_probe_every, geometry_tiers=args.geometry_tiers,
        trace_sample=getattr(args, "trace_sample", 0.0), **(obs or {}),
    )


def serve_telemetry(args, logger) -> tuple[dict, object]:
    """({watchdog, slo, drift} for the engine, the flight recorder or
    None) from the telemetry flags (the JAX ``serving/cli.py:591-660``);
    installs a ``--chaos`` plan."""
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
    return {"watchdog": watchdog, "slo": slo, "drift": drift}, recorder


def write_prometheus(run_dir) -> None:
    """The shared counter registry's Prometheus text as ``metrics.prom``
    (before the engine's close unbinds its gauges)."""
    from induction_network_on_fewrel_tpu_torch.obs import get_registry

    Path(run_dir, "metrics.prom").write_text(get_registry().to_prometheus())


def _build_engine(args, buckets, logger=None, breaker=None, obs=None):
    """The one home of the CLI's engine construction: a checkpoint, or
    fresh-init synthetic weights."""
    from induction_network_on_fewrel_tpu_torch.config import resolve_geometry_policy
    from induction_network_on_fewrel_tpu_torch.serving.engine import InferenceEngine

    resolve_geometry_policy(args)       # validates --geometry_tiers
    if args.load_ckpt:
        return InferenceEngine.from_checkpoint(
            args.load_ckpt, device=args.device, glove=args.glove, glove_mat=args.glove_mat,
            lstm_backend=args.lstm_backend, attn_backend=args.attn_backend,
            **_engine_kwargs(args, buckets, logger, breaker, obs),
        )
    from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig

    cfg = ExperimentConfig(k=args.K, vocab_size=FRESH_VOCAB, seed=args.seed)
    cfg = cfg.replace(**{k: v for k, v in (("lstm_backend", args.lstm_backend),
                                           ("attn_backend", args.attn_backend)) if v is not None})
    print("no --load_ckpt: serving FRESH-INIT synthetic weights (demo only)", file=sys.stderr)
    return _fresh_engine(cfg, args.device, **_engine_kwargs(args, buckets, logger, breaker, obs))


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


def serve_main(argv=None) -> int:
    from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

    parser = build_serve_arg_parser()
    args = parser.parse_args(argv)
    refuse_deferred(parser, args)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    logger = MetricsLogger(args.run_dir, quiet=True) if args.run_dir else None
    if logger is not None:
        logger.set_identity("serve")
    obs, recorder = serve_telemetry(args, logger)
    try:
        engine = _build_engine(args, buckets, logger=logger, breaker=_build_breaker(args),
                               obs=obs)
    except BaseException:
        _close_telemetry(recorder)
        raise
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
        if args.input:
            stream = sys.stdin if args.input == "-" else open(args.input)
            try:
                for line in stream:
                    line = line.strip()
                    if line:
                        print(json.dumps(engine.classify(json.loads(line))), flush=True)
            finally:
                if stream is not sys.stdin:
                    stream.close()
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
            engine.close()
            if logger is not None:
                logger.close()
        finally:
            _close_telemetry(recorder)


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
