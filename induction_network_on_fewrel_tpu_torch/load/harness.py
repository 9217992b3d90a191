"""The load generator's harness: flags, the synthetic checkpoint, engines,
tenants, the registry-parity gate and the closed/open traffic loops.

The port of the JAX repository's ``tools/loadgen.py:74-730`` on the
port's engine. Multi-tenant closed-loop (C synchronous clients) and
open-loop (Poisson arrivals at a fixed rate) traffic against one
``InferenceEngine``, a continuous-vs-microbatch scheduler A/B, and the
hot-swap drill (a publish fired from a side thread mid-load).

Deltas from the JAX tool:

* ``--device`` takes ``cuda | cpu`` (JAX: ``cpu | tpu``), default
  ``cuda``; without CUDA an entry point refuses to start
  (``require_device``). ``--serving_dp N`` reaches the engine's ``dp``
  (``build_engine``); more than the visible cards exits 2 with the JAX
  "exceeds the visible devices" text (``check_serving_dp``).
* The port's engine holds its weights in its model (the registry's
  parameter banks), not beside it: ``engine_params`` reads the active
  bank's state_dict where the JAX tool passes ``engine.params``.
* Where the JAX dict counts XLA compiles (``warmup_compiles``,
  ``steady_recompiles``) the port counts query programs made: in warmup,
  or after it. On the card a program is one CUDA graph per parameter bank
  (``serving/buckets.py:QueryGraphCache``), reported to
  ``obs/compile.py``'s ``CompileWatcher`` as a ``serve_query`` capture,
  and a kernel is built at its first launch, inside the warmup; so
  ``steady_recompiles`` is the count of captures after warmup.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

import numpy as np

DESCRIPTION = ("Serving load generator: multi-tenant closed/open-loop traffic against the "
               "port's inference engine, with a continuous-vs-microbatch scheduler A/B, a "
               "hot-swap-under-load drill and the burn, drift, chaos, fleet, recovery, "
               "elastic, fleet-obs, adapt, quant and geometry drills")


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m induction_network_on_fewrel_tpu_torch.load",
                                description=DESCRIPTION)
    p.add_argument("--ckpt", default=None,
                   help="port checkpoint dir to serve (default: build a synthetic-data "
                        "checkpoint in a temp dir)")
    p.add_argument("--mode", default="both", choices=["closed", "open", "both"])
    p.add_argument("--scheduler", default="ab", choices=["continuous", "microbatch", "ab"],
                   help="which scheduler to drive; 'ab' runs the same load under both")
    p.add_argument("--tenants", type=int, default=2,
                   help="registered tenants, each with its own synthetic relation set")
    p.add_argument("--swap_drill", action="store_true",
                   help="publish a new params version mid-load; zero dropped queries and "
                        "zero captures after warmup")
    p.add_argument("--artifact", default=None, metavar="PATH",
                   help="write the generator's report here")
    p.add_argument("--concurrency", type=int, default=4, help="closed-loop client threads")
    p.add_argument("--rate", type=float, default=200.0,
                   help="open-loop offered rate (queries/s, all tenants)")
    p.add_argument("--duration", type=float, default=5.0, help="seconds per load phase")
    p.add_argument("--N", type=int, default=5, help="classes per tenant")
    p.add_argument("--K", type=int, default=5, help="shots per class")
    p.add_argument("--na_rate", type=int, default=0,
                   help="train-config NOTA rate of the synthetic checkpoint (>0: NOTA head)")
    p.add_argument("--buckets", default="1,2,4,8,16")
    p.add_argument("--queue_depth", type=int, default=64)
    p.add_argument("--tenant_share", type=float, default=0.5)
    p.add_argument("--deadline_ms", type=float, default=1000.0)
    p.add_argument("--batch_window_ms", type=float, default=2.0)
    p.add_argument("--serving_dp", type=int, default=None,
                   help="dp-shard query scoring over this many cards")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="default: the GPU (refuses to start without CUDA)")
    p.add_argument("--run_dir", default=None,
                   help="telemetry dir: metrics.jsonl, flight dumps and SLO captures")
    p.add_argument("--trace_sample", type=float, default=0.1,
                   help="request-trace head-sampling rate (0 = off)")
    p.add_argument("--slo_latency_ms", type=float, default=None,
                   help="per-request latency objective (the burn drill derives one from "
                        "the measured p50 when unset)")
    p.add_argument("--slo_availability", type=float, default=0.99)
    p.add_argument("--slo_fast_s", type=float, default=3.0, help="fast burn window seconds")
    p.add_argument("--slo_slow_s", type=float, default=30.0, help="slow burn window seconds")
    p.add_argument("--burn_drill", action="store_true",
                   help="overload phase per arm: the fast window trips a once-latched "
                        "CRITICAL with diagnostics captured (requires --run_dir)")
    p.add_argument("--drift_drill", action="store_true",
                   help="model-quality phase on its own engine: a calibrated NOTA floor, an "
                        "out-of-vocabulary shift trips a once-latched CRITICAL, a publish "
                        "re-arms the baseline (requires --run_dir)")
    p.add_argument("--chaos_drill", action="store_true",
                   help="fault-domain drill: execute faults, a poisoned publish, a "
                        "corrupted ring slot (requires --run_dir)")
    p.add_argument("--chaos_artifact", default=None, metavar="PATH")
    p.add_argument("--adapt_drill", action="store_true",
                   help="self-healing adaptation drill, both arms (requires --run_dir)")
    p.add_argument("--adapt_artifact", default=None, metavar="PATH")
    p.add_argument("--fleet", type=int, default=0, metavar="R",
                   help="fleet soak mode: R in-process replicas behind the router "
                        "(0 = off)")
    p.add_argument("--fleet_artifact", default=None, metavar="PATH")
    p.add_argument("--recovery_drill", action="store_true",
                   help="durable-control-plane drill on its own journaled fleet")
    p.add_argument("--recovery_artifact", default=None, metavar="PATH")
    p.add_argument("--elastic_drill", action="store_true",
                   help="elasticity drill: scale-out, drain-in, standby promotion")
    p.add_argument("--elastic_artifact", default=None, metavar="PATH")
    p.add_argument("--fleet_obs_drill", action="store_true",
                   help="fleet observability drill, laid out under --run_dir as the "
                        "fleet_report convention (requires --run_dir)")
    p.add_argument("--obsfleet_artifact", default=None, metavar="PATH")
    p.add_argument("--quant_ab", action="store_true",
                   help="f32 / bf16 / int8 resident class vectors under the same arrivals")
    p.add_argument("--quant_artifact", default=None, metavar="PATH")
    p.add_argument("--geom_ab", action="store_true",
                   help="N-tier bucketed vs exact-N resident stacks, with the scenario grid")
    p.add_argument("--geom_artifact", default=None, metavar="PATH")
    p.add_argument("--slo_profile", action="store_true",
                   help="also take a torch.profiler trace in the SLO auto-capture")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    for flag in ("burn_drill", "drift_drill", "chaos_drill", "adapt_drill"):
        if getattr(args, flag) and not args.run_dir:
            p.error(f"--{flag} needs --run_dir (captures land there)")
    if args.fleet_obs_drill and not args.run_dir:
        p.error("--fleet_obs_drill needs --run_dir (the fleet's multi-stream layout "
                "lands there)")
    return args


def check_serving_dp(args) -> None:
    """Exit 2 when ``--serving_dp`` asks for more cards than are visible
    (the engine's own error, before any checkpoint is built)."""
    if args.serving_dp is not None and args.serving_dp > 1:
        from induction_network_on_fewrel_tpu_torch.serving.buckets import make_serving_mesh

        try:
            make_serving_mesh(args.serving_dp)
        except ValueError as e:
            print(f"error: --serving_dp {args.serving_dp}: {e}", file=sys.stderr)
            raise SystemExit(2) from None


def require_device(device: str | None):
    """The entry points' device rule: None or "cuda" needs CUDA."""
    from induction_network_on_fewrel_tpu_torch.models.build import resolve_device

    return resolve_device(device)


def make_synthetic_checkpoint(args, tmpdir: str, train_iters: int = 0) -> str:
    """Fresh weights (the flagship config at ``--N``/``--K``, a 2 002-word
    table) saved through the port's ``CheckpointManager``, so the engine
    runs the real restore path. ``train_iters > 0`` trains them first on a
    corpus of another seed, so the served verdicts carry real margins (an
    untrained model scores near-ties, whose argmax flips under any numeric
    noise)."""
    from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
    from induction_network_on_fewrel_tpu_torch.data import (
        GloveTokenizer,
        make_synthetic_fewrel,
        make_synthetic_glove,
    )
    from induction_network_on_fewrel_tpu_torch.models.build import build_model
    from induction_network_on_fewrel_tpu_torch.sampling.episodes import EpisodeSampler
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager
    from induction_network_on_fewrel_tpu_torch.train.framework import FewShotTrainer
    from induction_network_on_fewrel_tpu_torch.train.steps import make_optimizer
    from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

    cfg = ExperimentConfig(n=args.N, train_n=args.N, k=args.K, na_rate=args.na_rate,
                           vocab_size=2002, seed=args.seed, val_step=0)
    vocab = make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim)
    model = build_model(cfg, glove_init=vocab.vectors, device=args.device)
    opt, step = None, 0
    if train_iters > 0:
        train_ds = make_synthetic_fewrel(num_relations=max(args.N, 5) * 2,
                                         instances_per_relation=args.K + 10,
                                         vocab_size=2000, seed=args.seed + 9999)
        trainer = FewShotTrainer(
            model, cfg,
            EpisodeSampler(train_ds, GloveTokenizer(vocab, max_length=cfg.max_length),
                           n=cfg.n, k=cfg.k, q=cfg.q, batch_size=cfg.batch_size,
                           na_rate=cfg.na_rate, seed=args.seed + 1),
            logger=MetricsLogger(quiet=True))
        try:
            step = trainer.train(num_iters=train_iters)
            opt = trainer.opt
        finally:
            trainer.close()
    ckpt = os.path.join(tmpdir, "ckpt")
    mngr = CheckpointManager(ckpt, cfg, stage="off")
    try:
        mngr.save(step, model, opt if opt is not None else make_optimizer(cfg, model),
                  val_accuracy=0.0)
        mngr.wait()
    finally:
        mngr.close()
    return ckpt


def build_engine(args, ckpt: str, scheduler: str, logger=None, slo=None, drift=None,
                 breaker=None, resident_dtype=None, quant_probe_every=None,
                 geometry_tiers=None):
    from induction_network_on_fewrel_tpu_torch.serving.engine import InferenceEngine

    return InferenceEngine.from_checkpoint(
        ckpt, device=args.device, k=args.K,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        max_queue_depth=args.queue_depth, batch_window_s=args.batch_window_ms / 1e3,
        default_deadline_s=args.deadline_ms / 1e3, scheduler=scheduler,
        tenant_share=args.tenant_share, dp=args.serving_dp, logger=logger, slo=slo,
        drift=drift, breaker=breaker, trace_sample=args.trace_sample,
        resident_dtype=resident_dtype, quant_probe_every=quant_probe_every,
        geometry_tiers=geometry_tiers,
    )


def build_slo(args, logger=None, recorder=None, capture=None):
    """One SLOEngine per arm (fresh burn windows); the DiagnosticsCapture
    is shared across arms. None when nothing asked for it."""
    if args.slo_latency_ms is None and not args.burn_drill:
        return None
    from induction_network_on_fewrel_tpu_torch.obs import SLOEngine, SLOObjective

    return SLOEngine(
        SLOObjective(availability=args.slo_availability, latency_ms=args.slo_latency_ms),
        fast_window_s=args.slo_fast_s, slow_window_s=args.slo_slow_s,
        logger=logger, recorder=recorder, capture=capture,
    )


def register_tenants(engine, args) -> dict:
    """``--tenants`` synthetic relation sets, one per tenant (distinct
    seeds); returns {tenant: dataset}."""
    from induction_network_on_fewrel_tpu_torch.data import make_synthetic_fewrel

    tenants = {}
    for t in range(max(args.tenants, 1)):
        name = f"tenant{t}"
        ds = make_synthetic_fewrel(num_relations=args.N, instances_per_relation=args.K + 10,
                                   vocab_size=2000, seed=args.seed + 101 * t)
        engine.register_dataset(ds, tenant=name)
        tenants[name] = ds
    return tenants


def engine_params(engine) -> dict:
    """The weights the engine's snapshots score on, as a state_dict copy
    (what a publish of "the engine's own weights" hands the registry)."""
    return {k: v.detach().clone() for k, v in engine.registry.model.state_dict().items()}


def check_registry_parity(engine, ds, tenant: str = "default") -> float:
    """Registry scoring vs the direct episodic forward: one episode of the
    registered supports and held-out queries (one per class, capped at the
    largest bucket) through both paths; max |delta| over the class columns
    (and the NOTA column when the head exists). The served side pads to a
    real bucket, so it replays a warmed program; a quantized tenant is
    checked on its real serving path."""
    import torch

    from induction_network_on_fewrel_tpu_torch.models.base import to_device
    from induction_network_on_fewrel_tpu_torch.serving.buckets import (
        QUERY_DTYPES,
        pad_rows,
        select_bucket,
    )

    k = engine.registry.k
    snap = engine.registry.snapshot(tenant)
    names = list(snap.names)
    tok = engine.tokenizer

    def stack(insts, lead):
        toks = [tok(i) for i in insts]
        return {key: np.stack([getattr(t, key) for t in toks]).astype(dt)
                .reshape((1,) + lead + (-1,)) for key, dt in QUERY_DTYPES.items()}

    qcap = min(len(names), max(engine.batcher.buckets))
    sup = stack([i for r in names for i in (list(ds.instances[r]) * k)[:k]], (len(names), k))
    qry = stack([ds.instances[r][-1] for r in names[:qcap]], (qcap,))
    bucket = select_bucket(qcap, engine.batcher.buckets)
    model = engine.registry.banks[snap.bank]
    with engine._device_scope():
        direct = model(to_device(sup, model.device), to_device(qry, model.device))
        direct = direct.float().cpu().numpy()[0]
        served = engine.programs.run(snap.bank, snap.matrix,
                                     {key: pad_rows(qry[key][0], bucket) for key in qry},
                                     scale=snap.scale)[:qcap]
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    n = len(names)
    served = np.asarray(served, dtype=np.float64)
    if direct.shape[-1] == n:          # no NOTA head
        served = served[:, :n]
    else:                              # [real classes..., NOTA]
        served = np.concatenate([served[:, :n], served[:, -1:]], axis=1)
    return float(np.max(np.abs(direct - served)))


def _pools(tenants: dict, k: int) -> dict:
    """Held-out (post-support) query instances per tenant."""
    return {t: [inst for r in ds.rel_names for inst in ds.instances[r][k:]]
            for t, ds in tenants.items()}


def _by_bucket(by_bucket, verdict: dict, seconds: float) -> None:
    if by_bucket is not None:
        by_bucket.setdefault(int(verdict["bucket"]), []).append(seconds)


def run_closed(engine, pools, concurrency, duration, rng, by_bucket=None):
    """C synchronous workers round-robining tenants; returns per-tenant
    latency lists, the error count, the wall time and per-tenant retries.
    A ``Saturated`` (or ``ExecuteError``) carries ``retry_after_s``: the
    worker sleeps it with seeded jitter (x U[0.75, 1.25), capped at the
    phase's remaining time) instead of resubmitting at once. ``by_bucket``
    (a dict) also collects each latency under its verdict's bucket."""
    names = list(pools)
    lat = {t: [] for t in names}
    retries = {t: 0 for t in names}
    errs = [0]
    stop = time.monotonic() + duration
    lock = threading.Lock()

    def worker(seed):
        r = np.random.default_rng(seed)
        mine = {t: [] for t in names}
        my_retries = {t: 0 for t in names}
        i = seed
        while time.monotonic() < stop:
            tenant = names[i % len(names)]
            i += 1
            pool = pools[tenant]
            inst = pool[int(r.integers(len(pool)))]
            t0 = time.monotonic()
            try:
                v = engine.classify(inst, tenant=tenant)
                mine[tenant].append(time.monotonic() - t0)
                with lock:
                    _by_bucket(by_bucket, v, mine[tenant][-1])
            except Exception as e:  # noqa: BLE001 — counted, load continues
                with lock:
                    errs[0] += 1
                hint = getattr(e, "retry_after_s", None)
                if hint is not None:
                    my_retries[tenant] += 1
                    delay = float(hint) * (0.75 + 0.5 * float(r.random()))
                    time.sleep(max(0.0, min(delay, stop - time.monotonic())))
        with lock:
            for t in names:
                lat[t].extend(mine[t])
                retries[t] += my_retries[t]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(concurrency)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return lat, errs[0], time.monotonic() - t0, retries


def run_open(engine, pools, rate, duration, rng, swap_at=None, swap_fn=None,
             deadline_s=None, by_bucket=None):
    """Poisson arrivals at ``rate``/s round-robining tenants, futures
    collected at the end: saturation shows as ``Saturated`` rejections and
    p99 growth. ``swap_fn`` fires once, from a side thread, after
    ``swap_at`` seconds; ``deadline_s`` overrides the engine default.
    Returns (per-tenant latencies, rejected, deadline misses, dropped,
    wall, offered, swap info); ``by_bucket`` as in ``run_closed``."""
    names = list(pools)
    futures, rejected = [], 0
    lat = {t: [] for t in names}
    start = time.monotonic()
    stop = start + duration
    next_t = start
    i = 0
    swap_info = None
    swap_thread = None
    while time.monotonic() < stop:
        now = time.monotonic()
        if swap_fn is not None and swap_info is None and now - start >= swap_at:
            swap_info = {"at_s": round(now - start, 3),
                         "inflight_at_swap": engine.batcher.queue_depth}

            def _publish(info=swap_info):
                t0 = time.monotonic()
                try:
                    info["params_version"] = swap_fn()
                except Exception as e:  # noqa: BLE001 — the drill reports, never dies
                    info["error"] = repr(e)
                info["publish_s"] = round(time.monotonic() - t0, 4)

            swap_thread = threading.Thread(target=_publish)
            swap_thread.start()
            continue
        if now < next_t:
            time.sleep(min(next_t - now, 0.01))
            continue
        next_t += rng.exponential(1.0 / rate)
        tenant = names[i % len(names)]
        pool = pools[tenant]
        inst = pool[int(rng.integers(len(pool)))]
        try:
            futures.append((tenant, engine.submit(inst, deadline_s=deadline_s, tenant=tenant)))
        except Exception:  # noqa: BLE001 — Saturated backpressure
            rejected += 1
        i += 1
    t_end = time.monotonic()
    if swap_thread is not None:
        swap_thread.join(timeout=60.0)
    deadline_miss = dropped = 0
    for tenant, fut in futures:
        try:
            # The verdict's own latency (enqueue -> verdict), not this
            # post-hoc result() call's.
            v = fut.result(timeout=30.0)
            lat[tenant].append(v["latency_ms"] / 1e3)
            _by_bucket(by_bucket, v, lat[tenant][-1])
        except TimeoutError:  # DeadlineExceeded subclasses TimeoutError
            deadline_miss += 1
        except Exception:  # noqa: BLE001 — anything else is a dropped query
            dropped += 1
    return lat, rejected, deadline_miss, dropped, t_end - start, i, swap_info


def pct(lat, q):
    """The q-th percentile of ``lat`` (seconds) in ms, nearest rank."""
    if not lat:
        return float("nan")
    s = sorted(lat)
    return s[min(len(s) - 1, max(0, int(round(q / 100 * len(s))) - 1))] * 1e3


def pct_ms(lat, q):
    """Report-safe percentile: None (valid JSON) for an empty list."""
    return round(pct(lat, q), 2) if lat else None


def _flat(lat_by_tenant: dict) -> list:
    return [x for lats in lat_by_tenant.values() for x in lats]


def _per_tenant(lat_by_tenant: dict) -> dict:
    return {t: {"served": len(lats), "p50_ms": pct_ms(lats, 50), "p99_ms": pct_ms(lats, 99)}
            for t, lats in sorted(lat_by_tenant.items())}


def drive_one(engine, args, rng, swap_fn=None, by_bucket=None, on_warmup=None) -> dict:
    """The full load sequence against one engine: parity per tenant,
    warmup, the closed and open phases, then the hot-swap drill as an
    open-loop phase of its own (a publish re-distils every slot on the
    same device, so it is kept out of the measured phases). Returns the
    arm's result dict; ``by_bucket`` collects the measured phases'
    latencies per bucket; ``on_warmup()`` is called once the warmup ends."""
    from induction_network_on_fewrel_tpu_torch.load.burn import run_burn_drill

    tenants = register_tenants(engine, args)
    compiled = engine.warmup()
    if on_warmup is not None:
        on_warmup()
    print(f"warmup: {compiled} bucket programs (buckets={list(engine.batcher.buckets)}, "
          f"tenants={len(tenants)}, scheduler={engine.scheduler})", file=sys.stderr)
    parity = {}
    for tenant, ds in tenants.items():
        parity[tenant] = check_registry_parity(engine, ds, tenant=tenant)
        print(f"parity[{tenant}]: registry vs direct forward max|delta| = "
              f"{parity[tenant]:.2e}", file=sys.stderr)
    pools = _pools(tenants, args.K)
    out = {"scheduler": engine.scheduler,
           "parity_max_delta": {t: float(d) for t, d in parity.items()},
           "warmup_compiles": compiled}
    if any(not (d < 1e-4) for d in parity.values()):
        out["parity_ok"] = False
        return out
    out["parity_ok"] = True

    if args.mode in ("closed", "both"):
        lat, errs, wall, retries = run_closed(engine, pools, args.concurrency,
                                              args.duration, rng, by_bucket=by_bucket)
        flat = _flat(lat)
        out["closed"] = {
            "concurrency": args.concurrency, "qps": round(len(flat) / wall, 1),
            "p50_ms": pct_ms(flat, 50), "p99_ms": pct_ms(flat, 99), "errors": errs,
            "retries": sum(retries.values()), "retries_per_tenant": dict(sorted(retries.items())),
            "per_tenant": _per_tenant(lat),
        }
    if args.mode in ("open", "both"):
        lat, rej, miss, dropped, wall, offered, _ = run_open(
            engine, pools, args.rate, args.duration, rng, by_bucket=by_bucket)
        flat = _flat(lat)
        out["open"] = {
            "offered_qps": round(offered / wall, 1), "qps": round(len(flat) / wall, 1),
            "p50_ms": pct_ms(flat, 50), "p99_ms": pct_ms(flat, 99),
            "rejected": rej, "deadline_miss": miss, "dropped": dropped,
            "per_tenant": _per_tenant(lat),
        }
    if swap_fn is not None:
        drill_s = max(2.0, args.duration / 2)
        lat, rej, miss, dropped, wall, offered, swap_info = run_open(
            engine, pools, args.rate, drill_s, rng, swap_at=drill_s / 2, swap_fn=swap_fn)
        flat = _flat(lat)
        swap_info.update({
            "offered_qps": round(offered / wall, 1), "served": len(flat),
            "p50_ms": pct_ms(flat, 50), "p99_ms": pct_ms(flat, 99),
            "rejected": rej, "deadline_miss": miss, "dropped": dropped,
        })
        out["swap_drill"] = swap_info
    out["stats"] = engine.stats.snapshot(queue_depth=engine.batcher.queue_depth)
    out["per_tenant_stats"] = engine.stats.tenant_snapshot()
    out["trace"] = engine.stats.trace_summary()
    if args.burn_drill:
        # Last: the drill overloads the engine on purpose.
        out["burn_drill"] = run_burn_drill(engine, pools, args, rng)
    return out
