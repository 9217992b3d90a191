"""The port's telemetry modules (``obs/``, ``utils/``) vs the JAX package's.

The same inputs, made here, go through the JAX module and the port's copy
on the CPU: the span ring's eviction and parent ids; the watchdog's events
on one record sequence with an injected clock (NaN, throughput drop,
entropy collapse, queue and feed stalls, shed-load, fault criticals);
``to_prometheus()`` byte for byte after the same instrument operations;
chaos plans' parse and firing sequences (and the port's refusal, by name,
of a point whose layer it does not have); ``quality_features`` and the
drift and SLO trip sequences on an injected clock; the capture watcher's
phases and gate against the JAX ``CompileWatcher._observe_compile`` on one
event sequence; ``utils/flops`` and ``utils/roofline`` counts for every zoo
config; the hand-written TensorBoard file read by TensorFlow's summary
iterator against the JAX logger's file from the same records; the flight
recorder's dump; and the port's own pieces with no JAX twin: the
profiler annotations of spans, the diagnostics capture's torch.profiler
trace, the debug finite check.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.obs import chaos as jchaos
from induction_network_on_fewrel_tpu.obs import compile as jcompile
from induction_network_on_fewrel_tpu.obs import drift as jdrift
from induction_network_on_fewrel_tpu.obs import export as jexport
from induction_network_on_fewrel_tpu.obs import health as jhealth
from induction_network_on_fewrel_tpu.obs import perf as jperf
from induction_network_on_fewrel_tpu.obs import recorder as jrecorder
from induction_network_on_fewrel_tpu.obs import spans as jspans
from induction_network_on_fewrel_tpu.utils import flops as jflops
from induction_network_on_fewrel_tpu.utils import metrics as jmetrics
from induction_network_on_fewrel_tpu.utils import roofline as jroofline
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.obs import chaos, compile, drift, export, health
from induction_network_on_fewrel_tpu_torch.obs import perf, recorder, spans
from induction_network_on_fewrel_tpu_torch.utils import debug, flops, metrics, profiling, roofline


class ListLogger:
    """A MetricsLogger stand-in that keeps (step, kind, fields)."""

    def __init__(self):
        self.records = []

    def log(self, step, kind="train", **fields):
        self.records.append((int(step), kind, fields))


# --- spans --------------------------------------------------------------------


def _span_script(mod, tracker):
    """Nested spans, a trace context, fan-in links and ring eviction."""
    with tracker.span("a", x=1):
        with tracker.span("b"):
            pass
        with tracker.span("c", links=("t1", "t2")) as attrs:
            attrs["rows"] = 3
    ctx = mod.TraceContext("trace-1")
    with tracker.trace(ctx):
        with tracker.span("d"):
            with tracker.span("e"):
                pass
    with tracker.trace(mod.TraceContext("trace-1", span_id=ctx.span_id)):
        with tracker.span("worker"):
            pass
    for i in range(3):
        with tracker.span(f"tail{i}"):
            pass
    keep = ("name", "depth", "parent", "span_id", "parent_id", "links", "attrs", "trace_id")
    return ([{k: d.get(k) for k in keep} for d in tracker.snapshot()], tracker.evicted,
            len(tracker), [n for n in ("a", "tail2") if tracker.durations(n)])


def test_span_ring_eviction_and_parent_ids_equal_jax():
    ours = _span_script(spans, spans.SpanTracker(capacity=5))
    theirs = _span_script(jspans, jspans.SpanTracker(capacity=5, xplane_bridge=False))
    assert ours == theirs
    assert ours[1] == 4 and ours[2] == 5          # 9 spans through a ring of 5


def test_trace_sampler_equals_jax_and_rate_zero_allocates_nothing():
    for rate in (0.0, 0.25, 0.5, 1.0, 3.0):
        ours, theirs = spans.TraceSampler(rate), jspans.TraceSampler(rate)
        assert ours.stride == theirs.stride
        assert [ours.maybe_trace() is None for _ in range(9)] == \
            [theirs.maybe_trace() is None for _ in range(9)]
    off = spans.TraceSampler(0.0)
    assert off._count is None and off.maybe_trace() is None


def test_span_tracker_binds_nvtx_to_a_cuda_device_only():
    t = spans.SpanTracker(device="cpu")
    assert t.nvtx is False
    t.bind_device(torch.device("cuda", 0))
    assert t.nvtx is True           # no NVTX call is made until a span opens
    t.bind_device(None)
    assert t.nvtx is False


def test_spans_annotate_a_recording_profiler(tmp_path):
    tracker = spans.SpanTracker()
    with profiling.trace(tmp_path):
        with tracker.span("train/dispatch"):
            torch.ones(4).sum()
        with tracker.span("serve/submit", nvtx=False):
            pass
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())
             ["traceEvents"]}
    assert "train/dispatch" in names and "serve/submit" not in names


# --- perf tiles -------------------------------------------------------------------


def _span_stream(rng, n: int) -> list[tuple]:
    """(name, start_s, dur_s, depth, thread) in the order spans end: the
    loop thread's phases back to back (with nested children), a producer
    thread's spans interleaved."""
    out, t = [], 0.0
    names = list(perf.SEGMENT_OF) + ["untracked"]
    while len(out) < n:
        name = names[rng.integers(len(names))]
        dur = float(rng.uniform(1e-4, 5e-3))
        if rng.random() < 0.3:                   # a child ends first
            out.append(("child", t + dur / 4, dur / 2, 1, "MainThread"))
        out.append((name, t, dur, 0, "MainThread"))
        if rng.random() < 0.5:                   # the producer, appended late
            out.append(("datapipe/produce", t - 0.02, float(rng.uniform(1e-4, 2e-3)), 0, "feed"))
        t += dur + float(rng.uniform(0, 1e-3))
    return out


@pytest.mark.parametrize("capacity", [64, 5000])
def test_perf_window_sums_equal_jax_full_ring_scan(capacity):
    """The port's observer reads a window's spans newest first and stops
    at the loop thread's first span that ended before it; the JAX one
    scans the whole ring. Same sums on one span stream, through a
    wrapped ring and windows that cut spans."""
    stream = _span_stream(np.random.default_rng(0), 400)
    ours, theirs = spans.SpanTracker(capacity=capacity), jspans.SpanTracker(
        capacity=capacity, xplane_bridge=False)
    for i, (name, start, dur, depth, thread) in enumerate(stream):
        ours._append(spans.Span(name, start, dur, depth, None, thread, i + 1))
        theirs._append(jspans.Span(name, start, dur, depth, None, thread, i + 1))
    obs_ours = perf.PerfObserver(tracker=ours)
    obs_theirs = jperf.PerfObserver(tracker=theirs)
    obs_ours._thread = obs_theirs._thread = "MainThread"
    end = max(s + d for _, s, d, _, _ in stream)
    try:
        for w0, w1 in ((0.0, end), (end * 0.3, end * 0.71), (end * 0.9, end), (end * 0.5,
                                                                              end * 0.5001)):
            got, want = obs_ours._segment_sums(w0, w1), obs_theirs._segment_sums(w0, w1)
            assert got.keys() == want.keys()
            for k in got:
                assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-15), (w0, w1, k)
    finally:
        obs_ours.close()
        obs_theirs.close()


# --- the watchdog ---------------------------------------------------------------


WATCHDOG_RECORDS = [
    *({"kind": "train", "step": s, "episodes_per_s": 100.0, "loss": 1.0, "routing_entropy": 0.5}
      for s in range(1, 5)),
    {"kind": "train", "step": 5, "episodes_per_s": 20.0, "loss": 1.0, "routing_entropy": 0.5},
    {"kind": "train", "step": 6, "episodes_per_s": 100.0, "loss": float("nan"),
     "routing_entropy": 0.01},
    {"kind": "train", "step": 7, "episodes_per_s": 100.0, "loss": float("nan"),
     "routing_entropy": 0.01},
    {"kind": "val", "step": 8, "accuracy": float("inf")},
    {"kind": "train", "step": 9, "episodes_per_s": 100.0, "loss": 1.0, "routing_entropy": 0.5},
    {"kind": "serve", "step": 10, "queue_depth": 3.0, "served": 5.0, "shed": 2.0},
    {"kind": "serve", "step": 11, "event": "snapshot_swap", "params_version": 2.0,
     "tenants": 1.0, "slots": 3.0},
    {"kind": "fault", "step": 12, "action": "ckpt_quarantine", "ckpt_kind": "latest",
     "ckpt_step": 12.0, "reason": "digest"},
    {"kind": "fault", "step": 13, "action": "ckpt_quarantine", "ckpt_kind": "latest",
     "ckpt_step": 12.0, "reason": "digest"},
    {"kind": "fault", "step": 14, "action": "breaker", "tenant": "t0", "from": "closed",
     "to": "open", "failures": 3.0},
    {"kind": "fault", "step": 15, "action": "publish_rollback", "reason": "nan",
     "params_version": 1.0},
    {"kind": "data", "step": 16, "produced": 4.0, "consumed": 4.0, "producer_alive": 1.0,
     "poisoned": 1.0},
    {"kind": "health", "step": 17, "event": "grad_probe", "grad_norm": float("nan")},
    {"kind": "perf", "step": 18, "window_s": float("nan")},
]


def _watchdog_trace(mod):
    log = ListLogger()
    wd = mod.HealthWatchdog(logger=log, queue_stall_s=5.0, throughput_warmup=3)
    for rec in WATCHDOG_RECORDS:
        wd.observe_record(dict(rec))
    for t, served in ((0.0, 7), (1.0, 7), (6.5, 7), (7.0, 7), (8.0, 8), (9.0, 8), (20.0, 8)):
        wd.observe_queue(4, served, now=t)
    for t, produced in ((0.0, 4), (1.0, 4), (7.0, 4), (8.0, 4), (9.0, 5)):
        wd.observe_feed(produced, 4, step=30, waiting=True, now=t)
    wd.observe_feed(5, 5, producer_alive=False, step=31)
    return [(e.event, e.severity, e.step) for e in wd.events], wd.tripped, \
        [(s, k, f.get("event")) for s, k, f in log.records]


def test_watchdog_events_equal_jax():
    ours, theirs = _watchdog_trace(health), _watchdog_trace(jhealth)
    assert ours == theirs
    events = {e for e, _, _ in ours[0]}
    assert {"throughput_regression", "non_finite", "routing_collapse", "queue_stall",
            "feed_stall", "feed_dead", "feed_poisoned", "shed_load", "snapshot_swap",
            "ckpt_corrupt", "breaker_open", "publish_rollback"} <= events


# --- export ---------------------------------------------------------------------


def _registry_ops(mod):
    reg = mod.CounterRegistry(prefix="induction")
    reg.counter("steps", help="steps run").inc(3)
    reg.counter("steps").inc(2.5)
    g = reg.gauge("queue_depth")
    g.set(7)
    g.inc(-2)
    reg.gauge_fn("live", lambda: 4.25, help="a pull gauge")
    reg.gauge_fn("dead", lambda: 1 / 0)
    h = reg.histogram("latency_ms", bounds=(1.0, 5.0, 25.0), help="latency")
    for v, ex in ((0.5, "a"), (3.0, None), (4.0, "b"), (100.0, "c"), (26.0, None)):
        h.observe(v, exemplar=ex)
    fam = reg.labeled_gauge("replica_qps", help="per replica")
    fam.set(1.5, replica="r01")
    fam.set(2.0, replica='r"2\n')
    fam.set(3.0, replica="r03")
    fam.remove(replica="r03")
    with pytest.raises(ValueError):
        reg.counter("steps").inc(-1)
    with pytest.raises(ValueError):
        reg.gauge("steps")
    reg.unregister("nothing")
    return reg.to_prometheus(), reg.snapshot()


def test_to_prometheus_byte_equal_to_jax():
    ours, theirs = _registry_ops(export), _registry_ops(jexport)
    assert ours[0] == theirs[0]
    assert ours[1].keys() == theirs[1].keys()
    assert all(ours[1][k] == theirs[1][k] or (math.isnan(ours[1][k]) and math.isnan(theirs[1][k]))
               for k in ours[1])


# --- chaos ----------------------------------------------------------------------


PLAN = ("ckpt.bitflip@1:ring,ckpt.truncate@0*2:ring_delta,ckpt.restore_raise@2,"
        "publish.nan_params@0,publish.distill_raise@1,serve.execute_raise@0*3:t0")
ARRIVALS = ([("ckpt.bitflip", {"kind": "ring", "step": s}) for s in (4, 8, 12)]
            + [("ckpt.truncate", {"kind": k, "step": 3}) for k in ("ring_base", "ring_delta",
                                                                  "ring_delta", "ring_delta")]
            + [("ckpt.restore_raise", {"kind": "best", "step": i}) for i in range(4)]
            + [("publish.nan_params", {"step": 0}), ("publish.nan_params", {"step": 1})]
            + [("publish.distill_raise", {"step": i}) for i in range(3)]
            + [("serve.execute_raise", {"tenant": t, "step": i})
               for i, t in enumerate(("t0", "t1", "t0", "t0", "t0", "t1"))])


def _chaos_trace(mod):
    log = ListLogger()
    reg = mod.ChaosRegistry.parse(PLAN, logger=log).install()
    try:
        fired = [mod.chaos_fire(p, **ctx) is not None for p, ctx in ARRIVALS]
        assert mod.chaos_active()
    finally:
        reg.uninstall()
    assert not mod.chaos_active() and mod.chaos_fire("serve.execute_raise", tenant="t0") is None
    directives = [dataclasses.asdict(d) for d in reg.directives]
    return fired, directives, reg.fired_log, log.records


def test_chaos_plans_parse_and_fire_as_jax():
    assert chaos.KNOWN_POINTS.keys() == jchaos.KNOWN_POINTS.keys()
    assert chaos.PAYLOAD_ARG_POINTS == jchaos.PAYLOAD_ARG_POINTS
    ours, theirs = _chaos_trace(chaos), _chaos_trace(jchaos)
    assert ours == theirs
    assert sum(ours[0]) == 1 + 2 + 1 + 1 + 1 + 3
    for bad in ("", "nope@0", "ckpt.bitflip", "ckpt.bitflip@-1", "ckpt.bitflip@0*0"):
        try:
            theirs = ("ok", jchaos.ChaosRegistry.parse(bad) is None)
        except ValueError as e:
            theirs = ("error", str(e))
        try:
            ours = ("ok", chaos.ChaosRegistry.parse(bad) is None)
        except ValueError as e:
            ours = ("error", str(e))
        assert ours == theirs, bad


@pytest.mark.parametrize("point,item", [("fleet.replica_kill", "7c"), ("net.partition", "7c"),
                                        ("net.slow", "7c"), ("journal.torn_write", "7c"),
                                        ("adapt.train_raise", "7d")])
def test_chaos_refuses_a_point_of_an_unported_layer_by_name(point, item):
    """The fleet (item 7c) and adaptation (item 7d) layers are ported: their
    points parse as in JAX, and no layer is refused any more."""
    assert not hasattr(chaos, "UNPORTED_LAYERS")
    spec = f"serve.execute_raise@0,{point}@2*3:r01"
    fields = [(d.point, d.at, d.count, d.arg)
              for d in chaos.ChaosRegistry.parse(spec).directives]
    assert fields == [(d.point, d.at, d.count, d.arg)
                      for d in jchaos.ChaosRegistry.parse(spec).directives]
    assert fields[1] == (point, 2, 3, "r01")


def test_corruption_helpers_equal_jax(tmp_path):
    for mode in ("bitflip", "truncate"):
        for mod, name in ((chaos, "ours"), (jchaos, "theirs")):
            d = tmp_path / mode / name
            d.mkdir(parents=True)
            (d / "small.bin").write_bytes(bytes(range(10)))
            (d / "latest.pt").write_bytes(bytes(range(256)) * 3)
            assert Path(mod.corrupt_step_dir(d, mode)).name == "latest.pt"
        assert (tmp_path / mode / "ours" / "latest.pt").read_bytes() == \
            (tmp_path / mode / "theirs" / "latest.pt").read_bytes()
    with pytest.raises(ValueError):
        chaos.corrupt_file(tmp_path / "bitflip" / "ours" / "small.bin", "melt")


# --- drift and SLO --------------------------------------------------------------


def test_quality_features_equal_jax():
    rng = np.random.default_rng(0)
    for shape in ((5,), (7, 4), (3, 2, 6), (4, 1)):
        s = rng.normal(0, 3, shape).astype(np.float32)
        for a, b in zip(drift.quality_features(s), jdrift.quality_features(s)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def _drift_trace(mod):
    log = ListLogger()
    det = mod.DriftDetector(window=16, baseline_n=8, eval_interval_s=0.5, logger=log)
    rng = np.random.default_rng(1)
    t = 0.0
    for i in range(80):
        shifted = i >= 40
        det.observe("t0", nota=shifted and i % 2 == 0,
                    margin=float(rng.normal(0.5 if shifted else 2.0, 0.1)),
                    entropy=float(rng.normal(1.0, 0.05)), now=t)
        det.observe("t1", nota=False, margin=float(rng.normal(2.0, 0.1)),
                    entropy=float(rng.normal(1.0, 0.05)), now=t)
        t += 0.1
    det.emit(log, 80)
    det.observe_parity("t1", agreement=0.5, margin_drift=0.1, rows=4)
    det.observe_parity("t1", agreement=1.0, margin_drift=0.0, rows=4)
    det.rearm("t0", reason="publish")
    det.set_baseline("t1", {"nota_rate": (0.0, 0.0), "margin": (2.0, 0.1),
                            "entropy": (1.0, 0.05)})
    return ([(e.event, e.severity, e.step, e.data.get("feature")) for e in det.events],
            det.tripped, det.rearms, [(s, k) for s, k, _ in log.records])


def test_drift_trips_equal_jax_on_an_injected_clock():
    ours, theirs = _drift_trace(drift), _drift_trace(jdrift)
    assert ours == theirs
    assert ours[1] and any(e[1] == "critical" for e in ours[0])


def _slo_trace(mod):
    log = ListLogger()
    eng = mod.SLOEngine(mod.SLOObjective(availability=0.95, latency_ms=10.0), fast_window_s=10.0,
                        slow_window_s=60.0, logger=log)
    t = 0.0
    for i in range(200):
        eng.record("t0", latency_ms=5.0 if i % 3 else 30.0, now=t)
        eng.record("t1", latency_ms=2.0, now=t)
        if i > 120:
            eng.record("shed", error=True, now=t)
        eng.maybe_evaluate(now=t)
        t += 0.1
    out = [(e.event, e.severity, e.step, e.data.get("tenant")) for e in eng.events]
    return out, eng.tripped, eng.burn_rates("t0", now=t), eng.tenants()


def test_slo_trips_equal_jax_on_an_injected_clock():
    ours, theirs = _slo_trace(health), _slo_trace(jhealth)
    assert ours == theirs
    assert any(e[3] == "shed" and e[1] == "critical" for e in ours[0])


# --- the capture watcher --------------------------------------------------------


EVENTS = [(("train_step", "s:int32[1, 3]"), 0.8), (("eval_step", "s:int32[1, 3]"), 0.3),
          (("train_step", "s:int32[1, 3]"), 0.7), (("train_step", "s:int32[4, 3]"), 0.9),
          (("build:attn_fwd", "a1b2"), 12.0), (("eval_step", "s:int32[2, 3]"), 0.01),
          (("train_step", "s:int32[8, 3]"), 1.1), (("train_step", "s:int32[16, 3]"), 0.6),
          (None, 0.2)]


def _watcher_trace(mod, tracker):
    log, fired = ListLogger(), []
    w = mod.CompileWatcher(logger=log, on_recompile=fired.append)
    for i, (pending, dur) in enumerate(EVENTS):
        w.observe_step(i)
        if i == 3:
            w.arm_steady()
        if i == 7:
            w.rearm()
        with tracker.span("train/dispatch" if i % 2 else "train/eval"):
            w._observe_compile(pending, dur)
    snap = w.snapshot()
    recs = [(r["fn"], r["shapes"], r["phase"], r["step"], r["trigger"]) for r in snap["records"]]
    snap.pop("records")
    return recs, snap, [r.fn for r in fired], [(s, k, f["phase"]) for s, k, f in log.records]


def test_capture_watcher_phases_equal_jax_observe_compile():
    tracker = spans.SpanTracker()
    prev = spans.set_tracker(tracker)
    jprev = jspans.set_tracker(jspans.SpanTracker(xplane_bridge=False))
    try:
        ours = _watcher_trace(compile, tracker)
        theirs = _watcher_trace(jcompile, jspans.get_tracker())
    finally:
        spans.set_tracker(prev)
        jspans.set_tracker(jprev)
    assert ours == theirs
    assert ours[1]["steady_recompiles"] == 3 and ours[2] == ["train_step", "train_step"]


def test_notify_capture_reaches_installed_watchers_only():
    log = ListLogger()
    w = compile.CompileWatcher(logger=log)
    compile.notify_capture("serve_query", "4,1,f32", 0.1)
    with w:
        compile.notify_capture("serve_query", "4,1,f32", 0.1)
        compile.notify_capture("serve_query", "4,2,f32", 0.1)
    compile.notify_capture("serve_query", "4,4,f32", 0.1)
    assert [f["phase"] for _, _, f in log.records] == ["warmup", "recompile"]
    leaves = [("s_word", np.zeros((2, 3), np.int32))]
    assert compile.signature(leaves) == "s_word:int32[2, 3]"


# --- flops and roofline ---------------------------------------------------------


ZOO = [dict(model=m, encoder=e) for m in ("induction", "proto", "proto_hatt", "siamese", "gnn",
                                          "snail", "metanet") for e in ("cnn", "bilstm",
                                                                        "transformer")]
ZOO += [dict(model="induction", encoder="bert", bert_frozen=False),
        dict(model="induction", encoder="bert", bert_frozen=True, feature_cache=True),
        dict(model="pair", encoder="bert"), dict(model="gnn", encoder="cnn", n=10, k=10),
        dict(model="induction", encoder="bilstm", na_rate=2, compute_dtype="float32")]


@pytest.mark.parametrize("kw", ZOO, ids=[f"{k['model']}-{k['encoder']}-{i}"
                                         for i, k in enumerate(ZOO)])
def test_flops_and_roofline_counts_equal_jax(kw):
    cfg, jcfg = ExperimentConfig(**kw), JaxConfig(**kw)
    assert flops.train_step_flops(cfg) == jflops.train_step_flops(jcfg)
    for remat in (True, False):
        for window in (0, 8):
            assert roofline.step_components(cfg, remat, 3000, window) == \
                jroofline.step_components(jcfg, remat, 3000, window)
    assert roofline.step_bytes(cfg) == jroofline.step_bytes(jcfg)
    assert roofline.lstm_residual_bytes(cfg, 4, "bf16") == jroofline.lstm_residual_bytes(
        jcfg, 4, "bf16")
    assert roofline.main_param_count(cfg) == jroofline.main_param_count(jcfg)
    assert roofline.touched_rows(cfg, 100) == jroofline.touched_rows(jcfg, 100)
    # The floor divides by the H100's rates, not the reference's chip.
    peak = roofline.H100_BF16_FLOPS if cfg.compute_dtype == "bfloat16" else \
        roofline.H100_F32_FLOPS
    want = sum(max(b / roofline.H100_HBM_BW, f / peak) * 1e3
               for _, b, f in jroofline.step_components(jcfg))
    assert roofline.projected_floor_ms(cfg) == pytest.approx(want, rel=1e-12)


def test_peak_flops_know_the_h100_only():
    assert flops.peak_flops_per_chip("NVIDIA H100 80GB HBM3", "bfloat16") == 989e12
    assert flops.peak_flops_per_chip("NVIDIA H100 80GB HBM3", "float32") == 67e12
    assert flops.peak_flops_per_chip("TPU v5 lite", "bfloat16") is None
    assert flops.peak_flops_per_chip("cpu", "bfloat16") is None


# --- metrics: kinds, hooks, the TensorBoard mirror ------------------------------


def test_known_kinds_and_identity_equal_jax(tmp_path):
    assert metrics.KNOWN_KINDS == jmetrics.KNOWN_KINDS
    got = []
    lg = metrics.MetricsLogger(tmp_path, quiet=True)
    lg.add_hook(got.append)
    lg.add_hook(got.append)                 # registered once
    lg.set_identity("serve", replica="r1")
    lg.log(3, "train", loss=float("nan"), note="x")
    lg.close()
    rec = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert rec["loss"] == "nan" and rec["proc_role"] == "serve" and rec["proc_replica"] == "r1"
    assert len(got) == 1 and math.isnan(got[0]["loss"]) and "t_unix" in got[0]


TB_RECORDS = [(0, "train", {"loss": 1.25, "accuracy": 0.5, "note": "x"}),
              (4, "val", {"accuracy": 0.75, "acc_ci95": 0.125}),
              (-1, "fault", {"ckpt_step": -1.0, "action": "ckpt_quarantine"}),
              (2 ** 40, "perf", {"window_s": 3.5e-7})]


def _tb_values(path, tf):
    out = []
    for e in tf.compat.v1.train.summary_iterator(str(path)):
        for v in e.summary.value:
            value = v.simple_value if v.HasField("simple_value") else \
                float(tf.make_ndarray(v.tensor))
            out.append((v.tag, e.step, value))
    return out


def test_tensorboard_file_reads_back_as_the_jax_loggers(tmp_path):
    tf = pytest.importorskip("tensorflow")
    ours = metrics.MetricsLogger(tmp_path / "a", quiet=True, tensorboard_dir=tmp_path / "tb_a")
    theirs = jmetrics.MetricsLogger(tmp_path / "b", quiet=True, tensorboard_dir=tmp_path / "tb_b")
    for step, kind, fields in TB_RECORDS:
        ours.log(step, kind, **fields)
        theirs.log(step, kind, **fields)
    path = ours.tensorboard_path
    ours.close()
    theirs.close()
    got = _tb_values(path, tf)
    want = _tb_values(next((tmp_path / "tb_b").iterdir()), tf)
    assert [(t, s) for t, s, _ in got] == [(t, s) for t, s, _ in want]
    np.testing.assert_allclose([v for *_, v in got], [v for *_, v in want], rtol=1e-7)
    assert metrics.read_events(path) == [(t, s, np.float32(v)) for t, s, v in got]


def test_tensorboard_reader_refuses_a_corrupt_record(tmp_path):
    lg = metrics.MetricsLogger(None, quiet=True, tensorboard_dir=tmp_path)
    lg.log(1, "train", loss=2.0)
    lg.close()
    data = bytearray(lg_path := next(tmp_path.iterdir()).read_bytes())
    data[-6] ^= 0xFF
    Path(tmp_path / "bad").write_bytes(bytes(data))
    assert metrics.read_events(next(p for p in tmp_path.iterdir() if p.name != "bad")) == \
        [("train/loss", 1, 2.0)]
    with pytest.raises(ValueError, match="corrupt record"):
        metrics.read_events(tmp_path / "bad")
    assert lg_path


# --- the recorder, the capture, the debug check ---------------------------------


def _recorder_dump(mod, tmp_path, tracker):
    rec = mod.FlightRecorder(out_dir=tmp_path, tracker=tracker, max_metrics=2)
    for i in range(4):
        rec.record_metric({"step": i, "kind": "train", "loss": float("nan") if i == 3 else 1.0})
    rec.record_event({"event": "non_finite"})
    with pytest.raises(ZeroDivisionError):
        with rec.armed("train crash"):
            1 / 0
    payload = json.loads(rec.last_dump_path.read_text())
    return {k: v for k, v in payload.items() if k not in ("uptime_s", "dumped_unix_s", "spans")}


def test_flight_recorder_dump_equals_jax(tmp_path):
    ours = _recorder_dump(recorder, tmp_path / "a", spans.SpanTracker())
    theirs = _recorder_dump(jrecorder, tmp_path / "b", jspans.SpanTracker(xplane_bridge=False))
    assert ours == theirs
    assert ours["reason"].startswith("train crash: ZeroDivisionError")
    assert ours["metrics"][-1]["loss"] == "nan"


def test_diagnostics_capture_writes_a_torch_profiler_trace(tmp_path):
    cap = health.DiagnosticsCapture(tmp_path, tracker=spans.SpanTracker(), profile_s=0.05)
    out = cap.capture("drill")
    cap.wait(10.0)
    assert out["profile_state"] == "started" and not cap.profile_errors
    assert json.loads((Path(out["profile"]) / "trace.json").read_text())["traceEvents"]
    assert json.loads(Path(out["span_snapshot"]).read_text())["reason"] == "drill"


def test_debug_finite_check_names_the_step():
    ok = debug.finite_flag(torch.tensor(1.0), torch.tensor(2.0))
    bad = debug.finite_flag(torch.tensor(1.0), torch.tensor(float("inf")))
    debug.check_finite_steps(torch.stack([ok, ok]), 10)
    with pytest.raises(FloatingPointError, match="at step 12 .*steps 11..13"):
        debug.check_finite_steps(torch.stack([ok, bad, bad]), 10)
    with pytest.raises(FloatingPointError, match="step 5"):
        debug.assert_all_finite({"loss": float("nan")}, step=5)
