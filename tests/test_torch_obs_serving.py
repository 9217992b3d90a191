"""The port's serving telemetry (CPU) vs the JAX package's.

Both packages' ``InferenceEngine`` serve the same weights
(``interop.params_from_jax``) and the same queries with a logger, the
watchdog, the SLO engine and the drift detector, at ``trace_sample`` 1.0
and 0: the same record kinds, the same health events and the same trace
records (each request's queue + pack + execute + respond equals its
total), ``tools/obs_report.py --check`` passes on the port's run
directory (and the port's own report equals the JAX tool's on every
serving run directory, ``mfu`` and ``overhead`` aside), and at rate 0 the port allocates no span and no trace record.
The same chaos plan drives both: ``serve.execute_raise`` fails only its
batch with a typed ``ExecuteError`` and the worker serves on;
``publish.nan_params`` and ``publish.distill_raise`` roll the publish back
with every tenant on its old snapshot; the fault records are the same.
A drift drill (out-of-vocabulary traffic after an in-domain baseline)
trips both detectors the same way, once; a fully shed tenant trips the
SLO burn in both. ``serve_main`` with the telemetry flags writes
``metrics.prom`` and a run directory ``--check`` accepts.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from induction_network_on_fewrel_tpu import obs as jobs
from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.data import GloveTokenizer as JaxTokenizer
from induction_network_on_fewrel_tpu.data import make_synthetic_glove as jax_glove
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu.obs import chaos as jchaos
from induction_network_on_fewrel_tpu.serving.engine import InferenceEngine as JaxEngine
from induction_network_on_fewrel_tpu.serving.registry import PublishError as JaxPublishError
from induction_network_on_fewrel_tpu.utils.metrics import MetricsLogger as JaxLogger
from induction_network_on_fewrel_tpu_torch import cli, obs
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.data import (
    GloveTokenizer,
    make_synthetic_fewrel,
    make_synthetic_glove,
)
from induction_network_on_fewrel_tpu_torch.interop import params_from_jax
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.obs import chaos
from induction_network_on_fewrel_tpu_torch.serving import cli as serve_cli
from induction_network_on_fewrel_tpu_torch.serving.batcher import ExecuteError
from induction_network_on_fewrel_tpu_torch.serving.buckets import zero_batch
from induction_network_on_fewrel_tpu_torch.serving.engine import InferenceEngine
from induction_network_on_fewrel_tpu_torch.serving.registry import PublishError
from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

REPO = Path(__file__).resolve().parents[1]
VOCAB, L, K = 80, 12, 3
SMALL = dict(vocab_size=VOCAB + 2, max_length=L, word_dim=10, pos_dim=2, lstm_hidden=16,
             att_dim=8, induction_dim=12, ntn_slices=6, k=K, compute_dtype="float32")
BUCKETS = (1, 2, 4)
SEGMENTS = ("queue_ms", "pack_ms", "execute_ms", "respond_ms")


@pytest.fixture(scope="module")
def world():
    jcfg = JaxConfig(**SMALL, lstm_backend="scan", attn_backend="xla")
    jmodel = jax_build_model(jcfg)
    zeros = zero_batch(L, (1, 1, 1))
    init = jax.jit(jmodel.init)
    params = init(jax.random.key(1), zeros, {k: v[:, 0] for k, v in zeros.items()})["params"]
    params2 = init(jax.random.key(7), zeros, {k: v[:, 0] for k, v in zeros.items()})["params"]
    cfg = ExperimentConfig(**SMALL)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    ds = make_synthetic_fewrel(num_relations=6, instances_per_relation=12, vocab_size=VOCAB,
                               sentence_len=(5, 16), seed=4)
    return dict(jcfg=jcfg, jmodel=jmodel, params=params, params2=params2, cfg=cfg, model=model,
                tok=GloveTokenizer(make_synthetic_glove(vocab_size=VOCAB, word_dim=10),
                                   max_length=L),
                jtok=JaxTokenizer(jax_glove(vocab_size=VOCAB, word_dim=10), max_length=L), ds=ds)


def _engine(world, port: bool, logger, params=None, **kw):
    """An engine of either package on ``params`` (JAX leaves; default the
    world's)."""
    kw = dict(k=K, buckets=BUCKETS, start=False, geometry_tiers="off", **kw)
    if port:
        model = world["model"]
        if params is not None:
            model = build_model(world["cfg"], device="cpu")
            model.load_state_dict(params_from_jax(params))
        return InferenceEngine(model, world["cfg"], world["tok"], device="cpu",
                               logger=logger, **kw)
    return JaxEngine(world["jmodel"], {"params": params if params is not None else world["params"]},
                     world["jcfg"], world["jtok"], logger=logger, **kw)


def _drain(eng, futs):
    while not all(f.done() for f in futs):
        eng.batcher.drain_once(block_s=0.01)
    out = []
    for f in futs:
        try:
            out.append(f.result())
        except Exception as e:  # noqa: BLE001 — the typed failure is the result
            out.append(e)
    return out


def _records(run_dir: Path) -> list[dict]:
    return [json.loads(ln) for ln in (run_dir / "metrics.jsonl").read_text().splitlines()]


def _queries(ds, names, start=K, per=3):
    return [vars(i) for n in names for i in ds.instances[n][start:start + per]]


def _serve_run(world, port: bool, run_dir: Path, rate: float):
    """One serving run with every hook on: traffic, a chaos plan
    (execute_raise on tenant a's second batch, a NaN-poisoned publish, a
    distill failure in the next publish), then a clean publish."""
    o = obs if port else jobs
    mod = chaos if port else jchaos
    logger = (MetricsLogger if port else JaxLogger)(run_dir, quiet=True)
    recorder = o.FlightRecorder(out_dir=run_dir)
    logger.add_hook(recorder.record_metric)
    watchdog = o.HealthWatchdog(logger=logger, recorder=recorder)
    slo = o.SLOEngine(o.SLOObjective(availability=0.99, latency_ms=60_000.0), logger=logger,
                      recorder=recorder)
    drift = o.DriftDetector(window=8, baseline_n=4, eval_interval_s=0.0, logger=logger,
                            recorder=recorder)
    reg = mod.ChaosRegistry.parse(
        "serve.execute_raise@1:a,publish.nan_params@0,publish.distill_raise@0",
        logger=logger).install()
    eng = _engine(world, port, logger, watchdog=watchdog, slo=slo, drift=drift,
                  trace_sample=rate)
    try:
        names = eng.register_dataset(world["ds"], max_classes=3, tenant="a")
        eng.warmup()
        results = []
        for i in range(3):          # one batch of 3 a round
            futs = [eng.submit(q, deadline_s=60.0, tenant="a")
                    for q in _queries(world["ds"], names, start=K + i, per=1)]
            results.append(_drain(eng, futs))
        publish_errors = []
        for _ in range(2):
            try:
                eng.publish_params(params_from_jax(world["params2"]) if port
                                   else {"params": world["params2"]})
            except (PublishError, JaxPublishError) as e:
                publish_errors.append(str(e))
        version = eng.publish_params(params_from_jax(world["params2"]) if port
                                     else {"params": world["params2"]})
        results.append(_drain(eng, [eng.submit(q, deadline_s=60.0, tenant="a")
                                    for q in _queries(world["ds"], names, per=1)]))
    finally:
        eng.close()
        reg.uninstall()
        logger.close()
    return results, publish_errors, version, eng


@pytest.fixture(scope="module")
def serve_runs(world, tmp_path_factory):
    root = tmp_path_factory.mktemp("obs_serving")
    out = {}
    for rate in (1.0, 0.0):
        for port in (True, False):
            run = root / f"{'port' if port else 'jax'}_{rate}"
            tracker = obs.SpanTracker() if port else jobs.SpanTracker(xplane_bridge=False)
            prev = (obs.set_tracker if port else jobs.set_tracker)(tracker)
            try:
                res = _serve_run(world, port, run, rate)
            finally:
                (obs.set_tracker if port else jobs.set_tracker)(prev)
            out[port, rate] = dict(run=run, results=res[0], publish_errors=res[1],
                                   version=res[2], engine=res[3], spans=tracker.snapshot())
    return out


def _shape(rec: dict) -> tuple:
    return tuple(str(rec.get(k, "")) for k in ("kind", "event", "action", "op", "probe"))


@pytest.mark.parametrize("rate", [1.0, 0.0])
def test_serving_records_and_health_events_equal_jax(serve_runs, rate):
    ours, theirs = _records(serve_runs[True, rate]["run"]), _records(serve_runs[False, rate]["run"])
    assert sorted(map(_shape, ours)) == sorted(map(_shape, theirs))
    health = [(r["event"], r["severity"]) for r in ours if r["kind"] == "health"]
    assert health == [(r["event"], r["severity"]) for r in theirs if r["kind"] == "health"]
    assert ("publish_rollback", "critical") in health
    faults = [(r["action"], r.get("point"), r.get("tenant")) for r in ours if r["kind"] == "fault"]
    assert faults == [(r["action"], r.get("point"), r.get("tenant"))
                      for r in theirs if r["kind"] == "fault"]
    assert ("execute_error", None, "a") in faults


@pytest.mark.parametrize("rate", [1.0, 0.0])
def test_contained_failures_and_rollbacks_equal_jax(serve_runs, rate):
    ours, theirs = serve_runs[True, rate], serve_runs[False, rate]
    kinds = [[type(v).__name__ if isinstance(v, Exception) else v["label"] for v in batch]
             for batch in ours["results"]]
    assert kinds == [[type(v).__name__ if isinstance(v, Exception) else v["label"]
                      for v in batch] for batch in theirs["results"]]
    assert all(isinstance(v, ExecuteError) for v in ours["results"][1])
    assert not any(isinstance(v, Exception) for v in ours["results"][2])   # the worker serves on
    assert len(ours["publish_errors"]) == len(theirs["publish_errors"]) == 2
    assert "non-finite" in ours["publish_errors"][0]
    assert "ChaosError" in ours["publish_errors"][1]
    assert ours["version"] == theirs["version"] == 1


def test_trace_waterfalls_tile_each_request_at_rate_one(serve_runs):
    ours = [r for r in _records(serve_runs[True, 1.0]["run"]) if r["kind"] == "trace"]
    theirs = [r for r in _records(serve_runs[False, 1.0]["run"]) if r["kind"] == "trace"]
    assert [sorted(r) for r in ours] == [sorted(r) for r in theirs]
    requests = [r for r in ours if "total_ms" in r]
    assert len(requests) == sum(not isinstance(v, Exception)
                                for b in serve_runs[True, 1.0]["results"] for v in b)
    for r in requests:
        assert abs(sum(r[s] for s in SEGMENTS) - r["total_ms"]) <= 2.5e-3    # 5 x 0.5 us rounding
    verdicts = [v for b in serve_runs[True, 1.0]["results"] for v in b if isinstance(v, dict)]
    assert {v["trace_id"] for v in verdicts} == {r["trace_id"] for r in requests}
    names = {s["name"] for s in serve_runs[True, 1.0]["spans"]}
    assert {"serve/submit", "serve/stack", "serve/execute", "serve/publish",
            "serve/distill"} <= names
    execs = [s for s in serve_runs[True, 1.0]["spans"] if s["name"] == "serve/execute"]
    assert all(s.get("links") for s in execs)


def test_rate_zero_allocates_no_span_or_trace(serve_runs):
    s = serve_runs[True, 0.0]
    assert s["engine"]._tracer._count is None
    assert not {"serve/submit"} & {x["name"] for x in s["spans"]}
    assert all(not x.get("links") for x in s["spans"])
    recs = _records(s["run"])
    assert [r.get("op") for r in recs if r["kind"] == "trace"] == ["publish"]
    assert all("trace_id" not in v for b in s["results"] for v in b if isinstance(v, dict))


def test_obs_report_check_passes_on_the_ports_serving_run(serve_runs):
    out = subprocess.run([sys.executable, str(REPO / "tools" / "obs_report.py"),
                          str(serve_runs[True, 1.0]["run"]), "--check"], capture_output=True,
                         text=True, cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"},
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("port", [True, False], ids=["port", "jax"])
@pytest.mark.parametrize("rate", [1.0, 0.0])
def test_port_report_equals_the_jax_report(serve_runs, port, rate, capsys):
    """The port's ``tools/obs_report.py --json`` equals the JAX tool's on
    the port's and the JAX package's serving runs, section by section
    (``mfu`` and ``overhead`` aside), and its ``--check`` passes."""
    from test_torch_tools_report import assert_reports_equal
    from induction_network_on_fewrel_tpu_torch.tools import obs_report

    run = serve_runs[port, rate]["run"]
    report = assert_reports_equal(run, capsys)
    assert report["serve"] and report["faults"] and report["flight_recorder"]
    assert obs_report.main([str(run), "--check"]) == 0


# --- drift and SLO drills ---------------------------------------------------------


def _drift_drill(world, port: bool):
    """Fresh-init scores are near ties whatever the input; weights scaled
    3x give in-domain margins near 1 and the all-unknown sentence one near
    3, a shift the detector must see."""
    o = obs if port else jobs
    det = o.DriftDetector(window=8, baseline_n=8, eval_interval_s=0.0)
    eng = _engine(world, port, None, params=jax.tree.map(lambda x: 3.0 * x, world["params"]),
                  drift=det)
    try:
        names = eng.register_dataset(world["ds"], max_classes=3, tenant="a")
        normal = _queries(world["ds"], names, start=K, per=4)
        oov = [{"tokens": ["zzz_unknown"] * 8, "head_pos": [0], "tail_pos": [7]}] * 16
        _drain(eng, [eng.submit(q, deadline_s=60.0, tenant="a") for q in normal])
        _drain(eng, [eng.submit(q, deadline_s=60.0, tenant="a") for q in oov])
    finally:
        eng.close()
    return [(e.event, e.severity, e.data.get("feature")) for e in det.events], det.tripped


def test_drift_drill_trips_once_as_jax(world):
    ours, theirs = _drift_drill(world, True), _drift_drill(world, False)
    assert ours == theirs
    assert ours[1] and sum(sev == "critical" for _, sev, _ in ours[0]) >= 1
    crit = [f for _, sev, f in ours[0] if sev == "critical"]
    assert len(crit) == len(set(crit))                   # once-latched per feature


def _shed_drill(world, port: bool):
    o = obs if port else jobs
    slo = o.SLOEngine(o.SLOObjective(availability=0.99), fast_window_s=60.0)
    eng = _engine(world, port, None, slo=slo, max_queue_depth=4, tenant_share=0.25)
    shed = 0
    try:
        names = eng.register_dataset(world["ds"], max_classes=3, tenant="a")
        eng.register_dataset(world["ds"], max_classes=3, tenant="b")
        eng.submit(_queries(world["ds"], names)[0], deadline_s=60.0, tenant="b")
        for q in _queries(world["ds"], names, per=5) * 2:
            try:
                eng.submit(q, deadline_s=60.0, tenant="a")
            except Exception as e:  # noqa: BLE001 — either package's Saturated
                assert "saturated" in str(e)
                shed += 1
        while eng.batcher.queue_depth:
            eng.batcher.drain_once(block_s=0.01)
        slo.evaluate()
    finally:
        eng.close()
    return [(e.event, e.severity, e.data.get("tenant")) for e in slo.events], shed


def test_slo_trips_on_a_fully_shed_tenant_as_jax(world):
    ours, theirs = _shed_drill(world, True), _shed_drill(world, False)
    assert ours == theirs
    assert ours[1] >= 10 and ("slo_fast_burn", "critical", "a") in ours[0]


# --- serve_main --------------------------------------------------------------------


def test_serve_main_with_telemetry_writes_metrics_prom(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    assert cli.main(["train", "--synthetic", "--N", "3", "--K", "2", "--Q", "2",
                     "--batch_size", "2", "--max_length", "12", "--vocab_size", "2002",
                     "--lstm_hidden", "8", "--induction_dim", "10", "--ntn_slices", "4",
                     "--device", "cpu", "--train_iter", "2", "--val_step", "2",
                     "--val_iter", "2", "--save_ckpt", str(ckpt)]) == 0
    run = tmp_path / "serve"
    argv = ["--load_ckpt", str(ckpt), "--K", "2", "--buckets", "1,2,4", "--device", "cpu",
            "--demo_queries", "6", "--run_dir", str(run), "--watchdog", "--trace_sample", "1.0",
            "--slo_latency_ms", "60000", "--drift", "--drift_window", "4",
            "--drift_baseline", "2", "--chaos", "serve.execute_raise@0"]
    assert serve_cli.serve_main(argv) == 0
    err = capsys.readouterr().err
    assert "chaos plan armed" in err and " errors" in err.split("demo accuracy")[1]
    prom = (run / "metrics.prom").read_text()
    assert "# TYPE induction_serve_latency_ms histogram" in prom
    assert 'trace_id="' in prom and "induction_serve_served " in prom
    recs = _records(run)
    assert {r["kind"] for r in recs} >= {"serve", "trace", "fault", "quality"}
    assert all(r["proc_role"] == "serve" for r in recs)
    assert not chaos.chaos_active()
    out = subprocess.run([sys.executable, str(REPO / "tools" / "obs_report.py"), str(run),
                          "--check"], capture_output=True, text=True, cwd=REPO,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr

