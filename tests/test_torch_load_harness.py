"""The port's load generator harness (``load/harness.py``, ``load/drift.py``'s
pure functions, ``load/__main__.py``) against the JAX tool
``tools/loadgen.py``, on the CPU.

* CLI parity: every flag of the JAX ``loadgen.parse_args`` parses to the
  JAX value in the port, except the documented delta (``--device``:
  ``cuda | cpu``, default ``cuda``, against ``cpu | tpu``); ``--serving_dp``
  above the visible cards exits 2 with the engine's "exceeds" text; the
  same for the scenario harness's and the fleet report's parsers.
* ``pct``, ``calibrate_drift_floor`` and ``_nota_gap`` equal the JAX
  functions on the same inputs.
* The registry-parity gate: on the same weights (``interop.py``) the
  port's ``check_registry_parity`` and the JAX one both pass and agree
  within the serving bar of 2e-2, per resident dtype.
* The generator: a short closed + open run of both scheduler arms with the
  swap drill returns the JAX report's keys, with no error, shed, miss or
  capture after warmup; without CUDA the entry point refuses to start.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import argparse
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.data import GloveTokenizer as JaxTokenizer
from induction_network_on_fewrel_tpu.data import make_synthetic_glove as jax_glove
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu.serving.engine import InferenceEngine as JaxEngine
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.data import (
    GloveTokenizer,
    make_synthetic_fewrel,
    make_synthetic_glove,
)
from induction_network_on_fewrel_tpu_torch.interop import params_from_jax
from induction_network_on_fewrel_tpu_torch.load import __main__ as tmain
from induction_network_on_fewrel_tpu_torch.load import drift as tdrift
from induction_network_on_fewrel_tpu_torch.load import fleet_report as treport
from induction_network_on_fewrel_tpu_torch.load import harness
from induction_network_on_fewrel_tpu_torch.load import scenarios as tscen
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.serving.buckets import zero_batch
from induction_network_on_fewrel_tpu_torch.serving.engine import NO_RELATION, InferenceEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOOLS = os.path.join(REPO, "tools")
if _TOOLS not in sys.path:
    sys.path.insert(0, _TOOLS)

import fleet_report  # noqa: E402
import loadgen  # noqa: E402
import scenarios  # noqa: E402

# The serving bar: the JAX and port gates' readings on the same weights.
PARITY_BAR = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- CLI parity -------------------------------------------------------------------


JAX_DEFAULTS = vars(loadgen.parse_args([]))
# A value of each flag whose JAX default is None (other flags flip their
# default: store_true flags are given, numbers move, choices take another).
SAMPLES = {"ckpt": "c", "serving_dp": "2", "run_dir": "r", "slo_latency_ms": "7.5"}
DELTAS = {"device"}


def _argv_for(dest):
    default = JAX_DEFAULTS[dest]
    if isinstance(default, bool):
        return [f"--{dest}"]
    if dest in SAMPLES:
        return [f"--{dest}", SAMPLES[dest]]
    if dest.endswith("artifact"):
        return [f"--{dest}", "x.json"]
    if dest == "mode":
        return ["--mode", "open"]
    if dest == "scheduler":
        return ["--scheduler", "microbatch"]
    if dest == "buckets":
        return ["--buckets", "1,4"]
    return [f"--{dest}", str(type(default)(default * 2 + 1))]


@pytest.mark.parametrize("dest", sorted(set(JAX_DEFAULTS) - DELTAS))
def test_loadgen_flag_parses_as_in_jax(dest, capsys):
    argv = _argv_for(dest) + (["--run_dir", "r"] if dest != "run_dir" else [])
    want = vars(loadgen.parse_args(argv))
    got = vars(harness.parse_args(argv))
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in DELTAS} == \
        {k: v for k, v in want.items() if k not in DELTAS}


def test_loadgen_defaults_and_the_device_delta(capsys):
    got = vars(harness.parse_args([]))
    assert {k: v for k, v in got.items() if k != "device"} == \
        {k: v for k, v in JAX_DEFAULTS.items() if k != "device"}
    assert got["device"] == "cuda" and JAX_DEFAULTS["device"] == "cpu"
    assert harness.parse_args(["--device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        harness.parse_args(["--device", "tpu"])
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    args = harness.parse_args(["--serving_dp", str(max(2, visible + 1))])
    assert args.serving_dp == max(2, visible + 1)
    with pytest.raises(SystemExit) as e:
        harness.check_serving_dp(args)
    assert e.value.code == 2 and f"exceeds the {visible} visible devices" in \
        capsys.readouterr().err
    for flag in ("--burn_drill", "--drift_drill", "--chaos_drill", "--adapt_drill",
                 "--fleet_obs_drill"):
        with pytest.raises(SystemExit):
            harness.parse_args([flag])
        with pytest.raises(SystemExit):
            loadgen.parse_args([flag])


class _Parsed(Exception):
    pass


def _jax_namespace(main, argv, monkeypatch):
    """The namespace a JAX tool's ``main`` parses ``argv`` to (its parser is
    built inside ``main``)."""
    real = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        raise _Parsed(real(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    try:
        main(argv)
    except _Parsed as e:
        return vars(e.args[0])
    finally:
        monkeypatch.undo()
    raise AssertionError("the JAX main did not parse")


@pytest.mark.parametrize("argv", [[], ["--mode", "tier1"], ["--seed", "4", "--run_dir", "d"],
                                  ["--artifact", "x.json", "--mode", "full"]])
def test_scenarios_parser_equals_jax(argv, monkeypatch):
    want = _jax_namespace(scenarios.main, argv, monkeypatch)
    got = vars(tscen.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want


@pytest.mark.parametrize("argv", [["d"], ["d", "--check", "--json"],
                                  ["d", "--replica", "a", "--replica", "b", "--router", "r",
                                   "--journal", "j", "--skew_bound_ms", "5", "--waterfalls", "1"]])
def test_fleet_report_parser_equals_jax(argv, monkeypatch):
    assert vars(treport.parse_args(argv)) == _jax_namespace(fleet_report.main, argv, monkeypatch)


# --- pure functions -----------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_pct_equals_jax(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 2, 7, 100):
        lat = list(rng.exponential(0.01, n))
        for q in (0, 1, 50, 90, 99, 100):
            a, b = harness.pct(lat, q), loadgen.pct(lat, q)
            assert (np.isnan(a) and np.isnan(b)) or a == b
            assert harness.pct_ms(lat, q) == loadgen.pct_ms(lat, q)


def _gap_cases():
    rng = np.random.default_rng(0)
    yield list(rng.normal(0, 1, 40)), [0.1, 0.1, 0.1]
    yield list(rng.normal(2, 1, 40)), [0.0]
    yield list(rng.normal(-2, 1, 40)), [0.0, 0.0]
    yield [0.5] * 10, [0.5]                        # nothing separates
    yield [], [1.0]
    yield [1.0, 2.0, 3.0, -1.0], [1.5, 1.5]
    yield list(rng.normal(0, 1e-3, 20)), [0.0]


@pytest.mark.parametrize("case", list(_gap_cases()), ids=lambda c: f"n{len(c[0])}")
def test_calibrate_drift_floor_equals_jax(case):
    assert tdrift.calibrate_drift_floor(*case) == loadgen.calibrate_drift_floor(*case)


def test_nota_gap_and_oov_probe_equal_jax():
    for logits in ({"a": 1.0, "b": 3.5}, {"a": 1.0, "b": -2.0, NO_RELATION: 0.25},
                   {"x": -1.0, NO_RELATION: 4.0}):
        v = {"logits": logits}
        assert tdrift._nota_gap(v) == loadgen._nota_gap(v)
    a, b = tdrift._oov_instance(3), loadgen._oov_instance(3)
    assert (a.tokens, a.head_pos, a.tail_pos) == (b.tokens, b.head_pos, b.tail_pos)


# --- the registry-parity gate on the same weights ----------------------------------------


VOCAB, L, K = 80, 12, 3
SMALL = dict(vocab_size=VOCAB + 2, max_length=L, word_dim=10, pos_dim=2, lstm_hidden=16,
             att_dim=8, induction_dim=12, ntn_slices=6, k=K, compute_dtype="float32",
             na_rate=1)


@pytest.fixture(scope="module")
def parity_world():
    jcfg = JaxConfig(**SMALL, lstm_backend="scan", attn_backend="xla")
    jmodel = jax_build_model(jcfg)
    zeros = zero_batch(L, (1, 1, 1))
    params = jax.jit(jmodel.init)(jax.random.key(3), zeros,
                                  {k: v[:, 0] for k, v in zeros.items()})["params"]
    cfg = ExperimentConfig(**SMALL)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    ds = {t: make_synthetic_fewrel(num_relations=n, instances_per_relation=K + 4,
                                   vocab_size=VOCAB, sentence_len=(5, 16), seed=s)
          for t, n, s in (("a", 3, 1), ("b", 6, 2))}
    return dict(jcfg=jcfg, jmodel=jmodel, params=params, cfg=cfg, model=model, ds=ds,
                tok=GloveTokenizer(make_synthetic_glove(vocab_size=VOCAB, word_dim=10),
                                   max_length=L),
                jtok=JaxTokenizer(jax_glove(vocab_size=VOCAB, word_dim=10), max_length=L))


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-4), ("bf16", 0.25), ("int8", 0.25)])
def test_registry_parity_gate_agrees_with_jax(parity_world, dtype, tol):
    w = parity_world
    eng = InferenceEngine(w["model"], w["cfg"], w["tok"], k=K, buckets=(1, 2, 4), device="cpu",
                          start=False, resident_dtype=dtype)
    jeng = JaxEngine(w["jmodel"], {"params": w["params"]}, w["jcfg"], w["jtok"], k=K,
                     buckets=(1, 2, 4), start=False, resident_dtype=dtype)
    try:
        for e in (eng, jeng):
            for t, ds in w["ds"].items():
                e.register_dataset(ds, tenant=t)
            e.warmup()
        for t, ds in w["ds"].items():
            got = harness.check_registry_parity(eng, ds, tenant=t)
            want = loadgen.check_registry_parity(jeng, ds, tenant=t)
            assert got < tol and want < tol, (got, want)
            assert abs(got - want) <= PARITY_BAR
        assert eng.stats.snapshot()["steady_recompiles"] == 0
    finally:
        eng.close()
        jeng.close()


# --- the generator --------------------------------------------------------------------


def _report(capsys) -> dict:
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith('{"config"')]
    return json.loads(lines[-1])


def test_generator_both_arms_with_the_swap_drill(capsys):
    # A deadline far past the run: a host shared with other work may queue a
    # request for seconds, and a miss is not what this run checks.
    rc = tmain.main(["--device", "cpu", "--duration", "0.6", "--concurrency", "2",
                     "--rate", "40", "--deadline_ms", "60000", "--swap_drill",
                     "--trace_sample", "0.5"])
    report = _report(capsys)
    assert rc == 0
    with open(os.path.join(REPO, "SERVE_r02.json")) as f:
        jax_arm = json.load(f)["arms"]["continuous"]
    assert set(report["arms"]) == {"continuous", "microbatch"}
    for arm, r in report["arms"].items():
        assert set(r) == set(jax_arm) - {"burn_drill"}
        for key in ("closed", "open", "swap_drill", "stats"):
            assert set(jax_arm[key]) <= set(r[key]), key
        assert r["scheduler"] == arm and r["parity_ok"]
        assert r["closed"]["errors"] == 0 and r["closed"]["retries"] == 0
        assert r["open"]["rejected"] == r["open"]["dropped"] == r["open"]["deadline_miss"] == 0
        assert r["stats"]["steady_recompiles"] == 0 and r["stats"]["shed"] == 0
        assert r["swap_drill"]["params_version"] == 1 and r["swap_drill"]["dropped"] == 0
        assert r["closed"]["qps"] > 0 and r["open"]["p50_ms"] is not None
    assert set(report["comparison"]) >= {"closed_qps_ratio", "open_p99_ratio"}


def test_generator_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal path is not reachable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(["--duration", "0.1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tscen.main(["--mode", "tier1"])
