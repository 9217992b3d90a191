"""The port's quality drills on the CPU, held to the JAX tools:
``load/geom.py`` (the geometry A/B) and ``load/scenarios.py`` (the
scenario harness); the quant A/B is ``tests/test_torch_load_quant.py``.

* Geometry at ``GEOM_r01.json``'s seed (1 s phases instead of 2 s) passes
  the JAX ``check_geom_ab``: the tiered arm makes no program after warmup
  through the tier crossing and the dtype flip, stays under its bound and
  under the exact arm's count, and the exact arm pays the capture tax.
* The scenario harness's plans and band equal the JAX tool's; its tier-1
  leg, from the JAX trainer's initial weights (``interop.py``), stays
  inside ``SCENARIOS_r01.json``'s ``tier1`` band (the JAX tier-1 test's
  own bars) and writes schema-clean ``kind="scenario"`` records.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import json
import os
import sys

import jax
import pytest
import torch

import induction_network_on_fewrel_tpu.config as jconfig
import induction_network_on_fewrel_tpu.data as jdata
from induction_network_on_fewrel_tpu.models import build_model as jax_build
from induction_network_on_fewrel_tpu.models.build import batch_to_model_inputs
from induction_network_on_fewrel_tpu.sampling import EpisodeSampler as JaxSampler
from induction_network_on_fewrel_tpu.train.steps import init_state
from induction_network_on_fewrel_tpu_torch.interop import params_from_jax
from induction_network_on_fewrel_tpu_torch.load import geom, harness
from induction_network_on_fewrel_tpu_torch.load import scenarios as tscen
from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOOLS = os.path.join(REPO, "tools")
if _TOOLS not in sys.path:
    sys.path.insert(0, _TOOLS)

import loadgen  # noqa: E402
import obs_report  # noqa: E402
import scenarios  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config_argv(name, *keys):
    with open(os.path.join(REPO, name)) as f:
        cfg = json.load(f)["config"]
    return [x for k in keys for x in (f"--{k}", str(cfg[k]))]


def test_geom_ab_passes_the_jax_gate(tmp_path):
    args = harness.parse_args(["--device", "cpu", "--geom_ab", "--duration", "1.0",
                               *_config_argv("GEOM_r01.json", "seed", "K", "buckets", "rate")])
    ckpt = harness.make_synthetic_checkpoint(args, str(tmp_path))
    out = geom.run_geom_ab(args, ckpt)
    assert loadgen.check_geom_ab(out) == geom.check_geom_ab(out) == [], out["check_failures"]
    with open(os.path.join(REPO, "GEOM_r01.json")) as f:
        art = json.load(f)
    assert out["program_bound_tiered"] == art["program_bound_tiered"]
    t = out["arms"]["tiered"]
    assert t["tier_by_tenant"] == art["arms"]["tiered"]["tier_by_tenant"]
    assert t["tier_crossing"] == art["arms"]["tiered"]["tier_crossing"]
    assert t["tenant_classes"] == art["arms"]["tiered"]["tenant_classes"]
    assert set(out["grid"]) == set(art["grid"])


def test_scenario_plans_equal_jax():
    for ours, theirs in ((tscen.TIER1, scenarios.TIER1), (tscen.FULL, scenarios.FULL)):
        assert ours == {**theirs, "cfg": {k: v for k, v in theirs["cfg"].items()
                                          if k != "device"}}
    assert tscen.TIER1_BAND == scenarios.TIER1_BAND
    res = {"seed": 1, "cross_domain": {"in_domain": {"accuracy": 0.9},
                                       "by_shift": {"0.5": {"accuracy": 0.5},
                                                    "1e-05": {"accuracy": 0.7}},
                                       "da_mixture": {"accuracy": 0.6}},
           "nota": {"10": {"best": {"f1": 0.1}}, "2": {"best": {"f1": 0.8}}},
           "adversarial": {"clean": {"accuracy": 1.0}, "blank:1.0": {"accuracy": 0.3}},
           "grid": {"5w1s": {"accuracy": 0.6}}}
    assert tscen.tier1_headline(res) == scenarios.tier1_headline(res)


@pytest.mark.parametrize("seed", range(3))
def test_nota_operating_points_and_tau_grid_equal_jax(seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    gap = rng.normal(0, 2, 200)
    truth = rng.random(200) < 0.3
    taus = tscen.default_tau_grid(gap)
    assert taus == scenarios.default_tau_grid(gap)
    assert tscen.default_tau_grid(gap, points=5) == scenarios.default_tau_grid(gap, points=5)
    assert tscen.nota_operating_points(gap, truth, taus) == \
        scenarios.nota_operating_points(gap, truth, taus)
    assert tscen.nota_operating_points(gap, np.zeros(200, bool), [-100.0, 0.0]) == \
        scenarios.nota_operating_points(gap, np.zeros(200, bool), [-100.0, 0.0])


def _jax_init(seed):
    """The JAX trainer's initial weights for the tier-1 world at ``seed``
    (its first batch is drawn to initialize the state)."""
    w = scenarios.TIER1
    jcfg = jconfig.ExperimentConfig(**w["cfg"])
    vocab = jdata.make_synthetic_glove(vocab_size=jcfg.vocab_size - 2, word_dim=jcfg.word_dim)
    src = jdata.make_synthetic_fewrel(num_relations=w["num_relations"],
                                      instances_per_relation=w["instances_per_relation"],
                                      vocab_size=jcfg.vocab_size - 2, seed=seed)
    sampler = JaxSampler(src, jdata.GloveTokenizer(vocab, max_length=jcfg.max_length),
                         n=jcfg.n, k=jcfg.k, q=jcfg.q, batch_size=jcfg.batch_size,
                         na_rate=jcfg.na_rate, seed=seed + 1)
    support, query, _ = batch_to_model_inputs(sampler.sample_batch())
    state = init_state(jax_build(jcfg, glove_init=vocab.vectors), jcfg, support, query)
    return params_from_jax(jax.device_get(state.params["params"]))


def test_scenarios_tier1_within_the_jax_band(tmp_path):
    with open(os.path.join(REPO, "SCENARIOS_r01.json")) as f:
        t1 = json.load(f)["tier1"]
    seed = int(t1["seed"])
    logger = MetricsLogger(tmp_path, quiet=True)
    try:
        res = tscen.run_tier1(seed=seed, logger=logger, device="cpu",
                              init_params=_jax_init(seed))
    finally:
        logger.close()
    head = tscen.tier1_headline(res)
    band, f1_band = t1["band"]["accuracy_abs"], t1["band"]["f1_abs"]
    for key in ("in_domain_accuracy", "cross_domain_accuracy", "da_mixture_accuracy"):
        assert head[key] >= t1[key] - band, (key, head[key], t1[key])
    assert head["nota_best_f1"] >= t1["nota_best_f1"] - f1_band
    for spec, acc in t1["adversarial_accuracy"].items():
        assert head["adversarial_accuracy"][spec] >= acc - band, spec
    assert head["in_domain_accuracy"] >= head["cross_domain_accuracy"] + 0.2
    assert head["da_mixture_accuracy"] >= head["cross_domain_accuracy"] + 0.2
    assert set(head["grid"]) == {"2w1s", "2w2s", "5w1s", "5w2s"}
    assert res["cross_domain"]["da_mixture"]["mixture_counts"]["src"] > 0
    _, errors = obs_report.check_schema(tmp_path / "metrics.jsonl")
    assert errors == [], errors
    legs = obs_report.scenario_summary(obs_report.load_records(tmp_path / "metrics.jsonl"))
    assert legs["cross_domain_gap"] >= 0.2
