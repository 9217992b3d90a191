"""The port's adaptation loop against the JAX package's.

* ``resolve_adapt_policy`` and ``parse_canary_plan`` agree over a grid of
  inputs, errors included; ``canary_verdict`` and ``floors_from_headline``
  give equal dicts.
* The controller, with stub train/canary/publish functions, a stub drift
  detector and an injected clock, walks the same states and writes the
  same ``kind="adapt"`` records in both packages for every arm: success
  and cooldown, canary failure, injected train/canary/publish faults,
  publish refusal, a drift re-trip and an expired window (rollback),
  exhaustion and the journaled latch.
* ``mixture_finetune`` from the same weights (``interop.py``) over the
  same mixture stream gives the JAX losses within the trajectory bar
  (rtol 2e-4); a budget breach removes the candidate.
* The port's drill at the JAX drill world's config and seed (the JAX
  artifact's), from the JAX world's initial weights, passes the JAX
  ``check_adapt_drill``.
"""

import json
import os
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import induction_network_on_fewrel_tpu.config as jconfig
import induction_network_on_fewrel_tpu.obs.adapt as jadapt
import induction_network_on_fewrel_tpu.obs.chaos as jchaos
import induction_network_on_fewrel_tpu.utils.metrics as jmetrics
import induction_network_on_fewrel_tpu_torch.config as tconfig
import induction_network_on_fewrel_tpu_torch.obs.adapt as tadapt
import induction_network_on_fewrel_tpu_torch.obs.chaos as tchaos
import induction_network_on_fewrel_tpu_torch.utils.metrics as tmetrics
from induction_network_on_fewrel_tpu_torch.obs import canary

_TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
if _TOOLS not in sys.path:
    sys.path.insert(0, _TOOLS)

import loadgen  # noqa: E402
import scenarios  # noqa: E402

PKGS = {"jax": SimpleNamespace(config=jconfig, adapt=jadapt, chaos=jchaos, metrics=jmetrics),
        "port": SimpleNamespace(config=tconfig, adapt=tadapt, chaos=tchaos, metrics=tmetrics)}


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except (ValueError, TypeError) as e:
        return ("error", type(e).__name__, str(e))


# --- knobs ------------------------------------------------------------------------


CANARY_SPECS = ["", "off", "in_domain:0.3", " in_domain:0.3 , target:0.25 ", "grid_5w2s:0.3",
                "in_domain", "in_domain:1.5", "in_domain:-0.1", "a:0.1,a:0.2", ":0.3",
                "in_domain:x", "in_domain:0.3,", "target:1"]


@pytest.mark.parametrize("spec", CANARY_SPECS)
def test_parse_canary_plan_equals_jax(spec):
    assert _outcome(tconfig.parse_canary_plan, spec) == \
        _outcome(jconfig.parse_canary_plan, spec)


POLICIES = [
    {}, {"adapt": True}, {"adapt": True, "adapt_retries": 5, "adapt_canary": "off"},
    {"adapt": True, "adapt_retries": 0}, {"adapt": True, "adapt_backoff_s": 0.0},
    {"adapt": True, "adapt_cooldown_s": -1.0}, {"adapt": True, "adapt_step_budget": 0},
    {"adapt": True, "adapt_wall_s": 1.5, "adapt_verify_s": 2.5, "adapt_canary": "target:0.2"},
    {"adapt": True, "adapt_canary": "bad"}, {"adapt": None}, {"adapt": False, "adapt_retries": 0},
]


@pytest.mark.parametrize("knobs", POLICIES, ids=[json.dumps(p) for p in POLICIES])
@pytest.mark.parametrize("base", [None, {"adapt": True, "adapt_retries": 7,
                                         "adapt_canary": "in_domain:0.5"}])
def test_resolve_adapt_policy_equals_jax(knobs, base):
    got = _outcome(tconfig.resolve_adapt_policy, SimpleNamespace(**knobs),
                   tconfig.ExperimentConfig(**base) if base else None)
    want = _outcome(jconfig.resolve_adapt_policy, SimpleNamespace(**knobs),
                    jconfig.ExperimentConfig(**base) if base else None)
    assert got == want


def test_geometry_policy_with_tier_spread_equals_jax():
    for knobs in ({}, {"geometry_tier_spread": 2, "geometry_tiers": "off"},
                  {"geometry_tier_spread": -1}, {"geometry_tiers": "4,8"}):
        assert _outcome(tconfig.resolve_geometry_policy, SimpleNamespace(**knobs)) == \
            _outcome(jconfig.resolve_geometry_policy, SimpleNamespace(**knobs))


def test_canary_verdict_and_floors_equal_jax():
    legs = {"in_domain": {"accuracy": 0.7}, "target": {"accuracy": 0.4},
            "extra": {"accuracy": 0.1}, "grid_5w2s": {"accuracy": None}}
    for floors in ({}, {"in_domain": 0.6}, {"in_domain": 0.6, "target": 0.5},
                   {"missing": 0.2, "grid_5w2s": 0.3}):
        assert canary.canary_verdict(legs, floors) == scenarios.canary_verdict(legs, floors)
    head = {"in_domain_accuracy": 0.9, "cross_domain_accuracy": 0.05, "da_mixture_accuracy": "x",
            "grid": {"5w1s": 0.8, "10w5s": 0.4, "bad": None}}
    assert canary.floors_from_headline(head) == scenarios.floors_from_headline(head)
    assert canary.floors_from_headline(head, {"accuracy_abs": 0.5}) == \
        scenarios.floors_from_headline(head, {"accuracy_abs": 0.5})


# --- the controller's state machine --------------------------------------------------


class _Stub:
    def __init__(self):
        self.train_ok = self.canary_ok = self.publish_ok = True
        self.trained, self.version, self.log = 0, 0, []

    def train(self, tenant, attempt, step_budget, wall_budget_s):
        self.trained += 1
        self.log.append(("train", tenant, attempt, step_budget))
        if not self.train_ok:
            raise RuntimeError("stub fine-tune failure")
        return f"cand_{self.trained}"

    def canary(self, candidate):
        self.log.append(("canary", candidate))
        return {"passed": self.canary_ok, "failures": [] if self.canary_ok else ["below"]}

    def publish(self, candidate):
        self.log.append(("publish", candidate))
        if not self.publish_ok:
            raise RuntimeError("stub publish refusal")
        self.version += 1
        return self.version

    def cleanup(self, candidate):
        self.log.append(("cleanup", candidate))

    def quarantine(self, tenant, reason=""):
        self.log.append(("quarantine", tenant, reason))


class _Drift:
    """The controller's view of a detector, programmable."""

    band_sigma, baseline_n, nota_rate_floor = 4.0, 16, 0.05

    def __init__(self):
        self.on_event = None
        self.is_armed = False
        self.base = {"nota_rate": (0.0, 0.01)}

    def armed(self, tenant):
        return self.is_armed

    def baseline_for(self, tenant):
        return self.base


def _critical(pkg, tenant="t0"):
    from importlib import import_module

    health = import_module(pkg.adapt.__name__.rsplit(".", 1)[0] + ".health")
    return health.HealthEvent(event="prediction_drift", severity=health.CRITICAL, step=0,
                              message="drift", data={"tenant": tenant, "feature": "nota_rate"})


def _controller_arms(pkg, tmp_path):
    """Every arm on one clock; returns the states, the stub's calls and the
    controller's records."""
    A = pkg.adapt
    run = tmp_path / pkg.adapt.__name__.split(".")[0]
    logger = pkg.metrics.MetricsLogger(run, quiet=True)
    stub, drift = _Stub(), _Drift()
    ctl = A.AdaptationController(stub.train, stub.canary, stub.publish, drift=drift,
                                 current_fn=lambda: "live", cleanup_fn=stub.cleanup,
                                 quarantine_fn=stub.quarantine, retry_budget=3, backoff_s=10.0,
                                 cooldown_s=100.0, verify_window_s=50.0, step_budget=7,
                                 wall_budget_s=30.0, logger=logger)
    states = []

    def note(tag):
        states.append((tag, ctl.state_of("t0"), ctl.loop_info("t0")["attempts"]))

    # Success: trigger via the detector's event, attempt, verify, cooldown.
    drift.on_event(_critical(pkg))
    note("trigger")
    ctl.run_once(now=0.0)
    note("published")
    ctl.tick(now=1.0)
    note("not armed yet")
    drift.is_armed = True
    ctl.tick(now=2.0)
    note("verified")
    note_absorbed = ctl.trigger("t0", now=50.0)
    ctl.tick(now=200.0)
    note(f"cooled {note_absorbed}")
    # Canary failure, then an injected train fault, then backoff.
    drift.is_armed = False
    ctl.trigger("t0", now=201.0)
    stub.canary_ok = False
    ctl.run_once(now=201.0)
    note("canary failed")
    assert ctl.run_once(now=205.0) is None
    stub.canary_ok = True
    pkg.chaos.install(pkg.chaos.ChaosRegistry.parse("adapt.train_raise@0:t0"))
    try:
        ctl.run_once(now=212.0)
    finally:
        pkg.chaos.install(None)
    note("train fault")
    # A publish refusal; then an injected canary failure exhausts the budget.
    stub.publish_ok = False
    ctl.run_once(now=300.0)
    note("publish refused")
    stub.publish_ok = True
    pkg.chaos.install(pkg.chaos.ChaosRegistry.parse("adapt.canary_fail@0:t0"))
    try:
        ctl.run_once(now=400.0)
    finally:
        pkg.chaos.install(None)
    note("exhausted")
    note(f"absorbed {ctl.trigger('t0', now=500.0)}")
    # Another tenant: a re-trip in the window rolls back; an expired one too.
    ctl.trigger("t1", now=600.0)
    ctl.run_once(now=600.0)
    drift.on_event(_critical(pkg, "t1"))
    ctl.tick(now=601.0)
    states.append(("t1 retrip", ctl.state_of("t1"), ctl.loop_info("t1")["attempts"]))
    pkg.chaos.install(pkg.chaos.ChaosRegistry.parse("adapt.publish_raise@0:t1"))
    try:
        ctl.run_once(now=700.0)
    finally:
        pkg.chaos.install(None)
    states.append(("t1 publish fault", ctl.state_of("t1"), ctl.loop_info("t1")["attempts"]))
    ctl.run_once(now=800.0)
    ctl.tick(now=900.0)
    states.append(("t1 expired", ctl.state_of("t1"), ctl.loop_info("t1")["attempts"]))
    ctl2 = A.AdaptationController(stub.train, None, stub.publish)
    ctl2.restore_exhausted({"t0": 3.0})
    states.append(("restored", ctl2.state_of("t0"), ctl2.trigger("t0"), ctl2.trigger("t2")))
    ctl.close()
    logger.close()
    recs = [json.loads(ln) for ln in (run / "metrics.jsonl").read_text().splitlines()]
    recs = [{k: v for k, v in r.items() if not k.endswith("_s") and k != "t_unix"}
            for r in recs]
    return {"states": states, "calls": stub.log, "records": recs,
            "events": [(e.event, e.severity, e.data) for e in ctl.events]}


def test_controller_arms_equal_jax(tmp_path):
    theirs = _controller_arms(PKGS["jax"], tmp_path)
    ours = _controller_arms(PKGS["port"], tmp_path)
    assert ours == theirs
    assert ("verified", "cooldown", 0) in ours["states"]
    assert ("exhausted", "exhausted", 3) in ours["states"]
    assert [(e[0], e[2]["tenant"]) for e in ours["events"]] == [("adapt_exhausted", "t0"),
                                                                 ("adapt_exhausted", "t1")]
    assert {r["action"] for r in ours["records"] if r.get("kind") == "adapt"} >= {
        "trigger", "train", "canary", "publish", "verified", "rollback", "exhausted"}


# --- the fine-tune -----------------------------------------------------------------


SMALL = dict(vocab_size=62, max_length=12, word_dim=10, pos_dim=2, lstm_hidden=16, att_dim=8,
             induction_dim=12, ntn_slices=6, routing_iters=2, n=3, train_n=3, k=2, q=2,
             batch_size=2, na_rate=1, compute_dtype="float32", loss="ce", lr=2e-3,
             val_step=0, seed=3)
FT_STEPS = 6


def _corpora(pkg_data):
    src = pkg_data.make_synthetic_fewrel(num_relations=5, instances_per_relation=10,
                                         vocab_size=60, sentence_len=(6, 12), seed=2)
    tgt = pkg_data.make_domain_shifted_fewrel(num_relations=5, instances_per_relation=10,
                                              vocab_size=60, sentence_len=(6, 12), shift=1.0,
                                              seed=2)
    return src, tgt


def _losses(run) -> list:
    return [json.loads(ln)["loss"] for ln in (run / "metrics.jsonl").read_text().splitlines()
            if json.loads(ln).get("kind") == "train"]


def test_mixture_finetune_matches_jax(tmp_path):
    import induction_network_on_fewrel_tpu.data as jdata
    import induction_network_on_fewrel_tpu_torch.data as tdata
    from induction_network_on_fewrel_tpu.models import build_model as jax_build
    from induction_network_on_fewrel_tpu.serving.buckets import zero_batch
    from induction_network_on_fewrel_tpu.train.checkpoint import CheckpointManager as JaxCkpt
    from induction_network_on_fewrel_tpu.train.finetune import mixture_finetune as jax_ft
    from induction_network_on_fewrel_tpu.train.steps import init_state
    from induction_network_on_fewrel_tpu_torch.interop import params_from_jax
    from induction_network_on_fewrel_tpu_torch.models.build import build_model
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager
    from induction_network_on_fewrel_tpu_torch.train.finetune import mixture_finetune
    from induction_network_on_fewrel_tpu_torch.train.steps import make_optimizer

    jcfg = jconfig.ExperimentConfig(**SMALL, device="cpu")
    jmodel = jax_build(jcfg)
    state = init_state(jmodel, jcfg, zero_batch(12, (1, 3, 2)), zero_batch(12, (1, jcfg.total_q)))
    mgr = JaxCkpt(tmp_path / "jax_base", jcfg)
    mgr.save(0, jax.device_get(state), val_accuracy=0.0)
    mgr.wait()
    mgr.close()
    cfg = tconfig.ExperimentConfig(**SMALL)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(state.params["params"])))
    tmgr = CheckpointManager(tmp_path / "port_base", cfg, stage="off")
    tmgr.save(0, model, make_optimizer(cfg, model), val_accuracy=0.0)
    tmgr.close()
    jsrc, jtgt = _corpora(jdata)
    tsrc, ttgt = _corpora(tdata)
    jtok = jdata.GloveTokenizer(jdata.make_synthetic_glove(60, 10), max_length=12)
    ttok = tdata.GloveTokenizer(tdata.make_synthetic_glove(60, 10), max_length=12)
    jlog = jmetrics.MetricsLogger(tmp_path / "jlog", quiet=True)
    jax_ft(str(tmp_path / "jax_base"), str(tmp_path / "jax_cand"), jsrc, jtgt, jtok,
           steps=FT_STEPS, wall_budget_s=600.0, seed=5, chunk=1, logger=jlog)
    jlog.close()
    tlog = tmetrics.MetricsLogger(tmp_path / "tlog", quiet=True)
    out = mixture_finetune(str(tmp_path / "port_base"), str(tmp_path / "port_cand"), tsrc, ttgt,
                           ttok, steps=FT_STEPS, wall_budget_s=600.0, seed=5, chunk=1,
                           logger=tlog, device="cpu")
    tlog.close()
    want, got = _losses(tmp_path / "jlog"), _losses(tmp_path / "tlog")
    assert len(got) == len(want) == FT_STEPS
    np.testing.assert_allclose(got, want, rtol=2e-4)
    restored = CheckpointManager(out).params("latest")
    assert all(torch.isfinite(v).all() for v in restored.values())


def test_budget_breach_removes_the_candidate(tmp_path):
    from induction_network_on_fewrel_tpu_torch.data import (
        GloveTokenizer,
        make_synthetic_glove,
    )
    from induction_network_on_fewrel_tpu_torch.models.build import build_model
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager
    from induction_network_on_fewrel_tpu_torch.train.finetune import (
        AdaptTrainTimeout,
        mixture_finetune,
    )
    from induction_network_on_fewrel_tpu_torch.train.steps import make_optimizer
    import induction_network_on_fewrel_tpu_torch.data as tdata

    cfg = tconfig.ExperimentConfig(**SMALL)
    model = build_model(cfg, device="cpu")
    mgr = CheckpointManager(tmp_path / "base", cfg, stage="off")
    mgr.save(0, model, make_optimizer(cfg, model), val_accuracy=0.0)
    mgr.close()
    src, tgt = _corpora(tdata)
    tok = GloveTokenizer(make_synthetic_glove(60, 10), max_length=12)
    cand = tmp_path / "cand"
    with pytest.raises(AdaptTrainTimeout, match="wall budget"):
        mixture_finetune(str(tmp_path / "base"), str(cand), src, tgt, tok, steps=4,
                         wall_budget_s=1e-9, device="cpu")
    assert not cand.exists()
    with pytest.raises(ValueError):
        mixture_finetune(str(tmp_path / "base"), str(cand), src, tgt, tok, steps=0,
                         wall_budget_s=1.0, device="cpu")


# --- the drill ------------------------------------------------------------------------


def test_port_drill_passes_the_jax_gate():
    """The JAX drill world (``loadgen.ADAPT_WORLD``) at the seed of the JAX
    drill artifact (``ADAPT_r01.json``), from the JAX trainer's initial
    weights: the port's success and failure arms pass ``check_adapt_drill``."""
    import induction_network_on_fewrel_tpu.data as jdata
    from induction_network_on_fewrel_tpu.models import build_model as jax_build
    from induction_network_on_fewrel_tpu.models.build import batch_to_model_inputs
    from induction_network_on_fewrel_tpu.sampling import EpisodeSampler as JaxSampler
    from induction_network_on_fewrel_tpu.train.steps import init_state
    from induction_network_on_fewrel_tpu_torch.interop import params_from_jax
    from induction_network_on_fewrel_tpu_torch.obs import adapt_drill

    assert adapt_drill.ADAPT_WORLD == {**loadgen.ADAPT_WORLD, "cfg": {
        k: v for k, v in loadgen.ADAPT_WORLD["cfg"].items() if k != "device"}}
    with open(os.path.join(os.path.dirname(_TOOLS), "ADAPT_r01.json")) as f:
        seed = json.load(f)["seed"]
    w = loadgen.ADAPT_WORLD
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
    drill = adapt_drill.adapt_drill(seed=seed, device="cpu",
                                    init_params=params_from_jax(jax.device_get(
                                        state.params["params"])))
    assert loadgen.check_adapt_drill(drill), json.dumps(
        {k: drill[k] for k in ("success", "canary_failure")}, default=str)
    assert drill["passed"]
