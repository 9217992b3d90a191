"""The port's serving plane vs the JAX package's (CPU, small widths).

The copied modules (geometry, breaker, batchers, stats, int8
quantization) run the same cases through the JAX function and the port's
copy. The registry and the engine run on weights carried over from a
JAX model (``interop.params_from_jax``): class matrices, publishes and
verdicts are held against the JAX ``TenantRegistry`` and
``InferenceEngine`` on the same inputs, per resident dtype and
scheduler. Then the engine's host behaviour under threads: deadlines,
shed-load, the breaker, containment, quarantine, and a publish under
in-flight traffic.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.config import resolve_geometry_policy as jax_geom_policy
from induction_network_on_fewrel_tpu.config import resolve_quant_policy as jax_quant_policy
from induction_network_on_fewrel_tpu.data import GloveTokenizer as JaxTokenizer
from induction_network_on_fewrel_tpu.data import make_synthetic_glove as jax_glove
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu.serving import batcher as jbatcher
from induction_network_on_fewrel_tpu.serving import breaker as jbreaker
from induction_network_on_fewrel_tpu.serving import geometry as jgeometry
from induction_network_on_fewrel_tpu.serving import stats as jstats
from induction_network_on_fewrel_tpu.serving.engine import InferenceEngine as JaxEngine
from induction_network_on_fewrel_tpu.serving.registry import TenantRegistry as JaxRegistry
from induction_network_on_fewrel_tpu.serving.registry import quant_artifact as jax_quant_artifact
from induction_network_on_fewrel_tpu.serving.registry import quantize_int8 as jax_quantize_int8
from induction_network_on_fewrel_tpu_torch.config import (
    ExperimentConfig,
    resolve_geometry_policy,
    resolve_quant_policy,
)
from induction_network_on_fewrel_tpu_torch.data import (
    GloveTokenizer,
    make_synthetic_fewrel,
    make_synthetic_glove,
)
from induction_network_on_fewrel_tpu_torch.interop import params_from_jax
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.serving import batcher, breaker, geometry, stats
from induction_network_on_fewrel_tpu_torch.serving.buckets import QueryRunner, zero_batch
from induction_network_on_fewrel_tpu_torch.serving.engine import NO_RELATION, InferenceEngine
from induction_network_on_fewrel_tpu_torch.serving.registry import (
    PublishError,
    TenantRegistry,
    quant_artifact,
    quantize_int8,
)

VOCAB, L, K = 80, 12, 3
SMALL = dict(
    vocab_size=VOCAB + 2, max_length=L, word_dim=10, pos_dim=2, lstm_hidden=16,
    att_dim=8, induction_dim=12, ntn_slices=6, k=K, compute_dtype="float32", na_rate=1,
)
TIERS = (4, 8, 16, 32, 64)
BUCKETS = (1, 2, 4)
# Logits of the port vs the JAX engine on the same weights, every resident
# dtype: the same resident values (bf16 rounds the same f32 vectors
# round-to-nearest-even in both; int8 quantizes them with the same
# function, and the int8 matrices come out equal on these weights) through
# f32 heads that differ by f32 rounding.
LOGIT_TOL = 1e-5


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
    tok = GloveTokenizer(make_synthetic_glove(vocab_size=VOCAB, word_dim=10), max_length=L)
    jtok = JaxTokenizer(jax_glove(vocab_size=VOCAB, word_dim=10), max_length=L)
    ds = make_synthetic_fewrel(num_relations=10, instances_per_relation=8, vocab_size=VOCAB,
                               sentence_len=(5, 16), seed=4)
    return dict(jcfg=jcfg, jmodel=jmodel, params=params, params2=params2, cfg=cfg,
                model=model, tok=tok, jtok=jtok, ds=ds)


def _queries(ds, names, per=2):
    return [i for n in names for i in ds.instances[n][K:K + per]]


def _engine(world, **kw):
    kw.setdefault("buckets", BUCKETS)
    kw.setdefault("start", False)
    return InferenceEngine(world["model"], world["cfg"], world["tok"], device="cpu", **kw)


def _drain(eng, futs):
    while not all(f.done() for f in futs):
        eng.batcher.drain_once(block_s=0.01)
    return [f.result() for f in futs]


# --- the copied modules -------------------------------------------------------


def _call(fn, *a):
    try:
        return ("ok", fn(*a))
    except ValueError as e:
        return ("error", str(e))


def test_geometry_equals_jax():
    for spec in (None, "", "off", "4,8,16,32,64", " 2,3 ", (1, 5), "4,4", "8,4", "0,2", "a,b"):
        assert _call(geometry.parse_tiers, spec) == _call(jgeometry.parse_tiers, spec), spec
    assert geometry.DEFAULT_TIERS == jgeometry.DEFAULT_TIERS
    for n in range(0, 70):
        assert _call(geometry.select_tier, n) == _call(jgeometry.select_tier, n)
        for tiers in (None, (), TIERS, (3, 9)):
            assert _call(geometry.tier_for, n, tiers) == _call(jgeometry.tier_for, n, tiers)
    stack = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    for tier in (3, 4, 8):
        np.testing.assert_array_equal(geometry.pad_class_stack(stack, tier),
                                      jgeometry.pad_class_stack(stack, tier))
    assert _call(geometry.pad_class_stack, stack, 2)[0] == "error"
    assert geometry.program_bound(TIERS, BUCKETS, 3) == jgeometry.program_bound(TIERS, BUCKETS, 3)
    assert geometry.tiers_spec(TIERS) == jgeometry.tiers_spec(TIERS)
    assert geometry.grid_key(10, 5) == jgeometry.grid_key(10, 5) == "10w5s"

    class Head:
        nota_head = "stats"
    assert geometry.supports_tiering(Head()) is jgeometry.supports_tiering(Head()) is False


def _breaker_trace(mod):
    clock = [100.0]
    seen = []
    br = mod.CircuitBreaker(failure_threshold=3, open_s=5.0, half_open_probes=2,
                            clock=lambda: clock[0],
                            on_transition=lambda t, f, to, n, now: seen.append((t, f, to, n, now)))
    out = []
    script = ["a", "f", "f", "s", "f", "f", "f", "a", "t1", "a", "f", "t6", "a", "a", "a", "f",
              "a", "t6", "a", "s", "a", "f"]
    for op in script:
        if op == "a":
            out.append(br.admit("x"))
            out.append(br.admit("y"))
        elif op == "f":
            br.record_failure("x")
        elif op == "s":
            br.record_success("x")
        else:
            clock[0] += float(op[1:])
        out.append(br.state("x"))
    br.reset("x")
    out.append(br.state("x"))
    return out, seen


def test_breaker_equals_jax_with_an_injected_clock():
    ours, seen = _breaker_trace(breaker)
    assert (ours, seen) == _breaker_trace(jbreaker)
    assert [s[1:3] for s in seen] == [("closed", "open"), ("open", "half_open"),
                                      ("half_open", "open"), ("open", "half_open"),
                                      ("half_open", "closed")]


def _continuous_order(mod):
    order = []

    def execute(group, batch):
        order.append((group, [r.query["i"] for r in batch]))
        for r in batch:
            r.future.set_result(r.query["i"])

    b = mod.ContinuousBatcher(execute, buckets=(1, 2, 4), max_queue_depth=64, start=False)
    futs = []
    plan = [("a", 30.0)] * 6 + [("b", 30.0)] * 3 + [("c", 0.012)] + [("b", 30.0)] * 4
    for i, (tenant, deadline) in enumerate(plan):
        futs.append(b.submit({"i": i}, deadline_s=deadline, tenant=tenant))
    while not all(f.done() for f in futs):
        b.drain_once(block_s=0.01)
    b.close()
    return order


def test_continuous_batcher_packing_equals_jax():
    """Deepest group first when nothing is urgent, the urgent head first,
    at most max(buckets) rows a launch: the same launches in both."""
    ours = _continuous_order(batcher)
    assert ours == _continuous_order(jbatcher)
    assert ours[0] == ("c", [9])


def _dynamic_sizes(mod):
    sizes = []

    def execute(batch):
        sizes.append([r.query["i"] for r in batch])
        for r in batch:
            r.future.set_result(None)

    b = mod.DynamicBatcher(execute, buckets=(1, 2, 4), batch_window_s=0.05, start=False)
    futs = [b.submit({"i": i}, deadline_s=30.0) for i in range(7)]
    while not all(f.done() for f in futs):
        b.drain_once(block_s=0.01)
    b.close()
    return sizes


def test_dynamic_batcher_packing_equals_jax():
    ours = _dynamic_sizes(batcher)
    assert ours == _dynamic_sizes(jbatcher) == [[0, 1, 2, 3], [4, 5, 6]]


def test_batcher_deadline_backpressure_and_shed_equal_jax():
    for mod, smod in ((batcher, stats), (jbatcher, jstats)):
        st = smod.ServingStats()
        b = mod.ContinuousBatcher(lambda g, batch: None, buckets=(1, 2), max_queue_depth=4,
                                  tenant_share=0.5, stats=st, start=False)
        expired = b.submit({"q": 0}, deadline_s=-0.01, tenant="a")
        assert b.drain_once() == 0
        with pytest.raises(mod.DeadlineExceeded):
            expired.result(timeout=1.0)
        b.submit({"q": 1}, deadline_s=5.0, tenant="a")
        b.submit({"q": 2}, deadline_s=5.0, tenant="b")
        b.submit({"q": 3}, deadline_s=5.0, tenant="a")
        with pytest.raises(mod.Saturated) as ei:       # tenant a over its share of 2
            b.submit({"q": 4}, deadline_s=5.0, tenant="a")
        assert ei.value.tenant == "a" and ei.value.retry_after_s > 0
        b.submit({"q": 5}, deadline_s=5.0, tenant="b")
        with pytest.raises(mod.Saturated) as ei:       # the global bound
            b.submit({"q": 6}, deadline_s=5.0, tenant="c")
        assert ei.value.tenant is None
        snap = st.snapshot(queue_depth=b.queue_depth)
        assert (snap["deadline_missed"], snap["shed"], snap["rejected"], snap["queue_depth"]) \
            == (1, 1, 2, 4)
        b.close()


def _feed_stats(mod):
    st = mod.ServingStats()
    rng = np.random.default_rng(3)
    st.bind_resident(lambda: {"a": 128.0, "b": 64.0})
    for i in range(3000):
        tenant = "ab"[i % 2]
        st.record_done(float(rng.exponential(0.004)), tenant=tenant, nota=bool(i % 7 == 0),
                       margin=float(rng.random()), entropy=float(rng.random()))
        if i % 5 == 0:
            st.record_batch(rows=1 + i % 4, bucket=4, exec_s=float(rng.random()) * 1e-3)
    st.record_rejected("a")
    st.record_shed("b")
    st.record_deadline_miss("a")
    st.record_execute_error("b", 3)
    st.record_breaker_shed("a")
    st.record_degraded("a", 2)
    st.record_swap()
    st.record_compile(True)
    st.record_compile(False)
    st.record_quant_probe("a", 0.75, 0.1, 4)
    return st


def test_stats_percentiles_and_snapshots_equal_jax():
    ours, theirs = _feed_stats(stats), _feed_stats(jstats)
    for q in (50, 90, 99):
        assert ours.percentile_ms(q) == theirs.percentile_ms(q)
    assert ours.snapshot(queue_depth=3) == theirs.snapshot(queue_depth=3)
    assert ours.tenant_snapshot() == theirs.tenant_snapshot()
    assert ours.quality_snapshot() == theirs.quality_snapshot()
    assert ours.exec_estimate_s() == theirs.exec_estimate_s()
    assert stats.nearest_rank([3.0, 1.0, 2.0], 50) == jstats.nearest_rank([3.0, 1.0, 2.0], 50)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_int8_bitwise_equal_jax(seed):
    rng = np.random.default_rng(seed)
    stacks = [rng.normal(size=(5, 12)).astype(np.float32),
              np.zeros((2, 12), np.float32),
              np.concatenate([rng.normal(size=(2, 12)) * 1e-4, [np.full(12, 50.0)]]).astype(
                  np.float32)]
    for stack in stacks:
        q, s = quantize_int8(stack)
        jq, js = jax_quantize_int8(stack)
        assert q.dtype == jq.dtype == np.int8 and q.tobytes() == jq.tobytes()
        assert np.float32(s).tobytes() == np.float32(js).tobytes()
        assert quant_artifact(stack, q) == jax_quant_artifact(stack, jq)


def test_policy_resolvers_equal_jax():
    class Knobs:
        resident_dtype, quant_probe_every, geometry_tiers, geometry_tier_spread = (
            None, None, None, None)

    for base in (None, ExperimentConfig(resident_dtype="bf16", geometry_tiers="off")):
        jbase = None if base is None else JaxConfig(resident_dtype="bf16", geometry_tiers="off")
        assert resolve_quant_policy(Knobs(), base) == jax_quant_policy(Knobs(), jbase)
        # The fleet's tier_spread is ported with the fleet: the whole policy.
        assert resolve_geometry_policy(Knobs(), base) == jax_geom_policy(Knobs(), jbase)
    bad = Knobs()
    bad.resident_dtype = "fp8"
    with pytest.raises(ValueError, match="resident_dtype"):
        resolve_quant_policy(bad)


# --- the registry -------------------------------------------------------------


def _registries(world, dtype):
    reg = TenantRegistry(world["model"], world["tok"], k=K, resident_dtype=dtype, tiers=TIERS)
    jreg = JaxRegistry(world["jmodel"], {"params": world["params"]}, world["jtok"], k=K,
                       resident_dtype=dtype, tiers=TIERS)
    for r in (reg, jreg):
        r.register_dataset(world["ds"], max_classes=3, tenant="a")
        r.register_dataset(world["ds"], max_classes=6, tenant="b")
    return reg, jreg


def _assert_resident_equal(snap, jsnap, dtype):
    mat, jmat = snap.matrix, np.asarray(jsnap.matrix)
    assert tuple(mat.shape) == jmat.shape and snap.n_tier == jsnap.n_tier
    assert snap.names == jsnap.names and snap.resident_dtype == jsnap.resident_dtype == dtype
    if dtype == "int8":
        assert mat.dtype == torch.int8
        assert int(np.abs(mat.numpy().astype(np.int32) - jmat.astype(np.int32)).max()) <= 1
        np.testing.assert_allclose(snap.scale, jsnap.scale, rtol=1e-5)
    elif dtype == "bf16":
        assert mat.dtype == torch.bfloat16
        # One bf16 ulp (2^-8 relative) at most, from f32 vectors ~1e-7 apart.
        np.testing.assert_allclose(mat.float().numpy(), jmat.astype(np.float32),
                                   rtol=2 ** -8, atol=1e-6)
    else:
        np.testing.assert_allclose(mat.numpy(), jmat, rtol=1e-5, atol=1e-5)
    if dtype != "f32":
        np.testing.assert_allclose(snap.shadow, jsnap.shadow, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_registry_matrices_equal_jax(world, dtype):
    reg, jreg = _registries(world, dtype)
    for tenant, n, tier in (("a", 3, 4), ("b", 6, 8)):
        snap, jsnap = reg.snapshot(tenant), jreg.snapshot(tenant)
        assert snap.n_classes == n and snap.n_tier == tier
        assert not snap.matrix[n:].float().any()                  # zero pad rows
        _assert_resident_equal(snap, jsnap, dtype)
        assert (snap.version, snap.params_version) == (jsnap.version, jsnap.params_version)
    assert reg.resident_bytes() == jreg.resident_bytes()


def test_registry_slot_pool_shared_and_cow(world):
    reg, jreg = _registries(world, "f32")
    # Tenant b's first 3 classes are tenant a's supports: one slot each.
    assert reg.pool_size() == jreg.pool_size() == 6
    assert reg.snapshot("a").slots == reg.snapshot("b").slots[:3]
    pinned = reg.snapshot("a")
    reg.set_nota_threshold(0.5, tenant="a")
    assert reg.snapshot("a").matrix is pinned.matrix and pinned.nota_threshold is None
    clone = reg.clone_tenant("a", "c")
    assert clone.matrix is pinned.matrix and clone.slots == pinned.slots
    reg.unregister(reg.snapshot("b").names[-1], tenant="b")
    jreg.unregister(jreg.snapshot("b").names[-1], tenant="b")
    assert reg.pool_size() == jreg.pool_size() == 5
    reg.drop_tenant("c")
    with pytest.raises(ValueError, match="no classes registered"):
        reg.snapshot("c")
    for r in (reg, jreg):       # register_tokens validates its rows as the JAX registry does
        with pytest.raises(ValueError, match="at least one instance"):
            r.register_tokens("x", [])


def test_publish_params_equals_jax_publish(world):
    reg, jreg = _registries(world, "f32")
    assert reg.snapshot("a").bank == 0
    assert reg.publish_params(params_from_jax(world["params2"])) == 1
    assert jreg.publish_params({"params": world["params2"]}) == 1
    for tenant in ("a", "b"):
        snap, jsnap = reg.snapshot(tenant), jreg.snapshot(tenant)
        assert snap.bank == 1 and snap.params_version == 1
        _assert_resident_equal(snap, jsnap, "f32")
        assert snap.version == jsnap.version
    assert reg.pool_size() == jreg.pool_size()
    # The second publish returns to bank 0.
    assert reg.publish_params(params_from_jax(world["params"])) == 2
    assert reg.snapshot("a").bank == 0


def test_publish_refusals_leave_the_old_snapshots(world):
    reg, _ = _registries(world, "int8")
    before = {t: reg.snapshot(t) for t in reg.tenants()}
    bad = params_from_jax(world["params2"])
    bad["encoder.w_hh"] = bad["encoder.w_hh"].clone()
    bad["encoder.w_hh"][0, 0, 0] = float("nan")
    with pytest.raises(PublishError, match="non-finite params at encoder.w_hh"):
        reg.publish_params(bad)
    reg.publish_canary = lambda p: (_ for _ in ()).throw(RuntimeError("canary veto"))
    with pytest.raises(PublishError, match="canary veto"):
        reg.publish_params(params_from_jax(world["params2"]))
    reg.publish_canary = None
    txn = reg.prepare_publish(params_from_jax(world["params2"]))
    txn.abort()
    assert reg.params_version == 0 and reg.active == 0
    assert {t: reg.snapshot(t) for t in reg.tenants()} == before
    # The serial lock was released: a clean publish commits.
    assert reg.publish_params(params_from_jax(world["params2"])) == 1


# --- the engine on the CPU ------------------------------------------------------


@pytest.fixture(scope="module")
def jax_verdicts(world):
    """JAX engine verdicts on 8 queries of tenant a (3 classes, tier 4), per
    resident dtype."""
    eng = JaxEngine(world["jmodel"], {"params": world["params"]}, world["jcfg"], world["jtok"],
                    k=K, buckets=BUCKETS, start=False, geometry_tiers="4,8,16,32,64")
    try:
        names = eng.register_dataset(world["ds"], max_classes=3, tenant="a")
        out = {}
        for dtype in ("f32", "bf16", "int8"):
            eng.set_resident_dtype("a", dtype)
            futs = [eng.submit(vars(q), deadline_s=60.0, tenant="a")
                    for q in _queries(world["ds"], names, per=3)[:8]]
            while not all(f.done() for f in futs):
                eng.batcher.drain_once(block_s=0.01)
            out[dtype] = [f.result() for f in futs]
        return out
    finally:
        eng.close()


def _logit_rows(verdicts):
    return np.array([list(v["logits"].values()) for v in verdicts])


@pytest.mark.parametrize("scheduler", ["continuous", "microbatch"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_engine_verdicts_equal_jax(world, jax_verdicts, dtype, scheduler):
    eng = _engine(world, scheduler=scheduler, resident_dtype=dtype)
    try:
        names = eng.register_dataset(world["ds"], max_classes=3, tenant="a")
        eng.warmup()
        futs = [eng.submit(q, deadline_s=60.0, tenant="a")
                for q in _queries(world["ds"], names, per=3)[:8]]
        got = _drain(eng, futs)
        want = jax_verdicts[dtype]
        assert [list(v["logits"]) for v in got] == [list(v["logits"]) for v in want]
        assert set(got[0]["logits"]) == set(names) | {NO_RELATION}
        np.testing.assert_allclose(_logit_rows(got), _logit_rows(want), rtol=0, atol=LOGIT_TOL)
        # int8 included: held to the verdicts the JAX int8 path gives on
        # these weights, not to an agreement bar against f32.
        assert [v["label"] for v in got] == [v["label"] for v in want]
        assert [v["nota"] for v in got] == [v["nota"] for v in want]
        assert eng.stats.snapshot()["steady_recompiles"] == 0
    finally:
        eng.close()


def test_engine_deadline_and_saturation(world):
    eng = _engine(world, max_queue_depth=2)
    try:
        names = eng.register_dataset(world["ds"], max_classes=3)
        q = _queries(world["ds"], names)[0]
        expired = eng.submit(q, deadline_s=-0.01)
        assert eng.batcher.drain_once() == 0
        with pytest.raises(batcher.DeadlineExceeded):
            expired.result(timeout=1.0)
        eng.submit(q)
        eng.submit(q)
        with pytest.raises(batcher.Saturated) as ei:
            eng.submit(q)
        assert ei.value.retry_after_s > 0
        snap = eng.stats.snapshot()
        assert (snap["deadline_missed"], snap["rejected"]) == (1, 1)
    finally:
        eng.close()


def test_engine_contains_failures_and_the_breaker_sheds(world):
    """A failing execution fails only its batch with a typed ExecuteError
    and feeds the breaker; at the threshold the tenant sheds at submit
    while another tenant serves; after the open window one probe admits
    and its success closes the breaker."""
    clock = [0.0]
    br = breaker.CircuitBreaker(failure_threshold=2, open_s=5.0, clock=lambda: clock[0])
    eng = _engine(world, breaker=br)
    try:
        names = eng.register_dataset(world["ds"], max_classes=3, tenant="a")
        eng.register_dataset(world["ds"], max_classes=6, tenant="b")
        eng.warmup()
        q = _queries(world["ds"], names)[0]
        real_run, failing = eng.programs.run, [2]

        def run(bank, mat, query, scale=None):
            if failing[0] > 0 and mat.shape[0] == 4:     # tenant a's tier
                failing[0] -= 1
                raise RuntimeError("device fell over")
            return real_run(bank, mat, query, scale=scale)

        eng.programs.run = run
        for _ in range(2):
            fut = eng.submit(q, tenant="a")
            eng.batcher.drain_once()
            with pytest.raises(batcher.ExecuteError, match="device fell over") as ei:
                fut.result(timeout=1.0)
            assert ei.value.tenant == "a" and ei.value.retry_after_s == 5.0
        assert br.state("a") == "open"
        with pytest.raises(batcher.Saturated) as ei:
            eng.submit(q, tenant="a")
        assert ei.value.tenant == "a"
        assert _drain(eng, [eng.submit(q, tenant="b")])[0]["tenant"] == "b"
        clock[0] += 5.1
        v = _drain(eng, [eng.submit(q, tenant="a")])[0]          # the half-open probe
        assert v["label"] in names or v["label"] == NO_RELATION
        assert br.state("a") == "closed"
        snap = eng.stats.snapshot()
        assert (snap["execute_errors"], snap["breaker_shed"]) == (2, 1)
    finally:
        eng.close()


def test_engine_quarantine_serves_degraded_verdicts(world):
    eng = _engine(world)
    try:
        names = eng.register_dataset(world["ds"], max_classes=3, tenant="a")
        eng.warmup()
        q = _queries(world["ds"], names)[0]
        batches = eng.stats.snapshot()["batches"]
        eng.quarantine_tenant("a", reason="drill")
        v = _drain(eng, [eng.submit(q, tenant="a")])[0]
        assert v["degraded"] is True and v["label"] == NO_RELATION and v["logits"] == {}
        assert eng.stats.snapshot()["batches"] == batches
        assert eng.stats.snapshot()["degraded"] == 1
        eng.unquarantine_tenant("a")
        assert "degraded" not in _drain(eng, [eng.submit(q, tenant="a")])[0]
        # A committed publish also clears a quarantine.
        eng.quarantine_tenant("a", reason="again")
        eng.publish_params(params_from_jax(world["params"]))
        assert "degraded" not in _drain(eng, [eng.submit(q, tenant="a")])[0]
        assert eng.stats.snapshot()["steady_recompiles"] == 0
    finally:
        eng.close()


def _probe_records(eng) -> list:
    """Record every parity-probe outcome (agreement, margin drift, rows)
    the engine hands its stats, unrounded."""
    records, real = [], eng.stats.record_quant_probe

    def record(tenant, agreement, margin_drift, rows):
        records.append((agreement, margin_drift, rows))
        real(tenant, agreement, margin_drift, rows)

    eng.stats.record_quant_probe = record
    return records


def _loud(params, gain: float = 1e6):
    """``params`` with the relation head's output weights scaled by
    ``gain``. Fresh flax inits put the logits near 1e-6, where the
    verdicts' margins (rounded to 1e-6) cannot see int8 rounding; scaled,
    the logits are O(1) and quantization moves the margins visibly."""
    out = jax.tree_util.tree_map(np.asarray, params)
    dense = dict(out["relation"]["Dense_0"], kernel=out["relation"]["Dense_0"]["kernel"] * gain)
    return dict(out, relation=dict(out["relation"], Dense_0=dense))


def test_engine_parity_probe_counts_agreement(world):
    """The int8 parity probe against the JAX engine's on the same weights,
    queries and batches: one probe per batch, the same agreement and the
    same margin drift. The drift is nonzero, so the probe scored against
    the f32 shadow and not the int8 matrix it checks (which reads 0)."""
    tiers = "4,8,16,32,64"
    params = _loud(world["params"])
    model = build_model(world["cfg"], device="cpu")
    model.load_state_dict(params_from_jax(params))
    eng = InferenceEngine(model, world["cfg"], world["tok"], device="cpu", buckets=BUCKETS,
                          start=False, resident_dtype="int8", quant_probe_every=1,
                          geometry_tiers=tiers)
    jeng = JaxEngine(world["jmodel"], {"params": params}, world["jcfg"], world["jtok"],
                     k=K, buckets=BUCKETS, start=False, geometry_tiers=tiers,
                     resident_dtype="int8", quant_probe_every=1)
    try:
        names = eng.register_dataset(world["ds"], max_classes=3)
        assert jeng.register_dataset(world["ds"], max_classes=3) == names
        made = eng.warmup()
        assert made == 2 * len(BUCKETS)              # int8 and its f32 shadow
        jeng.warmup()
        got, want = _probe_records(eng), _probe_records(jeng)
        queries = _queries(world["ds"], names, per=3)[:9]
        for lo, hi in ((0, 4), (4, 7), (7, 8), (8, 9)):     # batches of 4, 3, 1, 1
            _drain(eng, [eng.submit(q) for q in queries[lo:hi]])
            jfuts = [jeng.submit(vars(q), deadline_s=60.0) for q in queries[lo:hi]]
            while not all(f.done() for f in jfuts):
                jeng.batcher.drain_once(block_s=0.01)
        assert len(got) == len(want) == 4
        assert [(a, r) for a, _, r in got] == [(a, r) for a, _, r in want]
        np.testing.assert_allclose([d for _, d, _ in got], [d for _, d, _ in want],
                                   rtol=0, atol=LOGIT_TOL)
        assert min(d for _, d, _ in want) > 10 * LOGIT_TOL
        snap, jsnap = eng.stats.snapshot(), jeng.stats.snapshot()
        assert snap["quant_probes"] == jsnap["quant_probes"] == 4
        assert snap["quant_agreement"] == jsnap["quant_agreement"]
        assert snap["steady_recompiles"] == 0
        assert snap["resident_bytes"] == 4 * SMALL["induction_dim"] + 4
    finally:
        eng.close()
        jeng.close()


def test_publish_under_in_flight_traffic_pins_snapshots(world):
    """Threaded engine: a client keeps two tenants busy while the main
    thread publishes new weights. Nothing drops, nothing is made after
    warmup, and every verdict's logits are the eager scoring of its query
    on its snapshot's own weights and matrix."""
    eng = _engine(world, start=True)
    try:
        eng.register_dataset(world["ds"], max_classes=3, tenant="a")
        eng.register_dataset(world["ds"], max_classes=6, tenant="b")
        eng.warmup()
        made = eng.programs.compiles
        snaps = {s.version: s for s in (eng.registry.snapshot(t) for t in ("a", "b"))}
        pools = {t: _queries(world["ds"], eng.registry.names_for(t), per=1) for t in "ab"}
        results, errors, stop = [], [], threading.Event()

        def client():
            i = 0
            while not stop.is_set():
                tenant = "ab"[i % 2]
                q = pools[tenant][i % len(pools[tenant])]
                try:
                    results.append((q, eng.classify(q, deadline_s=30.0, tenant=tenant)))
                except Exception as e:  # noqa: BLE001 — any error is a drop
                    errors.append(e)
                i += 1

        th = threading.Thread(target=client)
        th.start()
        try:
            while len(results) < 6:
                time.sleep(0.01)
            old_sd = {k: v.clone() for k, v in eng.registry.model.state_dict().items()}
            new_sd = params_from_jax(world["params2"])
            eng.publish_params(new_sd)
            snaps.update({s.version: s for s in (eng.registry.snapshot(t) for t in "ab")})
            n_before = len(results)
            while len(results) < n_before + 6:
                time.sleep(0.01)
        finally:
            stop.set()
            th.join()
        assert errors == []
        assert eng.programs.compiles == made and eng.stats.steady_compiles == 0
        pv = {snaps[v["snapshot_version"]].params_version for _, v in results}
        assert pv == {0, 1}
        ref = build_model(world["cfg"], device="cpu")
        for version_pv, sd in ((0, old_sd), (1, new_sd)):
            ref.load_state_dict(sd)
            runner = QueryRunner(ref)
            for q, v in results:
                snap = snaps[v["snapshot_version"]]
                if snap.params_version != version_pv:
                    continue
                t = eng.tokenizer(q)
                row = runner.run(snap.matrix, {k: np.asarray(getattr(t, k))[None]
                                               for k in ("word", "pos1", "pos2", "mask")})[0]
                np.testing.assert_allclose(list(v["logits"].values()),
                                           list(row[:snap.n_classes]) + [row[-1]],
                                           rtol=1e-5, atol=1e-5)
    finally:
        eng.close()
