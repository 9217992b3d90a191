"""dp-sharded query scoring in the port against the JAX serving mesh.

The counterpart of the JAX ``tests/test_serving_fleet.py``
``test_dp_sharded_scoring_parity``: the same weights (``interop``) and the
same registered tenant go through the port's engine at ``dp=2`` over two
CPU shard devices (``make_serving_mesh``'s ``devices`` seam) and the JAX
engine at ``dp=2`` on two of its forced host devices, bucket 8: equal
labels and every logit within 1e-5 (the JAX bar), no steady-state
compile on either. Then the port's own rules: a bucket that does not
divide runs the single-device program, every dtype scores as the dp=None
engine does, a publish loads every shard replica and scores as the
dp=None engine after the same publish, and the mesh refuses more devices
than there are.
"""

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
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.serving.buckets import (
    ShardedQuery,
    make_serving_mesh,
    zero_batch,
)
from induction_network_on_fewrel_tpu_torch.serving.engine import InferenceEngine

VOCAB, L, K = 80, 12, 3
SMALL = dict(
    vocab_size=VOCAB + 2, max_length=L, word_dim=10, pos_dim=2, lstm_hidden=16,
    att_dim=8, induction_dim=12, ntn_slices=6, k=K, compute_dtype="float32", na_rate=1,
)
CPU2 = ("cpu", "cpu")
TOL = 1e-5


def _sharpen(params, f: float = 30.0):
    """The fresh init's class and query projections scaled by ``f``: its
    logits are ~1e-6 (near-uniform verdicts), these ~0.4, so the 1e-5 bar
    and the labels mean something."""
    p = dict(params)
    p["induction"] = {"Dense_0": {**p["induction"]["Dense_0"],
                                  "kernel": p["induction"]["Dense_0"]["kernel"] * f}}
    p["query_proj"] = {**p["query_proj"], "kernel": p["query_proj"]["kernel"] * f}
    return p


@pytest.fixture(scope="module")
def world():
    jcfg = JaxConfig(**SMALL, lstm_backend="scan", attn_backend="xla")
    jmodel = jax_build_model(jcfg)
    zeros = zero_batch(L, (1, 1, 1))
    init = jax.jit(jmodel.init)
    params, params2 = (_sharpen(init(jax.random.key(s), zeros, {k: v[:, 0] for k, v in
                                                              zeros.items()})["params"])
                       for s in (1, 7))
    cfg = ExperimentConfig(**SMALL)
    tok = GloveTokenizer(make_synthetic_glove(vocab_size=VOCAB, word_dim=10), max_length=L)
    jtok = JaxTokenizer(jax_glove(vocab_size=VOCAB, word_dim=10), max_length=L)
    ds = make_synthetic_fewrel(num_relations=5, instances_per_relation=8, vocab_size=VOCAB,
                               sentence_len=(5, 16), seed=4)
    queries = [ds.instances[r][-1] for r in ds.rel_names] + \
        [ds.instances[r][-2] for r in ds.rel_names[:3]]            # 8 rows
    return dict(jcfg=jcfg, jmodel=jmodel, params=params, params2=params2, cfg=cfg, tok=tok,
                jtok=jtok, ds=ds, queries=queries)


def _engine(world, **kw):
    model = build_model(world["cfg"], device="cpu")
    model.load_state_dict(params_from_jax(world["params"]))
    kw.setdefault("buckets", (8,))
    return InferenceEngine(model, world["cfg"], world["tok"], device="cpu", start=False, **kw)


def _serve(eng, insts):
    futs = [eng.submit(i, deadline_s=30.0) for i in insts]
    while not all(f.done() for f in futs):
        eng.batcher.drain_once(block_s=0.01)
    return [f.result() for f in futs]


def _logits(verdicts):
    return np.array([[v["logits"][n] for n in sorted(v["logits"])] for v in verdicts])


def test_dp2_engine_matches_the_jax_dp2_mesh(world):
    jeng = JaxEngine(world["jmodel"], {"params": world["params"]}, world["jcfg"], world["jtok"],
                     k=K, buckets=(8,), start=False, dp=2)
    eng = _engine(world, dp=2, devices=CPU2)
    try:
        assert jeng.programs._mesh is not None and eng.mesh == [torch.device("cpu")] * 2
        assert jeng.register_dataset(world["ds"]) == eng.register_dataset(world["ds"])
        jeng.warmup()
        assert eng.warmup() == 1
        got = _serve(eng, world["queries"])
        want = _serve(jeng, [vars(q) for q in world["queries"]])
        assert [v["label"] for v in got] == [v["label"] for v in want]
        np.testing.assert_allclose(_logits(got), _logits(want), rtol=0, atol=TOL)
        assert eng.stats.steady_compiles == 0 and jeng.stats.steady_compiles == 0
        progs = eng.programs.get(8, eng.registry.snapshot().matrix.shape[1], 8, L)
        assert all(isinstance(p, ShardedQuery) and len(p.progs) == 2 for p in progs)
        assert [m.device for m in eng.registry.shards[1]] == [torch.device("cpu")] * 2
    finally:
        eng.close()
        jeng.close()


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_dp2_scores_as_the_single_device_engine(world, dtype):
    """Buckets 1 (does not divide: the single-device program) and 8 (two
    shards of 4 rows), at every resident dtype."""
    one = _engine(world, buckets=(1, 8), resident_dtype=dtype)
    two = _engine(world, buckets=(1, 8), resident_dtype=dtype, dp=2, devices=CPU2)
    try:
        for e in (one, two):
            e.register_dataset(world["ds"])
            e.warmup()
        n, c = two.registry.snapshot().matrix.shape
        kinds = {b: type(two.programs.get(n, c, b, L, dtype)[0]).__name__ for b in (1, 8)}
        assert kinds == {1: "QueryRunner", 8: "ShardedQuery"}
        for rows in (world["queries"][:1], world["queries"]):
            a, b = _serve(one, rows), _serve(two, rows)
            assert [v["label"] for v in a] == [v["label"] for v in b]
            assert {v["bucket"] for v in b} == {len(rows)}
            np.testing.assert_allclose(_logits(b), _logits(a), rtol=0, atol=TOL)
        assert two.stats.steady_compiles == 0 and two.programs.compiles == one.programs.compiles
    finally:
        one.close()
        two.close()


def test_publish_under_dp_loads_every_shard_and_scores_as_single(world):
    one = _engine(world)
    two = _engine(world, dp=2, devices=CPU2)
    try:
        for e in (one, two):
            e.register_dataset(world["ds"])
            e.warmup()
        before = _logits(_serve(two, world["queries"]))
        new = params_from_jax(world["params2"])
        assert one.publish_params(new) == two.publish_params(new) == 1
        snap = two.registry.snapshot()
        for replica in two.registry.shards[snap.bank]:
            for k, v in replica.state_dict().items():
                torch.testing.assert_close(v, new[k].to(v.dtype), rtol=0, atol=0, msg=k)
        a, b = _serve(one, world["queries"]), _serve(two, world["queries"])
        assert [v["label"] for v in a] == [v["label"] for v in b]
        np.testing.assert_allclose(_logits(b), _logits(a), rtol=0, atol=TOL)
        assert np.abs(_logits(b) - before).max() > 1e-2          # the new weights score
        assert two.stats.steady_compiles == 0
    finally:
        one.close()
        two.close()


def test_serving_mesh_guards(world):
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"serving dp={visible + 1} exceeds the {visible} "
                                         "visible devices"):
        make_serving_mesh(visible + 1)
    assert make_serving_mesh(2, devices=("cpu", "cpu", "cpu")) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="serving dp=3 exceeds the 2 visible devices"):
        make_serving_mesh(3, devices=CPU2)
    with pytest.raises(ValueError, match="exceeds"):
        _engine(world, dp=max(2, visible + 1))
