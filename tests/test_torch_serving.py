"""Torch port serving core vs the JAX package (CPU, small widths).

Synthetic fixtures and the tokenizer are copies, so a seed gives identical
data in both packages. The port's engine, on weights carried over from a
JAX model, registers a corpus and answers queries with the logits the JAX
model's ``class_vectors`` / ``score_queries`` give on the same rows.
"""

import jax
import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.data import GloveTokenizer as JaxTokenizer
from induction_network_on_fewrel_tpu.data import make_synthetic_fewrel as jax_fewrel
from induction_network_on_fewrel_tpu.data import make_synthetic_glove as jax_glove
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.data import (
    GloveTokenizer,
    make_synthetic_fewrel,
    make_synthetic_glove,
)
from induction_network_on_fewrel_tpu_torch.interop import params_from_jax
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.serving import cli
from induction_network_on_fewrel_tpu_torch.serving.buckets import (
    QUERY_DTYPES,
    pad_rows,
    select_bucket,
    stack_queries,
    zero_batch,
)
from induction_network_on_fewrel_tpu_torch.serving.engine import NO_RELATION, InferenceEngine

VOCAB, L, K = 80, 12, 3
SMALL = dict(
    vocab_size=VOCAB + 2, max_length=L, word_dim=10, pos_dim=2, lstm_hidden=16,
    att_dim=8, induction_dim=12, ntn_slices=6, k=K, compute_dtype="float32",
)
VERDICT_KEYS = {
    "label", "class_index", "nota", "margin", "entropy", "tenant",
    "snapshot_version", "logits", "latency_ms", "bucket",
}


def _corpus(make):
    return make(num_relations=4, instances_per_relation=8, vocab_size=VOCAB,
                sentence_len=(5, 16), seed=4)


@pytest.fixture(scope="module")
def setup():
    """JAX model + params, and a port engine on the same weights."""
    na_rate = 1
    jcfg = JaxConfig(**SMALL, na_rate=na_rate, lstm_backend="scan", attn_backend="xla")
    jmodel = jax_build_model(jcfg)
    zeros = zero_batch(L, (1, 1, 1))
    params = jax.jit(jmodel.init)(jax.random.key(1), zeros,
                                  {k: v[:, 0] for k, v in zeros.items()})["params"]
    vocab = make_synthetic_glove(vocab_size=VOCAB, word_dim=SMALL["word_dim"])
    tok = GloveTokenizer(vocab, max_length=L)
    cfg = ExperimentConfig(**SMALL, na_rate=na_rate)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    engine = InferenceEngine(model, cfg, tok, device="cpu", buckets=(1, 2, 4))
    ds = _corpus(make_synthetic_fewrel)
    names = engine.register_dataset(ds, max_classes=3)
    apply = jax.jit(jmodel.apply, static_argnames="method")
    return dict(jmodel=jmodel, params=params, apply=apply, tok=tok, engine=engine,
                ds=ds, names=names)


def _rows(tok, instances):
    ts = [tok(i) for i in instances]
    return {k: np.stack([getattr(t, k) for t in ts]).astype(dt)
            for k, dt in QUERY_DTYPES.items()}


def test_synthetic_fixtures_equal_jax():
    jv, tv = jax_glove(vocab_size=VOCAB, word_dim=10, seed=2), make_synthetic_glove(
        vocab_size=VOCAB, word_dim=10, seed=2)
    assert jv.word2id == tv.word2id
    np.testing.assert_array_equal(jv.vectors, tv.vectors)
    jd, td = _corpus(jax_fewrel), _corpus(make_synthetic_fewrel)
    assert jd.rel_names == td.rel_names
    for rel in jd.rel_names:
        assert [vars(i) for i in jd.instances[rel]] == [vars(i) for i in td.instances[rel]]


def test_tokenizer_equal_jax():
    jv = jax_glove(vocab_size=VOCAB, word_dim=10)
    jt, tt = JaxTokenizer(jv, max_length=L), GloveTokenizer(
        make_synthetic_glove(vocab_size=VOCAB, word_dim=10), max_length=L)
    ds = _corpus(make_synthetic_fewrel)
    insts = [i for rel in ds.rel_names for i in ds.instances[rel]]
    insts.append(insts[0].__class__(tokens=("UNSEEN",) * 30, head_pos=(29,), tail_pos=()))
    for inst in insts:
        a, b = jt(inst), tt(inst)
        for key in ("word", "pos1", "pos2", "mask"):
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key))


def test_engine_logits_match_jax_class_vectors_and_score_queries(setup):
    s = setup
    eng, ds, names, v = s["engine"], s["ds"], s["names"], {"params": s["params"]}
    assert eng.class_names == tuple(names) == tuple(ds.rel_names[:3])
    sup = {k: a.reshape(1, len(names), K, L) for k, a in _rows(
        s["tok"], [i for n in names for i in ds.instances[n][:K]]).items()}
    jcv = s["apply"](v, sup, method="class_vectors")
    # The 3 classes are resident on the 4-row tier: a zero pad row follows.
    mat = eng.registry.snapshot().matrix.numpy()
    assert mat.shape[0] == 4 and not mat[len(names):].any()
    np.testing.assert_allclose(mat[:len(names)], np.asarray(jcv)[0], rtol=1e-5, atol=1e-5)
    queries = [i for n in names for i in ds.instances[n][K:K + 2]]     # 6 rows
    verdicts = eng.classify_batch(queries)
    assert [vd["bucket"] for vd in verdicts] == [4] * 4 + [2] * 2
    got = np.array([[vd["logits"][n] for n in names] + [vd["logits"][NO_RELATION]]
                    for vd in verdicts])
    qry = {k: a[None] for k, a in _rows(s["tok"], queries).items()}
    want = np.asarray(s["apply"](v, jcv, qry, method="score_queries"))[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bucket_padding_leaves_live_rows_unchanged(setup):
    eng, ds, names = setup["engine"], setup["ds"], setup["names"]
    queries = [ds.instances[n][K + 3] for n in names]                 # 3 rows -> bucket 4
    batched = eng.classify_batch(queries)
    single = [eng.classify(q) for q in queries]                       # bucket 1 each
    assert {vd["bucket"] for vd in batched} == {4}
    assert {vd["bucket"] for vd in single} == {1}
    for a, b in zip(batched, single):
        np.testing.assert_allclose(
            list(a["logits"].values()), list(b["logits"].values()), rtol=1e-6, atol=1e-6)
        assert a["label"] == b["label"]


def test_verdict_fields_and_nota_threshold(setup):
    eng, ds, names = setup["engine"], setup["ds"], setup["names"]
    q = ds.instances[names[0]][K + 4]
    vd = eng.classify(q)
    assert set(vd) == VERDICT_KEYS
    assert set(vd["logits"]) == set(names) | {NO_RELATION}
    assert vd["tenant"] == "default" and vd["snapshot_version"] == 1
    best = max(names, key=lambda n: vd["logits"][n])
    assert vd["nota"] == (vd["logits"][NO_RELATION] > vd["logits"][best])
    assert vd["label"] == (NO_RELATION if vd["nota"] else best)
    # The threshold biases the NOTA logit: a huge bias forces no_relation.
    eng.set_nota_threshold(1e6)
    try:
        forced = eng.classify(q)
        assert forced["nota"] and forced["label"] == NO_RELATION
        assert forced["class_index"] == -1 and forced["snapshot_version"] == 2
    finally:
        eng.set_nota_threshold(None)


def test_tenants_are_independent(setup):
    eng, ds = setup["engine"], setup["ds"]
    eng.register_class(ds.rel_names[3], ds.instances[ds.rel_names[3]][:2], tenant="t2")
    snap = eng.registry.snapshot("t2")
    assert snap.names == (ds.rel_names[3],) and snap.k == K
    assert eng.registry.snapshot().names == tuple(setup["names"])
    assert eng.classify(ds.instances[ds.rel_names[3]][5], tenant="t2")["tenant"] == "t2"
    with pytest.raises(ValueError, match="no classes registered"):
        eng.classify(ds.instances[ds.rel_names[3]][5], tenant="nobody")


def test_bucket_helpers():
    assert [select_bucket(n) for n in (1, 2, 3, 5, 16)] == [1, 2, 4, 8, 16]
    with pytest.raises(ValueError):
        select_bucket(17)
    with pytest.raises(ValueError):
        select_bucket(0)
    a = np.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(pad_rows(a, 5), np.array([[0, 1], [2, 3], [4, 5], [0, 1], [0, 1]]))
    q = {"word": np.ones(L), "pos1": np.ones(L), "pos2": np.ones(L), "mask": np.ones(L)}
    st = stack_queries([q, q], 4)
    assert {k: (v.shape, v.dtype) for k, v in st.items()} == {
        k: ((4, L), np.dtype(dt)) for k, dt in QUERY_DTYPES.items()}


def test_engine_device_rule_and_model_check(setup):
    cfg = ExperimentConfig(**SMALL)
    model = setup["engine"].model
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            InferenceEngine(model, cfg, setup["tok"])
    with pytest.raises(ValueError, match="--model induction"):
        InferenceEngine(model, cfg.replace(model="proto"), setup["tok"], device="cpu")


def test_cli_demo_runs_on_cpu(capsys):
    assert cli.main(["--N", "3", "--K", "2", "--num_queries", "5", "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert len(lines) == 5 and "demo accuracy" in err
