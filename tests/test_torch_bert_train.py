"""Training, checkpoints, the feeds and serving on the BERT paths (CPU).

At the tiny BERT width of ``tests/test_torch_bert.py`` (2 layers, hidden
32, 4 heads, FFN 64, 500 ids), f32:

* 20-step trajectories against JAX ``make_train_step`` from the JAX
  ``init_state`` weights on the same 20 batches (losses rtol 2e-4, final
  parameters atol 1e-3) for the induction head over BERT fine-tuned and
  frozen, and for BERT-PAIR. Frozen: the JAX chain's coupled decay moves
  the backbone although its loss gradient is zero; the port, whose
  backbone has no ``grad``, moves it the same way.
* ``cli train --encoder bert`` then ``--resume`` equals the uninterrupted
  run (full ring saves: no word table, so no delta), and ``cli test``.
* ``--token_cache`` with BERT: the table's rows are the tokenizer's, and
  the CLI trains on it.
* the C++ sampler's batches with the BERT tokenizer equal the JAX native
  sampler's, bitwise (g++ builds both on the CPU).
* the serving engine on a ``cli train`` BERT checkpoint: class vectors and
  served logits against the JAX ``class_vectors``/``score_queries`` on the
  checkpoint's weights.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import json

import jax
import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.data import make_synthetic_fewrel as jax_fewrel
from induction_network_on_fewrel_tpu.data.bert_tokenizer import BertTokenizer as JaxTokenizer
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu.models.build import batch_to_model_inputs as jax_inputs
from induction_network_on_fewrel_tpu.native.sampler import NativeEpisodeSampler as JaxNative
from induction_network_on_fewrel_tpu.sampling.episodes import EpisodeSampler as JaxSampler
from induction_network_on_fewrel_tpu.train.steps import init_state, make_train_step
from induction_network_on_fewrel_tpu_torch import cli
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.data import BertTokenizer, make_synthetic_fewrel
from induction_network_on_fewrel_tpu_torch.interop import params_from_jax, params_to_jax
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.sampling.native import NativeEpisodeSampler
from induction_network_on_fewrel_tpu_torch.serving.engine import InferenceEngine
from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager
from induction_network_on_fewrel_tpu_torch.train.steps import make_optimizer, train_step
from induction_network_on_fewrel_tpu_torch.train.token_cache import build_token_table

L = 16
BERT = dict(encoder="bert", bert_layers=2, bert_hidden=32, bert_heads=4, bert_intermediate=64,
            bert_vocab_size=500, max_length=L, induction_dim=8, ntn_slices=4,
            compute_dtype="float32", loss="ce", optimizer="adam", lr=2e-3, weight_decay=1e-4,
            grad_clip=1.0, lr_step_size=7, lr_gamma=0.5)
CASES = {
    "induction_finetuned": dict(model="induction", bert_frozen=False, train_n=3, n=3, k=2, q=2,
                                batch_size=2),
    "induction_frozen": dict(model="induction", bert_frozen=True, train_n=3, n=3, k=2, q=2,
                             batch_size=2),
    "pair": dict(model="pair", bert_frozen=False, train_n=3, n=3, k=1, q=1, na_rate=1,
                 batch_size=2),
}
STEPS = 20
TINY_ARGV = ["--synthetic", "--device", "cpu", "--N", "3", "--K", "2", "--Q", "2",
             "--batch_size", "2", "--max_length", "16", "--encoder", "bert", "--bert_layers",
             "2", "--bert_hidden", "32", "--bert_heads", "4", "--bert_intermediate", "64",
             "--bert_vocab_size", "500", "--induction_dim", "8", "--ntn_slices", "4",
             "--sampler", "python", "--prefetch_depth", "0"]


def _jax_batches(kw: dict) -> list:
    ds = jax_fewrel(num_relations=7, instances_per_relation=8, vocab_size=300,
                    sentence_len=(5, 20), seed=2)
    s = JaxSampler(ds, JaxTokenizer(max_length=L, vocab_size=500), kw["n"], kw["k"], kw["q"],
                   batch_size=kw["batch_size"], na_rate=kw.get("na_rate", 0), seed=7)
    return [jax_inputs(s.sample_batch()) for _ in range(STEPS)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_trajectory_matches_jax_train_step(case):
    kw = dict(BERT, **CASES[case])
    batches = _jax_batches(kw)
    jcfg = JaxConfig(**kw)
    jmodel = jax_build_model(jcfg)
    state = init_state(jmodel, jcfg, batches[0][0], batches[0][1])
    p0 = params_from_jax(jax.device_get(state.params["params"]))
    step = jax.jit(make_train_step(jmodel, jcfg))
    cfg = ExperimentConfig(**kw)
    tmodel = build_model(cfg, device="cpu")
    tmodel.load_state_dict(p0)
    opt = make_optimizer(cfg, tmodel)
    for support, query, label in batches:
        state, jm = step(state, support, query, label)
        tm = train_step(tmodel, opt, cfg, support, query, label)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-4)
    want = params_from_jax(jax.device_get(state.params["params"]))
    got = tmodel.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=1e-3, err_msg=name)
    backbone = [n for n in want if "backbone." in n and n.endswith("weight")]
    moved = max(float((want[n] - p0[n]).abs().max()) for n in backbone)
    assert moved > 0.5 * cfg.lr        # fine-tuned by its gradient; frozen by the decay alone


def _params(path) -> dict:
    return torch.load(path, weights_only=True)["params"]


def test_cli_bert_resume_equals_uninterrupted_run_then_test(tmp_path, capsys):
    run = ["train", *TINY_ARGV, "--val_step", "2", "--val_iter", "4"]
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    assert cli.main([*run, "--train_iter", "4", "--save_ckpt", one]) == 0
    assert cli.main([*run, "--train_iter", "2", "--save_ckpt", two]) == 0
    assert cli.main([*run, "--train_iter", "2", "--save_ckpt", two, "--resume"]) == 0
    files = sorted(p.name for p in (tmp_path / "two").iterdir())
    assert "latest.pt" in files and "ring_base.pt" not in files and "ring_delta.pt" not in files
    a, b = _params(tmp_path / "one" / "latest.pt"), _params(tmp_path / "two" / "latest.pt")
    assert set(a) == set(b) and not any("word_embedding" in n for n in a)
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert CheckpointManager.load_config(two).encoder == "bert"
    capsys.readouterr()
    assert cli.main(["test", *TINY_ARGV, "--load_ckpt", two, "--test_iter", "8"]) == 0
    assert 0.0 <= json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "test_accuracy"] <= 1.0


def test_token_cache_with_bert(tmp_path, capsys):
    ds = make_synthetic_fewrel(num_relations=6, instances_per_relation=8, vocab_size=300)
    tok = BertTokenizer(max_length=L, vocab_size=500)
    table = build_token_table(ds, tok, "cpu")
    rows = [inst for rel in ds.rel_names for inst in ds.instances[rel]]
    idx = torch.tensor([[0, 5], [17, 47]])
    got = table.gather(idx)
    for i, j in np.ndindex(*idx.shape):
        t = tok(rows[int(idx[i, j])])
        np.testing.assert_array_equal(got["word"][i, j].numpy(), t.word)
        np.testing.assert_array_equal(got["mask"][i, j].numpy(), t.mask.astype(np.int8))
    assert cli.main(["train", *TINY_ARGV, "--token_cache", "--train_iter", "4", "--val_step",
                     "2", "--val_iter", "4", "--save_ckpt", str(tmp_path / "tc")]) == 0
    assert "final_val_accuracy" in capsys.readouterr().out


@pytest.mark.parametrize("na_rate", [0, 1])
def test_native_sampler_bert_stream_equals_jax(na_rate):
    ds = make_synthetic_fewrel(num_relations=8, instances_per_relation=12, vocab_size=300)
    jds = jax_fewrel(num_relations=8, instances_per_relation=12, vocab_size=300)
    ours = NativeEpisodeSampler(ds, BertTokenizer(max_length=L, vocab_size=500), 4, 2, 2,
                                batch_size=2, na_rate=na_rate, seed=5)
    theirs = JaxNative(jds, JaxTokenizer(max_length=L, vocab_size=500), 4, 2, 2, batch_size=2,
                       na_rate=na_rate, seed=5)
    try:
        for _ in range(6):
            for x, y in zip(ours.sample_batch(), theirs.sample_batch()):
                x, y = np.asarray(x), np.asarray(y)
                assert x.dtype == y.dtype and np.array_equal(x, y)
    finally:
        ours.close()
        theirs.close()


def test_engine_serves_a_bert_checkpoint(tmp_path):
    ckpt = str(tmp_path / "serve")
    assert cli.main(["train", *TINY_ARGV, "--train_iter", "2", "--val_step", "2", "--val_iter",
                     "4", "--save_ckpt", ckpt]) == 0
    eng = InferenceEngine.from_checkpoint(ckpt, device="cpu", start=False)
    try:
        assert isinstance(eng.tokenizer, BertTokenizer)
        ds = make_synthetic_fewrel(num_relations=3, instances_per_relation=10, vocab_size=300,
                                   seed=9)
        names = eng.register_dataset(ds)
        cfg = eng.cfg
        jcfg = JaxConfig.from_json((tmp_path / "serve" / "config.json").read_text())
        jmodel = jax_build_model(jcfg)
        v = {"params": params_to_jax(CheckpointManager(ckpt).params("best"))}
        tok = eng.tokenizer

        def rows(insts, lead):
            ts = [tok(i) for i in insts]
            return {k: np.stack([getattr(t, k) for t in ts]).reshape(*lead, -1)
                    for k in ("word", "pos1", "pos2", "mask")}

        sup = rows([i for n in names for i in ds.instances[n][:cfg.k]], (1, len(names), cfg.k))
        jcv = np.asarray(jmodel.apply(v, sup, method="class_vectors"))[0]
        mat = eng.registry.snapshot().matrix.numpy()
        np.testing.assert_allclose(mat[:len(names)], jcv, rtol=1e-5, atol=1e-5)
        queries = [i for n in names for i in ds.instances[n][cfg.k:cfg.k + 2]]
        verdicts = eng.classify_batch(queries)
        got = np.array([[vd["logits"][n] for n in names] for vd in verdicts])
        want = np.asarray(jmodel.apply(v, jcv[None], rows(queries, (1, len(queries))),
                                       method="score_queries"))[0]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    finally:
        eng.close()
