"""The port's frozen-BERT feature cache vs the JAX package's (CPU).

At the tiny BERT width of ``tests/test_torch_bert.py`` under a narrow
induction head (N=3, K=2, Q=2, B=2, L=16), f32:

* ``encode_dataset``: the port's per-relation blocks against the JAX
  ``encode_dataset`` on the same weights (``interop``), within 1e-5 of
  scale, with a ragged last chunk.
* ``FeatureEpisodeSampler``: its stream (features and labels) equal to the
  JAX feature-mode sampler's, bitwise, NOTA queries included.
* the head-only state: the cached model's leaves are the JAX head-only
  ``init_state`` tree's, name for name, with no backbone leaf.
* a 20-step cached trajectory (``train/steps.py``'s step over a
  ``FeatureTable`` source) against JAX ``make_cached_train_step``: losses
  rtol 2e-4, final parameters atol 1e-3.
* ``cli train --feature_cache`` then ``cli test`` on its checkpoint (the
  backbone rebuilt from the seed, the test split re-encoded); a test run
  with another ``--seed`` is refused by name.
* refusals by name: a cache off BERT, off the frozen backbone, with
  ``--model pair``, with ``--token_cache``; the serving engine refuses a
  cached checkpoint.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.data import make_synthetic_fewrel as jax_fewrel
from induction_network_on_fewrel_tpu.data.bert_tokenizer import BertTokenizer as JaxTokenizer
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu.models.build import batch_to_model_inputs as jax_inputs
from induction_network_on_fewrel_tpu.sampling.episodes import EpisodeSampler as JaxSampler
from induction_network_on_fewrel_tpu.train import feature_cache as jfc
from induction_network_on_fewrel_tpu.train.steps import init_state
from induction_network_on_fewrel_tpu_torch import cli
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.data import BertTokenizer, make_synthetic_fewrel
from induction_network_on_fewrel_tpu_torch.interop import params_from_jax, params_to_jax
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.sampling.index import IndexEpisodeSampler
from induction_network_on_fewrel_tpu_torch.serving.engine import InferenceEngine
from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager
from induction_network_on_fewrel_tpu_torch.train.feature_cache import (
    FeatureEpisodeSampler,
    FeatureTable,
    encode_dataset,
)
from induction_network_on_fewrel_tpu_torch.train.steps import make_optimizer, make_train_step

L = 16
CFG = dict(encoder="bert", bert_frozen=True, feature_cache=True, bert_layers=2,
           bert_hidden=32, bert_heads=4, bert_intermediate=64, bert_vocab_size=500,
           max_length=L, train_n=3, n=3, k=2, q=2, batch_size=2, induction_dim=8,
           ntn_slices=4, compute_dtype="float32", loss="ce", optimizer="adam", lr=2e-3,
           weight_decay=1e-4, grad_clip=1.0, lr_step_size=7, lr_gamma=0.5)
STEPS = 20
DATA = dict(num_relations=6, instances_per_relation=9, vocab_size=300, sentence_len=(5, 20),
            seed=3)
TINY_ARGV = ["--synthetic", "--device", "cpu", "--N", "3", "--K", "2", "--Q", "2",
             "--batch_size", "2", "--max_length", "16", "--encoder", "bert", "--bert_layers",
             "2", "--bert_hidden", "32", "--bert_heads", "4", "--bert_intermediate", "64",
             "--bert_vocab_size", "500", "--induction_dim", "8", "--ntn_slices", "4",
             "--sampler", "python"]


@pytest.fixture(scope="module")
def setup():
    """JAX: the full model, its init params, the head-only state, the
    blocks ``encode_dataset`` gives; port: the backbone's full model on the
    same weights, the head model on the state's head."""
    jcfg = JaxConfig(**CFG)
    jmodel = jax_build_model(jcfg)
    jds = jax_fewrel(**DATA)
    jtok = JaxTokenizer(max_length=L, vocab_size=500)
    sup, qry, _ = jax_inputs(JaxSampler(jds, jtok, 3, 2, 2, 2, seed=0).sample_batch())
    full = jmodel.init(jax.random.key(0), sup, qry)
    H = jcfg.bert_hidden
    state = init_state(jmodel, jcfg, np.zeros((2, 3, 2, H), np.float32),
                       np.zeros((2, 6, H), np.float32))
    jblocks = jfc.encode_dataset(jmodel, full, jds, jtok, batch_size=16)
    cfg = ExperimentConfig(**CFG)
    encoder = build_model(cfg.replace(feature_cache=False), device="cpu")
    encoder.load_state_dict(params_from_jax(jax.device_get(full["params"])))
    head = build_model(cfg, device="cpu")
    return {"jcfg": jcfg, "jmodel": jmodel, "state": state, "jblocks": jblocks, "cfg": cfg,
            "encoder": encoder, "head": head}


def test_encode_dataset_matches_jax(setup):
    tds = make_synthetic_fewrel(**DATA)
    blocks = encode_dataset(setup["encoder"], tds, BertTokenizer(max_length=L, vocab_size=500),
                            batch_size=16)
    jblocks = setup["jblocks"]
    assert [b.shape for b in blocks] == [b.shape for b in jblocks] == [(9, 32)] * 6
    got, want = np.concatenate(blocks), np.concatenate(jblocks)     # 54 rows: ragged last chunk
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("na_rate", [0, 1])
def test_feature_sampler_stream_bitwise(setup, na_rate):
    blocks = [np.asarray(b) for b in setup["jblocks"]]
    ours = FeatureEpisodeSampler(blocks, 3, 2, 2, batch_size=2, na_rate=na_rate, seed=5)
    theirs = jfc.FeatureEpisodeSampler(blocks, 3, 2, 2, batch_size=2, na_rate=na_rate, seed=5)
    for _ in range(10):
        a, b = ours.sample_batch(), theirs.sample_batch()
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
    fused = ours.sample_fused(3)
    assert [x.shape for x in fused] == [(3, 2, 3, 2, 32), (3, 2, 2 * (3 + na_rate), 32),
                                        (3, 2, 2 * (3 + na_rate))]


def test_head_only_state_matches_jax_tree(setup):
    head, state = setup["head"], setup["state"]
    names = [n for n, _ in head.named_parameters()]
    assert not [n for n in names if "backbone" in n or n.startswith(("encoder.", "embedding."))]
    tree = params_to_jax(head.state_dict())
    want = jax.device_get(state.params["params"])
    shapes = lambda t: {jax.tree_util.keystr(p): v.shape  # noqa: E731
                        for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    assert shapes(tree) == shapes(want)
    assert len(list(head.parameters())) == len(make_optimizer(setup["cfg"], head).params) == 7
    with pytest.raises(ValueError, match="feature-cache model holds the episode head alone"):
        head.encode(*(torch.zeros(1, L, dtype=torch.int32) for _ in range(4)))


def test_cached_trajectory_matches_jax(setup):
    jcfg, jmodel, cfg = setup["jcfg"], setup["jmodel"], setup["cfg"]
    blocks = setup["jblocks"]
    flat = np.concatenate(blocks).astype(np.float32)
    sizes = [b.shape[0] for b in blocks]
    sampler = IndexEpisodeSampler(sizes, 3, 2, 2, batch_size=2, seed=9)
    batches = [tuple(sampler.sample_batch()) for _ in range(STEPS)]
    state = setup["state"]
    head = build_model(cfg, device="cpu")
    head.load_state_dict(params_from_jax(jax.device_get(state.params["params"])))
    opt = make_optimizer(cfg, head)
    step = make_train_step(head, opt, cfg, source=FeatureTable(torch.from_numpy(flat), sizes))
    jstep = jfc.make_cached_train_step(jmodel, jcfg)
    table = jnp.asarray(flat)
    for sup, qry, label in batches:
        state, jm = jstep(state, table, sup, qry, label)
        tm = step(sup, qry, label)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-4)
    want = params_from_jax(jax.device_get(state.params["params"]))
    for name, p in head.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-3, err_msg=name)
    assert int(opt.count) == STEPS


def test_cli_train_then_test_round_trip(tmp_path, capsys):
    ckpt = str(tmp_path / "cached")
    argv = TINY_ARGV + ["--bert_frozen", "--feature_cache", "--steps_per_call", "2"]
    assert cli.main(["train", *argv, "--train_iter", "4", "--val_step", "2", "--val_iter", "4",
                     "--save_ckpt", ckpt]) == 0
    err = capsys.readouterr().err
    assert "feature cache: train split, 120 rows tokenized" in err
    saved = CheckpointManager.load_config(ckpt)
    assert saved.feature_cache and saved.bert_frozen and saved.encoder == "bert"
    assert JaxConfig.from_json((tmp_path / "cached" / "config.json").read_text()).feature_cache
    params = torch.load(tmp_path / "cached" / "best.pt", weights_only=True)["params"]
    assert sorted(params) == sorted(n for n, _ in build_model(saved, device="cpu")
                                    .named_parameters())
    assert cli.main(["test", *TINY_ARGV, "--load_ckpt", ckpt, "--test_iter", "8"]) == 0
    out, err = capsys.readouterr()
    assert "feature cache: test split" in err
    assert 0.0 <= json.loads(out.strip().splitlines()[-1])["test_accuracy"] <= 1.0
    with pytest.raises(ValueError, match="its backbone is rebuilt from its seed, pass --seed 0"):
        cli.main(["test", *TINY_ARGV, "--load_ckpt", ckpt, "--seed", "3"])
    with pytest.raises(ValueError, match="feature-cache checkpoints hold head-only params"):
        InferenceEngine.from_checkpoint(ckpt, device="cpu")


@pytest.mark.parametrize("extra,named", [
    (["--encoder", "cnn", "--bert_frozen"], "--feature_cache requires --encoder bert with the "
                                            "frozen backbone"),
    ([], "--feature_cache requires --encoder bert with the frozen backbone"),
    (["--bert_frozen", "--model", "pair"], "--feature_cache cannot serve --model pair"),
    (["--bert_frozen", "--token_cache"], "--token_cache and --feature_cache are exclusive"),
], ids=["not_bert", "not_frozen", "pair", "token_cache"])
def test_cli_refuses_by_name(extra, named):
    with pytest.raises(ValueError, match=named):
        cli.main(["train", *TINY_ARGV, "--feature_cache", *extra])


def test_embed_optimizer_refused_without_a_word_table():
    with pytest.raises(ValueError, match=r"--embed_optimizer lazy does not combine with "
                                         r"--feature_cache \(head-only state, no word table\)"):
        cli.main(["train", *TINY_ARGV, "--bert_frozen", "--feature_cache", "--embed_optimizer",
                  "lazy"])
