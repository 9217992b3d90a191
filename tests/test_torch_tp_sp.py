"""Tensor and sequence parallel in the port against the JAX single-device step.

Two worlds of gloo ranks on the CPU (``parallel/rig.run_ranks``), spawned
once for the module and run while this process runs the JAX reference.
Four configs, each from the port's fresh weights carried to JAX by
``interop``, f32, on the induction head (its NTN slices shard over tp):

* "cnn": ``tests/test_parallel.py:31-35`` (3-way 2-shot, B=8, L=16, the
  JAX widths: 100 NTN slices);
* "bilstm": the same episode over the BiLSTM at narrow widths;
* "tfm": the transformer of ``tests/test_ring.py`` (2 layers, width 64, 4
  heads, FFN 128): its MLP blocks shard over tp, its tokens over sp;
* "bert": a tiny BERT (2 layers, width 32, 4 heads, FFN 64), B=4.

Two ranks run (dp, tp, sp) = (1, 2, 1) for every config and (1, 1, 2) for
the transformer; four ranks (2, 2, 1) for every config and (2, 1, 2), (1,
2, 2) and (1, 1, 4) for the transformer. Each case is held to the JAX
``make_train_step`` on the global batch: the first forward's logits (each
rank's rows) and every gradient leaf within 1e-5 of scale, the losses of
the first ``AT`` steps within 1e-5 and the parameters after them within
atol 1e-5 (``tests/test_parallel.py:71-87``), and over ``STEPS`` steps the
losses rtol 2e-4 and the parameters atol 1e-3; and to the port's one-process
run at 1e-5 (losses, gradient norms rtol 1e-5, parameters after ``AT``
steps, the eval metrics). The 1e-5 parameter bars leave out the elements
whose first-batch gradient is nonzero rounding noise, below 1e-6 of the
leaf's largest (``tests/test_torch_moe_dp.py``'s rule for the attention
key biases, which are such elements, checked; here also a near-cancelling
word-table element; fewer than 1 in 100 elements): Adam steps such an
element by its rounding noise. The losses and the trajectory bar hold
every element. Every step issues
the collectives of ``DataParallel.plan``, and every rank holds the same
replica.

The port's ring (``parallel/ring.RingAttention``) is held to the JAX ring
(``make_ring_attention`` on ``tests/conftest.py``'s 8-device CPU mesh)
forward and backward at sp 2 and 4, with ``tests/test_ring.py``'s shapes
and masks, a fully masked key block included, and to dense attention at
JAX's own bar, 2e-4. Checkpoints hold the JAX layout: a tp=2 end state
restores in one process and at (dp=2, tp=1), a (2, 2, 1) one at (1, 4, 1),
and a one-process one at (1, 2, 1). The train and test CLI run under (1,
2, 1) on the BiLSTM and under (1, 1, 2) and (1, 2, 2) on the transformer;
``test`` reports the one-process evaluation of the same episodes. The
refusals that remain keep their texts.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.data import GloveTokenizer as JaxTokenizer
from induction_network_on_fewrel_tpu.data import make_synthetic_fewrel as jax_fewrel
from induction_network_on_fewrel_tpu.data import make_synthetic_glove as jax_glove
from induction_network_on_fewrel_tpu.data.bert_tokenizer import BertTokenizer as JaxBertTok
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu.models.build import batch_to_model_inputs as jax_inputs
from induction_network_on_fewrel_tpu.parallel import make_mesh as jax_make_mesh
from induction_network_on_fewrel_tpu.parallel.ring import make_ring_attention
from induction_network_on_fewrel_tpu.parallel.sharding import episode_batch_shardings
from induction_network_on_fewrel_tpu.sampling.episodes import EpisodeSampler as JaxSampler
from induction_network_on_fewrel_tpu.train import steps as jsteps
from induction_network_on_fewrel_tpu_torch import cli
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.interop import params_from_jax, params_to_jax
from induction_network_on_fewrel_tpu_torch.models.build import (
    AXES_WITH_EP,
    SP_MOE,
    build_model,
)
from induction_network_on_fewrel_tpu_torch.parallel import mesh as mesh_mod
from induction_network_on_fewrel_tpu_torch.parallel import rig
from induction_network_on_fewrel_tpu_torch.parallel import ring as ring_mod
from induction_network_on_fewrel_tpu_torch.parallel.tensor import TP_RULES, tp_axis

L = 16
BASE = dict(model="induction", train_n=3, n=3, k=2, q=2, batch_size=8, max_length=L,
            vocab_size=302, compute_dtype="float32", lr=1e-3, weight_decay=0.0)
VARIANTS = {
    "cnn": dict(encoder="cnn"),
    "bilstm": dict(encoder="bilstm", lstm_hidden=16, att_dim=16, induction_dim=8, ntn_slices=4),
    "tfm": dict(encoder="transformer", tfm_layers=2, tfm_model=64, tfm_heads=4, tfm_ff=128,
                induction_dim=8, ntn_slices=4),
    "bert": dict(encoder="bert", bert_layers=2, bert_hidden=32, bert_heads=4,
                 bert_intermediate=64, bert_vocab_size=500, bert_frozen=False, batch_size=4,
                 induction_dim=8, ntn_slices=4),
}
WORLDS = {
    2: [(v, (1, 2, 1)) for v in VARIANTS] + [("tfm", (1, 1, 2))],
    4: [(v, (2, 2, 1)) for v in VARIANTS] + [("tfm", lay) for lay in ((2, 1, 2), (1, 2, 2),
                                                                     (1, 1, 4))],
}
CASES = [(n, v, lay) for n, cases in WORLDS.items() for v, lay in cases]
IDS = [f"{v}-{rig.ts_name(*lay)}" for _, v, lay in CASES]
STEPS = 6
AT = rig.MOE_DP_AT
TOL = 1e-5
NOISE = 1e-6
TFM_ARGV = ["--synthetic", "--device", "cpu", "--encoder", "transformer", "--tfm_layers", "2",
            "--tfm_model", "32", "--tfm_heads", "2", "--tfm_ff", "64", "--N", "3", "--K", "2",
            "--Q", "2", "--batch_size", "4", "--max_length", "12", "--vocab_size", "40",
            "--induction_dim", "8", "--ntn_slices", "4", "--sampler", "python",
            "--prefetch_depth", "0", "--test_iter", "8"]
LSTM_ARGV = [*TFM_ARGV[:4], "bilstm", "--lstm_hidden", "8", *TFM_ARGV[13:]]
CLI_TRAIN = ["--train_iter", "4", "--val_step", "4", "--val_iter", "8"]
CLI = {2: {"dp1_tp2_sp1": LSTM_ARGV, "dp1_tp1_sp2": TFM_ARGV}, 4: {"dp1_tp2_sp2": TFM_ARGV}}
# The other training paths through ``cli train`` under tp and sp, a few
# steps and a val pass each (``--adv`` under sp is refused by name).
PATH_TRAIN = ["--train_iter", "4", "--val_step", "2", "--val_iter", "8"]
TINY_BERT = ["--encoder", "bert", "--bert_frozen", "--feature_cache", "--bert_layers", "2",
             "--bert_hidden", "32", "--bert_heads", "4", "--bert_intermediate", "64",
             "--bert_vocab_size", "500"]
CLI_PATHS = {2: [("adv", (1, 2, 1), [*LSTM_ARGV, "--adv", "--adv_batch", "4",
                                     "--adv_dis_hidden", "8", *PATH_TRAIN]),
                 ("mixture", (1, 2, 1), [*LSTM_ARGV, "--mixture", "train:1;synthetic:1",
                                         *PATH_TRAIN]),
                 ("feature_cache", (1, 2, 1), [*TFM_ARGV[:3], *TINY_BERT, *TFM_ARGV[13:],
                                               *PATH_TRAIN]),
                 ("mixture", (1, 1, 2), [*TFM_ARGV, "--mixture", "train:1;synthetic:1",
                                         *PATH_TRAIN])],
             4: [("mixture", (1, 2, 2), [*TFM_ARGV, "--mixture", "train:1;synthetic:1",
                                         *PATH_TRAIN])]}
# The token cache with lazy Adam on the word table (the flagship's
# headline path), on the BiLSTM under tp and the transformer under sp.
LAZY = {"bilstm": VARIANTS["bilstm"], "tfm": VARIANTS["tfm"]}
# At (2, 2, 1) under ZeRO-1: the tp-sharded leaves' moments stay whole.
LAZY_CASES = {2: [("bilstm", (1, 2, 1)), ("tfm", (1, 1, 2))],
              4: [("bilstm", (2, 2, 1), "zero1"), ("tfm", (1, 2, 2))]}


def _np(sd) -> dict:
    return {k: v.detach().numpy() for k, v in sd.items()}


def _batches(v: str) -> list:
    kw = {**BASE, **VARIANTS[v]}
    ds = jax_fewrel(num_relations=6, instances_per_relation=8, vocab_size=300)
    tok = (JaxBertTok(max_length=L, vocab_size=kw["bert_vocab_size"]) if v == "bert"
           else JaxTokenizer(jax_glove(vocab_size=300), max_length=L))
    s = JaxSampler(ds, tok, 3, 2, 2, batch_size=kw["batch_size"], seed=0)
    return [jax_inputs(s.sample_batch()) for _ in range(STEPS)]


def _lazy_payload(v: str) -> dict:
    """``rig.run_cases``'s payload: the token-cache lazy step of ``v`` from
    the seed's weights on STEPS global index batches."""
    from induction_network_on_fewrel_tpu_torch.data import GloveTokenizer, make_synthetic_glove
    from induction_network_on_fewrel_tpu_torch.data import make_synthetic_fewrel
    from induction_network_on_fewrel_tpu_torch.sampling.index import IndexEpisodeSampler
    from induction_network_on_fewrel_tpu_torch.train.token_cache import tokenize_dataset

    cfg = {**BASE, **LAZY[v], "token_cache": True, "embed_optimizer": "lazy"}
    table, sizes = tokenize_dataset(
        make_synthetic_fewrel(num_relations=6, instances_per_relation=8, vocab_size=300),
        GloveTokenizer(make_synthetic_glove(vocab_size=300), max_length=L))
    idx = IndexEpisodeSampler(sizes, 3, 2, 2, batch_size=BASE["batch_size"], seed=0)
    batches = []
    for _ in range(AT):
        si, qi, lab = idx.sample_fused(1)
        batches.append((si[0], qi[0], lab[0]))
    return {"cfg": cfg, "weights": None, "table": table, "sizes": sizes, "batches": batches}


def _jax_run(v: str, weights: dict, batches: list) -> dict:
    """The JAX forward's logits, the loss gradient at the first batch, and
    the trajectory (parameters after AT and STEPS steps), single-device on
    the global batches."""
    jcfg = JaxConfig(**{**BASE, **VARIANTS[v]})
    jmodel = jax_build_model(jcfg)
    state = jsteps.TrainState.create(apply_fn=jmodel.apply,
                                     params={"params": params_to_jax(
                                         {k: torch.as_tensor(x) for k, x in weights.items()})},
                                     tx=jsteps.make_optimizer(jcfg))

    def objective(params, sup, qry, lab):
        logits = jmodel.apply(params, sup, qry)
        return jsteps.LOSS_FNS[jcfg.loss](logits, lab), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(
        state.params, *batches[0])
    step = jsteps.make_train_step(jmodel, jcfg)
    losses, at = [], None
    for i, b in enumerate(batches):
        state, m = step(state, *b)
        losses.append(float(m["loss"]))
        if i + 1 == AT:
            at = _np(params_from_jax(jax.device_get(state.params["params"])))
    return {"logits": np.asarray(logits), "losses": losses, "params_at": at,
            "grads": _np(params_from_jax(jax.device_get(grads["params"]))),
            "params": _np(params_from_jax(jax.device_get(state.params["params"])))}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    batches = {v: _batches(v) for v in VARIANTS}
    weights = {v: _np(build_model(ExperimentConfig(**{**BASE, **kw}), device="cpu").state_dict())
               for v, kw in VARIANTS.items()}
    d = {k: str(tmp_path_factory.mktemp(k)) for k in ("one", "tp2", "tp2dp2", "cli2a", "cli2b",
                                                       "cli4")}
    payload = dict(cfg=BASE, variants=VARIANTS, variant_weights=weights,
                   variant_batches=batches, lazy={v: _lazy_payload(v) for v in LAZY})
    one = {"cnn": rig.run_moe_case(payload, "cnn", None, d["one"])}
    payload["worlds"] = {
        2: {"cases": WORLDS[2], "saves": {("cnn", "dp1_tp2_sp1"): d["tp2"]},
            "lazy_cases": LAZY_CASES[2], "cli_paths": CLI_PATHS[2],
            "restores": [("cnn", 2, 1, 1, d["tp2"]), ("cnn", 1, 2, 1, d["one"])],
            "cli": {"dp1_tp2_sp1": (LSTM_ARGV, CLI_TRAIN, d["cli2a"]),
                    "dp1_tp1_sp2": (TFM_ARGV, CLI_TRAIN, d["cli2b"])}},
        4: {"cases": WORLDS[4], "saves": {("cnn", "dp2_tp2_sp1"): d["tp2dp2"]},
            "lazy_cases": LAZY_CASES[4], "cli_paths": CLI_PATHS[4],
            "restores": [("cnn", 1, 4, 1, d["tp2dp2"])],
            "cli": {"dp1_tp2_sp2": (TFM_ARGV, CLI_TRAIN, d["cli4"])}},
    }
    ranks: dict = {}

    def spawn(n):
        try:
            ranks[n] = rig.run_ranks(rig.dp_ts_cases, n, payload, timeout_s=240)
        except BaseException as e:    # re-raised below, in the test's thread
            ranks[f"err{n}"] = e

    threads = [threading.Thread(target=spawn, args=(n,)) for n in (2, 4)]
    for t in threads:
        t.start()
    want = {v: _jax_run(v, weights[v], batches[v]) for v in VARIANTS}
    one.update({v: rig.run_moe_case(payload, v, None) for v in VARIANTS if v != "cnn"})
    one.update({f"lazy/{v}": rig.run_cases(payload["lazy"][v])["monolithic"] for v in LAZY})
    for t in threads:
        t.join(270)
    assert not any(t.is_alive() for t in threads), "the ranks outlived their bound"
    for n in (2, 4):
        if f"err{n}" in ranks:
            raise ranks[f"err{n}"]
    return {"ranks": ranks, "jax": want, "one": one, "payload": payload, "dirs": d,
            "restored": rig.restore_moe(payload, "cnn", None, d["tp2"]),
            "test_ref": {lay: rig.moe_test_reference(argv, d[key], 1) for lay, argv, key in
                         (("dp1_tp2_sp1", LSTM_ARGV, "cli2a"), ("dp1_tp1_sp2", TFM_ARGV, "cli2b"),
                          ("dp1_tp2_sp2", TFM_ARGV, "cli4"))}}


def _results(world, n: int, v: str, lay: tuple) -> list:
    return [r[rig.ts_name(*lay)][v] for r in world["ranks"][n]]


def _rows(n: int, lay: tuple, rank: int, B: int) -> slice:
    """The global episodes a rank of ``lay`` holds (B over dp)."""
    dp = lay[0]
    d = rank // (n // dp)
    return slice(d * B // dp, (d + 1) * B // dp)


def _key_bias(v: str, name: str, shape) -> np.ndarray:
    """The elements of leaf ``name`` that are an attention block's key bias."""
    mask = np.zeros(shape, bool)
    if v == "tfm" and name.startswith("encoder.qkv_") and name.endswith(".bias"):
        d = VARIANTS[v]["tfm_model"]
        mask[d:2 * d] = True
    if v == "bert" and name.endswith("attention.qkv.bias"):
        d = VARIANTS[v]["bert_hidden"]
        mask[d:2 * d] = True
    return mask


def _noise(grads: dict) -> dict:
    """Per leaf, the elements whose first-batch gradient is rounding noise:
    nonzero and below NOISE of the leaf's largest (a near-cancelling sum:
    the attention blocks' key biases, a word-table element). Adam's first
    step moves such an element by about lr times the sign of that noise,
    which two summation orders draw differently."""
    out = {}
    for k, g in grads.items():
        a = np.abs(g)
        out[k] = (a > 0) & (a < NOISE * a.max())
    return out


def _held(got: dict, want: dict, noise: dict, tol: float, what: str) -> None:
    """Every element of ``want`` within ``tol`` (atol and rtol) but those
    ``noise`` marks; fewer than 1 in 100 of them are left out."""
    assert set(got) == set(want), what
    left = sum(int(m.sum()) for m in noise.values())
    assert left < 1e-2 * sum(w.size for w in want.values()), (what, left)
    for k, w in want.items():
        keep = ~noise[k]
        np.testing.assert_allclose(got[k][keep], w[keep], atol=tol, rtol=tol,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("n,v,lay", CASES, ids=IDS)
def test_forward_and_gradients_match_jax_on_the_global_batch(world, n, v, lay):
    want = world["jax"][v]
    scale = float(np.abs(want["logits"]).max())
    B = len(want["logits"])
    for r, got in enumerate(_results(world, n, v, lay)):
        np.testing.assert_allclose(got["logits"], want["logits"][_rows(n, lay, r, B)], rtol=0,
                                   atol=TOL * scale, err_msg=f"rank {r}")
        for k, w in want["grads"].items():
            g_scale = float(np.abs(w).max())
            np.testing.assert_allclose(got["grads"][k], w, rtol=TOL, atol=TOL * g_scale,
                                       err_msg=f"rank {r} gradient: {k}")


@pytest.mark.parametrize("n,v,lay", CASES, ids=IDS)
def test_steps_match_jax_at_its_sharded_bar_and_over_the_trajectory(world, n, v, lay):
    want = world["jax"][v]
    for r, got in enumerate(_results(world, n, v, lay)):
        np.testing.assert_allclose(got["losses"][:AT], want["losses"][:AT], rtol=0, atol=TOL)
        _held(got["params_at"], want["params_at"], _noise(want["grads"]), TOL,
              f"rank {r} after {AT} steps")
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4, err_msg=f"rank {r}")
        for k, w in want["params"].items():
            np.testing.assert_allclose(got["params"][k], w, atol=1e-3, err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("n,v,lay", CASES, ids=IDS)
def test_ranks_equal_one_process_and_each_other(world, n, v, lay):
    one = world["one"][v]
    res = _results(world, n, v, lay)
    for r, got in enumerate(res):
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=0, atol=TOL)
        np.testing.assert_allclose(got["grad_norms"], one["grad_norms"], rtol=TOL, atol=0)
        _held(got["params_at"], one["params_at"], _noise(one["grads"]), TOL, f"rank {r}")
        if lay[0] == 1:         # the whole batch on every rank: the same eval metrics
            for k, w in one["eval"].items():
                assert got["eval"][k] == pytest.approx(w, abs=1e-6), (r, k)
        for k in got["params"]:
            np.testing.assert_array_equal(got["params"][k], res[0]["params"][k], err_msg=k)


@pytest.mark.parametrize("v", ["tfm", "bert"])
def test_key_bias_gradients_are_rounding_noise(world, v):
    grads = world["one"][v]["grads"]
    top = max(float(np.abs(g).max()) for g in grads.values())
    keys = [k for k, g in grads.items() if _key_bias(v, k, g.shape).any()]
    assert len(keys) == 2
    for k in keys:
        assert float(np.abs(grads[k][_key_bias(v, k, grads[k].shape)]).max()) < NOISE * top, k
        assert _noise(grads)[k][_key_bias(v, k, grads[k].shape)].any(), k


@pytest.mark.parametrize("n,v,lay", CASES, ids=IDS)
def test_steps_issue_the_planned_collectives(world, n, v, lay):
    _, tp, sp = lay
    for got in _results(world, n, v, lay):
        assert got["issued_per_step"] == got["plan"]
        plan = got["plan"]
        assert ("tp/ntn_allgather" in plan) == (tp > 1)
        assert ("tp/mlp_out_allreduce" in plan) == (tp > 1 and v in ("tfm", "bert"))
        if sp > 1:
            assert plan["sp/ring_hop"] == VARIANTS[v]["tfm_layers"] * (2 * sp - 1)
            assert plan["sp/pool_allreduce"] == 1 and plan["sp/grad_allreduce"] == 1
        assert not any(k.startswith("grad/bucket") for k in plan)


@pytest.mark.parametrize("n,v,lay", [(n, c[0], c[1]) for n, cs in LAZY_CASES.items()
                                     for c in cs],
                         ids=[f"{c[0]}-{rig.ts_name(*c[1])}" for cs in LAZY_CASES.values()
                              for c in cs])
def test_token_cache_lazy_step_equals_one_process(world, n, v, lay):
    """The token cache with lazy Adam under tp and sp, held to one process
    on the global batches at ``tests/test_torch_dp.py``'s bars: losses
    within 1e-5, gradient norms rtol 1e-5, the parameters (the lazy table
    materialized) within 1e-5, the moments (the compact rows' included)
    within 1e-5 of each leaf's scale, but the attention key biases (their
    gradient is rounding noise: ``test_key_bias_gradients_are_rounding_noise``);
    on every rank; the planned collectives."""
    one = world["one"][f"lazy/{v}"]
    for r, res in enumerate(world["ranks"][n]):
        got = res[f"lazy/{v}/{rig.ts_name(*lay)}"]
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=0, atol=TOL)
        np.testing.assert_allclose(got["grad_norms"], one["grad_norms"], rtol=TOL, atol=0)
        for k, w in one["params"].items():
            keep = ~_key_bias(v, k, w.shape)
            np.testing.assert_allclose(got["params"][k][keep], w[keep], atol=TOL, rtol=TOL,
                                       err_msg=f"rank {r}: {k}")
        for k, w in one["moments"].items():
            keep = ~_key_bias(v, k.split("/", 1)[1], w.shape)
            np.testing.assert_allclose(got["moments"][k][keep], w[keep], rtol=0,
                                       atol=TOL * max(float(np.abs(w).max()), 1e-30),
                                       err_msg=f"rank {r}: {k}")
        assert got["issued_per_step"] == got["plan"], r
        if "zero_shards" in got:
            # ZeRO-1 (the JAX state_shardings) dp-shards the replicated
            # leaves' moments, not the tp-sharded ones.
            sharded = set(got["zero_shards"])
            assert "relation.tensor_slices" not in sharded and "query_proj.weight" in sharded
            assert all(n == numel // lay[0] for n, numel in got["zero_shards"].values())


@pytest.mark.parametrize("n,path,lay", [(n, p, lay) for n, runs in CLI_PATHS.items()
                                        for p, lay, _ in runs],
                         ids=[f"{p}-{rig.ts_name(*lay)}" for runs in CLI_PATHS.values()
                              for p, lay, _ in runs])
def test_the_other_paths_train_under_the_layout(world, n, path, lay):
    """``--adv``, ``--mixture`` and ``--feature_cache`` through ``cli train``
    under tp, and ``--mixture`` under sp: every rank exits 0, rank 0 alone
    prints the result."""
    for r, res in enumerate(world["ranks"][n]):
        got = res[f"cli_path/{path}/{rig.ts_name(*lay)}"]
        assert got["rc"] == 0, (r, got["stderr"])
        assert (got["result"] is not None) == (r == 0), r
    assert 0.0 <= world["ranks"][n][0][f"cli_path/{path}/{rig.ts_name(*lay)}"]["result"][
        "final_val_accuracy"] <= 1.0


def test_checkpoints_round_trip_across_tp(world):
    saved = _results(world, 2, "cnn", (1, 2, 1))[0]
    for where, got in (("one process", world["restored"]),
                       ("dp2_tp1", world["ranks"][2][0]["restored/cnn/dp2_tp1_sp1"])):
        assert got["step"] == STEPS, where
        for k in saved["params"]:
            np.testing.assert_array_equal(got["params"][k], saved["params"][k],
                                          err_msg=f"{where}: {k}")
        for k in saved["moments"]:
            np.testing.assert_array_equal(got["moments"][k], saved["moments"][k],
                                          err_msg=f"{where}: {k}")
    for src, got in ((_results(world, 4, "cnn", (2, 2, 1))[0],
                      world["ranks"][4][0]["restored/cnn/dp1_tp4_sp1"]),
                     (world["one"]["cnn"], world["ranks"][2][1]["restored/cnn/dp1_tp2_sp1"])):
        for k in src["params"]:
            np.testing.assert_array_equal(got["params"][k], src["params"][k], err_msg=k)
        for k in src["moments"]:
            np.testing.assert_array_equal(got["moments"][k], src["moments"][k], err_msg=k)


@pytest.mark.parametrize("n,lay", [(n, lay) for n, lays in CLI.items() for lay in lays])
def test_train_and_test_cli_run_under_the_layout(world, n, lay):
    for r, res in enumerate(world["ranks"][n]):
        got = res[lay]["cli"]
        for mode in ("train", "test"):
            assert got[mode]["rc"] == 0, (r, mode, got[mode]["stderr"])
            assert (got[mode]["result"] is not None) == (r == 0), (r, mode)
    test = world["ranks"][n][0][lay]["cli"]["test"]["result"]
    want = world["test_ref"][lay]
    assert test["test_accuracy"] == pytest.approx(round(want["accuracy"], 4), abs=1e-9)
    assert test["acc_ci95"] == pytest.approx(round(want["acc_ci95"], 4), abs=1e-9)


# --- the ring against the JAX ring -----------------------------------------------


def _qkvm(seed: int, B=2, H=4, Lq=16, D=8, pad=3):
    """``tests/test_ring.py``'s shapes and key masks, and a row whose last
    key block (the last quarter) is masked whole."""
    ks = jax.random.split(jax.random.key(seed), 3)
    q, k, v = (np.asarray(jax.random.normal(kk, (B, H, Lq, D), jnp.float32)) for kk in ks)
    mask = np.ones((B, Lq), np.float32)
    mask[:, Lq - pad:] = 0.0
    mask[1, Lq - Lq // 4:] = 0.0
    return q, k, v, mask


@pytest.fixture(scope="module")
def rings():
    out = {}
    for sp in (2, 4):
        q, k, v, mask = _qkvm(sp)
        w = np.arange(q.size, dtype=np.float32).reshape(q.shape) / q.size
        out[sp] = {"jax": _jax_ring(sp, q, k, v, mask, w), "qkvm": (q, k, v, mask), "w": w,
                   "ranks": rig.run_ranks(rig.ring_ranks, sp, {"qkv": (q, k, v), "mask": mask,
                                                              "w": w}, timeout_s=60)}
    return out


def _jax_ring(sp, q, k, v, mask, w) -> dict:
    ring = make_ring_attention(jax_make_mesh(dp=1, tp=1, sp=sp))

    def loss(fn, q, k, v):
        return jnp.sum(fn(q, k, v, jnp.asarray(mask)) * w)

    out = jax.jit(ring)(q, k, v, jnp.asarray(mask))
    grads = jax.grad(lambda *a: loss(ring, *a), argnums=(0, 1, 2))(q, k, v)
    return {"out": np.asarray(out), "grads": [np.asarray(g) for g in grads]}


def _joined(ranks: list, key, i=None) -> np.ndarray:
    parts = [r[key] if i is None else r[key][i] for r in ranks]
    return np.concatenate(parts, axis=2)


@pytest.mark.parametrize("sp", [2, 4])
def test_port_ring_matches_the_jax_ring_forward_and_backward(rings, sp):
    got, want = rings[sp]["ranks"], rings[sp]["jax"]
    np.testing.assert_allclose(_joined(got, "out"), want["out"], atol=1e-5, rtol=1e-5)
    for i in range(3):
        np.testing.assert_allclose(_joined(got, "grads", i), want["grads"][i], atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("sp", [2, 4])
def test_port_ring_matches_dense_attention(rings, sp):
    q, k, v, mask = (torch.tensor(x, requires_grad=i < 3) for i, x in
                     enumerate(rings[sp]["qkvm"]))
    out = ring_mod.dense_attention(q, k, v, mask)
    (out * torch.tensor(rings[sp]["w"])).sum().backward()
    got = rings[sp]["ranks"]
    np.testing.assert_allclose(_joined(got, "out"), out.detach().numpy(), atol=2e-4)
    for i, x in enumerate((q, k, v)):
        np.testing.assert_allclose(_joined(got, "grads", i), x.grad.numpy(), atol=2e-4)


# --- the rules, the mesh, the refusals --------------------------------------------


def test_tp_rules_are_the_jax_table_in_the_port_layouts():
    from induction_network_on_fewrel_tpu.parallel.sharding import _TP_RULES

    assert [f for f, _, _ in TP_RULES] == [f for f, _ in _TP_RULES]
    for (frag, rank, axis), (jfrag, spec) in zip(TP_RULES, _TP_RULES):
        assert rank == len(spec)
        if "tp" not in spec:
            assert axis is None, frag
        else:       # a Dense weight is the JAX kernel transposed
            jaxis = list(spec).index("tp")
            assert axis == (jaxis if rank == 3 else 1 - jaxis), frag
    names = {"relation.tensor_slices": 0, "encoder.intermediate_0.weight": 0,
             "encoder.mlp_out_1.weight": 1, "encoder.backbone.layer_0.intermediate.weight": 0,
             "encoder.intermediate_0.bias": None, "encoder.stack_mlp_up_w": None,
             "encoder.moe_1.experts_up": None, "query_proj.weight": None}
    for name, want in names.items():
        leaf = {"relation.tensor_slices": 3, "encoder.stack_mlp_up_w": 3,
                "encoder.moe_1.experts_up": 3}.get(name, 1 if name.endswith("bias") else 2)
        assert tp_axis(name, leaf) == want, name


@pytest.mark.parametrize("v", ["cnn", "tfm", "bert"])
def test_interop_slices_the_jax_leaves_as_the_tp_modules_hold_them(v):
    """A JAX tree carried by ``params_from_jax`` and cut by ``tp_slice`` is
    each tp rank's state dict, and ``tp_join`` of the slices is the whole."""
    from induction_network_on_fewrel_tpu_torch.interop import tp_join, tp_slice
    from induction_network_on_fewrel_tpu_torch.parallel.tensor import TensorMesh, shard_modules

    cfg = ExperimentConfig(**{**BASE, **VARIANTS[v]})
    whole = params_from_jax(params_to_jax(build_model(cfg, device="cpu").state_dict()))
    slices = []
    for r in range(2):
        model = build_model(cfg, device="cpu")
        assert shard_modules(model, TensorMesh(mesh_mod.Mesh(dp=1, tp=2, tp_rank=r))) > 0
        model.load_state_dict(whole)            # a whole leaf loads sliced
        got, want = model.state_dict(), tp_slice(whole, 2, r)
        assert set(got) == set(want)
        for k, w in want.items():
            torch.testing.assert_close(got[k], w, rtol=0, atol=0, msg=k)
        slices.append(got)
    for k, w in tp_join(slices).items():
        torch.testing.assert_close(w, whole[k], rtol=0, atol=0, msg=k)


def test_mesh_numbers_ranks_in_the_jax_axis_order():
    jmesh = jax_make_mesh(dp=2, tp=2, sp=2)
    grid = np.vectorize(lambda d: d.id)(jmesh.devices)          # [dp, pp, ep, tp, sp]
    for d in range(2):
        for t in range(2):
            for s in range(2):
                assert mesh_mod.mesh_index(int(grid[d, 0, 0, t, s]), 1, 2, 2) == (d, 0, 0, t, s)


def test_sp_ranks_keep_their_token_columns_and_dp_keys_the_feed():
    from induction_network_on_fewrel_tpu_torch.parallel import hostfeed

    jmesh = jax_make_mesh(dp=2, tp=2, sp=2)
    for r in range(8):
        d, _, _, t, s = mesh_mod.mesh_index(r, 1, 2, 2)
        m = mesh_mod.Mesh(dp=2, rank=d, tp=2, tp_rank=t, sp=2, sp_rank=s)
        assert hostfeed.local_episode_range(m, 8) == (4 * d, 4)
        assert hostfeed.local_token_columns(m, L) == (s * L // 2, L // 2)
    sup, qry, lab = episode_batch_shardings(jmesh)
    for sh in [*sup.values(), *qry.values()]:
        assert sh.spec[0] == "dp" and sh.spec[-1] == "sp"   # episodes over dp, tokens over sp
    assert lab.spec == ("dp", None)


def test_moe_routing_groups_straddle_the_sp_columns():
    """Why --sp with MoE is refused: the routing groups follow the global
    token order (row-major over [M, L]), so under sp every group holds
    tokens of every sp rank, and no rank can route its columns alone."""
    M, G = 30, ExperimentConfig().moe_group_size
    for sp in (2, 4):
        tokens = np.arange(M * L)
        group, rank = tokens // G, (tokens % L) // (L // sp)
        for g in np.unique(group):
            assert len(np.unique(rank[group == g])) == sp


@pytest.mark.parametrize("argv,text", [
    (["--encoder", "cnn", "--sp", "2"], "--sp (ring attention) requires --encoder transformer; "
                                        "the cnn encoder has no sequence-parallel path"),
    (["--encoder", "transformer", "--tfm_stacked", "--sp", "2"],
     "the layer-stacked (pipeline) transformer does not compose with MoE or ring attention"),
    (["--encoder", "transformer", "--moe_experts", "4", "--sp", "2"], SP_MOE),
    (["--encoder", "transformer", "--moe_experts", "4", "--ep", "2", "--tp", "2"], AXES_WITH_EP),
    (["--pp", "2"], "--pp (pipeline parallelism) requires --encoder transformer (stages are "
                    "transformer layers)"),
    (["--encoder", "transformer", "--pp", "2", "--sp", "2"],
     "the layer-stacked (pipeline) transformer does not compose with MoE or ring attention"),
])
def test_refusals_that_remain_keep_their_texts(capsys, argv, text):
    with pytest.raises(SystemExit) as e:
        cli.parse_args(True, ["--synthetic", "--device", "cpu", *argv])
    assert e.value.code == 2
    assert text in capsys.readouterr().err


@pytest.mark.parametrize("flags,text", [
    (["--tp", "3"], "--ntn_slices (100) must be divisible by --tp (3)"),
    (["--tp", "2", "--encoder", "transformer", "--tfm_ff", "33", "--ntn_slices", "4"],
     "--tfm_ff (33) must be divisible by --tp (2)"),
    (["--tp", "2", "--encoder", "bert", "--bert_intermediate", "33", "--ntn_slices", "4"],
     "--bert_intermediate (33) must be divisible by --tp (2)"),
    (["--sp", "3", "--encoder", "transformer"], "--max_length (40) must be divisible by --sp (3)"),
    (["--sp", "2", "--encoder", "transformer", "--adv"], "--adv with --sp above 1 is not ported"),
    (["--tp", "2"], None),
    (["--sp", "2", "--encoder", "transformer"], None),
])
def test_sizes_that_do_not_divide_are_refused_where_jax_raises(monkeypatch, flags, text):
    tp = int(flags[flags.index("--tp") + 1]) if "--tp" in flags else 1
    sp = int(flags[flags.index("--sp") + 1]) if "--sp" in flags else 1
    layout = mesh_mod.Mesh(dp=1, tp=tp, sp=sp)
    monkeypatch.setattr(mesh_mod, "make_mesh", lambda **kw: layout)
    monkeypatch.setattr("induction_network_on_fewrel_tpu_torch.parallel.distributed."
                        "maybe_initialize_distributed", lambda **kw: True)
    args = cli.parse_args(True, ["--synthetic", "--device", "cpu", *flags])
    cfg = cli.config_from_args(args)
    if text is None:
        assert cli.dp_mesh(args, cfg) is layout
        return
    with pytest.raises(ValueError, match=text.replace("(", r"\(").replace(")", r"\)")):
        cli.dp_mesh(args, cfg)


def test_jax_raises_on_the_same_sizes():
    """The rules above are JAX's: its placement refuses a tp axis that does
    not divide, and its ring a sequence that does not."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    with pytest.raises(ValueError, match="should be divisible by 3"):
        jax.device_put(np.zeros((100, 4, 4), np.float32),
                       NamedSharding(jax_make_mesh(dp=1, tp=3), P("tp", None, None)))
    ring = make_ring_attention(jax_make_mesh(dp=1, sp=3))
    x = jnp.ones((2, 4, 16, 8))
    with pytest.raises(ValueError, match="3 does not evenly divide 16"):
        jax.jit(ring)(x, x, x, jnp.ones((2, 16)))


def test_no_port_text_refuses_tp_or_sp():
    """tp and sp are ported: no port text refuses either flag as unported,
    and no flag is left deferred (pp is ported since)."""
    from induction_network_on_fewrel_tpu_torch.models import build

    root = pathlib.Path(cli.__file__).parent
    files = list(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
    gone = ("--tp is not ported yet", "--sp is not ported yet", "tp, sp ring attention, pp",
            "--tp 2 is not ported", "--sp 2 is not ported")
    assert [(str(p), g) for p in files for g in gone if g in p.read_text()] == []
    assert cli.DEFERRED == {}
    assert not hasattr(build, "LATER_SLICE") and not hasattr(build, "SHARDED")
