"""The port's exact lazy word-table Adam vs the JAX package's (CPU).

* ``lazy_catchup`` (its plain version, the CPU path) against JAX
  ``decay_catchup`` on the same rows: gaps beyond ``CATCHUP_CAP``, rows
  with all-zero moments, a staircase crossed inside the catch-up, pad
  lanes; within 1e-6 (the JAX bar, tests/test_lazy_embed.py). The
  in-place ``lazy_materialize`` against JAX ``make_materialize`` on the
  same lazy state, 1e-6, ``last`` bitwise on the rows with moments (the
  others keep theirs: they never move).
* The update machinery over 20 steps on the same sparse row gradients:
  JAX ``decay_catchup`` + ``touched_update`` + the dropping scatter, and
  the port's ``lazy_catchup`` + ``adam_nodecay`` (``optim_update``'s
  plain version) + ``lazy_scatter``: table, moments and ``last`` within
  1e-6 at every step, then materialized past the cap.
* 20 live-lazy steps (per-step dedup) against JAX ``make_train_step``
  with ``embed_optimizer="lazy"`` (``make_lazy_update_body``), and 20
  cached-lazy steps in calls of 4 against the JAX token-cache scan
  (``make_lazy_cached_scan_fns``), from the same weights on the same
  batches: ``last`` bitwise, never-touched rows bitwise at their initial
  values, losses rtol 2e-4 and materialized parameters atol 1e-3 (the
  two frameworks' model trajectories differ by f32 rounding in the
  encoder, tests/test_torch_fused_step.py's bars).
* Exactness: the port's lazy run equals its dense twin (Adam with decay on
  every parameter but the table: the table on ``adam_nodecay``) at 1e-6
  over 20 steps, with weight decay 0 and 1e-2, live and cached, through
  the small-table gradients and the large-table ones; ``segsum_prefix``
  (the large compact rows' gradient) against ``index_put_``'s.
* S=4 fused equals 4 single steps bitwise (the eager body).
* ``--optimizer adamw`` with lazy is refused by name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.data import GloveTokenizer as JaxTokenizer
from induction_network_on_fewrel_tpu.data import make_synthetic_fewrel as jax_fewrel
from induction_network_on_fewrel_tpu.data import make_synthetic_glove as jax_glove
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu.models.build import batch_to_model_inputs as jax_inputs
from induction_network_on_fewrel_tpu.sampling.episodes import EpisodeSampler as JaxSampler
from induction_network_on_fewrel_tpu.train import lazy_embed as jlazy
from induction_network_on_fewrel_tpu.train.feature_cache import FeatureEpisodeSampler
from induction_network_on_fewrel_tpu.train.steps import init_state
from induction_network_on_fewrel_tpu.train.steps import make_train_step as jax_train_step
from induction_network_on_fewrel_tpu.train.token_cache import (
    make_token_cached_multi_train_step as jax_cached_multi,
)
from induction_network_on_fewrel_tpu.train.token_cache import tokenize_dataset as jax_tokenize
from induction_network_on_fewrel_tpu_torch import cli
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.interop import params_from_jax
from induction_network_on_fewrel_tpu_torch.models import embedding as embedding_module
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.ops.lazy_embed import (
    CATCHUP_CAP,
    lazy_catchup,
    lazy_materialize,
    lazy_scatter,
)
from induction_network_on_fewrel_tpu_torch.ops.optim import OptimHyper, optim_update_reference
from induction_network_on_fewrel_tpu_torch.train.framework import stack_batches
from induction_network_on_fewrel_tpu_torch.train.lazy_embed import (
    LazyTable,
    augment_token_table,
    live_rows,
)
from induction_network_on_fewrel_tpu_torch.train.steps import (
    ClipDecayOptimizer,
    make_multi_train_step,
    make_optimizer,
    make_train_step,
    train_step,
)
from induction_network_on_fewrel_tpu_torch.train.token_cache import TokenTable

VOCAB = 52          # 50 GloVe words + UNK/BLANK; the corpus uses 35 of them
SMALL = dict(
    vocab_size=VOCAB, max_length=12, word_dim=10, pos_dim=2, lstm_hidden=16, att_dim=8,
    induction_dim=12, ntn_slices=6, routing_iters=3, train_n=3, n=3, k=2, q=2, batch_size=2,
    compute_dtype="float32", lr=3e-3, lr_step_size=3, weight_decay=0.0, grad_clip=10.0,
)
STEPS, S = 20, 4
TOL = 1e-6


def _hyper(cfg) -> OptimHyper:
    return OptimHyper(cfg.lr, cfg.lr_gamma, cfg.lr_step_size, cfg.weight_decay, cfg.grad_clip)


@pytest.fixture(scope="module")
def world():
    vocab = jax_glove(vocab_size=VOCAB - 2, word_dim=SMALL["word_dim"])
    ds = jax_fewrel(num_relations=6, instances_per_relation=6, vocab_size=35,
                    sentence_len=(6, SMALL["max_length"]))
    tok = JaxTokenizer(vocab, max_length=SMALL["max_length"])
    sampler = JaxSampler(ds, tok, 3, 2, 2, batch_size=2, seed=3)
    batches = [jax_inputs(sampler.sample_batch()) for _ in range(STEPS)]
    table_np, sizes = jax_tokenize(ds, tok)
    isampler = FeatureEpisodeSampler(sizes, 3, 2, 2, batch_size=2, seed=5)
    ibatches = [isampler.sample_batch() for _ in range(STEPS)]
    ibatches = [(b.support_idx, b.query_idx, b.label) for b in ibatches]
    return {"vocab": vocab, "batches": batches, "table_np": table_np, "sizes": sizes,
            "ibatches": ibatches}


def _jax_state(cfg_kw, batch):
    jcfg = JaxConfig(**cfg_kw)
    jmodel = jax_build_model(jcfg)
    return jcfg, jmodel, init_state(jmodel, jcfg, batch[0], batch[1])


def _port(cfg, jstate, uids=None):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(jstate.params["params"])))
    opt = make_optimizer(cfg, model)
    lazy = None
    if cfg.embed_optimizer == "lazy":
        lazy = LazyTable(model, opt.hyper, live_rows(cfg), uids=uids)
        opt.attach_compact(lazy.rows, lazy.rows_m, lazy.rows_v)
    return model, opt, lazy


# --- the kernels' plain versions ------------------------------------------------


def _lazy_rows(rng, V, D, t, gaps):
    W = rng.normal(size=(V, D)).astype(np.float32)
    m = (rng.normal(size=(V, D)) * 1e-2).astype(np.float32)
    v = (rng.normal(size=(V, D)) * 1e-2).astype(np.float32) ** 2
    dead = rng.random(V) < 0.25
    m[dead] = 0.0
    v[dead] = 0.0
    last = (t - rng.choice(gaps, V)).astype(np.int32)
    return W, m, v, np.maximum(last, 0)


@pytest.mark.parametrize("t,step_size", [(9, 3), (1600, 7), (2600, 2000)])
def test_catchup_matches_jax_decay_catchup(t, step_size):
    """Gaps 0..1500 (beyond the cap), all-zero rows, pad lanes, a staircase
    crossed inside the catch-up."""
    rng = np.random.default_rng(t)
    V, D = 64, 10
    W, m, v, last = _lazy_rows(rng, V, D, t, [0, 1, 2, 5, 9, 1023, 1024, 1025, 1500])
    ids = np.sort(rng.choice(V, 40, replace=False)).astype(np.int32)
    ids = np.concatenate([ids, np.full(8, V, np.int32)])          # pad lanes
    jcfg = JaxConfig(lr=3e-3, lr_step_size=step_size)
    last_r = np.where(ids >= V, t, last[np.minimum(ids, V - 1)]).astype(np.int32)
    clamp = np.minimum(ids, V - 1)
    want = jlazy.decay_catchup(jnp.asarray(W[clamp]), jnp.asarray(m[clamp]),
                               jnp.asarray(v[clamp]), jnp.asarray(last_r), jnp.int32(t),
                               jlazy.make_hyper(jcfg))
    hp = OptimHyper(jcfg.lr, jcfg.lr_gamma, jcfg.lr_step_size, 0.0, jcfg.grad_clip)
    out = tuple(torch.empty((ids.size, D)) for _ in range(3))
    lazy_catchup(torch.tensor(W), torch.tensor(m), torch.tensor(v), torch.tensor(last),
                 torch.tensor(ids), torch.tensor(t), hp, out)
    for got, w in zip(out, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=TOL, rtol=0)
    dead = ~(m[clamp].any(-1) | v[clamp].any(-1))
    assert dead.any() and np.array_equal(out[0].numpy()[dead], W[clamp][dead])


def test_materialize_matches_jax_make_materialize(world):
    cfg_kw = dict(SMALL, embed_optimizer="lazy")
    jcfg, _, jstate = _jax_state(cfg_kw, world["batches"][0])
    rng = np.random.default_rng(7)
    t = 1400
    W, m, v, last = _lazy_rows(rng, VOCAB, SMALL["word_dim"], t, [0, 3, 1023, 1024, 1100])
    params = jax.device_get(jstate.params)
    params["params"]["embedding"]["word_embedding"] = W
    jstate = jstate.replace(params=params, step=jnp.int32(t), emb_m=jnp.asarray(m),
                            emb_v=jnp.asarray(v), emb_last=jnp.asarray(last))
    jout = jlazy.make_materialize(jcfg)(jstate)
    table, mm, vv, ll = (torch.tensor(x) for x in (W, m, v, last))
    lazy_materialize(table, mm, vv, ll, torch.tensor(t), _hyper(ExperimentConfig(**SMALL)))
    np.testing.assert_allclose(
        table.numpy(), np.asarray(jout.params["params"]["embedding"]["word_embedding"]),
        atol=TOL, rtol=0)
    np.testing.assert_allclose(mm.numpy(), np.asarray(jout.emb_m), atol=TOL, rtol=0)
    np.testing.assert_allclose(vv.numpy(), np.asarray(jout.emb_v), atol=TOL, rtol=0)
    # ``last`` as JAX sets it on every row with moments; a row without any
    # keeps its own (it never moves, so its gap is irrelevant).
    alive = m.any(-1) | v.any(-1)
    assert (~alive).any()
    assert np.array_equal(ll.numpy()[alive], np.asarray(jout.emb_last)[alive])
    assert np.array_equal(ll.numpy()[~alive], last[~alive])


def test_update_machinery_20_steps_matches_jax():
    """Catch-up, compact Adam and write-back on the same sparse row
    gradients for 20 steps, then a materialize past the cap: 1e-6."""
    rng = np.random.default_rng(0)
    V, D, U = 40, 6, 16
    jcfg = JaxConfig(lr=3e-3, lr_step_size=3)
    jhp = jlazy.make_hyper(jcfg)
    hp = OptimHyper(jcfg.lr, jcfg.lr_gamma, jcfg.lr_step_size, 0.0, jcfg.grad_clip)
    W0 = rng.normal(size=(V, D)).astype(np.float32)
    jW, jm, jv = jnp.asarray(W0), jnp.zeros((V, D)), jnp.zeros((V, D))
    jlast = jnp.zeros(V, jnp.int32)
    table, m, v = torch.tensor(W0), torch.zeros(V, D), torch.zeros(V, D)
    last, count = torch.zeros(V, dtype=torch.int32), torch.tensor(0)
    rows = tuple(torch.zeros(U, D) for _ in range(3))
    for t in range(STEPS):
        n = int(rng.integers(3, U))
        uids = np.concatenate([np.sort(rng.choice(V - 10, n, replace=False)),
                               np.full(U - n, V)]).astype(np.int32)
        g = (rng.normal(size=(U, D)) * 1e-2).astype(np.float32)
        g[n:] = 0.0
        ju = jnp.asarray(uids)
        last_r = jnp.where(ju >= V, t, jlast[jnp.minimum(ju, V - 1)])
        W_r, m_r, v_r = jlazy.decay_catchup(jW[ju], jm[ju], jv[ju], last_r, jnp.int32(t), jhp)
        W_n, m_n, v_n = jlazy.touched_update(W_r, m_r, v_r, jnp.asarray(g), jnp.int32(t), jhp)
        jW, jm = jW.at[ju].set(W_n, mode="drop"), jm.at[ju].set(m_n, mode="drop")
        jv, jlast = jv.at[ju].set(v_n, mode="drop"), jlast.at[ju].set(t + 1, mode="drop")

        ids = torch.tensor(uids)
        lazy_catchup(table, m, v, last, ids, count, hp, rows)
        optim_update_reference([rows[0]], [torch.tensor(g)], [rows[1]], [rows[2]],
                               ["adam_nodecay"], torch.zeros(1), count, hp)
        lazy_scatter(table, m, v, last, ids, rows, count)
        for got, want in ((table, jW), (m, jm), (v, jv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
        assert np.array_equal(last.numpy(), np.asarray(jlast))
    assert torch.equal(table[V - 10:], torch.tensor(W0[V - 10:]))     # never touched
    t_end = STEPS + CATCHUP_CAP + 300
    jW, jm, jv = jlazy.decay_catchup(jW, jm, jv, jlast, jnp.int32(t_end), jhp)
    lazy_materialize(table, m, v, last, torch.tensor(t_end), hp)
    for got, want in ((table, jW), (m, jm), (v, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


# --- trajectories vs JAX --------------------------------------------------------


def _assert_model_close(model, jparams, atol):
    want = params_from_jax(jax.device_get(jparams["params"]))
    for name, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), atol=atol, rtol=0,
                                   err_msg=name)


def _untouched(vocab_rows, word_arrays):
    touched = np.zeros(vocab_rows, bool)
    for w in word_arrays:
        touched[np.asarray(w).ravel()] = True
    return ~touched


def test_live_lazy_20_steps_match_jax_lazy_body(world):
    cfg_kw = dict(SMALL, embed_optimizer="lazy")
    batches = world["batches"]
    jcfg, jmodel, jstate = _jax_state(cfg_kw, batches[0])
    jstep = jax_train_step(jmodel, jcfg)
    cfg = ExperimentConfig(**cfg_kw)
    model, opt, lazy = _port(cfg, jstate)
    table0 = model.embedding.word_embedding.detach().clone().numpy()
    step = make_train_step(model, opt, cfg, lazy=lazy)
    for b in batches:
        jstate, jm = jstep(jstate, *b)
        tm = step(*b)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-4)
    assert np.array_equal(lazy.last.numpy(), np.asarray(jstate.emb_last))
    assert int(opt.count) == STEPS
    lazy.materialize(opt.count)
    jstate = jlazy.make_materialize(jcfg)(jstate)
    _assert_model_close(model, jstate.params, 1e-3)
    dead = _untouched(VOCAB, [w for b in batches for w in (b[0]["word"], b[1]["word"])])
    assert dead.sum() >= 10
    assert np.array_equal(model.embedding.word_embedding.detach().numpy()[dead], table0[dead])


def test_cached_lazy_20_steps_match_jax_scan(world):
    cfg_kw = dict(SMALL, embed_optimizer="lazy", token_cache=True, steps_per_call=S)
    arrays, uids = augment_token_table(world["table_np"])
    jarrays, juids = jlazy.augment_token_table(world["table_np"])
    assert np.array_equal(uids, juids) and np.array_equal(arrays["winv"], jarrays["winv"])
    jtable = {k: jnp.asarray(v) for k, v in {**jarrays, "uids": juids}.items()}
    ib = world["ibatches"]
    sup0 = {k: v[ib[0][0]] for k, v in world["table_np"].items()}
    qry0 = {k: v[ib[0][1]] for k, v in world["table_np"].items()}
    jcfg, jmodel, jstate = _jax_state(cfg_kw, (sup0, qry0))
    jmulti = jax_cached_multi(jmodel, jcfg)
    cfg = ExperimentConfig(**cfg_kw)
    table = TokenTable(arrays, world["sizes"], "cpu", uids)
    model, opt, lazy = _port(cfg, jstate, uids=table.uids)
    table0 = model.embedding.word_embedding.detach().clone().numpy()
    multi = make_multi_train_step(model, opt, cfg, source=table, lazy=lazy)
    for i in range(0, STEPS, S):
        stacked = stack_batches(ib[i:i + S])
        jstate, jm = jmulti(jstate, jtable, *stacked)
        tm = multi(*stacked)
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]), rtol=2e-4)
    assert np.array_equal(lazy.last.numpy(), np.asarray(jstate.emb_last))
    lazy.materialize(opt.count)
    jstate = jlazy.make_materialize(jcfg)(jstate)
    _assert_model_close(model, jstate.params, 1e-3)
    dead = np.ones(VOCAB, bool)
    dead[uids] = False
    assert np.array_equal(model.embedding.word_embedding.detach().numpy()[dead], table0[dead])


# --- exactness: lazy == the dense twin ------------------------------------------


def _dense_twin(cfg, model_from):
    model = build_model(cfg.replace(embed_optimizer="shared"), device="cpu")
    model.load_state_dict(model_from.state_dict())
    names = [n for n, _ in model.named_parameters()]
    opt = ClipDecayOptimizer(model.parameters(), cfg.lr, cfg.weight_decay, cfg.lr_step_size,
                             cfg.lr_gamma, cfg.grad_clip,
                             rules=["adam_nodecay" if n == "embedding.word_embedding" else "adam"
                                    for n in names])
    return model, opt


@pytest.mark.parametrize("large", [False, True], ids=["onehot", "scatter"])
@pytest.mark.parametrize("cached", [False, True], ids=["live", "cached"])
@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_lazy_equals_dense_twin(world, wd, cached, large, monkeypatch):
    """20 lazy steps == 20 steps of Adam with decay on every parameter but
    the table, at 1e-6 on every parameter (the table materialized). With
    ``large`` both tables take their large-table gradient (the dense one
    ``index_add_``, the compact rows ``segsum_prefix``), as at 400 002 rows."""
    if large:
        monkeypatch.setattr(embedding_module, "MATMUL_GRAD_MAX_ROWS", 0)
    cfg = ExperimentConfig(**{**SMALL, "weight_decay": wd}, embed_optimizer="lazy",
                           token_cache=cached)
    model = build_model(cfg, device="cpu", glove_init=world["vocab"].vectors)
    twin, twin_opt = _dense_twin(cfg, model)
    opt = make_optimizer(cfg, model)
    table = None
    if cached:
        arrays, uids = augment_token_table(world["table_np"])
        table = TokenTable(arrays, world["sizes"], "cpu", uids)
        batches = world["ibatches"]
        dense_table = TokenTable(world["table_np"], world["sizes"], "cpu")
        twin_step = make_train_step(twin, twin_opt, cfg.replace(embed_optimizer="shared"),
                                    source=dense_table)
    else:
        batches = world["batches"]
        twin_step = lambda *b: train_step(twin, twin_opt, cfg, *b)   # noqa: E731
    lazy = LazyTable(model, opt.hyper, live_rows(cfg), uids=None if table is None else table.uids)
    opt.attach_compact(lazy.rows, lazy.rows_m, lazy.rows_v)
    step = make_train_step(model, opt, cfg, source=table, lazy=lazy)
    for b in batches:
        got, want = step(*b), twin_step(*b)
        assert abs(float(got["loss"]) - float(want["loss"])) <= TOL * abs(float(want["loss"]))
    lazy.materialize(opt.count)
    for (name, a), b in zip(model.state_dict().items(), twin.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=0, err_msg=name)
    names = [n for n, _ in model.named_parameters()]
    it = names.index("embedding.word_embedding")
    np.testing.assert_allclose(lazy.m.numpy(), twin_opt.mu[it].numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(lazy.v.numpy(), twin_opt.nu[it].numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("cached", [False, True], ids=["live", "cached"])
def test_fused_lazy_equals_single_steps(world, cached):
    cfg = ExperimentConfig(**SMALL, embed_optimizer="lazy", token_cache=cached, steps_per_call=S)
    runs = []
    for fused in (False, True):
        model = build_model(cfg, device="cpu", glove_init=world["vocab"].vectors)
        opt = make_optimizer(cfg, model)
        table = None
        if cached:
            arrays, uids = augment_token_table(world["table_np"])
            table = TokenTable(arrays, world["sizes"], "cpu", uids)
        lazy = LazyTable(model, opt.hyper, live_rows(cfg),
                         uids=None if table is None else table.uids)
        opt.attach_compact(lazy.rows, lazy.rows_m, lazy.rows_v)
        batches = world["ibatches"] if cached else world["batches"]
        if fused:
            multi = make_multi_train_step(model, opt, cfg, source=table, lazy=lazy)
            losses = torch.cat([multi(*stack_batches(batches[i:i + S]))["loss"]
                                for i in range(0, STEPS, S)])
        else:
            step = make_train_step(model, opt, cfg, source=table, lazy=lazy)
            losses = torch.stack([step(*b)["loss"] for b in batches])
        runs.append((losses, model.state_dict(), lazy.state_dict()))
    assert torch.equal(runs[0][0], runs[1][0])
    for k, v in runs[0][1].items():
        assert torch.equal(runs[1][1][k], v), k
    for k, v in runs[0][2].items():
        assert torch.equal(runs[1][2][k], v), k


def test_lazy_refuses_adamw(tmp_path):
    cfg = ExperimentConfig(**SMALL, embed_optimizer="lazy", optimizer="adamw")
    with pytest.raises(ValueError, match="requires --optimizer adam"):
        make_optimizer(cfg, build_model(cfg, device="cpu"))
    with pytest.raises(ValueError, match="requires --optimizer adam"):
        cli.main(["train", "--device", "cpu", "--embed_optimizer", "lazy", "--optimizer", "adamw",
                  "--N", "3", "--K", "2", "--Q", "2", "--vocab_size", "62", "--max_length", "12",
                  "--lstm_hidden", "8", "--train_iter", "1", "--save_ckpt", str(tmp_path / "c")])


def test_kernel_constants_and_checks_match_the_cuda_source():
    """The host side of csrc/lazy_embed.cu: the widest row a lane set holds,
    the launchers' argument lists, and the wrappers' refusals."""
    import re
    from pathlib import Path

    from induction_network_on_fewrel_tpu_torch.kernels.build import LAUNCHERS
    from induction_network_on_fewrel_tpu_torch.ops import lazy_embed

    src = (Path(lazy_embed.__file__).parents[1] / "csrc" / "lazy_embed.cu").read_text()
    per_lane = int(re.search(r"constexpr int kPerLane = (\d+);", src).group(1))
    assert 32 * per_lane == lazy_embed.MAX_D
    for name in ("lazy_catchup", "lazy_scatter"):
        sig = re.search(rf"int {name}\(([^)]*)\)", src).group(1)
        assert len(sig.split(",")) == len(LAUNCHERS[name][1]), name
    V, D = 8, 4
    table, m, v = (torch.zeros(V, D) for _ in range(3))
    count = torch.tensor(0)
    out = tuple(torch.zeros(2, D) for _ in range(3))
    with pytest.raises(ValueError, match="last must be int32"):
        lazy_catchup(table, m, v, torch.zeros(V), torch.zeros(2, dtype=torch.int32), count,
                     _hyper(ExperimentConfig(**SMALL)), out)
    with pytest.raises(ValueError, match="ids must be int32"):
        lazy_scatter(table, m, v, torch.zeros(V, dtype=torch.int32), torch.zeros(2), out, count)
    with pytest.raises(ValueError, match="1 <= D <= 128"):
        lazy_materialize(torch.zeros(V, 130), torch.zeros(V, 130), torch.zeros(V, 130),
                         torch.zeros(V, dtype=torch.int32), count, _hyper(ExperimentConfig(**SMALL)))


def test_segsum_prefix_matches_index_put():
    """The atomic-free segment sum of the large compact rows: within 1e-6 of
    the output's scale of ``index_put_`` with accumulate (the padding id's
    row sums a third of the tokens), rows no id names exactly zero, the
    same bits on a second run."""
    from induction_network_on_fewrel_tpu_torch.ops.segsum import segsum_prefix, segsum_reference

    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 600, (40, 60), generator=g)
    ids[:, 40:] = 599
    cot = torch.randn(40, 60, 7, generator=g)
    got, want = segsum_prefix(cot, ids, 700), segsum_reference(cot, ids, 700)
    assert (got - want).abs().max() <= TOL * want.abs().max()
    assert torch.equal(got[600:], torch.zeros(100, 7))
    assert torch.equal(got, segsum_prefix(cot, ids, 700))
