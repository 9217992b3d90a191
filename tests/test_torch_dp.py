"""Data parallel in the port against the JAX package's dp mesh.

Two gloo ranks on the CPU (``parallel/rig.run_ranks``: spawned once for
the module, a ``FileStore`` rendezvous, 60 s on init and join, killed on
overrun) train the token-cache lazy step at ``tests/test_comms.py``'s
shapes for 3 steps from the JAX weights (``interop.params_from_jax``) on
the JAX batches, each rank on its own rows of every batch, under five
spellings: monolithic (one flat all-reduce, the embedding cotangent
gathered: ``compact_demb off``), compact (the rows leaf's own
all-reduce), bucketed (4 buckets started from the backward), bucketed
after the backward, and ZeRO-1. Each is held to the JAX step on
``make_mesh(dp=2)``: losses within 1e-5 absolute, parameters within 1e-5
(JAX's own bar, ``tests/test_comms.py:124-131``). The JAX step runs in its
default spelling only: its spellings agree with each other far inside the
bar (bucketed against monolithic 5.96e-08, compact against the dense
table gradient 0.0 over 3 steps at dp=8), and each JAX compile costs
seconds. Each case's gradient norms (rtol 1e-5) and full moments, the
lazy rows' included (1e-5 of each leaf's scale), equal the one-process
run's on the global batch, so a sum where a mean belongs shows; each
case's steps issued the collectives its plan names, counted where they
are issued. ZeRO-1: each rank holds half of every even moment, the
gathered moments equal the one-process run's within 1e-6, and its ring
slot saved at dp=2 resumes in one process onto the uninterrupted
trajectory. The feed's partition and seeds, the bucket resolution and the
compact-demb resolution equal the JAX functions; a failed rendezvous
raises the clean error within its bound.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import json
import os
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.data import (
    GloveTokenizer,
    make_synthetic_fewrel,
    make_synthetic_glove,
)
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu.native.sampler import make_index_sampler
from induction_network_on_fewrel_tpu.parallel import make_mesh as jax_make_mesh
from induction_network_on_fewrel_tpu.parallel import grad_buckets as jax_gb
from induction_network_on_fewrel_tpu.parallel import hostfeed as jax_feed
from induction_network_on_fewrel_tpu.parallel.sharding import demb_impl_for as jax_demb_impl_for
from induction_network_on_fewrel_tpu.train.lazy_embed import augment_token_table
from induction_network_on_fewrel_tpu.train.steps import init_state
from induction_network_on_fewrel_tpu.train.token_cache import (
    make_token_cached_train_step,
    tokenize_dataset,
)
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.interop import PARAM_MAP, params_from_jax
from induction_network_on_fewrel_tpu_torch.parallel import distributed, grad_buckets, hostfeed, rig
from induction_network_on_fewrel_tpu_torch.parallel.mesh import Mesh, make_mesh
from induction_network_on_fewrel_tpu_torch.parallel.sharding import demb_impl_for

L = 12
CFG_KW = dict(
    encoder="bilstm", train_n=3, n=3, k=2, q=2, batch_size=8, max_length=L, vocab_size=302,
    compute_dtype="float32", lstm_hidden=16, att_dim=8, induction_dim=16, ntn_slices=8,
    token_cache=True, steps_per_call=1, embed_optimizer="lazy", lr=1e-3, weight_decay=0.0,
    ckpt_stage="off",
)
STEPS = 3
RESUME_AT = 2
TOL = 1e-5


def _jax_run(corpus):
    vocab, table_np, batches = corpus
    cfg = JaxConfig(**CFG_KW)
    mesh = jax_make_mesh(dp=2)
    model = jax_build_model(cfg, glove_init=vocab.vectors, demb_impl=jax_demb_impl_for(cfg, mesh))
    table = {k: jax.device_put(v, NamedSharding(mesh, P())) for k, v in table_np.items()}
    si, qi, _ = batches[0]
    sup = {k: v[si] for k, v in table_np.items() if k != "uids"}
    qry = {k: v[qi] for k, v in table_np.items() if k != "uids"}
    state = init_state(model, cfg, sup, qry)
    weights = params_from_jax(jax.device_get(state.params["params"]))
    step = make_token_cached_train_step(model, cfg, mesh, state)
    losses = []
    for b in batches:
        state, m = step(state, table, *b)
        losses.append(float(jax.device_get(m["loss"])))
    params = params_from_jax(jax.device_get(state.params["params"]))
    return weights, losses, {k: v.numpy() for k, v in params.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX run (this process) while the two port ranks run (spawned);
    the one-process port reference and the dp=1 resume after them."""
    vocab = make_synthetic_glove(vocab_size=CFG_KW["vocab_size"] - 2)
    ds = make_synthetic_fewrel(num_relations=6,
                               instances_per_relation=CFG_KW["k"] + CFG_KW["q"] + 2,
                               vocab_size=35)
    table_np, sizes = tokenize_dataset(ds, GloveTokenizer(vocab, max_length=L))
    aug, uids = augment_token_table(table_np)
    idx = make_index_sampler(sizes, 3, 2, 2, batch_size=8, seed=0, backend="python")
    batches = []
    for _ in range(STEPS):
        si, qi, lab = idx.sample_fused(1)
        batches.append((si[0], qi[0], lab[0]))
    corpus = (vocab, {**aug, "uids": uids}, batches)
    weights, *jax_out = _jax_run(corpus)
    ckpt = tmp_path_factory.mktemp("zero1_ring")
    payload = dict(cfg=CFG_KW, weights={k: v.numpy() for k, v in weights.items()},
                   table=table_np, sizes=sizes, batches=batches, resume_dir=str(ckpt),
                   resume_at=RESUME_AT)
    ranks: dict = {}

    def spawn():
        try:
            ranks["out"] = rig.run_ranks(rig.dp_cases, 2, payload, timeout_s=60)
        except BaseException as e:    # re-raised below, in the test's thread
            ranks["err"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    thread.join(90)
    assert not thread.is_alive(), "the dp ranks outlived their bound"
    if "err" in ranks:
        raise ranks["err"]
    one = rig.run_cases({**payload, "resume_dir": None}, None)["monolithic"]
    resumed = rig.restore_and_continue(payload, rig.CASES["zero1"], str(ckpt), RESUME_AT)
    return {"ranks": ranks["out"], "jax": jax_out, "one": one, "resumed": resumed}


def _close(got: dict, want: dict, tol: float, what: str) -> None:
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=tol, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("case", sorted(rig.CASES))
def test_dp2_matches_the_jax_dp2_mesh(world, case):
    want_losses, want_params = world["jax"]
    got = world["ranks"][0][case]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=0, atol=TOL)
    _close(got["params"], want_params, TOL, case)


@pytest.mark.parametrize("case", sorted(rig.CASES))
def test_ranks_hold_the_same_replica(world, case):
    a, b = (world["ranks"][r][case] for r in (0, 1))
    assert a["losses"] == b["losses"]
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k], err_msg=k)


@pytest.mark.parametrize("case", sorted(rig.CASES))
def test_dp2_grad_norms_and_moments_equal_one_process(world, case):
    got, want = world["ranks"][0][case], world["one"]
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=TOL, atol=0)
    assert set(got["moments"]) == set(want["moments"]) and len(want["moments"]) >= 26
    for k, w in want["moments"].items():
        np.testing.assert_allclose(got["moments"][k], w, rtol=TOL, atol=TOL * np.abs(w).max(),
                                   err_msg=f"{case}: {k}")


def test_each_spelling_issues_its_collectives(world):
    for r in (0, 1):
        for c in rig.CASES:
            got = world["ranks"][r][c]
            assert got["issued_per_step"] == got["plan"], (r, c)
    plans = {c: world["ranks"][0][c]["plan"] for c in rig.CASES}
    mean = {"metrics/mean": 1}
    assert plans["monolithic"] == {"grad/all": 1, "demb/cotangent_allgather": 1,
                                   "demb/ids_allgather": 1, **mean}
    assert plans["compact"] == {"grad/all": 1, "demb/compact_allreduce": 1, **mean}
    assert plans["bucketed"] == plans["bucketed_sync"] == {
        **{f"grad/bucket_{k}": 1 for k in range(4)}, **mean}
    assert plans["zero1"] == {"grad/all": 1, "demb/compact_allreduce": 1,
                              "zero1/params_bucket_0": 1, **mean}


def test_zero1_rank_holds_half_of_every_even_moment(world):
    z = world["ranks"][0]["zero1"]
    shards, numels = z["zero_shards"], z["moment_numels"]
    assert len(shards) >= 12
    for name, n in numels.items():
        if n % 2 == 0:
            assert shards[name] == (n // 2, n), name
        else:
            assert name not in shards, name


def test_zero1_gathered_moments_equal_one_process(world):
    got, want = world["ranks"][0]["zero1"]["moments"], world["one"]["moments"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=k)


def test_zero1_ring_slot_resumes_at_dp1_onto_the_trajectory(world):
    got, want = world["resumed"], world["ranks"][0]["zero1"]
    assert got["step"] == RESUME_AT
    np.testing.assert_allclose(got["losses"], want["losses"][RESUME_AT:], rtol=0, atol=TOL)
    _close(got["params"], want["params"], TOL, "resumed")


# --- the feed ---------------------------------------------------------------------


@pytest.mark.parametrize("world_size", [1, 2, 4, 8])
def test_feed_partition_and_seeds_match_jax(world_size, monkeypatch):
    B = 16
    jmesh = jax_make_mesh(dp=world_size)
    mesh = make_mesh(world_size=world_size)
    want = jax_feed.episode_ranges_by_process(jmesh, B, process_of=lambda d: d.id)
    assert hostfeed.episode_ranges_by_process(mesh, B) == want
    if world_size > 1:
        with pytest.raises(ValueError, match=f"global batch {B + 1} must divide over dp"):
            hostfeed.episode_ranges_by_process(mesh, B + 1)
    for p in range(world_size):
        assert hostfeed.local_episode_range(Mesh(dp=world_size, rank=p), B) == want[p]
        monkeypatch.setattr(jax, "process_index", lambda p=p: p)
        for seed in (0, 7, 2**40 + 3):
            assert hostfeed.process_seed(seed, rank=p) == jax_feed.process_seed(seed)


def test_per_rank_sampler_reports_the_global_batch_and_carries_its_stream():
    from induction_network_on_fewrel_tpu_torch.sampling.index import IndexEpisodeSampler

    local = IndexEpisodeSampler([6] * 6, 3, 2, 2, batch_size=2, seed=hostfeed.process_seed(0, 1))
    s = hostfeed.PerRankSampler(local, 4)
    assert s.batch_size == 4 and hasattr(s, "sample_fused")
    state = s.feed_state()
    first = s.sample_batch()
    s.restore_feed_state(state)
    again = s.sample_batch()
    assert state["kind"] == "perhost"
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)


# --- the resolutions --------------------------------------------------------------


def _flagship_paths():
    """(JAX path, port name) of every flagship leaf, and the rows leaf."""
    pairs = [("/".join(jp), name) for jp, name, _ in PARAM_MAP if not jp[0].startswith("nota")]
    return pairs + [("lazy_embed/rows", grad_buckets.ROWS_PATH)]


@pytest.mark.parametrize("n_buckets", [1, 2, 3, 4, 5, 8])
def test_bucket_index_matches_jax_on_the_mapped_paths(n_buckets):
    for jpath, name in _flagship_paths():
        assert grad_buckets.bucket_index(name, n_buckets) == jax_gb.bucket_index(jpath, n_buckets)
        assert grad_buckets.bucket_index(jpath, n_buckets) == jax_gb.bucket_index(jpath, n_buckets)


GRID = [(knob, dp, ep, moe, emb) for knob in ("auto", "on", "off") for dp in (1, 2, 4, 8)
        for ep in (1, 2) if dp * ep <= 8 for moe in (0, 4) for emb in ("shared", "lazy")]


@pytest.mark.parametrize("knob,dp,ep,moe,emb", GRID,
                         ids=[f"{k}-dp{d}-{f'ep{p}-' if p > 1 else ''}moe{m}-{e}"
                              for k, d, p, m, e in GRID])
def test_resolutions_match_jax(knob, dp, ep, moe, emb):
    kw = dict(grad_bucketing=knob, grad_bucket_count=3, moe_experts=moe, embed_optimizer=emb,
              encoder="transformer" if moe else "bilstm")
    jcfg, cfg = JaxConfig(**kw), ExperimentConfig(**kw)
    jmesh, mesh = jax_make_mesh(dp=dp, ep=ep), make_mesh(dp=dp, ep=ep, world_size=dp * ep)
    assert grad_buckets.grad_buckets_for(cfg, mesh) == jax_gb.grad_buckets_for(jcfg, jmesh)
    assert grad_buckets.grad_buckets_for(cfg, None) == jax_gb.grad_buckets_for(jcfg, None) == 0
    for compact in ("auto", "on", "off"):
        got = demb_impl_for(cfg.replace(compact_demb=compact), mesh)
        want = jax_demb_impl_for(jcfg.replace(compact_demb=compact), jmesh)
        assert (got is None) == (want is None), compact


def test_mesh_validation_matches_jax():
    with pytest.raises(ValueError, match="exceeds 2 available devices"):
        make_mesh(dp=4, world_size=2)
    with pytest.raises(ValueError, match="exceeds 8 available devices"):
        jax_make_mesh(dp=16)
    assert make_mesh(world_size=4) == Mesh(dp=4)
    assert make_mesh() == Mesh(dp=1)
    for flag in ("tp", "sp", "pp"):
        with pytest.raises(ValueError, match=f"--{flag} 2 is not ported yet: it comes with "
                                             "ROADMAP queue A item 6d"):
            make_mesh(**{flag: 2})
    # ep is ported: the JAX axis arithmetic, then (dp, ep) over the ranks.
    with pytest.raises(ValueError, match=r"1 devices not divisible by pp\*ep\*tp\*sp=2"):
        make_mesh(ep=2)
    with pytest.raises(ValueError, match=r"8 devices not divisible by pp\*ep\*tp\*sp=3"):
        jax_make_mesh(ep=3)
    assert make_mesh(ep=2, world_size=4) == Mesh(dp=2, ep=2)
    assert dict(jax_make_mesh(ep=2).shape)["dp"] == 4


# --- the rendezvous ------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_failed_init_raises_the_clean_error_within_its_bound(monkeypatch):
    for v in distributed.LAUNCHER_ENV:
        monkeypatch.delenv(v, raising=False)
    assert distributed.maybe_initialize_distributed(device="cpu") is False
    # Rank 1 of 2 with nobody listening at the rendezvous address: the
    # store's connection times out at the bound.
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"multi-process initialization failed \(barrier "
                                           r"bound: 3s\).*Likely causes"):
        distributed.maybe_initialize_distributed(device="cpu", timeout_s=3)
    assert time.monotonic() - t0 < 30
    assert not torch.distributed.is_initialized()
    # Any failure inside the rendezvous comes out the same way.
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: (_ for _ in ()).throw(TimeoutError("deadline exceeded")))
    with pytest.raises(RuntimeError, match="deadline exceeded. Likely causes"):
        distributed.maybe_initialize_distributed(device="cpu", timeout_s=3)
    assert os.environ["RANK"] == "1"


def test_config_carries_the_dp_fields_both_ways():
    from induction_network_on_fewrel_tpu_torch.interop import config_from_jax

    dp_kw = dict(dp=4, zero_opt=True, compact_demb="off", grad_bucketing="on",
                 grad_bucket_count=3, async_collectives="off")
    jcfg = JaxConfig(**CFG_KW, **dp_kw)
    ours = config_from_jax(jcfg)
    assert {k: getattr(ours, k) for k in dp_kw} == dp_kw
    assert config_from_jax(json.loads(jcfg.to_json())) == ours
    back = JaxConfig.from_json(ours.to_json())
    assert {k: getattr(back, k) for k in dp_kw} == dp_kw
    defaults = ExperimentConfig()
    assert {k: getattr(defaults, k) for k in dp_kw} == {k: getattr(JaxConfig(), k) for k in dp_kw}
