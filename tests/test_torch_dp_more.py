"""``--adv``, ``--feature_cache`` and ``--mixture`` under data parallel, against JAX.

Two gloo ranks on the CPU (``parallel/rig.run_ranks``, spawned once for the
module, ``rig.dp_more_cases``) while this process runs the JAX steps:

* ``--adv``: the port's adversarial step from the JAX model and
  discriminator weights (``interop``) on the JAX batches (episodes, source
  and target instances; each rank on its rows of each), held to JAX
  ``make_sharded_adv_train_step`` on ``make_mesh(dp=2)`` for 3 steps:
  few-shot and domain losses within 1e-5 absolute, model and
  discriminator parameters within 1e-5 (the JAX dp bar,
  ``tests/test_comms.py:124-131``), with bucketing off and on and under
  ZeRO-1; each step's collectives equal ``DataParallel.plan()`` on both
  ranks, the discriminator's ("disc/") included.
* ``--feature_cache``: a narrow BERT (2 layers, hidden 64); each rank
  encodes the whole table itself, bitwise equal to one process's table,
  and trains the head on its rows of the JAX index batches, held to JAX
  ``make_cached_train_step(..., mesh=make_mesh(dp=2))`` at 1e-5 for 3
  steps (the head-only state reduced whole, and under ZeRO-1), under the
  flagship's MSE loss: under cross entropy the relation head's output
  bias shifts every logit alike, its gradient is zero up to rounding, and
  Adam turns that rounding into steps of +-lr in either package.
* ``--mixture`` through ``cli.make_trainer`` under the mesh: both ranks
  pick the JAX ``MixtureSampler``'s source for each of the first 64
  batches (the same seed on every rank), the children's streams start at
  the JAX ``process_seed`` of each rank, and a run resumed from its ring
  slot at step 4 ends on the uninterrupted run's parameters and stream
  state, bitwise.

The CLI refuses an ``--adv_batch`` that does not divide over the ranks by
name; MoE under dp runs (ported since), and no port text refuses it or
``--ep``.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.data import GloveTokenizer as JaxGloveTokenizer
from induction_network_on_fewrel_tpu.data import make_synthetic_fewrel as jax_fewrel
from induction_network_on_fewrel_tpu.data import make_synthetic_glove as jax_glove
from induction_network_on_fewrel_tpu.data.bert_tokenizer import BertTokenizer as JaxBertTokenizer
from induction_network_on_fewrel_tpu.datapipe import MixtureSampler as JaxMixture
from induction_network_on_fewrel_tpu.datapipe import MixtureSchedule as JaxSchedule
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu.models.adversarial import DomainDiscriminator as JaxDisc
from induction_network_on_fewrel_tpu.models.build import batch_to_model_inputs as jax_inputs
from induction_network_on_fewrel_tpu.parallel import hostfeed as jax_feed
from induction_network_on_fewrel_tpu.parallel import make_mesh as jax_make_mesh
from induction_network_on_fewrel_tpu.parallel.sharding import (
    make_sharded_adv_train_step,
    shard_state,
)
from induction_network_on_fewrel_tpu.sampling import EpisodeSampler as JaxSampler
from induction_network_on_fewrel_tpu.sampling import InstanceSampler as JaxInstances
from induction_network_on_fewrel_tpu.train import feature_cache as jfc
from induction_network_on_fewrel_tpu.train import steps as jsteps
from induction_network_on_fewrel_tpu_torch import cli
from induction_network_on_fewrel_tpu_torch.datapipe.cursor import rng_feed_state
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.data import make_synthetic_fewrel
from induction_network_on_fewrel_tpu_torch.interop import (
    disc_params_from_jax,
    disc_params_to_jax,
    params_from_jax,
    params_to_jax,
)
from induction_network_on_fewrel_tpu_torch.models.build import build_model, encoder_output_dim
from induction_network_on_fewrel_tpu_torch.parallel import distributed, rig
from induction_network_on_fewrel_tpu_torch.parallel import mesh as mesh_mod
from induction_network_on_fewrel_tpu_torch.sampling.index import IndexEpisodeSampler
from induction_network_on_fewrel_tpu_torch.train.steps import init_disc_state

STEPS = 3
TOL = 1e-5
L = 12
ADV = dict(vocab_size=302, max_length=L, train_n=3, n=3, k=2, q=2, batch_size=2,
           lstm_hidden=16, att_dim=8, induction_dim=8, ntn_slices=4, encoder="bilstm",
           compute_dtype="float32", loss="mse", lr=3e-3, weight_decay=1e-4, grad_clip=1.0,
           lr_step_size=7, adv=True, adv_lambda=0.5, adv_dis_hidden=32, adv_batch=8)
BERT_L = 16
CACHE = dict(encoder="bert", bert_frozen=True, feature_cache=True, bert_layers=2,
             bert_hidden=64, bert_heads=4, bert_intermediate=128, bert_vocab_size=500,
             max_length=BERT_L, train_n=3, n=3, k=2, q=2, batch_size=2, induction_dim=8,
             ntn_slices=4, compute_dtype="float32", loss="mse", lr=2e-3, weight_decay=1e-4,
             grad_clip=1.0, lr_step_size=7, lr_gamma=0.5)
CACHE_DATA = dict(num_relations=6, instances_per_relation=9, vocab_size=300,
                  sentence_len=(5, 20), seed=3)
MIXTURE = "train:1;synthetic:1"
MIX_ARGV = ["--synthetic", "--N", "3", "--K", "2", "--Q", "2", "--batch_size", "4",
            "--max_length", "12", "--vocab_size", "40", "--lstm_hidden", "8",
            "--induction_dim", "10", "--ntn_slices", "4", "--device", "cpu", "--sampler",
            "python", "--prefetch_depth", "0", "--val_step", "1000", "--mixture", MIXTURE]
PICKS = 64
HALF = 4


def _np_state(model_or_tree) -> dict:
    tree = model_or_tree.state_dict() if hasattr(model_or_tree, "state_dict") else model_or_tree
    return {k: v.detach().numpy() for k, v in tree.items()}


def _jax_state(apply_fn, params, cfg):
    """A JAX TrainState on the port's weights (no flax init run)."""
    return jsteps.TrainState.create(apply_fn=apply_fn, params={"params": params},
                                    tx=jsteps.make_optimizer(cfg))


def _adv_world():
    """The port's payload (its fresh weights, the JAX samplers' batches) and
    the JAX run on make_mesh(dp=2) from the same weights."""
    vocab = jax_glove(vocab_size=300)
    src_ds = jax_fewrel(num_relations=6, instances_per_relation=10, vocab_size=300, seed=0)
    tgt_ds = jax_fewrel(num_relations=6, instances_per_relation=10, vocab_size=300, seed=97)
    tok = JaxGloveTokenizer(vocab, max_length=L)
    ep = JaxSampler(src_ds, tok, n=3, k=2, q=2, batch_size=2, seed=0)
    src = JaxInstances(src_ds, tok, batch_size=8, seed=1)
    tgt = JaxInstances(tgt_ds, tok, batch_size=8, seed=2)
    batches = [jax_inputs(ep.sample_batch()) + (src.sample_batch()._asdict(),
                                                tgt.sample_batch()._asdict())
               for _ in range(STEPS)]
    cfg = ExperimentConfig(**ADV, lstm_backend="reference", attn_backend="reference")
    model = build_model(cfg, device="cpu")
    disc = init_disc_state(cfg, encoder_output_dim(cfg), "cpu")
    payload = dict(cfg=dict(ADV, lstm_backend="reference", attn_backend="reference"),
                   weights=_np_state(model), disc_weights=_np_state(disc.module),
                   batches=batches)

    def run():
        jcfg = JaxConfig(**ADV, model="induction", lstm_backend="scan", attn_backend="xla")
        jmodel, jdisc = jax_build_model(jcfg), JaxDisc(hidden=jcfg.adv_dis_hidden)
        state = _jax_state(jmodel.apply, params_to_jax(model.state_dict()), jcfg)
        dstate = _jax_state(jdisc.apply, disc_params_to_jax(disc.module.state_dict()),
                            jcfg.replace(embed_optimizer="shared"))
        mesh = jax_make_mesh(dp=2)
        step = make_sharded_adv_train_step(jmodel, jdisc, jcfg, mesh, state, dstate)
        st, dst = shard_state(state, mesh), shard_state(dstate, mesh)
        losses, dom = [], []
        for b in batches:
            st, dst, m = step(st, dst, *b)
            losses.append(float(m["loss"]))
            dom.append(float(m["domain_loss"]))
        return {"losses": losses, "domain_losses": dom,
                "params": _np_state(params_from_jax(jax.device_get(st.params["params"]))),
                "disc_params": _np_state(disc_params_from_jax(
                    jax.device_get(dst.params["params"])))}

    return payload, run


def _cache_world():
    """The port's payload (its fresh backbone and head weights, index
    batches) and the JAX cached step on make_mesh(dp=2) over the table the
    JAX ``encode_dataset`` makes with the same backbone weights."""
    cfg = ExperimentConfig(**CACHE)
    backbone = build_model(cfg.replace(feature_cache=False), device="cpu")
    head = build_model(cfg, device="cpu")
    ds = make_synthetic_fewrel(**CACHE_DATA)
    sizes = [len(ds.instances[r]) for r in ds.rel_names]
    idx = IndexEpisodeSampler(sizes, 3, 2, 2, batch_size=2, seed=9)
    batches = [tuple(idx.sample_batch()) for _ in range(STEPS)]
    payload = dict(cfg=CACHE, backbone=_np_state(backbone), head=_np_state(head),
                   data=CACHE_DATA, encode_batch=16, batches=batches)

    def run():
        jcfg = JaxConfig(**CACHE)
        jmodel = jax_build_model(jcfg)
        full = {"params": params_to_jax(backbone.state_dict())}
        blocks = jfc.encode_dataset(jmodel, full, jax_fewrel(**CACHE_DATA),
                                    JaxBertTokenizer(max_length=BERT_L, vocab_size=500),
                                    batch_size=16)
        state = _jax_state(jmodel.apply, params_to_jax(head.state_dict()), jcfg)
        mesh = jax_make_mesh(dp=2)
        step = jfc.make_cached_train_step(jmodel, jcfg, mesh=mesh, state_example=state)
        table = jax.device_put(np.concatenate(blocks).astype(np.float32),
                               NamedSharding(mesh, P()))
        st = shard_state(state, mesh)
        losses = []
        for b in batches:
            st, m = step(st, table, *b)
            losses.append(float(m["loss"]))
        return {"losses": losses, "table": np.concatenate(blocks),
                "params": _np_state(params_from_jax(jax.device_get(st.params["params"])))}

    return payload, run


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The two port ranks (spawned) while this process runs the JAX steps,
    then the port's one-process feature table."""
    adv_payload, adv_jax = _adv_world()
    cache_payload, cache_jax = _cache_world()
    payload = {"adv": adv_payload, "cache": cache_payload,
               "mixture": {"argv": MIX_ARGV, "picks": PICKS, "half": HALF,
                           "ckpt": str(tmp_path_factory.mktemp("mixture_ring"))}}
    ranks: dict = {}

    def spawn():
        try:
            ranks["out"] = rig.run_ranks(rig.dp_more_cases, 2, payload, timeout_s=90)
        except BaseException as e:    # re-raised below, in the test's thread
            ranks["err"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    want = {"adv": adv_jax(), "cache": cache_jax()}
    one = rig.more_cases({"cache": cache_payload}, None)["cache"]["cache"]
    thread.join(120)
    assert not thread.is_alive(), "the dp ranks outlived their bound"
    if "err" in ranks:
        raise ranks["err"]
    return {"ranks": ranks["out"], "jax": want, "one_table": one["table"]}


def _close(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=TOL, err_msg=f"{what}: {k}")


# --- --adv --------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(rig.ADV_CASES))
def test_adv_dp2_matches_the_jax_dp2_mesh(world, case):
    want = world["jax"]["adv"]
    got = world["ranks"][0]["adv"][case]
    np.testing.assert_allclose(got["loss"], want["losses"], rtol=0, atol=TOL)
    np.testing.assert_allclose(got["domain_loss"], want["domain_losses"], rtol=0, atol=TOL)
    _close(got["params"], want["params"], case)
    _close(got["disc_params"], want["disc_params"], f"{case} discriminator")


@pytest.mark.parametrize("case", sorted(rig.ADV_CASES))
def test_adv_ranks_hold_the_same_replica(world, case):
    a, b = (world["ranks"][r]["adv"][case] for r in (0, 1))
    assert a["loss"] == b["loss"] and a["domain_loss"] == b["domain_loss"]
    for part in ("params", "disc_params"):
        for k in a[part]:
            np.testing.assert_array_equal(a[part][k], b[part][k], err_msg=f"{part}: {k}")


def test_adv_collectives_equal_the_plan(world):
    for r in (0, 1):
        for case in rig.ADV_CASES:
            got = world["ranks"][r]["adv"][case]
            assert got["issued_per_step"] == got["plan"], (r, case)
    plans = {c: world["ranks"][0]["adv"][c]["plan"] for c in rig.ADV_CASES}
    mean = {"metrics/mean": 1}
    assert plans["adv_monolithic"] == {"grad/all": 1, "disc/grad/all": 1, **mean}
    bucketed = plans["adv_bucketed"]
    assert {k for k in bucketed if k.startswith("grad/")} == {f"grad/bucket_{b}"
                                                              for b in range(4)}
    assert [k for k in bucketed if k.startswith("disc/")] == ["disc/grad/bucket_1"]
    assert plans["adv_zero1"] == {"grad/all": 1, "disc/grad/all": 1,
                                  "zero1/params_bucket_0": 1, **mean}
    assert world["ranks"][0]["adv"]["adv_zero1"]["zero_shards"] >= 8


# --- --feature_cache ------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(rig.CACHE_CASES))
def test_cache_dp2_matches_the_jax_dp2_mesh(world, case):
    want = world["jax"]["cache"]
    got = world["ranks"][0]["cache"][case]
    np.testing.assert_allclose(got["loss"], want["losses"], rtol=0, atol=TOL)
    _close(got["params"], want["params"], case)
    other = world["ranks"][1]["cache"][case]
    for k in got["params"]:
        np.testing.assert_array_equal(got["params"][k], other["params"][k], err_msg=k)
    assert got["issued_per_step"] == got["plan"] == other["issued_per_step"]


def test_cache_each_rank_table_equals_the_one_process_table(world):
    one = world["one_table"]
    assert one.shape == (6 * 9, 64)
    jt = world["jax"]["cache"]["table"]
    assert np.abs(one - jt).max() <= TOL * np.abs(jt).max()           # JAX's encode
    for r in (0, 1):
        for case in rig.CACHE_CASES:
            np.testing.assert_array_equal(world["ranks"][r]["cache"][case]["table"], one)


# --- --mixture ------------------------------------------------------------------------


class _Child:
    batch_size, total_q = 4, 6

    def __init__(self, name):
        self.name = name

    def sample_batch(self):
        return self.name


def test_mixture_picks_match_the_jax_mixture_on_both_ranks(world):
    sched = JaxSchedule.parse(MIXTURE)
    seed = cli.config_from_args(cli.parse_args(True, MIX_ARGV)).seed
    jmix = JaxMixture([(n, _Child(n)) for n in sched.names], sched, seed=seed)
    want = [list(sched.names).index(jmix.sample_batch()) for _ in range(PICKS)]
    assert 0 < sum(want) < PICKS                                # both sources serve
    for r in (0, 1):
        m = world["ranks"][r]["mixture"]
        assert m["seed"] == seed and m["picks"] == want
        served = want[:2 * HALF]
        assert m["counts"] == {"train": served.count(0), "synthetic": served.count(1)}


def test_mixture_children_start_at_the_jax_process_seeds(world, monkeypatch):
    seed = cli.config_from_args(cli.parse_args(True, MIX_ARGV)).seed
    for r in (0, 1):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        states = world["ranks"][r]["mixture"]["child_states"]
        for name, base in (("train", seed), ("synthetic", seed + 1000 + 1)):
            want = rng_feed_state(np.random.default_rng(jax_feed.process_seed(base)))
            assert states[name] == want, (r, name)
    assert world["ranks"][0]["mixture"]["child_states"] != \
        world["ranks"][1]["mixture"]["child_states"]


def test_mixture_resume_from_the_ring_slot_continues_each_rank_bitwise(world):
    for r in (0, 1):
        m = world["ranks"][r]["mixture"]
        assert m["resumed"]["step"] == HALF
        assert m["resumed"]["stream"] == m["whole"]["stream"]
        assert m["whole"]["stream"]["sampler_state"]["kind"] == "perhost"
        assert m["whole"]["stream"]["sampler_state"]["local"]["next"] == 2 * HALF
        for k, v in m["whole"]["params"].items():
            np.testing.assert_array_equal(m["resumed"]["params"][k], v, err_msg=k)
    a, b = (world["ranks"][r]["mixture"]["whole"] for r in (0, 1))
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k], err_msg=k)


# --- the refusals that stay -----------------------------------------------------------


@pytest.mark.parametrize("flags,msg", [
    (["--adv", "--adv_batch", "3"], "--adv_batch 3 must be divisible by the data-parallel "
                                    "mesh axis dp=2 .* try --adv_batch 4"),
    # MoE under a mesh is ported: no refusal, the mesh comes back.
    (["--encoder", "transformer", "--moe_experts", "8"], None),
], ids=["adv_batch", "moe"])
def test_still_refused_by_name_under_a_mesh(flags, msg, monkeypatch):
    monkeypatch.setattr(distributed, "maybe_initialize_distributed", lambda **kw: True)
    monkeypatch.setattr(mesh_mod, "make_mesh", lambda dp=None, **kw: mesh_mod.Mesh(dp=2))
    args = cli.parse_args(True, [*MIX_ARGV[:-2], "--dp", "2", *flags])
    if msg is None:
        assert cli.dp_mesh(args, cli.config_from_args(args)) == mesh_mod.Mesh(dp=2)
        return
    with pytest.raises(ValueError, match=msg):
        cli.dp_mesh(args, cli.config_from_args(args))


def test_no_port_text_names_item_5():
    """Data parallel is ported whole: no text of the port names item 5, and
    the docs of the mesh, the rig and ``dp_mesh`` name the pp axis (the
    last sharded executor, ported since) beside the others."""
    import pathlib

    root = pathlib.Path(cli.__file__).parent
    files = list(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
    hits = [str(p) for p in files if "item 5" in p.read_text() or "LATER_ITEMS" in p.read_text()]
    assert hits == []
    for doc in (rig.__doc__, cli.dp_mesh.__doc__, mesh_mod.__doc__):
        assert "pp" in doc and "item 6d" not in doc


def test_no_port_text_refuses_ep_or_moe_under_dp():
    """MoE under dp and the expert-parallel executor are ported: no port
    text refuses either, and no flag is left deferred (tp, sp and pp are
    ported since)."""
    import pathlib

    from induction_network_on_fewrel_tpu_torch.models import build

    root = pathlib.Path(cli.__file__).parent
    files = list(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
    gone = ("--moe_experts under data parallel is refused", "--ep is not ported yet",
            "check_moe", "sp ring attention, pp, ep)")
    assert [(str(p), g) for p in files for g in gone if g in p.read_text()] == []
    assert "--ep" not in cli.DEFERRED and cli.DEFERRED == {}
    assert not hasattr(build, "SHARDED")
