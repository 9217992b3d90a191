"""Pipeline parallel in the port against the JAX GPipe and single-device step (CPU).

Two worlds of gloo ranks (``parallel/rig.run_ranks``, ``rig.dp_pp_cases``),
spawned once each for the module and run while this process runs the JAX
reference, at the widths of ``tests/test_pipeline.py`` (4 layers, width 32,
2 heads, FFN 64, L=12, f32):

* the encoder alone (``rig.pipe_encoder``, weights from the JAX flax init
  carried by ``interop``): the port's GPipe at pp 2 (two ranks) and 4 (four
  ranks) with 4 microbatches, held to JAX ``sequential_blocks`` and to
  ``make_gpipe`` on ``tests/conftest.py``'s 8-device CPU mesh, forward and
  the gradients of ``Σ out ⊙ R`` (the input's and every leaf's) within 1e-5
  of each one's scale; at pp=2 with 2, 4 and 8 microbatches the bubbles
  never reach the outputs (JAX ``tests/test_pipeline.py:73``);
* the induction head over the stacked transformer (B=8 of 3-way 2-shot
  Q=2, Adam at lr 1e-3) at (dp, pp, tp) = (1, 2, 1) on two ranks and (2,
  2, 1), (1, 2, 2), (1, 4, 1) on four, held to JAX ``make_train_step`` on
  the global batch (the first forward's logits, each rank's rows, and
  every gradient leaf within 1e-5 of scale; the losses of the first ``AT``
  steps within 1e-5 and the parameters after them within 1e-5; over STEPS
  = 20 steps the losses rtol 2e-4 and the parameters atol 1e-3, the
  ROADMAP bars) and to the port's one-process run (losses within 1e-5,
  gradient norms rtol 1e-5, parameters after ``AT`` steps within 1e-5, the
  eval metrics). The 1e-5 parameter bars leave out the elements whose
  first-batch gradient is nonzero rounding noise (below 1e-6 of the leaf's
  largest: the attention key biases, checked, as in
  ``tests/test_torch_tp_sp.py``): Adam steps such an element by its noise.
  Each rank holds ``[NL/pp, ...]`` of every stack leaf and of its moments;
  every replicated leaf is equal on every rank after every step; each
  step issues the collectives of ``DataParallel.plan``;
* the token cache with lazy Adam at (1, 2, 1) and under ZeRO-1 at (2, 2,
  1), held to one process at ``tests/test_torch_dp.py``'s bars; the ZeRO-1
  run saves a ring slot after ``AT`` steps, which one process restores and
  continues to the pp run's end;
* checkpoints across pp: a pp=2 end state restores in one process and a
  (2, 2, 1) one at (1, 4, 1), a one-process one at (1, 2, 1), every
  parameter and moment equal; the CLI: ``train`` and ``test`` under (1, 2,
  1) and (1, 2, 2), ``test`` at pp=1 of the pp=2 checkpoint and at pp=2
  of a one-process one, each equal to the one-process evaluation of the
  same episodes, the serving engine's logits on the pp=2 checkpoint against
  the one-process run's, ``--resume`` under pp equal to the uninterrupted
  run, and ``--adv``, ``--mixture`` and the token cache with lazy Adam and
  ``--zero_opt`` through ``cli train`` under pp;
* the refusals, each word for word the JAX text (the JAX ``make_trainer``
  and ``build_model`` raise them here too): rows that do not split into
  the microbatches, layers that do not split into the stages, ``--pp`` off
  the transformer and with MoE or ``--sp``.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import json
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu import cli as jcli
from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.data import GloveTokenizer as JaxTokenizer
from induction_network_on_fewrel_tpu.data import make_synthetic_fewrel as jax_fewrel
from induction_network_on_fewrel_tpu.data import make_synthetic_glove as jax_glove
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu.models.build import batch_to_model_inputs as jax_inputs
from induction_network_on_fewrel_tpu.models.pipeline_transformer import (
    PipelinedTransformerEncoder as JaxStacked,
)
from induction_network_on_fewrel_tpu.parallel import make_gpipe
from induction_network_on_fewrel_tpu.parallel import make_mesh as jax_make_mesh
from induction_network_on_fewrel_tpu.sampling.episodes import EpisodeSampler as JaxSampler
from induction_network_on_fewrel_tpu.train import steps as jsteps
from induction_network_on_fewrel_tpu_torch import cli
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.interop import params_from_jax, params_to_jax
from induction_network_on_fewrel_tpu_torch.models.build import STACKED_WITH, build_model
from induction_network_on_fewrel_tpu_torch.parallel import mesh as mesh_mod
from induction_network_on_fewrel_tpu_torch.parallel import rig
from induction_network_on_fewrel_tpu_torch.parallel.pipeline import microbatch_refusal

L = 12
D = 32
NL = 4
ENC = dict(input_dim=20, num_layers=NL, d_model=D, num_heads=2, d_ff=64, max_length=L)
BASE = dict(model="induction", train_n=3, n=3, k=2, q=2, batch_size=8, max_length=L,
            vocab_size=302, compute_dtype="float32", lr=1e-3, weight_decay=0.0,
            encoder="transformer", tfm_layers=NL, tfm_model=D, tfm_heads=2, tfm_ff=64,
            tfm_stacked=True, induction_dim=8, ntn_slices=4, pp_microbatches=4)
VARIANTS = {"tfm": {}}
WORLDS = {2: [(1, 2, 1)], 4: [(2, 2, 1), (1, 2, 2), (1, 4, 1)]}
CASES = [(n, lay) for n, lays in WORLDS.items() for lay in lays]
IDS = [rig.pp_name(*lay) for _, lay in CASES]
STEPS = 20
AT = rig.MOE_DP_AT
TOL = 1e-5
NOISE = 1e-6
BUBBLES = (2, 4, 8)
ARGV = ["--synthetic", "--device", "cpu", "--encoder", "transformer", "--tfm_stacked",
        "--tfm_layers", "4",
        "--tfm_model", "32", "--tfm_heads", "2", "--tfm_ff", "64", "--N", "3", "--K", "2",
        "--Q", "2", "--batch_size", "4", "--max_length", "12", "--vocab_size", "40",
        "--induction_dim", "8", "--ntn_slices", "4", "--sampler", "python",
        "--prefetch_depth", "0", "--test_iter", "8"]
CLI_TRAIN = ["--train_iter", "4", "--val_step", "4", "--val_iter", "8"]
LAZY_ARGV = ["--token_cache", "--embed_optimizer", "lazy"]


def _np(sd) -> dict:
    return {k: v.detach().numpy() for k, v in sd.items()}


def _batches() -> list:
    ds = jax_fewrel(num_relations=6, instances_per_relation=8, vocab_size=300)
    s = JaxSampler(ds, JaxTokenizer(jax_glove(vocab_size=300), max_length=L), 3, 2, 2,
                   batch_size=BASE["batch_size"], seed=0)
    return [jax_inputs(s.sample_batch()) for _ in range(STEPS)]


def _lazy_payload(resume_dir: str) -> dict:
    """``rig.run_cases``'s payload: the token-cache lazy step from the seed's
    weights on AT + 2 global index batches; the ZeRO-1 case saves a ring
    slot to ``resume_dir`` after AT steps."""
    from induction_network_on_fewrel_tpu_torch.data import GloveTokenizer, make_synthetic_glove
    from induction_network_on_fewrel_tpu_torch.data import make_synthetic_fewrel
    from induction_network_on_fewrel_tpu_torch.sampling.index import IndexEpisodeSampler
    from induction_network_on_fewrel_tpu_torch.train.token_cache import tokenize_dataset

    table, sizes = tokenize_dataset(
        make_synthetic_fewrel(num_relations=6, instances_per_relation=8, vocab_size=300),
        GloveTokenizer(make_synthetic_glove(vocab_size=300), max_length=L))
    idx = IndexEpisodeSampler(sizes, 3, 2, 2, batch_size=BASE["batch_size"], seed=0)
    batches = []
    for _ in range(AT + 2):
        si, qi, lab = idx.sample_fused(1)
        batches.append((si[0], qi[0], lab[0]))
    return {"cfg": {**BASE, "token_cache": True, "embed_optimizer": "lazy"}, "weights": None,
            "table": table, "sizes": sizes, "batches": batches, "resume_dir": resume_dir,
            "resume_at": AT}


def _encoder_case() -> tuple[dict, dict]:
    """(the ranks' encoder payload, the JAX encoder's results): JAX
    ``sequential_blocks`` and ``make_gpipe`` at pp 2 and 4 (4 microbatches)
    and at pp 2 with each of BUBBLES, forward and the gradients of
    ``Σ out ⊙ R`` for the input and every leaf."""
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(8, L, ENC["input_dim"])).astype(np.float32)
    mask = np.ones((8, L), np.float32)
    mask[:, 9:] = 0.0
    mask[3, 4:] = 0.0
    R = rng.normal(size=(8, D)).astype(np.float32)
    widths = {k: v for k, v in ENC.items() if k != "input_dim"}
    seq = JaxStacked(**widths)
    params = seq.init(jax.random.key(1), jnp.asarray(emb), jnp.asarray(mask))
    weights = {k.removeprefix("encoder."): v.numpy() for k, v in
               params_from_jax({"encoder": jax.device_get(params["params"])}).items()}

    def run(enc):
        def f(p, x):
            out = enc.apply(p, x, jnp.asarray(mask))
            return jnp.sum(out * R), out

        (_, out), (gp, gx) = jax.device_get(jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(emb)))
        grads = {k.removeprefix("encoder."): v.numpy() for k, v in
                 params_from_jax({"encoder": gp["params"]}).items()}
        return {"out": np.asarray(out), "x_grad": np.asarray(gx), "grads": grads}

    want = {"seq": run(seq)}
    for pp, m in [(2, 4), (4, 4)] + [(2, m) for m in BUBBLES if m != 4]:
        mesh = jax_make_mesh(dp=1, pp=pp, devices=jax.devices()[:pp])
        want[(pp, m)] = run(seq.copy(pipeline_impl=make_gpipe(mesh, microbatches=m)))
    payload = {"encoder": ENC, "weights": weights, "emb": emb, "mask": mask, "R": R}
    return payload, want


def _jax_run(weights: dict, batches: list) -> dict:
    """The JAX forward's logits and loss gradient at the first batch, and
    the trajectory (parameters after AT and STEPS steps), single-device on
    the global batches."""
    jcfg = JaxConfig(**BASE)
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
    batches = {"tfm": _batches()}
    weights = {"tfm": _np(build_model(ExperimentConfig(**BASE), device="cpu").state_dict())}
    d = {k: str(tmp_path_factory.mktemp(k)) for k in (
        "one", "pp2", "pp2dp2", "cli2", "cli4", "cli1", "lazy", "resume", "whole", "adv", "mix",
        "lazycli")}
    enc_payload, enc_want = _encoder_case()
    payload = dict(cfg=BASE, variants=VARIANTS, variant_weights=weights,
                   variant_batches=batches, step_digests=True, encoder_case=enc_payload,
                   lazy={"tfm": _lazy_payload(d["lazy"])})
    # The one-process references the ranks restore: a ring slot, a CLI run.
    one = {"tfm": rig.run_moe_case(payload, "tfm", None, d["one"])}
    assert cli.main(["train", *ARGV, *CLI_TRAIN, "--save_ckpt", d["cli1"]]) == 0
    resume = [*ARGV, "--val_step", "4", "--val_iter", "8", "--save_ckpt"]
    payload["worlds"] = {
        2: {"cases": [("tfm", lay) for lay in WORLDS[2]], "encoder_pp": 2,
            "encoder_case": {**enc_payload, "microbatches": BUBBLES},
            "saves": {("tfm", "dp1_pp2_tp1"): d["pp2"]},
            "lazy_cases": [("tfm", (1, 2, 1))],
            "cli": {"dp1_pp2_tp1": (ARGV, CLI_TRAIN, d["cli2"])},
            "cli_paths": [
                ("resume_first", (1, 2, 1), [*resume, d["resume"], "--train_iter", "4"]),
                ("resume", (1, 2, 1), [*resume, d["resume"], "--train_iter", "4", "--resume"]),
                ("whole", (1, 2, 1), [*resume, d["whole"], "--train_iter", "8"]),
                ("adv", (1, 2, 1), [*ARGV, *CLI_TRAIN, "--adv", "--adv_batch", "4",
                                    "--adv_dis_hidden", "8", "--save_ckpt", d["adv"]]),
                ("mixture", (1, 2, 1), [*ARGV, *CLI_TRAIN, "--mixture", "train:1;synthetic:1",
                                        "--save_ckpt", d["mix"]])],
            "cli_tests": [("one_process_ckpt", (1, 2, 1), [*ARGV, "--load_ckpt", d["cli1"]])],
            "restores": [("tfm", 1, 2, 1, d["one"])]},
        4: {"cases": [("tfm", lay) for lay in WORLDS[4]], "encoder_pp": 4,
            "encoder_case": {**enc_payload, "microbatches": (4,)},
            "saves": {("tfm", "dp2_pp2_tp1"): d["pp2dp2"]},
            "lazy_cases": [("tfm", (2, 2, 1), "zero1")],
            "cli": {"dp1_pp2_tp2": (ARGV, CLI_TRAIN, d["cli4"])},
            "cli_paths": [("lazy_zero", (2, 2, 1), [*ARGV, *CLI_TRAIN, *LAZY_ARGV, "--zero_opt",
                                                    "--save_ckpt", d["lazycli"]])],
            "restores": [("tfm", 1, 4, 1, d["pp2dp2"])]},
    }
    ranks: dict = {}

    def spawn(n):
        try:
            ranks[n] = rig.run_ranks(rig.dp_pp_cases, n, payload, timeout_s=240)
        except BaseException as e:    # re-raised below, in the test's thread
            ranks[f"err{n}"] = e

    threads = [threading.Thread(target=spawn, args=(n,)) for n in (2, 4)]
    for t in threads:
        t.start()
    want = {"tfm": _jax_run(weights["tfm"], batches["tfm"])}
    loop = rig.pipe_encoder({**enc_payload, "microbatches": (4,)}, None)[4]
    lazy_one = rig.run_cases({**payload["lazy"]["tfm"], "resume_dir": None})["monolithic"]
    for t in threads:
        t.join(270)
    assert not any(t.is_alive() for t in threads), "the ranks outlived their bound"
    for n in (2, 4):
        if f"err{n}" in ranks:
            raise ranks[f"err{n}"]
    continued = rig.restore_and_continue(payload["lazy"]["tfm"], rig.CASES["zero1"], d["lazy"],
                                         AT)
    return {"ranks": ranks, "jax": want, "one": one, "payload": payload, "dirs": d,
            "enc_jax": enc_want, "enc_loop": loop, "lazy_one": lazy_one,
            "continued": continued,
            "restored": rig.restore_moe(payload, "tfm", None, d["pp2"]),
            "test_ref": {key: rig.moe_test_reference(ARGV, d[key], 1)
                         for key in ("cli2", "cli4", "cli1")}}


def _results(world, n: int, lay: tuple) -> list:
    return [r[rig.pp_name(*lay)]["tfm"] for r in world["ranks"][n]]


def _rows(n: int, lay: tuple, rank: int, B: int) -> slice:
    """The global episodes a rank of ``lay`` holds (B over dp)."""
    dp = lay[0]
    d = rank // (n // dp)
    return slice(d * B // dp, (d + 1) * B // dp)


def _noise(grads: dict) -> dict:
    """Per leaf, the elements whose first-batch gradient is rounding noise:
    nonzero and below NOISE of the leaf's largest."""
    out = {}
    for k, g in grads.items():
        a = np.abs(g)
        out[k] = (a > 0) & (a < NOISE * a.max())
    return out


def _key_bias(name: str, shape) -> np.ndarray:
    """The elements of leaf ``name`` that are an attention block's key bias
    (the middle third of each layer's ``stack_qkv_b``)."""
    mask = np.zeros(shape, bool)
    if name.endswith("stack_qkv_b"):
        mask[..., D:2 * D] = True
    return mask


def _held(got: dict, want: dict, noise: dict, tol: float, what: str) -> None:
    assert set(got) == set(want), what
    left = sum(int(m.sum()) for m in noise.values())
    assert left < 1e-2 * sum(w.size for w in want.values()), (what, left)
    for k, w in want.items():
        keep = ~noise[k]
        np.testing.assert_allclose(got[k][keep], w[keep], atol=tol, rtol=tol,
                                   err_msg=f"{what}: {k}")


def _scaled(got: np.ndarray, want: np.ndarray, what: str) -> None:
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale, err_msg=what)


# --- the encoder: the port's GPipe against the JAX scan and GPipe ------------------


@pytest.mark.parametrize("pp", [2, 4])
@pytest.mark.parametrize("ref", ["sequential_blocks", "make_gpipe"])
def test_gpipe_forward_and_gradients_match_jax(world, pp, ref):
    want = world["enc_jax"]["seq" if ref == "sequential_blocks" else (pp, 4)]
    for r, res in enumerate(world["ranks"][pp]):
        got = res["encoder"][4]
        for key in ("out", "eval", "x_grad"):
            _scaled(got[key], want["out" if key == "eval" else key], f"rank {r} {key}")
        assert set(got["grads"]) == set(want["grads"])
        for k, w in want["grads"].items():
            _scaled(got["grads"][k], w, f"rank {r} gradient {k}")


def test_gpipe_equals_the_port_loop(world):
    loop = world["enc_loop"]
    for pp in (2, 4):
        for r, res in enumerate(world["ranks"][pp]):
            got = res["encoder"][4]
            np.testing.assert_array_equal(got["out"], loop["out"], err_msg=f"pp {pp} rank {r}")
            for k, w in loop["grads"].items():
                _scaled(got["grads"][k], w, f"pp {pp} rank {r} gradient {k}")


@pytest.mark.parametrize("m", BUBBLES)
def test_bubbles_never_reach_the_outputs(world, m):
    seq = world["enc_jax"]["seq"]
    for r, res in enumerate(world["ranks"][2]):
        got = res["encoder"][m]
        _scaled(got["out"], seq["out"], f"m={m} rank {r}")
        _scaled(got["out"], world["enc_jax"][(2, m)]["out"], f"m={m} rank {r} vs make_gpipe")
        for k, w in seq["grads"].items():
            _scaled(got["grads"][k], w, f"m={m} rank {r} gradient {k}")


@pytest.mark.parametrize("pp", [2, 4])
def test_each_stage_holds_its_layers_only(world, pp):
    for res in world["ranks"][pp]:
        for name, shape in res["encoder"][4]["local_shapes"].items():
            if name.startswith("encoder.stack_"):
                assert shape[0] == NL // pp, name


# --- training on the global batch --------------------------------------------------


@pytest.mark.parametrize("n,lay", CASES, ids=IDS)
def test_forward_and_gradients_match_jax_on_the_global_batch(world, n, lay):
    want = world["jax"]["tfm"]
    scale = float(np.abs(want["logits"]).max())
    B = len(want["logits"])
    for r, got in enumerate(_results(world, n, lay)):
        np.testing.assert_allclose(got["logits"], want["logits"][_rows(n, lay, r, B)], rtol=0,
                                   atol=TOL * scale, err_msg=f"rank {r}")
        for k, w in want["grads"].items():
            np.testing.assert_allclose(got["grads"][k], w, rtol=TOL,
                                       atol=TOL * float(np.abs(w).max()),
                                       err_msg=f"rank {r} gradient: {k}")


@pytest.mark.parametrize("n,lay", CASES, ids=IDS)
def test_steps_match_jax_at_its_sharded_bar_and_over_the_trajectory(world, n, lay):
    want = world["jax"]["tfm"]
    for r, got in enumerate(_results(world, n, lay)):
        np.testing.assert_allclose(got["losses"][:AT], want["losses"][:AT], rtol=0, atol=TOL)
        _held(got["params_at"], want["params_at"], _noise(want["grads"]), TOL,
              f"rank {r} after {AT} steps")
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4, err_msg=f"rank {r}")
        for k, w in want["params"].items():
            np.testing.assert_allclose(got["params"][k], w, atol=1e-3, err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("n,lay", CASES, ids=IDS)
def test_ranks_equal_one_process_and_each_other(world, n, lay):
    one = world["one"]["tfm"]
    res = _results(world, n, lay)
    for r, got in enumerate(res):
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=0, atol=TOL)
        np.testing.assert_allclose(got["grad_norms"], one["grad_norms"], rtol=TOL, atol=0)
        _held(got["params_at"], one["params_at"], _noise(one["grads"]), TOL, f"rank {r}")
        if lay[0] == 1:         # the whole batch on every rank: the same eval metrics
            for k, w in one["eval"].items():
                assert got["eval"][k] == pytest.approx(w, abs=1e-6), (r, k)
        for k in got["params"]:
            np.testing.assert_array_equal(got["params"][k], res[0]["params"][k], err_msg=k)


@pytest.mark.parametrize("n,lay", CASES, ids=IDS)
def test_replicated_leaves_stay_equal_on_every_rank_after_every_step(world, n, lay):
    res = _results(world, n, lay)
    assert len(res[0]["step_digests"]) == STEPS
    for r, got in enumerate(res):
        assert got["step_digests"] == res[0]["step_digests"], r


@pytest.mark.parametrize("n,lay", CASES, ids=IDS)
def test_each_rank_holds_its_stages_stack_and_moments_only(world, n, lay):
    _, pp, tp = lay
    one = world["one"]["tfm"]
    for got in _results(world, n, lay):
        for shapes, whole in ((got["local_shapes"], one["local_shapes"]),
                              (got["local_moment_shapes"], one["local_moment_shapes"])):
            assert set(shapes) == set(whole)
            for name, shape in shapes.items():
                if ".stack_" in name:
                    assert shape == (NL // pp,) + whole[name][1:], name
                elif name.endswith("tensor_slices"):        # the NTN's slices over tp
                    assert shape == (whole[name][0] // tp,) + whole[name][1:], name
                else:
                    assert shape == whole[name], name


def test_key_bias_gradients_are_rounding_noise(world):
    grads = world["one"]["tfm"]["grads"]
    top = max(float(np.abs(g).max()) for g in grads.values())
    k = "encoder.stack_qkv_b"
    kb = _key_bias(k, grads[k].shape)
    assert float(np.abs(grads[k][kb]).max()) < NOISE * top
    assert _noise(grads)[k][kb].any()


@pytest.mark.parametrize("n,lay", CASES, ids=IDS)
def test_steps_issue_the_planned_collectives(world, n, lay):
    _, pp, tp = lay
    m = BASE["pp_microbatches"]
    for got in _results(world, n, lay):
        assert got["issued_per_step"] == got["plan"]
        plan = got["plan"]
        assert plan["pp/hop"] == 2 * (m + pp - 2)
        assert plan["pp/out_allreduce"] == plan["pp/input_grad_allreduce"] == 1
        assert plan["pp/norm_allreduce"] == 1
        assert ("tp/ntn_allgather" in plan) == (tp > 1)
        assert "tp/mlp_out_allreduce" not in plan           # the stack is replicated over tp
        assert not any(k.startswith("grad/bucket") for k in plan)


@pytest.mark.parametrize("n,lay,case", [(2, (1, 2, 1), "compact"), (4, (2, 2, 1), "zero1")],
                         ids=["dp1_pp2_tp1", "dp2_pp2_tp1-zero1"])
def test_token_cache_lazy_step_equals_one_process(world, n, lay, case):
    """The token cache with lazy Adam under pp at ``tests/test_torch_dp.py``'s
    bars (losses within 1e-5, gradient norms rtol 1e-5, parameters and the
    moments of scale within 1e-5, but the key biases); the stack slices
    and their moments stay whole under ZeRO-1, which chunks the stage's
    replicated leaves over its dp group."""
    one = world["lazy_one"]
    for r, res in enumerate(world["ranks"][n]):
        got = res[f"lazy/tfm/{rig.pp_name(*lay)}"]
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=0, atol=TOL)
        np.testing.assert_allclose(got["grad_norms"], one["grad_norms"], rtol=TOL, atol=0)
        for k, w in one["params"].items():
            keep = ~_key_bias(k, w.shape)
            np.testing.assert_allclose(got["params"][k][keep], w[keep], atol=TOL, rtol=TOL,
                                       err_msg=f"rank {r}: {k}")
        for k, w in one["moments"].items():
            keep = ~_key_bias(k.split("/", 1)[1], w.shape)
            np.testing.assert_allclose(got["moments"][k][keep], w[keep], rtol=0,
                                       atol=TOL * max(float(np.abs(w).max()), 1e-30),
                                       err_msg=f"rank {r}: {k}")
        assert got["issued_per_step"] == got["plan"], r
        for name, shape in got["local_moment_shapes"].items():
            if ".stack_" in name:
                assert shape == (NL // lay[1],) + one["moments"][f"mu/{name}"].shape[1:], name
        if case == "zero1":
            sharded = set(got["zero_shards"])
            assert not any(".stack_" in s for s in sharded) and "query_proj.weight" in sharded
            assert all(k == numel // lay[0] for k, numel in got["zero_shards"].values())


def test_a_pp_ring_slot_restores_in_one_process_and_continues(world):
    """The (2, 2, 1) ZeRO-1 run's slot after AT steps, restored in one
    process and trained on to the end, ends where the pp run ends."""
    cont = world["continued"]
    assert cont["step"] == AT
    got = world["ranks"][4][0]["lazy/tfm/dp2_pp2_tp1"]
    np.testing.assert_allclose(cont["losses"], got["losses"][AT:], rtol=0, atol=TOL)
    for k, w in got["params"].items():
        keep = ~_key_bias(k, w.shape)
        np.testing.assert_allclose(cont["params"][k][keep], w[keep], atol=TOL, rtol=TOL,
                                   err_msg=k)


# --- checkpoints across pp, the CLI and serving -----------------------------------


def test_checkpoints_round_trip_across_pp(world):
    saved = _results(world, 2, (1, 2, 1))[0]
    got = world["restored"]
    assert got["step"] == STEPS
    for k in saved["params"]:
        np.testing.assert_array_equal(got["params"][k], saved["params"][k], err_msg=k)
    for k in saved["moments"]:
        np.testing.assert_array_equal(got["moments"][k], saved["moments"][k], err_msg=k)
    for src, got in ((_results(world, 4, (2, 2, 1))[0],
                      world["ranks"][4][0]["restored/tfm/dp1_pp4_tp1"]),
                     (world["one"]["tfm"], world["ranks"][2][1]["restored/tfm/dp1_pp2_tp1"])):
        for k in src["params"]:
            np.testing.assert_array_equal(got["params"][k], src["params"][k], err_msg=k)
        for k in src["moments"]:
            np.testing.assert_array_equal(got["moments"][k], src["moments"][k], err_msg=k)


@pytest.mark.parametrize("n,lay,key", [(2, "dp1_pp2_tp1", "cli2"), (4, "dp1_pp2_tp2", "cli4")])
def test_train_and_test_cli_run_under_the_layout(world, n, lay, key):
    for r, res in enumerate(world["ranks"][n]):
        got = res[lay]["cli"]
        for mode in ("train", "test"):
            assert got[mode]["rc"] == 0, (r, mode, got[mode]["stderr"])
            assert (got[mode]["result"] is not None) == (r == 0), (r, mode)
    test = world["ranks"][n][0][lay]["cli"]["test"]["result"]
    want = world["test_ref"][key]
    assert test["test_accuracy"] == pytest.approx(round(want["accuracy"], 4), abs=1e-9)
    assert test["acc_ci95"] == pytest.approx(round(want["acc_ci95"], 4), abs=1e-9)


def test_a_pp_checkpoint_tests_at_pp1_and_a_pp1_one_at_pp2(world, capsys):
    capsys.readouterr()
    assert cli.main(["test", *ARGV, "--load_ckpt", world["dirs"]["cli2"]]) == 0
    at1 = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("{")][-1])
    at2 = world["ranks"][2][0]["dp1_pp2_tp1"]["cli"]["test"]["result"]
    assert at1["test_accuracy"] == at2["test_accuracy"]
    assert at1["acc_ci95"] == at2["acc_ci95"]
    ranks = world["ranks"][2]
    for r, res in enumerate(ranks):
        got = res["cli_test/one_process_ckpt/dp1_pp2_tp1"]
        assert got["rc"] == 0, (r, got["stderr"])
    got = ranks[0]["cli_test/one_process_ckpt/dp1_pp2_tp1"]["result"]
    want = world["test_ref"]["cli1"]
    assert got["test_accuracy"] == pytest.approx(round(want["accuracy"], 4), abs=1e-9)


def test_a_pp_checkpoint_serves_through_the_stacked_engine(world):
    """The pp=2 CLI checkpoint and the one-process run of the same flags
    (the same episodes) served at pp=1: the engine's logits agree within
    1e-5 of their scale."""
    from induction_network_on_fewrel_tpu_torch.data import make_synthetic_fewrel
    from induction_network_on_fewrel_tpu_torch.serving.engine import InferenceEngine

    ds = make_synthetic_fewrel(num_relations=3, instances_per_relation=8, vocab_size=38, seed=5)
    logits = {}
    for key in ("cli2", "cli1"):
        engine = InferenceEngine.from_checkpoint(world["dirs"][key], device="cpu", k=2)
        assert type(engine.model.encoder).__name__ == "PipelinedTransformerEncoder"
        assert engine.model.encoder.pipeline_impl is None
        engine.register_dataset(ds, max_classes=3)
        queries = [inst for rel in engine.class_names for inst in ds.instances[rel][2:5]]
        verdicts = engine.classify_batch(queries)
        logits[key] = np.array([[v["logits"][c] for c in sorted(v["logits"])]
                                for v in verdicts])
        engine.close()
    _scaled(logits["cli2"], logits["cli1"], "served logits")


def _slot_state(d: str) -> dict:
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager

    cfg = cli.config_from_args(cli.parse_args(True, [*ARGV, "--load_ckpt", d]))
    cfg = cli._merge_ckpt_architecture(cfg, d)
    model = build_model(cfg, device="cpu")
    step, _ = CheckpointManager(d, cfg).restore_latest(model)
    return {"step": step, **_np(model.state_dict())}


def test_resume_under_pp_equals_the_uninterrupted_run(world):
    for r, res in enumerate(world["ranks"][2]):
        for path in ("resume_first", "resume", "whole"):
            got = res[f"cli_path/{path}/dp1_pp2_tp1"]
            assert got["rc"] == 0, (r, path, got["stderr"])
    resumed = _slot_state(world["dirs"]["resume"])
    whole = _slot_state(world["dirs"]["whole"])
    assert resumed["step"] == whole["step"] == 8
    for k, w in whole.items():
        np.testing.assert_array_equal(resumed[k], w, err_msg=k)
    assert "restored latest checkpoint step=4" in \
        world["ranks"][2][0]["cli_path/resume/dp1_pp2_tp1"]["stderr"]


@pytest.mark.parametrize("n,path,lay", [(2, "adv", "dp1_pp2_tp1"),
                                        (2, "mixture", "dp1_pp2_tp1"),
                                        (4, "lazy_zero", "dp2_pp2_tp1")])
def test_the_other_paths_train_under_pp(world, n, path, lay):
    """``--adv`` (its instance batches split into the microbatches),
    ``--mixture`` and the token cache with lazy Adam and ``--zero_opt``
    through ``cli train`` under pp: every rank exits 0, rank 0 alone prints
    the result."""
    for r, res in enumerate(world["ranks"][n]):
        got = res[f"cli_path/{path}/{lay}"]
        assert got["rc"] == 0, (r, got["stderr"])
        assert (got["result"] is not None) == (r == 0), r
    assert 0.0 <= world["ranks"][n][0][f"cli_path/{path}/{lay}"]["result"][
        "final_val_accuracy"] <= 1.0


# --- the mesh, the refusals ---------------------------------------------------------


def test_mesh_numbers_ranks_in_the_jax_axis_order_with_pp():
    from induction_network_on_fewrel_tpu_torch.parallel import hostfeed

    grid = np.vectorize(lambda d: d.id)(jax_make_mesh(dp=2, pp=2, tp=2).devices)
    for d in range(2):
        for p in range(2):
            for t in range(2):
                rank = int(grid[d, p, 0, t, 0])
                assert mesh_mod.mesh_index(rank, 1, 2, 1, 2) == (d, p, 0, t, 0)
                m = mesh_mod.Mesh(dp=2, rank=d, pp=2, pp_rank=p, tp=2, tp_rank=t)
                assert hostfeed.local_episode_range(m, 8) == (4 * d, 4)


def _port_refusal(monkeypatch, argv: list, dp: int = 1) -> str:
    args = cli.parse_args(True, ["--synthetic", "--device", "cpu", *argv])
    cfg = cli.config_from_args(args)
    layout = mesh_mod.Mesh(dp=dp, pp=cfg.pp)
    monkeypatch.setattr(mesh_mod, "make_mesh", lambda **kw: layout)
    monkeypatch.setattr("induction_network_on_fewrel_tpu_torch.parallel.distributed."
                        "maybe_initialize_distributed", lambda **kw: True)
    with pytest.raises(ValueError) as e:
        cli.dp_mesh(args, cfg)
    return str(e.value)


def _jax_refusal(argv: list) -> str:
    args = jcli.build_arg_parser(True).parse_args(argv)
    with pytest.raises(ValueError) as e:
        jcli.make_trainer(args, jcli.config_from_args(args))
    return str(e.value)


@pytest.mark.parametrize("argv,dp", [
    (["--encoder", "transformer", "--pp", "2", "--dp", "2"], 2),
    (["--encoder", "transformer", "--pp", "2", "--dp", "2", "--N", "3", "--K", "4", "--Q",
      "1"], 2),
    (["--encoder", "transformer", "--pp", "2", "--dp", "2", "--trainN", "4", "--N", "3", "--K",
      "4", "--Q", "1"], 2),
    (["--encoder", "transformer", "--pp", "2", "--dp", "1", "--pp_microbatches", "8"], 1),
])
def test_rows_that_do_not_split_are_refused_in_the_jax_words(monkeypatch, argv, dp):
    """The JAX default ``--pp_microbatches 4`` at dp=2 with 5-way 5-shot B=4
    (50 support rows a shard), then the train query, the eval query and
    (at dp=1, 8 microbatches) the train support rows."""
    got = _port_refusal(monkeypatch, argv, dp)
    assert got == _jax_refusal(argv)
    assert "must divide evenly across dp=" in got


def test_adv_instance_batches_that_do_not_split_are_refused(monkeypatch):
    """``--adv`` runs under pp (``test_the_other_paths_train_under_pp``); its
    instance batches, an encoder call of their own, are held to the
    microbatches with the JAX ``gpipe_local`` text."""
    argv = ["--encoder", "transformer", "--pp", "2", "--batch_size", "8", "--adv",
            "--adv_batch", "6"]
    assert _port_refusal(monkeypatch, argv) == f"--adv instance batches: " \
        f"{microbatch_refusal(6, 4)}"


@pytest.mark.parametrize("argv,text", [
    (["--encoder", "transformer", "--tfm_layers", "3", "--pp", "2"],
     "--tfm_layers (3) must be divisible by --pp (2) pipeline stages"),
    (["--encoder", "cnn", "--pp", "2"],
     "--pp (pipeline parallelism) requires --encoder transformer (stages are transformer "
     "layers)"),
])
def test_pp_layouts_jax_refuses_are_refused_in_its_words(capsys, argv, text):
    assert _jax_refusal(argv) == text
    with pytest.raises(SystemExit) as e:
        cli.parse_args(True, ["--synthetic", "--device", "cpu", *argv])
    assert e.value.code == 2
    assert text in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--encoder", "transformer", "--pp", "2", "--moe_experts", "4"],
    ["--encoder", "transformer", "--pp", "2", "--moe_experts", "4", "--ep", "2"],
    ["--encoder", "transformer", "--pp", "2", "--sp", "2"],
], ids=["moe", "ep", "sp"])
def test_pp_with_moe_or_sp_is_refused_in_the_jax_words(capsys, argv):
    from induction_network_on_fewrel_tpu.models.build import build_model as jbuild

    with pytest.raises(ValueError, match=r"does not compose with MoE or ring attention yet"):
        jbuild(JaxConfig(encoder="transformer", tfm_stacked=True, moe_experts=4))
    with pytest.raises(SystemExit) as e:
        cli.parse_args(True, ["--synthetic", "--device", "cpu", *argv])
    assert e.value.code == 2
    assert STACKED_WITH in capsys.readouterr().err


def test_microbatch_text_is_gpipe_locals():
    mesh = jax_make_mesh(dp=1, pp=2, devices=jax.devices()[:2])
    enc = JaxStacked(num_layers=2, d_model=8, num_heads=2, d_ff=16, max_length=4,
                     pipeline_impl=make_gpipe(mesh, microbatches=4))
    with pytest.raises(ValueError) as e:
        enc.init(jax.random.key(0), jnp.ones((6, 4, 8)), jnp.ones((6, 4)))
    assert str(e.value) == microbatch_refusal(6, 4)
    assert microbatch_refusal(8, 4) is None


def test_no_port_text_names_item_6d():
    """pp is ported, the last sharded executor: no text of the port names
    item 6d or ``LATER_SLICE``, and no JAX flag is left deferred."""
    root = pathlib.Path(cli.__file__).parent
    files = list(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
    hits = [(str(p), g) for p in files for g in ("item 6d", "LATER_SLICE", "SHARDED =")
            if g in p.read_text()]
    assert hits == []
    assert cli.DEFERRED == {}
