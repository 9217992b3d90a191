"""MoE across ranks in the port against the JAX single-device step on the global batch.

Two worlds of gloo ranks on the CPU (``parallel/rig.run_ranks``), spawned
once for the module before any JAX work and run while this process runs
the JAX reference: two ranks run the layouts (dp=2, ep=1) and (dp=1,
ep=2), four ranks (dp=2, ep=2). The config has the widths of JAX
``tests/test_moe.py:108-117`` (2 layers, width 32, 2 heads, ff 64, 4
experts, top-2, every 2nd block an MoE block, B=4 of 3-way 2-shot Q=2,
L=12, f32), on the induction head (proto's head is blind to a shared
shift of the encodings, so its final LayerNorm bias trains on rounding
noise), from the port's fresh weights carried to JAX by ``interop``.
Two variants:

* "route": the default routing group of 512 tokens. The global batch is
  576 tokens; at dp=2 rank 1's query rows straddle the groups' edge.
* "bind": ``moe_group_size 40`` and ``moe_capacity 0.5``: groups straddle
  every rank edge and capacity drops about half the assignments.

Each (layout, variant) is held to the JAX ``make_train_step`` on the
global batch at ``tests/test_torch_moe.py``'s bars (the forward's logits,
each rank's rows, within 1e-5 of scale; the load-balance sum rtol 1e-6;
every gradient leaf of the objective within 1e-5 of its scale; over
STEPS steps the losses rtol 2e-4 and the final parameters atol 1e-3),
and to the port's one-process run at ``tests/test_torch_dp.py``'s dp bar
(losses within 1e-5, parameters after ``rig.MOE_DP_AT`` steps within
1e-5, gradient norms rtol 1e-5) with the dropped shares equal; every
step issues the collectives of ``DataParallel.plan``. The parameter bar
leaves out the attention blocks' key biases (the middle third of each
``qkv_i.bias``): a key bias shifts every score of a query alike, so its
gradient is zero up to rounding (checked: below ``NOISE``, 1e-6 of the
largest element, the rule of ``tests/test_torch_zoo_train.py``), and Adam
steps such an element by its rounding noise, which two summation orders
draw differently. The losses hold every element to account. Without the global
routing (each rank routing its own tokens in groups of its own), "bind"
misses the JAX forward far beyond the bar.

Checkpoints hold the JAX layout: the (dp=2, ep=2) end state restores in
one process and at (dp=1, ep=4) with every parameter and moment equal,
and the (dp=2, ep=1) end state at (dp=1, ep=2). The train and test CLI
run under each layout; ``test`` at (dp=2, ep=1) with capacity binding
reports the one-process evaluation of the same episodes.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
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
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu.models.build import batch_to_model_inputs as jax_inputs
from induction_network_on_fewrel_tpu.sampling.episodes import EpisodeSampler as JaxSampler
from induction_network_on_fewrel_tpu.train import steps as jsteps
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.interop import params_from_jax, params_to_jax
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.parallel import rig

L = 12
CFG = dict(model="induction", encoder="transformer", train_n=3, n=3, k=2, q=2, batch_size=4,
           max_length=L, vocab_size=302, compute_dtype="float32", tfm_layers=2, tfm_model=32,
           tfm_heads=2, tfm_ff=64, moe_experts=4, moe_top_k=2, moe_every=2, induction_dim=8,
           ntn_slices=4, lr=1e-3, weight_decay=0.0)
VARIANTS = {"route": {}, "bind": dict(moe_group_size=40, moe_capacity=0.5)}
STEPS = 8
LAYOUTS = [rig.layout_name(dp, ep) for world in (2, 4) for dp, ep in rig.MOE_LAYOUTS[world]]
CASES = [(lay, v) for lay in LAYOUTS for v in VARIANTS]
IDS = [f"{lay}-{v}" for lay, v in CASES]
TOL = 1e-5
NOISE = 1e-6
CLI_ARGV = ["--synthetic", "--encoder", "transformer", "--tfm_layers", "2", "--tfm_model", "32",
            "--tfm_heads", "2", "--tfm_ff", "64", "--moe_experts", "4", "--moe_group_size", "40",
            "--moe_capacity", "0.5", "--N", "3", "--K", "2", "--Q", "2", "--batch_size", "4",
            "--max_length", "12", "--vocab_size", "40", "--induction_dim", "8", "--ntn_slices",
            "4", "--device", "cpu", "--sampler", "python", "--prefetch_depth", "0",
            "--test_iter", "8"]
CLI_TRAIN = ["--train_iter", "4", "--val_step", "4", "--val_iter", "8"]


def _np(sd) -> dict:
    return {k: v.detach().numpy() for k, v in sd.items()}


def _jax_run(weights: dict, batches: list) -> dict:
    """Per variant: the JAX forward's logits and load-balance sum, the
    objective's gradient at the first batch, and the STEPS-step
    trajectory, all single-device on the global batches."""
    out = {}
    for v, kw in VARIANTS.items():
        jcfg = JaxConfig(**CFG, **kw)
        jmodel = jax_build_model(jcfg)
        state = jsteps.TrainState.create(apply_fn=jmodel.apply,
                                         params={"params": params_to_jax(weights)},
                                         tx=jsteps.make_optimizer(jcfg))
        aux_w = jcfg.moe_aux_weight

        def objective(params, sup, qry, lab):
            logits, sown = jmodel.apply(params, sup, qry, mutable="losses")
            aux = sum(jnp.sum(x) for x in jax.tree.leaves(sown))
            return jsteps.LOSS_FNS[jcfg.loss](logits, lab) + aux_w * aux, (logits, aux)

        (_, (logits, aux)), grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(
            state.params, *batches[0])
        step = jsteps.make_train_step(jmodel, jcfg)
        losses = []
        for b in batches:
            state, m = step(state, *b)
            losses.append(float(m["loss"]))
        out[v] = {"logits": np.asarray(logits), "aux": float(aux), "losses": losses,
                  "grads": _np(params_from_jax(jax.device_get(grads["params"]))),
                  "params": _np(params_from_jax(jax.device_get(state.params["params"])))}
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    vocab = jax_glove(vocab_size=CFG["vocab_size"] - 2)
    ds = jax_fewrel(num_relations=6, instances_per_relation=8, vocab_size=CFG["vocab_size"] - 2)
    sampler = JaxSampler(ds, JaxTokenizer(vocab, max_length=L), 3, 2, 2, batch_size=4, seed=0)
    batches = [jax_inputs(sampler.sample_batch()) for _ in range(STEPS)]
    weights = build_model(ExperimentConfig(**CFG), device="cpu").state_dict()
    d = {k: str(tmp_path_factory.mktemp(k)) for k in ("dp2_ep1", "dp2_ep2", "cli21", "cli12",
                                                       "cli22")}
    payload = dict(cfg=CFG, variants=VARIANTS, weights=_np(weights), batches=batches,
                   saves={"dp2_ep1": d["dp2_ep1"], "dp2_ep2": d["dp2_ep2"]},
                   restores={2: [(1, 2, d["dp2_ep1"])], 4: [(1, 4, d["dp2_ep2"])]},
                   cli={lay: (CLI_ARGV, CLI_TRAIN, d[f"cli{lay[2]}{lay[-1]}"])
                        for lay in LAYOUTS})
    ranks: dict = {}

    def spawn(n):
        try:
            ranks[n] = rig.run_ranks(rig.dp_moe_cases, n, payload, timeout_s=150)
        except BaseException as e:    # re-raised below, in the test's thread
            ranks[f"err{n}"] = e

    threads = [threading.Thread(target=spawn, args=(n,)) for n in (2, 4)]
    for t in threads:
        t.start()
    want = _jax_run(weights, batches)
    one = {v: rig.run_moe_case(payload, v, None) for v in VARIANTS}
    for t in threads:
        t.join(180)
    assert not any(t.is_alive() for t in threads), "the ranks outlived their bound"
    for n in (2, 4):
        if f"err{n}" in ranks:
            raise ranks[f"err{n}"]
    got = {n: ranks[n] for n in (2, 4)}
    restored = rig.restore_moe(payload, "route", None, d["dp2_ep2"])
    test_ref = rig.moe_test_reference(CLI_ARGV, d["cli21"], 2)
    return {"ranks": got, "jax": want, "one": one, "payload": payload, "restored": restored,
            "test_ref": test_ref}


def _ranks_of(world, layout: str) -> list:
    n = 4 if layout == "dp2_ep2" else 2
    return [r[layout] for r in world["ranks"][n]]


def _rows(layout: str, rank: int) -> slice:
    """The global episodes a rank of ``layout`` holds (B=4 over dp)."""
    dp, ep = (int(x[2:]) for x in layout.split("_"))
    b = 4 // dp
    d = rank // ep
    return slice(d * b, (d + 1) * b)


def _leafwise(got: dict, want: dict, tol: float, what: str) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[k], w, rtol=tol, atol=tol * scale, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("layout,variant", CASES, ids=IDS)
def test_forward_and_gradients_match_jax_on_the_global_batch(world, layout, variant):
    want = world["jax"][variant]
    scale = float(np.abs(want["logits"]).max())
    for r, res in enumerate(_ranks_of(world, layout)):
        got = res[variant]
        np.testing.assert_allclose(got["logits"], want["logits"][_rows(layout, r)], rtol=0,
                                   atol=TOL * scale, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-6)
        _leafwise(got["grads"], want["grads"], TOL, f"rank {r} gradient")


@pytest.mark.parametrize("layout,variant", CASES, ids=IDS)
def test_trajectory_matches_jax_make_train_step(world, layout, variant):
    want = world["jax"][variant]
    for r, res in enumerate(_ranks_of(world, layout)):
        got = res[variant]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4, err_msg=f"rank {r}")
        for k, w in want["params"].items():
            np.testing.assert_allclose(got["params"][k], w, atol=1e-3, err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("layout,variant", CASES, ids=IDS)
def test_ranks_equal_one_process_at_the_dp_bar(world, layout, variant):
    one = world["one"][variant]
    for r, res in enumerate(_ranks_of(world, layout)):
        got = res[variant]
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=0, atol=TOL)
        np.testing.assert_allclose(got["grad_norms"], one["grad_norms"], rtol=TOL, atol=0)
        assert got["drops0"] == one["drops0"] and got["drops"] == one["drops"], r
        for k, w in one["params_at"].items():
            held = ~_key_bias(k, w.shape)
            np.testing.assert_allclose(got["params_at"][k][held], w[held], atol=TOL, rtol=TOL,
                                       err_msg=f"rank {r}: {k}")
    drops = np.array(one["drops"])
    assert (drops > 0).all() if variant == "bind" else (drops == 0).all(), drops


def _key_bias(name: str, shape) -> np.ndarray:
    """The elements of leaf ``name`` that are an attention block's key bias."""
    mask = np.zeros(shape, bool)
    if name.startswith("encoder.qkv_") and name.endswith(".bias"):
        d = CFG["tfm_model"]
        mask[d:2 * d] = True
    return mask


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_key_bias_gradients_are_rounding_noise(world, variant):
    grads = world["one"][variant]["grads"]
    top = max(float(np.abs(g).max()) for g in grads.values())
    keys = [k for k, g in grads.items() if _key_bias(k, g.shape).any()]
    assert len(keys) == CFG["tfm_layers"]
    for k in keys:
        assert float(np.abs(grads[k][_key_bias(k, grads[k].shape)]).max()) < NOISE * top, k


@pytest.mark.parametrize("layout", LAYOUTS)
def test_steps_issue_the_planned_collectives(world, layout):
    dp, ep = (int(x[2:]) for x in layout.split("_"))
    for res in _ranks_of(world, layout):
        for v in VARIANTS:
            got = res[v]
            assert got["issued_per_step"] == got["plan"], v
            want = {"grad/all": 1, "moe/route_allgather": 1, "metrics/mean": 1}
            if ep > 1:
                want.update({"ep/combine_allreduce": 1, "ep/input_grad_allreduce": 1,
                             "ep/gate_grad_allreduce": 1, "ep/norm_allreduce": 1})
            assert got["plan"] == want


def test_rank_local_routing_misses_the_jax_forward_when_capacity_binds(world):
    """The check above can fail: each dp rank routing its own tokens in its
    own groups (what the port did before global routing) puts rank 0's
    logits far outside the bar under "bind", and inside it under "route"."""
    payload = world["payload"]
    for v in VARIANTS:
        cfg = ExperimentConfig(**CFG, **VARIANTS[v])
        model = build_model(cfg, device="cpu")
        model.load_state_dict({k: torch.as_tensor(x) for k, x in payload["weights"].items()})
        sup, qry, _ = (rig._rows_of(x, 0, 2) for x in payload["batches"][0])
        with torch.no_grad():
            local = model({k: torch.as_tensor(x) for k, x in sup.items()},
                          {k: torch.as_tensor(x) for k, x in qry.items()}).numpy()
        want = world["jax"][v]["logits"][:2]
        err = float(np.abs(local - want).max()) / float(np.abs(want).max())
        assert (err > 100 * TOL) if v == "bind" else (err < TOL), (v, err)


def test_checkpoint_written_under_ep_restores_at_any_ep(world):
    saved = _ranks_of(world, "dp2_ep2")[0]["route"]
    for where, got in (("one process", world["restored"]),
                       ("dp1_ep4", world["ranks"][4][0]["restored/dp1_ep4"])):
        assert got["step"] == STEPS, where
        for k in saved["params"]:
            np.testing.assert_array_equal(got["params"][k], saved["params"][k],
                                          err_msg=f"{where}: {k}")
        assert set(got["moments"]) == set(saved["moments"])
        for k in saved["moments"]:
            np.testing.assert_array_equal(got["moments"][k], saved["moments"][k],
                                          err_msg=f"{where}: {k}")
    back = world["ranks"][2][1]["restored/dp1_ep2"]
    from_ep1 = _ranks_of(world, "dp2_ep1")[0]["route"]
    for k in from_ep1["params"]:
        np.testing.assert_array_equal(back["params"][k], from_ep1["params"][k], err_msg=k)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_train_and_test_cli_run_under_the_layout(world, layout):
    n = 4 if layout == "dp2_ep2" else 2
    for r, res in enumerate(world["ranks"][n]):
        cli = res[layout]["cli"]
        for mode in ("train", "test"):
            assert cli[mode]["rc"] == 0, (r, mode, cli[mode]["stderr"])
            assert (cli[mode]["result"] is not None) == (r == 0), (r, mode)
    test = world["ranks"][n][0][layout]["cli"]["test"]["result"]
    assert 0.0 <= test["test_accuracy"] <= 1.0


def test_cli_test_under_dp_equals_one_process_on_the_same_episodes(world):
    got = world["ranks"][2][0]["dp2_ep1"]["cli"]["test"]["result"]
    want = world["test_ref"]
    assert got["test_accuracy"] == pytest.approx(round(want["accuracy"], 4), abs=1e-9)
    assert got["acc_ci95"] == pytest.approx(round(want["acc_ci95"], 4), abs=1e-9)
