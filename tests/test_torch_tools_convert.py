"""The port's lazy-to-dense checkpoint converter (``tools/convert_lazy_ckpt.py``
of the port package) on the CPU.

* Through the CLI: a lazy run (token cache, weight decay 0) of 4 steps,
  converted, resumed in shared mode for 4 more with ``--resume`` equals the
  uninterrupted shared run of 8 steps at 1e-6 (the lazy pair's bar):
  parameters, every Adam moment and the update count of the ring slot at
  step 8. The converted slot carries the source's best val accuracy and
  sampler streams. A shared source exits 2 and writes nothing.
* Against the JAX tool: the same schedule (6 lazy steps, materialize,
  convert, 6 shared steps) from the same weights (``interop.params_from_jax``)
  on the same batches, the JAX side through ``tools/convert_lazy_ckpt.
  convert_state``: losses within rtol 2e-4 and parameters within 1e-3 at
  every step of the continuation (the trajectory-twin bars); at the
  conversion the update count equals the JAX tool's step and every carried
  moment is within 1e-5 of its leaf's largest value of the JAX tool's.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import json
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.data import GloveTokenizer as JaxTokenizer
from induction_network_on_fewrel_tpu.data import make_synthetic_fewrel as jax_fewrel
from induction_network_on_fewrel_tpu.data import make_synthetic_glove as jax_glove
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu.models.build import batch_to_model_inputs as jax_inputs
from induction_network_on_fewrel_tpu.sampling.episodes import EpisodeSampler as JaxSampler
from induction_network_on_fewrel_tpu.train import lazy_embed as jlazy
from induction_network_on_fewrel_tpu.train.steps import init_state
from induction_network_on_fewrel_tpu.train.steps import make_train_step as jax_train_step
from induction_network_on_fewrel_tpu_torch import cli
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.interop import params_from_jax
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.tools import convert_lazy_ckpt
from induction_network_on_fewrel_tpu_torch.train.lazy_embed import LazyTable, live_rows
from induction_network_on_fewrel_tpu_torch.train.steps import make_optimizer, make_train_step

REPO = Path(__file__).resolve().parents[1]
_TOOLS = str(REPO / "tools")
if _TOOLS not in sys.path:
    sys.path.insert(0, _TOOLS)

import convert_lazy_ckpt as jax_convert  # noqa: E402

TOL = 1e-6
TINY = ["--device", "cpu", "--lstm_hidden", "8", "--max_length", "12", "--induction_dim", "10",
        "--ntn_slices", "4", "--N", "3", "--K", "2", "--Q", "2", "--batch_size", "2",
        "--val_iter", "4", "--vocab_size", "62", "--sampler", "python", "--prefetch_depth", "0",
        "--token_cache", "--val_step", "4", "--lr", "5e-3", "--lr_step_size", "3",
        "--weight_decay", "0"]


def _slot(path: Path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=False)


def test_converted_run_continues_the_shared_run_exactly(tmp_path):
    lazy, conv, dense = tmp_path / "lazy", tmp_path / "conv", tmp_path / "dense"
    assert cli.main(["train", *TINY, "--embed_optimizer", "lazy", "--train_iter", "4",
                     "--save_ckpt", str(lazy)]) == 0
    assert convert_lazy_ckpt.main([str(lazy), str(conv), "--device", "cpu"]) == 0
    src, got = _slot(lazy / "best.pt"), _slot(conv / "best.pt")
    assert got["step"] == src["step"] == 4 and got["opt"]["count"] == 4
    assert got["val_accuracy"] == src["val_accuracy"] and got["samplers"] == src["samplers"]
    assert set(got["opt"]["rules"]) == {"adam"} and "lazy" not in got
    assert json.loads((conv / "config.json").read_text())["embed_optimizer"] == "shared"
    assert cli.main(["train", *TINY, "--train_iter", "4", "--save_ckpt", str(conv),
                     "--resume"]) == 0
    assert cli.main(["train", *TINY, "--train_iter", "8", "--save_ckpt", str(dense)]) == 0
    a, b = _slot(conv / "latest.pt"), _slot(dense / "latest.pt")
    assert a["step"] == b["step"] == 8 and a["opt"]["count"] == b["opt"]["count"] == 8
    for name, want in b["params"].items():
        np.testing.assert_allclose(a["params"][name].numpy(), want.numpy(), atol=TOL, rtol=0,
                                   err_msg=name)
    for key in ("mu", "nu"):
        for i, (x, y) in enumerate(zip(a["opt"][key], b["opt"][key])):
            np.testing.assert_allclose(x.numpy(), y.numpy(), atol=TOL, rtol=0,
                                       err_msg=f"{key}[{i}]")


def test_shared_source_exits_2(tmp_path, capsys):
    src = tmp_path / "shared"
    assert cli.main(["train", *TINY, "--train_iter", "2", "--val_step", "2",
                     "--save_ckpt", str(src)]) == 0
    assert convert_lazy_ckpt.main([str(src), str(tmp_path / "out"), "--device", "cpu"]) == 2
    assert "not a lazy-embed checkpoint" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


# --- against the JAX tool ----------------------------------------------------------


VOCAB = 52
SMALL = dict(
    vocab_size=VOCAB, max_length=12, word_dim=10, pos_dim=2, lstm_hidden=16, att_dim=8,
    induction_dim=12, ntn_slices=6, routing_iters=3, train_n=3, n=3, k=2, q=2, batch_size=2,
    compute_dtype="float32", lr=3e-3, lr_step_size=3, weight_decay=0.0, grad_clip=10.0,
)
STEPS = 6


def test_conversion_matches_the_jax_tool():
    vocab = jax_glove(vocab_size=VOCAB - 2, word_dim=SMALL["word_dim"])
    ds = jax_fewrel(num_relations=6, instances_per_relation=6, vocab_size=35,
                    sentence_len=(6, SMALL["max_length"]))
    sampler = JaxSampler(ds, JaxTokenizer(vocab, max_length=SMALL["max_length"]), 3, 2, 2,
                         batch_size=2, seed=3)
    batches = [jax_inputs(sampler.sample_batch()) for _ in range(2 * STEPS)]
    lazy_kw, dense_kw = dict(SMALL, embed_optimizer="lazy"), dict(SMALL, embed_optimizer="shared")
    jcfg, jdense_cfg = JaxConfig(**lazy_kw), JaxConfig(**dense_kw)
    jmodel = jax_build_model(jcfg)
    jstate = init_state(jmodel, jcfg, batches[0][0], batches[0][1])

    cfg = ExperimentConfig(**lazy_kw)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(jstate.params["params"])))
    opt = make_optimizer(cfg, model)
    lazy = LazyTable(model, opt.hyper, live_rows(cfg))
    opt.attach_compact(lazy.rows, lazy.rows_m, lazy.rows_v)
    step, jstep = make_train_step(model, opt, cfg, lazy=lazy), jax_train_step(jmodel, jcfg)
    for b in batches[:STEPS]:
        jstate, jm = jstep(jstate, *b)
        np.testing.assert_allclose(float(step(*b)["loss"]), float(jm["loss"]), rtol=2e-4)

    jstate = jlazy.make_materialize(jcfg)(jstate)
    jdense = jax_convert.convert_state(jstate, jmodel, jdense_cfg,
                                       jlazy.find_emb_path(jstate.params))
    dense = convert_lazy_ckpt.convert_state(model, opt, lazy, cfg.replace(
        embed_optimizer="shared"), STEPS)
    assert int(jdense.step) == int(dense.count) == STEPS
    adam = [n for n in jax.tree_util.tree_leaves(
        jdense.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(n, "mu")]
    assert len(adam) == 1
    names = [n for n, _ in model.named_parameters()]
    for key, theirs in (("mu", adam[0].mu), ("nu", adam[0].nu)):
        want = params_from_jax(jax.device_get(theirs["params"]))
        for name, got in zip(names, getattr(dense, key)):
            scale = float(want[name].abs().max())
            assert float((got - want[name]).abs().max()) <= 1e-5 * scale, (key, name)

    dstep, jdstep = make_train_step(model, dense, cfg.replace(embed_optimizer="shared")), \
        jax_train_step(jmodel, jdense_cfg)
    for b in batches[STEPS:]:
        jdense, jm = jdstep(jdense, *b)
        np.testing.assert_allclose(float(dstep(*b)["loss"]), float(jm["loss"]), rtol=2e-4)
        want_params = params_from_jax(jax.device_get(jdense.params["params"]))
        for name, v in model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want_params[name].numpy(), atol=1e-3, rtol=0,
                                       err_msg=name)
