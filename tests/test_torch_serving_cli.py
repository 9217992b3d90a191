"""The port's ``serve_main`` (CPU) vs the JAX package's ``serve_main``.

The port's ``cli train`` trains two steps on the CPU and writes its
checkpoint; tiny real-format files (a FewRel support JSON, a JSON-lines
query file and a combined GloVe JSON) are written to tmp. The same
weights go into a JAX checkpoint (``interop.params_to_jax``), and both
``serve_main``s serve them: the verdict lines agree (labels, NOTA flags,
logits within 1e-5). Each JAX serving flag of a later slice is refused
by name; the fresh-weight demo keeps its own test in
``tests/test_torch_serving.py``.
"""

import json

import jax
import numpy as np
import pytest

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu.serving.cli import serve_main as jax_serve_main
from induction_network_on_fewrel_tpu.train.checkpoint import CheckpointManager as JaxCkpt
from induction_network_on_fewrel_tpu.train.steps import init_state
from induction_network_on_fewrel_tpu_torch import cli
from induction_network_on_fewrel_tpu_torch.data import make_synthetic_fewrel
from induction_network_on_fewrel_tpu_torch.interop import params_to_jax
from induction_network_on_fewrel_tpu_torch.serving import cli as serve_cli
from induction_network_on_fewrel_tpu_torch.serving.buckets import zero_batch
from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager

VOCAB = 60
TRAIN = ["--synthetic", "--N", "3", "--K", "2", "--Q", "2", "--batch_size", "2",
         "--max_length", "12", "--vocab_size", str(VOCAB + 2), "--lstm_hidden", "8",
         "--induction_dim", "10", "--ntn_slices", "4", "--device", "cpu", "--lr", "5e-3",
         "--train_iter", "2", "--val_step", "2", "--val_iter", "2"]


def _raw(inst) -> dict:
    """A synthetic instance in the FewRel JSON schema."""
    return {"tokens": list(inst.tokens),
            "h": [inst.head_name, "Q1", [list(inst.head_pos)]],
            "t": [inst.tail_name, "Q2", [list(inst.tail_pos)]]}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(port argv, JAX argv) serving the same trained weights."""
    root = tmp_path_factory.mktemp("serve")
    ckpt = root / "ckpt"
    assert cli.main(["train", *TRAIN, "--save_ckpt", str(ckpt)]) == 0
    assert (ckpt / "best.pt").exists()
    ds = make_synthetic_fewrel(num_relations=4, instances_per_relation=6, vocab_size=VOCAB,
                               sentence_len=(4, 16), seed=9)
    support = root / "support.json"
    support.write_text(json.dumps({r: [_raw(i) for i in ds.instances[r]] for r in ds.rel_names}))
    queries = root / "queries.jsonl"
    queries.write_text("".join(json.dumps(_raw(i)) + "\n"
                               for r in ds.rel_names for i in ds.instances[r][2:5]))
    rng = np.random.default_rng(0)
    glove = root / "glove.json"
    glove.write_text(json.dumps([{"word": f"w{i}", "vec": rng.normal(0, 0.5, 50).round(4)
                                  .tolist()} for i in range(VOCAB)]))
    # The same weights as a JAX checkpoint.
    jcfg = JaxConfig.from_json((ckpt / "config.json").read_text()).replace(device="cpu")
    jmodel = jax_build_model(jcfg)
    L = jcfg.max_length
    state = init_state(jmodel, jcfg, zero_batch(L, (1, jcfg.n, jcfg.k)),
                       zero_batch(L, (1, jcfg.n * jcfg.q)))
    state = state.replace(params={"params": params_to_jax(CheckpointManager(ckpt).params(
        "best"))})
    jdir = root / "jax_ckpt"
    mgr = JaxCkpt(jdir, jcfg)
    mgr.save(2, jax.device_get(state), val_accuracy=0.5)
    mgr.wait()
    mgr.close()
    common = ["--support_file", str(support), "--input", str(queries), "--glove", str(glove),
              "--K", "2", "--buckets", "1,2,4", "--device", "cpu"]
    return (["--load_ckpt", str(ckpt), *common],
            ["--load_ckpt", str(jdir), *common, "--compile_cache", "off"])


def _lines(capsys):
    out = capsys.readouterr().out
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_serve_main_on_a_port_checkpoint_equals_jax(served, capsys, dtype):
    port_argv, jax_argv = served
    extra = ["--resident_dtype", dtype]
    assert jax_serve_main(jax_argv + extra) == 0
    want = _lines(capsys)
    assert serve_cli.serve_main(port_argv + extra) == 0
    got = _lines(capsys)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert (g["label"], g["nota"], g["tenant"]) == (w["label"], w["nota"], w["tenant"])
        assert list(g["logits"]) == list(w["logits"])
        np.testing.assert_allclose(list(g["logits"].values()), list(w["logits"].values()),
                                   rtol=1e-5, atol=1e-5)


def test_serve_main_demo_and_stats(served, capsys):
    port_argv, _ = served
    i = port_argv.index("--input")
    argv = port_argv[:i] + port_argv[i + 2:]
    assert serve_cli.serve_main(argv + ["--demo_queries", "5", "--scheduler", "microbatch",
                                        "--geometry_tiers", "off"]) == 0
    captured = capsys.readouterr()
    lines = [json.loads(ln) for ln in captured.out.splitlines() if ln.startswith("{")]
    assert len(lines) == 5 and all("true" in v and "label" in v for v in lines)
    assert "demo accuracy" in captured.err and "steady_recompiles\": 0" in captured.err


# The JAX serving flags the port now serves (the telemetry flags): each
# parses with a value and is not refused.
PORTED = ("--chaos", "--drift", "--drift_band", "--drift_baseline", "--drift_window",
          "--slo_availability", "--slo_fast_s", "--slo_latency_ms", "--slo_profile",
          "--slo_slow_s", "--trace_sample", "--watchdog")


@pytest.mark.parametrize("flag", sorted(set(serve_cli.DEFERRED) | set(PORTED)))
def test_deferred_flags_are_refused_by_name(flag, capsys):
    if flag in PORTED:
        p = serve_cli.build_serve_arg_parser()
        action = next(a for a in p._actions if flag in a.option_strings)
        value = "3" if action.type is int else "0.5"
        args = p.parse_args([flag] if action.nargs == 0 else [flag, value])
        serve_cli.refuse_deferred(p, args)
        assert getattr(args, flag[2:]) not in (None, False)
        return
    value = [] if flag in serve_cli._FLAGS else ["7"]
    with pytest.raises(SystemExit) as ei:
        serve_cli.serve_main([flag, *value, "--device", "cpu"])
    assert ei.value.code == 2
    err = capsys.readouterr().err
    assert f"{flag} is not ported yet" in err and "ROADMAP queue A item" in err


def test_default_valued_jax_flags_are_accepted():
    p = serve_cli.build_serve_arg_parser()
    args = p.parse_args(["--dp", "1", "--replicas", "1", "--trace_sample", "0",
                         "--compile_cache", "off", "--tier_spread", "0"])
    serve_cli.refuse_deferred(p, args)
    with pytest.raises(SystemExit):
        serve_cli.refuse_deferred(p, p.parse_args(["--compile_cache", "/tmp/xla"]))


def test_serve_main_refuses_a_mismatched_vocabulary(served, tmp_path):
    port_argv, _ = served
    glove = tmp_path / "small.json"
    glove.write_text(json.dumps([{"word": "a", "vec": [0.0] * 50}]))
    argv = list(port_argv)
    argv[argv.index("--glove") + 1] = str(glove)
    with pytest.raises(ValueError, match="does not match the checkpoint's embedding table"):
        serve_cli.serve_main(argv)
