"""The zoo through the port's CLI, its refusals and its checkpoints (CPU).

* ``cli train`` then ``cli test --device cpu`` for every zoo model (over
  the CNN, tiny widths): both exit 0, the test accuracy line is printed,
  and ``config.json`` carries the model and loads into the JAX config.
* The geometry a checkpoint's config carries: ``cli test`` with another
  ``--N``/``--K`` takes N for gnn/snail/metanet and K for proto_hatt from
  the checkpoint, as the JAX ``merge_architecture_from`` does (JAX
  ``tests/test_model_zoo.py:151``), and keeps the runtime's for proto.
* Refused by name: gnn/snail/metanet with ``--trainN`` other than ``--N``
  (``build_model`` and the CLI); ``--sp`` above 1 off the transformer (the
  JAX text), ``--pp`` and ``--ep`` above 1,
  ``--moe_experts`` and ``--tfm_stacked`` off the transformer and
  ``--moe_top_k 0`` on the CLI (rc 2); an unknown proto metric.
* The adversarial (``--adv``), MoE and stacked paths: ``cli train`` then
  ``cli test --load_ckpt``. ``--model pair`` and ``--encoder bert`` run:
  ``train`` one step at a tiny BERT width, ``test`` builds the model.
* Serving: a proto checkpoint written by ``cli train`` is refused by name
  through ``InferenceEngine.from_checkpoint`` and ``serve_main``, as the
  JAX engine refuses it.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import json

import pytest

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu_torch import cli
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.serving.cli import serve_main
from induction_network_on_fewrel_tpu_torch.serving.engine import InferenceEngine
from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager

MODELS = ("proto", "proto_hatt", "siamese", "gnn", "snail", "metanet")
TINY = ["--synthetic", "--device", "cpu", "--N", "3", "--K", "2", "--Q", "2",
        "--batch_size", "2", "--max_length", "12", "--vocab_size", "62", "--encoder", "cnn",
        "--hidden_size", "16", "--gnn_dim", "8", "--gnn_blocks", "1", "--snail_tc_filters", "8"]


def _train(tmp_path, model, capsys, *extra) -> str:
    ckpt = str(tmp_path / model)
    rc = cli.main(["train", *TINY, "--model", model, "--train_iter", "4", "--val_step", "2",
                   "--val_iter", "4", "--steps_per_call", "2", "--lr", "5e-3",
                   "--save_ckpt", ckpt, *extra])
    assert rc == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(final) == {"final_val_accuracy", "acc_ci95"}
    return ckpt


@pytest.mark.parametrize("model", MODELS)
def test_cli_train_then_test_every_model(tmp_path, capsys, model):
    ckpt = _train(tmp_path, model, capsys)
    saved = JaxConfig.from_json((tmp_path / model / "config.json").read_text())
    assert (saved.model, saved.encoder, saved.hidden_size) == (model, "cnn", 16)
    rc = cli.main(["test", "--synthetic", "--device", "cpu", "--load_ckpt", ckpt, "--N", "3",
                   "--K", "2", "--Q", "2", "--batch_size", "2", "--test_iter", "4"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.0 <= out["test_accuracy"] <= 1.0 and out["acc_ci95"] >= 0.0


@pytest.mark.parametrize("model,carried", [("gnn", {"n": 3, "train_n": 3, "k": 5}),
                                           ("proto_hatt", {"n": 5, "k": 2}),
                                           ("proto", {"n": 5, "k": 5})])
def test_checkpoint_geometry_rides_in_config_json(tmp_path, capsys, model, carried):
    ckpt = _train(tmp_path, model, capsys)
    args = cli.parse_args(train=False, argv=["--synthetic", "--device", "cpu", "--N", "5",
                                             "--K", "5", "--load_ckpt", ckpt])
    merged = cli._merge_ckpt_architecture(cli.config_from_args(args), ckpt)
    assert {k: getattr(merged, k) for k in carried} == carried
    assert (merged.model, merged.encoder) == (model, "cnn")
    jax_merged = JaxConfig(n=5, train_n=5, k=5).merge_architecture_from(
        JaxConfig.from_json((tmp_path / model / "config.json").read_text()))
    assert {k: getattr(jax_merged, k) for k in carried} == carried
    assert ExperimentConfig.MODEL_GEOMETRY_FIELDS == JaxConfig.MODEL_GEOMETRY_FIELDS
    rc = cli.main(["test", "--synthetic", "--device", "cpu", "--load_ckpt", ckpt, "--N", "5",
                   "--K", "5", "--Q", "2", "--batch_size", "2", "--test_iter", "4"])
    assert rc == 0


@pytest.mark.parametrize("model", ["gnn", "snail", "metanet"])
def test_n_tied_models_refuse_another_train_n(model):
    with pytest.raises(ValueError, match=rf"model '{model}' ties parameter shapes to N; "
                                         r"--trainN \(6\) must equal --N \(4\)"):
        build_model(ExperimentConfig(model=model, encoder="cnn", vocab_size=12, train_n=6, n=4),
                    device="cpu")
    with pytest.raises(ValueError, match="--trainN"):
        cli.main(["train", *TINY, "--model", model, "--trainN", "6", "--N", "4",
                  "--train_iter", "1"])


BERT_TINY = ["--encoder", "bert", "--bert_layers", "1", "--bert_hidden", "16", "--bert_heads",
             "2", "--bert_intermediate", "32", "--bert_vocab_size", "200"]


@pytest.mark.parametrize("argv", [["--model", "pair"], []], ids=["--model pair", "--encoder bert"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_cli_runs_bert_and_pair(tmp_path, capsys, mode, argv):
    """``--model pair`` and ``--encoder bert``, refused by name before their
    slice, now run: ``train`` one step at a tiny BERT width, ``test`` parses
    and builds the model its flags describe."""
    argv = [*TINY, *BERT_TINY, *argv]
    if mode == "train":
        assert cli.main(["train", *argv, "--train_iter", "1", "--val_step", "1", "--val_iter",
                         "2", "--save_ckpt", str(tmp_path / "c")]) == 0
        assert "final_val_accuracy" in capsys.readouterr().out
        return
    cfg = cli.config_from_args(cli.parse_args(False, argv))
    model = build_model(cfg, device="cpu")
    assert (type(model).__name__, cfg.encoder) == (
        "PairModel" if "pair" in argv else "InductionNetwork", "bert")
    assert sum(p.numel() for n, p in model.named_parameters() if "backbone" in n) > 0


# The ids are the ones these cases had beside the pair and bert cases
# (argv0, argv1), which now run (test_cli_runs_bert_and_pair). --moe_experts,
# --moe_top_k and --tfm_stacked parse since they were ported: their cases now
# hold the CLI's refusals of an MoE or stacked option the model would not
# honor; --pp, --ep and --sp above 1 (ported since) are refused off the
# transformer (--ep off the MoE transformer) with the JAX texts.
@pytest.mark.parametrize("argv,named,why", [
    pytest.param(argv, named, why, id=f"argv{i}-{named}") for i, (argv, named, why) in enumerate([
        (["--moe_experts", "4"], "--moe_experts", "requires --encoder transformer"),
        (["--encoder", "transformer", "--moe_experts", "4", "--moe_top_k", "0"], "--moe_top_k",
         "must be >= 1"),
        (["--sp", "2"], "--sp", "(ring attention) requires --encoder transformer"),
        (["--pp", "2"], "--pp", "(pipeline parallelism) requires --encoder transformer"),
        (["--ep", "2"], "--ep", "(expert parallelism) requires --encoder transformer"),
        (["--tfm_stacked"], "--tfm_stacked", "requires --encoder transformer"),
    ], start=2)
])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_cli_refuses_later_slices_by_name(capsys, mode, argv, named, why):
    with pytest.raises(SystemExit) as e:
        cli.main([mode, *TINY, *argv, "--load_ckpt", "unused"])
    assert e.value.code == 2
    assert f"{named} {why}" in capsys.readouterr().err


TFM_TINY = ["--encoder", "transformer", "--tfm_layers", "2", "--tfm_model", "16", "--tfm_heads",
            "2", "--tfm_ff", "32", "--model", "induction", "--induction_dim", "8",
            "--ntn_slices", "4"]
PATHS = {
    "adv": ["--encoder", "bilstm", "--lstm_hidden", "8", "--model", "induction",
            "--induction_dim", "8", "--ntn_slices", "4", "--adv", "--adv_batch", "4",
            "--adv_dis_hidden", "8"],
    "moe": TFM_TINY + ["--moe_experts", "4", "--moe_group_size", "32"],
    "stacked": TFM_TINY + ["--tfm_stacked"],
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_cli_train_then_test_slice_paths(tmp_path, capsys, path):
    """The adversarial, MoE and stacked paths through ``cli train`` (fused
    steps), then ``cli test --load_ckpt`` and the serving CLI on the
    checkpoint; its config carries the layout, which both take from it."""
    ckpt = str(tmp_path / path)
    assert cli.main(["train", *TINY, *PATHS[path], "--train_iter", "4", "--val_step", "2",
                     "--val_iter", "4", "--steps_per_call", "2", "--save_ckpt", ckpt]) == 0
    saved = JaxConfig.from_json((tmp_path / path / "config.json").read_text())
    assert (saved.moe_experts, saved.tfm_stacked) == (
        4 if path == "moe" else 0, path == "stacked")
    capsys.readouterr()
    assert cli.main(["test", "--synthetic", "--device", "cpu", "--load_ckpt", ckpt, "--N", "3",
                     "--K", "2", "--Q", "2", "--batch_size", "2", "--max_length", "12",
                     "--vocab_size", "62", "--test_iter", "4"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.0 <= out["test_accuracy"] <= 1.0
    assert serve_main(["--load_ckpt", ckpt, "--device", "cpu", "--buckets", "1,4"]) == 0


def test_unknown_proto_metric_refused():
    with pytest.raises(ValueError, match="unknown proto metric 'cosine'"):
        build_model(ExperimentConfig(model="proto", proto_metric="cosine", vocab_size=12),
                    device="cpu")


def test_serving_refuses_a_proto_checkpoint_by_name(tmp_path, capsys):
    ckpt = _train(tmp_path, "proto", capsys)
    assert CheckpointManager.load_config(ckpt).model == "proto"
    with pytest.raises(ValueError, match="requires --model induction.*got 'proto'"):
        InferenceEngine.from_checkpoint(ckpt, device="cpu")
    with pytest.raises(ValueError, match="requires --model induction.*got 'proto'"):
        serve_main(["--load_ckpt", ckpt, "--device", "cpu"])


@pytest.mark.parametrize("encoder", ["cnn", "transformer"])
def test_width_check_guards_the_bilstm_alone(monkeypatch, encoder):
    """``check_kernel_widths`` guards the BiLSTM kernels only: a CNN or
    transformer model builds at an lstm_hidden the kernels cannot take."""
    from induction_network_on_fewrel_tpu_torch.models import build as tbuild

    monkeypatch.setattr(tbuild, "check_kernel_widths",
                        lambda *a: pytest.fail("the BiLSTM width check ran"))
    model = build_model(ExperimentConfig(model="proto", encoder=encoder, lstm_hidden=640,
                                         vocab_size=12), device="cpu")
    assert not hasattr(model.encoder, "w_hh")
