"""The port's train/test command lines against the JAX package's.

* One command line, through both packages' ``build_arg_parser`` and
  ``config_from_args``, gives configs whose shared fields are all equal
  (``--routing_iters`` and the ``--fp16`` alias included, the host feed's
  flags, the ``--bert_*`` / ``--feature_cache`` flags, and the ``--moe_*``,
  ``--tfm_stacked`` and ``--adv*`` flags too).
* Every flag of both JAX parsers is either parsed by the port at the JAX
  default (a ported flag, or an unported one given its default) or, given
  anything else, refused by name with the ROADMAP item that brings it (or
  why it has no counterpart here), with rc 2.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import dataclasses
import functools
import json

import pytest
import torch

from induction_network_on_fewrel_tpu import cli as jax_cli
from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu_torch import cli
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.models.build import build_model

SHARED_FIELDS = sorted({f.name for f in dataclasses.fields(ExperimentConfig)}
                       & {f.name for f in dataclasses.fields(JaxConfig)})
# The port's default where the JAX one names the TPU: the card.
PORT_DEFAULTS = {"--device": None}

ARGVS = {
    "flagship": ["--routing_iters", "3", "--fp16", "--device", "cpu"],
    "wide": ["--N", "4", "--K", "3", "--Q", "2", "--trainN", "6", "--batch_size", "2",
             "--routing_iters", "2", "--fp16", "--lstm_hidden", "8", "--max_length", "12",
             "--induction_dim", "10", "--ntn_slices", "4", "--na_rate", "1", "--loss", "ce",
             "--optimizer", "adamw", "--lr", "0.002", "--steps_per_call", "2",
             "--sampler", "native", "--prefetch", "3", "--sampler_threads", "1",
             "--prefetch_depth", "0", "--mixture", "train:1;synthetic:0.5", "--seed", "3",
             "--device", "cpu"],
    "zoo": ["--model", "proto", "--encoder", "cnn", "--hidden_size", "16",
            "--routing_iters", "1", "--token_cache", "--sampler", "python", "--device", "cpu"],
    "bert": ["--encoder", "bert", "--bert_frozen", "--bert_layers", "2", "--bert_hidden", "32",
             "--bert_heads", "4", "--bert_intermediate", "64", "--bert_vocab_size", "500",
             "--bert_vocab", "vocab.txt", "--bert_weights", "bert.npz", "--bert_remat",
             "--feature_cache", "--fp16", "--device", "cpu"],
    "moe": ["--encoder", "transformer", "--moe_experts", "4", "--moe_top_k", "1",
            "--moe_capacity", "1.5", "--moe_every", "1", "--moe_group_size", "64",
            "--moe_aux_weight", "0.05", "--fp16", "--device", "cpu"],
    "stacked": ["--encoder", "transformer", "--tfm_stacked", "--tfm_layers", "3",
                "--device", "cpu"],
}
# Train-only flags of a command line (the test parsers have no --adv*).
TRAIN_ARGVS = {"moe": ["--adv", "target.json", "--adv_lambda", "0.5", "--adv_dis_hidden", "16",
                       "--adv_batch", "8"]}


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("name", sorted(ARGVS))
def test_config_from_args_matches_jax(name, train):
    argv = ARGVS[name] + (["--feed_fault", "slow:0.1", "--train_iter", "7",
                           *TRAIN_ARGVS.get(name, [])] if train else [])
    ours = cli.config_from_args(cli.parse_args(train, argv))
    theirs = jax_cli.config_from_args(jax_cli.build_arg_parser(train).parse_args(argv))
    diff = {f: (getattr(ours, f), getattr(theirs, f)) for f in SHARED_FIELDS
            if getattr(ours, f) != getattr(theirs, f)}
    assert not diff
    assert ours.compute_dtype == "bfloat16" or "--fp16" not in argv


def test_routing_iters_reaches_the_model():
    cfg = cli.config_from_args(cli.parse_args(True, ["--routing_iters", "2", "--lstm_hidden", "8",
                                                     "--vocab_size", "30", "--device", "cpu"]))
    assert build_model(cfg, device="cpu").induction.routing_iters == 2


@functools.lru_cache(maxsize=None)
def _actions(train: bool, port: bool) -> dict:
    parser = (cli if port else jax_cli).build_arg_parser(train)
    return {o: a for a in parser._actions for o in a.option_strings if o.startswith("--")}


FLAGS = [(train, flag) for train in (True, False) for flag in sorted(_actions(train, False))
         if flag != "--help"]


def _other_value(flag: str, action) -> list:
    """A command line giving ``flag`` something other than its JAX default."""
    if action.nargs == 0 or action.const is not None:
        return [flag]
    if flag in cli.NO_COUNTERPART:
        return [flag, {"--compile_cache": "/tmp/xla_cache", "--remat_attn": "off"}[flag]]
    d = action.default
    if action.type is int:
        return [flag, str((d or 0) + 7)]
    if action.type is float:
        return [flag, str((d or 0.0) + 0.5)]
    return [flag, "other"]


@pytest.mark.parametrize("train,flag", FLAGS,
                         ids=[f"{'train' if t else 'test'}{f}" for t, f in FLAGS])
def test_every_jax_flag_is_parsed_or_refused_by_name(train, flag, capsys):
    theirs = _actions(train, False)[flag]
    ours = _actions(train, True).get(flag)
    assert ours is not None, f"{flag} is neither ported nor refused by name"
    default = PORT_DEFAULTS.get(flag, theirs.default)
    assert ours.default == default
    explicit = [] if theirs.nargs == 0 or default is None else [flag, str(default)]
    assert getattr(cli.parse_args(train, explicit), ours.dest) == default
    if flag not in {**cli.DEFERRED, **cli.NO_COUNTERPART}:
        return
    with pytest.raises(SystemExit) as e:
        cli.parse_args(train, _other_value(flag, theirs))
    err = capsys.readouterr().err
    assert e.value.code == 2
    if flag in cli.DEFERRED:
        assert f"{flag} is not ported yet: it comes with ROADMAP queue A item" in err
    else:
        assert f"has no counterpart here: {cli.NO_COUNTERPART[flag][2]}" in err


def test_train_adapt_stamps_the_jax_config_fields(tmp_path):
    """``train --adapt`` with its knobs writes the fields the JAX train CLI
    puts in its config (``resolve_adapt_policy`` reads them back)."""
    from induction_network_on_fewrel_tpu_torch.config import resolve_adapt_policy

    flags = ["--adapt", "--adapt_retries", "5", "--adapt_backoff_s", "1.5",
             "--adapt_step_budget", "40", "--adapt_canary", "target:0.2,in_domain:0.5"]
    ckpt = tmp_path / "ckpt"
    assert cli.main(["train", "--synthetic", "--N", "3", "--K", "2", "--Q", "2",
                     "--batch_size", "2", "--max_length", "12", "--vocab_size", "40",
                     "--lstm_hidden", "8", "--induction_dim", "10", "--ntn_slices", "4",
                     "--device", "cpu", "--train_iter", "2", "--val_step", "2", "--val_iter", "2",
                     "--save_ckpt", str(ckpt), *flags]) == 0
    stamped = json.loads((ckpt / "config.json").read_text())
    theirs = jax_cli.config_from_args(jax_cli.build_arg_parser(True).parse_args(flags))
    fields = [f for f in SHARED_FIELDS if f == "adapt" or f.startswith("adapt_")]
    assert len(fields) == 8
    assert {f: stamped[f] for f in fields} == {f: getattr(theirs, f) for f in fields}
    policy = resolve_adapt_policy(ExperimentConfig.from_json((ckpt / "config.json").read_text()))
    assert policy["retry_budget"] == 5 and policy["canary_floors"] == {"target": 0.2,
                                                                       "in_domain": 0.5}
    with pytest.raises(ValueError, match="adapt_retries"):
        cli.config_from_args(cli.parse_args(True, ["--adapt", "--adapt_retries", "0",
                                                   "--device", "cpu"]))


DP_VALUES = {"--dp": ["0", "1", "2", "8"], "--zero_opt": [None],
             "--compact_demb": ["auto", "on", "off"], "--grad_bucketing": ["auto", "on", "off"],
             "--grad_bucket_count": ["1", "4", "7"], "--async_collectives": ["auto", "on", "off"]}
DP_ARGVS = [(train, flag, v) for train in (True, False) for flag, vs in DP_VALUES.items()
            for v in vs]


@pytest.mark.parametrize("train,flag,value", DP_ARGVS,
                         ids=[f"{'train' if t else 'test'}{f}={v}" for t, f, v in DP_ARGVS])
def test_dp_flags_parse_at_every_jax_value(train, flag, value):
    """The six data-parallel flags are ported: every JAX value parses into
    the JAX config's field (the mesh itself is made at run time)."""
    assert flag not in cli.DEFERRED and flag not in cli._NEUTRAL
    argv = ["--device", "cpu", flag] + ([] if value is None else [value])
    ours = cli.config_from_args(cli.parse_args(train, argv))
    theirs = jax_cli.config_from_args(jax_cli.build_arg_parser(train).parse_args(argv))
    field = flag[2:]
    assert getattr(ours, field) == getattr(theirs, field)
    assert {f: getattr(ours, f) for f in SHARED_FIELDS} == {f: getattr(theirs, f)
                                                            for f in SHARED_FIELDS}


@pytest.mark.parametrize("argv", [["--dp", "2"], ["--serving_dp", "2"]], ids=["serve", "load"])
def test_serving_dp_stays_refused_by_name(argv, capsys):
    """Serving ``--dp`` and the load tool's ``--serving_dp`` are ported: each
    parses to its JAX value and is no longer refused by name; more shard
    devices than are visible exit 2 with the JAX "exceeds" text."""
    from induction_network_on_fewrel_tpu_torch.load import __main__ as load_main
    from induction_network_on_fewrel_tpu_torch.load import harness
    from induction_network_on_fewrel_tpu_torch.serving import cli as serve_cli

    if argv[0] == "--dp":
        assert serve_cli.build_serve_arg_parser().parse_args(argv).dp == 2
    else:
        assert harness.parse_args(argv).serving_dp == 2
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    too_many = [argv[0], str(max(2, visible + 1)), "--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        if argv[0] == "--dp":
            serve_cli.serve_main(too_many)
        else:
            load_main.main(too_many)
    err = capsys.readouterr().err
    assert e.value.code == 2
    assert f"exceeds the {visible} visible devices" in err
    assert "not ported" not in err and "item 5" not in err
