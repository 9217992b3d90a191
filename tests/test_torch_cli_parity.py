"""The port's train/test command lines against the JAX package's.

* One command line, through both packages' ``build_arg_parser`` and
  ``config_from_args``, gives configs whose shared fields are all equal
  (``--routing_iters`` and the ``--fp16`` alias included, the host feed's
  flags and the ``--bert_*`` / ``--feature_cache`` flags too).
* Every flag of both JAX parsers is either parsed by the port at the JAX
  default (a ported flag, or an unported one given its default) or, given
  anything else, refused by name with the ROADMAP item that brings it (or
  why it has no counterpart here), with rc 2.
"""

import dataclasses
import functools

import pytest

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
}


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("name", sorted(ARGVS))
def test_config_from_args_matches_jax(name, train):
    argv = ARGVS[name] + (["--feed_fault", "slow:0.1", "--train_iter", "7"] if train else [])
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
