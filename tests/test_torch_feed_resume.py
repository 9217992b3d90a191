"""A crash and a resume through the port's CLI replay the episode stream exactly.

``cli train`` over the C++ sampler behind the host feed at depth 2: a run
crashed by ``--fault_step`` and continued with ``--resume`` consumes the
same batches, in the same order, as the uninterrupted run from the
checkpoint's step on (every batch the trainer draws is recorded), and ends
with the same parameters, optimizer state and pipeline cursor, bitwise;
then a second resume from a cursor inside a fused unit. A checkpoint from
before the host feed, whose ``samplers`` entry holds the numpy samplers'
raw ``bit_generator`` states, still resumes with ``--sampler python`` to
the uninterrupted run's state, and is refused by name over the C++
sampler.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import hashlib
import json

import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu_torch import cli
from induction_network_on_fewrel_tpu_torch.datapipe import PipelineFeed
from induction_network_on_fewrel_tpu_torch.datapipe.faults import tree_leaves
from induction_network_on_fewrel_tpu_torch.train.checkpoint import payload_manifest

TINY = ["--synthetic", "--N", "3", "--K", "2", "--Q", "2", "--batch_size", "2",
        "--max_length", "12", "--vocab_size", "62", "--lstm_hidden", "8",
        "--induction_dim", "10", "--ntn_slices", "4", "--device", "cpu", "--lr", "5e-3",
        "--val_step", "3", "--val_iter", "4"]


@pytest.fixture
def consumed(monkeypatch):
    """A digest of every batch a feed hands to the trainer, in order (a
    fused draw as its single batches)."""
    seen = []
    single, fused = PipelineFeed.sample_batch, PipelineFeed._sample_fused

    def digest(leaves):
        return hashlib.sha256(b"".join(np.ascontiguousarray(x).tobytes()
                                       for x in leaves)).hexdigest()

    def sample_batch(self):
        out = single(self)
        seen.append(digest(tree_leaves(out)))
        return out

    def sample_fused(self, s):
        out = fused(self, s)
        seen.extend(digest([x[i] for x in out]) for i in range(s))
        return out

    monkeypatch.setattr(PipelineFeed, "sample_batch", sample_batch)
    monkeypatch.setattr(PipelineFeed, "_sample_fused", sample_fused)
    return seen


def _state(path):
    return torch.load(path, weights_only=True)


def _assert_same_state(a, b):
    assert a["step"] == b["step"]
    for k, v in a["params"].items():
        assert torch.equal(b["params"][k], v), k
    assert a["opt"]["count"] == b["opt"]["count"]
    for x, y in zip(a["opt"]["mu"] + a["opt"]["nu"], b["opt"]["mu"] + b["opt"]["nu"]):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("mode", [[], ["--token_cache"]], ids=["live", "token-cache"])
def test_crash_and_resume_at_depth_2_replay_the_stream(tmp_path, consumed, mode, capsys):
    common = [*TINY, *mode, "--sampler", "native", "--prefetch_depth", "2",
              "--steps_per_call", "3"]
    whole, parts = str(tmp_path / "whole"), str(tmp_path / "parts")
    assert cli.main(["train", *common, "--train_iter", "12", "--save_ckpt", whole]) == 0
    want = list(consumed)
    assert len(want) == 12
    consumed.clear()
    with pytest.raises(RuntimeError, match="injected fault at step 6"):
        cli.main(["train", *common, "--train_iter", "10", "--fault_step", "5",
                  "--save_ckpt", parts])
    assert consumed == want[:6]
    consumed.clear()
    assert cli.main(["train", *common, "--train_iter", "7", "--fault_step", "5", "--resume",
                     "--save_ckpt", parts]) == 0
    assert "restored latest checkpoint step=3" in capsys.readouterr().err
    assert consumed == want[3:10]
    end = _state(tmp_path / "parts" / "latest.pt")
    cursor = end["samplers"]["train"]
    # Inside the fused unit [9, 12): both C++ samplers fill units of 3.
    assert (cursor["consumed"], cursor["captured_at"]) == (10, 9)
    assert cursor["sampler_state"]["kind"] == "native"
    consumed.clear()
    # From a cursor inside a fused unit to step 12.
    assert cli.main(["train", *common, "--train_iter", "2", "--resume",
                     "--save_ckpt", parts]) == 0
    assert consumed == want[10:12]
    a, b = _state(tmp_path / "whole" / "latest.pt"), _state(tmp_path / "parts" / "latest.pt")
    _assert_same_state(a, b)
    assert a["samplers"]["train"]["consumed"] == b["samplers"]["train"]["consumed"] == 12
    assert a["samplers"]["val"] == b["samplers"]["val"]


def _to_pre_feed_format(path):
    """Rewrite a ring slot as a checkpoint from before the host feed wrote
    it: ``samplers`` holds each numpy sampler's raw ``bit_generator``
    state, under a sidecar of that payload."""
    payload = _state(path)
    samplers = payload["samplers"]
    payload["samplers"] = {"train": samplers["train"]["sampler_state"]["state"],
                           "val": samplers["val"]["state"]}
    torch.save(payload, path)
    side = path.with_name(path.name + ".integrity.json")
    header = json.loads(side.read_text())
    side.write_text(json.dumps({"kind": header["kind"], "step": header["step"],
                                **payload_manifest(payload)}))


def test_a_checkpoint_from_before_the_feed_still_resumes(tmp_path, capsys):
    common = [*TINY, "--sampler", "python", "--embed_optimizer", "sgd"]
    whole, parts = str(tmp_path / "whole"), str(tmp_path / "parts")
    assert cli.main(["train", *common, "--train_iter", "6", "--save_ckpt", whole]) == 0
    assert cli.main(["train", *common, "--prefetch_depth", "0", "--train_iter", "3",
                     "--save_ckpt", parts]) == 0
    _to_pre_feed_format(tmp_path / "parts" / "latest.pt")
    with pytest.raises(ValueError, match="resume it with --sampler python"):
        cli.main(["train", *common[:-4], "--sampler", "native", "--embed_optimizer", "sgd",
                  "--train_iter", "3", "--save_ckpt", parts, "--resume"])
    assert cli.main(["train", *common, "--train_iter", "3", "--save_ckpt", parts,
                     "--resume"]) == 0
    assert "restored latest checkpoint step=3" in capsys.readouterr().err
    for slot in ("latest", "best"):
        _assert_same_state(_state(tmp_path / "whole" / f"{slot}.pt"),
                           _state(tmp_path / "parts" / f"{slot}.pt"))
