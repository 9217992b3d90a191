"""The port's zoo quality sweep (``tools/zoo_quality.py`` of the port
package) on the CPU: the JAX tool's model list and recipe, and one row
at a tiny recipe with ``--device cpu`` carrying the JAX tool's keys.
Without CUDA and without ``--device cpu`` the sweep refuses to start."""

import json
import sys
from pathlib import Path

import pytest

from induction_network_on_fewrel_tpu_torch.tools import zoo_quality

_TOOLS = str(Path(__file__).resolve().parents[1] / "tools")
if _TOOLS not in sys.path:
    sys.path.insert(0, _TOOLS)

import zoo_quality as jax_zoo  # noqa: E402

# The JAX tool's row keys (tools/zoo_quality.py: the CLI's final JSON line
# and the steady-state train rate).
ROW_KEYS = {"model", "final_val_accuracy", "acc_ci95", "train_eps_s_median"}
CUT = ["--train_iter", "8", "--val_step", "4", "--val_iter", "4", "--steps_per_call", "4",
       "--max_length", "12", "--batch_size", "2", "--N", "3", "--K", "2", "--Q", "2",
       "--vocab_size", "62", "--hidden_size", "16"]


def test_the_recipe_is_the_jax_tools():
    assert zoo_quality.ZOO == jax_zoo.ZOO
    assert zoo_quality.COMMON == jax_zoo.COMMON


def test_a_tiny_row_has_the_jax_keys(capsys):
    assert zoo_quality.main(["proto", "--device", "cpu", "--", *CUT]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert set(row) == ROW_KEYS, row
    assert row["model"] == "proto"
    assert 0.0 <= row["final_val_accuracy"] <= 1.0 and row["train_eps_s_median"] > 0


def test_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        zoo_quality.main(["proto"])
