"""Torch-native checkpoints: a best slot and a latest slot.

The JAX package keeps orbax checkpoints (best-val retention, a recovery
ring, integrity sidecars); this slice keeps what its train loop and test
entry point need. A checkpoint directory holds one run's

    config.json   the run's ExperimentConfig (the JAX names; it loads into
                  the JAX package's ExperimentConfig as well)
    best.pt       torch.save of {"step", "val_accuracy", "params", "opt"}
    latest.pt     the same, written at every val boundary and at the end

where ``params`` is the model's state_dict and ``opt`` the optimizer's
(``ClipDecayAdam.state_dict``). A manager made with the run's config
saves; its first save writes ``config.json`` and drops the slots an
earlier run left in the directory, so a directory never pairs one run's
config with another run's weights, and ``written`` names the slots this
run saved. Saves are synchronous and atomic (a temporary file renamed
over the slot), and a restore reads the tensors onto the model's device.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig

SLOTS = ("best", "latest")


class CheckpointManager:
    def __init__(self, directory: str | Path, cfg: ExperimentConfig | None = None):
        self.dir = Path(directory)
        self.cfg = cfg
        self.written: set[str] = set()

    @staticmethod
    def load_config(directory: str | Path) -> ExperimentConfig:
        path = Path(directory) / "config.json"
        if not path.exists():
            raise FileNotFoundError(f"no config.json in {directory}")
        return ExperimentConfig.from_json(path.read_text())

    def _write(self, slot: str, payload: dict) -> None:
        if self.cfg is None:
            raise ValueError("a CheckpointManager made without a config only restores")
        if not self.written:
            self.dir.mkdir(parents=True, exist_ok=True)
            for old in SLOTS:
                (self.dir / f"{old}.pt").unlink(missing_ok=True)
            (self.dir / "config.json").write_text(self.cfg.to_json())
        path = self.dir / f"{slot}.pt"
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)
        self.written.add(slot)

    def save(self, step: int, model, opt, val_accuracy: float) -> None:
        """The best slot (the caller decides that ``val_accuracy`` improved)."""
        self._write("best", {"step": int(step), "val_accuracy": float(val_accuracy),
                             "params": model.state_dict(), "opt": opt.state_dict()})

    def save_latest(self, step: int, model, opt) -> None:
        self._write("latest", {"step": int(step), "params": model.state_dict(),
                               "opt": opt.state_dict()})

    def has(self, slot: str) -> bool:
        return (self.dir / f"{slot}.pt").exists()

    def restore(self, slot: str, model, opt=None) -> int:
        """Load ``slot`` into ``model`` (and ``opt``); returns its step.
        Raises FileNotFoundError when the slot was never written."""
        if slot not in SLOTS:
            raise ValueError(f"unknown checkpoint slot {slot!r} ({SLOTS})")
        path = self.dir / f"{slot}.pt"
        if not path.exists():
            raise FileNotFoundError(f"no {slot} checkpoint in {self.dir}")
        payload = torch.load(path, map_location=model.device, weights_only=True)
        model.load_state_dict(payload["params"])
        if opt is not None:
            opt.load_state_dict(payload["opt"])
        return int(payload["step"])

    def restore_best(self, model, opt=None) -> int:
        return self.restore("best", model, opt)
