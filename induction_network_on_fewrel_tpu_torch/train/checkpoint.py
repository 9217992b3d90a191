"""Torch-native checkpoints: a best slot and a latest slot.

The JAX package keeps orbax checkpoints (best-val retention, a recovery
ring, integrity sidecars); this slice keeps what its train loop, ``--resume``
and the test entry point need. A checkpoint directory holds one run's

    config.json   the run's ExperimentConfig (the JAX names; it loads into
                  the JAX package's ExperimentConfig as well)
    best.pt       torch.save of {"step", "val_accuracy", "params", "opt"}
    latest.pt     {"step", "params", "opt", "best_val", "samplers"}, written
                  at every val boundary and at the end

where ``params`` is the model's state_dict and ``opt`` the optimizer's
(``ClipDecayOptimizer.state_dict``: the count, each parameter's rule and
its moments, None where the rule keeps none), and ``samplers`` the random
states of the train and val samplers. A manager made with the run's config
saves; its first save writes ``config.json`` and drops the slots an
earlier run left in the directory, so a directory never pairs one run's
config with another run's weights, and ``written`` names the slots this
run saved. ``restore_latest`` takes a directory over for the run that
resumes it: its slots count as this run's, so the resumed run's saves keep
its best slot. Saves are synchronous and atomic (a temporary file renamed
over the slot). A restore copies the tensors in place into the model's
parameters and the optimizer's state (a captured CUDA graph holds their
addresses); a manager made with a config refuses a directory whose
``config.json`` disagrees with it on an architecture field (the optimizer
rules among them), naming the fields.
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

    def save_latest(self, step: int, model, opt, best_val: float = -1.0,
                    samplers: dict | None = None) -> None:
        self._write("latest", {"step": int(step), "params": model.state_dict(),
                               "opt": opt.state_dict(), "best_val": float(best_val),
                               "samplers": samplers or {}})

    def has(self, slot: str) -> bool:
        return (self.dir / f"{slot}.pt").exists()

    def _payload(self, slot: str, map_location) -> dict:
        if slot not in SLOTS:
            raise ValueError(f"unknown checkpoint slot {slot!r} ({SLOTS})")
        path = self.dir / f"{slot}.pt"
        if not path.exists():
            raise FileNotFoundError(f"no {slot} checkpoint in {self.dir}")
        if self.cfg is not None and (self.dir / "config.json").exists():
            saved = self.load_config(self.dir)
            differ = [f for f in self.cfg.ARCHITECTURE_FIELDS
                      if getattr(saved, f) != getattr(self.cfg, f)]
            if differ:
                raise ValueError(f"checkpoint {self.dir} was saved with other architecture "
                                 f"fields: {differ}")
        return torch.load(path, map_location=map_location, weights_only=True)

    def params(self, slot: str) -> dict:
        """The model state_dict of ``slot`` as CPU tensors (the serving
        publish's source). Raises FileNotFoundError when it was never
        written."""
        return self._payload(slot, "cpu")["params"]

    def _load(self, slot: str, model, opt=None) -> dict:
        payload = self._payload(slot, model.device)
        model.load_state_dict(payload["params"])
        if opt is not None:
            opt.load_state_dict(payload["opt"])
        return payload

    def restore(self, slot: str, model, opt=None) -> int:
        """Load ``slot`` into ``model`` (and ``opt``) in place; returns its
        step. Raises FileNotFoundError when the slot was never written."""
        return int(self._load(slot, model, opt)["step"])

    def restore_best(self, model, opt=None) -> int:
        return self.restore("best", model, opt)

    def restore_latest(self, model, opt=None) -> tuple[int, dict]:
        """Load the latest slot in place, and take the directory over for
        the run that resumes it; returns (step, {"best_val", "samplers"})."""
        payload = self._load("latest", model, opt)
        self.written.update(s for s in SLOTS if self.has(s))
        return int(payload["step"]), {"best_val": float(payload.get("best_val", -1.0)),
                                      "samplers": payload.get("samplers", {})}
