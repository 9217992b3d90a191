"""Torch-native checkpoints: best-val retention, a recovery ring with
integrity sidecars, quarantine, and delta saves of the lazy word table.

The port's counterpart of ``induction_network_on_fewrel_tpu/train/
checkpoint.py`` (orbax there; ``.pt`` files here, with the JAX manager's
behaviour). A checkpoint directory holds one run's

    config.json        the run's ExperimentConfig (the JAX names; it loads
                       into the JAX package's ExperimentConfig as well)
    best.pt            the newest best-val save; the two before it stay as
                       best.<step>.pt (best-val retention of 3)
    latest.pt          the full recovery-ring slot, written at every val
                       boundary and at the end
    ring_base.pt       the ring of a state with the lazy leaves
    ring_delta.pt      (``ckpt_delta`` "auto"): a full base, then deltas

and next to each slot file ``<slot>.integrity.json``: the slot's kind,
step (and val accuracy), a sha256 of every tensor and scalar of the
payload and a digest of those. A full payload is ``{"step", "params"
(the model's state_dict), "opt" (ClipDecayOptimizer.state_dict), "lazy"
(the lazy table's m, v, last, when it has one), "best_val", "samplers"
(the streams' positions: the train feed's pipeline cursor and the val
sampler's state, ``FewShotTrainer.sampler_states``), "val_accuracy" (best
slots)}``. The cursor thus lies under the slot's sidecar and goes with its
slot, so every restorable step carries its cursor. A delta is
the base's step and nonce, the ids of the rows where any of the four
embedding leaves (table, m, v, last) differ from the base, those rows,
and every other leaf in full. The diff runs on the device against the
base's leaves kept there, at the boundary (its ``nonzero`` syncs the
host), and a delta past half the table writes a fresh base instead.
Best saves stay full.

Restores verify the payload against its sidecar. A slot that fails (a
digest mismatch, an unreadable file that claims a sidecar, a delta whose
base is missing, replaced or corrupt) is renamed ``.quarantined`` (never
deleted; a ``fault`` record goes to the logger), and the walk goes on:
``restore_latest`` takes the newest intact slot of the ring and the best
saves (the ring wins ties; delta -> base -> best), ``restore_best`` the
best intact best save by val accuracy. A slot without a sidecar (written
before this format) keeps the old behaviour: its errors raise. Verified
data whose load into the model fails (an architecture mismatch) re-raises
the original error and quarantines nothing.

A manager made with the run's config saves; its first save writes
``config.json`` and drops the slots an earlier run left in the directory,
and ``written`` names the families ("best", "latest") this run saved.
``restore_latest`` takes a directory over for the run that resumes it
(and re-arms the delta base it holds). Saves are synchronous and atomic
(temporary files renamed over the slot). A restore copies the tensors in
place into the model, the optimizer's state and the lazy table (captured
CUDA graphs hold their addresses). A manager made with a config refuses a
directory whose ``config.json`` disagrees with it on an architecture
field, naming the fields.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import uuid
from pathlib import Path

import numpy as np
import torch

from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig

SLOTS = ("best", "latest")
WORD_TABLE = "embedding.word_embedding"
KEEP_BEST = 3
RING_FILES = {"latest": "latest.pt", "ring_base": "ring_base.pt", "ring_delta": "ring_delta.pt"}
SIDECAR = ".integrity.json"
_OLD_BEST = re.compile(r"^best\.(\d{8})\.pt$")


class CorruptCheckpointError(RuntimeError):
    """A slot failed its integrity check; carries its identity for the
    quarantine."""

    def __init__(self, kind: str, path: Path, step: int | None, reason: str):
        super().__init__(f"checkpoint slot {kind}/{step} ({path.name}) corrupt: {reason}")
        self.kind, self.path, self.step, self.reason = kind, path, step, reason


def _leaves(payload, prefix: str = "") -> list:
    """(path, leaf) of a payload: dicts in sorted key order, sequences by
    index; tensors, arrays and scalars are leaves."""
    if isinstance(payload, dict):
        out = []
        for k in sorted(payload, key=str):
            out += _leaves(payload[k], f"{prefix}/{k}")
        return out
    if isinstance(payload, (list, tuple)):
        out = []
        for i, x in enumerate(payload):
            out += _leaves(x, f"{prefix}/{i}")
        return out
    return [(prefix, payload)]


def _leaf_digest(leaf) -> str:
    """sha256 of a tensor's dtype, shape and bytes; of a scalar's repr."""
    h = hashlib.sha256()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        h.update(str(t.dtype).encode())
        h.update(repr(tuple(t.shape)).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy())
    elif isinstance(leaf, np.ndarray):
        h.update(leaf.dtype.str.encode())
        h.update(repr(leaf.shape).encode())
        h.update(np.ascontiguousarray(leaf).tobytes())
    else:
        h.update(repr(leaf).encode())
    return h.hexdigest()


def payload_manifest(payload: dict) -> dict:
    """{"leaves": {path: sha256}, "manifest_sha"}: the integrity chain each
    save writes and each restore verifies."""
    d = {p: _leaf_digest(x) for p, x in _leaves(payload)}
    m = hashlib.sha256()
    for k in sorted(d):
        m.update(k.encode())
        m.update(d[k].encode())
    return {"leaves": d, "manifest_sha": m.hexdigest()}


def _to_cpu(payload):
    if isinstance(payload, dict):
        return {k: _to_cpu(v) for k, v in payload.items()}
    if isinstance(payload, (list, tuple)):
        return type(payload)(_to_cpu(v) for v in payload)
    if isinstance(payload, torch.Tensor):
        return payload.detach().to("cpu", copy=True)
    return payload


def _sidecar(path: Path) -> Path:
    return path.with_name(path.name + SIDECAR)


class CheckpointManager:
    def __init__(self, directory: str | Path, cfg: ExperimentConfig | None = None, logger=None):
        self.dir = Path(directory)
        self.cfg = cfg
        self.logger = logger
        self.written: set[str] = set()
        self._delta_on = cfg is not None and cfg.ckpt_delta != "off"
        self._base: dict | None = None      # the delta base's step, nonce and leaves

    @staticmethod
    def load_config(directory: str | Path) -> ExperimentConfig:
        path = Path(directory) / "config.json"
        if not path.exists():
            raise FileNotFoundError(f"no config.json in {directory}")
        return ExperimentConfig.from_json(path.read_text())

    # --- the slot files -------------------------------------------------

    def _best_files(self) -> list[Path]:
        files = [p for p in self.dir.glob("best.*.pt") if _OLD_BEST.match(p.name)]
        top = self.dir / "best.pt"
        return files + ([top] if top.exists() else [])

    def _slot_files(self) -> list[tuple[str, Path]]:
        out = [("best", p) for p in self._best_files()]
        out += [(kind, self.dir / name) for kind, name in RING_FILES.items()
                if (self.dir / name).exists()]
        return out

    def _manifest(self, kind: str, path: Path) -> dict | None:
        """The slot's sidecar, None for a slot written without one; an
        unreadable sidecar makes the slot corrupt."""
        side = _sidecar(path)
        if not side.exists():
            return None
        try:
            return json.loads(side.read_text())
        except (OSError, ValueError) as e:
            raise CorruptCheckpointError(kind, path, None, f"unreadable sidecar: {e}") from e

    def _header(self, kind: str, path: Path) -> dict:
        """{"step", "val_accuracy"} of a slot, from its sidecar (or, for a
        slot without one, from the payload)."""
        man = self._manifest(kind, path)
        if man is not None:
            return man
        payload = torch.load(path, map_location="cpu", weights_only=True)
        return {"step": int(payload["step"]),
                "val_accuracy": float(payload.get("val_accuracy", -1.0))}

    # --- saving ---------------------------------------------------------

    def _write(self, name: str, payload: dict, family: str, header: dict) -> int:
        """Write ``payload`` to ``name`` with its sidecar; returns the file's
        bytes."""
        if self.cfg is None:
            raise ValueError("a CheckpointManager made without a config only restores")
        if not self.written:
            self.dir.mkdir(parents=True, exist_ok=True)
            for _, old in self._slot_files():
                old.unlink(missing_ok=True)
                _sidecar(old).unlink(missing_ok=True)
            (self.dir / "config.json").write_text(self.cfg.to_json())
        payload = _to_cpu(payload)
        path = self.dir / name
        side = _sidecar(path)
        tmp, tmp_side = (p.with_name(f"{p.name}.{os.getpid()}.tmp") for p in (path, side))
        torch.save(payload, tmp)
        tmp_side.write_text(json.dumps({**header, **payload_manifest(payload)}))
        os.replace(tmp, path)
        os.replace(tmp_side, side)
        self.written.add(family)
        return path.stat().st_size

    @staticmethod
    def _state(model, opt, lazy) -> dict:
        out = {"params": model.state_dict(), "opt": opt.state_dict()}
        if lazy is not None:
            out["lazy"] = lazy.state_dict()
        return out

    def save(self, step: int, model, opt, val_accuracy: float, lazy=None,
             samplers: dict | None = None) -> None:
        """A best save (the caller decides that ``val_accuracy`` improved);
        the previous best stays as best.<step>.pt, the oldest beyond
        KEEP_BEST go."""
        top = self.dir / "best.pt"
        if top.exists() and "best" in self.written:
            old = int(self._header("best", top)["step"])
            kept = self.dir / f"best.{old:08d}.pt"
            os.replace(top, kept)
            if _sidecar(top).exists():
                os.replace(_sidecar(top), _sidecar(kept))
            older = sorted(p for p in self._best_files() if p.name != "best.pt")
            for p in older[:max(0, len(older) - (KEEP_BEST - 1))]:
                p.unlink()
                _sidecar(p).unlink(missing_ok=True)
        header = {"kind": "best", "step": int(step), "val_accuracy": float(val_accuracy)}
        self._write("best.pt", {"step": int(step), "val_accuracy": float(val_accuracy),
                                **self._state(model, opt, lazy), "best_val": float(val_accuracy),
                                "samplers": samplers or {}}, "best", header)

    def ring_step(self) -> int | None:
        """The newest step the recovery ring holds."""
        steps = []
        for kind, path in self._slot_files():
            if kind != "best":
                try:
                    steps.append(int(self._header(kind, path)["step"]))
                except CorruptCheckpointError:
                    continue
        return max(steps, default=None)

    def save_latest(self, step: int, model, opt, best_val: float = -1.0,
                    samplers: dict | None = None, lazy=None) -> dict | None:
        """A recovery-ring save: full, or (a state with the lazy leaves and
        ``ckpt_delta`` "auto") a base or a delta. Returns {"mode": full |
        base | delta, "bytes", "rows" (deltas)}, or None when the ring
        already holds this step."""
        if "latest" in self.written and self.ring_step() == int(step):
            return None
        extra = {"best_val": float(best_val), "samplers": samplers or {}}
        if lazy is None or not self._delta_on:
            size = self._write("latest.pt", {"step": int(step), **self._state(model, opt, lazy),
                                             **extra}, "latest",
                               {"kind": "latest", "step": int(step)})
            return {"mode": "full", "bytes": size}
        table = model.embedding.word_embedding.detach()
        leaves = {"table": table, "m": lazy.m, "v": lazy.v, "last": lazy.last}
        base = self._base
        if base is not None and base["table"].shape != table.shape:
            base = None
        if base is not None and base["table"].device != table.device:
            base = self._base = {k: (v.to(table.device) if isinstance(v, torch.Tensor) else v)
                                 for k, v in base.items()}
        idx = None
        if base is not None:
            changed = torch.zeros(table.shape[0], dtype=torch.bool, device=table.device)
            for name, x in leaves.items():
                diff = x != base[name]
                changed |= diff.any(-1) if diff.dim() > 1 else diff
            idx = torch.nonzero(changed).reshape(-1)          # syncs: a boundary
            if 2 * idx.numel() > table.shape[0]:
                base = None                                   # past half the table
        if base is None:
            nonce = uuid.uuid4().int & ((1 << 63) - 1)
            size = self._write("ring_base.pt", {"step": int(step), "nonce": nonce,
                                                **self._state(model, opt, lazy), **extra},
                               "latest", {"kind": "ring_base", "step": int(step)})
            for stale in ("ring_delta.pt", "latest.pt"):
                (self.dir / stale).unlink(missing_ok=True)
                _sidecar(self.dir / stale).unlink(missing_ok=True)
            self._base = {"step": int(step), "nonce": nonce,
                          **{k: x.detach().clone() for k, x in leaves.items()}}
            return {"mode": "base", "bytes": size}
        params = {k: v for k, v in model.state_dict().items() if k != WORD_TABLE}
        payload = {"step": int(step), "base_step": base["step"], "base_nonce": base["nonce"],
                   "idx": idx.long(), "rows": {k: x.detach()[idx] for k, x in leaves.items()},
                   "params": params, "opt": opt.state_dict(), **extra}
        size = self._write("ring_delta.pt", payload, "latest",
                           {"kind": "ring_delta", "step": int(step)})
        return {"mode": "delta", "bytes": size, "rows": int(idx.numel())}

    def purge_ring_newer_than(self, best_step: int) -> None:
        """Delete every ring slot newer than ``best_step`` (the divergence
        guard's restore: a later --resume must not restore the collapse),
        and drop a delta base newer than it."""
        for kind, path in self._slot_files():
            if kind == "best":
                continue
            try:
                step = int(self._header(kind, path)["step"])
            except CorruptCheckpointError:
                continue
            if step > best_step:
                path.unlink()
                _sidecar(path).unlink(missing_ok=True)
        if self._base is not None and self._base["step"] > best_step:
            self._base = None

    # --- integrity ------------------------------------------------------

    def _quarantine(self, err: CorruptCheckpointError) -> None:
        """Rename the slot and its sidecar aside (``.quarantined``, numbered
        if taken); one ``fault`` record."""
        for p in (err.path, _sidecar(err.path)):
            if not p.exists():
                continue
            q, n = p.with_name(p.name + ".quarantined"), 1
            while q.exists():
                q, n = p.with_name(f"{p.name}.quarantined{n}"), n + 1
            p.rename(q)
        if err.kind == "ring_base":
            self._base = None
        if self.logger is not None:
            self.logger.log(-1 if err.step is None else int(err.step), "fault",
                            action="ckpt_quarantine", ckpt_kind=err.kind,
                            ckpt_step=float(-1 if err.step is None else err.step),
                            reason=err.reason)

    def _load_verified(self, kind: str, path: Path) -> dict:
        """The payload of a slot, verified against its sidecar."""
        if not path.exists():
            raise FileNotFoundError(f"no {path.name} in {self.dir}")
        man = self._manifest(kind, path)
        step = None if man is None else man.get("step")
        try:
            payload = torch.load(path, map_location="cpu", weights_only=True)
        except Exception as e:          # noqa: BLE001 - classified by the sidecar
            if man is None:
                raise
            raise CorruptCheckpointError(kind, path, step, f"unreadable payload: {e}") from e
        if man is not None:
            got = payload_manifest(payload)
            if got["manifest_sha"] != man.get("manifest_sha"):
                bad = sorted(k for k in set(got["leaves"]) | set(man.get("leaves", {}))
                             if got["leaves"].get(k) != man.get("leaves", {}).get(k))
                raise CorruptCheckpointError(kind, path, step,
                                             f"digest mismatch in {bad[:3]}")
        return payload

    def _check_architecture(self) -> None:
        if self.cfg is not None and (self.dir / "config.json").exists():
            saved = self.load_config(self.dir)
            differ = [f for f in self.cfg.ARCHITECTURE_FIELDS
                      if getattr(saved, f) != getattr(self.cfg, f)]
            if differ:
                raise ValueError(f"checkpoint {self.dir} was saved with other architecture "
                                 f"fields: {differ}")

    def _assemble_ring(self, kind: str, path: Path) -> dict:
        """A ring slot's full payload: a delta resolved over its base. A
        missing or stale base makes a delta with a sidecar corrupt."""
        if kind == "latest":
            return self._load_verified(kind, path)
        base_path = self.dir / RING_FILES["ring_base"]
        if kind == "ring_delta" and not base_path.exists():
            man = self._manifest(kind, path)
            if man is None:
                raise FileNotFoundError(f"delta ring in {self.dir} has no base save")
            raise CorruptCheckpointError(kind, path, man.get("step"),
                                         "orphaned delta: its base is missing or quarantined")
        base = self._load_verified("ring_base", base_path)
        out = base
        if kind == "ring_delta":
            delta = self._load_verified(kind, path)
            if (int(delta["base_step"]), int(delta["base_nonce"])) != \
                    (int(base["step"]), int(base["nonce"])):
                msg = (f"delta {delta['step']} references base {int(delta['base_step'])}/"
                       f"{int(delta['base_nonce'])}, the directory holds "
                       f"{int(base['step'])}/{int(base['nonce'])}")
                if self._manifest(kind, path) is None:
                    raise ValueError(msg)
                raise CorruptCheckpointError(kind, path, int(delta["step"]), msg)
            idx = delta["idx"]
            table = base["params"][WORD_TABLE].clone()
            lazy = {k: v.clone() for k, v in base["lazy"].items()}
            table[idx] = delta["rows"]["table"]
            for name in ("m", "v", "last"):
                lazy[name][idx] = delta["rows"][name]
            out = {"step": int(delta["step"]), "params": {**delta["params"], WORD_TABLE: table},
                   "opt": delta["opt"], "lazy": lazy, "best_val": delta["best_val"],
                   "samplers": delta["samplers"]}
        self._arm_base(base)
        return out

    def _arm_base(self, base: dict) -> None:
        """Re-arm the diff base from a restored base payload (moved to the
        device at the next ring save), so that save deltas against the base
        the directory holds."""
        if self._delta_on and "lazy" in base:
            self._base = {"step": int(base["step"]), "nonce": int(base["nonce"]),
                          "table": base["params"][WORD_TABLE], **base["lazy"]}

    # --- restoring ------------------------------------------------------

    def has(self, slot: str) -> bool:
        if slot not in SLOTS:
            raise ValueError(f"unknown checkpoint slot {slot!r} ({SLOTS})")
        return any((kind == "best") == (slot == "best") for kind, _ in self._slot_files())

    def _walk(self, slot: str):
        """(kind, path, header) of the candidates of ``slot`` in restore
        order: best saves by val accuracy; for "latest" every slot by step,
        the ring before the best saves at a tie."""
        cands = []
        for kind, path in self._slot_files():
            if slot == "best" and kind != "best":
                continue
            try:
                head = self._header(kind, path)
            except CorruptCheckpointError as e:
                self._quarantine(e)
                return self._walk(slot)
            key = ((float(head.get("val_accuracy", -1.0)), int(head["step"])) if slot == "best"
                   else (int(head["step"]), kind != "best"))
            cands.append((key, kind, path, head))
        cands.sort(key=lambda c: c[0], reverse=True)
        return [(k, p, h) for _, k, p, h in cands]

    def _payload(self, slot: str) -> dict:
        """The verified payload of the newest intact candidate of ``slot``,
        quarantining corrupt ones on the way."""
        if slot not in SLOTS:
            raise ValueError(f"unknown checkpoint slot {slot!r} ({SLOTS})")
        self._check_architecture()
        while True:
            cands = self._walk(slot)
            if not cands:
                raise FileNotFoundError(f"no {slot} checkpoint in {self.dir}")
            kind, path, _ = cands[0]
            try:
                payload = (self._load_verified(kind, path) if kind == "best"
                           else self._assemble_ring(kind, path))
            except CorruptCheckpointError as e:
                self._quarantine(e)
                continue
            return payload

    def params(self, slot: str) -> dict:
        """The model state_dict of ``slot`` as CPU tensors (the serving
        publish's source). Raises FileNotFoundError when none is intact."""
        return self._payload(slot)["params"]

    def _load(self, slot: str, model, opt=None, lazy=None) -> dict:
        payload = self._payload(slot)
        model.load_state_dict(payload["params"])
        if opt is not None:
            opt.load_state_dict(payload["opt"])
        if lazy is not None:
            if "lazy" not in payload:
                raise ValueError(f"the {slot} checkpoint in {self.dir} has no lazy word-table "
                                 "state (saved with another embed_optimizer)")
            lazy.load_state_dict(payload["lazy"])
        return payload

    def restore(self, slot: str, model, opt=None, lazy=None) -> int:
        """Load ``slot`` into ``model`` (and ``opt``, ``lazy``) in place;
        returns its step. Raises FileNotFoundError when none is intact."""
        return int(self._load(slot, model, opt, lazy)["step"])

    def restore_best(self, model, opt=None, lazy=None) -> int:
        return self.restore("best", model, opt, lazy)

    def restore_latest(self, model, opt=None, lazy=None) -> tuple[int, dict]:
        """Load the newest intact slot in place, and take the directory over
        for the run that resumes it; returns (step, {"best_val",
        "samplers"})."""
        payload = self._load("latest", model, opt, lazy)
        self.written.update(s for s in SLOTS if self.has(s))
        return int(payload["step"]), {"best_val": float(payload.get("best_val", -1.0)),
                                      "samplers": payload.get("samplers", {})}
