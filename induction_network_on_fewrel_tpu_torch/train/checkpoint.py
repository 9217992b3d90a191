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
(and re-arms the delta base it holds). Saves are atomic (temporary files
renamed over the slot). A restore copies the tensors in place into the
model, the optimizer's state and the lazy table (captured CUDA graphs
hold their addresses). A manager made with a config refuses a directory
whose ``config.json`` disagrees with it on an architecture field, naming
the fields.

The saver (every manager; the JAX manager's saver thread,
``train/checkpoint.py:643-748``): a save snapshots the state and
returns; a daemon thread copies the snapshot to the host, writes the
slot and its sidecar, fires the fault points and drains the staging. The
snapshot is a device-side clone taken on the caller's current stream,
with a CUDA event recorded after it: the training state lives in a CUDA
graph's static tensors, which the next replay overwrites, and stream
order puts the clone before that replay while the host goes on. The
saver's copy stream waits on the event, copies into pinned host memory
and synchronizes. ``wait()`` blocks until every queued save is durable in
the real directory and re-raises a failed save; every restore, ``has``,
``params``, ``ring_step`` and ``purge_ring_newer_than`` waits first;
``close()`` flushes and joins the thread, and an ``atexit`` hook flushes
(bounded) a manager never closed. A caller that needs the slot on disk
at once (a reference save) calls ``wait()`` after the save.

Staging (``stage="auto"``, ``--ckpt_stage``; the JAX ``_stage_root_for``
and ``_sync_tree``): when ``/dev/shm`` exists and the directory is not on
it, slots are written to a per-user, per-directory root there (mode
0o700, seeded from the directory at construction) and each save is
drained to the directory: newer or missing files are copied over by
rename, and slot files the staging no longer holds are deleted (best
rotation, a base that replaced a delta). ``close()`` removes the root.
"off", or a root that cannot be owned (a warning), writes in place.

Fault points (``obs/chaos.py``): ``ckpt.bitflip`` and ``ckpt.truncate``
fire after a ring save is written (ARG filters the ring kind: ``ring``
for ``latest.pt``, ``ring_base``, ``ring_delta``) and corrupt that slot
file before the drain; ``ckpt.restore_raise`` fires at each slot restore
attempt (``best`` too) and is contained as corruption: quarantine, one
``kind="fault"`` record, and the walk goes on.
"""

from __future__ import annotations

import atexit
import hashlib
import json
import os
import queue
import re
import shutil
import stat
import threading
import time
import uuid
import warnings
from pathlib import Path

import numpy as np
import torch

from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.obs.chaos import (
    chaos_active,
    chaos_fire,
    corrupt_file,
)

SLOTS = ("best", "latest")
WORD_TABLE = "embedding.word_embedding"
KEEP_BEST = 3
RING_FILES = {"latest": "latest.pt", "ring_base": "ring_base.pt", "ring_delta": "ring_delta.pt"}
SIDECAR = ".integrity.json"
_OLD_BEST = re.compile(r"^best\.(\d{8})\.pt$")
# Slot kind -> the ring-kind name the chaos plans use (the JAX manager's).
CHAOS_KIND = {"best": "best", "latest": "ring", "ring_base": "ring_base",
              "ring_delta": "ring_delta"}
_SLOT_FILE = re.compile(r"^(best(\.\d{8})?|latest|ring_base|ring_delta)\.pt"
                        r"(\.integrity\.json)?$")
STAGE_MODES = ("auto", "off")


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


def _map_tensors(payload, fn):
    if isinstance(payload, dict):
        return {k: _map_tensors(v, fn) for k, v in payload.items()}
    if isinstance(payload, (list, tuple)):
        return type(payload)(_map_tensors(v, fn) for v in payload)
    if isinstance(payload, torch.Tensor):
        return fn(payload)
    return payload


def _tensor_bytes(payload) -> int:
    """The payload's tensor bytes (the JAX manager's ``_tree_bytes``): what
    a save's ``bytes`` reports, whatever the file's size on disk."""
    return sum(x.numel() * x.element_size() for _, x in _leaves(payload)
               if isinstance(x, torch.Tensor))


def _sidecar(path: Path) -> Path:
    return path.with_name(path.name + SIDECAR)


def stage_root_for(real_dir: Path, mode: str) -> Path | None:
    """The staging root of ``real_dir`` under ``/dev/shm``, or None when
    staging is off: mode "off", no ``/dev/shm``, or ``real_dir`` already on
    it. A pure function of the user and the real path."""
    if mode not in STAGE_MODES:
        raise ValueError(f"unknown ckpt_stage {mode!r} (one of {STAGE_MODES})")
    shm = Path("/dev/shm")
    real = str(Path(real_dir).resolve())
    if mode == "off" or not shm.is_dir() or real.startswith(str(shm)):
        return None
    tag = hashlib.md5(f"{os.getuid()}:{real}".encode()).hexdigest()[:16]
    return shm / f"inftorch_ckpt_stage_u{os.getuid()}_{tag}"


def _claim_stage_root(path: Path) -> Path | None:
    """Create (0o700) or validate the staging root: a symlink, a non-dir or
    another user's dir disables staging with a warning, never a crash."""
    try:
        path.mkdir(mode=0o700, parents=True, exist_ok=True)
        st = path.lstat()
    except OSError as e:
        warnings.warn(f"staging root {path} unusable ({e}); checkpoints write in place",
                      stacklevel=3)
        return None
    if not stat.S_ISDIR(st.st_mode) or st.st_uid != os.getuid():
        warnings.warn(f"staging root {path} is a symlink, not a directory or another user's; "
                      "checkpoints write in place", stacklevel=3)
        return None
    return path


def _slot_names(root: Path) -> set[str]:
    return {p.name for p in root.iterdir() if p.is_file() and _SLOT_FILE.match(p.name)} \
        if root.is_dir() else set()


def sync_slots(src: Path, dst: Path) -> None:
    """Copy the slot files of ``src`` that are newer or missing in ``dst``
    (tmp + rename), then delete the slot files ``dst`` holds and ``src``
    does not. Nothing else in ``dst`` is touched."""
    dst.mkdir(parents=True, exist_ok=True)
    names = _slot_names(src)
    for name in sorted(names):
        p, q = src / name, dst / name
        s = p.stat()
        if not q.exists() or q.stat().st_size != s.st_size or q.stat().st_mtime < s.st_mtime:
            tmp = q.with_name(q.name + ".staging_tmp")
            shutil.copy2(p, tmp)
            os.replace(tmp, q)
    for name in _slot_names(dst) - names:
        (dst / name).unlink(missing_ok=True)


class CheckpointManager:
    def __init__(self, directory: str | Path, cfg: ExperimentConfig | None = None, logger=None,
                 stage: str = "off"):
        self.dir = Path(directory)
        self.cfg = cfg
        self.logger = logger
        self.written: set[str] = set()
        self._delta_on = cfg is not None and cfg.ckpt_delta != "off"
        self._base: dict | None = None      # the delta base's step, nonce and leaves
        self._last_ring: int | None = None  # the ring step last saved or restored
        self._stage = stage_root_for(self.dir, stage)
        if self._stage is not None:
            self._stage = _claim_stage_root(self._stage)
        if self._stage is not None:
            for name in _slot_names(self._stage):
                (self._stage / name).unlink()
            if self.dir.is_dir():
                sync_slots(self.dir, self._stage)
        self._save_error: BaseException | None = None
        self._closed = False
        self._copy_stream = None
        self._q: queue.Queue = queue.Queue()
        self._worker: threading.Thread | None = None   # started by the first save

    @property
    def root(self) -> Path:
        """Where slots are written: the staging root, else the directory."""
        return self._stage if self._stage is not None else self.dir

    @staticmethod
    def load_config(directory: str | Path) -> ExperimentConfig:
        path = Path(directory) / "config.json"
        if not path.exists():
            raise FileNotFoundError(f"no config.json in {directory}")
        return ExperimentConfig.from_json(path.read_text())

    # --- the slot files -------------------------------------------------

    def _best_files(self, root: Path | None = None) -> list[Path]:
        root = self.dir if root is None else root
        files = [p for p in root.glob("best.*.pt") if _OLD_BEST.match(p.name)]
        top = root / "best.pt"
        return files + ([top] if top.exists() else [])

    def _slot_files(self, root: Path | None = None) -> list[tuple[str, Path]]:
        root = self.dir if root is None else root
        out = [("best", p) for p in self._best_files(root)]
        out += [(kind, root / name) for kind, name in RING_FILES.items()
                if (root / name).exists()]
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

    # --- the saver -------------------------------------------------------

    def _submit(self, job) -> None:
        """Queue ``job`` on the saver thread (started at the first save, so
        a manager that only restores runs none)."""
        if self._closed:
            raise RuntimeError("checkpoint manager is closed")
        self._check_save_error()
        if self._worker is None:
            self._worker = threading.Thread(target=self._drain_queue, daemon=True,
                                            name="ckpt-saver")
            self._worker.start()
            atexit.register(self._flush_at_exit)
        self._q.put(job)

    def _drain_queue(self) -> None:
        while True:
            job = self._q.get()
            try:
                if job is None:
                    return
                job()
            except Exception as e:  # noqa: BLE001 — re-raised by wait()
                self._save_error = e
            finally:
                self._q.task_done()

    def _check_save_error(self) -> None:
        if self._save_error is not None:
            err, self._save_error = self._save_error, None
            raise RuntimeError("async checkpoint save failed") from err

    def wait(self) -> None:
        """Block until every queued save is durable in the directory;
        re-raise a failed save."""
        self._q.join()
        self._check_save_error()

    def _flush_at_exit(self) -> None:
        # Bounded: a wedged copy must not hang interpreter exit.
        t0 = time.monotonic()
        while not self._closed and self._q.unfinished_tasks and time.monotonic() - t0 < 60.0:
            time.sleep(0.1)

    def close(self) -> None:
        """Flush queued saves, stop the saver thread, remove the staging
        root. Idempotent."""
        if self._closed:
            return
        try:
            self.wait()
        finally:
            self._closed = True
            if self._worker is not None:
                self._q.put(None)
                self._worker.join(timeout=30.0)
                atexit.unregister(self._flush_at_exit)
            if self._stage is not None:
                shutil.rmtree(self._stage, ignore_errors=True)

    def _snapshot(self, payload: dict):
        """A device-side clone of every tensor of ``payload`` on the current
        stream, and the CUDA event after it (None on the CPU)."""
        snap = _map_tensors(payload, lambda t: t.detach().clone())
        cuda = [t for _, t in _leaves(snap) if isinstance(t, torch.Tensor) and t.is_cuda]
        if not cuda:
            return snap, None
        ev = torch.cuda.Event()
        ev.record()
        return snap, ev

    def _to_host(self, snap: dict, ev) -> dict:
        """The snapshot's tensors on the host: pinned copies on the saver's
        copy stream after ``ev``; a snapshot without a CUDA tensor (``ev``
        None) is already its own host copy."""
        if ev is None:
            return snap
        dev = next(t.device for _, t in _leaves(snap) if isinstance(t, torch.Tensor) and t.is_cuda)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(dev)
        stream = self._copy_stream
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            stream.wait_event(ev)

            def pinned(t: torch.Tensor) -> torch.Tensor:
                if not t.is_cuda:
                    return t
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                return host

            host = _map_tensors(snap, pinned)
        stream.synchronize()
        return host

    # --- saving ---------------------------------------------------------

    def _prepare(self) -> None:
        """At the first save of a manager: the directory, config.json, and
        the slots an earlier run left (in the staging too) dropped."""
        if self.cfg is None:
            raise ValueError("a CheckpointManager made without a config only restores")
        if self.written:
            return
        self.wait()
        self.dir.mkdir(parents=True, exist_ok=True)
        for root in {self.dir, self.root}:
            for _, old in self._slot_files(root):
                old.unlink(missing_ok=True)
                _sidecar(old).unlink(missing_ok=True)
        (self.dir / "config.json").write_text(self.cfg.to_json())

    def _write_slot(self, name: str, payload: dict, header: dict, ev=None) -> None:
        """On the saver: the slot file and its sidecar under the root, and
        the fault points."""
        payload = self._to_host(payload, ev)
        path = self.root / name
        side = _sidecar(path)
        tmp, tmp_side = (p.with_name(f"{p.name}.{os.getpid()}.tmp") for p in (path, side))
        torch.save(payload, tmp)
        tmp_side.write_text(json.dumps({**header, **payload_manifest(payload)}))
        os.replace(tmp, path)
        os.replace(tmp_side, side)
        kind = header["kind"]
        if chaos_active() and kind != "best":
            for point, mode in (("ckpt.bitflip", "bitflip"), ("ckpt.truncate", "truncate")):
                if chaos_fire(point, kind=CHAOS_KIND[kind], step=int(header["step"])) is not None:
                    corrupt_file(path, mode)

    def _drain_stage(self) -> None:
        if self._stage is not None:
            sync_slots(self._stage, self.dir)

    def _enqueue(self, name: str, payload: dict, family: str, header: dict, before=None,
                 after=None) -> int:
        """Snapshot ``payload`` now and queue its write (with
        ``before``/``after`` file work around it) on the saver. Returns the
        payload's tensor bytes."""
        self._prepare()
        snap, ev = self._snapshot(payload)
        self.written.add(family)

        def job() -> None:
            if before is not None:
                before()
            self._write_slot(name, snap, header, ev)
            if after is not None:
                after()
            self._drain_stage()

        self._submit(job)
        return _tensor_bytes(snap)

    @staticmethod
    def _state(model, opt, lazy) -> dict:
        out = {"params": model.state_dict(), "opt": opt.state_dict()}
        if lazy is not None:
            out["lazy"] = lazy.state_dict()
        return out

    def _rotate_best(self) -> None:
        """The previous best.pt becomes best.<step>.pt; the oldest beyond
        KEEP_BEST go (under the root)."""
        root = self.root
        top = root / "best.pt"
        if not top.exists():
            return
        old = int(self._header("best", top)["step"])
        kept = root / f"best.{old:08d}.pt"
        os.replace(top, kept)
        if _sidecar(top).exists():
            os.replace(_sidecar(top), _sidecar(kept))
        older = sorted(p for p in self._best_files(root) if p.name != "best.pt")
        for p in older[:max(0, len(older) - (KEEP_BEST - 1))]:
            p.unlink()
            _sidecar(p).unlink(missing_ok=True)

    def save(self, step: int, model, opt, val_accuracy: float, lazy=None,
             samplers: dict | None = None) -> None:
        """A best save (the caller decides that ``val_accuracy`` improved);
        the previous best stays as best.<step>.pt, the oldest beyond
        KEEP_BEST go."""
        rotate = "best" in self.written
        header = {"kind": "best", "step": int(step), "val_accuracy": float(val_accuracy)}
        self._enqueue("best.pt", {"step": int(step), "val_accuracy": float(val_accuracy),
                                  **self._state(model, opt, lazy), "best_val": float(val_accuracy),
                                  "samplers": samplers or {}}, "best", header,
                      before=self._rotate_best if rotate else None)

    def ring_step(self) -> int | None:
        """The newest step the recovery ring holds."""
        self.wait()
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
        already holds this step. ``bytes`` is the payload's tensor bytes."""
        if "latest" in self.written and self._last_ring == int(step):
            return None
        self._last_ring = int(step)
        extra = {"best_val": float(best_val), "samplers": samplers or {}}
        if lazy is None or not self._delta_on:
            size = self._enqueue("latest.pt", {"step": int(step), **self._state(model, opt, lazy),
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

            def drop_stale() -> None:
                for stale in ("ring_delta.pt", "latest.pt"):
                    (self.root / stale).unlink(missing_ok=True)
                    _sidecar(self.root / stale).unlink(missing_ok=True)

            size = self._enqueue("ring_base.pt", {"step": int(step), "nonce": nonce,
                                                  **self._state(model, opt, lazy), **extra},
                                 "latest", {"kind": "ring_base", "step": int(step)},
                                 after=drop_stale)
            self._base = {"step": int(step), "nonce": nonce,
                          **{k: x.detach().clone() for k, x in leaves.items()}}
            return {"mode": "base", "bytes": size}
        params = {k: v for k, v in model.state_dict().items() if k != WORD_TABLE}
        payload = {"step": int(step), "base_step": base["step"], "base_nonce": base["nonce"],
                   "idx": idx.long(), "rows": {k: x.detach()[idx] for k, x in leaves.items()},
                   "params": params, "opt": opt.state_dict(), **extra}
        size = self._enqueue("ring_delta.pt", payload, "latest",
                             {"kind": "ring_delta", "step": int(step)})
        return {"mode": "delta", "bytes": size, "rows": int(idx.numel())}

    def purge_ring_newer_than(self, best_step: int) -> None:
        """Delete every ring slot newer than ``best_step`` (the divergence
        guard's restore: a later --resume must not restore the collapse),
        and drop a delta base newer than it."""
        self.wait()
        for kind, path in self._slot_files():
            if kind == "best":
                continue
            try:
                step = int(self._header(kind, path)["step"])
            except CorruptCheckpointError:
                continue
            if step > best_step:
                for root in {self.dir, self.root}:
                    (root / path.name).unlink(missing_ok=True)
                    _sidecar(root / path.name).unlink(missing_ok=True)
        if self._base is not None and self._base["step"] > best_step:
            self._base = None
        self._last_ring = self.ring_step()

    # --- integrity ------------------------------------------------------

    def _quarantine(self, err: CorruptCheckpointError) -> None:
        """Rename the slot and its sidecar aside (``.quarantined``, numbered
        if taken); one ``fault`` record."""
        for root in {self.dir, self.root}:
            for p in (root / err.path.name, _sidecar(root / err.path.name)):
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
        if chaos_fire("ckpt.restore_raise", kind=CHAOS_KIND[kind],
                      step=-1 if step is None else int(step)) is not None:
            raise CorruptCheckpointError(kind, path, step, "injected restore fault (chaos)")
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
        self.wait()
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
        self.wait()
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

    def restore_best_with_extras(self, model, opt=None, lazy=None) -> tuple[int, dict]:
        """``restore_best``, and the slot's {"val_accuracy", "samplers"}."""
        payload = self._load("best", model, opt, lazy)
        return int(payload["step"]), {"val_accuracy": float(payload.get("val_accuracy", 0.0)),
                                      "samplers": payload.get("samplers", {})}

    def restore_latest(self, model, opt=None, lazy=None) -> tuple[int, dict]:
        """Load the newest intact slot in place, and take the directory over
        for the run that resumes it; returns (step, {"best_val",
        "samplers"})."""
        payload = self._load("latest", model, opt, lazy)
        self.written.update(s for s in SLOTS if self.has(s))
        self._last_ring = self.ring_step()
        return int(payload["step"]), {"best_val": float(payload.get("best_val", -1.0)),
                                      "samplers": payload.get("samplers", {})}
