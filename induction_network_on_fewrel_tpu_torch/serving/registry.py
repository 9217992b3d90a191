"""Versioned multi-tenant class-vector registry: support sets -> resident
[N, C] class matrices on the model's device, published as immutable
copy-on-write snapshots.

The counterpart of ``induction_network_on_fewrel_tpu/serving/registry.py``
(``TenantRegistry``). The induction network distils a registered support
set ONCE through encoder + dynamic routing (``class_vectors``) into one [C]
vector per class; steady-state serving then never re-encodes supports.

* **Tenants** own their relation set and NOTA threshold; the data plane
  reads per-tenant ``Snapshot``s.
* **Copy-on-write snapshots**: every mutation (register, unregister,
  threshold, dtype, quarantine, publish) builds a NEW snapshot stamped
  with a registry-wide version; a batch holding one scores against exactly
  its (parameter bank, matrix, names, threshold).
* **Shared resident slot pool** keyed by (params_version, support-row
  digest): tenants registering the same support rows share one slot.
* **Quantized residency**: the resident matrix is f32, bf16
  (``torch.bfloat16``) or int8 with a per-tenant symmetric f32 scale
  (``quantize_int8``); quantized tenants keep their f32 stack on the host
  as the parity probe's shadow. A degenerate int8 artifact never becomes
  resident (``QuantArtifactError``).
* **N-tier geometry**: stacks pad with zero rows to their tier
  (``serving/geometry.py``) before any dtype conversion; a
  ``nota_head="stats"`` model serves exact-N.
* **Hot-swap publish on two parameter banks.** The query graphs
  (``serving/buckets.py``) bake their parameters' addresses, so the
  registry keeps two copies of the model, ``banks``: every snapshot names
  the bank it scores on. ``prepare_publish`` waits until no in-flight
  batch pins the idle bank (``pin``/``unpin``), loads the new weights into
  it in place, and re-distils every live slot with it; ``commit`` flips
  every snapshot to that bank in one block of plain assignments. In-flight
  batches finish on their pinned bank and the next batch scores on the new
  weights; nothing is captured. Under dp-sharded scoring
  (``shard_devices``) every bank also has a replica on each shard device
  (``shards[bank]``; shard 0 is the bank itself when it lives on the
  bank's device): a publish loads the idle bank's replicas too before the
  flip, and a pinned snapshot scores on one bank across all its shards. Non-finite weights, non-finite distilled
  vectors, a degenerate int8 artifact or a ``publish_canary`` veto refuse
  the publish (``PublishError``) and leave every snapshot as it was.

The distil runs outside the control-plane lock and its commit
re-validates ``params_version`` (a publish that raced re-plans the
registration). On the card the registry's device work runs on a stream
of its own and ends in a host synchronization, so the batcher's worker,
which replays graphs on its own stream, never waits on it. Support sets
are normalized to exactly K shots (cycle-pad when fewer arrive, truncate
when more). ``register_tokens`` registers already-tokenized rows (the
token cache's form: a position leaf may be a per-sentence offset, which is
expanded to per-token ids, so a class registered either way distils from
the same rows); ``register`` tokenizes raw instances and goes through it.

Every distil runs under a ``serve/distill`` span. Two fault points
(``obs/chaos.py``; the JAX ``registry.py:626-697``): ``publish.nan_params``
NaN-poisons the weights handed to a publish (the validation gate must
refuse it and roll back), and ``publish.distill_raise`` raises
``ChaosError`` inside a publish's re-distil (the rollback leaves every
tenant on its old snapshot).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import threading
from typing import Any

import numpy as np
import torch

from induction_network_on_fewrel_tpu_torch.config import RESIDENT_DTYPE_CHOICES
from induction_network_on_fewrel_tpu_torch.models.base import to_device
from induction_network_on_fewrel_tpu_torch.obs.chaos import ChaosError, chaos_fire
from induction_network_on_fewrel_tpu_torch.obs.spans import span
from induction_network_on_fewrel_tpu_torch.serving.buckets import QUERY_DTYPES, RESIDENT_DTYPES
from induction_network_on_fewrel_tpu_torch.serving.geometry import (
    pad_class_stack,
    supports_tiering,
    tier_for,
    tiers_spec,
)

DEFAULT_TENANT = "default"
# How long a publish waits for in-flight batches to release the idle bank.
BANK_WAIT_S = 60.0


class PublishError(RuntimeError):
    """A publish was refused or failed before its commit: the registry's
    generation is unchanged and every tenant serves its old snapshot."""


class QuantArtifactError(ValueError):
    """int8 quantization of a tenant's class matrix degenerated (a row
    collapsed to all-zero under the tenant scale, or a fully saturated
    row): a registration refuses, a publish rolls back, a re-quantization
    quarantines the tenant."""


def quantize_int8(stack: np.ndarray) -> tuple[np.ndarray, np.float32]:
    """[N, C] f32 host stack -> (int8 matrix, per-tenant symmetric f32
    scale = max-abs / 127). A copy of the JAX function."""
    amax = float(np.max(np.abs(stack))) if stack.size else 0.0
    scale = np.float32(amax / 127.0) if amax > 0.0 else np.float32(1.0)
    q = np.clip(np.rint(stack / scale), -127, 127).astype(np.int8)
    return q, scale


def quant_artifact(stack: np.ndarray, q: np.ndarray) -> str | None:
    """Why the int8 form ``q`` of ``stack`` is degenerate, or None: a class
    row that collapses to all-zero under the tenant-wide scale, or a row
    saturated at +-127 everywhere."""
    for i in range(q.shape[0]):
        if np.abs(q[i]).max() == 0 and np.abs(stack[i]).max() > 0.0:
            return (
                f"int8 dynamic-range collapse: class row {i} quantized to "
                f"all-zero under the tenant scale"
            )
        if np.abs(q[i]).min() >= 127:
            return f"int8 overflow: class row {i} fully saturated"
    return None


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One tenant's published serving state (immutable: holding it pins it)."""

    tenant: str
    version: int            # registry-wide monotonic publish counter
    params_version: int     # bumped by publish_params hot-swaps
    names: tuple[str, ...]
    slots: tuple[int, ...]  # slot-pool ids, parallel to names
    matrix: torch.Tensor    # [n_tier, C] resident matrix on the model's device
    bank: int               # the parameter bank (registry.banks) it scores on
    nota_threshold: float | None = None
    k: int = 5
    # Quarantined: the data plane answers degraded NOTA verdicts instead
    # of scoring against a suspect matrix.
    degraded: bool = False
    resident_dtype: str = "f32"
    scale: Any = None       # int8 dequant scale (np.float32), else None
    shadow: Any = None      # f32 host stack [n_tier, C] of a quantized tenant

    @property
    def n_classes(self) -> int:
        return len(self.names)

    @property
    def n_tier(self) -> int:
        """Row count of the resident matrix (the program key's class axis);
        the NOTA logit sits at ``row[-1]`` of every scored row."""
        return int(self.matrix.shape[0])

    def index_of(self, name: str) -> int:
        return self.names.index(name)


@dataclasses.dataclass
class _Slot:
    """One resident class vector and the K normalized support rows it was
    distilled from (a publish re-distils every live slot from them)."""

    vec: np.ndarray                      # [C] float32 host copy
    rows: list[dict[str, np.ndarray]]    # exactly K tokenized shots
    digest: str


class TenantRegistry:
    """Named support sets distilled to class vectors, resident on the
    model's device, versioned per tenant (see the module doc).

    ``model`` becomes bank 0, and a copy of it with its own parameter
    tensors bank 1; ``shard_devices`` gives each bank a replica per dp
    shard device (``shards``). The control plane mutates under one
    lock with the distils outside it; publishes serialize on
    ``_publish_serial``; ``snapshot`` is a lock-free read."""

    def __init__(self, model, tokenizer, k: int = 5, logger=None,
                 resident_dtype: str = "f32", tiers: tuple[int, ...] | None = None,
                 shard_devices=None):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if resident_dtype not in RESIDENT_DTYPE_CHOICES:
            raise ValueError(
                f"resident_dtype must be one of {RESIDENT_DTYPE_CHOICES}, "
                f"got {resident_dtype!r}"
            )
        self.banks = [model, copy.deepcopy(model)]
        self.shards = None
        if shard_devices:
            self.shards = [[bank if s == 0 and torch.device(d) == bank.device
                            else copy.deepcopy(bank).to(d) for s, d in enumerate(shard_devices)]
                           for bank in self.banks]
        self.active = 0
        self._tok, self.k = tokenizer, k
        self._logger = logger
        self._device = model.device
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self.tiers = tuple(tiers) if tiers else None
        if self.tiers is not None and not supports_tiering(model):
            if logger is not None:
                logger.log(
                    0, kind="serve", event="geometry_tiers_disabled",
                    reason="nota_head=stats reads class-axis statistics",
                    requested=tiers_spec(self.tiers),
                )
            self.tiers = None
        self.resident_dtype = resident_dtype
        self._tenant_dtype: dict[str, str] = {}
        self._lock = threading.Lock()
        self._publish_serial = threading.Lock()
        # In-flight batches per bank (pin/unpin); a publish waits for its
        # idle bank's count to reach 0 before overwriting that bank.
        self._bank_cv = threading.Condition()
        self._pins = [0, 0]
        # Optional pre-swap canary: callable(new_params) that raises to veto.
        self.publish_canary = None
        self.params_version = 0
        self._version = 0
        self._tenants: dict[str, Snapshot] = {}
        self._pool: dict[int, _Slot] = {}
        self._next_slot = 0
        self._by_digest: dict[tuple[int, str], int] = {}

    @property
    def model(self):
        """The bank the current snapshots score on."""
        return self.banks[self.active]

    def _replicas(self, bank: int) -> list:
        """Bank ``bank``'s shard replicas other than the bank itself."""
        if self.shards is None:
            return []
        return [m for m in self.shards[bank] if m is not self.banks[bank]]

    def _on_stream(self):
        """The registry's device work runs on its own stream on the card."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _sync(self) -> None:
        if self._stream is not None:
            self._stream.synchronize()

    # --- registration (control plane) ------------------------------------

    def _normalize_shots(self, rows: list[dict[str, np.ndarray]]):
        """Cycle-pad/truncate a ragged shot list to exactly K entries."""
        if not rows:
            raise ValueError("support set must contain at least one instance")
        return [rows[i % len(rows)] for i in range(self.k)]

    def _rows(self, instances) -> list[dict[str, np.ndarray]]:
        out = []
        for inst in instances:
            t = self._tok(inst)
            out.append({"word": t.word, "pos1": t.pos1, "pos2": t.pos2, "mask": t.mask})
        return out

    def register(self, name: str, instances, tenant: str = DEFAULT_TENANT) -> np.ndarray:
        """Register (or replace) one class from raw ``Instance``s; returns
        its distilled [C] class vector (host copy)."""
        return self.register_tokens(name, self._rows(instances), tenant=tenant)

    @staticmethod
    def _per_token(row: dict) -> dict:
        """A tokenized row with offset-form positions expanded (``off + l``)."""
        L = np.asarray(row["word"]).shape[-1]
        out = dict(row)
        for key in ("pos1", "pos2"):
            pos = np.asarray(row[key])
            if pos.ndim == 0:
                out[key] = int(pos) + np.arange(L, dtype=np.int32)
        return out

    def register_tokens(self, name: str, rows, tenant: str = DEFAULT_TENANT) -> np.ndarray:
        """Register (or replace) one class from already-tokenized [L]-leaf
        dicts (word, pos1, pos2, mask; a position leaf may be a scalar
        offset); returns its distilled [C] class vector (host copy)."""
        rows = self._normalize_shots([self._per_token(r) for r in rows])

        def commit(slots: list[int]) -> np.ndarray:
            slot = slots[0]
            snap = self._tenants.get(tenant)
            names = list(snap.names) if snap else []
            cur = list(snap.slots) if snap else []
            if name in names:
                cur[names.index(name)] = slot
            else:
                names.append(name)
                cur.append(slot)
            self._publish_locked(tenant, names, cur)
            return self._pool[slot].vec.copy()

        return self._intern_classes([rows], commit)

    def register_dataset(self, dataset, max_classes: int | None = None,
                         tenant: str = DEFAULT_TENANT) -> list[str]:
        """Register every relation of a FewRel dataset (support = its first
        K instances), all classes distilled in one call."""
        names = list(dataset.rel_names)
        if max_classes is not None:
            names = names[:max_classes]
        per_class = [
            self._normalize_shots(self._rows(dataset.instances[n][: self.k]))
            for n in names
        ]

        def commit(slots_new: list[int]) -> list[str]:
            snap = self._tenants.get(tenant)
            cur_names = list(snap.names) if snap else []
            cur_slots = list(snap.slots) if snap else []
            for name, slot in zip(names, slots_new):
                if name in cur_names:
                    cur_slots[cur_names.index(name)] = slot
                else:
                    cur_names.append(name)
                    cur_slots.append(slot)
            self._publish_locked(tenant, cur_names, cur_slots)
            return names

        return self._intern_classes(per_class, commit)

    def unregister(self, name: str, tenant: str = DEFAULT_TENANT) -> None:
        with self._lock:
            snap = self._require_locked(tenant)
            i = snap.names.index(name)
            names = [n for j, n in enumerate(snap.names) if j != i]
            slots = [s for j, s in enumerate(snap.slots) if j != i]
            if not names:
                self._drop_tenant_locked(tenant)
                return
            self._publish_locked(tenant, names, slots)

    def drop_tenant(self, tenant: str) -> None:
        with self._lock:
            self._require_locked(tenant)
            self._drop_tenant_locked(tenant)

    def clone_tenant(self, src: str, dst: str) -> Snapshot:
        """Zero-copy fork: ``dst`` starts from ``src``'s relation set,
        sharing its slots and its device matrix; an existing ``dst`` is
        replaced and its diverged slots are collected."""
        with self._lock:
            s = self._require_locked(src)
            replaced = self._tenants.get(dst)
            self._version += 1
            snap = dataclasses.replace(s, tenant=dst, version=self._version)
            self._tenants[dst] = snap
            if src in self._tenant_dtype:
                self._tenant_dtype[dst] = self._tenant_dtype[src]
            else:
                self._tenant_dtype.pop(dst, None)
            if replaced is not None and set(replaced.slots) - set(snap.slots):
                self._gc_slots_locked()
            return snap

    def quarantine_tenant(self, tenant: str, reason: str = "",
                          _degraded: bool = True) -> Snapshot:
        """Mark the tenant's snapshot degraded: the data plane serves
        open-set-floor NOTA verdicts flagged ``degraded=True`` until an
        unquarantine or the next committed publish. The matrix is kept."""
        with self._lock:
            s = self._require_locked(tenant)
            self._version += 1
            snap = dataclasses.replace(s, version=self._version, degraded=_degraded)
            self._tenants[tenant] = snap
        if self._logger is not None:
            self._logger.log(
                snap.version, kind="fault",
                action="tenant_quarantine" if _degraded else "tenant_restore",
                tenant=tenant, reason=reason or "operator",
            )
        return snap

    def unquarantine_tenant(self, tenant: str, reason: str = "") -> Snapshot:
        return self.quarantine_tenant(tenant, reason=reason, _degraded=False)

    def set_nota_threshold(self, threshold: float | None,
                           tenant: str = DEFAULT_TENANT) -> Snapshot:
        """Per-tenant NOTA verdict knob: with a trained NOTA head it biases
        the no-relation logit; without one it is an open-set floor on the
        best class logit. The new snapshot shares the parent's matrix."""
        with self._lock:
            s = self._require_locked(tenant)
            self._version += 1
            snap = dataclasses.replace(s, version=self._version, nota_threshold=threshold)
            self._tenants[tenant] = snap
            return snap

    # --- distill outside the lock ------------------------------------------

    _INTERN_RETRIES = 3

    def _distill(self, bank: int, per_class) -> np.ndarray:
        """[S][K] row dicts -> [S, C] f32 class vectors with bank ``bank``
        (one device call on the registry's stream)."""
        sup = self._stack_support(per_class)
        with span("serve/distill", classes=len(per_class)), torch.inference_mode(), \
                self._on_stream():
            vecs = self.banks[bank].class_vectors(to_device(sup, self._device))
            return vecs[0].float().cpu().numpy()

    def _intern_classes(self, per_class, commit):
        """Distil-or-reuse each class's K rows with the device pass outside
        the control-plane lock, then run ``commit(slots)`` under it. The
        commit re-validates ``params_version``: a publish that landed
        mid-distil sends the loop round again on the new weights."""
        digests = [self._digest(rows) for rows in per_class]
        for _ in range(self._INTERN_RETRIES):
            with self._lock:
                bank, pv = self.active, self.params_version
                missing = [
                    i for i, d in enumerate(digests)
                    if (pv, d) not in self._by_digest and i == digests.index(d)
                ]
            vecs = ()
            if missing:
                vecs = self._distill(bank, [per_class[i] for i in missing])
                if not np.isfinite(vecs).all():
                    raise ValueError(
                        "registration refused: distilled class vectors are non-finite "
                        "(corrupt weights or poisoned supports)"
                    )
            with self._lock:
                if self.params_version != pv:
                    continue
                for i, vec in zip(missing, vecs):
                    if (pv, digests[i]) in self._by_digest:
                        continue
                    slot = self._next_slot
                    self._next_slot += 1
                    self._pool[slot] = _Slot(vec=vec.astype(np.float32), rows=per_class[i],
                                             digest=digests[i])
                    self._by_digest[(pv, digests[i])] = slot
                if any((pv, d) not in self._by_digest for d in digests):
                    continue
                return commit([self._by_digest[(pv, d)] for d in digests])
        with self._lock:
            slots = self._intern_bulk_locked(per_class, self.active, self.params_version)
            return commit(slots)

    # --- hot-swap publish -------------------------------------------------

    def publish_params(self, new_params) -> int:
        """Atomic hot-swap to ``new_params`` (a state_dict of the model):
        prepare + commit. Returns the new params_version; raises
        ``PublishError`` with the registry unchanged on any failure before
        the commit."""
        txn = None
        try:
            txn = self.prepare_publish(new_params)
            return txn.commit()
        except BaseException as e:
            if txn is not None and txn.committed:
                raise
            version_before = txn.version_before if txn is not None else self.params_version
            if self._logger is not None:
                self._logger.log(
                    version_before, kind="fault", action="publish_rollback",
                    reason=f"{type(e).__name__}: {e}", params_version=float(version_before),
                )
            if isinstance(e, PublishError):
                raise
            raise PublishError(
                f"publish rolled back ({type(e).__name__}: {e}); "
                f"registry stays at params_version {version_before}"
            ) from e

    @staticmethod
    def _first_nonfinite(state_dict) -> str | None:
        """Name of the first floating tensor with a non-finite element."""
        for name, t in state_dict.items():
            t = torch.as_tensor(t)
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                return name
        return None

    def prepare_publish(self, new_params, target_version: int | None = None,
                        ) -> "PublishTransaction":
        """Phase 1: take the publish-serial lock (held until the
        transaction's ``commit()``/``abort()``), validate, load the weights
        into the idle bank once no in-flight batch pins it, re-distil every
        live slot with it and return the staged transaction. On any
        failure the lock is released and the live registry is untouched.
        ``target_version`` pins the generation the commit lands at."""
        self._publish_serial.acquire()
        try:
            if target_version is not None and target_version <= self.params_version:
                raise PublishError(
                    f"catch-up target_version {target_version} is not ahead of the "
                    f"local params_version {self.params_version}"
                )
            if chaos_fire("publish.nan_params", step=self.params_version) is not None:
                new_params = poison_state(new_params)
            staged = self._prepare_serialized(new_params, target_version)
        except BaseException:
            self._publish_serial.release()
            raise
        return PublishTransaction(self, staged)

    def _prepare_serialized(self, new_params, target_version: int | None = None) -> dict:
        bad = self._first_nonfinite(new_params)
        if bad is not None:
            raise PublishError(f"validation gate: non-finite params at {bad}")
        if self.publish_canary is not None:
            self.publish_canary(new_params)
        new_version = (int(target_version) if target_version is not None
                       else self.params_version + 1)
        idle = 1 - self.active
        # Current snapshots all score on the active bank (publishes
        # serialize), so new pins land there: only batches admitted before
        # the last commit can still hold the idle one.
        with self._bank_cv:
            if not self._bank_cv.wait_for(lambda: self._pins[idle] == 0, timeout=BANK_WAIT_S):
                raise PublishError(
                    f"in-flight batches still pin parameter bank {idle} after {BANK_WAIT_S} s"
                )
        with torch.no_grad(), self._on_stream():
            self.banks[idle].load_state_dict(new_params)
            for replica in self._replicas(idle):
                replica.load_state_dict(new_params)
        self._sync()
        for replica in self._replicas(idle):
            if replica.device.type == "cuda" and replica.device != self._device:
                torch.cuda.synchronize(replica.device)
        vec_of: dict[int, np.ndarray] = {}
        for _pass in range(self._INTERN_RETRIES):
            with self._lock:
                live = sorted({s for snap in self._tenants.values() for s in snap.slots})
                todo = [s for s in live if s not in vec_of]
                rows_of = {s: self._pool[s].rows for s in todo}
            if not todo:
                break
            if chaos_fire("publish.distill_raise", step=new_version) is not None:
                raise ChaosError("injected distill failure mid-publish (chaos)")
            vecs = self._distill(idle, [rows_of[s] for s in todo])
            for s, vec in zip(todo, vecs):
                vec_of[s] = vec.astype(np.float32)
        return {"bank": idle, "new_version": new_version, "vec_of": vec_of}

    def _commit_prepared(self, staged: dict) -> int:
        bank, new_version, vec_of = staged["bank"], staged["new_version"], staged["vec_of"]
        with self._lock:
            # Build, then commit: registry state changes only in the block
            # of plain assignments at the end.
            current = {s for snap in self._tenants.values() for s in snap.slots}
            for s in sorted(current - set(vec_of)):
                vec_of[s] = self._distill(bank, [self._pool[s].rows])[0].astype(np.float32)
            for s in sorted(current):
                if not np.isfinite(vec_of[s]).all():
                    raise PublishError(
                        f"validation gate: non-finite distilled class vector for slot {s} "
                        f"(digest {self._pool[s].digest[:12]})"
                    )
            staged_pool: dict[int, _Slot] = {}
            live_map: dict[int, int] = {}
            by_digest_new: dict[str, int] = {}
            next_slot = self._next_slot
            for s in sorted(current):
                digest = self._pool[s].digest
                if digest in by_digest_new:
                    live_map[s] = by_digest_new[digest]
                    continue
                slot = next_slot
                next_slot += 1
                staged_pool[slot] = _Slot(vec=vec_of[s], rows=self._pool[s].rows, digest=digest)
                by_digest_new[digest] = slot
                live_map[s] = slot
            version = self._version
            staged_snaps: dict[str, Snapshot] = {}
            for tenant, snap in self._tenants.items():
                stack = np.stack([staged_pool[live_map[s]].vec for s in snap.slots])
                try:
                    matrix, scale, shadow = self._residency(stack, tenant)
                except QuantArtifactError as e:
                    raise PublishError(f"validation gate: {e}") from e
                version += 1
                staged_snaps[tenant] = Snapshot(
                    tenant=tenant, version=version, params_version=new_version,
                    names=snap.names, slots=tuple(live_map[s] for s in snap.slots),
                    matrix=matrix, bank=bank, nota_threshold=snap.nota_threshold, k=self.k,
                    resident_dtype=self.dtype_for(tenant), scale=scale, shadow=shadow,
                )
            # COMMIT: plain assignments only.
            self._pool.update(staged_pool)
            for digest, slot in by_digest_new.items():
                self._by_digest[(new_version, digest)] = slot
            self._next_slot = next_slot
            self.active = bank
            self.params_version = new_version
            self._tenants.update(staged_snaps)
            self._version = version
            self._gc_slots_locked()
            n_tenants, n_slots = len(self._tenants), len(live_map)
        if self._logger is not None:
            self._logger.log(
                new_version, kind="serve", event="snapshot_swap",
                params_version=new_version, tenants=n_tenants, slots=n_slots,
            )
        return new_version

    def publish_checkpoint(self, ckpt_dir: str) -> int:
        """Hot-swap from a checkpoint directory: its best weights (else its
        latest), published through ``publish_params``."""
        return self.publish_params(load_params(ckpt_dir))

    # --- data plane (lock-free) ------------------------------------------

    def snapshot(self, tenant: str = DEFAULT_TENANT) -> Snapshot:
        snap = self._tenants.get(tenant)
        if snap is None:
            raise ValueError(
                f"no classes registered for tenant {tenant!r} — register supports first"
            )
        return snap

    def pin(self, tenant: str = DEFAULT_TENANT) -> Snapshot:
        """The tenant's current snapshot, its bank counted as in use until
        ``unpin``: a publish does not overwrite a bank a batch scores on."""
        with self._bank_cv:
            snap = self.snapshot(tenant)
            self._pins[snap.bank] += 1
            return snap

    def unpin(self, snap: Snapshot) -> None:
        with self._bank_cv:
            self._pins[snap.bank] -= 1
            self._bank_cv.notify_all()

    def has_tenant(self, tenant: str = DEFAULT_TENANT) -> bool:
        return tenant in self._tenants

    def tenants(self) -> tuple[str, ...]:
        return tuple(self._tenants)

    @property
    def names(self) -> tuple[str, ...]:
        snap = self._tenants.get(DEFAULT_TENANT)
        return snap.names if snap else ()

    def names_for(self, tenant: str) -> tuple[str, ...]:
        return self.snapshot(tenant).names

    def __len__(self) -> int:
        snap = self._tenants.get(DEFAULT_TENANT)
        return len(snap.names) if snap else 0

    def class_matrix(self, tenant: str = DEFAULT_TENANT) -> torch.Tensor:
        return self.snapshot(tenant).matrix

    def pool_size(self) -> int:
        return len(self._pool)

    # --- quantized residency ------------------------------------------------

    def dtype_for(self, tenant: str) -> str:
        return self._tenant_dtype.get(tenant, self.resident_dtype)

    def set_resident_dtype(self, tenant: str, dtype: str) -> Snapshot:
        """Re-quantize a live tenant to ``dtype`` from the f32 slot pool and
        republish (no re-distil). A degenerate int8 artifact reverts the
        override, quarantines the tenant and raises QuantArtifactError."""
        if dtype not in RESIDENT_DTYPE_CHOICES:
            raise ValueError(
                f"resident_dtype must be one of {RESIDENT_DTYPE_CHOICES}, got {dtype!r}"
            )
        artifact = None
        with self._lock:
            snap = self._require_locked(tenant)
            prev = self._tenant_dtype.get(tenant)
            self._tenant_dtype[tenant] = dtype
            try:
                snap = self._publish_locked(tenant, list(snap.names), list(snap.slots), gc=False)
            except QuantArtifactError as e:
                if prev is None:
                    self._tenant_dtype.pop(tenant, None)
                else:
                    self._tenant_dtype[tenant] = prev
                artifact = e
        if artifact is not None:
            self.quarantine_tenant(tenant, reason=str(artifact))
            raise artifact
        if self._logger is not None:
            self._logger.log(snap.version, kind="serve", event="resident_dtype",
                             tenant=tenant, dtype=dtype)
        return snap

    def resident_bytes(self) -> dict[str, float]:
        """Per-tenant device-resident bytes of the published snapshot: the
        [n_tier, C] matrix in its resident dtype plus the f32 scale (host
        copies excluded)."""
        out: dict[str, float] = {}
        for tenant, snap in list(self._tenants.items()):
            nbytes = snap.matrix.element_size() * snap.matrix.numel()
            if snap.scale is not None:
                nbytes += 4
            out[tenant] = float(nbytes)
        return out

    # --- internals (call with the lock held) ------------------------------

    def _require_locked(self, tenant: str) -> Snapshot:
        snap = self._tenants.get(tenant)
        if snap is None:
            raise ValueError(f"unknown tenant {tenant!r}")
        return snap

    def _drop_tenant_locked(self, tenant: str) -> None:
        del self._tenants[tenant]
        self._tenant_dtype.pop(tenant, None)
        self._gc_slots_locked()

    def tier_of(self, n: int) -> int:
        """The tier ``n`` class rows pad to here (``n`` itself when tiering
        is off or ``n`` overflows the ladder)."""
        return tier_for(n, self.tiers)

    def _residency(self, stack: np.ndarray, tenant: str):
        """The resident form of a stacked [N, C] f32 class matrix: padded to
        its tier with zero rows, then put on the device in the tenant's
        dtype. Returns (matrix, scale, shadow)."""
        tier = self.tier_of(stack.shape[0])
        if tier != stack.shape[0]:
            stack = pad_class_stack(stack, tier)
        dtype = self.dtype_for(tenant)
        scale = shadow = None
        if dtype == "int8":
            q, scale = quantize_int8(stack)
            reason = quant_artifact(stack, q)
            if reason is not None:
                raise QuantArtifactError(
                    f"registration refused: {reason} (tenant {tenant!r}; "
                    f"degenerate quantization must never become resident)"
                )
            host = torch.from_numpy(q)
        else:
            host = torch.from_numpy(np.ascontiguousarray(stack, np.float32)).to(
                RESIDENT_DTYPES[dtype])
        if dtype != "f32":
            shadow = stack
        with self._on_stream():
            matrix = host.to(self._device)
        self._sync()
        return matrix, scale, shadow

    def _publish_locked(self, tenant: str, names: list[str], slots: list[int],
                        nota_threshold: float | None = "inherit", gc: bool = True) -> Snapshot:
        prev = self._tenants.get(tenant)
        if nota_threshold == "inherit":
            nota_threshold = prev.nota_threshold if prev else None
        self._version += 1
        matrix, scale, shadow = self._residency(
            np.stack([self._pool[s].vec for s in slots]), tenant
        )
        snap = Snapshot(
            tenant=tenant, version=self._version, params_version=self.params_version,
            names=tuple(names), slots=tuple(slots), matrix=matrix, bank=self.active,
            nota_threshold=nota_threshold, k=self.k,
            degraded=prev.degraded if prev else False,
            resident_dtype=self.dtype_for(tenant), scale=scale, shadow=shadow,
        )
        self._tenants[tenant] = snap
        if gc and prev is not None and set(prev.slots) - set(slots):
            self._gc_slots_locked()
        return snap

    def _gc_slots_locked(self) -> None:
        """Drop pool slots no current snapshot references."""
        live = {s for snap in self._tenants.values() for s in snap.slots}
        dead = {s for s in self._pool if s not in live}
        for slot in dead:
            del self._pool[slot]
        if dead:
            for key in [k for k, v in self._by_digest.items() if v in dead]:
                del self._by_digest[key]

    def _digest(self, rows: list[dict[str, np.ndarray]]) -> str:
        h = hashlib.sha1()
        for row in rows:
            for key in sorted(QUERY_DTYPES):
                h.update(key.encode())
                h.update(np.ascontiguousarray(row[key]).tobytes())
        return h.hexdigest()

    def _intern_bulk_locked(self, per_class, bank: int, params_version: int) -> list[int]:
        """Distil-or-reuse each class's K rows under the lock (the escape
        hatch when registrations and publishes churn faster than a distil)."""
        digests = [self._digest(rows) for rows in per_class]
        out = [self._by_digest.get((params_version, d)) for d in digests]
        missing = [i for i, (s, d) in enumerate(zip(out, digests))
                   if s is None and i == digests.index(d)]
        if missing:
            vecs = self._distill(bank, [per_class[i] for i in missing])
            if not np.isfinite(vecs).all():
                raise ValueError(
                    "registration refused: distilled class vectors are non-finite "
                    "(corrupt weights or poisoned supports)"
                )
            for i, vec in zip(missing, vecs):
                slot = self._next_slot
                self._next_slot += 1
                self._pool[slot] = _Slot(vec=vec.astype(np.float32), rows=per_class[i],
                                         digest=digests[i])
                self._by_digest[(params_version, digests[i])] = slot
            out = [self._by_digest[(params_version, d)] for d in digests]
        return out

    @staticmethod
    def _stack_support(per_class) -> dict[str, np.ndarray]:
        """[N][K] row dicts -> one [1, N, K, L] support dict in wire dtypes."""
        return {
            key: np.asarray(
                [[np.asarray(row[key]) for row in shots] for shots in per_class], dtype=dt
            )[None]
            for key, dt in QUERY_DTYPES.items()
        }


class PublishTransaction:
    """A prepared publish: validated, the idle bank loaded and every live
    slot re-distilled, the publish-serial lock held. Exactly one of
    ``commit()`` or ``abort()`` follows, from any thread; either releases
    the lock once. An aborted transaction leaves the idle bank holding
    weights no snapshot scores on."""

    __slots__ = ("_registry", "_staged", "version_before", "_done", "committed")

    def __init__(self, registry: TenantRegistry, staged: dict):
        self._registry = registry
        self._staged = staged
        self.version_before = registry.params_version
        self._done = False
        self.committed = False

    @property
    def new_version(self) -> int:
        return self._staged["new_version"]

    def commit(self) -> int:
        if self._done:
            raise RuntimeError("publish transaction already finished")
        try:
            version = self._registry._commit_prepared(self._staged)
            self.committed = True
            return version
        except BaseException:
            if self._registry.params_version == self._staged["new_version"]:
                self.committed = True
            raise
        finally:
            self._done = True
            self._registry._publish_serial.release()

    def abort(self) -> None:
        if self._done:
            return
        self._done = True
        self._registry._publish_serial.release()


def poison_state(state_dict) -> dict:
    """NaN-poison the floating tensors of a state_dict and negate the
    integer ones (minus one), shapes and dtypes kept: the
    ``publish.nan_params`` fault."""
    def bad(t):
        t = torch.as_tensor(t)
        if t.is_floating_point():
            return torch.full_like(t, float("nan"))
        return -t - 1 if not t.dtype == torch.bool else t

    return {k: bad(v) for k, v in state_dict.items()}


def load_params(ckpt_dir: str) -> dict[str, torch.Tensor]:
    """The state_dict of a port checkpoint directory: its best slot,
    falling back to its latest (``train/checkpoint.py``)."""
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager

    mngr = CheckpointManager(ckpt_dir)
    try:
        return mngr.params("best")
    except FileNotFoundError:
        return mngr.params("latest")


# Single-tenant spelling of the same object, as in the JAX package.
ClassVectorRegistry = TenantRegistry
