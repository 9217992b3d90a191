"""Multi-tenant class-vector registry: support sets -> resident [N, C] class
vectors, published as immutable versioned snapshots.

The synchronous core of ``induction_network_on_fewrel_tpu/serving/registry.py``
(``TenantRegistry``). The induction network distils a registered support
set ONCE through encoder + dynamic routing (``class_vectors``) into one [C]
vector per class; steady-state serving then never re-encodes supports.
Every tenant owns its relation set and NOTA threshold; every change
publishes a new immutable ``Snapshot`` (names, the f32 class matrix on the
model's device, the threshold, a registry-wide version), so a batch that
holds a snapshot scores against exactly that state.

Support sets are normalized to exactly K shots (cycle-pad when fewer
arrive, truncate when more), and all classes of one registration distil in
one [1, N, K] call. A non-finite class vector is refused. Registration
uses per-token position ids (the JAX registry's compact offset form is a
training-cache detail; both give the same class vectors).

Waiting for later slices: the shared slot pool and its digest cache,
hot-swap publish and its transaction, quarantine, bf16/int8 residency and
the N-tier geometry padding.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from induction_network_on_fewrel_tpu_torch.models.base import to_device
from induction_network_on_fewrel_tpu_torch.serving.buckets import QUERY_DTYPES

DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One tenant's published serving state (immutable)."""

    tenant: str
    version: int
    names: tuple[str, ...]
    matrix: torch.Tensor            # [N, C] float32 on the model's device
    nota_threshold: float | None = None
    k: int = 5


class TenantRegistry:
    def __init__(self, model, tokenizer, k: int = 5):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self._model, self._tok, self.k = model, tokenizer, k
        self._version = 0
        self._tenants: dict[str, Snapshot] = {}
        self._vectors: dict[str, dict[str, np.ndarray]] = {}   # tenant -> name -> [C]

    # --- registration -----------------------------------------------------

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
        vec = self._distill([self._normalize_shots(self._rows(instances))])[0]
        self._commit(tenant, {name: vec})
        return vec.copy()

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
        vecs = self._distill(per_class)
        self._commit(tenant, dict(zip(names, vecs)))
        return names

    def _distill(self, per_class: list[list[dict[str, np.ndarray]]]) -> np.ndarray:
        """[S][K] row dicts -> [S, C] f32 class vectors (one device call)."""
        sup = {
            key: np.asarray(
                [[np.asarray(row[key]) for row in shots] for shots in per_class],
                dtype=dt,
            )[None]
            for key, dt in QUERY_DTYPES.items()
        }
        with torch.inference_mode():
            vecs = self._model.class_vectors(to_device(sup, self._model.device))
            vecs = vecs[0].float().cpu().numpy()
        if not np.isfinite(vecs).all():
            raise ValueError(
                "registration refused: distilled class vectors are non-finite "
                "(corrupt weights or poisoned supports)"
            )
        return vecs

    def _commit(self, tenant: str, new: dict[str, np.ndarray]) -> Snapshot:
        vecs = dict(self._vectors.get(tenant, {}))
        vecs.update(new)                     # replaced classes keep their slot
        prev = self._tenants.get(tenant)
        return self._publish(tenant, vecs, prev.nota_threshold if prev else None)

    def _publish(self, tenant, vecs: dict[str, np.ndarray], threshold) -> Snapshot:
        names = tuple(vecs)
        matrix = torch.from_numpy(np.stack([vecs[n] for n in names]).astype(np.float32))
        self._version += 1
        snap = Snapshot(
            tenant=tenant, version=self._version, names=names,
            matrix=matrix.to(self._model.device), nota_threshold=threshold, k=self.k,
        )
        self._vectors[tenant] = vecs
        self._tenants[tenant] = snap
        return snap

    def set_nota_threshold(self, threshold: float | None,
                           tenant: str = DEFAULT_TENANT) -> Snapshot:
        """Per-tenant NOTA verdict knob: with a trained NOTA head it biases
        the no-relation logit; without one it is an open-set floor on the
        best class logit."""
        snap = self.snapshot(tenant)
        self._version += 1
        snap = dataclasses.replace(snap, version=self._version, nota_threshold=threshold)
        self._tenants[tenant] = snap
        return snap

    # --- data plane -------------------------------------------------------

    def snapshot(self, tenant: str = DEFAULT_TENANT) -> Snapshot:
        snap = self._tenants.get(tenant)
        if snap is None:
            raise ValueError(
                f"no classes registered for tenant {tenant!r} — register "
                "supports first"
            )
        return snap

    @property
    def names(self) -> tuple[str, ...]:
        snap = self._tenants.get(DEFAULT_TENANT)
        return snap.names if snap else ()
