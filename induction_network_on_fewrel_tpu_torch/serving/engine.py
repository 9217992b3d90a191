"""InferenceEngine: the synchronous serving core.

Counterpart of ``induction_network_on_fewrel_tpu/serving/engine.py``
(``InferenceEngine``) without its threads: a ``TenantRegistry`` holds each
tenant's distilled class matrix, and ``classify_batch`` tokenizes the
queries, pads each batch of up to ``max(buckets)`` rows to its bucket,
scores it with one eager ``score_queries`` call on the device and turns
every live logits row into a verdict (``_verdict``, a copy of the JAX
engine's, including its quality features). The continuous batcher,
deadlines, SLOs, drift, breaker, quantized and tiered residency and
hot-swap publish come with later slices.

Device rule: ``device=None`` means "cuda" and raises without CUDA; the
model must already live on that device.
"""

from __future__ import annotations

import time

import numpy as np

from induction_network_on_fewrel_tpu_torch.data.fewrel import Instance
from induction_network_on_fewrel_tpu_torch.models.build import resolve_device
from induction_network_on_fewrel_tpu_torch.serving.buckets import (
    DEFAULT_BUCKETS,
    QueryRunner,
    select_bucket,
    stack_queries,
)
from induction_network_on_fewrel_tpu_torch.serving.registry import (
    DEFAULT_TENANT,
    TenantRegistry,
)

NO_RELATION = "no_relation"


def quality_features(scores):
    """(top-1 margin, softmax entropy) of class-score rows: a copy of
    ``induction_network_on_fewrel_tpu/obs/drift.quality_features``.
    ``scores``: numpy [..., n] class scores (the NOTA logit excluded).
    Returns float64 arrays; margin is 0 for n < 2."""
    s = np.asarray(scores, dtype=np.float64)
    n = s.shape[-1]
    if n >= 2:
        top2 = np.partition(s, -2, axis=-1)[..., -2:]
        margin = top2[..., 1] - top2[..., 0]
    else:
        margin = np.zeros(s.shape[:-1])
    z = s - s.max(axis=-1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=-1, keepdims=True)
    entropy = -(p * np.log(np.maximum(p, 1e-12))).sum(axis=-1)
    return margin, entropy


class InferenceEngine:
    def __init__(self, model, cfg, tokenizer, k: int | None = None,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS, device=None):
        if cfg.model != "induction":
            raise ValueError(
                f"class-vector serving requires --model induction; got {cfg.model!r}"
            )
        dev = resolve_device(device)
        if model.device.type != dev.type or dev.index not in (None, model.device.index):
            raise ValueError(f"model lives on {model.device}, engine asked for {dev}")
        self.cfg = cfg
        self.model = model
        self.tokenizer = tokenizer
        self.nota = cfg.na_rate > 0
        self.buckets = tuple(sorted(buckets))
        self.registry = TenantRegistry(model, tokenizer, k=k if k is not None else cfg.k)
        self.runner = QueryRunner(model)
        self.served = 0
        self.batches = 0

    # --- registration -----------------------------------------------------

    def register_class(self, name: str, instances, tenant: str = DEFAULT_TENANT):
        return self.registry.register(name, instances, tenant=tenant)

    def register_dataset(self, dataset, max_classes: int | None = None,
                         tenant: str = DEFAULT_TENANT) -> list[str]:
        return self.registry.register_dataset(dataset, max_classes=max_classes, tenant=tenant)

    def set_nota_threshold(self, threshold: float | None, tenant: str = DEFAULT_TENANT):
        return self.registry.set_nota_threshold(threshold, tenant=tenant)

    @property
    def class_names(self) -> tuple[str, ...]:
        return self.registry.names

    # --- query path -------------------------------------------------------

    def classify(self, instance, tenant: str = DEFAULT_TENANT) -> dict:
        return self.classify_batch([instance], tenant=tenant)[0]

    def classify_batch(self, instances, tenant: str = DEFAULT_TENANT) -> list[dict]:
        """Verdicts for ``instances`` under ``tenant``'s current snapshot,
        scored in batches of at most ``max(buckets)`` rows, each padded to
        its bucket. ``latency_ms`` is the wall time of the request's batch:
        tokenize, pack, score (ending in the device-to-host copy), verdicts."""
        snap = self.registry.snapshot(tenant)
        cap = self.buckets[-1]
        instances = list(instances)
        verdicts: list[dict] = []
        for start in range(0, len(instances), cap):
            t0 = time.monotonic()
            chunk = instances[start:start + cap]
            queries = []
            for inst in chunk:
                t = self.tokenizer(self._as_instance(inst))
                queries.append({"word": t.word, "pos1": t.pos1, "pos2": t.pos2, "mask": t.mask})
            bucket = select_bucket(len(chunk), self.buckets)
            logits = self.runner.run(snap.matrix, stack_queries(queries, bucket))
            batch = [self._verdict(row, snap) for row in logits[: len(chunk)]]
            ms = round((time.monotonic() - t0) * 1e3, 3)
            for v in batch:
                v["latency_ms"] = ms
                v["bucket"] = bucket
            verdicts.extend(batch)
            self.served += len(chunk)
            self.batches += 1
        return verdicts

    def _verdict(self, row: np.ndarray, snap) -> dict:
        """One logits row -> verdict dict under the tenant's NOTA policy.

        With a trained NOTA head the snapshot threshold BIASES the
        no-relation logit (0.0 = the head's own calibration); without one,
        a set threshold is an open-set floor on the best class logit. Ties
        resolve toward the class."""
        names = snap.names
        n = len(names)
        best = int(np.argmax(row[:n]))
        thr = snap.nota_threshold
        if self.nota:
            is_nota = float(row[-1]) + (thr or 0.0) > float(row[best])
        else:
            is_nota = thr is not None and float(row[best]) < thr
        m_arr, e_arr = quality_features(row[:n])
        margin, entropy = float(m_arr), float(e_arr)
        verdict = {
            "label": NO_RELATION if is_nota else names[best],
            "class_index": -1 if is_nota else best,
            "nota": is_nota,
            "margin": round(margin, 6),
            "entropy": round(entropy, 6),
            "tenant": snap.tenant,
            "snapshot_version": snap.version,
            "logits": {nm: float(row[i]) for i, nm in enumerate(names)},
        }
        if self.nota:
            verdict["logits"][NO_RELATION] = float(row[-1])
        return verdict

    @staticmethod
    def _as_instance(x):
        if isinstance(x, Instance):
            return x
        if isinstance(x, dict):
            if "h" in x:                       # raw FewRel JSON schema
                return Instance.from_raw(x)
            return Instance(
                tokens=tuple(x["tokens"]),
                head_pos=tuple(x.get("head_pos", (0,))),
                tail_pos=tuple(x.get("tail_pos", (0,))),
            )
        raise TypeError(f"cannot interpret query of type {type(x).__name__}")
