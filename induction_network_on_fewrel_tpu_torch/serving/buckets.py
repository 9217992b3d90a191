"""Shape buckets for query batches, and the eager query runner.

Counterpart of ``induction_network_on_fewrel_tpu/serving/buckets.py``. A
query batch is padded up to the smallest bucket that fits it, repeating
row 0 (a REAL row, so pad rows take the same numerical path as live
traffic; their outputs are dropped before verdicts). Fixed buckets keep the
set of shapes the device sees small; here they are the shapes a later
CUDA-graph capture will key on.

``QueryRunner`` stands where ``QueryProgramCache`` stands in the JAX
package: it calls ``InductionNetwork.score_queries`` eagerly under
``torch.inference_mode()``. Capturing one CUDA graph per (n_classes,
bucket) is the later step that removes the per-call launch overhead.
"""

from __future__ import annotations

import numpy as np
import torch

# Powers of two up to 16 (the JAX package's default set).
DEFAULT_BUCKETS = (1, 2, 4, 8, 16)

# Wire dtypes of the query leaves: pos offsets fit int16, the mask int8,
# word ids (400k GloVe rows) stay int32.
QUERY_DTYPES = {
    "word": np.int32, "pos1": np.int16, "pos2": np.int16, "mask": np.int8,
}


def zero_batch(max_length: int, lead: tuple[int, ...]) -> dict[str, np.ndarray]:
    """All-zeros token batch with leading shape ``lead`` in the wire dtypes."""
    return {
        k: np.zeros(lead + (max_length,), dt) for k, dt in QUERY_DTYPES.items()
    }


def select_bucket(n: int, buckets: tuple[int, ...] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket that fits ``n`` rows."""
    if n <= 0:
        raise ValueError(f"bucket request for {n} rows")
    for b in sorted(buckets):
        if n <= b:
            return b
    raise ValueError(f"{n} rows exceed the largest bucket {max(buckets)}")


def pad_rows(arr: np.ndarray, bucket: int) -> np.ndarray:
    """Pad axis 0 with repeats of row 0 up to ``bucket`` rows."""
    n = arr.shape[0]
    if n == bucket:
        return arr
    pad = np.broadcast_to(arr[:1], (bucket - n,) + arr.shape[1:])
    return np.concatenate([arr, pad], axis=0)


def stack_queries(
    queries: list[dict[str, np.ndarray]], bucket: int
) -> dict[str, np.ndarray]:
    """[L]-leaf query dicts -> one padded [bucket, L] dict in wire dtypes."""
    out = {}
    for k, dt in QUERY_DTYPES.items():
        out[k] = pad_rows(
            np.stack([np.asarray(q[k]) for q in queries]).astype(dt), bucket
        )
    return out


class QueryRunner:
    """Scores one padded query batch against one class matrix on the
    model's device: ``run(class_mat [N, C], query [bucket, L] leaves)`` ->
    host logits [bucket, N(+1)]. The host copy synchronizes, so the call
    returns when the device is done."""

    def __init__(self, model):
        self.model = model

    def run(self, class_mat: torch.Tensor, query: dict[str, np.ndarray],
            scale=None) -> np.ndarray:
        dev = self.model.device
        with torch.inference_mode():
            q = {k: torch.as_tensor(v).to(dev)[None] for k, v in query.items()}
            logits = self.model.score_queries(class_mat[None], q, scale)
            return logits[0].cpu().numpy()
