"""Shape buckets for query batches, and the query graphs keyed by
(n_tier, bucket, resident dtype).

Counterpart of ``induction_network_on_fewrel_tpu/serving/buckets.py``. A
query batch is padded up to the smallest bucket that fits it, repeating
row 0 (a REAL row, so pad rows take the same numerical path as live
traffic; their outputs are dropped before verdicts). Fixed buckets, with
the N-tier padding of the class matrices (``serving/geometry.py``), keep
the set of shapes the card sees small and bounded.

``QueryGraphCache`` stands where ``QueryProgramCache`` stands in the JAX
package: one program per key (n_tier, bucket, resident dtype), made at
``warmup`` and counted (``compiles``; one made after warmup is a
steady-state recompile, ``stats.record_compile``). On the card a program
is one ``torch.cuda.CUDAGraph`` of ``InductionNetwork.score_queries`` per
parameter bank (``CapturedQuery``): K1 and K2 and the head's kernels
replay from static buffers: the query leaves [bucket, L], filled from
pinned host memory; the class matrix [n_tier, C] in the key's dtype; the
int8 scale as a 0-d f32 tensor; and the logits [bucket, n_tier(+1)],
copied out to pinned host memory. The snapshot's matrix is copied into
the static buffer before each replay, on the replay's stream, so
re-registering a class never invalidates a graph, just as the JAX
programs take the matrix as an argument. A graph bakes its parameters'
addresses, so the registry keeps two parameter banks and every key holds
one graph per bank: a publish writes the idle bank and flips the
snapshots to it (``serving/registry.py``), and no publish captures.

On the CPU a program is the eager ``score_queries`` of the bank's model
(``QueryRunner``, the plain versions of K1 and K2), which is the only
path the CPU tests drive; on the card ``QueryRunner`` is the graphs'
reference.

Capture rule: a graph is captured in ``thread_local`` mode (other threads
may keep using the card: the batcher's worker replays, registration
distils), after an eager warm-up on a side stream (the kernels' one-time
attribute calls, ``kernels/build.py:launch_on``, happen outside the
capture), and under the cache's lock. Captures happen in ``warmup``, in
the engine's tier-crossing and dtype-roll warm-ups, and, counted as a
steady-state recompile, on a miss.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from induction_network_on_fewrel_tpu_torch.obs.compile import notify_capture

# Powers of two up to 16 (the JAX package's default set).
DEFAULT_BUCKETS = (1, 2, 4, 8, 16)

# Wire dtypes of the query leaves: pos offsets fit int16, the mask int8,
# word ids (400k GloVe rows) stay int32.
QUERY_DTYPES = {
    "word": np.int32, "pos1": np.int16, "pos2": np.int16, "mask": np.int8,
}

# Resident class-matrix dtypes: part of the program key, since a graph is
# dtype-exact. int8 graphs also take the per-tenant f32 dequant scale.
RESIDENT_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
_DTYPE_NAMES = {v: k for k, v in RESIDENT_DTYPES.items()}
_NUMPY_NAMES = {np.dtype(np.float32): "f32", np.dtype(np.int8): "int8"}


def resident_dtype_name(dtype) -> str:
    """torch (or numpy) dtype of a resident class matrix -> its knob name."""
    name = _DTYPE_NAMES.get(dtype) if isinstance(dtype, torch.dtype) else _NUMPY_NAMES.get(
        np.dtype(dtype))
    if name is None:
        raise ValueError(
            f"class matrix dtype {dtype} is not a resident dtype "
            f"(expected one of {sorted(RESIDENT_DTYPES)})"
        )
    return name


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


def _as_matrix(class_mat, device) -> torch.Tensor:
    """A resident matrix (device tensor) or a host f32 stack (the parity
    probe's shadow) as a tensor on ``device``."""
    return torch.as_tensor(class_mat).to(device)


class QueryRunner:
    """Scores one padded query batch against one class matrix eagerly on
    the model's device: ``run(class_mat [N, C], query [bucket, L] leaves,
    scale)`` -> host logits [bucket, N(+1)]. The host copy synchronizes,
    so the call returns when the device is done. It is a key's program on
    the CPU (``make_program``); ``split`` is the host time of its last run
    as (copy in, run, wait), all counted as the run."""

    captured = False

    def __init__(self, model):
        self.model = model
        self.split = (0.0, 0.0, 0.0)

    def run(self, class_mat, query: dict[str, np.ndarray], scale=None) -> np.ndarray:
        t0 = time.perf_counter()
        dev = self.model.device
        with torch.inference_mode():
            q = {k: torch.as_tensor(v).to(dev)[None] for k, v in query.items()}
            mat = _as_matrix(class_mat, dev)
            logits = self.model.score_queries(mat[None], q, scale)[0].cpu().numpy()
        self.split = (0.0, time.perf_counter() - t0, 0.0)
        return logits


class CapturedQuery:
    """One key's CUDA graph on one bank's model, with its static buffers.

    ``run`` fills the pinned query buffers and enqueues their copies, the
    class matrix's copy and the scale's fill on the current stream,
    replays, copies the logits to pinned memory and waits for them;
    ``split`` is its host time: (copy in, replay call, wait for the
    logits)."""

    captured = True

    def __init__(self, model, n: int, c: int, bucket: int, max_length: int, dtype: str):
        dev = model.device
        self.host = {k: torch.empty((bucket, max_length), dtype=torch.from_numpy(
            np.zeros(0, dt)).dtype, pin_memory=True) for k, dt in QUERY_DTYPES.items()}
        self.dev = {k: torch.zeros_like(h, device=dev) for k, h in self.host.items()}
        self.mat = torch.zeros((n, c), dtype=RESIDENT_DTYPES[dtype], device=dev)
        self.scale = torch.ones((), dtype=torch.float32, device=dev) if dtype == "int8" else None
        self.done = torch.cuda.Event()
        self.split = (0.0, 0.0, 0.0)

        def score():
            q = {k: v[None] for k, v in self.dev.items()}
            return model.score_queries(self.mat[None], q, self.scale)[0]

        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.inference_mode():
            with torch.cuda.stream(side):
                score()
            side.synchronize()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self.out = score()
        self.out_host = torch.empty(self.out.shape, dtype=self.out.dtype, pin_memory=True)

    def run(self, class_mat, query: dict[str, np.ndarray], scale=None) -> np.ndarray:
        t0 = time.perf_counter()
        for k, h in self.host.items():
            h.numpy()[...] = query[k]
        for k, h in self.host.items():
            self.dev[k].copy_(h, non_blocking=True)
        self.mat.copy_(_as_matrix(class_mat, self.mat.device), non_blocking=True)
        if self.scale is not None:
            if scale is None:
                raise ValueError("int8 resident class matrix scored without its dequant scale")
            self.scale.fill_(float(scale))
        t1 = time.perf_counter()
        self.graph.replay()
        t2 = time.perf_counter()
        self.out_host.copy_(self.out, non_blocking=True)
        self.done.record()
        self.done.synchronize()
        out = self.out_host.numpy().copy()
        self.split = (t1 - t0, t2 - t1, time.perf_counter() - t2)
        return out


def make_program(model, n: int, c: int, bucket: int, max_length: int, dtype: str):
    """The default program of one key on one bank: a CUDA graph on the
    card, the eager scorer on the CPU."""
    if model.device.type == "cuda":
        return CapturedQuery(model, n, c, bucket, max_length, dtype)
    return QueryRunner(model)


class QueryGraphCache:
    """Query programs keyed by (n_classes, bucket, resident dtype), one
    program per parameter bank.

    ``banks`` are the registry's models (the same architecture, each with
    its own parameter tensors); ``run(bank, class_mat, query, scale)``
    executes the key's program of that bank, the dtype taken off the
    matrix itself. ``factory(model, n, c, bucket, L, dtype)`` makes one
    program (``make_program`` by default; the CPU tests pass a fake).
    ``compiles`` counts keys made, ``captures`` CUDA graphs captured (one
    per key and bank on the card, none on the CPU); each key's captures
    are reported to the capture watchers (``obs/compile.notify_capture``,
    ``fn="serve_query"``, shapes "n,bucket,dtype")."""

    def __init__(self, banks, stats=None, factory=make_program):
        self.banks = list(banks)
        self._stats = stats
        self._factory = factory
        self._exe: dict[tuple[int, int, str], list] = {}
        self._lock = threading.RLock()
        self.compiles = 0
        self.captures = 0
        self.in_warmup = False
        self.split = (0.0, 0.0, 0.0)

    def keys(self) -> list[tuple[int, int, str]]:
        return list(self._exe)

    def get(self, n_classes: int, class_dim: int, bucket: int, max_length: int,
            dtype: str = "f32") -> list:
        key = (n_classes, bucket, dtype)
        progs = self._exe.get(key)
        if progs is None:
            with self._lock:
                progs = self._exe.get(key)
                if progs is None:
                    t0 = time.monotonic()
                    progs = [self._factory(m, n_classes, class_dim, bucket, max_length, dtype)
                             for m in self.banks]
                    self._exe[key] = progs
                    self.compiles += 1
                    captured = sum(bool(p.captured) for p in progs)
                    self.captures += captured
                    if captured:
                        notify_capture("serve_query", f"{n_classes},{bucket},{dtype}",
                                       time.monotonic() - t0)
                    if self._stats is not None:
                        self._stats.record_compile(during_warmup=self.in_warmup)
        return progs

    def warmup(self, n_classes: int, class_dim: int, buckets: tuple[int, ...],
               max_length: int, dtypes: tuple[str, ...] = ("f32",)) -> int:
        """Make every bucket's program for one class count, one per
        resident dtype in ``dtypes``; returns the programs this call made."""
        with self._lock:
            before = self.compiles
            self.in_warmup = True
            try:
                for dt in dtypes:
                    for b in buckets:
                        self.get(n_classes, class_dim, b, max_length, dt)
            finally:
                self.in_warmup = False
            return self.compiles - before

    def run(self, bank: int, class_mat, query: dict[str, np.ndarray],
            scale=None) -> np.ndarray:
        """Execute bank ``bank``'s (n_classes, bucket, dtype) program; makes
        it on a miss (a steady-state recompile unless inside warmup). int8
        matrices require their per-tenant f32 ``scale``."""
        bucket, max_length = query["word"].shape
        n, c = class_mat.shape
        dtype = resident_dtype_name(class_mat.dtype)
        if dtype == "int8" and scale is None:
            raise ValueError("int8 resident class matrix scored without its dequant scale")
        prog = self.get(n, c, bucket, max_length, dtype)[bank]
        out = prog.run(class_mat, query, scale if dtype == "int8" else None)
        self.split = prog.split
        return out
