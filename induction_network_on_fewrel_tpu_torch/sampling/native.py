"""The C++ episode samplers over ctypes, and the sampler factories.

The port's counterpart of ``induction_network_on_fewrel_tpu/native/
{lib,sampler}.py``, over its own copy of the source,
``csrc/episode_sampler.cpp``, built with g++ at first use into
``build/torch_kernels/`` (``kernels/build.py:HostLibrary``). Every C call
releases the GIL (ctypes), so a sampler drawing on the feed's producer
thread does not hold up the trainer's thread.

* ``NativeEpisodeSampler``: token batches (``EpisodeBatch``). Direct mode
  fills each batch in one C call; with ``prefetch`` > 0 a C++ ring of that
  many batches is kept full by ``num_threads`` worker threads.
  ``sample_fused(S)`` fills S batches into one [S, B, ...] block per field
  (S C calls), the layout an S-step graph takes.
* ``NativeIndexSampler``: index batches (``IndexEpisodeBatch``) for the
  token cache; ``sample_fused(S)`` fills an [S, B, ...] block in one call.

Batch i is a pure function of (seed, i), so the stream is the same for
any thread count, and the cursor protocol (``feed_state`` /
``restore_feed_state``, ``{"kind": "native", "next": i}``) is the next
sequence number. The episodes have the numpy samplers' statistics but
another random stream. ``close()`` destroys the ring and the handle.

``make_sampler`` / ``make_index_sampler`` choose the backend: "native",
"python" (the numpy samplers), or "auto": native for a training stream,
python for an evaluation stream (``eval=True``), as the JAX CLI pins
them. Under "auto" a library that fails to build raises and names
``--sampler python``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from induction_network_on_fewrel_tpu_torch.sampling.episodes import (
    EpisodeBatch,
    EpisodeSampler,
    check_episode_feasibility,
)
from induction_network_on_fewrel_tpu_torch.sampling.index import (
    IndexEpisodeBatch,
    IndexEpisodeSampler,
    check_sampler_backend,
)

_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)
_BATCH_ARGS = [ctypes.c_void_p] + [_I32P, _I32P, _I32P, _F32P] * 2 + [_I32P]
# C function -> (restype, argtypes) of csrc/episode_sampler.cpp's C ABI.
_SIGNATURES = {
    "inf_sampler_create": (ctypes.c_void_p, [_I32P, _I32P, _I32P, _F32P, _I64P, ctypes.c_int64,
                                             ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                                             ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                                             ctypes.c_uint64]),
    "inf_sampler_destroy": (None, [ctypes.c_void_p]),
    "inf_sampler_sample": (None, _BATCH_ARGS),
    "inf_sampler_sample_indices": (None, [ctypes.c_void_p, ctypes.c_int64, _I32P, _I32P, _I32P]),
    "inf_sampler_get_next": (ctypes.c_int64, [ctypes.c_void_p]),
    "inf_sampler_set_next": (None, [ctypes.c_void_p, ctypes.c_int64]),
    "inf_pipeline_create": (ctypes.c_void_p, [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]),
    "inf_pipeline_create_at": (ctypes.c_void_p, [ctypes.c_void_p, ctypes.c_int32,
                                                 ctypes.c_int32, ctypes.c_int64]),
    "inf_pipeline_next": (None, _BATCH_ARGS),
    "inf_pipeline_destroy": (None, [ctypes.c_void_p]),
}


@functools.lru_cache(maxsize=None)
def load_native_lib() -> ctypes.CDLL:
    """The sampler library, built at first use and declared once."""
    from induction_network_on_fewrel_tpu_torch.kernels.build import SAMPLER_LIBRARY

    lib = SAMPLER_LIBRARY.build()
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class _Handle:
    """The C sampler's handle and its teardown, shared by both samplers."""

    _handle = None

    def close(self) -> None:
        if getattr(self, "_pipeline", None) is not None:
            self._lib.inf_pipeline_destroy(self._pipeline)
            self._pipeline = None
        if self._handle is not None:
            self._lib.inf_sampler_destroy(self._handle)
            self._handle = None

    def __del__(self):              # best effort; close() is the API
        try:
            self.close()
        except Exception:           # noqa: BLE001 - interpreter teardown
            pass

    @property
    def total_q(self) -> int:
        return (self.n + self.na_rate) * self.q

    def __iter__(self):
        while True:
            yield self.sample_batch()


class NativeEpisodeSampler(_Handle):
    """Token batches from the C++ sampler; ``prefetch`` > 0 keeps a C++ ring
    of that many batches filled by ``num_threads`` threads."""

    def __init__(self, dataset, tokenizer, n: int, k: int, q: int, batch_size: int = 1,
                 na_rate: int = 0, seed: int = 0, prefetch: int = 0, num_threads: int = 2):
        check_episode_feasibility([len(dataset.instances[r]) for r in dataset.rel_names],
                                  n, k, q, na_rate, names=dataset.rel_names)
        if prefetch > 0 and num_threads < 1:
            raise ValueError(f"prefetch={prefetch} needs num_threads >= 1 (got {num_threads}): "
                             "a ring without workers would block at the first batch")
        self._lib = load_native_lib()
        self.n, self.k, self.q = n, k, q
        self.batch_size, self.na_rate = batch_size, na_rate
        L = tokenizer.max_length
        # The corpus tokenized once into flat [rows, L] blocks grouped by
        # relation; the C++ sampler borrows them for its lifetime.
        toks = [tokenizer(inst) for rel in dataset.rel_names for inst in dataset.instances[rel]]
        self._words = np.ascontiguousarray(np.stack([t.word for t in toks]), dtype=np.int32)
        self._pos1 = np.ascontiguousarray(np.stack([t.pos1 for t in toks]), dtype=np.int32)
        self._pos2 = np.ascontiguousarray(np.stack([t.pos2 for t in toks]), dtype=np.int32)
        self._mask = np.ascontiguousarray(np.stack([t.mask for t in toks]), dtype=np.float32)
        self._offsets = np.cumsum(
            [0] + [len(dataset.instances[r]) for r in dataset.rel_names]).astype(np.int64)
        self._handle = self._lib.inf_sampler_create(
            _ptr(self._words, ctypes.c_int32), _ptr(self._pos1, ctypes.c_int32),
            _ptr(self._pos2, ctypes.c_int32), _ptr(self._mask, ctypes.c_float),
            _ptr(self._offsets, ctypes.c_int64), dataset.num_relations, L, n, k, q, na_rate,
            batch_size, ctypes.c_uint64(seed))
        self._prefetch, self._num_threads = prefetch, num_threads
        self._pipeline = (self._lib.inf_pipeline_create(self._handle, prefetch, num_threads)
                          if prefetch > 0 else None)
        # The consumed position: the ring pulls by its own sequence counter.
        self._pos = 0
        TQ = self.total_q
        self._shapes = ((batch_size, n, k, L), (batch_size, TQ, L), (batch_size, TQ))

    def _empty(self, lead: tuple) -> EpisodeBatch:
        s, qs, ls = self._shapes
        return EpisodeBatch(
            *(np.empty(lead + s, np.int32) for _ in range(3)), np.empty(lead + s, np.float32),
            *(np.empty(lead + qs, np.int32) for _ in range(3)), np.empty(lead + qs, np.float32),
            np.empty(lead + ls, np.int32))

    def _fill(self, batch: EpisodeBatch) -> None:
        """The next batch of the stream into ``batch``'s (contiguous) arrays."""
        args = [_ptr(a, ctypes.c_float if a.dtype == np.float32 else ctypes.c_int32)
                for a in batch]
        if self._pipeline is not None:
            self._lib.inf_pipeline_next(self._pipeline, *args)
        else:
            self._lib.inf_sampler_sample(self._handle, *args)
        self._pos += 1

    def sample_batch(self) -> EpisodeBatch:
        batch = self._empty(())
        self._fill(batch)
        return batch

    def sample_fused(self, s: int) -> EpisodeBatch:
        """S batches stacked on a leading axis: each field [S, B, ...]."""
        block = self._empty((s,))
        for i in range(s):
            self._fill(EpisodeBatch(*(a[i] for a in block)))
        return block

    def feed_state(self) -> dict:
        return {"kind": "native", "next": int(self._pos)}

    def restore_feed_state(self, state: dict) -> None:
        pos = int(state["next"])
        self._pos = pos
        self._lib.inf_sampler_set_next(self._handle, pos)
        if self._pipeline is not None:
            # The ring restarts at the restored position (its queued batches
            # are produced again, never skipped).
            self._lib.inf_pipeline_destroy(self._pipeline)
            self._pipeline = self._lib.inf_pipeline_create_at(
                self._handle, self._prefetch, self._num_threads, pos)


class NativeIndexSampler(_Handle):
    """Index batches (global row ids into a split's flat token table) from
    the C++ sampler."""

    def __init__(self, sizes, n: int, k: int, q: int, batch_size: int = 1, na_rate: int = 0,
                 seed: int = 0):
        sizes = [int(s) for s in sizes]
        check_episode_feasibility(sizes, n, k, q, na_rate)
        self._lib = load_native_lib()
        self.n, self.k, self.q = n, k, q
        self.batch_size, self.na_rate = batch_size, na_rate
        self._offsets = np.cumsum([0] + sizes).astype(np.int64)
        # NULL corpus pointers: index mode never reads token rows.
        self._handle = self._lib.inf_sampler_create(
            None, None, None, None, _ptr(self._offsets, ctypes.c_int64), len(sizes), 1, n, k,
            q, na_rate, batch_size, ctypes.c_uint64(seed))

    def sample_fused(self, s: int):
        """S stacked batches in one C call: (sup [S,B,N,K], qry [S,B,TQ],
        label [S,B,TQ])."""
        B, TQ = self.batch_size, self.total_q
        sup = np.empty((s, B, self.n, self.k), np.int32)
        qry = np.empty((s, B, TQ), np.int32)
        lab = np.empty((s, B, TQ), np.int32)
        self._lib.inf_sampler_sample_indices(self._handle, s, _ptr(sup, ctypes.c_int32),
                                             _ptr(qry, ctypes.c_int32), _ptr(lab, ctypes.c_int32))
        return sup, qry, lab

    def sample_batch(self) -> IndexEpisodeBatch:
        sup, qry, lab = self.sample_fused(1)
        return IndexEpisodeBatch(sup[0], qry[0], lab[0])

    def feed_state(self) -> dict:
        return {"kind": "native", "next": int(self._lib.inf_sampler_get_next(self._handle))}

    def restore_feed_state(self, state: dict) -> None:
        self._lib.inf_sampler_set_next(self._handle, int(state["next"]))


def resolve_sampler_backend(backend: str, eval: bool = False) -> str:
    """"native" or "python": "auto" is native for a training stream and
    python for an evaluation stream (reproducible whatever the machine)."""
    check_sampler_backend(backend)
    if backend != "auto":
        return backend
    if eval:
        return "python"
    try:
        load_native_lib()
    except Exception as e:
        raise RuntimeError(f"--sampler auto trains on the C++ sampler, which failed to build "
                           f"({e}); pass --sampler python for the numpy sampler") from e
    return "native"


def make_sampler(dataset, tokenizer, n, k, q, batch_size=1, na_rate=0, seed=0,
                 backend: str = "auto", prefetch: int = 4, num_threads: int = 2,
                 eval: bool = False):
    """A token-batch sampler of ``backend`` (see ``resolve_sampler_backend``)."""
    if resolve_sampler_backend(backend, eval) == "native":
        return NativeEpisodeSampler(dataset, tokenizer, n, k, q, batch_size, na_rate, seed,
                                    prefetch=prefetch, num_threads=num_threads)
    return EpisodeSampler(dataset, tokenizer, n, k, q, batch_size, na_rate, seed)


def make_index_sampler(sizes, n, k, q, batch_size=1, na_rate=0, seed=0,
                       backend: str = "auto", eval: bool = False):
    """An index-batch sampler of ``backend`` (see ``resolve_sampler_backend``)."""
    if resolve_sampler_backend(backend, eval) == "native":
        return NativeIndexSampler(sizes, n, k, q, batch_size, na_rate, seed)
    return IndexEpisodeSampler(sizes, n, k, q, batch_size=batch_size, na_rate=na_rate,
                               seed=seed)
