"""The per-rank feed: each rank samples only its own episodes.

Counterpart of ``induction_network_on_fewrel_tpu/parallel/hostfeed.py``.
There each host of a pod samples the rows its devices own and
``GlobalBatchAssembler`` builds global ``jax.Array``s from them. Here a
rank is one process on one device and holds its own shard outright, so
there is no global assembly: each rank draws ``B/dp`` episodes a batch from
its own stream (``process_seed``), steps on them, and the gradients are
averaged over the ranks (``parallel/grad_buckets.py``).

* ``episode_ranges_by_process`` / ``local_episode_range``: which
  contiguous rows of the global episode batch each rank owns (the JAX
  partition arithmetic at one device a process, the port's only layout),
  by the rank's dp index: the ep, tp and sp ranks of a dp slice hold the
  same episodes, drawn from the same stream (``process_seed`` of the dp
  index); an sp rank keeps its ``L/sp`` token columns of them
  (``local_token_columns``).
* ``check_pipeline_rows``: under pp every encoder call's rows, per dp
  shard, split into ``--pp_microbatches`` (the JAX ``cli.py:886-907``).
* ``process_seed``: rank 0 keeps the seed (a one-rank run draws the
  single-process stream), rank p > 0 a splitmix64 avalanche of (seed, p).
* ``PerRankSampler``: wraps the rank-local sampler (the C++ sampler of
  ``sampling/native.py``, an index sampler, a numpy one, or a
  ``MixtureSampler`` of the rank's children, ``cli.mixture_sampler``) and
  reports the GLOBAL batch size, which the trainer counts episodes by;
  its position lives in the local sampler and rides in every checkpoint
  slot.
"""

from __future__ import annotations

from induction_network_on_fewrel_tpu_torch.datapipe.cursor import (
    capture_sampler_state,
    restore_sampler_state,
)
from induction_network_on_fewrel_tpu_torch.datapipe.mixture import _MASK64, _splitmix64


def episode_ranges_by_process(mesh, global_batch: int) -> dict:
    """{rank: (start_row, num_rows)} of the global episode axis sharded
    over ``mesh``'s dp ranks, one rank a device (the JAX function on a
    process-major layout of one device a process)."""
    dp = mesh.dp
    if global_batch % dp:
        raise ValueError(f"global batch {global_batch} must divide over dp={dp}")
    per = global_batch // dp
    return {d: (d * per, per) for d in range(dp)}


def local_episode_range(mesh, global_batch: int) -> tuple[int, int]:
    """(start_row, num_rows) of the global episode batch THIS rank owns."""
    return episode_ranges_by_process(mesh, global_batch)[mesh.rank]


def local_token_columns(mesh, length: int) -> tuple[int, int]:
    """(start, num) of the token columns THIS rank keeps of a [.., length]
    leaf: its sp index's share (the JAX ``episode_batch_shardings`` shards
    the token axis over sp; ``parallel/ring.SequenceShard.columns``)."""
    sp = getattr(mesh, "sp", 1)
    if length % sp:
        raise ValueError(f"the sequence length {length} must be divisible by --sp ({sp})")
    n = length // sp
    return getattr(mesh, "sp_rank", 0) * n, n


def pipeline_row_counts(cfg) -> dict:
    """The global rows of each encoder call a run makes (the JAX
    ``row_counts``): train support and query, eval support and query."""
    return {
        "train support": cfg.batch_size * cfg.train_n * cfg.k,
        "train query": cfg.batch_size * (cfg.train_n * cfg.q + cfg.na_rate * cfg.q),
        "eval support": cfg.batch_size * cfg.n * cfg.k,
        "eval query": cfg.batch_size * (cfg.n * cfg.q + cfg.na_rate * cfg.q),
    }


def check_pipeline_rows(cfg, dp: int) -> None:
    """Raise (the JAX text) unless every encoder call's rows divide evenly
    over ``dp`` shards and then into ``cfg.pp_microbatches``. Train shapes
    are checked under ``--only_test`` too, as JAX does."""
    mb = cfg.pp_microbatches
    for what, rows in pipeline_row_counts(cfg).items():
        if rows % dp != 0 or (rows // dp) % mb != 0:
            raise ValueError(
                f"{what} rows ({rows}) must divide evenly across "
                f"dp={dp} shards and then into "
                f"--pp_microbatches ({mb}); adjust --batch_size, "
                f"--pp_microbatches, or the episode shape flags"
            )


def process_seed(seed: int, rank: int | None = None) -> int:
    """The rank's sampler seed: rank 0 keeps ``seed``; rank p > 0 gets two
    dependent splitmix64 rounds of (seed, p), decorrelated 64-bit seeds
    (the JAX function, with the rank for ``jax.process_index()``)."""
    if rank is None:
        from induction_network_on_fewrel_tpu_torch.parallel.distributed import world

        rank = world()[0]
    if rank == 0:
        return seed
    return _splitmix64(_splitmix64(seed & _MASK64) ^ (rank & _MASK64))


class PerRankSampler:
    """A rank-local sampler reporting the global batch size. Batches are
    the local sampler's own: the rank's ``B/dp`` episodes."""

    def __init__(self, local_sampler, global_batch: int):
        self.local = local_sampler
        self.batch_size = int(global_batch)

    @property
    def total_q(self):
        return self.local.total_q

    def __getattr__(self, name):
        # sample_fused, return_indices and the rest: the local sampler's.
        if name == "local":
            raise AttributeError(name)
        return getattr(self.local, name)

    def sample_batch(self):
        return self.local.sample_batch()

    def __iter__(self):
        while True:
            yield self.sample_batch()

    def feed_state(self) -> dict:
        return {"kind": "perhost", "local": capture_sampler_state(self.local)}

    def restore_feed_state(self, state: dict) -> None:
        restore_sampler_state(self.local, state["local"])

    def close(self):
        if hasattr(self.local, "close"):
            self.local.close()
