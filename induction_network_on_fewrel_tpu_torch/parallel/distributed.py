"""Process-group initialization from the launcher's environment.

Counterpart of ``induction_network_on_fewrel_tpu/parallel/distributed.py``.
There ``jax.distributed.initialize()`` joins the hosts of a pod into one
JAX process group. Here every rank is one process holding one device, as
``torchrun --nproc_per_node N`` starts them: the launcher sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT``, and
``maybe_initialize_distributed`` joins the process group they name. NCCL
on ``cuda:LOCAL_RANK``; gloo only when the caller asks for the CPU (or
names it: two ranks on one card, which NCCL refuses, go over gloo).

It is a no-op when no launcher variable is set, so single-process runs
never pay for it. The rendezvous gets a bounded ``timeout_s``, and a failed
or timed-out one is re-raised as a clean ``RuntimeError`` naming the likely
causes.
"""

from __future__ import annotations

import datetime
import gc
import os

import torch
import torch.distributed as dist

LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """True when a launcher (torchrun) started this process as a rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def backend_for(device) -> str:
    """"gloo" for a CPU device, else "nccl"."""
    return "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl"


def maybe_initialize_distributed(device=None, timeout_s: float | None = 300,
                                 backend: str | None = None, store=None, rank: int | None = None,
                                 world_size: int | None = None) -> bool:
    """Join the process group this process was launched into.

    Returns True when a group is (now) initialized. Safe to call twice.
    Without a launcher variable or a ``store`` it returns False.
    ``device`` ("cpu" or a CUDA device; None is the card) picks the
    backend unless ``backend`` names it; NCCL binds the rank to
    ``cuda:LOCAL_RANK`` and creates its communicator now. ``store`` (a
    ``torch.distributed.Store``, e.g. a ``FileStore``) with ``rank`` and
    ``world_size`` replaces the environment's rendezvous.
    """
    if dist.is_initialized():
        return True
    if not (store is not None or launched()):
        return False
    backend = backend or backend_for(device)
    timeout = datetime.timedelta(seconds=timeout_s if timeout_s is not None else 1800)
    present = {v: os.environ[v] for v in LAUNCHER_ENV if v in os.environ}
    bound = f" (barrier bound: {timeout_s}s)" if timeout_s is not None else ""
    try:
        kw = dict(backend=backend, timeout=timeout)
        if store is not None:
            kw.update(store=store, rank=int(rank), world_size=int(world_size))
        else:
            kw.update(init_method="env://", rank=int(os.environ.get("RANK", 0)),
                      world_size=int(os.environ.get("WORLD_SIZE", 1)))
        if backend == "nccl":
            if not torch.cuda.is_available():
                raise RuntimeError("NCCL needs CUDA, and CUDA is not available; pass --device "
                                   "cpu for gloo ranks")
            local = int(os.environ.get("LOCAL_RANK", 0))
            torch.cuda.set_device(local)
            kw["device_id"] = torch.device("cuda", local)
        dist.init_process_group(**kw)
    except Exception as e:  # a clean, actionable error
        raise RuntimeError(
            f"multi-process initialization failed{bound}: {e}. Likely causes: a peer rank "
            f"crashed before the rendezvous, MASTER_ADDR:MASTER_PORT is unreachable or "
            f"taken, or this process was launched with launcher env vars set ({present}) "
            f"outside a real launch."
        ) from e
    return True


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main() -> bool:
    """True on rank 0 (and without a group): the rank that writes."""
    return world()[0] == 0


def shutdown() -> None:
    """Leave the process group, if any, once every rank has reached here.
    What still holds the group (a closed trainer's reference cycles) is
    collected first and last: torn down at the interpreter's exit instead,
    a gloo rank aborted ("terminate called without an active exception")
    in about 3 % of two-rank CLI runs on a loaded host."""
    if dist.is_initialized():
        gc.collect()
        dist.barrier()
        dist.destroy_process_group()
        gc.collect()
