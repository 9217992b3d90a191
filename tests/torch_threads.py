"""One CPU thread for the port's tests and for the processes they start.

At the widths of ``tests/test_torch_*.py`` torch's intra-op threads buy
nothing, and under ``pytest -n 6`` each worker's default of one thread a
core oversubscribes the machine many times over: the port's heavy
trajectory tests then spend most of their wall time waiting for a core.
Every ``tests/test_torch_*.py`` imports this module before its other
imports, so each pytest process runs torch on one thread, and every
process a test starts (a spawned rank, a CLI subprocess, torchrun and its
ranks, a tool's child run) inherits ``OMP_NUM_THREADS=1``. XLA's threads
and ``XLA_FLAGS`` stay as ``tests/conftest.py`` sets them.

Anyone running the port's tests under xdist outside pytest's collection
(a witness script, say) gets the same cap with ``import torch_threads``
or by exporting ``OMP_NUM_THREADS=1``.
"""

import os

import torch

CHILD_ENV = {"OMP_NUM_THREADS": "1"}

os.environ.update(CHILD_ENV)
torch.set_num_threads(1)


def child_env(**extra: str) -> dict:
    """The environment of a child process a port test starts: this
    process's, with the thread cap and ``extra``."""
    return {**os.environ, **CHILD_ENV, **extra}
