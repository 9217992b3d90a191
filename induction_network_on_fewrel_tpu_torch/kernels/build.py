"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` source has a plain ``extern "C"`` launcher interface and
compiles on its own into a shared library for ``sm_90a`` (the LSTM sources
share device code through ``csrc/lstm_common.cuh``, the attention sources
through ``csrc/attn_common.cuh``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/torch_kernels/<name>-<hash>.so csrc/<name>.cu

No PyTorch headers are included (a source that includes them takes minutes
to compile instead of seconds), and ``torch.utils.cpp_extension`` is not
used. Libraries are built at first use into ``build/torch_kernels/`` at the
root of the checkout, keyed by a hash of the source, the headers and the
flags, so an edited source or header rebuilds and an unchanged one loads.
All sources are compiled together, one ``nvcc`` process each, the first
time any kernel is needed.

Every launcher takes its pointers and the stream as ``void*`` and returns
``cudaGetLastError()`` after the launch; ``KernelLibrary.launch`` turns a
non-zero code into an exception. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# The split recurrence's launchers: L, M, u, Gc, the (group, row, time)
# strides of xg and of hs, the reversed group and the dtype flag.
_SPLIT = [_I] * 4 + [_LL] * 6 + [_I] * 2
# Launcher name -> (source stem, argtypes). The stream is the last argument;
# the LSTM recurrences take the row tile and the cluster size
# (ops/lstm.py:fwd_plan, bwd_plan) just before it, the attention kernels
# their plan's fields (ops/attn.py:attn_fwd_plan, attn_bwd_plan).
LAUNCHERS = {
    "bilstm_infer_fwd": ("bilstm_infer", [_P] * 5 + [_I] * 7 + [_P]),
    "bilstm_win_fwd": ("bilstm_infer", [_P] * 7 + [_I] * 9 + [_P]),
    "bilstm_full_fwd": ("bilstm_infer", [_P] * 6 + [_I] * 8 + [_P]),
    "bilstm_win_bwd": ("bilstm_win_bwd", [_P] * 9 + [_I] * 9 + [_P]),
    "bilstm_full_bwd": ("bilstm_full_bwd", [_P] * 8 + [_I] * 8 + [_P]),
    "lstm_wgrad": ("lstm_wgrad", [_P] * 8 + [_I] * 5 + [_LL] * 6 + [_I] * 4 + [_P]),
    "lstm_split_fwd_infer": ("lstm_split", [_P] * 3 + _SPLIT + [_I, _I, _P]),
    "lstm_split_fwd": ("lstm_split", [_P] * 4 + _SPLIT + [_I, _I, _P]),
    "lstm_split_bwd": ("lstm_split", [_P] * 7 + _SPLIT + [_I, _I, _P]),
    "attn_fwd": ("attn_fwd", [_P] * 5 + [_I] * 10 + [_P]),
    "attn_fwd_stats": ("attn_fwd", [_P] * 7 + [_I] * 10 + [_P]),
    "attn_bwd": ("attn_bwd", [_P] * 13 + [_I] * 6 + [_P]),
    # The optimizer pair (ops/optim.py): the host table of entries, its
    # length, the workspace and state pointers, then the hyperparameters.
    "optim_sumsq": ("optim", [_P, _I, _P, _P, _P, _P]),
    "optim_update": ("optim", [_P, _I, _P, _P, _P, _F, _F, _I] + [_F] * 7 + [_P]),
}
SOURCES = tuple(sorted({stem for stem, _ in LAUNCHERS.values()}))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda/bin, PATH): the CUDA "
            "kernels of this package are compiled at first use"
        )
    return found


def _lib_path(stem: str) -> Path:
    src = (CSRC / f"{stem}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{stem}-{h}.so"


class KernelLibrary:
    """The loaded launchers of every source. ``build()`` compiles whatever
    is missing in parallel and records the seconds it took."""

    def __init__(self):
        self._lock = threading.Lock()
        self._fns: dict | None = None
        self._error_string = None
        self.build_seconds = 0.0

    def build(self) -> dict:
        with self._lock:
            if self._fns is None:
                self._fns = self._build_and_load()
            return self._fns

    def _build_and_load(self) -> dict:
        t0 = time.monotonic()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = {stem: _lib_path(stem) for stem in SOURCES}
        procs = []
        for stem, out in todo.items():
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
            procs.append((stem, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        errors = []
        for stem, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {stem}.cu (rc {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        libs = {stem: ctypes.CDLL(str(path)) for stem, path in todo.items()}
        fns = {}
        for name, (stem, argtypes) in LAUNCHERS.items():
            fn = getattr(libs[stem], name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
        # cudaGetErrorString, exported by every source as <stem>_error_string.
        err = getattr(libs[SOURCES[0]], f"{SOURCES[0]}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._error_string = err
        self.build_seconds = time.monotonic() - t0
        return fns

    def launch_on(self, device, name: str, *args) -> None:
        """``launch(name, *args, stream)`` on the current stream of CUDA
        ``device``, made the current device for the call if it is not. The
        raw stream handle is read without making a ``torch.cuda.Stream``:
        the serving path's kernels take tens of microseconds, so the
        wrapper's host time is part of what a caller waits for."""
        import torch

        cur = torch.cuda.current_device()
        idx = cur if device.index is None else device.index
        stream = torch._C._cuda_getCurrentRawStream(idx)
        if idx == cur:
            self.launch(name, *args, stream)
        else:
            with torch.cuda.device(idx):
                self.launch(name, *args, stream)

    def launch(self, name: str, *args) -> None:
        """Call launcher ``name``; raise if it reports a CUDA error (a
        refused launch never runs, and a later synchronize would not say so)."""
        fns = self._fns if self._fns is not None else self.build()
        code = fns[name](*args)
        if code != 0:
            msg = self._error_string(code).decode()
            raise RuntimeError(f"{name}: CUDA error {code} ({msg}) at launch")


LIBRARY = KernelLibrary()


def check_cuda_tensors(name: str, *tensors) -> None:
    """A launcher takes raw pointers: every tensor must be contiguous and
    on one CUDA device, or ``name`` raises before anything is launched."""
    dev = tensors[0].device
    for x in tensors:
        if x.device.type != "cuda" or x.device != dev:
            raise RuntimeError(
                f"{name}: every tensor must lie on one CUDA device, got {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
