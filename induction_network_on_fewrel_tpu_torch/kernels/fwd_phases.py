"""Clock cycles per phase of the cluster LSTM bodies, on the card.

Builds ``csrc/bilstm_infer.cu`` with ``-DLSTM_PHASES`` (the ``FWD_PHASE``
marks of ``csrc/lstm_common.cuh`` compiled in) once per observed thread,
runs K1 at the flagship widths (L=40, D=60, u=128) with the plan the
wrapper would use, and prints, per phase, that thread's clock cycles per
launch and per step, averaged over the launches. Then the same for the
backward chain (the ``BWD_PHASE`` marks): ``csrc/bilstm_win_bwd.cu`` (K8,
W=8) and ``csrc/bilstm_full_bwd.cu`` (K6), thread 0 of the first CTA::

    python -m induction_network_on_fewrel_tpu_torch.kernels.fwd_phases [--rows 16 200]

A phase that ends in a block barrier includes that thread's wait for the
block's slowest thread. The libraries go to ``build/torch_kernels/phases/``;
the kernel library itself is not touched.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from induction_network_on_fewrel_tpu_torch.kernels.build import (
    BUILD_DIR,
    CSRC,
    LAUNCHERS,
    NVCC_FLAGS,
    _nvcc,
)
from induction_network_on_fewrel_tpu_torch.ops.lstm import bwd_plan, fwd_plan

L, D, U = 40, 60, 128
# (name, once per launch) in the order of the marks 0-7.
PHASES = (
    ("prologue", True), ("first gates + cluster barrier", True), ("gate product", False),
    ("barrier", False), ("cells + h exchange", False), ("hs stores", False),
    ("next projection", False), ("wait for peers", False),
)
# (CTA, thread): rank 0's thread 0 sends h to the peers (st.async), its
# thread 1 does not; rank 3 is another CTA of the same cluster.
THREADS = ((0, 0), (0, 1), (3, 0))
# The backward chain's marks 0-7 (name, once per launch): K8 passes 1 once
# per window (its replay), K6 never; K6's next gates run in phase 5.
BWD_PHASES = (
    ("prologue", True), ("window replay", False), ("da", False), ("barrier", False),
    ("dh product + reduce-scatter", False), ("next gates", False),
    ("reduce-scatter wait", False), ("rank-ordered sum", False),
)
BWD_SOURCES = {"K8": "bilstm_win_bwd", "K6": "bilstm_full_bwd"}
W = 8


def build() -> dict:
    """One library per observed thread, compiled in parallel."""
    (BUILD_DIR / "phases").mkdir(parents=True, exist_ok=True)
    procs = {}
    for cta, tid in THREADS:
        out = BUILD_DIR / "phases" / f"bilstm_infer_phases_{cta}_{tid}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-DLSTM_PHASES", f"-DLSTM_PHASES_CTA={cta}",
               f"-DLSTM_PHASES_TID={tid}", "-o", str(out), str(CSRC / "bilstm_infer.cu")]
        procs[(cta, tid)] = (out, subprocess.Popen(cmd))
    libs = {}
    for key, (out, proc) in procs.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed on the phase build {key}")
        lib = ctypes.CDLL(str(out))
        lib.bilstm_infer_fwd.argtypes = LAUNCHERS["bilstm_infer_fwd"][1]
        lib.bilstm_fwd_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[key] = lib
    return libs


def measure(lib: ctypes.CDLL, M: int, dt: torch.dtype, launches: int = 20) -> list[float]:
    """Cycles per launch of each phase, averaged over ``launches``."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    emb = (torch.randn((L, M, D), generator=gen) * 0.5).to(dev, dt)
    wih = (torch.randn((2, D, 4 * U), generator=gen) / D ** 0.5).to(dev, dt)
    b = (torch.randn((2, 1, 4 * U), generator=gen) * 0.1).to(dev)
    whh = (torch.randn((2, U, 4 * U), generator=gen) / U ** 0.5).to(dev)
    hs = torch.empty((L, M, 2 * U), dtype=dt, device=dev)
    plan = fwd_plan(M, D, U)
    args = (emb.data_ptr(), wih.data_ptr(), b.data_ptr(), whh.data_ptr(), hs.data_ptr(),
            L, M, D, U, int(dt == torch.bfloat16), plan.tm, plan.cluster,
            torch.cuda.current_stream().cuda_stream)
    buf = (ctypes.c_ulonglong * 8)()
    for _ in range(3):
        if lib.bilstm_infer_fwd(*args):
            raise RuntimeError("bilstm_infer_fwd refused the launch")
    torch.cuda.synchronize()
    lib.bilstm_fwd_phases(buf, 1)
    for _ in range(launches):
        lib.bilstm_infer_fwd(*args)
    torch.cuda.synchronize()
    if lib.bilstm_fwd_phases(buf, 1):
        raise RuntimeError("reading the phase counters failed")
    return [buf[i] / launches for i in range(8)]


def build_bwd() -> dict:
    """K8's and K6's sources with the backward marks, thread 0 of CTA 0."""
    (BUILD_DIR / "phases").mkdir(parents=True, exist_ok=True)
    procs = {}
    for key, stem in BWD_SOURCES.items():
        out = BUILD_DIR / "phases" / f"{stem}_phases.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-DLSTM_PHASES", "-o", str(out), str(CSRC / f"{stem}.cu")]
        procs[key] = (stem, out, subprocess.Popen(cmd))
    libs = {}
    for key, (stem, out, proc) in procs.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed on the phase build of {stem}.cu")
        lib = ctypes.CDLL(str(out))
        getattr(lib, stem).argtypes = LAUNCHERS[stem][1]
        lib.bilstm_bwd_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[key] = lib
    return libs


def measure_bwd(lib: ctypes.CDLL, key: str, M: int, dt: torch.dtype,
                launches: int = 20) -> list[float]:
    """Cycles per launch of each backward phase, averaged over ``launches``
    of K8's (W=8) or K6's chain kernel on random inputs."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    emb = (torch.randn((L, M, D), generator=gen) * 0.5).to(dev, dt)
    wih = (torch.randn((2, D, 4 * U), generator=gen) / D ** 0.5).to(dev, dt)
    b = (torch.randn((2, 1, 4 * U), generator=gen) * 0.1).to(dev)
    whh = (torch.randn((2, U, 4 * U), generator=gen) / U ** 0.5).to(dev)
    dhs = (torch.randn((L, M, 2 * U), generator=gen) * 0.1).to(dev, dt)
    da = torch.empty((2, L, M, 4 * U), device=dev)
    flags = (int(dt == torch.bfloat16), int(dt == torch.bfloat16))
    stream = torch.cuda.current_stream().cuda_stream
    if key == "K8":
        r = (torch.randn((-(-L // W), M, 2 * U), generator=gen) * 0.1).to(dev, dt)
        hp = torch.empty((2, L, M, U), device=dev)
        plan = bwd_plan(M, D, U, W)
        args = (dhs.data_ptr(), emb.data_ptr(), r.data_ptr(), r.data_ptr(), wih.data_ptr(),
                b.data_ptr(), whh.data_ptr(), da.data_ptr(), hp.data_ptr(), L, M, D, U, W,
                *flags, plan.tm, plan.cluster, stream)
    else:
        hs = (torch.rand((L, M, 2 * U), generator=gen) - 0.5).to(dev, dt)
        plan = bwd_plan(M, D, U, 0)
        args = (dhs.data_ptr(), emb.data_ptr(), hs.data_ptr(), hs.data_ptr(), wih.data_ptr(),
                b.data_ptr(), whh.data_ptr(), da.data_ptr(), L, M, D, U, *flags, plan.tm,
                plan.cluster, stream)
    fn = getattr(lib, BWD_SOURCES[key])
    buf = (ctypes.c_ulonglong * 8)()
    for _ in range(3):
        if fn(*args):
            raise RuntimeError(f"{BWD_SOURCES[key]} refused the launch")
    torch.cuda.synchronize()
    lib.bilstm_bwd_phases(buf, 1)
    for _ in range(launches):
        fn(*args)
    torch.cuda.synchronize()
    if lib.bilstm_bwd_phases(buf, 1):
        raise RuntimeError("reading the backward phase counters failed")
    return [buf[i] / launches for i in range(8)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[16, 200])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fwd_phases: needs a CUDA card")
    for (cta, tid), lib in build().items():
        for dt in (torch.bfloat16, torch.float32):
            for M in args.rows:
                cyc = measure(lib, M, dt)
                once = ", ".join(f"{n} {c:.0f}" for (n, o), c in zip(PHASES, cyc) if o)
                step = ", ".join(f"{n} {c / L:.0f}" for (n, o), c in zip(PHASES, cyc) if not o)
                print(f"[phases] CTA {cta} thread {tid} {str(dt)[6:]} M={M} "
                      f"TM={fwd_plan(M, D, U).tm}: {sum(cyc):.0f} cycles per launch; "
                      f"once: {once}; per step (sum / L): {step}", flush=True)
    for key, lib in build_bwd().items():
        for dt in (torch.bfloat16, torch.float32):
            for M in args.rows:
                cyc = measure_bwd(lib, key, M, dt)
                once = ", ".join(f"{n} {c:.0f}" for (n, o), c in zip(BWD_PHASES, cyc) if o)
                step = ", ".join(f"{n} {c / L:.0f}" for (n, o), c in zip(BWD_PHASES, cyc)
                                 if not o)
                print(f"[phases] {key} CTA 0 thread 0 {str(dt)[6:]} M={M} "
                      f"TM={bwd_plan(M, D, U, W if key == 'K8' else 0).tm}: {sum(cyc):.0f} "
                      f"cycles per launch; once: {once}; per step (sum / L): {step}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[phases] card: {smi.stdout.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
