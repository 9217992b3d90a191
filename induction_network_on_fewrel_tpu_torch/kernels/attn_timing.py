"""Device time of the attention kernels (K2, K10, K11) on the card.

At serving sizes a call of K2 takes a few tens of microseconds, less than
the wrapper's host time, so CUDA events around a loop of calls measure the
host. This tool reads the kernels' own device time under torch.profiler,
beside the event time, through the public wrappers only (``attn_fwd_cuda``,
``attn_fwd_stats``, ``attn_bwd``), at the flagship widths (L=40, D=256,
A=64, bf16), so it runs unchanged against an older checkout of the port::

    python -m induction_network_on_fewrel_tpu_torch.kernels.attn_timing [--rows 1 4 16 25 200]

It prints one line per (kernel, M) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from induction_network_on_fewrel_tpu_torch.ops import attn

L, D, A = 40, 256, 64


def times(fn, iters: int = 50) -> tuple[float, float]:
    """(event ms, device ms) per call of ``fn``: CUDA events around
    ``iters`` calls, then the kernels' self device time under the profiler
    over as many, both after 3 warm-up calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages() if e.self_device_time_total > 0)
    return start.elapsed_time(end) / iters, us / iters / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[1, 4, 16, 25, 200])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attn_timing: needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    for M in args.rows:
        H = (torch.rand((L, M, D), generator=gen) * 2 - 1).to(dev, torch.bfloat16)
        lengths = torch.randint(1, L + 1, (M,), generator=gen)
        mask = (torch.arange(L)[None, :] < lengths[:, None]).float().to(dev)
        w1 = (torch.randn((D, A), generator=gen) / D ** 0.5).to(dev)
        w2 = (torch.randn((A, 1), generator=gen) / A ** 0.5).to(dev)
        dout = (torch.randn((M, D), generator=gen) * 0.1).to(dev, torch.bfloat16)
        out, mx, dn = attn.attn_fwd_stats(H, mask, w1, w2)
        for name, fn in (("K2", lambda: attn.attn_fwd_cuda(H, mask, w1, w2)),
                         ("K10", lambda: attn.attn_fwd_stats(H, mask, w1, w2)),
                         ("K11", lambda: attn.attn_bwd(H, mask, w1, w2, out, mx, dn, dout))):
            ev, devt = times(fn)
            print(f"[attn_timing] {name} bf16 L={L} M={M} D={D} A={A}: event ms {ev:.4f} "
                  f"device ms {devt:.4f}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"[attn_timing] card: {smi.stdout.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
