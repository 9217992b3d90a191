"""Model-zoo quality sweep: the best synthetic-val accuracy of each few-shot
model, through the port's training CLI (the port of the JAX repository's
``tools/zoo_quality.py``).

Each model runs once in a child process, ``python -m
induction_network_on_fewrel_tpu_torch.cli train --model M``, at the
flagship quality recipe (``COMMON``: 5-way 5-shot, the token cache, a
damped learning-rate staircase, CE loss for every head), and the sweep
prints one JSON line per model: ``{model, final_val_accuracy, acc_ci95,
train_eps_s_median}``, or ``{model, error}``. ``train_eps_s_median`` is
the median ``episodes_per_s`` of the last half of the run's
``kind="train"`` records (``obs_report.load_records``).

Synthetic corpus only: the numbers bound the task, not FewRel; their value
is relative (a model far below its siblings has a head or geometry bug).

Run: ``python -m induction_network_on_fewrel_tpu_torch.tools.zoo_quality
[MODEL ...] [--device cuda|cpu] [-- TRAIN_FLAG ...]``: every model without
names; the flags after ``--`` follow ``COMMON`` (a cut recipe, say
``-- --train_iter 500 --val_step 250 --val_iter 50``). The runs take the
card unless ``--device cpu``; without CUDA the sweep refuses to start.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

ZOO = ("induction", "proto", "proto_hatt", "siamese", "gnn", "snail", "metanet")

COMMON = [
    "--encoder", "cnn", "--N", "5", "--K", "5", "--Q", "5",
    "--batch_size", "8", "--max_length", "40", "--vocab_size", "2002",
    "--token_cache", "--steps_per_call", "64", "--bf16",
    "--loss", "ce",  # uniform across the zoo: several heads (metric-based
    # logits) sit far from the MSE-sigmoid calibration the induction paper
    # assumes; CE ranks them on equal footing
    "--lr", "1e-3", "--lr_step_size", "500",  # the damped recipe
    "--train_iter", "4000", "--val_step", "500", "--val_iter", "200",
    "--divergence_guard", "stop",
]


def run_model(model: str, extra=(), ckpt: str | None = None,
              timeout_s: float = 3600.0) -> dict:
    """One model's row: the CLI's final JSON line and the steady-state
    train rate from its metrics, or ``error``. The run's checkpoint and
    metrics go to ``ckpt`` (kept), else to a temporary directory."""
    from induction_network_on_fewrel_tpu_torch.tools.obs_report import load_records

    if ckpt is None:
        with tempfile.TemporaryDirectory(prefix=f"zoo_{model}_") as tmp:
            return run_model(model, extra, tmp, timeout_s)

    row: dict = {"model": model}
    cmd = [sys.executable, "-m", "induction_network_on_fewrel_tpu_torch.cli", "train",
           "--model", model, *COMMON, *extra, "--save_ckpt", ckpt]
    pp = os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s,
                              cwd=REPO, env={**os.environ, "PYTHONPATH": pp})
    except subprocess.TimeoutExpired:
        # One stuck run must not abort the whole sweep.
        row["error"] = f"timeout after {timeout_s:g}s"
        return row
    if proc.returncode != 0:
        row["error"] = proc.stderr[-400:]
        return row
    try:
        row.update(json.loads(proc.stdout.strip().splitlines()[-1]))
    except (IndexError, json.JSONDecodeError):
        row["error"] = "no final JSON: " + proc.stdout[-200:]
    # The steady-state rate: the median of the last half of the train
    # windows (skips the captures and the early checkpoints).
    metrics = Path(ckpt) / "metrics.jsonl"
    if metrics.exists():
        rates = [r["episodes_per_s"] for r in load_records(metrics)
                 if r.get("kind") == "train" and "episodes_per_s" in r]
        tail = sorted(rates[len(rates) // 2:])
        if tail:
            row["train_eps_s_median"] = round(tail[len(tail) // 2], 1)
    return row


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    cut = argv.index("--") if "--" in argv else len(argv)
    ap = argparse.ArgumentParser(description="best synthetic-val accuracy per zoo model")
    ap.add_argument("models", nargs="*", choices=ZOO, metavar="MODEL",
                    help=f"zoo models to run (default: all of {', '.join(ZOO)})")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv[:cut])
    from induction_network_on_fewrel_tpu_torch.models.build import resolve_device

    resolve_device(args.device)
    extra = [*argv[cut + 1:], *(["--device", "cpu"] if args.device == "cpu" else [])]
    for model in args.models or ZOO:
        print(json.dumps(run_model(model, extra)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
