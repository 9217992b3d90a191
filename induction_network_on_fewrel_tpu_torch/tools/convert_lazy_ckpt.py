"""Convert a lazy word-table checkpoint directory into a shared (dense) one:
the port of the JAX repository's ``tools/convert_lazy_ckpt.py``.

An ``--embed_optimizer lazy`` checkpoint carries the table's Adam moments
as the lazy leaves (``m``, ``v``, ``last``) beside an optimizer state whose
table entry has no moments (rule "lazy"), and ``embed_optimizer`` is an
architecture field, so a shared-mode run refuses to resume it. This tool
makes the faithful conversion: it restores the best slot, materializes the
table on the device (every row caught up, ``lazy_catchup``), and rebuilds
the dense optimizer state with every Adam moment carried over (the main
partition's moments from the lazy run's optimizer, the word table's from
the lazy ``m``/``v``) and the update count, which drives both the bias
correction and the staircase, set to the checkpoint step. It saves the
result as a best slot under ``embed_optimizer="shared"`` with the source's
best val accuracy (a zero would let any later eval in the new directory
replace the better weights) and the source slot's sampler streams, so
``cli train --resume --save_ckpt DST`` continues the episode stream where
the lazy run stopped.

Caveat: lazy mode keeps weight decay off the table; a converted run
continued in shared mode with weight_decay > 0 applies the coupled L2 term
to the table from the conversion on. Continuation is exact at wd=0 (and for
the rest of the model always).

Run: ``python -m induction_network_on_fewrel_tpu_torch.tools.convert_lazy_ckpt
SRC_DIR DST_DIR [--device cuda|cpu]`` (cuda unless ``--device cpu``;
without CUDA it refuses to start). Exit code 2 for a source that is not a
lazy checkpoint.
"""

from __future__ import annotations

import argparse
import sys


def convert_state(model, opt, lazy, dense_cfg, step: int):
    """Materialize ``lazy`` into ``model``'s table and return the shared-mode
    optimizer of ``dense_cfg`` carrying ``opt``'s moments, the table's from
    ``lazy``, and ``step`` as its update count."""
    from induction_network_on_fewrel_tpu_torch.train.steps import WORD_TABLE, make_optimizer

    lazy.materialize(opt.count)
    dense = make_optimizer(dense_cfg, model)
    state = opt.state_dict()
    mu, nu = list(state["mu"]), list(state["nu"])
    i = [n for n, _ in model.named_parameters()].index(WORD_TABLE)
    mu[i], nu[i] = lazy.m, lazy.v
    dense.load_state_dict({"count": int(step), "rules": dense.rules, "mu": mu, "nu": nu})
    return dense


def convert(src: str, dst: str, device=None) -> int:
    """The conversion of ``src`` into ``dst``; returns the exit code."""
    from induction_network_on_fewrel_tpu_torch.models.build import build_model, resolve_device
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager
    from induction_network_on_fewrel_tpu_torch.train.lazy_embed import LazyTable, live_rows
    from induction_network_on_fewrel_tpu_torch.train.steps import make_optimizer

    dev = resolve_device(device)
    cfg = CheckpointManager.load_config(src)
    if cfg.embed_optimizer != "lazy":
        print(f"{src} is not a lazy-embed checkpoint "
              f"(embed_optimizer={cfg.embed_optimizer})", file=sys.stderr)
        return 2
    # The restore target from the config alone: the model, its optimizer
    # and the lazy leaves, all overwritten by the restore.
    model = build_model(cfg, device=dev)
    opt = make_optimizer(cfg, model)
    lazy = LazyTable(model, opt.hyper, live_rows(cfg))
    src_mngr = CheckpointManager(src, cfg)
    try:
        step, extras = src_mngr.restore_best_with_extras(model, opt, lazy)
    finally:
        src_mngr.close()
    dense_cfg = cfg.replace(embed_optimizer="shared")
    dense = convert_state(model, opt, lazy, dense_cfg, step)
    dst_mngr = CheckpointManager(dst, dense_cfg)
    try:
        dst_mngr.save(step, model, dense, extras["val_accuracy"], samplers=extras["samplers"])
        dst_mngr.wait()
    finally:
        dst_mngr.close()
    print(f"converted step {step} (best_val {extras['val_accuracy']:.4f}): "
          f"{src} (lazy) -> {dst} (shared)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="convert a lazy word-table checkpoint "
                                             "directory into a shared (dense) one")
    ap.add_argument("src", help="the lazy run's checkpoint directory")
    ap.add_argument("dst", help="the shared-mode checkpoint directory to write")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    return convert(args.src, args.dst, args.device)


if __name__ == "__main__":
    sys.exit(main())
