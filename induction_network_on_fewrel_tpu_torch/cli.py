"""Train and test entry points of the port.

    python -m induction_network_on_fewrel_tpu_torch.cli train --synthetic \\
        --N 5 --K 5 --Q 5 --batch_size 4 --train_iter 1000 --val_step 200 \\
        --val_iter 200 --bf16 --save_ckpt ./ckpt_torch
    python -m induction_network_on_fewrel_tpu_torch.cli test --synthetic \\
        --load_ckpt ./ckpt_torch --test_iter 1000 --bf16

The counterparts of ``train.py`` / ``test.py`` (``train_main`` /
``test_main`` of the JAX ``cli.py``) with a subset of their flags under the
same names. Data is the synthetic FewRel/GloVe fixtures (train, val and
test splits from seeds 0, 1 and 2, as the JAX package makes them when no
file is given); ``--synthetic`` says so explicitly, and real files are not
read by this slice. As in the JAX CLI the encoder computes in f32 unless
``--bf16``. ``train`` logs ``[train]``/``[val]`` records (stderr and
``<save_ckpt>/metrics.jsonl``), keeps the best and latest checkpoints,
then reports the final val accuracy of the best checkpoint as a JSON line;
``test`` restores the best checkpoint (the latest one when there is no
best) with the architecture of its ``config.json`` and prints
``{"test_accuracy", "acc_ci95"}``.

Runs on the GPU by default and refuses to start without CUDA unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_arg_parser(train: bool) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=f"python -m induction_network_on_fewrel_tpu_torch.cli {'train' if train else 'test'}",
    )
    p.add_argument("--N", type=int, default=5, help="N-way")
    p.add_argument("--K", type=int, default=5, help="K-shot")
    p.add_argument("--Q", type=int, default=5, help="queries per class")
    p.add_argument("--batch_size", type=int, default=4, help="episodes per step")
    p.add_argument("--max_length", type=int, default=40)
    p.add_argument("--vocab_size", type=int, default=400002,
                   help="word-embedding rows incl. UNK/BLANK (the synthetic GloVe size)")
    p.add_argument("--lstm_hidden", type=int, default=128)
    p.add_argument("--induction_dim", type=int, default=100)
    p.add_argument("--ntn_slices", type=int, default=100)
    p.add_argument("--lstm_cs_window", type=int, default=8,
                   help="BiLSTM checkpoint window of the training route "
                        "(0 = the full-residual twin)")
    p.add_argument("--lstm_residuals", default="auto", choices=["auto", "f32", "bf16"],
                   help="storage dtype of the checkpoints or the cs stream "
                        "(auto = the compute dtype)")
    p.add_argument("--lstm_backend", default="auto", choices=["auto", "reference", "cuda"],
                   help="BiLSTM impl: auto = the CUDA kernels on the GPU, the plain "
                        "PyTorch version on the CPU; reference = the plain version "
                        "(any width); cuda = the kernels (4u <= 512)")
    p.add_argument("--attn_backend", default="auto", choices=["auto", "reference", "cuda"],
                   help="self-attention impl: auto = the CUDA kernels on the GPU, the "
                        "plain PyTorch version on the CPU")
    p.add_argument("--bf16", action="store_true", help="bf16 embedding + encoder")
    p.add_argument("--loss", default="mse", choices=["mse", "ce"])
    p.add_argument("--lr", type=float, default=1e-3)
    if train:
        p.add_argument("--train_iter", type=int, default=10000)
        p.add_argument("--val_iter", type=int, default=1000)
        p.add_argument("--val_step", type=int, default=1000)
    p.add_argument("--test_iter", type=int, default=3000)
    p.add_argument("--synthetic", action="store_true",
                   help="train and evaluate on the synthetic FewRel/GloVe fixtures "
                        "(the only data this slice reads)")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the GPU (refuses to start without CUDA)")
    p.add_argument("--save_ckpt", default="./checkpoint", help="checkpoint directory")
    p.add_argument("--load_ckpt", default=None, help="checkpoint directory to restore")
    p.add_argument("--seed", type=int, default=0)
    return p


def config_from_args(args):
    from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig

    kw = dict(
        n=args.N, k=args.K, q=args.Q, batch_size=args.batch_size, max_length=args.max_length, vocab_size=args.vocab_size,
        lstm_hidden=args.lstm_hidden, induction_dim=args.induction_dim,
        ntn_slices=args.ntn_slices, lstm_cs_window=args.lstm_cs_window,
        lstm_residuals=args.lstm_residuals, lstm_backend=args.lstm_backend,
        attn_backend=args.attn_backend,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        loss=args.loss, lr=args.lr, test_iter=args.test_iter, seed=args.seed,
    )
    if hasattr(args, "train_iter"):
        kw.update(train_iter=args.train_iter, val_iter=args.val_iter, val_step=args.val_step)
    return ExperimentConfig(**kw)


def load_data(cfg, split: str):
    """The synthetic split (seeds 0/1/2 for train/val/test, the JAX sizes)."""
    from induction_network_on_fewrel_tpu_torch.data import make_synthetic_fewrel

    return make_synthetic_fewrel(
        num_relations=cfg.n * 2,
        instances_per_relation=max(cfg.k + cfg.q + 5, 20),
        vocab_size=cfg.vocab_size - 2,
        seed={"train": 0, "val": 1, "test": 2}[split],
    )


def make_trainer(args, cfg, only_test: bool = False):
    """(trainer, test sampler): data, model (built on ``args.device``),
    samplers and logger. ``only_test`` builds the test split's sampler and
    no train/val samplers, logger file or checkpoint manager."""
    from induction_network_on_fewrel_tpu_torch.data import GloveTokenizer, make_synthetic_glove
    from induction_network_on_fewrel_tpu_torch.models.build import build_model
    from induction_network_on_fewrel_tpu_torch.sampling.episodes import EpisodeSampler
    from induction_network_on_fewrel_tpu_torch.train.framework import FewShotTrainer
    from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

    if not args.synthetic:
        raise SystemExit(
            "this slice reads no FewRel/GloVe files: pass --synthetic to run on the "
            "synthetic fixtures"
        )
    vocab = make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim)
    tok = GloveTokenizer(vocab, max_length=cfg.max_length)
    model = build_model(cfg, glove_init=vocab.vectors, device=args.device)

    def sampler(split, seed):
        return EpisodeSampler(load_data(cfg, split), tok, cfg.n, cfg.k, cfg.q,
                              batch_size=cfg.batch_size, na_rate=cfg.na_rate, seed=seed)

    train_s = None if only_test else sampler("train", cfg.seed)
    val_s = None if only_test else sampler("val", cfg.seed + 1)
    logger = MetricsLogger(None if only_test else args.save_ckpt)
    trainer = FewShotTrainer(model, cfg, train_s, val_s,
                             ckpt_dir=None if only_test else args.save_ckpt, logger=logger)
    return trainer, sampler("test", cfg.seed + 2) if only_test else None


def print_result(metrics: dict, key: str) -> None:
    """Human line (stderr, with the ±CI bar) + one JSON line (stdout)."""
    from induction_network_on_fewrel_tpu_torch.utils.metrics import json_sanitize

    acc, ci = metrics["accuracy"], metrics.get("acc_ci95", 0.0)
    print(f"{key.replace('_', ' ')}: {acc:.4f} ± {ci:.4f} (95% CI)", file=sys.stderr)
    out = {key: acc, "acc_ci95": ci}
    out.update({k: v for k, v in metrics.items() if k not in ("accuracy", "acc_ci95")})
    print(json.dumps({k: json_sanitize(round(v, 4) if isinstance(v, float) else v)
                      for k, v in out.items()}), flush=True)


def _merge_ckpt_architecture(cfg, src: str):
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager

    try:
        saved = CheckpointManager.load_config(src)
    except FileNotFoundError:
        return cfg
    merged = cfg.merge_architecture_from(saved)
    if merged != cfg:
        print(f"using architecture from {src}/config.json", file=sys.stderr)
    return merged


def train_main(argv=None) -> int:
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager

    args = build_arg_parser(train=True).parse_args(argv)
    cfg = config_from_args(args)
    if args.load_ckpt:
        cfg = _merge_ckpt_architecture(cfg, args.load_ckpt)
    trainer, _ = make_trainer(args, cfg)
    try:
        if args.load_ckpt:
            step = CheckpointManager(args.load_ckpt).restore_best(trainer.model, trainer.opt)
            print(f"restored best checkpoint step={step} from {args.load_ckpt}", file=sys.stderr)
        trainer.train(cfg.train_iter)
        if "best" in trainer.ckpt.written:
            step = trainer.ckpt.restore_best(trainer.model)
            print(f"final eval from best checkpoint (step {step})", file=sys.stderr)
        print_result(trainer.evaluate(cfg.val_iter, return_metrics=True), "final_val_accuracy")
        return 0
    finally:
        trainer.close()


def test_main(argv=None) -> int:
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager

    args = build_arg_parser(train=False).parse_args(argv)
    src = args.load_ckpt or args.save_ckpt
    if not os.path.isdir(src):
        print("test needs --load_ckpt (or an existing --save_ckpt dir)", file=sys.stderr)
        return 2
    cfg = _merge_ckpt_architecture(config_from_args(args), src)
    trainer, test_sampler = make_trainer(args, cfg, only_test=True)
    try:
        mngr = CheckpointManager(src)
        which = "best" if mngr.has("best") else "latest"
        step = mngr.restore(which, trainer.model)
        print(f"loaded {which} checkpoint step={step} from {src}", file=sys.stderr)
        metrics = trainer.evaluate(cfg.test_iter, sampler=test_sampler, return_metrics=True)
        trainer.logger.log(step, "test", **metrics)
        print_result(metrics, "test_accuracy")
        return 0
    finally:
        trainer.close()


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("train", "test"):
        print("usage: python -m induction_network_on_fewrel_tpu_torch.cli {train,test} [flags]",
              file=sys.stderr)
        return 2
    return (train_main if argv[0] == "train" else test_main)(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
