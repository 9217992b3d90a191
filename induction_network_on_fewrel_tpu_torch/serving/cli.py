"""Serving demo entry point: fresh-init synthetic engine, one verdict per line.

The counterpart of what ``python serve.py`` runs with no arguments in the
JAX package (``serving/cli.py`` ``_fresh_engine`` + ``_demo``): a synthetic
GloVe vocabulary, fresh-init induction weights from ``--seed``, a synthetic
FewRel corpus whose first N relations register at K shots, then held-out
instances of those relations classified in bucketed batches. The serving
machinery is the real one; only the verdict quality is untrained.

    python -m induction_network_on_fewrel_tpu_torch.serving.cli \\
        --N 5 --K 5 --num_queries 16 --seed 0 [--device cpu]

Runs on the GPU by default and refuses to start without CUDA unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def fresh_engine(N: int, K: int, seed: int, device=None):
    """(engine, support dataset): synthetic vocab + fresh-init weights,
    the first N relations registered at K shots."""
    from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
    from induction_network_on_fewrel_tpu_torch.data import (
        GloveTokenizer,
        make_synthetic_fewrel,
        make_synthetic_glove,
    )
    from induction_network_on_fewrel_tpu_torch.models.build import build_model
    from induction_network_on_fewrel_tpu_torch.serving.engine import InferenceEngine

    cfg = ExperimentConfig(n=N, k=K, vocab_size=2002, seed=seed)   # 2000 words + UNK/BLANK
    vocab = make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim)
    tok = GloveTokenizer(vocab, max_length=cfg.max_length)
    model = build_model(cfg, glove_init=vocab.vectors, device=device)
    engine = InferenceEngine(model, cfg, tok, k=K, device=device)
    ds = make_synthetic_fewrel(
        num_relations=max(10, N), instances_per_relation=max(K + 10, 20),
        vocab_size=cfg.vocab_size - 2, seed=seed,
    )
    engine.register_dataset(ds, max_classes=N)
    return engine, ds


def demo(engine, ds, num_queries: int, seed: int = 0) -> list[dict]:
    """Classify held-out instances (after the K supports) of the registered
    relations; print one JSON verdict per line and the accuracy to stderr."""
    rng = np.random.default_rng(seed)
    k = engine.registry.k
    pool = [
        (rel, inst)
        for rel in engine.class_names
        for inst in ds.instances[rel][k:]
    ]
    picks = rng.choice(len(pool), size=min(num_queries, len(pool)), replace=False)
    chosen = [pool[int(i)] for i in picks]
    verdicts = engine.classify_batch([inst for _, inst in chosen])
    hits = 0
    for (rel, _), v in zip(chosen, verdicts):
        hits += v["label"] == rel
        print(json.dumps({"true": rel, **v}), flush=True)
    print(f"demo accuracy: {hits}/{len(chosen)}", file=sys.stderr)
    return verdicts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--N", type=int, default=5, help="relations registered")
    p.add_argument("--K", type=int, default=5, help="support shots per relation")
    p.add_argument("--num_queries", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)
    engine, ds = fresh_engine(args.N, args.K, args.seed, device=args.device)
    print("serving FRESH-INIT synthetic weights (demo only) on "
          f"{engine.model.device}", file=sys.stderr)
    demo(engine, ds, args.num_queries, seed=args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
