"""Schema-faithful synthetic FewRel data + GloVe fixtures.

There are no FewRel/GloVe files in the repository and nothing can be
downloaded, so the serving path runs against synthetic fixtures that obey
the real schemas exactly. The generator plants a learnable signal: each
relation owns a small set of "trigger" words that appear only in its
sentences.

A copy of ``make_synthetic_glove`` / ``make_synthetic_fewrel`` from
``induction_network_on_fewrel_tpu/data/synthetic.py``: the same numpy draws
in the same order, so a seed gives identical output in both packages
(pinned in tests/test_torch_serving.py); ``make_domain_shifted_fewrel``
likewise (tests/test_torch_adversarial.py).
"""

from __future__ import annotations

import numpy as np

from induction_network_on_fewrel_tpu_torch.data.fewrel import FewRelDataset, Instance
from induction_network_on_fewrel_tpu_torch.data.glove import GloveVocab


def make_synthetic_glove(
    vocab_size: int = 200, word_dim: int = 50, seed: int = 0
) -> GloveVocab:
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab_size)]
    vecs = rng.normal(0, 0.5, (vocab_size, word_dim)).astype(np.float32)
    return GloveVocab.from_words(words, vecs)


def make_synthetic_fewrel(
    num_relations: int = 10,
    instances_per_relation: int = 30,
    vocab_size: int = 200,
    sentence_len: tuple[int, int] = (8, 20),
    triggers_per_relation: int = 3,
    seed: int = 0,
) -> FewRelDataset:
    """Generate a FewRel-schema dataset whose relations are identifiable.

    Each relation r reserves ``triggers_per_relation`` exclusive vocabulary
    words; each of its sentences contains 1-3 of them at random positions.
    Head/tail entity mentions are random single-token spans, exercising the
    position-offset features.
    """
    rng = np.random.default_rng(seed)
    n_trigger = num_relations * triggers_per_relation
    if vocab_size <= n_trigger + 10:
        raise ValueError("vocab too small for distinct trigger words")

    relations: dict[str, list[Instance]] = {}
    for r in range(num_relations):
        trig = [f"w{r * triggers_per_relation + t}" for t in range(triggers_per_relation)]
        insts = []
        for _ in range(instances_per_relation):
            L = int(rng.integers(*sentence_len))
            toks = [f"w{int(i)}" for i in rng.integers(n_trigger, vocab_size, L)]
            for t in rng.choice(trig, size=int(rng.integers(1, 4)), replace=True):
                toks[int(rng.integers(0, L))] = t
            h, t_ = rng.choice(L, 2, replace=False)
            insts.append(
                Instance(
                    tokens=tuple(toks),
                    head_pos=(int(h),),
                    tail_pos=(int(t_),),
                    head_name=toks[int(h)],
                    tail_name=toks[int(t_)],
                )
            )
        relations[f"P{9000 + r}"] = insts
    return FewRelDataset(relations)


def make_domain_shifted_fewrel(
    num_relations: int = 10,
    instances_per_relation: int = 30,
    vocab_size: int = 200,
    sentence_len: tuple[int, int] = (8, 20),
    triggers_per_relation: int = 3,
    shift: float = 1.0,
    seed: int = 0,
) -> FewRelDataset:
    """A domain-shifted twin of ``make_synthetic_fewrel``: the same relation
    names and episode geometry, but each occurrence of a relation's trigger
    word moves, with probability ``shift``, to a disjoint vocabulary block
    (relation r's trigger t becomes word ``n_trigger + r*tpr + t`` instead
    of ``r*tpr + t``). The synthetic analog of FewRel 2.0's wiki -> pubmed
    transfer: relation semantics unchanged, the surface vocabulary not.
    ``shift=0.0`` keeps the source trigger placement (with an independent
    sentence draw); pass the source dataset's ``seed`` so relation names
    line up."""
    if not 0.0 <= shift <= 1.0:
        raise ValueError(f"shift must be in [0, 1], got {shift}")
    rng = np.random.default_rng(seed + 0x5D1F7)
    n_trigger = num_relations * triggers_per_relation
    if vocab_size <= 2 * n_trigger + 10:
        raise ValueError("vocab too small for disjoint source+shifted trigger blocks")

    relations: dict[str, list[Instance]] = {}
    for r in range(num_relations):
        src_trig = [f"w{r * triggers_per_relation + t}" for t in range(triggers_per_relation)]
        tgt_trig = [f"w{n_trigger + r * triggers_per_relation + t}"
                    for t in range(triggers_per_relation)]
        insts = []
        for _ in range(instances_per_relation):
            L = int(rng.integers(*sentence_len))
            # Background words start past both trigger blocks.
            toks = [f"w{int(i)}" for i in rng.integers(2 * n_trigger, vocab_size, L)]
            for _ in range(int(rng.integers(1, 4))):
                which = int(rng.integers(triggers_per_relation))
                word = tgt_trig[which] if rng.random() < shift else src_trig[which]
                toks[int(rng.integers(0, L))] = word
            h, t_ = rng.choice(L, 2, replace=False)
            insts.append(
                Instance(
                    tokens=tuple(toks),
                    head_pos=(int(h),),
                    tail_pos=(int(t_),),
                    head_name=toks[int(h)],
                    tail_name=toks[int(t_)],
                )
            )
        relations[f"P{9000 + r}"] = insts
    return FewRelDataset(relations)
