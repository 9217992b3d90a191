"""FewRel dataset schema and loader.

FewRel JSON (Han et al., EMNLP 2018) maps relation name -> list of instances;
each instance is ``{"tokens": [str, ...], "h": [name, wikidata_id,
[[head token positions]]], "t": [same for tail]}`` (SURVEY.md §2.1 "Dataset
loader" row). This module parses that schema into plain-Python structures;
all array work happens downstream in the tokenizer so this layer stays
numpy/torch-free and trivially testable.

A copy of ``induction_network_on_fewrel_tpu/data/fewrel.py``: the torch
port keeps its own copy of every module it needs and imports nothing of
the JAX package. No torch Dataset/DataLoader machinery: the "dataset" is
just an indexed store.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class Instance:
    """One sentence with marked head/tail entity mentions."""

    tokens: tuple[str, ...]
    head_pos: tuple[int, ...]   # token indices of the head mention (first span)
    tail_pos: tuple[int, ...]   # token indices of the tail mention (first span)
    head_name: str = ""
    tail_name: str = ""

    @classmethod
    def from_raw(cls, raw: Mapping) -> "Instance":
        h, t = raw["h"], raw["t"]
        # Positions nest as [[span1 indices], [span2 indices], ...]; the
        # first span is the mention used for position features.
        return cls(
            tokens=tuple(raw["tokens"]),
            head_pos=tuple(h[2][0]),
            tail_pos=tuple(t[2][0]),
            head_name=str(h[0]),
            tail_name=str(t[0]),
        )


class FewRelDataset:
    """Relation-indexed store of instances.

    ``rel_names`` fixes a deterministic relation ordering so that a seeded
    sampler draws identical episodes across runs and hosts (multi-host data
    parallelism shards episodes by index, so determinism is load-bearing).
    """

    def __init__(self, relations: Mapping[str, Sequence[Instance]]):
        if not relations:
            raise ValueError("FewRelDataset needs at least one relation")
        self.rel_names: tuple[str, ...] = tuple(sorted(relations))
        self.instances: dict[str, tuple[Instance, ...]] = {
            r: tuple(relations[r]) for r in self.rel_names
        }
        for r, insts in self.instances.items():
            if not insts:
                raise ValueError(f"relation {r!r} has no instances")

    @property
    def num_relations(self) -> int:
        return len(self.rel_names)

    def __repr__(self) -> str:
        n_inst = sum(len(v) for v in self.instances.values())
        return f"FewRelDataset({self.num_relations} relations, {n_inst} instances)"


def load_fewrel_json(path: str | Path) -> FewRelDataset:
    """Load a FewRel-schema JSON file (train_wiki/val_wiki/val_pubmed style)."""
    with open(path) as f:
        raw = json.load(f)
    return FewRelDataset(
        {rel: [Instance.from_raw(x) for x in insts] for rel, insts in raw.items()}
    )
