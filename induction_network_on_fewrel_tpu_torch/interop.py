"""Carry weights between the JAX package and the torch port.

``params_from_jax(tree)`` takes the nested dict of arrays that the JAX
package's ``model.init(...)["params"]`` produces (or a restored checkpoint's
params) and returns a ``state_dict`` for the port's ``InductionNetwork``;
``params_to_jax(state_dict)`` goes back to a nested dict of numpy arrays.
Both directions are bitwise: every leaf is copied, and the Dense kernels
([in, out] in JAX, [out, in] in torch) are transposed, which moves values
without rounding them.

The map follows the real parameter tree (encoder/att_w1 and att_w2 are
explicit parameters, not Dense layers):

    embedding/{word,pos1,pos2}_embedding   embedding.*             as-is
    encoder/{w_ih,w_hh,bias,att_w1,att_w2} encoder.*               as-is
    induction/Dense_0/{kernel,bias}        induction.dense.*       kernel^T
    relation/tensor_slices                 relation.tensor_slices  as-is
    relation/Dense_0/{kernel,bias}         relation.dense.*        kernel^T
    query_proj/{kernel,bias}               query_proj.*            kernel^T
    nota_logit | nota_stats_{w,b}          same names              as-is
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

# (JAX path, torch name, transpose)
PARAM_MAP = (
    (("embedding", "word_embedding"), "embedding.word_embedding", False),
    (("embedding", "pos1_embedding"), "embedding.pos1_embedding", False),
    (("embedding", "pos2_embedding"), "embedding.pos2_embedding", False),
    (("encoder", "w_ih"), "encoder.w_ih", False),
    (("encoder", "w_hh"), "encoder.w_hh", False),
    (("encoder", "bias"), "encoder.bias", False),
    (("encoder", "att_w1"), "encoder.att_w1", False),
    (("encoder", "att_w2"), "encoder.att_w2", False),
    (("induction", "Dense_0", "kernel"), "induction.dense.weight", True),
    (("induction", "Dense_0", "bias"), "induction.dense.bias", False),
    (("relation", "tensor_slices"), "relation.tensor_slices", False),
    (("relation", "Dense_0", "kernel"), "relation.dense.weight", True),
    (("relation", "Dense_0", "bias"), "relation.dense.bias", False),
    (("query_proj", "kernel"), "query_proj.weight", True),
    (("query_proj", "bias"), "query_proj.bias", False),
    (("nota_logit",), "nota_logit", False),
    (("nota_stats_w",), "nota_stats_w", False),
    (("nota_stats_b",), "nota_stats_b", False),
)


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, object]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """JAX param tree -> port state_dict (CPU tensors). Raises on a leaf
    the map does not know, so nothing is dropped silently."""
    flat = _flatten(tree)
    known = {path: (name, tr) for path, name, tr in PARAM_MAP}
    unknown = sorted("/".join(p) for p in flat if p not in known)
    if unknown:
        raise KeyError(f"JAX params without a torch counterpart: {unknown}")
    sd = {}
    for path, leaf in flat.items():
        name, tr = known[path]
        arr = np.asarray(leaf)
        sd[name] = torch.from_numpy(np.array(arr.T if tr else arr, order="C"))
    return sd


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """Port state_dict -> nested dict of numpy arrays in the JAX layout."""
    known = {name: (path, tr) for path, name, tr in PARAM_MAP}
    unknown = sorted(n for n in state_dict if n not in known)
    if unknown:
        raise KeyError(f"torch params without a JAX counterpart: {unknown}")
    tree: dict = {}
    for name, t in state_dict.items():
        path, tr = known[name]
        arr = t.detach().cpu().numpy()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(arr.T if tr else arr)
    return tree
