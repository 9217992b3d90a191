"""Carry weights between the JAX package and the torch port.

``params_from_jax(tree)`` takes the nested dict of arrays that the JAX
package's ``model.init(...)["params"]`` produces (or a restored checkpoint's
params) and returns a ``state_dict`` for the port's model of the same
config; ``params_to_jax(state_dict)`` goes back to a nested dict of numpy
arrays. Both directions are bitwise: every leaf is copied, and kernels
are only transposed, which moves values without rounding them.

The flagship's leaves are listed one by one (``PARAM_MAP``; encoder/att_w1
and att_w2 are explicit parameters, not Dense layers):

    embedding/{word,pos1,pos2}_embedding   embedding.*             as-is
    encoder/{w_ih,w_hh,bias,att_w1,att_w2} encoder.*               as-is
    induction/Dense_0/{kernel,bias}        induction.dense.*       kernel^T
    relation/tensor_slices                 relation.tensor_slices  as-is
    relation/Dense_0/{kernel,bias}         relation.dense.*        kernel^T
    query_proj/{kernel,bias}               query_proj.*            kernel^T
    nota_logit | nota_stats_{w,b}          same names              as-is

The zoo's leaves follow one rule: the torch name is the JAX path joined
with dots, a ``kernel`` leaf becomes ``weight`` and moves to torch's layout
by its rank (a Dense [in, out] -> [out, in]; a 1-D conv [W, in, out] ->
[out, in, W]; a 2-D conv [kh, kw, in, out] -> [out, in, kh, kw]), every
other leaf (LayerNorm ``scale``/``bias``, ``pos_embedding``, the heads'
explicit parameters) keeps its name and layout. ``ZOO_PATHS`` lists the
JAX paths the rule accepts: the CNN's and the transformer's encoder
layers, proto_hatt's convs and instance attention, siamese's metric,
gnn's adjacency MLPs and graph layers, snail's attention, causal-conv and
readout layers, metanet's slow head and meta-learner, the BERT backbone
(``encoder/backbone/...`` under a few-shot model, ``backbone/...`` under
BERT-PAIR) and BERT-PAIR's match head:

    backbone/tok_emb/embedding, pos_emb, seg_emb      same names, as-is
    backbone/ln_emb/{scale,bias}                      as-is
    backbone/layer_i/attention/{qkv,out}/kernel       .weight, kernel^T
    backbone/layer_i/{intermediate,mlp_out}/kernel    .weight, kernel^T
    backbone/layer_i/ln_{att,mlp}/{scale,bias}        as-is
    match_head/{kernel,bias}                          .weight (kernel^T), .bias

(BERT-PAIR's ``nota_logit`` is the flagship's leaf.) The transformer's
MoE blocks (``encoder/moe_i/router/{kernel,bias}`` a Dense;
``encoder/moe_i/experts_{up,down}[_bias]`` as-is, the expert kernels in
the JAX [E, in, out] layout) and the layer-stacked encoder
(``encoder/in_proj``, ``encoder/stack_*`` and ``encoder/final_ln_*``, as-is:
the stacked kernels are explicit [NL, in, out] parameters) follow the same
rule. A leaf outside both tables raises, in either direction.

Under tensor parallel a rank holds a share of each tp-sharded leaf
(``parallel/tensor.TP_RULES``): ``tp_slice(state_dict, tp, rank)`` cuts
a whole state dict (``params_from_jax``'s) to rank ``rank``'s of ``tp``
ranks, ``tp_join`` puts every rank's back together; the other leaves pass
whole.

``disc_params_from_jax`` / ``disc_params_to_jax`` carry the adversarial
step's discriminator (``fc1``, ``fc2``, ``out``: Dense layers) the same
way. ``config_from_jax`` carries a JAX ``ExperimentConfig`` (or its
``config.json`` dict) into the port's by field name, the data-parallel
knobs (``dp``, ``zero_opt``, ``compact_demb``, ``grad_bucketing``,
``grad_bucket_count``, ``async_collectives``) among them; the port's
``config.json`` loads into the JAX config the same way.
"""

from __future__ import annotations

from typing import Mapping

import re

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


# The zoo's JAX paths (joined with "/") that map by the rule.
ZOO_PATHS = re.compile("|".join([
    r"encoder/Conv_0/(kernel|bias)",
    r"encoder/(in_proj|(qkv|att_out|intermediate|mlp_out)_\d+)/(kernel|bias)",
    r"encoder/((ln_att|ln_mlp)_\d+|ln_final)/(scale|bias)",
    r"encoder/pos_embedding",
    r"encoder/moe_\d+/router/(kernel|bias)",
    r"encoder/moe_\d+/experts_(up|down)(_bias)?",
    r"encoder/stack_(ln[12]_(scale|bias)|qkv_[wb]|att_out_[wb]|mlp_(up|down)_[wb])",
    r"encoder/final_ln_(scale|bias)",
    r"(Conv_[012]|Dense_0)/(kernel|bias)",
    r"metric_[wvb]",
    r"adj_(\d+|out)/Dense_[012]/(kernel|bias)",
    r"gc_(\d+|out)/(kernel|bias)",
    r"att_[123]/[qkv]/(kernel|bias)",
    r"tc_[12]/cc_\d+/(filter|gate)/(kernel|bias)",
    r"out/(kernel|bias)",
    r"w_slow",
    r"meta_[ab][12]",
    r"(encoder/)?backbone/(tok_emb/embedding|pos_emb|seg_emb)",
    r"(encoder/)?backbone/(ln_emb|layer_\d+/ln_(att|mlp))/(scale|bias)",
    r"(encoder/)?backbone/layer_\d+/(attention/(qkv|out)|intermediate|mlp_out)/(kernel|bias)",
    r"match_head/(kernel|bias)",
]))
# Kernel rank -> the permutation from JAX's layout to torch's.
TO_TORCH = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}
TO_JAX = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, object]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _zoo_path(name: str) -> tuple | None:
    """The JAX path of a torch name under the zoo's rule, or None."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return tuple(parts) if ZOO_PATHS.fullmatch("/".join(parts)) else None


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """JAX param tree -> port state_dict (CPU tensors). Raises on a leaf
    neither table knows, so nothing is dropped silently."""
    flat = _flatten(tree)
    known = {path: (name, tr) for path, name, tr in PARAM_MAP}
    unknown = sorted("/".join(p) for p in flat
                     if p not in known and not ZOO_PATHS.fullmatch("/".join(p)))
    if unknown:
        raise KeyError(f"JAX params without a torch counterpart: {unknown}")
    sd = {}
    for path, leaf in flat.items():
        arr = np.asarray(leaf)
        if path in known:
            name, tr = known[path]
            arr = arr.T if tr else arr
        else:
            name = ".".join(path[:-1] + ("weight" if path[-1] == "kernel" else path[-1],))
            arr = arr.transpose(TO_TORCH[arr.ndim]) if path[-1] == "kernel" else arr
        sd[name] = torch.from_numpy(np.array(arr, order="C"))
    return sd


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """Port state_dict -> nested dict of numpy arrays in the JAX layout."""
    known = {name: (path, tr) for path, name, tr in PARAM_MAP}
    unknown = sorted(n for n in state_dict if n not in known and _zoo_path(n) is None)
    if unknown:
        raise KeyError(f"torch params without a JAX counterpart: {unknown}")
    tree: dict = {}
    for name, t in state_dict.items():
        arr = t.detach().cpu().numpy()
        if name in known:
            path, tr = known[name]
            arr = arr.T if tr else arr
        else:
            path = _zoo_path(name)
            arr = arr.transpose(TO_JAX[arr.ndim]) if path[-1] == "kernel" else arr
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.array(arr, order="C")    # keeps a 0-d leaf 0-d
    return tree


def tp_slice(state_dict: Mapping[str, torch.Tensor], tp: int, rank: int) -> dict:
    """Rank ``rank``'s share of a whole port state_dict under ``tp`` ranks:
    each tp-sharded leaf cut to its 1/tp along its axis (the JAX
    ``NamedSharding`` of ``_TP_RULES``), the rest as-is."""
    from induction_network_on_fewrel_tpu_torch.parallel.tensor import tp_axis

    out = {}
    for name, t in state_dict.items():
        axis = tp_axis(name, t.ndim)
        if axis is not None:
            n = t.shape[axis] // tp
            t = t.narrow(axis, rank * n, n)
        out[name] = t
    return out


def tp_join(slices: list) -> dict:
    """Every tp rank's state_dict (in rank order) -> the whole one."""
    from induction_network_on_fewrel_tpu_torch.parallel.tensor import tp_axis

    out = {}
    for name, t in slices[0].items():
        axis = tp_axis(name, t.ndim)
        out[name] = t if axis is None else torch.cat([s[name] for s in slices], dim=axis)
    return out


DISC_PATHS = re.compile(r"(fc1|fc2|out)/(kernel|bias)")


def disc_params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``DomainDiscriminator`` params -> the port's state_dict."""
    flat = _flatten(tree)
    unknown = sorted("/".join(p) for p in flat if not DISC_PATHS.fullmatch("/".join(p)))
    if unknown:
        raise KeyError(f"discriminator params without a torch counterpart: {unknown}")
    out = {}
    for (layer, leaf), arr in flat.items():
        arr = np.asarray(arr)
        name = f"{layer}.{'weight' if leaf == 'kernel' else 'bias'}"
        out[name] = torch.from_numpy(np.array(arr.T if leaf == "kernel" else arr, order="C"))
    return out


def disc_params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The port's discriminator state_dict -> the JAX params tree."""
    tree: dict = {}
    for name, t in state_dict.items():
        layer, leaf = name.split(".")
        if not DISC_PATHS.fullmatch(f"{layer}/{'kernel' if leaf == 'weight' else leaf}"):
            raise KeyError(f"discriminator param without a JAX counterpart: {name}")
        arr = t.detach().cpu().numpy()
        tree.setdefault(layer, {})["kernel" if leaf == "weight" else "bias"] = np.array(
            arr.T if leaf == "weight" else arr, order="C")
    return tree


def config_from_jax(jax_cfg):
    """The port's ``ExperimentConfig`` holding every field of ``jax_cfg`` (a
    JAX ``ExperimentConfig`` or its ``config.json`` dict) that the port's
    config has, by name; the others are dropped."""
    import dataclasses

    from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig

    fields = (jax_cfg if isinstance(jax_cfg, Mapping)
              else {f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(jax_cfg)})
    names = {f.name for f in dataclasses.fields(ExperimentConfig)}
    return ExperimentConfig(**{k: v for k, v in fields.items() if k in names})
