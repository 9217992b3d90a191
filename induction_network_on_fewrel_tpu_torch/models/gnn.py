"""Few-shot graph neural network (Garcia & Bruna, ICLR 2018).

Counterpart of ``induction_network_on_fewrel_tpu/models/gnn.py`` (``GNN``,
``_AdjacencyMLP``). One graph per query: T = N·K + 1 nodes, the query
first (label features uniform 1/N), then the supports (their one-hot
labels); node features are the sentence encoding ⧺ the label features.
Each of ``gnn_blocks`` blocks learns an adjacency ``A = softmax_j
MLP(|x_i - x_j|)`` (``adj_<i>``: three Dense layers, leaky ReLU, self-edges
masked with -1e9, softmax in f32) and grows the features by
``leaky_relu(gc_<i>([x, A x]))``; ``adj_out``/``gc_out`` read the N
logits off the query node. Everything in the compute dtype, all B·TQ
graphs as one batch.

The adjacency's pairs follow the JAX forms. Up to ``ONE_HOT_MAX_T`` nodes,
the MLP runs over the T(T-1)/2 unordered pairs, picked by one-hot
matmuls, and a one-hot matmul puts each value back at (i, j) and (j, i)
(the diagonal at a -1e9 pad slot); above it, over all T² ordered pairs
(broadcast). Both are deterministic: there is no index gather, whose
backward would be an atomic scatter-add on the card. The selection,
reconstruction and diagonal constants depend only on T: they are made on
the device at the first forward of each T and kept (``_constants``), so a
CUDA graph's warm-up makes them and the capture only reads them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from induction_network_on_fewrel_tpu_torch.models.base import FewShotModel
from induction_network_on_fewrel_tpu_torch.models.layers import Dense

ONE_HOT_MAX_T = 64


def _pair_constants(T: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(sel1 [P, T], sel2 [P, T], recon [T², P+1]) one-hot matrices of the
    strict upper triangle's P = T(T-1)/2 pairs (JAX gnn.py:100-125)."""
    iu, ju = np.triu_indices(T, k=1)
    P = iu.shape[0]
    sel1 = np.zeros((P, T), np.float32)
    sel1[np.arange(P), iu] = 1.0
    sel2 = np.zeros((P, T), np.float32)
    sel2[np.arange(P), ju] = 1.0
    pair_id = np.full((T, T), P, np.int64)
    pair_id[iu, ju] = np.arange(P)
    pair_id[ju, iu] = np.arange(P)
    recon = np.zeros((T * T, P + 1), np.float32)
    recon[np.arange(T * T), pair_id.reshape(-1)] = 1.0
    return sel1, sel2, recon


class _AdjacencyMLP(nn.Module):
    """[G, T, F] node features -> [G, T, T] row-stochastic adjacency."""

    def __init__(self, in_dim: int, hidden: int, compute_dtype: torch.dtype,
                 one_hot_max_t: int = ONE_HOT_MAX_T, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.Dense_0 = Dense(in_dim, hidden, compute_dtype, **kw)
        self.Dense_1 = Dense(hidden, hidden, compute_dtype, **kw)
        self.Dense_2 = Dense(hidden, 1, compute_dtype, **kw)
        self.compute_dtype = compute_dtype
        self.one_hot_max_t = one_hot_max_t
        self._cache: dict = {}

    def _constants(self, T: int, device) -> tuple:
        key = (T, device)
        if key not in self._cache:
            with torch.inference_mode(False):     # tensors autograd may save
                self._cache[key] = self._make_constants(T, device)
        return self._cache[key]

    def _make_constants(self, T: int, device) -> tuple:
        if T > self.one_hot_max_t:
            diag = np.where(np.eye(T, dtype=bool), -1e9, 0.0).astype(np.float32)
            return (torch.from_numpy(diag).to(device),)
        cd = self.compute_dtype
        sel1, sel2, recon = (torch.from_numpy(a).to(device) for a in _pair_constants(T))
        return sel1.to(cd), sel2.to(cd), recon.T.contiguous()

    def mlp(self, diff: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.Dense_0(diff))
        h = F.leaky_relu(self.Dense_1(h))
        return self.Dense_2(h)[..., 0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        G, T, _ = x.shape
        cd = self.compute_dtype
        if T > self.one_hot_max_t:
            (diag,) = self._constants(T, x.device)
            diff = (x[:, :, None, :] - x[:, None, :, :]).abs()
            logit = self.mlp(diff).float() + diag                 # [G, T, T]
            return torch.softmax(logit, dim=-1).to(cd)
        sel1, sel2, recon_t = self._constants(T, x.device)
        diff = (torch.matmul(sel1, x) - torch.matmul(sel2, x)).abs()   # [G, P, F]
        logit_p = self.mlp(diff).float()                          # [G, P]
        pad = torch.full((G, 1), -1e9, dtype=torch.float32, device=x.device)
        logit = torch.matmul(torch.cat([logit_p, pad], dim=1), recon_t).reshape(G, T, T)
        return torch.softmax(logit, dim=-1).to(cd)


class GNN(FewShotModel):
    def __init__(self, embedding, encoder, n: int, gnn_dim: int = 64, gnn_blocks: int = 2,
                 adj_hidden: int = 64, nota: bool = False, nota_head: str = "scalar",
                 compute_dtype: torch.dtype = torch.float32,
                 head_dtype: torch.dtype = torch.float32, *, device,
                 generator: torch.Generator):
        super().__init__(embedding, encoder, nota, nota_head, head_dtype, device)
        cd = compute_dtype
        kw = dict(device=device, generator=generator)
        feat = encoder.output_dim + n
        for i in range(gnn_blocks):
            self.add_module(f"adj_{i}", _AdjacencyMLP(feat, adj_hidden, cd, **kw))
            self.add_module(f"gc_{i}", Dense(2 * feat, gnn_dim, cd, **kw))
            feat += gnn_dim
        self.adj_out = _AdjacencyMLP(feat, adj_hidden, cd, **kw)
        self.gc_out = Dense(2 * feat, n, cd, **kw)
        self.gnn_blocks, self.compute_dtype = gnn_blocks, cd

    def forward(self, support: dict, query: dict) -> torch.Tensor:
        sup_enc, qry_enc = self.encode_episode(support, query)
        B, N, K, H = sup_enc.shape
        TQ = qry_enc.shape[1]
        cd, T = self.compute_dtype, N * K + 1
        eye = torch.eye(N, dtype=cd, device=sup_enc.device)
        sup_nodes = torch.cat([sup_enc.to(cd), eye[None, :, None, :].expand(B, N, K, N)], -1)
        sup_nodes = sup_nodes.reshape(B, 1, N * K, H + N).expand(B, TQ, N * K, H + N)
        qry_lab = torch.full((B, TQ, 1, N), 1.0 / N, dtype=cd, device=qry_enc.device)
        qry_nodes = torch.cat([qry_enc.to(cd)[:, :, None, :], qry_lab], -1)
        x = torch.cat([qry_nodes, sup_nodes], dim=2).reshape(B * TQ, T, H + N)

        for i in range(self.gnn_blocks):
            A = self.get_submodule(f"adj_{i}")(x)
            new = self.get_submodule(f"gc_{i}")(torch.cat([x, torch.matmul(A, x)], -1))
            x = torch.cat([x, F.leaky_relu(new)], -1)
        A = self.adj_out(x)
        logits = self.gc_out(torch.cat([x, torch.matmul(A, x)], -1))[:, 0, :]
        return self.append_nota(logits.reshape(B, TQ, N).float()).float()
