"""Ring attention: the sequence-parallel executor over the sp axis.

Counterpart of ``induction_network_on_fewrel_tpu/parallel/ring.py`` and of
what GSPMD makes of the transformer encoder (``models/transformer.py``) on
a mesh with an sp axis. There the token axis of ``word``/``pos1``/``pos2``/
``mask`` shards over sp (``episode_batch_shardings``), attention runs as
``ring_attention_local`` inside ``shard_map`` and the partitioner splits the
rest of the encoder per token. Here every sp rank of a dp slice holds the
same episodes (``parallel/hostfeed.py``), and the encoder runs on the rank's
``L/sp`` token columns (``SequenceShard``, attached by ``attach_sequence``):

* ``columns`` keeps the rank's columns of every token leaf at the model's
  input (``models/base.FewShotModel.encode``), so the embedding, the
  projections, LayerNorm and the MLP run on its tokens only;
* the learned ``pos_embedding`` takes the rows of the rank's token offset
  (``offset``): its gradient lands on those rows alone;
* attention is the ring (``RingAttention``, the JAX ``ring_attention_local``):
  each rank keeps its query block; k, v and the key mask travel one hop a
  step around the sp group (``ring_hop``: the JAX ``ppermute``, the
  neighbour exchange ``grad_buckets.neighbour_hop`` that the GPipe schedule
  shares, O(L/sp) a hop, never an all-gather); the online max
  and denominator run in f32 and a masked score is -1e30. The forward makes
  ``sp - 1`` hops (the JAX scan's last hop only brings the blocks home).
  Its backward is the mirrored ring, spelled by hand: it recomputes each
  block's scores from the saved queries, the travelling keys and the
  forward's log-sum-exp (nothing of size L·L/sp is saved), and each block's
  dk and dv accumulators travel with it, gathering every rank's share, for
  ``sp`` hops until they are back at the block's owner;
* the masked-mean pooling all-reduces its sum and its count over sp
  (``pool``; backward identity: every sp rank holds the same loss), so the
  sentence vectors, and everything above them, are the same on every sp
  rank;
* gradients: a leaf below the pooling (``embedding.*``, ``encoder.*``, the
  lazy table's rows) gets a partial over the rank's tokens, summed over
  the sp group before the dp average (``DataParallel.finish``,
  "sp/grad_allreduce"); a leaf above it is the same on every sp rank.

Each collective is counted in ``parallel/grad_buckets.COLLECTIVES`` where
it is issued: "sp/ring_hop" (forward and backward hops), "sp/pool_allreduce".
"""

from __future__ import annotations

import math

import torch

from induction_network_on_fewrel_tpu_torch.parallel.grad_buckets import SumOut, neighbour_hop

_NEG = -1e30


def dense_attention(q, k, v, kv_mask=None):
    """O(L²) attention, a copy of the JAX ``parallel/ring.py:42``. q, k, v:
    [M, H, L, hd]; kv_mask: [M, L]. Scores in q's dtype, masked keys set
    to -1e30, softmax in f32, the weighted sum in q's dtype."""
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :] > 0, s, torch.full_like(s, _NEG))
    p = torch.softmax(s.float(), dim=-1)
    return torch.matmul(p.to(q.dtype), v)


def ring_hop(buf: torch.Tensor, shard: "SequenceShard") -> torch.Tensor:
    """``buf`` (1-D) to the next rank of the sp ring; the previous rank's,
    back (``grad_buckets.neighbour_hop``)."""
    return neighbour_hop(buf, shard.group, shard.sp, shard.next_index, shard.prev_index,
                         "sp/ring_hop")


def _pack(*ts: torch.Tensor) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in ts])


def _unpack(buf: torch.Tensor, like: tuple) -> list:
    out, off = [], 0
    for t in like:
        out.append(buf[off:off + t.numel()].view_as(t))
        off += t.numel()
    return out


def _scores(q32, k_blk, msk, scale):
    s = torch.matmul(q32, k_blk.transpose(-1, -2)) * scale
    return torch.where(msk[:, None, None, :] > 0, s, torch.full_like(s, _NEG))


class RingAttention(torch.autograd.Function):
    """q, k, v [M, H, Lc, hd] (this rank's token block), kv_mask [M, Lc] ->
    [M, H, Lc, hd] in q's dtype: attention of the rank's queries over every
    rank's keys, the blocks travelling the sp ring."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, shard):
        scale = 1.0 / math.sqrt(q.shape[-1])
        q32, k32, v32 = q.float(), k.float(), v.float()
        msk = (kv_mask > 0).float()
        M, H, Lc, _ = q.shape
        m = torch.full((M, H, Lc), _NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((M, H, Lc), dtype=torch.float32, device=q.device)
        acc = torch.zeros_like(q32)
        k_blk, v_blk, m_blk = k32, v32, msk
        for step in range(shard.sp):
            s = _scores(q32, k_blk, m_blk, scale)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.matmul(p, v_blk)
            m = m_new
            if step + 1 < shard.sp:
                k_blk, v_blk, m_blk = _unpack(ring_hop(_pack(k_blk, v_blk, m_blk), shard),
                                              (k32, v32, msk))
        out32 = acc / (l[..., None] + 1e-30)
        lse = m + torch.log(l + 1e-30)
        ctx.save_for_backward(q32, k32, v32, msk, out32, lse)
        ctx.shard, ctx.scale, ctx.dtypes = shard, scale, (q.dtype, k.dtype, v.dtype)
        return out32.to(q.dtype)

    @staticmethod
    def backward(ctx, grad_out):
        q32, k32, v32, msk, out32, lse = ctx.saved_tensors
        shard, scale = ctx.shard, ctx.scale
        do = grad_out.float()
        delta = (do * out32).sum(-1)                                  # [M, H, Lc]
        dq = torch.zeros_like(q32)
        k_blk, v_blk, m_blk = k32, v32, msk
        dk_blk, dv_blk = torch.zeros_like(k32), torch.zeros_like(v32)
        for step in range(shard.sp):
            s = _scores(q32, k_blk, m_blk, scale)
            p = torch.exp(s - lse[..., None])
            dv_blk = dv_blk + torch.matmul(p.transpose(-1, -2), do)
            dp = torch.matmul(do, v_blk.transpose(-1, -2))
            ds = p * (dp - delta[..., None])
            ds = torch.where(m_blk[:, None, None, :] > 0, ds, torch.zeros_like(ds)) * scale
            dq = dq + torch.matmul(ds, k_blk)
            dk_blk = dk_blk + torch.matmul(ds.transpose(-1, -2), q32)
            if step + 1 < shard.sp:
                k_blk, v_blk, m_blk, dk_blk, dv_blk = _unpack(
                    ring_hop(_pack(k_blk, v_blk, m_blk, dk_blk, dv_blk), shard),
                    (k32, v32, msk, k32, v32))
            else:           # the last hop: each block's gradients home to its owner
                dk_blk, dv_blk = _unpack(ring_hop(_pack(dk_blk, dv_blk), shard), (k32, v32))
        qd, kd, vd = ctx.dtypes
        return dq.to(qd), dk_blk.to(kd), dv_blk.to(vd), None, None


class SequenceShard:
    """This rank's place on the sp axis: ``sp`` ranks over ``group``, this
    one ``sp_rank``, holding token columns [offset, offset + L/sp)."""

    def __init__(self, mesh):
        self.sp, self.sp_rank, self.group = mesh.sp, mesh.sp_rank, mesh.sp_group
        self.next_index = (self.sp_rank + 1) % self.sp
        self.prev_index = (self.sp_rank - 1) % self.sp
        self.offset = 0

    def columns(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's columns of a [..., L] token leaf
        (``parallel/hostfeed.local_token_columns``; the first one's index
        is kept as ``offset``)."""
        from induction_network_on_fewrel_tpu_torch.parallel.hostfeed import local_token_columns

        self.offset, n = local_token_columns(self, x.shape[-1])
        return x[..., self.offset:self.offset + n]

    def attention(self, q, k, v, kv_mask):
        return RingAttention.apply(q, k, v, kv_mask, self)

    def pool(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The masked mean over the whole sequence of [M, Lc, d] rows: the
        rank's sum and count, all-reduced over sp in one collective."""
        valid = (mask > 0)[..., None]
        part = torch.cat([(x * valid).sum(-2).float(), valid.sum(-2).float()], dim=-1)
        tot = SumOut.apply(part, self.group, "sp/pool_allreduce")
        return tot[..., :-1] / (tot[..., -1:] + 1e-13)


def attach_sequence(model, mesh) -> bool:
    """Put the transformer encoder of ``model`` on ``mesh``'s sp axis (a
    ``SequenceShard``); True when attached (sp > 1 on a live mesh)."""
    if not mesh.live or mesh.sp == 1:
        return False
    enc = getattr(model, "encoder", None)
    if not hasattr(enc, "seq"):
        raise ValueError("--sp (ring attention) requires --encoder transformer; the "
                         f"{type(enc).__name__} has no sequence-parallel path")
    enc.seq = SequenceShard(mesh)
    return True


def sequence_shard(model):
    """The model's ``SequenceShard``, or None."""
    return getattr(getattr(model, "encoder", None), "seq", None)


def is_token_partial(name: str) -> bool:
    """True for a leaf whose gradient under sp is a partial over the rank's
    tokens (below the pooling): the embedding's, the encoder's and the lazy
    table's rows."""
    return name.startswith(("embedding.", "encoder.")) or name == "lazy_embed"
