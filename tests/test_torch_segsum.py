"""The port's segment-sum lookups vs the JAX package at small widths (CPU).

* ``lookup_matmul_grad`` against ``jax.vjp`` of the JAX
  ``ops.segsum.lookup_matmul_grad`` on the same table, ids and cotangent:
  a position-table size (U = 80) with ids heavy in padding duplicates, and
  a table large enough that the one-hot budget splits the tokens into
  chunks (the chunked path).
* The large-table route (``lookup_scatter_grad``, the scatter-add whose
  plain version runs here) against ``jax.vjp`` of the plain gather, which
  XLA transposes into its scatter-add.
* ``Embedding``'s three routes against the JAX ``Embedding`` module's
  gradient: a small word table (one-hot product), a word table past
  ``MATMUL_GRAD_MAX_ROWS`` (scatter-add) and ``freeze_word_table`` (no
  gradient; the JAX table's gradient is zero).
* ``segsum`` on a column slice of a wider gradient (the word columns of
  the step's embedding gradient), and against its plain version.

All sums are f32 in another order than XLA's: the bar is 1e-6 of the
gradient's largest magnitude (the padding id's row sums thousands of
terms, and the rounding of a sum grows with it).
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.models.embedding import Embedding as JaxEmbedding
from induction_network_on_fewrel_tpu.ops.segsum import lookup_matmul_grad as jax_lookup
from induction_network_on_fewrel_tpu_torch.models.embedding import Embedding
from induction_network_on_fewrel_tpu_torch.ops import segsum as segsum_ops
from induction_network_on_fewrel_tpu_torch.ops.segsum import (
    MATMUL_GRAD_MAX_ROWS,
    lookup_matmul_grad,
    lookup_scatter_grad,
    segment_sum_matmul,
)

TOL = dict(rtol=1e-6, atol=1e-6)


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max(1.0, np.abs(want).max()),
                               err_msg=err_msg)


def _padded_ids(rng, shape, rows, pad_id, pad_frac=0.6):
    ids = rng.integers(0, rows, size=shape)
    ids[rng.random(shape) < pad_frac] = pad_id
    return ids.astype(np.int64)


def _torch_vjp(fn, table, ids, cot):
    t = torch.from_numpy(table.copy()).requires_grad_()
    out = fn(t, torch.from_numpy(ids))
    np.testing.assert_array_equal(out.detach().numpy(), table[ids])    # forward is the gather
    out.backward(torch.from_numpy(cot))
    return t.grad.numpy()


@pytest.mark.parametrize("rows,shape", [(80, (40, 50)), (4096, (60, 50))],
                         ids=["U80", "chunked"])
def test_lookup_matmul_grad_matches_jax_vjp(rows, shape):
    rng = np.random.default_rng(0)
    table = rng.normal(size=(rows, 5)).astype(np.float32)
    ids = _padded_ids(rng, shape, rows, pad_id=rows - 1)
    cot = rng.normal(size=shape + (5,)).astype(np.float32)
    if rows == 4096:    # the one-hot budget gives chunks shorter than the tokens
        assert max(segsum_ops._MIN_CHUNK,
                   segsum_ops._ONEHOT_BYTES // (rows * 4)) < ids.size
    _, vjp = jax.vjp(lambda t: jax_lookup(t, jnp.asarray(ids, jnp.int32)), jnp.asarray(table))
    (want,) = vjp(jnp.asarray(cot))
    got = _torch_vjp(lookup_matmul_grad, table, ids, cot)
    _close(got, want)
    _close(segment_sum_matmul(torch.from_numpy(cot), torch.from_numpy(ids), rows).numpy(), want)


def test_large_table_scatter_matches_jax_vjp():
    rows = MATMUL_GRAD_MAX_ROWS + 7
    rng = np.random.default_rng(1)
    table = rng.normal(size=(rows, 4)).astype(np.float32)
    ids = _padded_ids(rng, (40, 30), rows, pad_id=rows - 1)
    cot = rng.normal(size=(40, 30, 4)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: t[jnp.asarray(ids, jnp.int32)], jnp.asarray(table))
    (want,) = vjp(jnp.asarray(cot))
    got = _torch_vjp(lookup_scatter_grad, table, ids, cot)
    _close(got, want)
    assert np.count_nonzero(got.any(axis=1)) == len(np.unique(ids))


@pytest.mark.parametrize("vocab,frozen", [(60, False), (MATMUL_GRAD_MAX_ROWS + 2, False),
                                          (60, True)], ids=["matmul", "scatter", "frozen"])
def test_embedding_gradients_match_jax_module(vocab, frozen):
    L, M, wd, pd = 12, 9, 6, 2
    rng = np.random.default_rng(2)
    word = _padded_ids(rng, (M, L), vocab, pad_id=vocab - 1)
    pos1 = rng.integers(0, 2 * L, size=(M, L)).astype(np.int64)
    pos2 = rng.integers(0, 2 * L, size=(M, L)).astype(np.int64)
    tables = {"word_embedding": rng.normal(size=(vocab, wd)).astype(np.float32),
              "pos1_embedding": rng.normal(size=(2 * L, pd)).astype(np.float32),
              "pos2_embedding": rng.normal(size=(2 * L, pd)).astype(np.float32)}
    cot = rng.normal(size=(M, L, wd + 2 * pd)).astype(np.float32)

    jm = JaxEmbedding(vocab_size=vocab, word_dim=wd, pos_dim=pd, max_length=L,
                      freeze_word_table=frozen)
    jids = [jnp.asarray(x, jnp.int32) for x in (word, pos1, pos2)]
    params = {"params": {k: jnp.asarray(v) for k, v in tables.items()}}
    _, vjp = jax.vjp(lambda p: jm.apply(p, *jids), params)
    (want,) = vjp(jnp.asarray(cot))

    tm = Embedding(vocab, wd, pd, L, freeze_word_table=frozen, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for k, v in tables.items():
            getattr(tm, k).copy_(torch.from_numpy(v))
    out = tm(*(torch.from_numpy(x) for x in (word, pos1, pos2)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jm.apply(params, *jids)), **TOL)
    out.backward(torch.from_numpy(cot))
    for k in tables:
        w = np.asarray(want["params"][k])
        g = getattr(tm, k).grad
        if frozen and k == "word_embedding":
            assert g is None and not w.any()
            continue
        _close(g.numpy(), w, err_msg=k)


def test_scatter_rows_view_keeps_a_column_slice():
    """The word columns of the concatenated embedding's gradient,
    [L, M, 60][..., :50] (rows 60 apart, not contiguous), sum as their
    contiguous copy does, and so does a transposed layout."""
    wide = torch.randn(4, 3, 60, generator=torch.Generator().manual_seed(0))
    ids = torch.tensor([[0, 5, 5], [2, 0, 9], [5, 5, 5], [1, 0, 2]])
    for cot, i in ((wide[..., :50], ids), (wide.transpose(0, 1)[..., :50], ids.T)):
        got = segsum_ops.segsum(cot, i, 10)
        assert torch.equal(got, segsum_ops.segsum(cot.contiguous(), i, 10))
        torch.testing.assert_close(got[5], cot.reshape(12, 50)[i.reshape(-1) == 5].sum(0))

def test_segsum_cpu_route_is_the_plain_version():
    """On CPU tensors ``segsum`` (``index_add_``) equals its plain version
    (``index_put_`` with accumulate) bitwise: both add in token order;
    repeated ids add up and rows no id names stay zero."""
    cot, ids = torch.randn(6, 4), torch.tensor([0, 3, 3, 7, 0, 0])
    out = segsum_ops.segsum(cot, ids, 8)
    assert out.dtype == torch.float32 and out.shape == (8, 4)
    assert torch.equal(out, segsum_ops.segsum_reference(cot, ids, 8))
    torch.testing.assert_close(out[0], cot[0] + cot[4] + cot[5])
    assert not out[[1, 2, 4, 5, 6]].any()
