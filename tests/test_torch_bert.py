"""The port's BERT encoder and tokenizer vs the JAX package's (CPU).

At the tiny width of the JAX ``tests/test_bert.py`` (2 layers, hidden 32,
4 heads, FFN 64, 500 ids, L=24); token batches from a numpy seed, weights
carried by ``interop.py`` (``encoder/backbone/...``):

* ``BertTokenizer``: the same ids as the JAX tokenizer, bitwise, in the
  hash fallback and with a ``vocab.txt`` written to tmp (WordPiece splits,
  ``[UNK]``, the vocab size it resets).
* ``BertEncoder`` / ``BertBackbone`` forward: f32 within 1e-5 of the
  output's scale, bf16 within the repo's 5e-2 band; ``segment_ids``; an
  absent marker falls back to [CLS].
* gradients of ``Σ pooled ⊙ R`` against ``jax.vjp``, leaf by leaf within
  1e-5 of each leaf's scale; ``frozen`` gives no backbone gradient (JAX:
  zeros); ``remat`` the same gradients as without it.
* ``load_hf_weights`` on a synthetic ``.npz`` in both LayerNorm styles:
  the port's backbone equals the JAX mapping's tree through interop.
* fresh parameters follow flax's initializers (at hidden 128, enough
  draws): each leaf's std against the JAX init's, truncation or not.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.data import make_synthetic_fewrel as jax_synthetic
from induction_network_on_fewrel_tpu.data.bert_tokenizer import BertTokenizer as JaxTokenizer
from induction_network_on_fewrel_tpu.models import bert as jbert
from induction_network_on_fewrel_tpu_torch.data import BertTokenizer, make_synthetic_fewrel
from induction_network_on_fewrel_tpu_torch.interop import params_from_jax, params_to_jax
from induction_network_on_fewrel_tpu_torch.models.bert import (
    BertBackbone,
    BertEncoder,
    load_hf_weights,
)
from induction_network_on_fewrel_tpu_torch.models.embedding import TRUNC_STD

L = 24
TINY = dict(layers=2, hidden=32, heads=4, intermediate=64)
VOCAB = 500
F32 = 1e-5
BF16_BAND = 5e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _jax_encoder(frozen=False, dtype="float32", **kw):
    w = dict(TINY, **kw)
    return jbert.BertEncoder(vocab_size=VOCAB, num_layers=w["layers"], hidden_size=w["hidden"],
                             num_heads=w["heads"], intermediate_size=w["intermediate"],
                             frozen=frozen, compute_dtype=DTYPES[dtype][0])


def _port_encoder(frozen=False, dtype="float32", remat=False, seed=0, **kw):
    w = dict(TINY, **kw)
    return BertEncoder(VOCAB, w["layers"], w["hidden"], w["heads"], w["intermediate"],
                       frozen=frozen, remat=remat, dtype=DTYPES[dtype][1], device="cpu",
                       generator=torch.Generator().manual_seed(seed))


def _tokens(rng, m=6, markers=True):
    """[m, L] ids in [16, VOCAB) with [CLS] first, masks of ragged lengths,
    the two markers inside each row's length (``markers``)."""
    ids = rng.integers(16, VOCAB, (m, L)).astype(np.int32)
    lengths = rng.integers(6, L + 1, m)
    ids[:, 0] = 3
    if markers:
        for r, n in enumerate(lengths):
            h, t = rng.choice(np.arange(1, n), 2, replace=False)
            ids[r, h], ids[r, t] = 1, 2
    mask = (np.arange(L) < lengths[:, None]).astype(np.float32)
    ids[mask == 0] = 0
    return ids, mask


@pytest.fixture(scope="module")
def setup():
    """(JAX module, JAX params, port module) at f32, the port's weights the
    JAX init's."""
    ids, mask = _tokens(np.random.default_rng(0))
    jm = _jax_encoder()
    params = jm.init(jax.random.key(0), ids, mask)
    tm = _port_encoder()
    tm.load_state_dict(params_from_jax(params["params"]))
    return jm, params, tm


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# --- tokenizer -------------------------------------------------------------------


def test_tokenizer_ids_bitwise_hash_fallback():
    jds = jax_synthetic(num_relations=6, instances_per_relation=20, vocab_size=300, seed=4)
    tds = make_synthetic_fewrel(num_relations=6, instances_per_relation=20, vocab_size=300,
                                seed=4)
    jt, tt = JaxTokenizer(max_length=L, vocab_size=VOCAB), BertTokenizer(max_length=L,
                                                                         vocab_size=VOCAB)
    n = 0
    for rel in jds.rel_names:
        for ji, ti in zip(jds.instances[rel], tds.instances[rel]):
            assert tuple(ji.tokens) == tuple(ti.tokens)
            a, b = jt(ji), tt(ti)
            for k in ("word", "pos1", "pos2", "mask"):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
                assert getattr(a, k).dtype == getattr(b, k).dtype
            n += 1
    assert n == 120 and tt.vocab_size == VOCAB


def test_tokenizer_ids_bitwise_wordpiece(tmp_path):
    vocab = ["[PAD]", "[unused0]", "[unused1]", "x", "[UNK]", "[CLS]", "[SEP]", "w", "w1",
             "##1", "##2", "##3", "##45", "w2", "##0"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab))
    jds = jax_synthetic(num_relations=4, instances_per_relation=10, vocab_size=300, seed=5)
    tds = make_synthetic_fewrel(num_relations=4, instances_per_relation=10, vocab_size=300,
                                seed=5)
    jt, tt = JaxTokenizer(max_length=L, vocab_path=path), BertTokenizer(max_length=L,
                                                                        vocab_path=path)
    assert tt.vocab_size == jt.vocab_size == len(vocab)
    seen = set()
    for rel in jds.rel_names:
        for ji, ti in zip(jds.instances[rel], tds.instances[rel]):
            a, b = jt(ji), tt(ti)
            np.testing.assert_array_equal(a.word, b.word)
            np.testing.assert_array_equal(a.mask, b.mask)
            seen.update(b.word[b.mask > 0].tolist())
    assert {vocab.index(p) for p in ("[CLS]", "[SEP]", "[UNK]", "##1", "w2")} <= seen


# --- forward ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_forward_matches_jax(setup, dtype):
    jm0, params, tm0 = setup
    ids, mask = _tokens(np.random.default_rng(1), m=8)
    jm, tm = _jax_encoder(dtype=dtype), _port_encoder(dtype=dtype)
    tm.load_state_dict(tm0.state_dict())
    want = np.asarray(jm.apply(params, ids, mask).astype(jnp.float32))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == DTYPES[dtype][1] and got.shape == (8, TINY["hidden"])
    assert _rel(got.float().numpy(), want) < (F32 if dtype == "float32" else BF16_BAND)


@pytest.mark.parametrize("segments", [False, True], ids=["segment0", "segment_ids"])
def test_backbone_forward_matches_jax(setup, segments):
    _, params, tm = setup
    rng = np.random.default_rng(2)
    ids, mask = _tokens(rng, m=5)
    seg = rng.integers(0, 2, ids.shape).astype(np.int32) if segments else None
    jb = jbert.BertBackbone(vocab_size=VOCAB, num_layers=2, hidden_size=32, num_heads=4,
                            intermediate_size=64)
    want = np.asarray(jb.apply({"params": params["params"]["backbone"]}, ids, mask, seg))
    with torch.no_grad():
        got = tm.backbone(torch.from_numpy(ids), torch.from_numpy(mask),
                          None if seg is None else torch.from_numpy(seg))
    assert _rel(got.numpy(), want) < F32
    if segments:        # segment 1 rows differ from the all-zero segment's
        with torch.no_grad():
            zero = tm.backbone(torch.from_numpy(ids), torch.from_numpy(mask))
        assert not torch.allclose(got, zero)


def test_absent_marker_falls_back_to_cls(setup):
    jm, params, tm = setup
    ids, mask = _tokens(np.random.default_rng(3), m=4, markers=False)
    ids[0, 5] = 1                   # row 0 has [E1] only; rows 1-3 neither
    ids[1, int(mask[1].sum())] = 2  # [E2] on a masked-out position: absent
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(mask))
        hidden = tm.backbone(torch.from_numpy(ids), torch.from_numpy(mask))
    cls = hidden[:, 0]
    torch.testing.assert_close(got[1:], (cls[1:] + cls[1:] + cls[1:]) / 3.0, rtol=0, atol=0)
    torch.testing.assert_close(got[0], (cls[0] + hidden[0, 5] + cls[0]) / 3.0, rtol=0, atol=0)
    assert _rel(got.numpy(), np.asarray(jm.apply(params, ids, mask))) < F32


# --- gradients -------------------------------------------------------------------


def _port_grads(tm, ids, mask, R) -> dict:
    """Each parameter's gradient of ``Σ pooled ⊙ R`` (None without one: a
    frozen encoder's output does not require grad at all)."""
    tm.zero_grad(set_to_none=True)
    loss = (tm(torch.from_numpy(ids), torch.from_numpy(mask)) * torch.from_numpy(R)).sum()
    if loss.requires_grad:
        loss.backward()
    return {n: None if p.grad is None else p.grad.clone() for n, p in tm.named_parameters()}


@pytest.mark.parametrize("frozen", [False, True], ids=["finetuned", "frozen"])
def test_gradients_match_jax_vjp(setup, frozen):
    _, params, tm0 = setup
    rng = np.random.default_rng(4)
    ids, mask = _tokens(rng, m=6)
    R = rng.standard_normal((6, TINY["hidden"])).astype(np.float32)
    jm, tm = _jax_encoder(frozen=frozen), _port_encoder(frozen=frozen)
    tm.load_state_dict(tm0.state_dict())
    _, vjp = jax.vjp(lambda p: jm.apply(p, ids, mask), params)
    (jg,) = vjp(jnp.asarray(R))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jg)["params"])
    got = _port_grads(tm, ids, mask, R)
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy()
        if frozen:
            assert g is None and not np.any(w), name
            continue
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g.numpy() - w).max() <= F32 * scale, name


def test_remat_gives_the_same_gradients(setup):
    _, _, tm0 = setup
    rng = np.random.default_rng(5)
    ids, mask = _tokens(rng)
    R = rng.standard_normal((6, TINY["hidden"])).astype(np.float32)
    tm = _port_encoder(remat=True)
    tm.load_state_dict(tm0.state_dict())
    plain, remat = _port_grads(tm0, ids, mask, R), _port_grads(tm, ids, mask, R)
    for name, g in plain.items():
        torch.testing.assert_close(remat[name], g, rtol=1e-6, atol=1e-7, msg=name)


# --- weights ---------------------------------------------------------------------


def _hf_npz(path, rng, style: str, layers: int = 2, H: int = 32, inter: int = 64):
    """A synthetic bert-base-uncased-style .npz at tiny width; LayerNorms as
    ``gamma``/``beta`` (TF-era) or ``weight``/``bias`` (torch)."""
    g, b = ("gamma", "beta") if style == "tf" else ("weight", "bias")
    arr = {}

    def put(name, *shape):
        arr[name] = rng.standard_normal(shape).astype(np.float32)

    pre = "bert.embeddings."
    put(pre + "word_embeddings.weight", VOCAB, H)
    put(pre + "position_embeddings.weight", 512, H)
    put(pre + "token_type_embeddings.weight", 2, H)
    put(pre + f"LayerNorm.{g}", H)
    put(pre + f"LayerNorm.{b}", H)
    for i in range(layers):
        lp = f"bert.encoder.layer.{i}."
        for n in ("query", "key", "value"):
            put(lp + f"attention.self.{n}.weight", H, H)
            put(lp + f"attention.self.{n}.bias", H)
        put(lp + "attention.output.dense.weight", H, H)
        put(lp + "attention.output.dense.bias", H)
        put(lp + "intermediate.dense.weight", inter, H)
        put(lp + "intermediate.dense.bias", inter)
        put(lp + "output.dense.weight", H, inter)
        put(lp + "output.dense.bias", H)
        for ln in ("attention.output.", "output."):
            put(lp + ln + f"LayerNorm.{g}", H)
            put(lp + ln + f"LayerNorm.{b}", H)
    np.savez(path, **arr)


@pytest.mark.parametrize("style", ["tf", "torch"])
def test_load_hf_weights_matches_jax_mapping(setup, tmp_path, style):
    _, params, tm0 = setup
    path = tmp_path / f"bert_{style}.npz"
    _hf_npz(path, np.random.default_rng(6), style)
    want = params_from_jax(jbert.load_hf_weights(params, str(path))["params"])
    tm = _port_encoder()
    load_hf_weights(tm, str(path))
    got = tm.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        assert torch.equal(got[name], w), name
    assert not torch.equal(got["backbone.pos_emb"], tm0.state_dict()["backbone.pos_emb"])
    ids, mask = _tokens(np.random.default_rng(7))
    with torch.no_grad():
        out = tm(torch.from_numpy(ids), torch.from_numpy(mask))
    assert _rel(out.numpy(), np.asarray(_jax_encoder().apply(
        {"params": params_to_jax(got)}, ids, mask))) < F32


def test_load_hf_weights_missing_tensor_raises(tmp_path):
    path = tmp_path / "partial.npz"
    np.savez(path, **{"bert.embeddings.word_embeddings.weight": np.zeros((VOCAB, 32), np.float32)})
    with pytest.raises(KeyError):
        load_hf_weights(_port_encoder(), str(path))


# --- fresh weights ---------------------------------------------------------------


def test_fresh_params_follow_flax_initializers():
    """At hidden 128 (FFN 512, one layer, enough draws for a 5 % std bar):
    every leaf's std within 5 % of the JAX init's and constants equal; the
    Dense kernels truncated in both packages (max |w| within 2 std /
    TRUNC_STD), ``tok_emb`` (std 1/sqrt(H)) and ``pos_emb`` (0.02) drawn
    past that cut in both (untruncated normals)."""
    wide = dict(layers=1, hidden=128, heads=4, intermediate=512)
    ids, mask = _tokens(np.random.default_rng(8))
    jparams = params_from_jax(_jax_encoder(**wide).init(jax.random.key(1), ids, mask)["params"])
    tparams = {n: p.detach() for n, p in _port_encoder(seed=1, **wide).named_parameters()}
    assert set(jparams) == set(tparams)
    for name, j in jparams.items():
        t = tparams[name]
        if float(j.std()) == 0.0:
            assert torch.equal(t, j), name
            continue
        if j.numel() >= 1000:                   # seg_emb: too few draws for a std bar
            assert abs(float(t.std()) / float(j.std()) - 1.0) < 0.05, name
        if name.endswith(".weight"):            # Dense kernels: truncated lecun-normal
            cut = 2.0 / TRUNC_STD / math.sqrt(t.shape[1]) * (1 + 1e-6)
            assert float(t.abs().max()) <= cut and float(j.abs().max()) <= cut, name
    H = wide["hidden"]
    for name, std in (("backbone.tok_emb.embedding", 1.0 / math.sqrt(H)),
                      ("backbone.pos_emb", 0.02)):
        for w in (tparams[name], jparams[name]):
            assert abs(float(w.std()) / std - 1.0) < 0.05, name
            assert float(w.abs().max()) > 2.0 / TRUNC_STD * std, name


def test_backbone_parameter_names_are_the_jax_paths():
    """The parameter names a BERT-base backbone has, per layer, are the
    JAX paths joined with dots (interop's rule)."""
    bb = BertBackbone(VOCAB, 1, 32, 4, 64, device="cpu", generator=torch.Generator())
    names = sorted(n for n, _ in bb.named_parameters())
    assert names == sorted(
        ["tok_emb.embedding", "pos_emb", "seg_emb", "ln_emb.scale", "ln_emb.bias"]
        + [f"layer_0.{m}.{leaf}" for m in ("attention.qkv", "attention.out", "intermediate",
                                           "mlp_out") for leaf in ("weight", "bias")]
        + [f"layer_0.{m}.{leaf}" for m in ("ln_att", "ln_mlp") for leaf in ("scale", "bias")])
