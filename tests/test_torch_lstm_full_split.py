"""The port's full-residual BiLSTM route and split recurrence vs the JAX package (CPU).

The same numpy inputs, made from a seed, go through the JAX kernels (in
Pallas interpret mode, as the JAX package's own tests run them; in f32 also
through its ``lax.scan`` references) and through the port's plain versions
of the kernels, which CPU tensors reach through the same autograd
Functions the card's kernels sit behind:

* K4/K6 (``bilstm_encoder_tm(..., cs_window=0)``): forward, the saved hs
  and cs streams, and ``jax.vjp`` of all four inputs, in f32 and bf16 with
  both residual dtypes;
* kernels 1/2/3 (``lstm_recurrence``, ``lstm_recurrence_grouped``,
  ``bilstm_recurrence_tm``): forward and ``jax.vjp``, direction
  independence, and the time-major layout against the grouped one fed the
  flipped input;
* a 20-step training trajectory at ``lstm_cs_window=0`` against JAX
  ``make_train_step`` with the interpret-mode kernels.

Bars: f32 1e-5 (forward and full-residual gradients; the split gradients
against ``lax.scan`` at the tests/test_lstm.py:310 bar, rtol 1e-4 / atol
1e-5); bf16 5e-2 (the tests/test_attn.py band the W > 0 tests use); the
trajectory at the tests/test_torch_train.py bars (losses rtol 2e-4,
parameters atol 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.data import GloveTokenizer as JaxTokenizer
from induction_network_on_fewrel_tpu.data import make_synthetic_fewrel as jax_fewrel
from induction_network_on_fewrel_tpu.data import make_synthetic_glove as jax_glove
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu.models.build import batch_to_model_inputs as jax_inputs
from induction_network_on_fewrel_tpu.ops import lstm as jlstm
from induction_network_on_fewrel_tpu.sampling.episodes import EpisodeSampler as JaxSampler
from induction_network_on_fewrel_tpu.train.steps import init_state, make_train_step
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.interop import params_from_jax, params_to_jax
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.ops import lstm as tlstm
from induction_network_on_fewrel_tpu_torch.train.steps import make_optimizer, train_step

# Not a multiple of any row tile (8, 16) or of the JAX tile.
L, M, D, U = 7, 13, 12, 16
F32 = dict(rtol=1e-5, atol=1e-5)
SCAN = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
BOTH = [torch.float32, torch.bfloat16]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, bar, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **bar)


@pytest.fixture(scope="module")
def fused():
    rng = np.random.default_rng(21)
    emb_t = rng.normal(size=(L, M, D)).astype(np.float32) * 0.5
    wih = (rng.normal(size=(2, D, 4 * U)) / np.sqrt(D)).astype(np.float32)
    b = rng.normal(size=(2, 1, 4 * U)).astype(np.float32) * 0.1
    whh = (rng.normal(size=(2, U, 4 * U)) / np.sqrt(U)).astype(np.float32)
    dhs = rng.normal(size=(L, M, 2 * U)).astype(np.float32)
    return emb_t, wih, b, whh, dhs


# --- K4 + K6: the full-residual route ---------------------------------------------

RES_CASES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("dt,res", RES_CASES)
def test_full_fwd_streams_match_jax_interpret(fused, dt, res):
    """K4's plain version: hs in emb's dtype and cs at every step in the
    residual dtype, against JAX ``_fused_fwd_call`` (interpret)."""
    emb_t, wih, b, whh, _ = fused
    je = jnp.asarray(emb_t).astype(JDT[dt])
    tm = jlstm._pick_tm(M, U, je.dtype.itemsize, D=D)
    pad = (-M) % tm
    hs, cs = jlstm._fused_fwd_call(
        jnp.pad(je, ((0, 0), (0, pad), (0, 0))), jnp.asarray(wih).astype(je.dtype),
        jnp.asarray(b), jnp.asarray(whh), True, tm, JDT[res],
    )
    got = tlstm.bilstm_full_fwd_reference(
        torch.from_numpy(emb_t).to(dt), torch.from_numpy(wih).to(dt), torch.from_numpy(b),
        torch.from_numpy(whh), res,
    )
    assert got[0].dtype == dt and got[1].dtype == res and got[1].shape == (L, M, 2 * U)
    bar = F32 if dt == res == torch.float32 else BF16
    _close(got[0], hs[:, :M], bar)
    _close(got[1], cs[:, :M], bar)


def _jax_grads(inputs, dt, res):
    emb_t, wih, b, whh, dhs = inputs
    fn = lambda e, wi, bb, wh: jlstm.bilstm_encoder_tm(  # noqa: E731
        e, wi, bb, wh, backend="interpret", cs_window=0, residual_dtype=JDT[res])
    out, vjp = jax.vjp(fn, jnp.asarray(emb_t).astype(JDT[dt]), jnp.asarray(wih),
                       jnp.asarray(b), jnp.asarray(whh))
    return out, vjp(jnp.asarray(dhs).astype(out.dtype))


def _port_grads(inputs, dt, res, W=0):
    emb_t, wih, b, whh, dhs = inputs
    e = torch.from_numpy(emb_t).to(dt).requires_grad_()
    ps = [torch.from_numpy(x).requires_grad_() for x in (wih, b, whh)]
    out = tlstm.bilstm_encoder_tm(e, *ps, backend="reference", cs_window=W, residual_dtype=res)
    return out, torch.autograd.grad(out, [e, *ps], torch.from_numpy(dhs).to(out.dtype))


@pytest.mark.parametrize("dt,res", RES_CASES)
def test_full_residual_grads_match_jax_vjp(fused, dt, res):
    want_out, want = _jax_grads(fused, dt, res)
    got_out, got = _port_grads(fused, dt, res)
    bar = F32 if dt == res == torch.float32 else BF16
    assert got_out.dtype == dt and got[0].dtype == dt
    _close(got_out, want_out, bar)
    for name, g, w in zip(("demb", "dwih", "db", "dwhh"), got, want):
        assert g.shape == tuple(w.shape), name
        _close(g, w, bar, name)


def test_full_bwd_reads_h_prev_from_stored_hs(fused):
    """K6 recomputes the gates from the STORED hs (not from an f32 carry):
    with a bf16 encoder h_prev is the bf16-rounded value, so rounding an
    f32 hs to bf16 must move the gradients, within the bf16 band."""
    emb_t, wih, b, whh, dhs = fused
    args = [torch.from_numpy(x) for x in (emb_t, wih, b, whh)]
    hs, cs = tlstm.bilstm_full_fwd_reference(*args, torch.float32)
    d = torch.from_numpy(dhs)
    exact = tlstm.bilstm_full_bwd_reference(d, args[0], hs, cs, *args[1:])
    rounded = tlstm.bilstm_full_bwd_reference(d, args[0], hs.bfloat16().float(), cs, *args[1:])
    for g, r in zip(exact, rounded):
        assert not torch.equal(g, r)
        _close(r, g, BF16)


# --- kernels 1, 2, 3: the split recurrence ------------------------------------------


@pytest.fixture(scope="module")
def split():
    rng = np.random.default_rng(7)
    xg = rng.normal(size=(2, M, L, 4 * U)).astype(np.float32) * 0.5
    xg_t = rng.normal(size=(L, M, 8 * U)).astype(np.float32) * 0.5
    whh = (rng.normal(size=(2, U, 4 * U)) / np.sqrt(U)).astype(np.float32)
    ct = {"single": rng.normal(size=(M, L, U)), "grouped": rng.normal(size=(2, M, L, U)),
          "tm": rng.normal(size=(L, M, 2 * U))}
    return xg, xg_t, whh, {k: v.astype(np.float32) for k, v in ct.items()}


def _api_inputs(split, api):
    xg, xg_t, whh, ct = split
    if api == "single":
        return xg[0], whh[0], ct[api]
    return (xg, whh, ct[api]) if api == "grouped" else (xg_t, whh, ct[api])


JAX_API = {"single": jlstm.lstm_recurrence, "grouped": jlstm.lstm_recurrence_grouped,
           "tm": jlstm.bilstm_recurrence_tm}
PORT_API = {"single": tlstm.lstm_recurrence, "grouped": tlstm.lstm_recurrence_grouped,
            "tm": tlstm.bilstm_recurrence_tm}


@pytest.mark.parametrize("api", ["single", "grouped", "tm"])
@pytest.mark.parametrize("dt", BOTH)
def test_split_forward_matches_jax(split, api, dt):
    """No gradient needed: kernel 2's plain version vs JAX interpret (in
    xg's dtype) and, in f32, vs the JAX scan reference."""
    x, whh, _ = _api_inputs(split, api)
    got = PORT_API[api](torch.from_numpy(x).to(dt), torch.from_numpy(whh), backend="reference")
    jx = jnp.asarray(x).astype(JDT[dt])
    want = JAX_API[api](jx, jnp.asarray(whh), backend="interpret")
    assert got.dtype == dt and got.shape == tuple(want.shape)
    _close(got, want, F32 if dt == torch.float32 else BF16)
    if dt == torch.float32:
        _close(got, JAX_API[api](jx, jnp.asarray(whh), backend="scan"), F32)


@pytest.mark.parametrize("api", ["single", "grouped", "tm"])
@pytest.mark.parametrize("dt", BOTH)
def test_split_grads_match_jax_vjp(split, api, dt):
    """Kernels 1 and 3 (plain versions) through the autograd Function vs
    ``jax.vjp`` of the interpret kernels and, in f32, of ``lax.scan``."""
    x, whh, ct = _api_inputs(split, api)
    xt = torch.from_numpy(x).to(dt).requires_grad_()
    wt = torch.from_numpy(whh).requires_grad_()
    out = PORT_API[api](xt, wt, backend="reference")
    got = torch.autograd.grad(out, [xt, wt], torch.from_numpy(ct).to(out.dtype))
    assert got[0].dtype == dt and got[1].dtype == torch.float32
    jx = jnp.asarray(x).astype(JDT[dt])
    for backend, bar in (("interpret", F32 if dt == torch.float32 else BF16), ("scan", SCAN)):
        if backend == "scan" and dt != torch.float32:
            continue
        want_out, vjp = jax.vjp(lambda a, w: JAX_API[api](a, w, backend=backend),  # noqa: B023
                                jx, jnp.asarray(whh))
        want = vjp(jnp.asarray(ct).astype(want_out.dtype))
        _close(out, want_out, F32 if backend == "scan" else bar)
        for name, g, w in zip(("dxg", "dwhh"), got, want):
            _close(g, w, bar, f"{backend} {name}")


def test_split_tm_directions_are_independent(split):
    """Scaling the reverse weights moves only the reverse half (the JAX
    tests/test_lstm.py:289-291 check)."""
    _, xg_t, whh, _ = split
    x = torch.from_numpy(xg_t)
    a = tlstm.bilstm_recurrence_tm(x, torch.from_numpy(whh), backend="reference")
    w2 = torch.from_numpy(whh).clone()
    w2[1] *= 2.0
    b = tlstm.bilstm_recurrence_tm(x, w2, backend="reference")
    _close(b[..., :U], a[..., :U], dict(rtol=1e-6, atol=0))
    assert not torch.allclose(b[..., U:], a[..., U:])


def test_split_tm_matches_grouped_layout(split):
    """The time-major output equals the grouped API fed the explicitly
    flipped layout (tests/test_lstm.py:314-331), forward and gradients."""
    _, xg_t, whh, ct = split
    G = 4 * U
    x = torch.from_numpy(xg_t).requires_grad_()
    w = torch.from_numpy(whh)
    grouped = torch.stack([x[..., :G].transpose(0, 1), x[..., G:].flip(0).transpose(0, 1)])
    hs_g = tlstm.lstm_recurrence_grouped(grouped, w, backend="reference")
    want = torch.cat([hs_g[0], hs_g[1].flip(1)], -1).transpose(0, 1)
    got = tlstm.bilstm_recurrence_tm(x, w, backend="reference")
    _close(got, want, dict(rtol=1e-6, atol=1e-7))
    c = torch.from_numpy(ct["tm"])
    (g_tm,) = torch.autograd.grad(got, [x], c)
    (g_gr,) = torch.autograd.grad(want, [x], c)
    _close(g_tm, g_gr, dict(rtol=1e-6, atol=1e-7))


def test_lstm_scan_matches_jax_scan(split):
    xg, _, whh, ct = split
    x, w = torch.from_numpy(xg[0]).requires_grad_(), torch.from_numpy(whh[0]).requires_grad_()
    got = tlstm.lstm_scan(x, w)
    want, vjp = jax.vjp(jlstm.lstm_scan, jnp.asarray(xg[0]), jnp.asarray(whh[0]))
    _close(got, want, F32)
    for g, w_ in zip(torch.autograd.grad(got, [x, w], torch.from_numpy(ct["single"])),
                     vjp(jnp.asarray(ct["single"]))):
        _close(g, w_, SCAN)


def test_split_refuses_bad_shapes(split):
    xg, xg_t, whh, _ = split
    w3 = torch.zeros((3, U, 4 * U))
    with pytest.raises(ValueError, match="exactly 2 groups"):
        tlstm.bilstm_recurrence_tm(torch.zeros((L, M, 12 * U)), w3, backend="reference")
    with pytest.raises(ValueError, match="xg must be"):
        tlstm.lstm_recurrence_grouped(torch.from_numpy(xg), w3, backend="reference")


# --- training at lstm_cs_window=0 -------------------------------------------------

# The tests/test_torch_train.py trajectory configuration.
TRAJ = dict(vocab_size=60, max_length=12, word_dim=10, pos_dim=2, lstm_hidden=16, att_dim=8,
            induction_dim=12, ntn_slices=6, routing_iters=3, n=3, k=2, q=2, batch_size=2,
            compute_dtype="float32", lr=2e-3, weight_decay=1e-4, grad_clip=1.0,
            lr_step_size=3, lr_gamma=0.5)


def _batches(n):
    jcfg = JaxConfig(**TRAJ)
    vocab = jax_glove(jcfg.vocab_size - 2, jcfg.word_dim)
    ds = jax_fewrel(num_relations=6, instances_per_relation=jcfg.k + jcfg.q + 4,
                    vocab_size=jcfg.vocab_size - 2, sentence_len=(6, jcfg.max_length))
    s = JaxSampler(ds, JaxTokenizer(vocab, jcfg.max_length), jcfg.n, jcfg.k, jcfg.q,
                   batch_size=jcfg.batch_size, seed=123)
    return [jax_inputs(s.sample_batch()) for _ in range(n)]



def test_window_zero_trajectory_matches_jax_train_step():
    """20 steps of the port's ``train_step`` at ``lstm_cs_window=0`` (the
    plain versions of K4/K6 through the Function) against JAX
    ``make_train_step`` with the interpret-mode full-residual kernels,
    f32, on identical batches from the same weights."""
    steps = 20
    jcfg = JaxConfig(**TRAJ, lstm_backend="interpret", lstm_cs_window=0)
    cfg = ExperimentConfig(**TRAJ, lstm_cs_window=0)
    batches = _batches(steps)
    jmodel = jax_build_model(jcfg)
    state = init_state(jmodel, jcfg, batches[0][0], batches[0][1])
    step = make_train_step(jmodel, jcfg)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(state.params["params"])))
    opt = make_optimizer(cfg, model)
    for support, query, label in batches:
        state, jm = step(state, support, query, label)
        tm = train_step(model, opt, cfg, support, query, label)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-4)
    want = params_to_jax({k: torch.from_numpy(np.asarray(v)) for k, v in
                          params_from_jax(jax.device_get(state.params["params"])).items()})
    got = params_to_jax(model.state_dict())
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, w, atol=1e-3, err_msg=jax.tree_util.keystr(path))


def test_cli_trains_at_window_zero(tmp_path, capsys):
    """``cli train --lstm_cs_window 0`` trains (it raised before the
    full-residual route was ported) and records the window in config.json."""
    from induction_network_on_fewrel_tpu_torch import cli
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager

    ckpt = tmp_path / "ckpt"
    rc = cli.main(["train", "--synthetic", "--device", "cpu", "--N", "3", "--K", "2", "--Q", "2",
                   "--batch_size", "2", "--max_length", "12", "--vocab_size", "62",
                   "--lstm_hidden", "8", "--induction_dim", "10", "--ntn_slices", "4",
                   "--lstm_cs_window", "0", "--train_iter", "2", "--val_step", "2",
                   "--val_iter", "2", "--save_ckpt", str(ckpt)])
    assert rc == 0
    assert "final_val_accuracy" in capsys.readouterr().out
    assert CheckpointManager.load_config(ckpt).lstm_cs_window == 0
