"""The port's training-route ops vs the JAX package at small widths (CPU).

The same numpy inputs, made from a seed, go through the JAX kernels (in
Pallas interpret mode, as the JAX package's own tests run them) and through
the port's autograd Functions, which on CPU tensors run the plain versions
of K7/K8 (windowed BiLSTM forward/backward) and K10/K11 (attention forward
with stats/backward). Forward outputs and residuals are compared with the
JAX kernels' own, gradients with ``jax.vjp``:

* f32: rtol 1e-4 / atol 1e-5 (the tests/test_lstm.py windowed-gradient bar);
* bf16: 5e-2 (the tests/test_attn.py bf16 band).

The dispatch rule is pinned too: with the kernel route forced and the
launchers replaced by recording fakes, a call that needs a gradient never
reaches the forward-only K1/K2 or the split recurrence's kernel 2, and a
call that needs none never reaches the Functions; ``cs_window=0`` takes
the full-residual kernels K4/K6. (The full-residual and split routes are
held against JAX in tests/test_torch_lstm_full_split.py.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.ops import attn as jattn
from induction_network_on_fewrel_tpu.ops import lstm as jlstm
from induction_network_on_fewrel_tpu_torch.ops import attn as tattn
from induction_network_on_fewrel_tpu_torch.ops import lstm as tlstm

# Deliberately not a multiple of any tile or window: L=12, M=20.
L, M, D, U, A, H = 12, 20, 14, 16, 8, 32
F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _close(got, want, bar):
    np.testing.assert_allclose(_np(got), _np(want), **bar)


@pytest.fixture(scope="module")
def lstm_inputs():
    rng = np.random.default_rng(11)
    emb_t = rng.normal(size=(L, M, D)).astype(np.float32) * 0.5
    wih = (rng.normal(size=(2, D, 4 * U)) / np.sqrt(D)).astype(np.float32)
    b = rng.normal(size=(2, 1, 4 * U)).astype(np.float32) * 0.1
    whh = (rng.normal(size=(2, U, 4 * U)) / np.sqrt(U)).astype(np.float32)
    dhs = rng.normal(size=(L, M, 2 * U)).astype(np.float32)
    return emb_t, wih, b, whh, dhs


@pytest.fixture(scope="module")
def attn_inputs():
    rng = np.random.default_rng(5)
    Ht = rng.normal(size=(L, M, H)).astype(np.float32)
    mask = (rng.random((M, L)) > 0.25).astype(np.float32)
    mask[:, 0] = 1.0
    mask[3] = 0.0                         # a fully masked row
    w1 = (rng.normal(size=(H, A)) / np.sqrt(H)).astype(np.float32)
    w2 = (rng.normal(size=(A, 1)) / np.sqrt(A)).astype(np.float32)
    dout = rng.normal(size=(M, H)).astype(np.float32)
    return Ht, mask, w1, w2, dout


# --- K7: windowed forward and its checkpoints ---------------------------------


@pytest.mark.parametrize("W", [1, 5, 8, L])
@pytest.mark.parametrize("dt,res", [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.bfloat16)])
def test_win_fwd_and_checkpoints_match_jax_interpret(lstm_inputs, W, dt, res):
    emb_t, wih, b, whh, _ = lstm_inputs
    je = jnp.asarray(emb_t).astype(JDT[dt])
    tm = jlstm._pick_tm(M, U, je.dtype.itemsize, D=D, W=W)
    pad = (-M) % tm
    hs, ch, cc = jlstm._fused_win_fwd_call(
        jnp.pad(je, ((0, 0), (0, pad), (0, 0))), jnp.asarray(wih).astype(je.dtype),
        jnp.asarray(b), jnp.asarray(whh), True, tm, W, JDT[res],
    )
    got = tlstm.bilstm_win_fwd_reference(
        torch.from_numpy(emb_t).to(dt), torch.from_numpy(wih).to(dt), torch.from_numpy(b),
        torch.from_numpy(whh), W, res,
    )
    assert got[1].shape == (-(-L // W), M, 2 * U) and got[1].dtype == res
    bar = F32 if dt == res == torch.float32 else BF16
    for g, w in zip(got, (hs, ch, cc)):
        _close(g, w[:, :M], bar)


# --- K7 + K8 through the Function vs jax.vjp ----------------------------------


def _jax_lstm_grads(inputs, W, dt, res):
    emb_t, wih, b, whh, dhs = inputs
    fn = lambda e, wi, bb, wh: jlstm.bilstm_encoder_tm(  # noqa: E731
        e, wi, bb, wh, backend="interpret", cs_window=W,
        residual_dtype=None if res is None else JDT[res],
    )
    je = jnp.asarray(emb_t).astype(JDT[dt])
    out, vjp = jax.vjp(fn, je, jnp.asarray(wih), jnp.asarray(b), jnp.asarray(whh))
    return out, vjp(jnp.asarray(dhs).astype(out.dtype))


def _port_lstm_grads(inputs, W, dt, res):
    emb_t, wih, b, whh, dhs = inputs
    e = torch.from_numpy(emb_t).to(dt).requires_grad_()
    ps = [torch.from_numpy(x).requires_grad_() for x in (wih, b, whh)]
    out = tlstm.bilstm_encoder_tm(e, *ps, backend="reference", cs_window=W, residual_dtype=res)
    grads = torch.autograd.grad(out, [e, *ps], torch.from_numpy(dhs).to(out.dtype))
    return out, grads


@pytest.mark.parametrize("W", [1, 8, L])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_windowed_bilstm_grads_match_jax_vjp(lstm_inputs, W, dt):
    want_out, want = _jax_lstm_grads(lstm_inputs, W, dt, None)
    got_out, got = _port_lstm_grads(lstm_inputs, W, dt, None)
    bar = F32 if dt == torch.float32 else BF16
    assert got_out.dtype == dt and got[0].dtype == dt
    _close(got_out, want_out, bar)
    for name, g, w in zip(("demb", "dwih", "db", "dwhh"), got, want):
        assert g.shape == tuple(w.shape), name
        _close(g, w, bar)


def test_bf16_residuals_in_f32_compute_match_jax(lstm_inputs):
    """f32 activations with bf16 checkpoints: only the window seeds round."""
    _, want = _jax_lstm_grads(lstm_inputs, 5, torch.float32, torch.bfloat16)
    _, got = _port_lstm_grads(lstm_inputs, 5, torch.float32, torch.bfloat16)
    for g, w in zip(got, want):
        _close(g, w, BF16)


def test_windowed_grads_same_at_every_window(lstm_inputs):
    """f32 residuals: the window is a pure runtime knob (replay is exact)."""
    _, base = _port_lstm_grads(lstm_inputs, L, torch.float32, torch.float32)
    for W in (1, 3, 7):
        _, got = _port_lstm_grads(lstm_inputs, W, torch.float32, torch.float32)
        for g, w in zip(got, base):
            _close(g, w, dict(rtol=1e-5, atol=1e-6))


def test_window_zero_refused_with_grad(kernel_route, lstm_inputs):
    """W = 0 is no longer refused: with a gradient needed it takes the
    full-residual route (K4 forward, K6 backward, never K7/K8), and its f32
    gradients equal the W = L windowed ones (one window replayed from the
    zero state is the forward's own f32 arithmetic)."""
    _, want = _port_lstm_grads(lstm_inputs, L, torch.float32, torch.float32)
    kernel_route.clear()
    _, got = _port_lstm_grads(lstm_inputs, 0, torch.float32, torch.float32)
    assert kernel_route == ["K4", "K6"]
    for name, g, w in zip(("demb", "dwih", "db", "dwhh"), got, want):
        _close(g, w, dict(rtol=1e-5, atol=1e-5))


# --- K10 + K11 ------------------------------------------------------------------


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_attn_fwd_stats_match_jax_kernel(attn_inputs, dt):
    Ht, mask, w1, w2, _ = attn_inputs
    jH = jnp.asarray(Ht).astype(JDT[dt])
    Hp, mp, _ = jattn._pad_rows(jH, jnp.asarray(mask).T)
    out, mx, dn = jattn._fwd_call(Hp, mp, jnp.asarray(w1), jnp.asarray(w2), True, with_stats=True)
    got = tattn.attn_fwd_stats_reference(
        torch.from_numpy(Ht).to(dt), torch.from_numpy(mask), torch.from_numpy(w1),
        torch.from_numpy(w2),
    )
    bar = F32 if dt == torch.float32 else BF16
    _close(got[0], out[:M], bar)
    live = mask.sum(1) > 0
    _close(got[1][live], np.asarray(mx)[0, :M][live], bar)
    _close(got[2], np.asarray(dn)[0, :M], bar)
    assert float(got[2][3]) == 0.0 and float(got[0][3].abs().max()) == 0.0


@pytest.mark.parametrize("jax_backend", ["interpret", "xla_remat_interpret"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_attn_grads_match_jax_vjp(attn_inputs, jax_backend, dt):
    Ht, mask, w1, w2, dout = attn_inputs
    fn = lambda h, a, b: jattn.masked_selfattn_tm(h, jnp.asarray(mask), a, b,  # noqa: E731
                                                  backend=jax_backend)
    jH = jnp.asarray(Ht).astype(JDT[dt])
    want_out, vjp = jax.vjp(fn, jH, jnp.asarray(w1), jnp.asarray(w2))
    want = vjp(jnp.asarray(dout).astype(want_out.dtype))
    h = torch.from_numpy(Ht).to(dt).requires_grad_()
    a, b = (torch.from_numpy(x).requires_grad_() for x in (w1, w2))
    out = tattn.masked_selfattn_tm(h, torch.from_numpy(mask), a, b, backend="reference")
    got = torch.autograd.grad(out, [h, a, b], torch.from_numpy(dout).to(out.dtype))
    bar = F32 if dt == torch.float32 else BF16
    _close(out, want_out, bar)
    assert got[0].dtype == dt
    for g, w in zip(got, want):
        _close(g, w, bar)
    assert float(got[0][:, 3].float().abs().max()) == 0.0   # fully masked row: exact zeros


def test_attn_mask_gets_no_gradient(attn_inputs):
    Ht, mask, w1, w2, dout = attn_inputs
    m = torch.from_numpy(mask).requires_grad_()
    h = torch.from_numpy(Ht).requires_grad_()
    out = tattn.masked_selfattn_tm(h, m, *map(torch.from_numpy, (w1, w2)), backend="reference")
    (out * torch.from_numpy(dout)).sum().backward()
    assert m.grad is None and h.grad is not None


# --- dispatch rule --------------------------------------------------------------


@pytest.fixture
def kernel_route(monkeypatch):
    """Force the kernel route on CPU tensors and record which launcher runs
    (each fake delegates to its plain version)."""
    calls = []

    def fake(name, plain):
        def run(*args):
            calls.append(name)
            return plain(*args)
        return run

    for mod in (tlstm, tattn):
        monkeypatch.setattr(mod, "resolve_backend", lambda backend, device: "cuda")
    monkeypatch.setattr(tlstm, "bilstm_infer_cuda", fake("K1", tlstm.bilstm_reference))
    monkeypatch.setattr(tlstm, "bilstm_win_fwd", fake("K7", tlstm.bilstm_win_fwd_reference))
    monkeypatch.setattr(tlstm, "bilstm_win_bwd", fake("K8", tlstm.bilstm_win_bwd_reference))
    monkeypatch.setattr(tlstm, "bilstm_full_fwd", fake("K4", tlstm.bilstm_full_fwd_reference))
    monkeypatch.setattr(tlstm, "bilstm_full_bwd", fake("K6", tlstm.bilstm_full_bwd_reference))
    monkeypatch.setattr(tlstm, "lstm_split_infer_cuda",
                        fake("split2", tlstm.lstm_split_infer_reference))
    monkeypatch.setattr(tlstm, "lstm_split_fwd", fake("split1", tlstm.lstm_split_fwd_reference))
    monkeypatch.setattr(tlstm, "lstm_split_bwd", fake("split3", tlstm.lstm_split_bwd_reference))
    monkeypatch.setattr(tattn, "attn_fwd_cuda", fake("K2", tattn.attn_reference))
    monkeypatch.setattr(tattn, "attn_fwd_stats", fake("K10", tattn.attn_fwd_stats_reference))
    monkeypatch.setattr(tattn, "attn_bwd", fake("K11", tattn.attn_bwd_reference))
    return calls


@pytest.mark.parametrize("grad_mode", [True, False])
@pytest.mark.parametrize("requires_grad", [True, False])
def test_dispatch_rule(kernel_route, lstm_inputs, attn_inputs, grad_mode, requires_grad):
    emb_t, wih, b, whh, _ = lstm_inputs
    Ht, mask, w1, w2, _ = attn_inputs
    lstm_args = [torch.from_numpy(x).requires_grad_(requires_grad) for x in (emb_t, wih, b, whh)]
    attn_args = [torch.from_numpy(Ht).requires_grad_(requires_grad), torch.from_numpy(mask),
                 torch.from_numpy(w1), torch.from_numpy(w2)]
    xg_t = torch.zeros((L, M, 8 * U), requires_grad=requires_grad)
    with torch.set_grad_enabled(grad_mode):
        hs = tlstm.bilstm_encoder_tm(*lstm_args)
        out = tattn.masked_selfattn_tm(*attn_args)
        rec = tlstm.bilstm_recurrence_tm(xg_t, lstm_args[3])
    if grad_mode and requires_grad:
        assert kernel_route == ["K7", "K10", "split1"]
        assert all(y.grad_fn is not None for y in (hs, out, rec))
        (hs.float().sum() + out.float().sum() + rec.sum()).backward()
        assert sorted(kernel_route) == ["K10", "K11", "K7", "K8", "split1", "split3"]
        assert all(x.grad is not None for x in lstm_args + attn_args[:1] + [xg_t])
    else:
        assert kernel_route == ["K1", "K2", "split2"]
        assert all(y.grad_fn is None for y in (hs, out, rec))


def test_forward_only_kernels_refuse_grad_inputs(lstm_inputs, attn_inputs):
    """K1/K2 and kernel 2 would return detached outputs: with grad enabled
    on an input that requires grad they raise before any device check or
    launch."""
    emb_t, wih, b, whh, _ = lstm_inputs
    Ht, mask, w1, w2, _ = attn_inputs
    fns = (tlstm.bilstm_infer_cuda, tattn.attn_fwd_cuda, tlstm.lstm_split_infer_cuda)
    before = [f.launches for f in fns]
    e = torch.from_numpy(emb_t).requires_grad_()
    with pytest.raises(RuntimeError, match="requires grad"):
        tlstm.bilstm_infer_cuda(e, *map(torch.from_numpy, (wih, b, whh)))
    h = torch.from_numpy(Ht).requires_grad_()
    with pytest.raises(RuntimeError, match="requires grad"):
        tattn.attn_fwd_cuda(h, *map(torch.from_numpy, (mask, w1, w2)))
    with pytest.raises(RuntimeError, match="requires grad"):
        tlstm.lstm_split_infer_cuda(torch.zeros((L, M, 8 * U), requires_grad=True),
                                    torch.from_numpy(whh), True)
    assert [f.launches for f in fns] == before


@pytest.mark.parametrize("wrapper", ["win_fwd", "win_bwd", "attn_stats", "attn_bwd", "full_fwd",
                                     "full_bwd", "split_infer", "split_fwd", "split_bwd"])
def test_training_kernel_wrappers_refuse_cpu_tensors(lstm_inputs, attn_inputs, wrapper):
    emb_t, wih, b, whh, dhs = lstm_inputs
    Ht, mask, w1, w2, dout = attn_inputs
    t = lambda *xs: [torch.from_numpy(x) for x in xs]  # noqa: E731
    fns = {"win_fwd": tlstm.bilstm_win_fwd, "win_bwd": tlstm.bilstm_win_bwd,
           "attn_stats": tattn.attn_fwd_stats, "attn_bwd": tattn.attn_bwd,
           "full_fwd": tlstm.bilstm_full_fwd, "full_bwd": tlstm.bilstm_full_bwd,
           "split_infer": tlstm.lstm_split_infer_cuda, "split_fwd": tlstm.lstm_split_fwd,
           "split_bwd": tlstm.lstm_split_bwd}
    before = fns[wrapper].launches
    xg, hs = torch.zeros((L, M, 8 * U)), torch.zeros((L, M, 2 * U))
    with pytest.raises(RuntimeError, match="CUDA device"):
        if wrapper == "win_fwd":
            tlstm.bilstm_win_fwd(*t(emb_t, wih, b, whh), 8, torch.float32)
        elif wrapper == "win_bwd":
            ch = torch.zeros((2, M, 2 * U))
            tlstm.bilstm_win_bwd(torch.from_numpy(dhs), *t(emb_t), ch, ch, *t(wih, b, whh), 8)
        elif wrapper == "full_fwd":
            tlstm.bilstm_full_fwd(*t(emb_t, wih, b, whh), torch.float32)
        elif wrapper == "full_bwd":
            tlstm.bilstm_full_bwd(torch.from_numpy(dhs), *t(emb_t), hs, hs, *t(wih, b, whh))
        elif wrapper == "split_infer":
            tlstm.lstm_split_infer_cuda(xg, torch.from_numpy(whh), True)
        elif wrapper == "split_fwd":
            tlstm.lstm_split_fwd(xg, torch.from_numpy(whh), True)
        elif wrapper == "split_bwd":
            tlstm.lstm_split_bwd(hs, xg, hs, hs, torch.from_numpy(whh), True)
        elif wrapper == "attn_stats":
            tattn.attn_fwd_stats(*t(Ht, mask, w1, w2))
        else:
            st = torch.zeros(M)
            tattn.attn_bwd(*t(Ht, mask, w1, w2), torch.from_numpy(dout), st, st,
                           torch.from_numpy(dout))
    assert fns[wrapper].launches == before


def test_win_bwd_tile_fits_shared_memory():
    """K8's plan (``bwd_plan``) keeps its window in shared memory: 32-row
    tiles at W=8 and M=200, smaller tiles for a longer window, and a width
    whose window fits no tile is refused (tests/test_torch_lstm_bwd_plan.py
    covers the other rows and windows)."""
    plan = tlstm.bwd_plan(200, 60, 128, 8)
    assert (plan.tm, plan.smem) == (32, tlstm.bwd_smem(32, 8, 60, 128, 8))
    assert plan.smem <= tlstm.SMEM_LIMIT
    plan = tlstm.bwd_plan(200, 60, 128, 40)          # W = L at the flagship widths
    assert plan.tm == 8 and plan.smem <= tlstm.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        tlstm.bwd_plan(200, 60, 128, 1000)
