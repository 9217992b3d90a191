"""The backward chain's plan and the two-stage backward of K8 and K6.

The kernels run only on the card (``chip_smoke.py``); here, on the CPU:

* ``bwd_plan``, the plan that K8's, K6's and kernel 3's wrappers hand to the
  cluster backward chain: it fits a block's shared memory at the flagship
  widths, its byte formula is the header's, M=200 is one wave (or the plan
  says why not), and a width the body cannot take is refused before
  anything is launched;
* each backward wrapper launches its chain kernel with the plan and then
  the weight-gradient kernel (``lstm_wgrad``), recorded instead of run;
* the plain two-stage version (``bilstm_bwd_chain_reference`` then
  ``lstm_wgrad_reference``) equals the one-stage plain versions
  (``bilstm_win_bwd_reference``, ``bilstm_full_bwd_reference``) within 1e-5
  in f32, and the JAX ``jax.vjp`` of ``_bilstm_fused_tm`` in interpret mode
  within the bars of tests/test_torch_train_ops.py (f32 rtol 1e-4 / atol
  1e-5, bf16 5e-2), at W in {1, 6, 8, L} and 0 with a ragged M;
* at a window's kernel-first step the h_prev the chain hands on is the
  checkpoint seed rounded to the residual dtype;
* the phase profiler names every ``BWD_PHASE`` mark of the header.
"""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import induction_network_on_fewrel_tpu_torch.ops.lstm as tlstm
from induction_network_on_fewrel_tpu.ops import lstm as jlstm
from induction_network_on_fewrel_tpu_torch.kernels import fwd_phases
from induction_network_on_fewrel_tpu_torch.kernels.build import CSRC

FL, FD, FU = 40, 60, 128                  # the flagship widths
ROWS = (1, 4, 16, 25, 100, 200)
WINDOWS = (1, 6, 8, 40)
L, M, D, U = 12, 13, 10, 8               # small widths; M ragged
F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize("M_", ROWS)
@pytest.mark.parametrize("W", WINDOWS + (0,))
def test_bwd_plan_fits_shared_memory(M_, W):
    plan = tlstm.bwd_plan(M_, FD, FU, W)
    assert plan.smem == tlstm.bwd_smem(plan.tm, plan.cluster, FD, FU, W) <= tlstm.SMEM_LIMIT
    assert plan.cluster == 8 and (FU // plan.cluster) % 4 == 0
    assert plan.tm % 4 == 0 and plan.threads == tlstm.FWD_THREADS
    assert plan.tm // 4 * FU // 4 <= plan.threads        # one dh tile per thread
    assert plan.ctas == -(-M_ // plan.tm) * 2 * plan.cluster
    assert (plan.ctas <= tlstm.NUM_SMS) == (plan.why == "")


@pytest.mark.parametrize("M_", (16, 200))
def test_split_bwd_plan_fits_shared_memory(M_):
    """Kernel 3: no projection, no window, Gc = 2 groups."""
    plan = tlstm.bwd_plan(M_, 0, FU, 0, 2)
    assert plan.smem == tlstm.bwd_smem(plan.tm, 8, 0, FU, 0) <= tlstm.SMEM_LIMIT
    assert plan.ctas <= tlstm.NUM_SMS


@pytest.mark.parametrize("W", (8, 6, 0))
def test_bwd_plan_m200_is_one_wave(W):
    """The training step's 200 rows: 7 tiles of 32 x 2 directions x 8 CTAs."""
    plan = tlstm.bwd_plan(200, FD, FU, W)
    assert (plan.tm, plan.cluster, plan.ctas, plan.why) == (32, 8, 112, "")


def test_bwd_plan_says_why_a_long_window_takes_more_waves():
    """W = L = 40 at M = 200: the window of a 32- or 16-row tile does not fit,
    so 8-row tiles run 400 CTAs, and the plan names the reason."""
    plan = tlstm.bwd_plan(200, FD, FU, 40)
    assert plan.tm == 8 and plan.ctas == 400
    assert re.search(r"16-row tile at W=40 would need \d+ bytes of shared memory", plan.why)


def test_bwd_smem_formula_matches_the_header():
    """``lstm::bwd_smem`` in csrc/lstm_common.cuh, written out at the
    flagship widths (NC = 64 columns and 16 units a CTA; TM = 32: split-K
    S = 2, projection split P = 1): four mbarriers, W_hh [u, NC], W_ih
    [D, NC], b [NC], 2 h [u, TM], gates [P, TM, NC], partials [S, TM, NC + 8],
    embeddings [D, TM + 2] (rounded to 4 floats), the window [W, 5, TM * 16]
    and the reduce-scatter buffers [2, 8, 16, TM]; h buffers of row stride
    TM + 4 without a window."""
    nc, tm = 64, 32

    def core(hs):
        return (FU * nc + FD * nc + nc + 2 * FU * hs + tm * nc + 2 * tm * (nc + 8)
                + FD * (tm + 2))
    assert tlstm.bwd_smem(tm, 8, FD, FU, 8) == 32 + 4 * (core(tm) + 5 * 8 * tm * 16 + 2 * tm * FU)
    assert tlstm.bwd_smem(tm, 8, FD, FU, 0) == 32 + 4 * (core(tm + 4) + 2 * tm * FU)
    assert tlstm.bwd_smem(tm, 8, FD, FU, 8) == 230656
    src = (CSRC / "lstm_common.cuh").read_text()
    assert re.search(r"return 32 \+ sizeof\(float\) \* \(fwd_core_floats\(TM, C, D, u, "
                     r"W \? TM : TM \+ 4\) \+\s+5 \* \(size_t\)W \* TM \* \(u / C\) \+ "
                     r"2 \* \(size_t\)TM \* u\);", src)
    assert "MODE == kWindow ? TM : TM + 4" in src
    assert "((size_t)D * (TM + 2) + 3) / 4 * 4" in src
    assert "if (TM < 4 || TM % 4 || C < 1 || C > 8 || u < C || u % C || (u / C) % 4)" in src


def _fused(dt, M_, u=FU, d=FD, L_=FL):
    return (torch.zeros((L_, M_, d), dtype=dt), torch.zeros((2, d, 4 * u), dtype=dt),
            torch.zeros((2, 1, 4 * u)), torch.zeros((2, u, 4 * u)))


def _call(wrapper, dt, M_, u=FU, d=FD, W=8):
    """Call a backward wrapper on CPU tensors of the given widths."""
    emb, wih, b, whh = _fused(dt, M_, u, d)
    dhs = torch.zeros((FL, M_, 2 * u), dtype=dt)
    if wrapper == "K8":
        ch = torch.zeros((-(-FL // W), M_, 2 * u), dtype=dt)
        return tlstm.bilstm_win_bwd(dhs, emb, ch, ch, wih, b, whh, W)
    if wrapper == "K6":
        return tlstm.bilstm_full_bwd(dhs, emb, dhs, dhs, wih, b, whh)
    xg = torch.zeros((FL, M_, 8 * u), dtype=dt)
    return tlstm.lstm_split_bwd(dhs, xg, dhs, dhs, whh, True)


CHAIN = {"K8": "bilstm_win_bwd", "K6": "bilstm_full_bwd", "split3": "lstm_split_bwd"}
COUNTED = {"K8": tlstm.bilstm_win_bwd, "K6": tlstm.bilstm_full_bwd, "split3": tlstm.lstm_split_bwd}


@pytest.mark.parametrize("M_", (1, 16, 100, 200))
@pytest.mark.parametrize("dt", (torch.float32, torch.bfloat16), ids=["f32", "bf16"])
@pytest.mark.parametrize("wrapper", sorted(CHAIN))
def test_backward_wrappers_launch_chain_then_wgrad(monkeypatch, wrapper, dt, M_):
    """Each backward wrapper launches its chain kernel with the plan's row
    tile and cluster size (the last two arguments), then the weight-gradient
    kernel, and counts one launch of each; the launches are recorded
    instead of run."""
    calls = []
    monkeypatch.setattr(tlstm, "check_cuda_tensors", lambda *a: None)
    monkeypatch.setattr(tlstm, "_launch", lambda name, dev, *args: calls.append((name, args)))
    before = (COUNTED[wrapper].launches, tlstm.lstm_wgrad.launches)
    _call(wrapper, dt, M_)
    plan = tlstm.bwd_plan(M_, 0 if wrapper == "split3" else FD, FU, 8 if wrapper == "K8" else 0)
    assert [n for n, _ in calls] == [CHAIN[wrapper], "lstm_wgrad"]
    assert calls[0][1][-2:] == (plan.tm, plan.cluster)
    wg = calls[1][1]
    assert wg[8:13] == (FL, M_, 0 if wrapper == "split3" else FD, FU, 2)
    assert wg[-4] == (0 if wrapper == "K8" else 1)            # shift: hs, not hp
    assert wg[-1] == int(wrapper == "K8" or dt == torch.float32)  # h in f32
    assert (COUNTED[wrapper].launches, tlstm.lstm_wgrad.launches) == (before[0] + 1, before[1] + 1)


# u = 6 leaves no cluster size with a multiple of 4 units a CTA; u = 127
# neither; D = 1000 puts a 240 KB W_ih slice in shared memory.
REFUSED = [(w, u, FD, "multiple of 4 units") for w in sorted(CHAIN) for u in (6, 127)]
REFUSED += [(w, FU, 1000, "shared memory") for w in ("K6", "K8")]


@pytest.mark.parametrize("wrapper, u, d, why", REFUSED)
def test_backward_wrapper_refuses_widths_the_body_cannot_take(wrapper, u, d, why):
    """Refused by name before any device check or launch."""
    before = (COUNTED[wrapper].launches, tlstm.lstm_wgrad.launches)
    with pytest.raises(ValueError, match=f"{CHAIN[wrapper]}: .*cannot take .*{why}"):
        _call(wrapper, torch.float32, 16, u, d)
    assert (COUNTED[wrapper].launches, tlstm.lstm_wgrad.launches) == before


def test_lstm_wgrad_refuses_cpu_tensors_and_wrong_streams():
    emb, wih, _, _ = _fused(torch.float32, 4, U, D, L)
    da = torch.zeros((2, L, 4, 4 * U))
    with pytest.raises(ValueError, match="neither hp nor hs"):
        tlstm.lstm_wgrad(da, emb, torch.zeros((2, L, 4, U), dtype=torch.bfloat16), wih)
    with pytest.raises(ValueError, match="da"):
        tlstm.lstm_wgrad(da[:1], emb, torch.zeros((2, L, 4, U)), wih)
    before = tlstm.lstm_wgrad.launches
    with pytest.raises(RuntimeError, match="CUDA device"):
        tlstm.lstm_wgrad(da, emb, torch.zeros((2, L, 4, U)), wih)
    assert tlstm.lstm_wgrad.launches == before


# --- the two-stage plain version ----------------------------------------------


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    emb_t = rng.normal(size=(L, M, D)).astype(np.float32) * 0.5
    wih = (rng.normal(size=(2, D, 4 * U)) / np.sqrt(D)).astype(np.float32)
    b = rng.normal(size=(2, 1, 4 * U)).astype(np.float32) * 0.1
    whh = (rng.normal(size=(2, U, 4 * U)) / np.sqrt(U)).astype(np.float32)
    dhs = rng.normal(size=(L, M, 2 * U)).astype(np.float32)
    return emb_t, wih, b, whh, dhs


def _torch(inputs, dt):
    emb_t, wih, b, whh, dhs = inputs
    return (torch.from_numpy(dhs).to(dt), torch.from_numpy(emb_t).to(dt),
            torch.from_numpy(wih).to(dt), torch.from_numpy(b), torch.from_numpy(whh))


def _two_stage(inputs, W, dt, res):
    """(one-stage plain outputs, two-stage plain outputs, (da, hp), residuals)."""
    dhs, emb, wih, b, whh = _torch(inputs, dt)
    if W:
        _, r1, r2 = tlstm.bilstm_win_fwd_reference(emb, wih, b, whh, W, res)
        one = tlstm.bilstm_win_bwd_reference(dhs, emb, r1, r2, wih, b, whh, W)
    else:
        r1, r2 = tlstm.bilstm_full_fwd_reference(emb, wih, b, whh, res)
        one = tlstm.bilstm_full_bwd_reference(dhs, emb, r1, r2, wih, b, whh)
    da, hp = tlstm.bilstm_bwd_chain_reference(dhs, emb, r1, r2, wih, b, whh, W)
    return one, tlstm.lstm_wgrad_reference(da, emb, hp, wih), (da, hp), (r1, r2)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("W", (1, 6, 8, L, 0))
@pytest.mark.parametrize("dt", (torch.float32, torch.bfloat16), ids=["f32", "bf16"])
def test_two_stage_equals_one_stage_and_jax_vjp(inputs, W, dt):
    one, two, (da, hp), _ = _two_stage(inputs, W, dt, dt)
    assert da.shape == (2, L, M, 4 * U) and hp.shape == (2, L, M, U)
    assert da.dtype == hp.dtype == torch.float32
    assert two[0].dtype == dt and two[0].shape == (2, L, M, D)
    for name, g, w in zip(("demb", "dwih", "db", "dwhh"), two, one):
        assert g.shape == w.shape, name
        # demb rounds once from the same f32 product; the sums differ in order.
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-5 if dt == torch.float32
                                   else 2 ** -7 * float(w.float().abs().max()), err_msg=name)
    emb_t, wih, b, whh, dhs = inputs
    fn = lambda e, wi, bb, wh: jlstm.bilstm_encoder_tm(  # noqa: E731
        e, wi, bb, wh, backend="interpret", cs_window=W)
    out, vjp = jax.vjp(fn, jnp.asarray(emb_t).astype(JDT[dt]), jnp.asarray(wih),
                       jnp.asarray(b), jnp.asarray(whh))
    want = vjp(jnp.asarray(dhs).astype(out.dtype))
    got = (two[0][0] + two[0][1], two[1].to(dt), two[2].reshape(2, 1, -1), two[3])
    for name, g, w in zip(("demb", "dwih", "db", "dwhh"), got, want):
        np.testing.assert_allclose(_np(g), _np(w), **(F32 if dt == torch.float32 else BF16),
                                   err_msg=name)


@pytest.mark.parametrize("W", (1, 5))
def test_chain_hands_on_the_rounded_seed_as_h_prev(inputs, W):
    """f32 activations, bf16 checkpoints: at a window's kernel-first step
    h_prev is the seed as stored (bf16, upcast), not the f32 replayed h of
    the neighbouring window; inside a window it is the replayed h, and the
    gradients still match JAX within the bf16-residual band."""
    _, two, (da, hp), (ch, _) = _two_stage(inputs, W, torch.float32, torch.bfloat16)
    nB = ch.shape[0]
    for blk in range(1, nB):                                  # forward direction
        torch.testing.assert_close(hp[0, blk * W], ch[blk - 1, :, :U].float(), rtol=0, atol=0)
    for blk in range(nB - 1):                                 # reverse direction
        t = min(L, (blk + 1) * W) - 1
        torch.testing.assert_close(hp[1, t], ch[blk + 1, :, U:].float(), rtol=0, atol=0)
    assert (hp[0, 0] == 0).all() and (hp[1, L - 1] == 0).all()
    if W > 1:
        assert not torch.equal(hp[0, 1], hp[0, 1].bfloat16().float())   # replayed f32 h
    emb_t, wih, b, whh, dhs = inputs
    fn = lambda e, wi, bb, wh: jlstm.bilstm_encoder_tm(  # noqa: E731
        e, wi, bb, wh, backend="interpret", cs_window=W, residual_dtype=jnp.bfloat16)
    _, vjp = jax.vjp(fn, jnp.asarray(emb_t), jnp.asarray(wih), jnp.asarray(b), jnp.asarray(whh))
    want = vjp(jnp.asarray(dhs))
    got = (two[0][0] + two[0][1], two[1], two[2].reshape(2, 1, -1), two[3])
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **BF16)


def test_chain_rows_are_independent(inputs):
    """A ragged row count changes nothing for the rows that remain (the
    kernels mask their last tile): the chain of the first 5 rows equals the
    first 5 rows of the 13-row chain."""
    dhs, emb, wih, b, whh = _torch(inputs, torch.float32)
    _, r1, r2 = tlstm.bilstm_win_fwd_reference(emb, wih, b, whh, 6, torch.float32)
    da, hp = tlstm.bilstm_bwd_chain_reference(dhs, emb, r1, r2, wih, b, whh, 6)
    da5, hp5 = tlstm.bilstm_bwd_chain_reference(dhs[:, :5], emb[:, :5], r1[:, :5], r2[:, :5],
                                                wih, b, whh, 6)
    torch.testing.assert_close(da5, da[:, :, :5], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(hp5, hp[:, :, :5], rtol=1e-6, atol=1e-7)


def test_phase_profiler_names_every_backward_mark(monkeypatch):
    """kernels/fwd_phases.py names one backward phase per BWD_PHASE mark of
    the header and reads all of them; without a card it refuses before
    building anything."""
    src = (CSRC / "lstm_common.cuh").read_text()
    marks = sorted(int(i) for i in re.findall(r"BWD_PHASE\((\d)\);", src))
    assert marks == list(range(len(fwd_phases.BWD_PHASES)))
    assert f"bwd_phase_cycles[{len(marks)}]" in src
    for stem in fwd_phases.BWD_SOURCES.values():
        assert "int bilstm_bwd_phases(void* out, int reset)" in (CSRC / f"{stem}.cu").read_text()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(fwd_phases, "build_bwd", lambda: pytest.fail("built without a card"))
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        fwd_phases.main([])
