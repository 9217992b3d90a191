"""The launch plans of the attention kernels (K2/K10 forward, K11 backward),
and the forward's split-and-merge twin against the JAX kernel.

The kernels run only on the card (``chip_smoke.py``). Here, on the CPU:
both plans fit a block's shared memory at the flagship widths and at a wide
D = 1280, A = 300; they put enough CTAs to work at serving and training
sizes; their byte formulas are the header's; every wrapper hands its
launcher the plan and K11 returns its weight gradients whole; a width no
plan takes is refused before anything is launched. And the plain twin of
the forward's token split and rank-ordered merge of partial softmaxes
(``attn_fwd_split_reference``) matches the JAX interpret-mode kernel and
``_attn_reference`` for every plan at those row counts: f32 within 1e-5,
bf16 within the 1e-2 band of tests/test_torch_ops.py, with a fully masked
row, and with L not a multiple of the 8-way split.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.ops import attn as jattn
from induction_network_on_fewrel_tpu_torch.kernels.build import CSRC
from induction_network_on_fewrel_tpu_torch.ops import attn as tattn

L, D, A = 40, 256, 64                 # the flagship: L=40, 2u=256, A=64
WIDTHS = {"flagship": (D, A), "wide": (1280, 300)}
ROWS = (1, 4, 16, 25, 100, 200)
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_plans_fit_shared_memory(M, width):
    d, a = WIDTHS[width]
    fwd = tattn.attn_fwd_plan(M, L, d, a)
    assert fwd.smem == tattn.attn_fwd_smem(fwd.tile, fwd.rows, d) <= tattn.SMEM_LIMIT
    assert fwd.tile in tattn.TILES and fwd.rows * fwd.chunk <= fwd.tile
    assert fwd.cluster == 8 and fwd.steps * fwd.cluster >= L and fwd.chunk == fwd.steps
    assert fwd.ctas == -(-M // fwd.rows) * fwd.cluster
    bwd = tattn.attn_bwd_plan(M, L, d, a)
    assert bwd.smem == tattn.attn_bwd_smem(bwd.tile, a) <= tattn.SMEM_LIMIT
    assert bwd.wgrad_smem <= tattn.SMEM_LIMIT
    assert bwd.ctas == -(-L * M // bwd.tile)
    assert bwd.wgrad_ctas == (-(-d // 32) * -(-a // 64) + -(-a // 64)) * 16


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_plans_put_the_card_to_work(width):
    d, a = WIDTHS[width]
    fwd = {M: tattn.attn_fwd_plan(M, L, d, a) for M in (1, 4, 16, 200)}
    bwd = {M: tattn.attn_bwd_plan(M, L, d, a) for M in (16, 200)}
    assert fwd[200].ctas >= 120 and bwd[200].ctas >= 120
    assert fwd[16].ctas >= 64 and bwd[16].ctas >= 64
    for M in (1, 4):             # each row spread over a whole cluster of 8 CTAs
        assert (fwd[M].rows, fwd[M].cluster, fwd[M].ctas) == (1, 8, 8 * M)


def test_flagship_plans():
    assert tattn.attn_fwd_plan(200, L, D, A)[:6] == (64, 8, 8, 5, 5, 200)
    assert tattn.attn_fwd_plan(16, L, D, A)[:6] == (8, 8, 1, 5, 5, 128)
    assert tattn.attn_fwd_plan(200, L, 1280, 300)[:6] == (16, 8, 3, 5, 5, 536)
    assert tattn.attn_bwd_plan(200, L, D, A)[:2] == (16, 500)
    assert tattn.attn_bwd_plan(16, L, D, A)[:2] == (8, 80)
    assert tattn.attn_bwd_plan(200, L, D, A).wgrad_ctas == 144      # (8 + 1) tiles x 16
    # A row longer than 8 x 64 steps passes its steps in chunks of 64.
    long = tattn.attn_fwd_plan(3, 1000, D, A)
    assert (long.tile, long.rows, long.steps, long.chunk) == (64, 1, 125, 64)


def test_smem_formulas_match_the_header():
    """``attn::engine_floats``/``fwd_smem``/``bwd_smem``/``wgrad_smem`` in
    csrc/attn_common.cuh, written out at the flagship widths: two slabs
    of each operand [64, R + 4] and [64, 68], split partials [64, 64]; the
    forward adds half-row score sums [2R], scores and weights [2R], the
    rows' stats [3G], the merge factors [8G] and sums [G, D]; K11 adds tanh(P)
    [R, A] and [2R]; the weight-gradient kernel runs the engine at 32 rows
    and adds its partial tile [32, 64]."""
    eng = {R: 2 * 64 * (R + 4) + 2 * 64 * 68 + 64 * 64 for R in tattn.TILES}
    assert all(tattn.engine_floats(R) == eng[R] for R in tattn.TILES)
    assert tattn.attn_fwd_smem(64, 12, D) == 4 * (eng[64] + 256 + 132 + 12 * D) == 99856
    assert tattn.attn_fwd_smem(64, 8, D) == 4 * (eng[64] + 256 + 88 + 8 * D) == 95584
    assert tattn.attn_fwd_smem(8, 1, D) == 4 * (eng[8] + 32 + 11 + D)
    assert tattn.attn_bwd_smem(32, A) == 4 * (eng[32] + 32 * A + 64) == 78080
    assert tattn.attn_wgrad_smem() == 4 * (eng[32] + 32 * 64) == 77824
    src = (CSRC / "attn_common.cuh").read_text()
    for line in (
        "constexpr int THREADS = 256;",
        f"constexpr int CW = {tattn.CW};",
        f"constexpr int SLAB = {tattn.SLAB};",
        f"constexpr int SPLIT = {tattn.SPLIT};",
        f"constexpr int WSPLIT = {tattn.WSPLIT};",
        f"constexpr int WR = {tattn.WR};",
        f"constexpr size_t SMEM_LIMIT = {tattn.SMEM_LIMIT};",
        "return 2 * SLAB * (R + 4) + 2 * SLAB * (CW + 4) + 64 * CW;",
        "return 4 * ((size_t)engine_floats(R) + 4 * R + (3 + SPLIT) * G + (size_t)G * D);",
        "return 4 * ((size_t)engine_floats(R) + (size_t)R * A + 2 * R);",
        "return 4 * ((size_t)engine_floats(WR) + WR * CW);",
    ):
        assert line in src, line


def _cpu(M, d, a, dt=torch.float32, Lx=L):
    H = torch.zeros((Lx, M, d), dtype=dt)
    return H, torch.ones((M, Lx)), torch.zeros((d, a)), torch.zeros((a, 1))


@pytest.fixture
def recorded(monkeypatch):
    """Record each launch (name, args) instead of running it; the tensors
    stay on the CPU."""
    calls = []
    monkeypatch.setattr(tattn, "check_cuda_tensors", lambda *a: None)
    monkeypatch.setattr(tattn, "_launch", lambda name, dev, *args: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("M", (1, 16, 200))
@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wrappers_launch_with_the_plan(recorded, M, width, dt):
    """K2 and K10 pass (tile, cluster, rows, steps, chunk) last, K11 its
    tile and the dtype flag; K11's dW1 and dw2 are the buffers its launcher
    wrote, returned as they are (no reduction after the kernel). The wide
    case is past the old limits (D <= 1024, A <= 256)."""
    d, a = WIDTHS[width]
    H, mask, w1, w2 = _cpu(M, d, a, dt)
    counts = [f.launches for f in (tattn.attn_fwd_cuda, tattn.attn_fwd_stats, tattn.attn_bwd)]
    tattn.attn_fwd_cuda(H, mask, w1, w2)
    out, mx, dn = tattn.attn_fwd_stats(H, mask, w1, w2)
    dH, dw1, dw2 = tattn.attn_bwd(H, mask, w1, w2, out, mx, dn, torch.zeros((M, d), dtype=dt))
    fwd = tattn.attn_fwd_plan(M, L, d, a)
    bwd = tattn.attn_bwd_plan(M, L, d, a)
    want = (fwd.tile, fwd.cluster, fwd.rows, fwd.steps, fwd.chunk)
    bf = int(dt == torch.bfloat16)
    assert [n for n, _ in recorded] == ["attn_fwd", "attn_fwd_stats", "attn_bwd"]
    assert recorded[0][1][5:] == (L, M, d, a, bf) + want
    assert recorded[1][1][7:] == (L, M, d, a, bf) + want
    args = recorded[2][1]
    assert args[13:] == (L, M, d, a, bwd.tile, bf)
    assert (args[11], args[12]) == (dw1.data_ptr(), dw2.data_ptr())
    assert args[8] == dH.data_ptr() and dH.dtype == dt and tuple(dH.shape) == (L, M, d)
    assert tuple(dw1.shape) == (d, a) and tuple(dw2.shape) == (a, 1)
    assert [f.launches for f in (tattn.attn_fwd_cuda, tattn.attn_fwd_stats,
                                 tattn.attn_bwd)] == [c + 1 for c in counts]


@pytest.mark.parametrize("which, d, a, why", [
    ("fwd", 100_000, A, "cannot take D=100000"),
    ("bwd", D, 100_000, "cannot take A=100000"),
])
def test_width_no_plan_takes_is_refused_before_launch(recorded, which, d, a, why):
    H, mask, w1, w2 = _cpu(2, d, a, Lx=2)
    with pytest.raises(ValueError, match=why):
        if which == "fwd":
            tattn.attn_fwd_cuda(H, mask, w1, w2)
        else:
            st = torch.zeros(2)
            tattn.attn_bwd(H, mask, w1, w2, torch.zeros((2, d)), st, st, torch.zeros((2, d)))
    assert recorded == []


# --- the forward's split-and-merge twin vs the JAX kernel --------------------------

TL, TD, TA = 13, 32, 8          # L = 13 is not a multiple of the 8-way split


def _attn_inputs(M, Lx, seed):
    rng = np.random.default_rng(seed)
    Ht = rng.normal(size=(Lx, M, TD)).astype(np.float32)
    mask = (rng.random((M, Lx)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    if M > 1:
        mask[1] = 0.0                         # a fully masked row
    if M > 2:
        mask[2] = 0.0
        mask[2, Lx - 1] = 1.0                 # one valid step, in the last CTA's span
    w1 = (rng.normal(size=(TD, TA)) / np.sqrt(TD)).astype(np.float32)
    w2 = (rng.normal(size=(TA, 1)) / np.sqrt(TA)).astype(np.float32)
    return Ht, mask, w1, w2


def _jax_kernel(Ht, mask, w1, w2, dt):
    M = Ht.shape[1]
    jH = jnp.asarray(Ht).astype(jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32)
    Hp, mp, _ = jattn._pad_rows(jH, jnp.asarray(mask).T)
    out, mx, dn = jattn._fwd_call(Hp, mp, jnp.asarray(w1), jnp.asarray(w2), True, with_stats=True)
    f = lambda x: np.asarray(jnp.asarray(x, jnp.float32))  # noqa: E731
    return f(out)[:M], f(mx)[0, :M], f(dn)[0, :M]


CASES = [(M, Lx, None) for M in (1, 4, 16, 25, 200) for Lx in (12, TL)]
CASES += [(25, TL, 1), (25, TL, 2), (4, 40, 3)]      # multi-pass rows (chunk < steps)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M, Lx, chunk", CASES)
def test_split_twin_matches_jax_kernel(M, Lx, chunk, dt):
    Ht, mask, w1, w2 = _attn_inputs(M, Lx, seed=M * 100 + Lx)
    plan = tattn.attn_fwd_plan(M, Lx, TD, TA)
    if chunk:
        plan = plan._replace(chunk=chunk)
    H = torch.from_numpy(Ht).to(dt)
    out, mx, dn = tattn.attn_fwd_split_reference(
        H, torch.from_numpy(mask), torch.from_numpy(w1), torch.from_numpy(w2), plan)
    assert out.dtype == dt
    want = _jax_kernel(Ht, mask, w1, w2, dt)
    bar = F32 if dt == torch.float32 else BF16
    live = mask.sum(1) > 0
    np.testing.assert_allclose(out.float().numpy(), want[0], **bar)
    np.testing.assert_allclose(mx.numpy()[live], want[1][live], **bar)
    np.testing.assert_allclose(dn.numpy(), want[2], **bar)
    if dt == torch.float32:
        ref = jattn._attn_reference(jnp.asarray(Ht), jnp.asarray(mask), jnp.asarray(w1),
                                    jnp.asarray(w2))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    if M > 1:                                    # the fully masked row: exact zeros
        assert float(out[1].abs().max()) == 0.0 and float(dn[1]) == 0.0
        assert float(mx[1]) == np.float32(-1e30)


def test_timing_tool_refuses_without_a_card(monkeypatch):
    """kernels/attn_timing.py reads device time on the card only; without
    one it exits naming the reason before making any tensor."""
    from induction_network_on_fewrel_tpu_torch.kernels import attn_timing

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        attn_timing.main([])
