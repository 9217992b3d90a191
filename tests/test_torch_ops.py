"""Torch port ops vs the JAX package at small widths (CPU).

The same numpy inputs, made from a seed, go through the JAX function and
its counterpart in ``induction_network_on_fewrel_tpu_torch.ops``. The JAX
kernels run as the JAX package's own tests run them: the Pallas kernels in
interpret mode, next to the ``scan`` / two-pass ``xla`` forms. On the CPU
the port's entry points take the plain PyTorch version of each kernel; the
CUDA kernels themselves are held against those plain versions on the card
by ``chip_smoke.py``.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.ops import core as jcore
from induction_network_on_fewrel_tpu.ops.attn import masked_selfattn_tm as j_attn
from induction_network_on_fewrel_tpu.ops.lstm import bilstm_encoder_tm as j_bilstm
from induction_network_on_fewrel_tpu_torch.kernels.build import CSRC, LAUNCHERS
from induction_network_on_fewrel_tpu_torch.ops import core as tcore
from induction_network_on_fewrel_tpu_torch.ops.attn import (
    attn_fwd_cuda,
    masked_selfattn_tm as t_attn,
)
from induction_network_on_fewrel_tpu_torch.ops.lstm import (
    bilstm_encoder_tm as t_bilstm,
    bilstm_infer_cuda,
)

# Deliberately not a multiple of any tile: L=12 time steps, M=20 rows.
L, M, D, U, A, H = 12, 20, 14, 16, 8, 32
BF16_BAND = 1e-2   # tighter than tests/test_attn.py's 5e-2 bf16 band: one
                   # bf16 ulp (2^-8) at |h| < 1 with margin


@pytest.fixture(scope="module")
def lstm_inputs():
    rng = np.random.default_rng(11)
    emb_t = rng.normal(size=(L, M, D)).astype(np.float32) * 0.5
    wih = (rng.normal(size=(2, D, 4 * U)) / np.sqrt(D)).astype(np.float32)
    b = rng.normal(size=(2, 1, 4 * U)).astype(np.float32) * 0.1
    whh = (rng.normal(size=(2, U, 4 * U)) / np.sqrt(U)).astype(np.float32)
    return emb_t, wih, b, whh


@pytest.fixture(scope="module")
def attn_inputs():
    rng = np.random.default_rng(0)
    Ht = rng.normal(size=(L, M, H)).astype(np.float32)
    mask = (rng.random((M, L)) > 0.25).astype(np.float32)
    mask[:, 0] = 1.0
    mask[3] = 0.0                         # a fully masked row -> exact zeros
    w1 = (rng.normal(size=(H, A)) / np.sqrt(H)).astype(np.float32)
    w2 = (rng.normal(size=(A, 1)) / np.sqrt(A)).astype(np.float32)
    return Ht, mask, w1, w2


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# --- core ops ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["squash", "masked_softmax", "masked_max", "masked_mean"])
def test_core_ops_match_jax(name):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 6, 9)).astype(np.float32)
    mask = (rng.random((4, 6, 9)) > 0.3).astype(np.float32)
    mask[0, 0] = 0.0                      # one fully masked lane
    if name == "squash":
        want = jcore.squash(jnp.asarray(x))
        got = tcore.squash(torch.from_numpy(x))
    elif name == "masked_softmax":
        want = jcore.masked_softmax(jnp.asarray(x), jnp.asarray(mask))
        got = tcore.masked_softmax(torch.from_numpy(x), torch.from_numpy(mask))
    elif name == "masked_max":
        want = jcore.masked_max(jnp.asarray(x), jnp.asarray(mask), axis=1)
        got = tcore.masked_max(torch.from_numpy(x), torch.from_numpy(mask), dim=1)
    else:
        want = jcore.masked_mean(jnp.asarray(x), jnp.asarray(mask), axis=-1)
        got = tcore.masked_mean(torch.from_numpy(x), torch.from_numpy(mask), dim=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_squash_bf16_keeps_dtype():
    x = torch.randn(3, 7, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    want = jcore.squash(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    got = tcore.squash(x)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=1e-2)


# --- fused BiLSTM forward ---------------------------------------------------


@pytest.mark.parametrize("jax_backend", ["interpret", "scan"])
def test_bilstm_f32_matches_jax(lstm_inputs, jax_backend):
    want = j_bilstm(*(jnp.asarray(x) for x in lstm_inputs), backend=jax_backend)
    got = t_bilstm(*_t(*lstm_inputs))
    assert got.shape == (L, M, 2 * U) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_bilstm_directions_are_independent(lstm_inputs):
    """Scaling the reverse direction's W_hh moves only cols [u:2u]."""
    emb_t, wih, b, whh = lstm_inputs
    base = t_bilstm(*_t(emb_t, wih, b, whh))
    whh2 = whh.copy()
    whh2[1] *= 2.0
    moved = t_bilstm(*_t(emb_t, wih, b, whh2))
    np.testing.assert_array_equal(moved[..., :U].numpy(), base[..., :U].numpy())
    assert float((moved[..., U:] - base[..., U:]).abs().max()) > 1e-3


def test_bilstm_bf16_matches_jax_interpret(lstm_inputs):
    """bf16 follows the KERNEL's dtype placement (wih in bf16, b/whh f32,
    f32 accumulation and carries, hs in bf16), so it is held against the
    JAX kernel in interpret mode, not the scan backend."""
    emb_t, wih, b, whh = lstm_inputs
    want = j_bilstm(
        jnp.asarray(emb_t).astype(jnp.bfloat16), jnp.asarray(wih), jnp.asarray(b),
        jnp.asarray(whh), backend="interpret",
    )
    emb16, wih_, b_, whh_ = _t(emb_t, wih, b, whh)
    got = t_bilstm(emb16.to(torch.bfloat16), wih_, b_, whh_)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), _np(want), rtol=BF16_BAND, atol=BF16_BAND
    )


# --- structured self-attention ----------------------------------------------


@pytest.mark.parametrize("jax_backend", ["interpret", "xla"])
def test_attn_f32_matches_jax(attn_inputs, jax_backend):
    want = j_attn(*(jnp.asarray(x) for x in attn_inputs), backend=jax_backend)
    got = t_attn(*_t(*attn_inputs))
    assert got.shape == (M, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert float(got[3].abs().max()) == 0.0   # fully masked row: exact zeros


def test_attn_bf16_matches_jax_interpret(attn_inputs):
    Ht, mask, w1, w2 = attn_inputs
    want = j_attn(
        jnp.asarray(Ht).astype(jnp.bfloat16), jnp.asarray(mask), jnp.asarray(w1),
        jnp.asarray(w2), backend="interpret",
    )
    H_, mask_, w1_, w2_ = _t(Ht, mask, w1, w2)
    got = t_attn(H_.to(torch.bfloat16), mask_, w1_, w2_)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=BF16_BAND, atol=BF16_BAND)
    assert float(got[3].float().abs().max()) == 0.0


def test_attn_int_mask_same_as_float(attn_inputs):
    Ht, mask, w1, w2 = attn_inputs
    H_, mask_, w1_, w2_ = _t(Ht, mask, w1, w2)
    np.testing.assert_array_equal(
        t_attn(H_, mask_.to(torch.int8), w1_, w2_).numpy(),
        t_attn(H_, mask_, w1_, w2_).numpy(),
    )


# --- backend rule -----------------------------------------------------------


def test_resolve_backend_rule():
    assert tcore.resolve_backend("auto", "cpu") == "reference"
    assert tcore.resolve_backend("auto", "cuda") == "cuda"
    assert tcore.resolve_backend("reference", "cuda") == "reference"
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tcore.resolve_backend("cuda", "cpu")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        tcore.resolve_backend("pallas", "cpu")


def test_cuda_backend_with_cpu_tensors_raises(lstm_inputs, attn_inputs):
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        t_bilstm(*_t(*lstm_inputs), backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        t_attn(*_t(*attn_inputs), backend="cuda")


@pytest.mark.parametrize("wrapper", ["bilstm", "attn"])
def test_kernel_wrapper_refuses_cpu_tensors_without_launching(lstm_inputs, attn_inputs, wrapper):
    """The wrappers launch on CUDA tensors or raise: a CPU tensor never
    reaches the launcher (nor the nvcc build) and the count stays put."""
    before = (bilstm_infer_cuda.launches, attn_fwd_cuda.launches)
    with pytest.raises(RuntimeError, match="CUDA device"):
        if wrapper == "bilstm":
            bilstm_infer_cuda(*_t(*lstm_inputs))
        else:
            attn_fwd_cuda(*_t(*attn_inputs))
    assert (bilstm_infer_cuda.launches, attn_fwd_cuda.launches) == before


@pytest.mark.parametrize("name", sorted(LAUNCHERS))
def test_launcher_argtypes_match_the_c_signature(name):
    """Each ctypes declaration in ``LAUNCHERS`` has the arity and types of
    its ``extern "C"`` launcher in ``csrc/``: a mismatch would pass wrong
    sizes or pointers to a kernel (the row tile that sizes K6's and kernel
    3's partials is one such argument)."""
    import ctypes
    import re

    stem, argtypes = LAUNCHERS[name]
    src = (CSRC / f"{stem}.cu").read_text()
    extern_c = src[src.index('extern "C" {'):]
    m = re.search(rf"\bint {name}\(([^)]*)\)\s*{{", extern_c)
    assert m, f"{name} not found in {stem}.cu"
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "long long": ctypes.c_longlong,
             "float": ctypes.c_float}
    params = [" ".join(p.replace("const ", "").split()[:-1]) for p in m.group(1).split(",")]
    assert [kinds[p] for p in params] == argtypes
    assert params[-1] == "void*"                 # the stream comes last
