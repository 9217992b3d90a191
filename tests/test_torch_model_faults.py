"""The port's model-level faults against the reference, pinned on the CPU.

* A BiLSTM width the CUDA kernels cannot take (4u > 512) is refused by name
  when ``lstm_backend`` resolves to "cuda", before any parameter is made;
  ``lstm_backend="reference"`` builds it. The check is a function of (cfg,
  device), so it is called here with a CUDA device and no card.
* The CLI takes the JAX CLI's ``--lstm_backend``/``--attn_backend`` flags
  (with the port's ``auto | reference | cuda`` choices).
* Fresh weights follow flax's initializers: the truncated lecun/glorot
  normal (std within 3 %, |w| <= 2 std / 0.87962566 ~ 2.27 std, which an
  untruncated normal of 245 760 draws exceeds by far) and orthogonal
  recurrent weights.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from induction_network_on_fewrel_tpu_torch import cli
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.models import build as tbuild
from induction_network_on_fewrel_tpu_torch.models.embedding import TRUNC_STD, truncated_normal_param

CUDA = torch.device("cuda")
DRAWS = (60, 4096)
BOUND = 2.0 / TRUNC_STD          # max |w| / std of a flax truncated-normal draw


@pytest.mark.parametrize("u", [256, 640])
def test_wide_lstm_refused_by_name_on_cuda(u):
    cfg = ExperimentConfig(lstm_hidden=u)
    with pytest.raises(ValueError, match=rf"lstm_hidden={u} .*--lstm_backend reference"):
        tbuild.check_kernel_widths(cfg, CUDA)
    tbuild.check_kernel_widths(cfg.replace(lstm_backend="reference"), CUDA)
    tbuild.check_kernel_widths(cfg, torch.device("cpu"))       # auto -> the plain version


@pytest.mark.parametrize("window", [0, 8])
def test_flagship_width_passes_the_check(window):
    tbuild.check_kernel_widths(ExperimentConfig(lstm_cs_window=window), CUDA)


def test_build_model_refuses_before_any_parameter(monkeypatch):
    """``build_model`` runs the check right after resolving the device:
    with the device forced to CUDA (no card here), a wide BiLSTM raises
    before the embedding, the first module with parameters, is made."""
    monkeypatch.setattr(tbuild, "resolve_device", lambda device: CUDA)
    monkeypatch.setattr(tbuild, "Embedding",
                        lambda *a, **k: pytest.fail("a parameter was made before the check"))
    with pytest.raises(ValueError, match="lstm_hidden=256"):
        tbuild.build_model(ExperimentConfig(lstm_hidden=256))


def test_wide_lstm_builds_with_the_reference_backend():
    cfg = ExperimentConfig(vocab_size=40, lstm_hidden=256, lstm_backend="reference")
    model = tbuild.build_model(cfg, device="cpu")
    assert tuple(model.encoder.w_hh.shape) == (2, 256, 1024)


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_cli_backend_flags_reach_the_config(train):
    parser = cli.build_arg_parser(train=train)
    cfg = cli.config_from_args(parser.parse_args(
        ["--lstm_backend", "reference", "--attn_backend", "cuda"]))
    assert (cfg.lstm_backend, cfg.attn_backend) == ("reference", "cuda")
    cfg = cli.config_from_args(parser.parse_args([]))
    assert (cfg.lstm_backend, cfg.attn_backend) == ("auto", "auto")
    with pytest.raises(SystemExit):
        parser.parse_args(["--lstm_backend", "scan"])


# shape, the flax initializer, the std it targets
FLAX_INITS = {
    "lecun": (DRAWS, nn.initializers.lecun_normal(), 1.0 / math.sqrt(DRAWS[0])),
    "glorot_batch0": ((60, 64, 64), nn.initializers.glorot_normal(batch_axis=(0,)), 1.0 / 8.0),
}


@pytest.mark.parametrize("name", sorted(FLAX_INITS))
def test_truncated_normal_matches_flax(name):
    shape, init, std = FLAX_INITS[name]
    want = np.asarray(init(jax.random.PRNGKey(0), shape, jnp.float32))
    got = truncated_normal_param(torch.Generator().manual_seed(0), shape, std, "cpu")
    got = got.detach().numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    for w in (got, want):
        assert abs(w.std() / std - 1.0) < 0.03
        assert abs(w.mean()) < 0.03 * std
        assert np.abs(w).max() <= BOUND * std * (1 + 1e-6)
        assert np.abs(w).max() > 0.95 * BOUND * std          # reaches the cut, as flax does
    assert abs(got.std() / want.std() - 1.0) < 0.03
    # The same share of draws beyond one raw sigma (|z| > 1 of the truncated normal).
    frac = [float((np.abs(w) > std / TRUNC_STD).mean()) for w in (got, want)]
    assert abs(frac[0] - frac[1]) < 0.01


@pytest.fixture(scope="module")
def fresh_model():
    """The flagship widths (D=60, u=128, A=64, C=100, 100 slices) with a
    small vocabulary, built on the CPU."""
    return tbuild.build_model(ExperimentConfig(vocab_size=40), device="cpu")


# parameter -> its target std (flax fan rules at the flagship widths)
TRUNCATED = {
    "encoder.w_ih": 1.0 / math.sqrt(60),
    "encoder.att_w1": 1.0 / math.sqrt(256),
    "encoder.att_w2": 1.0 / math.sqrt(64),
    "induction.dense.weight": 1.0 / math.sqrt(256),
    "query_proj.weight": 1.0 / math.sqrt(256),
    "relation.tensor_slices": 1.0 / math.sqrt(100),
    "relation.dense.weight": 1.0 / math.sqrt(100),
}


@pytest.mark.parametrize("name", sorted(TRUNCATED))
def test_fresh_params_are_flax_truncated_normals(fresh_model, name):
    w = dict(fresh_model.named_parameters())[name].detach().double()
    std = TRUNCATED[name]
    assert float(w.abs().max()) <= BOUND * std * (1 + 1e-6)
    if w.numel() >= 10_000:                    # enough draws for a 3 % std bar
        assert abs(float(w.std()) / std - 1.0) < 0.03


def test_w_hh_is_orthogonal_like_flax(fresh_model):
    """Each direction's [u, 4u] W_hh has orthonormal rows, as flax's
    ``orthogonal()`` gives for that shape (JAX encoders.py:129)."""
    want = np.asarray(nn.initializers.orthogonal()(jax.random.PRNGKey(1), (128, 512), jnp.float32))
    np.testing.assert_allclose(want @ want.T, np.eye(128), atol=1e-5)
    for d in range(2):
        w = fresh_model.encoder.w_hh[d].detach()
        torch.testing.assert_close(w @ w.T, torch.eye(128), atol=1e-5, rtol=0)
    assert not torch.equal(fresh_model.encoder.w_hh[0], fresh_model.encoder.w_hh[1])
