"""20-step training trajectories of the zoo against JAX ``make_train_step`` (CPU).

Every zoo model over the CNN, proto_hatt over the BiLSTM and proto over
the transformer, at the small config of the JAX package's
``tests/test_model_zoo.py`` (L=16, hidden 64, N=4, K=2, Q=3, B=2), f32:
the JAX ``init_state`` weights carried into the port by
``interop.params_from_jax``, the same 20 batches from one seeded JAX
sampler, the clip and two staircase steps. The bar is the North star's
(``tests/test_torch_train.py``): losses rtol 2e-4 at every step, the final
parameters atol 1e-3.

The update is the North star's Adam (lr 2e-3). Adam moves an element by
about lr whatever its gradient's size, so a leaf whose gradient is
rounding noise (a softmax's shared shift: gnn's ``adj_*/Dense_2/bias``,
snail's ``att_*/k/bias``, the transformer's ``ln_final/bias``, siamese's
``metric_b``) walks ±lr a step in each package on its own noise. Such a
leaf, one whose JAX gradient at the first batch lies below 1e-6 of the
largest element over all leaves (``NOISE_LEAF``), is left out of the
parameter bar; the losses hold every leaf to account.

proto and siamese over the CNN run SGD with coupled decay (lr 0.2): their
logits do not change when every encoding shifts by the same vector, so
the CNN bias's gradient is rounding noise in most channels and real in
the others (the test checks that the JAX gradient shows this). No leaf
rule can part them, and under Adam the noise channels' ±lr steps part
the two runs beyond the bar. Adam itself is held against optax in
``tests/test_torch_optim.py``.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import jax
import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.data import GloveTokenizer as JaxTokenizer
from induction_network_on_fewrel_tpu.data import make_synthetic_fewrel as jax_fewrel
from induction_network_on_fewrel_tpu.data import make_synthetic_glove as jax_glove
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu.models.build import batch_to_model_inputs as jax_inputs
from induction_network_on_fewrel_tpu.sampling.episodes import EpisodeSampler as JaxSampler
from induction_network_on_fewrel_tpu.train.steps import (
    init_state,
    loss_and_metrics,
    make_train_step,
)
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.interop import params_from_jax, params_to_jax
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.train.steps import make_optimizer, train_step

L = 16
TRAJ = dict(
    vocab_size=302, max_length=L, train_n=4, n=4, k=2, q=3, batch_size=2, hidden_size=64,
    gnn_dim=16, gnn_adj_hidden=16, snail_tc_filters=16, lstm_hidden=16, att_dim=8,
    tfm_layers=2, tfm_model=32, tfm_heads=2, tfm_ff=64, compute_dtype="float32", loss="ce",
    weight_decay=1e-4, grad_clip=1.0, lr_step_size=7, lr_gamma=0.5,
)
ADAM = dict(optimizer="adam", lr=2e-3)
SGD = dict(optimizer="sgd", lr=0.2)
STEPS = 20
NOISE_LEAF = 1e-6
CASES = [("proto", "cnn", SGD), ("proto_hatt", "cnn", ADAM), ("siamese", "cnn", SGD),
         ("gnn", "cnn", ADAM), ("snail", "cnn", ADAM), ("metanet", "cnn", ADAM),
         ("proto_hatt", "bilstm", ADAM), ("proto", "transformer", ADAM)]


@pytest.fixture(scope="module")
def batches():
    jcfg = JaxConfig(**TRAJ, **ADAM)
    vocab = jax_glove(jcfg.vocab_size - 2, jcfg.word_dim)
    ds = jax_fewrel(num_relations=8, instances_per_relation=jcfg.k + jcfg.q + 4,
                    vocab_size=jcfg.vocab_size - 2, sentence_len=(6, L))
    s = JaxSampler(ds, JaxTokenizer(vocab, L), jcfg.n, jcfg.k, jcfg.q,
                   batch_size=jcfg.batch_size, seed=7)
    return [jax_inputs(s.sample_batch()) for _ in range(STEPS)]


def _leaf_levels(jmodel, jcfg, variables, batch) -> dict:
    """Each leaf's |JAX gradient| on ``batch`` over the largest element of
    all leaves."""
    grads = jax.jit(jax.grad(lambda v: loss_and_metrics(jmodel, v, *batch, jcfg.loss)[0]))(
        variables)
    flat = [(jax.tree_util.keystr(p), np.abs(np.asarray(g)))
            for p, g in jax.tree_util.tree_flatten_with_path(jax.device_get(grads["params"]))[0]]
    top = max(float(g.max()) for _, g in flat)
    return {name: g / top for name, g in flat}


@pytest.mark.parametrize("model,encoder,opt", CASES, ids=[f"{m}-{e}" for m, e, _ in CASES])
def test_trajectory_matches_jax_train_step(batches, model, encoder, opt):
    kw = dict(TRAJ, **opt, model=model, encoder=encoder)
    jcfg = JaxConfig(**kw, lstm_backend="scan", attn_backend="xla")
    jmodel = jax_build_model(jcfg)
    state = init_state(jmodel, jcfg, batches[0][0], batches[0][1])
    levels = _leaf_levels(jmodel, jcfg, state.params, batches[0])
    if opt is ADAM:
        noise = {name for name, lv in levels.items() if lv.max() < NOISE_LEAF}
    else:   # a leaf with noise elements beside real ones, which Adam cannot hold
        noise = set()
        assert any(((lv > 0) & (lv < NOISE_LEAF)).any() and lv.max() > 1e-2
                   for lv in levels.values())
    step = make_train_step(jmodel, jcfg)
    cfg = ExperimentConfig(**kw)
    tmodel = build_model(cfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.device_get(state.params["params"])))
    opt = make_optimizer(cfg, tmodel)
    for support, query, label in batches:
        state, jm = step(state, support, query, label)
        tm = train_step(tmodel, opt, cfg, support, query, label)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-4)
    want = params_to_jax({k: torch.from_numpy(np.asarray(v)) for k, v in
                          params_from_jax(jax.device_get(state.params["params"])).items()})
    got = params_to_jax(tmodel.state_dict())
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(noise) <= 3 < len(flat)
    for path, w in flat:
        if jax.tree_util.keystr(path) in noise:
            continue
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, w, atol=1e-3, err_msg=jax.tree_util.keystr(path))
