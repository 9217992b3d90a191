"""gnn over the CNN at the zoo sweep's recipe: the port against the JAX package.

The full sweep on the card read gnn/cnn near chance (0.2318) while its
train accuracy rose. Pinned here at a reduced recipe (the sweep's ce loss
and Adam at lr 1e-3, lr_step_size 500, at cut widths), on the CPU:

* the port's fresh init has the JAX init's distribution, leaf by leaf;
* from the JAX init, on the same episodes, the port's step follows the JAX
  step for 40 steps at the repo's trajectory bars (losses rtol 2e-4,
  parameters 1e-3).

So a difference at the full recipe comes from where the two inits land,
not from the step: ``tests/gnn_pin_witness.py`` runs the full recipe's 200
steps from either init (ROADMAP queue C has its figures).
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import jax
import numpy as np
import pytest

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.data import (
    GloveTokenizer,
    make_synthetic_fewrel,
    make_synthetic_glove,
)
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model
from induction_network_on_fewrel_tpu.models.build import batch_to_model_inputs
from induction_network_on_fewrel_tpu.native import make_sampler
from induction_network_on_fewrel_tpu.train.steps import init_state
from induction_network_on_fewrel_tpu.train.steps import make_train_step as jax_step
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.interop import params_from_jax
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.train.steps import make_optimizer, train_step

STEP_KW = dict(model="gnn", encoder="cnn", n=5, train_n=5, k=5, q=2, batch_size=2, max_length=12,
               vocab_size=2002, hidden_size=32, gnn_dim=16, gnn_adj_hidden=16, loss="ce",
               lr=1e-3, lr_step_size=500, compute_dtype="float32")
STEPS = 40


@pytest.fixture(scope="module")
def episodes():
    vocab = make_synthetic_glove(vocab_size=2000, word_dim=50)
    ds = make_synthetic_fewrel(num_relations=10, instances_per_relation=20, vocab_size=2000,
                               seed=0)
    sampler = make_sampler(ds, GloveTokenizer(vocab, max_length=12), 5, 5, 2, 2, seed=0,
                           backend="python", prefetch=0)
    return vocab, [batch_to_model_inputs(sampler.sample_batch()) for _ in range(STEPS)]


def _jax_state(vocab, batch, seed=0):
    jcfg = JaxConfig(**STEP_KW, seed=seed)
    jmodel = jax_build_model(jcfg, glove_init=vocab.vectors)
    return jcfg, jmodel, init_state(jmodel, jcfg, batch[0], batch[1])


def test_fresh_init_has_the_jax_distribution(episodes):
    vocab, batches = episodes
    _, _, state = _jax_state(vocab, batches[0])
    theirs = params_from_jax(jax.device_get(state.params["params"]))
    ours = build_model(ExperimentConfig(**STEP_KW), device="cpu",
                       glove_init=vocab.vectors).state_dict()
    assert set(ours) == set(theirs)
    for k, want in theirs.items():
        got = ours[k]
        if want.numel() < 1000:
            continue
        ratio = float(got.float().std() / want.float().std())
        assert 0.9 < ratio < 1.1, (k, ratio)


def test_port_from_the_jax_init_follows_the_jax_steps(episodes):
    vocab, batches = episodes
    jcfg, jmodel, state = _jax_state(vocab, batches[0])
    cfg = ExperimentConfig(**STEP_KW)
    model = build_model(cfg, device="cpu", glove_init=vocab.vectors)
    model.load_state_dict(params_from_jax(jax.device_get(state.params["params"])))
    opt = make_optimizer(cfg, model)
    step = jax_step(jmodel, jcfg)
    for b in batches:
        state, jm = step(state, *b)
        pm = train_step(model, opt, cfg, *b)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=2e-4)
    want = params_from_jax(jax.device_get(state.params["params"]))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-3, err_msg=k)
