"""Witness for the gnn/cnn reading of the zoo sweep: the step, or the init?

    JAX_PLATFORMS=cpu python tests/gnn_pin_witness.py jax SEED
    JAX_PLATFORMS=cpu python tests/gnn_pin_witness.py port SEED --jax_init
    JAX_PLATFORMS=cpu python tests/gnn_pin_witness.py port SEED

The zoo sweep's recipe for gnn over the CNN (5-way 5-shot, Q=5, B=8, L=40,
2 002 words, ce, Adam at lr 1e-3, f32 here) for STEPS steps on one
sequence of synthetic episodes (the JAX numpy sampler, seed 0): the JAX
step from the JAX init of ``SEED``, or the port's step from that same init
(``--jax_init``, through ``interop.params_from_jax``) or from the port's
own init of ``SEED``. Prints the mean train accuracy of each 20 steps.
Several minutes on a CPU; not a test (``tests/test_torch_gnn_pin.py`` is
the short one).
"""

import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig  # noqa: E402
from induction_network_on_fewrel_tpu.data import (  # noqa: E402
    GloveTokenizer,
    make_synthetic_fewrel,
    make_synthetic_glove,
)
from induction_network_on_fewrel_tpu.models import build_model as jax_build_model  # noqa: E402
from induction_network_on_fewrel_tpu.models.build import batch_to_model_inputs  # noqa: E402
from induction_network_on_fewrel_tpu.native import make_sampler  # noqa: E402
from induction_network_on_fewrel_tpu.train.steps import init_state  # noqa: E402
from induction_network_on_fewrel_tpu.train.steps import make_train_step as jax_step  # noqa: E402
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig  # noqa: E402
from induction_network_on_fewrel_tpu_torch.interop import params_from_jax  # noqa: E402
from induction_network_on_fewrel_tpu_torch.models.build import build_model  # noqa: E402
from induction_network_on_fewrel_tpu_torch.train.steps import make_optimizer, train_step  # noqa: E402

STEPS = 200
RECIPE = dict(model="gnn", encoder="cnn", n=5, train_n=5, k=5, q=5, batch_size=8, max_length=40,
              vocab_size=2002, loss="ce", lr=1e-3, lr_step_size=500, compute_dtype="float32")


def main(argv) -> int:
    which, seed, jax_init = argv[0], int(argv[1]), "--jax_init" in argv
    torch.set_num_threads(2)
    kw = dict(RECIPE, seed=seed)
    vocab = make_synthetic_glove(vocab_size=2000, word_dim=50)
    ds = make_synthetic_fewrel(num_relations=10, instances_per_relation=20, vocab_size=2000,
                               seed=0)
    sampler = make_sampler(ds, GloveTokenizer(vocab, max_length=40), 5, 5, 5, 8, seed=0,
                           backend="python", prefetch=0)
    batches = [batch_to_model_inputs(sampler.sample_batch()) for _ in range(STEPS)]
    jcfg = JaxConfig(**kw)
    jmodel = jax_build_model(jcfg, glove_init=vocab.vectors)
    state = init_state(jmodel, jcfg, batches[0][0], batches[0][1])
    t0, accs = time.time(), []
    if which == "jax":
        step = jax_step(jmodel, jcfg)
        for b in batches:
            state, m = step(state, *b)
            accs.append(float(m["accuracy"]))
    else:
        cfg = ExperimentConfig(**kw)
        model = build_model(cfg, device="cpu", glove_init=vocab.vectors)
        if jax_init:
            model.load_state_dict(params_from_jax(jax.device_get(state.params["params"])))
        opt = make_optimizer(cfg, model)
        for b in batches:
            accs.append(float(train_step(model, opt, cfg, *b)["accuracy"]))
    means = np.asarray(accs).reshape(-1, 20).mean(1)
    init = "jax init" if which == "jax" or jax_init else "port init"
    print(f"{which} step from the {init} of seed {seed}: train accuracy per 20 steps "
          f"{np.round(means, 3).tolist()} ({time.time() - t0:.0f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
