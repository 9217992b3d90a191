"""The port's optimizer family vs the JAX package's optax chains (CPU).

* Every rule (adam, adamw, sgd) x word-table mode (shared, sgd, frozen)
  against the JAX ``make_optimizer`` over 5 updates in f32, within 1e-6:
  the clip engaged on some updates and not on others, the staircase
  (lr_step_size=2) crossed twice, a tensor of several kernel chunks. A
  frozen table gets a zero gradient on the JAX side (its Embedding
  stop-gradients it) and none here.
* A frozen table gets no gradient and holds no moments; an sgd table
  holds no moments; ``lazy`` takes the table out of the dense update and is
  refused by name with another optimizer than Adam.
* ``state_dict`` round trips in every mode, copies in place, and the
  earlier Adam-only format (an int count, moments for every parameter, no
  rules) still loads; a state of other rules is refused by name.
* The kernels' plain twin: ``optim_sumsq_reference`` takes the kernel's
  chunks and final order; it agrees with the per-parameter norm (in f64)
  within 1e-6. The host table the CUDA launchers read (rows, chunk
  offsets, rule codes, null pointers) and the constants shared with
  ``csrc/optim.cu``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
from induction_network_on_fewrel_tpu.train.steps import make_optimizer as jax_make_optimizer
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.models.build import build_model
from induction_network_on_fewrel_tpu_torch.ops import optim as optim_ops
from induction_network_on_fewrel_tpu_torch.train.steps import make_optimizer, train_step

OPT = dict(lr=1e-2, weight_decay=1e-2, lr_step_size=2, lr_gamma=0.5, grad_clip=1.0)
SHAPES = {"embedding.word_embedding": (30, 4), "encoder.w": (5, 6), "head.b": (7,),
          "head.big": (3, 12001)}      # three kernel chunks
# Gradient scales per update: the global norm (~190 x scale) is below the
# clip (1.0) on updates 0, 2 and 4 and above it on 1 and 3.
SCALES = (0.003, 0.05, 0.002, 0.5, 0.001)
MODES = [(o, e) for o in ("adam", "adamw", "sgd") for e in ("shared", "sgd", "frozen")]


class _Tiny(torch.nn.Module):
    def __init__(self, values: dict):
        super().__init__()
        for name, v in values.items():
            mod, leaf = name.split(".")
            if not hasattr(self, mod):
                self.add_module(mod, torch.nn.Module())
            setattr(getattr(self, mod), leaf, torch.nn.Parameter(torch.from_numpy(v.copy())))


def _values(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}


def _nest(flat: dict) -> dict:
    out: dict = {}
    for name, v in flat.items():
        mod, leaf = name.split(".")
        out.setdefault(mod, {})[leaf] = jnp.asarray(v)
    return out


@pytest.mark.parametrize("optimizer,embed", MODES, ids=[f"{o}-{e}" for o, e in MODES])
def test_rule_and_table_mode_match_optax(optimizer, embed):
    values = _values()
    tx = jax_make_optimizer(JaxConfig(**OPT, optimizer=optimizer, embed_optimizer=embed))
    jp = _nest(values)
    state = tx.init(jp)
    model = _Tiny(values)
    opt = make_optimizer(ExperimentConfig(**OPT, optimizer=optimizer, embed_optimizer=embed), model)
    rng = np.random.default_rng(1)
    clipped = []
    for step, scale in enumerate(SCALES):
        grads = {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in SHAPES.items()}
        if embed == "frozen":
            grads["embedding.word_embedding"][:] = 0.0
        upd, state = tx.update(_nest(grads), state, jp)
        jp = optax.apply_updates(jp, upd)
        for name, p in model.named_parameters():
            frozen_table = embed == "frozen" and name == "embedding.word_embedding"
            p.grad = None if frozen_table else torch.from_numpy(grads[name])
        assert opt.learning_rate() == OPT["lr"] * 0.5 ** (step // 2)
        clipped.append(float(opt.step()) >= OPT["grad_clip"])
        for name, p in model.named_parameters():
            mod, leaf = name.split(".")
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[mod][leaf]),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{name} after {step + 1}")
    assert any(clipped) and not all(clipped)
    assert int(opt.count) == len(SCALES)
    table = opt.rules.index({"shared": optimizer, "sgd": "sgd_plain", "frozen": "frozen"}[embed])
    has_moments = embed == "shared" and optimizer != "sgd"
    assert (opt.mu[table] is not None) == has_moments == (opt.nu[table] is not None)
    if embed == "frozen":
        np.testing.assert_array_equal(model.embedding.word_embedding.detach().numpy(),
                                      values["embedding.word_embedding"])


SMALL = dict(vocab_size=60, max_length=12, word_dim=10, pos_dim=2, lstm_hidden=16, att_dim=8,
             induction_dim=12, ntn_slices=6, n=3, k=2, q=2, batch_size=2,
             compute_dtype="float32")


def _batch(cfg, seed=0):
    from induction_network_on_fewrel_tpu_torch.data import (
        GloveTokenizer,
        make_synthetic_fewrel,
        make_synthetic_glove,
    )
    from induction_network_on_fewrel_tpu_torch.models.build import batch_to_model_inputs
    from induction_network_on_fewrel_tpu_torch.sampling.episodes import EpisodeSampler

    tok = GloveTokenizer(make_synthetic_glove(cfg.vocab_size - 2, cfg.word_dim), cfg.max_length)
    ds = make_synthetic_fewrel(num_relations=6, instances_per_relation=8,
                               vocab_size=cfg.vocab_size - 2, sentence_len=(6, 12))
    s = EpisodeSampler(ds, tok, cfg.n, cfg.k, cfg.q, batch_size=cfg.batch_size, seed=seed)
    return batch_to_model_inputs(s.sample_batch())


def test_frozen_table_gets_no_gradient_and_no_moments():
    cfg = ExperimentConfig(**SMALL, embed_optimizer="frozen")
    model = build_model(cfg, device="cpu")
    opt = make_optimizer(cfg, model)
    before = model.embedding.word_embedding.detach().clone()
    m = train_step(model, opt, cfg, *_batch(cfg))
    assert np.isfinite(float(m["grad_norm"]))
    assert torch.equal(model.embedding.word_embedding.detach(), before)
    i = opt.rules.index("frozen")
    assert opt.mu[i] is None and opt.nu[i] is None
    support, query, label = _batch(cfg)
    from induction_network_on_fewrel_tpu_torch.train.steps import loss_and_metrics
    from induction_network_on_fewrel_tpu_torch.models.base import to_device

    loss, _ = loss_and_metrics(model, to_device(support, "cpu"), to_device(query, "cpu"),
                               torch.as_tensor(label), cfg.loss)
    loss.backward()
    assert model.embedding.word_embedding.grad is None
    assert model.embedding.pos1_embedding.grad is not None
    sgd = make_optimizer(cfg.replace(embed_optimizer="sgd"), model)
    j = sgd.rules.index("sgd_plain")
    assert sgd.mu[j] is None and sum(x is None for x in sgd.mu) == 1


def test_lazy_is_refused_by_name():
    model = build_model(ExperimentConfig(**SMALL), device="cpu")
    with pytest.raises(ValueError, match="embed_optimizer=lazy .* requires --optimizer adam"):
        make_optimizer(ExperimentConfig(**SMALL, embed_optimizer="lazy", optimizer="adamw"), model)
    lazy = make_optimizer(ExperimentConfig(**SMALL, embed_optimizer="lazy"), model)
    j = [n for n, _ in model.named_parameters()].index("embedding.word_embedding")
    assert lazy.rules[j] == "lazy" and lazy.mu[j] is None       # out of the dense update
    with pytest.raises(ValueError, match="unknown embed_optimizer 'dense'"):
        make_optimizer(ExperimentConfig(**SMALL, embed_optimizer="dense"), model)


@pytest.mark.parametrize("optimizer,embed", [("adam", "shared"), ("adamw", "sgd"),
                                             ("sgd", "frozen")])
def test_state_dict_round_trip_in_place(optimizer, embed):
    cfg = ExperimentConfig(**OPT, optimizer=optimizer, embed_optimizer=embed)
    rng = np.random.default_rng(3)
    a, b = _Tiny(_values()), _Tiny(_values())
    opt_a, opt_b = make_optimizer(cfg, a), make_optimizer(cfg, b)

    def step(model, opt, grads):
        for name, p in model.named_parameters():
            p.grad = None if opt.rules[list(SHAPES).index(name)] == "frozen" \
                else torch.from_numpy(grads[name])
        opt.step()

    for _ in range(2):
        step(a, opt_a, {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()})
    addresses = [None if m is None else m.data_ptr() for m in opt_b.mu]
    b.load_state_dict(a.state_dict())
    opt_b.load_state_dict(opt_a.state_dict())
    assert [None if m is None else m.data_ptr() for m in opt_b.mu] == addresses
    assert int(opt_b.count) == 2 and opt_b.state_dict()["count"] == 2
    g = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    step(a, opt_a, g)
    step(b, opt_b, g)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name


def test_earlier_adam_state_format_loads():
    """The Adam-only optimizer's state: {"count": int, "mu": [...], "nu":
    [...]} with moments for every parameter and no rules."""
    model = _Tiny(_values())
    opt = make_optimizer(ExperimentConfig(**OPT), model)
    old = {"count": 3, "mu": [torch.full(p.shape, 0.5) for p in model.parameters()],
           "nu": [torch.full(p.shape, 0.25) for p in model.parameters()]}
    opt.load_state_dict(old)
    assert int(opt.count) == 3 and all(torch.equal(m, o) for m, o in zip(opt.mu, old["mu"]))
    sgd_table = make_optimizer(ExperimentConfig(**OPT, embed_optimizer="sgd"), model)
    with pytest.raises(ValueError, match="saved with rules"):
        sgd_table.load_state_dict(old)


@pytest.mark.parametrize("missing", [False, True], ids=["all", "one-missing"])
def test_sumsq_twin_matches_the_per_parameter_norm(missing):
    """The twin sums chunk by chunk (CHUNK elements, ragged last chunk per
    tensor) and then in the kernel's final order; the per-parameter norm
    (the loop's: the norm of the tensors' norms, taken in f64 here) agrees
    within 1e-6. (In f32 the loop's own CPU ``vector_norm`` of the
    300 000-element tensor is 1.3e-6 off the f64 value; the twin is
    within 1e-8 of it.)"""
    rng = np.random.default_rng(4)
    C = optim_ops.CHUNK
    sizes = (1, C - 1, C, C + 1, 300_000, 12_345)
    params = [torch.zeros(n) for n in sizes]
    grads = [torch.from_numpy(rng.normal(size=n).astype(np.float32)) for n in sizes]
    if missing:
        grads[3] = None
    got = optim_ops.optim_sumsq_reference(params, grads)
    live = [g for g in grads if g is not None]
    want = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.double())
                                                 for g in live]))
    assert got.shape == (1,)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert torch.equal(optim_ops.optim_sumsq(params, grads), got)     # the CPU route


def test_entry_rows_are_the_kernels_table():
    C = optim_ops.CHUNK
    params = [torch.zeros(n) for n in (C + 904, 1, 2 * C)]
    grads = [torch.ones_like(params[0]), None, torch.ones_like(params[2])]
    mus = [torch.zeros_like(params[0]), None, None]
    rows = optim_ops.entry_rows(params, grads, mus, mus, ["adam", "sgd", "sgd_plain"])
    assert rows.dtype == np.int64 and rows.shape == (3, 7)
    assert rows[:, 0].tolist() == [p.data_ptr() for p in params]
    assert rows[1, 1] == 0 and rows[1, 2] == 0 and rows[1, 3] == 0
    assert rows[:, 4].tolist() == [C + 904, 1, 2 * C]
    assert rows[:, 5].tolist() == [0, 2, 3]                 # first chunk of each
    assert rows[:, 6].tolist() == [0, 2, 3]
    assert optim_ops.num_chunks(params) == 5
    with pytest.raises(ValueError, match="1..256"):
        optim_ops.entry_rows([], [], [], [], [])


def test_constants_match_the_cuda_source():
    src = (Path(optim_ops.__file__).parents[1] / "csrc" / "optim.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([^;]+);", src).group(1).split()[0])

    assert const("kMaxTensors") == optim_ops.MAX_TENSORS
    assert const("kThreads") * const("kVec") * const("kIters") == optim_ops.CHUNK
    assert const("kThreads") == optim_ops._FINAL_THREADS
    enum = re.search(r"enum Rule : int \{([^}]*)\}", src).group(1)
    assert [int(v) for v in re.findall(r"= (\d+)", enum)] == list(range(len(optim_ops.RULES)))
    # The by-value table: 256 entries of 4 pointers, 2 int64 and 2 int32,
    # and its header, inside the 32 764 bytes of a launch's parameters.
    assert optim_ops.MAX_TENSORS * (4 * 8 + 2 * 8 + 2 * 4) + 16 <= 32764
