"""Train/eval steps, the optimizer family, the CUDA-graph steps and the grad probe.

Counterpart of ``induction_network_on_fewrel_tpu/train/steps.py``. There
one training step (forward, loss, backward, clip, update) is one jitted XLA
program, and ``make_multi_train_step`` scans S steps in one dispatch. Here:

* ``train_step`` / ``eval_step``: the eager step, the CPU path. The
  encoder's backward runs the K8/K11 kernels (K6 at lstm_cs_window=0)
  through the autograd Functions of ``ops/`` on the card, their plain
  versions on the CPU.
* ``make_train_step`` / ``make_multi_train_step`` / ``make_eval_step`` /
  ``make_multi_eval_step``: on the card, each call is ONE CUDA-graph replay
  of S captured steps (S = 1 for the single-step factories), one graph per
  input shape, captured at the first call. The host copies the batch
  from pinned memory into the graph's static inputs and replays; the
  metrics are copied out of the graph's static outputs after each replay.
  Before the capture, one forward and backward run on a side stream
  without an update (and the optimizer kernels once on scratch tensors),
  so step 1 of a graph run is step 1 of an eager run from the same
  weights. On the CPU the factories return the eager steps. The S-step
  graph computes the same sequence of updates as S single steps.
* ``ClipDecayOptimizer`` / ``make_optimizer``: the optax chain of the JAX
  ``make_optimizer`` (steps.py:48-128), clip_by_global_norm over every
  gradient, then per tensor adam (coupled L2 after the clip), adamw
  (decoupled) or sgd (coupled L2, no momentum), with the staircase rate;
  the word table on the main rule (``embed_optimizer="shared"``), on plain
  sgd (``"sgd"``: -lr*g, no decay, no moments), ``"frozen"`` (no
  gradient, no update, no moments, nothing in the norm) or ``"lazy"``
  (its compact rows on ``adam_nodecay``, ``attach_compact``). The update is
  ``ops/optim.py``: two kernels on the card, the per-parameter loop on the
  CPU. The count, the rate and the bias corrections live on the device.
* the token cache (``source``, a ``train/token_cache.TokenTable``): the
  step factories take index batches (``sup_idx [B, N, K]``, ``qry_idx
  [B, TQ]``, ``label``) and gather the token rows inside the step (inside
  the graph on the card), so only the indices cross to the card.
* the lazy word table (``lazy``, a ``train/lazy_embed.LazyTable``): the
  table's rule is "lazy" (out of the dense update), and each step reads
  and updates compact rows (``adam_nodecay``) between a catch-up kernel
  and a scatter kernel: per step on the live path (after a graph-safe
  dedup of the batch's ids), once per call of S steps on the token cache.
  On the CPU the same step body runs eagerly.
* ``make_grad_probe``: the run-config gradient against an all-f32 plain
  backend (lstm_cs_window=0) reference gradient on the same batch and
  weights; norms and cosine through one shared reduction. Eager, off the
  training graph.

Launch counts under a graph: a kernel wrapper counts the calls that launch
its kernel, so under a graph it counts the warm-up's and the capture's
calls, not the replays (count those from the profiler's kernel records).
"""

from __future__ import annotations

import contextlib
import functools
import gc
import math

import numpy as np
import torch

from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.models.base import QUERY_KEYS, to_device
from induction_network_on_fewrel_tpu_torch.models.losses import (
    LOSS_FNS,
    accuracy,
    episode_metrics,
)
from induction_network_on_fewrel_tpu_torch.ops.optim import (
    MOMENT_RULES,
    RULES,
    OptimHyper,
    make_workspace,
    optim_sumsq,
    optim_update,
)

TRAIN_METRICS = ("loss", "accuracy", "grad_norm")
WORD_TABLE = "embedding.word_embedding"
OPTIMIZERS = ("adam", "adamw", "sgd")
EMBED_OPTIMIZERS = ("shared", "sgd", "frozen", "lazy")
# Rules that keep a parameter out of the dense update: no gradient used,
# no moments, nothing in the norm.
EXCLUDED_RULES = ("frozen", "lazy")


class ClipDecayOptimizer:
    """clip_by_global_norm over every gradient, then each parameter's rule
    (``ops.optim.RULES``, or "frozen"/"lazy": left out of the update and
    the norm), with a staircase learning rate. Moments exist only for the
    adam/adamw tensors. ``count`` is an int64 device scalar.
    ``attach_compact`` adds the lazy table's compact rows as one more
    entry (``adam_nodecay``, its moments the compact buffers), outside the
    parameter list and the state dict."""

    def __init__(self, params, lr: float, weight_decay: float, lr_step_size: int,
                 lr_gamma: float, grad_clip: float, rules=None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.rules = list(rules) if rules is not None else ["adam"] * len(self.params)
        if len(self.rules) != len(self.params):
            raise ValueError(f"{len(self.rules)} rules for {len(self.params)} parameters")
        for r in self.rules:
            if r not in RULES + EXCLUDED_RULES:
                raise ValueError(f"unknown update rule {r!r} (one of {RULES + EXCLUDED_RULES})")
        self.hyper = OptimHyper(lr, lr_gamma, lr_step_size, weight_decay, grad_clip, b1, b2, eps)
        dev = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int64, device=dev)
        self.mu = [torch.zeros_like(p) if r in MOMENT_RULES else None
                   for p, r in zip(self.params, self.rules)]
        self.nu = [torch.zeros_like(p) if r in MOMENT_RULES else None
                   for p, r in zip(self.params, self.rules)]
        self._live = [i for i, r in enumerate(self.rules) if r not in EXCLUDED_RULES]
        self._compact = None
        self._ws = make_workspace([self.params[i] for i in self._live]) \
            if dev.type == "cuda" else None

    def attach_compact(self, rows: torch.Tensor, m: torch.Tensor, v: torch.Tensor) -> None:
        """Update ``rows`` (a leaf) with ``adam_nodecay`` and the moments
        ``m``, ``v`` in every step, its gradient in the global norm."""
        self._compact = (rows, m, v)
        if self._ws is not None:
            self._ws = make_workspace([self.params[i] for i in self._live] + [rows])

    def learning_rate(self) -> float:
        """The staircase rate of the next update, on the host (reads the
        device count; the step itself computes it on the device)."""
        h = self.hyper
        return h.lr * h.lr_gamma ** (int(self.count) // h.lr_step_size)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None
        if self._compact is not None:
            self._compact[0].grad = None

    def _table(self):
        i = self._live
        table = ([self.params[k] for k in i], [self.params[k].grad for k in i],
                 [self.mu[k] for k in i], [self.nu[k] for k in i], [self.rules[k] for k in i])
        if self._compact is not None:
            rows, m, v = self._compact
            for col, x in zip(table, (rows, rows.grad, m, v, "adam_nodecay")):
                col.append(x)
        return table

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Apply one update from the parameters' ``.grad`` (None: zeros);
        returns the global gradient norm before the clip (a fresh f32
        device scalar)."""
        params, grads, mus, nus, rules = self._table()
        norm = optim_sumsq(params, grads, self._ws)
        optim_update(params, grads, mus, nus, rules, norm, self.count, self.hyper, self._ws)
        return norm.reshape(())

    def state_dict(self) -> dict:
        """``count`` as an int (the format of the earlier Adam-only
        optimizer, whose state loads here), the rule of every parameter,
        and its moments (None where its rule keeps none)."""
        def copy(xs):
            return [None if x is None else x.detach().clone() for x in xs]

        return {"count": int(self.count), "rules": list(self.rules),
                "mu": copy(self.mu), "nu": copy(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        """Copy ``state`` in place into this optimizer's tensors (a
        captured graph holds their addresses). A state without "rules" is
        the Adam-only format: every parameter on "adam"."""
        rules = list(state.get("rules", ["adam"] * len(state["mu"])))
        if len(state["mu"]) != len(self.params) or len(state["nu"]) != len(self.params):
            raise ValueError(
                f"optimizer state has {len(state['mu'])} moments for {len(self.params)} params"
            )
        if rules != self.rules:
            raise ValueError(f"optimizer state was saved with rules {rules}, this optimizer "
                             f"has {self.rules} (optimizer/embed_optimizer differ)")
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            if dst is None:
                continue
            if src is None or dst.shape != src.shape:
                raise ValueError(f"optimizer moment {None if src is None else tuple(src.shape)} "
                                 f"!= {tuple(dst.shape)}")
            dst.copy_(src)
        self.count.fill_(int(state["count"]))


def check_embed_optimizer(cfg: ExperimentConfig) -> None:
    """Refuse ``embed_optimizer`` other than "shared" for a model without a
    GloVe table: the BERT paths own their embedding and a feature-cache
    state is the head alone (the JAX refusal, cli.py:810-823)."""
    if cfg.embed_optimizer == "shared":
        return
    what = ("--feature_cache (head-only state, no word table)" if cfg.feature_cache else
            "--encoder bert (owns its embedding; no GloVe table)" if cfg.encoder == "bert" else
            None)
    if what is not None:
        raise ValueError(f"--embed_optimizer {cfg.embed_optimizer} does not combine with {what}; "
                         "use --embed_optimizer shared there")


def make_optimizer(cfg: ExperimentConfig, model: torch.nn.Module) -> ClipDecayOptimizer:
    """The JAX ``make_optimizer`` chain for ``cfg.optimizer`` and
    ``cfg.embed_optimizer`` over every parameter of ``model``. A parameter
    without a gradient (a frozen BERT backbone's) stays in the update with
    zeros, as the JAX chain's ``stop_gradient`` leaves it: under a weight
    decay it still moves by the decay term."""
    check_embed_optimizer(cfg)
    if cfg.optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r} (one of {OPTIMIZERS})")
    if cfg.embed_optimizer == "lazy":
        from induction_network_on_fewrel_tpu_torch.train.lazy_embed import require_adam

        require_adam(cfg)
    if cfg.embed_optimizer not in EMBED_OPTIMIZERS:
        raise ValueError(f"unknown embed_optimizer {cfg.embed_optimizer!r} "
                         f"(one of {EMBED_OPTIMIZERS})")
    if cfg.lr_step_size <= 0 or not math.isfinite(cfg.lr):
        raise ValueError(f"bad schedule: lr={cfg.lr}, lr_step_size={cfg.lr_step_size}")
    names = [n for n, _ in model.named_parameters()]
    if cfg.embed_optimizer != "shared" and WORD_TABLE not in names:
        raise ValueError(f"embed_optimizer={cfg.embed_optimizer!r} but the model has no "
                         f"{WORD_TABLE} parameter: the flag would do nothing")
    table_rule = {"shared": cfg.optimizer, "sgd": "sgd_plain", "frozen": "frozen",
                  "lazy": "lazy"}[cfg.embed_optimizer]
    return ClipDecayOptimizer(
        model.parameters(), lr=cfg.lr, weight_decay=cfg.weight_decay,
        lr_step_size=cfg.lr_step_size, lr_gamma=cfg.lr_gamma, grad_clip=cfg.grad_clip,
        rules=[table_rule if n == WORD_TABLE else cfg.optimizer for n in names],
    )


def loss_and_metrics(model, support, query, label, loss_name: str):
    """(loss, {"loss", "accuracy"}) of one batch; metrics are detached."""
    logits = model(support, query)
    loss = LOSS_FNS[loss_name](logits, label)
    return loss, {"loss": loss.detach(), "accuracy": accuracy(logits.detach(), label)}


def _inputs_on(model, support, query, label):
    dev = model.device
    return to_device(support, dev), to_device(query, dev), torch.as_tensor(label).to(dev)


def train_step(model, opt: ClipDecayOptimizer, cfg: ExperimentConfig, support, query,
               label) -> dict:
    """One eager update on one batch (numpy or tensor leaves). Returns
    device scalars: loss, accuracy and the pre-clip gradient norm."""
    support, query, label = _inputs_on(model, support, query, label)
    opt.zero_grad()
    loss, metrics = loss_and_metrics(model, support, query, label, cfg.loss)
    loss.backward()
    metrics["grad_norm"] = opt.step()
    opt.zero_grad()
    return metrics


def _eval_metrics(model, cfg, support, query, label) -> dict:
    logits = model(support, query)
    return {"loss": LOSS_FNS[cfg.loss](logits, label),
            **episode_metrics(logits, label, cfg.na_rate > 0)}


@torch.inference_mode()
def eval_step(model, cfg: ExperimentConfig, support, query, label) -> dict:
    """Loss + episode metrics of one batch, without a graph (the K1/K2 route)."""
    return _eval_metrics(model, cfg, *_inputs_on(model, support, query, label))


def eval_metric_keys(cfg: ExperimentConfig) -> tuple:
    return ("loss", "accuracy") + (("nota_tp", "nota_pred", "nota_true") if cfg.na_rate > 0
                                   else ())


# --- CUDA graphs -------------------------------------------------------------------


def batch_leaves(support, query, label) -> list:
    """(name, numpy array) of every input leaf of a (stacked) batch: what
    ``CapturedSteps.fill`` copies into a graph's static inputs. A token
    dict per side, or (token cache) the index arrays ``s_idx``/``q_idx``."""
    if not isinstance(support, dict):
        return [("s_idx", np.asarray(support)), ("q_idx", np.asarray(query)),
                ("label", np.asarray(label))]
    return ([("s_" + k, np.asarray(support[k])) for k in QUERY_KEYS]
            + [("q_" + k, np.asarray(query[k])) for k in QUERY_KEYS]
            + [("label", np.asarray(label))])


def _batch(dev: dict, i: int):
    """Batch ``i`` of the stacked static inputs as model inputs."""
    return ({k: dev["s_" + k][i] for k in QUERY_KEYS}, {k: dev["q_" + k][i] for k in QUERY_KEYS},
            dev["label"][i])


def batch_source(source=None, compact: bool = False):
    """``(dev, i) -> (support, query, label)`` of batch ``i``: the token
    leaves themselves, or (``source``, a TokenTable) the rows their indices
    name, gathered on the device (``compact``: words as ``winv``)."""
    if source is None:
        return _batch

    def gathered(dev: dict, i: int):
        return (source.gather(dev["s_idx"][i], compact), source.gather(dev["q_idx"][i], compact),
                dev["label"][i])

    return gathered


class CapturedSteps:
    """One CUDA graph of ``run`` over S stacked batches, with its static
    inputs (pinned host buffers and their device copies) and output.

    ``run(dev) -> [S, k]`` is captured once; ``warm(dev)`` runs first on a
    side stream, eagerly, and must leave the training state as it was.
    Each call copies a batch in, replays, and returns a copy of the output.
    ``pool_bytes`` is what the capture added to the caching allocator's
    reserve (the graph's private memory pool)."""

    def __init__(self, leaves: list, run, warm, device: torch.device):
        self.host = {n: torch.empty(a.shape, dtype=torch.from_numpy(a).dtype, pin_memory=True)
                     for n, a in leaves}
        self.dev = {n: torch.empty_like(h, device=device) for n, h in self.host.items()}
        self.copied = torch.cuda.Event()
        self.fill(leaves)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            warm(self.dev)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        gc.collect()
        torch.cuda.empty_cache()        # as the capture does on entry
        reserved = torch.cuda.memory_reserved(device)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = run(self.dev)
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved

    def fill(self, leaves: list) -> None:
        """Copy a batch into the static inputs: into the pinned buffers once
        the previous call's copies have read them, then to the device on
        the current stream without a host wait."""
        self.copied.synchronize()
        for n, a in leaves:
            self.host[n].numpy()[...] = a
        for n, h in self.host.items():
            self.dev[n].copy_(h, non_blocking=True)
        self.copied.record()

    def __call__(self, leaves: list) -> torch.Tensor:
        self.fill(leaves)
        self.graph.replay()
        return self.out.clone()


class GraphSteps:
    """``(support_s, query_s, label_s) -> {key: [S] tensor}`` through one
    ``CapturedSteps`` per input signature (captured at its first call)."""

    def __init__(self, run_of, warm, keys: tuple, device: torch.device):
        self.run_of, self.warm, self.keys, self.device = run_of, warm, keys, device
        self.graphs: dict = {}

    def __call__(self, support_s, query_s, label_s) -> dict:
        leaves = batch_leaves(support_s, query_s, label_s)
        out = self.captured(leaves)(leaves)
        return {k: out[:, j] for j, k in enumerate(self.keys)}

    def captured(self, leaves: list) -> CapturedSteps:
        """The graph of these inputs' signature, captured on first use."""
        sig = tuple((n, a.shape, a.dtype.str) for n, a in leaves)
        graph = self.graphs.get(sig)
        if graph is None:
            S = leaves[-1][1].shape[0]
            graph = self.graphs[sig] = CapturedSteps(leaves, self.run_of(S), self.warm,
                                                     self.device)
        return graph

    @property
    def pool_bytes(self) -> int:
        return sum(g.pool_bytes for g in self.graphs.values())


def stack1(support, query, label):
    """One batch as a stack of one: leading axis 1 on every leaf."""
    def one(x):
        return ({k: np.asarray(v)[None] for k, v in x.items()} if isinstance(x, dict)
                else np.asarray(x)[None])

    return one(support), one(query), np.asarray(label)[None]


def _single(multi):
    """A one-batch callable over an S-step callable run at S = 1."""
    def step(support, query, label) -> dict:
        return {k: v[0] for k, v in multi(*stack1(support, query, label)).items()}

    step.graphs = multi
    return step


def _eager_multi(step):
    def multi(support_s, query_s, label_s) -> dict:
        outs = [step({k: v[i] for k, v in support_s.items()},
                     {k: v[i] for k, v in query_s.items()}, label_s[i])
                for i in range(len(label_s))]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    return multi


class EagerSteps:
    """The CPU twin of ``GraphSteps`` for the token-cache and lazy steps:
    the same ``run_of(S)`` body, run eagerly on the batch's tensors."""

    def __init__(self, run_of, keys: tuple, device: torch.device):
        self.run_of, self.keys, self.device = run_of, keys, device

    def __call__(self, support_s, query_s, label_s) -> dict:
        leaves = batch_leaves(support_s, query_s, label_s)
        dev = {n: torch.as_tensor(a).to(self.device) for n, a in leaves}
        out = self.run_of(len(label_s))(dev)
        return {k: out[:, j] for j, k in enumerate(self.keys)}


def _train_run_of(model, opt: ClipDecayOptimizer, cfg: ExperimentConfig, source=None,
                  lazy=None):
    """``run_of(S)``: S training steps on the stacked inputs ``dev``, and
    the metrics [S, 3]. The lazy table's prologue and epilogue wrap each
    step (live) or the S steps (token cache)."""
    batch_of = batch_source(source, compact=lazy is not None and lazy.cached)
    hoisted = lazy is not None and lazy.cached

    def one_step(dev, i) -> torch.Tensor:
        support, query, label = batch_of(dev, i)
        if lazy is not None and not lazy.cached:
            support, query = lazy.dedup(support, query)
            lazy.prologue(opt.count)
        opt.zero_grad()
        with lazy.compact_forward() if lazy is not None else contextlib.nullcontext():
            loss, m = loss_and_metrics(model, support, query, label, cfg.loss)
        loss.backward()
        norm = opt.step()
        if lazy is not None and not lazy.cached:
            lazy.epilogue(opt.count)
        return torch.stack([m["loss"].float(), m["accuracy"].float(), norm])

    def run_of(S: int):
        def run(dev) -> torch.Tensor:
            if hoisted:
                lazy.prologue(opt.count)
            rows = [one_step(dev, i) for i in range(S)]
            if hoisted:
                lazy.epilogue(opt.count)
            opt.zero_grad()
            return torch.stack(rows)

        return run

    def warm(dev) -> None:
        """One forward and backward without an update, then the update's
        and the lazy table's kernels once on scratch tensors. The lazy
        prologue writes only the compact buffers, which every step
        rewrites."""
        support, query, label = batch_of(dev, 0)
        if lazy is not None:
            if lazy.cached:
                lazy.prologue(opt.count)
            else:
                support, query = lazy.dedup(support, query)
                lazy.prologue(opt.count)
        opt.zero_grad()
        with lazy.compact_forward() if lazy is not None else contextlib.nullcontext():
            loss, _ = loss_and_metrics(model, support, query, label, cfg.loss)
        loss.backward()
        opt.zero_grad()
        _warm_optim_kernels(model.device)
        if lazy is not None:
            lazy.warm_kernels()

    return run_of, warm


def _train_graphs(model, opt: ClipDecayOptimizer, cfg: ExperimentConfig, source=None,
                  lazy=None):
    run_of, warm = _train_run_of(model, opt, cfg, source, lazy)
    if model.device.type != "cuda":
        return EagerSteps(run_of, TRAIN_METRICS, model.device)
    return GraphSteps(run_of, warm, TRAIN_METRICS, model.device)


def _warm_optim_kernels(device) -> None:
    """Launch the optimizer pair once on scratch tensors, so their module is
    loaded before a capture; the training state is not touched."""
    p = torch.zeros(1, device=device)
    g, m, v = torch.ones_like(p), torch.zeros_like(p), torch.zeros_like(p)
    count = torch.zeros((), dtype=torch.int64, device=device)
    ws = make_workspace([p])
    norm = optim_sumsq([p], [g], ws)
    optim_update([p], [g], [m], [v], ["adam"], norm, count,
                 OptimHyper(1e-3, 0.5, 1, 0.0, 1.0), ws)


def _eval_run_of(model, cfg: ExperimentConfig, source=None):
    keys = eval_metric_keys(cfg)
    batch_of = batch_source(source)

    def run_of(S: int):
        @torch.inference_mode()
        def run(dev) -> torch.Tensor:
            rows = []
            for i in range(S):
                m = _eval_metrics(model, cfg, *batch_of(dev, i))
                rows.append(torch.stack([m[k].float() for k in keys]))
            return torch.stack(rows)

        return run

    @torch.inference_mode()
    def warm(dev) -> None:
        _eval_metrics(model, cfg, *batch_of(dev, 0))

    return run_of, warm, keys


def _eval_graphs(model, cfg: ExperimentConfig, source=None):
    run_of, warm, keys = _eval_run_of(model, cfg, source)
    if model.device.type != "cuda":
        return EagerSteps(run_of, keys, model.device)
    return GraphSteps(run_of, warm, keys, model.device)


def make_train_step(model, opt: ClipDecayOptimizer, cfg: ExperimentConfig, source=None,
                    lazy=None):
    """``(support, query, label) -> {loss, accuracy, grad_norm}`` device
    scalars (copies). On the card one CUDA-graph replay per call; on the
    CPU the eager ``train_step`` (the eager step body with a token-cache
    ``source`` or a ``lazy`` table)."""
    if model.device.type != "cuda" and source is None and lazy is None:
        return functools.partial(train_step, model, opt, cfg)
    return _single(_train_graphs(model, opt, cfg, source, lazy))


def make_multi_train_step(model, opt: ClipDecayOptimizer, cfg: ExperimentConfig, source=None,
                          lazy=None):
    """``(support_s, query_s, label_s)`` stacked [S, ...] -> metrics [S]:
    S updates per call, the same sequence as S single steps. On the card
    one replay of a graph of S captured steps; on the CPU S eager steps."""
    if model.device.type != "cuda" and source is None and lazy is None:
        return _eager_multi(functools.partial(train_step, model, opt, cfg))
    return _train_graphs(model, opt, cfg, source, lazy)


def make_eval_step(model, cfg: ExperimentConfig, source=None):
    """``(support, query, label) -> eval metrics`` (K1/K2, no autograd);
    one graph replay per call on the card, ``eval_step`` on the CPU."""
    if model.device.type != "cuda" and source is None:
        return functools.partial(eval_step, model, cfg)
    return _single(_eval_graphs(model, cfg, source))


def make_multi_eval_step(model, cfg: ExperimentConfig, source=None):
    """Eval metrics [S] of S stacked batches per call (one replay on the
    card); the same values as S calls of the single eval step."""
    if model.device.type != "cuda" and source is None:
        return _eager_multi(functools.partial(eval_step, model, cfg))
    return _eval_graphs(model, cfg, source)


# --- grad probe ---------------------------------------------------------------------


def probe_reference_config(cfg: ExperimentConfig) -> ExperimentConfig:
    """The probe's reference: all f32, the plain backends, and the
    full-residual route (the JAX probe's scan LSTM keeps no window)."""
    return cfg.replace(compute_dtype="float32", head_dtype="float32",
                       lstm_backend="reference", attn_backend="reference",
                       lstm_cs_window=0, lstm_residuals="f32")


def _flat_grad(model, cfg, support, query, label) -> torch.Tensor:
    """Every parameter's gradient of the loss on one batch, flattened in
    f32 (zeros for a parameter with none, as a frozen table); no ``.grad``
    is touched."""
    params = list(model.parameters())
    loss, _ = loss_and_metrics(model, support, query, label, cfg.loss)
    grads = torch.autograd.grad(loss, [p for p in params if p.requires_grad],
                                allow_unused=True)
    grads = iter(grads)
    flat = [(next(grads) if p.requires_grad else None) for p in params]
    return torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1).float()
                      for p, g in zip(params, flat)])


def make_grad_probe(model, cfg: ExperimentConfig):
    """``(support, query, label) -> {grad_norm, grad_norm_f32,
    grad_cosine}`` (f32 device scalars): the run-config gradient and the
    reference gradient (``probe_reference_config``) on the same batch and
    weights, all three inner products through one reduction (``torch.dot``
    in f32) so its rounding is common to the norms and the cosine, and a
    shared epsilon (two zero gradients agree: cosine 1). Eager; touches no
    training state."""
    from induction_network_on_fewrel_tpu_torch.models.build import build_model

    ref_cfg = probe_reference_config(cfg)
    ref_model = build_model(ref_cfg, device=model.device)

    def probe(support, query, label) -> dict:
        ref_model.load_state_dict(model.state_dict())
        batch = _inputs_on(model, support, query, label)
        g_run = _flat_grad(model, cfg, *batch)
        g_ref = _flat_grad(ref_model, ref_cfg, *batch)
        d_rr, d_ff, d_rf = torch.dot(g_run, g_run), torch.dot(g_ref, g_ref), torch.dot(g_run, g_ref)
        cos = (d_rf + 1e-30) / (torch.sqrt(d_rr * d_ff) + 1e-30)
        return {"grad_norm": torch.sqrt(d_rr), "grad_norm_f32": torch.sqrt(d_ff),
                "grad_cosine": cos}

    return probe
