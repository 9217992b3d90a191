"""Ranks as spawned processes with a bounded wall time, and the dp cases they run.

``run_ranks(fn, world_size, payload)`` starts ``world_size`` processes
(the ``spawn`` start method), each joins one process group over a
``FileStore`` in a scratch directory (gloo by default) and runs ``fn(rank,
world_size, payload)``; the return values come back in rank order. A rank
that fails fails the call with its traceback; ranks still running at the
deadline are killed, and the call raises. Nothing waits unbounded: the
rendezvous and every collective get the same timeout.

``dp_more_cases`` runs, under the world's dp mesh, the adversarial step
(``ADV_CASES``: monolithic, bucketed, ZeRO-1) from given model and
discriminator weights on given global (episode, source, target) batches,
each rank on its rows of each; the feature cache (``CACHE_CASES``), each
rank encoding the whole table with the given backbone and training the
head on its rows of given index batches; and ``--mixture`` through
``cli.make_trainer`` (the picks, the children's seeds, and a resume from
the ring slot against the uninterrupted run). ``more_cases(payload,
None)`` is the one-process reference of the first two.

``dp_cases`` runs the token-cache lazy training step under several dp
spellings from the same weights on the same global batches (each rank
steps on its own rows of every batch) and returns each case's losses,
gradient norms, final parameters and moments (the lazy table's compact
rows' included), and the collectives its steps issued (``COLLECTIVES``,
counted around each step) beside the ones they should issue
(``DataParallel.plan``); ``run_cases(payload, mesh=None)`` is the same
body on one process over the global batch (the reference). The payload
is plain data: the config's keywords, the weights (a state dict of numpy
arrays, or None for the seed's), the token table's arrays and rows per
relation, and the global index batches.

``dp_moe_cases`` runs the MoE transformer on the (dp, ep) layouts of its
world size (``MOE_LAYOUTS``: (2, 1) and (1, 2) on two ranks, (2, 2) on
four) from given full weights on given global token batches, each rank on
its dp index's rows: the first batch's forward and gradient, then a
training step a batch (``run_moe_case``; with the mesh None, the
one-process reference), saving and restoring ring slots across ep
(``restore_moe``) and the train and test CLI under the layout
(``moe_cli``); ``moe_test_reference`` is one process's ``test`` of the
episodes the dp ranks draw. The sharded executors still to port (tp, sp,
pp) come with ROADMAP queue A item 6d.
"""

from __future__ import annotations

import collections
import functools
import os
import pickle
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

# The dp spellings: config keywords of each case.
CASES = {
    "monolithic": dict(grad_bucketing="off", compact_demb="off"),
    "compact": dict(grad_bucketing="off", compact_demb="on"),
    "bucketed": dict(grad_bucketing="on", compact_demb="on"),
    "bucketed_sync": dict(grad_bucketing="on", compact_demb="on", async_collectives="off"),
    "zero1": dict(grad_bucketing="off", compact_demb="on", zero_opt=True),
}


def _rank_main(fn, rank: int, world: int, store_path: str, out_path: str, backend: str,
               timeout_s: float, payload) -> None:
    import torch.distributed as dist

    from induction_network_on_fewrel_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
    )

    torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, world)
        maybe_initialize_distributed(backend=backend, store=store, rank=rank, world_size=world,
                                     timeout_s=timeout_s)
        result = fn(rank, world, payload)
        with open(out_path, "wb") as f:
            pickle.dump({"ok": result}, f)
    except BaseException:
        with open(out_path, "wb") as f:
            pickle.dump({"error": traceback.format_exc()}, f)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world_size: int, payload=None, timeout_s: float = 60.0,
              backend: str = "gloo") -> list:
    """``fn(rank, world_size, payload)`` on ``world_size`` spawned ranks;
    their return values in rank order. ``fn`` must be importable (a
    module-level function). Raises RuntimeError on a failed rank or once
    ``timeout_s`` has passed (every rank killed)."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="dp_rig_") as tmp:
        store = os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world_size)]
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, store, outs[r], backend, timeout_s, payload))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            late = [r for r, p in enumerate(procs) if p.is_alive()]
            if late:
                raise RuntimeError(f"ranks {late} still running after {timeout_s:.0f} s: killed")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5)
        results = []
        for r, path in enumerate(outs):
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} exited with code {procs[r].exitcode} and no result")
            with open(path, "rb") as f:
                got = pickle.load(f)
            if "error" in got:
                raise RuntimeError(f"rank {r} failed:\n{got['error']}")
            results.append(got["ok"])
        return results


# --- the dp cases --------------------------------------------------------------


def numpy_state(model) -> dict:
    return {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}


def build_case(payload: dict, overrides: dict, mesh, device):
    """(cfg, model, opt, lazy, table, dp) of one case: the payload's weights
    (or the seed's), the lazy table over the token cache, and the case's
    ``DataParallel`` under a mesh."""
    from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
    from induction_network_on_fewrel_tpu_torch.models.build import build_model
    from induction_network_on_fewrel_tpu_torch.parallel.sharding import DataParallel
    from induction_network_on_fewrel_tpu_torch.train.lazy_embed import (
        LazyTable,
        augment_token_table,
        live_rows,
    )
    from induction_network_on_fewrel_tpu_torch.train.steps import make_optimizer
    from induction_network_on_fewrel_tpu_torch.train.token_cache import TokenTable

    cfg = ExperimentConfig(**{**payload["cfg"], **overrides})
    model = build_model(cfg, device=device)
    if payload.get("weights") is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in payload["weights"].items()})
    opt = make_optimizer(cfg, model)
    arrays, uids = augment_token_table(payload["table"])
    table = TokenTable(arrays, payload["sizes"], device, uids)
    lazy = LazyTable(model, opt.hyper, live_rows(cfg), uids=table.uids)
    opt.attach_compact(lazy.rows, lazy.rows_m, lazy.rows_v)
    dp = DataParallel(model, opt, cfg, mesh, lazy) if mesh is not None else None
    return cfg, model, opt, lazy, table, dp


def local_rows(batch, mesh) -> tuple:
    """This rank's rows of a global (support_idx, query_idx, label) batch."""
    if mesh is None:
        return batch
    from induction_network_on_fewrel_tpu_torch.parallel.hostfeed import local_episode_range

    lo, n = local_episode_range(mesh, len(batch[2]))
    return tuple(np.asarray(x)[lo:lo + n] for x in batch)


def run_case(payload: dict, overrides: dict, mesh, resume_at: int | None = None,
             ckpt_dir: str | None = None) -> dict:
    """Train ``payload["batches"]`` one step each; losses (the ranks'
    mean), gradient norms, the final parameters (the lazy table
    materialized), the full moments ("mu/<name>", "nu/<name>", and the
    compact rows' "lazy/rows_m", "lazy/rows_v") and, under a mesh, the
    collectives issued per step beside the plan. With ``resume_at`` the
    state is materialized after that many steps and, on rank 0, saved to
    ``ckpt_dir`` as a recovery-ring slot (the trainer's save: gathered
    moments)."""
    from induction_network_on_fewrel_tpu_torch.parallel.grad_buckets import COLLECTIVES
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager
    from induction_network_on_fewrel_tpu_torch.train.framework import SavedOptimizer
    from induction_network_on_fewrel_tpu_torch.train.steps import make_train_step

    device = torch.device(payload.get("device", "cpu"))
    cfg, model, opt, lazy, table, dp = build_case(payload, overrides, mesh, device)
    step = make_train_step(model, opt, cfg, source=table, lazy=lazy, dp=dp)
    losses, norms = [], []
    issued: collections.Counter = collections.Counter()
    out: dict = {}
    t0 = time.monotonic()
    for i, batch in enumerate(payload["batches"]):
        if resume_at is not None and i == resume_at:
            lazy.materialize(opt.count)
            saved = SavedOptimizer(opt.state_dict())
            if mesh is None or mesh.rank == 0:
                mgr = CheckpointManager(ckpt_dir, cfg.replace(ckpt_delta="off"))
                mgr.save_latest(i, model, saved, lazy=lazy)
                mgr.close()
            if dp is not None:
                dp.barrier()
        before = collections.Counter(COLLECTIVES)
        m = step(*local_rows(batch, mesh))
        issued += COLLECTIVES - before
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out["seconds"] = time.monotonic() - t0
    lazy.materialize(opt.count)
    full = opt.state_dict()
    moments = {f"{kind}/{n}": x.float().cpu().numpy() for kind in ("mu", "nu")
               for n, x in zip(opt.names, full[kind]) if x is not None}
    moments["lazy/rows_m"] = lazy.rows_m.cpu().numpy()
    moments["lazy/rows_v"] = lazy.rows_v.cpu().numpy()
    out.update(losses=losses, grad_norms=norms, params=numpy_state(model), moments=moments)
    if opt.zero is not None:
        out["zero_shards"] = {opt.names[i]: (int(n), int(opt.params[i].numel()))
                              for i, (_, n) in opt.zero.shards.items()}
        out["moment_numels"] = {opt.names[i]: int(opt.params[i].numel()) for i in opt._live
                                if opt.mu[i] is not None}
    if dp is not None:
        out["plan"] = dp.plan()
        out["issued_per_step"] = {k: n / len(losses) for k, n in issued.items()}
    return out


def restore_and_continue(payload: dict, overrides: dict, ckpt_dir: str, start: int) -> dict:
    """One process (no group): restore the ring slot of ``ckpt_dir`` and
    train the batches from ``start`` on; the final parameters."""
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager
    from induction_network_on_fewrel_tpu_torch.train.steps import make_train_step

    device = torch.device(payload.get("device", "cpu"))
    cfg, model, opt, lazy, table, _ = build_case(payload, overrides, None, device)
    step_no, _ = CheckpointManager(ckpt_dir, cfg).restore_latest(model, opt, lazy)
    step = make_train_step(model, opt, cfg, source=table, lazy=lazy)
    losses = [float(step(*b)["loss"]) for b in payload["batches"][start:]]
    lazy.materialize(opt.count)
    return {"step": step_no, "losses": losses, "params": numpy_state(model)}


def run_cases(payload: dict, mesh=None) -> dict:
    """Every case of ``payload["cases"]`` (names of ``CASES``) under
    ``mesh``, or once without one (the one-process reference, global
    batches) when ``mesh`` is None."""
    out = {}
    for name in payload.get("cases", list(CASES)):
        kw = dict(CASES[name])
        if name == "zero1" and payload.get("resume_dir") is not None:
            out[name] = run_case(payload, kw, mesh, resume_at=payload["resume_at"],
                                 ckpt_dir=payload["resume_dir"])
        else:
            out[name] = run_case(payload, kw, mesh)
        if mesh is None:
            break           # one process: every spelling is the same step
    return out


def dp_cases(rank: int, world: int, payload: dict) -> dict:
    """A rank's ``run_cases`` over the world's dp mesh."""
    from induction_network_on_fewrel_tpu_torch.parallel.mesh import make_mesh

    return run_cases(payload, make_mesh(dp=world))


# --- the adversarial, feature-cache and mixture cases ---------------------------

# The adversarial step's dp spellings (config keywords of each case).
ADV_CASES = {
    "adv_monolithic": dict(grad_bucketing="off"),
    "adv_bucketed": dict(grad_bucketing="on"),
    "adv_zero1": dict(grad_bucketing="off", zero_opt=True),
}
# The feature cache's: the head-only state reduced whole, and under ZeRO-1.
CACHE_CASES = {
    "cache": dict(grad_bucketing="off"),
    "cache_zero1": dict(grad_bucketing="off", zero_opt=True),
}


def _rows_of(x, lo: int, n: int):
    if isinstance(x, dict):
        return {k: np.asarray(v)[lo:lo + n] for k, v in x.items()}
    return np.asarray(x)[lo:lo + n]


def local_adv_rows(batch, mesh) -> tuple:
    """This rank's rows of a global (support, query, label, src, tgt)
    batch: its episodes, and its rows of each instance batch."""
    if mesh is None:
        return batch
    from induction_network_on_fewrel_tpu_torch.parallel.hostfeed import local_episode_range

    lo, n = local_episode_range(mesh, len(batch[2]))
    ilo, m = local_episode_range(mesh, len(batch[3]["word"]))
    return tuple(_rows_of(x, lo, n) for x in batch[:3]) + tuple(
        _rows_of(x, ilo, m) for x in batch[3:])


def _dp_metrics(step, batches, rows_of, mesh, keys: tuple, dp) -> dict:
    """Run ``step`` on this rank's rows of every batch: each key's values
    per step and, under a mesh, the collectives each step issued beside the
    plan."""
    from induction_network_on_fewrel_tpu_torch.parallel.grad_buckets import COLLECTIVES

    out = {k: [] for k in keys}
    issued: collections.Counter = collections.Counter()
    t0 = time.monotonic()
    for batch in batches:
        before = collections.Counter(COLLECTIVES)
        m = step(*rows_of(batch, mesh))
        issued += COLLECTIVES - before
        for k in keys:
            out[k].append(float(m[k]))
    out["seconds"] = time.monotonic() - t0
    if dp is not None:
        out["plan"] = dp.plan()
        out["issued_per_step"] = {k: n / len(batches) for k, n in issued.items()}
    return out


def run_adv_case(payload: dict, overrides: dict, mesh) -> dict:
    """The adversarial step (``train/steps.make_adv_train_step``) on
    ``payload["batches"]`` from the payload's model and discriminator
    weights: losses, domain losses, gradient norms, the final model and
    discriminator parameters and, under a mesh, the collectives."""
    from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
    from induction_network_on_fewrel_tpu_torch.models.build import build_model, encoder_output_dim
    from induction_network_on_fewrel_tpu_torch.parallel.sharding import DataParallel
    from induction_network_on_fewrel_tpu_torch.train.steps import (
        init_disc_state,
        make_adv_train_step,
        make_optimizer,
    )

    device = torch.device(payload.get("device", "cpu"))
    cfg = ExperimentConfig(**{**payload["cfg"], **overrides})
    model = build_model(cfg, device=device)
    if payload.get("weights") is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in payload["weights"].items()})
    disc = init_disc_state(cfg, encoder_output_dim(cfg), device)
    if payload.get("disc_weights") is not None:
        disc.module.load_state_dict({k: torch.as_tensor(v)
                                     for k, v in payload["disc_weights"].items()})
    opt = make_optimizer(cfg, model)
    dp = DataParallel(model, opt, cfg, mesh, disc=disc.opt) if mesh is not None else None
    step = make_adv_train_step(model, opt, disc, cfg, dp=dp)
    out = _dp_metrics(step, payload["batches"], local_adv_rows, mesh,
                      ("loss", "domain_loss", "accuracy", "domain_accuracy", "grad_norm"), dp)
    out.update(params=numpy_state(model), disc_params=numpy_state(disc.module))
    if opt.zero is not None:
        out["zero_shards"] = len(opt.zero.shards)
    return out


def run_cache_case(payload: dict, overrides: dict, mesh) -> dict:
    """The feature cache: this process encodes the whole table with the
    payload's backbone weights (``build_feature_table``; None: the seed's),
    then trains the head from its weights (None: the seed's) on
    ``payload["batches"]`` (index batches) through
    ``make_train_step`` over the table: losses, the final head parameters,
    the table and, under a mesh, the collectives."""
    from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
    from induction_network_on_fewrel_tpu_torch.data import BertTokenizer, make_synthetic_fewrel
    from induction_network_on_fewrel_tpu_torch.models.build import build_model
    from induction_network_on_fewrel_tpu_torch.parallel.sharding import DataParallel
    from induction_network_on_fewrel_tpu_torch.train.feature_cache import build_feature_table
    from induction_network_on_fewrel_tpu_torch.train.steps import make_optimizer, make_train_step

    device = torch.device(payload.get("device", "cpu"))
    cfg = ExperimentConfig(**{**payload["cfg"], **overrides})
    backbone = build_model(cfg.replace(feature_cache=False), device=device)
    if payload.get("backbone") is not None:
        backbone.load_state_dict({k: torch.as_tensor(v) for k, v in payload["backbone"].items()})
    tok = BertTokenizer(cfg.max_length, vocab_size=cfg.bert_vocab_size)
    table = build_feature_table(backbone, make_synthetic_fewrel(**payload["data"]), tok,
                                batch_size=payload.get("encode_batch", 256))
    head = build_model(cfg, device=device)
    if payload.get("head") is not None:
        head.load_state_dict({k: torch.as_tensor(v) for k, v in payload["head"].items()})
    opt = make_optimizer(cfg, head)
    dp = DataParallel(head, opt, cfg, mesh) if mesh is not None else None
    step = make_train_step(head, opt, cfg, source=table, dp=dp)
    out = _dp_metrics(step, payload["batches"], local_rows, mesh, ("loss", "grad_norm"), dp)
    out.update(params=numpy_state(head), table=table.table.cpu().numpy(), sizes=table.sizes)
    return out


def mixture_case(payload: dict, mesh) -> dict:
    """``--mixture`` through ``cli.make_trainer`` under ``mesh``: the
    mixture's seed and its picks for the first ``picks`` batches, each
    child's stream state before its first draw, then an uninterrupted run
    of ``2 * half`` steps beside a run of ``half`` steps that saves its ring
    slot and a fresh trainer that resumes from it for ``half`` more: each
    one's final parameters and train-stream state, and the batches each
    child served."""
    from induction_network_on_fewrel_tpu_torch import cli

    half = payload["half"]

    def trainer(save=None):
        argv = payload["argv"] + ["--dp", str(mesh.dp if mesh is not None else 0)]
        args = cli.parse_args(True, argv + (["--save_ckpt", save] if save else []))
        cfg = cli.config_from_args(args)
        return cli.make_trainer(args, cfg, mesh=cli.dp_mesh(args, cfg) if mesh else None)[0]

    def mixture_of(t):
        base = t.train_sampler.base
        return base.local if mesh is not None else base

    out: dict = {}
    whole = trainer()
    mix = mixture_of(whole)
    out["seed"] = mix.seed
    out["picks"] = [mix.schedule.pick(mix.seed, i) for i in range(payload["picks"])]
    out["child_states"] = {name: ch.feed_state() for name, ch in mix._children}
    whole.train(2 * half)
    out["counts"] = dict(mix.counts)
    out["whole"] = {"params": numpy_state(whole.model),
                    "stream": whole.sampler_states()["train"]}
    first = trainer(payload["ckpt"])
    first.train(half)
    first.close()
    resumed = trainer(payload["ckpt"])
    step, extra = resumed.reader().restore_latest(resumed.model, resumed.opt, resumed.lazy)
    resumed.restore_sampler_states(extra["samplers"])
    resumed.train(half, start_step=step)
    out["resumed"] = {"step": step, "params": numpy_state(resumed.model),
                      "stream": resumed.sampler_states()["train"]}
    for t in (whole, resumed):
        t.close()
    return out


def more_cases(payload: dict, mesh=None) -> dict:
    """The adversarial cases (``payload["adv"]``), the feature-cache cases
    (``payload["cache"]``) and the mixture (``payload["mixture"]``), each
    part only when its payload is given (a part's "cases" picks its
    spellings, default all); without a mesh one process on the global
    batches (each part's default spelling: the reference)."""
    out: dict = {}
    for part, fn, cases in (("adv", run_adv_case, ADV_CASES),
                            ("cache", run_cache_case, CACHE_CASES)):
        if payload.get(part) is None:
            continue
        names = payload[part].get("cases", list(cases)) if mesh is not None else [next(iter(cases))]
        out[part] = {n: fn(payload[part], cases[n], mesh) for n in names}
    if payload.get("mixture") is not None:
        out["mixture"] = mixture_case(payload["mixture"], mesh)
    return out


def dp_more_cases(rank: int, world: int, payload: dict) -> dict:
    """A rank's ``more_cases`` over the world's dp mesh (the mixture's
    checkpoint directory is shared: rank 0 writes it)."""
    from induction_network_on_fewrel_tpu_torch.parallel.mesh import make_mesh

    return more_cases(payload, make_mesh(dp=world))


# --- MoE across ranks: routing over the global batch, and the ep executor ----------

# The (dp, ep) layouts a world of each size runs, in turn.
MOE_LAYOUTS = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}
# The step after which the parameters are held to one process at the dp bar.
MOE_DP_AT = 3


def layout_name(dp: int, ep: int) -> str:
    return f"dp{dp}_ep{ep}"


def local_token_rows(batch, mesh) -> tuple:
    """This dp rank's episodes of a global (support, query, label) token
    batch (the ranks of one ep group hold the same ones)."""
    if mesh is None:
        return batch
    from induction_network_on_fewrel_tpu_torch.parallel.hostfeed import local_episode_range

    lo, n = local_episode_range(mesh, len(batch[2]))
    return tuple(_rows_of(x, lo, n) for x in batch)


def moe_parts(cfg, weights, mesh, device):
    """(model, opt, dp) of an MoE case: the given full weights (None: the
    seed's), the MoE layers on ``mesh`` (its experts sliced at ep > 1)
    before the optimizer, and its ``DataParallel``."""
    from induction_network_on_fewrel_tpu_torch.models.build import build_model
    from induction_network_on_fewrel_tpu_torch.parallel.expert import attach_experts
    from induction_network_on_fewrel_tpu_torch.parallel.sharding import DataParallel
    from induction_network_on_fewrel_tpu_torch.train.steps import make_optimizer

    model = build_model(cfg, device=device)
    if weights is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()})
    if mesh is not None:
        attach_experts(model, mesh)
    opt = make_optimizer(cfg, model)
    return model, opt, (DataParallel(model, opt, cfg, mesh) if mesh is not None else None)


def full_numpy(model, opt) -> tuple[dict, dict]:
    """(parameters, moments) in the JAX layout (the experts gathered over
    ep: a collective), as numpy copies."""
    from induction_network_on_fewrel_tpu_torch.parallel.expert import full_state_dict

    params = {k: np.array(v.detach().float().cpu()) for k, v in full_state_dict(model).items()}
    state = opt.state_dict()
    moments = {f"{kind}/{n}": np.array(x.float().cpu()) for kind in ("mu", "nu")
               for n, x in zip(opt.names, state[kind]) if x is not None}
    return params, moments


def run_moe_case(payload: dict, variant: str, mesh, save_dir: str | None = None) -> dict:
    """One MoE variant (``payload["variants"][variant]``, config keywords)
    under ``mesh`` (None: one process on the global batches) from the
    payload's weights: at the first batch the forward's logits (this rank's
    rows), the load-balance terms' sum and each layer's dropped share, and
    the objective's gradients (averaged over dp, the experts gathered);
    then one training step a batch: losses, gradient norms and dropped
    shares per step, the parameters after ``MOE_DP_AT`` steps and at the
    end, the moments, and under a mesh the collectives each step issued
    beside the plan. ``save_dir``: the end state saved there as a ring slot
    (the trainer's save: every expert, gathered)."""
    from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
    from induction_network_on_fewrel_tpu_torch.models.moe import collect_aux, moe_layers
    from induction_network_on_fewrel_tpu_torch.parallel.expert import FullModel, is_expert_leaf
    from induction_network_on_fewrel_tpu_torch.parallel.grad_buckets import COLLECTIVES
    from induction_network_on_fewrel_tpu_torch.train.framework import SavedOptimizer
    from induction_network_on_fewrel_tpu_torch.models.losses import LOSS_FNS
    from induction_network_on_fewrel_tpu_torch.train.steps import (
        _backward,
        _inputs_on,
        aux_weight,
        make_train_step,
        train_step,
    )

    device = torch.device(payload.get("device", "cpu"))
    cfg = ExperimentConfig(**{**payload["cfg"], **payload["variants"][variant]})
    model, opt, dp = moe_parts(cfg, payload.get("weights"), mesh, device)
    layers = moe_layers(model)
    out: dict = {}
    sup, qry, lab = _inputs_on(model, *local_token_rows(payload["batches"][0], mesh))
    opt.zero_grad()
    with collect_aux(model) as sink:
        logits = model(sup, qry)
    aux = sum(sink)
    loss = LOSS_FNS[cfg.loss](logits, lab) + aux_weight(cfg) * aux
    _backward(loss, dp)
    em = layers[0].dist if layers else None
    grads = {}
    for n, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if em is not None and em.ep > 1 and is_expert_leaf(n):
            g = em.gather_experts(g, "ep/experts_allgather")
        grads[n] = np.array(g.float().cpu())
    opt.zero_grad()
    out.update(logits=logits.detach().float().cpu().numpy(), aux=float(aux.detach()),
               drops0=[float(m.drop_share) for m in layers], grads=grads)
    # Eager on every device, as the gloo ranks step (the card's graph
    # steps are held to eager ones elsewhere).
    step = (make_train_step(model, opt, cfg, dp=dp) if dp is not None else
            functools.partial(train_step, model, opt, cfg))
    losses, norms, drops = [], [], []
    issued: collections.Counter = collections.Counter()
    t0 = time.monotonic()
    for i, batch in enumerate(payload["batches"]):
        before = collections.Counter(COLLECTIVES)
        m = step(*local_token_rows(batch, mesh))
        issued += COLLECTIVES - before
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        drops.append([float(layer.drop_share) for layer in layers])
        if i + 1 == MOE_DP_AT:
            out["params_at"] = full_numpy(model, opt)[0]
    out["seconds"] = time.monotonic() - t0
    out["params"], out["moments"] = full_numpy(model, opt)
    out.update(losses=losses, grad_norms=norms, drops=drops)
    if dp is not None:
        out["plan"] = dp.plan()
        out["issued_per_step"] = {k: n / len(losses) for k, n in issued.items()}
    if save_dir is not None:
        from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager

        saved = (FullModel(model), SavedOptimizer(opt.state_dict()))
        if mesh is None or mesh.main:
            mgr = CheckpointManager(save_dir, cfg.replace(ckpt_delta="off"))
            mgr.save_latest(len(losses), *saved)
            mgr.close()
        if dp is not None:
            dp.barrier()
    return out


def restore_moe(payload: dict, variant: str, mesh, src: str) -> dict:
    """A ring slot of ``src`` restored under ``mesh`` (None: one process):
    the parameters and moments, gathered whole again."""
    from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager

    device = torch.device(payload.get("device", "cpu"))
    cfg = ExperimentConfig(**{**payload["cfg"], **payload["variants"][variant]})
    model, opt, _ = moe_parts(cfg, None, mesh, device)
    step, _ = CheckpointManager(src, cfg).restore_latest(model, opt)
    params, moments = full_numpy(model, opt)
    return {"step": step, "params": params, "moments": moments}


def moe_cli(argv: list, train_argv: list, mesh, save_dir: str) -> dict:
    """``cli.main train`` (``argv`` and ``train_argv``) then ``test``
    (``argv``) under ``mesh``'s layout (``--dp``/``--ep``): each one's exit
    code and, on rank 0, its result line."""
    import contextlib
    import io
    import json as json_mod

    from induction_network_on_fewrel_tpu_torch import cli

    flags = ["--dp", str(mesh.dp), "--ep", str(mesh.ep)]
    out = {}
    for mode, extra in (("train", [*train_argv, "--save_ckpt", save_dir]),
                        ("test", ["--load_ckpt", save_dir])):
        buf, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = cli.main([mode, *argv, *flags, *extra])
        lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
        out[mode] = {"rc": rc, "result": json_mod.loads(lines[-1]) if lines else None,
                     "stderr": err.getvalue()[-2000:]}
    return out


def moe_test_reference(argv: list, ckpt: str, dp: int) -> dict:
    """One process's ``test`` of ``ckpt`` on the episodes ``dp`` ranks draw
    under ``cli.test_main`` (each rank's stream from its ``process_seed``,
    its ``B/dp`` episodes a batch), each global batch their rows in rank
    order: the metrics ``evaluate`` reports."""
    from induction_network_on_fewrel_tpu_torch import cli
    from induction_network_on_fewrel_tpu_torch.models.build import (
        batch_to_model_inputs,
        build_model,
    )
    from induction_network_on_fewrel_tpu_torch.parallel.hostfeed import process_seed
    from induction_network_on_fewrel_tpu_torch.sampling.native import make_sampler
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager
    from induction_network_on_fewrel_tpu_torch.train.framework import FewShotTrainer

    args = cli.parse_args(False, [*argv, "--load_ckpt", ckpt])
    cfg = cli._merge_ckpt_architecture(cli.config_from_args(args), ckpt)
    tok, cfg, vectors = cli.make_tokenizer(args, cfg)
    model = build_model(cfg, glove_init=vectors, device=args.device)
    mngr = CheckpointManager(ckpt)
    mngr.restore("best" if mngr.has("best") else "latest", model)
    ds = cli.load_data(cfg, "test", args)
    samplers = [make_sampler(ds, tok, cfg.n, cfg.k, cfg.q, batch_size=cfg.batch_size // dp,
                             na_rate=cfg.na_rate, seed=process_seed(cfg.seed + 2, r),
                             backend=cfg.sampler, eval=True) for r in range(dp)]
    batches = []
    for _ in range(max(1, cfg.test_iter // cfg.batch_size)):
        parts = [batch_to_model_inputs(s.sample_batch()) for s in samplers]
        batches.append(tuple(
            {k: np.concatenate([p[j][k] for p in parts]) for k in parts[0][j]} if j < 2
            else np.concatenate([p[j] for p in parts]) for j in range(3)))
    trainer = FewShotTrainer(model, cfg, None)
    return trainer.evaluate(cfg.test_iter, sampler=FixedBatches(batches, cfg.batch_size),
                            return_metrics=True)


class FixedBatches:
    """Given (support, query, label) batches as a sampler of ``batch_size``
    episodes."""

    def __init__(self, batches: list, batch_size: int):
        self.batches, self.batch_size = batches, batch_size

    def __iter__(self):
        return iter(self.batches)


def moe_cases(payload: dict, mesh_of, restores: tuple = ()) -> dict:
    """Every layout of ``payload["layouts"]`` ((dp, ep) pairs; a mesh each
    from ``mesh_of``) on every variant, in turn; ``payload["saves"]``
    {layout: directory} saves that layout's end state of the first
    variant; ``payload["cli"]`` {layout: (argv, train argv, directory)}
    runs the train and test CLI under it. Then each (dp, ep, directory) of ``restores``
    restores that ring slot under its own layout ("restored/<layout>")."""
    out: dict = {}
    first = next(iter(payload["variants"]))
    for dp, ep in payload["layouts"]:
        name = layout_name(dp, ep)
        mesh = mesh_of(dp, ep)
        res = out[name] = {v: run_moe_case(payload, v, mesh,
                                           payload.get("saves", {}).get(name) if v == first
                                           else None)
                           for v in payload["variants"]}
        if name in payload.get("cli", {}):
            res["cli"] = moe_cli(*payload["cli"][name][:2], mesh, payload["cli"][name][2])
    for dp, ep, src in restores:
        out[f"restored/{layout_name(dp, ep)}"] = restore_moe(payload, first, mesh_of(dp, ep), src)
    return out


def dp_moe_cases(rank: int, world: int, payload: dict) -> dict:
    """A rank's ``moe_cases`` over the layouts of its world size."""
    from induction_network_on_fewrel_tpu_torch.parallel.mesh import make_mesh

    return moe_cases({**payload, "layouts": MOE_LAYOUTS[world]},
                     lambda dp, ep: make_mesh(dp=dp, ep=ep),
                     payload.get("restores", {}).get(world, ()))
