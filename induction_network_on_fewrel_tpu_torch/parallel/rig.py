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
episodes the dp ranks draw.

``dp_ts_cases`` runs the same cases under (dp, tp, sp) layouts
(``TS_LAYOUTS``) and ``dp_pp_cases`` under (dp, pp, tp) layouts
(``PP_LAYOUTS``): the GPipe executor over the layer-stacked transformer,
its encoder alone against the sequential loop (``pipe_encoder``), the
token-cache lazy step, the train and test CLI (``--resume`` too) and
checkpoints across pp.
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
    """The model's parameters in the JAX layout (every sharded leaf whole:
    a collective under ep or tp), as numpy copies."""
    from induction_network_on_fewrel_tpu_torch.parallel.expert import full_state_dict

    return {k: v.detach().float().cpu().numpy() for k, v in full_state_dict(model).items()}


def build_case(payload: dict, overrides: dict, mesh, device):
    """(cfg, model, opt, lazy, table, dp) of one case: the payload's weights
    (or the seed's), the model's sharded parts on the mesh
    (``attach_parallel``), the lazy table over the token cache, and the
    case's ``DataParallel`` under a mesh."""
    from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
    from induction_network_on_fewrel_tpu_torch.models.build import build_model
    from induction_network_on_fewrel_tpu_torch.parallel.sharding import (
        DataParallel,
        attach_parallel,
    )
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
    if mesh is not None:
        attach_parallel(model, mesh)
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
    state is materialized after that many steps and, on the world's rank
    0, saved to ``ckpt_dir`` as a recovery-ring slot (the trainer's save:
    every sharded leaf and moment gathered); with ``payload["state_at"]``
    the parameters and moments after that many steps are kept too
    ("params_at", "moments_at"); "seconds" leaves both out."""
    from induction_network_on_fewrel_tpu_torch.parallel.expert import FullModel
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

    def state() -> tuple[dict, dict]:
        """(parameters, moments) as numpy copies, the lazy table
        materialized, every sharded leaf gathered (collectives under a
        mesh)."""
        lazy.materialize(opt.count)
        full = opt.state_dict()
        moments = {f"{kind}/{n}": x.float().cpu().numpy() for kind in ("mu", "nu")
                   for n, x in zip(opt.names, full[kind]) if x is not None}
        moments["lazy/rows_m"] = lazy.rows_m.cpu().numpy().copy()
        moments["lazy/rows_v"] = lazy.rows_v.cpu().numpy().copy()
        return {k: v.copy() for k, v in numpy_state(model).items()}, moments

    t0 = time.monotonic()
    for i, batch in enumerate(payload["batches"]):
        if i == payload.get("state_at"):
            t_state = time.monotonic()
            out["params_at"], out["moments_at"] = state()
            t0 += time.monotonic() - t_state
        if resume_at is not None and i == resume_at:
            t_save = time.monotonic()
            lazy.materialize(opt.count)
            saved = SavedOptimizer(opt.state_dict())
            whole = FullModel(model) if mesh is not None else model     # every rank gathers
            if mesh is None or mesh.main:
                mgr = CheckpointManager(ckpt_dir, cfg.replace(ckpt_delta="off"))
                mgr.save_latest(i, whole, saved, lazy=lazy)
                mgr.close()
            if dp is not None:
                dp.barrier()
            t0 += time.monotonic() - t_save
        before = collections.Counter(COLLECTIVES)
        m = step(*local_rows(batch, mesh))
        issued += COLLECTIVES - before
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out["seconds"] = time.monotonic() - t0
    params, moments = state()
    out.update(losses=losses, grad_norms=norms, params=params, moments=moments,
               local_shapes={n: tuple(p.shape) for n, p in model.named_parameters()},
               local_moment_shapes={n: tuple(x.shape) for n, x in zip(opt.names, opt.mu)
                                    if x is not None})
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
    """(model, opt, dp) of a case: the given full weights (None: the
    seed's), the model's sharded parts on ``mesh`` (experts sliced at ep >
    1, tp's slices, the sp encoder: ``attach_parallel``) before the
    optimizer, and its ``DataParallel``."""
    from induction_network_on_fewrel_tpu_torch.models.build import build_model
    from induction_network_on_fewrel_tpu_torch.parallel.sharding import (
        DataParallel,
        attach_parallel,
    )
    from induction_network_on_fewrel_tpu_torch.train.steps import make_optimizer

    model = build_model(cfg, device=device)
    if weights is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()})
    if mesh is not None:
        attach_parallel(model, mesh)
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


def _variant(payload: dict, variant: str, key: str):
    """The payload's ``key`` for ``variant`` ("variant_<key>" maps one per
    variant), else the shared one."""
    return payload.get(f"variant_{key}", {}).get(variant, payload.get(key))


def run_moe_case(payload: dict, variant: str, mesh, save_dir: str | None = None) -> dict:
    """One variant (``payload["variants"][variant]``, config keywords: MoE
    or any other model) under ``mesh`` (None: one process on the global
    batches) from the payload's weights: at the first batch the forward's
    logits (this rank's rows), the load-balance terms' sum and each MoE
    layer's dropped share, the objective's gradients (averaged over dp, the
    experts and the tp slices gathered) and the eval metrics;
    then one training step a batch: losses, gradient norms and dropped
    shares per step, the parameters after ``MOE_DP_AT`` steps and at the
    end, the moments, and under a mesh the collectives each step issued
    beside the plan. ``payload["eval_only"]``: the first batch's logits
    and eval metrics alone, without a gradient. ``save_dir``: the end state
    saved there as a ring slot (the trainer's save: every sharded leaf,
    gathered)."""
    from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
    from induction_network_on_fewrel_tpu_torch.models.moe import collect_aux, moe_layers
    from induction_network_on_fewrel_tpu_torch.parallel.expert import FullModel, is_expert_leaf
    from induction_network_on_fewrel_tpu_torch.parallel.grad_buckets import COLLECTIVES
    from induction_network_on_fewrel_tpu_torch.train.framework import SavedOptimizer
    from induction_network_on_fewrel_tpu_torch.models.losses import LOSS_FNS
    from induction_network_on_fewrel_tpu_torch.parallel.pipeline import pp_leaves
    from induction_network_on_fewrel_tpu_torch.parallel.tensor import tp_leaves
    from induction_network_on_fewrel_tpu_torch.train.steps import (
        _backward,
        _inputs_on,
        aux_weight,
        eval_step,
        make_train_step,
        train_step,
    )

    device = torch.device(payload.get("device", "cpu"))
    cfg = ExperimentConfig(**{**payload["cfg"], **payload["variants"][variant]})
    model, opt, dp = moe_parts(cfg, _variant(payload, variant, "weights"), mesh, device)
    batches = _variant(payload, variant, "batches")
    layers = moe_layers(model)
    out: dict = {}
    sup, qry, lab = _inputs_on(model, *local_token_rows(batches[0], mesh))
    if payload.get("eval_only"):
        t0 = time.monotonic()
        with torch.inference_mode():
            logits = model(sup, qry)
            out["eval"] = {k: float(v) for k, v in eval_step(model, cfg, sup, qry, lab).items()}
        out.update(logits=logits.float().cpu().numpy(), seconds=time.monotonic() - t0)
        return out
    opt.zero_grad()
    with collect_aux(model) as sink:
        logits = model(sup, qry)
    aux = sum(sink) if sink else torch.zeros(())
    loss = LOSS_FNS[cfg.loss](logits, lab) + aux_weight(cfg) * aux
    _backward(loss, dp)
    em = layers[0].dist if layers else None
    split = {n: (axis, m, kind) for kind, leaves in (("tp", tp_leaves(model)),
                                                     ("pp", pp_leaves(model)))
             for n, axis, m in leaves}
    grads = {}
    for n, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if em is not None and em.ep > 1 and is_expert_leaf(n):
            g = em.gather_experts(g, "ep/experts_allgather")
        if n in split:
            axis, m, kind = split[n]
            g = m.gather(g, axis, f"{kind}/params_allgather")
        grads[n] = np.array(g.float().cpu())
    opt.zero_grad()
    out.update(logits=logits.detach().float().cpu().numpy(), aux=float(aux.detach()),
               drops0=[float(m.drop_share) for m in layers], grads=grads,
               eval={k: float(v) for k, v in eval_step(model, cfg, sup, qry, lab).items()})
    # Eager on every device, as the gloo ranks step (the card's graph
    # steps are held to eager ones elsewhere).
    step = (make_train_step(model, opt, cfg, dp=dp) if dp is not None else
            functools.partial(train_step, model, opt, cfg))
    losses, norms, drops, digests = [], [], [], []
    issued: collections.Counter = collections.Counter()
    t0 = time.monotonic()
    for i, batch in enumerate(batches):
        before = collections.Counter(COLLECTIVES)
        m = step(*local_token_rows(batch, mesh))
        issued += COLLECTIVES - before
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        drops.append([float(layer.drop_share) for layer in layers])
        if payload.get("step_digests"):
            digests.append(replicated_digest(model))
        if i + 1 == MOE_DP_AT:
            out["params_at"] = full_numpy(model, opt)[0]
    out["seconds"] = time.monotonic() - t0
    out["step_digests"] = digests
    out["local_shapes"] = {n: tuple(p.shape) for n, p in model.named_parameters()}
    out["local_moment_shapes"] = {n: tuple(x.shape) for n, x in zip(opt.names, opt.mu)
                                  if x is not None}
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


def replicated_digest(model) -> str:
    """A digest of this rank's replicated leaves (every leaf but the ep-,
    tp- and pp-sharded ones): equal on every rank of a world."""
    import hashlib

    from induction_network_on_fewrel_tpu_torch.parallel.expert import is_expert_leaf
    from induction_network_on_fewrel_tpu_torch.parallel.pipeline import pp_leaves
    from induction_network_on_fewrel_tpu_torch.parallel.tensor import tp_leaves

    sharded = {n for n, *_ in tp_leaves(model)} | {n for n, *_ in pp_leaves(model)}
    h = hashlib.sha256()
    for n, p in model.named_parameters():
        if n not in sharded and not is_expert_leaf(n):
            h.update(n.encode())
            h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def restore_moe(payload: dict, variant: str, mesh, src: str) -> dict:
    """A ring slot of ``src`` restored under ``mesh`` (None: one process):
    the parameters and moments, gathered whole again."""
    from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
    from induction_network_on_fewrel_tpu_torch.parallel.sharding import DataParallel
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager

    device = torch.device(payload.get("device", "cpu"))
    cfg = ExperimentConfig(**{**payload["cfg"], **payload["variants"][variant]})
    model, opt, _ = moe_parts(cfg, None, mesh, device)
    if mesh is not None:
        DataParallel(model, opt, cfg, mesh)        # the optimizer's sharded leaves
    step, _ = CheckpointManager(src, cfg).restore_latest(model, opt)
    params, moments = full_numpy(model, opt)
    return {"step": step, "params": params, "moments": moments}


def cli_under(mode: str, argv: list, mesh) -> dict:
    """``cli.main([mode, *argv])`` under ``mesh``'s layout (``--dp``,
    ``--ep``, ``--tp``, ``--sp``, ``--pp``): its exit code, on rank 0 its result line,
    and the end of its stderr."""
    import contextlib
    import io
    import json as json_mod

    from induction_network_on_fewrel_tpu_torch import cli

    flags = ["--dp", str(mesh.dp), "--ep", str(mesh.ep), "--tp", str(mesh.tp), "--sp",
             str(mesh.sp), "--pp", str(mesh.pp)]
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = cli.main([mode, *argv, *flags])
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    return {"rc": rc, "result": json_mod.loads(lines[-1]) if lines else None,
            "stderr": err.getvalue()[-2000:]}


def moe_cli(argv: list, train_argv: list, mesh, save_dir: str) -> dict:
    """``cli.main train`` (``argv`` and ``train_argv``) then ``test``
    (``argv``) under ``mesh``'s layout (``cli_under``)."""
    return {"train": cli_under("train", [*argv, *train_argv, "--save_ckpt", save_dir], mesh),
            "test": cli_under("test", [*argv, "--load_ckpt", save_dir], mesh)}


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


# --- tensor and sequence parallel ------------------------------------------------

# The (dp, tp, sp) layouts a world of each size runs, in turn.
TS_LAYOUTS = {2: ((1, 2, 1), (1, 1, 2)), 4: ((2, 2, 1), (2, 1, 2), (1, 2, 2), (1, 1, 4))}


def ts_name(dp: int, tp: int, sp: int) -> str:
    return f"dp{dp}_tp{tp}_sp{sp}"


def ts_cases(payload: dict, mesh_of, restores: tuple = (), name_of=ts_name) -> dict:
    """Every (variant, (dp, tp, sp)) of ``payload["cases"]`` under a mesh
    from ``mesh_of``, in turn (``run_moe_case``: forward, gradients, eval
    metrics, steps); ``payload["saves"]`` {(variant, layout): directory}
    saves that case's end state; ``payload["cli"]`` {layout: (argv, train
    argv, directory)} runs the train and test CLI under it;
    ``payload["cli_paths"]`` [(name, (dp, tp, sp), argv)] runs ``cli train``
    under that layout, in order ("cli_path/<name>/<layout>"), then
    ``payload["cli_tests"]`` the same way ``cli test`` ("cli_test/...");
    ``payload["lazy_cases"]`` [(name, (dp, tp, sp)[, spelling])] runs the
    token-cache lazy step (``run_cases`` on ``payload["lazy"][name]``, in
    that ``CASES`` spelling, default "compact") under that layout
    ("lazy/<name>/<layout>"). Then each
    (variant, dp, tp, sp, directory) of ``restores`` restores that ring slot
    under its layout ("restored/<variant>/<layout>"). ``name_of`` names a
    layout (``pp_name`` for the (dp, pp, tp) layouts of ``pp_cases``)."""
    out: dict = {}
    meshes: dict = {}
    for name, lay, *spelling in payload.get("lazy_cases", ()):
        case = spelling[0] if spelling else "compact"
        if lay not in meshes:
            meshes[lay] = mesh_of(*lay)
        out[f"lazy/{name}/{name_of(*lay)}"] = run_cases(
            {**payload["lazy"][name], "cases": [case]}, meshes[lay])[case]
    for variant, lay in payload["cases"]:
        if lay not in meshes:
            meshes[lay] = mesh_of(*lay)
        name = name_of(*lay)
        out.setdefault(name, {})[variant] = run_moe_case(
            payload, variant, meshes[lay], payload.get("saves", {}).get((variant, name)))
    for name, (argv, train_argv, d) in payload.get("cli", {}).items():
        lay = tuple(int(x[2:]) for x in name.split("_"))
        if lay not in meshes:
            meshes[lay] = mesh_of(*lay)
        out.setdefault(name, {})["cli"] = moe_cli(argv, train_argv, meshes[lay], d)
    for mode in ("train", "test"):
        for path, lay, argv in payload.get("cli_paths" if mode == "train" else "cli_tests", ()):
            if lay not in meshes:
                meshes[lay] = mesh_of(*lay)
            out[f"cli_{'path' if mode == 'train' else 'test'}/{path}/{name_of(*lay)}"] = \
                cli_under(mode, argv, meshes[lay])
    for variant, *lay, src in restores:
        lay = tuple(lay)
        if lay not in meshes:
            meshes[lay] = mesh_of(*lay)
        out[f"restored/{variant}/{name_of(*lay)}"] = restore_moe(payload, variant, meshes[lay],
                                                                 src)
    return out


def dp_ts_cases(rank: int, world: int, payload: dict) -> dict:
    """A rank's ``ts_cases`` over the cases of its world size
    (``payload["worlds"][world]``: that world's payload keys)."""
    from induction_network_on_fewrel_tpu_torch.parallel.mesh import make_mesh

    mine = {**payload, **payload["worlds"][world]}
    return ts_cases(mine, lambda dp, tp, sp: make_mesh(dp=dp, tp=tp, sp=sp),
                    mine.get("restores", ()))


# --- pipeline parallel ------------------------------------------------------------

# The (dp, pp, tp) layouts a world of each size runs, in turn.
PP_LAYOUTS = {2: ((1, 2, 1),), 4: ((2, 2, 1), (1, 2, 2), (1, 4, 1))}


def pp_name(dp: int, pp: int, tp: int) -> str:
    return f"dp{dp}_pp{pp}_tp{tp}"


def pipe_encoder(payload: dict, mesh) -> dict:
    """The layer-stacked encoder alone (``payload["encoder"]``'s widths,
    ``payload["weights"]`` loaded whole) on ``mesh``'s pp axis (None: the
    loop), at each microbatch count of ``payload["microbatches"]``: the
    forward of ``payload["emb"]`` and ``payload["mask"]``, the same forward
    without a gradient, and the gradients of ``Σ out ⊙ R`` for the input and
    every leaf (the stack leaves gathered whole)."""
    from induction_network_on_fewrel_tpu_torch.models.pipeline_transformer import (
        PipelinedTransformerEncoder,
    )
    from induction_network_on_fewrel_tpu_torch.parallel.pipeline import (
        attach_pipeline,
        pp_leaves,
    )

    out = {}
    mask = torch.as_tensor(payload["mask"])
    for m in payload["microbatches"]:
        holder = torch.nn.Module()
        holder.encoder = PipelinedTransformerEncoder(
            **payload["encoder"], microbatches=m, device="cpu",
            generator=torch.Generator().manual_seed(0))
        if mesh is not None:
            attach_pipeline(holder, mesh)
        holder.load_state_dict({f"encoder.{k}": torch.as_tensor(v)
                                for k, v in payload["weights"].items()})
        x = torch.tensor(payload["emb"], requires_grad=True)
        y = holder.encoder(x, mask)
        (y * torch.as_tensor(payload["R"])).sum().backward()
        grads = {n: p.grad for n, p in holder.named_parameters()}
        for n, axis, stage in pp_leaves(holder):
            grads[n] = stage.gather(grads[n], axis, "pp/params_allgather")
        with torch.no_grad():
            y_eval = holder.encoder(x.detach(), mask)
        out[m] = {"out": y.detach().numpy(), "eval": y_eval.numpy(), "x_grad": x.grad.numpy(),
                  "grads": {n.removeprefix("encoder."): g.numpy() for n, g in grads.items()},
                  "local_shapes": {n: tuple(p.shape) for n, p in holder.named_parameters()}}
    return out


def pp_cases(payload: dict, mesh_of, restores: tuple = ()) -> dict:
    """``ts_cases`` over (dp, pp, tp) layouts (``pp_name``), and, when
    ``payload["encoder_pp"]`` is this world's pp, the encoder alone
    (``pipe_encoder``, "encoder") on a (dp=1, pp) mesh."""
    out = {}
    if payload.get("encoder_pp"):
        out["encoder"] = pipe_encoder(payload["encoder_case"],
                                      mesh_of(1, payload["encoder_pp"], 1))
    out.update(ts_cases(payload, mesh_of, restores, name_of=pp_name))
    return out


def dp_pp_cases(rank: int, world: int, payload: dict) -> dict:
    """A rank's ``pp_cases`` over the cases of its world size
    (``payload["worlds"][world]``: that world's payload keys)."""
    from induction_network_on_fewrel_tpu_torch.parallel.mesh import make_mesh

    mine = {**payload, **payload["worlds"][world]}
    return pp_cases(mine, lambda dp, pp, tp: make_mesh(dp=dp, pp=pp, tp=tp),
                    mine.get("restores", ()))


def ring_ranks(rank: int, world: int, payload: dict) -> dict:
    """A rank of an sp ring of ``world`` ranks: ``RingAttention`` on its
    token block of ``payload``'s q, k, v [B, H, L, hd] and key mask [B, L],
    and the gradients of the output's sum weighted by ``payload["w"]``:
    the output block and the q, k, v gradient blocks."""
    from induction_network_on_fewrel_tpu_torch.parallel.mesh import make_mesh
    from induction_network_on_fewrel_tpu_torch.parallel.ring import RingAttention, SequenceShard

    shard = SequenceShard(make_mesh(dp=1, sp=world))
    mask = torch.as_tensor(shard.columns(payload["mask"]))
    lo, n = shard.offset, mask.shape[-1]
    q, k, v = (torch.tensor(x[:, :, lo:lo + n]).requires_grad_() for x in payload["qkv"])
    out = RingAttention.apply(q, k, v, mask, shard)
    (out * torch.as_tensor(payload["w"][:, :, lo:lo + n])).sum().backward()
    return {"out": out.detach().numpy(), "grads": [x.grad.numpy() for x in (q, k, v)]}
