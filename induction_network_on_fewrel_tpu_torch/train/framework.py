"""FewShotTrainer: the episode-loop training framework.

Counterpart of ``induction_network_on_fewrel_tpu/train/framework.py``
(``FewShotTrainer.train``/``evaluate``, framework.py:266-330, 380-470,
539-622, 725-729) for the single-device path: sample host batches -> one
dispatch of ``steps_per_call`` training steps (on the card one CUDA-graph
replay, ``train/steps.py``; when fewer steps are left they run one at a
time) -> a ``[train]`` record of the window's mean metrics every
``metric_window`` steps (default max(50, metric_window_calls *
steps_per_call); each record syncs the card) and at the end -> every
``grad_probe_every`` steps a ``health`` record (event "grad_probe": the
gradient's norm and its cosine to an all-f32 plain reference,
``make_grad_probe``) -> validation every ``val_step`` steps, logged as
``[val]`` with ``acc_ci95`` (its time, the probe's and the saves', kept
out of ``episodes_per_s``) -> a best save on improvement and a
recovery-ring save at every val boundary (a ``ckpt`` record: full, base
or delta and its bytes) and at the end. A fused call may not skip a val
boundary: ``steps_per_call > val_step`` with a val sampler is refused.
Training episodes are ``train_n``-way, val and test ``n``-way (each shape
its own graph).

With ``embed_optimizer="lazy"`` the trainer owns the lazy word table
(``train/lazy_embed.LazyTable``) and materializes it (every row caught up,
in place) before each val pass, each save and at the end. With
``token_cache`` the samplers draw index episodes and the steps gather
from the splits' device tables (``train_table``/``val_table``;
``evaluate(source=...)`` for a test table).

The divergence guard: once the best val accuracy clears twice the
random-guess floor (capped at the floor/1.0 midpoint), a val accuracy
under half the best logs a ``divergence`` record; with
``divergence_guard="stop"`` the best checkpoint is restored, the ring
slots newer than it are purged, and the run ends. ``fault_step`` raises
before the val boundary once the step counter reaches it, on a fresh run
only (``start_step == 0``), so the ring holds the state a crash leaves.

Each dispatch's metrics are copies of the graph's static outputs, so the
window keeps one tensor per dispatch, not a reference to a buffer the next
replay overwrites.

FewRel 2.0 adversarial adaptation (``adv``, an ``AdvPieces``): each step
is the DANN step (``train/steps.make_adv_train_step``) on an episode batch
and one unlabeled source and one target instance batch. A fused call draws
S episode batches, then S source batches, then S target batches (the JAX
draw order, framework.py:421-470; never a fused sampler unit). The
discriminator stays out of every checkpoint and the instance samplers'
streams out of the saved sampler states: a resumed run starts both fresh
from their seeds, as the JAX trainer does.

``evaluate`` scores ``eval_steps_per_call`` batches per dispatch (0 =
min(steps_per_call, 16)); a short tail repeats its last batch and drops
the repeated results, and fewer than a width/8 batches run one at a time.
It returns the mean episode accuracy, or with ``return_metrics`` the full
dict: accuracy, ``acc_ci95`` (±1.96·σ/√n over per-batch accuracies) and,
with NOTA, its precision and recall aggregated exactly from the per-batch
fractions.

Telemetry (the JAX ``train/framework.py:106-115, 362-365, 395-580``):
each loop iteration runs under a fresh trace context, its phases as
spans (``train/sample``, ``train/dispatch``, ``train/metrics_fetch``,
``train/grad_probe``, ``train/eval``, ``train/checkpoint``; NVTX ranges on
the card, ``obs/spans.py``). ``recorder`` (a FlightRecorder) and
``watchdog`` (a HealthWatchdog) hook the logger in that order, so a
critical event's dump holds the record that tripped it, and the loop runs
under ``recorder.armed("train crash")``. ``perf`` (a PerfObserver) closes
a ``kind="perf"`` window at each metric record; ``compile_watcher`` (a
CompileWatcher) is stamped with each step and armed after the first
window. A BiLSTM run logs a ``kind="roofline"`` record per window
(``utils/roofline.step_bytes``). ``profile_dir`` traces the calls over
steps [start+1, start+1+profile_steps) with ``torch.profiler`` into
``profile_dir/trace.json`` and logs a ``kind="profile"`` record.
``cfg.nan_inject_step`` sets the logged loss of the window holding that
step to NaN (the training state is untouched). ``debug_nans`` builds the
steps with the device-side ``finite`` metric and raises
``FloatingPointError`` after the call that holds the first bad step
(``utils/debug.py``). The trainer owns the perf observer and the watcher
once passed (``close()`` releases them). Saves go through the manager's
saver thread (staging per ``cfg.ckpt_stage``): a save
snapshots the state on the card and returns, and ``train`` waits for
every save to be durable before it returns.

Data parallel (``mesh``, a ``parallel/mesh.Mesh`` with a live group):
each rank trains on its own ``B/dp`` episodes (its samplers report the
global batch, ``parallel/hostfeed.PerRankSampler``), the step averages
the gradients over the ranks (``parallel/sharding.DataParallel``; ZeRO-1
under ``zero_opt``), and the eval metrics of each batch are averaged over
them. Only rank 0 holds a ``CheckpointManager`` and writes; every rank
takes part in a save (``snapshot``: the full moments and every rank's
streams gathered) and reads the directory for a restore (``reader``,
after ``sync_saves``). Under ``adv`` the discriminator's gradients are
averaged too, and each rank's instance samplers draw its ``M/dp`` rows
(``cli.adv_pieces``). The live lazy path is refused there.

``train(num_iters, start_step)`` numbers steps from ``start_step``;
``sampler_states``/``restore_sampler_states`` carry the samplers' streams
through every checkpoint, so a resumed run continues the episode stream of
the run it resumes.

The host feed (``datapipe/producer.PipelineFeed``, recognized by its
``cursor_state``): the trainer gives it its logger, draws whole fused
units from it (``sample_fused``) where it has them, logs one
``kind="data"`` record of ``drain_stats()`` per metric window (just before
that window's ``[train]`` record), saves its ``PipelineCursor`` as the
train stream's state (the val sampler's ``feed_state`` beside it) and
closes it, joining its producer thread, in ``close()``. A checkpoint
written before the feed holds the numpy samplers' ``bit_generator``
states; those still restore into numpy samplers.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.datapipe.cursor import (
    PipelineCursor,
    capture_sampler_state,
    restore_sampler_state,
)
from induction_network_on_fewrel_tpu_torch.models.build import (
    batch_to_model_inputs,
    instance_inputs,
)
from induction_network_on_fewrel_tpu_torch.obs.spans import get_tracker, span
from induction_network_on_fewrel_tpu_torch.sampling.episodes import EpisodeBatch
from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager
from induction_network_on_fewrel_tpu_torch.train.steps import (
    DiscState,
    make_adv_multi_train_step,
    make_adv_train_step,
    make_eval_step,
    make_grad_probe,
    make_multi_eval_step,
    make_multi_train_step,
    make_optimizer,
    make_train_step,
)
from induction_network_on_fewrel_tpu_torch.utils.debug import check_finite_steps
from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger


def stack_batches(batches):
    """[(support, query, label)] -> stacked (support_s, query_s, label_s);
    token dicts or index arrays."""
    def stack(xs):
        if isinstance(xs[0], dict):
            return {k: np.stack([x[k] for x in xs]) for k in xs[0]}
        return np.stack(xs)

    return stack([b[0] for b in batches]), stack([b[1] for b in batches]), \
        np.stack([b[2] for b in batches])


def batch_inputs(batch):
    """A sampler's batch, or a fused unit of them (``sample_fused``), as
    step inputs: token dicts of an EpisodeBatch, or the index arrays."""
    if isinstance(batch, EpisodeBatch):
        return batch_to_model_inputs(batch)
    return tuple(batch)


def first_batch(inputs):
    """Batch 0 of stacked step inputs."""
    return tuple({k: v[0] for k, v in x.items()} if isinstance(x, dict) else x[0]
                 for x in inputs)


@dataclasses.dataclass
class AdvPieces:
    """What the adversarial loop needs beyond the plain trainer: the
    discriminator's state (never checkpointed) and the unlabeled source and
    target instance samplers (``sampling/episodes.InstanceSampler``). Under
    a dp mesh the samplers are this rank's: ``M/dp`` instances a batch each,
    seeded by ``parallel.hostfeed.process_seed`` (``cli.adv_pieces``)."""

    disc: DiscState
    src_sampler: object
    tgt_sampler: object

    def sample(self, S: int | None = None) -> tuple:
        """(src, tgt) token dicts of one batch each, or with ``S`` S source
        batches then S target batches, each side stacked [S, M, L]."""
        if S is None:
            return (instance_inputs(self.src_sampler.sample_batch()),
                    instance_inputs(self.tgt_sampler.sample_batch()))
        srcs = [instance_inputs(self.src_sampler.sample_batch()) for _ in range(S)]
        tgts = [instance_inputs(self.tgt_sampler.sample_batch()) for _ in range(S)]
        return tuple({k: np.stack([x[k] for x in xs]) for k in xs[0]} for xs in (srcs, tgts))


class SavedOptimizer:
    """An optimizer's gathered ``state_dict`` standing in for it in a save."""

    def __init__(self, state: dict):
        self.state = state

    def state_dict(self) -> dict:
        return self.state


class FewShotTrainer:
    def __init__(self, model, cfg: ExperimentConfig, train_sampler, val_sampler=None,
                 ckpt_dir: str | None = None, logger: MetricsLogger | None = None,
                 metric_window: int | None = None, train_table=None, val_table=None,
                 adv: AdvPieces | None = None, *, profile_dir: str | None = None,
                 profile_steps: int = 10, watchdog=None, recorder=None, perf=None,
                 compile_watcher=None, debug_nans: bool = False, mesh=None):
        spc = cfg.steps_per_call
        if spc < 1:
            raise ValueError(f"steps_per_call must be >= 1, got {spc}")
        if val_sampler is not None and cfg.val_step and spc > cfg.val_step:
            # A fused call may not skip val/checkpoint boundaries: mid-chunk
            # params no longer exist to evaluate.
            raise ValueError(
                f"steps_per_call ({spc}) must not exceed "
                f"val_step ({cfg.val_step}); lower it or raise val_step"
            )
        if cfg.divergence_guard not in ("none", "stop"):
            raise ValueError(f"unknown divergence_guard {cfg.divergence_guard!r} (none | stop)")
        self.model = model
        self.cfg = cfg
        self.train_sampler = train_sampler
        self.val_sampler = val_sampler
        self.logger = logger or MetricsLogger(quiet=True)
        get_tracker().bind_device(model.device)
        # The card's name on every train record: the run report's MFU
        # reads the peak of the device the run trained on.
        self._device_name = (torch.cuda.get_device_name(model.device)
                             if model.device.type == "cuda" else model.device.type)
        self.watchdog, self.recorder = watchdog, recorder
        self._perf, self._compile_watcher = perf, compile_watcher
        # Hook order: the recorder sees each record before the watchdog,
        # whose critical events dump the recorder.
        if recorder is not None:
            self.logger.add_hook(recorder.record_metric)
        if watchdog is not None:
            watchdog.logger = watchdog.logger or self.logger
            if watchdog.recorder is None:
                watchdog.recorder = recorder
            self.logger.add_hook(watchdog.observe_record)
        self.profile_dir, self.profile_steps = profile_dir, profile_steps
        self.debug_nans = debug_nans
        self._feed = train_sampler if hasattr(train_sampler, "cursor_state") else None
        if self._feed is not None and self._feed.logger is None:
            self._feed.logger = self.logger
        if mesh is not None:
            from induction_network_on_fewrel_tpu_torch.parallel.sharding import attach_parallel

            attach_parallel(model, mesh)    # before the optimizer: ep, tp and pp keep a slice
        self.opt = make_optimizer(cfg, model)
        self.lazy = None
        if cfg.embed_optimizer == "lazy":
            from induction_network_on_fewrel_tpu_torch.train.lazy_embed import (
                LazyTable,
                live_rows,
            )

            uids = train_table.uids if train_table is not None else None
            self.lazy = LazyTable(model, self.opt.hyper, live_rows(cfg), uids=uids)
            self.opt.attach_compact(self.lazy.rows, self.lazy.rows_m, self.lazy.rows_v)
        self.dp = None
        if mesh is not None:
            from induction_network_on_fewrel_tpu_torch.parallel.sharding import DataParallel

            if self.lazy is not None and train_table is None and train_sampler is not None:
                raise ValueError("embed_optimizer=lazy under data parallel needs the token cache: "
                                 "the live path's per-batch rows differ between the ranks")
            self.dp = DataParallel(model, self.opt, cfg, mesh, self.lazy,
                                   disc=adv.disc.opt if adv is not None else None)
        # The dp index (this rank's episode streams); rank 0 of the world writes.
        self.rank = 0 if mesh is None else mesh.rank
        self.main = mesh is None or mesh.main
        self.ckpt_dir = ckpt_dir
        # Only rank 0 writes; every rank takes part in a save's collectives.
        self.ckpt = (CheckpointManager(ckpt_dir, cfg, logger=self.logger,
                                       stage=cfg.ckpt_stage) if ckpt_dir and self.main
                     else None)
        self.saved_best = False
        self.best_val = -1.0
        # Divergence-guard arming threshold (the JAX rule): twice the
        # random-guess floor 1/(N + has_nota), capped at the floor/1.0 midpoint.
        floor = 1.0 / (cfg.n + (1 if cfg.na_rate > 0 else 0))
        self.guard_arm = min(2.0 * floor, 0.5 * (1.0 + floor))
        self.metric_window = metric_window or max(50, cfg.metric_window_calls * spc)
        self.adv = adv
        if adv is not None:
            if self.lazy is not None or train_table is not None:
                raise ValueError("the adversarial step trains on live token batches: it does not "
                                 "combine with the token cache or embed_optimizer=lazy")
            self.train_step = make_adv_train_step(model, self.opt, adv.disc, cfg, debug_nans,
                                                  dp=self.dp)
            self.multi_train_step = (make_adv_multi_train_step(model, self.opt, adv.disc, cfg,
                                                               debug_nans, dp=self.dp)
                                     if spc > 1 else None)
        else:
            self.train_step = make_train_step(model, self.opt, cfg, train_table, self.lazy,
                                              debug_nans, dp=self.dp)
            self.multi_train_step = (make_multi_train_step(model, self.opt, cfg, train_table,
                                                           self.lazy, debug_nans, dp=self.dp)
                                     if spc > 1 else None)
        self.eval_spc = cfg.eval_steps_per_call or min(spc, 16)
        self._eval_steps = {}
        self.train_table, self.val_table = train_table, val_table
        self.eval_step, self.multi_eval_step = self._evals(val_table)
        if cfg.grad_probe_every > 0 and (train_table is not None or self.lazy is not None):
            raise ValueError("grad_probe_every probes the dense step on token batches: it does "
                             "not combine with the token cache or embed_optimizer=lazy")
        self.grad_probe = make_grad_probe(model, cfg) if cfg.grad_probe_every > 0 else None
        self._roofline_record = None
        if cfg.encoder == "bilstm":
            from induction_network_on_fewrel_tpu_torch.utils.roofline import (
                lstm_residual_bytes,
                step_bytes,
            )

            rows = len(train_table.uids) if self.lazy is not None and train_table is not None \
                else None
            sb = step_bytes(cfg, corpus_rows=rows)
            self._roofline_record = {
                "step_bytes": float(sb), "step_mb": round(sb / 1e6, 3),
                "lstm_residual_bytes": float(lstm_residual_bytes(cfg)),
                "lstm_cs_window": float(cfg.lstm_cs_window),
                **({"corpus_rows": float(rows)} if rows else {}),
            }

    def _evals(self, source):
        """(single, fused or None) eval steps bound to ``source`` (a token
        table, or None for token batches), made once per source."""
        key = id(source)
        if key not in self._eval_steps:
            eager = self.dp is not None and self.dp.eager
            self._eval_steps[key] = (
                make_eval_step(self.model, self.cfg, source, eager),
                make_multi_eval_step(self.model, self.cfg, source, eager)
                if self.eval_spc > 1 else None,
                source)
        return self._eval_steps[key][:2]

    def materialize(self) -> None:
        """Catch the lazy table up to the current step (no-op otherwise)."""
        if self.lazy is not None:
            self.lazy.materialize(self.opt.count)

    def train(self, num_iters: int | None = None, start_step: int = 0) -> int:
        """Run ``num_iters`` updates (default ``cfg.train_iter``) numbered
        from ``start_step``; returns the last step (the restored best's
        after a divergence stop). An exception escaping the loop dumps the
        flight recorder first."""
        if self.recorder is not None:
            with self.recorder.armed("train crash"):
                return self._train_impl(num_iters, start_step)
        return self._train_impl(num_iters, start_step)

    def _dispatch(self, fn, prev: int, *args) -> dict:
        """One step call under ``train/dispatch``; under debug_nans its
        ``finite`` flags are read and a bad step raises."""
        with span("train/dispatch"):
            out = fn(*args)
            if self.debug_nans:
                check_finite_steps(out.pop("finite"), prev)
        return out

    def _profile(self, prof, step: int, start_step: int):
        """Start torch.profiler at step start+1; close it and
        write ``trace.json`` once profile_steps steps ran in it."""
        if self.profile_dir is None or prof is False:
            return prof
        if prof is None and step >= start_step + 1:
            from induction_network_on_fewrel_tpu_torch.utils.profiling import activities

            prof = torch.profiler.profile(activities=activities())
            prof.__enter__()
        elif prof is not None and step >= start_step + 1 + self.profile_steps:
            self._close_profile(prof, step)
            prof = False
        return prof

    def _close_profile(self, prof, step: int) -> None:
        prof.__exit__(None, None, None)
        out = Path(self.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))
        self.logger.log(step, "profile", written=1.0)

    def _train_impl(self, num_iters: int | None, start_step: int) -> int:
        cfg = self.cfg
        spc = cfg.steps_per_call
        end_step = start_step + (num_iters or cfg.train_iter)
        it = iter(self.train_sampler)
        step = last_logged = start_step
        window: list[dict] = []
        tracker = get_tracker()
        tracker.set_trace(None)
        if self._perf is not None:
            self._perf.begin(step)
        prof = None             # None: not yet; a profile: open; False: done
        t0 = time.monotonic()
        try:
            while step < end_step:
                tracker.set_trace(tracker.new_context())
                if self._compile_watcher is not None:
                    self._compile_watcher.observe_step(step)
                prof = self._profile(prof, step, start_step)
                adv = self.adv
                if self.multi_train_step is not None and end_step - step >= spc:
                    with span("train/sample", steps=spc):
                        if adv is None and hasattr(self.train_sampler, "sample_fused"):
                            fused = batch_inputs(self.train_sampler.sample_fused(spc))
                            batches = [first_batch(fused)]
                        else:
                            batches = [batch_inputs(next(it)) for _ in range(spc)]
                            fused = stack_batches(batches)
                        extra = adv.sample(spc) if adv is not None else ()
                    window.append(self._dispatch(self.multi_train_step, step, *fused, *extra))
                    prev, step = step, step + spc
                else:
                    with span("train/sample", steps=1):
                        batches = [batch_inputs(next(it))]
                        extra = adv.sample() if adv is not None else ()
                    window.append(self._dispatch(self.train_step, step, *batches[0], *extra))
                    prev, step = step, step + 1
                if step - last_logged >= self.metric_window or step >= end_step:
                    keys = list(window[0])
                    with span("train/metrics_fetch"):
                        means = torch.stack([
                            torch.cat([m[k].reshape(-1) for m in window]).float().mean()
                            for k in keys]).tolist()      # one sync per window
                    dt = max(time.monotonic() - t0, 1e-9)
                    scalars = dict(zip(keys, means))
                    if cfg.nan_inject_step and last_logged < cfg.nan_inject_step <= step:
                        scalars["loss"] = float("nan")    # the logged loss only
                    if self._feed is not None:
                        self.logger.log(step, "data", **self._feed.drain_stats())
                    self.logger.log(step, "train",
                                    episodes_per_s=(step - last_logged) * cfg.batch_size / dt,
                                    device=self._device_name, **scalars)
                    if self._roofline_record is not None:
                        self.logger.log(step, "roofline", **self._roofline_record)
                    if self._perf is not None:
                        self._perf.observe_window(step)
                    if self._compile_watcher is not None:
                        self._compile_watcher.arm_steady()
                    window, last_logged, t0 = [], step, time.monotonic()
                if self.grad_probe is not None \
                        and step // cfg.grad_probe_every > prev // cfg.grad_probe_every:
                    t_probe = time.monotonic()
                    with span("train/grad_probe"):
                        out = {k: float(v) for k, v in self.grad_probe(*batches[0]).items()}
                    self.logger.log(step, "health", event="grad_probe", severity="info", **out)
                    t0 += time.monotonic() - t_probe    # the probe stays out of episodes_per_s
                if cfg.fault_step and start_step == 0 and step >= cfg.fault_step:
                    raise RuntimeError(
                        f"injected fault at step {step} (--fault_step {cfg.fault_step}); resume "
                        "with --resume (resumed runs ignore the injection)"
                    )
                if self.val_sampler is not None and cfg.val_step \
                        and step // cfg.val_step > prev // cfg.val_step:
                    t_val = time.monotonic()
                    stopped = self._val_boundary(step)
                    t0 += time.monotonic() - t_val    # eval + saves stay out of episodes_per_s
                    if stopped is not None:
                        return stopped
        finally:
            tracker.set_trace(None)
            if prof:
                self._close_profile(prof, step)     # the run ended inside the window
        self.materialize()
        if self.ckpt_dir is not None:
            self.save_latest(step)
            self.sync_saves()           # returning implies durable checkpoints
        return step

    def sync_saves(self) -> None:
        """Wait until every save is durable (on every rank: rank 0 writes,
        the others wait for it), so any rank may read the directory."""
        if self.ckpt is not None:
            self.ckpt.wait()
        if self.dp is not None:
            self.dp.barrier()

    def reader(self) -> CheckpointManager:
        """A manager over the checkpoint directory for a restore (rank 0's
        own; a read-only one on the other ranks, after ``sync_saves``)."""
        if self.ckpt is not None:
            return self.ckpt
        return CheckpointManager(self.ckpt_dir, self.cfg)

    def _val_boundary(self, step: int) -> int | None:
        """Materialize, evaluate, save (best on improvement, the ring
        always), then the divergence guard; the restored best step when the
        guard stops the run."""
        cfg = self.cfg
        self.materialize()
        with span("train/eval", episodes=cfg.val_iter):
            m = self.evaluate(cfg.val_iter, return_metrics=True)
        self.logger.log(step, "val", **m)
        improved = m["accuracy"] > self.best_val
        if improved:
            self.best_val = m["accuracy"]
        if self.ckpt_dir is not None:
            with span("train/checkpoint"):
                snap = self.snapshot()
                if improved:
                    self.saved_best = True
                    if self.ckpt is not None:
                        self.ckpt.save(step, snap[0], snap[1], m["accuracy"], lazy=self.lazy,
                                       samplers=snap[2])
                self.save_latest(step, snap)
        if self.best_val > self.guard_arm and m["accuracy"] < 0.5 * self.best_val:
            self.logger.log(step, "divergence", val_accuracy=m["accuracy"],
                            best_val=self.best_val)
            if cfg.divergence_guard == "stop" and self.ckpt_dir is not None:
                self.sync_saves()
                try:
                    best_step = self.reader().restore_best(self.model, self.opt, self.lazy)
                except FileNotFoundError:
                    best_step = None
                if best_step is not None and self.ckpt is not None:
                    self.ckpt.purge_ring_newer_than(best_step)
                self.logger.log(step, "divergence_stop",
                                restored_step=float(-1 if best_step is None else best_step))
                return step if best_step is None else best_step
        return None

    def snapshot(self) -> tuple:
        """(model, optimizer, sampler states) for a save. Under data
        parallel all three are gathered from every rank (collectives: every
        rank calls this at the same boundary): the model whole
        (``parallel/expert.FullModel``: the expert leaves gathered over ep,
        the tp-sharded leaves over tp, the stack leaves over pp),
        the optimizer as a ``SavedOptimizer`` of its full moments (ZeRO-1's
        chunks and the experts' gathered), the streams as rank 0's with
        every dp rank's under "ranks"."""
        if self.dp is None:
            return self.model, self.opt, self.sampler_states()
        from induction_network_on_fewrel_tpu_torch.parallel.expert import FullModel

        sharded = self.dp.ep > 1 or self.dp.tp > 1 or self.dp.pp > 1
        model = FullModel(self.model) if sharded else self.model
        return model, SavedOptimizer(self.opt.state_dict()), self.sampler_states()

    def save_latest(self, step: int, snap: tuple | None = None) -> None:
        model, opt, samplers = snap if snap is not None else self.snapshot()
        if self.ckpt is None:
            return
        info = self.ckpt.save_latest(step, model, opt, best_val=self.best_val,
                                     samplers=samplers, lazy=self.lazy)
        if info is not None:
            self.logger.log(step, "ckpt", event="ring_save", mode=info["mode"],
                            bytes=float(info["bytes"]),
                            **({"rows": float(info["rows"])} if "rows" in info else {}))

    def sampler_states(self) -> dict:
        """The streams' states: the feed's cursor (``PipelineCursor.to_dict``)
        for the train stream, else the sampler's ``feed_state``; the val
        sampler's ``feed_state``."""
        out = {}
        if self._feed is not None:
            out["train"] = self._feed.cursor_state().to_dict()
        elif self.train_sampler is not None:
            out["train"] = capture_sampler_state(self.train_sampler)
        if self.val_sampler is not None:
            out["val"] = capture_sampler_state(self.val_sampler)
        if self.dp is not None:
            ranks = self.dp.gather_objects(out)
            out = {**ranks[0], "ranks": ranks}
        return out

    def restore_sampler_states(self, states: dict) -> None:
        """Reposition the streams at ``sampler_states``' output, or at a
        checkpoint's from before the feed (raw ``bit_generator`` states).
        Under data parallel each rank takes its own streams from "ranks"
        when the checkpoint was saved at this world size; at another one
        the streams restart from their seeds (said on stderr)."""
        if "ranks" in states or self.dp is not None:
            ranks = states.get("ranks", [states])
            world = 1 if self.dp is None else self.dp.world
            if len(ranks) != world:
                import sys

                print(f"the checkpoint's episode streams were drawn by {len(ranks)} rank(s), "
                      f"this run has {world}: each rank's streams restart from its seed",
                      file=sys.stderr)
                return
            states = ranks[self.rank]
        for name, s in (("train", self.train_sampler), ("val", self.val_sampler)):
            if s is None or name not in states:
                continue
            state = states[name]
            if "kind" not in state and "consumed" not in state:    # a raw bit_generator state
                state = {"kind": "rng", "bit_generator": state["bit_generator"], "state": state}
            base = s.base if s is self._feed else s
            if state.get("kind") == "rng" and not hasattr(base, "rng"):
                raise ValueError(
                    f"the checkpoint's {name} stream is the numpy sampler's random state, and "
                    f"this run's {name} sampler is {type(base).__name__}; resume it with "
                    "--sampler python")
            if s is self._feed:
                cursor = (PipelineCursor.from_dict(state) if "consumed" in state else
                          PipelineCursor(0, 0, state, s.layout, s.stream_tag))
                s.restore_cursor(cursor)
            else:
                restore_sampler_state(s, state)

    def evaluate(self, num_episodes: int, sampler=None, return_metrics: bool = False,
                 source=None):
        """Mean episode accuracy over ``num_episodes`` episodes (at least one
        batch), or the full metric dict with ``return_metrics``. ``source``:
        the token table of ``sampler``'s split (default: the val split's)."""
        sampler = sampler or self.val_sampler
        single, multi = self._evals(source if source is not None else self.val_table)
        remaining = max(1, num_episodes // sampler.batch_size)
        it = iter(sampler)
        spc = self.eval_spc
        outs = []
        while remaining > 0:
            if multi is not None and remaining >= max(1, spc // 8):
                take = min(spc, remaining)
                batches = [batch_inputs(next(it)) for _ in range(take)]
                out = multi(*stack_batches(batches + [batches[-1]] * (spc - take)))
                outs.append({k: v[:take] for k, v in out.items()})
                remaining -= take
            else:
                out = single(*batch_inputs(next(it)))
                outs.append({k: v.reshape(1) for k, v in out.items()})
                remaining -= 1
        cols = {k: torch.cat([o[k] for o in outs]).float() for k in outs[0]}
        if self.dp is not None:     # each batch's mean over the ranks: the global batch's
            flat = self.dp.mean_(torch.stack(list(cols.values())).contiguous())
            cols = dict(zip(cols, flat))
        arrays = {k: v.cpu().numpy() for k, v in cols.items()}
        means = {k: float(np.mean(v)) for k, v in arrays.items()}
        if not return_metrics:
            return means["accuracy"]
        accs = arrays["accuracy"]
        metrics = {
            "accuracy": means["accuracy"],
            "acc_ci95": float(1.96 * np.std(accs, ddof=1) / np.sqrt(len(accs)))
            if len(accs) > 1 else 0.0,
        }
        if "nota_tp" in means:
            metrics["nota_precision"] = means["nota_tp"] / max(means["nota_pred"], 1e-12)
            metrics["nota_recall"] = means["nota_tp"] / max(means["nota_true"], 1e-12)
        return metrics

    def close(self) -> None:
        """Close the checkpoint manager (flushing its saver), the samplers
        (the feed joins its producer thread), the perf observer, the
        capture watcher and the logger."""
        try:
            if self.ckpt is not None:
                self.ckpt.close()
        finally:
            for s in (self.train_sampler, self.val_sampler):
                if hasattr(s, "close"):
                    s.close()
            if self._perf is not None:
                self._perf.close()
            if self._compile_watcher is not None:
                self._compile_watcher.uninstall()
            self.logger.close()
