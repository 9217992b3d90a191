"""Frozen experiment configuration of the serving and training paths.

The port's own copy of the ``ExperimentConfig`` fields that the serving
and training paths read (``induction_network_on_fewrel_tpu/config.py``):
episode geometry, tokenization/embedding, the few-shot model zoo and its
heads' widths, the CNN, BiLSTM + self-attention and transformer
encoders (the BiLSTM's training-route knobs), the BERT encoder and the
feature cache, the induction/NTN head, the NOTA
head, the dtypes, the kernel backends, the optimizer family, the loop
lengths, the fused-dispatch and grad-probe knobs, the token cache, the
checkpoint ring, the divergence guard and fault injection, the transformer's
MoE FFN and layer-stacked layout, FewRel 2.0 adversarial adaptation
(``adv*``), the serving runtime knobs (resident dtype, parity probe,
geometry tiers and the fleet's tier spread), the adaptation controller's
``adapt*`` policy, the host feed (sampler backend, prefetch, mixture, feed
faults), the data-parallel knobs (``dp``, ``zero_opt``, ``compact_demb``,
``grad_bucketing``, ``grad_bucket_count``, ``async_collectives``;
``parallel/``), the expert-, tensor-, sequence- and pipeline-parallel axes
(``ep``, ``tp``, ``sp``, ``pp`` with ``pp_microbatches``) and the seed.
Names and defaults are the JAX package's, so a config built with the same
keywords describes the same model in both packages, and the
``config.json`` a checkpoint writes loads into the JAX config too.

``resolve_quant_policy``, ``resolve_geometry_policy``,
``resolve_adapt_policy`` and ``parse_canary_plan`` are copies of the JAX
package's one-home resolvers of the serving and adaptation knobs.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    # --- episode geometry ---
    train_n: int = 5          # N-way during training (can exceed eval N)
    n: int = 5                # N-way at eval
    k: int = 5                # K-shot
    q: int = 5                # queries per class per episode
    na_rate: int = 0          # NOTA: na_rate*Q extra none-of-the-above queries
    # NOTA head (models/base.append_nota): "scalar" = one global learned
    # threshold logit; "stats" = per-query learned affine over the class-
    # score distribution (max/mean/std).
    nota_head: str = "scalar"
    batch_size: int = 4       # episodes per forward

    # --- tokenization / embedding ---
    max_length: int = 40      # tokens per sentence (fixed shapes)
    word_dim: int = 50        # GloVe 6B.50d
    pos_dim: int = 5          # each of the two position embeddings
    vocab_size: int = 400002  # GloVe 400k + [UNK] + [BLANK]

    # --- few-shot model (models/build.py dispatches every one) ---
    model: str = "induction"  # induction | proto | proto_hatt | siamese | gnn | snail | metanet | pair
    proto_metric: str = "euclid"  # euclid | dot (proto only)
    gnn_dim: int = 64         # features added per GNN block
    gnn_blocks: int = 2
    gnn_adj_hidden: int = 64  # adjacency MLP hidden width
    snail_tc_filters: int = 128

    # --- encoder: cnn | bilstm | transformer | bert ---
    encoder: str = "bilstm"
    hidden_size: int = 230    # CNN filters
    lstm_hidden: int = 128    # per direction
    att_dim: int = 64         # structured self-attention projection dim
    # Kernel backends (models/build.resolve_runtime_backends is the one
    # home of their resolution): "auto" = the hand-written CUDA kernel for
    # CUDA tensors, the plain PyTorch version for CPU tensors; "reference"
    # forces the plain version, "cuda" forces the kernel (CUDA tensors only).
    lstm_backend: str = "auto"
    attn_backend: str = "auto"
    # Training route of the BiLSTM (ops/lstm.py): one (h, c) checkpoint pair
    # per W natural-time steps, each window replayed in the backward; 0 =
    # the full-residual twin (hs and c saved at every step, kernels 4/6).
    # "auto" residuals follow compute_dtype; "f32"/"bf16" force the storage
    # dtype of the checkpoints or of the cs stream.
    lstm_cs_window: int = 8
    lstm_residuals: str = "auto"
    # Transformer encoder (models/transformer.py):
    tfm_layers: int = 4
    tfm_model: int = 256
    tfm_heads: int = 4
    tfm_ff: int = 1024
    # Mixture-of-Experts FFN (models/moe.py): 0 = dense MLP everywhere;
    # > 0 routes every ``moe_every``-th block through that many experts
    # (on one card: the JAX package's ep=1).
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity: float = 2.0
    moe_every: int = 2
    moe_group_size: int = 512  # tokens per routing group (memory knob)
    moe_aux_weight: float = 1e-2  # load-balance aux loss weight
    # Layer-stacked transformer (models/pipeline_transformer.py): the
    # pipeline-parallel parameter layout. Forced on when pp > 1; alone it
    # runs as a loop over the layer axis on one card (the JAX package's pp=1).
    tfm_stacked: bool = False
    pp_microbatches: int = 4  # GPipe microbatches per step (pp > 1)
    # BERT (models/bert.py; random init unless --bert_weights names a
    # .npz of bert-base-uncased weights):
    bert_layers: int = 12
    bert_hidden: int = 768
    bert_heads: int = 12
    bert_intermediate: int = 3072
    bert_vocab_size: int = 30522  # bert-base-uncased WordPiece vocab
    bert_vocab_path: str | None = None  # vocab.txt (None -> hash fallback)
    bert_frozen: bool = True  # the frozen -> fine-tuned regime's frozen phase
    bert_weights: str | None = None  # .npz of pretrained weights (or None)
    bert_remat: bool = False  # torch.utils.checkpoint per layer (memory vs FLOPs)

    # --- induction + relation modules ---
    induction_dim: int = 100  # class-vector dim C after the squash transform
    routing_iters: int = 3    # dynamic-routing iterations
    ntn_slices: int = 100     # tensor slices in the NTN scorer

    # --- optimization (train/steps.make_optimizer) ---
    loss: str = "mse"         # mse (paper §3.4) | ce
    # adam (coupled L2 after the clip) | adamw (decoupled decay) | sgd
    # (coupled L2, no momentum): train/steps.make_optimizer.
    optimizer: str = "adam"
    # Word-table optimizer: "shared" = the main optimizer updates the table
    # densely (reference parity); "lazy" = dense Adam's exact trajectory
    # with weight decay off the table, at the cost of the rows a step
    # touches (train/lazy_embed.py; Adam only); "sgd" = plain -lr*g on the
    # table (no decay, no moments); "frozen" = the table gets no gradient,
    # no update and no moments.
    embed_optimizer: str = "shared"
    lr: float = 1e-3
    weight_decay: float = 1e-5
    lr_step_size: int = 2000  # staircase decay interval, in updates
    lr_gamma: float = 0.5
    grad_clip: float = 10.0
    train_iter: int = 10000
    val_iter: int = 1000
    val_step: int = 1000
    test_iter: int = 3000
    # Optimizer steps per dispatch (train/steps.make_multi_train_step: one
    # CUDA-graph replay of S captured steps on the card); 1 = one step per
    # dispatch. The updates are the same as S single steps.
    steps_per_call: int = 1
    # Eval batches per dispatch at val/test boundaries; 0 = auto:
    # min(steps_per_call, 16).
    eval_steps_per_call: int = 0
    # Train dispatches between metric records: the window in steps is
    # max(50, metric_window_calls * steps_per_call).
    metric_window_calls: int = 4
    # Every K steps, log the gradient's global norm and its cosine to an
    # all-f32 plain-backend reference gradient on the same batch
    # (train/steps.make_grad_probe); 0 = off.
    grad_probe_every: int = 0
    # Frozen-BERT feature cache (train/feature_cache.py): each split is
    # encoded once into a [M, H] f32 table on the device and the steps
    # train the head alone. Its checkpoints hold head-only params, which
    # the serving engine refuses by name.
    feature_cache: bool = False
    # Device-resident token cache (train/token_cache.py): each split is
    # tokenized once into a [M, L] table on the device; per step only
    # episode indices cross to the card and the gather runs in the graph.
    token_cache: bool = False
    # Delta ring checkpoints (train/checkpoint.py): recovery-ring saves
    # write a base plus the changed rows of the lazy word table and its
    # moments; "auto" = on when the state carries the lazy leaves, "off" =
    # every ring save is full. Best saves stay full.
    ckpt_delta: str = "auto"
    # On a >2x val-accuracy collapse (the MSE-sigmoid dead zone): "none"
    # logs it; "stop" restores the best checkpoint, purges the newer ring
    # slots and ends the run.
    divergence_guard: str = "none"
    # Failure injection: raise once the step counter reaches this value on
    # a fresh run (a --resume continues past it); 0 = off.
    fault_step: int = 0
    # Checkpoint staging (train/checkpoint.py): "auto" writes slots to
    # /dev/shm and the saver thread drains them to the directory; "off"
    # writes in place.
    ckpt_stage: str = "auto"

    # --- telemetry (obs/) ---
    # The flight recorder and the run-health watchdog over the metrics stream.
    watchdog: bool = False
    # Set the logged loss of the window holding this step to NaN (the
    # training state is untouched); 0 = off.
    nan_inject_step: int = 0
    # The per-window step-time decomposition and the capture watcher.
    perf: bool = False
    # Chaos plan over the named fault points (obs/chaos.py); "" = off.
    chaos: str = ""

    # --- FewRel 2.0 adversarial domain adaptation (training-time only) ---
    adv: bool = False         # train encoder against a domain discriminator
    adv_lambda: float = 1.0   # gradient-reversal scale (encoder side)
    adv_dis_hidden: int = 256 # discriminator MLP width
    adv_batch: int = 32       # unlabeled instances per domain per step

    # --- serving runtime knobs (not architecture fields) ---
    # Dtype of the resident per-tenant class matrix: "f32", "bf16" or
    # "int8" (per-tenant symmetric f32 scale, dequantized in the head).
    resident_dtype: str = "f32"
    # Every K scored batches of a quantized tenant, re-score the same
    # queries against the f32 class matrix and record verdict agreement
    # and margin drift (serving/stats.py); 0 = off.
    quant_probe_every: int = 0
    # The N-tier ladder resident [N, C] class stacks pad up to (zero rows),
    # bounding the query graphs by tiers x buckets x dtypes; "off" = exact-N.
    geometry_tiers: str = "4,8,16,32,64"
    # Fleet placement: concentrate each N-tier's tenants onto this many
    # rendezvous "home" replicas, so no replica captures every tier's
    # query graphs (0 = tier-blind placement).
    geometry_tier_spread: int = 0

    # --- self-healing adaptation (obs/adapt.py) ---
    # A drift CRITICAL starts a supervised mixture-ramp fine-tune from the
    # live checkpoint, gated by the canary floors before any publish. The
    # knobs resolve in one home (resolve_adapt_policy) shared by both CLIs;
    # a train run stamps them into config.json, so a serving controller
    # fine-tuning from that artifact inherits the policy.
    adapt: bool = False
    adapt_retries: int = 3        # failed loops before the permanent adapt_exhausted
    adapt_backoff_s: float = 2.0  # base retry backoff (doubles per failure)
    adapt_cooldown_s: float = 60.0   # post-success trigger suppression
    adapt_step_budget: int = 200     # fine-tune optimizer-step budget
    adapt_wall_s: float = 300.0      # fine-tune wall-clock budget
    adapt_verify_s: float = 30.0     # post-publish verification window
    adapt_canary: str = "in_domain:0.3"  # leg:floor[,leg:floor...] | off

    # --- host data pipeline (sampling/native.py, datapipe/) ---
    # "auto" (the C++ sampler for training, numpy for eval) | "native" |
    # "python" (the numpy samplers).
    sampler: str = "auto"
    prefetch: int = 4         # the C++ sampler's ring of batches (0 = synchronous)
    sampler_threads: int = 2  # the ring's worker threads
    # The feed's producer thread draws the train stream into a bounded queue
    # of this many units (steps_per_call batches on fused index paths); the
    # pipeline cursor rides in every checkpoint. 0 = the synchronous path.
    prefetch_depth: int = 2
    # Episode-mixture schedule (datapipe/mixture.py); "" = one source.
    mixture: str = ""
    # Feed fault injection (datapipe/faults.py): "slow:S,stall:I,poison:I".
    feed_fault: str = ""

    # --- numerics ---
    compute_dtype: str = "bfloat16"  # embedding + encoder dtype
    head_dtype: str = "float32"      # induction / NTN / logits dtype
    seed: int = 0

    # --- data and expert parallel (parallel/; none is an architecture field) ---
    # ZeRO-1: each rank holds a contiguous 1/dp chunk of every Adam moment
    # whose size divides, updates its chunk of the parameters and
    # all-gathers them; a checkpoint holds the gathered moments.
    zero_opt: bool = False
    # The word table's gradient on dp ranks: "auto"/"on" reduce the
    # compact [U, D] rows' gradient of each rank's local segment sum in
    # one all-reduce; "off" all-gathers the embedding cotangent and every
    # rank sums the whole batch (the dense spelling, for A/Bs).
    compact_demb: str = "auto"
    # Bucketed gradient all-reduce (parallel/grad_buckets.py): "on" groups
    # the gradients into grad_bucket_count reverse-topological buckets,
    # each one flat all-reduce; "auto" = on for a lazy table on the card;
    # "off" = one flat all-reduce of every gradient after the backward.
    grad_bucketing: str = "auto"
    grad_bucket_count: int = 4
    # "on"/"auto": each bucket's all-reduce starts from the backward as
    # soon as its gradients are ready; "off": every bucket after it.
    async_collectives: str = "auto"
    dp: int = 1               # data-parallel ranks (episodes sharded)
    # Expert-parallel ranks (parallel/expert.py): each MoE layer's experts
    # shard over them; the ranks of one ep group hold the same episodes.
    ep: int = 1
    # Tensor-parallel ranks (parallel/tensor.py): the NTN's slices and the
    # MLP blocks shard over them. Sequence-parallel ranks (parallel/ring.py):
    # the token axis shards over them, attention runs as a ring.
    tp: int = 1
    sp: int = 1
    # Pipeline-parallel ranks (parallel/pipeline.py): the layer-stacked
    # transformer's layer axis shards over them, the GPipe schedule.
    pp: int = 1

    # Fields whose value shapes the parameters or the optimizer state: a
    # checkpoint restores only into a config that agrees on them.
    ARCHITECTURE_FIELDS = (
        "model", "proto_metric", "gnn_dim", "gnn_blocks", "gnn_adj_hidden",
        "snail_tc_filters",
        "encoder", "hidden_size", "lstm_hidden", "att_dim", "word_dim", "pos_dim",
        "vocab_size", "max_length", "induction_dim", "routing_iters",
        "ntn_slices", "bert_layers", "bert_hidden", "bert_heads", "bert_intermediate",
        "bert_vocab_size", "bert_vocab_path", "tfm_layers", "tfm_model", "tfm_heads", "tfm_ff",
        # moe_top_k/moe_capacity are runtime routing knobs (no parameter
        # shape depends on them); experts/every shape the tree.
        "moe_experts", "moe_every", "tfm_stacked",
        "loss", "optimizer", "embed_optimizer", "nota_head",
        # A feature-cache checkpoint holds the head alone; the run that
        # tests it rebuilds the same backbone (seed, frozen flag, weights).
        "feature_cache", "bert_frozen", "bert_weights",
    )
    # Episode-geometry fields that shape the parameters of some models:
    # gnn/snail bake the N-way label width into their layers and metanet
    # into its slow head; proto_hatt's feature-attention convs are K tall.
    MODEL_GEOMETRY_FIELDS = {
        "gnn": ("train_n", "n"),
        "snail": ("train_n", "n"),
        "metanet": ("train_n", "n"),
        "proto_hatt": ("k",),
    }

    def replace(self, **kw: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)

    def merge_architecture_from(self, other: "ExperimentConfig") -> "ExperimentConfig":
        """This config with ``other``'s architecture fields, and the
        geometry fields that shape ``other.model``'s parameters."""
        fields = self.ARCHITECTURE_FIELDS + self.MODEL_GEOMETRY_FIELDS.get(other.model, ())
        return self.replace(**{f: getattr(other, f) for f in fields})

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        """Keys this config does not have (a JAX config.json carries many
        more) are ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in json.loads(s).items() if k in names})


# Legal resident class-matrix dtypes, in density order.
RESIDENT_DTYPE_CHOICES = ("f32", "bf16", "int8")


def _knob_reader(knobs: Any, base: "ExperimentConfig | None"):
    fields = {f.name: f.default for f in dataclasses.fields(ExperimentConfig)}

    def knob(name):
        v = getattr(knobs, name, None)
        if v is None and base is not None:
            v = getattr(base, name, None)
        return fields[name] if v is None else v

    return knob


def resolve_quant_policy(knobs: Any, base: "ExperimentConfig | None" = None) -> dict:
    """The one home of the quantized-serving knobs. ``knobs`` is any object
    with ``resident_dtype``/``quant_probe_every`` attributes (a config or an
    argparse namespace); a missing or None attribute falls back to ``base``
    (the served checkpoint's config), then to the default. Returns
    {"resident_dtype", "probe_every"}."""
    knob = _knob_reader(knobs, base)
    dtype = str(knob("resident_dtype"))
    if dtype not in RESIDENT_DTYPE_CHOICES:
        raise ValueError(
            f"resident_dtype must be one of {RESIDENT_DTYPE_CHOICES}, got {dtype!r}"
        )
    probe_every = int(knob("quant_probe_every"))
    if probe_every < 0:
        raise ValueError(f"quant_probe_every must be >= 0, got {probe_every}")
    return {"resident_dtype": dtype, "probe_every": probe_every}


def resolve_geometry_policy(knobs: Any, base: "ExperimentConfig | None" = None) -> dict:
    """The one home of the geometry knobs, resolved like
    ``resolve_quant_policy``. Returns {"tiers": tuple | None (exact-N),
    "tier_spread": int}."""
    from induction_network_on_fewrel_tpu_torch.serving.geometry import parse_tiers

    knob = _knob_reader(knobs, base)
    tiers = parse_tiers(knob("geometry_tiers"))
    spread = int(knob("geometry_tier_spread"))
    if spread < 0:
        raise ValueError(f"geometry_tier_spread must be >= 0, got {spread}")
    return {"tiers": tiers, "tier_spread": spread}


# The controller-facing knob names, in the order both CLIs expose them;
# each maps onto an ExperimentConfig ``adapt_*`` field.
ADAPT_KNOBS = (
    "adapt_retries", "adapt_backoff_s", "adapt_cooldown_s",
    "adapt_step_budget", "adapt_wall_s", "adapt_verify_s", "adapt_canary",
)


def parse_canary_plan(spec: str) -> dict[str, float]:
    """``"leg:floor[,leg:floor...]"`` -> {leg: floor}; "off" -> {} (the
    canary gate disabled: every candidate publishes). Floors are hard
    go/no-go accuracy bars for ``obs/canary.run_canary``; legs name the
    evaluation datasets the CLI wires (``in_domain`` = the serving
    support corpus, ``target`` = the remediation corpus,
    ``grid_<N>w<K>s`` = the in-domain corpus at that geometry)."""
    spec = (spec or "").strip()
    if not spec or spec == "off":
        return {}
    floors: dict[str, float] = {}
    for part in spec.split(","):
        leg, sep, floor_s = part.strip().partition(":")
        if not sep or not leg:
            raise ValueError(
                f"canary plan entry {part!r} must be 'leg:floor' "
                f"(e.g. 'in_domain:0.3,target:0.25') or 'off'"
            )
        floor = float(floor_s)
        if not 0.0 <= floor <= 1.0:
            raise ValueError(f"canary floor for {leg!r} must be in [0, 1], got {floor}")
        if leg in floors:
            raise ValueError(f"canary plan names leg {leg!r} twice")
        floors[leg] = floor
    return floors


def resolve_adapt_policy(knobs: Any, base: "ExperimentConfig | None" = None) -> dict | None:
    """The one home of the ``--adapt`` knobs, shared by both CLIs. ``knobs``
    is any object with ``adapt`` and the ADAPT_KNOBS attributes (a config
    or an argparse namespace); a missing or None attribute falls back to
    ``base`` (the served checkpoint's config, where a train run stamped
    its policy), then to the default. Returns the validated policy dict
    (the controller's kwargs and the parsed canary plan), or None when
    adaptation is off."""
    knob = _knob_reader(knobs, base)
    enabled = getattr(knobs, "adapt", None)
    if enabled is None and base is not None:
        enabled = getattr(base, "adapt", False)
    if not enabled:
        return None
    retries = int(knob("adapt_retries"))
    backoff_s = float(knob("adapt_backoff_s"))
    cooldown_s = float(knob("adapt_cooldown_s"))
    step_budget = int(knob("adapt_step_budget"))
    wall_s = float(knob("adapt_wall_s"))
    verify_s = float(knob("adapt_verify_s"))
    if retries < 1:
        raise ValueError(f"adapt_retries must be >= 1, got {retries}")
    if backoff_s <= 0 or wall_s <= 0 or verify_s <= 0:
        raise ValueError(
            f"adapt_backoff_s/adapt_wall_s/adapt_verify_s must be > 0 "
            f"(got {backoff_s}/{wall_s}/{verify_s})"
        )
    if cooldown_s < 0:
        raise ValueError(f"adapt_cooldown_s must be >= 0, got {cooldown_s}")
    if step_budget < 1:
        raise ValueError(f"adapt_step_budget must be >= 1, got {step_budget}")
    return {
        "retry_budget": retries,
        "backoff_s": backoff_s,
        "cooldown_s": cooldown_s,
        "step_budget": step_budget,
        "wall_budget_s": wall_s,
        "verify_window_s": verify_s,
        "canary_floors": parse_canary_plan(str(knob("adapt_canary"))),
    }
