"""Train and test entry points of the port.

    python -m induction_network_on_fewrel_tpu_torch.cli train \\
        --train_file train_wiki.json --val_file val_wiki.json \\
        --glove glove_word2id.json --glove_mat glove_mat.npy \\
        --N 5 --K 5 --Q 5 --batch_size 4 --train_iter 1000 --val_step 200 \\
        --val_iter 200 --bf16 --token_cache --embed_optimizer lazy \\
        --save_ckpt ./ckpt_torch
    python -m induction_network_on_fewrel_tpu_torch.cli test \\
        --test_file val_pubmed.json --glove glove_word2id.json \\
        --glove_mat glove_mat.npy --load_ckpt ./ckpt_torch --test_iter 1000 --bf16

The counterparts of ``train.py`` / ``test.py`` (``train_main`` /
``test_main`` of the JAX ``cli.py``) with a subset of their flags under the
same names. Data: FewRel-schema JSON splits (``--train_file``,
``--val_file``, ``--test_file``) and GloVe (``--glove`` word2id JSON with
``--glove_mat`` .npy, a combined JSON or the stock .txt), which then set
``vocab_size`` and ``word_dim``; a split or vocabulary without a file is
the synthetic fixture (train, val and test from seeds 0, 1 and 2, as the
JAX package makes them; ``--synthetic`` says so explicitly). As in the JAX
CLI the encoder computes in f32 unless ``--bf16``. ``train`` logs
``[train]``/``[val]`` records (stderr and ``<save_ckpt>/metrics.jsonl``),
keeps the best checkpoints and a recovery ring (``--ckpt_delta``: base +
delta saves of the lazy word table), then reports the final val accuracy
of the best checkpoint as a JSON line; ``test`` restores the best
checkpoint (the latest one when there is no best) with the architecture of
its ``config.json`` and prints ``{"test_accuracy", "acc_ci95"}`` (with
NOTA, its precision and recall). ``train --resume`` continues the newest
intact checkpoint of ``--save_ckpt`` (weights, optimizer and lazy state,
best val accuracy and the samplers' streams: the same updates as an
uninterrupted run) for ``--train_iter`` more steps; ``train --only_test``
restores (``--resume`` or ``--load_ckpt``) and reports the test accuracy.

``--model`` and ``--encoder`` choose any model of the zoo (induction,
proto, proto_hatt, siamese, gnn, snail, metanet) over the CNN, BiLSTM,
transformer or BERT encoder, or BERT-PAIR (``--model pair --encoder
bert``), with the JAX widths ``--proto_metric``, ``--gnn_dim``,
``--gnn_blocks``, ``--snail_tc_filters``, ``--hidden_size``, ``--tfm_*``,
``--bert_*`` and ``--routing_iters`` (``--fp16`` is the bf16 alias). The
BERT paths tokenize with ``BertTokenizer`` (WordPiece over ``--bert_vocab``,
which sets ``--bert_vocab_size``, else the hash fallback) and load no
GloVe; ``--bert_weights`` (an .npz of bert-base-uncased weights) is copied
into the backbone before training or encoding; the CLI's default is the
fine-tuned backbone, ``--bert_frozen`` freezes it. ``--feature_cache``
(frozen BERT only) encodes each split once into a table on the card and
trains the head alone; ``test`` on such a checkpoint rebuilds the backbone
from the seed and ``bert_weights`` and re-encodes the test split. Every
other JAX train/test flag is parsed: at its JAX default it is accepted,
otherwise refused by name (rc 2) with the ROADMAP item that brings it
(``DEFERRED``) or why it has no counterpart (``NO_COUNTERPART``).
``--sampler`` (auto: the C++ sampler for training, numpy for val/test),
``--prefetch`` and ``--sampler_threads`` (its ring), ``--prefetch_depth``
(the host feed's producer queue), ``--mixture`` and ``--feed_fault``
choose the input path (``make_trainer``).
``--trainN`` trains N-way episodes other than the eval's ``--N``;
``--na_rate``/``--nota_head`` the FewRel 2.0 none-of-the-above queries and
head (mse with ``--na_rate >= 3`` is refused without ``--force``);
``--token_cache`` keeps each split's tokens on the card and sends only
episode indices; ``--embed_optimizer lazy`` is exact lazy Adam on the word
table (Adam only; without ``--token_cache`` it warns); ``--divergence_guard
stop`` restores the best checkpoint on a val collapse and ends the run;
``--fault_step`` injects a crash on a fresh run. ``--moe_*`` (the MoE FFN in
every ``--moe_every``-th transformer block, its load-balance term in the
objective) and ``--tfm_stacked`` (the layer-stacked transformer) run on one
card (``--ep`` and ``--pp`` under a launcher, below); ``train --adv [TARGET_FILE]`` is FewRel 2.0
adversarial adaptation (the DANN step against a domain discriminator over
``--adv_batch`` source and target instances a step; bare ``--adv`` is the
synthetic target domain), with ``--adv_lambda`` and ``--adv_dis_hidden``.
``--optimizer``, ``--weight_decay``, ``--lr_step_size`` and ``--grad_clip`` choose the
update; ``--steps_per_call`` steps run per dispatch (one CUDA-graph replay
on the card), ``--eval_steps_per_call`` eval batches,
``--metric_window_calls`` dispatches per metric record, and
``--grad_probe_every`` logs the gradient-health probe.

Telemetry (the JAX ``cli.py:1333-1421``): records go to
``<--run_dir or --save_ckpt>/metrics.jsonl`` and, with ``--tensorboard
DIR``, to an event file there. ``--watchdog`` hooks the flight recorder
and the health watchdog (critical events dump ``flight_recorder.json``;
SIGTERM dumps too); ``--perf`` adds the per-window step-time
decomposition and the capture watcher (``kind="perf"``/``"compile"``,
the floor projected at the H100's rates); ``--profile DIR`` traces the
calls over steps [start+1, start+1+--profile_steps) with torch.profiler;
``--nan_inject_step N`` sets the logged loss of the window holding step
N to NaN; ``--debug_nans`` raises ``FloatingPointError`` at the first
step whose loss or gradient norm is not finite (a device-side flag read
after each call); ``--chaos PLAN`` arms the fault points
(``obs/chaos.py``); ``--ckpt_stage auto|off`` stages checkpoint writes in
``/dev/shm`` for the saver thread to drain. ``train --adapt`` with
``--adapt_retries``, ``--adapt_backoff_s``, ``--adapt_cooldown_s``,
``--adapt_step_budget``, ``--adapt_wall_s``, ``--adapt_verify_s`` and
``--adapt_canary`` stamps the self-healing adaptation policy into the
checkpoint's ``config.json`` (validated at start by
``config.resolve_adapt_policy``); ``serving.cli --adapt`` on that
artifact inherits it.

Data parallel (the JAX ``--dp``, ``--zero_opt``, ``--compact_demb``,
``--grad_bucketing``, ``--grad_bucket_count``, ``--async_collectives``):
launched as ``torchrun --nproc_per_node N -m
induction_network_on_fewrel_tpu_torch.cli train --dp N ...`` every rank
joins the process group (NCCL on ``cuda:LOCAL_RANK``; gloo with
``--device cpu``), samples its own ``B/N`` episodes and averages the
gradients with the others (``parallel/``); rank 0 alone logs, writes the
checkpoints and prints the result. Without a launcher ``--dp`` 0 or 1 is
the one-process run. ``--adv`` (each rank on ``adv_batch/N`` source and
target instances, the discriminator's gradients averaged too),
``--feature_cache`` (each rank encodes the whole table) and ``--mixture``
(every rank picks the same source for batch i; each draws its own rows)
run under a mesh, and so does MoE: each layer routes over the global batch
and takes its load-balance term from global statistics
(``models/moe.py``). ``--ep M`` (the JAX expert-parallel axis; it needs
``--encoder transformer --moe_experts E`` with E divisible by M) shards
each MoE layer's experts over M ranks that hold the same episodes
(``torchrun --nproc_per_node dp*M``; ``parallel/expert.py``); a checkpoint
holds every expert, so it restores at any ``--ep``. ``--tp T`` shards the
NTN's slices and the transformer's and BERT's MLP blocks over T ranks that
hold the same episodes (``parallel/tensor.py``; a checkpoint holds every
slice, so it restores at any ``--tp``), and ``--sp S`` (``--encoder
transformer``) the token axis, attention running as a ring
(``parallel/ring.py``). ``--pp P`` (``--encoder transformer``, layers
divisible by P; it implies ``--tfm_stacked``) shards the layer-stacked
transformer's layers over P stages that hold the same episodes and runs
each encoder call as ``--pp_microbatches`` microbatches in the GPipe
schedule (``parallel/pipeline.py``): every encoder call's rows per dp shard
must split into them (the JAX row check); a checkpoint holds every layer,
so it restores at any ``--pp``. Launch ``torchrun --nproc_per_node
dp*pp*ep*tp*sp``.

Runs on the GPU by default and refuses to start without CUDA unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import warnings


def build_arg_parser(train: bool) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=f"python -m induction_network_on_fewrel_tpu_torch.cli {'train' if train else 'test'}",
    )
    p.add_argument("--trainN", type=int, default=None,
                   help="N-way during training (defaults to --N)")
    p.add_argument("--N", type=int, default=5, help="N-way at eval")
    p.add_argument("--K", type=int, default=5, help="K-shot")
    p.add_argument("--Q", type=int, default=5, help="queries per class")
    p.add_argument("--na_rate", type=int, default=0, help="NOTA queries ratio (FewRel 2.0)")
    p.add_argument("--nota_head", default="scalar", choices=["scalar", "stats"],
                   help="NOTA threshold head: one global learned logit, or a per-query "
                        "learned affine over class-score statistics")
    p.add_argument("--batch_size", type=int, default=4, help="episodes per step")
    p.add_argument("--model", default="induction",
                   choices=["induction", "proto", "proto_hatt", "siamese", "gnn", "snail",
                            "metanet", "pair"],
                   help="few-shot model (pair = BERT-PAIR, needs --encoder bert)")
    p.add_argument("--proto_metric", default="euclid", choices=["euclid", "dot"],
                   help="proto similarity")
    p.add_argument("--gnn_dim", type=int, default=64, help="features added per GNN block")
    p.add_argument("--gnn_blocks", type=int, default=2)
    p.add_argument("--snail_tc_filters", type=int, default=128)
    p.add_argument("--encoder", default="bilstm",
                   choices=["cnn", "bilstm", "bert", "transformer"],
                   help="sentence encoder")
    p.add_argument("--tfm_layers", type=int, default=4)
    p.add_argument("--tfm_model", type=int, default=256)
    p.add_argument("--tfm_heads", type=int, default=4)
    p.add_argument("--tfm_ff", type=int, default=1024)
    p.add_argument("--moe_experts", type=int, default=0,
                   help="MoE: route every --moe_every-th transformer block through this many "
                        "experts (0 = dense MLP everywhere)")
    p.add_argument("--moe_top_k", type=int, default=2)
    p.add_argument("--moe_capacity", type=float, default=2.0,
                   help="expert capacity factor (tokens past capacity are dropped)")
    p.add_argument("--moe_every", type=int, default=2)
    p.add_argument("--moe_group_size", type=int, default=512,
                   help="tokens per routing group (bounds the [G, S, E, C] one-hots)")
    p.add_argument("--moe_aux_weight", type=float, default=1e-2,
                   help="load-balance aux loss weight (training objective only)")
    p.add_argument("--tfm_stacked", action="store_true",
                   help="layer-stacked transformer parameters [NL, ...], a loop over the layer "
                        "axis on one card (the pipeline-parallel layout)")
    p.add_argument("--hidden_size", type=int, default=230, help="CNN filters")
    p.add_argument("--max_length", type=int, default=40)
    p.add_argument("--vocab_size", type=int, default=400002,
                   help="word-embedding rows incl. UNK/BLANK (the synthetic GloVe size; a "
                        "--glove file sets it)")
    p.add_argument("--lstm_hidden", type=int, default=128)
    p.add_argument("--induction_dim", type=int, default=100)
    p.add_argument("--routing_iters", type=int, default=3,
                   help="dynamic-routing iterations of the induction module")
    p.add_argument("--ntn_slices", type=int, default=100)
    p.add_argument("--bert_frozen", action="store_true", help="freeze the BERT backbone")
    p.add_argument("--bert_layers", type=int, default=12)
    p.add_argument("--bert_hidden", type=int, default=768)
    p.add_argument("--bert_heads", type=int, default=12)
    p.add_argument("--bert_intermediate", type=int, default=3072)
    p.add_argument("--bert_vocab", default=None,
                   help="vocab.txt for WordPiece (hash fallback if absent)")
    p.add_argument("--bert_vocab_size", type=int, default=30522,
                   help="embedding rows in hash-fallback mode")
    p.add_argument("--bert_weights", default=None, help=".npz of bert-base-uncased weights")
    p.add_argument("--bert_remat", action="store_true",
                   help="recompute each BERT layer in the backward (memory vs FLOPs)")
    p.add_argument("--feature_cache", action="store_true",
                   help="frozen-encoder feature cache: encode each split once on the card, "
                        "train the episode head on gathered features (frozen bert only)")
    p.add_argument("--lstm_cs_window", type=int, default=8,
                   help="BiLSTM checkpoint window of the training route "
                        "(0 = the full-residual twin)")
    p.add_argument("--lstm_residuals", default="auto", choices=["auto", "f32", "bf16"],
                   help="storage dtype of the checkpoints or the cs stream "
                        "(auto = the compute dtype)")
    p.add_argument("--lstm_backend", default="auto", choices=["auto", "reference", "cuda"],
                   help="BiLSTM impl: auto = the CUDA kernels on the GPU, the plain "
                        "PyTorch version on the CPU; reference = the plain version "
                        "(any width); cuda = the kernels (4u <= 512)")
    p.add_argument("--attn_backend", default="auto", choices=["auto", "reference", "cuda"],
                   help="self-attention impl: auto = the CUDA kernels on the GPU, the "
                        "plain PyTorch version on the CPU")
    p.add_argument("--bf16", action="store_true", help="bf16 embedding + encoder")
    p.add_argument("--fp16", action="store_true", help="(reference flag) alias for --bf16")
    p.add_argument("--token_cache", action="store_true",
                   help="device-resident token cache: each split tokenized once on the "
                        "card, only episode indices cross per step")
    p.add_argument("--divergence_guard", default="none", choices=["none", "stop"],
                   help="on a >2x val-accuracy collapse: 'none' logs it, 'stop' restores "
                        "the best checkpoint and ends the run")
    p.add_argument("--loss", default="mse", choices=["mse", "ce"])
    p.add_argument("--optimizer", default="adam", choices=["adam", "adamw", "sgd"])
    p.add_argument("--embed_optimizer", default="shared",
                   choices=["shared", "lazy", "sgd", "frozen"],
                   help="word-embedding table optimizer: shared = main optimizer "
                        "(reference parity: dense update of the whole table every step; "
                        "the DEFAULT), lazy = dense Adam's exact trajectory with weight "
                        "decay off the table, at the cost of the rows a step touches "
                        "(--optimizer adam; fast with --token_cache), sgd = plain -lr*g "
                        "on the table (no decay, no moments), frozen = fixed GloVe (no "
                        "gradient, no update)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=1e-5)
    p.add_argument("--lr_step_size", type=int, default=2000)
    p.add_argument("--grad_clip", type=float, default=10.0)
    if train:
        p.add_argument("--train_iter", type=int, default=10000)
        p.add_argument("--val_iter", type=int, default=1000)
        p.add_argument("--val_step", type=int, default=1000)
        p.add_argument("--force", action="store_true",
                       help="run a known-degenerate config (--loss mse with --na_rate >= 3)")
        p.add_argument("--fault_step", type=int, default=0,
                       help="inject a crash once the step counter reaches this value (fresh "
                            "runs only; 0 = off)")
    # On both parsers: the test entry point's eval loop fuses batches too.
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="optimizer steps (or eval batches) fused into one dispatch "
                        "(one CUDA-graph replay); identical results, amortized host "
                        "launch latency")
    p.add_argument("--eval_steps_per_call", type=int, default=0,
                   help="eval batches fused per dispatch at val/test boundaries "
                        "(0 = auto: min(steps_per_call, 16))")
    p.add_argument("--metric_window_calls", type=int, default=4,
                   help="fused train calls between metric fetches (each fetch syncs "
                        "the card)")
    p.add_argument("--ckpt_delta", default="auto", choices=["auto", "off"],
                   help="delta ring checkpoints: ring saves of a lazy-table state write a "
                        "base + the changed rows (auto), or full states (off)")
    p.add_argument("--test_iter", type=int, default=3000)
    p.add_argument("--train_file", default=None,
                   help="FewRel-schema JSON; synthetic if omitted")
    p.add_argument("--val_file", default=None)
    p.add_argument("--test_file", default=None)
    if train:
        p.add_argument("--adv", nargs="?", const="synthetic", default=None,
                       metavar="TARGET_FILE",
                       help="FewRel 2.0 adversarial adaptation against this unlabeled "
                            "target-domain FewRel-schema JSON; bare --adv uses a synthetic "
                            "target domain")
        p.add_argument("--adv_lambda", type=float, default=1.0,
                       help="gradient-reversal scale on the encoder")
        p.add_argument("--adv_dis_hidden", type=int, default=256)
        p.add_argument("--adv_batch", type=int, default=32,
                       help="unlabeled instances per domain per step")
    p.add_argument("--glove", default=None, help="GloVe json (word2id or combined) or .txt")
    p.add_argument("--glove_mat", default=None, help=".npy matrix for a word2id json")
    p.add_argument("--synthetic", action="store_true",
                   help="the synthetic FewRel/GloVe fixtures (the default for every split "
                        "and the vocabulary without a file)")
    p.add_argument("--sampler", default="auto", choices=["auto", "native", "python"],
                   help="episode sampler backend: native = the C++ sampler (built with g++ "
                        "at first use), python = the numpy samplers, auto = native for "
                        "training and python for val/test")
    p.add_argument("--prefetch", type=int, default=4,
                   help="the C++ sampler's ring of batches (0 = synchronous)")
    p.add_argument("--sampler_threads", type=int, default=2,
                   help="the C++ sampler ring's worker threads")
    p.add_argument("--prefetch_depth", type=int, default=2,
                   help="the host feed's depth (units of steps_per_call batches on fused "
                        "index paths): a producer thread samples ahead into a bounded queue "
                        "so sampling overlaps the step; the pipeline cursor rides in every "
                        "checkpoint and --resume replays the exact episode stream. 0 = the "
                        "synchronous path (the same stream)")
    p.add_argument("--mixture", default="",
                   help="episode-mixture schedule (datapipe/mixture.py): "
                        "'source:w[@idx][,w@idx...];...' where a source is 'train', "
                        "'synthetic[:SEED]' or a FewRel-schema JSON path, e.g. "
                        "'train:1.0;pubmed.json:0.0@0,1.0@4000'; the per-batch source pick is "
                        "a function of (seed, batch index) and resumes exactly. Live token "
                        "path only")
    if train:
        p.add_argument("--feed_fault", default="",
                       help="feed fault injection (drills): 'slow:SECONDS', 'stall:INDEX', "
                            "'poison:INDEX' (comma-separable)")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the GPU (refuses to start without CUDA)")
    # Data parallel (parallel/): the JAX flags, names, defaults and help.
    p.add_argument(
        "--zero_opt", action="store_true",
        help="ZeRO-1-style optimizer-state sharding: Adam moments shard "
             "over the dp mesh axis (1/dp of the optimizer HBM per device; "
             "identical update trajectory)",
    )
    p.add_argument(
        "--compact_demb", default="auto", choices=["auto", "on", "off"],
        help="dp-sharded embedding gradient: keep the demb segment-sum "
             "local per shard and all-reduce only the compact [U, D] "
             "touched-row gradient, instead of gathering the [L, M, word_dim] "
             "embedding cotangent on every rank. 'off' restores the dense "
             "behavior for A/Bs; identical params/checkpoints either way",
    )
    p.add_argument(
        "--grad_bucketing", default="auto", choices=["auto", "on", "off"],
        help="bucketed gradient collectives on pure-dp meshes: one flat "
             "all-reduce per reverse-topological bucket (grad/bucket_0 = "
             "relation head ... last = embedding) so each bucket's reduction "
             "can fly while earlier layers' backward computes. 'auto' = the "
             "card with --embed_optimizer lazy; 'on' forces the bucketed arm "
             "anywhere; 'off' = one all-reduce after the backward. Identical "
             "params either way",
    )
    p.add_argument("--grad_bucket_count", type=int, default=4,
                   help="bucket count when --grad_bucketing resolves on")
    p.add_argument(
        "--async_collectives", default="auto", choices=["auto", "on", "off"],
        help="start each gradient bucket's all-reduce from the backward as "
             "soon as its gradients are ready ('on'/'auto'), or every bucket "
             "after the backward ('off')",
    )
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel mesh axis (0 = all devices): the ranks of "
                        "torchrun --nproc_per_node N; without a launcher, one")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel mesh axis (requires --moe_experts)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel mesh axis (NTN slices, MLP column/row splits)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel mesh axis (ring attention; requires --encoder "
                        "transformer)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel mesh axis: transformer layer stages with the "
                        "microbatched GPipe schedule (implies --tfm_stacked)")
    p.add_argument("--pp_microbatches", type=int, default=4,
                   help="GPipe microbatches per encoder call (bubble = (pp-1)/(m+pp-1))")
    p.add_argument("--save_ckpt", default="./checkpoint", help="checkpoint directory")
    p.add_argument("--load_ckpt", default=None, help="checkpoint directory to restore")
    if train:
        p.add_argument("--resume", action="store_true",
                       help="resume latest state from --save_ckpt")
        p.add_argument("--only_test", action="store_true")
        p.add_argument("--grad_probe_every", type=int, default=0,
                       help="every K steps, log grad global-norm + grad-cosine vs an "
                            "all-f32 reference backward on the same batch (0 = off)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--run_dir", default=None, help="metrics/log dir (defaults to --save_ckpt)")
    p.add_argument("--ckpt_stage", default="auto", choices=["auto", "off"],
                   help="checkpoint staging: slots are written to /dev/shm and the saver "
                        "thread drains them to --save_ckpt (auto: when /dev/shm exists)")
    if train:
        p.add_argument("--profile", default=None, metavar="DIR",
                       help="torch.profiler chrome trace of steps start+1..start+1+"
                            "profile_steps into DIR/trace.json")
        p.add_argument("--tensorboard", default=None, metavar="DIR",
                       help="also mirror every numeric record field to a TensorBoard event "
                            "file in DIR (metrics.jsonl is always written)")
        p.add_argument("--profile_steps", type=int, default=10)
        p.add_argument("--debug_nans", action="store_true",
                       help="raise FloatingPointError at the first step whose loss or "
                            "gradient norm is not finite (a device-side flag in the step, "
                            "read after each call)")
        p.add_argument("--watchdog", action="store_true",
                       help="run-health watchdog: NaN/Inf scalars, throughput regression, "
                            "routing collapse -> kind='health' events; critical events dump "
                            "flight_recorder.json to --run_dir")
        p.add_argument("--nan_inject_step", type=int, default=0,
                       help="set the LOGGED loss of the window holding step N to NaN "
                            "(training unaffected; drills the watchdog and the recorder)")
        p.add_argument("--perf", action="store_true",
                       help="per-window step-time decomposition (kind='perf' segments tile "
                            "the window) and capture forensics (kind='compile': CUDA-graph "
                            "captures and kernel builds, with the steady-capture gate)")
        p.add_argument("--chaos", default="",
                       help="chaos plan: comma-separated POINT@AT[*COUNT][:ARG] over the "
                            "named fault points (obs/chaos.py), e.g. ckpt.bitflip@1:ring")
        # The self-healing adaptation policy (obs/adapt.py), resolved in one
        # home (config.resolve_adapt_policy, shared with the serving CLI). A
        # train run stamps it into the checkpoint's config.json, so a serving
        # controller fine-tuning from this artifact inherits it.
        p.add_argument("--adapt", action="store_true",
                       help="stamp a self-healing adaptation policy into this run's "
                            "checkpoints: a serving-side controller (serving.cli --adapt) "
                            "fine-tuning from the artifact inherits the budgets below")
        p.add_argument("--adapt_retries", type=int, default=None,
                       help="failed adaptation loops before the permanent adapt_exhausted "
                            "CRITICAL + tenant quarantine")
        p.add_argument("--adapt_backoff_s", type=float, default=None,
                       help="base retry backoff seconds (doubles per failed attempt)")
        p.add_argument("--adapt_cooldown_s", type=float, default=None,
                       help="post-success trigger suppression seconds")
        p.add_argument("--adapt_step_budget", type=int, default=None,
                       help="fine-tune optimizer-step budget")
        p.add_argument("--adapt_wall_s", type=float, default=None,
                       help="fine-tune wall-clock budget seconds (breach = timeout-kill + "
                            "candidate cleanup)")
        p.add_argument("--adapt_verify_s", type=float, default=None,
                       help="post-publish verification window seconds (a drift re-trip "
                            "inside it rolls back)")
        p.add_argument("--adapt_canary", default=None,
                       help="pre-publish canary plan: 'leg:floor[,leg:floor...]' accuracy "
                            "bars (obs/canary.run_canary) or 'off'")
    later = p.add_argument_group("JAX flags refused by name unless at their JAX default")
    for flag, (default, kind, why) in {**DEFERRED, **NO_COUNTERPART}.items():
        why = f"not ported yet: {why}" if flag in DEFERRED else f"no counterpart: {why}"
        if kind is bool:
            later.add_argument(flag, action="store_true", help=why)
        else:
            later.add_argument(flag, type=kind, default=default, help=why)
    return p


# JAX train/test flags this package has not ported: flag -> (its JAX
# default, type, the ROADMAP queue A item that brings it). Given with
# anything but the default (or a value meaning the same here, _NEUTRAL),
# each is refused by name (rc 2). Every JAX flag is ported: none is left.
DEFERRED: dict = {}
# JAX flags with no counterpart here: flag -> (its JAX default, type, why).
NO_COUNTERPART = {
    "--compile_cache": ("auto", str, "the port keeps no XLA compile cache (its kernels build "
                                     "once into build/torch_kernels)"),
    "--remat_attn": ("on", str, "the attention backward always rebuilds the projection from "
                                "the forward's saved softmax statistics (K10 -> K11), as "
                                "--remat_attn on does"),
}
# Values other than the JAX default that mean the same on one card.
_NEUTRAL = {"--compile_cache": ("off",)}


def refuse_deferred(parser: argparse.ArgumentParser, args) -> None:
    """Exit (rc 2) naming the first unported JAX flag given with anything
    but its JAX default, with the ROADMAP item that brings it."""
    for flag, (default, _, why) in {**DEFERRED, **NO_COUNTERPART}.items():
        value = getattr(args, flag[2:], default)
        if value == default or value in _NEUTRAL.get(flag, ()):
            continue
        if flag in DEFERRED:
            parser.error(f"{flag} is not ported yet: it comes with {why}")
        parser.error(f"{flag} {value} has no counterpart here: {why}")


def parse_args(train: bool, argv=None):
    """Parse ``argv``; exit (rc 2) naming the slice that brings an unported
    JAX flag given with anything but its default, naming an MoE, stacked or
    ``--ep`` option the model would not honor (``check_transformer_options``), and
    on ``train --bert_weights`` without ``--encoder bert``."""
    from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
    from induction_network_on_fewrel_tpu_torch.models.build import (
        check_transformer_options,
        refuse_later_slices,
    )

    parser = build_arg_parser(train)
    args = parser.parse_args(argv)
    try:
        cfg = ExperimentConfig(model=args.model, encoder=args.encoder, tfm_layers=args.tfm_layers,
                               moe_experts=args.moe_experts, moe_top_k=args.moe_top_k,
                               moe_every=args.moe_every,
                               tfm_stacked=args.tfm_stacked or args.pp > 1,
                               ep=args.ep, tp=args.tp, sp=args.sp, pp=args.pp)
        refuse_later_slices(cfg)
        check_transformer_options(cfg)
    except ValueError as e:
        parser.error(str(e))
    refuse_deferred(parser, args)
    if train and args.bert_weights and args.encoder != "bert":
        parser.error("--bert_weights requires --encoder bert")
    return args


def check_degenerate(loss: str, na_rate: int, force: bool) -> None:
    """MSE over the sigmoid scores at na_rate >= 3 falls into the all-NOTA
    optimum and stays there (the JAX ``_check_degenerate``): training
    runs opt in with --force."""
    if loss == "mse" and na_rate >= 3 and not force:
        raise ValueError(
            f"--loss mse with --na_rate {na_rate} is a known-degenerate combination (the "
            "sigmoid-MSE objective's all-NOTA optimum dominates at high NOTA rates and "
            "training collapses to it). Use --loss ce, lower --na_rate, or pass --force "
            "to run it anyway"
        )


def check_adv(cfg) -> None:
    """Refuse by name what the adversarial step cannot train (the JAX
    refusals, cli.py:812-814, :1004, :1086)."""
    if not cfg.adv:
        return
    if cfg.embed_optimizer == "lazy":
        raise ValueError("--embed_optimizer lazy does not combine with --adv (the DANN step); "
                         "use --embed_optimizer shared there")
    if cfg.feature_cache:
        raise ValueError("--feature_cache excludes --adv: the domain game trains the encoder, "
                         "which the cache freezes out of the step")
    if cfg.token_cache:
        raise ValueError("--token_cache does not serve --adv (the DANN domain samplers stream "
                         "separate unlabeled instances)")
    if cfg.model == "pair":
        raise ValueError("--adv does not serve --model pair (it scores sentence pairs; the "
                         "domain game needs a sentence encoder)")


def config_from_args(args):
    """The run's ExperimentConfig. Refused before anything is built:
    ``--feature_cache`` with ``--token_cache``, ``--token_cache`` with
    ``--model pair``, and for training a feature cache off frozen BERT, an
    ``--embed_optimizer`` other than shared on the BERT paths and ``--adv``
    with lazy, the feature cache, the token cache or ``--model pair``."""
    from induction_network_on_fewrel_tpu_torch.config import (
        ADAPT_KNOBS,
        ExperimentConfig,
        resolve_adapt_policy,
    )
    from induction_network_on_fewrel_tpu_torch.models.build import check_feature_cache
    from induction_network_on_fewrel_tpu_torch.sampling.index import check_sampler_backend
    from induction_network_on_fewrel_tpu_torch.train.steps import check_embed_optimizer

    check_sampler_backend(args.sampler)
    if args.feature_cache and args.token_cache:
        raise ValueError("--token_cache and --feature_cache are exclusive (the feature cache "
                         "already runs in index mode)")
    if args.token_cache and args.model == "pair":
        raise ValueError("--token_cache does not serve --model pair (pair consumes token pairs)")
    training = hasattr(args, "train_iter") and not args.only_test
    if training:
        check_degenerate(args.loss, args.na_rate, args.force)
    kw = dict(
        train_n=args.trainN or args.N, n=args.N, k=args.K, q=args.Q, na_rate=args.na_rate,
        nota_head=args.nota_head, batch_size=args.batch_size, max_length=args.max_length,
        vocab_size=args.vocab_size, model=args.model, proto_metric=args.proto_metric,
        gnn_dim=args.gnn_dim, gnn_blocks=args.gnn_blocks, snail_tc_filters=args.snail_tc_filters,
        bert_frozen=args.bert_frozen, bert_layers=args.bert_layers, bert_hidden=args.bert_hidden,
        bert_heads=args.bert_heads, bert_intermediate=args.bert_intermediate,
        bert_vocab_size=args.bert_vocab_size, bert_vocab_path=args.bert_vocab,
        bert_remat=args.bert_remat, bert_weights=args.bert_weights,
        feature_cache=args.feature_cache,
        encoder=args.encoder, hidden_size=args.hidden_size, tfm_layers=args.tfm_layers,
        tfm_model=args.tfm_model, tfm_heads=args.tfm_heads, tfm_ff=args.tfm_ff,
        moe_experts=args.moe_experts, moe_top_k=args.moe_top_k, moe_capacity=args.moe_capacity,
        moe_every=args.moe_every, moe_group_size=args.moe_group_size,
        moe_aux_weight=args.moe_aux_weight, tfm_stacked=args.tfm_stacked or args.pp > 1,
        pp=args.pp, pp_microbatches=args.pp_microbatches,
        lstm_hidden=args.lstm_hidden, induction_dim=args.induction_dim,
        routing_iters=args.routing_iters, ntn_slices=args.ntn_slices, lstm_cs_window=args.lstm_cs_window,
        lstm_residuals=args.lstm_residuals, lstm_backend=args.lstm_backend,
        attn_backend=args.attn_backend,
        compute_dtype="bfloat16" if args.bf16 or args.fp16 else "float32",
        loss=args.loss, optimizer=args.optimizer, embed_optimizer=args.embed_optimizer,
        lr=args.lr, weight_decay=args.weight_decay, lr_step_size=args.lr_step_size,
        grad_clip=args.grad_clip, steps_per_call=args.steps_per_call,
        eval_steps_per_call=args.eval_steps_per_call,
        metric_window_calls=args.metric_window_calls, test_iter=args.test_iter,
        token_cache=args.token_cache, ckpt_delta=args.ckpt_delta,
        divergence_guard=args.divergence_guard, sampler=args.sampler, prefetch=args.prefetch,
        sampler_threads=args.sampler_threads, prefetch_depth=args.prefetch_depth,
        mixture=args.mixture, feed_fault=getattr(args, "feed_fault", ""), seed=args.seed,
        ckpt_stage=args.ckpt_stage, watchdog=getattr(args, "watchdog", False),
        perf=getattr(args, "perf", False), nan_inject_step=getattr(args, "nan_inject_step", 0),
        chaos=getattr(args, "chaos", ""), dp=args.dp, ep=args.ep, tp=args.tp, sp=args.sp,
        zero_opt=args.zero_opt,
        compact_demb=args.compact_demb, grad_bucketing=args.grad_bucketing,
        grad_bucket_count=args.grad_bucket_count, async_collectives=args.async_collectives,
    )
    if hasattr(args, "train_iter"):
        kw.update(train_iter=args.train_iter, val_iter=args.val_iter, val_step=args.val_step,
                  grad_probe_every=args.grad_probe_every, fault_step=args.fault_step,
                  adv=args.adv is not None, adv_lambda=args.adv_lambda,
                  adv_dis_hidden=args.adv_dis_hidden, adv_batch=args.adv_batch,
                  adapt=args.adapt,
                  # Knobs left unset keep the defaults; the whole policy is
                  # validated below, so a bad knob fails at run start, not
                  # when the first drift CRITICAL tries to use it.
                  **{k: v for k in ADAPT_KNOBS if (v := getattr(args, k)) is not None})
    else:                   # the JAX test entry point's config: no training loop
        kw.update(train_iter=0, val_step=0)
    cfg = ExperimentConfig(**kw)
    resolve_adapt_policy(cfg)       # knob validation (a no-op when off)
    if training:
        check_adv(cfg)
        check_feature_cache(cfg)
        check_embed_optimizer(cfg)
    if training and cfg.embed_optimizer == "lazy":
        from induction_network_on_fewrel_tpu_torch.train.lazy_embed import require_adam

        require_adam(cfg)
        if not cfg.token_cache:
            warnings.warn(
                "--embed_optimizer lazy without --token_cache deduplicates every batch's word "
                "ids on the card (a sort per step); add --token_cache for the precomputed "
                "corpus remap, whose catch-up and write-back run once per fused call",
                stacklevel=2,
            )
    return cfg


def load_vocab(args, cfg):
    """The --glove file, or the synthetic GloVe fixture of the config's
    vocab_size and word_dim."""
    from induction_network_on_fewrel_tpu_torch.data import load_glove, make_synthetic_glove

    if getattr(args, "glove", None):
        return load_glove(args.glove, args.glove_mat)
    return make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim)


def load_data(cfg, split: str, args=None):
    """A split's FewRel-schema file, else the synthetic split (seeds 0/1/2
    for train/val/test, the JAX sizes)."""
    from induction_network_on_fewrel_tpu_torch.data import load_fewrel_json, make_synthetic_fewrel

    path = getattr(args, f"{split}_file", None) if args is not None else None
    if path:
        if not os.path.isfile(path):
            raise FileNotFoundError(f"--{split}_file {path}: no such file")
        return load_fewrel_json(path)
    return make_synthetic_fewrel(
        num_relations=max(cfg.train_n, cfg.n) * 2,
        instances_per_relation=max(cfg.k + cfg.q + 5, 20),
        vocab_size=cfg.vocab_size - 2,
        seed={"train": 0, "val": 1, "test": 2}[split],
    )


def make_tokenizer(args, cfg):
    """(tokenizer, cfg, GloVe vectors or None): ``BertTokenizer`` for the
    BERT paths (a ``--bert_vocab`` file sets ``bert_vocab_size``; no GloVe is
    loaded), else the GloVe tokenizer over ``load_vocab``, which sets
    ``vocab_size`` and ``word_dim``."""
    from induction_network_on_fewrel_tpu_torch.data import BertTokenizer, GloveTokenizer

    if cfg.encoder == "bert":
        tok = BertTokenizer(cfg.max_length, vocab_path=cfg.bert_vocab_path,
                            vocab_size=cfg.bert_vocab_size)
        return tok, cfg.replace(bert_vocab_size=tok.vocab_size), None
    vocab = load_vocab(args, cfg)
    if (cfg.vocab_size, cfg.word_dim) != (vocab.vocab_size, vocab.word_dim):
        cfg = cfg.replace(vocab_size=vocab.vocab_size, word_dim=vocab.word_dim)
    return GloveTokenizer(vocab, max_length=cfg.max_length), cfg, vocab.vectors


def bert_backbone_model(cfg, device):
    """The full BERT model of ``cfg`` from its seed, with ``bert_weights``
    (if any) copied into its backbone."""
    from induction_network_on_fewrel_tpu_torch.models.bert import load_hf_weights
    from induction_network_on_fewrel_tpu_torch.models.build import build_model

    model = build_model(cfg.replace(feature_cache=False), device=device)
    if cfg.bert_weights:
        load_hf_weights(model if cfg.model == "pair" else model.encoder, cfg.bert_weights)
        print(f"loaded BERT weights from {cfg.bert_weights}", file=sys.stderr)
    return model


def dp_mesh(args, cfg):
    """The run's mesh, or None for one process (the JAX ``use_mesh``).
    Launched by torchrun, every rank joins the process group
    (``parallel.distributed``: NCCL on the card, gloo with ``--device cpu``)
    and the mesh is the whole world or ``--dp`` ranks of it by ``--pp``,
    ``--ep``, ``--tp`` and ``--sp`` (the JAX axis order); without a
    launcher ``--dp`` 0 or 1 with every other axis at 1 is the
    single-process run and more raises. Refused by name under a mesh: the
    live lazy path, an episode batch or an ``--adv`` instance batch that
    does not divide over the dp ranks (the JAX text), a sharded axis that
    does not divide over tp or sp (where JAX raises), under pp an encoder
    call's rows per dp shard that do not split into ``--pp_microbatches``
    (the JAX row check; an ``--adv`` instance batch with the JAX
    ``gpipe_local`` text), and ``--adv`` under sp (``ADV_SP``)."""
    from induction_network_on_fewrel_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
    )
    from induction_network_on_fewrel_tpu_torch.parallel.mesh import make_mesh
    from induction_network_on_fewrel_tpu_torch.parallel.tensor import check_tp_sizes

    if not maybe_initialize_distributed(device=args.device) and cfg.dp in (0, 1) \
            and cfg.pp == cfg.ep == cfg.tp == cfg.sp == 1:
        return None
    mesh = make_mesh(dp=cfg.dp or None, pp=cfg.pp, ep=cfg.ep, tp=cfg.tp, sp=cfg.sp)
    if cfg.embed_optimizer == "lazy" and not cfg.token_cache:
        raise ValueError(
            "--embed_optimizer lazy does not combine with a device mesh on the LIVE token path "
            "(combine --dp/--tp/... with --token_cache instead); use --embed_optimizer shared "
            "there")
    dp = mesh.dp
    if cfg.batch_size % dp != 0:
        raise ValueError(
            f"--batch_size {cfg.batch_size} must be divisible by the "
            f"data-parallel mesh axis dp={dp} (episodes are sharded "
            f"over dp); try --batch_size {((cfg.batch_size // dp) + 1) * dp} "
            f"or --dp {cfg.batch_size}"
        )
    if cfg.adv and cfg.adv_batch % dp != 0:
        raise ValueError(
            f"--adv_batch {cfg.adv_batch} must be divisible by the data-parallel mesh axis "
            f"dp={dp} (the source and target instances are sharded over dp); try "
            f"--adv_batch {((cfg.adv_batch // dp) + 1) * dp}")
    check_tp_sizes(cfg, mesh.tp)
    if mesh.sp > 1:
        if cfg.max_length % mesh.sp:
            raise ValueError(f"--max_length ({cfg.max_length}) must be divisible by --sp "
                             f"({mesh.sp}): the token axis shards over sp")
        if cfg.adv:
            raise ValueError(ADV_SP)
    if mesh.pp > 1:
        from induction_network_on_fewrel_tpu_torch.parallel.hostfeed import check_pipeline_rows
        from induction_network_on_fewrel_tpu_torch.parallel.pipeline import microbatch_refusal

        check_pipeline_rows(cfg, dp)
        why = microbatch_refusal(cfg.adv_batch // dp, cfg.pp_microbatches) if cfg.adv else None
        if why:
            raise ValueError(f"--adv instance batches: {why}")
    return mesh


# The port's refusal of --adv under sp (ROADMAP queue A lists it).
ADV_SP = ("--adv with --sp above 1 is not ported: the domain game's instance batches would need "
          "their token columns split and their discriminator fed the pooled rows (ROADMAP queue "
          "A item 4, sp x adv)")


def make_trainer(args, cfg, only_test: bool = False, mesh=None):
    """(trainer, test split): vocabulary and data, model (built on
    ``args.device``), samplers (index samplers and device token tables with
    --token_cache, feature tables with --feature_cache) and logger. A GloVe
    file sets the config's vocab_size and word_dim, a --bert_vocab file its
    bert_vocab_size (``trainer.cfg``). ``only_test`` builds the test split's
    (sampler, table or None) and no train/val samplers, logger file or
    checkpoint manager; otherwise the test split is None.

    On the BERT paths ``--bert_weights`` goes into the backbone before any
    step or encoding. With --feature_cache the backbone's full model is
    built from the seed (and the weights) to encode the splits, and the
    trainer's model is the head alone.

    The train sampler is ``--sampler``'s (auto: the C++ sampler, with its
    ring of ``--prefetch`` batches on the live token path), or a
    ``MixtureSampler`` of ring-free children under ``--mixture`` (under a
    mesh the rank's own children behind one ``PerRankSampler``), wrapped in
    a ``PipelineFeed`` of depth ``--prefetch_depth`` (units of
    steps_per_call batches where the sampler fills fused blocks) with the
    ``--feed_fault`` plan. Val and test samplers are synchronous and, under
    auto, the numpy ones.

    Under a dp ``mesh`` each rank samples its own ``B/dp`` episodes a
    batch from its own stream (``parallel.hostfeed.process_seed``) behind a
    ``PerRankSampler`` that reports the global batch; only rank 0 logs to
    the run directory and writes checkpoints."""
    from induction_network_on_fewrel_tpu_torch.datapipe import FeedFaults, PipelineFeed
    from induction_network_on_fewrel_tpu_torch.models.build import build_model
    from induction_network_on_fewrel_tpu_torch.sampling.native import (
        make_index_sampler,
        make_sampler,
    )
    from induction_network_on_fewrel_tpu_torch.train.feature_cache import build_feature_table
    from induction_network_on_fewrel_tpu_torch.train.framework import FewShotTrainer
    from induction_network_on_fewrel_tpu_torch.train.token_cache import build_token_table
    from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

    for split in ("train", "val", "test"):
        path = getattr(args, f"{split}_file", None)
        if path and not os.path.isfile(path):
            raise FileNotFoundError(f"--{split}_file {path}: no such file")
    if cfg.mixture and (cfg.token_cache or cfg.feature_cache) and not only_test:
        raise ValueError("--mixture does not combine with --token_cache or --feature_cache (an "
                         "index sampler is bound to one split's device table); drop one of them")
    tok, cfg, vectors = make_tokenizer(args, cfg)
    encoder_model = None
    if cfg.feature_cache:
        encoder_model = bert_backbone_model(cfg, args.device)
        model = build_model(cfg, device=args.device)
    elif cfg.encoder == "bert" and not only_test:
        model = bert_backbone_model(cfg, args.device)
    else:
        model = build_model(cfg, glove_init=vectors, device=args.device)

    batch, rank0 = cfg.batch_size, mesh is None or mesh.main

    def per_rank(sampler):
        return sampler if mesh is None else PerRankSampler(sampler, cfg.batch_size)

    if mesh is not None:
        from induction_network_on_fewrel_tpu_torch.parallel.hostfeed import (
            PerRankSampler,
            local_episode_range,
            process_seed,
        )

        batch = local_episode_range(mesh, cfg.batch_size)[1]

    def seeded(seed):
        return seed if mesh is None else process_seed(seed, mesh.rank)

    def live(ds, n, seed, train=False, prefetch=0, local=False):
        sampler = make_sampler(ds, tok, n, cfg.k, cfg.q, batch_size=batch, na_rate=cfg.na_rate,
                               seed=seeded(seed), backend=cfg.sampler, prefetch=prefetch,
                               num_threads=cfg.sampler_threads, eval=not train)
        return sampler if local else per_rank(sampler)

    datasets = {}

    def split_of(split, n, seed, lazy=False, train=False):
        ds = datasets[split] = load_data(cfg, split, args)
        if encoder_model is not None:
            table = build_feature_table(encoder_model, ds, tok)
            print(f"feature cache: {split} split, {table.rows} rows tokenized in "
                  f"{table.tokenize_s:.3f} s, encoded in {table.encode_s:.3f} s, a "
                  f"{table.nbytes}-byte table", file=sys.stderr)
        elif not cfg.token_cache:
            return live(ds, n, seed, train, cfg.prefetch if train and not cfg.mixture else 0), None
        else:
            table = build_token_table(ds, tok, model.device, lazy=lazy)
        return per_rank(make_index_sampler(table.sizes, n, cfg.k, cfg.q, batch_size=batch,
                                           na_rate=cfg.na_rate, seed=seeded(seed),
                                           backend=cfg.sampler, eval=not train)), table

    if only_test:
        trainer = FewShotTrainer(model, cfg, None, logger=MetricsLogger(None, quiet=not rank0),
                                 mesh=mesh)
        return trainer, split_of("test", cfg.n, cfg.seed + 2)
    train_s, train_t = split_of("train", cfg.train_n, cfg.seed, train=True,
                                lazy=cfg.embed_optimizer == "lazy")
    if cfg.mixture:
        train_s = mixture_sampler(cfg, args, train_s, live, mesh)
    # The adversarial loop draws single batches (the JAX draw order).
    unit = cfg.steps_per_call if cfg.steps_per_call > 1 and hasattr(train_s, "sample_fused") \
        and not cfg.adv else 1
    train_s = PipelineFeed(train_s, prefetch_depth=cfg.prefetch_depth, unit=unit,
                           faults=FeedFaults.parse(cfg.feed_fault),
                           stream_tag=f"mixture={cfg.mixture};seed={cfg.seed}",
                           process=(mesh.rank, mesh.dp) if mesh is not None else None)
    val_s, val_t = split_of("val", cfg.n, cfg.seed + 1)
    adv = adv_pieces(args, cfg, tok, datasets["train"], model, mesh) if cfg.adv else None
    run_dir = args.run_dir or args.save_ckpt
    if rank0:
        logger = MetricsLogger(run_dir, tensorboard_dir=args.tensorboard)
        obs = telemetry(cfg, run_dir, logger, train_t if cfg.embed_optimizer == "lazy" else None)
    else:
        logger = MetricsLogger(None, quiet=True)
        obs = {}
    trainer = FewShotTrainer(model, cfg, train_s, val_s, ckpt_dir=args.save_ckpt,
                             logger=logger, train_table=train_t, val_table=val_t, adv=adv,
                             profile_dir=args.profile if rank0 else None,
                             profile_steps=args.profile_steps, debug_nans=args.debug_nans,
                             mesh=mesh, **obs)
    return trainer, None


def telemetry(cfg, run_dir, logger, lazy_table=None) -> dict:
    """The trainer's telemetry (the JAX ``cli.py:1333-1421``): with
    ``cfg.watchdog`` a FlightRecorder (dumping on SIGTERM) and a
    HealthWatchdog; with ``cfg.perf`` a CompileWatcher (its bursts on the
    watchdog) and a PerfObserver (its criticals on the watchdog, a span
    snapshot captured into ``run_dir``; a BiLSTM run's floor projected at
    the H100's rates). ``cfg.chaos`` installs its plan (``obs/chaos.py``);
    ``close_telemetry`` removes it and the SIGTERM handler."""
    from induction_network_on_fewrel_tpu_torch import obs

    watchdog = recorder = None
    if cfg.watchdog:
        recorder = obs.FlightRecorder(out_dir=run_dir)
        recorder.install_sigterm_handler()
        watchdog = obs.HealthWatchdog(recorder=recorder)
    if cfg.chaos:
        reg = obs.ChaosRegistry.parse(cfg.chaos, logger=logger)
        if reg is not None:
            reg.install()
            print(f"chaos plan armed: {cfg.chaos}", file=sys.stderr)
    perf = compile_watcher = None
    if cfg.perf:
        capture = (obs.DiagnosticsCapture(out_dir=run_dir, recorder=None, profile=False)
                   if run_dir is not None else None)
        floor_ms = None
        if cfg.encoder == "bilstm":
            from induction_network_on_fewrel_tpu_torch.utils.roofline import projected_floor_ms

            floor_ms = projected_floor_ms(
                cfg, corpus_rows=len(lazy_table.uids) if lazy_table is not None else None)
        compile_watcher = obs.CompileWatcher(logger=logger).install()
        if watchdog is not None:
            obs.bind_health(compile_watcher, watchdog._emit)
        perf = obs.PerfObserver(logger=logger, compile_watcher=compile_watcher, capture=capture,
                                on_event=watchdog._emit if watchdog is not None else None,
                                floor_ms=floor_ms)
    return {"watchdog": watchdog, "recorder": recorder, "perf": perf,
            "compile_watcher": compile_watcher}


def close_telemetry(trainer) -> None:
    """Remove what ``telemetry`` installed process-wide: the chaos plan and
    the recorder's SIGTERM handler."""
    from induction_network_on_fewrel_tpu_torch.obs.chaos import install

    install(None)
    if trainer.recorder is not None:
        trainer.recorder.uninstall_sigterm_handler()


def adv_pieces(args, cfg, tok, train_ds, model, mesh=None):
    """The adversarial loop's ``AdvPieces``: the target domain (``--adv``'s
    FewRel-schema file, or for bare ``--adv`` the JAX package's synthetic
    target, seed 97), a fresh discriminator (``init_disc_state``) and the
    source and target ``InstanceSampler``s (seeds seed+31 and seed+32).
    Under a dp ``mesh`` the samplers are this rank's: ``adv_batch/dp``
    instances a batch, their seeds through ``process_seed``."""
    from induction_network_on_fewrel_tpu_torch.data import load_fewrel_json, make_synthetic_fewrel
    from induction_network_on_fewrel_tpu_torch.models.build import encoder_output_dim
    from induction_network_on_fewrel_tpu_torch.sampling.episodes import InstanceSampler
    from induction_network_on_fewrel_tpu_torch.train.framework import AdvPieces
    from induction_network_on_fewrel_tpu_torch.train.steps import init_disc_state

    if args.adv != "synthetic":
        if not os.path.isfile(args.adv):
            raise FileNotFoundError(f"--adv {args.adv}: no such file")
        tgt_ds = load_fewrel_json(args.adv)
    else:
        # A synthetic "other domain": its own seed, so the discriminator has
        # a real signal to separate.
        tgt_ds = make_synthetic_fewrel(
            num_relations=max(cfg.train_n, cfg.n) * 2,
            instances_per_relation=max(cfg.k + cfg.q + 5, 20),
            vocab_size=cfg.vocab_size - 2, seed=97)
    rows, seeded = cfg.adv_batch, (lambda seed: seed)
    if mesh is not None:
        from induction_network_on_fewrel_tpu_torch.parallel.hostfeed import process_seed

        rows, seeded = cfg.adv_batch // mesh.dp, (lambda seed: process_seed(seed, mesh.rank))
    return AdvPieces(
        disc=init_disc_state(cfg, encoder_output_dim(cfg), model.device),
        src_sampler=InstanceSampler(train_ds, tok, rows, seed=seeded(cfg.seed + 31)),
        tgt_sampler=InstanceSampler(tgt_ds, tok, rows, seed=seeded(cfg.seed + 32)))


def mixture_sampler(cfg, args, train_sampler, live, mesh=None):
    """The ``--mixture`` schedule's ``MixtureSampler``: ``train`` is the run's
    train sampler (built without the C++ ring: the feed is the pipeline),
    ``synthetic[:SEED]`` a synthetic split (seed 83 by default) and any
    other source a FewRel-schema JSON file; each other source's stream is
    seeded by its position (seed + 1000 + i).

    Under a dp ``mesh`` every rank builds the mixture with the same seed,
    so all ranks pick the same source for batch i (the meaning of the JAX
    one-process mesh, where the whole batch comes from one source); each
    child is the rank's own ``B/dp``-episode sampler from its
    ``process_seed`` stream, and the mixture sits behind one
    ``PerRankSampler``, whose ``feed_state`` carries the mixture's index
    and the children's states."""
    from induction_network_on_fewrel_tpu_torch.data import load_fewrel_json, make_synthetic_fewrel
    from induction_network_on_fewrel_tpu_torch.datapipe import MixtureSampler, MixtureSchedule

    schedule = MixtureSchedule.parse(cfg.mixture)
    if mesh is not None:
        train_sampler = train_sampler.local
    if "train" not in schedule.names and hasattr(train_sampler, "close"):
        train_sampler.close()
    children = []
    for i, name in enumerate(schedule.names):
        if name == "train":
            children.append((name, train_sampler))
            continue
        if name.startswith("synthetic"):
            _, _, sseed = name.partition(":")
            ds = make_synthetic_fewrel(
                num_relations=max(cfg.train_n, cfg.n) * 2,
                instances_per_relation=max(cfg.k + cfg.q + 5, 20),
                vocab_size=cfg.vocab_size - 2, seed=int(sseed or 83))
        else:
            ds = load_fewrel_json(name)
        children.append((name, live(ds, cfg.train_n, cfg.seed + 1000 + i, train=True,
                                    local=True)))
    mixture = MixtureSampler(children, schedule, seed=cfg.seed)
    if mesh is None:
        return mixture
    from induction_network_on_fewrel_tpu_torch.parallel.hostfeed import PerRankSampler

    return PerRankSampler(mixture, cfg.batch_size)


def print_result(metrics: dict, key: str) -> None:
    """Human line (stderr, with the ±CI bar) + one JSON line (stdout); on
    rank 0 only under data parallel."""
    from induction_network_on_fewrel_tpu_torch.parallel.distributed import is_main
    from induction_network_on_fewrel_tpu_torch.utils.metrics import json_sanitize

    if not is_main():
        return

    acc, ci = metrics["accuracy"], metrics.get("acc_ci95", 0.0)
    print(f"{key.replace('_', ' ')}: {acc:.4f} ± {ci:.4f} (95% CI)", file=sys.stderr)
    out = {key: acc, "acc_ci95": ci}
    out.update({k: v for k, v in metrics.items() if k not in ("accuracy", "acc_ci95")})
    print(json.dumps({k: json_sanitize(round(v, 4) if isinstance(v, float) else v)
                      for k, v in out.items()}), flush=True)


def _merge_ckpt_architecture(cfg, src: str):
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager

    try:
        saved = CheckpointManager.load_config(src)
    except FileNotFoundError:
        return cfg
    merged = cfg.merge_architecture_from(saved)
    if merged.feature_cache and saved.seed != cfg.seed:
        # The head was trained on the features of the backbone drawn from
        # the checkpoint's seed; another seed would encode with another one.
        raise ValueError(f"{src} is a feature-cache checkpoint: its backbone is rebuilt from "
                         f"its seed, pass --seed {saved.seed} (got {cfg.seed})")
    if merged != cfg:
        print(f"using architecture from {src}/config.json", file=sys.stderr)
    return merged


def train_main(argv=None) -> int:
    """Train (``--resume`` continues the newest intact state of
    ``--load_ckpt`` or else ``--save_ckpt``; ``--load_ckpt`` alone starts
    from that directory's best weights and optimizer state), then report the
    best checkpoint's val accuracy; with ``--only_test``, restore as above
    and report the test accuracy instead."""
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager

    args = parse_args(train=True, argv=argv)
    cfg = config_from_args(args)
    if args.load_ckpt:
        cfg = _merge_ckpt_architecture(cfg, args.load_ckpt)
        if not args.only_test:      # the checkpoint's config.json may bring back mse
            check_degenerate(cfg.loss, cfg.na_rate, args.force)
    mesh = dp_mesh(args, cfg)
    trainer, test_split = make_trainer(args, cfg, only_test=args.only_test, mesh=mesh)
    cfg = trainer.cfg
    try:
        start_step = 0
        if args.resume:
            src = args.load_ckpt or args.save_ckpt
            own = trainer.ckpt is not None and src == args.save_ckpt
            mngr = trainer.ckpt if own else CheckpointManager(src, cfg)
            try:
                start_step, extra = mngr.restore_latest(trainer.model, trainer.opt, trainer.lazy)
                trainer.best_val = extra["best_val"]
                trainer.restore_sampler_states(extra["samplers"])
                print(f"restored latest checkpoint step={start_step} from {src}",
                      file=sys.stderr)
            except FileNotFoundError:
                if args.load_ckpt:
                    raise
                print(f"no checkpoint in {src}; starting fresh", file=sys.stderr)
        elif args.load_ckpt:
            step = CheckpointManager(args.load_ckpt).restore_best(trainer.model, trainer.opt,
                                                                  trainer.lazy)
            print(f"restored best checkpoint step={step} from {args.load_ckpt}", file=sys.stderr)
        if args.only_test:
            sampler, source = test_split
            trainer.val_sampler = sampler           # closed with the trainer
            metrics = trainer.evaluate(cfg.test_iter, return_metrics=True, source=source)
            print_result(metrics, "test_accuracy")
            return 0
        trainer.train(cfg.train_iter, start_step=start_step)
        if trainer.saved_best:
            step = trainer.reader().restore_best(trainer.model)
            if trainer.main:
                print(f"final eval from best checkpoint (step {step})", file=sys.stderr)
        print_result(trainer.evaluate(cfg.val_iter, return_metrics=True), "final_val_accuracy")
        return 0
    finally:
        try:
            trainer.close()
        finally:
            close_telemetry(trainer)


def test_main(argv=None) -> int:
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager

    args = parse_args(train=False, argv=argv)
    src = args.load_ckpt or args.save_ckpt
    if not os.path.isdir(src):
        print("test needs --load_ckpt (or an existing --save_ckpt dir)", file=sys.stderr)
        return 2
    cfg = _merge_ckpt_architecture(config_from_args(args), src)
    trainer, (sampler, source) = make_trainer(args, cfg, only_test=True, mesh=dp_mesh(args, cfg))
    trainer.val_sampler = sampler                   # closed with the trainer
    try:
        mngr = CheckpointManager(src, logger=trainer.logger)
        which = "best" if mngr.has("best") else "latest"
        step = mngr.restore(which, trainer.model)
        print(f"loaded {which} checkpoint step={step} from {src}", file=sys.stderr)
        metrics = trainer.evaluate(trainer.cfg.test_iter, sampler=sampler, return_metrics=True,
                                   source=source)
        trainer.logger.log(step, "test", **metrics)
        print_result(metrics, "test_accuracy")
        return 0
    finally:
        trainer.close()


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("train", "test"):
        print("usage: python -m induction_network_on_fewrel_tpu_torch.cli {train,test} [flags]",
              file=sys.stderr)
        return 2
    from induction_network_on_fewrel_tpu_torch.parallel.distributed import launched, shutdown

    try:
        return (train_main if argv[0] == "train" else test_main)(argv[1:])
    finally:
        if launched():
            shutdown()


if __name__ == "__main__":
    sys.exit(main())
