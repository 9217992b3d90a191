#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port's serving and training paths, at full width.

    python3 chip_smoke.py                # from the root of a checkout, one CUDA card
    python3 chip_smoke.py --phases 2,17  # the build, the named phases (and the
                                         # phases whose results they need,
                                         # PHASE_NEEDS), the final lines

Phases (each prints its lines; any failed check raises and the process
exits non-zero; no phase catches a failure of its own):

1. Environment: torch / CUDA versions and the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``).
2. Build: compile every CUDA source in ``csrc/`` with nvcc (sm_90a), one
   process per source, all started together; then the C++ episode sampler
   (``csrc/episode_sampler.cpp``) with g++.
3. Kernel vs plain PyTorch version on the card at the flagship widths
   (L=40, D=60, u=128, 2u=256, A=64) for M in {1, 4, 16, 25, 200} (serving
   buckets, a 5x5 registration, a val/test batch), f32 and bf16, ragged
   row tiles, partial and fully masked rows; kernel, plain and library
   times (CUDA events) and the byte/operation bound. K1's library
   yardstick is cuDNN's f32 ``nn.LSTM`` run as K1 runs, ``.eval()`` under
   ``torch.no_grad()``; its train-mode forward is printed beside it. Each
   forward row prints its cluster launch plan (TM, C, CTAs), each K2 row
   its plan (ops/attn.py:attn_fwd_plan).
4. Main path: the flagship model (400 002 x 50 synthetic GloVe table, bf16
   encoder, f32 head, seeded fresh init) behind ``InferenceEngine``: one
   tenant of 5 relations registered at K=5 (tier 8), its query graphs
   captured at ``warmup``, 64 requests answered through ``classify_batch``
   in buckets 1, 4 and 16 as graph replays. The kernels' launch counts are
   zeroed just before and read just after; both must have launched (the
   distil, and the graphs' warm-ups and captures). Logits are held against
   an engine on the same weights with the plain ("reference") backends on
   the same card; request latency per bucket and the host split.
4b. (run after phase 10, on phase 9's best checkpoint) A correctness load
   through the continuous batcher: ~400 requests in bursts of 1-16 for two
   tenants of different N (tiers 4 and 8), a tier-crossing registration
   (tier 16, captured during traffic) and a ``publish_params`` mid-run;
   nothing shed, dropped or degraded, no capture after warmup but the
   crossing's, every verdict's logits the eager scoring of its query on
   its own snapshot's weights; a profiled window with one K1 and one K2
   launch per executed batch; each bucket's graph replay vs the eager
   ``QueryRunner`` at f32. Its rate is no measurement.
4c. In a process of its own (``chip_smoke.py --sweep``, which holds only
   the serving plane), an engine on the checkpoint with tenants of 9 and 6
   relations: its capacity on single-query requests from one client
   thread (served/s with 64 closed-loop clients), then Poisson arrivals at
   30, 60 and 90 % of it, 2 s each: offered and served/s, queue depth,
   shed, latency p50/p99 overall and per bucket (p99 only from 50 requests
   up), the host split per batch, the longest gap between completions and
   the garbage collector's pauses.
4a. ``serve_main`` on the checkpoint, on the card, with a synthetic support
   file and query file in a temp dir, tiers on, at resident f32, bf16 and
   int8 with K1/K2, then at f32 with the plain backends: every verdict
   served (no error, shed or degraded verdict, no capture after warmup),
   the kernels' wrapper counts zeroed before and read after; f32 logits
   and labels vs the plain backends; bf16 and int8 vs f32, each bar
   checked to lie between the sound residency's reading and a planted
   fault's (int8 scale 1 % high; bf16 vectors rounded through fp8).
5. Episode forward: B=4 episodes of 5-way 5-shot with 5 queries per class
   (200 encoder rows) through the kernels vs the plain backends.
6. Training kernels vs their plain versions: K7 (windowed BiLSTM forward),
   K8 (its backward: the cluster chain kernel, then the weight-gradient
   kernel ``lstm_wgrad``), K10 (attention forward with stats), K11
   (attention backward) at L=40, D=60, u=128, A=64, M in {16, 200} and a
   ragged M=100, f32 and bf16, W=8, a ragged window (W=6), both residual
   dtypes, a fully masked attention row; kernel, plain and library times
   and the bound. K8 and its cuDNN yardstick (f32 ``nn.LSTM`` forward +
   backward) are timed as the median of 5 repeats of 20 launches, with the
   spread printed. ``lstm_wgrad`` alone vs its plain version on the same
   da / h_prev streams (K8's hp and K6's shifted hs), timed.
6b. Attention kernels K2, K10, K11 vs their plain versions at M in {1, 4,
   16, 25, 200} at the flagship widths and at M in {16, 200} at D = 1280,
   A = 300 (past the old D <= 1024, A <= 256 limits), f32 and bf16, with a
   fully masked row (exact zeros, mx = -1e30, dn = 0) and K11 bitwise equal
   over two runs; times by CUDA events (``ms``) and the kernels' device
   time under torch.profiler (``device_ms``), the bound, the plain time and
   each launch's plan. K11 is two launches (token kernel, weight-gradient
   kernel) behind one wrapper call.
6c. The optimizer pair (``csrc/optim.cu``: ``optim_sumsq``, the global
   norm, and ``optim_update``, the clip, decay, moments and update of every
   tensor) vs the plain twin and the per-parameter loop on the flagship
   parameter list for every rule (adam, adamw, sgd) and word-table mode
   (shared, sgd, frozen; and adam_nodecay, the lazy table's rule and its
   dense twin's): the update within 1e-6 of each tensor's scale,
   the norm bitwise equal over two runs; times for Adam with a shared table
   beside the bound (bytes), the plain versions and the library yardsticks
   (``get_total_norm``, ``Adam(fused=True)``, and ``clip_grad_norm_`` +
   ``Adam(fused=True)`` against the pair).
6d. The segment sum (``ops/segsum.py:segsum``: the word table's gradient,
   ``index_add_`` into zeros, f32 atomics; a library call, not a hand
   kernel) vs its plain version ``index_put_`` with accumulate (it sorts
   the ids) on the flagship batch's word ids; both device times beside
   the bound.
7. Full-residual kernels vs their plain versions: K4 (BiLSTM forward
   writing c every step) and K6 (its backward over the saved hs/cs: chain
   kernel, then ``lstm_wgrad``) at L=40, D=60, u=128, M in {16, 200} plus
   a ragged M=100, f32 and bf16, both residual dtypes; f32 K6 gradients vs
   f32 K8 (W=8) on the same inputs; kernel, plain and library times (K6
   as K8) and the bound. Every backward row prints its chain plan (TM, C,
   CTAs).
8. Split recurrence (kernels 2, 1, 3): the public ops API
   ``lstm_recurrence_grouped`` (Gc=2) and ``bilstm_recurrence_tm`` at
   L=40, u=128, M in {16, 200}, f32 and bf16, without grad (kernel 2) and
   forward + backward under autograd (kernels 1 and 3, and lstm_wgrad
   after kernel 3), launch counts
   zeroed just before and read just after; then each output vs the plain
   versions, kernel 3 vs its plain version on the same residuals, the
   time-major layout vs the grouped one fed the flipped input; times and
   bounds; the library yardstick, an f32 cuDNN ``nn.LSTM`` whose identity
   input weights make it compute ``bilstm_recurrence_tm``, held against
   kernel 2 and timed.
9. Training main path: ``FewShotTrainer`` built by the CLI's wiring at the
   flagship config, on the input path before the host feed (``--sampler
   python --prefetch_depth 0``, as phases 9c and 9d) (bf16 encoder, 400 002-row table, mse, W=8, bf16
   checkpoints, Adam, shared table, B=4 episodes = 200 encoder rows per
   step): step-0 gradients of every parameter vs the plain backends (every
   encoder and embedding gradient finite and nonzero); one CUDA-graph step
   vs one eager step from the same weights on the same batch, and one
   replay of the S=4 graph vs four replays of the S=1 graph on the same 4
   batches (parameters, moments and count within 1e-6 of their scale; in
   the word table only the elements whose gradient is within the atomics'
   rounding of zero are left out, and the table must have moved far above
   that bar); the grad probe's cosine to the all-f32 plain reference above
   0.99; 20 steps as graph replays at steps_per_call 1 with a val pass
   (the eval graph: K1, K2) and a best-checkpoint save, and 20 at
   steps_per_call 4, each run under torch.profiler with the wrappers'
   counts zeroed just before and read just after: the wrappers count the
   warm-up's and the capture's calls, the profiler's kernel records count
   the launches (K7, K8, K10, K11, lstm_wgrad and the optimizer pair once
   per step plus once per graph's warm-up, K1/K2 once per val batch plus
   the eval graph's warm-up, K4/K6 never; no index_put_ sort); the same
   20 steps with the plain backends from the same weights (per-step
   losses, and the means of each fused call's 4, within a band); ms/step
   and episodes/s; then ``cli.test_main`` reloads the best checkpoint and
   evaluates. Then the profiles: 5 eager steps (the earlier path) and the
   graph at steps_per_call 1 and 4: unprofiled ms/step, the host split
   (sample, copy, replay), the graph's memory pool, and under
   torch.profiler the device busy time and launches per step and each
   hand kernel's launches per replay (one per step each).
10. Training at ``lstm_cs_window=0`` (the full-residual route; bf16
   encoder, bf16 residuals, otherwise the flagship): step-0 gradients vs
   the plain backends and their cosine to the W=8 kernel route from the
   same weights on the same batch, one graph step vs one eager step and
   one S=4 replay vs four S=1 replays, 10 steps as graph replays at
   steps_per_call 1 and 4 (two replays of 4, then a one-step tail graph
   twice) counted as in phase 9 (K4, K6, K10, K11, lstm_wgrad and the
   optimizer pair, K7/K8 never), the same steps with the plain backends
   (losses within a band), ms/step and episodes/s beside the W=8 figure,
   and the same profiles.
9c. Real-format files (``build/chip_smoke_real/``, removed at the end):
   FewRel-schema JSON splits at FewRel 1.0's sizes (64 train, 16 val and 16
   test relations of 700 instances, drawn from 50 000 words) and a GloVe
   word2id JSON + .npy of 400 000 x 50, written from the synthetic
   generators; the vocabulary and token ids they load to equal the
   generators'. ``cli.make_trainer`` on them with ``--trainN 10 --na_rate 1
   --nota_head stats --loss ce --steps_per_call 4`` (bf16, val every 10
   steps): 40 steps as graph replays under the profiler, launches counted
   as in phase 9; ``cli.train_main`` with ``--fault_step 20`` (it crashes
   before its step-20 boundary), then ``--resume`` from the ring's step 12
   to step 40, against the uninterrupted run (val accuracy within 2e-2 at
   every boundary, parameters within 5e-2 of scale: the shared table's
   gradient is f32 atomics); ``cli.test_main`` on the test file reports NOTA
   precision and recall; ms/step, episodes/s, host-to-device bytes a step
   and the graph's profile.
9d. ``--token_cache --embed_optimizer lazy`` on 9c's files, same flags:
   ``lazy_catchup`` and ``lazy_scatter`` (``csrc/lazy_embed.cu``) vs their
   plain versions on a 400 002 x 50 lazy state with gaps 0-1500 (beyond
   the 1024 cap), all-zero rows and pad lanes, at the corpus's R = U and a
   live batch's R, and the in-place materialize (never-touched rows
   bitwise); 20 lazy steps vs the dense twin (Adam with decay off the
   table only) from the same weights on the same batches (``hold_state``'s
   bars after 4 steps, losses within 2e-2 over 20; rows outside the corpus
   bitwise),
   and one lazy step under the profiler with shapes (no ``index_add_``, no
   fill of a [V, D] tensor); 40 steps through the trainer the CLI builds,
   under the profiler (the catch-up once per replay and per materialize,
   the write-back once per replay); the kernels' times at that run's state
   beside their bounds, plain versions and (write-back) four
   ``index_copy_``; host-to-device bytes a step beside 9c's; the ring: a
   base, then deltas (bytes against the base), a resume from the step-20
   delta equal to the uninterrupted run within 1e-6 of scale, a bit-flipped
   delta quarantined with the restore falling back to the base bitwise;
   ``register_tokens`` on the run's best checkpoint (offset-form rows) vs
   ``register`` on the same raw sentences; the graph's profile.
9e. The host feed (``datapipe/``, ``sampling/native.py``), on 9c's files,
   full width; files under ``build/chip_smoke_feed/``, removed at the end.
   (a) The flagship at phase 9's config through ``cli.make_trainer`` with
   the C++ sampler at depths 0 and 2: 20 steps as graph replays with a val
   pass, the wrappers' counts zeroed just before and read just after, launches by
   the profiler (the main path's kernels once a step, K1/K2 once a val
   batch), then the graph's profile: ms/step, episodes/s, host sampling
   ms, device busy, the card's share and the feed's stall share; the
   native runs' losses at depths 0 and 2 within 1e-6. (b) 9c and 9d with
   the C++ sampler at depth 2, the same columns, beside 9c's and 9d's.
   (c) phase 11b's proto/cnn through the CLI's trainer with the C++
   sampler at depth 2, beside its phase-11 row.
   (d) The JAX bench headline's shape: B=64, the token cache, lazy Adam
   on the 400 002 x 50 table, one graph of 128 steps, the C++ index
   sampler behind a feed at depths 0 and 2: episodes/s over
   hard-synced calls, the feed's stall share. (e) ``cli.train_main``
   (token cache, lazy, C++ sampler, depth 2) crashed by ``--fault_step``
   and resumed: its index batches equal the uninterrupted run's bitwise,
   its losses within 1e-6. A ``{"feed": ...}`` line holds (a)-(e).
11. (run after phase 4a) The few-shot model zoo at the flagship episode
   and step (bf16 encoder, f32 head, mse, W=8, Adam, shared table, 4 steps
   a replay), full width: 11a proto, proto_hatt, siamese, gnn, snail and
   metanet over the BiLSTM (u=128, A=64), 11b each over the CNN (230
   filters) and proto and gnn over the transformer (2 x 256, 4 heads, ff
   1024). Each: one S=4 replay vs four eager steps from the same weights
   (``hold_state``'s bars, cuDNN deterministic); the optimizer pair on
   the model's parameter list vs its plain twin; on the BiLSTM, each
   leaf's step-0 gradient within 5e-2 of its own scale (the leaves whose
   f32 gradient is rounding noise left out and printed) and 4 steps'
   losses within 2e-2 of the plain backends; 4 steps and a val pass (40 episodes)
   as graph replays with the wrappers' counts zeroed just before and read
   just after, launches by the profiler (K7, K8, K10, K11, lstm_wgrad and
   the optimizer pair once a step, K1 and K2 once a val batch; only the
   optimizer pair off the BiLSTM); ms/step, episodes/s, device busy and
   launches a step of the graph. 11c: ``cli.train_main`` for ``--model
   proto --encoder cnn --loss ce`` on phase 9c's files, 200 steps (the
   last metric window's mean loss below the first's), then ``cli.test_main`` on the test file (its
   accuracy printed, no bar: the data is synthetic). The phase's seconds.
13. (run after phase 11) BERT-base (12 layers x 768, 12 heads, FFN 3072,
   30 522 ids through the hash-fallback tokenizer, random weights from the
   seed) under the flagship's induction head, L=40, bf16 encoder, f32
   head, Adam, through the CLI's parsing and wiring. 13a fine-tuned, 5-way
   5-shot, Q=5, B=2 (100 rows, 4 000 tokens a step), 4 steps a replay: one
   S=4 replay vs four eager steps at ``hold_state``'s bars (the token
   table in the word table's place) and the same with ``--bert_remat``
   (S=2); every step-0 gradient finite and each backbone leaf's nonzero;
   the optimizer pair on BERT-base's 156 tensors vs its plain twin and
   loop at 1e-6 of scale, timed beside its bound and
   ``Adam(fused=True)``; 8 steps and a val pass as graph replays with the
   wrappers' counts zeroed just before and read just after, launches by
   the profiler (the pair once a step, no other hand kernel); ms/step,
   episodes/s, busy, launches, graph pool and peak memory; the step's
   matmul FLOPs beside the bf16 bound; one layer's attention core, plain
   vs ``scaled_dot_product_attention`` (a measurement only). 13b
   ``--bert_frozen`` on live tokens: no backbone leaf gets a loss
   gradient, one update moves the backbone by the decay term alone (the
   JAX chain's), then 8 steps as replays. 13c ``--bert_frozen
   --feature_cache`` through ``cli.train_main`` on 9c's files (train and
   val encoded once, 40 head steps, a checkpoint), then the same command
   line's trainer from ``cli.make_trainer``: the head-only state, the
   tokenize and encode seconds and rows/s beside the bound, 40 head steps
   as replays, the bytes sent a step; the backbone rebuilt from the
   checkpoint's config re-encodes the val split equal to the training
   encoder's table on 256 sampled rows (1e-6 of scale); ``cli.test_main``
   re-encodes and scores the test split (no bar: synthetic data); the
   serving engine refuses the checkpoint by name. 13d BERT-PAIR at FewRel
   2.0's pair shape (5-way 1-shot, Q=1, ``--na_rate 1``, B=4: 120
   sequences of 80 tokens), ce: one S=2 replay vs two eager steps, then 4
   steps as replays. 13e 13a's checkpoint through
   ``InferenceEngine.from_checkpoint``: one tenant of 5 relations at K=5,
   48 requests in buckets 1, 4 and 16 as graph replays, no capture after
   warmup, every verdict's logits vs the eager scoring at f32 residency
   (2e-2 of scale); p50 per bucket and the host split. The phase's
   seconds.
14. (run after phase 11) The rest of the single-card zoo, through the
   CLI's wiring (files under ``build/chip_smoke_slice6c/``, removed at the
   end). 14a: bare ``--adv`` (the JAX DANN defaults: 32 source and 32
   target instances a step from the seed-97 synthetic target, a 256-wide
   discriminator, lambda 1.0) at the flagship config through
   ``cli.make_trainer``: K7, K8, K10 and K11 vs their plain versions at
   M = 32, f32 and bf16, at phase 6's bars; every model and
   discriminator leaf's step-0 gradient within 5e-2 of its own scale
   against the plain backends (noise leaves left out and printed); one
   graph step vs one eager step and one S=4 replay vs four S=1 replays
   (``hold_state``'s bars, the discriminator's state within 1e-6); 20
   steps and a val pass as graph replays at spc 1, and 20 at spc 4, under
   the profiler (K7, K8, ``lstm_wgrad``, K10 and K11 three times a step,
   the optimizer pair twice, K1/K2 once a val batch), losses and domain
   losses within 2e-2 of the plain backends; the best checkpoint holds the
   plain model's leaves alone, and ``cli.test_main`` on it runs K1 and K2;
   the graph's profile beside phase 9's flagship. 14b: ``--adv <file>``
   (``make_domain_shifted_fewrel``, shift 1.0, as FewRel JSON) through
   ``cli.train_main``; its domain accuracy per window. 14c: ``--encoder
   transformer --moe_experts 8`` (ep 1, the JAX defaults): one graph step
   vs one eager step, 8 steps and a val pass as replays (the pair once a
   step), ms/step, peak GiB, the share of assignments dropped at capacity.
   14d: ``--tfm_stacked`` (pp 1): the same, beside the unstacked
   transformer at the same config in the same call and phase 11's
   proto/transformer. A ``{"slice6c": ...}`` line; the phase must end
   within 120 s.
15. (run after phase 13) Observability (files under
   ``build/chip_smoke_obs/``, removed at the end), through the CLI's
   wiring at the flagship config (bf16, W=8, 4 steps a replay). 15a: 100
   steps with ``--watchdog --perf --tensorboard --profile --profile_steps
   8 --chaos ckpt.bitflip@1:ring --ckpt_stage auto``, the wrappers' counts
   zeroed just before and read just after (the captures' K7, K8, K10,
   K11, lstm_wgrad, the pair, K1, K2): the stream passes the port's
   schema gate (``tools/obs_report.check_schema``); each perf window's
   unrounded tiles sum to its wall time within 1e-9 s; the capture
   watcher's records hold the train and eval graphs' warm-up captures and
   no steady-state capture; the
   TensorBoard file reads back (``utils/metrics.read_events``) as
   metrics.jsonl's numeric fields; the profile's chrome trace holds the
   ``train/dispatch`` annotations and K7/K8 rows; the corrupted ring save
   is quarantined (one ``kind="fault"`` record) and ``restore_latest``
   lands on the best save bitwise; the staging root is removed. 15b: a
   saver-thread save at step s while 16 more steps replay restores bitwise
   equal to a synchronous save at s; ms/step of 32 steps holding a save,
   staging off and on, beside none. 15c: ``--nan_inject_step`` trips the
   watchdog and the recorder dumps. 15d: ``--debug_nans`` with a weight
   poisoned after step 8 raises ``FloatingPointError`` naming step 9.
   15e: ``serve_main`` on 15a's checkpoint with ``--watchdog
   --trace_sample 1.0 --slo_latency_ms 1000 --drift --chaos
   serve.execute_raise@2,publish.nan_params@0`` (K1/K2 counts zeroed just
   before and read just after): every request's waterfall tiles its
   latency (rounding), the injected failure is contained, no capture
   after warmup, ``metrics.prom`` written; then an engine on the
   checkpoint: ``publish.nan_params`` refused and rolled back, the JAX
   drift drill (``load/drift.drill_engine``: an open-set floor between an
   out-of-vocabulary point mass and the in-domain pool) trips
   once-latched and a publish re-arms it, a tenant shed at its share
   trips its SLO burn. 15f, the tax: the flagship's unprofiled ms/step
   with ``--watchdog --perf`` against without (in turns), serve/execute's
   p50 at trace_sample 1.0 against 0 for buckets 1, 4 and 16, and a
   span's host cost with and without its NVTX range. An ``{"obs": ...}``
   line; the phase should end within 90 s.
16. (run after phase 15) The serving control plane and the adaptation
   controller (files under ``build/chip_smoke_fleet/``, removed at the end)
   at the flagship widths on the JAX drill world: the source artifact
   (``make_synthetic_fewrel``, 15 relations, NOTA at rate 1, ce) trained
   300 steps on the card, its shifted twin (``make_domain_shifted_fewrel``,
   shift 1.0) as the drifting traffic; the canary floors are the
   artifact's own pre-drift accuracy minus the JAX band; the fine-tune's
   ms/step alone. 16a: three ``InProcessReplica``s behind ``FleetRouter``
   and ``FleetControl`` (``obs/adapt_drill.run_adapt_success_arm``): 2 s of
   8 closed-loop clients on a second tenant before the drift, clean
   traffic arms the drift baseline, target traffic trips the CRITICAL, the
   controller fine-tunes (300 steps), canaries and fan-out publishes while
   the clients keep requests in flight, then verifies; the JAX
   ``check_adapt_drill`` fields held; the wrappers' counts read at the
   fleet's set-up and across the attempt (the fine-tune's K7, K8,
   lstm_wgrad, K10, K11 and the pair, K1 and K2); one train-graph capture,
   no serving capture after warm-up, no request errored or shed, some
   completed inside the capture; per-bucket p50/p99 before and during;
   the candidate's served logits vs the plain backends on its weights.
   16b: ``adapt.canary_fail`` twice: no publish, the backoff, one
   ``adapt_exhausted``, degraded NOTA verdicts launching no K1 or K2, no
   candidate left, device memory back to its level before the first
   attempt, the latch restored from the journal on a rebuilt router. 16c:
   ``fleet.replica_kill`` mid-traffic (failover, nothing dropped, the
   supervisor revives), ``journal.torn_write`` (``load/recovery.tear_journal``)
   and a cold-start ``recover`` (owners and params_version as before), a hot standby's
   promotion fencing the old primary, one autoscaler cycle on an injected
   clock. 16d: a replica in a child process behind a ``SocketReplica``
   (logits within 1e-6 of an in-process replica's; ``net.drop`` and
   ``net.slow`` retried), then ``serve_main --replicas 3 --journal
   --control_socket`` and a second process's ``--send`` drain. A
   ``{"fleet": ...}`` line.
17. (run after phase 16) The load tools (``load/``, files under
   ``build/chip_smoke_load/``, removed at the end) through their functions
   at the tool's own configuration (its synthetic checkpoint: the flagship
   widths, bf16 encoder, f32 head, a 2 002-word table, 5-way 5-shot, two
   tenants, buckets 1-16), the kernels' wrapper counts zeroed just before
   and read just after (``launches_load``); the cuts (``LOAD_CUTS``) are
   printed. 17a: both scheduler arms, closed and open, and the swap drill
   (``load/harness.drive_one``): the registry-parity gate, p50/p99 per
   bucket, served/s, nothing shed, no capture after warmup, nothing
   dropped by the swap. 17b: the burn, drift and chaos drills, each gate
   true. 17c: the quant A/B on a checkpoint trained 60 steps on the card
   and the geometry A/B with its scenario grid leg, no gate failure. 17d:
   a fleet soak at ``--fleet 3``, the tier-1 fleet, recovery, elastic and
   fleet-obs drills (placement and naming equal to the JAX artifacts'
   tier-1 values), then ``fleet_report --check`` in a process of its own
   on the fleet-obs run directory. A ``{"load": ...}`` line.
18. (run after phase 17) The single-card tools (``tools/``, files under
   ``build/chip_smoke_tools/``, removed at the end). 18a: the flagship on
   the token cache (the synthetic 400 002 x 50 table, bf16 encoder, 4
   steps a replay, weight decay 0: the converter's caveat) through
   ``cli.train_main`` with ``--embed_optimizer lazy`` for 4 steps (a val
   pass and a best save), ``tools/convert_lazy_ckpt`` on its directory
   (the materialize: one ``lazy_catchup`` launch), ``cli.train_main
   --resume`` on the result in shared mode for 4 more, all under the
   profiler (``lazy_catchup``, K7, K8 and the optimizer pair must launch);
   then the uninterrupted shared run of 8 steps from the same seed, and
   the resumed run's ring slot held to it at ``hold_state``'s bars (every
   parameter and moment within 1e-6 of its scale, the word table's
   atomics-noise elements aside). 18b: ``tools/zoo_quality.run_model`` on
   induction at a cut recipe (500 steps, val every 250 over 50
   episodes), a child process of the port's CLI: a
   ``final_val_accuracy`` and a ``train_eps_s_median``, no ``error``.
   18c: ``tools/obs_report`` ``--check`` (exit 0) and ``--json`` on 18a's
   and 18b's run directories (a train section; on 18a's lazy run an MFU
   against the card's peak, with the card's name) and on every run
   directory phases 15, 16 and 17 kept when they ran in the same call. A
   ``{"tools": ...}`` line; the phase must end within 120 s.
19. (run after phase 18) Data parallel (``parallel/``), the ranks in child
   processes, each launch bounded and killed by process group on overrun
   (this process never joins a process group). 19a: ``torchrun
   --nproc_per_node 1 chip_smoke.py --dp19a OUT``: the flagship on the
   token cache with lazy Adam (400 002 x 50, bf16, W=8, 4 steps a replay)
   through ``cli.dp_mesh`` and ``cli.make_trainer`` at world size 1 over
   NCCL with ``--dp 1 --zero_opt --grad_bucketing on --compact_demb on``
   (every gradient bucket and ZeRO-1 gather captured in the replay) beside
   the same run without a group, 16 steps each: losses within 1e-6 and the
   state at ``hold_state``'s bars (and the lazy moments); the collectives
   each replay issues, counted across the capture and held to the plan;
   each hand kernel of the path and the NCCL kernels per step under the
   profiler, no capture after the warm-up, ms/step beside the plain run; then
   ``cli.test_main`` on its checkpoint under the mesh. 19b: ``torchrun
   --nproc_per_node 2 chip_smoke.py --dp19b OUT``: two gloo ranks on the
   one card (NCCL refuses two ranks on one device), eager steps, f32 at the
   flagship widths, B=4 episodes a global batch: monolithic, compact,
   bucketed and ZeRO-1 for 3 steps each, held to one process on the global
   batches (losses and parameters within 1e-5, JAX's bar; gradient norms
   and moments, the lazy rows' included) and the two ranks' replicas to
   each other; the collectives each step issued, counted on both ranks
   and held to the plan; wrapper launches per step. A ``{"dp": ...}``
   line.
20. (run with phase 19, sharing its two torchrun children: a child's start
   costs ~20 s) The rest of data parallel. 20a, in this process:
   the flagship engine of phase 4 at ``dp=2`` with both shards on the one
   card (``devices=("cuda:0", "cuda:0")``) beside the same engine at
   ``dp=None``: 64 requests in buckets 1, 4 and 16 per resident dtype (f32,
   bf16, int8), logits within 1e-5 of scale at f32 and at phase 4's
   resident bars at bf16 and int8; one graph per (key, bank, shard) at
   warmup and none after; K1 and K2 launched twice a graph at warmup; a
   publish under dp scores as the single engine; p50 per bucket beside
   dp=None; ``serve_main --dp 2`` in a child process exits 2 with the
   "exceeds the 1 visible devices" text; a 1 s load-tool arm at
   ``--serving_dp 1``. 20b: ``torchrun --nproc_per_node 1 chip_smoke.py
   --dp20a OUT``: ``--adv`` at the flagship config, ``--mixture`` over two
   FewRel-format files and ``--feature_cache`` at BERT-base, each through
   ``cli.make_trainer`` at world size 1 over NCCL (collectives captured)
   beside the run without a group, one replay of 4 steps: losses within
   1e-6 of scale, the state held, the collectives each replay issues equal
   to the plan, each path's kernels and the NCCL kernels per step under
   the profiler, ms/step beside the plain run. 20c: ``torchrun
   --nproc_per_node 2 chip_smoke.py --dp20b OUT``: two gloo ranks on the
   card, eager, f32: the adversarial step (monolithic, ZeRO-1) and the
   feature cache for 3 steps each held to one process on the global batch
   within 1e-5 (each rank's feature table equal to the one process's),
   the replicas to each other, the collectives to the plan; the mixture
   through the CLI picks the same source on both ranks and resumes from
   its ring slot onto the uninterrupted stream. A ``{"dp20": ...}`` line.
21. (run with phases 19-20, sharing their two torchrun children, plus one
   of four ranks) MoE across ranks: routing and the load-balance term over
   the global batch, and the expert-parallel executor. 21a (in the NCCL
   child, ``--dp21a OUT``): phase 14c's MoE transformer (``--moe_experts
   8`` at the JAX defaults) on the token cache with lazy Adam at ``--dp 1
   --zero_opt``, world size 1 over NCCL (the routing all-gathers captured
   in the replay) beside the run without a group, 2 replays of 4 steps:
   held at 19a's bars (and whether every parameter is equal to the bit),
   the dropped shares equal, the collectives each replay issues equal to
   the plan, ms/step and peak GiB beside the plain run, then ``cli
   test_main`` under the mesh. 21b/21c (``--dp21b OUT`` in the two-rank
   gloo child: (dp=2, ep=1) and (dp=1, ep=2); ``--dp21c OUT``, four gloo
   ranks: (dp=2, ep=2)): f32 at 14c's widths, SGD at lr 0.1, with
   ``--moe_capacity 0.5``
   (the drops above 0, the routing groups of 512 straddling the ranks'
   edges at global tokens 2000 and 6000), 3 eager steps from the seed's
   weights, held to one process on the global batch within 1e-5 (the first
   forward's logits and every gradient leaf of scale, losses, parameters,
   gradient norms) with the dropped shares equal, every rank's replica
   equal, the collectives to the plan; eager ms/step and peak GiB, printed
   beside 14c's ep=1 run. A ``{"dp21": ...}`` line.
22. (run with phases 19-21, in their two- and four-rank gloo children)
   Tensor and sequence parallel on gloo ranks on the card, eager, each
   held to one process on the global batch within 1e-5. 22a: the flagship
   (``--encoder bilstm`` at the ExperimentConfig widths, the token cache
   with lazy Adam, f32 as 19b) at (dp, tp) = (1, 2) on two ranks and (2, 2)
   on four: losses, parameters, gradient norms and moments; K7, K8,
   ``lstm_wgrad``, K10, K11 and the optimizer pair launched on every rank
   every step (wrapper counts per rank per step). 22b: the transformer at
   the JAX defaults (4 layers, width 256, FFN 1024, L=40; f32, SGD) at
   sp=2, ring attention: the first forward's logits, every gradient leaf,
   losses, parameters, gradient norms. 22c: a BERT-base eval batch (the
   seed's weights) at tp=2: logits and eval metrics. Replicas equal, the
   collectives to the plan, ms/step and peak GiB per rank beside the
   one-process run. A ``{"dp22": ...}`` line.
23. (``--phases 23`` runs 22: the same two- and four-rank gloo children,
   after 22) Pipeline parallel: the stacked transformer at the JAX
   defaults (4 layers, width 256, FFN 1024, L=40; the induction head, f32,
   the token cache with lazy Adam on 22a's 400 002 x 50 table and
   batches) at (dp, pp) = (1, 2) on two ranks and (2, 2) on four, 5 GPipe
   microbatches, 3 eager steps held to one process on the global batch
   within 1e-5 (every step's loss and gradient norm; the parameters and
   the moments of scale after step 1, the elements whose first gradient
   is at the rounding level of their leaf aside: ``adam_noise``); the pp
   run's ring slot after 2 steps restored at pp=1 on the card and trained
   on, held to the pp run's end (each pp step is one process's step from
   the same state); the end state after 3 steps reported; each rank's
   stack and its moments half the one process's bytes; replicas equal,
   the collectives
   (``pp/hop`` 10 a step) to the plan, ``optim_sumsq`` 2 and
   ``optim_update`` 1 and the lazy pair on every rank every step; ms/step
   and peak GiB per rank beside the one-process run. A ``{"dp23": ...}``
   line.
12. A ``{"kernels": [...]}`` line for the sixteen hand kernels (one per
   Pallas body, the weight-gradient kernel of the backwards, the
   optimizer pair and the lazy table's two; K1 and K2 with the serving
   phases' counts; ``launches_zoo`` their launches in phase 11, and the
   optimizer pair's errors on the zoo models' parameter lists), a
   ``{"training_step": ...}`` line of the step's figures, the segment
   sum's, phases 9c/9d's and the zoo's, the ``{"feed": ...}`` line of
   phase 9e (``launches_feed_9e`` in the kernels line: its (a) native
   depth-2 run's profiled launches; ``*_bert``: the optimizer pair on
   phase 13a's parameter list and its launches in phase 13;
   ``launches_adv``: phase 14a's profiled launches; ``launches_fleet``
   and ``launches_adapt``: phase 16a's wrapper counts at the fleet's
   set-up and across the adaptation attempt; ``launches_load``: phase
   17's wrapper counts; ``launches_tools``: phase 18a's profiled
   launches; ``launches_dp_19a_per_step`` / ``launches_dp_19b_per_step``:
   phase 19a's profiled and 19b's wrapper launches per rank per step;
   ``launches_serving_dp``: phase 20a's wrapper counts across the dp
   engine; ``launches_dp_20``: phase 20b's profiled launches per step of
   each path and 20c's wrapper counts on rank 0; ``launches_moe_dp_21``:
   phase 21a's profiled launches per step and 21b/21c's wrapper launches
   per step on rank 0, by layout; ``launches_tp_sp_22``: phase 22's
   wrapper launches per step on every rank, by part and layout;
   ``launches_pp_23``: phase 23's, by layout), a
   ``{"serving": ...}`` line of phases 4, 4a, 4b and 4c, a ``{"bert":
   ...}`` line of phase 13, the ``{"slice6c": ...}`` line of phase 14, the
   ``{"obs": ...}`` line of phase 15, the ``{"fleet": ...}`` line of phase
   16, the ``{"load": ...}`` line of phase 17, the ``{"tools": ...}`` line
   of phase 18, the ``{"dp": ...}`` line of phase 19, the ``{"dp20":
   ...}`` line of phase 20, the ``{"dp21": ...}`` line of phase 21, the
   ``{"dp22": ...}`` line of phase 22, the ``{"dp23": ...}`` line of
   phase 23, the run's seconds,
   then the last line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX. Exits non-zero without CUDA (rc 2), and when the
port's package is not beside it (rc 1, with a message naming the package).
"""

from __future__ import annotations

import contextlib
import copy
import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

try:
    from induction_network_on_fewrel_tpu_torch import cli
except ModuleNotFoundError as e:    # run from a directory without the port beside it
    if e.name != "induction_network_on_fewrel_tpu_torch":
        raise
    sys.exit("chip_smoke: the port's package induction_network_on_fewrel_tpu_torch is not "
             "beside this script; run it from the root of a checkout")
from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
from induction_network_on_fewrel_tpu_torch.data import (
    GloveTokenizer,
    make_domain_shifted_fewrel,
    make_synthetic_fewrel,
    make_synthetic_glove,
)
from induction_network_on_fewrel_tpu_torch.kernels.build import LIBRARY, SAMPLER_LIBRARY, SOURCES
from induction_network_on_fewrel_tpu_torch.models.base import to_device
from induction_network_on_fewrel_tpu_torch.models.bert import attention_bias
from induction_network_on_fewrel_tpu_torch.models.build import build_model, encoder_output_dim
from induction_network_on_fewrel_tpu_torch.models.moe import MoeFfn, moe_geometry
from induction_network_on_fewrel_tpu_torch.ops.attn import (
    attn_bwd,
    attn_bwd_plan,
    attn_bwd_reference,
    attn_fwd_cuda,
    attn_fwd_plan,
    attn_fwd_stats,
    attn_fwd_stats_reference,
    attn_reference,
)
from induction_network_on_fewrel_tpu_torch.ops.lstm import (
    bilstm_bwd_chain_reference,
    bilstm_full_bwd,
    bilstm_full_bwd_reference,
    bilstm_full_fwd,
    bilstm_full_fwd_reference,
    bilstm_infer_cuda,
    bilstm_recurrence_tm,
    bilstm_reference,
    bilstm_win_bwd,
    bilstm_win_bwd_reference,
    bilstm_win_fwd,
    bilstm_win_fwd_reference,
    bwd_plan,
    fwd_plan,
    lstm_recurrence_grouped,
    lstm_split_bwd,
    lstm_split_bwd_reference,
    lstm_split_fwd,
    lstm_split_fwd_reference,
    lstm_split_infer_cuda,
    lstm_split_infer_reference,
    lstm_wgrad,
    lstm_wgrad_reference,
)
from induction_network_on_fewrel_tpu_torch.models.build import batch_to_model_inputs
from induction_network_on_fewrel_tpu_torch.sampling.episodes import EpisodeSampler
from induction_network_on_fewrel_tpu_torch.serving.buckets import QUERY_DTYPES
from induction_network_on_fewrel_tpu_torch.serving.engine import InferenceEngine
from induction_network_on_fewrel_tpu_torch.ops.optim import (
    MOMENT_RULES,
    OptimHyper,
    make_workspace,
    optim_sumsq,
    optim_sumsq_reference,
    optim_update,
    optim_update_reference,
)
from induction_network_on_fewrel_tpu_torch.ops.lazy_embed import (
    CATCHUP_CAP,
    lazy_catchup,
    lazy_catchup_reference,
    lazy_materialize,
    lazy_scatter,
    lazy_scatter_reference,
)
from induction_network_on_fewrel_tpu_torch.ops.segsum import segsum, segsum_reference
from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager
from induction_network_on_fewrel_tpu_torch.train.feature_cache import encode_table
from induction_network_on_fewrel_tpu_torch.train.framework import (
    FewShotTrainer,
    batch_inputs,
    stack_batches,
)
from induction_network_on_fewrel_tpu_torch.train.steps import (
    WORD_TABLE,
    adv_loss_and_metrics,
    adv_train_step,
    batch_leaves,
    init_disc_state,
    loss_and_metrics,
    make_adv_multi_train_step,
    make_adv_train_step,
    make_grad_probe,
    make_multi_train_step,
    make_optimizer,
    make_train_step,
    train_step,
)
from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

L, D, U, A = 40, 60, 128, 64
H_DIM = 2 * U
# Phase 3's row counts: serving buckets 1, 4, 16, a 5x5 registration (25)
# and the val/test batch (200).
SERVE_ROWS = (1, 4, 16, 25, 200)
# Published H100 SXM peaks: HBM bytes/s, and
# FLOP/s by operand type (bf16 on the tensor cores, f32 on the CUDA cores).
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# Tolerances (max abs error, kernel vs plain version on the same inputs):
#   K1 f32  5e-5: the 188-term gate sums run in another order, and the
#           difference is carried through 40 recurrent steps; h is bounded
#           by 1, so this is ~100 f32 ulps of the output.
#   K2 f32  2e-5: 256-term projections and a 40-step online softmax vs the
#           two-pass form; outputs are averages of |H| <= 1.
#   bf16    8e-3 (both): each output is rounded to bf16 once from f32
#           values that differ by f32 rounding, so it may land one bf16
#           ulp apart (2^-8 for values in [0.5, 1)); 8e-3 is two ulps.
TOL = {
    ("K1", torch.float32): 5e-5, ("K1", torch.bfloat16): 8e-3,
    ("K2", torch.float32): 2e-5, ("K2", torch.bfloat16): 8e-3,
}
# Logits of the main path, kernel engine vs plain-backend engine: the bf16
# encoder outputs may differ by a bf16 ulp in a few elements, which the f32
# head carries into the logits; the bar is relative to the logits' scale.
LOGIT_REL_TOL = 2e-2


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` launches (CUDA
    events around the whole run, after 3 warm-up calls; L2 stays warm)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def median_ms(fn, repeats: int = 5, iters: int = 20) -> tuple[float, float, float]:
    """(median, min, max) over ``repeats`` runs of ``cuda_ms(fn, iters)``."""
    runs = sorted(cuda_ms(fn, iters) for _ in range(repeats))
    return runs[len(runs) // 2], runs[0], runs[-1]


def spread_text(t: tuple[float, float, float]) -> str:
    return f"{t[0]:.4f} (min {t[1]:.4f} max {t[2]:.4f} over 5 x 20)"


def bound(bytes_moved: float, op_times: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BPS
    return (max(t_bytes, op_times) * 1e3, "bytes" if t_bytes >= op_times else "operations")


def cudnn_infer_ms(M: int) -> float:
    """K1's yardstick: an f32 torch.nn.LSTM(bidirectional) run the way K1
    runs, ``.eval()`` under ``torch.no_grad()`` (cuDNN's inference
    forward; in bf16 it compacts its weights on every call); timed here,
    used nowhere in the port."""
    dev = torch.device("cuda")
    lstm = torch.nn.LSTM(D, U, bidirectional=True).to(dev).eval()
    lstm.flatten_parameters()
    x = torch.randn((L, M, D), device=dev)
    with torch.no_grad():
        return cuda_ms(lambda: lstm(x), 20)


def plan_text(M: int, D_in: int = D, W: int | None = None) -> str:
    """The cluster forward's launch plan at M rows (ops/lstm.py:fwd_plan),
    or, with a window W (0: saved streams), the backward chain's
    (ops/lstm.py:bwd_plan)."""
    p = fwd_plan(M, D_in, U) if W is None else bwd_plan(M, D_in, U, W)
    why = f" ({p.why})" if getattr(p, "why", "") else ""
    return f"plan TM={p.tm} C={p.cluster} CTAs={p.ctas} smem={p.smem}{why}"


def lstm_bound_parts(M: int, dt: torch.dtype) -> tuple[float, float]:
    """K1's (bytes, operation seconds)."""
    es = torch.finfo(dt).bits // 8
    G = 4 * U
    moved = L * M * D * es + 2 * D * G * es + 2 * G * 4 + 2 * U * G * 4 + L * M * H_DIM * es
    ops_in = 2 * 2 * L * M * D * G          # emb x W_ih, both directions (operand dtype)
    ops_rec = 2 * 2 * L * M * U * G         # h x W_hh, both directions (f32)
    return moved, ops_in / PEAK_FLOPS[dt] + ops_rec / PEAK_FLOPS[torch.float32]


def lstm_bound(M: int, dt: torch.dtype):
    return bound(*lstm_bound_parts(M, dt))


def attn_bound_parts(M: int, dt: torch.dtype, d: int = H_DIM, a: int = A) -> tuple[float, float]:
    """K2's (bytes, operation seconds) at width d, attention dim a."""
    es = torch.finfo(dt).bits // 8
    moved = L * M * d * es + M * L * 4 + d * a * 4 + a * 4 + M * d * es
    ops = 2 * L * M * d * a + 2 * L * M * a + 2 * L * M * d   # f32 math
    return moved, ops / PEAK_FLOPS[torch.float32]


def attn_bound(M: int, dt: torch.dtype, d: int = H_DIM, a: int = A):
    return bound(*attn_bound_parts(M, dt, d, a))


def attn_plan_text(M: int, d: int = H_DIM, a: int = A, which: str = "fwd") -> str:
    """The attention kernels' launch plan (ops/attn.py:attn_fwd_plan for
    K2/K10, attn_bwd_plan for K11)."""
    if which == "fwd":
        p = attn_fwd_plan(M, L, d, a)
        return (f"plan tile={p.tile} C={p.cluster} rows={p.rows} steps={p.steps} "
                f"chunk={p.chunk} CTAs={p.ctas} smem={p.smem}")
    p = attn_bwd_plan(M, L, d, a)
    return (f"plan tile={p.tile} CTAs={p.ctas} smem={p.smem} + wgrad CTAs={p.wgrad_ctas} "
            f"smem={p.wgrad_smem}")


def device_ms(fn, iters: int = 20) -> float:
    """Device time of ``fn`` per call in ms: its kernels' self device time
    under torch.profiler over ``iters`` calls, after 3 warm-up calls. Unlike
    ``cuda_ms`` it leaves out the host's time between launches, which a
    kernel of tens of microseconds does not hide."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # A window can come back without any device record (phase 13a's
    # optim_sumsq read 0.0 once in a full run): profile again, and fail
    # rather than report a time the profiler did not see.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.self_device_time_total > 0)
        if us > 0:
            return us / iters / 1e3
    raise AssertionError("device_ms: the profiler recorded no device time in three windows")


def kernel_checks(gen: torch.Generator) -> dict:
    """Phase 3: both kernels vs their plain versions at every shape/dtype:
    serving buckets M in {1, 4, 16}, a 5x5 registration (M=25) and the
    val/test batch (M=200)."""
    dev = torch.device("cuda")
    rows = {}
    infer_lib = {M: cudnn_infer_ms(M) for M in SERVE_ROWS}
    train_lib = {M: cudnn_lstm_ms(M, False)[0] for M in SERVE_ROWS}
    for M in SERVE_ROWS:
        print(f"[check] cuDNN f32 LSTM M={M}: no-grad eval forward (K1's yardstick) "
              f"{infer_lib[M]:.4f} ms; train-mode forward {train_lib[M]:.4f} ms", flush=True)
    for dt in (torch.float32, torch.bfloat16):
        for M in SERVE_ROWS:
            emb = (torch.randn((L, M, D), generator=gen) * 0.5).to(dev, dt)
            wih = (torch.randn((2, D, 4 * U), generator=gen) / D ** 0.5).to(dev, dt)
            b = (torch.randn((2, 1, 4 * U), generator=gen) * 0.1).to(dev)
            whh = (torch.randn((2, U, 4 * U), generator=gen) / U ** 0.5).to(dev)
            hs = bilstm_infer_cuda(emb, wih, b, whh)
            torch.cuda.synchronize()
            ref = bilstm_reference(emb, wih, b, whh)
            err1 = (hs.float() - ref.float()).abs().max().item()
            tol1 = TOL[("K1", dt)]
            if not (torch.isfinite(hs).all() and err1 <= tol1):
                raise AssertionError(f"K1 {dt} M={M}: max abs err {err1} > {tol1}")
            ms1 = cuda_ms(lambda: bilstm_infer_cuda(emb, wih, b, whh), 20)
            plain1 = cuda_ms(lambda: bilstm_reference(emb, wih, b, whh), 3)
            bd1, by1 = lstm_bound(M, dt)

            H = (torch.rand((L, M, H_DIM), generator=gen) * 2 - 1).to(dev, dt)
            lengths = torch.randint(1, L + 1, (M,), generator=gen)
            mask = (torch.arange(L)[None, :] < lengths[:, None]).float()
            if M > 1:
                mask[1] = 0.0                       # a fully masked row
            mask = mask.to(dev)
            w1 = (torch.randn((H_DIM, A), generator=gen) / H_DIM ** 0.5).to(dev)
            w2 = (torch.randn((A, 1), generator=gen) / A ** 0.5).to(dev)
            out = attn_fwd_cuda(H, mask, w1, w2)
            torch.cuda.synchronize()
            ref2 = attn_reference(H, mask, w1, w2)
            err2 = (out.float() - ref2.float()).abs().max().item()
            tol2 = TOL[("K2", dt)]
            if not (torch.isfinite(out).all() and err2 <= tol2):
                raise AssertionError(f"K2 {dt} M={M}: max abs err {err2} > {tol2}")
            if M > 1 and out[1].abs().max().item() != 0.0:
                raise AssertionError("K2: a fully masked row must give exact zeros")
            ms2 = cuda_ms(lambda: attn_fwd_cuda(H, mask, w1, w2), 20)
            plain2 = cuda_ms(lambda: attn_reference(H, mask, w1, w2), 20)
            bd2, by2 = attn_bound(M, dt)
            name = "bf16" if dt == torch.bfloat16 else "f32"
            rows[("K1", name, M)] = dict(err=err1, tol=tol1, ms=ms1, plain_ms=plain1,
                                         library_ms=infer_lib[M], bound_ms=bd1, bound_by=by1,
                                         train_library_ms=train_lib[M], plan=plan_text(M))
            rows[("K2", name, M)] = dict(err=err2, tol=tol2, ms=ms2, plain_ms=plain2,
                                         library_ms=None, bound_ms=bd2, bound_by=by2,
                                         plan=attn_plan_text(M))
            for k in ("K1", "K2"):
                r = rows[(k, name, M)]
                print(f"[check] {k} {name} M={M}: max_abs_err={r['err']:.3g} "
                      f"(tol {r['tol']:g}) ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                      f"library_ms={r['library_ms']} bound_ms={r['bound_ms']:.5f} "
                      f"({r['bound_by']}){' ' + r['plan'] if 'plan' in r else ''}", flush=True)
    return rows


# Training kernels, kernel vs plain version on the same inputs. Errors are
# relative to the largest magnitude of the plain output they compare:
#   f32   1e-4: sums of up to L*M = 8000 products (dW) taken in another
#         order, through 40 recurrent steps (K7, K8) or a 40-step softmax
#         (K10, K11); ~1000 f32 ulps of the largest value.
#   bf16  1e-2: outputs written in bf16 (hs, checkpoints, demb, dH, out)
#         may land one bf16 ulp (2^-8 = 3.9e-3 relative) apart; the f32
#         outputs (dW, stats) are held to the same bar, as their inputs
#         (hs, out) are bf16 values that may differ by that ulp.
TRAIN_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# f32 K6 vs f32 K8 gradients on the same inputs, relative to each output's
# max: the same arithmetic on the same f32 states, summed in other orders
# (the JAX package holds the two at 1e-6 in interpret mode).
K6_K8_TOL = 1e-5


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|), after a finite check."""
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite kernel output")
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def check_outputs(name: str, pairs: dict, tol: float) -> float:
    """Hold every (kernel, plain) output pair to ``tol``; return the
    largest abs error."""
    worst = 0.0
    for key, (got, want) in pairs.items():
        err, rel = rel_err(got, want)
        if rel > tol:
            raise AssertionError(f"{name} {key}: relative error {rel:.3g} > {tol}")
        worst = max(worst, err)
    return worst


def cudnn_lstm_ms(M: int, backward: bool) -> tuple[float, float, float]:
    """K7/K8's yardstick: an f32 torch.nn.LSTM(bidirectional) in train mode
    (cuDNN; in bf16 it compacts its weights on every call), forward, or
    forward + backward; timed here, used nowhere in the port. (median, min,
    max) of ``median_ms``."""
    dev = torch.device("cuda")
    lstm = torch.nn.LSTM(D, U, bidirectional=True).to(dev).train()
    lstm.flatten_parameters()
    x = torch.randn((L, M, D), device=dev, requires_grad=True)
    g = torch.randn((L, M, H_DIM), device=dev)

    def run():
        out, _ = lstm(x)
        if backward:
            torch.autograd.backward(out, g)
    return median_ms(run)


def win_fwd_bound(M: int, dt: torch.dtype, W: int, rdt: torch.dtype):
    nB = -(-L // W)
    ckpt = 2 * nB * M * H_DIM * (torch.finfo(rdt).bits // 8)
    t_bytes, t_ops = lstm_bound_parts(M, dt)
    return bound(t_bytes + ckpt, t_ops)


def win_bwd_bound(M: int, dt: torch.dtype, W: int, rdt: torch.dtype):
    es, rs, G = torch.finfo(dt).bits // 8, torch.finfo(rdt).bits // 8, 4 * U
    nB = -(-L // W)
    moved = (L * M * H_DIM * es + L * M * D * es + 2 * nB * M * H_DIM * rs      # dhs, emb, ckpts
             + 2 * D * G * es + 2 * G * 4 + 2 * U * G * 4                      # weights
             + 2 * L * M * D * es + (2 * D * G + 2 * G + 2 * U * G) * 4)        # demb, dW
    # Per step and direction: the gates once from the checkpoints (2MG(D+u)),
    # then da W_ih^T, da W_hh^T, emb^T da, h^T da (2MG(D+u) twice). The
    # emb x W_ih product runs in the operand dtype. The da and hp streams
    # that K8 hands to lstm_wgrad are its design's cost, not the function's
    # work, and are not counted here.
    ops_in = 2 * L * 2 * M * D * G
    ops_f32 = 2 * L * (2 * M * U * G + 4 * M * G * (D + U))
    return bound(moved, ops_in / PEAK_FLOPS[dt] + ops_f32 / PEAK_FLOPS[torch.float32])


def attn_stats_bound(M: int, dt: torch.dtype, d: int = H_DIM, a: int = A):
    t_bytes, t_ops = attn_bound_parts(M, dt, d, a)
    return bound(t_bytes + 2 * M * 4, t_ops)


def attn_bwd_bound(M: int, dt: torch.dtype, d: int = H_DIM, a: int = A):
    es = torch.finfo(dt).bits // 8
    moved = (2 * L * M * d * es + M * L * 4 + d * a * 4 + a * 4          # H, dH, mask, w
             + 2 * M * d * es + 2 * M * 4 + d * a * 4 + a * 4)         # out, dout, stats, dW
    ops = 3 * 2 * L * M * d * a + 6 * L * M * a + 6 * L * M * d          # f32 math
    return bound(moved, ops / PEAK_FLOPS[torch.float32])


# Phase 6b's shapes: the flagship widths at every serving and training row
# count, and one width past the kernels' old limits (D <= 1024, A <= 256):
# u = 640 (D = 1280) with A = 300.
ATTN_CASES = [(M, H_DIM, A) for M in SERVE_ROWS] + [(16, 1280, 300), (200, 1280, 300)]


def attn_checks(gen: torch.Generator) -> dict:
    """Phase 6b: K2, K10 and K11 vs their plain versions at ATTN_CASES, f32
    and bf16, each with a partly masked row and a fully masked one (M > 1):
    K2 at phase 3's tolerances, K10/K11 at TRAIN_TOL; the fully masked row
    gives out = 0, mx = -1e30, dn = 0 and dH = 0 exactly; K11 run twice must
    repeat bit for bit. Times: CUDA events around 20 calls as the other
    phases (``ms``, host time between launches included) and the kernels'
    device time under the profiler (``device_ms``), with the plan of each
    launch."""
    dev = torch.device("cuda")
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = "bf16" if dt == torch.bfloat16 else "f32"
        for M, d, a in ATTN_CASES:
            name = f"{dname} M={M} D={d} A={a}"
            tol = TRAIN_TOL[dt]
            H = (torch.rand((L, M, d), generator=gen) * 2 - 1).to(dev, dt)
            lengths = torch.randint(1, L + 1, (M,), generator=gen)
            mask = (torch.arange(L)[None, :] < lengths[:, None]).float()
            if M > 1:
                mask[1] = 0.0                       # a fully masked row
            mask = mask.to(dev)
            w1 = (torch.randn((d, a), generator=gen) / d ** 0.5).to(dev)
            w2 = (torch.randn((a, 1), generator=gen) / a ** 0.5).to(dev)
            dout = (torch.randn((M, d), generator=gen) * 0.1).to(dev, dt)
            out2 = attn_fwd_cuda(H, mask, w1, w2)
            out, mx, dn = attn_fwd_stats(H, mask, w1, w2)
            got11 = attn_bwd(H, mask, w1, w2, out, mx, dn, dout)
            again = attn_bwd(H, mask, w1, w2, out, mx, dn, dout)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got11, again)):
                raise AssertionError(f"K11 {name}: two runs differ")
            ref10 = attn_fwd_stats_reference(H, mask, w1, w2)
            err2 = (out2.float() - ref10[0].float()).abs().max().item()
            tol2 = TOL[("K2", dt)]
            if not (torch.isfinite(out2).all() and err2 <= tol2):
                raise AssertionError(f"K2 {name}: max abs err {err2} > {tol2}")
            live = mask.sum(1) > 0
            err10 = check_outputs(f"K10 {name}", {"out": (out, ref10[0]),
                                                  "mx": (mx[live], ref10[1][live]),
                                                  "dn": (dn, ref10[2])}, tol)
            ref11 = attn_bwd_reference(H, mask, w1, w2, out, mx, dn, dout)
            err11 = check_outputs(f"K11 {name}", dict(zip(("dH", "dw1", "dw2"),
                                                          zip(got11, ref11))), tol)
            if M > 1 and (out2[1].abs().max().item() != 0.0 or out[1].abs().max().item() != 0.0
                          or mx[1].item() != np.float32(-1e30) or dn[1].item() != 0.0
                          or got11[0][:, 1].abs().max().item() != 0.0):
                raise AssertionError(f"{name}: a fully masked row must give out=0, mx=-1e30, "
                                     "dn=0 and dH=0 exactly")
            calls = {
                "K2": (lambda: attn_fwd_cuda(H, mask, w1, w2),
                       lambda: attn_reference(H, mask, w1, w2), err2, tol2,
                       attn_bound(M, dt, d, a), attn_plan_text(M, d, a)),
                "K10": (lambda: attn_fwd_stats(H, mask, w1, w2),
                        lambda: attn_fwd_stats_reference(H, mask, w1, w2), err10, tol,
                        attn_stats_bound(M, dt, d, a), attn_plan_text(M, d, a)),
                "K11": (lambda: attn_bwd(H, mask, w1, w2, out, mx, dn, dout),
                        lambda: attn_bwd_reference(H, mask, w1, w2, out, mx, dn, dout), err11,
                        tol, attn_bwd_bound(M, dt, d, a), attn_plan_text(M, d, a, "bwd")),
            }
            for k, (fn, plain, err, tl, (bd, by), plan) in calls.items():
                r = dict(err=err, tol=tl, ms=cuda_ms(fn, 20), device_ms=device_ms(fn),
                         plain_ms=cuda_ms(plain, 20), library_ms=None, bound_ms=bd,
                         bound_by=by, plan=plan)
                rows[(k, name)] = r
                print(f"[attn] {k} {name}: max_abs_err={err:.3g} (tol {tl:g}"
                      f"{'' if k == 'K2' else ' rel'}) ms={r['ms']:.4f} "
                      f"device_ms={r['device_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                      f"library_ms=None bound_ms={bd:.5f} ({by}) {plan}"
                      f"{'; bitwise equal over two runs' if k == 'K11' else ''}", flush=True)
    return rows


def train_kernel_checks(gen: torch.Generator, library: dict, cases: list | None = None) -> dict:
    """K7, K8, K10 and K11 vs their plain versions at the flagship widths,
    M in {16, 200}, f32 and bf16; W = 8 with residuals in the activation
    dtype, plus a ragged window (W = 6: 40 = 6*6 + 4), the other residual
    dtype, ragged row tiles (M = 100), and a fully masked attention row.
    ``cases``: other (dtype, M, W, residual dtype) cases (phase 14a's M)."""
    dev = torch.device("cuda")
    rows = {}
    if cases is None:
        cases = [(dt, M, 8, dt) for dt in (torch.float32, torch.bfloat16) for M in (16, 200)]
        cases += [(torch.bfloat16, 200, 6, torch.bfloat16), (torch.bfloat16, 16, 8, torch.float32),
                  (torch.float32, 16, 8, torch.bfloat16), (torch.float32, 100, 8, torch.float32),
                  (torch.bfloat16, 100, 8, torch.bfloat16)]
    for dt, M, W, rdt in cases:
        name = f"{'bf16' if dt == torch.bfloat16 else 'f32'} M={M} W={W} " \
               f"res={'bf16' if rdt == torch.bfloat16 else 'f32'}"
        tol = TRAIN_TOL[dt if rdt == dt else torch.bfloat16]
        emb = (torch.randn((L, M, D), generator=gen) * 0.5).to(dev, dt)
        wih = (torch.randn((2, D, 4 * U), generator=gen) / D ** 0.5).to(dev, dt)
        b = (torch.randn((2, 1, 4 * U), generator=gen) * 0.1).to(dev)
        whh = (torch.randn((2, U, 4 * U), generator=gen) / U ** 0.5).to(dev)
        dhs = (torch.randn((L, M, H_DIM), generator=gen) * 0.1).to(dev, dt)
        hs, ch, cc = bilstm_win_fwd(emb, wih, b, whh, W, rdt)
        torch.cuda.synchronize()
        ref = bilstm_win_fwd_reference(emb, wih, b, whh, W, rdt)
        err7 = check_outputs(f"K7 {name}", {"hs": (hs, ref[0]), "ch": (ch, ref[1]),
                                            "cc": (cc, ref[2])}, tol)
        # K8 and its plain version on the same checkpoints (the kernel's).
        got8 = bilstm_win_bwd(dhs, emb, ch, cc, wih, b, whh, W)
        torch.cuda.synchronize()
        ref8 = bilstm_win_bwd_reference(dhs, emb, ch, cc, wih, b, whh, W)
        err8 = check_outputs(f"K8 {name}", dict(zip(("demb", "dwih", "db", "dwhh"),
                                                    zip(got8, ref8))), tol)

        H = (torch.rand((L, M, H_DIM), generator=gen) * 2 - 1).to(dev, dt)
        lengths = torch.randint(1, L + 1, (M,), generator=gen)
        mask = (torch.arange(L)[None, :] < lengths[:, None]).float()
        mask[1] = 0.0                                   # a fully masked row
        mask = mask.to(dev)
        w1 = (torch.randn((H_DIM, A), generator=gen) / H_DIM ** 0.5).to(dev)
        w2 = (torch.randn((A, 1), generator=gen) / A ** 0.5).to(dev)
        dout = (torch.randn((M, H_DIM), generator=gen) * 0.1).to(dev, dt)
        out, mx, dn = attn_fwd_stats(H, mask, w1, w2)
        torch.cuda.synchronize()
        ref10 = attn_fwd_stats_reference(H, mask, w1, w2)
        live = mask.sum(1) > 0
        err10 = check_outputs(f"K10 {name}", {"out": (out, ref10[0]),
                                              "mx": (mx[live], ref10[1][live]),
                                              "dn": (dn, ref10[2])}, tol)
        if mx[1].item() != np.float32(-1e30) or dn[1].item() != 0.0 \
                or out[1].abs().max().item() != 0.0:
            raise AssertionError("K10: a fully masked row must give mx=-1e30, dn=0, out=0")
        got11 = attn_bwd(H, mask, w1, w2, out, mx, dn, dout)
        torch.cuda.synchronize()
        ref11 = attn_bwd_reference(H, mask, w1, w2, out, mx, dn, dout)
        err11 = check_outputs(f"K11 {name}", dict(zip(("dH", "dw1", "dw2"), zip(got11, ref11))),
                              tol)
        if got11[0][:, 1].abs().max().item() != 0.0:
            raise AssertionError("K11: a fully masked row must get exact-zero dH")

        r = {}
        r["K7"] = dict(err=err7, tol=tol, ms=cuda_ms(lambda: bilstm_win_fwd(emb, wih, b, whh, W, rdt), 10),
                       plain_ms=cuda_ms(lambda: bilstm_win_fwd_reference(emb, wih, b, whh, W, rdt), 2))
        k8 = median_ms(lambda: bilstm_win_bwd(dhs, emb, ch, cc, wih, b, whh, W))
        r["K8"] = dict(err=err8, tol=tol, ms=k8[0], spread=k8,
                       plain_ms=cuda_ms(lambda: bilstm_win_bwd_reference(dhs, emb, ch, cc, wih, b,
                                                                         whh, W), 1))
        r["K10"] = dict(err=err10, tol=tol, ms=cuda_ms(lambda: attn_fwd_stats(H, mask, w1, w2), 20),
                        plain_ms=cuda_ms(lambda: attn_fwd_stats_reference(H, mask, w1, w2), 20),
                        library_ms=None)
        r["K11"] = dict(err=err11, tol=tol,
                        ms=cuda_ms(lambda: attn_bwd(H, mask, w1, w2, out, mx, dn, dout), 20),
                        plain_ms=cuda_ms(lambda: attn_bwd_reference(H, mask, w1, w2, out, mx, dn,
                                                                    dout), 20),
                        library_ms=None)
        if M not in library:
            library[M] = (cudnn_lstm_ms(M, False), cudnn_lstm_ms(M, True))
            print(f"[check] cuDNN f32 LSTM train mode M={M}: forward {spread_text(library[M][0])}"
                  f" ms; forward + backward {spread_text(library[M][1])} ms", flush=True)
        r["K7"]["library_ms"], r["K8"]["library_ms"] = library[M][0][0], library[M][1][0]
        r["K7"]["plan"] = plan_text(M)
        r["K8"]["plan"] = plan_text(M, W=W)
        r["K10"]["plan"] = attn_plan_text(M)
        r["K11"]["plan"] = attn_plan_text(M, which="bwd")
        for k, (bd, by) in (("K7", win_fwd_bound(M, dt, W, rdt)), ("K8", win_bwd_bound(M, dt, W, rdt)),
                            ("K10", attn_stats_bound(M, dt)), ("K11", attn_bwd_bound(M, dt))):
            r[k].update(bound_ms=bd, bound_by=by)
            rows[(k, name)] = r[k]
            print(f"[check] {k} {name}: max_abs_err={r[k]['err']:.3g} (rel tol {tol:g}) "
                  f"ms={r[k]['ms']:.4f} plain_ms={r[k]['plain_ms']:.4f} "
                  f"library_ms={r[k]['library_ms']} bound_ms={bd:.5f} ({by})"
                  f"{' ' + r[k]['plan'] if 'plan' in r[k] else ''}"
                  f"{' ms ' + spread_text(r[k]['spread']) if 'spread' in r[k] else ''}", flush=True)
    return rows


def wgrad_bound(M: int, dt: torch.dtype, h_f32: bool):
    """lstm_wgrad: reads da (f32), emb, the h_prev source (hp in f32, or hs
    in the activation dtype) and W_ih once, writes demb and the weight
    gradients; f32 operations: demb = da W_ih^T, emb^T da, h^T da, sum da."""
    es, G, rows = torch.finfo(dt).bits // 8, 4 * U, L * M
    moved = (2 * rows * G * 4 + rows * D * es + 2 * rows * U * (4 if h_f32 else es)
             + 2 * D * G * es + 2 * rows * D * es + (2 * D * G + 2 * G + 2 * U * G) * 4)
    ops = 2 * (2 * rows * G * (2 * D + U) + rows * G)
    return bound(moved, ops / PEAK_FLOPS[torch.float32])


def hp_from_hs(hs: torch.Tensor) -> torch.Tensor:
    """The h_prev stream [2, L, M, u] (f32) that K6 reads from its saved hs:
    each direction's hs at the kernel-previous step, zero at the first."""
    hp = hs.new_zeros((2,) + hs.shape[:2] + (U,), dtype=torch.float32)
    hp[0, 1:] = hs[:-1, :, :U].float()
    hp[1, :-1] = hs[1:, :, U:].float()
    return hp


def wgrad_checks(gen: torch.Generator) -> dict:
    """The weight-gradient kernel alone vs its plain version on the same
    streams: da and K8's hp (f32), and da with K6's saved hs (read at the
    kernel-previous step), at M in {16, 200}, f32 and bf16; run twice, the
    outputs must repeat bit for bit (no atomics)."""
    dev = torch.device("cuda")
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        for M in (16, 200):
            emb = (torch.randn((L, M, D), generator=gen) * 0.5).to(dev, dt)
            wih = (torch.randn((2, D, 4 * U), generator=gen) / D ** 0.5).to(dev, dt)
            da = (torch.randn((2, L, M, 4 * U), generator=gen) * 0.1).to(dev)
            hp = (torch.rand((2, L, M, U), generator=gen) * 2 - 1).to(dev)
            hs = (torch.rand((L, M, H_DIM), generator=gen) * 2 - 1).to(dev, dt)
            tol = TRAIN_TOL[dt]
            for src, h, want_h in (("hp", hp, hp), ("hs", hs, hp_from_hs(hs))):
                name = f"{'bf16' if dt == torch.bfloat16 else 'f32'} M={M} {src}"
                got = lstm_wgrad(da, emb, h, wih)
                again = lstm_wgrad(da, emb, h, wih)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(got, again)):
                    raise AssertionError(f"lstm_wgrad {name}: two runs differ")
                ref = lstm_wgrad_reference(da, emb, want_h, wih)
                err = check_outputs(f"lstm_wgrad {name}", dict(zip(
                    ("demb", "dwih", "db", "dwhh"), zip(got, ref))), tol)
                bd, by = wgrad_bound(M, dt, src == "hp")
                r = dict(err=err, tol=tol, ms=cuda_ms(lambda: lstm_wgrad(da, emb, h, wih), 20),
                         plain_ms=cuda_ms(lambda: lstm_wgrad_reference(da, emb, want_h, wih), 20),
                         library_ms=None, bound_ms=bd, bound_by=by)
                rows[("wgrad", name)] = r
                print(f"[check] lstm_wgrad {name}: max_abs_err={err:.3g} (rel tol {tol:g}) "
                      f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms=None "
                      f"bound_ms={bd:.5f} ({by}); bitwise equal over two runs", flush=True)
    return rows


def full_fwd_bound(M: int, dt: torch.dtype, rdt: torch.dtype):
    """K4: K1's work plus c written at every step in the residual dtype."""
    t_bytes, t_ops = lstm_bound_parts(M, dt)
    return bound(t_bytes + L * M * H_DIM * (torch.finfo(rdt).bits // 8), t_ops)


def full_bwd_bound(M: int, dt: torch.dtype, rdt: torch.dtype):
    """K6: reads dhs, emb, hs, cs and the weights once, writes demb and the
    weight gradients; the operations are K8's (gates once, four products)."""
    es, rs, G = torch.finfo(dt).bits // 8, torch.finfo(rdt).bits // 8, 4 * U
    moved = (2 * L * M * H_DIM * es + L * M * D * es + L * M * H_DIM * rs     # dhs, hs, emb, cs
             + 2 * D * G * es + 2 * G * 4 + 2 * U * G * 4                     # weights
             + 2 * L * M * D * es + (2 * D * G + 2 * G + 2 * U * G) * 4)       # demb, dW
    ops_in = 2 * L * 2 * M * D * G
    ops_f32 = 2 * L * (2 * M * U * G + 4 * M * G * (D + U))
    return bound(moved, ops_in / PEAK_FLOPS[dt] + ops_f32 / PEAK_FLOPS[torch.float32])


def full_kernel_checks(gen: torch.Generator, library: dict) -> dict:
    """Phase 7: K4 and K6 vs their plain versions (K6's plain version on
    the kernel's own hs/cs) at the flagship widths, M in {16, 200} and a
    ragged M=100 (not a multiple of K4's 16-row or K6's 8-row tile), f32
    and bf16 with both residual dtypes; f32 K6 vs f32 K8 (W=8) gradients."""
    dev = torch.device("cuda")
    rows = {}
    err68 = 0.0
    cases = [(dt, M, dt) for dt in (torch.float32, torch.bfloat16) for M in (16, 200)]
    cases += [(torch.bfloat16, 100, torch.float32), (torch.float32, 100, torch.bfloat16)]
    for dt, M, rdt in cases:
        name = f"{'bf16' if dt == torch.bfloat16 else 'f32'} M={M} " \
               f"res={'bf16' if rdt == torch.bfloat16 else 'f32'}"
        tol = TRAIN_TOL[dt if rdt == dt else torch.bfloat16]
        emb = (torch.randn((L, M, D), generator=gen) * 0.5).to(dev, dt)
        wih = (torch.randn((2, D, 4 * U), generator=gen) / D ** 0.5).to(dev, dt)
        b = (torch.randn((2, 1, 4 * U), generator=gen) * 0.1).to(dev)
        whh = (torch.randn((2, U, 4 * U), generator=gen) / U ** 0.5).to(dev)
        dhs = (torch.randn((L, M, H_DIM), generator=gen) * 0.1).to(dev, dt)
        hs, cs = bilstm_full_fwd(emb, wih, b, whh, rdt)
        torch.cuda.synchronize()
        ref4 = bilstm_full_fwd_reference(emb, wih, b, whh, rdt)
        err4 = check_outputs(f"K4 {name}", {"hs": (hs, ref4[0]), "cs": (cs, ref4[1])}, tol)
        got6 = bilstm_full_bwd(dhs, emb, hs, cs, wih, b, whh)
        torch.cuda.synchronize()
        ref6 = bilstm_full_bwd_reference(dhs, emb, hs, cs, wih, b, whh)
        err6 = check_outputs(f"K6 {name}", dict(zip(("demb", "dwih", "db", "dwhh"),
                                                    zip(got6, ref6))), tol)
        if dt == rdt == torch.float32:
            # f32 residuals: K8's window replay is the forward's own f32
            # arithmetic, so both backwards see the same states; they sum in
            # other orders (per-step slabs vs replayed windows).
            _, ch, cc = bilstm_win_fwd(emb, wih, b, whh, 8, rdt)
            got8 = bilstm_win_bwd(dhs, emb, ch, cc, wih, b, whh, 8)
            torch.cuda.synchronize()
            err68 = max(err68, check_outputs(f"K6 vs K8 {name}", dict(zip(
                ("demb", "dwih", "db", "dwhh"), zip(got6, got8))), K6_K8_TOL))
        r = {}
        r["K4"] = dict(err=err4, tol=tol, ms=cuda_ms(lambda: bilstm_full_fwd(emb, wih, b, whh, rdt), 10),
                       plain_ms=cuda_ms(lambda: bilstm_full_fwd_reference(emb, wih, b, whh, rdt), 2))
        k6 = median_ms(lambda: bilstm_full_bwd(dhs, emb, hs, cs, wih, b, whh))
        r["K6"] = dict(err=err6, tol=tol, ms=k6[0], spread=k6,
                       plain_ms=cuda_ms(lambda: bilstm_full_bwd_reference(dhs, emb, hs, cs, wih,
                                                                          b, whh), 1))
        if M not in library:
            library[M] = (cudnn_lstm_ms(M, False), cudnn_lstm_ms(M, True))
        r["K4"]["library_ms"], r["K6"]["library_ms"] = library[M][0][0], library[M][1][0]
        r["K4"]["plan"] = plan_text(M)
        r["K6"]["plan"] = plan_text(M, W=0)
        for k, (bd, by) in (("K4", full_fwd_bound(M, dt, rdt)), ("K6", full_bwd_bound(M, dt, rdt))):
            r[k].update(bound_ms=bd, bound_by=by)
            rows[(k, name)] = r[k]
            print(f"[check] {k} {name}: max_abs_err={r[k]['err']:.3g} (rel tol {tol:g}) "
                  f"ms={r[k]['ms']:.4f} plain_ms={r[k]['plain_ms']:.4f} "
                  f"library_ms={r[k]['library_ms']} bound_ms={bd:.5f} ({by})"
                  f"{' ' + r[k]['plan'] if 'plan' in r[k] else ''}"
                  f"{' ms ' + spread_text(r[k]['spread']) if 'spread' in r[k] else ''}", flush=True)
    print(f"[check] K6 vs K8 (W=8) f32 gradients: max abs err {err68:.3g} (rel tol "
          f"{K6_K8_TOL:g})", flush=True)
    return rows


def split_bound(key: str, M: int, dt: torch.dtype):
    """Kernels 2, 1, 3 over 2 groups: xg (4u a row and group) streamed once,
    hs (u) written (kernel 2), plus cs (kernel 1); kernel 3 reads dhs, xg,
    hs, cs and writes dxg and dW_hh. f32 operations: the recurrent product
    per step and group (kernel 3: the gates once, da W_hh^T and h^T da)."""
    es, G = torch.finfo(dt).bits // 8, 4 * U
    rows, w = L * M * 2, 2 * U * G * 4
    if key == "split2":
        moved, prods = rows * (G + U) * es + w, 1
    elif key == "split1":
        moved, prods = rows * (G + 2 * U) * es + w, 1
    else:
        moved, prods = rows * (2 * G + 3 * U) * es + 2 * w, 3
    return bound(moved, prods * 2 * rows * U * G / PEAK_FLOPS[torch.float32])


def split_library(M: int, gen: torch.Generator) -> dict:
    """Kernels 2, 1 and 3's yardstick, timed here and used nowhere in the
    port: one f32 torch.nn.LSTM(8u, u, bidirectional=True) call (cuDNN)
    computes ``bilstm_recurrence_tm`` on [L, M, 8u] when its input weights
    are the identity blocks [I_4u | 0] (forward) and [0 | I_4u] (reverse),
    its biases zero and its recurrent weights W_hh[d]^T: the gate order is
    [i, f, g, o] in both, and the reverse direction walks time reversed with
    its output in natural time. The identity input product is exact in f32,
    and is work the kernels do not do (printed as its time at the f32 peak).
    Held against kernel 2 on the same input, then timed without grad
    (kernel 2), as a train-mode forward (kernel 1), and forward + backward
    (kernel 3)."""
    dev = torch.device("cuda")
    G = 4 * U
    lstm = torch.nn.LSTM(2 * G, U, bidirectional=True).to(dev).train()
    whh = (torch.randn((2, U, G), generator=gen) / U ** 0.5).to(dev)
    eye, zero = torch.eye(G, device=dev), torch.zeros((G, G), device=dev)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.cat([eye, zero], 1))
        lstm.weight_ih_l0_reverse.copy_(torch.cat([zero, eye], 1))
        lstm.weight_hh_l0.copy_(whh[0].T)
        lstm.weight_hh_l0_reverse.copy_(whh[1].T)
        for bias in (lstm.bias_ih_l0, lstm.bias_hh_l0, lstm.bias_ih_l0_reverse,
                     lstm.bias_hh_l0_reverse):
            bias.zero_()
    lstm.flatten_parameters()
    xg = (torch.randn((L, M, 2 * G), generator=gen) * 0.5).to(dev)
    g = (torch.randn((L, M, H_DIM), generator=gen) * 0.1).to(dev)
    with torch.no_grad():
        want = lstm_split_infer_cuda(xg, whh, True)
        got = lstm(xg)[0]
        torch.cuda.synchronize()
        err = check_outputs(f"cuDNN identity-input LSTM vs kernel 2 f32 M={M}",
                            {"hs": (got, want)}, TRAIN_TOL[torch.float32])
        infer = cuda_ms(lambda: lstm(xg), 10)
    x = xg.clone().requires_grad_()

    def fwd_bwd():
        torch.autograd.backward(lstm(x)[0], g)
    out = {"split2": infer, "split1": cuda_ms(lambda: lstm(x), 10), "split3": cuda_ms(fwd_bwd, 10)}
    eye_ms = 2 * 2 * L * M * 2 * G * G / PEAK_FLOPS[torch.float32] * 1e3
    print(f"[split] library yardstick M={M}: cuDNN f32 LSTM(8u, u) with identity input weights "
          f"equals kernel 2 (max abs err {err:.3g}); ms no-grad {out['split2']:.4f} forward "
          f"{out['split1']:.4f} forward+backward {out['split3']:.4f}; its identity input "
          f"product takes {eye_ms:.4f} ms of the forward at the f32 peak", flush=True)
    return out


def split_recurrence(gen: torch.Generator) -> dict:
    """Phase 8: the split-recurrence ops API on the card. The path (public
    calls, kernel backend, counts zeroed just before and read just after),
    then its outputs vs the plain backend, kernel 3 vs its plain version on
    the same residuals, and the time-major layout vs the grouped one fed
    the flipped input."""
    dev = torch.device("cuda")
    G = 4 * U
    cases = [(dt, M, tm) for dt in (torch.float32, torch.bfloat16) for M in (16, 200)
             for tm in (False, True)]
    inputs = {}
    for dt, M, tm in cases:
        shape = (L, M, 2 * G) if tm else (2, M, L, G)
        xg = (torch.randn(shape, generator=gen) * 0.5).to(dev, dt)
        whh = (torch.randn((2, U, G), generator=gen) / U ** 0.5).to(dev)
        ct = (torch.randn((L, M, H_DIM) if tm else (2, M, L, U), generator=gen) * 0.1).to(dev, dt)
        inputs[(dt, M, tm)] = (xg, whh, ct)

    def api(tm):
        return bilstm_recurrence_tm if tm else lstm_recurrence_grouped

    def run(xg, whh, ct, tm, backend):
        with torch.no_grad():
            h_nog = api(tm)(xg, whh, backend=backend)
        x, w = xg.clone().requires_grad_(), whh.clone().requires_grad_()
        h = api(tm)(x, w, backend=backend)
        torch.autograd.backward(h, ct)
        return h_nog, h.detach(), x.grad, w.grad

    torch.cuda.synchronize()
    for fn in SPLIT_KERNELS.values():
        fn.launches = 0
    outs = {case: run(*inp, case[2], "cuda") for case, inp in inputs.items()}
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in SPLIT_KERNELS.items()}
    print(f"[split] {len(cases)} calls without grad and {len(cases)} with forward + backward "
          f"through lstm_recurrence_grouped / bilstm_recurrence_tm: launches {launches}",
          flush=True)
    if any(n != len(cases) for n in launches.values()):
        raise AssertionError(f"split kernels launched {launches}, expected {len(cases)} each")

    rows, library = {}, {}
    for (dt, M, tm), (xg, whh, ct) in inputs.items():
        name = f"{'bf16' if dt == torch.bfloat16 else 'f32'} M={M} {'tm' if tm else 'grouped'}"
        tol = TRAIN_TOL[dt]
        h_nog, h, dx, dw = outs[(dt, M, tm)]
        ref = run(xg, whh, ct, tm, "reference")
        err2 = check_outputs(f"kernel 2 {name}", {"hs": (h_nog, ref[0])}, tol)
        # The autograd path: hs of kernel 1; the gradients went through
        # kernel 3 on kernel 1's residuals, the plain ones on the plain
        # forward's, which may differ by one bf16 ulp (the training band).
        err1 = check_outputs(f"kernel 1 {name}", {"hs": (h, ref[1])}, tol)
        check_outputs(f"split grads {name}", {"dxg": (dx, ref[2]), "dwhh": (dw, ref[3])},
                      tol if dt == torch.float32 else GRAD_REL_TOL)
        hs, cs = lstm_split_fwd(xg, whh, tm)
        got3 = lstm_split_bwd(ct, xg, hs, cs, whh, tm)
        torch.cuda.synchronize()
        ref1 = lstm_split_fwd_reference(xg, whh, tm)
        err1 = max(err1, check_outputs(f"kernel 1 {name}", {"hs": (hs, ref1[0]),
                                                             "cs": (cs, ref1[1])}, tol))
        err3 = check_outputs(f"kernel 3 {name}", dict(zip(("dxg", "dwhh"), zip(
            got3, lstm_split_bwd_reference(ct, xg, hs, cs, whh, tm)))), tol)
        if tm:
            flipped = torch.stack([xg[..., :G].transpose(0, 1),
                                   xg[..., G:].flip(0).transpose(0, 1)]).contiguous()
            with torch.no_grad():
                hg = lstm_recurrence_grouped(flipped, whh, backend="cuda")
            want = torch.cat([hg[0], hg[1].flip(1)], -1).transpose(0, 1)
            check_outputs(f"tm vs grouped layout {name}", {"hs": (h_nog, want)}, tol)
        r = {}
        r["split2"] = dict(err=err2, ms=cuda_ms(lambda: lstm_split_infer_cuda(xg, whh, tm), 10),
                           plain_ms=cuda_ms(lambda: lstm_split_infer_reference(xg, whh, tm), 2))
        r["split1"] = dict(err=err1, ms=cuda_ms(lambda: lstm_split_fwd(xg, whh, tm), 10),
                           plain_ms=cuda_ms(lambda: lstm_split_fwd_reference(xg, whh, tm), 2))
        r["split3"] = dict(err=err3, ms=cuda_ms(lambda: lstm_split_bwd(ct, xg, hs, cs, whh, tm), 10),
                           plain_ms=cuda_ms(lambda: lstm_split_bwd_reference(ct, xg, hs, cs, whh,
                                                                             tm), 1))
        if M not in library:
            library[M] = split_library(M, gen)
        for k in r:
            bd, by = split_bound(k, M, dt)
            r[k].update(tol=tol, library_ms=library[M][k], bound_ms=bd, bound_by=by)
            rows[(k, name)] = r[k]
            plan = f" {plan_text(M, 0, W=0 if k == 'split3' else None)}"
            print(f"[check] {k} {name}: max_abs_err={r[k]['err']:.3g} (rel tol {tol:g}) "
                  f"ms={r[k]['ms']:.4f} plain_ms={r[k]['plain_ms']:.4f} "
                  f"library_ms={r[k]['library_ms']:.4f} bound_ms={bd:.5f} ({by}){plan}",
                  flush=True)
    print("[split] time-major layout equals the grouped one fed the flipped input", flush=True)
    return {"rows": rows, "launches": launches}


# The optimizer pair vs its plain versions on the flagship parameter list
# (every rule x word-table mode): p, m and v within OPTIM_TOL of each
# tensor's scale (the same f32 formulas; nvcc contracts them into fused
# multiply-adds and the card's powf may round the bias corrections one ulp
# apart), the norm within OPTIM_TOL of the plain twin's (the same chunks, a
# different order inside each) and bitwise equal over two runs.
OPTIM_TOL = 1e-6
OPTIM_MODES = ([(o, e) for o in ("adam", "adamw", "sgd") for e in ("shared", "sgd", "frozen")]
               + [("adam", "nodecay")])     # the lazy table's rule, and its dense twin's
# The segment sum vs index_put_ with accumulate on the flagship batch's word
# ids: the same f32 terms per row in another order (atomics); the padding
# id's row sums thousands of terms, so the bar is relative to the output's
# largest magnitude.
SEGSUM_TOL = 1e-5


def optim_bytes(numels: list, rules: list) -> float:
    """Bytes the update must move: p, g, m, v read and p, m, v written for
    a tensor with moments, p and g read and p written otherwise."""
    return sum(n * 4 * (7 if r in MOMENT_RULES else 3) for n, r in zip(numels, rules))


def optim_checks(model, gen: torch.Generator) -> dict:
    """Phase 6c: the optimizer pair (``optim_sumsq``, ``optim_update``) vs
    the plain twin and the per-parameter loop on the flagship parameter
    list, for every rule and word-table mode, from random parameters,
    gradients and moments at update count 2000 (past the first staircase
    step); the clip engaged on every other mode. Times for Adam with a
    shared table, beside the bound, the plain versions and the library
    yardsticks (``get_total_norm``; ``Adam(fused=True)``; and the pair
    against ``clip_grad_norm_`` + ``Adam(fused=True)``)."""
    dev = torch.device("cuda")
    cfg = ExperimentConfig()
    hp = OptimHyper(cfg.lr, cfg.lr_gamma, cfg.lr_step_size, cfg.weight_decay, cfg.grad_clip)
    names = [n for n, _ in model.named_parameters()]
    shapes = [p.shape for p in model.parameters()]

    def rand(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    rows, timed = {}, None
    for idx, (o, e) in enumerate(OPTIM_MODES):
        table_rule = {"shared": o, "sgd": "sgd_plain", "frozen": "frozen",
                      "nodecay": "adam_nodecay"}[e]
        rules = [table_rule if n == WORD_TABLE else o for n in names]
        live = [i for i, r in enumerate(rules) if r != "frozen"]
        rl = [rules[i] for i in live]
        params = [rand(shapes[i], 0.1) for i in live]
        grads = [rand(shapes[i], 1e-3 if idx % 2 else 1e-2) for i in live]
        mus = [rand(shapes[i], 1e-3) if rules[i] in MOMENT_RULES else None for i in live]
        nus = [rand(shapes[i], 1e-3).square() if rules[i] in MOMENT_RULES else None
               for i in live]
        ws = make_workspace(params)
        norm = optim_sumsq(params, grads, ws)
        again = optim_sumsq(params, grads, ws)
        want = optim_sumsq_reference(params, grads)
        if not torch.equal(norm, again):
            raise AssertionError(f"optim_sumsq {o}/{e}: two runs differ ({norm} vs {again})")
        n_err, n_rel = rel_err(norm, want)
        if n_rel > OPTIM_TOL:
            raise AssertionError(f"optim_sumsq {o}/{e}: relative error {n_rel:.3g} > {OPTIM_TOL}")

        def clone(xs):
            return [None if x is None else x.clone() for x in xs]

        kp, km, kv, pp, pm, pv = (clone(x) for x in (params, mus, nus, params, mus, nus))
        k_count = torch.full((), 2000, dtype=torch.int64, device=dev)
        p_count = k_count.clone()
        optim_update(kp, grads, km, kv, rl, norm, k_count, hp, ws)
        optim_update_reference(pp, grads, pm, pv, rl, norm, p_count, hp)
        if int(k_count) != 2001 or int(p_count) != 2001:
            raise AssertionError(f"optim_update {o}/{e}: count {int(k_count)}, "
                                 f"plain {int(p_count)}")
        pairs = {f"{names[i]}.{w}": (a, b) for i, *trip in zip(live, kp, km, kv, pp, pm, pv)
                 for w, a, b in (("p", trip[0], trip[3]), ("m", trip[1], trip[4]),
                                 ("v", trip[2], trip[5])) if a is not None}
        err = check_outputs(f"optim_update {o}/{e}", pairs, OPTIM_TOL)
        clipped = float(norm) >= hp.grad_clip
        rows[(o, e)] = {"err": max(err, n_err), "norm": float(norm), "clipped": clipped}
        print(f"[optim] {o:5s} table {e:6s}: {len(live)} tensors, "
              f"{sum(p.numel() for p in params)} elements, norm {float(norm):.6g} "
              f"({'clip engaged' if clipped else 'no clip'}), norm vs twin rel {n_rel:.3g}, "
              f"update vs loop max abs err {err:.3g} (tol {OPTIM_TOL} of scale); sumsq bitwise "
              f"over two runs", flush=True)
        if (o, e) == ("adam", "shared"):
            timed = (params, grads, kp, km, kv, pp, pm, pv, rl, norm, k_count, p_count, ws)

    params, grads, kp, km, kv, pp, pm, pv, rl, norm, k_count, p_count, ws = timed
    numels = [p.numel() for p in params]
    n_all = sum(numels)
    sumsq_bound = bound(4 * n_all + 4, 3 * n_all / PEAK_FLOPS[torch.float32])
    update_bound = bound(optim_bytes(numels, rl), 20 * n_all / PEAK_FLOPS[torch.float32])
    # Device time under the profiler (``device_ms``) for the kernels, the
    # plain versions and the library calls alike: inside the step's graph
    # no host time separates the launches, and an eager call of a wrapper
    # (its host table, checks and ctypes call) takes longer on the host
    # than its kernel on the card. ``ms_events`` keeps the CUDA-event time
    # of the eager calls.
    ev_sumsq = cuda_ms(lambda: optim_sumsq(params, grads, ws), 20)
    ev_update = cuda_ms(lambda: optim_update(kp, grads, km, kv, rl, norm, k_count, hp, ws), 20)
    ms_sumsq = device_ms(lambda: optim_sumsq(params, grads, ws))
    ms_update = device_ms(lambda: optim_update(kp, grads, km, kv, rl, norm, k_count, hp, ws))
    plain_sumsq = device_ms(lambda: optim_sumsq_reference(params, grads), 5)
    plain_update = device_ms(
        lambda: optim_update_reference(pp, grads, pm, pv, rl, norm, p_count, hp), 5)
    lib_sumsq = (device_ms(lambda: torch.nn.utils.get_total_norm(grads))
                 if hasattr(torch.nn.utils, "get_total_norm") else None)
    lib_params = [torch.nn.Parameter(p.clone()) for p in params]
    for p, g in zip(lib_params, grads):
        p.grad = g.clone()
    adam = torch.optim.Adam(lib_params, lr=hp.lr, weight_decay=hp.weight_decay, fused=True)
    lib_update = device_ms(adam.step)

    def clip_and_adam():
        torch.nn.utils.clip_grad_norm_(lib_params, hp.grad_clip)
        adam.step()

    lib_pair = device_ms(clip_and_adam)
    print(f"[optim] adam/shared, {len(params)} tensors, {n_all} elements, device ms: sumsq "
          f"{ms_sumsq:.4f} (bound {sumsq_bound[0]:.4f}, plain twin {plain_sumsq:.4f}, "
          f"get_total_norm {'n/a' if lib_sumsq is None else f'{lib_sumsq:.4f}'}); update "
          f"{ms_update:.4f} (bound {update_bound[0]:.4f} by {update_bound[1]}, per-parameter loop "
          f"{plain_update:.4f}, Adam(fused=True) {lib_update:.4f}); pair "
          f"{ms_sumsq + ms_update:.4f} vs clip_grad_norm_ + Adam(fused=True) {lib_pair:.4f}; "
          f"eager calls by CUDA events: sumsq {ev_sumsq:.4f}, update {ev_update:.4f}", flush=True)
    err = max(r["err"] for r in rows.values())
    return {
        "optim_sumsq": {"err": err, "ms": ms_sumsq, "plain_ms": plain_sumsq,
                        "bound_ms": sumsq_bound[0], "bound_by": sumsq_bound[1],
                        "library_ms": lib_sumsq, "ms_events": ev_sumsq},
        "optim_update": {"err": err, "ms": ms_update, "plain_ms": plain_update,
                         "bound_ms": update_bound[0], "bound_by": update_bound[1],
                         "library_ms": lib_update, "ms_events": ev_update,
                         "pair_ms": ms_sumsq + ms_update, "clip_grad_norm_adam_fused_ms": lib_pair},
    }


def segsum_checks(model, support: dict, query: dict, gen: torch.Generator) -> dict:
    """Phase 6d: the segment sum (``segsum``: ``index_add_`` of the token
    rows into a zeroed f32 [V, D], a library call, not a hand kernel) vs
    its plain version (``index_put_`` with accumulate, what autograd of
    ``table[ids]`` ran before; it sorts the ids) on the flagship batch's
    word ids, time-major [L, M] as the embedding gathers them, with the
    cotangent a [..., :50] slice of a [L, M, 60] gradient as in the step's
    backward; both device times beside the bound."""
    dev = torch.device("cuda")
    V, Dw = model.embedding.word_embedding.shape
    words = np.concatenate([support["word"].reshape(-1, L), query["word"].reshape(-1, L)])
    ids = torch.from_numpy(words.T.copy()).long().to(dev)                 # [L, M]
    wide = (torch.randn(tuple(ids.shape) + (Dw + 10,), generator=gen) * 0.1).to(dev)
    cot = wide[..., :Dw]
    got, again = segsum(cot, ids, V), segsum(cot, ids, V)
    want = segsum_reference(cot, ids, V)
    err, rel = rel_err(got, want)
    run_diff = (got - again).abs().max().item()
    T = ids.numel()
    uniq, counts = torch.unique(ids, return_counts=True)
    print(f"[segsum] {T} tokens, {uniq.numel()} distinct rows of {V}, the most shared row "
          f"{int(counts.max())} tokens: index_add_ vs index_put_ max abs err {err:.3g} (rel "
          f"{rel:.3g}, tol {SEGSUM_TOL}); two runs differ by {run_diff:.3g} (f32 atomics)",
          flush=True)
    if rel > SEGSUM_TOL:
        raise AssertionError(f"segsum: relative error {rel:.3g} > {SEGSUM_TOL}")
    ms = device_ms(lambda: segsum(cot, ids, V))
    plain = device_ms(lambda: segsum_reference(cot, ids, V))
    b = bound(V * Dw * 4 + T * Dw * 4 + T * 8, T * Dw / PEAK_FLOPS[torch.float32])
    print(f"[segsum] device ms: index_add_ {ms:.4f} (zero fill included), bound {b[0]:.4f} "
          f"({b[1]}), index_put_ (plain) {plain:.4f}", flush=True)
    return {"err": err, "ms": ms, "plain_ms": plain, "bound_ms": b[0], "bound_by": b[1]}


# Phase 9c's real-format files: FewRel 1.0's published split sizes (64 train,
# 16 val relations of 700 instances; the test split 16 more) from the
# synthetic generator, and a GloVe word2id JSON + .npy of the flagship
# table's 400 000 words (the loader appends [UNK] and [BLANK]).
REAL_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_real"
REAL_SPLITS = {"train": (64, 0), "val": (16, 1), "test": (16, 2)}
REAL_INSTANCES = 700
# Distinct words the sentences draw from: a real corpus of this size uses
# tens of thousands of the table's 400 000 (the JAX package: "real corpora
# run 40-60k rows", models/embedding.py), not all of them. So the lazy
# run's compact rows, and its ring deltas, cover about an eighth of the
# table, as a FewRel run's would.
REAL_CORPUS_WORDS = 50_000


def fewrel_record(inst) -> dict:
    return {"tokens": list(inst.tokens), "h": [inst.head_name, "Q1", [list(inst.head_pos)]],
            "t": [inst.tail_name, "Q2", [list(inst.tail_pos)]]}


def write_real_files(directory: Path) -> dict:
    """Write the splits and the GloVe pair to ``directory``; returns their
    paths and the generators' objects they were written from."""
    cfg = ExperimentConfig()
    directory.mkdir(parents=True, exist_ok=True)
    vocab = make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim)
    words = sorted(((i, w) for w, i in vocab.word2id.items() if i < cfg.vocab_size - 2))
    paths = {"glove": directory / "glove_word2id.json", "glove_mat": directory / "glove_mat.npy"}
    paths["glove"].write_text(json.dumps({w: i for i, w in words}))
    np.save(paths["glove_mat"], vocab.vectors[:cfg.vocab_size - 2])
    data = {}
    for split, (n_rel, seed) in REAL_SPLITS.items():
        ds = make_synthetic_fewrel(num_relations=n_rel, instances_per_relation=REAL_INSTANCES,
                                   vocab_size=REAL_CORPUS_WORDS, seed=seed)
        paths[split] = directory / f"{split}.json"
        paths[split].write_text(json.dumps({r: [fewrel_record(i) for i in ds.instances[r]]
                                            for r in ds.rel_names}))
        data[split] = ds
    return {"paths": paths, "vocab": vocab, "data": data}


def real_argv(paths: dict, *splits: str) -> list:
    out = ["--glove", str(paths["glove"]), "--glove_mat", str(paths["glove_mat"])]
    for split in splits:
        out += [f"--{split}_file", str(paths[split])]
    return out


# The lazy word table's kernels (phase 9d) vs their plain versions: the same
# f32 operations in the same order, but CUDA's powf and PyTorch's pow of
# the bias corrections may differ by an ulp, so outputs are held within 1e-6
# of each output's scale (the JAX bar for lazy vs dense Adam,
# tests/test_lazy_embed.py); pad lanes, rows left out and never-touched
# rows bitwise.
LAZY_TOL = 1e-6
LAZY_GAPS = (0, 1, 2, 7, 1023, 1024, 1025, 1500)
LAZY_T = 2600                   # past the flagship's first staircase step (2000)


def lazy_state(gen: torch.Generator, V: int, D: int, t: int) -> dict:
    """A lazy table state at update count ``t``: 20 % of the rows alive
    (nonzero moments) with gaps 0-1500 (LAZY_GAPS beyond the cap among
    them), the rest never touched (zero moments, any last)."""
    dev = torch.device("cuda")
    alive = torch.rand(V, generator=gen) < 0.2
    gaps = torch.randint(0, 1501, (V,), generator=gen)
    gaps[:len(LAZY_GAPS)] = torch.tensor(LAZY_GAPS)
    alive[:len(LAZY_GAPS)] = True
    last = torch.where(alive, t - gaps, torch.randint(0, t + 1, (V,), generator=gen))
    m = torch.randn((V, D), generator=gen) * 1e-3 * alive[:, None]
    v = (torch.randn((V, D), generator=gen) * 1e-3).square() * alive[:, None]
    return {"table": (torch.randn((V, D), generator=gen) * 0.5).to(dev), "m": m.to(dev),
            "v": v.to(dev), "last": last.to(torch.int32).to(dev), "alive": alive.to(dev)}


def lazy_kernel_checks(gen: torch.Generator, uids: torch.Tensor, live_tokens: int) -> dict:
    """Phase 9d's kernel checks at the flagship table (400 002 x 50) and
    schedule: ``lazy_catchup`` at R = U (the token cache's corpus rows
    ``uids``) and at a live batch's R (its distinct ids, then pad lanes),
    ``lazy_materialize`` (the catch-up in place over the whole table) and
    ``lazy_scatter`` (pad lanes dropped), each vs its plain version; then
    device times at R = U and for materialize, the bound (bytes) and the
    plain versions, and for the scatter the library yardstick (four
    ``index_copy_`` calls)."""
    dev = torch.device("cuda")
    cfg = ExperimentConfig()
    V, D = cfg.vocab_size, cfg.word_dim
    hp = OptimHyper(cfg.lr, cfg.lr_gamma, cfg.lr_step_size, 0.0, cfg.grad_clip)
    st = lazy_state(gen, V, D, LAZY_T)
    count = torch.tensor(LAZY_T, dtype=torch.int64, device=dev)
    live = torch.unique(torch.randint(0, V - 1, (live_tokens,), generator=gen))
    live = torch.cat([live, torch.full((live_tokens - live.numel(),), V)]).to(torch.int32)
    worst, out = 0.0, {}
    for tag, ids in (("cached", uids), ("live", live.to(dev))):
        R = ids.numel()
        bufs = tuple(torch.empty((R, D), device=dev) for _ in range(3))
        lazy_catchup(st["table"], st["m"], st["v"], st["last"], ids, count, hp, bufs)
        want = lazy_catchup_reference(st["table"], st["m"], st["v"], st["last"], ids, LAZY_T, hp)
        worst = max(worst, check_outputs(f"lazy_catchup {tag}", dict(zip("Wmv", zip(bufs, want))),
                                         LAZY_TOL))
        pad = ids.long() >= V
        if pad.any() and not all(torch.equal(b[pad], w[pad]) for b, w in zip(bufs, want)):
            raise AssertionError("lazy_catchup: pad lanes differ from the clamped row")
        out[tag] = (ids, bufs)
        print(f"[lazy] lazy_catchup {tag}: R={R} ({int(pad.sum())} pad lanes) at t={LAZY_T}, "
              f"gaps 0-1500 (cap {CATCHUP_CAP}): max abs err {worst:.3g} (tol {LAZY_TOL} of "
              f"scale)", flush=True)
    # Materialize: in place over the whole table.
    k_state = {k: st[k].clone() for k in ("table", "m", "v", "last")}
    lazy_materialize(k_state["table"], k_state["m"], k_state["v"], k_state["last"], count, hp)
    W, mm, vv = lazy_catchup_reference(st["table"], st["m"], st["v"], st["last"], None, LAZY_T,
                                       hp)
    worst = max(worst, check_outputs("lazy_materialize", {"W": (k_state["table"], W),
                                                          "m": (k_state["m"], mm),
                                                          "v": (k_state["v"], vv)}, LAZY_TOL))
    dead = ~st["alive"]
    if not torch.equal(k_state["table"][dead], st["table"][dead]) \
            or not torch.equal(k_state["last"][dead], st["last"][dead]) \
            or bool((k_state["last"][st["alive"]] != LAZY_T).any()):
        raise AssertionError("lazy_materialize: a never-touched row moved, or last is wrong")
    # Scatter (live ids: pad lanes dropped).
    ids, bufs = out["live"]
    rows = tuple(torch.randn(b.shape, generator=gen).to(dev) for b in bufs)
    k_state = {k: st[k].clone() for k in ("table", "m", "v", "last")}
    p_state = {k: st[k].clone() for k in ("table", "m", "v", "last")}
    lazy_scatter(k_state["table"], k_state["m"], k_state["v"], k_state["last"], ids, rows, count)
    lazy_scatter_reference(p_state["table"], p_state["m"], p_state["v"], p_state["last"], ids,
                           *rows, LAZY_T)
    if not all(torch.equal(k_state[k], p_state[k]) for k in k_state):
        raise AssertionError("lazy_scatter differs from its plain version")
    if not torch.equal(k_state["table"][V - 1], st["table"][V - 1]):
        raise AssertionError("lazy_scatter wrote a pad lane")
    print(f"[lazy] lazy_materialize over {V} rows ({int(dead.sum())} never touched, left "
          f"bitwise): within {LAZY_TOL} of scale; lazy_scatter of {ids.numel()} rows with pad "
          f"lanes: bitwise equal to its plain version, pads dropped", flush=True)

    # Times at the token cache's R = U on this state (gaps 0-1500: the
    # catch-up's worst case), materialize first: the write-backs below
    # overwrite the rows they time.
    times = []
    for _ in range(3):
        k_state = {k: st[k].clone() for k in ("table", "m", "v", "last")}
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        lazy_materialize(k_state["table"], k_state["m"], k_state["v"], k_state["last"], count, hp)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    ms_m = sorted(times)[1]
    moved = int((st["alive"] & (st["last"] < LAZY_T)).sum())
    b_m = bound(8 * V * D + 4 * V + moved * D * 4 + 12 * moved * D + 4 * V, 0.0)
    ids, bufs = out["cached"]
    rows = lazy_times(st["table"], st["m"], st["v"], st["last"], ids, bufs, count, hp)
    rows["lazy_catchup"].update(err=worst, materialize_ms=ms_m, materialize_bound_ms=b_m[0],
                                materialize_moved_rows=moved)
    print(f"[lazy] gaps 0-1500, R=U={ids.numel()}: lazy_catchup "
          f"{rows['lazy_catchup']['ms']:.4f} ms (bound {rows['lazy_catchup']['bound_ms']:.4f} by "
          f"bytes, plain {rows['lazy_catchup']['plain_ms']:.3f}; no library call computes it); "
          f"lazy_materialize over {V} rows ({moved} to catch up): {ms_m:.4f} ms (bound "
          f"{b_m[0]:.4f}); lazy_scatter {rows['lazy_scatter']['ms']:.4f} ms (bound "
          f"{rows['lazy_scatter']['bound_ms']:.4f}, plain {rows['lazy_scatter']['plain_ms']:.4f}, "
          f"four index_copy_ {rows['lazy_scatter']['library_ms']:.4f})", flush=True)
    return rows


def lazy_times(table, m, v, last, ids, bufs, count, hp) -> dict:
    """CUDA-event times (warm L2) of ``lazy_catchup`` of rows ``ids`` of the
    state into ``bufs`` and of ``lazy_scatter`` of ``bufs`` back, their plain
    versions', the write-back's library yardstick (four ``index_copy_``:
    table, moments, last) and their byte bounds (each input read once, each
    output written once). The write-backs write ``bufs`` over the rows."""
    U, D = bufs[0].shape
    t = int(count)
    ms_c = cuda_ms(lambda: lazy_catchup(table, m, v, last, ids, count, hp, bufs), 20)
    plain_c = cuda_ms(lambda: lazy_catchup_reference(table, m, v, last, ids, t, hp), 2)
    b_c = bound(3 * U * D * 4 + 8 * U + 3 * U * D * 4, 0.0)
    ms_s = cuda_ms(lambda: lazy_scatter(table, m, v, last, ids, bufs, count), 20)
    plain_s = cuda_ms(lambda: lazy_scatter_reference(table, m, v, last, ids, *bufs, t), 5)
    b_s = bound(3 * U * D * 4 + 4 * U + 3 * U * D * 4 + 4 * U, 0.0)
    idx64 = ids.long()
    stamp = torch.full((U,), t, dtype=torch.int32, device=ids.device)

    def index_copies():
        table.index_copy_(0, idx64, bufs[0])
        m.index_copy_(0, idx64, bufs[1])
        v.index_copy_(0, idx64, bufs[2])
        last.index_copy_(0, idx64, stamp)

    lib_s = cuda_ms(index_copies, 20)
    return {
        "lazy_catchup": {"ms": ms_c, "plain_ms": plain_c, "bound_ms": b_c[0],
                         "bound_by": b_c[1], "library_ms": None, "R": U},
        "lazy_scatter": {"err": 0.0, "ms": ms_s, "plain_ms": plain_s, "bound_ms": b_s[0],
                         "bound_by": b_s[1], "library_ms": lib_s, "R": U},
    }


# Training main path, kernel route vs the plain ("reference") backends from
# the same weights on the same batches. Both run the same bf16 encoder
# arithmetic, except that a bf16 value written by a kernel (hs, demb, dH,
# out) may land one bf16 ulp away from the plain version's, and the f32
# head and the optimizer carry that on:
#   step-0 gradients: max |g - g_ref| / max |g_ref| per parameter <= 5e-2,
#     the repo's bf16 band (tests/test_attn.py);
#   per-step losses: |loss - loss_ref| / loss_ref <= 2e-2 over 20 steps.
GRAD_REL_TOL = 5e-2
LOSS_REL_TOL = 2e-2
# Phase 11: a leaf whose f32 gradient lies below this share of the largest
# element over all leaves holds rounding noise alone (grads_vs).
NOISE_LEAF = 1e-6
TRAIN_STEPS = 20
WORK_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"
# The input path phases 9-9d and 11 measure, as before the host feed: the
# numpy sampler on the trainer's thread (phase 9e sets it beside the feed).
TODAY = ["--sampler", "python", "--prefetch_depth", "0"]
TRAIN_KERNELS = {"K7": bilstm_win_fwd, "K8": bilstm_win_bwd, "K10": attn_fwd_stats, "K11": attn_bwd,
                 "K4": bilstm_full_fwd, "K6": bilstm_full_bwd, "wgrad": lstm_wgrad,
                 "optim_sumsq": optim_sumsq, "optim_update": optim_update,
                 "K1": bilstm_infer_cuda, "K2": attn_fwd_cuda,
                 "lazy_catchup": lazy_catchup, "lazy_scatter": lazy_scatter}
LAZY_KERNELS = ("lazy_catchup", "lazy_scatter")
STEP_KERNELS = ("K10", "K11", "wgrad", "optim_sumsq", "optim_update")
SPLIT_KERNELS = {"split2": lstm_split_infer_cuda, "split1": lstm_split_fwd, "split3": lstm_split_bwd,
                 "wgrad": lstm_wgrad}
# The training path's kernels by the name the profiler gives them: the
# BiLSTM bodies by their template's mode (forward Residuals 0/1/2: K1, K7,
# K4; backward BwdMode 0/1: K8, K6; PROJ true, which the split recurrence's
# kernels 1-3 do not take), the attention forward by its STATS flag (K2,
# K10), K11 by its token kernel and its weight-gradient kernel (one each
# per call). Under a CUDA graph the wrappers count only the warm-up's and
# the capture's calls, so the launches of a graph run are counted here.
PROFILED = {
    "K1": r"lstm_cluster_fwd_kernel<[^<>]*, true, 0>",
    "K7": r"lstm_cluster_fwd_kernel<[^<>]*, true, 1>",
    "K4": r"lstm_cluster_fwd_kernel<[^<>]*, true, 2>",
    "K8": r"lstm_cluster_bwd_kernel<[^<>]*, true, 0>",
    "K6": r"lstm_cluster_bwd_kernel<[^<>]*, true, 1>",
    "K2": r"attn_fwd_kernel<[^<>]*, false, \d+>",
    "K10": r"attn_fwd_kernel<[^<>]*, true, \d+>",
    "K11": r"attn_bwd_token_kernel<",
    "K11 wgrad": r"attn_wgrad_kernel<",
    "wgrad": r"lstm_wgrad_kernel<",
    "optim_sumsq": r"optim_sumsq_kernel\(",
    "optim_update": r"optim_update_kernel\(",
    "lazy_catchup": r"lazy_catchup_kernel\(",
    "lazy_scatter": r"lazy_scatter_kernel\(",
}
# index_add_'s kernels: the dense table gradient, never on the lazy path.
INDEX_ADD = "indexFunc"

# The sorting scatter behind autograd of table[ids] (index_put_ with
# accumulate): no longer on the training path.
SORT_SCATTER = "indexing_backward_kernel"
# Two runs of the training state from the same weights on the same batches
# (the graph step vs the eager step; one S=4 replay vs four S=1 replays):
# every parameter and moment within 1e-6 of its scale, the count equal. The
# word table's gradient is index_add_'s sum in f32 atomics order, which
# changes from run to run: an element whose gradient is within that
# rounding of zero may take Adam's step (lr * m / (sqrt(v) + eps), ~ +-lr at
# the first step) either way. Those elements alone are left out of the
# table's bar: a nonzero second moment whose root is below TABLE_LOOSE of
# the table's largest (at the first step, |g| < 1e-6 max |g|). The table's
# moments are linear and quadratic in that gradient, so they are held to the
# segment sum's own bar (SEGSUM_TOL): the padding id's row sums ~1800 terms,
# and two atomics orders put the moments 1.4e-6 to 3.2e-6 of their scale
# apart on the card (the H100). The table's change must be far above the parameters' bar, so a
# step that never applied the table's update would fail it.
GRAPH_PARAM_TOL = 1e-6
TABLE_LOOSE = 1e-6
# Training at lstm_cs_window=0 vs the W=8 kernel route from the same
# weights on the same batch: bf16 residuals at every step against bf16
# checkpoint seeds; the JAX band for bf16 residuals (tests/test_lstm.py:517).
W0_COSINE_MIN = 0.999
W0_STEPS = 10
# The grad probe's cosine, the bf16 kernel route's gradient against the
# all-f32 plain reference on the same batch: the bf16 rounding of the
# encoder's activations and residuals (the JAX probe's health signal; a
# sanity floor, not a kernel tolerance).
PROBE_COSINE_MIN = 0.99
GRAD_PARAMS = ("embedding.word_embedding", "embedding.pos1_embedding", "embedding.pos2_embedding",
               "encoder.w_ih", "encoder.w_hh", "encoder.bias", "encoder.att_w1", "encoder.att_w2")


def batch_grads(model, cfg, batch) -> dict[str, torch.Tensor]:
    """Gradients of the training loss on one batch (no update)."""
    support, query, label = batch_to_model_inputs(batch)
    model.zero_grad(set_to_none=True)
    loss, _ = loss_and_metrics(model, to_device(support, "cuda"), to_device(query, "cuda"),
                               torch.as_tensor(label).cuda(), cfg.loss)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return grads


def train_records(path: Path) -> list[dict]:
    return [r for r in map(json.loads, path.read_text().splitlines()) if r["kind"] == "train"]


def profile_rows(prof) -> list:
    """(kernel, device us, launches) of the profile's device work; the
    profiler's own step annotations and ``counted_profile``'s spin kernels
    are left out."""
    from torch.autograd import DeviceType

    return sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                   and not e.key.startswith("ProfilerStep") and "spin_kernel" not in e.key),
                  key=lambda r: -r[1])


def profile_eager_steps(trainer, steps: int = 5, tag: str = "profile eager") -> dict:
    """torch.profiler over ``steps`` eager training steps (``train_step``,
    the parent's path) of the trainer's model: device time by kernel, and
    the device's busy share of the wall time (the sum of kernel times over
    the synchronized wall; one stream, so kernels do not overlap)."""
    batches = [batch_to_model_inputs(trainer.train_sampler.sample_batch()) for _ in range(steps)]
    train_step(trainer.model, trainer.opt, trainer.cfg, *batches[0])     # warm
    torch.cuda.synchronize()
    with counted_profile() as prof:
        t0 = time.monotonic()
        for b in batches:
            train_step(trainer.model, trainer.opt, trainer.cfg, *b)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    rows = profile_rows(prof)
    busy = sum(r[1] for r in rows)
    print(f"[{tag}] {steps} steps under the profiler: wall {wall_us / steps / 1e3:.2f} ms/step, "
          f"{sum(r[2] for r in rows) // steps} kernel launches/step, device busy "
          f"{busy / steps / 1e3:.2f} ms/step ({busy / wall_us:.1%} of wall)", flush=True)
    for key, us, n in rows[:15]:
        print(f"[{tag}]   {us / steps / 1e3:8.3f} ms/step {n // steps:4d}x  {key[:90]}", flush=True)
    return {"busy_ms": busy / steps / 1e3, "launches": sum(r[2] for r in rows) / steps}


@contextlib.contextmanager
def counted_profile():
    """torch.profiler (CPU and CUDA activities) over the block, after one
    warm-up cycle and a few spin kernels: the tracer runs before the first
    launch it must count. The block ends synchronized."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        # The first device records of a window can be lost (a replay's first
        # memcpys and kernels were, the same in two windows): a few spin
        # kernels take that place, and ``profile_rows`` leaves them out.
        for _ in range(8):
            torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        time.sleep(0.005)
        yield prof
        torch.cuda.synchronize()
        prof.step()


def profiled_counts(rows: list) -> dict:
    """Launches of each PROFILED kernel among the profiler's rows."""
    return {k: sum(n for key, _, n in rows if re.search(pat, key)) for k, pat in PROFILED.items()}


def no_sort_scatter(rows: list, tag: str) -> None:
    if any(SORT_SCATTER in key for key, _, _ in rows):
        raise AssertionError(f"{tag}: {SORT_SCATTER} ran: the table gradient took index_put_'s "
                             f"sort")


def no_index_add(rows: list, tag: str) -> None:
    if any(INDEX_ADD in key for key, _, _ in rows):
        raise AssertionError(f"{tag}: {INDEX_ADD} ran: a dense table gradient (index_add_)")


def profile_graph_steps(trainer, on: tuple, calls: int = 8, tag: str = "profile graph",
                        per_call: tuple = (), per_step: dict | None = None) -> dict:
    """The trainer's CUDA-graph step (``steps_per_call`` steps a replay):
    unprofiled ms/step over ``calls`` replays with the host split (sample:
    the episode batches drawn and stacked on the host; copy: into the pinned
    buffers and the device copies enqueued, including the wait for the
    previous call's copies; replay: ``graph.replay()`` returning), then
    ``calls`` more under torch.profiler: device busy and launches per step,
    and each kernel of ``on`` launched once per step (K11's two kernels
    each once; ``per_step`` overrides that count: the adversarial step's
    three encoder calls), each of ``per_call`` once per replay (the lazy
    table's catch-up and write-back on the token cache), every other
    PROFILED kernel never. An adversarial trainer's replays take its
    instance batches too."""
    spc = trainer.cfg.steps_per_call
    graphs = trainer.multi_train_step if spc > 1 else trainer.train_step.graphs
    sampler = trainer.train_sampler
    adv = getattr(trainer, "adv", None)

    def sample():
        if adv is not None:
            return batch_leaves(*stack_batches([batch_inputs(sampler.sample_batch())
                                                for _ in range(spc)]), *adv.sample(spc))
        if spc > 1 and hasattr(sampler, "sample_fused"):        # one fused unit, as trained
            return batch_leaves(*batch_inputs(sampler.sample_fused(spc)))
        return batch_leaves(*stack_batches([batch_inputs(sampler.sample_batch())
                                            for _ in range(spc)]))

    captured = graphs.captured(sample())
    split = {"sample": 0.0, "copy": 0.0, "replay": 0.0}
    torch.cuda.synchronize()
    stats0 = sampler.stats() if hasattr(sampler, "stats") else None
    t_start = time.perf_counter()
    for _ in range(calls):
        t0 = time.perf_counter()
        leaves = sample()
        t1 = time.perf_counter()
        captured.fill(leaves)
        t2 = time.perf_counter()
        captured.graph.replay()
        t3 = time.perf_counter()
        split["sample"] += t1 - t0
        split["copy"] += t2 - t1
        split["replay"] += t3 - t2
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    step_ms = wall / (calls * spc) * 1e3
    split = {k: v / (calls * spc) * 1e3 for k, v in split.items()}
    # The share of the wall the trainer's thread waited on the feed (at
    # depth 0 the inline sampling itself).
    stall_frac = (None if stats0 is None else
                  (sampler.stats()["stall_s"] - stats0["stall_s"]) / wall)
    stacked = [sample() for _ in range(calls)]
    with counted_profile() as prof:
        t0 = time.monotonic()
        for leaves in stacked:
            captured.fill(leaves)
            captured.graph.replay()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    rows = profile_rows(prof)
    steps = calls * spc
    busy = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows) / steps
    print(f"[{tag}] steps_per_call={spc}: unprofiled {step_ms:.3f} ms/step -> "
          f"{trainer.cfg.batch_size * 1e3 / step_ms:.1f} episodes/s; host split per step: sample "
          f"{split['sample']:.3f} ms, copy {split['copy']:.3f} ms, replay {split['replay']:.3f} "
          f"ms; graph pool {graphs.pool_bytes / 2**20:.1f} MiB"
          + ("" if stall_frac is None else f"; feed stall {stall_frac:.2%} of wall"), flush=True)
    print(f"[{tag}] {steps} steps under the profiler: wall {wall_us / steps / 1e3:.3f} ms/step, "
          f"{launches:.1f} launches/step, device busy {busy / steps / 1e3:.3f} ms/step "
          f"({busy / wall_us:.1%} of wall)", flush=True)
    for key, us, n in rows[:15]:
        print(f"[{tag}]   {us / steps / 1e3:8.4f} ms/step {n / steps:6.2f}x  {key[:90]}",
              flush=True)
    if not rows:
        raise AssertionError("the profiler saw no kernel in the graph replays")
    per_replay = {k: n / calls for k, n in profiled_counts(rows).items()}
    print(f"[{tag}] hand kernels per replay of {spc} steps: {per_replay}", flush=True)
    times = per_step or {}
    want = {k: float(spc * times.get(k.split()[0], 1) if k.split()[0] in on else
                     1 if k in per_call else 0) for k in PROFILED}
    if per_replay != want:
        # Should the profiler drop a kernel record of a window, a second
        # window of the same replays counts it; a kernel a replay does not
        # launch is missing from both.
        odd = [(key[:100], n) for key, _, n in rows if n % calls]
        with counted_profile() as prof2:
            for leaves in stacked:
                captured.fill(leaves)
                captured.graph.replay()
        again = {k: n / calls for k, n in profiled_counts(profile_rows(prof2)).items()}
        print(f"[{tag}] kernel rows off a multiple of {calls} replays: {odd}; a second window: "
              f"{again}", flush=True)
        per_replay = {k: max(per_replay[k], again[k]) for k in per_replay}
    if per_replay != want:
        raise AssertionError(f"kernels per replay {per_replay}, expected {want}")
    if per_call:
        no_index_add(rows, tag)
    else:
        no_sort_scatter(rows, tag)
    return {"step_ms": step_ms, "episodes_per_s": trainer.cfg.batch_size * 1e3 / step_ms,
            "split": split, "busy_ms": busy / steps / 1e3, "launches": launches,
            "busy_share": busy / wall_us, "pool_bytes": graphs.pool_bytes,
            "feed_stall_frac": stall_frac, "per_replay": per_replay,
            "nccl_per_step": sum(n for key, _, n in rows if "nccl" in key.lower()) / steps}


def graphs_of(single, multi) -> int:
    """CUDA graphs captured by a trainer's single-step callable (its
    ``GraphSteps`` in ``.graphs``) and its multi-step ``GraphSteps``."""
    return len(single.graphs.graphs) + (len(multi.graphs) if multi is not None else 0)


def grad_cosine(ga: dict, gb: dict) -> float:
    """Global cosine of two gradient sets (the JAX grad-probe reduction)."""
    num = sum(float((ga[k].double() * gb[k].double()).sum()) for k in ga)
    na = sum(float(ga[k].double().square().sum()) for k in ga) ** 0.5
    nb = sum(float(gb[k].double().square().sum()) for k in gb) ** 0.5
    return num / (na * nb + 1e-30)


def table_held(opt, i: int) -> torch.Tensor:
    """The word-table elements held to GRAPH_PARAM_TOL (TABLE_LOOSE),
    from the reference run's second moment of parameter ``i``."""
    nu = opt.nu[i]
    if nu is None:
        return torch.ones_like(opt.params[i], dtype=torch.bool)
    r = nu.sqrt()
    return ~((r > 0) & (r < TABLE_LOOSE * r.max()))


def hold_state(tag: str, got: tuple, want: tuple, table0: torch.Tensor,
               table: str = WORD_TABLE) -> dict:
    """Hold the training state of run ``got`` (model, optimizer) to run
    ``want`` from the same weights (``table0``: the word table before;
    ``table`` its name, BERT's token table on phase 13's paths):
    the count equal; every parameter and moment within GRAPH_PARAM_TOL of
    its scale, the word table's and its moments' on the ``table_held``
    elements (its moments within SEGSUM_TOL); the table's change far above
    that bar in both runs."""
    (model, opt), (_, ref) = got, want
    worst_name = None
    if int(opt.count) != int(ref.count):
        raise AssertionError(f"{tag}: count {int(opt.count)} != {int(ref.count)}")
    names = [n for n, _ in model.named_parameters()]
    it = names.index(table)
    held = table_held(ref, it)
    worst, worst_table = 0.0, 0.0
    for i, name in enumerate(names):
        for what, a, b in (("", opt.params[i], ref.params[i]), (" m", opt.mu[i], ref.mu[i]),
                           (" v", opt.nu[i], ref.nu[i])):
            if b is None:
                continue
            a, b = a.detach(), b.detach()
            tol = GRAPH_PARAM_TOL
            if i == it:
                a, b = a[held], b[held]
                tol = SEGSUM_TOL if what else GRAPH_PARAM_TOL
            _, rel = rel_err(a, b)
            if rel > tol:
                raise AssertionError(f"{tag}: {name}{what} relative error {rel:.3g} > {tol}")
            if i == it and what:
                worst_table = max(worst_table, rel)
            elif rel >= worst:
                worst, worst_name = rel, name + what
    scale = ref.params[it].detach()[held].abs().max().item()
    moved = [(p.params[it].detach() - table0)[held].abs().max().item() for p in (opt, ref)]
    if min(moved) <= 100 * GRAPH_PARAM_TOL * scale:
        raise AssertionError(f"{tag}: the word table moved by {moved} (got, want), not far above "
                             f"the bar {GRAPH_PARAM_TOL * scale:.3g}: was its update applied?")
    left_out = int((~held).sum())
    print(f"[{tag}] count {int(opt.count)}; parameters and moments worst rel {worst:.3g} "
          f"({worst_name}; tol "
          f"{GRAPH_PARAM_TOL} of scale), the word table's on all but {left_out} of "
          f"{held.numel()} elements (gradient within the atomics' rounding of zero), its "
          f"moments {worst_table:.3g} (tol {SEGSUM_TOL}); the table moved by {moved[0]:.3g} / "
          f"{moved[1]:.3g}", flush=True)
    return {"state_rel": worst, "worst_leaf": worst_name, "table_moments_rel": worst_table,
            "table_left_out": left_out, "table_moved": moved[1]}


def graph_vs_eager(cfg, vocab, batch, tag: str | None = None) -> dict:
    """One update of the graph step (``make_train_step``) against one eager
    ``train_step`` from the same fresh weights on the same batch."""
    tag = tag or f"W={cfg.lstm_cs_window}"
    eager, graph = (build_model(cfg, glove_init=vocab.vectors) for _ in range(2))
    opt_e, opt_g = make_optimizer(cfg, eager), make_optimizer(cfg, graph)
    table0 = eager.embedding.word_embedding.detach().clone()
    me = train_step(eager, opt_e, cfg, *batch)
    mg = make_train_step(graph, opt_g, cfg)(*batch)
    loss_rel = abs(float(mg["loss"]) - float(me["loss"])) / abs(float(me["loss"]))
    norm_rel = abs(float(mg["grad_norm"]) - float(me["grad_norm"])) / float(me["grad_norm"])
    print(f"[graph] {tag}: one graph step vs one eager step from the same "
          f"weights: loss rel diff {loss_rel:.3g}, grad norm rel diff {norm_rel:.3g}", flush=True)
    if loss_rel > GRAPH_PARAM_TOL or norm_rel > GRAPH_PARAM_TOL:
        raise AssertionError(f"graph step: loss {loss_rel:.3g} or norm {norm_rel:.3g} differs")
    held = hold_state(f"graph {tag}", (graph, opt_g), (eager, opt_e), table0)
    return {**held, "loss_rel": loss_rel, "norm_rel": norm_rel}


def fused_vs_single(cfg, vocab, batches: list) -> dict:
    """One replay of the S=4 graph (``make_multi_train_step``) against four
    replays of the S=1 graph (``make_train_step``) from the same fresh
    weights on the same 4 batches: the 4 losses and norms, then the state
    (``hold_state``)."""
    single, fused = (build_model(cfg, glove_init=vocab.vectors) for _ in range(2))
    opt_s, opt_f = make_optimizer(cfg, single), make_optimizer(cfg, fused)
    table0 = single.embedding.word_embedding.detach().clone()
    step = make_train_step(single, opt_s, cfg)
    ms = [step(*b) for b in batches]
    mf = make_multi_train_step(fused, opt_f, cfg)(*stack_batches(batches))
    worst = 0.0
    for key in ("loss", "grad_norm"):
        want = torch.stack([m[key] for m in ms]).float()
        _, rel = rel_err(mf[key].float(), want)
        worst = max(worst, rel)
        if rel > GRAPH_PARAM_TOL:
            raise AssertionError(f"S=4 replay vs 4 S=1 replays: {key} relative error {rel:.3g}")
    print(f"[fused] W={cfg.lstm_cs_window}: one S={len(batches)} replay vs {len(batches)} S=1 "
          f"replays from the same weights on the same batches: losses and norms rel "
          f"{worst:.3g} (tol {GRAPH_PARAM_TOL})", flush=True)
    held = hold_state(f"fused W={cfg.lstm_cs_window}", (fused, opt_f), (single, opt_s), table0)
    return {**held, "metrics_rel": worst}


def run_trainer(trainer, steps: int, on: tuple, evals: int = 0,
                expect: dict | None = None) -> tuple[dict, dict, list]:
    """``trainer.train(steps)``, the main path, under torch.profiler, with the wrappers' counts zeroed just before and read
    just after. A wrapper counts the calls that launch its kernel: under a
    graph, the warm-up's and the capture's, not the replays. So every
    wrapper of ``on`` must have counted and every other none, and the
    launches are counted from the profiler's records of this run: each
    kernel of ``on`` once per step plus once per captured graph's warm-up
    (an eager forward and backward and one optimizer pair), the eval
    kernels (K1, K2) once per evaluated batch (``evals``) plus once per
    eval graph's warm-up; ``expect`` overrides the count of a kernel (the
    lazy table's, which run once per replay and at each materialize).
    Returns (profiled launches, wrapper counts, the [train] records)."""
    torch.cuda.synchronize()
    for fn in TRAIN_KERNELS.values():
        fn.launches = 0
    with contextlib.redirect_stderr(io.StringIO()), counted_profile() as prof:
        trainer.train(steps)                # the [train]/[val] lines; read back below
        torch.cuda.synchronize()
    wrapped = {k: fn.launches for k, fn in TRAIN_KERNELS.items()}
    if sorted(k for k, n in wrapped.items() if n) != sorted(on):
        raise AssertionError(f"kernel wrappers launched {wrapped}, expected exactly {on}")
    rows = profile_rows(prof)
    launches = profiled_counts(rows)
    n_train = graphs_of(trainer.train_step, trainer.multi_train_step)
    n_eval = graphs_of(trainer.eval_step, trainer.multi_eval_step)
    want = {k: (0 if k.split()[0] not in on else
                evals + n_eval if k in ("K1", "K2") else steps + n_train) for k in PROFILED}
    want.update(expect or {})
    if launches != want:
        raise AssertionError(f"training kernels launched {launches} (profiler), expected {want} "
                             f"({steps} steps, {n_train} train graphs, {evals} eval batches, "
                             f"{n_eval} eval graphs)")
    if trainer.lazy is None:
        no_sort_scatter(rows, "main path")
    else:
        no_index_add(rows, "lazy main path")
    trainer.logger.close()          # flushed; the samplers stay open for the profiles
    return launches, wrapped, train_records(trainer.logger.path)


def losses_vs(recs: list, ref_recs: list, tag: str, key: str = "loss") -> tuple[np.ndarray, float]:
    """Per-step losses (one [train] record per dispatch: a fused record is
    the mean of its steps) against the plain-backend run's at the same
    steps (``key``: another per-step metric, the domain loss)."""
    ref = {r["step"]: r[key] for r in ref_recs}
    losses = np.array([r[key] for r in recs])
    if not np.isfinite(losses).all():
        raise AssertionError(f"{tag}: non-finite training loss")
    steps = [r["step"] for r in recs]
    spans = np.diff([0] + steps)
    ref_means = np.array([np.mean([ref[t] for t in range(s - n + 1, s + 1)])
                          for s, n in zip(steps, spans)])
    rel = float(np.max(np.abs(losses - ref_means) / ref_means))
    if rel > LOSS_REL_TOL:
        raise AssertionError(f"{tag}: training losses disagree: {rel} > {LOSS_REL_TOL}")
    return losses, rel


def step_ms_of(recs: list, batch_size: int, skip: int) -> float:
    """Median ms/step over the [train] records after the first ``skip``."""
    spans = np.diff([0] + [r["step"] for r in recs])
    ms = [n * batch_size / r["episodes_per_s"] * 1e3 / n for r, n in zip(recs, spans)]
    return float(np.median(ms[skip:]))


def train_main_path() -> dict:
    """Phase 9: FewShotTrainer at full width on the card (the flagship
    config, bf16 encoder, 400 002-row table, mse, lstm_cs_window=8, bf16
    checkpoints): step-0 gradients vs the plain backends, one graph step vs
    one eager step, TRAIN_STEPS steps as CUDA-graph replays at
    steps_per_call 1 (with a val pass and a best-checkpoint save) and 4, the
    same steps with the plain backends, ``cli.test_main`` reloads the
    checkpoint, then the profiles: eager (the parent's step) and the graph
    at steps_per_call 1 and 4."""
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    ckpt, ref_dir = WORK_DIR / "ckpt", WORK_DIR / "reference"
    argv = ["--synthetic", "--bf16", "--train_iter", str(TRAIN_STEPS), "--val_step",
            str(TRAIN_STEPS), "--val_iter", "40", "--save_ckpt", str(ckpt), *TODAY]
    args = cli.build_arg_parser(train=True).parse_args(argv)
    cfg = cli.config_from_args(args)
    trainer, _ = cli.make_trainer(args, cfg)        # the model is built on the card
    trainer.metric_window = 1                       # one [train] record per dispatch
    model = trainer.model
    ref_cfg = cfg.replace(lstm_backend="reference", attn_backend="reference")
    vocab = make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim)
    tok = GloveTokenizer(vocab, max_length=cfg.max_length)
    ref_model = build_model(ref_cfg, glove_init=vocab.vectors)
    ref_model.load_state_dict(model.state_dict())
    print(f"[train] flagship: B={cfg.batch_size} N={cfg.n} K={cfg.k} Q={cfg.q} "
          f"({cfg.batch_size * cfg.n * (cfg.k + cfg.q)} encoder rows) L={cfg.max_length} "
          f"u={cfg.lstm_hidden} table {tuple(model.embedding.word_embedding.shape)} "
          f"compute {cfg.compute_dtype} W={cfg.lstm_cs_window} residuals {cfg.lstm_residuals} "
          f"loss {cfg.loss} optimizer {cfg.optimizer}/{cfg.embed_optimizer}", flush=True)

    def sampler():
        return EpisodeSampler(cli.load_data(cfg, "train"), tok, cfg.n, cfg.k, cfg.q,
                              batch_size=cfg.batch_size, seed=cfg.seed)

    # Step-0 gradients on the trainer's first batch (a sampler of the same seed).
    first = sampler().sample_batch()
    g = batch_grads(model, cfg, first)
    g_ref = batch_grads(ref_model, ref_cfg, first)
    worst = 0.0
    for name in GRAD_PARAMS:
        if not torch.isfinite(g[name]).all() or g[name].abs().max().item() == 0.0:
            raise AssertionError(f"step-0 gradient of {name} is not finite and nonzero")
    for name, gr in g_ref.items():
        err, rel = rel_err(g[name], gr)
        worst = max(worst, rel)
        if rel > GRAD_REL_TOL:
            raise AssertionError(f"step-0 gradient {name}: relative error {rel:.3g} > {GRAD_REL_TOL}")
    print(f"[train] step-0 gradients of {len(g)} parameters vs plain backends: worst relative "
          f"error {worst:.3g} (tol {GRAD_REL_TOL}); all {len(GRAD_PARAMS)} encoder/embedding "
          f"gradients finite and nonzero", flush=True)
    graph_check = graph_vs_eager(cfg, vocab, batch_to_model_inputs(first))
    four = sampler()
    fused_check = fused_vs_single(cfg, vocab, [batch_to_model_inputs(four.sample_batch())
                                               for _ in range(4)])
    probe = make_grad_probe(model, cfg)(*batch_to_model_inputs(first))
    probe = {k: float(v) for k, v in probe.items()}
    print(f"[train] grad probe (bf16 kernel route vs all-f32 plain W=0 reference, same batch): "
          f"{probe}", flush=True)
    if not (np.isfinite(list(probe.values())).all() and probe["grad_cosine"] > PROBE_COSINE_MIN):
        raise AssertionError(f"grad probe: {probe}")

    t0 = time.monotonic()
    evals = 40 // cfg.batch_size                    # --val_iter 40, one val pass
    launches, wrapped, recs = run_trainer(trainer, TRAIN_STEPS,
                                          ("K7", "K8", "K1", "K2") + STEP_KERNELS, evals)
    wall = time.monotonic() - t0
    vals = [r for r in map(json.loads, (ckpt / "metrics.jsonl").read_text().splitlines())
            if r["kind"] == "val"]
    if len(recs) != TRAIN_STEPS or len(vals) != 1 or not (ckpt / "best.pt").exists():
        raise AssertionError(f"{len(recs)} train records, {len(vals)} val, best.pt missing?")
    steady = step_ms_of(recs, cfg.batch_size, 2)
    print(f"[train] {TRAIN_STEPS} steps (graph replays, steps_per_call 1) in {wall:.2f} s "
          f"(capture, val and saves included; under the profiler's kernel tracing); launches "
          f"(profiler) {launches}, wrapper counts (warm-up and capture) {wrapped}; ms/step "
          f"median of steps "
          f"3-{TRAIN_STEPS} {steady:.2f} -> {cfg.batch_size * 1e3 / steady:.1f} episodes/s; val "
          f"accuracy {vals[0]['accuracy']:.4f} ± {vals[0]['acc_ci95']:.4f}; train graph pool "
          f"{trainer.train_step.graphs.pool_bytes / 2**20:.1f} MiB", flush=True)

    ref_trainer = FewShotTrainer(ref_model, ref_cfg, sampler(),
                                 logger=MetricsLogger(ref_dir, quiet=True), metric_window=1)
    ref_trainer.train(TRAIN_STEPS)
    ref_trainer.close()
    ref_recs = train_records(ref_dir / "metrics.jsonl")
    losses, loss_rel = losses_vs(recs, ref_recs, "W=8")
    print(f"[train] losses {np.round(losses, 5).tolist()}", flush=True)
    print(f"[train] vs plain backends: max per-step relative loss difference {loss_rel:.3g} "
          f"(tol {LOSS_REL_TOL})", flush=True)

    cfg4 = cfg.replace(steps_per_call=4)
    trainer4 = FewShotTrainer(build_model(cfg4, glove_init=vocab.vectors), cfg4, sampler(),
                              logger=MetricsLogger(WORK_DIR / "spc4", quiet=True), metric_window=1)
    launches4, _, recs4 = run_trainer(trainer4, TRAIN_STEPS, ("K7", "K8") + STEP_KERNELS)
    losses4, loss_rel4 = losses_vs(recs4, ref_recs, "W=8 steps_per_call 4")
    steady4 = step_ms_of(recs4, cfg.batch_size, 1)
    print(f"[train] steps_per_call 4: {TRAIN_STEPS} steps in {len(recs4)} replays, launches "
          f"{launches4}; losses (means of 4) {np.round(losses4, 5).tolist()}; vs plain backends "
          f"{loss_rel4:.3g} (tol {LOSS_REL_TOL}); ms/step median of replays 2-{len(recs4)} "
          f"{steady4:.2f} -> {cfg.batch_size * 1e3 / steady4:.1f} episodes/s", flush=True)

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.test_main(["--synthetic", "--bf16", "--load_ckpt", str(ckpt),
                            "--test_iter", "40"])
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    if rc != 0 or not 0.0 <= result["test_accuracy"] <= 1.0 \
            or "loaded best checkpoint" not in err.getvalue():
        raise AssertionError(f"test_main: rc {rc}, {result}, {err.getvalue()!r}")
    print(f"[test] test_main reloaded the best checkpoint: {result}", flush=True)
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    shutil.copytree(ckpt, SERVE_DIR / "ckpt")       # served by phases 4a-4c
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    eager = profile_eager_steps(trainer)
    on = ("K7", "K8") + STEP_KERNELS
    prof1 = profile_graph_steps(trainer, on, tag="profile graph")
    prof4 = profile_graph_steps(trainer4, on, tag="profile graph spc4")
    return {"launches": launches, "step_ms": steady, "episodes_per_s": cfg.batch_size * 1e3 / steady,
            "step_ms_spc4": steady4, "grad_rel": worst, "loss_rel": max(loss_rel, loss_rel4),
            "graph": graph_check, "fused": fused_check, "eager": eager, "prof1": prof1,
            "prof4": prof4}


def train_full_residual(w8: dict) -> dict:
    """Phase 10: the training route at ``lstm_cs_window=0`` (K4/K6) at the
    flagship config (bf16 encoder, residuals "auto" = bf16): step-0
    gradients vs the plain backends at W=0 and their cosine to the W=8
    kernel route from the same weights on the same batch, one graph step
    vs one eager step, W0_STEPS steps of ``FewShotTrainer`` as graph
    replays at steps_per_call 1 and 4 (two replays and a one-step tail) with
    the counts zeroed just before and read just after, the same steps with
    the plain backends, ms/step beside W=8's, and the graph's profile."""
    argv = ["--synthetic", "--bf16", "--lstm_cs_window", "0"]
    cfg = cli.config_from_args(cli.build_arg_parser(train=True).parse_args(argv))
    ref_cfg = cfg.replace(lstm_backend="reference", attn_backend="reference")
    w8_cfg = cfg.replace(lstm_cs_window=8)
    vocab = make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim)
    tok = GloveTokenizer(vocab, max_length=cfg.max_length)
    model = build_model(cfg, glove_init=vocab.vectors)
    ref_model = build_model(ref_cfg, glove_init=vocab.vectors)
    w8_model = build_model(w8_cfg, glove_init=vocab.vectors)
    for m in (ref_model, w8_model):
        m.load_state_dict(model.state_dict())

    def sampler():
        return EpisodeSampler(cli.load_data(cfg, "train"), tok, cfg.n, cfg.k, cfg.q,
                              batch_size=cfg.batch_size, seed=cfg.seed)

    first = sampler().sample_batch()
    g = batch_grads(model, cfg, first)
    g_ref = batch_grads(ref_model, ref_cfg, first)
    g8 = batch_grads(w8_model, w8_cfg, first)
    worst = 0.0
    for name, gr in g_ref.items():
        _, rel = rel_err(g[name], gr)
        worst = max(worst, rel)
        if rel > GRAD_REL_TOL:
            raise AssertionError(f"W=0 step-0 gradient {name}: relative error {rel:.3g} > "
                                 f"{GRAD_REL_TOL}")
    cos = grad_cosine(g, g8)
    print(f"[train W=0] step-0 gradients of {len(g)} parameters vs plain backends (W=0): worst "
          f"relative error {worst:.3g} (tol {GRAD_REL_TOL}); cosine to the W=8 kernel route "
          f"{cos:.9f} (min {W0_COSINE_MIN})", flush=True)
    if not cos > W0_COSINE_MIN:
        raise AssertionError(f"W=0 vs W=8 gradient cosine {cos} <= {W0_COSINE_MIN}")
    del w8_model
    graph_check = graph_vs_eager(cfg, vocab, batch_to_model_inputs(first))
    four = sampler()
    fused_check = fused_vs_single(cfg, vocab, [batch_to_model_inputs(four.sample_batch())
                                               for _ in range(4)])

    def trainer_of(m, c, sub):
        return FewShotTrainer(m, c, sampler(), logger=MetricsLogger(WORK_DIR / sub, quiet=True),
                              metric_window=1)

    shutil.rmtree(WORK_DIR, ignore_errors=True)
    on = ("K4", "K6") + STEP_KERNELS
    trainer = trainer_of(model, cfg, "w0")
    launches, wrapped, recs = run_trainer(trainer, W0_STEPS, on)
    cfg4 = cfg.replace(steps_per_call=4)
    trainer4 = trainer_of(build_model(cfg4, glove_init=vocab.vectors), cfg4, "w0_spc4")
    launches4, _, recs4 = run_trainer(trainer4, W0_STEPS, on)
    ref_trainer = trainer_of(ref_model, ref_cfg, "w0_reference")
    ref_trainer.train(W0_STEPS)
    ref_trainer.close()
    ref_recs = train_records(WORK_DIR / "w0_reference" / "metrics.jsonl")
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    losses, loss_rel = losses_vs(recs, ref_recs, "W=0")
    losses4, loss_rel4 = losses_vs(recs4, ref_recs, "W=0 steps_per_call 4")
    if len(losses) != W0_STEPS or [r["step"] for r in recs4] != [4, 8, 9, 10]:
        raise AssertionError(f"W=0 records: {len(losses)}, {[r['step'] for r in recs4]}")
    steady = step_ms_of(recs, cfg.batch_size, 2)
    print(f"[train W=0] {W0_STEPS} steps: launches (profiler) {launches}, wrapper counts (warm-up and "
          f"capture) {wrapped} (steps_per_call 4, profiler: {launches4}); "
          f"losses {np.round(losses, 5).tolist()}; vs plain backends max per-step relative loss "
          f"difference {loss_rel:.3g}, steps_per_call 4 {loss_rel4:.3g} (tol {LOSS_REL_TOL})",
          flush=True)
    print(f"[train W=0] ms/step median of steps 3-{W0_STEPS} {steady:.2f} -> "
          f"{cfg.batch_size * 1e3 / steady:.1f} episodes/s (W=8 in this run: "
          f"{w8['step_ms']:.2f} ms/step, {w8['episodes_per_s']:.1f} episodes/s)", flush=True)
    eager = profile_eager_steps(trainer, tag="profile eager W=0")
    prof1 = profile_graph_steps(trainer, on, tag="profile graph W=0")
    prof4 = profile_graph_steps(trainer4, on, tag="profile graph spc4 W=0")
    return {"launches": launches, "step_ms": steady, "episodes_per_s": cfg.batch_size * 1e3 / steady,
            "grad_rel": worst, "cosine_w8": cos, "loss_rel": max(loss_rel, loss_rel4),
            "graph": graph_check, "fused": fused_check, "eager": eager, "prof1": prof1,
            "prof4": prof4}


# --- Phases 9c and 9d: real-format files, the ring, lazy Adam over the token cache ---

REAL_STEPS = 40
REAL_FAULT = 20
# 10-way training episodes with NOTA (FewRel 2.0), 5-way eval, ce, 4 steps a
# replay, a val pass of 40 episodes every 10 steps (so at steps 12, 20, 32
# and 40: a replay may not cross a boundary unseen).
REAL_ARGV = ["--bf16", "--trainN", "10", "--na_rate", "1", "--nota_head", "stats", "--loss",
             "ce", "--steps_per_call", "4", "--val_step", "10", "--val_iter", "40", *TODAY]
# Phase 9c's resume vs the uninterrupted run on the shared table: the table's
# gradient is index_add_'s f32 atomics, so the two runs differ by rounding
# from the first step on (``hold_state``): held as two runs from the same
# weights over many steps are held, val accuracy within 2e-2 at every
# boundary, and each parameter within GRAD_REL_TOL of its scale at step 40.
REAL_VAL_TOL = 2e-2


def evals_per_pass(trainer) -> int:
    """Eval batches one val pass of ``trainer.evaluate`` runs, the repeated
    ones of a fused tail included."""
    remaining, spc, n = max(1, trainer.cfg.val_iter // trainer.cfg.batch_size), trainer.eval_spc, 0
    while remaining > 0:
        if spc > 1 and remaining >= max(1, spc // 8):
            n, remaining = n + spc, remaining - min(spc, remaining)
        else:
            n, remaining = n + 1, remaining - 1
    return n


def h2d_bytes(trainer) -> float:
    """Host-to-device bytes of one training step: the static inputs of one
    batch (token leaves, or the token cache's indices) and its labels."""
    batch = batch_inputs(trainer.train_sampler.sample_batch())
    return float(sum(a.nbytes for _, a in batch_leaves(*stack_batches([batch]))))


def val_records(path: Path) -> list[dict]:
    return [r for r in map(json.loads, path.read_text().splitlines()) if r["kind"] == "val"]


def quiet_cli(fn, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


def real_files_phase(real: dict) -> dict:
    """Phase 9c: ``cli.train_main`` on the real-format files, the shared
    table, 10-way training with NOTA: the vocabulary and token ids the CLI
    reads vs the generator's; REAL_STEPS steps as graph replays (the trainer
    the CLI builds, under the profiler, launches counted); a run with
    ``--fault_step`` that crashes before its step-20 boundary, then
    ``--resume`` to step 40, against the uninterrupted run; ``test_main`` on
    the test file with NOTA precision and recall; ms/step, episodes/s and
    the host-to-device bytes of a step."""
    from induction_network_on_fewrel_tpu_torch.data import load_fewrel_json, load_glove
    from induction_network_on_fewrel_tpu_torch.train.token_cache import tokenize_dataset

    paths = real["paths"]
    t0 = time.monotonic()
    loaded = load_glove(paths["glove"], paths["glove_mat"])
    if loaded.word2id != real["vocab"].word2id or not np.array_equal(loaded.vectors,
                                                                     real["vocab"].vectors):
        raise AssertionError("the GloVe files do not load into the generator's vocabulary")
    loaded_data = {split: load_fewrel_json(paths[split]) for split in REAL_SPLITS}
    for split, ds in loaded_data.items():
        if ds.instances != real["data"][split].instances:
            raise AssertionError(f"{split}: the file's instances differ from the generator's")
    # Equal instances and vocabularies tokenize alike; the val split shows it.
    got, sizes = tokenize_dataset(loaded_data["val"], GloveTokenizer(loaded, max_length=L))
    want, wsizes = tokenize_dataset(real["data"]["val"], GloveTokenizer(real["vocab"],
                                                                        max_length=L))
    if sizes != wsizes or any(not np.array_equal(got[k], want[k]) for k in want):
        raise AssertionError("token ids from the files differ from the generator's")
    splits = ", ".join(f"{split} {n_rel} x {REAL_INSTANCES}"
                       for split, (n_rel, _) in REAL_SPLITS.items())
    print(f"[9c] {loaded.vocab_size} x {loaded.word_dim} GloVe and the splits ({splits}) load "
          f"to the generator's vocabulary and token ids ({time.monotonic() - t0:.1f} s)",
          flush=True)
    files = real_argv(paths, "train", "val")
    whole, parts = REAL_DIR / "whole", REAL_DIR / "parts"
    args = cli.build_arg_parser(train=True).parse_args(
        REAL_ARGV + files + ["--train_iter", str(REAL_STEPS), "--save_ckpt", str(whole)])
    cfg = cli.config_from_args(args)
    trainer, _ = cli.make_trainer(args, cfg)
    trainer.metric_window = 1
    cfg = trainer.cfg
    passes = REAL_STEPS // cfg.val_step
    on = ("K7", "K8", "K1", "K2") + STEP_KERNELS
    launches, _, recs = run_trainer(trainer, REAL_STEPS, on, passes * evals_per_pass(trainer))
    bytes_step = h2d_bytes(trainer)
    steady = step_ms_of(recs, cfg.batch_size, 1)
    print(f"[9c] {REAL_STEPS} steps of {cfg.train_n}-way {cfg.k}-shot training with NOTA "
          f"({cfg.batch_size * (cfg.train_n * (cfg.k + cfg.q) + cfg.na_rate * cfg.q)} encoder "
          f"rows a step) as graph replays of {cfg.steps_per_call}: launches (profiler) "
          f"{launches}; ms/step median of replays 2-{len(recs)} {steady:.2f} -> "
          f"{cfg.batch_size * 1e3 / steady:.1f} episodes/s; host-to-device {bytes_step:.0f} "
          f"bytes a step", flush=True)
    prof = profile_graph_steps(trainer, ("K7", "K8") + STEP_KERNELS, tag="profile graph 9c")

    fault_argv = REAL_ARGV + files + ["--save_ckpt", str(parts), "--fault_step", str(REAL_FAULT)]
    try:
        quiet_cli(cli.train_main, fault_argv + ["--train_iter", str(REAL_STEPS)])
        raise AssertionError("--fault_step did not fire")
    except RuntimeError as e:
        if f"injected fault at step {REAL_FAULT}" not in str(e):
            raise
    rc, _, err = quiet_cli(cli.train_main, fault_argv + ["--resume", "--train_iter",
                                                         str(REAL_STEPS - 12)])
    if rc != 0 or "restored latest checkpoint step=12" not in err:
        raise AssertionError(f"--resume: rc {rc}, {err[-2000:]!r}")
    a = torch.load(whole / "latest.pt", weights_only=True)
    b = torch.load(parts / "latest.pt", weights_only=True)
    if a["step"] != b["step"] or a["opt"]["count"] != b["opt"]["count"]:
        raise AssertionError(f"resume: step {b['step']} count {b['opt']['count']} vs "
                             f"{a['step']} {a['opt']['count']}")
    worst = max(rel_err(b["params"][k], v)[1] for k, v in a["params"].items())
    va, vb = val_records(whole / "metrics.jsonl"), val_records(parts / "metrics.jsonl")
    val_diff = max(abs(x["accuracy"] - y["accuracy"]) for x, y in zip(va, vb))
    if [r["step"] for r in va] != [r["step"] for r in vb] or val_diff > REAL_VAL_TOL \
            or worst > GRAD_REL_TOL:
        raise AssertionError(f"resume vs uninterrupted: val {[r['accuracy'] for r in vb]} vs "
                             f"{[r['accuracy'] for r in va]}, params {worst:.3g}")
    print(f"[9c] --fault_step {REAL_FAULT} crashed the run before its step-20 boundary; --resume "
          f"from the ring's step 12 to step {REAL_STEPS}: val accuracy at "
          f"{[r['step'] for r in va]} within {val_diff:.3g} of the uninterrupted run (tol "
          f"{REAL_VAL_TOL}), parameters within {worst:.3g} of scale (tol {GRAD_REL_TOL}; the "
          f"table gradient's atomics)", flush=True)
    rc, out, err = quiet_cli(cli.test_main, ["--bf16", "--na_rate", "1", "--nota_head", "stats",
                                             "--loss", "ce", "--load_ckpt", str(whole),
                                             "--test_iter", "40", "--steps_per_call", "4"]
                             + real_argv(paths, "test"))
    result = json.loads(out.strip().splitlines()[-1])
    if rc != 0 or not {"nota_precision", "nota_recall"} <= set(result):
        raise AssertionError(f"test_main: rc {rc}, {result}, {err[-2000:]!r}")
    print(f"[9c] test_main on the test file: {result}", flush=True)
    return {"launches": launches, "step_ms": steady, "episodes_per_s": cfg.batch_size * 1e3 / steady,
            "h2d_bytes_per_step": bytes_step, "resume_param_rel": worst, "resume_val_diff": val_diff,
            "test": result, "prof": prof, "vocab": loaded}


def lazy_twin_check(cfg, vocab, table) -> dict:
    """TRAIN_STEPS lazy steps (token cache, replays of S=4) against the
    dense twin (shared Adam with the table on ``adam_nodecay``: decay off
    the table only) from
    the same weights on the same index batches. After the first replay the
    state is held to ``hold_state``'s bars (1e-6 of scale but the
    table elements whose gradient is within the twin's atomics' rounding of
    zero, the table's moments 1e-5); every replay's losses within
    LOSS_REL_TOL; rows outside the corpus bitwise at their GloVe values in
    both runs. Then one more lazy step, eagerly, under the profiler with
    shapes (``no_dense_table_ops``)."""
    from induction_network_on_fewrel_tpu_torch.sampling.index import IndexEpisodeSampler
    from induction_network_on_fewrel_tpu_torch.train.lazy_embed import LazyTable, live_rows
    from induction_network_on_fewrel_tpu_torch.train.steps import ClipDecayOptimizer

    shared = cfg.replace(embed_optimizer="shared")
    lazy_model = build_model(cfg, glove_init=vocab.vectors)
    twin = build_model(shared, glove_init=vocab.vectors)
    opt_l = make_optimizer(cfg, lazy_model)
    lazy = LazyTable(lazy_model, opt_l.hyper, live_rows(cfg), uids=table.uids)
    opt_l.attach_compact(lazy.rows, lazy.rows_m, lazy.rows_v)
    names = [n for n, _ in twin.named_parameters()]
    opt_t = ClipDecayOptimizer(twin.parameters(), cfg.lr, cfg.weight_decay, cfg.lr_step_size,
                               cfg.lr_gamma, cfg.grad_clip,
                               rules=["adam_nodecay" if n == WORD_TABLE else "adam" for n in names])
    multi_l = make_multi_train_step(lazy_model, opt_l, cfg, source=table, lazy=lazy)
    multi_t = make_multi_train_step(twin, opt_t, shared, source=table)
    sampler = IndexEpisodeSampler(table.sizes, cfg.train_n, cfg.k, cfg.q, cfg.batch_size,
                                  cfg.na_rate, seed=cfg.seed)
    batches = [batch_inputs(sampler.sample_batch()) for _ in range(TRAIN_STEPS)]
    table0 = twin.embedding.word_embedding.detach().clone()
    it = names.index(WORD_TABLE)
    worst_loss, held = 0.0, None
    for i in range(0, TRAIN_STEPS, 4):
        ml, mt = multi_l(*stack_batches(batches[i:i + 4])), multi_t(*stack_batches(batches[i:i + 4]))
        _, rel = rel_err(ml["loss"].float(), mt["loss"].float())
        worst_loss = max(worst_loss, rel)
        if i == 0:
            lazy.materialize(opt_l.count)
            held = hold_lazy_state(lazy_model, opt_l, lazy, twin, opt_t, it, table0)
    if worst_loss > LOSS_REL_TOL:
        raise AssertionError(f"lazy vs dense twin: losses {worst_loss:.3g} > {LOSS_REL_TOL}")
    lazy.materialize(opt_l.count)
    outside = torch.ones(table0.shape[0], dtype=torch.bool, device=table0.device)
    outside[table.uids.long()] = False
    for tag, m in (("lazy", lazy_model), ("twin", twin)):
        if not torch.equal(m.embedding.word_embedding.detach()[outside], table0[outside]):
            raise AssertionError(f"{tag}: a row outside the corpus moved")
    final = max(rel_err(a.detach(), b.detach())[1]
                for a, b in zip(lazy_model.parameters(), twin.parameters()))
    print(f"[9d] lazy vs the dense twin (decay off the table only), same weights and batches: "
          f"after 4 steps {held}; {TRAIN_STEPS} steps' losses within {worst_loss:.3g} (tol "
          f"{LOSS_REL_TOL}); parameters after {TRAIN_STEPS} steps within {final:.3g} of scale "
          f"(reported); {int(outside.sum())} rows outside the corpus bitwise unchanged in both",
          flush=True)
    no_dense_table_ops(lazy_model, opt_l, cfg, table, lazy, sampler)
    return {**held, "loss_rel": worst_loss, "param_rel_20": final}


def hold_lazy_state(lazy_model, opt_l, lazy, twin, opt_t, it: int, table0) -> dict:
    """``hold_state`` for a lazy run against its dense twin: the table's
    moments are the lazy table's m and v."""
    if int(opt_l.count) != int(opt_t.count):
        raise AssertionError(f"count {int(opt_l.count)} != {int(opt_t.count)}")
    held = table_held(opt_t, it)
    worst, worst_table = 0.0, 0.0
    for i, (a, b) in enumerate(zip(lazy_model.parameters(), twin.parameters())):
        pairs = [("", a.detach(), b.detach())]
        pairs += ([(" m", lazy.m, opt_t.mu[it]), (" v", lazy.v, opt_t.nu[it])] if i == it else
                  [(" m", opt_l.mu[i], opt_t.mu[i]), (" v", opt_l.nu[i], opt_t.nu[i])])
        for what, x, y in pairs:
            if i == it:
                x, y = x[held], y[held]
            _, rel = rel_err(x, y)
            tol = SEGSUM_TOL if i == it and what else GRAPH_PARAM_TOL
            if rel > tol:
                raise AssertionError(f"lazy vs twin: parameter {i}{what} relative error {rel:.3g} "
                                     f"> {tol}")
            if i == it and what:
                worst_table = max(worst_table, rel)
            else:
                worst = max(worst, rel)
    moved = (lazy_model.embedding.word_embedding.detach() - table0)[held].abs().max().item()
    if moved <= 100 * GRAPH_PARAM_TOL * table0[held].abs().max().item():
        raise AssertionError(f"lazy vs twin: the table moved by {moved}: was it updated?")
    return {"state_rel": worst, "table_moments_rel": worst_table,
            "table_left_out": int((~held).sum()), "table_moved": moved}


def lazy_resume_check(cfg, vocab, train_t, val_t) -> dict:
    """The ring of a lazy run: 20 steps (a base at the step-12 boundary, a
    delta at step 20), then 20 more; a second trainer resumes the step-20
    delta and trains the same 20: its state must equal the uninterrupted
    run's within GRAPH_PARAM_TOL of scale (no atomics on this path). Before
    that a copy of the directory with its delta bit-flipped: the delta is
    quarantined and the restore falls back to the base, bitwise."""
    from induction_network_on_fewrel_tpu_torch.sampling.index import IndexEpisodeSampler
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager

    def trainer_at(directory):
        return FewShotTrainer(
            build_model(cfg, glove_init=vocab.vectors), cfg,
            IndexEpisodeSampler(train_t.sizes, cfg.train_n, cfg.k, cfg.q, cfg.batch_size,
                                cfg.na_rate, seed=cfg.seed),
            IndexEpisodeSampler(val_t.sizes, cfg.n, cfg.k, cfg.q, cfg.batch_size, cfg.na_rate,
                                seed=cfg.seed + 1),
            ckpt_dir=str(directory), logger=MetricsLogger(directory, quiet=True),
            train_table=train_t, val_table=val_t)

    run_b, resumed, corrupt = REAL_DIR / "lazy_b", REAL_DIR / "lazy_r", REAL_DIR / "lazy_c"
    b = trainer_at(run_b)
    b.train(REAL_FAULT)
    for d in (resumed, corrupt):
        shutil.copytree(run_b, d)
    b.train(REAL_STEPS - REAL_FAULT, start_step=REAL_FAULT)
    b.close()
    saves = [r for r in map(json.loads, (run_b / "metrics.jsonl").read_text().splitlines())
             if r["kind"] == "ckpt"]
    modes = [(r["step"], r["mode"], int(r["bytes"]), int(r.get("rows", -1))) for r in saves]
    base_bytes = next(n for _, m, n, _ in modes if m == "base")
    deltas = [n for _, m, n, _ in modes if m == "delta"]
    if not deltas:
        raise AssertionError(f"no delta ring save: {modes}")

    r = trainer_at(resumed)
    data = bytearray((corrupt / "ring_delta.pt").read_bytes())
    data[len(data) // 2] ^= 0xFF
    (corrupt / "ring_delta.pt").write_bytes(bytes(data))
    step_c, _ = CheckpointManager(corrupt, cfg).restore_latest(r.model, r.opt, r.lazy)
    base = torch.load(corrupt / "ring_base.pt", weights_only=True)
    if step_c != base["step"] or not (corrupt / "ring_delta.pt.quarantined").exists() or not all(
            torch.equal(v.cpu(), base["params"][k]) for k, v in r.model.state_dict().items()):
        raise AssertionError(f"corrupt delta: restored step {step_c}, base {base['step']}")
    step_r, extra = r.ckpt.restore_latest(r.model, r.opt, r.lazy)
    r.best_val = extra["best_val"]
    r.restore_sampler_states(extra["samplers"])
    if step_r != REAL_FAULT:
        raise AssertionError(f"resume from the delta: step {step_r}")
    r.train(REAL_STEPS - REAL_FAULT, start_step=REAL_FAULT)
    r.close()
    pairs = [(x.detach(), y.detach()) for x, y in zip(r.model.parameters(), b.model.parameters())]
    pairs += [(getattr(r.lazy, k), getattr(b.lazy, k)) for k in ("m", "v")]
    pairs += [(x, y) for x, y in zip(r.opt.mu + r.opt.nu, b.opt.mu + b.opt.nu) if x is not None]
    worst = max(rel_err(x, y)[1] for x, y in pairs)
    bitwise = all(torch.equal(x, y) for x, y in pairs) and torch.equal(r.lazy.last, b.lazy.last)
    if worst > GRAPH_PARAM_TOL or int(r.opt.count) != int(b.opt.count) \
            or not torch.equal(r.lazy.last, b.lazy.last):
        raise AssertionError(f"resume from the delta vs uninterrupted: {worst:.3g}")
    print(f"[9d] ring saves of the lazy run (step, mode, bytes, rows): {modes}; a delta "
          f"{min(deltas) / base_bytes:.1%}-{max(deltas) / base_bytes:.1%} of the full base; a "
          f"bit-flipped delta quarantined, the restore fell back to the step-{step_c} base "
          f"bitwise; resumed from the step-{REAL_FAULT} delta to step {REAL_STEPS}: state within "
          f"{worst:.3g} of scale of the uninterrupted run (tol {GRAPH_PARAM_TOL}; bitwise: "
          f"{bitwise})", flush=True)
    return {"ring": modes, "delta_over_base": max(deltas) / base_bytes, "resume_rel": worst,
            "resume_bitwise": bitwise}


def no_dense_table_ops(model, opt, cfg, table, lazy, sampler) -> None:
    """One eager run of the lazy token-cache step body (the code the graph
    captures) under the profiler with shapes: no ``index_add_`` and no
    zero fill, fill or scatter of a [V, D] tensor."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from induction_network_on_fewrel_tpu_torch.train.steps import _train_run_of

    V, D = model.embedding.word_embedding.shape
    run_of, _ = _train_run_of(model, opt, cfg, table, lazy)
    batch = batch_inputs(sampler.sample_batch())
    dev = {n: torch.as_tensor(a).cuda() for n, a in batch_leaves(*stack_batches([batch]))}
    with torch_profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        run_of(1)(dev)
        torch.cuda.synchronize()
    bad = [(e.key, e.input_shapes) for e in prof.key_averages(group_by_input_shape=True)
           if e.key in ("aten::index_add_", "aten::zero_", "aten::fill_", "aten::zeros",
                        "aten::index_put_", "aten::scatter_", "aten::index_copy_")
           and any(list(s) == [V, D] for s in e.input_shapes if s)]
    if bad or any(e.key == "aten::index_add_" for e in prof.key_averages()):
        raise AssertionError(f"the lazy step touched a dense [V, D] table: {bad}")
    print(f"[9d] one lazy step under the profiler with shapes: no index_add_, and no zero fill, "
          f"fill, scatter or index write of a [{V}, {D}] tensor", flush=True)


def lazy_phase(real: dict, tr9c: dict, gen: torch.Generator) -> dict:
    """Phase 9d: ``--token_cache --embed_optimizer lazy`` on 9c's files, the
    flagship widths, graph replays: the two lazy kernels vs their plain
    versions (``lazy_kernel_checks``), 20 steps against the dense twin, the
    main path (REAL_STEPS steps through the trainer the CLI builds, under
    the profiler: the catch-up once per replay and per materialize, the
    write-back once per replay, no index_add_), the host-to-device bytes
    of a step beside 9c's, the ring (base, deltas, a resume from a delta, a
    corrupt delta), ``register_tokens`` on the run's best checkpoint vs
    ``register`` on the same raw sentences, and the graph's profile."""
    from induction_network_on_fewrel_tpu_torch.serving.registry import TenantRegistry
    from induction_network_on_fewrel_tpu_torch.train.lazy_embed import live_rows
    from induction_network_on_fewrel_tpu_torch.train.token_cache import tokenize_dataset

    paths = real["paths"]
    directory = REAL_DIR / "lazy"
    args = cli.build_arg_parser(train=True).parse_args(
        REAL_ARGV + real_argv(paths, "train", "val")
        + ["--token_cache", "--embed_optimizer", "lazy", "--train_iter", str(REAL_STEPS),
           "--save_ckpt", str(directory)])
    cfg = cli.config_from_args(args)
    trainer, _ = cli.make_trainer(args, cfg)
    trainer.metric_window = 1
    cfg = trainer.cfg
    train_t, val_t = trainer.train_table, trainer.val_table
    print(f"[9d] token tables on the card: train {train_t.rows} rows "
          f"({train_t.nbytes / 2**20:.1f} MiB, {train_t.uids.numel()} distinct words), val "
          f"{val_t.rows} rows", flush=True)
    kernel_rows = lazy_kernel_checks(gen, train_t.uids, live_rows(cfg))
    twin = lazy_twin_check(cfg, tr9c["vocab"], train_t)

    on = ("K7", "K8", "K1", "K2") + STEP_KERNELS + LAZY_KERNELS
    passes = REAL_STEPS // cfg.val_step
    replays = REAL_STEPS // cfg.steps_per_call
    expect = {"lazy_catchup": replays + 1 + passes + 1, "lazy_scatter": replays + 1}
    launches, wrapped, recs = run_trainer(trainer, REAL_STEPS, on,
                                          passes * evals_per_pass(trainer), expect)
    bytes_step = h2d_bytes(trainer)
    steady = step_ms_of(recs, cfg.batch_size, 1)
    print(f"[9d] {REAL_STEPS} lazy steps over the token cache as graph replays of "
          f"{cfg.steps_per_call}: launches (profiler) {launches}, wrapper counts (warm-ups, "
          f"captures, materializes) {wrapped}; ms/step median of replays 2-{len(recs)} "
          f"{steady:.2f} -> {cfg.batch_size * 1e3 / steady:.1f} episodes/s (9c: "
          f"{tr9c['step_ms']:.2f}, {tr9c['episodes_per_s']:.1f}); host-to-device {bytes_step:.0f} "
          f"bytes a step (9c: {tr9c['h2d_bytes_per_step']:.0f})", flush=True)
    # The catch-up and write-back at the main path's state: the trained
    # run's table, every corpus row current (the steady state: k = 0). The
    # compact rows hold the last replay's rows, so the write-backs write
    # the values the table holds.
    lazy = trainer.lazy
    with torch.no_grad():
        main = lazy_times(lazy.table.detach(), lazy.m, lazy.v, lazy.last, lazy.ids,
                          (lazy.rows.detach(), lazy.rows_m, lazy.rows_v), trainer.opt.count,
                          lazy.hyper)
    print(f"[9d] at the trained run's state (U={lazy.U}, every row current): lazy_catchup "
          f"{main['lazy_catchup']['ms']:.4f} ms (bound {main['lazy_catchup']['bound_ms']:.4f}, "
          f"plain {main['lazy_catchup']['plain_ms']:.4f}); lazy_scatter "
          f"{main['lazy_scatter']['ms']:.4f} ms (bound {main['lazy_scatter']['bound_ms']:.4f}, "
          f"plain {main['lazy_scatter']['plain_ms']:.4f}, four index_copy_ "
          f"{main['lazy_scatter']['library_ms']:.4f})", flush=True)
    ring = lazy_resume_check(cfg, tr9c["vocab"], train_t, val_t)
    prof = profile_graph_steps(trainer, ("K7", "K8") + STEP_KERNELS, tag="profile graph 9d",
                               per_call=LAZY_KERNELS)

    engine = InferenceEngine.from_checkpoint(str(directory), glove=str(paths["glove"]),
                                             glove_mat=str(paths["glove_mat"]), start=False)
    test_ds = real["data"]["test"]
    table, sizes = tokenize_dataset(test_ds, engine.tokenizer)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    by_rows = TenantRegistry(engine.model, engine.tokenizer, k=cfg.k, tiers=None)
    by_raw = TenantRegistry(engine.model, engine.tokenizer, k=cfg.k, tiers=None)
    worst = 0.0
    for ci, rel in enumerate(test_ds.rel_names[:5]):
        rows = [{k: v[starts[ci] + j] for k, v in table.items()} for j in range(cfg.k)]
        got = by_rows.register_tokens(rel, rows)
        want = by_raw.register(rel, test_ds.instances[rel][:cfg.k])
        worst = max(worst, float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)))
    engine.close()
    if worst > 1e-5:
        raise AssertionError(f"register_tokens vs register: {worst:.3g}")
    print(f"[9d] register_tokens (offset-form rows of the token cache) on the run's best "
          f"checkpoint: 5 class vectors within {worst:.3g} of scale of register on the raw "
          f"sentences (tol 1e-5)", flush=True)
    for key in LAZY_KERNELS:
        worst_case = kernel_rows[key]
        kernel_rows[key] = {**worst_case, **main[key], "launches": launches[key],
                            "ms_gaps_0_1500": worst_case["ms"],
                            "plain_ms_gaps_0_1500": worst_case["plain_ms"]}
    return {"launches": launches, "step_ms": steady,
            "episodes_per_s": cfg.batch_size * 1e3 / steady, "h2d_bytes_per_step": bytes_step,
            "twin": twin, "ring": ring, "register_rel": worst, "prof": prof,
            "kernels": kernel_rows, "U": lazy.U}


# --- Phase 9e: the host feed ------------------------------------------------------

FEED_STEPS = 20
# Native at depth 0 vs depth 2, the same batches from the same weights: per
# step losses within the graph bar (GRAPH_PARAM_TOL) of each other; only
# the shared table's f32 atomics may order a sum differently.
FEED_LOSS_TOL = GRAPH_PARAM_TOL
# 9e(d), the JAX bench headline's shape: B=64 episodes a step, the token
# cache, lazy Adam on the 400 002-row table, one graph of 128 steps (the
# JAX bench scans 512: at 512 a call took ~11 s on the card and the three
# depths 88.7 s of a whole script that, with phase 20, came within 3 s of the
# 1200 s it must finish in, on a slower card; 128 leaves a quarter); one
# hard-synced call per depth after one warm call, at depths 0 and 2.
BENCH_B = 64
BENCH_SPC = 128
BENCH_CALLS = 1
BENCH_DEPTHS = (0, 2)
FEED_DIR = WORK_DIR.parent / "chip_smoke_feed"
# 9e(c)'s zoo models through the C++ feed.
FEED_ZOO_MODELS = ("proto",)


def feed_argv(sampler: str, depth: int) -> list:
    return ["--sampler", sampler, "--prefetch_depth", str(depth)]


def feed_trainer(argv: list):
    """The trainer ``cli.make_trainer`` builds for ``argv``, one [train]
    record per dispatch."""
    args = cli.build_arg_parser(train=True).parse_args(argv)
    trainer, _ = cli.make_trainer(args, cli.config_from_args(args))
    trainer.metric_window = 1
    return trainer


def feed_columns(prof: dict) -> dict:
    """9e's columns of a ``profile_graph_steps`` reading: ms/step,
    episodes/s, host sampling ms a step (the trainer thread's draw: the
    feed's wait at depth 2), device busy ms a step and the card's share of
    the wall under the profiler, and the feed's stall share (unprofiled)."""
    return {"step_ms": prof["step_ms"], "episodes_per_s": prof["episodes_per_s"],
            "sample_ms": prof["split"]["sample"], "busy_ms": prof["busy_ms"],
            "card_share": prof["busy_share"], "feed_stall_frac": prof["feed_stall_frac"]}


def close_trainer(trainer) -> None:
    trainer.close()                 # joins the feed's producer thread
    gc.collect()
    torch.cuda.empty_cache()


def feed_flagship() -> dict:
    """9e(a): the flagship at phase 9's config through ``cli.make_trainer``
    with the C++ sampler at depths 0 and 2 (today's input path, ``--sampler
    python --prefetch_depth 0``, is 9c's): FEED_STEPS steps as graph replays
    with a val pass, the wrappers' counts zeroed just before and read just
    after, launches by the profiler; then the graph's profile. The two
    native runs start from the same weights and draw the same batches, so
    their losses agree within FEED_LOSS_TOL."""
    base = ["--synthetic", "--bf16", "--train_iter", str(FEED_STEPS), "--val_step",
            str(FEED_STEPS), "--val_iter", "40"]
    on = ("K7", "K8", "K1", "K2") + STEP_KERNELS
    rows, losses = {}, {}
    for sampler, depth in (("native", 0), ("native", 2)):
        tag = f"{sampler} d{depth}"
        trainer = feed_trainer(base + feed_argv(sampler, depth)
                               + ["--save_ckpt", str(FEED_DIR / f"flagship_{sampler}_{depth}")])
        evals = 40 // trainer.cfg.batch_size
        launches, wrapped, recs = run_trainer(trainer, FEED_STEPS, on, evals)
        losses[tag] = np.array([r["loss"] for r in recs])
        if len(recs) != FEED_STEPS or not np.isfinite(losses[tag]).all():
            raise AssertionError(f"9e(a) {tag}: {len(recs)} records, losses {losses[tag]}")
        prof = profile_graph_steps(trainer, ("K7", "K8") + STEP_KERNELS,
                                   tag=f"profile 9e(a) {tag}")
        rows[tag] = {**feed_columns(prof), "launches": launches, "wrapper_counts": wrapped}
        close_trainer(trainer)
    a, b = losses["native d0"], losses["native d2"]
    rel = float(np.max(np.abs(a - b) / np.abs(a)))
    if rel > FEED_LOSS_TOL:
        raise AssertionError(f"9e(a): native losses at depth 0 vs 2 differ by {rel:.3g} > "
                             f"{FEED_LOSS_TOL}")
    print(f"[9e(a)] flagship, {FEED_STEPS} steps: losses native d0 vs d2 within {rel:.3g} "
          f"(tol {FEED_LOSS_TOL}); {json.dumps(rows)}", flush=True)
    return {"rows": rows, "loss_rel_native_d0_d2": rel}


def feed_real(real: dict) -> dict:
    """9e(b): 9c (shared table) and 9d (token cache, lazy) on 9c's files
    with the C++ sampler at depth 2: the graph's profile of each
    (``profile_graph_steps``: each hand kernel once a step, the lazy pair
    once a replay), beside phases 9c's and 9d's own (today's input path;
    9e(a) holds depth 0 against depth 2)."""
    files = real_argv(real["paths"], "train", "val")
    rows = {}
    for phase, extra, per_call in (("9c", [], ()),
                                   ("9d", ["--token_cache", "--embed_optimizer", "lazy"],
                                    LAZY_KERNELS)):
        for depth in (2,):
            tag = f"{phase} native d{depth}"
            trainer = feed_trainer(REAL_ARGV + files + extra + feed_argv("native", depth)
                                   + ["--save_ckpt", str(FEED_DIR / f"{phase}_{depth}")])
            prof = profile_graph_steps(trainer, ("K7", "K8") + STEP_KERNELS,
                                       tag=f"profile 9e(b) {tag}", per_call=per_call)
            rows[tag] = feed_columns(prof)
            close_trainer(trainer)
    return rows


def feed_zoo() -> dict:
    """9e(c): phase 11b's proto/cnn through ``cli.make_trainer`` with the
    C++ sampler at depth 2: the graph's profile (only the optimizer pair is
    a hand kernel off the BiLSTM)."""
    rows = {}
    for model_name in FEED_ZOO_MODELS:
        tag = f"{model_name}/cnn native d2"
        trainer = feed_trainer(ZOO_ARGV + ["--model", model_name, "--encoder", "cnn",
                                           "--save_ckpt", str(FEED_DIR / model_name)]
                               + feed_argv("native", 2))
        prof = profile_graph_steps(trainer, ("optim_sumsq", "optim_update"), calls=4,
                                   tag=f"profile 9e(c) {tag}")
        rows[tag] = feed_columns(prof)
        close_trainer(trainer)
    return rows


def feed_bench(real: dict) -> dict:
    """9e(d): the JAX bench headline's shape: B=BENCH_B, the token cache over
    9c's train file, lazy Adam on the 400 002 x 50 table, steps_per_call
    BENCH_SPC (one CUDA graph of that many steps); the C++ index sampler
    through a PipelineFeed producing whole fused units at each depth of
    BENCH_DEPTHS (a fresh sampler of one seed each: the same stream), one
    warm call, then BENCH_CALLS calls each ended by reading its last loss
    (hard-synced): episodes/s and the feed's stall share of the wall."""
    from induction_network_on_fewrel_tpu_torch.datapipe import PipelineFeed
    from induction_network_on_fewrel_tpu_torch.sampling.native import NativeIndexSampler

    t0 = time.monotonic()
    trainer = feed_trainer(["--bf16", "--batch_size", str(BENCH_B), "--token_cache",
                            "--embed_optimizer", "lazy", "--steps_per_call", str(BENCH_SPC),
                            "--val_step", "0", "--save_ckpt", str(FEED_DIR / "bench")]
                           + real_argv(real["paths"], "train", "val") + feed_argv("native", 0))
    cfg, graphs = trainer.cfg, trainer.multi_train_step
    sizes = trainer.train_table.sizes
    out = {"steps_per_call": BENCH_SPC, "batch_size": BENCH_B, "calls": BENCH_CALLS}
    for depth in BENCH_DEPTHS:
        feed = PipelineFeed(NativeIndexSampler(sizes, cfg.train_n, cfg.k, cfg.q,
                                               batch_size=BENCH_B, seed=1234),
                            prefetch_depth=depth, unit=BENCH_SPC)
        t_warm = time.monotonic()
        loss = graphs(*feed.sample_fused(BENCH_SPC))["loss"][-1].item()    # captures once
        warm_s = time.monotonic() - t_warm
        before = feed.stats()
        t1 = time.monotonic()
        for _ in range(BENCH_CALLS):
            loss = graphs(*feed.sample_fused(BENCH_SPC))["loss"][-1].item()  # hard sync
        wall = time.monotonic() - t1
        stall = feed.stats()["stall_s"] - before["stall_s"]
        feed.close()
        if not np.isfinite(loss):
            raise AssertionError(f"9e(d) depth {depth}: loss {loss}")
        out[f"d{depth}"] = {"episodes_per_s": BENCH_CALLS * BENCH_SPC * BENCH_B / wall,
                            "feed_stall_frac": stall / wall, "wall_s": wall,
                            "warm_call_s": warm_s, "last_loss": loss}
        print(f"[9e(d)] B={BENCH_B} token cache + lazy, steps_per_call {BENCH_SPC}, depth "
              f"{depth}: {out[f'd{depth}']['episodes_per_s']:.1f} episodes/s (hard-synced, "
              f"{BENCH_CALLS} calls in {wall:.2f} s), feed stall {stall / wall:.3%} of wall; "
              f"warm call {warm_s:.2f} s", flush=True)
    out["graph_pool_bytes"] = graphs.pool_bytes
    close_trainer(trainer)
    out["seconds"] = time.monotonic() - t0
    return out


@contextlib.contextmanager
def recorded_feeds():
    """Every batch a PipelineFeed hands to the trainer, in order, as the
    bytes of its arrays (a fused draw as its single batches)."""
    from induction_network_on_fewrel_tpu_torch.datapipe import PipelineFeed

    seen: list[bytes] = []
    single, fused = PipelineFeed.sample_batch, PipelineFeed._sample_fused

    def sample_batch(self):
        out = single(self)
        seen.append(b"".join(np.ascontiguousarray(x).tobytes() for x in out))
        return out

    def sample_fused(self, n):
        out = fused(self, n)
        seen.extend(b"".join(np.ascontiguousarray(x[i]).tobytes() for x in out)
                    for i in range(n))
        return out

    PipelineFeed.sample_batch, PipelineFeed._sample_fused = sample_batch, sample_fused
    try:
        yield seen
    finally:
        PipelineFeed.sample_batch, PipelineFeed._sample_fused = single, fused


@contextlib.contextmanager
def per_dispatch_records():
    """``cli.make_trainer``'s trainers log one [train] record per dispatch."""
    make = cli.make_trainer

    def made(*args, **kw):
        trainer, test = make(*args, **kw)
        trainer.metric_window = 1
        return trainer, test

    cli.make_trainer = made
    try:
        yield
    finally:
        cli.make_trainer = make


def feed_resume(real: dict) -> dict:
    """9e(e): ``cli.train_main`` on 9c's files with the token cache, lazy
    Adam (repeatable on the card: no atomics add a value) and the C++
    sampler at depth 2: an uninterrupted run of REAL_STEPS, a run crashed
    by ``--fault_step`` and its ``--resume`` from the ring's step 12. The
    resumed run's episode index batches equal the uninterrupted run's
    from step 12 on, bitwise, and its per-dispatch losses within 1e-6."""
    argv = (REAL_ARGV + real_argv(real["paths"], "train", "val")
            + ["--token_cache", "--embed_optimizer", "lazy"] + feed_argv("native", 2))
    whole, parts = FEED_DIR / "resume_whole", FEED_DIR / "resume_parts"
    with recorded_feeds() as seen, per_dispatch_records():
        rc, _, err = quiet_cli(cli.train_main, argv + ["--train_iter", str(REAL_STEPS),
                                                       "--save_ckpt", str(whole)])
        if rc != 0:
            raise AssertionError(f"9e(e) uninterrupted run: rc {rc}, {err[-2000:]!r}")
        want = list(seen)
        seen.clear()
        try:
            quiet_cli(cli.train_main, argv + ["--train_iter", str(REAL_STEPS), "--fault_step",
                                              str(REAL_FAULT), "--save_ckpt", str(parts)])
            raise AssertionError("9e(e): --fault_step did not fire")
        except RuntimeError as e:
            if f"injected fault at step {REAL_FAULT}" not in str(e):
                raise
        crashed = list(seen)
        seen.clear()
        rc, _, err = quiet_cli(cli.train_main, argv + ["--train_iter", str(REAL_STEPS - 12),
                                                       "--fault_step", str(REAL_FAULT),
                                                       "--resume", "--save_ckpt", str(parts)])
        if rc != 0 or "restored latest checkpoint step=12" not in err:
            raise AssertionError(f"9e(e) --resume: rc {rc}, {err[-2000:]!r}")
        resumed = list(seen)
    if len(want) != REAL_STEPS or crashed != want[:REAL_FAULT] or resumed != want[12:]:
        raise AssertionError(f"9e(e): the resumed stream differs: {len(want)} batches, crashed "
                             f"run {len(crashed)} (prefix {crashed == want[:REAL_FAULT]}), "
                             f"resumed {len(resumed)} (equal {resumed == want[12:]})")
    a = {r["step"]: r["loss"] for r in train_records(whole / "metrics.jsonl")}
    b = {r["step"]: r["loss"] for r in train_records(parts / "metrics.jsonl")[-(len(a) - 3):]}
    if sorted(b) != [s for s in sorted(a) if s > 12]:
        raise AssertionError(f"9e(e): [train] records at {sorted(b)} vs {sorted(a)}")
    rel = max(abs(b[t] - a[t]) / abs(a[t]) for t in b)
    if rel > 1e-6:
        raise AssertionError(f"9e(e): resumed losses differ by {rel:.3g} > 1e-6")
    print(f"[9e(e)] train_main --fault_step {REAL_FAULT}, then --resume from step 12 at depth 2 "
          f"over the C++ sampler: the resumed run's {len(resumed)} index batches equal the "
          f"uninterrupted run's steps 13-{REAL_STEPS} bitwise; its losses at steps {sorted(b)} "
          f"within {rel:.3g} (tol 1e-6)", flush=True)
    return {"batches_resumed": len(resumed), "loss_rel": rel}


def feed_phase(real: dict) -> dict:
    """Phase 9e, the host feed: (a)-(e); (c)'s phase-11 rows are set beside
    its own in the summary."""
    t0 = time.monotonic()
    shutil.rmtree(FEED_DIR, ignore_errors=True)
    out = {"a_flagship": feed_flagship(), "b_real_files": feed_real(real),
           "c_zoo": feed_zoo(), "d_bench": feed_bench(real), "e_resume": feed_resume(real)}
    shutil.rmtree(FEED_DIR, ignore_errors=True)
    out["seconds"] = time.monotonic() - t0
    print(f"[9e] the host feed in {out['seconds']:.1f} s", flush=True)
    return out


# --- Phase 11: the few-shot model zoo ------------------------------------------

ZOO_MODELS = ("proto", "proto_hatt", "siamese", "gnn", "snail", "metanet")
ZOO_STEPS = 4
ZOO_DIR = WORK_DIR.parent / "chip_smoke_zoo"
# The flagship episode and step (bf16 encoder, f32 head, mse, W=8, Adam,
# shared table), 4 steps a replay, one val pass of 40 episodes at step 8.
ZOO_ARGV = ["--synthetic", "--bf16", "--steps_per_call", "4", "--val_step", str(ZOO_STEPS),
            "--val_iter", "40", "--train_iter", str(ZOO_STEPS)]
# The transformer cases at 2 of the JAX default's 4 layers (phase 14 runs
# the 4-layer transformer, and phase 22 its ring).
ZOO_TFM_DEPTH = ["--tfm_layers", "2"]
# 11c: proto over the CNN through cli.train_main on phase 9c's files, 200
# steps in one run: the mean loss of its first metric window against its
# last. ce: proto's -||q - p||^2 logits start deep in the sigmoid's flat
# tail, where the mse objective barely moves them.
ZOO_CLI_ARGV = ["--bf16", "--model", "proto", "--encoder", "cnn", "--loss", "ce",
                "--steps_per_call", "4", "--val_step", "20", "--val_iter", "40"]
ZOO_CLI_STEPS = 200


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for the block: a convolution's
    weight gradient may otherwise sum in atomics order, and a run-to-run
    comparison of training states would see it."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def fused_vs_eager(cfg, vocab, batches: list, tag: str) -> dict:
    """One replay of the S=4 graph (``make_multi_train_step``) against four
    eager ``train_step``s from the same fresh weights on the same 4
    batches: losses and norms within GRAPH_PARAM_TOL, then the state
    (``hold_state``)."""
    with deterministic_cudnn():
        eager, fused = (build_model(cfg, glove_init=vocab.vectors) for _ in range(2))
        opt_e, opt_f = make_optimizer(cfg, eager), make_optimizer(cfg, fused)
        table0 = eager.embedding.word_embedding.detach().clone()
        me = [train_step(eager, opt_e, cfg, *b) for b in batches]
        mf = make_multi_train_step(fused, opt_f, cfg)(*stack_batches(batches))
    worst = 0.0
    for key in ("loss", "grad_norm"):
        _, rel = rel_err(mf[key].float(), torch.stack([m[key] for m in me]).float())
        worst = max(worst, rel)
        if rel > GRAPH_PARAM_TOL:
            raise AssertionError(f"{tag}: S=4 replay vs 4 eager steps: {key} relative error "
                                 f"{rel:.3g}")
    held = hold_state(tag, (fused, opt_f), (eager, opt_e), table0)
    return {**held, "metrics_rel": worst}


def grads_vs(g: dict, g_ref: dict, g_f32: dict, tag: str) -> dict:
    """Every parameter's step-0 gradient within GRAD_REL_TOL of its own
    scale (phase 9's bar), kernels vs plain backends, both in bf16. A
    leaf whose gradient in an f32 run of the plain backends (``g_f32``,
    the same weights and batch) is below NOISE_LEAF of the largest
    element over all leaves carries rounding noise alone (a softmax's
    shared shift: gnn's ``adj_*.Dense_2.bias``, snail's ``att_*.k.bias``):
    it is left out of the bar, and each such leaf is printed with its
    readings. The f32 run draws the line because in bf16 a noise leaf and
    a small real one lie at the same level."""
    top = max(gr.abs().max().item() for gr in g_f32.values())
    rows, levels, dropped = {}, {}, {}
    for n, gr in g_ref.items():
        if not torch.isfinite(g[n]).all():
            raise AssertionError(f"{tag}: step-0 gradient of {n} is not finite")
        level = g_f32[n].abs().max().item() / top
        if level < NOISE_LEAF:
            dropped[n] = {"f32_level": level,
                          "bf16_abs_err_of_top": (g[n] - gr).abs().max().item() / top}
            continue
        rows[n], levels[n] = rel_err(g[n], gr)[1], level
    name, low = max(rows, key=rows.get), min(levels, key=levels.get)
    print(f"[{tag}] step-0 gradients of {len(rows)} leaves within {rows[name]:.3g} of their own "
          f"scale (worst {name}; tol {GRAD_REL_TOL}; the smallest kept leaf, {low}, at "
          f"{levels[low]:.3g} of the largest f32 element); {len(dropped)} leaves below "
          f"{NOISE_LEAF:g} left out: {dropped}", flush=True)
    if rows[name] > GRAD_REL_TOL:
        raise AssertionError(f"{tag}: step-0 gradient of {name}: error {rows[name]:.3g} of its "
                             f"scale > {GRAD_REL_TOL}")
    return {"worst": rows[name], "leaves": len(rows), "dropped": len(dropped),
            "smallest_kept_level": levels[low],
            "largest_dropped_level": max((d["f32_level"] for d in dropped.values()), default=None)}


def zoo_optim_check(model, gen: torch.Generator) -> dict:
    """The optimizer pair on the model's parameter list (table entries past
    the flagship's step's) vs the plain twin and the per-parameter loop,
    Adam, from random parameters, gradients and moments at count 2000: the
    norm and the update within OPTIM_TOL of scale."""
    dev = torch.device("cuda")
    cfg = ExperimentConfig()
    hp = OptimHyper(cfg.lr, cfg.lr_gamma, cfg.lr_step_size, cfg.weight_decay, cfg.grad_clip)
    names = [n for n, _ in model.named_parameters()]

    def rand(like, scale):
        return torch.randn(like.shape, generator=gen, device=dev) * scale

    params = [rand(p, 0.1) for p in model.parameters()]
    grads = [rand(p, 1e-2) for p in params]
    mus, nus = [rand(p, 1e-3) for p in params], [rand(p, 1e-3).square() for p in params]
    rules = ["adam"] * len(params)
    ws = make_workspace(params)
    norm = optim_sumsq(params, grads, ws)
    _, n_rel = rel_err(norm, optim_sumsq_reference(params, grads))
    if n_rel > OPTIM_TOL:
        raise AssertionError(f"zoo optim_sumsq: relative error {n_rel:.3g} > {OPTIM_TOL}")
    kp, km, kv = ([x.clone() for x in xs] for xs in (params, mus, nus))
    count, p_count = (torch.full((), 2000, dtype=torch.int64, device=dev) for _ in range(2))
    optim_update(kp, grads, km, kv, rules, norm, count, hp, ws)
    optim_update_reference(params, grads, mus, nus, rules, norm, p_count, hp)
    pairs = {f"{n}.{w}": (a, b) for n, *trip in zip(names, kp, km, kv, params, mus, nus)
             for w, a, b in (("p", trip[0], trip[3]), ("m", trip[1], trip[4]),
                             ("v", trip[2], trip[5]))}
    err = check_outputs("zoo optim_update", pairs, OPTIM_TOL)
    return {"sumsq_rel": n_rel, "update_err": err}


def zoo_case(model_name: str, encoder: str, vocab, tok, gen: torch.Generator) -> dict:
    """One zoo model over one encoder at full width: one S=4 replay vs four
    eager steps; on the BiLSTM, step-0 gradients and ZOO_STEPS losses
    against the plain backends from the same weights; ZOO_STEPS steps and a
    val pass as graph replays with the wrappers' counts zeroed just before
    and read just after, launches by the profiler (K7, K8, K10, K11 and the
    weight-gradient and optimizer kernels once a step, K1 and K2 once a val
    batch); then the graph's profile."""
    tag = f"zoo {model_name}/{encoder}"
    t0 = time.monotonic()
    cfg = cli.config_from_args(cli.parse_args(
        train=True, argv=ZOO_ARGV + ["--model", model_name, "--encoder", encoder]
        + (ZOO_TFM_DEPTH if encoder == "transformer" else [])))

    def sampler(split="train", seed=0):
        return EpisodeSampler(cli.load_data(cfg, split), tok, cfg.n, cfg.k, cfg.q,
                              batch_size=cfg.batch_size, seed=cfg.seed + seed)

    four = sampler()
    fused = fused_vs_eager(cfg, vocab, [batch_to_model_inputs(four.sample_batch())
                                        for _ in range(4)], tag)
    model = build_model(cfg, glove_init=vocab.vectors)
    kernels = encoder == "bilstm"
    out = {"fused_vs_eager": fused, "tensors": len(list(model.parameters())),
           "optim": zoo_optim_check(model, gen)}
    if kernels:
        ref_cfg = cfg.replace(lstm_backend="reference", attn_backend="reference")
        ref_model = build_model(ref_cfg, glove_init=vocab.vectors)
        ref_model.load_state_dict(model.state_dict())
        f32_cfg = ref_cfg.replace(compute_dtype="float32")
        f32_model = build_model(f32_cfg, glove_init=vocab.vectors)
        f32_model.load_state_dict(model.state_dict())
        first = sampler().sample_batch()
        out["grads"] = grads_vs(batch_grads(model, cfg, first),
                                batch_grads(ref_model, ref_cfg, first),
                                batch_grads(f32_model, f32_cfg, first), tag)
        del f32_model
    on = (("K7", "K8") + STEP_KERNELS if kernels else ("optim_sumsq", "optim_update"))
    trainer = FewShotTrainer(model, cfg, sampler(), sampler("val", 1),
                             logger=MetricsLogger(ZOO_DIR / f"{model_name}_{encoder}",
                                                  quiet=True), metric_window=1)
    evals = evals_per_pass(trainer)
    launches, wrapped, recs = run_trainer(trainer, ZOO_STEPS, on + (("K1", "K2") if kernels
                                                                    else ()), evals)
    out["launches"] = launches
    if kernels:
        ref_trainer = FewShotTrainer(ref_model, ref_cfg.replace(steps_per_call=1), sampler(),
                                     logger=MetricsLogger(ZOO_DIR / f"{model_name}_reference",
                                                          quiet=True), metric_window=1)
        ref_trainer.train(ZOO_STEPS)
        ref_trainer.close()
        _, out["loss_rel"] = losses_vs(
            recs, train_records(ZOO_DIR / f"{model_name}_reference" / "metrics.jsonl"), tag)
        del ref_model, ref_trainer
    prof = profile_graph_steps(trainer, on, calls=4, tag=f"profile {tag}")
    out.update({k: prof[k] for k in ("step_ms", "episodes_per_s", "busy_ms", "busy_share")},
               launches_per_step=prof["launches"], sample_ms=prof["split"]["sample"])
    print(f"[{tag}] S=4 replay vs 4 eager steps: state {fused['state_rel']:.3g}, metrics "
          f"{fused['metrics_rel']:.3g} (tol {GRAPH_PARAM_TOL}); optimizer pair on the model's "
          f"{out['tensors']} tensors vs plain: norm rel {out['optim']['sumsq_rel']:.3g}, update "
          f"max abs err {out['optim']['update_err']:.3g} (tol {OPTIM_TOL} of scale)"
          + (f"; vs plain backends: step-0 gradients {out['grads']['worst']:.3g} of their "
             f"scale (tol {GRAD_REL_TOL}), losses over {ZOO_STEPS} steps {out['loss_rel']:.3g} (tol "
             f"{LOSS_REL_TOL})" if kernels else "")
          + f"; launches (profiler, {ZOO_STEPS} steps + {evals} val batches) "
          f"{ {k: n for k, n in launches.items() if n} }; {prof['step_ms']:.3f} ms/step, "
          f"{prof['episodes_per_s']:.1f} episodes/s, busy {prof['busy_ms']:.3f} ms/step "
          f"({prof['busy_share']:.1%}), {prof['launches']:.1f} launches/step; "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def zoo_cli(real: dict) -> dict:
    """11c: ``cli.train_main`` for proto over the CNN on phase 9c's files,
    ZOO_CLI_STEPS steps: the mean loss of the last [train] record (the last
    metric window) must be below that of the first; then ``cli.test_main``
    on the test file. (The CLI's resume is held by 9c and 9e(e).)"""
    ckpt = ZOO_DIR / "cli"
    argv = ZOO_CLI_ARGV + real_argv(real["paths"], "train", "val") + ["--save_ckpt", str(ckpt)]
    rc, _, err = quiet_cli(cli.train_main, argv + ["--train_iter", str(ZOO_CLI_STEPS)])
    if rc != 0:
        raise AssertionError(f"zoo train_main: rc {rc}, {err[-2000:]!r}")
    recs = train_records(ckpt / "metrics.jsonl")
    steps = [r["step"] for r in recs]
    if len(steps) < 2 or steps[-1] != ZOO_CLI_STEPS or steps != sorted(set(steps)):
        raise AssertionError(f"zoo train_main: [train] records at steps {steps}")
    first, last = recs[0]["loss"], recs[-1]["loss"]
    if not last < first:
        raise AssertionError(f"zoo train_main: mean loss of steps {steps[-2] + 1}-{steps[-1]} "
                             f"{last} not below steps 1-{steps[0]}'s {first}")
    rc, out, err = quiet_cli(cli.test_main, ["--bf16", "--model", "proto", "--encoder", "cnn",
                                             "--loss", "ce", "--load_ckpt", str(ckpt),
                                             "--test_iter", "40", "--steps_per_call", "4"]
                             + real_argv(real["paths"], "test"))
    result = json.loads(out.strip().splitlines()[-1])
    if rc != 0 or not 0.0 <= result["test_accuracy"] <= 1.0:
        raise AssertionError(f"zoo test_main: rc {rc}, {result}, {err[-2000:]!r}")
    print(f"[zoo cli] train_main --model proto --encoder cnn on 9c's files, {ZOO_CLI_STEPS} "
          f"steps: mean loss steps 1-{steps[0]} {first:.5f} -> steps {steps[-2] + 1}-"
          f"{steps[-1]} {last:.5f}; test_main on the test file: {result}", flush=True)
    return {"loss_first": first, "loss_last": last, "test": result}


def zoo_phase(real: dict) -> dict:
    """Phase 11: 11a every zoo model over the BiLSTM, 11b over the CNN and
    (proto, gnn) over the transformer, 11c the CLI on real-format files."""
    t0 = time.monotonic()
    shutil.rmtree(ZOO_DIR, ignore_errors=True)
    cfg = ExperimentConfig()
    vocab = make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim)
    tok = GloveTokenizer(vocab, max_length=cfg.max_length)
    cases = [(m, "bilstm") for m in ZOO_MODELS] + [(m, "cnn") for m in ZOO_MODELS] \
        + [("proto", "transformer"), ("gnn", "transformer")]
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {f"{m}/{e}": zoo_case(m, e, vocab, tok, gen) for m, e in cases}
    out["cli"] = zoo_cli(real)
    shutil.rmtree(ZOO_DIR, ignore_errors=True)
    out["seconds"] = time.monotonic() - t0
    print(f"[zoo] phase 11: {len(cases)} model/encoder cases and the CLI in "
          f"{out['seconds']:.1f} s", flush=True)
    return out


# --- Phase 13: BERT-base through the port's CLI ------------------------------------

BERT_DIR = WORK_DIR.parent / "chip_smoke_bert"
BERT_STEPS = 8
# 13a/13b: BERT-base (12 layers x 768, 12 heads, FFN 3072, 30 522 ids through
# the hash-fallback tokenizer, random weights from the seed) under the
# flagship's induction head: L=40, bf16 encoder, f32 head, mse, Adam, 5-way
# 5-shot, Q=5, B=2 (100 encoder rows, 4 000 tokens a step), 4 steps a
# replay, one val pass of 20 episodes at step 8.
BERT_ARGV = ["--synthetic", "--bf16", "--encoder", "bert", "--batch_size", "2",
             "--steps_per_call", "4", "--val_step", str(BERT_STEPS), "--val_iter", "20",
             "--train_iter", str(BERT_STEPS), *TODAY]
BERT_TABLE = "encoder.backbone.tok_emb.embedding"
# 13c: the frozen backbone's feature cache on 9c's files through the CLI, 40
# head steps, 4 a replay; the test-time re-encode held on 256 sampled rows.
CACHE_STEPS = 40
CACHE_ARGV = ["--bf16", "--encoder", "bert", "--bert_frozen", "--feature_cache",
              "--batch_size", "2", "--steps_per_call", "4", "--val_step", str(CACHE_STEPS),
              "--val_iter", "20", "--train_iter", str(CACHE_STEPS)]
CACHE_ROWS = 256
# The test-time features of a cached checkpoint (its backbone rebuilt from the
# checkpoint's config) vs the training run's, the same split in the same
# chunks: the same weights and operations, so within 1e-6 of scale.
CACHE_TOL = 1e-6
# 13d: BERT-PAIR at FewRel 2.0's pair shape: 5-way 1-shot, Q=1, one NOTA
# query a class (na_rate 1), B=4: 120 sequences of 2L = 80 tokens a step, 2
# steps a replay.
PAIR_ARGV = ["--synthetic", "--bf16", "--model", "pair", "--encoder", "bert", "--K", "1",
             "--Q", "1", "--na_rate", "1", "--batch_size", "4", "--loss", "ce",
             "--steps_per_call", "2", *TODAY]
PAIR_STEPS = 4
PAIR_TABLE = "backbone.tok_emb.embedding"
# 13e: 13a's checkpoint served: one tenant of 5 relations at K=5, 48 requests.
BERT_SERVE_PLAN = [1] * 16 + [4] * 4 + [16]
OPTIM_ON = ("optim_sumsq", "optim_update")


def bert_setup(argv: list):
    """(cfg, tokenizer, sampler factory) of a phase-13 command line as the
    CLI parses it; the samplers draw the CLI's synthetic splits."""
    cfg = cli.config_from_args(cli.parse_args(train=True, argv=argv))
    tok, cfg, _ = cli.make_tokenizer(None, cfg)

    def sampler(split: str = "train", seed: int = 0):
        return EpisodeSampler(cli.load_data(cfg, split), tok,
                              cfg.train_n if split == "train" else cfg.n, cfg.k, cfg.q,
                              batch_size=cfg.batch_size, na_rate=cfg.na_rate,
                              seed=cfg.seed + seed)

    return cfg, tok, sampler


def bert_flops(cfg, sequences: int, length: int, passes: int = 3) -> float:
    """Matmul FLOPs of the BERT layers over ``sequences`` x ``length``
    tokens: per token and layer the QKV, output and FFN products, 2(4H^2 +
    2HI), and the two attention contractions, 4LH; ``passes`` 3 for a
    training step (forward and backward), 1 for a forward."""
    H, inter = cfg.bert_hidden, cfg.bert_intermediate
    per_token = cfg.bert_layers * (2 * (4 * H * H + 2 * H * inter) + 4 * length * H)
    return passes * sequences * length * per_token


def bert_fused_vs_eager(cfg, base, batches: list, tag: str, table: str) -> dict:
    """One replay of the S-step graph against S eager ``train_step``s from
    ``base``'s weights on the same S batches: losses and norms within
    GRAPH_PARAM_TOL, then the state at ``hold_state``'s bars (``table``, the
    BERT token table, in the word table's place)."""
    eager, fused = copy.deepcopy(base), copy.deepcopy(base)
    opt_e, opt_f = make_optimizer(cfg, eager), make_optimizer(cfg, fused)
    table0 = dict(eager.named_parameters())[table].detach().clone()
    me = [train_step(eager, opt_e, cfg, *b) for b in batches]
    mf = make_multi_train_step(fused, opt_f, cfg)(*stack_batches(batches))
    worst = 0.0
    for key in ("loss", "grad_norm"):
        _, rel = rel_err(mf[key].float(), torch.stack([m[key] for m in me]).float())
        worst = max(worst, rel)
        if rel > GRAPH_PARAM_TOL:
            raise AssertionError(f"{tag}: S={len(batches)} replay vs {len(batches)} eager steps: "
                                 f"{key} relative error {rel:.3g}")
    held = hold_state(tag, (fused, opt_f), (eager, opt_e), table0, table)
    del eager, fused, opt_e, opt_f, mf
    gc.collect()
    torch.cuda.empty_cache()
    return {**held, "metrics_rel": worst}


def bert_grads(model, cfg, batch) -> dict:
    """Step-0 loss gradients of one batch (no update): each leaf's largest
    |g|, None for a leaf without a gradient; every gradient finite."""
    support, query, label = batch
    model.zero_grad(set_to_none=True)
    loss, _ = loss_and_metrics(model, to_device(support, "cuda"), to_device(query, "cuda"),
                               torch.as_tensor(label).cuda(), cfg.loss)
    loss.backward()
    out = {}
    for n, p in model.named_parameters():
        if p.grad is not None and not torch.isfinite(p.grad).all():
            raise AssertionError(f"step-0 gradient of {n} is not finite")
        out[n] = None if p.grad is None else p.grad.abs().max().item()
    model.zero_grad(set_to_none=True)
    return out


def bert_optim(model, gen: torch.Generator) -> dict:
    """13a: the optimizer pair on BERT-base's parameter list (Adam on each
    tensor, from random parameters, gradients and moments at count 2000, the
    clip engaged) vs its plain twin and the per-parameter loop, within
    OPTIM_TOL of each tensor's scale; device times beside the bound (bytes)
    and ``Adam(fused=True)``."""
    dev = torch.device("cuda")
    cfg = ExperimentConfig()
    hp = OptimHyper(cfg.lr, cfg.lr_gamma, cfg.lr_step_size, cfg.weight_decay, cfg.grad_clip)
    names = [n for n, _ in model.named_parameters()]

    def rand(like, scale):
        return torch.randn(like.shape, generator=gen, device=dev) * scale

    params = [rand(p, 0.1) for p in model.parameters()]
    grads = [rand(p, 1e-3) for p in params]
    mus, nus = [rand(p, 1e-3) for p in params], [rand(p, 1e-3).square() for p in params]
    rules = ["adam"] * len(params)
    ws = make_workspace(params)
    norm = optim_sumsq(params, grads, ws)
    _, n_rel = rel_err(norm, optim_sumsq_reference(params, grads))
    if n_rel > OPTIM_TOL:
        raise AssertionError(f"bert optim_sumsq: relative error {n_rel:.3g} > {OPTIM_TOL}")
    kp, km, kv = ([x.clone() for x in xs] for xs in (params, mus, nus))
    count, p_count = (torch.full((), 2000, dtype=torch.int64, device=dev) for _ in range(2))
    optim_update(kp, grads, km, kv, rules, norm, count, hp, ws)
    optim_update_reference(params, grads, mus, nus, rules, norm, p_count, hp)
    pairs = {f"{n}.{w}": (a, b) for n, *trip in zip(names, kp, km, kv, params, mus, nus)
             for w, a, b in (("p", trip[0], trip[3]), ("m", trip[1], trip[4]),
                             ("v", trip[2], trip[5]))}
    err = check_outputs("bert optim_update", pairs, OPTIM_TOL)
    numels = [p.numel() for p in params]
    n_all = sum(numels)
    sumsq_bound = bound(4 * n_all + 4, 3 * n_all / PEAK_FLOPS[torch.float32])
    update_bound = bound(optim_bytes(numels, rules), 20 * n_all / PEAK_FLOPS[torch.float32])
    ms_sumsq = device_ms(lambda: optim_sumsq(params, grads, ws))
    ms_update = device_ms(lambda: optim_update(kp, grads, km, kv, rules, norm, count, hp, ws))
    plain_sumsq = device_ms(lambda: optim_sumsq_reference(params, grads), 3)
    plain_update = device_ms(
        lambda: optim_update_reference(params, grads, mus, nus, rules, norm, p_count, hp), 3)
    lib_sumsq = (device_ms(lambda: torch.nn.utils.get_total_norm(grads))
                 if hasattr(torch.nn.utils, "get_total_norm") else None)
    lib_params = [torch.nn.Parameter(p.clone()) for p in params]
    for p, g in zip(lib_params, grads):
        p.grad = g
    adam = torch.optim.Adam(lib_params, lr=hp.lr, weight_decay=hp.weight_decay, fused=True)
    lib_update = device_ms(adam.step)
    print(f"[bert 13a] optimizer pair on BERT-base's {len(params)} tensors, {n_all} elements: "
          f"norm vs twin rel {n_rel:.3g}, update vs loop max abs err {err:.3g} (tol {OPTIM_TOL} "
          f"of scale); device ms: sumsq {ms_sumsq:.4f} (bound {sumsq_bound[0]:.4f}, twin "
          f"{plain_sumsq:.4f}, get_total_norm {lib_sumsq}), update {ms_update:.4f} (bound "
          f"{update_bound[0]:.4f} by {update_bound[1]}, loop {plain_update:.4f}, "
          f"Adam(fused=True) {lib_update:.4f})", flush=True)
    del params, grads, mus, nus, kp, km, kv, lib_params, adam, pairs
    gc.collect()
    torch.cuda.empty_cache()
    return {"tensors": len(numels), "elements": n_all, "err": err, "sumsq_rel": n_rel,
            "optim_sumsq": {"ms": ms_sumsq, "plain_ms": plain_sumsq, "bound_ms": sumsq_bound[0],
                            "bound_by": sumsq_bound[1], "library_ms": lib_sumsq},
            "optim_update": {"ms": ms_update, "plain_ms": plain_update,
                             "bound_ms": update_bound[0], "bound_by": update_bound[1],
                             "library_ms": lib_update}}


def sdpa_vs_plain(gen: torch.Generator) -> dict:
    """13a: one BERT-base layer's attention core at 13a's shape (100
    sequences x 40 tokens, 12 heads of 64, bf16, ragged masks): the port's
    plain form (``models/bert.py``) against
    ``F.scaled_dot_product_attention`` on the same q, k, v and mask, device
    times. A measurement for a later PR; the path keeps the plain form."""
    B, nh, d = 100, 12, 64
    q, k, v = (torch.randn(B, L, nh, d, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    lens = torch.randint(8, L + 1, (B,), generator=gen, device="cuda")
    mask = (torch.arange(L, device="cuda")[None] < lens[:, None]).float()
    bias = attention_bias(mask)
    keep = mask[:, None, None, :] > 0

    def plain():
        s = torch.einsum("blhd,bmhd->bhlm", q, k).float() / d ** 0.5
        att = torch.softmax(s + bias, dim=-1)
        return torch.einsum("bhlm,bmhd->blhd", att.to(torch.bfloat16), v)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=keep).transpose(1, 2)

    diff = (plain().float() - sdpa().float()).abs().max().item()
    return {"plain_ms": device_ms(plain), "sdpa_ms": device_ms(sdpa), "max_abs_diff": diff}


def bert_train_run(trainer, steps: int, tag: str, evals: int = 0) -> dict:
    """``run_trainer`` over ``steps`` graph-replayed steps (the optimizer
    pair once a step, no other hand kernel), then ``profile_graph_steps``
    over two more replays; the peak memory of both."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches, _, recs = run_trainer(trainer, steps, OPTIM_ON, evals)
    losses = [r["loss"] for r in recs]
    if not np.isfinite(losses).all():
        raise AssertionError(f"{tag}: non-finite training loss {losses}")
    prof = profile_graph_steps(trainer, OPTIM_ON, calls=2, tag=f"profile {tag}")
    return {"launches": {k: n for k, n in launches.items() if n}, "losses": losses,
            **{k: prof[k] for k in ("step_ms", "episodes_per_s", "busy_ms", "busy_share",
                                    "pool_bytes")},
            "launches_per_step": prof["launches"], "host_split_ms": prof["split"],
            "peak_bytes": torch.cuda.max_memory_allocated()}


def bert_finetune(gen: torch.Generator) -> tuple[dict, object, dict]:
    """13a: fine-tuned BERT-base under the induction head. Returns (the
    readings, the fresh model, the checkpoint's directory)."""
    tag = "bert 13a"
    cfg, _, sampler = bert_setup(BERT_ARGV)
    t0 = time.monotonic()
    base = build_model(cfg)
    init_s = time.monotonic() - t0
    n_params = sum(p.numel() for p in base.parameters())
    four = sampler()
    batches = [batch_to_model_inputs(four.sample_batch()) for _ in range(4)]
    fused = bert_fused_vs_eager(cfg, base, batches, tag, BERT_TABLE)
    cfg_r = cfg.replace(bert_remat=True)
    remat = build_model(cfg_r)
    remat.load_state_dict(base.state_dict())
    fused_remat = bert_fused_vs_eager(cfg_r, remat, batches[:2], f"{tag} remat", BERT_TABLE)
    del remat
    grads = bert_grads(base, cfg, batches[0])
    backbone = {n: g for n, g in grads.items() if ".backbone." in n}
    if any(g is None or g == 0.0 for g in backbone.values()):
        raise AssertionError(f"{tag}: a backbone leaf has no gradient: "
                             f"{[n for n, g in backbone.items() if not g]}")
    optim = bert_optim(base, gen)
    sdpa = sdpa_vs_plain(gen)
    model = copy.deepcopy(base)
    trainer = FewShotTrainer(model, cfg, sampler(), sampler("val", 1),
                             logger=MetricsLogger(BERT_DIR / "finetune", quiet=True),
                             metric_window=1)
    run = bert_train_run(trainer, BERT_STEPS, tag, evals_per_pass(trainer))
    rows = cfg.batch_size * (cfg.train_n * cfg.k + (cfg.train_n + cfg.na_rate) * cfg.q)
    flops = bert_flops(cfg, rows, cfg.max_length)
    run["tflop_per_step"] = flops / 1e12
    run["flop_bound_ms"] = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    ckpt = BERT_DIR / "ckpt"
    m = trainer.evaluate(cfg.val_iter, return_metrics=True)
    saver = CheckpointManager(ckpt, cfg)
    saver.save(BERT_STEPS, model, trainer.opt, m["accuracy"])
    saver.close()
    trainer.close()
    print(f"[{tag}] BERT-base fine-tuned ({n_params} parameters, {len(grads)} tensors, init "
          f"{init_s:.1f} s): S=4 replay vs 4 eager steps: state {fused['state_rel']:.3g}, metrics "
          f"{fused['metrics_rel']:.3g} (tol {GRAPH_PARAM_TOL}), the token table's moments "
          f"{fused['table_moments_rel']:.3g}; --bert_remat (each layer under "
          f"torch.utils.checkpoint) captured: S=2 replay vs 2 eager steps, state "
          f"{fused_remat['state_rel']:.3g}; step-0 gradients finite, every backbone leaf's "
          f"nonzero (smallest max |g| {min(backbone.values()):.3g}); {BERT_STEPS} steps + "
          f"val as replays: launches {run['launches']}; {run['step_ms']:.3f} ms/step, "
          f"{run['episodes_per_s']:.1f} episodes/s, busy {run['busy_ms']:.3f} ms/step "
          f"({run['busy_share']:.1%}), {run['launches_per_step']:.1f} launches/step, graph pool "
          f"{run['pool_bytes'] / 2**20:.1f} MiB, peak {run['peak_bytes'] / 2**30:.2f} GiB; "
          f"{run['tflop_per_step']:.3f} TFLOP a step, bf16 bound {run['flop_bound_ms']:.3f} ms; "
          f"attention core plain {sdpa['plain_ms']:.4f} ms vs scaled_dot_product_attention "
          f"{sdpa['sdpa_ms']:.4f} ms (max abs diff {sdpa['max_abs_diff']:.3g}); val accuracy "
          f"{m['accuracy']:.4f}", flush=True)
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return ({"parameters": n_params, "init_s": init_s, "fused_vs_eager": fused,
             "remat_fused_vs_eager": fused_remat,
             "optim": optim, "sdpa": sdpa, **run}, base, ckpt)


def bert_frozen(base) -> dict:
    """13b: ``--bert_frozen`` on live tokens, 13a's shape and weights: the
    backbone's loss gradients exactly zero (no ``grad``), and one update
    moves it by the decay term alone (the JAX chain's: the optimizer's
    update with zero gradients); 8 steps and a val pass as replays."""
    tag = "bert 13b"
    cfg, _, sampler = bert_setup(BERT_ARGV + ["--bert_frozen"])
    model = build_model(cfg)
    model.load_state_dict(base.state_dict())
    batch = batch_to_model_inputs(sampler().sample_batch())
    grads = bert_grads(model, cfg, batch)
    live = [n for n, g in grads.items() if ".backbone." in n and g is not None]
    head = max(g for n, g in grads.items() if ".backbone." not in n)
    if live or not head > 0:
        raise AssertionError(f"{tag}: backbone leaves with a gradient {live}, head max {head}")
    opt = make_optimizer(cfg, model)
    bb = [(n, p) for n, p in model.named_parameters() if ".backbone." in n]
    p0 = [p.detach().clone() for _, p in bb]
    train_step(model, opt, cfg, *batch)
    want = [x.clone() for x in p0]
    hp = OptimHyper(cfg.lr, cfg.lr_gamma, cfg.lr_step_size, cfg.weight_decay, cfg.grad_clip)
    optim_update_reference(want, [None] * len(want), [torch.zeros_like(x) for x in want],
                           [torch.zeros_like(x) for x in want], ["adam"] * len(want),
                           torch.zeros(1, device="cuda"),
                           torch.zeros((), dtype=torch.int64, device="cuda"), hp)
    err = check_outputs(f"{tag} decay-only update",
                        {n: (p.detach(), w) for (n, p), w in zip(bb, want)}, OPTIM_TOL)
    moved = max((p.detach() - x).abs().max().item() for (_, p), x in zip(bb, p0))
    if not moved > 0.5 * cfg.lr:
        raise AssertionError(f"{tag}: the backbone moved by {moved}, not by the decay step")
    trainer = FewShotTrainer(model, cfg, sampler(), sampler("val", 1),
                             logger=MetricsLogger(BERT_DIR / "frozen", quiet=True),
                             metric_window=1)
    run = bert_train_run(trainer, BERT_STEPS, tag, evals_per_pass(trainer))
    trainer.close()
    print(f"[{tag}] --bert_frozen: every backbone leaf without a loss gradient (head max |g| "
          f"{head:.3g}); one update moved the backbone by {moved:.3g} (lr {cfg.lr}), equal to "
          f"the decay-only update within {err:.3g} (tol {OPTIM_TOL} of scale); launches "
          f"{run['launches']}; {run['step_ms']:.3f} ms/step, busy {run['busy_ms']:.3f} ms/step "
          f"({run['busy_share']:.1%}), peak {run['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    del trainer, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return {"backbone_moved": moved, "decay_err": err, **run}


def bert_cache(real: dict) -> dict:
    """13c: ``--bert_frozen --feature_cache`` through ``cli.train_main`` on
    9c's files (train and val encoded once, 40 head steps, a checkpoint);
    the same command line's trainer from ``cli.make_trainer`` profiled: the
    head-only state, the encode times, launches and ms/step of the graph
    replays, the bytes sent a step; the backbone rebuilt from the
    checkpoint's config re-encodes the val split equal to the training
    encoder's table on 256 sampled rows; ``cli.test_main`` re-encodes the
    test split and scores it; the serving engine refuses the checkpoint."""
    tag = "bert 13c"
    files = [a for s in ("train", "val") for a in (f"--{s}_file", str(real["paths"][s]))]
    ckpt = BERT_DIR / "cache"
    rc, out, err = quiet_cli(cli.train_main, CACHE_ARGV + files + ["--save_ckpt", str(ckpt)])
    if rc != 0:
        raise AssertionError(f"{tag}: train_main rc {rc}, {err[-2000:]!r}")
    trained = json.loads(out.strip().splitlines()[-1])
    args = cli.parse_args(True, CACHE_ARGV + files + ["--save_ckpt", str(BERT_DIR / "cache_prof")])
    with contextlib.redirect_stderr(io.StringIO()):
        trainer, _ = cli.make_trainer(args, cli.config_from_args(args))
    cfg = trainer.cfg
    names = [n for n, _ in trainer.model.named_parameters()]
    if any("backbone" in n or n.startswith(("encoder.", "embedding.")) for n in names):
        raise AssertionError(f"{tag}: the cached state holds encoder leaves: {names}")
    tables = {s: {"rows": t.rows, "tokenize_s": t.tokenize_s, "encode_s": t.encode_s,
                  "rows_per_s": t.rows / t.encode_s, "bytes": t.nbytes,
                  "flop_bound_s": bert_flops(cfg, t.rows, cfg.max_length, 1)
                  / PEAK_FLOPS[torch.bfloat16]}
              for s, t in (("train", trainer.train_table), ("val", trainer.val_table))}
    run = bert_train_run(trainer, CACHE_STEPS, tag, evals_per_pass(trainer))
    run["h2d_bytes_per_step"] = h2d_bytes(trainer)
    val_table = trainer.val_table.table
    trainer.close()
    saved = CheckpointManager.load_config(ckpt)
    with contextlib.redirect_stderr(io.StringIO()):
        rebuilt = cli.bert_backbone_model(saved, "cuda")
    tok, _, _ = cli.make_tokenizer(args, saved)
    again, _ = encode_table(rebuilt, cli.load_data(saved, "val", args), tok)
    rows = torch.randperm(val_table.shape[0], generator=torch.Generator().manual_seed(13))
    rows = rows[:CACHE_ROWS].cuda()
    _, re_rel = rel_err(again[rows], val_table[rows])
    if re_rel > CACHE_TOL:
        raise AssertionError(f"{tag}: the rebuilt backbone's features differ by {re_rel:.3g} of "
                             f"scale from the training encoder's")
    del rebuilt, again, val_table
    gc.collect()
    torch.cuda.empty_cache()
    rc, out, err = quiet_cli(cli.test_main, ["--bf16", "--load_ckpt", str(ckpt), "--test_iter",
                                             "40", "--steps_per_call", "4", "--test_file",
                                             str(real["paths"]["test"])])
    if rc != 0:
        raise AssertionError(f"{tag}: test_main rc {rc}, {err[-2000:]!r}")
    tested = json.loads(out.strip().splitlines()[-1])
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            InferenceEngine.from_checkpoint(str(ckpt))
    except ValueError as e:
        if "feature-cache checkpoints" not in str(e):
            raise
        refusal = str(e)
    else:
        raise AssertionError(f"{tag}: the serving engine took a feature-cache checkpoint")
    print(f"[{tag}] feature cache through cli.train_main on 9c's files: {trained}; the state "
          f"holds the head's {len(names)} tensors alone; encoded {tables}; {CACHE_STEPS} head "
          f"steps as replays: launches {run['launches']}, {run['step_ms']:.4f} ms/step, "
          f"{run['episodes_per_s']:.1f} episodes/s, busy {run['busy_ms']:.4f} ms/step "
          f"({run['busy_share']:.1%}), {run['launches_per_step']:.1f} launches/step, "
          f"{run['h2d_bytes_per_step']:.0f} bytes to the card a step; the backbone rebuilt "
          f"from the checkpoint's config re-encodes {CACHE_ROWS} sampled val rows within "
          f"{re_rel:.3g} of scale (tol {CACHE_TOL}); test_main: {tested}; the engine refuses "
          f"it: {refusal!r}", flush=True)
    return {"train_main": trained, "head_tensors": len(names), "tables": tables,
            "rebuilt_rel": re_rel, "test_main": tested, **run}


def bert_pair() -> dict:
    """13d: BERT-PAIR at FewRel 2.0's pair shape: one S=2 replay vs two
    eager steps, then 4 steps as replays."""
    tag = "bert 13d"
    cfg, _, sampler = bert_setup(PAIR_ARGV)
    base = build_model(cfg)
    two = sampler()
    batches = [batch_to_model_inputs(two.sample_batch()) for _ in range(2)]
    fused = bert_fused_vs_eager(cfg, base, batches, tag, PAIR_TABLE)
    trainer = FewShotTrainer(base, cfg, sampler(),
                             logger=MetricsLogger(BERT_DIR / "pair", quiet=True),
                             metric_window=1)
    run = bert_train_run(trainer, PAIR_STEPS, tag)
    seqs = cfg.batch_size * (cfg.train_n + cfg.na_rate) * cfg.q * cfg.train_n * cfg.k
    flops = bert_flops(cfg, seqs, 2 * cfg.max_length)
    run.update(sequences=seqs, tflop_per_step=flops / 1e12,
               flop_bound_ms=flops / PEAK_FLOPS[torch.bfloat16] * 1e3)
    trainer.close()
    print(f"[{tag}] BERT-PAIR, {seqs} sequences of {2 * cfg.max_length} tokens a step: S=2 "
          f"replay vs 2 eager steps: state {fused['state_rel']:.3g}, metrics "
          f"{fused['metrics_rel']:.3g} (tol {GRAPH_PARAM_TOL}); launches {run['launches']}; "
          f"{run['step_ms']:.3f} ms/step, busy {run['busy_ms']:.3f} ms/step "
          f"({run['busy_share']:.1%}), {run['launches_per_step']:.1f} launches/step, peak "
          f"{run['peak_bytes'] / 2**30:.2f} GiB; {run['tflop_per_step']:.3f} TFLOP a step, bf16 "
          f"bound {run['flop_bound_ms']:.3f} ms", flush=True)
    del trainer, base
    gc.collect()
    torch.cuda.empty_cache()
    return {"fused_vs_eager": fused, **run}


def bert_serve(ckpt: Path) -> dict:
    """13e: 13a's checkpoint through ``InferenceEngine.from_checkpoint``:
    one tenant of 5 relations at K=5, 48 requests in buckets 1, 4 and 16 as
    graph replays, no capture after warmup; every verdict's logits vs the
    eager scoring of its query at f32 residency."""
    from induction_network_on_fewrel_tpu_torch.serving.buckets import QueryRunner, stack_queries

    tag = "bert 13e"
    with contextlib.redirect_stderr(io.StringIO()):
        engine = InferenceEngine.from_checkpoint(str(ckpt))
    cfg = engine.cfg
    ds = make_synthetic_fewrel(num_relations=5, instances_per_relation=40,
                               vocab_size=cfg.vocab_size - 2, sentence_len=(10, 60), seed=0)
    engine.register_dataset(ds)
    made = engine.warmup()
    captured = engine.programs.captures
    pool = [i for rel in ds.rel_names for i in ds.instances[rel][cfg.k:cfg.k + 10]]
    batches, pos = [], 0
    for size in BERT_SERVE_PLAN:
        batches.append(pool[pos:pos + size])
        pos += size
    verdicts = [engine.classify_batch(b) for b in batches]
    torch.cuda.synchronize()
    if engine.stats.served != pos or engine.stats.steady_compiles \
            or engine.programs.captures != captured:
        raise AssertionError(f"{tag}: served {engine.stats.served} of {pos}, steady compiles "
                             f"{engine.stats.steady_compiles}, captures {captured} -> "
                             f"{engine.programs.captures}")
    snap = engine.registry.snapshot()
    runner = QueryRunner(engine.registry.banks[snap.bank])
    names = engine.class_names
    worst, scale = 0.0, 0.0
    for batch, vs in zip(batches, verdicts):
        for inst, v in zip(batch, vs):
            t = engine.tokenizer(inst)
            want = runner.run(snap.matrix, stack_queries(
                [{k: getattr(t, k) for k in QUERY_DTYPES}], 1))[0][:len(names)]
            got = np.array([v["logits"][n] for n in names])
            if not np.isfinite(got).all():
                raise AssertionError(f"{tag}: non-finite logits")
            worst, scale = max(worst, float(np.abs(got - want).max())), max(
                scale, float(np.abs(want).max()))
    if worst > LOGIT_REL_TOL * scale:
        raise AssertionError(f"{tag}: served logits vs eager {worst} > {LOGIT_REL_TOL}*{scale}")
    by_bucket: dict = {}
    for vs in verdicts:
        for v in vs:
            by_bucket.setdefault(v["bucket"], []).append(v["latency_ms"])
    p50 = {b: float(np.percentile(by_bucket[b], 50)) for b in sorted(by_bucket)}
    split = engine.host_split.ms()
    engine.close()
    print(f"[{tag}] served {pos} requests of one 5-relation tenant from 13a's checkpoint as "
          f"graph replays ({made} query programs at warmup, none after); logits vs eager at f32 "
          f"residency: max abs err {worst:.3g} at scale {scale:.3g} (tol {LOGIT_REL_TOL}); p50 "
          f"ms by bucket {p50}; host ms per batch {split}", flush=True)
    return {"served": pos, "programs": made, "logit_err": worst, "logit_scale": scale,
            "p50_ms_by_bucket": p50, "host_split_ms": split}


def bert_phase(real: dict) -> dict:
    """Phase 13: 13a fine-tuned BERT-base, 13b frozen, 13c the feature cache,
    13d BERT-PAIR, 13e 13a's checkpoint served."""
    t0 = time.monotonic()
    shutil.rmtree(BERT_DIR, ignore_errors=True)
    gen = torch.Generator(device="cuda").manual_seed(13)
    out = {}
    out["a_finetune"], base, ckpt = bert_finetune(gen)
    out["b_frozen"] = bert_frozen(base)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    out["c_feature_cache"] = bert_cache(real)
    out["d_pair"] = bert_pair()
    out["e_serving"] = bert_serve(ckpt)
    shutil.rmtree(BERT_DIR, ignore_errors=True)
    out["seconds"] = time.monotonic() - t0
    print(f"[bert] phase 13 in {out['seconds']:.1f} s", flush=True)
    return out


# --- The serving plane on a trained checkpoint (phases 4a-4c) -------------------

# --- Phase 14: the rest of the single-card zoo (adversarial, MoE, stacked) ----------

SLICE_DIR = WORK_DIR.parent / "chip_smoke_slice6c"
ADV_STEPS = 20
# 14a: the flagship ExperimentConfig with bare --adv at the JAX DANN defaults
# (--adv_batch 32, --adv_dis_hidden 256, --adv_lambda 1.0), one val pass.
ADV_ARGV = ["--synthetic", "--bf16", "--adv", "--train_iter", str(ADV_STEPS), "--val_step",
            str(ADV_STEPS), "--val_iter", "40", *TODAY]
ADV_M = 32                              # each instance batch's encoder rows
# An adversarial step runs the encoder three times (the episode's 200 rows,
# the 32 source and the 32 target instances) and updates two parameter
# lists (the model's and the discriminator's).
ENCODER_KERNELS = ("K7", "K8", "K10", "K11", "wgrad")
ADV_PER_STEP = {**{k: 3 for k in ENCODER_KERNELS}, "optim_sumsq": 2, "optim_update": 2}
ADV_ON = ("K7", "K8") + STEP_KERNELS
ADV_FILE_STEPS = 100                    # 14b: two metric windows of 50 steps
SLICE_STEPS = 8
# 14c/14d: the transformer at the JAX widths (4 x 256, 4 heads, FFN 1024)
# under the induction head, the flagship episode and step, 4 steps a replay.
TFM_ARGV = ["--synthetic", "--bf16", "--encoder", "transformer", "--steps_per_call", "4",
            "--train_iter", str(SLICE_STEPS), "--val_step", str(SLICE_STEPS), "--val_iter", "40",
            *TODAY]
# README's --moe_experts 8 at ep=1; every other --moe_* at its JAX default
# (top-k 2, capacity 2.0, every 2nd block, groups of 512, aux weight 1e-2).
MOE_FLAGS = ["--moe_experts", "8"]
SLICE_SECONDS = 120


def adv_expect(steps: int, graphs: int) -> dict:
    """Profiled launches of ``steps`` adversarial steps as replays of
    ``graphs`` captured graphs: each encoder kernel three times a step and a
    graph's warm-up (an eager forward and backward), the optimizer pair
    twice a step and once a warm-up (on scratch tensors)."""
    out = {}
    for k in PROFILED:
        n = ADV_PER_STEP.get(k.split()[0])
        if n is not None:
            out[k] = n * steps + (3 if n == 3 else 1) * graphs
    return out


def adv_batches(cfg, tok, pieces, n: int) -> list:
    """``n`` (support, query, label, src, tgt) batches: the episode sampler
    of the run's seed and ``pieces``' instance samplers."""
    s = EpisodeSampler(cli.load_data(cfg, "train"), tok, cfg.n, cfg.k, cfg.q,
                       batch_size=cfg.batch_size, seed=cfg.seed)
    return [batch_to_model_inputs(s.sample_batch()) + pieces.sample() for _ in range(n)]


def stack_adv(batches: list) -> tuple:
    return stack_batches([b[:3] for b in batches]) + tuple(
        {k: np.stack([b[j][k] for b in batches]) for k in batches[0][j]} for j in (3, 4))


def adv_grads(model, disc, cfg, batch) -> dict:
    """Gradients of the adversarial objective on one batch (no update): the
    model's leaves and the discriminator's (``disc.*``)."""
    sup, qry, label, src, tgt = batch
    for m in (model, disc):
        m.zero_grad(set_to_none=True)
    loss, _ = adv_loss_and_metrics(model, disc, cfg, to_device(sup, "cuda"),
                                   to_device(qry, "cuda"), torch.as_tensor(label).cuda(),
                                   to_device(src, "cuda"), to_device(tgt, "cuda"))
    loss.backward()
    g = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    g.update({f"disc.{n}": p.grad.detach().clone() for n, p in disc.named_parameters()})
    for m in (model, disc):
        m.zero_grad(set_to_none=True)
    return g


def adv_pair(cfg, vocab) -> list:
    """Two fresh (model, optimizer, discriminator state) from the seeds."""
    out = []
    for _ in range(2):
        model = build_model(cfg, glove_init=vocab.vectors)
        out.append((model, make_optimizer(cfg, model),
                    init_disc_state(cfg, encoder_output_dim(cfg), "cuda")))
    return out


def hold_adv(tag: str, got: tuple, want: tuple, table0: torch.Tensor) -> dict:
    """``hold_state`` on the models, then the discriminators: counts equal,
    parameters and moments within GRAPH_PARAM_TOL of their scale."""
    (model, opt, disc), (ref_model, ref_opt, ref_disc) = got, want
    held = hold_state(tag, (model, opt), (ref_model, ref_opt), table0)
    if int(disc.opt.count) != int(ref_disc.opt.count):
        raise AssertionError(f"{tag}: discriminator count {int(disc.opt.count)} != "
                             f"{int(ref_disc.opt.count)}")
    worst = 0.0
    for xs, ys in ((disc.opt.params, ref_disc.opt.params), (disc.opt.mu, ref_disc.opt.mu),
                   (disc.opt.nu, ref_disc.opt.nu)):
        for a, b in zip(xs, ys):
            worst = max(worst, rel_err(a.detach(), b.detach())[1])
    print(f"[{tag}] discriminator count {int(disc.opt.count)}, parameters and moments worst rel "
          f"{worst:.3g} (tol {GRAPH_PARAM_TOL})", flush=True)
    if worst > GRAPH_PARAM_TOL:
        raise AssertionError(f"{tag}: discriminator state relative error {worst:.3g}")
    return {**held, "disc_rel": worst}


def adv_metrics_rel(got: dict, want: list, tag: str) -> float:
    """The worst relative difference of the step metrics (``want``: one
    dict per step) over the losses and the norm."""
    worst = 0.0
    for key in ("loss", "domain_loss", "grad_norm"):
        ref = torch.stack([torch.as_tensor(m[key]).reshape(()) for m in want]).float()
        worst = max(worst, rel_err(torch.as_tensor(got[key]).float().reshape(-1), ref)[1])
    if worst > GRAPH_PARAM_TOL:
        raise AssertionError(f"{tag}: step metrics relative error {worst:.3g}")
    return worst


def adv_graph_checks(cfg, vocab, first, four: list) -> tuple[dict, dict]:
    """One graph step vs one eager step, and one S=4 replay vs four S=1
    replays, each from the same fresh weights on the same batches."""
    (eager, opt_e, de), (graph, opt_g, dg) = adv_pair(cfg, vocab)
    table0 = eager.embedding.word_embedding.detach().clone()
    me = adv_train_step(eager, opt_e, de, cfg, *first)
    mg = make_adv_train_step(graph, opt_g, dg, cfg)(*first)
    rel = adv_metrics_rel(mg, [me], "14a graph vs eager")
    g_vs_e = {**hold_adv("14a graph vs eager", (graph, opt_g, dg), (eager, opt_e, de), table0),
              "metrics_rel": rel}
    del eager, graph, opt_e, opt_g
    (single, opt_s, ds_), (fused, opt_f, df) = adv_pair(cfg, vocab)
    table0 = single.embedding.word_embedding.detach().clone()
    step = make_adv_train_step(single, opt_s, ds_, cfg)
    ms = [step(*b) for b in four]
    mf = make_adv_multi_train_step(fused, opt_f, df, cfg)(*stack_adv(four))
    rel = adv_metrics_rel(mf, ms, "14a S=4 vs 4 x S=1")
    f_vs_s = {**hold_adv("14a S=4 vs 4 x S=1", (fused, opt_f, df), (single, opt_s, ds_), table0),
              "metrics_rel": rel}
    print(f"[14a] one graph step vs one eager step: metrics rel {g_vs_e['metrics_rel']:.3g}; "
          f"one S=4 replay vs four S=1 replays: metrics rel {f_vs_s['metrics_rel']:.3g} "
          f"(tol {GRAPH_PARAM_TOL})", flush=True)
    return g_vs_e, f_vs_s


def adv_phase(tr: dict, gen: torch.Generator, card: str) -> dict:
    """14a: bare ``--adv`` at the flagship config through ``cli.make_trainer``."""
    ckpt, ref_dir = SLICE_DIR / "adv", SLICE_DIR / "adv_reference"
    args = cli.build_arg_parser(train=True).parse_args(ADV_ARGV + ["--save_ckpt", str(ckpt)])
    cfg = cli.config_from_args(args)
    trainer, _ = cli.make_trainer(args, cfg)        # the model is built on the card
    trainer.metric_window = 1
    model, disc = trainer.model, trainer.adv.disc
    vocab = make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim)
    tok = GloveTokenizer(vocab, max_length=cfg.max_length)
    train_ds = cli.load_data(cfg, "train")

    def pieces(m):
        """Fresh instance samplers and a discriminator from their seeds."""
        return cli.adv_pieces(args, cfg, tok, train_ds, m)

    print(f"[14a] --adv (synthetic target, seed 97): adv_batch {cfg.adv_batch} x 2, "
          f"adv_dis_hidden {cfg.adv_dis_hidden}, adv_lambda {cfg.adv_lambda}; encoder rows a "
          f"step {cfg.batch_size * cfg.n * (cfg.k + cfg.q)} + {ADV_M} + {ADV_M}; "
          f"discriminator {sum(p.numel() for p in disc.module.parameters())} parameters; {card}",
          flush=True)
    kchecks = train_kernel_checks(gen, {}, [(torch.float32, ADV_M, 8, torch.float32),
                                            (torch.bfloat16, ADV_M, 8, torch.bfloat16)])

    first = adv_batches(cfg, tok, pieces(model), 1)[0]
    ref_cfg = cfg.replace(lstm_backend="reference", attn_backend="reference")
    f32_cfg = ref_cfg.replace(compute_dtype="float32")
    ref_model = build_model(ref_cfg, glove_init=vocab.vectors)
    ref_model.load_state_dict(model.state_dict())
    f32_model = build_model(f32_cfg, glove_init=vocab.vectors)
    f32_model.load_state_dict(model.state_dict())
    grads = grads_vs(adv_grads(model, disc.module, cfg, first),
                     adv_grads(ref_model, disc.module, ref_cfg, first),
                     adv_grads(f32_model, disc.module, f32_cfg, first), "14a adv")
    del f32_model
    graph, fused = adv_graph_checks(cfg, vocab, first, adv_batches(cfg, tok, pieces(model), 4))

    evals = 40 // cfg.batch_size                    # --val_iter 40, one val pass
    launches, wrapped, recs = run_trainer(trainer, ADV_STEPS, ADV_ON + ("K1", "K2"), evals,
                                          expect=adv_expect(ADV_STEPS, 1))
    if len(recs) != ADV_STEPS or not (ckpt / "best.pt").exists():
        raise AssertionError(f"14a: {len(recs)} train records, best.pt missing?")
    ref_trainer = FewShotTrainer(
        ref_model, ref_cfg, EpisodeSampler(train_ds, tok, cfg.n, cfg.k, cfg.q,
                                           batch_size=cfg.batch_size, seed=cfg.seed),
        logger=MetricsLogger(ref_dir, quiet=True), metric_window=1, adv=pieces(ref_model))
    ref_trainer.train(ADV_STEPS)
    ref_trainer.close()
    ref_recs = train_records(ref_dir / "metrics.jsonl")
    rel = {k: losses_vs(recs, ref_recs, f"14a {k}", k)[1] for k in ("loss", "domain_loss")}

    cfg4 = cfg.replace(steps_per_call=4)
    m4 = build_model(cfg4, glove_init=vocab.vectors)
    trainer4 = FewShotTrainer(
        m4, cfg4, EpisodeSampler(train_ds, tok, cfg.n, cfg.k, cfg.q, batch_size=cfg.batch_size,
                                 seed=cfg.seed),
        logger=MetricsLogger(SLICE_DIR / "adv_spc4", quiet=True), metric_window=1,
        adv=pieces(m4))
    launches4, _, recs4 = run_trainer(trainer4, ADV_STEPS, ADV_ON,
                                      expect=adv_expect(ADV_STEPS, 1))
    rel4 = {k: losses_vs(recs4, ref_recs, f"14a spc4 {k}", k)[1] for k in ("loss", "domain_loss")}
    print(f"[14a] {ADV_STEPS} steps as graph replays at steps_per_call 1 and 4: launches "
          f"(profiler) {launches} / {launches4}; wrapper counts (warm-up and capture) {wrapped}; "
          f"losses {np.round([r['loss'] for r in recs], 5).tolist()}; domain losses "
          f"{np.round([r['domain_loss'] for r in recs], 5).tolist()}; vs plain backends: "
          f"{rel} (spc 1), {rel4} (spc 4; tol {LOSS_REL_TOL})", flush=True)

    saved = set(CheckpointManager(ckpt).params("best"))
    if saved != set(model.state_dict()):
        raise AssertionError(f"14a: the checkpoint's leaves differ from the model's: "
                             f"{sorted(saved ^ set(model.state_dict()))}")
    bilstm_infer_cuda.launches = attn_fwd_cuda.launches = 0
    rc, out, err = quiet_cli(cli.test_main, ["--synthetic", "--bf16", "--load_ckpt", str(ckpt),
                                             "--test_iter", "40"])
    served = {"K1": bilstm_infer_cuda.launches, "K2": attn_fwd_cuda.launches}
    result = json.loads(out.strip().splitlines()[-1])
    if rc != 0 or min(served.values()) == 0 or not 0.0 <= result["test_accuracy"] <= 1.0:
        raise AssertionError(f"14a test_main: rc {rc}, {served}, {result}, {err[-2000:]!r}")
    print(f"[14a] the checkpoint holds the plain model's {len(saved)} leaves and no "
          f"discriminator leaf; test_main on it: {result}, wrapper launches {served}", flush=True)

    prof1 = profile_graph_steps(trainer, ADV_ON, tag="profile 14a adv", per_step=ADV_PER_STEP)
    prof4 = profile_graph_steps(trainer4, ADV_ON, tag="profile 14a adv spc4",
                                per_step=ADV_PER_STEP)
    for tag, p, base in (("spc 1", prof1, tr["prof1"]), ("spc 4", prof4, tr["prof4"])):
        print(f"[14a] {tag}: {p['step_ms']:.3f} ms/step unprofiled, busy {p['busy_ms']:.3f} "
              f"ms/step ({p['busy_share']:.1%} of wall), {p['launches']:.1f} launches/step; "
              f"phase 9's flagship in this call {base['step_ms']:.3f} ms/step, busy "
              f"{base['busy_ms']:.3f}, {base['launches']:.1f} launches/step ({card})", flush=True)
    close_trainer(trainer)
    close_trainer(trainer4)
    return {"kernel_checks_m32": {f"{k} {n}": {"err": r["err"], "tol": r["tol"], "ms": r["ms"],
                                               "plain_ms": r["plain_ms"],
                                               "bound_ms": r["bound_ms"]}
                                  for (k, n), r in kchecks.items()},
            "grads": grads, "graph_vs_eager": graph, "fused_vs_single": fused,
            "launches": launches, "launches_spc4": launches4, "loss_rel": rel,
            "loss_rel_spc4": rel4, "test": result, "test_launches": served,
            "checkpoint_leaves": len(saved),
            **{f"{k}{sfx}": p[k] for sfx, p in (("", prof1), ("_spc4", prof4))
               for k in ("step_ms", "busy_ms", "busy_share")},
            "launches_per_step": prof1["launches"], "launches_per_step_spc4": prof4["launches"],
            "flagship_step_ms": tr["prof1"]["step_ms"],
            "flagship_spc4_step_ms": tr["prof4"]["step_ms"]}


def adv_file_phase(cfg) -> dict:
    """14b: ``--adv <file>``: the domain-shifted twin of the synthetic
    relations (shift 1.0) written as FewRel JSON, through ``cli.train_main``."""
    shifted = make_domain_shifted_fewrel(num_relations=10, instances_per_relation=30,
                                         vocab_size=cfg.vocab_size - 2, shift=1.0, seed=0)
    path = SLICE_DIR / "target_shifted.json"
    path.write_text(json.dumps({rel: [fewrel_record(i) for i in shifted.instances[rel]]
                                for rel in shifted.rel_names}))
    ckpt = SLICE_DIR / "adv_file"
    rc, _, err = quiet_cli(cli.train_main, [
        "--synthetic", "--bf16", "--adv", str(path), "--steps_per_call", "4", "--train_iter",
        str(ADV_FILE_STEPS), "--val_step", str(ADV_FILE_STEPS), "--val_iter", "40",
        "--save_ckpt", str(ckpt), *TODAY])
    recs = train_records(ckpt / "metrics.jsonl")
    if rc != 0 or len(recs) != 2 or not all(np.isfinite(r["domain_loss"]) for r in recs):
        raise AssertionError(f"14b: rc {rc}, {recs}, {err[-2000:]!r}")
    out = {f"steps_{r['step']}": {k: r[k] for k in ("loss", "domain_loss", "domain_accuracy",
                                                    "episodes_per_s")} for r in recs}
    print(f"[14b] --adv {path.name} (make_domain_shifted_fewrel shift 1.0, 10 relations x 30): "
          f"{ADV_FILE_STEPS} steps through train_main; per 50-step window {out}", flush=True)
    return out


def transformer_trainer(flags: list, name: str):
    args = cli.build_arg_parser(train=True).parse_args(
        TFM_ARGV + flags + ["--save_ckpt", str(SLICE_DIR / name)])
    cfg = cli.config_from_args(args)
    trainer, _ = cli.make_trainer(args, cfg)
    trainer.metric_window = 1
    return trainer, cfg


def transformer_phase(tag: str, flags: list, name: str, vocab, tok) -> tuple[dict, object]:
    """One graph step vs one eager step from the same weights, then
    SLICE_STEPS steps and a val pass as graph replays (the optimizer pair
    once a step, no other hand kernel), then the graph's profile."""
    trainer, cfg = transformer_trainer(flags, name)
    s = EpisodeSampler(cli.load_data(cfg, "train"), tok, cfg.n, cfg.k, cfg.q,
                       batch_size=cfg.batch_size, seed=cfg.seed)
    graph = graph_vs_eager(cfg, vocab, batch_to_model_inputs(s.sample_batch()), tag)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launches, _, recs = run_trainer(trainer, SLICE_STEPS, OPTIM_ON, evals_per_pass(trainer))
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [r["loss"] for r in recs]
    if not np.isfinite(losses).all():
        raise AssertionError(f"{tag}: non-finite losses {losses}")
    prof = profile_graph_steps(trainer, OPTIM_ON, calls=4, tag=f"profile {tag}")
    out = {"graph_vs_eager": graph, "launches": launches, "losses": losses, "peak_gib": peak,
           "tensors": len(list(trainer.model.parameters())),
           "launches_per_step": prof["launches"],
           **{k: prof[k] for k in ("step_ms", "episodes_per_s", "busy_ms", "busy_share")}}
    return out, trainer


def slice_phase(tr: dict, zoo: dict, gen: torch.Generator, card: str) -> dict:
    """Phase 14: 14a the adversarial step, 14b its target file, 14c the MoE
    transformer, 14d the stacked transformer, each through the CLI."""
    t0 = time.monotonic()
    shutil.rmtree(SLICE_DIR, ignore_errors=True)
    SLICE_DIR.mkdir(parents=True)
    out = {"card": card, "a_adv": adv_phase(tr, gen, card)}
    cfg = ExperimentConfig()
    out["b_adv_file"] = adv_file_phase(cfg)
    vocab = make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim)
    tok = GloveTokenizer(vocab, max_length=cfg.max_length)

    moe, trainer = transformer_phase("14c moe", MOE_FLAGS, "moe", vocab, tok)
    layers = [m for m in trainer.model.modules() if isinstance(m, MoeFfn)]
    tc = trainer.cfg
    T = tc.batch_size * tc.n * (tc.k + tc.q) * tc.max_length
    _, S, G, C = moe_geometry(T, tc.moe_experts, tc.moe_top_k, tc.moe_capacity,
                              tc.moe_group_size)
    moe.update(moe_layers=len(layers), tokens=T, groups=G, group_size=S, capacity=C,
               dispatch_bytes=G * S * 8 * C * 4,
               drop_share=[float(m.drop_share) for m in layers])
    print(f"[14c] --moe_experts 8 (ep 1): {len(layers)} MoE layers over {T} tokens a step in "
          f"{G} groups of {S}, capacity {C}; dispatch/combine [{G}, {S}, 8, {C}] f32 "
          f"({moe['dispatch_bytes'] / 1e6:.1f} MB each); share of assignments dropped at "
          f"capacity (last step, per layer) {moe['drop_share']}; peak {moe['peak_gib']:.2f} GiB; "
          f"{moe['step_ms']:.3f} ms/step, busy {moe['busy_ms']:.3f} ms/step "
          f"({moe['busy_share']:.1%}), {moe['launches_per_step']:.1f} launches/step; {card}",
          flush=True)
    close_trainer(trainer)

    stacked, trainer = transformer_phase("14d stacked", ["--tfm_stacked"], "stacked", vocab, tok)
    close_trainer(trainer)
    flat, trainer = transformer_trainer([], "unstacked")
    prof = profile_graph_steps(flat, OPTIM_ON, calls=4, tag="profile 14d unstacked")
    close_trainer(flat)
    stacked["unstacked"] = {k: prof[k] for k in ("step_ms", "busy_ms", "busy_share", "launches")}
    stacked["phase11_proto_transformer_step_ms"] = zoo["proto/transformer"]["step_ms"]
    print(f"[14d] --tfm_stacked (pp 1): {stacked['step_ms']:.3f} ms/step, busy "
          f"{stacked['busy_ms']:.3f}, {stacked['launches_per_step']:.1f} launches/step; the unstacked "
          f"transformer at the same config in this call {prof['step_ms']:.3f} ms/step, busy "
          f"{prof['busy_ms']:.3f}, {prof['launches']:.1f} launches/step; phase 11's "
          f"proto/transformer (2 layers) {stacked['phase11_proto_transformer_step_ms']:.3f} "
          f"ms/step; "
          f"{card}", flush=True)
    out.update(c_moe=moe, d_stacked=stacked)
    shutil.rmtree(SLICE_DIR, ignore_errors=True)
    out["seconds"] = time.monotonic() - t0
    print(f"[slice6c] phase 14 in {out['seconds']:.1f} s (limit {SLICE_SECONDS} s; {card})",
          flush=True)
    if out["seconds"] > SLICE_SECONDS:
        raise AssertionError(f"phase 14 took {out['seconds']:.1f} s > {SLICE_SECONDS} s")
    return out


SERVE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_serve"
SERVE_KERNELS = {"K1": bilstm_infer_cuda, "K2": attn_fwd_cuda}
SERVE_BUCKETS = (1, 2, 4, 8, 16)
SERVE_RELATIONS = 10
SERVE_TIERS = "4,8,16,32,64"
# Resident bf16 / int8 class matrices vs f32 on the same checkpoint and
# queries: max abs logit difference over the f32 logits' scale. Each bar
# lies between two readings that phase 4a takes in every run on the same
# queries: the sound residency's (served by serve_main, and scored eagerly)
# and a planted fault's (PLANTED): int8 with its dequant scale 1 % off,
# bf16 vectors rounded through fp8 e4m3 (3 mantissa bits). The run fails
# unless sound <= bar < fault.
RESIDENT_REL_TOL = {"bf16": 1.5e-3, "int8": 3e-3}
PLANTED = {"bf16": "bf16 vectors rounded through fp8 e4m3", "int8": "int8 scale 1 % high"}
# A graph replay vs the eager scorer on the same weights, matrix and
# queries, f32 residency: the same kernels on the same inputs.
GRAPH_EAGER_TOL = 1e-6
# Phase 4b is a correctness load: bursts of 1-16 requests at this mean gap
# keep traffic in flight through a tier crossing and a publish. Its rate
# is no measurement; the latency and throughput figures come from 4c.
OPEN_LOOP_REQUESTS = 400
OPEN_LOOP_GAP_S = 0.008
# Phase 4c, a capacity sweep of single-query requests (one client thread,
# two tenants). Capacity: served/s with CAPACITY_CLIENTS closed-loop
# clients for CAPACITY_S. Then Poisson arrivals at SWEEP_FRACTIONS of that
# capacity, each held SWEEP_HOLD_S. A bucket's p99 is printed only from
# MIN_P99_N requests up.
CAPACITY_CLIENTS = 64
CAPACITY_S = 2.0
SWEEP_FRACTIONS = (0.3, 0.6, 0.9)
SWEEP_HOLD_S = 2.0
MIN_P99_N = 50


def raw_instance(inst) -> dict:
    """A synthetic instance in the FewRel JSON schema."""
    return {"tokens": list(inst.tokens), "h": [inst.head_name, "Q1", [list(inst.head_pos)]],
            "t": [inst.tail_name, "Q2", [list(inst.tail_pos)]]}


def serve_dataset(cfg):
    return make_synthetic_fewrel(num_relations=SERVE_RELATIONS, instances_per_relation=30,
                                 vocab_size=cfg.vocab_size - 2, sentence_len=(10, 60), seed=5)


def serve_checkpoint(cfg) -> dict:
    """Phase 4a: ``serve_main`` on phase 9's best checkpoint, on the card,
    with a synthetic support file (K supports of each relation) and query
    file (8 held-out instances of each) written to a temp dir, tiers on, at
    resident f32, bf16 and int8, with K1/K2; then at f32 with the plain
    backends. Every verdict must be served (no error, shed or degraded
    verdict, no capture after warmup); labels and f32 logits vs the plain
    backends, bf16 and int8 vs f32."""
    from induction_network_on_fewrel_tpu_torch.serving.cli import serve_main

    ds = serve_dataset(cfg)
    support, queries = SERVE_DIR / "support.json", SERVE_DIR / "queries.jsonl"
    support.write_text(json.dumps({r: [raw_instance(i) for i in ds.instances[r][:cfg.k]]
                                   for r in ds.rel_names}))
    lines = [json.dumps(raw_instance(i)) for r in ds.rel_names
             for i in ds.instances[r][cfg.k:cfg.k + 8]]
    queries.write_text("\n".join(lines) + "\n")
    base = ["--load_ckpt", str(SERVE_DIR / "ckpt"), "--support_file", str(support), "--input",
            str(queries), "--K", str(cfg.k), "--geometry_tiers", SERVE_TIERS]

    def serve(*extra) -> dict:
        out, err = io.StringIO(), io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = serve_main(base + list(extra))
        seconds = time.monotonic() - t0
        verdicts = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
        text = err.getvalue()
        stats = json.loads(text.split("serve stats: ")[1].splitlines()[0])
        warm = re.search(r"warmup: (\d+) query programs \((\d+) CUDA graphs\)", text)
        bad = [v for v in verdicts if "error" in v or "shed" in v or v.get("degraded")]
        if rc != 0 or len(verdicts) != len(lines) or bad or warm is None:
            raise AssertionError(f"serve_main {extra}: rc {rc}, {len(verdicts)} verdicts, "
                                 f"bad {bad[:2]}, stderr {text[-2000:]!r}")
        if (stats["served"], stats["execute_errors"], stats["degraded"], stats["breaker_shed"],
                stats["rejected"], stats["steady_recompiles"]) != (len(lines), 0, 0, 0, 0, 0):
            raise AssertionError(f"serve_main {extra}: stats {stats}")
        logits = np.array([list(v["logits"].values()) for v in verdicts])
        if not np.isfinite(logits).all():
            raise AssertionError(f"serve_main {extra}: non-finite logits")
        return {"verdicts": verdicts, "logits": logits, "stats": stats, "seconds": seconds,
                "programs": int(warm.group(1)), "graphs": int(warm.group(2))}

    torch.cuda.synchronize()
    for fn in SERVE_KERNELS.values():
        fn.launches = 0
    runs = {dt: serve("--resident_dtype", dt) for dt in ("f32", "bf16", "int8")}
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in SERVE_KERNELS.items()}
    if min(launches.values()) == 0:
        raise AssertionError(f"serve_main did not go through both kernels: {launches}")
    ref = serve("--resident_dtype", "f32", "--lstm_backend", "reference", "--attn_backend",
                "reference")
    if {k: fn.launches for k, fn in SERVE_KERNELS.items()} != launches:
        raise AssertionError("the plain-backend serve_main launched a kernel")
    f32, want = runs["f32"]["logits"], ref["logits"]
    scale = float(np.abs(want).max())
    err = float(np.abs(f32 - want).max())
    if err > LOGIT_REL_TOL * scale:
        raise AssertionError(f"serve_main f32 logits vs plain backends: {err} > "
                             f"{LOGIT_REL_TOL}*{scale}")
    clear = [v["margin"] > 2 * LOGIT_REL_TOL * scale for v in ref["verdicts"]]
    flips = [i for i, (a, b) in enumerate(zip(runs["f32"]["verdicts"], ref["verdicts"]))
             if a["label"] != b["label"]]
    if any(clear[i] for i in flips):
        raise AssertionError(f"serve_main labels disagree with the plain backends at {flips}")
    out = {"launches": launches, "f32_vs_plain": err / scale, "label_flips_vs_plain": len(flips),
           "seconds": {dt: round(r["seconds"], 2) for dt, r in runs.items()},
           "graphs": {dt: r["graphs"] for dt, r in runs.items()}}
    print(f"[serve 4a] serve_main on phase 9's checkpoint: {len(lines)} queries over "
          f"{SERVE_RELATIONS} relations (tier 16) at f32/bf16/int8 in {out['seconds']} s, "
          f"graphs {out['graphs']}; wrapper launches (warm-ups, captures, distils) {launches}; "
          f"f32 logits vs plain backends max abs err {err:.3g} at scale {scale:.3g} (rel tol "
          f"{LOGIT_REL_TOL}); label flips {len(flips)} (none where the plain margin clears "
          f"2x the bar)", flush=True)
    eager = resident_readings(cfg, support, lines, f32, scale)
    out["eager"] = eager
    for dt in ("bf16", "int8"):
        d = float(np.abs(runs[dt]["logits"] - f32).max())
        agree = float(np.mean([a["label"] == b["label"] for a, b in
                               zip(runs[dt]["verdicts"], runs["f32"]["verdicts"])]))
        bar = RESIDENT_REL_TOL[dt]
        print(f"[serve 4a] {dt} vs f32: max abs logit diff {d:.3g} ({d / scale:.3g} of scale; "
              f"eager {eager[dt]:.3g}; planted fault, {PLANTED[dt]}: {eager[dt + ' fault']:.3g}; "
              f"bar {bar}); label agreement {agree:.4f}; resident bytes "
              f"{runs[dt]['stats']['resident_bytes']} vs {runs['f32']['stats']['resident_bytes']}",
              flush=True)
        if max(d / scale, eager[dt]) > bar or eager[dt + " fault"] <= bar:
            raise AssertionError(f"{dt} vs f32: sound {d / scale:.3g} (eager {eager[dt]:.3g}) "
                                 f"and planted fault {eager[dt + ' fault']:.3g} do not lie "
                                 f"either side of the bar {bar}")
        out[f"{dt}_vs_f32"], out[f"{dt}_label_agreement"] = d / scale, agree
    return out


def resident_readings(cfg, support: Path, lines: list, served_f32: np.ndarray,
                      scale: float) -> dict:
    """Phase 4a's queries scored eagerly (K1, K2), one at a time, on the f32
    snapshot's class matrix in each resident form, sound and with its
    planted fault (PLANTED): each form's max abs logit difference from the
    eager f32 scoring over ``scale``. The eager f32 logits must equal what
    serve_main served at f32 (``served_f32``) within GRAPH_EAGER_TOL."""
    from induction_network_on_fewrel_tpu_torch.data import load_fewrel_json
    from induction_network_on_fewrel_tpu_torch.serving.buckets import QueryRunner, stack_queries
    from induction_network_on_fewrel_tpu_torch.serving.registry import quantize_int8

    with contextlib.redirect_stderr(io.StringIO()):
        engine = InferenceEngine.from_checkpoint(str(SERVE_DIR / "ckpt"), k=cfg.k,
                                                 geometry_tiers=SERVE_TIERS, start=False)
    try:
        engine.register_dataset(load_fewrel_json(str(support)))
        snap = engine.registry.snapshot()
        stack = snap.matrix.float().cpu()
        q, s = quantize_int8(stack.numpy())
        q = torch.from_numpy(q)
        forms = {"f32": (stack, None), "int8": (q, s), "int8 fault": (q, np.float32(s * 1.01)),
                 "bf16": (stack.bfloat16(), None),
                 "bf16 fault": (stack.to(torch.float8_e4m3fn).bfloat16(), None)}
        runner = QueryRunner(engine.registry.banks[snap.bank])
        queries = [stack_queries([engine._tokenize(json.loads(ln))], 1) for ln in lines]
        cols = list(range(snap.n_classes)) + ([-1] if engine.nota else [])
        logits = {name: np.stack([runner.run(mat, qy, sc)[0][cols] for qy in queries])
                  for name, (mat, sc) in forms.items()}
    finally:
        engine.close()
    graph_err = float(np.abs(logits["f32"] - served_f32).max()) / scale
    if graph_err > GRAPH_EAGER_TOL:
        raise AssertionError(f"eager f32 vs serve_main f32: {graph_err} > {GRAPH_EAGER_TOL}")
    out = {name: float(np.abs(x - logits["f32"]).max()) / scale
           for name, x in logits.items() if name != "f32"}
    out["f32_vs_served"] = graph_err
    return out


def pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q))


def serve_traffic(cfg) -> dict:
    """Phase 4b: ``InferenceEngine.from_checkpoint`` (phase 9's checkpoint)
    under a correctness load through the continuous batcher: bursts of 1-16
    requests at exponential gaps for two tenants of 3 and 6 relations
    (tiers 4 and 8), in four segments; after the first, tenant a grows to 9
    relations (tier 16, whose graphs are captured then, on this thread,
    while the worker replays), after the second new weights are published,
    and traffic keeps arriving until each has committed. Every
    request must be served (nothing shed, dropped or degraded), nothing
    captured after warmup but the crossing's warm-up, and each verdict's
    logits must be the eager scoring of its query on its own snapshot's
    weights and matrix. Then a profiled window (one K1 and one K2 launch per
    executed batch) and each bucket's graph against the eager scorer."""
    from induction_network_on_fewrel_tpu_torch.serving.batcher import Saturated
    from induction_network_on_fewrel_tpu_torch.serving.buckets import QueryRunner, stack_queries

    ds = serve_dataset(cfg)
    with contextlib.redirect_stderr(io.StringIO()):
        engine = InferenceEngine.from_checkpoint(
            str(SERVE_DIR / "ckpt"), k=cfg.k, buckets=SERVE_BUCKETS, max_queue_depth=8192,
            tenant_share=0.75, default_deadline_s=10.0)
    snaps: dict = {}

    def note(*tenants):
        for t in tenants:
            snap = engine.registry.snapshot(t)
            snaps[snap.version] = snap

    engine.register_dataset(ds, max_classes=3, tenant="a")
    engine.register_dataset(ds, max_classes=6, tenant="b")
    note("a", "b")
    made = engine.warmup()
    captures0 = engine.programs.captures
    old_sd = {k: v.clone() for k, v in engine.registry.model.state_dict().items()}
    new_sd = build_model(engine.cfg.replace(seed=1)).state_dict()
    pool = [i for r in ds.rel_names[:9] for i in ds.instances[r][cfg.k:]]
    rng = np.random.default_rng(0)
    # Four segments of open-loop bursts; the second runs on until the
    # crossing registration has committed and the third until the publish
    # has, so traffic is in flight through both and after each.
    per_segment = max(1, OPEN_LOOP_REQUESTS // (4 * 8))
    marks, done = [threading.Event(), threading.Event()], [threading.Event(), threading.Event()]
    reqs, shed, bursts = [], [0], [0]

    def segment(count: int, until=None):
        j = 0
        while j < count or (until is not None and not until.is_set()):
            clock[0] += rng.exponential(OPEN_LOOP_GAP_S)
            delay = clock[0] - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            tenant = "ab"[bursts[0] % 2]
            for _ in range(int(rng.integers(1, 17))):
                inst = pool[int(rng.integers(len(pool)))]
                try:
                    reqs.append((tenant, inst, engine.submit(inst, tenant=tenant)))
                except Saturated:
                    shed[0] += 1
            bursts[0] += 1
            j += 1

    def generate():
        segment(per_segment)
        marks[0].set()
        segment(per_segment, done[0])
        marks[1].set()
        segment(per_segment, done[1])
        segment(per_segment)

    torch.cuda.synchronize()
    for fn in SERVE_KERNELS.values():
        fn.launches = 0
    stats0 = engine.stats.snapshot()
    t0 = time.monotonic()
    clock = [t0]
    gen = threading.Thread(target=generate)
    gen.start()
    marks[0].wait()
    engine.register_dataset(ds, max_classes=9, tenant="a")    # tier 4 -> 16, captured now
    note("a")
    done[0].set()
    marks[1].wait()
    engine.publish_params(new_sd)
    note("a", "b")
    done[1].set()
    gen.join()
    verdicts, errors = [], []
    for tenant, inst, fut in reqs:
        try:
            verdicts.append((inst, fut.result(timeout=60.0)))
        except Exception as e:  # noqa: BLE001 — any failure is a drop
            errors.append(f"{type(e).__name__}: {e}")
    wall = time.monotonic() - t0
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in SERVE_KERNELS.items()}
    stats1 = engine.stats.snapshot()
    crossing = engine.programs.captures - captures0
    served = stats1["served"] - stats0["served"]
    if errors or shed[0] or stats1["degraded"] or stats1["execute_errors"] or \
            served != len(reqs):
        raise AssertionError(f"open loop: {len(errors)} errors {errors[:2]}, {shed[0]} shed, "
                             f"stats {stats1}")
    if stats1["steady_recompiles"] or crossing != len(engine.registry.banks) * len(
            SERVE_BUCKETS) or min(launches.values()) == 0:
        raise AssertionError(f"open loop: steady recompiles {stats1['steady_recompiles']}, "
                             f"crossing captures {crossing}, wrapper launches {launches}")
    pvs = sorted({snaps[v["snapshot_version"]].params_version for _, v in verdicts})
    if pvs != [0, 1]:
        raise AssertionError(f"open loop: verdicts on params versions {pvs}, expected [0, 1]")

    # Each verdict on its own snapshot's weights: eager rescoring (K1, K2).
    refs = {0: build_model(engine.cfg), 1: build_model(engine.cfg)}
    refs[0].load_state_dict(old_sd)
    refs[1].load_state_dict(new_sd)
    worst, apart = 0.0, 0.0
    for inst, v in verdicts:
        snap = snaps[v["snapshot_version"]]
        t = engine.tokenizer(inst)
        query = stack_queries([{k: getattr(t, k) for k in QUERY_DTYPES}], 1)
        n = snap.n_classes
        row = QueryRunner(refs[snap.params_version]).run(snap.matrix, query)[0][:n]
        other = QueryRunner(refs[1 - snap.params_version]).run(snap.matrix, query)[0][:n]
        got = np.array(list(v["logits"].values()))
        sc = float(np.abs(row).max())
        worst = max(worst, float(np.abs(got - row).max()) / sc)
        apart = max(apart, float(np.abs(got - other).max()) / sc)
    if worst > LOGIT_REL_TOL or apart < 10 * LOGIT_REL_TOL:
        raise AssertionError(f"open loop: verdicts vs their snapshots' weights {worst} (tol "
                             f"{LOGIT_REL_TOL}); vs the other weights only {apart}")
    print(f"[serve 4b] correctness load: {len(reqs)} requests in {bursts[0]} bursts of 1-16 "
          f"over {wall:.2f} s, tenants a 3 -> 9 relations (tier 4 -> 16, {crossing} graphs "
          f"captured during traffic) and b 6 (tier 8); warmup made {made} programs ({captures0} "
          f"graphs); publish mid-run; shed {shed[0]}, errors 0, degraded 0, steady recompiles "
          f"0; wrapper launches {launches}; verdicts on params versions {pvs}, each within "
          f"{worst:.3g} of its snapshot's weights (rel tol {LOGIT_REL_TOL}; {apart:.3g} from "
          f"the other weights); batches {stats1['batches'] - stats0['batches']}", flush=True)

    # One K1 and one K2 launch per executed batch, by the profiler (its
    # tracer armed by a warm-up cycle first: a bare window can lose the
    # first batch's kernel records).
    b0 = engine.stats.batches
    with counted_profile() as prof:
        t_prof = time.monotonic()
        futs = []
        for j in range(24):
            futs += [engine.submit(pool[(j * 7 + i) % len(pool)], tenant="ab"[j % 2])
                     for i in range(1 + j % 16)]
            time.sleep(0.002)
        for f in futs:
            f.result(timeout=60.0)
        torch.cuda.synchronize()
        prof_wall_ms = (time.monotonic() - t_prof) * 1e3
    batches = engine.stats.batches - b0
    rows = profile_rows(prof)
    counts = profiled_counts(rows)
    busy_ms = sum(r[1] for r in rows) / 1e3
    want = {k: batches if k in ("K1", "K2") else 0 for k in PROFILED}
    if counts != want:
        raise AssertionError(f"profiled serving window: {counts}, expected {want}")
    print(f"[serve 4b] profiled window: {len(futs)} requests in {batches} batches; launches "
          f"(profiler) K1 {counts['K1']}, K2 {counts['K2']}, no other hand kernel; device busy "
          f"{busy_ms / batches:.3f} ms/batch, {sum(r[2] for r in rows) / batches:.1f} "
          f"launches/batch, {busy_ms / prof_wall_ms:.1%} of the window's wall", flush=True)
    for key, us, n in rows[:8]:
        print(f"[serve 4b]   {us / batches / 1e3:8.4f} ms/batch {n / batches:5.1f}x  {key[:90]}",
              flush=True)
    engine.close()

    # Each bucket's graph vs the eager scorer, f32 residency, same weights.
    snap = engine.registry.snapshot("b")
    graph_err = 0.0
    for b in SERVE_BUCKETS:
        ts = [engine.tokenizer(i) for i in pool[:b]]
        query = stack_queries([{k: getattr(t, k) for k in QUERY_DTYPES} for t in ts], b)
        got = engine.programs.run(snap.bank, snap.matrix, query)
        want_b = QueryRunner(engine.registry.banks[snap.bank]).run(snap.matrix, query)
        graph_err = max(graph_err, float(np.abs(got - want_b).max() / np.abs(want_b).max()))
    if graph_err > GRAPH_EAGER_TOL:
        raise AssertionError(f"graph replay vs eager: {graph_err} > {GRAPH_EAGER_TOL} of scale")
    print(f"[serve 4b] graph replay vs eager QueryRunner, buckets {SERVE_BUCKETS}, f32: max "
          f"abs err {graph_err:.3g} of scale (tol {GRAPH_EAGER_TOL})", flush=True)
    return {"launches": launches, "profiled": {k: counts[k] for k in ("K1", "K2")},
            "profiled_batches": batches, "busy_ms_per_batch": busy_ms / batches,
            "busy_share": busy_ms / prof_wall_ms, "requests": len(reqs), "shed": shed[0],
            "crossing_graphs": crossing, "warmup_programs": made, "warmup_graphs": captures0,
            "pin_err": worst, "graph_vs_eager": graph_err}


def sweep_process() -> dict:
    """Phase 4c in a process of its own (``chip_smoke.py --sweep``), which
    holds only the serving plane, as a serving process does: this one's heap
    holds every earlier phase's objects, and the garbage collector's pauses
    grow with them. Echoes its lines and returns its figures."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--sweep"],
                          capture_output=True, text=True, timeout=300)
    lines = proc.stdout.splitlines()
    for line in lines:
        if line.startswith("[serve 4c]"):
            print(line, flush=True)
    if proc.returncode != 0 or not lines or not lines[-1].startswith("{"):
        raise AssertionError(f"phase 4c: rc {proc.returncode}, stderr {proc.stderr[-3000:]!r}")
    return json.loads(lines[-1])


def sweep_main() -> int:
    """Phase 4c's process: an engine on phase 9's checkpoint with tenants a
    (9 relations, tier 16) and b (6, tier 8), its graphs captured at
    warmup, then ``serve_sweep``; the figures go out as the last line."""
    if not torch.cuda.is_available():
        sys.exit("chip_smoke --sweep: torch.cuda.is_available() is False")
    with contextlib.redirect_stderr(io.StringIO()):
        engine = InferenceEngine.from_checkpoint(
            str(SERVE_DIR / "ckpt"), buckets=SERVE_BUCKETS, max_queue_depth=8192,
            tenant_share=0.75, default_deadline_s=10.0)
    try:
        ds = serve_dataset(engine.cfg)
        engine.register_dataset(ds, max_classes=9, tenant="a")
        engine.register_dataset(ds, max_classes=6, tenant="b")
        engine.warmup()
        k = engine.registry.k
        sweep = serve_sweep(engine, [i for r in ds.rel_names[:9] for i in ds.instances[r][k:]])
    finally:
        engine.close()
    print(json.dumps(sweep), flush=True)
    return 0


def serve_sweep(engine, pool: list) -> dict:
    """Phase 4c: the engine's capacity and its latency below it, on
    single-query requests from one client thread, tenants a and b drawn at
    random. Capacity is served/s with CAPACITY_CLIENTS closed-loop clients;
    then Poisson arrivals at each of SWEEP_FRACTIONS of it for SWEEP_HOLD_S.
    Reports per rate: offered and served/s, the queue depth seen at each
    arrival, shed count, latency p50/p99 overall and per bucket (p99 from
    MIN_P99_N requests up), the host split per batch, the longest gap
    between two completions and the garbage collector's pauses. Any
    execute error, degraded verdict or capture fails the phase."""
    from induction_network_on_fewrel_tpu_torch.serving.batcher import Saturated

    rng = np.random.default_rng(1)
    stats0 = engine.stats.snapshot()
    pauses, gc_t0 = [], [0.0]

    def on_gc(phase: str, info: dict) -> None:
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            pauses.append((info["generation"], time.perf_counter() - gc_t0[0]))

    def pick():
        return pool[int(rng.integers(len(pool)))], "ab"[int(rng.integers(2))]

    def collect(futs: list, t0: float) -> tuple[list, float]:
        """The verdicts, and the seconds from t0 until the last one."""
        verdicts = [f.result(timeout=60.0) for f in futs]
        span = time.monotonic() - t0
        bad = [v for v in verdicts if v.get("degraded")]
        if bad:
            raise AssertionError(f"sweep: {len(bad)} degraded verdicts")
        return verdicts, span

    # Capacity: a closed loop of CAPACITY_CLIENTS outstanding requests.
    slots, futs = threading.Semaphore(CAPACITY_CLIENTS), []
    t0 = time.monotonic()
    while time.monotonic() - t0 < CAPACITY_S:
        slots.acquire()
        inst, tenant = pick()
        fut = engine.submit(inst, tenant=tenant)
        fut.add_done_callback(lambda _: slots.release())
        futs.append(fut)
    _, span = collect(futs, t0)
    capacity = len(futs) / span
    print(f"[serve 4c] capacity: {len(futs)} single-query requests with {CAPACITY_CLIENTS} "
          f"closed-loop clients in {span:.3f} s: {capacity:.1f} served/s", flush=True)

    rates = []
    gc.callbacks.append(on_gc)
    for frac in SWEEP_FRACTIONS:
        rate = frac * capacity
        futs, depth, shed, ends = [], [], 0, []
        pauses.clear()
        engine.host_split.reset()
        b0 = engine.stats.batches
        t0 = clock = time.monotonic()
        while True:
            clock += rng.exponential(1.0 / rate)
            if clock - t0 > SWEEP_HOLD_S:
                break
            delay = clock - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            inst, tenant = pick()
            depth.append(engine.batcher.queue_depth)
            try:
                futs.append(engine.submit(inst, tenant=tenant))
            except Saturated:
                shed += 1
                continue
            futs[-1].add_done_callback(lambda _: ends.append(time.monotonic()))
        verdicts, span = collect(futs, t0)
        by_bucket: dict[int, list] = {}
        for v in verdicts:
            by_bucket.setdefault(v["bucket"], []).append(v["latency_ms"])
        lat = [v["latency_ms"] for v in verdicts]
        row = {
            "fraction": frac, "offered_per_s": (len(futs) + shed) / SWEEP_HOLD_S,
            "served_per_s": len(futs) / span, "requests": len(futs), "shed": shed,
            "queue_depth_p50": pct(depth, 50), "queue_depth_max": int(max(depth)),
            "batches": engine.stats.batches - b0, "p50_ms": pct(lat, 50), "p99_ms": pct(lat, 99),
            "buckets": {b: {"n": len(x), "p50_ms": pct(x, 50),
                            "p99_ms": pct(x, 99) if len(x) >= MIN_P99_N else None}
                        for b, x in sorted(by_bucket.items())},
            "host_split_ms": engine.host_split.ms(),
            "max_completion_gap_ms": 1e3 * float(np.diff(sorted(ends)).max()),
            "gc_pauses": {f"gen{g}": {"n": sum(1 for x, _ in pauses if x == g),
                                      "max_ms": 1e3 * max((t for x, t in pauses if x == g),
                                                          default=0.0)} for g in (0, 1, 2)},
        }
        rates.append(row)
        print(f"[serve 4c] {frac:.0%} of capacity: offered {row['offered_per_s']:.1f}/s, served "
              f"{row['served_per_s']:.1f}/s, {row['requests']} requests in {row['batches']} "
              f"batches, shed {shed}, queue depth p50 {row['queue_depth_p50']:.0f} max "
              f"{row['queue_depth_max']}; latency ms p50 {row['p50_ms']:.3f} p99 "
              f"{row['p99_ms']:.3f}", flush=True)
        for b, r in row["buckets"].items():
            p99 = f"{r['p99_ms']:.3f}" if r["p99_ms"] is not None else f"n < {MIN_P99_N}"
            print(f"[serve 4c]   bucket {b}: {r['n']} requests, p50 {r['p50_ms']:.3f} ms, p99 "
                  f"{p99}", flush=True)
        print(f"[serve 4c]   host ms per batch (tokenize per request): {row['host_split_ms']}; "
              f"longest gap between completions {row['max_completion_gap_ms']:.3f} ms; gc "
              f"pauses {row['gc_pauses']}", flush=True)
    gc.callbacks.remove(on_gc)
    stats1 = engine.stats.snapshot()
    for key in ("execute_errors", "degraded", "breaker_shed", "steady_recompiles"):
        if stats1[key] != stats0[key]:
            raise AssertionError(f"sweep: {key} {stats0[key]} -> {stats1[key]}")
    return {"capacity_per_s": capacity, "capacity_clients": CAPACITY_CLIENTS, "rates": rates}


# --- 15. Observability on the card ------------------------------------------------

OBS_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_obs"
# The flagship at 4 steps a replay; two metric windows of 50 steps, a val
# pass and ring save at steps 50 and 100 (the second ring save is the one
# ckpt.bitflip@1:ring corrupts).
OBS_STEPS = 100
OBS_ARGV = ["--synthetic", "--bf16", "--steps_per_call", "4", "--val_step", "50",
            "--val_iter", "40"]
OBS_TAX_STEPS = 200
OBS_TAX_BUCKETS = (1, 4, 16)
OBS_TAX_BATCHES = 210
OBS_NVTX_SPANS = 20_000
OBS_SECONDS = 90
# The perf tiles of each window sum to its wall time exactly (other = window
# - tracked): the observer's unrounded figures within a float's rounding.
TILE_TOL_S = 1e-9
# Each request's waterfall (queue + pack + execute + respond) against its
# total: the five fields are rounded to 1e-3 ms each (4 x 0.5 + 0.5 us).
WATERFALL_TOL_MS = 2.5e-3


def obs_trainer(extra: list, run: Path):
    """A flagship trainer built by the CLI's wiring (``cli.make_trainer``)
    with ``extra`` flags, its files under ``run``."""
    args = cli.parse_args(True, [*OBS_ARGV, "--save_ckpt", str(run / "ckpt"), "--run_dir",
                                 str(run), *extra])
    return cli.make_trainer(args, cli.config_from_args(args))[0]


def obs_no_saves(trainer) -> None:
    """Close and drop the trainer's checkpoint manager: a timed run then
    holds no save of its own (its end-of-run ring save and wait)."""
    trainer.ckpt.close()
    trainer.ckpt = None


def obs_close(trainer) -> None:
    try:
        trainer.close()
    finally:
        cli.close_telemetry(trainer)


def obs_records(run: Path) -> list[dict]:
    return [json.loads(ln) for ln in (run / "metrics.jsonl").read_text().splitlines()]


def obs_bitwise(a, b, tag: str) -> None:
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import _leaves

    la, lb = _leaves(a), _leaves(b)
    if [p for p, _ in la] != [p for p, _ in lb]:
        raise AssertionError(f"{tag}: the payloads hold other leaves")
    for (p, x), (_, y) in zip(la, lb):
        same = (x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())) \
            if isinstance(x, torch.Tensor) else x == y
        if not same:
            raise AssertionError(f"{tag}: leaf {p} differs")


def obs_train(smi: str) -> dict:
    """15a: the flagship through the CLI's wiring with every telemetry flag,
    then the checks on its run directory."""
    from induction_network_on_fewrel_tpu_torch.tools.obs_report import check_schema
    from induction_network_on_fewrel_tpu_torch.utils.metrics import read_events

    run = OBS_DIR / "train"
    for k in TRAIN_KERNELS.values():
        k.launches = 0
    trainer = obs_trainer(["--train_iter", str(OBS_STEPS), "--watchdog", "--perf",
                           "--tensorboard", str(run / "tb"), "--profile", str(run / "prof"),
                           "--profile_steps", "8", "--chaos", "ckpt.bitflip@1:ring",
                           "--ckpt_stage", "auto"], run)
    tiles = []
    observe = trainer._perf.observe_window

    def observe_window(step):
        rec = observe(step)
        tiles.append(trainer._perf.last_tiles)
        return rec

    trainer._perf.observe_window = observe_window
    stage_root = trainer.ckpt.root
    t0 = time.monotonic()
    try:
        trainer.train(OBS_STEPS)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        watcher = trainer._compile_watcher.snapshot()
    finally:
        obs_close(trainer)
    launches = {k: v.launches for k, v in TRAIN_KERNELS.items()
                if k in ("K7", "K8", "K10", "K11", "wgrad", "optim_sumsq", "optim_update", "K1",
                         "K2")}
    recs = obs_records(run)
    kinds = {r["kind"] for r in recs}
    n_recs, schema_errors = check_schema(run / "metrics.jsonl")
    print(f"[obs train] {OBS_STEPS} flagship steps (4 a replay) with --watchdog --perf "
          f"--tensorboard --profile --chaos ckpt.bitflip@1:ring --ckpt_stage auto in {wall:.2f} s "
          f"(captures, 2 val passes, saves and the profile window included); kinds {sorted(kinds)}; "
          f"schema (tools/obs_report.check_schema): {n_recs} records, {len(schema_errors)} "
          f"errors; wrapper launches (warm-ups and captures) {launches}", flush=True)
    if schema_errors or min(launches.values()) == 0:
        raise AssertionError(f"schema errors {schema_errors} or a kernel of the path never "
                             f"launched: {launches}")
    worst = max(abs(sum(t.values()) - w) for w, t in tiles)
    perf = [r for r in recs if r["kind"] == "perf"]
    print(f"[obs train] {len(tiles)} perf windows: tiles vs window worst {worst:.3g} s (tol "
          f"{TILE_TOL_S}); windows (ms/step: data_wait / host_dispatch / device_sync / "
          f"checkpoint / eval / other): "
          + "; ".join(f"{r['step_ms']:.3f}: {r['data_wait_ms']:.1f}/{r['host_dispatch_ms']:.1f}/"
                      f"{r['device_sync_ms']:.1f}/{r['checkpoint_ms']:.1f}/{r['eval_ms']:.1f}/"
                      f"{r['other_ms']:.1f}" for r in perf)
          + f"; floor {perf[-1]['floor_ms']:.4f} ms/step at the H100's rates; {smi}", flush=True)
    if len(tiles) != 2 or worst > TILE_TOL_S:
        raise AssertionError(f"perf tiles: {len(tiles)} windows, worst {worst}")
    comp = [r for r in recs if r["kind"] == "compile"]
    phases = [(r["fn"], r["phase"], r["trigger"]) for r in comp]
    print(f"[obs train] capture watcher: {phases}; {watcher['steady_recompiles']} steady-state "
          f"captures, {watcher['compile_s_total']:.2f} s of captures", flush=True)
    if watcher["steady_recompiles"] or not any(f == "multi_train_step" and p == "warmup"
                                               for f, p, _ in phases) \
            or not any(f.endswith("eval_step") for f, _, _ in phases):
        raise AssertionError(f"capture records: {phases}, steady {watcher['steady_recompiles']}")
    (tb,) = (run / "tb").iterdir()
    want = [(f"{r['kind']}/{k}", r["step"], np.float32(v)) for r in recs for k, v in r.items()
            if k not in ("step", "kind", "wall_s") and isinstance(v, (int, float))]
    got = [x for x in read_events(tb) if np.isfinite(x[2])]
    if got != want:
        raise AssertionError("the TensorBoard file does not read back as metrics.jsonl")
    events = json.loads((run / "prof" / "trace.json").read_text())["traceEvents"]
    names = [e.get("name", "") for e in events]
    prof_counts = {"train/dispatch": names.count("train/dispatch"),
                   **{k: sum(bool(re.search(PROFILED[k], n)) for n in names)
                      for k in ("K7", "K8")}}
    print(f"[obs train] TensorBoard file: {len(got)} scalars equal to metrics.jsonl's; profile "
          f"trace rows {prof_counts}", flush=True)
    if min(prof_counts.values()) == 0:
        raise AssertionError(f"profile trace: {prof_counts}")
    faults = [(r.get("action"), r.get("point")) for r in recs if r["kind"] == "fault"]
    mngr = CheckpointManager(run / "ckpt", None, logger=MetricsLogger(run / "restore", quiet=True))
    cfg = CheckpointManager.load_config(run / "ckpt")
    model = build_model(cfg)
    step, _ = mngr.restore_latest(model)
    best = torch.load(run / "ckpt" / "best.pt", map_location="cpu", weights_only=True)
    obs_bitwise(model.state_dict(), best["params"], "restore_latest after ckpt.bitflip")
    quarantined = [(r["action"], r["ckpt_kind"]) for r in obs_records(run / "restore")
                   if r["kind"] == "fault"]
    print(f"[obs train] chaos: {faults}; restore_latest quarantined {quarantined} and landed on "
          f"the best save (step {step}) bitwise; staging root {stage_root} removed: "
          f"{not stage_root.exists() or stage_root == run / 'ckpt'}", flush=True)
    if faults != [("inject", "ckpt.bitflip")] or quarantined != [("ckpt_quarantine", "latest")] \
            or step != best["step"]:
        raise AssertionError(f"ckpt.bitflip drill: {faults}, {quarantined}, step {step}")
    steady = [r["step_ms"] for r in perf]
    return {"seconds": wall, "launches": launches, "perf_windows": perf, "tiles_worst_s": worst,
            "captures": phases, "steady_recompiles": watcher["steady_recompiles"],
            "profile_rows": prof_counts, "tb_scalars": len(got), "faults": faults,
            "quarantined": quarantined, "restored_step": step, "window_step_ms": steady}


def obs_async_save() -> dict:
    """15b: a saver-thread save at step s while replays go on, against a
    synchronous save at s, bitwise; then the ms/step of a window of 8 calls
    holding a save, staging on and off (and without a save)."""
    run = OBS_DIR / "save"
    trainer = obs_trainer(["--train_iter", "8", "--val_step", "100000"], run)
    obs_no_saves(trainer)
    out = {}
    try:
        trainer.train(8)
        cfg, s = trainer.cfg, 8
        sync = CheckpointManager(run / "sync", cfg)
        sync.save_latest(s, trainer.model, trainer.opt, samplers=trainer.sampler_states())
        sync.wait()                             # the synchronous reference
        saver = CheckpointManager(run / "async", cfg, stage="auto")
        saver.save_latest(s, trainer.model, trainer.opt, samplers=trainer.sampler_states())
        trainer.train(16, start_step=s)         # replays overwrite the graph's static state
        saver.wait()
        staged = saver.root != saver.dir
        saver.close()
        obs_bitwise(torch.load(run / "async" / "latest.pt", weights_only=True),
                    torch.load(run / "sync" / "latest.pt", weights_only=True), "async save")
        print(f"[obs save] a saver-thread save at step {s} (staged in /dev/shm: {staged}) with "
              f"16 steps replayed behind it restores bitwise equal to a synchronous save at "
              f"step {s}", flush=True)
        step = 24
        for label, stage in (("none", None), ("stage off", "off"), ("stage auto", "auto"),
                             ("stage auto", "auto"), ("stage off", "off"), ("none", None)):
            mngr = CheckpointManager(run / f"w{step}", cfg, stage=stage or "off")
            torch.cuda.synchronize()
            t0 = time.monotonic()
            trainer.train(16, start_step=step)
            if stage is not None:
                mngr.save_latest(step + 16, trainer.model, trainer.opt)
            trainer.train(16, start_step=step + 16)
            torch.cuda.synchronize()
            ms = (time.monotonic() - t0) * 1e3 / 32
            mngr.close()
            out.setdefault(label, []).append(ms)
            step += 32
        print(f"[obs save] ms/step of a window of 8 replays (32 steps) holding a ring save "
              f"(unprofiled, host clock, synced): " + "; ".join(
                  f"{k} {', '.join(f'{v:.3f}' for v in vs)}" for k, vs in out.items()), flush=True)
    finally:
        obs_close(trainer)
    return {"window_ms_per_step": out, "staged": staged}


def obs_nan_and_debug() -> dict:
    """15c: ``--nan_inject_step`` trips the watchdog and the recorder dumps;
    15d: ``--debug_nans`` on a weight poisoned after step 8 raises at the
    call that holds step 9."""
    run = OBS_DIR / "nan"
    trainer = obs_trainer(["--train_iter", "52", "--val_step", "1000", "--watchdog",
                           "--nan_inject_step", "10"], run)
    try:
        trainer.train(52)
    finally:
        obs_close(trainer)
    dump = json.loads((run / "flight_recorder.json").read_text())
    health = [(r["event"], r["severity"]) for r in obs_records(run) if r["kind"] == "health"]
    print(f"[obs nan] --nan_inject_step 10: health {health}; flight recorder dumped "
          f"({dump['reason'][:60]}...), {len(dump['spans'])} spans", flush=True)
    if ("non_finite", "critical") not in health or not dump["reason"].startswith("watchdog"):
        raise AssertionError(f"nan injection: {health}, {dump['reason']}")
    trainer = obs_trainer(["--train_iter", "16", "--val_step", "1000", "--debug_nans"],
                          OBS_DIR / "debug")
    try:
        trainer.train(8)
        with torch.no_grad():
            trainer.model.encoder.w_hh.view(-1)[0] = float("nan")
        try:
            trainer.train(8, start_step=8)
        except FloatingPointError as e:
            raised = str(e)
        else:
            raise AssertionError("--debug_nans: a poisoned weight did not raise")
    finally:
        obs_close(trainer)
    print(f"[obs debug_nans] {raised}", flush=True)
    if "at step 9 " not in raised:
        raise AssertionError(f"--debug_nans named another step: {raised}")
    return {"nan_health": health, "dump_reason": dump["reason"], "debug_nans": raised}


def obs_drift_drill(engine, drift, pool: list) -> dict:
    """The JAX drift drill (``load/drift.drill_engine``) on the default
    tenant: the best class logit of an out-of-vocabulary sentence (a point
    mass) against the in-domain pool's; an open-set floor between the point
    mass and the pool's larger side (setting it re-arms the detector); a
    baseline on that clean side (NOTA rate exactly 0, or 1); then the point
    mass (exactly 1, or 0): a once-latched CRITICAL; a publish re-arms the
    detector and clean traffic re-baselines."""
    from induction_network_on_fewrel_tpu_torch.load.drift import drill_engine
    from induction_network_on_fewrel_tpu_torch.serving.registry import DEFAULT_TENANT

    start = len(drift.events)
    d = drill_engine(engine, drift, pool, DEFAULT_TENANT)
    return {"clean": d["clean_pool"], "pool": len(pool), "floor": d["calibration"]["threshold"],
            "events": [(e.severity, e.data.get("feature")) for e in list(drift.events)[start:]],
            "tripped": d["tripped"], "once_latched": d["once_latched"],
            "rearmed_on_publish": d.get("rearmed_on_publish"),
            "clean_after_publish": d.get("clean_after_publish")}


def obs_serve(ckpt: Path, smi: str) -> dict:
    """15e: ``serve_main`` on 15a's checkpoint with the telemetry flags and
    a chaos plan, then an engine on the same checkpoint for the publish
    rollback, the drift drill and the shed tenant's SLO."""
    from induction_network_on_fewrel_tpu_torch.obs import (
        ChaosRegistry,
        DriftDetector,
        SLOEngine,
        SLOObjective,
    )
    from induction_network_on_fewrel_tpu_torch.obs.chaos import install
    from induction_network_on_fewrel_tpu_torch.serving.batcher import Saturated
    from induction_network_on_fewrel_tpu_torch.serving.cli import serve_main
    from induction_network_on_fewrel_tpu_torch.serving.registry import PublishError

    run = OBS_DIR / "serve"
    bilstm_infer_cuda.launches = attn_fwd_cuda.launches = 0
    rc = serve_main(["--load_ckpt", str(ckpt), "--run_dir", str(run), "--demo_queries", "64",
                     "--watchdog", "--trace_sample", "1.0", "--slo_latency_ms", "1000",
                     "--drift", "--drift_window", "16", "--drift_baseline", "8",
                     "--chaos", "serve.execute_raise@2,publish.nan_params@0"])
    torch.cuda.synchronize()
    launches = {"K1": bilstm_infer_cuda.launches, "K2": attn_fwd_cuda.launches}
    recs = obs_records(run)
    traces = [r for r in recs if r["kind"] == "trace" and "total_ms" in r]
    worst = max(abs(sum(r[s] for s in ("queue_ms", "pack_ms", "execute_ms", "respond_ms"))
                    - r["total_ms"]) for r in traces)
    faults = [(r["action"], r.get("point")) for r in recs if r["kind"] == "fault"]
    serve = [r for r in recs if r["kind"] == "serve" and "tenant" not in r and "event" not in r]
    prom = (run / "metrics.prom").read_text()
    print(f"[obs serve] serve_main --watchdog --trace_sample 1.0 --slo_latency_ms 1000 --drift "
          f"--chaos serve.execute_raise@2,publish.nan_params@0: rc {rc}; {len(traces)} request "
          f"waterfalls, worst |segments - total| {worst:.4f} ms (tol {WATERFALL_TOL_MS}); faults "
          f"{faults}; served {serve[-1]['served']:.0f}, steady captures "
          f"{serve[-1]['steady_recompiles']:.0f}; metrics.prom {len(prom.splitlines())} lines; "
          f"wrapper launches (distil, warm-ups, captures) {launches}", flush=True)
    if rc or worst > WATERFALL_TOL_MS or ("execute_error", None) not in faults \
            or ("inject", "serve.execute_raise") not in faults or min(launches.values()) == 0 \
            or serve[-1]["steady_recompiles"] or "induction_serve_latency_ms_bucket" not in prom:
        raise AssertionError(f"serve_main telemetry: rc {rc}, {faults}, {launches}")

    drift = DriftDetector(window=32, baseline_n=24, min_count=16, eval_interval_s=0.0)
    engine = InferenceEngine.from_checkpoint(
        str(ckpt), drift=drift, logger=MetricsLogger(OBS_DIR / "engine", quiet=True))
    ds = serve_dataset(engine.cfg)
    install(ChaosRegistry.parse("publish.nan_params@0", logger=engine._logger))
    try:
        names = engine.register_dataset(ds, max_classes=5)
        engine.warmup()
        before = engine.registry.snapshot()
        try:
            engine.publish_checkpoint(str(ckpt))
        except PublishError as e:
            refused = str(e)
        else:
            raise AssertionError("publish.nan_params: the poisoned publish was not refused")
        rolled_back = engine.registry.snapshot() is before and engine.registry.params_version == 0
        inst = [i for r in names for i in ds.instances[r][engine.registry.k:]]
        drill = obs_drift_drill(engine, drift, inst)
        steady = engine.stats.steady_compiles
    finally:
        install(None)
        engine.close()
    print(f"[obs serve] publish.nan_params: refused ({refused[:70]}...), every tenant on its "
          f"old snapshot: {rolled_back}; drift drill (the JAX drill: an open-set floor between "
          f"an out-of-vocabulary point mass and the in-domain pool, a baseline on the clean "
          f"pool, then the point mass): {drill}; steady captures {steady}", flush=True)
    if not rolled_back or not drill["tripped"] or not drill["once_latched"] or steady \
            or not drill["rearmed_on_publish"] or not drill["clean_after_publish"]:
        raise AssertionError(f"publish rollback {rolled_back}, drift {drill}")

    slo = SLOEngine(SLOObjective(availability=0.99), fast_window_s=60.0)
    cfg = engine.cfg
    shed_engine = InferenceEngine(engine.model, cfg, engine.tokenizer, start=False, slo=slo,
                                  max_queue_depth=8, tenant_share=0.25)
    shed = 0
    try:
        for tenant in ("hog", "other"):
            shed_engine.register_dataset(ds, max_classes=5, tenant=tenant)
        shed_engine.submit(inst[0], tenant="other")
        for q in inst * 2:
            try:
                shed_engine.submit(q, tenant="hog")
            except Saturated:
                shed += 1
        while shed_engine.batcher.queue_depth:
            shed_engine.batcher.drain_once(block_s=0.01)
    finally:
        shed_engine.close()
    slo_events = [(e.event, e.severity, e.data.get("tenant")) for e in slo.events]
    print(f"[obs serve] a tenant over its share ({shed} of {2 * len(inst)} submits shed): SLO "
          f"events {slo_events}", flush=True)
    if ("slo_fast_burn", "critical", "hog") not in slo_events:
        raise AssertionError(f"the shed tenant's SLO did not trip: {slo_events}")
    return {"launches": launches, "waterfalls": len(traces), "waterfall_worst_ms": worst,
            "faults": faults, "publish_refused": refused, "drift": drill,
            "slo": slo_events, "shed": shed}


def obs_tax(smi: str) -> dict:
    """15f: the flagship's unprofiled ms/step with --watchdog --perf against
    without (in turns: off, on, on, off); per bucket, serve/execute's p50
    (and the submits', the drain's and the request latency's) at
    trace_sample 1.0 against 0; the NVTX cost per span."""
    from induction_network_on_fewrel_tpu_torch.obs import SpanTracker, get_tracker, set_tracker

    # A long-running process's span ring is full: fill it, so the perf
    # observer's window reads meet the ring it meets in production.
    ring = get_tracker()
    for _ in range(ring.capacity):
        with ring.span("obs/fill", nvtx=False):
            pass
    train = {}
    for label in ("off", "on", "on", "off"):
        extra = ["--watchdog", "--perf"] if label == "on" else []
        trainer = obs_trainer(["--train_iter", str(OBS_TAX_STEPS + 8), "--val_step", "100000",
                               *extra], OBS_DIR / f"tax_{len(train.get(label, []))}_{label}")
        obs_no_saves(trainer)
        try:
            trainer.train(8)                       # the capture
            torch.cuda.synchronize()
            t0 = time.monotonic()
            trainer.train(OBS_TAX_STEPS, start_step=8)
            torch.cuda.synchronize()
            train.setdefault(label, []).append((time.monotonic() - t0) * 1e3 / OBS_TAX_STEPS)
        finally:
            obs_close(trainer)
    on, off = np.median(train["on"]), np.median(train["off"])
    print(f"[obs tax] flagship ms/step (unprofiled, {OBS_TAX_STEPS} steps, host clock, synced) "
          f"with --watchdog --perf {train['on']} vs without {train['off']}: "
          f"{(on - off) / off:+.2%} (the JAX gate: < 2 %); {smi}", flush=True)
    # The perf observer's window read against the JAX observer's whole-ring
    # scan, on the full ring, for the last 50 steps' window.
    from induction_network_on_fewrel_tpu_torch.obs import PerfObserver
    from induction_network_on_fewrel_tpu_torch.obs.perf import SEGMENT_OF

    observer = PerfObserver(tracker=ring)
    observer._thread = threading.current_thread().name
    ends = sorted(sp.start_s + sp.dur_s for sp in ring._ring
                  if sp.name == "train/dispatch" and sp.thread == observer._thread)
    w0, w1 = ends[-13], ends[-1]                # 12 replays of 4 steps

    def whole_ring(w0: float, w1: float) -> dict:
        sums: dict = {}
        with ring._lock:
            spans = list(ring._ring)
        for sp in spans:
            if sp.depth == 0 and sp.thread == observer._thread and sp.name in SEGMENT_OF:
                lo, hi = max(sp.start_s, w0), min(sp.start_s + sp.dur_s, w1)
                if hi > lo:
                    sums[SEGMENT_OF[sp.name]] = sums.get(SEGMENT_OF[sp.name], 0.0) + hi - lo
        return sums

    scan = {}
    for label, fn in (("window", observer._segment_sums), ("whole ring", whole_ring)) * 2:
        t0 = time.perf_counter()
        for _ in range(20):
            got = fn(w0, w1)
        scan.setdefault(label, []).append((time.perf_counter() - t0) / 20 * 1e3)
        scan.setdefault(label + " sums", {k: v for k, v in got.items() if v})
    observer.close()
    a, b = scan["window sums"], scan["whole ring sums"]
    same = a.keys() == b.keys() and all(abs(a[k] - b[k]) <= 1e-12 for k in a)
    print(f"[obs tax] the perf observer's window read on a full ring of {len(ring)} spans: "
          f"{scan['window']} ms against a whole-ring scan's {scan['whole ring']} ms, the same "
          f"tiles {a}; {smi}", flush=True)
    if not same:
        raise AssertionError(f"perf window read {a} != whole-ring scan {b}")

    cfg = CheckpointManager.load_config(OBS_DIR / "train" / "ckpt")
    model = build_model(cfg)
    CheckpointManager(OBS_DIR / "train" / "ckpt").restore_best(model)
    vocab = make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim)
    tok = GloveTokenizer(vocab, max_length=cfg.max_length)
    ds = serve_dataset(cfg)
    pool = [raw_instance(i) for r in ds.rel_names[:5] for i in ds.instances[r][cfg.k:]]
    # Two engines on the same weights, at trace_sample 0 and 1.0, take the
    # same batches in alternation (which goes first alternates too): a
    # batch's submits (tokenization, and at 1.0 the serve/submit span and
    # the trace context), its serve/execute span, and its drain (execute,
    # verdicts, and at 1.0 the trace records).
    tracker = SpanTracker(capacity=1 << 17)
    prev = set_tracker(tracker)
    engines = {rate: InferenceEngine(model, cfg, tok, start=False, trace_sample=rate,
                                     buckets=(1, 2, 4, 8, 16), max_queue_depth=64)
               for rate in (0.0, 1.0)}
    cols: dict = {}
    try:
        for eng in engines.values():
            eng.register_dataset(ds, max_classes=5)
            eng.warmup()
        for bucket in OBS_TAX_BUCKETS:
            for i in range(OBS_TAX_BATCHES):
                qs = [pool[(i * bucket + j) % len(pool)] for j in range(bucket)]
                for rate in ((0.0, 1.0) if i % 2 else (1.0, 0.0)):
                    eng = engines[rate]
                    t0 = time.perf_counter()
                    futs = [eng.submit(q, deadline_s=60.0) for q in qs]
                    t1 = time.perf_counter()
                    eng.batcher.drain_once(block_s=0.01)
                    t2 = time.perf_counter()
                    lat = [f.result()["latency_ms"] for f in futs]
                    if i >= 10:                         # past each key's first replays
                        c = cols.setdefault((rate, bucket), {"submit_us": [], "drain_ms": [],
                                                             "latency_ms": []})
                        c["submit_us"].append((t1 - t0) * 1e6 / bucket)
                        c["drain_ms"].append((t2 - t1) * 1e3)
                        c["latency_ms"].extend(lat)
    finally:
        for eng in engines.values():
            eng.close()
        set_tracker(prev)
    for sp in tracker.snapshot():
        if sp["name"] == "serve/execute":
            rate = 1.0 if sp.get("links") else 0.0
            cols[rate, sp["attrs"]["bucket"]].setdefault("execute_ms", []).append(
                sp["dur_s"] * 1e3)
    rows = {}
    for bucket in OBS_TAX_BUCKETS:
        rows[bucket] = {}
        for key in ("execute_ms", "submit_us", "drain_ms", "latency_ms"):
            p0 = float(np.percentile(cols[0.0, bucket][key], 50))
            p1 = float(np.percentile(cols[1.0, bucket][key], 50))
            rows[bucket][key] = {"rate0": p0, "rate1": p1, "tax": (p1 - p0) / p0}
    print(f"[obs tax] p50 at trace_sample 0 vs 1.0, {OBS_TAX_BATCHES - 10} batches a bucket in "
          f"alternation (serve/execute ms; submit us per request; drain ms per batch; request "
          f"latency ms): " + "; ".join(
              f"bucket {b}: " + ", ".join(f"{k} {v['rate0']:.4f} vs {v['rate1']:.4f} "
                                          f"({v['tax']:+.2%})" for k, v in r.items())
              for b, r in rows.items())
          + f" (the JAX gate: < 2 % of p50 exec); {smi}", flush=True)

    def per_span(tracker) -> float:
        t0 = time.perf_counter()
        for _ in range(OBS_NVTX_SPANS):
            with tracker.span("obs/bench"):
                pass
        return (time.perf_counter() - t0) / OBS_NVTX_SPANS * 1e6

    plain, nvtx = SpanTracker(capacity=1024), SpanTracker(capacity=1024, device="cuda")
    costs = {"plain": [], "nvtx": []}
    for _ in range(2):
        costs["plain"].append(per_span(plain))
        costs["nvtx"].append(per_span(nvtx))
    span_us = float(np.median(costs["plain"]))
    nvtx_us = float(np.median(costs["nvtx"])) - span_us
    print(f"[obs tax] a span costs {span_us:.2f} us on the host; its NVTX range adds "
          f"{nvtx_us:.2f} us ({costs}); {smi}", flush=True)
    return {"train_ms_per_step": train, "train_tax": (on - off) / off, "serve": rows,
            "perf_read_ms": {k: scan[k] for k in ("window", "whole ring")},
            "span_us": span_us, "nvtx_us_per_span": nvtx_us}


def obs_phase(smi: str) -> dict:
    """Phase 15: the observability slice on the card."""
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    t0 = time.monotonic()
    out = {"card": smi, "a_train": obs_train(smi), "b_async_save": obs_async_save(),
           "cd_nan_debug": obs_nan_and_debug()}
    out["e_serve"] = obs_serve(OBS_DIR / "train" / "ckpt", smi)
    out["f_tax"] = obs_tax(smi)
    out["seconds"] = time.monotonic() - t0
    print(f"[obs] phase 15: {out['seconds']:.1f} s (aim: {OBS_SECONDS} s)", flush=True)
    out["report_runs"] = keep_runs(OBS_DIR, "obs15")
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    return out


# --- phase 16: the serving control plane and the adaptation controller ------

FLEET_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_fleet"
FLEET_DEVICE = None                     # the card
FLEET_SEED = 1
# The JAX drill world (tools/loadgen.py:1327 ADAPT_WORLD: ce, no decay,
# NOTA queries at rate 1, seed 1) at the flagship widths. With N + 1 = 6
# relations a 5-way episode's NOTA queries always come from the one
# relation left, and the source model meets the shifted twin with 12-50 %
# NOTA (measured on the H100); with 15 relations and lr 2e-3 (the
# JAX world's 5e-3 gives 14-42 % at every count tried) NOTA generalizes
# and the shifted traffic collapses into it, as in the JAX drill.
FLEET_KNOBS = dict(na_rate=1, loss="ce", lr=2e-3, weight_decay=0.0, val_step=0, seed=FLEET_SEED)
# The fine-tune takes 300 steps: at 200 (the default budget) the adapted
# model answered 0-2 of the 24 post-publish target queries with NOTA (0.0,
# 0.042, 0.0, 0.0, 0.083 in five runs on the H100), and 2 of 24 is outside
# the JAX gate's 0.05 band around the healthy rate.
FLEET_PLAN = dict(num_relations=15, instances_per_relation=40, train_iters=300,
                  finetune_steps=300, canary_episodes=48,
                  drift=dict(window=32, baseline_n=24, min_count=16))
FLEET_REPLICAS = 3
FLEET_BUCKETS = (1, 4, 16)
FLEET_CLIENTS = 8
FLEET_LOAD_S = 2.0
FLEET_SECONDS = 90
ADAPT_KERNELS = ("K7", "K8", "wgrad", "K10", "K11", "optim_sumsq", "optim_update")
# The serving graphs' capture name, and the fine-tune's and canary's.
SERVE_CAPTURE = "serve_query"
JOB_CAPTURES = ("train_step", "multi_train_step", "eval_step", "multi_eval_step")
FLEET_MEM_TOL = 1 << 20                 # bytes of device memory across attempts
SOCKET_LOGIT_TOL = 1e-6
FLEET_RETRIES = 2


def kernel_counts() -> dict:
    return {k: f.launches for k, f in TRAIN_KERNELS.items()}


def zero_kernel_counts() -> None:
    for f in TRAIN_KERNELS.values():
        f.launches = 0


def count_delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


class ClosedLoad:
    """FLEET_CLIENTS closed-loop clients on one tenant through the fleet
    router: per-bucket latencies, completion times, sheds and errors."""

    def __init__(self, router, pool: list, tenant: str):
        self.router, self.pool, self.tenant = router, pool, tenant
        self.lat: dict[int, list[float]] = {}
        self.done_at: list[float] = []
        self.served = self.shed = self.errors = self.degraded = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    def _client(self, i: int) -> None:
        from induction_network_on_fewrel_tpu_torch.serving.batcher import Saturated

        # A seeded random draw over the whole pool: the tenant's drift
        # baseline and windows see the same mix of relations.
        rng = np.random.default_rng(FLEET_SEED + i)
        while not self._stop.is_set():
            inst = self.pool[int(rng.integers(len(self.pool)))]
            try:
                v = self.router.classify(inst, 30.0, tenant=self.tenant)
            except Saturated:
                with self._lock:
                    self.shed += 1
                continue
            except Exception:  # noqa: BLE001 — counted: any failure is an error
                with self._lock:
                    self.errors += 1
                continue
            with self._lock:
                self.served += 1
                self.done_at.append(time.monotonic())
                self.degraded += bool(v.get("degraded"))
                self.lat.setdefault(int(v.get("bucket", 0)), []).append(v["latency_ms"])

    def __enter__(self) -> "ClosedLoad":
        self._threads = [threading.Thread(target=self._client, args=(i,), daemon=True)
                         for i in range(FLEET_CLIENTS)]
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=60.0)

    def summary(self) -> dict:
        rows = {b: {"n": len(v), "p50_ms": round(float(np.percentile(v, 50)), 3),
                    **({"p99_ms": round(float(np.percentile(v, 99)), 3)} if len(v) >= 50 else {})}
                for b, v in sorted(self.lat.items())}
        return {"served": self.served, "shed": self.shed, "errors": self.errors,
                "degraded": self.degraded, "by_bucket": rows}


def stamped_watcher():
    """A capture watcher that keeps each capture's (fn, start, end) on the
    monotonic clock."""
    from induction_network_on_fewrel_tpu_torch.obs.compile import CompileWatcher

    class Stamped(CompileWatcher):
        def __init__(self):
            super().__init__()
            self.stamps: list[tuple[str, float, float]] = []

        def _observe_compile(self, pending, duration):
            end = time.monotonic()
            self.stamps.append(((pending or ("?",))[0], end - duration, end))
            super()._observe_compile(pending, duration)

    return Stamped().install()


def fleet_cfg() -> ExperimentConfig:
    return ExperimentConfig(**FLEET_KNOBS)


def train_ms_per_step(records: list, batch_size: int) -> float:
    """The fine-tune's ms/step over its metric windows after the first
    (the first holds the graph's warm-up and capture)."""
    eps = [r["episodes_per_s"] for r in records if r.get("kind") == "train"][1:]
    if not eps:
        raise AssertionError("the fine-tune logged fewer than two metric windows")
    return round(float(np.mean([batch_size * 1e3 / e for e in eps])), 4)


def fleet_headline(cfg, tok, src, tgt, ckpt: str) -> dict:
    """The live artifact's own pre-drift accuracy on both corpora (the
    canary's legs), and its floors: accuracy minus the JAX tier-1 band."""
    from induction_network_on_fewrel_tpu_torch.obs.canary import floors_from_headline, run_canary
    from induction_network_on_fewrel_tpu_torch.serving.registry import load_params

    verdict = run_canary(build_model(cfg, device=FLEET_DEVICE), load_params(ckpt), cfg, tok,
                         {"in_domain": src, "target": tgt}, {},
                         episodes=FLEET_PLAN["canary_episodes"], seed=cfg.seed + 7)
    acc = {k: v["accuracy"] for k, v in verdict["legs"].items()}
    band = floors_from_headline({"in_domain_accuracy": acc["in_domain"],
                                 "cross_domain_accuracy": acc["target"]})
    floors = {"in_domain": band["in_domain_accuracy"], "target": band["cross_domain_accuracy"]}
    print(f"[fleet] the live artifact before the drift: canary accuracy {acc}; floors "
          f"(accuracy - 0.12, the JAX band) {floors}", flush=True)
    gc.collect()
    return {"accuracy": acc, "floors": floors}


def fleet_alone(cfg, tok, src, tgt, ckpt: str) -> float:
    """The fine-tune with no serving beside it: its ms/step."""
    from induction_network_on_fewrel_tpu_torch.train.finetune import mixture_finetune

    run = FLEET_DIR / "alone"
    logger = MetricsLogger(run, quiet=True)
    mixture_finetune(ckpt, str(FLEET_DIR / "alone_ckpt"), src, tgt, tok,
                     steps=FLEET_PLAN["finetune_steps"], wall_budget_s=300.0,
                     seed=cfg.seed + 100, logger=logger, device=FLEET_DEVICE)
    logger.close()
    shutil.rmtree(FLEET_DIR / "alone_ckpt", ignore_errors=True)
    ms = train_ms_per_step(obs_records(run), cfg.batch_size)
    print(f"[fleet] the fine-tune alone ({FLEET_PLAN['finetune_steps']} steps, 4 chunks): "
          f"{ms} ms/step", flush=True)
    return ms


def fleet_success(cfg, tok, src, tgt, ckpt: str, plan: dict) -> dict:
    """16a: three replicas behind the router and the fan-out, the drift
    CRITICAL, the fine-tune with traffic in flight, the canary, the
    publish, the verification; the candidate's served logits vs the plain
    backends on its weights."""
    from induction_network_on_fewrel_tpu_torch.obs.adapt_drill import (
        TENANT,
        adapt_pools,
        run_adapt_success_arm,
    )
    from induction_network_on_fewrel_tpu_torch.serving.registry import load_params

    src_pool, tgt_pool = adapt_pools(src, tgt, cfg.k)
    state: dict = {}
    post: list = []

    def after_warmup(router, control):
        control.register_tenant("live", src)
        router.replicas[router.directory["live"].owner].warmup()
        torch.cuda.synchronize()
        state["fleet_counts"] = kernel_counts()
        state["warm_captures"] = len(watcher.stamps)     # serving graphs end here
        with ClosedLoad(router, src_pool, "live") as load:
            time.sleep(FLEET_LOAD_S)
        state["pre"] = load.summary()

    @contextlib.contextmanager
    def during_attempt(router, pools):
        torch.cuda.synchronize()
        before = kernel_counts()
        load = ClosedLoad(router, src_pool, "live")
        with load:
            yield
        torch.cuda.synchronize()
        state["adapt_counts"] = count_delta(kernel_counts(), before)
        state["during"] = load.summary()
        state["during_done_at"] = list(load.done_at)

    def on_verdict(stage, v):
        if stage == "post":
            post.append(v)

    run = FLEET_DIR / "success"
    logger = MetricsLogger(run, quiet=True)
    watcher = stamped_watcher()
    zero_kernel_counts()
    try:
        out = run_adapt_success_arm(cfg, tok, src, tgt, ckpt, str(FLEET_DIR), plan=plan,
                                    replicas=FLEET_REPLICAS, device=FLEET_DEVICE, logger=logger,
                                    on_verdict=on_verdict, during_attempt=during_attempt,
                                    after_warmup=after_warmup, buckets=FLEET_BUCKETS,
                                    watch=(TENANT,))
    finally:
        watcher.uninstall()
        logger.close()
    captures = [(fn, t0, t1) for fn, t0, t1 in watcher.stamps]
    train_caps = [c for c in captures if c[0] == "train_step"]
    serve_steady = [c for c in captures[state.get("warm_captures", 0):] if c[0] == SERVE_CAPTURE]
    job = [c[0] for c in captures if c[0] in JOB_CAPTURES]
    in_capture = sum(1 for t in state.get("during_done_at", ()) for _, a, b in train_caps
                     if a <= t <= b)
    ms_during = train_ms_per_step([r for r in obs_records(run)], cfg.batch_size)
    fields = {k: out.get(k) for k in (
        "baseline_armed", "tripped", "nota_healthy", "nota_shifted", "trigger_feature",
        "canary_passed", "canary_first_failure", "published", "versions_uniform",
        "dropped_during_publish", "inflight_at_publish", "steady_recompiles", "rearmed",
        "verified", "nota_post", "nota_band", "finetune_s", "publish_s", "fanout_publish_ms",
        "trigger_to_verified_s", "recover_s", "params_versions_after", "state_after_publish")}
    print(f"[fleet 16a] the controller's kind=\"adapt\" records: {out.get('records')}", flush=True)
    print(f"[fleet 16a] {FLEET_REPLICAS} replicas behind the router and the fan-out: {fields}",
          flush=True)
    print(f"[fleet 16a] served before the drift ({FLEET_CLIENTS} clients, {FLEET_LOAD_S} s): "
          f"{state.get('pre')}; during the attempt (fine-tune, canary, publish): "
          f"{state.get('during')}; completions inside the train-graph capture: {in_capture}",
          flush=True)
    print(f"[fleet 16a] wrapper launches, serving set-up (distils, warm-ups, captures): "
          f"{state.get('fleet_counts')}; the attempt (the fine-tune's warm-up and capture, the "
          f"canary's eval graphs, the publish's distils): {state.get('adapt_counts')}; "
          f"captures in the arm: train_step {len(train_caps)}, the job's {job}, serving "
          f"steady {len(serve_steady)}; fine-tune {ms_during} ms/step beside serving",
          flush=True)

    # The candidate's served logits vs an engine with the plain backends on
    # the candidate's weights (the post-publish queries: the first
    # baseline_n of the target pool).
    ref_cfg = cfg.replace(lstm_backend="reference", attn_backend="reference")
    ref_model = build_model(ref_cfg, device=FLEET_DEVICE)
    ref_model.load_state_dict(load_params(out["candidate"]))
    ref = InferenceEngine(ref_model, ref_cfg, tok, k=cfg.k, buckets=FLEET_BUCKETS,
                          device=FLEET_DEVICE)
    try:
        ref.register_dataset(src, tenant=TENANT)
        want = ref.classify_batch(tgt_pool[:len(post)], tenant=TENANT)
    finally:
        ref.close()
    names = list(want[0]["logits"])
    got_m = np.array([[v["logits"][n] for n in names] for v in post])
    want_m = np.array([[v["logits"][n] for n in names] for v in want])
    scale = float(np.abs(want_m).max())
    err = float(np.abs(got_m - want_m).max())
    print(f"[fleet 16a] the candidate's served logits ({len(post)} post-publish verdicts) vs "
          f"the plain backends on its weights: max abs err {err:.3g} at scale {scale:.3g} "
          f"(rel tol {LOGIT_REL_TOL})", flush=True)
    bad = []
    for key in ("baseline_armed", "tripped", "canary_passed", "published", "versions_uniform",
                "rearmed", "verified"):
        if not out.get(key):
            bad.append(key)
    if out.get("dropped_during_publish") != 0 or out.get("steady_recompiles") != 0:
        bad.append("dropped/steady")
    if (out.get("nota_shifted") or 0) < 0.5:
        bad.append("nota_shifted < 0.5")
    if out.get("nota_post") is None or out.get("nota_healthy") is None \
            or abs(out["nota_post"] - out["nota_healthy"]) \
            > max(out.get("nota_band") or 0.05, 0.05) + 1e-9:
        bad.append("nota_post out of band")
    fc, ac = state.get("fleet_counts", {}), state.get("adapt_counts", {})
    if min(fc.get("K1", 0), fc.get("K2", 0)) == 0:
        bad.append(f"serving kernels not launched {fc}")
    if min(ac.get(k, 0) for k in ADAPT_KERNELS + ("K1", "K2")) == 0:
        bad.append(f"attempt kernels not launched {ac}")
    if len(train_caps) != 1 or serve_steady:
        bad.append(f"captures: train_step {len(train_caps)}, serving steady {len(serve_steady)}")
    during = state.get("during", {})
    if during.get("errors") or during.get("shed") or not during.get("served") or not in_capture:
        bad.append(f"traffic during the attempt {during}, {in_capture} inside the capture")
    if not np.isfinite(got_m).all() or err > LOGIT_REL_TOL * scale:
        bad.append(f"candidate logits {err} > {LOGIT_REL_TOL}*{scale}")
    if bad:
        raise AssertionError(f"16a: {bad}")
    return {"arm": fields, "pre": state["pre"], "during": during,
            "completions_in_capture": in_capture, "launches_fleet": fc, "launches_adapt": ac,
            "train_captures": len(train_caps), "job_captures": job,
            "serve_steady_captures": len(serve_steady), "finetune_ms_per_step": ms_during,
            "candidate_logit_err": err, "candidate_logit_scale": scale}


def fleet_failure(cfg, tok, src, tgt, ckpt: str, plan: dict) -> dict:
    """16b: every canary failed (``adapt.canary_fail``): no publish, the
    backoff, one ``adapt_exhausted``, the quarantine (degraded NOTA, no K1
    or K2), every candidate removed, device memory back; a router rebuilt
    from the journal restores the latch."""
    from induction_network_on_fewrel_tpu_torch.fleet import (
        FleetJournal,
        FleetRouter,
        InProcessReplica,
    )
    from induction_network_on_fewrel_tpu_torch.obs.adapt import EXHAUSTED, AdaptationController
    from induction_network_on_fewrel_tpu_torch.obs.adapt_drill import (
        TENANT,
        adapt_pools,
        run_adapt_failure_arm,
    )

    _, tgt_pool = adapt_pools(src, tgt, cfg.k)
    mem: dict = {}

    def on_attempt(i):
        gc.collect()
        torch.cuda.synchronize()
        mem[i] = torch.cuda.memory_allocated()

    jdir = FLEET_DIR / "journal_b"
    journal = FleetJournal(jdir)
    out = run_adapt_failure_arm(cfg, tok, src, tgt, ckpt, str(FLEET_DIR), plan=plan,
                                retries=FLEET_RETRIES, device=FLEET_DEVICE, journal=journal,
                                on_attempt=on_attempt, buckets=FLEET_BUCKETS)
    engine = out.pop("engine", None)
    journal.close()
    if engine is None:
        raise AssertionError(f"16b: the drift did not trip: {out}")
    torch.cuda.synchronize()
    before = kernel_counts()
    verdicts = [engine.classify(q, tenant=TENANT) for q in tgt_pool[:8]]
    torch.cuda.synchronize()
    quarantine_launches = count_delta(kernel_counts(), before)
    degraded = sum(bool(v["degraded"]) and bool(v["nota"]) for v in verdicts)
    j2 = FleetJournal(jdir)
    try:
        state = j2.materialize()
        router = FleetRouter({"r00": InProcessReplica("r00", engine)})
        try:
            summary = router.recover(j2, state=state)
            ctl = AdaptationController(lambda *a: None, None, lambda c: 0, journal=j2)
            ctl.restore_exhausted(state.adapt_exhausted)
            restored = ctl.state_of(TENANT) == EXHAUSTED and not ctl.trigger(TENANT)
        finally:
            router.close()
    finally:
        j2.close()
    mem_first, mem_last = mem.get(1), mem.get(FLEET_RETRIES + 1)
    fields = {k: out.get(k) for k in (
        "tripped", "attempt1_failed", "backoff_honored", "exhausted", "exhausted_criticals",
        "quarantined", "retrigger_absorbed", "candidates_cleaned", "unexpected_publishes",
        "canary_fail_records", "injected")}
    print(f"[fleet 16b] adapt.canary_fail x{FLEET_RETRIES}: {fields}; quarantined verdicts "
          f"{degraded}/{len(verdicts)} degraded NOTA, wrapper launches across them "
          f"{ {k: v for k, v in quarantine_launches.items() if v} }; device memory allocated "
          f"before the first attempt {mem_first} B, after the last {mem_last} B (all "
          f"readings {mem}); journal latch {dict(state.adapt_exhausted)}, recovered "
          f"{summary['tenants']} tenant(s), restored on a rebuilt router: {restored}",
          flush=True)
    bad = [k for k in ("tripped", "attempt1_failed", "backoff_honored", "exhausted",
                       "quarantined", "retrigger_absorbed", "candidates_cleaned")
           if not out.get(k)]
    if out.get("exhausted_criticals") != 1 or out.get("unexpected_publishes") != 0 \
            or out.get("canary_fail_records") != FLEET_RETRIES:
        bad.append("exhaustion counts")
    if degraded != len(verdicts) or quarantine_launches["K1"] or quarantine_launches["K2"]:
        bad.append(f"quarantine: {degraded} degraded, launches {quarantine_launches}")
    if mem_first is None or mem_last is None or abs(mem_last - mem_first) > FLEET_MEM_TOL:
        bad.append(f"device memory {mem_first} -> {mem_last}")
    if not restored:
        bad.append("the journaled latch was not restored")
    if bad:
        raise AssertionError(f"16b: {bad}")
    return {"arm": fields, "degraded_verdicts": degraded,
            "quarantine_launches": quarantine_launches, "mem_first": mem_first,
            "mem_last": mem_last, "mem": mem, "latch_restored": restored}


def fleet_faults(cfg, tok, src, ckpt: str) -> dict:
    """16c: ``fleet.replica_kill`` mid-traffic (failover, nothing dropped,
    the supervisor revives); ``journal.torn_write`` and a cold-start
    recovery from the WAL; a hot standby's promotion fencing the old
    primary; one autoscaler cycle on the injected clock."""
    from induction_network_on_fewrel_tpu_torch.fleet import (
        DRAINING,
        UP,
        FleetAutoscaler,
        FleetControl,
        FleetJournal,
        FleetRouter,
        HotStandby,
        InProcessReplica,
        JournalError,
        ReplicaSupervisor,
    )
    from induction_network_on_fewrel_tpu_torch.load.recovery import tear_journal
    from induction_network_on_fewrel_tpu_torch.obs.adapt_drill import replica_engine
    from induction_network_on_fewrel_tpu_torch.obs.chaos import ChaosRegistry, install
    from induction_network_on_fewrel_tpu_torch.serving.breaker import CircuitBreaker

    def replica(rid: str):
        return InProcessReplica(rid, replica_engine(cfg, tok, ckpt, buckets=FLEET_BUCKETS,
                                                    device=FLEET_DEVICE))

    pool = [i for r in src.rel_names for i in src.instances[r][cfg.k:]]
    tenants = [f"t{i}" for i in range(4)]
    jdir = FLEET_DIR / "journal_c"
    journal = FleetJournal(jdir)
    journal.acquire_lease("primary")
    router = FleetRouter({f"r{i:02d}": replica(f"r{i:02d}") for i in range(FLEET_REPLICAS)},
                         breaker=CircuitBreaker(failure_threshold=3, open_s=1.0))
    control = FleetControl(router, journal=journal)
    out: dict = {}
    try:
        for t in tenants:
            control.register_tenant(t, src)
        for h in router.replicas.values():
            h.warmup()
        victim = router.directory["t0"].owner
        served = degraded = errors = 0
        moved = []
        install(ChaosRegistry.parse(f"fleet.replica_kill@2:{victim}"))
        try:
            for i in range(32):
                if i == 16:
                    moved = control.replace_tenants()
                try:
                    v = router.classify(pool[i % len(pool)], 30.0, tenant=tenants[i % 4])
                except Exception:  # noqa: BLE001 — any failure is a drop
                    errors += 1
                    continue
                served += 1
                degraded += bool(v.get("degraded"))
        finally:
            install(None)
        dead = router.placement.state(victim)
        clock = {"t": 0.0}
        sup = ReplicaSupervisor(router, replica, journal=journal, backoff_s=1.0,
                                restart_budget=3, clock=lambda: clock["t"])
        polled = sup.poll()
        revived = router.placement.state(victim) == UP
        moved_back = control.replace_tenants()
        v = router.classify(pool[0], 30.0, tenant="t0")
        out["kill"] = {"victim": victim, "state_after_kill": dead, "served": served,
                       "degraded_failover": degraded, "errors": errors, "moved": moved,
                       "supervisor": {k: v2 for k, v2 in polled.items() if v2},
                       "revived": revived, "moved_back": moved_back, "after_revive_degraded": bool(v.get("degraded"))}
        print(f"[fleet 16c] fleet.replica_kill on {victim} mid-traffic: {out['kill']}",
              flush=True)
        if errors or served != 32 or not degraded or dead != "dead" or not revived:
            raise AssertionError(f"16c replica kill: {out['kill']}")

        # journal.torn_write (load/recovery.tear_journal: the torn append,
        # the next one refused, the journal healed), then a cold start from
        # the WAL.
        control.publish_checkpoint(ckpt)
        versions = {rid: h.params_version for rid, h in router.replicas.items()}
        torn = tear_journal(control, jdir, "t1", "t2")
        refused = torn["append_refused_after_tear"]
        view = router.directory_view()
        journal.close()
        router.close()
        journal = FleetJournal(jdir)
        journal.acquire_lease("primary")
        router = FleetRouter({f"r{i:02d}": replica(f"r{i:02d}") for i in range(FLEET_REPLICAS)})
        control = FleetControl(router, journal=journal)
        summary = router.recover(journal)
        same_view = router.directory_view() == view
        versions2 = {rid: h.params_version for rid, h in router.replicas.items()}
        out["torn"] = {"append_after_tear_refused": refused,
                       "prefix_recovered": torn["prefix_recovered"], "recovered": summary,
                       "directory_equal": same_view, "params_version_before": versions,
                       "params_version_after": versions2}
        print(f"[fleet 16c] journal.torn_write: {out['torn']}", flush=True)
        if not refused or not torn["prefix_recovered"] or not same_view \
                or versions2 != versions:
            raise AssertionError(f"16c torn write: {out['torn']}")

        # A hot standby tails the WAL and promotes; the old primary is fenced.
        standby = HotStandby(jdir)
        applied = standby.poll()
        promo = standby.promote(dict(router.replicas))
        try:
            control.set_nota_threshold("t2", 0.2)
            fenced = False
        except JournalError:
            fenced = True
        out["standby"] = {"applied": applied, "promote_s": promo["promote_s"],
                          "lease_epoch": promo["lease_epoch"], "tenants": promo["tenants"],
                          "old_primary_fenced": fenced,
                          "directory_equal": standby.router.directory_view() == view}
        print(f"[fleet 16c] hot standby: {out['standby']}", flush=True)
        if not fenced or not out["standby"]["directory_equal"]:
            raise AssertionError(f"16c standby: {out['standby']}")
        journal.close()
        router = standby.router
        journal = standby.journal
        control = FleetControl(router, journal=journal)

        # One autoscaler cycle on the injected clock.
        aclock = {"t": 0.0}
        scaler = FleetAutoscaler(control, replica, min_replicas=FLEET_REPLICAS,
                                 max_replicas=FLEET_REPLICAS + 1, high_windows=2, low_windows=2,
                                 cooldown_s=10.0, scale_budget_s=30.0,
                                 clock=lambda: aclock["t"])
        actions = []
        for _ in range(6):
            actions.append(scaler.tick({"occupancy": 0.9})["action"])
            aclock["t"] += 1.0
            if actions[-1] == "scale_out":
                break
        grown = sorted(router.replicas)
        aclock["t"] += 20.0
        drained = None
        for _ in range(6):
            a = scaler.tick({"occupancy": 0.0})["action"]
            actions.append(a)
            for rid in router.replicas:
                if router.placement.state(rid) == DRAINING:
                    drained = (rid, router.replicas[rid].stats_snapshot()["queue_depth"])
            aclock["t"] += 1.0
            if a == "drain_in":
                break
        out["autoscale"] = {"actions": actions, "after_scale_out": grown,
                            "after_drain_in": sorted(router.replicas),
                            "drained_queue_depth": drained,
                            "tenants": len(router.directory)}
        print(f"[fleet 16c] autoscaler: {out['autoscale']}", flush=True)
        if "scale_out" not in actions or "drain_in" not in actions \
                or len(grown) != FLEET_REPLICAS + 1 \
                or len(router.replicas) != FLEET_REPLICAS or len(router.directory) != 4 \
                or (drained is not None and drained[1] != 0):
            raise AssertionError(f"16c autoscaler: {out['autoscale']}")
    finally:
        router.close()
        journal.close()
    return out


def fleet_socket(cfg, tok, src, ckpt: str) -> dict:
    """16d: one replica in a child process on the same card behind a
    ``SocketReplica`` (logits vs an in-process replica on the same weights,
    ``net.drop`` and ``net.slow`` retried), then ``serve_main --replicas 3
    --journal --control_socket`` and a second process's ``--send``."""
    from induction_network_on_fewrel_tpu_torch.fleet import InProcessReplica
    from induction_network_on_fewrel_tpu_torch.fleet.transport import SocketReplica
    from induction_network_on_fewrel_tpu_torch.obs.adapt_drill import TENANT, replica_engine
    from induction_network_on_fewrel_tpu_torch.obs.chaos import ChaosRegistry, install

    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    pool = [i for r in src.rel_names for i in src.instances[r][cfg.k:]][:16]
    device_flag = ["--device", FLEET_DEVICE] if FLEET_DEVICE else []
    child = subprocess.Popen(
        [sys.executable, "-m", "induction_network_on_fewrel_tpu_torch.fleet.transport",
         "--load_ckpt", ckpt, "--buckets", ",".join(map(str, FLEET_BUCKETS)), *device_flag],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=root, env=env)
    out: dict = {}
    local = None
    sock = None
    try:
        line = child.stdout.readline()
        address = tuple(json.loads(line)["address"])
        sock = SocketReplica("s0", address, call_deadline_s=30.0, retries=2,
                             retry_backoff_s=0.01)
        local = InProcessReplica("l0", replica_engine(cfg, tok, ckpt, buckets=FLEET_BUCKETS,
                                                      device=FLEET_DEVICE))
        for h in (sock, local):
            h.register_dataset(src, TENANT)
            h.warmup()
        got = [sock.submit(q, 30.0, tenant=TENANT).result(timeout=60.0) for q in pool]
        want = [local.submit(q, 30.0, tenant=TENANT).result(timeout=60.0) for q in pool]
        names = list(want[0]["logits"])
        err = float(max(abs(g["logits"][n] - w["logits"][n])
                        for g, w in zip(got, want) for n in names))
        install(ChaosRegistry.parse("net.drop@0:s0"))
        try:
            t0 = time.monotonic()
            v_drop = sock.params_version
            drop_s = time.monotonic() - t0
        finally:
            install(None)
        install(ChaosRegistry.parse("net.slow@0:0.05"))
        try:
            t0 = time.monotonic()
            v_slow = sock.params_version
            slow_s = time.monotonic() - t0
        finally:
            install(None)
        out["socket"] = {"verdicts": len(got), "logit_max_abs_err": err,
                         "labels_equal": [g["label"] for g in got] == [w["label"] for w in want],
                         "net_drop_retried": v_drop == local.params_version,
                         "net_drop_s": round(drop_s, 4), "net_slow_s": round(slow_s, 4),
                         "net_slow_landed": v_slow == local.params_version and slow_s >= 0.05}
        print(f"[fleet 16d] a replica in a child process behind a SocketReplica: "
              f"{out['socket']}", flush=True)
        if err > SOCKET_LOGIT_TOL or not out["socket"]["labels_equal"] \
                or not out["socket"]["net_drop_retried"] or not out["socket"]["net_slow_landed"]:
            raise AssertionError(f"16d socket: {out['socket']}")
    finally:
        if sock is not None:
            sock.close()
        if local is not None:
            local.close()
        child.stdin.close()
        child.wait(timeout=120)

    # serve_main's fleet and its operator socket, from two processes.
    jdir, csock = FLEET_DIR / "journal_d", FLEET_DIR / "control.sock"
    serve = subprocess.Popen(
        [sys.executable, "-m", "induction_network_on_fewrel_tpu_torch.serving.cli",
         "--load_ckpt", ckpt, "--replicas", "3", "--journal", str(jdir),
         "--control_socket", str(csock), "--input", "-", "--buckets",
         ",".join(map(str, FLEET_BUCKETS)), *device_flag],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=root, env=env)
    try:
        deadline = time.monotonic() + 240.0
        while not csock.exists():
            if serve.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"serve_main never listened: {serve.stderr.read()[-2000:]}")
            time.sleep(0.2)
        sent = subprocess.run(
            [sys.executable, "-m", "induction_network_on_fewrel_tpu_torch.serving.cli",
             "--control_socket", str(csock), "--send", '{"op": "drain", "replica": "r01"}'],
            capture_output=True, text=True, cwd=root, env=env, timeout=120)
        reply = json.loads(sent.stdout.strip().splitlines()[-1])
        stdout, stderr = serve.communicate(json.dumps(raw_instance(pool[0])) + "\n",
                                           timeout=120)
    finally:
        if serve.poll() is None:
            serve.kill()
            serve.wait()
    verdict = json.loads(stdout.strip().splitlines()[-1])
    out["control"] = {"send_rc": sent.returncode, "reply": reply, "serve_rc": serve.returncode,
                      "verdict_label": verdict.get("label")}
    print(f"[fleet 16d] serve_main --replicas 3 --journal --control_socket, then --send "
          f"drain r01 from a second process: {out['control']}", flush=True)
    if sent.returncode or not reply.get("ok") or serve.returncode \
            or reply["result"]["replica"] != "r01":
        raise AssertionError(f"16d control socket: {out['control']}; {stderr[-2000:]}")
    return out


def fleet_phase(smi: str) -> dict:
    """Phase 16: the serving control plane and the drift-triggered
    adaptation controller, at the flagship widths on the drill world."""
    from induction_network_on_fewrel_tpu_torch.obs.adapt_drill import adapt_world

    t0 = time.monotonic()
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    FLEET_DIR.mkdir(parents=True)
    cfg = fleet_cfg()
    cfg, tok, _, src, tgt, ckpt = adapt_world(FLEET_SEED, str(FLEET_DIR), cfg=cfg,
                                              plan=FLEET_PLAN, device=FLEET_DEVICE)
    t_world = time.monotonic() - t0
    print(f"[fleet] the drill world at the flagship widths ({cfg.vocab_size} x {cfg.word_dim} "
          f"table, BiLSTM u={cfg.lstm_hidden}, {cfg.n}-way {cfg.k}-shot, NOTA rate "
          f"{cfg.na_rate}, {cfg.compute_dtype} encoder): {FLEET_PLAN['num_relations']} "
          f"relations x {FLEET_PLAN['instances_per_relation']}, the source artifact trained "
          f"{FLEET_PLAN['train_iters']} steps on the card in {t_world:.1f} s; {smi}", flush=True)
    head = fleet_headline(cfg, tok, src, tgt, ckpt)
    plan = dict(FLEET_PLAN, canary_floors=head["floors"])
    alone = fleet_alone(cfg, tok, src, tgt, ckpt)
    a = fleet_success(cfg, tok, src, tgt, ckpt, plan)
    b = fleet_failure(cfg, tok, src, tgt, ckpt, plan)
    c = fleet_faults(cfg, tok, src, ckpt)
    d = fleet_socket(cfg, tok, src, ckpt)
    seconds = round(time.monotonic() - t0, 1)
    out = {"card": smi, "config": {**FLEET_KNOBS, **{k: v for k, v in FLEET_PLAN.items()}},
           "headline": head, "finetune_ms_per_step_alone": alone,
           "finetune_ms_per_step_serving": a["finetune_ms_per_step"],
           "a_success": a, "b_failure": b, "c_faults": c, "d_socket": d, "seconds": seconds}
    print(f"[fleet] phase 16: {seconds} s (aim {FLEET_SECONDS})", flush=True)
    out["report_runs"] = keep_runs(FLEET_DIR, "fleet16")
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    return out


# --- phase 17: the load tools on the card -------------------------------------------

LOAD_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_load"
# Cuts of the tool's own configuration (its flagship checkpoint, N=5, K=5,
# two tenants, buckets 1-16): seconds per load phase (the tool's default
# 5 s), the burn drill's fast window (3 s), the quant and geometry arms'
# phases (5 s and 2 s in the JAX artifacts), and the soak's tenants (1 000
# in the JAX artifact, on 4 replicas).
LOAD_S = 1.5
LOAD_AB_S = 1.0
LOAD_FLEET_TENANTS = 64
LOAD_SECONDS = 150
LOAD_SLO_FAST_S = 1.0
LOAD_CUTS = {"duration_s": f"{LOAD_S} (tool default 5.0)",
             "burn_slo_fast_s": f"{LOAD_SLO_FAST_S} (tool default 3.0)",
             "quant_geom_duration_s": f"{LOAD_AB_S} (JAX artifacts 5.0 / 2.0)",
             "fleet_tenants": f"{LOAD_FLEET_TENANTS} on 3 replicas (JAX artifact 1000 on 4)"}


def load_args(*extra):
    from induction_network_on_fewrel_tpu_torch.load.harness import parse_args

    return parse_args(["--duration", str(LOAD_S), "--run_dir", str(LOAD_DIR / "run"), *extra])


def load_sinks(run: Path):
    """The tool's telemetry sinks on ``run``: logger, recorder, capture."""
    from induction_network_on_fewrel_tpu_torch.obs import DiagnosticsCapture, FlightRecorder

    logger = MetricsLogger(run, quiet=True)
    recorder = FlightRecorder(out_dir=run)
    logger.add_hook(recorder.record_metric)
    return logger, recorder, DiagnosticsCapture(run, recorder=recorder)


def bucket_pcts(by_bucket: dict) -> dict:
    return {b: {"n": len(v), "p50_ms": round(float(np.percentile(v, 50)) * 1e3, 3),
                "p99_ms": round(float(np.percentile(v, 99)) * 1e3, 3)}
            for b, v in sorted(by_bucket.items())}


def load_generator(ckpt: str) -> dict:
    """17a: both scheduler arms, closed and open, and the swap drill,
    through ``load/harness.drive_one``; each arm's captures counted by a
    watcher against its warmup's."""
    from induction_network_on_fewrel_tpu_torch.load.__main__ import arm_verdicts, comparison
    from induction_network_on_fewrel_tpu_torch.load.harness import (
        build_engine,
        drive_one,
        engine_params,
    )

    args = load_args("--swap_drill")
    arms = {}
    for arm in ("continuous", "microbatch"):
        watcher = stamped_watcher()
        by_bucket: dict = {}
        warm: list = []
        engine = build_engine(args, ckpt, arm)
        try:
            r = drive_one(engine, args, np.random.default_rng(args.seed),
                          swap_fn=lambda e=engine: e.publish_params(engine_params(e)),
                          by_bucket=by_bucket, on_warmup=lambda: warm.append(len(watcher.stamps)))
        finally:
            engine.close()
            watcher.uninstall()
        r["captures_after_warmup"] = sum(1 for fn, _, _ in watcher.stamps[warm[0]:]
                                         if fn == SERVE_CAPTURE)
        r["by_bucket"] = bucket_pcts(by_bucket)
        arms[arm] = r
        st, sw = r["stats"], r["swap_drill"]
        print(f"[load 17a/{arm}] registry parity max|delta| {max(r['parity_max_delta'].values()):.3g} "
              f"(gate 1e-4); closed {r['closed']['qps']} served/s p50 {r['closed']['p50_ms']} "
              f"p99 {r['closed']['p99_ms']} ms errors {r['closed']['errors']}; open offered "
              f"{r['open']['offered_qps']} served {r['open']['qps']}/s p50 {r['open']['p50_ms']} "
              f"p99 {r['open']['p99_ms']} ms rejected {r['open']['rejected']}; per bucket "
              f"{r['by_bucket']}; shed {st['shed']}, captures after warmup "
              f"{r['captures_after_warmup']} (steady_recompiles {st['steady_recompiles']}); swap "
              f"drill v{sw.get('params_version')} in {sw.get('publish_s')} s, dropped "
              f"{sw['dropped']}", flush=True)
        if arm_verdicts(arm, r) or r["captures_after_warmup"] or st["shed"] \
                or r["closed"]["errors"] or r["open"]["dropped"]:
            raise AssertionError(f"17a {arm}: {json.dumps(r, default=str)[:3000]}")
    return {"arms": arms, "comparison": comparison(arms)}


def load_drills(ckpt: str) -> dict:
    """17b: the burn, drift and chaos drills (``load/burn.py``,
    ``load/drift.py``, ``load/chaos.py``), each on an engine of its own."""
    from induction_network_on_fewrel_tpu_torch.load.burn import burn_ok, run_burn_drill
    from induction_network_on_fewrel_tpu_torch.load.chaos import check_chaos_drill, run_chaos_drill
    from induction_network_on_fewrel_tpu_torch.load.drift import drift_ok, run_drift_drill
    from induction_network_on_fewrel_tpu_torch.load.harness import (
        _pools,
        build_engine,
        build_slo,
        register_tenants,
        run_open,
    )

    args = load_args("--burn_drill", "--slo_fast_s", str(LOAD_SLO_FAST_S))
    logger, recorder, capture = load_sinks(LOAD_DIR / "run")
    out: dict = {}
    try:
        engine = build_engine(args, ckpt, "continuous", logger=logger,
                              slo=build_slo(args, logger, recorder, capture))
        try:
            pools = _pools(register_tenants(engine, args), args.K)
            engine.warmup()
            rng = np.random.default_rng(args.seed)
            run_open(engine, pools, args.rate, LOAD_S, rng)     # the healthy p50
            out["burn"] = run_burn_drill(engine, pools, args, rng)
        finally:
            engine.close()
        out["drift"] = run_drift_drill(args, ckpt, logger, recorder, capture)
        out["chaos"] = run_chaos_drill(args, ckpt, logger, recorder, capture)
    finally:
        capture.wait(10.0)
        logger.close()
    b, d, c = out["burn"], out["drift"], out["chaos"]
    print(f"[load 17b] burn: SLO {b['threshold_ms']} ms tripped at x{b['tripped_at_rate_multiplier']} "
          f"(served {b['served']}, rejected {b['rejected']}, misses {b['deadline_miss']}), "
          f"once-latched {b['once_latched']}, captures {len(b['captures'])}; drift: floor "
          f"{d['calibration']['threshold']} (clean {d['calibration']['clean_frac']}), tripped "
          f"after {d.get('tripped_after')} on {d.get('drift_features')}, re-armed by the "
          f"publish {d.get('rearmed_on_publish')}, clean after {d.get('clean_after_publish')}; "
          f"chaos: breaker {c['breaker_opened']}/{c['breaker_recovered']}, rollback "
          f"{c['rollback']}, ring leg {c['ckpt']['fallback_step']} bitwise "
          f"{c['ckpt']['bitwise_equal']}", flush=True)
    bad = [k for k, ok in (("burn", burn_ok(b)), ("drift", drift_ok(d)),
                           ("chaos", check_chaos_drill(c))) if not ok]
    if bad:
        raise AssertionError(f"17b gates failed: {bad}: {json.dumps(out, default=str)[:3000]}")
    return out


def load_ab() -> dict:
    """17c: the quant A/B on the 60-step trained checkpoint and the
    geometry A/B with its scenario grid leg."""
    from induction_network_on_fewrel_tpu_torch.load.geom import run_geom_ab
    from induction_network_on_fewrel_tpu_torch.load.harness import make_synthetic_checkpoint
    from induction_network_on_fewrel_tpu_torch.load.quant import run_quant_ab

    args = load_args("--quant_ab", "--duration", str(LOAD_AB_S))
    t0 = time.monotonic()
    ckpt = make_synthetic_checkpoint(args, str(LOAD_DIR / "quant"), train_iters=60)
    train_s = time.monotonic() - t0
    quant = run_quant_ab(args, ckpt)
    print(f"[load 17c] quant A/B (checkpoint trained 60 steps on the card in {train_s:.1f} s): "
          + "; ".join(f"{dt} {a['qps']} served/s p50 {a['p50_ms']} p99 {a['p99_ms']} ms, "
                      f"{a['resident_bytes_per_tenant']} B/tenant, agreement "
                      f"{a['quant_agreement']} over {a['quant_probes']} probes, margin drift "
                      f"{a['quant_margin_drift']}, parity {a['parity_max_delta']:.3g}"
                      for dt, a in quant["arms"].items())
          + f"; gate failures {quant['check_failures']}", flush=True)
    gargs = load_args("--geom_ab", "--duration", str(LOAD_AB_S))
    geom = run_geom_ab(gargs, make_synthetic_checkpoint(gargs, str(LOAD_DIR / "geom")))
    print(f"[load 17c] geometry A/B: "
          + "; ".join(f"{k} programs {a['program_cache_keys']} (captured "
                      f"{a['programs_compiled']}), {a['qps']} served/s p50 {a['p50_ms']} ms, "
                      f"parity {a['parity_max_delta']:.3g}, flip {a['dtype_flip']['parity_max_delta']:.3g}, "
                      f"steady {a['steady_recompiles']}" for k, a in geom["arms"].items())
          + f"; bound {geom['program_bound_tiered']}; grid "
          + " ".join(f"{k}={v['accuracy']}" for k, v in geom["grid"].items())
          + f"; gate failures {geom['check_failures']}", flush=True)
    if quant["check_failures"] or geom["check_failures"]:
        raise AssertionError(f"17c gates failed: {quant['check_failures']} "
                             f"{geom['check_failures']}")
    return {"quant": quant, "geom": geom, "quant_train_s": train_s}


def load_fleet(ckpt: str) -> dict:
    """17d: the fleet soak at --fleet 3, the tier-1 fleet, recovery,
    elastic and fleet-obs drills (their placement and naming against the
    JAX artifacts' tier-1 values), then ``fleet_report --check`` in a
    process of its own on the fleet-obs run directory."""
    from induction_network_on_fewrel_tpu_torch.load.elastic import elastic_tier1_drill
    from induction_network_on_fewrel_tpu_torch.load.fleet import fleet_tier1_drill, run_fleet_soak
    from induction_network_on_fewrel_tpu_torch.load.fleet_obs import fleet_obs_drill
    from induction_network_on_fewrel_tpu_torch.load.recovery import recovery_tier1_drill

    root = Path(__file__).resolve().parent

    def artifact(name):
        return json.loads((root / name).read_text())

    args = load_args("--fleet", "3", "--tenants", str(LOAD_FLEET_TENANTS))
    logger, recorder, capture = load_sinks(LOAD_DIR / "fleet")
    try:
        soak = run_fleet_soak(args, ckpt, logger, recorder, capture)
        tier1 = fleet_tier1_drill(seed=0, logger=logger)
        rec = recovery_tier1_drill(seed=0, logger=logger)
        ela = elastic_tier1_drill(seed=0, logger=logger)
    finally:
        capture.wait(10.0)
        logger.close()
    obs_dir = LOAD_DIR / "obsfleet"
    obs = fleet_obs_drill(seed=0, fleet_dir=str(obs_dir))
    env = {**os.environ, "PYTHONPATH": str(root) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    check = subprocess.run([sys.executable, "-m", "induction_network_on_fewrel_tpu_torch.load."
                            "fleet_report", str(obs_dir), "--check"], capture_output=True,
                           text=True, cwd=root, env=env, timeout=120)
    fa, ra, ea = (artifact("FLEET_r01.json")["tier1"], artifact("RECOVERY_r01.json"),
                  artifact("ELASTIC_r01.json"))
    pins = {
        "fleet_placement": tier1["placement_distribution"] == fa["placement_distribution"],
        "fleet_kill": tier1["replica_kill"] == fa["replica_kill"],
        "recovery_placement": rec["placement_distribution"] == ra["placement_distribution"],
        "recovery_victim": rec["replica_kill"]["victim"] == ra["replica_kill"]["victim"],
        "elastic_replicas": (ela["scale_out"]["replica"], ela["drain_in"]["replica"])
        == (ea["scale_out"]["replica"], ea["drain_in"]["replica"]),
    }
    tr, fp, rk = soak["traffic"], soak["fanout_publish"], soak["replica_kill"]
    print(f"[load 17d] fleet soak R=3 T={LOAD_FLEET_TENANTS}: {tr['qps']} served/s p50 "
          f"{tr['p50_ms']} p99 {tr['p99_ms']} ms shed {tr['shed']} errors {tr['errors']}; "
          f"fan-out v{fp.get('params_version')} in {fp.get('publish_s')} s uniform "
          f"{fp['uniform']} steady {fp['steady_recompiles']}; add churn "
          f"{soak['placement']['add_churn_frac']}; kill {rk['victim']}: degraded "
          f"{rk['degraded_served']} criticals {rk['criticals']} recovered {rk['recovered']}; "
          f"tier-1 fleet {tier1['passed']}, recovery {rec['passed']}, elastic {ela['passed']} "
          f"(promote {ela['promotion']['promote_s']} s), fleet-obs {obs['passed']} "
          f"(hops {obs['stitching']['hop_records']}, stitched {obs['stitching']['stitched']}, "
          f"orphans {obs['stitching']['orphan_spans']}, hop p50 {obs['hop']['hop_ms_p50']} ms); "
          f"the JAX artifacts' tier-1 values {pins}; fleet_report --check rc "
          f"{check.returncode}: {check.stdout.strip().splitlines()[-1:]}", flush=True)
    bad = [k for k, ok in (("soak", soak["passed"]), ("tier1", tier1["passed"]),
                           ("recovery", rec["passed"]), ("elastic", ela["passed"]),
                           ("fleet_obs", obs["passed"]), ("report", check.returncode == 0),
                           *pins.items()) if not ok]
    if bad:
        raise AssertionError(f"17d gates failed: {bad}; {check.stderr[-2000:]}")
    return {"soak": {k: soak[k] for k in ("traffic", "per_replica", "fanout_publish",
                                          "placement", "replica_kill", "zero_bands")},
            "tier1": tier1, "recovery": rec["zero_bands"], "elastic": ela["zero_bands"],
            "promote_s": ela["promotion"]["promote_s"], "fleet_obs": {
                k: obs[k] for k in ("requests", "stitching", "hop", "clock", "timeline")},
            "report_rc": check.returncode, "pins": pins}


def load_phase(smi: str) -> dict:
    """Phase 17: the port's load tools on the card, at the tool's own
    configuration, the kernels' wrapper counts zeroed just before and read
    just after."""
    from induction_network_on_fewrel_tpu_torch.load.harness import make_synthetic_checkpoint

    t0 = time.monotonic()
    shutil.rmtree(LOAD_DIR, ignore_errors=True)
    LOAD_DIR.mkdir(parents=True)
    ckpt = make_synthetic_checkpoint(load_args(), str(LOAD_DIR))
    print(f"[load] the tool's checkpoint (flagship widths: u=128, L=40, D=60, A=64, "
          f"{ExperimentConfig().compute_dtype} encoder, f32 head, 2 002-word table, 5-way "
          f"5-shot, 2 tenants); cuts {LOAD_CUTS}; {smi}", flush=True)
    torch.cuda.synchronize()
    zero_kernel_counts()
    out = {"card": smi, "cuts": LOAD_CUTS, "a_generator": load_generator(ckpt),
           "b_drills": load_drills(ckpt), "c_ab": load_ab(), "d_fleet": load_fleet(ckpt)}
    torch.cuda.synchronize()
    out["launches"] = kernel_counts()
    out["seconds"] = round(time.monotonic() - t0, 1)
    print(f"[load] wrapper launches across phase 17 (distils, warm-ups, captures; the quant "
          f"checkpoint's training): {out['launches']}; {out['seconds']} s (aim "
          f"{LOAD_SECONDS})", flush=True)
    if min(out["launches"]["K1"], out["launches"]["K2"]) == 0:
        raise AssertionError(f"phase 17 launched no K1/K2: {out['launches']}")
    out["report_runs"] = keep_runs(LOAD_DIR, "load17")
    shutil.rmtree(LOAD_DIR, ignore_errors=True)
    return out


# --- phase 18: the single-card tools on the card -------------------------------------

TOOLS_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_tools"
# The run directories of phases 15-17, copied before those phases remove
# their files, for phase 18c's report.
REPORT_DIR = TOOLS_DIR / "earlier"
REPORT_FILES = ("metrics.jsonl", "config.json", "flight_recorder.json")
# 18a: the flagship on the token cache (the synthetic 400 002 x 50 table,
# bf16 encoder), one replay of 4 steps lazy, then 4 shared; a val pass and
# a best save (the converter's source) at every replay. Weight decay 0:
# lazy mode keeps decay off the table, so the shared continuation equals
# the uninterrupted shared run only at wd = 0 (the converter's caveat).
TOOLS_STEPS = 4
TOOLS_ARGV = ["--synthetic", "--bf16", "--token_cache", "--steps_per_call", "4",
              "--val_step", str(TOOLS_STEPS), "--val_iter", "20", "--weight_decay", "0"]
TOOLS_ON = ("lazy_catchup", "K7", "K8", "optim_sumsq", "optim_update")
# 18b: the zoo sweep's recipe cut from 4000 steps (val every 500, 200
# episodes) to 500 (val every 250, 50 episodes), two of its seven models.
ZOO_TOOL_MODELS = ("induction",)
ZOO_TOOL_CUT = ["--train_iter", "500", "--val_step", "250", "--val_iter", "50"]
TOOLS_SECONDS = 120


def keep_runs(phase_dir: Path, tag: str) -> list[str]:
    """Copy every run directory under ``phase_dir`` (each metrics.jsonl's
    directory: the stream, its config.json and flight_recorder.json) into
    ``REPORT_DIR / tag``; returns the copies."""
    kept = []
    for metrics in sorted(phase_dir.rglob("metrics.jsonl")):
        run = metrics.parent
        dst = REPORT_DIR / tag / run.relative_to(phase_dir)
        dst.mkdir(parents=True, exist_ok=True)
        for name in REPORT_FILES:
            if (run / name).exists():
                shutil.copy2(run / name, dst / name)
        kept.append(str(dst))
    return kept


def tools_convert(smi: str) -> dict:
    """18a: a lazy flagship run through ``cli.train_main``, converted by
    ``tools/convert_lazy_ckpt``, resumed in shared mode by ``cli.train_main
    --resume``, held against the uninterrupted shared run from the same
    seed at ``hold_state``'s bars (1e-6 of scale; the lazy pair's)."""
    from induction_network_on_fewrel_tpu_torch.tools import convert_lazy_ckpt

    lazy_dir, conv_dir, ref_dir = (TOOLS_DIR / n for n in ("lazy", "converted", "shared"))
    t0 = time.monotonic()
    torch.cuda.synchronize()
    zero_kernel_counts()
    with counted_profile() as prof:
        rc, out, err = quiet_cli(cli.train_main, [
            *TOOLS_ARGV, "--embed_optimizer", "lazy", "--train_iter", str(TOOLS_STEPS),
            "--save_ckpt", str(lazy_dir)])
        if rc:
            raise AssertionError(f"18a lazy run: rc {rc}: {err[-2000:]}")
        before = lazy_catchup.launches
        rc, conv_out, err = quiet_cli(convert_lazy_ckpt.main, [str(lazy_dir), str(conv_dir)])
        conv_launches = lazy_catchup.launches - before
        if rc or conv_launches != 1:
            raise AssertionError(f"18a convert: rc {rc}, lazy_catchup launches {conv_launches}: "
                                 f"{err[-2000:]}")
        rc, out, err = quiet_cli(cli.train_main, [
            *TOOLS_ARGV, "--train_iter", str(TOOLS_STEPS), "--save_ckpt", str(conv_dir),
            "--resume"])
        if rc or f"restored latest checkpoint step={TOOLS_STEPS}" not in err:
            raise AssertionError(f"18a shared resume: rc {rc}: {err[-2000:]}")
    rows = profile_rows(prof)
    launches = profiled_counts(rows)
    wall = time.monotonic() - t0
    print(f"[tools 18a] lazy {TOOLS_STEPS} steps (cli train --embed_optimizer lazy), "
          f"{conv_out.strip()}, shared {TOOLS_STEPS} more (cli train --resume) in {wall:.1f} s; "
          f"profiled launches {launches} (the converter's materialize: {conv_launches} "
          f"lazy_catchup); {smi}", flush=True)
    if min(launches[k] for k in TOOLS_ON) == 0:
        raise AssertionError(f"18a: a kernel of the path never launched: {launches}")
    args = cli.parse_args(True, [*TOOLS_ARGV, "--train_iter", str(2 * TOOLS_STEPS),
                                 "--save_ckpt", str(ref_dir)])
    ref = cli.make_trainer(args, cli.config_from_args(args))[0]
    try:
        table0 = ref.model.embedding.word_embedding.detach().clone()
        with contextlib.redirect_stderr(io.StringIO()):
            ref.train(2 * TOOLS_STEPS)
    finally:
        ref.close()
        cli.close_telemetry(ref)
    cfg = CheckpointManager.load_config(conv_dir)
    model = build_model(cfg)
    opt = make_optimizer(cfg, model)
    step = CheckpointManager(conv_dir).restore("latest", model, opt)
    if step != 2 * TOOLS_STEPS or cfg.embed_optimizer != "shared":
        raise AssertionError(f"18a: the resumed run ended at step {step} ({cfg.embed_optimizer})")
    held = hold_state("tools 18a converted + resumed vs uninterrupted shared",
                      (model, opt), (ref.model, ref.opt), table0)
    return {"seconds": wall, "launches": launches, "converter_lazy_catchup": conv_launches,
            "steps": [TOOLS_STEPS, TOOLS_STEPS], "held": held, "runs": [str(lazy_dir),
                                                                        str(conv_dir)]}


def tools_zoo() -> dict:
    """18b: ``tools/zoo_quality.run_model`` for ZOO_TOOL_MODELS at the cut
    recipe, each a child process of the port's CLI on the card."""
    from induction_network_on_fewrel_tpu_torch.tools.zoo_quality import run_model

    rows = {}
    for m in ZOO_TOOL_MODELS:
        t0 = time.monotonic()
        row = run_model(m, ZOO_TOOL_CUT, ckpt=str(TOOLS_DIR / f"zoo_{m}"))
        row["seconds"] = round(time.monotonic() - t0, 1)
        print(f"[tools 18b] zoo_quality {json.dumps(row)} (cut: {' '.join(ZOO_TOOL_CUT)})",
              flush=True)
        if "error" in row or not isinstance(row.get("final_val_accuracy"), float) \
                or not row.get("train_eps_s_median"):
            raise AssertionError(f"18b: zoo_quality row {row}")
        rows[m] = row
    return {"cut": ZOO_TOOL_CUT, "rows": rows}


def tools_report(runs: list, mfu_run: str) -> dict:
    """18c: the port's ``tools/obs_report`` ``--check`` and ``--json`` on each
    run directory: the check passes, the report renders; a training run's
    report has a train section, ``mfu_run``'s an MFU against the card."""
    from induction_network_on_fewrel_tpu_torch.tools import obs_report

    out = {}
    for run in runs:
        rc, text, err = quiet_cli(obs_report.main, [run, "--check"])
        if rc:
            raise AssertionError(f"18c: obs_report --check {run}: rc {rc}: {text} {err[-2000:]}")
        rc, text, err = quiet_cli(obs_report.main, [run, "--json"])
        report = json.loads(text)
        sections = sorted(k for k, v in report.items() if v and k not in ("run_dir", "schema"))
        out[run] = {"records": report["schema"]["records"], "sections": sections}
        if any(r["kind"] == "train" for r in obs_report.load_records(Path(run) / "metrics.jsonl")) \
                and not report["train"]:
            raise AssertionError(f"18c: no train section in the report of {run}")
        if run == mfu_run:
            mfu = report["mfu"] or {}
            if not isinstance(mfu.get("mfu"), float) or mfu.get("device_kind") != \
                    torch.cuda.get_device_name(0):
                raise AssertionError(f"18c: the mfu section of {run}: {mfu}")
            out[run]["mfu"] = mfu
    print(f"[tools 18c] obs_report --check and --json on {len(runs)} run directories: "
          + "; ".join(f"{Path(r).relative_to(TOOLS_DIR)} {v['records']} records"
                      for r, v in out.items())
          + f"; 18a's mfu {out[mfu_run]['mfu']}", flush=True)
    return out


def tools_phase(smi: str, earlier: list) -> dict:
    """Phase 18: the converter, the zoo sweep and the run report on the
    card; ``earlier``: phases 15-17's kept run directories."""
    t0 = time.monotonic()
    for d in ("lazy", "converted", "shared", *(f"zoo_{m}" for m in ZOO_TOOL_MODELS)):
        shutil.rmtree(TOOLS_DIR / d, ignore_errors=True)
    a = tools_convert(smi)
    b = tools_zoo()
    runs = [*a["runs"], *(str(TOOLS_DIR / f"zoo_{m}") for m in ZOO_TOOL_MODELS), *earlier]
    c = tools_report(runs, a["runs"][0])
    out = {"card": smi, "a_convert": a, "b_zoo": b, "c_report": c,
           "seconds": round(time.monotonic() - t0, 1)}
    print(f"[tools] phase 18: {out['seconds']} s (limit {TOOLS_SECONDS} s; {smi})", flush=True)
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    if out["seconds"] > TOOLS_SECONDS:
        raise AssertionError(f"phase 18 took {out['seconds']} s > {TOOLS_SECONDS} s")
    return out


def tokenize_rows(tok, instances) -> dict[str, np.ndarray]:
    ts = [tok(i) for i in instances]
    return {k: np.stack([getattr(t, k) for t in ts]).astype(dt)
            for k, dt in QUERY_DTYPES.items()}


def serving_main_path() -> dict:
    """Phases 4 and 5: the flagship served through ``InferenceEngine``
    (the main path) and the episode forward, each against the plain
    backends."""
    # 4. Main path
    cfg = ExperimentConfig()                            # flagship defaults
    vocab = make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim)
    tok = GloveTokenizer(vocab, max_length=cfg.max_length)
    ds = make_synthetic_fewrel(
        num_relations=5, instances_per_relation=60, vocab_size=cfg.vocab_size - 2,
        sentence_len=(10, 60), seed=0,
    )
    n_long = sum(len(i.tokens) > cfg.max_length for v in ds.instances.values() for i in v)
    if n_long == 0:
        raise AssertionError("no support/query sentence exceeds max_length")
    queries = [i for rel in ds.rel_names for i in ds.instances[rel][cfg.k:cfg.k + 13]]
    plan = [1] * 16 + [4] * 4 + [16] * 2                 # 64 requests
    batches, pos = [], 0
    for size in plan:
        batches.append(queries[pos:pos + size])
        pos += size

    model = build_model(cfg, glove_init=vocab.vectors)  # device None -> cuda
    torch.cuda.synchronize()
    bilstm_infer_cuda.launches = 0
    attn_fwd_cuda.launches = 0
    engine = InferenceEngine(model, cfg, tok, k=cfg.k)
    engine.register_dataset(ds)
    made = engine.warmup()
    verdicts = [engine.classify_batch(b) for b in batches]
    torch.cuda.synchronize()
    launches = {"K1": bilstm_infer_cuda.launches, "K2": attn_fwd_cuda.launches}
    served = engine.stats.served
    print(f"[main] served {served} requests in {engine.stats.batches} batches as CUDA-graph "
          f"replays ({made} query programs, {engine.programs.captures} graphs captured at "
          f"warmup); wrapper launches (distil, warm-ups, captures) {launches}; "
          f"{n_long} sentences truncated at L={cfg.max_length}", flush=True)
    if served < 32 or min(launches.values()) == 0 or engine.stats.steady_compiles:
        raise AssertionError(f"main path did not go through both kernels: {launches}")
    engine.close()

    ref_cfg = cfg.replace(lstm_backend="reference", attn_backend="reference")
    ref_model = build_model(ref_cfg, glove_init=vocab.vectors)
    ref_model.load_state_dict(model.state_dict())
    ref_engine = InferenceEngine(ref_model, ref_cfg, tok, k=cfg.k)
    ref_engine.register_dataset(ds)
    ref_engine.warmup()
    ref_verdicts = [ref_engine.classify_batch(b) for b in batches]
    ref_engine.close()
    names = engine.class_names

    def logit_matrix(vs):
        return np.array([[v["logits"][n] for n in names] for batch in vs for v in batch])

    got, want = logit_matrix(verdicts), logit_matrix(ref_verdicts)
    if not np.isfinite(got).all():
        raise AssertionError("non-finite logits on the main path")
    scale = float(np.abs(want).max())
    logit_err = float(np.abs(got - want).max())
    mat_err = (engine.registry.snapshot().matrix - ref_engine.registry.snapshot().matrix)
    mat_err = mat_err.abs().max().item()
    print(f"[main] logits vs plain backends: max abs err {logit_err:.3g} at logit "
          f"scale {scale:.3g} (rel tol {LOGIT_REL_TOL}); class matrix max abs err "
          f"{mat_err:.3g}", flush=True)
    if logit_err > LOGIT_REL_TOL * scale:
        raise AssertionError(f"main-path logits disagree: {logit_err} > {LOGIT_REL_TOL}*{scale}")
    by_bucket: dict[int, list[float]] = {}
    for batch in verdicts:
        for v in batch:
            by_bucket.setdefault(v["bucket"], []).append(v["latency_ms"])
    main_latency = {}
    for bkt in sorted(by_bucket):
        lat = np.array(by_bucket[bkt])
        main_latency[bkt] = round(float(np.percentile(lat, 50)), 3)
        print(f"[main] bucket {bkt}: {len(lat)} requests, request latency ms "
              f"p50 {np.percentile(lat, 50):.3f} max {lat.max():.3f}", flush=True)
    print(f"[main] host ms per batch (tokenize per request): {engine.host_split.ms()}",
          flush=True)

    # 5. Episode forward (B=4, N=5, K=5, Q=5 -> 200 encoder rows)
    B, N, K, Q = cfg.batch_size, cfg.n, cfg.k, cfg.q
    sup_inst = [ds.instances[rel][b * K + k] for b in range(B) for rel in ds.rel_names
                for k in range(K)]
    qry_inst = [ds.instances[rel][30 + b * Q + q] for b in range(B) for rel in ds.rel_names
                for q in range(Q)]
    support = {k: v.reshape(B, N, K, -1) for k, v in tokenize_rows(tok, sup_inst).items()}
    query = {k: v.reshape(B, N * Q, -1) for k, v in tokenize_rows(tok, qry_inst).items()}
    with torch.inference_mode():
        ep = model(to_device(support, "cuda"), to_device(query, "cuda"))
        ep_ref = ref_model(to_device(support, "cuda"), to_device(query, "cuda"))
    if tuple(ep.shape) != (B, N * Q, N) or not torch.isfinite(ep).all():
        raise AssertionError(f"episode logits: shape {tuple(ep.shape)}, finite check failed")
    ep_err = (ep - ep_ref).abs().max().item()
    ep_scale = ep_ref.abs().max().item()
    print(f"[episode] logits {tuple(ep.shape)} vs plain backends: max abs err "
          f"{ep_err:.3g} at scale {ep_scale:.3g} (rel tol {LOGIT_REL_TOL})", flush=True)
    if ep_err > LOGIT_REL_TOL * ep_scale:
        raise AssertionError(f"episode logits disagree: {ep_err} > {LOGIT_REL_TOL}*{ep_scale}")
    return {"cfg": cfg, "model": model, "support": support, "query": query,
            "launches": launches, "main_latency": main_latency}


# --- Phase 19: data parallel over torch.distributed ---------------------------------

DP_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_dp"
DP_STEPS = 16                           # four replays of steps_per_call 4
DP_ARGV = ["--synthetic", "--bf16", "--token_cache", "--embed_optimizer", "lazy",
           "--steps_per_call", "4", "--train_iter", str(DP_STEPS), "--val_step", str(DP_STEPS),
           "--val_iter", "40"]
DP_FLAGS = ["--dp", "1", "--zero_opt", "--grad_bucketing", "on", "--compact_demb", "on"]
DP_TEST_ARGV = ["--synthetic", "--bf16", "--token_cache", "--test_iter", "40", "--dp", "1"]
DP_ON = ("K7", "K8", "K10", "K11", "wgrad", "optim_sumsq", "optim_update")
# 19b: two gloo ranks on the one card, eager steps, f32 at the flagship
# widths, 3 steps each case from the seed's weights, held to one process
# on the global batch of 4 episodes (JAX's bar, tests/test_comms.py:124-131).
DP_B_CASES = ("monolithic", "compact", "bucketed", "zero1")
DP_B_STEPS = 3
DP_B_TOL = 1e-5
DP_CHILD_SECONDS = {"19a": 240, "19b": 240}
DP_SECONDS = 120


# The parts a torchrun child runs (``chip_smoke.py --dp19a OUT [--dp20a OUT2]``),
# where each writes its result, and the labels its lines start with.
DP_PARTS = {"19a": ("dp19a_main", DP_DIR, "19a"), "19b": ("dp19b_main", DP_DIR, "19b"),
            "20a": ("dp20a_main", None, "20b"), "20b": ("dp20b_main", None, "20c"),
            "21a": ("dp21a_main", None, "21a"), "21b": ("dp21_gloo_main", None, "21"),
            "21c": ("dp21_gloo_main", None, "21"), "22b": ("dp22_gloo_main", None, "22 23"),
            "22c": ("dp22_gloo_main", None, "22 23")}


def dp_child_main(argv: list) -> int:
    """One torchrun rank: the parts ``argv`` names (``--dp19a OUT --dp20a
    OUT2 ...``) in turn, each writing its JSON result to its OUT; the
    kernels loaded once, the process group left once, at the end (a
    child's start costs ~20 s: phases 19 and 20 share their children)."""
    from induction_network_on_fewrel_tpu_torch.parallel.distributed import shutdown

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    LIBRARY.build()
    SAMPLER_LIBRARY.build()
    for flag, out in zip(argv[::2], argv[1::2]):
        globals()[DP_PARTS[flag[len("--dp"):]][0]](out)
    shutdown()
    return 0


def dp_child(parts: list, nproc: int) -> dict:
    """``torchrun --nproc_per_node nproc chip_smoke.py --dp<part> OUT ...``
    (one child for all of ``parts``) in a session of its own, killed whole
    at the sum of the parts' bounds; each part's lines, then its JSON
    result (rank 0's), by part."""
    outs = {}
    for part in parts:
        out_dir = DP_PARTS[part][1] or {"20": DP20_DIR, "21": DP21_DIR, "22": DP22_DIR}[part[:2]]
        out_dir.mkdir(parents=True, exist_ok=True)
        outs[part] = out_dir / f"{part}.json"
        outs[part].unlink(missing_ok=True)
    bound_s = sum({**DP_CHILD_SECONDS, **DP20_CHILD_SECONDS, **DP21_CHILD_SECONDS,
                   **DP22_CHILD_SECONDS}[p] for p in parts)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc), str(Path(__file__).resolve())]
    for part in parts:
        cmd += [f"--dp{part}", str(outs[part])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=bound_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        text, _ = proc.communicate()
        print(text[-4000:], flush=True)
        raise AssertionError(f"phase {parts}: the ranks overran {bound_s} s")
    labels = tuple(f"[{lab}" for p in parts for lab in DP_PARTS[p][2].split())
    keep = [ln for ln in text.splitlines() if ln.startswith(labels)]
    print("\n".join(keep), flush=True)
    if proc.returncode != 0 or not all(o.exists() for o in outs.values()):
        print(text[-6000:], flush=True)
        raise AssertionError(f"phase {parts}: torchrun exited {proc.returncode}")
    return {p: json.loads(o.read_text()) for p, o in outs.items()}


def full_moments(opt):
    """(model-free) the optimizer as ``hold_state`` reads it, its moments
    gathered whole (ZeRO-1's chunks)."""
    import types

    state = opt.state_dict()
    return types.SimpleNamespace(params=opt.params, mu=state["mu"], nu=state["nu"],
                                 count=opt.count)


def dp19a_main(out_path: str) -> int:
    """19a, one rank of ``torchrun --nproc_per_node 1``: the flagship (400 002
    x 50 table, bf16, W=8, token cache, lazy Adam) through ``cli.make_trainer``
    with a world-size-1 NCCL mesh (``--dp 1 --zero_opt --grad_bucketing on
    --compact_demb on``; every collective captured in the replay) and the
    same run without a mesh, DP_STEPS steps each as replays of 4; held at
    ``hold_state``'s bars; launches per step under the profiler, the
    collectives each replay issues (``COLLECTIVES`` counted across the
    capture, held to ``DataParallel.plan``), no capture after the warm-up,
    ms/step beside the plain run; then ``cli.test_main`` on the dp run's
    checkpoint under the mesh."""
    t0 = time.monotonic()
    shutil.rmtree(DP_DIR / "dp", ignore_errors=True)
    shutil.rmtree(DP_DIR / "plain", ignore_errors=True)
    args = cli.parse_args(True, DP_ARGV + DP_FLAGS + ["--save_ckpt", str(DP_DIR / "dp")])
    cfg = cli.config_from_args(args)
    mesh = cli.dp_mesh(args, cfg)
    if mesh is None or mesh.backend != "nccl" or mesh.dp != 1:
        raise AssertionError(f"19a: expected a world-size-1 NCCL mesh, got {mesh}")
    dp = cli.make_trainer(args, cfg, mesh=mesh)[0]
    pargs = cli.parse_args(True, DP_ARGV + ["--save_ckpt", str(DP_DIR / "plain")])
    plain = cli.make_trainer(pargs, cli.config_from_args(pargs))[0]
    spc = dp.cfg.steps_per_call
    for t in (dp, plain):
        t.metric_window = spc                    # a [train] record per replay
    table0 = dp.model.embedding.word_embedding.detach().clone()
    if not torch.equal(table0, plain.model.embedding.word_embedding.detach()):
        raise AssertionError("19a: the two runs start from different weights")
    watcher = stamped_watcher()
    runs = {}
    for tag, t in (("plain", plain), ("dp", dp)):
        zero_kernel_counts()
        with contextlib.redirect_stderr(io.StringIO()):
            t.train(DP_STEPS)
        torch.cuda.synchronize()
        runs[tag] = {"wrappers": kernel_counts(), "records": train_records(t.logger.path)}
    missing = [k for k in DP_ON + LAZY_KERNELS + ("K1", "K2") if not runs["dp"]["wrappers"][k]]
    if missing:
        raise AssertionError(f"19a: kernels of the path never launched under dp: {missing}")
    losses = {tag: np.array([r["loss"] for r in r_["records"]]) for tag, r_ in runs.items()}
    loss_rel = float(np.max(np.abs(losses["dp"] - losses["plain"]) / np.abs(losses["plain"])))
    if loss_rel > GRAPH_PARAM_TOL:
        raise AssertionError(f"19a: losses rel {loss_rel:.3g} > {GRAPH_PARAM_TOL}")
    held = hold_state("19a NCCL world 1 vs no process group", (dp.model, full_moments(dp.opt)),
                      (plain.model, plain.opt), table0)
    lazy_rel = max(rel_err(getattr(dp.lazy, k).float(), getattr(plain.lazy, k).float())[1]
                   for k in ("m", "v"))
    if lazy_rel > SEGSUM_TOL or not torch.equal(dp.lazy.last, plain.lazy.last):
        raise AssertionError(f"19a: the lazy table's moments rel {lazy_rel:.3g}")
    captures = len(watcher.stamps)
    prof = {tag: profile_graph_steps(t, DP_ON, calls=8, tag=f"19a profile {tag}",
                                     per_call=LAZY_KERNELS) for tag, t in (("plain", plain),
                                                                           ("dp", dp))}
    if len(watcher.stamps) != captures:
        raise AssertionError(f"19a: captures after the warm-up: {watcher.stamps[captures:]}")
    watcher.uninstall()
    graphs = list(dp.multi_train_step.graphs.values())
    for g in graphs:
        S = g.out.shape[0]
        if g.collectives != dp.dp.plan(S):
            raise AssertionError(f"19a: a replay of {S} steps issues {g.collectives}, the plan "
                                 f"is {dp.dp.plan(S)}")
    issued = {k: n / spc for k, n in graphs[0].collectives.items()}
    per_step = {k: n / spc for k, n in prof["dp"]["per_replay"].items()}
    rc, out, err = quiet_cli(cli.test_main, DP_TEST_ARGV + ["--load_ckpt", str(DP_DIR / "dp")])
    test = json.loads(out.strip().splitlines()[-1]) if rc == 0 else None
    if rc != 0 or not 0.0 <= test["test_accuracy"] <= 1.0:
        raise AssertionError(f"19a: cli test under the mesh: rc {rc}: {err[-2000:]}")
    zero = dp.opt.zero
    res = {"world": 1, "backend": "nccl", "steps": DP_STEPS, "steps_per_call": spc,
           "loss_rel": loss_rel, "held": held, "lazy_moments_rel": lazy_rel,
           "collectives_per_step": issued, "nccl_kernels_per_step": prof["dp"]["nccl_per_step"],
           "launches_per_step": per_step, "captures_after_warmup": 0,
           "graph_ms_per_step": prof["dp"]["step_ms"], "plain_ms_per_step": prof["plain"]["step_ms"],
           "busy_ms": prof["dp"]["busy_ms"], "plain_busy_ms": prof["plain"]["busy_ms"],
           "launches_graph": prof["dp"]["launches"], "plain_launches_graph": prof["plain"]["launches"],
           "zero1_sharded_leaves": len(zero.shards), "test": test,
           "seconds": round(time.monotonic() - t0, 1)}
    print(f"[19a] world 1 over NCCL (--dp 1 --zero_opt --grad_bucketing on --compact_demb on), "
          f"{DP_STEPS} steps as replays of {spc}: losses rel {loss_rel:.3g} of the run without a "
          f"process group; collectives issued per step, counted across the capture {issued} "
          f"(= the plan; {prof['dp']['nccl_per_step']:.2f} NCCL kernels per step under the "
          f"profiler); {prof['dp']['step_ms']:.3f} ms/step vs "
          f"{prof['plain']['step_ms']:.3f} without dp; no capture after the warm-up; test "
          f"accuracy {test['test_accuracy']} under the mesh; {res['seconds']} s", flush=True)
    for t in (dp, plain):
        close_trainer(t)
    Path(out_path).write_text(json.dumps(res, default=str))
    return 0


def dp_b_payload(cfg) -> dict:
    """19b's world: the synthetic train split at the flagship widths on a
    400 002-word synthetic vocabulary, DP_B_STEPS global index batches of
    ``cfg.batch_size`` episodes (the same in every rank: seeds)."""
    from induction_network_on_fewrel_tpu_torch.sampling.index import IndexEpisodeSampler
    from induction_network_on_fewrel_tpu_torch.train.token_cache import tokenize_dataset

    vocab = make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim)
    table, sizes = tokenize_dataset(cli.load_data(cfg, "train"),
                                    GloveTokenizer(vocab, max_length=cfg.max_length))
    idx = IndexEpisodeSampler(sizes, cfg.train_n, cfg.k, cfg.q, batch_size=cfg.batch_size, seed=0)
    batches = []
    for _ in range(DP_B_STEPS):
        si, qi, lab = idx.sample_fused(1)
        batches.append((si[0], qi[0], lab[0]))
    return {"cfg": {k: getattr(cfg, k) for k in ("compute_dtype", "token_cache", "embed_optimizer",
                                                 "batch_size", "ckpt_stage")},
            "weights": None, "table": table, "sizes": sizes, "batches": batches,
            "device": "cuda", "cases": list(DP_B_CASES)}


def dp19b_main(out_path: str) -> int:
    """19b, a rank of ``torchrun --nproc_per_node 2``: two gloo ranks on the
    one card (NCCL puts no two ranks on one device), eager steps; each case
    of DP_B_CASES trains DP_B_STEPS steps of the flagship token-cache lazy
    step at f32 from the seed's weights, each rank on its half of every
    global batch; rank 0 then runs the one-process reference on the global
    batches and holds every case to it (losses and parameters within
    DP_B_TOL, gradient norms at rtol DP_B_TOL, the moments, the lazy rows'
    included, within DP_B_TOL of each leaf's scale), the ranks' replicas to
    each other, and the collectives each step issued (counted around the
    steps) to the case's plan."""
    import torch.distributed as dist

    from induction_network_on_fewrel_tpu_torch.parallel import rig
    from induction_network_on_fewrel_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
    )
    from induction_network_on_fewrel_tpu_torch.parallel.mesh import make_mesh

    t0 = time.monotonic()
    torch.cuda.set_device(0)
    maybe_initialize_distributed(backend="gloo", timeout_s=120)
    mesh = make_mesh()
    cfg = ExperimentConfig(compute_dtype="float32", token_cache=True, embed_optimizer="lazy",
                           ckpt_stage="off")
    payload = dp_b_payload(cfg)
    zero_kernel_counts()
    got = rig.run_cases(payload, mesh)
    counts = kernel_counts()
    mine = {c: {"params": r["params"], "issued": r["issued_per_step"], "plan": r["plan"]}
            for c, r in got.items()}
    other = [None, None]
    dist.gather_object(mine, other if mesh.rank == 0 else None, dst=0)
    if mesh.rank != 0:
        return 0
    ref = rig.run_cases({**payload}, None)["monolithic"]
    res = {"world": 2, "backend": "gloo", "device": torch.cuda.get_device_name(0),
           "steps": DP_B_STEPS, "global_batch": cfg.batch_size, "cases": {}}
    for case, r in got.items():
        loss_err = float(np.abs(np.array(r["losses"]) - ref["losses"]).max())
        # np.testing.assert_allclose(atol=rtol=DP_B_TOL)'s measure: the
        # largest |got - want| - DP_B_TOL |want| must stay within DP_B_TOL.
        param_err = max(float(np.max(np.abs(r["params"][k] - ref["params"][k])
                                     - DP_B_TOL * np.abs(ref["params"][k])))
                        for k in ref["params"])
        norm_rel = float(np.max(np.abs(np.array(r["grad_norms"]) - ref["grad_norms"])
                                / np.array(ref["grad_norms"])))
        # Each moment leaf within DP_B_TOL of its scale (the lazy rows' too).
        moment_rel = max(float(np.max(np.abs(r["moments"][k] - w)) / max(np.abs(w).max(), 1e-30))
                         for k, w in ref["moments"].items())
        ranks_equal = all(np.array_equal(r["params"][k], other[1][case]["params"][k])
                          for k in r["params"])
        issued_ok = all(o[case]["issued"] == o[case]["plan"] for o in other)
        if (loss_err > DP_B_TOL or param_err > DP_B_TOL or norm_rel > DP_B_TOL
                or moment_rel > DP_B_TOL or not ranks_equal or not issued_ok
                or set(r["moments"]) != set(ref["moments"])):
            raise AssertionError(
                f"19b {case}: losses {loss_err:.3g}, params {param_err:.3g}, grad norms rel "
                f"{norm_rel:.3g}, moments rel {moment_rel:.3g} (tol {DP_B_TOL}), ranks equal "
                f"{ranks_equal}, collectives issued {[o[case]['issued'] for o in other]} vs "
                f"plan {r['plan']}")
        res["cases"][case] = {"loss_abs_err": loss_err, "param_err": param_err,
                              "grad_norm_rel": norm_rel, "moment_rel": moment_rel,
                              "collectives_per_step": r["issued_per_step"],
                              "eager_s": r["seconds"]}
        print(f"[19b] {case}: two gloo ranks on the card vs one process on the global batch, "
              f"{DP_B_STEPS} steps: losses within {loss_err:.3g}, parameters within "
              f"{param_err:.3g}, grad norms rel {norm_rel:.3g}, moments ({len(r['moments'])} "
              f"leaves, the lazy rows' included) rel {moment_rel:.3g} of scale (tol "
              f"{DP_B_TOL}); replicas equal; collectives issued per step, counted on both "
              f"ranks {r['issued_per_step']} (= the plan); {r['seconds']:.2f} s", flush=True)
    steps = DP_B_STEPS * len(got)
    res["launches_per_step"] = {k: n / steps for k, n in counts.items()}
    res["zero1_shards"] = len(got["zero1"]["zero_shards"]) if "zero1" in got else None
    res["seconds"] = round(time.monotonic() - t0, 1)
    print(f"[19b] rank 0 wrapper launches per step (eager: every call launches) "
          f"{res['launches_per_step']}; {res['seconds']} s", flush=True)
    Path(out_path).write_text(json.dumps(res, default=str))
    return 0


# --- Phase 20: the rest of data parallel -----------------------------------------

DP20_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_dp20"
# 20a: the flagship engine of phase 4 at dp=2, both shards on the one card
# (the ``devices`` seam of make_serving_mesh), beside the same engine at
# dp=None: 64 requests in buckets 1, 4 and 16 per resident dtype.
DP20_DEVICES = ("cuda:0", "cuda:0")
DP20_BUCKETS = (1, 4, 16)
DP20_PLAN = [1] * 16 + [4] * 4 + [16] * 2
DP20_RESIDENT = ("f32", "bf16", "int8")
# dp against dp=None: the same kernels on row chunks, the same resident
# matrix: 1e-5 of the logit scale at f32 resident, phase 4's bars at bf16
# and int8 (RESIDENT_REL_TOL).
DP20_TOL = 1e-5
DP20_LOAD_ARGV = ["--duration", "1", "--serving_dp", "1", "--mode", "closed",
                  "--scheduler", "continuous"]
# 20b: world size 1 over NCCL against the run without a group, one replay
# of 4 steps each (held at hold_state's bars: the shared table's gradient is
# index_add_'s f32 atomics, whose order changes from run to run, and over 8
# steps the adversarial step's three table gradients a step put held table
# elements 1.02e-6 of scale apart on the H100): --adv at the flagship config,
# --mixture over two FewRel-format files, --feature_cache at BERT-base.
DP20_STEPS = 4
DP20_B_TOL = 1e-6
DP20_ADV_ARGV = ["--synthetic", "--bf16", "--adv", "--steps_per_call", "4",
                 "--train_iter", str(DP20_STEPS), "--val_step", "1000", *TODAY]
DP20_MIX_ARGV = ["--synthetic", "--bf16", "--steps_per_call", "4", "--train_iter",
                 str(DP20_STEPS), "--val_step", "1000", *TODAY]
DP20_CACHE_ARGV = ["--synthetic", "--bf16", "--encoder", "bert", "--bert_frozen",
                   "--feature_cache", "--batch_size", "2", "--steps_per_call", "4",
                   "--train_iter", str(DP20_STEPS), "--val_step", "1000", *TODAY]
DP20_MIX_FILES = {"mix_a": 5, "mix_b": 6}          # file -> generator seed
# 20c: two gloo ranks on the card, eager, f32 at the flagship widths (BERT-base
# for the cache), 3 steps of each path held to one process on the global
# batch; the mixture 2 + 2 steps through the CLI with a resume from its ring
# slot. The adversarial and the mixture runs keep the word table on plain
# SGD: two sums of its gradient (index_add_'s f32 atomics; two ranks' partial
# sums against one) then differ by rounding, where Adam steps an element
# whose gradient was within rounding of zero at some step by +-lr either way
# (1.45e-3 apart in 2 of 6 runs on the H100 with Adam on the table).
DP20_C_STEPS = 3
DP20_C_TOL = 1e-5
DP20_C_MIX_ARGV = ["--synthetic", "--embed_optimizer", "sgd", "--sampler", "python",
                   "--prefetch_depth", "0", "--val_step", "1000", "--mixture",
                   "train:1;synthetic:1"]
DP20_CHILD_SECONDS = {"20a": 300, "20b": 300}
DP20_SECONDS = 90


def dp20_logits(verdicts: list, names) -> np.ndarray:
    return np.array([[v["logits"][n] for n in names] for batch in verdicts for v in batch])


def serving_dp_engines(tag: str, smi: str) -> dict:
    """20a's engines: the flagship engine at dp=2 over two shards on the one
    card beside dp=None: per resident dtype 64 requests in buckets 1, 4 and
    16 (a bucket of 1 does not divide: the single-device program), logits
    held at DP20_TOL of scale (f32) and RESIDENT_REL_TOL (bf16, int8); one
    graph per (key, bank, shard) at warmup and none after; K1 and K2
    launched twice per graph (the eager warm-up and the capture); a
    publish under dp scores as the single engine after the same publish;
    p50 per bucket."""
    from induction_network_on_fewrel_tpu_torch.serving.registry import DEFAULT_TENANT

    t0 = time.monotonic()
    cfg = ExperimentConfig()
    vocab = make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim)
    tok = GloveTokenizer(vocab, max_length=cfg.max_length)
    ds = make_synthetic_fewrel(num_relations=5, instances_per_relation=60,
                               vocab_size=cfg.vocab_size - 2, sentence_len=(10, 60), seed=0)
    queries = [i for rel in ds.rel_names for i in ds.instances[rel][cfg.k:cfg.k + 13]]
    batches, pos = [], 0
    for size in DP20_PLAN:
        batches.append(queries[pos:pos + size])
        pos += size
    model = build_model(cfg, glove_init=vocab.vectors)
    t_setup = time.monotonic() - t0
    single = InferenceEngine(model, cfg, tok, k=cfg.k, buckets=DP20_BUCKETS)
    single.register_dataset(ds)
    single.warmup()
    zero_kernel_counts()
    dp = InferenceEngine(copy.deepcopy(model), cfg, tok, k=cfg.k, buckets=DP20_BUCKETS, dp=2,
                         devices=DP20_DEVICES)
    dp.register_dataset(ds)
    distil = kernel_counts()
    made = dp.warmup()
    torch.cuda.synchronize()
    warm = count_delta(kernel_counts(), distil)
    graphs = dp.programs.captures
    want_graphs = sum(2 * (2 if b % 2 == 0 else 1) for b in DP20_BUCKETS)
    if graphs != want_graphs or warm["K1"] != 2 * graphs or warm["K2"] != 2 * graphs:
        raise AssertionError(f"{tag}: {graphs} graphs at warmup (want {want_graphs}), K1/K2 "
                             f"launches {warm['K1']}/{warm['K2']} (want 2 a graph)")
    names = dp.class_names
    out: dict = {"card": smi, "graphs_at_warmup": graphs, "programs": made,
                 "single_graphs_at_warmup": single.programs.captures, "dtypes": {}}
    for dtype in DP20_RESIDENT:
        if dtype != "f32":
            for e in (single, dp):
                e.set_resident_dtype(DEFAULT_TENANT, dtype)
        before = (single.programs.captures, dp.programs.captures)
        got = [dp.classify_batch(b) for b in batches]
        want = [single.classify_batch(b) for b in batches]
        torch.cuda.synchronize()
        if (single.programs.captures, dp.programs.captures) != before \
                or dp.stats.steady_compiles or single.stats.steady_compiles:
            raise AssertionError(f"{tag} {dtype}: captures after warmup: {before} -> "
                                 f"{(single.programs.captures, dp.programs.captures)}")
        g, w = dp20_logits(got, names), dp20_logits(want, names)
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        bar = DP20_TOL if dtype == "f32" else RESIDENT_REL_TOL[dtype]
        labels = sum(a["label"] == b["label"] for x, y in zip(got, want) for a, b in zip(x, y))
        if not np.isfinite(g).all() or err > bar * scale:
            raise AssertionError(f"{tag} {dtype}: dp logits {err:.3g} from dp=None at scale "
                                 f"{scale:.3g} (bar {bar} of scale)")
        p50 = {}
        for which, vs in (("dp", got), ("single", want)):
            by: dict = {}
            for batch in vs:
                for v in batch:
                    by.setdefault(v["bucket"], []).append(v["latency_ms"])
            p50[which] = {b: round(float(np.percentile(x, 50)), 4) for b, x in sorted(by.items())}
        out["dtypes"][dtype] = {"max_abs_err": err, "scale": scale, "bar_rel": bar,
                                "labels_equal": labels, "requests": len(queries[:pos]),
                                "p50_ms": p50, "graphs": dp.programs.captures}
        print(f"[{tag}] {dtype} resident: {pos} requests in buckets {DP20_BUCKETS} on dp=2 "
              f"(two shards on the card) vs dp=None: logits max abs err {err:.3g} at scale "
              f"{scale:.3g} (bar {bar} of scale), {labels}/{pos} labels equal; request p50 ms "
              f"by bucket dp {p50['dp']} vs dp=None {p50['single']}; graphs "
              f"{dp.programs.captures} (none after warmup); {smi}", flush=True)
    for e in (single, dp):
        e.set_resident_dtype(DEFAULT_TENANT, "f32")
    t_traffic = time.monotonic() - t0
    # New weights: every floating tensor 1 % larger (a publish moves them all).
    new = {k: v * 1.01 if v.is_floating_point() else v for k, v in model.state_dict().items()}
    before = dp.programs.captures
    versions = (single.publish_params(new), dp.publish_params(new))
    got = [dp.classify_batch(b) for b in batches[-6:]]
    want = [single.classify_batch(b) for b in batches[-6:]]
    g, w = dp20_logits(got, names), dp20_logits(want, names)
    pub_err, pub_scale = float(np.abs(g - w).max()), float(np.abs(w).max())
    if versions != (1, 1) or dp.programs.captures != before or pub_err > DP20_TOL * pub_scale:
        raise AssertionError(f"{tag}: publish under dp: versions {versions}, captures "
                             f"{before} -> {dp.programs.captures}, logits {pub_err:.3g} at "
                             f"scale {pub_scale:.3g}")
    launches = kernel_counts()
    for e in (single, dp):
        e.close()
    del single, dp, model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{tag}] publish_params under dp=2: params_version {versions[1]}, no capture, the "
          f"next {len(got)} batches within {pub_err:.3g} of dp=None at scale {pub_scale:.3g}; "
          f"K1/K2 wrapper launches {warm['K1']}/{warm['K2']} at the warmup of {graphs} graphs "
          f"(2 a graph: its eager warm-up and its capture)", flush=True)
    out.update(publish={"max_abs_err": pub_err, "scale": pub_scale},
               launches={k: v for k, v in launches.items() if v}, warm_launches=warm,
               seconds={"setup": round(t_setup, 1),
                        "engines_and_traffic": round(t_traffic - t_setup, 1),
                        "publish": round(time.monotonic() - t0 - t_traffic, 1)})
    return out


def serving_dp_phase(smi: str) -> dict:
    """20a: ``serving_dp_engines``; ``serve_main --dp 2`` in a child process
    (python, torch and the card's start-up, ~10 s, meanwhile), refused with
    the "exceeds" text; a 1 s load-tool arm at ``--serving_dp 1``."""
    tag = "20a"
    t0 = time.monotonic()
    child = subprocess.Popen([sys.executable, "-m",
                              "induction_network_on_fewrel_tpu_torch.serving.cli", "--dp", "2"],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             cwd=str(Path(__file__).resolve().parent))
    try:
        out = serving_dp_engines(tag, smi)
        _, err = child.communicate(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    n = torch.cuda.device_count()
    if child.returncode != 2 or f"exceeds the {n} visible devices" not in err:
        raise AssertionError(f"{tag}: serve_main --dp 2 exited {child.returncode}: {err[-2000:]}")
    refusal = err.strip().splitlines()[-1]
    print(f"[{tag}] serve_main --dp 2 on {n} card(s): rc 2, {refusal!r}", flush=True)
    t_load = time.monotonic()
    out["load"] = dp20_load_arm()
    out["seconds"].update(serve_main_wait=round(t_load - t0 - sum(out["seconds"].values()), 1),
                          load_arm=round(time.monotonic() - t_load, 1))
    out["serve_main_dp2"] = {"rc": child.returncode, "stderr": refusal}
    print(f"[{tag}] seconds {out['seconds']}", flush=True)
    return out


def dp20_load_arm() -> dict:
    """A 1 s closed-loop arm of the load tool at ``--serving_dp 1`` on its
    synthetic checkpoint."""
    from induction_network_on_fewrel_tpu_torch.load.harness import (
        build_engine,
        check_serving_dp,
        drive_one,
        make_synthetic_checkpoint,
        parse_args,
    )

    args = parse_args(DP20_LOAD_ARGV)
    check_serving_dp(args)
    ckpt_dir = DP20_DIR / "load_ckpt"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    with contextlib.redirect_stderr(io.StringIO()):
        ckpt = make_synthetic_checkpoint(args, str(ckpt_dir))
        engine = build_engine(args, ckpt, "continuous")
        try:
            r = drive_one(engine, args, np.random.default_rng(args.seed))
        finally:
            engine.close()
    st = r["stats"]
    if r["closed"]["errors"] or st["shed"] or st["steady_recompiles"]:
        raise AssertionError(f"20a load arm: {json.dumps(r, default=str)[:2000]}")
    print(f"[20a] load tool --serving_dp 1, 1 s closed: {r['closed']['qps']} served/s, p50 "
          f"{r['closed']['p50_ms']} ms, p99 {r['closed']['p99_ms']} ms, errors 0, steady "
          f"recompiles 0", flush=True)
    return {"closed": r["closed"], "stats": {k: st[k] for k in ("shed", "steady_recompiles")}}


def dp20_mix_files() -> str:
    """Two FewRel-format files of synthetic relations (the flagship corpus
    words); the ``--mixture`` spec over them."""
    DP20_DIR.mkdir(parents=True, exist_ok=True)
    spec = []
    for name, seed in DP20_MIX_FILES.items():
        ds = make_synthetic_fewrel(num_relations=20, instances_per_relation=40,
                                   vocab_size=REAL_CORPUS_WORDS, seed=seed)
        path = DP20_DIR / f"{name}.json"
        path.write_text(json.dumps({r: [fewrel_record(i) for i in ds.instances[r]]
                                    for r in ds.rel_names}))
        spec.append(f"{path}:1")
    return ";".join(spec)


def hold_head(tag: str, got, want) -> float:
    """Every parameter and moment of optimizer ``got`` within
    GRAPH_PARAM_TOL of ``want``'s scale (a state without a word table);
    the worst relative error."""
    worst = 0.0
    for i in range(len(want.params)):
        for a, b in ((got.params[i], want.params[i]), (got.mu[i], want.mu[i]),
                     (got.nu[i], want.nu[i])):
            if b is None:
                continue
            worst = max(worst, rel_err(a.detach().float(), b.detach().float())[1])
    if worst > GRAPH_PARAM_TOL or int(got.count) != int(want.count):
        raise AssertionError(f"{tag}: state rel {worst:.3g} > {GRAPH_PARAM_TOL}")
    return worst


def dp20_pair(tag: str, argv: list, on: tuple, per_step: dict | None = None) -> dict:
    """One path at world size 1 over NCCL (``--dp 1``) beside the same run
    without a group, DP20_STEPS steps each as replays: the path's kernels
    launched under the mesh, losses within DP20_B_TOL of scale, the state
    held, the collectives each replay issued (counted across the capture)
    equal to the plan, kernels and NCCL kernels per step under the profiler,
    no capture after the warm-up, ms/step beside the plain run."""
    t0 = time.monotonic()
    runs = {}
    trainers = {}
    for which, flags in (("plain", []), ("dp", ["--dp", "1"])):
        args = cli.parse_args(True, argv + flags + ["--run_dir", str(DP20_DIR / tag / which)])
        cfg = cli.config_from_args(args)
        mesh = cli.dp_mesh(args, cfg) if flags else None
        if which == "dp" and (mesh is None or mesh.backend != "nccl" or mesh.dp != 1):
            raise AssertionError(f"{tag}: expected a world-size-1 NCCL mesh, got {mesh}")
        with contextlib.redirect_stderr(io.StringIO()):
            trainers[which] = cli.make_trainer(args, cfg, mesh=mesh)[0]
    plain, dp = trainers["plain"], trainers["dp"]
    split = {"build": time.monotonic() - t0}
    spc = dp.cfg.steps_per_call
    for t in (plain, dp):
        t.metric_window = spc
    named = {n: p.detach().clone() for n, p in dp.model.named_parameters()}
    if any(not torch.equal(p, dict(plain.model.named_parameters())[n]) for n, p in named.items()):
        raise AssertionError(f"{tag}: the two runs start from different weights")
    watcher = stamped_watcher()
    for which, t in (("plain", plain), ("dp", dp)):
        zero_kernel_counts()
        with contextlib.redirect_stderr(io.StringIO()):
            t.train(DP20_STEPS)
        torch.cuda.synchronize()
        runs[which] = {"wrappers": kernel_counts(), "records": train_records(t.logger.path)}
    split["train"] = time.monotonic() - t0 - sum(split.values())
    missing = [k for k in on if not runs["dp"]["wrappers"][k]]
    if missing:
        raise AssertionError(f"{tag}: kernels of the path never launched under dp: {missing}")
    losses = {w: np.array([r["loss"] for r in r_["records"]]) for w, r_ in runs.items()}
    loss_rel = float(np.abs(losses["dp"] - losses["plain"]).max() / np.abs(losses["plain"]).max())
    if loss_rel > DP20_B_TOL or len(losses["dp"]) != DP20_STEPS // spc:
        raise AssertionError(f"{tag}: losses rel {loss_rel:.3g} > {DP20_B_TOL}")
    if WORD_TABLE in named:
        held = hold_state(f"{tag} NCCL world 1 vs no process group",
                          (dp.model, full_moments(dp.opt)), (plain.model, plain.opt),
                          named[WORD_TABLE])
    else:
        held = {"state_rel": hold_head(tag, full_moments(dp.opt), plain.opt)}
    if dp.adv is not None:
        held["disc_rel"] = max(rel_err(a.detach(), b.detach())[1] for a, b in zip(
            dp.adv.disc.module.parameters(), plain.adv.disc.module.parameters()))
        if held["disc_rel"] > GRAPH_PARAM_TOL:
            raise AssertionError(f"{tag}: discriminator rel {held['disc_rel']:.3g}")
    captures = len(watcher.stamps)
    split["hold"] = time.monotonic() - t0 - sum(split.values())
    prof = {w: profile_graph_steps(t, on, calls=2, tag=f"{tag} profile {w}", per_step=per_step)
            for w, t in (("plain", plain), ("dp", dp))}
    split["profile"] = time.monotonic() - t0 - sum(split.values())
    if len(watcher.stamps) != captures:
        raise AssertionError(f"{tag}: captures after the warm-up: {watcher.stamps[captures:]}")
    watcher.uninstall()
    graphs = list(dp.multi_train_step.graphs.values())
    for g in graphs:
        S = g.out.shape[0]
        if g.collectives != dp.dp.plan(S):
            raise AssertionError(f"{tag}: a replay of {S} steps issues {g.collectives}, the "
                                 f"plan is {dp.dp.plan(S)}")
    issued = {k: n / spc for k, n in graphs[0].collectives.items()}
    res = {"steps": DP20_STEPS, "steps_per_call": spc, "loss_rel": loss_rel, "held": held,
           "collectives_per_step": issued, "nccl_kernels_per_step": prof["dp"]["nccl_per_step"],
           "launches_per_step": {k: n / spc for k, n in prof["dp"]["per_replay"].items()},
           "graph_ms_per_step": prof["dp"]["step_ms"],
           "plain_ms_per_step": prof["plain"]["step_ms"], "busy_ms": prof["dp"]["busy_ms"],
           "plain_busy_ms": prof["plain"]["busy_ms"], "captures_after_warmup": 0,
           "seconds": round(time.monotonic() - t0, 1),
           "seconds_split": {k: round(v, 1) for k, v in split.items()}}
    print(f"[{tag}] world 1 over NCCL (--dp 1) vs no process group, {DP20_STEPS} steps as "
          f"replays of {spc}: losses rel {loss_rel:.3g} of scale (tol {DP20_B_TOL}); state "
          f"{held}; collectives per step, counted across the capture {issued} (= the plan; "
          f"{prof['dp']['nccl_per_step']:.2f} NCCL kernels per step under the profiler); "
          f"{prof['dp']['step_ms']:.3f} ms/step vs {prof['plain']['step_ms']:.3f} without dp; "
          f"no capture after the warm-up; {res['seconds']} s {res['seconds_split']}", flush=True)
    for t in (plain, dp):
        close_trainer(t)
    return res


def dp20a_main(out_path: str) -> int:
    """20b, one rank of ``torchrun --nproc_per_node 1``: ``--adv`` at the
    flagship config, ``--mixture`` over two FewRel-format files and
    ``--feature_cache`` at BERT-base, each through ``cli.make_trainer`` at
    world size 1 over NCCL beside the same run without a group
    (``dp20_pair``)."""
    t0 = time.monotonic()
    shutil.rmtree(DP20_DIR / "20b", ignore_errors=True)
    spec = dp20_mix_files()
    res = {"world": 1, "backend": "nccl"}
    res["adv"] = dp20_pair("20b adv", DP20_ADV_ARGV, ADV_ON, ADV_PER_STEP)
    res["mixture"] = dp20_pair("20b mixture", DP20_MIX_ARGV + ["--mixture", spec], DP_ON)
    res["cache"] = dp20_pair("20b cache", DP20_CACHE_ARGV, OPTIM_ON)
    res["seconds"] = round(time.monotonic() - t0, 1)
    print(f"[20b] {res['seconds']} s", flush=True)
    Path(out_path).write_text(json.dumps(res, default=str))
    return 0


def dp20_payload() -> dict:
    """20c's world: the flagship adversarial step at f32 (3 global batches
    of 4 episodes and 32 + 32 instances), the feature cache at BERT-base
    f32 (a 10-relation split, 3 index batches of 4 episodes), and the
    mixture through the CLI; weights from the seeds on every rank."""
    from induction_network_on_fewrel_tpu_torch.models.build import instance_inputs
    from induction_network_on_fewrel_tpu_torch.sampling.episodes import InstanceSampler
    from induction_network_on_fewrel_tpu_torch.sampling.index import IndexEpisodeSampler

    cfg = ExperimentConfig(compute_dtype="float32", adv=True)
    vocab = make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim)
    tok = GloveTokenizer(vocab, max_length=cfg.max_length)
    train_ds = cli.load_data(cfg, "train")
    tgt_ds = make_synthetic_fewrel(num_relations=max(cfg.train_n, cfg.n) * 2,
                                   instances_per_relation=max(cfg.k + cfg.q + 5, 20),
                                   vocab_size=cfg.vocab_size - 2, seed=97)
    ep = EpisodeSampler(train_ds, tok, cfg.train_n, cfg.k, cfg.q, batch_size=cfg.batch_size,
                        seed=0)
    src = InstanceSampler(train_ds, tok, cfg.adv_batch, seed=31)
    tgt = InstanceSampler(tgt_ds, tok, cfg.adv_batch, seed=32)
    adv = [batch_to_model_inputs(ep.sample_batch()) + (instance_inputs(src.sample_batch()),
                                                       instance_inputs(tgt.sample_batch()))
           for _ in range(DP20_C_STEPS)]
    data = dict(num_relations=10, instances_per_relation=20, vocab_size=2000, seed=0)
    sizes = [20] * 10
    idx = IndexEpisodeSampler(sizes, cfg.train_n, cfg.k, cfg.q, batch_size=cfg.batch_size, seed=9)
    cache = [tuple(idx.sample_batch()) for _ in range(DP20_C_STEPS)]
    return {"adv": {"cfg": {"compute_dtype": "float32", "adv": True, "embed_optimizer": "sgd"},
                    "weights": None, "disc_weights": None, "batches": adv, "device": "cuda",
                    "cases": ["adv_monolithic", "adv_zero1"]},
            "cache": {"cfg": {"compute_dtype": "float32", "encoder": "bert", "bert_frozen": True,
                              "feature_cache": True}, "backbone": None, "head": None,
                      "data": data, "encode_batch": 64, "batches": cache, "device": "cuda",
                      "cases": ["cache"]},
            "mixture": {"argv": DP20_C_MIX_ARGV, "picks": 64, "half": 2,
                        "ckpt": str(DP20_DIR / "20c_ring")}}


def np_err(got: dict, want: dict, tol: float) -> float:
    """The largest |got - want| - tol |want| over the leaves (the measure of
    np.testing.assert_allclose(atol=rtol=tol), which holds while it stays
    within tol)."""
    return max(np_errs(got, want, tol).values())


def np_errs(got: dict, want: dict, tol: float) -> dict:
    """``np_err``'s measure leaf by leaf."""
    return {k: float(np.max(np.abs(got[k] - want[k]) - tol * np.abs(want[k]))) for k in want}


def dp20b_main(out_path: str) -> int:
    """20c, a rank of ``torchrun --nproc_per_node 2``: two gloo ranks on the
    card, eager steps, f32; ``rig.more_cases`` on ``dp20_payload``: the
    adversarial step (monolithic and ZeRO-1) and the feature cache held to
    one process on the global batches (losses and parameters within
    DP20_C_TOL, the discriminator's too; each rank's feature table equal
    to the one process's), the replicas to each other and the collectives
    to the plan on both ranks; the mixture's picks equal on both ranks and
    its resume from the ring slot onto the uninterrupted stream."""
    import torch.distributed as dist

    from induction_network_on_fewrel_tpu_torch.parallel import rig
    from induction_network_on_fewrel_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
    )
    from induction_network_on_fewrel_tpu_torch.parallel.mesh import make_mesh

    t0 = time.monotonic()
    torch.cuda.set_device(0)
    maybe_initialize_distributed(backend="gloo", timeout_s=120)
    mesh = make_mesh()
    if mesh.rank == 0:
        shutil.rmtree(DP20_DIR / "20c_ring", ignore_errors=True)
    dist.barrier()
    payload = dp20_payload()
    zero_kernel_counts()
    with contextlib.redirect_stderr(io.StringIO()):
        got = rig.more_cases(payload, mesh)
    counts = kernel_counts()
    other = [None, None]
    dist.gather_object(got, other if mesh.rank == 0 else None, dst=0)
    if mesh.rank != 0:
        return 0
    ref = rig.more_cases({k: payload[k] for k in ("adv", "cache")}, None)
    res = {"world": 2, "backend": "gloo", "device": torch.cuda.get_device_name(0),
           "steps": DP20_C_STEPS, "cases": {}}
    for part, keys, trees in (("adv", ("loss", "domain_loss"), ("params", "disc_params")),
                              ("cache", ("loss",), ("params",))):
        want = next(iter(ref[part].values()))
        for case, r in got[part].items():
            loss_err = max(float(np.abs(np.array(r[k]) - want[k]).max()) for k in keys)
            errs = {f"{t}/{k}": v for t in trees
                    for k, v in np_errs(r[t], want[t], DP20_C_TOL).items()}
            worst = max(errs, key=errs.get)
            param_err = errs[worst]
            ranks_equal = all(np.array_equal(r[t][k], other[1][part][case][t][k])
                              for t in trees for k in r[t])
            issued_ok = all(o[part][case]["issued_per_step"] == o[part][case]["plan"]
                            for o in other)
            row = {"loss_abs_err": loss_err, "param_err": param_err, "worst_leaf": worst,
                   "ranks_equal": ranks_equal,
                   "collectives_per_step": r["issued_per_step"], "eager_s": r["seconds"]}
            if part == "cache":
                row["table_equal"] = all(np.array_equal(o[part][case]["table"], want["table"])
                                         for o in other)
            if loss_err > DP20_C_TOL or param_err > DP20_C_TOL or not ranks_equal \
                    or not issued_ok or not row.get("table_equal", True):
                raise AssertionError(f"20c {case}: {row}, plan {r['plan']}")
            res["cases"][case] = row
            print(f"[20c] {case}: two gloo ranks on the card vs one process on the global "
                  f"batch, {DP20_C_STEPS} steps: losses within {loss_err:.3g}, parameters "
                  f"{param_err:.3g} ({worst}; tol {DP20_C_TOL}); replicas equal"
                  + ("; each rank's feature table equals the one process's" if part == "cache"
                     else "")
                  + f"; collectives per step on both ranks {r['issued_per_step']} (= the plan)",
                  flush=True)
    mixes = [o["mixture"] for o in other]
    mix_err = max(np_err(m["resumed"]["params"], m["whole"]["params"], DP20_C_TOL)
                  for m in mixes)
    if mixes[0]["picks"] != mixes[1]["picks"] or mixes[0]["seed"] != mixes[1]["seed"] \
            or any(m["resumed"]["stream"] != m["whole"]["stream"] for m in mixes) \
            or mix_err > DP20_C_TOL or any(
                not np.array_equal(mixes[0]["whole"]["params"][k], mixes[1]["whole"]["params"][k])
                for k in mixes[0]["whole"]["params"]):
        raise AssertionError(f"20c mixture: picks equal {mixes[0]['picks'] == mixes[1]['picks']}, "
                             f"streams {[m['resumed']['stream'] == m['whole']['stream'] for m in mixes]}, "
                             f"resumed params {mix_err:.3g}")
    res["mixture"] = {"picks_equal": True, "counts": mixes[0]["counts"],
                      "resumed_param_err": mix_err, "stream_equal": True}
    print(f"[20c] mixture through cli.make_trainer: both ranks pick the same source for the "
          f"first 64 batches (served {mixes[0]['counts']}); each rank's run resumed from the "
          f"ring slot at step 2 ends on the uninterrupted run's stream state, its parameters "
          f"within {mix_err:.3g} (tol {DP20_C_TOL}); replicas equal", flush=True)
    res["launches"] = {k: v for k, v in counts.items() if v}
    res["seconds"] = round(time.monotonic() - t0, 1)
    print(f"[20c] rank 0 wrapper launches (eager: every call launches) {res['launches']}; "
          f"{res['seconds']} s", flush=True)
    Path(out_path).write_text(json.dumps(res, default=str))
    return 0


# --- Phase 21: MoE across ranks: global routing under dp, the ep executor --------------

DP21_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_dp21"
DP21_STEPS = 8                          # two replays of steps_per_call 4
# 21a: 14c's MoE transformer (--moe_experts 8, every other --moe_* at its
# JAX default) on the token cache with lazy Adam (the table's gradient
# without atomics), --dp 1 --zero_opt at world size 1 over NCCL beside the
# same run without a group: every collective in the replay, the MoE
# layers' routing all-gathers among them.
DP21_ARGV = ["--synthetic", "--bf16", "--encoder", "transformer", "--moe_experts", "8",
             "--token_cache", "--embed_optimizer", "lazy", "--steps_per_call", "4",
             "--train_iter", str(DP21_STEPS), "--val_step", str(DP21_STEPS), "--val_iter", "40"]
DP21_FLAGS = ["--dp", "1", "--zero_opt"]
DP21_TEST_ARGV = ["--synthetic", "--bf16", "--encoder", "transformer", "--moe_experts", "8",
                  "--token_cache", "--test_iter", "40", "--dp", "1"]
# 21b/21c: gloo ranks on the one card, eager steps, f32 at 14c's widths (4 x
# 256, FFN 1024, 8 experts, top-2, groups of 512; the flagship episode, 8000
# tokens a step) on a 2 002-word table, with --moe_capacity 0.5: 64 slots
# an expert in a group of 512, 512 in all for two choices of each real
# token, so every step drops (at 1.0 the router, trained at SGD's rate,
# balanced its experts to no drop by step 2, call 4); at dp=2 a rank's support
# ends at global token 2000 and its query starts at 4000, neither a
# multiple of 512. DP21_B_STEPS steps from the seed's weights, held to one
# process on the global batch at DP21_TOL with the dropped shares equal.
# The update is SGD at lr 0.1: Adam divides each gradient by its own
# scale, so an element whose gradient is a near-cancelling sum (1e-6 of
# the largest, on the card's f32 GEMMs) moves by its rounding (1.44e-5
# apart after 3 steps, call 3), as 20c keeps its table on SGD.
DP21_CAPACITY = 0.5
DP21_VOCAB = 2002
DP21_B_STEPS = 3
DP21_TOL = 1e-5
DP21_CHILD_SECONDS = {"21a": 240, "21b": 240, "21c": 240}
DP21_SECONDS = 100


def dp21a_main(out_path: str) -> int:
    """21a, one rank of ``torchrun --nproc_per_node 1``: ``DP21_ARGV`` under
    a world-size-1 NCCL mesh (``DP21_FLAGS``) and without a group,
    DP21_STEPS steps each as replays of 4: held at ``hold_state``'s bars
    (and whether every parameter is equal to the bit), the lazy moments,
    the dropped shares equal, the path's kernels launched, the collectives
    each replay issues equal to the plan, no capture after the warm-up,
    ms/step and peak GiB beside the plain run; then ``cli.test_main`` on the
    dp run's checkpoint under the mesh."""
    from induction_network_on_fewrel_tpu_torch.models.moe import moe_layers

    t0 = time.monotonic()
    shutil.rmtree(DP21_DIR / "a", ignore_errors=True)
    trainers, runs = {}, {}
    for which, flags in (("plain", []), ("dp", DP21_FLAGS)):
        args = cli.parse_args(True, DP21_ARGV + flags + ["--save_ckpt",
                                                         str(DP21_DIR / "a" / which)])
        cfg = cli.config_from_args(args)
        mesh = cli.dp_mesh(args, cfg) if flags else None
        if flags and (mesh is None or mesh.backend != "nccl" or mesh.dp != 1):
            raise AssertionError(f"21a: expected a world-size-1 NCCL mesh, got {mesh}")
        with contextlib.redirect_stderr(io.StringIO()):
            trainers[which] = cli.make_trainer(args, cfg, mesh=mesh)[0]
    plain, dp = trainers["plain"], trainers["dp"]
    spc = dp.cfg.steps_per_call
    for t in (plain, dp):
        t.metric_window = spc
    table0 = dp.model.embedding.word_embedding.detach().clone()
    if any(not torch.equal(a, b) for a, b in zip(dp.model.parameters(),
                                                  plain.model.parameters())):
        raise AssertionError("21a: the two runs start from different weights")
    watcher = stamped_watcher()
    for which, t in (("plain", plain), ("dp", dp)):
        zero_kernel_counts()
        torch.cuda.reset_peak_memory_stats()
        with contextlib.redirect_stderr(io.StringIO()):
            t.train(DP21_STEPS)
        torch.cuda.synchronize()
        runs[which] = {"wrappers": kernel_counts(), "records": train_records(t.logger.path),
                       "drops": [float(m.drop_share) for m in moe_layers(t.model)],
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    missing = [k for k in OPTIM_ON + LAZY_KERNELS if not runs["dp"]["wrappers"][k]]
    if missing:
        raise AssertionError(f"21a: kernels of the path never launched under dp: {missing}")
    losses = {w: np.array([r["loss"] for r in r_["records"]]) for w, r_ in runs.items()}
    loss_rel = float(np.max(np.abs(losses["dp"] - losses["plain"]) / np.abs(losses["plain"])))
    if loss_rel > GRAPH_PARAM_TOL or runs["dp"]["drops"] != runs["plain"]["drops"]:
        raise AssertionError(f"21a: losses rel {loss_rel:.3g}, dropped shares "
                             f"{runs['dp']['drops']} vs {runs['plain']['drops']}")
    held = hold_state("21a NCCL world 1 vs no process group", (dp.model, full_moments(dp.opt)),
                      (plain.model, plain.opt), table0)
    bitwise = all(torch.equal(a, b) for a, b in zip(dp.model.parameters(),
                                                     plain.model.parameters()))
    lazy_rel = max(rel_err(getattr(dp.lazy, k).float(), getattr(plain.lazy, k).float())[1]
                   for k in ("m", "v"))
    if lazy_rel > SEGSUM_TOL or not torch.equal(dp.lazy.last, plain.lazy.last):
        raise AssertionError(f"21a: the lazy table's moments rel {lazy_rel:.3g}")
    captures = len(watcher.stamps)
    prof = {w: profile_graph_steps(t, OPTIM_ON, calls=4, tag=f"21a profile {w}",
                                   per_call=LAZY_KERNELS) for w, t in (("plain", plain),
                                                                       ("dp", dp))}
    if len(watcher.stamps) != captures:
        raise AssertionError(f"21a: captures after the warm-up: {watcher.stamps[captures:]}")
    watcher.uninstall()
    for g in dp.multi_train_step.graphs.values():
        S = g.out.shape[0]
        if g.collectives != dp.dp.plan(S):
            raise AssertionError(f"21a: a replay of {S} steps issues {g.collectives}, the "
                                 f"plan is {dp.dp.plan(S)}")
    issued = {k: n / spc for k, n in next(iter(dp.multi_train_step.graphs.values()))
              .collectives.items()}
    rc, out, err = quiet_cli(cli.test_main, DP21_TEST_ARGV + ["--load_ckpt",
                                                              str(DP21_DIR / "a" / "dp")])
    test = json.loads(out.strip().splitlines()[-1]) if rc == 0 else None
    if rc != 0 or not 0.0 <= test["test_accuracy"] <= 1.0:
        raise AssertionError(f"21a: cli test under the mesh: rc {rc}: {err[-2000:]}")
    res = {"world": 1, "backend": "nccl", "steps": DP21_STEPS, "steps_per_call": spc,
           "loss_rel": loss_rel, "held": held, "bitwise_params": bitwise,
           "lazy_moments_rel": lazy_rel, "drop_share": runs["dp"]["drops"],
           "collectives_per_step": issued, "nccl_kernels_per_step": prof["dp"]["nccl_per_step"],
           "launches_per_step": {k: n / spc for k, n in prof["dp"]["per_replay"].items()},
           "graph_ms_per_step": prof["dp"]["step_ms"],
           "plain_ms_per_step": prof["plain"]["step_ms"], "busy_ms": prof["dp"]["busy_ms"],
           "plain_busy_ms": prof["plain"]["busy_ms"], "peak_gib": runs["dp"]["peak_gib"],
           "plain_peak_gib": runs["plain"]["peak_gib"], "captures_after_warmup": 0,
           "test": test, "seconds": round(time.monotonic() - t0, 1)}
    print(f"[21a] MoE (--moe_experts 8) at world 1 over NCCL ({' '.join(DP21_FLAGS)}), "
          f"{DP21_STEPS} steps as replays of {spc}: losses rel {loss_rel:.3g} of the run "
          f"without a process group, parameters equal to the bit: {bitwise}, state "
          f"{held['state_rel']:.3g}; dropped shares {runs['dp']['drops']} (equal); "
          f"collectives per step, counted across the capture {issued} (= the plan; "
          f"{prof['dp']['nccl_per_step']:.2f} NCCL kernels per step); "
          f"{prof['dp']['step_ms']:.3f} ms/step vs {prof['plain']['step_ms']:.3f} without dp, "
          f"peak {res['peak_gib']:.2f} vs {res['plain_peak_gib']:.2f} GiB; no capture after "
          f"the warm-up; test accuracy {test['test_accuracy']} under the mesh; "
          f"{res['seconds']} s", flush=True)
    for t in (plain, dp):
        close_trainer(t)
    Path(out_path).write_text(json.dumps(res, default=str))
    return 0


def dp21_payload() -> dict:
    """21b/21c's world (the same in every rank: seeds): the MoE config at
    f32 on a DP21_VOCAB-word table, DP21_B_STEPS global token batches of
    the flagship episode from the synthetic train split."""
    cfg = ExperimentConfig(encoder="transformer", moe_experts=8, moe_capacity=DP21_CAPACITY,
                           compute_dtype="float32", vocab_size=DP21_VOCAB, optimizer="sgd",
                           lr=0.1)
    vocab = make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim)
    s = EpisodeSampler(cli.load_data(cfg, "train"), GloveTokenizer(vocab, cfg.max_length),
                       cfg.n, cfg.k, cfg.q, batch_size=cfg.batch_size, seed=0)
    keys = ("encoder", "moe_experts", "moe_capacity", "compute_dtype", "vocab_size",
            "optimizer", "lr")
    return {"cfg": {k: getattr(cfg, k) for k in keys}, "variants": {"bind": {}},
            "weights": None, "device": "cuda",
            "batches": [batch_to_model_inputs(s.sample_batch()) for _ in range(DP21_B_STEPS)]}


def leaf_rel(got: dict, want: dict) -> float:
    """The worst |got - want| over each leaf's scale."""
    return max(float(np.abs(got[k] - w).max()) / max(float(np.abs(w).max()), 1e-30)
               for k, w in want.items())


def dp21_gloo_main(out_path: str) -> int:
    """21b/21c, a rank of ``torchrun --nproc_per_node 2`` or ``4``: gloo
    ranks on the one card (NCCL puts no two ranks on one device), eager
    steps; the MoE layouts of the world size (``rig.MOE_LAYOUTS``: (dp=2,
    ep=1) and (dp=1, ep=2) on two ranks, (dp=2, ep=2) on four) each train
    ``dp21_payload``'s batches; rank 0 runs the one-process reference on the
    global batches and holds each layout to it: the first forward's logits
    (its rows) and every gradient leaf within DP21_TOL of scale, the losses
    within DP21_TOL, the parameters after ``rig.MOE_DP_AT`` steps at
    ``np.testing.assert_allclose(atol=rtol=DP21_TOL)``'s measure, the
    gradient norms at rtol DP21_TOL, the dropped shares equal and above 0,
    every rank's replica equal, the collectives each step issued equal to
    the plan on every rank."""
    import torch.distributed as dist

    from induction_network_on_fewrel_tpu_torch.parallel import rig
    from induction_network_on_fewrel_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
    )
    from induction_network_on_fewrel_tpu_torch.parallel.mesh import make_mesh

    t0 = time.monotonic()
    torch.cuda.set_device(0)
    maybe_initialize_distributed(backend="gloo", timeout_s=120)
    rank, world = dist.get_rank(), dist.get_world_size()
    payload = dp21_payload()
    torch.cuda.reset_peak_memory_stats()
    got, counts = {}, {}
    for dp, ep in rig.MOE_LAYOUTS[world]:
        zero_kernel_counts()
        got.update(rig.moe_cases({**payload, "layouts": ((dp, ep),)},
                                 lambda dp, ep: make_mesh(dp=dp, ep=ep)))
        counts[rig.layout_name(dp, ep)] = kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    mine = {lay: {"params": r["bind"]["params"], "issued": r["bind"]["issued_per_step"],
                  "plan": r["bind"]["plan"]} for lay, r in got.items()}
    other = [None] * world
    dist.gather_object(mine, other if rank == 0 else None, dst=0)
    if rank != 0:
        return 0
    ref = rig.run_moe_case(payload, "bind", None)
    res = {"world": world, "backend": "gloo", "device": torch.cuda.get_device_name(0),
           "steps": DP21_B_STEPS, "capacity": DP21_CAPACITY, "layouts": {},
           "peak_gib_rank0": peak}
    for lay, r in got.items():
        r = r["bind"]
        B = len(ref["logits"])
        dp, ep = (int(x[2:]) for x in lay.split("_"))
        logit_rel = float(np.abs(r["logits"] - ref["logits"][:B // dp]).max()
                          / np.abs(ref["logits"]).max())
        grad_rel = leaf_rel(r["grads"], ref["grads"])
        loss_err = float(np.abs(np.array(r["losses"]) - ref["losses"]).max())
        excess = {k: float(np.max(np.abs(r["params_at"][k] - w) - DP21_TOL * np.abs(w)))
                  for k, w in ref["params_at"].items()}
        param_err = max(excess.values())
        worst = sorted(excess.items(), key=lambda kv: -kv[1])[:3]
        norm_rel = float(np.max(np.abs(np.array(r["grad_norms"]) - ref["grad_norms"])
                                / np.array(ref["grad_norms"])))
        drops_equal = r["drops"] == ref["drops"] and r["drops0"] == ref["drops0"]
        dropped = min(min(d) for d in ref["drops"]) > 0
        replicas = all(np.array_equal(o[lay]["params"][k], r["params"][k])
                       for o in other for k in r["params"])
        issued_ok = all(o[lay]["issued"] == o[lay]["plan"] for o in other)
        if (logit_rel > DP21_TOL or grad_rel > DP21_TOL or loss_err > DP21_TOL
                or param_err > DP21_TOL or norm_rel > DP21_TOL or not drops_equal
                or not dropped or not replicas or not issued_ok):
            raise AssertionError(
                f"21 {lay}: logits {logit_rel:.3g}, gradients {grad_rel:.3g}, losses "
                f"{loss_err:.3g}, params {param_err:.3g}, grad norms {norm_rel:.3g} (tol "
                f"{DP21_TOL}; worst parameter leaves {worst}); dropped shares {r['drops']} vs "
                f"{ref['drops']}; "
                f"replicas equal "
                f"{replicas}; collectives {[o[lay]['issued'] for o in other]} vs {r['plan']}")
        ms = r["seconds"] / DP21_B_STEPS * 1e3
        res["layouts"][lay] = {"logit_rel": logit_rel, "grad_rel": grad_rel,
                               "loss_abs_err": loss_err, "param_err": param_err,
                               "grad_norm_rel": norm_rel, "drop_share": r["drops"],
                               "worst_param_leaves": worst,
                               "collectives_per_step": r["issued_per_step"],
                               "eager_ms_per_step": ms,
                               "launches_per_step": {k: n / DP21_B_STEPS
                                                     for k, n in counts[lay].items() if n}}
        label = "21b" if ep == 1 else "21c"
        print(f"[{label}] {lay} ({world} gloo ranks on the card, eager) vs one process on the "
              f"global batch, {DP21_B_STEPS} steps at --moe_capacity {DP21_CAPACITY}: logits "
              f"{logit_rel:.3g}, gradients {grad_rel:.3g} of scale, losses within "
              f"{loss_err:.3g}, parameters within {param_err:.3g}, grad norms rel "
              f"{norm_rel:.3g} (tol {DP21_TOL}); dropped shares per step and layer "
              f"{r['drops']} (equal); replicas equal; collectives per step {r['issued_per_step']} "
              f"(= the plan on every rank); {ms:.1f} ms/step eager", flush=True)
    res["seconds"] = round(time.monotonic() - t0, 1)
    print(f"[21{'b' if world == 2 else 'c'}] rank 0 wrapper launches per step (eager) by "
          f"layout {dict((k, v['launches_per_step']) for k, v in res['layouts'].items())}; "
          f"peak {peak:.2f} GiB on rank 0; {res['seconds']} s", flush=True)
    Path(out_path).write_text(json.dumps(res, default=str))
    return 0


# --- Phase 22: tensor and sequence parallel ------------------------------------

DP22_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_dp22"
DP22_TOL = 1e-5
DP22_CHILD_SECONDS = {"22b": 240, "22c": 240}
DP22_SECONDS = 100
# The flagship's kernels that every tp rank launches in a training step.
DP22_ON = ("K7", "K8", "wgrad", "K10", "K11", "optim_sumsq", "optim_update")
# 22a's layouts (dp, tp) by world size; 22b's (sp) and 22c's (tp) run on two.
DP22_TP = {2: (1, 2), 4: (2, 2)}


def dp22_tfm_payload() -> dict:
    """22b's world: the transformer at the JAX defaults (4 layers, width
    256, 4 heads, FFN 1024) under the induction head on the flagship episode
    (5-way 5-shot, Q=5, B=4, L=40), f32, SGD at lr 0.1, a DP21_VOCAB-word
    table, DP21_B_STEPS global token batches; 22c's: BERT-base (the seed's
    weights, the hash-fallback tokenizer) at f32, one eval batch of B=2."""
    from induction_network_on_fewrel_tpu_torch.data import BertTokenizer

    cfg = ExperimentConfig(encoder="transformer", compute_dtype="float32", vocab_size=DP21_VOCAB,
                           optimizer="sgd", lr=0.1)
    vocab = make_synthetic_glove(vocab_size=cfg.vocab_size - 2, word_dim=cfg.word_dim)
    s = EpisodeSampler(cli.load_data(cfg, "train"), GloveTokenizer(vocab, cfg.max_length),
                       cfg.n, cfg.k, cfg.q, batch_size=cfg.batch_size, seed=0)
    bert = ExperimentConfig(encoder="bert", compute_dtype="float32", batch_size=2)
    sb = EpisodeSampler(cli.load_data(bert, "train"),
                        BertTokenizer(bert.max_length, vocab_size=bert.bert_vocab_size),
                        bert.n, bert.k, bert.q, batch_size=bert.batch_size, seed=0)
    return {"cfg": {}, "device": "cuda", "weights": None,
            "variants": {"tfm": {k: getattr(cfg, k) for k in (
                "encoder", "compute_dtype", "vocab_size", "optimizer", "lr")},
                         "bert": {"encoder": "bert", "compute_dtype": "float32",
                                  "batch_size": 2}},
            "variant_batches": {
                "tfm": [batch_to_model_inputs(s.sample_batch()) for _ in range(DP21_B_STEPS)],
                "bert": [batch_to_model_inputs(sb.sample_batch())]}}


def state_digest(params: dict) -> str:
    """A digest of a replica's parameters (the ranks compare replicas by it)."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(np.ascontiguousarray(params[k]).tobytes())
    return h.hexdigest()


def one_process_reference(part: str, payload: dict, run) -> tuple[dict, float]:
    """(``run()``, its peak GiB): the one-process reference of ``part`` on
    ``payload``'s global batches. The two- and four-rank children hold their
    runs to the same reference (the same payload, drawn from seeds): the
    first computes it and leaves it in DP22_DIR, keyed by a digest of the
    payload's batches, and the second reads it back."""
    import hashlib
    import pickle

    h = hashlib.sha256(pickle.dumps((payload["cfg"], payload["batches"])))
    path = DP22_DIR / f"reference_{part}_{h.hexdigest()[:16]}.pkl"
    if path.exists():
        return pickle.loads(path.read_bytes())
    torch.cuda.reset_peak_memory_stats()
    out = (run(), torch.cuda.max_memory_allocated() / 2**30)
    path.write_bytes(pickle.dumps(out))
    return out


def param_excess(got: dict, want: dict) -> tuple[float, list]:
    """The worst ``|got - want| - tol·|want|`` over every element (within
    ``np.testing.assert_allclose(atol=rtol=DP22_TOL)`` when at most
    DP22_TOL), and the three worst leaves."""
    excess = {k: float(np.max(np.abs(got[k] - w) - DP22_TOL * np.abs(w))) for k, w in want.items()}
    return max(excess.values()), sorted(excess.items(), key=lambda kv: -kv[1])[:3]


def dp22_flagship(mesh, smi: str) -> dict:
    """22a on this rank: the flagship token-cache lazy step at f32 (19b's
    payload, its compact spelling) under ``mesh``; with the wrappers' counts
    zeroed just before and read just after."""
    from induction_network_on_fewrel_tpu_torch.parallel import rig

    cfg = ExperimentConfig(compute_dtype="float32", token_cache=True, embed_optimizer="lazy",
                           ckpt_stage="off")
    payload = {**dp_b_payload(cfg), "cases": ["compact"]}
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    got = rig.run_cases(payload, mesh)["compact"]
    counts = kernel_counts()
    return {"payload": payload, "got": got, "counts": counts,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


# --- Phase 23: pipeline parallel -------------------------------------------------

# The (dp, pp) layout by world size, the GPipe microbatches, and the step
# after which the pp run saves the ring slot that one process restores.
DP23_PP = {2: (1, 2), 4: (2, 2)}
DP23_M = 5
DP23_SAVE_AT = DP_B_STEPS - 1
DP23_SECONDS = 40
# ``adam_noise``: an element whose first gradient is below this share of
# its leaf's largest is at the rounding level of the leaf's f32 sums on the
# card (cuBLAS sums of up to 1 024 terms a product, in another order for
# each microbatch count).
DP23_NOISE = 1e-5
# The optimizer and lazy-table kernels every rank launches a step (the
# transformer path runs no LSTM or attention kernel).
DP23_ON = ("optim_sumsq", "optim_update", "lazy_catchup", "lazy_scatter")


def dp23_payload(payload22a: dict) -> dict:
    """23's run: 22a's token table and global index batches (drawn once in
    the child), the stacked transformer at the JAX defaults (4 layers,
    width 256, 4 heads, FFN 1024, L=40) under the induction head, f32, the
    token cache with lazy Adam on the 400 002 x 50 table, DP23_M
    microbatches."""
    return {**payload22a, "cfg": {**payload22a["cfg"], "encoder": "transformer",
                                  "tfm_stacked": True, "pp_microbatches": DP23_M},
            "state_at": 1}


def adam_noise(first: dict, uids: np.ndarray) -> dict:
    """{leaf: mask} of the elements whose first-step gradient sits at the
    rounding level of its leaf: nonzero and below DP23_NOISE of the leaf's
    largest, read from the Adam first moment of one process's first step
    (``first``; it is 0.1 times the gradient the update saw; the lazy rows'
    for the word table's corpus rows ``uids``). Adam's first step moves
    every element by about lr times the sign of its gradient, so where that
    gradient is rounding noise two summation orders (the GPipe microbatches'
    and one process's whole batch) move it apart, and the steps after keep
    the difference. ``tests/test_torch_pp.py`` leaves out the same elements
    at 1e-6."""
    from induction_network_on_fewrel_tpu_torch.train.steps import WORD_TABLE

    def small(v):
        a = np.abs(v)
        return (a > 0) & (a < DP23_NOISE * a.max())

    masks = {k[3:]: small(v) for k, v in first["moments"].items() if k.startswith("mu/")}
    table = np.zeros(first["params"][WORD_TABLE].shape, bool)
    table[uids] = small(first["moments"]["lazy/rows_m"])
    masks[WORD_TABLE] = table
    masks["lazy/rows"] = table[uids]
    return masks


def mask_of(name: str, masks: dict):
    """The ``adam_noise`` mask of a parameter or a moment ("mu/<leaf>",
    "nu/<leaf>", "lazy/rows_m", "lazy/rows_v"), or None."""
    leaf = "lazy/rows" if name.startswith("lazy/rows") else name.split("/", 1)[-1]
    return masks.get(leaf)


def held(got: dict, want: dict, masks: dict) -> tuple[float, float, list]:
    """Over the elements ``masks`` keeps: the worst ``|got - want| -
    DP22_TOL·|want|`` (``param_excess``'s bar), the worst |got - want| over
    each leaf's scale (``leaf_rel``'s), and the three worst leaves by the
    first."""
    excess, rel = {}, {}
    for k, w in want.items():
        m = mask_of(k, masks)
        keep = np.ones(w.shape, bool) if m is None else ~m
        g, w = got[k][keep], w[keep]
        if w.size == 0:
            continue
        excess[k] = float(np.max(np.abs(g - w) - DP22_TOL * np.abs(w)))
        rel[k] = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
    worst = sorted(excess.items(), key=lambda kv: -kv[1])[:3]
    return max(excess.values()), max(rel.values()), worst


def dp23_rank(payload22a: dict, world: int) -> dict:
    """23 on this rank: ``dp23_payload``'s DP_B_STEPS token-cache lazy steps
    at (dp, pp) = DP23_PP[world], the state saved as a ring slot after
    DP23_SAVE_AT steps; the wrappers' counts zeroed just before and read
    just after; this rank's stack and moment bytes."""
    import torch.distributed as dist

    from induction_network_on_fewrel_tpu_torch.parallel import rig
    from induction_network_on_fewrel_tpu_torch.parallel.mesh import make_mesh

    dp, pp = DP23_PP[world]
    payload = dp23_payload(payload22a)
    ckpt = DP22_DIR / f"pp23_world{world}"
    if dist.get_rank() == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
    mesh = make_mesh(dp=dp, pp=pp)
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    got = rig.run_case(payload, rig.CASES["compact"], mesh, resume_at=DP23_SAVE_AT,
                       ckpt_dir=str(ckpt))
    counts = kernel_counts()

    def stack_bytes(shapes: dict) -> int:
        return 4 * sum(int(np.prod(v)) for k, v in shapes.items() if ".stack_" in k)

    mine = {"digest": state_digest(got["params"]), "counts": counts,
            "issued": got["issued_per_step"], "plan": got["plan"],
            "peak": torch.cuda.max_memory_allocated() / 2**30,
            "stack_bytes": stack_bytes(got["local_shapes"]),
            "stack_moment_bytes": 2 * stack_bytes(got["local_moment_shapes"])}
    return {"payload": payload, "got": got, "mine": mine, "ckpt": str(ckpt), "dp": dp, "pp": pp}


def dp23_hold(p23: dict, other: list, world: int, smi: str) -> dict:
    """23 on rank 0: the one-process reference on the global batches (the
    card, no group), held to within DP22_TOL on every step's loss and
    gradient norm, and after the first step on the parameters and the
    moments of scale, the elements whose first gradient is at the rounding
    level of their leaf aside (``adam_noise``: fewer than 1 in 100); the pp
    run's slot after DP23_SAVE_AT steps restored at pp=1 on the card and
    trained on to the end, held to the pp run's end the same way (each step
    of pp is one process's step to rounding); every rank's stack and moment
    bytes half the one process's (pp=2); the optimizer and lazy kernels
    launched on every rank every step, the optimizer's norm kernel twice
    (the replicated leaves, then the stack's, whose square is all-reduced
    over pp); the hops a step as planned."""
    from induction_network_on_fewrel_tpu_torch.parallel import rig
    from induction_network_on_fewrel_tpu_torch.train.lazy_embed import augment_token_table

    got, payload, dp, pp = p23["got"], p23["payload"], p23["dp"], p23["pp"]
    ref, ref_peak = one_process_reference(
        "23", payload, lambda: rig.run_case(payload, rig.CASES["compact"], None))
    one = {**payload, "batches": payload["batches"][:1]}
    first, _ = one_process_reference(
        "23_first", one, lambda: rig.run_case(one, rig.CASES["compact"], None))
    cont = rig.restore_and_continue(payload, rig.CASES["compact"], p23["ckpt"], DP23_SAVE_AT)
    masks = adam_noise(first, augment_token_table(payload["table"])[1])
    d = ExperimentConfig(**payload["cfg"]).tfm_model
    left = sum(int(mask_of(k, masks).sum()) for k in ref["params"] if k in masks)
    share = left / sum(v.size for v in ref["params"].values())
    key_bias = int(masks["encoder.stack_qkv_b"][:, d:2 * d].sum())
    loss_err = float(np.abs(np.array(got["losses"]) - ref["losses"]).max())
    param_err, _, worst = held(got["params_at"], first["params"], masks)
    norm_rel = float(np.max(np.abs(np.array(got["grad_norms"]) - ref["grad_norms"])
                            / np.array(ref["grad_norms"])))
    _, moment_rel, _ = held(got["moments_at"], first["moments"], masks)
    # Reported, not held: the end states after DP_B_STEPS steps. The
    # left-out elements' first steps (about +-lr each, drawn apart by the
    # two summation orders) feed the later steps' forwards, so every later
    # gradient carries more than rounding.
    end_err, end_moment_rel, end_worst = held(got["params"], ref["params"], masks)
    _, end_moment_rel, _ = held(got["moments"], ref["moments"], masks)
    cont_loss = float(np.abs(np.array(cont["losses"]) - got["losses"][DP23_SAVE_AT:]).max())
    cont_err, _, cont_worst = held(cont["params"], got["params"], masks)
    # Where the bar is missed: per leaf, the kept elements over it and the
    # least of their first-step gradients over the leaf's largest.
    over = {}
    for k, w in first["params"].items():
        mu = first["moments"].get(f"mu/{k}")
        m = mask_of(k, masks)
        bad = np.abs(got["params_at"][k] - w) - DP22_TOL * np.abs(w) > DP22_TOL
        if m is not None:
            bad &= ~m
        if bad.any() and mu is not None:
            a = np.abs(mu)
            over[k] = (int(bad.sum()), float(a[bad].min() / a.max()))
    per_step = [{k: n / DP_B_STEPS for k, n in o["pp"]["counts"].items() if n} for o in other]
    missing = [(r, k) for r, c in enumerate(per_step) for k in DP23_ON if not c.get(k)]
    optim = [(c.get("optim_sumsq"), c.get("optim_update")) for c in per_step]
    hops = got["plan"].get("pp/hop")
    whole = 4 * sum(int(np.prod(v)) for k, v in ref["local_shapes"].items() if ".stack_" in k)
    half = [(o["pp"]["stack_bytes"], o["pp"]["stack_moment_bytes"]) for o in other]
    if (max(loss_err, param_err, norm_rel, moment_rel, cont_loss, cont_err) > DP22_TOL or missing
            or any(x != (2.0, 1.0) for x in optim) or hops != 2 * (DP23_M + pp - 2)
            or any(h != (whole // pp, 2 * whole // pp) for h in half) or share >= 1e-2):
        raise AssertionError(
            f"23 (dp={dp}, pp={pp}): losses {loss_err:.3g}, parameters {param_err:.3g} (worst "
            f"{worst}), grad norms {norm_rel:.3g}, moments {moment_rel:.3g}, with {left} "
            f"elements ({share:.3g}) at the rounding level left out ({key_bias} key biases "
            f"among them; elements over the bar and the least of their first-step gradients "
            f"of the leaf's largest: {over}); restored at pp=1: "
            f"losses {cont_loss:.3g}, parameters {cont_err:.3g} (worst {cont_worst}) (tol "
            f"{DP22_TOL}); kernels not launched (rank, kernel) {missing}; optim_sumsq / "
            f"optim_update per step {optim}; pp/hop per step {hops}; stack and moment bytes "
            f"per rank {half} of {whole}")
    ms, ref_ms = got["seconds"] / DP_B_STEPS * 1e3, ref["seconds"] / DP_B_STEPS * 1e3
    tag = "a" if world == 2 else "b"
    out = {"part": f"23{tag}", "loss_abs_err": loss_err, "param_err": param_err,
           "noise_elements_left_out": left, "noise_share": share, "key_biases_left_out": key_bias,
           "end_param_excess_reported": end_err, "end_worst_leaves": end_worst,
           "end_moment_rel_reported": end_moment_rel,
           "worst_leaves": worst, "grad_norm_rel": norm_rel, "moment_rel": moment_rel,
           "restored_pp1_loss_abs_err": cont_loss, "restored_pp1_param_err": cont_err,
           "collectives_per_step": got["issued_per_step"], "launches_per_step_by_rank": per_step,
           "stack_bytes_by_rank": [h[0] for h in half], "stack_moment_bytes_by_rank":
           [h[1] for h in half], "one_process_stack_bytes": whole,
           "eager_ms_per_step": ms, "one_process_ms_per_step": ref_ms,
           "peak_gib_by_rank": [o["pp"]["peak"] for o in other], "one_process_peak_gib": ref_peak}
    print(f"[23{tag}] the stacked transformer (4 layers x 256, FFN 1024, L=40, f32, token cache + "
          f"lazy Adam on the 400 002 x 50 table) at (dp, pp) = ({dp}, {pp}), {DP23_M} "
          f"microbatches ({world} gloo ranks on the card, eager) vs one process on the global "
          f"batch, {DP_B_STEPS} steps: losses within {loss_err:.3g}, grad norms rel "
          f"{norm_rel:.3g}; after step 1 parameters {param_err:.3g}, moments {moment_rel:.3g} "
          f"of scale (tol {DP22_TOL}; {left} elements, {share:.3g} of all, whose first gradient "
          f"is at the rounding level of their leaf aside, {key_bias} key biases among them); "
          f"after step {DP_B_STEPS} (reported, not held) parameters {end_err:.3g}, moments "
          f"{end_moment_rel:.3g}; "
          f"the pp slot after {DP23_SAVE_AT} steps "
          f"restored at pp=1 and trained on: losses {cont_loss:.3g}, parameters {cont_err:.3g}; "
          f"replicas equal; collectives per step {got['issued_per_step']} (= the plan on every "
          f"rank); wrapper launches per rank per step {per_step}; stack bytes per rank "
          f"{[h[0] for h in half]} and its moments' {[h[1] for h in half]} of {whole} and "
          f"{2 * whole} in one process; {ms:.1f} ms/step eager vs {ref_ms:.1f} one process "
          f"(graph capture included); peak {[round(o['pp']['peak'], 2) for o in other]} vs "
          f"{ref_peak:.2f} GiB; {smi}", flush=True)
    return out


def dp22_gloo_main(out_path: str) -> int:
    """22, a rank of ``torchrun --nproc_per_node 2`` or ``4``: gloo ranks on
    the one card, eager steps. 22a: the flagship (``--encoder bilstm`` at the
    ExperimentConfig widths, the token cache with lazy Adam, f32 as 19b) at
    (dp, tp) = (1, 2) on two ranks and (2, 2) on four, DP_B_STEPS steps held
    to one process on the global batch within DP22_TOL (losses, parameters,
    gradient norms, the moments of scale), every rank launching the
    BiLSTM, attention and optimizer kernels a step (wrapper counts per rank
    per step), every replica equal, the collectives to the plan. On two
    ranks also 22b, the transformer at the JAX defaults at sp=2 (the ring),
    and 22c, a BERT-base eval batch at tp=2, each held to one process
    (``dp22_tfm_payload``): the first forward's logits and every gradient
    leaf within DP22_TOL of scale, the losses, the parameters after
    ``rig.MOE_DP_AT`` steps, the gradient norms; 22c's logits and eval
    metrics. ms/step and peak GiB per rank beside the one-process run. Then
    phase 23 on every rank (``dp23_rank``) and, on rank 0, its holds
    (``dp23_hold``)."""
    import torch.distributed as dist

    from induction_network_on_fewrel_tpu_torch.parallel import rig
    from induction_network_on_fewrel_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed,
    )
    from induction_network_on_fewrel_tpu_torch.parallel.mesh import make_mesh

    t0 = time.monotonic()
    torch.cuda.set_device(0)
    maybe_initialize_distributed(backend="gloo", timeout_s=120)
    rank, world = dist.get_rank(), dist.get_world_size()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    res = {"world": world, "backend": "gloo", "card": smi, "layouts": {}}
    dp, tp = DP22_TP[world]
    a = dp22_flagship(make_mesh(dp=dp, tp=tp), smi)
    mine = {"a": {"digest": state_digest(a["got"]["params"]), "counts": a["counts"],
                  "issued": a["got"]["issued_per_step"], "plan": a["got"]["plan"],
                  "peak": a["peak_gib"]}}
    if world == 2:
        tp_payload = dp22_tfm_payload()
        torch.cuda.reset_peak_memory_stats()
        zero_kernel_counts()
        b = rig.run_moe_case(tp_payload, "tfm", make_mesh(dp=1, sp=2))
        mine["b"] = {"digest": state_digest(b["params"]), "counts": kernel_counts(),
                     "issued": b["issued_per_step"], "plan": b["plan"],
                     "peak": torch.cuda.max_memory_allocated() / 2**30}
        torch.cuda.reset_peak_memory_stats()
        zero_kernel_counts()
        c = rig.run_moe_case({**tp_payload, "eval_only": True}, "bert", make_mesh(dp=1, tp=2))
        mine["c"] = {"counts": kernel_counts(), "peak": torch.cuda.max_memory_allocated() / 2**30}
    t23 = time.monotonic()
    p23 = dp23_rank(a["payload"], world)
    mine["pp"] = p23["mine"]
    t23 = time.monotonic() - t23
    other = [None] * world
    dist.gather_object(mine, other if rank == 0 else None, dst=0)
    if rank != 0:
        return 0
    for part in mine:
        for key in ("digest", "issued"):
            if key in mine[part] and not all(o[part][key] == (mine[part][key] if key == "digest"
                                                               else o[part]["plan"])
                                             for o in other):
                raise AssertionError(f"22{part}: the ranks' {key} differ: "
                                     f"{[o[part].get(key) for o in other]}")
    # 22a: the one-process reference on the global batches.
    ref, ref_peak = one_process_reference(
        "22a", a["payload"], lambda: rig.run_cases(a["payload"], None)["compact"])
    got = a["got"]
    loss_err = float(np.abs(np.array(got["losses"]) - ref["losses"]).max())
    param_err, worst = param_excess(got["params"], ref["params"])
    norm_rel = float(np.max(np.abs(np.array(got["grad_norms"]) - ref["grad_norms"])
                            / np.array(ref["grad_norms"])))
    moment_rel = leaf_rel(got["moments"], ref["moments"])
    per_step = [{k: n / DP_B_STEPS for k, n in o["a"]["counts"].items() if n} for o in other]
    missing = [(r, k) for r, c in enumerate(per_step) for k in DP22_ON if not c.get(k)]
    if (loss_err > DP22_TOL or param_err > DP22_TOL or norm_rel > DP22_TOL
            or moment_rel > DP22_TOL or missing):
        raise AssertionError(f"22a (dp={dp}, tp={tp}): losses {loss_err:.3g}, parameters "
                             f"{param_err:.3g} (worst {worst}), grad norms {norm_rel:.3g}, "
                             f"moments {moment_rel:.3g} (tol {DP22_TOL}); kernels not launched "
                             f"(rank, kernel) {missing}")
    ms, ref_ms = got["seconds"] / DP_B_STEPS * 1e3, ref["seconds"] / DP_B_STEPS * 1e3
    lay = f"dp{dp}_tp{tp}"
    res["layouts"][lay] = {
        "part": "22a", "loss_abs_err": loss_err, "param_err": param_err, "worst_leaves": worst,
        "grad_norm_rel": norm_rel, "moment_rel": moment_rel,
        "collectives_per_step": got["issued_per_step"], "launches_per_step_by_rank": per_step,
        "eager_ms_per_step": ms, "one_process_ms_per_step": ref_ms,
        "peak_gib_by_rank": [o["a"]["peak"] for o in other], "one_process_peak_gib": ref_peak}
    print(f"[22a] the flagship (bilstm, token cache + lazy Adam, f32) at (dp, tp) = ({dp}, {tp}) "
          f"({world} gloo ranks on the card, eager) vs one process on the global batch, "
          f"{DP_B_STEPS} steps: losses within {loss_err:.3g}, parameters {param_err:.3g}, grad "
          f"norms rel {norm_rel:.3g}, moments {moment_rel:.3g} of scale (tol {DP22_TOL}); "
          f"replicas equal; collectives per step {got['issued_per_step']} (= the plan on every "
          f"rank); wrapper launches per rank per step {per_step}; {ms:.1f} ms/step eager vs "
          f"{ref_ms:.1f} one process; peak {[round(o['a']['peak'], 2) for o in other]} vs "
          f"{ref_peak:.2f} GiB; {smi}", flush=True)
    if world == 2:
        ref_b = rig.run_moe_case(tp_payload, "tfm", None)
        logit_rel = float(np.abs(b["logits"] - ref_b["logits"]).max()
                          / np.abs(ref_b["logits"]).max())
        grad_rel = leaf_rel(b["grads"], ref_b["grads"])
        loss_b = float(np.abs(np.array(b["losses"]) - ref_b["losses"]).max())
        param_b, worst_b = param_excess(b["params_at"], ref_b["params_at"])
        norm_b = float(np.max(np.abs(np.array(b["grad_norms"]) - ref_b["grad_norms"])
                              / np.array(ref_b["grad_norms"])))
        if max(logit_rel, grad_rel, loss_b, param_b, norm_b) > DP22_TOL:
            raise AssertionError(f"22b (sp=2): logits {logit_rel:.3g}, gradients {grad_rel:.3g}, "
                                 f"losses {loss_b:.3g}, parameters {param_b:.3g} (worst "
                                 f"{worst_b}), grad norms {norm_b:.3g} (tol {DP22_TOL})")
        ms_b = b["seconds"] / DP21_B_STEPS * 1e3
        ref_ms_b = ref_b["seconds"] / DP21_B_STEPS * 1e3
        per_b = [{k: n / DP21_B_STEPS for k, n in o["b"]["counts"].items() if n} for o in other]
        res["layouts"]["dp1_sp2"] = {
            "part": "22b", "logit_rel": logit_rel, "grad_rel": grad_rel, "loss_abs_err": loss_b,
            "param_err": param_b, "worst_leaves": worst_b, "grad_norm_rel": norm_b,
            "collectives_per_step": b["issued_per_step"], "launches_per_step_by_rank": per_b,
            "eager_ms_per_step": ms_b, "one_process_ms_per_step": ref_ms_b,
            "peak_gib_by_rank": [o["b"]["peak"] for o in other]}
        print(f"[22b] the transformer (4 layers x 256, FFN 1024, L=40, f32, SGD) at sp=2 (ring "
              f"attention over gloo's all_to_all_single: gloo refuses send/recv on CUDA tensors) "
              f"vs one process, {DP21_B_STEPS} steps: logits {logit_rel:.3g}, gradients "
              f"{grad_rel:.3g} of scale, losses within {loss_b:.3g}, parameters {param_b:.3g}, "
              f"grad norms rel {norm_b:.3g} (tol {DP22_TOL}); replicas equal; collectives per "
              f"step {b['issued_per_step']} (= the plan); wrapper launches per rank per step "
              f"{per_b}; {ms_b:.1f} ms/step eager vs {ref_ms_b:.1f} one process; peak "
              f"{[round(o['b']['peak'], 2) for o in other]} GiB; {smi}", flush=True)
        t_c = time.monotonic()
        ref_c = rig.run_moe_case({**tp_payload, "eval_only": True}, "bert", None)
        logit_c = float(np.abs(c["logits"] - ref_c["logits"]).max()
                        / np.abs(ref_c["logits"]).max())
        eval_c = max(abs(c["eval"][k] - v) for k, v in ref_c["eval"].items())
        if logit_c > DP22_TOL or eval_c > DP22_TOL:
            raise AssertionError(f"22c (BERT-base eval at tp=2): logits {logit_c:.3g} of scale, "
                                 f"eval metrics {eval_c:.3g} (tol {DP22_TOL})")
        res["layouts"]["dp1_tp2_bert_eval"] = {
            "part": "22c", "logit_rel": logit_c, "eval_abs_err": eval_c,
            "eval_ms": c["seconds"] * 1e3, "one_process_eval_ms": ref_c["seconds"] * 1e3,
            "peak_gib_by_rank": [o["c"]["peak"] for o in other],
            "launches_by_rank": [{k: n for k, n in o["c"]["counts"].items() if n}
                                 for o in other], "reference_seconds": time.monotonic() - t_c}
        print(f"[22c] a BERT-base eval batch (f32, the seed's weights, B=2: 100 sequences of 40) "
              f"at tp=2 vs one process: logits {logit_c:.3g} of scale, eval metrics within "
              f"{eval_c:.3g} (tol {DP22_TOL}); {c['seconds'] * 1e3:.1f} ms vs "
              f"{ref_c['seconds'] * 1e3:.1f} ms one process (the first call); peak "
              f"{[round(o['c']['peak'], 2) for o in other]} GiB; {smi}", flush=True)
    t_hold = time.monotonic()
    res["pp23"] = dp23_hold(p23, other, world, smi)
    res["pp23"]["seconds"] = round(t23 + time.monotonic() - t_hold, 1)
    res["seconds"] = round(time.monotonic() - t0, 1)
    print(f"[22{'b' if world == 2 else 'c'}] {world} ranks: {res['seconds']} s (phase 23's part "
          f"{res['pp23']['seconds']} s)", flush=True)
    Path(out_path).write_text(json.dumps(res, default=str))
    return 0


def dp_phases(smi: str, want19: bool, want20: bool, want21: bool = False,
              moe14: dict | None = None, want22: bool = False) -> tuple:
    """Phases 19, 20, 21, 22 and 23 (the ``{"dp": ...}``, ``{"dp20":
    ...}``, ``{"dp21": ...}``, ``{"dp22": ...}`` and ``{"dp23": ...}``
    results, None for a phase not asked for; 23 runs with 22): 20a in this
    process, then one torchrun child at world size 1 over NCCL for 19a, 20b
    and 21a, one of two gloo ranks for 19b, 20c, 21b-c, 22's two-rank
    layouts and 23 at (dp=1, pp=2), and one of four for 21c (dp=2, ep=2),
    22a at (dp=2, tp=2) and 23 at (dp=2, pp=2); this process never joins a
    process group. ``moe14``: phase 14c's MoE result, printed beside 21's."""
    t0 = time.monotonic()
    for d in (DP_DIR, DP20_DIR, DP21_DIR, DP22_DIR):
        d.mkdir(parents=True, exist_ok=True)
    a20 = serving_dp_phase(smi) if want20 else None
    t_a = time.monotonic()
    nccl_parts = ["19a"] * want19 + ["20a"] * want20 + ["21a"] * want21
    nccl = dp_child(nccl_parts, 1) if nccl_parts else {}
    gloo = dp_child(["19b"] * want19 + ["20b"] * want20 + ["21b"] * want21 + ["22b"] * want22, 2)
    t_c = time.monotonic()
    four = ["21c"] * want21 + ["22c"] * want22
    gloo4 = dp_child(four, 4) if four else {}
    seconds = round(time.monotonic() - t0, 1)
    dp19 = dp20 = dp21 = dp22 = dp23 = None
    if want19:
        dp19 = {"card": smi, "a_nccl_world1": nccl["19a"], "b_gloo_world2": gloo["19b"]}
    if want20:
        dp20 = {"card": smi, "a_serving_dp": a20, "b_nccl_world1": nccl["20a"],
                "c_gloo_world2": gloo["20b"], "seconds_20a": round(t_a - t0, 1)}
    if want21:
        dp21 = {"card": smi, "a_nccl_world1": nccl["21a"], "bc_gloo_world2": gloo["21b"],
                "c_gloo_world4": gloo4["21c"], "seconds_world4_child": round(time.monotonic()
                                                                             - t_c, 1)}
        a = nccl["21a"]
        eager = {lay: v["eager_ms_per_step"] for w in (gloo["21b"], gloo4["21c"])
                 for lay, v in w["layouts"].items()}
        dp21["beside_14c"] = ({k: moe14[k] for k in ("step_ms", "peak_gib")}
                              if moe14 is not None else None)
        print(f"[21] MoE ms/step: 21a graph {a['graph_ms_per_step']:.3f} (world 1 over NCCL) "
              f"vs {a['plain_ms_per_step']:.3f} without a group, peak {a['peak_gib']:.2f} vs "
              f"{a['plain_peak_gib']:.2f} GiB; 21b/21c eager f32 on gloo ranks {eager}, peak "
              f"{gloo['21b']['peak_gib_rank0']:.2f} / {gloo4['21c']['peak_gib_rank0']:.2f} GiB "
              f"on rank 0 (2 / 4 ranks on one card: one card, not a speed-up); 14c at ep=1 "
              + (f"{moe14['step_ms']:.3f} ms/step, peak {moe14['peak_gib']:.2f} GiB"
                 if moe14 is not None else "not run in this call") + f"; {smi}", flush=True)
    if want22:
        dp23 = {"card": smi, "world2": gloo["22b"].pop("pp23"), "world4": gloo4["22c"].pop("pp23")}
        dp22 = {"card": smi, "world2": gloo["22b"], "world4": gloo4["22c"],
                "seconds_parts": {"world2": gloo["22b"]["seconds"],
                                  "world4": gloo4["22c"]["seconds"]}}
        print(f"[23] pp on gloo ranks (one card: not a speed-up), eager ms/step vs one process: "
              + "; ".join(f"(dp, pp) = {DP23_PP[n]} {dp23[w]['eager_ms_per_step']:.1f} vs "
                          f"{dp23[w]['one_process_ms_per_step']:.1f}, peak "
                          f"{[round(x, 2) for x in dp23[w]['peak_gib_by_rank']]} vs "
                          f"{dp23[w]['one_process_peak_gib']:.2f} GiB"
                          for n, w in ((2, "world2"), (4, "world4")))
              + f"; in-rank seconds {[dp23[w]['seconds'] for w in ('world2', 'world4')]} "
              f"(target {DP23_SECONDS} s); {smi}", flush=True)
        print(f"[22] tp and sp on gloo ranks (one card: not a speed-up), eager ms/step vs one "
              f"process: " + "; ".join(
                  f"{lay} {v.get('eager_ms_per_step', v.get('eval_ms')):.1f} vs "
                  f"{v.get('one_process_ms_per_step', v.get('one_process_eval_ms')):.1f}"
                  for w in ("world2", "world4") for lay, v in dp22[w]["layouts"].items())
              + f"; in-rank seconds {dp22['seconds_parts']} (target {DP22_SECONDS} s); {smi}",
              flush=True)
    print(f"[dp] phases {'19 ' * want19}{'20 ' * want20}{'21 ' * want21}{'22 23' * want22}: "
          f"{seconds} s (torchrun children; 20a in process {round(t_a - t0, 1)} s; targets "
          f"{DP_SECONDS} s, {DP20_SECONDS} s, {DP21_SECONDS} s and {DP22_SECONDS} s; {smi})",
          flush=True)
    for d in (dp19, dp20, dp21, dp22, dp23):
        if d is not None:
            d["seconds_with_shared_children"] = seconds
    for d in (DP_DIR, DP20_DIR, DP21_DIR, DP22_DIR):
        shutil.rmtree(d, ignore_errors=True)
    return dp19, dp20, dp21, dp22, dp23

def main(phases: set | None = None) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()

    # 1. Environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    print(smi, flush=True)

    # 2. Build
    LIBRARY.build()
    print(f"[build] nvcc sm_90a, all kernels ({len(SOURCES)} sources in parallel): "
          f"{LIBRARY.build_seconds:.1f} s", flush=True)
    SAMPLER_LIBRARY.build()
    print(f"[build] g++ -O3, the C++ episode sampler (csrc/episode_sampler.cpp): "
          f"{SAMPLER_LIBRARY.build_seconds:.1f} s", flush=True)

    def on(phase: str) -> bool:
        return phases is None or phase in phases

    cfg = ExperimentConfig()                            # flagship defaults
    gen = torch.Generator().manual_seed(0)
    done: dict = {}

    # 3. Kernel vs plain
    if on("3"):
        rows = kernel_checks(gen)

    # 4, 5. The main path and the episode forward
    if on("4"):
        mp = serving_main_path()
        model, support, query = mp["model"], mp["support"], mp["query"]
        launches, main_latency = mp["launches"], mp["main_latency"]

    # 6. Training kernels vs plain (cuDNN yardsticks by M, shared with phase 7)
    if on("6"):
        library: dict = {}
        train_rows = train_kernel_checks(gen, library)
        wgrad_rows = wgrad_checks(gen)

    # 6b. Attention kernels at every row count and a wide width
    if on("6b"):
        attn_rows = attn_checks(gen)

    # 6c. The optimizer pair, 6d. the segment sum, on the flagship shapes
    if on("6"):
        optim_rows = optim_checks(model, gen)
        segsum_row = segsum_checks(model, support, query, gen)

    # 7. Full-residual kernels vs plain
    if on("7"):
        full_rows = full_kernel_checks(gen, library)

    # 8. Split recurrence: the ops API path, then the checks
    if on("8"):
        split = split_recurrence(gen)

    # 9. Training main path (W=8)
    if on("9"):
        tr = train_main_path()

    # 10. Training at lstm_cs_window=0
    if on("10"):
        tr0 = train_full_residual(tr)

    # 9c, 9d. Real-format files; lazy Adam over the token cache
    if on("9c"):
        shutil.rmtree(REAL_DIR, ignore_errors=True)
        real = write_real_files(REAL_DIR)
        tr9c = real_files_phase(real)
    if on("9d"):
        tr9d = lazy_phase(real, tr9c, gen)

    # 9e. The host feed on the same files
    if on("9e"):
        feed = feed_phase(real)

    # 4b, 4c, 4a. The serving plane on phase 9's best checkpoint
    if on("4b"):
        done["serving"] = {"correctness_load": serve_traffic(cfg)}
    if on("4c"):
        done.setdefault("serving", {})["sweep"] = sweep_process()
    if on("4a"):
        done.setdefault("serving", {})["serve_main"] = serve_checkpoint(cfg)
    shutil.rmtree(SERVE_DIR, ignore_errors=True)

    # 11. The few-shot model zoo (11c on phase 9c's files)
    if on("11"):
        zoo = zoo_phase(real)

    # 14. The rest of the single-card zoo: the adversarial step, the MoE and
    # the stacked transformer
    if on("14"):
        slice6c = done["slice6c"] = slice_phase(tr, zoo, gen, smi)

    # 13. BERT-base: fine-tuned, frozen, the feature cache (13c on 9c's files),
    # BERT-PAIR, served
    if on("13"):
        bert = done["bert"] = bert_phase(real)
    shutil.rmtree(REAL_DIR, ignore_errors=True)

    # 15. Observability: the telemetry of the training and serving paths
    if on("15"):
        obs15 = done["obs"] = obs_phase(smi)

    # 16. The serving control plane (the fleet) and the drift-triggered
    # adaptation controller
    if on("16"):
        fleet16 = done["fleet"] = fleet_phase(smi)

    # 17. The load tools: the generator and its drills, the A/Bs, the fleet
    # drills and the fleet report
    if on("17"):
        load17 = done["load"] = load_phase(smi)

    # 18. The single-card tools: the lazy-to-dense converter, the zoo sweep,
    # the run report (also on the run directories phases 15-17 kept)
    if on("18"):
        tools18 = done["tools"] = tools_phase(smi, [
            r for key in ("obs", "fleet", "load") for r in done.get(key, {}).get("report_runs", [])])
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)

    # 19. Data parallel: world size 1 over NCCL (captured), two gloo ranks on
    # the card (eager); the ranks are child processes. 20. The rest of data
    # parallel: the dp-sharded serving engine (in this process), --adv,
    # --mixture and --feature_cache at world size 1 over NCCL (captured) and
    # on two gloo ranks on the card (eager), in the same two children.
    # 21. MoE across ranks: the routing and the load-balance term over the
    # global batch at world size 1 over NCCL (captured, in 19's child) and on
    # gloo ranks on the card (eager: dp=2, ep=2 and both, 2 and 4 ranks).
    # 22. Tensor and sequence parallel: gloo ranks on the card (eager) in
    # the two- and four-rank children of phases 19-21. 23. Pipeline
    # parallel: the GPipe executor in the same children, after 22.
    if on("19") or on("20") or on("21") or on("22"):
        dp19, dp20, dp21, dp22, dp23 = dp_phases(smi, on("19"), on("20"), on("21"),
                                                 done.get("slice6c", {}).get("c_moe"), on("22"))
        for phase, key, value in (("19", "dp", dp19), ("20", "dp20", dp20),
                                  ("21", "dp21", dp21), ("22", "dp22", dp22),
                                  ("22", "dp23", dp23)):
            if on(phase):
                done[key] = value

    if phases is not None:
        # A selected run: each phase's own line, then the final lines.
        for key, value in done.items():
            print(json.dumps({key: value}, default=str), flush=True)
        print(f"[done] phases {sorted(phases)}: {time.monotonic() - t_start:.1f} s",
              flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0

    # 12. Summary lines
    def attn_extra(key: str, M: int) -> dict:
        """Phase 6b's figures of an attention kernel: device time and plan
        at the row's M, its worst error there, and the wide case."""
        r = attn_rows[(key, f"bf16 M={M} D={H_DIM} A={A}")]
        wide = attn_rows[(key, f"bf16 M={M} D=1280 A=300")]
        return {"device_ms": r["device_ms"], "plan": r["plan"],
                "max_abs_err_6b": max(v["err"] for (k, _), v in attn_rows.items() if k == key),
                "ms_wide_d1280_a300": wide["ms"], "device_ms_wide_d1280_a300": wide["device_ms"],
                "device_ms_m16" if M == 200 else "device_ms_m200": attn_rows[
                    (key, f"bf16 M={16 if M == 200 else 200} D={H_DIM} A={A}")]["device_ms"]}

    def zoo_launches(key: str) -> int:
        """Launches of ``key`` over phase 11's runs (profiler)."""
        return sum(v["launches"][key] for k, v in zoo.items() if "/" in k)

    zoo_optim = [v["optim"] for k, v in zoo.items() if "/" in k]
    # Phase 9e(a)'s main path: the flagship on the C++ sampler behind the feed.
    feed_launches = feed["a_flagship"]["rows"]["native d2"]["launches"]

    adv_launches = slice6c["a_adv"]["launches"]
    kernels = []
    for key, name, src, replaces in (
        ("K1", "bilstm_infer_fwd", "induction_network_on_fewrel_tpu_torch/csrc/bilstm_infer.cu",
         "induction_network_on_fewrel_tpu/ops/lstm.py:729"),
        ("K2", "attn_fwd", "induction_network_on_fewrel_tpu_torch/csrc/attn_fwd.cu",
         "induction_network_on_fewrel_tpu/ops/attn.py:122"),
    ):
        r = rows[(key, "bf16", 16)]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[key],
            "max_abs_err": max(v["err"] for (k, _, _), v in rows.items() if k == key),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "at": "L=40 M=16 bf16 (serving bucket 16)", "launches_val": tr["launches"][key],
            "launches_feed_9e": feed_launches[key],
            "launches_zoo": zoo_launches(key),
            "launches_serve_wrappers": (done["serving"]["serve_main"]["launches"][key]
                                        + done["serving"]["correctness_load"]["launches"][key]),
            "launches_serve_profiled": done["serving"]["correctness_load"]["profiled"][key],
            "serve_batches_profiled": done["serving"]["correctness_load"]["profiled_batches"],
            **{f"ms_m{M}": rows[(key, "bf16", M)]["ms"] for M in SERVE_ROWS if M != 16},
            "bound_ms_m200": rows[(key, "bf16", 200)]["bound_ms"],
            **({"train_library_ms": r["train_library_ms"], "plan": r["plan"]}
               if key == "K1" else attn_extra(key, 16)),
        })
    main_case = "bf16 M=200 W=8 res=bf16"
    for key, name, src, replaces in (
        ("K7", "bilstm_win_fwd", "induction_network_on_fewrel_tpu_torch/csrc/bilstm_infer.cu",
         "induction_network_on_fewrel_tpu/ops/lstm.py:969"),
        ("K8", "bilstm_win_bwd", "induction_network_on_fewrel_tpu_torch/csrc/bilstm_win_bwd.cu",
         "induction_network_on_fewrel_tpu/ops/lstm.py:1000"),
        ("K10", "attn_fwd_stats", "induction_network_on_fewrel_tpu_torch/csrc/attn_fwd.cu",
         "induction_network_on_fewrel_tpu/ops/attn.py:122"),
        ("K11", "attn_bwd", "induction_network_on_fewrel_tpu_torch/csrc/attn_bwd.cu",
         "induction_network_on_fewrel_tpu/ops/attn.py:168"),
    ):
        r = train_rows[(key, main_case)]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": tr["launches"][key],
            "max_abs_err": max(v["err"] for (k, _), v in train_rows.items() if k == key),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "at": "L=40 M=200 bf16 W=8 (training step, B=4 episodes)"
                  + ("; chain kernel + lstm_wgrad" if key == "K8" else ""),
            "launches_zoo": zoo_launches(key), "launches_feed_9e": feed_launches[key],
            "ms_m16": train_rows[(key, "bf16 M=16 W=8 res=bf16")]["ms"],
            **({"plan": r["plan"]} if "plan" in r else {}),
            **({"ms_min": r["spread"][1], "ms_max": r["spread"][2]} if "spread" in r else {}),
            **(attn_extra(key, 200) if key in ("K10", "K11") else {}),
        })
    for key, name, src, replaces in (
        ("K4", "bilstm_full_fwd", "induction_network_on_fewrel_tpu_torch/csrc/bilstm_infer.cu",
         "induction_network_on_fewrel_tpu/ops/lstm.py:706"),
        ("K6", "bilstm_full_bwd", "induction_network_on_fewrel_tpu_torch/csrc/bilstm_full_bwd.cu",
         "induction_network_on_fewrel_tpu/ops/lstm.py:751"),
    ):
        r = full_rows[(key, "bf16 M=200 res=bf16")]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": tr0["launches"][key],
            "max_abs_err": max(v["err"] for (k, _), v in full_rows.items() if k == key),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "at": "L=40 M=200 bf16 res=bf16 (training step at lstm_cs_window=0)"
                  + ("; chain kernel + lstm_wgrad" if key == "K6" else ""),
            "ms_m16": full_rows[(key, "bf16 M=16 res=bf16")]["ms"],
            **({"plan": r["plan"]} if "plan" in r else {}),
            **({"ms_min": r["spread"][1], "ms_max": r["spread"][2]} if "spread" in r else {}),
        })
    r = wgrad_rows[("wgrad", "bf16 M=200 hp")]
    kernels.append({
        "name": "lstm_wgrad", "route": "cuda",
        "source": "induction_network_on_fewrel_tpu_torch/csrc/lstm_wgrad.cu",
        "replaces": "induction_network_on_fewrel_tpu/ops/lstm.py:1090",
        "launches": tr["launches"]["wgrad"], "launches_zoo": zoo_launches("wgrad"),
        "launches_feed_9e": feed_launches["wgrad"],
        "max_abs_err": max(v["err"] for v in wgrad_rows.values()),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        "at": "L=40 M=200 bf16, K8's da and hp streams (training step)",
        "ms_hs": wgrad_rows[("wgrad", "bf16 M=200 hs")]["ms"],
        "ms_m16": wgrad_rows[("wgrad", "bf16 M=16 hp")]["ms"],
    })
    for key, name, replaces in (
        ("split2", "lstm_split_fwd_infer", "induction_network_on_fewrel_tpu/ops/lstm.py:189"),
        ("split1", "lstm_split_fwd", "induction_network_on_fewrel_tpu/ops/lstm.py:157"),
        ("split3", "lstm_split_bwd", "induction_network_on_fewrel_tpu/ops/lstm.py:215"),
    ):
        r = split["rows"][(key, "bf16 M=200 tm")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "induction_network_on_fewrel_tpu_torch/csrc/lstm_split.cu",
            "replaces": replaces, "launches": split["launches"][key],
            "max_abs_err": max(v["err"] for (k, _), v in split["rows"].items() if k == key),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "at": "L=40 M=200 u=128 bf16, bilstm_recurrence_tm (2 groups)",
            "ms_m16": split["rows"][(key, "bf16 M=16 tm")]["ms"],
        })
    step_at = "the flagship parameter list (training step, Adam, shared table)"
    bert_optim_rows = bert["a_finetune"]["optim"]
    for key in ("optim_sumsq", "optim_update"):
        r = optim_rows[key]
        b = bert_optim_rows[key]
        kernels.append({
            "name": key, "route": "cuda",
            "source": "induction_network_on_fewrel_tpu_torch/csrc/optim.cu",
            "replaces": "induction_network_on_fewrel_tpu/train/steps.py:48",
            "launches": tr["launches"][key], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "at": step_at + "; ms, plain_ms and library_ms are device times under the profiler",
            "ms_events": r["ms_events"],
            "launches_w0": tr0["launches"][key], "launches_zoo": zoo_launches(key),
            "launches_feed_9e": feed_launches[key],
            ("rel_err_zoo" if key == "optim_sumsq" else "max_abs_err_zoo"):
                max(w["sumsq_rel" if key == "optim_sumsq" else "update_err"] for w in zoo_optim),
            **({k: r[k] for k in ("pair_ms", "clip_grad_norm_adam_fused_ms")}
               if key == "optim_update" else {}),
            "launches_bert": {p: bert[p]["launches"][key] for p in
                              ("a_finetune", "b_frozen", "c_feature_cache", "d_pair")},
            "max_abs_err_bert": bert_optim_rows["err"],
            **{f"{k}_bert": b[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms")},
            "at_bert": f"BERT-base's {bert_optim_rows['tensors']} tensors, "
                       f"{bert_optim_rows['elements']} elements (phase 13a; device times)",
        })
    for key, replaces in (("lazy_catchup", "induction_network_on_fewrel_tpu/train/lazy_embed.py:147"),
                          ("lazy_scatter", "induction_network_on_fewrel_tpu/train/lazy_embed.py:460")):
        r = tr9d["kernels"][key]
        kernels.append({
            "name": key, "route": "cuda",
            "source": "induction_network_on_fewrel_tpu_torch/csrc/lazy_embed.cu",
            "replaces": replaces, "launches": r["launches"], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "at": f"R=U={r['R']} corpus rows x 50, the trained 9d run's state (every row "
                  "current); once per replay of 4 steps"
                  + ("" if key == "lazy_scatter" else " and at each materialize"),
            "ms_gaps_0_1500": r["ms_gaps_0_1500"], "plain_ms_gaps_0_1500": r["plain_ms_gaps_0_1500"],
            **({k: r[k] for k in ("materialize_ms", "materialize_bound_ms",
                                  "materialize_moved_rows")} if key == "lazy_catchup" else {}),
        })
    # Phase 14a's profiled launches (20 adversarial steps and a val pass):
    # each kernel by its PROFILED key; the split recurrence is off that path.
    profiled_key = {"bilstm_infer_fwd": "K1", "attn_fwd": "K2", "bilstm_win_fwd": "K7",
                    "bilstm_win_bwd": "K8", "attn_fwd_stats": "K10", "attn_bwd": "K11",
                    "bilstm_full_fwd": "K4", "bilstm_full_bwd": "K6", "lstm_wgrad": "wgrad"}
    fleet_launches = fleet16["a_success"]["launches_fleet"]
    load_launches = load17["launches"]
    adapt_launches = fleet16["a_success"]["launches_adapt"]
    tools_launches = tools18["a_convert"]["launches"]
    for k in kernels:
        key = profiled_key.get(k["name"], k["name"])
        k["launches_adv"] = adv_launches.get(key, 0)
        k["launches_fleet"] = fleet_launches.get(key, 0)
        k["launches_adapt"] = adapt_launches.get(key, 0)
        k["launches_load"] = load_launches.get(key, 0)
        k["launches_tools"] = tools_launches.get(key, 0)
        k["launches_dp_19a_per_step"] = dp19["a_nccl_world1"]["launches_per_step"].get(key, 0.0)
        k["launches_dp_19b_per_step"] = dp19["b_gloo_world2"]["launches_per_step"].get(key, 0.0)
        k["launches_serving_dp"] = dp20["a_serving_dp"]["launches"].get(key, 0)
        k["launches_dp_20"] = {
            **{f"{p}_per_step": dp20["b_nccl_world1"][p]["launches_per_step"].get(key, 0.0)
               for p in ("adv", "mixture", "cache")},
            "gloo_20c": dp20["c_gloo_world2"]["launches"].get(key, 0)}
        k["launches_moe_dp_21"] = {
            "21a_per_step": dp21["a_nccl_world1"]["launches_per_step"].get(key, 0.0),
            **{f"gloo_{lay}_per_step": v["launches_per_step"].get(key, 0.0)
               for w in ("bc_gloo_world2", "c_gloo_world4")
               for lay, v in dp21[w]["layouts"].items()}}
        k["launches_tp_sp_22"] = {
            f"{v['part']}_{lay}_per_rank_per_step": [c.get(key, 0.0) for c in
                                                     v["launches_per_step_by_rank"]]
            for w in ("world2", "world4") for lay, v in dp22[w]["layouts"].items()
            if "launches_per_step_by_rank" in v}
        k["launches_pp_23"] = {
            f"{dp23[w]['part']}_per_rank_per_step": [c.get(key, 0.0) for c in
                                                     dp23[w]["launches_per_step_by_rank"]]
            for w in ("world2", "world4")}
    steps_summary = {
        tag: {"graph_ms_per_step": r["prof1"]["step_ms"],
              "graph_spc4_ms_per_step": r["prof4"]["step_ms"],
              "busy_ms_eager": r["eager"]["busy_ms"], "busy_ms_graph": r["prof1"]["busy_ms"],
              "launches_eager": r["eager"]["launches"], "launches_graph": r["prof1"]["launches"],
              "host_split_ms": r["prof1"]["split"], "host_split_ms_spc4": r["prof4"]["split"],
              "pool_bytes": r["prof1"]["pool_bytes"], "pool_bytes_spc4": r["prof4"]["pool_bytes"],
              "graph_vs_eager": r["graph"], "fused_vs_single": r["fused"]}
        for tag, r in (("W=8", tr), ("W=0", tr0))
    }
    steps_summary["segsum_index_add"] = segsum_row
    steps_summary["real_files_9c"] = {k: v for k, v in tr9c.items() if k != "vocab"}
    steps_summary["lazy_token_cache_9d"] = {k: v for k, v in tr9d.items() if k != "kernels"}
    steps_summary["zoo_11"] = zoo
    print(json.dumps({"training_step": steps_summary}), flush=True)
    feed["b_real_files"].update({"9c today": feed_columns(tr9c["prof"]),
                                 "9d today": feed_columns(tr9d["prof"])})
    feed["c_zoo"].update({f"{m}/cnn phase 11": {
        k: zoo[f"{m}/cnn"][k] for k in ("step_ms", "episodes_per_s", "sample_ms", "busy_ms")}
        | {"card_share": zoo[f"{m}/cnn"]["busy_share"]} for m in FEED_ZOO_MODELS})
    print(json.dumps({"feed": feed}), flush=True)
    print(json.dumps({"serving": {"main_path_p50_ms_by_bucket": main_latency,
                                  **done["serving"]}}), flush=True)
    print(json.dumps({"bert": bert}), flush=True)
    print(json.dumps({"slice6c": slice6c}), flush=True)
    print(json.dumps({"obs": obs15}, default=str), flush=True)
    print(json.dumps({"fleet": fleet16}, default=str), flush=True)
    print(json.dumps({"load": load17}, default=str), flush=True)
    print(json.dumps({"tools": tools18}, default=str), flush=True)
    print(json.dumps({"dp": dp19}, default=str), flush=True)
    print(json.dumps({"dp20": dp20}, default=str), flush=True)
    print(json.dumps({"dp21": dp21}, default=str), flush=True)
    print(json.dumps({"dp22": dp22}, default=str), flush=True)
    print(json.dumps({"dp23": dp23}, default=str), flush=True)
    print(f"[done] {time.monotonic() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


# ``--phases``: the phases to run (1, the environment, and 2, the build,
# always run), each with the phases whose results it needs run first.
PHASE_NEEDS = {"1": (), "2": (), "3": (), "4": (), "6": ("4",), "6b": (), "7": ("6",), "8": (),
               "9": (), "10": ("9",), "9c": (), "9d": ("9c",), "9e": ("9c",), "4b": ("9",),
               "4c": ("9",), "4a": ("9",), "11": ("9c",), "14": ("9", "11"), "13": ("9c",),
               "15": (), "16": (), "17": (), "18": (), "19": (), "20": (), "21": (), "22": (),
               "23": ("22",)}
PHASE_ALIASES = {"5": "4", "6c": "6", "6d": "6"}


def parse_phases(argv: list) -> set | None:
    """None (every phase) without arguments; else the set ``--phases
    A,B,...`` names, closed over ``PHASE_NEEDS``."""
    import argparse

    ap = argparse.ArgumentParser(description="GPU smoke run of the port (one CUDA card)")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run, e.g. 2,17 (default: all); the "
                         "build and the final lines always run")
    spec = ap.parse_args(argv).phases
    if spec is None:
        return None
    want: set = set()

    def add(phase: str) -> None:
        phase = PHASE_ALIASES.get(phase, phase)
        if phase not in PHASE_NEEDS:
            ap.error(f"unknown phase {phase!r}; phases: {', '.join(PHASE_NEEDS)}")
        for need in PHASE_NEEDS[phase]:
            add(need)
        want.add(phase)

    for phase in spec.split(","):
        add(phase.strip())
    return want


if __name__ == "__main__":
    if sys.argv[1:] == ["--sweep"]:
        sys.exit(sweep_main())
    if len(sys.argv) >= 3 and sys.argv[1][len("--dp"):] in DP_PARTS:
        sys.exit(dp_child_main(sys.argv[1:]))
    sys.exit(main(parse_phases(sys.argv[1:])))
