"""tools/ — the port's single-card tools, under the JAX repository's
``tools/`` file names.

* ``obs_report``       — the run report and the schema gate of a run
                         directory's ``metrics.jsonl`` (host work; no device).
* ``convert_lazy_ckpt`` — a lazy word-table checkpoint directory into a
                         shared (dense) one that the trainer resumes.
* ``zoo_quality``      — the model zoo's best synthetic-val accuracy, one
                         JSON line per model, through the port's CLI.

Each runs as ``python -m induction_network_on_fewrel_tpu_torch.tools.<name>``.
The converter and the sweep run on ``cuda`` unless given ``--device cpu``;
without CUDA they refuse to start.
"""
