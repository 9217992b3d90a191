"""load/ — the load tools of the port: the load generator and its drills,
the scenario harness and the fleet report.

The counterpart of the JAX repository's ``tools/loadgen.py``,
``tools/scenarios.py`` and ``tools/fleet_report.py`` on the port's engine,
fleet and trainer. Each drill returns the JAX drill's dict with the JAX
keys, so the JAX ``check_*`` gates read the port's dicts unchanged.

* ``harness``      — flags, the synthetic checkpoint, engines, tenants, the
                     registry-parity gate, the closed/open loops, ``pct``.
* ``burn``         — the SLO burn-rate drill.
* ``drift``        — the drift drill and its calibrated NOTA floor.
* ``chaos``        — the fault-domain drill and its ring-slot leg.
* ``quant``        — the f32/bf16/int8 resident-dtype A/B.
* ``scenarios``    — the model-quality scenario harness (``python -m``).
* ``geom``         — the tiered vs exact-N geometry A/B with the grid leg.
* ``fleet``        — the fleet soak and its tier-1 miniature.
* ``recovery``     — the durability drill (router kill, supervised
                     restart, torn journal tail).
* ``elastic``      — the elasticity drill (scale-out, drain-in, standby
                     promotion).
* ``fleet_report`` — the cross-process fleet report (``python -m``).
* ``fleet_obs``    — the fleet observability drill, on ``fleet_report``.
* ``__main__``     — ``python -m induction_network_on_fewrel_tpu_torch.load``.

Entry points run on ``cuda`` unless given ``--device cpu``
(``device="cpu"``); without CUDA they refuse to start. Reports are written
only to paths the caller names.
"""
