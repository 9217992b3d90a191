"""The port's fleet drills (``load/fleet.py``, ``load/recovery.py``,
``load/elastic.py``) on the CPU, held to the JAX tool's gates and to the
committed JAX artifacts' tier-1 blocks.

* ``fleet_tier1_drill`` at ``FLEET_r01.json``'s tier-1 seed: the
  placement distribution, the add churn, the victim and every replica-kill
  verdict equal the artifact's (the JAX drill costs ~18 s on the CPU, so
  the port is held to the block the JAX test holds the JAX drill to).
* A short fleet soak (3 replicas, 24 tenants) passes the JAX
  ``check_fleet_soak``.
* ``recovery_tier1_drill`` and ``elastic_tier1_drill`` at their artifacts'
  seeds pass the JAX gates and equal the artifacts on the values the JAX
  tier-1 tests pin and on every other decision (placement, victims,
  replica names, counts; wall times left out). Each JAX drill costs
  more than 20 s cold on the CPU (its first XLA compiles), so the port is
  held to the artifact the JAX tier-1 test holds the JAX drill to.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import json
import os
import sys

import pytest
import torch

from induction_network_on_fewrel_tpu_torch.load import elastic, fleet, harness, recovery
from induction_network_on_fewrel_tpu_torch.utils.metrics import MetricsLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOOLS = os.path.join(REPO, "tools")
if _TOOLS not in sys.path:
    sys.path.insert(0, _TOOLS)

import loadgen  # noqa: E402
import obs_report  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _artifact(name):
    with open(os.path.join(REPO, name)) as f:
        return json.load(f)


def _drop_times(d):
    """A drill dict without its wall-clock readings."""
    if isinstance(d, dict):
        return {k: _drop_times(v) for k, v in d.items()
                if not (k.endswith("_s") or k in ("wall_s",))}
    return d


def test_fleet_tier1_equals_the_jax_artifact(tmp_path):
    t1 = _artifact("FLEET_r01.json")["tier1"]
    logger = MetricsLogger(tmp_path, quiet=True)
    try:
        res = fleet.fleet_tier1_drill(seed=int(t1["seed"]), logger=logger, device="cpu")
    finally:
        logger.close()
    assert res["passed"], res
    assert abs(res["add_churn_frac"] - t1["add_churn_frac"]) <= t1["band"]["churn_frac_abs"]
    assert res["placement_distribution"] == t1["placement_distribution"]
    assert res["replica_kill"] == {k: t1["replica_kill"][k] for k in res["replica_kill"]}
    assert res["steady_recompiles"] == 0
    assert {k: v for k, v in res.items() if k != "band"}.keys() == \
        {k for k in t1 if k != "band"}
    _, errors = obs_report.check_schema(tmp_path / "metrics.jsonl")
    assert errors == [], errors


def test_fleet_soak_passes_the_jax_gate(tmp_path):
    args = harness.parse_args(["--device", "cpu", "--fleet", "3", "--tenants", "24",
                               "--duration", "1.0", "--concurrency", "2", "--K", "2",
                               "--buckets", "1,2,4"])
    ckpt = harness.make_synthetic_checkpoint(args, str(tmp_path))
    soak = fleet.run_fleet_soak(args, ckpt, None, None, None)
    assert loadgen.check_fleet_soak(soak), json.dumps(soak, default=str)
    assert fleet.check_fleet_soak(soak) and soak["passed"]
    art = _artifact("FLEET_r01.json")
    # The artifact predates the soak's time series.
    assert set(art) - {"config", "tier1"} == set(soak) - {"timeseries"}
    assert soak["timeseries"]["windows"]
    assert sum(soak["placement_distribution"].values()) == 24


def _decisions(d):
    """An artifact or a drill dict without its stamps and wall times."""
    return _drop_times({k: v for k, v in d.items() if k not in ("round", "generated_by")})


def test_recovery_drill_equals_the_jax_artifact(tmp_path):
    art = _artifact("RECOVERY_r01.json")
    logger = MetricsLogger(tmp_path, quiet=True)
    try:
        res = recovery.recovery_tier1_drill(seed=int(art["seed"]), logger=logger, device="cpu")
    finally:
        logger.close()
    assert loadgen.check_recovery_drill(res) and res["passed"], res
    assert res["placement_distribution"] == art["placement_distribution"]
    for arm, key in (("router_kill", "lost_replica"), ("router_kill", "reregistered"),
                     ("replica_kill", "victim"), ("replica_kill", "restart_attempts")):
        assert res[arm][key] == art[arm][key], (arm, key)
    assert res["zero_bands"] == art["zero_bands"]
    assert _decisions(res) == _decisions(art)
    _, errors = obs_report.check_schema(tmp_path / "metrics.jsonl")
    assert errors == [], errors


def test_elastic_drill_equals_the_jax_artifact(tmp_path):
    art = _artifact("ELASTIC_r01.json")
    logger = MetricsLogger(tmp_path, quiet=True)
    try:
        res = elastic.elastic_tier1_drill(seed=int(art["seed"]), logger=logger, device="cpu")
    finally:
        logger.close()
    assert loadgen.check_elastic_drill(res) and res["passed"], res
    for arm, keys in (("scale_out", ("replica", "warm_compiles", "moved")),
                      ("drain_in", ("replica", "inflight_at_drain")),
                      ("promotion", ("scale_out2_replica", "lease_epoch"))):
        for key in keys:
            assert res[arm][key] == art[arm][key], (arm, key)
    assert res["zero_bands"] == art["zero_bands"]
    assert _decisions(res) == _decisions(art)
    _, errors = obs_report.check_schema(tmp_path / "metrics.jsonl")
    assert errors == [], errors


def test_tear_journal_refuses_then_heals(tmp_path):
    """The torn-tail mechanics on a one-replica journaled fleet."""
    from induction_network_on_fewrel_tpu_torch.fleet import (
        FleetControl,
        FleetJournal,
        FleetRouter,
        InProcessReplica,
    )

    world = fleet.tiny_world(5, "cpu")
    journal = FleetJournal(tmp_path / "j", fsync="always")
    router = FleetRouter({"r00": InProcessReplica("r00", world.engine())})
    control = FleetControl(router, journal=journal)
    try:
        for i in range(3):
            control.register_tenant(f"t{i}", world.datasets[i])
        out = recovery.tear_journal(control, tmp_path / "j", "t0", "t1")
    finally:
        router.close()
        journal.close()
    assert out == {"append_refused_after_tear": True, "prefix_recovered": True,
                   "appendable_after_heal": True}
