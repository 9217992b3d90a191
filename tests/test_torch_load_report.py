"""The port's fleet report (``load/fleet_report.py``) and fleet-obs drill
(``load/fleet_obs.py``) against the JAX tools ``tools/fleet_report.py``
and ``tools/loadgen.py``, on the CPU.

* ``clock_offsets``, ``stitch``, ``waterfall_lines``, ``build_timeline``
  and the event labels equal the JAX functions on the same records.
* ``build_report`` equals the JAX ``build_report`` exactly on a run
  directory the JAX ``fleet_obs_drill`` wrote and on one the port's wrote.
* The port's drill passes its acceptance and equals ``OBSFLEET_r01.json``
  on every count (requests, stitching, timeline, failures, the victim);
  ``main --check`` is green on its directory and red once a replica's
  trace is lost.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from induction_network_on_fewrel_tpu_torch.load import fleet_report as treport
from induction_network_on_fewrel_tpu_torch.load.fleet_obs import fleet_obs_drill

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOOLS = os.path.join(REPO, "tools")
if _TOOLS not in sys.path:
    sys.path.insert(0, _TOOLS)

import fleet_report  # noqa: E402
import loadgen  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- pure functions on the same records ----------------------------------------------


def _records(seed: int):
    """Router records (hops, fleet events, health, scale) and replica
    records (request traces, faults), with clock offsets and a few records
    no stitch or label accepts."""
    rng = np.random.default_rng(seed)
    router, replicas = [], {"r01": [], "r02": []}
    t = 1_700_000_000.0
    for i in range(30):
        rid = ("r01", "r02")[i % 2]
        tid = f"{seed:04x}-{i:08d}"
        segs = {f"{s}_ms": float(rng.uniform(0.01, 2.0)) for s in fleet_report.ROUTER_SEGMENTS}
        if i % 7 != 3:   # every 7th hop's remote record is lost
            rsegs = {f"{s}_ms": float(rng.uniform(0.01, 1.0))
                     for s in fleet_report.REPLICA_SEGMENTS}
            replicas[rid].append({"kind": "trace", "trace_id": tid, **rsegs,
                                  "total_ms": sum(rsegs.values()), "t_unix": t + i})
        router.append({"kind": "hop", "trace_id": tid, "replica": rid, "tenant": f"t{i % 3}",
                       "router_ms": sum(segs.values()) * (1.2 if i == 5 else 1.0),
                       "hop_ms": float(rng.uniform(0, 1)), **segs,
                       "offset_ms": float(rng.normal(0, 3)), "t_unix": t + i})
    replicas["r02"].append({"kind": "trace", "trace_id": "orphan-1", "total_ms": 1.0})
    replicas["r01"].append({"kind": "trace", "trace_id": "ctl", "op": "publish",
                            "total_ms": 2.0})
    events = [
        {"kind": "fleet", "event": "journal_op", "op": "register", "seq": 1},
        {"kind": "fleet", "event": "fanout_publish", "params_version": 2, "replicas": 3,
         "publish_s": 0.1},
        {"kind": "fleet", "event": "replica_add", "replica": "r03", "replicas": 3},
        {"kind": "fleet", "event": "replica_retire", "replica": "r03", "replicas": 2},
        {"kind": "fleet", "event": "replace", "moved": 4},
        {"kind": "fleet", "event": "journal_compact", "snapshot_seq": 9},
        {"kind": "fleet", "event": "rollup"},
        {"kind": "scale", "event": "scale_out", "replica": "r03", "occupancy": 0.9,
         "shed_delta": 2},
        {"kind": "scale", "event": "drain_in", "replica": "r03", "moved": 2},
        {"kind": "scale", "event": "promotion", "promote_s": 0.2, "lease_epoch": 2},
        {"kind": "scale", "event": "tick"},
        {"kind": "health", "event": "slo_fast_burn", "tenant": "t0", "burn_fast": 20.0},
        {"kind": "health", "event": "drift", "severity": "critical", "message": "m"},
        {"kind": "health", "event": "x", "severity": "warning"},
        {"kind": "adapt", "action": "trigger", "tenant": "t1", "state": "triggered"},
    ]
    for j, e in enumerate(events):
        router.append({**e, **({"t_unix": t + 0.5 + j} if j != 6 else {})})
    for j, a in enumerate(("replica_dead", "replica_recover", "publish_rollback", "recovered",
                           "breaker", "scale_stuck", "other")):
        replicas["r01"].append({"kind": "fault", "action": a, "replica": "r01",
                                "reason": "drill", "tenants": 2, "reregistered": 1,
                                "tenant": "t0", "from": "closed", "to": "open",
                                "direction": "out", "t_unix": t + 2.25 + j})
    replicas["r02"].append({"kind": "fault", "action": "replica_dead", "replica": "r02",
                            "reason": "no clock", "tenants": 1})
    return router, replicas


@pytest.mark.parametrize("seed", range(3))
def test_stitch_offsets_timeline_equal_jax(seed):
    router, replicas = _records(seed)
    assert treport.clock_offsets(router) == fleet_report.clock_offsets(router)
    got, want = treport.stitch(router, replicas), fleet_report.stitch(router, replicas)
    assert got == want and got["unstitched"] and got["orphan_spans"] == 1
    for (h, rid, tr), _ in zip(got["pairs"], range(4)):
        assert treport.waterfall_lines(h, rid, tr) == fleet_report.waterfall_lines(h, rid, tr)
    offsets = fleet_report.clock_offsets(router)
    for offs in (offsets, {}, {"r01": 1e4}):
        assert treport.build_timeline(router, replicas, offs) == \
            fleet_report.build_timeline(router, replicas, offs)
    for r in router + [x for v in replicas.values() for x in v]:
        assert treport._event_label(r) == fleet_report._event_label(r)


# --- build_report on two run directories ---------------------------------------------


def _report_both(root):
    args = (root, None, [], None)
    t, j = treport.discover(*args), fleet_report.discover(*args)
    assert t == j
    return (treport.build_report(root, *t, skew_bound_ms=250.0, n_waterfalls=3),
            fleet_report.build_report(root, *j, skew_bound_ms=250.0, n_waterfalls=3))


def test_build_report_equals_jax_on_a_jax_run_dir(tmp_path):
    drill = loadgen.fleet_obs_drill(seed=0, fleet_dir=str(tmp_path / "jax"))
    assert drill["passed"]
    got, want = _report_both(tmp_path / "jax")
    assert got == want
    assert treport.render(got) == fleet_report.render(want)
    assert not got["failures"] and got["journal"]["wal_records"] >= 8


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet_obs") / "run"
    return root, fleet_obs_drill(seed=0, fleet_dir=str(root), device="cpu")


def test_port_drill_equals_the_jax_artifact(port_run):
    _, drill = port_run
    with open(os.path.join(REPO, "OBSFLEET_r01.json")) as f:
        art = json.load(f)
    assert drill["passed"], json.dumps(drill, default=str)
    assert set(drill) == set(art) - {"round", "generated_by"}
    for key in ("replicas", "tenants", "seed", "requests", "victim", "stitching",
                "zero_bands", "check_failures", "waterfalls_rendered"):
        assert drill[key] == art[key], key
    assert drill["timeline"] == art["timeline"]
    assert set(drill["hop"]) == set(art["hop"])
    assert set(drill["clock"]["per_replica"]) == set(art["clock"]["per_replica"])


def test_build_report_equals_jax_on_a_port_run_dir(port_run):
    root, _ = port_run
    got, want = _report_both(root)
    assert got == want and not got["failures"]
    assert treport.render(got) == fleet_report.render(want)


def test_check_green_then_red_when_a_trace_is_lost(port_run, tmp_path, capsys):
    root, _ = port_run
    assert treport.main([str(root), "--check"]) == 0
    capsys.readouterr()
    assert treport.main([str(root), "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert fleet_report.main([str(root), "--json"]) == 0
    assert got == json.loads(capsys.readouterr().out)
    broken = tmp_path / "broken"
    shutil.copytree(root, broken)
    rep = sorted(p for p in broken.iterdir() if p.name.startswith("r0"))[0]
    lines = (rep / "metrics.jsonl").read_text().splitlines()
    keep = [x for x in lines if '"kind": "trace"' not in x or '"op"' in x]
    assert len(keep) < len(lines)
    (rep / "metrics.jsonl").write_text("\n".join(keep) + "\n")
    assert treport.main([str(broken), "--check"]) == 1
    assert fleet_report.main([str(broken), "--check"]) == 1
    assert treport.main([str(tmp_path / "nothing")]) == 2
