"""The port's elastic fleet (autoscaler, hot standby) against the JAX package's.

On stub replicas with settable occupancy and queue depth and an injected
clock, both packages' autoscalers take the same decisions through a
scale-out and a drain-in (hysteresis, cool-down, bounds, the drain waiting
for an empty queue), and both packages' standbys tail the same WAL,
promote into the same directory and fence the old primary.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import json
from concurrent.futures import Future
from types import SimpleNamespace

import pytest

import induction_network_on_fewrel_tpu.fleet as jfleet
import induction_network_on_fewrel_tpu.fleet.transport as jtransport
import induction_network_on_fewrel_tpu_torch.fleet as tfleet
import induction_network_on_fewrel_tpu_torch.fleet.transport as ttransport

PKGS = {"jax": SimpleNamespace(fleet=jfleet, transport=jtransport),
        "port": SimpleNamespace(fleet=tfleet, transport=ttransport)}
SOURCE = {"rel0": [{"tokens": ["alpha", "beta", "gamma"], "head_pos": [0], "tail_pos": [2]}]}


def _replica_class(pkg):
    class Rep(pkg.fleet.ReplicaHandle):
        def __init__(self, rid, version=1):
            self.replica_id, self.version = rid, version
            self.registered: list[str] = []
            self.queue_depth, self.occupancy, self.closed, self.warmups = 0, 0.0, False, 0

        def submit(self, instance, deadline_s=None, tenant="default", trace=None):
            f: Future = Future()
            f.set_result({"label": "rel0", "tenant": tenant, "replica": self.replica_id})
            return f

        def has_tenant(self, tenant):
            return tenant in self.registered

        def register_dataset(self, dataset, tenant, max_classes=None):
            self.registered.append(tenant)
            return []

        def set_nota_threshold(self, threshold, tenant):
            pass

        def quarantine_tenant(self, tenant, reason=""):
            pass

        def unquarantine_tenant(self, tenant, reason=""):
            pass

        def drop_tenant(self, tenant):
            pass

        def prepare_publish(self, params=None, ckpt_dir=None, target_version=None):
            return ("txn", target_version)

        def commit_publish(self, txn):
            self.version = txn[1] if txn[1] is not None else self.version + 1
            return self.version

        def abort_publish(self, txn):
            pass

        @property
        def params_version(self):
            return self.version

        def stats_snapshot(self):
            return {"served": 0, "steady_recompiles": 0, "batch_occupancy": self.occupancy,
                    "queue_depth": self.queue_depth}

        def warmup(self):
            self.warmups += 1
            return 1

        def close(self):
            self.closed = True

    return Rep


def _fleet(pkg, d, n):
    Rep = _replica_class(pkg)
    router = pkg.fleet.FleetRouter({f"r{i:02d}": Rep(f"r{i:02d}") for i in range(n)})
    journal = pkg.fleet.FleetJournal(d)
    control = pkg.fleet.FleetControl(router, journal=journal)
    for i in range(6):
        control.register_tenant(f"t{i}", pkg.transport._dataset_from_wire(SOURCE))
    journal.append("publish_commit", params_version=1, ckpt_dir="/x/ckpt")
    return Rep, router, control, journal


def _autoscale(pkg, tmp_path):
    Rep, router, control, journal = _fleet(pkg, tmp_path / pkg.fleet.__name__.split(".")[0], 2)
    clock, spawned = {"t": 0.0}, {}

    def spawn(rid):
        spawned[rid] = Rep(rid, version=0)
        return spawned[rid]

    sc = pkg.fleet.FleetAutoscaler(control, spawn, min_replicas=1, max_replicas=3,
                                   high_occupancy=0.75, low_occupancy=0.20, high_windows=2,
                                   low_windows=2, cooldown_s=10.0, scale_budget_s=30.0,
                                   clock=lambda: clock["t"])
    plan = ([0.9] * 3 + [0.5] + [0.9] * 3 + [0.0] * 3     # hot: out, cooling down, hot at max
            + [0.0] * 12 + [0.0] * 6)                      # cold: drain in (queue held), then in
    out = []
    for i, occ in enumerate(plan):
        if i == 7:
            router.replicas[sorted(router.replicas)[-1]].queue_depth = 2    # in flight
        if i == 10:
            for h in router.replicas.values():
                h.queue_depth = 0
        d = sc.tick({"occupancy": occ})
        out.append((clock["t"], d["action"], sorted(router.replicas),
                    {r: router.placement.state(r) for r in sorted(router.replicas)}))
        clock["t"] += 3.0
    state = journal.materialize()
    out.append((sorted(state.replicas), sorted(spawned), {r: s.version for r, s in spawned.items()},
                len(router.directory)))
    journal.close()
    router.close()
    return out


def test_autoscaler_decisions_equal_jax(tmp_path):
    theirs, ours = _autoscale(PKGS["jax"], tmp_path), _autoscale(PKGS["port"], tmp_path)
    assert ours == theirs
    actions = [a for _, a, _, _ in ours[:-1]]
    assert "scale_out" in actions and "drain_in" in actions and "pending" in actions
    assert ours[-1][3] == 6                     # every tenant kept its home


def _standby(pkg, tmp_path):
    d = tmp_path / pkg.fleet.__name__.split(".")[0]
    Rep, router, control, journal = _fleet(pkg, d, 2)
    journal.acquire_lease("primary")
    control.set_nota_threshold("t1", 0.3)
    control.quarantine_tenant("t2", reason="hold")
    standby = pkg.fleet.HotStandby(d)
    applied = standby.poll()
    view = router.directory_view()
    degraded = standby.classify("support me", tenant="t0")
    with pytest.raises(ValueError):
        standby.classify("x", tenant="t99")
    promo = standby.promote({f"r{i:02d}": Rep(f"r{i:02d}", version=0) for i in range(2)})
    out = {"applied": applied, "view_equal": standby.router.directory_view() == view,
           "degraded": (degraded["degraded"], degraded["nota"]),
           "promo": {k: v for k, v in promo.items() if not k.endswith("_s")}}
    fenced = []
    for op in (lambda: journal.append("tenant_threshold", tenant="t1", threshold=0.5),
               lambda: control.quarantine_tenant("t3", reason="zombie")):
        try:
            op()
            fenced.append(False)
        except pkg.fleet.JournalError:
            fenced.append(True)
    out["fenced"] = fenced
    pkg.fleet.FleetControl(standby.router, journal=standby.journal).set_nota_threshold("t1", 0.6)
    out["state"] = json.dumps(standby.journal.materialize().to_dict(), sort_keys=True)
    with pytest.raises(RuntimeError):
        standby.promote({})
    router.close()
    standby.router.close()
    standby.journal.close()
    journal.close()
    return out


def test_standby_promotion_and_fencing_equal_jax(tmp_path):
    theirs, ours = _standby(PKGS["jax"], tmp_path), _standby(PKGS["port"], tmp_path)
    assert ours == theirs
    assert ours["view_equal"] and ours["fenced"] == [True, True]
    assert ours["degraded"] == (True, True) and ours["promo"]["lease_epoch"] == 2
