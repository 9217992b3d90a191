"""The port's fleet (placement, router, control) against the JAX package's.

Each scenario runs once per package from the same inputs and the results
must be equal: the rendezvous owners and tier homes of 10 000 tenant ids,
a router over stub replicas on an injected breaker clock (routing,
fleet-share shedding, breaker-fed failover, re-placement and the
``kind="fleet"`` records), and the all-or-nothing fan-out publish's
rollback when one replica refuses. Then the port alone: a routed
request's spans carry the router's trace id across the hop into the
replica's engine.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import json
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import pytest

import induction_network_on_fewrel_tpu.fleet as jfleet
import induction_network_on_fewrel_tpu.serving.batcher as jbatcher
import induction_network_on_fewrel_tpu.serving.breaker as jbreaker
import induction_network_on_fewrel_tpu.utils.metrics as jmetrics
import induction_network_on_fewrel_tpu_torch.fleet as tfleet
import induction_network_on_fewrel_tpu_torch.serving.batcher as tbatcher
import induction_network_on_fewrel_tpu_torch.serving.breaker as tbreaker
import induction_network_on_fewrel_tpu_torch.utils.metrics as tmetrics

PKGS = {
    "jax": SimpleNamespace(fleet=jfleet, batcher=jbatcher, breaker=jbreaker, metrics=jmetrics),
    "port": SimpleNamespace(fleet=tfleet, batcher=tbatcher, breaker=tbreaker, metrics=tmetrics),
}
# Record fields that carry a time or a process identity, not the decision.
TIMING = ("t_unix", "proc_pid", "proc_role", "wall", "qps", "uptime")


def both(fn, *args, **kw):
    """``fn(pkg, ...)`` for each package; returns (jax result, port result)."""
    return fn(PKGS["jax"], *args, **kw), fn(PKGS["port"], *args, **kw)


def _stub_class(pkg):
    class Stub(pkg.fleet.ReplicaHandle):
        """Immediate verdicts stamped with the replica id; ``mode`` holds
        futures unresolved ("hold") or fails launches ("fail"); ``refuse``
        makes prepare_publish raise."""

        def __init__(self, rid):
            self.replica_id = rid
            self.mode = "ok"
            self.refuse = False
            self.held: list[Future] = []
            self.submits = 0
            self.version = 0
            self.aborted = 0
            self.registered: list[str] = []

        def submit(self, instance, deadline_s=None, tenant="default", trace=None):
            self.submits += 1
            f: Future = Future()
            if self.mode == "hold":
                self.held.append(f)
            elif self.mode == "fail":
                f.set_exception(pkg.batcher.ExecuteError(tenant, retry_after_s=0.01))
            else:
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
            if self.refuse:
                raise RuntimeError(f"{self.replica_id} refuses the candidate")
            return ("txn", target_version)

        def commit_publish(self, txn):
            self.version += 1
            return self.version

        def abort_publish(self, txn):
            self.aborted += 1

        @property
        def params_version(self):
            return self.version

        def stats_snapshot(self):
            return {"served": self.submits, "p50_ms": 0.0, "p99_ms": 0.0,
                    "batch_occupancy": 1.0, "steady_recompiles": 0,
                    "queue_depth": len(self.held)}

        def warmup(self):
            return 0

        def close(self):
            pass

    return Stub


# --- placement ------------------------------------------------------------------


def _placement(pkg):
    pl = pkg.fleet.FleetPlacement({f"r{i}": None for i in range(5)})
    tenants = [f"tenant-{i:05d}" for i in range(10_000)]
    tiers = (4, 8, 16, 32, 64)
    owners = [pl.place(t) for t in tenants]
    homes = [pl.place(t, tier=tiers[i % 5], tier_spread=2) for i, t in enumerate(tenants)]
    pl.set_state("r3", pkg.fleet.DEAD)
    after = [pl.place(t) for t in tenants[:2000]]
    scores = [pkg.fleet.placement_score(t, "r1") for t in tenants[:100]]
    return owners, homes, after, scores


def test_placement_owners_and_tier_homes_equal_jax():
    theirs, ours = both(_placement)
    assert ours == theirs
    owners, homes, after, _ = ours
    assert len(set(owners)) == 5 and all(h is not None for h in homes)
    assert "r3" not in after
    moved = sum(a != b for a, b in zip(owners[:2000], after))
    assert moved == sum(o == "r3" for o in owners[:2000])     # only the dead one's tenants


# --- the router over stubs -------------------------------------------------------


def _records(run) -> list:
    out = []
    for line in (run / "metrics.jsonl").read_text().splitlines():
        r = json.loads(line)
        out.append({k: v for k, v in r.items()
                    if not k.startswith(TIMING) and not k.endswith(("_ms", "_s"))})
    return out


def _router(pkg, tmp_path):
    Stub = _stub_class(pkg)
    clock = {"t": 0.0}
    stubs = {f"r{i}": Stub(f"r{i}") for i in range(3)}
    run = tmp_path / pkg.fleet.__name__.split(".")[0]
    logger = pkg.metrics.MetricsLogger(run, quiet=True)
    breaker = pkg.breaker.CircuitBreaker(failure_threshold=2, open_s=5.0,
                                         clock=lambda: clock["t"])
    router = pkg.fleet.FleetRouter(stubs, logger=logger, breaker=breaker, fleet_share=0.25,
                                   queue_capacity_per_replica=4)
    control = pkg.fleet.FleetControl(router)
    tenants = [f"t{i:02d}" for i in range(12)]
    for t in tenants:
        control.register_tenant(t, object())
    out = {"owners": {t: router.directory[t].owner for t in tenants}}
    out["routed"] = [router.submit("q", 1.0, tenant=t).result()["replica"] for t in tenants]
    # Fleet-share shedding: every replica holds its futures; t00 sheds at
    # its share of the fleet's 12 slots, another tenant is still admitted.
    for s in stubs.values():
        s.mode = "hold"
    accepted = shed = 0
    for _ in range(8):
        try:
            router.submit("q", 1.0, tenant="t00")
            accepted += 1
        except pkg.batcher.Saturated as e:
            shed += 1
            assert e.tenant == "t00"
    router.submit("q", 1.0, tenant="t01")
    out["share"] = (accepted, shed)
    for s in stubs.values():
        for f in s.held:
            f.set_result({"label": "rel0", "replica": s.replica_id})
        s.held.clear()
        s.mode = "ok"
    # Breaker-fed failover: the owner of t02 fails its launches.
    victim = router.directory["t02"].owner
    stubs[victim].mode = "fail"
    seq = []
    for _ in range(4):
        fut = router.submit("q", 1.0, tenant="t02")
        try:
            v = fut.result()
            seq.append(("verdict", bool(v.get("degraded")), bool(v.get("failover"))))
        except Exception as e:  # noqa: BLE001 — the typed launch failure
            seq.append(("error", type(e).__name__))
    out["failover"] = seq
    out["states"] = {r: router.placement.state(r) for r in stubs}
    out["moved"] = control.replace_tenants()
    out["after_move"] = router.submit("q", 1.0, tenant="t02").result()["replica"]
    out["new_owner"] = router.directory["t02"].owner
    clock["t"] = 10.0                       # the breaker's open window ends
    out["snapshot"] = {k: v for k, v in router.snapshot().items() if not k.endswith("_ms")}
    router.emit_stats()
    router.close()
    logger.close()
    out["records"] = [r for r in _records(run) if r.get("kind") == "fleet"]
    return out


def test_router_sequence_and_fleet_records_equal_jax(tmp_path):
    theirs, ours = both(_router, tmp_path)
    assert ours == theirs
    assert ours["share"][1] > 0 and ours["states"][ours["owners"]["t02"]] == "dead"
    assert ("verdict", True, True) in ours["failover"]
    assert ours["after_move"] == ours["new_owner"] != ours["owners"]["t02"]
    assert ours["failover"][:2] == [("error", "ExecuteError")] * 2   # the breaker's feed
    assert {r.get("event") for r in ours["records"]} >= {"replace"}
    assert sum("replica" in r for r in ours["records"]) == 3           # one row per replica


# --- the fan-out publish ---------------------------------------------------------


def _fanout(pkg):
    Stub = _stub_class(pkg)
    stubs = {f"r{i}": Stub(f"r{i}") for i in range(3)}
    router = pkg.fleet.FleetRouter(stubs)
    control = pkg.fleet.FleetControl(router)
    control.register_tenant("t0", object())
    v1 = control.publish_checkpoint("/ckpt/a")
    stubs["r1"].refuse = True
    with pytest.raises(pkg.fleet.FleetPublishError) as e:
        control.publish_checkpoint("/ckpt/b")
    out = {"first": v1, "versions": {r: s.version for r, s in stubs.items()},
           "aborted": {r: s.aborted for r, s in stubs.items()},
           "error": type(e.value).__name__}
    stubs["r1"].refuse = False
    out["retry"] = control.publish_checkpoint("/ckpt/b")
    router.close()
    return out


def test_fanout_publish_rolls_back_when_one_replica_refuses():
    theirs, ours = both(_fanout)
    assert ours == theirs
    assert ours["versions"] == {"r0": 1, "r1": 1, "r2": 1}     # nothing moved
    assert ours["aborted"]["r0"] == 1 and ours["retry"] == 2


# --- trace propagation through the real engine -----------------------------------


def test_routed_request_spans_carry_the_router_trace_id(tmp_path):
    """``InferenceEngine.submit(trace=)``: the router head-samples, and the
    replica's queue/pack/execute/respond segments join its trace id."""
    from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
    from induction_network_on_fewrel_tpu_torch.data import (
        GloveTokenizer,
        make_synthetic_fewrel,
        make_synthetic_glove,
    )
    from induction_network_on_fewrel_tpu_torch.models.build import build_model
    from induction_network_on_fewrel_tpu_torch.serving.engine import InferenceEngine

    cfg = ExperimentConfig(encoder="cnn", hidden_size=16, vocab_size=62, word_dim=8,
                           max_length=12, induction_dim=8, ntn_slices=4, n=3, k=2, q=2)
    vocab = make_synthetic_glove(vocab_size=60, word_dim=8)
    tok = GloveTokenizer(vocab, max_length=12)
    ds = make_synthetic_fewrel(num_relations=3, instances_per_relation=6, vocab_size=60)
    logger = tmetrics.MetricsLogger(tmp_path / "run", quiet=True)
    engines = [InferenceEngine(build_model(cfg, glove_init=vocab.vectors, device="cpu"), cfg, tok,
                               k=2, buckets=(1, 2), device="cpu", logger=logger)
               for _ in range(2)]
    router = tfleet.FleetRouter({f"r{i}": tfleet.InProcessReplica(f"r{i}", e)
                                 for i, e in enumerate(engines)},
                                logger=logger, trace_sample=1.0)
    control = tfleet.FleetControl(router)
    control.register_tenant("t0", ds)
    verdicts = [router.classify(ds.instances[r][3], 5.0, tenant="t0") for r in ds.rel_names]
    router.close()
    logger.close()
    recs = [json.loads(ln) for ln in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    hops = {r["trace_id"] for r in recs if r.get("kind") == "hop"}
    traces = {r["trace_id"] for r in recs if r.get("kind") == "trace" and "total_ms" in r}
    ids = {v["trace_id"] for v in verdicts}
    assert len(ids) == len(verdicts) and ids <= hops and ids <= traces
    assert np.isfinite([x for v in verdicts for x in v["logits"].values()]).all()
