"""The port's durable control plane and transport against the JAX package's.

* The same op sequence writes byte-identical WAL files in both packages,
  and each package materializes the other's WAL (a torn tail, a
  compaction's snapshot) to the same state.
* The supervisor's restart backoff, jitter and budget give the same
  schedule on an injected clock.
* The socket wire format is shared: a JAX ``SocketReplica`` drives a port
  ``ReplicaServer`` and a port ``SocketReplica`` a JAX ``ReplicaServer``
  (ping, register, submit, stats), and the port's ``net.*`` fault points
  behave as the JAX ones do.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import json
import socketserver
import threading
from concurrent.futures import Future
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import induction_network_on_fewrel_tpu.fleet as jfleet
import induction_network_on_fewrel_tpu.fleet.transport as jtransport
import induction_network_on_fewrel_tpu.obs.chaos as jchaos
import induction_network_on_fewrel_tpu_torch.fleet as tfleet
import induction_network_on_fewrel_tpu_torch.fleet.transport as ttransport
import induction_network_on_fewrel_tpu_torch.obs.chaos as tchaos
from induction_network_on_fewrel_tpu_torch.fleet.journal import SNAPSHOT_NAME, WAL_NAME

PKGS = {
    "jax": SimpleNamespace(fleet=jfleet, chaos=jchaos, transport=jtransport),
    "port": SimpleNamespace(fleet=tfleet, chaos=tchaos, transport=ttransport),
}
SOURCE = {"rel0": [{"tokens": ["alpha", "beta", "gamma"], "head_pos": [0], "tail_pos": [2]}]}


def _ops(j) -> None:
    j.append("replica_add", replica="r0")
    j.append("replica_add", replica="r1", meta={"host": "127.0.0.1", "port": 9})
    j.append("tenant_register", tenant="t0", source=SOURCE, max_classes=None,
             nota_threshold=0.5, owner="r0")
    j.append("tenant_register", tenant="t1", source=None, max_classes=3,
             nota_threshold=None, owner="r1")
    j.append("tenant_threshold", tenant="t0", threshold=0.25)
    j.append("publish_commit", params_version=1, ckpt_dir="/x/ckpt")
    j.append("tenant_quarantine", tenant="t1", reason="op")
    j.append("replica_drain", replica="r1")
    j.append("adapt_exhausted", tenant="t1", attempts=3.0)


def _state(j) -> str:
    return json.dumps(j.materialize().to_dict(), sort_keys=True)


@pytest.mark.parametrize("compact_every", [0, 4])
def test_same_ops_give_byte_identical_wal(tmp_path, compact_every):
    files = {}
    for name, pkg in PKGS.items():
        j = pkg.fleet.FleetJournal(tmp_path / name, compact_every=compact_every)
        _ops(j)
        j.close()
        files[name] = {f: (tmp_path / name / f).read_bytes()
                       for f in (WAL_NAME, SNAPSHOT_NAME) if (tmp_path / name / f).exists()}
    assert files["port"] == files["jax"]
    assert (SNAPSHOT_NAME in files["port"]) == bool(compact_every)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_each_package_materializes_the_other_wal(tmp_path, writer, reader):
    """Plain, compacted and torn: the reader's state equals the writer's."""
    w, r = PKGS[writer], PKGS[reader]
    for case in ("plain", "compacted", "torn"):
        d = tmp_path / case
        j = w.fleet.FleetJournal(d)
        _ops(j)
        if case == "compacted":
            j.compact()
            j.append("tenant_unquarantine", tenant="t1", reason="op")
        want = _state(j)
        if case == "torn":
            w.chaos.install(w.chaos.ChaosRegistry.parse("journal.torn_write@0"))
            try:
                j.append("tenant_threshold", tenant="t0", threshold=0.9)
            finally:
                w.chaos.install(None)
            with pytest.raises(w.fleet.JournalError):
                j.append("tenant_threshold", tenant="t0", threshold=0.9)
        j.close()
        other = r.fleet.FleetJournal(d)
        assert _state(other) == want, case
        other.close()


# --- the supervisor --------------------------------------------------------------


def _sup_class(pkg):
    class Rep(pkg.fleet.ReplicaHandle):
        def __init__(self, rid, version=1):
            self.replica_id, self.version, self.registered = rid, version, []

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
            return {"served": 0, "steady_recompiles": 0}

        def warmup(self):
            return 0

        def close(self):
            pass

    return Rep


def _supervisor(pkg, tmp_path):
    """Failed restarts back off exponentially with the deterministic jitter
    and exhaust the budget; forgive re-arms; a restart that succeeds
    re-registers and catches up."""
    Rep = _sup_class(pkg)
    clock = {"t": 0.0}
    calls = {"n": 0, "ok": False}

    def restart_fn(rid):
        calls["n"] += 1
        if not calls["ok"]:
            raise RuntimeError("spawn refused")
        return Rep(rid, version=0)

    router = pkg.fleet.FleetRouter({f"r{i}": Rep(f"r{i}") for i in range(2)})
    journal = pkg.fleet.FleetJournal(tmp_path / pkg.fleet.__name__.split(".")[0])
    control = pkg.fleet.FleetControl(router, journal=journal)
    for i in range(6):
        control.register_tenant(f"t{i}", pkg.transport._dataset_from_wire(SOURCE))
    journal.append("publish_commit", params_version=1, ckpt_dir="/x/ckpt")
    sup = pkg.fleet.ReplicaSupervisor(router, restart_fn, journal=journal, backoff_s=1.0,
                                      restart_budget=3, clock=lambda: clock["t"])
    out = []
    router.mark_replica_dead("r0", reason="test")
    for step in range(6):
        p = sup.poll()
        out.append((clock["t"], calls["n"], {k: v for k, v in p.items() if v},
                    [round(sup.next_delay("r0", a), 9) for a in (1, 2, 3)]))
        clock["t"] += 2.0 ** step
    out.append(("exhausted", sup.exhausted("r0")))
    sup.forgive("r0")
    calls["ok"] = True
    p = sup.poll()
    out.append(({k: v for k, v in p.items() if v}, router.placement.state("r0"),
                sorted(router.replicas["r0"].registered), router.replicas["r0"].version))
    journal.close()
    router.close()
    return out


def test_supervisor_backoff_and_budget_equal_jax(tmp_path):
    theirs, ours = _supervisor(PKGS["jax"], tmp_path), _supervisor(PKGS["port"], tmp_path)
    assert ours == theirs
    assert ours[-2] == ("exhausted", True) and ours[-1][1] == "up" and ours[-1][3] == 1


# --- the wire, across packages -----------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """A port engine and a JAX engine on the same CNN weights, CPU."""
    from induction_network_on_fewrel_tpu.config import ExperimentConfig as JaxConfig
    from induction_network_on_fewrel_tpu.data import GloveTokenizer as JaxTok
    from induction_network_on_fewrel_tpu.data import make_synthetic_glove as jax_glove
    from induction_network_on_fewrel_tpu.models import build_model as jax_build
    from induction_network_on_fewrel_tpu.serving.buckets import zero_batch
    from induction_network_on_fewrel_tpu.serving.engine import InferenceEngine as JaxEngine
    from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
    from induction_network_on_fewrel_tpu_torch.data import GloveTokenizer, make_synthetic_glove
    from induction_network_on_fewrel_tpu_torch.interop import params_from_jax
    from induction_network_on_fewrel_tpu_torch.models.build import build_model
    from induction_network_on_fewrel_tpu_torch.serving.engine import InferenceEngine

    kw = dict(encoder="cnn", hidden_size=16, vocab_size=62, word_dim=8, pos_dim=2,
              max_length=12, induction_dim=8, ntn_slices=4, routing_iters=2, n=3, train_n=3,
              k=2, q=2, compute_dtype="float32")
    jcfg = JaxConfig(**kw, device="cpu")
    jvocab = jax_glove(vocab_size=60, word_dim=8)
    jmodel = jax_build(jcfg, glove_init=jvocab.vectors)
    params = jmodel.init(jax.random.key(0), zero_batch(12, (1, 3, 2)), zero_batch(12, (1, 2)))
    jeng = JaxEngine(jmodel, params, jcfg, JaxTok(jvocab, max_length=12), k=2, buckets=(1, 2, 4))
    cfg = ExperimentConfig(**kw)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(params["params"])))
    teng = InferenceEngine(model, cfg, GloveTokenizer(make_synthetic_glove(60, 8), 12), k=2,
                           buckets=(1, 2, 4), device="cpu")
    yield {"jax": jeng, "port": teng}
    jeng.close()
    teng.close()


def _dataset():
    from induction_network_on_fewrel_tpu.data import make_synthetic_fewrel

    return make_synthetic_fewrel(num_relations=3, instances_per_relation=5, vocab_size=60,
                                 sentence_len=(5, 12), seed=4)


@pytest.mark.parametrize("server,client", [("port", "jax"), ("jax", "port")])
def test_socket_wire_across_packages(engines, server, client):
    """ping, register, submit and stats over the other package's client;
    the verdicts equal the in-process engine's of the other package."""
    srv = PKGS[server].transport.ReplicaServer(engines[server]).start()
    rep = PKGS[client].transport.SocketReplica("x0", srv.address, call_deadline_s=30.0)
    try:
        assert rep.ping()
        ds = _dataset()
        names = rep.register_dataset(ds, "t0", max_classes=None)
        assert sorted(names) == sorted(ds.rel_names) and rep.has_tenant("t0")
        queries = [jtransport._inst_to_wire(ds.instances[r][3]) for r in ds.rel_names]
        got = [rep.submit(q, 5.0, tenant="t0").result(timeout=60) for q in queries]
        wire = jtransport._dataset_to_wire(ds)
        engines[client].register_dataset(PKGS[client].transport._dataset_from_wire(wire),
                                         tenant="t0")
        want = [engines[client].classify(q, tenant="t0") for q in queries]
        for g, w in zip(got, want):
            assert g["label"] == w["label"] and list(g["logits"]) == list(w["logits"])
            np.testing.assert_allclose(list(g["logits"].values()), list(w["logits"].values()),
                                       rtol=1e-5, atol=1e-5)
        stats = rep.stats_snapshot()
        assert stats["served"] >= len(queries) and rep.params_version == 0
    finally:
        rep.close()
        srv.stop()


class _Echo(socketserver.StreamRequestHandler):
    def handle(self):
        for line in self.rfile:
            req = json.loads(line)
            op = req.get("op")
            resp = ({"ok": True, "version": 7} if op == "params_version"
                    else {"ok": True, "has": True} if op == "has_tenant"
                    else {"ok": True, "t_recv": 0.0, "t_send": 0.0} if op == "clock"
                    else {"ok": True})
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()


def _net(pkg):
    srv = socketserver.ThreadingTCPServer(("127.0.0.1", 0), _Echo)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    out = []
    rep = pkg.transport.SocketReplica("e0", srv.server_address[:2], call_deadline_s=5.0,
                                      retries=2, retry_backoff_s=0.001)
    try:
        for plan, call in (("net.partition@0:e0", "version"), ("net.partition@0*9:e0", "version"),
                           ("net.drop@0:e0", "has"), ("net.partition@0:e0", "submit"),
                           ("net.slow@0:0.05", "version")):
            pkg.chaos.install(pkg.chaos.ChaosRegistry.parse(plan))
            try:
                if call == "version":
                    res = rep.params_version
                elif call == "has":
                    res = rep.has_tenant("t0")
                else:
                    res = rep.submit({"tokens": ["a"]}, deadline_s=1.0).result(timeout=10.0)
                out.append((plan, "ok", res))
            except Exception as e:  # noqa: BLE001 — the outcome is the result
                out.append((plan, type(e).__name__))
            finally:
                pkg.chaos.install(None)
    finally:
        rep.close()
        srv.shutdown()
        srv.server_close()
    return out


def test_net_points_equal_jax():
    theirs, ours = _net(PKGS["jax"]), _net(PKGS["port"])
    assert ours == theirs
    assert ours == [("net.partition@0:e0", "ok", 7), ("net.partition@0*9:e0", "ConnectionError"),
                    ("net.drop@0:e0", "ok", True), ("net.partition@0:e0", "ConnectionError"),
                    ("net.slow@0:0.05", "ok", 7)]
