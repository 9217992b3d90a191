"""The torch port stands alone: no JAX, no JAX package, no GPU at import.

A subprocess blocks ``jax``, ``jaxlib``, ``flax``, ``optax``, ``orbax``,
``ml_dtypes``, ``tensorflow``, ``tensorboard`` (the port writes its
TensorBoard files itself) and ``induction_network_on_fewrel_tpu`` with a
``sys.meta_path`` finder, then imports every module of the port (the data
parallel package ``parallel/`` among them, checked by name) and
``chip_smoke.py``; an AST scan of the same files finds no such import
either. Without CUDA the entry points refuse to run unless asked for the CPU.
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "induction_network_on_fewrel_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes", "tensorflow", "tensorboard",
           "induction_network_on_fewrel_tpu")

GUARDED = textwrap.dedent(f"""
    import importlib, pkgutil, sys
    BLOCKED = {BLOCKED!r}

    class Block:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError("blocked import: " + name)
            return None

    sys.meta_path.insert(0, Block())
    import induction_network_on_fewrel_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    parallel = set(["distributed", "mesh", "hostfeed", "grad_buckets", "sharding", "rig"])
    got = set(n.rsplit(".", 1)[1] for n in names if ".parallel." in n)
    assert parallel <= got, sorted(parallel - got)
    leaked = sorted(m for m in sys.modules
                    if any(m == b or m.startswith(b + ".") for b in BLOCKED))
    assert not leaked, leaked
    import torch
    if not torch.cuda.is_available():
        from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
        from induction_network_on_fewrel_tpu_torch.models.build import build_model
        try:
            build_model(ExperimentConfig())
        except RuntimeError as e:
            assert "CUDA is not available" in str(e), e
        else:
            raise AssertionError("build_model() ran without CUDA and without device='cpu'")
    print("IMPORTED", len(names))
""")


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", GUARDED], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    n = int(proc.stdout.split("IMPORTED")[1])
    assert n >= 20    # every module of the package was imported


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            assert not any(m == b or m.startswith(b + ".") for b in BLOCKED), (
                f"{path.name}:{node.lineno} imports {m}"
            )


def test_entry_points_refuse_to_run_without_cuda():
    from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
    from induction_network_on_fewrel_tpu_torch.models.build import build_model, resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal path is not reachable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(ExperimentConfig(vocab_size=12), device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("module,wrappers", [("ops.optim", ("optim_sumsq", "optim_update")),
                                             ("ops.segsum", ())])
def test_kernel_modules_of_the_training_step_are_guarded(module, wrappers):
    """The optimizer pair's and the segment sum's modules are among the
    sources scanned above (and so among the modules imported with JAX
    blocked); each kernel wrapper counts its launches. The segment sum is
    a library call (``index_add_``) and counts none."""
    import importlib

    assert PORT / (module.replace(".", "/") + ".py") in _sources()
    mod = importlib.import_module(f"induction_network_on_fewrel_tpu_torch.{module}")
    for name in wrappers:
        assert isinstance(getattr(mod, name).launches, int), name
    if not wrappers:
        assert not hasattr(mod.segsum, "launches")


# The serving control plane and the adaptation loop: ported from the JAX
# package and from the repository's tools/, which the port never imports.
CONTROL_PLANE = ("fleet.placement", "fleet.journal", "fleet.router", "fleet.supervisor",
                 "fleet.control", "fleet.transport", "fleet.standby", "fleet.autoscaler",
                 "obs.adapt", "obs.adapt_drill", "obs.canary", "train.finetune",
                 # The load tools, ported from tools/loadgen.py, scenarios.py
                 # and fleet_report.py.
                 "load.harness", "load.burn", "load.drift", "load.chaos", "load.quant",
                 "load.scenarios", "load.geom", "load.fleet", "load.recovery", "load.elastic",
                 "load.fleet_report", "load.fleet_obs", "load.__main__")
TOOLS = ("tools", "loadgen", "scenarios", "fleet_report", "obs_report", "bench_trend")


@pytest.mark.parametrize("module", CONTROL_PLANE)
def test_control_plane_modules_are_guarded(module):
    path = PORT / (module.replace(".", "/") + ".py")
    assert path in _sources()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for m in mods:
            assert not any(m == t or m.startswith(t + ".") for t in TOOLS), (path.name, m)


def test_replica_process_refuses_to_run_without_cuda(tmp_path):
    from induction_network_on_fewrel_tpu_torch.config import ExperimentConfig
    from induction_network_on_fewrel_tpu_torch.fleet.transport import serve_replica_main
    from induction_network_on_fewrel_tpu_torch.models.build import build_model
    from induction_network_on_fewrel_tpu_torch.train.checkpoint import CheckpointManager
    from induction_network_on_fewrel_tpu_torch.train.steps import make_optimizer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal path is not reachable")
    cfg = ExperimentConfig(vocab_size=12, lstm_hidden=8, max_length=8)
    model = build_model(cfg, device="cpu")
    mgr = CheckpointManager(tmp_path / "ckpt", cfg, stage="off")
    mgr.save(0, model, make_optimizer(cfg, model), val_accuracy=0.0)
    mgr.close()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_replica_main(["--load_ckpt", str(tmp_path / "ckpt")])
