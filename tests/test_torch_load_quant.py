"""The port's quantized-serving A/B (``load/quant.py``) on the CPU, held to
the JAX tool's (``tools/loadgen.py``), the reference pinned first.

The JAX A/B (``tools/loadgen.py --quant_ab --device cpu --seed 0``, the
committed ``QUANT_r01.json``'s config) fails its own gate on the CPU: int8
verdict agreement 0.9897 under the 0.99 floor (the same shortfall as the
reference's ``test_quantized_parity_vs_f32[int8]``). Its readings:
agreement 1.0 (bf16) and 0.9897 (int8), margin drift 0.0006 and 0.0014,
failures ``['agreement:int8=0.9897<0.99']``. The port's A/B at that seed
(1 s arms instead of 5 s) is held to those readings within the A/B's own
bands: agreement no more than 1 - 0.99 below the reference's, margin drift
no more than the 0.25 band above it, and no gate failure the reference
does not have. Its zero bands hold and its density ratio passes. The A/B
trains its checkpoint 60 steps at the flagship widths first (one thread:
the suite's workers share the host).
"""

import torch_threads  # noqa: F401  (one CPU thread: tests/torch_threads.py)
import json
import os
import sys

import pytest
import torch

from induction_network_on_fewrel_tpu_torch.load import harness, quant

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOOLS = os.path.join(REPO, "tools")
if _TOOLS not in sys.path:
    sys.path.insert(0, _TOOLS)

import loadgen  # noqa: E402

# The JAX A/B at the artifact's config and seed, on the CPU (see above).
QUANT_REFERENCE = {"bf16": {"agreement": 1.0, "margin_drift": 0.0006},
                   "int8": {"agreement": 0.9897, "margin_drift": 0.0014}}
QUANT_REFERENCE_FAILURES = ["agreement:int8=0.9897<0.99"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config_argv(name, *keys):
    with open(os.path.join(REPO, name)) as f:
        cfg = json.load(f)["config"]
    return [x for k in keys for x in (f"--{k}", str(cfg[k]))]


def test_quant_ab_within_the_pinned_reference_bands(tmp_path):
    args = harness.parse_args(["--device", "cpu", "--quant_ab", "--duration", "1.0",
                               *_config_argv("QUANT_r01.json", "seed", "tenants", "N", "K",
                                             "buckets", "rate")])
    ckpt = harness.make_synthetic_checkpoint(args, str(tmp_path), train_iters=60)
    out = quant.run_quant_ab(args, ckpt)
    fails = loadgen.check_quant_ab(out)
    assert fails == quant.check_quant_ab(out) == out["check_failures"]
    ref_kinds = {f.split("=")[0] for f in QUANT_REFERENCE_FAILURES}
    assert all(f.split("=")[0] in ref_kinds for f in fails), fails
    assert out["zero_bands"] == {"dropped": 0, "steady_recompiles": 0}
    assert out["density"]["bytes_ratio_f32_over_int8"] >= 3.5
    assert out["arms"]["f32"]["parity_max_delta"] < quant.QUANT_PARITY_TOL["f32"]
    for dt, ref in QUANT_REFERENCE.items():
        arm = out["arms"][dt]
        assert arm["quant_probes"] > 0
        assert arm["quant_agreement"] >= ref["agreement"] - (1.0 - out["parity_floor"]), dt
        assert arm["quant_margin_drift"] <= ref["margin_drift"] + out["margin_drift_band"], dt
        assert arm["parity_max_delta"] < quant.QUANT_PARITY_TOL[dt]
    with open(os.path.join(REPO, "QUANT_r01.json")) as f:
        art = json.load(f)
    assert set(out) == set(art) - {"round", "generated_by", "config"}
    assert set(out["arms"]["int8"]) == set(art["arms"]["int8"])
