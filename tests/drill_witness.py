"""Witness for the adaptation drill's publish race (not a test; run it as a
program from the repository root, on the CPU):

    JAX_PLATFORMS=cpu python tests/drill_witness.py

It runs ``test_torch_adapt.test_port_drill_passes_the_jax_gate`` with the
drift detector's re-arms and observations and the drill's traffic phases
logged, and prints one JSON line: whether the test passed, the reasons of
the last re-arms before the post-publish traffic, and the verdicts the
detector observed after the last of them and before that traffic began
(the params version of the snapshot that served each, and its NOTA flag).
Such verdicts can only be the burst submitted just before the fan-out
publish, and they enter the re-armed detector's post-publish baseline.

To load the machine as the parallel test run does, start six copies at
once, several times over, and count the lines with ``"passed": false``.
"""

import json
import os
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
sys.path[:0] = [os.path.dirname(HERE), HERE]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import test_torch_adapt  # noqa: E402

from induction_network_on_fewrel_tpu_torch.obs import adapt_drill  # noqa: E402
from induction_network_on_fewrel_tpu_torch.obs import drift as drift_module  # noqa: E402
from induction_network_on_fewrel_tpu_torch.serving import engine as engine_module  # noqa: E402

LOG: list = []
_served = threading.local()


def _instrument() -> None:
    verdict = engine_module.InferenceEngine._verdict
    observe = drift_module.DriftDetector.observe
    rearm = drift_module.DriftDetector.rearm
    drive = adapt_drill.drive

    def _verdict(self, row, snap):
        _served.version = snap.version      # the worker observes its batch after
        return verdict(self, row, snap)

    def _observe(self, tenant, *args, **kw):
        LOG.append(("observe", time.monotonic(), tenant, getattr(_served, "version", None),
                    kw.get("nota")))
        return observe(self, tenant, *args, **kw)

    def _rearm(self, tenant=None, reason=""):
        LOG.append(("rearm", time.monotonic(), tenant, reason))
        return rearm(self, tenant, reason)

    def _drive(classify, pool, cap, stop=None, count_nota=False):
        LOG.append(("drive", time.monotonic(), cap))
        return drive(classify, pool, cap, stop, count_nota)

    engine_module.InferenceEngine._verdict = _verdict
    drift_module.DriftDetector.observe = _observe
    drift_module.DriftDetector.rearm = _rearm
    adapt_drill.drive = _drive


def main() -> int:
    _instrument()
    passed, error = True, ""
    try:
        test_torch_adapt.test_port_drill_passes_the_jax_gate()
    except AssertionError as e:
        passed, error = False, str(e)[:2000]
    # The success arm drives baseline, shift, then post-publish traffic.
    post = [i for i, e in enumerate(LOG) if e[0] == "drive"][2]
    rearms = [i for i in range(post) if LOG[i][0] == "rearm"]
    early = [LOG[i] for i in range(rearms[-1], post)
             if LOG[i][0] == "observe" and LOG[i][2] == adapt_drill.TENANT]
    print(json.dumps({
        "passed": passed,
        "rearms_before_post": [LOG[i][3] for i in rearms[-4:]],
        "observed_after_last_rearm_before_post": len(early),
        "their_versions": sorted({e[3] for e in early}),
        "their_nota": [e[4] for e in early],
        "error": error,
    }))
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
