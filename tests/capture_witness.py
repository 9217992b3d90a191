"""Witness for CUDA-graph captures beside live serving: how often a fleet drill fails.

    python3 tests/capture_witness.py SECONDS [GC_THRESHOLD]

On the card only (not a test). Builds the kernels, then runs the fleet
observability drill (``load/fleet_obs.fleet_obs_drill``: three replicas
serving open-loop traffic while a fourth is added and warmed up, a kill
and a fan-out publish; every replica captures its query graphs while the
others replay) again and again for SECONDS, and prints one JSON line: the
runs, the failed runs and the first error. A capture that other work
invalidated fails a request ("operation failed due to a previous error
during capture"). GC_THRESHOLD, when given, sets Python's first
collection threshold (default 700) lower, so that collections fall
inside captures more often.
"""

import gc
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from induction_network_on_fewrel_tpu_torch.kernels.build import LIBRARY  # noqa: E402
from induction_network_on_fewrel_tpu_torch.load.fleet_obs import fleet_obs_drill  # noqa: E402


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("capture_witness: needs a CUDA card", file=sys.stderr)
        return 2
    seconds = float(argv[0])
    if len(argv) > 1:
        gc.set_threshold(int(argv[1]))
    LIBRARY.build()
    runs, fails, first = 0, 0, None
    t_end = time.monotonic() + seconds
    with tempfile.TemporaryDirectory(prefix="capture_witness_") as tmp:
        while time.monotonic() < t_end:
            try:
                fleet_obs_drill(seed=runs, fleet_dir=os.path.join(tmp, f"run{runs}"))
                torch.cuda.synchronize()
            except Exception as e:      # counted: the witness reports, not raises
                fails += 1
                first = first or f"{type(e).__name__}: {str(e)[:300]}"
            runs += 1
    print(json.dumps({"runs": runs, "failed": fails, "first_error": first,
                      "gc_threshold": gc.get_threshold()[0], "seconds": seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
