"""Time the tier-1 test command on several trees, back to back (a program,
not collected by pytest).

    python3 tests/tier1_timing.py OUT_DIR TREE[:TAG] [TREE[:TAG] ...]

Each TREE is the root of a checkout (``git archive`` of a commit unpacked
into a directory, or the working tree itself). In each, in the order
given, this runs the tier-1 command (``pytest tests/ -m 'not slow'`` under
six xdist workers, ``--dist loadfile``, a 1470 s bound) with its log and
junit report in OUT_DIR, then prints one JSON line per tree: the exit
code, the passes counted from the junit report (tests less errors,
failures and skips), pytest's own seconds, the wall seconds, and the
failed test ids; and the summed test seconds per file, largest first.
Compare two trees only within one call: the machine's load moves the
wall time by minutes.
"""

import collections
import json
import os
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

BOUND_S = 1470


def command(log: str, xml: str) -> str:
    return (f"set -o pipefail; rm -rf {log} {xml}; timeout -k 10 {BOUND_S} env "
            "JAX_PLATFORMS=cpu ALLOW_MULTIPLE_LIBTPU_LOAD=1 python -m pytest tests/ -q -m "
            "'not slow' --continue-on-collection-errors -p no:cacheprovider -p xdist -n 6 "
            f"--dist loadfile --junitxml={xml} -p no:randomly 2>&1 | tee {log} > /dev/null")


def summary(xml: str) -> dict:
    root = ET.parse(xml).getroot()
    suite = root if root.tag == "testsuite" else root.find("testsuite")
    n = {k: int(suite.get(k, 0)) for k in ("tests", "errors", "failures", "skipped")}
    files: collections.Counter = collections.Counter()
    failed = []
    for case in suite.iter("testcase"):
        files[case.get("classname", "").split(".")[-1]] += float(case.get("time", 0.0))
        if case.find("failure") is not None or case.find("error") is not None:
            failed.append(f"{case.get('classname')}::{case.get('name')}")
    return {"passed": n["tests"] - n["errors"] - n["failures"] - n["skipped"],
            "pytest_s": float(suite.get("time", 0.0)), "failed": failed,
            "worker_s": round(sum(files.values()), 1),
            "files_s": {k: round(v, 1) for k, v in files.most_common(12)}}


def main(argv: list) -> int:
    out_dir, trees = os.path.abspath(argv[0]), argv[1:]
    os.makedirs(out_dir, exist_ok=True)
    for spec in trees:
        tree, _, tag = spec.partition(":")
        tag = tag or os.path.basename(os.path.abspath(tree))
        log, xml = (os.path.join(out_dir, f"tier1_{tag}.{ext}") for ext in ("log", "xml"))
        t0 = time.monotonic()
        rc = subprocess.run(["bash", "-c", command(log, xml)], cwd=tree).returncode
        wall = time.monotonic() - t0
        res = {"tree": tag, "rc": rc, "wall_s": round(wall, 1)}
        if os.path.exists(xml):
            res.update(summary(xml))
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
