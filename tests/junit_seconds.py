"""Junit seconds of the port's test files, each file in a process of its own:

    python tests/junit_seconds.py [--jobs 3] [--out DIR] [FILE ...]

Runs every ``tests/test_torch_*.py`` of the tree it is started in (or the
files given) as ``python -m pytest FILE -q -p no:cacheprovider
--junitxml=...`` with ``JAX_PLATFORMS=cpu`` and ``UTRL_CACHE_WRITE=0``,
``--jobs`` at a time, and prints one JSON object: per file its junit
seconds (the testsuite's ``time``), passes and failures, the ten slowest
cases of each file, and the totals. Run it from a fresh ``git archive`` of a
commit for a cold JAX compile cache (the tree's ``.jax_cache/``, which
``tests/conftest.py`` reads, is not in an archive).
"""

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET
from concurrent.futures import ThreadPoolExecutor


def run_file(path, out_dir):
    xml = os.path.join(out_dir, os.path.basename(path) + ".xml")
    env = dict(os.environ, JAX_PLATFORMS="cpu", UTRL_CACHE_WRITE="0")
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-m", "pytest", path, "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", f"--junitxml={xml}"],
        capture_output=True, text=True, env=env)
    wall = time.time() - t0
    with open(os.path.join(out_dir, os.path.basename(path) + ".log"), "w") as f:
        f.write(res.stdout + res.stderr)
    suite = ET.parse(xml).getroot()
    suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
    n = int(suite.get("tests"))
    failed = int(suite.get("failures")) + int(suite.get("errors"))
    skipped = int(suite.get("skipped"))
    cases = sorted(((float(c.get("time")), c.get("name"))
                    for c in suite.iter("testcase")), reverse=True)
    return {"junit_s": float(suite.get("time")), "wall_s": wall,
            "passed": n - failed - skipped, "failed": failed, "skipped": skipped,
            "slowest": [[round(t, 1), name] for t, name in cases[:10]]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("files", nargs="*")
    args = ap.parse_args()
    files = args.files or sorted(glob.glob("tests/test_torch_*.py"))
    out_dir = args.out or tempfile.mkdtemp(prefix="junit_seconds_")
    os.makedirs(out_dir, exist_ok=True)
    with ThreadPoolExecutor(args.jobs) as pool:
        results = dict(zip(files, pool.map(lambda f: run_file(f, out_dir), files)))
    per_file = {os.path.basename(f)[len("test_torch_"):-3]: r
                for f, r in results.items()}
    print(json.dumps({
        "files": per_file,
        "total_junit_s": sum(r["junit_s"] for r in per_file.values()),
        "passed": sum(r["passed"] for r in per_file.values()),
        "failed": sum(r["failed"] for r in per_file.values()),
        "out": out_dir,
    }))


if __name__ == "__main__":
    main()
