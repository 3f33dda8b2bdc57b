"""Wall time of each of the port's test files run alone, several at a time.

Runs ``python -m pytest -q -p no:cacheprovider FILE`` for each
``tests/test_torch_*.py``, ``--jobs`` processes at once (pytest without
xdist in each, ``JAX_PLATFORMS=cpu`` as the suite's own command sets it),
and prints one JSON line per file (seconds, exit code, the summary line)
and a last line with their sum and the whole run's wall time.

Usage, from the repository's root: python tools/time_test_files.py [--jobs 6]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(path: Path) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                           str(path.relative_to(ROOT))], cwd=ROOT, env=env,
                          capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    return {"file": path.name, "seconds": time.perf_counter() - t0, "rc": proc.returncode,
            "summary": lines[-1] if lines else ""}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=6)
    args = ap.parse_args(argv)
    files = sorted((ROOT / "tests").glob("test_torch_*.py"))
    t0 = time.perf_counter()
    recs = []
    with ThreadPoolExecutor(args.jobs) as pool:
        for rec in pool.map(_run, files):
            print(json.dumps(rec), flush=True)
            recs.append(rec)
    print(json.dumps({"files": len(recs), "sum_seconds": sum(r["seconds"] for r in recs),
                      "max_seconds": max((r["seconds"] for r in recs), default=0.0),
                      "wall_seconds": time.perf_counter() - t0, "jobs": args.jobs,
                      "failed": [r["file"] for r in recs if r["rc"] not in (0, 5)]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
