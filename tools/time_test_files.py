"""Wall time of each of the port's test files run alone, several at a time.

Runs ``python -m pytest -q -p no:cacheprovider FILE`` for each
``tests/test_torch_*.py``, ``--jobs`` processes at once (pytest without
xdist in each, ``JAX_PLATFORMS=cpu`` as the suite's own command sets it),
and prints one JSON line per file (seconds, exit code, the summary line)
and a last line with their sum and the whole run's wall time.

``--only NAME ...`` times those files alone. ``--root DIR`` times the files of another checkout (say a fresh ``git
archive`` copy), from that checkout's root. The suite keeps its JAX compile
cache in ``<root>/.jax_cache_tests`` (``tests/conftest.py``); ``--cold``
empties it first, so that every JAX program the files compile is compiled
anew, as in a fresh checkout's first run.

Usage, from the repository's root:
    python tools/time_test_files.py [--jobs 6] [--root DIR] [--cold] [--only NAME ...]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(path: Path, root: Path) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                           str(path.relative_to(root))], cwd=root, env=env,
                          capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    return {"file": path.name, "seconds": time.perf_counter() - t0, "rc": proc.returncode,
            "summary": lines[-1] if lines else ""}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--root", type=Path, default=ROOT, help="the checkout whose files to time")
    ap.add_argument("--cold", action="store_true",
                    help="empty <root>/.jax_cache_tests first (a cold compile cache)")
    ap.add_argument("--only", nargs="+", default=None, metavar="NAME",
                    help="time only these test files (names under tests/)")
    args = ap.parse_args(argv)
    root = args.root.resolve()
    if args.cold:
        shutil.rmtree(root / ".jax_cache_tests", ignore_errors=True)
    files = sorted((root / "tests").glob("test_torch_*.py"))
    if args.only:
        files = [f for f in files if f.name in set(args.only)]
    t0 = time.perf_counter()
    recs = []
    with ThreadPoolExecutor(args.jobs) as pool:
        for rec in pool.map(lambda f: _run(f, root), files):
            print(json.dumps(rec), flush=True)
            recs.append(rec)
    print(json.dumps({"files": len(recs), "sum_seconds": sum(r["seconds"] for r in recs),
                      "max_seconds": max((r["seconds"] for r in recs), default=0.0),
                      "wall_seconds": time.perf_counter() - t0, "jobs": args.jobs,
                      "root": str(root), "cold": args.cold,
                      "failed": [r["file"] for r in recs if r["rc"] not in (0, 5)]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
