"""Per-file test runner with crash retry + a status record.

A monolithic pytest run that dies in one file (a segfault or abort in a
native library) reports nothing. This runner executes each test file in
its own process, retries once on abnormal termination, and writes a
machine-readable summary so a green run is *recorded*, not just observed.

Usage:
  python scripts/run_suite.py            # fast suite (-m "not slow")
  python scripts/run_suite.py --slow     # slow suite (-m slow)
  python scripts/run_suite.py --all      # everything

Writes SUITE_STATUS.json (fast) / SLOWSUITE_STATUS.json (--slow/--all)
at the repo root.
"""

import argparse
import datetime
import glob
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ABNORMAL = {-11, -6, 134, 139}  # SIGSEGV / SIGABRT, shell-encoded variants


def run_file(path: str, marker: str, timeout: int) -> dict:
    cmd = [
        sys.executable, "-m", "pytest", path, "-q", "-p", "no:cacheprovider",
    ]
    if marker:
        cmd += ["-m", marker]
    for attempt in (1, 2):
        t0 = time.time()
        try:
            proc = subprocess.run(
                cmd, cwd=REPO, capture_output=True, text=True, timeout=timeout
            )
            rc = proc.returncode
            tail = (proc.stdout or "").strip().splitlines()[-3:]
        except subprocess.TimeoutExpired:
            rc = -99
            tail = [f"TIMEOUT after {timeout}s"]
        dt = round(time.time() - t0, 1)
        # pytest rc 5 = no tests collected under this marker — fine
        if rc in (0, 5):
            return {
                "file": os.path.basename(path), "rc": rc, "attempt": attempt,
                "seconds": dt, "summary": tail[-1] if tail else "",
            }
        if rc in ABNORMAL and attempt == 1:
            print(f"  {path}: abnormal rc={rc}, retrying once", flush=True)
            continue
        return {
            "file": os.path.basename(path), "rc": rc, "attempt": attempt,
            "seconds": dt, "summary": "\n".join(tail),
        }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--slow", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args()

    if args.all:
        marker, out_name = "", "SLOWSUITE_STATUS.json"
    elif args.slow:
        marker, out_name = "slow", "SLOWSUITE_STATUS.json"
    else:
        marker, out_name = "not slow", "SUITE_STATUS.json"

    files = sorted(glob.glob(os.path.join(REPO, "tests", "test_*.py")))
    results = []
    t0 = time.time()
    for path in files:
        res = run_file(path, marker, args.timeout)
        results.append(res)
        status = "ok" if res["rc"] in (0, 5) else f"FAIL rc={res['rc']}"
        print(f"{res['file']}: {status} ({res['seconds']}s)", flush=True)

    bad = [r for r in results if r["rc"] not in (0, 5)]
    summary = {
        "suite": "slow" if (args.slow or args.all) else "fast",
        "marker": marker or "(all)",
        "timestamp_utc": datetime.datetime.now(
            datetime.timezone.utc
        ).isoformat(timespec="seconds"),
        "git_head": subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True,
            text=True,
        ).stdout.strip(),
        "total_files": len(files),
        "failed_files": [r["file"] for r in bad],
        "green": not bad,
        "wall_seconds": round(time.time() - t0, 1),
        "files": results,
    }
    out = os.path.join(REPO, out_name)
    with open(out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"\n{'GREEN' if not bad else 'RED'}: {len(files) - len(bad)}"
          f"/{len(files)} files ok -> {out}")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
