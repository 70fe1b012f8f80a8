"""Self-defending single-device perf ladder.

Round-2 lesson (VERDICT weak #2): the same config measured 13.1k and
34.9k reads/s in one session because a contended host quietly poisons
steady-state.  This ladder defends itself:

  - waits for the host to be IDLE (1-min load average below a
    threshold) before every row, instead of trusting the operator;
  - runs every row until the last two measurements agree within
    MAX_SPREAD (or MAX_TRIES is hit), and flags unstable rows;
  - emits machine-readable results (best + per-run values + spread)
    to <outdir>/ladder.json, so README numbers can be diffed against
    captured numbers.

Usage:
  python bench/ladder.py [outdir] [--rows se60,pe60,...] [--quick]

Run it alone: one process per card (a JAX process reserves most of
the card's memory).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))

MAX_SPREAD = 0.15   # |a-b| / max(a,b) between the last two runs
MAX_TRIES = 3
IDLE_LOAD = 1.0     # 1-min load average threshold
IDLE_TIMEOUT = 900  # give up waiting and run anyway (flagged)

TP = "bench/throughput.py"


def rows_catalog(quick: bool):
    r = 40000 if quick else 100000
    common = ["--batch", "2048", "-t", "4", "--overlap", "--inflight", "4"]
    rows = [
        ("step", ["bench.py"], "json:step_ms"),
        ("se60", [TP, "--genome-mb", "60", "--reads", str(r), *common],
         "last_float"),
        ("se4", [TP, "--genome-mb", "4.6", "--reads", str(r), *common],
         "last_float"),
        ("pe60", [TP, "--genome-mb", "60", "--reads", str(r), "--paired",
                  *common], "last_float"),
        ("pe60dev", [TP, "--genome-mb", "60", "--reads", str(r),
                     "--paired", *common, "--device-rescue",
                     "--device-cigar"], "last_float"),
        ("pe60stress", [TP, "--genome-mb", "60", "--reads",
                        str(r // 2), "--paired", "--discordant", "0.5",
                        *common, "--device-rescue"], "last_float"),
        ("se60dseed", [TP, "--genome-mb", "60", "--reads", "20000",
                       "--batch", "2048", "-t", "1", "--overlap",
                       "--inflight", "4", "--device-seed"],
         "last_float"),
    ]
    # GRCh38-scale end-to-end: only when the cached index exists (it
    # takes ~66 min to build; bench/index_scale.py --single-build or a
    # prior ladder run leaves it in /tmp)
    if os.path.exists("/tmp/bwamem_bench_idx_3100000000.npz"):
        # larger chunks amortize the per-batch overhead that dominates
        # at GRCh38 scale (b2048: ~17k, b4096: 21-22k reads/s); at
        # 60 Mb the smaller chunk wins instead (36.4k vs 26.5k)
        rows.append(
            ("se3100", [TP, "--genome-mb", "3100", "--reads", str(r),
                        "--batch", "4096", "-t", "4", "--overlap",
                        "--inflight", "6"], "last_float"))
        rows.append(
            ("pe3100", [TP, "--genome-mb", "3100", "--reads", str(r),
                        "--paired", "--batch", "4096", "-t", "4",
                        "--overlap", "--inflight", "6"], "last_float"))
    # multi-host scaling row (CPU backend: N processes share this box)
    rows.append(("multihost", ["bench/multihost.py", "--reads",
                               "40000" if quick else "80000"],
                 "json:reads_per_s"))
    return rows


def load1() -> float:
    return os.getloadavg()[0]


def wait_idle(log) -> bool:
    t0 = time.time()
    while load1() > IDLE_LOAD:
        if time.time() - t0 > IDLE_TIMEOUT:
            log(f"  [warn] host still loaded (load1={load1():.2f}) "
                f"after {IDLE_TIMEOUT}s — running anyway, row flagged")
            return False
        time.sleep(15)
    return True


def parse_value(kind: str, stdout: str):
    if kind == "last_float":
        for line in reversed(stdout.strip().splitlines()):
            try:
                return float(line.strip())
            except ValueError:
                continue
        return None
    if kind.startswith("json:"):
        key = kind.split(":", 1)[1]
        for line in reversed(stdout.strip().splitlines()):
            try:
                d = json.loads(line)
            except ValueError:
                continue
            if key in d:
                v = d[key]
                return v if not isinstance(v, dict) else v
        return None
    raise ValueError(kind)


def spread(vals) -> float:
    a, b = vals[-2], vals[-1]
    if isinstance(a, dict) or isinstance(b, dict):
        # multihost row: compare the aggregate of the largest N
        a = max(float(v) for v in a.values())
        b = max(float(v) for v in b.values())
    hi = max(a, b)
    return abs(a - b) / hi if hi else 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir", nargs="?", default="bench_out")
    ap.add_argument("--rows", default=None,
                    help="comma-separated row names (default: all)")
    ap.add_argument("--quick", action="store_true",
                    help="smaller read counts (shape check, not BENCH)")
    ap.add_argument("--tries", type=int, default=MAX_TRIES,
                    help="max runs per row before flagging unstable")
    args = ap.parse_args()
    os.makedirs(args.outdir, exist_ok=True)
    logf = open(os.path.join(args.outdir, "ladder.log"), "a")

    def log(msg):
        print(msg, file=sys.stderr)
        print(msg, file=logf, flush=True)

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    rows = rows_catalog(args.quick)
    if args.rows:
        want = set(args.rows.split(","))
        rows = [r for r in rows if r[0] in want]
    results = {}
    for name, cmd, kind in rows:
        log(f"=== {name}: {' '.join(cmd)}")
        idle = wait_idle(log)
        vals, raw = [], []
        for attempt in range(args.tries):
            t0 = time.time()
            r = subprocess.run([sys.executable, *cmd], cwd=REPO, env=env,
                               capture_output=True, text=True,
                               timeout=7200)
            base = os.path.join(args.outdir, f"{name}.{attempt}")
            open(base + ".out", "w").write(r.stdout)
            open(base + ".err", "w").write(r.stderr)
            if r.returncode != 0:
                log(f"  [run {attempt}] FAILED rc={r.returncode} "
                    f"(see {base}.err)")
                continue
            v = parse_value(kind, r.stdout)
            if v is None:
                log(f"  [run {attempt}] no value parsed")
                continue
            vals.append(v)
            raw.append({"value": v, "seconds": round(time.time() - t0, 1),
                        "load1_at_start": round(load1(), 2)})
            log(f"  [run {attempt}] {v}")
            if len(vals) >= 2 and spread(vals) <= MAX_SPREAD:
                break
            if len(vals) >= 2:
                log(f"  [spread] {spread(vals):.0%} > {MAX_SPREAD:.0%}"
                    f" — re-running")
        stable = len(vals) >= 2 and spread(vals) <= MAX_SPREAD
        best = None
        if vals:
            best = (max(vals, key=lambda v: max(float(x) for x in
                                                v.values()))
                    if isinstance(vals[0], dict) else max(vals))
        results[name] = {
            "best": best, "runs": raw, "stable": stable,
            "idle_at_start": idle,
            "spread_last2": round(spread(vals), 4) if len(vals) >= 2
            else None,
        }
        log(f"  [row] best={best} stable={stable}")
    out = os.path.join(args.outdir, "ladder.json")
    # merge into any existing ladder.json so a --rows subset run never
    # clobbers rows captured by an earlier invocation in this outdir
    merged = {}
    if os.path.exists(out):
        try:
            prev = json.load(open(out))
            if isinstance(prev, dict):
                merged = prev
        except ValueError:
            pass
    merged.update(results)
    # atomic replace: a crash mid-write must not destroy captured rows
    json.dump(merged, open(out + ".part", "w"), indent=1)
    os.replace(out + ".part", out)
    log(f"ladder done -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
