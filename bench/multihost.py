"""Multi-host scaling bench: N real `mem --shard` processes + merge.

Usage:
  python bench/multihost.py [--genome-mb 20] [--reads 20000] [--procs 1 2 4]

Launches N share-nothing aligner processes (the `--shard K/N` CLI
path, CPU backend so N processes coexist on one box — the real
multi-chip device path is exercised separately by parallel/dist.py),
waits for all, merges with the `merge` subcommand, and verifies the
merged record stream against the single-process run.

The scaling metric aggregates each process's STEADY align-loop rate
(the ``[mem] align:`` stderr line: chunk loop only, the first chunk's
jit compiles plus index load and backend setup excluded) — reads /
total-wall would charge every process its fixed interpreter+index
startup and under-report scaling on any run short enough to finish
quickly.

Contention model: every shard is pinned to ONE core (taskset) at every
N, because XLA's CPU threadpool otherwise grabs the whole box and the
"1-process baseline" silently uses all 4 cores.  One core per process
at every N = the truest one-box emulation of N independent hosts; the
efficiency number then isolates the sharding path's own overheads
(strided FASTQ scan, per-host index load, merge).  Total wall is also
printed for reference.  (BASELINE north star: >=80% linear 1->4
hosts.)
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mb", type=float, default=20)
    ap.add_argument("--reads", type=int, default=20000)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--procs", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("-t", type=int, default=1,
                    help="host threads per process")
    args = ap.parse_args()

    d = tempfile.mkdtemp(prefix="bwamem_mh_")
    rng = np.random.default_rng(0)
    n_bp = int(args.genome_mb * 1e6)
    bases = np.frombuffer(b"ACGT", np.uint8)
    codes = rng.integers(0, 4, n_bp)
    fa = os.path.join(d, "ref.fa")
    print(f"[sim] genome {args.genome_mb} Mb + {args.reads} reads -> {d}",
          file=sys.stderr)
    with open(fa, "wb") as f:
        f.write(b">sim\n")
        row = bases[codes]
        for i in range(0, n_bp, 1 << 20):
            chunk = row[i:i + (1 << 20)]
            f.write(b"\n".join(chunk[j:j + 70].tobytes()
                               for j in range(0, len(chunk), 70)) + b"\n")
    rl = args.read_len
    pos = rng.integers(0, n_bp - rl - 1, size=args.reads)
    R = codes[pos[:, None] + np.arange(rl)]
    mut = rng.random((args.reads, rl)) < 0.01
    R[mut] = rng.integers(0, 4, int(mut.sum()))
    fq = os.path.join(d, "reads.fq")
    qual = b"I" * rl
    with open(fq, "wb") as f:
        for i in range(args.reads):
            f.write(b"@r%d\n%s\n+\n%s\n"
                    % (i, bases[R[i]].tobytes(), qual))

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = (os.path.abspath(
        os.path.join(os.path.dirname(__file__), os.pardir))
        + os.pathsep + env.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-m", "bwamem_tpu", "index", fa],
                   env=env, check=True, capture_output=True, timeout=3600)

    base = [sys.executable, "-m", "bwamem_tpu", "mem", "--backend", "jax",
            "--host", "native", "-t", str(args.t), "-b", "2048", "-v", "1"]
    align_re = re.compile(
        r"\[mem\] align: (\d+) reads in ([0-9.]+)s = ([0-9.]+) reads/s"
        r" \(steady ([0-9.]+) reads/s over last (\d+) reads\)")
    results = {}
    single_body = None
    for N in args.procs:
        t0 = time.time()
        procs = []
        paths, errs = [], []
        for k in range(N):
            out = os.path.join(d, f"shard{k}of{N}.sam")
            err = os.path.join(d, f"shard{k}of{N}.err")
            paths.append(out)
            errs.append(err)
            cmd = ["taskset", "-c", str(k % os.cpu_count())] + list(base)
            if N > 1:
                cmd += ["--shard", f"{k}/{N}"]
            cmd += [fa, fq]
            procs.append(subprocess.Popen(
                cmd, env=env, stdout=open(out, "w"),
                stderr=open(err, "w")))
        for p in procs:
            assert p.wait() == 0, f"shard process failed (N={N})"
        dt = time.time() - t0
        merged = os.path.join(d, f"merged{N}.sam")
        if N > 1:
            subprocess.run([sys.executable, "-m", "bwamem_tpu", "merge",
                            merged, *paths], env=env, check=True,
                           capture_output=True, timeout=600)
        else:
            merged = paths[0]
        body = [l for l in open(merged) if not l.startswith("@")]
        if single_body is None:
            single_body = body
        else:
            assert body == single_body, \
                f"merged SAM (N={N}) != single-process SAM"
        # aggregate per-process STEADY align-loop rates (startup and
        # each process's first-chunk jit compiles excluded); the shards
        # run concurrently, so the sum is the box's aggregate steady
        # throughput
        rate = 0.0
        for err in errs:
            m = align_re.search(open(err).read())
            assert m, f"no align line in {err}"
            rate += float(m.group(4))
        results[N] = rate
        eff = rate / results[args.procs[0]] / (N / args.procs[0]) * 100
        print(f"[mh] N={N}: wall {dt:.1f}s  {rate:,.0f} reads/s "
              f"aggregate align-loop ({rate / N:,.0f}/proc, {eff:.0f}% "
              f"linear vs N={args.procs[0]})", file=sys.stderr)
    import json

    best = max(args.procs)
    print(json.dumps({
        "metric": "multihost_scaling",
        "value": round(results[best] / results[args.procs[0]]
                       / (best / args.procs[0]) * 100, 1),
        "unit": f"% linear {args.procs[0]}->{best} procs "
                f"(align-loop rates)",
        "reads_per_s": {str(k): round(v) for k, v in results.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
