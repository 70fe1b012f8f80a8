"""Smoke run of the aligner on one NVIDIA GPU: the quickest proof that the
system starts and aligns correctly on the card.  A smoke run, not a
benchmark: its rates are printed for orientation only.

  python chip_smoke.py [--genome-mb 64] [--se-reads 200000] ...
  python chip_smoke.py --four     # only the four-card path, on 4 cards

Phases, each in a child process run one after another (the parent never
opens the card: a JAX process reserves most of the card's memory, so a
second one would fail).  Every child runs with JAX_PLATFORMS=cuda, so a
missing CUDA plugin stops it instead of falling back to the CPU, and all
children share one compile cache (utils/jaxcfg.py).

a. device: platform, device kind and count; the card's name and power
   limit from nvidia-smi.  Fails unless JAX runs on a GPU.
b. kernel gate at real widths: bench.py checks the chosen extension step
   against the scalar oracle `ksw_extend_core` on --gate-lanes fuzz lanes
   and against the plain XLA step on the whole batch (exact equality),
   prints the compiled step's memory analysis; then the `gpu`-marked
   tests run.
c. main path at chr20 scale (BASELINE config #3): a seeded uniform
   random genome (bench/throughput.py's generator), `index`, then
   `mem --backend device --host native` for SE reads, FR pairs, pairs
   with 25% RR orientation under --device-rescue --device-cigar, and SE
   reads under --device-seed.
d. correctness: the first --check-reads reads and --check-pairs pairs
   again on the GPU and on the CPU (`--backend jax`, JAX_PLATFORMS=cpu)
   with the same -b: the SAM must be byte-identical except the @PG
   line.  The device-rescue/CIGAR and device-seed runs must match their
   host-path SAM, and most reads must map.
e. the last line: {"ok": true, "device": {...}}.

Any failure exits non-zero without that line.  --four runs four
`mem --shard k/4` processes, one per card (CUDA_VISIBLE_DEVICES=k),
merges their SAM and compares it byte for byte with a one-card run of
the same input made first; then `__graft_entry__.dryrun_multichip(4)`
drives the mesh wrappers of parallel/dist.py on the four cards.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CHILD_PLATFORM = "cuda"
_BASES = b"ACGTN"


def die(msg: str) -> None:
    print(f"[smoke] FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def child_env(**extra) -> dict:
    env = dict(os.environ, JAX_PLATFORMS=CHILD_PLATFORM)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def run(cmd, *, env=None, stdout=None, timeout=1800, label=None):
    """Run one child to its end; returns (stdout, stderr, seconds).
    A non-zero exit fails the smoke with the child's stderr."""
    t0 = time.perf_counter()
    with open(stdout, "w") if stdout else open(os.devnull, "w") as sink:
        r = subprocess.run(
            cmd, cwd=REPO, env=env or child_env(), text=True,
            stdout=sink if stdout else subprocess.PIPE,
            stderr=subprocess.PIPE, timeout=timeout)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        die(f"{label or cmd[:4]} exited {r.returncode}:\n"
            f"{(r.stdout or '')[-4000:]}\n{r.stderr[-8000:]}")
    return r.stdout or "", r.stderr, dt


# -- a. device ------------------------------------------------------------

def device_info(env=None) -> dict:
    out, _, _ = run([sys.executable, "-c",
                     "import jax, json; d = jax.devices(); print(json.dumps("
                     "{'platform': d[0].platform, 'kind': d[0].device_kind, "
                     "'count': len(d)}))"], env=env, label="device query")
    dev = json.loads(out.strip().splitlines()[-1])
    if dev["platform"] != "gpu":
        die(f"JAX runs on {dev['platform']}, not a GPU")
    return dev


# -- b. kernel gate -------------------------------------------------------

def kernel_gate(args) -> None:
    out, _, dt = run([sys.executable, "bench.py", "--bp", "8192", "--qmax",
                      "256", "--tmax", "512", "--gate",
                      str(args.gate_lanes)], label="bench.py gate")
    for line in out.splitlines():
        print(f"[b] {line}")
    print(f"[b] kernel gate passed in {dt:.1f}s")
    out, err, _ = run([sys.executable, "-m", "pytest", "tests/", "-m", "gpu",
                       "-q", "-rs", "-p", "no:cacheprovider"],
                      label="pytest -m gpu")
    tail = out.strip().splitlines()[-1]
    if "passed" not in tail or "skipped" in tail or "failed" in tail:
        die(f"gpu-marked tests: {tail}\n{out[-4000:]}")
    print(f"[b] gpu-marked tests: {tail}")


# -- c. data and the main path --------------------------------------------

def _simulator():
    spec = importlib.util.spec_from_file_location(
        "throughput", os.path.join(REPO, "bench", "throughput.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_fasta(path, name, pac) -> None:
    import numpy as np

    seq = np.frombuffer(_BASES, np.uint8)[pac].tobytes()
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        for i in range(0, len(seq), 80):
            f.write(seq[i:i + 80] + b"\n")


def write_fastq(path, reads, prefix, suffix="") -> None:
    import numpy as np

    lut = np.frombuffer(_BASES, np.uint8)
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b"@%s%d%s\n%s\n+\n%s\n" % (
                prefix.encode(), i, suffix.encode(), lut[r].tobytes(),
                b"I" * len(r)))


def make_data(args, wd) -> dict:
    """Genome, index and read files under `wd`; returns their paths."""
    import numpy as np

    sim = _simulator()
    rng = np.random.default_rng(args.seed)
    n_bp = int(args.genome_mb * 1e6)
    pac = sim.simulate_genome(rng, n_bp)
    p = {"fa": os.path.join(wd, "genome.fa")}
    write_fasta(p["fa"], "chr20sim", pac)
    se, _ = sim.simulate_reads(rng, pac, args.se_reads, 150)
    p["se"] = os.path.join(wd, "se.fq")
    write_fastq(p["se"], se, "se")
    p["se_head"] = os.path.join(wd, "se_head.fq")
    write_fastq(p["se_head"], se[:args.check_reads], "se")
    p["ds"] = os.path.join(wd, "ds.fq")
    write_fastq(p["ds"], se[:args.seed_reads], "se")
    for key, n, rr in (("pe", args.pe_pairs, 0.0),
                       ("rr", args.rescue_pairs, 0.25)):
        r1, r2 = sim.simulate_reads(rng, pac, n, 150, paired=True,
                                    discordant=rr)
        for end, reads in ((1, r1), (2, r2)):
            p[f"{key}{end}"] = os.path.join(wd, f"{key}_{end}.fq")
            write_fastq(p[f"{key}{end}"], reads, key, f"/{end}")
            if key == "pe":
                p[f"pe_head{end}"] = os.path.join(wd, f"pe_head_{end}.fq")
                write_fastq(p[f"pe_head{end}"], reads[:args.check_pairs],
                            key, f"/{end}")
    del se
    _, err, dt = run([sys.executable, "-m", "bwamem_tpu", "index", p["fa"]],
                     label="index")
    print(f"[c] genome {n_bp} bp, index built in {dt:.1f}s")
    return p


def mem(args, fa, reads, out, *extra, backend="device", env=None):
    """One `mem` run; returns (wall seconds, the `[mem] align:` line)."""
    cmd = [sys.executable, "-m", "bwamem_tpu", "mem", "--backend", backend,
           "--host", "native", "-t", str(args.threads), "-b",
           str(args.batch), *extra, fa, *reads]
    _, err, dt = run(cmd, env=env, stdout=out, label=" ".join(cmd[3:]))
    align = [ln for ln in err.splitlines() if ln.startswith("[mem] align:")]
    return dt, (align[-1] if align else "(no align line)")


def main_path(args, p, wd, card_line) -> dict:
    runs = {
        "se": ((p["se"],), ()),
        "pe": ((p["pe1"], p["pe2"]), ()),
        "rr_dev": ((p["rr1"], p["rr2"]),
                   ("--device-rescue", "--device-cigar")),
        "ds_dev": ((p["ds"],), ("--device-seed",)),
    }
    sams = {}
    for label, (reads, extra) in runs.items():
        sams[label] = os.path.join(wd, f"{label}.sam")
        dt, align = mem(args, p["fa"], reads, sams[label], *extra)
        print(f"[c] {label} {' '.join(extra)}: wall {dt:.3f}s; {align}; "
              f"{card_line}; smoke run, not a benchmark")
    return sams


# -- d. correctness -------------------------------------------------------

def sam_body(path) -> list[str]:
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@PG")]


def same_sam(a, b, what) -> int:
    la, lb = sam_body(a), sam_body(b)
    if la != lb:
        bad = next((i for i, (x, y) in enumerate(zip(la, lb)) if x != y),
                   min(len(la), len(lb)))
        die(f"{what}: SAM differs ({len(la)} vs {len(lb)} lines; first "
            f"difference at line {bad}:\n{la[bad:bad + 1]}\n"
            f"{lb[bad:bad + 1]})")
    n = sum(1 for ln in la if not ln.startswith("@"))
    print(f"[d] {what}: {n} SAM records byte-identical (only @PG may "
          f"differ)")
    return n


def mapped_fraction(path) -> float:
    n = mapped = 0
    with open(path) as f:
        for ln in f:
            if ln.startswith("@"):
                continue
            flag = int(ln.split("\t", 2)[1])
            if flag & 0x900:
                continue
            n += 1
            mapped += not flag & 0x4
    return mapped / max(n, 1)


def correctness(args, p, wd, sams) -> None:
    cpu = child_env(JAX_PLATFORMS="cpu")
    for label, reads in (("se_head", (p["se_head"],)),
                         ("pe_head", (p["pe_head1"], p["pe_head2"]))):
        gpu_sam = os.path.join(wd, f"{label}.gpu.sam")
        cpu_sam = os.path.join(wd, f"{label}.cpu.sam")
        mem(args, p["fa"], reads, gpu_sam)
        mem(args, p["fa"], reads, cpu_sam, backend="jax", env=cpu)
        same_sam(gpu_sam, cpu_sam, f"{label}: GPU --backend device vs "
                                   f"CPU --backend jax")
    host = os.path.join(wd, "rr_host.sam")
    mem(args, p["fa"], (p["rr1"], p["rr2"]), host)
    same_sam(sams["rr_dev"], host,
             "rr: --device-rescue --device-cigar vs host rescue/CIGAR")
    host = os.path.join(wd, "ds_host.sam")
    mem(args, p["fa"], (p["ds"],), host)
    same_sam(sams["ds_dev"], host, "ds: --device-seed vs host seeding")
    for label in ("se", "pe"):
        frac = mapped_fraction(sams[label])
        if frac < 0.9:
            die(f"{label}: only {frac:.4f} of primary records mapped")
        print(f"[d] {label}: {frac:.4f} of primary records mapped")


# -- the four-card path ---------------------------------------------------

def four_cards(args, p, wd, card_line) -> None:
    one = os.path.join(wd, "one_card.sam")
    dt, align = mem(args, p["fa"], (p["se"],), one,
                    env=child_env(CUDA_VISIBLE_DEVICES="0"))
    print(f"[4] one card: wall {dt:.3f}s; {align}; {card_line}; smoke run")
    shards = [os.path.join(wd, f"shard{k}.sam") for k in range(4)]
    procs, sinks = [], []
    t0 = time.perf_counter()
    try:
        for k, out in enumerate(shards):
            cmd = [sys.executable, "-m", "bwamem_tpu", "mem", "--backend",
                   "device", "--host", "native", "-t",
                   str(max(args.threads // 4, 1)), "-b", str(args.batch),
                   "--shard", f"{k}/4", p["fa"], p["se"]]
            sinks.append(open(out, "w"))
            procs.append(subprocess.Popen(
                cmd, cwd=REPO, env=child_env(CUDA_VISIBLE_DEVICES=str(k)),
                stdout=sinks[-1], stderr=subprocess.PIPE, text=True))
        errs = [pr.communicate(timeout=1800)[1] for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
        for f in sinks:
            f.close()
    for k, (pr, err) in enumerate(zip(procs, errs)):
        if pr.returncode != 0:
            die(f"shard {k}/4 exited {pr.returncode}:\n{err[-6000:]}")
        align = [ln for ln in err.splitlines() if ln.startswith("[mem] align")]
        print(f"[4] shard {k}/4 on card {k}: {align[-1] if align else ''}")
    print(f"[4] four shards: wall {time.perf_counter() - t0:.3f}s; "
          f"{card_line}; smoke run")
    merged = os.path.join(wd, "merged.sam")
    run([sys.executable, "-m", "bwamem_tpu", "merge", merged, *shards],
        label="merge")
    same_sam(merged, one, "four-card merged SAM vs one-card SAM")
    out, _, dt = run([sys.executable, "-c",
                      "import __graft_entry__ as g; g.dryrun_multichip(4)"],
                     label="dryrun_multichip(4)")
    print(f"[4] {out.strip().splitlines()[-1]} ({dt:.1f}s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-mb", type=float, default=64.0)
    ap.add_argument("--se-reads", type=int, default=200_000)
    ap.add_argument("--pe-pairs", type=int, default=100_000)
    ap.add_argument("--rescue-pairs", type=int, default=20_000)
    ap.add_argument("--seed-reads", type=int, default=10_000)
    ap.add_argument("--check-reads", type=int, default=4096)
    ap.add_argument("--check-pairs", type=int, default=2048)
    ap.add_argument("--gate-lanes", type=int, default=512)
    ap.add_argument("--batch", type=int, default=2048, help="mem -b")
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 1,
                    help="mem -t")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=os.path.join(REPO, ".smoke"))
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path and its comparison")
    args = ap.parse_args(argv)

    for need in ("bwamem_tpu", "bench.py", "bench", "tests"):
        if not os.path.exists(os.path.join(REPO, need)):
            die(f"{need} not found beside chip_smoke.py: run it from a "
                f"checkout of the repository")
    from bench import card_name_and_power

    dev = device_info()
    card_line = card_name_and_power()
    print(f"[a] JAX devices: platform {dev['platform']}, kind "
          f"{dev['kind']}, count {dev['count']}")
    for line in card_line.splitlines():
        print(f"[a] card: {line}")
    card_short = card_line.splitlines()[0]
    if args.four and dev["count"] < 4:
        die(f"--four needs 4 cards, JAX sees {dev['count']}")
    os.makedirs(args.workdir, exist_ok=True)
    if args.four:
        p = make_data(args, args.workdir)
        four_cards(args, p, args.workdir, card_short)
    else:
        kernel_gate(args)
        p = make_data(args, args.workdir)
        sams = main_path(args, p, args.workdir, card_short)
        correctness(args, p, args.workdir, sams)
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
