"""End-to-end reads/s benchmark (the BASELINE.json config ladder).

Usage:
  python bench/throughput.py [--genome-mb 4.6] [--reads 2000]
                             [--read-len 150] [--backend device|jax]
                             [--paired]

Simulates a genome + mutated reads, then measures the full pipeline
(seeding -> chaining -> device extension -> CIGAR -> SAM) with the
batched seeding path and the device extension backend, reporting a
stage breakdown.  This is the "reads aligned/sec at 1 chip" number of
the north star; bench.py reports the kernel GCUPS number.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def simulate_genome(rng, n_bp: int) -> np.ndarray:
    """A uniform random genome of n_bp base codes (uint8, 0..3)."""
    return rng.integers(0, 4, n_bp).astype(np.uint8)


def simulate_reads(rng, pac, n_reads: int, read_len: int,
                   paired: bool = False, discordant: float = 0.0):
    """Reads drawn from `pac` with 1% uniform substitutions: (reads,
    mates) lists of int64 code arrays (mates empty for single-end).

    Single-end reads alternate strands.  Pairs form an FR library with
    an N(350, 30) insert: the left end forward, the right end reverse
    complemented, read1 alternating between them; `discordant` makes
    that fraction of pairs same-strand (RR), so mate rescue fires on
    them.  Vectorized and chunked to bound transient memory."""
    n_bp = len(pac)
    reads, mates = [], []
    rl = read_len
    span = np.arange(rl)
    for lo in range(0, n_reads, 1 << 20):
        n = min(n_reads - lo, 1 << 20)
        pos = rng.integers(0, n_bp - 600, size=n)
        R = pac[pos[:, None] + span].astype(np.int64)
        mut = rng.random((n, rl)) < 0.01
        R[mut] = rng.integers(0, 4, int(mut.sum()))
        if paired:
            isize = rng.normal(350, 30, size=n).astype(np.int64)
            M = pac[(pos + isize - rl)[:, None] + span].astype(np.int64)
            mut2 = rng.random((n, rl)) < 0.01
            M[mut2] = rng.integers(0, 4, int(mut2.sum()))
            M = 3 - M[:, ::-1]
            if discordant > 0:
                # un-revcomp a fraction of mates: both ends forward =>
                # RR orientation, outside the trained FR window =>
                # mem_matesw fires on every such pair
                bad = rng.random(n) < discordant
                M[bad] = 3 - M[bad][:, ::-1]
            R[1::2], M[1::2] = M[1::2].copy(), R[1::2].copy()
            reads.extend(R)
            mates.extend(M)
        else:
            R[1::2] = 3 - R[1::2, ::-1]
            reads.extend(R)
    return reads, mates


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mb", type=float, default=4.6)
    ap.add_argument("--reads", type=int, default=2000)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--backend", default="device",
                    choices=["device", "jax", "scalar"])
    ap.add_argument("--paired", action="store_true")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--host", default="auto",
                    choices=["auto", "native", "python"])
    ap.add_argument("-t", "--threads", type=int, default=1)
    ap.add_argument("--inflight", type=int, default=2,
                    help="chunks in flight with --overlap (pipeline "
                         "depth)")
    ap.add_argument("--overlap", action="store_true",
                    help="double-buffered chunk pipeline (2 handles)")
    ap.add_argument("--ship-ref", action="store_true",
                    help="ship target windows from the host instead of "
                         "gathering from the device-resident reference")
    ap.add_argument("--bucket-split", action="store_true",
                    help="dispatch each fused chunk as two shape "
                         "buckets (global dims + a percentile-derived "
                         "smaller shape) — cuts qmax/tmax padding at "
                         "the cost of a second device call")
    ap.add_argument("--phased", action="store_true",
                    help="use the 4-pass protocol instead of the fused "
                         "whole-alignment step")
    ap.add_argument("--device-rescue", action="store_true",
                    help="run mem_matesw local-SW batches on device "
                         "(the mp_rescue_* wave protocol)")
    ap.add_argument("--device-seed", action="store_true",
                    help="SMEM seeding + SA walks on device "
                         "(ops/smem_jax; the CPU-starved-host path)")
    ap.add_argument("--device-cigar", action="store_true",
                    help="run reg2aln banded globals + traceback on "
                         "device (the mp_cigar_* round protocol)")
    ap.add_argument("--trace", metavar="PATH",
                    help="write the per-batch device trace "
                         "(utils.metrics.Tracer JSONL) to PATH")
    ap.add_argument("--discordant", type=float, default=0.0,
                    metavar="FRAC",
                    help="make FRAC of simulated pairs same-strand "
                         "(RR) so mate rescue fires on them — the "
                         "worst-case PE stress configuration")
    args = ap.parse_args()

    from bwamem_tpu.config import MemOptions
    from bwamem_tpu.index.build import build_index
    from bwamem_tpu.index.occ_packed import pack_occ
    from bwamem_tpu.io.fasta import Contig, Reference
    from bwamem_tpu.pipeline.align import revcomp_read
    from bwamem_tpu.pipeline.driver import align_batch
    from bwamem_tpu.pipeline.pair import align_pairs

    opt = MemOptions()
    rng = np.random.default_rng(0)
    n_bp = int(args.genome_mb * 1e6)
    print(f"[sim] genome {n_bp/1e6:.1f} Mb, {args.reads} reads x "
          f"{args.read_len} bp", file=sys.stderr)
    pac = simulate_genome(rng, n_bp)
    ref = Reference(contigs=[Contig("sim", 0, n_bp)], pac=pac)

    # cache the simulated-genome index across bench invocations (the
    # build is deterministic in n_bp; a 60 Mb rebuild costs 40-80 s per
    # config sweep point otherwise).  Caches are format-versioned and
    # written atomically (bench/cachefmt.py) so a layout change or a
    # crashed build can never feed a stale/truncated index to a run.
    # bench.py at the repo root shadows the bench/ dir for `import
    # bench.*`; load the sibling helper by directory instead
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import cachefmt

    t0 = time.time()
    z = cachefmt.load_idx(n_bp)
    if z is not None:
        from bwamem_tpu.index.build import FMIndex

        fm = FMIndex(
            l_pac=int(z["l_pac"]), seq_len2=int(z["seq_len2"]),
            primary=int(z["primary"]), C=z["C"], bwt=z["bwt"],
            occ_cp=z["occ_cp"], sa_intv=int(z["sa_intv"]), ssa=z["ssa"],
            pac=z["pac"])
        how = "cached"
    else:
        fm = build_index(pac)
        cachefmt.save_idx(n_bp, fm)
        how = "built"
    t_index = time.time() - t0
    # the occ pack is ~7 min at GRCh38 scale — cache it beside the index
    z = cachefmt.load_occ(n_bp)
    if z is not None:
        from bwamem_tpu.index.occ_packed import PackedOcc

        po = PackedOcc(occ_rows=z["occ_rows"], pk_rows=z["pk_rows"],
                       va_rows=z["va_rows"], C=z["C"],
                       primary=int(z["primary"]), n_rows=int(z["n_rows"]))
    else:
        po = pack_occ(fm)
        cachefmt.save_occ(n_bp, po)
    print(f"[index] {t_index:.1f}s ({how})", file=sys.stderr)

    reads, mates = simulate_reads(rng, pac, args.reads, args.read_len,
                                  args.paired, args.discordant)

    from bwamem_tpu.pipeline import native_driver

    use_native = (args.host != "python" and args.backend != "scalar"
                  and native_driver.available())
    backend_fn = None
    raw_t_fn = None
    rescue_fn = None
    pipes = []
    # one resident two-strand text shared by every idx backend
    text_dev = (native_driver.make_resident_text(ref.pac)
                if use_native and not args.ship_ref else None)
    if args.device_rescue:
        if args.ship_ref or text_dev is None:
            from bwamem_tpu.ops.local_jax import make_rescue_backend

            rescue_fn = make_rescue_backend()
        else:  # resident-reference waves: meta-only H2D
            rescue_fn = native_driver.make_rescue_idx_backend(
                text_dev=text_dev)
    cigar_fn = None
    if args.device_cigar:
        if args.ship_ref or text_dev is None:
            from bwamem_tpu.ops.global_jax import make_cigar_backend

            cigar_fn = make_cigar_backend()
        else:  # resident-reference rounds: meta-only H2D
            cigar_fn = native_driver.make_cigar_idx_backend(
                text_dev=text_dev)
    if args.backend != "scalar":
        import jax

        from bwamem_tpu.utils.jaxcfg import enable_compilation_cache

        enable_compilation_cache()
        import jax.numpy as jnp

        from bwamem_tpu.ops.extend_jax import ExtendParams

        params = ExtendParams(
            mat_flat=jnp.asarray(opt.mat.astype(np.int32).ravel()), m=5,
            o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
            e_ins=opt.e_ins, zdrop=opt.zdrop)
        if use_native:
            if args.backend == "jax":
                raw_t_fn = native_driver.make_jax_raw_t_backend(params)
            elif args.phased:
                raw_t_fn = native_driver.make_raw_t_backend(params)
            elif args.ship_ref:
                # fused whole-alignment step: 1 device call/chunk
                raw_t_fn = native_driver.make_fused_backend(params)
            else:  # + device-resident reference: scalars-only H2D
                raw_t_fn = native_driver.make_fused_idx_backend(
                    params, ref.pac, text_dev=text_dev)
            tracer = None
            if args.trace:
                from bwamem_tpu.utils.metrics import Tracer

                tracer = Tracer(args.trace)
            pipes = [native_driver.NativePipeline(
                opt, ref, fm, po, nthreads=args.threads, tracer=tracer,
                bucket_split=args.bucket_split)
                for _ in range(args.inflight if args.overlap else 1)]
            if args.device_seed:
                from bwamem_tpu.ops.smem_jax import make_device_seeder

                seeder = make_device_seeder(po, fm, opt)
                for p_ in pipes:
                    p_.seed_fn = seeder
            print(f"[host] native pipeline, {args.threads} thread(s)"
                  f"{', overlapped' if args.overlap else ''}",
                  file=sys.stderr)
        elif args.backend == "jax":
            from bwamem_tpu.ops.extend_jax import extend_batch_core
            backend_fn = jax.jit(lambda *a: extend_batch_core(*a, params))
        else:
            from bwamem_tpu.ops.extend_step import make_pass_backend
            backend_fn = make_pass_backend(params)

    t0 = time.time()
    n_rec = 0
    chunk_times = []
    if use_native and args.overlap:
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        def submit(ex, ci, i):
            chunk = reads[i:i + args.batch]
            if args.paired:
                return len(chunk), ex.submit(
                    pipes[ci % len(pipes)].align_pairs_chunk_text,
                    chunk, mates[i:i + args.batch], raw_t_fn,
                    rescue_fn=rescue_fn, cigar_fn=cigar_fn)
            return len(chunk), ex.submit(
                pipes[ci % len(pipes)].align_chunk_text, chunk,
                raw_t_fn, cigar_fn=cigar_fn)

        with ThreadPoolExecutor(max_workers=args.inflight) as ex:
            futs: deque = deque()
            tc = time.time()
            for ci, i in enumerate(range(0, len(reads), args.batch)):
                futs.append(submit(ex, ci, i))
                while len(futs) >= args.inflight:
                    nc, f = futs.popleft()
                    n_rec += f.result()[1]
                    chunk_times.append((nc, time.time() - tc))
                    tc = time.time()
            while futs:
                nc, f = futs.popleft()
                n_rec += f.result()[1]
                chunk_times.append((nc, time.time() - tc))
                tc = time.time()
    else:
        for i in range(0, len(reads), args.batch):
            tc = time.time()
            chunk = reads[i:i + args.batch]
            if args.paired:
                if use_native:
                    recs = pipes[0].align_pairs_chunk(
                        chunk, mates[i:i + args.batch], raw_t_fn,
                        rescue_fn=rescue_fn, cigar_fn=cigar_fn)
                else:
                    recs = align_pairs(opt, ref, fm, chunk,
                                       mates[i:i + args.batch], po=po,
                                       extend_batch_fn=backend_fn)
            elif use_native:
                recs = pipes[0].align_chunk(chunk, raw_t_fn,
                                            cigar_fn=cigar_fn)
            elif backend_fn is None:
                from bwamem_tpu.pipeline.align import align_read
                recs = [align_read(opt, ref, fm, f"r{i+j}", r)
                        for j, r in enumerate(chunk)]
            else:
                recs = align_batch(opt, ref, fm, chunk, backend_fn, po=po)
            n_rec += sum(len(x) for x in recs)
            chunk_times.append((len(chunk), time.time() - tc))
    dt = time.time() - t0
    if args.trace and pipes and pipes[0].tracer is not None:
        c = pipes[0].tracer.counters
        print(f"[trace] device {c.device_seconds:.2f}s over "
              f"{c.device_batches} batches ({c.band_cells/1e9:.1f} Gcells)"
              f", host {c.host_seconds:.2f}s, wall {dt:.2f}s",
              file=sys.stderr)
        pipes[0].tracer.close()
    n = len(reads) * (2 if args.paired else 1)
    mult = 2 if args.paired else 1
    # steady state excludes the warm-up chunk (it absorbs the compiles)
    steady = chunk_times[1:] or chunk_times
    st_rate = sum(c * mult for c, _ in steady) / sum(t for _, t in steady)
    print(f"[align] {n} reads in {dt:.1f}s -> {n/dt:.1f} reads/s total, "
          f"{st_rate:.1f} reads/s steady-state "
          f"({n_rec} SAM records, backend={args.backend})",
          file=sys.stderr)
    print(f"{st_rate:.1f}")


if __name__ == "__main__":
    main()
