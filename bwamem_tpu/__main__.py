"""Command-line interface — the `bwa` drop-in surface.

  python -m bwamem_tpu index ref.fa
  python -m bwamem_tpu mem [-t N] [-b BATCH] [-M] [-a] [-R RG] \
         [--backend device|jax|scalar] ref.fa reads.fq [mates.fq] > out.sam

Mirrors the reference invocation `$BWA mem --target=ASE|Direct -t N
-b BATCH -Ma -R hdr ref.fa in.fq` (README.md:28-34): `--backend` is the
ASE/Direct analogue.  scalar = the pure-host model; jax = the plain XLA
extension twin on whatever device JAX runs on; device = the platform's
extension step (ops/extend_step.step_for: the CUDA kernel on a GPU,
the plain XLA step on the CPU) behind the fused resident-reference
protocol.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def cmd_index(args) -> int:
    from bwamem_tpu.index.build import build_index
    from bwamem_tpu.io.fasta import read_fasta

    ref = read_fasta(args.fasta)
    sys.stderr.write(
        f"[index] {len(ref.contigs)} contig(s), {ref.l_pac} bp\n")
    fm = build_index(ref.pac, sa_intv=args.sa_intv)
    out = args.fasta + ".bwt.npz"
    # uncompressed: zlib over a GRCh38-scale index costs many minutes
    # and bwa's own index files are raw; np.load reads either format
    np.savez(
        out,
        l_pac=fm.l_pac, seq_len2=fm.seq_len2, primary=fm.primary,
        C=fm.C, bwt=fm.bwt, occ_cp=fm.occ_cp, sa_intv=fm.sa_intv,
        ssa=fm.ssa, pac=fm.pac,
        names=np.array([c.name for c in ref.contigs]),
        offsets=np.array([c.offset for c in ref.contigs]),
        lengths=np.array([c.length for c in ref.contigs]),
    )
    sys.stderr.write(f"[index] wrote {out}\n")
    return 0


def load_index(fasta: str):
    from bwamem_tpu.index.build import FMIndex
    from bwamem_tpu.io.fasta import Contig, Reference

    path = fasta + ".bwt.npz"
    if not os.path.exists(path):
        sys.stderr.write(f"[mem] no index at {path}; run `index` first\n")
        raise SystemExit(1)
    z = np.load(path, allow_pickle=False)
    fm = FMIndex(
        l_pac=int(z["l_pac"]), seq_len2=int(z["seq_len2"]),
        primary=int(z["primary"]), C=z["C"], bwt=z["bwt"],
        occ_cp=z["occ_cp"], sa_intv=int(z["sa_intv"]), ssa=z["ssa"],
        pac=z["pac"])
    contigs = [Contig(str(n), int(o), int(l)) for n, o, l in
               zip(z["names"], z["offsets"], z["lengths"])]
    return Reference(contigs=contigs, pac=z["pac"]), fm


def _extend_params(opt):
    import jax.numpy as jnp

    from bwamem_tpu.ops.extend_jax import ExtendParams

    return ExtendParams(
        mat_flat=jnp.asarray(opt.mat.astype(np.int32).ravel()), m=5,
        o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
        e_ins=opt.e_ins, zdrop=opt.zdrop)


def make_extend_backend(opt, backend: str):
    """Returns extend_batch_fn for the driver, or None for scalar."""
    if backend == "scalar":
        return None
    import jax

    from bwamem_tpu.utils.jaxcfg import enable_compilation_cache

    enable_compilation_cache()
    params = _extend_params(opt)
    if backend == "jax":
        from bwamem_tpu.ops.extend_jax import extend_batch_core

        return jax.jit(lambda *a: extend_batch_core(*a, params))
    from bwamem_tpu.ops.extend_step import make_pass_backend

    return make_pass_backend(params)


def make_raw_t_backend(opt, backend: str, pac=None, ship_ref=False,
                       text_dev=None):
    """Transposed-layout device backend for the native host pipeline."""
    from bwamem_tpu.utils.jaxcfg import enable_compilation_cache

    enable_compilation_cache()
    from bwamem_tpu.pipeline import native_driver

    params = _extend_params(opt)
    if backend == "jax":
        return native_driver.make_jax_raw_t_backend(params)
    if pac is not None and not ship_ref:
        # fused step + device-resident reference: one device call per
        # chunk and scalars-only H2D
        return native_driver.make_fused_idx_backend(params, pac,
                                                    text_dev=text_dev)
    # fused whole-alignment step on host-shipped windows
    return native_driver.make_fused_backend(params)


def _parse_isize(spec):
    """-I FLOAT[,FLOAT[,INT[,INT]]]: mean, std (10% of mean if
    absent), max (mean+4*std if absent), min of the insert-size
    distribution (bwa mem -I)."""
    if not spec:
        return {}
    parts = spec.split(",")
    out = {"pe_mean": float(parts[0])}
    if len(parts) > 1:
        out["pe_std"] = float(parts[1])
    if len(parts) > 2:
        out["pe_max"] = int(parts[2])
    if len(parts) > 3:
        out["pe_min"] = int(parts[3])
    return out


def cmd_mem(args) -> int:
    from bwamem_tpu.config import MemOptions
    from bwamem_tpu.io.fastq import iter_fastq_chunks
    from bwamem_tpu.io.sam import sam_header
    from bwamem_tpu.pipeline import align as A
    from bwamem_tpu.pipeline import native_driver
    from bwamem_tpu.pipeline.driver import align_batch
    from bwamem_tpu.pipeline.pair import align_pairs

    opt = MemOptions(flag_M=args.M, flag_a=args.a, w=args.w,
                     min_seed_len=args.k, T=args.T,
                     a=args.A, b=args.B, o_del=args.O, o_ins=args.O,
                     e_del=args.E, e_ins=args.E, zdrop=args.d,
                     pen_clip5=args.L, pen_clip3=args.L,
                     pen_unpaired=args.U, split_factor=args.r,
                     max_occ=args.c,
                     max_matesw=0 if args.S else 100,
                     skip_pairing=args.P,
                     **_parse_isize(args.I))
    ref, fm = load_index(args.fasta)
    from bwamem_tpu.index.occ_packed import pack_occ

    po = pack_occ(fm)
    # streaming chunked ingest: WGS inputs never fully materialize.
    # pair_iter yields (chunk, mate_chunk) for the PE path; None = SE.
    chunks = None
    pair_iter = None
    if args.p and not args.mates:
        # -p: one file of interleaved pairs — de-interleave per chunk
        pair_iter = ((c[0::2], c[1::2])
                     for c in iter_fastq_chunks(args.reads, 2 * args.b))
    elif args.mates:
        pair_iter = zip(iter_fastq_chunks(args.reads, args.b),
                        iter_fastq_chunks(args.mates, args.b))
    else:
        chunks = iter_fastq_chunks(args.reads, args.b)
    # multi-host scale-out (SURVEY §7 step 6): each process aligns the
    # strided shard_reads assignment and writes its own SAM; `merge`
    # restores input order byte-identically.  --shard K/N is explicit;
    # under the JAX distributed runtime (JAX_COORDINATOR set by a
    # multi-host launcher) the shard is derived from the process id.
    shard_id, n_shards = 0, 1
    if args.shard:
        shard_id, n_shards = (int(x) for x in args.shard.split("/"))
        if not 0 <= shard_id < n_shards:
            sys.stderr.write(f"[mem] bad --shard {args.shard}\n")
            return 1
    elif os.environ.get("JAX_COORDINATOR"):
        from bwamem_tpu.parallel.multihost import init_distributed

        shard_id, n_shards = init_distributed()
    if n_shards > 1:
        from bwamem_tpu.parallel.multihost import (
            shard_chunk_stream,
            shard_pair_stream,
        )

        if pair_iter is not None:
            pair_iter = shard_pair_stream(pair_iter, shard_id, n_shards,
                                          args.b)
        else:
            chunks = shard_chunk_stream(chunks, shard_id, n_shards,
                                        args.b)
        sys.stderr.write(f"[mem] shard {shard_id}/{n_shards} "
                         f"(strided)\n")
    if args.host == "native" and args.backend != "scalar":
        from bwamem_tpu import native

        native.require()   # an explicit request fails with g++'s error
    use_native = (args.host != "python" and args.backend != "scalar"
                  and native_driver.available())
    out = sys.stdout
    out.write(sam_header(ref.contigs, rg_line=args.R,
                         pg_cl=" ".join(sys.argv)))
    # bwa attaches RG:Z:<ID> to every record when -R carries an ID
    rg_id = None
    if args.R:
        for f in args.R.replace("\\t", "\t").split("\t"):
            if f.startswith("ID:"):
                rg_id = f[3:]
                break

    def emit(rec, comments=None) -> None:
        """Write one record; -C appends the FASTQ comment of the end
        the record belongs to (bwa appends it verbatim)."""
        line = rec.line()
        if rg_id and not use_native:
            # native records already carry RG:Z via mp_set_rg
            line += "\tRG:Z:" + rg_id
        if comments is not None:
            cm = comments[1] if (rec.flag & 0x80) else comments[0]
            if cm:
                line += "\t" + cm
        out.write(line + "\n")
    n_rec = 0
    n_reads = 0
    tracer = None
    if args.trace:
        from bwamem_tpu.utils.metrics import Tracer

        tracer = Tracer(args.trace)
    manifest = None
    if args.resume:
        from bwamem_tpu.utils.checkpoint import Manifest, ReadRange

        manifest = Manifest(args.resume)
    if args.device_cigar and args.backend != "scalar" and (
            pair_iter is not None and not use_native):
        sys.stderr.write("[mem] --device-cigar for PE needs the native "
                         "host; ignored here\n")
    if args.device_cigar and args.backend == "scalar":
        sys.stderr.write("[mem] --device-cigar needs a device backend; "
                         "ignored here\n")
    # one resident two-strand text shared by every idx backend
    text_dev = (native_driver.make_resident_text(ref.pac)
                if use_native and not args.ship_ref else None)
    cigar_fn = None
    if (args.device_cigar and use_native and args.backend != "scalar"):
        if args.ship_ref:
            from bwamem_tpu.ops.global_jax import make_cigar_backend

            cigar_fn = make_cigar_backend()
        else:  # resident-reference rounds: meta-only H2D
            cigar_fn = native_driver.make_cigar_idx_backend(
                text_dev=text_dev)
    rescue_fn = None
    if args.device_rescue:
        if pair_iter is None or not use_native:
            sys.stderr.write("[mem] --device-rescue applies to the "
                             "native PE path; ignored here\n")
        elif args.ship_ref:
            from bwamem_tpu.ops.local_jax import make_rescue_backend

            rescue_fn = make_rescue_backend()
        else:  # resident-reference waves: meta-only H2D
            rescue_fn = native_driver.make_rescue_idx_backend(
                text_dev=text_dev)
    seed_fn = None
    if args.device_seed:
        if not use_native or args.backend == "scalar":
            sys.stderr.write("[mem] --device-seed needs the native host "
                             "and a device backend; ignored here\n")
        elif int(po.n_rows) >= 1 << 31:
            sys.stderr.write("[mem] --device-seed: reference too large "
                             "for int32 device positions; using host "
                             "seeding\n")
        else:
            from bwamem_tpu.ops.smem_jax import make_device_seeder

            seed_fn = make_device_seeder(po, fm, opt)
    raw_t_fn = None
    if use_native:
        raw_t_fn = make_raw_t_backend(opt, args.backend, pac=ref.pac,
                                      ship_ref=args.ship_ref,
                                      text_dev=text_dev)
    import time as _time

    t_align0 = _time.time()  # align-loop wall: excludes index load and
    #                          backend/reference-residency setup
    # steady-state mark: the first completed chunk absorbs the jit
    # compiles, so the steady rate is measured from its completion
    _steady = [None, 0, 0]  # [t_first_done, reads_at_first_done, chunks]

    def _mark_chunk_done(reads_done: int) -> None:
        _steady[2] += 1
        if _steady[0] is None:
            _steady[0] = _time.time()
            _steady[1] = reads_done

    if pair_iter is not None:
        if use_native:
            # full PE chunk in C++: pestat, mate rescue, pairing, sam_pe
            pipe = native_driver.NativePipeline(
                opt, ref, fm, po, nthreads=args.t, tracer=tracer,
                bucket_split=args.bucket_split)
            pipe.seed_fn = seed_fn
            if rg_id:
                pipe.set_rg(rg_id)
            backend_fn = None
        else:
            backend_fn = make_extend_backend(opt, args.backend)
        for chunk, mchunk in pair_iter:
            assert len(chunk) == len(mchunk), "read/mate count mismatch"
            start = n_reads // 2
            n_reads += len(chunk) * 2
            if manifest is not None:
                rr = ReadRange(0, start, start + len(chunk))
                if manifest.is_done(rr):
                    continue
            if use_native and not args.C:
                # zero-object fast path: the chunk's SAM arrives as
                # one pre-terminated text blob straight from C++
                text, nr_ = pipe.align_pairs_chunk_text(
                    [r.seq.astype(np.int64) for r in chunk],
                    [m.seq.astype(np.int64) for m in mchunk], raw_t_fn,
                    names=[r.name for r in chunk],
                    quals1=[r.qual for r in chunk],
                    quals2=[m.qual for m in mchunk],
                    rescue_fn=rescue_fn, cigar_fn=cigar_fn)
                out.write(text)
                n_rec += nr_
                recs = []
            elif use_native:
                recs = pipe.align_pairs_chunk(
                    [r.seq.astype(np.int64) for r in chunk],
                    [m.seq.astype(np.int64) for m in mchunk], raw_t_fn,
                    names=[r.name for r in chunk],
                    quals1=[r.qual for r in chunk],
                    quals2=[m.qual for m in mchunk],
                    rescue_fn=rescue_fn, cigar_fn=cigar_fn)
            else:
                recs = align_pairs(
                    opt, ref, fm,
                    [r.seq.astype(np.int64) for r in chunk],
                    [m.seq.astype(np.int64) for m in mchunk],
                    names=[r.name for r in chunk],
                    quals1=[r.qual for r in chunk],
                    quals2=[m.qual for m in mchunk], po=po,
                    extend_batch_fn=backend_fn)
            for gi, rr_ in enumerate(recs):
                cms = ((chunk[gi].comment, mchunk[gi].comment)
                       if args.C else None)
                for rec in rr_:
                    emit(rec, cms)
                    n_rec += 1
            if manifest is not None:
                manifest.mark_done(rr)
            _mark_chunk_done(n_reads)
            if args.v >= 3:
                sys.stderr.write(
                    f"[mem] processed {n_reads} reads\n")
    elif use_native:
        # TBB-style pipelining: --inflight pipeline handles; chunk
        # n+1's host work (C++, GIL-free) overlaps chunk n's device
        # phases (/root/reference/tbb.v:84-118 HOLD-while-fetch)
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        depth = max(args.inflight, 1)
        pipes = [native_driver.NativePipeline(
            opt, ref, fm, po, nthreads=args.t, tracer=tracer,
            bucket_split=args.bucket_split)
                 for _ in range(depth)]
        for p_ in pipes:
            p_.seed_fn = seed_fn
        if rg_id:
            for p_ in pipes:
                p_.set_rg(rg_id)

        def run_chunk(ci, chunk):
            pipe_ = pipes[ci % len(pipes)]
            seqs = [r.seq.astype(np.int64) for r in chunk]
            names_ = [r.name for r in chunk]
            quals_ = [r.qual for r in chunk]
            if not args.C:
                # zero-object fast path: pre-terminated text blob
                return pipe_.align_chunk_text(seqs, raw_t_fn,
                                              names=names_,
                                              quals=quals_,
                                              cigar_fn=cigar_fn)
            return pipe_.align_chunk(seqs, raw_t_fn, names=names_,
                                     quals=quals_, cigar_fn=cigar_fn)

        reads_done = 0

        def flush_one(futs):
            nonlocal n_rec, reads_done
            rng_, cms, n_chunk, fut = futs.popleft()
            got = fut.result()
            if not args.C:
                text, nr_ = got
                out.write(text)
                n_rec += nr_
            else:
                for gi, rr in enumerate(got):
                    cm = (cms[gi], None) if cms is not None else None
                    for rec in rr:
                        emit(rec, cm)
                        n_rec += 1
            if manifest is not None:
                manifest.mark_done(rng_)
            reads_done += n_chunk
            _mark_chunk_done(reads_done)
            if args.v >= 3:
                sys.stderr.write(f"[mem] processed {n_reads} reads\n")

        with ThreadPoolExecutor(max_workers=depth) as ex:
            futs: deque = deque()
            submitted = 0
            for chunk in chunks:
                start = n_reads
                n_reads += len(chunk)
                rng_ = None
                if manifest is not None:
                    rng_ = ReadRange(0, start, start + len(chunk))
                    if manifest.is_done(rng_):
                        continue
                futs.append((rng_,
                             [r.comment for r in chunk] if args.C
                             else None, len(chunk),
                             ex.submit(run_chunk, submitted, chunk)))
                submitted += 1
                while len(futs) >= depth:
                    flush_one(futs)
            while futs:
                flush_one(futs)
    else:
        backend_fn = make_extend_backend(opt, args.backend)
        for chunk in chunks:
            start = n_reads
            n_reads += len(chunk)
            if manifest is not None:
                rr = ReadRange(0, start, start + len(chunk))
                if manifest.is_done(rr):
                    continue
            if backend_fn is None:
                all_recs = [
                    A.align_read(opt, ref, fm, r.name,
                                 r.seq.astype(np.int64), r.qual)
                    for r in chunk]
            else:
                all_recs = align_batch(
                    opt, ref, fm,
                    [r.seq.astype(np.int64) for r in chunk], backend_fn,
                    names=[r.name for r in chunk],
                    quals=[r.qual for r in chunk], po=po,
                    device_cigar=args.device_cigar)
            for gi, rr_ in enumerate(all_recs):
                cms = (chunk[gi].comment, None) if args.C else None
                for rec in rr_:
                    emit(rec, cms)
                    n_rec += 1
            if manifest is not None:
                manifest.mark_done(rr)
            _mark_chunk_done(n_reads)
            if args.v >= 3:
                sys.stderr.write(f"[mem] processed {n_reads} reads\n")
    t_end = _time.time()
    t_align = t_end - t_align0
    if args.v >= 1:
        sys.stderr.write(
            f"[mem] wrote {n_rec} records for {n_reads} reads\n")
        # machine-readable align-loop rates (startup excluded) — parsed
        # by bench/multihost.py for honest scaling aggregation.  The
        # steady rate starts at the FIRST chunk's completion (the jit
        # compiles land there); runs of one chunk have no steady window
        # and report the whole-loop rate.
        rate = n_reads / t_align if t_align > 0 else 0.0
        sr, sn = rate, n_reads
        # guard against degenerate windows: with in-flight pipelining a
        # short run's chunks land in one burst right after the compile,
        # so a steady figure needs >=3 post-warmup chunks and >=1s
        if _steady[0] is not None and n_reads > _steady[1] \
                and _steady[2] >= 4 and t_end - _steady[0] >= 1.0:
            sn = n_reads - _steady[1]
            sr = sn / (t_end - _steady[0])
        sys.stderr.write(
            f"[mem] align: {n_reads} reads in {t_align:.3f}s = "
            f"{rate:.1f} reads/s (steady {sr:.1f} reads/s over last "
            f"{sn} reads)\n")
    if tracer is not None:
        import json as _json

        sys.stderr.write(
            "[mem] counters: " + _json.dumps(tracer.counters.as_dict())
            + "\n")
        tracer.close()
    return 0


def cmd_merge(args) -> int:
    import tempfile

    from bwamem_tpu.parallel.multihost import merge_sam_files

    if args.out == "-":
        with tempfile.NamedTemporaryFile("r", suffix=".sam",
                                         delete=False) as tf:
            tmp = tf.name
        n = merge_sam_files(args.shards, tmp)
        with open(tmp) as f:
            for line in f:
                sys.stdout.write(line)
        os.unlink(tmp)
    else:
        n = merge_sam_files(args.shards, args.out)
    sys.stderr.write(f"[merge] {n} records from {len(args.shards)} "
                     f"shard(s)\n")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bwamem_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ix = sub.add_parser("index", help="build the FM-index")
    ix.add_argument("fasta")
    ix.add_argument("--sa-intv", type=int, default=8)
    ix.set_defaults(fn=cmd_index)

    mem = sub.add_parser("mem", help="align reads")
    mem.add_argument("fasta")
    mem.add_argument("reads")
    mem.add_argument("mates", nargs="?", default=None)
    mem.add_argument("-t", type=int, default=1,
                     help="host threads (native pipeline stages)")
    mem.add_argument("--host", default="auto",
                     choices=["auto", "native", "python"],
                     help="host pipeline implementation")
    mem.add_argument("-b", type=int, default=512, help="batch size")
    mem.add_argument("-k", type=int, default=19, help="min seed length")
    mem.add_argument("-w", type=int, default=100, help="band width")
    mem.add_argument("-d", type=int, default=100,
                     help="off-diagonal X-dropoff (Z-dropoff)")
    mem.add_argument("-r", type=float, default=1.5,
                     help="re-seed trigger: internal seeds inside a "
                          "seed longer than k*FLOAT")
    mem.add_argument("-c", type=int, default=500,
                     help="skip seeds with more than INT occurrences")
    mem.add_argument("-S", action="store_true", help="skip mate rescue")
    mem.add_argument("-P", action="store_true",
                     help="skip pairing; mate rescue performed unless "
                          "-S also in use")
    mem.add_argument("-A", type=int, default=1,
                     help="score for a sequence match")
    mem.add_argument("-B", type=int, default=4,
                     help="penalty for a mismatch")
    mem.add_argument("-O", type=int, default=6, help="gap open penalty")
    mem.add_argument("-E", type=int, default=1,
                     help="gap extension penalty; a gap of size k costs "
                          "O + k*E")
    mem.add_argument("-L", type=int, default=5,
                     help="penalty for 5'- and 3'-end clipping")
    mem.add_argument("-U", type=int, default=17,
                     help="penalty for an unpaired read pair")
    mem.add_argument("-I", default=None, metavar="FLOAT[,...]",
                     help="specify the mean, standard deviation (10%%"
                          " of the mean if absent), max (4 sigma from "
                          "the mean if absent) and min of the insert "
                          "size distribution; skips pestat inference")
    mem.add_argument("-p", action="store_true",
                     help="first query file consists of interleaved "
                          "paired-end sequences")
    mem.add_argument("-T", type=int, default=30, help="min output score")
    mem.add_argument("-M", action="store_true",
                     help="mark shorter split hits as secondary")
    mem.add_argument("-a", action="store_true",
                     help="output all alignments")
    mem.add_argument("-C", action="store_true",
                     help="append FASTA/FASTQ comment to SAM output")
    mem.add_argument("-v", type=int, default=3, help="verbose level")
    mem.add_argument("-R", default=None, help="read group header line")
    mem.add_argument("--backend", default="scalar",
                     choices=["scalar", "jax", "device"],
                     help="extension backend (ASE/Direct analogue): "
                          "scalar = host only; jax = the plain XLA twin "
                          "on the JAX device; device = the platform's "
                          "step, on a GPU the CUDA extension kernel, "
                          "on the CPU the plain XLA step")
    mem.add_argument("--trace", default=None, metavar="OUT.jsonl",
                     help="per-batch device trace (transaction.tsv "
                          "analogue) + counters summary")
    mem.add_argument("--resume", default=None, metavar="MANIFEST.jsonl",
                     help="checkpoint manifest: completed chunks are "
                          "skipped, finished chunks appended")
    mem.add_argument("--inflight", type=int, default=3,
                     help="chunks in flight (pipeline depth): chunk "
                          "n+1's host work overlaps chunk n's device "
                          "calls")
    mem.add_argument("--ship-ref", action="store_true",
                     help="ship target windows from the host instead "
                          "of gathering from the device-resident "
                          "reference")
    mem.add_argument("--bucket-split", action="store_true",
                     help="dispatch each fused chunk as two shape "
                          "buckets (cuts qmax/tmax padding at the "
                          "cost of a second device call)")
    mem.add_argument("--device-cigar", action="store_true",
                     help="run reg2aln global realignment (CIGAR "
                          "traceback) on device too (SE paths, python "
                          "or native host; ops/global_jax)")
    mem.add_argument("--device-rescue", action="store_true",
                     help="run mem_matesw mate-rescue local SW batched "
                          "on device (native PE path; ops/local_jax)")
    mem.add_argument("--device-seed", action="store_true",
                     help="run SMEM seeding + SA lookups on device "
                          "(ops/smem_jax; for CPU-starved hosts; "
                          "references < 2^31 two-strand symbols)")
    mem.add_argument("--shard", default=None, metavar="K/N",
                     help="multi-host scale-out: align only the strided "
                          "shard K of N (reads K, K+N, K+2N, ...); one "
                          "process per shard, then `merge` the SAMs. "
                          "Derived from the JAX distributed runtime "
                          "when JAX_COORDINATOR is set and --shard "
                          "is not")
    mem.set_defaults(fn=cmd_mem)

    mg = sub.add_parser(
        "merge", help="merge per-shard SAM files back into input order "
                      "(byte-identical to a single-process run)")
    mg.add_argument("out", help="output SAM path ('-' = stdout)")
    mg.add_argument("shards", nargs="+",
                    help="per-shard SAM files, in shard-id order")
    mg.set_defaults(fn=cmd_merge)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
