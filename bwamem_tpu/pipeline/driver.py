"""Batched device extension driver — the batch_manager of this build.

The reference streams fixed-capacity task batches into 4 PE arrays
behind double buffers (batch_manager.v:397-562; SURVEY.md §2.1).  Here,
the host walks every read's chains, PLANS all extension tasks, runs two
device phases (all left extensions, then all right extensions — a seed's
right h0 is its own left score, so there is no cross-seed dependency),
and then replays bwa's sequential mem_chain2aln control flow against the
precomputed result table.  Extension results are bit-identical to the
scalar path (the kernels are fuzz-verified twins), so align_batch
produces the same SAM as align.align_read with the scalar extender.

The contained-seed skip (mem_chain2aln's "has this been extended
before" test) depends on earlier seeds' extension results, so the
device path speculatively extends EVERY seed — wasted lanes are cheap,
serialized host<->device round trips are not.  Band doubling runs as
pass k=0 for all tasks plus pass k=1 consumed only where pass 0 did not
converge (the FPGA runs the same retry internally, sw_extend.v:1765).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from bwamem_tpu.config import MemOptions
from bwamem_tpu.io.fasta import Reference
from bwamem_tpu.io.sam import SamRecord
from bwamem_tpu.pipeline import align as A
from bwamem_tpu.pipeline.chain import chain_read
from bwamem_tpu.pipeline.tasks import round_up
from bwamem_tpu.ops.extend_ref import ExtendResult


def _plan_read(opt: MemOptions, ref: Reference, read: np.ndarray, chains):
    """Enumerate (key, query, target, h0|None, pen_clip) for every
    extension side, mirroring chain2aln's geometry exactly."""
    plans = []
    l_query = len(read)
    for ci, c in enumerate(chains):
        seeds = c.seeds
        rmax0, rmax1 = ref.l_pac << 1, 0
        for t in seeds:
            b = t.rbeg - (t.qbeg + A.cal_max_gap(opt, t.qbeg))
            e = (t.rbeg + t.len + (l_query - t.qbeg - t.len)
                 + A.cal_max_gap(opt, l_query - t.qbeg - t.len))
            rmax0 = min(rmax0, b)
            rmax1 = max(rmax1, e)
        rmax0 = max(rmax0, 0)
        rmax1 = min(rmax1, ref.l_pac << 1)
        if rmax0 < ref.l_pac < rmax1:
            if seeds[0].rbeg < ref.l_pac:
                rmax1 = ref.l_pac
            else:
                rmax0 = ref.l_pac
        lo, hi = ref.contig_window(seeds[0].rbeg)
        rmax0 = max(rmax0, lo)
        rmax1 = min(rmax1, hi)
        rseq = ref.get_seq(rmax0, rmax1)
        for si, s in enumerate(seeds):
            if s.qbeg > 0:
                plans.append(((ci, si, "L"),
                              read[:s.qbeg][::-1],
                              rseq[:s.rbeg - rmax0][::-1],
                              s.len * opt.a, opt.pen_clip5))
            if s.qbeg + s.len != l_query:
                plans.append(((ci, si, "R"),
                              read[s.qbeg + s.len:],
                              rseq[s.rbeg + s.len - rmax0:],
                              None, opt.pen_clip3))
    return plans


def _bucket(n: int, buckets=(128, 160, 192, 256, 320, 384, 512, 640,
                             768, 1024, 1536, 2048, 3072, 4096)) -> int:
    """Smallest standard size >= n.  Fixed shape buckets keep the set of
    compiled programs tiny — with per-batch exact shapes every batch
    recompiles; with buckets the compile happens once and lives in the
    persistent cache.

    The sequence-axis buckets are finer than powers of two (multiples
    of 32): the plain XLA step computes every padded column of every
    row, so e.g. 150 bp reads in a 256 bucket would waste 40% of the
    row work — the 160 bucket recovers it.  Typical short-read chunks
    see qmax 160/192 and tmax 320/384, so the hot compile set stays
    small."""
    for b in buckets:
        if n <= b:
            return b
    return round_up(n, buckets[-1])


def _run_pass(opt, jobs, extend_batch_fn, k):
    """One kernel pass at attempted width opt.w<<k over a job list.
    Returns list of ExtendResult aligned with jobs.

    Tasks are sorted by target length before packing so each kernel
    block's row bound is tight (the bucketing lesson from SURVEY.md §7:
    the FPGA tolerates task-length divergence with MIMD PEs; we sort
    instead)."""
    import jax.numpy as jnp

    B = len(jobs)
    order = sorted(range(B), key=lambda i: -len(jobs[i][2]))
    qmax = _bucket(max(max((len(j[1]) for j in jobs), default=1), 1))
    tmax = _bucket(max(max((len(j[2]) for j in jobs), default=1), 1))
    # power-of-two batch buckets: job counts jitter chunk-to-chunk and
    # every unseen shape is a compile
    Bp = _bucket(max(B, 512), (512, 1024, 2048, 4096, 8192, 16384))
    query = np.zeros((Bp, qmax), np.int32)
    target = np.zeros((Bp, tmax), np.int32)
    qlen = np.zeros(Bp, np.int32)
    tlen = np.zeros(Bp, np.int32)
    h0 = np.zeros(Bp, np.int32)
    max_ins = np.ones(Bp, np.int32)
    max_del = np.ones(Bp, np.int32)
    for slot, i in enumerate(order):
        key, q, t, h, pen = jobs[i]
        query[slot, :len(q)] = q
        target[slot, :len(t)] = t
        qlen[slot], tlen[slot], h0[slot] = len(q), len(t), h
        max_ins[slot] = A._max_gap_bound(opt, len(q), opt.o_ins,
                                         opt.e_ins, pen)
        max_del[slot] = A._max_gap_bound(opt, len(q), opt.o_del,
                                         opt.e_del, pen)
    aw = np.minimum(np.minimum(opt.w << k, max_ins),
                    max_del).astype(np.int32)
    res = extend_batch_fn(
        jnp.asarray(query), jnp.asarray(qlen), jnp.asarray(target),
        jnp.asarray(tlen), jnp.asarray(aw), jnp.asarray(h0))
    arr = {f: np.asarray(getattr(res, f)) for f in
           ("score", "qle", "tle", "gtle", "gscore", "max_off")}
    out: list[ExtendResult | None] = [None] * B
    for slot, i in enumerate(order):
        out[i] = ExtendResult(
            score=int(arr["score"][slot]), qle=int(arr["qle"][slot]),
            tle=int(arr["tle"][slot]), gtle=int(arr["gtle"][slot]),
            gscore=int(arr["gscore"][slot]),
            max_off=int(arr["max_off"][slot]), w_used=int(aw[slot]))
    return out


def _device_extend(opt: MemOptions, jobs, extend_batch_fn):
    """Batch one list of (key, query, target, h0, pen_clip) through the
    device kernel: pass k=0 for everything, then pass k=1 COMPACTED to
    the tasks whose pass-0 result did not converge (the FPGA re-runs
    internally, sw_extend.v:1963; we re-batch — most tasks converge, so
    the retry batch is a small fraction).
    Returns {key: {attempted_w: ExtendResult}}."""
    if not jobs:
        return {}
    out = {}
    res0 = _run_pass(opt, jobs, extend_batch_fn, 0)
    aw0 = opt.w
    retry = []
    for j, r0 in zip(jobs, res0):
        out[j[0]] = {aw0: r0}
        # a task needs pass 1 iff the bwa convergence test can fail for
        # it under ANY caller prev_score: score==prev may still hold, so
        # retry when the max_off test alone does not prove convergence
        if not (r0.max_off < (aw0 >> 1) + (aw0 >> 2)):
            retry.append(j)
    if retry:
        res1 = _run_pass(opt, retry, extend_batch_fn, 1)
        for j, r1 in zip(retry, res1):
            out[j[0]][opt.w << 1] = r1
    # converged tasks reuse their pass-0 result as the "pass 1" entry
    # (never consulted by _resolve, but keeps the table total)
    for j, r0 in zip(jobs, res0):
        out[j[0]].setdefault(opt.w << 1, r0)
    return out


def _resolve(opt: MemOptions, per_w, prev_score):
    """Replay the band-doubling convergence on precomputed pass results."""
    prev = prev_score
    res = None
    for k in (0, 1):
        aw = opt.w << k
        res = per_w[aw]
        if res.score == prev or res.max_off < (aw >> 1) + (aw >> 2):
            break
        prev = res.score
    return res


def extension_tables(opt: MemOptions, ref: Reference, reads, all_chains,
                     extend_batch_fn: Callable):
    """Plan + two batched device phases for a list of reads; returns
    per-read result tables consumed by the chain2aln replay."""
    all_plans = [_plan_read(opt, ref, r, ch)
                 for r, ch in zip(reads, all_chains)]

    # phase L
    left_jobs = [((ri,) + key, q, t, h, pen)
                 for ri, plans in enumerate(all_plans)
                 for key, q, t, h, pen in plans if key[2] == "L"]
    table = _device_extend(opt, left_jobs, extend_batch_fn)

    # phase R: h0 chained from the resolved left score of the same seed
    right_jobs = []
    for ri, plans in enumerate(all_plans):
        for key, q, t, h, pen in plans:
            if key[2] != "R":
                continue
            ci, si, _ = key
            s = all_chains[ri][ci].seeds[si]
            if s.qbeg > 0:
                sc0 = _resolve(opt, table[(ri, ci, si, "L")], -1).score
            else:
                sc0 = s.len * opt.a
            right_jobs.append(((ri,) + key, q, t, sc0, pen))
    table.update(_device_extend(opt, right_jobs, extend_batch_fn))
    tables = [dict() for _ in reads]
    for k, v in table.items():
        tables[k[0]][k[1:]] = v
    return tables


def table_extend_fn(local):
    def extend_fn(key, query, target, w_attempt, h0, max_ins, max_del, o):
        return local[key][w_attempt]
    return extend_fn


def align_batch(opt: MemOptions, ref: Reference, fm, reads,
                extend_batch_fn: Callable, names=None, quals=None,
                po=None, device_cigar: bool = False
                ) -> list[list[SamRecord]]:
    """Align a batch of reads with device-batched extension.

    extend_batch_fn(query, qlen, target, tlen, aw, h0) -> ExtendOut —
    typically ops.extend_step.make_pass_backend(params) (or the
    extend_jax twin).  `po` (index.occ_packed.pack_occ) switches
    seeding to the native/batched path — identical output.

    `device_cigar` runs the reg2aln global realignments (CIGAR
    traceback included) as batched device rounds too
    (ops/global_jax), so extension AND traceback leave the host;
    output is identical either way (tests/test_global_jax.py).
    """
    names = names or [f"read{i}" for i in range(len(reads))]
    quals = quals or [None] * len(reads)
    if po is not None:
        from bwamem_tpu.pipeline.chain import chain_reads_batch

        all_chains = chain_reads_batch(fm, po, reads, opt)
    else:
        all_chains = [chain_read(fm, r, opt) for r in reads]
    tables = extension_tables(opt, ref, reads, all_chains, extend_batch_fn)
    all_regions = [None] * len(reads)
    gtabs = [None] * len(reads)
    if device_cigar:
        from bwamem_tpu.ops.global_jax import ksw_global_batch

        for ri, (read, chains) in enumerate(zip(reads, all_chains)):
            r = A.compute_regions(opt, ref, fm, read,
                                  table_extend_fn(tables[ri]), chains)
            all_regions[ri] = A.mark_primary(opt, r)
        gall = A.batched_global_results(
            opt, ref, reads, all_regions,
            lambda tasks: ksw_global_batch(tasks, opt.mat, opt.o_del,
                                           opt.e_del, opt.o_ins,
                                           opt.e_ins))
        gtabs = [dict() for _ in reads]
        for (ri, ki), v in gall.items():
            gtabs[ri][ki] = v
    out = []
    for ri, (read, chains) in enumerate(zip(reads, all_chains)):
        out.append(A.align_read(opt, ref, fm, names[ri], read, quals[ri],
                                extend_fn=table_extend_fn(tables[ri]),
                                chains=chains, regions=all_regions[ri],
                                global_results=gtabs[ri]))
    return out
