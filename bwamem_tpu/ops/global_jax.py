"""Batched banded global alignment WITH traceback on device.

The reference FPGA is score-only: bwa runs ksw_global on the host CPU
afterwards to produce CIGARs (SURVEY.md §7 "hard parts").  This module
is the device-side variant of that second pass: a jitted batched
ksw_global2 twin (fill + traceback both under one jit) producing
byte-identical (score, CIGAR) to pipeline/cigar.ksw_global.

Design (vector-first, not a transliteration of ksw.c):
  * FILL — ``lax.scan`` over target rows.  Per row the whole query
    axis is computed vectorized: in ksw_global2 the E/F recurrences
    open from M (the diagonal), so a row has *no* serial dependency
    once F is expressed as a running prefix max (the same identity as
    cigar._ksw_global_rows, here ``lax.cummax``).  Per-task bands
    (beg/end per row per task) are lane masks; out-of-band state is
    simply left unchanged, which reproduces the scalar band-edge
    writes exactly.  The 6-bit ksw.c z-codes (H dir | E-cont | F-cont)
    stream out one uint8 row per step.
  * TRACEBACK — a second ``lax.scan`` of at most Qmax+Tmax steps walks
    all tasks in lockstep: one vectorized gather into the z-volume per
    step, ``which = (z >> (which<<1)) & 3`` exactly as ksw.c, emitting
    one step-op per task per step (3 = done).  The D/I tail after
    falling off either edge is folded into the same scan.
  * Host does only the run-length encoding of the emitted step-ops
    (vectorized numpy over the whole batch, no per-base Python).

Scoring parameters (mat, gap opens/extends) are traced *arguments*,
not compile-time constants — one compiled program serves any
MemOptions (the reference takes them per batch at runtime:
sw_pe_array_task_parse.v:1954-1955).

PRODUCTION DEFAULT: the C++ host path (csrc/kswglobal.cpp) computes
CIGARs off the device critical path and remains the default; this
variant exists for deployments where host CPU is the scarce resource
and for keeping the whole alignment resident on-chip (reg2aln
integration: pipeline/driver.py use_device_cigar).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bwamem_tpu.pipeline.cigar import D_OP, I_OP, M_OP, NEG_INF

NEG = np.int32(NEG_INF)


@functools.partial(jax.jit, static_argnames=("qmax", "tmax"))
def _global_batch(query, qlen, target, tlen, w, mat, pens, *, qmax, tmax):
    """Fill + traceback for a (B,) batch of global alignment tasks.

    query (B, qmax) int32 codes 0..4; target (B, tmax); qlen/tlen/w
    (B,) int32 (all tasks must have qlen >= 1 and tlen >= 1 — empty
    dims are host fast paths, cigar.ksw_global:58-62); mat (5, 5)
    int32; pens = [o_del, e_del, o_ins, e_ins] int32.

    Returns (score (B,), steps (smax, B) int32 step-ops in ksw `which`
    coding emitted back-to-front: 0=M 1=D 2=I 3=done).
    """
    B = query.shape[0]
    o_del, e_del, o_ins, e_ins = pens[0], pens[1], pens[2], pens[3]
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    w = jnp.maximum(w, jnp.abs(tlen - qlen))          # cigar.py:65
    jidx = jnp.arange(qmax, dtype=jnp.int32)[None, :]  # (1, qmax)
    bI = jnp.arange(B)

    # qprof[c, b, j] = mat[c, query[b, j]]
    qprof = mat.astype(jnp.int32)[:, query]            # (5, B, qmax)

    # init: eh_h[j] = -(o_ins + e_ins*j) for 1 <= j <= min(w, qlen),
    # eh_h[0] = 0, else NEG (cigar.py:72-76).  State is (B, qmax+1).
    j1 = jnp.arange(qmax + 1, dtype=jnp.int32)[None, :]
    eh_h0 = jnp.where(
        j1 <= jnp.minimum(w, qlen)[:, None],
        -(o_ins + e_ins * j1), NEG).astype(jnp.int32)
    eh_h0 = eh_h0.at[:, 0].set(0)
    eh_e0 = jnp.full((B, qmax + 1), NEG, jnp.int32)

    def fill_row(carry, t_sym):
        eh_h, eh_e, i = carry
        live = i < tlen                                # (B,)
        beg = jnp.maximum(i - w, 0)
        end = jnp.minimum(i + w + 1, qlen)             # exclusive
        inb = live[:, None] & (jidx >= beg[:, None]) & (jidx < end[:, None])

        sub = jnp.sum(
            jnp.stack([(t_sym == c)[:, None] * qprof[c] for c in range(5)],
                      0), 0)                           # (B, qmax)
        m = eh_h[:, :qmax] + sub
        e = eh_e[:, :qmax]
        d = (m < e).astype(jnp.int32)                  # H dir: 0=M, 1=E
        hme = jnp.maximum(m, e)
        # F(j) = max_{j'<j} (M(j') - oe_ins - e_ins*(j-j'-1)), fresh at
        # beg: out-of-band A = NEG keeps the cummax from leaking across
        # the band edge (cigar.py:152-158)
        A = jnp.where(inb, m + e_ins * jidx, NEG)
        S = jax.lax.cummax(A, axis=1)
        f = jnp.concatenate(
            [jnp.full((B, 1), NEG, jnp.int32),
             S[:, :-1] - oe_ins - e_ins * (jidx[:, :-1])], axis=1)
        d = jnp.where(f > hme, 2, d)
        h = jnp.maximum(hme, f)
        d = d | jnp.where(e - e_del > m - oe_del, 0x04, 0)
        new_e = jnp.maximum(e - e_del, m - oe_del)
        d = d | jnp.where(f - e_ins > m - oe_ins, 0x20, 0)
        zrow = jnp.where(inb, d, 0).astype(jnp.uint8)

        # writeback: eh_h[j+1] <- h[j] for j in band; eh_h[beg] <- left
        # edge; eh_e in band; eh_e[end] <- NEG (cigar.py:88,105-106)
        shif = jnp.concatenate(
            [jnp.full((B, 1), NEG, jnp.int32), h], axis=1)
        upd_h = live[:, None] & (j1 >= beg[:, None] + 1) & (j1 <= end[:, None])
        eh_h = jnp.where(upd_h, shif, eh_h)
        left = jnp.where(beg == 0, -(o_del + e_del * (i + 1)), NEG)
        eh_h = jnp.where(live[:, None] & (j1 == beg[:, None]),
                         left[:, None], eh_h)
        eh_e = jnp.where(
            live[:, None] & (j1 >= beg[:, None]) & (j1 < end[:, None]),
            jnp.pad(new_e, ((0, 0), (0, 1)), constant_values=NEG), eh_e)
        eh_e = jnp.where(live[:, None] & (j1 == end[:, None]), NEG, eh_e)
        return (eh_h, eh_e, i + 1), zrow

    (eh_h, _, _), z = jax.lax.scan(
        fill_row, (eh_h0, eh_e0, jnp.int32(0)), target.T)
    score = eh_h[bI, qlen]                             # H(tlen-1, qlen-1)

    # traceback: all tasks in lockstep, one gather per step
    z_flat = z.reshape(-1)                             # (tmax*B*qmax,)
    smax = qmax + tmax

    def tb_step(carry, _):
        i, k, which = carry
        both = (i >= 0) & (k >= 0)
        idx = (jnp.clip(i, 0) * B + bI) * qmax + jnp.clip(k, 0)
        zv = z_flat[idx].astype(jnp.int32)
        nxt = (zv >> (which << 1)) & 3
        op = jnp.where(both, nxt,
                       jnp.where(i >= 0, 1, jnp.where(k >= 0, 2, 3)))
        i = i - ((op == 0) | (op == 1)).astype(jnp.int32)
        k = k - ((op == 0) | (op == 2)).astype(jnp.int32)
        which = jnp.where(both, nxt, which)
        return (i, k, which), op.astype(jnp.int8)

    (_, _, _), steps = jax.lax.scan(
        tb_step, (tlen - 1, qlen - 1, jnp.zeros(B, jnp.int32)),
        None, length=smax)
    return score, steps


_WHICH2OP = np.array([M_OP, D_OP, I_OP, -1], np.int8)


def rle_cigars(steps: np.ndarray) -> list[list[tuple[int, int]]]:
    """(smax, B) device step-ops -> per-task CIGAR [(op, len), ...].

    Steps were emitted back-to-front; vectorized numpy RLE over the
    whole batch (one pass, no per-base Python)."""
    B = steps.shape[1]
    ops = _WHICH2OP[steps.T]                           # (B, smax), -1 done
    n = (ops >= 0).sum(1)                              # steps per task
    flat = ops[ops >= 0]                               # concat, task-major
    row = np.repeat(np.arange(B), n)
    if flat.size == 0:
        return [[] for _ in range(B)]
    brk = np.flatnonzero((flat[1:] != flat[:-1]) | (row[1:] != row[:-1]))
    starts = np.concatenate([[0], brk + 1])
    ends = np.concatenate([brk + 1, [flat.size]])
    runs = ends - starts
    run_op = flat[starts]
    run_row = row[starts]
    out: list[list[tuple[int, int]]] = [[] for _ in range(B)]
    for r, o, ln in zip(run_row.tolist(), run_op.tolist(), runs.tolist()):
        out[r].append((int(o), int(ln)))
    for c in out:
        c.reverse()                                    # back-to-front
    return out


def make_cigar_backend():
    """Raw-array device backend for NativePipeline's mp_cigar_* round
    protocol (csrc/mempipe.cpp): one round = padded int8 (Bp, lq)
    query segments, (Bp, lt) reference segments and (3, Bp) int32
    [qlen, tlen, band] rows in; (scores (Bp,) int32, counts (Bp,)
    int32, flat (op, len) int32 pairs task-major) out.  Fill +
    traceback run in ONE jit call; only the run-length encoding is
    host numpy.  Scoring params are traced arguments — zero recompiles
    across MemOptions."""

    def fn(q_i8, t_i8, meta, mat, o_del, e_del, o_ins, e_ins):
        B, qmax = q_i8.shape
        tmax = t_i8.shape[1]
        score, steps = _global_batch(
            jnp.asarray(q_i8), jnp.asarray(meta[0]), jnp.asarray(t_i8),
            jnp.asarray(meta[1]), jnp.asarray(meta[2]),
            jnp.asarray(np.asarray(mat, np.int32)),
            jnp.asarray(np.array([o_del, e_del, o_ins, e_ins],
                                 np.int32)),
            qmax=qmax, tmax=tmax)
        return pack_cigar_round(score, steps)

    return fn


def pack_cigar_round(score, steps):
    """(score, steps) device outputs -> the mp_cigar round triple
    (scores (Bp,) int32, counts (Bp,) int32, flat (op, len) int32
    pairs task-major).  Shared by the single-device and mesh-sharded
    cigar backends."""
    cigars = rle_cigars(np.asarray(steps))
    ncig = np.array([len(c) for c in cigars], np.int32)
    flat = np.fromiter(
        (x for c in cigars for p in c for x in p), np.int32,
        count=2 * int(ncig.sum()))
    return np.asarray(score, np.int32), ncig, flat


def _pow2(n: int, lo: int) -> int:
    v = lo
    while v < n:
        v <<= 1
    return v


def ksw_global_batch(tasks, mat, o_del, e_del, o_ins, e_ins,
                     ) -> list[tuple[int, list[tuple[int, int]]]]:
    """Batched drop-in for per-task cigar.ksw_global.

    tasks: list of (query codes, target codes, w).  Returns
    [(score, cigar), ...] — byte-identical to the scalar twin
    (tests/test_global_jax.py).  Empty-dim tasks take the host fast
    path (cigar.py:58-62); the rest run on device in one jit call,
    padded to power-of-two (qmax, tmax) shape buckets."""
    from bwamem_tpu.pipeline.cigar import ksw_global

    out: list = [None] * len(tasks)
    idx, qs, ts, ws = [], [], [], []
    for i, (q, t, w) in enumerate(tasks):
        if len(q) == 0 or len(t) == 0:
            out[i] = ksw_global(np.asarray(q), np.asarray(t), mat,
                                o_del, e_del, o_ins, e_ins, w,
                                use_native=False)
        else:
            idx.append(i)
            qs.append(np.asarray(q, np.int32))
            ts.append(np.asarray(t, np.int32))
            ws.append(int(w))
    if not idx:
        return out
    B = len(idx)
    qmax = _pow2(max(len(q) for q in qs), 16)
    tmax = _pow2(max(len(t) for t in ts), 16)
    qa = np.full((B, qmax), 4, np.int32)
    ta = np.full((B, tmax), 4, np.int32)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for b, (q, t) in enumerate(zip(qs, ts)):
        qa[b, :len(q)] = q
        ta[b, :len(t)] = t
        qlen[b], tlen[b] = len(q), len(t)
    score, steps = _global_batch(
        jnp.asarray(qa), jnp.asarray(qlen), jnp.asarray(ta),
        jnp.asarray(tlen), jnp.asarray(np.asarray(ws, np.int32)),
        jnp.asarray(np.asarray(mat, np.int32)),
        jnp.asarray(np.array([o_del, e_del, o_ins, e_ins], np.int32)),
        qmax=qmax, tmax=tmax)
    score = np.asarray(score)
    cigars = rle_cigars(np.asarray(steps))
    for b, i in enumerate(idx):
        out[i] = (int(score[b]), cigars[b])
    return out
