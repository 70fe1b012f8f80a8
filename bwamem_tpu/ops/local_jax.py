"""Batched local Smith-Waterman (bwa's ksw_align) on device.

The mate-rescue compute (mem_matesw: align the unplaced mate against
the insert-size window around its anchor — ops/local_ref.py is the
scalar twin, csrc/kswlocal.cpp the host production path).  This is the
device twin: all rescue tasks of a chunk in one jitted call.

Vector-first structure (same recipe as ops/global_jax):
  * one ``lax.scan`` over target rows, whole query axis vectorized.
    The local-SW F recurrence F(j+1) = max(F(j)-e_ins, H(j)-oe_ins, 0)
    looks serial because H(j) = max(Hdiag(j), F(j)), but
    max(Hdiag,F)-oe_ins ≤ max(F-e_ins, Hdiag-oe_ins) given oe ≥ e, so
    F opens from the *pre-F* Hdiag and the row collapses to a running
    prefix max (``lax.cummax``) — no serial dependency.
  * best/end tracking in-scan with bwa's exact tie-breaking (first row
    with the strictly-greater score; leftmost column within the row);
    per-row best scores stream out for the KSW_XSUBO second-best.
  * start coordinates by the standard reversed-prefix second pass —
    the reversed prefixes (per-task lengths qe/te) are built with one
    vectorized gather, then the same fill runs once more.

Returns exactly ops/local_ref.ksw_align's (score, qb, qe, tb, te,
score2) per task (fuzz-pinned by tests/test_local_jax.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("qmax", "tmax"))
def _fill(query, qlen, target, tlen, mat, pens, *, qmax, tmax):
    """Forward local fill.  Returns (best, bi, bj, row_best) with
    best = max cell score (0 floor), (bi, bj) its 0-based (target,
    query) cell with bwa tie-breaking, row_best (tmax, B)."""
    B = query.shape[0]
    o_del, e_del, o_ins, e_ins = pens[0], pens[1], pens[2], pens[3]
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    jidx = jnp.arange(qmax, dtype=jnp.int32)[None, :]
    qprof = mat.astype(jnp.int32)[:, query]            # (5, B, qmax)
    qmask = jidx < qlen[:, None]

    H0 = jnp.zeros((B, qmax + 1), jnp.int32)
    E0 = jnp.zeros((B, qmax + 1), jnp.int32)
    NEGB = jnp.int32(-(1 << 28))

    def row(carry, t_sym):
        H, E, i, best, bi, bj = carry
        live = (i < tlen)                              # (B,)
        sub = jnp.sum(
            jnp.stack([(t_sym == c)[:, None] * qprof[c] for c in range(5)],
                      0), 0)
        M = H[:, :qmax] + sub
        Hd = jnp.maximum(jnp.maximum(M, E[:, 1:]), 0)
        Hd = jnp.where(qmask, Hd, 0)                   # cols past qlen dead
        # F(j) = max(0, max_{j'<j} Hd(j') - oe_ins - e_ins*(j-j'-1))
        A = jnp.where(qmask, Hd + e_ins * jidx, NEGB)
        S = jax.lax.cummax(A, axis=1)
        F = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32),
             jnp.maximum(S[:, :-1] - oe_ins - e_ins * jidx[:, :-1], 0)],
            axis=1)[:, :qmax]
        h = jnp.where(qmask, jnp.maximum(Hd, F), 0)
        newH = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), h], axis=1)
        newE = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32),
             jnp.maximum(jnp.maximum(E[:, 1:] - e_del, h - oe_del), 0)],
            axis=1)
        H = jnp.where(live[:, None], newH, H)
        E = jnp.where(live[:, None], newE, E)
        rb = jnp.max(jnp.where(live[:, None], h, 0), axis=1)
        upd = live & (rb > best)                       # strict >: first row
        best = jnp.where(upd, rb, best)
        bi = jnp.where(upd, i, bi)
        bj = jnp.where(upd, jnp.argmax(h, axis=1).astype(jnp.int32), bj)
        return (H, E, i + 1, best, bi, bj), rb

    (_, _, _, best, bi, bj), row_best = jax.lax.scan(
        row, (H0, E0, jnp.int32(0), jnp.zeros(B, jnp.int32),
              jnp.full(B, -1, jnp.int32), jnp.full(B, -1, jnp.int32)),
        target.T)
    return best, bi, bj, row_best


@functools.partial(jax.jit, static_argnames=("qmax", "tmax"))
def _align6(query, qlen, target, tlen, mat, pens, *, qmax, tmax):
    """Whole ksw_align under ONE jit: forward fill, reversed-prefix
    second fill for start coordinates, KSW_XSUBO second best.  Returns
    (6, B) int32 rows [score, qb, qe, tb, te, score2]; lanes with
    qlen == 0 (padding) come back all-zero scores."""
    best, bi, bj, row_best = _fill(query, qlen, target, tlen, mat, pens,
                                   qmax=qmax, tmax=tmax)
    qe = bj + 1
    te = bi + 1
    qrev = _reverse_prefix(query, qe)
    trev = _reverse_prefix(target, te)
    _, ti2, qj2, _ = _fill(qrev, qe, trev, te, mat, pens,
                           qmax=qmax, tmax=tmax)
    qb = qe - (qj2 + 1)
    tb = te - (ti2 + 1)
    iidx = jnp.arange(tmax, dtype=jnp.int32)[:, None]
    half = jnp.maximum(qlen // 2, 1)
    m = (jnp.abs(iidx - bi[None, :]) >= half[None, :]) & (
        iidx < tlen[None, :])
    score2 = jnp.max(jnp.where(m, row_best, 0), axis=0)
    return jnp.stack([best, qb, qe, tb, te, score2]).astype(jnp.int32)


def make_rescue_backend():
    """Raw-array device backend for NativePipeline's mem_matesw wave
    protocol (mp_rescue_* in csrc/mempipe.cpp): takes the wave's padded
    int8 (Bp, lq) mate sequences, (Bp, lt) reference windows and
    (2, Bp) int32 lengths plus the four gap penalties, returns (6, Bp)
    int32 [score, qb, qe, tb, te, score2] — the same rows
    local_ref.ksw_align computes per task.  Shapes are bucketed by the
    caller so the set of compiled programs stays tiny; the penalties
    travel as traced arguments (zero recompiles across MemOptions)."""

    def fn(seq_i8, rseq_i8, lens, mat, o_del, e_del, o_ins, e_ins):
        B, qmax = seq_i8.shape
        tmax = rseq_i8.shape[1]
        pens = jnp.asarray(
            np.array([o_del, e_del, o_ins, e_ins], np.int32))
        out = _align6(jnp.asarray(seq_i8), jnp.asarray(lens[0]),
                      jnp.asarray(rseq_i8), jnp.asarray(lens[1]),
                      jnp.asarray(np.asarray(mat, np.int32)), pens,
                      qmax=qmax, tmax=tmax)
        return np.asarray(out, np.int32)

    return fn


@jax.jit
def _reverse_prefix(seq, end):
    """seq (B, L) -> rev (B, L) with rev[b, j] = seq[b, end[b]-1-j] for
    j < end[b], pad 4 elsewhere."""
    L = seq.shape[1]
    j = jnp.arange(L, dtype=jnp.int32)[None, :]
    src = jnp.clip(end[:, None] - 1 - j, 0, L - 1)
    out = jnp.take_along_axis(seq, src, axis=1)
    return jnp.where(j < end[:, None], out, 4)


def ksw_align_batch(tasks, mat, o_del, e_del, o_ins, e_ins,
                    ) -> list[tuple[int, int, int, int, int, int]]:
    """Batched drop-in for per-task local_ref.ksw_align: tasks is a
    list of (query codes, target codes); returns (score, qb, qe, tb,
    te, score2) per task, identical to the scalar twin."""
    from bwamem_tpu.ops.global_jax import _pow2
    from bwamem_tpu.ops.local_ref import ksw_align

    out: list = [None] * len(tasks)
    idx, qs, ts = [], [], []
    for i, (q, t) in enumerate(tasks):
        if len(q) == 0 or len(t) == 0:
            out[i] = (0, -1, -1, -1, -1, 0)
        else:
            idx.append(i)
            qs.append(np.asarray(q, np.int32))
            ts.append(np.asarray(t, np.int32))
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
    matd = jnp.asarray(np.asarray(mat, np.int32))
    pens = jnp.asarray(np.array([o_del, e_del, o_ins, e_ins], np.int32))
    out6 = np.asarray(_align6(
        jnp.asarray(qa), jnp.asarray(qlen), jnp.asarray(ta),
        jnp.asarray(tlen), matd, pens, qmax=qmax, tmax=tmax))
    best, qb, qe, tb, te, score2 = out6
    for b, i in enumerate(idx):
        if best[b] <= 0:
            out[i] = (0, -1, -1, -1, -1, 0)
        else:
            out[i] = (int(best[b]), int(qb[b]), int(qe[b]), int(tb[b]),
                      int(te[b]), int(score2[b]))
    return out
