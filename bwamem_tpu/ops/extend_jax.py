"""Batched, vectorized banded seed extension — the pure-JAX twin.

Semantics are bit-identical to `extend_ref.ksw_extend_core` (bwa-0.7.8
`ksw_extend2`, i.e. the algorithm of /root/reference/sw_pe_array_sw_extend.v
— see SURVEY.md §2.5), but restructured for SIMD hardware:

  * a batch of B tasks is processed together (the analogue of the FPGA's
    20 MIMD processing elements, sw_pe_array.v:1133-1511, except we batch
    thousands),
  * the row loop over target positions stays sequential (as in the
    hardware), but **all query columns of a row are computed in parallel**:
    M and E depend only on the previous row, and the serial F recurrence
        F(i,j+1) = max(F(i,j) - e_ins, max(M(i,j) - o_ins - e_ins, 0))
    is solved with an associative prefix-max over P[k] = G[k] + e_ins*k
    (a (max,+) linear recurrence), replacing the FPGA's one-cell-per-cycle
    pipeline (sw_extend.v:144-148) with a one-ROW-per-step vector pipeline.

All state is int32. Shapes are static: query padded to QMAX columns,
target length only bounds the (dynamic) while_loop trip count.

The per-row scalar control of the reference — adaptive band clamp,
zero-run band trimming, row-max==0 break, gscore/max_ie tracking, zdrop —
becomes per-task vectors of beg/end/done flags with masked updates.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

NEG = -(1 << 29)  # a Python int: importing touches no device


class ExtendParams(NamedTuple):
    """Per-batch scoring parameters (the analogue of the reference batch
    header words 0-1, SURVEY.md §2.3: gap penalties, clip penalties, band
    width are per-batch; the matrix rides along as a flat (m*m,) array)."""

    mat_flat: jax.Array  # (m*m,) int32 substitution matrix, row = target sym
    m: int               # alphabet size (5)
    o_del: int
    e_del: int
    o_ins: int
    e_ins: int
    zdrop: int           # 0 disables (reference-FPGA behaviour)


class ExtendState(NamedTuple):
    i: jax.Array        # scalar row index
    eh_h: jax.Array     # (B, QMAX+1) H-diagonal storage (eh[j].h)
    eh_e: jax.Array     # (B, QMAX+1) E storage (eh[j].e)
    beg: jax.Array      # (B,)
    end: jax.Array      # (B,)
    done: jax.Array     # (B,) bool
    best: jax.Array     # (B,) running max score
    max_i: jax.Array    # (B,)
    max_j: jax.Array    # (B,)
    max_ie: jax.Array   # (B,)
    gscore: jax.Array   # (B,)
    max_off: jax.Array  # (B,)


class ExtendOut(NamedTuple):
    score: jax.Array
    qle: jax.Array
    tle: jax.Array
    gtle: jax.Array
    gscore: jax.Array
    max_off: jax.Array
    w_used: jax.Array


def _row_step(state: ExtendState, query, qlen, target, tlen, aw, h0,
              p: ExtendParams, jidx, jidx_e) -> ExtendState:
    """One target row i for every task in the batch (masked)."""
    i = state.i
    B, QP1 = state.eh_h.shape
    QMAX = QP1 - 1
    oe_del = p.o_del + p.e_del
    oe_ins = p.o_ins + p.e_ins

    active = (~state.done) & (i < tlen)

    # --- adaptive band clamp (sw_extend.v:1894-1895, 1777-1778) ---
    beg = jnp.maximum(state.beg, i - aw)
    end = jnp.minimum(jnp.minimum(state.end, i + aw + 1), qlen)

    # first column H(i, beg-1): only non-zero when beg == 0
    h1_first = jnp.where(
        beg == 0,
        jnp.maximum(h0 - (p.o_del + p.e_del * (i + 1)), 0),
        0,
    )

    # --- the vectorized column loop ---
    t_sym = jnp.take_along_axis(
        target, jnp.clip(i, 0, target.shape[1] - 1)[None].repeat(B)[:, None],
        axis=1)[:, 0]                                   # (B,)
    s = jnp.take(p.mat_flat, t_sym[:, None] * p.m + query, mode="clip")  # (B,QMAX)

    in_band = (jidx >= beg[:, None]) & (jidx < end[:, None])             # (B,QMAX)

    Mdiag = state.eh_h[:, :QMAX]              # eh[j].h = H(i-1, j-1)
    E = state.eh_e[:, :QMAX]                  # eh[j].e = E(i, j)
    M = jnp.where(Mdiag != 0, Mdiag + s, 0)   # the M/H split zero guard
    M = jnp.where(in_band, M, 0)
    E_b = jnp.where(in_band, E, 0)

    # F prefix-scan: F[j] = max(0, max_{k<j}(G[k] + e_ins*k) - e_ins*(j-1))
    G = jnp.maximum(M - oe_ins, 0)
    Pk = jnp.where(in_band, G + p.e_ins * jidx, NEG)
    S = jax.lax.cummax(Pk, axis=1)
    Sm1 = jnp.concatenate([jnp.full((B, 1), NEG), S[:, :-1]], axis=1)
    F = jnp.maximum(Sm1 - p.e_ins * (jidx - 1), 0)
    F = jnp.where(jidx == beg[:, None], 0, F)

    H = jnp.maximum(jnp.maximum(M, E_b), F)
    H = jnp.where(in_band, H, 0)

    # row max and its LAST attaining column (C: mj = m > h ? mj : j)
    row_max = jnp.max(jnp.where(in_band, H, 0), axis=1)
    is_max = in_band & (H == row_max[:, None])
    mj = jnp.max(jnp.where(is_max, jidx, -1), axis=1)

    # h1 after the loop = H(i, end-1) (or the first-column value if empty)
    h1_last = jnp.take_along_axis(
        H, jnp.clip(end - 1, 0, QMAX - 1)[:, None], axis=1)[:, 0]
    h1_last = jnp.where(end > beg, h1_last, h1_first)

    # --- eh writeback: eh[j].h <- H(i, j-1) for j in [beg, end],
    #     eh[beg].h <- h1_first, eh[end].e <- 0; outside [beg,end] UNTOUCHED
    #     (stale values are part of the bwa semantics) ---
    Hsh = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), H], axis=1)  # (B,QP1)
    Hsh = jnp.where(jidx_e == beg[:, None], h1_first[:, None], Hsh)
    wb_h = (jidx_e >= beg[:, None]) & (jidx_e <= end[:, None])
    new_eh_h = jnp.where(wb_h & active[:, None], Hsh, state.eh_h)

    Enew = jnp.maximum(E_b - p.e_del, jnp.maximum(M - oe_del, 0))
    Enew_p = jnp.concatenate([Enew, jnp.zeros((B, 1), jnp.int32)], axis=1)
    Enew_p = jnp.where(jidx_e == end[:, None], 0, Enew_p)
    wb_e = (jidx_e >= beg[:, None]) & (jidx_e <= end[:, None])
    new_eh_e = jnp.where(wb_e & active[:, None], Enew_p, state.eh_e)

    # --- gscore / max_ie at the query boundary (ties pick the later row) ---
    at_qend = active & (end == qlen)
    upd_ie = at_qend & ~(state.gscore > h1_last)
    max_ie = jnp.where(upd_ie, i, state.max_ie)
    gscore = jnp.where(at_qend, jnp.maximum(state.gscore, h1_last), state.gscore)

    # --- row-max == 0 break (sw_extend.v:1942) ---
    break_zero = active & (row_max == 0)

    # --- best-score update (strict >) + max_off ---
    improved = active & (row_max > state.best)
    best = jnp.where(improved, row_max, state.best)
    max_i = jnp.where(improved, i, state.max_i)
    max_j = jnp.where(improved, mj, state.max_j)
    off = jnp.abs(mj - i)
    max_off = jnp.where(improved, jnp.maximum(state.max_off, off), state.max_off)

    # --- zdrop break (bwa-0.7.8; pass zdrop=0 for exact FPGA behaviour);
    #     zdrop may be a traced scalar, so the test is masked, not skipped ---
    di = i - state.max_i
    dj = mj - state.max_j
    pen = jnp.where(di > dj, (di - dj) * p.e_del, (dj - di) * p.e_ins)
    break_z = active & ~break_zero & ~improved & (p.zdrop > 0) & (
        state.best - row_max - pen > p.zdrop)

    done = state.done | break_zero | break_z | (i + 1 >= tlen)

    # --- zero-run band trimming on the UPDATED eh (C scans after writeback) ---
    nz = (new_eh_h != 0) | (new_eh_e != 0)
    fwd = (jidx_e >= beg[:, None]) & (jidx_e < end[:, None]) & nz
    first_nz = jnp.min(jnp.where(fwd, jidx_e, jnp.int32(1 << 29)), axis=1)
    new_beg = jnp.minimum(first_nz, end)
    bwd = (jidx_e >= beg[:, None]) & (jidx_e <= end[:, None]) & nz
    last_nz = jnp.max(jnp.where(bwd, jidx_e, beg[:, None] - 1), axis=1)
    new_end = jnp.minimum(last_nz + 2, qlen)

    sel = lambda a, b: jnp.where(active, a, b)
    return ExtendState(
        i=i + 1,
        eh_h=new_eh_h,
        eh_e=new_eh_e,
        beg=sel(new_beg, state.beg),
        end=sel(new_end, state.end),
        done=done,
        best=best,
        max_i=max_i,
        max_j=max_j,
        max_ie=max_ie,
        gscore=gscore,
        max_off=max_off,
    )


def extend_batch_core(query, qlen, target, tlen, aw, h0,
                      params: ExtendParams) -> ExtendOut:
    """One banded extension pass at per-task band width `aw` (no doubling).

    query:  (B, QMAX) int32 base codes, padded arbitrarily past qlen
    target: (B, TMAX) int32 base codes
    qlen, tlen, aw, h0: (B,) int32.  Tasks with qlen<=0, tlen<=0 or h0<=0
    are no-ops that return (h0, 0, 0, 0, -1, 0) — used for batch padding.
    """
    B, QMAX = query.shape
    QP1 = QMAX + 1
    jidx = jax.lax.broadcasted_iota(jnp.int32, (B, QMAX), 1)
    jidx_e = jax.lax.broadcasted_iota(jnp.int32, (B, QP1), 1)
    oe_ins = params.o_ins + params.e_ins

    # first virtual row: eh[0].h = h0; eh[j].h = max(h0-oe_ins-(j-1)*e_ins, 0)
    # for 1 <= j <= qlen (closed form of the C while-loop); 0 beyond.
    h0c = h0[:, None]
    init_h = jnp.where(
        jidx_e == 0, h0c,
        jnp.where(jidx_e <= qlen[:, None],
                  jnp.maximum(h0c - oe_ins - (jidx_e - 1) * params.e_ins, 0),
                  0))
    init_e = jnp.zeros((B, QP1), jnp.int32)

    valid = (qlen > 0) & (tlen > 0) & (h0 > 0)
    state = ExtendState(
        i=jnp.int32(0),
        eh_h=init_h.astype(jnp.int32),
        eh_e=init_e,
        beg=jnp.zeros((B,), jnp.int32),
        end=qlen.astype(jnp.int32),
        done=~valid,
        best=h0.astype(jnp.int32),
        max_i=jnp.full((B,), -1, jnp.int32),
        max_j=jnp.full((B,), -1, jnp.int32),
        max_ie=jnp.full((B,), -1, jnp.int32),
        gscore=jnp.full((B,), -1, jnp.int32),
        max_off=jnp.zeros((B,), jnp.int32),
    )

    tmax = jnp.max(jnp.where(valid, tlen, 0))
    step = functools.partial(
        _row_step, query=query.astype(jnp.int32), qlen=qlen.astype(jnp.int32),
        target=target.astype(jnp.int32), tlen=tlen.astype(jnp.int32),
        aw=aw.astype(jnp.int32), h0=h0.astype(jnp.int32),
        p=params, jidx=jidx, jidx_e=jidx_e)

    state = jax.lax.while_loop(
        lambda s: (s.i < tmax) & ~jnp.all(s.done),
        lambda s: step(s),
        state,
    )
    return ExtendOut(
        score=state.best,
        qle=state.max_j + 1,
        tle=state.max_i + 1,
        gtle=state.max_ie + 1,
        gscore=state.gscore,
        max_off=state.max_off,
        w_used=aw.astype(jnp.int32),
    )


def extend_batch(query, qlen, target, tlen, w, h0, max_ins, max_del,
                 params: ExtendParams, prev_score=None,
                 max_band_try: int = 2) -> ExtendOut:
    """Full extension with the inline band-doubling retry (select-based).

    Reproduces the FPGA's internal k<2 doubling loop
    (sw_extend.v:1765, 1963, 1878): pass k runs at
    aw_k = min(w << k, max_ins, max_del); a task keeps its pass-k result
    once `score == prev || max_off < (aw>>1)+(aw>>2)` (bwa convergence).
    `prev_score` is the caller's previous score (bwa: a->score, -1 on the
    left extension, sc0 on the right).
    """
    if prev_score is None:
        prev_score = jnp.full_like(h0, -1)
    out = None
    converged = None
    prev = prev_score
    for k in range(max_band_try):
        awk = jnp.minimum(jnp.minimum(w << k, max_ins), max_del)
        o = extend_batch_core(query, qlen, target, tlen, awk, h0, params)
        o = o._replace(w_used=awk)
        if out is None:
            out = o
            converged = (o.score == prev) | (o.max_off < ((awk >> 1) + (awk >> 2)))
        else:
            keep = converged
            out = ExtendOut(*[jnp.where(keep, a, b) for a, b in zip(out, o)])
            converged = keep | (o.score == prev) | (
                o.max_off < ((awk >> 1) + (awk >> 2)))
        prev = out.score
    return out
