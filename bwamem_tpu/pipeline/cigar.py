"""Banded global alignment with traceback (bwa's ksw_global2) + CIGAR/NM/MD.

The reference FPGA is score-only — bwa runs this second, traceback pass
on the CPU to produce CIGARs (SURVEY.md §7 "hard parts": replicate that
split).  We keep it host-side (numpy) in the scalar twin; a traceback-
emitting kernel variant is a later optimization.

Semantics (ksw.c ksw_global2):
  * global DP over the full query x target with band |i*D - j| style
    clamp: column range for target row i is [i - w_r, i + w_l] adjusted
    for length difference,
  * affine gaps with separate insertion (query-gap) / deletion
    (target-gap) penalties,
  * traceback preferring M, then D (deletion, gap in query), then I,
    recorded per-cell in 3 bits (direction + E/F continuation bits).

CIGAR ops: 0=M, 1=I (insertion to ref = extra query), 2=D, 3=S (soft
clip), 4=H (bwa codes: MIDSH).
"""

from __future__ import annotations

import numpy as np

M_OP, I_OP, D_OP, S_OP, H_OP = 0, 1, 2, 3, 4
OP_CHARS = "MIDSH"
NEG_INF = -(1 << 28)


def ksw_global(query: np.ndarray, target: np.ndarray, mat: np.ndarray,
               o_del: int, e_del: int, o_ins: int, e_ins: int, w: int,
               *, use_native: bool = True,
               ) -> tuple[int, list[tuple[int, int]]]:
    """Banded global alignment. Returns (score, cigar as [(op, len), ...]).

    Faithful to ksw.c ksw_global2 including cell ordering, tie-breaking
    (M preferred over E over F; gap-open preferred over gap-extend on
    ties) and the 6-bit traceback encoding — these determine CIGAR
    identity with bwa.  0-based i over target rows, j over query cols.

    Wide bands dispatch to a row-vectorized fill (identical output; in
    ksw_global the E/F recurrences open from M — the diagonal value —
    so a row has no serial dependency once F is expressed as a running
    prefix max)."""
    qlen, tlen = len(query), len(target)
    if qlen > 0 and tlen > 0:
        if use_native:
            from bwamem_tpu.native import ksw_global_native

            got = ksw_global_native(query, target, mat, o_del, e_del,
                                    o_ins, e_ins, w)
            if got is not None:
                return got
        band = min(2 * max(w, abs(tlen - qlen)) + 1, qlen)
        if tlen * band >= 4096:
            return _ksw_global_rows(query, target, mat, o_del, e_del,
                                    o_ins, e_ins, w)
    if qlen == 0:
        return (-(o_del + e_del * tlen) if tlen else 0,
                [(D_OP, tlen)] if tlen else [])
    if tlen == 0:
        return -(o_ins + e_ins * qlen), [(I_OP, qlen)]
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    # the caller guarantees w >= |tlen - qlen| (bwa_gen_cigar2 / infer_bw)
    w = max(w, abs(tlen - qlen))

    eh_h = np.full(qlen + 1, NEG_INF, np.int64)
    eh_e = np.full(qlen + 1, NEG_INF, np.int64)
    # z[i][j]: bits[1:0] H direction (0=M,1=E,2=F); bit2 E-continue;
    # bit5 F-continue (the d |= 1<<2 / 2<<4 encoding of ksw.c)
    z = np.zeros((tlen, qlen + 1), np.uint8)
    eh_h[0] = 0
    for j in range(1, qlen + 1):
        if j > w:
            break
        eh_h[j] = -(o_ins + e_ins * j)
    for i in range(tlen):
        t_sym = target[i]
        beg = max(i - w, 0)
        end = min(i + w + 1, qlen)
        h1 = -(o_del + e_del * (i + 1)) if beg == 0 else NEG_INF
        f = NEG_INF
        zrow = z[i]
        for j in range(beg, end):
            # eh[j] = { H(i-1,j-1), E(i,j) }; f = F(i,j); h1 = H(i,j-1)
            m = eh_h[j]
            e = eh_e[j]
            eh_h[j] = h1
            m += mat[t_sym, query[j]]
            d = 0 if m >= e else 1
            h = m if m >= e else e
            d = d if h >= f else 2
            h = h if h >= f else f
            h1 = h
            t = m - oe_del
            e -= e_del
            d |= (1 << 2) if e > t else 0
            e = e if e > t else t
            eh_e[j] = e
            t = m - oe_ins
            f -= e_ins
            d |= (2 << 4) if f > t else 0
            f = f if f > t else t
            zrow[j] = d
        eh_h[end] = h1
        eh_e[end] = NEG_INF
    score = int(eh_h[qlen])
    # traceback (ksw.c: which = z >> (which<<1) & 3)
    cigar: list[tuple[int, int]] = []
    i, k = tlen - 1, qlen - 1
    which = 0
    while i >= 0 and k >= 0:
        which = (int(z[i][k]) >> (which << 1)) & 3
        if which == 0:
            _push(cigar, M_OP, 1)
            i -= 1
            k -= 1
        elif which == 1:
            _push(cigar, D_OP, 1)
            i -= 1
        else:
            _push(cigar, I_OP, 1)
            k -= 1
    if i >= 0:
        _push(cigar, D_OP, i + 1)
    if k >= 0:
        _push(cigar, I_OP, k + 1)
    cigar.reverse()
    return score, cigar


def _ksw_global_rows(query, target, mat, o_del, e_del, o_ins, e_ins, w):
    """Row-vectorized ksw_global2 fill + the shared traceback."""
    qlen, tlen = len(query), len(target)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    w = max(w, abs(tlen - qlen))
    eh_h = np.full(qlen + 1, NEG_INF, np.int64)
    eh_e = np.full(qlen + 1, NEG_INF, np.int64)
    eh_h[0] = 0
    jinit = np.arange(1, min(qlen, w) + 1)
    eh_h[jinit] = -(o_ins + e_ins * jinit)
    z = np.zeros((tlen, qlen + 1), np.uint8)
    for i in range(tlen):
        beg = max(i - w, 0)
        end = min(i + w + 1, qlen)
        h1_first = -(o_del + e_del * (i + 1)) if beg == 0 else NEG_INF
        jj = np.arange(beg, end)
        m = eh_h[beg:end] + mat[target[i], query[beg:end]].astype(np.int64)
        e = eh_e[beg:end]
        d = (m < e).astype(np.uint8)          # H direction: 0=M, 1=E
        hme = np.maximum(m, e)
        # F(j+1) = max(F(j) - e_ins, M(j) - oe_ins): prefix max over M
        A = m + e_ins * jj
        S = np.maximum.accumulate(A)
        f = np.empty_like(m)
        f[0] = NEG_INF
        if len(jj) > 1:
            f[1:] = S[:-1] - oe_ins - e_ins * (jj[1:] - 1)
        d = np.where(f > hme, np.uint8(2), d)
        h = np.maximum(hme, f)
        # E' and continuation bits (strict >, gap-open wins ties)
        d |= np.where(e - e_del > m - oe_del, 0x04, 0).astype(np.uint8)
        eh_e[beg:end] = np.maximum(e - e_del, m - oe_del)
        d |= np.where(f - e_ins > m - oe_ins, 0x20, 0).astype(np.uint8)
        # writeback: eh_h[j] <- H(i, j-1), eh_h[end] <- H(i, end-1)
        eh_h[beg] = h1_first
        eh_h[beg + 1:end + 1] = h
        eh_e[end] = NEG_INF
        z[i, beg:end] = d
    score = int(eh_h[qlen])
    cigar: list[tuple[int, int]] = []
    i, k = tlen - 1, qlen - 1
    which = 0
    while i >= 0 and k >= 0:
        which = (int(z[i][k]) >> (which << 1)) & 3
        if which == 0:
            _push(cigar, M_OP, 1)
            i -= 1
            k -= 1
        elif which == 1:
            _push(cigar, D_OP, 1)
            i -= 1
        else:
            _push(cigar, I_OP, 1)
            k -= 1
    if i >= 0:
        _push(cigar, D_OP, i + 1)
    if k >= 0:
        _push(cigar, I_OP, k + 1)
    cigar.reverse()
    return score, cigar


def _push(cigar: list[tuple[int, int]], op: int, n: int) -> None:
    if cigar and cigar[-1][0] == op:
        cigar[-1] = (op, cigar[-1][1] + n)
    else:
        cigar.append((op, n))


def cigar_to_string(cigar: list[tuple[int, int]]) -> str:
    return "".join(f"{n}{OP_CHARS[op]}" for op, n in cigar) or "*"


def cigar_query_len(cigar) -> int:
    return sum(n for op, n in cigar if op in (M_OP, I_OP, S_OP))


def cigar_ref_len(cigar) -> int:
    return sum(n for op, n in cigar if op in (M_OP, D_OP))


def compute_nm_md(query: np.ndarray, rseq: np.ndarray, cigar, *,
                  use_native: bool = True) -> tuple[int, str]:
    """NM (edit distance) and MD tag from an alignment (bwa_gen_cigar2's
    on-the-fly computation). query/rseq are the aligned segments only."""
    if use_native:
        from bwamem_tpu.native import cigar_nm_md_native

        got = cigar_nm_md_native(query, rseq, cigar)
        if got is not None:
            return got
    nm = 0
    md = []
    qi = ri = 0
    match_run = 0
    for op, n in cigar:
        if op == M_OP:
            for _ in range(n):
                if (query[qi] > 3 or rseq[ri] > 3
                        or query[qi] != rseq[ri]):
                    md.append(str(match_run))
                    match_run = 0
                    md.append("ACGTN"[min(int(rseq[ri]), 4)])
                    nm += 1
                else:
                    match_run += 1
                qi += 1
                ri += 1
        elif op == I_OP:
            qi += n
            nm += n
        elif op == D_OP:
            md.append(str(match_run))
            match_run = 0
            md.append("^" + "".join("ACGTN"[min(int(c), 4)]
                                    for c in rseq[ri:ri + n]))
            ri += n
            nm += n
        elif op in (S_OP, H_OP):
            qi += n if op == S_OP else 0
    md.append(str(match_run))
    return nm, "".join(md)


def infer_bw(l1: int, l2: int, score: int, a: int, q: int, r: int) -> int:
    """bwa's infer_bw: minimum band width consistent with a score."""
    if l1 == l2 and l1 * a - score < (q + r - a) * 2:
        return 0
    w = int((min(l1, l2) * a - score - q) / r + 2.0)
    return max(w, abs(l1 - l2))
