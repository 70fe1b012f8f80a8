"""GPU extension kernel equivalence vs the scalar golden reference.

The CUDA kernel's lane arithmetic (csrc/banded_extend.h) runs here in its
host build (native.banded_fused_host), the ASE-style swappable backend of
SURVEY.md §4; on a GPU the same source compiles with nvcc
(tests/test_extend_step.py, `gpu` marker).
"""

import numpy as np
import pytest

from bwamem_tpu import native
from bwamem_tpu.config import MemOptions
from bwamem_tpu.ops import extend_step
from bwamem_tpu.ops.extend_jax import ExtendOut
from bwamem_tpu.ops.extend_ref import ksw_extend, ksw_extend_core

from test_extend_jax import make_params, random_batch, check_equal

OPT = MemOptions()
MAT = OPT.mat
QMAX = 128
TMAX = 128


def _out(rows):
    rows = np.asarray(rows)
    return ExtendOut(score=rows[0], qle=rows[1], tle=rows[2], gtle=rows[3],
                     gscore=rows[4], max_off=rows[5], w_used=rows[6])


def fused_lanes(query_l, target_l, scal, params):
    """The kernel's lane code on (B, Q) / (B, T) row-major left tasks,
    no right task."""
    empty = np.zeros((1, len(query_l)), np.int8)
    return native.banded_fused_host(
        np.asarray(query_l, np.int8).T, np.asarray(target_l, np.int8).T,
        empty, empty, scal, extend_step.params_vector(params))


def kernel_pass(query, qlen, target, tlen, aw, h0, params):
    """One plain pass of the kernel's lane code."""
    scal = np.zeros((8, len(qlen)), np.int32)
    for k, v in enumerate((qlen, tlen, aw, h0)):
        scal[k] = v
    scal16 = np.asarray(extend_step.pass_scal(scal))
    return _out(fused_lanes(query, target, scal16, params)[:8])


@pytest.mark.parametrize("seed,band", [(s, b) for s in range(3)
                                       for b in ("wide", "narrow", "mixed")])
def test_pallas_matches_ref(seed, band):
    rng = np.random.default_rng(seed * 31 + hash(band) % 97)
    B = 16
    query, qlen, target, tlen, h0 = random_batch(
        rng, B, qmax=QMAX - 8, tmax=TMAX - 8, qpad=QMAX, tpad=TMAX)
    if band == "wide":
        aw = np.full(B, 100, np.int32)
    elif band == "narrow":
        aw = np.full(B, 7, np.int32)
    else:
        aw = rng.integers(0, 101, B).astype(np.int32)
    out = kernel_pass(query, qlen, target, tlen, aw, h0, make_params())
    refs = [
        ksw_extend_core(query[b, :qlen[b]], target[b, :tlen[b]], MAT,
                        6, 1, 6, 1, w=int(aw[b]), h0=int(h0[b]))
        for b in range(B)
    ]
    check_equal(out, refs, aw)


def test_pallas_zdrop_matches_ref():
    rng = np.random.default_rng(77)
    B = 16
    query, qlen, target, tlen, h0 = random_batch(
        rng, B, qmax=QMAX - 8, tmax=TMAX - 8, qpad=QMAX, tpad=TMAX)
    aw = rng.integers(2, 60, B).astype(np.int32)
    out = kernel_pass(query, qlen, target, tlen, aw, h0, make_params(zdrop=20))
    refs = [
        ksw_extend_core(query[b, :qlen[b]], target[b, :tlen[b]], MAT,
                        6, 1, 6, 1, w=int(aw[b]), h0=int(h0[b]), zdrop=20)
        for b in range(B)
    ]
    check_equal(out, refs, aw)


def test_pallas_band_doubling():
    rng = np.random.default_rng(5)
    B = 8
    query, qlen, target, tlen, h0 = random_batch(
        rng, B, qmax=QMAX - 8, tmax=TMAX - 8, qpad=QMAX, tpad=TMAX)
    w = np.full(B, 5, np.int32)
    mx = int(MAT.max())
    max_ins = np.maximum((qlen * mx - 6) // 1 + 1, 1).astype(np.int32)
    max_del = max_ins.copy()
    # the fused kernel's left half is the k<2 doubling loop: L0 at
    # min(w, max_ins, max_del), L1 at min(2w, ...) unless L0 converged
    scal = np.zeros((16, B), np.int32)
    scal[0], scal[1], scal[3], scal[9] = qlen, tlen, h0, w
    scal[2] = np.minimum(w, np.minimum(max_ins, max_del))
    scal[4] = np.minimum(w << 1, np.minimum(max_ins, max_del))
    rows = fused_lanes(query, target, scal, make_params())
    conv = rows[5] < (w >> 1) + (w >> 2)
    out = _out(np.where(conv, rows[0:8], rows[8:16]))
    refs = [
        ksw_extend(query[b, :qlen[b]], target[b, :tlen[b]], MAT,
                   6, 1, 6, 1, w=5, h0=int(h0[b]),
                   max_ins=int(max_ins[b]), max_del=int(max_del[b]))
        for b in range(B)
    ]
    check_equal(out, refs, w, fields=("score", "qle", "tle", "gtle",
                                      "gscore", "max_off", "w_used"))


def test_pallas_padding_tasks():
    params = make_params()
    B = 8
    query = np.zeros((B, QMAX), np.int32)
    target = np.zeros((B, TMAX), np.int32)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    qlen[0], tlen[0] = 10, 10
    h0 = np.full(B, 5, np.int32)
    aw = np.full(B, 10, np.int32)
    out = kernel_pass(query, qlen, target, tlen, aw, h0, params)
    assert int(out.score[0]) == 15  # 10 matching zeros
    assert all(int(out.qle[b]) == 0 for b in range(1, B))


def test_pallas_full_width_query():
    """qlen == QMAX exactly (lane `end` doesn't exist) — regression for the
    h1_last/eh[end] edge."""
    rng = np.random.default_rng(3)
    B = 8
    query = rng.integers(0, 4, (B, QMAX)).astype(np.int32)
    target = np.zeros((B, TMAX), np.int32)
    target[:, :QMAX] = query
    target[:, QMAX:] = rng.integers(0, 4, (B, TMAX - QMAX))
    qlen = np.full(B, QMAX, np.int32)
    tlen = np.full(B, TMAX, np.int32)
    h0 = np.full(B, 19, np.int32)
    aw = np.full(B, 100, np.int32)
    out = kernel_pass(query, qlen, target, tlen, aw, h0, make_params())
    refs = [
        ksw_extend_core(query[b], target[b], MAT, 6, 1, 6, 1,
                        w=100, h0=19)
        for b in range(B)
    ]
    check_equal(out, refs, aw)


def test_pallas_reference_capacity_limits():
    """The reference hardware caps: qlen<=255/side, tlen<=2047/side
    (SURVEY.md §2.3).  The kernel must handle those extremes exactly."""
    QM, TM = 256, 2048
    rng = np.random.default_rng(9)
    B = 8
    query = rng.integers(0, 4, (B, QM)).astype(np.int32)
    target = np.zeros((B, TM), np.int32)
    target[:, :QM] = query       # query matches the target prefix
    target[:, QM:] = rng.integers(0, 4, (B, TM - QM))
    qlen = np.full(B, 255, np.int32)
    tlen = np.full(B, 2047, np.int32)
    h0 = np.full(B, 100, np.int32)
    aw = np.full(B, 100, np.int32)
    out = kernel_pass(query, qlen, target, tlen, aw, h0, make_params())
    refs = [ksw_extend_core(query[b, :255], target[b, :2047], MAT,
                            6, 1, 6, 1, w=100, h0=100) for b in range(B)]
    check_equal(out, refs, aw)


@pytest.mark.parametrize("pen", [(6, 1, 6, 1), (5, 2, 7, 3), (2, 1, 2, 1)])
def test_pallas_penalty_grid(pen):
    o_del, e_del, o_ins, e_ins = pen
    rng = np.random.default_rng(sum(pen))
    B = 8
    query, qlen, target, tlen, h0 = random_batch(
        rng, B, qmax=QMAX - 8, tmax=TMAX - 8, qpad=QMAX, tpad=TMAX)
    aw = rng.integers(1, 80, B).astype(np.int32)
    params = make_params(o_del, e_del, o_ins, e_ins)
    out = kernel_pass(query, qlen, target, tlen, aw, h0, params)
    refs = [ksw_extend_core(query[b, :qlen[b]], target[b, :tlen[b]], MAT,
                            o_del, e_del, o_ins, e_ins,
                            w=int(aw[b]), h0=int(h0[b])) for b in range(B)]
    check_equal(out, refs, aw)
