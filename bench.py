"""Kernel bench: the platform's fused extension step on one GPU.

  python bench.py [--bp 8192] [--qmax 256] [--tmax 512] [--gate 48]

Builds a seeded batch of fused extension lanes at a real chunk's shape
(left and right tasks per lane, ~1% substitutions, Ns, short indels, a
quarter of the lanes with a narrow band so the L1/R1 retries fire), then

1. gates the chosen step (ops/extend_step.step_for) against the scalar
   bwa-0.7.8 oracle `ksw_extend_core` on `--gate` lanes and against the
   plain XLA step on the whole batch.  Exact equality: the step is
   integer DP, no float product is involved;
2. times the chosen step and the plain XLA step (median of `--iters`
   calls, each ending in block_until_ready).

Every result line names the device; the bench fails when JAX finds no
GPU.  The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np


def fused_batch(rng, bp, qmax, tmax, w=100):
    """(ql, tl, qr, tr, scal) for `bp` fused lanes: (qmax, bp) / (tmax, bp)
    int8 sequences in the transposed layout and the (16, bp) scalar
    block (rows as in extend_step.fused_xla)."""
    seqs = [np.zeros((n, bp), np.int8) for n in (qmax, tmax, qmax, tmax)]
    scal = np.zeros((16, bp), np.int32)
    narrow = rng.random(bp) < 0.25
    lane_w = np.where(narrow, rng.integers(4, 17, bp), w)
    scal[3] = rng.integers(19, 61, bp)
    scal[9] = lane_w
    for side, (q_arr, t_arr, rows) in enumerate(
            ((seqs[0], seqs[1], (0, 1, 2, 4)),
             (seqs[2], seqs[3], (5, 6, 7, 8)))):
        for b in range(bp):
            ql = int(rng.integers(0 if side else 1, qmax + 1))
            q = rng.integers(0, 4, ql)
            t = q.copy()
            sub = rng.random(ql) < 0.01
            t[sub] = rng.integers(0, 4, int(sub.sum()))
            t[rng.random(ql) < 0.003] = 4
            if ql and rng.random() < (0.5 if narrow[b] else 0.1):
                p = int(rng.integers(0, ql))
                n = int(rng.integers(1, 13 if narrow[b] else 4))
                t = (np.delete(t, np.s_[p:p + n]) if rng.random() < 0.5
                     else np.insert(t, p, rng.integers(0, 4, n)))
            tail = rng.integers(0, 4, int(rng.integers(0, lane_w[b] + 1)))
            t = np.concatenate([t, tail])[:tmax]
            q_arr[:ql, b] = q
            t_arr[:len(t), b] = t
            gap = max(int((ql + 5 - 6) / 1 + 1.0), 1)   # bwa max_gap, -A1
            scal[rows[0], b] = ql
            scal[rows[1], b] = len(t)
            scal[rows[2], b] = min(lane_w[b], gap)
            scal[rows[3], b] = min(lane_w[b] << 1, gap)
    return (*seqs, scal)


def _lane_reference(args):
    """Expected [L0 | L1 | R0 | R1] groups of one lane from the scalar
    oracle (None where that pass does not run)."""
    from bwamem_tpu.config import MemOptions
    from bwamem_tpu.ops.extend_ref import ksw_extend_core

    ql, tl, qr, tr, s, prm = args
    mat = MemOptions(a=int(prm[0]), b=int(prm[1])).mat

    def core(q, t, aw, h0):
        r = ksw_extend_core(q, t, mat, *(int(x) for x in prm[2:6]),
                            w=int(aw), h0=int(h0), zdrop=int(prm[6]))
        return tuple(r[:6]) + (int(aw), 0)

    thr = (s[9] >> 1) + (s[9] >> 2)
    groups = [None] * 4
    score = s[3]
    for g, (q, t, qlen, tlen, aw0, aw1) in enumerate(
            ((ql, tl, s[0], s[1], s[2], s[4]),
             (qr, tr, s[5], s[6], s[7], s[8]))):
        if qlen == 0 or tlen == 0:
            continue
        q, t = q[:qlen], t[:tlen]
        groups[2 * g] = core(q, t, aw0, score)
        if groups[2 * g][5] < thr:
            score = groups[2 * g][0]
        else:
            groups[2 * g + 1] = core(q, t, aw1, score)
            score = groups[2 * g + 1][0]
    return groups


def gate(step_fn, batch, prm, n_lanes, rng):
    """Check `n_lanes` random lanes of step_fn's (32, B) output against
    the scalar oracle; returns (lanes checked, retry passes checked)."""
    ql, tl, qr, tr, scal = batch
    out = np.asarray(step_fn(ql, tl, qr, tr, scal, prm))
    lanes = rng.choice(scal.shape[1], n_lanes, replace=False)
    jobs = [(ql[:, b], tl[:, b], qr[:, b], tr[:, b], scal[:, b], prm)
            for b in lanes]
    # the oracle is numpy; keep the workers off the card (a JAX process
    # that touches the GPU reserves most of its memory)
    env_before = os.environ.get("JAX_PLATFORMS")
    os.environ["JAX_PLATFORMS"] = "cpu"
    try:
        with multiprocessing.get_context("spawn").Pool() as pool:
            want = pool.map(_lane_reference, jobs, chunksize=8)
    finally:
        if env_before is None:
            del os.environ["JAX_PLATFORMS"]
        else:
            os.environ["JAX_PLATFORMS"] = env_before
    n_retry = 0
    for b, groups in zip(lanes, want):
        for g, exp in enumerate(groups):
            if exp is None:
                continue
            n_retry += g in (1, 3)
            got = tuple(int(x) for x in out[8 * g:8 * g + 8, b])
            if got != exp:
                raise AssertionError(
                    f"lane {b} group {g}: step {got} != ksw_extend_core "
                    f"{exp}")
    return len(lanes), n_retry


def time_step(fn, args, iters):
    """Median seconds of `iters` calls, each fenced by block_until_ready
    (after one warm-up call that compiles)."""
    fn(*args).block_until_ready()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args).block_until_ready()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def card_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bp", type=int, default=8192, help="lanes")
    ap.add_argument("--qmax", type=int, default=256)
    ap.add_argument("--tmax", type=int, default=512)
    ap.add_argument("--gate", type=int, default=48,
                    help="lanes checked against ksw_extend_core")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    from bwamem_tpu.config import MemOptions
    from bwamem_tpu.ops import extend_step
    from bwamem_tpu.utils.jaxcfg import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"[bench] no GPU: JAX runs on {dev.platform}", file=sys.stderr)
        return 1
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    card = card_name_and_power()
    print(f"[bench] device {device}; card {card}")

    opt = MemOptions()
    prm = np.array([opt.a, opt.b, opt.o_del, opt.e_del, opt.o_ins,
                    opt.e_ins, opt.zdrop, 0], np.int32)
    rng = np.random.default_rng(args.seed)
    batch = fused_batch(rng, args.bp, args.qmax, args.tmax, opt.w)
    dev_batch = [jax.device_put(x) for x in batch]
    step = jax.jit(extend_step.step_for().fused)
    plain = jax.jit(extend_step.fused_xla)

    n, n_retry = gate(step, batch, prm, args.gate, rng)
    print(f"[gate] chosen step == ksw_extend_core on {n}/{n} lanes "
          f"({n_retry} L1/R1 retry passes among them); exact integer "
          f"equality, no float product involved (TF32 does not apply)")
    same = np.array_equal(np.asarray(step(*dev_batch, prm)),
                          np.asarray(plain(*dev_batch, prm)))
    if not same:
        raise AssertionError("chosen step != plain XLA step on the batch")
    print(f"[gate] chosen step == plain XLA step on all {args.bp} lanes")
    mem = step.lower(*dev_batch, prm).compile().memory_analysis()
    print(f"[gate] memory_analysis: {mem}")

    t_step = time_step(step, (*dev_batch, prm), args.iters)
    t_plain = time_step(plain, (*dev_batch, prm), args.iters)
    print(f"[time] {device['kind']} ({card}): chosen step "
          f"{t_step * 1e3:.3f} ms, plain XLA step {t_plain * 1e3:.3f} ms "
          f"per (bp={args.bp}, qmax={args.qmax}, tmax={args.tmax}) call")
    print(json.dumps({"bp": args.bp, "qmax": args.qmax, "tmax": args.tmax,
                      "step_ms": t_step * 1e3, "xla_ms": t_plain * 1e3,
                      "card": card, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
