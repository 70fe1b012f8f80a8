"""Table-SHARDED device seeding (ops/smem_sharded.py): the occ/SA
tables split by block range over an 8-device mesh, FM coordinates wide
(two int32 words) — seeds must be byte-identical (values AND order) to
the replicated single-device seeder's, which is itself pinned to the
C++ host engine (tests/test_device_seed.py).  Also pins the >2^31
routing with a small table logically placed at a 2^32-row block
origin — GRCh38-scale addressing without gigabytes of test data.

Runs in a subprocess so the 8-device virtual CPU platform is
configured before any backend initialization (same harness as
tests/test_dist.py)."""

import os
import subprocess
import sys

_SCRIPT = r"""
import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
assert len(jax.devices()) == 8, jax.devices()

from bwamem_tpu.config import MemOptions
from bwamem_tpu.index.build import build_index
from bwamem_tpu.index.occ_packed import pack_occ, rank4, sa_value_batch
from bwamem_tpu.ops.smem_jax import make_device_seeder
from bwamem_tpu.ops.smem_sharded import (
    ShardedSeedTables, join64, make_sharded_rank4,
    make_table_sharded_seeder, split64)
from bwamem_tpu.parallel.dist import make_mesh, make_sharded_device_seeder
from bwamem_tpu.pipeline.align import revcomp_read

rng = np.random.default_rng(1234)
pac = rng.integers(0, 4, 60000).astype(np.uint8)
pac[40000:40900] = pac[1000:1900]     # a repeat: split re-seed rounds
fm = build_index(pac)
po = pack_occ(fm)
mesh = make_mesh()

# 0) wide split/join round-trips across the int32 boundary
v = np.array([0, 1, (1 << 30) - 1, 1 << 30, (1 << 31) + 7,
              (1 << 35) + 12345], np.int64)
assert np.array_equal(join64(*split64(v)), v)

# 1) sharded rank4 == host rank4 (psum-routed gathers)
tabs = ShardedSeedTables(po, fm.ssa, fm.sa_intv, 8)
r4 = make_sharded_rank4(mesh, tabs)
rows = rng.integers(0, po.n_rows + 1, 999).astype(np.int64)
want = rank4(po, rows)
np.testing.assert_array_equal(r4(rows), want)
print("rank4 sharded ok")

# 2) >2^31 routing: same table logically placed at block origin 2^26
#    (row offset 2^32) — wide block math must route to the same shards
origin = 1 << 26
tabs2 = ShardedSeedTables(po, fm.ssa, fm.sa_intv, 8, blk_origin=origin)
r4o = make_sharded_rank4(mesh, tabs2)
np.testing.assert_array_equal(r4o(rows + (origin << 6)), want)
print("rank4 @ >2^31 origin ok")

# 3) full seeder parity vs the single-device (replicated) seeder:
#    values AND order, through SMEM splits and SA walks
opt = MemOptions()
reads = []
for i in range(24):
    pos = int(rng.integers(0, fm.l_pac - 105))
    if i < 6:                       # reads on the repeat: low-occ splits
        pos = 40000 + int(rng.integers(0, 800))
    r = fm.pac[pos:pos + 100].astype(np.int64).copy()
    for _ in range(int(rng.integers(0, 5))):
        r[int(rng.integers(0, 100))] = int(rng.integers(0, 5))
    if rng.random() < 0.4:
        r = revcomp_read(r)
    reads.append(r)
want_rows = make_device_seeder(po, fm, opt)(reads)
got_rows = make_table_sharded_seeder(mesh, po, fm, opt)(reads)
np.testing.assert_array_equal(got_rows, want_rows)
assert len(want_rows) > 0
print(f"seeder parity ok ({len(want_rows)} seed rows)")

# 4) the dist entry point routes to the table-sharded path when forced
#    (and automatically at n_rows >= 2^31, untestable at test scale)
got2 = make_sharded_device_seeder(mesh, po, fm, opt,
                                  table_sharded=True)(reads)
np.testing.assert_array_equal(got2, want_rows)
print("dist routing ok")

# 5) constructor guards: non-power-of-two sa_intv fails loudly
try:
    ShardedSeedTables(po, fm.ssa, 24, 8)
except ValueError:
    pass
else:
    raise AssertionError("expected ValueError for sa_intv=24")

# 6) FORCING the reads-sharded regime on a >=2^31 index fails loudly
#    (the removed construction-time ValueError, re-established after
#    the round-5 code review) — int32 coordinates must never truncate
import dataclasses
big_po = dataclasses.replace(po, n_rows=(1 << 31) + 7)
try:
    make_sharded_device_seeder(mesh, big_po, fm, opt,
                               table_sharded=False)
except ValueError as e:
    assert "2^31" in str(e), e
else:
    raise AssertionError("expected ValueError forcing reads-sharded "
                         "on a >=2^31 index")
print("ALL OK")
"""


def test_table_sharded_seeder_8dev_cpu_mesh():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.pathsep.join(sys.path)
    r = subprocess.run([sys.executable, "-c", _SCRIPT], env=env,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    assert "ALL OK" in r.stdout


def test_wide_arithmetic_boundaries():
    """Host-side checks of the (hi, lo) int32 pair algebra at carry
    boundaries — pure numpy, no mesh needed.  Every device expression
    in ops/smem_sharded.py reduces to these primitives."""
    import numpy as np

    from bwamem_tpu.ops.smem_sharded import (
        HALF, join64, split64, wadd, waddw, weq, wle, wlt)

    rng = np.random.default_rng(77)
    vals = np.concatenate([
        np.array([0, 1, HALF - 1, HALF, HALF + 1, 2 * HALF - 1,
                  (1 << 35) + 123, (1 << 36) - 1], np.int64),
        rng.integers(0, 1 << 36, 64),
    ])
    deltas = np.concatenate([
        np.array([0, 1, -1, HALF - 1, -(HALF - 1), (1 << 31) - 1,
                  -(1 << 31) + 1], np.int64),
        rng.integers(-(1 << 31) + 1, 1 << 31, 64),
    ]).astype(np.int64)
    h, l = split64(vals)
    assert np.array_equal(join64(h, l), vals)
    assert l.min() >= 0 and l.max() < HALF
    # wadd: any int32 delta, result exact where it stays nonnegative
    for d in deltas:
        keep = vals + d >= 0
        rh, rl = wadd(h, l, np.int64(d))
        got = join64(rh, rl)[keep]
        assert np.array_equal(got, (vals + d)[keep]), d
        assert rl[keep].min(initial=0) >= 0
        assert rl[keep].max(initial=0) < HALF
    # waddw: pairwise sums of in-range pairs
    h2, l2 = split64(vals[::-1].copy())
    sh, sl = waddw(h, l, h2, l2)
    assert np.array_equal(join64(sh, sl), vals + vals[::-1])
    # comparisons agree with int64 semantics
    a = rng.integers(0, 1 << 36, 256)
    b = rng.integers(0, 1 << 36, 256)
    b[:64] = a[:64]  # force equality cases
    ah, al = split64(a)
    bh, bl = split64(b)
    assert np.array_equal(wlt(ah, al, bh, bl), a < b)
    assert np.array_equal(wle(ah, al, bh, bl), a <= b)
    assert np.array_equal(weq(ah, al, bh, bl), a == b)


def test_wide_n_before_no_int32_wrap():
    """Round-5 code-review finding #1: the ambiguous-symbol LF step's
    n_before must not sum the four rank counts in int32 (jnp.sum stays
    int32 and wraps once the total approaches the row index — i.e. at
    any row >= 2^31, exactly the regime this module exists for).  Pin
    the component-wise wide subtraction against int64 arithmetic at
    GRCh38-magnitude counts."""
    import numpy as np

    from bwamem_tpu.ops.smem_sharded import (
        join64, split64, wide_n_before)

    rng = np.random.default_rng(5)
    # rows up to 2^36; counts summing to ~r (the real FM invariant)
    r = rng.integers(1 << 31, 1 << 36, 128)
    parts = rng.random((128, 4))
    parts /= parts.sum(axis=1, keepdims=True)
    rk4 = np.minimum((parts * (r[:, None] - 8)).astype(np.int64),
                     (1 << 31) - 1).astype(np.int64)
    # clamp keeps each count < 2^31 (pack_occ's invariant); recompute
    # a consistent "ambiguous symbol" remainder
    before_primary = rng.integers(0, 2, 128)
    want = r - rk4.sum(axis=1) - before_primary
    rh, rl = split64(r)
    nh, nl = wide_n_before(rh, rl, rk4.astype(np.int32),
                           before_primary.astype(np.int32), np)
    got = join64(nh, nl)
    assert np.array_equal(got, want)
    # and the int32-sum formulation really does wrap at these scales
    # (the bug being pinned): guard that the test is non-trivial
    assert (rk4.sum(axis=1) >= (1 << 31)).any()
