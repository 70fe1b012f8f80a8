"""Multi-device data parallelism: the production extension path sharded
over a mesh must produce byte-identical SAM to the single-device path.

Runs in a subprocess so the 8-device virtual CPU platform
(xla_force_host_platform_device_count) is configured before any
backend initialization — the in-process suite already owns a 1-device
CPU backend."""

import os
import subprocess
import sys

import pytest

from bwamem_tpu.pipeline import native_driver

pytestmark = pytest.mark.skipif(not native_driver.available(),
                                reason="native library unavailable")

_SCRIPT = r"""
import os, sys
import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
assert len(jax.devices()) == 8, jax.devices()

import jax.numpy as jnp
from bwamem_tpu.config import MemOptions
from bwamem_tpu.index.build import build_index
from bwamem_tpu.index.occ_packed import pack_occ
from bwamem_tpu.io.fasta import Contig, Reference
from bwamem_tpu.ops.extend_jax import ExtendParams
from bwamem_tpu.ops.extend_step import params_vector, step_for
from bwamem_tpu.parallel.dist import make_mesh, make_sharded_raw_t_backend
from bwamem_tpu.pipeline.align import revcomp_read
from bwamem_tpu.pipeline import native_driver

opt = MemOptions()
params = ExtendParams(
    mat_flat=jnp.asarray(opt.mat.astype(np.int32).ravel()), m=5,
    o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
    e_ins=opt.e_ins, zdrop=opt.zdrop)

mesh = make_mesh(jax.devices())

# 1) step-level: sharded == unsharded on a random batch
rng = np.random.default_rng(0)
Bp = 16 * 8 * 2
qmax, tmax = 32, 64
query_t = rng.integers(0, 4, (qmax, Bp)).astype(np.int32)
target_t = rng.integers(0, 4, (tmax, Bp)).astype(np.int32)
scal_t = np.zeros((8, Bp), np.int32)
scal_t[0] = rng.integers(5, qmax, Bp)
scal_t[1] = rng.integers(5, tmax, Bp)
scal_t[2] = 10
scal_t[3] = rng.integers(1, 40, Bp)
want = np.asarray(step_for().extend_pass(
    jnp.asarray(query_t), jnp.asarray(target_t), jnp.asarray(scal_t),
    params_vector(params)))
sharded = make_sharded_raw_t_backend(mesh, params)
got = sharded(query_t, target_t, scal_t)
assert np.array_equal(want, got), "kernel mismatch under shard_map"
print("kernel sharded == unsharded: ok")

# 2) end-to-end: full aligner through the sharded backend
pac = rng.integers(0, 4, 40000).astype(np.uint8)
ref = Reference(contigs=[Contig("c1", 0, 40000)], pac=pac)
fm = build_index(pac)
po = pack_occ(fm)
reads = []
for i in range(24):
    pos = int(rng.integers(0, 40000 - 130))
    r = pac[pos:pos + 120].astype(np.int64).copy()
    for _ in range(3):
        p = int(rng.integers(0, 120))
        r[p] = (r[p] + 1) % 4
    if i % 2:
        r = revcomp_read(r)
    reads.append(r)

single = native_driver.make_raw_t_backend(params)
pipe1 = native_driver.NativePipeline(opt, ref, fm, po)
want_sam = [[r.line() for r in rr]
            for rr in pipe1.align_chunk(reads, single)]
pipe8 = native_driver.NativePipeline(opt, ref, fm, po)
got_sam = [[r.line() for r in rr]
           for rr in pipe8.align_chunk(reads, sharded)]
assert want_sam == got_sam, "SAM mismatch under mesh sharding"
print("e2e sharded SAM == single-device SAM: ok")

# 3) the fused production protocol through the mesh
from bwamem_tpu.parallel.dist import make_sharded_fused_backend

sharded_fused = make_sharded_fused_backend(mesh, params)
pipe8f = native_driver.NativePipeline(opt, ref, fm, po)
got_fused = [[r.line() for r in rr]
             for rr in pipe8f.align_chunk(reads, sharded_fused)]
assert want_sam == got_fused, "SAM mismatch: sharded fused protocol"
print("e2e sharded fused SAM == single-device SAM: ok")

# 3b) the resident-reference fused protocol through the mesh (text
# and read matrix replicated, scalar block sharded on lanes)
from bwamem_tpu.parallel.dist import make_sharded_fused_idx_backend

sharded_idx = make_sharded_fused_idx_backend(mesh, params, ref.pac)
pipe8i = native_driver.NativePipeline(opt, ref, fm, po)
got_idx = [[r.line() for r in rr]
           for rr in pipe8i.align_chunk(reads, sharded_idx)]
assert want_sam == got_idx, "SAM mismatch: sharded fused_idx protocol"
print("e2e sharded fused_idx SAM == single-device SAM: ok")

# 4) device CIGAR (batched global align + traceback) through the mesh
from bwamem_tpu.ops.global_jax import _global_batch
from bwamem_tpu.parallel.dist import make_sharded_global_batch

B, gq, gt = 32, 32, 32
qa = rng.integers(0, 4, (B, gq)).astype(np.int32)
ta = rng.integers(0, 4, (B, gt)).astype(np.int32)
gql = rng.integers(5, gq + 1, B).astype(np.int32)
gtl = rng.integers(5, gt + 1, B).astype(np.int32)
gw = rng.integers(1, 12, B).astype(np.int32)
pens = np.array([opt.o_del, opt.e_del, opt.o_ins, opt.e_ins], np.int32)
mat = opt.mat.astype(np.int32)
ws, wst = _global_batch(jnp.asarray(qa), jnp.asarray(gql),
                        jnp.asarray(ta), jnp.asarray(gtl),
                        jnp.asarray(gw), jnp.asarray(mat),
                        jnp.asarray(pens), qmax=gq, tmax=gt)
gfn = make_sharded_global_batch(mesh, qmax=gq, tmax=gt)
gs, gst = gfn(qa, gql, ta, gtl, gw, mat, pens)
assert np.array_equal(np.asarray(ws), gs), "global score mismatch"
assert np.array_equal(np.asarray(wst), gst), "global traceback mismatch"
print("sharded device CIGAR == unsharded: ok")

# 5) device mate rescue (batched local SW) through the mesh
from bwamem_tpu.ops.local_jax import make_rescue_backend
from bwamem_tpu.parallel.dist import make_sharded_rescue_backend

Br, rq, rt = 32, 32, 96
rseq = rng.integers(0, 4, (Br, rq)).astype(np.int8)
rwin = rng.integers(0, 4, (Br, rt)).astype(np.int8)
rlens = np.zeros((2, Br), np.int32)
rlens[0] = rng.integers(5, rq + 1, Br)
rlens[1] = rng.integers(10, rt + 1, Br)
rfn1 = make_rescue_backend()
want_r = rfn1(rseq, rwin, rlens, mat, opt.o_del, opt.e_del,
              opt.o_ins, opt.e_ins)
rfn8 = make_sharded_rescue_backend(mesh)
got_r = rfn8(rseq, rwin, rlens, mat, opt.o_del, opt.e_del,
             opt.o_ins, opt.e_ins)
assert np.array_equal(np.asarray(want_r), got_r), "rescue mismatch"
print("sharded device rescue == unsharded: ok")

# 6) full paired-end chunk: extension + rescue + CIGAR all sharded
from bwamem_tpu.ops.global_jax import make_cigar_backend
from bwamem_tpu.parallel.dist import make_sharded_cigar_backend

r1s, r2s = [], []
for i in range(16):
    pos = int(rng.integers(0, 40000 - 400))
    r1 = pac[pos:pos + 100].astype(np.int64).copy()
    r2 = revcomp_read(pac[pos + 200:pos + 300].astype(np.int64))
    for r in (r1, r2):
        p = int(rng.integers(0, 100))
        r[p] = (r[p] + 1) % 4
    r1s.append(r1)
    r2s.append(r2)
pipeA = native_driver.NativePipeline(opt, ref, fm, po)
want_pe = [[r.line() for r in rr] for rr in pipeA.align_pairs_chunk(
    r1s, r2s, single, rescue_fn=rfn1, cigar_fn=make_cigar_backend())]
pipeB = native_driver.NativePipeline(opt, ref, fm, po)
got_pe = [[r.line() for r in rr] for rr in pipeB.align_pairs_chunk(
    r1s, r2s, sharded, rescue_fn=rfn8,
    cigar_fn=make_sharded_cigar_backend(mesh))]
assert want_pe == got_pe, "PE SAM mismatch under full mesh sharding"
print("e2e sharded PE SAM == single-device PE SAM: ok")

# 7) the fully resident mesh PE path: fused_idx extension +
# resident-reference rescue waves + CIGAR rounds, all sharded
from bwamem_tpu.parallel.dist import (
    make_sharded_cigar_idx_backend,
    make_sharded_rescue_idx_backend,
)

pipeC = native_driver.NativePipeline(opt, ref, fm, po)
got_pe_idx = [[r.line() for r in rr] for rr in pipeC.align_pairs_chunk(
    r1s, r2s, sharded_idx,
    rescue_fn=make_sharded_rescue_idx_backend(mesh, ref.pac),
    cigar_fn=make_sharded_cigar_idx_backend(mesh, ref.pac))]
assert want_pe == got_pe_idx, "PE SAM mismatch: resident mesh path"
print("e2e resident mesh PE SAM == single-device PE SAM: ok")

# 8) device seeding through the mesh: sharded seed rows == the
# single-device seeder's == the C++ host engine's, and a seed_fn-fed
# pipeline still reproduces the host-seeded SAM
from bwamem_tpu.ops.smem_jax import make_device_seeder
from bwamem_tpu.parallel.dist import make_sharded_device_seeder

seed1 = make_device_seeder(po, fm, opt)
seed8 = make_sharded_device_seeder(mesh, po, fm, opt)
rows1 = seed1(reads)
rows8 = seed8(reads)
assert np.array_equal(rows1, rows8), "seed rows mismatch under mesh"
pipeD = native_driver.NativePipeline(opt, ref, fm, po)
pipeD.seed_fn = seed8
got_seeded = [[r.line() for r in rr]
              for rr in pipeD.align_chunk(reads, sharded)]
assert want_sam == got_seeded, "SAM mismatch: mesh device seeding"
print("mesh device seeding rows + SAM == single-device: ok")
"""


def test_sharded_extension_8dev_cpu_mesh():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
        + os.pathsep + env.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", _SCRIPT], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    assert "e2e sharded SAM == single-device SAM: ok" in r.stdout
    assert "e2e sharded fused SAM == single-device SAM: ok" in r.stdout
    assert "e2e sharded fused_idx SAM == single-device SAM: ok" in r.stdout
    assert "sharded device CIGAR == unsharded: ok" in r.stdout
    assert "sharded device rescue == unsharded: ok" in r.stdout
    assert "e2e sharded PE SAM == single-device PE SAM: ok" in r.stdout
    assert "e2e resident mesh PE SAM == single-device PE SAM: ok" in r.stdout
