"""Multi-chip data parallelism for the aligner.

The reference scales by replicating PE arrays behind private double
buffers, scheduled round-robin by batch_manager
(/root/reference/batch_manager.v:994-1013; SURVEY.md §2.1 items 1-2).
Here: a `jax.sharding.Mesh` with a "data" axis; extension task
batches are sharded along the batch (lane) dimension — each device is
one giant PE array — while the scoring parameters are replicated.
Per-read data never crosses chips (a read's tasks stay in one shard,
like a task stays inside one PE array), so the only collective is the
result gather XLA inserts for the replicated output layout.

`make_sharded_raw_t_backend` wraps the platform's extension step
(ops/extend_step.step_for) in shard_map: the same step that runs on
one device runs per shard, and the native host pipeline
(pipeline/native_driver.NativePipeline) consumes it unchanged — pass it
as `raw_t_fn` and the whole aligner runs data-parallel.
tests/test_dist.py pins sharded SAM == single-device SAM on an
8-device CPU mesh."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bwamem_tpu.ops.extend_jax import ExtendParams


def make_mesh(devices=None, axis: str = "data") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def make_sharded_raw_t_backend(mesh: Mesh, params: ExtendParams):
    """Data-parallel phased extension backend.

    Returns raw_t(query_t, target_t, scal_t) -> (8, Bp) numpy, the
    exact contract of native_driver.make_raw_t_backend, with the task
    axis sharded over the mesh.  Bp must be a multiple of
    `raw_t.bp_quantum` (= n_devices); NativePipeline reads the
    attribute and pads its batches accordingly."""
    from bwamem_tpu.ops.extend_step import params_vector, prepare

    axis = mesh.axis_names[0]
    n_dev = int(mesh.devices.size)
    prm = params_vector(params)

    fn = jax.jit(jax.shard_map(
        prepare().extend_pass,
        mesh=mesh,
        in_specs=(P(None, axis), P(None, axis), P(None, axis), P(None)),
        out_specs=P(None, axis),
        # the GPU kernel's FFI call result carries no vma annotation,
        # which the varying-manual-axes checker requires;
        # the sharding here is plain batch-dim data parallelism with no
        # cross-shard communication, so the check adds nothing
        check_vma=False,
    ))

    def raw_t(query_t, target_t, scal_t):
        assert query_t.shape[1] % n_dev == 0, (query_t.shape, n_dev)
        return np.asarray(fn(query_t, target_t, scal_t, prm))

    raw_t.bp_quantum = n_dev
    return raw_t


def make_sharded_fused_backend(mesh: Mesh, params: ExtendParams):
    """Data-parallel FUSED whole-alignment backend (one device call per
    chunk, in-step band doubling and left->right h0 chaining) with the
    lane axis sharded over the mesh.  Same contract as
    native_driver.make_fused_backend; NativePipeline pads Bp to
    `bp_quantum` = n_devices."""
    from bwamem_tpu.ops.extend_step import params_vector, prepare

    axis = mesh.axis_names[0]
    n_dev = int(mesh.devices.size)
    prm = params_vector(params)

    fn = jax.jit(jax.shard_map(
        prepare().fused,
        mesh=mesh,
        in_specs=(P(None, axis),) * 5 + (P(None),),
        out_specs=P(None, axis),
        check_vma=False,  # same rationale as make_sharded_raw_t_backend
    ))

    def fused(ql, tl, qr, tr, scal_t):
        assert ql.shape[1] % n_dev == 0, (ql.shape, n_dev)
        return np.asarray(fn(ql, tl, qr, tr, scal_t, prm))

    fused.fused = True
    fused.bp_quantum = n_dev
    return fused


def make_sharded_fused_idx_backend(mesh: Mesh, params: ExtendParams, pac):
    """Mesh-sharded resident-reference fused backend: the two-strand
    text and the chunk read matrix REPLICATE across the mesh (every
    device holds the index — the reference replicates the genome into
    each PE array's host workspace the same way), while the per-lane
    scalar block shards on the lane axis; each shard gathers its own
    query/target windows locally, so no base payload crosses the host
    link and no collective crosses devices.  Same call contract as
    native_driver.make_fused_idx_backend."""
    import functools

    from bwamem_tpu.ops.extend_step import params_vector, prepare
    from bwamem_tpu.pipeline.native_driver import (
        fused_idx_local,
        resident_text_host,
    )

    prepare()
    axis = mesh.axis_names[0]
    n_dev = int(mesh.devices.size)
    prm = params_vector(params)
    a_max = int(np.max(np.asarray(params.mat_flat)))
    text = jax.device_put(
        resident_text_host(pac), NamedSharding(mesh, P()))

    @functools.partial(
        jax.jit, static_argnames=("qmax_l", "tmax_l", "qmax_r", "tmax_r"))
    def fn(reads_nib, scal, p, text, *, qmax_l, tmax_l, qmax_r, tmax_r):
        local = functools.partial(
            fused_idx_local, qmax_l=qmax_l, tmax_l=tmax_l,
            qmax_r=qmax_r, tmax_r=tmax_r, a_max=a_max)
        return jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(None, None), P(None, axis), P(None),
                      P(*([None] * text.ndim))),
            out_specs=P(None, axis),
            # plain batch-dim data parallelism; same vma rationale as
            # make_sharded_raw_t_backend
            check_vma=False,
        )(reads_nib, scal, p, text)

    def fused_idx(reads_nib, scal, dims, prm_override=None):
        assert scal.shape[1] % n_dev == 0, (scal.shape, n_dev)
        qmax_l, tmax_l, qmax_r, tmax_r = dims
        return fn(reads_nib, scal,
                  prm if prm_override is None else prm_override, text,
                  qmax_l=qmax_l, tmax_l=tmax_l, qmax_r=qmax_r,
                  tmax_r=tmax_r)

    fused_idx.fused = True
    fused_idx.idx = True
    fused_idx.bp_quantum = n_dev
    return fused_idx


def make_sharded_global_batch(mesh: Mesh, *, qmax: int, tmax: int):
    """Data-parallel device CIGAR (ops/global_jax._global_batch): the
    batched banded global alignment + on-device traceback with the
    task axis sharded over the mesh.  Tasks are independent (one
    read's realignment never crosses chips), so like the extension
    backends the only collective is the output gather.  Returns
    fn(query, qlen, target, tlen, w, mat, pens) -> (score, steps)
    with B a multiple of n_devices."""
    from bwamem_tpu.ops import global_jax

    axis = mesh.axis_names[0]
    n_dev = int(mesh.devices.size)

    def local(query, qlen, target, tlen, w, mat, pens):
        return global_jax._global_batch(query, qlen, target, tlen, w,
                                        mat, pens, qmax=qmax, tmax=tmax)

    fn = jax.jit(jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(None),
                  P(None)),
        # steps is (smax, B): task axis is axis 1
        out_specs=(P(axis), P(None, axis)),
        # the scan carry mixes invariant inits (eh_e0 = full(NEG)) with
        # shard-varying data, which the vma checker rejects; as with the
        # extension backends this is plain batch-dim data parallelism
        # with no cross-shard communication, so the check adds nothing
        check_vma=False,
    ))

    def sharded(query, qlen, target, tlen, w, mat, pens):
        assert query.shape[0] % n_dev == 0, (query.shape, n_dev)
        s, st = fn(query, qlen, target, tlen, w, mat, pens)
        return np.asarray(s), np.asarray(st)

    sharded.b_quantum = n_dev
    return sharded


def make_sharded_cigar_backend(mesh: Mesh):
    """Mesh-sharded device CIGAR backend for NativePipeline's
    mp_cigar_* round protocol: same contract as
    ops/global_jax.make_cigar_backend — fn(q_i8, t_i8, meta, mat,
    o_del, e_del, o_ins, e_ins) -> (scores, counts, flat) — with the
    fill + traceback shard_mapped over the mesh (one
    make_sharded_global_batch program cached per (qmax, tmax) round
    bucket).  Only the run-length encoding stays on the host."""
    from bwamem_tpu.ops.global_jax import pack_cigar_round

    n_dev = int(mesh.devices.size)
    cache: dict = {}

    def fn(q_i8, t_i8, meta, mat, o_del, e_del, o_ins, e_ins):
        B, qmax = q_i8.shape
        tmax = t_i8.shape[1]
        assert B % n_dev == 0, (B, n_dev)
        key = (qmax, tmax)
        if key not in cache:
            cache[key] = make_sharded_global_batch(mesh, qmax=qmax,
                                                   tmax=tmax)
        pens = np.array([o_del, e_del, o_ins, e_ins], np.int32)
        score, steps = cache[key](
            np.asarray(q_i8), np.asarray(meta[0]), np.asarray(t_i8),
            np.asarray(meta[1]), np.asarray(meta[2]),
            np.asarray(mat, np.int32), pens)
        return pack_cigar_round(score, steps)

    fn.b_quantum = n_dev
    return fn


def make_sharded_rescue_backend(mesh: Mesh):
    """Data-parallel device mate rescue (ops/local_jax._align6): the
    batched local Smith-Waterman behind mem_matesw with the task axis
    sharded over the mesh.  Same contract as
    ops/local_jax.make_rescue_backend — fn(seq_i8, rseq_i8, lens, mat,
    o_del, e_del, o_ins, e_ins) -> (6, Bp) int32 — so NativePipeline's
    mp_rescue_* wave protocol consumes it unchanged.  Rescue waves are
    shape-bucketed by the caller; one shard_map program is cached per
    (qmax, tmax) bucket.  Bp must be a multiple of n_devices (the
    wave builder's 256-lane buckets always are)."""
    import jax.numpy as jnp

    from bwamem_tpu.ops import local_jax

    axis = mesh.axis_names[0]
    n_dev = int(mesh.devices.size)
    cache: dict = {}

    def _program(qmax: int, tmax: int):
        if (qmax, tmax) not in cache:
            def local(query, qlen, target, tlen, mat, pens):
                return local_jax._align6(query, qlen, target, tlen,
                                         mat, pens, qmax=qmax, tmax=tmax)

            cache[(qmax, tmax)] = jax.jit(jax.shard_map(
                local,
                mesh=mesh,
                in_specs=(P(axis), P(axis), P(axis), P(axis), P(None),
                          P(None)),
                # rows [score, qb, qe, tb, te, score2]: task axis is 1
                out_specs=P(None, axis),
                # plain batch-dim data parallelism; same vma rationale
                # as make_sharded_global_batch
                check_vma=False,
            ))
        return cache[(qmax, tmax)]

    def fn(seq_i8, rseq_i8, lens, mat, o_del, e_del, o_ins, e_ins):
        B, qmax = seq_i8.shape
        tmax = rseq_i8.shape[1]
        assert B % n_dev == 0, (B, n_dev)
        pens = jnp.asarray(
            np.array([o_del, e_del, o_ins, e_ins], np.int32))
        out = _program(qmax, tmax)(
            jnp.asarray(seq_i8), jnp.asarray(lens[0]),
            jnp.asarray(rseq_i8), jnp.asarray(lens[1]),
            jnp.asarray(np.asarray(mat, np.int32)), pens)
        return np.asarray(out, np.int32)

    fn.b_quantum = n_dev
    return fn


def make_sharded_rescue_idx_backend(mesh: Mesh, pac=None, text_dev=None):
    """Mesh-sharded resident-reference mate rescue: text + read matrix
    replicate, the (6, Bp) meta block shards on the lane axis; same
    call contract as native_driver.make_rescue_idx_backend (the wave
    builder's 256-lane buckets are multiples of any mesh size)."""
    import functools

    import jax.numpy as jnp

    from bwamem_tpu.pipeline.native_driver import (
        rescue_idx_local,
        resident_text_host,
    )

    axis = mesh.axis_names[0]
    n_dev = int(mesh.devices.size)
    text = text_dev if text_dev is not None else jax.device_put(
        resident_text_host(pac), NamedSharding(mesh, P()))

    @functools.partial(jax.jit, static_argnames=("qmax", "tmax"))
    def fn(reads_nib, meta, mat, pens, text, *, qmax, tmax):
        local = functools.partial(rescue_idx_local, qmax=qmax, tmax=tmax)
        return jax.shard_map(
            lambda r, m, mt, pp, tx: local(r, m, mt, pp, tx),
            mesh=mesh,
            in_specs=(P(None, None), P(None, axis), P(None), P(None),
                      P(*([None] * text.ndim))),
            out_specs=P(None, axis),
            check_vma=False,  # batch-dim data parallelism only
        )(reads_nib, meta, mat, pens, text)

    def rescue_idx(reads_nib, meta, mat, o_del, e_del, o_ins, e_ins,
                   qmax, tmax):
        assert meta.shape[1] % n_dev == 0, (meta.shape, n_dev)
        pens = jnp.asarray(
            np.array([o_del, e_del, o_ins, e_ins], np.int32))
        out = fn(reads_nib, meta, jnp.asarray(np.asarray(mat, np.int32)),
                 pens, text, qmax=qmax, tmax=tmax)
        return np.asarray(out, np.int32)

    rescue_idx.idx = True
    rescue_idx.b_quantum = n_dev
    return rescue_idx


def make_sharded_cigar_idx_backend(mesh: Mesh, pac=None, text_dev=None):
    """Mesh-sharded resident-reference CIGAR rounds: text + read matrix
    replicate, the (8, Bp) meta block shards on the lane axis; same
    call contract as native_driver.make_cigar_idx_backend.  The
    traceback steps gather back to the host, where run-length encoding
    stays (as in make_sharded_cigar_backend)."""
    import functools

    import jax.numpy as jnp

    from bwamem_tpu.ops.global_jax import pack_cigar_round
    from bwamem_tpu.pipeline.native_driver import (
        cigar_idx_local,
        resident_text_host,
    )

    axis = mesh.axis_names[0]
    n_dev = int(mesh.devices.size)
    text = text_dev if text_dev is not None else jax.device_put(
        resident_text_host(pac), NamedSharding(mesh, P()))

    @functools.partial(jax.jit, static_argnames=("qmax", "tmax"))
    def fn(reads_nib, meta, mat, pens, text, *, qmax, tmax):
        local = functools.partial(cigar_idx_local, qmax=qmax, tmax=tmax)
        return jax.shard_map(
            lambda r, m, mt, pp, tx: local(r, m, mt, pp, tx),
            mesh=mesh,
            in_specs=(P(None, None), P(None, axis), P(None), P(None),
                      P(*([None] * text.ndim))),
            # (score (Bp,), steps (smax, Bp)): task axes 0 and 1
            out_specs=(P(axis), P(None, axis)),
            check_vma=False,  # batch-dim data parallelism only
        )(reads_nib, meta, mat, pens, text)

    def cigar_idx(reads_nib, meta, mat, o_del, e_del, o_ins, e_ins,
                  qmax, tmax):
        assert meta.shape[1] % n_dev == 0, (meta.shape, n_dev)
        pens = jnp.asarray(
            np.array([o_del, e_del, o_ins, e_ins], np.int32))
        score, steps = fn(reads_nib, meta,
                          jnp.asarray(np.asarray(mat, np.int32)), pens,
                          text, qmax=qmax, tmax=tmax)
        return pack_cigar_round(score, steps)

    cigar_idx.idx = True
    cigar_idx.b_quantum = n_dev
    return cigar_idx


def make_sharded_device_seeder(mesh: Mesh, po, fm, opt,
                               table_sharded: bool | None = None):
    """Data-parallel device seeding.  Two regimes:

    - reads-sharded (default below 2^31 rows): the chunk's reads shard
      over the mesh for the lockstep SMEM search, the SA-walk rows
      shard for the seed materialization, and the packed-occ tables +
      sampled SA replicate (index replication, SURVEY.md §7 step 6).
    - TABLE-sharded (automatic at >= 2^31 rows, i.e. GRCh38 scale, or
      forced with table_sharded=True): the occ/SA tables shard by
      block range over the mesh and rank queries route to the owning
      shard via masked psum — each chip holds 1/N of the index and FM
      coordinates go wide, lifting the int32 cap entirely
      (ops/smem_sharded.py; BASELINE config #4).

    Returns the same `seed_fn(reads) -> (n, 4) int64 rows` contract as
    ops/smem_jax.make_device_seeder, so NativePipeline.seed_fn consumes
    any of them; rows are identical to the single-device (and C++ host)
    seeder's (tests/test_dist.py, tests/test_smem_sharded.py)."""
    import functools

    import jax.numpy as jnp

    from bwamem_tpu.ops.smem_jax import (
        DeviceOcc,
        _sa_kernel,
        _smem1_kernel,
        collect_seeds_device,
    )

    axis = mesh.axis_names[0]
    n_dev = int(mesh.devices.size)
    if table_sharded is None:
        table_sharded = int(po.n_rows) >= 1 << 31
    if table_sharded:
        from bwamem_tpu.ops.smem_sharded import make_table_sharded_seeder

        return make_table_sharded_seeder(mesh, po, fm, opt)
    if int(po.n_rows) >= 1 << 31:
        # an explicitly FORCED reads-sharded regime on a too-big index
        # must fail loudly, never truncate int32 coordinates silently
        raise ValueError(
            "reads-sharded device seeding requires n_rows < 2^31; "
            "use table_sharded=True (the default at this scale)")
    d = DeviceOcc(po)

    smem_body = functools.partial(
        _smem1_kernel, d.occ_rows, d.pk_rows, d.va_rows, d.C,
        int(d.primary), int(d.n_rows))
    smem_sh = jax.jit(jax.shard_map(
        smem_body, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        # (ret, overflow, m_qb, m_qe, m_x0, m_x1, m_s, m_n): all lead
        # with the read axis
        out_specs=(P(axis),) * 8,
        # loop carries mix shard-varying reads with replicated-constant
        # initializers; plain batch-dim data parallelism, no collectives
        check_vma=False,
    ))

    def smem1_fn(q, qlen, x, mi):
        B = q.shape[0]
        Bp = -(-B // n_dev) * n_dev
        if Bp != B:
            pad = Bp - B
            q = jnp.pad(q, ((0, pad), (0, 0)), constant_values=4)
            qlen = jnp.pad(qlen, (0, pad))        # len 0: never startable
            x = jnp.pad(x, (0, pad))
            mi = jnp.pad(mi, (0, pad), constant_values=1)
        out = smem_sh(q, qlen, x, mi)
        return tuple(o[:B] for o in out) if Bp != B else out

    ssa_d = jnp.asarray(np.asarray(fm.ssa, np.int64).astype(np.int32))
    sa_body = functools.partial(
        _sa_kernel, d.occ_rows, d.pk_rows, d.va_rows, d.C,
        int(d.primary), int(d.n_rows), ssa_d, int(fm.sa_intv))
    sa_sh = jax.jit(jax.shard_map(
        sa_body, mesh=mesh, in_specs=(P(axis),), out_specs=P(axis),
        check_vma=False))

    def sa_fn(rows):
        n = rows.shape[0]
        np_ = -(-n // n_dev) * n_dev
        if np_ != n:
            rows = jnp.pad(rows, (0, np_ - n))  # row 0 resolves at once
        out = sa_sh(rows)
        return out[:n] if np_ != n else out

    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)

    def seed_fn(reads):
        return collect_seeds_device(
            d, fm, reads, opt.min_seed_len, split_len, opt.split_width,
            opt.max_occ, sa_fn=sa_fn, smem1_fn=smem1_fn)

    return seed_fn


def shard_batch(mesh: Mesh, arrays):
    """Device-put a pytree of (B, ...) host arrays with batch-dim sharding."""
    axis = mesh.axis_names[0]
    return jax.tree_util.tree_map(
        lambda a: jax.device_put(
            a, NamedSharding(mesh, P(axis, *([None] * (a.ndim - 1))))),
        arrays)
