"""Device-side (JAX) FM-index SMEM search — SURVEY.md §7 step 3.

`smem1_batch_device` is a fully jitted batched `bwt_smem1`: every read
in the batch advances through the forward/backward phase structure in
lockstep under `lax.fori_loop`, each step doing one batched `rank4`
row-gather + SWAR popcount against the packed-occ tables resident in
device HBM (index/occ_packed.py expressions instantiated under
jax.numpy).  Interval pushes, stop conditions and containment-filtered
emission run as masked one-hot scatters over static slot axes
(P_CAP live intervals, M_CAP emitted SMEMs per call) — the same
algorithm as index/smem_batch.smem1_batch, whose numpy body is the
tested host twin; outputs are bit-equal (tests/test_smem_jax.py).

DECISION (round 2): the DEFAULT production seeding stays on the HOST
in C++ (csrc/smem.cpp).  Measured at scale (bench/index_scale.py) the
native engine sustains tens of thousands of reads/s at gigabase
genomes while overlapping with device extension; a device SMEM
serializes dependent HBM gathers per extension step (the classic
FM-index latency chain) and contends with the extension kernel for the
chip.  The reference's seeding also runs host-side on CPU threads
(SURVEY.md §0).  For pods where host CPU, not the chip, is the scarce
resource, the device path is production-SELECTABLE: `--device-seed`
(CLI) / `make_device_seeder` (NativePipeline.seed_fn) runs the chunk's
SMEM search AND the SA-materialization walks on device, emitting seed
rows byte-identical to the C++ engine's (tests/test_device_seed.py)
into mp_chunk_start_seeded.

Limit: positions are int32 on device (jax x64 stays off), so THIS
replicated path covers two-strand texts < 2^31 symbols (~1 Gb
genomes); the host paths have no such limit.  For larger texts
(GRCh38's 6.2 Gsym) the TABLE-SHARDED twin (ops/smem_sharded.py,
routed automatically by parallel/dist.make_sharded_device_seeder)
carries coordinates as two int32 words and shards the occ/SA tables
by block range over the mesh — no cap, 1/N index per chip.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bwamem_tpu.index.occ_packed import (
    OCC_BLOCK,
    WORD_SYMS,
    PackedOcc,
    extend_backward4 as _eb4,
    extend_forward4 as _ef4,
    rank4 as _rank4,
)
from bwamem_tpu.index.smem_batch import M_CAP, P_CAP

# Device prev-slot width.  The batched rank cost scales with B*P
# (measured 1495 us/step at P=24 vs 117 us at P=1 for a 300-deep
# dependent chain, B=2048, 60 Mb index), so a narrower device width
# looked like a ~3x win — but a P_DEV=8 probe measured 51.5 reads/s
# end-to-end (vs 94.3 at 24): real reads' forward interval lists
# routinely exceed 8 distinct sizes, and every overflow falls back to
# the exact scalar host search.  bwa's 24 is the right width; the
# device-seeding ceiling analysis lives in bench/README ("Device
# seeding roofline").
P_DEV = P_CAP


class DeviceOcc:
    """PackedOcc tables resident on the device (HBM)."""

    def __init__(self, po: PackedOcc):
        self.occ_rows = jnp.asarray(po.occ_rows)
        self.pk_rows = jnp.asarray(po.pk_rows)
        self.va_rows = jnp.asarray(po.va_rows)
        self.C = jnp.asarray(po.C)
        self.primary = po.primary
        self.n_rows = po.n_rows
        self._smem1_jit = None
        self._smem_all_jit = None

    def smem1_jit(self):
        """Lazily-cached jitted smem1 kernel: repeat chunks (and
        split re-seed jobs) reuse one compiled executable instead of
        rebuilding a fresh jax.jit wrapper per call — through the
        remote compile service a dispatch-cache miss costs minutes."""
        if self._smem1_jit is None:
            self._smem1_jit = make_smem1_device(self)
        return self._smem1_jit

    def smem_all_jit(self):
        if self._smem_all_jit is None:
            self._smem_all_jit = make_smem_all_device(self)
        return self._smem_all_jit


class _Shim:
    def __init__(self, occ_rows, pk_rows, va_rows, C, primary, n_rows):
        self.occ_rows = occ_rows
        self.pk_rows = pk_rows
        self.va_rows = va_rows
        self.C = C
        self.primary = primary
        self.n_rows = n_rows


def rank4_device(d: DeviceOcc, i):
    """Batched rank query on device; i: jnp int array, any shape."""
    shim = _Shim(d.occ_rows, d.pk_rows, d.va_rows, None, d.primary,
                 d.n_rows)
    return jax.jit(lambda ii: _rank4(shim, ii, jnp))(jnp.asarray(i))


def extend_backward4_device(d: DeviceOcc, x0, x1, s):
    shim = _Shim(d.occ_rows, d.pk_rows, d.va_rows,
                 np.asarray(d.C), d.primary, d.n_rows)
    return _eb4(shim, jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(s),
                jnp)


def extend_forward4_device(d: DeviceOcc, x0, x1, s):
    shim = _Shim(d.occ_rows, d.pk_rows, d.va_rows,
                 np.asarray(d.C), d.primary, d.n_rows)
    return _ef4(shim, jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(s),
                jnp)


# ---------------------------------------------------------------------
# batched bwt_smem1 on device (jitted twin of smem_batch.smem1_batch)
# ---------------------------------------------------------------------

def _smem1_kernel(occ_rows, pk_rows, va_rows, C, primary, n_rows,
                  q, qlen, x, min_intv):
    """Jittable body.  q (B, L) int32 codes (4 = N/pad); all position
    arrays int32.  Returns (ret, overflow, m_qb, m_qe, m_x0, m_x1,
    m_s, m_n) with the exact semantics of smem_batch.smem1_batch."""
    po = _Shim(occ_rows, pk_rows, va_rows, C, primary, n_rows)
    B, L = q.shape
    bI = jnp.arange(B)
    iotaP = jnp.arange(P_DEV)
    iotaM = jnp.arange(M_CAP)

    at_x = q[bI, jnp.minimum(x, L - 1)]
    startable = (x < qlen) & (at_x < 4)
    c0 = jnp.where(startable, jnp.clip(at_x, 0, 3), 0)
    cx0 = jnp.where(startable, C[c0], 0)
    cs = jnp.where(startable, C[c0 + 1] - C[c0], 0)
    cx1 = jnp.where(startable, C[3 - c0], 0)
    cqe = x + 1

    zP = jnp.zeros((B, P_DEV), jnp.int32)
    zB = jnp.zeros((B,), jnp.int32)

    def fpush(st, mask):
        (f_x0, f_x1, f_s, f_qe, f_n, overflow, cx0, cx1, cs, cqe) = st
        ok = mask & (f_n < P_DEV)
        oh = (iotaP[None, :] == f_n[:, None]) & ok[:, None]
        f_x0 = jnp.where(oh, cx0[:, None], f_x0)
        f_x1 = jnp.where(oh, cx1[:, None], f_x1)
        f_s = jnp.where(oh, cs[:, None], f_s)
        f_qe = jnp.where(oh, cqe[:, None], f_qe)
        overflow = overflow | (mask & (f_n >= P_DEV))
        f_n = f_n + ok.astype(jnp.int32)
        return (f_x0, f_x1, f_s, f_qe, f_n, overflow, cx0, cx1, cs, cqe)

    def fwd_body(t, c):
        (cx0, cx1, cs, cqe, f_x0, f_x1, f_s, f_qe, f_n, active,
         overflow) = c
        i = x + t
        at_end = active & (i >= qlen)
        ch = q[bI, jnp.clip(i, 0, L - 1)]
        amb = active & ~at_end & (ch > 3)
        st = fpush((f_x0, f_x1, f_s, f_qe, f_n, overflow, cx0, cx1, cs,
                    cqe), at_end | amb)
        (f_x0, f_x1, f_s, f_qe, f_n, overflow, *_rest) = st
        active = active & ~(at_end | amb)
        # forward extension via the revcomp swap (smem_batch.py:99-104)
        nx0, nx1, ns = _eb4(po, cx1, cx0, cs, jnp)
        cc = jnp.clip(3 - ch, 0, 3)
        ex1 = nx0[bI, cc].astype(jnp.int32)
        ex0 = nx1[bI, cc].astype(jnp.int32)
        es = ns[bI, cc].astype(jnp.int32)
        changed = active & (es != cs)
        st = fpush((f_x0, f_x1, f_s, f_qe, f_n, overflow, cx0, cx1, cs,
                    cqe), changed)
        (f_x0, f_x1, f_s, f_qe, f_n, overflow, *_rest) = st
        too_small = changed & (es < min_intv)
        active = active & ~too_small
        upd = active  # = ext & ~too_small (smem_batch.py:109)
        cx0 = jnp.where(upd, ex0, cx0)
        cx1 = jnp.where(upd, ex1, cx1)
        cs = jnp.where(upd, es, cs)
        cqe = jnp.where(upd, i + 1, cqe)
        return (cx0, cx1, cs, cqe, f_x0, f_x1, f_s, f_qe, f_n, active,
                overflow)

    c = (cx0, cx1, cs, cqe, zP, zP, zP, zP, zB, startable,
         jnp.zeros((B,), bool))
    c = jax.lax.fori_loop(1, L + 1, fwd_body, c)
    (cx0, cx1, cs, cqe, f_x0, f_x1, f_s, f_qe, f_n, active, overflow) = c
    st = fpush((f_x0, f_x1, f_s, f_qe, f_n, overflow, cx0, cx1, cs, cqe),
               active)
    (f_x0, f_x1, f_s, f_qe, f_n, overflow, *_rest) = st
    has = startable & (f_n > 0)
    last = jnp.maximum(f_n - 1, 0)
    ret = jnp.where(has, f_qe[bI, last], x + 1)

    # prev = reversed fcur (longest first)
    ridx = jnp.clip(f_n[:, None] - 1 - iotaP[None, :], 0, P_DEV - 1)
    inb = iotaP[None, :] < f_n[:, None]
    p_x0 = jnp.where(inb, jnp.take_along_axis(f_x0, ridx, 1), 0)
    p_x1 = jnp.where(inb, jnp.take_along_axis(f_x1, ridx, 1), 0)
    p_s = jnp.where(inb, jnp.take_along_axis(f_s, ridx, 1), 0)
    p_qe = jnp.where(inb, jnp.take_along_axis(f_qe, ridx, 1), 0)
    p_n = f_n

    zM = jnp.zeros((B, M_CAP), jnp.int32)
    m_qb, m_qe, m_x0, m_x1, m_s = zM, zM, zM, zM, zM
    m_n = zB
    back_active = startable & (p_n > 0)

    def bwd_body(t, c):
        (p_x0, p_x1, p_s, p_qe, p_n, m_qb, m_qe, m_x0, m_x1, m_s, m_n,
         back_active) = c
        i = x - t
        live = back_active & (i >= -1)
        ch = jnp.where(i >= 0, q[bI, jnp.maximum(i, 0)], 4)
        cvalid = live & (i >= 0) & (ch < 4)
        nx0, nx1, ns = _eb4(po, p_x0, p_x1, p_s, jnp)   # (B, P, 4)
        chc = jnp.clip(ch, 0, 3)
        sel_x0 = jnp.take_along_axis(
            nx0, chc[:, None, None], 2)[..., 0].astype(jnp.int32)
        sel_x1 = jnp.take_along_axis(
            nx1, chc[:, None, None], 2)[..., 0].astype(jnp.int32)
        sel_s = jnp.take_along_axis(
            ns, chc[:, None, None], 2)[..., 0].astype(jnp.int32)

        # --- vectorized slot compaction (the former 24-iteration
        # fori_loop: ~340 dependent vector ops per backward step, the
        # measured device-seeding wall).  Same semantics, proved by the
        # smem parity tests:
        #   keep/stop per slot are independent of the scan state;
        #   the running last_s always equals the s of the last KEPT
        #   slot (a kept-but-deduped slot has s == last_s by
        #   definition), so push_j = keep_j & (s_j != s[prev kept j']);
        #   at most ONE slot emits per step (the first stop slot before
        #   any keep: the first emit sets m_qb[last] = i+1, making the
        #   (i+1 < m_qb[last]) test false for every later candidate,
        #   and if the first candidate fails the test, all fail it).
        has = live[:, None] & (iotaP[None, :] < p_n[:, None])
        min_i = jnp.broadcast_to(jnp.asarray(min_intv), (B,))[:, None]
        stop = has & (~cvalid[:, None] | (sel_s < min_i))
        keep = has & ~stop
        keep_i = keep.astype(jnp.int32)
        ncum = jnp.cumsum(keep_i, axis=1)          # inclusive kept count
        # s of the previous kept slot: gather at the index of the last
        # kept j' < j (clipped; masked below for "no prev kept")
        kidx = jnp.where(keep, iotaP[None, :], -1)
        prev_kidx = jax.lax.associative_scan(jnp.maximum, kidx, axis=1)
        prev_kidx = jnp.concatenate(
            [jnp.full((B, 1), -1, jnp.int32), prev_kidx[:, :-1]], axis=1)
        prev_s = jnp.take_along_axis(
            sel_s, jnp.maximum(prev_kidx, 0), axis=1)
        push = keep & ((prev_kidx < 0) | (sel_s != prev_s))
        # compact pushes in slot order via a stable sort of their j's
        key = jnp.where(push, iotaP[None, :], P_DEV)
        order = jnp.argsort(key, axis=1)
        n_cnt = jnp.sum(push.astype(jnp.int32), axis=1)
        inb_n = iotaP[None, :] < n_cnt[:, None]
        gat = lambda a: jnp.where(
            inb_n, jnp.take_along_axis(a, order, axis=1), 0)
        n_x0, n_x1, n_s = gat(sel_x0), gat(sel_x1), gat(sel_s)
        n_qe = gat(p_qe)
        # the single emitted SMEM: first stop slot with no keep before
        cand = stop & (ncum - keep_i == 0)
        any_cand = jnp.any(cand, axis=1)
        first_j = jnp.argmax(cand, axis=1)
        lastm = jnp.maximum(m_n - 1, 0)
        emit = any_cand & ((m_n == 0) | (i + 1 < m_qb[bI, lastm])) & (
            m_n < M_CAP)
        ohm = (iotaM[None, :] == m_n[:, None]) & emit[:, None]
        m_qb = jnp.where(ohm, (i + 1)[:, None], m_qb)
        m_qe = jnp.where(ohm, p_qe[bI, first_j][:, None], m_qe)
        m_x0 = jnp.where(ohm, p_x0[bI, first_j][:, None], m_x0)
        m_x1 = jnp.where(ohm, p_x1[bI, first_j][:, None], m_x1)
        m_s = jnp.where(ohm, p_s[bI, first_j][:, None], m_s)
        m_n = m_n + emit.astype(jnp.int32)
        back_active = back_active & (n_cnt > 0)
        return (n_x0, n_x1, n_s, n_qe, n_cnt, m_qb, m_qe, m_x0, m_x1,
                m_s, m_n, back_active)

    c = (p_x0, p_x1, p_s, p_qe, p_n, m_qb, m_qe, m_x0, m_x1, m_s, m_n,
         back_active)
    c = jax.lax.fori_loop(1, L + 2, bwd_body, c)
    (_, _, _, _, _, m_qb, m_qe, m_x0, m_x1, m_s, m_n, _) = c
    overflow = overflow | (m_n >= M_CAP)
    return ret, overflow, m_qb, m_qe, m_x0, m_x1, m_s, m_n


def make_smem1_device(d: DeviceOcc):
    """Returns a jitted smem1(q, qlen, x, min_intv) over a fixed-shape
    int32 batch, with the occ tables captured on device."""
    fn = functools.partial(_smem1_kernel, d.occ_rows, d.pk_rows,
                           d.va_rows, d.C, d.primary, d.n_rows)
    return jax.jit(fn)


# total SMEM slots per read across ALL first-round smem1 calls of the
# fused device loop (M_CAP bounds one call); overflow -> exact host
# fallback for that read, same policy as the per-round path
ALL_CAP = 128


def _smem_all_kernel(occ_rows, pk_rows, va_rows, C, primary, n_rows,
                     q, qlen, msl):
    """The whole first-round SMEM collection under ONE jit: a
    `lax.while_loop` advances every read's start pointer x in lockstep
    (the host orchestration loop of collect_smems_device moved on
    device), each iteration one `_smem1_kernel` round at the current
    frontier.  Emitted SMEMs with qlen >= msl append per read into
    ALL_CAP slots in EXACTLY the host path's order (rounds ascending,
    within a round the kernel's emission order reversed — the
    `mems.reverse()` of the host consumer).  Returns one packed int32
    matrix (B, 2 + 5*ALL_CAP): [cnt, overflow, qb…, qe…, x0…, x1…, s…]
    so the host needs a single D2H fetch per chunk."""
    B, L = q.shape
    bI = jnp.arange(B)
    kI = jnp.arange(M_CAP)
    # next non-N position at-or-after j, precomputed once: a lane
    # sitting on an N run jumps straight past it instead of paying one
    # full (dead) smem1 round per N base — same per-read smem1 call
    # sequence, fewer lockstep rounds (ADVICE round 2)
    idxL = jnp.arange(L, dtype=jnp.int32)[None, :]
    nn = jnp.where(q <= 3, idxL, L)
    next_nn = jnp.flip(jax.lax.cummin(jnp.flip(nn, axis=1), axis=1),
                       axis=1)

    def cond(c):
        return jnp.any(c[0] < qlen)

    def body(c):
        x, sl_qb, sl_qe, sl_x0, sl_x1, sl_s, cnt, ovf = c
        at = q[bI, jnp.minimum(x, L - 1)]
        todo = x < qlen
        skip = todo & (at > 3)          # N run: jump past it, no search
        x_adv = jnp.where(skip, next_nn[bI, jnp.minimum(x, L - 1)], x)
        active = todo & ~skip
        xs_eff = jnp.where(active, x_adv, qlen).astype(jnp.int32)
        ret, o, m_qb, m_qe, m_x0, m_x1, m_s, m_n = _smem1_kernel(
            occ_rows, pk_rows, va_rows, C, primary, n_rows,
            q, qlen, xs_eff, jnp.ones_like(qlen))
        keep = (kI[None, :] < m_n[:, None]) & ((m_qe - m_qb) >= msl) \
            & active[:, None]
        csum = jnp.cumsum(keep.astype(jnp.int32), axis=1)
        total = csum[:, -1]
        # appended order = descending kernel index among kept slots
        pos = total[:, None] - csum                 # kept k' > k count
        tgt = jnp.where(keep, cnt[:, None] + pos, ALL_CAP)
        tgt = jnp.minimum(tgt, ALL_CAP)             # spill -> dropped col
        sl_qb = sl_qb.at[bI[:, None], tgt].set(m_qb)
        sl_qe = sl_qe.at[bI[:, None], tgt].set(m_qe)
        sl_x0 = sl_x0.at[bI[:, None], tgt].set(m_x0)
        sl_x1 = sl_x1.at[bI[:, None], tgt].set(m_x1)
        sl_s = sl_s.at[bI[:, None], tgt].set(m_s)
        new_cnt = cnt + jnp.where(active, total, 0)
        ovf = ovf | (active & o.astype(bool)) | (new_cnt > ALL_CAP)
        new_x = jnp.where(active, ret, x_adv)
        return (new_x, sl_qb, sl_qe, sl_x0, sl_x1, sl_s,
                jnp.minimum(new_cnt, ALL_CAP), ovf)

    zS = jnp.zeros((B, ALL_CAP + 1), jnp.int32)
    c0 = (jnp.zeros((B,), jnp.int32), zS, zS, zS, zS, zS,
          jnp.zeros((B,), jnp.int32), jnp.zeros((B,), bool))
    x, sl_qb, sl_qe, sl_x0, sl_x1, sl_s, cnt, ovf = \
        jax.lax.while_loop(cond, body, c0)
    return jnp.concatenate(
        [cnt[:, None], ovf.astype(jnp.int32)[:, None],
         sl_qb[:, :ALL_CAP], sl_qe[:, :ALL_CAP], sl_x0[:, :ALL_CAP],
         sl_x1[:, :ALL_CAP], sl_s[:, :ALL_CAP]], axis=1)


def make_smem_all_device(d: DeviceOcc):
    """Jitted whole-first-round SMEM search (one dispatch per chunk)."""
    fn = functools.partial(_smem_all_kernel, d.occ_rows, d.pk_rows,
                           d.va_rows, d.C, d.primary, d.n_rows)
    return jax.jit(fn)


def collect_smems_device(d: DeviceOcc, fm, reads, min_seed_len: int,
                         split_len: int, split_width: int,
                         smem1_fn=None, all_fn=None):
    """Batched mem_collect_intv with the SMEM search on DEVICE —
    semantics equal to fmindex.collect_smems per read (fuzz-pinned by
    tests/test_smem_jax.py).  The first round (every start position of
    every read) runs as ONE device dispatch (`_smem_all_kernel`:
    the round loop lives in a lax.while_loop) with a single packed D2H
    fetch; only the rare split re-seed round is host-orchestrated.
    Pathological reads (slot overflow) fall back to the scalar host
    search, exactly like the host batch path.  `smem1_fn` swaps in an
    alternative jitted smem1 (the mesh-sharded one from
    parallel/dist.make_sharded_device_seeder); alone it selects the
    host-orchestrated round loop, and together with a matching
    `all_fn` (the table-sharded fused twin, ops/smem_sharded.
    _smem_all_wide) the first round runs fused while smem1_fn serves
    only the rare split re-seed rounds."""
    from bwamem_tpu.index.fmindex import BiInterval, smem1

    B = len(reads)
    L = max((len(r) for r in reads), default=1)
    q = np.full((B, L), 4, np.int32)
    qlen = np.zeros(B, np.int32)
    for b, r in enumerate(reads):
        q[b, :len(r)] = r
        qlen[b] = len(r)
    dev = smem1_fn if smem1_fn is not None else d.smem1_jit()
    qd = jnp.asarray(q)
    qlen_d = jnp.asarray(qlen)

    def run(xs, mis, mask):
        """One device round over the full batch; masked rows are fed
        x = qlen (non-startable) and contribute nothing.  All eight
        outputs come back in ONE packed D2H fetch: one blocking fetch
        per round instead of eight."""
        xs_eff = np.where(mask, xs, qlen).astype(np.int32)
        out = dev(qd, qlen_d, jnp.asarray(xs_eff),
                  jnp.asarray(mis.astype(np.int32)))
        o_ret, o_ovf, o_qb, o_qe, o_x0, o_x1, o_s, o_n = out
        if isinstance(o_ret, np.ndarray):
            # a host-fetching twin (the table-sharded wide seeder,
            # ops/smem_sharded.py) already packed/joined on its side:
            # its int64 coordinates must NOT round-trip through jnp
            # (x64 is off — jnp would silently truncate to int32)
            ret, overflow, m_n = o_ret, o_ovf, o_n
            m_qb, m_qe, m_x0, m_x1, m_s = o_qb, o_qe, o_x0, o_x1, o_s
        else:
            K = o_qb.shape[1]
            # pack in the WIDEST output dtype: a future 64-bit kernel
            # twin (>2^31-symbol texts) must fail loudly or widen, never
            # silently truncate through an int32 astype (ADVICE round 2)
            dt = o_qb.dtype
            for o in (o_x0, o_x1, o_s, o_ret):
                dt = jnp.promote_types(dt, o.dtype)
            packed = np.asarray(jnp.concatenate(
                [o_ret[:, None].astype(dt), o_ovf[:, None].astype(dt),
                 o_n[:, None].astype(dt), o_qb.astype(dt),
                 o_qe.astype(dt), o_x0.astype(dt), o_x1.astype(dt),
                 o_s.astype(dt)], axis=1))
            # ret is written by the overflow fallback below; np.asarray
            # of a jax array is a read-only zero-copy view, so copy it
            ret, overflow, m_n = packed[:, 0].copy(), packed[:, 1], \
                packed[:, 2]
            m_qb = packed[:, 3:3 + K]
            m_qe = packed[:, 3 + K:3 + 2 * K]
            m_x0 = packed[:, 3 + 2 * K:3 + 3 * K]
            m_x1 = packed[:, 3 + 3 * K:3 + 4 * K]
            m_s = packed[:, 3 + 4 * K:3 + 5 * K]
        per_read = []
        for b in range(B):
            if not mask[b]:
                per_read.append([])
                continue
            if overflow[b]:
                nx, mems = smem1(fm, q[b, :qlen[b]].astype(np.int64),
                                 int(xs[b]), int(mis[b]))
                ret[b] = nx
                per_read.append(mems)
                continue
            mems = [BiInterval(x0=int(m_x0[b, k]), x1=int(m_x1[b, k]),
                               s=int(m_s[b, k]), qb=int(m_qb[b, k]),
                               qe=int(m_qe[b, k]))
                    for k in range(int(m_n[b]))]
            mems.reverse()
            per_read.append(mems)
        return ret, per_read

    mems: list[list] = [[] for _ in range(B)]
    ones = np.ones(B, np.int32)
    if smem1_fn is None or all_fn is not None:
        # fused first round: ONE dispatch + ONE fetch for the chunk
        # (with BOTH given, all_fn runs the first round fused and
        # smem1_fn serves the rare split re-seed rounds — the
        # table-sharded seeder's arrangement)
        if all_fn is None:
            all_fn = d.smem_all_jit()
        packed = np.asarray(all_fn(qd, qlen_d,
                                   jnp.int32(min_seed_len)))
        cnt, ovf = packed[:, 0], packed[:, 1]
        if getattr(all_fn, "wide", False):
            # table-sharded wide twin (ops/smem_sharded._smem_all_wide):
            # 7 slot planes; (hi, lo) joined HOST-side into int64 —
            # never through jnp (x64 off would truncate)
            from bwamem_tpu.ops.smem_sharded import join64

            fA = lambda k: packed[:, 2 + k * ALL_CAP:
                                  2 + (k + 1) * ALL_CAP]
            s_qb, s_qe = fA(0), fA(1)
            s_x0 = join64(fA(2), fA(3))
            s_x1 = join64(fA(4), fA(5))
            s_s = fA(6)
        else:
            s_qb = packed[:, 2:2 + ALL_CAP]
            s_qe = packed[:, 2 + ALL_CAP:2 + 2 * ALL_CAP]
            s_x0 = packed[:, 2 + 2 * ALL_CAP:2 + 3 * ALL_CAP]
            s_x1 = packed[:, 2 + 3 * ALL_CAP:2 + 4 * ALL_CAP]
            s_s = packed[:, 2 + 4 * ALL_CAP:2 + 5 * ALL_CAP]
        for b in range(B):
            if ovf[b]:  # exact host fallback, scalar oracle
                xx = 0
                ql = int(qlen[b])
                qb64 = q[b, :ql].astype(np.int64)
                while xx < ql:
                    if q[b, xx] > 3:
                        xx += 1
                        continue
                    nx, ms = smem1(fm, qb64, xx, 1)
                    mems[b].extend(
                        m for m in ms if m.qlen >= min_seed_len)
                    xx = int(nx)
                continue
            mems[b] = [BiInterval(x0=int(s_x0[b, k]), x1=int(s_x1[b, k]),
                                  s=int(s_s[b, k]), qb=int(s_qb[b, k]),
                                  qe=int(s_qe[b, k]))
                       for k in range(int(cnt[b]))]
    else:
        x = np.zeros(B, np.int32)
        # next non-N position at-or-after j (N runs jump in one round
        # instead of one dead round per N base — ADVICE round 2)
        nn_np = np.where(q <= 3, np.arange(L, dtype=np.int32)[None, :], L)
        next_nn = np.minimum.accumulate(nn_np[:, ::-1], axis=1)[:, ::-1]
        while True:
            todo = x < qlen
            if not todo.any():
                break
            at = q[np.arange(B), np.minimum(x, L - 1)]
            skip = todo & (at > 3)
            x = np.where(skip, next_nn[np.arange(B),
                                       np.minimum(x, L - 1)],
                         x).astype(np.int32)
            run_mask = todo & ~skip
            if not run_mask.any():
                continue
            nx, got = run(x, ones, run_mask)
            for b in np.nonzero(run_mask)[0]:
                mems[b].extend(
                    m for m in got[b] if m.qlen >= min_seed_len)
                x[b] = nx[b]

    # second round: re-seed long low-occ SMEMs from their middle
    jobs = []
    for b in range(B):
        for p in mems[b]:
            if p.qlen >= split_len and p.s <= split_width:
                jobs.append((b, (p.qb + p.qe) // 2, p.s + 1))
    pending = jobs
    while pending:
        xs = np.zeros(B, np.int32)
        mis = np.ones(B, np.int32)
        mask = np.zeros(B, bool)
        # at most one job per read per device round (duplicate target
        # reads spill to the next round)
        spill = []
        for (b, xx, mi) in pending:
            if mask[b]:
                spill.append((b, xx, mi))
                continue
            mask[b] = True
            xs[b] = xx
            mis[b] = mi
        _, got = run(xs, mis, mask)
        for b in np.nonzero(mask)[0]:
            mems[b].extend(m for m in got[b] if m.qlen >= min_seed_len)
        pending = spill

    for b in range(B):
        mems[b].sort(key=lambda m: (m.qb, m.qe))
    return mems


# ---------------------------------------------------------------------
# batched bwt_sa on device + full seed materialization
# ---------------------------------------------------------------------

def _sa_kernel(occ_rows, pk_rows, va_rows, C, primary, n_rows, ssa,
               sa_intv, rows):
    """Jittable batched bwt_sa (occ_packed.sa_value_batch's device twin):
    masked lockstep LF-walks under `lax.while_loop` until every lane
    hits the primary row or a row-sampled SA entry.  rows int32 (N,);
    returns text positions int32 (N,).  Each LF step is one batched
    symbol lookup + rank4 against the HBM-resident packed tables —
    the same dependent-gather chain as csrc/smem.cpp sa_value, run
    across the whole batch at once."""
    po = _Shim(occ_rows, pk_rows, va_rows, None, primary, n_rows)
    r0 = rows.astype(jnp.int32)
    zero = jnp.zeros_like(r0)
    n_ssa = ssa.shape[0]
    # walks are only EXPECTED to take ~sa_intv steps; bound by n_rows
    max_it = min(int(n_rows) + 1, (1 << 31) - 1)

    def cond(c):
        _r, _d, _val, done, it = c
        return jnp.logical_and(~jnp.all(done), it < max_it)

    def body(c):
        r, d, val, done, it = c
        hitp = ~done & (r == primary)
        val = jnp.where(hitp, d, val)
        done = done | hitp
        sampled = ~done & (r % sa_intv == 0)
        val = jnp.where(sampled, ssa[(r // sa_intv) % n_ssa] + d, val)
        done = done | sampled
        # LF step: symbol at row r from the packed words
        blk = r // OCC_BLOCK
        off = r - blk * OCC_BLOCK
        w = pk_rows[blk, off // WORD_SYMS]
        lane = (off % WORD_SYMS).astype(jnp.uint32)
        sym = ((w >> (2 * lane)) & 3).astype(jnp.int32)
        vbit = ((va_rows[blk, off // WORD_SYMS] >> (2 * lane)) & 1
                ).astype(jnp.int32)
        rk4 = _rank4(po, r, jnp)
        rankc = jnp.take_along_axis(rk4, sym[..., None], axis=-1)[..., 0]
        n_before = (r - rk4.sum(axis=-1)
                    - (r > primary).astype(jnp.int32))
        c_idx = jnp.where(vbit == 1, sym, 4)
        rankc = jnp.where(vbit == 1, rankc, n_before)
        newr = (C[c_idx] + rankc).astype(jnp.int32)
        r = jnp.where(done, r, newr)
        d = jnp.where(done, d, d + 1)
        return (r, d, val, done, it + 1)

    c0 = (r0, zero, zero, jnp.zeros(r0.shape, bool), jnp.int32(0))
    return jax.lax.while_loop(cond, body, c0)[2]


def make_sa_batch_device(d: DeviceOcc, ssa, sa_intv: int):
    """Returns a jitted rows→positions batched SA lookup with the occ
    tables and the sampled SA resident on device.  int32 positions —
    same <2^31-symbol limit as the rest of the device seeding path."""
    if int(d.n_rows) >= 1 << 31:
        raise ValueError("device SA lookup requires n_rows < 2^31")
    ssa_d = jnp.asarray(np.asarray(ssa, np.int64).astype(np.int32))
    fn = functools.partial(_sa_kernel, d.occ_rows, d.pk_rows, d.va_rows,
                           d.C, int(d.primary), int(d.n_rows), ssa_d,
                           int(sa_intv))
    return jax.jit(fn)


def collect_seeds_device(d: DeviceOcc, fm, reads, min_seed_len: int,
                         split_len: int, split_width: int, max_occ: int,
                         sa_fn=None, smem1_fn=None, all_fn=None):
    """Device-side seeding end to end: SMEM search + SA materialization
    on the chip, emitting (n, 4) int64 rows {read_idx, rbeg, qbeg, len}
    in the EXACT order csrc/smem.cpp bwamem_collect_seeds produces them
    — so NativePipeline.mp_chunk_start_seeded can consume either
    seeder's output interchangeably (pinned by tests/test_device_seed).

    The occurrence subsampling is bwa's mem.c rule: step = s // max_occ
    when s > max_occ, k = 0, step, 2·step, ... capped at max_occ."""
    if sa_fn is None:
        sa_fn = make_sa_batch_device(d, fm.ssa, fm.sa_intv)
    mems = collect_smems_device(d, fm, reads, min_seed_len, split_len,
                                split_width, smem1_fn=smem1_fn,
                                all_fn=all_fn)
    rows: list[int] = []
    meta: list[tuple[int, int, int]] = []
    for ri, ms in enumerate(mems):
        for m in ms:
            step = m.s // max_occ if m.s > max_occ else 1
            cnt = 0
            k = 0
            while k < m.s and cnt < max_occ:
                rows.append(m.x0 + k)
                meta.append((ri, m.qb, m.qe - m.qb))
                k += step
                cnt += 1
    if not rows:
        return np.zeros((0, 4), np.int64)
    n = len(rows)
    cap = 1 << max(8, (n - 1).bit_length())  # shape-bucketed: rare re-jits
    if getattr(sa_fn, "wide", False):
        # table-sharded wide twin (ops/smem_sharded.py): rows stay
        # int64 on the host; the twin splits them into (hi, lo) words
        padded = np.zeros(cap, np.int64)
        padded[:n] = np.asarray(rows, np.int64)
        vals = np.asarray(sa_fn(padded))[:n]
    else:
        padded = np.zeros(cap, np.int32)
        padded[:n] = np.asarray(rows, np.int64).astype(np.int32)
        vals = np.asarray(sa_fn(jnp.asarray(padded)))[:n]
    out = np.empty((n, 4), np.int64)
    out[:, 0] = [t[0] for t in meta]
    out[:, 1] = vals
    out[:, 2] = [t[1] for t in meta]
    out[:, 3] = [t[2] for t in meta]
    return out


def make_device_seeder(po: PackedOcc, fm, opt):
    """The production hook: a `seed_fn(reads) -> (n, 4) int64 rows`
    closure for NativePipeline.seed_fn / the CLI's --device-seed.
    Builds the DeviceOcc + jitted SA lookup once; each call runs the
    chunk's SMEM search and SA walks on the device."""
    d = DeviceOcc(po)
    sa_fn = make_sa_batch_device(d, fm.ssa, fm.sa_intv)
    all_fn = d.smem_all_jit()
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)

    def seed_fn(reads):
        return collect_seeds_device(
            d, fm, reads, opt.min_seed_len, split_len, opt.split_width,
            opt.max_occ, sa_fn=sa_fn, all_fn=all_fn)

    return seed_fn
