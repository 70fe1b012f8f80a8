"""Parity: the native C++ host pipeline (csrc/mempipe.cpp via
pipeline/native_driver.py) must produce byte-identical SAM to the
Python driver path (pipeline/driver.align_batch), which itself is
pinned to the scalar bwa-0.7.8 oracle by tests/test_driver.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bwamem_tpu.config import MemOptions
from bwamem_tpu.index.build import build_index
from bwamem_tpu.index.occ_packed import pack_occ
from bwamem_tpu.io.fasta import Contig, Reference
from bwamem_tpu.ops.extend_jax import ExtendParams, extend_batch_core
from bwamem_tpu.pipeline import native_driver
from bwamem_tpu.pipeline.align import revcomp_read
from bwamem_tpu.pipeline.driver import align_batch

pytestmark = pytest.mark.skipif(not native_driver.available(),
                                reason="native library unavailable")


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(42)
    # two contigs to exercise rid resolution and junction logic
    pac = rng.integers(0, 4, 120000).astype(np.uint8)
    ref = Reference(contigs=[Contig("chrA", 0, 70000),
                             Contig("chrB", 70000, 50000)], pac=pac)
    fm = build_index(pac)
    po = pack_occ(fm)
    return ref, fm, po, rng


def make_reads(rng, ref, n, read_len=120):
    reads, names, quals = [], [], []
    for i in range(n):
        pos = int(rng.integers(0, ref.l_pac - read_len - 20))
        r = ref.pac[pos:pos + read_len].astype(np.int64).copy()
        kind = i % 5
        if kind == 1:  # substitutions
            for _ in range(4):
                p = int(rng.integers(0, read_len))
                r[p] = (r[p] + 1 + rng.integers(0, 3)) % 4
        elif kind == 2:  # deletion in read
            d = int(rng.integers(1, 6))
            p = int(rng.integers(10, read_len - 10 - d))
            r = np.concatenate([r[:p], r[p + d:]])
        elif kind == 3:  # insertion in read
            ins = rng.integers(0, 4, int(rng.integers(1, 5)))
            p = int(rng.integers(10, read_len - 10))
            r = np.concatenate([r[:p], ins, r[p:]])
        elif kind == 4:  # junk / N-heavy (likely unmapped)
            if i % 10 == 4:
                r = rng.integers(0, 4, read_len).astype(np.int64)
            else:
                r[::3] = 4
        if rng.random() < 0.5:
            r = revcomp_read(r)
        reads.append(r)
        names.append(f"r{i}")
        quals.append("".join(chr(33 + int(x))
                             for x in rng.integers(20, 40, len(r))))
    return reads, names, quals


def _params(opt):
    return ExtendParams(
        mat_flat=jnp.asarray(opt.mat.astype(np.int32).ravel()), m=5,
        o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
        e_ins=opt.e_ins, zdrop=opt.zdrop)


def _backends(opt):
    params = _params(opt)
    row_fn = jax.jit(lambda *a: extend_batch_core(*a, params))
    raw_t_fn = native_driver.make_jax_raw_t_backend(params)
    return row_fn, raw_t_fn


def _compare(opt, world, n_reads, nthreads=1):
    ref, fm, po, rng = world
    reads, names, quals = make_reads(rng, ref, n_reads)
    row_fn, raw_t_fn = _backends(opt)
    want = align_batch(opt, ref, fm, reads, row_fn, names=names,
                       quals=quals, po=po)
    pipe = native_driver.NativePipeline(opt, ref, fm, po,
                                        nthreads=nthreads)
    got = pipe.align_chunk(reads, raw_t_fn, names=names, quals=quals)
    want_lines = [[r.line() for r in rr] for rr in want]
    got_lines = [[r.line() for r in rr] for rr in got]
    for i, (w, g) in enumerate(zip(want_lines, got_lines)):
        assert w == g, (i, w, g)


def test_sam_identical_defaults(world):
    _compare(MemOptions(), world, 40)


def test_sam_identical_no_a_xa(world):
    """-a off: XA tags and secondary suppression."""
    _compare(MemOptions(flag_a=False), world, 40)


def test_sam_identical_hard_clip(world):
    """-M off: supplementary records with hard clips."""
    _compare(MemOptions(flag_M=False), world, 40)


def test_sam_identical_threaded(world):
    _compare(MemOptions(), world, 60, nthreads=4)


def test_pe_native_regions_identical(world):
    """align_pairs through the native regions path == the Python path."""
    from bwamem_tpu.pipeline.pair import align_pairs

    opt = MemOptions()
    ref, fm, po, rng = world
    r1s, r2s = [], []
    for i in range(16):
        pos = int(rng.integers(0, ref.l_pac - 500))
        isize = 300 + int(rng.integers(-30, 30))
        r1 = ref.pac[pos:pos + 100].astype(np.int64)
        r2 = revcomp_read(
            ref.pac[pos + isize - 100:pos + isize].astype(np.int64))
        r1s.append(r1)
        r2s.append(r2)
    row_fn, raw_t_fn = _backends(opt)
    want = align_pairs(opt, ref, fm, r1s, r2s, po=po,
                       extend_batch_fn=row_fn)
    pipe = native_driver.NativePipeline(opt, ref, fm, po)
    got = align_pairs(opt, ref, fm, r1s, r2s, po=po,
                      native_pipe=pipe, raw_t_fn=raw_t_fn)
    assert [[r.line() for r in x] for x in want] == \
        [[r.line() for r in x] for x in got]


def _pe_world(rng, ref, n):
    r1s, r2s = [], []
    for i in range(n):
        pos = int(rng.integers(0, ref.l_pac - 500))
        isize = 300 + int(rng.integers(-30, 30))
        r1 = ref.pac[pos:pos + 100].astype(np.int64).copy()
        r2 = revcomp_read(
            ref.pac[pos + isize - 100:pos + isize].astype(np.int64))
        kind = i % 6
        if kind == 1:  # substitutions on read 1
            for _ in range(4):
                p = int(rng.integers(0, 100))
                r1[p] = (r1[p] + 1 + rng.integers(0, 3)) % 4
        elif kind == 2:  # heavily mutated mate -> rescue path
            m = ref.pac[pos + isize - 100:pos + isize].astype(
                np.int64).copy()
            for p in range(4, 100, 9):
                m[p] = (m[p] + 1 + rng.integers(0, 3)) % 4
            r2 = revcomp_read(m)
        elif kind == 3:  # unmappable mate (all N)
            r2 = np.full(100, 4, np.int64)
        r1s.append(r1)
        r2s.append(r2)
    return r1s, r2s


def test_pe_full_native_sam_identical(world):
    """The all-C++ PE path (mp_finalize_pe: pestat, mate rescue,
    pairing, sam_pe) == the Python align_pairs oracle, byte for byte,
    including rescued mates, unmapped ends, TLEN and mate fields."""
    from bwamem_tpu.pipeline.pair import align_pairs

    opt = MemOptions()
    ref, fm, po, rng = world
    r1s, r2s = _pe_world(rng, ref, 36)
    names = [f"p{i}" for i in range(36)]
    q1 = ["".join(chr(33 + int(x)) for x in rng.integers(20, 40, len(r)))
          for r in r1s]
    q2 = ["".join(chr(33 + int(x)) for x in rng.integers(20, 40, len(r)))
          for r in r2s]
    row_fn, raw_t_fn = _backends(opt)
    want = align_pairs(opt, ref, fm, r1s, r2s, names=names, quals1=q1,
                       quals2=q2, po=po, extend_batch_fn=row_fn)
    pipe = native_driver.NativePipeline(opt, ref, fm, po, nthreads=3)
    got = pipe.align_pairs_chunk(r1s, r2s, raw_t_fn, names=names,
                                 quals1=q1, quals2=q2)
    want_lines = [[r.line() for r in rr] for rr in want]
    got_lines = [[r.line() for r in rr] for rr in got]
    for i, (w, g) in enumerate(zip(want_lines, got_lines)):
        assert w == g, (i, w, g)


def test_pe_full_native_no_a(world):
    from bwamem_tpu.pipeline.pair import align_pairs

    opt = MemOptions(flag_a=False)
    ref, fm, po, rng = world
    r1s, r2s = _pe_world(rng, ref, 24)
    row_fn, raw_t_fn = _backends(opt)
    want = align_pairs(opt, ref, fm, r1s, r2s, po=po,
                       extend_batch_fn=row_fn)
    pipe = native_driver.NativePipeline(opt, ref, fm, po)
    got = pipe.align_pairs_chunk(r1s, r2s, raw_t_fn)
    assert [[r.line() for r in x] for x in want] == \
        [[r.line() for r in x] for x in got]


def test_pe_device_rescue_sam_identical(world):
    """The mem_matesw wave protocol (mp_rescue_* + the device-batched
    local SW, ops/local_jax.make_rescue_backend) == the all-C++ rescue
    path, byte for byte, on a rescue-heavy chunk — and the waves must
    actually fire (non-vacuous)."""
    from bwamem_tpu.ops.local_jax import make_rescue_backend

    opt = MemOptions()
    ref, fm, po, rng = world
    r1s, r2s = _pe_world(rng, ref, 40)
    # a few same-strand (discordant) mates: their proper-FR window is
    # untrained for that pair, so rescue fires beyond the mutated/all-N
    # mates _pe_world already plants
    for i in range(0, 40, 7):
        r2s[i] = revcomp_read(r2s[i])
    row_fn, raw_t_fn = _backends(opt)
    want = native_driver.NativePipeline(
        opt, ref, fm, po, nthreads=2).align_pairs_chunk(r1s, r2s,
                                                        raw_t_fn)
    base = make_rescue_backend()
    calls = []

    def counting(*a):
        calls.append(a[0].shape)
        return base(*a)

    got = native_driver.NativePipeline(
        opt, ref, fm, po, nthreads=2).align_pairs_chunk(
        r1s, r2s, raw_t_fn, rescue_fn=counting)
    assert calls, "no rescue wave fired — vacuous comparison"
    assert [[r.line() for r in x] for x in want] == \
        [[r.line() for r in x] for x in got]


def test_pe_device_rescue_idx_sam_identical(world):
    """The resident-reference rescue waves (mp_rescue_fill_idx: meta
    only, mate sequence + window gathered on device with in-lane
    revcomp) == the all-C++ rescue path, byte for byte, non-vacuously."""
    opt = MemOptions()
    ref, fm, po, rng = world
    r1s, r2s = _pe_world(rng, ref, 40)
    for i in range(0, 40, 7):
        r2s[i] = revcomp_read(r2s[i])
    row_fn, raw_t_fn = _backends(opt)
    want = native_driver.NativePipeline(
        opt, ref, fm, po, nthreads=2).align_pairs_chunk(r1s, r2s,
                                                        raw_t_fn)
    base = native_driver.make_rescue_idx_backend(ref.pac)
    calls = []

    def counting(*a):
        calls.append(a[1].shape)
        return base(*a)

    counting.idx = True
    got = native_driver.NativePipeline(
        opt, ref, fm, po, nthreads=2).align_pairs_chunk(
        r1s, r2s, raw_t_fn, rescue_fn=counting)
    assert calls, "no rescue wave fired — vacuous comparison"
    assert [[r.line() for r in x] for x in want] == \
        [[r.line() for r in x] for x in got]


def test_se_device_cigar_sam_identical(world):
    """The mp_cigar_* round protocol (device-batched banded global
    align + traceback, ops/global_jax.make_cigar_backend) == the
    host-C++ reg2aln path, byte for byte, and the rounds must actually
    fire (non-vacuous)."""
    from bwamem_tpu.ops.global_jax import make_cigar_backend

    opt = MemOptions()
    ref, fm, po, rng = world
    reads, names, quals = make_reads(rng, ref, 48)
    row_fn, raw_t_fn = _backends(opt)
    want = native_driver.NativePipeline(
        opt, ref, fm, po, nthreads=2).align_chunk(
        reads, raw_t_fn, names=names, quals=quals)
    base = make_cigar_backend()
    calls = []

    def counting(*a):
        calls.append(a[0].shape)
        return base(*a)

    got = native_driver.NativePipeline(
        opt, ref, fm, po, nthreads=2).align_chunk(
        reads, raw_t_fn, names=names, quals=quals, cigar_fn=counting)
    assert calls, "no cigar round fired — vacuous comparison"
    want_lines = [[r.line() for r in rr] for rr in want]
    got_lines = [[r.line() for r in rr] for rr in got]
    for i, (w, g) in enumerate(zip(want_lines, got_lines)):
        assert w == g, (i, w, g)


def test_se_device_cigar_flag_a(world):
    """Device-CIGAR rounds under -a (every passing region emitted)."""
    from bwamem_tpu.ops.global_jax import make_cigar_backend

    opt = MemOptions(flag_a=True)
    ref, fm, po, rng = world
    reads, names, quals = make_reads(rng, ref, 24)
    row_fn, raw_t_fn = _backends(opt)
    want = native_driver.NativePipeline(
        opt, ref, fm, po).align_chunk(reads, raw_t_fn, names=names,
                                      quals=quals)
    got = native_driver.NativePipeline(
        opt, ref, fm, po).align_chunk(reads, raw_t_fn, names=names,
                                      quals=quals,
                                      cigar_fn=make_cigar_backend())
    assert [[r.line() for r in x] for x in want] == \
        [[r.line() for r in x] for x in got]


def test_pe_device_cigar_and_rescue_sam_identical(world):
    """PE with BOTH device protocols (mp_rescue_* waves + mp_cigar_*
    rounds over the candidate superset) == the all-C++ PE path, byte
    for byte; both protocols must fire."""
    from bwamem_tpu.ops.global_jax import make_cigar_backend
    from bwamem_tpu.ops.local_jax import make_rescue_backend

    opt = MemOptions()
    ref, fm, po, rng = world
    r1s, r2s = _pe_world(rng, ref, 36)
    for i in range(0, 36, 9):
        r2s[i] = revcomp_read(r2s[i])
    row_fn, raw_t_fn = _backends(opt)
    want = native_driver.NativePipeline(
        opt, ref, fm, po, nthreads=2).align_pairs_chunk(r1s, r2s,
                                                        raw_t_fn)
    rcalls, ccalls = [], []
    rbase, cbase = make_rescue_backend(), make_cigar_backend()

    def rcount(*a):
        rcalls.append(a[0].shape)
        return rbase(*a)

    def ccount(*a):
        ccalls.append(a[0].shape)
        return cbase(*a)

    got = native_driver.NativePipeline(
        opt, ref, fm, po, nthreads=2).align_pairs_chunk(
        r1s, r2s, raw_t_fn, rescue_fn=rcount, cigar_fn=ccount)
    assert rcalls and ccalls, (rcalls, ccalls)
    assert [[r.line() for r in x] for x in want] == \
        [[r.line() for r in x] for x in got]


def test_pe_device_cigar_only_sam_identical(world):
    """cigar_fn without rescue_fn: rescue stays host C++
    (mp_rescue_host) and only the sam_pe globals go to the device."""
    from bwamem_tpu.ops.global_jax import make_cigar_backend

    opt = MemOptions()
    ref, fm, po, rng = world
    r1s, r2s = _pe_world(rng, ref, 24)
    row_fn, raw_t_fn = _backends(opt)
    want = native_driver.NativePipeline(
        opt, ref, fm, po).align_pairs_chunk(r1s, r2s, raw_t_fn)
    got = native_driver.NativePipeline(
        opt, ref, fm, po).align_pairs_chunk(
        r1s, r2s, raw_t_fn, cigar_fn=make_cigar_backend())
    assert [[r.line() for r in x] for x in want] == \
        [[r.line() for r in x] for x in got]


def test_fused_sam_identical(world):
    """The fused one-call protocol (mp_prepare_fused + the platform's
    fused step) == the Python oracle SAM byte for byte —
    i.e. in-step band-doubling retry and in-lane left->right h0
    chaining reproduce the four-pass protocol exactly."""
    opt = MemOptions()
    ref, fm, po, rng = world
    reads, names, quals = make_reads(rng, ref, 32)
    row_fn, _ = _backends(opt)
    fused_fn = native_driver.make_fused_backend(_params(opt))
    want = align_batch(opt, ref, fm, reads, row_fn, names=names,
                       quals=quals, po=po)
    pipe = native_driver.NativePipeline(opt, ref, fm, po)
    got = pipe.align_chunk(reads, fused_fn, names=names, quals=quals)
    want_lines = [[r.line() for r in rr] for rr in want]
    got_lines = [[r.line() for r in rr] for rr in got]
    for i, (w, g) in enumerate(zip(want_lines, got_lines)):
        assert w == g, (i, w, g)


def test_fused_pe_sam_identical(world):
    """Fused protocol through the all-C++ PE path == Python PE oracle."""
    from bwamem_tpu.pipeline.pair import align_pairs

    opt = MemOptions()
    ref, fm, po, rng = world
    r1s, r2s = _pe_world(rng, ref, 18)
    row_fn, _ = _backends(opt)
    fused_fn = native_driver.make_fused_backend(_params(opt))
    want = align_pairs(opt, ref, fm, r1s, r2s, po=po,
                       extend_batch_fn=row_fn)
    pipe = native_driver.NativePipeline(opt, ref, fm, po)
    got = pipe.align_pairs_chunk(r1s, r2s, fused_fn)
    assert [[r.line() for r in x] for x in want] == \
        [[r.line() for r in x] for x in got]


def test_se_device_cigar_idx_sam_identical(world):
    """The resident-reference CIGAR rounds (mp_cigar_fill_idx: meta
    only, segments gathered on device with reverse-strand walks) ==
    the host-C++ reg2aln path, byte for byte, non-vacuously."""
    opt = MemOptions()
    ref, fm, po, rng = world
    reads, names, quals = make_reads(rng, ref, 48)
    row_fn, raw_t_fn = _backends(opt)
    want = native_driver.NativePipeline(
        opt, ref, fm, po, nthreads=2).align_chunk(
        reads, raw_t_fn, names=names, quals=quals)
    base = native_driver.make_cigar_idx_backend(ref.pac)
    calls = []

    def counting(*a):
        calls.append(a[1].shape)
        return base(*a)

    counting.idx = True
    got = native_driver.NativePipeline(
        opt, ref, fm, po, nthreads=2).align_chunk(
        reads, raw_t_fn, names=names, quals=quals, cigar_fn=counting)
    assert calls, "no cigar round fired — vacuous comparison"
    assert [[r.line() for r in x] for x in want] == \
        [[r.line() for r in x] for x in got]


def test_pe_device_cigar_idx_sam_identical(world):
    """Resident-reference CIGAR rounds through the PE path (regions on
    both strands, mate fields) == the host-C++ path."""
    opt = MemOptions()
    ref, fm, po, rng = world
    r1s, r2s = _pe_world(rng, ref, 24)
    row_fn, raw_t_fn = _backends(opt)
    want = native_driver.NativePipeline(
        opt, ref, fm, po).align_pairs_chunk(r1s, r2s, raw_t_fn)
    fn = native_driver.make_cigar_idx_backend(ref.pac)
    got = native_driver.NativePipeline(
        opt, ref, fm, po).align_pairs_chunk(
        r1s, r2s, raw_t_fn, cigar_fn=fn)
    assert [[r.line() for r in x] for x in want] == \
        [[r.line() for r in x] for x in got]


def test_fused_idx_sam_identical(world):
    """The resident-reference fused path (mp_fill_fused_idx: scalars
    only, device-side query/target window gathers from the two-strand
    text) == the Python oracle SAM byte for byte."""
    opt = MemOptions()
    ref, fm, po, rng = world
    reads, names, quals = make_reads(rng, ref, 32)
    row_fn, _ = _backends(opt)
    fn = native_driver.make_fused_idx_backend(_params(opt), ref.pac)
    want = align_batch(opt, ref, fm, reads, row_fn, names=names,
                       quals=quals, po=po)
    pipe = native_driver.NativePipeline(opt, ref, fm, po)
    got = pipe.align_chunk(reads, fn, names=names, quals=quals)
    assert [[r.line() for r in rr] for rr in want] == \
        [[r.line() for r in rr] for rr in got]


def test_text_gather_window_fuzz():
    """Direct unit fuzz of the word-aligned window gather (the
    production target-window path of every resident-reference backend)
    against the per-symbol oracle _text_gather: word-straddling start
    offsets, off==0 starts (the shift-by-32 guard), descending windows
    (sign=-1), negative starts (padded reverse-strand CIGAR lanes),
    the 2^20 hi/lo split, and text-edge word clamping — every sharp
    edge of native_driver._text_gather_window."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    # odd length => the packed text ends in a partial word padded with N
    pac = rng.integers(0, 5, (1 << 20) + 1237).astype(np.uint8)
    text = jnp.asarray(native_driver.two_strand_text_packed(pac))
    n = 2 * len(pac)  # two-strand symbol count, > 2^21: real hi values

    def oracle(lo, hi, length, sign):
        j = np.arange(length, dtype=np.int32)[:, None]
        return np.asarray(native_driver._text_gather(
            text, jnp.asarray(lo[None, :] + sign * j),
            jnp.asarray(np.broadcast_to(hi, (length, len(lo))))))

    for length in (17, 64, 129, 320):
        B = 128
        pos = rng.integers(0, n - length, B).astype(np.int64)
        pos[0] = 0                        # text start
        pos[1] = 8                        # off == 0, word-aligned
        pos[2] = n - length               # right at the tail pad
        pos[3] = 7                        # straddles the first word
        pos[4] = (1 << 20) - 3            # straddles the hi/lo split
        pos[5] = (1 << 21) - length // 2  # hi=1 region
        # production encoding: hi = pos >> 20, lo = pos & 0xFFFFF, and
        # lo may absorb signed offsets (descending walks, padding)
        hi = (pos >> 20).astype(np.int32)
        lo = (pos & 0xFFFFF).astype(np.int32)
        lo[6] -= 1 << 20                  # borrow absorbed into lo
        hi[6] += 1
        lo[7] = -5                        # negative start (padded lane)
        hi[7] = 0
        for sign in (1, -1):
            los = lo if sign > 0 else lo + length - 1
            got = np.asarray(native_driver._text_gather_window(
                text, jnp.asarray(los), jnp.asarray(hi), length, sign))
            want = oracle(los, hi, length, sign)
            assert (got == want).all(), (length, sign)


def test_fused_idx_bucket_split_sam_identical(world):
    """The two-dispatch shape-bucketed fused chunk (bucket_split: big
    lanes at the chunk-global dims, percentile-fitting lanes at a
    smaller static shape, results scattered back by lane index) is SAM
    byte-identical to the single-dispatch path — padding must never
    change kernel results."""
    opt = MemOptions()
    ref, fm, po, rng = world
    # mixed read lengths so the two shape buckets are both non-empty
    reads, names, quals = make_reads(rng, ref, 16)
    r2, n2, q2 = make_reads(rng, ref, 16, read_len=60)
    reads += r2
    names += [s + "b" for s in n2]
    quals += q2
    fn = native_driver.make_fused_idx_backend(_params(opt), ref.pac)
    calls = []
    orig = fn

    def counting(*a, **k):
        calls.append(a[1].shape)
        return orig(*a, **k)

    counting.fused = True
    counting.idx = True
    pipe = native_driver.NativePipeline(opt, ref, fm, po)
    want = pipe.align_chunk(reads, fn, names=names, quals=quals)
    pipe2 = native_driver.NativePipeline(opt, ref, fm, po,
                                         bucket_split=True)
    pipe2.split_min = 4
    got = pipe2.align_chunk(reads, counting, names=names, quals=quals)
    assert len(calls) == 2, f"split did not fire: {calls}"
    assert [[r.line() for r in rr] for rr in want] == \
        [[r.line() for r in rr] for rr in got]


def test_fused_idx_pe_sam_identical(world):
    """Resident-reference fused path through the all-C++ PE pipeline
    == the Python PE oracle."""
    from bwamem_tpu.pipeline.pair import align_pairs

    opt = MemOptions()
    ref, fm, po, rng = world
    r1s, r2s = _pe_world(rng, ref, 18)
    row_fn, _ = _backends(opt)
    fn = native_driver.make_fused_idx_backend(_params(opt), ref.pac)
    want = align_pairs(opt, ref, fm, r1s, r2s, po=po,
                       extend_batch_fn=row_fn)
    pipe = native_driver.NativePipeline(opt, ref, fm, po)
    got = pipe.align_pairs_chunk(r1s, r2s, fn)
    assert [[r.line() for r in x] for x in want] == \
        [[r.line() for r in x] for x in got]


def test_fused_idx_n_bases_reference(world):
    """A reference with N runs (code 4): the resident text must carry
    them through the device gathers (strand fold keeps 4) identically
    to the host-shipped payload path — reads anchored next to N
    stretches still align the same."""
    opt = MemOptions()
    rng = np.random.default_rng(7)
    pac = rng.integers(0, 4, 50000).astype(np.uint8)
    for p in range(0, 50000, 4000):  # scattered ambiguity runs
        pac[p:p + int(rng.integers(5, 40))] = 4
    ref = Reference(contigs=[Contig("cN", 0, 50000)], pac=pac)
    fm = build_index(pac)
    po = pack_occ(fm)
    reads = []
    for i in range(24):
        pos = int(rng.integers(0, 50000 - 140))
        r = pac[pos:pos + 120].astype(np.int64).copy()
        for _ in range(3):
            q = int(rng.integers(0, 120))
            r[q] = (r[q] + 1) % 4
        if i % 2:
            r = revcomp_read(r)
        reads.append(r)
    ship = native_driver.make_fused_backend(_params(opt))
    idx = native_driver.make_fused_idx_backend(_params(opt), ref.pac)
    want = native_driver.NativePipeline(
        opt, ref, fm, po).align_chunk(reads, ship)
    got = native_driver.NativePipeline(
        opt, ref, fm, po).align_chunk(reads, idx)
    assert [[r.line() for r in rr] for rr in want] == \
        [[r.line() for r in rr] for rr in got]


def test_sa_tag_split_reads(world):
    """Chimeric reads (left half from chrA, right half from chrB)
    produce primary + supplementary records that cross-reference each
    other via SA:Z (bwa mem_aln2sam); native == Python byte for byte.
    flag_M off so the split mate keeps 0x800 (with -M it becomes 0x100
    per bwa but SA still appears — also asserted)."""
    opt = MemOptions(flag_M=False)
    ref, fm, po, rng = world
    reads, names, quals = [], [], []
    for i in range(12):
        pa = int(rng.integers(0, 60000))
        pb = int(rng.integers(72000, 115000))
        r = np.concatenate([ref.pac[pa:pa + 70],
                            ref.pac[pb:pb + 70]]).astype(np.int64)
        reads.append(r)
        names.append(f"chim{i}")
        quals.append("I" * len(r))
    row_fn, raw_t_fn = _backends(opt)
    want = align_batch(opt, ref, fm, reads, row_fn, names=names,
                       quals=quals, po=po)
    pipe = native_driver.NativePipeline(opt, ref, fm, po)
    got = pipe.align_chunk(reads, raw_t_fn, names=names, quals=quals)
    assert [[r.line() for r in rr] for rr in want] == \
        [[r.line() for r in rr] for rr in got]
    n_sa = n_supp = 0
    for rr in want:
        lines = [r.line() for r in rr]
        for l in lines:
            flag = int(l.split("\t")[1])
            if flag & 0x800:
                n_supp += 1
            if "\tSA:Z:" in l:
                n_sa += 1
                # each SA entry names a real contig and ends with ';'
                sa = l.split("SA:Z:")[1].split("\t")[0]
                assert sa.endswith(";")
                assert sa.split(",")[0] in ("chrA", "chrB")
    assert n_supp >= 8, n_supp
    assert n_sa >= 2 * n_supp, (n_sa, n_supp)  # primary + supp both tagged

    # -M: the split hit is remapped to 0x100 but SA survives
    optM = MemOptions()
    wantM = align_batch(optM, ref, fm, reads, row_fn, names=names,
                        quals=quals, po=po)
    pipeM = native_driver.NativePipeline(optM, ref, fm, po)
    gotM = pipeM.align_chunk(reads, raw_t_fn, names=names, quals=quals)
    assert [[r.line() for r in rr] for rr in wantM] == \
        [[r.line() for r in rr] for rr in gotM]
    assert sum("\tSA:Z:" in r.line() for rr in wantM for r in rr) >= 16


def test_chunk_text_blob_parity(world):
    """align_chunk_text / align_pairs_chunk_text (the zero-object emit
    fast path) == the per-record SamLine output, byte for byte."""
    opt = MemOptions()
    ref, fm, po, rng = world
    reads, names, quals = make_reads(rng, ref, 24)
    row_fn, raw_t_fn = _backends(opt)
    want = native_driver.NativePipeline(
        opt, ref, fm, po).align_chunk(reads, raw_t_fn, names=names,
                                      quals=quals)
    want_text = "".join(r.line() + "\n" for rr in want for r in rr)
    text, nrec = native_driver.NativePipeline(
        opt, ref, fm, po).align_chunk_text(reads, raw_t_fn, names=names,
                                           quals=quals)
    assert text == want_text
    assert nrec == sum(len(rr) for rr in want)

    r1s, r2s = _pe_world(rng, ref, 12)
    want_pe = native_driver.NativePipeline(
        opt, ref, fm, po).align_pairs_chunk(r1s, r2s, raw_t_fn)
    want_pe_text = "".join(r.line() + "\n" for rr in want_pe for r in rr)
    text_pe, nrec_pe = native_driver.NativePipeline(
        opt, ref, fm, po).align_pairs_chunk_text(r1s, r2s, raw_t_fn)
    assert text_pe == want_pe_text
    assert nrec_pe == sum(len(rr) for rr in want_pe)


def test_pe_text_with_idx_rescue(world):
    """The zero-object PE text path composed with resident-reference
    device rescue (the stress-bench configuration) == the per-record
    path, byte for byte, with rescue actually firing."""
    opt = MemOptions()
    ref, fm, po, rng = world
    r1s, r2s = _pe_world(rng, ref, 30)
    for i in range(0, 30, 6):
        r2s[i] = revcomp_read(r2s[i])  # discordant: rescue fires
    row_fn, raw_t_fn = _backends(opt)
    resc = native_driver.make_rescue_idx_backend(ref.pac)
    calls = []

    def counting(*a):
        calls.append(a[1].shape)
        return resc(*a)

    counting.idx = True
    want = native_driver.NativePipeline(
        opt, ref, fm, po).align_pairs_chunk(r1s, r2s, raw_t_fn,
                                            rescue_fn=counting)
    want_text = "".join(r.line() + "\n" for rr in want for r in rr)
    text, nrec = native_driver.NativePipeline(
        opt, ref, fm, po).align_pairs_chunk_text(r1s, r2s, raw_t_fn,
                                                 rescue_fn=counting)
    assert calls, "no rescue wave fired — vacuous comparison"
    assert text == want_text
    assert nrec == sum(len(rr) for rr in want)


def test_pe_text_with_idx_cigar(world):
    """The zero-object PE text path composed with resident-reference
    device CIGAR rounds == the per-record path, byte for byte."""
    opt = MemOptions()
    ref, fm, po, rng = world
    r1s, r2s = _pe_world(rng, ref, 16)
    row_fn, raw_t_fn = _backends(opt)
    cig = native_driver.make_cigar_idx_backend(ref.pac)
    want = native_driver.NativePipeline(
        opt, ref, fm, po).align_pairs_chunk(r1s, r2s, raw_t_fn,
                                            cigar_fn=cig)
    want_text = "".join(r.line() + "\n" for rr in want for r in rr)
    text, nrec = native_driver.NativePipeline(
        opt, ref, fm, po).align_pairs_chunk_text(r1s, r2s, raw_t_fn,
                                                 cigar_fn=cig)
    assert text == want_text
    assert nrec == sum(len(rr) for rr in want)


def test_fused_idx_boundary_positions(world):
    """Reads anchored at the very start/end of the reference (left
    target walks hit two-strand position 0 / 2*l_pac-1): host-shipped
    payload == resident-reference window gathers, byte for byte."""
    opt = MemOptions()
    ref, fm, po, rng = world
    pac = ref.pac
    L = len(pac)
    reads = [
        pac[0:100].astype(np.int64),
        revcomp_read(pac[0:100].astype(np.int64)),
        pac[L - 100:L].astype(np.int64),
        revcomp_read(pac[L - 100:L].astype(np.int64)),
    ]
    for i, r in enumerate(reads):
        r = r.copy()
        r[50] = (r[50] + 1) % 4
        reads[i] = r
    ship = native_driver.make_fused_backend(_params(opt))
    idx = native_driver.make_fused_idx_backend(_params(opt), pac)
    outs = []
    for fn in (ship, idx):
        pipe = native_driver.NativePipeline(opt, ref, fm, po)
        outs.append([[r.line() for r in rr]
                     for rr in pipe.align_chunk(reads, fn)])
    assert outs[0] == outs[1]


def test_native_random_options_fuzz(world):
    """Native SAM == Python SAM under randomized MemOptions (scoring,
    seed length, band, zdrop) — the runtime-parameter plumbing holds
    across the whole option space, not just defaults."""
    ref, fm, po, rng = world
    for trial in range(3):
        opt = MemOptions(
            a=int(rng.integers(1, 3)),
            b=int(rng.integers(2, 7)),
            o_del=int(rng.integers(4, 9)),
            e_del=int(rng.integers(1, 3)),
            o_ins=int(rng.integers(4, 9)),
            e_ins=int(rng.integers(1, 3)),
            w=int(rng.integers(40, 150)),
            zdrop=int(rng.integers(50, 200)),
            min_seed_len=int(rng.integers(15, 25)),
            T=int(rng.integers(20, 40)),
            flag_M=bool(rng.integers(0, 2)),
            flag_a=bool(rng.integers(0, 2)),
        )
        reads, names, quals = make_reads(rng, ref, 20)
        row_fn, raw_t_fn = _backends(opt)
        want = align_batch(opt, ref, fm, reads, row_fn, names=names,
                           quals=quals, po=po)
        pipe = native_driver.NativePipeline(opt, ref, fm, po)
        got = pipe.align_chunk(reads, raw_t_fn, names=names, quals=quals)
        assert [[r.line() for r in rr] for rr in want] == \
            [[r.line() for r in rr] for rr in got], f"trial {trial}: {opt}"


def test_pe_mixed_read_lengths(world):
    """PE with different read lengths per end (150 vs 100 bp) and per
    pair: padding in the read matrix, TLEN and rescue windows stay
    correct; native == Python."""
    from bwamem_tpu.pipeline.pair import align_pairs

    opt = MemOptions()
    ref, fm, po, rng = world
    r1s, r2s = [], []
    for i in range(16):
        l1 = int(rng.integers(80, 151))
        l2 = int(rng.integers(60, 121))
        pos = int(rng.integers(0, ref.l_pac - 500))
        a = ref.pac[pos:pos + l1].astype(np.int64).copy()
        b = revcomp_read(ref.pac[pos + 300 - l2:pos + 300]
                         .astype(np.int64))
        p = int(rng.integers(0, l1))
        a[p] = (a[p] + 1) % 4
        r1s.append(a)
        r2s.append(b)
    row_fn, raw_t_fn = _backends(opt)
    want = align_pairs(opt, ref, fm, r1s, r2s, po=po,
                       extend_batch_fn=row_fn)
    pipe = native_driver.NativePipeline(opt, ref, fm, po)
    got = pipe.align_pairs_chunk(r1s, r2s, raw_t_fn)
    assert [[r.line() for r in x] for x in want] == \
        [[r.line() for r in x] for x in got]


def test_tiny_and_unmappable_reads(world):
    """Reads below the seed length, all-N reads and random (unmappable)
    reads flow through the native pipeline as unmapped records without
    crashing; native == Python."""
    opt = MemOptions()
    ref, fm, po, rng = world
    reads = [
        ref.pac[100:115].astype(np.int64),           # 15 bp < k
        np.full(50, 4, np.int64),                     # all N
        rng.integers(0, 4, 120).astype(np.int64),     # random junk
        ref.pac[500:620].astype(np.int64),            # mappable control
    ]
    names = [f"edge{i}" for i in range(len(reads))]
    quals = [None] * len(reads)
    row_fn, raw_t_fn = _backends(opt)
    want = align_batch(opt, ref, fm, reads, row_fn, names=names,
                       quals=quals, po=po)
    pipe = native_driver.NativePipeline(opt, ref, fm, po)
    got = pipe.align_chunk(reads, raw_t_fn, names=names, quals=quals)
    assert [[r.line() for r in rr] for rr in want] == \
        [[r.line() for r in rr] for rr in got]
    flags = [want[0][0].flag, want[1][0].flag]
    assert all(f & 0x4 for f in flags), flags  # tiny + all-N unmapped
    assert not (want[3][0].flag & 0x4)


def test_regions_match_compute_regions(world):
    """regions_chunk == the Python compute_regions pipeline (PE input)."""
    from bwamem_tpu.pipeline.align import compute_regions
    from bwamem_tpu.pipeline.chain import chain_reads_batch
    from bwamem_tpu.pipeline.driver import (
        extension_tables,
        table_extend_fn,
    )

    opt = MemOptions()
    ref, fm, po, rng = world
    reads, _, _ = make_reads(rng, ref, 30)
    row_fn, raw_t_fn = _backends(opt)
    chains = chain_reads_batch(fm, po, reads, opt)
    tables = extension_tables(opt, ref, reads, chains, row_fn)
    want = [
        compute_regions(opt, ref, fm, r, table_extend_fn(tables[i]),
                        chains=chains[i])
        for i, r in enumerate(reads)
    ]
    pipe = native_driver.NativePipeline(opt, ref, fm, po)
    got = pipe.regions_chunk(reads, raw_t_fn)
    for i, (w, g) in enumerate(zip(want, got)):
        wt = [(r.rb, r.re, r.qb, r.qe, r.score, r.truesc, r.w, r.seedcov,
               r.seedlen0) for r in w]
        gt = [(r.rb, r.re, r.qb, r.qe, r.score, r.truesc, r.w, r.seedcov,
               r.seedlen0) for r in g]
        assert wt == gt, i
