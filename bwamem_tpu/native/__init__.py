"""Native (C++) components, loaded via ctypes.

The reference's native code is its RTL + the C host (SURVEY.md §2);
ours is csrc/*.cpp compiled to a shared library.  The library builds
with g++ on first use, for the machine that loads it (-march=native),
into bwamem_tpu/native/build/.  Its file name carries a hash of the
sources, the compiler command and the host (machine, CPU model), so a
source edit or a move to another machine builds afresh and a library
built elsewhere is never loaded.  Every native path has a pure-numpy
fallback, so the package works without a toolchain; `require()` is the
hard form for callers that asked for the native host explicitly.

`cuda_library()` builds the GPU kernels (csrc/cuda/*.cu) the same way
with nvcc for Hopper (sm_90a), keyed by their sources and the command.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, os.pardir, os.pardir, "csrc")
_BUILD = os.path.join(_HERE, "build")
_CXX = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_lib = None
_error: str | None = None


def _sources() -> list[str]:
    return [os.path.join(_CSRC, f) for f in sorted(os.listdir(_CSRC))
            if f.endswith(".cpp")]


def _host_id() -> str:
    """The build target: machine and CPU model (what -march=native
    reads), so a library is only reused on the kind of host that
    built it."""
    cpu = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    cpu += line
    except OSError:
        cpu = platform.processor()
    return f"{platform.machine()}\n{cpu}"


def library_path(srcs=None) -> str:
    """Where the library built from `srcs` for this host lives."""
    h = hashlib.sha256()
    for part in (" ".join(_CXX), _host_id()):
        h.update(part.encode())
    for src in srcs if srcs is not None else _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD, f"libbwamem-{h.hexdigest()[:16]}.so")


def _build(srcs, so) -> str | None:
    """Compile `srcs` into `so`; returns None or the compiler's error."""
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.part"
    try:
        r = subprocess.run(_CXX + ["-o", tmp] + srcs, capture_output=True,
                           text=True, timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{' '.join(_CXX)}: {e}"
    if r.returncode != 0:
        return r.stderr or f"g++ exited with {r.returncode}"
    os.replace(tmp, so)
    return None


def get_lib():
    """The loaded shared library, or None if it cannot be built."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        srcs = _sources()
        if not srcs:
            _error = f"no C++ sources under {_CSRC}"
            return None
        so = library_path(srcs)
        if not os.path.exists(so):
            _error = _build(srcs, so)
            if _error is not None:
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            _error = str(e)
            return None
        lib.bwamem_sais_u8.restype = ctypes.c_int
        lib.bwamem_sais_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64]
        lib.bwamem_sais_bwt_u8.restype = ctypes.c_int
        lib.bwamem_sais_bwt_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.bwamem_fastq_scan.restype = ctypes.c_int64
        lib.bwamem_fastq_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        p8 = ctypes.POINTER(ctypes.c_int8)
        p32 = ctypes.POINTER(ctypes.c_int32)
        lib.bwamem_banded_fused_host.restype = None
        lib.bwamem_banded_fused_host.argtypes = [
            p8, p8, p8, p8, p32, p32, p32, p32, ctypes.c_int64,
            ctypes.c_int64]
        _bind_smem(lib)
        _bind_ksw(lib)
        _bind_mempipe(lib)
        _lib = lib
        return _lib


def require():
    """The library, or a RuntimeError carrying the compiler's output."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native library unavailable:\n{_error}")
    return lib


_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]


def cuda_library() -> str:
    """Path of the CUDA kernels' shared library, built with nvcc on first
    use; raises RuntimeError with nvcc's output when the build fails."""
    import jax
    import jax.ffi

    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    cuda = os.path.join(_CSRC, "cuda")
    srcs = [os.path.join(cuda, f) for f in sorted(os.listdir(cuda))
            if f.endswith(".cu")]
    deps = srcs + [os.path.join(_CSRC, "banded_extend.h")]
    cmd = [nvcc, *_NVCC_FLAGS, "-I", jax.ffi.include_dir()]
    h = hashlib.sha256(" ".join(_NVCC_FLAGS + [jax.__version__]).encode())
    for dep in deps:
        with open(dep, "rb") as f:
            h.update(f.read())
    so = os.path.join(_BUILD, f"libbwamem_cuda-{h.hexdigest()[:16]}.so")
    with _lock:
        if os.path.exists(so):
            return so
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.part"
        r = subprocess.run(cmd + ["-o", tmp] + srcs, capture_output=True,
                           text=True, timeout=900)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{r.stderr}")
        os.replace(tmp, so)
    return so


def banded_fused_host(ql, tl, qr, tr, scal, prm) -> np.ndarray:
    """The CUDA kernel's fused lanes (csrc/banded_extend.h) run on the
    host: same arguments and (32, B) result as ops/extend_step.fused_xla.
    For tests; raises when the library is unavailable."""
    lib = require()
    ql, tl, qr, tr = (np.ascontiguousarray(x, np.int8)
                      for x in (ql, tl, qr, tr))
    scal = np.ascontiguousarray(scal, np.int32)
    prm = np.ascontiguousarray(prm, np.int32)
    if scal.shape[0] < 10 or not (
            ql.shape[1] == tl.shape[1] == qr.shape[1] == tr.shape[1]
            == scal.shape[1]):
        raise ValueError("banded_fused_host: mismatched lane counts")
    B = scal.shape[1]
    eh_rows = max(ql.shape[0], qr.shape[0]) + 1
    out = np.zeros((32, B), np.int32)
    eh = np.zeros((2, eh_rows, B), np.int32)
    p8 = ctypes.POINTER(ctypes.c_int8)
    p32 = ctypes.POINTER(ctypes.c_int32)
    lib.bwamem_banded_fused_host(
        *(x.ctypes.data_as(p8) for x in (ql, tl, qr, tr)),
        scal.ctypes.data_as(p32), prm.ctypes.data_as(p32),
        out.ctypes.data_as(p32), eh.ctypes.data_as(p32), B, eh_rows)
    return out


def sais_u8(s: np.ndarray) -> np.ndarray | None:
    """Linear-time suffix array of uint8 codes via the C++ SA-IS, or
    None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(s, np.uint8)
    n = len(s)
    sa = np.empty(n, np.int64)
    rc = lib.bwamem_sais_u8(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, int(s.max(initial=0)) + 1)
    return sa if rc == 0 else None


def sais_bwt_u8(s: np.ndarray, sa_intv: int):
    """Memory-bounded BWT construction: packed 40-bit SA-IS emitting
    (bwt, ssa, primary) directly — ~8.3 bytes/symbol peak vs ~17 for
    the int64 SA path, which is what makes a GRCh38-scale two-strand
    build (6.2 Gsym) fit this host.  Returns None if the native
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(s, np.uint8)
    n = len(s)
    bwt = np.empty(n + 1, np.uint8)
    ssa = np.empty(n // sa_intv + 1, np.int64)
    primary = ctypes.c_int64(-1)
    rc = lib.bwamem_sais_bwt_u8(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
        bwt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ssa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sa_intv, ctypes.byref(primary))
    if rc != 0:
        return None
    return bwt, ssa, int(primary.value)


def fastq_scan(buf: bytes, max_rec: int = 1 << 22):
    """Native record scan: returns (n, offsets (n,5) int64) or None."""
    lib = get_lib()
    if lib is None:
        return None
    off = np.empty((max_rec, 5), np.int64)
    n = lib.bwamem_fastq_scan(
        buf, len(buf), max_rec,
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if n < 0:
        return None
    return int(n), off[:n]


def _bind_ksw(lib):
    p8 = ctypes.POINTER(ctypes.c_uint8)
    p32 = ctypes.POINTER(ctypes.c_int32)
    p64 = ctypes.POINTER(ctypes.c_int64)
    lib.bwamem_ksw_global.restype = ctypes.c_int64
    lib.bwamem_ksw_global.argtypes = [
        p8, ctypes.c_int64, p8, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, p32, ctypes.c_int64, p64]
    lib.bwamem_cigar_nm_md.restype = ctypes.c_int64
    lib.bwamem_cigar_nm_md.argtypes = [
        p8, p8, p32, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64, p64]
    lib.bwamem_ksw_align.restype = None
    lib.bwamem_ksw_align.argtypes = [
        p8, ctypes.c_int64, p8, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        p64]


def ksw_global_native(query: np.ndarray, target: np.ndarray,
                      mat: np.ndarray, o_del: int, e_del: int, o_ins: int,
                      e_ins: int, w: int):
    """Native banded global alignment; returns (score, cigar) with the
    exact cigar.py ksw_global semantics, or None if unavailable.
    Caller guarantees len(query) > 0 and len(target) > 0."""
    lib = get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(query, np.uint8)
    t = np.ascontiguousarray(target, np.uint8)
    m8 = np.ascontiguousarray(mat, np.int8)
    cap = len(q) + len(t) + 2
    cig = np.empty(2 * cap, np.int32)
    score = ctypes.c_int64()
    n = lib.bwamem_ksw_global(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(q),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(t),
        m8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), m8.shape[0],
        o_del, e_del, o_ins, e_ins, int(w),
        cig.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
        ctypes.byref(score))
    if n < 0:
        return None
    pairs = cig[:2 * n].reshape(n, 2)
    return int(score.value), [(int(op), int(ln)) for op, ln in pairs]


def ksw_align_native(query: np.ndarray, target: np.ndarray,
                     mat: np.ndarray, o_del: int, e_del: int, o_ins: int,
                     e_ins: int):
    """Native local SW (bwa ksw_align twin); returns the 6-tuple
    (score, qb, qe, tb, te, score2) or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(query, np.uint8)
    t = np.ascontiguousarray(target, np.uint8)
    m8 = np.ascontiguousarray(mat, np.int8)
    out = np.empty(6, np.int64)
    lib.bwamem_ksw_align(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(q),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(t),
        m8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), m8.shape[0],
        o_del, e_del, o_ins, e_ins,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return tuple(int(x) for x in out)


def cigar_nm_md_native(query: np.ndarray, rseq: np.ndarray, cigar):
    """Native NM/MD computation; returns (nm, md) or None."""
    lib = get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(query, np.uint8)
    r = np.ascontiguousarray(rseq, np.uint8)
    flat = np.asarray([x for p in cigar for x in p], np.int32)
    cap = 16 + 5 * (len(q) + len(r))
    buf = ctypes.create_string_buffer(cap)
    nm = ctypes.c_int64()
    ln = lib.bwamem_cigar_nm_md(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(cigar),
        buf, cap, ctypes.byref(nm))
    if ln < 0:
        return None
    return int(nm.value), buf.raw[:ln].decode("ascii")


def _bind_mempipe(lib):
    p8 = ctypes.POINTER(ctypes.c_uint8)
    p32 = ctypes.POINTER(ctypes.c_int32)
    pu32 = ctypes.POINTER(ctypes.c_uint32)
    p64 = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    lib.mp_new.restype = ctypes.c_void_p
    lib.mp_new.argtypes = [
        p64, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int8), p8, i64, p64, p64, i64,
        ctypes.c_char_p, p64, i64, i64, p32, pu32, pu32, p64, i64, i64]
    lib.mp_free.restype = None
    lib.mp_free.argtypes = [ctypes.c_void_p]
    lib.mp_chunk_start.restype = i64
    lib.mp_chunk_start.argtypes = [ctypes.c_void_p, p8, p64, i64, i64, i64]
    lib.mp_chunk_start_seeded.restype = i64
    lib.mp_chunk_start_seeded.argtypes = [ctypes.c_void_p, p8, p64, i64,
                                          i64, p64, i64, i64]
    lib.mp_task_count.restype = i64
    lib.mp_task_count.argtypes = [ctypes.c_void_p]
    lib.mp_task_dims.restype = None
    lib.mp_task_dims.argtypes = [ctypes.c_void_p, p64, p64]
    pi8 = ctypes.POINTER(ctypes.c_int8)
    lib.mp_fill_tasks.restype = None
    lib.mp_fill_tasks.argtypes = [ctypes.c_void_p, i64, pi8, i64, pi8,
                                  i64, p32, i64]
    lib.mp_pass_done.restype = i64
    lib.mp_pass_done.argtypes = [ctypes.c_void_p, i64, p32, i64]
    lib.mp_prepare_right.restype = i64
    lib.mp_prepare_right.argtypes = [ctypes.c_void_p]
    lib.mp_prepare_fused.restype = i64
    lib.mp_prepare_fused.argtypes = [ctypes.c_void_p]
    lib.mp_fused_dims.restype = None
    lib.mp_fused_dims.argtypes = [ctypes.c_void_p, p64, p64, p64, p64]
    lib.mp_fill_fused.restype = None
    lib.mp_fill_fused.argtypes = [ctypes.c_void_p, pi8, i64, pi8, i64,
                                  pi8, i64, pi8, i64, p32, i64]
    lib.mp_fill_fused_idx.restype = None
    lib.mp_fill_fused_idx.argtypes = [ctypes.c_void_p, p32, i64]
    lib.mp_fused_done.restype = None
    lib.mp_fused_done.argtypes = [ctypes.c_void_p, p32, i64]
    lib.mp_finalize.restype = i64
    lib.mp_finalize.argtypes = [ctypes.c_void_p, i64]
    lib.mp_finalize_pe.restype = i64
    lib.mp_finalize_pe.argtypes = [ctypes.c_void_p, i64, i64]
    # device-rescue wave protocol (mem_matesw batched on-device)
    lib.mp_pe_prepare.restype = None
    lib.mp_pe_prepare.argtypes = [ctypes.c_void_p, i64, i64]
    lib.mp_rescue_begin.restype = i64
    lib.mp_rescue_begin.argtypes = [ctypes.c_void_p]
    lib.mp_rescue_wave_build.restype = i64
    lib.mp_rescue_wave_build.argtypes = [ctypes.c_void_p, i64, p64, p64]
    lib.mp_rescue_fill.restype = None
    lib.mp_rescue_fill.argtypes = [ctypes.c_void_p, pi8, i64, pi8, i64,
                                   p32, i64]
    lib.mp_rescue_fill_idx.restype = None
    lib.mp_rescue_fill_idx.argtypes = [ctypes.c_void_p, p32, i64]
    lib.mp_rescue_apply.restype = None
    lib.mp_rescue_apply.argtypes = [ctypes.c_void_p, p32, i64]
    lib.mp_finalize_pe_tail.restype = i64
    lib.mp_finalize_pe_tail.argtypes = [ctypes.c_void_p, i64, i64]
    # device-CIGAR round protocol (reg2aln globals batched on-device)
    lib.mp_cigar_begin.restype = i64
    lib.mp_cigar_begin.argtypes = [ctypes.c_void_p, i64]
    lib.mp_cigar_dims.restype = None
    lib.mp_cigar_dims.argtypes = [ctypes.c_void_p, p64, p64]
    lib.mp_cigar_fill.restype = None
    lib.mp_cigar_fill.argtypes = [ctypes.c_void_p, pi8, i64, pi8, i64,
                                  p32, i64]
    lib.mp_cigar_fill_idx.restype = None
    lib.mp_cigar_fill_idx.argtypes = [ctypes.c_void_p, p32, i64]
    lib.mp_cigar_apply.restype = i64
    lib.mp_cigar_apply.argtypes = [ctypes.c_void_p, p32, p32, p32, i64]
    lib.mp_finalize_records.restype = i64
    lib.mp_finalize_records.argtypes = [ctypes.c_void_p, i64]
    lib.mp_cigar_collect_pe.restype = i64
    lib.mp_cigar_collect_pe.argtypes = [ctypes.c_void_p]
    lib.mp_rescue_host.restype = None
    lib.mp_rescue_host.argtypes = [ctypes.c_void_p, i64, i64]
    lib.mp_blob_size.restype = i64
    lib.mp_blob_size.argtypes = [ctypes.c_void_p]
    lib.mp_get_records.restype = None
    lib.mp_get_records.argtypes = [ctypes.c_void_p, p64, ctypes.c_char_p]
    lib.mp_sam_size.restype = i64
    lib.mp_sam_size.argtypes = [ctypes.c_void_p, p64]
    lib.mp_emit_sam.restype = None
    lib.mp_emit_sam.argtypes = [ctypes.c_void_p, ctypes.c_char_p, p64,
                                ctypes.c_char_p, p64, ctypes.c_char_p,
                                p64, p64, i64, i64]
    lib.mp_region_count.restype = i64
    lib.mp_region_count.argtypes = [ctypes.c_void_p, i64]
    lib.mp_export_regions.restype = None
    lib.mp_export_regions.argtypes = [ctypes.c_void_p, p64]
    lib.mp_set_rg.restype = None
    lib.mp_set_rg.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mp_chunk_end.restype = None
    lib.mp_chunk_end.argtypes = [ctypes.c_void_p]


def _bind_smem(lib):
    lib.bwamem_collect_seeds.restype = ctypes.c_int64
    lib.bwamem_collect_seeds.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]


def collect_seeds_native(po, ssa, sa_intv, reads_mat, qlen,
                         min_seed_len, split_len, split_width, max_occ):
    """Native seeding over a (n_reads, L) u8 read matrix.
    Returns (n, seeds (n,4) int64 rows {read_idx, rbeg, qbeg, len}) or
    None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    C = np.ascontiguousarray(po.C, np.int64)
    occ = np.ascontiguousarray(po.occ_rows, np.int32)
    pk = np.ascontiguousarray(po.pk_rows, np.uint32)
    va = np.ascontiguousarray(po.va_rows, np.uint32)
    ssa = np.ascontiguousarray(ssa, np.int64)
    reads_mat = np.ascontiguousarray(reads_mat, np.uint8)
    qlen = np.ascontiguousarray(qlen, np.int64)
    cap = max(1 << 16, int(qlen.sum()) * 4)
    out = np.empty((cap, 4), np.int64)
    p64 = ctypes.POINTER(ctypes.c_int64)
    n = lib.bwamem_collect_seeds(
        C.ctypes.data_as(p64), int(po.primary), int(po.n_rows),
        occ.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pk.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        va.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ssa.ctypes.data_as(p64), len(ssa), int(sa_intv),
        reads_mat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        qlen.ctypes.data_as(p64), reads_mat.shape[0], reads_mat.shape[1],
        int(min_seed_len), int(split_len), int(split_width), int(max_occ),
        out.ctypes.data_as(p64), cap)
    if n < 0:
        return None
    return int(n), out[:n]
