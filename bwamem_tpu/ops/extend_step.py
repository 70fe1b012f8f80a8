"""The device extension step, and the one place that picks it per platform.

Two steps serve the native pipeline (pipeline/native_driver.py), the
Python host (pipeline/driver.py) and the mesh wrappers (parallel/dist.py):

  pass   (query (Q, B), target (T, B), scal (8, B), prm (8,)) -> (8, B)
         one banded pass per lane; scal rows [qlen, tlen, aw, h0, ...]
  fused  (query_l, target_l, query_r, target_r, scal (16, B), prm) -> (32, B)
         the whole alignment per lane: L0, the L1 retry, left->right h0
         chaining, R0 and the R1 retry (rows documented on `fused_xla`)

Every output group is [score, qle, tle, gtle, gscore, max_off, aw, 0],
bit-identical to ops/extend_ref.ksw_extend_core (bwa-0.7.8 ksw_extend2).
Lanes with qlen, tlen or h0 <= 0 are inert and return (h0, 0, 0, 0, -1, 0).
Scoring travels as the runtime vector `prm` = [a, b, o_del, e_del, o_ins,
e_ins, zdrop, 0] (the reference's per-batch header words,
task_parse.v:1954-1955), so changing -A/-B/-O/-E/zdrop recompiles nothing.
The substitution matrix is bwa-style: +a match, -b mismatch, -1 against N
(what the reference FPGA hardcodes, sw_pe_array_sw_extend.v:1915-1940).

Two implementations of the contract:

* plain XLA (`pass_xla`, `fused_xla`), built from ops/extend_jax: a
  while_loop over target rows with every query column of a row computed
  at once.  It is the CPU's step and the reference the kernel is tested
  against.
* a CUDA kernel for NVIDIA Hopper GPUs (`pass_cuda`, `fused_cuda`),
  csrc/cuda/banded_extend.cu called through jax.ffi.  It takes the
  reference processing element's own shape (sw_pe_array_sw_extend.v):
  one lane per thread running ksw_extend2's serial row and column loops,
  its eh band row and query in shared memory.  Its arithmetic lives in
  csrc/banded_extend.h, whose host build (native.banded_fused_host) the
  CPU tests compare with extend_ref and the XLA step.  The library is
  compiled once per source version, so a process pays no per-shape
  kernel compile.

`step_for()` chooses from `jax.default_backend()`: the CUDA kernel on
"gpu", the XLA step on "cpu", and an error for any other platform.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import jax
import jax.ffi
import jax.numpy as jnp
import numpy as np

from bwamem_tpu.ops.extend_jax import (
    ExtendOut,
    ExtendParams,
    extend_batch_core,
)


def params_vector(params: ExtendParams) -> np.ndarray:
    """The (8,) int32 runtime scoring vector [a, b, o_del, e_del, o_ins,
    e_ins, zdrop, 0] for a bwa-style ExtendParams."""
    mat = np.asarray(params.mat_flat).reshape(params.m, params.m)
    return np.array([int(mat[0, 0]), -int(mat[0, 1]), params.o_del,
                     params.e_del, params.o_ins, params.e_ins,
                     params.zdrop, 0], np.int32)


# -- plain XLA ---------------------------------------------------------------

def _params_from_vector(prm) -> ExtendParams:
    """ExtendParams with traced scalars: the bwa-style matrix rebuilt from
    a and b, so the XLA step also takes scoring at run time."""
    prm = jnp.asarray(prm, jnp.int32)
    k = jnp.arange(5)
    mat = jnp.where(k[:, None] == k[None, :], prm[0], -prm[1])
    mat = jnp.where((k[:, None] > 3) | (k[None, :] > 3), -1, mat)
    return ExtendParams(mat_flat=mat.ravel().astype(jnp.int32), m=5,
                        o_del=prm[2], e_del=prm[3], o_ins=prm[4],
                        e_ins=prm[5], zdrop=prm[6])


def _xla_rows(query_t, target_t, qlen, tlen, aw, h0, params):
    o = extend_batch_core(query_t.T.astype(jnp.int32), qlen,
                          target_t.T.astype(jnp.int32), tlen, aw, h0,
                          params)
    return [o.score, o.qle, o.tle, o.gtle, o.gscore, o.max_off, aw,
            jnp.zeros_like(aw)]


def pass_xla(query_t, target_t, scal, prm):
    """One banded pass (the `pass` contract) as plain XLA."""
    qlen, tlen, aw, h0 = (scal[k].astype(jnp.int32) for k in range(4))
    return jnp.stack(_xla_rows(query_t, target_t, qlen, tlen, aw, h0,
                               _params_from_vector(prm)))


def fused_xla(query_l, target_l, query_r, target_r, scal, prm):
    """The fused whole-alignment step as plain XLA.

    scal rows: [0]=qlen_l [1]=tlen_l [2]=aw0_l [3]=h0 [4]=aw1_l
    [5]=qlen_r [6]=tlen_r [7]=aw0_r [8]=aw1_r [9]=w; rows 10-15 belong to
    the resident-reference gather (native_driver.fused_idx_local).
    A retry pass runs only on lanes whose first pass did not converge,
    max_off < (w>>1)+(w>>2) (csrc/mempipe.cpp mp_pass_done); the retry
    group of a converged lane holds the inert result.  The right pass
    starts from the chosen left score (bwa's h0 chaining).
    Returns (32, B): [L0 | L1 | R0 | R1] x [score, qle, tle, gtle,
    gscore, max_off, aw, 0]."""
    params = _params_from_vector(prm)
    s = [scal[k].astype(jnp.int32) for k in range(10)]
    qlen_l, tlen_l, aw0_l, h0, aw1_l, qlen_r, tlen_r, aw0_r, aw1_r, w = s
    thr = (w >> 1) + (w >> 2)

    l0 = _xla_rows(query_l, target_l, qlen_l, tlen_l, aw0_l, h0, params)
    conv_l = l0[5] < thr
    l1 = _xla_rows(query_l, target_l, jnp.where(conv_l, 0, qlen_l), tlen_l,
                   aw1_l, h0, params)
    h0_r = jnp.where(conv_l, l0[0], l1[0])
    r0 = _xla_rows(query_r, target_r, qlen_r, tlen_r, aw0_r, h0_r, params)
    conv_r = r0[5] < thr
    r1 = _xla_rows(query_r, target_r, jnp.where(conv_r, 0, qlen_r), tlen_r,
                   aw1_r, h0_r, params)
    return jnp.stack(l0 + l1 + r0 + r1)


# -- the CUDA kernel ---------------------------------------------------------

_FFI_TARGET = "bwamem_banded_fused"
# row 9 (w) large enough that the fused step's retry never runs
_NO_RETRY_W = 1 << 28


@functools.cache
def _cuda_kernels():
    """Build (first use) and load the CUDA library; register its FFI
    target.  Cached: the CDLL handle must outlive every call."""
    from bwamem_tpu import native

    lib = ctypes.CDLL(native.cuda_library())
    jax.ffi.register_ffi_target(
        _FFI_TARGET, jax.ffi.pycapsule(lib.BwamemBandedFused),
        platform="CUDA")
    return lib


def fused_cuda(query_l, target_l, query_r, target_r, scal, prm):
    """The `fused` contract as the CUDA kernel (traceable)."""
    _cuda_kernels()
    seqs = [jnp.asarray(x, jnp.int8)
            for x in (query_l, target_l, query_r, target_r)]
    return jax.ffi.ffi_call(
        _FFI_TARGET, jax.ShapeDtypeStruct((32, scal.shape[1]), jnp.int32))(
        *seqs, jnp.asarray(scal, jnp.int32), jnp.asarray(prm, jnp.int32))


def pass_scal(scal):
    """The (16, B) fused scalars that make the fused step one plain pass
    over `scal`'s [qlen, tlen, aw, h0] lanes: no right task, no retry."""
    scal = jnp.asarray(scal, jnp.int32)
    b = scal.shape[1]
    return jnp.concatenate(
        [scal[:4], jnp.zeros((5, b), jnp.int32),
         jnp.full((1, b), _NO_RETRY_W, jnp.int32),
         jnp.zeros((6, b), jnp.int32)])


def pass_cuda(query_t, target_t, scal, prm):
    """The `pass` contract as the CUDA kernel: its L0 group."""
    empty = jnp.zeros((1, scal.shape[1]), jnp.int8)
    return fused_cuda(query_t, target_t, empty, empty, pass_scal(scal),
                      prm)[:8]


# -- the choice --------------------------------------------------------------

class Step(NamedTuple):
    extend_pass: object   # the `pass` contract
    fused: object         # the `fused` contract


_STEPS = {
    "gpu": Step(pass_cuda, fused_cuda),
    "cpu": Step(pass_xla, fused_xla),
}


def step_for(platform: str | None = None) -> Step:
    """The extension step for `platform` (default: the platform JAX runs
    on).  Traceable; call it inside jit, shard_map or a backend."""
    platform = platform or jax.default_backend()
    try:
        return _STEPS[platform]
    except KeyError:
        raise ValueError(
            f"no banded-extension step for platform {platform!r}; "
            f"supported: {sorted(_STEPS)}") from None


def prepare() -> Step:
    """step_for() for the running platform, with the GPU kernel's library
    built and loaded now: backends call it at construction, so the
    one-time nvcc build is set-up, not the first chunk's time."""
    step = step_for()
    if step.fused is fused_cuda:
        _cuda_kernels()
    return step


def make_pass_backend(params: ExtendParams):
    """A pipeline.driver extend_batch_fn over the platform's pass step:
    (query (B, Q), qlen, target (B, T), tlen, aw, h0) -> ExtendOut."""
    prm = params_vector(params)
    fn = jax.jit(prepare().extend_pass)

    def backend(query, qlen, target, tlen, aw, h0):
        scal = np.zeros((8, len(qlen)), np.int32)
        for k, v in enumerate((qlen, tlen, aw, h0)):
            scal[k] = np.asarray(v)
        q_t, t_t = (np.ascontiguousarray(np.asarray(x, np.int8).T)
                    for x in (query, target))
        out = np.asarray(fn(q_t, t_t, scal, prm))
        return ExtendOut(score=out[0], qle=out[1], tle=out[2], gtle=out[3],
                         gscore=out[4], max_off=out[5], w_used=out[6])

    return backend

