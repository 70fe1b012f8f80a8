"""The platform extension step (ops/extend_step): the plain XLA fused step
against the scalar oracle, the CUDA kernel's lane code (host build)
against the XLA step, the single-pass scalars, the platform choice, and —
on a GPU only (`gpu` marker) — the compiled CUDA kernel."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from bwamem_tpu import native
from bwamem_tpu.config import MemOptions
from bwamem_tpu.ops import extend_step
from bwamem_tpu.ops.extend_ref import ksw_extend_core
from bwamem_tpu.utils import jaxcfg

from test_extend_jax import make_params, random_batch

MAT = MemOptions().mat
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fused_world(seed, B=24, Q=48, T=72, zdrop=30):
    """A fused batch (transposed int8 layout + (16, B) scalars) with
    narrow bands so some lanes take the L1/R1 retries, a few lanes with
    no left or right task, and the runtime scoring vector."""
    rng = np.random.default_rng(seed)
    ql, qll, tl, tll, h0 = random_batch(rng, B, qmax=Q - 4, tmax=T - 8,
                                        qpad=Q, tpad=T)
    qr, qrl, tr, trl, _ = random_batch(rng, B, qmax=Q - 4, tmax=T - 8,
                                       qpad=Q, tpad=T)
    w = rng.integers(1, 12, B).astype(np.int32)
    scal = np.zeros((16, B), np.int32)
    scal[0], scal[1], scal[2], scal[3] = qll, tll, w, h0
    scal[4], scal[5], scal[6], scal[7] = 2 * w, qrl, trl, w
    scal[8], scal[9] = 2 * w, w
    scal[0, ::7] = 0
    scal[5, ::5] = 0
    seqs = [x.T.astype(np.int8) for x in (ql, tl, qr, tr)]
    return seqs, scal, extend_step.params_vector(make_params(zdrop=zdrop))


def oracle_groups(seqs, scal, zdrop=30):
    """Per lane, the expected [L0 | L1 | R0 | R1] groups (None where a
    pass does not run) from ksw_extend_core with h0 chaining."""
    ql, tl, qr, tr = seqs
    out = []
    for b in range(scal.shape[1]):
        s = scal[:, b]
        thr = (s[9] >> 1) + (s[9] >> 2)
        groups = [None] * 4
        score = s[3]
        for g, (q, t, qlen, tlen, aw0, aw1) in enumerate(
                ((ql, tl, s[0], s[1], s[2], s[4]),
                 (qr, tr, s[5], s[6], s[7], s[8]))):
            if qlen == 0:
                continue

            def core(aw):
                return ksw_extend_core(q[:qlen, b], t[:tlen, b], MAT, 6, 1,
                                       6, 1, w=int(aw), h0=int(score),
                                       zdrop=zdrop)

            groups[2 * g] = core(aw0)
            if groups[2 * g].max_off >= thr:
                groups[2 * g + 1] = core(aw1)
            score = (groups[2 * g + 1] or groups[2 * g]).score
        out.append(groups)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_xla_matches_oracle_per_lane(seed):
    """L0, the L1 retry, h0 chaining into R0, and R1 — per lane."""
    seqs, scal, prm = fused_world(seed)
    got = np.asarray(jax.jit(extend_step.fused_xla)(*seqs, scal, prm))
    n_retry = 0
    for b, groups in enumerate(oracle_groups(seqs, scal)):
        for g, want in enumerate(groups):
            if want is None:
                continue
            n_retry += g in (1, 3)
            assert tuple(got[8 * g:8 * g + 6, b]) == tuple(want[:6]), (b, g)
    assert n_retry > 0, "fixture should make some lanes retry"


@pytest.mark.parametrize("seed", [3, 4])
def test_kernel_lanes_match_xla(seed):
    """The CUDA kernel's lane code, host build, on the whole batch."""
    seqs, scal, prm = fused_world(seed)
    want = np.asarray(extend_step.fused_xla(*seqs, scal, prm))
    np.testing.assert_array_equal(
        native.banded_fused_host(*seqs, scal, prm), want)


@pytest.mark.parametrize("B", [37, 5])
def test_pass_scal_makes_fused_one_pass(B):
    """pass_scal turns the fused step into the `pass` contract: no right
    task, no retry; the L0 group equals pass_xla."""
    seqs, scal, prm = fused_world(7, B=B)
    scal16 = np.asarray(extend_step.pass_scal(scal[:8]))
    assert scal16.shape == (16, B)
    empty = np.zeros((1, B), np.int8)
    got = native.banded_fused_host(seqs[0], seqs[1], empty, empty, scal16,
                                   prm)
    np.testing.assert_array_equal(
        got[:8], np.asarray(extend_step.pass_xla(seqs[0], seqs[1],
                                                 scal[:8], prm)))
    # the inert right pass hands the left score on (h0 chaining)
    np.testing.assert_array_equal(got[16], got[0])


def test_inert_lanes_return_the_seed_score():
    seqs, scal, prm = fused_world(8, B=8)
    scal[0] = 0      # no left task anywhere
    scal[5] = 0      # no right task anywhere
    out = native.banded_fused_host(*seqs, scal, prm)
    for g in range(4):
        np.testing.assert_array_equal(out[8 * g], scal[3])      # h0
        np.testing.assert_array_equal(out[8 * g + 1:8 * g + 4], 0)
        np.testing.assert_array_equal(out[8 * g + 4], -1)       # gscore
        np.testing.assert_array_equal(out[8 * g + 5], 0)        # max_off


def test_host_lanes_reject_mismatched_lane_counts():
    seqs, scal, prm = fused_world(9, B=8)
    with pytest.raises(ValueError, match="lane counts"):
        native.banded_fused_host(seqs[0][:, :4], *seqs[1:], scal, prm)


def test_pass_backend_matches_extend_jax():
    """The Python host's extend_batch_fn over the platform's pass step."""
    from bwamem_tpu.ops.extend_jax import extend_batch_core

    rng = np.random.default_rng(14)
    query, qlen, target, tlen, h0 = random_batch(rng, 12)
    aw = rng.integers(1, 30, 12).astype(np.int32)
    params = make_params(zdrop=20)
    got = extend_step.make_pass_backend(params)(query, qlen, target, tlen,
                                                aw, h0)
    want = extend_batch_core(*(jax.numpy.asarray(x) for x in (
        query, qlen, target, tlen, aw, h0)), params)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_scoring_is_runtime_data():
    """One compiled XLA step serves two scoring vectors (no retrace), and
    the rebuilt matrix is bwa's (+a, -b, -1 against N)."""
    seqs, scal, prm = fused_world(10, B=8)
    fn = jax.jit(lambda *a: extend_step.pass_xla(*a))   # its own cache
    fn(seqs[0], seqs[1], scal[:8], prm)
    prm2 = prm.copy()
    prm2[:2] = (2, 3)
    fn(seqs[0], seqs[1], scal[:8], prm2)
    assert fn._cache_size() == 1
    mat = np.asarray(extend_step._params_from_vector(prm2).mat_flat)
    np.testing.assert_array_equal(mat.reshape(5, 5),
                                  MemOptions(a=2, b=3).mat)


@pytest.mark.parametrize("platform,pass_fn,fused_fn", [
    ("cpu", extend_step.pass_xla, extend_step.fused_xla),
    ("gpu", extend_step.pass_cuda, extend_step.fused_cuda),
])
def test_platform_choice(platform, pass_fn, fused_fn):
    step = extend_step.step_for(platform)
    assert step.extend_pass is pass_fn and step.fused is fused_fn


def test_platform_choice_rejects_unknown_platform():
    with pytest.raises(ValueError, match="'rocm'"):
        extend_step.step_for("rocm")


def test_platform_choice_defaults_to_jax_backend():
    assert extend_step.step_for() is extend_step.step_for(
        jax.default_backend())


@pytest.mark.parametrize("env", [None, "/some/cache"])
def test_compile_cache_path_rule(env, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins and nothing overrides it; without
    it the cache is one fixed directory inside the checkout."""
    if env is None:
        monkeypatch.delenv(jaxcfg.ENV, raising=False)
        assert jaxcfg.cache_dir() == os.path.join(REPO, ".jax_cache")
    else:
        monkeypatch.setenv(jaxcfg.ENV, env)
        calls = []
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        assert jaxcfg.enable_compilation_cache() == env
        assert [c for c in calls if c[0] == "jax_compilation_cache_dir"] \
            == []


def test_native_library_path_is_keyed_by_sources(tmp_path):
    from bwamem_tpu import native

    src = tmp_path / "a.cpp"
    src.write_text("int f() { return 1; }\n")
    first = native.library_path([str(src)])
    assert first == native.library_path([str(src)])
    src.write_text("int f() { return 2; }\n")
    assert native.library_path([str(src)]) != first
    assert os.path.dirname(first) == native._BUILD


def test_native_build_failure_surfaces_compiler_error(tmp_path, monkeypatch):
    from bwamem_tpu import native

    src = tmp_path / "broken.cpp"
    src.write_text("int f( { return 1; }\n")
    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "build"))
    err = native._build([str(src)], native.library_path([str(src)]))
    assert err and "broken.cpp" in err
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", err)
    with pytest.raises(RuntimeError, match="broken.cpp"):
        native.require()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(alone, tmp_path):
    """No GPU (JAX held to the CPU), or the script alone in a directory:
    a non-zero exit and no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = str(tmp_path / "chip_smoke.py")
        with open(os.path.join(REPO, "chip_smoke.py")) as f:
            open(script, "w").write(f.read())
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


# -- on the card ------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("seed", [11, 12])
def test_compiled_kernel_matches_xla_on_gpu(seed):
    seqs, scal, prm = fused_world(seed, B=300, Q=160, T=320)
    got = np.asarray(jax.jit(extend_step.fused_cuda)(*seqs, scal, prm))
    want = np.asarray(jax.jit(extend_step.fused_xla)(*seqs, scal, prm))
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_compiled_pass_matches_xla_on_gpu():
    seqs, scal, prm = fused_world(13, B=100, Q=160, T=320)
    got = np.asarray(jax.jit(extend_step.pass_cuda)(seqs[0], seqs[1],
                                                    scal[:8], prm))
    want = np.asarray(extend_step.pass_xla(seqs[0], seqs[1], scal[:8],
                                           prm))
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_gpu_step_is_the_cuda_kernel():
    assert extend_step.step_for().fused is extend_step.fused_cuda
