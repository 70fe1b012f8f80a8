"""Multi-host scale-out, driven end-to-end through REAL processes.

The reference scales by putting 4 PE arrays behind one scheduler
(/root/reference/batch_manager.v:397-562, 994-1013); the analogue here
is N share-nothing host processes, each aligning the strided
shard_reads assignment (`mem --shard K/N`) and a deterministic merge
(`merge`) that restores input order byte-identically (SURVEY §7 step
6; BASELINE north star: >=80% linear 1->4 hosts).

Every test here launches 2-4 actual `python -m bwamem_tpu` processes
CONCURRENTLY (CPU backend) and diffs the merged SAM against the
single-process run.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from bwamem_tpu.pipeline import native_driver

pytestmark = pytest.mark.skipif(not native_driver.available(),
                                reason="native library unavailable")


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
        + os.pathsep + env.get("PYTHONPATH", ""))
    return env


def _body(text: str) -> list[str]:
    return [l for l in text.splitlines() if not l.startswith("@")]


def _revcomp(s):
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("mhost")
    rng = np.random.default_rng(23)
    bases = "ACGT"
    seq = "".join(bases[i] for i in rng.integers(0, 4, 60000))
    fa = d / "ref.fa"
    with open(fa, "w") as f:
        f.write(">c1\n")
        for i in range(0, len(seq), 70):
            f.write(seq[i:i + 70] + "\n")

    n = 70  # deliberately not a multiple of the shard counts
    r1s, r2s = [], []
    for i in range(n):
        pos = int(rng.integers(0, 60000 - 400))
        isz = int(rng.integers(250, 350))
        a = list(seq[pos:pos + 100])
        b = list(seq[pos + isz - 100:pos + isz])
        for p in (13, 61):
            a[p] = bases[int(rng.integers(0, 4))]
            b[p] = bases[int(rng.integers(0, 4))]
        r1s.append("".join(a))
        r2s.append(_revcomp("".join(b)))

    fq1, fq2 = d / "r1.fq", d / "r2.fq"
    with open(fq1, "w") as f1, open(fq2, "w") as f2:
        for i in range(n):
            f1.write(f"@p{i}\n{r1s[i]}\n+\n{'I' * 100}\n")
            f2.write(f"@p{i}\n{r2s[i]}\n+\n{'I' * 100}\n")
    # the QNAME-collision stress: every read carries the SAME name, so
    # unit grouping by QNAME runs alone cannot work (VERDICT weak #7)
    fqdup = d / "dup.fq"
    with open(fqdup, "w") as f:
        for i in range(n):
            f.write(f"@dup\n{r1s[i]}\n+\n{'I' * 100}\n")

    env = _env()
    subprocess.run([sys.executable, "-m", "bwamem_tpu", "index", str(fa)],
                   env=env, check=True, capture_output=True, timeout=300)
    return d, fa, fq1, fq2, fqdup, env, n


_BASE = ["-m", "bwamem_tpu", "mem", "--backend", "jax",
         "--host", "native", "-b", "32"]


def _single(env, *extra) -> str:
    r = subprocess.run([sys.executable, *_BASE, *extra], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr
    return r.stdout


def _sharded(env, d, n_shards, *extra, shard_env=None) -> str:
    """Launch n_shards mem processes CONCURRENTLY, then merge."""
    procs = []
    paths = []
    for k in range(n_shards):
        out = d / f"shard{k}.sam"
        paths.append(str(out))
        e = dict(env)
        if shard_env is not None:
            e.update(shard_env(k, n_shards))
            args = list(extra)
        else:
            args = ["--shard", f"{k}/{n_shards}", *extra]
        procs.append((subprocess.Popen(
            [sys.executable, *_BASE, *args], env=e,
            stdout=open(out, "w"), stderr=subprocess.PIPE, text=True),
            out))
    for p, out in procs:
        _, err = p.communicate(timeout=900)
        assert p.returncode == 0, err
    merged = d / "merged.sam"
    r = subprocess.run(
        [sys.executable, "-m", "bwamem_tpu", "merge", str(merged),
         *paths], env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return open(merged).read()


def test_shard_merge_se_identical(world):
    d, fa, fq1, fq2, fqdup, env, n = world
    want = _body(_single(env, str(fa), str(fq1)))
    got = _body(_sharded(env, d, 3, str(fa), str(fq1)))
    assert got == want
    assert len(got) >= n


def test_shard_merge_pe_identical(world):
    """PE shards: a pair's whole lifecycle (pestat, rescue, pairing)
    stays in one process; the merged stream is record-for-record the
    single-process PE run."""
    d, fa, fq1, fq2, fqdup, env, n = world
    want = _body(_single(env, str(fa), str(fq1), str(fq2)))
    got = _body(_sharded(env, d, 2, str(fa), str(fq1), str(fq2)))
    assert got == want
    assert len(got) >= 2 * n


def test_shard_merge_duplicate_qnames(world):
    """Adjacent reads sharing one QNAME: the flag-structure unit
    grouping (multihost.sam_units) keeps them apart where QNAME-run
    grouping glued them (round-2 VERDICT weak #7)."""
    d, fa, fq1, fq2, fqdup, env, n = world
    want = _body(_single(env, str(fa), str(fqdup)))
    got = _body(_sharded(env, d, 2, str(fa), str(fqdup)))
    assert got == want


def test_shard_from_jax_distributed_env(world):
    """The JAX distributed runtime path: two processes with
    JAX_COORDINATOR/JAX_NUM_PROCESSES/JAX_PROCESS_ID derive their shard
    from multihost.init_distributed (no --shard flag) and produce the
    same merged SAM."""
    d, fa, fq1, fq2, fqdup, env, n = world
    want = _body(_single(env, str(fa), str(fq1)))

    def shard_env(k, n_shards):
        return {"JAX_COORDINATOR": "127.0.0.1:19731",
                "JAX_NUM_PROCESSES": str(n_shards),
                "JAX_PROCESS_ID": str(k)}

    got = _body(_sharded(env, d, 2, str(fa), str(fq1),
                         shard_env=shard_env))
    assert got == want
