"""Which engine runs where: the device decision (ops.device), checked with
the backend reported as "gpu" and spies in place of the engines (nothing
runs on a device here); the compile-cache placement; and chip_smoke.py's
refusal to run without a GPU."""
import os
import subprocess
import sys

import jax
import pytest

from curdleproofs_jax import curve as cv
from curdleproofs_jax import vectors as vec
from curdleproofs_jax.curve import G1
from curdleproofs_jax.fields import Fr
from curdleproofs_jax.ops import msm as omsm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _backend(monkeypatch, name):
    monkeypatch.setattr(jax, "default_backend", lambda: name)


def _spy_engines(monkeypatch):
    calls = []

    def spy(tag):
        def f(*a, **k):
            calls.append(tag)
            return G1.identity()

        return f

    monkeypatch.setattr(omsm, "_msm_host_timed", spy("host"))
    monkeypatch.setattr(omsm, "msm_ladder", spy("ladder"))
    monkeypatch.setattr(omsm, "msm_pippenger_stream", spy("stream"))
    monkeypatch.setattr(cv, "msm_host", spy("native"))
    return calls


@pytest.mark.parametrize("case", ["msm_auto", "pointvec", "lockstep", "decompress"])
def test_engine_choice_by_backend(monkeypatch, case):
    monkeypatch.setattr(omsm, "STREAM_MIN", 256)
    monkeypatch.setattr(vec, "DEVICE_MIN", 64)
    calls = _spy_engines(monkeypatch)
    g = G1()

    if case == "msm_auto":
        sizes = [omsm.HOST_THRESHOLD, omsm.HOST_THRESHOLD + 1, 255, 256]
        for backend, want in [
            ("gpu", ["host", "ladder", "ladder", "stream"]),
            ("cpu", ["host"] * 4),
        ]:
            _backend(monkeypatch, backend)
            calls.clear()
            for n in sizes:
                omsm.msm([g] * n, [Fr(3)] * n)
            assert calls == want, backend
    elif case == "pointvec":
        for backend, want in [
            ("gpu", ["native", "ladder", "stream"]),
            ("cpu", ["native", "host", "host"]),
        ]:
            _backend(monkeypatch, backend)
            calls.clear()
            for n in (63, 64, 300):
                vec.PointVec([g] * n).msm(vec.ScalarVec.of([Fr(5)] * n))
            assert calls == want, backend
    elif case == "lockstep":
        from curdleproofs_jax.utils.lockstep import LockstepContext

        ctx = LockstepContext(2, device_min=4096)
        _backend(monkeypatch, "gpu")
        assert [ctx._use_device(t) for t in (4095, 4096)] == [False, True]
        _backend(monkeypatch, "cpu")
        assert [ctx._use_device(t) for t in (4095, 4096)] == [False, False]
    else:
        from curdleproofs_jax.ops import compress as ocompress

        monkeypatch.setattr(cv, "DECOMPRESS_DEVICE_MIN", 4)
        pts = [g * Fr(k) for k in range(1, 6)]
        blob = b"".join(p.to_compressed_bytes() for p in pts)

        def dev(encs):
            calls.append("device")
            return [G1.from_compressed_bytes_unchecked(e) for e in encs]

        monkeypatch.setattr(ocompress, "batch_decompress_to_host", dev)
        for backend, n, want in [
            ("gpu", 5, ["device"]),
            ("gpu", 3, []),
            ("cpu", 5, []),
        ]:
            _backend(monkeypatch, backend)
            calls.clear()
            assert cv.decompress_host_batch(blob[: 48 * n]) == pts[:n]
            assert calls == want, (backend, n)


def _run(code, env_extra, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_extra)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "checkout"])
def test_compile_cache_placement(tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache and nothing in the
    package overrides it; otherwise the cache is <checkout>/.jax_cache."""
    code = (
        "import jax, curdleproofs_jax.ops as o;"
        "print(jax.config.jax_compilation_cache_dir);print(o.cache_dir())"
    )
    if env_set:
        want = str(tmp_path / "cc")
        r = _run(code, {"JAX_COMPILATION_CACHE_DIR": want})
    else:
        want = os.path.join(ROOT, ".jax_cache")
        r = _run(code, {}, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [want, want]


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py without a GPU exits non-zero and prints no ok line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
