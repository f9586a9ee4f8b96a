"""Sharded MSM on the virtual 8-device CPU mesh: results must be identical
to the single-device engine and the exact host oracle regardless of mesh
shape (field adds are exact — no floating-point reduction-order hazards)."""
import random

import jax
import pytest

from curdleproofs_jax.curve import G1, msm_host
from curdleproofs_jax.fields import FR_MOD, Fr
from curdleproofs_jax.parallel.mesh import make_mesh
from curdleproofs_jax.parallel.msm import msm_sharded

rng = random.Random(0x5A5A)


def rand_points(n):
    return [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(n)]


def rand_scalars(n):
    return [Fr(rng.randrange(FR_MOD)) for _ in range(n)]


def test_virtual_mesh_available():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual CPU devices"


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_msm_matches_oracle(n_dev):
    n = 96  # not a multiple of shards * 32 -> exercises padding
    pts, scs = rand_points(n), rand_scalars(n)
    pts[0] = G1.identity()
    scs[1] = Fr(0)
    mesh = make_mesh(n_dev)
    got = msm_sharded(pts, scs, mesh=mesh, c=4)
    assert got == msm_host(pts, scs)


def test_sharded_msm_shard_invariance():
    n = 64
    pts, scs = rand_points(n), rand_scalars(n)
    expect = msm_host(pts, scs)
    for n_dev in (1, 2, 4):
        got = msm_sharded(pts, scs, mesh=make_mesh(n_dev), c=4)
        assert got == expect, f"mesh={n_dev}"


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_stream_matches_oracle(d):
    """Streaming pipeline per shard + in-graph collective window combine."""
    from curdleproofs_jax.parallel.msm import msm_sharded_stream

    n = 32 * d + 5  # padding exercised
    pts, scs = rand_points(n), rand_scalars(n)
    pts[2] = G1.identity()
    scs[3] = Fr(0)
    mesh = make_mesh(d)
    got = msm_sharded_stream(pts, scs, mesh=mesh, c=4)
    assert got == msm_host(pts, scs)


@pytest.mark.parametrize("d", [2, 8])
def test_sharded_ladder_matches_oracle(d):
    from curdleproofs_jax.parallel.msm import msm_sharded_ladder

    rng = random.Random(5150)
    n = 16 * d + 3  # non-multiple of shard count; padding handles it
    pts = [G1() * Fr(rng.randrange(1, FR_MOD)) for _ in range(n - 1)]
    pts.append(G1.identity())
    scs = [Fr(rng.randrange(FR_MOD)) for _ in range(n - 1)] + [Fr(0)]
    mesh = make_mesh(d)
    assert msm_sharded_ladder(pts, scs, mesh=mesh) == msm_host(pts, scs)


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_stream_production_path(monkeypatch, d):
    """The sharded stream path as production runs it: input sliced at
    STREAM_SPLIT (forced small here), window bits picked per slice, every
    slice's digit sort on the host and its device scan on its own mesh
    device, slice results added on the host — vs the host oracle. The
    profiling tags name the device each slice's result array was on: all
    d devices."""
    from curdleproofs_jax.ops import msm as omsm
    from curdleproofs_jax.parallel.msm import msm_sharded_stream
    from curdleproofs_jax.utils import profiling

    monkeypatch.setattr(omsm, "STREAM_SPLIT", 128 // d)
    n = 250  # two slices of 128 pairs, the second padded
    pts, scs = rand_points(n), rand_scalars(n)
    pts[0] = G1.identity()
    scs[1] = Fr(0)
    pts[130] = pts[129]  # duplicate base inside the second slice
    mesh = make_mesh(d)
    with profiling.collect() as reg:
        got = msm_sharded_stream(pts, scs, mesh=mesh)
        tags = {k for k in reg.report() if k.startswith("msm.shard.")}
    assert got == msm_host(pts, scs)
    assert tags == {f"msm.shard.{dev.id}" for dev in mesh.devices.flat}


def test_sharded_stream_slice_off_its_device_raises(monkeypatch):
    """A slice whose programs run on another device than the one it was
    given is an error, not a silent single-device run."""
    from curdleproofs_jax.ops import msm as omsm
    from curdleproofs_jax.parallel.msm import msm_sharded_stream

    orig = omsm._msm_stream_impl
    dev0 = jax.devices()[0]

    def on_dev0(points, scalars_np, c, window_batch=None, device=None, _safe=False):
        return orig(points, scalars_np, c, window_batch, dev0, _safe=_safe)

    monkeypatch.setattr(omsm, "_msm_stream_impl", on_dev0)
    n = 69
    pts, scs = rand_points(n), rand_scalars(n)
    with pytest.raises(RuntimeError, match="ran on"):
        msm_sharded_stream(pts, scs, mesh=make_mesh(2), c=4)
