"""The 3-D z-plane multi-device path of the port (parallel.mesh.ZShardingPolicy3,
the z-plane split of parallel.sharded, the shard modes of ops.kernels3 and
parallel.kernel_shard3) against the JAX package's (parallel/pallas_shard3.py).

On the CPU every shard-mode call runs its plain twin. Each sharded wrapper is
held

  * bit for bit against the port's unsharded twin on rings of 2, 3 and 8
    z-shards (the port splits 33 planes over 8 shards as 4, ..., 4, 5 and 65
    as 8, ..., 8, 9: ragged last shards, and halos deeper than a neighbour's
    block where JAX's planes per device exceed the port's);
  * against JAX's sharded call on its 8-device CPU mesh in interpret mode
    (the sizes tests/test_pallas_shard3.py uses: 33³ for the smoother, its
    error modes, the emit_residual pass and the residual; 65³ for the legs),
    with tests/test_torch_kernels3.py's fp32 bounds: iterates |Δu| ≤
    1e-5·max|u| (the Pallas sweep folds the update into another form, a few
    ulps a sweep), restricted right-hand sides 2e-5·max|f_c|, errors 1e-4
    relative (sums in another order; the port's clean error is Σ|r|, JAX's
    6/(ωh²)·Σ|Δ|), residuals the fp32 cancellation noise 12·eps·max|u|/h²
    times the sweeps' ulps.

``v_cycle3_sharded`` at 65³ is held against JAX's (the same fp32 iterate
bound as tests/test_torch_compiled3.py, 5e-5·max|u|, over a cycle's dozens of
sweeps) and bit for bit against the port's unsharded ``v_cycle3``, on the
kernel routing (its twins) and on the plain path; its routes (JAX's padded
depths) are read off the shard modes it calls. 129³ is marked slow.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_poisson_solver_tpu.models import poisson3d as jp3
from multigrid_poisson_solver_tpu.ops import padded3 as jpd3
from multigrid_poisson_solver_tpu.ops import pallas3d as jp3k
from multigrid_poisson_solver_tpu.parallel import pallas_shard3 as jps3
from multigrid_poisson_solver_tpu_torch.convert import (grid3_from_jax, policy3_from_jax,
                                                        sharded3_from_jax)
from multigrid_poisson_solver_tpu_torch.models import poisson3d as p3
from multigrid_poisson_solver_tpu_torch.ops import kernels as K
from multigrid_poisson_solver_tpu_torch.ops import kernels3 as K3
from multigrid_poisson_solver_tpu_torch.parallel import halo3
from multigrid_poisson_solver_tpu_torch.parallel import kernel_shard3 as KS3
from multigrid_poisson_solver_tpu_torch.parallel import mesh as M
from multigrid_poisson_solver_tpu_torch.parallel import sharded as S

U_RTOL = 1e-5
FC_RTOL = 2e-5
ERR_RTOL = 1e-4
CYCLE_RTOL = 5e-5
OMEGA3 = 6.0 / 7.0
NDEV = 8
RINGS = [2, 3, 8]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _jmesh(ndev=NDEV):
    return jps3.make_mesh_z(jax.devices()[:ndev])


def _policy(ndev, threshold=8):
    return M.ZShardingPolicy3(M.make_mesh_z(["cpu"] * ndev), threshold_planes=threshold)


@functools.lru_cache(maxsize=None)
def _fields(n):
    rng = np.random.default_rng(3000 + n)
    m = (n + 1) // 2
    return (rng.standard_normal((n, n, n)).astype(np.float32),
            rng.standard_normal((n, n, n)).astype(np.float32),
            rng.standard_normal((m, m, m)).astype(np.float32))


def _th(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jsharded(a, depth_mult):
    """A JAX padded volume, its depth padded to ×depth_mult, z-sharded."""
    return jax.device_put(jps3.pad_planes3(jp3k.pad_grid3(jnp.asarray(a)), depth_mult),
                          jps3.z_sharding(_jmesh()))


def _split(ndev, n, *arrays):
    lay = S.z_layout(n, ["cpu"] * ndev)
    return tuple(S.shard(_th(a), lay) for a in arrays)


def _nl(n, mult):
    """JAX's planes per device of an n-deep volume padded to ×mult."""
    return M.padded_depth3(n, mult) // NDEV


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rtol * float(np.abs(want).max())


def _crop(a, n):
    return grid3_from_jax(a, n).numpy()


# --- the policy, the split and the convert helpers -------------------------------------

@pytest.mark.parametrize("ndev", [2, 3, 4, 8])
@pytest.mark.parametrize("threshold", [8, 20])
def test_policy_matches_jax(ndev, threshold):
    theirs = jps3.ZShardingPolicy3(_jmesh(ndev), threshold_planes=threshold)
    ours = policy3_from_jax(theirs)
    assert ours.n_devices == theirs.n_devices == ndev
    cyc = KS3.CyclePolicy3(ours.mesh, threshold)
    for n in (17, 33, 64, 65, 66, 129, 257, 513):
        assert ours.is_sharded(n) == theirs.is_sharded(n)
        assert ours.padded_depth(n) == theirs.padded_depth(n)
        assert M.padded_depth3(n, ndev) == jps3.padded_depth3(n, ndev)
        assert (ours.spec(n) != ()) == (theirs.spec(n) != jax.sharding.PartitionSpec())
        # v_cycle3_sharded's own rule (pallas_shard3.py:761-763)
        assert cyc.is_sharded(n) == (ndev > 1 and n >= 65 and jps3.padded_depth3(n, ndev)
                                     // ndev >= threshold)


@pytest.mark.parametrize("ndev", RINGS + [4])
def test_zplane_split_and_halos(ndev):
    """Blocks are contiguous plane ranges with even origins (the last one
    ragged); a halo deeper than a neighbour's block is assembled from every
    block it overlaps, zero beyond the grid."""
    n = 65
    u = _th(_fields(n)[0])
    lay = S.layout_of(_policy(ndev, threshold=2), n)
    assert lay == S.z_layout(n, ["cpu"] * ndev)
    assert lay.dim == 3 and lay.cols == ((0, n),)
    assert all(z0 % 2 == 0 for z0, _ in lay.rows) and lay.rows[-1][1] == n
    us = S.shard(u, lay)
    assert us.shape == (n, n, n) and torch.equal(S.gather(us), u)
    for i, (z0, z1) in enumerate(lay.rows):
        for ext in (1, 6, 11):
            got = S.extend(us, i, 0, ext)
            want = torch.zeros((z1 - z0 + 2 * ext, n, n))
            lo, hi = max(0, z0 - ext), min(n, z1 + ext)
            want[lo - (z0 - ext):hi - (z0 - ext)] = u[lo:hi]
            assert torch.equal(got, want)
    other = S.layout_of(_policy(5, threshold=2), n)
    assert torch.equal(S.gather(S.as_level(us, _policy(5, threshold=2), n)), u)
    assert S.as_level(us, _policy(5, threshold=2), n).layout == other
    assert torch.equal(S.psum([torch.tensor(1.5, dtype=torch.float64)] * ndev),
                       torch.tensor(1.5 * ndev, dtype=torch.float64))


def test_convert_helpers():
    theirs = jps3.ZShardingPolicy3(_jmesh(), threshold_planes=8)
    ours = policy3_from_jax(theirs)
    assert ours.mesh.axis_names == ("z",) and ours.threshold_planes == 8
    u = _fields(65)[0]
    jarr = jax.device_put(jps3.pad_planes3(jp3k.pad_grid3(jnp.asarray(u)), 2 * NDEV),
                          jps3.z_sharding(_jmesh()))
    lvl = sharded3_from_jax(jarr, ours, 65)
    assert isinstance(lvl, S.ShardedGrid) and torch.equal(S.gather(lvl), _th(u))
    assert isinstance(sharded3_from_jax(jp3k.pad_grid3(jnp.asarray(_fields(33)[0])), ours, 33),
                      torch.Tensor)
    with pytest.raises(TypeError):
        policy3_from_jax(object())


# --- each shard mode against the port's unsharded twin, on 2, 3 and 8 shards ---------

def _sweeps(u, f, h, steps, fz):
    first = True
    while steps > 0:
        k = min(steps, 8)
        u = K3.fused_jacobi3_torch(u, f, h, k, OMEGA3, fz and first)
        steps -= k
        first = False
    return u


@pytest.mark.parametrize("ndev", RINGS)
@pytest.mark.parametrize("steps,fz", [(1, False), (3, True), (11, False)])
def test_jacobi3_shard_bitmatches_unsharded(ndev, steps, fz):
    n, h = 33, 1.0 / 32
    u, f, _ = _fields(n)
    us, fs = _split(ndev, n, u, f)
    got = KS3.sharded_fused_jacobi3(us, fs, h, steps, OMEGA3, fz, nl=_nl(n, NDEV))
    assert torch.equal(S.gather(got), _sweeps(_th(u), _th(f), h, steps, fz))


@pytest.mark.parametrize("ndev", RINGS)
@pytest.mark.parametrize("compat", ["clean", "gpu"])
def test_jacobi3_err_shard_matches_unsharded(ndev, compat):
    """Iterates bit for bit; the error is the shards' float64 sums added in
    shard order and rounded once, the unsharded sum's but for the order of a
    float64 sum."""
    n, h = 33, 1.0 / 32
    u, f, _ = _fields(n)
    us, fs = _split(ndev, n, u, f)
    for steps, fz in ((1, False), (3, True), (7, False)):
        gu, ge = KS3.sharded_fused_jacobi3_err(us, fs, h, steps, OMEGA3, compat, fz,
                                               nl=_nl(n, NDEV))
        wu, we = K3.fused_jacobi3_err_torch(_th(u), _th(f), h, steps, OMEGA3, compat, fz)
        assert torch.equal(S.gather(gu), wu)
        assert float(ge) == pytest.approx(float(we), rel=1e-6)


@pytest.mark.parametrize("ndev", RINGS)
@pytest.mark.parametrize("compat", ["clean", "gpu"])
def test_per_sweep_errors_are_the_one_sweep_steps(ndev, compat):
    """errs[s − 1] of a per-sweep pass is the error the s-th one-sweep step of
    a sharded trigger loop reports, bit for bit; the iterate is the unsharded
    one."""
    n, h = 33, 1.0 / 32
    u, f, _ = _fields(n)
    us, fs = _split(ndev, n, u, f)
    nl = _nl(n, NDEV)
    steps = 4 if compat == "clean" else 5   # the halo (+1 for clean) within nl = 5
    gu, ge = KS3.sharded_fused_jacobi3_errs(us, fs, h, steps, OMEGA3, compat, nl)
    assert torch.equal(S.gather(gu), _sweeps(_th(u), _th(f), h, steps, False))
    v = us
    for s in range(steps):
        v, e = KS3.sharded_trigger_step3(v, fs, h, OMEGA3, compat, nl)
        assert torch.equal(ge[s], e)
    with pytest.raises(ValueError, match="halo planes"):
        KS3.sharded_fused_jacobi3_errs(us, fs, h, steps + 1, OMEGA3, compat, nl)


@pytest.mark.parametrize("ndev", RINGS)
@pytest.mark.parametrize("steps,fz,negate", [(3, False, True), (3, True, True), (1, True, False),
                                             (7, False, False)])
def test_smooth_residual3_shard_bitmatches_pair(ndev, steps, fz, negate):
    """Kernel 10's emit_residual mode per shard: the iterate and its
    (negated) residual, bit for bit the unsharded sweeps and residual, and
    the whole-grid form."""
    n, h = 65, 1.0 / 64
    u, f, _ = _fields(n)
    us, fs = _split(ndev, n, u, f)
    gu, gr = KS3.sharded_smooth_residual3(us, fs, h, steps, OMEGA3, fz, negate,
                                          nl=_nl(n, 2 * NDEV))
    wu = _sweeps(_th(u), _th(f), h, steps, fz)
    assert torch.equal(S.gather(gu), wu)
    assert torch.equal(S.gather(gr), K3.residual3_torch(wu, _th(f), h, negate))
    ku, kr = K3.fused_jacobi3_residual(_th(u), _th(f), h, steps, OMEGA3, fz, negate)
    assert torch.equal(ku, wu) and torch.equal(kr, S.gather(gr))


def test_smooth_residual3_falls_back_to_the_pair(monkeypatch):
    """Beyond the fused form's 7 sweeps, or JAX's nl, the pair of passes."""
    n, h = 33, 1.0 / 32
    u, f, _ = _fields(n)
    us, fs = _split(NDEV, n, u, f)
    calls = []
    monkeypatch.setattr(K3, "fused_jacobi3_residual_shard",
                        lambda *a, **k: calls.append(1) or K3.fused_jacobi3_residual_shard_torch(
                            *a, **k))
    for steps, nl in ((8, 10), (5, 5)):
        gu, gr = KS3.sharded_smooth_residual3(us, fs, h, steps, OMEGA3, False, True, nl)
        wu = _sweeps(_th(u), _th(f), h, steps, False)
        assert torch.equal(S.gather(gu), wu)
        assert torch.equal(S.gather(gr), K3.residual3_torch(wu, _th(f), h, True))
    assert not calls


@pytest.mark.parametrize("ndev", RINGS)
def test_residual3_shard_bitmatches_unsharded(ndev):
    n, h = 33, 1.0 / 32
    u, f, _ = _fields(n)
    us, fs = _split(ndev, n, u, f)
    for negate in (False, True):
        assert torch.equal(S.gather(KS3.sharded_residual3(us, fs, h, negate)),
                           K3.residual3_torch(_th(u), _th(f), h, negate))


@pytest.mark.parametrize("ndev", RINGS)
@pytest.mark.parametrize("restriction,fz,steps", [("full_weighting", False, 3),
                                                  ("full_weighting", True, 6),
                                                  ("sampling", True, 3)])
def test_descend3_shard_bitmatches_unsharded(ndev, restriction, fz, steps):
    n, h = 65, 1.0 / 64
    u, f, _ = _fields(n)
    us, fs = _split(ndev, n, u, f)
    pol = _policy(ndev)
    gu, gfc, ge = KS3.sharded_fused_descend3(us, fs, h, steps, OMEGA3, fz, restriction, True,
                                             nl=pol.planes_per_device(n))
    wu, wfc, we = K3.fused_descend3_torch(_th(u), _th(f), h, steps, OMEGA3, fz, restriction, True)
    assert torch.equal(S.gather(gu), wu) and torch.equal(S.gather(gfc), wfc)
    assert float(ge) == pytest.approx(float(we), rel=1e-6)
    # the coarse slabs start at each shard's origin / 2
    assert [r for r in gfc.layout.rows] == [(a // 2, (b + 1) // 2) for a, b in us.layout.rows]


@pytest.mark.parametrize("ndev", RINGS)
@pytest.mark.parametrize("steps,want_err", [(1, False), (3, True), (8, False)])
def test_ascend3_shard_bitmatches_unsharded(ndev, steps, want_err):
    """The coarse correction in any layout: sharded as its level, or a
    replicated tensor."""
    n, h = 65, 1.0 / 64
    u, f, c = _fields(n)
    us, fs = _split(ndev, n, u, f)
    wu, we = K3.fused_ascend3_torch(_th(u), _th(f), _th(c), h, steps, OMEGA3, want_err)
    for child in (_th(c), S.shard(_th(c), S.z_layout(33, ["cpu"] * 3))):
        gu, ge = KS3.sharded_fused_ascend3(us, fs, child, h, steps, OMEGA3, want_err,
                                           nl=_policy(ndev).planes_per_device(n))
        assert torch.equal(S.gather(gu), wu)
        if want_err:
            assert float(ge) == pytest.approx(float(we), rel=1e-6)
        else:
            assert ge is None


def test_legs_refuse_what_jax_refuses():
    """JAX's planes per device decide: an odd nl, or a halo deeper than nl."""
    n, h = 65, 1.0 / 64
    u, f, c = _fields(n)
    us, fs = _split(NDEV, n, u, f)
    with pytest.raises(ValueError, match="even plane count"):
        KS3.sharded_fused_descend3(us, fs, h, 3, OMEGA3, nl=9)
    with pytest.raises(ValueError, match="even plane count"):
        KS3.sharded_fused_descend3(us, fs, h, 6, OMEGA3, nl=6)
    with pytest.raises(ValueError, match="even plane count"):
        KS3.sharded_fused_ascend3(us, fs, _th(c), h, 3, OMEGA3, nl=9)


@pytest.mark.parametrize("ndev", RINGS)
def test_plain_per_shard_ops_bitmatch_the_oracle(ndev):
    """parallel.halo3 (kernels="torch" under a policy): sweeps and residual
    bit for bit, both errors the oracle's but for a float64 sum's order."""
    n, h = 33, 1.0 / 32
    u, f, _ = _fields(n)
    us, fs = _split(ndev, n, u, f)
    want = _th(u)
    for _ in range(3):
        want = p3.jacobi_sweep3(want, _th(f), h, OMEGA3)
    got = halo3.sharded_smooth3(us, fs, h, 3, OMEGA3)
    assert torch.equal(S.gather(got), want)
    assert torch.equal(S.gather(halo3.sharded_residual3(got, fs, h)), p3.residual3(want, _th(f), h))
    for compat in ("clean", "gpu"):
        gu, ge = halo3.sharded_smooth3_err(us, fs, h, 3, OMEGA3, compat)
        wu, we = p3.smooth3(_th(u), _th(f), h, 3, OMEGA3, compat)
        assert torch.equal(S.gather(gu), wu)
        assert float(ge) == pytest.approx(float(we), rel=1e-6)


# --- each shard mode against JAX's sharded call (8-device mesh, interpret) -------------

@functools.lru_cache(maxsize=None)
def _jax_call(name, n, steps=3, fz=False, compat=None, negate=False, restriction=None):
    """JAX's sharded call on the 8-device mesh, cached per input."""
    u, f, c = _fields(n)
    h = 1.0 / (n - 1)
    mesh = _jmesh()
    if name in ("descend", "ascend"):
        us, fs = _jsharded(np.zeros_like(u) if fz else u, 2 * NDEV), _jsharded(f, 2 * NDEV)
    else:
        us, fs = _jsharded(np.zeros_like(u) if fz else u, NDEV), _jsharded(f, NDEV)
    with mesh:
        if name == "jacobi":
            return jps3.sharded_fused_jacobi3(us, fs, n, h, steps, OMEGA3, mesh, from_zero=fz,
                                              interpret=True)
        if name == "err":
            return jps3.sharded_fused_jacobi3_err(us, fs, n, h, steps, OMEGA3, compat, mesh,
                                                  from_zero=fz, interpret=True)
        if name == "errs":
            return jps3.sharded_fused_jacobi3_errs(us, fs, n, h, steps, OMEGA3, compat, mesh,
                                                   interpret=True)
        if name == "smooth_residual":
            return jps3.sharded_smooth_residual3(us, fs, n, h, steps, OMEGA3, mesh, from_zero=fz,
                                                 negate=negate, interpret=True)
        if name == "residual":
            return jps3.sharded_residual3_pallas(us, fs, n, h, mesh, negate=negate,
                                                 interpret=True)
        if name == "descend":
            ju, dw, err = jps3.sharded_fused_descend3(us, fs, n, h, steps, OMEGA3, mesh,
                                                      from_zero=fz, restriction=restriction,
                                                      interpret=True)
            return ju, jpd3.restrict3_lanes_p(dw, n, (n + 1) // 2), err
        m = (n + 1) // 2
        ec = jp3k.pad_grid3(jnp.asarray(c))
        ecs = jax.device_put(jnp.concatenate(
            [ec, jnp.zeros((us.shape[0] // 2 - ec.shape[0],) + ec.shape[1:], ec.dtype)], 0),
            jps3.z_sharding(mesh))
        cw = jax.device_put(jpd3.prolong3_lanes_p(ecs, n, m), jps3.z_sharding(mesh))
        return jps3.sharded_fused_ascend3(us, fs, cw, n, h, steps, OMEGA3, mesh,
                                          err_mode=compat, interpret=True)


def _port(ndev, n):
    u, f, c = _fields(n)
    return _split(ndev, n, u, f) + (_th(c),)


@pytest.mark.parametrize("steps,fz", [(3, False), (11, False), (4, True)])
def test_jacobi3_matches_jax_sharded(steps, fz):
    n, h = 33, 1.0 / 32
    us, fs, _ = _port(NDEV, n)
    got = KS3.sharded_fused_jacobi3(us, fs, h, steps, OMEGA3, fz, nl=_nl(n, NDEV))
    _close(S.gather(got), _crop(_jax_call("jacobi", n, steps, fz), n), U_RTOL)


@pytest.mark.parametrize("compat,steps", [("clean", 3), ("gpu", 5)])
def test_jacobi3_err_matches_jax_sharded(compat, steps):
    n, h = 33, 1.0 / 32
    us, fs, _ = _port(NDEV, n)
    gu, ge = KS3.sharded_fused_jacobi3_err(us, fs, h, steps, OMEGA3, compat, nl=_nl(n, NDEV))
    ju, jraw = _jax_call("err", n, steps, compat=compat)
    _close(S.gather(gu), _crop(ju, n), U_RTOL)
    assert float(ge) == pytest.approx(float(jraw) / n ** 3, rel=ERR_RTOL)


@pytest.mark.parametrize("compat,steps", [("clean", 3), ("gpu", 4)])
def test_jacobi3_errs_matches_jax_sharded(compat, steps):
    n, h = 33, 1.0 / 32
    us, fs, _ = _port(NDEV, n)
    gu, ge = KS3.sharded_fused_jacobi3_errs(us, fs, h, steps, OMEGA3, compat, nl=_nl(n, NDEV))
    ju, jerrs = _jax_call("errs", n, steps, compat=compat)
    _close(S.gather(gu), _crop(ju, n), U_RTOL)
    np.testing.assert_allclose(ge.numpy(), np.asarray(jerrs), rtol=ERR_RTOL)


@pytest.mark.parametrize("fz,negate", [(False, True), (True, False)])
def test_smooth_residual3_matches_jax_sharded(fz, negate):
    n, h = 33, 1.0 / 32
    us, fs, _ = _port(NDEV, n)
    gu, gr = KS3.sharded_smooth_residual3(us, fs, h, 3, OMEGA3, fz, negate, nl=_nl(n, NDEV))
    ju, jr = _jax_call("smooth_residual", n, 3, fz, negate=negate)
    want_u = _crop(ju, n)
    _close(S.gather(gu), want_u, U_RTOL)
    # JAX's r is 6Δ/(ωh²) of one more sweep, the port's the direct stencil:
    # the cancellation noise of a 7-point sum, eps·|u|/h² per term, over the
    # iterates' ulps
    atol = 4 * 12 * 1.2e-7 * float(np.abs(want_u).max()) / (h * h)
    np.testing.assert_allclose(S.gather(gr).numpy(), _crop(jr, n), rtol=0, atol=atol)


def test_residual3_matches_jax_sharded():
    n, h = 33, 1.0 / 32
    u = _fields(n)[0]
    us, fs, _ = _port(NDEV, n)
    got = KS3.sharded_residual3(us, fs, h, True)
    atol = 12 * 1.2e-7 * float(np.abs(u).max()) / (h * h)
    np.testing.assert_allclose(S.gather(got).numpy(),
                               _crop(_jax_call("residual", n, negate=True), n), rtol=0, atol=atol)


@pytest.mark.parametrize("restriction,fz", [("full_weighting", False), ("full_weighting", True),
                                            ("sampling", True)])
def test_descend3_matches_jax_sharded(restriction, fz):
    n, h = 65, 1.0 / 64
    us, fs, _ = _port(NDEV, n)
    nl = _nl(n, 2 * NDEV)
    gu, gfc, ge = KS3.sharded_fused_descend3(us, fs, h, 3, OMEGA3, fz, restriction, True, nl)
    ju, jfc, jerr = _jax_call("descend", n, 3, fz, restriction=restriction)
    _close(S.gather(gu), _crop(ju, n), U_RTOL)
    _close(S.gather(gfc), _crop(jfc, 33), FC_RTOL)
    assert float(ge) == pytest.approx(float(jerr) / n ** 3, rel=ERR_RTOL)


@pytest.mark.parametrize("compat", [None, "clean"])
def test_ascend3_matches_jax_sharded(compat):
    n, h = 65, 1.0 / 64
    us, fs, c = _port(NDEV, n)
    gu, ge = KS3.sharded_fused_ascend3(us, fs, c, h, 3, OMEGA3, compat is not None,
                                       nl=_nl(n, 2 * NDEV))
    theirs = _jax_call("ascend", n, 3, compat=compat)
    if compat is None:
        _close(S.gather(gu), _crop(theirs, n), U_RTOL)
    else:
        _close(S.gather(gu), _crop(theirs[0], n), U_RTOL)
        assert float(ge) == pytest.approx(float(theirs[1]) / n ** 3, rel=ERR_RTOL)


# --- v_cycle3_sharded -------------------------------------------------------------------

ROUTED = {"fused_jacobi3_shard": "jacobi3_shard", "fused_jacobi3_residual_shard": "10r",
          "fused_descend3_shard": "descend3_shard", "fused_ascend3_shard": "ascend3_shard",
          "fused_descend3": "descend3", "fused_ascend3": "ascend3"}


def _spy_routes(monkeypatch):
    calls = dict.fromkeys(ROUTED.values(), 0)
    for name, key in ROUTED.items():
        fn = getattr(K3, name)
        monkeypatch.setattr(K3, name, lambda *a, _f=fn, _k=key, **kw: (
            calls.__setitem__(_k, calls[_k] + 1), _f(*a, **kw))[1])
    return calls


def _cycle_data(n):
    prob = jp3.REFERENCE_PROBLEM_3D
    f = np.asarray((prob.source_grid(n) + prob.boundary_grid(n)).astype(jnp.float32))
    u = np.asarray(prob.boundary_grid(n).astype(jnp.float32))
    return u, f


def _v_cycle_case(monkeypatch, n, pre, want_routes):
    u, f = _cycle_data(n)
    h = 1.0 / (n - 1)
    monkeypatch.setattr(K, "use_kernels", lambda kernels, device: kernels != "torch")
    calls = _spy_routes(monkeypatch)
    mesh = M.make_mesh_z(["cpu"] * NDEV)
    got = S.gather(KS3.v_cycle3_sharded(_th(u), _th(f), h, mesh, pre=pre, post=3))
    assert calls == want_routes
    # the port's unsharded kernel path (twins), bit for bit
    assert torch.equal(got, p3.v_cycle3(_th(u), _th(f), h, pre=pre, post=3, omega=OMEGA3))
    # the plain path, bit for bit the plain v_cycle3
    plain = S.gather(KS3.v_cycle3_sharded(_th(u), _th(f), h, mesh, pre=pre, post=3,
                                          kernels="torch"))
    assert torch.equal(plain, p3.v_cycle3(_th(u), _th(f), h, pre=pre, post=3, omega=OMEGA3,
                                          kernels="torch"))
    return got, u, f


def test_v_cycle3_sharded_65_matches_jax_and_unsharded(monkeypatch):
    """65³ on 8 shards: JAX's top depth 80 (nl 10) takes both legs per shard;
    33³ down runs replicated."""
    n = 65
    got, u, f = _v_cycle_case(monkeypatch, n, 3, {"jacobi3_shard": 0, "10r": 0,
                                                  "descend3_shard": 8, "ascend3_shard": 8,
                                                  "descend3": 0, "ascend3": 0})
    with _jmesh():
        want = jps3.v_cycle3_sharded(jnp.asarray(u), jnp.asarray(f), n, 1.0 / (n - 1), _jmesh(),
                                     interpret=True)
    _close(got, np.asarray(want), CYCLE_RTOL)


def test_v_cycle3_sharded_routes_the_emit_residual_fallback(monkeypatch):
    """pre = 7 is over the fused descend leg's cap: the emit_residual pass
    per shard and the restriction; the coarse level then has JAX's depth 33,
    not half of 80, so the prolongation and add and the shard smoother."""
    _v_cycle_case(monkeypatch, 65, 7, {"jacobi3_shard": 8, "10r": 8, "descend3_shard": 0,
                                       "ascend3_shard": 0, "descend3": 0, "ascend3": 0})


@pytest.mark.slow
def test_v_cycle3_sharded_129_matches_jax_and_unsharded(monkeypatch):
    """129³: JAX's depths 144 (nl 18) then 72 (nl 9, odd): the legs per shard
    at 129³, the emit_residual pass, the restriction, the prolongation and
    the shard smoother at 65³."""
    n = 129
    got, u, f = _v_cycle_case(monkeypatch, n, 3, {"jacobi3_shard": 8, "10r": 8,
                                                  "descend3_shard": 8, "ascend3_shard": 8,
                                                  "descend3": 0, "ascend3": 0})
    with _jmesh():
        want = jps3.v_cycle3_sharded(jnp.asarray(u), jnp.asarray(f), n, 1.0 / (n - 1), _jmesh(),
                                     interpret=True)
    _close(got, np.asarray(want), CYCLE_RTOL)


def test_v_cycle3_sharded_refuses_rdma(monkeypatch):
    """halo="rdma" takes the ring kernels on a ring of shards on one card (on
    the CPU their twins: the ppermute cycle, bit for bit); it is refused on
    a mesh over several cards, where one launch cannot span the ring, and an
    unknown halo is refused."""
    u, f = _cycle_data(65)
    mesh = M.make_mesh_z(["cpu"] * NDEV)
    monkeypatch.setattr(K, "use_kernels", lambda kernels, device: kernels != "torch")
    got = KS3.v_cycle3_sharded(_th(u), _th(f), 1.0 / 64, mesh, halo="rdma")
    assert torch.equal(S.gather(got), S.gather(KS3.v_cycle3_sharded(_th(u), _th(f), 1.0 / 64,
                                                                    mesh)))
    monkeypatch.setattr(K, "use_kernels", lambda kernels, device: True)
    with pytest.raises(ValueError, match="one card.*halo='ppermute'"):
        KS3.v_cycle3_sharded(_th(u), _th(f), 1.0 / 64, M.make_mesh_z(["cuda:0", "cuda:1"] * 4),
                             halo="rdma")
    with pytest.raises(ValueError, match="unknown halo"):
        KS3.v_cycle3_sharded(_th(u), _th(f), 1.0 / 64, mesh, halo="nccl")


def test_v_cycle3_sharded_small_grid_runs_replicated():
    """A grid too small to shard is the port's v_cycle3."""
    u, f = _cycle_data(33)
    got = KS3.v_cycle3_sharded(_th(u), _th(f), 1.0 / 32, M.make_mesh_z(["cpu"] * NDEV))
    assert isinstance(got, torch.Tensor)
    assert torch.equal(got, p3.v_cycle3(_th(u), _th(f), 1.0 / 32, pre=3, post=3, omega=OMEGA3))
