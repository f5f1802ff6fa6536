"""The 3-D ring kernels of the port (ops.rdma3: kernels 19-22, halo="rdma" on
z-sharded levels) against the JAX package's (ops/pallas_rdma3.py, reached
through parallel/pallas_shard3.py's rdma_fused_* functions).

On the CPU every ring wrapper runs its twin: the plane exchange and the
shard-mode twins of kernels 10-12 on every shard, or the loop of one-sweep
sharded error passes (kernel 19). They are held

  * for routing: the port's copies of JAX's admission predicates equal
    JAX's over a grid of planes per device, padded shapes, sweep counts and
    modes (the phase-H levels of 513³-65³ on 8 and 4 shards among them);
  * against JAX's exchange path (``sharded_fused_*``) at 65³ on a ring of 4
    devices (JAX's own RDMA tests use 4: 8-device interpreter runs of its
    ring kernels deadlock), on tests/test_rdma.py's fields (ω 0.8, trigger
    30), with tests/test_torch_shard3.py's bounds: iterates |Δu| ≤
    1e-5·max|u| (the Pallas sweep folds the update into another form),
    restricted right-hand sides 2e-5·max|f_c|, errors 1e-4 relative (the
    port's clean error is Σ|r|, JAX's 6/(ωh²)·Σ|Δ|), equal trigger sweep
    counts; and once per kernel against JAX's ring kernel itself in
    interpret mode (one in the default set, the others slow);
  * bit for bit against the port's unsharded twins on rings of 2, 3, 8 and
    16 shards of 33³-67³ (ragged last shards; on 33³ over 8 and 65³ over
    16 a shard's window is deeper than its neighbour's block and spans two
    of them), errors within 1e-6 (a float64 sum in another order);
  * for the routes the engines take: compile_program3(policy=...) and
    v_cycle3_sharded with halo="rdma", spied, bit for bit against the same
    runs with halo="ppermute" and JAX's within the bounds above.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multigrid_poisson_solver_tpu as jmg
from multigrid_poisson_solver_tpu import compiled3 as jcompiled3
from multigrid_poisson_solver_tpu.models import poisson3d as jp3
from multigrid_poisson_solver_tpu.ops import padded3 as jpd3
from multigrid_poisson_solver_tpu.ops import pallas3d as jp3k
from multigrid_poisson_solver_tpu.ops import pallas_rdma3 as jr3
from multigrid_poisson_solver_tpu.parallel import pallas_shard3 as jps3
import multigrid_poisson_solver_tpu_torch as tmg
from multigrid_poisson_solver_tpu_torch import compiled3
from multigrid_poisson_solver_tpu_torch.convert import (config_from_jax, grid3_from_jax,
                                                        policy3_from_jax, problem3_from_jax_grids,
                                                        program_from_jax)
from multigrid_poisson_solver_tpu_torch.ops import kernels as K
from multigrid_poisson_solver_tpu_torch.ops import kernels3 as K3
from multigrid_poisson_solver_tpu_torch.ops import rdma as R2
from multigrid_poisson_solver_tpu_torch.ops import rdma3 as R3
from multigrid_poisson_solver_tpu_torch.parallel import halo3
from multigrid_poisson_solver_tpu_torch.parallel import kernel_shard3 as KS3
from multigrid_poisson_solver_tpu_torch.parallel import mesh as M
from multigrid_poisson_solver_tpu_torch.parallel import sharded as S
from multigrid_poisson_solver_tpu_torch.solver import trigger_loop

U_RTOL, FC_RTOL, ERR_RTOL = 1e-5, 2e-5, 1e-4
CYCLE_RTOL = 5e-5          # whole cycles against JAX (tests/test_torch_compiled3_policy.py)
SUM_ORDER_RTOL = 1e-6      # a float64 error sum in another order, rounded to fp32
OMEGA, OMEGA3 = 0.8, 6.0 / 7.0
NDEV = 4                   # JAX's ring (its 8-device interpreter runs of ring kernels deadlock)
N = 65
TRIGGER = 30.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _th(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rtol * float(np.abs(want).max())


# --- the admission predicates -----------------------------------------------------------

NLS = sorted(set(range(1, 21)) | {33, 34, 65, 66, 67, 129, 130, 131})
FITS = {
    "trigger": lambda f, nl, rp, cp, k, fz, err: f.rdma_trigger3_fits(nl, rp, cp),
    "jacobi": lambda f, nl, rp, cp, k, fz, err: f.rdma_jacobi3_fits(nl, rp, cp, k, err=err),
    "descend": lambda f, nl, rp, cp, k, fz, err: f.rdma_descend3_fits(nl, rp, cp, k, fz,
                                                                      fw=not err),
    "ascend": lambda f, nl, rp, cp, k, fz, err: f.rdma_ascend3_fits(nl, rp, cp, k, err),
}


@pytest.mark.parametrize("n", [33, 65, 129, 257, 513, 1025])
@pytest.mark.parametrize("name", list(FITS))
def test_fits_match_jax(name, n):
    """Each copied predicate equals JAX's over planes per device 1-20 and the
    phase-H depths (odd ones, nl < ext, the brick-count edge), 1-8 sweeps,
    from_zero and the error or restriction variant (``err`` doubles as the
    sampling leg for the descend predicate)."""
    _, rp, cp = jp3k.padded_shape3(n)
    assert R3.padded_rc(n) == (rp, cp)
    fits = FITS[name]
    for nl in NLS:
        for k in range(1, 9):
            for fz in (False, True):
                for err in (False, True):
                    ours = fits(R3, nl, rp, cp, k, fz, err)
                    assert ours == fits(jr3, nl, rp, cp, k, fz, err), (nl, k, fz, err)


@pytest.mark.parametrize("n,shards,want", [
    (513, 8, (False, True, True, True)), (257, 8, (True, True, True, True)),
    (129, 8, (True, True, True, True)), (65, 8, (True, True, True, True)),
    (513, 4, (False, False, False, False)), (257, 4, (True, True, True, True))])
def test_phase_h_routes(n, shards, want):
    """The routes of the phase-H levels under ZShardingPolicy3 (nl from the
    policy's ×2P depth): kernel 19 (whole loop), 20 (3 sweeps with the clean
    error), 21 (3 sweeps from zero and not) and 22 (3 sweeps with the error),
    as JAX's predicates decide them."""
    nl = M.ZShardingPolicy3(M.make_mesh_z(["cpu"] * shards)).planes_per_device(n)
    rp, cp = R3.padded_rc(n)
    for f in (R3, jr3):
        got = (f.rdma_trigger3_fits(nl, rp, cp),
               f.rdma_jacobi3_fits(nl, rp, cp, 3) and f.rdma_jacobi3_fits(nl, rp, cp, 3, err=True),
               f.rdma_descend3_fits(nl, rp, cp, 3, True) and f.rdma_descend3_fits(nl, rp, cp, 3,
                                                                                  False),
               f.rdma_ascend3_fits(nl, rp, cp, 3) and f.rdma_ascend3_fits(nl, rp, cp, 3, True))
        assert got == want, (f.__name__, got)


def test_workspace_is_per_ring_and_tags_only_grow():
    """The 3-D workspace holds RING3_HALO planes a side for u (two parities), f
    and the coarse correction, float64 error slots, 64-bit flags; it is keyed
    apart from the 2-D rings', and its tags never repeat."""
    n, shards = 9, 3
    ws = R3._workspace(torch.device("cpu"), shards, n)
    assert ws is R3._workspace(torch.device("cpu"), shards, n)
    assert ws is not R3._workspace(torch.device("cpu"), shards + 1, n)
    assert ws.ubuf.numel() == shards * 4 * R3.RING3_HALO * n * n
    assert ws.fbuf.numel() == shards * 2 * R3.RING3_HALO * n * n
    assert ws.cbuf.numel() == shards * 2 * R3.RING3_HALO * 5 * 5
    assert ws.err.dtype == torch.float64 and ws.err.numel() == shards * 2 * shards
    assert ws.flags.dtype == torch.int64 and ws.flags.numel() == shards * shards
    assert R2._workspace(torch.device("cpu"), shards, n) is not ws
    a, b = ws.take(5), ws.take(1)
    assert b == a + 5 and ws.take(1) == b + 1


# --- the twins against JAX's exchange path at 65³ on 4 shards ------------------------------

@functools.lru_cache(maxsize=None)
def _jmesh():
    return jps3.make_mesh_z(jax.devices()[:NDEV])


@functools.lru_cache(maxsize=None)
def _fields3(seed=13):
    """tests/test_rdma.py's fields: u uniform, f 10 × uniform."""
    rng = np.random.default_rng(seed)
    u = rng.random((N, N, N)).astype(np.float32)
    f = (10 * rng.random((N, N, N))).astype(np.float32)
    return u, f


def _jax_level(a, mult):
    return jax.device_put(jps3.pad_planes3(jp3k.pad_grid3(jnp.asarray(a)), mult),
                          jps3.z_sharding(_jmesh()))


def _port_level(*arrays):
    lay = S.z_layout(N, ["cpu"] * NDEV)
    return tuple(S.shard(_th(a), lay) for a in arrays)


def _nl(mult):
    """JAX's planes per device of the 65-deep volume padded to ×mult."""
    return M.padded_depth3(N, mult) // NDEV


@pytest.mark.parametrize("steps,fz", [(3, False), (5, False), (3, True), (11, False)])
def test_jacobi3_twin_matches_jax(steps, fz):
    u, f = _fields3()
    h = 1.0 / (N - 1)
    uu = np.zeros_like(u) if fz else u
    with _jmesh():
        want = jps3.sharded_fused_jacobi3(_jax_level(uu, NDEV), _jax_level(f, NDEV), N, h, steps,
                                          OMEGA, _jmesh(), from_zero=fz, interpret=True)
    us, fs = _port_level(uu, f)
    got = KS3.rdma_fused_jacobi3(us, fs, h, steps, OMEGA, fz, _nl(NDEV))
    _close(S.gather(got), grid3_from_jax(want, N), U_RTOL)


@pytest.mark.parametrize("compat,steps", [("clean", 3), ("clean", 5), ("gpu", 3), ("gpu", 5)])
def test_jacobi3_err_twin_matches_jax(compat, steps):
    u, f = _fields3()
    h = 1.0 / (N - 1)
    with _jmesh():
        ju, jraw = jps3.sharded_fused_jacobi3_err(_jax_level(u, NDEV), _jax_level(f, NDEV), N, h,
                                                  steps, OMEGA, compat, _jmesh(), interpret=True)
    us, fs = _port_level(u, f)
    gu, ge = KS3.rdma_fused_jacobi3_err(us, fs, h, steps, OMEGA, compat, _nl(NDEV))
    _close(S.gather(gu), grid3_from_jax(ju, N), U_RTOL)
    assert float(ge) == pytest.approx(float(jraw) / N ** 3, rel=ERR_RTOL)


@pytest.mark.parametrize("fz", [False, True])
def test_descend3_twin_matches_jax(fz):
    u, f = _fields3(5)
    h, m = 1.0 / (N - 1), (N + 1) // 2
    uu = np.zeros_like(u) if fz else u
    with _jmesh():
        ju, dw, jerr = jps3.sharded_fused_descend3(_jax_level(uu, 2 * NDEV),
                                                   _jax_level(f, 2 * NDEV), N, h, 3, OMEGA,
                                                   _jmesh(), from_zero=fz, interpret=True)
        jfc = jpd3.restrict3_lanes_p(dw, N, m)
    us, fs = _port_level(uu, f)
    gu, gfc, ge = KS3.rdma_fused_descend3(us, fs, h, 3, OMEGA, fz, "full_weighting", True,
                                          _nl(2 * NDEV))
    _close(S.gather(gu), grid3_from_jax(ju, N), U_RTOL)
    _close(S.gather(gfc), grid3_from_jax(jfc, m), FC_RTOL)
    assert float(ge) == pytest.approx(float(jerr) / N ** 3, rel=ERR_RTOL)


def _jax_cwide(ec, up):
    m = (N + 1) // 2
    ec = jp3k.pad_grid3(jnp.asarray(ec))
    ecc = jnp.concatenate([ec, jnp.zeros((up.shape[0] // 2 - ec.shape[0],) + ec.shape[1:],
                                         ec.dtype)], 0)
    return jax.device_put(jpd3.prolong3_lanes_p(ecc, N, m), jps3.z_sharding(_jmesh()))


@pytest.mark.parametrize("want_err", [False, True])
def test_ascend3_twin_matches_jax(want_err):
    u, f = _fields3(6)
    h, m = 1.0 / (N - 1), (N + 1) // 2
    ec = np.random.default_rng(6).random((m, m, m)).astype(np.float32)
    up, fp = _jax_level(u, 2 * NDEV), _jax_level(f, 2 * NDEV)
    with _jmesh():
        theirs = jps3.sharded_fused_ascend3(up, fp, _jax_cwide(ec, up), N, h, 3, OMEGA, _jmesh(),
                                            err_mode="clean" if want_err else None,
                                            interpret=True)
    us, fs = _port_level(u, f)
    gu, ge = KS3.rdma_fused_ascend3(us, fs, _th(ec), h, 3, OMEGA, want_err, _nl(2 * NDEV))
    ju = theirs[0] if want_err else theirs
    _close(S.gather(gu), grid3_from_jax(ju, N), U_RTOL)
    if want_err:
        assert float(ge) == pytest.approx(float(theirs[1]) / N ** 3, rel=ERR_RTOL)
    else:
        assert ge is None


def _jax_trigger_loop(compat, up, fp, h, max_sweeps=50):
    """tests/test_rdma.py's reference: the loop of one-sweep sharded error
    passes with the reference's stop rule."""
    v, prev, k = up, None, 0
    with _jmesh():
        while True:
            v, raw = jps3.sharded_fused_jacobi3_err(v, fp, N, h, 1, OMEGA, compat, _jmesh(),
                                                    interpret=True)
            e = float(raw) / N ** 3
            k += 1
            if (prev is not None and abs(e - prev) <= TRIGGER) or k >= max_sweeps:
                return v, e, k
            prev = e


@pytest.mark.parametrize("compat", ["clean", "gpu"])
def test_trigger3_twin_matches_jax(compat):
    u, f = _fields3()
    h = 1.0 / (N - 1)
    jv, je, jk = _jax_trigger_loop(compat, _jax_level(u, NDEV), _jax_level(f, NDEV), h)
    assert jk < 50
    us, fs = _port_level(u, f)
    gu, ge, gk = KS3.rdma_fused_trigger3(us, fs, h, OMEGA, compat, TRIGGER, 50)
    assert int(gk) == jk
    _close(S.gather(gu), grid3_from_jax(jv, N), U_RTOL)
    assert float(ge) == pytest.approx(je, rel=ERR_RTOL)


# --- once per kernel against JAX's ring kernel itself (interpret mode) --------------------

def test_jacobi3_matches_jax_ring_kernel():
    """Kernel 20's path against ``rdma_fused_jacobi3_err`` (JAX's
    ``_rdma_jacobi3_kernel`` in the race-detecting interpreter)."""
    u, f = _fields3()
    h = 1.0 / (N - 1)
    with _jmesh():
        ju, jraw = jps3.rdma_fused_jacobi3_err(_jax_level(u, NDEV), _jax_level(f, NDEV), N, h, 5,
                                               OMEGA, "gpu", _jmesh(), interpret=True)
    us, fs = _port_level(u, f)
    gu, ge = KS3.rdma_fused_jacobi3_err(us, fs, h, 5, OMEGA, "gpu", _nl(NDEV))
    _close(S.gather(gu), grid3_from_jax(ju, N), U_RTOL)
    assert float(ge) == pytest.approx(float(jraw) / N ** 3, rel=ERR_RTOL)


@pytest.mark.slow
def test_descend3_matches_jax_ring_kernel():
    u, f = _fields3(5)
    h, m = 1.0 / (N - 1), (N + 1) // 2
    with _jmesh():
        ju, dw, jerr = jps3.rdma_fused_descend3(_jax_level(u, 2 * NDEV), _jax_level(f, 2 * NDEV),
                                                N, h, 3, OMEGA, _jmesh(), interpret=True)
        jfc = jpd3.restrict3_lanes_p(dw, N, m)
    us, fs = _port_level(u, f)
    gu, gfc, ge = KS3.rdma_fused_descend3(us, fs, h, 3, OMEGA, False, "full_weighting", True,
                                          _nl(2 * NDEV))
    _close(S.gather(gu), grid3_from_jax(ju, N), U_RTOL)
    _close(S.gather(gfc), grid3_from_jax(jfc, m), FC_RTOL)
    assert float(ge) == pytest.approx(float(jerr) / N ** 3, rel=ERR_RTOL)


@pytest.mark.slow
def test_ascend3_matches_jax_ring_kernel():
    u, f = _fields3(6)
    h, m = 1.0 / (N - 1), (N + 1) // 2
    ec = np.random.default_rng(6).random((m, m, m)).astype(np.float32)
    up, fp = _jax_level(u, 2 * NDEV), _jax_level(f, 2 * NDEV)
    with _jmesh():
        ju, jraw = jps3.rdma_fused_ascend3(up, fp, _jax_cwide(ec, up), N, h, 3, OMEGA, _jmesh(),
                                           err_mode="clean", interpret=True)
    us, fs = _port_level(u, f)
    gu, ge = KS3.rdma_fused_ascend3(us, fs, _th(ec), h, 3, OMEGA, True, _nl(2 * NDEV))
    _close(S.gather(gu), grid3_from_jax(ju, N), U_RTOL)
    assert float(ge) == pytest.approx(float(jraw) / N ** 3, rel=ERR_RTOL)


@pytest.mark.slow
def test_trigger3_matches_jax_ring_kernel():
    u, f = _fields3()
    h = 1.0 / (N - 1)
    with _jmesh():
        ju, jerr = jps3.rdma_fused_trigger3(_jax_level(u, NDEV), _jax_level(f, NDEV), N, h,
                                            TRIGGER, OMEGA, "clean", 50, _jmesh(), interpret=True)
    us, fs = _port_level(u, f)
    gu, ge, gk = KS3.rdma_fused_trigger3(us, fs, h, OMEGA, "clean", TRIGGER, 50)
    assert int(gk) == _jax_trigger_loop("clean", _jax_level(u, NDEV), _jax_level(f, NDEV), h)[2]
    _close(S.gather(gu), grid3_from_jax(ju, N), U_RTOL)
    assert float(ge) == pytest.approx(float(jerr), rel=ERR_RTOL)


# --- ragged shards and deep halos, bit for bit against the unsharded twins -----------------

RINGS = [(65, 2), (65, 3), (65, 8), (67, 2), (67, 3), (67, 8), (33, 8), (65, 16)]


@functools.lru_cache(maxsize=None)
def _volumes(n):
    rng = np.random.default_rng(4000 + n)
    m = (n + 1) // 2
    return (_th(rng.standard_normal((n, n, n)).astype(np.float32)),
            _th(rng.standard_normal((n, n, n)).astype(np.float32)),
            _th(rng.standard_normal((m, m, m)).astype(np.float32)))


def _ring(n, shards):
    u, f, c = _volumes(n)
    lay = S.z_layout(n, ["cpu"] * shards)
    return u, f, c, S.shard(u, lay), S.shard(f, lay)


@pytest.mark.parametrize("n,shards", RINGS)
def test_jacobi3_twin_bitmatches_unsharded(n, shards):
    u, f, _, us, fs = _ring(n, shards)
    h = 1.0 / (n - 1)
    for steps, fz, mode in ((1, False, None), (8, True, "clean"), (3, False, "clean"),
                            (8, False, "gpu")):
        got, raws = R3.rdma_jacobi3(us, fs, h, steps, OMEGA3, fz, mode)
        if mode is None:
            assert torch.equal(S.gather(got), K3.fused_jacobi3_torch(u, f, h, steps, OMEGA3, fz))
            continue
        wu, we = K3.fused_jacobi3_err_torch(u, f, h, steps, OMEGA3, mode, fz)
        assert torch.equal(S.gather(got), wu)
        assert len(raws) == shards
        assert float(halo3.sum_err3(raws, mode, n, h, torch.float32, fs)) == pytest.approx(
            float(we), rel=SUM_ORDER_RTOL)


@pytest.mark.parametrize("n,shards", RINGS)
def test_descend3_twin_bitmatches_unsharded(n, shards):
    u, f, _, us, fs = _ring(n, shards)
    h = 1.0 / (n - 1)
    for steps, fz, restriction in ((3, False, "full_weighting"), (1, True, "full_weighting"),
                                   (7, False, "sampling")):
        gu, gfc, raws = R3.rdma_descend3(us, fs, h, steps, OMEGA3, fz, restriction, True)
        wu, wfc, we = K3.fused_descend3_torch(u, f, h, steps, OMEGA3, fz, restriction, True)
        assert gfc.layout == R3.coarse_layout3(fs)
        assert torch.equal(S.gather(gu), wu) and torch.equal(S.gather(gfc), wfc)
        assert float(halo3.sum_err3(raws, "clean", n, h, torch.float32, fs)) == pytest.approx(
            float(we), rel=SUM_ORDER_RTOL)


@pytest.mark.parametrize("n,shards", RINGS)
def test_ascend3_twin_bitmatches_unsharded(n, shards):
    """Every layout of the coarse correction: one tensor, the shards' coarse
    blocks, the coarse level's own split."""
    u, f, c, us, fs = _ring(n, shards)
    h, m = 1.0 / (n - 1), (n + 1) // 2
    children = (c, S.shard(c, R3.coarse_layout3(fs)), S.shard(c, S.z_layout(m, ["cpu"] * 2)))
    for steps, want_err in ((3, False), (7, True), (8, False)):
        wu, we = K3.fused_ascend3_torch(u, f, c, h, steps, OMEGA3, want_err)
        for child in children:
            gu, raws = R3.rdma_ascend3(us, fs, child, h, steps, OMEGA3, want_err)
            assert torch.equal(S.gather(gu), wu)
            if want_err:
                assert float(halo3.sum_err3(raws, "clean", n, h, torch.float32, fs)) == pytest.approx(
                    float(we), rel=SUM_ORDER_RTOL)
            else:
                assert raws is None


@pytest.mark.parametrize("n,shards", RINGS)
def test_trigger3_twin_bitmatches_unsharded(n, shards):
    """A trigger of 0 runs the cap: the iterate after 6 sweeps is the
    unsharded loop's; the sweep count is the cap."""
    u, f, _, us, fs = _ring(n, shards)
    h = 1.0 / (n - 1)
    for compat in ("clean", "gpu"):
        gu, ge, gk = R3.rdma_trigger3(us, fs, h, OMEGA3, compat, 0.0, 6)
        wu, we, wk = K3.trigger_smooth3_torch(u, f, h, OMEGA3, compat, 0.0, 6)
        assert int(gk) == int(wk) == 6 and gk.dtype == torch.int32
        assert torch.equal(S.gather(gu), wu)
        assert float(ge) == pytest.approx(float(we), rel=SUM_ORDER_RTOL)


def test_trigger3_twin_is_the_one_sweep_loop():
    """Kernel 19's twin stops where the loop of ``sharded_trigger_step3``
    stops, with its iterate and error bit for bit."""
    u, f, _, us, fs = _ring(65, 3)
    h = 1.0 / 64
    errs, v = [], us
    for _ in range(12):
        v, e = KS3.sharded_trigger_step3(v, fs, h, OMEGA3, "clean")
        errs.append(e)
    trig = float(torch.abs(errs[9] - errs[8]))
    gu, ge, gk = R3.rdma_trigger3(us, fs, h, OMEGA3, "clean", trig, 100)
    wu, we, wk = trigger_loop(lambda x: KS3.sharded_trigger_step3(x, fs, h, OMEGA3, "clean"), us,
                              trig, 100)
    assert int(gk) == wk and wk <= 10
    assert torch.equal(S.gather(gu), S.gather(wu)) and torch.equal(ge, we)


def test_ring_wrappers_refuse_what_the_kernels_refuse():
    u, f, c, us, fs = _ring(65, 3)
    h = 1.0 / 64
    with pytest.raises(ValueError, match="at most 7"):
        R3.rdma_jacobi3(us, fs, h, 8, OMEGA3, False, "clean")
    with pytest.raises(ValueError, match="unknown err_mode"):
        R3.rdma_jacobi3(us, fs, h, 3, OMEGA3, False, "cpu")
    with pytest.raises(ValueError, match="descend leg runs"):
        R3.rdma_descend3(us, fs, h, 8, OMEGA3)
    with pytest.raises(ValueError, match="unknown restriction"):
        R3.rdma_descend3(us, fs, h, 3, OMEGA3, restriction="injection")
    with pytest.raises(ValueError, match="sweeps per pass"):
        R3.rdma_ascend3(us, fs, c, h, 8, OMEGA3, want_err=True)
    with pytest.raises(ValueError, match="even plane count"):
        KS3.rdma_fused_descend3(us, fs, h, 3, OMEGA3, nl=9)
    with pytest.raises(ValueError, match="even plane count"):
        KS3.rdma_fused_ascend3(us, fs, c, h, 3, OMEGA3, nl=9)
    with pytest.raises(ValueError, match="unknown error metric"):
        R3.rdma_trigger3(us, fs, h, OMEGA3, "cpu")


# --- routing through the engines -------------------------------------------------------

RING_WRAPPERS = ("rdma_jacobi3", "rdma_descend3", "rdma_ascend3", "rdma_trigger3")
SHARD_MODES = ("fused_jacobi3_shard", "fused_descend3_shard", "fused_ascend3_shard",
               "fused_jacobi3_errs_shard", "trigger_pass3_shard")


def _spy(monkeypatch, module, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _f=fn, _k=name, **kw: (
            calls.__setitem__(_k, calls[_k] + 1), _f(*a, **kw))[1])
    return calls


@pytest.fixture
def kernel_routing(monkeypatch):
    """The engines' kernel path on CPU tensors (the twins), as on the card."""
    monkeypatch.setattr(compiled3, "_use_kernels", lambda cfg, device: cfg.kernels != "torch")
    monkeypatch.setattr(K, "use_kernels", lambda kernels, device: kernels != "torch")


@functools.lru_cache(maxsize=None)
def _jpolicy():
    return jps3.ZShardingPolicy3(_jmesh())


PROGRAMS = {  # JAX's test programs (tests/test_rdma.py:274, :408, :514)
    "legs": (dict(n_min=5, steps=3, coarse_target=1e-8, coarsen=3), {}),
    "smoother": (dict(n_min=5, steps=3, coarse_target=1e-8, coarsen=3), {"compat_error": "gpu"}),
    "trigger": (dict(n_min=5, steps=-1, coarse_option=0, coarsen=3), {"max_trigger_sweeps": 30}),
}


def _jcfg(**kw):
    return jmg.SolverConfig(omega=OMEGA3, kernels="pallas", collect_node_stats=False, **kw)


@functools.lru_cache(maxsize=None)
def _jax_engine(key):
    kw, cfg = PROGRAMS[key]
    with _jpolicy().mesh:
        cc = jcompiled3.compile_program3(jmg.v_cycle(N, **kw), jp3.REFERENCE_PROBLEM_3D,
                                         _jcfg(**cfg), policy=_jpolicy())
        u, err = cc(*cc.init())
    return grid3_from_jax(u, N), float(err)


def _port_engine(key, halo, trigger_batch=None):
    kw, cfg = PROGRAMS[key]
    ours = dataclasses.replace(config_from_jax(_jcfg(**cfg)), halo=halo)
    if trigger_batch is not None:
        ours = dataclasses.replace(ours, trigger_batch=trigger_batch)
    cc = tmg.compile_program3(program_from_jax(jmg.v_cycle(N, **kw)),
                              problem3_from_jax_grids(jp3.REFERENCE_PROBLEM_3D), ours,
                              device="cpu", policy=policy3_from_jax(_jpolicy()))
    cc.trigger_sweeps = []
    u, err = cc(*cc.init())
    return cc.unpad(u), err, cc.trigger_sweeps


@pytest.mark.parametrize("key,want", [
    ("legs", {"rdma_descend3": 1, "rdma_ascend3": 1}),
    ("smoother", {"rdma_jacobi3": 2}),
    ("trigger", {"rdma_trigger3": 2})])
def test_engine_routes_the_ring_kernels(monkeypatch, kernel_routing, key, want):
    """halo="rdma" under the policy takes the ring kernels at 65³ (JAX's nl
    18 on 4 devices: every predicate admits) in place of the shard modes,
    bit for bit the ppermute engine, and JAX's engine within its bounds."""
    ring = _spy(monkeypatch, R3, RING_WRAPPERS)
    shard = _spy(monkeypatch, K3, SHARD_MODES)
    got, gerr, gsweeps = _port_engine(key, "rdma")
    routed = dict(ring)
    assert routed == {**dict.fromkeys(RING_WRAPPERS, 0), **want}
    assert not any(shard.values())
    pu, perr, psweeps = _port_engine(key, "ppermute")
    assert ring == routed and any(shard.values())
    assert torch.equal(got, pu) and torch.equal(gerr, perr) and gsweeps == psweeps
    ju, jerr = _jax_engine(key)
    _close(got, ju, CYCLE_RTOL)
    assert float(gerr) == pytest.approx(jerr, rel=ERR_RTOL)


@pytest.mark.parametrize("batch", ["auto", 7])
def test_ring_trigger_ignores_the_batch(kernel_routing, batch):
    """JAX tests the ring before any batching: under "rdma" a level that fits
    runs the exact loop whatever trigger_batch says (under "ppermute" batch 7
    batches it)."""
    exact = _port_engine("trigger", "rdma", 1)
    ring = _port_engine("trigger", "rdma", batch)
    assert ring[2] == exact[2] and torch.equal(ring[0], exact[0])
    if batch == 7:
        batched = _port_engine("trigger", "ppermute", 7)[2]
        assert [k for n, k in batched if n == N] != [k for n, k in exact[2] if n == N]


@pytest.mark.parametrize("n,ring", [(513, False), (257, True), (129, True), (65, True)])
def test_trigger_route_at_phase_h_sizes(monkeypatch, n, ring):
    """The sharded trigger node on 8 shards takes kernel 19 where JAX's
    predicate admits the shard (257³-65³), the one-sweep loop at 513³; the
    route is read off the first call, nothing runs."""
    class Routed(Exception):
        pass

    def stop(name):
        def fn(*a, **kw):
            raise Routed(name)
        return fn

    monkeypatch.setattr(KS3, "rdma_fused_trigger3", stop("ring"))
    monkeypatch.setattr(KS3, "sharded_trigger_step3", stop("step"))
    monkeypatch.setattr(KS3, "sharded_trigger_pass3", stop("step"))
    pol = M.ZShardingPolicy3(M.make_mesh_z(["cpu"] * 8))
    cfg = tmg.SolverConfig(halo="rdma", trigger_batch=1)
    nl = pol.planes_per_device(n)
    with pytest.raises(Routed) as hit:
        compiled3._trigger_sharded(None, None, n, 1.0 / (n - 1), cfg, "clean", nl, True)
    assert str(hit.value) == ("ring" if ring else "step")
    _, rp, cp = jp3k.padded_shape3(n)
    assert jr3.rdma_trigger3_fits(nl, rp, cp) == ring


@pytest.mark.parametrize("pre,want", [
    (3, {"rdma_descend3": 1, "rdma_ascend3": 1}),
    (7, {"rdma_jacobi3": 1})])
def test_v_cycle3_sharded_routes_the_ring_kernels(monkeypatch, kernel_routing, pre, want):
    """v_cycle3_sharded(halo="rdma") at 65³ on 8 shards: JAX's top depth 80
    (nl 10) takes both ring legs; with pre = 7 (over the descend leg's cap)
    the emit_residual pass, then the prolongation and add and the ring
    smoother. Bit for bit the ppermute cycle."""
    u, f = (_th(a) for a in _fields3())
    mesh = M.make_mesh_z(["cpu"] * 8)
    ring = _spy(monkeypatch, R3, RING_WRAPPERS)
    got = S.gather(KS3.v_cycle3_sharded(u, f, 1.0 / 64, mesh, pre=pre, halo="rdma"))
    assert ring == {**dict.fromkeys(RING_WRAPPERS, 0), **want}
    want_u = S.gather(KS3.v_cycle3_sharded(u, f, 1.0 / 64, mesh, pre=pre, halo="ppermute"))
    assert torch.equal(got, want_u)


def test_engine_refuses_rdma_on_a_mesh_of_several_cards(monkeypatch):
    """A ring launch runs every shard on one card: in 3-D as in 2-D, a mesh
    over several cards with halo="rdma" is refused when the engine is built,
    with the way out in the message (device names only; no card needed)."""
    monkeypatch.setattr(compiled3, "_use_kernels", lambda cfg, device: True)
    program = tmg.v_cycle(65, n_min=5, steps=3, coarse_target=1e-8, coarsen=3)
    pol = M.ZShardingPolicy3(M.make_mesh_z(["cuda:0", "cuda:1"] * 4))
    with pytest.raises(ValueError, match="one card.*cuda:0.*cuda:1.*halo='ppermute'"):
        tmg.compile_program3(program, tmg.REFERENCE_PROBLEM_3D, tmg.SolverConfig(halo="rdma"),
                             device="cpu", policy=pol)
    for devices, halo in ((["cuda:1"] * 8, "rdma"), (["cuda:0", "cuda:1"] * 4, "ppermute")):
        tmg.compile_program3(program, tmg.REFERENCE_PROBLEM_3D, tmg.SolverConfig(halo=halo),
                             device="cpu", policy=M.ZShardingPolicy3(M.make_mesh_z(devices)))


def test_v_cycle3_sharded_refuses_rdma_on_several_cards(monkeypatch):
    monkeypatch.setattr(K, "use_kernels", lambda kernels, device: True)
    u, f = (_th(a) for a in _fields3())
    with pytest.raises(ValueError, match="one card.*halo='ppermute'"):
        KS3.v_cycle3_sharded(u, f, 1.0 / 64, M.make_mesh_z(["cuda:0", "cuda:1"] * 4),
                             halo="rdma")


def test_ring_launch_checks_its_layout():
    """A ring launch takes a z-sharded volume whose every shard lives on one
    device, checked before the library loads (device names only)."""
    lay = S.Layout(9, ((0, 4), (4, 9)), ((0, 9),), ((torch.device("cuda:0"),),
                                                   (torch.device("cuda:1"),)), 3)
    grid = S.ShardedGrid(lay, [[torch.zeros(4, 9, 9)], [torch.zeros(5, 9, 9)]])
    with pytest.raises(ValueError, match="one ring launch runs on one device"):
        R3._check_ring3(grid, grid)
    flat = S.Layout(9, ((0, 9),), ((0, 9),), ((torch.device("cpu"),),), 2)
    with pytest.raises(ValueError, match="z-sharded volumes"):
        R3._check_ring3(None, S.ShardedGrid(flat, [[torch.zeros(9, 9)]]))
