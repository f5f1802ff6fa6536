"""Kernel 10's emit_residual mode on column passes (csrc/jacobi3.cu,
``mg3_jacobi_residual`` and ``mg3_jacobi_residual_shard``), emulated in plain
PyTorch on the CPU, and its clean error against the JAX package.

Nothing compiles the CUDA sources here, so these tests hold the plane ranges
the kernel follows against the plain twins the card's checks hold it to
(chip_smoke.py phase H1):

  * ``col3_schedule``'s k sweeps with ``tail`` 1: sweep j writes the owned
    planes and k − j more a side, the iterates alternating between two
    scratch windows (NaN until a pass writes them), so iterate k lies in a
    window on the owned planes and one more a side (from zero the first
    sweep is the closed form over f, folded into the second one's loads
    where there is a second one);
  * then one residual pass per z chunk of the tile plan (``err_plan3`` of
    the shard's depth, and a forced chunk of 6 planes): r of iterate k on
    the chunk's planes from u on them and one a side and f on them alone,
    negated or not, and the chunk's Σ|r| in float64.

On windows of k_eff + 1 halo planes (NaN beyond the grid), the owned planes
of u and r equal ``fused_jacobi3_residual_shard_torch``'s bit for bit on 2,
3, 4 and 8 z-shards of the port's split (a ragged last shard) and
``fused_jacobi3_residual_torch``'s on the whole grid, at 33³ and 65³, steps
1, 2, 3, 7 and 8 (k_eff ≤ 7), from zero or not; the raw clean error the
twins' to 1e-12 relative. A window whose outermost plane a side is NaN, or
a schedule with ``tail`` 0, differs. The emulations are test code: the
kernel's own plane ranges live in csrc/col3.cuh and csrc/jacobi3.cu.

The twin of the whole-grid mode with ``err_mode="clean"`` is held against
JAX's ``fused_jacobi3_residual_padded(..., err_mode="clean")`` in interpret
mode, and ``err_plan3``'s tiles, which every trigger loop sums its errors
over, are pinned.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_col3_legs import _one_thread  # noqa: F401 (one intra-op thread, module scope)
from test_torch_col3_legs import _fields, _geos, _sweep_planes, _window, _zero_planes

from multigrid_poisson_solver_tpu.ops import pallas3d as jp3k
from multigrid_poisson_solver_tpu_torch.convert import grid3_from_jax
from multigrid_poisson_solver_tpu_torch.ops import kernels3 as K3

OMEGA3 = 6.0 / 7.0
NAN = float("nan")
# (steps, from_zero) with at most 7 neighbour-reading sweeps
RUNS = [(steps, fz) for steps in (1, 2, 3, 7, 8) for fz in (False, True) if steps - fz <= 7]


def _planes(geo, steps, tail, j):
    """The planes [lo, hi) sweep j writes: the owned ones and steps + tail −
    j − 1 more a side, within the grid."""
    more = steps + tail - j - 1
    return max(geo.z0 - more, 0), min(geo.z0 + geo.nz + more, geo.n)


def _sweeps(src, f_win, geo, h, steps, tail):
    """col3_schedule's ``steps`` sweeps from src (None: u ≡ 0) into two
    scratch windows (iterate s in window (steps − s) % 2), sweep j on
    ``_planes``: the window holding iterate k. From zero with two sweeps or
    more the closed-form pass is folded into sweep 1 (col3_passes' FOLD):
    iterate 1 is formed from f on the planes sweep 1 reads and never
    stored."""
    base = geo.z0 - geo.ext
    bufs = [torch.full_like(f_win, NAN), torch.full_like(f_win, NAN)]
    first = 0
    if src is None and steps >= 2:
        lo, hi = _planes(geo, steps, tail, 1)
        lo, hi = max(lo - 1, 0), min(hi + 1, geo.n)
        src = torch.full_like(f_win, NAN)
        src[lo - base:hi - base] = _zero_planes(f_win, geo, lo, hi, h)
        first = 1
    for j in range(first, steps):
        lo, hi = _planes(geo, steps, tail, j)
        dst = bufs[(steps - j - 1) % 2]
        dst[lo - base:hi - base] = (_zero_planes(f_win, geo, lo, hi, h) if src is None
                                    else _sweep_planes(src, f_win, geo, lo, hi, h))
        src = dst
    return src


def _emit_residual(u_win, f_win, geo, h, steps, fz, negate, cz, tail=1):
    """jacobi3.cu's emit_residual passes on a shard's windows: (owned planes
    of iterate k, of r, the raw Σ|r| over the owned interior)."""
    n, base = geo.n, geo.z0 - geo.ext
    it_k = _sweeps(None if fz else u_win, f_win, geo, h, steps, tail)
    rs, raw = [], torch.zeros((), dtype=torch.float64)
    for e0 in range(geo.z0, geo.z0 + geo.nz, cz):
        e1 = min(e0 + cz, geo.z0 + geo.nz)
        a, b = max(e0 - 1, 0), min(e1 + 1, n)
        fs = torch.full((b - a, n, n), NAN)
        fs[e0 - a:e1 - a] = f_win[e0 - base:e1 - base]   # the chunk reads f on its planes only
        gz = torch.arange(a, b)
        r = K3._residual3_ext(it_k[a - base:b - base], fs, (gz >= 1) & (gz <= n - 2),
                              h)[e0 - a:e1 - a]
        raw = raw + torch.sum(torch.abs(r[:, 1:-1, 1:-1]), dtype=torch.float64)
        rs.append(-r if negate else r)
    return geo.owned(it_k).contiguous(), torch.cat(rs), raw


def _case(u, f, n, z0, nz, steps, fz, shallow=False):
    """A shard's geometry and windows of k_eff + 1 halo planes (none for the
    whole grid), NaN beyond the grid; ``shallow``: the outermost plane a
    side NaN too, where a neighbour lies."""
    ext = 0 if nz == n else steps - int(fz) + 1
    geo = K3.ShardGeo3(n, z0, nz, ext)
    u_win, f_win = (_window(x, z0 - ext, z0 + nz + ext) for x in (u, f))
    if shallow:
        for win in (u_win, f_win):
            if z0 > 0:
                win[0] = NAN
            if z0 + nz < n:
                win[-1] = NAN
    return geo, u_win, f_win


def _twin(u, f, geo, u_win, f_win, h, steps, fz, negate):
    if geo.whole:
        return K3.fused_jacobi3_residual_torch(u, f, h, steps, OMEGA3, fz, negate, "clean")
    return K3.fused_jacobi3_residual_shard_torch(torch.nan_to_num(u_win), torch.nan_to_num(f_win),
                                                 geo, h, steps, OMEGA3, fz, negate, "clean")


@pytest.mark.parametrize("n", [33, 65])
@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_emit_residual_schedule_matches_the_twin(n, shards):
    """Every (steps, from_zero) of RUNS, negated or not, the planned z chunk
    and a forced one of 6 planes: the emulated passes give the twin's owned
    u and r bit for bit and its raw clean error to 1e-12 relative."""
    h = 1.0 / (n - 1)
    u, f, _ = _fields(n, 30 * n + shards)
    for z0, nz in _geos(n, shards):
        for steps, fz in RUNS:
            geo, u_win, f_win = _case(u, f, n, z0, nz, steps, fz)
            for negate in (False, True):
                want_u, want_r, want_raw = _twin(u, f, geo, u_win, f_win, h, steps, fz, negate)
                assert want_raw.dtype == torch.float64 and want_raw.dim() == 0
                for cz in {K3.err_plan3(nz)[2], 6}:
                    got_u, got_r, got_raw = _emit_residual(u_win, f_win, geo, h, steps, fz,
                                                           negate, cz)
                    what = (z0, nz, steps, fz, negate, cz)
                    assert torch.equal(got_u, want_u), what
                    assert torch.equal(got_r, want_r), what
                    assert abs(float(got_raw) - float(want_raw)) <= 1e-12 * float(want_raw), what


@pytest.mark.parametrize("n,shards", [(33, 4), (65, 3), (65, 8)])
@pytest.mark.parametrize("mutation", ["shallow window", "tail 0"])
def test_emit_residual_mutations_fail(n, shards, mutation):
    """A window whose outermost plane a side is NaN, or sweeps that leave
    iterate k on the owned planes alone (tail 0), differ from the twin on
    some shard for every (steps, from_zero)."""
    h = 1.0 / (n - 1)
    u, f, _ = _fields(n, 31 * n + shards)
    for steps, fz in RUNS:
        differs = False
        for z0, nz in _geos(n, shards):
            geo, u_win, f_win = _case(u, f, n, z0, nz, steps, fz, mutation == "shallow window")
            _, want_r, _ = _twin(u, f, geo, *_case(u, f, n, z0, nz, steps, fz)[1:], h, steps, fz,
                                 False)
            _, got_r, _ = _emit_residual(u_win, f_win, geo, h, steps, fz, False,
                                         K3.err_plan3(nz)[2], int(mutation != "tail 0"))
            differs |= not torch.equal(got_r, want_r)
        assert differs, (steps, fz)


def test_emit_residual_clean_raw_is_the_clean_pass_raw():
    """On every shard, the twin's raw clean error equals, bit for bit, the
    raw that kernel 10's shard mode with the clean error reports for the
    same sweeps (the kernel's residual pass adds the same |r| in the same
    tiles); the whole-grid twin's equals the sum of |r| over the interior."""
    n, h = 33, 1.0 / 32
    u, f, _ = _fields(n, 32)
    for z0, nz in _geos(n, 3):
        for steps, fz in ((3, False), (3, True), (7, False)):
            geo, u_win, f_win = _case(u, f, n, z0, nz, steps, fz)
            ue, fe = torch.nan_to_num(u_win), torch.nan_to_num(f_win)
            _, _, raw = K3.fused_jacobi3_residual_shard(ue, fe, geo, h, steps, OMEGA3, fz, True,
                                                        "clean")
            _, want = K3.fused_jacobi3_shard(ue, fe, geo, h, steps, OMEGA3, fz, "clean")
            assert torch.equal(raw, want), (z0, steps, fz)
    ku, kr, raw = K3.fused_jacobi3_residual(u, f, h, 3, OMEGA3, err_mode="clean")
    assert torch.equal(raw, torch.sum(torch.abs(kr[1:-1, 1:-1, 1:-1]), dtype=torch.float64))
    assert torch.equal(ku, K3.fused_jacobi3(u, f, h, 3, OMEGA3))
    assert len(K3.fused_jacobi3_residual(u, f, h, 3, OMEGA3)) == 2
    with pytest.raises(ValueError, match="err_mode"):
        K3.fused_jacobi3_residual(u, f, h, 3, OMEGA3, err_mode="gpu")
    with pytest.raises(ValueError, match="1..7"):
        K3.fused_jacobi3_residual_shard(u, f, K3.ShardGeo3(n, 0, n), h, 8, OMEGA3)


@pytest.mark.parametrize("n", [33, 65])
@pytest.mark.parametrize("fz,negate", [(False, True), (True, False)])
def test_emit_residual_clean_matches_jax(n, fz, negate):
    """fused_jacobi3_residual(err_mode="clean") on the CPU against JAX's
    fused_jacobi3_residual_padded(err_mode="clean") in interpret mode, 3
    sweeps: u within 1e-6·max|u|; r within the fp32 cancellation noise of a
    7-point residual, 12·eps·(max|u|/h² + max|f|) (JAX's r is 6Δ/(ωh²) of a
    further sweep, the port's the direct stencil: they differ by roundings
    of the neighbour sum and of h²f, up to 1.0e-6·max|r| here, above the
    5e-7·max|r| that JAX's own test allows between its two forms); raw/n³
    within 5e-5 relative (JAX sums in fp32)."""
    h = 1.0 / (n - 1)
    rng = np.random.default_rng(40 + n)
    u, f = (rng.standard_normal((n, n, n)).astype(np.float32) for _ in range(2))
    ju, jr, jraw = jp3k.fused_jacobi3_residual_padded(
        jp3k.pad_grid3(jnp.asarray(u)), jp3k.pad_grid3(jnp.asarray(f)), n, h, 3, omega=OMEGA3,
        from_zero=fz, negate=negate, interpret=True, err_mode="clean")
    want_u, want_r = grid3_from_jax(ju, n), grid3_from_jax(jr, n)
    got_u, got_r, raw = K3.fused_jacobi3_residual(torch.from_numpy(u), torch.from_numpy(f), h, 3,
                                                  OMEGA3, fz, negate, "clean")
    np.testing.assert_allclose(got_u.numpy(), want_u.numpy(), rtol=0,
                               atol=1e-6 * float(want_u.abs().max()))
    eps = float(np.finfo(np.float32).eps)
    np.testing.assert_allclose(got_r.numpy(), want_r.numpy(), rtol=0,
                               atol=12 * eps * (float(want_u.abs().max()) / (h * h)
                                                + float(np.abs(f).max())))
    assert float(raw) / n ** 3 == pytest.approx(float(jraw) / n ** 3, rel=5e-5)


@pytest.mark.parametrize("n,plan", [
    (5, (16, 32, 6)), (8, (16, 32, 8)), (9, (16, 32, 10)), (17, (16, 32, 18)),
    (33, (16, 32, 34)), (34, (16, 32, 34)), (64, (16, 32, 64)), (65, (16, 32, 34)),
    (66, (16, 32, 34)), (72, (16, 32, 36)), (129, (16, 32, 44)), (136, (16, 32, 46)),
    (257, (16, 32, 52)), (264, (16, 32, 54)), (513, (16, 32, 58)), (528, (16, 32, 60))])
def test_err_plan3_values_are_pinned(n, plan):
    """err_plan3 fixes the tiles every trigger loop sums its errors over
    (levels 5³-513³ and the shard depths of 2-16 z-shards): its values stay
    those of the removed tile pipeline's plan, so stop sweeps cannot move."""
    assert K3.err_plan3(n) == plan
