"""The column-pass schedules of the 3-D legs (kernels 11 and 12,
csrc/descend3.cu and csrc/ascend3.cu), emulated in plain PyTorch on the CPU.

Nothing compiles the CUDA sources here, so these tests hold the plane ranges
the kernels follow against the plain twins the card's checks hold the
kernels to (chip_smoke.py phases 2, H1 and I1):

  * every tile plan the legs take (``err_plan3`` of a level or of a shard's
    depth) fits the column pass: at most 512 cells a tile, for the levels
    and shard depths of phases D, F, H2 and I2 (33³ to 513³ on 2 to 16
    z-shards);
  * the descend leg, mirrored below: ``col3_schedule``'s sweeps with
    1 + (full weighting) more planes a side (the tail the residual pass
    reads), iterate k in a scratch window as well as the owned planes; the
    residual pass per z chunk of the plan, −r on the chunk's planes and
    (full weighting) one more a side, the chunk's share of the clean error,
    and the restriction's z step of each coarse plane 2K in the chunk
    into a buffer of coarse planes; then the y and x steps into the coarse
    slab;
  * the ascend leg, mirrored below: u plus the prolonged correction on the
    k + clean planes a side that the sweeps read, into the scratch window
    the first sweep does not write, then ``col3_schedule``'s sweeps and the
    clean error's read-only pass.

Run on windows that hold just the planes the leg needs, with every plane a
pass must not read set to NaN (beyond the grid, in the scratch windows and
in the buffer of coarse planes) and stale iterates left in the scratch
windows, the owned planes, the coarse slab and the raw clean error equal
``fused_descend3_shard_torch``'s and ``fused_ascend3_shard_torch``'s bit for
bit on the whole grid and on 2, 3, 4 and 8 z-shards (ragged last shards) at
33³ and 65³: a wrong halo offset shows as NaN or as a stale plane. The
emulations are test code: the kernels' own plane ranges live in
csrc/col3.cuh, csrc/descend3.cu and csrc/ascend3.cu.
"""

import numpy as np
import pytest
import torch

from multigrid_poisson_solver_tpu_torch.ops import kernels3 as K3
from multigrid_poisson_solver_tpu_torch.parallel import kernel_shard3 as KS3
from multigrid_poisson_solver_tpu_torch.parallel import mesh as M
from multigrid_poisson_solver_tpu_torch.parallel import sharded as S

OMEGA3 = 6.0 / 7.0
NAN = float("nan")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulations run thousands of small tensor ops: one intra-op thread
    each, as several test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fields(n, seed):
    rng = np.random.default_rng(seed)
    u, f, c = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((n, n, n), (n, n, n), ((n + 1) // 2,) * 3))
    return u, f, c


def _window(x, lo, hi):
    """x's planes [lo, hi), NaN beyond the volume."""
    out = torch.full((hi - lo,) + tuple(x.shape[1:]), NAN)
    a, b = max(lo, 0), min(hi, x.shape[0])
    out[a - lo:b - lo] = x[a:b]
    return out


def _geos(n, shards):
    """The whole grid, or the port's z split on ``shards`` (even origins,
    a ragged last shard), as (z0, nz)."""
    return ((0, n),) if shards == 1 else tuple((a, b - a) for a, b in S.split_bounds(n, shards))


# --- the plans ------------------------------------------------------------------------------

@pytest.mark.parametrize("n", [33, 65, 129, 257, 513])
def test_leg_plans_fit_the_column_pass(n):
    """err_plan3 of the level (the whole-grid legs) and of every shard depth
    on 2-16 z-shards (the port's split and JAX's planes per device): at
    most 512 cells a tile, a z chunk of at least one plane."""
    depths = {n}
    for shards in (2, 3, 4, 8, 16):
        if 2 * (n // (2 * shards)) >= 2:
            depths |= {b - a for a, b in S.split_bounds(n, shards)}
            depths.add(M.padded_depth3(n, shards) // shards)
    for nz in sorted(depths):
        ty, tx, cz = K3.err_plan3(nz)
        assert ty * tx <= 512 and cz >= 1, (nz, ty, tx, cz)


# --- col3_schedule's sweeps ---------------------------------------------------------------

def _sweep_planes(src, f_win, geo, lo, hi, h):
    """The sweep of ``src`` on planes [lo, hi) (global z), reading only
    planes [lo − 1, hi + 1)."""
    base = geo.z0 - geo.ext
    a, b = max(lo - 1, base), min(hi + 1, geo.z0 + geo.nz + geo.ext)
    gz = torch.arange(a, b)
    swept = K3._sweep3_ext(src[a - base:b - base], f_win[a - base:b - base],
                           (gz >= 1) & (gz <= geo.n - 2), h, OMEGA3)
    return swept[lo - a:hi - a]


def _zero_planes(f_win, geo, lo, hi, h):
    """The closed-form first sweep from u ≡ 0 on planes [lo, hi)."""
    base = geo.z0 - geo.ext
    fs = f_win[lo - base:hi - base]
    gz = torch.arange(lo, hi)
    out = torch.zeros_like(fs)
    out[:, 1:-1, 1:-1] = torch.where(
        ((gz >= 1) & (gz <= geo.n - 2))[:, None, None],
        (OMEGA3 / 6.0) * (out[:, 1:-1, 1:-1] - (h * h) * fs[:, 1:-1, 1:-1]), out[:, 1:-1, 1:-1])
    return out


def _sweeps(src, f_win, geo, h, steps, bufs, reread):
    """col3_schedule's ``steps`` sweeps from src (None: u ≡ 0) into the two
    scratch windows ``bufs`` (iterate s in bufs[(steps − s) % 2]), ``reread``
    planes a side more for the passes that read iterate k afterwards:
    (owned planes of iterate k, the window holding it or None)."""
    n, base = geo.n, geo.z0 - geo.ext
    it = {s: bufs[(steps - s) % 2] for s in range(1, steps + 1)}
    if not reread:   # the last iterate goes to the owned planes alone
        it[steps] = torch.full_like(f_win, NAN)
    for j in range(steps):
        more = steps + reread - j - 1
        lo, hi = max(geo.z0 - more, 0), min(geo.z0 + geo.nz + more, n)
        dst = it[j + 1]
        dst[lo - base:hi - base] = (_zero_planes(f_win, geo, lo, hi, h) if src is None
                                    else _sweep_planes(src, f_win, geo, lo, hi, h))
        src = dst
    return geo.owned(src).contiguous(), (src if reread else None)


def _scratch(f_win):
    """The two scratch windows, torch.empty: NaN until a pass writes them."""
    return [torch.full_like(f_win, NAN), torch.full_like(f_win, NAN)]


# --- the descend leg ----------------------------------------------------------------------

def _descend(u_win, f_win, geo, h, steps, from_zero, fw, cz):
    """descend3.cu's passes on a shard's windows: (owned planes, the coarse
    slab, the raw clean error, the times each coarse plane's z step was
    written)."""
    n, m, base = geo.n, (geo.n + 1) // 2, geo.z0 - geo.ext
    tail = 1 + fw
    _, it_k = _sweeps(None if from_zero else u_win, f_win, geo, h, steps,
                      _scratch(f_win), tail)
    out = geo.owned(it_k).contiguous()
    k0, k1 = K3.coarse_planes3(geo)
    s_buf = torch.full((k1 - k0, n, n), NAN)   # the restriction's z steps, torch.empty
    writes = [0] * (k1 - k0)
    d_own = torch.zeros_like(f_win)            # −r of the owned planes, as the chunks made it
    for e0 in range(geo.z0, geo.z0 + geo.nz, cz):
        e1 = min(e0 + cz, geo.z0 + geo.nz)
        zs, ze = max(e0 - fw, 0), min(e1 + fw, n)
        a, b = max(zs - 1, base), min(ze + 1, geo.z0 + geo.nz + geo.ext)
        gz = torch.arange(a, b)
        d = -K3._residual3_ext(it_k[a - base:b - base], f_win[a - base:b - base],
                               (gz >= 1) & (gz <= n - 2), h)[zs - a:ze - a]
        d_own[e0 - base:e1 - base] = d[e0 - zs:e1 - zs]
        for k in range(k0, k1):
            if e0 <= 2 * k < e1 and 1 <= k <= m - 2:
                z = 2 * k - zs
                s_buf[k - k0] = ((0.25 * d[z - 1] + 0.5 * d[z]) + 0.25 * d[z + 1] if fw
                                 else d[z])
                writes[k - k0] += 1
    raw = K3._raw3(torch.abs(d_own), geo)
    fc = torch.full((k1 - k0, m, m), NAN)
    for k in range(k0, k1):
        fc[k - k0] = 0.0
        if 1 <= k <= m - 2:
            fc[k - k0, 1:-1, 1:-1] = K3._restrict_yx(s_buf[k - k0:k - k0 + 1], n, bool(fw))[0]
    return out, fc, raw, writes


@pytest.mark.parametrize("n", [33, 65])
@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("restriction", ["full_weighting", "sampling"])
def test_descend_schedule_matches_the_shard_twin(n, shards, restriction):
    """Every sweep count within the cap, from_zero on and off, the planned z
    chunk and a forced one of 6 planes: the emulated passes on windows of
    exactly the halo ``sharded_fused_descend3`` exchanges (NaN beyond) give
    the shard twin's owned planes, coarse slab and raw error bit for bit,
    and every interior coarse plane's z step is written once."""
    fw = int(restriction == "full_weighting")
    cap = K3.MAX_DESCEND3_SWEEPS_FW if fw else K3.MAX_DESCEND3_SWEEPS_SAMPLING
    h = 1.0 / (n - 1)
    u, f, _ = _fields(n, 10 * n + shards)
    m = (n + 1) // 2
    for z0, nz in _geos(n, shards):
        for steps in range(1, cap + 2):
            for fz in (False, True):
                k_nb = steps - int(fz)
                if k_nb > cap:
                    continue
                ext = 0 if nz == n else k_nb + 1 + fw
                geo = K3.ShardGeo3(n, z0, nz, ext)
                u_win, f_win = _window(u, z0 - ext, z0 + nz + ext), _window(f, z0 - ext,
                                                                          z0 + nz + ext)
                want_u, want_fc, want_raw = K3.fused_descend3_shard_torch(
                    torch.nan_to_num(u_win), torch.nan_to_num(f_win), geo, h, steps, OMEGA3, fz,
                    restriction, True)
                for cz in {K3.err_plan3(nz)[2], 6}:
                    got_u, got_fc, got_raw, writes = _descend(u_win, f_win, geo, h, steps, fz,
                                                              fw, cz)
                    what = (z0, nz, steps, fz, cz)
                    assert torch.equal(got_u, want_u), what
                    assert torch.equal(got_fc, want_fc), what
                    assert torch.equal(got_raw, want_raw), what
                    k0, _ = K3.coarse_planes3(geo)
                    assert writes == [int(1 <= k0 + i <= m - 2) for i in range(len(writes))]
    # the leg without the error: the same owned planes and slab, no error
    geo = K3.ShardGeo3(n, 0, n)
    got = K3.fused_descend3_shard_torch(u, f, geo, h, 3, OMEGA3, False, restriction, False)
    want = K3.fused_descend3_torch(u, f, h, 3, OMEGA3, False, restriction, False)
    assert got[2] is None and want[2] is None
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# --- the ascend leg ------------------------------------------------------------------------

def _ascend(u_win, f_win, c_win, cz0, geo, h, steps, want_err):
    """ascend3.cu's passes on a shard's windows: (owned planes, raw clean
    error or None)."""
    n, base = geo.n, geo.z0 - geo.ext
    clean = int(want_err)
    halo = steps + clean
    plo, phi = max(geo.z0 - halo, 0), min(geo.z0 + geo.nz + halo, n)
    bufs = _scratch(f_win)
    # the prolongation goes to the window iterate 1 does not
    u0 = bufs[1] if (steps - 1) % 2 == 0 else bufs[0]
    for z in range(max(plo, 1), min(phi, n - 1)):   # the coarse planes it reads exist
        assert 0 <= z // 2 - cz0 and (z + 1) // 2 - cz0 < c_win.shape[0], (z, cz0)
    pgeo = K3.ShardGeo3(n, plo, phi - plo)
    e = K3._prolong3_planes(c_win, cz0, pgeo)
    src = u_win[plo - base:phi - base]
    zin = pgeo.inner(src.device)
    u0[plo - base:phi - base] = src
    u0[plo - base:phi - base, 1:-1, 1:-1] = torch.where(
        zin[:, None, None], src[:, 1:-1, 1:-1] + e[:, 1:-1, 1:-1], src[:, 1:-1, 1:-1])
    assert bufs[(steps - 1) % 2] is not u0   # iterate 1's window (_sweeps)
    out, it_k = _sweeps(u0, f_win, geo, h, steps, bufs, clean)
    raw = None
    if want_err:   # the read-only pass over iterate k
        raw = K3._raw_error3(it_k, it_k, f_win, geo, geo.inner(f_win.device), h, "clean")
    return out, raw


@pytest.mark.parametrize("n", [33, 65])
@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_ascend_schedule_matches_the_shard_twin(n, shards):
    """Every sweep count within the cap, with and without the clean error:
    the emulated passes on windows of ``ascend3_halo``'s planes and coarse
    windows (NaN beyond the grid) give the shard twin's owned planes and raw
    error bit for bit."""
    h = 1.0 / (n - 1)
    u, f, c = _fields(n, 20 * n + shards)
    m = (n + 1) // 2
    for z0, nz in _geos(n, shards):
        for want_err in (False, True):
            for steps in range(1, K3.MAX_FUSED_SWEEPS_3D + 1 - int(want_err)):
                ext_z, ext_c = KS3.ascend3_halo(steps, want_err)
                if nz == n:
                    ext_z, cz0, c_win = 0, 0, c
                else:
                    cz0 = z0 // 2 - ext_c
                    c_win = _window(c, cz0, (z0 + nz + 1) // 2 + ext_c + 1)
                geo = K3.ShardGeo3(n, z0, nz, ext_z)
                u_win = _window(u, z0 - ext_z, z0 + nz + ext_z)
                f_win = _window(f, z0 - ext_z, z0 + nz + ext_z)
                got_u, got_raw = _ascend(u_win, f_win, c_win, cz0, geo, h, steps, want_err)
                want_u, want_raw = K3.fused_ascend3_shard_torch(
                    torch.nan_to_num(u_win), torch.nan_to_num(f_win), torch.nan_to_num(c_win),
                    cz0, geo, h, steps, OMEGA3, want_err)
                assert torch.equal(got_u, want_u), (z0, nz, steps, want_err)
                if want_err:
                    assert torch.equal(got_raw, want_raw), (z0, nz, steps)
                else:
                    assert got_raw is None and want_raw is None
    assert m == c.shape[0]
