"""The multigrid legs on the row-streaming wavefront (kernels 3 and 4:
csrc/descend.cu, csrc/ascend.cu over csrc/wave2.cuh's WV_DESCEND and
WV_ASCEND stages), emulated in plain PyTorch on the CPU.

Nothing compiles the CUDA sources here, so these tests hold the legs' rules
against the plain twins the card's checks hold the kernels to (chip_smoke.py
phases 2 and G1), as tests/test_torch_wave2.py does for kernel 1's pass,
whose helpers they reuse:

  * the descend leg, mirrored over every warp at once: kernel 1's pass with
    H = k + 1 halo rows (+ 1 a side for full weighting), −r of level k one
    row behind the last sweep, d = −r on the interior and 0 elsewhere, d's
    last two rows kept, and on row 2I + 1 (full weighting) or 2I (sampling)
    of a coarse row I whose fine row 2I the chunk owns the row combination on
    the staged columns, handed through the per-warp row to lane x's coarse
    columns x and x + 32 of the strip's 64, the column combination there,
    0 on coarse boundary points;
  * the ascend leg: level 0 is u + prolong(c) on the interior, coarse row I
    arriving with fine row 2I − 1 (the chunk's first row's with the
    prologue) into a ring of four rows, its column interpolation at the
    lane's five columns formed at the first step and on odd rows and kept
    for the next;
  * run with every value they must not read set to NaN (staged columns
    beyond the strip and the window, the level and −r windows before their
    first row, rows past the chunk's loop, stale ring rows, coarse cells
    outside the window), the owned block, the coarse block and the error
    partials equal ``fused_descend_shard_torch`` / ``fused_ascend_shard_torch``
    and legs.cuh's tile order bit for bit: whole grid (257², a ragged 259²
    and 1031² with forced chunk rows), on 2 and 8 row shards and 2 × 4
    blocks (even origins), k 1-8, from_zero, both restrictions, every error;
  * the checks see a wrong schedule: a halo a row short for full weighting,
    a coarse ring a row short, the prolongation's rows before its columns,
    chunk origins a row off;
  * the bf16 legs (``csrc/descend_bf16.cu``, ``csrc/ascend_bf16.cu``): the
    same passes on bf16 rows, each op of the sweeps, −r, the full weighting
    and the prolongation rounded to bf16 as the twins' tensors are, against
    the twins run on bf16 tensors bit for bit, the mutations seen.

The twins are held against the JAX package's Pallas legs at 257² here (the
sizes tests/test_torch_kernels.py compares are 65² and 129²).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_poisson_solver_tpu.ops import layout
from multigrid_poisson_solver_tpu.ops import padded as P
from multigrid_poisson_solver_tpu.ops import pallas_kernels as pk
from multigrid_poisson_solver_tpu_torch.ops import kernels as K
from test_torch_wave2 import (LANES, NAN, OMEGA, PAD, SLOTS, TILE_H, TILE_W, _exchange,
                              _grid, _neighbours, _Partials, _terms, _Warps, _window,
                              chunk_rows, tile_partials)

CRING, CROW = 4, 96   # WV_CRING, WV_CROW


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulations run thousands of small tensor ops: one intra-op thread
    each, as several test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _half(a, b):
    return 0.5 * a + 0.5 * b


def _comb(x, y, z):
    return (0.25 * x + 0.5 * y) + 0.25 * z


def leg_pass(leg, u_ext, f_ext, geo, h, steps, err=None, fw=False, from_zero=False,
             c_win=None, cr0=0, cc0=0, rows=None, mutate=None):
    """wave2_pass with the descend or ascend stage over every warp: (owned
    block, the coarse block (descend) or None, partials or None). ``c_win``
    is the ascend leg's coarse window at global (cr0, cc0). ``mutate``
    breaks the schedule: "fw_halo" (full weighting without its extra halo
    row), "cring" (a coarse ring of three rows), "rows_first" (the
    prolongation's rows before its columns) or "origin" (chunk origins a
    row early)."""
    n = geo.n
    descend = leg == "descend"
    k = steps - from_zero
    halo = k + (err in ("cpu", "clean") or descend)
    ahead = 4 if k <= 2 else 2
    nf, nu = halo + 1 + ahead, ahead + 1
    nc = CRING - (mutate == "cring")
    xh = int(descend and fw and mutate != "fw_halo")
    rows = rows or chunk_rows(geo)
    wav = _Warps(geo, rows)
    if mutate == "origin":   # chunks of rows − 1, rows, ...: odd origins
        ch = wav.a // rows
        wav.a = torch.clamp(wav.a - 1, min=0)
        wav.b = torch.clamp((ch + 1) * rows - 1, max=geo.rows)
        wav.b[ch == ch.max()] = geo.rows
    warps = len(wav.tx)
    lanes = torch.arange(LANES)
    ga, gb = geo.row0 + wav.a, geo.row0 + wav.b
    r_first, r_end = ga - halo - xh, gb + halo + xh
    dt = f_ext.dtype   # the storage type: every level and ring row rounds to it
    out = torch.full((geo.rows, geo.cols), NAN, dtype=dt)
    m = (n + 1) // 2
    crows, ccols = (geo.rows + 1) // 2, (geo.cols + 1) // 2
    fc = torch.full((crows, ccols), NAN, dtype=dt) if descend else None
    errs = _Partials(0 if err is None else 1, wav.strips * -(-geo.rows // TILE_H), warps, geo,
                     wav, err == "cpu")
    h2, inv_h2, zc = h * h, 1.0 / (h * h), K._zero_coef(h, OMEGA)

    def fetch(win, gi):
        ri = (gi - wav.wr0).clamp(0, wav.wrows - 1)[:, None, None].expand_as(wav.gj)
        v = win[ri, (wav.gj - wav.wc0).clamp(0, wav.wcols - 1)]
        v = torch.where(wav.load_m, v, torch.full((), NAN))
        v = torch.where(((gi >= wav.r_lo) & (gi < wav.r_hi))[:, None, None], v, torch.zeros(()))
        return torch.where((gi >= r_end)[:, None, None], torch.full((), NAN), v)

    # the coarse ring: row I of c's window at the strip's coarse columns
    # from gc0 / 2 (NaN outside the window and the grid: never to be read)
    j0 = (geo.col0 + wav.tx * TILE_W - PAD) // 2
    ring_c = torch.full((warps, nc, CROW), NAN, dtype=dt)

    def fetch_coarse(I, sel=None):
        """Coarse row I[w] into warp w's ring (the warps ``sel`` only)."""
        if descend:
            return
        cj = j0[:, None] + torch.arange(CROW)[None, :]
        lo_r, hi_r = max(0, cr0), min(m, cr0 + c_win.shape[0])
        lo_c, hi_c = max(0, cc0), min(m, cc0 + c_win.shape[1])
        ii = (I - cr0).clamp(0, c_win.shape[0] - 1)[:, None].expand_as(cj)
        v = c_win[ii, (cj - cc0).clamp(0, c_win.shape[1] - 1)]
        ok = ((I >= lo_r) & (I < hi_r))[:, None] & (cj >= lo_c) & (cj < hi_c)
        v = torch.where(ok, v, torch.full((), NAN))
        w = torch.arange(warps)
        if sel is not None:
            v = torch.where(sel[:, None], v, ring_c[w, I % nc])
        ring_c[w, I % nc] = v

    def wide_row(I):
        """Coarse row I (from the ring) at each lane's five fine columns."""
        ring = ring_c[torch.arange(warps), I % nc]                    # (warps, CROW)
        jr = (SLOTS * lanes[:, None] + torch.arange(SLOTS)[None, :]) >> 1   # (LANES, SLOTS)
        odd = ((lanes[:, None] + torch.arange(SLOTS)[None, :]) % 2 == 1)
        a, b = ring[:, jr], ring[:, jr + 1]
        return torch.where(odd, _half(a, b), a), a, b

    def write(gi, v):
        le = gi - geo.row0
        keep = ((le >= wav.a) & (le < wav.b))[:, None, None] & wav.own
        t = _exchange(v)
        w_idx, l_idx, q_idx = torch.nonzero(keep, as_tuple=True)
        out[le[w_idx], wav.gt[w_idx, l_idx, q_idx] - geo.col0] = t[w_idx, l_idx, q_idx]

    def restrict(gi, d, dm2, dm1):
        I = torch.div(gi, 2, rounding_mode="floor")
        emit = (gi % 2 == int(fw)) & (2 * I >= ga) & (2 * I < gb)
        if not bool(emit.any()):
            return
        sy = _comb(dm2, dm1, d) if fw else d
        row = sy.reshape(warps, LANES * SLOTS)
        for q in range(2):
            j = PAD + 2 * lanes + 64 * q
            v = _comb(row[:, j - 1], row[:, j], row[:, j + 1]) if fw else row[:, j]
            lJ = wav.tx[:, None] * (TILE_W // 2) + lanes[None, :] + 32 * q
            J = geo.col0 // 2 + lJ
            inside = ((I >= 1) & (I <= m - 2))[:, None] & (J >= 1) & (J <= m - 2)
            v = torch.where(inside, v, torch.zeros(()))
            keep = emit[:, None] & (lJ < ccols)
            w_idx, l_idx = torch.nonzero(keep, as_tuple=True)
            fc[I[w_idx] - geo.row0 // 2, lJ[w_idx, l_idx]] = v[w_idx, l_idx]

    shape = (warps, LANES, SLOTS)
    ring_f = torch.full((warps, nf) + shape[1:], NAN, dtype=dt)
    ring_u = torch.full((warps, nu) + shape[1:], NAN, dtype=dt)
    fetch_coarse(torch.div(r_first, 2, rounding_mode="floor"))

    def fetch_all(gi, fs_, us_):
        ring_f[:, fs_] = fetch(f_ext, gi)
        if not from_zero:
            ring_u[:, us_] = fetch(u_ext, gi)
        fetch_coarse(torch.div(gi + 1, 2, rounding_mode="floor"), gi % 2 == 1)

    for d in range(ahead):
        fetch_all(r_first + d, d, d)
    nw = [torch.full(shape, NAN, dtype=dt) for _ in range(max(halo, 1))]
    cw = [torch.full(shape, NAN, dtype=dt) for _ in range(max(halo, 1))]
    dm2 = dm1 = torch.full(shape, NAN, dtype=dt)
    wc = None
    fs = us = 0
    for i in range(int((r_end - r_first).max())):
        r = r_first + i
        fetch_all(r + ahead, (fs + ahead) % nf, (us + ahead) % nu)
        ri0 = ((r >= 1) & (r <= n - 2))[:, None, None] & wav.int_m
        if from_zero:
            cur = torch.where(ri0, zc * ring_f[:, fs], torch.zeros(()))
        else:
            cur = ring_u[:, us].clone()
        if not descend:
            I = torch.div(r, 2, rounding_mode="floor")
            if i == 0:
                wc = wide_row(I)[0]
            wn, an, bn = wide_row(I + 1)
            if mutate == "rows_first":   # rows first, then the columns
                _, a0, b0 = wide_row(I)
                jodd = (lanes[:, None] + torch.arange(SLOTS)[None, :]) % 2 == 1
                p_odd = torch.where(jodd, _half(_half(a0, an), _half(b0, bn)), _half(a0, an))
            else:
                p_odd = _half(wc, wn)
            odd_r = (r % 2 == 1)[:, None, None]
            p = torch.where(odd_r, p_odd, wc)
            wc = torch.where(odd_r, wn, wc)
            cur = torch.where(ri0, cur + p, cur)
        if k == 0:
            write(r, cur)
            if err == "gpu":
                errs.add(0, r, cur)
        for s in range(1, halo + 1):
            gi = r - s
            fl = ring_f[:, (fs - s) % nf]
            uc = cw[s - 1]
            we, ea = _neighbours(uc)
            nb = ((nw[s - 1] + cur) + we) + ea
            inside = ((gi >= 1) & (gi <= n - 2))[:, None, None] & wav.int_m
            if s <= k:
                nxt = torch.where(inside, uc + OMEGA * (0.25 * ((nb - 4.0 * uc) - h2 * fl)), uc)
            if s - 1 == k and (descend or err in ("cpu", "clean")):
                res = inv_h2 * (nb - 4.0 * uc) - fl
                if err in ("cpu", "clean"):
                    errs.add(0, gi, res)
                if descend:
                    d = torch.where(inside, -res, torch.zeros(()))
                    restrict(gi, d, dm2, dm1)
                    dm2, dm1 = dm1, d
            if err == "gpu" and s == k:
                errs.add(0, gi, nxt - uc)
            nw[s - 1], cw[s - 1] = uc, cur
            if s <= k:
                cur = nxt
            if s == k:
                write(gi, cur)
        fs, us = (fs + 1) % nf, (us + 1) % nu
    return out, fc, (None if err is None else errs.partials[0])


# --- the twins' terms in legs.cuh's order -------------------------------------------------------

def _ascend_start(u_ext, c_win, cr0, cc0, geo):
    inside = geo.interior(u_ext.device)
    return torch.where(inside, u_ext + K._prolong_ext(c_win, cr0, cc0, geo), u_ext)


def _check(leg, geo, steps, err, seed, fw=False, from_zero=False, rows=None, mutate=None,
           dtype=torch.float32):
    """The emulated leg against its twin (owned and coarse blocks bit for
    bit), its partials against legs.cuh's order bit for bit, their sum
    against the twin's raw error (a bf16 twin's sum rounded to bf16: 2^-8).
    Returns whether all held (a mutation must make it False)."""
    h = 1.0 / (geo.n - 1)
    rng = np.random.default_rng(seed)
    ug, fg = _grid(geo.n, seed, dtype)
    u_ext, f_ext = _window(ug, geo), _window(fg, geo)
    mode = {"cpu": "cpu", "clean": "clean", "gpu": "gpu", None: None}[err]
    if leg == "descend":
        restriction = "full_weighting" if fw else "sampling"
        got, gfc, parts = leg_pass(leg, None if from_zero else u_ext, f_ext, geo, h, steps, err,
                                   fw, from_zero, rows=rows, mutate=mutate)
        want, wfc, raw = K.fused_descend_shard_torch(u_ext, f_ext, geo, h, steps, OMEGA,
                                                     restriction, mode, from_zero)
        ok = torch.equal(got, want) and torch.equal(gfc, wfc)
        start, fz = u_ext, from_zero
    else:
        m = (geo.n + 1) // 2
        cg = torch.from_numpy(rng.standard_normal((m, m)).astype(np.float32)).to(dtype)
        # the coarse window the sharded callers cut: the block's coarse
        # points and the halo's, clipped to the grid
        ch = max(geo.ext_r, geo.ext_c) // 2 + 1
        cr0 = max(0, geo.row0 // 2 - (ch if geo.ext_r else 0))
        cc0 = max(0, geo.col0 // 2 - (ch if geo.ext_c else 0))
        cr1 = min(m, (geo.row0 + geo.rows + 1) // 2 + (ch if geo.ext_r else 0))
        cc1 = min(m, (geo.col0 + geo.cols + 1) // 2 + (ch if geo.ext_c else 0))
        c_win = cg[cr0:cr1, cc0:cc1].contiguous()
        got, _, parts = leg_pass(leg, u_ext, f_ext, geo, h, steps, err, c_win=c_win, cr0=cr0,
                                 cc0=cc0, rows=rows, mutate=mutate)
        want, raw = K.fused_ascend_shard_torch(u_ext, f_ext, c_win, cr0, cc0, geo, h, steps,
                                               OMEGA, mode)
        ok = torch.equal(got, want)
        start, fz = _ascend_start(u_ext, c_win, cr0, cc0, geo), False
    if err is None or not ok:
        return ok
    ref = tile_partials(_terms(None if fz else start, f_ext, geo, h, steps, err, fz), geo)
    if not torch.equal(parts, ref):
        return False
    total = float(parts.double().sum())
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    assert abs(total - float(raw)) <= rtol * abs(float(raw)) + 1e-30
    return True


ERRS = (None, "cpu", "clean", "gpu")


# --- the cases ----------------------------------------------------------------------------------

@pytest.mark.parametrize("steps", range(1, 9))
@pytest.mark.parametrize("from_zero", [False, True])
def test_descend_whole_grid_257(steps, from_zero):
    """257²: three strips, the last one column wide; both restrictions,
    every error."""
    geo = K.ShardGeo(257, 0, 0, 257, 257)
    for fw in (False, True):
        for err in ERRS:
            assert _check("descend", geo, steps, err, seed=steps, fw=fw, from_zero=from_zero), \
                f"steps={steps} fz={from_zero} fw={fw} err={err}"


@pytest.mark.parametrize("steps", range(1, 9))
def test_ascend_whole_grid_257(steps):
    geo = K.ShardGeo(257, 0, 0, 257, 257)
    for err in ERRS:
        assert _check("ascend", geo, steps, err, seed=20 + steps), f"steps={steps} err={err}"


@pytest.mark.parametrize("leg", ["descend", "ascend"])
@pytest.mark.parametrize("n,steps,rows", [(259, 2, 64), (259, 7, 256), (1031, 3, 64),
                                          (1031, 8, 256), (1031, 1, 32)])
def test_ragged_forced_chunks(leg, n, steps, rows):
    """A ragged last strip and chunk (259²: 3 columns, 1031²: 7), chunks of
    one, two and eight tile rows."""
    geo = K.ShardGeo(n, 0, 0, n, n)
    cases = ((None, True, False), ("cpu", False, True), ("gpu", True, steps % 2 == 0)) \
        if leg == "descend" else ((None, False, False), ("clean", False, False),
                                  ("gpu", False, False))
    for err, fw, fz in cases:
        assert _check(leg, geo, steps, err, seed=n + steps, fw=fw, from_zero=fz, rows=rows), \
            f"{leg} n={n} steps={steps} err={err} fw={fw} fz={fz}"


def _even_row_shards(n, shards, ext):
    bounds = [2 * round(n * i / shards / 2) for i in range(shards)] + [n]
    return [K.ShardGeo(n, a, 0, b - a, n, ext, 0) for a, b in zip(bounds[:-1], bounds[1:])]


def _even_blocks(n, ext):
    """2 × 4 blocks at even origins."""
    rb, cb = [0, 130, n], [0, 64, 132, 198, n]
    return [K.ShardGeo(n, rb[i], cb[j], rb[i + 1] - rb[i], cb[j + 1] - cb[j], ext, ext)
            for i in range(2) for j in range(4)]


@pytest.mark.parametrize("layout", ["rows-2", "rows-8", "blocks"])
@pytest.mark.parametrize("steps,err,fw,from_zero",
                         [(1, "cpu", True, False), (3, "cpu", False, True),
                          (8, None, True, False), (6, "clean", True, True),
                          (5, "gpu", False, False), (1, "gpu", True, True)])
def test_descend_shards(layout, steps, err, fw, from_zero):
    """Each shard's block from its window (exactly the halo the leg reads:
    k + 1, + 1 for full weighting), masks by global index, the block's
    coarse points, partials over its owned cells."""
    n = 257
    ext = steps - from_zero + 1 + fw
    geos = (_even_row_shards(n, int(layout[-1]), ext) if layout != "blocks"
            else _even_blocks(n, ext))
    for i, geo in enumerate(geos):
        assert _check("descend", geo, steps, err, seed=30 + i, fw=fw, from_zero=from_zero,
                      rows=32 if i % 2 else 64), f"{geo}"


@pytest.mark.parametrize("layout", ["rows-2", "rows-8", "blocks"])
@pytest.mark.parametrize("steps,err", [(1, "cpu"), (3, None), (7, "clean"), (8, "gpu")])
def test_ascend_shards(layout, steps, err):
    n = 257
    ext = steps + (err in ("cpu", "clean"))
    geos = (_even_row_shards(n, int(layout[-1]), ext) if layout != "blocks"
            else _even_blocks(n, ext))
    for i, geo in enumerate(geos):
        assert _check("ascend", geo, steps, err, seed=40 + i, rows=32 if i % 2 else 64), f"{geo}"


@pytest.mark.parametrize("leg,mutation,steps,err,fw",
                         [("descend", "fw_halo", 3, "cpu", True),
                          ("descend", "origin", 3, "cpu", True),
                          ("ascend", "cring", 2, "cpu", False),
                          ("ascend", "rows_first", 3, None, False),
                          ("ascend", "origin", 3, "gpu", False)])
def test_mutated_schedule_fails(leg, mutation, steps, err, fw):
    """A halo a row short for full weighting, a coarse ring a row short
    (read before its first row's copy lands at an odd first row), the
    prolongation's rows before its columns, chunk origins a row early (the
    tiles' partials split): each changes an output; unmutated each matches.
    257², chunks of 64 rows."""
    geo = K.ShardGeo(257, 0, 0, 257, 257)
    assert _check(leg, geo, steps, err, seed=70, fw=fw, rows=64)
    assert not _check(leg, geo, steps, err, seed=70, fw=fw, rows=64, mutate=mutation), \
        f"the {mutation} mutation went unseen"


# --- the twins against JAX at 257² ----------------------------------------------------------

def _jx(a):
    return layout.pad_grid(jnp.asarray(a))


@pytest.mark.parametrize("restriction,compat,from_zero",
                         [("full_weighting", True, False), ("sampling", "gpu", True)])
def test_descend_twin_matches_pallas_257(restriction, compat, from_zero):
    n, steps = 257, 3
    rng = np.random.default_rng(80)
    u, f = (rng.standard_normal((n, n)).astype(np.float32) for _ in range(2))
    if from_zero:
        u = np.zeros_like(u)
    m, h = (n + 1) // 2, 1.0 / (n - 1)
    want_u, dwide, want_err = pk.fused_descend_padded(
        _jx(u), _jx(f), n, h, steps, omega=OMEGA, restriction=restriction, compat=compat,
        want_err=True, from_zero=from_zero, interpret=True)
    want_fc = np.asarray(P.restrict_lanes_p(dwide, n, m, layout.padded_shape(m)))[:m, :m]
    got_u, got_fc, got_err = K.fused_descend_torch(
        torch.from_numpy(u), torch.from_numpy(f), h, steps, OMEGA, restriction, compat, True,
        from_zero)
    want_u = np.asarray(want_u)[:n, :n]
    # tolerances as tests/test_torch_kernels.py states them
    np.testing.assert_allclose(got_u.numpy(), want_u, rtol=0,
                               atol=1e-5 * float(np.abs(want_u).max()))
    np.testing.assert_allclose(got_fc.numpy(), want_fc, rtol=0,
                               atol=2e-6 * (float(np.abs(want_fc).max()) + 1))
    assert float(got_err) == pytest.approx(float(want_err), rel=1e-4)


def test_ascend_twin_matches_pallas_257():
    n, steps = 257, 3
    rng = np.random.default_rng(81)
    uf, f = (rng.standard_normal((n, n)).astype(np.float32) for _ in range(2))
    m, h = (n + 1) // 2, 1.0 / (n - 1)
    uc = rng.standard_normal((m, m)).astype(np.float32)
    uc[0, :] = uc[-1, :] = uc[:, 0] = uc[:, -1] = 0
    ufp = _jx(uf)
    rp, cp = ufp.shape
    cwide = P.prolong_lanes_p(_jx(uc), m, n, (rp // 2 + 8, cp))
    want_u, want_err = pk.fused_ascend_padded(ufp, _jx(f), cwide, n, h, steps, omega=OMEGA,
                                              compat=True, want_err=True, interpret=True)
    got_u, got_err = K.fused_ascend_torch(torch.from_numpy(uf), torch.from_numpy(f),
                                          torch.from_numpy(uc), h, steps, OMEGA, True, True)
    want_u = np.asarray(want_u)[:n, :n]
    np.testing.assert_allclose(got_u.numpy(), want_u, rtol=0,
                               atol=1e-5 * float(np.abs(want_u).max()))
    assert float(got_err) == pytest.approx(float(want_err), rel=1e-4)


# --- the bf16 legs ------------------------------------------------------------------------------

@pytest.mark.parametrize("leg", ["descend", "ascend"])
@pytest.mark.parametrize("steps", [1, 3, 8])
def test_bf16_legs(leg, steps):
    """The legs on bf16 rows: 257² whole (rows at every 2-byte offset of a
    16-byte chunk) with every error, both restrictions and from_zero, and
    ragged 1031² with chunks of 64 rows."""
    BF16 = torch.bfloat16
    geo = K.ShardGeo(257, 0, 0, 257, 257)
    for err in ERRS:
        for fw, fz in ((False, False), (True, True)) if leg == "descend" else ((False, False),):
            assert _check(leg, geo, steps, err, seed=90 + steps, fw=fw, from_zero=fz,
                          dtype=BF16), f"{leg} steps={steps} err={err} fw={fw} fz={fz}"
    geo = K.ShardGeo(1031, 0, 0, 1031, 1031)
    err = ("cpu", "gpu", "clean")[steps % 3]
    assert _check(leg, geo, steps, err, seed=91, fw=steps > 1, rows=64, dtype=BF16)


@pytest.mark.parametrize("leg,mutation,steps,err,fw",
                         [("descend", "fw_halo", 3, "cpu", True),
                          ("descend", "origin", 3, "cpu", True),
                          ("ascend", "cring", 2, "cpu", False),
                          ("ascend", "rows_first", 3, None, False),
                          ("ascend", "origin", 3, "gpu", False)])
def test_bf16_mutated_schedule_fails(leg, mutation, steps, err, fw):
    """test_mutated_schedule_fails's cases on bf16 rows: each mutation seen."""
    geo = K.ShardGeo(257, 0, 0, 257, 257)
    args = dict(fw=fw, rows=64, dtype=torch.bfloat16)
    assert _check(leg, geo, steps, err, seed=92, **args)
    assert not _check(leg, geo, steps, err, seed=92, mutate=mutation, **args), \
        f"the {mutation} mutation went unseen"
