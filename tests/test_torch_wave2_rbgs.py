"""Kernel 1's rb-GS mode on the row-streaming wavefront (csrc/rbgs.cu over
csrc/wave2.cuh's WV_RBGS stage), emulated in plain PyTorch on the CPU.

Nothing compiles the CUDA sources here, so these tests hold the stage's
rules against the plain twins the card's checks hold the kernel to
(chip_smoke.py phase 2 and G1), as tests/test_torch_wave2.py does for the
Jacobi pass, whose helpers they reuse:

  * the pass, mirrored over every warp at once: k rb-GS sweeps are 2k
    half-levels of kernel 1's register pipeline, level s (at row r − s from
    level s − 1's rows r − s − 1 .. r − s + 1) the update of colour
    (s − 1) & 1 (even first, (gi + gj) & 1 by global index) on the interior,
    ¼·(nb − h²f) in the twin's order, every other cell copied; with the cpu
    or clean error one more level forms Δ = ¼·((nb − 4u) − h²f) of level 2k
    and adds |Δ| (cpu: the even colour) into the tile partials; from_zero:
    level 0 is 0 and u is not read;
  * run with every value it must not read set to NaN (staged columns beyond
    the strip and the window, the level windows before their first row,
    rows past the chunk's loop, stale ring rows), the owned block equals
    ``fused_rbgs_torch`` / ``fused_rbgs_err_torch`` (whole grid) and
    ``fused_jacobi_shard_torch(..., smoother="rbgs")`` (shards) bit for bit:
    1-4 sweeps, no error, cpu and clean, from_zero, whole grids of 257² and
    a ragged 1031² with chunks of 32-256 rows, row shards and 2 × 4 blocks
    with odd global origins;
  * the tile partials, formed in the wavefront's order, equal legs.cuh's
    error_partial + block_sum order over the twin's |Δ| bit for bit, and
    their sum the twin's error;
  * the checks see a wrong schedule: the colour parity off by one, the
    colours in the other order, a halo a row short;
  * the emulated pass against the JAX package's Pallas rb-GS kernel in
    interpret mode (``fused_rbgs_err_padded``) at 129².
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_poisson_solver_tpu.ops import layout
from multigrid_poisson_solver_tpu.ops import pallas_kernels as pk
from multigrid_poisson_solver_tpu_torch.ops import kernels as K
from test_torch_wave2 import (NAN, _grid, _neighbours, _Partials, _Warps, _window, _exchange,
                              chunk_rows, tile_partials)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulations run thousands of small tensor ops: one intra-op thread
    each, as several test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rbgs_shape(steps, err):
    """(levels, H, D, NF, NU) of WaveShape<2·steps, E, false, WV_RBGS>."""
    k = 2 * steps
    halo = k + (err is not None)
    ahead = 4 if k <= 2 else 2
    return k, halo, ahead, halo + 1 + ahead, ahead + 1


def rbgs_pass(u_ext, f_ext, geo, h, steps, err=None, from_zero=False, rows=None, mutate=None):
    """wave2_pass with the rb-GS stage over every warp: (owned block,
    partials or None). ``mutate`` breaks the schedule for the tests that
    must see it: "parity" (the colour of (gi + gj + 1)), "order" (the odd
    colour first) or "halo" (a chunk starts a row late)."""
    n = geo.n
    k, halo, ahead, nf, nu = rbgs_shape(steps, err)
    late = int(mutate == "halo")
    rows = rows or chunk_rows(geo, halo=halo)
    wav = _Warps(geo, rows)
    warps = len(wav.tx)
    ga, gb = geo.row0 + wav.a, geo.row0 + wav.b
    r_end = gb + halo
    out = torch.full((geo.rows, geo.cols), NAN)
    errs = _Partials(0 if err is None else 1, wav.strips * -(-geo.rows // 32), warps, geo, wav,
                     err == "cpu")
    h2 = h * h
    par_gj = wav.gj % 2                      # the computed columns' parity
    flip = int(mutate == "parity")
    first = int(mutate == "order")           # the colour of half-level 1

    def fetch(win, gi):
        ri = (gi - wav.wr0).clamp(0, wav.wrows - 1)[:, None, None].expand_as(wav.gj)
        v = win[ri, (wav.gj - wav.wc0).clamp(0, wav.wcols - 1)]
        v = torch.where(wav.load_m, v, torch.full((), NAN))
        v = torch.where(((gi >= wav.r_lo) & (gi < wav.r_hi))[:, None, None], v, torch.zeros(()))
        return torch.where((gi >= r_end)[:, None, None], torch.full((), NAN), v)

    def write(gi, v):
        le = gi - geo.row0
        keep = ((le >= wav.a) & (le < wav.b))[:, None, None] & wav.own
        t = _exchange(v)
        w_idx, l_idx, q_idx = torch.nonzero(keep, as_tuple=True)
        out[le[w_idx], wav.gt[w_idx, l_idx, q_idx] - geo.col0] = t[w_idx, l_idx, q_idx]

    shape = (warps, 32, 5)
    ring_f = torch.full((warps, nf) + shape[1:], NAN)
    ring_u = torch.full((warps, nu) + shape[1:], NAN)
    r_first = ga - halo + late
    for d in range(ahead):
        ring_f[:, d] = fetch(f_ext, r_first + d)
        if not from_zero:
            ring_u[:, d] = fetch(u_ext, r_first + d)
    nw = [torch.full(shape, NAN) for _ in range(halo)]
    cw = [torch.full(shape, NAN) for _ in range(halo)]
    fs = us = 0
    for i in range(rows + 2 * halo - late):
        r = r_first + i
        ring_f[:, (fs + ahead) % nf] = fetch(f_ext, r + ahead)
        if not from_zero:
            ring_u[:, (us + ahead) % nu] = fetch(u_ext, r + ahead)
        cur = torch.zeros(shape) if from_zero else ring_u[:, us].clone()
        for s in range(1, halo + 1):
            gi = r - s
            fl = ring_f[:, (fs - s) % nf]
            uc = cw[s - 1]
            we, ea = _neighbours(uc)
            nb = ((nw[s - 1] + cur) + we) + ea
            if s <= k:
                colour = (s - 1 + first) % 2
                take = ((gi[:, None, None] + par_gj + flip) % 2 == colour) & wav.int_m
                take = take & ((gi >= 1) & (gi <= n - 2))[:, None, None]
                nxt = torch.where(take, 0.25 * (nb - h2 * fl), uc)
            else:
                errs.add(0, gi, 0.25 * ((nb - 4.0 * uc) - h2 * fl))
            nw[s - 1], cw[s - 1] = uc, cur
            if s <= k:
                cur = nxt
            if s == k:
                write(gi, cur)
        fs, us = (fs + 1) % nf, (us + 1) % nu
    return out, (None if err is None else errs.partials)


def _delta_terms(u_ext, f_ext, geo, h, steps, err, from_zero):
    """|Δ| of the twin's iterate after ``steps`` on the owned interior (the
    even colour for cpu), 0 elsewhere: what the partials sum."""
    inside = geo.interior(f_ext.device)
    even = geo.even(f_ext.device)
    u = torch.zeros_like(f_ext) if from_zero else u_ext
    for _ in range(steps):
        u = K._rbgs_half_ext(u, f_ext, inside & even, h)
        u = K._rbgs_half_ext(u, f_ext, inside & ~even, h)
    take = inside & geo.owned_mask(f_ext.device)
    if err == "cpu":
        take = take & even
    return geo.owned(torch.where(take, K._rbgs_delta_ext(u, f_ext, h), torch.zeros(())))


def _check(geo, steps, err, from_zero, seed, rows=None):
    """The emulated pass against the twins: the owned block bit for bit, the
    partials bit for bit legs.cuh's order, their sum the twin's error."""
    h = 1.0 / (geo.n - 1)
    ug, fg = _grid(geo.n, seed)
    u_ext, f_ext = _window(ug, geo), _window(fg, geo)
    got, parts = rbgs_pass(None if from_zero else u_ext, f_ext, geo, h, steps, err, from_zero,
                           rows)
    want, raw = K.fused_jacobi_shard_torch(u_ext, f_ext, geo, h, steps, 1.0, from_zero, err,
                                           "rbgs")
    assert torch.equal(got, want), f"iterate differs: {geo} steps={steps} err={err}"
    if geo.rows == geo.n and geo.cols == geo.n:   # the whole grid: the unsharded twins too
        if err is None:
            assert torch.equal(got, K.fused_rbgs_torch(ug, fg, h, steps, from_zero))
        else:
            wu, we = K.fused_rbgs_err_torch(ug, fg, h, steps, err == "cpu", from_zero)
            assert torch.equal(got, wu)
            scale = K.shard_err_scale(err, geo.n, h, "rbgs")
            assert float(parts[0].double().sum()) * scale == pytest.approx(float(we), rel=1e-5)
    if err is None:
        return
    ref = tile_partials(_delta_terms(u_ext, f_ext, geo, h, steps, err, from_zero), geo)
    assert torch.equal(parts[0], ref), f"partials differ from the tile order: {geo} {err}"
    total = float(parts[0].double().sum())
    assert abs(total - float(raw)) <= 1e-5 * abs(float(raw)) + 1e-30


def _errs(steps):
    return (None, "cpu", "clean") if steps <= 3 else (None,)


@pytest.mark.parametrize("steps", [1, 2, 3, 4])
@pytest.mark.parametrize("from_zero", [False, True])
def test_whole_grid_257(steps, from_zero):
    """257²: three strips, the last one column wide; every error the sweep
    count allows."""
    geo = K.ShardGeo(257, 0, 0, 257, 257)
    for err in _errs(steps):
        _check(geo, steps, err, from_zero, seed=steps)


@pytest.mark.parametrize("steps,rows,err,from_zero",
                         [(1, 256, "cpu", False), (2, 64, "clean", True), (3, 32, "cpu", True),
                          (4, 256, None, False), (2, 96, None, True)])
def test_ragged_1031(steps, rows, err, from_zero):
    """1031²: a ragged last strip (7 columns) and chunk; chunks of one to
    eight tile rows."""
    geo = K.ShardGeo(1031, 0, 0, 1031, 1031)
    _check(geo, steps, err, from_zero, seed=10 + steps, rows=rows)


def _row_shards(n, shards, ext):
    bounds = np.linspace(0, n, shards + 1).round().astype(int)
    return [K.ShardGeo(n, int(a), 0, int(b - a), n, ext, 0)
            for a, b in zip(bounds[:-1], bounds[1:])]


def _blocks(n, ext):
    """2 × 4 blocks with odd origins."""
    rb, cb = [0, 129, n], [0, 67, 131, 199, n]
    return [K.ShardGeo(n, rb[i], cb[j], rb[i + 1] - rb[i], cb[j + 1] - cb[j], ext, ext)
            for i in range(2) for j in range(4)]


@pytest.mark.parametrize("layout", ["rows", "blocks"])
@pytest.mark.parametrize("steps,err,from_zero",
                         [(1, "cpu", False), (2, None, True), (3, "clean", True),
                          (4, None, False), (2, "cpu", True)])
def test_shard_mode(layout, steps, err, from_zero):
    """Row shards of 257 (origins 64, 128, 193) and 2 × 4 blocks (origins
    67, 129, 131, 199): the colour by global index, the partials over the
    owned cells."""
    n = 257
    ext = 2 * steps + (err is not None) + 1
    geos = _row_shards(n, 4, ext) if layout == "rows" else _blocks(n, ext)
    for i, geo in enumerate(geos):
        _check(geo, steps, err, from_zero, seed=30 + i, rows=32 if i % 2 else 64)


@pytest.mark.parametrize("mutation", ["parity", "order", "halo"])
def test_mutated_schedule_fails(mutation):
    """The emulation tells a wrong schedule from the kernel's: the colour
    parity off by one, the odd colour first or a chunk that starts a row
    late changes the iterate or the partials (2 sweeps + cpu error, chunks
    of 64 rows, a block with odd origins); unmutated it matches."""
    geo = K.ShardGeo(257, 129, 67, 128, 64, 6, 6)
    h = 1.0 / (geo.n - 1)
    ug, fg = _grid(geo.n, 70)
    u_ext, f_ext = _window(ug, geo), _window(fg, geo)
    want, _ = K.fused_jacobi_shard_torch(u_ext, f_ext, geo, h, 2, 1.0, False, "cpu", "rbgs")
    ref = tile_partials(_delta_terms(u_ext, f_ext, geo, h, 2, "cpu", False), geo)

    def matches(mutate):
        got, parts = rbgs_pass(u_ext, f_ext, geo, h, 2, "cpu", rows=64, mutate=mutate)
        return torch.equal(got, want) and torch.equal(parts[0], ref)

    assert matches(None)
    assert not matches(mutation), f"the {mutation} mutation went unseen"


@pytest.mark.parametrize("compat", [True, False])
def test_emulation_matches_pallas_129(compat):
    """The emulated pass (2 sweeps, the cpu or clean error) against JAX's
    Pallas rb-GS kernel in interpret mode on the same inputs: the iterate to
    1e-5 of its largest value, the error to 1e-4."""
    n = 129
    h = 1.0 / (n - 1)
    rng = np.random.default_rng(80)
    u = rng.standard_normal((n, n)).astype(np.float32)
    f = rng.standard_normal((n, n)).astype(np.float32)
    want_u, want_e = pk.fused_rbgs_err_padded(layout.pad_grid(jnp.asarray(u)),
                                              layout.pad_grid(jnp.asarray(f)), n, h, 2,
                                              compat=compat, interpret=True)
    want_u = np.asarray(want_u)[:n, :n]
    geo = K.ShardGeo(n, 0, 0, n, n)
    got, parts = rbgs_pass(torch.from_numpy(u), torch.from_numpy(f), geo, h, 2,
                           "cpu" if compat else "clean")
    np.testing.assert_allclose(got.numpy(), want_u, rtol=0,
                               atol=1e-5 * float(np.abs(want_u).max()))
    scale = K.shard_err_scale("cpu" if compat else "clean", n, h, "rbgs")
    assert float(parts[0].double().sum()) * scale == pytest.approx(float(want_e), rel=1e-4)
