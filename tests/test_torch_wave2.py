"""The row-streaming wavefront of kernel 1's Jacobi modes (csrc/wave2.cuh),
emulated in plain PyTorch on the CPU.

Nothing compiles the CUDA sources here, so these tests hold the rules the
kernels follow against the plain twins the card's checks hold the kernels
to (chip_smoke.py phases 2 and G1):

  * the pass, mirrored below over every warp at once: a warp owns one
    128-column tile strip and a chunk of whole tile rows, stages 16 halo
    columns a side, receives row r of u and f through rings of D rows ahead
    (columns outside the window and the grid NaN, where the kernel reads 0
    or, with 16-byte chunks, the previous row's last floats: no owned cell
    may depend on them), computes on five adjacent columns a
    lane (lane x: 5x + c) level s at row r − s from level s − 1's last two
    rows (kept from earlier steps) and row r − s + 1, the columns beyond its
    own from the adjacent lanes by one shuffle each way, and hands a row to
    the tile layout (lane x: tile columns x + 32q) through shared memory for
    the stores and the error terms. Run with every value it must not read
    set to NaN (the level windows before their first row, the rows past its
    chunk's loop, the staged columns −1 and 160, stale ring rows), the owned
    block equals ``fused_jacobi_shard_torch`` (or
    ``fused_jacobi_errs_shard_torch``) bit for bit, whole grid and per
    shard, for 0-8 sweeps after from_zero's closed form, every error mode,
    ragged last strips and chunks and odd shard origins;
  * the per-tile error partials, formed in the wavefront's order (lane x's
    accumulator per tile row mod 8 adding its four tile columns in order,
    the eight butterflies and the final sum) and in legs.cuh's
    error_partial + block_sum order (thread (x, y), tile rows y + 8m,
    columns x + 32q, the warp butterflies, then the block's over the eight
    warp sums), each with float32 adds in sequence, are equal bit for bit:
    the trigger kernels 8 and 9, which keep the tile pipeline, report what
    loops of these launches report;
  * the per-sweep mode's partials of iterate s equal the fixed mode's after
    s sweeps, bit for bit;
  * the checks above see a wrong schedule: the emulation run with a halo a
    row short, a lane map shifted by a lane, a wrong tile-row-mod-8 index or
    an f ring a row short fails them;
  * the bf16 mode (``csrc/jacobi_bf16.cu``): the same pass on bf16 rows,
    each op rounded to bf16 as the twin's tensors are (the emulation's ops
    on bf16 tensors), the partials float sums of the rounded terms, against
    the twin run on bf16 tensors bit for bit, with the mutations seen; and
    its copy plan: every row copied in 16-byte chunks of 8 values from the
    chunk holding the strip's first staged column, at any of 8 offsets (the
    fp32 plan's 4), lands every staged column of the grid where the pass
    reads it and reads no byte outside the grid, and so does the ascend
    leg's coarse-row plan.

The emulation is test code: the kernels' own schedule lives in
csrc/wave2.cuh and its launch rule in csrc/jacobi.cu.
"""

import numpy as np
import pytest
import torch

from multigrid_poisson_solver_tpu_torch.ops import kernels as K

TILE_H, TILE_W = 32, 128
PAD, SLOTS, LANES = 16, 5, 32
OMEGA = 0.8
NAN = float("nan")
H100_SMS = 132
START_ROWS = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulations run thousands of small tensor ops: one intra-op thread
    each, as several test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _grid(n, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)).to(dtype),
            torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)).to(dtype))


def _window(x, geo):
    """The block's window of the global grid x, 0 beyond the grid."""
    n = geo.n
    pad = max(geo.ext_r, geo.ext_c)
    xp = torch.nn.functional.pad(x, (pad, pad, pad, pad))
    r0, c0 = geo.row0 - geo.ext_r + pad, geo.col0 - geo.ext_c + pad
    rows, cols = geo.ext_shape
    assert r0 >= 0 and c0 >= 0 and r0 + rows <= n + 2 * pad and c0 + cols <= n + 2 * pad
    return xp[r0:r0 + rows, c0:c0 + cols].contiguous()


def _mode(err):
    return {"cpu": "cpu", "clean": "clean", "gpu": "gpu", None: None}[err]


# --- the pass's shape and launch rule (WaveShape, wave2_chunk_rows) ---------------------------

def wave_shape(k, err):
    """(H, D, NF, NU) of WaveShape<k, E, ALL>: halo rows, rows loaded
    ahead, f ring rows, u ring rows."""
    halo = k + (err in ("cpu", "clean"))
    ahead = 4 if k <= 2 else 2
    return halo, ahead, halo + 1 + ahead, ahead + 1


def chunk_rows(geo, resident=16 * H100_SMS, halo=8):
    """wave2_chunk_rows: the multiple of 32 owned rows a chunk that finishes
    first, waves × (rows + 2·halo + 16) with ``resident`` warps at once; of
    equal times the most rows."""
    strips = -(-geo.cols // TILE_W)
    best, best_cost = TILE_H, None
    for rows in range(TILE_H, geo.rows + TILE_H, TILE_H):
        cost = -(-strips * -(-geo.rows // rows) // resident) * (rows + 2 * halo + START_ROWS)
        if best_cost is None or cost <= best_cost:
            best, best_cost = rows, cost
    return best


@pytest.mark.parametrize("resident", [12 * H100_SMS, 16 * H100_SMS, 24 * H100_SMS])
def test_chunk_rule_makes_one_wave(resident):
    """At the main paths' shapes (8193² and 4097² whole, a 1024-row shard of
    8193² and a 512-row one of 4097²) the pass is one wave of whole tile rows
    a chunk: no more warps than the card keeps resident, and no multiple of
    32 rows a chunk that also makes one wave sweeps fewer rows a warp."""
    geo = K.ShardGeo
    for g in (geo(8193, 0, 0, 8193, 8193), geo(4097, 0, 0, 4097, 4097),
              geo(8193, 1024, 0, 1024, 8193, 8, 0), geo(4097, 512, 0, 512, 4097, 8, 0)):
        strips = -(-g.cols // TILE_W)
        for halo in (1, 4, 9):
            rows = chunk_rows(g, resident, halo)
            assert rows % TILE_H == 0 and strips * -(-g.rows // rows) <= resident
            fewer = rows - TILE_H
            assert fewer < TILE_H or strips * -(-g.rows // fewer) > resident
    assert chunk_rows(geo(8193, 0, 0, 8193, 8193), 12 * H100_SMS) == 352
    for k in range(0, 9):
        for err in (None, "cpu", "clean", "gpu"):
            halo, ahead, nf, nu = wave_shape(k, err)
            assert halo <= PAD and nf == halo + 1 + ahead and nu == ahead + 1


# --- the wavefront, mirrored over every warp at once -----------------------------------------

class _Partials:
    """wave2_pass's ``add``: per warp, lane, level and tile row mod 8 an
    accumulator; after a tile's last row (or the chunk's), the eight
    butterflies and the final sum into the level's row of partials."""

    def __init__(self, levels, tiles, warps, geo, wav, even_only, mutate=None):
        self.acc = torch.zeros(warps, max(levels, 1), 8, LANES)
        self.partials = torch.full((max(levels, 1), tiles), NAN)
        self.geo, self.wav, self.even_only, self.mutate = geo, wav, even_only, mutate

    def add(self, lv, gi, v):
        geo, wav = self.geo, self.wav
        le = gi - geo.row0
        inr = (le >= wav.a) & (le < wav.b)
        t = _exchange(v, self.mutate == "lane")
        take = (inr & (gi >= wav.i_lo) & (gi <= wav.i_hi))[:, None, None] & wav.err_m
        if self.even_only:
            take = take & ((gi[:, None, None] + wav.gt) % 2 == 0)
        y = (le // 4) % 8 if self.mutate == "rowmod" else le % 8
        idx = torch.arange(len(gi))
        s = self.acc[idx, lv, y]
        for q in range(TILE_W // LANES):
            s = s + torch.where(take[:, :, q], t[:, :, q].abs(), torch.zeros(()))
        self.acc[idx, lv, y] = torch.where(inr[:, None], s, self.acc[idx, lv, y])
        flush = inr & ((le % TILE_H == TILE_H - 1) | (le == wav.b - 1))
        if not bool(flush.any()):
            return
        lanes = torch.arange(LANES)
        w = []
        for yy in range(8):
            x = self.acc[:, lv, yy]
            for o in (16, 8, 4, 2, 1):
                x = x + x[:, lanes ^ o]
            w.append(x[:, 0])
        total = ((w[0] + w[4]) + (w[2] + w[6])) + ((w[1] + w[5]) + (w[3] + w[7]))
        tile = (le // TILE_H) * wav.strips + wav.tx
        self.partials[lv, tile[flush]] = total[flush]
        self.acc[flush, lv] = 0.0


class _Warps:
    """Every warp's strip, chunk and columns (wave2_pass's prologue): lane x
    computes staged columns 5x + c and, in the tile layout, holds tile
    columns x + 32q."""

    def __init__(self, geo, rows):
        n = geo.n
        self.strips = -(-geo.cols // TILE_W)
        self.chunks = -(-geo.rows // rows)
        wid = torch.arange(self.strips * self.chunks)
        self.tx, ch = wid % self.strips, wid // self.strips
        self.a = ch * rows
        self.b = torch.clamp(self.a + rows, max=geo.rows)
        lane = torch.arange(LANES)[:, None]
        gc0 = geo.col0 + self.tx[:, None, None] * TILE_W - PAD
        self.gj = gc0 + SLOTS * lane + torch.arange(SLOTS)[None, :]
        self.gt = gc0 + PAD + lane + LANES * torch.arange(TILE_W // LANES)[None, :]
        wr0, wc0 = geo.row0 - geo.ext_r, geo.col0 - geo.ext_c
        wrows, wcols = geo.ext_shape
        self.r_lo, self.r_hi = max(0, wr0), min(n, wr0 + wrows)
        c_lo, c_hi = max(0, wc0), min(n, wc0 + wcols)
        self.load_m = (self.gj >= c_lo) & (self.gj < c_hi)
        self.int_m = (self.gj >= 1) & (self.gj <= n - 2)
        self.own = self.gt < geo.col0 + geo.cols
        j_lo, j_hi = max(1, geo.col0), min(n - 2, geo.col0 + geo.cols - 1)
        self.i_lo, self.i_hi = max(1, geo.row0), min(n - 2, geo.row0 + geo.rows - 1)
        self.err_m = self.own & (self.gt >= j_lo) & (self.gt <= j_hi)
        self.wr0, self.wc0, self.wrows, self.wcols = wr0, wc0, wrows, wcols


def _exchange(v, shifted=False):
    """A row of lane x's columns 5x + c handed through shared memory to the
    tile layout: thread x's tile columns x + 32q (staged 16 + x + 32q);
    ``shifted``, a mutation: lane x reading lane x + 1's."""
    row = v.reshape(len(v), LANES * SLOTS)
    lanes = (torch.arange(LANES) + int(shifted)) % LANES
    cols = PAD + lanes[:, None] + LANES * torch.arange(TILE_W // LANES)[None, :]
    return row[:, cols]


def _neighbours(v):
    """The side neighbours of lane x's columns 5x + c: its own columns, and
    lane x − 1's last (``__shfl_up_sync``) and lane x + 1's first
    (``__shfl_down_sync``); NaN past the staged columns, where the shuffles
    return the lane's own."""
    w = torch.cat([torch.full_like(v[:, :1, -1:], NAN), v[:, :-1, -1:]], dim=1)
    e = torch.cat([v[:, 1:, :1], torch.full_like(v[:, :1, :1], NAN)], dim=1)
    return (torch.cat([w, v[:, :, :-1]], dim=2), torch.cat([v[:, :, 1:], e], dim=2))


def wave_pass(u_ext, f_ext, geo, h, steps, err=None, per_sweep=False, from_zero=False,
              rows=None, mutate=None):
    """wave2_pass over every warp: (owned block, partials by level and tile
    or None). ``steps`` counts from_zero's closed form, as the entry points
    do; ``rows`` overrides the chunk rule. ``mutate`` breaks the schedule
    for the tests that must see it: "halo" (a chunk starts a row late),
    "lane" (the tile layout shifted by a lane), "rowmod" (the accumulator
    of tile row le // 4 mod 8, not le mod 8) or "ring" (the f ring a row
    short)."""
    n = geo.n
    k = steps - from_zero
    halo, ahead, nf, nu = wave_shape(k, err)
    nf -= mutate == "ring"
    late = int(mutate == "halo")
    rows = rows or chunk_rows(geo)
    wav = _Warps(geo, rows)
    warps = len(wav.tx)
    ga, gb = geo.row0 + wav.a, geo.row0 + wav.b
    r_end = gb + halo
    dt = f_ext.dtype   # the storage type: every level and ring row rounds to it
    out = torch.full((geo.rows, geo.cols), NAN, dtype=dt)
    levels = 0 if err is None else (k if per_sweep else 1)
    errs = _Partials(levels, wav.strips * -(-geo.rows // TILE_H), warps, geo, wav, err == "cpu",
                     mutate)
    h2, inv_h2, zc = h * h, 1.0 / (h * h), K._zero_coef(h, OMEGA)

    def fetch(win, gi):
        ri = (gi - wav.wr0).clamp(0, wav.wrows - 1)[:, None, None].expand_as(wav.gj)
        v = win[ri, (wav.gj - wav.wc0).clamp(0, wav.wcols - 1)]
        # columns outside the window and the grid: 0 or whatever memory holds
        v = torch.where(wav.load_m, v, torch.full((), NAN))
        v = torch.where(((gi >= wav.r_lo) & (gi < wav.r_hi))[:, None, None], v, torch.zeros(()))
        # rows past the chunk's loop: never read, whatever the ring holds
        return torch.where((gi >= r_end)[:, None, None], torch.full((), NAN), v)

    def write(gi, v):
        le = gi - geo.row0
        keep = ((le >= wav.a) & (le < wav.b))[:, None, None] & wav.own
        t = _exchange(v, mutate == "lane")
        w_idx, l_idx, q_idx = torch.nonzero(keep, as_tuple=True)
        out[le[w_idx], wav.gt[w_idx, l_idx, q_idx] - geo.col0] = t[w_idx, l_idx, q_idx]

    shape = (warps, LANES, SLOTS)
    ring_f = torch.full((warps, nf) + shape[1:], NAN, dtype=dt)
    ring_u = torch.full((warps, nu) + shape[1:], NAN, dtype=dt)
    r_first = ga - halo + late
    for d in range(ahead):
        ring_f[:, d] = fetch(f_ext, r_first + d)
        if not from_zero:
            ring_u[:, d] = fetch(u_ext, r_first + d)
    nw = [torch.full(shape, NAN, dtype=dt) for _ in range(max(halo, 1))]
    cw = [torch.full(shape, NAN, dtype=dt) for _ in range(max(halo, 1))]
    fs = us = 0
    for i in range(rows + 2 * halo - late):
        r = r_first + i
        fd, ud = (fs + ahead) % nf, (us + ahead) % nu
        ring_f[:, fd] = fetch(f_ext, r + ahead)
        if not from_zero:
            ring_u[:, ud] = fetch(u_ext, r + ahead)
        if from_zero:
            ri = ((r >= 1) & (r <= n - 2))[:, None, None] & wav.int_m
            cur = torch.where(ri, zc * ring_f[:, fs], torch.zeros(()))
        else:
            cur = ring_u[:, us].clone()
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
            if err in ("cpu", "clean") and (s >= 2 if per_sweep else s - 1 == k):
                errs.add(s - 2 if per_sweep else 0, gi, inv_h2 * (nb - 4.0 * uc) - fl)
            if err == "gpu" and s <= k and (per_sweep or s == k):
                errs.add(s - 1 if per_sweep else 0, gi, nxt - uc)
            nw[s - 1], cw[s - 1] = uc, cur
            if s <= k:
                cur = nxt
            if s == k:
                write(gi, cur)
        fs, us = (fs + 1) % nf, (us + 1) % nu
    return out, (None if err is None else errs.partials)


# --- legs.cuh's order of the partials ---------------------------------------------------------

def _butterfly(t):
    lanes = torch.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        t = t + t[..., lanes ^ o]
    return t


def tile_partials(vals, geo):
    """error_partial + block_sum over the owned block's tiles of ``vals`` (the
    terms of the owned interior cells, 0 elsewhere): thread (x, y) adds tile
    rows y + 8m, columns x + 32q from +0, a butterfly over each warp, then
    over the warp sums in lanes 0..7 (the others +0); thread (0, 0)'s value."""
    ty, tx = -(-geo.rows // TILE_H), -(-geo.cols // TILE_W)
    v = torch.zeros(ty * TILE_H, tx * TILE_W)
    v[:geo.rows, :geo.cols] = vals
    v = v.reshape(ty, TILE_H, tx, TILE_W).permute(0, 2, 1, 3).reshape(ty * tx, 4, 8, 4, 32)
    acc = torch.zeros(ty * tx, 8, 32)               # [tile, y, x]
    for m in range(4):
        for q in range(4):
            acc = acc + v[:, m, :, q, :]
    warp_sums = _butterfly(acc)[:, :, 0]            # every lane holds the warp's sum
    last = torch.cat([warp_sums, torch.zeros(ty * tx, 24)], dim=1)
    return _butterfly(last)[:, 0]


def _terms(u_ext, f_ext, geo, h, steps, err, from_zero):
    """|r| or |Δu| of the twin's iterate after ``steps`` on the owned
    interior (the even color for cpu), 0 elsewhere."""
    inside = geo.interior(u_ext.device if u_ext is not None else f_ext.device)
    fin, prev = K._jacobi_window(u_ext, f_ext, inside, h, steps, OMEGA, from_zero)
    if err == "gpu":
        v = (fin if prev is None else fin - prev).abs()
    else:
        v = K._residual_ext(fin, f_ext, inside, h).abs()
    take = inside & geo.owned_mask(v.device)
    if err == "cpu":
        take = take & geo.even(v.device)
    return geo.owned(torch.where(take, v, torch.zeros(())))


# --- the cases ----------------------------------------------------------------------------------

def _check(geo, steps, err, from_zero, seed, rows=None, dtype=torch.float32):
    """The emulated pass against the twin (owned block bit for bit), its
    partials against legs.cuh's order bit for bit, and their sum against the
    twin's raw error (a bf16 twin's sum is rounded to bf16: 2^-8)."""
    h = 1.0 / (geo.n - 1)
    ug, fg = _grid(geo.n, seed, dtype)
    u_ext, f_ext = _window(ug, geo), _window(fg, geo)
    got, parts = wave_pass(None if from_zero else u_ext, f_ext, geo, h, steps, err,
                           from_zero=from_zero, rows=rows)
    want, raw = K.fused_jacobi_shard_torch(u_ext, f_ext, geo, h, steps, OMEGA, from_zero,
                                           _mode(err))
    assert torch.equal(got, want), f"iterate differs: {geo} steps={steps} err={err}"
    if err is None:
        return None
    ref = tile_partials(_terms(u_ext, f_ext, geo, h, steps, err, from_zero), geo)
    assert torch.equal(parts[0], ref), f"partials differ from the tile order: {geo} {err}"
    total = float(parts[0].double().sum())
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    assert abs(total - float(raw)) <= rtol * abs(float(raw)) + 1e-30
    return parts[0]


@pytest.mark.parametrize("steps", range(1, 9))
@pytest.mark.parametrize("from_zero", [False, True])
def test_fixed_modes_whole_grid_257(steps, from_zero):
    """257²: three strips, the last one column wide (as at 8193²)."""
    geo = K.ShardGeo(257, 0, 0, 257, 257)
    for err in (None, "cpu", "clean", "gpu"):
        _check(geo, steps, err, from_zero, seed=steps)


@pytest.mark.parametrize("steps,rows", [(1, 256), (3, 64), (8, 32), (5, 256), (8, 256)])
def test_fixed_modes_ragged_1031(steps, rows):
    """1031²: a ragged last strip (7 columns) and chunk; the chunks of 32,
    64 and 256 rows (one, two and eight tile rows a chunk; 8 sweeps with
    256 rows as at 8193², where the rule picks 352)."""
    geo = K.ShardGeo(1031, 0, 0, 1031, 1031)
    for err, fz in ((None, False), ("cpu", True), ("clean", False), ("gpu", steps % 2 == 1)):
        _check(geo, steps, err, fz, seed=10 + steps, rows=rows)


@pytest.mark.parametrize("steps", [2, 7])
def test_fixed_modes_whole_grid_513(steps):
    geo = K.ShardGeo(513, 0, 0, 513, 513)
    for err in ("cpu", "gpu"):
        _check(geo, steps, err, False, seed=20 + steps, rows=64)


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
                         [(1, "cpu", False), (3, "cpu", True), (8, None, False),
                          (8, "clean", True), (5, "gpu", False), (1, "gpu", True)])
def test_shard_mode(layout, steps, err, from_zero):
    """Row shards of 257 (odd origins) and 2 × 4 blocks: each shard's block
    from its window, masks by global index, partials over its owned cells."""
    n = 257
    ext = steps - from_zero + (err in ("cpu", "clean")) + 1
    geos = _row_shards(n, 4, ext) if layout == "rows" else _blocks(n, ext)
    for i, geo in enumerate(geos):
        _check(geo, steps, err, from_zero, seed=30 + i, rows=32 if i % 2 else 64)


def test_from_zero_closed_form_alone():
    """One step from zero: level 0 is the closed form (no sweep in the pass),
    with each error."""
    for geo in (K.ShardGeo(257, 0, 0, 257, 257), K.ShardGeo(257, 64, 67, 65, 131, 2, 2)):
        for err in (None, "cpu", "clean", "gpu"):
            _check(geo, 1, err, True, seed=40)


# --- the per-sweep mode ---------------------------------------------------------------------

@pytest.mark.parametrize("err", ["cpu", "clean", "gpu"])
@pytest.mark.parametrize("geo", [K.ShardGeo(257, 0, 0, 257, 257),
                                 K.ShardGeo(257, 65, 0, 64, 257, 9, 0),
                                 K.ShardGeo(257, 129, 67, 128, 64, 9, 9)],
                         ids=["whole", "row-shard", "block"])
def test_per_sweep_mode(err, geo):
    """The error of every iterate: the iterate as the twin's, row s − 1 of
    the partials bit for bit the fixed mode's after s sweeps (and legs.cuh's
    order), their sums the twin's raw errors."""
    cap = 8 if err == "gpu" else 7
    h = 1.0 / (geo.n - 1)
    ug, fg = _grid(geo.n, 50)
    u_ext, f_ext = _window(ug, geo), _window(fg, geo)
    for steps in (1, 4, cap) if geo.rows < geo.n else range(1, cap + 1):
        got, parts = wave_pass(u_ext, f_ext, geo, h, steps, err, per_sweep=True)
        want, raws = K.fused_jacobi_errs_shard_torch(u_ext, f_ext, geo, h, steps, OMEGA, err)
        assert torch.equal(got, want)
        for s in range(1, steps + 1):
            fixed = _check(geo, s, err, False, seed=50) if steps == cap else \
                tile_partials(_terms(u_ext, f_ext, geo, h, s, err, False), geo)
            assert torch.equal(parts[s - 1], fixed), f"iterate {s} of {steps}: {err} {geo}"
            total = float(parts[s - 1].double().sum())
            assert abs(total - float(raws[s - 1])) <= 1e-5 * abs(float(raws[s - 1])) + 1e-30


@pytest.mark.parametrize("err", ["cpu", "gpu"])
def test_per_sweep_mode_multi_tile_chunks(err):
    """The per-sweep mode at its cap with chunks of 256 rows (the rule's 288
    or more at 8193²): ragged 1031², each accumulated level flushed after
    every tile row of a chunk, row s − 1 of the partials bit for bit the
    fixed mode's after s sweeps."""
    geo = K.ShardGeo(1031, 0, 0, 1031, 1031)
    cap = 8 if err == "gpu" else 7
    h = 1.0 / (geo.n - 1)
    ug, fg = _grid(geo.n, 60)
    got, parts = wave_pass(ug, fg, geo, h, cap, err, per_sweep=True, rows=256)
    want, raws = K.fused_jacobi_errs_shard_torch(ug, fg, geo, h, cap, OMEGA, err)
    assert torch.equal(got, want)
    for s in range(1, cap + 1):
        fixed = tile_partials(_terms(ug, fg, geo, h, s, err, False), geo)
        assert torch.equal(parts[s - 1], fixed), f"iterate {s}: {err}"


@pytest.mark.parametrize("mutation", ["halo", "lane", "rowmod", "ring"])
def test_mutated_schedule_fails(mutation):
    """The emulation tells a wrong schedule from the kernel's: a chunk that
    starts a row late, a tile layout shifted by a lane, a wrong tile-row-mod-8
    accumulator or an f ring a row short changes the iterate or the
    partials (3 sweeps + cpu error, chunks of 64 rows); unmutated it
    matches."""
    geo = K.ShardGeo(257, 0, 0, 257, 257)
    h = 1.0 / (geo.n - 1)
    ug, fg = _grid(geo.n, 70)
    want, _ = K.fused_jacobi_shard_torch(ug, fg, geo, h, 3, OMEGA, False, "cpu")
    ref = tile_partials(_terms(ug, fg, geo, h, 3, "cpu", False), geo)

    def matches(mutate):
        got, parts = wave_pass(ug, fg, geo, h, 3, "cpu", rows=64, mutate=mutate)
        return torch.equal(got, want) and torch.equal(parts[0], ref)

    assert matches(None)
    assert not matches(mutation), f"the {mutation} mutation went unseen"


# --- the bf16 mode (csrc/jacobi_bf16.cu) ------------------------------------------------------

@pytest.mark.parametrize("steps", [1, 2, 3, 5, 8])
def test_bf16_modes_whole_grid(steps):
    """The pass on bf16 rows, every error and from_zero: 257² (rows at every
    2-byte offset of a 16-byte chunk) and ragged 1031² with chunks of 64
    rows."""
    for geo, rows in ((K.ShardGeo(257, 0, 0, 257, 257), None),
                      (K.ShardGeo(1031, 0, 0, 1031, 1031), 64)):
        for err, fz in ((None, False), ("cpu", True), ("clean", False), ("gpu", steps % 2 == 0)):
            if geo.n == 1031 and err in ("clean", None) and steps not in (1, 8):
                continue
            _check(geo, steps, err, fz, seed=80 + steps, rows=rows, dtype=torch.bfloat16)


@pytest.mark.parametrize("mutation", ["halo", "lane", "rowmod", "ring"])
def test_bf16_mutated_schedule_fails(mutation):
    """test_mutated_schedule_fails on bf16 rows: every mutation is seen."""
    geo = K.ShardGeo(257, 0, 0, 257, 257)
    h = 1.0 / (geo.n - 1)
    ug, fg = _grid(geo.n, 71, torch.bfloat16)
    want, _ = K.fused_jacobi_shard_torch(ug, fg, geo, h, 3, OMEGA, False, "cpu")
    ref = tile_partials(_terms(ug, fg, geo, h, 3, "cpu", False), geo)

    def matches(mutate):
        got, parts = wave_pass(ug, fg, geo, h, 3, "cpu", rows=64, mutate=mutate)
        return torch.equal(got, want) and torch.equal(parts[0], ref)

    assert matches(None)
    assert not matches(mutation), f"the {mutation} mutation went unseen"


def _chunk_copies(n, rows_n, gi, c0, cols, el, chunks):
    """wave2_pass's 16-byte chunk copies of the ``cols`` values of row gi from
    column c0 on, in a row-major rows_n × n grid whose first value starts a
    chunk (16-byte aligned): (the value offset m of column c0 in its chunk,
    the ring row, each slot the flat index of the value it holds or None for
    a zero fill). Chunk k copies from column c0 − m + el·k the values up to
    the row's last column, none from a row outside the grid."""
    m = (gi * n + c0) % el
    ring = [None] * (el * chunks)
    for k in range(chunks):
        cs = c0 - m + el * k
        start = gi * n + cs
        count = min(el, n - cs) if 0 <= gi < rows_n and cs + el > 0 and cs < n else 0
        assert start % el == 0, "a chunk's source is not 16-byte aligned"
        if count:
            assert 0 <= start and start + count <= rows_n * n, "a copy reads outside the grid"
        for v in range(count):
            ring[el * k + v] = start + v
    return m, ring


@pytest.mark.parametrize("el", [4, 8], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n", [257, 1031, 2049, 8193])
def test_chunk_plan_lands_every_staged_column(el, n):
    """fetch_row's plan (WaveShape CH = 160 / el + 1 chunks a ring row, lane
    x copying chunks x and x + 32): each staged column of a strip that lies
    in the grid lands at ring slot m + c, where the pass reads it; a chunk
    before column 0 or past the row's end copies nothing outside the grid.
    Rows of every offset class in a chunk (n = 2^k + 1 and 1031 step through
    all el of them), the first and last strips."""
    chunks = (TILE_W + 2 * PAD) // el + 1
    assert chunks <= 2 * LANES
    strips = -(-n // TILE_W)
    for gi in list(range(-2, 2 * el + 2)) + [n // 2, n - 2, n - 1, n]:
        for tx in (0, 1, strips - 1):
            c0 = tx * TILE_W - PAD
            m, ring = _chunk_copies(n, n, gi, c0, TILE_W + 2 * PAD, el, chunks)
            assert m < el
            for c in range(TILE_W + 2 * PAD):
                gj = c0 + c
                if 0 <= gi < n and 0 <= gj < n:
                    assert ring[m + c] == gi * n + gj, (gi, tx, c)
                elif not 0 <= gi < n:
                    assert ring[m + c] is None


@pytest.mark.parametrize("n", [257, 1031, 4097])
def test_bf16_coarse_row_plan(n):
    """The ascend leg's bf16 coarse rows (fetch_coarse): CCH = 96 / 8 + 1
    chunks from the one holding column j0 = gc0 / 2 of the m × m correction
    (at offset coffset, one of 8), the lanes reading ring slots coffset +
    (5x >> 1) + k, k < 4: every coarse column the strip's interior fine
    cells interpolate from lands there, and no copy leaves the grid."""
    m = (n + 1) // 2
    chunks = 96 // 8 + 1
    strips = -(-n // TILE_W)
    for ci in list(range(0, 18)) + [m // 2, m - 2, m - 1]:
        for tx in (0, 1, strips - 1):
            gc0 = tx * TILE_W - PAD
            j0 = gc0 >> 1
            off, ring = _chunk_copies(m, m, ci, j0, 96, 8, chunks)
            for lane in range(LANES):
                for k in range(4):
                    j = j0 + ((SLOTS * lane) >> 1) + k
                    slot = off + ((SLOTS * lane) >> 1) + k
                    assert slot < 8 * chunks
                    if 0 <= j < m:
                        assert ring[slot] == ci * m + j, (ci, tx, lane, k)
