"""The chains' cluster tail (csrc/chain_tail.cuh, chain_descend.cu,
chain_ascend.cu), emulated in plain PyTorch on the CPU.

Nothing compiles the CUDA sources here, so these tests hold the schedule the
tail kernels follow against the plain twins the card's checks hold the
kernels to (chip_smoke.py phase 2, on every split):

  * the cluster, mirrored below: TAIL_CTAS blocks, block q owning the rows
    [n·q // 8, n·(q + 1) // 8) of every level-n array in slots of its shared
    memory (NaN until written), or block 0 every row for n <= TAIL_SOLO,
    whose barriers are then block 0's own. A block reads its own slots as
    they stand and another block's as they stood at the last cluster
    barrier; what it stores into another block's slot lands at the next
    one. So a read the kernel makes before the barrier that orders it sees
    NaN or a stale value here;
  * descend (levels first .. c − 1): from zero, the first sweep after the
    closed-form one forms u_1 = zero_coef·f at its reads (f's band and the
    rows next to it, complete since the level began; the closed form is
    stored only when it is the level's only sweep); a barrier before every
    later sweep (the rows above and below the band from the neighbours'
    slots), a barrier, the band's u stored, −r of
    the final iterate into the spare slot, a barrier with full weighting,
    then coarse row I formed by the block that owns fine row 2I and stored
    into the slot of the block that owns row I at the next level, and a
    barrier. The emulated u and f of every level equal
    ``chain_descend_torch``'s bit for bit, for 1-8 sweeps a level, both
    restrictions, entry_from_zero both ways, ladders from 257², 129², 65²,
    33² and 5² (8 blocks for 5 rows: empty bands);
  * ascend (levels c − 1 .. first): u plus the prolongation of the coarse
    rows read from the slots that hold them (the block below's result), a
    barrier before every sweep, the band stored, a barrier; for 0-8 sweeps
    a level the result equals ``chain_ascend_torch``'s bit for bit;
  * level 0's error in the tail: the partial of each 32 x 128 tile of the
    level formed by a group of 256 threads in error_partial's order (thread
    (x, y): rows y + 8m, columns x + 32q, float32 adds in sequence; the
    warp butterflies; the sum over the eight warp sums), read through the
    cluster, then fixed_sum, equals the same sums over the whole arrays in
    legs.cuh's tile order bit for bit (the chain's error equals a per-level
    ``fused_ascend`` launch's), and the twin's error within 1e-4, for the
    cpu, clean and gpu metrics;
  * the twins against JAX's ``fused_chain_descend`` / ``fused_chain_ascend``
    (interpret mode) within tests/test_torch_kernels.py's tolerances, on the
    ladders the tail takes;
  * the split rule (``chain_split`` below, chain_split_level's mirror)
    against ``chain_fits``' ladders and the constants of csrc/chain_tail.cuh;
  * the checks above see a wrong schedule: a band that reads no row above
    it (a halo one row short), a missing barrier before a sweep (a
    neighbour's rows of the sweep before), no barrier between the first
    level's load and its first sweep, and coarse row I formed from fine row
    2I + 1 each fail them.

The emulation is test code: the kernels' own schedule lives in the CUDA
sources.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_poisson_solver_tpu.ops import layout
from multigrid_poisson_solver_tpu.ops import pallas_chain as pc
from multigrid_poisson_solver_tpu_torch.ops import build
from multigrid_poisson_solver_tpu_torch.ops import kernels as K

Q = 8               # TAIL_CTAS: the cluster's blocks
CHAIN_SPLIT = 257   # the split size S: levels n <= S run in the tail
TAIL_SOLO = 65      # levels n <= TAIL_SOLO run in block 0 alone
TAIL_SMEM_LIMIT = 232448 - 1024   # a tail block's dynamic shared memory, bytes
TILE_H, TILE_W, BLOCK_X, BLOCK_Y = 32, 128, 32, 8
THREADS = BLOCK_X * BLOCK_Y
GROUPS = 1024 // THREADS
NAN = float("nan")
OMEGA = 0.8
U_RTOL = 1e-5
ERR_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulations run many small tensor ops: one intra-op thread each,
    as several test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ladder(n0, n_min=9):
    sizes = [n0]
    while sizes[-1] > n_min:
        sizes.append((sizes[-1] + 1) // 2)
    return tuple(sizes)


def _grid(rng, n):
    return torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))


def solo(n):
    """Whether block 0 runs level n alone (TAIL_SOLO)."""
    return n <= TAIL_SOLO


def band_lo(n, q):
    return (n if q > 0 else 0) if solo(n) else n * q // Q


def band_owner(n, gi):
    return 0 if solo(n) else (Q * (gi + 1) + n - 1) // n - 1


def _slot_floats(sizes):
    return max((n if solo(n) else -(-n // Q)) * n for n in sizes)


class Cluster:
    """The tail's shared memory: ``slots`` band slots of ``floats`` floats a
    block. Reads of another block's slot see it as of the last barrier;
    stores into another block's slot land at the next one."""

    def __init__(self, slots, floats):
        self.mem = [[torch.full((floats,), NAN) for _ in range(slots)] for _ in range(Q)]
        self.pending = []
        self.seen = None
        self.sync()

    def sync(self):
        for q, s, off, vals in self.pending:
            self.mem[q][s][off:off + vals.numel()] = vals
        self.pending = []
        self.seen = [[t.clone() for t in blk] for blk in self.mem]

    def band(self, q, s, n):
        rows = band_lo(n, q + 1) - band_lo(n, q)
        return self.mem[q][s][:rows * n].view(rows, n)

    def row(self, q, s, n, gi):
        """Row gi of slot s as block q reads it."""
        r = band_owner(n, gi)
        off = (gi - band_lo(n, r)) * n
        return (self.mem if r == q else self.seen)[r][s][off:off + n]

    def put_row(self, q, s, n, gi, vals):
        """Block q stores row gi of a level-n slot into the block owning it."""
        r = band_owner(n, gi)
        off = (gi - band_lo(n, r)) * n
        if r == q:
            self.mem[q][s][off:off + n] = vals
        else:
            self.pending.append((r, s, off, vals.clone()))


def _rows_mask(lo, rows, n):
    gi = torch.arange(lo, lo + rows)
    return (gi >= 1) & (gi <= n - 2)


def _edges(cl, q, s, n, lo, rows, mutate=None):
    nan = torch.full((n,), NAN)
    above = cl.row(q, s, n, lo - 1) if lo > 0 else nan
    below = cl.row(q, s, n, lo + rows) if lo + rows < n else nan
    if mutate == "halo_short":
        above = nan
    return above, below


def _nb(ext, src):
    """((N + S) + W) + E on the band's interior columns (stencils._nb_sum)."""
    return ext[:-2, 1:-1] + ext[2:, 1:-1] + src[:, :-2] + src[:, 2:]


def _closed_form(f, lo, n, h):
    """u_1 = zero_coef·f on the interior cells of rows lo.. of f, 0
    elsewhere (the closed-form first sweep from u ≡ 0)."""
    u1 = torch.zeros_like(f)
    u1[:, 1:-1] = torch.where(_rows_mask(lo, f.shape[0], n)[:, None],
                              K._zero_coef(h, OMEGA) * f[:, 1:-1], torch.zeros(()))
    return u1


def _sweep_rows(ext, sf, dst, lo, n, h, mutate=None):
    """One sweep of the band from ext (its rows with one more above and
    below) into dst."""
    if mutate == "halo_short":
        ext = ext.clone()
        ext[0] = NAN
    src = ext[1:-1]
    h2 = h * h
    incr = 0.25 * (_nb(ext, src) - 4.0 * src[:, 1:-1] - h2 * sf[:, 1:-1])
    out = src.clone()
    out[:, 1:-1] = torch.where(_rows_mask(lo, src.shape[0], n)[:, None],
                               src[:, 1:-1] + OMEGA * incr, src[:, 1:-1])
    dst.copy_(out)


def _sweep(cl, q, src_s, dst_s, f_s, n, h, mutate=None):
    lo, rows = band_lo(n, q), band_lo(n, q + 1) - band_lo(n, q)
    if rows == 0:
        return
    above, below = _edges(cl, q, src_s, n, lo, rows)
    ext = torch.cat([above[None], cl.band(q, src_s, n), below[None]])
    _sweep_rows(ext, cl.band(q, f_s, n), cl.band(q, dst_s, n), lo, n, h, mutate)


def descend_tail(f_first, u0, sizes, first, h0, pre_steps, restriction, entry_from_zero,
                 mutate=None):
    """chain_descend_tail: levels first .. c − 1; returns {k: u_k}, {k: f_k}."""
    c = len(sizes) - 1
    n = sizes[first]
    cl = Cluster(4, _slot_floats(sizes[first:]))
    us, fs = {}, {}
    for q in range(Q):
        lo, hi = band_lo(n, q), band_lo(n, q + 1)
        cl.band(q, 0, n).copy_(f_first[lo:hi])
        if not (first > 0 or entry_from_zero):
            cl.band(q, 2, n).copy_(u0[lo:hi])
    if not solo(n) and mutate != "no_first_barrier":
        cl.sync()   # the first sweep reads the neighbours' rows of f (or u)
    cur = 0
    for k in range(first, c):
        n, m = sizes[k], sizes[k + 1]
        h = h0 * 2 ** k
        fz = k > 0 or entry_from_zero
        ns = pre_steps[k] - (1 if fz else 0)
        multi = not solo(n)
        if fz:
            # the closed-form first sweep: stored only when it is the last,
            # else formed from f (the band's and the rows next to it) by the
            # next sweep, with no barrier before it
            for q in range(Q):
                lo, rows = band_lo(n, q), band_lo(n, q + 1) - band_lo(n, q)
                if rows == 0:
                    continue
                if ns == 0:
                    cl.band(q, 2, n).copy_(_closed_form(cl.band(q, cur, n), lo, n, h))
                    continue
                above, below = _edges(cl, q, cur, n, lo, rows)
                ext = torch.cat([above[None], cl.band(q, cur, n), below[None]])
                _sweep_rows(_closed_form(ext, lo - 1, n, h), cl.band(q, cur, n),
                            cl.band(q, 3, n), lo, n, h,
                            mutate if mutate == "halo_short" else None)
        for s in range(2 if fz else 1, ns + 1):
            if multi and not (mutate == "no_barrier" and s == 2):
                cl.sync()
            for q in range(Q):
                _sweep(cl, q, 2 + (s - 1) % 2, 2 + s % 2, cur, n, h,
                       mutate if mutate == "halo_short" else None)
        fin_s, d_s = 2 + ns % 2, 2 + (ns + 1) % 2
        if multi:
            cl.sync()
        us[k] = torch.full((n, n), NAN)
        for q in range(Q):
            lo, rows = band_lo(n, q), band_lo(n, q + 1) - band_lo(n, q)
            if rows == 0:
                continue
            fin, sf = cl.band(q, fin_s, n), cl.band(q, cur, n)
            us[k][lo:lo + rows] = fin
            above, below = _edges(cl, q, fin_s, n, lo, rows)
            ext = torch.cat([above[None], fin, below[None]])
            r = (1.0 / (h * h)) * (_nb(ext, fin) - 4.0 * fin[:, 1:-1]) - sf[:, 1:-1]
            d = torch.zeros_like(fin)
            d[:, 1:-1] = torch.where(_rows_mask(lo, rows, n)[:, None], -r, torch.zeros(()))
            cl.band(q, d_s, n).copy_(d)
        if restriction == "full_weighting" and multi:
            cl.sync()
        fs[k + 1] = torch.full((m, m), NAN)
        for q in range(Q):
            lo, rows = band_lo(n, q), band_lo(n, q + 1) - band_lo(n, q)
            for ci in range((lo + 1) // 2, (lo + rows - 1) // 2 + 1 if rows else 0):
                fine = 2 * ci + (1 if mutate == "restrict_off" else 0)
                v = torch.zeros(m)
                if 1 <= ci <= m - 2:
                    d0 = cl.row(q, d_s, n, fine)
                    if restriction == "full_weighting":
                        sy = (0.25 * cl.row(q, d_s, n, fine - 1) + 0.5 * d0) \
                            + 0.25 * cl.row(q, d_s, n, fine + 1)
                        v[1:-1] = (0.25 * sy[1:n - 3:2] + 0.5 * sy[2:n - 2:2]) \
                            + 0.25 * sy[3:n - 1:2]
                    else:
                        v[1:-1] = d0[2:-2:2]
                cl.put_row(q, 1 - cur, m, ci, v)
                fs[k + 1][ci] = v
        if multi:
            cl.sync()
        cur ^= 1
    return us, fs


def _tile_order_sum(terms):
    """Per-tile partials of an array of error terms (0 where a cell is not
    counted) in error_partial + block_sum's order, as float32 adds: tensor
    (tiles_y, tiles_x)."""
    rows, cols = terms.shape
    ty, tx = -(-rows // TILE_H), -(-cols // TILE_W)
    t = torch.zeros(ty * TILE_H, tx * TILE_W)
    t[:rows, :cols] = terms
    t = t.view(ty, TILE_H // BLOCK_Y, BLOCK_Y, tx, TILE_W // BLOCK_X, BLOCK_X)
    acc = torch.zeros(ty, BLOCK_Y, tx, BLOCK_X)
    for mm in range(TILE_H // BLOCK_Y):          # rows y + 8m
        for qq in range(TILE_W // BLOCK_X):      # then columns x + 32q
            acc = acc + t[:, mm, :, :, qq, :]
    lanes = torch.arange(BLOCK_X)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ o]
    ws = torch.zeros(ty, tx, BLOCK_X)
    ws[..., :BLOCK_Y] = acc[..., 0].permute(0, 2, 1)
    for o in (16, 8, 4, 2, 1):
        ws = ws + ws[..., lanes ^ o]
    return ws[..., 0]


def _fixed_sum(partials):
    """fixed_sum over a flat float32 tensor (thread-strided, then block_sum)."""
    v = torch.zeros(THREADS)
    for i in range(0, partials.numel(), THREADS):
        chunk = partials[i:i + THREADS]
        v[:chunk.numel()] = v[:chunk.numel()] + chunk
    acc = v.view(BLOCK_Y, BLOCK_X)
    lanes = torch.arange(BLOCK_X)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lanes ^ o]
    ws = torch.zeros(BLOCK_X)
    ws[:BLOCK_Y] = acc[:, 0]
    for o in (16, 8, 4, 2, 1):
        ws = ws + ws[lanes ^ o]
    return ws[0]


def _error_terms(fin, prev, f, h, mode):
    """|r(fin)| (cpu: even cells only) or |fin − prev| on the interior, 0
    elsewhere, as error_partial forms each term."""
    n = fin.shape[0]
    terms = torch.zeros_like(fin)
    if mode == "gpu":
        t = (fin[1:-1, 1:-1] - prev[1:-1, 1:-1]).abs()
    else:
        nb = fin[:-2, 1:-1] + fin[2:, 1:-1] + fin[1:-1, :-2] + fin[1:-1, 2:]
        t = ((1.0 / (h * h)) * (nb - 4.0 * fin[1:-1, 1:-1]) - f[1:-1, 1:-1]).abs()
        if mode == "cpu":
            i = torch.arange(1, n - 1)
            t = torch.where((i[:, None] + i[None, :]) % 2 == 0, t, torch.zeros(()))
    terms[1:-1, 1:-1] = t
    return terms


def tail_error(cl, fin_s, prev_s, f_s, n, h, mode):
    """tail_error: each group's tile partial from cells read through the
    cluster (after the barrier), then fixed_sum; the unscaled total and the
    partials."""
    def whole(s):
        return torch.cat([cl.row(0, s, n, gi)[None] for gi in range(n)])

    # the cells a group reads, gathered through the cluster: the same
    # values whichever block holds them, once the barrier has passed
    terms = _error_terms(whole(fin_s), whole(prev_s), whole(f_s), h, mode)
    tiles = _tile_order_sum(terms).reshape(-1)
    partials = torch.full((tiles.numel(),), NAN)
    for q in range(Q):
        for g in range(GROUPS):
            for tile in range(q * GROUPS + g, tiles.numel(), Q * GROUPS):
                partials[tile] = tiles[tile]
    return _fixed_sum(partials), partials


def ascend_tail(u_list, f_list, uc, sizes, first, h0, post_steps, mode=None, mutate=None):
    """chain_ascend_tail: levels c − 1 .. first; returns {k: out_k} and level
    0's (unscaled error total, partials) when it runs there with a mode."""
    c = len(sizes) - 1
    cl = Cluster(4, _slot_floats(sizes[first:-1]))
    outs, err = {}, None
    child = -1
    for k in range(c - 1, first - 1, -1):
        n, m = sizes[k], sizes[k + 1]
        h = h0 * 2 ** k
        p0, p1 = (1 if child == 0 else 0), (1 if child == 2 else 2)
        bufs = (1 + p0, 1 + p1)
        for q in range(Q):
            lo, rows = band_lo(n, q), band_lo(n, q + 1) - band_lo(n, q)
            if rows == 0:
                continue
            cl.band(q, 0, n).copy_(f_list[k][lo:lo + rows])
            u = u_list[k][lo:lo + rows].clone()
            c_lo = lo // 2
            c_hi = min(m - 1, (lo + rows - 1) // 2 + 1)
            crow = torch.stack([uc[ci] if child < 0 else cl.row(q, 1 + child, m, ci)
                                for ci in range(c_lo, c_hi + 1)])
            wide = torch.empty(crow.shape[0], n)
            wide[:, ::2] = crow
            wide[:, 1::2] = 0.5 * crow[:, :-1] + 0.5 * crow[:, 1:]
            gi = torch.arange(lo, lo + rows)
            even = wide[gi // 2 - c_lo]
            odd = 0.5 * wide[(gi // 2 - c_lo).clamp(max=wide.shape[0] - 1)] \
                + 0.5 * wide[(gi // 2 + 1 - c_lo).clamp(max=wide.shape[0] - 1)]
            p = torch.where((gi % 2 == 1)[:, None], odd, even)
            u[:, 1:-1] = torch.where(_rows_mask(lo, rows, n)[:, None],
                                     u[:, 1:-1] + p[:, 1:-1], u[:, 1:-1])
            cl.band(q, bufs[0], n).copy_(u)
        multi = not solo(n)
        for s in range(1, post_steps[k] + 1):
            if multi and not (mutate == "no_barrier" and s == 2):
                cl.sync()
            for q in range(Q):
                _sweep(cl, q, bufs[(s - 1) % 2], bufs[s % 2], 0, n, h,
                       mutate if mutate == "halo_short" else None)
        fin = post_steps[k] % 2
        outs[k] = torch.full((n, n), NAN)
        for q in range(Q):
            lo, hi = band_lo(n, q), band_lo(n, q + 1)
            outs[k][lo:hi] = cl.band(q, bufs[fin], n)
        child = (p1 if fin else p0)
        if multi or (k == 0 and mode is not None) or (k > first and not solo(sizes[k - 1])):
            cl.sync()
        if k == 0 and mode is not None:
            err = tail_error(cl, bufs[fin], bufs[1 - fin], 0, n, h, mode)
    return outs, err


# --- descend ---------------------------------------------------------------------

DESCEND_CASES = [
    # ladder, steps a level, restriction, entry_from_zero
    (_ladder(257), (3,) * 5, "sampling", True),
    (_ladder(257), (1, 2, 3, 4, 5), "full_weighting", False),
    (_ladder(129), (8, 7, 6, 5), "sampling", False),
    (_ladder(129), (2,) * 4, "full_weighting", True),
    (_ladder(65, 3), (1, 8, 2, 7, 3), "full_weighting", True),
    (_ladder(65, 3), (4, 1, 6, 1, 8), "sampling", False),
    ((33, 17), (3,), "sampling", False),
    ((33, 17), (8,), "full_weighting", True),
    ((5, 3), (2,), "full_weighting", False),
    ((5, 3), (1,), "sampling", True),
]


@pytest.mark.parametrize("sizes,steps,restriction,fz", DESCEND_CASES)
def test_descend_tail_matches_twin(sizes, steps, restriction, fz):
    rng = np.random.default_rng(sizes[0] + sum(steps))
    u0, f0 = _grid(rng, sizes[0]), _grid(rng, sizes[0])
    h0 = 1.0 / (sizes[0] - 1)
    want_u, want_f = K.chain_descend_torch(u0, f0, sizes, h0, steps, OMEGA, restriction, fz)
    got_u, got_f = descend_tail(f0, u0, sizes, 0, h0, steps, restriction, fz)
    for k in range(len(steps)):
        assert torch.equal(got_u[k], want_u[k]), f"level {k} u"
        assert torch.equal(got_f[k + 1], want_f[k]), f"level {k + 1} f"


@pytest.mark.parametrize("split", [257, 129, 65])
def test_descend_tail_below_wide_levels(split):
    """A ladder from 1025² split at S: the twin's wide levels, then the tail
    from the f they formed, equal the twin's whole chain bit for bit."""
    rng = np.random.default_rng(split)
    sizes = _ladder(1025)
    f0 = _grid(rng, 1025)
    h0 = 1.0 / 1024
    steps = (3,) * (len(sizes) - 1)
    want_u, want_f = K.chain_descend_torch(None, f0, sizes, h0, steps, OMEGA, "sampling", True)
    first = chain_split(sizes, split)
    assert sizes[first] == split and sizes[first - 1] > split
    got_u, got_f = descend_tail(want_f[first - 1], None, sizes, first, h0, steps, "sampling",
                                True)
    for k in range(first, len(steps)):
        assert torch.equal(got_u[k], want_u[k]) and torch.equal(got_f[k + 1], want_f[k])


# --- ascend --------------------------------------------------------------------

ASCEND_CASES = [
    # ladder, post-steps a level, level 0's error metric (None: none)
    (_ladder(257), (3,) * 5, None),
    (_ladder(257), (1, 0, 2, 8, 3), "cpu"),
    (_ladder(129), (8, 0, 1, 2), "clean"),
    (_ladder(129), (2, 6, 7, 8), "gpu"),
    (_ladder(65, 3), (4, 5, 0, 1, 2), "cpu"),
    (_ladder(65, 3), (1,) * 5, "gpu"),
    ((33, 17), (3,), "clean"),
    ((33, 17), (0,), None),
    ((5, 3), (2,), "cpu"),
    ((5, 3), (1,), "gpu"),
]


def _ascend_inputs(rng, sizes):
    c = len(sizes) - 1
    u_list = [_grid(rng, s) for s in sizes[:-1]]
    f_list = [_grid(rng, s) for s in sizes[:-1]]
    uc = _grid(rng, sizes[-1])
    return u_list, f_list, uc


@pytest.mark.parametrize("sizes,steps,mode", ASCEND_CASES)
def test_ascend_tail_matches_twin(sizes, steps, mode):
    rng = np.random.default_rng(sizes[0] * 3 + sum(steps))
    u_list, f_list, uc = _ascend_inputs(rng, sizes)
    h0 = 1.0 / (sizes[0] - 1)
    compat = {"cpu": True, "clean": False, "gpu": "gpu", None: True}[mode]
    want_u, want_e = K.chain_ascend_torch(u_list, f_list, uc, sizes, h0, steps, OMEGA, compat,
                                          mode is not None)
    outs, err = ascend_tail(u_list, f_list, uc, sizes, 0, h0, steps, mode)
    assert torch.equal(outs[0], want_u)
    if mode is not None:
        n = sizes[0]
        scale = torch.tensor(K._err_scale(mode, n, h0), dtype=torch.float32)
        got = float(err[0] * scale)
        assert got == pytest.approx(float(want_e), rel=ERR_RTOL)


@pytest.mark.parametrize("split", [257, 129, 65])
def test_ascend_tail_below_wide_levels(split):
    """The tail's result at level S, under the twin's wide levels, gives
    the twin's whole chain bit for bit."""
    rng = np.random.default_rng(split + 1)
    sizes = _ladder(1025)
    u_list, f_list, uc = _ascend_inputs(rng, sizes)
    h0 = 1.0 / 1024
    steps = (3,) * (len(sizes) - 1)
    want, _ = K.chain_ascend_torch(u_list, f_list, uc, sizes, h0, steps, OMEGA)
    first = chain_split(sizes, split)
    outs, _ = ascend_tail(u_list, f_list, uc, sizes, first, h0, steps)
    got, _ = K.chain_ascend_torch(u_list[:first], f_list[:first], outs[first],
                                  sizes[:first + 1], h0, steps[:first], OMEGA)
    assert torch.equal(got, want)


# --- level 0's error: the tail's partials are legs.cuh's -----------------------

@pytest.mark.parametrize("n", [257, 129, 33])
@pytest.mark.parametrize("mode", ["cpu", "clean", "gpu"])
def test_tail_error_is_the_tile_routes(n, mode):
    """The tail's error of level 0, through the cluster, equals the tile
    route's per-tile partials and fixed_sum over the whole arrays bit for
    bit (what a per-level fused_ascend launch reports), and the twin's
    error within 1e-4 (torch.sum adds in another order)."""
    rng = np.random.default_rng(n + len(mode))
    sizes = (n, (n + 1) // 2)
    u_list, f_list, uc = _ascend_inputs(rng, sizes)
    h = 1.0 / (n - 1)
    outs, (total, partials) = ascend_tail(u_list, f_list, uc, sizes, 0, h, (2,), mode)
    # the tile route on the whole level: prev is the iterate one sweep back
    u1 = K.fused_ascend_torch(u_list[0], f_list[0], uc, h, 1, OMEGA)[0]
    assert torch.equal(K.fused_jacobi_torch(u1, f_list[0], h, 1, OMEGA), outs[0])
    tiles = _tile_order_sum(_error_terms(outs[0], u1, f_list[0], h, mode)).reshape(-1)
    assert torch.equal(partials, tiles)
    assert torch.equal(total, _fixed_sum(tiles))
    compat = {"cpu": True, "clean": False, "gpu": "gpu"}[mode]
    _, want = K.fused_ascend_torch(u_list[0], f_list[0], uc, h, 2, OMEGA, compat, True)
    scale = torch.tensor(K._err_scale(mode, n, h), dtype=torch.float32)
    assert float(total * scale) == pytest.approx(float(want), rel=ERR_RTOL)


def test_tile_order_sum_is_sequential_float32():
    """_tile_order_sum's adds in order, one thread and warp at a time, on a
    ragged 33 x 150 array whose terms make float32 rounding show."""
    rng = np.random.default_rng(5)
    terms = torch.from_numpy((rng.standard_normal((33, 150)) * 10.0 ** rng.integers(
        -6, 6, (33, 150))).astype(np.float32)).abs()
    got = _tile_order_sum(terms)
    pad = np.zeros((64, 256), np.float32)
    pad[:33, :150] = terms.numpy()
    for ty in range(2):
        for tx in range(2):
            tile = pad[ty * 32:(ty + 1) * 32, tx * 128:(tx + 1) * 128]
            lanes = np.zeros((8, 32), np.float32)
            for y in range(8):
                for x in range(32):
                    acc = np.float32(0)
                    for i in range(y, 32, 8):
                        for j in range(x, 128, 32):
                            acc = np.float32(acc + tile[i, j])
                    lanes[y, x] = acc
            for o in (16, 8, 4, 2, 1):
                lanes = (lanes + lanes[:, np.arange(32) ^ o]).astype(np.float32)
            ws = np.zeros(32, np.float32)
            ws[:8] = lanes[:, 0]
            for o in (16, 8, 4, 2, 1):
                ws = (ws + ws[np.arange(32) ^ o]).astype(np.float32)
            assert got[ty, tx].item() == ws[0]


# --- mutations -------------------------------------------------------------------

@pytest.mark.parametrize("leg,mutation", [
    ("descend", "halo_short"), ("descend", "no_barrier"), ("descend", "restrict_off"),
    ("descend", "no_first_barrier"), ("ascend", "halo_short"), ("ascend", "no_barrier")])
def test_mutated_schedule_fails(leg, mutation):
    """Each mutation alone makes the emulation differ from the twin (with
    the entry from zero, so the first sweep reads the neighbours' f rows
    right after the load)."""
    sizes, steps = _ladder(257), (3,) * 5
    rng = np.random.default_rng(11)
    h0 = 1.0 / 256
    if leg == "descend":
        u0, f0 = _grid(rng, 257), _grid(rng, 257)
        want_u, want_f = K.chain_descend_torch(u0, f0, sizes, h0, steps, OMEGA, "sampling",
                                               True)
        got_u, got_f = descend_tail(f0, u0, sizes, 0, h0, steps, "sampling", True, mutation)
        same = all(torch.equal(got_u[k], want_u[k]) and torch.equal(got_f[k + 1], want_f[k])
                   for k in range(len(steps)))
    else:
        u_list, f_list, uc = _ascend_inputs(rng, sizes)
        want, _ = K.chain_ascend_torch(u_list, f_list, uc, sizes, h0, steps, OMEGA)
        outs, _ = ascend_tail(u_list, f_list, uc, sizes, 0, h0, steps, None, mutation)
        same = torch.equal(outs[0], want)
    assert not same, f"the {mutation} mutation went unseen"


# --- the twins on the tail's ladders against JAX -------------------------------------

def _jx(a):
    return layout.pad_grid(jnp.asarray(a.numpy()))


def _unpad(x, n):
    return np.asarray(x)[:n, :n]


@pytest.mark.parametrize("restriction,fz", [("sampling", True), ("full_weighting", False)])
def test_descend_twin_matches_pallas_129(restriction, fz):
    sizes, steps = _ladder(129), (3, 2, 4, 1)
    rng = np.random.default_rng(21)
    u0, f0 = _grid(rng, 129), _grid(rng, 129)
    h0 = 1.0 / 128
    want_u, want_f = pc.fused_chain_descend(_jx(u0), _jx(f0), sizes, h0, steps, OMEGA,
                                            restriction=restriction, entry_from_zero=fz,
                                            interpret=True)
    got_u, got_f = descend_tail(f0, u0, sizes, 0, h0, steps, restriction, fz)
    for k in range(len(steps)):
        wu = _unpad(want_u[k], sizes[k])
        np.testing.assert_allclose(got_u[k].numpy(), wu, rtol=0,
                                   atol=U_RTOL * float(np.abs(wu).max()))
        wf = _unpad(want_f[k], sizes[k + 1])
        np.testing.assert_allclose(got_f[k + 1].numpy(), wf, rtol=0,
                                   atol=2e-6 * (k + 1) * (float(np.abs(wf).max()) + 1))


@pytest.mark.parametrize("compat", [True, False])
def test_ascend_twin_matches_pallas_65(compat):
    sizes, steps = _ladder(65), (3, 0, 2)
    rng = np.random.default_rng(22)
    u_list, f_list, _ = _ascend_inputs(rng, sizes)
    uc = torch.zeros(9, 9)
    uc[1:-1, 1:-1] = torch.from_numpy(rng.standard_normal((7, 7)).astype(np.float32))
    h0 = 1.0 / 64
    want_u, want_e = pc.fused_chain_ascend([_jx(u) for u in u_list], [_jx(f) for f in f_list],
                                           _jx(uc), sizes, h0, steps, OMEGA, interpret=True,
                                           compat=compat)
    mode = "cpu" if compat else "clean"
    outs, (total, _) = ascend_tail(u_list, f_list, uc, sizes, 0, h0, steps, mode)
    wu = _unpad(want_u, 65)
    np.testing.assert_allclose(outs[0].numpy(), wu, rtol=0,
                               atol=U_RTOL * float(np.abs(wu).max()))
    err = float(total * torch.tensor(K._err_scale(mode, 65, h0), dtype=torch.float32))
    assert err == pytest.approx(float(np.asarray(want_e).reshape(-1)[0]), rel=ERR_RTOL)


# --- the split rule --------------------------------------------------------------------

def chain_tail_fits(n):
    """Whether a chain level of size n, and so every smaller one, fits the
    cluster: four slots of a band of ceil(n / Q) rows a block, or of the
    whole level for n <= TAIL_SOLO (tail_smem_bytes)."""
    rows = n if solo(n) else -(-n // Q)
    return 4 * 4 * rows * n <= TAIL_SMEM_LIMIT


def chain_split(sizes, split=CHAIN_SPLIT):
    """chain_split_level's rule: the first level of the ladder at or below
    ``split`` (``len(sizes) - 1`` when every level is wide); raises where
    that level does not fit the cluster (the C entry points fail)."""
    k = 0
    while k < len(sizes) - 1 and sizes[k] > split:
        k += 1
    if k < len(sizes) - 1 and not chain_tail_fits(sizes[k]):
        raise ValueError(f"chain split {split}: level {sizes[k]}² does not fit the cluster")
    return k


def _tail_source():
    return (Path(build.CSRC) / "chain_tail.cuh").read_text()


def test_split_constants_match_the_source():
    src = _tail_source()
    assert int(re.search(r"constexpr int CHAIN_SPLIT = (\d+);", src).group(1)) == CHAIN_SPLIT
    assert int(re.search(r"constexpr int TAIL_CTAS = (\d+);", src).group(1)) == Q
    assert int(re.search(r"constexpr int TAIL_SOLO = (\d+);", src).group(1)) == TAIL_SOLO
    assert re.search(r"constexpr int TAIL_SMEM_LIMIT = 232448 - 1024;", src)
    assert re.search(r"constexpr int TAIL_SLOTS = 4;", src)


@pytest.mark.parametrize("split", [CHAIN_SPLIT, 257, 129, 65, 0])
def test_split_rule_on_chain_fits_ladders(split):
    """Every ladder chain_fits admits splits into wide levels above S and a
    tail at or below it that fits the cluster; a ladder wholly at or below
    S is a tail alone, one wholly above it wide alone."""
    seen = 0
    for n0 in (1025, 513, 257, 129, 65, 33, 17, 9, 5, 3):
        for n_min in (2, 3, 5, 9, 17, 65, 129, 257):
            sizes = _ladder(n0, n_min)
            if not K.chain_fits(sizes):
                continue
            seen += 1
            first = chain_split(sizes, split)
            assert all(s > split for s in sizes[:first])
            assert first == len(sizes) - 1 or sizes[first] <= split
            if first < len(sizes) - 1:
                assert chain_tail_fits(sizes[first])
    assert seen > 20
    assert chain_split((257, 129, 65, 33, 17, 9), 257) == 0
    assert chain_split((33, 17), 257) == 0
    assert chain_split((1025, 513), 257) == 1
    assert chain_split(_ladder(1025), 0) == len(_ladder(1025)) - 1


def test_split_above_the_cluster_is_refused():
    assert chain_tail_fits(257) and not chain_tail_fits(513)
    with pytest.raises(ValueError, match="does not fit"):
        chain_split(_ladder(1025), 513)
