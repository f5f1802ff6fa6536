"""The ring smoother 18's wavefront route (csrc/rdma_jacobi.cu,
rdma_jacobi_wave_kernel) and kernel 2's batched shard mode
(csrc/residual.cu, residual_shards_kernel), emulated in plain PyTorch on
the CPU.

Nothing compiles the CUDA sources here, so these tests hold the kernels'
schedules against the twins the card's checks hold the kernels to
(chip_smoke.py G1):

  * kernel 18's wavefront route, shard by shard: every shard posts the
    first and last H = steps − from_zero rows of f (and of u, unless from
    zero) into its neighbours' receive slots of the launch's parity (tag &
    1), then runs the wavefront pass of tests/test_torch_wave2.py over its
    block with H halo rows a side read from its own receive slots of that
    parity; slots never posted and rows beyond the grid NaN, and the slots
    of the other parity hold an earlier launch's posts of other data. The
    owned cells equal ``rdma_jacobi_torch`` (the exchange path on the twins)
    bit for bit for 1-8 steps, from zero and not, on rings of 2, 3 and 8
    shards with a ragged last shard and shards of exactly ``steps`` rows;
  * the schedule's waits: a warp waits for a neighbour's post before each
    unit (in wave2_pass's order) whose rows, with the H halo rows and the D
    rows loaded ahead, reach that neighbour's receive slots, and only
    there;
  * the checks see a wrong schedule: a post a row short, or reads from the
    slots of the other parity, change the result;
  * the route rule: the wavefront from ``RING_WAVE_CELLS`` cells a launch
    (the constant read from the source), the tile pipeline below, a forced
    route either way;
  * kernel 2's batched shard mode: the flat block index walked to (shard,
    tile) by the shards' tile offsets as the kernel does, each tile's
    residual formed from its staged window, equals ``residual_shard_torch``
    of every shard bit for bit on row layouts (ragged last shards) and 2 x 4
    blocks, every tile written once; the batched twin through
    ``sharded_residual`` against JAX's ``sharded_residual_pallas`` in
    interpret mode on the 8-device CPU mesh.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from multigrid_poisson_solver_tpu.parallel import pallas_shard as jps
from multigrid_poisson_solver_tpu.parallel.mesh import (
    BlockShardingPolicy as JBlock,
    ShardingPolicy as JRows,
    make_mesh as jmake_mesh,
    make_mesh_2d as jmake_mesh_2d,
)
from multigrid_poisson_solver_tpu_torch.convert import policy_from_jax, sharded_from_jax
from multigrid_poisson_solver_tpu_torch.ops import build
from multigrid_poisson_solver_tpu_torch.ops import kernels as K
from multigrid_poisson_solver_tpu_torch.ops import rdma
from multigrid_poisson_solver_tpu_torch.parallel import kernel_shard as KS
from multigrid_poisson_solver_tpu_torch.parallel import sharded as S
from test_torch_wave2 import NAN, OMEGA, wave_pass, wave_shape

N = 131
RING_HALO = rdma.RING_HALO
TILE_H, TILE_W = 32, 128


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _layouts(steps):
    """Row bounds of the rings: 2 shards (a ragged last one), 3 with a
    middle shard of exactly ``steps`` rows, 8 (16 rows each, the last 19),
    and 3 with a first shard of exactly ``steps`` rows."""
    return {"2": (0, 64, N), "3-mid": (0, 61, 61 + steps, N),
            "8": tuple(r for r, _ in S.split_bounds(N, 8)) + (N,),
            "3-first": (0, steps, 70, N)}


def _uf(seed, n=N):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)))


def _ring(bounds):
    return S.Layout(N, tuple(zip(bounds[:-1], bounds[1:])), ((0, N),),
                    tuple((torch.device("cpu"),) for _ in bounds[1:]))


class Workspace:
    """The receive slots of a ring (csrc/rdma.cuh): per shard, parity, side
    (0 from the shard above, 1 from the shard below) and array (0 u, 1 f),
    RING_HALO rows; NaN until posted. Tags only grow."""

    def __init__(self, shards):
        self.slots = {(s, par, side, arr): torch.full((RING_HALO, N), NAN)
                      for s in range(shards) for par in (0, 1) for side in (0, 1)
                      for arr in (0, 1)}
        self.tag = 1

    def take(self):
        self.tag += 1
        return self.tag - 1


def ring_jacobi_wave(u, f, bounds, h, steps, from_zero, ws, rows=32, mutate=None):
    """rdma_jacobi_wave_kernel's launch, shard by shard: the posts, then
    each shard's wavefront pass over its block and its receive slots of the
    launch's parity. ``mutate``: "short" (a post one row short) or "parity"
    (reads from the other parity's slots)."""
    P, k = len(bounds) - 1, steps - from_zero
    par = ws.take() & 1
    blk = [(u[a:b], f[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
    cut = k - (mutate == "short")
    for s, (ub, fb) in enumerate(blk):
        for arr, x in ((1, fb),) + (() if from_zero else ((0, ub),)):
            if k == 0:
                break
            if s > 0:      # its first rows to the shard above, side 1, from the slot's start
                ws.slots[s - 1, par, 1, arr][:cut] = x[:cut]
            if s + 1 < P:  # its last rows to the shard below, side 0, ending at the slot's end
                ws.slots[s + 1, par, 0, arr][RING_HALO - cut:] = x[len(x) - cut:]
    rpar = par ^ (mutate == "parity")
    out = []
    for s, (ub, fb) in enumerate(blk):
        def window(x, arr):
            top = ws.slots[s, rpar, 0, arr][RING_HALO - k:]
            bot = ws.slots[s, rpar, 1, arr][:k]
            return torch.cat([top, x, bot])

        geo = K.ShardGeo(N, bounds[s], 0, bounds[s + 1] - bounds[s], N, k, 0)
        got, _ = wave_pass(None if from_zero else window(ub, 0), window(fb, 1), geo, h, steps,
                           from_zero=from_zero, rows=rows)
        out.append(got)
    return torch.cat(out)


def _twin(u, f, bounds, h, steps, from_zero):
    lay = _ring(bounds)
    return S.gather(rdma.rdma_jacobi_torch(S.shard(u, lay), S.shard(f, lay), h, steps, OMEGA,
                                           from_zero))


@pytest.mark.parametrize("from_zero", [False, True])
@pytest.mark.parametrize("steps", range(1, 9))
def test_wave_route_matches_twin(steps, from_zero):
    """Every ring, two launches on one workspace (the second's other-parity
    slots hold the first's posts of other data), chunks of 32 and 64 rows:
    bit for bit the exchange path on the twins."""
    h = 1.0 / (N - 1)
    u0, f0 = _uf(300 + steps)
    u, f = _uf(400 + 2 * steps + from_zero)
    for i, (name, bounds) in enumerate(_layouts(steps).items()):
        ws = Workspace(len(bounds) - 1)
        ring_jacobi_wave(u0, f0, bounds, h, steps, from_zero, ws)
        got = ring_jacobi_wave(u, f, bounds, h, steps, from_zero, ws, rows=32 * (1 + i % 2))
        want = _twin(u, f, bounds, h, steps, from_zero)
        assert torch.equal(got, want), f"{name}: steps={steps} from_zero={from_zero}"


@pytest.mark.parametrize("mutation", ["short", "parity"])
@pytest.mark.parametrize("steps,from_zero", [(3, False), (8, True)])
def test_mutated_ring_fails(mutation, steps, from_zero):
    """A post one row short, or reads from the slots of the other parity
    (which hold the launch before's posts), change the owned cells; the
    launch unmutated matches."""
    h = 1.0 / (N - 1)
    bounds = _layouts(steps)["8"]
    u0, f0 = _uf(7)
    u, f = _uf(8)
    want = _twin(u, f, bounds, h, steps, from_zero)

    def run(mutate):
        ws = Workspace(len(bounds) - 1)
        ring_jacobi_wave(u0, f0, bounds, h, steps, from_zero, ws)
        return ring_jacobi_wave(u, f, bounds, h, steps, from_zero, ws, mutate=mutate)

    assert torch.equal(run(None), want)
    got = run(mutation)
    assert not torch.equal(got, want), f"the {mutation} mutation went unseen"


def ring18_ahead(k):
    """The rows the wavefront route loads ahead: RING18_AHEAD from the
    source, or wave2.cuh's rule where it is 0."""
    src = (build.CSRC / "rdma_jacobi.cu").read_text()
    ahead = int(re.search(r"RING18_AHEAD = (\d+);", src).group(1))
    return ahead or wave_shape(k, None)[1]


def unit_waits(s, shards, rows, chunk, steps, from_zero):
    """rdma_jacobi_wave_kernel's ``unit``: for each unit in wave2_pass's
    order (tile strip w mod the strips, chunk w / strips), which neighbours
    a warp waits for before it: chunk 0 the top's, from ``cb`` the bottom's."""
    k = steps - from_zero
    H, D = k, ring18_ahead(k)
    strips, chunks = -(-N // TILE_W), -(-rows // chunk)
    past = rows - H - D
    cb = (0 if past < 0 else past // chunk) if s + 1 < shards else chunks
    return [(H > 0 and s > 0 and w // strips == 0, H > 0 and w // strips >= cb)
            for w in range(strips * chunks)]


@pytest.mark.parametrize("steps,from_zero", [(1, True), (2, False), (3, True), (8, False)])
def test_units_wait_for_the_slots_they_read(steps, from_zero):
    """A warp waits for a neighbour's post before a unit exactly where that
    unit's fetched rows (its chunk with H halo rows a side and the D rows
    loaded ahead, cut to the window) reach that neighbour's receive slot."""
    k = steps - from_zero
    H, D = k, ring18_ahead(k)
    strips = -(-N // TILE_W)
    for bounds in _layouts(steps).values():
        P = len(bounds) - 1
        for s in range(P):
            rows = bounds[s + 1] - bounds[s]
            for chunk in (32, 64, 96):
                for w, waits in enumerate(unit_waits(s, P, rows, chunk, steps, from_zero)):
                    a = w // strips * chunk
                    b = min(a + chunk, rows)
                    lo, hi = max(a - H, -H), min(b + H + D - 1, rows + H - 1)
                    assert waits == (s > 0 and lo < 0, s + 1 < P and hi >= rows), (bounds, s, w)


def _wave_cells():
    src = (build.CSRC / "rdma_jacobi.cu").read_text()
    assert "return forced_route ? forced_route == 2 : (long long)n * n >= RING_WAVE_CELLS;" in src
    return int(re.search(r"RING_WAVE_CELLS = (\d+);", src).group(1))


def takes_wave(n, forced=None):
    """mg_rdma_jacobi's route: a forced one, else the wavefront from n² >=
    RING_WAVE_CELLS."""
    return forced == "wave" if forced else n * n >= _wave_cells()


def test_route_rule():
    """From 1.5 M cells a launch the wavefront: 4097² and 2049² on it, 1025²
    and G2's 1024² below it on the tile pipeline; a forced route either
    way at any size. The rule's constant is the source's."""
    assert _wave_cells() == 1_500_000
    assert [takes_wave(n) for n in (4097, 2049, 2048, 1225, 1224, 1025, 1024, 513, 129)] == \
        [True, True, True, True, False, False, False, False, False]
    for n in (4097, 129):
        assert takes_wave(n, "wave") and not takes_wave(n, "tile")
    assert set(rdma._JACOBI_ROUTES) == {"tile", "wave"}


# --- kernel 2's batched shard mode ----------------------------------------------------------------

def _geos(kind, n, ext=1):
    if kind == "rows-8":
        rows, cols = S.split_bounds(n, 8), ((0, n),)
    elif kind == "rows-3":
        rows, cols = ((0, 40), (40, 150), (150, n)), ((0, n),)
    else:
        rows, cols = S.split_bounds(n, 2), S.split_bounds(n, 4)
    ec = ext if len(cols) > 1 else 0
    return [K.ShardGeo(n, r0, c0, r1 - r0, c1 - c0, ext, ec) for r0, r1 in rows for c0, c1 in cols]


def _window(x, g):
    pad = max(g.ext_r, g.ext_c)
    xp = torch.nn.functional.pad(x, (pad, pad, pad, pad))
    r0, c0 = g.row0 - g.ext_r + pad, g.col0 - g.ext_c + pad
    return xp[r0:r0 + g.rows + 2 * g.ext_r, c0:c0 + g.cols + 2 * g.ext_c].contiguous()


def residual_shards_emulated(u_exts, f_exts, geos, h, negate):
    """residual_shards_kernel over every flat block: the shard found by a
    scan of the tile offsets, the tile (t mod tiles_x, t / tiles_x) staged
    with a one-cell halo from its window (0 outside it and the grid), the
    residual in residual_point's order on its owned interior cells. Returns
    the blocks and how often each (shard, tile) ran."""
    tiles = [-(-g.rows // TILE_H) * -(-g.cols // TILE_W) for g in geos]
    tile0 = list(np.cumsum([0] + tiles))
    out = [torch.full((g.rows, g.cols), NAN) for g in geos]
    runs = {}
    inv_h2 = np.float32(1.0 / (h * h))
    for b in range(tile0[-1]):
        s = 0
        while b >= tile0[s + 1]:
            s += 1
        g = geos[s]
        t, tx_n = b - tile0[s], -(-g.cols // TILE_W)
        tx, ty = t % tx_n, t // tx_n
        runs[s, tx, ty] = runs.get((s, tx, ty), 0) + 1
        gr0, gc0 = g.row0 + ty * TILE_H - 1, g.col0 + tx * TILE_W - 1
        gi = torch.arange(gr0, gr0 + TILE_H + 2)
        gj = torch.arange(gc0, gc0 + TILE_W + 2)
        wr, wc = gi - (g.row0 - g.ext_r), gj - (g.col0 - g.ext_c)
        ok_r = (gi >= 0) & (gi < g.n) & (wr >= 0) & (wr < u_exts[s].shape[0])
        ok_c = (gj >= 0) & (gj < g.n) & (wc >= 0) & (wc < u_exts[s].shape[1])
        win = u_exts[s][wr.clamp(0, u_exts[s].shape[0] - 1)][:, wc.clamp(0, u_exts[s].shape[1] - 1)]
        sm = torch.where(ok_r[:, None] & ok_c[None, :], win, torch.zeros(()))
        fv = f_exts[s][wr[1:-1].clamp(0, f_exts[s].shape[0] - 1)][
            :, wc[1:-1].clamp(0, f_exts[s].shape[1] - 1)]
        nb = ((sm[:-2, 1:-1] + sm[2:, 1:-1]) + sm[1:-1, :-2]) + sm[1:-1, 2:]
        v = inv_h2 * (nb - 4.0 * sm[1:-1, 1:-1]) - fv
        ci, cj = gi[1:-1], gj[1:-1]
        inside = ((ci >= 1) & (ci <= g.n - 2))[:, None] & ((cj >= 1) & (cj <= g.n - 2))[None, :]
        v = torch.where(inside, -v if negate else v, torch.zeros(()))
        own_r = (ci >= g.row0) & (ci < g.row0 + g.rows)
        own_c = (cj >= g.col0) & (cj < g.col0 + g.cols)
        li, lj = ci[own_r] - g.row0, cj[own_c] - g.col0
        out[s][li[:, None], lj[None, :]] = v[own_r][:, own_c]
    return out, runs, tiles


@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("kind,n", [("rows-8", 257), ("rows-3", 259), ("blocks-2x4", 257),
                                    ("blocks-2x4", 259)])
def test_batched_residual_block_map(kind, n, negate):
    """Every (shard, tile) runs once and every owned cell comes out bit for
    bit ``residual_shard_torch``'s: 8 row shards, 3 ragged ones, 2 x 4
    blocks (one halo row and column) at 257² and 259²."""
    h = 1.0 / (n - 1)
    u, f = _uf(500 + n, n)
    geos = _geos(kind, n)
    ues, fes = [_window(u, g) for g in geos], [_window(f, g) for g in geos]
    got, runs, tiles = residual_shards_emulated(ues, fes, geos, h, negate)
    assert len(runs) == sum(tiles) and set(runs.values()) == {1}
    want = K.residual_shards(ues, fes, geos, h, negate)
    assert len(want) == len(geos)
    for s, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"{kind} {n}: shard {s} differs"
        assert torch.equal(w, K.residual_shard_torch(ues[s], fes[s], geos[s], h, negate))


def test_batched_residual_routes_one_call_a_card(monkeypatch):
    """sharded_residual issues one residual_shards call per card over that
    card's shards in shard order: a ring of 8 on one device is one call of
    8; a 2 x 4 mesh whose columns alternate between two devices ("cpu" and
    "cpu:0", two entries to the layout) one call each, bit for bit the
    unsharded residual either way."""
    calls = []
    real = K.residual_shards

    def counted(ues, fes, geos, h, negate=False):
        calls.append([(g.row0, g.col0) for g in geos])
        return real(ues, fes, geos, h, negate)

    monkeypatch.setattr(K, "residual_shards", counted)
    n = 129
    u, f = _uf(9, n)
    h = 1.0 / (n - 1)
    one = S.Layout(n, S.split_bounds(n, 8), ((0, n),),
                   tuple((torch.device("cpu"),) for _ in range(8)))
    two = S.Layout(n, S.split_bounds(n, 2), S.split_bounds(n, 4),
                   tuple(tuple(torch.device("cpu:0" if j % 2 else "cpu") for j in range(4))
                         for _ in range(2)))
    want = K.residual_torch(u, f, h, True)
    for lay in (one, two):
        got = KS.sharded_residual(S.shard(u, lay), S.shard(f, lay), h, True)
        assert torch.equal(S.gather(got), want)
    origins = [(two.rows[i][0], two.cols[j][0]) for i, j in two.order()]
    assert calls == [[(r0, 0) for r0, _ in one.rows], origins[0::2], origins[1::2]]


@pytest.fixture(scope="module")
def jpolicies():
    return {"rows-8": JRows(jmake_mesh(), threshold_rows=8),
            "blocks-2x4": JBlock(jmake_mesh_2d((2, 4)), threshold_rows=8)}


@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("kind", ["rows-8", "blocks-2x4"])
def test_batched_twin_matches_jax_sharded_residual(jpolicies, kind, negate):
    """``sharded_residual`` (one batched call on the CPU ring, its twin)
    against JAX's ``sharded_residual_pallas`` in interpret mode on the
    8-device mesh at 129², within tests/test_torch_shard.py's residual
    bound (8 ulp of max|u|/h²)."""
    jpol = jpolicies[kind]
    n = 129
    h = 1.0 / (n - 1)
    u, f = (x.numpy() for x in _uf(11 + negate, n))
    rp, cp = jpol.padded_shape(n)
    ju, jf = (jax.device_put(jnp.zeros((rp, cp), jnp.float32).at[:n, :n].set(jnp.asarray(a)),
                             NamedSharding(jpol.mesh, jpol.spec(n))) for a in (u, f))
    want = np.asarray(jps.sharded_residual_pallas(ju, jf, n, h, jpol, negate=negate,
                                                  interpret=True))[:n, :n]
    pol = policy_from_jax(jpol)
    us, fs = (sharded_from_jax(x, pol, n) for x in (ju, jf))
    got = S.gather(KS.sharded_residual(us, fs, h, negate)).numpy()
    atol = 8 * 1.2e-7 * float(np.abs(u).max()) / (h * h)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert np.array_equal(got, K.residual_torch(torch.from_numpy(u), torch.from_numpy(f), h,
                                                negate).numpy())
