"""The pass schedules of the 3-D ring smoother (kernel 20,
csrc/rdma_jacobi3.cu) and of the column residual (kernel 13,
csrc/residual3.cu, both modes), emulated in plain PyTorch on the CPU.

Nothing compiles the CUDA sources here, so these tests hold the plane
ranges the kernels follow against the twins the card's checks hold them to
(chip_smoke.py phases 2, H1 and I1).

Kernel 20 is the ring leg of csrc/rdma3.cuh with kernel 10's shard-mode
passes: every shard posts the planes of u (none from zero) and f that its
neighbours' windows take, depth = k − from_zero + clean planes a side, into
their receive buffers (``_post`` of tests/test_torch_col3_ring_legs.py:
NaN where nothing was posted), then runs ``col3_schedule``'s k sweeps with
``tail`` 0 (sweep j writes k + clean − j − 1 planes a side beyond its
block) into two scratch windows that hold stale iterates, the last iterate
into the owned planes, and with the clean error a pass that reads iterate
k. Its owned planes and raw float64 sums equal ``rdma_jacobi3_torch``'s
bit for bit at 33³ and 65³ on 2, 3, 4, 8 and 16 z-shards of the port's
split (on 16 shards a window of up to 8 planes spans several neighbours'
blocks), steps 1, 3, 7 and 8, from zero or not, error None, clean and gpu;
a window one plane shallower or a tail one plane short fails.

Kernel 13 is one column pass: each z chunk of its tile plan (``err_plan3``
of the shard's depth) reads u on its planes and one a side, f on its own,
and writes r on its planes only. Held bit for bit against
``residual3_torch`` on the whole grid and ``residual3_shard_torch`` on 2-8
shards, with every window plane beyond ext = 1 NaN; and the shard twin
against JAX's ``sharded_residual3_pallas`` in interpret mode on the
8-device CPU mesh. The emulations are test code: the kernels' own plane
ranges live in csrc/rdma3.cuh, csrc/col3.cuh and the two sources.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_col3_ring_legs import (_fields, _fine_window, _post, _ring_source, _same, _stack,
                                       _sweeps, _Window, _zin)

from multigrid_poisson_solver_tpu.ops import pallas3d as jp3k
from multigrid_poisson_solver_tpu.parallel import pallas_shard3 as jps3
from multigrid_poisson_solver_tpu_torch.convert import grid3_from_jax
from multigrid_poisson_solver_tpu_torch.ops import kernels3 as K3
from multigrid_poisson_solver_tpu_torch.ops import rdma3 as R3
from multigrid_poisson_solver_tpu_torch.parallel import halo3
from multigrid_poisson_solver_tpu_torch.parallel import sharded as S

OMEGA3 = 6.0 / 7.0
NAN = float("nan")
RINGS = [(n, p) for n in (33, 65) for p in (2, 3, 4, 8, 16)]
STEPS = (1, 3, 7, 8)
MODES = (None, "clean", "gpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulations run thousands of small tensor ops: one intra-op thread
    each, as several test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- kernel 20: the ring smoother ----------------------------------------------------------

def _jacobi_shard(ring_u, ring_f, rows, s, n, h, steps, fz, mode, gen, tail):
    """rdma_jacobi3.cu's passes on shard s: (owned planes, raw error or
    None). ``tail``: col3_schedule's (0; −1 is a mutation)."""
    z0, z1 = rows[s]
    clean = int(mode == "clean")
    depth = steps - int(fz) + clean
    wins = [_Window(z0, z1, depth, n, gen), _Window(z0, z1, depth, n, gen)]
    out, it_k = _sweeps(None if fz else ring_u, ring_f, z0, z1, n, h, steps, wins, clean, tail)
    geo = K3.ShardGeo3(n, z0, z1 - z0)
    if mode is None:
        return out, None
    if mode == "clean":
        a, b = max(z0 - 1, 0), min(z1 + 1, n)
        r = K3._residual3_ext(_stack(it_k.plane, a, b), _stack(ring_f, a, b), _zin(a, b, n), h)
        return out, K3._raw3(torch.abs(r[z0 - a:z1 - a]), geo)
    # gpu: iterate k − 1's owned planes, in the window the last sweep read
    # (the input, or zeros from zero, for one sweep)
    if steps >= 2:
        prev = _stack(wins[1].plane, z0, z1)
    else:
        prev = torch.zeros_like(out) if fz else _stack(ring_u, z0, z1)
    return out, K3._raw3(torch.abs(out - prev), geo)


def _jacobi(u, f, n, shards, steps, fz, mode, depth_cut=0, tail=0, seed=0):
    """Every shard's (owned planes, raw sum or None) on the port's z split
    (``depth_cut``, ``tail`` −1: mutations)."""
    rows = S.split_bounds(n, shards)
    h = 1.0 / (n - 1)
    depth = steps - int(fz) + int(mode == "clean") - depth_cut   # of the posts
    ub, fb = [u[a:b] for a, b in rows], [f[a:b] for a, b in rows]
    fbufs = _post(fb, rows, lambda r, side: _fine_window(rows, r, side, depth), (n, n))
    ubufs = None if fz else _post(ub, rows, lambda r, side: _fine_window(rows, r, side, depth),
                                  (n, n))
    gen = torch.Generator().manual_seed(seed)
    return [_jacobi_shard(None if fz else _ring_source(ub, ubufs, rows, s, n),
                          _ring_source(fb, fbufs, rows, s, n), rows, s, n, h, steps, fz, mode,
                          gen, tail)
            for s in range(len(rows))]


@pytest.mark.parametrize("n,shards", RINGS)
def test_jacobi_ring_schedule_matches_the_twin(n, shards):
    """Steps 1, 3, 7 and 8, from zero and not, no error, the clean and the
    gpu error (the clean one within 7 neighbour-reading sweeps): the
    emulated post, receive buffers and passes give rdma_jacobi3_torch's
    owned planes and raw float64 sums bit for bit."""
    u, f, _ = _fields(n, 50 * n + shards)
    lay = S.z_layout(n, ["cpu"] * shards)
    us, fs = S.shard(u, lay), S.shard(f, lay)
    h = 1.0 / (n - 1)
    for steps in STEPS:
        for fz in (False, True):
            for mode in MODES:
                if steps - int(fz) + int(mode == "clean") > K3.MAX_FUSED_SWEEPS_3D:
                    continue
                want_u, want_raw = R3.rdma_jacobi3_torch(us, fs, h, steps, OMEGA3, fz, mode)
                res = _jacobi(u, f, n, shards, steps, fz, mode, seed=steps)
                for i, (got_u, got_raw) in enumerate(res):
                    what = (i, steps, fz, mode)
                    assert _same(got_u, want_u.blocks[i][0]), what
                    assert _same(got_raw, None if mode is None else want_raw[i]), what


@pytest.mark.parametrize("n,shards", [(33, 4), (65, 16)])
@pytest.mark.parametrize("mutation", ["depth", "tail"])
def test_jacobi_mutations_fail(n, shards, mutation):
    """A window one plane shallower (the posts, so the receive buffers hold
    NaN where a sweep reads) or, with the clean error, a tail one plane
    short (each sweep writes one plane fewer a side, so the error's pass
    reads a stale window plane) differs from the twin."""
    u, f, _ = _fields(n, 60 * n + shards)
    lay = S.z_layout(n, ["cpu"] * shards)
    us, fs = S.shard(u, lay), S.shard(f, lay)
    h = 1.0 / (n - 1)
    cases = (((False, "gpu"), (True, "clean"), (False, None)) if mutation == "depth"
             else ((False, "clean"), (True, "clean")))
    for fz, mode in cases:
        want_u, want_raw = R3.rdma_jacobi3_torch(us, fs, h, 3, OMEGA3, fz, mode)
        cut = dict(depth_cut=1) if mutation == "depth" else dict(tail=-1)
        res = _jacobi(u, f, n, shards, 3, fz, mode, **cut)
        assert any(not _same(r[0], want_u.blocks[i][0])
                   or not _same(r[1], None if mode is None else want_raw[i])
                   for i, r in enumerate(res)), (fz, mode)


def test_one_closed_form_sweep_posts_nothing():
    """One sweep from zero without the clean error reads no halo plane
    (depth 0: the kernel posts nothing): the emulation with empty windows
    and nothing posted equals the twin."""
    n, shards = 33, 8
    u, f, _ = _fields(n, 7)
    lay = S.z_layout(n, ["cpu"] * shards)
    fs = S.shard(f, lay)
    h = 1.0 / (n - 1)
    for mode in (None, "gpu"):
        want_u, want_raw = R3.rdma_jacobi3_torch(None, fs, h, 1, OMEGA3, True, mode)
        res = _jacobi(u, f, n, shards, 1, True, mode)
        for i, (got_u, got_raw) in enumerate(res):
            assert _same(got_u, want_u.blocks[i][0]), (i, mode)
            assert _same(got_raw, None if mode is None else want_raw[i]), (i, mode)


# --- kernel 13: the column residual ----------------------------------------------------------

def _window_nan(x, z0, z1, ext, n):
    """Planes [z0 − ext, z1 + ext) of x as a shard's window, NaN beyond the
    grid, and a reader of global plane z that is NaN beyond the window."""
    win = torch.full((z1 - z0 + 2 * ext,) + x.shape[1:], NAN)
    lo, hi = max(z0 - ext, 0), min(z1 + ext, n)
    win[lo - (z0 - ext):hi - (z0 - ext)] = x[lo:hi]

    def plane(z):
        i = z - (z0 - ext)
        return win[i] if 0 <= i < win.shape[0] else torch.full(x.shape[1:], NAN)
    return plane


def _residual_shard(u, f, n, z0, z1, ext, cz, negate):
    """residual3.cu's pass on the owned planes [z0, z1): each z chunk of cz
    planes reads u on its planes and one a side (within the grid) and f on
    its own, from windows NaN beyond ext planes a side."""
    h = 1.0 / (n - 1)
    ur, fr = _window_nan(u, z0, z1, ext, n), _window_nan(f, z0, z1, ext, n)
    out = []
    for e0 in range(z0, z1, cz):
        e1 = min(e0 + cz, z1)
        a, b = max(e0 - 1, 0), min(e1 + 1, n)
        fs = torch.full((b - a, n, n), NAN)
        fs[e0 - a:e1 - a] = _stack(fr, e0, e1)   # the chunk reads f on its planes only
        r = K3._residual3_ext(_stack(ur, a, b), fs, _zin(a, b, n), h)[e0 - a:e1 - a]
        out.append(-r if negate else r)
    return torch.cat(out)


@pytest.mark.parametrize("n", [33, 65])
@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_residual_column_pass_matches_the_twins(n, shards):
    """The planned z chunks (err_plan3 of the shard's depth) and forced ones
    of 5 planes, negated and not: on the whole grid (one shard, no window)
    bit for bit residual3_torch, on 2-8 shards residual3_shard_torch on
    windows of one halo plane."""
    u, f, _ = _fields(n, 70 * n + shards)
    h = 1.0 / (n - 1)
    lay = S.z_layout(n, ["cpu"] * shards)
    us, fs = S.shard(u, lay), S.shard(f, lay)
    ext = 0 if shards == 1 else 1
    for negate in (False, True):
        for i, (z0, z1) in enumerate(lay.rows):
            if shards == 1:
                want = K3.residual3_torch(u, f, h, negate)
            else:
                want = K3.residual3_shard_torch(S.extend(us, i, 0, ext), S.extend(fs, i, 0, ext),
                                                halo3.geo3(fs, i, ext), h, negate)
            for cz in (K3.err_plan3(z1 - z0)[2], 5):
                got = _residual_shard(u, f, n, z0, z1, ext, cz, negate)
                assert _same(got, want), (i, negate, cz)


def test_residual_without_the_halo_plane_fails():
    """Windows of no halo plane (NaN at the cut) differ from the twin on a
    ring of 4 shards."""
    n, shards = 33, 4
    u, f, _ = _fields(n, 71)
    lay = S.z_layout(n, ["cpu"] * shards)
    us, fs = S.shard(u, lay), S.shard(f, lay)
    h = 1.0 / (n - 1)
    assert any(not _same(_residual_shard(u, f, n, z0, z1, 0, 8, False),
                         K3.residual3_shard_torch(S.extend(us, i, 0, 1), S.extend(fs, i, 0, 1),
                                                  halo3.geo3(fs, i, 1), h))
               for i, (z0, z1) in enumerate(lay.rows))


@pytest.mark.parametrize("negate", [False, True])
def test_residual3_shard_twin_matches_jax_sharded(negate):
    """residual3_shard_torch on each of 8 z-shards' one-plane windows
    against JAX's sharded_residual3_pallas on its 8-device CPU mesh in
    interpret mode, at 33³: within the fp32 cancellation noise of a 7-point
    residual, 12·eps·max|u|/h² (tests/test_torch_kernels3.py's bound; JAX's
    Pallas residual sums in another order)."""
    n, ndev = 33, 8
    h = 1.0 / (n - 1)
    u, f, _ = _fields(n, 72)
    mesh = jps3.make_mesh_z(jax.devices()[:ndev])

    def jsharded(a):
        return jax.device_put(jps3.pad_planes3(jp3k.pad_grid3(jnp.asarray(a.numpy())), ndev),
                              jps3.z_sharding(mesh))

    with mesh:
        want = grid3_from_jax(jps3.sharded_residual3_pallas(jsharded(u), jsharded(f), n, h, mesh,
                                                            negate=negate, interpret=True), n)
    lay = S.z_layout(n, ["cpu"] * ndev)
    us, fs = S.shard(u, lay), S.shard(f, lay)
    got = torch.cat([K3.residual3_shard_torch(S.extend(us, i, 0, 1), S.extend(fs, i, 0, 1),
                                              halo3.geo3(fs, i, 1), h, negate)
                     for i in range(ndev)])
    atol = 12 * 1.2e-7 * float(u.abs().max()) / (h * h)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=atol)
