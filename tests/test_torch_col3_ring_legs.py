"""The pass schedules of the 3-D ring legs (kernels 21 and 22,
csrc/rdma_descend3.cu and csrc/rdma_ascend3.cu), emulated in plain PyTorch
on the CPU.

Nothing compiles the CUDA sources here, so these tests hold the plane
ranges the ring kernels follow against the twins the card's checks hold
them to (chip_smoke.py phase I1): ``rdma_descend3_torch`` and
``rdma_ascend3_torch``, the exchange path on the shard-mode twins, which
tests/test_torch_rdma3.py holds to JAX's ring kernels.

Each shard of a ring leg reads three kinds of planes, emulated below:

  * its own block of u, f and (ascend) the coarse correction;
  * the receive buffers its neighbours posted into, ``RING3_HALO`` planes a
    side: every sender posts the planes of its block that meet the
    receiver's window (``fine_window`` and ``coarse_window`` of
    csrc/rdma3.cuh, mirrored here), the window being the leg's depth (the
    descend leg: k_nb + 1 + full weighting planes; the ascend leg: k +
    clean); from zero no u is posted;
  * its two scratch windows (its planes and the depth a side), which hold
    stale iterates of an earlier call until a pass writes them.

Every buffer plane no sender posted, and every plane beyond the grid, is
NaN. The passes are the shard modes' (tests/test_torch_col3_legs.py):
``col3_schedule``'s sweeps (sweep j writes k + clean + tail − j − 1 planes
a side beyond the block), the descend leg's residual pass per z chunk and
its restriction, the ascend leg's prolongation on every window plane a
sweep reads. The owned planes, the coarse slab and the raw float64 sums
equal the twins' bit for bit at 33³ and 65³ on 1, 2, 3, 4, 8 and (65³) 16
z-shards of the port's split (ragged last shards; on 16 shards of 4 planes
a window of up to 8 planes spans two neighbours' blocks), and a window one
plane shallower, a tail one plane shorter or a coarse window one plane
narrower shows as NaN or as a stale plane. The emulations are test code:
the kernels' own plane ranges live in csrc/rdma3.cuh, csrc/col3.cuh,
csrc/col3_legs.cuh and the two ring sources.
"""

import numpy as np
import pytest
import torch

from multigrid_poisson_solver_tpu_torch.ops import kernels3 as K3
from multigrid_poisson_solver_tpu_torch.ops import rdma3 as R3
from multigrid_poisson_solver_tpu_torch.parallel import sharded as S

OMEGA3 = 6.0 / 7.0
H = R3.RING3_HALO
NAN = float("nan")
RINGS = [(33, p) for p in (1, 2, 3, 4, 8)] + [(65, p) for p in (1, 2, 3, 4, 8, 16)]


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
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((n, n, n), (n, n, n), ((n + 1) // 2,) * 3)]


# --- the ring: windows, posts and what a shard reads -------------------------------------

def _fine_window(rows, r, side, depth):
    """rdma3.cuh's fine_window: the planes above (side 0) or below shard r's
    block that its window takes."""
    z0, z1 = rows[r]
    return (z0 - depth, z0) if side == 0 else (z1, z1 + depth)


def _coarse_window(rows, n, r, side, depth, narrow=0):
    """rdma3.cuh's coarse_window: the coarse planes the window's fine planes
    interpolate from (``narrow`` planes fewer at its far end: a mutation)."""
    m = (n + 1) // 2
    z0, z1 = rows[r]
    if side == 0:
        return (max(z0 - depth, 0) >> 1) + narrow, z0 // 2
    return (z1 + 1) // 2, min(((z1 + depth) >> 1) + 1, m) - narrow


def _post(blocks, rows, windows, shape):
    """Every shard's receive buffers, RING3_HALO planes a side (side 0 from
    its block's first plane − RING3_HALO, side 1 from its block's end):
    each sender d posts the planes of its block ``rows[d]`` that meet the
    receiver's window ``windows(r, side)``; the rest stays NaN."""
    bufs = []
    for r in range(len(rows)):
        sides = []
        for side in (0, 1):
            buf = torch.full((H,) + shape, NAN)
            origin = rows[r][0] - H if side == 0 else rows[r][1]
            lo, hi = windows(r, side)
            for d, (b0, b1) in enumerate(rows):
                a, b = max(lo, b0), min(hi, b1)
                if d != r and a < b:
                    assert origin <= a and b <= origin + H, (r, side, a, b)
                    buf[a - origin:b - origin] = blocks[d][a - b0:b - b0]
            sides.append(buf)
        bufs.append(sides)
    return bufs


def _ring_source(blocks, bufs, rows, s, size):
    """Plane z of shard s's input as the kernel reads it: its block, or a
    receive buffer beyond it (NaN beyond the grid or the buffer)."""
    z0, z1 = rows[s]

    def plane(z):
        if 0 <= z < size:
            if z0 <= z < z1:
                return blocks[s][z - z0]
            i = z - (z0 - H) if z < z0 else z - z1
            if 0 <= i < H:
                return bufs[s][0 if z < z0 else 1][i]
        return torch.full(blocks[s].shape[1:], NAN)
    return plane


class _Window:
    """A shard's scratch window: planes [z0 − depth, z1 + depth), stale
    iterates of an earlier call until a pass writes them."""

    def __init__(self, z0, z1, depth, n, gen):
        self.first, self.last = z0 - depth, z1 + depth
        self.x = torch.randn((z1 - z0 + 2 * depth, n, n), generator=gen)

    def plane(self, z):
        assert self.first <= z < self.last, (z, self.first, self.last)
        return self.x[z - self.first]

    def write(self, lo, hi, planes):
        assert self.first <= lo and hi <= self.last, (lo, hi, self.first, self.last)
        self.x[lo - self.first:hi - self.first] = planes


def _stack(read, lo, hi):
    return torch.stack([read(z) for z in range(lo, hi)])


def _zin(lo, hi, n):
    gz = torch.arange(lo, hi)
    return (gz >= 1) & (gz <= n - 2)


# --- the shard's passes ---------------------------------------------------------------------

def _sweep(read, fread, lo, hi, n, h):
    """One sweep of the source ``read`` on planes [lo, hi), reading its planes
    [lo − 1, hi + 1) and f's [lo, hi) within the grid."""
    a, b = max(lo - 1, 0), min(hi + 1, n)
    return K3._sweep3_ext(_stack(read, a, b), _stack(fread, a, b), _zin(a, b, n), h,
                          OMEGA3)[lo - a:hi - a]


def _zero_sweep(fread, lo, hi, n, h):
    """The closed-form first sweep from u ≡ 0 on planes [lo, hi)."""
    fs = _stack(fread, lo, hi)
    out = torch.zeros_like(fs)
    out[:, 1:-1, 1:-1] = torch.where(
        _zin(lo, hi, n)[:, None, None],
        (OMEGA3 / 6.0) * (out[:, 1:-1, 1:-1] - (h * h) * fs[:, 1:-1, 1:-1]), out[:, 1:-1, 1:-1])
    return out


def _sweeps(src, fread, z0, z1, n, h, steps, wins, clean, tail):
    """col3_schedule's ``steps`` sweeps from the source src (None: u ≡ 0)
    into the windows (iterate s in wins[(steps − s) % 2]): (owned planes of
    iterate k, the window holding it)."""
    out = None
    for j in range(steps):
        more = steps + clean + tail - j - 1
        lo, hi = max(z0 - more, 0), min(z1 + more, n)
        planes = _zero_sweep(fread, lo, hi, n, h) if src is None else _sweep(src, fread, lo, hi,
                                                                              n, h)
        dst = wins[(steps - j - 1) % 2]
        if j == steps - 1:
            out = planes[z0 - lo:z1 - lo].clone()
            if not (clean or tail):   # the last iterate goes to the owned planes alone
                return out, None
        dst.write(lo, hi, planes)
        src = dst.plane
    return out, wins[0]


def _descend_shard(ring_u, ring_f, rows, s, n, h, steps, fz, fw, cz, gen, tail):
    """rdma_descend3.cu's passes on shard s: (owned planes, coarse slab, raw
    clean error)."""
    z0, z1 = rows[s]
    m = (n + 1) // 2
    depth = steps - int(fz) + 1 + fw
    wins = [_Window(z0, z1, depth, n, gen), _Window(z0, z1, depth, n, gen)]
    out, it_k = _sweeps(None if fz else ring_u, ring_f, z0, z1, n, h, steps, wins, 0, tail)
    k0, k1 = z0 // 2, (z1 + 1) // 2
    s_buf = torch.full((k1 - k0, n, n), NAN)   # the restriction's z steps, torch.empty
    d_own = torch.zeros((z1 - z0, n, n))
    for e0 in range(z0, z1, cz):
        e1 = min(e0 + cz, z1)
        zs, ze = max(e0 - fw, 0), min(e1 + fw, n)
        a, b = max(zs - 1, 0), min(ze + 1, n)
        d = -K3._residual3_ext(_stack(it_k.plane, a, b), _stack(ring_f, a, b), _zin(a, b, n),
                               h)[zs - a:ze - a]
        d_own[e0 - z0:e1 - z0] = d[e0 - zs:e1 - zs]
        for k in range(k0, k1):
            if e0 <= 2 * k < e1 and 1 <= k <= m - 2:
                z = 2 * k - zs
                s_buf[k - k0] = ((0.25 * d[z - 1] + 0.5 * d[z]) + 0.25 * d[z + 1] if fw
                                 else d[z])
    raw = K3._raw3(torch.abs(d_own), K3.ShardGeo3(n, z0, z1 - z0))
    fc = torch.zeros((k1 - k0, m, m))
    for k in range(max(k0, 1), min(k1, m - 1)):
        fc[k - k0, 1:-1, 1:-1] = K3._restrict_yx(s_buf[k - k0:k - k0 + 1], n, bool(fw))[0]
    return out, fc, raw


def _ascend_shard(ring_u, ring_f, ring_c, rows, s, n, h, steps, want_err, gen):
    """rdma_ascend3.cu's passes on shard s: (owned planes, raw clean error or
    None)."""
    z0, z1 = rows[s]
    m, clean = (n + 1) // 2, int(want_err)
    depth = steps + clean
    wins = [_Window(z0, z1, depth, n, gen), _Window(z0, z1, depth, n, gen)]
    u0 = wins[1] if (steps - 1) % 2 == 0 else wins[0]   # the window iterate 1 does not go to
    plo, phi = max(z0 - depth, 0), min(z1 + depth, n)
    # the coarse planes the window's interior planes interpolate from
    c_lo = max(plo, 1) >> 1
    c_hi = min(((min(phi, n - 1) - 1) >> 1) + 2, m)
    e = K3._prolong3_planes(_stack(ring_c, c_lo, c_hi), c_lo, K3.ShardGeo3(n, plo, phi - plo))
    u = _stack(ring_u, plo, phi)
    zin = _zin(plo, phi, n)
    u[:, 1:-1, 1:-1] = torch.where(zin[:, None, None], u[:, 1:-1, 1:-1] + e[:, 1:-1, 1:-1],
                                   u[:, 1:-1, 1:-1])
    u0.write(plo, phi, u)
    out, it_k = _sweeps(u0.plane, ring_f, z0, z1, n, h, steps, wins, clean, 0)
    if not want_err:
        return out, None
    a, b = max(z0 - 1, 0), min(z1 + 1, n)
    r = K3._residual3_ext(_stack(it_k.plane, a, b), _stack(ring_f, a, b), _zin(a, b, n), h)
    return out, K3._raw3(torch.abs(r[z0 - a:z1 - a]), K3.ShardGeo3(n, z0, z1 - z0))


# --- the legs over the ring -------------------------------------------------------------------

def _descend(u, f, n, shards, steps, fz, fw, cz=None, depth_cut=0, tail_cut=0, seed=0):
    """Every shard's (owned planes, coarse slab, raw sum) on the port's z
    split (``depth_cut``, ``tail_cut``: mutations)."""
    rows = S.split_bounds(n, shards)
    h = 1.0 / (n - 1)
    depth = steps - int(fz) + 1 + fw - depth_cut   # of the posts
    ub, fb = [u[a:b] for a, b in rows], [f[a:b] for a, b in rows]
    fbufs = _post(fb, rows, lambda r, side: _fine_window(rows, r, side, depth), (n, n))
    ubufs = None if fz else _post(ub, rows, lambda r, side: _fine_window(rows, r, side, depth),
                                  (n, n))
    gen = torch.Generator().manual_seed(seed)
    res = []
    for s, (z0, z1) in enumerate(rows):
        ring_u = None if fz else _ring_source(ub, ubufs, rows, s, n)
        ring_f = _ring_source(fb, fbufs, rows, s, n)
        res.append(_descend_shard(ring_u, ring_f, rows, s, n, h, steps, fz, fw,
                                  cz or K3.err_plan3(z1 - z0)[2], gen, 1 + fw - tail_cut))
    return res


def _ascend(u, f, c, n, shards, steps, want_err, depth_cut=0, narrow=0, seed=0):
    """Every shard's (owned planes, raw sum or None) on the port's z split
    (``depth_cut``, ``narrow``: mutations)."""
    rows = S.split_bounds(n, shards)
    h = 1.0 / (n - 1)
    depth = steps + int(want_err) - depth_cut   # of the posts
    crows = R3.coarse_layout3(S.shard(f, S.z_layout(n, ["cpu"] * shards))).rows
    ub, fb, cb = [u[a:b] for a, b in rows], [f[a:b] for a, b in rows], [c[a:b] for a, b in crows]
    ubufs = _post(ub, rows, lambda r, side: _fine_window(rows, r, side, depth), (n, n))
    fbufs = _post(fb, rows, lambda r, side: _fine_window(rows, r, side, depth), (n, n))
    m = (n + 1) // 2
    cbufs = _post(cb, crows, lambda r, side: _coarse_window(rows, n, r, side, depth, narrow),
                  (m, m))
    gen = torch.Generator().manual_seed(seed)
    res = [_ascend_shard(_ring_source(ub, ubufs, rows, s, n), _ring_source(fb, fbufs, rows, s, n),
                         _ring_source(cb, cbufs, crows, s, m), rows, s, n, h, steps, want_err, gen)
           for s in range(len(rows))]
    return res


def _same(got, want):
    if got is None or want is None:
        return got is want
    return got.shape == want.shape and bool(torch.equal(got, want))


@pytest.mark.parametrize("restriction", ["full_weighting", "sampling"])
@pytest.mark.parametrize("n,shards", RINGS)
def test_descend_ring_schedule_matches_the_twin(n, shards, restriction):
    """Every sweep count within the cap, from zero and not, the planned z
    chunk and (one case a ring) a forced one of 6 planes: the emulated
    post, receive buffers and passes give rdma_descend3_torch's owned
    planes, coarse slab and raw float64 sums bit for bit."""
    fw = int(restriction == "full_weighting")
    cap = K3.MAX_DESCEND3_SWEEPS_FW if fw else K3.MAX_DESCEND3_SWEEPS_SAMPLING
    u, f, _ = _fields(n, 10 * n + shards)
    lay = S.z_layout(n, ["cpu"] * shards)
    us, fs = S.shard(u, lay), S.shard(f, lay)
    h = 1.0 / (n - 1)
    for steps in range(1, cap + 2):
        for fz in (False, True):
            if steps - int(fz) > cap:
                continue
            want_u, want_fc, want_raw = R3.rdma_descend3_torch(us, fs, h, steps, OMEGA3, fz,
                                                               restriction, True)
            for cz in (None, 6) if steps == 3 else (None,):
                res = _descend(u, f, n, shards, steps, fz, fw, cz, seed=steps)
                for i, (got_u, got_fc, got_raw) in enumerate(res):
                    what = (i, steps, fz, cz)
                    assert _same(got_u, want_u.blocks[i][0]), what
                    assert _same(got_fc, want_fc.blocks[i][0]), what
                    assert _same(got_raw, want_raw[i]), what


@pytest.mark.parametrize("n,shards", RINGS)
def test_ascend_ring_schedule_matches_the_twin(n, shards):
    """Every sweep count within the cap, with and without the clean error:
    the emulated posts (fine and coarse), receive buffers and passes give
    rdma_ascend3_torch's owned planes and raw float64 sums bit for bit."""
    u, f, c = _fields(n, 20 * n + shards)
    lay = S.z_layout(n, ["cpu"] * shards)
    us, fs = S.shard(u, lay), S.shard(f, lay)
    h = 1.0 / (n - 1)
    for want_err in (False, True):
        for steps in range(1, K3.MAX_FUSED_SWEEPS_3D + 1 - int(want_err)):
            want_u, want_raw = R3.rdma_ascend3_torch(us, fs, c, h, steps, OMEGA3, want_err)
            res = _ascend(u, f, c, n, shards, steps, want_err, seed=steps)
            for i, (got_u, got_raw) in enumerate(res):
                assert _same(got_u, want_u.blocks[i][0]), (i, steps, want_err)
                if want_err:
                    assert _same(got_raw, want_raw[i]), (i, steps)
                else:
                    assert got_raw is None and want_raw is None


def _mismatch(res, want_u, want_other, pick):
    """Whether any shard's result differs from the twin's."""
    return any(not _same(r[0], want_u.blocks[i][0]) or not _same(pick(r), want_other(i))
               for i, r in enumerate(res))


@pytest.mark.parametrize("n,shards", [(33, 4), (65, 16)])
@pytest.mark.parametrize("mutation", ["depth", "tail"])
def test_descend_mutations_fail(n, shards, mutation):
    """A window one plane shallower (the posts and so the receive buffers)
    or a tail one plane shorter (iterate k on one plane fewer a side, so the
    residual pass reads a stale plane) differs from the twin."""
    u, f, _ = _fields(n, 30 * n + shards)
    lay = S.z_layout(n, ["cpu"] * shards)
    us, fs = S.shard(u, lay), S.shard(f, lay)
    h = 1.0 / (n - 1)
    for fz in (False, True):
        want_u, want_fc, _ = R3.rdma_descend3_torch(us, fs, h, 3, OMEGA3, fz, "full_weighting",
                                                    True)
        cut = dict(depth_cut=1) if mutation == "depth" else dict(tail_cut=1)
        res = _descend(u, f, n, shards, 3, fz, 1, **cut)
        assert _mismatch(res, want_u, lambda i: want_fc.blocks[i][0], lambda r: r[1]), fz


@pytest.mark.parametrize("n,shards", [(33, 4), (65, 16)])
@pytest.mark.parametrize("mutation", ["depth", "coarse window"])
def test_ascend_mutations_fail(n, shards, mutation):
    """A fine window one plane shallower, or a coarse window one plane
    narrower at its far end, differs from the twin."""
    u, f, c = _fields(n, 40 * n + shards)
    lay = S.z_layout(n, ["cpu"] * shards)
    us, fs = S.shard(u, lay), S.shard(f, lay)
    h = 1.0 / (n - 1)
    for steps, want_err in ((3, False), (2, True)):
        want_u, want_raw = R3.rdma_ascend3_torch(us, fs, c, h, steps, OMEGA3, want_err)
        cut = dict(depth_cut=1) if mutation == "depth" else dict(narrow=1)
        res = _ascend(u, f, c, n, shards, steps, want_err, **cut)
        assert _mismatch(res, want_u, lambda i: want_raw[i] if want_err else None,
                         lambda r: r[1]), steps


def test_windows_span_neighbours_and_fit_the_buffers():
    """On 16 shards of 65 (blocks of 4 planes) a descend window of 8 planes
    takes planes of two neighbours' blocks, and every window the legs take
    (depth at most RING3_HALO, coarse windows at most 5 planes) fits the
    receive buffers; _post asserts the fit for every test above."""
    n, rows = 65, S.split_bounds(65, 16)
    lo, hi = _fine_window(rows, 5, 0, 8)
    assert sum(1 for a, b in rows if max(lo, a) < min(hi, b)) == 2
    for depth in range(1, H + 1):
        for r in range(len(rows)):
            for side in (0, 1):
                a, b = _coarse_window(rows, n, r, side, depth)
                assert b - a <= 5, (depth, r, side, a, b)
