"""The column pass's schedules (csrc/col3.cuh) for kernel 10's fixed-sweep
modes and the ring trigger kernel 19, emulated in plain PyTorch on the CPU.

Nothing compiles the CUDA sources here, so these tests hold the rules the
kernels follow against the plain twins the card's checks hold the kernels
to (chip_smoke.py phases 2, H1 and I1):

  * every tile plan kernel 10's fixed-sweep modes and kernel 19 take
    (``err_plan3`` of a level or of a shard's depth, and the forced tiles of
    the card's checks) fits the column pass: at most 512 cells a tile, for
    the levels and shard depths of phases H2, H3 and I3 and the CLI (33³ to
    513³ on 2 to 16 z-shards);
  * ``col3_schedule``'s passes, mirrored below: sweep s of k writes the
    owned planes and the k + clean − s more per side that the later passes
    read, the iterates alternating between two buffers (the last to the
    owned planes alone unless a pass reads it), the from_zero sweep
    a closed form over f on every plane it writes, the clean error from a
    pass that only reads (or, lagged, from the last sweep's read of its
    input) and the gpu error from the last sweep. Run on windows that hold
    just the planes the pass needs, with every plane it must not read set
    to NaN and stale iterates left in the buffers, the owned planes and the
    raw error equal ``fused_jacobi3_shard_torch``'s (and
    ``trigger_pass3_shard_torch``'s) bit for bit: a wrong halo offset shows
    as NaN or as a stale plane;
  * kernel 19's ring, mirrored below: per sweep one pass per shard over its
    owned planes, one halo plane a side read from a receive buffer of the
    sweep's parity, boundary planes posted into the neighbours' buffers of
    the next parity, raw sums added in shard order, the clean error one
    sweep behind: iterate, error and stop sweep equal ``rdma_trigger3_torch``
    (the loop of one-sweep sharded error steps) bit for bit on 2, 3, 4 and
    8 shards at 33³ and 65³;
  * ``solver.trigger_loop_lagged`` over ``sharded_trigger_pass3`` (the
    route of a sharded clean trigger node) equals ``trigger_loop`` over
    ``sharded_trigger_step3`` bit for bit.

The emulations are test code: the kernels' own plane ranges live in
csrc/col3.cuh and csrc/rdma_trigger3.cu.
"""

import math

import numpy as np
import pytest
import torch

from multigrid_poisson_solver_tpu_torch.ops import kernels3 as K3
from multigrid_poisson_solver_tpu_torch.ops import rdma3 as R3
from multigrid_poisson_solver_tpu_torch.parallel import halo3
from multigrid_poisson_solver_tpu_torch.parallel import kernel_shard3 as KS3
from multigrid_poisson_solver_tpu_torch.parallel import mesh as M
from multigrid_poisson_solver_tpu_torch.parallel import sharded as S
from multigrid_poisson_solver_tpu_torch.solver import trigger_loop, trigger_loop_lagged

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


def _fields(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.standard_normal((n, n, n)).astype(np.float32)) * scale
    f = torch.from_numpy(rng.standard_normal((n, n, n)).astype(np.float32))
    return u, f


# --- the plans ----------------------------------------------------------------------------

def _depths(n, shards):
    """The shard depths a level of n planes takes on ``shards`` z-shards: the
    port's split, and JAX's planes per device (the windows' routing)."""
    rows = S.split_bounds(n, shards)
    return sorted({b - a for a, b in rows} | {M.padded_depth3(n, shards) // shards})


@pytest.mark.parametrize("n", [33, 64, 65, 128, 129, 256, 257, 513])
def test_fixed_mode_plans_fit_the_column_pass(n):
    """err_plan3 of the level (the whole-grid fixed modes, the CLI's 256³
    and 128³ levels among them) and of every shard depth on 2-16 z-shards
    (the shard modes and kernel 19) holds at most 512 cells a tile and an
    even z chunk; the forced tiles of the card's checks too."""
    plans = [K3.err_plan3(n)]
    for shards in (2, 3, 4, 8, 16):
        if 2 * (n // (2 * shards)) >= 2:
            plans += [K3.err_plan3(nz) for nz in _depths(n, shards)]
    plans += [(6, 10, 6), (8, 16, 10)]
    for ty, tx, cz in plans:
        assert ty * tx <= 512 and cz >= 2 and cz % 2 == 0
    tiles = K3.blocks3(n, *K3.err_plan3(n))
    assert K3.col3_work(tiles) * 8 >= tiles * (K3.WARPS3 * 8 + 4)


# --- kernel 10's fixed-sweep schedule -------------------------------------------------------

def _sweep_planes(src, f_win, geo, lo, hi, h):
    """The sweep of ``src`` on window planes [lo, hi) (global z; planes outside
    the grid or its faces frozen), reading only planes [lo − 1, hi + 1)."""
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
    zin = (gz >= 1) & (gz <= geo.n - 2)
    out = torch.zeros_like(fs)
    out[:, 1:-1, 1:-1] = torch.where(
        zin[:, None, None], (OMEGA3 / 6.0) * (out[:, 1:-1, 1:-1] - (h * h) * fs[:, 1:-1, 1:-1]),
        out[:, 1:-1, 1:-1])
    return out


def _schedule(u_win, f_win, geo, h, steps, from_zero, mode, lagged=False):
    """col3_schedule's passes with the owned planes given (a shard): (owned
    planes of iterate k, raw error or None, which of the scratch windows
    (dst, mid) were written)."""
    n, base = geo.n, geo.z0 - geo.ext
    clean = int(mode == "clean" and not lagged)
    bufs = [torch.full_like(f_win, NAN), torch.full_like(f_win, NAN)]
    it = {s: bufs[(steps - s) % 2] for s in range(1, steps + 1)}   # iterate s's buffer
    if not clean:   # the last iterate goes to the owned planes alone
        it[steps] = torch.full_like(f_win, NAN)
    src, raw = (None if from_zero else u_win), None
    zin = geo.inner(f_win.device)
    written = [False, False]
    for j in range(steps + clean):
        extra = steps + clean - j - 1
        lo, hi = max(geo.z0 - extra, 0), min(geo.z0 + geo.nz + extra, n)
        if j < steps:
            dst = it[j + 1]
            for b, buf in enumerate(bufs):
                written[b] |= dst is buf
            if src is None:
                dst[lo - base:hi - base] = _zero_planes(f_win, geo, lo, hi, h)
            else:
                dst[lo - base:hi - base] = _sweep_planes(src, f_win, geo, lo, hi, h)
            if j == steps - 1 and mode == "gpu":
                prev = torch.zeros_like(f_win) if src is None else src
                raw = K3._raw_error3(dst, prev, f_win, geo, zin, h, "gpu")
            if j == steps - 1 and mode == "clean" and lagged:
                raw = K3._raw_error3(src, src, f_win, geo, zin, h, "clean")
            src = dst
        else:   # the read-only pass: the clean error of iterate k
            raw = K3._raw_error3(src, src, f_win, geo, zin, h, "clean")
    return geo.owned(src).contiguous(), raw, written


def _window(x, geo):
    """x's planes [z0 − ext, z0 + nz + ext), NaN beyond the grid."""
    out = torch.full((geo.nz + 2 * geo.ext, geo.n, geo.n), NAN)
    a, b = max(geo.z0 - geo.ext, 0), min(geo.z0 + geo.nz + geo.ext, geo.n)
    out[a - geo.z0 + geo.ext:b - geo.z0 + geo.ext] = x[a:b]
    return out


@pytest.mark.parametrize("n,z0,nz", [(33, 0, 9), (33, 10, 7), (33, 26, 7), (34, 12, 5),
                                     (33, 0, 33)])
@pytest.mark.parametrize("mode", [None, "clean", "gpu"])
def test_fixed_schedule_matches_the_shard_twin(n, z0, nz, mode):
    """Every sweep count, from_zero on and off: the emulated passes on
    windows of exactly the halo the pass needs (NaN beyond) give the shard
    twin's owned planes and raw error bit for bit."""
    h = 1.0 / (n - 1)
    u, f = _fields(n, 7 + z0)
    for steps in range(1, 9):
        for fz in (False, True):
            stages = steps - int(fz) + int(mode == "clean")
            if stages > 8:
                continue
            ext = 0 if nz == n else max(stages, 1)
            geo = K3.ShardGeo3(n, z0, nz, ext)
            u_win, f_win = _window(u, geo), _window(f, geo)
            got_u, got_raw, written = _schedule(u_win, f_win, geo, h, steps, fz, mode)
            want_u, want_raw = K3.fused_jacobi3_shard_torch(
                torch.nan_to_num(u_win), torch.nan_to_num(f_win), geo, h, steps, OMEGA3, fz,
                mode)
            assert torch.equal(got_u, want_u), (steps, fz)
            # the wrapper allocates exactly the windows the passes write
            assert written == [w is not None for w in K3._windows3(f_win, steps,
                                                                  mode == "clean")]
            if mode is None:
                assert got_raw is None
            else:
                assert torch.equal(got_raw, want_raw), (steps, fz)


@pytest.mark.parametrize("n,z0,nz", [(33, 0, 9), (33, 10, 7), (33, 26, 7), (65, 56, 9)])
@pytest.mark.parametrize("compat", ["clean", "gpu"])
def test_lagged_pass_is_the_trigger_pass_twin(n, z0, nz, compat):
    """One sweep with the error of its input (clean) or result (gpu) on a
    one-plane window: the emulated pass equals ``trigger_pass3_shard_torch``,
    and its clean error is the one-sweep step's error of the same iterate."""
    h = 1.0 / (n - 1)
    u, f = _fields(n, 3 + nz)
    geo = K3.ShardGeo3(n, z0, nz, 1)
    u_win, f_win = _window(u, geo), _window(f, geo)
    got_u, got_raw, written = _schedule(u_win, f_win, geo, h, 1, False, compat, lagged=True)
    assert written == [False, False]   # one pass straight into the owned planes
    want_u, want_raw = K3.trigger_pass3_shard_torch(torch.nan_to_num(u_win),
                                                    torch.nan_to_num(f_win), geo, h, OMEGA3,
                                                    compat)
    assert torch.equal(got_u, want_u) and torch.equal(got_raw, want_raw)
    if compat == "clean":
        # the one-sweep step from u reports the error of its sweep u'; the
        # lagged pass from u' reports the same float
        geo2 = K3.ShardGeo3(n, z0, nz, 2)
        _, step_raw = K3.fused_jacobi3_shard_torch(
            torch.nan_to_num(_window(u, geo2)), torch.nan_to_num(_window(f, geo2)), geo2, h, 1,
            OMEGA3, False, "clean")
        swept = K3.fused_jacobi3_torch(u, f, h, 1, OMEGA3)
        _, lag_raw = K3.trigger_pass3_shard_torch(torch.nan_to_num(_window(swept, geo)),
                                                  torch.nan_to_num(f_win), geo, h, OMEGA3,
                                                  "clean")
        assert torch.equal(step_raw, lag_raw)


# --- kernel 19's ring ------------------------------------------------------------------------

RING3_HALO = R3.RING3_HALO


def _ring_trigger(us, fs, h, compat, trigger, max_sweeps):
    """Kernel 19's loop over the shards of ``us``: (gathered u, err, sweeps)."""
    rows, n = fs.layout.rows, fs.n
    P = len(rows)
    blocks = [us.blocks[s][0].clone() for s in range(P)]
    f_b = [fs.blocks[s][0] for s in range(P)]
    # receive buffers [shard][parity][side], RING3_HALO planes each
    ubuf = [[[torch.full((RING3_HALO, n, n), NAN) for _ in range(2)] for _ in range(2)]
            for _ in range(P)]

    def post(s, blk, par):
        if s > 0:
            ubuf[s - 1][par][1][0] = blk[0]                  # plane z0: the shard above
        if s + 1 < P:
            ubuf[s + 1][par][0][RING3_HALO - 1] = blk[-1]    # plane z1 − 1: the one below

    def window(s, blk, par):
        """Shard s's owned planes of blk between its halo planes of parity par."""
        z0, z1 = rows[s]
        top = ubuf[s][par][0][RING3_HALO - 1:] if z0 > 0 else torch.full((1, n, n), NAN)
        bot = ubuf[s][par][1][:1] if z1 < n else torch.full((1, n, n), NAN)
        return torch.cat([top, blk, bot])

    def fwin(s):
        pad = torch.full((1, n, n), NAN)   # the halo planes' f is not read
        return torch.cat([pad, f_b[s], pad])

    for s in range(P):
        post(s, blocks[s], 0)
    iters = {0: blocks}
    clean = compat == "clean"
    err, k = None, 0
    j = 0
    while True:
        k = j if clean else j + 1
        rpar, wpar = j & 1, (j + 1) & 1
        cur, nxt, raws = iters[j], [], []
        for s in range(P):
            z0, z1 = rows[s]
            geo = K3.ShardGeo3(n, z0, z1 - z0, 1)
            uw, fw = window(s, cur[s], rpar), fwin(s)
            zin = geo.inner(uw.device)
            new = K3._sweep3_ext(uw, fw, zin, h, OMEGA3)
            nxt.append(geo.owned(new).contiguous())
            raws.append(K3._raw_error3(uw if clean else new, uw, fw, geo, zin, h, compat))
        for s in range(P):
            post(s, nxt[s], wpar)
        iters[j + 1] = nxt
        if k >= 1:
            e = halo3.sum_err3(raws, compat, n, h, torch.float32, fs)
            above = k == 1 or bool(torch.abs(e - err) > trigger)
            err = e
            if not (above and k < max_sweeps):
                break
        j += 1
    return torch.cat(iters[k]), err, k


@pytest.mark.parametrize("n,shards", [(33, 2), (33, 3), (33, 8), (65, 4), (65, 8)])
@pytest.mark.parametrize("compat", ["clean", "gpu"])
def test_ring_exchange_matches_the_kernel_19_twin(n, shards, compat):
    """The one-plane-a-side parity exchange, run to a cap and to a trigger
    that stops mid-loop, gives rdma_trigger3_torch's iterate, error and stop
    sweep bit for bit."""
    h = 1.0 / (n - 1)
    u, f = _fields(n, n + shards, 0.01)
    lay = S.z_layout(n, ["cpu"] * shards)
    us, fs = S.shard(u, lay), S.shard(f, lay)
    v, errs = us, []
    for _ in range(14):
        v, e = KS3.sharded_trigger_step3(v, fs, h, OMEGA3, compat)
        errs.append(float(e))
    mid = abs(errs[11] - errs[10])
    for trigger, cap in ((0.0, 1), (0.0, 2), (0.0, 5), (mid, 40)):
        gu, ge, gk = _ring_trigger(us, fs, h, compat, trigger, cap)
        wu, we, wk = R3.rdma_trigger3_torch(us, fs, h, OMEGA3, compat, trigger, cap)
        assert gk == int(wk) and torch.equal(gu, S.gather(wu)) and torch.equal(ge, we), (
            trigger, cap, gk, int(wk))
        if trigger:
            assert 3 <= gk < cap


@pytest.mark.parametrize("n,shards", [(33, 3), (65, 8)])
def test_lagged_loop_is_the_one_sweep_loop(n, shards):
    """The sharded clean trigger node's lagged loop stops where the loop of
    one-sweep error steps stops, with its iterate and error, bit for bit."""
    h = 1.0 / (n - 1)
    u, f = _fields(n, 11 * shards, 0.01)
    lay = S.z_layout(n, ["cpu"] * shards)
    us, fs = S.shard(u, lay), S.shard(f, lay)
    v, errs = us, []
    for _ in range(12):
        v, e = KS3.sharded_trigger_step3(v, fs, h, OMEGA3, "clean")
        errs.append(float(e))
    for trigger, cap in ((0.0, 1), (0.0, 3), (abs(errs[9] - errs[8]), 50)):
        wu, we, wk = trigger_loop(lambda x: KS3.sharded_trigger_step3(x, fs, h, OMEGA3, "clean"),
                                  us, trigger, cap)
        gu, ge, gk = trigger_loop_lagged(
            lambda x: KS3.sharded_trigger_pass3(x, fs, h, OMEGA3, "clean"), us, trigger, cap)
        assert gk == wk and torch.equal(S.gather(gu), S.gather(wu)) and torch.equal(ge, we)
    assert not math.isnan(float(we))
