"""The 2-D whole-loop trigger kernels 8 and 9 (csrc/trigger.cu,
csrc/trigger_stream.cu), emulated in plain PyTorch on the CPU.

Nothing compiles the CUDA sources here, so these tests hold each route's
schedule against the loop the card's checks hold it to (chip_smoke.py phase
2): ``trigger_loop`` over one-sweep launches of kernel 1, whose error is its
tile partials (legs.cuh's order, tests/test_torch_wave2.py) summed in
sum_partials_kernel's order and scaled.

  * Route A, levels n <= 257 in one thread block cluster: block q's band of
    whole tile rows (block 0 alone for n <= 65) in slots of f and three
    iterates (u_j in slot j mod 3), unwritten slots NaN; a pass reads the
    rows beside its band as the neighbours formed them in the pass before
    (the kernel has them pushed into its halo rows), forms each tile's
    error terms from the same stencil read (the cpu and clean errors of the
    iterate read, a pass behind; the gpu error |u_{j+1} − u_j| of the one
    written), sums them in the tile block's order and pushes the partial into
    every block's copy of the pass's partial array; in the next pass each
    block sums its copy in the fixed order (every copy the same) and takes
    the stop decision, which the pass after reads: the result is the slot of
    the stop's iterate, two passes behind the last one formed.
  * The tile loop between 257² and 1.5 M cells is the parent design's
    (legs.cuh's jacobi_tile a sweep); only its route rule is mirrored here.
  * Route B, from 1.5 M cells (and kernel 9): wavefront passes of
    next_sweeps' lengths (or a forced B each), each sweep's row of partials
    summed and the stop rule replayed sweep by sweep, a pass that overshoots
    the stop redone from its intact input, the final iterate in out or the
    scratch grid (copied). The pass itself is tests/test_torch_wave2.py's;
    here its iterates come from the twin one sweep at a time, its partials
    from the tile order.
  * Mutations that must show: a partial summed in another order, the cpu
    error taken one iterate off (no lag), u_{k+1} returned after a lagged
    stop, and route B's redo from the pass's output.
  * The plain twin ``trigger_smooth_torch`` against JAX's
    ``fused_trigger_vmem`` / ``fused_trigger_stream`` in interpret mode at
    the sizes each route takes.
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
from multigrid_poisson_solver_tpu_torch.ops import stencils
from test_torch_wave2 import OMEGA, _butterfly, tile_partials

TILE_H, TILE_W = 32, 128
CTAS, SOLO, SPLIT = 8, 65, 257   # TAIL_CTAS, TAIL_SOLO, CHAIN_SPLIT (chain_tail.cuh)
NAN = float("nan")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _grids(n, seed, f_scale=1.0):
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    f = torch.from_numpy((f_scale * rng.standard_normal((n, n))).astype(np.float32))
    return u, f


def _tiles(n):
    return -(-n // TILE_H) * -(-n // TILE_W)


def fixed_sum(p):
    """sum_partials_kernel's order (common.cuh's warp_block_sum plays it in
    one warp): thread t of 256 adds p[t], p[t + 256], ... from +0, a
    butterfly over each warp's 32, then one over the 8 warp sums in lanes
    0..7 (the others +0)."""
    v = torch.zeros(256)
    for i in range(0, len(p), 256):
        c = p[i:i + 256]
        v[:len(c)] = v[:len(c)] + c
    warps = _butterfly(v.reshape(8, 32))[:, 0]
    return _butterfly(torch.cat([warps, torch.zeros(24)]))[0]


def _f32(x):
    return torch.tensor(np.float32(x))


def _scale(mode, n, h):
    return _f32(K._err_scale(mode, n, h))


def _terms(prev, cur, f, h, mode):
    """kernel 1's error terms of ``cur`` (|r| or |cur − prev|) on the
    interior (the even color for cpu), 0 elsewhere."""
    n = cur.shape[0]
    if mode == "gpu":
        v = (cur - prev).abs()
    else:
        v = stencils.residual(cur, f, h).abs()
    take = torch.zeros(n, n, dtype=torch.bool)
    take[1:-1, 1:-1] = True
    if mode == "cpu":
        i = torch.arange(n)
        take &= (i[:, None] + i[None, :]) % 2 == 0
    return torch.where(take, v, torch.zeros(()))


class OneSweepLoop:
    """The reference: ``trigger_loop`` over one-sweep launches of kernel 1
    (the twin's iterate; the error its tile partials in the fixed order,
    scaled). Iterates and errors are computed once and replayed to every
    loop on the same data."""

    def __init__(self, u, f, h, mode):
        self.its, self.errs = [u], [None]
        self.f, self.h, self.mode = f, h, mode
        self.geo = K.ShardGeo(u.shape[0], 0, 0, u.shape[0], u.shape[0])
        self.scale = _scale(mode, u.shape[0], h)

    def it(self, k):
        while len(self.its) <= k:
            prev = self.its[-1]
            cur = K.fused_jacobi_torch(prev, self.f, self.h, 1, OMEGA)
            self.its.append(cur)
            parts = tile_partials(_terms(prev, cur, self.f, self.h, self.mode), self.geo)
            self.errs.append(fixed_sum(parts) * self.scale)
        return self.its[k]

    def err(self, k):
        self.it(k)
        return self.errs[k]

    def run(self, trigger, max_sweeps):
        k, err, above = 1, self.err(1), True
        while above and k < max_sweeps:
            e = self.err(k + 1)
            above = bool(torch.abs(e - err) > _f32(trigger))
            err, k = e, k + 1
        return self.it(k), err, k


# --- route A: the cluster ------------------------------------------------------------------------

def trig_lo(n, q):
    """trigger.cu's trig_lo: block q's first row (whole tile rows; block 0
    alone at n <= TAIL_SOLO)."""
    if n <= SOLO:
        return n if q > 0 else 0
    return n if q >= CTAS or q * TILE_H > n else q * TILE_H


def _owner(n, gi):
    return 0 if n <= SOLO else min(gi // TILE_H, CTAS - 1)


def _group_partials(terms, n, lo, rows, mutate):
    """Each tile of the band as its group sums it: tile_partials' order, or
    (mutate "order") each thread adding a tile row's four columns before
    moving down (columns outer)."""
    if mutate != "order":
        return tile_partials(terms, K.ShardGeo(n, lo, 0, rows, n))
    ty, tx = -(-rows // TILE_H), -(-n // TILE_W)
    v = torch.zeros(ty * TILE_H, tx * TILE_W)
    v[:rows, :n] = terms
    v = v.reshape(ty, TILE_H, tx, TILE_W).permute(0, 2, 1, 3).reshape(ty * tx, 4, 8, 4, 32)
    acc = torch.zeros(ty * tx, 8, 32)
    for q in range(4):
        for m in range(4):
            acc = acc + v[:, m, :, q, :]
    warp_sums = _butterfly(acc)[:, :, 0]
    return _butterfly(torch.cat([warp_sums, torch.zeros(ty * tx, 24)], dim=1))[:, 0]


def cluster_loop(u, f, h, mode, trigger, max_sweeps, mutate=None):
    """Route A's loop, block by block: (u, err, sweeps)."""
    n = u.shape[0]
    blocks = 1 if n <= SOLO else CTAS
    bands = [(trig_lo(n, q), trig_lo(n, q + 1)) for q in range(blocks)]
    count, tx_n = _tiles(n), -(-n // TILE_W)
    assert count <= 32 and max(hi - lo for lo, hi in bands) <= (n if n <= SOLO else 33)
    slots = [[u[lo:hi].clone()] + [torch.full((hi - lo, n), NAN) for _ in range(2)]
             for lo, hi in bands]
    fb = [f[lo:hi] for lo, hi in bands]
    parts = [[torch.full((32,), NAN), torch.full((32,), NAN)] for _ in bands]
    dec_err, dec_go = [None, None], [None, None]
    lag = 0 if mode == "gpu" or mutate == "lag" else 1
    h2, inv_h2 = _f32(h * h), _f32(1.0 / (h * h))
    scale, trig = _scale(mode, n, h), _f32(trigger)
    gi_all = torch.arange(n)
    err, k, j = _f32(0.0), 0, 0
    while True:
        # the decision on sweep j − 1 − lag, taken in pass j − 1
        if j >= 2 + lag and not dec_go[(j - 1) & 1]:
            k, err = j - 1 - lag, dec_err[(j - 1) & 1]
            break
        want = lag == 0 or j > 0
        cur, nxt = j % 3, (j + 1) % 3
        for q, (lo, hi) in enumerate(bands):
            rows = hi - lo
            if rows == 0:
                continue

            def row(gi):   # row gi of the swept iterate, from the block that holds it
                if gi < 0 or gi >= n:
                    return torch.full((1, n), NAN)
                r = _owner(n, gi)
                return slots[r][cur][gi - bands[r][0]].reshape(1, n)

            src = slots[q][cur]
            ext = torch.cat([row(lo - 1), src, row(hi)])
            nb = ext[:-2, 1:-1] + ext[2:, 1:-1] + ext[1:-1, :-2] + ext[1:-1, 2:]
            uc, fc = src[:, 1:-1], fb[q][:, 1:-1]
            new = uc + OMEGA * (0.25 * (nb - 4.0 * uc - h2 * fc))
            gi = gi_all[lo:hi]
            inside = ((gi >= 1) & (gi <= n - 2))[:, None].expand(rows, n - 2)
            v = src.clone()
            v[:, 1:-1] = torch.where(inside, new, uc)
            slots[q][nxt] = v
            if not want:
                continue
            if mode == "gpu":
                term = (new - uc).abs()
            else:
                term = (inv_h2 * (nb - 4.0 * uc) - fc).abs()
            take = inside.clone()
            if mode == "cpu":
                take &= (gi[:, None] + gi_all[None, 1:-1]) % 2 == 0
            terms = torch.zeros(rows, n)
            terms[:, 1:-1] = torch.where(take, term, torch.zeros(()))
            local = _group_partials(terms, n, lo, rows, mutate)
            ty0 = lo // TILE_H
            for t, p in enumerate(local):
                tile = (ty0 + t // tx_n) * tx_n + t % tx_n
                for copy in parts:
                    copy[j & 1][tile] = p
        if j >= 1 + lag:
            # every block's warp 16: sweep j − lag's error from pass j − 1
            kk = j - lag
            totals = [fixed_sum(p[(j - 1) & 1][:count]) for p in parts]
            assert all(torch.equal(t, totals[0]) for t in totals), "blocks disagree"
            e = totals[0] * scale
            assert not torch.isnan(e), f"sweep {kk}: a partial was never pushed"
            dec_go[j & 1] = (kk == 1 or bool(torch.abs(e - err) > trig)) and kk < max_sweeps
            dec_err[j & 1], err = e, e
        j += 1
    slot = (k + 1) % 3 if mutate == "slot" else k % 3
    return torch.cat([s[slot] for s in slots]), err, k


def _same(got, want, what):
    gu, ge, gk = got
    wu, we, wk = want
    assert gk == wk, f"{what}: {gk} sweeps vs {wk}"
    assert torch.equal(ge, we), f"{what}: error {float(ge):.9e} vs {float(we):.9e}"
    assert torch.equal(gu, wu), f"{what}: iterate differs"


def _loops(loop, cap):
    """(trigger, max_sweeps) of loops that stop at max_sweeps 1, 2 and a cap,
    at sweep 2 (a trigger no slope exceeds) and inside the loop (a trigger
    below the first slope)."""
    d = float(torch.abs(loop.err(2) - loop.err(1)))
    return [(0.0, 1), (0.0, 2), (0.0, cap), (1e30, 100), (d * 0.05, 200)]


MODES = ["cpu", "clean", "gpu"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [16, 65, 128, 129, 131, 256, 257])
def test_cluster_route_is_the_one_sweep_loop(n, mode):
    """Route A at every band layout it takes (block 0 alone at 16² and 65²;
    4 and 5 busy blocks at 128²-131², the last one ragged at 131²; 8 at
    256², the last with 33 rows at 257²): iterate, error and stop sweep bit
    for bit the one-sweep loop's, for every max_sweeps and stop."""
    h = 1.0 / (n - 1)
    u, f = _grids(n, n)
    ref = OneSweepLoop(u, f, h, mode)
    stops = []
    for trigger, max_sweeps in _loops(ref, 9):
        want = ref.run(trigger, max_sweeps)
        _same(cluster_loop(u, f, h, mode, trigger, max_sweeps), want,
              f"n={n} {mode} trigger={trigger:g} max={max_sweeps}")
        stops.append(want[2])
    assert stops[:4] == [1, 2, 9, 2] and 2 < stops[4] < 200


@pytest.mark.parametrize("mutation,n", [("order", 65), ("lag", 129), ("slot", 129)])
def test_cluster_mutations_show(mutation, n):
    """A partial summed columns first, the cpu error of u_{k−1} reported as
    sweep k's (no lag), and u_{k+1} returned after the lagged stop: each
    changes what some loop returns (the error at max_sweeps 1..6, or a
    trigger's stop), while unmutated every loop is the one-sweep loop's. (A
    partial's last bit often rounds away in a sum of many: the order
    mutation shows on 65², block 0 alone, three tiles.)"""
    h = 1.0 / (n - 1)
    u, f = _grids(n, 7)
    seen = False
    for mode in ("cpu", "gpu"):
        ref = OneSweepLoop(u, f, h, mode)
        trigger = float(torch.abs(ref.err(2) - ref.err(1))) * 0.05
        for trig, max_sweeps in [(0.0, m) for m in range(1, 7)] + [(trigger, 200)]:
            want = ref.run(trig, max_sweeps)
            _same(cluster_loop(u, f, h, mode, trig, max_sweeps), want, f"unmutated {mode}")
            got = cluster_loop(u, f, h, mode, trig, max_sweeps, mutate=mutation)
            seen |= not (got[2] == want[2] and torch.equal(got[1], want[1])
                         and torch.equal(got[0], want[0]))
    assert seen, f"the {mutation} mutation went unseen"


# --- route B: wavefront passes with an exact replay ----------------------------------------------

def next_sweeps(k, d1, d0, trigger, B):
    """common.cuh's next_sweeps in float32."""
    if k == 0:
        return min(2, B)
    if k < 3:
        return 1
    d1, d0 = np.float32(d1), np.float32(d0)
    rho, t = np.float32(d1 / d0), np.float32(trigger)
    if not (t > 0 and d1 > t and 0 < rho < 1):
        return B
    m = float(np.ceil(np.log(np.float32(t / d1)) / np.log(rho)))
    return 1 if m < 1 else min(B, int(m))


def wave_loop(u, f, h, mode, trigger, max_sweeps, fixed=0, B=7, mutate=None):
    """Route B's loop: (u, err, sweeps, pass lengths, redone)."""
    n = u.shape[0]
    geo = K.ShardGeo(n, 0, 0, n, n)
    out, tmp = torch.full((n, n), NAN), torch.full((n, n), NAN)
    scale, trig = _scale(mode, n, h), _f32(trigger)

    def run_pass(src, sweeps):
        its, raws = [src], []
        for _ in range(sweeps):
            its.append(K.fused_jacobi_torch(its[-1], f, h, 1, OMEGA))
            raws.append(fixed_sum(tile_partials(_terms(its[-2], its[-1], f, h, mode), geo)))
        return its[-1], raws

    src, dst = u, out
    err, d1, d0 = _f32(0.0), _f32(0.0), _f32(0.0)
    k, lens, redone = 0, [], False
    length = fixed or next_sweeps(0, d1, d0, trigger, B)
    while True:
        kb = min(length, max_sweeps - k)
        lens.append(kb)
        fin, raws = run_pass(src, kb)
        dst.copy_(fin)
        stop = 0
        for j, raw in enumerate(raws):
            e = raw * scale
            d = torch.abs(e - err)
            above = k + j == 0 or bool(d > trig)
            d0, d1, err = d1, d, e
            if not (above and k + j + 1 < max_sweeps):
                stop = j + 1
                break
        length = fixed or next_sweeps(k + kb, d1, d0, trigger, B)
        if stop:
            k += stop
            if stop < kb:   # redo from the pass's input
                redone = True
                dst.copy_(run_pass(dst if mutate == "redo" else src, stop)[0])
            break
        k += kb
        src, dst = dst, (tmp if dst is out else out)
    if dst is not out:
        out.copy_(dst)
    return out, err, k, lens, redone


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [65, 300])
def test_wave_route_is_the_one_sweep_loop(n, mode):
    """Route B with next_sweeps' passes (2, 1, then the slopes' prediction,
    which on these data stops at a pass's end): every max_sweeps and stop
    bit for bit the one-sweep loop's; predicted passes of several sweeps,
    and passes of 7 where the slopes do not fall to the trigger."""
    h = 1.0 / (n - 1)
    u, f = _grids(n, 100 + n, f_scale=10.0)
    ref = OneSweepLoop(u, f, h, mode)
    d = float(torch.abs(ref.err(2) - ref.err(1)))
    lengths = set()
    for trigger, max_sweeps in [(0.0, 1), (0.0, 2), (0.0, 3), (0.0, 17), (1e30, 50),
                                (d * 0.3, 300), (d * 0.05, 300), (d * 0.003, 300)]:
        want = ref.run(trigger, max_sweeps)
        gu, ge, gk, lens, _ = wave_loop(u, f, h, mode, trigger, max_sweeps)
        _same((gu, ge, gk), want, f"n={n} {mode} trigger={trigger:g} max={max_sweeps}")
        lengths.update(lens)
    assert 7 in lengths and lengths & {3, 4, 5, 6}


@pytest.mark.parametrize("B", range(1, 8))
def test_wave_route_fixed_passes(B):
    """Forced passes of B sweeps (``forced_trigger_batch``): the same loops,
    stops inside a pass, on its last sweep and at max_sweeps."""
    n, mode = 131, "cpu" if B % 2 else "gpu"
    h = 1.0 / (n - 1)
    u, f = _grids(n, 200 + B, f_scale=10.0)
    ref = OneSweepLoop(u, f, h, mode)
    d = float(torch.abs(ref.err(2) - ref.err(1)))
    redos = 0
    for trigger, max_sweeps in [(0.0, 2 * B), (0.0, 2 * B + 1), (d * 0.05, 300),
                                (d * 0.003, 300), (1e30, 9)]:
        want = ref.run(trigger, max_sweeps)
        got = wave_loop(u, f, h, mode, trigger, max_sweeps, fixed=B)
        _same(got[:3], want, f"B={B} {mode} trigger={trigger:g} max={max_sweeps}")
        assert all(x == B for x in got[3][:-1])
        redos += got[4]
    assert redos > 0 or B == 1


def test_wave_redo_from_the_output_shows():
    """A redo that reads the pass's output instead of its input changes the
    iterate (unmutated it matches), on the first of a few triggers whose
    loop stops inside a pass of 7."""
    n, mode = 131, "clean"
    h = 1.0 / (n - 1)
    u, f = _grids(n, 9, f_scale=10.0)
    ref = OneSweepLoop(u, f, h, mode)
    d = float(torch.abs(ref.err(2) - ref.err(1)))
    for trigger in (d * 0.05, d * 0.02, d * 0.01, d * 0.003):
        got = wave_loop(u, f, h, mode, trigger, 300, fixed=7)
        if got[4]:
            break
    assert got[4], "no loop stopped inside a pass"
    want = ref.run(trigger, 300)
    _same(got[:3], want, "unmutated")
    bad = wave_loop(u, f, h, mode, trigger, 300, fixed=7, mutate="redo")
    assert not torch.equal(bad[0], want[0]), "the redo mutation went unseen"


# --- the plain twins against JAX's kernels ------------------------------------------------------

def _jx(a):
    return layout.pad_grid(jnp.asarray(a))


@pytest.mark.parametrize("n,jax_kernel", [(129, "vmem"), (257, "vmem"), (300, "vmem"),
                                          (300, "stream")])
@pytest.mark.parametrize("compat", [True, "gpu"])
def test_twin_matches_pallas_at_each_routes_sizes(n, jax_kernel, compat):
    """The twin the kernels are held to on the card against JAX's whole-loop
    kernels in interpret mode: route A's sizes (129², 257²) and route B's
    (300², both entry points): the same stop, the iterate to 1e-5·max|u|
    (JAX folds the update, a few ulps a sweep), the error to 1e-4."""
    rng = np.random.default_rng(n)
    u = rng.standard_normal((n, n)).astype(np.float32)
    f = (10 * rng.standard_normal((n, n))).astype(np.float32)
    h = 1.0 / (n - 1)
    fn = pc.fused_trigger_vmem if jax_kernel == "vmem" else pc.fused_trigger_stream
    want_u, want_e = fn(_jx(u), _jx(f), n, h, 30.0, 0.8, compat, 200, interpret=True)
    got_u, got_e, sweeps = K.trigger_smooth_torch(torch.from_numpy(u), torch.from_numpy(f), h,
                                                  0.8, compat, 30.0, 200)
    assert 1 < int(sweeps) < 200
    want_u = np.asarray(want_u)[:n, :n]
    np.testing.assert_allclose(got_u.numpy(), want_u, rtol=0,
                               atol=1e-5 * float(np.abs(want_u).max()))
    assert float(got_e) == pytest.approx(float(want_e), rel=1e-4)


def trigger_route(n):
    """csrc/trigger.cu's size rule for kernel 8: the cluster to 257², the
    tile loop below 3 · 2^19 cells, the wavefront passes from there."""
    if n <= SPLIT:
        return "cluster"
    return "wave" if n * n >= 3 << 19 else "tile"


def test_route_constants_match_the_source():
    """The emulations' constants and the route rule's mirror are the
    sources': the cluster's split and solo sizes, its bands, the tile
    loop's last size and the passes' longest length."""
    csrc = Path(build.CSRC)
    tail = (csrc / "chain_tail.cuh").read_text()
    assert f"constexpr int TAIL_CTAS = {CTAS};" in tail
    assert re.search(rf"constexpr int TAIL_SOLO = {SOLO};", tail)
    assert f"constexpr int CHAIN_SPLIT = {SPLIT};" in tail
    trig = (csrc / "trigger.cu").read_text()
    assert "constexpr int CLUSTER_MAX_N = CHAIN_SPLIT;" in trig
    assert "return q >= TAIL_CTAS || q * TILE_H > n ? n : q * TILE_H;" in trig
    assert "constexpr long WAVE_MIN_CELLS = 3L << 19;" in trig
    assert "if (n <= CLUSTER_MAX_N) return ROUTE_CLUSTER;" in trig
    assert "return (long)n * n >= WAVE_MIN_CELLS ? ROUTE_WAVE : ROUTE_TILE;" in trig
    wave = (csrc / "trigger_wave.cuh").read_text()
    assert f"constexpr int TRIG_BATCH = {K.TRIGGER_BATCH};" in wave
    assert [trig_lo(257, q) for q in range(9)] == [0, 32, 64, 96, 128, 160, 192, 224, 257]
    assert [trig_lo(131, q) for q in range(9)] == [0, 32, 64, 96, 128, 131, 131, 131, 131]
    # the engine's kernel-8 levels (trigger_fits: n <= 2176) on each route
    assert [trigger_route(n) for n in (16, 257, 258, 513, 1025, 1254, 1255, 2049, 2176)] == \
        ["cluster"] * 2 + ["tile"] * 4 + ["wave"] * 3
    assert K.trigger_fits(2176) and not K.trigger_fits(2177)


@pytest.mark.parametrize("name", ["next_sweeps", "trigger_goes_on", "warp_block_sum"])
def test_trigger_rule_is_defined_once(name):
    """The pass lengths, the stop rule and the one-warp fixed-order sum that
    kernel 8's cluster and the wavefront trigger loops share are defined in
    common.cuh alone, and those loops call them."""
    csrc = Path(build.CSRC)
    defined = re.compile(rf"^static __device__[^(]*\b{name}\(", re.M)
    homes = [p.name for p in sorted(csrc.glob("*.cu*")) if defined.search(p.read_text())]
    assert homes == ["common.cuh"]
    users = {"next_sweeps": ["trigger_wave.cuh"],
             "trigger_goes_on": ["trigger.cu", "trigger_wave.cuh"],
             "warp_block_sum": ["trigger.cu", "trigger_wave.cuh"]}[name]
    for user in users:
        assert f"{name}(" in (csrc / user).read_text(), user
