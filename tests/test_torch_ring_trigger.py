"""The ring trigger kernel 17's loop as batched wavefront passes
(csrc/rdma_trigger.cu), emulated in plain PyTorch on the CPU.

Nothing compiles the CUDA sources here, so these tests hold the kernel's
pass schedule against the loop the card's checks hold it to (chip_smoke.py
G1: ``trigger_loop`` over one-sweep ``sharded_fused_jacobi_err`` launches):

  * the schedule, emulated shard by shard: passes of at most B sweeps (7,
    or a forced B up to the metric's cap, 8 for gpu and 7 for cpu / clean;
    at most the smallest shard's rows less the residual's row), their
    lengths the kernel's next_sweeps (2, 1, then what the last two slopes'
    decay predicts) or, forced, B each; each shard's pass the per-sweep
    wavefront pass of tests/test_torch_wave2.py over its block and H = B
    (+1) halo rows a side taken from its receive slots of the pass's parity,
    which hold the edge rows its neighbours posted after the pass before
    (u_0's and f's before the loop; slots never posted, the scratch blocks
    before they are written and rows beyond the grid NaN); each
    sweep's tile partials summed in sum_partials_kernel's fixed order, the
    shards' sums added in shard order and scaled, the stop rule replayed
    sweep by sweep; a pass that overshoots the stop redone from its input
    with the stop's sweeps, the final iterate in out or tmp;
  * the reference: the one-sweep loop whose shard launches form their
    partials in the kernels' tile order and sum them in the same fixed
    order (what a one-sweep launch of kernel 1 reports on the card). Stop
    sweep, iterate and error equal it bit for bit over every metric, rings
    of 2, 3 and 8 shards with a ragged last shard and shards of exactly H
    rows, stops inside a pass, on a pass's last sweep and at max_sweeps
    with the final iterate in either buffer, every B from 1 to 8, and
    other sequences of pass lengths (the results do not depend on them);
  * the iterate and stop sweep also equal the twins' loop
    (``rdma_trigger_torch``: one-sweep sharded error passes on the CPU)
    bit for bit, and its error to 1e-5 (its sums run in PyTorch's order);
  * the checks see a wrong schedule: a redo that reads the pass's output
    instead of its input, receive slots chosen by the parity of the sweep
    instead of the pass.

A short last pass or a redo runs kb < B sweeps: the kernel runs its B
levels with the ones above kb copying, the emulation a pass of kb sweeps;
both give iterate kb and its partials (the copies' rows are never read).
tests/test_torch_rdma.py's ``test_rdma_trigger_matches_jax_per_pass_loop``
holds the twins' loop against JAX's.
"""

import itertools

import numpy as np
import pytest
import torch

from multigrid_poisson_solver_tpu_torch.ops import kernels as K
from multigrid_poisson_solver_tpu_torch.ops import rdma
from multigrid_poisson_solver_tpu_torch.parallel import sharded as S
from multigrid_poisson_solver_tpu_torch.solver import trigger_loop
from test_torch_wave2 import NAN, OMEGA, _butterfly, _terms, _window, tile_partials, wave_pass

N = 131
LAYOUTS = {  # shard row bounds
    "2": (0, 64, N),                 # a ragged last shard
    "3-first-H": (0, 8, 70, N),      # a first shard of exactly H = 8 rows
    "3-mid-H": (0, 61, 69, N),       # a middle shard of exactly H rows
    "8": tuple(r for r, _ in S.split_bounds(N, 8)) + (N,),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fixed_sum(p):
    """sum_partials_kernel's order: thread t of 256 adds p[t], p[t + 256],
    ... from +0, a butterfly over each warp's 32 thread sums, then one over
    the 8 warp sums in lanes 0..7 (the others +0)."""
    v = torch.zeros(256)
    for i in range(0, len(p), 256):
        c = p[i:i + 256]
        v[:len(c)] = v[:len(c)] + c
    warps = _butterfly(v.reshape(8, 32))[:, 0]
    return _butterfly(torch.cat([warps, torch.zeros(24)]))[0]


def _layout(bounds):
    """The row layout of the shard bounds on the CPU."""
    return S.Layout(N, tuple(zip(bounds[:-1], bounds[1:])), ((0, N),),
                    tuple((torch.device("cpu"),) for _ in bounds[1:]))


def _geo(bounds, s, ext):
    r0, r1 = bounds[s], bounds[s + 1]
    return K.ShardGeo(N, r0, 0, r1 - r0, N, ext, 0)


def _stop(totals, k, err, slopes, trigger, max_sweeps):
    """The kernel's replay of the stop rule over a pass's errors: (stop, the
    last error looked at); stop 0: the loop goes on. ``slopes`` gathers
    |err_k − err_{k−1}|."""
    for j, e in enumerate(totals):
        d = torch.abs(e - err)
        slopes.append(d)
        above = k + j == 0 or bool(d > trigger)
        err = e
        if not (above and k + j + 1 < max_sweeps):
            return j + 1, err
    return 0, err


def next_sweeps(k, slopes, trigger, B):
    """common.cuh's next_sweeps in float32: the 2 sweeps the slope test
    needs, 1, then the sweeps the last two slopes' geometric decay takes to
    reach the trigger, at most B."""
    if k == 0:
        return min(2, B)
    if k < 3:
        return 1
    d1, d0 = np.float32(slopes[-1]), np.float32(slopes[-2])
    rho, t = np.float32(d1 / d0), np.float32(trigger)
    if not (t > 0 and d1 > t and 0 < rho < 1):
        return B
    m = float(np.ceil(np.log(np.float32(t / d1)) / np.log(rho)))
    return 1 if m < 1 else min(B, int(m))


class OneSweepLoop:
    """The reference: ``trigger_loop`` over one-sweep shard launches, each
    shard's raw partial formed in the tile order and summed in the fixed
    order, the raws added in shard order and scaled. The sweeps from u are
    computed once and replayed to every loop on the same data."""

    def __init__(self, u, f, bounds, h, mode):
        self.its, self.errs = [u], []
        self.f, self.bounds, self.h, self.mode = f, bounds, h, mode

    def _sweep(self, v):
        hr = 1 + (self.mode != "gpu")
        blocks, raws = [], []
        for s in range(len(self.bounds) - 1):
            geo = _geo(self.bounds, s, hr)
            ue, fe = _window(v, geo), _window(self.f, geo)
            blk, _ = K.fused_jacobi_shard_torch(ue, fe, geo, self.h, 1, OMEGA, False, self.mode)
            blocks.append(blk)
            raws.append(fixed_sum(tile_partials(_terms(ue, fe, geo, self.h, 1, self.mode,
                                                       False), geo)))
        return torch.cat(blocks), S.psum(raws, _layout(self.bounds)) * K.shard_err_scale(self.mode, N, self.h)

    def step(self, k):
        """(iterate k, its error), k >= 1."""
        while len(self.its) <= k:
            v, e = self._sweep(self.its[-1])
            self.its.append(v)
            self.errs.append(e)
        return self.its[k], self.errs[k - 1]

    def __call__(self, trigger, max_sweeps):
        """trigger_loop's (u, err, sweeps)."""
        k = iter(itertools.count(1))
        return trigger_loop(lambda v: self.step(next(k)), self.its[0], trigger, max_sweeps)

    def trigger_stopping_at(self, stop):
        """A trigger midway between the slopes |err_k − err_{k−1}| of sweeps
        stop − 1 and stop: the loop stops at ``stop`` where they fall."""
        slope = [float(abs(self.step(k)[1] - self.step(k - 1)[1])) for k in (stop - 1, stop)]
        return 0.5 * (slope[0] + slope[1])


def ring_trigger(u, f, bounds, h, mode, trigger, max_sweeps, batch=0, rows=32, mutate=None,
                 lengths=None):
    """The kernel's schedule: (u, err, sweeps, the buffer the final iterate
    ended in: "out" or "tmp", passes, redone). ``batch``: passes of that
    many sweeps (``forced_trigger_batch``); 0: of next_sweeps' lengths, at
    most 7; ``lengths``: of these lengths, one a pass. ``mutate``:
    "redo_output" (the redo reads the pass's output) or "sweep_parity"
    (slots by the parity of the pass's first sweep)."""
    P, res = len(bounds) - 1, int(mode != "gpu")
    rows_min = min(b - a for a, b in zip(bounds[:-1], bounds[1:]))
    B = min(batch or 7, 8 - res, max_sweeps, rows_min - res)
    H = B + res
    scale = K.shard_err_scale(mode, N, h)
    lay = _layout(bounds)
    blk = [u[a:b].clone() for a, b in zip(bounds[:-1], bounds[1:])]
    fb = [f[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    nan = torch.full((H, N), NAN)
    slots = {}                               # (shard, parity, side 0 top / 1 bottom) -> rows

    def post(s, x, par):
        if s > 0:
            slots[s - 1, par, 1] = x[:H].clone()
        if s + 1 < P:
            slots[s + 1, par, 0] = x[-H:].clone()

    def window(s, own, top, bot):
        return torch.cat([top, own, bot])

    f_win = []
    for s in range(P):
        f_win.append(window(s, fb[s], fb[s - 1][-H:] if s > 0 else nan,
                            fb[s + 1][:H] if s + 1 < P else nan))
        post(s, blk[s], 0)
    out = [torch.full_like(b, NAN) for b in blk]
    tmp = [torch.full_like(b, NAN) for b in blk]
    src, dst = blk, out

    def run(p_src, par, sweeps, want_err):
        new, raws = [], []
        for s in range(P):
            ue = window(s, p_src[s], slots.get((s, par, 0), nan), slots.get((s, par, 1), nan))
            got, parts = wave_pass(ue, f_win[s], _geo(bounds, s, H), h, sweeps,
                                   mode if want_err else None, per_sweep=want_err, rows=rows)
            new.append(got)
            if want_err:
                raws.append([fixed_sum(parts[j]) for j in range(sweeps)])
        return new, raws

    k, err, redone, slopes = 0, torch.zeros(()), False, []
    for p in itertools.count():
        if lengths is not None:
            length = min(B, lengths[p % len(lengths)])
        else:
            length = B if batch else next_sweeps(k, slopes, trigger, B)
        kb = min(length, max_sweeps - k)
        par = (k & 1) if mutate == "sweep_parity" else (p & 1)
        new, raws = run(src, par, kb, True)
        for s in range(P):
            dst[s].copy_(new[s])
            post(s, dst[s], ((k + kb) & 1) if mutate == "sweep_parity" else (par ^ 1))
        totals = [S.psum([raws[s][j] for s in range(P)], lay) * scale for j in range(kb)]
        stop, err = _stop(totals, k, err, slopes, trigger, max_sweeps)
        if stop:
            k += stop
            if stop < kb:
                redone = True
                again, _ = run(dst if mutate == "redo_output" else src, par, stop, False)
                for s in range(P):
                    dst[s].copy_(again[s])
            break
        k += kb
        src, dst = dst, (tmp if dst is out else out)
    return torch.cat(dst), err, k, ("out" if dst is out else "tmp"), p + 1, redone


def _uf(seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy((0.01 * rng.standard_normal((N, N))).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((N, N)).astype(np.float32)))


def _same(got, want, what):
    gu, ge, gk = got[:3]
    wu, we, wk = want
    assert gk == wk, f"{what}: {gk} sweeps, the one-sweep loop {wk}"
    assert torch.equal(gu, wu), f"{what}: the iterate differs"
    assert torch.equal(ge, we), f"{what}: error {float(ge)!r} vs {float(we)!r}"


@pytest.mark.parametrize("mode", ["cpu", "clean", "gpu"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_matches_one_sweep_loop(layout, mode):
    """The kernel's own pass lengths: stops at max_sweeps after an odd and
    an even count of passes (the final iterate in out, then in tmp), and
    triggers that stop the loop at B + 2 and 2B sweeps, each bit for bit
    the one-sweep loop; the iterate and stop also the twins' loop's."""
    bounds = LAYOUTS[layout]
    h = 1.0 / (N - 1)
    u, f = _uf(3 * list(LAYOUTS).index(layout) + ("cpu", "clean", "gpu").index(mode))
    B = min(7, min(b - a for a, b in zip(bounds[:-1], bounds[1:])) - (mode != "gpu"))
    ref = OneSweepLoop(u, f, bounds, h, mode)
    seen = set()
    for max_sweeps in (B + 3, 2 * B + 3):
        got = ring_trigger(u, f, bounds, h, mode, 0.0, max_sweeps)
        _same(got, ref(0.0, max_sweeps), f"max {max_sweeps}")
        seen.add(got[3])
    assert seen == {"out", "tmp"}
    for stop in (B + 2, 2 * B):
        trig = ref.trigger_stopping_at(stop)
        got = ring_trigger(u, f, bounds, h, mode, trig, 100)
        want = ref(trig, 100)
        assert want[2] == stop
        _same(got, want, f"trigger {trig:.6g}")
        lay = _layout(bounds)
        tu, te, tk = rdma.rdma_trigger_torch(S.shard(u, lay), S.shard(f, lay), h, OMEGA,
                                             {"cpu": True, "clean": False, "gpu": "gpu"}[mode],
                                             trig, 100)
        assert int(tk) == got[2] and torch.equal(S.gather(tu), got[0])
        assert float(te) == pytest.approx(float(got[1]), rel=1e-5)


@pytest.mark.parametrize("batch", range(1, 9))
def test_every_batch(batch):
    """Forced passes of 1..8 sweeps (the gpu metric; cpu at 7, clean at 5)
    on the ring with a middle shard of H rows (odd B) or on 8 shards: a stop
    at sweep 11 (inside a pass for every B > 1: a redo) and at max_sweeps
    inside the second pass, bit for bit the one-sweep loop."""
    bounds = LAYOUTS["3-mid-H"] if batch % 2 else LAYOUTS["8"]
    mode = {7: "cpu", 5: "clean"}.get(batch, "gpu")
    h = 1.0 / (N - 1)
    u, f = _uf(100 + batch)
    ref = OneSweepLoop(u, f, bounds, h, mode)
    trig = ref.trigger_stopping_at(11)
    for t, max_sweeps in ((trig, 40), (0.0, batch + 2)):
        got = ring_trigger(u, f, bounds, h, mode, t, max_sweeps, batch=batch)
        want = ref(t, max_sweeps)
        assert t == 0.0 or (want[2] == 11 and got[5] == (batch > 1))
        _same(got, want, f"B={batch} trigger {t:.6g} max {max_sweeps}")


@pytest.mark.parametrize("lengths", [(1,), (3, 1, 5), (7, 2), (4, 6, 1, 1)],
                         ids=lambda x: "-".join(map(str, x)))
def test_any_pass_lengths(lengths):
    """Passes of other lengths than next_sweeps' (the clean metric, a middle
    shard of H rows): a stop at sweep 10 and at max_sweeps 13, bit for bit
    the one-sweep loop: the schedule only moves work."""
    bounds = LAYOUTS["3-mid-H"]
    h = 1.0 / (N - 1)
    u, f = _uf(200)
    ref = OneSweepLoop(u, f, bounds, h, "clean")
    for t, max_sweeps in ((ref.trigger_stopping_at(10), 100), (0.0, 13)):
        _same(ring_trigger(u, f, bounds, h, "clean", t, max_sweeps, lengths=lengths),
              ref(t, max_sweeps), f"lengths {lengths} trigger {t:.6g}")


@pytest.mark.parametrize("mutation", ["redo_output", "sweep_parity"])
def test_mutated_schedule_fails(mutation):
    """The emulation tells a wrong schedule from the kernel's: a redo of the
    pass's output, or slots by the sweep's parity (passes of 4 sweeps, so
    every pass starts on an even sweep), changes the iterate or the stop
    (a stop inside the third pass); unmutated it matches."""
    bounds = LAYOUTS["3-mid-H"]
    h = 1.0 / (N - 1)
    u, f = _uf(7)
    ref = OneSweepLoop(u, f, bounds, h, "clean")
    want = ref(ref.trigger_stopping_at(10), 100)
    assert want[2] == 10
    trig = ref.trigger_stopping_at(10)

    def matches(mutate):
        got = ring_trigger(u, f, bounds, h, "clean", trig, 100, batch=4, mutate=mutate)
        return (got[2] == want[2] and torch.equal(got[0], want[0])
                and torch.equal(got[1], want[1]))

    assert matches(None)
    assert not matches(mutation), f"the {mutation} mutation went unseen"
