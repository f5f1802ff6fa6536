"""The port's 3-D trigger kernels and the smoother's per-sweep-error mode
(multigrid_poisson_solver_tpu_torch.ops.kernels3) against the JAX package's
Pallas kernels (ops/pallas3d.py), run in interpret mode at 33³.

On the CPU every public kernel function runs its plain twin, so these tests
hold the twins against:
  * ``fused_jacobi3_errs_padded`` (the per_sweep mode of
    ``_fused_jacobi3_kernel``), every sweep count up to the cap, both
    metrics, with the VMEM budgets cut so that each call is split into
    several bricks;
  * ``_trigger3_vmem_kernel`` and ``_trigger3_stream_kernel``, through the
    same ``pallas_call`` as ``fused_trigger3_vmem`` / ``fused_trigger3_stream``
    but also reading the sweep count the kernels keep beside the error.

The CUDA kernels are held against the same twins on the card by
chip_smoke.py, and against the loop of one-sweep launches bit for bit.

Tolerances (fp32): the Pallas sweep folds the update into u + a·(Σnb − 6u) −
a·h²f while the twin keeps the oracle's u + (ω/6)·((Σnb − 6u) − h²f), so
iterates differ by a few ulps a sweep: 1e-5·max|u| for one pass, 5e-5 after
the tens of sweeps of a trigger loop. Error scalars are sums over n³ terms in
another order: 1e-4 relative. Sweep counts are equal: the triggers below lie
between two slopes of the loop, far from either (see ``_slopes``).
"""

import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from multigrid_poisson_solver_tpu.models import poisson3d as jp3
from multigrid_poisson_solver_tpu.ops import pallas3d as jp3k
from multigrid_poisson_solver_tpu_torch.ops import kernels as K
from multigrid_poisson_solver_tpu_torch.ops import kernels3 as K3

U_RTOL, LOOP_U_RTOL, ERR_RTOL = 1e-5, 5e-5, 1e-4
OMEGA3 = 6.0 / 7.0
N = 33
H = 1.0 / (N - 1)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    u = np.zeros((N, N, N), np.float32)
    u[1:-1, 1:-1, 1:-1] = rng.standard_normal((N - 2,) * 3) * scale
    return u, rng.standard_normal((N, N, N)).astype(np.float32)


def _problem_data():
    """The reference problem at 33³: the boundary (zero) as u, its source as f."""
    p = jp3.REFERENCE_PROBLEM_3D
    b = np.asarray(p.boundary_grid(N, jnp.float32))
    return b, np.asarray(p.source_grid(N, jnp.float32)) + b


def _jx(a):
    return jp3k.pad_grid3(jnp.asarray(a))


def _th(a):
    return torch.from_numpy(np.array(a))


def _crop(a):
    return np.asarray(a)[:N, :N, :N]


def _assert_close(got, want, rtol):
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("compat,steps", [("clean", s) for s in range(1, 8)]
                         + [("gpu", s) for s in range(1, 9)])
def test_fused_jacobi3_errs_twin_matches_pallas(monkeypatch, compat, steps):
    monkeypatch.setattr(jp3k, "_VMEM_BUDGET_3D_BYTES", 1_500_000)   # several bricks
    u, f = _data(steps + (10 if compat == "gpu" else 0))
    want_u, want_e = jp3k.fused_jacobi3_errs_padded(_jx(u), _jx(f), N, H, steps, omega=OMEGA3,
                                                    compat=compat, interpret=True)
    got_u, got_e = K3.fused_jacobi3_errs_torch(_th(u), _th(f), H, steps, OMEGA3, compat)
    _assert_close(got_u, _crop(want_u), U_RTOL)
    assert got_e.shape == (steps,)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), rtol=ERR_RTOL)


def test_errs_twin_rows_are_the_one_pass_errors():
    """errs[s − 1] is the error a pass of s sweeps reports, bit for bit, and
    the public entry point runs the twin on CPU tensors without a launch."""
    u, f = (_th(a) for a in _data(30))
    K.reset_launch_counts()
    for compat in ("clean", "gpu"):
        cap = K3.errs3_sweep_cap(compat)
        got_u, errs = K3.fused_jacobi3_errs(u, f, H, cap, OMEGA3, compat)
        assert torch.equal(got_u, K3.fused_jacobi3_torch(u, f, H, cap, OMEGA3))
        for s in range(1, cap + 1):
            assert torch.equal(errs[s - 1], K3.fused_jacobi3_err_torch(u, f, H, s, OMEGA3,
                                                                       compat)[1])
    assert not any(K.launches.values())
    with pytest.raises(ValueError, match="1..7"):
        K3.fused_jacobi3_errs(u, f, H, 8, OMEGA3, "clean")
    with pytest.raises(ValueError, match="metric"):
        K3.fused_jacobi3_errs(u, f, H, 2, OMEGA3, "cpu")


# --- the whole-loop trigger kernels ----------------------------------------------

def _jax_trigger3(stream, u, f, trigger, compat, max_sweeps):
    """(u, err, sweeps) of JAX's whole-loop kernel: the pallas_call of
    fused_trigger3_stream / fused_trigger3_vmem, which keep the sweep count
    in their stat output but return only the error."""
    nz, rp, cp = jp3k.padded_shape3(N)
    body = jp3k._trigger3_stream_kernel if stream else jp3k._trigger3_vmem_kernel
    kernel = partial(body, n=N, nz=nz, rp=rp, cp=cp, h2=H * H, omega=OMEGA3, trigger=trigger,
                     compat=compat, max_sweeps=max_sweeps)
    vol = pltpu.VMEM((nz, rp, cp), jnp.float32)
    scratch = ([vol, pltpu.VMEM((3, jp3k.ZB3, rp, cp), jnp.float32),
                pltpu.VMEM((rp, cp), jnp.float32), pltpu.SemaphoreType.DMA,
                pltpu.SemaphoreType.DMA((3,))] if stream
               else [vol, vol, vol, pltpu.SemaphoreType.DMA])
    out, stat = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((nz, rp, cp), jnp.float32),
                   jax.ShapeDtypeStruct((1, 2), jnp.float32)),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 2,
        out_specs=(pl.BlockSpec(memory_space=pl.ANY), pl.BlockSpec(memory_space=pltpu.SMEM)),
        scratch_shapes=scratch, interpret=True)(_jx(u), _jx(f))
    stat = np.asarray(stat)
    return _crop(out), float(stat[0, 0]), int(stat[0, 1])


def _slopes(u, f, compat, count):
    """|err_k − err_{k−1}|, k = 2..count, of the twin's loop."""
    v, errs = _th(u), []
    for _ in range(count):
        v, e = K3.fused_jacobi3_err_torch(v, _th(f), H, 1, OMEGA3, compat)
        errs.append(float(e))
    return np.abs(np.diff(errs))


def test_jax_trigger3_reader_is_the_wrapper():
    """The pallas_call above is JAX's own: the same iterate and error."""
    u, f = _problem_data()
    got_u, got_e, _ = _jax_trigger3(False, u, f, 0.3, "clean", 40)
    want_u, want_e = jp3k.fused_trigger3_vmem(_jx(u), _jx(f), N, H, 0.3, OMEGA3, "clean", 40,
                                              interpret=True)
    np.testing.assert_array_equal(got_u, _crop(want_u))
    assert got_e == float(want_e)


# triggers between two slopes of the reference problem's loop at 33³ (clean:
# 0.30509 / 0.30006 at sweeps 25 / 26; gpu: 0.27946 / 0.27486 at sweeps
# 22 / 23), a cap that ends the loop first, and a trigger of 0 that runs to
# the cap
TRIGGER_CASES = [("clean", 0.3025, 60, 26), ("gpu", 0.2775, 60, 23), ("clean", 0.3025, 13, 13),
                 ("gpu", 0.0, 9, 9)]


@pytest.mark.parametrize("stream", [False, True], ids=["vmem", "stream"])
@pytest.mark.parametrize("compat,trigger,max_sweeps,want", TRIGGER_CASES)
def test_trigger3_twin_matches_pallas(stream, compat, trigger, max_sweeps, want):
    u, f = _problem_data()
    slopes = _slopes(u, f, compat, min(max_sweeps, 30))
    if trigger > 0 and want < max_sweeps:
        # the stop is no near thing: the slopes around it are 1% off the trigger
        assert slopes[want - 3] > 1.005 * trigger > trigger > 1.005 * slopes[want - 2]
    ju, je, jk = _jax_trigger3(stream, u, f, trigger, compat, max_sweeps)
    fn = K3.trigger_smooth3_stream if stream else K3.trigger_smooth3
    gu, ge, gk = fn(_th(u), _th(f), H, OMEGA3, compat, trigger, max_sweeps)
    assert int(gk) == jk == want
    _assert_close(gu, ju, LOOP_U_RTOL)
    assert float(ge) == pytest.approx(je, rel=ERR_RTOL)


def test_trigger3_entry_points_run_the_twin_on_cpu_tensors():
    u, f = (_th(a) for a in _data(40, 0.01))
    K.reset_launch_counts()
    want = K3.trigger_smooth3_torch(u, f, H, OMEGA3, "gpu", 1e-3, 30)
    for fn in (K3.trigger_smooth3, K3.trigger_smooth3_stream):
        for a, b in zip(fn(u, f, H, OMEGA3, "gpu", 1e-3, 30), want):
            assert torch.equal(a, b)
    for a, b in zip(K3.trigger_step3(u, f, H, OMEGA3, "gpu"),
                    K3.trigger_step3_torch(u, f, H, OMEGA3, "gpu")):
        assert torch.equal(a, b)
    assert want[2].dtype == torch.int32 and not any(K.launches.values())
    assert {"jacobi3_errs", "trigger3", "trigger3_stream", "residual_mw3"} <= set(K.launches)
    with pytest.raises(ValueError, match="metric"):
        K3.trigger_smooth3(u, f, H, OMEGA3, "cpu")


def test_err_plan3_fits_every_error_launch():
    """One plan for every launch that measures an error: it fits the deepest
    per-sweep pass (8 stages, halo 8), hence every shallower pipeline."""
    for n in (65, 129, 257, 513):
        ty, tx, cz = K3.err_plan3(n)
        assert (ty, tx, cz) == K3.plan3(n, 8, 8)
        for stages in range(1, 9):
            assert K3.smem3(stages, stages, ty, tx) <= K3.smem3(8, 8, ty, tx) <= K3.SMEM_MAX3
        assert (ty + 16) * (tx + 16) <= K3.PLANE_MAX3


def _header_int(name, header):
    from multigrid_poisson_solver_tpu_torch.ops import build

    text = (build.CSRC / header).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_col3_constants_match_the_headers():
    """The column pass (csrc/col3.cuh) splits block_sum3's 512 threads, 16
    warps, over whole warps of its blocks; kernels3.WARPS3 sizes its
    workspace by the same count."""
    threads3 = _header_int("BLOCK_X", "common.cuh") * _header_int("BLOCK3_Y", "col3.cuh")
    col_threads = _header_int("COL3_THREADS", "col3.cuh")
    assert threads3 == 512 and K3.WARPS3 == threads3 // 32
    assert col_threads % 32 == 0 and threads3 % col_threads == 0


@pytest.mark.parametrize("n,nz", [(65, None), (129, None), (170, None), (257, None),
                                  (513, None), (513, 64), (513, 65), (65, 8), (65, 9)])
def test_col3_workspace_holds_the_warp_sums_and_counters(n, nz):
    """col3_work(tiles) float64 words: 16 warp sums a tile, then a 32-bit
    arrival counter a tile, and no more than one word of slack; the tile
    count is the error plan's (a shard's plan over its own depth)."""
    plan = K3.err_plan3(n if nz is None else nz)
    tiles = K3.blocks3(n, *plan, nz=nz)
    need = tiles * K3.WARPS3 * 8 + tiles * 4
    assert 0 <= K3.col3_work(tiles) * 8 - need < 8


@pytest.mark.parametrize("n", [65, 129, 170, 257, 513])
def test_err_plan3_tiles_fit_the_column_pass(n):
    """The column pass gives each cell of an error tile one thread of
    block_sum3's 512, so the trigger loops' plan (and the forced tiles the
    card's checks use) may hold at most 512 cells a tile."""
    ty, tx, _ = K3.err_plan3(n)
    assert ty * tx <= 512
    for ty, tx, _ in ((6, 10, 6), (8, 16, 10)):
        assert ty * tx <= 512
