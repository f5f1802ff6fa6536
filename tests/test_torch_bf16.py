"""bf16 states on kernels 1-4: the port's bf16 twins and engines against the
JAX package's, and the admission rule that keeps every other bf16 path off
the CUDA kernels.

On the CPU every kernel wrapper runs its plain twin, so the twins, run on
bf16 tensors (each op computed in float and rounded to bf16, PyTorch's rule
for a reduced-precision tensor), are held against JAX's Pallas kernels at
bf16 in interpret mode (``fused_jacobi_padded``, ``fused_jacobi_err_padded``,
``residual_pallas``, ``fused_descend_padded`` + ``restrict_lanes_p``,
``fused_ascend_padded`` + ``prolong_lanes_p``), and the bf16 engines
(``compile_program`` through the kernel routing, bf16-inner refinement)
against JAX's. The CUDA kernels' bf16 modes are held bit for bit to these
twins on the card (chip_smoke.py, phase J).

Tolerances, each at most twice the largest difference measured over this
file's cases (CPU, this file's seeds), relative to the reference's max|value|,
and never looser than 2^-5 for a grid. JAX's kernels fold the Jacobi update
into another form, so an iterate differs from the twin's by a few bf16 ulps
(2^-8 relative each): U_TOL (measured ≤ 0.0096). The residual of a bf16
iterate carries its rounding times 1/h², so the descend leg's coarse
right-hand side is compared on JAX's own iterate (the twin with 0 sweeps):
FC_TOL (measured ≤ 0.0169; JAX forms r from an extra sweep's Δ). Error
scalars ERR_TOL (measured ≤ 0.0105: JAX rounds its f32 sum once, the twin's
torch.sum rounds the sum and each scaling). The residual kernel's twin
equals JAX's bit for bit. A bf16 V(3,3) cycle: the iterate within
CYCLE_TOL after the first cycle (measured ≤ 0.0139), its finest error
within CYCLE_ERR_TOL (measured ≤ 0.068: a residual-based sum over an
iterate that differs by CYCLE_TOL, amplified by 1/h²); warm bf16 cycles are
dominated by each implementation's own rounding noise (13-65% apart after
the second and third, tests/test_dtypes.py's "chaining floors"), so chained
cycles are held to JAX's bound at 65² and, at 513², to JAX's growth (the
last two tests). Refinement: equal cycle counts, final relative residuals within
REL_TOL (measured 0.57 and 0.71 relative at their 1e-10 and 1e-8 stops: a
residual one cycle below the target).
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multigrid_poisson_solver_tpu as jmg
import multigrid_poisson_solver_tpu_torch as tmg
from multigrid_poisson_solver_tpu.ops import layout
from multigrid_poisson_solver_tpu.ops import padded as P
from multigrid_poisson_solver_tpu.ops import pallas_kernels as pk
from multigrid_poisson_solver_tpu_torch import compiled, compiled3
from multigrid_poisson_solver_tpu_torch.convert import (config_from_jax, grid_from_jax,
                                                        problem_from_jax_grids, program_from_jax)
from multigrid_poisson_solver_tpu_torch.ops import kernels as K
from multigrid_poisson_solver_tpu_torch.parallel.mesh import ShardingPolicy, make_mesh
from multigrid_poisson_solver_tpu_torch.schedule import Ascend, CoarseSolve, CycleProgram, Descend

OMEGA = 0.8
BF16 = torch.bfloat16
U_TOL = 2.0 ** -6
FC_TOL = 2.0 ** -5
ERR_TOL = 2.0 ** -6
CYCLE_TOL = 2.0 ** -6
CYCLE_ERR_TOL = 0.1
REL_TOL = 0.8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _grids(n, count, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, n)).astype(np.float32) for _ in range(count)]


def _jx(a):
    return layout.pad_grid(jnp.asarray(a, jnp.bfloat16))


def _th(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(BF16)


def _close(got, want, tol):
    """max|got − want| ≤ tol·max|want|, both bf16 of the same shape."""
    assert got.dtype == want.dtype == BF16 and got.shape == want.shape
    diff = float((got.float() - want.float()).abs().max())
    assert diff <= tol * float(want.float().abs().max()), diff


def _err_close(got, want):
    assert got.dtype == BF16
    assert float(got) == pytest.approx(float(want), rel=ERR_TOL)


# --- the twins against JAX's Pallas kernels at bf16 ------------------------------------------

@pytest.mark.parametrize("n", [65, 129])
@pytest.mark.parametrize("steps,from_zero", [(3, False), (8, False), (1, True), (5, True)])
def test_fused_jacobi_twin_matches_pallas_bf16(n, steps, from_zero):
    u, f = _grids(n, 2, seed=n + steps)
    if from_zero:
        u = np.zeros_like(u)
    h = 1.0 / (n - 1)
    want = pk.fused_jacobi_padded(_jx(u), _jx(f), n, h, steps, omega=OMEGA,
                                  from_zero=from_zero, interpret=True)
    got = K.fused_jacobi(_th(u), _th(f), h, steps, OMEGA, from_zero)
    _close(got, grid_from_jax(want, n), U_TOL)


@pytest.mark.parametrize("n,steps,from_zero", [(65, 3, False), (129, 8, False), (65, 1, True),
                                               (129, 5, True)])
@pytest.mark.parametrize("compat", [True, False, "gpu"])
def test_fused_jacobi_err_twin_matches_pallas_bf16(n, steps, from_zero, compat):
    u, f = _grids(n, 2, seed=2 * n + steps)
    if from_zero:
        u = np.zeros_like(u)
    h = 1.0 / (n - 1)
    want_u, want_err = pk.fused_jacobi_err_padded(_jx(u), _jx(f), n, h, steps, omega=OMEGA,
                                                  compat=compat, from_zero=from_zero,
                                                  interpret=True)
    got_u, got_err = K.fused_jacobi_err(_th(u), _th(f), h, steps, OMEGA, compat, from_zero)
    _close(got_u, grid_from_jax(want_u, n), U_TOL)
    assert want_err.dtype == jnp.bfloat16
    _err_close(got_err, want_err)


@pytest.mark.parametrize("n", [65, 129])
@pytest.mark.parametrize("negate", [False, True])
def test_residual_twin_matches_pallas_bf16(n, negate):
    u, f = _grids(n, 2, seed=3 * n)
    h = 1.0 / (n - 1)
    want = pk.residual_pallas(_jx(u), _jx(f), n, h, negate=negate, interpret=True)
    got = K.residual(_th(u), _th(f), h, negate)
    assert got.dtype == BF16 and torch.equal(got, grid_from_jax(want, n))


@pytest.mark.parametrize("restriction", ["sampling", "full_weighting"])
@pytest.mark.parametrize("n,steps,compat,from_zero", [(65, 3, True, False), (65, 1, False, True),
                                                      (129, 6, "gpu", False),
                                                      (129, 3, True, True)])
def test_fused_descend_twin_matches_pallas_bf16(n, steps, compat, from_zero, restriction):
    u, f = _grids(n, 2, seed=4 * n + steps)
    if from_zero:
        u = np.zeros_like(u)
    m, h = (n + 1) // 2, 1.0 / (n - 1)
    want_u, dwide, want_err = pk.fused_descend_padded(
        _jx(u), _jx(f), n, h, steps, omega=OMEGA, restriction=restriction, compat=compat,
        want_err=True, from_zero=from_zero, interpret=True)
    want_fc = P.restrict_lanes_p(dwide, n, m, layout.padded_shape(m))
    got_u, got_fc, got_err = K.fused_descend(_th(u), _th(f), h, steps, OMEGA, restriction,
                                             compat, True, from_zero)
    ju = grid_from_jax(want_u, n)
    _close(got_u, ju, U_TOL)
    assert got_fc.dtype == BF16 and got_fc.shape == (m, m)
    # the leg's −r and restriction on JAX's own iterate: 0 sweeps of the twin
    _, fc_of_ju, _ = K.fused_descend(ju, _th(f), h, 0, OMEGA, restriction)
    _close(fc_of_ju, grid_from_jax(want_fc, m), FC_TOL)
    _err_close(got_err, want_err)


@pytest.mark.parametrize("n,steps,want_err,compat", [(65, 3, False, True), (65, 3, True, False),
                                                     (129, 7, True, True),
                                                     (129, 8, True, "gpu")])
def test_fused_ascend_twin_matches_pallas_bf16(n, steps, want_err, compat):
    uf, f = _grids(n, 2, seed=5 * n + steps)
    m, h = (n + 1) // 2, 1.0 / (n - 1)
    uc = np.random.default_rng(n).standard_normal((m, m)).astype(np.float32)
    uc[0, :] = uc[-1, :] = uc[:, 0] = uc[:, -1] = 0
    ufp = _jx(uf)
    rp, cp = ufp.shape
    cwide = P.prolong_lanes_p(_jx(uc), m, n, (rp // 2 + 8, cp))
    want_u, want_e = pk.fused_ascend_padded(ufp, _jx(f), cwide, n, h, steps, omega=OMEGA,
                                            compat=compat, want_err=want_err, interpret=True)
    got_u, got_e = K.fused_ascend(_th(uf), _th(f), _th(uc), h, steps, OMEGA, compat, want_err)
    _close(got_u, grid_from_jax(want_u, n), U_TOL)
    if want_err:
        _err_close(got_e, want_e)
    else:
        assert got_e is None


# --- the bf16 engines against JAX's ----------------------------------------------------------

@pytest.mark.parametrize("n,routed", [(65, True), (129, True), (129, False)])
def test_compiled_cycle_bf16_matches_jax(monkeypatch, n, routed):
    """The bf16 V(3,3) (ω 0.8, coarsen=3, dense coarse solve) through the
    kernel routing (the fused legs level by level, never the chains: their
    twins on CPU tensors) and through the plain path, against JAX's bf16
    engine (XLA): the first cycle's iterate within CYCLE_TOL, its error
    within CYCLE_ERR_TOL; a warm cycle runs the same routes."""
    calls = {"fused_descend": 0, "fused_ascend": 0, "chain_descend": 0}
    if routed:
        monkeypatch.setattr(compiled, "_use_kernels", lambda cfg, device: True)
        for name in calls:
            fn = getattr(K, name)
            monkeypatch.setattr(K, name, lambda *a, _n=name, _f=fn, **kw: (
                calls.__setitem__(_n, calls[_n] + 1), _f(*a, **kw))[1])
    jprogram = jmg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=3)
    jcfg = jmg.SolverConfig(dtype=jnp.bfloat16, omega=OMEGA, kernels="xla",
                            collect_node_stats=False)
    jcold = jmg.compile_program(jprogram, jmg.REFERENCE_PROBLEM, jcfg, donate=False)
    ju, jf = jcold.init()
    ju, je = jcold(ju, jf)
    program, cfg = program_from_jax(jprogram), config_from_jax(jcfg)
    cold = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cpu")
    warm = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cpu", warm=True)
    u, f = cold.init()
    u, err = cold(u, f)
    assert u.dtype == f.dtype == err.dtype == BF16
    _close(u, grid_from_jax(ju, n), CYCLE_TOL)
    assert float(err) == pytest.approx(float(je), rel=CYCLE_ERR_TOL)
    u2, err2 = warm(u, f)
    assert u2.dtype == BF16 and bool(torch.isfinite(u2.float()).all())
    levels = len(jprogram.instructions) // 2
    if routed:
        assert calls == {"fused_descend": 2 * levels, "fused_ascend": 2 * levels,
                         "chain_descend": 0}


@pytest.mark.parametrize("n,state", [(65, "tw32"), (129, "df32")])
def test_refine_bf16_inner_matches_jax(n, state):
    """inner_dtype=bfloat16: the correction cycles in bf16 (the kernel
    routing on the card, the twins here), the state and residual fp32:
    the same cycle count as JAX's, the relative residual within REL_TOL, on
    the same fp32 problem data."""
    jprogram = jmg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=3)
    tol = 1e-10 if state == "tw32" else 1e-8
    jrep = jmg.refine.IterativeRefinementSolver(jmg.REFERENCE_PROBLEM, n, program=jprogram,
                                                max_cycles=60, state=state,
                                                inner_dtype=jnp.bfloat16).solve(tol)
    spec = jmg.GridSpec(n)
    rep = tmg.IterativeRefinementSolver(problem_from_jax_grids(jmg.REFERENCE_PROBLEM, spec), n,
                                        program=program_from_jax(jprogram), max_cycles=60,
                                        state=state, inner_dtype=BF16, device="cpu").solve(tol)
    assert rep.u.dtype == torch.float32
    assert rep.rel_residual <= tol and jrep.rel_residual <= tol
    assert rep.cycles == jrep.cycles
    assert rep.rel_residual == pytest.approx(jrep.rel_residual, rel=REL_TOL)


def test_refine_bf16_inner_slows_with_n_as_jax_does():
    """At 257² bf16 inner cycles need about three times fp32's cycles in both
    packages (ROADMAP Queue 3 item 9: a bf16 correction's rounding times
    8/h² grows with n; at 1025² both stall and at 2049² both rise,
    tests/bf16_witness.py --refine). Measured on the
    same fp32 data: the port 24 cycles, JAX 25 (65² and 129² are equal,
    above); pinned to within one cycle of each other and above 2.5× the
    port's fp32 count."""
    n, tol = 257, 1e-10
    jrep = jmg.refine.IterativeRefinementSolver(jmg.REFERENCE_PROBLEM, n, max_cycles=60,
                                                state="tw32",
                                                inner_dtype=jnp.bfloat16).solve(tol)
    problem = problem_from_jax_grids(jmg.REFERENCE_PROBLEM, jmg.GridSpec(n))
    rep = tmg.IterativeRefinementSolver(problem, n, max_cycles=60, state="tw32",
                                        inner_dtype=BF16, device="cpu").solve(tol)
    fp32 = tmg.IterativeRefinementSolver(problem, n, max_cycles=60, state="tw32",
                                         device="cpu").solve(tol)
    assert rep.rel_residual <= tol and jrep.rel_residual <= tol
    assert abs(rep.cycles - jrep.cycles) <= 1
    assert rep.cycles > 2.5 * fp32.cycles


# --- the admission rule: what has no bf16 kernel raises, naming the ROADMAP item ----------------

def _kernels_on(monkeypatch):
    monkeypatch.setattr(compiled, "_use_kernels", lambda cfg, device: True)
    monkeypatch.setattr(compiled3, "_use_kernels", lambda cfg, device: True)


def test_bf16_fixed_step_jacobi_is_admitted(monkeypatch):
    _kernels_on(monkeypatch)
    for kw in (dict(steps=3, coarse_option=0, coarsen=3), dict(steps=2, coarse_option=1),
               dict(steps=9, coarse_option=0, coarsen=3)):
        cc = tmg.compile_program(tmg.v_cycle(65, n_min=8, **kw), tmg.REFERENCE_PROBLEM,
                                 tmg.SolverConfig(dtype=BF16, omega=OMEGA), device="cpu")
        assert cc.use_kernels
    assert tmg.IterativeRefinementSolver(tmg.REFERENCE_PROBLEM, 65, inner_dtype=BF16,
                                         device="cpu")._cycle.use_kernels


@pytest.mark.parametrize("case", ["trigger", "trigger_ascend", "rbgs", "policy", "3d", "f64"])
def test_bf16_without_a_kernel_mode_raises(monkeypatch, case):
    _kernels_on(monkeypatch)
    cfg = tmg.SolverConfig(dtype=BF16, omega=OMEGA)
    program = tmg.v_cycle(65, n_min=8, steps=3, coarse_option=0, coarsen=3)
    kw = {}
    if case == "trigger":
        program = tmg.v_cycle(65, n_min=8, steps=-1, coarse_option=0, coarsen=3)
    elif case == "trigger_ascend":
        # a trigger node on the way up only
        program = CycleProgram(1.0, 0.0, 0.0, 65, (Descend(33, 3), CoarseSolve(1e-7, 0),
                                                   Ascend(-1)))
    elif case == "rbgs":
        cfg = tmg.SolverConfig(dtype=BF16, smoother="rbgs", restriction="full_weighting")
    elif case == "policy":
        kw = dict(policy=ShardingPolicy(make_mesh(["cpu"] * 8), threshold_rows=8))
    elif case == "f64":
        cfg = tmg.SolverConfig(dtype=torch.float64)
    if case == "3d":
        with pytest.raises(TypeError, match="3-D kernels.*Queue 2 A2"):
            tmg.compile_program3(tmg.v_cycle(17, n_min=5, steps=2, coarse_option=0, coarsen=3),
                                 tmg.REFERENCE_PROBLEM_3D, cfg, device="cpu")
        return
    match = "float32" if case == "f64" else "Queue 2 A2"
    with pytest.raises(TypeError, match=match):
        tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cpu", **kw)
    # kernels="torch" runs the same bf16 configuration on the plain path
    plain = dataclasses.replace(cfg, kernels="torch")
    monkeypatch.undo()
    if case != "f64":
        tmg.compile_program(program, tmg.REFERENCE_PROBLEM, plain, device="cpu", **kw)


def test_refinement_bf16_with_a_policy_raises(monkeypatch):
    _kernels_on(monkeypatch)
    pol = ShardingPolicy(make_mesh(["cpu"] * 8), threshold_rows=8)
    with pytest.raises(TypeError, match="sharding policy.*Queue 2 A2"):
        tmg.IterativeRefinementSolver(tmg.REFERENCE_PROBLEM, 65, inner_dtype=BF16,
                                      device="cpu", policy=pol)


# --- chained bf16 cycles: bounded where JAX's are, growing with n as JAX's do ------------------

def _chained(n, cycles, routed, monkeypatch, **prog):
    """The per-cycle float64 relative residual and mean |u − analytic| of
    ``cycles`` chained bf16 cycles, the port's (through the kernel routing
    when ``routed``) and JAX's XLA engine, on the same program."""
    from multigrid_poisson_solver_tpu_torch.ops.transfers import relative_residual_norm
    jprogram = jmg.v_cycle(n, n_min=8, **prog)
    jcfg = jmg.SolverConfig(dtype=jnp.bfloat16, omega=OMEGA, kernels="xla",
                            collect_node_stats=False)
    program, cfg = program_from_jax(jprogram), config_from_jax(jcfg)
    h = 1.0 / (n - 1)
    ua = grid_from_jax(jmg.REFERENCE_PROBLEM.analytic_grid(jmg.GridSpec(n), jnp.float32),
                       n).double()
    out = {}
    jcold = jmg.compile_program(jprogram, jmg.REFERENCE_PROBLEM, jcfg, donate=False)
    jwarm = jmg.compile_program(jprogram, jmg.REFERENCE_PROBLEM, jcfg, donate=False, warm=True)
    if routed:
        monkeypatch.setattr(compiled, "_use_kernels", lambda cfg, device: True)
    cold = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cpu")
    warm = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cpu", warm=True)
    for who, (c0, c1, to_th) in {"jax": (jcold, jwarm, lambda a: grid_from_jax(a, n)),
                                 "port": (cold, warm, lambda a: a)}.items():
        u, f = c0.init()
        rels, errs = [], []
        for c in range(cycles):
            u, _ = (c0 if c == 0 else c1)(u, f)
            ut = to_th(u).double()
            rels.append(float(relative_residual_norm(ut, to_th(f).double(), h)))
            errs.append(float((ut - ua).abs().mean()))
        out[who] = (rels, errs)
    return out


def test_bf16_chaining_floors_far_above_fp32(monkeypatch):
    """The port's counterpart of tests/test_dtypes.py's test of the same name:
    four chained bf16 V(3,3) cycles at 65² (the kernel routing) stay bounded
    by JAX's limit, mean |u − analytic| < 5e-2, as JAX's XLA engine does on
    the same program (measured: port 8.25e-3, JAX 9.29e-3), and fp32's four
    cycles floor ten times lower."""
    prog = dict(steps=3, coarse_option=0, coarsen=3)
    out = _chained(65, 4, True, monkeypatch, **prog)
    port, jx = out["port"][1][-1], out["jax"][1][-1]
    assert jx < 5e-2 and port < 5e-2
    cfg32 = tmg.SolverConfig(omega=OMEGA, collect_node_stats=False)
    program = tmg.v_cycle(65, n_min=8, **prog)
    cold = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg32, device="cpu")
    warm = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg32, device="cpu", warm=True)
    u, f = cold.init()
    u, _ = cold(u, f)
    for _ in range(3):
        u, _ = warm(u, f)
    ua = grid_from_jax(jmg.REFERENCE_PROBLEM.analytic_grid(jmg.GridSpec(65), jnp.float32), 65)
    assert float((u.double() - ua.double()).abs().mean()) < port / 10


def test_bf16_chained_cycles_grow_with_n_as_jax_does(monkeypatch):
    """Four chained bf16 V(3,3) cycles at 513², the port's (the kernel
    routing) against JAX's XLA engine (ROADMAP Queue 3 item 9): the first
    cycle's float64 relative residual within 0.5% of JAX's (measured 0.17%),
    both rising over the next three cycles (measured: port 81.2, 364, 354,
    699; JAX 81.3, 412, 811, 1183), the port's never above twice JAX's."""
    out = _chained(513, 4, True, monkeypatch, steps=3, coarse_option=0, coarsen=3)
    (port, _), (jx, _) = out["port"], out["jax"]
    assert port[0] == pytest.approx(jx[0], rel=5e-3)
    assert port[-1] > 4 * port[0] and jx[-1] > 4 * jx[0]
    assert all(p <= 2 * j for p, j in zip(port, jx))


# --- the legs' size rule: each leg's measured crossover ------------------------------------

def _shift_const(src, name):
    a, b = re.search(rf"{name} = (\d+)L << (\d+);", src).groups()
    return int(a) << int(b)


@pytest.mark.parametrize("source,const,tile_at,wave_at", [
    ("wave2.cuh", None, 1025, 2049),
    ("descend_bf16.cu", "DESCEND_BF16_WAVE_MIN_CELLS", 2049, 2561),
    ("ascend_bf16.cu", "ASCEND_BF16_WAVE_MIN_CELLS", 1449, 1793)])
def test_leg_route_rule(source, const, tile_at, wave_at):
    """``legs_take_wave`` (wave2.cuh) with each leg's crossover, the sizes
    either side of it as measured on the card (examples/torch_bf16_leg_routes.py,
    the sources' headers): the fp32 legs' 1.5 M cells by default, the bf16
    descend leg's 5 M, the bf16 ascend leg's 2.5 M."""
    from multigrid_poisson_solver_tpu_torch.ops import build
    rule = (build.CSRC / "wave2.cuh").read_text()
    assert "static inline bool legs_take_wave(long rows, long cols, long min_cells = 3L << 19)" \
        in rule and "return rows * cols >= min_cells;" in rule
    if const is None:
        cells = 3 << 19
        for leg in ("descend.cu", "ascend.cu"):
            assert "legs_take_wave(g.rows, g.cols)" in (build.CSRC / leg).read_text()
    else:
        src = (build.CSRC / source).read_text()
        assert f"legs_take_wave(n, n, {const})" in src
        cells = _shift_const(src, const)
    assert tile_at * tile_at < cells <= wave_at * wave_at
