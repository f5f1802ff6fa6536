"""The port's 3-D engines (compile_program3, Solver3D, v_cycle3's kernel
routing) against the JAX package's.

  * compile_program3 and Solver3D on the CPU against JAX's (XLA path) on V
    (2:1-aligned, coarsen=3; dense and Gauss-Seidel coarse solves), W and
    FMG programs at ≤ 33³, with both error metrics and a warm restart, on
    JAX's own fp32 problem grids (convert.problem3_from_jax_grids);
  * the kernel routing (the kernels' twins on CPU tensors) at 65³, the one
    size where it engages: the operations it reaches equal those JAX's
    Pallas engine reaches (its kernels counted in interpret mode), and the
    result agrees with JAX's;
  * trigger nodes on the kernel path: they stop where the plain path stops
    (tests/test_torch_compiled3_trigger.py holds each trigger tier against
    JAX's Pallas engine).

fp32 bounds: each package rounds its own way (XLA contracts FMAs; the JAX
kernels fold the Jacobi update into another form) and the difference grows
by a few ulps a sweep over a cycle's dozens of sweeps: |Δu| ≤ 5e-5·max|u|;
the error scalars agree to 1e-3 relative after the first cycle (a sum of
fp32 residuals whose cancellation noise is a visible share of each term).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multigrid_poisson_solver_tpu as jmg
import multigrid_poisson_solver_tpu_torch as tmg
from multigrid_poisson_solver_tpu import compiled3 as jcompiled3
from multigrid_poisson_solver_tpu.models import poisson3d as jp3
from multigrid_poisson_solver_tpu.ops import pallas3d as jp3k
from multigrid_poisson_solver_tpu.solver3 import Solver3D as JSolver3D
from multigrid_poisson_solver_tpu_torch import compiled3
from multigrid_poisson_solver_tpu_torch.convert import (config_from_jax, grid3_from_jax,
                                                        problem3_from_jax_grids,
                                                        program_from_jax)
from multigrid_poisson_solver_tpu_torch.models import poisson3d as p3
from multigrid_poisson_solver_tpu_torch.ops import kernels as K
from multigrid_poisson_solver_tpu_torch.ops import kernels3 as K3

FP32_U_RTOL, FP32_ERR_RTOL = 5e-5, 1e-3
OMEGA3 = 6.0 / 7.0
PROGRAMS = {
    "v_gs": ("v_cycle", 33, dict(n_min=5, steps=3, coarse_target=1e-8, coarsen=3)),
    "v_dense": ("v_cycle", 33, dict(n_min=8, steps=2, coarse_option=0, coarsen=3)),
    "w": ("w_cycle", 17, dict(n_min=5, steps=2, coarse_target=1e-8, coarsen=3)),
    "fmg": ("fmg", 17, dict(n_min=5, steps=3, coarse_target=1e-8, coarsen=3)),
    "v_halving": ("v_cycle", 16, dict(n_min=5, steps=3, coarse_target=1e-8)),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _program(key):
    maker, n, kw = PROGRAMS[key]
    return getattr(jmg, maker)(n, **kw)


def _jax_runs(jprogram, jcfg, cycles):
    cc = jcompiled3.compile_program3(jprogram, jp3.REFERENCE_PROBLEM_3D, jcfg)
    u, f = cc.init()
    out = []
    for c in range(cycles):
        u, err = cc(u, f, warm=c > 0)
        out.append((grid3_from_jax(u, jprogram.n_max), float(err)))
    return out


def _port_runs(jprogram, jcfg, cycles, device="cpu"):
    cc = tmg.compile_program3(program_from_jax(jprogram),
                              problem3_from_jax_grids(jp3.REFERENCE_PROBLEM_3D),
                              config_from_jax(jcfg), device=device)
    u, f = cc.init()
    out = []
    for c in range(cycles):
        u, err = cc(u, f, warm=c > 0)
        out.append((u, float(err)))
    return out


def _assert_runs_close(ours, theirs, rtol, err_rtol):
    for cycle, ((u, e), (ju, je)) in enumerate(zip(ours, theirs, strict=True)):
        assert u.dtype == ju.dtype and u.shape == ju.shape
        assert float((u - ju).abs().max()) <= rtol * float(ju.abs().max())
        if cycle == 0 or u.dtype == torch.float64:
            assert e == pytest.approx(je, rel=err_rtol)


@pytest.mark.parametrize("key", list(PROGRAMS))
@pytest.mark.parametrize("compat", [True, "gpu"])
@pytest.mark.parametrize("dtype,rtol,err_rtol", [(jnp.float64, 1e-12, 1e-10),
                                                 (jnp.float32, FP32_U_RTOL, FP32_ERR_RTOL)])
def test_compile_program3_matches_jax_xla(key, compat, dtype, rtol, err_rtol):
    """A cold run, then a warm one (the init-flag restart)."""
    jcfg = jmg.SolverConfig(dtype=dtype, omega=OMEGA3, compat_error=compat, kernels="xla",
                            collect_node_stats=False)
    jprogram = _program(key)
    _assert_runs_close(_port_runs(jprogram, jcfg, 2), _jax_runs(jprogram, jcfg, 2), rtol,
                       err_rtol)


@pytest.mark.parametrize("key", ["v_gs", "w", "fmg"])
@pytest.mark.parametrize("compat", [True, "gpu"])
def test_solver3_matches_jax_float64(key, compat):
    """The interpreted engine node by node: the same reports (kind, level,
    sweeps, error) and the same final iterate."""
    jcfg = jmg.SolverConfig(dtype=jnp.float64, omega=OMEGA3, compat_error=compat)
    jprogram = _program(key)
    theirs = JSolver3D(jp3.REFERENCE_PROBLEM_3D, jcfg).run(jprogram)
    ours = tmg.Solver3D(problem3_from_jax_grids(jp3.REFERENCE_PROBLEM_3D),
                        config_from_jax(jcfg), device="cpu").run(program_from_jax(jprogram))
    ju = grid3_from_jax(theirs.u, jprogram.n_max)
    assert float((ours.u - ju).abs().max()) <= 1e-12 * float(ju.abs().max())
    assert ours.error_vs_analytic == pytest.approx(theirs.error_vs_analytic, rel=1e-10)
    assert len(ours.nodes) == len(theirs.nodes)
    for a, b in zip(ours.nodes, theirs.nodes):
        assert (a.kind, a.n, a.steps, a.detail) == (b.kind, b.n, b.steps, b.detail)
        if b.error is not None:
            assert a.error == pytest.approx(b.error, rel=1e-9)


def test_trigger_program_engines_agree():
    """A trigger schedule on the plain path: the compiled engine and the
    interpreted one run the same loops to the same iterate."""
    program = tmg.v_cycle(17, n_min=5, steps=-1, coarse_target=1e-8, coarsen=3)
    cfg = tmg.SolverConfig(omega=OMEGA3, trigger=1e-4, collect_node_stats=False,
                           dtype=torch.float64)
    rep = tmg.Solver3D(tmg.REFERENCE_PROBLEM_3D, cfg, device="cpu").run(program)
    cc = tmg.compile_program3(program, tmg.REFERENCE_PROBLEM_3D, cfg, device="cpu")
    u, _ = cc(*cc.init())
    assert float((u - rep.u).abs().max()) <= 1e-12 * float(rep.u.abs().max())


def test_engines_never_write_their_inputs_and_iterate_chains():
    program = tmg.v_cycle(17, n_min=5, steps=2, coarse_option=0, coarsen=3)
    cc = tmg.compile_program3(program, tmg.REFERENCE_PROBLEM_3D,
                              tmg.SolverConfig(omega=OMEGA3), device="cpu")
    u0, f = cc.init()
    keep = u0.clone(), f.clone()
    u = cc(cc(u0, f)[0], f, warm=True)[0]
    assert torch.equal(cc.iterate(2)(u0, f), u)
    assert torch.equal(u0, keep[0]) and torch.equal(f, keep[1])
    warm = tmg.compile_program3(program, tmg.REFERENCE_PROBLEM_3D,
                                tmg.SolverConfig(omega=OMEGA3), device="cpu", warm=True)
    assert torch.equal(warm(cc(u0, f)[0], f)[0], u)


# --- the kernel routing at 65³ -----------------------------------------------------

JAX_KERNELS = {"descend3": "fused_descend3_padded", "ascend3": "fused_ascend3_padded",
               "jacobi3": "fused_jacobi3_padded", "residual3": "residual3_pallas"}
PORT_KERNELS = {"descend3": ("fused_descend3",), "ascend3": ("fused_ascend3",),
                "jacobi3": ("fused_jacobi3", "fused_jacobi3_err"), "residual3": ("residual3",)}


def _spy(monkeypatch, module, name, key, calls):
    fn = getattr(module, name)

    def counted(*a, **kw):
        calls[key] += 1
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, counted)


def _spy_both(monkeypatch):
    ours, theirs = dict.fromkeys(JAX_KERNELS, 0), dict.fromkeys(JAX_KERNELS, 0)
    for key, name in JAX_KERNELS.items():
        _spy(monkeypatch, jp3k, name, key, theirs)
        for port_name in PORT_KERNELS[key]:
            _spy(monkeypatch, K3, port_name, key, ours)
    return ours, theirs


@pytest.mark.parametrize("compat,steps,want", [
    # clean: both legs fused at 65³ (below it the plain ops run)
    (True, 2, {"descend3": 1, "ascend3": 1, "jacobi3": 0, "residual3": 0}),
    # the gpu metric: no fused leg; smoother passes with the gpu error, the
    # residual kernel before the 2:1 restriction
    ("gpu", 2, {"descend3": 0, "ascend3": 0, "jacobi3": 2, "residual3": 1}),
    # 9 sweeps: two smoother passes (8 + 1) a side, the descend over its cap,
    # the ascend over 8; the clean error rides on the last pass
    (True, 9, {"descend3": 0, "ascend3": 0, "jacobi3": 4, "residual3": 1}),
])
def test_compiled3_kernel_routing_matches_jax_pallas(monkeypatch, compat, steps, want):
    monkeypatch.setattr(compiled3, "_use_kernels", lambda cfg, device: True)
    ours, theirs = _spy_both(monkeypatch)
    jprogram = jmg.v_cycle(65, n_min=8, steps=steps, coarse_option=0, coarsen=3)
    jcfg = jmg.SolverConfig(omega=OMEGA3, compat_error=compat, kernels="pallas",
                            collect_node_stats=False)
    got = _port_runs(jprogram, jcfg, 1)
    ref = _jax_runs(jprogram, jcfg, 1)
    assert ours == theirs == want
    _assert_runs_close(got, ref, FP32_U_RTOL, FP32_ERR_RTOL)


def test_v_cycle3_kernel_routing_matches_jax_pallas(monkeypatch):
    """v_cycle3's kernel path at 65³ (the fused legs there, the oracle ops
    below) against JAX's v_cycle3(kernels='pallas')."""
    monkeypatch.setattr(K, "use_kernels", lambda kernels, device: True)
    ours, theirs = _spy_both(monkeypatch)
    n, h = 65, 1.0 / 64
    rng = np.random.default_rng(3)
    u = np.zeros((n, n, n), np.float32)
    u[1:-1, 1:-1, 1:-1] = rng.standard_normal((n - 2,) * 3)
    f = rng.standard_normal((n, n, n)).astype(np.float32)
    want = jp3.v_cycle3(jnp.asarray(u), jnp.asarray(f), h, pre=3, post=3, coarse_sweeps=10,
                        kernels="pallas")
    got = p3.v_cycle3(torch.from_numpy(u), torch.from_numpy(f), h, pre=3, post=3,
                      coarse_sweeps=10, kernels="cuda")
    assert ours == theirs == {"descend3": 1, "ascend3": 1, "jacobi3": 0, "residual3": 0}
    want = np.asarray(want)
    assert float(np.abs(got.numpy() - want).max()) <= FP32_U_RTOL * float(np.abs(want).max())


def test_kernel_path_refuses_trigger_nodes(monkeypatch):
    """Trigger nodes run on the kernel path at every size: at 65³ through the
    trigger tiers (their whole-loop kernel there), below 65³ on the oracle
    ops, as on the plain path; the kernel path stops where the plain path
    stops."""
    monkeypatch.setattr(compiled3, "_use_kernels", lambda cfg, device: True)
    cfg = tmg.SolverConfig(omega=OMEGA3, collect_node_stats=False, max_trigger_sweeps=20)
    for n in (65, 33):
        program = tmg.v_cycle(n, n_min=8, steps=-1, coarse_option=0, coarsen=3)
        cc = tmg.compile_program3(program, tmg.REFERENCE_PROBLEM_3D, cfg, device="cpu")
        cc.trigger_sweeps = []
        u, err = cc(*cc.init())
        assert bool(torch.isfinite(u).all()) and bool(torch.isfinite(err))
        plain = tmg.compile_program3(program, tmg.REFERENCE_PROBLEM_3D,
                                     dataclasses.replace(cfg, kernels="torch"), device="cpu")
        plain.trigger_sweeps = []
        plain(*plain.init())
        assert cc.trigger_sweeps == plain.trigger_sweeps
        assert len(cc.trigger_sweeps) == {65: 6, 33: 4}[n]


def test_kernel_path_checks(monkeypatch):
    program = tmg.v_cycle(17, n_min=5, steps=2, coarse_option=0, coarsen=3)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tmg.compile_program3(program, tmg.REFERENCE_PROBLEM_3D,
                             tmg.SolverConfig(kernels="cuda"), device="cpu")
    monkeypatch.setattr(compiled3, "_use_kernels", lambda cfg, device: True)
    with pytest.raises(TypeError, match="float32"):
        tmg.compile_program3(program, tmg.REFERENCE_PROBLEM_3D,
                             tmg.SolverConfig(dtype=torch.float64), device="cpu")


def test_cli_3d_problems_are_jax_s():
    """The three 3-D problems exist in both packages under the same keys."""
    assert set(tmg.BUILTIN_PROBLEMS_3D) == set(jp3.BUILTIN_PROBLEMS_3D)
    assert jax.config.jax_enable_x64   # the tests' float64 runs need it
