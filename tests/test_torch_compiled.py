"""The port's engines as a whole against the JAX package's.

  * the 257² V(3,3) main-path schedule (ω = 0.8, coarsen=3, dense coarse
    solve): the port's compiled engine on the CPU against JAX's with
    kernels='xla', in float64 (1e-12) and fp32 (FP32_* below);
  * the same schedule at 65² routed through the port's fused legs (their
    plain twins on CPU tensors) against JAX with kernels='pallas', which runs
    the Pallas legs and chain kernels in interpret mode;
  * W-cycle, FMG, rb-GS and trigger schedules through the compiled engine;
  * the bundled Cycle.txt schedules through both port engines: the final
    error equal to JAX's (and the reference's) to the 6 printed digits.

fp32 bounds: each engine rounds its own way (JAX's Pallas legs fold the
Jacobi update into another form; XLA contracts FMAs) and the difference
grows by a few ulps per sweep over a cycle's dozens of sweeps, so
|Δu| ≤ 5e-5·max|u|. The finest-level error is a sum of fp32 residuals whose
cancellation noise eps·|u|/h² is a visible share of each term: it agrees
to 1e-3 relative after the first cycle and is compared there only, since
warm cycles bring it down to that noise floor.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multigrid_poisson_solver_tpu as jmg
import multigrid_poisson_solver_tpu_torch as tmg
from multigrid_poisson_solver_tpu_torch import compiled
from multigrid_poisson_solver_tpu_torch.convert import (config_from_jax, grid_from_jax,
                                                        program_from_jax)
from multigrid_poisson_solver_tpu_torch.ops import kernels as K

SCHEDULES = Path(__file__).resolve().parent.parent / "schedules"
# the reference binary's printed final errors (tests/test_reference_parity.py)
FP32_U_RTOL, FP32_ERR_RTOL = 5e-5, 1e-3
REFERENCE_ERRORS = {"test.txt": "0.000666", "Vcycle.txt": "0.000876",
                    "VcycleTrigger.txt": "0.000784"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_cycles(program, cfg, cycles):
    cold = jmg.compile_program(program, jmg.REFERENCE_PROBLEM, cfg, donate=False)
    warm = jmg.compile_program(program, jmg.REFERENCE_PROBLEM, cfg, donate=False, warm=True)
    u, f = cold.init()
    u, err = cold(u, f)
    out = [(grid_from_jax(u, program.n_max), float(err))]
    for _ in range(cycles - 1):
        u, err = warm(u, f)
        out.append((grid_from_jax(u, program.n_max), float(err)))
    return out


def _port_cycles(program, cfg, cycles):
    cold = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cpu")
    warm = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cpu", warm=True)
    u, f = cold.init()
    u, err = cold(u, f)
    out = [(u, float(err))]
    for _ in range(cycles - 1):
        u, err = warm(u, f)
        out.append((u, float(err)))
    return out


def _assert_cycles_close(ours, theirs, rtol, err_rtol):
    for cycle, ((u, e), (ju, je)) in enumerate(zip(ours, theirs, strict=True)):
        assert u.dtype == ju.dtype
        scale = float(ju.abs().max())
        assert float((u - ju).abs().max()) <= rtol * scale
        if cycle == 0 or u.dtype == torch.float64:
            assert e == pytest.approx(je, rel=err_rtol)


@pytest.mark.parametrize("dtype,rtol,err_rtol", [(jnp.float64, 1e-12, 1e-10),
                                                 (jnp.float32, FP32_U_RTOL,
                                                  FP32_ERR_RTOL)])
def test_main_path_schedule_matches_jax_xla(dtype, rtol, err_rtol):
    jprogram = jmg.v_cycle(257, n_min=8, steps=3, coarse_option=0, coarsen=3)
    jcfg = jmg.SolverConfig(dtype=dtype, omega=0.8, kernels="xla",
                            collect_node_stats=False)
    ours = _port_cycles(program_from_jax(jprogram), config_from_jax(jcfg), 3)
    _assert_cycles_close(ours, _jax_cycles(jprogram, jcfg, 3), rtol, err_rtol)


@pytest.mark.parametrize("chain_root,want_calls", [
    # JAX's routing: the whole 65 → 33 → 17 → 9 V is one chain pair per cycle
    (1025, {"descend": 0, "ascend": 0, "chain_descend": 2, "chain_ascend": 2}),
    # with the chain capped at 33 the top transition runs the fused legs
    (33, {"descend": 2, "ascend": 2, "chain_descend": 2, "chain_ascend": 2}),
])
def test_fused_leg_routing_matches_jax_pallas(monkeypatch, chain_root, want_calls):
    """The kernel routing on CPU tensors (chain kernels and fused legs → their
    twins) reaches JAX's Pallas engine's result, which runs the chain kernels
    in interpret mode."""
    calls = dict.fromkeys(want_calls, 0)

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(compiled, "_use_kernels", lambda cfg, device: True)
    monkeypatch.setattr(K, "CHAIN_MAX_ROOT", chain_root)
    for name in want_calls:
        fn = {"descend": "fused_descend", "ascend": "fused_ascend"}.get(name, name)
        monkeypatch.setattr(K, fn, counted(name, getattr(K, fn)))
    jprogram = jmg.v_cycle(65, n_min=8, steps=3, coarse_option=0, coarsen=3)
    jcfg = jmg.SolverConfig(omega=0.8, kernels="pallas", collect_node_stats=False)
    ours = _port_cycles(program_from_jax(jprogram), config_from_jax(jcfg), 2)
    assert calls == want_calls
    _assert_cycles_close(ours, _jax_cycles(jprogram, jcfg, 2), FP32_U_RTOL, FP32_ERR_RTOL)


@pytest.mark.parametrize("maker,n,kw", [
    ("v_cycle", 4097, dict(n_min=8, steps=3, coarse_option=0, coarsen=3)),
    ("v_cycle", 257, dict(n_min=8, steps=3, coarse_option=0, coarsen=3)),
    ("v_cycle", 129, dict(n_min=8, steps=9, coarse_option=0, coarsen=3)),
    ("v_cycle", 65, dict(n_min=9, steps=-1, coarse_option=0)),
    ("w_cycle", 65, dict(n_min=8, steps=2, coarse_option=0, coarsen=3)),
    ("fmg", 65, dict(n_min=8, steps=2, coarse_option=0, coarsen=3)),
])
@pytest.mark.parametrize("compat", [True, "gpu"])
def test_match_chain_agrees_with_jax(maker, n, kw, compat):
    """At every Descend of a schedule the port's chain matcher picks the
    ladder JAX's picks, except where a level's sweep count exceeds the tile
    budget of the port's leg kernels (steps=9 here): there the port runs per
    level instead."""
    from multigrid_poisson_solver_tpu import compiled as jcompiled

    jprogram = getattr(jmg, maker)(n, **kw)
    program = program_from_jax(jprogram)
    jcfg = jmg.SolverConfig(omega=0.8, kernels="pallas", compat_error=compat)
    cfg = config_from_jax(jcfg)
    matched, stack = [], [n]
    for i, ins in enumerate(program.instructions):
        if isinstance(ins, tmg.Ascend):
            stack.pop()
        if not isinstance(ins, tmg.Descend):
            continue
        finest = len(stack) == 1
        ours = compiled._match_chain(program.instructions, i, stack[-1], cfg, True, finest)
        theirs = jcompiled._match_chain(jprogram.instructions, i, stack[-1], jcfg, None, finest)
        stack.append(ins.next_n)
        if kw["steps"] > K.MAX_FUSED_SWEEPS:
            assert ours is None
            continue
        assert (ours is None) == (theirs is None), i
        if ours is not None:
            matched.append(ours[0])
            assert ours[:3] == theirs[:3] and ours[4] == theirs[4]
            assert (ours[3].option, ours[3].target_error) == (theirs[3].option,
                                                              theirs[3].target_error)
    if maker == "v_cycle" and kw["steps"] == 3:
        # the main path chains below 1025 (4097, 2049 per level); 257 chains
        # whole unless the finest level reports the gpu metric
        assert matched[0][0] == (1025 if n == 4097 else 129 if compat == "gpu" else 257)


@pytest.mark.parametrize("maker", ["w_cycle", "fmg"])
def test_kernel_routing_of_w_cycle_and_fmg(monkeypatch, maker):
    """Fused legs under the warm-restart rules that V-cycles do not reach:
    mid-W re-zeroed corrections, and FMG levels that keep their iterate."""
    monkeypatch.setattr(compiled, "_use_kernels", lambda cfg, device: True)
    jprogram = getattr(jmg, maker)(33, n_min=8, steps=2, coarse_option=0, coarsen=3)
    jcfg = jmg.SolverConfig(omega=0.8, kernels="xla", collect_node_stats=False)
    ours = _port_cycles(program_from_jax(jprogram), config_from_jax(jcfg), 2)
    _assert_cycles_close(ours, _jax_cycles(jprogram, jcfg, 2), FP32_U_RTOL, FP32_ERR_RTOL)


@pytest.mark.parametrize("maker,kw", [
    ("w_cycle", dict(steps=2, coarse_target=1e-8)),
    ("fmg", dict(steps=2, coarse_target=1e-8)),
    ("v_cycle", dict(steps=-1, coarse_option=0)),
])
def test_schedule_families_match_jax_xla_float64(maker, kw):
    jprogram = getattr(jmg, maker)(33, n_min=8, **kw)
    jcfg = jmg.SolverConfig(dtype=jnp.float64, kernels="xla", collect_node_stats=False)
    ours = _port_cycles(program_from_jax(jprogram), config_from_jax(jcfg), 1)
    _assert_cycles_close(ours, _jax_cycles(jprogram, jcfg, 1), 1e-12, 1e-10)


def test_rbgs_full_weighting_matches_jax_xla_float64():
    jprogram = jmg.v_cycle(65, n_min=8, steps=2, coarse_option=0, coarsen=3)
    jcfg = jmg.SolverConfig(dtype=jnp.float64, smoother="rbgs",
                            restriction="full_weighting", compat_error="gpu",
                            kernels="xla", collect_node_stats=False)
    ours = _port_cycles(program_from_jax(jprogram), config_from_jax(jcfg), 2)
    _assert_cycles_close(ours, _jax_cycles(jprogram, jcfg, 2), 1e-12, 1e-10)


@pytest.mark.parametrize("whole_loop", [True, False])
def test_trigger_through_fused_error_routing(monkeypatch, whole_loop):
    """A trigger schedule on the kernel routing lands where JAX's plain
    trigger loop does: through the whole-loop trigger kernel's twin, and
    through one fused sweep-plus-error step at a time (levels above
    trigger_fits)."""
    calls = {"trigger_smooth": 0}

    def counted(*a, **kw):
        calls["trigger_smooth"] += 1
        return trigger_smooth(*a, **kw)

    trigger_smooth = K.trigger_smooth
    monkeypatch.setattr(compiled, "_use_kernels", lambda cfg, device: True)
    monkeypatch.setattr(K, "trigger_smooth", counted)
    if not whole_loop:
        monkeypatch.setattr(K, "trigger_fits", lambda n: False)
    jprogram = jmg.v_cycle(65, n_min=9, steps=-1, coarse_option=0)
    jcfg = jmg.SolverConfig(omega=0.8, kernels="xla", collect_node_stats=False)
    ours = _port_cycles(program_from_jax(jprogram), config_from_jax(jcfg), 1)
    # 65 → 32 → 16 (halving): two trigger descents and two ascents
    assert calls["trigger_smooth"] == (4 if whole_loop else 0)
    _assert_cycles_close(ours, _jax_cycles(jprogram, jcfg, 1), FP32_U_RTOL, FP32_ERR_RTOL)


@pytest.mark.parametrize("compat", [True, "gpu"])
def test_rbgs_kernel_routing_matches_jax_pallas(monkeypatch, compat):
    """rb-GS V(2,2) with full weighting on the kernel routing (the rb-GS
    modes' twins on CPU tensors; the gpu metric by the two-call form) against
    JAX's Pallas engine, which runs fused_rbgs(_err)_padded in interpret
    mode."""
    monkeypatch.setattr(compiled, "_use_kernels", lambda cfg, device: True)
    jprogram = jmg.v_cycle(65, n_min=8, steps=2, coarse_option=0, coarsen=3)
    jcfg = jmg.SolverConfig(smoother="rbgs", restriction="full_weighting", compat_error=compat,
                            kernels="pallas", collect_node_stats=False)
    ours = _port_cycles(program_from_jax(jprogram), config_from_jax(jcfg), 2)
    _assert_cycles_close(ours, _jax_cycles(jprogram, jcfg, 2), FP32_U_RTOL, FP32_ERR_RTOL)


@pytest.mark.parametrize("trigger_batch", [1, 4, "auto"])
def test_trigger_tiers_above_the_whole_loop_kernels_match_jax_pallas(monkeypatch,
                                                                     trigger_batch):
    """Trigger levels that neither whole-loop kernel admits (both packages'
    trigger_fits and trigger_stream_fits made to reject every n, as
    tests/test_pallas_chain.py does for JAX) take JAX's kernel-path tiers:
    the exact loop for trigger_batch=1, batched passes of the per-sweep error
    mode for 4, the two-phase loop for "auto". The port's kernel routing (the
    twins on CPU tensors) lands on JAX's Pallas engine's iterate, and the
    batched runs stop on multiples of the batch past where the exact run
    stops."""
    import jax

    from multigrid_poisson_solver_tpu.ops import pallas_chain as pc

    for mod in (pc, K):
        monkeypatch.setattr(mod, "trigger_fits", lambda n, **kw: False)
        monkeypatch.setattr(mod, "trigger_stream_fits", lambda n, **kw: False)
    monkeypatch.setattr(compiled, "_use_kernels", lambda cfg, device: True)
    calls = {"errs": 0}
    errs = K.fused_jacobi_errs

    def counted(*a, **kw):
        calls["errs"] += 1
        return errs(*a, **kw)

    monkeypatch.setattr(K, "fused_jacobi_errs", counted)
    jax.clear_caches()
    jprogram = jmg.v_cycle(65, n_min=8, steps=-1, coarse_option=0, coarsen=3)
    jcfg = jmg.SolverConfig(omega=0.8, kernels="pallas", trigger_batch=trigger_batch,
                            collect_node_stats=False)
    cfg = config_from_jax(jcfg)
    cc = tmg.compile_program(program_from_jax(jprogram), tmg.REFERENCE_PROBLEM, cfg, device="cpu")
    cc.trigger_sweeps = []
    u, err = cc(*cc.init())
    _assert_cycles_close([(u, float(err))], _jax_cycles(jprogram, jcfg, 1), FP32_U_RTOL,
                         FP32_ERR_RTOL)
    exact = tmg.compile_program(program_from_jax(jprogram), tmg.REFERENCE_PROBLEM,
                                dataclasses.replace(cfg, trigger_batch=1), device="cpu")
    exact.trigger_sweeps = []
    exact(*exact.init())
    # 65 → 33 → 17 → 9: three trigger descents and three ascents
    assert len(cc.trigger_sweeps) == len(exact.trigger_sweeps) == 6
    for (n, k), (n1, k1) in zip(cc.trigger_sweeps, exact.trigger_sweeps):
        assert n == n1
        if trigger_batch == 4:
            assert k % 4 == 0 and k1 <= k < k1 + 4
    if trigger_batch == 1:
        assert calls["errs"] == 0
    elif trigger_batch == 4:
        assert calls["errs"] == sum(k for _, k in cc.trigger_sweeps) // 4


def test_iterate_chains_cold_then_warm():
    program = tmg.v_cycle(33, n_min=8, steps=3, coarse_option=0, coarsen=3)
    cfg = tmg.SolverConfig(omega=0.8)
    cc = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cpu")
    u0, f = cc.init()
    chained = cc.iterate(3)(u0, f)
    manual = [u for u, _ in _port_cycles(program, cfg, 3)][-1]
    assert torch.equal(chained, manual)
    assert torch.equal(u0, cc.init()[0])   # the engine never writes its inputs
    assert cc.unpad(chained) is chained


@pytest.mark.parametrize("name", ["test.txt", "Vcycle.txt", "VcycleTrigger.txt"])
@pytest.mark.parametrize("engine", ["interpreted", "compiled"])
def test_bundled_schedules_final_error_matches_jax(name, engine):
    jprogram = jmg.parse_cycle_path(SCHEDULES / name)
    program = tmg.parse_cycle_path(SCHEDULES / name)
    if engine == "interpreted":
        theirs = jmg.solve(jmg.REFERENCE_PROBLEM, jprogram).error_vs_analytic
        ours = tmg.solve(tmg.REFERENCE_PROBLEM, program, device="cpu").error_vs_analytic
    else:
        jcc = jmg.compile_program(jprogram, jmg.REFERENCE_PROBLEM, donate=False)
        ju, _ = jcc(*jcc.init())
        theirs = float(jnp.mean(jnp.abs(
            jcc.unpad(ju) - jmg.REFERENCE_PROBLEM.analytic_grid(jcc.finest_spec))))
        cc = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, device="cpu")
        u, _ = cc(*cc.init())
        ours = float((u - tmg.REFERENCE_PROBLEM.analytic_grid(cc.finest_spec)).abs().mean())
    assert f"{ours:.6f}" == f"{theirs:.6f}" == REFERENCE_ERRORS[name]
    assert np.isclose(ours, theirs, rtol=1e-4)
