"""The port's user examples (examples/torch_0*.py) run with ``--device cpu``
at a small size, each printing the lines of its JAX counterpart
(examples/0*.py) with the JAX package's numbers.

Example 01's compiled-engine Error on schedules/test.txt is held to the JAX
example's within 1e-3 relative: the two packages' fp32 problem data differ by
an ulp at a few percent of points (torch's and XLA's fp32 exp). Examples
02-04: the refinement cycle counts equal the JAX package's exactly; each
printed residual is finite and at most the tolerance the example asks for,
and within 5% of JAX's (residuals near 1e-11 sit at the fp32 inner cycles'
rounding floor, where the two packages' roundings differ); errors against the
analytic solution and smoothing errors are within 1e-3 of JAX's (the port
prints 4 digits). Example 02 is JAX's ``main`` at the same size; 03 and 04
fix their sizes (129², 257²), so their steps run through the JAX package at
the port's test size.
"""

import importlib.util
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def load(name):
    spec = importlib.util.spec_from_file_location(name.replace(".py", ""),
                                                  ROOT / "examples" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(capsys, name, *argv):
    assert load(name).main([*argv, "--device", "cpu"]) == 0
    return capsys.readouterr().out


def test_01_reference_style_matches_jax(capsys):
    out = run(capsys, "torch_01_reference_style.py", str(ROOT / "schedules" / "test.txt"))
    assert "N=16, 3 instructions" in out and "[interpreted] ===== Final Result" in out
    ours = float(re.search(r"\[compiled\]\s+Error = (\S+)", out).group(1))
    load("01_reference_style.py").main(str(ROOT / "schedules" / "test.txt"))
    theirs = float(re.search(r"\[compiled\]\s+Error = (\S+)", capsys.readouterr().out).group(1))
    assert ours == pytest.approx(theirs, rel=1e-3)


EXAMPLES = sorted(p.name for p in (ROOT / "examples").glob("torch_0*.py"))


def test_five_examples():
    assert [n[:8] for n in EXAMPLES] == [f"torch_0{i}" for i in range(1, 6)]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_defaults_to_the_card_and_imports_no_jax(name):
    src = (ROOT / "examples" / name).read_text()
    assert re.search(r'"--device", default="cuda", choices=\["cuda", "cpu"\]', src)
    assert not re.search(r"^\s*(import|from)\s+(jax|multigrid_poisson_solver_tpu)\b", src,
                         re.MULTILINE)
    with pytest.raises(SystemExit):
        load(name).main(["--device", "tpu"])


def jax_02(capsys, n):
    load("02_deep_solve.py").main(str(n))
    return parse(capsys.readouterr().out, LINES["torch_02_deep_solve.py"])


def jax_03(capsys, n):
    import math

    import jax.numpy as jnp

    import multigrid_poisson_solver_tpu as jmg
    from multigrid_poisson_solver_tpu.models.problems import Problem
    from multigrid_poisson_solver_tpu.solver import SolverConfig

    def boundary(x, y):
        return jnp.sin(math.pi * x) * jnp.sinh(math.pi * y) / math.sinh(math.pi)

    problem = Problem(source=lambda x, y: jnp.zeros_like(x), boundary=boundary,
                      analytic=boundary, name="laplace-sinh")
    program = jmg.w_cycle(n, n_min=5, steps=2, coarse_option=0, coarsen=3)
    config = SolverConfig(smoother="rbgs", restriction="full_weighting")
    deep = jmg.solve_to_tolerance(problem, n, tol=1e-10, program=program, config=config)
    return {"err_w": jmg.solve(problem, program, config).error_vs_analytic,
            "res": deep.rel_residual, "cycles": deep.cycles, "err": deep.error_vs_analytic}


def jax_04(capsys, n):
    import multigrid_poisson_solver_tpu as jmg
    from multigrid_poisson_solver_tpu.parallel import multihost
    from multigrid_poisson_solver_tpu.parallel.mesh import ShardingPolicy, make_mesh

    policy = ShardingPolicy(make_mesh(), threshold_rows=16)
    mesh2 = multihost.hybrid_block_mesh()
    assert dict(mesh2.shape) == {"rows": 2, "cols": 4}
    program = jmg.v_cycle(n, n_min=8, steps=3)
    errs = []
    for pol in (policy, multihost.block_policy(mesh2, threshold_rows=16)):
        cc = jmg.compile_program(program, jmg.REFERENCE_PROBLEM, policy=pol, donate=False)
        errs.append(float(cc(*cc.init())[1]))
    rep = jmg.solve_to_tolerance(jmg.REFERENCE_PROBLEM, n, tol=1e-9, policy=policy)
    return {"err_rows": errs[0], "err_blocks": errs[1], "res": rep.rel_residual,
            "cycles": rep.cycles}


# each example's printed lines; named groups are the numbers held to JAX's
LINES = {
    "torch_02_deep_solve.py": [
        r"N=\d+: rel residual (?P<res>\S+) after (?P<cycles>\d+) refinement cycles",
        r"error vs analytic: (?P<err>\S+) \(discretization floor\)",
        r"tw32 state: rel residual (?P<res_tw32>\S+) after (?P<cycles_tw32>\d+) cycles"],
    "torch_03_custom_problem.py": [
        r"W-cycle error vs analytic: (?P<err_w>\S+)",
        r"refined to (?P<res>\S+) in (?P<cycles>\d+) cycles; error (?P<err>\S+)"],
    "torch_04_multichip.py": [
        r"row-sharded over 8 shards of cpu: finest smoothing error (?P<err_rows>\S+)",
        r"block-sharded on mesh \{'rows': 2, 'cols': 4\}: finest smoothing error "
        r"(?P<err_blocks>\S+)",
        r"sharded refinement: (?P<res>\S+) in (?P<cycles>\d+) cycles"],
    "torch_05_chain.py": [
        r"N=65: chain vs per-level engine maxdiff = 0.0 \(BIT-IDENTICAL\)",
        r"mean\|u − analytic\| after one V\(3,3\) cycle: \S+"],
}
# the tolerance each printed residual was asked for
TOLS = {("torch_02_deep_solve.py", "res"): 1e-10, ("torch_02_deep_solve.py", "res_tw32"): 1e-13,
        ("torch_03_custom_problem.py", "res"): 1e-10, ("torch_04_multichip.py", "res"): 1e-9}


def parse(out, patterns):
    got = {}
    for pattern in patterns:
        match = re.search(pattern, out)
        assert match, (pattern, out)
        got.update({k: float(v) for k, v in match.groupdict().items()})
    return got


# the JAX package's numbers for the same steps at the same size
JAX_STEPS = {"torch_02_deep_solve.py": jax_02, "torch_03_custom_problem.py": jax_03,
             "torch_04_multichip.py": jax_04}


@pytest.mark.parametrize("name,argv,lines", [
    (name, [n], LINES[name]) for name, n in (("torch_02_deep_solve.py", "33"),
                                             ("torch_03_custom_problem.py", "33"),
                                             ("torch_04_multichip.py", "129"),
                                             ("torch_05_chain.py", "65"))])
def test_example_runs_on_cpu(capsys, name, argv, lines):
    ours = parse(run(capsys, name, *argv), lines)
    jax_steps = JAX_STEPS.get(name)
    if jax_steps is None:
        return
    theirs = jax_steps(capsys, int(argv[0]))
    assert ours.keys() == theirs.keys()
    for key, value in ours.items():
        assert math.isfinite(value), (key, value)
        if "cycles" in key:
            assert value == theirs[key], key
        elif key.startswith("res"):
            assert value <= TOLS[name, key], (key, value)
            assert value == pytest.approx(theirs[key], rel=0.05), key
        else:
            assert value == pytest.approx(theirs[key], rel=1e-3), key


@pytest.mark.parametrize("path", [
    "multigrid_poisson_solver_tpu_torch/native.py",
    "multigrid_poisson_solver_tpu_torch/utils/io.py",
    "multigrid_poisson_solver_tpu_torch/utils/profiling.py",
    "multigrid_poisson_solver_tpu_torch/utils/dist_checkpoint.py",
    "multigrid_poisson_solver_tpu_torch/utils/plotting.py",
    "multigrid_poisson_solver_tpu_torch/ops/zoom.py",
    "multigrid_poisson_solver_tpu_torch/ops/__init__.py",
    "chip_smoke.py",
])
def test_port_modules_import_no_jax(path):
    src = (ROOT / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|multigrid_poisson_solver_tpu)\b", src,
                         re.MULTILINE)
    assert "matplotlib" not in src or path.endswith("plotting.py")
