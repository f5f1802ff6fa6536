"""The port's CLI, its CSV writer, and what the port package and
chip_smoke.py promise about their imports and their exit codes."""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multigrid_poisson_solver_tpu import cli as jcli
from multigrid_poisson_solver_tpu.utils import io as jio
from multigrid_poisson_solver_tpu_torch import cli
from multigrid_poisson_solver_tpu_torch.utils import io

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "multigrid_poisson_solver_tpu_torch"
TEST_TXT = str(ROOT / "schedules" / "test.txt")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _final_error(text):
    return float(re.search(r"Error = ([0-9.eE+-]+)", text).group(1))


@pytest.mark.parametrize("engine", ["compiled", "interpreted"])
def test_cli_matches_jax_cli(capsys, engine):
    argv = ["1", TEST_TXT, "--engine", engine, "--quiet", "--no-output"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    assert jcli.main(argv + ["--platform", "cpu"]) == 0
    theirs = capsys.readouterr().out
    assert "===== Final Result =====" in ours and "Time Used = " in ours
    assert f"{_final_error(ours):.6f}" == f"{_final_error(theirs):.6f}" == "0.000666"


def test_cli_writes_reference_csv(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["1", TEST_TXT, "--device", "cpu", "--quiet"]) == 0
    assert "Output file name = Sol_CPU_test.txt" in capsys.readouterr().out
    grid = jio.read_solution_csv(tmp_path / "Sol_CPU_test.txt")
    assert grid.shape == (16, 16) and np.isfinite(grid).all()


def test_csv_bytes_match_jax_writer(tmp_path, rng):
    u = rng.standard_normal((7, 9)) * 1e3
    u[0, 0] = -0.0
    jio.write_solution_csv(u.astype(np.float32), tmp_path / "jax.csv")
    io.write_solution_csv(torch.from_numpy(u.astype(np.float32)), tmp_path / "port.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert io.solution_filename("/a/b/Vcycle.txt") == "Sol_GPU_Vcycle.txt"


@pytest.mark.parametrize("extra,what", [(["--tol", "1e-10"], "--tol"),
                                        (["--dim", "3", "--tol", "1e-10"], "--dim 3")])
def test_cli_unported_modes_exit_1(capsys, extra, what):
    """Both deep-solve modes are ported and exit 0 with their result blocks:
    --tol (2-D iterative refinement) and --dim 3 --tol (3-D refinement);
    what exits 1 is the state the 3-D refinement does not have, f64, as in
    JAX's CLI."""
    argv = ["1", TEST_TXT, "--device", "cpu", "--no-output", "--quiet", *extra]
    assert cli.main(argv + ["--max-cycles", "3"]) == 0
    out = capsys.readouterr().out
    if what == "--tol":
        assert re.search(r"RelRes = \S+ after 3 cycles\n\s+Error = \S+\nTime Used = ", out), out
        return
    assert re.search(r"Error = \S+\nRelative residual = \S+ \(3 refinement cycles\)\n"
                     r"Time Used = ", out), out
    assert cli.main(argv + ["--state", "f64"]) == 1
    err = capsys.readouterr().err
    assert "--state f64 is 2-D only" in err


# JAX's CLI on test.txt --dim 3, both engines (fp32, CPU); the port's own
# problem data differ from XLA's by an ulp of fp32 sin at some points, and the
# mean error of 4096 fp32 terms is summed in another order, which moves the
# 7th significant digit (ROADMAP Queue 3): the bound is 2e-5 relative.
JAX_DIM3_TEST_ERROR = 1.948268e-02


@pytest.mark.parametrize("engine", ["compiled", "interpreted"])
def test_cli_dim3_matches_jax_cli(capsys, engine):
    argv = ["1", TEST_TXT, "--dim", "3", "--engine", engine, "--quiet", "--no-output"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    assert jcli.main(argv + ["--platform", "cpu"]) == 0
    theirs = capsys.readouterr().out
    assert "===== Final Result =====" in ours and "Time Used = " in ours
    assert _final_error(theirs) == JAX_DIM3_TEST_ERROR
    assert _final_error(ours) == pytest.approx(JAX_DIM3_TEST_ERROR, rel=2e-5)


def test_cli_dim3_writes_npz_and_checks_its_problem(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = ["1", TEST_TXT, "--dim", "3", "--device", "cpu", "--quiet"]
    assert cli.main(argv + ["--problem", "harmonic"]) == 0
    assert "Output file name = Sol_CPU_test.txt.npz" in capsys.readouterr().out
    with np.load(tmp_path / "Sol_CPU_test.txt.npz") as z:
        assert z["u"].shape == (16, 16, 16) and np.isfinite(z["u"]).all()
    assert cli.main(argv + ["--problem", "sine", "--no-output"]) == 1
    assert "unknown 3-D problem" in capsys.readouterr().err


@pytest.mark.slow
def test_cli_dim3_vcycle_matches_jax_cli(capsys):
    """Vcycle.txt --dim 3 at 256³ on the CPU: JAX's CLI prints 3.422244e-02."""
    argv = ["1", str(ROOT / "schedules" / "Vcycle.txt"), "--dim", "3", "--engine", "compiled",
            "--quiet", "--no-output", "--device", "cpu"]
    assert cli.main(argv) == 0
    assert _final_error(capsys.readouterr().out) == pytest.approx(3.422244e-02, rel=1e-4)


@pytest.mark.slow
def test_cli_dim3_vcycle_trigger_near_tie():
    """VcycleTrigger.txt --dim 3 (256³) on the CPU, both interpreted engines
    on the same fp32 data: every trigger node stops at the same sweep but
    the 64³ descend, whose slope at the stop lies within the noise of an
    fp32 sum of the trigger, so the summation decides it (XLA's fp32 sum
    278, the port's float64 sum 277; ROADMAP Queue 3, item 5); the one
    sweep moves Error by 3.0e-3 relative, inside chip_smoke.py's 5e-3 bound
    for this schedule."""
    import jax.numpy as jnp  # noqa: F401  (x64 is configured by conftest)

    import multigrid_poisson_solver_tpu as jmg
    from multigrid_poisson_solver_tpu.models import poisson3d as jp3
    from multigrid_poisson_solver_tpu.solver3 import Solver3D as JSolver3D
    from multigrid_poisson_solver_tpu_torch import Solver3D
    from multigrid_poisson_solver_tpu_torch.convert import (config_from_jax,
                                                            problem3_from_jax_grids,
                                                            program_from_jax)

    jprog = jmg.parse_cycle_path(ROOT / "schedules" / "VcycleTrigger.txt")
    jcfg = jmg.SolverConfig(collect_node_stats=True)
    theirs = JSolver3D(jp3.REFERENCE_PROBLEM_3D, jcfg).run(jprog)
    ours = Solver3D(problem3_from_jax_grids(jp3.REFERENCE_PROBLEM_3D), config_from_jax(jcfg),
                    device="cpu").run(program_from_jax(jprog))
    diff = [(a.kind, a.n, a.steps, b.steps) for a, b in zip(ours.nodes, theirs.nodes)
            if a.steps != b.steps]
    assert diff == [("descend", 64, 277, 278)]
    assert theirs.error_vs_analytic == pytest.approx(8.048455e-04, rel=1e-6)
    assert ours.error_vs_analytic == pytest.approx(theirs.error_vs_analytic, rel=5e-3)


def test_cli_tol_writes_csv_and_checkpoints(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = ["1", TEST_TXT, "--device", "cpu", "--quiet", "--tol", "1e-10", "--state", "tw32",
            "--max-cycles", "4", "--checkpoint", str(tmp_path / "ck")]
    assert cli.main(argv) == 0
    assert "Output file name = Sol_CPU_test.txt" in capsys.readouterr().out
    assert jio.read_solution_csv(tmp_path / "Sol_CPU_test.txt").shape == (16, 16)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir())[-1] == "mg-00000004.npz"


def test_cli_rejects_missing_file(capsys):
    assert cli.main(["1", "no_such_schedule.txt", "--device", "cpu"]) == 1
    assert "Cannot open file" in capsys.readouterr().err


def test_port_never_imports_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax\b|multigrid_poisson_solver_tpu\b(?!_torch))", re.M)
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        assert not pattern.search(path.read_text()), path
    code = ("import sys, multigrid_poisson_solver_tpu_torch, "
            "multigrid_poisson_solver_tpu_torch.cli, multigrid_poisson_solver_tpu_torch.convert, "
            "multigrid_poisson_solver_tpu_torch.compiled3, multigrid_poisson_solver_tpu_torch.solver3, "
            "multigrid_poisson_solver_tpu_torch.refine3, "
            "multigrid_poisson_solver_tpu_torch.ops.kernels3, "
            "multigrid_poisson_solver_tpu_torch.ops.transfers3;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'multigrid_poisson_solver_tpu')];"
            "sys.exit(1 if bad else 0)")
    assert subprocess.run([sys.executable, "-c", code], cwd=ROOT).returncode == 0


def test_chip_smoke_fails_without_a_gpu_or_the_repo(tmp_path):
    """chip_smoke.py exits non-zero and prints no result where there is no
    CUDA device, and in a directory that holds nothing else of the repo."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    runs = [(tmp_path, lone)]
    if not torch.cuda.is_available():
        runs.append((ROOT, ROOT / "chip_smoke.py"))
    for cwd, script in runs:
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
