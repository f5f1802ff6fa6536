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
                                        (["--dim", "3"], "--dim 3")])
def test_cli_unported_modes_exit_1(capsys, extra, what):
    """--dim 3 is not yet ported and exits 1; --tol (iterative refinement)
    is ported and exits 0 with the deep-solve result block."""
    argv = ["1", TEST_TXT, "--device", "cpu", "--no-output", "--quiet", *extra]
    if what == "--tol":
        assert cli.main(argv + ["--max-cycles", "3"]) == 0
        out = capsys.readouterr().out
        assert re.search(r"RelRes = \S+ after 3 cycles\n\s+Error = \S+\nTime Used = ", out), out
        return
    assert cli.main(argv) == 1
    err = capsys.readouterr().err
    assert what in err and "not yet ported" in err


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
            "multigrid_poisson_solver_tpu_torch.cli, multigrid_poisson_solver_tpu_torch.convert;"
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
