"""The port's native runtime binding (multigrid_poisson_solver_tpu_torch.native)
against the port's and the JAX package's Python implementations.

The native cycle parser must give the same CycleProgram as
``schedule.parse_cycle_file`` of both packages on every grammar variant (the
cases of tests/test_native.py), and the native CSV writer the same bytes as
the numpy writer and the JAX package's writer. The binding builds its own
library into a build directory under a file lock and renames it into place,
so processes that load it at once all succeed; with the library unavailable
every entry point returns None or False and the writers still write the
same bytes.

Whether the library can be built is decided inside a fixture, never while
this module is imported.
"""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import multigrid_poisson_solver_tpu as jmg
import multigrid_poisson_solver_tpu_torch as tmg
from multigrid_poisson_solver_tpu import native as jnative
from multigrid_poisson_solver_tpu.schedule import parse_cycle_file as jparse
from multigrid_poisson_solver_tpu.utils import io as jio
from multigrid_poisson_solver_tpu_torch import native
from multigrid_poisson_solver_tpu_torch.convert import program_from_jax
from multigrid_poisson_solver_tpu_torch.schedule import parse_cycle_file, to_cycle_file
from multigrid_poisson_solver_tpu_torch.utils import io as tio

ROOT = Path(__file__).resolve().parents[1]
SCHEDULE_DIR = ROOT / "schedules"
BUNDLED = ["test.txt", "Vcycle.txt", "VcycleTrigger.txt", "Wcycle.txt"]


def rounded6(u):
    """The values a %.6f file holds."""
    return np.array([[float(f"{v:.6f}") for v in row] for row in np.asarray(u, np.float64)])


@pytest.fixture(autouse=True)
def jax_writer_in_python(monkeypatch):
    """The JAX package's writer on its Python path: its binding would run
    ``make`` in native/ when its library is absent."""
    monkeypatch.setattr(jnative, "load", lambda: None)


@pytest.fixture
def lib():
    if not native.available():
        pytest.skip("the native runtime library cannot be built here (no g++?)")
    return native


@pytest.fixture
def unavailable(monkeypatch):
    """The binding as it is where the library cannot be built or loaded."""
    monkeypatch.setattr(native, "load", lambda: None)
    return native


@pytest.mark.parametrize("name", BUNDLED)
def test_parser_matches_python_on_bundled(lib, name):
    text = (SCHEDULE_DIR / name).read_text()
    got = lib.parse_cycle_native(text)
    assert got == parse_cycle_file(text)
    assert got == program_from_jax(jparse(text))


@pytest.mark.parametrize("maker", [
    lambda m: m.v_cycle(129, n_min=8, steps=3),
    lambda m: m.w_cycle(65, n_min=8, steps=2),
    lambda m: m.fmg(65, n_min=8, steps=2),
    lambda m: m.v_cycle(64, n_min=5, steps=-1, coarsen=2),
], ids=["v_cycle", "w_cycle", "fmg", "v_cycle-coarsen2"])
def test_parser_roundtrip_generated(lib, maker):
    program = maker(tmg)
    text = to_cycle_file(program)
    assert lib.parse_cycle_native(text) == parse_cycle_file(text) == program
    assert program == program_from_jax(maker(jmg))


@pytest.mark.parametrize("bad,msg", [
    ("1.0 0 0\n3 1\n16 100\n-1\n2\n", "descends below"),
    ("1.0 0 0\n0 0\n16 4\n1\n3\n2\n", "no coarser level"),
    ("1.0 0 0\n0 0\n16 4\n-1\n3 20\n2\n", "does not coarsen"),
    ("1.0 0 0\n0 0\n16 4\n-1\n3", "ended while reading"),
    ("1.0 0 0\n0 0\n16 4\n7\n", "unknown node"),
])
def test_parser_errors_match(lib, bad, msg):
    with pytest.raises(ValueError, match=msg):
        parse_cycle_file(bad)
    with pytest.raises(ValueError, match=msg):
        jparse(bad)
    with pytest.raises(ValueError, match="Bad cycle file"):
        lib.parse_cycle_native(bad)


def test_parser_con_n3_cross_parity(lib):
    """con_N=3 (odd-halve): both parsers accept it and give the same
    instructions; con_N=4 is refused by both."""
    text = "1.0 0.0 0.0\n3 3\n65 8\n-1\n-1\n-1\n0\n1e-8 1\n1\n1\n1\n2\n"
    program = parse_cycle_file(text)
    assert [ins.next_n for ins in program.instructions
            if isinstance(ins, tmg.Descend)] == [33, 17, 9]
    assert lib.parse_cycle_native(text) == program == program_from_jax(jparse(text))

    bad = text.replace("3 3\n", "3 4\n", 1)
    with pytest.raises(ValueError, match="con_N"):
        parse_cycle_file(bad)
    with pytest.raises(ValueError, match="con_N"):
        lib.parse_cycle_native(bad)


def test_csv_writer_bytes_native_numpy_jax(lib, tmp_path, monkeypatch, rng):
    u = rng.standard_normal((37, 41)).astype(np.float32)
    t = torch.from_numpy(u)
    tio.write_solution_csv(t, tmp_path / "native.csv")          # the native path
    assert lib.write_csv_native(u.astype(np.float64)[::-1], tmp_path / "direct.csv")
    jio.write_solution_csv(u, tmp_path / "jax.csv")
    monkeypatch.setattr(native, "load", lambda: None)
    tio.write_solution_csv(t, tmp_path / "numpy.csv")           # the numpy path
    want = (tmp_path / "numpy.csv").read_bytes()
    for name in ("native.csv", "direct.csv", "jax.csv"):
        assert (tmp_path / name).read_bytes() == want, name


def test_csv_roundtrip_through_io(lib, tmp_path, rng):
    u = rng.standard_normal((65, 65))
    path = tmp_path / "sol.csv"
    tio.write_solution_csv(torch.from_numpy(u), path)
    back = tio.read_solution_csv(path)
    np.testing.assert_array_equal(back, rounded6(u))
    fast = lib.read_csv_native(str(path), 65, 65)
    np.testing.assert_array_equal(fast[::-1], back)
    np.testing.assert_array_equal(back, jio.read_solution_csv(path))


# --- the build -----------------------------------------------------------------

# A child loads the binding from its file (no package import, so the six
# start together), waits for the go file, then builds and loads the library.
_CHILD = """
import importlib.util, sys, time
from pathlib import Path
spec = importlib.util.spec_from_file_location("mg_native_child", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod.BUILD_DIR = Path(sys.argv[2])
Path(sys.argv[3]).touch()
go = Path(sys.argv[4])
while not go.exists():
    time.sleep(0.001)
lib = mod.load()
assert lib is not None, "load failed"
assert lib.mg_runtime_abi_version() == 1
print("ok")
"""


def test_six_processes_load_a_fresh_build_at_once(tmp_path):
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("no g++: the library cannot be built here")
    build_dir = tmp_path / "torch_native"
    go = tmp_path / "go"
    procs = []
    for i in range(6):
        ready = tmp_path / f"ready{i}"
        procs.append((ready, subprocess.Popen(
            [sys.executable, "-c", _CHILD, native.__file__, str(build_dir), str(ready),
             str(go)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    deadline = time.monotonic() + 60
    while not all(r.exists() for r, _ in procs) and time.monotonic() < deadline:
        time.sleep(0.01)
    go.touch()
    results = [p.communicate(timeout=120) + (p.returncode,) for _, p in procs]
    for out, err, rc in results:
        assert rc == 0 and out.strip() == "ok", err[-2000:]
    built = {p.name for p in build_dir.iterdir()} - {"lock"}
    assert built == {native.library_path().name}   # no temporary left


def test_build_goes_to_its_own_directory():
    path = native.library_path()
    assert path.parent == ROOT / "build" / "torch_native"
    assert path.parent != native.SOURCE.parent
    assert path.name.startswith("libmg_runtime_") and path.suffix == ".so"


# --- without the library --------------------------------------------------------

@pytest.mark.parametrize("call,want", [
    (lambda n: n.available(), False),
    (lambda n: n.parse_cycle_native("1.0 0 0\n3 1\n16 8\n-1\n0\n1e-8 0\n1\n2\n"), None),
    (lambda n: n.write_csv_native(np.zeros((3, 3)), "never_written.csv"), False),
    (lambda n: n.read_csv_native("never_read.csv", 3, 3), None),
], ids=["available", "parse_cycle_native", "write_csv_native", "read_csv_native"])
def test_entry_points_without_library(unavailable, call, want):
    assert call(unavailable) is want
    assert not Path("never_written.csv").exists()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_writer_without_library_matches_jax(unavailable, tmp_path, rng, dtype):
    u = torch.from_numpy(rng.standard_normal((33, 33))).to(dtype)
    tio.write_solution_csv(u, tmp_path / "port.csv")
    jio.write_solution_csv(u.numpy(), tmp_path / "jax.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    np.testing.assert_array_equal(tio.read_solution_csv(tmp_path / "port.csv"),
                                  rounded6(u.numpy()))
