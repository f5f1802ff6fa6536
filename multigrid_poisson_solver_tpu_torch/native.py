"""ctypes binding of the native runtime library (``native/mg_runtime.cpp``).

PyTorch port of ``multigrid_poisson_solver_tpu/native.py`` (its C ABI at
``native.py:37-104``): the Cycle.txt grammar parser and the multithreaded
Sol_* CSV writer and reader. Every entry point keeps the JAX package's
contract: the library is an acceleration, not a requirement, so each
returns ``None`` or ``False`` when the library is unavailable, and the
callers (``schedule.parse_cycle_file``, ``utils.io``) do the same work in
Python.

The port builds its own copy of the library from the repo's source, with
``native/Makefile``'s flags, into ``build/torch_native/`` beside the
package, and never writes into ``native/``. The file name carries a hash of
the source and the flags (as ``ops/build.py`` does), so an edited source
rebuilds. The build is race-free across processes: it holds an ``fcntl``
lock on ``build/torch_native/lock`` while it compiles to a temporary name,
then ``os.replace``s the file into place, so no two processes compile at
once and no process ever loads a partial file.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parent.parent
SOURCE = _REPO_ROOT / "native" / "mg_runtime.cpp"
BUILD_DIR = _REPO_ROOT / "build" / "torch_native"
# native/Makefile's CXXFLAGS and LDFLAGS
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra")
LD_FLAGS = ("-shared", "-pthread")
_ABI_VERSION = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


class _MgHeader(ctypes.Structure):
    _fields_ = [
        ("length", ctypes.c_double),
        ("min_x", ctypes.c_double),
        ("min_y", ctypes.c_double),
        ("con_step", ctypes.c_int32),
        ("con_n", ctypes.c_int32),
        ("n_max", ctypes.c_int32),
        ("n_min", ctypes.c_int32),
    ]


class _MgInstruction(ctypes.Structure):
    _fields_ = [
        ("kind", ctypes.c_int32),
        ("steps", ctypes.c_int32),
        ("next_n", ctypes.c_int32),
        ("option", ctypes.c_int32),
        ("target_error", ctypes.c_double),
    ]


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmg_runtime_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the current one exists; return its path.

    Raises ``OSError`` (no source, no compiler) or
    ``subprocess.SubprocessError`` (the compiler failed)."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise FileNotFoundError("no C++ compiler (g++) on PATH: the native runtime "
                                "cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)      # released when the file closes
        if out.exists():                       # another process built it meanwhile
            return out
        with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
            tmp_lib = Path(tmp) / out.name
            subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), *LD_FLAGS, "-o", str(tmp_lib)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp_lib, out)   # atomic: a loader sees no file or the whole file
    return out


def _declare(lib: ctypes.CDLL) -> None:
    lib.mg_parse_cycle.restype = ctypes.c_int32
    lib.mg_parse_cycle.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_MgHeader),
        ctypes.POINTER(_MgInstruction), ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_int32,
    ]
    lib.mg_write_csv.restype = ctypes.c_int32
    lib.mg_write_csv.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_int32,
    ]
    lib.mg_read_csv.restype = ctypes.c_int32
    lib.mg_read_csv.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int64,
    ]


def load() -> Optional[ctypes.CDLL]:
    """The loaded library (built first if needed), or None if it cannot be
    built or loaded; a failure is remembered for the process."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
            lib.mg_runtime_abi_version.restype = ctypes.c_int32
            if lib.mg_runtime_abi_version() != _ABI_VERSION:
                _load_failed = True
                return None
            _declare(lib)
            _lib = lib
        except (OSError, subprocess.SubprocessError):
            _load_failed = True
    return _lib


def available() -> bool:
    return load() is not None


# ---------------------------------------------------------------------------
# Cycle parsing
# ---------------------------------------------------------------------------

def parse_cycle_native(text: str):
    """Parse Cycle.txt text with the native parser into the port's
    ``schedule.CycleProgram``.

    Returns None if the library is unavailable; raises ValueError on grammar
    errors, as ``schedule.parse_cycle_file`` does."""
    lib = load()
    if lib is None:
        return None
    from .schedule import Ascend, CoarseSolve, CycleProgram, Descend

    raw = text.encode()
    hdr = _MgHeader()
    max_ins = max(64, len(raw))        # the token count bounds the instruction count
    buf = (_MgInstruction * max_ins)()
    err = ctypes.create_string_buffer(256)
    count = lib.mg_parse_cycle(raw, len(raw), ctypes.byref(hdr), buf, max_ins,
                               err, len(err))
    if count < 0:
        raise ValueError(f"Bad cycle file: {err.value.decode()}")

    instructions = []
    for ins in buf[:count]:
        if ins.kind == -1:
            instructions.append(Descend(next_n=ins.next_n, steps=ins.steps))
        elif ins.kind == 0:
            instructions.append(CoarseSolve(target_error=ins.target_error,
                                            option=ins.option))
        else:
            instructions.append(Ascend(steps=ins.steps))
    return CycleProgram(length=hdr.length, min_x=hdr.min_x, min_y=hdr.min_y,
                        n_max=hdr.n_max, instructions=tuple(instructions))


# ---------------------------------------------------------------------------
# CSV I/O
# ---------------------------------------------------------------------------

def write_csv_native(rows: np.ndarray, path: str, decimals: int = 6) -> bool:
    """Write ``rows`` (already in file order) as CSV, ``%.{decimals}f`` each
    value; False if the library is unavailable."""
    lib = load()
    if lib is None:
        return False
    arr = np.ascontiguousarray(rows, dtype=np.float64)
    if arr.ndim != 2:
        raise ValueError(f"expected a 2D array, got shape {arr.shape}")
    rc = lib.mg_write_csv(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        arr.shape[0], arr.shape[1], str(path).encode(), decimals)
    if rc != 0:
        raise OSError(f"mg_write_csv failed with code {rc} for {path}")
    return True


def read_csv_native(path: str, n_rows: int, n_cols: int) -> Optional[np.ndarray]:
    """Read an (n_rows, n_cols) CSV of numbers, rows in file order; None if
    the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    out = np.empty((n_rows, n_cols), dtype=np.float64)
    rc = lib.mg_read_csv(str(path).encode(),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                         n_rows, n_cols)
    if rc != 0:
        raise OSError(f"mg_read_csv failed with code {rc} for {path}")
    return out
