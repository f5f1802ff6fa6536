"""Build and load the port's CUDA kernels (``ops/csrc``) as one shared library.

No counterpart in the JAX package: Pallas kernels compile inside ``jit``.
Here the sources are compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface and loaded with ``ctypes``; no
PyTorch header is compiled, so a cold build takes seconds.

The build runs at first use, from the sources in the checkout, into
``build/torch_kernels/`` beside the package: one ``nvcc`` per ``.cu`` file,
all started together, then one link. The library's file name carries a hash
of the sources and flags, so an edited source rebuilds and a current one is
reused. Every entry point returns a ``cudaError_t``; ``ops.kernels`` raises
on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_U = ctypes.c_uint64
# C signatures of the entry points (pointers and the stream as void*).
SIGNATURES = {
    "mg_num_tiles": ([_I], _I),
    "mg_error_string": ([_I], ctypes.c_char_p),
    "mg_jacobi": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _P], _I),
    "mg_jacobi_errs": ([_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _P], _I),
    "mg_rbgs": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P], _I),
    "mg_residual": ([_P, _P, _P, _I, _F, _I, _P], _I),
    "mg_residual_mw": ([_P, _P, _P, _P, _P, _I, _I, _F, _P], _I),
    "mg_descend": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _P],
                   _I),
    "mg_ascend": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _P], _I),
    "mg_chain_descend": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P], _I),
    "mg_chain_ascend": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P, _P, _F, _P], _I),
    "mg_trigger": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _I, _P], _I),
    "mg_trigger_stream": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _I,
                           _P], _I),
    "mg3_jacobi": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _D, _P], _I),
    "mg3_descend": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _D,
                     _P], _I),
    "mg3_ascend": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _D, _P], _I),
    "mg3_residual": ([_P, _P, _P, _I, _I, _I, _I, _I, _F, _P], _I),
    "mg3_jacobi_errs": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _D, _P], _I),
    "mg3_trigger": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _D, _F, _I,
                     _P], _I),
    "mg3_trigger_stream": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _D,
                            _F, _I, _P], _I),
    "mg3_residual_mw": ([_P, _P, _P, _P, _P, _I, _I, _F, _P], _I),
    # shard modes: the block's geometry (n, row0, col0, rows, cols, ext_r, ext_c)
    "mg_num_tiles_block": ([_I, _I], _I),
    "mg_jacobi_shard": ([_P] * 5 + [_I] * 7 + [_I, _I, _I, _F, _F, _F, _F, _F, _P], _I),
    "mg_jacobi_errs_shard": ([_P] * 5 + [_I] * 7 + [_I, _I, _F, _F, _F, _F, _P], _I),
    "mg_rbgs_shard": ([_P] * 5 + [_I] * 7 + [_I, _I, _I, _F, _F, _P], _I),
    "mg_residual_shard": ([_P] * 3 + [_I] * 7 + [_F, _I, _P], _I),
    "mg_descend_shard": ([_P] * 6 + [_I] * 7 + [_I, _I, _I, _I, _F, _F, _F, _F, _F, _P], _I),
    "mg_ascend_shard": ([_P] * 6 + [_I] * 7 + [_I] * 4 + [_I, _I, _F, _F, _F, _F, _P], _I),
    # 3-D shard modes: the shard's planes (n, z0, nz, ext)
    "mg3_jacobi_shard": ([_P] * 5 + [_I] * 4 + [_I] * 3 + [_I] * 3 + [_F] * 3 + [_P], _I),
    "mg3_jacobi_errs_shard": ([_P] * 5 + [_I] * 4 + [_I] * 2 + [_I] * 3 + [_F] * 3 + [_P], _I),
    "mg3_jacobi_residual_shard": ([_P] * 4 + [_I] * 4 + [_I] * 3 + [_I] * 3 + [_F] * 3 + [_P],
                                  _I),
    "mg3_descend_shard": ([_P] * 6 + [_I] * 4 + [_I] * 4 + [_I] * 3 + [_F] * 3 + [_P], _I),
    "mg3_ascend_shard": ([_P] * 6 + [_I] * 4 + [_I] * 2 + [_I] * 2 + [_I] * 3 + [_F] * 3 + [_P],
                         _I),
    "mg3_residual_shard": ([_P] * 3 + [_I] * 4 + [_I] + [_I] * 3 + [_F, _P], _I),
    # the ring kernels (ops.rdma)
    "mg_rdma_jacobi": ([_P] * 4 + [_I] * 4 + [_P] * 3 + [_U, _F, _F, _F, _P], _I),
    "mg_rdma_trigger": ([_P] * 5 + [_I, _I] + [_P] * 7 + [_I, _F, _F, _F, _F, _F, _I, _U, _P],
                        _I),
    # the 3-D ring kernels (ops.rdma3): shard pointer arrays, the shards'
    # origins and z chunks, then the workspace's pointer array and the tag
    "mg3_rdma_jacobi": ([_P] * 5 + [_I] * 7 + [_P] * 3 + [_U, _F, _F, _F, _P], _I),
    "mg3_rdma_descend": ([_P] * 6 + [_I] * 8 + [_P] * 3 + [_U, _F, _F, _F, _P], _I),
    "mg3_rdma_ascend": ([_P] * 6 + [_I] * 6 + [_P] * 3 + [_U, _F, _F, _F, _P], _I),
    "mg3_rdma_trigger": ([_P] * 6 + [_I] * 5 + [_P] * 4 + [_U, _F, _F, _F, _D, _F, _I, _P],
                         _I),
}

_lib = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmg_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the sources unless the current library exists; return its path.
    nvcc's report (registers, shared memory, spills) goes to ``<lib>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    log = out.with_suffix(".log")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in (s for s in sources() if s.suffix == ".cu"):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.PIPE, text=True)))
        tmp_lib = Path(tmp) / out.name
        steps = []
        for cmd, _, proc in jobs:
            stdout, stderr = proc.communicate()
            steps.append((cmd, proc.returncode, stdout + stderr))
        if all(rc == 0 for _, rc, _ in steps):
            cmd = [nvcc, "-shared", "-o", str(tmp_lib), *[str(obj) for _, obj, _ in jobs]]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            steps.append((cmd, proc.returncode, proc.stdout + proc.stderr))
        log.write_text("".join(f"{' '.join(cmd)}\n{text}" for cmd, _, text in steps))
        failed = [(cmd, rc, text) for cmd, rc, text in steps if rc != 0]
        if failed:
            cmd, rc, text = failed[0]
            raise RuntimeError(f"nvcc failed (rc {rc}) on {cmd[-1]}; see {log}:\n"
                               + text[-4000:])
        os.replace(tmp_lib, out)   # atomic: a concurrent loader never sees a partial file
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), signatures declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib
