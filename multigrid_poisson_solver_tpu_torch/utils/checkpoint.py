"""Checkpoint / resume for long solves.

PyTorch port of ``multigrid_poisson_solver_tpu/utils/checkpoint.py``, in the
same file format: a plain ``.npz`` holding the solution words, the RHS and a
JSON metadata blob (cycle counter, schedule fingerprint, ``format_version``
1), written atomically (temporary file, then rename) so a preempted write
never corrupts the previous checkpoint. Arrays are saved as numpy arrays of
their own dtype; tensors are copied to the host first.

The port saves plain (n, n) grids and (n, n, n) volumes. The JAX package
saves its padded layouts, (rows × 16, lanes × 128) in 2-D and the
(n, rows × 16, lanes × 128) bricks of its 3-D refinement; ``crop_to`` takes
either, so the port resumes a checkpoint the JAX package wrote.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

FORMAT_VERSION = 1


def schedule_fingerprint(program) -> str:
    """Stable hash of a CycleProgram (schedule and geometry), for resume
    compatibility checks; equal to the JAX package's for the same program."""
    from ..schedule import to_cycle_file

    return hashlib.sha256(to_cycle_file(program).encode()).hexdigest()[:16]


def crop_to(a: np.ndarray, n: int, dim: int = 2) -> Optional[np.ndarray]:
    """The (n,)·dim grid of a saved array: the array itself, or the corner of
    the JAX package's padded layout of an n-grid (rows × 16 and lanes × 128,
    the z planes unpadded in 3-D); None if it is neither."""
    padded = (n,) * (dim - 2) + (-(-n // 16) * 16, -(-n // 128) * 128)
    if a.shape == (n,) * dim:
        return a
    if a.shape == padded:
        return a[(slice(0, n),) * dim]
    return None


@dataclasses.dataclass
class SolverState:
    """Everything needed to resume an iterative solve."""

    u: Any                              # solution / high word, (n, n)
    f: Any                              # RHS (n, n)
    u_lo: Any = None                    # second word (df32/tw32 state)
    u_lo2: Any = None                   # third word (tw32 state)
    cycle: int = 0                      # cycles completed
    meta: Optional[dict[str, Any]] = None


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def save_checkpoint(path: str | os.PathLike, state: SolverState) -> None:
    """Atomically write ``state`` to ``path`` (.npz)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {"u": _host(state.u), "f": _host(state.f)}
    if state.u_lo is not None:
        arrays["u_lo"] = _host(state.u_lo)
    if state.u_lo2 is not None:
        arrays["u_lo2"] = _host(state.u_lo2)
    meta = dict(state.meta or {})
    meta.update({"cycle": int(state.cycle), "format_version": FORMAT_VERSION})
    arrays["_meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)

    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str | os.PathLike) -> SolverState:
    with np.load(path) as z:
        meta = json.loads(bytes(z["_meta_json"]).decode())
        if meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(f"checkpoint {path} has format_version "
                             f"{meta.get('format_version')}; expected {FORMAT_VERSION}")
        return SolverState(
            u=z["u"], f=z["f"],
            u_lo=z["u_lo"] if "u_lo" in z.files else None,
            u_lo2=z["u_lo2"] if "u_lo2" in z.files else None,
            cycle=meta.pop("cycle", 0), meta=meta)


class CheckpointManager:
    """Rotating checkpoints: keep the last ``keep`` files, save every
    ``every`` cycles. ``latest()`` resolves the resume point."""

    def __init__(self, directory: str | os.PathLike, every: int = 1, keep: int = 3,
                 prefix: str = "mg"):
        self.dir = Path(directory)
        self.every = max(1, every)
        self.keep = max(1, keep)
        self.prefix = prefix

    def _path(self, cycle: int) -> Path:
        return self.dir / f"{self.prefix}-{cycle:08d}.npz"

    def existing(self) -> list[Path]:
        if not self.dir.is_dir():
            return []
        return sorted(self.dir.glob(f"{self.prefix}-*.npz"))

    def latest(self) -> Optional[SolverState]:
        for path in reversed(self.existing()):
            try:
                return load_checkpoint(path)
            except (ValueError, OSError, KeyError):
                continue  # half-written or incompatible: fall back to an older one
        return None

    def maybe_save(self, state: SolverState) -> bool:
        """Save if ``state.cycle`` is on the cadence; prune old files."""
        if state.cycle % self.every != 0:
            return False
        save_checkpoint(self._path(state.cycle), state)
        for old in self.existing()[:-self.keep]:
            old.unlink(missing_ok=True)
        return True
