"""Solver checkpoints on ``torch.distributed.checkpoint``.

PyTorch port of ``multigrid_poisson_solver_tpu/utils/orbax_checkpoint.py``
(``OrbaxCheckpointManager``, ``:42-103``). The plain ``.npz`` backend
(``utils.checkpoint``) is dependency-free; this one layers the same
``SolverState`` contract on PyTorch's distributed checkpoint format:

  * asynchronous saves: ``dcp.async_save`` copies the state to the host and
    writes it in a background thread, so the solve loop does not wait on the
    file system;
  * one step directory per save (``step-<cycle>``), committed when ``dcp``
    writes its ``.metadata`` file last, with rotation to the newest ``keep``;
  * the standard PyTorch checkpoint layout, readable by ``dcp.load``.

Drop-in: ``DistCheckpointManager`` has the ``maybe_save`` / ``latest``
surface of ``utils.checkpoint.CheckpointManager``, so
``IterativeRefinementSolver.solve(checkpoints=...)`` and
``IterativeRefinement3.solve(checkpoints=...)`` take either. The state is
saved from one process; ``dcp`` needs no process group for that.
"""

from __future__ import annotations

import json
import os
import shutil
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed.checkpoint as dcp

from .checkpoint import SolverState

_WORDS = ("u", "f", "u_lo", "u_lo2")
# dcp warns on every call made without a process group, which is this
# module's only use
_NO_GROUP = "torch.distributed is disabled, unavailable or uninitialized"


def _to_host(a) -> torch.Tensor:
    """A host copy of ``a`` that the solver can no longer change."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", copy=True).contiguous()
    return torch.from_numpy(np.array(a))


class DistCheckpointManager:
    """SolverState persistence via ``torch.distributed.checkpoint``.

    Same contract as ``utils.checkpoint.CheckpointManager``: ``maybe_save``
    on a cycle cadence with rotation, ``latest() -> SolverState | None``.
    With ``async_save=True`` (default) ``maybe_save`` returns once the state
    is copied to the host; one save is in flight at a time, and
    ``wait_until_finished()``, ``latest()`` and ``close()`` wait for it.
    """

    def __init__(self, directory: str | os.PathLike, every: int = 1,
                 keep: int = 3, async_save: bool = True):
        self.dir = Path(directory).absolute()
        self.every = max(1, every)
        self.keep = max(1, keep)
        self.async_save = async_save
        self._pending = None        # the in-flight save's future

    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step-{step:08d}"

    def steps(self) -> list[int]:
        """The committed steps, oldest first."""
        if not self.dir.is_dir():
            return []
        return sorted(int(p.name[5:]) for p in self.dir.glob("step-*")
                      if p.name[5:].isdigit() and (p / ".metadata").exists())

    def maybe_save(self, state: SolverState) -> bool:
        """Save if ``state.cycle`` is on the cadence and not saved yet; prune
        old steps once the save commits."""
        if state.cycle % self.every != 0:
            return False
        self.wait_until_finished()
        step = int(state.cycle)
        if step in self.steps():
            return False
        path = self._step_dir(step)
        shutil.rmtree(path, ignore_errors=True)     # an uncommitted leftover
        tree = {k: _to_host(getattr(state, k)) for k in _WORDS
                if getattr(state, k) is not None}
        meta = dict(state.meta or {})
        meta["cycle"] = step
        tree["meta"] = torch.frombuffer(bytearray(json.dumps(meta).encode()), dtype=torch.uint8)
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=_NO_GROUP)
            if self.async_save:
                self._pending = dcp.async_save(tree, checkpoint_id=str(path))
            else:
                dcp.save(tree, checkpoint_id=str(path))
                self._rotate()
        return True

    def _rotate(self) -> None:
        for step in self.steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def _load(self, step: int) -> SolverState:
        path = str(self._step_dir(step))
        md = dcp.FileSystemReader(path).read_metadata()
        tree = {k: torch.empty(v.size, dtype=v.properties.dtype)
                for k, v in md.state_dict_metadata.items()}
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=_NO_GROUP)
            dcp.load(tree, checkpoint_id=path)
        meta = json.loads(bytes(tree.pop("meta").numpy()).decode())
        arrays = {k: v.numpy() for k, v in tree.items()}
        return SolverState(u=arrays["u"], f=arrays["f"], u_lo=arrays.get("u_lo"),
                           u_lo2=arrays.get("u_lo2"), cycle=meta.pop("cycle", step),
                           meta=meta)

    def latest(self) -> Optional[SolverState]:
        """The newest committed state that loads, or None."""
        self.wait_until_finished()
        for step in reversed(self.steps()):
            try:
                return self._load(step)
            except (OSError, ValueError, RuntimeError, KeyError):
                continue    # unreadable: fall back to an older step
        return None

    def wait_until_finished(self) -> None:
        """Block until an in-flight async save has committed (and raise its
        error, if it failed)."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()
            self._rotate()

    def close(self) -> None:
        self.wait_until_finished()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
