"""3-D deep convergence: multi-word fp32 iterative refinement on cubic grids.

PyTorch port of ``multigrid_poisson_solver_tpu/refine3.py``: the 2-D
refinement (``refine.py``) one dimension up. The state is a double-float
("df32", ~2⁻⁴⁸) or triple-word ("tw32", ~2⁻⁷²) fp32 expansion, and each
outer cycle applies one fp32 multigrid V-cycle to the correction equation:

    r  = f − A₇·(u₀ + u₁ [+ u₂])   the compensated 7-point residual;
    e  ≈ A₇⁻¹ r                    one ``v_cycle3`` (its kernel path on the
                                   card: the fused legs and the smoother);
    u += e                          the two-sum add into the words
                                   (``refine.df_add`` / ``tw_add``).

The residual is, on the kernel path, the multi-word kernel
(``ops.kernels3.residual_df3`` / ``residual_tw3``, kernel 14; its twin on
CPU tensors), and on the plain path JAX's XLA forms (``residual_df3``,
``residual_tw3`` here). Both forms add the rounding error of hi·h⁻²
(Dekker's exact product): it is 0 on 2^k + 1 grids, where h⁻² is a power of
two; elsewhere it is what lets the state reach 1e-10 (JAX's CPU runs get it
from the FMA that XLA contracts ``hi·h⁻² − f`` into).

JAX runs the whole loop as one ``lax.while_loop`` on the device. Here the
host drives it, as in ``refine.py``: per cycle one V-cycle, the add, one
residual, one norm and one read of the relative residual for the stop test.
The state is kept as plain (n, n, n) words; JAX keeps its padded brick
layout, which ``utils.checkpoint.crop_to`` crops when the port resumes one
of its checkpoints.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .models.poisson3d import Problem3D, _nb_sum3, v_cycle3
from .ops import kernels as K
from .ops import kernels3 as K3
from .refine import df_add, tw_add
from .solver import synchronize

STATES3 = ("df32", "tw32")


def _on_interior3(r_int: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    r = torch.zeros_like(like)
    r[1:-1, 1:-1, 1:-1] = r_int
    return r


def residual_df3(u_hi, u_lo, f, h: float):
    """Compensated residual of the double-float pair state, 0 off the
    interior (JAX's ``refine3.residual_df3``): the u_hi stencil sum in
    error-free two-sums, u_lo's in plain fp32, plus the exact rounding error
    of hi·h⁻²."""
    c = (slice(1, -1),) * 3
    uc = u_hi[c]
    hi, lo = K._two_sum(u_hi[:-2, 1:-1, 1:-1], u_hi[2:, 1:-1, 1:-1])
    for t in (u_hi[1:-1, :-2, 1:-1], u_hi[1:-1, 2:, 1:-1], u_hi[1:-1, 1:-1, :-2],
              u_hi[1:-1, 1:-1, 2:]):
        hi, e = K._two_sum(hi, t)
        lo = lo + e
    for _ in range(6):
        hi, e = K._two_sum(hi, -uc)
        lo = lo + e
    slo = _nb_sum3(u_lo) - 6.0 * u_lo[c]
    inv_h2 = torch.tensor(1.0 / (h * h), dtype=f.dtype, device=f.device)
    p, pe = K._two_prod(hi, inv_h2)
    return _on_interior3(((p - f[c]) + pe) + (lo + slo) * inv_h2, u_hi)


def residual_tw3(u0, u1, u2, f, h: float):
    """Compensated residual of the triple-word state, 0 off the interior
    (JAX's ``refine3.residual_tw3``: doubly compensated u0 / u1 chains, a
    plain u2 sum, the big term first). Its arithmetic is the multi-word
    kernel's, so this is that kernel's twin."""
    return K3.residual_tw3_torch(u0, u1, u2, f, h)


@dataclasses.dataclass
class Refine3Report:
    u: torch.Tensor                 # best fp32 representation, (n, n, n)
    u_lo: torch.Tensor              # second word
    rel_residual: float             # compensated ‖r‖₂/‖f‖₂ at exit
    cycles: int
    wall_time_s: float
    error_vs_analytic: Optional[float] = None


class IterativeRefinement3:
    """Solve the 3-D Poisson problem to a relative-residual target.

    ``state`` is "df32" or "tw32" (the inner V-cycles stay fp32). The inner
    cycle is ``v_cycle3`` with ``pre``/``post`` sweeps and ω = ``omega``.
    ``kernels`` routes the hot path: "auto" (the CUDA kernels on a CUDA
    device), "cuda" or "torch". Runs on ``device`` ("cuda" unless the caller
    asks for "cpu")."""

    def __init__(self, problem: Problem3D, n: int, max_cycles: int = 60,
                 state: str = "df32", pre: int = 3, post: int = 3,
                 omega: float = 6.0 / 7.0, kernels: str = "auto", dtype=torch.float32,
                 device="cuda"):
        if state not in STATES3:
            raise ValueError(f"unknown state {state!r} (df32 or tw32)")
        self.problem, self.n, self.state = problem, n, state
        self.max_cycles = max_cycles
        self.pre, self.post, self.omega = pre, post, omega
        self.dtype = dtype
        self.device = torch.device(device)
        self.h = 1.0 / (n - 1)
        self.use_kernels = K.use_kernels(kernels, self.device)
        if self.use_kernels and dtype != torch.float32:
            raise TypeError(f"the CUDA kernels take float32, got dtype={dtype}; "
                            f"use kernels='torch' for other dtypes")
        if self.use_kernels:
            self._res_df, self._res_tw = K3.residual_df3, K3.residual_tw3
        else:
            self._res_df, self._res_tw = residual_df3, residual_tw3

    # --- the state ------------------------------------------------------------

    def initial_state(self):
        """(u0, u1): the Dirichlet faces and a zero interior, and zeros."""
        u0 = self.problem.boundary_grid(self.n, self.dtype, self.device)
        return u0, torch.zeros_like(u0)

    def init_rhs(self) -> torch.Tensor:
        return (self.problem.source_grid(self.n, self.dtype, self.device)
                + self.problem.boundary_grid(self.n, self.dtype, self.device))

    def _fingerprint(self) -> str:
        return (f"refine3/{self.problem.name}/n={self.n}/{self.state}/"
                f"{str(self.dtype).removeprefix('torch.')}")

    def _res(self, words, f):
        if len(words) == 3:
            return self._res_tw(*words, f, self.h)
        return self._res_df(*words, f, self.h)

    def _correction(self, rhs: torch.Tensor) -> torch.Tensor:
        """One V-cycle on A·e = rhs with a zero Dirichlet boundary."""
        return v_cycle3(torch.zeros_like(rhs), rhs, self.h, pre=self.pre, post=self.post,
                        omega=self.omega, kernels="cuda" if self.use_kernels else "torch")

    def _den(self, f: torch.Tensor, r0: torch.Tensor) -> torch.Tensor:
        """‖f‖ over the interior; the initial state's residual where f ≈ 0
        (harmonic problems), as JAX's ``make_den``."""
        nf = torch.linalg.vector_norm(f[1:-1, 1:-1, 1:-1]).to(r0.dtype)
        return torch.where(nf > 1e-20, nf, torch.clamp(r0, min=1e-30))

    def _run(self, words, f, tol: float, budget: int):
        """Refine ``words`` for at most ``budget`` cycles. Returns (words,
        rel, cycles run)."""
        i0, i1 = self.initial_state()
        fresh = (i0, i1, torch.zeros_like(i0)) if len(words) == 3 else (i0, i1)
        den = self._den(f, torch.linalg.vector_norm(self._res(fresh, f)))
        r = self._res(words, f)
        rel = torch.linalg.vector_norm(r) / den
        # the stop test in the state's dtype, as JAX's weakly typed compare
        tol_t = float(np.float32(tol))
        k = 0
        while k < budget and float(rel) > tol_t:
            e = self._correction(-r)
            words = tw_add(*words, e) if len(words) == 3 else df_add(*words, e)
            r = self._res(words, f)
            rel = torch.linalg.vector_norm(r) / den
            k += 1
        return words, rel, k

    def _fresh(self):
        u0, u1 = self.initial_state()
        return (u0, u1, torch.zeros_like(u0)) if self.state == "tw32" else (u0, u1)

    # --- solving --------------------------------------------------------------

    def solve(self, tol: float = 1e-8, checkpoints=None,
              checkpoint_chunk: int = 10) -> Refine3Report:
        """Refine to ``tol``. With a ``CheckpointManager`` in ``checkpoints``
        the loop runs in chunks of ``checkpoint_chunk`` cycles, persisting
        (and resuming) every word between chunks: the same contract as the
        2-D ``IterativeRefinementSolver.solve``."""
        f = self.init_rhs()
        synchronize(self.device)
        start = time.perf_counter()
        if checkpoints is None:
            words, rel, k = self._run(self._fresh(), f, tol, self.max_cycles)
        else:
            words, rel, k = self._solve_checkpointed(f, tol, checkpoints, checkpoint_chunk)
        rel_f = float(rel)
        synchronize(self.device)
        wall = time.perf_counter() - start
        err = None
        if self.problem.analytic is not None:
            ua = self.problem.analytic_grid(self.n, self.dtype, self.device)
            err = float(torch.mean(torch.abs(words[0] - ua)))
        return Refine3Report(u=words[0], u_lo=words[1], rel_residual=rel_f, cycles=int(k),
                             wall_time_s=wall, error_vs_analytic=err)

    def _resume(self, saved):
        """The words a checkpoint holds (the port's (n, n, n) arrays, or the
        JAX package's padded ones, cropped), or None if it does not fit."""
        from .utils.checkpoint import crop_to

        n = self.n
        if saved is None or not saved.meta or saved.meta.get("schedule") != self._fingerprint():
            return None
        if crop_to(saved.u, n, dim=3) is None:
            return None

        def word(a):
            w = None if a is None else crop_to(a, n, dim=3)
            if w is None:
                return torch.zeros((n, n, n), dtype=self.dtype, device=self.device)
            return torch.from_numpy(np.ascontiguousarray(w)).to(self.device, self.dtype)

        words = (word(saved.u), word(saved.u_lo))
        return words + ((word(saved.u_lo2),) if self.state == "tw32" else ())

    def _solve_checkpointed(self, f, tol: float, manager, chunk: int):
        """Host loop in chunks with persistence (utils.checkpoint): every
        chunk's words are saved, so a resume loses no precision."""
        from .utils.checkpoint import SolverState

        fp = self._fingerprint()
        resumed = manager.latest()
        words = self._resume(resumed)
        done = resumed.cycle if words is not None else 0
        if words is None:
            words = self._fresh()
        rel = None
        while done < self.max_cycles:
            words, rel, k = self._run(words, f, tol, min(chunk, self.max_cycles - done))
            done += k
            manager.maybe_save(SolverState(f=f, cycle=done, meta={"schedule": fp, "tol": tol},
                                           **dict(zip(("u", "u_lo", "u_lo2"), words))))
            if float(rel) <= tol:
                break
        if rel is None:
            # resumed at the cycle budget: report the restored state's residual
            words, rel, _ = self._run(words, f, tol, 0)
        return words, rel, done


def solve_to_tolerance3(problem: Problem3D, n: int, tol: float = 1e-8,
                        max_cycles: int = 60, state: str = "df32",
                        **kw) -> Refine3Report:
    """One call: 3-D iterative refinement until ‖r‖/‖f‖ ≤ tol."""
    return IterativeRefinement3(problem, n, max_cycles, state, **kw).solve(tol)
