"""Deep convergence: mixed-precision iterative refinement to a residual target.

PyTorch port of ``multigrid_poisson_solver_tpu/refine.py``. An fp32 iterate
cannot represent a Poisson solution to better than eps·‖u‖·‖A‖ in
residual (at 8193² that floor is O(0.1) relative), so the state is kept as
an unevaluated sum of fp32 words and refined by fp32 multigrid cycles:

    state:  u as "df32" (two words, ~2⁻⁴⁸), "tw32" (three words, ~2⁻⁷²) or
            "f64" (one float64 array: native on the GPU);
    step:   r = A·u − f  the compensated residual of the state
                         (``ops.kernels.residual_df`` / ``residual_tw``:
                         the multi-word residual kernel; float64 for f64);
            e ≈ A⁻¹(−r)  one fp32 cycle of the compiled engine on the
                         correction problem (zero source, zero boundary);
            u += e       the two-sum (multi-word) add.

JAX runs the whole loop as one ``lax.while_loop`` on the device. Here the
host drives it: per cycle one engine cycle, the add, one residual launch,
one norm and one read of the relative residual to the host for the stop
test. The residual of the df32 and tw32 states is the multi-word kernel's
function on every path (its plain twin on the CPU, with
``kernels="torch"`` and under a policy), so the kernel and plain runs
compute the same refinement; with two words both get the doubly compensated
chain, which is more accurate than ``residual_df_p`` (kept here as JAX's
form).

Under a sharding policy (``policy=``, JAX's ``refine.py`` 2-D policy
argument) the correction cycle runs on the policy's mesh
(``CompiledCycle(policy=...)``, which lays each right-hand side out by it)
and the state lives on the mesh's first device as (n, n) words: the port's
levels carry no padding, so JAX's padded layout has no counterpart. The
residual is then the plain multi-word one, as JAX's is under a policy.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from .compiled import CompiledCycle
from .grid import GridSpec
from .models.problems import Problem
from .ops import kernels as K
from .ops import stencils
from .ops.stencils import two_sum
from .schedule import CycleProgram, v_cycle
from .solver import SolverConfig, synchronize

STATES = ("df32", "tw32", "f64")


def _roll_sum(u: torch.Tensor) -> torch.Tensor:
    """Σ4 neighbors − 4u on the interior, (n − 2, n − 2)."""
    return stencils._nb_sum(u) - 4.0 * u[1:-1, 1:-1]


def _on_interior(r_int: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    r = torch.zeros_like(like)
    r[1:-1, 1:-1] = r_int
    return r


def residual_df_p(u_hi, u_lo, f, h: float):
    """Compensated residual of the double-float pair state, 0 off the
    interior: the u_hi stencil sum by error-free two-sums, u_lo's in plain
    fp32 (JAX's ``refine.residual_df_p``)."""
    uc = u_hi[1:-1, 1:-1]
    hi, lo = two_sum(u_hi[:-2, 1:-1], u_hi[2:, 1:-1])
    hi, e = two_sum(hi, u_hi[1:-1, :-2])
    lo = lo + e
    hi, e = two_sum(hi, u_hi[1:-1, 2:])
    lo = lo + e
    for _ in range(4):
        hi, e = two_sum(hi, -uc)
        lo = lo + e
    inv_h2 = 1.0 / (h * h)
    r = (hi * inv_h2 - f[1:-1, 1:-1]) + (lo + _roll_sum(u_lo)) * inv_h2
    return _on_interior(r, u_hi)


def df_add(u_hi, u_lo, e):
    """(u_hi, u_lo) + e with two-sum renormalization."""
    s, err = two_sum(u_hi, e)
    u_lo = u_lo + err
    return two_sum(s, u_lo)


def tw_add(u0, u1, u2, e):
    """(u0, u1, u2) + e, renormalized by two-sum chains (VecSum passes) so
    the words stay magnitude-ordered."""
    s0, c = two_sum(u0, e)
    s1, c = two_sum(u1, c)
    s2 = u2 + c
    r1, c = two_sum(s1, s2)
    r0, c2 = two_sum(s0, r1)
    r1, c3 = two_sum(c2, c)
    return r0, r1, c3


def residual_tw_p(u0, u1, u2, f, h: float):
    """Compensated residual of the triple-word state, 0 off the interior
    (JAX's ``refine.residual_tw_p``: the doubly compensated stencil chains,
    ``_eft_stencil_sum_dd``, are ``ops.kernels._dd_chain``; this is the
    multi-word kernel's twin)."""
    return K.residual_tw_torch(u0, u1, u2, f, h)


@dataclasses.dataclass
class RefineReport:
    u: torch.Tensor                 # (n, n) best fp32 representation
    u_lo: torch.Tensor              # (n, n) second word
    rel_residual: float             # compensated ‖r‖₂/‖f‖₂ at exit
    cycles: int
    wall_time_s: float
    spec: GridSpec
    error_vs_analytic: Optional[float] = None


def _zero_source(x, y):
    return torch.zeros_like(x)


class IterativeRefinementSolver:
    """Solve ∇²u = f to a relative-residual target by iterative refinement.

    ``state`` selects the outer-state precision; the inner multigrid cycles
    stay fp32 on the kernel path:
      * "df32" (default): double-float fp32 pair, floor 2⁻⁴⁸·‖A‖‖u‖ (about
        3e-9 relative at 4097², growing ~N²);
      * "tw32": triple-word fp32 with the doubly compensated residual,
        1e-10 relative at 8193²;
      * "f64": a float64 state and a float64 residual (plain PyTorch).

    ``inner_dtype`` (e.g. ``torch.bfloat16``) runs the correction cycles in
    another dtype. bfloat16 runs on the CUDA kernels (the bf16 modes of
    kernels 1-4) for a fixed-step Jacobi program without a policy, as the
    default V(3,3) is; the outer state, the multi-word residual and the add
    stay float32. Other dtypes, and bfloat16 elsewhere, need
    ``kernels="torch"`` (the engine's admission rule raises otherwise).
    ``policy``: a ``parallel.mesh`` sharding policy for the correction
    cycles (float32 only). Runs on ``device`` ("cuda" unless the caller asks
    for "cpu"; the mesh's first device under a policy).
    """

    def __init__(self, problem: Problem, n: int, program: Optional[CycleProgram] = None,
                 config: Optional[SolverConfig] = None, max_cycles: int = 60,
                 state: str = "df32", inner_dtype: Any = None, device="cuda", policy=None):
        if state not in STATES:
            raise ValueError(f"unknown state {state!r}; expected 'df32', 'tw32', or 'f64'")
        self.problem = problem
        # ω = 0.8: plain Jacobi leaves the checkerboard mode undamped and
        # stalls the outer iteration; dense coarse solve (exact in one matmul)
        self.config = config or SolverConfig(omega=0.8)
        # coarsen=3: 2:1-aligned levels, so the inner cycles run the fused legs
        self.program = program or v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=3)
        self.spec = GridSpec(self.program.n_max, self.program.length,
                             self.program.min_x, self.program.min_y)
        self.max_cycles = max_cycles
        self.state = state
        self.inner_dtype = inner_dtype
        self.policy = policy
        icfg = (self.config if inner_dtype is None
                else dataclasses.replace(self.config, dtype=inner_dtype))
        # the correction problem: zero source, zero Dirichlet boundary; its
        # right-hand side is −r, fed per cycle
        zero_problem = Problem(source=_zero_source, name="refine-correction")
        self._cycle = CompiledCycle(self.program, zero_problem, icfg, device, policy=policy)
        self.device = self._cycle.device
        # under a policy the multi-word residual is the plain one (JAX's too)
        kern = self._cycle.use_kernels and policy is None
        self._res_df = K.residual_df if kern else K.residual_df_torch
        self._res_tw = K.residual_tw if kern else K.residual_tw_torch

    # --- the state ------------------------------------------------------------

    def initial_state(self):
        """(u_hi0, u_lo0): the Dirichlet ring and a zero interior."""
        u_hi = self.problem.boundary_grid(self.spec, self.config.dtype, self.device)
        return u_hi, torch.zeros_like(u_hi)

    def init_rhs(self) -> torch.Tensor:
        dt, dev = self.config.dtype, self.device
        return (self.problem.source_grid(self.spec, dt, dev)
                + self.problem.boundary_grid(self.spec, dt, dev))

    def _correction(self, rhs: torch.Tensor) -> torch.Tensor:
        """One cycle of the engine on ∇²e = rhs with a zero boundary."""
        dt = self.config.dtype
        zero = torch.zeros_like(rhs, dtype=self._cycle.config.dtype)
        e, _ = self._cycle(zero, rhs.to(self._cycle.config.dtype))
        return self._cycle.unpad(e).to(dt)

    def _den(self, f: torch.Tensor, r0: torch.Tensor) -> torch.Tensor:
        """Convergence normalization: ‖f‖ over the interior for source-driven
        problems; the initial state's residual only where f ≈ 0 (harmonic
        problems). Never the running residual."""
        nf = torch.linalg.vector_norm(f[1:-1, 1:-1]).to(r0.dtype)
        return torch.where(nf > 1e-20, nf, torch.clamp(r0, min=1e-30))

    def _words(self, words, f, tol: float, budget: int):
        """Refine the df32 or tw32 state ``words`` for at most ``budget``
        cycles. Returns (words, rel, cycles run)."""
        tw = len(words) == 3

        def res(ws):
            return self._res_tw(*ws, f, self.spec.h) if tw else self._res_df(*ws, f, self.spec.h)

        i0, i1 = self.initial_state()
        r0 = torch.linalg.vector_norm(res((i0, i1, torch.zeros_like(i0)) if tw else (i0, i1)))
        den = self._den(f, r0)
        r = res(words)
        rel = torch.linalg.vector_norm(r) / den
        # the stop test in the state's dtype, as JAX's weakly typed compare
        tol_t = float(np.float32(tol))
        k = 0
        while k < budget and float(rel) > tol_t:
            e = self._correction(-r)
            words = tw_add(*words, e) if tw else df_add(*words, e)
            r = res(words)
            rel = torch.linalg.vector_norm(r) / den
            k += 1
        return words, rel, k

    def _f64(self, u, f, tol: float, budget: int):
        """Refine the float64 state u for at most ``budget`` cycles. Returns
        (u, rel, cycles run)."""
        h = self.spec.h
        f64 = f.to(torch.float64)
        i0 = self.initial_state()[0].to(torch.float64)
        den = self._den(f, torch.linalg.vector_norm(stencils.residual(i0, f64, h)))
        r = stencils.residual(u, f64, h)
        rel = torch.linalg.vector_norm(r) / den
        k = 0
        while k < budget and float(rel) > tol:
            u = u + self._correction(-r).to(torch.float64)
            r = stencils.residual(u, f64, h)
            rel = torch.linalg.vector_norm(r) / den
            k += 1
        return u, rel, k

    def _fresh(self):
        """The starting state in the solver's representation."""
        u_hi, u_lo = self.initial_state()
        if self.state == "f64":
            return (u_hi.to(torch.float64),)
        if self.state == "tw32":
            return u_hi, u_lo, torch.zeros_like(u_hi)
        return u_hi, u_lo

    def _run(self, state, f, tol: float, budget: int):
        if self.state == "f64":
            u, rel, k = self._f64(state[0], f, tol, budget)
            return (u,), rel, k
        return self._words(state, f, tol, budget)

    def _hi_lo(self, state):
        """(u_hi, u_lo) in the solver's dtype from any state."""
        if self.state != "f64":
            return state[0], state[1]
        u64 = state[0]
        u_hi = u64.to(self.config.dtype)
        return u_hi, (u64 - u_hi.to(torch.float64)).to(self.config.dtype)

    # --- solving --------------------------------------------------------------

    def solve(self, tol: float = 1e-8, checkpoints=None,
              checkpoint_chunk: int = 10) -> RefineReport:
        """Refine to ``tol``. With a ``CheckpointManager`` in
        ``checkpoints``, run in chunks of ``checkpoint_chunk`` cycles,
        persisting (and resuming) the whole state between chunks."""
        cfg = self.config
        f = self.init_rhs()
        synchronize(self.device)
        start = time.perf_counter()
        if checkpoints is None:
            state, rel, k = self._run(self._fresh(), f, tol, self.max_cycles)
        else:
            state, rel, k = self._solve_checkpointed(f, tol, checkpoints, checkpoint_chunk)
        u_hi, u_lo = self._hi_lo(state)
        # corrections are interior-only: put the Dirichlet ring back
        b = self.problem.boundary_grid(self.spec, cfg.dtype, self.device)
        u_hi = u_hi.clone()
        u_hi[0, :], u_hi[-1, :], u_hi[:, 0], u_hi[:, -1] = b[0, :], b[-1, :], b[:, 0], b[:, -1]
        rel_f = float(rel)
        synchronize(self.device)
        wall = time.perf_counter() - start

        err = None
        if self.problem.analytic is not None:
            ua = self.problem.analytic_grid(self.spec, cfg.dtype, self.device)
            err = float(stencils.mean_abs_error(u_hi, ua))
        return RefineReport(u=u_hi, u_lo=u_lo, rel_residual=rel_f, cycles=int(k),
                            wall_time_s=wall, spec=self.spec, error_vs_analytic=err)

    def _fingerprint(self) -> str:
        from .utils.checkpoint import schedule_fingerprint

        return schedule_fingerprint(self.program) + {"tw32": "/tw32", "f64": "/f64"}.get(
            self.state, "")

    def _resume(self, saved):
        """The state held by a checkpoint (the port's (n, n) arrays, or the
        JAX package's padded ones, cropped), or None if it does not fit."""
        from .utils.checkpoint import crop_to

        n = self.spec.n
        if saved is None or not saved.meta or saved.meta.get("schedule") != self._fingerprint():
            return None
        u = crop_to(saved.u, n)
        if u is None:
            return None

        def word(a):
            w = None if a is None else crop_to(a, n)
            return torch.from_numpy(np.ascontiguousarray(w)).to(self.device) if w is not None \
                else torch.zeros((n, n), dtype=self.config.dtype, device=self.device)

        if self.state == "f64":
            return (torch.from_numpy(np.ascontiguousarray(u, np.float64)).to(self.device),)
        words = (word(saved.u), word(saved.u_lo))
        return words + ((word(saved.u_lo2),) if self.state == "tw32" else ())

    def _solve_checkpointed(self, f, tol: float, manager, chunk: int):
        """Host loop in chunks with persistence (utils.checkpoint): every
        chunk's whole state (two or three fp32 words, or the float64 array)
        is saved, so a resume loses no precision."""
        from .utils.checkpoint import SolverState

        fp = self._fingerprint()
        resumed = manager.latest()
        state = self._resume(resumed)
        done = resumed.cycle if state is not None else 0
        if state is None:
            state = self._fresh()
        rel = None
        while done < self.max_cycles:
            state, rel, k = self._run(state, f, tol, min(chunk, self.max_cycles - done))
            done += k
            words = dict(zip(("u", "u_lo", "u_lo2"), state))
            manager.maybe_save(SolverState(f=f, cycle=done, meta={"schedule": fp, "tol": tol},
                                           **words))
            if float(rel) <= tol:
                break
        if rel is None:
            # resumed at the cycle budget: report the restored state's residual
            state, rel, _ = self._run(state, f, tol, 0)
        return state, rel, done


def solve_to_tolerance(problem: Problem, n: int, tol: float = 1e-8,
                       program: Optional[CycleProgram] = None,
                       config: Optional[SolverConfig] = None, max_cycles: int = 60,
                       state: str = "df32", device="cuda", policy=None) -> RefineReport:
    """One call: iterative refinement until ‖r‖/‖f‖ ≤ tol (``policy``: the
    correction cycles' sharding policy)."""
    return IterativeRefinementSolver(problem, n, program, config, max_cycles, state=state,
                                     device=device, policy=policy).solve(tol)
