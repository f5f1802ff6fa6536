"""multigrid_poisson_solver_tpu_torch: the PyTorch and CUDA port of
``multigrid_poisson_solver_tpu``.

Geometric multigrid for the 2-D Poisson problem with a Dirichlet boundary,
driven by the reference's ``Cycle.txt`` schedules, on one NVIDIA GPU. The hot
path (the fused smoother in its Jacobi, per-sweep-error and rb-GS modes, the
residuals, the fused descend and ascend legs, the chains and the trigger
loops) runs hand-written CUDA kernels for Hopper (``ops/csrc``, built at
first use by ``ops.build``); everything else is plain PyTorch. The JAX
package is the reference this port is tested against.

Ported so far: the 2-D single-device engines (``compile_program``,
``MultigridSolver``), iterative refinement to a tolerance
(``IterativeRefinementSolver``, ``solve_to_tolerance``) with its checkpoints,
and the CLI. The 3-D family and multi-device execution are not yet ported.
"""

__version__ = "0.1.0"

from .grid import GridSpec, level_sizes  # noqa: F401
from .models import BUILTIN_PROBLEMS, REFERENCE_PROBLEM, Problem  # noqa: F401
from .schedule import (  # noqa: F401
    Ascend,
    CoarseSolve,
    CycleProgram,
    Descend,
    fmg,
    parse_cycle_file,
    parse_cycle_path,
    repeat,
    to_cycle_file,
    v_cycle,
    w_cycle,
)
from .solver import MultigridSolver, SolveReport, SolverConfig, solve  # noqa: F401
from .compiled import CompiledCycle, compile_program  # noqa: F401
from .refine import IterativeRefinementSolver, RefineReport, solve_to_tolerance  # noqa: F401
from . import models  # noqa: F401
