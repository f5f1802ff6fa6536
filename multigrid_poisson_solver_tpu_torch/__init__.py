"""multigrid_poisson_solver_tpu_torch: the PyTorch and CUDA port of
``multigrid_poisson_solver_tpu``.

Geometric multigrid for the 2-D (and 3-D) Poisson problem with a Dirichlet boundary,
driven by the reference's ``Cycle.txt`` schedules, on one NVIDIA GPU. The hot
path (the fused smoother in its Jacobi, per-sweep-error and rb-GS modes, the
residuals, the fused descend and ascend legs, the chains and the trigger
loops) runs hand-written CUDA kernels for Hopper (``ops/csrc``, built at
first use by ``ops.build``); everything else is plain PyTorch. The JAX
package is the reference this port is tested against.

Ported so far: the 2-D single-device engines (``compile_program``,
``MultigridSolver``), iterative refinement to a tolerance
(``IterativeRefinementSolver``, ``solve_to_tolerance``) with its checkpoints,
the 3-D single-device path (``v_cycle3``, ``compile_program3`` with its
trigger tiers, ``Solver3D``, 3-D refinement ``IterativeRefinement3`` and
``solve_to_tolerance3``; eight kernels in ``ops.kernels3``), the CLI with
``--dim 3`` and ``--dim 3 --tol``, and the 2-D multi-device path:
``compile_program(..., policy=...)`` with the row and block policies of
``parallel.mesh`` on a mesh of shards (repeats allowed: eight shards on one
card are a real ring), the shard modes of the kernels and the two ring
kernels of ``ops.rdma``; and the 3-D multi-device path on a z-plane mesh
(``ZShardingPolicy3``, ``make_mesh_z``): ``v_cycle3_sharded`` and
``compile_program3(..., policy=...)`` with the shard modes of the 3-D
kernels and, with ``halo="rdma"``, the four 3-D ring kernels of
``ops.rdma3``. Every TPU kernel of the JAX package has a counterpart; not
ported: multi-process runs.
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
from .models.poisson3d import (  # noqa: F401
    BUILTIN_PROBLEMS_3D,
    Problem3D,
    REFERENCE_PROBLEM_3D,
    solve3,
    v_cycle3,
)
from .solver3 import Solver3D, solve3_program  # noqa: F401
from .compiled3 import CompiledCycle3, compile_program3  # noqa: F401
from .refine3 import IterativeRefinement3, Refine3Report, solve_to_tolerance3  # noqa: F401
from .parallel.mesh import ZShardingPolicy3, make_mesh_z  # noqa: F401
from .parallel.kernel_shard3 import v_cycle3_sharded  # noqa: F401
from . import models  # noqa: F401
