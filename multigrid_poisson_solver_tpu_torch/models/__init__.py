"""Problem families (port of ``multigrid_poisson_solver_tpu/models/__init__.py``)."""

from .problems import (  # noqa: F401
    BUILTIN_PROBLEMS,
    Problem,
    REFERENCE_PROBLEM,
    gaussian_charge_problem,
    polynomial_problem,
    sine_problem,
)
from .poisson3d import (  # noqa: F401
    BUILTIN_PROBLEMS_3D,
    Problem3D,
    REFERENCE_PROBLEM_3D,
    solve3,
    v_cycle3,
)
