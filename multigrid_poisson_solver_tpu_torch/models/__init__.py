"""Problem families (port of ``multigrid_poisson_solver_tpu/models/__init__.py``, 2-D only)."""

from .problems import (  # noqa: F401
    BUILTIN_PROBLEMS,
    Problem,
    REFERENCE_PROBLEM,
    gaussian_charge_problem,
    polynomial_problem,
    sine_problem,
)
