"""Level operations: oracle ops, transfers, coarse solvers and the CUDA kernels.

Exports the names of JAX's ``ops/__init__.py:3-16`` that the port has
(``exact_solve`` and ``mean_abs_interior_residual`` it has not).
"""

from .stencils import (  # noqa: F401
    interior_color_masks,
    jacobi_sweep,
    mean_abs_error,
    redblack_gs_sweep,
    residual,
    smooth,
    smoothing_error,
)
from .transfers import add_correction, relative_residual_norm  # noqa: F401
from .zoom import prolongate, restrict_residual, zoom  # noqa: F401
from .coarse import dense_solve, gauss_seidel_solve  # noqa: F401
