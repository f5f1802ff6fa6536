"""Level operations: oracle ops, transfers, coarse solvers and the CUDA kernels."""
