"""The host operations whose kernels are the solvers' (Cholesky,
triangular solves, eigh, SVD, LU solves: cuSOLVER and the cuBLAS kernels
it calls), by the names the profiler gives them."""

SOLVER_OPS = ("linalg_", "cholesky", "triangular_solve", "lu_", "_lu", "svd", "eigh", "geqrf", "ormqr",
              "pinv", "lstsq", "solve")


def is_solver(ops) -> bool:
    """Whether any of the host operations that launched a kernel is a
    solver's."""
    return any(any(s in op.lower() for s in SOLVER_OPS) for op in ops)
