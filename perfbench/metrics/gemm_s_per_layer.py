"""gemm_s_per_layer: device seconds in GEMM kernels outside the solvers,
per compressed decoder layer (the calibration sweep: projections and
Gram taps). A kernel counts when its name matches a GEMM name below and
no host operation that launched it is a solver's (`counts.solvers`,
shared with ``cusolver_s_per_layer``). Moves ``compress_s_per_layer``."""

from perfbench.counts.solvers import is_solver

GEMM_NAMES = ("gemm", "gemv", "xmma", "cutlass", "sm90_", "sm80_", "ampere_", "cublas")


def is_gemm(name, ops):
    n = name.lower()
    return any(g in n for g in GEMM_NAMES) and not is_solver(ops)


def read(record):
    tr = record.get("trace")
    if not tr or not record.get("layers"):
        return None
    secs = sum((t - s) / 1e6 for name, s, t, ops in tr["kernels"] if is_gemm(name, ops))
    return secs / record["layers"] if secs > 0 else None
