"""cusolver_s_per_layer: device seconds of the kernels that the solvers'
host operations launched (`counts.solvers`), per compressed decoder
layer. Moves ``compress_s_per_layer``."""

from perfbench.counts.solvers import is_solver


def read(record):
    tr = record.get("trace")
    if not tr or not record.get("layers"):
        return None
    secs = sum((t - s) / 1e6 for name, s, t, ops in tr["kernels"] if is_solver(ops))
    return secs / record["layers"] if secs > 0 else None
