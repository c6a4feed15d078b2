"""k3_roofline_pct: K3's share of its roofline over the traced stretch of
the serving window, in %: the sum of its launches' least times over its
device time.

A launch's least time (`counts.k3.launch_bound_s`) is the larger of its
FLOPs at the TF32 peak and its bytes at the HBM rate, from the rows it
served: each decode row at its live length, each prefill chunk's real
tokens at their offsets, as the harness tracked them. The launches come
from the wrapper's counter (``ragged_gqa_attend.launches``, one a layer
and dispatch); with a count other than the harness expects, nothing is
read. Device time: the kernels named `KERNEL_NAMES` (the split grids and
the combine). Moves ``itl_p95_ms``."""

KERNEL_NAMES = ("decode_split", "chunk_split", "combine_splits")


def read(record):
    tr = record.get("trace")
    n = record.get("k3_launches", 0)
    if not tr or not n or n != record.get("k3_expected_launches"):
        return None
    secs = sum((t - s) / 1e6 for name, s, t, _ in tr["kernels"] if any(k in name for k in KERNEL_NAMES))
    if secs <= 0:
        return None
    return 100.0 * record["k3_bound_s"] / secs
