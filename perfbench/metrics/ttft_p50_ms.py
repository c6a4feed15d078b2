"""ttft_p50_ms: the 50th percentile, over every request due in the
window's untraced part, of the time from when it fell due to its first
token, in ms (host clock). Per-slot prefill gives a step one chunk, to
the lowest prefilling slot: the time a prompt waits and is prefilled.
Prefill chunks ride the steps every decoding slot waits on, so this
moves ``itl_p95_ms``."""

import numpy as np


def read(record):
    ms = record.get("ttft_ms")
    return float(np.percentile(ms, 50)) if ms else None
