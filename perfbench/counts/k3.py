"""K3 (`kernels/ragged_decode.ragged_gqa_attend`): rows of new queries
attending each row's live cache.

One launch serves one layer of one dispatch. A row that runs ``q`` new
tokens from offset ``p0`` (a decode row: q = 1 at its length; a prefill
chunk: its real tokens, not the padded tail) attends ``p0 + i + 1`` keys
with its i-th token. FLOPs: 2 * H * keys * (Rq + Rv) per query. Bytes:
each kv head's live keys and values read once, the queries read and the
outputs written once."""

from typing import Iterable, Tuple

from perfbench import peaks


def launch_counts(rows: Iterable[Tuple[int, int]], H: int, Hk: int, Rq: int, Rv: int,
                  itemsize: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one launch over ``rows``: (p0, q) pairs."""
    flops = 0.0
    nbytes = 0.0
    for p0, q in rows:
        keys = q * p0 + q * (q + 1) // 2  # sum over i < q of p0 + i + 1
        flops += 2.0 * H * keys * (Rq + Rv)
        live = p0 + q
        nbytes += (Hk * live * (Rq + Rv) + H * q * (Rq + Rv)) * itemsize
    return flops, nbytes


def launch_bound_s(rows, H: int, Hk: int, Rq: int, Rv: int, itemsize: int) -> float:
    flops, nbytes = launch_counts(rows, H, Hk, Rq, Rv, itemsize)
    return max(flops / peaks.TF32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)
