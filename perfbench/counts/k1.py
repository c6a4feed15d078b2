"""K1 (`kernels/flash_attention.flash_attention`): causal attention over
[B, H, T, hd] queries against [B, Hk, T, hd] keys and values.

FLOPs: 2 * B * H * (visible (query, key) pairs) * (hd + hd_v), the
pairs of a causal T x T square being T (T + 1) / 2. Bytes: q, k, v and
the output, each read or written once."""

from perfbench import peaks


def causal_pairs(T: int) -> int:
    return T * (T + 1) // 2


def flops(B: int, H: int, T: int, hd: int, hd_v: int) -> float:
    return 2.0 * B * H * causal_pairs(T) * (hd + hd_v)


def nbytes(B: int, H: int, Hk: int, T: int, hd: int, hd_v: int, itemsize: int) -> float:
    q = B * H * T * hd
    k = B * Hk * T * hd
    v = B * Hk * T * hd_v
    out = B * H * T * hd_v
    return float(q + k + v + out) * itemsize


def bound_s(B: int, H: int, Hk: int, T: int, hd: int, hd_v: int, itemsize: int) -> float:
    """The least time one launch can take on the card: the larger of its
    FLOPs at the TF32 peak and its bytes at the HBM rate."""
    return max(flops(B, H, T, hd, hd_v) / peaks.TF32_FLOPS,
               nbytes(B, H, Hk, T, hd, hd_v, itemsize) / peaks.HBM_BYTES_PER_S)
