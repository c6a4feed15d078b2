"""A Qwen3-MoE model's work from its shapes: the compression job's FLOPs
(for ``mfu_pct.compress``) and one expert-layer call's least time (for
``experts_roofline_pct``).

Counted as the routed model needs it, whatever implements it: a token
passes the router (2 * d * E FLOPs) and its ``k`` chosen experts
(2 * 3 * d * D FLOPs each), never the experts it was not routed to; an
expert's Gram counts only the rows routed to it (2 * D * D FLOPs a
routed row). The attention half and its taps are counted as in
`model_flops`."""

from perfbench import peaks
from perfbench.counts import k1


def _sizes(cfg: dict):
    return (cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"],
            cfg["moe_intermediate_size"], cfg["num_experts"], cfg["num_experts_per_tok"])


def experts_flops(cfg: dict, tokens: int) -> float:
    """The router and the routed experts' three products over ``tokens``."""
    d, _, _, _, D, E, k = _sizes(cfg)
    return 2.0 * tokens * (d * E + k * 3 * d * D)


def experts_bytes(cfg: dict, tokens: int, itemsize: int) -> float:
    """Every expert's and the router's weights read once, and the routed
    activations: each (token, expert) pair's input row read and output
    row written once."""
    d, _, _, _, D, E, k = _sizes(cfg)
    weights = E * 3 * d * D + d * E
    routed = tokens * k * 2 * d
    return float(weights + routed) * itemsize


def experts_bound_s(cfg: dict, tokens: int, itemsize: int = 4) -> float:
    """The least time one expert-layer call over ``tokens`` can take on
    the card: the larger of its FLOPs at the TF32 peak and its bytes at
    the HBM rate."""
    return max(experts_flops(cfg, tokens) / peaks.TF32_FLOPS,
               experts_bytes(cfg, tokens, itemsize) / peaks.HBM_BYTES_PER_S)


def compress_job_flops(cfg: dict, n_seq: int, seq_len: int) -> float:
    """One forward over the calibration tokens with ``k`` of ``E`` experts
    a token (no LM head), plus every tap: the attention input's, each
    head's q and k, and each expert's Gram over its routed rows."""
    d, H, Hk, hd, D, E, k = _sizes(cfg)
    N = n_seq * seq_len
    projections = 2.0 * N * (d * H * hd + 2 * d * Hk * hd + H * hd * d)
    attention = k1.flops(n_seq, H, seq_len, hd, hd)
    grams = 2.0 * N * (d * d + H * hd * hd + Hk * hd * hd + k * D * D)
    return cfg["num_hidden_layers"] * (projections + attention + experts_flops(cfg, N) + grams)
