"""A Qwen3 model's FLOPs from its shapes, for the `mfu` metrics.

Counted once per token, whatever implements it: 2 FLOPs per weight of
every projection a token passes (dense or compressed widths), the
attention products (2 * H * keys * (q width + v width) per query), the
LM head where logits are wanted, and, for a compression job, the Gram
products the method's statistics need (X^T X at each tap: the attention
input, each head's q and k, the MLP intermediate)."""

from perfbench.counts import k1


def layer_params(d: int, H: int, Hk: int, rq: int, rv: int, rm: int) -> int:
    """Weights of one decoder layer's projections: q, k, v, o and the
    gated MLP (gate, up, down) at per-head ranks rq (q, k), rv (v, o)
    and MLP width rm."""
    return d * H * rq + d * Hk * rq + d * Hk * rv + H * rv * d + 3 * d * rm


def compress_job_flops(cfg: dict, n_seq: int, seq_len: int) -> float:
    """One dense forward over the calibration tokens (no LM head: the
    calibration wants no logits) plus the Gram taps of every layer."""
    d, H, Hk = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, di, L = cfg["head_dim"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    N = n_seq * seq_len
    forward = 2.0 * N * layer_params(d, H, Hk, hd, hd, di)
    attention = k1.flops(n_seq, H, seq_len, hd, hd)
    grams = 2.0 * N * (d * d + H * hd * hd + Hk * hd * hd + di * di)
    return L * (forward + attention + grams)


def decode_token_flops(cfg: dict, rq: int, rv: int, rm: int) -> float:
    """The decoder stack's projection FLOPs for one token at compressed
    ranks (attention and head counted apart)."""
    d, H, Hk, L = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["num_hidden_layers"]
    return 2.0 * L * layer_params(d, H, Hk, rq, rv, rm)


def head_flops(cfg: dict) -> float:
    """The LM head for one position's logits."""
    return 2.0 * cfg["hidden_size"] * cfg["vocab_size"]


def attention_flops(cfg: dict, keys: int, rq: int, rv: int) -> float:
    """Every layer's attention products for queries that attend ``keys``
    keys in all."""
    return 2.0 * cfg["num_hidden_layers"] * cfg["num_attention_heads"] * keys * (rq + rv)
