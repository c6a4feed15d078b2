"""The plain Qwen3 decoder in float32, dense or MoDeGPT-compressed.

Written from the published description (HF ``Qwen3ForCausalLM``): RMSNorm
before attention and MLP, per-head RMSNorm on q and k before RoPE
(``rope_theta``, the HF duplicated cos/sin layout), grouped-query causal
attention, a SiLU-gated MLP, a final RMSNorm and an untied LM head. A
compressed layer keeps ``rq`` of each head's q/k coordinates (the kept
RoPE frequency pairs, ``rotary_mask`` [Hk, rq] per kv head, through which
the q/k norm weights and the cos/sin tables are gathered), ``rv`` of each
head's v/o coordinates and ``rm`` MLP columns; its attention scale is
``rq ** -0.5``. Widths are read off the kernels.

No kernel, cache or batching of the port: attention is a masked softmax
over blocks of heads. Parameters are a tree in the port's layout
(kernels ``[in, out]``). TF32 must be off (`plain_fp32`) for float32.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 off (float32 products, the configuration's precision) or on
    (the control's lower precision) for the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * w


def rope_tables(T: int, head_dim: int, theta: float, device):
    """cos, sin [T, head_dim] at positions 0..T-1."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim // 2, dtype=torch.float32, device=device) * 2.0 / head_dim))
    freqs = torch.arange(T, dtype=torch.float32, device=device)[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                     heads_per_block: int = 8) -> torch.Tensor:
    """q [B, H, T, r], k [B, Hk, T, r], v [B, Hk, T, rv] -> [B, H, T, rv]."""
    B, H, T, _ = q.shape
    group = H // k.shape[1]
    out = q.new_empty((B, H, T, v.shape[-1]))
    masked = torch.ones((T, T), dtype=torch.bool, device=q.device).triu_(1)
    for b in range(B):
        for h0 in range(0, H, heads_per_block):
            h1 = min(H, h0 + heads_per_block)
            kv = torch.arange(h0, h1, device=q.device) // group
            s = (q[b, h0:h1] @ k[b, kv].transpose(-1, -2)) * scale
            s.masked_fill_(masked, float("-inf"))
            out[b, h0:h1] = torch.softmax(s, dim=-1) @ v[b, kv]
            del s
    return out


def layer(cfg: dict, lp: Dict, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
          taps: Optional[Dict] = None) -> torch.Tensor:
    """One decoder layer over x [B, T, d]. ``taps``: a dict that gathers
    the compression statistics as sums over tokens: the Grams of the
    attention input (``cov_x``), of each head's raw q and k projections
    before their norm and RoPE (``cov_q`` [H, hd, hd], ``cov_k``), and of
    the gated MLP intermediate (``cov_mlp``)."""
    B, T, d = x.shape
    H, Hk, eps = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["rms_norm_eps"]
    group = H // Hk
    rq = lp["q"]["kernel"].shape[1] // H
    rv = lp["v"]["kernel"].shape[1] // Hk
    xa = rms_norm(x, lp["attn_norm"]["scale"], eps)
    q = (xa @ lp["q"]["kernel"]).view(B, T, H, rq)
    k = (xa @ lp["k"]["kernel"]).view(B, T, Hk, rq)
    v = (xa @ lp["v"]["kernel"]).view(B, T, Hk, rv)
    if taps is not None:
        x2 = xa.reshape(-1, d)
        _acc(taps, "cov_x", x2.T @ x2)
        _acc(taps, "cov_q", torch.einsum("bthi,bthj->hij", q, q))
        _acc(taps, "cov_k", torch.einsum("bthi,bthj->hij", k, k))
    mask = lp.get("rotary_mask")
    wq, wk = lp["q_norm"]["scale"], lp["k_norm"]["scale"]
    if mask is not None:
        m = mask.long()
        wq, wk = wq[m.repeat_interleave(group, dim=0)], wk[m]  # [H, rq], [Hk, rq]
        ck, sk = cos[:, m].permute(1, 0, 2), sin[:, m].permute(1, 0, 2)  # [Hk, T, rq]
        cq, sq = ck.repeat_interleave(group, dim=0), sk.repeat_interleave(group, dim=0)
    else:
        ck, sk = cos[None], sin[None]
        cq, sq = ck, sk
    q = rms_norm(q, wq, eps).transpose(1, 2)  # [B, H, T, rq]
    k = rms_norm(k, wk, eps).transpose(1, 2)
    q = q * cq + _rotate_half(q) * sq
    k = k * ck + _rotate_half(k) * sk
    attn = causal_attention(q, k, v.transpose(1, 2), rq ** -0.5)
    x = x + attn.transpose(1, 2).reshape(B, T, H * rv) @ lp["o"]["kernel"]
    xm = rms_norm(x, lp["mlp_norm"]["scale"], eps)
    h = F.silu(xm @ lp["gate"]["kernel"]) * (xm @ lp["up"]["kernel"])
    if taps is not None:
        h2 = h.reshape(-1, h.shape[-1])
        _acc(taps, "cov_mlp", h2.T @ h2)
    return x + h @ lp["down"]["kernel"]


def _acc(taps: Dict, key: str, g: torch.Tensor) -> None:
    if key in taps:
        taps[key].add_(g)
    else:
        taps[key] = g


def block_influence(x_in: torch.Tensor, x_out: torch.Tensor) -> float:
    """A layer's Block Influence over a batch: the sum over sequences of
    the mean over positions of 1 - cos(x_in, x_out)."""
    cos = (x_in * x_out).sum(-1) / torch.clamp(x_in.norm(dim=-1) * x_out.norm(dim=-1), min=1e-8)
    return float((1.0 - cos).mean(dim=1).sum())


def hidden(cfg: dict, params: Dict, ids: torch.Tensor) -> torch.Tensor:
    """The final-norm hidden states [B, T, d] of tokens ids [B, T]."""
    T = ids.shape[1]
    cos, sin = rope_tables(T, cfg["head_dim"], float(cfg["rope_theta"]), ids.device)
    x = params["embed_tokens"][ids.long()]
    for lp in params["layers"]:
        x = layer(cfg, lp, x, cos, sin)
    return rms_norm(x, params["final_norm"]["scale"], cfg["rms_norm_eps"])


def logits_at(cfg: dict, params: Dict, ids: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Logits [n, V] of one sequence ids [1, T] at ``positions`` [n]."""
    h = hidden(cfg, params, ids)[0, positions]
    return h @ params["lm_head"]["kernel"]
