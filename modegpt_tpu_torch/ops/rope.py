"""Rotary position embeddings with frequency masking, and masked RMSNorm.

Port of ``modegpt_tpu.ops.rope``:

* Masked RoPE (reference: src/patchers/LlamaRebuild.py:119-187): after QK
  compression each kv head keeps a subset of rotary frequency pairs; the
  kept cos/sin columns are gathered per head through the layer's rotary
  mask. The mask ordering ``concat(topk, topk + hd/2)`` makes
  rotate_half pair position ``i`` with ``i + r/2``, as in the original
  frequency pairs.
* Masked per-head q/k RMSNorm (reference:
  src/patchers/DenseQwenRebuild.py:262-286): Qwen3 normalises q/k per
  head with a weight at the original head_dim; the compressed model
  gathers the matching weight coordinates through the rotary mask.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["rope_cos_sin", "apply_rope", "masked_head_rms_norm"]


def rope_cos_sin(
    positions: torch.Tensor,
    head_dim: int,
    theta: float = 10000.0,
    dtype: torch.dtype = torch.float32,
    scaling: Optional[tuple] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [T, head_dim] at the ORIGINAL head dim, computed in
    float32 (as HF does, LlamaRebuild.py:103) with the HF duplicated
    layout emb = concat(freqs, freqs).

    scaling: optional ModelSpec.rope_scaling:
      ("linear", factor) — position interpolation (inv_freq / factor);
      ("llama3", factor, low_freq_factor, high_freq_factor,
       original_max_position_embeddings) — Llama-3.1 per-wavelength
       scaling (HF modeling_rope_utils._compute_llama3_parameters).
    """
    dev = positions.device
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=dev) * 2.0 / head_dim
    inv_freq = 1.0 / (theta**exponent)
    if scaling is not None:
        kind = scaling[0]
        if kind == "linear":
            inv_freq = inv_freq / scaling[1]
        elif kind == "llama3":
            _, factor, low_f, high_f, old_len = scaling
            wavelen = 2.0 * math.pi / inv_freq
            scaled = torch.where(wavelen > old_len / low_f, inv_freq / factor, inv_freq)
            smooth = (old_len / wavelen - low_f) / (high_f - low_f)
            smoothed = (1.0 - smooth) * scaled / factor + smooth * scaled
            medium = (wavelen <= old_len / low_f) & (wavelen >= old_len / high_f)
            inv_freq = torch.where(medium, smoothed, scaled)
        else:
            raise ValueError(f"unsupported rope scaling {kind!r}")
    freqs = positions.to(torch.float32)[:, None] * inv_freq[None, :]  # [T, half]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    q: torch.Tensor,
    k: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    rotary_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply (optionally masked) RoPE.

    Args:
      q: [B, H, T, r]      (r = compressed head dim, == head_dim if dense)
      k: [B, Hk, T, r]
      cos/sin: [T, head_dim] full-dim tables from `rope_cos_sin`.
      rotary_mask: [Hk, r] int indices into head_dim, or None for dense.
    """
    if rotary_mask is None:
        return q * cos + _rotate_half(q) * sin, k * cos + _rotate_half(k) * sin
    group = q.shape[1] // k.shape[1]
    idx = rotary_mask.long()
    cos_k = cos[:, idx].permute(1, 0, 2)  # [T, Hk, r] -> [Hk, T, r]
    sin_k = sin[:, idx].permute(1, 0, 2)
    cos_q = torch.repeat_interleave(cos_k, group, dim=0)  # [H, T, r]
    sin_q = torch.repeat_interleave(sin_k, group, dim=0)
    return q * cos_q + _rotate_half(q) * sin_q, k * cos_k + _rotate_half(k) * sin_k


def masked_head_rms_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    rotary_mask: Optional[torch.Tensor],
    group: int,
    eps: float,
) -> torch.Tensor:
    """Per-head RMSNorm with the weight gathered through the rotary mask.

    Args:
      x: [B, T, H, r] per-head states (H = n_heads for q with
         ``group = n_heads // n_kv_heads``, or n_kv_heads for k with
         ``group = 1``).
      weight: [head_dim] learned weight at the ORIGINAL head dim.
      rotary_mask: [Hk, r] kept indices, or None (dense: plain RMSNorm).
    """
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    w = weight.to(torch.float32)
    if rotary_mask is not None:
        mask = rotary_mask.long()
        if group > 1:
            mask = torch.repeat_interleave(mask, group, dim=0)
        w = w[mask]  # [H, r]
    return (normed * w).to(x.dtype)
