"""Type-II Q/K decomposition — CR column selection, RoPE-pair-aware.

Port of ``modegpt_tpu.ops.qk`` (reference: src/compression/compress_qk.py):

* RoPE archs (Llama/Qwen, MHA and GQA): score each rotary frequency pair
  ``j`` by the whitened column energies of the per-head Q/K Grams,
  summed over the query heads of the kv group, keep the top ``rank/2``
  pairs and slice the matching Q/K rows. The kept index mask is the
  per-head rotary mask the compressed model gathers cos/sin with
  (reference: compress_head_llama_grouped :320-384).
* OPT (no RoPE, attention biases): score = columnwise
  ``||sqrt(C_q)|| * ||sqrt(C_k)||``; keep the top ``rank`` rows of Q, K
  and their biases (reference: compress_head_opt :439-476).

The column energy of the symmetric PSD square root is the ridged
diagonal, ``||sqrt(C)[:, j]||^2 = C_jj + ridge``, so scoring reads
diagonals and needs no eigendecomposition.

The rotary mask is ``concat(topk, topk + hd/2)`` with topk in
descending-score order (not sorted), as the reference builds it
(compress_qk.py:366-367). Ties go to the lower index, as with
``jax.lax.top_k``.

The whitened-SVD method (``qk_method="svd"``) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = [
    "QKFactors",
    "qk_rope_pair_scores",
    "qk_opt_scores",
    "compress_qk_layer_rope",
    "compress_qk_layer_opt",
]

# The reference regularises sqrt(C_q) with sqrt_M's default ridge (1e-4)
# and applies config.ridge_qk only to sqrt(C_k) in the GQA path
# (compress_qk.py:348-353); the MHA path uses defaults for both
# (compress_qk.py:406-407). Both quirks are kept.
DEFAULT_SQRT_RIDGE = 1e-4


class QKFactors(NamedTuple):
    """Compressed Q/K factors in HF weight layout.

    q: [n_heads * rank, d_model]
    k: [n_kv_heads * rank, d_model]
    rotary_mask: [n_kv_heads, rank] int32 or None (OPT)
    q_bias / k_bias: per-head-sliced biases or None (OPT only)
    """

    q: torch.Tensor
    k: torch.Tensor
    rotary_mask: Optional[torch.Tensor]
    q_bias: Optional[torch.Tensor] = None
    k_bias: Optional[torch.Tensor] = None


def _col_energy(cov: torch.Tensor, ridge: float) -> torch.Tensor:
    """Per-head column squared-norms of the PSD sqrt: [H, hd]."""
    return torch.diagonal(cov, dim1=-2, dim2=-1) + ridge


def _topk_desc(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k indices along the last axis in descending-score order,
    lower index first on ties."""
    return torch.argsort(-scores, dim=-1, stable=True)[..., :k]


def qk_rope_pair_scores(
    cov_q: torch.Tensor, cov_k: torch.Tensor, ridge_qk: float, n_kv_heads: int
) -> torch.Tensor:
    """RoPE frequency-pair scores per kv head: [n_kv_heads, head_dim/2].

    score[kv, j] = sqrt( sum_{q in group}  e_q[j]    * e_k[j]
                                         + e_q[j+h/2] * e_k[j+h/2] )
    """
    n_heads, hd = cov_q.shape[0], cov_q.shape[-1]
    group = n_heads // n_kv_heads
    half = hd // 2
    eq = _col_energy(cov_q, DEFAULT_SQRT_RIDGE).reshape(n_kv_heads, group, hd)
    ek = _col_energy(cov_k, ridge_qk)[:, None, :]  # [Hk, 1, hd]
    pair = eq[..., :half] * ek[..., :half] + eq[..., half:] * ek[..., half:]
    return torch.sqrt(pair.sum(dim=1))


def qk_opt_scores(cov_q: torch.Tensor, cov_k: torch.Tensor, ridge_qk: float) -> torch.Tensor:
    """OPT per-head row scores [n_heads, head_dim]; both square roots at
    the default ridge, as the reference does (compress_qk.py:455-461)."""
    del ridge_qk
    return torch.sqrt(_col_energy(cov_q, DEFAULT_SQRT_RIDGE)) * torch.sqrt(
        _col_energy(cov_k, DEFAULT_SQRT_RIDGE)
    )


def _gather_heads(W: torch.Tensor, n_h: int, masks: torch.Tensor) -> torch.Tensor:
    """Rows ``masks[h]`` of each head block of W [n_h*hd, d] -> [n_h*r, d]."""
    hd = W.shape[0] // n_h
    rows = (torch.arange(n_h, device=W.device)[:, None] * hd + masks.to(W.device)).reshape(-1)
    return W[rows]


def compress_qk_layer_rope(
    cov_q: torch.Tensor,
    cov_k: torch.Tensor,
    W_q: torch.Tensor,
    W_k: torch.Tensor,
    rank: int,
    ridge_qk: float,
) -> QKFactors:
    """Type-II solve for one RoPE layer (Llama MHA/GQA, Qwen3).

    Args:
      cov_q: [n_heads, hd, hd] per-head Q Grams.
      cov_k: [n_kv_heads, hd, hd] per-head K Grams.
      W_q:   [n_heads*hd, d_model], W_k: [n_kv_heads*hd, d_model]. The
             rows are gathered on the weights' device.
      rank:  even kept dim per head (reference: compress_qk.py:180-182).
    """
    n_heads, hd = cov_q.shape[0], cov_q.shape[-1]
    n_kv_heads = cov_k.shape[0]
    assert rank % 2 == 0 and 2 <= rank <= hd
    scores = qk_rope_pair_scores(cov_q, cov_k, ridge_qk, n_kv_heads)
    topk = _topk_desc(scores, rank // 2)
    mask = torch.cat([topk, topk + hd // 2], dim=-1)  # [Hk, rank]
    q_mask = torch.repeat_interleave(mask, n_heads // n_kv_heads, dim=0)
    return QKFactors(
        q=_gather_heads(W_q, n_heads, q_mask),
        k=_gather_heads(W_k, n_kv_heads, mask),
        rotary_mask=mask.to(torch.int32),
    )


def compress_qk_layer_opt(
    cov_q: torch.Tensor,
    cov_k: torch.Tensor,
    W_q: torch.Tensor,
    W_k: torch.Tensor,
    bias_q: torch.Tensor,
    bias_k: torch.Tensor,
    rank: int,
    ridge_qk: float,
) -> QKFactors:
    """Type-II solve for one OPT layer (no RoPE; biases sliced too)."""
    n_heads = cov_q.shape[0]
    topk = _topk_desc(qk_opt_scores(cov_q, cov_k, ridge_qk), rank)  # [H, rank]
    return QKFactors(
        q=_gather_heads(W_q, n_heads, topk),
        k=_gather_heads(W_k, n_heads, topk),
        rotary_mask=None,
        q_bias=_gather_heads(bias_q[:, None], n_heads, topk)[:, 0],
        k_bias=_gather_heads(bias_k[:, None], n_heads, topk)[:, 0],
    )
