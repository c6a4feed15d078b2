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

`compress_qk_layer_svd` is the alternative Type-II solve for non-RoPE
archs (``qk_method="svd"``): a whitened two-stage SVD of each head's QK
bilinear form, all heads in one batched `torch.linalg.svd`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from modegpt_tpu_torch.ops.psd import sqrt_and_inv_sqrt_psd

__all__ = [
    "QKFactors",
    "qk_rope_pair_scores",
    "qk_opt_scores",
    "qk_rope_mask",
    "qk_opt_mask",
    "gather_heads",
    "compress_qk_layer_rope",
    "compress_qk_layer_opt",
    "compress_qk_layer_svd",
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


def qk_rope_mask(cov_q: torch.Tensor, cov_k: torch.Tensor, rank: int, ridge_qk: float) -> torch.Tensor:
    """The rotary mask [n_kv_heads, rank]: the top ``rank/2`` frequency
    pairs of each kv head in descending-score order, then the same
    indices + hd/2."""
    hd = cov_q.shape[-1]
    assert rank % 2 == 0 and 2 <= rank <= hd
    topk = _topk_desc(qk_rope_pair_scores(cov_q, cov_k, ridge_qk, cov_k.shape[0]), rank // 2)
    return torch.cat([topk, topk + hd // 2], dim=-1)


def qk_opt_mask(cov_q: torch.Tensor, cov_k: torch.Tensor, rank: int, ridge_qk: float) -> torch.Tensor:
    """OPT's kept rows per head [n_heads, rank], descending score."""
    return _topk_desc(qk_opt_scores(cov_q, cov_k, ridge_qk), rank)


def gather_heads(W: torch.Tensor, n_h: int, masks: torch.Tensor) -> torch.Tensor:
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
    n_heads, n_kv_heads = cov_q.shape[0], cov_k.shape[0]
    mask = qk_rope_mask(cov_q, cov_k, rank, ridge_qk)  # [Hk, rank]
    q_mask = torch.repeat_interleave(mask, n_heads // n_kv_heads, dim=0)
    return QKFactors(
        q=gather_heads(W_q, n_heads, q_mask),
        k=gather_heads(W_k, n_kv_heads, mask),
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
    topk = qk_opt_mask(cov_q, cov_k, rank, ridge_qk)  # [H, rank]
    return QKFactors(
        q=gather_heads(W_q, n_heads, topk),
        k=gather_heads(W_k, n_heads, topk),
        rotary_mask=None,
        q_bias=gather_heads(bias_q[:, None], n_heads, topk)[:, 0],
        k_bias=gather_heads(bias_k[:, None], n_heads, topk)[:, 0],
    )


def _qk_svd_solve(
    cov_x: torch.Tensor,
    W_q: torch.Tensor,
    W_k: torch.Tensor,
    bias_q: Optional[torch.Tensor],
    bias_k: Optional[torch.Tensor],
    rank: int,
    n_heads: int,
    ridge: float,
):
    """Whitened two-stage SVD of the QK bilinear form, batched over heads.

    Per head: U,S,Vh = svd(sqrt(C_x) @ Wq_h^T); U',S',Vh' = svd(S Vh Wk_h);
    Q_new = (C^-1/2 U U')[:, :r], K_new = diag(S')[:r] Vh'[:r, :], with a
    scale balance alpha = sqrt(max|K| / max|Q|) (reference:
    compress_qk_svd, compress_qk.py:62-91). At full rank
    Q_new^T K_new == Wq_h^T Wk_h exactly (the whitening cancels).
    Biases keep the score's cross-terms in least squares:
    b_q'^T K == b_q^T Wk_h and Q^T b_k' == Wq_h^T b_k, solved with pinv.
    The factors are unique up to a sign per singular pair; Q^T K, the
    bias cross-terms and alpha are not affected by those signs.

    The whitening's eigh runs in float64 whatever the input's dtype. A
    layer-normed input (pre-LN OPT) leaves its Gram one direction of
    little energy: its eigenvalue lies below a float32 eigh's rounding, can
    come out negative, clamp to zero past the ridge, and the inverse square
    root then scales that direction by 1e12. The JAX function runs the
    eigh in the input's dtype; with float64 inputs the two agree.
    """
    d_model = cov_x.shape[0]
    hd = W_q.shape[0] // n_heads
    sqrt_C, inv_sqrt_C = (m.to(cov_x.dtype) for m in sqrt_and_inv_sqrt_psd(cov_x.double(), ridge))
    Wq_h = W_q.reshape(n_heads, hd, d_model)
    Wk_h = W_k.reshape(n_heads, hd, d_model)

    U, S, Vh = torch.linalg.svd(sqrt_C @ Wq_h.transpose(1, 2), full_matrices=False)  # [H, d, hd]
    Up, Sp, Vph = torch.linalg.svd((S[..., None] * Vh) @ Wk_h, full_matrices=False)  # [H, hd, d]
    Q = (inv_sqrt_C @ (U @ Up))[..., :rank]  # [H, d, r]
    K = Sp[:, :rank, None] * Vph[:, :rank, :]  # [H, r, d]
    q_max = torch.clamp(torch.amax(torch.abs(Q), dim=(1, 2)), min=1e-30)
    alpha = torch.sqrt(torch.amax(torch.abs(K), dim=(1, 2)) / q_max)[:, None, None]
    Q = (Q * alpha).transpose(1, 2)  # [H, r, d] q weight
    K = K / alpha  # [H, r, d] k weight
    bq_new = bk_new = None
    if bias_q is not None:
        bq_h = bias_q.reshape(n_heads, hd, 1)
        bk_h = bias_k.reshape(n_heads, hd, 1)
        bq_new = (torch.linalg.pinv(K.transpose(1, 2)) @ (Wk_h.transpose(1, 2) @ bq_h)).reshape(-1)
        bk_new = (torch.linalg.pinv(Q.transpose(1, 2)) @ (Wq_h.transpose(1, 2) @ bk_h)).reshape(-1)
    return Q.reshape(n_heads * rank, d_model), K.reshape(n_heads * rank, d_model), bq_new, bk_new


def compress_qk_layer_svd(
    cov_x: torch.Tensor,
    W_q: torch.Tensor,
    W_k: torch.Tensor,
    bias_q: Optional[torch.Tensor],
    bias_k: Optional[torch.Tensor],
    rank: int,
    ridge_qk: float,
    n_heads: int,
) -> QKFactors:
    """Alternative Type-II solve: whitened SVD of the QK bilinear form.

    The reference ships it as an unused alternative "better for OPT
    models" (compress_qk.py:16-148); here it is ``qk_method="svd"`` for
    non-RoPE archs. cov_x [d, d] is the layer input's Gram; W_q, W_k
    [n_heads*hd, d] in HF layout; the result is on their device and dtype.
    """
    q, k, bq, bk = _qk_svd_solve(cov_x, W_q, W_k, bias_q, bias_k, rank, n_heads, ridge_qk)
    return QKFactors(q=q, k=k, rotary_mask=None, q_bias=bq, k_bias=bk)
