"""Type-III V/O decomposition — correlation-whitened SVD.

Port of ``modegpt_tpu.ops.vo`` (reference: src/compression/compress_vo.py).
Given the covariance ``C_x`` of the attention-input activations:

* MHA (reference: compress_head :162-223): two-stage whitened SVD —
  ``U, S, Vh = svd(sqrt(C_x) @ W_v_head^T)`` then
  ``U', S', Vh' = svd(diag(S) @ Vh @ W_o_head^T)``;
  ``V_new = (C^-1/2 U U')[:, :r]``, ``O_new = diag(S')[:r] Vh'[:r, :]``.
* GQA (reference: compress_head_grouped :112-159): one SVD on the shared
  V head — ``V_new = C^-1/2 U[:, :r]``, and each O head of the group is
  projected through the shared basis:
  ``O_new = diag(S)[:r] Vh[:r, :] @ W_o_head^T``.

The JAX version vmaps over heads; here heads are a batch dimension of
the batched SVDs. The economy SVD is used throughout (the reference's
``full_matrices=True`` second SVD only consumes the first ``r`` rows).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from modegpt_tpu_torch.ops.psd import _cholesky_escalated, sqrt_and_inv_sqrt_psd

__all__ = ["VOFactors", "compress_vo_layer", "vo_full_factors", "vo_factors_from_full"]


class VOFactors(NamedTuple):
    """Compressed V/O factors in HF weight layout.

    v: [n_kv_heads * rank, d_model]
    o: [d_model, n_heads * rank]
    """

    v: torch.Tensor
    o: torch.Tensor


def _whiteners(
    cov_x: torch.Tensor, ridge_vo: float, whiten: str
) -> Tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]:
    """Return (F, unwhiten) with F^T F = cov_x + ridge*I and
    unwhiten(M) = F^{-1} M.

    whiten="eigh": F is the symmetric PSD sqrt (bit-matches the
    reference, compress_vo.py:43-45). whiten="cholesky": F = L^T. Any F
    with F^T F = C gives the same whitened column space, hence the same
    product O_new @ V_new; only the individual factors differ by a basis
    change. The escalated Cholesky survives a singular f32 ``cov_x``.
    """
    if whiten == "eigh":
        sqrt_C, inv_sqrt_C = sqrt_and_inv_sqrt_psd(cov_x, ridge_vo)
        return sqrt_C, lambda M: inv_sqrt_C @ M
    if whiten != "cholesky":
        raise ValueError(f"whiten must be eigh or cholesky, got {whiten!r}")
    L = _cholesky_escalated(cov_x, ridge_vo)
    U = L.transpose(-1, -2)
    return U, lambda M: torch.linalg.solve_triangular(U, M, upper=True)


def vo_full_factors(
    cov_x: torch.Tensor,
    W_v: torch.Tensor,
    W_o: torch.Tensor,
    n_heads: int,
    n_kv_heads: int,
    ridge_vo: float,
    whiten: str = "eigh",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank-independent full factor forms.

    Returns (v_full, o_full):
      v_full: [Hk, d, hd] unwhitened left basis; rank r is ``[:, :, :r]``.
      o_full: [H, hd, d] scaled right factors; rank r is ``[:, :r, :]``.
    """
    d_model = cov_x.shape[0]
    hd = W_v.shape[0] // n_kv_heads
    group = n_heads // n_kv_heads
    sqrt_C, unwhiten = _whiteners(cov_x, ridge_vo, whiten)

    V_heads = W_v.reshape(n_kv_heads, hd, d_model)  # [Hk, hd, d]
    O_heads = W_o.reshape(d_model, n_heads, hd).permute(1, 0, 2)  # [H, d, hd]

    # Stage 1: batched economy SVD of sqrt(C) @ V_head^T [d, hd].
    U, S, Vh = torch.linalg.svd(sqrt_C @ V_heads.transpose(1, 2), full_matrices=False)
    if group == 1:
        # MHA: second SVD through the O head.
        A = (S[:, :, None] * Vh) @ O_heads.transpose(1, 2)  # [H, hd, d]
        Up, Sp, Vph = torch.linalg.svd(A, full_matrices=False)
        v_full = unwhiten(U @ Up)  # [H, d, hd]
        o_full = Sp[:, :, None] * Vph  # [H, hd, d]
    else:
        # GQA: shared V basis per kv head, O heads projected through it.
        v_full = unwhiten(U)  # [Hk, d, hd]
        SVh = S[:, :, None] * Vh  # [Hk, hd, hd]
        O_grp = O_heads.reshape(n_kv_heads, group, d_model, hd)
        o_full = torch.einsum("hre,hgde->hgrd", SVh, O_grp).reshape(n_heads, hd, d_model)
    return v_full, o_full


def vo_factors_from_full(v_full, o_full, rank: int, n_heads: int, n_kv_heads: int) -> VOFactors:
    """Slice full factor forms to rank and lay out as HF weights."""
    d_model = v_full.shape[1]
    v_w = v_full[:, :, :rank].permute(0, 2, 1).reshape(n_kv_heads * rank, d_model)
    o_w = o_full[:, :rank, :].permute(2, 0, 1).reshape(d_model, n_heads * rank)
    return VOFactors(v=v_w, o=o_w)


def compress_vo_layer(
    cov_x: torch.Tensor,
    W_v: torch.Tensor,
    W_o: torch.Tensor,
    rank: int,
    n_heads: int,
    n_kv_heads: int,
    ridge_vo: float,
    whiten: str = "eigh",
) -> VOFactors:
    """Type-III solve for one layer.

    Args:
      cov_x: [d_model, d_model] attention-input covariance.
      W_v:   [n_kv_heads*hd, d_model] value weight (HF layout).
      W_o:   [d_model, n_heads*hd] output weight (HF layout).
      rank:  kept dims per head (the caller applies the even-rank rule
             for RoPE archs, reference: compress_vo.py:39-41).
    """
    v_full, o_full = vo_full_factors(cov_x, W_v, W_o, n_heads, n_kv_heads, ridge_vo, whiten)
    return vo_factors_from_full(v_full, o_full, rank, n_heads, n_kv_heads)
