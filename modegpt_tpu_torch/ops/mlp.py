"""Type-I MLP decomposition — Nyström / ridge-leverage column selection.

Port of ``modegpt_tpu.ops.mlp`` (reference:
src/compression/compress_mlp.py). Given the Gram matrix ``C`` of the MLP
intermediate activations, keep the ``rank`` columns with the smallest
ridge-leverage inverse-diagonal, slice the up/gate rows, and re-solve
the down projection in closed form:

    W_d' = (C_SS + eps*I)^-1 C_{S,:} W_d^T

Weights are in HF ``[out_features, in_features]`` layout.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from modegpt_tpu_torch.ops.psd import cholesky_solve_ridged, ridge_inverse_diag

__all__ = ["MLPFactors", "nystrom_scores", "nystrom_select", "nystrom_mlp"]

NYSTROM_SOLVE_RIDGE = 1e-6  # reference: src/compression/compress_mlp.py:56


class MLPFactors(NamedTuple):
    """Compressed MLP factors in HF weight layout.

    up:   [rank, d_model]
    gate: [rank, d_model] or None (OPT has no gate)
    down: [d_model, rank]
    idx:  [rank] sorted kept-column indices into the intermediate dim
    """

    up: torch.Tensor
    gate: Optional[torch.Tensor]
    down: torch.Tensor
    idx: torch.Tensor


def nystrom_scores(C: torch.Tensor, ridge: float) -> torch.Tensor:
    """Ridge-leverage inverse-diagonal scores; smaller = keep."""
    return ridge_inverse_diag(C, ridge)


def nystrom_select(scores: torch.Tensor, rank: int) -> torch.Tensor:
    """Bottom-`rank` score indices, sorted ascending (reference:
    compress_mlp.py:45-47). Ties go to the lower index, as with
    ``jax.lax.top_k(-scores)``."""
    idx = torch.argsort(scores, stable=True)[:rank]
    return torch.sort(idx).values


def nystrom_mlp(
    C: torch.Tensor,
    W_u: torch.Tensor,
    W_g: Optional[torch.Tensor],
    W_d: torch.Tensor,
    keep_ratio: float,
    ridge: float,
    rank: Optional[int] = None,
) -> MLPFactors:
    """Full Type-I solve for one layer.

    Args:
      C:   [D_int, D_int] activation Gram (normalised by token count).
      W_u: [D_int, d_model] up (fc1) weight.
      W_g: [D_int, d_model] gate weight, or None.
      W_d: [d_model, D_int] down (fc2) weight.
      keep_ratio: fraction of intermediate columns to keep.
      ridge: ridge-leverage lambda (config.nystrom_ridge).
      rank: explicit kept-column count, overriding keep_ratio.
    """
    d_int = C.shape[0]
    if rank is None:
        rank = max(1, int(d_int * keep_ratio))  # reference: compress_mlp.py:37
    idx = nystrom_select(nystrom_scores(C, ridge), rank)
    up = W_u[idx]
    gate = None if W_g is None else W_g[idx]
    C_S = C[idx]  # [rank, D_int]
    cross = C_S @ W_d.T  # [rank, d_model]
    down_T = cholesky_solve_ridged(C_S[:, idx], cross, NYSTROM_SOLVE_RIDGE)
    return MLPFactors(up=up, gate=gate, down=down_T.T, idx=idx)
