"""PSD matrix square roots and ridge-leverage utilities on torch.linalg.

Port of ``modegpt_tpu.ops.psd`` (reference: src/compression_utils.py:15-55
`sqrt_M`, src/compression/compress_mlp.py:13-25 `get_ridge_scores`).
Everything runs on the tensor's own device and dtype: LAPACK on the CPU
(the float64 parity path), cuSOLVER on the card (the float32 path).

The JAX module's recursive and row-blocked triangular code exists for
TPU memory and the MXU; here the plain factorisations and triangular
solves are used at every size.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "sqrt_psd",
    "sqrt_and_inv_sqrt_psd",
    "ridge_inverse_diag",
    "cholesky_solve_ridged",
]


def _ridged_eigh(M: torch.Tensor, ridge: float, scaled: bool):
    """eigh with additive ridge on the eigenvalues: ``ridge * max_eig``
    when ``scaled`` else ``ridge`` (reference: compression_utils.py:35-36)."""
    w, V = torch.linalg.eigh(M)
    scale = w[..., -1:] if scaled else 1.0
    return w + ridge * scale, V


def sqrt_psd(M: torch.Tensor, ridge: float = 1e-4, scaled: bool = False) -> torch.Tensor:
    """PSD square root with eigenvalue ridge; negative post-ridge
    eigenvalues clamp to zero (reference: compression_utils.py:47)."""
    w, V = _ridged_eigh(M, ridge, scaled)
    sw = torch.sqrt(torch.clamp(w, min=0.0))
    return (V * sw.unsqueeze(-2)) @ V.transpose(-1, -2)


def sqrt_and_inv_sqrt_psd(
    M: torch.Tensor, ridge: float = 1e-4, scaled: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Simultaneous PSD square root and inverse square root from one
    eigensystem (reference: compression_utils.py:50-55)."""
    w, V = _ridged_eigh(M, ridge, scaled)
    sw = torch.sqrt(torch.clamp(w, min=0.0))
    isw = 1.0 / torch.clamp(sw, min=1e-12)
    Vt = V.transpose(-1, -2)
    return (V * sw.unsqueeze(-2)) @ Vt, (V * isw.unsqueeze(-2)) @ Vt


_ESCALATION_TRIES = 9


def _cholesky_escalated(A: torch.Tensor, ridge: float) -> torch.Tensor:
    """Cholesky of ``A + r*I``, escalating ``r`` while pivots fail.

    The first attempt uses the caller's ridge. When the factorisation
    fails (a non-positive pivot, or NaN on the factor diagonal — the
    JAX version's test), retry with the ridge raised to the
    factorisation's own rounding scale, ``max(32 r, 8 * eps * trace(A))``,
    then geometrically, for at most 9 attempts in all. A singular f32
    Gram (fewer calibration tokens than the kept rank) would otherwise
    give NaN factors. The well-conditioned case runs one factorisation.
    """
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    floor = 8.0 * torch.finfo(A.dtype).eps * float(torch.trace(A))
    r = float(ridge)
    for k in range(_ESCALATION_TRIES):
        if k > 0:
            r = max(r * 32.0, floor)
        L, info = torch.linalg.cholesky_ex(A + r * eye)
        if int(info) == 0 and not bool(torch.isnan(torch.diagonal(L)).any()):
            break
    return L


def ridge_inverse_diag(C: torch.Tensor, ridge: float = 1e-2) -> torch.Tensor:
    """diag((C + ridge*I)^-1) via Cholesky — the Type-I ridge leverage
    score; columns with the SMALLEST entries are kept (reference:
    compress_mlp.py:13-25,45). diag(A^-1)_j = ||L^-1 e_j||^2."""
    n = C.shape[-1]
    L = _cholesky_escalated(C, ridge)
    eye = torch.eye(n, dtype=C.dtype, device=C.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.sum(Linv * Linv, dim=0)


def cholesky_solve_ridged(A: torch.Tensor, B: torch.Tensor, ridge: float = 1e-6) -> torch.Tensor:
    """Solve ``(A + ridge*I) X = B`` for PSD ``A`` by two triangular
    solves (the Nyström down re-solve, reference: compress_mlp.py:56-57)."""
    L = _cholesky_escalated(A, ridge)
    y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
