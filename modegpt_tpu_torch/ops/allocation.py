"""Global layer-sparsity allocation from Block-Influence scores.

Port of ``modegpt_tpu.ops.allocation`` (reference:
src/compression_utils.py:79-124 `allocate_global_sparsity`): per-layer
sparsity = ``L * ratio * softmax(-bi / smoothing)`` followed by an
iterative clamp-at-max-and-redistribute loop, returning keep ratios
``1 - sparsity``. The scores are a handful of floats, so this runs in
float64 on the CPU.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

__all__ = ["allocate_keep_ratios"]

_MAX_ITERS = 10_000


def allocate_keep_ratios(
    bi_scores: Sequence[float],
    compression_ratio: float,
    smoothing: float = 0.015,
    max_sparsity: float = 0.8,
    invert: bool = False,
    dtype: torch.dtype = torch.float64,
) -> Tuple[List[float], float]:
    """Allocate per-layer keep ratios; returns ``(keep_ratios [L],
    max_layer_sparsity)`` as host floats (reference:
    compression_utils.py:106-124)."""
    s = torch.as_tensor(list(bi_scores), dtype=dtype)
    if invert:
        # CKA-style scores: higher score => more compression
        # (reference: src/compression_utils.py:97-98).
        s = -s
    n_layers = s.shape[0]
    weights = torch.softmax(-s / smoothing, dim=0)
    sp = weights * (n_layers * compression_ratio)

    # The reference loop (compression_utils.py:110-122) does not terminate
    # in floating point for sharp-softmax configs: once every high-weight
    # layer sits at the cap, the residual excess circulates among them
    # forever. As in the JAX version, convergence is declared once the
    # overshoot is at rounding level, with a hard iteration cap, and the
    # result is clipped to the cap.
    tol = 64.0 * torch.finfo(dtype).eps * max(max_sparsity, 1.0)
    it = 0
    while bool((sp > max_sparsity + tol).any()) and it < _MAX_ITERS:
        clamped = sp > max_sparsity
        excess = torch.sum(torch.where(clamped, sp - max_sparsity, 0.0))
        sp = torch.where(clamped, torch.as_tensor(max_sparsity, dtype=dtype), sp)
        free_w = torch.where(clamped, 0.0, weights)
        denom = torch.sum(free_w)
        # If every layer is capped the excess is dropped, matching the
        # reference's `if free.any()` guard.
        if float(denom) > 0.0:
            sp = sp + excess * free_w / denom
        it += 1
    sp = torch.clamp(sp, max=max_sparsity)
    return [float(x) for x in (1.0 - sp)], float(sp.max())
