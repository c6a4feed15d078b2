"""Global layer-sparsity allocation from Block-Influence scores.

Port of ``modegpt_tpu.ops.allocation`` (reference:
src/compression_utils.py:79-124 `allocate_global_sparsity`): per-layer
sparsity = ``L * ratio * softmax(-bi / smoothing)`` followed by an
iterative clamp-at-max-and-redistribute loop, returning keep ratios
``1 - sparsity``. The scores are a handful of floats, so the pipeline
runs it in float64 on the CPU; `_allocate` is the tensor form.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

__all__ = ["allocate_keep_ratios"]

_MAX_ITERS = 10_000


def _allocate(s: torch.Tensor, ratio: float, smoothing: float, max_sparsity: float, invert: bool = False):
    """The allocator on a score tensor, in its dtype and on its device:
    (keep ratios [L], max layer sparsity) as tensors. The fused job
    (`compress.fused`) runs it in float32 on the card, as the JAX
    package runs its `_allocate` there. The JAX loop is a
    ``lax.while_loop``; here each iteration's convergence test reads one
    bool on the host (a handful of iterations in practice)."""
    if invert:
        # CKA-style scores: higher score => more compression
        # (reference: src/compression_utils.py:97-98).
        s = -s
    n_layers = s.shape[0]
    weights = torch.softmax(-s / smoothing, dim=0)
    sp = weights * (n_layers * ratio)

    # The reference loop (compression_utils.py:110-122) does not terminate
    # in floating point for sharp-softmax configs: once every high-weight
    # layer sits at the cap, the residual excess circulates among them
    # forever. As in the JAX version, convergence is declared once the
    # overshoot is at rounding level, with a hard iteration cap, and the
    # result is clipped to the cap.
    tol = 64.0 * torch.finfo(s.dtype).eps * max(max_sparsity, 1.0)
    cap = torch.as_tensor(max_sparsity, dtype=s.dtype, device=s.device)
    it = 0
    while bool((sp > max_sparsity + tol).any()) and it < _MAX_ITERS:
        clamped = sp > max_sparsity
        excess = torch.sum(torch.where(clamped, sp - max_sparsity, 0.0))
        sp = torch.where(clamped, cap, sp)
        free_w = torch.where(clamped, 0.0, weights)
        denom = torch.sum(free_w)
        # Redistribute proportionally among non-capped layers. If every
        # layer is capped the excess is dropped, matching the reference's
        # `if free.any()` guard.
        sp = torch.where(denom > 0.0, sp + excess * free_w / torch.clamp(denom, min=1e-30), sp)
        it += 1
    sp = torch.clamp(sp, max=max_sparsity)
    return 1.0 - sp, sp.max()


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
    keep, max_sp = _allocate(
        torch.as_tensor(list(bi_scores), dtype=dtype), compression_ratio, smoothing, max_sparsity, invert
    )
    return [float(x) for x in keep], float(max_sp)
