"""Context-parallel ring-attention calibration: sequence split, K/V rotating.

Port of ``modegpt_tpu.parallel.ring``. The sequence-sharded calibration
(``calibrate(..., shard_sequence=True)``) gathers the full sequence for
attention on every rank; this is the path beyond that: each rank of a
``context`` mesh axis holds only its T/N-token chunk through the whole
forward, and attention is a RING (blockwise online softmax, the K/V
chunk shifted one neighbour a step, Liu et al. 2023), so a rank's
attention memory is O(T/N * chunk) instead of O(T).

Everything else in the forward is token-local (norms, projections,
MLP, Gram taps, BI cosines), so the statistics are exact:

* Gram accumulators are sums over tokens: all-reduced over the chunks,
  then accumulated in float64 on the host;
* BI is a mean over tokens: the mean of the equal chunks' means;
* RoPE (and learned positions) use each chunk's global positions.

The layer body is the forward's own (`models.forward._layer`) with
``attn_impl="ring"``; the one cross-token op dispatches to
`ring_attention`. A ring step's two products stay plain ``torch``
einsums, as the JAX package computes them with ``jnp.einsum`` outside
any Pallas kernel: K1 needs q and k of one length from position 0, and a
step holds a chunk of queries against another chunk's keys.

Causality leaves about half the ring steps fully masked for the average
chunk; they are computed all the same (a fixed N-step loop), as in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from modegpt_tpu_torch.calib.engine import CalibrationResult, _calibrate
from modegpt_tpu_torch.models.spec import ModelSpec
from modegpt_tpu_torch.parallel.mesh import Mesh, ring_shift

__all__ = ["ring_attention", "calibrate_ring", "supports_ring", "CTX_AXIS"]

CTX_AXIS = "context"
_NEG = -1e30  # finite -inf stand-in: exp(_NEG - m) == 0 in f32, no inf-inf NaN


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scaling: float, mesh: Mesh,
                   softcap: Optional[float] = None, window: Optional[int] = None,
                   axis: str = CTX_AXIS) -> torch.Tensor:
    """Blockwise causal attention over a ring of sequence chunks.

    q [B, H, C, hd] and k/v [B, Hk, C, hd_v] are this rank's chunk
    (global positions coordinate*C ..) on ``axis`` of ``mesh``; GQA is
    grouped, never repeated to H heads. Online softmax in float32 across
    the N ring steps; the causal (and sliding-window) mask comes from
    GLOBAL positions, which covers the fully visible, diagonal and fully
    masked blocks alike. Step 0 is the diagonal block, so every row has
    a finite running max from then on."""
    B, H, C, hd = q.shape
    Hk, hd_v = k.shape[1], v.shape[3]
    G = H // Hk
    N, idx = mesh.size(axis), mesh.coord(axis)
    dev = q.device

    qg = q.reshape(B, Hk, G, C, hd)
    q_pos = idx * C + torch.arange(C, device=dev)
    o = torch.zeros((B, Hk, G, C, hd_v), dtype=torch.float32, device=dev)
    m = torch.full((B, Hk, G, C), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hk, G, C), dtype=torch.float32, device=dev)
    k_r, v_r = k, v
    for r in range(N):
        src = (idx - r) % N  # which global chunk this step's K/V came from
        k_pos = src * C + torch.arange(C, device=dev)
        scores = (torch.einsum("bkgqd,bkcd->bkgqc", qg, k_r) * scaling).to(torch.float32)
        if softcap is not None:
            scores = torch.tanh(scores / softcap) * softcap
        mask = k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        scores = torch.where(mask, scores, torch.full((), _NEG, device=dev))

        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bkgqc,bkcd->bkgqd", p, v_r.to(torch.float32))
        m = m_new
        if r < N - 1:  # the JAX loop's last shift returns the chunks home unused
            k_r, v_r = ring_shift(mesh, [k_r, v_r], axis)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, C, hd_v).to(q.dtype)


def supports_ring(spec: ModelSpec, mesh: Optional[Mesh]) -> bool:
    """Ring calibration needs a 'context' mesh axis of size > 1. MoE
    stacks are fine: calibration runs every expert on every token
    (`models.forward._moe_mlp`), which is token-local."""
    return mesh is not None and mesh.size(CTX_AXIS) > 1


def calibrate_ring(
    spec: ModelSpec,
    params: Dict,
    batches: Sequence[np.ndarray],
    target_layers: Sequence[int],
    mesh: Mesh,
) -> CalibrationResult:
    """Drop-in `calib.engine.calibrate` over a context-parallel mesh:
    each rank's tokens are [B, T/N] (rows also split over a ``data``
    axis, if any), ring attention, all-reduced exact statistics
    accumulated in float64 on the host (JAX ``ring.py:129-220``)."""
    if not supports_ring(spec, mesh):
        raise ValueError("calibrate_ring needs a 'context' mesh axis")
    return _calibrate(spec, params, batches, target_layers, "host", "highest", "ring", mesh, CTX_AXIS)
