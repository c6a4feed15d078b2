"""Pure-functional model surgery.

Port of ``modegpt_tpu.compress.surgery``: dense (spec, params) + solver
factors -> compressed (spec, params). The compressed spec carries the
per-layer rank lists; the compressed params carry the new kernels and
the per-layer rotary masks. Solvers emit HF ``[out, in]`` weights;
forward kernels are ``[in, out]`` — the transposition happens here.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from modegpt_tpu_torch.models.convert import to_tensor
from modegpt_tpu_torch.models.spec import ModelSpec

__all__ = ["compress_ranks_for_layer", "apply_factors"]


def compress_ranks_for_layer(spec: ModelSpec, keep_ratio: float, kind: str) -> int:
    """Per-layer rank from a keep ratio, with the reference's rounding:

    kind='mlp':  rank = int(d_int * keep)            (compress_mlp.py:37)
    kind='qk':   per head, even for RoPE archs       (compress_qk.py:177-182)
    kind='vo':   per head, even for RoPE archs       (compress_vo.py:36-41)
    """
    if kind == "mlp":
        return max(1, int(spec.d_int * keep_ratio))
    if kind not in ("qk", "vo"):
        raise NotImplementedError(f"modegpt_tpu_torch.compress.surgery: rank kind {kind!r}")
    rank = int(spec.head_dim * keep_ratio)
    rank = max(1, min(rank, spec.head_dim))
    if spec.uses_rope:
        rank -= rank % 2
        rank = max(2, min(rank, spec.head_dim))
    return rank


def _as_kernel(w, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """HF [out, in] weight (numpy or tensor) -> [in, out] kernel."""
    return to_tensor(w, device, dtype).transpose(-1, -2).contiguous()


def apply_factors(
    spec: ModelSpec,
    params: Dict,
    mlp_factors: Optional[Dict[int, Dict]] = None,
    qk_factors: Optional[Dict[int, Dict]] = None,
    vo_factors: Optional[Dict[int, Dict]] = None,
    release_dense: bool = False,
):
    """Build the compressed (spec, params) from per-layer solver factors.

    Each factors dict maps layer_idx -> dict of HF-layout arrays:
      mlp: {"up", "gate"?, "down", "up_bias"?, "down_bias"?}
      qk:  {"q", "k", "rotary_mask"?, "q_bias"?, "k_bias"?}
      vo:  {"v", "o", "o_bias"?}
    Layers absent from a dict keep their dense weights. New kernels land
    on the model's device in the model's dtype.

    release_dense: MUTATES ``params`` — pops each replaced dense
    projection as its compressed kernel is built, so the device can free
    it once nothing else references it.
    """
    mlp_factors = mlp_factors or {}
    qk_factors = qk_factors or {}
    vo_factors = vo_factors or {}
    q_ranks = list(spec.q_ranks)
    k_ranks = list(spec.k_ranks)
    v_ranks = list(spec.v_ranks)
    o_ranks = list(spec.o_ranks)
    gate_ranks = list(spec.gate_ranks)
    dtype = params["embed_tokens"].dtype
    dev = params["embed_tokens"].device

    new_layers = []
    any_mask = False
    for l in range(spec.n_layers):
        lp = dict(params["layers"][l])  # shallow copy; replaced leaves are new
        if l in mlp_factors:
            f = mlp_factors[l]
            if np.ndim(f["up"]) != 2:
                raise NotImplementedError(
                    f"modegpt_tpu_torch.compress.surgery: layer {l} has MoE factors"
                )
            lp["up"] = {"kernel": _as_kernel(f["up"], dtype, dev)}
            if spec.gated_mlp:
                lp["gate"] = {"kernel": _as_kernel(f["gate"], dtype, dev)}
            lp["down"] = {"kernel": _as_kernel(f["down"], dtype, dev)}
            if f.get("up_bias") is not None:
                lp["up"]["bias"] = to_tensor(f["up_bias"], dev, dtype)
            if f.get("down_bias") is not None:
                lp["down"]["bias"] = to_tensor(f["down_bias"], dev, dtype)
            gate_ranks[l] = int(f["up"].shape[0])

        if l in qk_factors:
            f = qk_factors[l]
            lp["q"] = {"kernel": _as_kernel(f["q"], dtype, dev)}
            lp["k"] = {"kernel": _as_kernel(f["k"], dtype, dev)}
            if f.get("q_bias") is not None:
                lp["q"]["bias"] = to_tensor(f["q_bias"], dev, dtype)
                lp["k"]["bias"] = to_tensor(f["k_bias"], dev, dtype)
            if f.get("rotary_mask") is not None:
                lp["rotary_mask"] = to_tensor(f["rotary_mask"], dev).to(torch.int32)
                any_mask = True
            q_ranks[l] = int(f["q"].shape[0])
            k_ranks[l] = int(f["k"].shape[0])

        if l in vo_factors:
            f = vo_factors[l]
            lp["v"] = {"kernel": _as_kernel(f["v"], dtype, dev)}
            lp["o"] = {"kernel": _as_kernel(f["o"], dtype, dev)}
            if f.get("o_bias") is not None:
                lp["o"]["bias"] = to_tensor(f["o_bias"], dev, dtype)
            v_ranks[l] = int(f["v"].shape[0])
            o_ranks[l] = int(f["o"].shape[1])

        if release_dense:
            src = params["layers"][l]
            if l in mlp_factors:
                for key in ("up", "gate", "down"):
                    src.pop(key, None)
            if l in qk_factors:
                src.pop("q", None)
                src.pop("k", None)
            if l in vo_factors:
                src.pop("v", None)
                src.pop("o", None)
        new_layers.append(lp)

    new_params = dict(params)
    new_params["layers"] = new_layers
    new_spec = spec.with_ranks(
        q_ranks=q_ranks,
        k_ranks=k_ranks,
        v_ranks=v_ranks,
        o_ranks=o_ranks,
        gate_ranks=gate_ranks,
        has_rotary_masks=any_mask or spec.has_rotary_masks,
    )
    return new_spec, new_params
