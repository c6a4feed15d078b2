"""Weight-only int8 execution and the W8A8 view of an int8 model.

Port of ``modegpt_tpu.models.quantize``. Projection kernels are stored
as symmetric per-out-channel int8 codes (``kernel_q``, [..., in, out])
with a float32 ``scale`` ([..., out]); `forward._linear` and the MoE
products consume them directly, so every execution path (unrolled,
padded, generation, serving) runs on a quantised tree. Norm scales,
biases, embeddings (gathers, not products), routers, ``shared_gate`` and
rotary masks stay as they are.

The int8 codes are laid out column-major (`forward.column_major`: the
same [..., in, out] values, each output column contiguous), the layout
the card's int8 GEMM takes without a copy in the W8A8 view.

Codes and scales are the JAX package's bit for bit: the max-abs runs
over the IN axis (-2), so ``[L, in, out]`` layer stacks and
``[E, in, out]`` expert stacks keep their own scales; the scale is
``amax / 127`` (1 where amax is 0); ``kernel / scale`` is rounded half
to even (``torch.round``, as ``jnp.round``) and clipped to [-127, 127].

A padded stack (`models.padded.pad_to_uniform`) is quantised AFTER
padding (`quantize_padded`): zero pads change no column's max-abs and
quantise to zero codes, and an all-zero kernel (the other MLP kind of a
mixed dense/MoE stack) quantises to zero codes with scale 1, exactly.

Resident int4 (from an int4 artifact loaded with ``resident_int8``)
takes a form of its own, because torch has no int4 type that computes:
``kernel_q`` is a ``uint8`` tensor [..., in, ceil(out / 2)] holding two
codes a byte along the OUT axis (column 2j in the low nibble, 2j + 1 in
the high one), each stored as code + 8 (codes in [-7, 7]); the true
width is ``scale.shape[-1]``. That is 0.5 bytes a weight plus 4 bytes a
column (int8: 1 byte a weight), the 4x residency against bfloat16 that
the JAX package's ``jnp.int4`` gives. Its dtype keeps it out of the W8A8
view, as ``jnp.int4`` does in the JAX package: a 4-bit code is never
run as an 8-bit activation-quantised product.
"""

from __future__ import annotations

from typing import Dict

import torch

from modegpt_tpu_torch.models.forward import column_major, pack_int4, true_div, unpack_int4
from modegpt_tpu_torch.models.padded import PaddedModel

__all__ = [
    "quantize_linear",
    "quantize_params",
    "quantize_padded",
    "with_act_quant",
    "pack_int4",
    "unpack_int4",
]

_PROJECTIONS = ("q", "k", "v", "o", "up", "gate", "down")


def quantize_linear(p: Dict) -> Dict:
    """{"kernel": [..., in, out]} -> {"kernel_q": int8, "scale": [..., out]},
    the other leaves (a bias) kept. Idempotent: a dict without a float
    ``kernel`` comes back as it is."""
    if "kernel" not in p or p["kernel"].dtype == torch.int8:
        return p
    k = p["kernel"].to(torch.float32)
    amax = torch.amax(torch.abs(k), dim=-2, keepdim=True)
    scale = torch.where(amax == 0.0, torch.ones_like(amax), true_div(amax, 127.0))
    q = torch.clamp(torch.round(k / scale), -127, 127).to(torch.int8)
    out = {name: v for name, v in p.items() if name != "kernel"}
    out["kernel_q"] = column_major(q)
    out["scale"] = scale.squeeze(-2)
    return out


def _quantize_layer(lp: Dict) -> Dict:
    out = {}
    for name, sub in lp.items():
        if name in _PROJECTIONS:
            out[name] = quantize_linear(sub)
        elif name in ("experts", "shared"):
            out[name] = {k: quantize_linear(v) for k, v in sub.items()}
        else:
            out[name] = sub  # norms, router, shared_gate, rotary_mask
    return out


def quantize_params(params: Dict) -> Dict:
    """Quantise every projection kernel of a plain parameter tree (a list
    of per-layer dicts) and the LM head; embeddings stay full precision
    (a token gather reads only the looked-up rows)."""
    out = dict(params)
    out["layers"] = [_quantize_layer(lp) for lp in params["layers"]]
    if params.get("lm_head") is not None:
        out["lm_head"] = quantize_linear(params["lm_head"])
    return out


def quantize_padded(pm: PaddedModel) -> PaddedModel:
    """Quantise a padded stack: the stacked [L, ...] kernels get
    per-(layer, out-channel) scales [L, out] ([L, E, out] for experts), so
    ``layers[...][l]`` hands layer l its own [out] ([E, out]) scale."""
    other = dict(pm.other)
    if pm.other.get("lm_head") is not None:
        other["lm_head"] = quantize_linear(pm.other["lm_head"])
    return pm._replace(layers=_quantize_layer(pm.layers), other=other)


def _qa_view_linear(p: Dict) -> Dict:
    # kernel_q -> kernel_qa on int8 codes only: the tensor is shared, not
    # copied. Packed int4 (uint8) stays weight-only.
    if "kernel_q" in p and p["kernel_q"].dtype == torch.int8:
        q = {k: v for k, v in p.items() if k != "kernel_q"}
        q["kernel_qa"] = p["kernel_q"]
        return q
    return p


def _qa_view_layer(lp: Dict) -> Dict:
    out = {}
    for name, sub in lp.items():
        if name in _PROJECTIONS:
            out[name] = _qa_view_linear(sub)
        elif name in ("experts", "shared"):
            out[name] = {k: _qa_view_linear(v) for k, v in sub.items()}
        else:
            out[name] = sub
    return out


def with_act_quant(pm):
    """The W8A8 view of an int8 model (a `PaddedModel` or a plain tree):
    every int8 projection re-keyed ``kernel_q`` -> ``kernel_qa``, so
    `forward._linear` quantises the activation per token and runs the
    product int8 x int8 -> int32 (`forward._dot_w8a8`). The view shares
    every tensor with the model. The LM head stays weight-only, and so
    does everything that is not int8 (float kernels, packed int4): on an
    unquantised model the view is the identity."""
    if isinstance(pm, PaddedModel):
        return pm._replace(layers=_qa_view_layer(pm.layers))
    out = dict(pm)
    out["layers"] = [_qa_view_layer(lp) for lp in pm["layers"]]
    return out

