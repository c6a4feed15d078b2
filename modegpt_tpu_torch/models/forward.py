"""Functional decoder-only forward pass with calibration taps.

Port of ``modegpt_tpu.models.forward`` for the dense and compressed
(heterogeneous per-layer rank, rotary-masked) llama, qwen3 and opt
models. Parameters are the JAX package's tree as torch tensors: kernels
in ``[in, out]`` layout (``y = x @ kernel``), per-layer rotary masks as
int32 leaves.

When ``stats_layers`` is non-empty the forward also returns the
calibration statistics (`CalibStats`): Grams of the post-activation MLP
intermediate (``cov_mlp``), of the raw per-head q/k projections
(``cov_q`` / ``cov_k``, pre-RoPE, pre-q_norm) and of the attention input
(``cov_x``), plus the per-layer Block-Influence accumulators
(``bi_acc``, reference: calibration.py:118-124).

Attention at ``128 <= T <= 8192`` goes through the hand-written CUDA
kernel K1 and at ``T > 8192`` through the long-context kernel K2
(``kernels/flash_attention.py``) on the card, the route the JAX forward
takes to its two Pallas kernels; shorter sequences and the CPU take the
plain masked-softmax version, computed over blocks of query rows.

Precision: "highest" means true float32, so TF32 is switched off for
matmuls and convolutions when this module is imported
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``); the ``gram_precision``
knob opts single Gram products into reduced precision.
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from modegpt_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_hbm,
    flash_attention_reference,
)
from modegpt_tpu_torch.models.spec import ModelSpec
from modegpt_tpu_torch.ops.rope import apply_rope, masked_head_rms_norm, rope_cos_sin

__all__ = ["forward", "CalibStats", "check_supported", "SUPPORTED_ARCHS"]

# "highest" = true float32 (the JAX package's Precision.HIGHEST).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SUPPORTED_ARCHS = ("llama", "qwen3", "opt")
FLASH_MIN_T = 128  # the JAX forward's flash-route threshold
FLASH_MAX_T = 8192  # beyond: the long-context kernel (K2)


class CalibStats(NamedTuple):
    """Per-batch Gram statistics for `stats_layers` (stacked on axis 0)."""

    cov_mlp: torch.Tensor  # [n_t, D_int, D_int]
    cov_q: torch.Tensor  # [n_t, n_heads, hd, hd]
    cov_k: torch.Tensor  # [n_t, n_kv_heads, hd, hd]
    cov_x: torch.Tensor  # [n_t, d_model, d_model]
    bi_acc: torch.Tensor  # [n_layers]


def check_supported(spec: ModelSpec) -> None:
    """Raise NotImplementedError for a spec this port cannot run yet."""
    missing = []
    if spec.arch not in SUPPORTED_ARCHS:
        missing.append(f"arch {spec.arch!r} (ported: {', '.join(SUPPORTED_ARCHS)})")
    if spec.n_experts:
        missing.append("MoE layers")
    if spec.post_norms or not spec.pre_norms or spec.flat_qk_norm:
        missing.append("gemma2/olmo2 norm wiring")
    if spec.attn_logit_softcap is not None or spec.final_logit_softcap is not None:
        missing.append("logit soft-capping")
    if missing:
        raise NotImplementedError(
            "modegpt_tpu_torch.models.forward does not support " + "; ".join(missing)
        )


def _norm(x: torch.Tensor, p: Dict, kind: str, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]
    if kind == "layernorm":
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
        return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"] + p["bias"]
    raise NotImplementedError(f"modegpt_tpu_torch.models.forward: norm {kind!r} is not ported")


def _linear(x: torch.Tensor, p: Dict) -> torch.Tensor:
    if "kernel" not in p:
        raise NotImplementedError(
            "modegpt_tpu_torch.models.forward: quantised kernels are not ported"
        )
    y = x @ p["kernel"]
    if "bias" in p:
        y = y + p["bias"]
    return y


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "relu":
        return F.relu(x)
    if kind == "gelu":
        return F.gelu(x)  # HF "gelu" is exact erf
    if kind in ("gelu_new", "gelu_pytorch_tanh"):
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {kind}")


@contextlib.contextmanager
def _tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _gram_of(a: torch.Tensor, b: torch.Tensor, eq: str, prec: str) -> torch.Tensor:
    """einsum ``eq`` of a with b with float32 accumulation at ``prec``:
      * "highest": float32 inputs, true float32 products (the parity path);
      * "high":    float32 inputs through TF32 on the card (the card's
        reduced-precision float32 product; the CPU computes full float32,
        as XLA:CPU does for the JAX package's HIGH);
      * "bf16":    inputs rounded to bfloat16, products and sums in
        float32 (bf16 x bf16 products are exact in float32).
    """
    if prec == "bf16":
        a = a.to(torch.bfloat16).to(torch.float32)
        b = a if b is None else b.to(torch.bfloat16).to(torch.float32)
        return torch.einsum(eq, a, b)
    a = a.to(torch.float32)
    b = a if b is None else b.to(torch.float32)
    if prec == "high":
        with _tf32():
            return torch.einsum(eq, a, b)
    return torch.einsum(eq, a, b)


def _gram(x2d: torch.Tensor, prec: str = "highest") -> torch.Tensor:
    """X^T X with float32 accumulation (see `_gram_of` for prec)."""
    return _gram_of(x2d, None, "ni,nj->ij", prec)


def _head_gram(x: torch.Tensor, prec: str = "highest") -> torch.Tensor:
    """[B,T,H,hd] -> per-head Gram [H, hd, hd] (see `_gram_of`)."""
    return _gram_of(x, None, "bthi,bthj->hij", prec)


def _attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scaling: float,
    window: Optional[int],
    impl: str = "xla",
) -> torch.Tensor:
    """Causal (optionally sliding-window) attention; q [B,H,T,r],
    k/v [B,Hk,T,r_k]. impl="flash" takes the CUDA kernel K1 for
    ``128 <= T <= 8192`` and K2 beyond (the JAX rule, forward.py:454-462);
    "xla" (the JAX name of the plain path) takes the masked float32-softmax
    version, which runs over blocks of query rows at any T."""
    T = q.shape[2]
    if impl == "flash" and T >= FLASH_MIN_T:
        kernel = flash_attention_hbm if T > FLASH_MAX_T else flash_attention
        return kernel(q.contiguous(), k.contiguous(), v.contiguous(), scale=scaling, window=window)
    return flash_attention_reference(q, k, v, scale=scaling, window=window)


def _layer(
    spec: ModelSpec,
    layer_idx: int,
    p: Dict,
    x: torch.Tensor,
    cos: Optional[torch.Tensor],
    sin: Optional[torch.Tensor],
    collect: bool,
    attn_impl: str = "xla",
    gram_precision: str = "highest",
):
    """One decoder layer. Returns (x_out, taps or None)."""
    B, T, _ = x.shape
    H, Hk = spec.n_heads, spec.n_kv_heads
    q_hd = spec.q_ranks[layer_idx] // H
    v_hd = spec.v_ranks[layer_idx] // Hk
    rotary_mask = p.get("rotary_mask")
    pre_ln = spec.do_layer_norm_before  # False = post-LN OPT (e.g. OPT-350m)
    taps = {}

    # ---- attention ----
    residual = x
    x_ln = _norm(x, p["attn_norm"], spec.norm, spec.norm_eps) if pre_ln else x
    q = _linear(x_ln, p["q"]).reshape(B, T, H, q_hd)
    k = _linear(x_ln, p["k"]).reshape(B, T, Hk, q_hd)
    v = _linear(x_ln, p["v"]).reshape(B, T, Hk, v_hd)
    if collect:
        taps["cov_x"] = _gram(x_ln.reshape(-1, spec.d_model), gram_precision)
        taps["cov_q"] = _head_gram(q, gram_precision)
        taps["cov_k"] = _head_gram(k, gram_precision)
    if spec.qk_norm:
        q = masked_head_rms_norm(q, p["q_norm"]["scale"], rotary_mask, spec.group_size, spec.norm_eps)
        k = masked_head_rms_norm(k, p["k_norm"]["scale"], rotary_mask, 1, spec.norm_eps)
    q = q.transpose(1, 2)  # [B, H, T, q_hd]
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    if spec.uses_rope:
        q, k = apply_rope(q, k, cos, sin, rotary_mask)

    window = None
    if spec.layer_types and spec.layer_types[layer_idx] == "sliding_attention":
        window = spec.sliding_window
    # compressed-head-dim scaling (reference: LlamaRebuild.py:282)
    attn = _attention(q, k, v, q_hd**-0.5, window, attn_impl)
    attn = attn.transpose(1, 2).reshape(B, T, H * v_hd)
    x = residual + _linear(attn, p["o"])
    if not pre_ln:
        x = _norm(x, p["attn_norm"], spec.norm, spec.norm_eps)

    x, h = _mlp_block(spec, p, x)
    if collect:
        taps["cov_mlp"] = _gram(h.reshape(-1, h.shape[-1]), gram_precision)
    return x, (taps if collect else None)


def _mlp_block(spec: ModelSpec, p: Dict, x: torch.Tensor):
    """A layer's MLP half with its residual (and norm: before for pre-LN,
    after for post-LN OPT). Returns (x_out, h), h the post-activation
    intermediate the calibration taps."""
    pre_ln = spec.do_layer_norm_before
    residual = x
    x_ln2 = _norm(x, p["mlp_norm"], spec.norm, spec.norm_eps) if pre_ln else x
    if spec.gated_mlp:
        h = _act(_linear(x_ln2, p["gate"]), spec.act) * _linear(x_ln2, p["up"])
    else:
        h = _act(_linear(x_ln2, p["up"]), spec.act)
    x = residual + _linear(h, p["down"])
    if not pre_ln:
        x = _norm(x, p["mlp_norm"], spec.norm, spec.norm_eps)
    return x, h


def _bi_piece(h_in: torch.Tensor, h_out: torch.Tensor) -> torch.Tensor:
    """sum_B mean_T (1 - cosine_sim(h_in, h_out)) in float32 (reference:
    calibration.py:122-124; torch.cosine_similarity's eps=1e-8 clamp)."""
    a = h_in.to(torch.float32)
    b = h_out.to(torch.float32)
    num = torch.sum(a * b, dim=-1)
    den = torch.clamp(torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1), min=1e-8)
    return torch.sum(torch.mean(1.0 - num / den, dim=1), dim=0)


@torch.no_grad()
def forward(
    spec: ModelSpec,
    params: Dict,
    input_ids: torch.Tensor,
    stats_layers: Tuple[int, ...] = (),
    attn_impl: str = "auto",
    gram_precision: str = "highest",
    want_logits: bool = True,
):
    """Run the model. Returns (logits | None, CalibStats | None).

    Args:
      spec: architecture (dense or compressed ranks).
      params: parameter tree (kernels in [in, out] layout), on one device.
      input_ids: [B, T] integer tokens on that device.
      stats_layers: layers whose Gram taps are collected; BI accumulators
        cover every layer whenever this is non-empty.
      attn_impl: "auto" (the CUDA kernel on the card, the plain version
        elsewhere), "flash" or "xla" (plain).
      want_logits: False skips the final norm and LM head (the JAX
        calibration path's dead-code-eliminated logits); logits is None.
    """
    check_supported(spec)
    B, T = input_ids.shape
    ids = input_ids.long()
    x = params["embed_tokens"][ids]
    if spec.arch == "opt":
        if "project_in" in params:  # OPT-350m-style word_embed_proj_dim
            x = _linear(x, params["project_in"])
        pos = torch.arange(T, device=ids.device) + spec.position_offset
        x = x + params["embed_positions"][pos][None]

    cos = sin = None
    if spec.uses_rope:
        positions = torch.arange(T, device=ids.device, dtype=torch.int32)
        cos, sin = rope_cos_sin(positions, spec.head_dim, spec.rope_theta, dtype=x.dtype, scaling=spec.rope_scaling)

    if attn_impl == "auto":
        attn_impl = "flash" if x.is_cuda else "xla"

    collect = len(stats_layers) > 0
    taps_by_layer = {}
    bi = []
    for l in range(spec.n_layers):
        h_in = x
        x, taps = _layer(
            spec, l, params["layers"][l], x, cos, sin,
            collect and (l in stats_layers), attn_impl, gram_precision,
        )
        if collect:
            bi.append(_bi_piece(h_in, x))
        if taps is not None:
            taps_by_layer[l] = taps

    logits = None
    if want_logits:
        if params.get("final_norm") is not None:
            x = _norm(x, params["final_norm"], spec.norm, spec.norm_eps)
        if "project_out" in params:
            x = _linear(x, params["project_out"])
        if params.get("lm_head") is not None:
            logits = _linear(x, params["lm_head"])
        else:
            logits = x @ params["embed_tokens"].T  # tied embeddings

    stats = None
    if collect:
        stats = CalibStats(
            cov_mlp=torch.stack([taps_by_layer[l]["cov_mlp"] for l in stats_layers]),
            cov_q=torch.stack([taps_by_layer[l]["cov_q"] for l in stats_layers]),
            cov_k=torch.stack([taps_by_layer[l]["cov_k"] for l in stats_layers]),
            cov_x=torch.stack([taps_by_layer[l]["cov_x"] for l in stats_layers]),
            bi_acc=torch.stack(bi),
        )
    return logits, stats
