"""Functional decoder-only forward pass with calibration taps.

Port of ``modegpt_tpu.models.forward`` for every architecture the spec
parses, dense and compressed (heterogeneous per-layer rank,
rotary-masked): llama, mistral, qwen2, qwen3, phi3, starcoder2, gemma,
gemma2, olmo2, opt and gpt2, and the mixture-of-experts mixtral,
qwen3_moe (all-MoE or mixed with dense layers) and qwen2_moe (shared
expert, qkv biases). Parameters are the JAX package's tree as torch
tensors: kernels in ``[in, out]`` layout (``y = x @ kernel``), expert
stacks ``[E, in, out]``, per-layer rotary masks as int32 leaves.

The layer's wiring follows the spec: pre-norms (or none: olmo2; or the
norm after the residual add: post-LN OPT), gemma2's and olmo2's
post-sublayer norms on each sublayer's output before its residual add,
qwen3's per-head or olmo2's whole-projection q/k norm, gemma's
``(1 + w)`` RMSNorm and ``sqrt(d_model)`` embedding scale, gemma2's
fixed attention scale and its soft caps on the attention scores and the
final logits, learned positions for opt and gpt2.

When ``stats_layers`` is non-empty the forward also returns the
calibration statistics (`CalibStats`): Grams of the post-activation MLP
intermediate (``cov_mlp``; per expert ``[E, D, D]`` over the tokens
routed to it on a MoE layer), of the shared expert's intermediate
(``cov_shared``), of the raw per-head q/k projections (``cov_q`` /
``cov_k``, pre-RoPE, pre-q_norm) and of the attention input (``cov_x``),
plus the per-layer Block-Influence accumulators (``bi_acc``, reference:
calibration.py:118-124).

MoE layers run every expert on every token (`_moe_mlp`, the JAX
package's formulation: static shapes, E/k times the routed FLOPs) or,
in serving, through capacity-based token dispatch (`_moe_mlp_dispatch`).
Routing is a float32 softmax over all experts, then the top k with ties
to the lower expert index (a stable sort, as ``lax.top_k`` breaks them),
renormalised when ``norm_topk_prob``.

Projections take the three forms of `models.quantize` (`_linear`):
float ``kernel``, weight-only ``kernel_q`` + ``scale`` (int8, or
resident int4 packed two codes a byte) and the W8A8 view's
``kernel_qa``, whose int8 x int8 products accumulate in int32 through
``torch._int_mm`` (`_int_mm`, zero-padded to the shapes the card's call
takes; never a float fallback). The MoE forms take the same three
(`_expert_mm`, `_expert_down_sum`).

Attention at ``128 <= T <= 8192`` goes through the hand-written CUDA
kernel K1 and at ``T > 8192`` through the long-context kernel K2
(``kernels/flash_attention.py``) on the card, the route the JAX forward
takes to its two Pallas kernels; shorter sequences, the CPU and a layer
whose scores are soft-capped (gemma2: the kernels have no cap, and the
JAX forward sends such a layer to XLA) take the plain masked-softmax
version, computed over blocks of query rows.

Precision: "highest" means true float32, so TF32 is switched off for
matmuls and convolutions when this module is imported
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``); the ``gram_precision``
knob opts single Gram products into reduced precision.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from modegpt_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_hbm,
    flash_attention_reference,
)
from modegpt_tpu_torch.models.spec import ARCHS, ModelSpec
from modegpt_tpu_torch.ops.rope import apply_rope, masked_flat_rms_norm, masked_head_rms_norm, rope_cos_sin
from modegpt_tpu_torch.parallel.mesh import all_gather, all_reduce
from modegpt_tpu_torch.utils.profiling import span

__all__ = ["forward", "forward_taps", "CalibStats", "check_supported", "SUPPORTED_ARCHS"]

# "highest" = true float32 (the JAX package's Precision.HIGHEST).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SUPPORTED_ARCHS = ARCHS  # every architecture the spec parses
FLASH_MIN_T = 128  # the JAX forward's flash-route threshold
FLASH_MAX_T = 8192  # beyond: the long-context kernel (K2)


class CalibStats(NamedTuple):
    """Per-batch Gram statistics for `stats_layers` (stacked on axis 0)."""

    cov_mlp: torch.Tensor  # [n_t, D_int, D_int] (MoE: [n_t, E, D, D])
    cov_q: torch.Tensor  # [n_t, n_heads, hd, hd]
    cov_k: torch.Tensor  # [n_t, n_kv_heads, hd, hd]
    cov_x: torch.Tensor  # [n_t, d_model, d_model]
    bi_acc: torch.Tensor  # [n_layers]
    # shared-expert intermediate Gram [n_t, Ds, Ds]; None unless every
    # tapped layer has a shared expert (qwen2_moe)
    cov_shared: Optional[torch.Tensor] = None


def check_supported(spec: ModelSpec) -> None:
    """Raise NotImplementedError for an architecture this port does not
    know."""
    if spec.arch not in SUPPORTED_ARCHS:
        raise NotImplementedError(
            f"modegpt_tpu_torch.models.forward does not support arch {spec.arch!r} "
            f"(ported: {', '.join(SUPPORTED_ARCHS)})"
        )


def _norm(x: torch.Tensor, p: Dict, kind: str, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]
    if kind == "rmsnorm_1p":
        # gemma: scale by (1 + weight), in float32 before the cast
        # (HF GemmaRMSNorm.forward)
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + eps) * (1.0 + p["scale"].to(torch.float32))).to(x.dtype)
    if kind == "layernorm":
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
        return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"] + p["bias"]
    raise NotImplementedError(f"modegpt_tpu_torch.models.forward: norm {kind!r} is not ported")


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Resident int4 (see `models.quantize`): codes in [-8, 7] of any
    integer dtype [..., out] -> uint8 [..., ceil(out / 2)], each code
    stored as code + 8, column 2j in the low nibble and 2j + 1 in the high
    one (an odd last column pairs with a zero nibble)."""
    n = (codes.to(torch.int16) + 8).to(torch.uint8)
    if n.shape[-1] % 2:
        n = torch.cat([n, torch.zeros_like(n[..., :1])], dim=-1)
    return n[..., 0::2] | (n[..., 1::2] << 4)


def unpack_int4(packed: torch.Tensor, out: int) -> torch.Tensor:
    """`pack_int4`'s inverse: uint8 [..., ceil(out / 2)] -> int8 codes
    [..., out]."""
    n = torch.stack([packed & 0x0F, packed >> 4], dim=-1).flatten(-2)[..., :out]
    return n.to(torch.int8) - 8


def _dequant(p: Dict, dtype: torch.dtype, row_major: bool = False) -> torch.Tensor:
    """A weight-only leaf's codes (``kernel_q``: int8, or resident int4
    unpacked to its true width ``scale.shape[-1]``) converted to
    ``dtype``: the copy torch writes on every call, where XLA fuses the
    convert into the product. It keeps the codes' layout (the products
    take either), or is laid out row-major with ``row_major``."""
    q = p["kernel_q"]
    if q.dtype == torch.uint8:
        q = unpack_int4(q, p["scale"].shape[-1])
    return q.to(dtype, memory_format=torch.contiguous_format if row_major else torch.preserve_format)


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c, correctly rounded on every device. On the card a Python
    number as the divisor becomes a product with its reciprocal, which
    differs in the last bit; a tensor divisor keeps the division, so the
    quantisers' codes and scales are the JAX package's (numpy's) bit for
    bit."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _act_quant(x: torch.Tensor):
    """Dynamic symmetric per-token int8 quantisation of the last axis:
    x [..., d] -> (codes int8 [..., d], scale float32 [..., 1]); an
    all-zero row gets scale 1 (JAX forward.py:83)."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    s = torch.where(amax == 0.0, torch.ones_like(amax), true_div(amax, 127.0))
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


INT_MM_MIN_ROWS = 17  # the card's torch._int_mm takes M > 16 rows ...
INT_MM_ALIGN = 8  # ... and K and N multiples of 8


def column_major(q: torch.Tensor) -> torch.Tensor:
    """The same [..., in, out] values laid out column-major (each output
    column's codes contiguous), the layout `_int_mm` takes without a copy;
    the quantisers store int8 codes so."""
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 a [M, K] @ int8 b [K, N] -> int32 [M, N], exact, through
    ``torch._int_mm`` (on the card, cuBLASLt's int8 tensor-core GEMM).
    The card's call takes M > 16 and K and N multiples of 8, so a and b
    are zero-padded to that (zero codes add exactly zero) and the result
    sliced. It also refuses many shapes (M = 24 or 48 with K = 64 and
    N = 56, for one) with a row-major b, and took every shape tried with
    a row-major a and a column-major b (cuBLAS's "TN" form): b is used as
    it is when it is column-major and aligned (`column_major`, as the
    quantisers store it), else copied into a column-major buffer with its
    padding. The CPU takes the same path. There is no float fallback: a
    product the call refuses raises. The int32 sum cannot overflow for
    K <= 133 000 (K * 127^2 < 2^31)."""
    M, K = a.shape
    N = b.shape[1]
    Mp = max(M, INT_MM_MIN_ROWS)
    Kp, Np = -(-K // INT_MM_ALIGN) * INT_MM_ALIGN, -(-N // INT_MM_ALIGN) * INT_MM_ALIGN
    if (Mp, Kp) != (M, K):
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
    if (Kp, Np) != (K, N) or not b.t().is_contiguous():
        bt = b.new_zeros((Np, Kp))
        bt[:N, :K] = b.t()
        b = bt.t()
    return torch._int_mm(a.contiguous(), b)[:M, :N]


def _dot_w8a8(x: torch.Tensor, kq: torch.Tensor, wscale: torch.Tensor) -> torch.Tensor:
    """W8A8 product (JAX forward.py:94): per-token int8 activations times
    int8 weights, accumulated in int32, rescaled ``acc * x_scale *
    w_scale`` in float32 (the JAX order)."""
    xq, xs = _act_quant(x)
    acc = _int_mm(xq.reshape(-1, x.shape[-1]), kq).reshape(*x.shape[:-1], kq.shape[-1])
    return (acc.to(torch.float32) * xs * wscale.to(torch.float32)).to(x.dtype)


def _linear(x: torch.Tensor, p: Dict) -> torch.Tensor:
    """``x @ kernel (+ bias)`` for the three forms of a projection
    (JAX forward.py:108): float ``kernel``; weight-only ``kernel_q`` +
    ``scale`` (int8, or packed int4), the codes converted to x's dtype
    and the per-out-channel scale applied to the output (`_dequant`);
    and the W8A8 view's ``kernel_qa`` (`_dot_w8a8`)."""
    if "kernel_qa" in p:
        y = _dot_w8a8(x, p["kernel_qa"], p["scale"])
    elif "kernel_q" in p:
        y = (x @ _dequant(p, x.dtype)) * p["scale"].to(x.dtype)
    else:
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


def _scale_embed(spec: ModelSpec, x: torch.Tensor) -> torch.Tensor:
    """gemma and gemma2 scale the token embeddings by sqrt(d_model),
    rounded through the model dtype (HF GemmaModel.forward)."""
    if spec.arch in ("gemma", "gemma2"):
        return x * torch.tensor(spec.d_model**0.5, dtype=x.dtype)
    return x


def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """gemma2's soft cap ``cap * tanh(x / cap)``, computed in place on
    ``x`` (a fresh score or logit tensor); x itself when cap is None."""
    if cap is None:
        return x
    return x.div_(cap).tanh_().mul_(cap)


def _embed(spec: ModelSpec, params: Dict, ids: torch.Tensor, positions: Optional[torch.Tensor] = None):
    """Token embeddings (gemma's scale; OPT-350m's ``project_in``) plus,
    for opt and gpt2, the learned positions at ``positions`` ([T] or
    [B, T] absolute positions, default 0..T-1; OPT's table is offset by
    2). A position past the table reads its last row, as the JAX gather
    clamps; on a CUDA tensor an out-of-range index would be a device-side
    assert."""
    x = _scale_embed(spec, params["embed_tokens"][ids.long()])
    if spec.uses_rope:
        return x
    if "project_in" in params:
        x = _linear(x, params["project_in"])
    if positions is None:
        positions = torch.arange(ids.shape[1], device=ids.device)
    table = params["embed_positions"]
    pe = table[(positions.long() + spec.position_offset).clamp_(max=table.shape[0] - 1)]
    return x + (pe[None] if pe.dim() == 2 else pe)


def _unembed(spec: ModelSpec, params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm, OPT-350m's ``project_out``, the LM head (or the tied
    embeddings) and gemma2's final soft cap."""
    if params.get("final_norm") is not None:
        x = _norm(x, params["final_norm"], spec.norm, spec.norm_eps)
    if "project_out" in params:
        x = _linear(x, params["project_out"])
    if params.get("lm_head") is not None:
        logits = _linear(x, params["lm_head"])
    else:
        logits = x @ params["embed_tokens"].T  # tied embeddings
    return _softcap(logits, spec.final_logit_softcap)


def _attn_scale(spec: ModelSpec, q_hd: int) -> float:
    """The score scale: the compressed head dim's (reference:
    LlamaRebuild.py:282), or gemma2's query_pre_attn_scalar**-0.5, which
    stays fixed under compression."""
    if spec.query_pre_attn_scalar is not None:
        return spec.query_pre_attn_scalar**-0.5
    return q_hd**-0.5


def _attn_input(spec: ModelSpec, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """What the q/k/v projections see: x through the pre-attention norm,
    or x itself where the layer has none (olmo2; post-LN OPT)."""
    if spec.do_layer_norm_before and spec.pre_norms:
        return _norm(x, p["attn_norm"], spec.norm, spec.norm_eps)
    return x


def _qk_norms(spec: ModelSpec, p: Dict, q: torch.Tensor, k: torch.Tensor, rotary_mask, r_true=None):
    """q [B, T, H, r], k [B, T, Hk, r] through qwen3's per-head or
    olmo2's whole-projection RMSNorm (unchanged for the other archs), the
    weights gathered through the rotary mask. ``r_true``: the padded
    stack's true per-head rank, so that zero pads do not dilute the
    variance."""
    if spec.qk_norm:
        q = masked_head_rms_norm(q, p["q_norm"]["scale"], rotary_mask, spec.group_size, spec.norm_eps, r_true)
        k = masked_head_rms_norm(k, p["k_norm"]["scale"], rotary_mask, 1, spec.norm_eps, r_true)
    elif spec.flat_qk_norm:
        B, T, H, r = q.shape
        Hk = k.shape[2]
        q = masked_flat_rms_norm(
            q.reshape(B, T, H * r), p["q_norm"]["scale"], rotary_mask, H, spec.head_dim,
            spec.group_size, spec.norm_eps, None if r_true is None else H * r_true,
        ).view(B, T, H, r)
        k = masked_flat_rms_norm(
            k.reshape(B, T, Hk * r), p["k_norm"]["scale"], rotary_mask, Hk, spec.head_dim,
            1, spec.norm_eps, None if r_true is None else Hk * r_true,
        ).view(B, T, Hk, r)
    return q, k


def _row_linear(x: torch.Tensor, p: Dict, tp) -> torch.Tensor:
    """A projection whose input is this rank's slice of features under
    tensor parallelism (row-parallel o and down): the partial product
    summed over the mesh's ``model`` axis, then the replicated bias added
    once. ``_linear`` itself when ``tp`` is None.

    W8A8 (``kernel_qa``) stays the unsharded product exactly, as GSPMD
    partitions it: the per-token activation scale comes from the maximum
    over every rank's features (one max all-reduce), each rank's int8
    codes against its rows give int32 partial sums, and those are summed
    over the axis in int32 (exact) before the float rescale."""
    if tp is None:
        return _linear(x, p)
    if "kernel_qa" in p:
        xf = x.to(torch.float32)
        amax = all_reduce(tp, torch.amax(torch.abs(xf), dim=-1, keepdim=True), "model", op="max")
        xs = torch.where(amax == 0.0, torch.ones_like(amax), true_div(amax, 127.0))
        xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
        kq = p["kernel_qa"]
        acc = _int_mm(xq.reshape(-1, x.shape[-1]), kq).reshape(*x.shape[:-1], kq.shape[-1])
        acc = all_reduce(tp, acc, "model")
        y = (acc.to(torch.float32) * xs * p["scale"].to(torch.float32)).to(x.dtype)
    else:
        y = all_reduce(tp, _linear(x, {k: v for k, v in p.items() if k != "bias"}), "model")
    return y + p["bias"] if "bias" in p else y


def _tp_of(spec: ModelSpec, q_width: int, head_dim: int, mesh, what: str):
    """The mesh a layer holding ``q_width`` columns of q (``head_dim`` a
    head) is tensor-parallel over, or None for a full layer. A layer short
    of the spec's heads needs the mesh whose model axis sharded it."""
    Hl = q_width // head_dim
    if Hl == spec.n_heads:
        return None
    if mesh is None or mesh.size("model") * Hl != spec.n_heads:
        raise ValueError(
            f"{what} holds {Hl} of {spec.n_heads} heads: a tensor-parallel layer needs the mesh whose "
            "model axis sharded it"
        )
    return mesh


def _tp_qk_norms(spec: ModelSpec, p: Dict, q: torch.Tensor, k: torch.Tensor, rotary_mask, tp, r_true=None):
    """`_qk_norms` on this rank's heads q [B, T, Hl, r], k [B, T, Hkl, r]
    under tensor parallelism (``tp`` the mesh, or None). The rotary mask
    and the q/k norm weights are replicated (the JAX layout); the rank
    takes its kv heads' mask rows (its q heads are kv-head-major, so they
    group with them). olmo2's whole-projection norm spans every head:
    the heads are gathered, normalised with the full mask and weights,
    and the rank keeps its own. Returns (q, k, the rank's mask rows)."""
    if tp is None:
        return (*_qk_norms(spec, p, q, k, rotary_mask, r_true), rotary_mask)
    Hl, Hkl, c = q.shape[2], k.shape[2], tp.coord("model")
    local = None if rotary_mask is None else rotary_mask[c * Hkl : (c + 1) * Hkl]
    if spec.flat_qk_norm:
        q, k = _qk_norms(spec, p, all_gather(tp, q, "model", 2), all_gather(tp, k, "model", 2), rotary_mask,
                         r_true)
        return q[:, :, c * Hl : (c + 1) * Hl], k[:, :, c * Hkl : (c + 1) * Hkl], local
    return (*_qk_norms(spec, p, q, k, local, r_true), local)


def _out_width(p: Dict) -> int:
    """A projection's output width (float or weight-only kernel)."""
    return (p["kernel"] if "kernel" in p else p["scale"]).shape[-1]


def _attn_output(spec: ModelSpec, p: Dict, residual: torch.Tensor, attn: torch.Tensor, tp=None) -> torch.Tensor:
    """The o projection and the residual add: gemma2's and olmo2's
    post-attention norm on the projection before the add, post-LN OPT's
    norm after it. ``tp``: the mesh when o is row-parallel."""
    a_out = _row_linear(attn, p["o"], tp)
    if spec.post_norms:
        a_out = _norm(a_out, p["post_attn_norm"], spec.norm, spec.norm_eps)
    x = residual + a_out
    if not spec.do_layer_norm_before:
        x = _norm(x, p["attn_norm"], spec.norm, spec.norm_eps)
    return x


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


def _route(spec: ModelSpec, p: Dict, x: torch.Tensor):
    """Router: float32 softmax over all experts, the top k (ties to the
    lower index: a stable descending sort, as ``lax.top_k``), renormalised
    when ``norm_topk_prob``. Returns (weights [..., k] float32, experts
    [..., k] int64)."""
    probs = torch.softmax(_linear(x, p["router"]).to(torch.float32), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[..., : spec.experts_per_tok], idx[..., : spec.experts_per_tok]
    if spec.norm_topk_prob:
        w = w / torch.sum(w, dim=-1, keepdim=True)
    return w, idx


def _expert_scale(s: torch.Tensor) -> torch.Tensor:
    """An expert stack's scale aligned to an [E, rows, out] product:
    [E, out] from the quantisers, or a flat [out] (older artifacts)."""
    return s[:, None, :] if s.dim() == 2 else s


def _expert_mm(xx: torch.Tensor, ep: Dict) -> torch.Tensor:
    """xx [N, d] (every token to every expert) or [E, C, d] (dispatch)
    against the expert stack ``ep`` [E, d, f] -> [E, N or C, f], for each
    form of the stack (JAX forward.py:222, :356). W8A8: the activation
    codes of [N, d] are shared by every expert, so the product is one
    int8 GEMM over the flattened (expert, column) axis; [E, C, d] takes
    one per expert (torch has no batched int8 product on the card)."""
    if "kernel" in ep:
        return torch.matmul(xx, ep["kernel"])
    if "kernel_q" in ep:
        out = torch.matmul(xx, _dequant(ep, xx.dtype))
        return out * _expert_scale(ep["scale"]).to(xx.dtype)
    kq = ep["kernel_qa"]
    E, d, f = kq.shape
    xq, xs = _act_quant(xx)
    if xx.dim() == 2:  # [d, E * f], column-major (a view of column-major codes)
        kcat = kq.transpose(1, 2).reshape(E * f, d).t()
        acc = _int_mm(xq, kcat).reshape(-1, E, f).transpose(0, 1)
        xs = xs[None]
    else:
        acc = torch.stack([_int_mm(xq[e], kq[e]) for e in range(E)])
    return (acc.to(torch.float32) * xs * _expert_scale(ep["scale"]).to(torch.float32)).to(xx.dtype)


def _expert_down_sum(h: torch.Tensor, ep: Dict, w_full: torch.Tensor) -> torch.Tensor:
    """sum_e w_full[:, e] * (h[e] @ down[e]) for h [E, N, D] and the
    down stack ``ep`` [E, D, d] -> [N, d], without an [E, N, d] tensor.
    Float and weight-only stacks fold the sum into one product over the
    flattened (expert, column) axis, a weight-only stack dequantised once
    per call (its per-(expert, out-channel) scale sits on the output
    axis, so it cannot follow the sum). W8A8 scales each activation row
    per (token, expert), so the exact int32 products are taken expert by
    expert."""
    E, N, D = h.shape
    if "kernel_qa" in ep:
        hq, hs = _act_quant(h)
        kq, s = ep["kernel_qa"], ep["scale"].to(torch.float32)
        y = None
        for e in range(E):
            ye = (_int_mm(hq[e], kq[e]).to(torch.float32) * hs[e] * (s[e] if s.dim() == 2 else s)).to(h.dtype)
            ye = ye * w_full[:, e : e + 1]
            y = ye if y is None else y + ye
        return y
    if "kernel_q" in ep:
        kd = _dequant(ep, h.dtype, row_major=True).mul_(_expert_scale(ep["scale"]).to(h.dtype))
    else:
        kd = ep["kernel"]
    hw = (h * w_full.T[..., None]).transpose(0, 1).reshape(N, E * D)
    return hw @ kd.reshape(E * D, -1)


def _expert_range(spec: ModelSpec, p: Dict, tp) -> Tuple[int, int]:
    """(first expert, number of experts) of the stack this rank holds:
    (0, E) for a whole stack; under expert parallelism (`parallel.mesh`)
    its coordinate's E/n experts."""
    ep = p["experts"]["gate"]
    El = next(v for k, v in ep.items() if k.startswith("kernel")).shape[0]
    if El == spec.n_experts:
        return 0, El
    if tp is None or tp.size("model") * El != spec.n_experts:
        raise ValueError(f"an expert stack of {El} of {spec.n_experts} experts needs the mesh whose model axis "
                         "sharded it")
    return tp.coord("model") * El, El


def _moe_mlp(spec: ModelSpec, p: Dict, x: torch.Tensor, collect: bool, tp=None):
    """Sparse-MoE MLP with every expert on every token (HF semantics,
    modeling_mixtral.MixtralSparseMoeBlock; JAX forward.py:186): the
    non-selected experts' outputs are weighted by zero.

    The gate and up products are one batched product each, the tokens
    broadcast over the expert stack ([E, N, D], no copy of the kernels);
    the weighted sum over experts is one product of ``h * w``, laid out
    over the flattened (expert, column) axis, with the stacked down
    kernels, so no ``[B, T, E, d]`` tensor is formed.

    Returns (y, h_routed, h_shared): h_routed [B, T, E, D] is the expert
    intermediate masked 0/1 to the tokens routed to each expert (not
    scaled by the routing weight), the rows each expert's down projection
    sees, and h_shared [B, T, Ds] the shared expert's intermediate; both
    None unless ``collect`` (h_shared also None without a shared expert).

    Under expert parallelism (``tp`` the mesh; `_expert_range`) the
    router runs whole on every rank, the rank's experts give their part
    of the routed-weighted sum, and one all-reduce over ``model`` adds
    the parts; the shared expert is column/row split (`_shared_expert`).
    h_routed and h_shared are then gathered over the axis.

    The routed part (router, expert products, weighted sum, routed mask)
    runs inside the span ``modegpt.moe.experts``; ``_moe_mlp.calls`` and
    ``_moe_mlp.tokens`` count the calls and the tokens they took.
    """
    B, T, d = x.shape
    N, E = B * T, spec.n_experts
    _moe_mlp.calls += 1
    _moe_mlp.tokens += N
    e0, El = _expert_range(spec, p, tp)
    with span("modegpt.moe.experts"):
        x2 = x.reshape(N, d)
        w, idx = _route(spec, p, x2)
        ek = p["experts"]
        h = _act(_expert_mm(x2, ek["gate"]), spec.act)
        h = h.mul_(_expert_mm(x2, ek["up"]))  # [El, N, D]
        D = h.shape[-1]
        w_full = torch.zeros((N, E), dtype=torch.float32, device=x.device).scatter_(-1, idx, w)
        y = _expert_down_sum(h, ek["down"], w_full[:, e0 : e0 + El].to(x.dtype)).view(B, T, d)
        if El < E:
            y = all_reduce(tp, y, "model")
        h_routed = h_shared = None
        if collect:
            routed = torch.zeros((N, E), dtype=h.dtype, device=x.device).scatter_(-1, idx, 1.0)[:, e0 : e0 + El]
            h_routed = h.mul_(routed.T[..., None]).transpose(0, 1).reshape(B, T, El, D)
            if El < E:
                h_routed = all_gather(tp, h_routed, "model", dim=2)
        del h
    if "shared" in p:
        ys, hs = _shared_expert(spec, p, x, tp)
        y = y + ys
        if collect:
            h_shared = hs if tp is None else all_gather(tp, hs, "model", dim=-1)
    return y, h_routed, h_shared


_moe_mlp.calls = 0
_moe_mlp.tokens = 0


def _shared_expert(spec: ModelSpec, p: Dict, x: torch.Tensor, tp=None):
    """qwen2_moe's shared expert: a dense gated MLP over all tokens,
    scaled by a per-token sigmoid gate computed in float32 when the layer
    has one (HF Qwen2MoeSparseMoeBlock.forward). Returns (y, h). Under
    tensor parallelism (``tp``) gate/up are this rank's columns and down
    its rows (`_row_linear`), h the rank's slice."""
    sp = p["shared"]
    hs = _act(_linear(x, sp["gate"]), spec.act) * _linear(x, sp["up"])
    ys = _row_linear(hs, sp["down"], tp)
    if "shared_gate" in p:
        gate = torch.sigmoid(_linear(x, p["shared_gate"]).to(torch.float32))
        ys = ys * gate.to(ys.dtype)
    return ys, hs


def _moe_gram(h_routed: torch.Tensor) -> torch.Tensor:
    """[B, T, E, D] routed intermediates -> per-expert Gram [E, D, D], at
    "highest" always: the JAX layer calls it without gram_precision."""
    return _gram_of(h_routed, None, "btef,bteg->efg", "highest")


def _moe_mlp_dispatch(
    spec: ModelSpec,
    p: Dict,
    x: torch.Tensor,
    capacity_factor: float,
    token_valid: Optional[torch.Tensor] = None,
    tp=None,
) -> torch.Tensor:
    """Capacity-based token dispatch (JAX forward.py:283): the (token,
    expert) assignments sorted by expert, each expert given
    C = ceil(capacity_factor * N * k / E) slots (at most N), its tokens
    gathered into an [E, C, d] buffer, one batched product per projection,
    and the weighted results summed back per token. Assignments past an
    expert's capacity are dropped, earlier tokens first served; at
    capacity_factor >= E/k nothing is dropped and the result is
    `_moe_mlp`'s up to float reassociation.

    token_valid [B, T] (optional): False tokens (masked serving rows,
    padded prefill tails) go to a virtual expert E that holds no capacity,
    so they never take a real token's slot. Where JAX drops the
    out-of-range scatters of the virtual expert and of the overflow, the
    port clamps those indices into range and adds zeros there (an
    out-of-range index on a CUDA tensor is a device-side assert); kept
    assignments have unique (expert, slot) pairs.

    Under expert parallelism (``tp``, `_expert_range`) every rank routes
    and sorts every token (the capacity is the global one, so the same
    assignments are dropped), fills and runs only its experts' buffers,
    and one all-reduce over ``model`` adds the ranks' sums.

    Everything but the shared expert runs inside the span
    ``modegpt.moe.experts``.
    """
    B, T, d = x.shape
    N, E, k = B * T, spec.n_experts, spec.experts_per_tok
    e0, El = _expert_range(spec, p, tp)
    with span("modegpt.moe.experts"):
        C = max(1, min(N, int(math.ceil(capacity_factor * N * k / E))))
        dev = x.device
        xf = x.reshape(N, d)
        w, idx = _route(spec, p, xf)  # [N, k]
        expert_of = idx.reshape(-1)
        if token_valid is not None:
            tv = token_valid.reshape(-1).to(dev).repeat_interleave(k)
            expert_of = torch.where(tv, expert_of, torch.full_like(expert_of, E))
        token_of = torch.arange(N, device=dev).repeat_interleave(k)

        # stable sort by expert: earlier tokens win the capacity slots
        order = torch.argsort(expert_of, stable=True)
        sorted_e = expert_of[order]
        counts = torch.bincount(expert_of, minlength=E + 1)
        starts = torch.cumsum(counts, 0) - counts
        slot = torch.arange(N * k, device=dev) - starts[sorted_e]
        keep = (slot < C) & (sorted_e >= e0) & (sorted_e < e0 + El)  # a real expert of this rank's
        e_ix, s_ix = (sorted_e - e0).clamp(0, El - 1), slot.clamp(max=C - 1)
        tok_sorted = token_of[order]

        buf = torch.zeros((El, C, d), dtype=x.dtype, device=dev)
        vals = torch.where(keep[:, None], xf[tok_sorted], torch.zeros((), dtype=x.dtype, device=dev))
        buf.index_put_((e_ix, s_ix), vals, accumulate=True)  # dropped ones add zeros

        ek = p["experts"]
        h = _act(_expert_mm(buf, ek["gate"]), spec.act) * _expert_mm(buf, ek["up"])
        y_e = _expert_mm(h, ek["down"])  # [E, C, d]

        # each assignment's weighted output back at its unsorted place, then
        # summed over the token's k assignments (no atomics)
        w_sorted = w.reshape(-1).to(x.dtype)[order]
        picked = torch.where(keep[:, None], y_e[e_ix, s_ix] * w_sorted[:, None],
                             torch.zeros((), dtype=x.dtype, device=dev))
        contrib = torch.empty_like(picked)
        contrib[order] = picked
        y = contrib.view(N, k, d).sum(dim=1).view(B, T, d)
        if El < E:
            y = all_reduce(tp, y, "model")
    if "shared" in p:
        y = y + _shared_expert(spec, p, x, tp)[0]
    return y


def _attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scaling: float,
    window: Optional[int],
    impl: str = "xla",
    softcap: Optional[float] = None,
    mesh=None,
    seq_axis: Optional[str] = None,
) -> torch.Tensor:
    """Causal (optionally sliding-window) attention; q [B,H,T,r],
    k/v [B,Hk,T,r_k]. impl="flash" takes the CUDA kernel K1 for
    ``128 <= T <= 8192`` and K2 beyond (the JAX rule, forward.py:454-462);
    "xla" (the JAX name of the plain path) takes the masked float32-softmax
    version, which runs over blocks of query rows at any T. ``softcap``
    (gemma2's cap on the scores, before the mask) takes the plain version
    whatever impl says, as the JAX forward does: neither kernel has a cap.

    Sequence-sharded inputs (this rank's chunk of T on ``seq_axis`` of
    ``mesh``): impl="ring" is `parallel.ring.ring_attention` (JAX
    forward.py:447-453); any other impl all-gathers q, k and v along T,
    attends over the full sequence (K1 needs it whole and square) and
    keeps this rank's rows, the gather GSPMD inserts for the JAX
    package's ``shard_sequence``."""
    if impl == "ring":
        from modegpt_tpu_torch.parallel.ring import ring_attention

        return ring_attention(q, k, v, scaling, mesh, softcap=softcap, window=window)
    if seq_axis is not None:
        C, c = q.shape[2], mesh.coord(seq_axis)
        full = [all_gather(mesh, t, seq_axis, dim=2) for t in (q, k, v)]
        return _attention(*full, scaling, window, impl, softcap)[:, :, c * C : (c + 1) * C]
    T = q.shape[2]
    if impl == "flash" and T >= FLASH_MIN_T and softcap is None:
        kernel = flash_attention_hbm if T > FLASH_MAX_T else flash_attention
        return kernel(q.contiguous(), k.contiguous(), v.contiguous(), scale=scaling, window=window)
    return flash_attention_reference(q, k, v, scale=scaling, window=window, softcap=softcap)


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
    mesh=None,
    seq_axis: Optional[str] = None,
):
    """One decoder layer. Returns (x_out, taps or None).

    Tensor parallelism (`parallel.mesh.param_shardings`): the local head
    counts come from the sharded q/k kernels' widths; when they are
    short of the spec's, the layer runs its heads (with its kv heads'
    rows of the rotary mask) and its d_int slice or experts, and sums
    the row-parallel o and down products over ``mesh``'s ``model`` axis
    (one all-reduce each). Its taps are then: ``cov_x``
    replicated, ``cov_q``/``cov_k`` this rank's heads (the caller gathers
    them), ``cov_mlp`` the Gram of ``h`` all-gathered along its features.
    ``seq_axis``: x is this rank's chunk of the sequence on that axis
    (see `_attention`)."""
    B, T, _ = x.shape
    H, Hk = spec.n_heads, spec.n_kv_heads
    q_hd = spec.q_ranks[layer_idx] // H
    v_hd = spec.v_ranks[layer_idx] // Hk
    rotary_mask = p.get("rotary_mask")
    taps = {}
    Hl, Hkl = _out_width(p["q"]) // q_hd, _out_width(p["k"]) // q_hd
    tp = _tp_of(spec, _out_width(p["q"]), q_hd, mesh, f"layer {layer_idx}")
    if tp is not None and seq_axis is not None:
        raise ValueError(f"layer {layer_idx}: a tensor-parallel layer takes no sequence sharding")

    # ---- attention ----
    residual = x
    x_ln = _attn_input(spec, p, x)
    q = _linear(x_ln, p["q"]).reshape(B, T, Hl, q_hd)
    k = _linear(x_ln, p["k"]).reshape(B, T, Hkl, q_hd)
    v = _linear(x_ln, p["v"]).reshape(B, T, Hkl, v_hd)
    if collect:
        with span("modegpt.compress.taps"):
            taps["cov_x"] = _gram(x_ln.reshape(-1, spec.d_model), gram_precision)
            taps["cov_q"] = _head_gram(q, gram_precision)
            taps["cov_k"] = _head_gram(k, gram_precision)
    q, k, rotary_mask = _tp_qk_norms(spec, p, q, k, rotary_mask, tp)
    q = q.transpose(1, 2)  # [B, H, T, q_hd]
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    if spec.uses_rope:
        q, k = apply_rope(q, k, cos, sin, rotary_mask)

    window = None
    if spec.layer_types and spec.layer_types[layer_idx] == "sliding_attention":
        window = spec.sliding_window
    attn = _attention(
        q, k, v, _attn_scale(spec, q_hd), window, attn_impl, spec.attn_logit_softcap, mesh, seq_axis
    )
    attn = attn.transpose(1, 2).reshape(B, T, Hl * v_hd)
    x = _attn_output(spec, p, residual, attn, tp)

    x, h, h_shared = _mlp_block(spec, p, x, layer_idx, collect, tp=tp)
    if collect:
        with span("modegpt.compress.taps"):
            if spec.is_moe_layer(layer_idx):
                taps["cov_mlp"] = _moe_gram(h)  # "highest" whatever gram_precision says, as JAX
            else:
                taps["cov_mlp"] = _gram(h.reshape(-1, h.shape[-1]), gram_precision)
            if h_shared is not None:
                taps["cov_shared"] = _gram(h_shared.reshape(-1, h_shared.shape[-1]), gram_precision)
    return x, (taps if collect else None)


def _mlp_block(
    spec: ModelSpec,
    p: Dict,
    x: torch.Tensor,
    layer_idx: int,
    collect: bool = True,
    moe: str = "dense",
    moe_capacity: float = 2.0,
    token_valid: Optional[torch.Tensor] = None,
    tp=None,
):
    """A layer's MLP half with its residual: the pre-MLP norm (none for
    olmo2), gemma2's and olmo2's post-MLP norm on the down projection
    before the add, post-LN OPT's norm after it. A MoE layer runs every
    expert on every token (``moe="dense"``) or by capacity dispatch
    (``"dispatch"``, serving; see `_moe_mlp_dispatch`). Returns (x_out,
    h, h_shared): h the post-activation intermediate the calibration taps
    (on a MoE layer the routed [B, T, E, D] intermediate, None unless
    ``collect`` and never under dispatch), h_shared the shared expert's
    (or None). ``tp``: the mesh when up/gate are column- and down
    row-parallel (a MoE layer's experts split by whole experts); h is then
    gathered along its features (its experts) when ``collect``."""
    pre_ln = spec.do_layer_norm_before
    residual = x
    x_ln2 = _norm(x, p["mlp_norm"], spec.norm, spec.norm_eps) if (pre_ln and spec.pre_norms) else x
    h = h_shared = None
    if spec.is_moe_layer(layer_idx) and moe == "dispatch":
        y = _moe_mlp_dispatch(spec, p, x_ln2, moe_capacity, token_valid, tp)
    elif spec.is_moe_layer(layer_idx):
        y, h, h_shared = _moe_mlp(spec, p, x_ln2, collect, tp)
    else:
        if spec.gated_mlp:
            h = _act(_linear(x_ln2, p["gate"]), spec.act) * _linear(x_ln2, p["up"])
        else:
            h = _act(_linear(x_ln2, p["up"]), spec.act)
        y = _row_linear(h, p["down"], tp)
        if spec.post_norms:
            y = _norm(y, p["post_mlp_norm"], spec.norm, spec.norm_eps)
        if tp is not None and collect:
            h = all_gather(tp, h, "model", dim=-1)
    x = residual + y
    if not pre_ln:
        x = _norm(x, p["mlp_norm"], spec.norm, spec.norm_eps)
    return x, h, h_shared


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
    mesh=None,
):
    """Run the model. Returns (logits | None, CalibStats | None).

    Args:
      spec: architecture (dense or compressed ranks).
      params: parameter tree (kernels in [in, out] layout), on one device.
      input_ids: [B, T] integer tokens on that device.
      stats_layers: layers whose Gram taps are collected; BI accumulators
        cover every layer whenever this is non-empty. The taps are
        stacked over these layers, so they must share shapes (one kind
        of a mixed dense/MoE stack; `calibrate` takes per-layer taps).
      attn_impl: "auto" (the CUDA kernel on the card, the plain version
        elsewhere), "flash" or "xla" (plain).
      want_logits: False skips the final norm and LM head (the JAX
        calibration path's dead-code-eliminated logits); logits is None.
      mesh: the `parallel.mesh.Mesh` whose ``model`` axis sharded
        ``params`` (`parallel.mesh.param_shardings`); ignored for a full
        tree. The taps are then as `_layer` describes.
    """
    logits, taps_by_layer, bi = forward_taps(
        spec, params, input_ids, stats_layers, attn_impl, gram_precision, want_logits, mesh
    )
    stats = None
    if stats_layers:
        has_shared = all("cov_shared" in taps_by_layer[l] for l in stats_layers)
        stats = CalibStats(
            cov_mlp=torch.stack([taps_by_layer[l]["cov_mlp"] for l in stats_layers]),
            cov_q=torch.stack([taps_by_layer[l]["cov_q"] for l in stats_layers]),
            cov_k=torch.stack([taps_by_layer[l]["cov_k"] for l in stats_layers]),
            cov_x=torch.stack([taps_by_layer[l]["cov_x"] for l in stats_layers]),
            bi_acc=bi,
            cov_shared=torch.stack([taps_by_layer[l]["cov_shared"] for l in stats_layers])
            if has_shared
            else None,
        )
    return logits, stats


@torch.no_grad()
def forward_taps(
    spec: ModelSpec,
    params: Dict,
    input_ids: torch.Tensor,
    stats_layers: Tuple[int, ...] = (),
    attn_impl: str = "auto",
    gram_precision: str = "highest",
    want_logits: bool = True,
    mesh=None,
    seq_axis: Optional[str] = None,
) -> Tuple[Optional[torch.Tensor], Dict[int, Dict[str, torch.Tensor]], Optional[torch.Tensor]]:
    """`forward` with the taps left per layer: (logits | None,
    {layer: {"cov_mlp", "cov_q", "cov_k", "cov_x"[, "cov_shared"]}},
    bi_acc [n_layers] | None). A mixed dense/MoE stack taps every layer
    in one pass this way. ``seq_axis``: ``input_ids`` is this rank's
    chunk of the sequence on that axis of ``mesh`` (the positions, RoPE
    and learned, are the chunk's global ones; attention per `_attention`,
    ``attn_impl="ring"`` for the ring); every tap and BI piece is then
    this chunk's share, for the caller to sum."""
    check_supported(spec)
    B, T = input_ids.shape
    ids = input_ids.long()
    start = mesh.coord(seq_axis) * T if seq_axis is not None else 0
    positions = torch.arange(start, start + T, device=ids.device, dtype=torch.int32)
    x = _embed(spec, params, ids, positions)

    cos = sin = None
    if spec.uses_rope:
        cos, sin = rope_cos_sin(positions, spec.head_dim, spec.rope_theta, dtype=x.dtype, scaling=spec.rope_scaling)

    if attn_impl == "auto":
        attn_impl = "flash" if x.is_cuda else "xla"

    collect = len(stats_layers) > 0
    taps_by_layer: Dict[int, Dict[str, torch.Tensor]] = {}
    bi: List[torch.Tensor] = []
    for l in range(spec.n_layers):
        h_in = x
        x, taps = _layer(
            spec, l, params["layers"][l], x, cos, sin,
            collect and (l in stats_layers), attn_impl, gram_precision, mesh, seq_axis,
        )
        if collect:
            bi.append(_bi_piece(h_in, x))
        if taps is not None:
            taps_by_layer[l] = taps

    logits = _unembed(spec, params, x) if want_logits else None
    return logits, taps_by_layer, (torch.stack(bi) if collect else None)
