"""Padded-uniform execution for heterogeneous-rank compressed models.

Port of ``modegpt_tpu.models.padded`` for every architecture the spec
parses, dense or compressed. Every layer's
factors are zero-padded to the stack-wide max rank per module and
stacked into ``[L, ...]`` leaves, so every layer has the same shapes; the
layer scan is a Python loop over ``l`` that reads ``layers[...][l]``
views. Expert stacks pad their intermediate axis to the largest gate
rank, shared experts to the largest shared rank. A mixed dense/MoE stack
carries both MLP kinds on every layer, the other kind's kernels zero
(as the JAX stack does), and each layer runs its own kind.

Exactness (equal to the unrolled forward up to float reassociation):

* Zero-padded projection columns give zero q/k/v coordinates, which add
  nothing to scores or outputs; zero-padded o/down rows consume them.
  Biases are zero at pad positions.
* For RoPE architectures q/k pads use a half-split layout per head,
  ``[first-half | 0.. | second-half | 0..]``, so ``rotate_half`` still
  pairs true coordinates with true coordinates.
* The attention scale uses each layer's TRUE head dim (``q_hd_true``),
  or gemma2's fixed ``query_pre_attn_scalar``, multiplied into q in q's
  dtype.
* Qwen3's per-head q/k RMSNorm divides by the true rank
  (`ops.rope.masked_head_rms_norm` with ``r_true``), olmo2's
  whole-projection norm by the true width ``H * r_true``
  (`ops.rope.masked_flat_rms_norm` with ``true_dim``).
* Each layer keeps its own window (gemma2 alternates sliding and full
  layers); gemma2's soft caps apply to the scores, in the plain
  attention and in K3, and to the final logits.

`_model_step_padded` runs new tokens through the stack against a stacked
KV cache ``[L, B, Hk, max_len, R]`` that it updates in place (the torch
form of the JAX carries and donation: only the new positions are
written, the pool is never copied). Each row sits at its own offset; a
write at or past ``max_len`` is dropped, as JAX's ``mode="drop"`` scatter
drops it. The offsets are host integers: the drop mask is decided on the
host, and only the surviving (row, position) pairs are written, because
an out-of-range index on a CUDA tensor is a device-side assert and a
clamped write would overwrite a live position. `step_indices` builds
those indices for one dispatch or several and uploads them in one copy
from pinned memory, so a run of dispatches whose offsets the host knows
ahead (fused decode, draft steps) issues without a host wait between
them.

A decode dispatch over a whole slot table (one new token a row) is
~30 launches a layer, which the host issues far slower than the card runs
them. Where its shapes and buffers are fixed (`_replayable`: one process,
K3, no dispatch-MoE capacity, every row inside the pool) it is captured
once as a CUDA graph (`DecodeGraph`, held with the pools) and replayed:
one launch, the same kernels on the same buffers, its offsets filled
from the host in one copy. Every other dispatch runs op by op.

A quantised stack is quantised AFTER padding
(`models.quantize.quantize_padded`), as in the JAX package. Zero pads
change no column's max-abs, so ``quantize_padded(pad_to_uniform(p))``
equals ``pad_to_uniform(p)`` with ``quantize_params(p)``'s codes laid
into its true positions (the pads zero codes, the pad columns' scale 1);
each per-layer view ``layers[...][l]`` hands `forward._linear` layer l's
own [out] (experts: [E, out]) scale. A quantised tree is padded through
this order only: `pad_to_uniform` reads float kernels.

`prefill_padded` and `generate_padded` are plain generation over the
padded stack (the JAX functions of the same names; no JAX module calls
them): a prompt prefill, then one-token steps on the plain cache
attention.

MoE layers run every expert on every token (``moe="dense"``) or by
capacity-based token dispatch (``moe="dispatch"``, with ``token_valid``
marking the rows whose tokens may claim expert capacity).

Tensor parallelism (`parallel.mesh.shard_serving`): each rank holds its
heads' columns of q/k/v, rows of o, its slice of the MLP or its whole
experts, and its kv heads of the pools; `_layer_padded` runs the rank's
heads (K3 on them, no collective) and reduces o and down over the
``model`` axis, so the residual stream and the logits are whole on every
rank.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from modegpt_tpu_torch.kernels.ragged_decode import ragged_gqa_attend, ragged_gqa_attend_reference
from modegpt_tpu_torch.models.forward import (
    _attention,
    _attn_input,
    _attn_output,
    _embed,
    _linear,
    _mlp_block,
    _out_width,
    _tp_of,
    _tp_qk_norms,
    _unembed,
    check_supported,
)
from modegpt_tpu_torch.models.spec import ModelSpec
from modegpt_tpu_torch.ops.rope import apply_rope, apply_rope_ragged, rope_cos_sin
from modegpt_tpu_torch.utils.profiling import span

__all__ = [
    "PaddedModel",
    "DecodeGraph",
    "pad_to_uniform",
    "padding_overhead",
    "forward_padded",
    "init_cache_padded",
    "prefill_padded",
    "generate_padded",
]

Length = Union[int, Sequence[int], np.ndarray]


class PaddedModel(NamedTuple):
    """Uniform-shape stacked model: `spec` has the PADDED ranks; `layers`
    holds [L, ...] stacked leaves; `q_hd_true` [L] float32 the true
    per-head q/k dim of each layer (everything else is exact through
    zeros). `mesh`: the `parallel.mesh.Mesh` whose ``model`` axis
    sharded the stack (`parallel.mesh.shard_serving`), else None."""

    spec: ModelSpec
    layers: Dict
    other: Dict
    q_hd_true: torch.Tensor
    mesh: object = None


def _pad_head_axis(x: torch.Tensor, n_heads: int, r_true: int, R: int, rope: bool, axis: int):
    """Pad a head-major axis of size n_heads*r_true to n_heads*R with
    zeros; `rope=True` uses the half-split layout."""
    if r_true == R:
        return x
    x = torch.movedim(x, axis, -1)
    shape = x.shape[:-1]
    xh = x.reshape(*shape, n_heads, r_true)
    out = x.new_zeros((*shape, n_heads, R))
    if rope:
        h, Rh = r_true // 2, R // 2
        out[..., :h] = xh[..., :h]
        out[..., Rh : Rh + h] = xh[..., h:]
    else:
        out[..., :r_true] = xh
    return torch.movedim(out.reshape(*shape, n_heads * R), -1, axis)


def _pad_tail(x: torch.Tensor, true: int, target: int, axis: int):
    if true == target:
        return x
    shape = list(x.shape)
    shape[axis] = target
    out = x.new_zeros(shape)
    out.narrow(axis, 0, true).copy_(x)
    return out


def _pad_linear(p: Dict, pad_in=None, pad_out=None) -> Dict:
    """pad_in/pad_out: None or a function of (tensor, axis)."""
    out = dict(p)
    k = p["kernel"]
    if pad_in is not None:
        k = pad_in(k, 0)
    if pad_out is not None:
        k = pad_out(k, 1)
    out["kernel"] = k
    if "bias" in p and pad_out is not None:
        out["bias"] = pad_out(p["bias"], 0)
    return out


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def pad_to_uniform(spec: ModelSpec, params: Dict) -> PaddedModel:
    """Zero-pad every layer to the stack-wide max rank per module and
    stack the layer params into [L, ...] leaves, on the params' device."""
    check_supported(spec)
    if any("kernel" not in lp["q"] for lp in params["layers"]):
        raise ValueError("pad_to_uniform pads float kernels: pad first, then quantise "
                         "(models.quantize.quantize_padded)")
    H, Hk, L = spec.n_heads, spec.n_kv_heads, spec.n_layers
    rope = spec.uses_rope
    device = params["embed_tokens"].device
    Rq = max(spec.q_ranks[l] // H for l in range(L))
    Rv = max(spec.v_ranks[l] // Hk for l in range(L))
    d, E = spec.d_model, spec.n_experts
    moe_ls = [l for l in range(L) if spec.is_moe_layer(l)]
    dense_ls = [l for l in range(L) if not spec.is_moe_layer(l)]
    # the widest gate rank of each MLP kind, and of the shared experts
    Rg_moe = max((spec.gate_ranks[l] for l in moe_ls), default=0)
    Rg_dense = max((spec.gate_ranks[l] for l in dense_ls), default=0)
    Rs = max((spec.shared_rank(l) for l in moe_ls), default=0) if spec.shared_d_int else 0
    pdtype = params["embed_tokens"].dtype

    def zeros(*shape):  # the other MLP kind's kernels on a mixed stack's layer
        return torch.zeros(shape, dtype=pdtype, device=device)

    # every layer needs the same leaves to stack: if any layer carries a
    # rotary mask (or a RoPE layer's q/k need padding), all get one
    need_masks = spec.has_rotary_masks or (rope and any(spec.q_ranks[l] // H != Rq for l in range(L)))

    padded_layers = []
    for l in range(L):
        p = params["layers"][l]
        rq = spec.q_ranks[l] // H
        rv = spec.v_ranks[l] // Hk
        rg = spec.gate_ranks[l]
        q = {k_: p[k_] for k_ in ("attn_norm", "mlp_norm", "post_attn_norm", "post_mlp_norm") if k_ in p}
        q["q"] = _pad_linear(p["q"], pad_out=lambda x, ax: _pad_head_axis(x, H, rq, Rq, rope, ax))
        q["k"] = _pad_linear(p["k"], pad_out=lambda x, ax: _pad_head_axis(x, Hk, rq, Rq, rope, ax))
        q["v"] = _pad_linear(p["v"], pad_out=lambda x, ax: _pad_head_axis(x, Hk, rv, Rv, False, ax))
        q["o"] = _pad_linear(p["o"], pad_in=lambda x, ax: _pad_head_axis(x, H, rv, Rv, False, ax))
        if spec.is_moe_layer(l):
            ek = p["experts"]
            q["router"] = p["router"]
            q["experts"] = {
                "gate": {"kernel": _pad_tail(ek["gate"]["kernel"], rg, Rg_moe, 2)},
                "up": {"kernel": _pad_tail(ek["up"]["kernel"], rg, Rg_moe, 2)},
                "down": {"kernel": _pad_tail(ek["down"]["kernel"], rg, Rg_moe, 1)},
            }
            if spec.shared_d_int:
                rs = spec.shared_rank(l)
                s_pad = lambda x, ax: _pad_tail(x, rs, Rs, ax)  # noqa: E731
                sp = p["shared"]
                q["shared"] = {
                    "gate": _pad_linear(sp["gate"], pad_out=s_pad),
                    "up": _pad_linear(sp["up"], pad_out=s_pad),
                    "down": _pad_linear(sp["down"], pad_in=s_pad),
                }
                if "shared_gate" in p:
                    q["shared_gate"] = p["shared_gate"]
            if dense_ls:  # mixed stack: the dense kind's zero kernels
                q["up"] = {"kernel": zeros(d, Rg_dense)}
                q["down"] = {"kernel": zeros(Rg_dense, d)}
                if spec.gated_mlp:
                    q["gate"] = {"kernel": zeros(d, Rg_dense)}
        else:
            g_pad = lambda x, ax: _pad_tail(x, rg, Rg_dense, ax)  # noqa: E731
            q["up"] = _pad_linear(p["up"], pad_out=g_pad)
            q["down"] = _pad_linear(p["down"], pad_in=g_pad)
            if spec.gated_mlp:
                q["gate"] = _pad_linear(p["gate"], pad_out=g_pad)
            if moe_ls:  # mixed stack: the MoE kind's zero kernels
                q["router"] = {"kernel": zeros(d, E)}
                q["experts"] = {
                    "gate": {"kernel": zeros(E, d, Rg_moe)},
                    "up": {"kernel": zeros(E, d, Rg_moe)},
                    "down": {"kernel": zeros(E, Rg_moe, d)},
                }
                if spec.shared_d_int:
                    q["shared"] = {
                        "gate": {"kernel": zeros(d, Rs)},
                        "up": {"kernel": zeros(d, Rs)},
                        "down": {"kernel": zeros(Rs, d)},
                    }
                    if spec.shared_expert_gate:
                        q["shared_gate"] = {"kernel": zeros(d, 1)}
        if spec.qk_norm or spec.flat_qk_norm:  # weights at the original dims
            q["q_norm"] = p["q_norm"]
            q["k_norm"] = p["k_norm"]
        if "rotary_mask" in p:
            # pad positions keep index 0: the gathered cos/sin multiply a
            # zero coordinate. Each mask row is one kv head (n_heads=1).
            q["rotary_mask"] = _pad_head_axis(p["rotary_mask"], 1, rq, Rq, rope, 1)
        elif need_masks:
            # a layer without a mask inside a masked stack: the identity
            # frequency mask, padded in the same half-split layout
            half = rq // 2
            ar = torch.arange(half, dtype=torch.int32, device=device)
            ident = torch.cat([ar, ar + spec.head_dim // 2]).expand(Hk, rq)
            q["rotary_mask"] = _pad_head_axis(ident, 1, rq, Rq, rope, 1)
        padded_layers.append(q)

    stacked = _stack(padded_layers)
    other = {k: v for k, v in params.items() if k != "layers"}
    pspec = spec.with_ranks(
        q_ranks=(H * Rq,) * L,
        k_ranks=(Hk * Rq,) * L,
        v_ranks=(Hk * Rv,) * L,
        o_ranks=(H * Rv,) * L,
        gate_ranks=tuple(Rg_moe if spec.is_moe_layer(l) else Rg_dense for l in range(L)),
        shared_gate_ranks=(Rs,) * L if spec.shared_d_int else None,
    )
    q_hd_true = torch.tensor([spec.q_ranks[l] / H for l in range(L)], dtype=torch.float32, device=device)
    return PaddedModel(spec=pspec, layers=stacked, other=other, q_hd_true=q_hd_true)


def padding_overhead(spec: ModelSpec) -> float:
    """FLOP ratio padded/exact for the layer stack's matmuls (embeddings
    and attention quadratic terms excluded — a conservative upper bound)."""
    H, Hk, L, d = spec.n_heads, spec.n_kv_heads, spec.n_layers, spec.d_model
    Rq = max(spec.q_ranks) // H * H
    Rk = max(spec.q_ranks) // H * Hk
    Rv = max(spec.v_ranks) // Hk * Hk
    Ro = max(spec.v_ranks) // Hk * H
    Rg = max(spec.gate_ranks)
    n_g = 2 if spec.gated_mlp else 1
    n_e = max(1, spec.n_experts)
    padded = L * d * (Rq + Rk + Rv + Ro + n_e * (n_g + 1) * Rg)
    exact = sum(
        d * (spec.q_ranks[l] + spec.k_ranks[l] + spec.v_ranks[l] + spec.o_ranks[l]
             + n_e * (n_g + 1) * spec.gate_ranks[l])
        for l in range(L)
    )
    return padded / max(exact, 1)


def _layer_window(spec: ModelSpec, l: int) -> Optional[int]:
    """Layer l's sliding window, or None for full attention (a sliding
    layer type without a configured window attends fully)."""
    if spec.layer_types and spec.layer_types[l] == "sliding_attention":
        return spec.sliding_window or None
    return None


def _layer_params(layers: Dict, l: int) -> Dict:
    return {k: _layer_params(v, l) if isinstance(v, dict) else v[l] for k, v in layers.items()}


def _quantize(x: torch.Tensor):
    """[B, Hk, S, R] -> int8 codes and float32 per-vector scales
    (symmetric, max-abs / 127, floored at 1e-8; round half to even)."""
    xf = x.to(torch.float32)
    scale = torch.clamp(torch.amax(torch.abs(xf), dim=-1) / 127.0, min=1e-8)
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return codes, scale


def _scatter(cache: torch.Tensor, new: torch.Tensor, ix) -> None:
    """Write new [B, Hk, S(, R)] into cache [B, Hk, T(, R)] in place at
    the surviving (row, position) pairs ix = (b, s, t)."""
    b, s, t = ix
    cache[b, :, t] = new[b, :, s].to(cache.dtype)


# attention over the cache pool: "ragged" is the CUDA kernel (its plain
# version on a CPU tensor), "xla" the plain version over the whole pool
_CACHE_ATTENTION = {"ragged": ragged_gqa_attend, "xla": ragged_gqa_attend_reference}


def _layer_padded(
    spec: ModelSpec,
    p: Dict,
    q_hd_true: torch.Tensor,
    x: torch.Tensor,
    cos,
    sin,
    attn_impl: str,
    window: Optional[int],
    cache: Optional[Tuple[torch.Tensor, ...]] = None,
    pos: Optional[torch.Tensor] = None,
    write_ix=None,
    layer: int = 0,
    moe: str = "dense",
    moe_capacity: float = 2.0,
    token_valid: Optional[torch.Tensor] = None,
    mesh=None,
) -> torch.Tensor:
    """One padded layer (``layer``: its index in the stack). Without a
    cache: full causal self-attention (attn_impl "flash" or "xla"). With
    ``cache`` = this layer's (ck, cv[, k_scale, v_scale]) views
    [B, Hk, T(, R)]: the new K/V are written in place at ``write_ix`` and
    the rows attend the pool from ``pos`` (attn_impl "ragged", the CUDA
    kernel on the card, or "xla", its plain version: the masked
    contraction over the whole pool). A MoE layer's experts run by ``moe``
    ("dense" or "dispatch" at ``moe_capacity``, where ``token_valid``
    [B, S] keeps masked rows from claiming expert capacity).

    Tensor parallelism (`parallel.mesh.shard_serving`; ``mesh`` the mesh
    that sharded the stack): the local head counts come from the sharded
    q/k widths, cut at the padded width R. The q heads are kv-head-major,
    so the rank's column shard of q groups with its kv heads and its
    shard of the pool ([B, Hk/n, T, R]): the attention (K3 on the card)
    runs on the rank's H/n heads with no collective, the JAX
    ``shard_map`` over ``model`` in SPMD form. o and down are reduced over
    the axis, a MoE layer's experts by expert parallelism."""
    B, S, _ = x.shape
    Rq = spec.q_ranks[0] // spec.n_heads
    Rv = spec.v_ranks[0] // spec.n_kv_heads
    tp = _tp_of(spec, _out_width(p["q"]), Rq, mesh, f"padded layer {layer}")
    H, Hk = _out_width(p["q"]) // Rq, _out_width(p["k"]) // Rq  # this rank's heads
    rotary_mask = p.get("rotary_mask")

    residual = x
    x_ln = _attn_input(spec, p, x)
    q = _linear(x_ln, p["q"]).reshape(B, S, H, Rq)
    k = _linear(x_ln, p["k"]).reshape(B, S, Hk, Rq)
    v = _linear(x_ln, p["v"]).reshape(B, S, Hk, Rv)
    q, k, rotary_mask = _tp_qk_norms(spec, p, q, k, rotary_mask, tp, q_hd_true)
    q = q.transpose(1, 2)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    if spec.query_pre_attn_scalar is not None:  # gemma2's fixed scale
        q_scale = torch.rsqrt(torch.tensor(spec.query_pre_attn_scalar, dtype=torch.float32)).to(q.dtype)
    else:
        q_scale = torch.rsqrt(q_hd_true).to(q.dtype)
    softcap = spec.attn_logit_softcap
    if cache is None:
        if spec.uses_rope:
            q, k = apply_rope(q, k, cos, sin, rotary_mask)
        attn = _attention(q * q_scale, k, v, 1.0, window, attn_impl, softcap)
    else:
        if spec.uses_rope:
            q, k = apply_rope_ragged(q, k, cos, sin, rotary_mask, spec.group_size)
        q = (q * q_scale).contiguous()
        if attn_impl not in _CACHE_ATTENTION:
            raise ValueError(f"decode attention must be xla or ragged, got {attn_impl!r}")
        if len(cache) == 4:  # int8 KV: codes + per-(row, head, position) scales
            ck, cv, ks, vs = cache
            k_codes, k_sc = _quantize(k)
            v_codes, v_sc = _quantize(v)
            for c, new in ((ck, k_codes), (cv, v_codes), (ks, k_sc), (vs, v_sc)):
                _scatter(c, new, write_ix)
            scales = (ks, vs)
        else:
            ck, cv = cache
            _scatter(ck, k, write_ix)
            _scatter(cv, v, write_ix)
            scales = (None, None)
        attn = _CACHE_ATTENTION[attn_impl](
            q, ck, cv, pos, k_scale=scales[0], v_scale=scales[1], window=window, softcap=softcap
        )
    attn = attn.transpose(1, 2).reshape(B, S, H * Rv)
    x = _attn_output(spec, p, residual, attn, tp)
    return _mlp_block(spec, p, x, layer, False, moe, moe_capacity, token_valid, tp)[0]


@torch.no_grad()
def forward_padded(
    spec: ModelSpec,
    layers: Dict,
    other: Dict,
    q_hd_true: torch.Tensor,
    input_ids: torch.Tensor,
    attn_impl: str = "auto",
    moe: str = "dense",
    moe_capacity: float = 2.0,
    mesh=None,
) -> torch.Tensor:
    """Full causal forward over the padded stack; returns logits. Same
    numerics as `forward(orig_spec, orig_params, ...)`. attn_impl "auto"
    takes the CUDA flash-attention kernels on the card (K1 for
    128 <= T <= 8192, K2 beyond) and the plain version elsewhere, through
    `forward`'s attention route. moe: "dense" or "dispatch" (MoE layers,
    see `_layer_padded`). ``mesh``: the mesh that sharded ``layers``
    (`parallel.mesh.shard_serving`), or None."""
    check_supported(spec)
    T = input_ids.shape[1]
    x = _embed(spec, other, input_ids)
    if attn_impl == "auto":
        attn_impl = "flash" if x.is_cuda else "xla"
    cos = sin = None
    if spec.uses_rope:
        cos, sin = rope_cos_sin(
            torch.arange(T, device=x.device, dtype=torch.int32), spec.head_dim, spec.rope_theta,
            dtype=x.dtype, scaling=spec.rope_scaling,
        )
    for l in range(spec.n_layers):
        x = _layer_padded(
            spec, _layer_params(layers, l), q_hd_true[l], x, cos, sin, attn_impl, _layer_window(spec, l),
            layer=l, moe=moe, moe_capacity=moe_capacity, mesh=mesh,
        )
    return _unembed(spec, other, x)


def init_cache_padded(pm: PaddedModel, batch: int, max_len: int, dtype=torch.float32):
    """Stacked KV cache [L, B, Hk, max_len, R] on the model's device;
    returns (k, v, length 0)."""
    spec = pm.spec
    Rq = spec.q_ranks[0] // spec.n_heads
    Rv = spec.v_ranks[0] // spec.n_kv_heads
    L, Hk = spec.n_layers, spec.n_kv_heads
    dev = pm.other["embed_tokens"].device
    k = torch.zeros((L, batch, Hk, max_len, Rq), dtype=dtype, device=dev)
    v = torch.zeros((L, batch, Hk, max_len, Rv), dtype=dtype, device=dev)
    return k, v, 0


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`: on a CUDA device through pinned memory
    without waiting (the stream orders it before the dispatch that reads
    it), so an upload never stalls the host behind queued work. The
    array is copied: the caller may reuse it."""
    t = torch.from_numpy(np.array(a))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class StepIndex(NamedTuple):
    """One dispatch's host-decided indices on the device: each row's
    offset ``pos`` [B] int32, the surviving cache writes ``write_ix`` =
    (row, new position, pool position) and the RoPE positions [B, S]."""

    pos: torch.Tensor
    write_ix: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    positions: torch.Tensor


class DecodeGraph:
    """The whole-table decode dispatch of one slot table as a CUDA graph,
    replayed in place of its op-by-op issue: the same kernels in the same
    order on the same buffers, so the same numbers. The pools' owner
    holds one (`serving.ServeState.graph`) and frees it with them.

    `_model_step_padded` captures it at the first dispatch that
    `_replayable` admits (one eager warm-up run on a side stream, whose
    result the dispatch returns, then the capture) and replays it at every
    later one. The graph reads fixed addresses: the tokens (the owner's
    ``last_token``, updated in place), the pools, the weights, and the
    index buffer ``ix`` [3, B] int64 (rows, zeros, each row's offset),
    from which the graph forms its `StepIndex`. A replay fills the
    offsets from the host's lengths in one pinned copy, and its logits
    land in one [B, 1, V] tensor, overwritten by the next replay. The
    graph is keyed on what it reads (the tensors' addresses, shapes and
    dtypes, the weights' and spec's identities, which it keeps alive); a
    dispatch with another key captures anew.

    Counters, plain integers over the process: ``captures``; ``replays``;
    ``eager``, the whole-table decode dispatches that ran op by op (those
    `_replayable` refused, and each capturing one). Each replay also adds
    the K3 launches recorded at capture to ``ragged_gqa_attend.launches``."""

    captures = 0
    replays = 0
    eager = 0

    def __init__(self):
        self._key = None
        self._held = None  # what the graph reads, kept alive with it
        self._graph = None
        self._ix: Optional[torch.Tensor] = None
        self._logits: Optional[torch.Tensor] = None
        self._k3 = 0

    def _buffers(self, B: int, device) -> None:
        self._ix = torch.zeros((3, B), dtype=torch.int64, device=device)
        self._ix[0] = torch.arange(B, device=device)

    def _fill(self, length: Length) -> None:
        """Each row's offset into the index buffer, in one copy (from
        pinned memory on a card, without waiting)."""
        B = self._ix.shape[1]
        host = torch.from_numpy(np.array(np.broadcast_to(np.asarray(length, dtype=np.int64).reshape(-1), (B,))))
        if self._ix.is_cuda:
            host = host.pin_memory()
        self._ix[2].copy_(host, non_blocking=True)

    def _index(self) -> StepIndex:
        """The dispatch's `StepIndex`, formed from the buffer: every row
        writes its one new position at its offset."""
        rows, zeros, t = self._ix
        return StepIndex(pos=t.to(torch.int32), write_ix=(rows, zeros, t), positions=t.view(-1, 1))

    def run(self, key: tuple, held: tuple, length: Length, stack) -> torch.Tensor:
        """The logits of ``stack`` (a function of the `StepIndex`) at the
        rows' host offsets ``length``: a replay, or a capture when ``key``
        is not the graph's."""
        if key != self._key:
            return self._capture(key, held, length, stack)
        self._fill(length)
        self._graph.replay()
        ragged_gqa_attend.launches += self._k3
        DecodeGraph.replays += 1
        return self._logits

    def _capture(self, key: tuple, held: tuple, length: Length, stack) -> torch.Tensor:
        self._key = self._held = self._graph = self._logits = None  # the old graph goes first
        dev = held[0].device
        self._buffers(held[0].shape[0], dev)
        self._fill(length)
        cur, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):  # the warm-up `torch.cuda.graph` asks for, on the capture stream
            logits = stack(self._index())
        cur.wait_stream(side)
        logits.record_stream(cur)
        graph, n0 = torch.cuda.CUDAGraph(), ragged_gqa_attend.launches
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            out = stack(self._index())
        self._k3, ragged_gqa_attend.launches = ragged_gqa_attend.launches - n0, n0  # recorded, not run
        self._key, self._held, self._graph, self._logits = key, held, graph, out
        DecodeGraph.captures += 1
        DecodeGraph.eager += 1
        return logits


def _replayable(tokens: torch.Tensor, pools: Sequence[torch.Tensor], length: Length, decode_attn: str,
                logits_at, moe: str, token_valid: Optional[torch.Tensor], index: Optional[StepIndex],
                mesh) -> bool:
    """Whether a dispatch over a whole slot table may replay its
    `DecodeGraph`: a decode (one new token a row, every position's
    logits), on one process (no mesh), through K3, with no dispatch-MoE
    expert capacity (its counts come back to the host), an index the
    dispatch builds itself (a caller that uploaded a run of dispatches'
    indices ahead issues them op by op) and every row's offset inside the
    pool (a write at the pool's end is dropped on the host, which a fixed
    index cannot do). The caller checks that the tensors are on a card."""
    return (
        tokens.shape[1] == 1 and logits_at is None and mesh is None and decode_attn == "ragged"
        and moe != "dispatch" and token_valid is None and index is None and int(np.max(length)) < pools[0].shape[3]
    )


def step_indices(lengths: Sequence[Length], B: int, S: int, T: int, device) -> list:
    """The `StepIndex` of each of ``len(lengths)`` dispatches of S new
    tokens over a pool of T positions, each at its rows' offsets (a host
    int or B ints), uploaded in one copy. Writes at or past T are dropped
    here, on the host (the module docstring says why)."""
    parts, sizes = [], []
    for length in lengths:
        pos_host = np.broadcast_to(np.asarray(length, dtype=np.int64).reshape(-1), (B,))
        t_host = pos_host[:, None] + np.arange(S)[None, :]
        b_ok, s_ok = np.nonzero(t_host < T)
        arrs = (pos_host, b_ok, s_ok, t_host[b_ok, s_ok], t_host.reshape(-1))
        parts += arrs
        sizes += [a.shape[0] for a in arrs]
    flat = upload(np.concatenate(parts).astype(np.int64), device)
    views = torch.split(flat, sizes)
    return [
        StepIndex(pos=v[0].to(torch.int32), write_ix=(v[1], v[2], v[3]), positions=v[4].view(B, S))
        for v in (views[i : i + 5] for i in range(0, len(views), 5))
    ]


@torch.no_grad()
def _model_step_padded(
    spec: ModelSpec,
    layers: Dict,
    other: Dict,
    q_hd_true: torch.Tensor,
    tokens: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    length: Length,
    cache_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    decode_attn: str = "xla",
    logits_at=None,
    moe: str = "dense",
    moe_capacity: float = 2.0,
    token_valid: Optional[torch.Tensor] = None,
    index: Optional[StepIndex] = None,
    mesh=None,
    graph: Optional[DecodeGraph] = None,
):
    """New tokens [B, S] through the padded stack with a stacked cache.

    cache_k/cache_v: [L, B, Hk, max_len, R] (int8 codes with
    ``cache_scales`` = (k_scale, v_scale), each [L, B, Hk, max_len]),
    updated in place; a per-row slice of a larger pool (``pool[:, s:s+1]``)
    works too. ``length``: each row's current length, a host int (every
    row) or a host sequence of B ints. ``index``: the dispatch's
    `StepIndex`, when the caller built it ahead (`step_indices`, one
    upload for several dispatches); else it is built from ``length``.
    decode_attn: "xla" (masked
    contraction over the whole pool) or "ragged" (the CUDA kernel, whose
    reads cover each row's live keys only). ``logits_at``: None for every
    position's logits, one position s whose logits alone are computed
    (a prefill chunk needs its last real position only), or a [B] int64
    tensor on the device with one position per row. moe,
    moe_capacity: MoE execution (`_layer_padded`); token_valid [B, S]
    bool: the rows and positions whose tokens may claim dispatch-MoE
    expert capacity (masked slots and padded chunk tails may not).
    ``mesh``: the mesh that sharded the stack and the pools
    (`parallel.mesh.shard_serving`; ``pm.mesh``), or None. Every rank of
    its ``model`` axis runs the step on its heads with the same tokens
    and lengths; the logits come out whole on every rank.

    ``graph``: the pools' `DecodeGraph`, given when the pools are a whole
    slot table. A decode dispatch over it (S = 1, every position's
    logits) replays the graph where `_replayable` admits it and the
    tensors are on a card, and runs op by op otherwise; the returned
    logits are then the graph's, overwritten by its next replay. Every
    other dispatch runs op by op.

    Returns (logits [B, S or 1, V], length + S as a host value)."""
    with span("modegpt.model.step"):
        check_supported(spec)
        B, S = tokens.shape
        dev = tokens.device
        pools = (cache_k, cache_v) + (tuple(cache_scales) if cache_scales is not None else ())

        def stack(index: StepIndex) -> torch.Tensor:
            x = _embed(spec, other, tokens, index.positions)
            cos = sin = None
            if spec.uses_rope:
                cos, sin = rope_cos_sin(index.positions.reshape(-1).to(torch.int32), spec.head_dim,
                                        spec.rope_theta, dtype=x.dtype, scaling=spec.rope_scaling)
                cos = cos.reshape(B, S, -1)
                sin = sin.reshape(B, S, -1)
            for l in range(spec.n_layers):
                x = _layer_padded(
                    spec, _layer_params(layers, l), q_hd_true[l], x, cos, sin, decode_attn,
                    _layer_window(spec, l), cache=tuple(c[l] for c in pools), pos=index.pos,
                    write_ix=index.write_ix, layer=l, moe=moe, moe_capacity=moe_capacity,
                    token_valid=token_valid, mesh=mesh,
                )
            if isinstance(logits_at, torch.Tensor):
                x = x[torch.arange(B, device=dev), logits_at][:, None]
            elif logits_at is not None:
                x = x[:, logits_at : logits_at + 1]
            return _unembed(spec, other, x)

        logits = None
        if graph is not None and S == 1 and logits_at is None:  # a whole-table decode
            if tokens.is_cuda and _replayable(tokens, pools, length, decode_attn, logits_at, moe, token_valid,
                                              index, mesh):
                key = (id(spec), id(layers), id(other), id(q_hd_true)) + tuple(
                    (t.data_ptr(), t.shape, t.stride(), t.dtype) for t in (tokens,) + pools)
                logits = graph.run(key, (tokens, pools, spec, layers, other, q_hd_true), length, stack)
            else:
                DecodeGraph.eager += 1
        if logits is None:
            if index is None:
                index = step_indices([length], B, S, cache_k.shape[3], dev)[0]
            logits = stack(index)
        if np.ndim(length) == 0:
            return logits, int(length) + S
        return logits, np.asarray(length) + S


def prefill_padded(pm: PaddedModel, prompt_ids: torch.Tensor, cache):
    """Prompt tokens [B, P] through the padded stack into ``cache`` =
    (k, v, length) from `init_cache_padded`, written in place; returns
    (last-position logits [B, V], (k, v, length + P))."""
    ck, cv, length = cache
    logits, length = _model_step_padded(pm.spec, pm.layers, pm.other, pm.q_hd_true, prompt_ids, ck, cv, length)
    return logits[:, -1, :], (ck, cv, length)


@torch.no_grad()
def generate_padded(
    pm: PaddedModel,
    prompt_ids,
    max_new_tokens: int = 32,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    eos_token_id: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    max_len: Optional[int] = None,
) -> torch.Tensor:
    """Generation over the padded stack: prefill, then ``max_new_tokens``
    one-token steps (greedy, or sampled from ``generator`` in the JAX
    ``key``'s place). Returns [B, prompt + new] int64 tokens on the
    model's device, as `models.generate.generate` does; a row that has
    emitted ``eos_token_id`` repeats it."""
    from modegpt_tpu_torch.models.generate import _sample

    dev = pm.other["embed_tokens"].device
    prompt_ids = torch.as_tensor(prompt_ids, device=dev).long()
    B, P = prompt_ids.shape
    cache = init_cache_padded(pm, B, P + max_new_tokens if max_len is None else max_len,
                              dtype=pm.other["embed_tokens"].dtype)
    logits, cache = prefill_padded(pm, prompt_ids, cache)
    out = [prompt_ids]
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for i in range(max_new_tokens):
        token = _sample(logits, generator, temperature, top_k)
        if eos_token_id is not None:
            token = torch.where(done, torch.full_like(token, eos_token_id), token)
            done = done | (token == eos_token_id)
        out.append(token[:, None])
        if i + 1 < max_new_tokens:
            logits, cache = prefill_padded(pm, token[:, None], cache)
    return torch.cat(out, dim=1)
