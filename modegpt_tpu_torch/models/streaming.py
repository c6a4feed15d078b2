"""Streaming generation with an attention-sink ring cache.

Port of ``modegpt_tpu.models.streaming``. The slot-table serving cache
(`models.serving`) is bounded by ``max_len``; this is the unbounded
alternative: a fixed cache of ``n_sink`` pinned initial tokens plus a
ring over the last ``window - n_sink`` tokens (StreamingLLM, Xiao et al.
2023: sinks keep the softmax mass that would otherwise land on evicted
early positions).

* Keys are cached before RoPE; every step rotates them at
  cache-relative positions (sinks at 0..n_sink-1, ring tokens contiguous
  after), so positions stay inside the trained range however long the
  stream runs.
* The ring is addressed by ``global_pos % ring_len``: eviction is an
  overwrite in place of the ``[L, B, Hk, window, r]`` caches, never a
  copy or a reallocation, so device memory stays flat over the stream.
* It runs on the padded-uniform stack (`models.padded.PaddedModel`), so
  heterogeneous-rank compressed models, MoE and mixed dense/MoE stacks
  stream through one layer body. A model's own sliding window masks by
  global distance, each layer by its own window.
* The prompt feeds one token at a time through the same step (it may
  exceed the window; its head is then evicted like any other token).
  The slot, the relative positions and the masks are decided on the
  host from the step's position and uploaded in one copy; the tokens
  stay on the device until the stream ends.
* The attention is the plain masked contraction, as in the JAX module
  (no Pallas there, no kernel here): the serving kernel's slot-table
  layout is not this cache's.

Beyond the window this is lossy by design (evicted tokens are gone).
Within it (prompt + new <= window) it is greedy generation exactly.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from modegpt_tpu_torch.models.forward import (
    _attn_input,
    _attn_output,
    _embed,
    _linear,
    _mlp_block,
    _qk_norms,
    _softcap,
    _unembed,
)
from modegpt_tpu_torch.models.padded import PaddedModel, _layer_params, _layer_window, upload
from modegpt_tpu_torch.models.spec import ModelSpec
from modegpt_tpu_torch.ops.rope import apply_rope, rope_cos_sin

__all__ = ["streaming_generate"]


def _slot_of(g: int, n_sink: int, ring_len: int) -> int:
    """Cache slot of global position g: sinks pinned, the rest ring-addressed."""
    return g if g < n_sink else n_sink + (g - n_sink) % ring_len


def _rel_positions(g: int, C: int, n_sink: int, ring_len: int):
    """Per-slot cache-relative positions, validity and global positions
    at step g (the token at g is written before it attends).

    Slots [0, n_sink) hold globals 0..n_sink-1 (relative = global). Ring
    slot s holds the largest global p <= g with p >= n_sink and
    (p - n_sink) % ring_len == s - n_sink; its relative position is
    n_sink + (p - ring_start), ring_start the oldest retained ring
    global. A slot not yet written is invalid. Host numpy, [C] each."""
    slots = np.arange(C, dtype=np.int64)
    is_sink = slots < n_sink
    m = g - n_sink
    p_ring = n_sink + m - np.mod(m - (slots - n_sink), ring_len)
    p = np.where(is_sink, slots, p_ring)
    valid = (p >= 0) & (p <= g) & (is_sink | (p >= n_sink))
    n_ring = min(g - n_sink + 1, ring_len)
    ring_start = g + 1 - n_ring
    rel = np.where(is_sink, slots, n_sink + (p - ring_start))
    return np.where(valid, rel, 0), valid, p


def _stream_step(
    spec: ModelSpec,
    layers: Dict,
    other: Dict,
    q_hd_true: torch.Tensor,
    token: torch.Tensor,
    ck: torch.Tensor,
    cv: torch.Tensor,
    g: int,
    n_sink: int,
) -> torch.Tensor:
    """One token [B] at global position g through the stack. ck/cv:
    [L, B, Hk, C, r] pre-RoPE key and value caches, written in place at
    g's slot. Returns the logits [B, V]."""
    B = token.shape[0]
    H, Hk = spec.n_heads, spec.n_kv_heads
    C = ck.shape[3]
    ring_len = C - n_sink
    Rq = spec.q_ranks[0] // H
    Rv = spec.v_ranks[0] // Hk
    dev = token.device

    slot = _slot_of(g, n_sink, ring_len)
    rel, valid, p_global = _rel_positions(g, C, n_sink, ring_len)
    # one validity row per distinct layer window: global distance < window
    windows = sorted({_layer_window(spec, l) for l in range(spec.n_layers)}, key=lambda w: w or 0)
    masks = [valid & ((g - p_global < w) if w else True) for w in windows]
    q_rel = min(g, C - 1)
    host = upload(np.concatenate([rel, [q_rel], *masks]).astype(np.int64), dev)
    rel_d, q_rel_d = host[:C], host[C : C + 1]
    mask_of = {w: host[C + 1 + i * C : C + 1 + (i + 1) * C].bool() for i, w in enumerate(windows)}

    # positions embed at the query's relative position (OPT's and GPT-2's too)
    x = _embed(spec, other, token[:, None], q_rel_d)
    if spec.uses_rope:
        cos_k, sin_k = rope_cos_sin(rel_d.to(torch.int32), spec.head_dim, spec.rope_theta, dtype=x.dtype,
                                    scaling=spec.rope_scaling)
        cos_q, sin_q = rope_cos_sin(q_rel_d.to(torch.int32), spec.head_dim, spec.rope_theta, dtype=x.dtype,
                                    scaling=spec.rope_scaling)
    G = H // Hk
    for l in range(spec.n_layers):
        p = _layer_params(layers, l)
        rm = p.get("rotary_mask")
        x_ln = _attn_input(spec, p, x)
        q = _linear(x_ln, p["q"]).reshape(B, 1, H, Rq)
        k = _linear(x_ln, p["k"]).reshape(B, 1, Hk, Rq)
        v = _linear(x_ln, p["v"]).reshape(B, 1, Hk, Rv)
        q, k = _qk_norms(spec, p, q, k, rm, q_hd_true[l])
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        # the pre-RoPE k and the v at the slot, in place
        ck[l, :, :, slot] = k[:, :, 0].to(ck.dtype)
        cv[l, :, :, slot] = v[:, :, 0].to(cv.dtype)
        k_all = ck[l]  # [B, Hk, C, r]
        if spec.uses_rope:
            # q at its relative position; the whole pre-RoPE cache at the
            # slots' current relative positions
            q, _ = apply_rope(q, k, cos_q, sin_q, rm)
            _, k_all = apply_rope(k_all, k_all, cos_k, sin_k, rm)
        if spec.query_pre_attn_scalar is not None:  # gemma2's fixed scale
            q_scale = torch.rsqrt(torch.tensor(spec.query_pre_attn_scalar, dtype=torch.float32))
        else:
            q_scale = torch.rsqrt(q_hd_true[l])
        q = q * q_scale.to(q.dtype)
        # grouped contraction: K/V stay at Hk heads
        scores = torch.einsum("bkgsd,bktd->bkgst", q.reshape(B, Hk, G, 1, Rq), k_all)
        scores = _softcap(scores.to(torch.float32), spec.attn_logit_softcap)
        scores = scores.masked_fill(~mask_of[_layer_window(spec, l)], float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        attn = torch.einsum("bkgst,bktd->bkgsd", probs, cv[l]).reshape(B, H, 1, Rv)
        x = _attn_output(spec, p, x, attn.transpose(1, 2).reshape(B, 1, H * Rv))
        x = _mlp_block(spec, p, x, l, collect=False)[0]
    return _unembed(spec, other, x)[:, -1, :]


@torch.no_grad()
def streaming_generate(
    pm: PaddedModel,
    prompt_ids,
    max_new_tokens: int = 32,
    window: int = 256,
    n_sink: int = 4,
    eos_token_id: Optional[int] = None,
    on_step: Optional[Callable[[int, torch.Tensor], None]] = None,
) -> np.ndarray:
    """Greedy generation in O(window) memory for unbounded streams, on
    the model's device.

    Within the window (prompt + new <= window) the output equals plain
    greedy decoding exactly; beyond it the oldest non-sink tokens are
    evicted (StreamingLLM, lossy by design). Returns [B, prompt + new]
    host tokens; a row that has emitted ``eos_token_id`` repeats it.
    ``on_step(g, logits)``, when given, sees every step's logits [B, V]
    on the device, the prompt's too (g is the step's global position)."""
    spec = pm.spec
    dev = pm.other["embed_tokens"].device
    prompt = torch.as_tensor(np.asarray(prompt_ids), device=dev).long()
    B, P = prompt.shape
    if n_sink >= window:
        raise ValueError(f"n_sink ({n_sink}) must be < window ({window})")
    if window > spec.max_position_embeddings:
        raise ValueError(f"window ({window}) exceeds max_position_embeddings ({spec.max_position_embeddings})")
    if not spec.uses_rope and P + max_new_tokens > window:
        # RoPE caches are position-free (keys re-roped at cache-relative
        # positions every step), so eviction keeps one frame. Learned
        # positions (opt, gpt2) are baked into the cached activations at
        # feed time and cannot be re-based after an eviction; within the
        # window the stream is exact, so only streams that can evict fail.
        raise ValueError(
            f"streaming beyond the window is unsupported for learned-position "
            f"arch {spec.arch!r}: cached activations embed absolute "
            f"positions, which cannot be re-based after eviction "
            f"(prompt {P} + max_new_tokens {max_new_tokens} > window {window})"
        )
    dtype = pm.other["embed_tokens"].dtype
    L, Hk = spec.n_layers, spec.n_kv_heads
    ck = torch.zeros((L, B, Hk, window, spec.q_ranks[0] // spec.n_heads), dtype=dtype, device=dev)
    cv = torch.zeros((L, B, Hk, window, spec.v_ranks[0] // Hk), dtype=dtype, device=dev)

    def step(token, g):
        logits = _stream_step(spec, pm.layers, pm.other, pm.q_hd_true, token, ck, cv, g, n_sink)
        if on_step is not None:
            on_step(g, logits)
        return logits

    for g in range(P):
        logits = step(prompt[:, g], g)
    # tokens land in one buffer: nothing on the device grows with the stream
    out = torch.empty((B, max_new_tokens), dtype=torch.long, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for i in range(max_new_tokens):
        token = torch.argmax(logits, dim=-1)
        if eos_token_id is not None:
            token = torch.where(done, torch.full_like(token, eos_token_id), token)
            done = done | (token == eos_token_id)
        out[:, i] = token
        if i + 1 < max_new_tokens:
            logits = step(token, P + i)
    return torch.cat([prompt, out], dim=1).cpu().numpy()
