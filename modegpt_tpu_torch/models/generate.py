"""Autoregressive generation with a KV cache, and next-token sampling.

Port of ``modegpt_tpu.models.generate`` (the reference generates through
HF `generate` over its compressed attention, LlamaRebuild.py:343-348):

* `init_cache`, `prefill`, `decode_step` and `generate`: a preallocated
  per-layer cache ``[B, Hk, max_len, r]`` at each layer's compressed
  ranks, written in place at the filled length (the torch form of the
  JAX package's ``dynamic_update_slice`` with a donated cache); the new
  tokens attend the filled prefix through the grouped contraction of the
  JAX ``_layer_step`` (a plain masked softmax, no kernel, with gemma2's
  score cap), with masked RoPE at each new position through the layer's
  rotary mask;
* `apply_repetition_penalty`: HF's CTRL-style penalty;
* `_sample`: greedy argmax, or temperature sampling with HF's filter
  order temperature -> top-k -> top-p (nucleus) -> min-p. The knobs are
  plain Python values fixed per call, as the JAX function's static
  arguments are;
* `sample_rows`: per-row sampling for serving, each row with its own
  knobs from a ``[S, 5]`` or ``[S, 7]`` table (temperature, top_k,
  top_p, min_p, repetition penalty[, presence and frequency penalty]),
  in `_sample`'s order with the JAX function's tie-inclusive
  thresholds. Where the JAX function branches on the traced table
  (``lax.cond``), the port decides on the host copy of the table, so an
  all-greedy step skips the sort without asking the device.

The JAX ``generate_scan`` (the whole decode as one ``lax.scan``) has no
counterpart: the Python loop of `generate` is its torch form.

Random draws come from an explicit ``torch.Generator`` where the JAX
function takes a PRNG key. The two generators give different numbers
from the same seed, so a sampled stream here differs from the JAX
package's by construction; greedy decoding (temperature 0) is exact and
identical in both. `sample_rows` draws each row by inverse CDF, with
one uniform from a counter-based hash of (row seed, draw index) in
int64 torch ops: a row's draw depends on its seed, its draw index and
its logits only, never on its batch mates or on how steps are grouped
into dispatches, and needs no host round trip.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from modegpt_tpu_torch.models.forward import (
    _attn_input,
    _attn_output,
    _attn_scale,
    _embed,
    _linear,
    _mlp_block,
    _qk_norms,
    _softcap,
    _unembed,
    check_supported,
)
from modegpt_tpu_torch.models.spec import ModelSpec
from modegpt_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from modegpt_tpu_torch.utils.device import resolve_device

__all__ = [
    "KVCache",
    "init_cache",
    "prefill",
    "decode_step",
    "apply_repetition_penalty",
    "generate",
    "penalize_rows",
    "filter_rows",
    "sample_rows",
    "_sample",
]


class KVCache(NamedTuple):
    """Per-layer key/value caches, lists of [B, Hk, max_len, r], written
    in place; ``length`` is the filled length, a host int."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    length: int


def init_cache(spec: ModelSpec, batch: int, max_len: int, dtype=torch.float32, device="cuda") -> KVCache:
    """Zeroed per-layer caches [batch, Hk, max_len, r] on `device` (CUDA
    unless the caller asks for the CPU; raises without a card)."""
    device = resolve_device(device)
    ks, vs = [], []
    for l in range(spec.n_layers):
        r_k = spec.k_ranks[l] // spec.n_kv_heads
        r_v = spec.v_ranks[l] // spec.n_kv_heads
        ks.append(torch.zeros((batch, spec.n_kv_heads, max_len, r_k), dtype=dtype, device=device))
        vs.append(torch.zeros((batch, spec.n_kv_heads, max_len, r_v), dtype=dtype, device=device))
    return KVCache(k=ks, v=vs, length=0)


def _layer_step(spec: ModelSpec, layer_idx: int, p: Dict, x, cos, sin, cache_k, cache_v, pos: int):
    """One decoder layer over new tokens x [B, S, d]: writes their K/V
    into the cache at ``pos`` (in place) and attends the cache's filled
    prefix. Returns x_out."""
    B, S, _ = x.shape
    H, Hk = spec.n_heads, spec.n_kv_heads
    q_hd = spec.q_ranks[layer_idx] // H
    v_hd = spec.v_ranks[layer_idx] // Hk
    rotary_mask = p.get("rotary_mask")

    residual = x
    x_ln = _attn_input(spec, p, x)
    q = _linear(x_ln, p["q"]).reshape(B, S, H, q_hd)
    k = _linear(x_ln, p["k"]).reshape(B, S, Hk, q_hd)
    v = _linear(x_ln, p["v"]).reshape(B, S, Hk, v_hd)
    q, k = _qk_norms(spec, p, q, k, rotary_mask)
    q = q.transpose(1, 2)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    if spec.uses_rope:
        q, k = apply_rope(q, k, cos, sin, rotary_mask)
    cache_k[:, :, pos : pos + S] = k.to(cache_k.dtype)
    cache_v[:, :, pos : pos + S] = v.to(cache_v.dtype)

    # attend the whole pool, masked to the filled prefix: K/V stay at Hk
    # heads, the query heads grouped [Hk, G] (the JAX gqa_scores)
    max_len = cache_k.shape[2]
    G = H // Hk
    qg = q.reshape(B, Hk, G, S, q_hd)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, cache_k) * _attn_scale(spec, q_hd)
    scores = _softcap(scores.to(torch.float32), spec.attn_logit_softcap)
    t_ids = torch.arange(max_len, device=x.device)[None, :]
    s_ids = pos + torch.arange(S, device=x.device)[:, None]
    mask = t_ids <= s_ids
    if spec.layer_types and spec.layer_types[layer_idx] == "sliding_attention":
        mask = mask & (t_ids > s_ids - spec.sliding_window)
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    attn = torch.einsum("bkgst,bktd->bkgsd", probs, cache_v).reshape(B, H, S, v_hd)
    attn = attn.transpose(1, 2).reshape(B, S, H * v_hd)
    x = _attn_output(spec, p, residual, attn)
    return _mlp_block(spec, p, x, layer_idx, collect=False)[0]


@torch.no_grad()
def _model_step(spec: ModelSpec, params: Dict, tokens: torch.Tensor, cache: KVCache):
    """Run new tokens [B, S] through the model, writing the cache in
    place. Returns (logits [B, S, V], the cache at its new length)."""
    B, S = tokens.shape
    pos = cache.length
    max_len = cache.k[0].shape[2]
    if pos + S > max_len:
        raise ValueError(f"generate: {pos} + {S} tokens exceed the cache's max_len {max_len}")
    dev = tokens.device
    x = _embed(spec, params, tokens, pos + torch.arange(S, device=dev))
    cos = sin = None
    if spec.uses_rope:
        positions = pos + torch.arange(S, device=dev, dtype=torch.int32)
        cos, sin = rope_cos_sin(positions, spec.head_dim, spec.rope_theta, dtype=x.dtype, scaling=spec.rope_scaling)
    for l in range(spec.n_layers):
        x = _layer_step(spec, l, params["layers"][l], x, cos, sin, cache.k[l], cache.v[l], pos)
    return _unembed(spec, params, x), cache._replace(length=pos + S)


def prefill(spec: ModelSpec, params: Dict, prompt_ids: torch.Tensor, cache: KVCache):
    """Process the prompt; returns (last-position logits, cache)."""
    logits, cache = _model_step(spec, params, prompt_ids, cache)
    return logits[:, -1, :], cache


def decode_step(spec: ModelSpec, params: Dict, token: torch.Tensor, cache: KVCache):
    """One-token decode. token: [B, 1]."""
    logits, cache = _model_step(spec, params, token, cache)
    return logits[:, -1, :], cache


def apply_repetition_penalty(logits: torch.Tensor, presence: torch.Tensor, penalty: float) -> torch.Tensor:
    """CTRL-style repetition penalty (HF RepetitionPenaltyLogitsProcessor):
    for tokens marked in ``presence`` [..., V], positive logits divide by
    the penalty and negative ones multiply. Applied before temperature,
    like HF."""
    penalised = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(presence, penalised, logits)


@torch.no_grad()
def generate(
    spec: ModelSpec,
    params: Dict,
    prompt_ids,
    max_new_tokens: int = 32,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    eos_token_id: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    max_len: Optional[int] = None,
    top_p: Optional[float] = None,
    min_p: Optional[float] = None,
    repetition_penalty: Optional[float] = None,
) -> torch.Tensor:
    """Batched autoregressive generation on the parameters' device.
    Returns [B, prompt + new] int64 tokens; after every row has emitted
    ``eos_token_id`` the loop stops, and a finished row repeats it.
    ``generator`` (on the parameters' device) takes the JAX ``key``'s
    place for sampled decoding."""
    check_supported(spec)
    device = params["embed_tokens"].device
    prompt_ids = torch.as_tensor(prompt_ids, device=device).long()
    B, P = prompt_ids.shape
    if max_len is None:
        max_len = P + max_new_tokens
    cache = init_cache(spec, B, max_len, dtype=params["embed_tokens"].dtype, device=device)
    logits, cache = prefill(spec, params, prompt_ids, cache)

    presence = None
    if repetition_penalty is not None and repetition_penalty != 1.0:
        presence = torch.zeros((B, spec.vocab_size), dtype=torch.bool, device=device)
        presence[torch.arange(B, device=device)[:, None], prompt_ids] = True

    out = [prompt_ids]
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    rows = torch.arange(B, device=device)
    for _ in range(max_new_tokens):
        step_logits = logits
        if presence is not None:
            step_logits = apply_repetition_penalty(logits, presence, repetition_penalty)
        token = _sample(step_logits, generator, temperature, top_k, top_p, min_p)
        if eos_token_id is not None:
            token = torch.where(done, torch.full_like(token, eos_token_id), token)
            done = done | (token == eos_token_id)
        if presence is not None:
            presence[rows, token] = True
        out.append(token[:, None])
        if eos_token_id is not None and bool(done.all()):
            break
        logits, cache = decode_step(spec, params, token[:, None], cache)
    return torch.cat(out, dim=1)


def _sample(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    temperature: float,
    top_k: Optional[int],
    top_p: Optional[float] = None,
    min_p: Optional[float] = None,
) -> torch.Tensor:
    """Sample (or argmax) next tokens from [..., V] logits; returns int64
    ids of shape [...]. ``generator`` lives on the logits' device (None:
    torch's default generator); greedy ignores it. Ties in the argmax go
    to the lowest id, as in JAX."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.to(torch.float32) / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None and top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep a token if the mass BEFORE it is < top_p; the top token
        # always survives (HF min_tokens_to_keep=1)
        keep = (cum - probs) < top_p
        keep[..., 0] = True
        thr = torch.amin(sorted_desc.masked_fill(~keep, float("inf")), dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < thr, float("-inf"))
    if min_p is not None and min_p > 0.0:
        probs = torch.softmax(logits, dim=-1)
        pmax = torch.amax(probs, dim=-1, keepdim=True)
        # tokens tied at pmax always survive (min_p >= 1 -> argmax)
        logits = logits.masked_fill((probs < min_p * pmax) & (probs < pmax), float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(probs.shape[:-1])


def _knob_columns(samp: np.ndarray, samp_dev: Optional[torch.Tensor], device) -> torch.Tensor:
    """The knob table on the logits' device (``samp_dev`` when the caller
    keeps it resident)."""
    if samp_dev is not None:
        return samp_dev
    return torch.as_tensor(np.asarray(samp, np.float32), device=device)


def penalize_rows(
    logits: torch.Tensor,
    samp: np.ndarray,
    presence: Optional[torch.Tensor] = None,
    gen_counts: Optional[torch.Tensor] = None,
    samp_dev: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[S, V] float32 logits after each row's penalties: the CTRL-style
    repetition penalty (column 4) over ``presence`` [S, V], then, with
    the 7-column table and ``gen_counts`` [S, V] (generated tokens only),
    the additive OpenAI penalties ``- presence_penalty * (count > 0) -
    frequency_penalty * count``. A pass runs only when some row of the
    host table ``samp`` enables it (the JAX function's ``lax.cond``)."""
    samp = np.asarray(samp, np.float32)
    x = logits.to(torch.float32)
    knobs = None
    if presence is not None and (samp[:, 4] != 1.0).any():
        knobs = _knob_columns(samp, samp_dev, x.device)
        x = apply_repetition_penalty(x, presence, knobs[:, 4:5])
    if samp.shape[1] >= 7 and gen_counts is not None and ((samp[:, 5] != 0.0) | (samp[:, 6] != 0.0)).any():
        knobs = _knob_columns(samp, samp_dev, x.device) if knobs is None else knobs
        counts = gen_counts.to(torch.float32)
        x = x - knobs[:, 5:6] * (counts > 0.0) - knobs[:, 6:7] * counts
    return x


def filter_rows(scaled: torch.Tensor, samp: np.ndarray, samp_dev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each row's top-k (column 1), top-p (2) and min-p (3) filters over
    temperature-scaled [S, V] float32 logits: the tokens a filter drops
    become -inf. All three keep a prefix of the descending sort, so one
    sort serves them; every filter keeps rank 0 (HF min_tokens_to_keep=1),
    thresholds are tie-inclusive, and the off-sentinels (top_k <= 0,
    top_p >= 1, min_p <= 0) leave a row as it is. Without any filter on
    in the host table ``samp`` the sort is skipped."""
    samp = np.asarray(samp, np.float32)
    if not ((samp[:, 1] > 0) | (samp[:, 2] < 1.0) | (samp[:, 3] > 0.0)).any():
        return scaled
    knobs = _knob_columns(samp, samp_dev, scaled.device)
    top_k, top_p, min_p = knobs[:, 1:2], knobs[:, 2:3], knobs[:, 3:4]
    V = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    rank = torch.arange(V, device=scaled.device, dtype=torch.float32)[None, :]
    first = rank == 0
    neg_inf = torch.tensor(float("-inf"), device=scaled.device)
    valid = torch.where(top_k > 0, (rank < top_k) | first, True)
    probs = torch.softmax(torch.where(valid, sorted_desc, neg_inf), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    valid = valid & torch.where(top_p < 1.0, ((cum - probs) < top_p) | first, True)
    probs = torch.softmax(torch.where(valid, sorted_desc, neg_inf), dim=-1)
    # sorted descending: probs[:, :1] is each row's largest probability
    valid = valid & torch.where(min_p > 0.0, (probs >= min_p * probs[:, :1]) | first, True)
    thr = torch.amin(sorted_desc.masked_fill(~valid, float("inf")), dim=-1, keepdim=True)
    return scaled.masked_fill(scaled < thr, float("-inf"))


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2**32 for int64 x in [0, 2**32): the 32-bit product in
    16-bit halves, so no int64 product overflows (CPU and CUDA agree)."""
    lo, hi = m & 0xFFFF, m >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser (the "lowbias32" constants) on int64
    tensors holding values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform_rows(seeds: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """[S] float64 uniforms in (0, 1), a pure function of each row's
    (seed, draw index): 52 bits from a counter-based hash. seeds and
    counts are int64 [S] on the device; seeds are taken modulo 2**64 in
    two 32-bit halves."""
    lo, hi = seeds & _M32, (seeds >> 32) & _M32
    key = _mix32(_mix32(_mix32(lo) ^ hi) ^ (counts & _M32))
    top, low = _mix32(key ^ 0x68E31DA4) >> 6, _mix32(key ^ 0xB5297A4D) >> 6
    return ((top * (1 << 26) + low).to(torch.float64) + 0.5) * (1.0 / (1 << 52))


def _inverse_cdf(final: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The token of each row of ``final`` [S, V] (logits, -inf where
    filtered) whose cumulative probability first reaches ``u`` [S] of the
    row's total (float64 sums), so that token i is drawn with its softmax
    probability and a filtered token never."""
    cum = torch.cumsum(torch.softmax(final, dim=-1), dim=-1, dtype=torch.float64)
    idx = torch.searchsorted(cum, (u * cum[:, -1])[:, None])[:, 0]
    return torch.clamp(idx, max=final.shape[-1] - 1)


def sample_rows(
    logits: torch.Tensor,
    samp: np.ndarray,
    generator: Optional[torch.Generator] = None,
    presence: Optional[torch.Tensor] = None,
    gen_counts: Optional[torch.Tensor] = None,
    seeds: Optional[torch.Tensor] = None,
    counts: Optional[torch.Tensor] = None,
    samp_dev: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-row next tokens [S] (int64) from [S, V] logits, each row under
    its own knobs (JAX ``generate.sample_rows``): ``samp`` is the host
    knob table [S, 5] or [S, 7] float32 (temperature, top_k, top_p,
    min_p, repetition_penalty[, presence_penalty, frequency_penalty]);
    ``samp_dev`` its copy on the device when the caller keeps one.

    Order and semantics are the JAX function's: penalties
    (`penalize_rows`), then temperature, then the filters
    (`filter_rows`). temperature 0 -> greedy argmax of the penalised
    logits (ties to the lowest id). Sampled rows draw from the softmax of
    their filtered logits by inverse CDF, at a uniform that is a function
    of ``seeds`` [S] and ``counts`` [S] (int64 on the device: each row's
    stream seed and draw index, `uniform_rows`).
    Without ``seeds`` each call draws fresh row seeds from
    ``generator``. Every decision that needs the table (any penalty, any
    filter, any sampled row) is taken on the host copy."""
    samp = np.asarray(samp, np.float32)
    x = penalize_rows(logits, samp, presence, gen_counts, samp_dev)
    greedy = torch.argmax(x, dim=-1)
    sampled_rows = samp[:, 0] != 0.0
    if not sampled_rows.any():
        return greedy
    knobs = _knob_columns(samp, samp_dev, x.device)
    temp = knobs[:, 0:1]
    final = filter_rows(x / torch.clamp(temp, min=1e-6), samp, knobs)
    S = x.shape[0]
    if seeds is None:
        seeds = torch.randint(0, 1 << 62, (S,), generator=generator, device=x.device)
    if counts is None:
        counts = torch.zeros((S,), dtype=torch.int64, device=x.device)
    sampled = _inverse_cdf(final, uniform_rows(seeds, counts))
    return torch.where(temp[:, 0] == 0.0, greedy, sampled)
