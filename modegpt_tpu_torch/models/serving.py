"""Serving core: slot-table KV cache and continuous batching.

Port of ``modegpt_tpu.models.serving`` over the padded stack
(`models.padded`):

* one cache pool ``[L, slots, Hk, max_len, R]`` per K and V (int8 codes
  plus per-position scales with ``kv_dtype="int8"``), allocated once and
  updated in place: admission and eviction only change host bookkeeping;
* a decode step runs every slot at its own position (per-row RoPE
  phases, per-row causal masks); idle and finished slots run masked, their
  write landing at their current length, to be rewritten on reuse;
* a prompt is prefilled in chunks of ``prefill_bucket`` tokens (the last
  one right-padded), interleaved with decode steps: per slot
  (`_prefill_chunk`), or every admitting slot's next chunk in one
  ``[slots, bucket]`` dispatch (`_prefill_slots`, ``prefill_exec=
  "batched"``), which by default also carries each decode-active slot's
  next token (mixed rounds, ``mixed_prefill_decode``);
* fused decode (``steps_per_dispatch=N``): N steps issued back to back,
  their cache indices uploaded once, each slot stopping on the card at
  EOS and on the host plan at its budget, the tokens fetched once;
* prefix caching: a new prompt adopts the longest bucket-aligned prefix
  that some slot's cache holds (a slot-row copy) instead of recomputing
  it;
* speculative decoding, greedy-exact: ``spec_decode="prompt_lookup"``
  drafts from each slot's own history, ``"draft"`` runs a draft model in
  a second pool (k draft steps and one cache-fill step); one (k+1)-token
  verify dispatch of the target commits 1..k+1 tokens a slot.
  ``batcher.stats`` holds each request's rounds, drafted and accepted
  tokens.

Every dispatch reaches the attention of `models.padded._layer_padded`:
``decode_attn="ragged"`` is the CUDA ragged kernel (K3,
``kernels/ragged_decode.py``), whose reads cover each slot's live keys
only; ``"xla"`` is its plain version, the masked contraction over the
whole pool.
``"auto"`` takes the kernel for every dispatch on a CUDA device
(prefill, mixed, decode, draft and verify) and the plain path on the CPU.

Where the JAX package keeps the slot lengths on the device, the port
keeps them on the host (``ServeState.lengths``, numpy): the host decides
which cache writes fall past the pool, so none reaches the device as an
out-of-range index. Host arrays reach the card through pinned memory
without a wait (`models.padded.upload`); a dispatch waits for the card
only where its tokens come back to the host.

MoE models serve with every expert on every token (``moe="dense"``) or
through capacity-based token dispatch (``moe="dispatch"`` at
``moe_capacity``): each dispatch marks the tokens that may claim expert
capacity (a prefill chunk's real positions; the decode-active slots), as
the JAX step functions do. A batched prefill pools capacity across the
admitting slots, so under dispatch its drops can differ from per-slot
prefill, as in the JAX package.

An int8 model (`models.quantize.quantize_padded`) serves weight-only;
with ``a8_prefill`` the prefill dispatches (mixed rounds included) run on
its W8A8 view (`models.quantize.with_act_quant`: per-token int8
activations, int8 x int8 -> int32 products), while decode keeps the
weight-only model; a draft model takes its own view. On an unquantised
model the view changes nothing.

Still raising NotImplementedError, with this module named: the
constructor's ``per_request_sampling``, ``repetition_penalty`` and
``mesh``; `submit`'s per-request sampling knobs (temperature, top_k,
top_p, min_p, repetition, presence and frequency penalties), logprobs,
top_logprobs, seed, guide, logit_bias and min_tokens.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view

from modegpt_tpu_torch.models.generate import _sample
from modegpt_tpu_torch.models.padded import PaddedModel, _model_step_padded, step_indices, upload
from modegpt_tpu_torch.models.quantize import with_act_quant

__all__ = [
    "ServeState",
    "init_serve_state",
    "resolve_decode_attn",
    "prefill_slot",
    "decode_slots",
    "lookup_draft",
    "ContinuousBatcher",
]

_MODULE = "modegpt_tpu_torch.models.serving"


class ServeState(NamedTuple):
    cache_k: torch.Tensor  # [L, slots, Hk, max_len, Rq] (int8 codes when quantized)
    cache_v: torch.Tensor  # [L, slots, Hk, max_len, Rv]
    lengths: np.ndarray  # [slots] int64, host: tokens currently in each slot
    last_token: torch.Tensor  # [slots] int64 on the pool's device: newest token per slot
    # int8 KV: per-(layer, slot, head, position) scales; None = model dtype
    k_scale: Optional[torch.Tensor] = None  # [L, slots, Hk, max_len] float32
    v_scale: Optional[torch.Tensor] = None

    @property
    def scales(self):
        return None if self.k_scale is None else (self.k_scale, self.v_scale)


def resolve_decode_attn(decode_attn: str, device: torch.device) -> str:
    """"auto" -> "ragged" (the CUDA kernel) on a CUDA device, "xla" (the
    plain masked contraction) on the CPU; "xla" and "ragged" as given."""
    if decode_attn not in ("auto", "xla", "ragged"):
        raise ValueError(f"decode_attn must be auto/xla/ragged, got {decode_attn!r}")
    if decode_attn == "auto":
        return "ragged" if torch.device(device).type == "cuda" else "xla"
    return decode_attn


def _device(pm: PaddedModel) -> torch.device:
    return pm.other["embed_tokens"].device


def init_serve_state(pm: PaddedModel, slots: int, max_len: int,
                     dtype: Optional[torch.dtype] = None, kv_dtype: str = "model") -> ServeState:
    """Empty pools on the model's device. kv_dtype: "model" (the cache in
    ``dtype``, default the model's) or "int8" (codes plus float32
    per-vector scales: half the capacity of bf16, a quarter of f32)."""
    if kv_dtype not in ("model", "int8"):
        raise ValueError(f"kv_dtype must be model or int8, got {kv_dtype!r}")
    spec = pm.spec
    dev = _device(pm)
    dtype = pm.other["embed_tokens"].dtype if dtype is None else dtype
    Rq = spec.q_ranks[0] // spec.n_heads
    Rv = spec.v_ranks[0] // spec.n_kv_heads
    L, Hk = spec.n_layers, spec.n_kv_heads
    quant = kv_dtype == "int8"
    cdt = torch.int8 if quant else dtype

    def scales():
        return torch.zeros((L, slots, Hk, max_len), dtype=torch.float32, device=dev) if quant else None

    return ServeState(
        cache_k=torch.zeros((L, slots, Hk, max_len, Rq), dtype=cdt, device=dev),
        cache_v=torch.zeros((L, slots, Hk, max_len, Rv), dtype=cdt, device=dev),
        lengths=np.zeros((slots,), np.int64),
        last_token=torch.zeros((slots,), dtype=torch.int64, device=dev),
        k_scale=scales(),
        v_scale=scales(),
    )


def _chunks(prompt: np.ndarray, bucket: int) -> List[Tuple[np.ndarray, int, bool]]:
    """A prompt's prefill chunks, in order: (tokens, offset, is_last),
    each at most `bucket` tokens long."""
    n = max(1, -(-prompt.shape[0] // bucket))
    return [(prompt[c * bucket : (c + 1) * bucket], c * bucket, c == n - 1) for c in range(n)]


def _step(pm: PaddedModel, state: ServeState, tokens: torch.Tensor, length, **kw):
    """`_model_step_padded` of `pm` over the whole slot table of `state`."""
    return _model_step_padded(pm.spec, pm.layers, pm.other, pm.q_hd_true, tokens, state.cache_k,
                              state.cache_v, length, cache_scales=state.scales, **kw)[0]


def _prefill_chunk(pm: PaddedModel, state: ServeState, slot: int, piece: np.ndarray, pos0: int,
                   bucket: int, commit: bool, temperature: float,
                   generator: Optional[torch.Generator], top_p=None, min_p=None,
                   decode_attn: str = "xla", moe: str = "dense",
                   moe_capacity: float = 2.0) -> Optional[int]:
    """Run one prompt chunk (`piece`, at most `bucket` tokens, right-padded
    to `bucket`) through `slot` at offset pos0. The pools are read and
    written through the slot's views, never copied. When `commit` is set
    (the prompt's last chunk) the next token is sampled from the last
    real position and returned; else None. The padded tail claims no
    dispatch-MoE expert capacity."""
    dev = _device(pm)
    real_len = piece.shape[0]
    chunk = np.zeros((1, bucket), np.int64)
    chunk[0, :real_len] = piece
    view = slice(slot, slot + 1)
    scales = None if state.scales is None else tuple(s[:, view] for s in state.scales)
    tail_valid = None  # only dispatch reads it
    if moe == "dispatch":
        tail_valid = upload(np.arange(bucket)[None, :] < real_len, dev)
    logits, _ = _model_step_padded(
        pm.spec, pm.layers, pm.other, pm.q_hd_true, upload(chunk, dev),
        state.cache_k[:, view], state.cache_v[:, view], pos0, cache_scales=scales,
        decode_attn=decode_attn, logits_at=real_len - 1,
        moe=moe, moe_capacity=moe_capacity, token_valid=tail_valid,
    )
    state.lengths[slot] = pos0 + real_len
    if not commit:
        return None
    nxt = _sample(logits[0, 0], generator, temperature, None, top_p=top_p, min_p=min_p)
    state.last_token[slot] = nxt
    return int(nxt)


def _prefill_slots(pm: PaddedModel, state: ServeState, chunks: np.ndarray, pos0: np.ndarray,
                   real_len: np.ndarray, commit: np.ndarray, prefill_mask: np.ndarray,
                   temperature: float, generator: Optional[torch.Generator], top_p=None, min_p=None,
                   decode_attn: str = "xla", moe: str = "dense",
                   moe_capacity: float = 2.0) -> torch.Tensor:
    """One chunk for every row of the slot table in a single dispatch
    (JAX ``_prefill_slots_jit``): chunks [slots, bucket] at per-row
    offsets pos0, ``prefill_mask`` selecting the rows that run a chunk.
    A mixed round passes each decode-active slot as a one-token chunk of
    its last committed token at pos0 = its length, with commit set.
    The other rows sit at their length; their writes land at or past it
    (dropped past the pool) and are rewritten before anything attends
    them. Rows with ``commit`` sample their next token from their last
    real position. Returns the sampled tokens [slots] on the device
    (meaningful for committed rows)."""
    dev = _device(pm)
    S = chunks.shape[1]
    pos_arg = np.where(prefill_mask, pos0, state.lengths)
    valid = None
    if moe == "dispatch":
        valid = upload(prefill_mask[:, None] & (np.arange(S)[None, :] < real_len[:, None]), dev)
    logits = _step(pm, state, upload(chunks.astype(np.int64), dev), pos_arg, decode_attn=decode_attn,
                   logits_at=upload(np.maximum(real_len - 1, 0).astype(np.int64), dev),
                   moe=moe, moe_capacity=moe_capacity, token_valid=valid)
    nxt = _sample(logits[:, 0], generator, temperature, None, top_p=top_p, min_p=min_p)
    state.lengths[:] = np.where(prefill_mask, pos0 + real_len, state.lengths)
    state.last_token.copy_(torch.where(upload(commit, dev), nxt, state.last_token))
    return nxt


def _adopt_prefix(state: ServeState, src: int, dst: int, new_len: int) -> None:
    """Copy slot `src`'s whole cache row (codes and scales) onto slot
    `dst` and set `dst`'s length to the adopted prefix (JAX
    ``_adopt_prefix_jit``). Positions past ``new_len`` are stale; every
    later write for `dst` lands at or past it, before anything attends
    there. src == dst (a slot re-admitted with its own previous prefix)
    copies nothing."""
    if src != dst:
        for pool in (state.cache_k, state.cache_v) + (state.scales or ()):
            pool[:, dst].copy_(pool[:, src])
    state.lengths[dst] = new_len


def _one_decode_step(pm: PaddedModel, state: ServeState, active: np.ndarray, temperature: float,
                     top_k, generator: Optional[torch.Generator], top_p=None, min_p=None,
                     decode_attn: str = "xla", moe: str = "dense",
                     moe_capacity: float = 2.0) -> torch.Tensor:
    """One decode step for ALL slots from each slot's last token at its
    own length. Inactive rows run masked: their length and last token do
    not advance, their cache write lands at their current position, to
    be overwritten on reuse, and their tokens claim no dispatch-MoE
    expert capacity. Returns the sampled tokens [slots]."""
    active = np.asarray(active, bool)
    dev = _device(pm)
    valid = upload(active[:, None], dev) if moe == "dispatch" else None
    logits = _step(pm, state, state.last_token[:, None], state.lengths, decode_attn=decode_attn,
                   moe=moe, moe_capacity=moe_capacity, token_valid=valid)
    nxt = _sample(logits[:, -1, :], generator, temperature, top_k, top_p=top_p, min_p=min_p)
    state.last_token.copy_(torch.where(upload(active, dev), nxt, state.last_token))
    state.lengths[active] += 1
    return nxt


def _decode_slots_multi(pm: PaddedModel, state: ServeState, active: np.ndarray, budgets: np.ndarray,
                        eos: Optional[int], n_steps: int, temperature: float,
                        generator: Optional[torch.Generator], top_p=None, min_p=None,
                        decode_attn: str = "xla", moe: str = "dense",
                        moe_capacity: float = 2.0) -> Tuple[np.ndarray, np.ndarray]:
    """`n_steps` decode steps for all slots, issued without a host wait
    between them (JAX ``_decode_slots_multi_jit``). A slot stops
    advancing the step it emits EOS (decided on the card) or exhausts
    its budget (known to the host ahead), so fusing never over-decodes.

    Every step's offsets come from the host plan (a row advances one a
    step while its budget lasts) and are uploaded in one copy; the
    sampled tokens stay on the card and are fetched once, at the end. A
    row that stopped at EOS is finished: its later writes land past its
    committed tokens and are never read. Returns (toks [n_steps, slots],
    emitted [n_steps, slots]): the host appends the emitted tokens."""
    dev = _device(pm)
    active = np.asarray(active, bool)
    budgets = np.where(active, budgets, 0)
    steps = np.arange(n_steps)[:, None]
    planned = active[None, :] & (steps < budgets[None, :])  # [n, slots]
    lengths = state.lengths[None, :] + np.minimum(steps, budgets[None, :])
    index = step_indices(list(lengths), state.lengths.shape[0], 1, state.cache_k.shape[3], dev)
    plan = upload(planned, dev)
    alive, tok, toks = plan[0], state.last_token, []
    for i in range(n_steps):
        valid = alive[:, None] if moe == "dispatch" else None
        logits = _step(pm, state, tok[:, None], lengths[i], index=index[i], decode_attn=decode_attn,
                       moe=moe, moe_capacity=moe_capacity, token_valid=valid)
        nxt = _sample(logits[:, -1, :], generator, temperature, None, top_p=top_p, min_p=min_p)
        toks.append(nxt)
        tok = torch.where(alive, nxt, tok)
        if i + 1 < n_steps:
            alive = plan[i + 1] & alive
            if eos is not None:
                alive = alive & (nxt != eos)
    toks = torch.stack(toks).cpu().numpy()  # the dispatch's one wait
    emitted = planned
    if eos is not None:
        hit = (toks == eos) & planned
        emitted = planned & (np.cumsum(hit, axis=0) - hit == 0)
    state.lengths[:] += emitted.sum(axis=0)
    state.last_token.copy_(tok)
    return toks, emitted


def _draft_slots(pm: PaddedModel, state: ServeState, active: np.ndarray, k: int,
                 decode_attn: str = "xla", moe: str = "dense", moe_capacity: float = 2.0) -> torch.Tensor:
    """k greedy draft steps for all slots plus one cache-fill step, so
    that every drafted token's K/V is in the draft pool (JAX
    ``_draft_slots_jit``); issued without a host wait, their offsets (each
    row's length + i) uploaded once. The lengths stay unchanged: the
    caller commits them after verification (`_commit_draft_cache`).
    Returns the drafts [slots, k] on the device."""
    dev = _device(pm)
    lengths = [state.lengths + i for i in range(k + 1)]
    index = step_indices(lengths, state.lengths.shape[0], 1, state.cache_k.shape[3], dev)
    valid = upload(np.asarray(active, bool)[:, None], dev) if moe == "dispatch" else None
    tok, dtoks = state.last_token, []
    for i in range(k + 1):
        logits = _step(pm, state, tok[:, None], lengths[i], index=index[i], decode_attn=decode_attn,
                       moe=moe, moe_capacity=moe_capacity, token_valid=valid)
        if i < k:
            tok = torch.argmax(logits[:, -1, :], dim=-1)
            dtoks.append(tok)
    return torch.stack(dtoks, dim=1)


def _verify_slots(pm: PaddedModel, state: ServeState, active: np.ndarray, drafts: torch.Tensor,
                  max_adv: np.ndarray, eos: Optional[int], decode_attn: str = "xla", moe: str = "dense",
                  moe_capacity: float = 2.0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One greedy verify dispatch for all slots (JAX ``_verify_slots_jit``):
    each slot's [last token, k drafts] at its length. A slot commits the
    target's tokens up to the first rejected draft plus one, cut at an
    EOS and at ``max_adv`` (its remaining budget); inactive slots commit
    nothing, and their writes land past their length. Returns (ttoks
    [slots, k+1], adv [slots], accepted drafts [slots]) on the host."""
    dev = _device(pm)
    active = np.asarray(active, bool)
    k = drafts.shape[1]
    window = torch.cat([state.last_token[:, None], drafts], dim=1)
    valid = upload(np.repeat(active[:, None], k + 1, axis=1), dev) if moe == "dispatch" else None
    logits = _step(pm, state, window, state.lengths, decode_attn=decode_attn, moe=moe,
                   moe_capacity=moe_capacity, token_valid=valid)
    both = torch.cat([torch.argmax(logits, dim=-1), drafts], dim=1).cpu().numpy()  # the one wait
    ttoks, drafts = both[:, : k + 1], both[:, k + 1 :]
    acc = np.cumprod(drafts == ttoks[:, :k], axis=1).sum(axis=1)
    adv = acc + 1
    if eos is not None:
        is_eos = ttoks == eos
        in_prefix = (is_eos & (np.arange(k + 1)[None, :] < adv[:, None])).any(axis=1)
        adv = np.where(in_prefix, np.minimum(adv, is_eos.argmax(axis=1) + 1), adv)
    adv = np.where(active, np.minimum(adv, max_adv), 0)
    _commit_draft_cache(state, adv, ttoks[np.arange(ttoks.shape[0]), np.maximum(adv - 1, 0)])
    return ttoks, adv, np.where(active, acc, 0)


def _commit_draft_cache(state: ServeState, adv: np.ndarray, last: np.ndarray) -> None:
    """Roll a pool forward by `adv` tokens a slot; slots that advance take
    `last` as their newest token (JAX ``_commit_draft_cache_jit``)."""
    dev = state.last_token.device
    state.lengths[:] += adv
    state.last_token.copy_(torch.where(upload(adv > 0, dev), upload(last.astype(np.int64), dev),
                                       state.last_token))


def lookup_draft(history, k: int, ngram: int) -> np.ndarray:
    """Host-side prompt-lookup drafting (Saxena 2023) over one slot's
    committed history: continuation after the most recent earlier match
    of the last `ngram` tokens; repeats of the last token when no match
    (the verify round then degenerates to one ordinary decode step). The
    JAX package's function, with the match search vectorised."""
    h = np.asarray(history, dtype=np.int64)
    n = h.shape[0]
    out = np.full((k,), h[-1] if n else 0, dtype=np.int64)
    if n <= ngram:
        return out
    # windows starting at 0 .. n-ngram-1 (the tail's own excluded)
    hits = np.nonzero((sliding_window_view(h[: n - 1], ngram) == h[n - ngram :]).all(axis=1))[0]
    if hits.size:
        cont = h[hits[-1] + ngram : hits[-1] + ngram + k]
        out[: cont.shape[0]] = cont
    return out


def prefill_slot(pm: PaddedModel, state: ServeState, slot: int, prompt_ids, bucket: int,
                 temperature: float = 0.0, generator: Optional[torch.Generator] = None,
                 decode_attn: str = "auto", moe: str = "dense", moe_capacity: float = 2.0) -> ServeState:
    """Admit a prompt into `slot`, chunk by chunk (prompts longer than
    `bucket` are chunked). The slot's first generated token ends up in
    ``state.last_token[slot]``."""
    prompt_ids = np.asarray(prompt_ids, dtype=np.int64).reshape(-1)
    P = prompt_ids.shape[0]
    max_len = state.cache_k.shape[3]
    if P == 0:
        raise ValueError("empty prompt: a request needs at least one token")
    if P >= max_len:
        raise ValueError(f"prompt ({P} tokens) does not fit the cache (max_len {max_len})")
    attn = resolve_decode_attn(decode_attn, _device(pm))
    for piece, pos0, is_last in _chunks(prompt_ids, bucket):
        _prefill_chunk(pm, state, slot, piece, pos0, bucket, is_last, temperature, generator,
                       decode_attn=attn, moe=moe, moe_capacity=moe_capacity)
    return state


def decode_slots(pm: PaddedModel, state: ServeState, active, temperature: float = 0.0,
                 top_k=None, generator: Optional[torch.Generator] = None, top_p=None, min_p=None,
                 decode_attn: str = "auto", moe: str = "dense", moe_capacity: float = 2.0):
    """One decode step across all slots. Returns (state, tokens [slots])."""
    nxt = _one_decode_step(pm, state, active, temperature, top_k, generator, top_p=top_p,
                           min_p=min_p, decode_attn=resolve_decode_attn(decode_attn, _device(pm)),
                           moe=moe, moe_capacity=moe_capacity)
    return state, nxt


def _not_ported(names: List[str]) -> None:
    if names:
        raise NotImplementedError(f"{_MODULE}: not ported: " + ", ".join(names))


class ContinuousBatcher:
    """Host-side continuous batching over the slot table.

    submit() enqueues prompts; run() admits them into free slots, steps
    all decode-active slots together each iteration, and returns the
    finished sequences (prompt + generated tokens).

    Prefill overlaps decode: admission only records a slot's pending
    prompt chunks; each step() processes at most
    ``prefill_chunks_per_step`` chunks (round-robin across admitting
    slots; with ``prefill_exec="batched"``, that many rounds of one
    dispatch each) before the decode step of the already-active slots, so
    a long prompt never blocks decoding. Under batched prefill with
    ``mixed_prefill_decode`` (the default) the decode-active slots advance
    inside each prefill round instead.

    ``steps_per_dispatch=N`` fuses N decode steps whenever nothing is
    prefilling; ``prefix_cache`` adopts shared bucket-aligned prompt
    prefixes; ``spec_decode`` ("prompt_lookup", or "draft" with
    ``draft_pm``) commits up to ``n_draft + 1`` verified tokens a step
    (greedy only; prompt lookup matches ``lookup_ngram`` tokens). Greedy
    output is the same in every mode (the module docstring).

    ``moe``: "dense" (every expert on every token; exact) or "dispatch"
    (capacity-based token dispatch at ``moe_capacity``; nothing is
    dropped at moe_capacity >= n_experts / experts_per_tok).
    ``a8_prefill``: prefill dispatches run W8A8 on an int8 model (see the
    module docstring).
    """

    def __init__(self, pm: PaddedModel, slots: int = 8, max_len: int = 512,
                 prefill_bucket: int = 64, eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, moe: str = "dense",
                 moe_capacity: float = 2.0, prefill_chunks_per_step: int = 1,
                 spec_decode: str = "off", n_draft: int = 4,
                 lookup_ngram: int = 3, draft_pm: Optional[PaddedModel] = None,
                 kv_dtype: str = "model", steps_per_dispatch: int = 1,
                 prefill_exec: str = "per_slot",
                 top_p: Optional[float] = None, min_p: Optional[float] = None,
                 repetition_penalty: Optional[float] = None,
                 mesh=None, prefix_cache: bool = False,
                 per_request_sampling: bool = False,
                 decode_attn: str = "auto",
                 mixed_prefill_decode: bool = True,
                 a8_prefill: bool = False):
        rep_penalty = None if repetition_penalty in (None, 1.0) else repetition_penalty
        if spec_decode != "off" and (top_p or min_p or rep_penalty or per_request_sampling):
            raise ValueError("speculative serving is greedy-only: top_p/min_p/repetition_penalty/"
                             "per_request_sampling are sampling knobs it cannot honour")
        if spec_decode not in ("off", "prompt_lookup", "draft"):
            raise ValueError(f"spec_decode must be off/prompt_lookup/draft, got {spec_decode!r}")
        if spec_decode != "off" and temperature != 0.0:
            raise ValueError("speculative serving is greedy-only (temperature 0)")
        if spec_decode == "draft" and draft_pm is None:
            raise ValueError("spec_decode='draft' needs draft_pm")
        if kv_dtype not in ("model", "int8"):
            raise ValueError(f"kv_dtype must be model or int8, got {kv_dtype!r}")
        if steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
        if steps_per_dispatch > 1 and spec_decode != "off":
            raise ValueError("steps_per_dispatch > 1 requires spec_decode='off' "
                             "(speculative rounds already batch tokens per dispatch)")
        if prefill_exec not in ("per_slot", "batched"):
            raise ValueError(f"prefill_exec must be per_slot or batched, got {prefill_exec!r}")
        if moe not in ("dense", "dispatch"):
            raise ValueError(f"moe must be dense or dispatch, got {moe!r}")
        _not_ported([name for name, on in (
            ("per_request_sampling", per_request_sampling),
            ("repetition_penalty", rep_penalty is not None),
            ("mesh", mesh is not None),
        ) if on])
        self.pm = pm
        self.device = _device(pm)
        self.slots = slots
        self.max_len = max_len
        self.bucket = prefill_bucket
        self.eos = eos_token_id
        self.temperature = temperature
        self.moe = moe
        self.moe_capacity = moe_capacity
        self.top_p = top_p
        self.min_p = min_p
        self.prefill_chunks_per_step = prefill_chunks_per_step
        self.spec_decode = spec_decode
        self.n_draft = n_draft
        self.lookup_ngram = lookup_ngram
        self.steps_per_dispatch = steps_per_dispatch
        self.prefill_exec = prefill_exec
        self.mixed_prefill_decode = mixed_prefill_decode
        self.decode_attn = resolve_decode_attn(decode_attn, self.device)
        self.kv_dtype = kv_dtype
        self.state = init_serve_state(pm, slots, max_len, kv_dtype=kv_dtype)
        # the draft model's own pool, mirrored by every prefill path
        self.draft_pm = draft_pm if spec_decode == "draft" else None
        self.draft_state = (
            init_serve_state(draft_pm, slots, max_len, kv_dtype=kv_dtype) if self.draft_pm is not None else None
        )
        # W8A8 prefill: the prefill dispatches run on the int8 model's
        # W8A8 view (it shares every tensor with pm); decode stays
        # weight-only (JAX serving.py:1036-1047)
        self.a8_prefill = bool(a8_prefill)
        self.pm_pf = with_act_quant(pm) if self.a8_prefill else pm
        self.draft_pm_pf = (
            with_act_quant(self.draft_pm) if self.a8_prefill and self.draft_pm is not None else self.draft_pm
        )
        self.prefix_cache = prefix_cache
        # tokens whose KV is live in each slot's cache from a completed
        # prefill of its last prompt (decode writes land after them)
        self.slot_prompt: List[Optional[np.ndarray]] = [None] * slots
        self.prefix_hits = 0  # prefill chunks skipped through adoption
        self.prefix_tokens_reused = 0
        # per-request speculative telemetry {rid: {rounds, drafted, accepted}}
        self.stats: Dict[int, Dict[str, int]] = {}
        # (req_id, prompt, max_new, stop_seqs-or-None)
        self.queue: List[Tuple] = []
        self.slot_req: List[Optional[int]] = [None] * slots
        self.slot_out: List[List[int]] = [[] for _ in range(slots)]
        self.slot_budget = [0] * slots
        # per-request stop sequences (host-side, exact): generation ends the
        # step the generated tail contains one, and the matched tokens are
        # excluded from the output (OpenAI `stop` semantics)
        self.slot_stop: List[Optional[List[List[int]]]] = [None] * slots
        self.slot_plen = [0] * slots  # prompt length per slot
        self.slot_scanned = [0] * slots  # generated tokens already stop-scanned
        # pending prompt chunks per slot: (piece, pos0, is_last); non-empty
        # = the slot is still prefilling (not decode-active)
        self.slot_chunks: List[List] = [[] for _ in range(slots)]
        self._next_id = 0

    def submit(self, prompt_ids, max_new_tokens: int = 32,
               temperature: Optional[float] = None, top_k: Optional[int] = None,
               top_p: Optional[float] = None, min_p: Optional[float] = None,
               repetition_penalty: Optional[float] = None,
               presence_penalty: Optional[float] = None,
               frequency_penalty: Optional[float] = None,
               stop: Optional[List] = None, logprobs: bool = False,
               top_logprobs: int = 0, seed: Optional[int] = None, guide=None,
               logit_bias: Optional[Dict[int, float]] = None,
               min_tokens: int = 0) -> int:
        """Enqueue a prompt; returns its request id. `stop` is one
        token-id sequence or a list of them: generation ends as soon as
        the generated tail contains one, the matched tokens excluded.
        The other keyword options are the JAX batcher's per-request
        features and raise NotImplementedError here."""
        overrides = (temperature, top_k, top_p, min_p, repetition_penalty,
                     presence_penalty, frequency_penalty)
        _not_ported([name for name, on in (
            ("per-request sampling knobs", any(v is not None for v in overrides)),
            ("logprobs", bool(logprobs)),
            ("top_logprobs", bool(top_logprobs)),
            ("seed", seed is not None),
            ("guide", guide is not None),
            ("logit_bias", logit_bias is not None),
            ("min_tokens", int(min_tokens) > 0),
        ) if on])
        stop_seqs = None
        if stop is not None:
            if stop and isinstance(stop[0], (int, np.integer)):
                stop = [stop]
            stop_seqs = [[int(t) for t in q] for q in stop if len(q) > 0] or None
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        if prompt.shape[0] == 0:
            raise ValueError("empty prompt: a request needs at least one token")
        # speculative verify windows write n_draft+1 positions past the
        # commit point; reserve that margin
        margin = self.n_draft + 1 if self.spec_decode != "off" else 0
        if prompt.shape[0] + max_new_tokens + margin > self.max_len:
            raise ValueError(
                f"prompt ({prompt.shape[0]}) + max_new_tokens ({max_new_tokens})"
                f"{f' + draft margin ({margin})' if margin else ''} exceeds max_len ({self.max_len})"
            )
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, prompt, max_new_tokens, stop_seqs))
        return rid

    def cancel(self, rid: int) -> bool:
        """Abort a request: drop it from the queue, or free its slot at
        once (the slot is then re-admitted like a finished one: prefill
        rewrites its cache from position 0). Returns False when `rid` is
        unknown or already finished."""
        for i, (q_rid, *_rest) in enumerate(self.queue):
            if q_rid == rid:
                del self.queue[i]
                self.stats.pop(rid, None)
                return True
        for s in range(self.slots):
            if self.slot_req[s] == rid:
                self.slot_req[s] = None
                self.slot_chunks[s] = []
                self.slot_budget[s] = 0
                self.stats.pop(rid, None)
                return True
        return False

    def _slot_finished(self, s: int) -> bool:
        if self.slot_chunks[s]:
            return False  # still prefilling
        return self.slot_budget[s] <= 0 or (
            self.eos is not None and bool(self.slot_out[s]) and self.slot_out[s][-1] == self.eos
        )

    def _decode_rows(self) -> List[int]:
        """Decode-active slots: fully prefilled and unfinished (a slot that
        finished at prefill must not take a decode step)."""
        return [s for s in range(self.slots)
                if self.slot_req[s] is not None and not self.slot_chunks[s] and not self._slot_finished(s)]

    def _admit(self) -> None:
        """Assign queued requests to free slots (host bookkeeping, plus a
        slot-row copy where a prefix is adopted; the prefill runs chunk
        by chunk in `_prefill_step`)."""
        for s in range(self.slots):
            if self.slot_req[s] is None and self.queue:
                rid, prompt, budget, stop_seqs = self.queue.pop(0)
                self.slot_req[s] = rid
                self.slot_out[s] = prompt.tolist()
                self.slot_budget[s] = budget
                self.slot_stop[s] = stop_seqs
                self.slot_plen[s] = int(prompt.shape[0])
                self.slot_scanned[s] = 0
                if self.spec_decode != "off":
                    self.stats[rid] = {"rounds": 0, "drafted": 0, "accepted": 0}
                chunks = _chunks(prompt, self.bucket)
                if self.prefix_cache:
                    skip, src = self._best_prefix(prompt, len(chunks))
                    adopted = skip * self.bucket
                    if skip > 0:
                        for st in (self.state, self.draft_state):
                            if st is not None:  # the draft pool mirrored the same chunks
                                _adopt_prefix(st, src, s, adopted)
                        chunks = chunks[skip:]
                        self.prefix_hits += skip
                        self.prefix_tokens_reused += adopted
                    self.slot_prompt[s] = prompt[:adopted]
                self.slot_chunks[s] = chunks

    def _best_prefix(self, prompt: np.ndarray, n_chunks: int) -> Tuple[int, int]:
        """Longest bucket-aligned common prefix between `prompt` and any
        slot's cache-resident prefilled prompt, as (chunks to skip, source
        slot). The final chunk is never skipped: it gives the first
        token."""
        best_skip, best_src = 0, 0
        for t in range(self.slots):
            cand = self.slot_prompt[t]
            if cand is None or cand.shape[0] == 0:
                continue
            n = min(cand.shape[0], prompt.shape[0])
            neq = np.nonzero(cand[:n] != prompt[:n])[0]
            lcp = int(neq[0]) if neq.size else n
            skip = min(lcp // self.bucket, n_chunks - 1)
            if skip > best_skip:
                best_skip, best_src = skip, t
        return best_skip, best_src

    def _check_stop(self, s: int) -> None:
        """Scan slot `s`'s newly generated tokens for its stop sequences;
        on the earliest match, truncate the output at the match start and
        zero the budget so the next sweep frees the slot. Tokens are
        scanned once, minus a (max_stop_len - 1) overlap for matches that
        straddle two scans."""
        seqs = self.slot_stop[s]
        if not seqs:
            return
        plen = self.slot_plen[s]
        region = self.slot_out[s][plen:]
        n_gen = len(region)
        if n_gen == 0:
            return
        start = max(0, self.slot_scanned[s] - max(len(q) for q in seqs) + 1)
        earliest = None
        for q in seqs:
            for j in range(start, n_gen - len(q) + 1):
                if region[j : j + len(q)] == q:
                    if earliest is None or j < earliest:
                        earliest = j
                    break
        self.slot_scanned[s] = n_gen
        if earliest is not None:
            del self.slot_out[s][plen + earliest :]
            self.slot_budget[s] = 0

    def _commit(self, s: int, tok: int, prefill: bool = False) -> None:
        """Host bookkeeping for one token generated into slot `s`; a
        prefill commit first records the prompt whose KV is now resident
        (prefix caching)."""
        if prefill and self.prefix_cache:
            self.slot_prompt[s] = np.asarray(self.slot_out[s], np.int64)
        self.slot_out[s].append(tok)
        self.slot_budget[s] -= 1
        if self.eos is not None and tok == self.eos:
            self.slot_budget[s] = 0
        self._check_stop(s)

    def _prefill_step(self, generator: Optional[torch.Generator]) -> None:
        """Process up to `prefill_chunks_per_step` pending chunks,
        round-robin over the prefilling slots, mirroring each into the
        draft pool (its own commit is discarded: the target decides)."""
        if self.prefill_exec == "batched":
            return self._batched_rounds(generator, mixed=False)
        budget = self.prefill_chunks_per_step
        while budget > 0:
            pending = [s for s in range(self.slots) if self.slot_chunks[s]]
            if not pending:
                break
            for s in pending:
                if budget <= 0:
                    break
                piece, pos0, is_last = self.slot_chunks[s].pop(0)
                tok = _prefill_chunk(
                    self.pm_pf, self.state, s, piece, pos0, self.bucket, is_last,
                    self.temperature, generator, top_p=self.top_p, min_p=self.min_p,
                    decode_attn=self.decode_attn, moe=self.moe, moe_capacity=self.moe_capacity,
                )
                if self.draft_state is not None:
                    _prefill_chunk(self.draft_pm_pf, self.draft_state, s, piece, pos0, self.bucket, False,
                                   self.temperature, generator, decode_attn=self.decode_attn, moe=self.moe,
                                   moe_capacity=self.moe_capacity)
                budget -= 1
                if is_last:
                    if self.draft_state is not None:
                        self.draft_state.last_token[s] = tok
                    self._commit(s, tok, prefill=True)

    def _batched_rounds(self, generator: Optional[torch.Generator], mixed: bool) -> None:
        """Up to `prefill_chunks_per_step` rounds of one [slots, bucket]
        dispatch, each consuming the head chunk of every prefilling slot
        (JAX ``_prefill_step_batched``). With `mixed` every decode-active
        slot rides the round as a one-token commit row: its last committed
        token at pos0 = its length, both known on the host (JAX
        ``_mixed_round``)."""
        for _ in range(self.prefill_chunks_per_step):
            pending = [s for s in range(self.slots) if self.slot_chunks[s]]
            if not pending:
                break
            decode_rows = self._decode_rows() if mixed else []
            chunks = np.zeros((self.slots, self.bucket), np.int64)
            pos0 = np.zeros((self.slots,), np.int64)
            real = np.zeros((self.slots,), np.int64)
            commit = np.zeros((self.slots,), bool)
            mask = np.zeros((self.slots,), bool)
            for s in pending:
                piece, p0, is_last = self.slot_chunks[s].pop(0)
                chunks[s, : piece.shape[0]] = piece
                pos0[s], real[s], commit[s], mask[s] = p0, piece.shape[0], is_last, True
            for s in decode_rows:
                chunks[s, 0] = self.slot_out[s][-1]
                pos0[s], real[s], commit[s], mask[s] = len(self.slot_out[s]) - 1, 1, True, True
            nxt = _prefill_slots(
                self.pm_pf, self.state, chunks, pos0, real, commit, mask, self.temperature, generator,
                top_p=self.top_p, min_p=self.min_p, decode_attn=self.decode_attn, moe=self.moe,
                moe_capacity=self.moe_capacity,
            )
            if self.draft_state is not None:
                # mirror into the draft pool; its last token copies the
                # target's commits
                _prefill_slots(self.draft_pm_pf, self.draft_state, chunks, pos0, real, np.zeros_like(commit),
                               mask, self.temperature, generator, decode_attn=self.decode_attn, moe=self.moe,
                               moe_capacity=self.moe_capacity)
                self.draft_state.last_token.copy_(
                    torch.where(upload(commit, self.device), self.state.last_token, self.draft_state.last_token))
            nxt = nxt.tolist()
            for s in pending:
                if commit[s]:
                    self._commit(s, nxt[s], prefill=True)
            for s in decode_rows:
                self.slot_out[s].append(nxt[s])
                self.slot_budget[s] -= 1
                self._check_stop(s)

    def step(self, generator: Optional[torch.Generator] = None) -> Tuple[Dict[int, List[int]], bool]:
        """One scheduler iteration: sweep finished slots, admit queued
        requests, process prefill chunks, take one decode (fused or
        speculative) round; under batched prefill with mixed rounds, one
        mixed round per chunk round replaces the prefill and decode of
        the iteration while any slot prefills. Returns ``(finished,
        drained)``: `finished` maps req_id -> tokens for the requests
        swept at the top of this iteration, `drained` is True when the
        queue and every slot are empty. `generator` draws the sampled
        tokens (greedy needs none)."""
        finished: Dict[int, List[int]] = {}
        for s in range(self.slots):
            if self.slot_req[s] is not None and self._slot_finished(s):
                finished[self.slot_req[s]] = self.slot_out[s]
                self.slot_req[s] = None
        self._admit()
        if (self.mixed_prefill_decode and self.prefill_exec == "batched"
                and self.spec_decode == "off" and any(self.slot_chunks)):
            self._batched_rounds(generator, mixed=True)
            return finished, False
        self._prefill_step(generator)
        active = np.zeros((self.slots,), bool)
        active[self._decode_rows()] = True
        if not active.any():
            drained = not self.queue and all(r is None for r in self.slot_req)
            return finished, drained
        if self.spec_decode != "off":
            self._speculative_step(active)
        else:
            self._decode_round(active, generator)
        return finished, False

    def _decode_round(self, active: np.ndarray, generator: Optional[torch.Generator]) -> None:
        """One decode dispatch over the decode-active slots, fused over
        `steps_per_dispatch` steps when nothing is prefilling."""
        n = self.steps_per_dispatch if not any(self.slot_chunks) else 1
        if n == 1:
            toks = _one_decode_step(
                self.pm, self.state, active, self.temperature, None, generator,
                top_p=self.top_p, min_p=self.min_p, decode_attn=self.decode_attn,
                moe=self.moe, moe_capacity=self.moe_capacity,
            ).tolist()
            for s in np.nonzero(active)[0]:
                self._commit(s, toks[s])
            return
        budgets = np.asarray(self.slot_budget, np.int64)
        toks, emitted = _decode_slots_multi(
            self.pm, self.state, active, budgets, self.eos, n, self.temperature, generator,
            top_p=self.top_p, min_p=self.min_p, decode_attn=self.decode_attn,
            moe=self.moe, moe_capacity=self.moe_capacity,
        )
        for s in np.nonzero(active)[0]:
            new = toks[emitted[:, s], s].tolist()
            self.slot_out[s].extend(new)
            self.slot_budget[s] -= len(new)
            self._check_stop(s)

    def _speculative_step(self, active: np.ndarray) -> None:
        """One draft + verify round across the decode-active slots: each
        commits 1..n_draft+1 greedy-exact tokens."""
        k = self.n_draft
        if self.spec_decode == "draft":
            drafts = _draft_slots(self.draft_pm, self.draft_state, active, k, decode_attn=self.decode_attn,
                                  moe=self.moe, moe_capacity=self.moe_capacity)
        else:
            drafts = upload(np.stack([
                lookup_draft(self.slot_out[s], k, self.lookup_ngram) if active[s] else np.zeros(k, np.int64)
                for s in range(self.slots)
            ]), self.device)
        max_adv = np.where(active, np.asarray(self.slot_budget, np.int64), 0)
        ttoks, adv, acc = _verify_slots(self.pm, self.state, active, drafts, max_adv, self.eos,
                                        decode_attn=self.decode_attn, moe=self.moe,
                                        moe_capacity=self.moe_capacity)
        if self.draft_state is not None:
            _commit_draft_cache(self.draft_state, adv, ttoks[np.arange(self.slots), np.maximum(adv - 1, 0)])
        for s in np.nonzero(active)[0]:
            a = int(adv[s])
            self.slot_out[s].extend(ttoks[s, :a].tolist())
            self.slot_budget[s] -= a
            self._check_stop(s)
            st = self.stats[self.slot_req[s]]
            st["rounds"] += 1
            st["drafted"] += k
            st["accepted"] += int(acc[s])

    def run(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Run until the queue and all slots drain; returns {req_id: tokens}.
        Sampling draws from a generator seeded 0 on the model's device."""
        generator = torch.Generator(device=self.device).manual_seed(0)
        finished: Dict[int, List[int]] = {}
        for _ in range(max_steps):
            fin, drained = self.step(generator)
            finished.update(fin)
            if drained:
                return finished
        raise RuntimeError(f"serving loop did not drain in {max_steps} steps")
