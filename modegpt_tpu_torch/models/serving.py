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

The single decode step over the whole slot table (`_one_decode_step`,
behind `decode_slots` and the batcher's unfused decode round) replays a
CUDA graph of the padded stack on a card (`models.padded.DecodeGraph`,
held by the `ServeState` with its pools): one launch in place of the
36-layer step's op-by-op issue, bit-equal to it. It stays eager on the
CPU, under tensor parallelism, with ``decode_attn="xla"``, with
``moe="dispatch"`` and while some slot's length sits at the pool's end.
Every other dispatch is issued op by op: prefill chunks, batched and
mixed rounds, fused decode, draft and verify steps.

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

Sampling (JAX ``serving.py:847-907``): greedy, or the constructor's
static knobs (temperature, top_p, min_p and a CTRL-style
``repetition_penalty``), or, with ``per_request_sampling``, each
request's own knobs in a [slots, 7] table (`generate.sample_rows`).
Every dispatch reads a `Sampling`: the knobs, the device-resident pools
(``presence`` [slots, V] bool over prompt and generated tokens,
``gen_counts`` [slots, V] int32 over generated tokens, both updated on
the card by every dispatch that commits a token, fused steps included),
per-row stream seeds, the guided ``allow`` rows (`models.guided`) and
the ``logit_bias``/``min_tokens`` bias rows. The host decides what a
dispatch needs from its own tables (which slots penalise, filter, are
seeded, guided or biased, ask for logprobs), so no decision waits for the
card; the host tables reach it through `models.padded.upload` and stay
resident until a row changes. Logprobs are the raw model's, in float32,
computed only in dispatches where some slot asks (`TOP_LP_K` = 20
alternatives for ``top_logprobs``). A seeded request draws row by row
from a hash of (seed, draw index), so its stream is the same alone, in
any batch, fused or not, prefilled per slot or batched.

Under a profiler each step, each dispatch of the padded stack and the
sampling are spans (`utils.profiling.span`).

Tensor- and expert-parallel serving (``mesh``, JAX ``serving.py:1014-1026``):
SPMD, one process per rank of a `parallel.mesh.Mesh`. The batcher
shards its model, the draft model and their pools with
`parallel.mesh.shard_serving`; every dispatch runs each rank's heads
(K3 on them on the card) and experts and reduces o and down over the
``model`` axis, so the logits, and with them every host decision, are
the same on every rank. Every rank must see the same submits and
cancels in the same order and step with generators seeded alike
(`server.follow` keeps the server's ranks so).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view

from modegpt_tpu_torch.models.generate import _sample, apply_repetition_penalty, sample_rows
from modegpt_tpu_torch.models.padded import DecodeGraph, PaddedModel, _model_step_padded, step_indices, upload
from modegpt_tpu_torch.models.quantize import with_act_quant
from modegpt_tpu_torch.utils.profiling import span

__all__ = [
    "ServeState",
    "init_serve_state",
    "resolve_decode_attn",
    "prefill_slot",
    "decode_slots",
    "lookup_draft",
    "Sampling",
    "TOP_LP_K",
    "ContinuousBatcher",
]

class ServeState(NamedTuple):
    cache_k: torch.Tensor  # [L, slots, Hk, max_len, Rq] (int8 codes when quantized)
    cache_v: torch.Tensor  # [L, slots, Hk, max_len, Rv]
    lengths: np.ndarray  # [slots] int64, host: tokens currently in each slot
    last_token: torch.Tensor  # [slots] int64 on the pool's device: newest token per slot
    # int8 KV: per-(layer, slot, head, position) scales; None = model dtype
    k_scale: Optional[torch.Tensor] = None  # [L, slots, Hk, max_len] float32
    v_scale: Optional[torch.Tensor] = None
    # the whole-table decode dispatch's CUDA graph over these pools (`models.padded.DecodeGraph`)
    graph: Optional[DecodeGraph] = None

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
        graph=DecodeGraph(),
    )


def _chunks(prompt: np.ndarray, bucket: int) -> List[Tuple[np.ndarray, int, bool]]:
    """A prompt's prefill chunks, in order: (tokens, offset, is_last),
    each at most `bucket` tokens long."""
    n = max(1, -(-prompt.shape[0] // bucket))
    return [(prompt[c * bucket : (c + 1) * bucket], c * bucket, c == n - 1) for c in range(n)]


def _step(pm: PaddedModel, state: ServeState, tokens: torch.Tensor, length, **kw):
    """`_model_step_padded` of `pm` over the whole slot table of `state`
    (a decode dispatch may replay the table's `DecodeGraph`)."""
    return _model_step_padded(pm.spec, pm.layers, pm.other, pm.q_hd_true, tokens, state.cache_k,
                              state.cache_v, length, cache_scales=state.scales, mesh=pm.mesh,
                              graph=state.graph, **kw)[0]


# device-side top-logprobs width: OpenAI caps top_logprobs at 20, and the
# host slices each request's k out of the fetched rows (JAX serving.py:181)
TOP_LP_K = 20


def _chosen_logprob(raw_logits: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """Log-probability of the chosen tokens ``nxt`` [...] under the raw
    model distribution ``raw_logits`` [..., V] (before the guide's mask,
    the bias, penalties, temperature and filters: what the model
    believed, not what the sampler drew from), in float32."""
    lp = torch.log_softmax(raw_logits.to(torch.float32), dim=-1)
    return lp.gather(-1, nxt[..., None])[..., 0]


def _top_logprobs(raw_logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-`TOP_LP_K` raw-model (ids [..., K] int64, logprobs [..., K]
    float32) at each position (OpenAI ``top_logprobs``)."""
    k = min(TOP_LP_K, raw_logits.shape[-1])
    lps, ids = torch.topk(torch.log_softmax(raw_logits.to(torch.float32), dim=-1), k, dim=-1)
    return ids, lps


@dataclass
class Sampling:
    """What a dispatch's token choice reads besides the logits, and the
    raw-model logprobs it returns besides the tokens (the JAX step
    programs' sampling operands and their lp / tids / tlps outputs).

    * static knobs (the constructor's): ``temperature``, ``top_k``,
      ``top_p``, ``min_p``, ``rep_penalty`` (over ``presence``);
    * per-request mode: ``samp``, the host knob table [slots, 7]
      (`generate.sample_rows`), ``samp_dev`` its resident copy;
      ``seeds`` [slots] int64 on the device (each row's stream seed) and
      ``counts`` [slots] on the host (each row's tokens generated so far,
      its draw index), or None to draw fresh row seeds a dispatch;
    * pools on the device, updated by every dispatch that commits:
      ``presence`` [slots, V] bool, ``gen_counts`` [slots, V] int32;
    * ``allow`` [slots, V] bool (guided rows; [slots, k+1, V] for a
      verify): disallowed tokens become -inf; ``bias`` [slots, V]
      float32 (logit_bias, -inf EOS under min_tokens) is added;
    * ``want_lp`` and ``top_lp``: the chosen tokens' logprobs land in
      ``lp``, the top-`TOP_LP_K` alternatives in ``tids``/``tlps``
      (device tensors; a fused dispatch stacks them over its steps)."""

    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    min_p: Optional[float] = None
    rep_penalty: Optional[float] = None
    presence: Optional[torch.Tensor] = None
    gen_counts: Optional[torch.Tensor] = None
    samp: Optional[np.ndarray] = None
    samp_dev: Optional[torch.Tensor] = None
    seeds: Optional[torch.Tensor] = None
    counts: Optional[np.ndarray] = None
    allow: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None
    want_lp: bool = False
    top_lp: bool = False
    lp: Optional[torch.Tensor] = None
    tids: Optional[torch.Tensor] = None
    tlps: Optional[torch.Tensor] = None

    def rows(self, view: slice) -> "Sampling":
        """The same sampling restricted to the slots of `view` (the pools
        as views, so their updates land in the full tables)."""
        def cut(a):
            return None if a is None else a[view]

        return replace(self, presence=cut(self.presence), gen_counts=cut(self.gen_counts), samp=cut(self.samp),
                       samp_dev=cut(self.samp_dev), seeds=cut(self.seeds), counts=cut(self.counts),
                       allow=cut(self.allow), bias=cut(self.bias), lp=None, tids=None, tlps=None)


def _pick(smp: Sampling, logits: torch.Tensor, generator: Optional[torch.Generator],
          commit: Optional[torch.Tensor] = None, counts: Optional[torch.Tensor] = None):
    """The next token of each row of ``logits`` [B, V] under `smp`: the
    guide's mask and the bias, then `sample_rows` (per-request mode) or
    the static penalty and `_sample`. Rows with ``commit`` [B] (every row
    when None) enter the penalty pools on the device. ``counts`` [B]
    int64 on the device: each seeded row's draw index. Returns (tokens
    [B], lp, tids, tlps), the last three None unless asked for."""
    with span("modegpt.serve.sample"):
        x = logits
        if smp.allow is not None:
            x = x.masked_fill(~smp.allow, float("-inf"))
        if smp.bias is not None:
            x = x + smp.bias.to(x.dtype)
        if smp.samp is not None:
            nxt = sample_rows(x, smp.samp, generator, smp.presence, smp.gen_counts,
                              smp.seeds, counts if smp.seeds is not None else None, smp.samp_dev)
        else:
            if smp.rep_penalty is not None:
                x = apply_repetition_penalty(x, smp.presence, smp.rep_penalty)
            nxt = _sample(x, generator, smp.temperature, smp.top_k, top_p=smp.top_p, min_p=smp.min_p)
        lp = _chosen_logprob(logits, nxt) if smp.want_lp else None
        tids, tlps = _top_logprobs(logits) if smp.top_lp else (None, None)
        rows = torch.arange(nxt.shape[0], device=nxt.device)
        if smp.presence is not None:
            mark = torch.ones_like(nxt, dtype=torch.bool) if commit is None else commit
            smp.presence[rows, nxt] = smp.presence[rows, nxt] | mark
        if smp.gen_counts is not None:
            add = torch.ones_like(nxt, dtype=torch.int32) if commit is None else commit.to(torch.int32)
            smp.gen_counts.index_put_((rows, nxt), add, accumulate=True)
        return nxt, lp, tids, tlps


def _counts_on(smp: Sampling, device) -> Optional[torch.Tensor]:
    """The seeded rows' draw indices on the device (None when unseeded)."""
    if smp.seeds is None:
        return None
    return upload(np.asarray(smp.counts, np.int64), device)


def _prefill_chunk(pm: PaddedModel, state: ServeState, slot: int, piece: np.ndarray, pos0: int,
                   bucket: int, commit: bool, temperature: float,
                   generator: Optional[torch.Generator], top_p=None, min_p=None,
                   decode_attn: str = "xla", moe: str = "dense",
                   moe_capacity: float = 2.0, sampling: Optional[Sampling] = None) -> Optional[int]:
    """Run one prompt chunk (`piece`, at most `bucket` tokens, right-padded
    to `bucket`) through `slot` at offset pos0. The pools are read and
    written through the slot's views, never copied. When `commit` is set
    (the prompt's last chunk) the next token is chosen from the last
    real position under the slot's row of `sampling` (the static knobs
    when None; a seeded row takes draw 0) and returned; else None. The
    padded tail claims no dispatch-MoE expert capacity."""
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
        moe=moe, moe_capacity=moe_capacity, token_valid=tail_valid, mesh=pm.mesh,
    )
    state.lengths[slot] = pos0 + real_len
    if not commit:
        return None
    smp = sampling if sampling is not None else Sampling(temperature=temperature, top_p=top_p, min_p=min_p)
    row = smp.rows(view)
    counts = None if row.seeds is None else torch.zeros((1,), dtype=torch.int64, device=dev)
    nxt, smp.lp, smp.tids, smp.tlps = _pick(row, logits[:, 0], generator, counts=counts)
    state.last_token[view] = nxt
    return int(nxt[0])


def _prefill_slots(pm: PaddedModel, state: ServeState, chunks: np.ndarray, pos0: np.ndarray,
                   real_len: np.ndarray, commit: np.ndarray, prefill_mask: np.ndarray,
                   temperature: float, generator: Optional[torch.Generator], top_p=None, min_p=None,
                   decode_attn: str = "xla", moe: str = "dense",
                   moe_capacity: float = 2.0, sampling: Optional[Sampling] = None) -> torch.Tensor:
    """One chunk for every row of the slot table in a single dispatch
    (JAX ``_prefill_slots_jit``): chunks [slots, bucket] at per-row
    offsets pos0, ``prefill_mask`` selecting the rows that run a chunk.
    A mixed round passes each decode-active slot as a one-token chunk of
    its last committed token at pos0 = its length, with commit set.
    The other rows sit at their length; their writes land at or past it
    (dropped past the pool) and are rewritten before anything attends
    them. Rows with ``commit`` choose their next token from their last
    real position under `sampling` (the static knobs when None) and
    enter its pools. Returns the tokens [slots] on the device
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
    smp = sampling if sampling is not None else Sampling(temperature=temperature, top_p=top_p, min_p=min_p)
    commit_dev = upload(commit, dev)
    nxt, smp.lp, smp.tids, smp.tlps = _pick(smp, logits[:, 0], generator, commit_dev, _counts_on(smp, dev))
    state.lengths[:] = np.where(prefill_mask, pos0 + real_len, state.lengths)
    state.last_token.copy_(torch.where(commit_dev, nxt, state.last_token))
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
                     moe_capacity: float = 2.0, sampling: Optional[Sampling] = None) -> torch.Tensor:
    """One decode step for ALL slots from each slot's last token at its
    own length. Inactive rows run masked: their length and last token do
    not advance, their cache write lands at their current position, to
    be overwritten on reuse, and their tokens claim no dispatch-MoE
    expert capacity and enter no pool. Returns the tokens [slots],
    chosen under `sampling` (the static knobs when None).

    On a card the dispatch replays the pools' decode graph
    (``state.graph``, `models.padded.DecodeGraph`; captured at the first
    such step), unless it runs tensor-parallel, through the plain
    attention, with dispatched experts or with a slot at the pool's end;
    those run op by op, as does every step on the CPU."""
    active = np.asarray(active, bool)
    dev = _device(pm)
    active_dev = upload(active, dev)
    valid = active_dev[:, None] if moe == "dispatch" else None
    logits = _step(pm, state, state.last_token[:, None], state.lengths, decode_attn=decode_attn,
                   moe=moe, moe_capacity=moe_capacity, token_valid=valid)
    smp = sampling if sampling is not None else Sampling(temperature=temperature, top_k=top_k, top_p=top_p,
                                                         min_p=min_p)
    nxt, smp.lp, smp.tids, smp.tlps = _pick(smp, logits[:, -1, :], generator, active_dev, _counts_on(smp, dev))
    state.last_token.copy_(torch.where(active_dev, nxt, state.last_token))
    state.lengths[active] += 1
    return nxt


def _decode_slots_multi(pm: PaddedModel, state: ServeState, active: np.ndarray, budgets: np.ndarray,
                        eos: Optional[int], n_steps: int, temperature: float,
                        generator: Optional[torch.Generator], top_p=None, min_p=None,
                        decode_attn: str = "xla", moe: str = "dense",
                        moe_capacity: float = 2.0,
                        sampling: Optional[Sampling] = None) -> Tuple[np.ndarray, np.ndarray]:
    """`n_steps` decode steps for all slots, issued without a host wait
    between them (JAX ``_decode_slots_multi_jit``). A slot stops
    advancing the step it emits EOS (decided on the card) or exhausts
    its budget (known to the host ahead), so fusing never over-decodes.

    Every step's offsets come from the host plan (a row advances one a
    step while its budget lasts) and are uploaded in one copy; the
    tokens stay on the card and are fetched once, at the end. A row that
    stopped at EOS is finished: its later writes land past its committed
    tokens and are never read. Each step chooses under `sampling` (the
    bias constant across the steps; a seeded row's draw index advances
    one a step), and only rows still emitting enter its pools; its
    logprobs come back stacked [n_steps, slots, ...]. Returns (toks
    [n_steps, slots], emitted [n_steps, slots]): the host appends the
    emitted tokens."""
    dev = _device(pm)
    active = np.asarray(active, bool)
    budgets = np.where(active, budgets, 0)
    steps = np.arange(n_steps)[:, None]
    planned = active[None, :] & (steps < budgets[None, :])  # [n, slots]
    lengths = state.lengths[None, :] + np.minimum(steps, budgets[None, :])
    index = step_indices(list(lengths), state.lengths.shape[0], 1, state.cache_k.shape[3], dev)
    plan = upload(planned, dev)
    smp = sampling if sampling is not None else Sampling(temperature=temperature, top_p=top_p, min_p=min_p)
    counts = _counts_on(smp, dev)
    alive, tok, toks, extras = plan[0], state.last_token, [], []
    for i in range(n_steps):
        valid = alive[:, None] if moe == "dispatch" else None
        logits = _step(pm, state, tok[:, None], lengths[i], index=index[i], decode_attn=decode_attn,
                       moe=moe, moe_capacity=moe_capacity, token_valid=valid)
        nxt, *picked = _pick(smp, logits[:, -1, :], generator, alive, None if counts is None else counts + i)
        toks.append(nxt)
        extras.append(picked)
        tok = torch.where(alive, nxt, tok)
        if i + 1 < n_steps:
            alive = plan[i + 1] & alive
            if eos is not None:
                alive = alive & (nxt != eos)
    smp.lp, smp.tids, smp.tlps = (None if col[0] is None else torch.stack(col) for col in zip(*extras))
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
                  moe_capacity: float = 2.0,
                  sampling: Optional[Sampling] = None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One greedy verify dispatch for all slots (JAX ``_verify_slots_jit``):
    each slot's [last token, k drafts] at its length. A slot commits the
    target's tokens up to the first rejected draft plus one, cut at an
    EOS and at ``max_adv`` (its remaining budget); inactive slots commit
    nothing, and their writes land past their length. With
    ``sampling.allow`` [slots, k+1, V] (guided rows) position j's argmax
    reads the mask of the automaton state the host walked for drafts[:j];
    ``sampling.want_lp``/``top_lp`` return the raw-model logprobs of the
    target's tokens [slots, k+1] and their alternatives. Returns (ttoks
    [slots, k+1], adv [slots], accepted drafts [slots]) on the host."""
    dev = _device(pm)
    active = np.asarray(active, bool)
    k = drafts.shape[1]
    window = torch.cat([state.last_token[:, None], drafts], dim=1)
    valid = upload(np.repeat(active[:, None], k + 1, axis=1), dev) if moe == "dispatch" else None
    logits = _step(pm, state, window, state.lengths, decode_attn=decode_attn, moe=moe,
                   moe_capacity=moe_capacity, token_valid=valid)
    smp = sampling if sampling is not None else Sampling()
    masked = logits if smp.allow is None else logits.masked_fill(~smp.allow, float("-inf"))
    target = torch.argmax(masked, dim=-1)
    smp.lp = _chosen_logprob(logits, target) if smp.want_lp else None
    smp.tids, smp.tlps = _top_logprobs(logits) if smp.top_lp else (None, None)
    both = torch.cat([target, drafts], dim=1).cpu().numpy()  # the one wait
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


class _Queued(NamedTuple):
    """A submitted request waiting for a slot."""

    rid: int
    prompt: np.ndarray
    budget: int
    samp_row: Optional[np.ndarray]
    stop: Optional[List[List[int]]]
    want_lp: bool
    top_k_lp: int
    seed: Optional[int]
    guide: object
    logit_bias: Optional[Dict[int, float]]
    min_tokens: int


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
    prefilling, no guided request is resident and no ``min_tokens``
    suppression could lift mid-dispatch; ``prefix_cache`` adopts shared
    bucket-aligned prompt prefixes; ``spec_decode`` ("prompt_lookup", or
    "draft" with ``draft_pm``) commits up to ``n_draft + 1`` verified
    tokens a step (greedy only; prompt lookup matches ``lookup_ngram``
    tokens). Greedy output is the same in every mode (the module
    docstring).

    Sampling: ``temperature``, ``top_p``, ``min_p`` and
    ``repetition_penalty`` are the static knobs; ``per_request_sampling``
    lets each `submit` carry its own (the knob table,
    `generate.sample_rows`), a seed, and the presence and frequency
    penalties. Any request may ask for logprobs and top_logprobs, a
    guide, a logit_bias or min_tokens (`submit`).

    ``moe``: "dense" (every expert on every token; exact) or "dispatch"
    (capacity-based token dispatch at ``moe_capacity``; nothing is
    dropped at moe_capacity >= n_experts / experts_per_tok).
    ``a8_prefill``: prefill dispatches run W8A8 on an int8 model (see the
    module docstring). ``mesh``: a `parallel.mesh.Mesh` to serve on, each
    rank its shard (`parallel.mesh.shard_serving`; quantise before, as
    the scales of row-parallel projections span every rank's rows).
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
        rep_penalty = None if repetition_penalty in (None, 1.0) else float(repetition_penalty)
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
        draft_pm = draft_pm if spec_decode == "draft" else None
        state = init_serve_state(pm, slots, max_len, kv_dtype=kv_dtype)
        draft_state = init_serve_state(draft_pm, slots, max_len, kv_dtype=kv_dtype) if draft_pm is not None else None
        # tensor-parallel serving (JAX serving.py:1014-1026): this rank's
        # shard of the stack and of its pools, the draft model's too;
        # every rank steps the same host decisions over its own heads
        if mesh is not None:
            from modegpt_tpu_torch.parallel.mesh import shard_serving

            pm, state = shard_serving(mesh, pm, state)
            if draft_pm is not None:
                draft_pm, draft_state = shard_serving(mesh, draft_pm, draft_state)
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
        self.rep_penalty = rep_penalty
        V = pm.spec.vocab_size
        self.vocab_size = V
        # per-request sampling: each submit may carry its own knobs (the
        # constructor's are the defaults) in a host table [slots, 7]:
        # temperature, top_k, top_p, min_p, repetition_penalty,
        # presence_penalty, frequency_penalty (JAX serving.py:876-891);
        # idle slots hold the off row, so a stale sampled row never
        # turns the filter path on for greedy steps. The table reaches
        # the card when a row changes, and stays there.
        self.per_request = per_request_sampling
        self._samp_default = np.asarray(
            [temperature, 0.0, 1.0 if top_p is None else top_p, 0.0 if min_p is None else min_p,
             1.0 if rep_penalty is None else rep_penalty, 0.0, 0.0], np.float32)
        self._samp_off = np.asarray([0.0, 0.0, 1.0, 0.0, 1.0, 0.0, 0.0], np.float32)
        self.samp = np.tile(self._samp_off, (slots, 1)) if per_request_sampling else None
        self._samp_dev: Optional[torch.Tensor] = None  # None: the host table changed since its upload
        # the penalty pools on the card, updated inside every committing
        # dispatch: presence (prompt + generated) for the repetition
        # penalty, gen_counts (generated only) for the additive ones
        self.presence = (torch.zeros((slots, V), dtype=torch.bool, device=self.device)
                         if rep_penalty is not None or per_request_sampling else None)
        self.gen_counts = (torch.zeros((slots, V), dtype=torch.int32, device=self.device)
                           if per_request_sampling else None)
        self.prefill_chunks_per_step = prefill_chunks_per_step
        self.spec_decode = spec_decode
        self.n_draft = n_draft
        self.lookup_ngram = lookup_ngram
        self.steps_per_dispatch = steps_per_dispatch
        self.prefill_exec = prefill_exec
        self.mixed_prefill_decode = mixed_prefill_decode
        self.decode_attn = resolve_decode_attn(decode_attn, self.device)
        self.kv_dtype = kv_dtype
        self.state = state
        # the draft model's own pool, mirrored by every prefill path
        self.draft_pm = draft_pm
        self.draft_state = draft_state
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
        self.queue: List[_Queued] = []
        self.slot_req: List[Optional[int]] = [None] * slots
        self.slot_out: List[List[int]] = [[] for _ in range(slots)]
        self.slot_budget = [0] * slots
        # per-request stop sequences (host-side, exact): generation ends the
        # step the generated tail contains one, and the matched tokens are
        # excluded from the output (OpenAI `stop` semantics)
        self.slot_stop: List[Optional[List[List[int]]]] = [None] * slots
        self.slot_plen = [0] * slots  # prompt length per slot
        self.slot_scanned = [0] * slots  # generated tokens already stop-scanned
        # per-request logprobs: each generated token's raw-model logprob,
        # and the requested top-k alternatives (0 = off) as (ids, lps)
        # pairs; finished requests' lists move to self.logprobs and
        # self.top_logprobs, keyed by request id
        self.slot_want_lp = [False] * slots
        self.slot_lp: List[List[float]] = [[] for _ in range(slots)]
        self.slot_top_k = [0] * slots
        self.slot_top: List[List] = [[] for _ in range(slots)]
        self.logprobs: Dict[int, List[float]] = {}
        self.top_logprobs: Dict[int, List] = {}
        # per-request seed (per-request mode): the row draws from (seed,
        # its generated count) alone, whatever else shares the batch
        self.slot_seed: List[Optional[int]] = [None] * slots
        # guided decoding (models.guided): each guided slot's TokenGuide
        # and automaton state; the host recomputes the slot's allow row
        # after every committed token
        self.slot_guide: List[Optional[object]] = [None] * slots
        self.slot_gstate: List[int] = [0] * slots
        # logit_bias ({token: bias}) and min_tokens (EOS at -inf until that
        # many tokens are generated) share one bias table, added to the
        # logits
        self.slot_bias: List[Optional[Dict[int, float]]] = [None] * slots
        self.slot_min_tokens: List[int] = [0] * slots
        # the allow and bias tables [slots, V], allocated on first use: a
        # host copy, a resident copy on the card, and the rows changed
        # since their last upload (sent before the next dispatch, so
        # submit and cancel never touch the device)
        self._tables: Dict[str, np.ndarray] = {}
        self._tables_dev: Dict[str, torch.Tensor] = {}
        self._dirty: Dict[str, set] = {"allow": set(), "bias": set()}
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
        """Enqueue a prompt; returns its request id (JAX ``submit``).

        The sampling keywords override the constructor's knobs for this
        request and need ``per_request_sampling=True``; so does `seed`,
        which makes the sampled stream a function of (seed, prompt,
        knobs) alone. `stop` is one token-id sequence or a list of them:
        generation ends as soon as the generated tail contains one, the
        matched tokens excluded. `logprobs` records each generated token's
        raw-model logprob (``batcher.logprobs[rid]`` on finish);
        `top_logprobs=k` (at most `TOP_LP_K`) also records the top-k
        alternatives (``batcher.top_logprobs[rid]``, (ids, lps) pairs).
        `guide` (a `models.guided.TokenGuide` over the model's
        vocabulary, its EOS the batcher's) restricts every token to the
        grammar; guided requests decode in single steps, compose with
        prompt lookup (repaired drafts, per-position masks) and refuse a
        draft model. `logit_bias` ({token_id: bias}) is added to the
        logits; `min_tokens` holds EOS off until that many tokens are
        generated. Neither works with speculative serving."""
        overrides = (temperature, top_k, top_p, min_p, repetition_penalty,
                     presence_penalty, frequency_penalty)
        if not self.per_request and (any(v is not None for v in overrides) or seed is not None):
            raise ValueError("per-request sampling kwargs need per_request_sampling=True "
                             "(without it the constructor's knobs hold for every request)")
        row = None
        if self.per_request:
            row = self._samp_default.copy()
            for i, v in enumerate(overrides):
                if v is not None:
                    row[i] = float(v)
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
        if guide is not None:
            if self.spec_decode == "draft":
                raise ValueError("guided decoding composes with spec_decode='prompt_lookup' (repaired drafts, "
                                 "per-position verify masks) but not 'draft': repairing a draft model's tokens "
                                 "would leave K/V of tokens it never produced in its cache")
            if guide.V != self.vocab_size:
                raise ValueError(f"guide vocab ({guide.V}) != model vocab ({self.vocab_size}); build the "
                                 "TokenGuide with vocab_size=spec.vocab_size")
            if self.eos is None or guide.eos_id != self.eos:
                raise ValueError("guided decoding needs the batcher's eos_token_id set and equal to the guide's "
                                 "eos_id (EOS is how a completed grammar terminates)")
            if guide.dead_end(guide.start):
                raise ValueError("guide grammar admits no token from its start state with this vocabulary")
        min_tokens = int(min_tokens)
        if (logit_bias is not None or min_tokens > 0) and self.spec_decode != "off":
            raise ValueError("logit_bias/min_tokens are incompatible with speculative serving "
                             "(the verify forward argmaxes raw logits)")
        if logit_bias is not None:
            logit_bias = {int(t): float(v) for t, v in logit_bias.items()}
            bad = [t for t in logit_bias if not 0 <= t < self.vocab_size]
            if bad:
                raise ValueError(f"logit_bias token ids out of range: {bad}")
            logit_bias = logit_bias or None
        if min_tokens > 0 and self.eos is None:
            raise ValueError("min_tokens needs the batcher's eos_token_id set (it works by suppressing EOS)")
        if min_tokens > 0 and guide is not None:
            raise ValueError("min_tokens cannot combine with a guide: the grammar decides when EOS is reachable")
        top_logprobs = int(top_logprobs)
        if not 0 <= top_logprobs <= TOP_LP_K:
            raise ValueError(f"top_logprobs must be in [0, {TOP_LP_K}], got {top_logprobs}")
        rid = self._next_id
        self._next_id += 1
        self.queue.append(_Queued(rid, prompt, max_new_tokens, row, stop_seqs, bool(logprobs) or top_logprobs > 0,
                                  top_logprobs, None if seed is None else int(seed) % (1 << 63), guide,
                                  logit_bias, min_tokens))
        return rid

    def cancel(self, rid: int) -> bool:
        """Abort a request: drop it from the queue, or free its slot at
        once (the slot is then re-admitted like a finished one: prefill
        rewrites its cache from position 0). Returns False when `rid` is
        unknown or already finished."""
        for i, q in enumerate(self.queue):
            if q.rid == rid:
                del self.queue[i]
                self.stats.pop(rid, None)
                return True
        for s in range(self.slots):
            if self.slot_req[s] == rid:
                self._release(s)
                self.slot_chunks[s] = []
                self.slot_budget[s] = 0
                self.stats.pop(rid, None)
                return True
        return False

    def _release(self, s: int) -> None:
        """Free slot `s`: its request's per-slot state back to off."""
        self.slot_req[s] = None
        self.slot_want_lp[s] = False
        self.slot_top_k[s] = 0
        self.slot_seed[s] = None
        self._clear_guide(s)
        self._clear_bias(s)
        if self.samp is not None and not np.array_equal(self.samp[s], self._samp_off):
            self.samp[s] = self._samp_off
            self._samp_dev = None

    # -- the dispatch's sampling --------------------------------------------

    def _live(self) -> List[int]:
        return [s for s in range(self.slots) if self.slot_req[s] is not None]

    def _sampling(self, generator: Optional[torch.Generator], slot: Optional[int] = None) -> Sampling:
        """The `Sampling` of the next dispatch, decided on the host from the
        resident requests (the JAX ``_samp_kwargs``, ``_seed_kwargs``,
        ``_guided_kwargs`` and ``_bias_kwargs``): the knob table and the
        pools, per-row seeds while a seeded request is resident, the allow
        and bias tables while some request uses them, logprobs while some
        request asks. `slot` narrows the logprob flags to one slot (a
        per-slot prefill chunk)."""
        with span("modegpt.serve.sample"):
            live = self._live() if slot is None else [slot]
            smp = Sampling(presence=self.presence, gen_counts=self.gen_counts,
                           want_lp=any(self.slot_want_lp[s] for s in live),
                           top_lp=any(self.slot_top_k[s] for s in live))
            if self.per_request:
                if self._samp_dev is None:
                    self._samp_dev = upload(self.samp, self.device)
                smp.samp, smp.samp_dev = self.samp, self._samp_dev
                if any(self.slot_seed[s] is not None for s in self._live()):
                    smp.seeds = self._seeds(generator)
                    smp.counts = np.asarray([max(0, len(self.slot_out[s]) - self.slot_plen[s])
                                             for s in range(self.slots)], np.int64)
            else:
                smp.temperature, smp.top_p, smp.min_p = self.temperature, self.top_p, self.min_p
                smp.rep_penalty = self.rep_penalty
            if any(self.slot_guide[s] is not None for s in self._live()):
                smp.allow = self._table_on_device("allow")
            if any(self.slot_bias[s] is not None or self.slot_min_tokens[s] > 0 for s in self._live()):
                smp.bias = self._table_on_device("bias")
            return smp

    def _table(self, name: str) -> np.ndarray:
        """The host copy of the allow (all True) or bias (zeros) table."""
        if name not in self._tables:
            self._tables[name] = (np.ones if name == "allow" else np.zeros)(
                (self.slots, self.vocab_size), bool if name == "allow" else np.float32)
        return self._tables[name]

    def _table_on_device(self, name: str) -> torch.Tensor:
        """The resident copy of a table, its changed rows uploaded first."""
        host = self._table(name)
        dev = self._tables_dev.get(name)
        if dev is None:
            dev = self._tables_dev[name] = upload(host, self.device)
        else:
            for s in sorted(self._dirty[name]):
                dev[s].copy_(upload(host[s], self.device))
        self._dirty[name].clear()
        return dev

    def _seeds(self, generator: Optional[torch.Generator]) -> torch.Tensor:
        """Each row's stream seed on the device: a seeded request's own,
        else a fresh draw from `generator` (a valid stream that changes
        every dispatch)."""
        host = np.zeros((2, self.slots), np.int64)
        for s in self._live():
            if self.slot_seed[s] is not None:
                host[:, s] = (self.slot_seed[s], 1)
        both = upload(host, self.device)
        fresh = torch.randint(0, 1 << 62, (self.slots,), generator=generator, device=self.device)
        return torch.where(both[1] == 1, both[0], fresh)

    def _fetch(self, smp: Sampling):
        """(lp, tids, tlps) of `smp` on the host (None where not asked)."""
        return tuple(None if t is None else t.cpu().numpy() for t in (smp.lp, smp.tids, smp.tlps))

    # -- guided decoding (models.guided) -------------------------------------

    def _set_allow_row(self, s: int, row: Optional[np.ndarray]) -> None:
        """Slot `s`'s allow row (None: every token)."""
        self._table("allow")[s] = True if row is None else row
        self._dirty["allow"].add(s)

    def _clear_guide(self, s: int) -> None:
        if self.slot_guide[s] is not None:
            self.slot_guide[s] = None
            self._set_allow_row(s, None)

    def _advance_guide(self, s: int, tok: int) -> None:
        """Walk slot `s`'s automaton over a committed token and refresh
        its allow row; a dead end (no token and no EOS reachable, possible
        only when the vocabulary cannot spell a required byte) finishes
        the request on the host."""
        guide = self.slot_guide[s]
        if guide is None or (self.eos is not None and tok == self.eos):
            return
        self.slot_gstate[s] = guide.advance(self.slot_gstate[s], tok)
        if guide.dead_end(self.slot_gstate[s]):
            self.slot_budget[s] = 0
            self._clear_guide(s)
        else:
            self._set_allow_row(s, guide.mask_for(self.slot_gstate[s]))

    # -- logit bias and min_tokens -------------------------------------------

    def _set_bias_row(self, s: int) -> None:
        """Rebuild slot `s`'s bias row: its logit_bias entries, plus -inf
        EOS while min_tokens remain."""
        row = self._table("bias")[s]
        row[:] = 0.0
        for t, v in (self.slot_bias[s] or {}).items():
            row[t] = v
        if self.slot_min_tokens[s] > 0:
            row[self.eos] = -np.inf
        self._dirty["bias"].add(s)

    def _clear_bias(self, s: int) -> None:
        if self.slot_bias[s] is not None or self.slot_min_tokens[s] > 0:
            self.slot_bias[s] = None
            self.slot_min_tokens[s] = 0
            self._set_bias_row(s)

    def _tick_min_tokens(self, s: int) -> None:
        """One token committed: count the EOS suppression down and lift
        it when the minimum is reached."""
        if self.slot_min_tokens[s] > 0:
            self.slot_min_tokens[s] -= 1
            if self.slot_min_tokens[s] == 0:
                self._set_bias_row(s)

    def _record_top(self, s: int, tids_row, tlps_row) -> None:
        """Record one generated position's top-logprob row for slot `s`,
        cut to the request's k."""
        k = self.slot_top_k[s]
        if k:
            self.slot_top[s].append(([int(t) for t in tids_row[:k]], [float(v) for v in tlps_row[:k]]))

    # -- scheduling ------------------------------------------------------------

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
        """Assign queued requests to free slots (host bookkeeping, the
        slot's pool rows reset, plus a slot-row copy where a prefix is
        adopted; the prefill runs chunk by chunk in `_prefill_step`)."""
        for s in range(self.slots):
            if self.slot_req[s] is None and self.queue:
                q = self.queue.pop(0)
                prompt = q.prompt
                self.slot_req[s] = q.rid
                self.slot_out[s] = prompt.tolist()
                self.slot_budget[s] = q.budget
                self.slot_stop[s] = q.stop
                self.slot_plen[s] = int(prompt.shape[0])
                self.slot_scanned[s] = 0
                self.slot_want_lp[s] = q.want_lp
                self.slot_lp[s] = []
                self.slot_top_k[s] = q.top_k_lp
                self.slot_top[s] = []
                self.slot_seed[s] = q.seed
                self.slot_guide[s] = q.guide
                if q.guide is not None:
                    self.slot_gstate[s] = q.guide.start
                    self._set_allow_row(s, q.guide.mask_for(q.guide.start))
                self.slot_bias[s] = q.logit_bias
                self.slot_min_tokens[s] = q.min_tokens
                if q.logit_bias is not None or q.min_tokens > 0:
                    self._set_bias_row(s)
                if q.samp_row is not None:
                    self.samp[s] = q.samp_row
                    self._samp_dev = None
                # the pools start over with the request: presence holds its
                # prompt where the request penalises repetition, gen_counts
                # nothing
                if self.presence is not None:
                    self.presence[s].zero_()
                    if self.rep_penalty is not None or (q.samp_row is not None and q.samp_row[4] != 1.0):
                        self.presence[s, upload(prompt, self.device)] = True
                if self.gen_counts is not None:
                    self.gen_counts[s].zero_()
                if self.spec_decode != "off":
                    self.stats[q.rid] = {"rounds": 0, "drafted": 0, "accepted": 0}
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
        on the earliest match, truncate the output (and its logprobs) at
        the match start and zero the budget so the next sweep frees the
        slot. Tokens are scanned once, minus a (max_stop_len - 1) overlap
        for matches that straddle two scans."""
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
            del self.slot_lp[s][earliest:]
            del self.slot_top[s][earliest:]
            self.slot_budget[s] = 0

    def _commit(self, s: int, tok: int, prefill: bool = False, lp=None, top=None) -> None:
        """Host bookkeeping for one token generated into slot `s` (with
        its logprob `lp` and top-logprob row `top` where the dispatch
        computed them); a prefill commit first records the prompt whose
        KV is now resident (prefix caching)."""
        if self.slot_want_lp[s]:
            self.slot_lp[s].append(float(lp))
        if top is not None:
            self._record_top(s, *top)
        if prefill and self.prefix_cache:
            self.slot_prompt[s] = np.asarray(self.slot_out[s], np.int64)
        self.slot_out[s].append(tok)
        self.slot_budget[s] -= 1
        self._advance_guide(s, tok)
        self._tick_min_tokens(s)
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
                smp = self._sampling(generator, slot=s) if is_last else None
                tok = _prefill_chunk(
                    self.pm_pf, self.state, s, piece, pos0, self.bucket, is_last, self.temperature, generator,
                    decode_attn=self.decode_attn, moe=self.moe, moe_capacity=self.moe_capacity, sampling=smp,
                )
                if self.draft_state is not None:
                    _prefill_chunk(self.draft_pm_pf, self.draft_state, s, piece, pos0, self.bucket, False,
                                   self.temperature, generator, decode_attn=self.decode_attn, moe=self.moe,
                                   moe_capacity=self.moe_capacity)
                budget -= 1
                if is_last:
                    if self.draft_state is not None:
                        self.draft_state.last_token[s] = tok
                    lp, tids, tlps = self._fetch(smp)
                    self._commit(s, tok, prefill=True, lp=None if lp is None else lp[0],
                                 top=None if tids is None else (tids[0], tlps[0]))

    def _batched_rounds(self, generator: Optional[torch.Generator], mixed: bool) -> None:
        """Up to `prefill_chunks_per_step` rounds of one [slots, bucket]
        dispatch, each consuming the head chunk of every prefilling slot
        (JAX ``_prefill_step_batched``). With `mixed` every decode-active
        slot rides the round as a one-token commit row: its last committed
        token at pos0 = its length, both known on the host (JAX
        ``_mixed_round``); its sampling, pools, guide, bias, seed and
        logprobs are a decode step's."""
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
            smp = self._sampling(generator)
            nxt = _prefill_slots(
                self.pm_pf, self.state, chunks, pos0, real, commit, mask, self.temperature, generator,
                decode_attn=self.decode_attn, moe=self.moe, moe_capacity=self.moe_capacity, sampling=smp,
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
            lp, tids, tlps = self._fetch(smp)
            for s in [s for s in pending if commit[s]] + decode_rows:
                self._commit(s, nxt[s], prefill=s not in decode_rows, lp=None if lp is None else lp[s],
                             top=None if tids is None else (tids[s], tlps[s]))

    def step(self, generator: Optional[torch.Generator] = None) -> Tuple[Dict[int, List[int]], bool]:
        """One scheduler iteration: sweep finished slots, admit queued
        requests, process prefill chunks, take one decode (fused or
        speculative) round; under batched prefill with mixed rounds, one
        mixed round per chunk round replaces the prefill and decode of
        the iteration while any slot prefills. Returns ``(finished,
        drained)``: `finished` maps req_id -> tokens for the requests
        swept at the top of this iteration (their logprobs move to
        ``self.logprobs`` and ``self.top_logprobs``), `drained` is True
        when the queue and every slot are empty. `generator` draws the
        sampled tokens (greedy needs none)."""
        with span("modegpt.serve.step"):
            finished: Dict[int, List[int]] = {}
            for s in range(self.slots):
                rid = self.slot_req[s]
                if rid is not None and self._slot_finished(s):
                    finished[rid] = self.slot_out[s]
                    if self.slot_want_lp[s]:
                        self.logprobs[rid] = self.slot_lp[s]
                    if self.slot_top_k[s]:
                        self.top_logprobs[rid] = self.slot_top[s]
                    self._release(s)
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
        `steps_per_dispatch` steps when nothing is prefilling, no guided
        request is resident (each guided step's mask depends on the token
        before it, which only the host's automaton knows) and no
        min_tokens suppression could lift mid-dispatch (a plain logit_bias
        is constant and fuses)."""
        min_pending = any(self.slot_min_tokens[s] > 0 for s in self._live())
        guided = any(self.slot_guide[s] is not None for s in self._live())
        n = self.steps_per_dispatch if not any(self.slot_chunks) and not guided and not min_pending else 1
        smp = self._sampling(generator)
        if n == 1:
            toks = _one_decode_step(
                self.pm, self.state, active, self.temperature, None, generator, decode_attn=self.decode_attn,
                moe=self.moe, moe_capacity=self.moe_capacity, sampling=smp,
            ).tolist()
            lp, tids, tlps = self._fetch(smp)
            for s in np.nonzero(active)[0]:
                self._commit(s, toks[s], lp=None if lp is None else lp[s],
                             top=None if tids is None else (tids[s], tlps[s]))
            return
        budgets = np.asarray(self.slot_budget, np.int64)
        toks, emitted = _decode_slots_multi(
            self.pm, self.state, active, budgets, self.eos, n, self.temperature, generator,
            decode_attn=self.decode_attn, moe=self.moe, moe_capacity=self.moe_capacity, sampling=smp,
        )
        lp, tids, tlps = self._fetch(smp)
        for s in np.nonzero(active)[0]:
            steps = np.nonzero(emitted[:, s])[0]
            self.slot_out[s].extend(toks[steps, s].tolist())
            if self.slot_want_lp[s]:
                self.slot_lp[s].extend(float(x) for x in lp[steps, s])
            if tids is not None:
                for i in steps:
                    self._record_top(s, tids[i, s], tlps[i, s])
            self.slot_budget[s] -= len(steps)
            self._check_stop(s)

    def _guided_drafts(self, active: np.ndarray, drafts: np.ndarray, max_adv: np.ndarray):
        """Guided prompt-lookup rounds (JAX ``_speculative_step``): walk
        each guided slot's drafts through its automaton, repairing the
        first disallowed token (and what follows) with an allowed one, so
        that every verify position has a live state, and build the
        per-position masks [slots, k+1, V]. The masked argmax at every
        committed position is what plain guided decode would emit.
        Returns the masks, or None when no active slot is guided;
        `drafts` and `max_adv` are repaired in place."""
        guided = [s for s in range(self.slots) if active[s] and self.slot_guide[s] is not None]
        if not guided:
            return None
        k = drafts.shape[1]
        allow = np.ones((self.slots, k + 1, self.vocab_size), bool)
        for s in guided:
            g, st, valid_upto = self.slot_guide[s], self.slot_gstate[s], k + 1
            for j in range(k + 1):
                mask = g.mask_for(st)
                if not mask.any():  # dead end: never commit at or after j
                    valid_upto = j
                    break
                allow[s, j] = mask
                if j == k:
                    break
                content = np.nonzero(mask)[0]
                content = content[content != g.eos_id]
                if content.size == 0:  # the grammar is complete: EOS at j
                    valid_upto = j + 1
                    break
                t = int(drafts[s, j])
                if not mask[t] or t == g.eos_id:
                    t = int(content[0])
                    drafts[s, j] = t
                st = g.advance(st, t)
            max_adv[s] = min(max_adv[s], valid_upto)
        return upload(allow, self.device)

    def _speculative_step(self, active: np.ndarray) -> None:
        """One draft + verify round across the decode-active slots: each
        commits 1..n_draft+1 greedy-exact tokens."""
        k = self.n_draft
        max_adv = np.where(active, np.asarray(self.slot_budget, np.int64), 0)
        smp = Sampling(want_lp=any(self.slot_want_lp[s] for s in self._live()),
                       top_lp=any(self.slot_top_k[s] for s in self._live()))
        if self.spec_decode == "draft":
            drafts = _draft_slots(self.draft_pm, self.draft_state, active, k, decode_attn=self.decode_attn,
                                  moe=self.moe, moe_capacity=self.moe_capacity)
        else:
            host = np.stack([
                lookup_draft(self.slot_out[s], k, self.lookup_ngram) if active[s] else np.zeros(k, np.int64)
                for s in range(self.slots)
            ])
            smp.allow = self._guided_drafts(active, host, max_adv)
            drafts = upload(host, self.device)
        ttoks, adv, acc = _verify_slots(self.pm, self.state, active, drafts, max_adv, self.eos,
                                        decode_attn=self.decode_attn, moe=self.moe,
                                        moe_capacity=self.moe_capacity, sampling=smp)
        if self.draft_state is not None:
            _commit_draft_cache(self.draft_state, adv, ttoks[np.arange(self.slots), np.maximum(adv - 1, 0)])
        lp, tids, tlps = self._fetch(smp)
        for s in np.nonzero(active)[0]:
            a = int(adv[s])
            committed = ttoks[s, :a].tolist()
            self.slot_out[s].extend(committed)
            if self.slot_want_lp[s]:
                self.slot_lp[s].extend(float(x) for x in lp[s, :a])
            if tids is not None:
                for j in range(a):
                    self._record_top(s, tids[s, j], tlps[s, j])
            self.slot_budget[s] -= a
            for t in committed:
                self._advance_guide(s, t)
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
