"""Serving core: slot-table KV cache and continuous batching.

Port of ``modegpt_tpu.models.serving`` (per-slot chunked prefill, single
step decode, `ContinuousBatcher`) over the padded stack
(`models.padded`):

* one cache pool ``[L, slots, Hk, max_len, R]`` per K and V (int8 codes
  plus per-position scales with ``kv_dtype="int8"``), allocated once and
  updated in place: admission and eviction only change host bookkeeping;
* a decode step runs every slot at its own position (per-row RoPE
  phases, per-row causal masks); idle and finished slots run masked, their
  write landing at their current length, to be rewritten on reuse;
* a prompt is prefilled into its slot in chunks of ``prefill_bucket``
  tokens (the last one right-padded), interleaved with decode steps.

Every dispatch reaches the attention of `models.padded._layer_padded`:
``decode_attn="ragged"`` is the CUDA ragged kernel (K3,
``kernels/ragged_decode.py``), whose reads cover each slot's live keys
only; ``"xla"`` is its plain version, the masked contraction over the
whole pool.
``"auto"`` takes the kernel for every dispatch on a CUDA device and the
plain path on the CPU.

Where the JAX package keeps the slot lengths on the device, the port
keeps them on the host (``ServeState.lengths``, numpy): the host decides
which cache writes fall past the pool, so none reaches the device as an
out-of-range index.

MoE models serve with every expert on every token (``moe="dense"``) or
through capacity-based token dispatch (``moe="dispatch"`` at
``moe_capacity``): each dispatch marks the tokens that may claim expert
capacity (a prefill chunk's real positions; the decode-active slots), as
the JAX step functions do.

An int8 model (`models.quantize.quantize_padded`) serves weight-only;
with ``a8_prefill`` the prefill chunks run on its W8A8 view
(`models.quantize.with_act_quant`: per-token int8 activations, int8 x
int8 -> int32 products), while decode keeps the weight-only model. On an
unquantised model the view changes nothing.

Options of the JAX batcher that this port does not have yet (speculative
decoding, batched and mixed prefill, fused multi-step decode, prefix
caching, per-request sampling, logprobs, guided decoding, logit bias,
min_tokens, repetition penalty, meshes) raise NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from modegpt_tpu_torch.models.generate import _sample
from modegpt_tpu_torch.models.padded import PaddedModel, _model_step_padded
from modegpt_tpu_torch.models.quantize import with_act_quant

__all__ = [
    "ServeState",
    "init_serve_state",
    "resolve_decode_attn",
    "prefill_slot",
    "decode_slots",
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
        tail_valid = torch.from_numpy(np.arange(bucket)[None, :] < real_len).to(dev)
    logits, _ = _model_step_padded(
        pm.spec, pm.layers, pm.other, pm.q_hd_true, torch.from_numpy(chunk).to(dev),
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
    valid = torch.from_numpy(active[:, None]).to(_device(pm)) if moe == "dispatch" else None
    logits, _ = _model_step_padded(
        pm.spec, pm.layers, pm.other, pm.q_hd_true, state.last_token[:, None],
        state.cache_k, state.cache_v, state.lengths, cache_scales=state.scales, decode_attn=decode_attn,
        moe=moe, moe_capacity=moe_capacity, token_valid=valid,
    )
    nxt = _sample(logits[:, -1, :], generator, temperature, top_k, top_p=top_p, min_p=min_p)
    state.last_token.copy_(torch.where(torch.from_numpy(active).to(nxt.device), nxt, state.last_token))
    state.lengths[active] += 1
    return nxt


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
    slots) before the decode step of the already-active slots, so a long
    prompt never blocks decoding.

    ``moe``: "dense" (every expert on every token; exact) or "dispatch"
    (capacity-based token dispatch at ``moe_capacity``; nothing is
    dropped at moe_capacity >= n_experts / experts_per_tok).
    ``a8_prefill``: prefill chunks run W8A8 on an int8 model (see the
    module docstring).
    """

    def __init__(self, pm: PaddedModel, slots: int = 8, max_len: int = 512,
                 prefill_bucket: int = 64, eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, moe: str = "dense",
                 moe_capacity: float = 2.0, prefill_chunks_per_step: int = 1,
                 spec_decode: str = "off", draft_pm: Optional[PaddedModel] = None,
                 kv_dtype: str = "model", steps_per_dispatch: int = 1,
                 prefill_exec: str = "per_slot",
                 top_p: Optional[float] = None, min_p: Optional[float] = None,
                 repetition_penalty: Optional[float] = None,
                 mesh=None, prefix_cache: bool = False,
                 per_request_sampling: bool = False,
                 decode_attn: str = "auto",
                 mixed_prefill_decode: bool = False,
                 a8_prefill: bool = False):
        if spec_decode not in ("off", "prompt_lookup", "draft"):
            raise ValueError(f"spec_decode must be off/prompt_lookup/draft, got {spec_decode!r}")
        if steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
        if prefill_exec not in ("per_slot", "batched"):
            raise ValueError(f"prefill_exec must be per_slot or batched, got {prefill_exec!r}")
        if moe not in ("dense", "dispatch"):
            raise ValueError(f"moe must be dense or dispatch, got {moe!r}")
        _not_ported([name for name, on in (
            (f"spec_decode={spec_decode!r}", spec_decode != "off"),
            ("draft_pm", draft_pm is not None),
            ("prefill_exec='batched'", prefill_exec == "batched"),
            ("mixed_prefill_decode", mixed_prefill_decode),
            ("steps_per_dispatch > 1", steps_per_dispatch > 1),
            ("prefix_cache", prefix_cache),
            ("per_request_sampling", per_request_sampling),
            ("repetition_penalty", repetition_penalty not in (None, 1.0)),
            ("mesh", mesh is not None),
        ) if on])
        self.pm = pm
        # W8A8 prefill: the prefill dispatches run on the int8 model's
        # W8A8 view (it shares every tensor with pm); decode stays
        # weight-only (JAX serving.py:1036-1047)
        self.a8_prefill = bool(a8_prefill)
        self.pm_pf = with_act_quant(pm) if self.a8_prefill else pm
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
        self.decode_attn = resolve_decode_attn(decode_attn, self.device)
        self.kv_dtype = kv_dtype
        self.state = init_serve_state(pm, slots, max_len, kv_dtype=kv_dtype)
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
        if prompt.shape[0] + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt.shape[0]}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_len ({self.max_len})"
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
                return True
        for s in range(self.slots):
            if self.slot_req[s] == rid:
                self.slot_req[s] = None
                self.slot_chunks[s] = []
                self.slot_budget[s] = 0
                return True
        return False

    def _slot_finished(self, s: int) -> bool:
        if self.slot_chunks[s]:
            return False  # still prefilling
        return self.slot_budget[s] <= 0 or (
            self.eos is not None and bool(self.slot_out[s]) and self.slot_out[s][-1] == self.eos
        )

    def _admit(self) -> None:
        """Assign queued requests to free slots (host bookkeeping only;
        the device work happens chunk by chunk in `_prefill_step`)."""
        for s in range(self.slots):
            if self.slot_req[s] is None and self.queue:
                rid, prompt, budget, stop_seqs = self.queue.pop(0)
                self.slot_req[s] = rid
                self.slot_out[s] = prompt.tolist()
                self.slot_budget[s] = budget
                self.slot_stop[s] = stop_seqs
                self.slot_plen[s] = int(prompt.shape[0])
                self.slot_scanned[s] = 0
                self.slot_chunks[s] = _chunks(prompt, self.bucket)

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

    def _commit(self, s: int, tok: int) -> None:
        """Host bookkeeping for one token generated into slot `s`."""
        self.slot_out[s].append(tok)
        self.slot_budget[s] -= 1
        if self.eos is not None and tok == self.eos:
            self.slot_budget[s] = 0
        self._check_stop(s)

    def _prefill_step(self, generator: Optional[torch.Generator]) -> None:
        """Process up to `prefill_chunks_per_step` pending chunks,
        round-robin over the prefilling slots."""
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
                budget -= 1
                if is_last:
                    self._commit(s, tok)

    def step(self, generator: Optional[torch.Generator] = None) -> Tuple[Dict[int, List[int]], bool]:
        """One scheduler iteration: sweep finished slots, admit queued
        requests, process prefill chunks, take one decode step. Returns
        ``(finished, drained)``: `finished` maps req_id -> tokens for the
        requests swept at the top of this iteration, `drained` is True
        when the queue and every slot are empty. `generator` draws the
        sampled tokens (greedy needs none)."""
        finished: Dict[int, List[int]] = {}
        for s in range(self.slots):
            if self.slot_req[s] is not None and self._slot_finished(s):
                finished[self.slot_req[s]] = self.slot_out[s]
                self.slot_req[s] = None
        self._admit()
        self._prefill_step(generator)
        # decode-active: fully prefilled, unfinished slots only (a slot that
        # finished at prefill must not take a decode step)
        active = np.asarray([
            self.slot_req[s] is not None and not self.slot_chunks[s] and not self._slot_finished(s)
            for s in range(self.slots)
        ])
        if not active.any():
            drained = not self.queue and all(r is None for r in self.slot_req)
            return finished, drained
        toks = _one_decode_step(
            self.pm, self.state, active, self.temperature, None, generator,
            top_p=self.top_p, min_p=self.min_p, decode_attn=self.decode_attn,
            moe=self.moe, moe_capacity=self.moe_capacity,
        ).tolist()
        for s in range(self.slots):
            if active[s]:
                self._commit(s, toks[s])
        return finished, False

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
