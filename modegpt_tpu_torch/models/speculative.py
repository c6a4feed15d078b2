"""Speculative decoding: a draft proposes, the target verifies.

Port of ``modegpt_tpu.models.speculative``. A MoDeGPT-compressed model
is a cheap draft for its own dense parent; the output is the TARGET's:

* greedy (temperature 0): a draft token is accepted when it equals the
  target's argmax, so the output is the target's own greedy decode;
* temperature > 0: Leviathan-style rejection sampling (Leviathan et al.
  2023; Chen et al. 2023): draft token x_i ~ p_i is accepted with
  probability min(1, q_i(x_i) / p_i(x_i)), the first rejection resamples
  from norm(max(q_i - p_i, 0)) (`residual_sample`), and a fully accepted
  window earns a bonus sample from q_k. The output is distributed as
  sampling from the target alone.

Both models run padded (`models.padded`) with caches ``[L, B, Hk,
max_len, R]`` at per-row lengths. Where the JAX package vmaps a
``while_loop`` over rows, a round here is a Python iteration over the
whole batch: k draft steps and one cache-fill step (issued without a
host wait, their offsets uploaded once), then one (k+1)-token verify
forward of the target, then one fetch of the round's tokens. Each row
advances at its own acceptance; a finished row is frozen (its counters
and lengths stop; its writes in later rounds land past its committed
tokens and are never read). The cache attention is
``decode_attn="auto"``: K3 on a CUDA device, its plain version on the
CPU. Sampled mode draws from a ``torch.Generator`` on the model's device
where the JAX functions take a PRNG key.

`prompt_lookup_generate` drafts from each sequence's own history
(Saxena 2023) instead of a draft model; greedy-exact.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view

from modegpt_tpu_torch.models.padded import PaddedModel, _model_step_padded, init_cache_padded, step_indices, upload
from modegpt_tpu_torch.models.serving import resolve_decode_attn

__all__ = ["speculative_generate", "prompt_lookup_generate", "residual_sample", "SpecDecodeStats"]


class SpecDecodeStats(NamedTuple):
    """Per-sequence telemetry from one speculative generation call (host
    int64 arrays [B])."""

    rounds: np.ndarray  # target forwards after the prefill
    drafted: np.ndarray  # draft tokens proposed
    accepted: np.ndarray  # draft tokens accepted


class _Padded:
    """One padded model with its cache at per-row host lengths."""

    def __init__(self, pm: PaddedModel, B: int, max_len: int, dtype, attn: str):
        self.pm, self.attn, self.max_len = pm, attn, max_len
        self.k, self.v, _ = init_cache_padded(pm, B, max_len, dtype)
        self.lengths = np.zeros((B,), np.int64)

    def step(self, tokens: torch.Tensor, lengths, index=None) -> torch.Tensor:
        pm = self.pm
        return _model_step_padded(pm.spec, pm.layers, pm.other, pm.q_hd_true, tokens, self.k, self.v, lengths,
                                  decode_attn=self.attn, index=index)[0]

    def draft(self, last: torch.Tensor, k: int, temperature: float, generator):
        """k draft tokens from `last` [B] at each row's length, plus the
        cache-fill step; returns (drafts [B, k], their distributions
        [B, k, V] when sampling, else None). Lengths do not move."""
        B = last.shape[0]
        lengths = [self.lengths + i for i in range(k + 1)]
        index = step_indices(lengths, B, 1, self.max_len, last.device)
        tok, toks, dists = last, [], []
        for i in range(k + 1):
            logits = self.step(tok[:, None], lengths[i], index[i])[:, -1]
            if i == k:
                break
            if temperature > 0.0:
                p = torch.softmax(logits.float() / temperature, dim=-1)
                tok = torch.multinomial(p, 1, generator=generator)[:, 0]
                dists.append(p)
            else:
                tok = torch.argmax(logits, dim=-1)
            toks.append(tok)
        return torch.stack(toks, dim=1), torch.stack(dists, dim=1) if dists else None


def residual_sample(q: torch.Tensor, p: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Sample from norm(max(q - p, 0)), the rejection-sampling residual,
    for each row of [..., V] probability vectors; a row whose residual
    has no mass (p == q up to rounding) samples q."""
    r = torch.clamp(q - p, min=0.0)
    rs = r.sum(dim=-1, keepdim=True)
    r = torch.where(rs > 0, r / torch.clamp(rs, min=1e-30), q)
    flat = r.reshape(-1, r.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(r.shape[:-1])


def _accept(committed: np.ndarray, a: np.ndarray, eos: Optional[int]):
    """adv (tokens to commit) and done (EOS among them) per row, from
    the round's candidate tokens [B, k+1] and accepted drafts [B]."""
    adv = a + 1
    done = np.zeros(adv.shape, bool)
    if eos is not None:
        is_eos = committed == eos
        done = (is_eos & (np.arange(committed.shape[1])[None, :] < adv[:, None])).any(axis=1)
        adv = np.where(done, np.minimum(adv, is_eos.argmax(axis=1) + 1), adv)
    return adv, done


def _finish(prompt_ids: torch.Tensor, new: np.ndarray, eos: Optional[int]) -> torch.Tensor:
    """Prompt + new tokens; positions after a row's first EOS repeat EOS."""
    if eos is not None:
        is_eos = new == eos
        after = is_eos.any(axis=1)[:, None] & (np.arange(new.shape[1])[None, :] > is_eos.argmax(axis=1)[:, None])
        new = np.where(after, eos, new)
    return torch.cat([prompt_ids, torch.from_numpy(new).to(prompt_ids.device)], dim=1)


def _first(logits: torch.Tensor, temperature: float, generator) -> torch.Tensor:
    if temperature > 0.0:
        return torch.multinomial(torch.softmax(logits.float() / temperature, dim=-1), 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)


@torch.no_grad()
def speculative_generate(
    draft: PaddedModel,
    target: PaddedModel,
    prompt_ids,
    max_new_tokens: int = 32,
    n_draft: int = 4,
    eos_token_id: Optional[int] = None,
    max_len: Optional[int] = None,
    return_stats: bool = False,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    decode_attn: str = "auto",
):
    """Speculative decoding batched over sequences (each row advances at
    its own acceptance rate; finished rows are frozen).

    temperature == 0 (default): the output is the target model's own
    greedy decode. temperature > 0: rejection-sampling verification (the
    module docstring), distributed as sampling from the target at this
    temperature; pass a `generator` on the models' device.

    Returns [B, prompt + new] token ids on the models' device and, with
    return_stats, the per-sequence `SpecDecodeStats`."""
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 requires a torch.Generator `generator`")
    dev = target.other["embed_tokens"].device
    prompt_ids = torch.as_tensor(prompt_ids).to(dev, torch.int64)
    B, P = prompt_ids.shape
    k = n_draft
    max_len = P + max_new_tokens + k + 1 if max_len is None else max_len
    attn = resolve_decode_attn(decode_attn, dev)
    dtype = target.other["embed_tokens"].dtype
    d, t = _Padded(draft, B, max_len, dtype, attn), _Padded(target, B, max_len, dtype, attn)
    # prefill; each cache then holds every committed token but the newest
    d.step(prompt_ids, 0)
    first = _first(t.step(prompt_ids, 0)[:, -1], temperature, generator)
    d.lengths[:] = t.lengths[:] = P
    buf = np.zeros((B, max_new_tokens + k + 1), np.int64)
    last = first.cpu().numpy()
    buf[:, 0] = last
    n_gen = np.full((B,), min(1, max_new_tokens), np.int64)
    done = last == eos_token_id if eos_token_id is not None else np.zeros((B,), bool)
    rounds, drafted, accepted = (np.zeros((B,), np.int64) for _ in range(3))
    while True:
        live = (n_gen < max_new_tokens) & ~done
        if not live.any():
            break
        last_dev = upload(last, dev)
        dtoks, p_all = d.draft(last_dev, k, temperature, generator)
        tlogits = t.step(torch.cat([last_dev[:, None], dtoks], dim=1), t.lengths)
        if temperature > 0.0:
            q_all = torch.softmax(tlogits.float() / temperature, dim=-1)  # [B, k+1, V]
            u = torch.rand((B, k), generator=generator, device=dev)
            q_x = q_all[:, :k].gather(-1, dtoks[..., None])[..., 0]
            p_x = p_all.gather(-1, dtoks[..., None])[..., 0]
            a = torch.cumprod((u * p_x < q_x).long(), dim=1).sum(dim=1)
            rows = torch.arange(B, device=dev)
            a_c = torch.clamp(a, max=k - 1)
            t_res = residual_sample(q_all[rows, a_c], p_all[rows, a_c], generator)
            t_bonus = torch.multinomial(q_all[:, k], 1, generator=generator)[:, 0]
            repl = torch.where(a == k, t_bonus, t_res)
            host = torch.cat([dtoks, a[:, None], repl[:, None]], dim=1).cpu().numpy()  # the round's one wait
            a = host[:, k]
            committed = np.concatenate([host[:, :k], np.zeros((B, 1), np.int64)], axis=1)
            committed[np.arange(B), a] = host[:, k + 1]
        else:
            host = torch.cat([dtoks, torch.argmax(tlogits, dim=-1)], dim=1).cpu().numpy()  # the round's one wait
            committed = host[:, k:]
            a = np.cumprod(host[:, :k] == committed[:, :k], axis=1).sum(axis=1)
        adv, hit = _accept(committed, a, eos_token_id)
        for b in np.nonzero(live)[0]:
            buf[b, n_gen[b] : n_gen[b] + k + 1] = committed[b]
            last[b] = committed[b, adv[b] - 1]
        adv = np.where(live, adv, 0)
        d.lengths += adv
        t.lengths += adv
        n_gen = np.where(live, np.minimum(n_gen + adv, max_new_tokens), n_gen)
        done |= live & hit
        rounds += live
        drafted += live * k
        accepted += np.where(live, a, 0)
    out = _finish(prompt_ids, buf[:, :max_new_tokens], eos_token_id)
    stats = SpecDecodeStats(rounds=rounds, drafted=drafted, accepted=accepted)
    return (out, stats) if return_stats else out


def _lookup(hist: np.ndarray, h_len: int, k: int, ngram: int) -> np.ndarray:
    """The continuation after the most recent earlier match of the last
    `ngram` committed tokens, read from the history buffer as the JAX
    program reads it; repeats of the last token when nothing matches."""
    hits = np.nonzero((sliding_window_view(hist[: h_len - 1], ngram) == hist[h_len - ngram : h_len]).all(axis=1))[0]
    if hits.size:
        return hist[hits[-1] + ngram : hits[-1] + ngram + k].copy()
    return np.full((k,), hist[h_len - 1], np.int64)


@torch.no_grad()
def prompt_lookup_generate(
    pm: PaddedModel,
    prompt_ids,
    max_new_tokens: int = 32,
    n_draft: int = 8,
    ngram: int = 3,
    eos_token_id: Optional[int] = None,
    max_len: Optional[int] = None,
    return_stats: bool = False,
    decode_attn: str = "auto",
):
    """Draft-model-free greedy speculative decoding: drafts come from
    n-gram matches against each sequence's own history (prompt lookup),
    verified by one (k+1)-token forward a round; the output is the
    model's own greedy decode. Returns [B, prompt + new] token ids on the
    model's device and, with return_stats, the `SpecDecodeStats`."""
    dev = pm.other["embed_tokens"].device
    prompt_ids = torch.as_tensor(prompt_ids).to(dev, torch.int64)
    B, P = prompt_ids.shape
    if ngram >= P:
        raise ValueError(f"ngram ({ngram}) must be shorter than the prompt ({P})")
    k = n_draft
    max_len = P + max_new_tokens + k + 1 if max_len is None else max_len
    m = _Padded(pm, B, max_len, pm.other["embed_tokens"].dtype, resolve_decode_attn(decode_attn, dev))
    first = torch.argmax(m.step(prompt_ids, 0)[:, -1], dim=-1).cpu().numpy()
    m.lengths[:] = P
    hist = np.zeros((B, P + max_new_tokens + k + 1), np.int64)
    hist[:, :P] = prompt_ids.cpu().numpy()
    hist[:, P] = first
    h_len = np.full((B,), P + 1, np.int64)
    last = first.copy()
    n_gen = np.full((B,), min(1, max_new_tokens), np.int64)
    done = first == eos_token_id if eos_token_id is not None else np.zeros((B,), bool)
    rounds, drafted, accepted = (np.zeros((B,), np.int64) for _ in range(3))
    while True:
        live = (n_gen < max_new_tokens) & ~done
        if not live.any():
            break
        drafts = np.stack([_lookup(hist[b], h_len[b], k, ngram) for b in range(B)])
        window = upload(np.concatenate([last[:, None], drafts], axis=1), dev)
        ttoks = torch.argmax(m.step(window, m.lengths), dim=-1).cpu().numpy()  # the round's one wait
        a = np.cumprod(drafts == ttoks[:, :k], axis=1).sum(axis=1)
        adv, hit = _accept(ttoks, a, eos_token_id)
        for b in np.nonzero(live)[0]:
            hist[b, h_len[b] : h_len[b] + k + 1] = ttoks[b]
            last[b] = ttoks[b, adv[b] - 1]
        adv = np.where(live, adv, 0)
        m.lengths += adv
        h_len += adv
        n_gen = np.where(live, np.minimum(n_gen + adv, max_new_tokens), n_gen)
        done |= live & hit
        rounds += live
        drafted += live * k
        accepted += np.where(live, a, 0)
    new = hist[np.arange(B)[:, None], P + np.arange(max_new_tokens)[None, :]]
    out = _finish(prompt_ids, new, eos_token_id)
    stats = SpecDecodeStats(rounds=rounds, drafted=drafted, accepted=accepted)
    return (out, stats) if return_stats else out
