"""Open-loop Poisson arrivals at a fixed rate against `models.serving.ContinuousBatcher`.

The model is the configuration at the compressed ranks the mix names
(``compressed_ranks``), with random weights drawn on the card from the
seed, padded by `models.padded.pad_to_uniform` and served by one batcher
with the mix's settings (``batcher``). Requests arrive at
``arrivals.rate_per_s`` as independent users send them, whether or not
earlier ones have finished; a request is a prompt of uniform random token
ids over the whole vocabulary and a number of new tokens, with no
end-of-sequence token, so it stops at its drawn length. Lengths and gaps
come from a fixed set (``pool`` prompt and answer lengths at evenly
spaced quantiles of two clipped lognormals, paired by a fixed shuffle,
and as many gaps at evenly spaced quantiles of the exponential) that the
seed only reorders and that repeats, so any ``pool`` consecutive
requests are the whole set: with ``pool`` = rate x the window's seconds,
every window offers the same work in another order. Every
``greedy_every``-th request of the set is greedy, the others sample
(``sampled``).

Set-up: weights, padding, the batcher, two warm-up requests (K3 built,
every step shape run once), then ``arrivals.warmup_s`` of the schedule,
so the window opens on a batcher in its steady state. The window's steps
are `ContinuousBatcher.step` calls, each timed on the host (a step
returns its tokens to the host); between steps the harness hands over
every request that has fallen due, and reads each step's new tokens from
the batcher's slots (as the server streams them) and its cache lengths.
After the window the schedule runs on until every request due in it has
its first token, a minute at most.

End to end (a cell reports those that ``BENCHMARK.json`` lists for it):
``itl_p95_ms``, the 95th percentile of the gaps between consecutive
tokens of every request in the window (thousands of gaps), the pace of a
stream as its user feels it, and ``ttft_p95_ms``, the 95th percentile
over every request due in the window of the time from when it fell due
to its first token (a late hand-over counts). With
``--trace 1`` the first ``trace_seconds`` of the window are traced, and
the host-clock metrics are read from the steps after them.

Correct: a sample drawn from the seed of the requests the run finished,
the longest greedy and the longest sampled among them, each run once
through the plain reference (`reference.qwen3`) over its prompt and
served tokens. ``greedy_gap``: the widest gap by which a greedy token's
logit lies below the reference's best at its position. ``sampled_gap``:
the widest gap by which a sampled token's logit lies below the least
logit of the reference's nucleus at its position (the tokens its
temperature and top_p keep). ``malformed_requests``: requests due in the
window with no first token a minute after the close, or whose tokens are
not their prompt and their number of new tokens.
"""

from __future__ import annotations

import gc
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import trace, weights
from perfbench.counts import k3, model_flops
from perfbench.reference import qwen3

POST_WINDOW_S = 60.0


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    budget: int
    greedy: bool
    t_submit: float  # when it fell due
    gen: int = 0
    times: List[float] = field(default_factory=list)
    tokens: Optional[List[int]] = None  # prompt + generated, as the batcher returned them
    t_first: Optional[float] = None
    t_done: Optional[float] = None


def length_set(spec: Dict, n: int) -> np.ndarray:
    """n lengths at evenly spaced quantiles of a lognormal (median, sigma),
    rounded and clipped to [min, max]."""
    nd = statistics.NormalDist()
    z = np.asarray([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    raw = np.rint(spec["median"] * np.exp(spec["sigma"] * z))
    return np.clip(raw, spec["min"], spec["max"]).astype(np.int64)


class Traffic:
    """The mix's requests and arrival gaps in the seed's order (each set
    cycles if a run outlasts it)."""

    def __init__(self, tr: Dict, seed: int, vocab: int):
        n = int(tr["pool"])
        fixed = np.random.default_rng(0)
        self.prompt_len = length_set(tr["prompt_len"], n)[fixed.permutation(n)]
        self.output_len = length_set(tr["output_len"], n)
        self.greedy = (np.arange(n) % int(tr["greedy_every"])) == 0
        self.order = np.random.default_rng(weights.sub_seed(seed, 6)).permutation(n)
        u = (np.arange(n) + 0.5) / n
        gaps = -np.log1p(-u) / float(tr["arrivals"]["rate_per_s"])
        self.gaps = gaps[np.random.default_rng(weights.sub_seed(seed, 4)).permutation(n)]
        self.seed, self.vocab, self.sampled = seed, vocab, tr["sampled"]
        self.next = 0

    def draw(self):
        """(prompt ids, new tokens, greedy, gap before it) of the next request."""
        i = self.next
        self.next += 1
        j = int(self.order[i % len(self.order)])
        rng = np.random.default_rng(weights.sub_seed(self.seed, 7, i))
        ids = rng.integers(0, self.vocab, int(self.prompt_len[j]), dtype=np.int64)
        return ids, int(self.output_len[j]), bool(self.greedy[j]), float(self.gaps[i % len(self.gaps)])


@dataclass
class Step:
    t0: float
    t1: float
    chunk_rows: list  # (p0, q): prefill rows
    decode_rows: list  # (p0, 1)
    tokens: int  # tokens returned: each one an LM head row


class Loop:
    """The arrivals, the batcher and the harness's record of every step."""

    def __init__(self, batcher, traffic: Traffic, generator, t0: float):
        self.b, self.traffic, self.gen = batcher, traffic, generator
        self.reqs: Dict[int, Request] = {}
        self.steps: List[Step] = []
        self.upcoming = self.traffic.draw()
        self.due = t0 + self.upcoming[3]

    def hand_over(self, now: float) -> None:
        """Submit every request that has fallen due by ``now``."""
        while self.due <= now:
            ids, budget, greedy, _ = self.upcoming
            kw = {} if greedy else dict(temperature=self.traffic.sampled["temperature"],
                                        top_p=self.traffic.sampled["top_p"])
            rid = self.b.submit(ids, max_new_tokens=budget, **kw)
            self.reqs[rid] = Request(rid, ids, budget, greedy, self.due)
            self.upcoming = self.traffic.draw()
            self.due += self.upcoming[3]

    def run_until(self, t_end: float, until=None) -> None:
        """Hand over and step until ``t_end`` (or until ``until()`` holds),
        sleeping only while the batcher has nothing to do."""
        b = self.b
        while True:
            now = time.perf_counter()
            if now >= t_end or (until is not None and until()):
                return
            self.hand_over(now)
            if b.queue or any(r is not None for r in b.slot_req):
                self.step()
            else:
                time.sleep(max(0.0, min(self.due, t_end) - now))

    def step(self) -> None:
        """One batcher step, and the harness's record of it. The prefill
        rows are the chunks the step took off a slot's pending list (a
        prompt's chunks are its ``prefill_bucket``-long pieces from offset
        0), the decode rows the tokens a slot gained besides a last chunk's
        first token; a slot's cache length is not read for them, since a
        slot admitted in the step and not yet prefilled keeps its last
        request's length."""
        b = self.b
        len0 = b.state.lengths.copy()
        req0 = list(b.slot_req)
        pending0 = [len(c) for c in b.slot_chunks]
        t0 = time.perf_counter()
        with torch.profiler.record_function("perfbench.step"):
            swept, _ = b.step(self.gen)
        t1 = time.perf_counter()
        for rid, toks in swept.items():
            if rid in self.reqs:
                self.reqs[rid].tokens = list(toks)
        chunks, decodes, n_tok = [], [], 0
        for s, rid in enumerate(b.slot_req):
            if rid is None or rid not in self.reqs:
                continue
            r = self.reqs[rid]
            plen = r.prompt.shape[0]
            total = max(1, -(-plen // b.bucket))
            first = total - pending0[s] if req0[s] == rid else 0
            last = total - len(b.slot_chunks[s])
            chunks += [(c * b.bucket, min(b.bucket, plen - c * b.bucket)) for c in range(first, last)]
            new = len(b.slot_out[s]) - plen - r.gen
            decoded = new - (1 if last == total and first < last else 0)
            if decoded > 0:
                decodes.append((plen if first < last else int(len0[s]), decoded))
            if new > 0:
                r.times.extend([t1] * new)
                r.gen += new
                n_tok += new
                if r.t_first is None:
                    r.t_first = t1
                if r.gen >= r.budget and r.t_done is None:
                    r.t_done = t1
        self.steps.append(Step(t0, t1, chunks, decodes, n_tok))

    @staticmethod
    def k3_launch_rows(st: Step) -> List[list]:
        """The row sets of the K3 launches of one layer in a per-slot step:
        one a prefill chunk, one the decode rows."""
        return [[c] for c in st.chunk_rows] + ([st.decode_rows] if st.decode_rows else [])


def warm_up(batcher, tr: Dict, generator) -> None:
    """Before the schedule starts: a greedy and a sampled request of two
    prefill chunks each, run to their end, so that K3 is built and every
    shape of the mix's steps (a chunk, a decode over every slot, the
    sampling filter) has run once."""
    bucket = tr["batcher"]["prefill_bucket"]
    prompt = np.arange(bucket + bucket // 2, dtype=np.int64)
    batcher.submit(prompt, max_new_tokens=4)
    if tr["batcher"]["per_request_sampling"]:
        batcher.submit(prompt, max_new_tokens=4, temperature=tr["sampled"]["temperature"],
                       top_p=tr["sampled"]["top_p"])
    while batcher.queue or any(r is not None for r in batcher.slot_req):
        batcher.step(generator)


def make_batcher(pm, bc: Dict):
    """A batcher with the mix's ``batcher`` settings."""
    from modegpt_tpu_torch.models.serving import ContinuousBatcher

    return ContinuousBatcher(
        pm, slots=bc["slots"], max_len=bc["max_len"], prefill_bucket=bc["prefill_bucket"],
        prefill_exec=bc["prefill_exec"], mixed_prefill_decode=bc["mixed_prefill_decode"],
        per_request_sampling=bc["per_request_sampling"], decode_attn=bc["decode_attn"], kv_dtype=bc["kv_dtype"],
    )


def compressed_spec(cfg: Dict, ranks: Dict):
    L, H, Hk = cfg["num_hidden_layers"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    rq, rv, rm = ranks["qk_per_head"], ranks["vo_per_head"], ranks["mlp"]
    return weights.spec_of(cfg).with_ranks(
        q_ranks=[H * rq] * L, k_ranks=[Hk * rq] * L, v_ranks=[Hk * rv] * L, o_ranks=[H * rv] * L,
        gate_ranks=[rm] * L, has_rotary_masks=True,
    )


def _ranks(tr: Dict):
    r = tr["compressed_ranks"]
    return r["qk_per_head"], r["vo_per_head"], r["mlp"]


def serve(ctx) -> Dict:
    """Set-up, warm-up and window; returns the record of the run, the
    program's state freed."""
    from modegpt_tpu_torch.kernels import ragged_decode as k3_mod
    from modegpt_tpu_torch.models.padded import pad_to_uniform

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    phases = {"start": time.perf_counter() - ctx.t_start}
    spec = compressed_spec(cfg, tr["compressed_ranks"])
    params = weights.model_params(cfg, ctx.seed, dev, _ranks(tr))
    pm = pad_to_uniform(spec, params)
    del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    phases["weights"] = time.perf_counter() - ctx.t_start
    bc = tr["batcher"]
    batcher = make_batcher(pm, bc)
    generator = torch.Generator(device=dev).manual_seed(weights.sub_seed(ctx.seed, 5))
    warm_up(batcher, tr, generator)
    phases["warm-up"] = time.perf_counter() - ctx.t_start
    traffic = Traffic(tr, ctx.seed, cfg["vocab_size"])
    loop = Loop(batcher, traffic, generator, time.perf_counter())

    # the schedule's first warmup_s: the window opens on a steady batcher
    loop.run_until(time.perf_counter() + float(tr["arrivals"]["warmup_s"]))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t_start
    phases["schedule"] = setup_s
    first_window_step = len(loop.steps)

    trace_s = min(float(tr["trace_seconds"]), ctx.seconds / 2) if ctx.trace else 0.0
    k3_0 = k3_mod.ragged_gqa_attend.launches
    with trace.Window(ctx.trace) as tw:
        t_open = time.perf_counter()
        loop.run_until(t_open + trace_s)
        k3_traced = k3_mod.ragged_gqa_attend.launches - k3_0
    traced_steps = len(loop.steps)
    t_untraced = time.perf_counter()  # after the profiler's stop, which may take seconds
    loop.run_until(t_untraced + ctx.seconds - trace_s)
    t_close = time.perf_counter()
    close_step = len(loop.steps)
    sent = [r for r in loop.reqs.values() if t_open <= r.t_submit < t_close]
    loop.run_until(time.perf_counter() + POST_WINDOW_S, until=lambda: all(r.t_first is not None for r in sent))
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    summary = tw.close()

    rec = {
        "t_open": t_open, "t_close": t_close, "t_untraced": t_untraced, "loop": loop,
        "window_steps": loop.steps[first_window_step:close_step],
        "traced_steps": loop.steps[first_window_step:traced_steps],
        "untraced_steps": loop.steps[traced_steps:close_step],
        "sent": sent, "trace": summary, "k3_traced_launches": k3_traced, "cfg": cfg, "ranks": _ranks(tr),
        "n_layers": cfg["num_hidden_layers"], "setup_s": setup_s, "setup_phases": phases, "memory_peak_bytes": peak,
    }
    loop.b = None
    del batcher, pm
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def end_to_end(rec: Dict) -> Dict:
    """The 95th percentiles of the time to first token of every request
    due in the window, and of the gaps between consecutive tokens of every
    request within it."""
    lo, hi = rec["t_open"], rec["t_close"]
    return {"ttft_p95_ms": percentile(ttft_ms(rec["loop"].reqs.values(), lo, hi), 95),
            "itl_p95_ms": percentile(token_gaps_ms(rec["loop"], lo, hi), 95)}


def ttft_ms(reqs, lo: float, hi: float) -> List[float]:
    """Time from falling due to the first token, of every request due in
    [lo, hi)."""
    return [1e3 * (r.t_first - r.t_submit) for r in reqs if lo <= r.t_submit < hi and r.t_first is not None]


def token_gaps_ms(loop, lo: float, hi: float) -> List[float]:
    """Gaps between consecutive tokens of each request, both within
    [lo, hi] (a token's time is the end of the step that returned it, so
    two tokens of one step are 0 apart)."""
    gaps = []
    for r in loop.reqs.values():
        ts = [t for t in r.times if lo <= t <= hi]
        gaps += [1e3 * (b - a) for a, b in zip(ts, ts[1:])]
    return gaps


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q)) if values else float("nan")


def per_layer_record(rec: Dict) -> Dict:
    """What the serving cell's per-layer readers read."""
    cfg, (rq, rv, rm) = rec["cfg"], rec["ranks"]
    steps = rec["untraced_steps"]
    lo, hi = rec["t_untraced"], rec["t_close"]
    flops = 0.0
    for st in steps:
        rows = st.chunk_rows + st.decode_rows
        keys = sum(q * p0 + q * (q + 1) // 2 for p0, q in rows)
        flops += model_flops.decode_token_flops(cfg, rq, rv, rm) * sum(q for _, q in rows)
        flops += model_flops.head_flops(cfg) * st.tokens
        flops += model_flops.attention_flops(cfg, keys, rq, rv)
    H, Hk, L = cfg["num_attention_heads"], cfg["num_key_value_heads"], rec["n_layers"]
    traced = rec["traced_steps"]
    launches = [rows for st in traced for rows in Loop.k3_launch_rows(st)]
    return {
        "ttft_ms": ttft_ms(rec["loop"].reqs.values(), lo, hi),
        "decode_step_ms": [1e3 * (st.t1 - st.t0) for st in steps if st.decode_rows and not st.chunk_rows],
        "prefill_step_ms": [1e3 * (st.t1 - st.t0) for st in steps if st.chunk_rows],
        "flops": flops, "untraced_s": hi - lo,
        "trace": rec["trace"],
        "k3_launches": rec["k3_traced_launches"],
        "k3_expected_launches": L * len(launches),
        "k3_bound_s": L * sum(k3.launch_bound_s(rows, H, Hk, rq, rv, 4) for rows in launches),
    }


def sample_for_check(rec: Dict, seed: int, n: int, token_budget: int) -> List[Request]:
    """Requests the run finished: the longest greedy and the longest
    sampled one, then others in the seed's order while the token budget
    lasts."""
    done = sorted((r for r in rec["loop"].reqs.values() if r.tokens is not None), key=lambda r: r.rid)
    out, used = [], 0
    for kind in (True, False):
        of_kind = [r for r in done if r.greedy == kind]
        if of_kind:
            out.append(max(of_kind, key=lambda r: len(r.tokens)))
            used += len(out[-1].tokens)
    for i in np.random.default_rng(weights.sub_seed(seed, 8)).permutation(len(done)):
        r = done[int(i)]
        if any(r is o for o in out) or len(out) >= n or used + len(r.tokens) > token_budget:
            continue
        out.append(r)
        used += len(r.tokens)
    return out


def nucleus_floor(logits: torch.Tensor, temperature: float, top_p: float) -> torch.Tensor:
    """[N] the least logit that temperature and top_p keep at each of N
    positions: a token stays while the probability of the tokens above it
    is under top_p, and the first always stays."""
    sorted_desc = torch.sort(logits.float() / temperature, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
    keep[:, 0] = True
    last = keep.sum(dim=-1, keepdim=True) - 1
    return sorted_desc.gather(1, last)[:, 0] * temperature


def served_gaps(cfg: Dict, params: Dict, reqs: List[Request], dev, sampled: Dict,
                tf32_control: bool = False) -> Dict[str, Dict[int, float]]:
    """Per request, the widest gap by which a served token's logit lies
    below what the float32 reference allows at its position: its best
    logit for a greedy request (``greedy``), the least logit of its
    nucleus for a sampled one (``sampled``). With ``tf32_control`` the
    greedy tokens judged are those the reference computed with TF32 puts
    first."""
    out = {"greedy": {}, "sampled": {}}
    for r in reqs:
        plen = r.prompt.shape[0]
        toks = torch.as_tensor(r.tokens, device=dev)
        ids = toks[:-1][None]
        pos = torch.arange(plen - 1, toks.shape[0] - 1, device=dev)
        chosen = toks[plen:]
        with torch.no_grad():
            with qwen3.matmul_precision(False):
                ref = qwen3.logits_at(cfg, params, ids, pos)
            if r.greedy and tf32_control:
                with qwen3.matmul_precision(True):
                    chosen = qwen3.logits_at(cfg, params, ids, pos).argmax(dim=-1)
            if r.greedy:
                floor = ref.max(dim=-1).values
            else:
                floor = nucleus_floor(ref, sampled["temperature"], sampled["top_p"])
        gap = (floor - ref.gather(1, chosen[:, None].long())[:, 0]).clamp_min(0.0)
        out["greedy" if r.greedy else "sampled"][r.rid] = float(gap.max())
    return out


def check(ctx, rec: Dict) -> Dict:
    """The compared numbers, each beside its limit."""
    cfg, tr, lim = ctx.cell.config, ctx.cell.traffic, ctx.cell.limits
    reqs = sample_for_check(rec, ctx.seed, tr["check"]["requests"], tr["check"]["tokens"])
    params = weights.model_params(cfg, ctx.seed, ctx.device, _ranks(tr))
    gaps = served_gaps(cfg, params, reqs, ctx.device, tr["sampled"])
    out = {name: {"value": max(gaps[kind].values()) if gaps[kind] else float("nan"), "limit": lim[name]}
           for kind, name in (("greedy", "greedy_gap"), ("sampled", "sampled_gap"))}
    out["malformed_requests"] = {"value": malformed(rec), "limit": lim["malformed_requests"]}
    return out


def malformed(rec: Dict) -> int:
    """Requests due in the window with no first token a minute after the
    close, or whose returned tokens are not their prompt and their number
    of new tokens."""
    bad = 0
    for r in rec["sent"]:
        if r.t_first is None:
            bad += 1
        elif r.tokens is not None and (len(r.tokens) != r.prompt.shape[0] + r.budget
                                       or list(r.tokens[: r.prompt.shape[0]]) != r.prompt.tolist()):
            bad += 1
    return bad


def run(ctx) -> Dict:
    rec = serve(ctx)
    t_check = time.perf_counter()
    checks = check(ctx, rec)
    return {"check_s": time.perf_counter() - t_check, "setup_s": rec["setup_s"],
            "setup_phases": rec["setup_phases"], "e2e": end_to_end(rec),
            "record": per_layer_record(rec), "memory_peak_bytes": rec["memory_peak_bytes"],
            "attempted": len(rec["sent"]), "failed": checks["malformed_requests"]["value"], "checks": checks}
