"""Parity: per-request sampling in the port against the JAX package.

`generate.sample_rows` against JAX's on the same numpy-seeded logits,
penalty pools and knob tables (5 and 7 columns): greedy rows token for
token, penalised logits to 1e-6, each row's kept set under top-k, top-p
and min-p (degenerate knobs included) against the set JAX keeps, and
sampled rows by distribution against the softmax of the kept set. Then
the batcher: greedy requests with penalties, logprobs and top_logprobs,
logit_bias, min_tokens and stop sequences give the JAX batcher's tokens
and logprobs per slot, batched, mixed and fused, and under prompt
lookup; a seeded request gives the same tokens alone, in a mixed batch,
fused and under batched prefill; the refusals are JAX's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from modegpt_tpu.models import params_from_hf_model as j_params_from_hf  # noqa: E402
from modegpt_tpu.models.generate import sample_rows as j_sample_rows  # noqa: E402
from modegpt_tpu.models.padded import pad_to_uniform as j_pad  # noqa: E402
from modegpt_tpu.models.serving import ContinuousBatcher as JBatcher  # noqa: E402
from modegpt_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from modegpt_tpu_torch.models.generate import filter_rows, penalize_rows, sample_rows  # noqa: E402
from modegpt_tpu_torch.models.padded import pad_to_uniform as t_pad  # noqa: E402
from modegpt_tpu_torch.models.serving import ContinuousBatcher as TBatcher  # noqa: E402
from modegpt_tpu_torch.models.spec import ModelSpec as TSpec  # noqa: E402

# (temperature, top_k, top_p, min_p, repetition, presence, frequency):
# every filter alone and together, the off-sentinels, and degenerate
# knobs (top_p 0, min_p >= 1, top_k 1 and past V)
ROWS = np.asarray([
    [0.0, 0, 1.0, 0.0, 1.0, 0.0, 0.0],
    [1.0, 0, 1.0, 0.0, 1.0, 0.0, 0.0],
    [0.7, 10, 1.0, 0.0, 1.0, 0.0, 0.0],
    [1.0, 0, 0.9, 0.0, 1.0, 0.0, 0.0],
    [1.3, 0, 1.0, 0.05, 1.0, 0.0, 0.0],
    [0.8, 20, 0.95, 0.02, 1.2, 0.4, 0.3],
    [0.9, 0, 0.8, 0.0, 1.5, 0.0, 0.0],
    [0.0, 0, 1.0, 0.0, 2.0, 1.1, 0.6],
    [1.0, 0, 0.0, 0.0, 1.0, 0.0, 0.0],
    [1.0, 0, 1.0, 1.0, 1.0, 0.0, 0.0],
    [1.0, 0, 1.0, 5.0, 1.0, 0.0, 0.0],
    [1.0, 1, 1.0, 0.0, 1.0, 0.0, 0.0],
    [0.6, 500, 0.5, 0.1, 1.0, 0.9, 0.0],
], np.float32)


def _inputs(seed, S=len(ROWS), V=97):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((S, V)) * 3.0).astype(np.float32)
    presence = rng.random((S, V)) < 0.1
    counts = rng.integers(0, 3, (S, V)).astype(np.int32) * (rng.random((S, V)) < 0.1)
    return logits, presence, counts.astype(np.int32)


def _jax_final(monkeypatch, logits, samp, presence, counts):
    """JAX's sample_rows on these inputs, and the filtered logits its draw
    reads (caught at `jax.random.categorical`)."""
    caught = []

    def categorical(key, final, axis=-1):
        caught.append(np.asarray(final))
        return jnp.argmax(final, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    out = j_sample_rows(jnp.asarray(logits), jax.random.key(0), jnp.asarray(samp), jnp.asarray(presence),
                        gen_counts=jnp.asarray(counts))
    return np.asarray(out), caught[0]


@pytest.mark.parametrize("cols", [5, 7])
def test_penalised_logits_equal_jax(monkeypatch, cols):
    """Repetition, then presence and frequency penalties: at temperature 1
    without filters JAX's draw reads exactly the penalised logits."""
    logits, presence, counts = _inputs(0)
    samp = ROWS[:, :cols].copy()
    samp[:, 0], samp[:, 1], samp[:, 2], samp[:, 3] = 1.0, 0.0, 1.0, 0.0
    _, want = _jax_final(monkeypatch, logits, samp, presence, counts)
    got = penalize_rows(torch.from_numpy(logits), samp, torch.from_numpy(presence), torch.from_numpy(counts))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cols", [5, 7])
def test_greedy_rows_equal_jax(cols):
    """Greedy rows (temperature 0) are JAX's argmax of the penalised logits,
    whatever their filters."""
    for seed in range(4):
        logits, presence, counts = _inputs(seed)
        samp = ROWS[:, :cols].copy()
        samp[:, 0] = 0.0
        want = j_sample_rows(jnp.asarray(logits), jax.random.key(1), jnp.asarray(samp), jnp.asarray(presence),
                             gen_counts=jnp.asarray(counts))
        got = sample_rows(torch.from_numpy(logits), samp, torch.Generator().manual_seed(0),
                          torch.from_numpy(presence), torch.from_numpy(counts))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kept_sets_equal_jax(monkeypatch):
    """Each row's kept set under top-k, top-p and min-p (every filter keeps
    rank 0; tie-inclusive thresholds) is the set above JAX's threshold on
    the same logits, and the kept logits are JAX's."""
    for seed in range(3):
        logits, presence, counts = _inputs(10 + seed)
        _, want = _jax_final(monkeypatch, logits, ROWS, presence, counts)
        x = penalize_rows(torch.from_numpy(logits), ROWS, torch.from_numpy(presence), torch.from_numpy(counts))
        got = filter_rows(x / torch.clamp(torch.from_numpy(ROWS[:, :1]), min=1e-6), ROWS).numpy()
        thr = np.where(np.isfinite(want), want, np.inf).min(axis=1, keepdims=True)
        np.testing.assert_array_equal(np.isfinite(got), got >= thr)
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], rtol=1e-6)
        kept = np.isfinite(got).sum(axis=1)
        assert (kept[8:12] == 1).all() and kept[1] == logits.shape[1]  # degenerate knobs keep the argmax


def _tv(draws, probs):
    freq = np.bincount(draws, minlength=probs.shape[0]) / draws.shape[0]
    return 0.5 * np.abs(freq - probs).sum()


def test_sampled_rows_follow_the_kept_softmax():
    """4000 draws at V = 16 from one row (counts 0..3999 under one seed,
    then fresh seeds from a generator) stay in the kept set and follow
    the softmax of the kept logits: total variation under 0.05 (about
    0.02 expected at this count). The same seeds and counts give the
    same draws; a row's draw does not depend on the other rows."""
    rng = np.random.default_rng(3)
    row = (rng.standard_normal(16) * 1.5).astype(np.float32)
    knobs = np.asarray([[0.8, 12, 0.92, 0.02, 1.0]], np.float32)
    n = 4000
    logits = torch.from_numpy(np.tile(row, (n, 1)))
    samp = np.tile(knobs, (n, 1))
    final = filter_rows(torch.from_numpy(row[None]) / 0.8, knobs)[0]
    probs = torch.softmax(final, -1).numpy()
    seeds = torch.full((n,), 123, dtype=torch.int64)
    counts = torch.arange(n, dtype=torch.int64)
    draws = sample_rows(logits, samp, seeds=seeds, counts=counts).numpy()
    assert np.isfinite(final.numpy()[draws]).all()
    assert _tv(draws, probs) < 0.05
    assert np.array_equal(draws, sample_rows(logits, samp, seeds=seeds, counts=counts).numpy())
    assert not np.array_equal(draws, sample_rows(logits, samp, seeds=seeds + 1, counts=counts).numpy())
    # one row alone draws what it drew among the 4000
    np.testing.assert_array_equal(
        sample_rows(logits[7:8], samp[7:8], seeds=seeds[7:8], counts=counts[7:8]).numpy(), draws[7:8])
    fresh = sample_rows(logits, samp, torch.Generator().manual_seed(0)).numpy()
    assert _tv(fresh, probs) < 0.05
    assert np.array_equal(fresh, sample_rows(logits, samp, torch.Generator().manual_seed(0)).numpy())


def _hf(seed=0):
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=144, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
    )
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(cfg).eval()


@pytest.fixture(scope="module")
def pair():
    j_spec, j_params = j_params_from_hf(_hf(0))
    t_spec = TSpec.from_dict(j_spec.to_dict())
    return j_pad(j_spec, j_params), t_pad(t_spec, params_from_numpy(jax.device_get(j_params), "cpu"))


KW = dict(slots=2, max_len=96, prefill_bucket=16, eos_token_id=127)
EOS = 127


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 127, size=(n,)).astype(np.int32) for n in lengths]


def _serve(cls, pm, requests, **kw):
    """Serve `requests` ((prompt, budget, submit kwargs) each); returns, per
    request, (tokens, logprobs, top_logprobs)."""
    b = cls(pm, **{**KW, **kw})
    rids = [b.submit(p, max_new_tokens=n, **rkw) for p, n, rkw in requests]
    done = b.run()
    return [(list(map(int, done[r])), b.logprobs.get(r), b.top_logprobs.get(r)) for r in rids]


def _assert_same(got, want):
    for (gt, gl, gtop), (wt, wl, wtop) in zip(got, want):
        assert gt == wt
        assert (gl is None) == (wl is None) and (gtop is None) == (wtop is None)
        if wl is not None:
            np.testing.assert_allclose(gl, wl, atol=1e-5)
        if wtop is not None:
            assert [ids for ids, _ in gtop] == [ids for ids, _ in wtop]
            np.testing.assert_allclose([lps for _, lps in gtop], [lps for _, lps in wtop], atol=1e-5)


@pytest.fixture(scope="module")
def stop_seq(pair):
    """A stop sequence that the penalised request's greedy output contains
    (its 4th and 5th generated tokens), found by the JAX batcher."""
    prompt = _prompts((21,), seed=5)[0]
    (toks, _, _), = _serve(JBatcher, pair[0], [(prompt, 9, {})])
    return toks[21 + 3 : 21 + 5]


MODES = {
    "per_slot": dict(),
    "batched": dict(prefill_exec="batched", mixed_prefill_decode=False),
    "mixed_fused": dict(prefill_exec="batched", steps_per_dispatch=4),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_requests_equal_jax_batcher(pair, stop_seq, mode):
    """Greedy requests with penalties, logprobs and top_logprobs, a
    logit_bias with min_tokens, and a stop sequence, beside a sampled
    request, on a per-request batcher: the JAX batcher's tokens, and its
    logprobs to 1e-5, in each execution mode."""
    p = _prompts((21, 9, 30, 5), seed=5)
    requests = [
        (p[0], 9, dict(stop=stop_seq, logprobs=True)),
        (p[1], 7, dict(repetition_penalty=1.3, presence_penalty=0.4, frequency_penalty=0.3, top_logprobs=3)),
        (p[2], 8, dict(logit_bias={EOS: 100.0, 5: 2.0}, min_tokens=3, logprobs=True)),
        (p[3], 6, dict(temperature=0.9, top_p=0.9, seed=4)),
        (p[1], 5, dict(repetition_penalty=1.5, logit_bias={9: -100.0}, top_logprobs=2)),
    ]
    kw = dict(MODES[mode], per_request_sampling=True)
    want = _serve(JBatcher, pair[0], requests, **kw)
    got = _serve(TBatcher, pair[1], requests, **kw)
    greedy = [0, 1, 2, 4]
    _assert_same([got[i] for i in greedy], [want[i] for i in greedy])
    assert len(got[0][0]) == 21 + 3 and got[0][0][21:] == want[0][0][21:]  # cut at the stop sequence
    assert got[2][0][30 + 3 :] == [EOS]  # min_tokens held EOS for 3 tokens
    assert len(got[3][0]) == 5 + 6 and all(0 <= t < 128 for t in got[3][0])


def test_prompt_lookup_logprobs_equal_jax(pair):
    """Prompt lookup with logprobs, top_logprobs and a stop sequence: the
    verify dispatch's raw-model logprobs are the JAX batcher's."""
    base = _prompts((12,), seed=8)[0]
    prompt = np.concatenate([base, base, base[:6]])
    requests = [(prompt, 10, dict(logprobs=True, top_logprobs=4)), (base, 8, dict(logprobs=True))]
    kw = dict(spec_decode="prompt_lookup", n_draft=3)
    _assert_same(_serve(TBatcher, pair[1], requests, **kw), _serve(JBatcher, pair[0], requests, **kw))


def test_static_repetition_penalty_equals_jax(pair):
    """The constructor's repetition_penalty (no per-request table): JAX's
    greedy tokens and logprobs, per slot and fused."""
    requests = [(p, 8, dict(logprobs=True)) for p in _prompts((7, 18, 3), seed=9)]
    for kw in (dict(repetition_penalty=1.4), dict(repetition_penalty=1.4, steps_per_dispatch=3)):
        _assert_same(_serve(TBatcher, pair[1], requests, **kw), _serve(JBatcher, pair[0], requests, **kw))


def test_seeded_stream_is_the_same_alone_batched_fused_and_mixed(pair):
    """A seeded request's sampled tokens depend on its seed, prompt and
    knobs alone: the same alone, beside other traffic in a later slot,
    with steps_per_dispatch=4 and with prefill_exec="batched" (mixed
    rounds); another seed changes them."""
    tpm = pair[1]
    prompt, other = _prompts((19, 33), seed=11)
    knobs = dict(temperature=0.9, top_k=40, top_p=0.95, min_p=0.01, repetition_penalty=1.1,
                 frequency_penalty=0.2)

    def run(seed, traffic, **kw):
        b = TBatcher(tpm, **{**KW, "slots": 3}, per_request_sampling=True, **kw)
        before = [b.submit(other, 12, temperature=t) for t in traffic]
        rid = b.submit(prompt, 12, seed=seed, **knobs)
        after = [b.submit(other, 5, temperature=0.7, seed=99)]
        out = b.run(max_steps=2000)
        assert set(out) == set(before + [rid] + after)
        return out[rid]

    alone = run(7, [])
    assert len(alone) == 19 + 12
    assert run(7, [0.0, 1.2]) == alone
    assert run(7, [0.8], steps_per_dispatch=4) == alone
    assert run(7, [0.0], prefill_exec="batched") == alone
    assert run(7, [1.0, 0.0], prefill_exec="batched", steps_per_dispatch=4) == alone
    assert run(8, []) != alone


def test_refusals_equal_jax(pair):
    """Per-request fields without per_request_sampling and sampling knobs
    with speculative serving raise as the JAX batcher does."""
    prompt = np.arange(1, 5)
    for cls, pm in ((JBatcher, pair[0]), (TBatcher, pair[1])):
        b = cls(pm, **KW)
        for kw in (dict(temperature=0.5), dict(seed=1), dict(presence_penalty=0.2)):
            with pytest.raises(ValueError, match="per_request_sampling"):
                b.submit(prompt, 4, **kw)
        for kw in (dict(repetition_penalty=2.0), dict(per_request_sampling=True)):
            with pytest.raises(ValueError, match="greedy-only"):
                cls(pm, slots=2, spec_decode="prompt_lookup", **kw)
        with pytest.raises(ValueError, match="top_logprobs"):
            b.submit(prompt, 4, top_logprobs=21)
        with pytest.raises(ValueError, match="out of range"):
            b.submit(prompt, 4, logit_bias={500: 1.0})
        with pytest.raises(ValueError, match="speculative"):
            cls(pm, **KW, spec_decode="prompt_lookup").submit(prompt, 4, min_tokens=2)
