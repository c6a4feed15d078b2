"""Parity: the port's batcher execution modes against the JAX batcher's.

Batched and mixed prefill, fused multi-step decode, prefix caching and
speculative decoding (prompt lookup, a draft model) in the port's
`ContinuousBatcher` must give the JAX `ContinuousBatcher`'s greedy
tokens in the same mode, token for token, on tiny llama and opt models
(the JAX serving tests' configs, built offline and carried across with
`params_from_numpy`), and with them the JAX batcher's prefix-cache and
speculative counters. The cases mirror the JAX serving tests: EOS and
ragged budgets, admission churn, self-drafting, int8 KV, stop sequences,
a slot near the pool's end, a MoE model under batched prefill, and the
constructor's validations.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402

from modegpt_tpu.models import params_from_hf_model as j_params_from_hf  # noqa: E402
from modegpt_tpu.models.padded import pad_to_uniform as j_pad  # noqa: E402
from modegpt_tpu.models.serving import ContinuousBatcher as JBatcher  # noqa: E402
from modegpt_tpu.models.serving import lookup_draft as j_lookup_draft  # noqa: E402
from modegpt_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from modegpt_tpu_torch.models.padded import pad_to_uniform as t_pad  # noqa: E402
from modegpt_tpu_torch.models.serving import ContinuousBatcher as TBatcher  # noqa: E402
from modegpt_tpu_torch.models.serving import lookup_draft as t_lookup_draft  # noqa: E402
from modegpt_tpu_torch.models.spec import ModelSpec as TSpec  # noqa: E402

KW = dict(slots=2, max_len=96, prefill_bucket=16)


def _hf(arch, seed=0):
    if arch == "llama":
        cfg = transformers.LlamaConfig(
            vocab_size=128, hidden_size=64, intermediate_size=144, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
        )
        cls = transformers.LlamaForCausalLM
    elif arch == "opt":
        cfg = transformers.OPTConfig(
            vocab_size=128, hidden_size=48, ffn_dim=96, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=256, word_embed_proj_dim=48,
        )
        cls = transformers.OPTForCausalLM
    else:  # a small mixtral: 4 experts, 2 a token
        cfg = transformers.MixtralConfig(
            vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
            num_local_experts=4, num_experts_per_tok=2, sliding_window=None,
        )
        cls = transformers.MixtralForCausalLM
    torch.manual_seed(seed)
    return cls(cfg).eval()


def _pair(j_spec, j_params):
    """(JAX padded model, port padded model)."""
    t_spec = TSpec.from_dict(j_spec.to_dict())
    return j_pad(j_spec, j_params), t_pad(t_spec, params_from_numpy(jax.device_get(j_params), "cpu"))


@pytest.fixture(scope="module")
def models():
    return {arch: _pair(*j_params_from_hf(_hf(arch, seed))) for arch, seed in
            (("llama", 29), ("opt", 0), ("mixtral", 0))}


@pytest.fixture(scope="module")
def draft(tmp_path_factory):
    """A tiny llama compressed by the port's own pipeline, drafting for the
    dense llama of `models` (per-layer ranks, rotary masks; padded ranks
    below the target's)."""
    from modegpt_tpu.models.spec import ModelSpec as JSpec
    from modegpt_tpu_torch.compress.pipeline import run_compression
    from modegpt_tpu_torch.config import CompressionConfig
    from modegpt_tpu_torch.models.convert import to_numpy
    from modegpt_tpu_torch.models.hf import params_from_hf_model

    root = tmp_path_factory.mktemp("draft")
    spec, params = params_from_hf_model(_hf("llama", 29), device="cpu")
    config = CompressionConfig(
        model="in-memory", dataset="synthetic", calib_size=4, calibs_batch_size=2, seq_len=48,
        compression_ratio=0.2, sparsity_smoothing=0.5, device="cpu",
        output_dir=str(root / "o"), temp_storage_dir=str(root / "l"), metrics_dir=str(root / "m"),
        skip_baseline_eval=True, skip_final_eval=True,
    )
    res = run_compression(config, spec=spec, params=params)

    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [host(v) for v in tree]
        return to_numpy(tree)

    j_params = jax.tree_util.tree_map(jax.numpy.asarray, host(res["compressed_params"]))
    return _pair(JSpec.from_dict(res["compressed_spec"].to_dict()), j_params)


def _prompts(lengths, seed=0, high=128):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, high, size=(n,)).astype(np.int32) for n in lengths]


def _serve(pm, cls, prompts, budgets, stop=None, draft_pm=None, **kw):
    b = cls(pm, **{**KW, **kw}, **({} if draft_pm is None else {"draft_pm": draft_pm}))
    budgets = budgets if isinstance(budgets, list) else [budgets] * len(prompts)
    ids = [b.submit(p, max_new_tokens=n, stop=stop) for p, n in zip(prompts, budgets)]
    done = b.run()
    assert set(done) == set(ids)
    return [list(map(int, done[r])) for r in ids], b, ids


def _both(pair, prompts, budgets, stop=None, draft=None, **kw):
    """Serve on both packages in the same mode: the outputs, the prefix
    cache counters and the per-request speculative stats must be equal.
    Returns (outputs, port batcher, port request ids)."""
    want, jb, jids = _serve(pair[0], JBatcher, prompts, budgets, stop, None if draft is None else draft[0], **kw)
    got, tb, tids = _serve(pair[1], TBatcher, prompts, budgets, stop, None if draft is None else draft[1], **kw)
    assert got == want
    assert (tb.prefix_hits, tb.prefix_tokens_reused) == (jb.prefix_hits, jb.prefix_tokens_reused)
    assert [tb.stats.get(r) for r in tids] == [jb.stats.get(r) for r in jids]
    return got, tb, tids


FUSED_PROMPTS, FUSED_BUDGETS = (5, 12, 3, 21, 8), [14, 3, 9, 1, 17]


@pytest.mark.parametrize("arch", ["llama", "opt"])
def test_fused_decode_with_budgets_and_eos(models, arch):
    """steps_per_dispatch > 1 across admission churn, ragged budgets and
    an EOS the model emits mid-window: equal to the JAX batcher's fused
    output and to the port's own single-step output."""
    prompts = _prompts(FUSED_PROMPTS, seed=1)
    plain, *_ = _serve(models[arch][1], TBatcher, prompts, FUSED_BUDGETS)
    fused, *_ = _both(models[arch], prompts, FUSED_BUDGETS, steps_per_dispatch=5)
    assert fused == plain
    eos = plain[0][len(prompts[0]) + 4]
    _both(models[arch], prompts, FUSED_BUDGETS, eos_token_id=eos, steps_per_dispatch=4)


@pytest.mark.parametrize("arch", ["llama", "opt"])
def test_batched_prefill(models, arch):
    """prefill_exec='batched' (one [slots, bucket] dispatch a chunk round)
    with multi-chunk prompts, admission churn, fused decode, and an EOS
    possibly at prefill, with mixed rounds off and on."""
    prompts = _prompts((21, 4, 33, 9, 17), seed=2)
    budgets = [8, 13, 5, 11, 2]
    plain, *_ = _serve(models[arch][1], TBatcher, prompts, budgets)
    for mixed in (False, True):
        got, *_ = _both(models[arch], prompts, budgets, prefill_exec="batched", steps_per_dispatch=4,
                        mixed_prefill_decode=mixed)
        assert got == plain
    eos = plain[0][len(prompts[0]) + 2]
    _both(models[arch], prompts, budgets, eos_token_id=eos, prefill_exec="batched", mixed_prefill_decode=False)
    _both(models[arch], prompts, budgets, eos_token_id=eos, prefill_exec="batched")


def test_mixed_round_decode_piggyback(models):
    """While one slot prefills a 4-chunk prompt, a decode-active slot
    advances one token per chunk round inside the same dispatch with
    mixed rounds on, once per step with them off; both drain to the
    JAX batcher's output."""
    short, long_p = _prompts((5, 60), seed=3)
    jpm, tpm = models["llama"]
    for mixed, gain in ((True, 2), (False, 1)):
        kw = dict(KW, prefill_exec="batched", prefill_chunks_per_step=2, mixed_prefill_decode=mixed)
        jb, tb = JBatcher(jpm, **kw), TBatcher(tpm, **kw)
        key = jax.random.key(0)
        ra, rta = jb.submit(short, max_new_tokens=20), tb.submit(short, max_new_tokens=20)
        key, _, _ = jb.step(key)
        tb.step()
        a_len0 = len(tb.slot_out[0])
        assert a_len0 == len(jb.slot_out[0])
        jb.submit(long_p, max_new_tokens=4)
        tb.submit(long_p, max_new_tokens=4)
        jb.step(key)
        tb.step()
        assert len(tb.slot_out[0]) - a_len0 == gain
        assert tb.slot_out == jb.slot_out
        assert list(map(int, jb.run()[ra])) == tb.run()[rta]
    assert TBatcher(tpm).mixed_prefill_decode  # JAX's default


def _shared_prefix_prompts(seed=4):
    """A 33-token shared prefix (4 chunks of 8) with varied tails, one
    prompt diverging at token 0, and one sharing only 11 tokens."""
    rng = np.random.default_rng(seed)
    sysp = rng.integers(1, 128, size=(33,)).astype(np.int32)
    prompts = [np.concatenate([sysp, rng.integers(1, 128, size=(k,)).astype(np.int32)]) for k in (3, 9, 5, 7)]
    div = prompts[0].copy()
    div[0] = div[0] % 126 + 1
    prompts.append(div)
    prompts.append(np.concatenate([sysp[:11], rng.integers(1, 128, size=(10,)).astype(np.int32)]))
    return prompts


@pytest.mark.parametrize("mode", ["per_slot", "batched", "self_adoption", "draft"])
def test_prefix_cache(models, mode):
    """prefix_cache=True adopts bucket-aligned shared prefixes (slot-row
    copies, into the draft pool too under a draft model), with the JAX
    batcher's hits, tokens reused and outputs, and the outputs of the
    same requests served without the cache."""
    prompts = _shared_prefix_prompts()
    kw = dict(prefill_bucket=8)
    if mode == "batched":
        kw["prefill_exec"] = "batched"
    if mode == "self_adoption":
        prompts, kw["slots"] = prompts[:3], 1
    pair = models["llama"]
    plain, *_ = _serve(pair[1], TBatcher, prompts, 7, **kw)
    if mode == "draft":
        kw.update(spec_decode="draft", n_draft=3)
    got, tb, _ = _both(pair, prompts, 7, draft=pair if mode == "draft" else None, prefix_cache=True, **kw)
    assert got == plain
    assert tb.prefix_hits == {"per_slot": 9, "batched": 9, "self_adoption": 8, "draft": 8}[mode]


def test_prompt_lookup(models):
    """In-batcher prompt lookup: the plain output, with the JAX batcher's
    per-request stats, and repetitive prompts accept drafts."""
    rng = np.random.default_rng(5)
    prompts = [np.tile(rng.integers(1, 100, size=4).astype(np.int32), 5), rng.integers(1, 128, size=(12,)),
               np.tile(rng.integers(1, 100, size=3).astype(np.int32), 6)]
    plain, *_ = _serve(models["llama"][1], TBatcher, prompts, 14)
    got, tb, ids = _both(models["llama"], prompts, 14, spec_decode="prompt_lookup", n_draft=4, lookup_ngram=3)
    assert got == plain
    for rid in ids:
        st = tb.stats[rid]
        assert st["rounds"] >= 1 and st["drafted"] == 4 * st["rounds"] and 0 <= st["accepted"] <= st["drafted"]
    assert tb.stats[ids[0]]["accepted"] > 0 and tb.stats[ids[0]]["rounds"] < 14
    for hist in ([1, 2, 3], list(prompts[0]), list(prompts[1]) + [5, 5, 5, 5]):
        np.testing.assert_array_equal(t_lookup_draft(hist, 4, 3), j_lookup_draft(hist, 4, 3))


@pytest.mark.parametrize("prefill_exec", ["per_slot", "batched"])
def test_draft_model(models, draft, prefill_exec):
    """A compressed draft (its own padded ranks) speculating for its dense
    parent: the target's plain output, the JAX batcher's stats; every
    prefill path mirrors into the draft pool."""
    prompts = _prompts((10, 21, 6), seed=6)
    plain, *_ = _serve(models["llama"][1], TBatcher, prompts, 12)
    got, tb, ids = _both(models["llama"], prompts, 12, draft=draft, spec_decode="draft", n_draft=3,
                         prefill_exec=prefill_exec)
    assert got == plain
    assert all(tb.stats[r]["drafted"] == 3 * tb.stats[r]["rounds"] for r in ids)


def test_self_draft_accepts_everything(models):
    """The target drafting for itself accepts every draft: 12 tokens after
    the prefill's one take ceil(12 / 4) rounds."""
    prompt = _prompts((8,), seed=7)
    _, tb, ids = _both(models["llama"], prompt, 13, draft=models["llama"], slots=1, spec_decode="draft",
                       n_draft=3)
    st = tb.stats[ids[0]]
    assert st["rounds"] == 3 and st["accepted"] == st["drafted"]


def test_speculative_eos(models):
    """EOS inside an accepted prefix ends the request where plain decode
    ends it."""
    prompt = _prompts((9,), seed=8)
    plain, *_ = _serve(models["llama"][1], TBatcher, prompt, 20, slots=1)
    eos = plain[0][9 + 4]
    want, *_ = _serve(models["llama"][1], TBatcher, prompt, 20, slots=1, eos_token_id=eos)
    for mode, n_draft in (("prompt_lookup", 4), ("draft", 3)):
        got, *_ = _both(models["llama"], prompt, 20, draft=models["llama"] if mode == "draft" else None,
                        slots=1, eos_token_id=eos, spec_decode=mode, n_draft=n_draft)
        assert got == want


@pytest.mark.parametrize("mode", ["fused_batched", "prompt_lookup"])
def test_int8_kv(models, mode):
    """int8 KV under fused decode with batched prefill, and under prompt
    lookup: the JAX batcher's tokens and the port's int8 plain tokens."""
    if mode == "fused_batched":
        prompts, budgets, kw = _prompts((9, 19, 5), seed=9), 9, dict(steps_per_dispatch=4, prefill_exec="batched")
    else:
        prompts = [np.tile(_prompts((4,), seed=10, high=100)[0], 5)]
        budgets, kw = 12, dict(slots=1, spec_decode="prompt_lookup", n_draft=4)
    plain, *_ = _serve(models["llama"][1], TBatcher, prompts, budgets, kv_dtype="int8",
                       slots=kw.get("slots", 2))
    got, *_ = _both(models["llama"], prompts, budgets, kv_dtype="int8", **kw)
    assert got == plain


STOP_MODES = [dict(), dict(steps_per_dispatch=4), dict(prefill_exec="batched", steps_per_dispatch=3),
              dict(prefill_exec="batched", mixed_prefill_decode=False), dict(spec_decode="prompt_lookup", n_draft=3)]


@pytest.mark.parametrize("kw", STOP_MODES, ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()) or "plain")
def test_stop_sequences_across_modes(models, kw):
    """A stop sequence ends generation at its earliest match, the matched
    tokens excluded, in every execution mode."""
    prompt = _prompts((5,), seed=11)
    full, *_ = _serve(models["llama"][1], TBatcher, prompt, 12)
    gen = full[0][5:]
    earliest = next(j for j in range(len(gen)) if gen[j : j + 2] == gen[5:7])
    got, *_ = _both(models["llama"], prompt, 12, stop=[gen[5:7]], **kw)
    assert got == [full[0][: 5 + earliest]]


@pytest.mark.parametrize("kw", [dict(prefill_exec="batched"), dict(prefill_exec="batched", steps_per_dispatch=4),
                                dict(spec_decode="prompt_lookup", n_draft=4),
                                dict(prefill_exec="batched", spec_decode="draft", n_draft=3)],
                         ids=["mixed", "batched_fused", "prompt_lookup", "draft"])
def test_slot_near_pool_end(models, kw):
    """A slot whose length comes within one bucket of max_len: mixed
    decode rows and idle rows write up to a bucket past their length,
    verify rows k+1 positions; the writes past the pool are dropped, and
    the outputs stay the JAX batcher's."""
    prompts = _prompts((50, 3, 20), seed=12)
    budgets = [8, 6, 40] if "spec_decode" not in kw else [3, 6, 35]
    draft = models["llama"] if kw.get("spec_decode") == "draft" else None
    _both(models["llama"], prompts, budgets, draft=draft, max_len=64, **kw)


@pytest.mark.parametrize("moe", ["dense", "dispatch"])
def test_moe_batched_prefill(models, moe):
    """A MoE model under batched prefill and fused decode: moe='dense'
    gives the per-slot tokens; 'dispatch' pools expert capacity across
    the admitting slots, so it is held to the JAX batcher in the same
    mode only."""
    prompts = _prompts((21, 4, 30, 9), seed=13)
    kw = dict(moe=moe, moe_capacity=1.0, prefill_exec="batched", steps_per_dispatch=3)
    got, *_ = _both(models["mixtral"], prompts, 7, **kw)
    if moe == "dense":
        assert got == _serve(models["mixtral"][1], TBatcher, prompts, 7, moe="dense")[0]


def test_validations(models):
    tpm = models["llama"][1]
    with pytest.raises(ValueError, match="greedy-only"):
        TBatcher(tpm, spec_decode="prompt_lookup", temperature=0.7)
    with pytest.raises(ValueError, match="greedy-only"):
        TBatcher(tpm, spec_decode="prompt_lookup", top_p=0.9)
    with pytest.raises(ValueError, match="draft_pm"):
        TBatcher(tpm, spec_decode="draft")
    b = TBatcher(tpm, slots=1, max_len=32, spec_decode="prompt_lookup", n_draft=4)
    with pytest.raises(ValueError, match="draft margin"):
        b.submit(np.arange(1, 20, dtype=np.int32), max_new_tokens=10)
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        TBatcher(tpm, steps_per_dispatch=0)
    with pytest.raises(ValueError, match="spec_decode"):
        TBatcher(tpm, steps_per_dispatch=4, spec_decode="prompt_lookup")
    with pytest.raises(ValueError, match="prefill_exec"):
        TBatcher(tpm, prefill_exec="chunked")
    with pytest.raises(ValueError, match="spec_decode must be"):
        TBatcher(tpm, spec_decode="medusa")
    # the JAX signature, positionally: n_draft and lookup_ngram after spec_decode
    b = TBatcher(tpm, 2, 64, 8, None, 0.0, "dense", 2.0, 1, "prompt_lookup", 2, 4)
    assert (b.n_draft, b.lookup_ngram) == (2, 4)
