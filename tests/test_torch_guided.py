"""Parity: guided decoding in the port against the JAX package.

The port keeps its own copy of `models.guided`: its regex -> DFA
compiler must give JAX's transition tables, acceptance and start state
on the patterns of `tests/test_guided.py` and the JSON grammars, its
`TokenGuide` JAX's masks and advances along random walks, and its
tokenizer byte table JAX's. In the batcher, guided greedy requests (a
choice and a JSON schema, beside an unguided request) give the JAX
batcher's tokens per slot, in mixed + fused rounds (guided slots force
single steps) and under prompt lookup (repaired drafts, per-position
masks); sampled guided rows stay in the grammar; the refusals are JAX's.
"""

import json
import re as pyre

import numpy as np
import pytest

from modegpt_tpu.models import guided as JG
from modegpt_tpu_torch.models import guided as TG

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402

from modegpt_tpu.models import params_from_hf_model as j_params_from_hf  # noqa: E402
from modegpt_tpu.models.padded import pad_to_uniform as j_pad  # noqa: E402
from modegpt_tpu.models.serving import ContinuousBatcher as JBatcher  # noqa: E402
from modegpt_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from modegpt_tpu_torch.models.padded import pad_to_uniform as t_pad  # noqa: E402
from modegpt_tpu_torch.models.serving import ContinuousBatcher as TBatcher  # noqa: E402
from modegpt_tpu_torch.models.spec import ModelSpec as TSpec  # noqa: E402

# tests/test_guided.py's patterns, plus the grammars the server lowers
PATTERNS = [
    "abc", "a|bc|", "(ab)*c", "a+b?c{2,3}", "[a-f0-9]+", "[^xyz]{1,4}", "\\d{2}-\\d{2}", "(foo|bar)(baz)?",
    "a.c", "\\w+@\\w+\\.(com|org)", "x{3}", "(?:ab|cd){1,2}e", "\\s*ok\\s*", "a{2,}", "é+x", "a{2",
]
SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string"}, "age": {"type": "integer"}, "tag": {"enum": ["x", "y"]},
        "scores": {"type": "array", "items": {"type": "number"}, "minItems": 1, "maxItems": 2},
        "ok": {"type": "boolean"}, "none": {"type": "null"}, "pat": {"type": "string", "pattern": "[a-c]{2}"},
    },
}
GRAMMARS = {
    "choice": lambda G: G.regex_for_choice(["a.b", "c+d", "x{1}"]),
    "json_object": lambda G: G.regex_for_json_object(max_depth=2),
    "json_schema": lambda G: G.regex_for_json_schema(SCHEMA),
    "json_value": lambda G: G.regex_for_json_value(max_depth=1),
}


def _same_dfa(pattern):
    want, got = JG.compile_charset(pattern), TG.compile_charset(pattern)
    np.testing.assert_array_equal(got.trans, want.trans)
    np.testing.assert_array_equal(got.accept, want.accept)
    assert got.start == want.start
    return got


@pytest.mark.parametrize("pattern", PATTERNS)
def test_dfa_tables_equal_jax(pattern):
    dfa = _same_dfa(pattern)
    for s in ["", "abc", "ababc", "f00", "12-34", "foobaz", "a@b.com", "xxx", "cdabe", " ok ", "aaa", "ééx", "a{2"]:
        assert dfa.fullmatch(s) == JG.compile_charset(pattern).fullmatch(s)


@pytest.mark.parametrize("name", sorted(GRAMMARS))
def test_grammar_regexes_equal_jax(name):
    pattern = GRAMMARS[name](TG)
    assert pattern == GRAMMARS[name](JG)
    dfa = _same_dfa(pattern)
    if name == "json_schema":
        assert dfa.fullmatch('{"name": "bo", "age": 3, "tag": "x", "scores": [1.5], "ok": true, "none": null, '
                             '"pat": "ab"}')


def test_regex_errors_equal_jax():
    for bad in ["(ab", "ab)", "a**", "*a", "[z-a]", "a{4,2}", "a{9999,}", "a{0,99999}", "^ab$"]:
        with pytest.raises(JG.RegexError):
            JG.compile_charset(bad)
        with pytest.raises(TG.RegexError):
            TG.compile_charset(bad)
    for G in (JG, TG):
        with pytest.raises(ValueError):
            G.regex_for_choice([])
        with pytest.raises(ValueError):
            G.regex_for_json_schema({"type": "tuple"})


def _byte_vocab(V, eos, strip_ws=False):
    """Token i spells byte i; EOS (and whitespace with strip_ws) spell
    nothing."""
    ws = {0x20, 0x09, 0x0A, 0x0D, 0x0B, 0x0C}
    return [b"" if i == eos or (strip_ws and i in ws) else bytes([i]) for i in range(V)]


VOCABS = {
    "bytes": (_byte_vocab(128, 127), 127),
    "multibyte": ([b"", b"ab", b"ba", b"a", b"b", b"abab", b"abx", b"", b"c", b"", b"cd", b"e", b"dc"], 9),
}


@pytest.mark.parametrize("vocab", sorted(VOCABS))
@pytest.mark.parametrize("pattern", ["(ab|ba)c*", "(ab)+", "(ab|cd){2,8}e", "[a-d]{1,6}(x|yz)", "z+"])
def test_token_guide_masks_and_advances_equal_jax(vocab, pattern):
    """Along random walks that follow the mask, every state's mask, EOS
    and dead-end flags and every advance are JAX's."""
    tb, eos = VOCABS[vocab]
    want = JG.compile_regex(pattern, tb, eos, vocab_size=len(tb) + 3)
    got = TG.compile_regex(pattern, tb, eos, vocab_size=len(tb) + 3)
    assert got.V == want.V and got.start == want.start
    rng = np.random.default_rng(0)
    for _ in range(20):
        sj = st = got.start
        for _ in range(12):
            mask = got.mask_for(st)
            np.testing.assert_array_equal(mask, want.mask_for(sj))
            assert got.dead_end(st) == want.dead_end(sj) and got.eos_ok(st) == want.eos_ok(sj)
            choices = np.nonzero(mask)[0]
            choices = choices[choices != eos]
            if choices.size == 0:
                break
            t = int(rng.choice(choices))
            st, sj = got.advance(st, t), want.advance(sj, t)
            assert st == sj


def test_token_bytes_from_tokenizer_equal_jax():
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.train_from_iterator(["the quick brown fox jumps over the lazy dog", "a b c {} [] : , 0 1 2 true"],
                            trainers.BpeTrainer(vocab_size=90, special_tokens=["<unk>", "<s>", "</s>"]))
    fast = transformers.PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", bos_token="<s>",
                                                eos_token="</s>")
    assert TG.token_bytes_from_tokenizer(fast) == JG.token_bytes_from_tokenizer(fast)
    assert TG._gpt2_byte_decoder() == JG._gpt2_byte_decoder()


EOS = 127
KW = dict(slots=2, max_len=80, prefill_bucket=16, eos_token_id=EOS)


@pytest.fixture(scope="module")
def pair():
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=144, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
    )
    torch.manual_seed(0)
    j_spec, j_params = j_params_from_hf(transformers.LlamaForCausalLM(cfg).eval())
    t_spec = TSpec.from_dict(j_spec.to_dict())
    return j_pad(j_spec, j_params), t_pad(t_spec, params_from_numpy(jax.device_get(j_params), "cpu"))


def _guides(G):
    tb = _byte_vocab(128, EOS, strip_ws=True)
    schema = {"type": "object", "properties": {"ok": {"type": "boolean"}, "tag": {"enum": ["a", "b"]}}}
    return tb, [G.compile_regex(G.regex_for_choice(["cat", "dog", "bird"]), tb, EOS, vocab_size=128),
                G.compile_regex(G.regex_for_json_schema(schema), tb, EOS, vocab_size=128),
                G.compile_regex("(ab|cd){2,8}e", tb, EOS, vocab_size=128)]


MODES = {
    "per_slot": dict(),
    "mixed_fused": dict(prefill_exec="batched", steps_per_dispatch=4, per_request_sampling=True),
    "prompt_lookup": dict(spec_decode="prompt_lookup", n_draft=3),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_guided_greedy_equals_jax_batcher(pair, mode):
    """A choice, a JSON schema and a regex guide beside an unguided
    request: the JAX batcher's tokens; each guided output is in its
    grammar and ends with EOS."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 100, size=(n,)).astype(np.int32) for n in (5, 19, 7, 11)]

    def serve(cls, pm, G):
        tb, guides = _guides(G)
        b = cls(pm, **KW, **MODES[mode])
        rids = [b.submit(p, max_new_tokens=24, guide=g, logprobs=True) for p, g in zip(prompts, guides)]
        rids.append(b.submit(prompts[3], max_new_tokens=8))
        done = b.run()
        return [list(map(int, done[r])) for r in rids], [b.logprobs.get(r) for r in rids], tb

    want, want_lp, tb = serve(JBatcher, pair[0], JG)
    got, got_lp, _ = serve(TBatcher, pair[1], TG)
    assert got == want
    for g, w in zip(got_lp[:3], want_lp[:3]):
        np.testing.assert_allclose(g, w, atol=1e-5)
    words = []
    for out, n in zip(got[:3], (5, 19, 7)):
        assert out[-1] == EOS
        words.append(b"".join(tb[t] for t in out[n:-1]).decode())
    assert words[0] in ("cat", "dog", "bird")
    assert set(json.loads(words[1])) == {"ok", "tag"}
    assert pyre.fullmatch("(ab|cd){2,8}e", words[2])


def test_sampled_guided_rows_stay_in_grammar(pair):
    """Per-request sampling with a guide: every sampled token obeys the
    mask (temperature 1.3 and 0.8 with filters, seeded, beside greedy
    traffic, mixed rounds)."""
    tb = _byte_vocab(128, EOS)
    pattern = "[a-h]{2,12}"
    guide = TG.compile_regex(pattern, tb, EOS, vocab_size=128)
    rng = np.random.default_rng(6)
    b = TBatcher(pair[1], **{**KW, "slots": 3}, per_request_sampling=True, prefill_exec="batched")
    rids = [b.submit(rng.integers(1, 100, size=(4,)), max_new_tokens=14, guide=guide, temperature=t, seed=i,
                     **kw)
            for i, (t, kw) in enumerate([(1.3, {}), (0.8, dict(top_k=5, top_p=0.9)), (1.0, dict(min_p=0.1))])]
    b.submit(rng.integers(1, 100, size=(5,)), max_new_tokens=6)
    done = b.run()
    for rid in rids:
        out = done[rid][4:]
        body = out[:-1] if out[-1] == EOS else out
        text = b"".join(tb[t] for t in body).decode()
        if out[-1] == EOS:
            assert pyre.fullmatch(pattern, text), text
        else:  # the budget ran out: still a viable prefix
            assert all(c in "abcdefgh" for c in text) and len(text) <= 12


def test_guided_refusals_equal_jax(pair):
    """No EOS, another vocabulary, a grammar the vocabulary cannot spell,
    a draft model, and min_tokens with a guide: JAX's ValueErrors."""
    tb = _byte_vocab(128, EOS)
    prompt = np.arange(1, 4, dtype=np.int32)
    for cls, pm, G in ((JBatcher, pair[0], JG), (TBatcher, pair[1], TG)):
        ok = G.compile_regex("ab", tb, EOS, vocab_size=128)
        with pytest.raises(ValueError, match="eos"):
            cls(pm, slots=1, max_len=64, prefill_bucket=8).submit(prompt, 4, guide=ok)
        b = cls(pm, slots=1, max_len=64, prefill_bucket=8, eos_token_id=EOS)
        with pytest.raises(ValueError, match="vocab"):
            b.submit(prompt, 4, guide=G.compile_regex("ab", tb[:64], 63))
        with pytest.raises(ValueError, match="no token"):
            b.submit(prompt, 4, guide=G.compile_regex("\\xff+", tb, EOS, vocab_size=128))
        with pytest.raises(ValueError, match="min_tokens"):
            b.submit(prompt, 4, guide=ok, min_tokens=2)
        draft = cls(pm, slots=1, max_len=64, prefill_bucket=8, eos_token_id=EOS, spec_decode="draft", draft_pm=pm)
        with pytest.raises(ValueError, match="draft"):
            draft.submit(prompt, 4, guide=ok)
