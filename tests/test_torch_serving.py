"""Parity: the port's continuous batcher against the JAX package's.

Tiny llama and opt models (the JAX serving tests' configs, built offline)
are carried across with `params_from_numpy`; greedy outputs of the port's
`ContinuousBatcher` must be token-identical to the JAX batcher's on every
case: mixed prompt lengths with more requests than slots, a chunked long
prompt, EOS with slot reuse, a budget of one token, EOS at prefill,
prefill overlapping decode, a compressed model, stop sequences and int8
KV. Also: the ragged backend (the kernel's plain version on the CPU)
gives the plain path's tokens, unported options raise, and the serve CLI
runs on the CPU with a word-level tokenizer built offline, in every
execution mode, on an artifact or a dense HF checkpoint, with a draft
model and with in-memory compression, as the JAX serve CLI does.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from modegpt_tpu.models import params_from_hf_model as j_params_from_hf  # noqa: E402
from modegpt_tpu.models.padded import pad_to_uniform as j_pad  # noqa: E402
from modegpt_tpu.models.serving import ContinuousBatcher as JBatcher  # noqa: E402
from modegpt_tpu_torch.models.convert import params_from_numpy, to_numpy  # noqa: E402
from modegpt_tpu_torch.models.generate import _sample  # noqa: E402
from modegpt_tpu_torch.models.padded import pad_to_uniform as t_pad  # noqa: E402
from modegpt_tpu_torch.models.serving import ContinuousBatcher as TBatcher  # noqa: E402
from modegpt_tpu_torch.models.spec import ModelSpec as TSpec  # noqa: E402

KW = dict(slots=2, max_len=64, prefill_bucket=8)


def _hf(arch, seed=0):
    if arch == "llama":
        cfg = transformers.LlamaConfig(
            vocab_size=128, hidden_size=64, intermediate_size=144, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
        )
        cls = transformers.LlamaForCausalLM
    else:
        cfg = transformers.OPTConfig(
            vocab_size=128, hidden_size=48, ffn_dim=96, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=256, word_embed_proj_dim=48,
        )
        cls = transformers.OPTForCausalLM
    torch.manual_seed(seed)
    return cls(cfg).eval()


def _pair(j_spec, j_params):
    """(JAX padded model, port padded model, port spec, port params)."""
    host = jax.device_get(j_params)
    t_spec, t_params = TSpec.from_dict(j_spec.to_dict()), params_from_numpy(host, "cpu")
    return j_pad(j_spec, j_params), t_pad(t_spec, t_params), t_spec, t_params


@pytest.fixture(scope="module")
def models():
    return {arch: _pair(*j_params_from_hf(_hf(arch))) for arch in ("llama", "opt")}


@pytest.fixture(scope="module")
def compressed(tmp_path_factory):
    """A tiny llama compressed by the port's own pipeline (rotary masks,
    per-layer ranks), carried into the JAX package."""
    from modegpt_tpu_torch.compress.pipeline import run_compression
    from modegpt_tpu_torch.config import CompressionConfig
    from modegpt_tpu_torch.models.hf import params_from_hf_model

    root = tmp_path_factory.mktemp("compress")
    spec, params = params_from_hf_model(_hf("llama", seed=3), device="cpu")
    config = CompressionConfig(
        model="in-memory", dataset="synthetic", calib_size=4, calibs_batch_size=2, seq_len=48,
        compression_ratio=0.3, sparsity_smoothing=0.1, device="cpu",
        output_dir=str(root / "o"), temp_storage_dir=str(root / "l"), metrics_dir=str(root / "m"),
        skip_baseline_eval=True, skip_final_eval=True,
    )
    res = run_compression(config, spec=spec, params=params)
    from modegpt_tpu.models.spec import ModelSpec as JSpec

    cspec = res["compressed_spec"]
    host = _tree_numpy(res["compressed_params"])
    return _pair(JSpec.from_dict(cspec.to_dict()), jax.tree_util.tree_map(jnp.asarray, host)), res["artifact_dir"]


def _tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_numpy(v) for v in tree]
    return None if tree is None else to_numpy(tree)


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, size=(n,)).astype(np.int32) for n in lengths]


def _serve(pm, cls, prompts, max_new, stop=None, **kw):
    b = cls(pm, **{**KW, **kw})
    budgets = max_new if isinstance(max_new, list) else [max_new] * len(prompts)
    ids = [b.submit(p, max_new_tokens=n, stop=stop) for p, n in zip(prompts, budgets)]
    done = b.run()
    assert set(done) == set(ids)
    return [list(map(int, done[r])) for r in ids]


def _both(pair, prompts, max_new, stop=None, **kw):
    """Serve on both packages; the outputs must be identical. Returns them."""
    jpm, tpm = pair[:2]
    want = _serve(jpm, JBatcher, prompts, max_new, stop, **kw)
    got = _serve(tpm, TBatcher, prompts, max_new, stop, **kw)
    assert got == want
    return got


@pytest.mark.parametrize("arch", ["llama", "opt"])
def test_mixed_lengths_more_requests_than_slots(models, arch):
    prompts = _prompts((3, 7, 5, 9, 4))
    out = _both(models[arch], prompts, 6)
    assert [len(o) for o in out] == [len(p) + 6 for p in prompts]


def test_chunked_long_prompt(models):
    _both(models["llama"], _prompts((21,), seed=1), 6)  # 3 chunks of 8
    with pytest.raises(ValueError, match="exceeds max_len"):
        TBatcher(models["llama"][1], **KW).submit(np.zeros(60, np.int32), max_new_tokens=10)
    with pytest.raises(ValueError, match="empty prompt"):
        TBatcher(models["llama"][1], **KW).submit([], max_new_tokens=10)


def test_eos_and_slot_reuse(models):
    prompt = _prompts((5,), seed=2)[0]
    full = _serve(models["llama"][1], TBatcher, [prompt], 10)[0]
    eos = full[5 + 2]  # the 3rd generated token acts as EOS
    out = _both(models["llama"], [prompt, prompt], 10, slots=1, eos_token_id=eos)
    assert out == [full[: 5 + 3]] * 2  # both stop at EOS; the single slot was reused


def test_max_new_tokens_one(models):
    prompts = _prompts((4, 6), seed=3)
    out = _both(models["llama"], prompts, 1)
    assert [len(o) for o in out] == [5, 7]


def test_eos_at_prefill(models):
    prompt = _prompts((4,), seed=4)[0]
    first = _serve(models["llama"][1], TBatcher, [prompt], 1)[0][-1]
    out = _both(models["llama"], [prompt], 10, slots=1, eos_token_id=first)
    assert out == [prompt.tolist() + [first]]


def test_prefill_overlaps_decode(models):
    """A 4-chunk prompt admitted while another slot decodes: the chunks
    interleave with decode steps and both outputs stay exact."""
    _both(models["llama"], _prompts((5, 29), seed=5), [8, 6], prefill_chunks_per_step=1)


def test_compressed_model(compressed):
    (pair, _) = compressed
    _both(pair, _prompts((6, 11, 3), seed=6), 5)


def test_stop_sequences(models):
    prompt = _prompts((5,), seed=7)[0]
    full = _serve(models["llama"][1], TBatcher, [prompt], 12)[0]
    gen = full[5:]
    j = 5
    assert _both(models["llama"], [prompt], 12, stop=[gen[j:j + 2]]) == [full[: 5 + j]]
    # flat single-sequence form + earliest of several
    assert _both(models["llama"], [prompt], 12, stop=gen[j:j + 2]) == [full[: 5 + j]]
    stops = [gen[j + 2:j + 4], gen[j:j + 2]]
    earliest = min(i for i in range(len(gen) - 1) if gen[i:i + 2] in stops)
    assert _both(models["llama"], [prompt], 12, stop=stops) == [full[: 5 + earliest]]
    # a stop matching the first generated token leaves an empty generation
    assert _both(models["llama"], [prompt], 12, stop=[[gen[0]]]) == [prompt.tolist()]


def test_cancel_queued_and_running(models):
    """Cancel one queued and one running request between steps; the slot
    is reused and the survivor's output equals the JAX batcher's."""
    outs = []
    for cls, pm in ((JBatcher, models["llama"][0]), (TBatcher, models["llama"][1])):
        b = cls(pm, **{**KW, "slots": 1})
        r0, r1, r2 = (b.submit(p, max_new_tokens=6) for p in _prompts((5, 7, 4), seed=13))
        b.step(jax.random.key(0)) if cls is JBatcher else b.step()
        assert b.cancel(r2) and b.cancel(r0) and not b.cancel(r0) and not b.cancel(99)
        done = b.run()
        assert set(done) == {r1}
        outs.append(list(map(int, done[r1])))
    assert outs[1] == outs[0]


def test_int8_kv(models):
    prompts = _prompts((9, 14, 5), seed=8)
    _both(models["llama"], prompts, 10, kv_dtype="int8", max_len=96, prefill_bucket=16)
    b = TBatcher(models["llama"][1], kv_dtype="int8")
    assert b.state.cache_k.dtype == torch.int8 and b.state.k_scale.dtype == torch.float32


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_ragged_backend_matches_xla_on_cpu(models, kv_dtype):
    """decode_attn="ragged" (the kernel's plain version on a CPU tensor)
    and "xla" give the same tokens; "auto" is "xla" on the CPU."""
    tpm = models["llama"][1]
    prompts = _prompts((3, 12, 20), seed=9)
    ragged = _serve(tpm, TBatcher, prompts, 7, decode_attn="ragged", kv_dtype=kv_dtype)
    assert ragged == _serve(tpm, TBatcher, prompts, 7, decode_attn="xla", kv_dtype=kv_dtype)
    assert TBatcher(tpm, **KW).decode_attn == "xla"


def test_prefill_slot_and_decode_slots_match_jax(models):
    """The batcher's building blocks used directly: prompts prefilled into
    two of three slots, then three decode steps over all slots."""
    from modegpt_tpu.models import serving as j_serving
    from modegpt_tpu_torch.models import serving as t_serving

    jpm, tpm = models["opt"][:2]
    js = j_serving.init_serve_state(jpm, 3, 48)
    ts = t_serving.init_serve_state(tpm, 3, 48)
    for slot, prompt in zip((0, 2), _prompts((11, 4), seed=12)):
        js = j_serving.prefill_slot(jpm, js, slot, prompt, bucket=8)
        ts = t_serving.prefill_slot(tpm, ts, slot, prompt, bucket=8)
    np.testing.assert_array_equal(ts.lengths, np.asarray(js.lengths))
    active = np.array([True, False, True])
    for _ in range(3):
        js, j_tok = j_serving.decode_slots(jpm, js, active)
        ts, t_tok = t_serving.decode_slots(tpm, ts, active)
        np.testing.assert_array_equal(t_tok.numpy()[active], np.asarray(j_tok)[active])
    np.testing.assert_array_equal(ts.lengths, np.asarray(js.lengths))
    np.testing.assert_array_equal(ts.last_token.numpy()[active], np.asarray(js.last_token)[active])


def test_sampling_is_seeded_and_filtered(models):
    tpm = models["llama"][1]
    prompts = _prompts((4, 9), seed=10)
    kw = dict(temperature=0.9, top_p=0.8, min_p=0.05)
    a = _serve(tpm, TBatcher, prompts, 6, **kw)
    assert a == _serve(tpm, TBatcher, prompts, 6, **kw)  # run() draws from a generator seeded 0
    assert all(0 <= t < 128 for o in a for t in o)
    logits = torch.from_numpy(np.random.default_rng(11).standard_normal((3, 50)).astype(np.float32))
    greedy = torch.argmax(logits, -1)
    gen = torch.Generator().manual_seed(0)
    for knobs in (dict(top_k=1), dict(top_k=None, top_p=1e-6), dict(top_k=None, min_p=1.0)):
        assert torch.equal(_sample(logits, gen, 1.5, **knobs), greedy), knobs
    assert torch.equal(_sample(logits, None, 0.0, None), greedy)


CTOR_UNPORTED = [dict(per_request_sampling=True), dict(repetition_penalty=1.2), dict(mesh=object())]
SUBMIT_UNPORTED = [
    dict(logprobs=True), dict(top_logprobs=2), dict(seed=1), dict(guide=object()),
    dict(logit_bias={1: 2.0}), dict(min_tokens=2), dict(temperature=0.5),
]


@pytest.mark.parametrize("kw", CTOR_UNPORTED + SUBMIT_UNPORTED, ids=lambda k: next(iter(k)))
def test_unported_options_raise(models, kw):
    """Every option earlier slices refused is ported: on the same
    arguments the port's batcher serves the JAX batcher's tokens, or
    raises the exception type the JAX batcher raises (an object that is
    no mesh raises AttributeError in both). A one-rank mesh (no process
    group; the launched meshes are held in
    tests/test_torch_tp_serving.py) serves the tokens of a JAX mesh of
    one device."""
    jpm, tpm = models["llama"][:2]

    def outcome(cls, pm, **ctor):
        try:
            if kw in CTOR_UNPORTED:
                b = cls(pm, **KW, **{**kw, **ctor})
                rid = b.submit(np.arange(1, 5), max_new_tokens=2)
            else:
                b = cls(pm, **KW)
                rid = b.submit(np.arange(1, 5), max_new_tokens=2, **kw)
            return list(map(int, b.run()[rid]))
        except Exception as e:  # the JAX batcher's refusals, type for type
            return type(e)

    assert outcome(TBatcher, tpm) == outcome(JBatcher, jpm)
    if "mesh" in kw:
        from jax.sharding import Mesh

        from modegpt_tpu_torch.parallel.mesh import make_mesh

        one = outcome(TBatcher, tpm, mesh=make_mesh("data:1,model:1", device="cpu"))
        assert isinstance(one, list)
        assert one == outcome(JBatcher, jpm, mesh=Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model")))


def _word_tokenizer():
    """A word-level tokenizer over the tiny models' vocabulary: "tokN" is
    id N, with <eos> 126 and <unk> 127."""
    from tokenizers import Tokenizer, models as tok_models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {f"tok{i}": i for i in range(126)}
    vocab.update({"<eos>": 126, "<unk>": 127})
    tok = Tokenizer(tok_models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    return PreTrainedTokenizerFast(tokenizer_object=tok, eos_token="<eos>", unk_token="<unk>")


def test_serve_cli_on_cpu(compressed, monkeypatch, capsys):
    """`python -m modegpt_tpu_torch.serve` with the JAX CLI's flags plus
    --device cpu, on an artifact with a word-level tokenizer: the same
    completions as `python -m modegpt_tpu.serve`."""
    from modegpt_tpu.serve import main as j_serve
    from modegpt_tpu_torch.serve import main as t_serve

    _, artifact = compressed
    _word_tokenizer().save_pretrained(artifact)

    flags = ["--model", artifact, "--prompt", "tok1 tok2 tok3", "--prompt", "tok4 tok5",
             "--max_new_tokens", "5", "--slots", "2", "--max_len", "32", "--prefill_bucket", "8"]
    got = t_serve(flags + ["--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(got) == 2 and [ln["prompt"] for ln in lines] == ["tok1 tok2 tok3", "tok4 tok5"]
    assert {k: list(map(int, v)) for k, v in j_serve(flags).items()} == got

    fused = ["--steps_per_dispatch", "3"]
    assert t_serve(flags + fused + ["--device", "cpu"]) == {
        k: list(map(int, v)) for k, v in j_serve(flags + fused).items()}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_serve(flags)  # the default device is cuda


@pytest.fixture(scope="module")
def cli_dirs(compressed, tmp_path_factory):
    """(artifact dir, dense HF checkpoint dir): the compressed tiny llama
    and the dense model it was compressed from, each with the word-level
    tokenizer."""
    _, artifact = compressed
    dense = str(tmp_path_factory.mktemp("dense"))
    _hf("llama", seed=3).save_pretrained(dense)
    for path in (artifact, dense):
        _word_tokenizer().save_pretrained(path)
    return artifact, dense


def _cli_both(flags):
    """The port's serve CLI on the CPU and the JAX serve CLI: equal results."""
    from modegpt_tpu.serve import main as j_serve
    from modegpt_tpu_torch.serve import main as t_serve

    got = t_serve(flags + ["--device", "cpu"])
    assert got == {k: list(map(int, v)) for k, v in j_serve(flags).items()}
    return got


PROMPT_FLAGS = ["--prompt", "tok1 tok2 tok3 tok4 tok5 tok6 tok7 tok8 tok9 tok10",
                "--prompt", "tok7 tok7 tok8 tok7 tok7 tok8 tok7", "--prompt", "tok4 tok5",
                "--prompt", "tok1 tok2 tok3 tok4 tok5 tok6 tok7 tok8 tok20 tok21 tok22",
                "--max_new_tokens", "6", "--slots", "2", "--max_len", "40", "--prefill_bucket", "8"]
SERVE_MODES = {
    "batched": ["--prefill_exec", "batched"],
    "batched_fused_int8": ["--prefill_exec", "batched", "--steps_per_dispatch", "4", "--kv_dtype", "int8"],
    "prefix_cache": ["--prefix_cache"],
    "prompt_lookup": ["--spec_decode", "prompt_lookup", "--n_draft", "3", "--lookup_ngram", "2"],
}


@pytest.mark.parametrize("mode", sorted(SERVE_MODES))
def test_serve_cli_modes_match_jax(cli_dirs, mode):
    """The serve CLI's execution-mode flags on an artifact: the JAX CLI's
    completions."""
    got = _cli_both(["--model", cli_dirs[0]] + PROMPT_FLAGS + SERVE_MODES[mode])
    assert len(got) == 4


def test_serve_cli_dense_checkpoint_draft_and_compress_ratio(cli_dirs, caplog):
    """A dense HF checkpoint as --model, alone, with its compressed child
    as --draft_model, and compressed in memory (--compress_ratio): the
    JAX CLI's completions; the draft run logs its acceptance."""
    artifact, dense = cli_dirs
    base = ["--model", dense] + PROMPT_FLAGS
    plain = _cli_both(base)
    caplog.set_level("INFO")
    assert _cli_both(base + ["--spec_decode", "draft", "--draft_model", artifact, "--n_draft", "3"]) == plain
    assert any("speculative:" in r.getMessage() for r in caplog.records)
    _cli_both(base + ["--compress_ratio", "0.3", "--compress_dataset", "synthetic", "--compress_calib_size", "4",
                      "--compress_seq_len", "32"])
    with pytest.raises(SystemExit, match="needs --draft_model"):
        from modegpt_tpu_torch.serve import main as t_serve

        t_serve(base + ["--spec_decode", "draft", "--device", "cpu"])
