"""Parity of the port's eval entry point with the JAX package's, on the CPU.

* Both eval CLIs (`main([...])`, ``--device cpu`` for the port) on one
  tiny compressed artifact with a word-level tokenizer saved into it:
  joined-window and per-sample alpaca perplexity to 1e-4 relative, equal
  task accuracies, the same greedy generation. The alpaca holdout loader
  is pinned to the same few texts in both packages, as
  tests/test_data_golden.py pins it.
* `evaluate_multiple_choice` on the vendored real-schema task documents
  (tests/fixtures/task_docs.json), winogrande partial scoring and the
  truncation boundary included; `compute_perplexity_alpaca` with given
  texts; greedy `generate` with and without a repetition penalty and EOS.
* ``--mesh_shape`` on one process (a world of 1) raises, and the CLI's
  default device (cuda) raises without a card.
"""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from modegpt_tpu.calib import data as j_data  # noqa: E402
from modegpt_tpu.compress import artifact as j_artifact  # noqa: E402
from modegpt_tpu.evals import tasks as j_tasks  # noqa: E402
from modegpt_tpu.evals.cli import main as j_main  # noqa: E402
from modegpt_tpu.evals.perplexity import compute_perplexity_alpaca as j_alpaca  # noqa: E402
from modegpt_tpu.models import params_from_hf_model as j_params_from_hf  # noqa: E402
from modegpt_tpu.models.generate import generate as j_generate  # noqa: E402
from modegpt_tpu_torch.calib import data as t_data  # noqa: E402
from modegpt_tpu_torch.compress import artifact as t_artifact  # noqa: E402
from modegpt_tpu_torch.evals import tasks as t_tasks  # noqa: E402
from modegpt_tpu_torch.evals.cli import main as t_main  # noqa: E402
from modegpt_tpu_torch.evals.perplexity import compute_perplexity_alpaca as t_alpaca  # noqa: E402
from modegpt_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from modegpt_tpu_torch.models.generate import generate as t_generate  # noqa: E402
from modegpt_tpu_torch.models.spec import ModelSpec as TSpec  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "task_docs.json")
WORDS = "one two a b x y z q the dog xylophone ran zebra".split()
ALPACA_TEXTS = [
    "tok1 tok2 tok3 tok4 tok5",
    "one two one two one two one two",
    "tok9",  # one token: no loss, skipped
    " ".join(f"tok{i % 40}" for i in range(70)),  # truncated at --seq_len
    "the dog ran the dog ran",
]


def _tiny_llama(seed=0):
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=144, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
        tie_word_embeddings=False,
    )
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(cfg).eval()


def _word_tokenizer():
    from tokenizers import Tokenizer, models as tok_models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    names = WORDS + [f"tok{i}" for i in range(126 - len(WORDS))]
    vocab = {w: i for i, w in enumerate(names)}
    vocab.update({"<eos>": 126, "<unk>": 127})
    tok = Tokenizer(tok_models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    return PreTrainedTokenizerFast(tokenizer_object=tok, eos_token="<eos>", unk_token="<unk>")


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A tiny llama compressed by the port's pipeline (per-layer ranks,
    rotary masks), with a word-level tokenizer saved beside it."""
    from modegpt_tpu_torch.compress.pipeline import run_compression
    from modegpt_tpu_torch.config import CompressionConfig
    from modegpt_tpu_torch.models.hf import params_from_hf_model

    root = tmp_path_factory.mktemp("evals")
    spec, params = params_from_hf_model(_tiny_llama(seed=3), device="cpu")
    config = CompressionConfig(
        model="in-memory", dataset="synthetic", calib_size=4, calibs_batch_size=2, seq_len=48,
        compression_ratio=0.3, sparsity_smoothing=0.1, device="cpu",
        output_dir=str(root / "o"), temp_storage_dir=str(root / "l"), metrics_dir=str(root / "m"),
        skip_baseline_eval=True, skip_final_eval=True,
    )
    path = run_compression(config, spec=spec, params=params)["artifact_dir"]
    _word_tokenizer().save_pretrained(path)
    return path


def test_eval_clis_agree(artifact, monkeypatch, capsys):
    for module in (j_data, t_data):
        monkeypatch.setattr(module, "_alpaca_texts", lambda tokenizer, calib, n_holdout=500: ALPACA_TEXTS)
    flags = [
        "--model", artifact, "--dataset", "synthetic", "--tasks", "synthetic", "--alpaca_per_sample",
        "--generate", "tok1 tok2 tok3", "--max_new_tokens", "5", "--seq_len", "32",
        "--eval_batch_size", "3", "--eval_max_samples", "4",
    ]
    got = t_main(flags + ["--device", "cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) >= {"ppl-synthetic", "ppl-alpaca-per-sample", "synthetic"}
    want = j_main(flags)
    for key in ("ppl-synthetic", "ppl-alpaca-per-sample"):
        assert np.isfinite(got[key])
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    assert got["synthetic"] == want["synthetic"]
    assert got["generation"] == want["generation"]
    assert got["generation"].startswith("tok1 tok2 tok3")


def test_eval_cli_unported_options_and_devices(artifact, monkeypatch, tmp_path):
    base = ["--model", artifact, "--dataset", "synthetic", "--seq_len", "16", "--device", "cpu"]
    with pytest.raises(ValueError, match="world size is 1"):  # one process per rank
        t_main(base + ["--mesh_shape", "data:2"])
    # an artifact without tokenizer files: what needs one exits, as the JAX CLI does
    bare = tmp_path / "bare"
    bare.mkdir()
    for name in ("spec.json", "params.npz", "tokenizer_source.txt"):
        shutil.copy(os.path.join(artifact, name), bare / name)
    for flag in (["--tasks", "synthetic"], ["--alpaca_per_sample"], ["--generate", "tok1"]):
        with pytest.raises(SystemExit, match="requires a tokenizer"):
            t_main(["--model", str(bare), "--device", "cpu"] + flag)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_main(["--model", artifact, "--dataset", "synthetic"])  # the default device is cuda


@pytest.mark.parametrize("extra", [["--prompt_lookup", "--n_draft", "3", "--lookup_ngram", "2"],
                                   ["--speculative_draft", "<artifact>", "--n_draft", "3"]],
                         ids=["prompt_lookup", "speculative_draft"])
def test_eval_cli_speculative_generation_matches_jax(artifact, extra):
    """--generate with --prompt_lookup, and with --speculative_draft (the
    artifact drafting for itself): the JAX CLI's text and stats."""
    extra = [artifact if e == "<artifact>" else e for e in extra]
    flags = ["--model", artifact, "--generate", "tok1 tok2 tok3 tok1 tok2 tok3 tok1", "--max_new_tokens", "7"] + extra
    got = t_main(flags + ["--device", "cpu"])
    want = j_main(flags)
    key = "prompt_lookup" if "--prompt_lookup" in extra else "spec_decode"
    assert got["generation"] == want["generation"]
    assert got[key] == want[key]
    plain = t_main(["--model", artifact, "--generate", "tok1 tok2 tok3 tok1 tok2 tok3 tok1", "--max_new_tokens", "7",
                    "--device", "cpu"])
    assert got["generation"] == plain["generation"]


class ByteTokenizer:
    """Bytes as ids (1..127), with HF's truncation keywords."""

    eos_token = None

    def __call__(self, text, add_special_tokens=True, truncation=False, max_length=None):
        ids = [b % 127 + 1 for b in text.encode("utf-8")]
        return {"input_ids": ids[:max_length] if truncation and max_length else ids}


@pytest.fixture(scope="module")
def dense_pair():
    j_spec, j_params = j_params_from_hf(_tiny_llama())
    t_spec = TSpec.from_dict(j_spec.to_dict())
    return j_spec, j_params, t_spec, params_from_numpy(jax.device_get(j_params), "cpu")


def test_tasks_match_jax_on_fixture_docs(dense_pair):
    j_spec, j_params, t_spec, t_params = dense_pair
    with open(FIXTURES) as f:
        docs = json.load(f)
    examples = {}
    for family, task in (("arc", "arc_easy"), ("piqa", "piqa"), ("hellaswag", "hellaswag"),
                         ("winogrande", "winogrande")):
        t_ex = t_tasks.load_task_docs(task, docs[family])
        j_ex = j_tasks.load_task_docs(task, docs[family])
        assert [vars(e) for e in t_ex] == [vars(e) for e in j_ex], task
        examples[task] = t_ex
    tok = ByteTokenizer()
    for task, ex in examples.items():
        for max_len in (512, 48):  # 48 truncates most contexts
            got = t_tasks.evaluate_multiple_choice(t_spec, t_params, ex, tok, batch_size=3, max_len=max_len,
                                                   return_scores=True)
            want = j_tasks.evaluate_multiple_choice(j_spec, j_params, ex, tok, batch_size=3, max_len=max_len,
                                                    return_scores=True)
            assert (got["acc"], got["acc_norm"], got["n"]) == (want["acc"], want["acc_norm"], want["n"])
            for key in ("scores", "scores_norm"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5, err_msg=f"{task} {key}")
    assert [vars(e) for e in t_tasks.load_task("synthetic")] == [vars(e) for e in j_tasks.load_task("synthetic")]


@pytest.mark.parametrize("max_length", [256, 24])
def test_alpaca_per_sample_perplexity_matches_jax(dense_pair, max_length):
    j_spec, j_params, t_spec, t_params = dense_pair
    texts = ["short", "a", "Below is an instruction. ### Response: fine", "x" * 30, "tokens " * 9]
    tok = ByteTokenizer()
    got = t_alpaca(t_spec, t_params, tok, texts=texts, max_length=max_length, batch_size=2, progress=False)
    want = j_alpaca(j_spec, j_params, tok, texts=texts, max_length=max_length, batch_size=2, progress=False)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("penalty", [None, 1.3])
def test_greedy_generate_matches_jax(dense_pair, artifact, penalty):
    """Dense and compressed (rotary-masked) models, two prompts, then EOS
    set to a token the first run emits."""
    j_spec, j_params, t_spec, t_params = dense_pair
    c_spec, c_params, _ = t_artifact.load_compressed_model(artifact, device="cpu")
    jc_spec, jc_params, _ = j_artifact.load_compressed_model(artifact)
    prompts = np.random.default_rng(2).integers(1, 120, (2, 7)).astype(np.int32)
    for js, jp, ts, tp in ((j_spec, j_params, t_spec, t_params), (jc_spec, jc_params, c_spec, c_params)):
        kw = dict(max_new_tokens=6, repetition_penalty=penalty)
        got = t_generate(ts, tp, prompts, **kw)
        want = np.asarray(j_generate(js, jp, jnp.asarray(prompts), **kw))
        np.testing.assert_array_equal(got.numpy(), want)
        eos = int(want[0, 9])
        got = t_generate(ts, tp, prompts, eos_token_id=eos, **kw)
        want = np.asarray(j_generate(js, jp, jnp.asarray(prompts), eos_token_id=eos, **kw))
        np.testing.assert_array_equal(got.numpy(), want)


def test_init_cache_defaults_to_the_card(dense_pair, artifact, monkeypatch):
    """`init_cache` runs on CUDA unless asked for the CPU, as the port's
    other entry points do; on the CPU its caches have the JAX cache's
    shapes (dense and per-layer compressed ranks)."""
    from modegpt_tpu.models.generate import init_cache as j_init_cache
    from modegpt_tpu_torch.models.generate import init_cache as t_init_cache

    j_spec, _, t_spec, _ = dense_pair
    c_spec, _, _ = t_artifact.load_compressed_model(artifact, device="cpu")
    jc_spec, _, _ = j_artifact.load_compressed_model(artifact)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_init_cache(t_spec, 2, 16)
    for js, ts in ((j_spec, t_spec), (jc_spec, c_spec)):
        got = t_init_cache(ts, 2, 16, device="cpu")
        want = j_init_cache(js, 2, 16)
        assert got.length == 0
        for g, w in zip(got.k + got.v, want.k + want.v):
            assert g.device.type == "cpu" and g.dtype == torch.float32
            assert tuple(g.shape) == tuple(w.shape) and not g.any()
