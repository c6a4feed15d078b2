"""Streaming generation and padded generation against the JAX package, on the CPU.

* `models.streaming.streaming_generate` gives JAX's tokens: inside the
  window (llama and opt, where it is greedy `generate_padded` too),
  beyond it with eviction (llama), on a compressed model with rotary
  masks, under the model's own sliding window (uniform mistral, gemma2's
  alternating layers) and on a mixed dense/MoE stack; the same
  ValueErrors, the learned-position rejection included;
* `models.padded.prefill_padded` and `generate_padded` give JAX's logits
  and tokens;
* the eval CLI's ``--generate ... --streaming_window`` prints JAX's text.

The same weights go into both packages (an HF model, or one artifact
loaded by each).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402
import test_torch_archs  # noqa: E402
import test_torch_evals  # noqa: E402
import test_torch_moe  # noqa: E402

from modegpt_tpu.compress import artifact as j_artifact  # noqa: E402
from modegpt_tpu.evals.cli import main as j_eval_main  # noqa: E402
from modegpt_tpu.models import padded as j_padded  # noqa: E402
from modegpt_tpu.models import params_from_hf_model as j_params_from_hf  # noqa: E402
from modegpt_tpu.models.streaming import streaming_generate as j_stream  # noqa: E402
from modegpt_tpu_torch.compress import artifact as t_artifact  # noqa: E402
from modegpt_tpu_torch.evals.cli import main as t_eval_main  # noqa: E402
from modegpt_tpu_torch.models import padded as t_padded  # noqa: E402
from modegpt_tpu_torch.models.hf import params_from_hf_model as t_params_from_hf  # noqa: E402
from modegpt_tpu_torch.models.streaming import _rel_positions, streaming_generate as t_stream  # noqa: E402


def _tiny_opt():
    cfg = transformers.OPTConfig(
        vocab_size=128, hidden_size=48, ffn_dim=96, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=64, word_embed_proj_dim=48,
    )
    torch.manual_seed(0)
    return transformers.OPTForCausalLM(cfg).eval()


def _models(hf_model):
    """(JAX PaddedModel, port PaddedModel) of one HF model."""
    j_spec, j_params = j_params_from_hf(hf_model)
    t_spec, t_params = t_params_from_hf(hf_model, device="cpu")
    return j_padded.pad_to_uniform(j_spec, j_params), t_padded.pad_to_uniform(t_spec, t_params)


@pytest.fixture(scope="module")
def compressed(tmp_path_factory):
    """The eval tests' compressed tiny llama (rotary masks, per-layer
    ranks, a word-level tokenizer), loaded by both packages."""
    from modegpt_tpu_torch.compress.pipeline import run_compression
    from modegpt_tpu_torch.config import CompressionConfig

    root = tmp_path_factory.mktemp("stream")
    spec, params = t_params_from_hf(test_torch_evals._tiny_llama(seed=3), device="cpu")
    config = CompressionConfig(
        model="in-memory", dataset="synthetic", calib_size=4, calibs_batch_size=2, seq_len=48,
        compression_ratio=0.3, sparsity_smoothing=0.1, device="cpu",
        output_dir=str(root / "o"), temp_storage_dir=str(root / "l"), metrics_dir=str(root / "m"),
        skip_baseline_eval=True, skip_final_eval=True,
    )
    path = run_compression(config, spec=spec, params=params)["artifact_dir"]
    test_torch_evals._word_tokenizer().save_pretrained(path)
    j_spec, j_params, _ = j_artifact.load_compressed_model(path)
    t_spec, t_params, _ = t_artifact.load_compressed_model(path, device="cpu")
    return path, j_padded.pad_to_uniform(j_spec, j_params), t_padded.pad_to_uniform(t_spec, t_params)


def _ids(B, T, seed=0, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(np.int32)


def _assert_stream_equal(jpm, tpm, ids, **kw):
    want = np.asarray(j_stream(jpm, ids, **kw))
    got = t_stream(tpm, ids, **kw)
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("name", ["llama", "opt"])
def test_stream_within_window_is_greedy(name):
    jpm, tpm = _models(test_torch_evals._tiny_llama() if name == "llama" else _tiny_opt())
    ids = _ids(2, 10)
    got = _assert_stream_equal(jpm, tpm, ids, max_new_tokens=12, window=32, n_sink=4)
    greedy = t_padded.generate_padded(tpm, ids, max_new_tokens=12).numpy()
    np.testing.assert_array_equal(got, greedy)


def test_stream_beyond_window_evicts():
    """Prompt + new = 64 through a 16-position window: the JAX tokens,
    and plain greedy's until the first eviction."""
    jpm, tpm = _models(test_torch_evals._tiny_llama())
    ids = _ids(2, 12, seed=1)
    got = _assert_stream_equal(jpm, tpm, ids, max_new_tokens=52, window=16, n_sink=2)
    greedy = t_padded.generate_padded(tpm, ids, max_new_tokens=52).numpy()
    np.testing.assert_array_equal(got[:, :16], greedy[:, :16])  # nothing evicted yet
    assert got.shape == (2, 64)


def test_stream_compressed_with_rotary_masks(compressed):
    _, jpm, tpm = compressed
    assert "rotary_mask" in tpm.layers
    _assert_stream_equal(jpm, tpm, _ids(2, 6, seed=2), max_new_tokens=30, window=12, n_sink=3)


@pytest.mark.parametrize("arch", ["mistral", "gemma2"])
def test_stream_under_the_models_sliding_window(arch):
    """The model's own window (8) inside a 24-position stream window:
    uniform on mistral, alternating layers on gemma2 (with its caps)."""
    jpm, tpm = _models(test_torch_archs._hf(arch))
    assert tpm.spec.sliding_window == 8
    _assert_stream_equal(jpm, tpm, _ids(1, 9, seed=3), max_new_tokens=30, window=24, n_sink=4)


def test_stream_mixed_moe_stack():
    jpm, tpm = _models(test_torch_moe._hf("qwen3_moe_mixed"))
    _assert_stream_equal(jpm, tpm, _ids(2, 5, seed=4), max_new_tokens=20, window=16, n_sink=2)


def test_stream_errors_match_jax():
    jpm, tpm = _models(_tiny_opt())
    ids = _ids(1, 8)
    cases = [
        dict(max_new_tokens=4, window=4, n_sink=4),  # n_sink >= window
        dict(max_new_tokens=4, window=128, n_sink=4),  # window > max_position_embeddings
        dict(max_new_tokens=40, window=32, n_sink=4),  # learned positions beyond the window
    ]
    for kw in cases:
        with pytest.raises(ValueError) as want:
            j_stream(jpm, ids, **kw)
        with pytest.raises(ValueError) as got:
            t_stream(tpm, ids, **kw)
        assert str(got.value) == str(want.value)


def test_rel_positions_match_jax():
    from modegpt_tpu.models.streaming import _rel_positions as j_rel

    for g in (0, 3, 5, 11, 12, 29, 100):
        want = [np.asarray(a) for a in j_rel(jnp.int32(g), 12, 3, 9)]
        got = _rel_positions(g, 12, 3, 9)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_prefill_and_generate_padded_match_jax(compressed):
    _, jpm, tpm = compressed
    ids = _ids(2, 7, seed=5)
    j_cache = j_padded.init_cache_padded(jpm, 2, 20)
    t_cache = t_padded.init_cache_padded(tpm, 2, 20)
    want, j_cache = j_padded.prefill_padded(jpm, jnp.asarray(ids), j_cache)
    got, t_cache = t_padded.prefill_padded(tpm, torch.as_tensor(ids).long(), t_cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert t_cache[2] == int(j_cache[2]) == 7
    for eos in (None, 5):
        want = np.asarray(j_padded.generate_padded(jpm, ids, max_new_tokens=9, eos_token_id=eos))
        got = t_padded.generate_padded(tpm, ids, max_new_tokens=9, eos_token_id=eos).numpy()
        np.testing.assert_array_equal(got, want)


def test_eval_cli_streaming_window_matches_jax(compressed, capsys):
    path = compressed[0]
    flags = ["--model", path, "--generate", "tok1 tok2 tok3 one two", "--max_new_tokens", "20",
             "--streaming_window", "12", "--streaming_sinks", "2"]
    got = t_eval_main(flags + ["--device", "cpu"])
    want = j_eval_main(flags)
    assert got["generation"] == want["generation"]
    assert got["generation"].startswith("tok1 tok2 tok3 one two")
    assert len(got["generation"].split()) == 25
