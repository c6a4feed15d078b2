"""Parity: the port's `models.speculative` against the JAX package's.

Greedy `speculative_generate` (a compressed draft, or the target drafting
for itself) and `prompt_lookup_generate` must give the JAX functions'
tokens and per-sequence stats on the same seeded prompts, batched rows
equal to each row alone, and EOS must stop a row where greedy decode
stops it. Sampled mode (a `torch.Generator` where JAX takes a key) is
held to the laws of the JAX tests: the residual law, the first token's
distribution against the target's softmax, per-position marginals
against plain sampling, and near-full acceptance when the target drafts
for itself.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from modegpt_tpu.models import params_from_hf_model as j_params_from_hf  # noqa: E402
from modegpt_tpu.models.padded import pad_to_uniform as j_pad  # noqa: E402
from modegpt_tpu.models.speculative import prompt_lookup_generate as j_lookup  # noqa: E402
from modegpt_tpu.models.speculative import speculative_generate as j_spec  # noqa: E402
from modegpt_tpu.models.spec import ModelSpec as JSpec  # noqa: E402
from modegpt_tpu_torch.models.convert import params_from_numpy, to_numpy  # noqa: E402
from modegpt_tpu_torch.models.forward import forward as t_forward  # noqa: E402
from modegpt_tpu_torch.models.generate import generate as t_generate  # noqa: E402
from modegpt_tpu_torch.models.padded import pad_to_uniform as t_pad  # noqa: E402
from modegpt_tpu_torch.models.spec import ModelSpec as TSpec  # noqa: E402
from modegpt_tpu_torch.models.speculative import (  # noqa: E402
    prompt_lookup_generate,
    residual_sample,
    speculative_generate,
)


def _tiny_llama():
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=144, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
    )
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(cfg).eval()


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_host(v) for v in tree]
    return to_numpy(tree)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{"target": (JAX padded, port padded, port spec, port params),
    "draft": (JAX padded, port padded)}: the dense tiny llama and its
    compression by the port's pipeline, carried into the JAX package."""
    from modegpt_tpu_torch.compress.pipeline import run_compression
    from modegpt_tpu_torch.config import CompressionConfig

    j_spec, j_params = j_params_from_hf(_tiny_llama())
    t_spec = TSpec.from_dict(j_spec.to_dict())
    t_params = params_from_numpy(jax.device_get(j_params), "cpu")
    root = tmp_path_factory.mktemp("spec")
    config = CompressionConfig(
        model="in-memory", dataset="synthetic", calib_size=4, calibs_batch_size=2, seq_len=48,
        compression_ratio=0.3, sparsity_smoothing=0.1, device="cpu",
        output_dir=str(root / "o"), temp_storage_dir=str(root / "l"), metrics_dir=str(root / "m"),
        skip_baseline_eval=True, skip_final_eval=True,
    )
    res = run_compression(config, spec=t_spec, params=params_from_numpy(jax.device_get(j_params), "cpu"))
    c_host = jax.tree_util.tree_map(jnp.asarray, _host(res["compressed_params"]))
    return {
        "target": (j_pad(j_spec, j_params), t_pad(t_spec, t_params), t_spec, t_params),
        "draft": (j_pad(JSpec.from_dict(res["compressed_spec"].to_dict()), c_host),
                  t_pad(res["compressed_spec"], res["compressed_params"])),
    }


def _ids(rng_seed, shape):
    return np.random.default_rng(rng_seed).integers(0, 128, size=shape).astype(np.int32)


def _stats(stats):
    return [np.asarray(s).tolist() for s in stats]


@pytest.mark.parametrize("B", [1, 3])
def test_speculative_greedy_matches_jax(models, B):
    """A compressed draft for the dense target: the JAX function's tokens
    and stats, the target's greedy decode, and each row alone equal to
    its row of the batch."""
    (jt, tt, t_spec, t_params), (jd, td) = models["target"], models["draft"]
    ids = _ids(B, (B, 6))
    want, j_stats = j_spec(jd, jt, ids, max_new_tokens=12, n_draft=3, return_stats=True)
    got, stats = speculative_generate(td, tt, ids, max_new_tokens=12, n_draft=3, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _stats(stats) == _stats(j_stats)
    np.testing.assert_array_equal(got.numpy(), t_generate(t_spec, t_params, ids, max_new_tokens=12).numpy())
    for b in range(B):
        np.testing.assert_array_equal(
            speculative_generate(td, tt, ids[b : b + 1], max_new_tokens=12, n_draft=3).numpy(), got.numpy()[b : b + 1])


def test_speculative_self_draft_accepts_everything(models):
    jt, tt = models["target"][:2]
    ids = _ids(5, (1, 5))
    out, stats = speculative_generate(tt, tt, ids, max_new_tokens=11, n_draft=4, return_stats=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_spec(jt, jt, ids, max_new_tokens=11, n_draft=4)))
    assert stats.accepted.sum() == stats.drafted.sum() and stats.rounds[0] == 2


def test_speculative_eos_stops(models):
    jt, tt = models["target"][:2]
    jd, td = models["draft"]
    ids = _ids(7, (2, 5))
    ref = speculative_generate(tt, tt, ids, max_new_tokens=8, n_draft=3).numpy()
    eos = int(ref[0, 5 + 2])
    for draft_pair in ((jt, tt), (jd, td)):
        got = speculative_generate(draft_pair[1], tt, ids, max_new_tokens=8, n_draft=3, eos_token_id=eos).numpy()
        want = np.asarray(j_spec(draft_pair[0], jt, ids, max_new_tokens=8, n_draft=3, eos_token_id=eos))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[0, : 5 + 3], ref[0, : 5 + 3])
        assert (got[0, 5 + 3 :] == eos).all()


def test_prompt_lookup_matches_jax(models):
    """On a repetitive prompt (drafts accepted) and a random one: the JAX
    function's tokens and stats, the model's greedy decode."""
    jt, tt, t_spec, t_params = models["target"]
    cycle = _ids(9, (6,))
    prompt = np.concatenate([cycle, cycle, cycle])[None]
    got, stats = prompt_lookup_generate(tt, prompt, max_new_tokens=10, n_draft=6, ngram=3, return_stats=True)
    want, j_stats = j_lookup(jt, prompt, max_new_tokens=10, n_draft=6, ngram=3, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _stats(stats) == _stats(j_stats)
    assert stats.rounds[0] >= 1 and stats.drafted[0] > 0
    np.testing.assert_array_equal(got.numpy(), t_generate(t_spec, t_params, prompt, max_new_tokens=10).numpy())
    prompt2 = _ids(10, (1, 9))
    np.testing.assert_array_equal(prompt_lookup_generate(tt, prompt2, max_new_tokens=7, n_draft=4).numpy(),
                                  np.asarray(j_lookup(jt, prompt2, max_new_tokens=7, n_draft=4)))
    with pytest.raises(ValueError, match="shorter than the prompt"):
        prompt_lookup_generate(tt, prompt2[:, :3], ngram=3)


def test_prompt_lookup_batched_and_eos(models):
    jt, tt, t_spec, t_params = models["target"]
    prompts = _ids(11, (3, 8))
    got, stats = prompt_lookup_generate(tt, prompts, max_new_tokens=6, n_draft=4, ngram=3, eos_token_id=5,
                                        return_stats=True)
    want, j_stats = j_lookup(jt, prompts, max_new_tokens=6, n_draft=4, ngram=3, eos_token_id=5, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _stats(stats) == _stats(j_stats)
    ref = t_generate(t_spec, t_params, prompts, max_new_tokens=6, eos_token_id=5).numpy()
    np.testing.assert_array_equal(got.numpy(), ref)


def test_residual_sample_law():
    """residual_sample draws from norm(max(q - p, 0)), nothing where q <= p."""
    q = torch.tensor([0.5, 0.3, 0.15, 0.05], dtype=torch.float64)
    p = torch.tensor([0.1, 0.6, 0.25, 0.05], dtype=torch.float64)
    r = torch.clamp(q - p, min=0)
    r = (r / r.sum()).numpy()
    draws = residual_sample(q.expand(4096, 4), p.expand(4096, 4), torch.Generator().manual_seed(0)).numpy()
    emp = np.bincount(draws, minlength=4) / draws.size
    np.testing.assert_allclose(emp, r, atol=0.03)
    assert emp[1] == 0.0 and emp[3] == 0.0
    # no residual mass: the row samples q
    same = residual_sample(q.expand(2048, 4), q.expand(2048, 4), torch.Generator().manual_seed(1)).numpy()
    np.testing.assert_allclose(np.bincount(same, minlength=4) / same.size, q.numpy(), atol=0.04)


def test_sampled_first_token_distribution(models):
    """The first token is distributed as sampling from the target: total
    variation against its softmax below the JAX test's 0.15 at N = 2048."""
    tt, t_spec, t_params = models["target"][1:]
    temp, prompt = 0.8, _ids(12, (1, 6))
    logits, _ = t_forward(t_spec, t_params, torch.from_numpy(prompt).long())
    q = torch.softmax(logits[0, -1].double() / temp, dim=-1).numpy()
    N = 2048
    out = speculative_generate(tt, tt, np.repeat(prompt, N, axis=0), max_new_tokens=1, n_draft=3,
                               temperature=temp, generator=torch.Generator().manual_seed(7)).numpy()
    emp = np.bincount(out[:, 6], minlength=128) / N
    assert 0.5 * np.abs(emp - q).sum() < 0.15


def test_sampled_matches_plain_sampling_marginals(models):
    """Compressed draft, dense target: per-position marginals of sampled
    speculative decoding against plain sampling from the target (two
    1024-sample empiricals, total variation below the JAX test's 0.25)."""
    tt, t_spec, t_params = models["target"][1:]
    td = models["draft"][1]
    temp, P, T_new, N = 0.9, 5, 3, 1024
    ids = np.repeat(_ids(13, (1, P)), N, axis=0)
    spec_out = speculative_generate(td, tt, ids, max_new_tokens=T_new, n_draft=2, temperature=temp,
                                    generator=torch.Generator().manual_seed(3)).numpy()
    plain = t_generate(t_spec, t_params, ids, max_new_tokens=T_new, temperature=temp,
                       generator=torch.Generator().manual_seed(11)).numpy()
    for t in range(T_new):
        a = np.bincount(spec_out[:, P + t], minlength=128) / N
        b = np.bincount(plain[:, P + t], minlength=128) / N
        assert 0.5 * np.abs(a - b).sum() < 0.25, t


def test_sampled_self_draft_and_generator_required(models):
    """The target drafting for itself at temperature 0.7 accepts ~every
    draft; sampling without a generator raises."""
    tt = models["target"][1]
    ids = _ids(14, (4, 5))
    out, stats = speculative_generate(tt, tt, ids, max_new_tokens=12, n_draft=4, temperature=0.7,
                                      generator=torch.Generator().manual_seed(5), return_stats=True)
    assert out.shape == (4, 5 + 12) and bool(((out >= 0) & (out < 128)).all())
    assert stats.accepted.sum() / stats.drafted.sum() > 0.95 and stats.rounds.sum() >= 4
    with pytest.raises(ValueError, match="requires a torch.Generator"):
        speculative_generate(tt, tt, ids, max_new_tokens=4, temperature=0.5)
