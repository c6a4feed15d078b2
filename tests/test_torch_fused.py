"""The port's fused compression against the JAX package's, on the CPU.

`compress/fused.fused_compress` beside JAX's ``fused_compress`` and beside
the port's own chunked pipeline on the same tiny HF models (llama MHA and
GQA, qwen3 with its q/k norms); `ops/allocation._allocate` beside its JAX
version on the same seeded numpy inputs. Tolerances: ranks, rotary masks
and kept indices identical; the selected rows (up, gate, q, k) bit for
bit against the port's pipeline and to 2e-3 against JAX; the re-solved
down to 2e-3; V/O as sign-free per-head products to 5e-4.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from modegpt_tpu.calib.data import load_calibration_batches  # noqa: E402
from modegpt_tpu.compress.fused import fused_compress as j_fused  # noqa: E402
from modegpt_tpu.compress.pipeline import run_compression as j_run  # noqa: E402
from modegpt_tpu.config import CompressionConfig as JConfig  # noqa: E402
from modegpt_tpu.models import params_from_hf_model as j_params_from_hf  # noqa: E402
from modegpt_tpu.ops.allocation import _allocate as j_allocate  # noqa: E402
from modegpt_tpu_torch.compress.fused import fused_compress, supports_fused  # noqa: E402
from modegpt_tpu_torch.compress.pipeline import compress_in_memory, run_compression  # noqa: E402
from modegpt_tpu_torch.config import CompressionConfig  # noqa: E402
from modegpt_tpu_torch.models.forward import forward  # noqa: E402
from modegpt_tpu_torch.models.hf import params_from_hf_model  # noqa: E402
from modegpt_tpu_torch.ops.allocation import _allocate  # noqa: E402


def _tiny(seed=0, n_kv=2, arch="llama"):
    common = dict(
        vocab_size=128, hidden_size=64, intermediate_size=144, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=n_kv, max_position_embeddings=128,
        tie_word_embeddings=False,
    )
    torch.manual_seed(seed)
    if arch == "qwen3":
        return transformers.Qwen3ForCausalLM(transformers.Qwen3Config(**common, head_dim=16)).eval()
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(**common)).eval()


def _config(cls, tmp, **kw):
    if cls is CompressionConfig:
        kw.setdefault("device", "cpu")
    return cls(
        model="mem", dataset="synthetic", calib_size=4, calibs_batch_size=2, seq_len=48,
        compression_ratio=0.3, sparsity_smoothing=0.5, solver_precision="f32_device",
        eval_max_samples=4, eval_batch_size=2,
        output_dir=str(tmp / "o"), temp_storage_dir=str(tmp / "l"), metrics_dir=str(tmp / "m"), **kw,
    )


def _vo(lp, spec, r):
    """[Hk, G, d, d] products of each kv head's V with its group's O."""
    v = np.asarray(lp["v"]["kernel"], dtype=np.float64)  # [d, Hk*r]
    o = np.asarray(lp["o"]["kernel"], dtype=np.float64)  # [H*r, d]
    G = spec.n_heads // spec.n_kv_heads
    return np.stack([
        np.stack([v[:, h * r:(h + 1) * r] @ o[(h * G + g) * r:(h * G + g + 1) * r] for g in range(G)])
        for h in range(spec.n_kv_heads)
    ])


@pytest.mark.parametrize("n_kv,arch", [(4, "llama"), (2, "llama"), (2, "qwen3")], ids=["mha", "gqa", "qwen3"])
def test_fused_equals_pipeline_and_jax(tmp_path, n_kv, arch):
    """The fused job equals the port's chunked job (JAX test_fused's
    check) and JAX's fused_compress."""
    model = _tiny(seed=n_kv, n_kv=n_kv, arch=arch)
    spec, params = params_from_hf_model(model, device="cpu")
    assert supports_fused(spec)
    batches = load_calibration_batches(None, "synthetic", 4, 2, 48, vocab_size=spec.vocab_size)
    ref = run_compression(_config(CompressionConfig, tmp_path / "ref", skip_baseline_eval=True,
                                  skip_final_eval=True),
                          spec=spec, params=params, calib_batches=batches)
    rspec, rparams = ref["compressed_spec"], ref["compressed_params"]
    cspec, cparams = fused_compress(spec, params, batches, _config(CompressionConfig, tmp_path / "f"))
    assert cspec == rspec
    for l in range(spec.n_layers):
        c, r = cparams["layers"][l], rparams["layers"][l]
        torch.testing.assert_close(c["rotary_mask"], r["rotary_mask"], rtol=0, atol=0)
        for key in ("up", "gate", "q", "k"):
            torch.testing.assert_close(c[key]["kernel"], r[key]["kernel"], rtol=0, atol=0)
        torch.testing.assert_close(c["down"]["kernel"], r["down"]["kernel"], rtol=2e-3, atol=1e-5)
        rv = cspec.v_ranks[l] // spec.n_kv_heads
        np.testing.assert_allclose(_vo(c, spec, rv), _vo(r, spec, rv), rtol=5e-4, atol=5e-5)

    j_spec, j_params = j_params_from_hf(model)
    jspec, jparams = j_fused(j_spec, j_params, batches, _config(JConfig, tmp_path / "j"))
    assert (list(cspec.gate_ranks), list(cspec.q_ranks)) == (list(jspec.gate_ranks), list(jspec.q_ranks))
    for l in range(spec.n_layers):
        c, j = cparams["layers"][l], jparams["layers"][l]
        np.testing.assert_array_equal(c["rotary_mask"].numpy(), np.asarray(j["rotary_mask"]))
        for key in ("up", "gate", "q", "k", "down"):
            np.testing.assert_allclose(c[key]["kernel"].numpy(), np.asarray(j[key]["kernel"]), rtol=2e-3,
                                       atol=1e-5, err_msg=f"layer {l} {key}")
        rv = cspec.v_ranks[l] // spec.n_kv_heads
        np.testing.assert_allclose(_vo(c, spec, rv), _vo({k: {"kernel": np.asarray(j[k]["kernel"])} for k in "vo"},
                                                          spec, rv), rtol=5e-4, atol=5e-5)

    ids = torch.as_tensor(np.random.default_rng(0).integers(0, 128, size=(2, 16)))
    want, _ = forward(rspec, rparams, ids)
    got, _ = forward(cspec, cparams, ids)
    torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4)


def test_fused_rejects_unsupported():
    cfg = transformers.OPTConfig(
        vocab_size=128, hidden_size=48, ffn_dim=96, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=64, word_embed_proj_dim=48,
    )
    torch.manual_seed(0)
    spec, params = params_from_hf_model(transformers.OPTForCausalLM(cfg).eval(), device="cpu")
    assert not supports_fused(spec)
    with pytest.raises(ValueError, match="fused_compress covers"):
        fused_compress(spec, params, [np.zeros((2, 16), np.int32)], CompressionConfig(device="cpu"))


def test_fused_through_run_compression_matches_jax(tmp_path):
    """fused=True through run_compression: the artifact is saved and
    reloaded, both evaluations run, and the ranks and perplexities are
    JAX's fused job's (the existing pipeline test's tolerance)."""
    model = _tiny(seed=7, n_kv=2)
    spec, params = params_from_hf_model(model, device="cpu")
    got = run_compression(_config(CompressionConfig, tmp_path / "t", fused=True), spec=spec, params=params)
    assert got["compressed_spec"].has_rotary_masks and "fused" in got["step_seconds"]
    j_spec, j_params = j_params_from_hf(model)
    want = j_run(_config(JConfig, tmp_path / "j", fused=True), spec=j_spec, params=j_params)
    assert list(got["compressed_spec"].gate_ranks) == list(want["compressed_spec"].gate_ranks)
    np.testing.assert_allclose(got["baseline_ppl"], want["baseline_ppl"], rtol=1e-5)
    np.testing.assert_allclose(got["compressed_ppl"], want["compressed_ppl"], rtol=1e-3)


def test_compress_in_memory_fused_equals_fused_compress(tmp_path):
    spec, params = params_from_hf_model(_tiny(seed=3), device="cpu")
    config = _config(CompressionConfig, tmp_path, fused=True)
    batches = load_calibration_batches(None, "synthetic", 4, 2, 48, vocab_size=spec.vocab_size)
    want_spec, want = fused_compress(spec, params, batches, config)
    got_spec, got = compress_in_memory(spec, params, config)
    assert got_spec == want_spec
    for l in range(spec.n_layers):
        for key in ("up", "gate", "down", "q", "k", "v", "o"):
            torch.testing.assert_close(got["layers"][l][key]["kernel"], want["layers"][l][key]["kernel"],
                                       rtol=0, atol=0)


def test_fused_leaves_params_untouched(tmp_path):
    """The caller's tree keeps every dense leaf, by identity and value."""
    spec, params = params_from_hf_model(_tiny(seed=5), device="cpu")
    before = {(l, k): t for l, lp in enumerate(params["layers"]) for k, v in lp.items()
              for t in ([v["kernel"]] if isinstance(v, dict) and "kernel" in v else [])}
    copies = {key: t.clone() for key, t in before.items()}
    batches = load_calibration_batches(None, "synthetic", 4, 2, 48, vocab_size=spec.vocab_size)
    fused_compress(spec, params, batches, _config(CompressionConfig, tmp_path))
    for (l, k), t in before.items():
        assert params["layers"][l][k]["kernel"] is t
        torch.testing.assert_close(t, copies[(l, k)], rtol=0, atol=0)


def test_fused_solves_in_float32_on_the_device(tmp_path):
    """The fused job solves in float32 on the parameters' device whatever
    ``solver_precision`` says, as JAX's does: an ``f64_cpu`` config gives
    the ``f32_device`` factors."""
    spec, params = params_from_hf_model(_tiny(seed=6), device="cpu")
    batches = load_calibration_batches(None, "synthetic", 4, 2, 48, vocab_size=spec.vocab_size)
    want_spec, want = fused_compress(spec, params, batches, _config(CompressionConfig, tmp_path))
    got_spec, got = fused_compress(spec, params, batches,
                                   dataclasses.replace(_config(CompressionConfig, tmp_path), solver_precision="f64_cpu"))
    assert got_spec == want_spec
    for l in range(spec.n_layers):
        for key in ("up", "gate", "down", "q", "k", "v", "o"):
            torch.testing.assert_close(got["layers"][l][key]["kernel"], want["layers"][l][key]["kernel"],
                                       rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("smoothing,max_sp", [(0.5, 0.8), (0.015, 0.8), (0.05, 0.4)])
def test_allocate_tensor_form_matches_jax(dtype, smoothing, max_sp):
    """`_allocate` on a score tensor gives the JAX `_allocate`'s keep
    ratios in that dtype (float64 with x64 off is JAX's float32)."""
    bi = np.random.default_rng(1).uniform(0.01, 0.3, size=8).astype(dtype)
    keep, max_s = _allocate(torch.as_tensor(bi), 0.3, smoothing, max_sp, False)
    assert keep.dtype == getattr(torch, dtype)
    j_keep, j_max = j_allocate(jnp.asarray(bi), 0.3, smoothing, max_sp, False)
    tol = 1e-6 if dtype == "float32" or not jax.config.jax_enable_x64 else 1e-12
    np.testing.assert_allclose(keep.numpy(), np.asarray(j_keep), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(max_s), float(j_max), rtol=tol, atol=tol)
