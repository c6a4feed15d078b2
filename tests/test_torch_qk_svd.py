"""The whitened-SVD Q/K solver (``qk_method="svd"``) against the JAX package, on the CPU.

* `ops.qk.compress_qk_layer_svd` on the same numpy inputs in float64,
  with and without biases, at rank 2 and at full rank. SVD factors are
  unique only up to a sign per singular pair, so what is compared is
  what the signs leave alone: each head's bilinear form ``Q_h^T K_h``
  (relative 1e-9), the bias cross-terms ``b_q'^T K_h`` and
  ``Q_h^T b_k'`` (1e-9), and at full rank ``Wq_h^T Wk_h`` itself;
* `run_compression` with ``qk_method="svd"`` on a tiny OPT and a tiny
  GPT-2: the JAX job's rank lists, its baseline perplexity to rtol 1e-5
  and its compressed perplexity to 1e-3;
* the streamed job, host-staged with slimmed flush windows, gives the
  resident job's factors (the slim keeps q/k for this solver), and its
  ``profile_dir`` gets one trace.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from modegpt_tpu.compress.pipeline import run_compression as j_run  # noqa: E402
from modegpt_tpu.config import CompressionConfig as JConfig  # noqa: E402
from modegpt_tpu.models import params_from_hf_model as j_params_from_hf  # noqa: E402
from modegpt_tpu.ops.qk import compress_qk_layer_svd as j_svd  # noqa: E402
from modegpt_tpu_torch.compress import offload  # noqa: E402
from modegpt_tpu_torch.compress.artifact import load_layer_factors  # noqa: E402
from modegpt_tpu_torch.compress.pipeline import run_compression as t_run  # noqa: E402
from modegpt_tpu_torch.config import CompressionConfig as TConfig  # noqa: E402
from modegpt_tpu_torch.models.hf import params_from_hf_model as t_params_from_hf  # noqa: E402
from modegpt_tpu_torch.models.spec import spec_from_hf_config  # noqa: E402
from modegpt_tpu_torch.ops.qk import compress_qk_layer_svd as t_svd  # noqa: E402

H, HD, D = 3, 8, 24


def _inputs(seed, bias):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((4 * D, D)) * rng.uniform(0.3, 2.0, D)
    cov = X.T @ X / X.shape[0]
    W_q, W_k = rng.standard_normal((H * HD, D)), rng.standard_normal((H * HD, D))
    b_q = rng.standard_normal(H * HD) if bias else None
    b_k = rng.standard_normal(H * HD) if bias else None
    return cov, W_q, W_k, b_q, b_k


def _heads(W, r):
    return np.asarray(W).reshape(H, r, D)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("rank", [2, HD], ids=["rank2", "full"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_svd_solver_matches_jax(rank, bias):
    cov, W_q, W_k, b_q, b_k = _inputs(7, bias)
    J = (lambda a: None if a is None else jnp.asarray(a))
    T = (lambda a: None if a is None else torch.from_numpy(a))
    want = j_svd(J(cov), J(W_q), J(W_k), J(b_q), J(b_k), rank, 1e-6, H)
    got = t_svd(T(cov), T(W_q), T(W_k), T(b_q), T(b_k), rank, 1e-6, H)
    assert got.rotary_mask is None and got.q.dtype == torch.float64
    assert tuple(got.q.shape) == tuple(got.k.shape) == (H * rank, D)
    gq, gk = _heads(got.q.numpy(), rank), _heads(got.k.numpy(), rank)
    wq, wk = _heads(want.q, rank), _heads(want.k, rank)
    for h in range(H):
        # the bilinear form of each head: free of the per-pair signs
        assert _rel(gq[h].T @ gk[h], wq[h].T @ wk[h]) < 1e-9
        if rank == HD:  # full rank: the whitening cancels exactly
            Wq_h, Wk_h = W_q.reshape(H, HD, D)[h], W_k.reshape(H, HD, D)[h]
            assert _rel(gq[h].T @ gk[h], Wq_h.T @ Wk_h) < 1e-9
    if not bias:
        assert got.q_bias is None and want.q_bias is None
        return
    gbq, gbk = got.q_bias.numpy().reshape(H, rank), got.k_bias.numpy().reshape(H, rank)
    wbq, wbk = np.asarray(want.q_bias).reshape(H, rank), np.asarray(want.k_bias).reshape(H, rank)
    for h in range(H):
        assert _rel(gbq[h] @ gk[h], wbq[h] @ wk[h]) < 1e-9  # b_q'^T K_h
        assert _rel(gq[h].T @ gbk[h], wq[h].T @ wbk[h]) < 1e-9  # Q_h^T b_k'
        if rank == HD:  # full rank reproduces the original cross-terms
            Wq_h, Wk_h = W_q.reshape(H, HD, D)[h], W_k.reshape(H, HD, D)[h]
            bq_h, bk_h = b_q.reshape(H, HD)[h], b_k.reshape(H, HD)[h]
            assert _rel(gbq[h] @ gk[h], bq_h @ Wk_h) < 1e-9
            assert _rel(gq[h].T @ gbk[h], Wq_h.T @ bk_h) < 1e-9


def test_svd_solver_scale_balance():
    """alpha = sqrt(max|K| / max|Q|) leaves max|Q| == max|K| per head."""
    cov, W_q, W_k, b_q, b_k = _inputs(3, True)
    got = t_svd(*(torch.from_numpy(a) for a in (cov, W_q, W_k, b_q, b_k)), 4, 1e-6, H)
    q, k = _heads(got.q.numpy(), 4), _heads(got.k.numpy(), 4)
    for h in range(H):
        np.testing.assert_allclose(np.abs(q[h]).max(), np.abs(k[h]).max(), rtol=1e-12)


def _layer_normed_inputs(seed, n_tokens=1024):
    """float32 inputs whose Gram is a layer norm's output: mean-subtracted
    rows scaled by gamma, plus a beta with no component along 1/gamma, so
    the Gram keeps one direction of almost no energy (pre-LN OPT)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_tokens, D * 4 // 3)) * rng.uniform(0.5, 2.0, D * 4 // 3)
    x -= x.mean(1, keepdims=True)
    x /= np.sqrt((x**2).mean(1, keepdims=True))
    g = 1 + 0.02 * rng.standard_normal(x.shape[1])
    b = 0.02 * rng.standard_normal(x.shape[1])
    b -= g * (b / g).sum() / x.shape[1]
    x = x * g + b
    W_q, W_k = 0.1 * rng.standard_normal((2, H * HD, x.shape[1]))
    b_q, b_k = 0.02 * rng.standard_normal((2, H * HD))
    return [torch.from_numpy(a.astype(np.float32)) for a in (x.T @ x / n_tokens, W_q, W_k, b_q, b_k)]


def test_svd_solver_float32_on_a_layer_normed_gram():
    """A float32 solve on a layer-normed Gram stays within 1e-3 of the
    float64 solve of the same Gram (each head's Q_h^T K_h). A float32
    eigh puts the Gram's smallest eigenvalue below minus the ridge, where
    the clamp would scale that direction by 1e12; the solver's whitening
    eigh runs in float64 for that reason."""
    cov, W_q, W_k, b_q, b_k = _layer_normed_inputs(3)
    ridge, rank, d = 1e-8, 2, cov.shape[0]
    assert torch.linalg.eigh(cov)[0][0] < -ridge < 0 < torch.linalg.eigh(cov.double())[0][0] + ridge
    got = t_svd(cov, W_q, W_k, b_q, b_k, rank, ridge, H)
    want = t_svd(*(t.double() for t in (cov, W_q, W_k, b_q, b_k)), rank, ridge, H)
    assert got.q.dtype == torch.float32
    forms = [f.q.double().reshape(H, rank, d).transpose(1, 2) @ f.k.double().reshape(H, rank, d) for f in (got, want)]
    assert _rel(forms[0].numpy(), forms[1].numpy()) < 1e-3


def _tiny_opt():
    cfg = transformers.OPTConfig(
        vocab_size=256, hidden_size=48, ffn_dim=128, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=256, word_embed_proj_dim=48,
    )
    torch.manual_seed(0)
    return transformers.OPTForCausalLM(cfg).eval()


def _tiny_gpt2():
    cfg = transformers.GPT2Config(vocab_size=256, n_embd=48, n_layer=2, n_head=4, n_positions=128)
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(cfg).eval()


def _config(cls, root, **kw):
    defaults = dict(
        model="in-memory", dataset="synthetic", calib_size=8, calibs_batch_size=4, seq_len=64,
        eval_batch_size=4, eval_max_samples=8, compression_ratio=0.3, sparsity_smoothing=0.5,
        max_sparsity=0.8, qk_method="svd", output_dir=str(root / "out"),
        temp_storage_dir=str(root / "layers"), metrics_dir=str(root / "metrics"),
    )
    defaults.update(kw)
    return cls(**defaults)


@pytest.mark.parametrize("make_model", [_tiny_opt, _tiny_gpt2], ids=["opt", "gpt2"])
def test_svd_job_matches_jax(tmp_path, make_model):
    model = make_model()
    j_spec, j_params = j_params_from_hf(model)
    t_spec, t_params = t_params_from_hf(model, device="cpu")
    want = j_run(_config(JConfig, tmp_path / "jax"), spec=j_spec, params=j_params)
    got = t_run(_config(TConfig, tmp_path / "port", device="cpu"), spec=t_spec, params=t_params)
    ws, gs = want["compressed_spec"], got["compressed_spec"]
    for ranks in ("q_ranks", "k_ranks", "v_ranks", "o_ranks", "gate_ranks"):
        assert getattr(gs, ranks) == getattr(ws, ranks), ranks
    assert sum(gs.q_ranks) < sum(t_spec.q_ranks) and not gs.has_rotary_masks
    np.testing.assert_allclose(got["baseline_ppl"], want["baseline_ppl"], rtol=1e-5)
    np.testing.assert_allclose(got["compressed_ppl"], want["compressed_ppl"], rtol=1e-3)
    # the factor store holds the SVD's factors (not row slices of W_q)
    r = gs.q_ranks[0] // gs.n_heads
    fq = load_layer_factors(str(tmp_path / "port" / "layers"), 0, "qk")
    W_q = t_params["layers"][0]["q"]["kernel"].T.numpy()
    assert fq["q"].shape == (gs.n_heads * r, t_spec.d_model)
    assert not any(np.allclose(fq["q"][0], row) for row in W_q)


def test_svd_stream_host_staged_equals_resident(tmp_path, monkeypatch):
    """The streamed sweep with host-staged weights and slimmed flush
    windows (the low-memory threshold patched to 0 so the slim applies at
    this size) solves the resident job's factors: the SVD reads the staged
    q/k, which the slim keeps for it."""
    spec, params = t_params_from_hf(_tiny_opt(), device="cpu")
    kw = dict(skip_baseline_eval=True, layers_per_step=1, solver_precision="f32_device", device="cpu")
    ref = t_run(_config(TConfig, tmp_path / "chunk", **kw), spec=spec, params=params)
    monkeypatch.setattr(offload, "_host_staged", lambda params, device: True)
    monkeypatch.setattr(offload, "_LOWMEM_COV_BYTES", 0)
    got = t_run(_config(TConfig, tmp_path / "stream", calib_exec="stream", profile_dir=str(tmp_path / "trace"), **kw),
                spec=spec, params=params)
    assert len(os.listdir(tmp_path / "trace")) == 1  # one trace for the job
    assert got["compressed_spec"] == ref["compressed_spec"]
    for l in range(spec.n_layers):
        a = load_layer_factors(str(tmp_path / "stream" / "layers"), l, "qk")
        b = load_layer_factors(str(tmp_path / "chunk" / "layers"), l, "qk")
        assert sorted(a) == sorted(b) == ["k", "k_bias", "q", "q_bias"]
        for name in a:
            np.testing.assert_allclose(a[name], b[name], rtol=1e-5, atol=1e-6, err_msg=f"{l}/{name}")
    np.testing.assert_allclose(got["compressed_ppl"], ref["compressed_ppl"], rtol=1e-5)


def test_slim_window_keeps_qk_for_svd():
    """A host-staged dense window beyond the low-memory threshold keeps
    q/k beside down/v/o when the SVD solve will read them (non-RoPE arch,
    ``qk_method="svd"``), as the JAX rule does."""
    big = dict(gate_ranks=(20_000,) * 2)  # gate_ranks^2 * 4 > the threshold
    opt = dataclasses.replace(spec_from_hf_config(_tiny_opt().config), **big)
    rope = dataclasses.replace(spec_from_hf_config(transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2)), **big)
    lp = {k: object() for k in ("q", "k", "v", "o", "up", "gate", "down", "attn_norm")}
    svd, cr = TConfig(qk_method="svd"), TConfig(qk_method="cr")
    assert set(offload._slim_window_lp(opt, 0, lp, True, svd)) == {"q", "k", "down", "v", "o"}
    assert set(offload._slim_window_lp(opt, 0, lp, True, cr)) == {"down", "v", "o"}
    assert set(offload._slim_window_lp(rope, 0, lp, True, svd)) == {"down", "v", "o"}
    assert offload._slim_window_lp(opt, 0, lp, False, svd) is lp
