"""Parity of the port's long-context path (T > 8192) with the JAX package's.

* The port's `flash_attention_hbm` (K2; its plain row-chunked version on
  the CPU) against the JAX `flash_attention_hbm` Pallas kernel run in
  interpret mode with 128-row blocks, as tests/test_models.py runs it:
  GQA and MHA, windows, unaligned head dims (44 / 40), f32 at rtol 2e-4 /
  atol 2e-5 and bf16 at 2e-2 (the JAX package's own kernel tolerances).
* The row-chunked plain version against the unchunked softmax, with
  blocks of a few rows and a ragged last block.
* The attention route: `_attention(impl="flash")` takes K2 above 8192
  tokens and K1 at 8192, and agrees with the JAX XLA attention there.
* A 1-layer Llama with llama3 RoPE scaling at T = 8200: logits and the
  calibration statistics against the JAX forward, and the padded stack
  of a compressed model against the JAX `forward_padded`; the RoPE
  tables past 8192 positions against JAX's.

The CUDA kernel itself runs only on a card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from modegpt_tpu.kernels.flash_attention import flash_attention_hbm as j_hbm  # noqa: E402
from modegpt_tpu.models import forward as j_forward  # noqa: E402
from modegpt_tpu.models import params_from_hf_model as j_params_from_hf  # noqa: E402
from modegpt_tpu.models.forward import _attention as j_attention  # noqa: E402
from modegpt_tpu.models.padded import forward_padded as j_forward_padded  # noqa: E402
from modegpt_tpu.models.padded import pad_to_uniform as j_pad  # noqa: E402
from modegpt_tpu.ops.rope import rope_cos_sin as j_rope  # noqa: E402
from modegpt_tpu_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_hbm,
    flash_attention_hbm_reference,
    flash_attention_reference,
)
from modegpt_tpu_torch.models import forward as t_forward_mod  # noqa: E402
from modegpt_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from modegpt_tpu_torch.models.forward import forward as t_forward  # noqa: E402
from modegpt_tpu_torch.models.padded import forward_padded as t_forward_padded  # noqa: E402
from modegpt_tpu_torch.models.padded import pad_to_uniform as t_pad  # noqa: E402
from modegpt_tpu_torch.models.spec import ModelSpec as TSpec  # noqa: E402
from modegpt_tpu_torch.ops.rope import rope_cos_sin as t_rope  # noqa: E402

TOLERANCE = {"float32": dict(rtol=2e-4, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
LLAMA3_SCALING = {
    "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
    "original_max_position_embeddings": 8192,
}
T_LONG = 8200


def _qkv(B, H, Hk, T, hd, hd_v, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, H, T, hd)).astype(np.float32),
        rng.standard_normal((B, Hk, T, hd)).astype(np.float32),
        rng.standard_normal((B, Hk, T, hd_v)).astype(np.float32),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("heads", [(4, 2), (4, 4)], ids=["gqa", "mha"])
@pytest.mark.parametrize("T", [300, 384, 640])
def test_k2_matches_jax_kernel(T, heads, window, dtype):
    H, Hk = heads
    q, k, v = _qkv(1, H, Hk, T, 44, 40, seed=T + H + Hk)
    scale = 44**-0.5
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v))
    got = flash_attention_hbm(tq, tk, tv, scale=scale, window=window)
    assert got.shape == (1, H, T, 40) and got.dtype == tq.dtype
    jq, jk, jv = (jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in (q, k, v))
    want = j_hbm(jq, jk, jv, scale=scale, window=window, block_q=128, block_k=128)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), **TOLERANCE[dtype]
    )


def _unchunked(q, k, v, scale, window):
    """The masked float32 softmax over the whole [B, H, T, T] scores."""
    B, H, T, hd = q.shape
    Hk = k.shape[1]
    qg = q.reshape(B, Hk, H // Hk, T, hd)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k) * scale
    qi, ki = torch.arange(T)[:, None], torch.arange(T)[None, :]
    mask = ki <= qi
    if window is not None:
        mask = mask & (ki > qi - window)
    probs = torch.softmax(scores.float().masked_fill(~mask, float("-inf")), dim=-1).to(q.dtype)
    return torch.einsum("bkgst,bktd->bkgsd", probs, v).reshape(B, H, T, v.shape[-1])


@pytest.mark.parametrize("window", [None, 5])
def test_row_chunks_equal_the_unchunked_softmax(monkeypatch, window):
    """Blocks of 7 rows over T=75 (ten full blocks and a ragged one), of
    all 75, and the default budget (one block here); GQA and unaligned
    head dims: the same numbers as the unchunked softmax. K2's plain
    version is this same function."""
    from modegpt_tpu_torch.kernels import flash_attention as fa_mod

    assert flash_attention_hbm_reference is flash_attention_reference
    B, H, T = 2, 4, 75
    q, k, v = (torch.from_numpy(a) for a in _qkv(B, H, 2, T, 12, 10, seed=3))
    want = _unchunked(q, k, v, 0.3, window)
    got = flash_attention_reference(q, k, v, scale=0.3, window=window)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    for rows in (7, T):  # a score budget, in elements, of `rows` query rows per block
        monkeypatch.setattr(fa_mod, "_REFERENCE_SCORES", B * H * T * rows)
        got = flash_attention_reference(q, k, v, scale=0.3, window=window)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T,taken", [(8193, "flash_attention_hbm"), (8192, "flash_attention")])
def test_route_takes_k2_beyond_8192(monkeypatch, T, taken):
    """One head of width 8 keeps JAX's [T, T] scores near 270 MB."""
    calls = []
    for name in ("flash_attention", "flash_attention_hbm"):
        original = getattr(t_forward_mod, name)

        def spy(*args, _name=name, _original=original, **kwargs):
            calls.append(_name)
            return _original(*args, **kwargs)

        monkeypatch.setattr(t_forward_mod, name, spy)
    q, k, v = _qkv(1, 1, 1, T, 8, 8, seed=T)
    got = t_forward_mod._attention(*(torch.from_numpy(a) for a in (q, k, v)), 8**-0.5, None, impl="flash")
    assert calls == [taken]
    want = j_attention(*(jnp.asarray(a) for a in (q, k, v)), 8**-0.5, None, impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOLERANCE["float32"])


def _llama31(n_layers=1):
    cfg = transformers.LlamaConfig(
        vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=n_layers,
        num_attention_heads=1, num_key_value_heads=1, max_position_embeddings=16384,
        rope_scaling=dict(LLAMA3_SCALING), rope_theta=500000.0, tie_word_embeddings=False,
    )
    torch.manual_seed(5)
    return transformers.LlamaForCausalLM(cfg).eval()


def _ids(vocab, T=T_LONG, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (1, T)).astype(np.int32)


def test_long_forward_matches_jax():
    """Logits and every CalibStats field of the tapped layer at T = 8200,
    the port's forward through the long-context route (its plain version
    on the CPU) against the JAX forward."""
    j_spec, j_params = j_params_from_hf(_llama31())
    assert j_spec.rope_scaling[0] == "llama3"
    t_spec = TSpec.from_dict(j_spec.to_dict())
    t_params = params_from_numpy(jax.device_get(j_params), "cpu")
    ids = _ids(j_spec.vocab_size)
    jl, js = j_forward(j_spec, j_params, jnp.asarray(ids), stats_layers=(0,))
    tl, ts = t_forward(t_spec, t_params, torch.from_numpy(ids), stats_layers=(0,), attn_impl="flash")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    for field in ("cov_mlp", "cov_q", "cov_k", "cov_x", "bi_acc"):
        np.testing.assert_allclose(
            getattr(ts, field).numpy(), np.asarray(getattr(js, field)), rtol=1e-4, atol=1e-6, err_msg=field
        )


def test_long_forward_padded_matches_jax():
    """A two-layer compressed model (heterogeneous ranks, rotary masks) at
    T = 8200: the port's padded stack through the long-context route
    against the JAX `forward_padded`, and against its own unrolled forward."""
    spec, dense = j_params_from_hf(_llama31(n_layers=2))
    dense = jax.device_get(dense)
    rng = np.random.default_rng(7)
    d, hd = spec.d_model, spec.head_dim
    r_qk, r_vo, r_mlp = (6, 10), (12, 8), (24, 16)
    cspec = spec.with_ranks(q_ranks=r_qk, k_ranks=r_qk, v_ranks=r_vo, o_ranks=r_vo, gate_ranks=r_mlp,
                            has_rotary_masks=True)
    params = {key: val for key, val in dense.items() if key != "layers"}
    params["layers"] = []
    for l, lp in enumerate(dense["layers"]):
        shapes = {"q": (d, r_qk[l]), "k": (d, r_qk[l]), "v": (d, r_vo[l]), "o": (r_vo[l], d),
                  "gate": (d, r_mlp[l]), "up": (d, r_mlp[l]), "down": (r_mlp[l], d)}
        layer = {key: lp[key] for key in ("attn_norm", "mlp_norm")}
        layer.update({name: {"kernel": (rng.standard_normal(s) * 0.2).astype(np.float32)} for name, s in shapes.items()})
        pairs = rng.permutation(hd // 2)[None, : r_qk[l] // 2]
        layer["rotary_mask"] = np.concatenate([pairs, pairs + hd // 2], axis=1).astype(np.int32)
        params["layers"].append(layer)
    ids = _ids(cspec.vocab_size, seed=1)

    jpm = j_pad(cspec, jax.tree_util.tree_map(jnp.asarray, params))
    want = j_forward_padded(jpm.spec, jpm.layers, jpm.other, jpm.q_hd_true, jnp.asarray(ids), "xla")
    t_spec = TSpec.from_dict(cspec.to_dict())
    t_params = params_from_numpy(params, "cpu")
    tpm = t_pad(t_spec, t_params)
    got = t_forward_padded(tpm.spec, tpm.layers, tpm.other, tpm.q_hd_true, torch.from_numpy(ids), attn_impl="flash")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    unrolled, _ = t_forward(t_spec, t_params, torch.from_numpy(ids), attn_impl="flash")
    torch.testing.assert_close(got, unrolled, rtol=1e-4, atol=1e-4)


def test_llama3_rope_tables_past_8192():
    positions = np.arange(0, 16385, 7, dtype=np.int32)
    scaling = ("llama3", 8.0, 1.0, 4.0, 8192.0)
    tc, ts = t_rope(torch.from_numpy(positions), 128, 500000.0, scaling=scaling)
    jc, js = j_rope(jnp.asarray(positions), 128, 500000.0, scaling=scaling)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=2e-6)
