"""Parity: the port's forward (logits and every CalibStats field) against
the JAX package's, on tiny llama, qwen3 (with sliding-window layers) and
opt models built offline from transformers configs.

Weights come from the HF model through each package's own loader; the
compressed cases carry heterogeneous per-layer ranks, q/k widths that
differ from v/o widths, and rotary masks, with random numpy weights fed
to both packages. float32 tolerance rtol 1e-4 / atol 1e-4: XLA:CPU and
ATen sum their matmuls in different orders.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from modegpt_tpu.models import forward as j_forward  # noqa: E402
from modegpt_tpu.models import params_from_hf_model as j_params_from_hf  # noqa: E402
from modegpt_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from modegpt_tpu_torch.models.forward import forward as t_forward  # noqa: E402
from modegpt_tpu_torch.models.hf import params_from_hf_model as t_params_from_hf  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
T_LEN = 48


def _llama():
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(cfg).eval()


def _qwen3():
    cfg = transformers.Qwen3Config(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, max_position_embeddings=128,
        use_sliding_window=True, sliding_window=8, max_window_layers=1, tie_word_embeddings=False,
    )
    torch.manual_seed(1)
    return transformers.Qwen3ForCausalLM(cfg).eval()


def _opt():
    cfg = transformers.OPTConfig(
        vocab_size=128, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=128, word_embed_proj_dim=32,
    )
    torch.manual_seed(2)
    return transformers.OPTForCausalLM(cfg).eval()


MODELS = {"llama": _llama, "qwen3": _qwen3, "opt": _opt}


def _ids(vocab, B=2, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, T_LEN)).astype(np.int32)


def _compare(j_spec, j_params, t_params, ids, gram_precision="highest"):
    """Logits and taps, one tapped layer per forward (a compressed spec's
    per-layer Grams differ in shape and cannot be stacked)."""
    from modegpt_tpu_torch.models.spec import ModelSpec as TSpec

    t_spec = TSpec.from_dict(j_spec.to_dict())
    for layer in range(j_spec.n_layers):
        jl, js = j_forward(
            j_spec, j_params, jnp.asarray(ids), stats_layers=(layer,), gram_precision=gram_precision
        )
        tl, ts = t_forward(
            t_spec, t_params, torch.from_numpy(ids), stats_layers=(layer,), gram_precision=gram_precision
        )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for field in ("cov_mlp", "cov_q", "cov_k", "cov_x", "bi_acc"):
            np.testing.assert_allclose(
                getattr(ts, field).numpy(), np.asarray(getattr(js, field)), **TOL, err_msg=field
            )
    # logits only, no taps
    tl2, ts2 = t_forward(t_spec, t_params, torch.from_numpy(ids))
    assert ts2 is None
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_dense_forward_and_loader(arch):
    model = MODELS[arch]()
    j_spec, j_params = j_params_from_hf(model)
    t_spec, t_params = t_params_from_hf(model, device="cpu")
    assert t_spec.to_dict() == j_spec.to_dict()
    if arch == "qwen3":
        assert t_spec.layer_types == ("full_attention", "sliding_attention")
    # the port's loader builds the JAX tree, leaf for leaf
    j_flat = jax.tree_util.tree_leaves_with_path(jax.device_get(j_params))
    t_from_j = params_from_numpy(jax.device_get(j_params), "cpu")
    for path, leaf in j_flat:
        node_t, node_j = t_params, t_from_j
        for key in path:
            k = getattr(key, "key", getattr(key, "idx", None))
            node_t, node_j = node_t[k], node_j[k]
        np.testing.assert_array_equal(node_t.numpy(), node_j.numpy())
    _compare(j_spec, j_params, t_params, _ids(j_spec.vocab_size))


@pytest.mark.parametrize("gram_precision", ["high", "bf16"])
def test_gram_precision_modes(gram_precision):
    model = _llama()
    j_spec, j_params = j_params_from_hf(model)
    t_params = params_from_numpy(jax.device_get(j_params), "cpu")
    _compare(j_spec, j_params, t_params, _ids(j_spec.vocab_size, seed=3), gram_precision)


def _compressed(arch):
    """A compressed spec with per-layer ranks (q/k != v/o widths) and
    random weights; rotary masks for the rope archs."""
    model = MODELS[arch]()
    spec, dense = j_params_from_hf(model)
    dense = jax.device_get(dense)
    rng = np.random.default_rng(4)
    H, Hk, hd, d = spec.n_heads, spec.n_kv_heads, spec.head_dim, spec.d_model
    r_qk, r_vo, r_mlp = (6, 4), (5, 7), (40, 24)
    if spec.uses_rope:
        r_vo = (4, 6)
    cspec = spec.with_ranks(
        q_ranks=[H * r for r in r_qk], k_ranks=[Hk * r for r in r_qk],
        v_ranks=[Hk * r for r in r_vo], o_ranks=[H * r for r in r_vo],
        gate_ranks=r_mlp, has_rotary_masks=spec.uses_rope,
    )
    params = {k: v for k, v in dense.items() if k != "layers"}
    layers = []
    for l, lp in enumerate(dense["layers"]):
        new = {k: v for k, v in lp.items() if k in ("attn_norm", "mlp_norm", "q_norm", "k_norm")}
        shapes = {
            "q": (d, cspec.q_ranks[l]), "k": (d, cspec.k_ranks[l]), "v": (d, cspec.v_ranks[l]),
            "o": (cspec.o_ranks[l], d), "up": (d, r_mlp[l]), "down": (r_mlp[l], d),
        }
        if spec.gated_mlp:
            shapes["gate"] = (d, r_mlp[l])
        for name, shape in shapes.items():
            new[name] = {"kernel": (rng.standard_normal(shape) * 0.1).astype(np.float32)}
            if "bias" in lp.get(name, {}):
                new[name]["bias"] = (rng.standard_normal(shape[1]) * 0.1).astype(np.float32)
        if spec.uses_rope:
            half, r = hd // 2, r_qk[l]
            pairs = np.stack([rng.permutation(half)[: r // 2] for _ in range(Hk)])
            new["rotary_mask"] = np.concatenate([pairs, pairs + half], axis=1).astype(np.int32)
        layers.append(new)
    params["layers"] = layers
    return cspec, params


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_compressed_forward(arch):
    cspec, params = _compressed(arch)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    _compare(cspec, j_params, params_from_numpy(params, "cpu"), _ids(cspec.vocab_size, seed=5))


def test_unported_arch_raises():
    """An arch the spec does not know raises; every arch it parses runs
    (tests/test_torch_archs.py holds each against the JAX package)."""
    from modegpt_tpu_torch.models.forward import check_supported
    from modegpt_tpu_torch.models.spec import ARCHS, ModelSpec

    spec, _ = j_params_from_hf(_llama())
    with pytest.raises(NotImplementedError, match="models.forward"):
        check_supported(ModelSpec.from_dict({**spec.to_dict(), "arch": "falcon"}))
    olmo2 = ModelSpec.from_dict({**spec.to_dict(), "arch": "olmo2", "post_norms": True, "pre_norms": False})
    check_supported(olmo2)
    for arch in ARCHS:
        check_supported(ModelSpec.from_dict({**spec.to_dict(), "arch": arch}))
