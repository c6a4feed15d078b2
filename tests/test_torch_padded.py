"""Parity: the port's padded execution (`pad_to_uniform`, `forward_padded`,
`_model_step_padded`, padded perplexity) against the JAX package's, and
against the port's unrolled forward.

Tiny llama, qwen3 (a full and a sliding-window layer, q/k norm) and opt
models, dense (from HF configs, offline) and compressed with forced
heterogeneous per-layer ranks (random numpy factors and rotary masks), so
every layer is really padded. The same numpy inputs go to both packages.
float32 tolerance 1e-4: XLA:CPU and ATen sum in different orders.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from modegpt_tpu.evals.perplexity import compute_perplexity as j_ppl  # noqa: E402
from modegpt_tpu.models import forward as j_forward  # noqa: E402
from modegpt_tpu.models import params_from_hf_model as j_params_from_hf  # noqa: E402
from modegpt_tpu.models import padded as j_padded  # noqa: E402
from modegpt_tpu_torch.evals.perplexity import compute_perplexity as t_ppl  # noqa: E402
from modegpt_tpu_torch.evals.perplexity import resolve_exec_mode  # noqa: E402
from modegpt_tpu_torch.models import padded as t_padded  # noqa: E402
from modegpt_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from modegpt_tpu_torch.models.forward import forward as t_forward  # noqa: E402
from modegpt_tpu_torch.models.spec import ModelSpec as TSpec  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _hf(arch):
    if arch == "llama":
        cfg = transformers.LlamaConfig(
            vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
            tie_word_embeddings=False,
        )
        cls = transformers.LlamaForCausalLM
    elif arch == "qwen3":
        cfg = transformers.Qwen3Config(
            vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16, max_position_embeddings=128,
            use_sliding_window=True, sliding_window=8, max_window_layers=1, tie_word_embeddings=False,
        )
        cls = transformers.Qwen3ForCausalLM
    else:
        cfg = transformers.OPTConfig(
            vocab_size=128, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=128, word_embed_proj_dim=32,
        )
        cls = transformers.OPTForCausalLM
    torch.manual_seed({"llama": 0, "qwen3": 1, "opt": 2}[arch])
    return cls(cfg).eval()


def _compress(spec, dense, seed=4):
    """Per-layer ranks that differ across layers (q/k != v/o widths),
    random factors, rotary masks for the RoPE archs."""
    rng = np.random.default_rng(seed)
    H, Hk, hd, d = spec.n_heads, spec.n_kv_heads, spec.head_dim, spec.d_model
    r_qk, r_vo, r_mlp = (6, 4), ((4, 6) if spec.uses_rope else (5, 7)), (40, 24)
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


_CACHE = {}


def _model(arch, variant):
    """(j_spec, j_params, t_spec, t_params) for one tiny model, built once."""
    key = (arch, variant)
    if key not in _CACHE:
        spec, dense = j_params_from_hf(_hf(arch))
        host = jax.device_get(dense)
        if variant == "compressed":
            spec, host = _compress(spec, host)
        j_params = jax.tree_util.tree_map(jnp.asarray, host)
        _CACHE[key] = (spec, j_params, TSpec.from_dict(spec.to_dict()), params_from_numpy(host, "cpu"))
    return _CACHE[key]


def _pads(arch, variant):
    j_spec, j_params, t_spec, t_params = _model(arch, variant)
    return j_padded.pad_to_uniform(j_spec, j_params), t_padded.pad_to_uniform(t_spec, t_params)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("variant", ["dense", "compressed"])
@pytest.mark.parametrize("arch", ["llama", "qwen3", "opt"])
def test_forward_padded_matches_jax_and_unrolled(arch, variant):
    j_spec, j_params, t_spec, t_params = _model(arch, variant)
    jpm, tpm = _pads(arch, variant)
    assert tpm.spec.to_dict() == jpm.spec.to_dict()
    assert t_padded.padding_overhead(t_spec) == pytest.approx(j_padded.padding_overhead(j_spec))
    j_leaves, t_leaves = _leaves(jax.device_get(jpm.layers)), _leaves(tpm.layers)
    # the JAX stack carries mixed windows as a leaf; the port reads them from the spec
    assert set(j_leaves) - set(t_leaves) <= {"window"} and set(t_leaves) <= set(j_leaves)
    for name, leaf in t_leaves.items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(j_leaves[name]), err_msg=name)
    np.testing.assert_array_equal(tpm.q_hd_true.numpy(), np.asarray(jpm.q_hd_true))

    ids = np.random.default_rng(5).integers(0, t_spec.vocab_size, (2, 24)).astype(np.int32)
    got = t_padded.forward_padded(tpm.spec, tpm.layers, tpm.other, tpm.q_hd_true, torch.from_numpy(ids))
    want = j_padded.forward_padded(jpm.spec, jpm.layers, jpm.other, jpm.q_hd_true, jnp.asarray(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    unrolled, _ = t_forward(t_spec, t_params, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), unrolled.numpy(), **TOL)


STEP_CASES = [
    ("llama", "model", "xla", 3),
    ("llama", "model", "ragged", 3),
    ("llama", "int8", "xla", 1),
    ("llama", "int8", "ragged", 3),
    ("qwen3", "model", "ragged", 3),
    ("qwen3", "int8", "xla", 1),
    ("opt", "model", "xla", 1),
    ("opt", "int8", "ragged", 3),
]


@pytest.mark.parametrize("arch,kv,attn,S", STEP_CASES, ids=["-".join(map(str, c)) for c in STEP_CASES])
def test_model_step_padded_matches_jax(arch, kv, attn, S):
    """New tokens at per-row offsets into a pool holding random state; the
    last row runs past the pool's end, whose writes are dropped."""
    jpm, tpm = _pads(arch, "compressed")
    spec = tpm.spec
    L, Hk = spec.n_layers, spec.n_kv_heads
    Rq, Rv = spec.q_ranks[0] // spec.n_heads, spec.v_ranks[0] // Hk
    Bn, T = 3, 24
    rng = np.random.default_rng(6)
    lengths = np.asarray([0, 7, T - 2])
    tokens = rng.integers(0, spec.vocab_size, (Bn, S)).astype(np.int32)
    if kv == "int8":
        ck = rng.integers(-127, 128, (L, Bn, Hk, T, Rq), dtype=np.int8)
        cv = rng.integers(-127, 128, (L, Bn, Hk, T, Rv), dtype=np.int8)
        scales = tuple((rng.uniform(0.5, 1.5, (L, Bn, Hk, T)) / 127).astype(np.float32) for _ in range(2))
    else:
        ck = rng.standard_normal((L, Bn, Hk, T, Rq)).astype(np.float32)
        cv = rng.standard_normal((L, Bn, Hk, T, Rv)).astype(np.float32)
        scales = None

    j_out = j_padded._model_step_padded(
        jpm.spec, jpm.layers, jpm.other, jpm.q_hd_true, jnp.asarray(tokens), jnp.asarray(ck),
        jnp.asarray(cv), jnp.asarray(lengths, jnp.int32),
        cache_scales=None if scales is None else tuple(map(jnp.asarray, scales)), decode_attn=attn,
    )
    t_ck, t_cv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    t_sc = None if scales is None else tuple(torch.from_numpy(s.copy()) for s in scales)
    logits, new_len = t_padded._model_step_padded(
        tpm.spec, tpm.layers, tpm.other, tpm.q_hd_true, torch.from_numpy(tokens), t_ck, t_cv, lengths,
        cache_scales=t_sc, decode_attn=attn,
    )
    np.testing.assert_array_equal(new_len, lengths + S)
    # rows whose queries sit past the pool are garbage in both packages
    live = lengths[:, None] + np.arange(S)[None, :] < T
    np.testing.assert_allclose(logits.numpy()[live], np.asarray(j_out[0])[live], **TOL)
    if scales is None:
        np.testing.assert_allclose(t_ck.numpy(), np.asarray(j_out[1]), **TOL)
        np.testing.assert_allclose(t_cv.numpy(), np.asarray(j_out[2]), **TOL)
    else:
        for got, want in ((t_ck, j_out[1]), (t_cv, j_out[2])):  # codes: at most one rounding step apart
            diff = np.abs(got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01
        for got, want in zip(t_sc, j_out[4]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # nothing outside the written positions changed
    for b in range(Bn):
        kept = np.ones(T, bool)
        kept[lengths[b]: lengths[b] + S] = False
        np.testing.assert_array_equal(t_ck.numpy()[:, b, :, kept], ck[:, b, :, kept])


@pytest.mark.parametrize("arch", ["llama", "qwen3"])
def test_padded_perplexity_matches_jax(arch):
    j_spec, j_params, t_spec, t_params = _model(arch, "compressed")
    tokens = np.random.default_rng(7).integers(0, t_spec.vocab_size, (4, 32)).astype(np.int32)
    assert resolve_exec_mode(t_spec, "auto") == "padded"
    got = t_ppl(t_spec, t_params, tokens, 2, progress=False, exec_mode="padded")
    want = j_ppl(j_spec, j_params, tokens, 2, progress=False, exec_mode="padded")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert t_ppl(t_spec, t_params, tokens, 2, progress=False) == got  # auto takes padded
    unrolled = t_ppl(t_spec, t_params, tokens, 2, progress=False, exec_mode="unrolled")
    np.testing.assert_allclose(unrolled, got, rtol=1e-5)


def test_init_cache_padded_matches_jax():
    jpm, tpm = _pads("qwen3", "compressed")
    jk, jv, jn = j_padded.init_cache_padded(jpm, 3, 16)
    tk, tv, tn = t_padded.init_cache_padded(tpm, 3, 16)
    assert tuple(tk.shape) == jk.shape and tuple(tv.shape) == jv.shape and tn == int(jn) == 0
    assert tk.dtype == torch.float32 and not tk.any() and not tv.any()


def test_auto_runs_a_uniform_model_unrolled():
    _, _, t_spec, _ = _model("llama", "dense")
    assert resolve_exec_mode(t_spec, "auto") == "unrolled"
    assert resolve_exec_mode(t_spec, "padded") == "padded"
    with pytest.raises(ValueError, match="exec_mode"):
        resolve_exec_mode(t_spec, "scan")


def test_unported_stacks_raise():
    """An arch the port does not know is refused; a soft-capped stack
    (gemma2's wiring, tests/test_torch_archs.py) pads."""
    j_spec, _, _, t_params = _model("llama", "dense")
    unknown = TSpec.from_dict({**j_spec.to_dict(), "arch": "falcon"})
    with pytest.raises(NotImplementedError, match="models.forward"):
        t_padded.pad_to_uniform(unknown, t_params)
    softcap = TSpec.from_dict({**j_spec.to_dict(), "attn_logit_softcap": 50.0})
    assert t_padded.pad_to_uniform(softcap, t_params).spec.attn_logit_softcap == 50.0
