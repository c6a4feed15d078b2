"""Parity of the port's dense gemma, gemma2, olmo2, gpt2, phi3,
starcoder2, mistral and qwen2 architectures with the JAX package.

Tiny models are built offline from transformers configs (widths of 64 or
less, 2-4 layers, T <= 48), their weights redrawn from a seeded normal
wide enough that gemma2's soft caps and every sliding window bite; the
same numpy inputs go to both packages.

* the HF loader leaf for leaf, the dense forward's logits (also against
  HF) and every CalibStats field; the compressed forward on random
  compressed weights with heterogeneous ranks and rotary masks;
* `run_compression` end to end for gemma2, olmo2, gpt2, phi3 and
  starcoder2: identical rank lists and kept indices, factors and
  perplexities within tolerance;
* padded execution and greedy serving against the JAX padded stack and
  batcher for gemma2 (alternating windows, soft caps through K3's plain
  version) and olmo2 (the flat q/k norm at padded ranks); `generate` for
  gemma2; artifacts across the two packages;
* `masked_flat_rms_norm` against the JAX function; random parameters
  with the JAX tree's leaves; the soft-capped layers' route to the plain
  attention; every arch the spec parses passes `check_supported`.

float32 tolerance rtol 1e-4 / atol 1e-4 (XLA:CPU and ATen sum their
matmuls in different orders), as ``tests/test_torch_forward.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from modegpt_tpu.compress import artifact as j_artifact  # noqa: E402
from modegpt_tpu.compress.pipeline import run_compression as j_run  # noqa: E402
from modegpt_tpu.config import CompressionConfig as JConfig  # noqa: E402
from modegpt_tpu.models import forward as j_forward  # noqa: E402
from modegpt_tpu.models import padded as j_padded  # noqa: E402
from modegpt_tpu.models import params_from_hf_model as j_params_from_hf  # noqa: E402
from modegpt_tpu.models.serving import ContinuousBatcher as JBatcher  # noqa: E402
from modegpt_tpu.models.spec import ModelSpec as JSpec  # noqa: E402
from modegpt_tpu_torch.compress import artifact as t_artifact  # noqa: E402
from modegpt_tpu_torch.compress.pipeline import run_compression as t_run  # noqa: E402
from modegpt_tpu_torch.config import CompressionConfig as TConfig  # noqa: E402
from modegpt_tpu_torch.models import padded as t_padded  # noqa: E402
from modegpt_tpu_torch.models.convert import params_from_numpy, to_numpy  # noqa: E402
from modegpt_tpu_torch.models.forward import forward as t_forward  # noqa: E402
from modegpt_tpu_torch.models.hf import params_from_hf_model as t_params_from_hf  # noqa: E402
from modegpt_tpu_torch.models.serving import ContinuousBatcher as TBatcher  # noqa: E402
from modegpt_tpu_torch.models.spec import ARCHS as SPEC_ARCHS  # noqa: E402
from modegpt_tpu_torch.models.spec import ModelSpec as TSpec  # noqa: E402
from modegpt_tpu_torch.models.spec import spec_from_hf_config  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
T_LEN = 48
_COMMON = dict(vocab_size=128, max_position_embeddings=128)


def _config(name):
    """(config, model class) of the tiny model ``name``."""
    t = transformers
    if name == "gemma":
        return t.GemmaConfig(**_COMMON, hidden_size=64, intermediate_size=64, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=4, head_dim=16), t.GemmaForCausalLM
    if name == "gemma2":
        cfg = t.Gemma2Config(**_COMMON, hidden_size=64, intermediate_size=64, num_hidden_layers=4,
                             num_attention_heads=4, num_key_value_heads=2, head_dim=16, sliding_window=8,
                             query_pre_attn_scalar=24, attn_logit_softcapping=3.0,
                             final_logit_softcapping=5.0)
        cfg._attn_implementation = "eager"  # HF caps the scores in its eager path only
        return cfg, t.Gemma2ForCausalLM
    if name == "olmo2":
        return t.Olmo2Config(**_COMMON, hidden_size=64, intermediate_size=64, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2), t.Olmo2ForCausalLM
    if name == "gpt2":
        return t.GPT2Config(n_layer=2, n_embd=64, n_inner=64, n_head=4, vocab_size=128,
                            n_positions=128), t.GPT2LMHeadModel
    if name == "phi3":
        return t.Phi3Config(**_COMMON, hidden_size=64, intermediate_size=64, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=4, sliding_window=8,
                            tie_word_embeddings=False, pad_token_id=0, eos_token_id=1,
                            bos_token_id=2), t.Phi3ForCausalLM
    if name == "starcoder2":  # 6 heads over 2 kv heads: a group of 3
        return t.Starcoder2Config(**_COMMON, hidden_size=48, intermediate_size=64, num_hidden_layers=2,
                                  num_attention_heads=6, num_key_value_heads=2,
                                  sliding_window=8), t.Starcoder2ForCausalLM
    if name == "mistral":
        return t.MistralConfig(**_COMMON, hidden_size=64, intermediate_size=64, num_hidden_layers=2,
                               num_attention_heads=4, num_key_value_heads=2, sliding_window=8,
                               tie_word_embeddings=False), t.MistralForCausalLM
    assert name == "qwen2"  # 6 heads over 2 kv heads, qkv biases
    return t.Qwen2Config(**_COMMON, hidden_size=48, intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=6, num_key_value_heads=2,
                         tie_word_embeddings=False), t.Qwen2ForCausalLM


ARCHS = ["gemma", "gemma2", "olmo2", "gpt2", "phi3", "starcoder2", "mistral", "qwen2"]


def _hf(name, std=0.15):
    """The tiny HF model with every parameter drawn from N(0, std) (norm
    weights around 1, gemma's around 0: its norms scale by 1 + w)."""
    cfg, cls = _config(name)
    torch.manual_seed(0)
    model = cls(cfg).eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen) * std
            center = 1.0 if ("norm" in pname or "ln_" in pname) and pname.endswith("weight") else 0.0
            if name.startswith("gemma") and "norm" in pname:
                center = 0.0
            p.copy_(noise + center)
    return model


def _ids(B=2, T=T_LEN, seed=0):
    return np.random.default_rng(seed).integers(0, 128, (B, T)).astype(np.int32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def _tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_numpy(v) for v in tree]
    return None if tree is None else to_numpy(tree)


def _compare(j_spec, j_params, t_params, ids):
    """Logits and every CalibStats field: every layer tapped in one forward
    for a dense spec, one layer per forward for a compressed one (whose
    per-layer Grams differ in shape and cannot be stacked)."""
    t_spec = TSpec.from_dict(j_spec.to_dict())
    L = j_spec.n_layers
    groups = [tuple(range(L))] if j_spec.is_uniform else [(l,) for l in range(L)]
    for layers in groups:
        jl, js = j_forward(j_spec, j_params, jnp.asarray(ids), stats_layers=layers)
        tl, ts = t_forward(t_spec, t_params, torch.from_numpy(ids), stats_layers=layers)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for field in ("cov_mlp", "cov_q", "cov_k", "cov_x", "bi_acc"):
            np.testing.assert_allclose(
                getattr(ts, field).numpy(), np.asarray(getattr(js, field)), **TOL, err_msg=field
            )
    return tl


@pytest.mark.parametrize("name", ARCHS)
def test_dense_forward_loader_and_taps(name):
    model = _hf(name)
    j_spec, j_params = j_params_from_hf(model)
    t_spec, t_params = t_params_from_hf(model, device="cpu")
    assert t_spec.arch == name and t_spec.to_dict() == j_spec.to_dict()
    j_flat = dict(_leaves(jax.device_get(j_params)))
    t_flat = dict(_leaves(t_params))
    assert sorted(t_flat) == sorted(j_flat)
    for key, leaf in t_flat.items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(j_flat[key]), err_msg=key)
    ids = _ids()
    logits = _compare(j_spec, j_params, t_params, ids)
    with torch.no_grad():
        ref = model(torch.from_numpy(ids.astype(np.int64))).logits.numpy()
    np.testing.assert_allclose(logits.numpy(), ref, rtol=2e-4, atol=2e-4)


def test_the_caps_and_windows_bite():
    """The tiny models' weights are wide enough that gemma2's caps and the
    sliding windows change the logits, so the parity above tests them."""
    import dataclasses

    model = _hf("gemma2")
    spec, params = t_params_from_hf(model, device="cpu")
    ids = torch.from_numpy(_ids())
    base, _ = t_forward(spec, params, ids)
    for change in (dict(attn_logit_softcap=None), dict(final_logit_softcap=None), dict(layer_types=())):
        other, _ = t_forward(dataclasses.replace(spec, **change), params, ids)
        assert float((other - base).abs().max()) > 1e-2, change


def _compressed(name):
    """A compressed spec with per-layer ranks (q/k widths differ from v/o
    widths, rotary masks for the rope archs) and random numpy projections;
    every other leaf (norms, post norms, flat q/k norms, positions) kept."""
    spec, dense = j_params_from_hf(_hf(name))
    dense = jax.device_get(dense)
    rng = np.random.default_rng(4)
    H, Hk, hd, d = spec.n_heads, spec.n_kv_heads, spec.head_dim, spec.d_model
    L = spec.n_layers
    r_qk, r_vo = ((6, 4), (4, 6)) if spec.uses_rope else ((5, 7), (7, 5))
    r_qk, r_vo, r_mlp = (r_qk * L)[:L], (r_vo * L)[:L], (40, 24, 32, 16)[:L]
    cspec = spec.with_ranks(
        q_ranks=[H * r for r in r_qk], k_ranks=[Hk * r for r in r_qk],
        v_ranks=[Hk * r for r in r_vo], o_ranks=[H * r for r in r_vo],
        gate_ranks=r_mlp, has_rotary_masks=spec.uses_rope,
    )
    params = {k: v for k, v in dense.items() if k != "layers"}
    layers = []
    for l, lp in enumerate(dense["layers"]):
        new = {k: v for k, v in lp.items() if k not in ("q", "k", "v", "o", "up", "down", "gate")}
        shapes = {
            "q": (d, cspec.q_ranks[l]), "k": (d, cspec.k_ranks[l]), "v": (d, cspec.v_ranks[l]),
            "o": (cspec.o_ranks[l], d), "up": (d, cspec.gate_ranks[l]), "down": (cspec.gate_ranks[l], d),
        }
        if spec.gated_mlp:
            shapes["gate"] = (d, cspec.gate_ranks[l])
        for pname, shape in shapes.items():
            new[pname] = {"kernel": (rng.standard_normal(shape) * 0.15).astype(np.float32)}
            if "bias" in lp[pname]:
                new[pname]["bias"] = (rng.standard_normal(shape[1]) * 0.1).astype(np.float32)
        if spec.uses_rope:
            half, r = hd // 2, cspec.q_ranks[l] // H
            pairs = np.stack([rng.permutation(half)[: r // 2] for _ in range(Hk)])
            new["rotary_mask"] = np.concatenate([pairs, pairs + half], axis=1).astype(np.int32)
        layers.append(new)
    params["layers"] = layers
    return cspec, params


@pytest.mark.parametrize("name", ARCHS)
def test_compressed_forward(name):
    cspec, params = _compressed(name)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    _compare(cspec, j_params, params_from_numpy(params, "cpu"), _ids(seed=5))


def _job_config(cls, root, **kw):
    return cls(**{
        **dict(
            model="in-memory", dataset="synthetic", calib_size=4, calibs_batch_size=2, seq_len=T_LEN,
            eval_batch_size=4, eval_max_samples=4, compression_ratio=0.3, sparsity_smoothing=0.2,
            output_dir=str(root / "out"), temp_storage_dir=str(root / "layers"), metrics_dir=str(root / "metrics"),
        ),
        **kw,
    })


_JOBS = {}


def _jobs(name, tmp_path_factory):
    """Both packages' `run_compression` on the tiny ``name``, once per
    module: (JAX results, port results, JAX factor dir, port factor dir)."""
    if name not in _JOBS:
        root = tmp_path_factory.mktemp(name)
        model = _hf(name)
        j_spec, j_params = j_params_from_hf(model)
        t_spec, t_params = t_params_from_hf(model, device="cpu")
        want = j_run(_job_config(JConfig, root / "jax"), spec=j_spec, params=j_params)
        got = t_run(_job_config(TConfig, root / "port", device="cpu"), spec=t_spec, params=t_params)
        _JOBS[name] = (want, got, str(root / "jax" / "layers"), str(root / "port" / "layers"))
    return _JOBS[name]


def _vo_products(f, spec, l):
    """Each head's O_h V_kv(h) from a layer's VO factors: free of the SVD's
    per-vector sign, which LAPACK builds may choose differently."""
    H, Hk = spec.n_heads, spec.n_kv_heads
    r = f["v"].shape[0] // Hk
    return [f["o"][:, h * r:(h + 1) * r] @ f["v"][(h // spec.group_size) * r:(h // spec.group_size + 1) * r]
            for h in range(H)]


@pytest.mark.parametrize("name", ["gemma2", "olmo2", "gpt2", "phi3", "starcoder2"])
def test_run_compression_matches_jax(name, tmp_path_factory):
    """Identical rank lists, kept indices and rotary masks; factors (the
    V/O ones as sign-free per-head products) to 1e-4 relative of each
    factor's largest entry: the two packages' float32 forwards give Grams
    that agree to ~1e-6, which the solves carry through; perplexities to
    rtol 1e-4."""
    want, got, j_dir, t_dir = _jobs(name, tmp_path_factory)
    cspec = got["compressed_spec"]
    assert cspec.to_dict() == want["compressed_spec"].to_dict()
    assert max(cspec.gate_ranks) < cspec.d_int and min(cspec.q_ranks) < cspec.n_heads * cspec.head_dim
    for l in range(cspec.n_layers):
        for suffix in ("mlp", "qk", "vo"):
            jf = j_artifact.load_layer_factors(j_dir, l, suffix)
            tf = t_artifact.load_layer_factors(t_dir, l, suffix)
            assert sorted(tf) == sorted(jf), (l, suffix)
            pairs = [(key, tf[key], jf[key]) for key in tf if key not in ("v", "o")]
            if suffix == "vo":
                pairs += [(f"O_{h} V", a, b) for h, (a, b) in
                          enumerate(zip(_vo_products(tf, cspec, l), _vo_products(jf, cspec, l)))]
            for key, a, b in pairs:
                if key in ("idx", "rotary_mask"):
                    np.testing.assert_array_equal(a, b, err_msg=f"{l} {suffix} {key}")
                else:
                    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max(),
                                               err_msg=f"{l} {suffix} {key}")
    for key in ("baseline_ppl", "compressed_ppl"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)


KW = dict(slots=2, max_len=64, prefill_bucket=8)


def _serve(pm, cls, prompts, max_new, **kw):
    b = cls(pm, **{**KW, **kw})
    ids = [b.submit(p, max_new_tokens=max_new) for p in prompts]
    done = b.run()
    return [list(map(int, done[r])) for r in ids]


@pytest.mark.parametrize("name", ["gemma2", "olmo2"])
def test_padded_and_batcher_match_jax(name, tmp_path_factory):
    """The compressed model's padded stack against the unrolled forward
    and the JAX padded forward, then greedy serving (prefill chunks and
    decode through K3's plain version, with gemma2's caps and windows)
    token for token against the JAX batcher, in f32 and int8 KV."""
    _, got, _, _ = _jobs(name, tmp_path_factory)
    spec, params = got["compressed_spec"], got["compressed_params"]
    assert len(set(spec.q_ranks)) > 1 or len(set(spec.gate_ranks)) > 1
    pm = t_padded.pad_to_uniform(spec, params)
    jpm = j_padded.pad_to_uniform(JSpec.from_dict(spec.to_dict()),
                                  jax.tree_util.tree_map(jnp.asarray, _tree_numpy(params)))
    assert pm.spec.to_dict() == jpm.spec.to_dict()
    ids = _ids(seed=6)
    want, _ = t_forward(spec, params, torch.from_numpy(ids))
    lp = t_padded.forward_padded(pm.spec, pm.layers, pm.other, pm.q_hd_true, torch.from_numpy(ids))
    np.testing.assert_allclose(lp.numpy(), want.numpy(), **TOL)
    jl = j_padded.forward_padded(jpm.spec, jpm.layers, jpm.other, jpm.q_hd_true, jnp.asarray(ids))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jl), **TOL)

    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 128, size=(n,)).astype(np.int32) for n in (5, 19, 3)]
    for kv in ("model", "int8"):
        tokens = _serve(pm, TBatcher, prompts, 6, kv_dtype=kv, decode_attn="ragged")
        assert tokens == _serve(jpm, JBatcher, prompts, 6, kv_dtype=kv), kv


def test_generate_matches_jax(tmp_path_factory):
    """KV-cache generation (caps, fixed scale, sandwich norms, windows),
    greedy, on the dense and the compressed gemma2."""
    from modegpt_tpu.models.generate import generate as j_generate
    from modegpt_tpu_torch.models.generate import generate as t_generate

    model = _hf("gemma2")
    j_spec, j_params = j_params_from_hf(model)
    t_spec, t_params = t_params_from_hf(model, device="cpu")
    _, got, _, _ = _jobs("gemma2", tmp_path_factory)
    c_spec, c_params = got["compressed_spec"], got["compressed_params"]
    cj_params = jax.tree_util.tree_map(jnp.asarray, _tree_numpy(c_params))
    ids = _ids(B=2, T=12, seed=8)
    for (js, jp), (ts, tp) in (((j_spec, j_params), (t_spec, t_params)),
                               ((JSpec.from_dict(c_spec.to_dict()), cj_params), (c_spec, c_params))):
        want = np.asarray(j_generate(js, jp, ids, max_new_tokens=6, temperature=0.0))
        np.testing.assert_array_equal(t_generate(ts, tp, ids, max_new_tokens=6).numpy(), want)


@pytest.mark.parametrize("name", ["gemma2", "gpt2"])
def test_artifact_cross_load(name, tmp_path_factory):
    """The port's artifact loads in the JAX package and the JAX package's
    loads in the port, leaf for leaf, with the same logits."""
    _, got, _, _ = _jobs(name, tmp_path_factory)
    src = got["artifact_dir"]
    j_spec, j_params, _ = j_artifact.load_compressed_model(src)
    assert j_spec.to_dict() == got["compressed_spec"].to_dict()
    jax_dir = str(tmp_path_factory.mktemp(name + "_jax_saved"))
    j_artifact.save_compressed_model(jax_dir, j_spec, j_params, "tok", {})
    spec2, params2, _ = t_artifact.load_compressed_model(jax_dir, device="cpu")
    assert spec2 == got["compressed_spec"]
    a, b = dict(_leaves(params2)), dict(_leaves(got["compressed_params"]))
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key].numpy(), b[key].numpy(), err_msg=key)
    ids = _ids(seed=3)
    tl, _ = t_forward(spec2, params2, torch.from_numpy(ids))
    jl, _ = j_forward(j_spec, j_params, jnp.asarray(ids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("case", ["dense", "masked", "true_dim"])
def test_masked_flat_rms_norm_matches_jax(case):
    from modegpt_tpu.ops.rope import masked_flat_rms_norm as j_norm
    from modegpt_tpu_torch.ops.rope import masked_flat_rms_norm as t_norm

    rng = np.random.default_rng(9)
    H, Hk, hd, r = 6, 2, 8, 4
    group = H // Hk
    weight = rng.standard_normal(H * hd).astype(np.float32)
    mask = None
    width = hd
    if case != "dense":
        width = r
        pairs = np.stack([rng.permutation(hd // 2)[: r // 2] for _ in range(Hk)])
        mask = np.concatenate([pairs, pairs + hd // 2], axis=1).astype(np.int32)
    x = rng.standard_normal((2, 5, H * width)).astype(np.float32)
    true_dim = None
    if case == "true_dim":  # zero pads past the true rank, as the padded stack holds them
        true_dim = float(H * 3)
        x.reshape(2, 5, H, width)[..., 3:] = 0.0
    want = j_norm(jnp.asarray(x), jnp.asarray(weight), None if mask is None else jnp.asarray(mask),
                  H, hd, group, 1e-6, true_dim=true_dim)
    got = t_norm(torch.from_numpy(x), torch.from_numpy(weight), None if mask is None else torch.from_numpy(mask),
                 H, hd, group, 1e-6, true_dim=true_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_matches_the_jax_tree(name):
    """Random parameters have the JAX init's leaves at its shapes, and the
    artifact's shape check passes on them."""
    from modegpt_tpu.models.init import init_params as j_init
    from modegpt_tpu_torch.models.init import init_params as t_init

    spec = spec_from_hf_config(_config(name)[0])
    got = t_init(spec, torch.Generator().manual_seed(0), device="cpu")
    want = j_init(JSpec.from_dict(spec.to_dict()), jax.random.PRNGKey(0))
    shapes = {k: tuple(v.shape) for k, v in _leaves(got)}
    assert shapes == {k: tuple(v.shape) for k, v in _leaves(want)}
    t_artifact._validate_shapes(spec, got)


def test_softcap_takes_the_plain_attention(monkeypatch):
    """A soft-capped layer goes to the plain attention whatever attn_impl
    says (the JAX forward sends it to XLA): the kernel is never called."""
    from modegpt_tpu_torch.models import forward as forward_mod

    def refuse(*args, **kwargs):
        raise AssertionError("K1 called on a soft-capped layer")

    spec, params = t_params_from_hf(_hf("gemma2"), device="cpu")
    ids = torch.from_numpy(_ids(B=1, T=128))
    want, _ = t_forward(spec, params, ids, attn_impl="xla")
    monkeypatch.setattr(forward_mod, "flash_attention", refuse)
    got, _ = t_forward(spec, params, ids, attn_impl="flash")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    olmo2, olmo2_params = t_params_from_hf(_hf("olmo2"), device="cpu")
    with pytest.raises(AssertionError, match="K1 called"):
        t_forward(olmo2, olmo2_params, ids, attn_impl="flash")


@pytest.mark.parametrize("arch", sorted(SPEC_ARCHS))
def test_every_parsed_arch_is_supported(arch):
    import dataclasses

    from modegpt_tpu_torch.models.forward import check_supported

    check_supported(dataclasses.replace(spec_from_hf_config(_config("mistral")[0]), arch=arch))
