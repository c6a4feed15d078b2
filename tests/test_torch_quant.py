"""Parity of the port's quantised execution and artifacts with the JAX
package's (`models/quantize.py`, the quantised branches of
`models/forward.py`, the int8/int4/nf4 artifact formats, `a8_prefill`).

Tiny llama, qwen3 (q/k norm), opt (biases, ``project_in/out``), gemma2
(tied head, soft caps), mixtral and qwen2_moe (shared expert and
``shared_gate``) models, built offline from transformers configs; the
same numpy inputs go to both packages.

* codes and scales of `quantize_linear`, `quantize_params` and
  `quantize_padded`, the artifact quantisers (NF4 in bounded chunks
  against the JAX one-shot form) and `_act_quant`, and the int32
  accumulator of `_dot_w8a8`: equal;
* the padding identity: quantising after padding equals padding the
  quantised codes;
* the forward over quantised parameters: rtol/atol 1e-4 (MoE 2e-4), the
  port's float32 forward tolerance; the W8A8 forward (MoE dense and
  dispatch): rtol/atol 1e-3, room for an activation code that rounds the
  other way at a half-way point. Measured on these models (logits up to
  3.3 in magnitude): at most 1.5e-6 on the W8A8 logits and 1.8e-7 on
  the W8A8 dispatch outputs (weight-only: 2.1e-6 and 2.4e-7);
* int8, int4 and nf4 artifacts both ways, dequantised and resident: the
  npz keys, bytes and ``dtypes`` equal, the dequantised leaves equal;
  resident int4 never enters the W8A8 view;
* `run_compression` with each ``artifact_dtype`` beside the JAX
  pipeline, `generate` on a resident tree, the eval CLI on an int8
  artifact, the batcher on a quantised padded stack (with and without
  W8A8 prefill) and the serve CLI's ``--quantize_int8 --a8_prefill``.
"""

import json
import os

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
from modegpt_tpu.models import params_from_hf_model as j_params_from_hf  # noqa: E402
from modegpt_tpu.models import quantize as j_quant  # noqa: E402
from modegpt_tpu.models.forward import _act_quant as j_act_quant  # noqa: E402
from modegpt_tpu.models.forward import _dot_w8a8 as j_dot_w8a8  # noqa: E402
from modegpt_tpu.models.forward import _moe_mlp_dispatch as j_dispatch  # noqa: E402
from modegpt_tpu.models.padded import pad_to_uniform as j_pad  # noqa: E402
from modegpt_tpu.models.serving import ContinuousBatcher as JBatcher  # noqa: E402
from modegpt_tpu_torch.compress import artifact as t_artifact  # noqa: E402
from modegpt_tpu_torch.compress.pipeline import run_compression as t_run  # noqa: E402
from modegpt_tpu_torch.config import CompressionConfig as TConfig  # noqa: E402
from modegpt_tpu_torch.models import quantize as t_quant  # noqa: E402
from modegpt_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from modegpt_tpu_torch.models.forward import _act_quant, _dot_w8a8, _int_mm, _moe_mlp_dispatch  # noqa: E402
from modegpt_tpu_torch.models.forward import forward as t_forward  # noqa: E402
from modegpt_tpu_torch.models.forward import pack_int4, unpack_int4  # noqa: E402
from modegpt_tpu_torch.models.padded import pad_to_uniform as t_pad  # noqa: E402
from modegpt_tpu_torch.models.serving import ContinuousBatcher as TBatcher  # noqa: E402
from modegpt_tpu_torch.models.spec import ModelSpec as TSpec  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
MOE_TOL = dict(rtol=2e-4, atol=2e-4)
W8A8_TOL = dict(rtol=1e-3, atol=1e-3)
_COMMON = dict(vocab_size=128, max_position_embeddings=128)
MODELS = ["llama", "qwen3", "opt", "gemma2", "mixtral", "qwen2_moe"]
MOE = ("mixtral", "qwen2_moe")
QUANTISED = ("int8", "int4", "nf4")


def _hf(name):
    t = transformers
    if name == "llama":
        cfg, cls = t.LlamaConfig(**_COMMON, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                                 num_attention_heads=4, num_key_value_heads=2,
                                 tie_word_embeddings=False), t.LlamaForCausalLM
    elif name == "qwen3":
        cfg, cls = t.Qwen3Config(**_COMMON, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                                 num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                                 tie_word_embeddings=False), t.Qwen3ForCausalLM
    elif name == "opt":  # project_in / project_out: the embedding is narrower than the model
        cfg, cls = t.OPTConfig(**_COMMON, hidden_size=64, ffn_dim=96, num_hidden_layers=2,
                               num_attention_heads=4, word_embed_proj_dim=32), t.OPTForCausalLM
    elif name == "gemma2":
        cfg, cls = t.Gemma2Config(**_COMMON, hidden_size=64, intermediate_size=64, num_hidden_layers=2,
                                  num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                                  sliding_window=8, query_pre_attn_scalar=24, attn_logit_softcapping=3.0,
                                  final_logit_softcapping=5.0), t.Gemma2ForCausalLM
    elif name == "mixtral":
        cfg, cls = t.MixtralConfig(**_COMMON, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                                   num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
                                   num_experts_per_tok=2, sliding_window=None), t.MixtralForCausalLM
    else:
        cfg, cls = t.Qwen2MoeConfig(**_COMMON, hidden_size=64, intermediate_size=96, moe_intermediate_size=48,
                                    shared_expert_intermediate_size=80, num_hidden_layers=2,
                                    num_attention_heads=4, num_key_value_heads=2, num_experts=4,
                                    num_experts_per_tok=2), t.Qwen2MoeForCausalLM
    torch.manual_seed(MODELS.index(name))
    model = cls(cfg).eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # wider than HF's 0.02 init, so that the logits spread
        for pname, p in model.named_parameters():
            if "norm" not in pname:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return model


_CACHE = {}


def _pair(name):
    """(JAX spec, JAX params, port spec, port params) of the same model."""
    if name not in _CACHE:
        j_spec, j_params = j_params_from_hf(_hf(name))
        _CACHE[name] = (j_spec, j_params, TSpec.from_dict(j_spec.to_dict()),
                        params_from_numpy(jax.device_get(j_params), "cpu"))
    return _CACHE[name]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def _assert_trees_equal(t_tree, j_tree, extra_jax_leaves=()):
    """Leaf for leaf equal; ``extra_jax_leaves``: leaf names only the JAX
    tree has (its padded stack carries each layer's ``window``)."""
    t_flat, j_flat = dict(_leaves(t_tree)), dict(_leaves(jax.device_get(j_tree)))
    assert sorted(t_flat) == sorted(k for k in j_flat if k.rsplit("/", 1)[-1] not in extra_jax_leaves)
    for key, leaf in t_flat.items():
        want = np.asarray(j_flat[key])
        if want.dtype.name == "int4":  # JAX's resident int4 against the port's packed form
            assert leaf.dtype == torch.uint8, key
            got = unpack_int4(leaf, want.shape[-1]).numpy()
            want = want.astype(np.int8)
        else:
            got = leaf.numpy()
            assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)


def _ids(B=2, T=24, seed=0):
    return np.random.default_rng(seed).integers(0, 128, (B, T)).astype(np.int32)


# ---- quantisers ----


@pytest.mark.parametrize("name", MODELS)
def test_quantize_params_and_padded_codes_equal_jax(name):
    j_spec, j_params, t_spec, t_params = _pair(name)
    _assert_trees_equal(t_quant.quantize_params(t_params), j_quant.quantize_params(j_params))
    jq = j_quant.quantize_padded(j_pad(j_spec, j_params))
    tq = t_quant.quantize_padded(t_pad(t_spec, t_params))
    _assert_trees_equal(tq.layers, jq.layers, ("window",))
    _assert_trees_equal(tq.other, jq.other)
    # the codes dtype alone decides the W8A8 view: every int8 projection
    # re-keyed, the LM head, router and shared gate left weight-only
    view = t_quant.with_act_quant(tq)
    _assert_trees_equal(view.layers, j_quant.with_act_quant(jq).layers, ("window",))
    assert view.other is tq.other
    for key, leaf in _leaves(view.layers):
        if key.endswith("kernel_qa"):
            assert leaf is dict(_leaves(tq.layers))[key[: -len("kernel_qa")] + "kernel_q"]


def test_quantize_linear_edge_cases_equal_jax():
    rng = np.random.default_rng(0)
    k = rng.standard_normal((3, 40, 24)).astype(np.float32)
    k[1, :, 5] = 0.0  # an all-zero column: scale 1, codes 0
    k[2, 7, :] = k[2].max(axis=0) * 127.5 / 127  # a half-way code: round half to even
    bias = rng.standard_normal(24).astype(np.float32)
    got = t_quant.quantize_linear({"kernel": torch.from_numpy(k), "bias": torch.from_numpy(bias)})
    want = j_quant.quantize_linear({"kernel": jnp.asarray(k), "bias": jnp.asarray(bias)})
    _assert_trees_equal(got, want)
    assert float(got["scale"][1, 5]) == 1.0
    assert t_quant.quantize_linear(got) is got  # idempotent


@pytest.mark.parametrize("shape", [(40, 24), (3, 33, 17), (130,), (5, 64, 65)], ids=str)
def test_artifact_quantisers_equal_jax(shape):
    rng = np.random.default_rng(1)
    a = rng.standard_normal(shape).astype(np.float32)
    a.reshape(-1)[: a.size // 3] = 0.0  # zero blocks and zero columns
    t = torch.from_numpy(a)
    q, s = t_artifact._quantize_int8(t)
    jq, js = j_artifact._quantize_int8(a)
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)
    q, s, sh = t_artifact._quantize_int4(t)
    jq, js, jsh = j_artifact._quantize_int4(a)
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)
    assert sh == tuple(jsh)


@pytest.mark.parametrize("chunk_blocks", [1, 3, 65536])
def test_nf4_chunked_codes_equal_jax_one_shot(chunk_blocks):
    """NF4 over bounded chunks of blocks against the JAX package's
    one-shot numpy form, with exact ties between two levels (the first
    level wins) and a ragged last block."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal(64 * 7 + 21).astype(np.float32)
    code = j_artifact._NF4_CODE
    a[:15] = (code[:-1] + code[1:]) / 2  # block 0: midpoints ...
    a[15] = 1.0  # ... scaled by a max-abs of 1
    a[64:128] = 0.0  # an all-zero block
    packed, scale, shape = t_artifact._quantize_nf4(torch.from_numpy(a), chunk_blocks=chunk_blocks)
    jp, js, jsh = j_artifact._quantize_nf4(a)
    np.testing.assert_array_equal(packed.numpy(), jp)
    np.testing.assert_array_equal(scale.numpy(), js)
    assert shape == tuple(jsh)
    np.testing.assert_array_equal(
        t_artifact._dequantize_nf4(packed, scale, shape).numpy(), j_artifact._dequantize_nf4(jp, js, jsh)
    )


def test_int4_packing_round_trips():
    codes = torch.from_numpy(np.random.default_rng(3).integers(-7, 8, (2, 5, 7)).astype(np.int8))
    packed = pack_int4(codes)
    assert packed.dtype == torch.uint8 and packed.shape == (2, 5, 4)
    assert torch.equal(unpack_int4(packed, 7), codes)


def test_act_quant_and_w8a8_accumulator_equal_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 126)).astype(np.float32)
    x[0, 1] = 0.0  # an all-zero row: scale 1, codes 0
    w = rng.standard_normal((126, 250)).astype(np.float32)
    xq, xs = _act_quant(torch.from_numpy(x))
    jxq, jxs = j_act_quant(jnp.asarray(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    p = t_quant.quantize_linear({"kernel": torch.from_numpy(w)})
    jp = j_quant.quantize_linear({"kernel": jnp.asarray(w)})
    acc = _int_mm(xq.reshape(-1, 126), p["kernel_q"])  # M = 10, K = 126, N = 250: padded
    jacc = jax.lax.dot_general(jxq.reshape(-1, 126), jp["kernel_q"], (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(
        _dot_w8a8(torch.from_numpy(x), p["kernel_q"], p["scale"]).numpy(),
        np.asarray(j_dot_w8a8(jnp.asarray(x), jp["kernel_q"], jp["scale"])),
    )


# ---- padded stacks ----


def _mixed_moe_spec():
    cfg = transformers.Qwen2MoeConfig(
        **_COMMON, hidden_size=64, intermediate_size=96, moe_intermediate_size=48,
        shared_expert_intermediate_size=80, num_hidden_layers=3, num_attention_heads=4,
        num_key_value_heads=2, num_experts=4, num_experts_per_tok=2, mlp_only_layers=[1],
    )
    from modegpt_tpu_torch.models.spec import spec_from_hf_config

    spec = spec_from_hf_config(cfg)
    # heterogeneous ranks: every module of every layer is padded
    return spec.with_ranks(
        q_ranks=(24, 16, 32), k_ranks=(12, 8, 16), v_ranks=(8, 16, 12), o_ranks=(16, 32, 24),
        gate_ranks=(40, 64, 24), shared_gate_ranks=(60, 80, 44), has_rotary_masks=True,
    )


_PROJ = ("q", "k", "v", "o", "up", "gate", "down")


def _with_kernels(params, qp, fn):
    """``params`` with each quantised projection's ``kernel`` replaced by
    fn(its quantised dict in ``qp``, the kernel)."""
    def sub(p, q):
        return {**p, "kernel": fn(q, p["kernel"])}

    layers = []
    for lp, lq in zip(params["layers"], qp["layers"]):
        new = dict(lp)
        for k in lp:
            if k in _PROJ:
                new[k] = sub(lp[k], lq[k])
            elif k in ("experts", "shared"):
                new[k] = {n: sub(lp[k][n], lq[k][n]) for n in lp[k]}
        layers.append(new)
    return {**params, "layers": layers}


def test_quantize_after_padding_equals_padding_the_codes():
    """``quantize_padded(pad_to_uniform(p))`` is ``pad_to_uniform(p)``
    with ``quantize_params(p)``'s codes laid into the true positions
    (pads: codes 0, pad columns scale 1), on a mixed dense/MoE stack with
    a shared expert, rotary masks and every rank padded; the other MLP
    kind's all-zero kernels quantise to codes 0 with scale 1."""
    from modegpt_tpu_torch.models.init import init_params
    from modegpt_tpu_torch.models.padded import _layer_params, forward_padded

    spec = _mixed_moe_spec()
    params = init_params(spec, torch.Generator().manual_seed(5))
    for l, lp in enumerate(params["layers"]):  # each kv head keeps the lowest frequencies
        half = torch.arange(spec.k_ranks[l] // spec.n_kv_heads // 2, dtype=torch.int32)
        lp["rotary_mask"] = torch.cat([half, half + spec.head_dim // 2]).expand(spec.n_kv_heads, -1).clone()
    qp = t_quant.quantize_params(params)
    got = t_quant.quantize_padded(t_pad(spec, params))
    with pytest.raises(ValueError, match="pad first"):
        t_pad(spec, qp)
    # pad the codes (as floats) and the per-column scales (each as a
    # constant column) the way pad_to_uniform pads the kernels
    codes = dict(_leaves(t_pad(spec, _with_kernels(params, qp, lambda q, k: q["kernel_q"].float())).layers))
    scales = dict(_leaves(t_pad(spec, _with_kernels(
        params, qp, lambda q, k: q["scale"].unsqueeze(-2).expand(k.shape).clone())).layers))
    got_leaves = dict(_leaves(got.layers))
    checked = 0
    for key, leaf in got_leaves.items():
        if not key.endswith("kernel_q"):
            continue
        base = key[: -len("kernel_q")]
        np.testing.assert_array_equal(leaf.numpy(), codes[base + "kernel"].numpy(), err_msg=key)
        want = scales[base + "kernel"][..., 0, :]
        want = torch.where(want == 0.0, torch.ones_like(want), want)  # pad columns: scale 1
        np.testing.assert_array_equal(got_leaves[base + "scale"].numpy(), want.numpy(), err_msg=key)
        checked += 1
    assert checked == 13  # q k v o, dense up gate down, experts' three, the shared expert's three
    # each per-layer view hands _linear layer l's own [out] ([E, out]) scale
    view = _layer_params(got.layers, 1)
    assert view["q"]["scale"].shape == (got.spec.q_ranks[1],)
    assert view["experts"]["down"]["scale"].shape == (spec.n_experts, spec.d_model)
    # and the quantised padded forward equals the quantised unrolled one
    ids = torch.from_numpy(_ids(T=16))
    lp = forward_padded(got.spec, got.layers, got.other, got.q_hd_true, ids)
    lu, _ = t_forward(spec, qp, ids)
    np.testing.assert_allclose(lp.numpy(), lu.numpy(), **TOL)


# ---- forwards ----


@pytest.mark.parametrize("name", MODELS)
def test_quantised_forward_matches_jax(name):
    j_spec, j_params, t_spec, t_params = _pair(name)
    ids = _ids()
    jq, tq = j_quant.quantize_params(j_params), t_quant.quantize_params(t_params)
    got, _ = t_forward(t_spec, tq, torch.from_numpy(ids))
    want, _ = j_forward(j_spec, jq, jnp.asarray(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(MOE_TOL if name in MOE else TOL))
    # the weight-only forward is close to the float one (int8 noise only)
    ref, _ = t_forward(t_spec, t_params, torch.from_numpy(ids))
    rel = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))
    assert rel < 0.1, rel


@pytest.mark.parametrize("name", MODELS)
def test_w8a8_forward_matches_jax(name):
    j_spec, j_params, t_spec, t_params = _pair(name)
    ids = _ids()
    jv = j_quant.with_act_quant(j_quant.quantize_params(j_params))
    tv = t_quant.with_act_quant(t_quant.quantize_params(t_params))
    got, _ = t_forward(t_spec, tv, torch.from_numpy(ids))
    want, _ = j_forward(j_spec, jv, jnp.asarray(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **W8A8_TOL)


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("form", ["weight_only", "w8a8"])
def test_quantised_moe_dispatch_matches_jax(name, form):
    """Capacity dispatch over quantised experts, one MoE layer, with
    drops (capacity 0.75) and without (E / k); and without drops equal to
    the port's own dense form."""
    j_spec, j_params, t_spec, t_params = _pair(name)
    jl, tl = j_quant.quantize_params(j_params)["layers"][0], t_quant.quantize_params(t_params)["layers"][0]
    if form == "w8a8":
        jl = j_quant.with_act_quant({"layers": [jl]})["layers"][0]
        tl = t_quant.with_act_quant({"layers": [tl]})["layers"][0]
        assert "kernel_qa" in tl["experts"]["down"]
    x = np.random.default_rng(6).standard_normal((2, 12, 64)).astype(np.float32)
    for cf in (0.75, t_spec.n_experts / t_spec.experts_per_tok):
        got = _moe_mlp_dispatch(t_spec, tl, torch.from_numpy(x), cf)
        want = j_dispatch(j_spec, jl, jnp.asarray(x), capacity_factor=cf)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **(W8A8_TOL if form == "w8a8" else MOE_TOL))
    from modegpt_tpu_torch.models.forward import _moe_mlp

    dense, _, _ = _moe_mlp(t_spec, tl, torch.from_numpy(x), False)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **(W8A8_TOL if form == "w8a8" else MOE_TOL))


# ---- artifacts ----


@pytest.mark.parametrize("name", ["llama", "qwen2_moe"])
@pytest.mark.parametrize("dtype", QUANTISED)
def test_quantised_artifacts_cross_load(tmp_path, name, dtype):
    """The port writes and the JAX package loads, and the reverse: the
    npz keys, bytes and ``dtypes`` are equal, and so are the dequantised
    and the resident trees of either loader."""
    j_spec, j_params, t_spec, t_params = _pair(name)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    t_artifact.save_compressed_model(port_dir, t_spec, t_params, "tok", {"m": 1}, dtype=dtype)
    j_artifact.save_compressed_model(jax_dir, j_spec, j_params, "tok", {"m": 1}, dtype=dtype)
    with open(os.path.join(port_dir, "spec.json")) as f, open(os.path.join(jax_dir, "spec.json")) as g:
        assert json.load(f) == json.load(g)  # the dtypes map included
    with np.load(os.path.join(port_dir, "params.npz")) as a, np.load(os.path.join(jax_dir, "params.npz")) as b:
        assert a.files == b.files
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for src in (port_dir, jax_dir):
        for resident in (False, True):
            spec, params, tok = t_artifact.load_compressed_model(src, device="cpu", resident_int8=resident)
            js, jp, jtok = j_artifact.load_compressed_model(src, resident_int8=resident)
            assert tok == jtok == "tok" and spec.to_dict() == js.to_dict()
            _assert_trees_equal(params, jp)
            # the JAX resident tree carried across equals the port's own
            _assert_trees_equal(params_from_numpy(jax.device_get(jp), "cpu"), jp)
            leaf = params["layers"][0]["q"]
            if resident and dtype != "nf4":
                assert leaf["kernel_q"].dtype == (torch.int8 if dtype == "int8" else torch.uint8)
                assert leaf["scale"].shape == (t_spec.q_ranks[0],)
                assert params["embed_tokens"].dtype == torch.float32
            else:
                assert "kernel" in leaf and leaf["kernel"].dtype == torch.float32


@pytest.mark.parametrize("name", ["llama", "qwen2_moe"])
def test_int4_resident_runs_weight_only(tmp_path, name):
    """A resident int4 tree: its forward equals JAX's over its jnp.int4
    tree, and the W8A8 view re-keys nothing (a 4-bit code is never run as
    an 8-bit product)."""
    j_spec, j_params, t_spec, t_params = _pair(name)
    path = str(tmp_path / "a")
    t_artifact.save_compressed_model(path, t_spec, t_params, dtype="int4")
    spec, params, _ = t_artifact.load_compressed_model(path, device="cpu", resident_int8=True)
    js, jp, _ = j_artifact.load_compressed_model(path, resident_int8=True)
    view = t_quant.with_act_quant(params)
    keys = [k for k, _ in _leaves(view)]
    assert not any(k.endswith("kernel_qa") for k in keys) and any(k.endswith("kernel_q") for k in keys)
    ids = _ids()
    got, _ = t_forward(spec, view, torch.from_numpy(ids))
    want, _ = j_forward(js, jp, jnp.asarray(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(MOE_TOL if name in MOE else TOL))


def test_generate_on_a_resident_tree_matches_jax(tmp_path):
    from modegpt_tpu.models.generate import generate as j_generate
    from modegpt_tpu_torch.models.generate import generate as t_generate

    j_spec, j_params, t_spec, t_params = _pair("llama")
    path = str(tmp_path / "a")
    t_artifact.save_compressed_model(path, t_spec, t_params, dtype="int8")
    spec, params, _ = t_artifact.load_compressed_model(path, device="cpu", resident_int8=True)
    js, jp, _ = j_artifact.load_compressed_model(path, resident_int8=True)
    ids = _ids(B=2, T=5, seed=7)
    got = t_generate(spec, params, ids, max_new_tokens=6)
    want = np.asarray(j_generate(js, jp, jnp.asarray(ids), max_new_tokens=6, temperature=0.0))
    np.testing.assert_array_equal(got.numpy(), want)


# ---- the job, the eval CLI, serving ----


def _job_config(cls, root, **kw):
    return cls(
        model="in-memory", dataset="synthetic", calib_size=4, calibs_batch_size=2, seq_len=48,
        eval_batch_size=2, eval_max_samples=4, compression_ratio=0.3, sparsity_smoothing=0.5,
        max_sparsity=0.8, output_dir=str(root / "out"), temp_storage_dir=str(root / "layers"),
        metrics_dir=str(root / "metrics"), **kw,
    )


@pytest.mark.parametrize("dtype", QUANTISED)
def test_run_compression_with_a_quantised_artifact_matches_jax(tmp_path, dtype):
    j_spec, j_params, t_spec, t_params = _pair("llama")
    want = j_run(_job_config(JConfig, tmp_path / "jax", artifact_dtype=dtype), spec=j_spec, params=j_params)
    got = t_run(_job_config(TConfig, tmp_path / "port", artifact_dtype=dtype, device="cpu"),
                spec=t_spec, params=t_params)
    assert got["compressed_spec"].to_dict() == want["compressed_spec"].to_dict()
    np.testing.assert_allclose(got["compressed_ppl"], want["compressed_ppl"], rtol=1e-3)
    with open(os.path.join(got["artifact_dir"], "spec.json")) as f:
        sidecar = json.load(f)
    assert sidecar["storage_dtype"] == dtype and sidecar["dtypes"]["layers/0/q/kernel"] == dtype
    # the job evaluates the dequantised reload
    assert got["compressed_params"]["layers"][0]["q"]["kernel"].dtype == torch.float32
    if dtype == "int8":
        from modegpt_tpu_torch.evals.cli import main as t_eval

        out = t_eval(["--model", got["artifact_dir"], "--dataset", "synthetic", "--seq_len", "48",
                      "--eval_batch_size", "2", "--eval_max_samples", "4", "--device", "cpu"])
        np.testing.assert_allclose(out["ppl-synthetic"], got["compressed_ppl"], rtol=1e-6)


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, size=(n,)).astype(np.int32) for n in lengths]


def _serve(pm, cls, prompts, **kw):
    b = cls(pm, slots=2, max_len=64, prefill_bucket=8, **kw)
    ids = [b.submit(p, max_new_tokens=6) for p in prompts]
    done = b.run()
    return [list(map(int, done[r])) for r in ids]


@pytest.mark.parametrize("name", ["llama", "mixtral"])
def test_batcher_on_a_quantised_stack_matches_jax(name):
    """Greedy serving of ``quantize_padded(pm)``, per-slot prefill: the
    JAX batcher's tokens, weight-only; with ``a8_prefill`` too, or in a
    majority of requests where a near-tie flips (as the JAX package's own
    test allows)."""
    j_spec, j_params, t_spec, t_params = _pair(name)
    jpm = j_quant.quantize_padded(j_pad(j_spec, j_params))
    tpm = t_quant.quantize_padded(t_pad(t_spec, t_params))
    prompts = _prompts((5, 19, 11))
    kw = dict(prefill_exec="per_slot")
    got = _serve(tpm, TBatcher, prompts)
    assert got == _serve(jpm, JBatcher, prompts, **kw)
    got8 = _serve(tpm, TBatcher, prompts, a8_prefill=True)
    want8 = _serve(jpm, JBatcher, prompts, a8_prefill=True, **kw)
    assert sum(a == b for a, b in zip(got8, want8)) >= 2, (got8, want8)
    assert all(len(o) == len(p) + 6 for o, p in zip(got8, prompts))
    b = TBatcher(tpm, slots=2, max_len=64, prefill_bucket=8, a8_prefill=True)
    assert b.pm is tpm and "kernel_qa" in b.pm_pf.layers["q"]  # decode stays weight-only


def test_a8_prefill_on_an_unquantised_model_is_the_identity():
    _, _, t_spec, t_params = _pair("llama")
    pm = t_pad(t_spec, t_params)
    prompts = _prompts((5, 19, 30), seed=1)
    assert _serve(pm, TBatcher, prompts, a8_prefill=True) == _serve(pm, TBatcher, prompts)
    view = t_quant.with_act_quant(pm)
    assert all(a is b for (_, a), (_, b) in zip(_leaves(view.layers), _leaves(pm.layers)))


def test_serve_cli_quantize_int8_a8_prefill(tmp_path, capsys):
    """`python -m modegpt_tpu_torch.serve --quantize_int8 --a8_prefill
    --device cpu` beside the JAX CLI with the same flags."""
    from tokenizers import Tokenizer, models as tok_models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    from modegpt_tpu.serve import main as j_serve
    from modegpt_tpu_torch.serve import main as t_serve

    _, _, t_spec, t_params = _pair("llama")
    path = str(tmp_path / "a")
    t_artifact.save_compressed_model(path, t_spec, t_params)
    vocab = {f"tok{i}": i for i in range(126)}
    vocab.update({"<eos>": 126, "<unk>": 127})
    tok = Tokenizer(tok_models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, eos_token="<eos>", unk_token="<unk>").save_pretrained(path)
    flags = ["--model", path, "--prompt", "tok1 tok2 tok3", "--prompt", "tok4 tok5 tok9 tok30",
             "--max_new_tokens", "5", "--slots", "2", "--max_len", "32", "--prefill_bucket", "8",
             "--quantize_int8"]
    got = t_serve(flags + ["--device", "cpu"])
    assert {k: list(map(int, v)) for k, v in j_serve(flags).items()} == got
    got8 = t_serve(flags + ["--a8_prefill", "--device", "cpu"])
    want8 = {k: list(map(int, v)) for k, v in j_serve(flags + ["--a8_prefill"]).items()}
    assert len(got8) == 2 and sum(got8[k] == want8[k] for k in got8) >= 1
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [ln["prompt"] for ln in lines[-2:]] == ["tok1 tok2 tok3", "tok4 tok5 tok9 tok30"]
