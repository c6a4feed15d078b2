"""Parity of the port's mixture-of-experts path with the JAX package's.

Tiny mixtral, qwen3_moe (``norm_topk_prob`` both ways, and a mixed stack
with a dense middle layer) and qwen2_moe (shared expert with its sigmoid
gate, qkv biases; all-MoE and mixed) models, built offline from
transformers configs; the same numpy inputs go to both packages.

* the loader and the forward: logits against the JAX package's and HF's
  at rtol/atol 2e-4; per-expert Grams (routed tokens only) and shared
  Grams (all tokens) at the float32 forward tolerance 1e-4;
* the Type-I solves, per expert and for the shared expert, from the same
  float64 Grams: identical kept indices, factors to 1e-8;
* `run_compression` end to end: identical rank lists and kept indices,
  perplexities within 1e-4 relative. A mixed stack's dense layer is the
  exception: the port takes its rank from the layer's own width, where
  the JAX package takes the expert width; that layer is held to the JAX
  solver called at the port's rank;
* the artifact across packages, both ways; the padded stack against the
  unrolled forward; capacity dispatch against dense and against the JAX
  dispatch (drops included); masked rows claiming no capacity; greedy
  serving and the serve CLI against the JAX batcher and CLI.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from modegpt_tpu.calib.engine import CalibrationResult as JCalib  # noqa: E402
from modegpt_tpu.compress import artifact as j_artifact  # noqa: E402
from modegpt_tpu.compress.pipeline import run_compression as j_run  # noqa: E402
from modegpt_tpu.compress.pipeline import solve_layer as j_solve_layer  # noqa: E402
from modegpt_tpu.config import CompressionConfig as JConfig  # noqa: E402
from modegpt_tpu.models import forward as j_forward  # noqa: E402
from modegpt_tpu.models import params_from_hf_model as j_params_from_hf  # noqa: E402
from modegpt_tpu.models import padded as j_padded  # noqa: E402
from modegpt_tpu.models.forward import _moe_mlp_dispatch as j_dispatch  # noqa: E402
from modegpt_tpu.models.serving import ContinuousBatcher as JBatcher  # noqa: E402
from modegpt_tpu.models.spec import ModelSpec as JSpec  # noqa: E402
from modegpt_tpu.ops.mlp import nystrom_mlp as j_nystrom  # noqa: E402
from modegpt_tpu_torch.calib.data import load_calibration_batches  # noqa: E402
from modegpt_tpu_torch.calib.engine import calibrate as t_calibrate  # noqa: E402
from modegpt_tpu_torch.compress import artifact as t_artifact  # noqa: E402
from modegpt_tpu_torch.compress.batched import solve_chunk_batched  # noqa: E402
from modegpt_tpu_torch.compress.pipeline import run_compression as t_run  # noqa: E402
from modegpt_tpu_torch.compress.surgery import compress_ranks_for_layer  # noqa: E402
from modegpt_tpu_torch.config import CompressionConfig as TConfig  # noqa: E402
from modegpt_tpu_torch.evals.perplexity import resolve_exec_mode  # noqa: E402
from modegpt_tpu_torch.models import padded as t_padded  # noqa: E402
from modegpt_tpu_torch.models.convert import to_numpy  # noqa: E402
from modegpt_tpu_torch.models.forward import _moe_mlp, _moe_mlp_dispatch, _shared_expert  # noqa: E402
from modegpt_tpu_torch.models.forward import forward as t_forward  # noqa: E402
from modegpt_tpu_torch.models.hf import params_from_hf_model as t_params_from_hf  # noqa: E402
from modegpt_tpu_torch.models.serving import ContinuousBatcher as TBatcher  # noqa: E402

FWD_TOL = dict(rtol=2e-4, atol=2e-4)
TAP_TOL = dict(rtol=1e-4, atol=1e-4)
_COMMON = dict(
    vocab_size=128, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
    max_position_embeddings=128,
)


def _hf(name):
    if name == "mixtral":
        cfg = transformers.MixtralConfig(
            **_COMMON, intermediate_size=96, num_hidden_layers=2, num_local_experts=4,
            num_experts_per_tok=2, sliding_window=None,
        )
        cls = transformers.MixtralForCausalLM
    elif name.startswith("qwen3_moe"):
        cfg = transformers.Qwen3MoeConfig(
            **_COMMON, intermediate_size=96, moe_intermediate_size=48,
            num_hidden_layers=3 if name.endswith("mixed") else 2, num_experts=4, num_experts_per_tok=2,
            mlp_only_layers=[1] if name.endswith("mixed") else [], norm_topk_prob=name != "qwen3_moe",
        )
        cls = transformers.Qwen3MoeForCausalLM
    else:
        cfg = transformers.Qwen2MoeConfig(
            **_COMMON, intermediate_size=96, moe_intermediate_size=48, shared_expert_intermediate_size=80,
            num_hidden_layers=3 if name.endswith("mixed") else 2, num_experts=4, num_experts_per_tok=2,
            mlp_only_layers=[1] if name.endswith("mixed") else [],
        )
        cls = transformers.Qwen2MoeForCausalLM
    torch.manual_seed(0)
    return cls(cfg).eval()


# qwen3_moe: norm_topk_prob False; qwen3_moe_norm: True; *_mixed: layer 1 dense
MODELS = ["mixtral", "qwen3_moe", "qwen3_moe_norm", "qwen3_moe_mixed", "qwen2_moe", "qwen2_moe_mixed"]


def _ids(B=2, T=16, seed=0):
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


@pytest.mark.parametrize("name", MODELS)
def test_loader_and_forward_match_jax_and_hf(name):
    model = _hf(name)
    j_spec, j_params = j_params_from_hf(model)
    t_spec, t_params = t_params_from_hf(model, device="cpu")
    assert t_spec.to_dict() == j_spec.to_dict() and t_spec.n_experts == 4
    j_flat = dict(_leaves(jax.device_get(j_params)))
    t_flat = dict(_leaves(t_params))
    assert sorted(t_flat) == sorted(j_flat)
    for key, leaf in t_flat.items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(j_flat[key]), err_msg=key)
    ids = _ids()
    with torch.no_grad():
        ref = model(torch.from_numpy(ids.astype(np.int64))).logits.numpy()
    tl, _ = t_forward(t_spec, t_params, torch.from_numpy(ids))
    jl, _ = j_forward(j_spec, j_params, jnp.asarray(ids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD_TOL)
    np.testing.assert_allclose(tl.numpy(), ref, **FWD_TOL)


@pytest.mark.parametrize("name", ["mixtral", "qwen3_moe_norm", "qwen2_moe_mixed"])
def test_routed_and_shared_grams_match_jax(name):
    """One tapped layer per forward: cov_mlp is [E, D, D] over the routed
    tokens on a MoE layer ([D', D'] on the mixed stack's dense layer),
    cov_shared the shared expert's Gram over every token."""
    model = _hf(name)
    j_spec, j_params = j_params_from_hf(model)
    t_spec, t_params = t_params_from_hf(model, device="cpu")
    ids = _ids(seed=1)
    for layer in range(t_spec.n_layers):
        _, js = j_forward(j_spec, j_params, jnp.asarray(ids), stats_layers=(layer,))
        _, ts = t_forward(t_spec, t_params, torch.from_numpy(ids), stats_layers=(layer,))
        D = t_spec.d_int if t_spec.is_moe_layer(layer) else t_spec.gate_ranks[layer]
        want_mlp = (1, 4, D, D) if t_spec.is_moe_layer(layer) else (1, D, D)
        assert tuple(ts.cov_mlp.shape) == want_mlp
        for field in ("cov_mlp", "cov_q", "cov_k", "cov_x", "bi_acc", "cov_shared"):
            got, want = getattr(ts, field), getattr(js, field)
            assert (got is None) == (want is None), field
            if got is not None:
                np.testing.assert_allclose(got.numpy(), np.asarray(want), **TAP_TOL, err_msg=field)
        assert (ts.cov_shared is not None) == t_spec.has_shared_expert(layer)


def test_routed_gram_counts_each_routed_token_once():
    """The routed tap is a 0/1 mask: the Gram of expert e is the Gram of
    h_e over the tokens routed to e, not weighted by their routing
    weights, recomputed here from the port's own router and experts."""
    spec, params = t_params_from_hf(_hf("qwen3_moe"), device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 12, 64)).astype(np.float32))
    lp = params["layers"][0]
    _, h_routed, _ = _moe_mlp(spec, lp, x, True)
    probs = torch.softmax(x[0] @ lp["router"]["kernel"], dim=-1)
    sel = torch.topk(probs, 2, dim=-1).indices
    ek = lp["experts"]
    for e in range(4):
        xe = x[0][(sel == e).any(-1)]
        he = torch.nn.functional.silu(xe @ ek["gate"]["kernel"][e]) * (xe @ ek["up"]["kernel"][e])
        got = h_routed[0, :, e].T @ h_routed[0, :, e]
        np.testing.assert_allclose(got.numpy(), (he.T @ he).numpy(), rtol=1e-5, atol=1e-6)


def test_expert_and_shared_factors_match_jax():
    """Type-I per expert and for the shared expert, and the qk biases
    sliced through the rotary mask, from the same float64 Grams."""
    model = _hf("qwen2_moe")
    j_spec, j_params = j_params_from_hf(model)
    t_spec, t_params = t_params_from_hf(model, device="cpu")
    batches = load_calibration_batches(None, "synthetic", 4, 2, 32, vocab_size=128)
    calib = t_calibrate(t_spec, t_params, batches, [0])
    assert calib.cov_mlp[0].dtype == torch.float64 and tuple(calib.cov_shared[0].shape) == (80, 80)
    keep = 0.55
    config = TConfig(device="cpu", compression_ratio=0.3)
    got = solve_chunk_batched(t_spec, t_params, [0], [keep, keep], calib, config, "mlp,qk,vo")
    j_calib = JCalib(
        **{f: {0: getattr(calib, f)[0].numpy()} for f in ("cov_mlp", "cov_q", "cov_k", "cov_x", "cov_shared")},
        bi_scores=calib.bi_scores, n_sequences=calib.n_sequences, total_tokens=calib.total_tokens,
    )
    want = j_solve_layer(j_spec, jax.device_get(j_params)["layers"][0], 0, keep, j_calib, JConfig(), "mlp,qk,vo")
    assert got["mlp"][0]["up"].shape == (4, int(48 * keep), 64)
    assert got["mlp"][0]["shared_up"].shape == (int(80 * keep), 64)
    for suffix in ("mlp", "qk", "vo"):
        assert sorted(got[suffix][0]) == sorted(want[suffix]), suffix
        for key, arr in want[suffix].items():
            if key.endswith("idx") or key == "rotary_mask":
                np.testing.assert_array_equal(got[suffix][0][key], np.asarray(arr), err_msg=key)
            else:
                np.testing.assert_allclose(got[suffix][0][key], np.asarray(arr), rtol=1e-8, atol=1e-8, err_msg=key)


def _config(cls, root, **kw):
    return cls(**{
        **dict(
            model="in-memory", dataset="synthetic", calib_size=4, calibs_batch_size=2, seq_len=48,
            eval_batch_size=4, eval_max_samples=4, compression_ratio=0.3, sparsity_smoothing=0.2,
            output_dir=str(root / "out"), temp_storage_dir=str(root / "layers"), metrics_dir=str(root / "metrics"),
        ),
        **kw,
    })


@pytest.mark.parametrize("name", ["mixtral", "qwen3_moe", "qwen2_moe"])
def test_end_to_end_matches_jax(tmp_path, name):
    model = _hf(name)
    j_spec, j_params = j_params_from_hf(model)
    t_spec, t_params = t_params_from_hf(model, device="cpu")
    want = j_run(_config(JConfig, tmp_path / "jax"), spec=j_spec, params=j_params)
    got = t_run(_config(TConfig, tmp_path / "port", device="cpu"), spec=t_spec, params=t_params)
    assert got["compressed_spec"].to_dict() == want["compressed_spec"].to_dict()
    assert max(got["compressed_spec"].gate_ranks) < t_spec.d_int
    for l in range(t_spec.n_layers):
        jm = j_artifact.load_layer_factors(str(tmp_path / "jax" / "layers"), l, "mlp")
        tm = t_artifact.load_layer_factors(str(tmp_path / "port" / "layers"), l, "mlp")
        assert sorted(tm) == sorted(jm)
        np.testing.assert_array_equal(tm["idx"], jm["idx"])
    for key in ("baseline_ppl", "compressed_ppl"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)


def test_mixed_stack_dense_layer_takes_its_own_width(tmp_path):
    """qwen3_moe with a dense middle layer (intermediate 96, experts 48):
    the MoE layers match the JAX job; the dense layer's rank comes from
    96 (the JAX package cuts it from 48), and its factors equal the JAX
    solver's at that rank on the port's own Gram."""
    model = _hf("qwen3_moe_mixed")
    j_spec, j_params = j_params_from_hf(model)
    t_spec, t_params = t_params_from_hf(model, device="cpu")
    want = j_run(_config(JConfig, tmp_path / "jax"), spec=j_spec, params=j_params)
    got = t_run(_config(TConfig, tmp_path / "port", device="cpu"), spec=t_spec, params=t_params)
    ws, gs = want["compressed_spec"], got["compressed_spec"]
    for ranks in ("q_ranks", "k_ranks", "v_ranks", "o_ranks"):
        assert getattr(gs, ranks) == getattr(ws, ranks), ranks
    assert [gs.gate_ranks[l] for l in (0, 2)] == [ws.gate_ranks[l] for l in (0, 2)]
    for l in (0, 2):
        jm = j_artifact.load_layer_factors(str(tmp_path / "jax" / "layers"), l, "mlp")
        tm = t_artifact.load_layer_factors(str(tmp_path / "port" / "layers"), l, "mlp")
        np.testing.assert_array_equal(tm["idx"], jm["idx"])
    np.testing.assert_allclose(got["baseline_ppl"], want["baseline_ppl"], rtol=1e-4)
    assert np.isfinite(got["compressed_ppl"])

    # the dense layer: rank from its own width, the JAX solver at that rank
    tm = t_artifact.load_layer_factors(str(tmp_path / "port" / "layers"), 1, "mlp")
    r = tm["up"].shape[0]
    assert ws.gate_ranks[1] < 48 < r < 96 and gs.gate_ranks[1] == r
    batches = load_calibration_batches(None, "synthetic", 4, 2, 48, vocab_size=128)
    C = t_calibrate(t_spec, t_params, batches, [1]).cov_mlp[1].numpy()
    lp = jax.device_get(j_params)["layers"][1]
    f = j_nystrom(
        jnp.asarray(C), jnp.asarray(np.asarray(lp["up"]["kernel"]).T, jnp.float64),
        jnp.asarray(np.asarray(lp["gate"]["kernel"]).T, jnp.float64),
        jnp.asarray(np.asarray(lp["down"]["kernel"]).T, jnp.float64), 0.5, JConfig().nystrom_ridge, rank=r,
    )
    np.testing.assert_array_equal(tm["idx"], np.asarray(f.idx))
    for key in ("up", "gate", "down"):
        np.testing.assert_allclose(tm[key], np.asarray(getattr(f, key)), rtol=1e-8, atol=1e-8, err_msg=key)


def test_mixed_ranks_and_calibration_in_one_pass():
    """compress_ranks_for_layer: a mixed stack's dense layer from its own
    width, MoE layers and every layer of an all-MoE stack from d_int, the
    shared expert from its own width; one calibration pass taps both
    kinds, equal to one pass per kind."""
    t_spec, t_params = t_params_from_hf(_hf("qwen2_moe_mixed"), device="cpu")
    assert t_spec.gate_ranks == (48, 96, 48)
    assert [compress_ranks_for_layer(t_spec, 0.5, "mlp", layer=l) for l in range(3)] == [24, 48, 24]
    assert compress_ranks_for_layer(t_spec, 0.5, "mlp") == 24
    assert compress_ranks_for_layer(t_spec, 0.5, "shared") == 40
    batches = load_calibration_batches(None, "synthetic", 2, 2, 32, vocab_size=128)
    both = t_calibrate(t_spec, t_params, batches, [0, 1, 2])
    assert sorted(both.cov_shared) == [0, 2]
    for group in ([0, 2], [1]):
        part = t_calibrate(t_spec, t_params, batches, group)
        assert part.bi_scores == both.bi_scores
        for l in group:
            for field in ("cov_mlp", "cov_q", "cov_k", "cov_x"):
                torch.testing.assert_close(getattr(part, field)[l], getattr(both, field)[l], rtol=0, atol=0)


def _port_compressed(tmp_path, name):
    """A tiny MoE compressed by the port (heterogeneous gate and shared
    ranks, rotary masks); returns (spec, params, artifact dir)."""
    spec, params = t_params_from_hf(_hf(name), device="cpu")
    cfg = _config(TConfig, tmp_path / name, device="cpu", compression_ratio=0.4,
                  skip_baseline_eval=True, skip_final_eval=True, sparsity_smoothing=0.05)
    res = t_run(cfg, spec=spec, params=params)
    return res["compressed_spec"], res["compressed_params"], res["artifact_dir"]


@pytest.mark.parametrize("name", ["qwen2_moe_mixed", "mixtral"])
def test_artifact_cross_load(tmp_path, name):
    spec, params, src = _port_compressed(tmp_path, name)
    j_spec, j_params, _ = j_artifact.load_compressed_model(src)
    assert j_spec.to_dict() == spec.to_dict()
    jax_dir = str(tmp_path / "jax_saved")
    j_artifact.save_compressed_model(jax_dir, j_spec, j_params, "tok", {})
    spec2, params2, _ = t_artifact.load_compressed_model(jax_dir, device="cpu")
    assert spec2 == spec
    with np.load(os.path.join(src, "params.npz")) as a, np.load(os.path.join(jax_dir, "params.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert any("/experts/" in k for k in a.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    ids = _ids(seed=3)
    tl, _ = t_forward(spec2, params2, torch.from_numpy(ids))
    jl, _ = j_forward(j_spec, j_params, jnp.asarray(ids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD_TOL)
    bad = {k: v for k, v in params2.items()}
    bad["layers"] = [dict(lp) for lp in params2["layers"]]
    bad["layers"][0]["experts"] = {**bad["layers"][0]["experts"], "up": {"kernel": torch.zeros(4, 64, 3)}}
    with pytest.raises(ValueError, match="layers/0/experts/up"):
        t_artifact._validate_shapes(spec2, bad)


@pytest.mark.parametrize("name", ["qwen2_moe_mixed", "qwen3_moe_norm"])
def test_padded_matches_unrolled_and_jax(tmp_path, name):
    """The padded stack of a compressed MoE model (expert stacks padded to
    the widest gate rank, shared experts to the widest shared rank; a
    mixed stack carries both kinds) against the unrolled forward and the
    JAX padded forward, dense and dispatch at no-drop capacity."""
    spec, params, _ = _port_compressed(tmp_path, name)
    assert len(set(spec.gate_ranks)) > 1
    pm = t_padded.pad_to_uniform(spec, params)
    jpm = j_padded.pad_to_uniform(JSpec.from_dict(spec.to_dict()), jax.tree_util.tree_map(jnp.asarray, _tree_numpy(params)))
    ids = _ids(seed=4)
    want, _ = t_forward(spec, params, torch.from_numpy(ids))
    full = spec.n_experts / spec.experts_per_tok
    for moe in ("dense", "dispatch"):
        got = t_padded.forward_padded(pm.spec, pm.layers, pm.other, pm.q_hd_true, torch.from_numpy(ids),
                                      moe=moe, moe_capacity=full)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD_TOL)
        jl = j_padded.forward_padded(jpm.spec, jpm.layers, jpm.other, jpm.q_hd_true, jnp.asarray(ids),
                                     moe=moe, moe_capacity=full)
        np.testing.assert_allclose(got.numpy(), np.asarray(jl), **FWD_TOL)
    assert pm.spec.to_dict() == jpm.spec.to_dict()
    mixed = name.endswith("mixed")
    assert resolve_exec_mode(spec, "auto") == ("unrolled" if mixed else "padded")


def _tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_numpy(v) for v in tree]
    return None if tree is None else to_numpy(tree)


@pytest.mark.parametrize("name", ["mixtral", "qwen2_moe"])
@pytest.mark.parametrize("capacity", ["full", 1.0, 0.5])
def test_dispatch_matches_jax_and_dense(name, capacity):
    """At capacity >= E/k dispatch equals dense; at tight capacity the
    port drops exactly the assignments the JAX dispatch drops."""
    spec, params = t_params_from_hf(_hf(name), device="cpu")
    j_spec, j_params = j_params_from_hf(_hf(name))
    x = np.random.default_rng(5).standard_normal((2, 16, 64)).astype(np.float32)
    cf = spec.n_experts / spec.experts_per_tok if capacity == "full" else capacity
    got = _moe_mlp_dispatch(spec, params["layers"][0], torch.from_numpy(x), cf)
    want = j_dispatch(j_spec, j_params["layers"][0], jnp.asarray(x), capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    if capacity == "full":
        dense, _, _ = _moe_mlp(spec, params["layers"][0], torch.from_numpy(x), False)
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5, atol=1e-6)


def test_dispatch_masked_rows_do_not_steal_capacity():
    """Seven masked rows and one real row at capacity 4: the masked rows
    go to the virtual expert, so the real row equals the dense path and
    the masked rows get the shared expert only (JAX test_moe.py:540)."""
    spec, params = t_params_from_hf(_hf("qwen2_moe"), device="cpu")
    lp = params["layers"][0]
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((8, 1, 64)).astype(np.float32))
    valid = torch.tensor([False] * 7 + [True])[:, None]
    dense, _, _ = _moe_mlp(spec, lp, x, False)
    masked = _moe_mlp_dispatch(spec, lp, x, 1.0, token_valid=valid)
    np.testing.assert_allclose(masked[7].numpy(), dense[7].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(masked[:7].numpy(), _shared_expert(spec, lp, x)[0][:7].numpy(), rtol=1e-5, atol=1e-6)
    # without the mask the garbage rows do take the real row's slots
    unmasked = _moe_mlp_dispatch(spec, lp, x, 1.0)
    assert not np.allclose(unmasked[7].numpy(), dense[7].numpy(), rtol=1e-5, atol=1e-6)


def test_ties_go_to_the_lower_expert():
    """A zero row gives exactly tied router probabilities: the top k are
    the lowest expert indices, as lax.top_k picks them."""
    from modegpt_tpu_torch.models.forward import _route

    spec, params = t_params_from_hf(_hf("mixtral"), device="cpu")
    w, idx = _route(spec, params["layers"][0], torch.zeros(3, 64))
    assert idx.tolist() == [[0, 1]] * 3 and torch.allclose(w, torch.full((3, 2), 0.5))


KW = dict(slots=2, max_len=64, prefill_bucket=8)


def _serve(pm, cls, prompts, max_new, **kw):
    b = cls(pm, **{**KW, **kw})
    ids = [b.submit(p, max_new_tokens=max_new) for p in prompts]
    done = b.run()
    return [list(map(int, done[r])) for r in ids]


@pytest.mark.parametrize("moe", ["dense", "dispatch"])
def test_batcher_matches_jax(tmp_path, moe):
    """Greedy serving of a compressed mixed qwen2_moe: the port's batcher
    gives the JAX batcher's tokens, prefill chunks and masked decode rows
    included; dispatch at no-drop capacity gives dense's tokens."""
    spec, params, _ = _port_compressed(tmp_path, "qwen2_moe_mixed")
    jpm = j_padded.pad_to_uniform(JSpec.from_dict(spec.to_dict()), jax.tree_util.tree_map(jnp.asarray, _tree_numpy(params)))
    tpm = t_padded.pad_to_uniform(spec, params)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 128, size=(n,)).astype(np.int32) for n in (5, 19, 3)]
    full = spec.n_experts / spec.experts_per_tok
    kw = dict(moe=moe, moe_capacity=full)
    got = _serve(tpm, TBatcher, prompts, 6, **kw)
    assert got == _serve(jpm, JBatcher, prompts, 6, **kw)
    if moe == "dispatch":
        assert got == _serve(tpm, TBatcher, prompts, 6)
    with pytest.raises(ValueError, match="moe"):
        TBatcher(tpm, moe="sparse")


def test_serve_cli_moe_dispatch_on_cpu(tmp_path, capsys):
    """`serve --moe_exec dispatch` on a MoE artifact: the JAX CLI's
    completions."""
    from tokenizers import Tokenizer, models as tok_models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    from modegpt_tpu.serve import main as j_serve
    from modegpt_tpu_torch.serve import main as t_serve

    _, _, artifact = _port_compressed(tmp_path, "qwen2_moe")
    vocab = {f"tok{i}": i for i in range(126)}
    vocab.update({"<eos>": 126, "<unk>": 127})
    tok = Tokenizer(tok_models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, eos_token="<eos>", unk_token="<unk>").save_pretrained(artifact)
    flags = ["--model", artifact, "--prompt", "tok1 tok2 tok3", "--prompt", "tok4 tok5 tok9 tok7",
             "--max_new_tokens", "5", "--slots", "2", "--max_len", "32", "--prefill_bucket", "8",
             "--moe_exec", "dispatch", "--moe_capacity", "2.0"]
    got = t_serve(flags + ["--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(got) == 2 and len(lines) == 2
    assert {k: list(map(int, v)) for k, v in j_serve(flags).items()} == got


def test_generate_matches_jax():
    """KV-cache generation through the MoE layer step, greedy."""
    from modegpt_tpu.models.generate import generate as j_generate
    from modegpt_tpu_torch.models.generate import generate as t_generate

    model = _hf("qwen3_moe_mixed")
    j_spec, j_params = j_params_from_hf(model)
    t_spec, t_params = t_params_from_hf(model, device="cpu")
    ids = _ids(B=2, T=5, seed=8)
    want = np.asarray(j_generate(j_spec, j_params, ids, max_new_tokens=6, temperature=0.0))
    got = t_generate(t_spec, t_params, ids, max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_params_shapes():
    from modegpt_tpu_torch.models.init import init_params

    t_spec, _ = t_params_from_hf(_hf("qwen2_moe_mixed"), device="cpu")
    params = init_params(t_spec, torch.Generator().manual_seed(0), device="cpu")
    t_artifact._validate_shapes(t_spec, params)
    assert set(params["layers"][1]) >= {"up", "gate", "down"} and "experts" not in params["layers"][1]
    assert tuple(params["layers"][0]["experts"]["down"]["kernel"].shape) == (4, 48, 64)
    assert tuple(params["layers"][2]["shared_gate"]["kernel"].shape) == (64, 1)
    logits, _ = t_forward(t_spec, params, torch.from_numpy(_ids()))
    assert torch.isfinite(logits).all()
