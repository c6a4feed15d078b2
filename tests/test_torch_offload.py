"""The port's big-model paths against the JAX package's, on the CPU.

`compress/offload` (the layer-streamed sweep, its staging, flush and
fetch modes), `calib/engine.calibrate_window`, the `solve_chunk_batched`
fetch modes and `compress_in_memory`, each on the same seeded weights
(JAX ``init_params`` -> numpy -> the port's tree) beside the JAX
function, and the pipeline's ``calib_exec="stream"`` and ``"window"``
jobs beside JAX's ``run_compression``.

On the CPU every leaf is on the compute device, so a sweep here is
resident; the host-staged branch (CPU leaves, a card computing) is
reached by patching `offload._host_staged`, the one place that decides
it. Tolerances: the port against itself bit for bit where the
arithmetic is the same; against the JAX package BI to 1e-4 relative,
identical ranks, kept indices and rotary masks, and float32 factors to
2e-3 relative (V/O as sign-free per-head products).

JAX tests with no counterpart here: the compile-count test (no jit),
the device-kind memory table, the five drop-recovery tests and the
recursive-Cholesky retry (not ported; see `compress/offload.py`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from modegpt_tpu.calib.data import load_calibration_batches  # noqa: E402
from modegpt_tpu.calib.engine import calibrate_window as j_calibrate_window  # noqa: E402
from modegpt_tpu.compress import offload as j_offload  # noqa: E402
from modegpt_tpu.compress.pipeline import compress_in_memory as j_compress_in_memory  # noqa: E402
from modegpt_tpu.compress.pipeline import run_compression as j_run  # noqa: E402
from modegpt_tpu.config import CompressionConfig as JConfig  # noqa: E402
from modegpt_tpu.models.init import init_params as j_init  # noqa: E402
from modegpt_tpu.models.spec import ModelSpec as JSpec  # noqa: E402
from modegpt_tpu_torch.calib.engine import calibrate, calibrate_window  # noqa: E402
from modegpt_tpu_torch.compress import batched as batched_mod  # noqa: E402
from modegpt_tpu_torch.compress import offload  # noqa: E402
from modegpt_tpu_torch.compress.batched import solve_chunk_batched  # noqa: E402
from modegpt_tpu_torch.compress.offload import stream_bi_sweep, stream_calibrate_solve  # noqa: E402
from modegpt_tpu_torch.compress.pipeline import compress_in_memory, run_compression  # noqa: E402
from modegpt_tpu_torch.compress.surgery import apply_factors, compress_ranks_for_layer  # noqa: E402
from modegpt_tpu_torch.config import CompressionConfig  # noqa: E402
from modegpt_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from modegpt_tpu_torch.models.forward import forward  # noqa: E402
from modegpt_tpu_torch.models.spec import ModelSpec  # noqa: E402
from modegpt_tpu_torch.ops.allocation import allocate_keep_ratios  # noqa: E402
from modegpt_tpu_torch.utils.memory import device_memory_stats  # noqa: E402

KERNELS = ("q", "k", "v", "o", "up", "gate", "down")


def _llama_kw(n_layers=3, d_model=64, d_int=144):
    return dict(
        arch="llama", vocab_size=128, d_model=d_model, n_layers=n_layers,
        n_heads=4, n_kv_heads=2, head_dim=d_model // 4,
        d_int=d_int, max_position_embeddings=128, act="silu", norm="rmsnorm",
        norm_eps=1e-6, rope_theta=10000.0, attention_bias=False, mlp_bias=False,
        tie_word_embeddings=False,
        q_ranks=(d_model,) * n_layers, k_ranks=(d_model // 2,) * n_layers,
        v_ranks=(d_model // 2,) * n_layers, o_ranks=(d_model,) * n_layers,
        gate_ranks=(d_int,) * n_layers,
    )


MIXED_KW = dict(
    arch="mixtral", vocab_size=128, d_model=64, n_layers=3, n_heads=4,
    n_kv_heads=2, head_dim=16, d_int=48, max_position_embeddings=128,
    act="silu", norm="rmsnorm", norm_eps=1e-6, rope_theta=10000.0,
    attention_bias=False, mlp_bias=False, tie_word_embeddings=False,
    q_ranks=(64,) * 3, k_ranks=(32,) * 3, v_ranks=(32,) * 3,
    o_ranks=(64,) * 3, gate_ranks=(96, 48, 96),
    n_experts=4, experts_per_tok=2, moe_layers=(1,),
)


def _model(kw, seed=0):
    """(port spec, port CPU tree, JAX spec, JAX host-numpy tree) of the
    same weights."""
    j_spec = JSpec(**kw)
    host = jax.tree_util.tree_map(np.asarray, j_init(j_spec, jax.random.key(seed)))
    return ModelSpec(**kw), params_from_numpy(host, device="cpu"), j_spec, host


def _batches():
    return load_calibration_batches(None, "synthetic", 4, 2, 32, vocab_size=128)


def _config(cls=CompressionConfig, **kw):
    kw.setdefault("solver_precision", "f32_device")
    if cls is CompressionConfig:
        kw.setdefault("device", "cpu")
        # what "auto" resolves to in a JAX sweep on the CPU: exact staging
        # (here "auto" would probe quantised staging for a staged tree)
        kw.setdefault("bi_stage_dtype", "bf16")
    return cls(
        model="mem", dataset="synthetic", calib_size=4, calibs_batch_size=2,
        seq_len=32, compression_ratio=0.3, sparsity_smoothing=0.5, **kw
    )


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy() if a.is_floating_point() else a.numpy()
    return np.asarray(a)


def _assert_factors_equal(got, want):
    assert sorted(got) == sorted(want)
    for s in want:
        assert sorted(got[s]) == sorted(want[s]), s
        for l in want[s]:
            assert sorted(got[s][l]) == sorted(want[s][l]), (s, l)
            for k, v in want[s][l].items():
                np.testing.assert_array_equal(_np(got[s][l][k]), _np(v), err_msg=f"{s}[{l}][{k}]")


def _vo_products(fd, spec, r):
    """Per (kv head, group member) V_h^T O_hg^T products: [Hk, G, d, d],
    free of the SVD's per-vector signs."""
    v, o = _np(fd["v"]).astype(np.float64), _np(fd["o"]).astype(np.float64)
    Hk, G = spec.n_kv_heads, spec.n_heads // spec.n_kv_heads
    out = np.empty((Hk, G, v.shape[1], v.shape[1]))
    for h in range(Hk):
        vh = v[h * r:(h + 1) * r]  # [r, d]
        for g in range(G):
            qh = h * G + g
            out[h, g] = vh.T @ o[:, qh * r:(qh + 1) * r].T
    return out


def _assert_factors_match_jax(got, want, spec, keep):
    """Port factors against the JAX package's from the same weights."""
    for s in want:
        assert sorted(got[s]) == sorted(int(l) for l in want[s]), s
        for l in want[s]:
            g, w = got[s][l], want[s][l]
            for k in ("idx", "rotary_mask", "shared_idx"):
                if k in w:
                    np.testing.assert_array_equal(_np(g[k]), np.asarray(w[k]), err_msg=f"{s}[{l}][{k}]")
            if s == "vo":
                r = compress_ranks_for_layer(spec, float(keep[l]), "vo")
                np.testing.assert_allclose(
                    _vo_products(g, spec, r), _vo_products(w, spec, r), rtol=2e-3, atol=2e-5,
                    err_msg=f"vo[{l}]",
                )
                continue
            for k, v in w.items():
                if k in ("idx", "rotary_mask", "shared_idx") or v is None:
                    continue
                np.testing.assert_allclose(
                    _np(g[k]), np.asarray(v, dtype=np.float32), rtol=2e-3, atol=2e-5, err_msg=f"{s}[{l}][{k}]"
                )


@pytest.fixture
def staged(monkeypatch):
    """Treat the CPU tree as host-staged: the sweep's staging, slimmed
    windows, host-row gathers and host-only policies run on the CPU."""
    monkeypatch.setattr(offload, "_host_staged", lambda params, device: True)


# ---- the streamed sweep -------------------------------------------------


def test_stream_matches_chunked_and_jax():
    """The streamed sweep's factors equal calibrate + solve_chunk_batched
    (the same solves on the same sums, another schedule) bit for bit,
    and the JAX sweep's to the stated tolerance."""
    spec, params, j_spec, host = _model(_llama_kw())
    batches = _batches()
    calib = calibrate(spec, params, batches, [0, 1, 2], accumulate="device")
    keep, _ = allocate_keep_ratios(calib.bi_scores, 0.3, 0.5, 0.8)
    ref = solve_chunk_batched(spec, params, [0, 1, 2], keep, calib, _config(), "mlp,qk,vo")

    factors, bi, keep_s = stream_calibrate_solve(spec, params, batches, _config(layers_per_step=2))
    np.testing.assert_allclose(bi, calib.bi_scores, rtol=2e-5)
    np.testing.assert_array_equal(keep_s, np.asarray(keep))
    _assert_factors_equal(factors, ref)

    j_factors, j_bi, j_keep = j_offload.stream_calibrate_solve(
        j_spec, jax.tree_util.tree_map(jnp.asarray, host), batches, _config(JConfig, layers_per_step=2)
    )
    np.testing.assert_allclose(bi, j_bi, rtol=1e-4)
    _assert_factors_match_jax(factors, j_factors, spec, keep_s)


def test_staged_equals_resident_bitwise(monkeypatch):
    """Host staging is a transport: the host-staged sweep (slimmed
    windows, rows gathered from the host tree) equals the resident one
    bit for bit, and stages every layer twice (prepass and sweep)."""
    spec, params, _, _ = _model(_llama_kw(), seed=1)
    batches = _batches()
    f_dev, bi_dev, keep_dev = stream_calibrate_solve(spec, params, batches, _config(layers_per_step=1))
    monkeypatch.setattr(offload, "_host_staged", lambda params, device: True)
    stats = {}
    f_host, bi_host, keep_host = stream_calibrate_solve(
        spec, params, batches, _config(layers_per_step=1), stats_out=stats
    )
    np.testing.assert_array_equal(keep_dev, keep_host)
    assert bi_dev == bi_host
    _assert_factors_equal(f_host, f_dev)
    layer_bytes = sum(t.numel() * t.element_size() for lp in params["layers"] for t in offload._leaves(lp))
    assert stats["staged_bytes"] >= 2 * layer_bytes


def test_stream_fixed_keep_and_target_layers():
    """keep_ratios given -> no prepass; target_layers restricts the solves
    (the resume path) without touching the forward."""
    spec, params, _, _ = _model(_llama_kw(), seed=2)
    keep = np.asarray([0.7, 0.8, 0.9])
    stats = {}
    factors, bi, keep_out = stream_calibrate_solve(
        spec, params, _batches(), _config(layers_per_step=2), keep_ratios=keep, target_layers=[1, 2],
        stats_out=stats,
    )
    np.testing.assert_array_equal(keep_out, keep)
    assert "prepass_s" not in stats
    for s in ("mlp", "qk", "vo"):
        assert sorted(factors[s]) == [1, 2]
    assert len(bi) == 3 and all(np.isfinite(bi))


def test_stream_bi_matches_calibrate_and_jax():
    spec, params, j_spec, host = _model(_llama_kw(), seed=3)
    batches = _batches()
    ref = calibrate(spec, params, batches, [0], accumulate="host")
    bi = stream_bi_sweep(spec, params, batches, device="cpu")
    np.testing.assert_allclose(bi, ref.bi_scores, rtol=2e-5)
    np.testing.assert_allclose(bi, j_offload.stream_bi_sweep(j_spec, host, batches), rtol=1e-4)


def test_stream_moe_mixed_stack():
    """A mixed dense/MoE stack: per-expert factor stacks, equal to the
    chunked solves, and the JAX sweep's allocation and selections."""
    spec, params, j_spec, host = _model(MIXED_KW, seed=4)
    batches = _batches()
    factors, bi, keep = stream_calibrate_solve(spec, params, batches, _config(layers_per_step=3))
    assert factors["mlp"][0]["up"].ndim == 2 and factors["mlp"][1]["up"].shape[0] == 4
    calib = calibrate(spec, params, batches, [0, 1, 2], accumulate="device")
    ref = solve_chunk_batched(spec, params, [0, 1, 2], keep, calib, _config(), "mlp,qk,vo")
    _assert_factors_equal(factors, ref)

    j_factors, j_bi, j_keep = j_offload.stream_calibrate_solve(
        j_spec, jax.tree_util.tree_map(jnp.asarray, host), batches, _config(JConfig, layers_per_step=3)
    )
    np.testing.assert_allclose(bi, j_bi, rtol=1e-4)
    np.testing.assert_allclose(keep, j_keep, rtol=1e-6)
    # the JAX package ranks the mixed stack's dense layers from the expert
    # width (ROADMAP Queue 3); the MoE layer's selections agree
    np.testing.assert_array_equal(factors["mlp"][1]["idx"], np.asarray(j_factors["mlp"][1]["idx"]))
    for l in range(3):
        np.testing.assert_array_equal(factors["qk"][l]["rotary_mask"], np.asarray(j_factors["qk"][l]["rotary_mask"]))


@pytest.mark.parametrize("mode", ["staged", "resident"])
def test_stream_async_flush_equals_sync(monkeypatch, mode):
    """stream_async_flush on == off bit for bit on a mixed stack at
    width 1 (dense windows on the worker, the MoE window in line), and
    on_window sees every window in layer order."""
    if mode == "staged":
        monkeypatch.setattr(offload, "_host_staged", lambda params, device: True)
    spec, params, _, _ = _model(MIXED_KW, seed=4)
    runs = {}
    for flag in ("on", "off"):
        windows, stats = [], {}
        runs[flag] = stream_calibrate_solve(
            spec, params, _batches(), _config(layers_per_step=1, stream_async_flush=flag),
            on_window=lambda layers, chunk: windows.append(list(layers)), stats_out=stats,
        )
        assert windows == [[0], [1], [2]]
        assert stats["async_flush"] is (flag == "on")
    assert runs["on"][1] == runs["off"][1]
    np.testing.assert_array_equal(runs["on"][2], runs["off"][2])
    _assert_factors_equal(runs["on"][0], runs["off"][0])


def test_stream_flush_depth_equals_depth1(staged):
    """stream_flush_depth 3 (the sweep runs ahead of the drain) equals
    depth 1 bit for bit, with a coherent phase split."""
    spec, params, _, _ = _model(_llama_kw(n_layers=5), seed=7)
    runs = {}
    for depth in (1, 3):
        stats = {}
        runs[depth] = stream_calibrate_solve(
            spec, params, _batches(),
            _config(layers_per_step=1, stream_async_flush="on", stream_flush_depth=depth), stats_out=stats,
        )
        assert stats["async_flush"] is True and stats["flush_depth"] == depth
        for key in ("stage_s", "sweep_s", "flush_run_s", "flush_wait_s", "prepass_s"):
            assert stats[key] >= 0.0, key
        assert stats["flush_run_s"] > 0.0
    assert runs[1][1] == runs[3][1]
    _assert_factors_equal(runs[3][0], runs[1][0])


def test_stream_release_params_equals_keep():
    """release_params gives the same factors, pops exactly the replaced
    dense leaves, and surgery on the released tree builds the same model."""
    spec, params, _, _ = _model(_llama_kw(), seed=0)
    params_rel = {**params, "layers": [dict(lp) for lp in params["layers"]]}
    f_keep, _, keep = stream_calibrate_solve(spec, params, _batches(), _config(layers_per_step=1))
    f_rel, _, keep_r = stream_calibrate_solve(
        spec, params_rel, _batches(), _config(layers_per_step=1), release_params=True
    )
    np.testing.assert_array_equal(keep, keep_r)
    _assert_factors_equal(f_rel, f_keep)
    for l in range(spec.n_layers):
        assert not set(KERNELS) & set(params_rel["layers"][l]), l
        assert set(KERNELS) <= set(params["layers"][l])
    cs_keep, cp_keep = apply_factors(spec, params, f_keep["mlp"], f_keep["qk"], f_keep["vo"])
    cs_rel, cp_rel = apply_factors(spec, params_rel, f_rel["mlp"], f_rel["qk"], f_rel["vo"], release_dense=True)
    assert cs_keep == cs_rel
    for l in range(spec.n_layers):
        for key in KERNELS:
            torch.testing.assert_close(cp_rel["layers"][l][key]["kernel"], cp_keep["layers"][l][key]["kernel"],
                                       rtol=0, atol=0)


@pytest.mark.parametrize("kw", [_llama_kw(), MIXED_KW], ids=["llama", "mixed"])
def test_stream_fetch_device_equals_host(kw):
    """stream_fetch="device" keeps the kernel factors as tensors and
    equals the host fetch value for value; selection metadata is numpy
    on both."""
    spec, params, _, _ = _model(kw, seed=3)
    f_host, _, _ = stream_calibrate_solve(spec, params, _batches(), _config(layers_per_step=1))
    f_dev, _, _ = stream_calibrate_solve(
        spec, params, _batches(), _config(layers_per_step=1, stream_fetch="device")
    )
    for s in f_host:
        for l in f_host[s]:
            for k, v in f_host[s][l].items():
                d = f_dev[s][l][k]
                assert isinstance(d, torch.Tensor) == (k in KERNELS), (s, l, k)
                np.testing.assert_array_equal(_np(d), _np(v), err_msg=f"{s}[{l}][{k}]")


def test_stream_fetch_device_refused_for_host_staged(staged):
    spec, params, _, _ = _model(_llama_kw())
    with pytest.raises(ValueError, match="device-resident"):
        stream_calibrate_solve(
            spec, params, _batches(), _config(stream_fetch="device"), keep_ratios=np.full(spec.n_layers, 0.7)
        )


def test_compress_in_memory_equals_streamed_surgery_and_jax():
    """compress_in_memory builds the model the explicit sweep + surgery
    builds, leaves the caller's tree whole, runs a forward, and gives
    the JAX compress_in_memory's ranks and logits."""
    spec, params, j_spec, host = _model(_llama_kw(), seed=0)
    config = _config(layers_per_step=1)
    f_ref, _, _ = stream_calibrate_solve(spec, params, _batches(), config)
    cs_ref, cp_ref = apply_factors(spec, params, f_ref["mlp"], f_ref["qk"], f_ref["vo"])
    cs, cp = compress_in_memory(spec, params, config)
    assert cs == cs_ref
    for l in range(spec.n_layers):
        assert set(KERNELS) <= set(params["layers"][l])
        for key in KERNELS:
            torch.testing.assert_close(cp["layers"][l][key]["kernel"], cp_ref["layers"][l][key]["kernel"],
                                       rtol=0, atol=0)
    tokens = np.asarray(_batches()[0][:1, :16], dtype=np.int64)
    logits, _ = forward(cs, cp, torch.as_tensor(tokens))
    assert logits.shape == (1, 16, spec.vocab_size) and bool(torch.isfinite(logits).all())

    j_cs, j_cp = j_compress_in_memory(j_spec, host, _config(JConfig, layers_per_step=1))
    assert list(cs.gate_ranks) == list(j_cs.gate_ranks) and list(cs.q_ranks) == list(j_cs.q_ranks)
    from modegpt_tpu.models.forward import forward as j_forward

    j_logits, _ = j_forward(j_cs, j_cp, jnp.asarray(tokens.astype(np.int32)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=2e-3, atol=2e-4)


# ---- staging ------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_quantized_staging_codes_equal_jax(dtype):
    """The prepass's staged codes and scales equal the JAX package's
    numpy quantiser's bit for bit, odd widths included, and dequantise
    to JAX's values."""
    rng = np.random.default_rng(0)
    lp = {
        "up": {"kernel": rng.standard_normal((64, 97)).astype(np.float32)},
        "down": {"kernel": (rng.standard_normal((97, 64)) * 0.02).astype(np.float32)},
        "norm": {"scale": np.ones(64, np.float32)},
        "small": {"kernel": rng.standard_normal((8, 8)).astype(np.float32)},
    }
    j_tree, j_kinds, j_payload = j_offload._quantize_host_tree(lp, dtype)
    kinds, payload = offload._quantize_host_tree(params_from_numpy(lp, device="cpu"), dtype)
    j_leaves = iter(j_payload)
    for path in (("down", "kernel"), ("norm", "scale"), ("small", "kernel"), ("up", "kernel")):
        if kinds[path][0] == "raw":
            np.testing.assert_array_equal(_np(payload[path[0]][path[1]]), next(j_leaves))
            continue
        np.testing.assert_array_equal(payload[path[0]][path[1]]["q"].numpy(), next(j_leaves))
        np.testing.assert_array_equal(payload[path[0]][path[1]]["scale"].numpy(), next(j_leaves))
    assert kinds[("norm", "scale")] == ("raw",) and kinds[("small", "kernel")] == ("raw",)
    want = j_offload._dequant_staged(j_tree, j_kinds, tuple(jnp.asarray(p) for p in j_payload))
    got = offload._dequant_staged(kinds, payload)
    for name in ("up", "down"):
        np.testing.assert_array_equal(got[name]["kernel"].numpy(), np.asarray(want[name]["kernel"]))


def test_bi_stage_dtype_allocation_deviation():
    """Quantised prepass staging reproduces the exact prepass's
    allocation within a few rank units and shrinks the staged bytes
    (JAX test_bi_stage_dtype_allocation_deviation's bounds), and each
    dtype's BI equals the JAX prepass's at that dtype."""
    spec, params, j_spec, host = _model(_llama_kw(n_layers=4), seed=11)
    runs = {}
    for dtype in ("bf16", "int8", "int4"):
        stats = {}
        bi = stream_bi_sweep(spec, params, _batches(), stats_out=stats, stage_dtype=dtype, device="cpu")
        runs[dtype] = (np.asarray(bi), stats["staged_bytes"])
        j_bi = j_offload.stream_bi_sweep(j_spec, host, _batches(), stage_dtype=dtype)
        np.testing.assert_allclose(bi, j_bi, rtol=1e-4, err_msg=dtype)
    bi_ref, bytes_ref = runs["bf16"]
    for dtype, max_rel in (("int8", 0.05), ("int4", 0.25)):
        bi_q, bytes_q = runs[dtype]
        np.testing.assert_allclose(bi_q, bi_ref, rtol=max_rel, atol=max_rel * float(np.abs(bi_ref).mean()))
        keep_ref, _ = allocate_keep_ratios(bi_ref.tolist(), 0.3, 0.5, 0.8)
        keep_q, _ = allocate_keep_ratios(bi_q.tolist(), 0.3, 0.5, 0.8)
        for l in range(spec.n_layers):
            r_ref = compress_ranks_for_layer(spec, keep_ref[l], "mlp")
            r_q = compress_ranks_for_layer(spec, keep_q[l], "mlp")
            assert abs(r_ref - r_q) <= max(4, int(0.02 * spec.d_int)), (dtype, l, r_ref, r_q)
        # the payload shrinks (JAX's bounds; the per-row scales and the raw
        # embedding keep it from the full 4x / 8x at these widths)
        assert bytes_ref / bytes_q > (1.6 if dtype == "int8" else 2.6), (dtype, bytes_ref / bytes_q)


def test_bi_stage_dtype_auto_resolution(staged):
    """"auto" stages quantised (adaptive) only when the prepass copies
    weights to a card; resident sweeps stay exact. A forced int8 is
    honoured and still solves every layer."""
    spec, params, _, _ = _model(_llama_kw(), seed=12)
    stats = {}
    stream_calibrate_solve(spec, params, _batches(), _config(layers_per_step=1, bi_stage_dtype="auto"),
                           stats_out=stats)
    assert stats["bi_stage_dtype"] in ("bf16", "int8", "int4") and "bi_stage_probe_s" in stats
    offload_host = offload._host_staged
    assert offload_host(params, torch.device("cpu")) is True  # the fixture's patch
    stats8 = {}
    f, bi, _ = stream_calibrate_solve(
        spec, params, _batches(), _config(layers_per_step=1, bi_stage_dtype="int8"), stats_out=stats8
    )
    assert stats8["bi_stage_dtype"] == "int8" and "bi_stage_probe_s" not in stats8
    assert sorted(f["mlp"]) == [0, 1, 2] and all(np.isfinite(bi))


def test_bi_stage_dtype_auto_stays_exact_when_resident():
    spec, params, _, _ = _model(_llama_kw(), seed=12)
    stats = {}
    stream_calibrate_solve(spec, params, _batches(), _config(layers_per_step=1, bi_stage_dtype="auto"),
                           stats_out=stats)
    assert stats["bi_stage_dtype"] == "bf16" and "bi_stage_probe_s" not in stats


@pytest.mark.parametrize("winner", ["int4", "bf16"])
def test_adaptive_probe(monkeypatch, winner):
    """The adaptive probe commits to the cheapest staging it timed: int4
    when int8 beats raw and int4 beats int8 (the int4 arm probed), raw
    when raw beats int8 (no int4 arm)."""
    import time as _t

    spec, params, _, _ = _model(_llama_kw(n_layers=4), seed=13)
    ref = stream_bi_sweep(spec, params, _batches(), device="cpu")
    orig_call, orig_q = offload._PinnedStager.__call__, offload._stage_quantized

    def slow_raw(self, tree):
        _t.sleep(0.6 if winner == "int4" else 0.0)
        return orig_call(self, tree)

    def q_stage(lp, dtype, stager, stats=None):
        _t.sleep({"int4": {"int8": 0.3, "int4": 0.05}, "bf16": {"int8": 0.6, "int4": 0.6}}[winner][dtype])
        offload._PinnedStager.__call__ = orig_call  # the codes' own copy is not the raw staging
        try:
            return orig_q(lp, dtype, stager, stats)
        finally:
            offload._PinnedStager.__call__ = slow_raw

    monkeypatch.setattr(offload._PinnedStager, "__call__", slow_raw)
    monkeypatch.setattr(offload, "_stage_quantized", q_stage)
    stats = {}
    bi = stream_bi_sweep(spec, params, _batches(), stats_out=stats, stage_dtype="int8", adaptive=True, device="cpu")
    assert stats["bi_stage_dtype"] == winner
    assert ("quantized_int4" in stats["bi_stage_probe_s"]) == (winner == "int4")
    r, g = np.asarray(ref), np.asarray(bi)
    assert np.all(np.abs(g - r) / (np.abs(r) + 1e-9) < 0.2)


def test_slim_window_lp():
    """A host-staged dense window beyond the low-memory threshold keeps
    only down/v/o for its solve; small, MoE or resident ones keep all."""
    import dataclasses

    big = 20_000  # gate_ranks^2 * 4 > 4e8
    spec = ModelSpec(**_llama_kw())
    big_spec = dataclasses.replace(spec, gate_ranks=(big,) * 3)
    lp = {k: object() for k in ("q", "k", "v", "o", "up", "gate", "down", "attn_norm")}
    assert set(offload._slim_window_lp(big_spec, 0, lp, True, CompressionConfig())) == {"down", "v", "o"}
    assert offload._slim_window_lp(big_spec, 0, lp, False, CompressionConfig()) is lp
    assert offload._slim_window_lp(spec, 0, lp, True, CompressionConfig()) is lp
    assert offload._slim_window_lp(ModelSpec(**MIXED_KW), 1, lp, True, CompressionConfig()) is lp


# ---- flush policy and out-of-memory retries -----------------------------


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("overlap", [False, True])
def test_flush_estimate_and_fit_equal_jax(depth, overlap):
    """`_flush_hbm_estimate` and `_async_flush_fits` give the JAX
    package's numbers and decisions (its 0.85 / 0.75 margins)."""
    kw = _llama_kw(n_layers=4, d_model=5120, d_int=25600)
    spec, j_spec = ModelSpec(**kw), JSpec(**kw)
    for layer_bytes, stack_bytes, width in ((1_950_000_000, 335_000_000, 1), (10_000, 1_000, 2)):
        est = offload._flush_hbm_estimate(spec, layer_bytes, stack_bytes, width, overlap=overlap, depth=depth)
        assert est == j_offload._flush_hbm_estimate(
            j_spec, layer_bytes, stack_bytes, width, overlap=overlap, depth=depth
        )
        for hbm in (None, 80 * 2**30, 16 * 2**30, int(est / 0.80), est):
            assert offload._async_flush_fits(spec, layer_bytes, stack_bytes, width, hbm, depth) == (
                j_offload._async_flush_fits(j_spec, layer_bytes, stack_bytes, width, hbm, depth)
            ), (hbm, depth)


def test_async_flush_memory_gate(staged, monkeypatch):
    """"auto" goes async for a host-staged sweep when the estimate fits,
    stays synchronous when the card is too small, and "on" bypasses the
    gate; the factors are the same every way."""
    spec, params, _, _ = _model(_llama_kw(n_layers=4), seed=3)
    runs = {}
    for name, flag, hbm in (("fits", "auto", None), ("tight", "auto", 1), ("on", "on", 1)):
        monkeypatch.setattr(offload, "_device_hbm_bytes", lambda hbm=hbm: hbm)
        stats = {}
        runs[name] = stream_calibrate_solve(
            spec, params, _batches(), _config(layers_per_step=1, stream_async_flush=flag), stats_out=stats
        )
        assert stats["async_flush"] is (name != "tight"), name
    for name in ("tight", "on"):
        assert runs[name][1] == runs["fits"][1]
        _assert_factors_equal(runs[name][0], runs["fits"][0])


def _flaky_solve(monkeypatch, fail_at):
    orig = batched_mod.solve_chunk_batched
    state = {"calls": 0}

    def flaky(*args, **kwargs):
        state["calls"] += 1
        if state["calls"] == fail_at:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return orig(*args, **kwargs)

    monkeypatch.setattr(batched_mod, "solve_chunk_batched", flaky)
    return state


@pytest.mark.parametrize("flag", ["on", "off"])
def test_flush_out_of_memory_retries_once(monkeypatch, flag):
    """A window flush that runs out of device memory is retried once
    (after empty_cache), counted in stats_out; an async one first drains
    and turns async off. The factors equal a clean run's."""
    spec, params, _, _ = _model(_llama_kw(n_layers=4), seed=5)
    config = _config(layers_per_step=1, stream_async_flush=flag)
    ref = stream_calibrate_solve(spec, params, _batches(), config)
    state = _flaky_solve(monkeypatch, fail_at=2)
    stats = {}
    got = stream_calibrate_solve(spec, params, _batches(), config, stats_out=stats)
    assert state["calls"] == 5  # 4 windows of one layer + the failed attempt
    assert stats["oom_retries"] == 1 and stats["async_flush"] is False
    assert got[1] == ref[1]
    _assert_factors_equal(got[0], ref[0])


def test_flush_out_of_memory_twice_raises(monkeypatch):
    spec, params, _, _ = _model(_llama_kw(), seed=5)

    def oom(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")

    monkeypatch.setattr(batched_mod, "solve_chunk_batched", oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        stream_calibrate_solve(spec, params, _batches(), _config(layers_per_step=1, stream_async_flush="off"))


@pytest.mark.parametrize("every", [1, 8])
def test_stream_checkpoint_every_raises(every):
    """The JAX drop recovery is not ported: an explicit interval raises,
    naming why; 0 (auto) and -1 run."""
    spec, params, _, _ = _model(_llama_kw())
    with pytest.raises(NotImplementedError, match="CUDA error leaves"):
        stream_calibrate_solve(spec, params, _batches(), _config(stream_checkpoint_every=every))
    with pytest.raises(NotImplementedError, match="stream_checkpoint_every"):
        stream_bi_sweep(spec, params, _batches(), config=_config(stream_checkpoint_every=every))
    for ok in (0, -1):
        offload._checkpoint_every(_config(stream_checkpoint_every=ok))


# ---- solve_chunk_batched fetch modes --------------------------------------


@pytest.mark.parametrize("kw", [_llama_kw(), MIXED_KW], ids=["llama", "mixed"])
def test_host_sliced_factors_bit_equal(kw):
    """host_params gathers up/gate/q/k from the host tree: bit-identical
    to the device's slices, and those bytes no longer count as fetched."""
    spec, params, _, _ = _model(kw, seed=13)
    layers = list(range(spec.n_layers))
    calib = calibrate(spec, params, _batches(), layers, accumulate="device")
    keep, _ = allocate_keep_ratios(calib.bi_scores, 0.3, 0.5, 0.8)
    b0 = batched_mod.FETCHED_BYTES.total
    ref = solve_chunk_batched(spec, params, layers, keep, calib, _config(), "mlp,qk,vo")
    fetched_ref = batched_mod.FETCHED_BYTES.total - b0
    host_view = {l: {k: v for k, v in params["layers"][l].items()} for l in layers}
    slim = {"layers": [{k: v for k, v in lp.items() if k not in ("up", "gate", "q", "k") or spec.is_moe_layer(l)}
                       for l, lp in enumerate(params["layers"])]}
    b1 = batched_mod.FETCHED_BYTES.total
    got = solve_chunk_batched(spec, slim, layers, keep, calib, _config(), "mlp,qk,vo", host_params=host_view)
    fetched_host = batched_mod.FETCHED_BYTES.total - b1
    _assert_factors_equal(got, ref)
    assert fetched_host < 0.6 * fetched_ref, (fetched_host, fetched_ref)


def test_scratch_params_pops_solved_leaves():
    spec, params, _, _ = _model(_llama_kw(), seed=13)
    calib = calibrate(spec, params, _batches(), [0, 1, 2], accumulate="device")
    keep, _ = allocate_keep_ratios(calib.bi_scores, 0.3, 0.5, 0.8)
    scratch = {"layers": [dict(lp) for lp in params["layers"]]}
    got = solve_chunk_batched(spec, scratch, [0, 2], keep, calib, _config(), "mlp,qk,vo", scratch_params=True)
    ref = solve_chunk_batched(spec, params, [0, 2], keep, calib, _config(), "mlp,qk,vo")
    _assert_factors_equal(got, ref)
    assert not set(KERNELS) & set(scratch["layers"][0]) and not set(KERNELS) & set(scratch["layers"][2])
    assert set(KERNELS) <= set(scratch["layers"][1]) and set(KERNELS) <= set(params["layers"][0])


# ---- the windowed calibration ----------------------------------------------


@pytest.mark.parametrize("kw,start,width", [
    (_llama_kw(), 1, 2), (_llama_kw(), 2, 2), (MIXED_KW, 0, 3), (MIXED_KW, 1, 1),
    (dict(MIXED_KW, moe_layers=(), gate_ranks=(48,) * 3), 0, 2),
], ids=["dense", "dense_tail", "mixed", "mixed_moe_layer", "moe"])
def test_calibrate_window_matches_jax_and_calibrate(kw, start, width):
    spec, params, j_spec, host = _model(kw, seed=6)
    batches = _batches()
    got = calibrate_window(spec, params, batches, start, width)
    layers = [l for l in range(start, start + width) if l < spec.n_layers]
    ref = calibrate(spec, params, batches, layers, accumulate="device")
    want = j_calibrate_window(j_spec, jax.tree_util.tree_map(jnp.asarray, host), batches, start, width)
    assert got.bi_scores == ref.bi_scores
    np.testing.assert_allclose(got.bi_scores, want.bi_scores, rtol=1e-4)
    assert (got.n_sequences, got.total_tokens) == (want.n_sequences, want.total_tokens)
    for field in ("cov_mlp", "cov_q", "cov_k", "cov_x", "cov_shared"):
        g, r, w = getattr(got, field), getattr(ref, field), getattr(want, field) or {}
        assert sorted(g) == sorted(r) == sorted(w), field
        for l in g:
            assert g[l].dtype == torch.float32
            torch.testing.assert_close(g[l], r[l], rtol=0, atol=0)
            np.testing.assert_allclose(g[l].numpy(), np.asarray(w[l]), rtol=1e-4, atol=1e-6, err_msg=field)


@pytest.mark.parametrize("change,match", [
    (dict(q_ranks=(64, 32, 64)), "uniform attention ranks"),
    (dict(gate_ranks=(144, 100, 144)), "uniform dense MLP widths"),
])
def test_calibrate_window_refuses_ragged_stacks(change, match):
    spec = ModelSpec(**dict(_llama_kw(), **change))
    with pytest.raises(ValueError, match=match):
        calibrate_window(spec, {"layers": []}, _batches(), 0, 1)
    with pytest.raises(ValueError, match=match):
        j_calibrate_window(JSpec(**dict(_llama_kw(), **change)), {"layers": []}, _batches(), 0, 1)


# ---- the pipeline ------------------------------------------------------------


def _tiny_llama():
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=144, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        tie_word_embeddings=False,
    )
    torch.manual_seed(7)
    return transformers.LlamaForCausalLM(cfg).eval()


def _job_config(cls, tmp, **kw):
    kw.setdefault("layers_per_step", 2)
    kw.setdefault("eval_max_samples", 4)
    if cls is CompressionConfig:
        kw.setdefault("device", "cpu")
        kw.setdefault("bi_stage_dtype", "bf16")
    return cls(
        model=kw.pop("model", "mem"), dataset="synthetic", calib_size=4, calibs_batch_size=2,
        seq_len=32, compression_ratio=0.3, sparsity_smoothing=0.5, solver_precision="f32_device",
        eval_batch_size=2,
        output_dir=str(tmp / "o"), temp_storage_dir=str(tmp / "l"), metrics_dir=str(tmp / "m"), **kw,
    )


@pytest.mark.parametrize("calib_exec", ["stream", "window"])
def test_run_compression_stream_and_window_match_chunked_and_jax(tmp_path, calib_exec):
    """``calib_exec`` stream and window through run_compression: the
    chunked job's compressed kernels, and JAX's job's ranks and
    perplexities (the existing pipeline test's tolerance)."""
    from modegpt_tpu.models import params_from_hf_model as j_params_from_hf

    from modegpt_tpu_torch.models.hf import params_from_hf_model

    model = _tiny_llama()
    spec, params = params_from_hf_model(model, device="cpu")
    ref = run_compression(_job_config(CompressionConfig, tmp_path / "ref"), spec=spec, params=params)
    got = run_compression(
        _job_config(CompressionConfig, tmp_path / calib_exec, calib_exec=calib_exec), spec=spec, params=params
    )
    assert got["compressed_spec"] == ref["compressed_spec"]
    for l in range(spec.n_layers):
        for key in KERNELS:
            torch.testing.assert_close(
                got["compressed_params"]["layers"][l][key]["kernel"],
                ref["compressed_params"]["layers"][l][key]["kernel"], rtol=0, atol=0,
            )
    assert got["compressed_ppl"] == ref["compressed_ppl"]
    if calib_exec == "stream":
        assert got["stream_stats"]["async_flush"] is False  # resident: "auto" stays synchronous
    j_spec, j_params = j_params_from_hf(model)
    want = j_run(_job_config(JConfig, tmp_path / ("j" + calib_exec), calib_exec=calib_exec), spec=j_spec,
                 params=j_params)
    cs, js = got["compressed_spec"], want["compressed_spec"]
    assert (list(cs.gate_ranks), list(cs.q_ranks), list(cs.v_ranks)) == (
        list(js.gate_ranks), list(js.q_ranks), list(js.v_ranks))
    np.testing.assert_allclose(got["baseline_ppl"], want["baseline_ppl"], rtol=1e-5)
    np.testing.assert_allclose(got["compressed_ppl"], want["compressed_ppl"], rtol=1e-3)


def test_run_compression_stream_host_staged_from_disk(tmp_path, staged):
    """A model loaded from disk under calib_exec="stream" stays on the
    CPU and is host-staged: the baseline evaluates from a device copy,
    surgery and the artifact are on the CPU, and the result equals the
    resident stream job's and JAX's host-resident job's ranks."""
    from modegpt_tpu.models import params_from_hf_model as j_params_from_hf

    from modegpt_tpu_torch.models import hf as hf_mod

    model = _tiny_llama()
    ckpt = tmp_path / "ckpt"
    model.save_pretrained(ckpt, safe_serialization=True)
    loaded = {}
    orig = hf_mod.load_hf_model

    def spy(path, dtype=torch.float32, device="cuda"):
        out = orig(path, dtype=dtype, device=device)
        loaded.update(device=device, params=out[1])
        return out

    hf_mod.load_hf_model = spy
    try:
        got = run_compression(_job_config(CompressionConfig, tmp_path / "a", calib_exec="stream",
                                          layers_per_step=1, model=str(ckpt)))
    finally:
        hf_mod.load_hf_model = orig
    assert loaded["device"] == "cpu"
    assert all(t.device.type == "cpu" for lp in loaded["params"]["layers"] for t in offload._leaves(lp))
    assert got["stream_stats"]["staged_bytes"] > 0

    spec, params = hf_mod.params_from_hf_model(model, device="cpu")
    ref = run_compression(_job_config(CompressionConfig, tmp_path / "b", layers_per_step=1), spec=spec,
                          params=params)
    assert got["compressed_spec"] == ref["compressed_spec"]
    np.testing.assert_allclose(got["baseline_ppl"], ref["baseline_ppl"], rtol=1e-6)
    np.testing.assert_allclose(got["compressed_ppl"], ref["compressed_ppl"], rtol=1e-6)
    j_spec, j_params = j_params_from_hf(model)
    want = j_run(_job_config(JConfig, tmp_path / "j", calib_exec="stream", layers_per_step=1), spec=j_spec,
                 params=j_params)
    assert list(got["compressed_spec"].gate_ranks) == list(want["compressed_spec"].gate_ranks)
    np.testing.assert_allclose(got["compressed_ppl"], want["compressed_ppl"], rtol=1e-3)


def test_device_memory_stats_without_a_card():
    assert device_memory_stats() == {}
    assert offload._device_hbm_bytes() is None

