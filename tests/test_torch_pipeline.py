"""Parity of the port's compression job with the JAX package's, on the CPU.

* `calibrate` in both accumulation modes against JAX's;
* artifacts written by either package load in the other;
* `run_compression` end to end on a tiny Llama and a tiny OPT
  (``dataset="synthetic"``, float64 solves): identical rank lists, MLP
  indices and rotary masks, baseline perplexity to rtol 1e-5 and
  compressed perplexity to rtol 1e-3;
* import hygiene: the port never imports jax or modegpt_tpu;
* asking for CUDA without it raises.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from modegpt_tpu.calib.data import load_calibration_batches  # noqa: E402
from modegpt_tpu.calib.engine import calibrate as j_calibrate  # noqa: E402
from modegpt_tpu.compress import artifact as j_artifact  # noqa: E402
from modegpt_tpu.compress.pipeline import run_compression as j_run  # noqa: E402
from modegpt_tpu.config import CompressionConfig as JConfig  # noqa: E402
from modegpt_tpu.models import params_from_hf_model as j_params_from_hf  # noqa: E402
from modegpt_tpu_torch.calib.engine import calibrate as t_calibrate  # noqa: E402
from modegpt_tpu_torch.compress import artifact as t_artifact  # noqa: E402
from modegpt_tpu_torch.compress.pipeline import run_compression as t_run  # noqa: E402
from modegpt_tpu_torch.config import CompressionConfig as TConfig  # noqa: E402
from modegpt_tpu_torch.models.hf import params_from_hf_model as t_params_from_hf  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "modegpt_tpu_torch")


def _tiny_llama():
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=176, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
        tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(cfg).eval()


def _tiny_opt():
    cfg = transformers.OPTConfig(
        vocab_size=256, hidden_size=48, ffn_dim=128, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=256, word_embed_proj_dim=48,
    )
    torch.manual_seed(0)
    return transformers.OPTForCausalLM(cfg).eval()


@pytest.mark.parametrize("accumulate", ["host", "device"])
def test_calibrate_matches_jax(accumulate):
    model = _tiny_llama()
    j_spec, j_params = j_params_from_hf(model)
    t_spec, t_params = t_params_from_hf(model, device="cpu")
    batches = load_calibration_batches(None, "synthetic", 6, 4, 64, vocab_size=256)  # ragged last batch
    want = j_calibrate(j_spec, j_params, batches, [0, 1], accumulate=accumulate)
    got = t_calibrate(t_spec, t_params, batches, [0, 1], accumulate=accumulate)
    assert (got.n_sequences, got.total_tokens) == (want.n_sequences, want.total_tokens)
    np.testing.assert_allclose(got.bi_scores, want.bi_scores, rtol=1e-4, atol=1e-6)
    want_dtype = torch.float64 if accumulate == "host" else torch.float32
    for field in ("cov_mlp", "cov_q", "cov_k", "cov_x"):
        for l in (0, 1):
            g = getattr(got, field)[l]
            assert g.dtype == want_dtype
            np.testing.assert_allclose(
                g.numpy(), np.asarray(getattr(want, field)[l]), rtol=1e-4, atol=1e-6, err_msg=field
            )


def _compressed_tree(tmp_path):
    """Run the port's job once; returns its artifact directory."""
    model = _tiny_llama()
    spec, params = t_params_from_hf(model, device="cpu")
    cfg = _config(TConfig, tmp_path / "port", device="cpu", compression_ratio=0.4)
    return t_run(cfg, spec=spec, params=params)["artifact_dir"]


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_artifact_cross_load(tmp_path, storage):
    src = _compressed_tree(tmp_path)
    spec, params, _ = t_artifact.load_compressed_model(src, device="cpu")
    # port -> JAX
    port_dir = str(tmp_path / f"port_{storage}")
    t_artifact.save_compressed_model(port_dir, spec, params, "tok", {"m": 1}, dtype=storage)
    j_spec, j_params, tok = j_artifact.load_compressed_model(port_dir)
    assert tok == "tok" and j_spec.to_dict() == spec.to_dict()
    # JAX -> port
    jax_dir = str(tmp_path / f"jax_{storage}")
    j_artifact.save_compressed_model(jax_dir, j_spec, j_params, "tok", {"m": 1}, dtype=storage)
    spec2, params2, _ = t_artifact.load_compressed_model(jax_dir, device="cpu")
    assert spec2 == spec
    for name in ("params.npz", "spec.json"):
        assert os.path.getsize(os.path.join(port_dir, name)) == os.path.getsize(os.path.join(jax_dir, name))
    with np.load(os.path.join(port_dir, "params.npz")) as a, np.load(os.path.join(jax_dir, "params.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    want_dtype = torch.bfloat16 if storage == "bfloat16" else torch.float32
    assert params2["layers"][0]["q"]["kernel"].dtype == want_dtype
    assert params2["layers"][0]["rotary_mask"].dtype == torch.int32


def _config(cls, root, **kw):
    defaults = dict(
        model="in-memory", dataset="synthetic", calib_size=8, calibs_batch_size=4, seq_len=64,
        eval_batch_size=4, eval_max_samples=8, compression_ratio=0.3, sparsity_smoothing=0.5,
        max_sparsity=0.8, output_dir=str(root / "out"), temp_storage_dir=str(root / "layers"),
        metrics_dir=str(root / "metrics"),
    )
    defaults.update(kw)
    return cls(**defaults)


@pytest.mark.parametrize("make_model", [_tiny_llama, _tiny_opt], ids=["llama", "opt"])
def test_end_to_end_matches_jax(tmp_path, make_model):
    model = make_model()
    j_spec, j_params = j_params_from_hf(model)
    t_spec, t_params = t_params_from_hf(model, device="cpu")
    want = j_run(_config(JConfig, tmp_path / "jax"), spec=j_spec, params=j_params)
    got = t_run(_config(TConfig, tmp_path / "port", device="cpu"), spec=t_spec, params=t_params)

    ws, gs = want["compressed_spec"], got["compressed_spec"]
    for ranks in ("q_ranks", "k_ranks", "v_ranks", "o_ranks", "gate_ranks"):
        assert getattr(gs, ranks) == getattr(ws, ranks), ranks
    assert sum(gs.gate_ranks) < sum(t_spec.gate_ranks)
    for l in range(t_spec.n_layers):
        jm = j_artifact.load_layer_factors(str(tmp_path / "jax" / "layers"), l, "mlp")
        tm = t_artifact.load_layer_factors(str(tmp_path / "port" / "layers"), l, "mlp")
        np.testing.assert_array_equal(tm["idx"], jm["idx"])
        if t_spec.uses_rope:
            jq = j_artifact.load_layer_factors(str(tmp_path / "jax" / "layers"), l, "qk")
            tq = t_artifact.load_layer_factors(str(tmp_path / "port" / "layers"), l, "qk")
            np.testing.assert_array_equal(tq["rotary_mask"], jq["rotary_mask"])
            np.testing.assert_array_equal(
                got["compressed_params"]["layers"][l]["rotary_mask"].numpy(),
                np.asarray(want["compressed_params"]["layers"][l]["rotary_mask"]),
            )
    np.testing.assert_allclose(got["baseline_ppl"], want["baseline_ppl"], rtol=1e-5)
    np.testing.assert_allclose(got["compressed_ppl"], want["compressed_ppl"], rtol=1e-3)
    assert set(got["step_seconds"]) >= {"baseline_eval", "calibrate", "solve", "compressed_eval"}


def test_f32_device_solver_runs_on_the_model_device(tmp_path):
    """solver_precision=f32_device: device accumulation and float32
    solves (Cholesky whitening) give the f64 path's ranks and a
    perplexity within 1e-3 of it."""
    model = _tiny_llama()
    t_spec, t_params = t_params_from_hf(model, device="cpu")
    ref = t_run(_config(TConfig, tmp_path / "f64", device="cpu"), spec=t_spec, params=t_params)
    f32 = t_run(
        _config(TConfig, tmp_path / "f32", device="cpu", solver_precision="f32_device"),
        spec=t_spec, params=t_params,
    )
    assert f32["compressed_spec"] == ref["compressed_spec"]
    np.testing.assert_allclose(f32["compressed_ppl"], ref["compressed_ppl"], rtol=1e-3)


@pytest.mark.parametrize(
    "knob",
    [dict(fused=True), dict(calib_exec="window"), dict(calib_exec="stream"), dict(mesh_shape="data:2"),
     dict(compressed_exec="padded"), dict(qk_method="svd"), dict(artifact_dtype="int8"),
     dict(artifact_backend="orbax")],
    ids=lambda k: next(iter(k)),
)
def test_unported_paths_raise(tmp_path, knob):
    spec, params = t_params_from_hf(_tiny_llama(), device="cpu")
    with pytest.raises(NotImplementedError, match="modegpt_tpu_torch"):
        t_run(_config(TConfig, tmp_path, device="cpu", **knob), spec=spec, params=params)


def _port_imports():
    found = []
    for root, _, files in os.walk(PORT):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    found += [(path, a.name) for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    found.append((path, node.module))
    return found


def test_import_hygiene():
    imports = _port_imports()
    assert imports, "no imports found: wrong package path?"
    bad = [
        (p, m) for p, m in imports
        if m.split(".")[0] in ("jax", "jaxlib", "flax") or m.split(".")[0] == "modegpt_tpu"
    ]
    assert not bad, bad
    for script in ("chip_smoke.py",):
        with open(os.path.join(REPO, script)) as f:
            tree = ast.parse(f.read())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        assert not [m for m in mods if m.split(".")[0] in ("jax", "modegpt_tpu")], script
    code = (
        "import sys, modegpt_tpu_torch.cli, modegpt_tpu_torch.compress.pipeline; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'modegpt_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONSTARTUP")}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_cuda_requested_without_cuda_raises(monkeypatch, tmp_path):
    from modegpt_tpu_torch.utils.device import parse_device, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in ("cuda", "cuda:0", 0, "1"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(dev)
    assert resolve_device("cpu") == torch.device("cpu")
    assert parse_device(3) == torch.device("cuda", 3) == parse_device("3")
    assert TConfig().device == "cuda"
    spec, params = t_params_from_hf(_tiny_llama(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_run(_config(TConfig, tmp_path), spec=spec, params=params)
    with pytest.raises(ValueError):
        TConfig(device="tpu").validate()


def test_cli_takes_the_jax_flags(tmp_path):
    """`python -m modegpt_tpu_torch.cli` with the JAX CLI's flags on a
    tiny checkpoint saved offline; the rank lists match the JAX CLI's."""
    import json

    from modegpt_tpu.cli import main as j_main
    from modegpt_tpu_torch.cli import main as t_main

    ckpt = tmp_path / "tiny-llama"
    _tiny_llama().save_pretrained(ckpt)

    def flags(root):
        return [
            "--model", str(ckpt), "--compression_ratio", "0.3", "--calib_size", "4",
            "--calibs_batch_size", "2", "--seq_len", "48", "--eval_batch_size", "4",
            "--eval_max_samples", "4", "--dataset", "synthetic", "--sparsity_smoothing", "0.5",
            "--output_dir", str(root / "o"), "--temp_storage_dir", str(root / "l"),
            "--metrics_dir", str(root / "m"),
        ]

    got = t_main(flags(tmp_path / "port") + ["--device", "cpu"])
    want = j_main(flags(tmp_path / "jax"))
    assert got["compressed_spec"].gate_ranks == want["compressed_spec"].gate_ranks
    assert got["compressed_spec"].q_ranks == want["compressed_spec"].q_ranks
    np.testing.assert_allclose(got["compressed_ppl"], want["compressed_ppl"], rtol=1e-3)
    reg = json.load(open(tmp_path / "port" / "m" / "metrics.json"))
    run = list(reg.values())[-1]
    assert "baseline-ppl" in run and "ppl-synthetic" in run and run["achieved_compression"] > 0
