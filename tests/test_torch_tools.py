"""The port's tooling against the JAX package's, on the CPU.

* `models.hf_export.export_to_hf`: on a compressed llama (rotary masks),
  a compressed opt and gpt2 and a dense qwen3_moe, the port's export of
  an artifact equals JAX's export of the same artifact: the same
  safetensors keys with bit-equal arrays, ``config.json`` equal but for
  ``mask_path`` (absolute, in each one's own directory), equal masks. A
  dense export reloads through ``transformers`` with the model's logits;
  a compressed one through the port's importer with the artifact's;
* `inspect_artifact`: the same JSON as JAX's, dense, compressed and MoE
  (a shared expert included), with ``--device cpu``;
* `utils.profiling`: ``profile_dir`` writes a Chrome trace of the
  calibrate + solve steps on the CPU, with the program's spans, of a
  job on the default path and of a streamed one;
* `analysis.search`: `random_search` draws JAX's trials from the same
  seed, `staged_search` scores them within rtol 1e-4 of JAX's, and
  `run_optuna_study` raises without optuna.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402
import test_torch_evals  # noqa: E402
import test_torch_moe  # noqa: E402

from modegpt_tpu.analysis import search as j_search  # noqa: E402
from modegpt_tpu.calib.engine import calibrate as j_calibrate  # noqa: E402
from modegpt_tpu.compress import artifact as j_artifact  # noqa: E402
from modegpt_tpu.config import CompressionConfig as JConfig  # noqa: E402
from modegpt_tpu.inspect_artifact import main as j_inspect  # noqa: E402
from modegpt_tpu.models import params_from_hf_model as j_params_from_hf  # noqa: E402
from modegpt_tpu.models.hf_export import export_to_hf as j_export  # noqa: E402
from modegpt_tpu.ops.vo import compress_vo_layer as j_vo  # noqa: E402
from modegpt_tpu_torch.analysis import search as t_search  # noqa: E402
from modegpt_tpu_torch.calib.data import load_calibration_batches  # noqa: E402
from modegpt_tpu_torch.calib.engine import calibrate as t_calibrate  # noqa: E402
from modegpt_tpu_torch.compress import artifact as t_artifact  # noqa: E402
from modegpt_tpu_torch.compress.pipeline import run_compression as t_run  # noqa: E402
from modegpt_tpu_torch.config import CompressionConfig as TConfig  # noqa: E402
from modegpt_tpu_torch.inspect_artifact import main as t_inspect  # noqa: E402
from modegpt_tpu_torch.models.forward import forward  # noqa: E402
from modegpt_tpu_torch.models.hf import params_from_hf_model as t_params_from_hf  # noqa: E402
from modegpt_tpu_torch.models.hf import params_from_state_dict  # noqa: E402
from modegpt_tpu_torch.models.hf_export import export_to_hf as t_export  # noqa: E402
from modegpt_tpu_torch.models.safetensors_io import read_hf_config  # noqa: E402
from modegpt_tpu_torch.models.spec import spec_from_hf_config  # noqa: E402
from modegpt_tpu_torch.ops.vo import compress_vo_layer as t_vo  # noqa: E402


def _tiny_opt():
    cfg = transformers.OPTConfig(
        vocab_size=128, hidden_size=48, ffn_dim=96, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=64, word_embed_proj_dim=48,
    )
    torch.manual_seed(0)
    return transformers.OPTForCausalLM(cfg).eval()


def _tiny_gpt2():
    cfg = transformers.GPT2Config(vocab_size=128, n_embd=48, n_layer=2, n_head=4, n_positions=64)
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(cfg).eval()


MODELS = {"llama": lambda: test_torch_evals._tiny_llama(seed=3), "opt": _tiny_opt, "gpt2": _tiny_gpt2,
          "qwen2_moe": lambda: test_torch_moe._hf("qwen2_moe_mixed"),
          "qwen3_moe": lambda: test_torch_moe._hf("qwen3_moe")}


def _job_config(root, **kw):
    return TConfig(
        model="in-memory", dataset="synthetic", calib_size=4, calibs_batch_size=2, seq_len=32,
        compression_ratio=0.3, sparsity_smoothing=0.1, device="cpu", solver_precision="f32_device",
        output_dir=str(root / "o"), temp_storage_dir=str(root / "l"), metrics_dir=str(root / "m"),
        skip_baseline_eval=True, skip_final_eval=True, **kw,
    )


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Artifacts written by the port: llama, opt and gpt2 compressed (the
    llama job traced into ``profile_dir``), qwen2_moe (a mixed stack with
    shared experts) compressed, qwen3_moe and llama dense; the llama job
    streamed, traced into another ``profile_dir``."""
    root = tmp_path_factory.mktemp("tools")
    out = {}
    for name in ("llama", "opt", "gpt2", "qwen2_moe"):
        spec, params = t_params_from_hf(MODELS[name](), device="cpu")
        kw = dict(profile_dir=str(root / "trace")) if name == "llama" else {}
        out[name] = t_run(_job_config(root / name, **kw), spec=spec, params=params)["artifact_dir"]
    spec, params = t_params_from_hf(MODELS["llama"](), device="cpu")
    t_run(_job_config(root / "llama_stream", profile_dir=str(root / "trace_stream"), calib_exec="stream"),
          spec=spec, params=params)
    for name in ("qwen3_moe", "llama"):
        spec, params = t_params_from_hf(MODELS[name](), device="cpu")
        out[name + "_dense"] = t_artifact.save_compressed_model(str(root / f"{name}_dense"), spec, params, "src")
    out["trace_dir"] = str(root / "trace")
    out["stream_trace_dir"] = str(root / "trace_stream")
    return out


def _safetensors(path):
    from safetensors.numpy import load_file

    return load_file(os.path.join(path, "model.safetensors"))


@pytest.mark.parametrize("name", ["llama", "opt", "gpt2", "qwen3_moe_dense"])
def test_export_equals_jax(artifacts, tmp_path, name):
    j_spec, j_params, _ = j_artifact.load_compressed_model(artifacts[name])
    t_spec, t_params, _ = t_artifact.load_compressed_model(artifacts[name], device="cpu")
    want_dir = j_export(j_spec, j_params, str(tmp_path / "jax"), tokenizer_source="src")
    got_dir = t_export(t_spec, t_params, str(tmp_path / "port"), tokenizer_source="src")
    want, got = _safetensors(want_dir), _safetensors(got_dir)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    cfg_w, cfg_g = (json.load(open(os.path.join(d, "config.json"))) for d in (want_dir, got_dir))
    mw, mg = cfg_w.pop("mask_path"), cfg_g.pop("mask_path")
    assert cfg_g == cfg_w
    assert (mg is None) == (mw is None) == (name != "llama")
    if mg is not None:
        assert mg == os.path.abspath(os.path.join(got_dir, "rotary_masks.pt"))
        for a, b in zip(torch.load(mg), torch.load(mw), strict=True):
            assert a.dtype == b.dtype == torch.int64
            assert torch.equal(a, b)
    for d in (want_dir, got_dir):
        assert open(os.path.join(d, "tokenizer_source.txt")).read() == "src"


@pytest.mark.parametrize("name", ["llama", "opt"])
def test_dense_export_reloads_through_transformers(tmp_path, name):
    model = MODELS[name]()
    spec, params = t_params_from_hf(model, device="cpu")
    out = t_export(spec, params, str(tmp_path / "export"))
    reloaded = type(model).from_pretrained(out).eval()
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, 128, (2, 12)))
    with torch.no_grad():
        torch.testing.assert_close(reloaded(ids).logits, model(ids).logits, rtol=1e-5, atol=1e-5)


def test_compressed_export_reloads_through_the_port(artifacts, tmp_path):
    spec, params, _ = t_artifact.load_compressed_model(artifacts["llama"], device="cpu")
    out = t_export(spec, params, str(tmp_path / "export"))
    cfg = read_hf_config(out)
    spec2 = spec_from_hf_config(cfg)
    assert spec2.q_ranks == spec.q_ranks and spec2.gate_ranks == spec.gate_ranks and spec2.has_rotary_masks
    sd = {k: torch.from_numpy(v) for k, v in _safetensors(out).items()}
    masks = dict(enumerate(torch.load(cfg.mask_path)))
    params2 = params_from_state_dict(spec2, sd, rotary_masks=masks, device="cpu")
    ids = torch.as_tensor(np.random.default_rng(1).integers(0, 128, (1, 16)))
    torch.testing.assert_close(forward(spec2, params2, ids)[0], forward(spec, params, ids)[0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["llama_dense", "llama", "qwen2_moe", "qwen3_moe_dense"])
def test_inspect_equals_jax(artifacts, capsys, name):
    assert t_inspect([artifacts[name], "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert j_inspect([artifacts[name]]) == 0
    want = json.loads(capsys.readouterr().out)
    assert got == want
    if name == "qwen2_moe":
        assert any("shared" in row for row in got["per_layer"]) and got["n_experts"] == 4


def test_inspect_defaults_to_cuda(artifacts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_inspect([artifacts["llama"]])


def _trace_events(trace_dir):
    traces = [f for f in os.listdir(trace_dir) if f.startswith("trace_") and f.endswith(".json")]
    assert len(traces) == 1
    with open(os.path.join(trace_dir, traces[0])) as f:
        return json.load(f)["traceEvents"]


def _compress_spans(events):
    return {e.get("name") for e in events if str(e.get("name", "")).startswith("modegpt.compress.")}


def test_profile_dir_writes_a_trace(artifacts):
    """The default path (no BI pre-pass): the taps and the solves."""
    events = _trace_events(artifacts["trace_dir"])
    assert any("aten::" in str(e.get("name", "")) for e in events)
    assert _compress_spans(events) == {"modegpt.compress.taps", "modegpt.compress.decompose"}


def test_profile_dir_shows_a_streamed_job_s_spans(artifacts):
    events = _trace_events(artifacts["stream_trace_dir"])
    assert _compress_spans(events) == {"modegpt.compress.bi_prepass", "modegpt.compress.taps",
                                       "modegpt.compress.decompose"}


def test_random_search_draws_jax_trials():
    def score(cfg):  # any deterministic function of the knobs
        return cfg.nystrom_ridge + cfg.sparsity_smoothing + cfg.ridge_vo + cfg.ridge_qk

    assert t_search.SEARCH_SPACE == j_search.SEARCH_SPACE
    want = j_search.random_search(JConfig(), score, n_trials=5, seed=7)
    got = t_search.random_search(TConfig(), score, n_trials=5, seed=7)
    assert got == want


def test_staged_search_matches_jax(tmp_path):
    """Calibration on 16 x 32 tokens, where the trials' V/O solve is well
    posed (`test_search_vo_solve_matches_jax`); on 4 x 32 it is not
    (`test_search_gram_at_4x32_is_singular`)."""
    model = test_torch_evals._tiny_llama()
    j_spec, j_params = j_params_from_hf(model)
    t_spec, t_params = t_params_from_hf(model, device="cpu")
    kw = dict(n_trials=2, top_k=1, seed=3, proxy_seq_len=16, proxy_samples=4)

    def base(cls, sub, **extra):
        return cls(model="in-memory", dataset="synthetic", calib_size=16, calibs_batch_size=4, seq_len=32,
                   compression_ratio=0.3, temp_storage_dir=str(tmp_path / sub / "l"),
                   output_dir=str(tmp_path / sub / "o"), metrics_dir=str(tmp_path / sub / "m"), **extra)

    want = j_search.staged_search(base(JConfig, "jax"), j_spec, j_params, **kw)
    got = t_search.staged_search(base(TConfig, "port", device="cpu"), t_spec, t_params, **kw)
    assert [p for p, _ in got[2]] == [p for p, _ in want[2]]
    np.testing.assert_allclose([s for _, s in got[2]], [s for _, s in want[2]], rtol=1e-4)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)


# the search's second trial at seed 3 (above): the smallest ridge_vo it draws
SEARCH_RIDGE_VO = 1.1636971153806425e-07


def _search_grams(calib_size):
    """Layer 0's attention-input Gram of the search's tiny llama, from
    each package's calibration (f32 forwards), in float64."""
    model = test_torch_evals._tiny_llama()
    j_spec, j_params = j_params_from_hf(model)
    t_spec, t_params = t_params_from_hf(model, device="cpu")
    batches = load_calibration_batches(None, "synthetic", calib_size, 4, 32, vocab_size=t_spec.vocab_size)
    cov_j = np.asarray(j_calibrate(j_spec, j_params, batches, [0]).cov_x[0], np.float64)
    cov_t = t_calibrate(t_spec, t_params, batches, [0]).cov_x[0].double().numpy()
    return model, cov_j, cov_t


def test_search_vo_solve_matches_jax():
    """On the search test's 16 x 32 calibration tokens the layer-0 Gram is
    far from singular at the trials' smallest ridge_vo, and the two
    packages' V/O solvers (rank 12 of 16 a kv head), given either
    package's Gram, agree to 1e-12."""
    model, cov_j, cov_t = _search_grams(16)
    assert np.linalg.eigvalsh(cov_j)[0] > 1e4 * SEARCH_RIDGE_VO
    attn = model.model.layers[0].self_attn
    W_v, W_o = (attn.v_proj.weight.detach().double().numpy(), attn.o_proj.weight.detach().double().numpy())
    for cov in (cov_j, cov_t):
        want = j_vo(jnp.asarray(cov), jnp.asarray(W_v), jnp.asarray(W_o), 12, 4, 2, SEARCH_RIDGE_VO)
        got = t_vo(*map(torch.from_numpy, (cov, W_v, W_o)), 12, 4, 2, SEARCH_RIDGE_VO)
        for g, w in ((got.v, want.v), (got.o, want.o)):
            w = np.asarray(w)
            assert np.abs(g.numpy() - w).max() <= 1e-12 * np.abs(w).max()


def test_search_gram_at_4x32_is_singular():
    """Why the search test calibrates on 16 x 32 tokens: 4 x 32 hold 50
    distinct tokens, and layer 0's Gram (whose input is the normed
    embedding) keeps a null space whose eigenvalues lie below the two
    packages' f32 rounding of the Gram and below the trials' ridge_vo.
    The whitening's inverse square root there is set by that rounding,
    not by the model, so the two packages' trial perplexities part there
    in float64 solves as in float32."""
    _, cov_j, cov_t = _search_grams(4)
    w = np.linalg.eigvalsh(cov_j)
    rounding = np.abs(cov_j - cov_t).max()
    assert rounding > 0 and w[0] < SEARCH_RIDGE_VO
    assert (np.abs(w) <= 10 * rounding).sum() >= 8  # a null space, not one small eigenvalue


def test_run_optuna_study_needs_optuna(monkeypatch):
    monkeypatch.setitem(sys.modules, "optuna", None)  # `import optuna` raises ImportError
    with pytest.raises(ImportError, match="optuna is not installed in this environment; use "
                       "modegpt_tpu_torch.analysis.search.random_search instead"):
        t_search.run_optuna_study(TConfig(), n_trials=1)
    with pytest.raises(ImportError, match="optuna is not installed in this environment"):
        j_search.run_optuna_study(JConfig(), n_trials=1)
