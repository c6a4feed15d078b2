"""The streamed job on every other architecture the spec parses, on the CPU.

The tiny models of `test_torch_archs` (gemma, gemma2, olmo2, gpt2, phi3,
starcoder2, mistral, qwen2) and `test_torch_moe` (mixtral, a mixed
qwen3_moe stack, qwen2_moe) through `run_compression` with
``calib_exec="stream"`` and host-staged weights (`offload._host_staged`
patched: on the CPU every leaf sits on the compute device) must give the
chunked job's compressed spec and perplexity exactly: staging, the
prepass, the slimmed windows and the host-row gathers change no number.
The JAX comparisons of these models are in those two files.
"""

import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import test_torch_archs  # noqa: E402
import test_torch_moe  # noqa: E402

from modegpt_tpu_torch.compress import offload  # noqa: E402
from modegpt_tpu_torch.compress.pipeline import run_compression  # noqa: E402
from modegpt_tpu_torch.config import CompressionConfig  # noqa: E402
from modegpt_tpu_torch.models.hf import params_from_hf_model  # noqa: E402

MOE = ("mixtral", "qwen3_moe_mixed", "qwen2_moe")


@pytest.mark.parametrize("arch", ["gemma", "gemma2", "olmo2", "gpt2", "phi3", "starcoder2", "mistral", "qwen2", *MOE])
def test_stream_job_on_every_arch(tmp_path, monkeypatch, arch):
    if arch in MOE:
        model = test_torch_moe._hf(arch)
    else:
        cfg, cls = test_torch_archs._config(arch)
        torch.manual_seed(0)
        model = cls(cfg).eval()
    spec, params = params_from_hf_model(model, device="cpu")

    def job(sub, **kw):
        config = CompressionConfig(
            model="mem", dataset="synthetic", calib_size=4, calibs_batch_size=2, seq_len=32,
            compression_ratio=0.3, sparsity_smoothing=0.5, layers_per_step=1, solver_precision="f32_device",
            bi_stage_dtype="bf16", eval_max_samples=2, eval_batch_size=2, skip_baseline_eval=True, device="cpu",
            output_dir=str(tmp_path / sub / "o"), temp_storage_dir=str(tmp_path / sub / "l"),
            metrics_dir=str(tmp_path / sub / "m"), **kw,
        )
        return run_compression(config, spec=spec, params=params)

    ref = job("chunk")
    monkeypatch.setattr(offload, "_host_staged", lambda params, device: True)
    got = job("staged", calib_exec="stream")
    assert got["compressed_spec"] == ref["compressed_spec"]
    assert got["compressed_ppl"] == ref["compressed_ppl"]
