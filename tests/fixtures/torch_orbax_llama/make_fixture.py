"""Write the JAX-written orbax fixture the port's tests and chip_smoke.py
load: a tiny Llama compressed by the JAX package (heterogeneous ranks,
rotary masks), saved with ``backend="orbax"`` in float32 (``f32/``) and
bfloat16 (``bf16/``), zstd-compressed chunks inside, and its npz twin in
float32 (``npz/``). Run from the repository root on the CPU:

    JAX_PLATFORMS=cpu python tests/fixtures/torch_orbax_llama/make_fixture.py
"""

import os
import shutil
import sys
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402
import transformers  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from modegpt_tpu.compress import artifact  # noqa: E402
from modegpt_tpu.compress.pipeline import run_compression  # noqa: E402
from modegpt_tpu.config import CompressionConfig  # noqa: E402
from modegpt_tpu.models import params_from_hf_model  # noqa: E402


def tiny_llama():
    cfg = transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(cfg).eval()


def main():
    spec, params = params_from_hf_model(tiny_llama())
    with tempfile.TemporaryDirectory() as tmp:
        cfg = CompressionConfig(
            model="tiny-llama", dataset="synthetic", calib_size=8, calibs_batch_size=4, seq_len=32,
            eval_batch_size=4, eval_max_samples=4, compression_ratio=0.4, sparsity_smoothing=0.01,
            max_sparsity=0.8, skip_baseline_eval=True, output_dir=os.path.join(tmp, "out"),
            temp_storage_dir=os.path.join(tmp, "layers"), metrics_dir=os.path.join(tmp, "metrics"),
        )
        out = run_compression(cfg, spec=spec, params=params)
        c_spec, c_params, tok = artifact.load_compressed_model(out["artifact_dir"])
    for name in ("f32", "bf16", "npz"):
        shutil.rmtree(os.path.join(HERE, name), ignore_errors=True)
    meta = {"fixture": "tiny llama, JAX package"}
    artifact.save_compressed_model(os.path.join(HERE, "f32"), c_spec, c_params, tok, meta, "float32", "orbax")
    artifact.save_compressed_model(os.path.join(HERE, "bf16"), c_spec, c_params, tok, meta, "bfloat16", "orbax")
    artifact.save_compressed_model(os.path.join(HERE, "npz"), c_spec, c_params, tok, meta, "float32")
    print("ranks:", c_spec.gate_ranks, c_spec.k_ranks)


if __name__ == "__main__":
    main()
