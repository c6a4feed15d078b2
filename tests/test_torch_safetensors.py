"""The port's direct safetensors loader against its AutoModel path and the
JAX package's loader, on the CPU.

Tiny HF models of six architectures (llama, qwen3, opt, phi3, gpt2 and a
mixed qwen3_moe stack) saved as one file and as shards with an index, in
float32 and bfloat16: `models/safetensors_io` (through
`models/hf.load_hf_model`) must build, without instantiating a torch
module, the spec and the float32 tree that `params_from_hf_model` builds
from the live model, and the tree JAX's ``load_hf_model`` (its own
safetensors reader) returns, bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from modegpt_tpu.models.hf import load_hf_model as j_load  # noqa: E402
from modegpt_tpu_torch.models import hf as hf_mod  # noqa: E402
from modegpt_tpu_torch.models.safetensors_io import load_hf_checkpoint_safetensors  # noqa: E402

_COMMON = dict(vocab_size=128, max_position_embeddings=128)


def _model(name):
    t = transformers
    if name == "llama":
        cfg = t.LlamaConfig(**_COMMON, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2, tie_word_embeddings=False)
        cls = t.LlamaForCausalLM
    elif name == "qwen3":
        cfg = t.Qwen3Config(**_COMMON, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2, head_dim=16, tie_word_embeddings=True)
        cls = t.Qwen3ForCausalLM
    elif name == "opt":
        cfg = t.OPTConfig(**_COMMON, hidden_size=48, ffn_dim=96, num_hidden_layers=2,
                          num_attention_heads=4, word_embed_proj_dim=48)
        cls = t.OPTForCausalLM
    elif name == "phi3":
        cfg = t.Phi3Config(**_COMMON, hidden_size=64, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=4, tie_word_embeddings=False,
                           pad_token_id=0, eos_token_id=1, bos_token_id=2)
        cls = t.Phi3ForCausalLM
    elif name == "gpt2":
        cfg = t.GPT2Config(n_layer=2, n_embd=64, n_inner=64, n_head=4, vocab_size=128, n_positions=128)
        cls = t.GPT2LMHeadModel
    else:  # a mixed stack: layer 1 dense
        cfg = t.Qwen3MoeConfig(**_COMMON, intermediate_size=96, moe_intermediate_size=48, hidden_size=64,
                               num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                               num_experts=4, num_experts_per_tok=2, mlp_only_layers=[1])
        cls = t.Qwen3MoeForCausalLM
    torch.manual_seed(0)
    return cls(cfg).eval()


def _assert_trees_equal(got, want, path="params"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        def host(a):  # bfloat16 compared by its bits
            if isinstance(a, torch.Tensor):
                return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
            return np.asarray(a)

        g, w = host(got), host(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.mark.parametrize("layout", ["single", "sharded"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama", "qwen3", "opt", "phi3", "gpt2", "qwen3_moe"])
def test_safetensors_equals_automodel_and_jax(tmp_path, monkeypatch, arch, dtype, layout):
    model = _model(arch).to(getattr(torch, dtype))
    model.save_pretrained(tmp_path, safe_serialization=True, max_shard_size="40KB" if layout == "sharded" else "5GB")
    sharded = (tmp_path / "model.safetensors.index.json").exists()
    assert sharded == (layout == "sharded")

    def no_automodel(*args, **kwargs):
        raise AssertionError("the safetensors path built a torch module")

    monkeypatch.setattr(transformers.AutoModelForCausalLM, "from_pretrained", no_automodel)
    spec, params, tokenizer = hf_mod.load_hf_model(str(tmp_path), device="cpu")
    assert tokenizer is None  # no tokenizer files saved
    want_spec, want = hf_mod.params_from_hf_model(model, device="cpu")
    assert spec == want_spec
    _assert_trees_equal(params, want)

    j_spec, j_params, _ = j_load(str(tmp_path))
    assert spec.to_dict() == want_spec.to_dict()
    assert (j_spec.arch, j_spec.n_layers, tuple(j_spec.gate_ranks)) == (spec.arch, spec.n_layers, spec.gate_ranks)
    _assert_trees_equal(params, j_params)


def test_safetensors_casts_to_the_requested_dtype(tmp_path):
    model = _model("llama")
    model.save_pretrained(tmp_path, safe_serialization=True)
    spec, params = load_hf_checkpoint_safetensors(str(tmp_path), dtype=torch.bfloat16, device="cpu")
    _, want = hf_mod.params_from_hf_model(model, dtype=torch.bfloat16, device="cpu")
    _assert_trees_equal(params, want)
    assert params["layers"][0]["q"]["kernel"].dtype == torch.bfloat16


def test_without_safetensors_files_falls_back_to_automodel(tmp_path):
    """A .bin checkpoint has no safetensors shards: load_hf_model builds it
    through AutoModelForCausalLM instead, to the same tree."""
    model = _model("llama")
    model.save_pretrained(tmp_path, safe_serialization=False)
    assert not list(tmp_path.glob("*.safetensors"))
    with pytest.raises(FileNotFoundError):
        load_hf_checkpoint_safetensors(str(tmp_path), device="cpu")
    spec, params, _ = hf_mod.load_hf_model(str(tmp_path), device="cpu")
    _, want = hf_mod.params_from_hf_model(model, device="cpu")
    _assert_trees_equal(params, want)


def test_missing_tensor_falls_back_to_automodel(tmp_path, monkeypatch):
    """A tensor the spec needs absent from the shards (KeyError) takes
    the AutoModel path, as the JAX loader does."""
    model = _model("llama")
    model.save_pretrained(tmp_path, safe_serialization=True)
    calls = []
    real = transformers.AutoModelForCausalLM.from_pretrained

    def spy(*args, **kwargs):
        calls.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(transformers.AutoModelForCausalLM, "from_pretrained", spy)
    from modegpt_tpu_torch.models import safetensors_io

    real_keys = safetensors_io._ShardedReader.__init__

    def drop_final_norm(self, model_dir):
        real_keys(self, model_dir)
        del self._files["model.norm.weight"]

    monkeypatch.setattr(safetensors_io._ShardedReader, "__init__", drop_final_norm)
    _, params, _ = hf_mod.load_hf_model(str(tmp_path), device="cpu")
    assert calls == [str(tmp_path)]
    _, want = hf_mod.params_from_hf_model(model, device="cpu")
    _assert_trees_equal(params, want)


def test_the_fallback_never_changes_the_device(tmp_path):
    """The default device is the card: without one the load raises rather
    than carrying on on the CPU, on both paths."""
    model = _model("llama")
    model.save_pretrained(tmp_path / "st", safe_serialization=True)
    model.save_pretrained(tmp_path / "bin", safe_serialization=False)
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device exists")
    for sub in ("st", "bin"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            hf_mod.load_hf_model(str(tmp_path / sub))
