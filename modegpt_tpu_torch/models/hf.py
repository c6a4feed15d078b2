"""HuggingFace checkpoint ingestion: state dict -> the port's parameter tree.

Port of ``modegpt_tpu.models.hf`` for llama, qwen3, opt, mixtral,
qwen3_moe and qwen2_moe. HF Linear weights are ``[out, in]``; the
forward's kernels are ``[in, out]``, so each projection is transposed
once here, and a MoE layer's per-expert weights are stacked into
``[E, in, out]`` kernels. `params_from_state_dict` is
pure torch; `load_hf_model` imports ``transformers`` when called (it is
absent on the card's machine, where the smoke run builds its weights in
code).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from modegpt_tpu_torch.models.forward import check_supported
from modegpt_tpu_torch.models.spec import ModelSpec, spec_from_hf_config
from modegpt_tpu_torch.utils.device import DeviceLike, resolve_device

__all__ = ["params_from_state_dict", "params_from_hf_model", "load_hf_model"]


def params_from_state_dict(
    spec: ModelSpec,
    sd: Dict[str, torch.Tensor],
    dtype: torch.dtype = torch.float32,
    rotary_masks: Optional[Dict[int, torch.Tensor]] = None,
    device: DeviceLike = "cuda",
) -> Dict:
    """Build the parameter tree from an HF state dict, on ``device``."""
    check_supported(spec)
    dev = resolve_device(device)

    def V(name):  # vector / embedding: as-is
        return sd[name].detach().to(device=dev, dtype=dtype).contiguous()

    def W(name):  # linear kernel: [out, in] -> [in, out]
        return sd[name].detach().to(device=dev, dtype=dtype).T.contiguous()

    def has(name):
        return name in sd

    params: Dict = {}
    if spec.arch == "opt":
        pre = "model.decoder."
        params["embed_tokens"] = V(pre + "embed_tokens.weight")
        params["embed_positions"] = V(pre + "embed_positions.weight")
        if has(pre + "project_in.weight"):
            params["project_in"] = {"kernel": W(pre + "project_in.weight")}
            params["project_out"] = {"kernel": W(pre + "project_out.weight")}
        if has(pre + "final_layer_norm.weight"):
            params["final_norm"] = {
                "scale": V(pre + "final_layer_norm.weight"),
                "bias": V(pre + "final_layer_norm.bias"),
            }
        else:
            params["final_norm"] = None  # post-LN OPT variants
        names = [
            ("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"), ("v", "self_attn.v_proj"),
            ("o", "self_attn.out_proj"), ("up", "fc1"), ("down", "fc2"),
        ]
        layers = []
        for l in range(spec.n_layers):
            b = f"{pre}layers.{l}."
            lp = {
                "attn_norm": {
                    "scale": V(b + "self_attn_layer_norm.weight"),
                    "bias": V(b + "self_attn_layer_norm.bias"),
                },
                "mlp_norm": {
                    "scale": V(b + "final_layer_norm.weight"),
                    "bias": V(b + "final_layer_norm.bias"),
                },
            }
            for ours, theirs in names:
                lp[ours] = {"kernel": W(b + theirs + ".weight")}
                if has(b + theirs + ".bias"):
                    lp[ours]["bias"] = V(b + theirs + ".bias")
            layers.append(lp)
        params["layers"] = layers
    else:  # llama / qwen3 / mixtral / qwen3_moe / qwen2_moe
        pre = "model."
        params["embed_tokens"] = V(pre + "embed_tokens.weight")
        params["final_norm"] = {"scale": V(pre + "norm.weight")}
        layers = []
        for l in range(spec.n_layers):
            b = f"{pre}layers.{l}."
            lp = {
                "attn_norm": {"scale": V(b + "input_layernorm.weight")},
                "mlp_norm": {"scale": V(b + "post_attention_layernorm.weight")},
                "q": {"kernel": W(b + "self_attn.q_proj.weight")},
                "k": {"kernel": W(b + "self_attn.k_proj.weight")},
                "v": {"kernel": W(b + "self_attn.v_proj.weight")},
                "o": {"kernel": W(b + "self_attn.o_proj.weight")},
            }
            if spec.is_moe_layer(l):
                # mixtral: block_sparse_moe.gate + experts.{e}.w1/w3/w2;
                # qwen*_moe: mlp.gate + mlp.experts.{e}.{gate,up,down}_proj,
                # and qwen2_moe's mlp.shared_expert.* + mlp.shared_expert_gate
                if spec.arch == "mixtral":
                    moe, names = b + "block_sparse_moe.", ("w1", "w3", "w2")
                else:
                    moe, names = b + "mlp.", ("gate_proj", "up_proj", "down_proj")
                lp["router"] = {"kernel": W(moe + "gate.weight")}

                def EW(name):  # [E, in, out]
                    return torch.stack([W(f"{moe}experts.{e}.{name}.weight") for e in range(spec.n_experts)])

                lp["experts"] = {
                    "gate": {"kernel": EW(names[0])},
                    "up": {"kernel": EW(names[1])},
                    "down": {"kernel": EW(names[2])},
                }
                if spec.shared_d_int:
                    lp["shared"] = {
                        "gate": {"kernel": W(moe + "shared_expert.gate_proj.weight")},
                        "up": {"kernel": W(moe + "shared_expert.up_proj.weight")},
                        "down": {"kernel": W(moe + "shared_expert.down_proj.weight")},
                    }
                    if spec.shared_expert_gate:
                        lp["shared_gate"] = {"kernel": W(moe + "shared_expert_gate.weight")}
            else:
                lp["gate"] = {"kernel": W(b + "mlp.gate_proj.weight")}
                lp["up"] = {"kernel": W(b + "mlp.up_proj.weight")}
                lp["down"] = {"kernel": W(b + "mlp.down_proj.weight")}
            if spec.attention_bias:
                for ours, theirs in [
                    ("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                    ("v", "self_attn.v_proj"), ("o", "self_attn.o_proj"),
                ]:
                    if has(b + theirs + ".bias"):
                        lp[ours]["bias"] = V(b + theirs + ".bias")
            if spec.qk_norm:
                lp["q_norm"] = {"scale": V(b + "self_attn.q_norm.weight")}
                lp["k_norm"] = {"scale": V(b + "self_attn.k_norm.weight")}
            if rotary_masks is not None and l in rotary_masks:
                lp["rotary_mask"] = torch.as_tensor(rotary_masks[l], dtype=torch.int32, device=dev)
            layers.append(lp)
        params["layers"] = layers

    if spec.tie_word_embeddings or "lm_head.weight" not in sd:
        params["lm_head"] = None
    else:
        params["lm_head"] = {"kernel": W("lm_head.weight")}
    return params


def params_from_hf_model(model, dtype: torch.dtype = torch.float32, device: DeviceLike = "cuda") -> Tuple[ModelSpec, Dict]:
    """Convert a live transformers CausalLM model to (spec, params)."""
    spec = spec_from_hf_config(model.config)
    return spec, params_from_state_dict(spec, dict(model.state_dict()), dtype=dtype, device=device)


def load_hf_model(model_name_or_path: str, dtype: torch.dtype = torch.float32, device: DeviceLike = "cuda"):
    """Load a dense HF checkpoint directory; returns (spec, params, tokenizer)."""
    from transformers import AutoModelForCausalLM, AutoTokenizer

    model = AutoModelForCausalLM.from_pretrained(
        model_name_or_path, torch_dtype=torch.float32, low_cpu_mem_usage=True
    )
    try:
        tokenizer = AutoTokenizer.from_pretrained(model_name_or_path)
        if tokenizer.pad_token is None:
            tokenizer.pad_token = tokenizer.eos_token
    except Exception:
        # a checkpoint without tokenizer files: fine for the synthetic
        # dataset and for pre-tokenized local corpora
        tokenizer = None
    spec, params = params_from_hf_model(model, dtype=dtype, device=device)
    del model
    return spec, params, tokenizer
