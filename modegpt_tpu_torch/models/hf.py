"""HuggingFace checkpoint ingestion: state dict -> the port's parameter tree.

Port of ``modegpt_tpu.models.hf`` for every architecture the spec
parses. HF Linear weights are ``[out, in]``; the forward's kernels are
``[in, out]``, so each projection is transposed once here (gpt2's Conv1D
weights are already ``[in, out]``), and a MoE layer's per-expert weights
are stacked into ``[E, in, out]`` kernels. Fused projections (gpt2's
``c_attn``, phi3's ``qkv_proj`` and ``gate_up_proj``) split by the spec's
rank lists, so a compressed re-import splits where the export fused.
The norm names depend on the arch: llama's ``post_attention_layernorm``
is the pre-MLP norm, gemma2's normalises the attention output (its MLP
takes ``pre_feedforward_layernorm``), olmo2 has only the two post norms.
`params_from_state_dict` is pure torch; `load_hf_model` reads
safetensors shards directly (`models.safetensors_io`) and imports
``transformers`` only for a checkpoint without them and for the
tokenizer.
"""

from __future__ import annotations

import os
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

    def split(fused, sizes, transpose: bool):
        """A fused weight (or bias) cut along its output axis: rows of an
        HF [out, in] weight, columns of a Conv1D [in, out] one."""
        t = fused.detach().to(device=dev, dtype=dtype)
        axis = 0 if transpose or t.dim() == 1 else 1
        parts = torch.split(t, list(sizes), dim=axis)
        return [(part.T if transpose else part).contiguous() for part in parts]

    params: Dict = {}
    if spec.arch == "gpt2":
        # Conv1D weights are [in, out] already; c_attn [d, 3d] splits into
        # q/k/v by the rank lists, c_fc/c_proj are up/down
        pre = "transformer."
        params["embed_tokens"] = V(pre + "wte.weight")
        params["embed_positions"] = V(pre + "wpe.weight")
        params["final_norm"] = {"scale": V(pre + "ln_f.weight"), "bias": V(pre + "ln_f.bias")}
        layers = []
        for l in range(spec.n_layers):
            b = f"{pre}h.{l}."
            sizes = (spec.q_ranks[l], spec.k_ranks[l], spec.v_ranks[l])
            ws = split(sd[b + "attn.c_attn.weight"], sizes, transpose=False)
            bs = split(sd[b + "attn.c_attn.bias"], sizes, transpose=False)
            lp = {
                "attn_norm": {"scale": V(b + "ln_1.weight"), "bias": V(b + "ln_1.bias")},
                "mlp_norm": {"scale": V(b + "ln_2.weight"), "bias": V(b + "ln_2.bias")},
                **{name: {"kernel": w, "bias": bias} for name, w, bias in zip("qkv", ws, bs)},
            }
            for ours, theirs in (("o", "attn.c_proj"), ("up", "mlp.c_fc"), ("down", "mlp.c_proj")):
                lp[ours] = {"kernel": V(b + theirs + ".weight"), "bias": V(b + theirs + ".bias")}
            layers.append(lp)
        params["layers"] = layers
    elif spec.arch == "opt":
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
    else:  # the rotary archs
        pre = "model."
        params["embed_tokens"] = V(pre + "embed_tokens.weight")
        params["final_norm"] = {"scale": V(pre + "norm.weight")}
        if has(pre + "norm.bias"):  # starcoder2: biased LayerNorm
            params["final_norm"]["bias"] = V(pre + "norm.bias")
        layers = []
        for l in range(spec.n_layers):
            b = f"{pre}layers.{l}."
            if spec.post_norms and not spec.pre_norms:  # olmo2: the post norms only
                names = {"post_attn_norm": "post_attention_layernorm", "post_mlp_norm": "post_feedforward_layernorm"}
            elif spec.post_norms:  # gemma2: sandwich norms
                names = {
                    "attn_norm": "input_layernorm", "post_attn_norm": "post_attention_layernorm",
                    "mlp_norm": "pre_feedforward_layernorm", "post_mlp_norm": "post_feedforward_layernorm",
                }
            else:
                names = {"attn_norm": "input_layernorm", "mlp_norm": "post_attention_layernorm"}
            lp = {}
            for ours, theirs in names.items():
                lp[ours] = {"scale": V(f"{b}{theirs}.weight")}
                if has(f"{b}{theirs}.bias"):  # starcoder2's LayerNorms
                    lp[ours]["bias"] = V(f"{b}{theirs}.bias")
            if spec.arch == "phi3":  # fused qkv_proj [(H + 2 Hk) hd, d]
                sizes = (spec.q_ranks[l], spec.k_ranks[l], spec.v_ranks[l])
                qkv = split(sd[b + "self_attn.qkv_proj.weight"], sizes, transpose=True)
                lp.update({name: {"kernel": w} for name, w in zip("qkv", qkv)})
            else:
                for name in "qkv":
                    lp[name] = {"kernel": W(f"{b}self_attn.{name}_proj.weight")}
            lp["o"] = {"kernel": W(b + "self_attn.o_proj.weight")}
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
            elif spec.arch == "phi3":  # fused gate_up_proj [2 D, d]
                gd = spec.gate_ranks[l]
                gate, up = split(sd[b + "mlp.gate_up_proj.weight"], (gd, gd), transpose=True)
                lp["gate"], lp["up"] = {"kernel": gate}, {"kernel": up}
                lp["down"] = {"kernel": W(b + "mlp.down_proj.weight")}
            elif spec.arch == "starcoder2":  # non-gated, under GPT-2's names
                for ours, theirs in (("up", "mlp.c_fc"), ("down", "mlp.c_proj")):
                    lp[ours] = {"kernel": W(f"{b}{theirs}.weight")}
                    if has(f"{b}{theirs}.bias"):
                        lp[ours]["bias"] = V(f"{b}{theirs}.bias")
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
            if spec.qk_norm or spec.flat_qk_norm:
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
    """Load a dense HF checkpoint directory; returns (spec, params, tokenizer).

    The safetensors shards are read directly first
    (`models.safetensors_io`: one pass, no torch module); a checkpoint
    without them, or without a tensor the spec needs, goes through
    ``AutoModelForCausalLM`` instead (JAX ``models/hf.py:285-297``). Either
    way the tree lands on ``device``."""
    from modegpt_tpu_torch.models.safetensors_io import load_hf_checkpoint_safetensors

    local = os.path.isdir(model_name_or_path)  # a directory never asks the hub
    try:
        spec, params = load_hf_checkpoint_safetensors(model_name_or_path, dtype=dtype, device=device)
    except (FileNotFoundError, KeyError):
        from transformers import AutoModelForCausalLM

        model = AutoModelForCausalLM.from_pretrained(
            model_name_or_path, torch_dtype=torch.float32, low_cpu_mem_usage=True, local_files_only=local
        )
        spec, params = params_from_hf_model(model, dtype=dtype, device=device)
        del model
    try:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_name_or_path, local_files_only=local)
        if tokenizer.pad_token is None:
            tokenizer.pad_token = tokenizer.eos_token
    except Exception:
        # a checkpoint without tokenizer files (or a host without
        # transformers): fine for the synthetic dataset and for
        # pre-tokenized local corpora
        tokenizer = None
    return spec, params, tokenizer
