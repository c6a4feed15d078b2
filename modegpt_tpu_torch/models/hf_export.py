"""Export a (compressed) model to a HuggingFace checkpoint directory.

Port of ``modegpt_tpu.models.hf_export``. The reference's compressed
checkpoints are HF directories whose config carries per-layer rank lists
and whose weights follow HF naming (reference: LlamaAdapter.py:250-302
`patch_config`, model_utils.py:83-126 `save_compressed_model`). This
exporter writes the same files as the JAX package from the port's
(spec, params):

* ``config.json`` with the arch's standard fields plus
  ``q_ranks/k_ranks/v_ranks/o_ranks/gate_ranks`` and ``mask_path`` (an
  absolute path, or null);
* ``model.safetensors`` under HF parameter names, ``[out, in]`` weights
  (gpt2's Conv1D ``[in, out]``, its ``c_attn`` fused again, a folded v
  bias written as zeros; OPT's folded v bias as zeros too; phi3's fused
  ``qkv_proj`` and ``gate_up_proj``; mixtral, qwen3_moe and qwen2_moe
  expert layouts with qwen2_moe's shared expert);
* ``rotary_masks.pt`` (a list of int64 tensors) when the model has
  rotary masks;
* ``tokenizer_source.txt``.

A dense export loads with ``transformers``; a compressed one reloads
through `models.safetensors_io.read_hf_config`, `models.spec.spec_from_hf_config`
and `models.hf.params_from_state_dict`. Tensors are copied to the host
in ``dtype`` one at a time, so the export works from a card-resident tree.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import torch

from modegpt_tpu_torch.models.spec import ModelSpec

__all__ = ["export_to_hf"]


def _hf_config_dict(spec: ModelSpec) -> Dict:
    if spec.arch == "gpt2":
        cfg = {
            "model_type": "gpt2",
            "architectures": ["GPT2LMHeadModel"],
            "vocab_size": spec.vocab_size,
            "n_embd": spec.d_model,
            "n_inner": spec.d_int,
            "n_layer": spec.n_layers,
            "n_head": spec.n_heads,
            "n_positions": spec.max_position_embeddings,
            "n_ctx": spec.max_position_embeddings,
            "activation_function": spec.act,
            "layer_norm_epsilon": spec.norm_eps,
            "tie_word_embeddings": spec.tie_word_embeddings,
        }
    elif spec.arch == "opt":
        cfg = {
            "model_type": "opt",
            "architectures": ["OPTForCausalLM"],
            "vocab_size": spec.vocab_size,
            "hidden_size": spec.d_model,
            "ffn_dim": spec.d_int,
            "num_hidden_layers": spec.n_layers,
            "num_attention_heads": spec.n_heads,
            "max_position_embeddings": spec.max_position_embeddings,
            "activation_function": spec.act,
            "do_layer_norm_before": spec.do_layer_norm_before,
            "enable_bias": spec.attention_bias,
            "word_embed_proj_dim": spec.word_embed_proj_dim or spec.d_model,
            "tie_word_embeddings": spec.tie_word_embeddings,
        }
    else:
        arch_cls = {
            "llama": "LlamaForCausalLM",
            "mistral": "MistralForCausalLM",
            "qwen2": "Qwen2ForCausalLM",
            "qwen3": "Qwen3ForCausalLM",
            "mixtral": "MixtralForCausalLM",
            "qwen3_moe": "Qwen3MoeForCausalLM",
            "qwen2_moe": "Qwen2MoeForCausalLM",
            "gemma": "GemmaForCausalLM",
            "gemma2": "Gemma2ForCausalLM",
            "phi3": "Phi3ForCausalLM",
            "starcoder2": "Starcoder2ForCausalLM",
            "olmo2": "Olmo2ForCausalLM",
        }
        cfg = {
            "model_type": spec.arch,
            "architectures": [arch_cls[spec.arch]],
            "vocab_size": spec.vocab_size,
            "hidden_size": spec.d_model,
            "intermediate_size": spec.d_int,
            "num_hidden_layers": spec.n_layers,
            "num_attention_heads": spec.n_heads,
            "num_key_value_heads": spec.n_kv_heads,
            "head_dim": spec.head_dim,
            "max_position_embeddings": spec.max_position_embeddings,
            "hidden_act": spec.act,
            "rms_norm_eps": spec.norm_eps,
            "rope_theta": spec.rope_theta,
            "attention_bias": spec.attention_bias,
            "mlp_bias": spec.mlp_bias,
            "tie_word_embeddings": spec.tie_word_embeddings,
        }
        if spec.layer_types and spec.arch != "mixtral":
            cfg["layer_types"] = list(spec.layer_types)
            cfg["sliding_window"] = spec.sliding_window
            cfg["use_sliding_window"] = spec.sliding_window is not None
        elif spec.arch == "mixtral":
            cfg["sliding_window"] = spec.sliding_window
        if spec.arch in ("gemma", "gemma2"):
            cfg["hidden_activation"] = spec.act
        if spec.arch == "starcoder2":
            cfg["norm_epsilon"] = spec.norm_eps
            cfg["use_bias"] = spec.attention_bias
            del cfg["rms_norm_eps"]
        if spec.arch == "gemma2":
            cfg["query_pre_attn_scalar"] = spec.query_pre_attn_scalar
            cfg["attn_logit_softcapping"] = spec.attn_logit_softcap
            cfg["final_logit_softcapping"] = spec.final_logit_softcap
            cfg["sliding_window"] = spec.sliding_window
            cfg["layer_types"] = list(spec.layer_types)
        if spec.arch == "mixtral":
            cfg["num_local_experts"] = spec.n_experts
            cfg["num_experts_per_tok"] = spec.experts_per_tok
        elif spec.arch in ("qwen3_moe", "qwen2_moe"):
            # HF MoE configs carry BOTH the dense intermediate (used by
            # mlp_only_layers) and the per-expert moe intermediate; our
            # spec.d_int is the latter, dense layers' size lives in their
            # gate_ranks entries.
            cfg["moe_intermediate_size"] = spec.d_int
            dense_layers = [
                l for l in range(spec.n_layers) if not spec.is_moe_layer(l)
            ]
            cfg["intermediate_size"] = (
                spec.gate_ranks[dense_layers[0]] if dense_layers else spec.d_int
            )
            cfg["mlp_only_layers"] = dense_layers
            cfg["decoder_sparse_step"] = 1
            cfg["num_experts"] = spec.n_experts
            cfg["num_experts_per_tok"] = spec.experts_per_tok
            cfg["norm_topk_prob"] = spec.norm_topk_prob
            if spec.arch == "qwen2_moe":
                cfg["shared_expert_intermediate_size"] = spec.shared_d_int
    # Compressed rank lists (reference: LlamaAdapter.py:286-292) + the
    # ffn_dim=-1 canary the reference sets (LlamaAdapter.py:287).
    cfg["q_ranks"] = list(spec.q_ranks)
    cfg["k_ranks"] = list(spec.k_ranks)
    cfg["v_ranks"] = list(spec.v_ranks)
    cfg["o_ranks"] = list(spec.o_ranks)
    cfg["gate_ranks"] = list(spec.gate_ranks)
    if spec.arch == "opt":
        # The reference's OPTRebuild consumes qk_ranks/vo_ranks
        # (OPTRebuild.py:126-127) while its own writers only ever emit
        # q_ranks/... (LlamaAdapter.py:288-292) — emit BOTH key sets so
        # exports load through the reference's actual consumer.
        cfg["qk_ranks"] = list(spec.q_ranks)
        cfg["vo_ranks"] = list(spec.v_ranks)
    if spec.shared_gate_ranks:
        cfg["shared_gate_ranks"] = list(spec.shared_gate_ranks)
    cfg["torch_dtype"] = "bfloat16"
    return cfg


def export_to_hf(
    spec: ModelSpec,
    params: Dict,
    out_dir: str,
    tokenizer_source: str = "",
    dtype: torch.dtype = torch.float32,
) -> str:
    """Write an HF-layout checkpoint directory from (spec, params)."""
    from safetensors.torch import save_file

    os.makedirs(out_dir, exist_ok=True)

    def V(a):  # a host copy in `dtype` (never a view of the tree)
        return a.detach().to(device="cpu", dtype=dtype, copy=True).contiguous()

    def K(p):  # the kernel as stored, [in, out] (gpt2's Conv1D layout)
        return V(p["kernel"])

    def W(p):  # kernel [in, out] -> HF [out, in]
        return V(p["kernel"]).T.contiguous()

    def zeros(p):  # a folded bias's slot
        return torch.zeros(p["kernel"].shape[-1], dtype=dtype)

    def finish(sd, masks):
        save_file(sd, os.path.join(out_dir, "model.safetensors"))
        cfg = _hf_config_dict(spec)
        cfg["mask_path"] = None
        if masks:
            cfg["mask_path"] = os.path.abspath(os.path.join(out_dir, "rotary_masks.pt"))
            torch.save([masks[l].to(torch.int64) for l in range(spec.n_layers)], cfg["mask_path"])
        with open(os.path.join(out_dir, "config.json"), "w") as f:
            json.dump(cfg, f, indent=2)
        with open(os.path.join(out_dir, "tokenizer_source.txt"), "w") as f:
            f.write(tokenizer_source.strip())
        return out_dir

    sd: Dict[str, torch.Tensor] = {}
    masks: Dict[int, torch.Tensor] = {}
    if spec.arch == "gpt2":
        # Conv1D layout is [in, out]: the kernels verbatim; c_attn fuses
        # [q | k | v] along the out axis again (the importer splits it by
        # the exported rank lists); a folded v bias is written as zeros
        pre = "transformer."
        sd[pre + "wte.weight"] = V(params["embed_tokens"])
        sd[pre + "wpe.weight"] = V(params["embed_positions"])
        sd[pre + "ln_f.weight"] = V(params["final_norm"]["scale"])
        sd[pre + "ln_f.bias"] = V(params["final_norm"]["bias"])
        for l, lp in enumerate(params["layers"]):
            b = f"{pre}h.{l}."
            sd[b + "ln_1.weight"] = V(lp["attn_norm"]["scale"])
            sd[b + "ln_1.bias"] = V(lp["attn_norm"]["bias"])
            sd[b + "ln_2.weight"] = V(lp["mlp_norm"]["scale"])
            sd[b + "ln_2.bias"] = V(lp["mlp_norm"]["bias"])
            sd[b + "attn.c_attn.weight"] = torch.cat([K(lp[n]) for n in "qkv"], dim=1)
            sd[b + "attn.c_attn.bias"] = torch.cat(
                [V(lp[n]["bias"]) if "bias" in lp[n] else zeros(lp[n]) for n in "qkv"]
            )
            sd[b + "attn.c_proj.weight"] = K(lp["o"])
            sd[b + "attn.c_proj.bias"] = V(lp["o"]["bias"])
            sd[b + "mlp.c_fc.weight"] = K(lp["up"])
            sd[b + "mlp.c_fc.bias"] = V(lp["up"]["bias"])
            sd[b + "mlp.c_proj.weight"] = K(lp["down"])
            sd[b + "mlp.c_proj.bias"] = V(lp["down"]["bias"])
        if params.get("lm_head") is not None:  # untied variants
            sd["lm_head.weight"] = W(params["lm_head"])
        return finish(sd, None)
    if spec.arch == "opt":
        pre = "model.decoder."
        sd[pre + "embed_tokens.weight"] = V(params["embed_tokens"])
        sd[pre + "embed_positions.weight"] = V(params["embed_positions"])
        if "project_in" in params:
            sd[pre + "project_in.weight"] = W(params["project_in"])
            sd[pre + "project_out.weight"] = W(params["project_out"])
        if params.get("final_norm") is not None:
            sd[pre + "final_layer_norm.weight"] = V(params["final_norm"]["scale"])
            sd[pre + "final_layer_norm.bias"] = V(params["final_norm"]["bias"])
        names = {
            "q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
            "o": "self_attn.out_proj", "up": "fc1", "down": "fc2",
        }
        norm_names = {"attn_norm": "self_attn_layer_norm", "mlp_norm": "final_layer_norm"}
    else:
        pre = "model."
        sd[pre + "embed_tokens.weight"] = V(params["embed_tokens"])
        sd[pre + "norm.weight"] = V(params["final_norm"]["scale"])
        if "bias" in params["final_norm"]:  # starcoder2 LayerNorm
            sd[pre + "norm.bias"] = V(params["final_norm"]["bias"])
        names = {
            "q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj", "o": "self_attn.o_proj",
        }
        if spec.arch == "starcoder2":
            names.update(up="mlp.c_fc", down="mlp.c_proj")
        else:
            names.update(gate="mlp.gate_proj", up="mlp.up_proj", down="mlp.down_proj")
        if spec.post_norms and not spec.pre_norms:  # olmo2
            norm_names = {"post_attn_norm": "post_attention_layernorm", "post_mlp_norm": "post_feedforward_layernorm"}
        elif spec.post_norms:
            norm_names = {
                "attn_norm": "input_layernorm",
                "post_attn_norm": "post_attention_layernorm",
                "mlp_norm": "pre_feedforward_layernorm",
                "post_mlp_norm": "post_feedforward_layernorm",
            }
        else:
            norm_names = {"attn_norm": "input_layernorm", "mlp_norm": "post_attention_layernorm"}

    for l, lp in enumerate(params["layers"]):
        b = f"{pre}layers.{l}."
        if spec.arch == "phi3":
            # phi3's native fused layout: qkv_proj = [q; k; v] rows,
            # gate_up_proj = [gate; up] rows (the importer splits them by
            # the exported rank lists)
            sd[b + "self_attn.qkv_proj.weight"] = torch.cat([W(lp[n]) for n in "qkv"], dim=0)
            sd[b + "self_attn.o_proj.weight"] = W(lp["o"])
            if "gate" in lp:
                sd[b + "mlp.gate_up_proj.weight"] = torch.cat([W(lp["gate"]), W(lp["up"])], dim=0)
                sd[b + "mlp.down_proj.weight"] = W(lp["down"])
        else:
            for ours, theirs in names.items():
                if ours not in lp:
                    continue
                sd[b + theirs + ".weight"] = W(lp[ours])
                if "bias" in lp[ours]:
                    sd[b + theirs + ".bias"] = V(lp[ours]["bias"])
                elif spec.arch == "opt" and spec.attention_bias and ours == "v":
                    # compression folds the v bias exactly into the o bias;
                    # OPT consumers (the reference's OPTRebuild too) build
                    # every Linear with bias=enable_bias, so the redundant
                    # v bias is written as zeros (the same function)
                    sd[b + theirs + ".bias"] = zeros(lp[ours])
        for ours, theirs in norm_names.items():
            sd[b + theirs + ".weight"] = V(lp[ours]["scale"])
            if "bias" in lp[ours]:
                sd[b + theirs + ".bias"] = V(lp[ours]["bias"])
        if "q_norm" in lp:
            sd[b + "self_attn.q_norm.weight"] = V(lp["q_norm"]["scale"])
            sd[b + "self_attn.k_norm.weight"] = V(lp["k_norm"]["scale"])
        if spec.is_moe_layer(l):
            # mixtral: block_sparse_moe.gate + experts.{e}.w1/w3/w2;
            # qwen3_moe / qwen2_moe: mlp.gate + experts.{e}.{gate,up,down}_proj
            # (+ qwen2_moe's shared_expert.* and shared_expert_gate)
            if spec.arch == "mixtral":
                moe_pre, enames = b + "block_sparse_moe.", ("w1", "w3", "w2")
            else:
                moe_pre, enames = b + "mlp.", ("gate_proj", "up_proj", "down_proj")
            sd[moe_pre + "gate.weight"] = W(lp["router"])
            ek = lp["experts"]
            for e in range(spec.n_experts):
                for ours, theirs in zip(("gate", "up", "down"), enames):
                    sd[f"{moe_pre}experts.{e}.{theirs}.weight"] = W({"kernel": ek[ours]["kernel"][e]})
            if "shared" in lp:
                for ours in ("gate", "up", "down"):
                    sd[moe_pre + f"shared_expert.{ours}_proj.weight"] = W(lp["shared"][ours])
                if "shared_gate" in lp:
                    sd[moe_pre + "shared_expert_gate.weight"] = W(lp["shared_gate"])
        if "rotary_mask" in lp:
            masks[l] = lp["rotary_mask"].detach().cpu()

    if params.get("lm_head") is not None:
        sd["lm_head.weight"] = W(params["lm_head"])
    return finish(sd, masks)
