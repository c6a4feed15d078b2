"""Static model specification with first-class heterogeneous per-layer ranks.

This replaces the reference's entire patcher layer
(reference: src/patchers/LlamaRebuild.py, OPTRebuild.py,
DenseQwenRebuild.py — ~2,500 LoC of vendored HF modeling code whose only
real delta is reading per-layer rank lists from the config). Here the
compressed architecture IS the config: a frozen, hashable dataclass that
can be used as a dict key or cache key.

A dense model has ``q_ranks[l] == n_heads * head_dim`` etc.; a compressed
model carries whatever ranks the solvers produced (reference:
src/adapters/LlamaAdapter.py:250-302 `patch_config`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["ModelSpec", "spec_from_hf_config"]

ARCHS = (
    "opt", "gpt2", "llama", "mistral", "qwen2", "qwen3", "mixtral", "qwen3_moe",
    "qwen2_moe", "gemma", "gemma2", "phi3", "starcoder2", "olmo2",
)


@dataclass(frozen=True)
class ModelSpec:
    arch: str
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_int: int
    max_position_embeddings: int
    act: str  # "silu" | "relu" | "gelu"
    norm: str  # "rmsnorm" | "layernorm"
    norm_eps: float
    rope_theta: Optional[float]
    attention_bias: bool
    mlp_bias: bool
    tie_word_embeddings: bool
    qk_norm: bool = False  # qwen3 per-head q/k RMSNorm
    gated_mlp: bool = True  # llama/qwen3; False for OPT's fc1/fc2
    do_layer_norm_before: bool = True  # OPT
    # Per-layer compressed output dims (HF rank-list semantics,
    # reference: LlamaAdapter.py:286-292). Dense models carry the full dims.
    q_ranks: Tuple[int, ...] = ()
    k_ranks: Tuple[int, ...] = ()
    v_ranks: Tuple[int, ...] = ()
    o_ranks: Tuple[int, ...] = ()
    gate_ranks: Tuple[int, ...] = ()
    has_rotary_masks: bool = False
    # qwen3 sliding-window plumbing (reference: DenseQwenRebuild.py:257-259)
    sliding_window: Optional[int] = None
    layer_types: Tuple[str, ...] = ()
    # OPT word-embedding projection dim (e.g. OPT-350m: 512 vs hidden 1024;
    # reference: OPTRebuild project_in/project_out handling)
    word_embed_proj_dim: Optional[int] = None
    # Mixture-of-experts (mixtral family). The reference carries only
    # vestigial MoE branches (SURVEY.md §2 "dead/vestigial"); here MoE is
    # first-class: per-expert Type-I solves share one rank per layer
    # (gate_ranks[l] applies to every expert of layer l), so expert
    # stacks stay uniform-shaped for batched execution.
    n_experts: int = 0  # 0 = dense MLP
    experts_per_tok: int = 2
    # Mixed stacks (qwen3_moe decoder_sparse_step / mlp_only_layers):
    # indices of the MoE layers; EMPTY means every layer is MoE when
    # n_experts > 0 (the canonical all-MoE case).
    moe_layers: Tuple[int, ...] = ()
    # Renormalise the top-k routing weights to sum to 1. Mixtral always
    # does; qwen3_moe gates it behind config.norm_topk_prob.
    norm_topk_prob: bool = True
    # RoPE frequency scaling (hashable tuple; see ops/rope.rope_cos_sin):
    # ("linear", factor) or ("llama3", factor, low_f, high_f, orig_len).
    rope_scaling: Optional[Tuple] = None
    # DeepSeek-style shared experts (qwen2_moe family; the reference's
    # vestigial DeepSeek/Mixtral branches hint at this shape,
    # src/patchers/patch.py:41-53): every MoE layer also runs one dense
    # gated MLP of intermediate size `shared_d_int` over ALL tokens, added
    # to the routed output. qwen2_moe additionally scales it by a sigmoid
    # scalar gate (`shared_expert_gate=True`); DeepSeek adds it plainly.
    shared_d_int: int = 0  # 0 = no shared expert
    shared_expert_gate: bool = False
    # Per-layer compressed shared-expert intermediate dims (the shared
    # expert is a dense MLP, so it gets its own Type-I rank). EMPTY means
    # dense (= shared_d_int on every MoE layer).
    shared_gate_ranks: Tuple[int, ...] = ()
    # olmo2: NO pre-norms — attention/MLP consume the raw residual
    # stream and only the post-sublayer norms (before the residual add)
    # exist; combined with post_norms=True this is the olmo2 wiring.
    pre_norms: bool = True
    # olmo2: q/k RMSNorm over the WHOLE projection output ([H*hd] /
    # [Hk*hd]) rather than per head (qwen3's qk_norm).
    flat_qk_norm: bool = False
    # gemma2: sandwich norms (post_attention + pre/post_feedforward),
    # attention-score and final-logit soft-capping (cap * tanh(x / cap)),
    # and a config-fixed attention scale (query_pre_attn_scalar**-0.5
    # instead of head_dim**-0.5 — kept fixed under compression).
    post_norms: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None

    # ---- derived helpers ----
    @property
    def uses_rope(self) -> bool:
        # learned-position archs; everything else is rotary
        return self.arch not in ("opt", "gpt2")

    @property
    def position_offset(self) -> int:
        """Learned-position index offset (OPT hardcodes 2, GPT-2 none)."""
        return 2 if self.arch == "opt" else 0

    @property
    def mixed_windows(self) -> bool:
        """True when layers disagree on sliding vs full attention
        (gemma2 alternates) — the scanned paths then carry the window
        as a per-layer input."""
        return bool(self.layer_types) and len(set(self.layer_types)) > 1

    def window_per_layer(self) -> Tuple[int, ...]:
        """Per-layer attention window, 0 = full attention. A sliding
        layer_type without a configured window degrades to full (matches
        the unrolled forward's `window = sliding_window if ...` -> None)."""
        w = self.sliding_window or 0
        return tuple(
            w if t == "sliding_attention" else 0 for t in self.layer_types
        )

    def is_moe_layer(self, layer: int) -> bool:
        return self.n_experts > 0 and (not self.moe_layers or layer in self.moe_layers)

    @property
    def mixed_moe(self) -> bool:
        """True when the stack mixes dense and MoE MLP layers
        (qwen3_moe mlp_only_layers / decoder_sparse_step)."""
        return (
            self.n_experts > 0
            and bool(self.moe_layers)
            and len(set(self.moe_layers)) != self.n_layers
        )

    def has_shared_expert(self, layer: int) -> bool:
        return self.shared_d_int > 0 and self.is_moe_layer(layer)

    def shared_rank(self, layer: int) -> int:
        """Compressed shared-expert intermediate dim for a layer (dense
        when no compressed ranks are recorded)."""
        if self.shared_gate_ranks:
            return self.shared_gate_ranks[layer]
        return self.shared_d_int

    @property
    def group_size(self) -> int:
        return self.n_heads // self.n_kv_heads

    def q_head_dim(self, layer: int) -> int:
        """Compressed per-head q/k dim (reference: LlamaRebuild.py:266)."""
        return self.q_ranks[layer] // self.n_heads

    def v_head_dim(self, layer: int) -> int:
        return self.v_ranks[layer] // self.n_kv_heads

    @property
    def is_uniform(self) -> bool:
        """True when all layers share the same shapes (scan-friendly)."""
        return all(
            len(set(r)) <= 1
            for r in (
                self.q_ranks,
                self.k_ranks,
                self.v_ranks,
                self.o_ranks,
                self.gate_ranks,
                self.shared_gate_ranks,
            )
        ) and not self.has_rotary_masks

    @property
    def is_dense(self) -> bool:
        qk = self.n_heads * self.head_dim
        kv = self.n_kv_heads * self.head_dim
        return (
            all(r == qk for r in self.q_ranks)
            and all(r == kv for r in self.k_ranks)
            and all(r == kv for r in self.v_ranks)
            and all(r == qk for r in self.o_ranks)
            and all(r == self.d_int for r in self.gate_ranks)
            and all(r == self.shared_d_int for r in self.shared_gate_ranks)
            and not self.has_rotary_masks
        )

    def with_ranks(
        self,
        q_ranks=None,
        k_ranks=None,
        v_ranks=None,
        o_ranks=None,
        gate_ranks=None,
        has_rotary_masks=None,
        shared_gate_ranks=None,
    ) -> "ModelSpec":
        kw = {}
        if shared_gate_ranks is not None:
            kw["shared_gate_ranks"] = tuple(shared_gate_ranks)
        if q_ranks is not None:
            kw["q_ranks"] = tuple(q_ranks)
        if k_ranks is not None:
            kw["k_ranks"] = tuple(k_ranks)
        if v_ranks is not None:
            kw["v_ranks"] = tuple(v_ranks)
        if o_ranks is not None:
            kw["o_ranks"] = tuple(o_ranks)
        if gate_ranks is not None:
            kw["gate_ranks"] = tuple(gate_ranks)
        if has_rotary_masks is not None:
            kw["has_rotary_masks"] = bool(has_rotary_masks)
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "ModelSpec":
        d = dict(d)
        for k in ("q_ranks", "k_ranks", "v_ranks", "o_ranks", "gate_ranks", "layer_types",
                  "rope_scaling", "moe_layers", "shared_gate_ranks"):
            if k in d and d[k] is not None:
                d[k] = tuple(d[k])
        return ModelSpec(**d)


def _parse_rope_scaling(rs) -> Optional[Tuple]:
    """HF rope_scaling dict -> hashable tuple (llama-3.1 and linear/PI)."""
    if not rs:
        return None
    kind = rs.get("rope_type", rs.get("type", ""))
    if kind in ("default", ""):
        return None
    if kind == "linear":
        return ("linear", float(rs["factor"]))
    if kind == "llama3":
        return (
            "llama3",
            float(rs["factor"]),
            float(rs["low_freq_factor"]),
            float(rs["high_freq_factor"]),
            float(rs["original_max_position_embeddings"]),
        )
    raise ValueError(f"unsupported rope_scaling type {kind!r} (supported: linear, llama3)")


def _dense_ranks(n_layers, qk, kv, d_int):
    return dict(
        q_ranks=(qk,) * n_layers,
        k_ranks=(kv,) * n_layers,
        v_ranks=(kv,) * n_layers,
        o_ranks=(qk,) * n_layers,
        gate_ranks=(d_int,) * n_layers,
    )


def spec_from_hf_config(config) -> ModelSpec:
    """Build a ModelSpec from a HuggingFace PretrainedConfig.

    Mirrors the reference's arch sniffing (src/adapters/model_adapter.py:118-135)
    and its dimension properties (model_adapter.py:253-307). If the config
    carries compressed rank lists (a model previously saved by this
    framework or by the reference's patch_config), they are honoured.
    """
    model_type = getattr(config, "model_type", "")
    if model_type == "gpt2":
        # GPT-2: learned positions (no offset), pre-LN LayerNorm blocks,
        # fused Conv1D projections (split by the loader), gelu_new,
        # biases everywhere, MHA, tied embeddings. The reference carries
        # only a dead GPT-2 branch (compression_utils.py:58-76).
        # fail loudly on attention variants we don't implement rather
        # than silently producing wrong logits
        if not getattr(config, "scale_attn_weights", True):
            raise ValueError("gpt2 with scale_attn_weights=False is unsupported")
        if getattr(config, "scale_attn_by_inverse_layer_idx", False):
            raise ValueError("gpt2 with scale_attn_by_inverse_layer_idx is unsupported")
        n_heads = config.n_head
        head_dim = config.n_embd // n_heads
        n_layers = config.n_layer
        d_int = config.n_inner or 4 * config.n_embd
        ranks = _dense_ranks(n_layers, n_heads * head_dim, n_heads * head_dim, d_int)
        spec = ModelSpec(
            arch="gpt2",
            vocab_size=config.vocab_size,
            d_model=config.n_embd,
            n_layers=n_layers,
            n_heads=n_heads,
            n_kv_heads=n_heads,
            head_dim=head_dim,
            d_int=d_int,
            max_position_embeddings=config.n_positions,
            act=config.activation_function,
            norm="layernorm",
            norm_eps=config.layer_norm_epsilon,
            rope_theta=None,
            attention_bias=True,
            mlp_bias=True,
            tie_word_embeddings=config.tie_word_embeddings,
            gated_mlp=False,
            **ranks,
        )
    elif model_type == "opt":
        n_heads = config.num_attention_heads
        head_dim = config.hidden_size // n_heads
        n_layers = config.num_hidden_layers
        qk = n_heads * head_dim
        ranks = _dense_ranks(n_layers, qk, qk, config.ffn_dim)
        wepd = getattr(config, "word_embed_proj_dim", config.hidden_size)
        spec = ModelSpec(
            arch="opt",
            vocab_size=config.vocab_size,
            d_model=config.hidden_size,
            n_layers=n_layers,
            n_heads=n_heads,
            n_kv_heads=n_heads,
            head_dim=head_dim,
            d_int=config.ffn_dim,
            max_position_embeddings=config.max_position_embeddings,
            act="relu" if config.activation_function == "relu" else config.activation_function,
            norm="layernorm",
            norm_eps=1e-5,
            rope_theta=None,
            attention_bias=getattr(config, "enable_bias", True),
            mlp_bias=getattr(config, "enable_bias", True),
            tie_word_embeddings=config.tie_word_embeddings,
            gated_mlp=False,
            do_layer_norm_before=getattr(config, "do_layer_norm_before", True),
            word_embed_proj_dim=wepd if wepd != config.hidden_size else None,
            **ranks,
        )
    elif (
        model_type
        in (
            "llama", "mistral", "qwen2", "qwen3", "mixtral", "qwen3_moe",
            "qwen2_moe", "gemma", "gemma2", "phi3", "starcoder2", "olmo2",
        )
        or "qwen3" in model_type
    ):
        if model_type in ("qwen3_moe", "qwen2_moe"):
            arch = model_type
        elif "qwen3" in model_type:
            arch = "qwen3"
        else:
            arch = model_type
        is_moe = arch in ("mixtral", "qwen3_moe", "qwen2_moe")
        moe_layer_ids = ()
        if arch in ("qwen3_moe", "qwen2_moe"):
            # HF rule (Qwen3MoeDecoderLayer.__init__, same in Qwen2Moe):
            # layer l is sparse iff l not in mlp_only_layers and
            # (l+1) % decoder_sparse_step == 0.
            only = set(getattr(config, "mlp_only_layers", []) or [])
            step_ = getattr(config, "decoder_sparse_step", 1)
            moe_layer_ids = tuple(
                l
                for l in range(config.num_hidden_layers)
                if l not in only and (l + 1) % step_ == 0
            )
            if not moe_layer_ids:
                raise ValueError(f"{arch} config with no sparse layers")
            d_int = config.moe_intermediate_size
        else:
            d_int = config.intermediate_size
        n_heads = config.num_attention_heads
        n_kv = getattr(config, "num_key_value_heads", n_heads)
        head_dim = getattr(config, "head_dim", None) or config.hidden_size // n_heads
        n_layers = config.num_hidden_layers
        ranks = _dense_ranks(n_layers, n_heads * head_dim, n_kv * head_dim, d_int)
        if arch in ("qwen3_moe", "qwen2_moe") and len(moe_layer_ids) != n_layers:
            # mixed stack: dense layers use the DENSE intermediate size
            ranks["gate_ranks"] = tuple(
                d_int if l in moe_layer_ids else config.intermediate_size
                for l in range(n_layers)
            )
        if arch in ("gemma", "gemma2"):
            # HF forces the tanh GELU regardless of older configs saying
            # "gelu" (modeling_gemma GemmaMLP + config.hidden_activation).
            act = getattr(config, "hidden_activation", None) or "gelu_pytorch_tanh"
        else:
            act = config.hidden_act
        if arch == "phi3" and getattr(config, "partial_rotary_factor", 1.0) != 1.0:
            raise ValueError("phi3 with partial_rotary_factor != 1.0 is unsupported")
        spec = ModelSpec(
            arch=arch,
            vocab_size=config.vocab_size,
            d_model=config.hidden_size,
            n_layers=n_layers,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_int=d_int,
            max_position_embeddings=config.max_position_embeddings,
            act=act,
            # gemma's RMSNorm multiplies by (1 + weight) in float32;
            # starcoder2 is the one rotary arch with biased LayerNorm
            norm="rmsnorm_1p"
            if arch in ("gemma", "gemma2")
            else "layernorm"
            if arch == "starcoder2"
            else "rmsnorm",
            norm_eps=getattr(config, "norm_epsilon", 1e-5)
            if arch == "starcoder2"
            else config.rms_norm_eps,
            rope_theta=getattr(config, "rope_theta", 10000.0),
            # qwen2/qwen2_moe hardcode q/k/v biases (o bias-free) in their
            # attention modules rather than exposing a config flag;
            # starcoder2's use_bias covers attention AND mlp (incl. o).
            attention_bias=True
            if arch in ("qwen2", "qwen2_moe")
            else getattr(config, "use_bias", True)
            if arch == "starcoder2"
            else getattr(config, "attention_bias", False),
            mlp_bias=getattr(config, "use_bias", True)
            if arch == "starcoder2"
            else getattr(config, "mlp_bias", False),
            tie_word_embeddings=config.tie_word_embeddings,
            qk_norm=arch in ("qwen3", "qwen3_moe"),
            gated_mlp=arch != "starcoder2",
            # qwen2/qwen3/qwen2_moe gate their window behind
            # use_sliding_window; mistral/mixtral apply
            # config.sliding_window whenever it is set (HF mask_function
            # selection); gemma2 alternates sliding/full layers via
            # layer_types with the window always on.
            sliding_window=getattr(config, "sliding_window", None)
            if (
                getattr(config, "use_sliding_window", False)
                or arch in ("mistral", "mixtral", "gemma2", "phi3", "starcoder2")
            )
            else None,
            # explicit config.layer_types wins; mistral/mixtral without one
            # slide on EVERY layer when a window is set; gemma2 alternates
            # (even layers slide — HF pre-layer_types rule
            # `not bool(layer_idx % 2)`)
            layer_types=tuple(getattr(config, "layer_types", ()) or ())
            or (
                ("sliding_attention",) * n_layers
                if arch in ("mistral", "mixtral", "phi3", "starcoder2")
                and getattr(config, "sliding_window", None)
                else tuple(
                    "sliding_attention" if l % 2 == 0 else "full_attention"
                    for l in range(n_layers)
                )
                if arch == "gemma2" and getattr(config, "sliding_window", None)
                # older qwen-family configs (pre-layer_types transformers)
                # gate the window per layer: l >= max_window_layers slides
                # (modern Qwen*Config synthesizes this same list in
                # __init__; reproduce it when only the knobs are present)
                else tuple(
                    "sliding_attention"
                    if l >= getattr(config, "max_window_layers", 0)
                    else "full_attention"
                    for l in range(n_layers)
                )
                if arch in ("qwen2", "qwen2_moe", "qwen3", "qwen3_moe")
                and getattr(config, "use_sliding_window", False)
                and getattr(config, "sliding_window", None)
                else ()
            ),
            n_experts=(
                getattr(config, "num_local_experts", 0)
                if arch == "mixtral"
                else getattr(config, "num_experts", 0)
                if arch in ("qwen3_moe", "qwen2_moe")
                else 0
            ),
            experts_per_tok=getattr(config, "num_experts_per_tok", 2),
            norm_topk_prob=bool(getattr(config, "norm_topk_prob", True))
            if arch in ("qwen3_moe", "qwen2_moe")
            else True,
            moe_layers=moe_layer_ids
            if (arch in ("qwen3_moe", "qwen2_moe") and len(moe_layer_ids) != n_layers)
            else (),
            rope_scaling=_parse_rope_scaling(getattr(config, "rope_scaling", None)),
            shared_d_int=getattr(config, "shared_expert_intermediate_size", 0)
            if arch == "qwen2_moe"
            else 0,
            shared_expert_gate=arch == "qwen2_moe",
            post_norms=arch in ("gemma2", "olmo2"),
            pre_norms=arch != "olmo2",
            flat_qk_norm=arch == "olmo2",
            attn_logit_softcap=getattr(config, "attn_logit_softcapping", None)
            if arch == "gemma2"
            else None,
            final_logit_softcap=getattr(config, "final_logit_softcapping", None)
            if arch == "gemma2"
            else None,
            query_pre_attn_scalar=float(config.query_pre_attn_scalar)
            if arch == "gemma2"
            else None,
            **ranks,
        )
    else:
        raise ValueError(f"Unsupported architecture: {model_type!r}")

    # Honour compressed rank lists if present (reference: LlamaAdapter.py:288-292).
    if getattr(config, "q_ranks", None):
        spec = spec.with_ranks(
            q_ranks=config.q_ranks,
            k_ranks=config.k_ranks,
            v_ranks=config.v_ranks,
            o_ranks=config.o_ranks,
            gate_ranks=config.gate_ranks,
            has_rotary_masks=getattr(config, "mask_path", None) is not None,
            shared_gate_ranks=getattr(config, "shared_gate_ranks", None),
        )
    return spec
