"""Compressed-model persistence: per-layer factor store + final artifact.

Port of ``modegpt_tpu.compress.artifact``. The on-disk formats are the
JAX package's, so an artifact written by either package loads in the
other, MoE ones included (``layers/3/experts/up/kernel`` [E, d, r],
``layers/3/router``, ``layers/3/shared/...``, ``layers/3/shared_gate``):

* the factor store: one ``layer_{i}_{suffix}.npz`` per layer and solver
  (the reference's temp store names, model_adapter.py:184-191);
* the artifact: ``spec.json`` (the ModelSpec plus a per-leaf dtype map),
  a flat ``params.npz`` keyed by the tree path (``layers/3/q/kernel``;
  a None leaf is stored as ``<path>::none``), and
  ``tokenizer_source.txt``. bfloat16 leaves are stored as their uint16
  bit pattern, since npz has no bfloat16.

Quantised storage (``dtype="int8" | "int4" | "nf4"``) stores projection
kernels and embeddings weight-only, byte for byte as the JAX package
does: int8 codes with a keepdims float32 ``<key>::scale`` (symmetric per
out-channel, the max-abs over the IN axis); int4 codes in [-7, 7] as
code + 8, packed two a byte over the flattened leaf (element 2i in the
low nibble), with its ``<key>::shape``; nf4 as 64-value blocks scaled by
their max-abs and mapped to the nearest of the 16 QLoRA NormalFloat
levels, packed the same way, one scale a block. The quantisers run in
torch on the leaf's device (the division is kept a true division,
`forward.true_div`, and NF4's distances are taken over bounded chunks of
blocks), and their bytes equal the JAX package's numpy ones. A
quantised artifact reloads dequantised to float32, or with
``resident_int8`` keeps its int8 or int4 ``kernel`` leaves resident
(`models.quantize`).

The orbax backend (``backend="orbax"``, float32 or bfloat16 storage)
keeps the parameters as an orbax checkpoint under ``params_orbax/``
(`compress.orbax_format`, written and read without orbax) beside a
``spec.json`` with ``"backend": "orbax"`` and an empty dtype map.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from modegpt_tpu_torch.compress import orbax_format
from modegpt_tpu_torch.models.convert import to_tensor
from modegpt_tpu_torch.models.forward import check_supported, column_major, pack_int4, true_div
from modegpt_tpu_torch.models.spec import ModelSpec
from modegpt_tpu_torch.utils.device import DeviceLike, resolve_device

__all__ = [
    "save_layer_factors",
    "load_layer_factors",
    "save_compressed_model",
    "load_compressed_model",
]

_FORMAT_VERSION = 1
_QUANTISED = ("int8", "int4", "nf4")
_STORAGE_DTYPES = ("float32", "bfloat16") + _QUANTISED


def _factor_path(output_dir: str, layer_idx: int, suffix: str) -> str:
    return os.path.join(os.path.expandvars(output_dir), f"layer_{layer_idx}_{suffix}.npz")


def _host(a) -> np.ndarray:
    """Tensor or array -> numpy; bfloat16 becomes float32 (lossless)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.to(torch.float32) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def save_layer_factors(output_dir: str, layer_idx: int, suffix: str, factors: Dict) -> str:
    """Persist one layer's solver factors (suffix in mlp|qk|vo)."""
    os.makedirs(os.path.expandvars(output_dir), exist_ok=True)
    path = _factor_path(output_dir, layer_idx, suffix)
    np.savez(path, **{k: _host(v) for k, v in factors.items() if v is not None})
    return path


def load_layer_factors(output_dir: str, layer_idx: int, suffix: str) -> Optional[Dict[str, np.ndarray]]:
    """One layer's factors as numpy, or None if not yet solved (resume)."""
    path = _factor_path(output_dir, layer_idx, suffix)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _flatten(tree, prefix: str = "") -> Dict[str, Optional[torch.Tensor]]:
    out: Dict = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is None:
        out[prefix[:-1] + "::none"] = None
    else:
        out[prefix[:-1]] = tree
    return out


def _as_tensor(t) -> torch.Tensor:
    return t.detach() if isinstance(t, torch.Tensor) else torch.as_tensor(np.asarray(t))


def _to_storage(t, storage: str):
    """Leaf -> (numpy array as stored, dtype name for the sidecar). A None
    leaf is an empty float leaf, as the JAX package stores it."""
    t = torch.zeros(0, dtype=torch.float64) if t is None else _as_tensor(t).cpu()
    if t.is_floating_point():
        if storage == "bfloat16":
            return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16), "bfloat16"
        t = t.to(torch.float32)
    a = t.numpy()
    return a, str(a.dtype)


def _is_weight_key(key: str) -> bool:
    """Leaves worth quantising: projection kernels and the (un)embedding.
    Norm scales, biases and rotary masks stay full precision."""
    leaf = key.rsplit("/", 1)[-1]
    return leaf == "kernel" or leaf in ("embed_tokens", "embed_positions")


def _absmax_scale(af: torch.Tensor, levels: float) -> torch.Tensor:
    """Per-out-channel symmetric scale, keepdims: the max-abs over the IN
    axis (-2; a 1-D leaf scales whole) / levels, 1 where that is 0."""
    dim = -2 if af.dim() >= 2 else 0
    scale = true_div(torch.amax(torch.abs(af), dim=dim, keepdim=True), levels)
    return torch.where(scale == 0.0, torch.ones_like(scale), scale)


def _quantize_int8(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-out-channel int8 (JAX artifact.py:101): codes and the
    keepdims float32 scale, on a's device."""
    af = a.to(torch.float32)
    scale = _absmax_scale(af, 127.0)
    return torch.clamp(torch.round(af / scale), -127, 127).to(torch.int8), scale


def _pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """Flatten unsigned 4-bit codes [0, 15] and pack two a byte (element
    2i in the low nibble)."""
    flat = codes.reshape(-1).to(torch.uint8)
    if flat.numel() % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    return flat[0::2] | (flat[1::2] << 4)


def _unpack_nibbles(packed: torch.Tensor, size: int) -> torch.Tensor:
    return torch.stack([packed & 0x0F, packed >> 4], dim=-1).reshape(-1)[:size]


def _quantize_int4(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, ...]]:
    """Symmetric per-out-channel int4 in [-7, 7] (scale axes as int8),
    stored as code + 8 packed two a byte."""
    af = a.to(torch.float32)
    scale = _absmax_scale(af, 7.0)
    q = torch.clamp(torch.round(af / scale), -7, 7).to(torch.int8)
    return _pack_nibbles(q + 8), scale, tuple(af.shape)


# The QLoRA NF4 codebook: 16 quantiles of a standard normal, normalised
# to [-1, 1] (Dettmers et al., 2023, "QLoRA", Appendix E).
_NF4_CODE = np.array(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    dtype=np.float32,
)
_NF4_BLOCK = 64
# NF4 blocks quantised at a time: the [blocks, 64, 16] float32 distances
# take 256 MiB at 65536 blocks, where the whole 128256 x 4096 Llama-3
# embedding at once would take 33.6 GB.
_NF4_CHUNK_BLOCKS = 65536


def _quantize_nf4(a: torch.Tensor, chunk_blocks: int = _NF4_CHUNK_BLOCKS):
    """Blockwise NF4 (JAX artifact.py:165): each 64-value block scaled by
    its max-abs (1 where that is 0) and mapped to the nearest NF4 level
    (the first on a tie, as ``np.argmin``), the codes packed two a byte.
    Returns (packed uint8, scales [blocks] float32, shape)."""
    af = a.to(torch.float32)
    flat = af.reshape(-1)
    pad = (-flat.numel()) % _NF4_BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.view(-1, _NF4_BLOCK)
    absmax = torch.amax(torch.abs(blocks), dim=1, keepdim=True)
    absmax = torch.where(absmax == 0.0, torch.ones_like(absmax), absmax)
    code = torch.from_numpy(_NF4_CODE).to(af.device)
    codes = torch.empty(blocks.shape, dtype=torch.uint8, device=af.device)
    for b0 in range(0, blocks.shape[0], chunk_blocks):
        normed = blocks[b0 : b0 + chunk_blocks] / absmax[b0 : b0 + chunk_blocks]
        codes[b0 : b0 + chunk_blocks] = torch.argmin(torch.abs(normed[..., None] - code), dim=-1)
    return _pack_nibbles(codes), absmax.reshape(-1), tuple(af.shape)


def _dequantize_nf4(packed: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    size = int(np.prod(shape))
    codes = _unpack_nibbles(packed, scale.numel() * _NF4_BLOCK)
    levels = torch.from_numpy(_NF4_CODE).to(packed.device)
    vals = levels.index_select(0, codes.to(torch.int32)).view(-1, _NF4_BLOCK) * scale[:, None]
    return vals.reshape(-1)[:size].reshape(shape)


def _quantise_leaf(key: str, leaf: torch.Tensor, dtype: str, stored: Dict, dtypes: Dict) -> None:
    """Store one weight leaf quantised, with its sidecar leaves, in the
    JAX package's key order."""
    if dtype == "int8":
        q, scale = _quantize_int8(leaf)
    else:
        q, scale, shape = (_quantize_int4 if dtype == "int4" else _quantize_nf4)(leaf)
        stored[key + "::shape"] = np.asarray(shape, np.int64)
        dtypes[key + "::shape"] = "int64"
    stored[key] = q.cpu().numpy()
    stored[key + "::scale"] = scale.cpu().numpy()
    dtypes[key] = dtype
    dtypes[key + "::scale"] = "float32"


def save_compressed_model(
    save_dir: str,
    spec: ModelSpec,
    params: Dict,
    tokenizer_source: str = "",
    metadata: Optional[Dict] = None,
    dtype: str = "float32",
    backend: str = "npz",
) -> str:
    """Write the artifact: spec.json + params.npz (or params_orbax/) +
    tokenizer_source.txt.

    dtype: "float32" or "bfloat16" (floating leaves; integer leaves keep
    their dtype), or "int8", "int4" or "nf4": projection kernels and
    embeddings quantised weight-only (~4x, ~8x and ~8x smaller than
    float32), every other floating leaf float32. backend: "npz" (one
    file, every dtype) or "orbax" (an orbax checkpoint; float32 and
    bfloat16 only, as in the JAX package).
    """
    if backend not in ("npz", "orbax"):
        raise ValueError(f"artifact backend must be npz or orbax, got {backend!r}")
    if dtype not in _STORAGE_DTYPES:
        raise ValueError(f"storage dtype must be one of {', '.join(_STORAGE_DTYPES)}, got {dtype!r}")
    if backend == "orbax" and dtype in _QUANTISED:
        raise ValueError(f"{dtype} quantization is supported by the npz backend only")
    os.makedirs(save_dir, exist_ok=True)
    if backend == "orbax":
        target = torch.bfloat16 if dtype == "bfloat16" else torch.float32

        def cast(tree):
            if isinstance(tree, dict):
                return {k: cast(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return [cast(v) for v in tree]
            if tree is None:
                return None
            t = _as_tensor(tree)
            return t.to(target) if t.is_floating_point() else t

        orbax_format.save_tree(os.path.abspath(os.path.join(save_dir, "params_orbax")), cast(params))
        _write_sidecar(save_dir, spec, {}, dtype, metadata, tokenizer_source, backend="orbax")
        return save_dir
    stored, dtypes = {}, {}
    for key, leaf in _flatten(params).items():
        if dtype in _QUANTISED and leaf is not None and _is_weight_key(key):
            t = _as_tensor(leaf)
            if t.is_floating_point():
                _quantise_leaf(key, t, dtype, stored, dtypes)
                continue
        stored[key], dtypes[key] = _to_storage(leaf, dtype)
    np.savez(os.path.join(save_dir, "params.npz"), **stored)
    _write_sidecar(save_dir, spec, dtypes, dtype, metadata, tokenizer_source)
    return save_dir


def _write_sidecar(save_dir: str, spec: ModelSpec, dtypes: Dict, dtype: str, metadata: Optional[Dict],
                   tokenizer_source: str, backend: Optional[str] = None) -> None:
    """spec.json (the JAX package's keys; "backend" only for orbax) and
    tokenizer_source.txt."""
    sidecar = {
        "format_version": _FORMAT_VERSION,
        "spec": spec.to_dict(),
        "dtypes": dtypes,
        "storage_dtype": dtype,
        **({"backend": backend} if backend else {}),
        "metadata": metadata or {},
    }
    with open(os.path.join(save_dir, "spec.json"), "w") as f:
        json.dump(sidecar, f, indent=2)
    with open(os.path.join(save_dir, "tokenizer_source.txt"), "w") as f:
        f.write(tokenizer_source.strip())


def _unflatten(flat: Dict, n_layers: int) -> Dict:
    tree: Dict = {}
    for key, val in flat.items():
        if key.endswith("::none"):
            key, val = key[: -len("::none")], None
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    if "layers" in tree:
        tree["layers"] = [tree["layers"][str(i)] for i in range(n_layers)]
    return tree


def _resident_scale(s: torch.Tensor) -> torch.Tensor:
    """A stored keepdims scale ([..., 1, out]) in the forward's shape
    ([out]; [E, out] for expert stacks); a flat [out] passes through."""
    return s.squeeze(-2) if s.dim() >= 2 else s


def load_compressed_model(save_dir: str, device: DeviceLike = "cuda", resident_int8: bool = False):
    """Load (spec, params, tokenizer_source) from an artifact directory,
    with the parameters on ``device``. Every leaf's shape is checked
    against the spec; a mismatch raises with the parameter's name.

    Quantised leaves are dequantised to float32 on the device, the JAX
    package's values bit for bit. ``resident_int8``: an int8 or int4
    artifact keeps its ``kernel`` leaves quantised, as ``kernel_q`` (int8
    codes, or int4 packed two a byte, `models.quantize`) plus ``scale``
    ([out], or [E, out] for expert stacks), which the forward consumes
    directly; a router's kernel too, as in the JAX package. Embeddings
    and nf4 always dequantise. An orbax artifact (float32 or bfloat16,
    never quantised) loads its checkpoint's leaves as they were saved."""
    dev = resolve_device(device)
    with open(os.path.join(save_dir, "spec.json")) as f:
        sidecar = json.load(f)
    if sidecar["format_version"] > _FORMAT_VERSION:
        raise ValueError(f"artifact written by a newer format: {sidecar['format_version']}")
    spec = ModelSpec.from_dict(sidecar["spec"])
    check_supported(spec)
    backend = sidecar.get("backend", "npz")
    if backend == "orbax":
        params = orbax_format.load_tree(os.path.abspath(os.path.join(save_dir, "params_orbax")), dev)
        params.setdefault("lm_head", None)
        if isinstance(params.get("layers"), dict):
            params["layers"] = [params["layers"][str(i)] for i in range(spec.n_layers)]
        _validate_shapes(spec, params)
        return spec, params, _read_tokenizer_source(save_dir)
    if backend != "npz":
        raise ValueError(f"unknown artifact backend {backend!r}")
    flat = {}
    with np.load(os.path.join(save_dir, "params.npz")) as z:
        for key in z.files:
            if key.endswith("::scale") or key.endswith("::shape"):
                continue
            kdt = sidecar["dtypes"].get(key)
            if key.endswith("::none"):
                flat[key] = None
            elif kdt in _QUANTISED:
                codes = to_tensor(z[key], dev)
                scale = to_tensor(z[key + "::scale"], dev)
                if kdt == "nf4":
                    flat[key] = _dequantize_nf4(codes, scale, tuple(int(n) for n in z[key + "::shape"]))
                    continue
                if kdt == "int4":
                    shape = tuple(int(n) for n in z[key + "::shape"])
                    codes = (_unpack_nibbles(codes, int(np.prod(shape))).to(torch.int8) - 8).view(shape)
                if resident_int8 and key.rsplit("/", 1)[-1] == "kernel":
                    base = key[: -len("kernel")]
                    flat[base + "kernel_q"] = pack_int4(codes) if kdt == "int4" else column_major(codes)
                    flat[base + "scale"] = _resident_scale(scale)
                else:
                    flat[key] = codes.to(torch.float32) * scale
            elif kdt == "bfloat16":
                flat[key] = torch.from_numpy(z[key].view(np.int16).copy()).view(torch.bfloat16).to(dev)
            else:
                flat[key] = to_tensor(z[key], dev)
    params = _unflatten(flat, spec.n_layers)
    params.setdefault("lm_head", None)
    _validate_shapes(spec, params)
    return spec, params, _read_tokenizer_source(save_dir)


def _read_tokenizer_source(save_dir: str) -> str:
    path = os.path.join(save_dir, "tokenizer_source.txt")
    if os.path.exists(path):
        with open(path) as f:
            return f.read().strip()
    return ""


def _validate_shapes(spec: ModelSpec, params: Dict) -> None:
    def check(name, got, want):
        if tuple(got) != tuple(want):
            raise ValueError(f"shape mismatch for {name}: got {tuple(got)}, want {tuple(want)}")

    def kern(p):
        """The kernel's [..., in, out] shape: float, int8-resident, or
        packed int4 (its true width is the scale's)."""
        if "kernel" in p:
            return tuple(p["kernel"].shape)
        return tuple(p["kernel_q"].shape[:-1]) + (p["scale"].shape[-1],)

    emb_dim = spec.word_embed_proj_dim or spec.d_model
    check("embed_tokens", params["embed_tokens"].shape, (spec.vocab_size, emb_dim))
    for l, lp in enumerate(params["layers"]):
        check(f"layers/{l}/q", kern(lp["q"]), (spec.d_model, spec.q_ranks[l]))
        check(f"layers/{l}/k", kern(lp["k"]), (spec.d_model, spec.k_ranks[l]))
        check(f"layers/{l}/v", kern(lp["v"]), (spec.d_model, spec.v_ranks[l]))
        check(f"layers/{l}/o", kern(lp["o"]), (spec.o_ranks[l], spec.d_model))
        if spec.is_moe_layer(l):
            E, r, d = spec.n_experts, spec.gate_ranks[l], spec.d_model
            check(f"layers/{l}/router", kern(lp["router"]), (d, E))
            for name, want in (("gate", (E, d, r)), ("up", (E, d, r)), ("down", (E, r, d))):
                check(f"layers/{l}/experts/{name}", kern(lp["experts"][name]), want)
            if spec.shared_d_int:
                rs = spec.shared_rank(l)
                for name, want in (("gate", (d, rs)), ("up", (d, rs)), ("down", (rs, d))):
                    check(f"layers/{l}/shared/{name}", kern(lp["shared"][name]), want)
                if spec.shared_expert_gate:
                    check(f"layers/{l}/shared_gate", kern(lp["shared_gate"]), (d, 1))
        else:
            check(f"layers/{l}/up", kern(lp["up"]), (spec.d_model, spec.gate_ranks[l]))
            check(f"layers/{l}/down", kern(lp["down"]), (spec.gate_ranks[l], spec.d_model))
        if "rotary_mask" in lp:
            check(
                f"layers/{l}/rotary_mask",
                lp["rotary_mask"].shape,
                (spec.n_kv_heads, spec.k_ranks[l] // spec.n_kv_heads),
            )
