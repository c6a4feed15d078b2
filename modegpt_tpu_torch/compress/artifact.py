"""Compressed-model persistence: per-layer factor store + final artifact.

Port of ``modegpt_tpu.compress.artifact``, npz backend, float32 and
bfloat16 storage. The on-disk format is the JAX package's, so an
artifact written by either package loads in the other:

* the factor store: one ``layer_{i}_{suffix}.npz`` per layer and solver
  (the reference's temp store names, model_adapter.py:184-191);
* the artifact: ``spec.json`` (the ModelSpec plus a per-leaf dtype map),
  a flat ``params.npz`` keyed by the tree path (``layers/3/q/kernel``;
  a None leaf is stored as ``<path>::none``), and
  ``tokenizer_source.txt``. bfloat16 leaves are stored as their uint16
  bit pattern, since npz has no bfloat16.

The quantised storage dtypes (int8, int4, nf4) and the orbax backend are
not ported.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from modegpt_tpu_torch.models.convert import to_tensor
from modegpt_tpu_torch.models.forward import check_supported
from modegpt_tpu_torch.models.spec import ModelSpec
from modegpt_tpu_torch.utils.device import DeviceLike, resolve_device

__all__ = [
    "save_layer_factors",
    "load_layer_factors",
    "save_compressed_model",
    "load_compressed_model",
]

_FORMAT_VERSION = 1
_STORAGE_DTYPES = ("float32", "bfloat16")


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


def _to_storage(t, storage: str):
    """Leaf -> (numpy array as stored, dtype name for the sidecar)."""
    if t is None:
        return np.zeros(0), "float64"
    t = t if isinstance(t, torch.Tensor) else torch.as_tensor(np.asarray(t))
    t = t.detach().cpu()
    if t.is_floating_point():
        if storage == "bfloat16":
            return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16), "bfloat16"
        t = t.to(torch.float32)
    a = t.numpy()
    return a, str(a.dtype)


def save_compressed_model(
    save_dir: str,
    spec: ModelSpec,
    params: Dict,
    tokenizer_source: str = "",
    metadata: Optional[Dict] = None,
    dtype: str = "float32",
    backend: str = "npz",
) -> str:
    """Write the artifact: spec.json + params.npz + tokenizer_source.txt.

    dtype: "float32" or "bfloat16" (floating leaves; integer leaves keep
    their dtype). backend: "npz".
    """
    if backend != "npz":
        raise NotImplementedError(
            f"modegpt_tpu_torch.compress.artifact: backend {backend!r} is not ported (npz only)"
        )
    if dtype not in _STORAGE_DTYPES:
        raise NotImplementedError(
            f"modegpt_tpu_torch.compress.artifact: storage dtype {dtype!r} is not ported "
            f"({', '.join(_STORAGE_DTYPES)} only)"
        )
    os.makedirs(save_dir, exist_ok=True)
    stored, dtypes = {}, {}
    for key, leaf in _flatten(params).items():
        stored[key], dtypes[key] = _to_storage(leaf, dtype)
    np.savez(os.path.join(save_dir, "params.npz"), **stored)
    sidecar = {
        "format_version": _FORMAT_VERSION,
        "spec": spec.to_dict(),
        "dtypes": dtypes,
        "storage_dtype": dtype,
        "metadata": metadata or {},
    }
    with open(os.path.join(save_dir, "spec.json"), "w") as f:
        json.dump(sidecar, f, indent=2)
    with open(os.path.join(save_dir, "tokenizer_source.txt"), "w") as f:
        f.write(tokenizer_source.strip())
    return save_dir


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


def load_compressed_model(save_dir: str, device: DeviceLike = "cuda"):
    """Load (spec, params, tokenizer_source) from an artifact directory,
    with the parameters on ``device``. Every leaf's shape is checked
    against the spec; a mismatch raises with the parameter's name."""
    dev = resolve_device(device)
    with open(os.path.join(save_dir, "spec.json")) as f:
        sidecar = json.load(f)
    if sidecar["format_version"] > _FORMAT_VERSION:
        raise ValueError(f"artifact written by a newer format: {sidecar['format_version']}")
    if sidecar.get("backend", "npz") != "npz":
        raise NotImplementedError(
            f"modegpt_tpu_torch.compress.artifact: backend {sidecar['backend']!r} is not ported"
        )
    if sidecar.get("storage_dtype", "float32") not in _STORAGE_DTYPES:
        raise NotImplementedError(
            f"modegpt_tpu_torch.compress.artifact: storage dtype "
            f"{sidecar['storage_dtype']!r} is not ported"
        )
    spec = ModelSpec.from_dict(sidecar["spec"])
    check_supported(spec)
    flat = {}
    with np.load(os.path.join(save_dir, "params.npz")) as z:
        for key in z.files:
            kdt = sidecar["dtypes"].get(key)
            if key.endswith("::none"):
                flat[key] = None
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

    emb_dim = spec.word_embed_proj_dim or spec.d_model
    check("embed_tokens", params["embed_tokens"].shape, (spec.vocab_size, emb_dim))
    for l, lp in enumerate(params["layers"]):
        check(f"layers/{l}/q", lp["q"]["kernel"].shape, (spec.d_model, spec.q_ranks[l]))
        check(f"layers/{l}/k", lp["k"]["kernel"].shape, (spec.d_model, spec.k_ranks[l]))
        check(f"layers/{l}/v", lp["v"]["kernel"].shape, (spec.d_model, spec.v_ranks[l]))
        check(f"layers/{l}/o", lp["o"]["kernel"].shape, (spec.o_ranks[l], spec.d_model))
        check(f"layers/{l}/up", lp["up"]["kernel"].shape, (spec.d_model, spec.gate_ranks[l]))
        check(f"layers/{l}/down", lp["down"]["kernel"].shape, (spec.gate_ranks[l], spec.d_model))
        if "rotary_mask" in lp:
            check(
                f"layers/{l}/rotary_mask",
                lp["rotary_mask"].shape,
                (spec.n_kv_heads, spec.k_ranks[l] // spec.n_kv_heads),
            )
