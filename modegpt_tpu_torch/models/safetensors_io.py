"""Direct safetensors checkpoint ingestion: no model instantiation.

Port of ``modegpt_tpu.models.safetensors_io``. `models/hf.load_hf_model`
otherwise builds the whole torch module through
``AutoModelForCausalLM.from_pretrained`` (twice the peak host memory, and
slow from 7B up). This loader reads the safetensors shards directly into
the port's parameter tree in one pass, each tensor cast on the fly to
``dtype`` and moved to ``device``; bf16 arrives as a torch tensor
(``framework="pt"``).

Single-file (``model.safetensors``) and sharded
(``model.safetensors.index.json``) HF checkpoints are read. The config
comes from ``config.json`` as a plain namespace (the fields the spec
reads; ``PretrainedConfig``'s default for an omitted
``tie_word_embeddings``), so the loader needs no ``transformers`` and
reads the same fields whatever version wrote them.
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace
from typing import Dict, Tuple

import torch

from modegpt_tpu_torch.models.spec import ModelSpec, spec_from_hf_config
from modegpt_tpu_torch.utils.device import DeviceLike

__all__ = ["load_hf_checkpoint_safetensors", "read_hf_config"]


def read_hf_config(model_dir: str) -> SimpleNamespace:
    """``config.json`` as an attribute namespace. ``save_pretrained``
    omits a field only where it equals both ``PretrainedConfig``'s default
    and the config class's, so the one base default the spec reads is
    filled in here."""
    with open(os.path.join(model_dir, "config.json")) as f:
        return SimpleNamespace(**{"tie_word_embeddings": True, **json.load(f)})


class _ShardedReader:
    """Lazy tensor-name -> torch tensor reader over one or more shards."""

    def __init__(self, model_dir: str):
        from safetensors import safe_open

        self._open = safe_open
        index_path = os.path.join(model_dir, "model.safetensors.index.json")
        single_path = os.path.join(model_dir, "model.safetensors")
        self._files: Dict[str, str] = {}
        if os.path.exists(index_path):
            with open(index_path) as f:
                index = json.load(f)
            for name, shard in index["weight_map"].items():
                self._files[name] = os.path.join(model_dir, shard)
        elif os.path.exists(single_path):
            with self._open(single_path, framework="pt") as f:
                for name in f.keys():
                    self._files[name] = single_path
        else:
            raise FileNotFoundError(f"no safetensors checkpoint in {model_dir}")
        self._handles: Dict[str, object] = {}

    def __contains__(self, name: str) -> bool:
        return name in self._files

    def keys(self):
        return self._files.keys()

    def get(self, name: str) -> torch.Tensor:
        path = self._files[name]
        if path not in self._handles:
            self._handles[path] = self._open(path, framework="pt").__enter__()
        return self._handles[path].get_tensor(name)

    def close(self):
        for h in self._handles.values():
            h.__exit__(None, None, None)
        self._handles.clear()


class _LazySD:
    """Duck-typed state dict backed by the shard reader: each tensor is
    read when `params_from_state_dict` asks for it, so the checkpoint is
    never held twice."""

    def __init__(self, reader: _ShardedReader):
        self._reader = reader

    def __contains__(self, name):
        return name in self._reader

    def __getitem__(self, name):
        if name in self._reader:
            return self._reader.get(name)
        raise KeyError(name)

    def keys(self):
        return self._reader.keys()


def load_hf_checkpoint_safetensors(
    model_dir: str, dtype: torch.dtype = torch.float32, device: DeviceLike = "cuda"
) -> Tuple[ModelSpec, Dict]:
    """(spec, params) from an HF checkpoint directory, each tensor cast to
    ``dtype`` on ``device``. Raises FileNotFoundError without safetensors
    files and KeyError when a tensor the spec needs is absent."""
    from modegpt_tpu_torch.models.hf import params_from_state_dict

    spec = spec_from_hf_config(read_hf_config(model_dir))
    reader = _ShardedReader(model_dir)
    try:
        params = params_from_state_dict(spec, _LazySD(reader), dtype=dtype, device=device)
    finally:
        reader.close()
    return spec, params
