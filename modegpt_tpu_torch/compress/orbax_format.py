"""Orbax checkpoints (``ocp.StandardCheckpointer``'s layout) written and
read without orbax, tensorstore or JAX.

A checkpoint directory holds:

* ``_METADATA``: the tree. ``tree_metadata`` maps each leaf's key path,
  written as a Python tuple repr (``"('layers', '0', 'q', 'kernel')"``),
  to its ``key_metadata`` (each key with its type: 1 for a sequence
  index, 2 for a dict key) and ``value_metadata`` (``jax.Array`` with its
  ``write_shape``; a ``None`` leaf is ``value_type "None"`` with
  ``skip_deserialize``, and has no array);
* ``_CHECKPOINT_METADATA``: the handler's name and timestamps;
* ``_sharding``: per leaf (key: the base64 of its dotted path), the
  sharding it was saved with; orbax reads it when restoring without a
  target, and maps ``device_str`` to one of its local devices;
* an OCDBT store (`compress.ocdbt`) with one zarr v2 array per leaf:
  ``<dotted.path>/.zarray`` (JSON: shape, chunks, dtype, compressor) and
  one value per chunk, keyed by its grid index joined with ``.``
  (``0.0``; ``0`` for a scalar). bfloat16 is the zarr dtype
  ``"bfloat16"``, its little-endian bit pattern.

`save_tree` writes what orbax itself writes for a tree on one CPU
device, with two differences orbax reads back bit for bit: each leaf is
one uncompressed chunk (``"compressor": null``) in a data file of its
own, and the store is one uncompressed version at the directory's top
(no ``ocdbt.process_0/`` and no ``array_metadatas/``). Its ``_sharding``
names ``TFRT_CPU_0``, the device JAX gives a CPU host, so the JAX
package restores it on a CPU host (orbax refuses a device it does not
have, as for any artifact saved on another topology).

`load_tree` reads any such checkpoint: any chunk grid, chunks
uncompressed or zstd-compressed (`compress.zstd`), float32, bfloat16,
float16/64 and the integer and bool dtypes.
"""

from __future__ import annotations

import base64
import json
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from modegpt_tpu_torch.compress import ocdbt

__all__ = ["save_tree", "load_tree"]

_HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
_DEVICE_STR = "TFRT_CPU_0"
_SEQUENCE, _DICT = 1, 2
_READ_WORKERS = 8


def _leaves(tree, path: Tuple = ()) -> List[Tuple[Tuple, List[int], object]]:
    """(key path, key types, leaf) in JAX's flattening order: dict keys
    sorted, sequences in order; ``None`` is a leaf here, as orbax
    records it."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += [((str(k),) + p, [_DICT] + t, v) for p, t, v in _leaves(tree[k])]
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, child in enumerate(tree):
            out += [((str(i),) + p, [_SEQUENCE] + t, v) for p, t, v in _leaves(child)]
        return out
    return [((), [], tree)]


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """A leaf's C-contiguous host bytes as numpy, and its zarr dtype."""
    t = leaf.detach().cpu().contiguous() if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = np.ascontiguousarray(t.numpy())
    return a, a.dtype.str


def save_tree(ckpt_dir: str, tree: Dict) -> None:
    """Write ``tree`` (nested dicts and lists of tensors or arrays, with
    ``None`` leaves) as an orbax checkpoint at ``ckpt_dir``, replacing
    one already there (orbax's ``force=True``)."""
    t0 = time.time_ns()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    os.makedirs(os.path.join(ckpt_dir, "d"))
    tree_metadata, sharding, entries = {}, {}, {}
    for path, types, leaf in _leaves(tree):
        key_metadata = [{"key": k, "key_type": t} for k, t in zip(path, types)]
        if leaf is None:
            tree_metadata[str(path)] = {
                "key_metadata": key_metadata,
                "value_metadata": {"value_type": "None", "skip_deserialize": True},
            }
            continue
        a, dtype = _host_array(leaf)
        shape = list(a.shape)
        tree_metadata[str(path)] = {
            "key_metadata": key_metadata,
            "value_metadata": {"value_type": "jax.Array", "skip_deserialize": False, "write_shape": shape},
        }
        name = ".".join(path)
        zarray = {
            "chunks": shape, "compressor": None, "dimension_separator": ".", "dtype": dtype,
            "fill_value": None, "filters": None, "order": "C", "shape": shape, "zarr_format": 2,
        }
        entries[f"{name}/.zarray"] = json.dumps(zarray, separators=(",", ":")).encode()
        sharding[base64.b64encode(name.encode()).decode()] = json.dumps(
            {"sharding_type": "SingleDeviceSharding", "device_str": _DEVICE_STR}
        )
        if a.size:
            path_d = ocdbt.new_data_file(ckpt_dir)
            with open(os.path.join(ckpt_dir, path_d), "wb") as f:
                f.write(memoryview(a.reshape(-1).view(np.uint8)))
            entries[f"{name}/{'.'.join(['0'] * a.ndim) or '0'}"] = (path_d, 0, a.nbytes)
    ocdbt.write_store(ckpt_dir, entries)
    meta = {
        "tree_metadata": tree_metadata, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True, "custom_metadata": None,
    }
    with open(os.path.join(ckpt_dir, "_METADATA"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(ckpt_dir, "_sharding"), "w") as f:
        json.dump(sharding, f)
    with open(os.path.join(ckpt_dir, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({
            "item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
            "init_timestamp_nsecs": t0, "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {},
        }, f)


def _host_buffer(dtype: str, shape) -> Tuple[torch.Tensor, np.ndarray]:
    """An empty host tensor of the zarr dtype and its numpy view (native
    byte order: the caller swaps a big-endian array's bytes)."""
    if dtype == "bfloat16":
        t = torch.empty(shape, dtype=torch.bfloat16)
        return t, t.view(torch.int16).numpy().view(np.uint16)
    a = np.empty(shape, dtype=np.dtype(dtype).newbyteorder("="))
    return torch.from_numpy(a), a


def _read_chunk(store: ocdbt.OcdbtReader, key: str, compressor: Optional[str], out: np.ndarray) -> None:
    if compressor is None:
        store.read_into(key, out)
        return
    from modegpt_tpu_torch.compress import zstd

    v = store.values[key]
    src = v if isinstance(v, bytes) else np.fromfile(os.path.join(store.root, v.path), np.uint8, v.length,
                                                      offset=v.offset)
    if zstd.decompress_into(src, out) != out.nbytes:
        raise ValueError(f"orbax: chunk {key} decodes to fewer bytes than its {out.nbytes}")


def _read_array(store: ocdbt.OcdbtReader, name: str) -> torch.Tensor:
    z = json.loads(store.read(f"{name}/.zarray"))
    if z.get("zarr_format") != 2 or z.get("filters") or z.get("order", "C") != "C":
        raise ValueError(f"orbax: {name}: only C-order zarr v2 arrays without filters are read")
    comp = z.get("compressor")
    compressor = None if comp is None else comp.get("id")
    if compressor not in (None, "zstd"):
        raise ValueError(f"orbax: {name}: compressor {compressor!r} is not supported (null or zstd)")
    shape, chunks, dtype = tuple(z["shape"]), tuple(z["chunks"]), z["dtype"]
    sep = z.get("dimension_separator", ".")
    host, out = _host_buffer(dtype, shape)
    grid = [-(-s // c) if c else 0 for s, c in zip(shape, chunks)]
    if chunks == shape:
        key = f"{name}/{sep.join(['0'] * len(shape)) or '0'}"
        if out.size and key in store.values:
            _read_chunk(store, key, compressor, out)
        else:
            out[...] = 0
    else:
        out[...] = 0  # chunks never written hold the fill value (null: zero)
        _, piece = _host_buffer(dtype, chunks)
        for idx in np.ndindex(*grid):
            key = f"{name}/{sep.join(str(i) for i in idx)}"
            if key not in store.values:
                continue
            _read_chunk(store, key, compressor, piece)
            lo = [i * c for i, c in zip(idx, chunks)]
            region = tuple(slice(l, min(l + c, s)) for l, c, s in zip(lo, chunks, shape))
            out[region] = piece[tuple(slice(0, r.stop - r.start) for r in region)]
    if dtype != "bfloat16" and not np.dtype(dtype).isnative:
        out.byteswap(inplace=True)
    return host


def load_tree(ckpt_dir: str, device: torch.device) -> Dict:
    """Read the orbax checkpoint at ``ckpt_dir``: the tree as orbax
    restores it without a target (sequences as lists, ``None`` leaves as
    ``None``), every array a tensor on ``device``."""
    with open(os.path.join(ckpt_dir, "_METADATA")) as f:
        meta = json.load(f)["tree_metadata"]
    store = ocdbt.OcdbtReader(ckpt_dir)
    leaves = []
    for entry in meta.values():
        keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        vtype = entry["value_metadata"]["value_type"]
        if vtype not in ("None", "jax.Array", "np.ndarray"):
            raise ValueError(f"orbax: leaf {keys} of type {vtype} is not supported")
        leaves.append((keys, None if vtype == "None" else ".".join(k for k, _ in keys)))

    def fetch(name: Optional[str]):
        return None if name is None else _read_array(store, name).to(device)

    with ThreadPoolExecutor(max_workers=min(_READ_WORKERS, os.cpu_count() or 1)) as pool:
        values = list(pool.map(fetch, [name for _, name in leaves]))
    tree: Dict = {}
    for (keys, _), value in zip(leaves, values):
        node = tree
        for k, _ in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1][0]] = value
    return _sequences(tree, {tuple(k for k, _ in keys[: i + 1]): keys[i][1] for keys, _ in leaves
                             for i in range(len(keys))})


def _sequences(node, types: Dict[Tuple, int], path: Tuple = ()):
    """Turn the dicts whose keys are sequence indices back into lists."""
    if not isinstance(node, dict):
        return node
    children = {k: _sequences(v, types, path + (k,)) for k, v in node.items()}
    if children and all(types.get(path + (k,)) == _SEQUENCE for k in children):
        return [children[str(i)] for i in range(len(children))]
    return children
