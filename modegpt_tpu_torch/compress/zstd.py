"""zstd decompression through the hand-written decoder in
``csrc/zstd_decode.cpp`` (RFC 8878), loaded with ctypes.

Orbax artifacts written by the JAX package hold zstd frames without a
content size: the zarr chunks (whose decoded size the array's shape
gives) and the OCDBT manifests and B-tree nodes (whose size is bounded
but unknown). The decoder is host code, built with the host C++ compiler
at first use (`kernels.build`); a failed build raises, and there is no
other decoder to fall back to. ctypes releases the interpreter lock for
the call, so threads may decode chunks side by side.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

__all__ = ["decompress", "decompress_into", "xxh64"]

_ERR_BYTES = 256


def _lib() -> ctypes.CDLL:
    from modegpt_tpu_torch.kernels.build import load_library

    lib = load_library("zstd_decode")
    if not getattr(lib, "_modegpt_typed", False):
        lib.modegpt_zstd_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
        ]
        lib.modegpt_zstd_decompress.restype = ctypes.c_int64
        lib.modegpt_xxh64.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.modegpt_xxh64.restype = ctypes.c_uint64
        lib._modegpt_typed = True
    return lib


def _src_view(src) -> np.ndarray:
    a = np.frombuffer(src, dtype=np.uint8) if not isinstance(src, np.ndarray) else src.reshape(-1).view(np.uint8)
    return np.ascontiguousarray(a)


def _call(src: np.ndarray, out: np.ndarray) -> int:
    """Decode ``src`` into ``out``: the bytes written, or -2 when ``out``
    is too small. Corrupt input raises ValueError."""
    err = ctypes.create_string_buffer(_ERR_BYTES)
    n = _lib().modegpt_zstd_decompress(src.ctypes.data, src.nbytes, out.ctypes.data, out.nbytes, err, _ERR_BYTES)
    if n == -1:
        raise ValueError(f"zstd: {err.value.decode(errors='replace')}")
    return int(n)


def decompress_into(src, out: np.ndarray) -> int:
    """Decode every frame of ``src`` into the C-contiguous array ``out``
    (any dtype; its bytes are written) and return the bytes written.
    Raises ValueError for corrupt input or when ``out`` is too small."""
    if not out.flags.c_contiguous:
        raise ValueError("zstd: the output array must be C-contiguous")
    n = _call(_src_view(src), out.reshape(-1).view(np.uint8))
    if n < 0:
        raise ValueError(f"zstd: the frames decode to more than {out.nbytes} bytes")
    return n


def decompress(src, max_size: Optional[int] = None) -> bytes:
    """Decode every frame of ``src`` whose decoded size is not known in
    advance. The output buffer starts at four times the input and
    doubles while it is too small, up to ``max_size`` bytes (default 1
    GiB), past which ValueError is raised."""
    limit = max_size if max_size is not None else 1 << 30
    a = _src_view(src)
    size = min(max(4 * a.nbytes, 1 << 12), limit)
    while True:
        out = np.empty(size, dtype=np.uint8)
        n = _call(a, out)
        if n >= 0:
            return out[:n].tobytes()
        if size >= limit:
            raise ValueError(f"zstd: the frames decode to more than {limit} bytes")
        size = min(2 * size, limit)


def xxh64(data) -> int:
    """XXH64 (seed 0) of ``data``, the hash zstd's content checksum keeps
    the low 32 bits of."""
    a = _src_view(data)
    return int(_lib().modegpt_xxh64(a.ctypes.data, a.nbytes))
