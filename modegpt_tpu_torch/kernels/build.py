"""Build the sources in ``csrc/`` and load them with ctypes.

Each CUDA source ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so``
(a plain C interface, no PyTorch headers, so one file builds in
seconds), compiled by nvcc for ``sm_90a``. The hash covers the source,
every shared header ``csrc/*.cuh`` and the flags, so an edited source or
header rebuilds and an unchanged one is reused. Each host source
``csrc/<name>.cpp`` (the zstd decoder) is compiled the same way by the
host C++ compiler (``$CXX``, else ``c++``), its hash over the source and
its flags. All sources compile at once, one compiler process each.
Nothing builds at import time: the first call (or an explicit
`build_all`) does it, and a failed build raises with the compiler's
output.

    python -m modegpt_tpu_torch.kernels.build    # build every source now
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

__all__ = ["SOURCES", "HOST_SOURCES", "build_all", "load_library", "BUILD_DIR", "CSRC_DIR"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("flash_attention_hbm", "ragged_decode")
HOST_SOURCES = ("zstd_decode",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no host C++ compiler found (set CXX or put c++ on PATH)")
    return cxx


def _lib_path(name: str, csrc_dir: str = CSRC_DIR, build_dir: str = BUILD_DIR) -> str:
    if name in HOST_SOURCES:
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
        files = [f"{name}.cpp"]
    else:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        files = [f"{name}.cu", *sorted(f for f in os.listdir(csrc_dir) if f.endswith(".cuh"))]
    for fname in files:
        with open(os.path.join(csrc_dir, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(build_dir, f"lib{name}-{h.hexdigest()[:16]}.so")


def _command(name: str, out: str) -> List[str]:
    if name in HOST_SOURCES:
        return [_cxx(), *CXX_FLAGS, "-o", out, os.path.join(CSRC_DIR, f"{name}.cpp")]
    return [_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", out, os.path.join(CSRC_DIR, f"{name}.cu")]


def build_all(names: Optional[List[str]] = None) -> Dict[str, float]:
    """Compile every missing library in parallel (default: every CUDA and
    host source); returns seconds per source built (0.0 for one already
    built). Raises on a failed build, with the compiler's output."""
    names = list(names or SOURCES + HOST_SOURCES)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    seconds = {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            seconds[name] = 0.0
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = _command(name, tmp)
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, out)
    for name, (proc, tmp, out) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        seconds[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(proc.args[0])} failed for {proc.args[-1]}:\n{log}")
        os.replace(tmp, out)
    return seconds


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` or ``.cpp``, building it
    first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.exists(path):
                build_all([name])
            lib = _libs[name] = ctypes.CDLL(path)
        return lib


if __name__ == "__main__":
    for src, secs in build_all().items():
        print(f"{src}: {secs:.1f} s")
        if BUILD_LOGS.get(src):
            print(BUILD_LOGS[src])
