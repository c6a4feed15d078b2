"""Time variants of the long-context attention source against each other.

    python -m modegpt_tpu_torch.kernels.compare a.cu b.cu [...]

Each file is a variant of ``csrc/flash_attention_hbm.cu`` exporting its C
entry ``modegpt_flash_attention_hbm``. All variants build at once with
the package's nvcc flags (into the directory of the first file). Then
the T = 16384 cases of ``chip_smoke.py``'s K2 table run on every
variant in turn, on the same seeded inputs, and each line gives the ms
per launch and the largest difference from the first variant's output.
The card's name, power limit and clocks close the output. It needs one
NVIDIA card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

from modegpt_tpu_torch.kernels.build import NVCC_FLAGS, _nvcc

# name, H, Hk, T, hd, hd_v, dtype (B = 1, causal)
CASES = [
    ("long_f32", 32, 8, 16384, 128, 128, torch.float32),
    ("long_padded_f32", 32, 8, 16384, 126, 126, torch.float32),
    ("long_bf16", 32, 8, 16384, 128, 128, torch.bfloat16),
    ("long_compressed_f32", 32, 8, 16384, 88, 90, torch.float32),
    ("long_compressed_bf16", 32, 8, 16384, 88, 90, torch.bfloat16),
]


def build(sources):
    """One ctypes function per source, built in parallel; raises with
    nvcc's output on a failed build."""
    out_dir = os.path.dirname(os.path.abspath(sources[0]))
    procs = []
    for src in sources:
        lib = os.path.join(out_dir, os.path.basename(src) + ".so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", lib, src]
        procs.append((src, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    fns = []
    for src, lib, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        fn = ctypes.CDLL(lib).modegpt_flash_attention_hbm
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        fns.append(fn)
    return fns


def launch(fn, q, k, v):
    B, H, T, hd = q.shape
    o = torch.empty((B, H, T, v.shape[-1]), dtype=q.dtype, device=q.device)
    scale = float(torch.tensor(hd**-0.5, dtype=q.dtype))
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, k.shape[1], T, hd, v.shape[-1],
        scale, 0, 0 if q.dtype == torch.float32 else 1, torch.cuda.current_stream().cuda_stream,
    )
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return o


def ms_per_launch(fn, iters: int = 5) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(sources) -> int:
    if not sources or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    fns = build(sources)
    names = [os.path.basename(s) for s in sources]
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(8192, 8192, device="cuda", generator=gen)
    for _ in range(50):  # bring the clocks up before the first case
        x @ x
    del x
    for name, H, Hk, T, hd, hd_v, dt in CASES:
        q = torch.randn((1, H, T, hd), generator=gen, device="cuda").to(dt)
        k = torch.randn((1, Hk, T, hd), generator=gen, device="cuda").to(dt)
        v = torch.randn((1, Hk, T, hd_v), generator=gen, device="cuda").to(dt)
        first = None
        cells = []
        for label, fn in zip(names, fns):
            out = launch(fn, q, k, v).float()
            first = out if first is None else first
            diff = float((out - first).abs().max())
            t = ms_per_launch(lambda: launch(fn, q, k, v))
            cells.append(f"{label} {t:.3f} ms (diff {diff:.1e})")
        print(f"{name}: " + "; ".join(cells), flush=True)
    smi = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
