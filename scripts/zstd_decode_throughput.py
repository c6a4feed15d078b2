"""Throughput of the port's hand-written zstd decoder on the host CPU.

Compresses about 64 MB of normal weights (bfloat16 and float32 bit
patterns, numpy seed 0) with ``zstandard`` at level 1 without a content
size, as tensorstore writes orbax's zarr chunks, then decodes them with
``modegpt_tpu_torch.compress.zstd`` (built with the host compiler on
first use) and, for reference, with ``zstandard``'s streaming decoder.
Prints one JSON line: the host's CPU model, and MB/s (decoded bytes) of
the best of five runs for each. Needs ``zstandard``, which only the test
environment has; the port never imports it.

    python scripts/zstd_decode_throughput.py
"""

import json
import os
import platform
import sys
import time

import numpy as np
import zstandard

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from modegpt_tpu_torch.compress import zstd  # noqa: E402


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def _best(fn, runs: int = 5) -> float:
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> None:
    rng = np.random.default_rng(0)
    x = rng.standard_normal(16 * 1024 * 1024).astype(np.float32)  # 64 MiB as float32
    payloads = {
        "bfloat16": (np.concatenate([x, x[::-1]]).view(np.uint32) >> 16).astype(np.uint16).tobytes(),
        "float32": x.tobytes(),
    }
    out = {"host_cpu": _cpu_model(), "cores": os.cpu_count(), "level": 1}
    for name, data in payloads.items():
        frame = zstandard.ZstdCompressor(level=1, write_content_size=False).compress(data)
        buf = np.empty(len(data), dtype=np.uint8)
        assert zstd.decompress_into(frame, buf) == len(data) and buf.tobytes() == data
        port = _best(lambda: zstd.decompress_into(frame, buf))
        ref = _best(lambda: zstandard.ZstdDecompressor().decompressobj().decompress(frame))
        out[name] = {"decoded_mb": len(data) / 1e6, "ratio": len(data) / len(frame),
                     "port_mb_per_s": len(data) / 1e6 / port, "zstandard_mb_per_s": len(data) / 1e6 / ref}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
