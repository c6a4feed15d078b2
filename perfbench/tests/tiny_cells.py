"""Tiny stand-ins of the benchmark's cells for the CPU tests: the cells'
own files, with the widths, depths, lengths and counts cut to what a test
run holds."""

import copy
import os
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402

TINY = dict(hidden_size=64, intermediate_size=136, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            vocab_size=512)


def compress_cell():
    cell = harness.Cell("qwen3-32b.compress", ROOT)
    tr = copy.deepcopy(cell.traffic)
    tr["compression"].update(calib_size=8, calibs_batch_size=4, seq_len=128)
    tr["check_tokens"] = dict(sequences=2, seq_len=128)
    return SimpleNamespace(config=dict(cell.config, **TINY), traffic=tr, limits=cell.limits, root=ROOT)


def serve_cell():
    cell = harness.Cell("qwen3-8b.serve", ROOT)
    tr = copy.deepcopy(cell.traffic)
    tr.update(pool=20, trace_seconds=1)
    tr["arrivals"].update(rate_per_s=10.0, warmup_s=1.0)
    tr["batcher"].update(slots=4, max_len=256, prefill_bucket=16)
    tr["compressed_ranks"] = dict(keep_ratio=0.7, qk_per_head=10, vo_per_head=10, mlp=95)
    tr["prompt_len"] = dict(median=32, sigma=0.7, min=8, max=100)
    tr["output_len"] = dict(median=8, sigma=0.7, min=4, max=30)
    tr["check"] = dict(requests=6, tokens=1000)
    return SimpleNamespace(config=dict(cell.config, num_hidden_layers=2, **TINY), traffic=tr, limits=cell.limits,
                           root=ROOT)


def context(cell, seed=2**31 + 12345, seconds=1.0, trace=False, device="cpu"):
    import torch

    return SimpleNamespace(cell=cell, seed=seed, seconds=seconds, trace=trace, device=torch.device(device),
                           t_start=time.perf_counter())
