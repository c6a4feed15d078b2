"""Find the highest arrival rate a serving cell's batcher sustains: a
sweep on the card, made once when a cell's rate is chosen.

    python3 perfbench/tools/sweep.py --workload <cell> --rates 0.5,1,1.5 --seconds 30 --seed <n>

For each rate, in one process on one model: a fresh batcher with the
mix's settings, ``arrivals.warmup_s`` of the schedule, then ``--seconds``
of window. One JSON line a rate: requests due in the window and finished
in it, tokens/s, time to first token (p50, p95, max, over requests due in
the window), the requests still waiting for their first token when the
window closes, and the mean step time. A rate is sustained while the
backlog at the close stays near what a steady batcher holds and the
finished requests keep pace with the due ones.
"""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from perfbench import harness, run, weights
    from perfbench.drivers import serve_loop as d

    run._environment()
    from modegpt_tpu_torch.models.padded import pad_to_uniform

    cell = harness.Cell(args.workload, ROOT)
    cfg, tr = cell.config, cell.traffic
    dev = torch.device("cuda", 0)
    params = weights.model_params(cfg, args.seed, dev, d._ranks(tr))
    pm = pad_to_uniform(d.compressed_spec(cfg, tr["compressed_ranks"]), params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    bc = tr["batcher"]
    for rate in (float(r) for r in args.rates.split(",")):
        b = d.make_batcher(pm, bc)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        d.warm_up(b, tr, gen)
        at_rate = dict(tr, arrivals=dict(tr["arrivals"], rate_per_s=rate))
        loop = d.Loop(b, d.Traffic(at_rate, args.seed, cfg["vocab_size"]), gen, time.perf_counter())
        loop.run_until(time.perf_counter() + float(tr["arrivals"]["warmup_s"]))
        first = len(loop.steps)
        t_open = time.perf_counter()
        loop.run_until(t_open + args.seconds)
        t_close = time.perf_counter()
        due = [r for r in loop.reqs.values() if t_open <= r.t_submit < t_close]
        ttft = [1e3 * (r.t_first - r.t_submit) for r in due if r.t_first is not None]
        steps = loop.steps[first:]
        out = {
            "rate_per_s": rate, "due": len(due),
            "finished": sum(1 for r in loop.reqs.values() if r.t_done is not None and t_open <= r.t_done < t_close),
            "tok_s": sum(st.tokens for st in steps) / (t_close - t_open),
            "waiting_at_close": sum(1 for r in loop.reqs.values() if r.t_first is None),
            "ttft_ms": {q: float(np.percentile(ttft, q)) for q in (50, 80, 95, 100)} if ttft else None,
            "without_first_token": len(due) - len(ttft),
            "step_ms": 1e3 * (t_close - t_open) / max(1, len(steps)),
            "prefill_step_ms": float(np.mean([1e3 * (s.t1 - s.t0) for s in steps if s.chunk_rows] or [0])),
            "decode_step_ms": float(np.mean([1e3 * (s.t1 - s.t0) for s in steps if not s.chunk_rows] or [0])),
        }
        print(json.dumps(out), flush=True)
        loop.b = None
        del b, loop
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
