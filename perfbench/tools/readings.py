"""The readings a cell's correctness limits are set from, on the card.

    python3 perfbench/tools/readings.py --workload <cell> --seeds 12 --control 3 --base <n>

Prints one JSON line a seed: the program's compared numbers on seeds
``base, base+1, ...`` and the control's (the plain reference computed in
the nearest lower precision, TF32, put in the program's place) on the
first ``--control`` of them. A compression cell runs one job a seed; a
serving cell its set-up, ramp and a window of ``--seconds``, then reads
the control's ``greedy_gap`` on the same prompts and served tokens, and
``sampled_gap`` with every served token altered (id + 1), the fault that
the sampled requests' number has to catch. The benchmark's own runs never
run the control.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--base", type=int, required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from perfbench import harness, run, weights
    from perfbench.drivers import compress_job, serve_loop

    run._environment()
    cell = harness.Cell(args.workload, ROOT)
    dev = torch.device("cuda", 0)
    kind = cell.traffic["kind"]
    for i in range(args.seeds):
        seed = args.base + i
        t0 = time.perf_counter()
        ctx = run.Context(cell, seed, args.seconds, False, dev, time.perf_counter())
        out = {"seed": seed}
        if kind == "compress_job":
            res = compress_job.run(ctx)
            out["program"] = {k: v["value"] for k, v in res["checks"].items()}
            out["e2e"] = res["e2e"]
            if i < args.control:
                torch.cuda.empty_cache()
                out["control"] = {k: v["value"] for k, v in compress_job.control_reading(cell, seed, dev).items()}
        else:
            rec = serve_loop.serve(ctx)
            tr = cell.traffic
            reqs = serve_loop.sample_for_check(rec, seed, tr["check"]["requests"], tr["check"]["tokens"])
            params = weights.model_params(cell.config, seed, dev, serve_loop._ranks(tr))
            gaps = serve_loop.served_gaps(cell.config, params, reqs, dev, tr["sampled"])
            out["program"] = {f"{k}_gap": max(v.values()) for k, v in gaps.items() if v}
            out["served_tokens"] = sum(r.budget for r in reqs)
            if i < args.control:
                ctrl = serve_loop.served_gaps(cell.config, params, reqs, dev, tr["sampled"], tf32_control=True)
                out["control"] = {"greedy_gap": max(ctrl["greedy"].values())}
                for r in reqs:
                    plen = r.prompt.shape[0]
                    r.tokens = r.tokens[:plen] + [(t + 1) % cell.config["vocab_size"] for t in r.tokens[plen:]]
                fault = serve_loop.served_gaps(cell.config, params, [r for r in reqs if not r.greedy], dev,
                                               tr["sampled"])
                out["token_altered"] = {"sampled_gap": max(fault["sampled"].values())}
            out["e2e"] = serve_loop.end_to_end(rec)
            del params, rec
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
