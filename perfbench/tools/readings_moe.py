"""The readings a Qwen3-MoE compression cell's correctness limits are set
from, on the card.

    python3 perfbench/tools/readings_moe.py --workload <cell> --seeds 12 --control 3 --base <n>

Prints one JSON line a seed: the program's compared numbers from one job
on seeds ``base, base+1, ...``, and on the first ``--control`` of them
the control's (the plain reference computed in the nearest lower
precision, TF32, put in the program's place). `readings.py` sends every
traffic kind but ``compress_job`` to the serving path; this tool runs
``compress_job_moe``. The benchmark's own runs never run the control.
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

    from perfbench import harness, run
    from perfbench.drivers import compress_job_moe

    run._environment()
    cell = harness.Cell(args.workload, ROOT)
    if cell.traffic["kind"] != "compress_job_moe":
        raise SystemExit(f"{args.workload} is not a compress_job_moe cell")
    dev = torch.device("cuda", 0)
    for i in range(args.seeds):
        seed = args.base + i
        t0 = time.perf_counter()
        res = compress_job_moe.run(run.Context(cell, seed, args.seconds, False, dev, time.perf_counter()))
        out = {"seed": seed, "program": {k: v["value"] for k, v in res["checks"].items()}, "e2e": res["e2e"]}
        del res
        if i < args.control:
            torch.cuda.empty_cache()
            ctrl = compress_job_moe.control_reading(cell, seed, dev)
            out["control"] = {k: v["value"] for k, v in ctrl.items()}
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
