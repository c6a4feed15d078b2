"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, this folder and
the `modegpt_tpu_torch` package, on a machine with as many NVIDIA cards
as the cell asks for. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer ones (and the device's busy seconds
and the traced window, from ``torch.profiler``). The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``, each number compared with its limit; the same
numbers are the last lines of standard error.

Exits with a code other than 0, and prints no result, without a card,
when the program cannot be imported, or when JAX or the JAX package
(``modegpt_tpu``) was loaded in the process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".perfbench_cache")


def _environment() -> None:
    """Kernel caches at fixed paths inside the checkout, and no library
    that would load JAX or TensorFlow or reach the network."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)
    for var, val in (("USE_FLAX", "0"), ("USE_JAX", "0"), ("USE_TF", "0"), ("USE_TORCH", "1"),
                     ("HF_HUB_OFFLINE", "1"), ("TRANSFORMERS_OFFLINE", "1")):
        os.environ[var] = val


class Context:
    """What a driver is given: the cell, the run's arguments, the device
    and the process's start (set-up is measured from it)."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device, t_start: float):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device, self.t_start = device, t_start


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    sys.path.insert(0, ROOT)
    from perfbench import harness

    cell = harness.Cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    res = cell.driver().run(ctx)

    found = harness.forbidden_loaded()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; the port's benchmark loads neither JAX "
              "nor the JAX package", file=sys.stderr)
        return 3

    if args.trace:
        metrics = harness.read_per_layer(cell, res["record"])
    else:
        values = dict(res["e2e"], setup_s=res["setup_s"])
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell.metrics("end_to_end")}
    dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
                "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": harness.correct(res["checks"]),
            "attempted": int(res["attempted"]), "failed": int(res["failed"]),
            "metrics": metrics, "device": dev_info}
    summary = res["record"].get("trace")
    if args.trace and summary is not None:
        dev_info["busy_s"] = summary["busy_s"]
        dev_info["window_s"] = summary["window_s"]
        line["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    line["checks"] = res["checks"]
    print(json.dumps(line), flush=True)
    phases = ", ".join(f"{k} {v:.2f}" for k, v in res.get("setup_phases", {}).items())
    print(f"perfbench: set-up {res['setup_s']:.1f} s (s from the process's start: {phases}), "
          f"correctness check {res['check_s']:.1f} s", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
