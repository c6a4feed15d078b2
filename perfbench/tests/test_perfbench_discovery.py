"""A cell, a traffic mix and a per-layer metric are found by name from
files and entries alone."""

import json
import os
import shutil

from tiny_cells import ROOT

from perfbench import harness


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    return root


def test_a_new_cell_mix_and_metric_need_only_files_and_entries(tmp_path):
    root = _copy(tmp_path)
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "qwen3-8b.json").read_text())
    (pb / "configs" / "qwen3-8b-alt.json").write_text(json.dumps(dict(cfg, num_hidden_layers=4)))
    mix = json.loads((pb / "traffic" / "steady-chat.json").read_text())
    (pb / "traffic" / "poisson-short.json").write_text(json.dumps(dict(mix, pool=8)))
    (pb / "metrics" / "tokens_per_step.py").write_text(
        "def read(record):\n    return record.get('tokens_per_step')\n")
    (pb / "limits" / "qwen3-8b-alt.short.json").write_text(json.dumps({"greedy_gap": 1.0}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][1], name="qwen3-8b-alt", file="perfbench/configs/qwen3-8b-alt.json"))
    bench["workloads"].append({"name": "qwen3-8b-alt.short", "config": "qwen3-8b-alt", "traffic": "poisson-short",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "tokens_per_step", "unit": "tokens", "better": "higher",
                               "source": "host_clock", "layer": "batcher", "moves": "serve_tok_s",
                               "workloads": ["qwen3-8b-alt.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.Cell("qwen3-8b-alt.short", str(root))
    assert cell.config["num_hidden_layers"] == 4
    assert cell.traffic["pool"] == 8
    assert cell.driver().__name__ == "perfbench.drivers.serve_loop"
    assert [m["name"] for m in cell.metrics("per_layer")] == ["tokens_per_step"]
    assert {m["name"] for m in cell.metrics("end_to_end")} == {"setup_s"}
    assert harness.read_per_layer(cell, {"tokens_per_step": 3}) == {"tokens_per_step": {"value": 3.0, "unit": "tokens"}}
    assert harness.read_per_layer(cell, {}) == {}  # a reader with nothing to read is left out


def test_every_cell_of_the_benchmark_resolves():
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for w in bench["workloads"]:
        cell = harness.Cell(w["name"], ROOT)
        assert cell.driver() is not None
        for m in cell.metrics("per_layer"):
            assert callable(harness.load_metric(m["name"], ROOT).read)
        assert cell.metrics("end_to_end")[0]["name"] == "setup_s"
