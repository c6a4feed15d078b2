"""The plain reference against the port at a tiny size, on the CPU: the
whole run of each cell (the harness's look for a card skipped), with
every compared number within its limit."""

import pytest
import torch
from tiny_cells import compress_cell, context, serve_cell

from perfbench import harness
from perfbench.drivers import compress_job, serve_loop
from perfbench.reference import modegpt


@pytest.mark.parametrize("seed", [7, 2**31 + 12345])
def test_compression_agrees_with_the_reference(seed):
    res = compress_job.run(context(compress_cell(), seed=seed))
    assert res["checks"]["rank_mismatch"]["value"] == 0
    assert res["checks"]["hidden_gap"]["value"] < 1e-4
    assert harness.correct(res["checks"])
    assert res["attempted"] >= 1 and res["e2e"]["compress_s_per_layer"] > 0


@pytest.mark.parametrize("prefill_exec", ["per_slot", "batched"])
def test_serving_agrees_with_the_reference(prefill_exec):
    cell = serve_cell()
    cell.traffic["batcher"]["prefill_exec"] = prefill_exec
    res = serve_loop.run(context(cell, seconds=2.0))
    assert res["checks"]["greedy_gap"]["value"] < 1e-4
    assert res["checks"]["sampled_gap"]["value"] < 1e-4
    assert harness.correct(res["checks"]) and res["failed"] == 0 and res["attempted"] > 0
    assert res["e2e"]["itl_p95_ms"] > 0 and res["e2e"]["ttft_p95_ms"] > 0 and res["record"]["ttft_ms"]


def test_allocation_and_rank_rounding():
    keep = modegpt.allocate([0.2, 0.2], 0.3, 0.15, 0.8)
    assert keep == pytest.approx([0.7, 0.7])
    keep = modegpt.allocate([0.01, 1.0, 1.0], 0.5, 0.015, 0.8)  # the first layer would take 1.5: capped
    assert keep[0] == pytest.approx(0.2) and sum(1 - k for k in keep) == pytest.approx(1.5)
    r = modegpt.ranks_for({"head_dim": 128, "intermediate_size": 12288}, 0.7)
    assert (r["qk"], r["vo"], r["mlp"]) == (88, 88, 8601)


def test_the_reference_runs_without_the_program_on_its_path():
    cell = compress_cell()
    ref = compress_job.reference_model(cell.config, cell.traffic, 3, torch.device("cpu"), tf32=False)
    assert len(ref["ranks"]) == cell.config["num_hidden_layers"]
    assert all(0 < k < 1 for k in ref["keep"])


def test_the_step_record_holds_each_prompt_token_once():
    """The harness's rows of every step: each prompt token prefilled once,
    in chunks of at most the bucket, and one decode row a token."""
    cell = serve_cell()
    rec = serve_loop.serve(context(cell, seconds=2.0))
    reqs, steps = rec["loop"].reqs.values(), rec["loop"].steps
    bucket = cell.traffic["batcher"]["prefill_bucket"]
    prefilled = sum(q for st in steps for _, q in st.chunk_rows)
    assert sum(r.prompt.shape[0] for r in reqs if r.t_first is not None) <= prefilled
    assert prefilled <= sum(r.prompt.shape[0] for r in reqs)
    assert all(0 < q <= bucket and p0 % bucket == 0 for st in steps for p0, q in st.chunk_rows)
    assert all(q == 1 for st in steps for _, q in st.decode_rows)
    assert sum(st.tokens for st in steps) == sum(r.gen for r in reqs)
