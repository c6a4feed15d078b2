"""The whole-table decode dispatch's CUDA graph (`models.padded.DecodeGraph`)
on the CPU: its index buffer against `step_indices`, the rule that admits
a dispatch to the graph, and the counting of the dispatches that run op
by op. The capture and the replays themselves need a card
(`tests/test_torch_cuda.py`)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from modegpt_tpu_torch.models.init import init_params
from modegpt_tpu_torch.models.padded import (
    DecodeGraph,
    _model_step_padded,
    _replayable,
    pad_to_uniform,
    step_indices,
)
from modegpt_tpu_torch.models.serving import init_serve_state
from modegpt_tpu_torch.models.spec import spec_from_hf_config

B, T = 5, 16

LENGTHS = {
    "all_zero": np.zeros(B, np.int64),
    "mixed": np.array([0, 3, 15, 7, 1]),
    "one_row_at_T_minus_1": np.array([2, T - 1, 0, 9, T - 2]),
    "host_int": 6,
}


@pytest.mark.parametrize("name", sorted(LENGTHS))
def test_graph_index_equals_step_indices(name):
    """For one new token a row, every row inside the pool, the graph's
    buffer gives `step_indices`' pos, write_ix and positions."""
    g = DecodeGraph()
    g._buffers(B, "cpu")
    g._fill(LENGTHS[name])
    got = g._index()
    want = step_indices([LENGTHS[name]], B, 1, T, "cpu")[0]
    assert got.pos.dtype == want.pos.dtype == torch.int32 and torch.equal(got.pos, want.pos)
    assert len(got.write_ix) == len(want.write_ix) == 3
    for a, b in zip(got.write_ix, want.write_ix):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got.positions.shape == want.positions.shape == (B, 1) and torch.equal(got.positions, want.positions)


def _pools(n_layers=2, Hk=2, R=8):
    return (torch.zeros((n_layers, B, Hk, T, R)), torch.zeros((n_layers, B, Hk, T, R)))


# the replay rule's cases: what changes from a plain whole-table decode
RULE_CASES = {
    "decode": ({}, True),
    "decode_at_one_host_int": (dict(length=T - 1), True),
    "mesh": (dict(mesh=object()), False),
    "moe_dispatch": (dict(moe="dispatch"), False),
    "dispatch_token_valid": (dict(token_valid=torch.ones((B, 1), dtype=torch.bool)), False),
    "row_at_T": (dict(length=np.array([0, 3, T, 7, 1])), False),
    "every_row_at_T": (dict(length=T), False),
    "chunk_S_gt_1": (dict(tokens=torch.zeros((B, 4), dtype=torch.int64)), False),
    "logits_at": (dict(logits_at=0), False),
    "logits_at_per_row": (dict(logits_at=torch.zeros(B, dtype=torch.int64)), False),
    "plain_attention": (dict(decode_attn="xla"), False),
    "index_uploaded_ahead": (dict(index="ahead"), False),
}


@pytest.mark.parametrize("name", sorted(RULE_CASES))
def test_replay_rule(name):
    change, replays = RULE_CASES[name]
    kw = dict(tokens=torch.zeros((B, 1), dtype=torch.int64), pools=_pools(), length=np.array([0, 3, 15, 7, 1]),
              decode_attn="ragged", logits_at=None, moe="dense", token_valid=None, index=None, mesh=None)
    kw.update(change)
    if kw["index"] == "ahead":
        kw["index"] = step_indices([kw["length"]], B, 1, T, "cpu")[0]
    assert _replayable(**kw) is replays


def _tiny_llama():
    spec = spec_from_hf_config(SimpleNamespace(
        model_type="llama", vocab_size=64, hidden_size=32, intermediate_size=48,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=8,
        max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=10000.0, hidden_act="silu",
        tie_word_embeddings=False, attention_bias=False, mlp_bias=False, rope_scaling=None,
    ))
    return pad_to_uniform(spec, init_params(spec, torch.Generator().manual_seed(0), device="cpu"))


def _dispatch(pm, state, tokens, length, **kw):
    return _model_step_padded(pm.spec, pm.layers, pm.other, pm.q_hd_true, tokens, state.cache_k, state.cache_v,
                              length, **kw)[0]


@pytest.mark.parametrize("kind", ["decode", "chunk", "logits_at", "no_graph"])
def test_whole_table_decodes_off_the_card_count_eager(kind):
    """On the CPU a whole-table decode over a pool with a graph runs op by
    op and counts ``eager``, with the logits and pool of the plain
    dispatch; a chunk, a dispatch with ``logits_at`` or one without the
    graph is no whole-table decode and counts nothing."""
    pm = _tiny_llama()
    states = [init_serve_state(pm, B, T) for _ in range(2)]
    assert all(isinstance(s.graph, DecodeGraph) for s in states)
    length = np.array([0, 3, 9, 7, 1])
    S = 3 if kind == "chunk" else 1
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (B, S)))
    kw = dict(decode_attn="ragged", logits_at=0 if kind == "logits_at" else None)
    before = (DecodeGraph.captures, DecodeGraph.replays, DecodeGraph.eager)
    got = _dispatch(pm, states[0], tokens, length, graph=None if kind == "no_graph" else states[0].graph, **kw)
    counted = (DecodeGraph.captures - before[0], DecodeGraph.replays - before[1], DecodeGraph.eager - before[2])
    assert counted == ((0, 0, 1) if kind == "decode" else (0, 0, 0))
    want = _dispatch(pm, states[1], tokens, length, **kw)
    assert torch.equal(got, want)
    assert torch.equal(states[0].cache_k, states[1].cache_k) and torch.equal(states[0].cache_v, states[1].cache_v)
