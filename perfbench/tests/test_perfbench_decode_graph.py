"""The reader of the decode graph's engagement, on fake and real counters."""

import sys
import types

import pytest
from tiny_cells import ROOT  # noqa: F401  (puts the checkout on sys.path)

from perfbench import harness

MODULE = "modegpt_tpu_torch.models.padded"


def _read():
    return harness.load_metric("decode_graph_pct.serve", ROOT).read({})


@pytest.mark.parametrize("counts,want", [((999, 1), 99.9), ((0, 40), 0.0), ((0, 0), None)])
def test_decode_graph_share_of_whole_table_decodes(monkeypatch, counts, want):
    graph = types.SimpleNamespace(replays=counts[0], eager=counts[1])
    monkeypatch.setitem(sys.modules, MODULE, types.SimpleNamespace(DecodeGraph=graph))
    got = _read()
    assert got == (None if want is None else pytest.approx(want))


def test_decode_graph_share_is_silent_on_a_program_without_the_graph(monkeypatch):
    monkeypatch.setitem(sys.modules, MODULE, types.SimpleNamespace())  # the module, no counters
    assert _read() is None
    monkeypatch.delitem(sys.modules, MODULE)  # the module never loaded
    assert _read() is None


def test_decode_graph_share_reads_the_ports_counters(monkeypatch):
    from modegpt_tpu_torch.models import padded

    monkeypatch.setattr(padded.DecodeGraph, "replays", 3)
    monkeypatch.setattr(padded.DecodeGraph, "eager", 1)
    assert _read() == pytest.approx(75.0)
