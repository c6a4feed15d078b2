"""decode_graph_pct.serve: the share of the run's whole-table decode
dispatches (`models.padded._model_step_padded` over the batcher's slot
table, one token a slot) that replayed the CUDA graph of the step, in %:
100 x replays / (replays + eager), from the program's counters
(``models.padded.DecodeGraph``), read through ``sys.modules`` over the
whole process: the set-up's dispatches and the window's. Nothing to read
where the program has no such counters or ran no such dispatch. Moves
``itl_p95_ms``."""

import sys

MODULE = "modegpt_tpu_torch.models.padded"


def read(record):
    graph = getattr(sys.modules.get(MODULE), "DecodeGraph", None)
    replays, eager = getattr(graph, "replays", None), getattr(graph, "eager", None)
    if not isinstance(replays, int) or not isinstance(eager, int) or replays + eager == 0:
        return None
    return 100.0 * replays / (replays + eager)
