"""idle_model_pct.serve: the share of the traced stretch of the serving
window, in %, in which the device sat idle waiting on the host to launch
a dispatch of the padded stack (`models.padded._model_step_padded`: the
embedding, every decoder layer's launches, the head). Each idle gap goes
to the innermost program span that launched the kernel ending it
(`spans.idle_pct`, span ``modegpt.model.step``); nothing to read where
the program opens no spans. Moves ``itl_p95_ms``."""

from perfbench.spans import idle_pct

SPAN = "modegpt.model.step"


def read(record):
    return idle_pct(record, SPAN)
