"""prepass_s_per_layer: device seconds under the program's span
``modegpt.compress.bi_prepass``, per compressed decoder layer: the BI
pre-pass (`compress.offload._bi_sweep`: one forward with no taps, before
the tap sweep). The union of the intervals of the kernels whose
launching host operations include the span (`spans.per_layer`);
nothing to read where the program opens no such span. Moves
``compress_s_per_layer``."""

from perfbench.spans import per_layer

SPAN = "modegpt.compress.bi_prepass"


def read(record):
    return per_layer(record, SPAN)
