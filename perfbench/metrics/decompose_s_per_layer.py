"""decompose_s_per_layer: device seconds under the program's span
``modegpt.compress.decompose``, per compressed decoder layer: the solves
(`compress.batched.solve_chunk_batched`: Type-I, II and III, their GEMMs
included). The union of the intervals of the kernels whose launching
host operations include the span (`spans.per_layer`); nothing to
read where the program opens no such span. Moves
``compress_s_per_layer``."""

from perfbench.spans import per_layer

SPAN = "modegpt.compress.decompose"


def read(record):
    return per_layer(record, SPAN)
