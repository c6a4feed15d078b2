"""taps_s_per_layer: device seconds under the program's span
``modegpt.compress.taps``, per compressed decoder layer: the Gram taps
(`models.forward._layer` when it collects: `cov_x`, `cov_q`, `cov_k`,
`cov_mlp`, `cov_shared`). The union of the intervals of the kernels
whose launching host operations include the span
(`spans.per_layer`); nothing to read where the program opens no
such span. Moves ``compress_s_per_layer``."""

from perfbench.spans import per_layer

SPAN = "modegpt.compress.taps"


def read(record):
    return per_layer(record, SPAN)
