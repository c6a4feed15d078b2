"""experts_s_per_layer: device seconds under the program's span
``modegpt.moe.experts``, per compressed decoder layer: the routed expert
layer (`models.forward._moe_mlp`: the router, the expert products, the
weighted down sum and the routed mask the taps read), in the BI
pre-pass and in the tap sweep. The union of the intervals of the
kernels whose launching host operations include the span
(`spans.per_layer`); nothing to read where the program opens no such
span. Moves ``compress_s_per_layer``."""

from perfbench.spans import per_layer

SPAN = "modegpt.moe.experts"


def read(record):
    return per_layer(record, SPAN)
