"""idle_batcher_pct.serve: the share of the traced stretch of the serving
window, in %, in which the device sat idle waiting on the batcher: the
rest of `ContinuousBatcher.step` (the sweep of finished slots,
admission, chunk scheduling, commits), in the step but in neither the
model step nor sampling. Each idle gap goes to the innermost program
span that launched the kernel ending it (`spans.idle_pct`, span
``modegpt.serve.step``); nothing to read where the program opens no
spans. Moves ``itl_p95_ms``."""

from perfbench.spans import idle_pct

SPAN = "modegpt.serve.step"


def read(record):
    return idle_pct(record, SPAN)
