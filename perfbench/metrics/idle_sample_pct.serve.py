"""idle_sample_pct.serve: the share of the traced stretch of the serving
window, in %, in which the device sat idle waiting on sampling: the
batcher's sampling tables (`ContinuousBatcher._sampling`) and the token
choice (`serving._pick`). Each idle gap goes to the innermost program
span that launched the kernel ending it (`spans.idle_pct`, span
``modegpt.serve.sample``); nothing to read where the program opens no
spans. Moves ``itl_p95_ms``."""

from perfbench.spans import idle_pct

SPAN = "modegpt.serve.sample"


def read(record):
    return idle_pct(record, SPAN)
