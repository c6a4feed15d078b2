"""decode_step_ms: the mean host time of the window's untraced
`ContinuousBatcher.step` calls that carry no prefill rows, in ms (a step
returns its tokens to the host, so it ends synchronised). Moves
``itl_p95_ms``."""


def read(record):
    ms = record.get("decode_step_ms")
    return sum(ms) / len(ms) if ms else None
