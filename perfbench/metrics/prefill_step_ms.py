"""prefill_step_ms: the mean host time of the window's untraced
`ContinuousBatcher.step` calls that carry prefill rows, in ms. Every
decoding slot waits on such a step: moves ``itl_p95_ms``."""


def read(record):
    ms = record.get("prefill_step_ms")
    return sum(ms) / len(ms) if ms else None
