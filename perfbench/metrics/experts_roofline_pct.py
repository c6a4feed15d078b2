"""experts_roofline_pct: the expert layer's share of its roofline in the
window, in %: the sum of its calls' least times over the device seconds
under the program's span ``modegpt.moe.experts``.

A call's least time (`counts.moe.experts_bound_s`) is the larger of the
routed model's FLOPs (the router and each token's k experts) at the TF32
peak and its bytes (every expert's weights once, each routed row in and
out once) at the HBM rate, so the share reads the same work whatever
implements the experts. The calls and their tokens come from the
program's counters (``_moe_mlp.calls``, ``.tokens``); nothing is read
where the program has none or where they disagree with the harness's
own count of the job's calls and tokens. Moves
``compress_s_per_layer``."""

from perfbench.spans import device_seconds

SPAN = "modegpt.moe.experts"


def read(record):
    tr, bound = record.get("trace"), record.get("experts_bound_s")
    if not tr or not bound:
        return None
    if (record.get("moe_calls"), record.get("moe_tokens")) != (record.get("moe_expected_calls"),
                                                               record.get("moe_expected_tokens")):
        return None
    secs = device_seconds(tr["kernels"], SPAN)
    return 100.0 * bound / secs if secs > 0 else None
