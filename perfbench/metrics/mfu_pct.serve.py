"""mfu_pct.serve: the serving steps' counted FLOPs over the seconds they
span at the card's TF32 peak (`peaks.TF32_FLOPS`), in %, over the
window's untraced steps.

Counted (`counts.model_flops`): 2 x the compressed decoder's weights for
every prompt token prefilled and every token decoded, the LM head for
each token returned, and the attention products over each row's live
keys. Padded positions are not counted. Moves ``itl_p95_ms``."""

from perfbench import peaks


def read(record):
    if not record.get("flops") or not record.get("untraced_s"):
        return None
    return 100.0 * record["flops"] / (record["untraced_s"] * peaks.TF32_FLOPS)
