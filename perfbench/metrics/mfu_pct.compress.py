"""mfu_pct.compress: the compression jobs' counted FLOPs over the window's
seconds at the card's TF32 peak (`peaks.TF32_FLOPS`), in %.

The FLOPs (`counts.model_flops.compress_job_flops`) are one dense forward
over the calibration tokens plus the Gram products of every tap, counted
from shapes whatever implements them; the seconds are the jobs' wall
time. Moves ``compress_s_per_layer``."""

from perfbench import peaks


def read(record):
    if not record.get("flops") or not record.get("window_s"):
        return None
    return 100.0 * record["flops"] / (record["window_s"] * peaks.TF32_FLOPS)
