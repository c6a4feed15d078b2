"""k1_roofline_pct: K1's share of its roofline in the window, in %: the
sum of its launches' least times over its device time.

A launch's least time (`counts.k1.bound_s`) is the larger of its FLOPs at
the TF32 peak and its bytes at the HBM rate, at the cell's calibration
shape. The launches come from the kernel's counter
(``flash_attention.launches``), the device time from the kernels named
`KERNEL_NAMES` in the trace; with a count that disagrees, nothing is
read. Moves ``compress_s_per_layer``."""

KERNEL_NAMES = ("attention_tile_loop",)


def read(record):
    tr = record.get("trace")
    n = record.get("k1_launches", 0)
    if not tr or not n:
        return None
    secs, count = 0.0, 0
    for name, s, t, ops in tr["kernels"]:
        if any(k in name for k in KERNEL_NAMES):
            secs += (t - s) / 1e6
            count += 1
    if count != n or secs <= 0:
        return None
    return 100.0 * n * record["k1_launch_bound_s"] / secs
