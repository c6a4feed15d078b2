"""idle_pct.compress: the share of the traced window in which no device
operation ran, in %: 100 * (1 - union of the operations' intervals /
window). Moves ``compress_s_per_layer``."""


def read(record):
    tr = record.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
