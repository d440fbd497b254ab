"""idle_pct (%): the share of the traced window in which no kernel, copy or
set ran on the device (busy time averaged over the chips)."""


def read(record):
    if not record.get("window_s"):
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
