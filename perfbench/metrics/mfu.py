"""mfu (%): the model FLOPs of the traced window's steps (the configuration's
count, every worker's tokens) over the window's length x the chips x the
card's dense bf16 peak."""


def read(record):
    if not record.get("window_steps") or not record.get("window_s"):
        return None
    work = record["flops_per_step"] * record["window_steps"]
    return 100.0 * work / (record["window_s"] * record["chips"] * record["peak_flops"])
